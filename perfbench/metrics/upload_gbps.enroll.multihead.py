"""upload_gbps.enroll.multihead: the bytes the program's extractor moved
to the card in the window (its ``embed.upload_bytes`` counter) over the
device time of the trace's host-to-device copies, in GB/s, in the
multi-head enrolment cell (``perfbench/embed_spans.py``)."""

from perfbench.embed_spans import upload_gbps


def read(ctx):
    return upload_gbps(ctx)
