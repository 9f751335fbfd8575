"""idle_fetch.enroll.multihead: percent of the traced window in the multi-
head enrolment cell with no kernel running while the program was in an
``embed.fetch`` span, the host waiting on the copies back: the card's
own gaps between kernels and the copy back; a part of
``device_idle.enroll.multihead`` (``perfbench/embed_spans.py``)."""

from perfbench.embed_spans import idle_share


def read(ctx):
    return idle_share(ctx, "embed.fetch")
