"""idle_upload.enroll: percent of the traced window in the ArcFace
enrolment cell with no kernel running while the program was in an
``embed.upload`` span, the host copying a chunk's rows to the card; a
part of ``device_idle.enroll`` (``perfbench/embed_spans.py``)."""

from perfbench.embed_spans import idle_share


def read(ctx):
    return idle_share(ctx, "embed.upload")
