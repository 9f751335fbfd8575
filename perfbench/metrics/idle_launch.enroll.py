"""idle_launch.enroll: percent of the traced window in the ArcFace
enrolment cell with no kernel running while the program was in an
``embed.forward`` span, the host enqueueing a chunk's conversion,
resize, normalisation and backbone; a part of ``device_idle.enroll``
(``perfbench/embed_spans.py``)."""

from perfbench.embed_spans import idle_share


def read(ctx):
    return idle_share(ctx, "embed.forward")
