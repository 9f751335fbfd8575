"""idle_fetch.enroll: percent of the traced window in the ArcFace enrolment
cell with no kernel running while the program was in an ``embed.fetch``
span, the host waiting on the copies back: the card's own gaps between
kernels and the copy back; a part of ``device_idle.enroll``
(``perfbench/embed_spans.py``)."""

from perfbench.embed_spans import idle_share


def read(ctx):
    return idle_share(ctx, "embed.fetch")
