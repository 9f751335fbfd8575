"""mfu.enroll: the embedding model's FLOPs of every face embedded in the
window (the benchmark's count from the layer shapes), over the window's
seconds, over the float32 peak (67 T; the card's power limit is in the
result's ``card``), in percent."""

from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx)
