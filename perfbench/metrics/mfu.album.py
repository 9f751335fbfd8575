"""mfu.album: the FLOPs that the window's photos need, counted from the
plain reference's cascade on the same photos (P-Net on every pyramid
level, R-Net and O-Net on the candidates that reach them, the multi-head
net on the faces), never from what the program ran, over the window's
seconds, over the float32 peak, in percent."""

from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx)
