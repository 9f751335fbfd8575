"""mfu.identify: the work the window's finished requests needed (each real
face's IResNet FLOPs at the float32 peak, each query's int8 1-NN over the
gallery at the int8 peak), as a share of the window's seconds, in percent:
the whole step's share of the card beside K2c's roofline."""

from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx)
