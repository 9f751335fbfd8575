"""device_idle.identify: percent of the traced part of the window in which
no kernel ran on the card; copies and sets leave the SMs idle and do not
count as busy."""

from perfbench.readers import device_idle


def read(ctx):
    return device_idle(ctx)
