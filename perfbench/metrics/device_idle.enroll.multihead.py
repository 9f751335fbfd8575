"""device_idle.enroll.multihead: ``device_idle.enroll`` in the multi-head
enrolment cell, which reports ``faces_per_s.multihead``: percent of the
traced part of the window in which no kernel ran on the card."""

from perfbench.readers import device_idle


def read(ctx):
    return device_idle(ctx)
