"""mfu.enroll.multihead: ``mfu.enroll`` in the multi-head enrolment cell,
which reports ``faces_per_s.multihead``: the model's FLOPs of every face
embedded in the window over its seconds, over the float32 peak, in
percent."""

from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx)
