"""attn_roofline.enroll.vit: K5's share of its roofline, in percent: per
launch the attention of a chunk's faces (4 x H x T^2 x D float32 operations
a face, the qkv tensor read once and the output written once), bound by
the float32 peak, over the device time of every ``k5_attention_kernel``
launch in the trace. Nothing is read when the trace holds another number
of such launches than the program counted in the window, so that no other
kernel is ever read as K5."""

from perfbench.readers import roofline

NAME = "k5_attention_kernel"


def read(ctx):
    launches = ctx.entry.get("attn_launches")
    if ctx.trace is None or not launches:
        return None
    if ctx.trace.kernel_time_s(lambda k: NAME in k)[1] != launches:
        return None
    ops, nbytes = ctx.entry["attn_work"]
    return roofline(ctx, lambda k: NAME in k, lambda k: NAME in k,
                    lambda calls: [(nbytes, ops, "f32")] * calls)
