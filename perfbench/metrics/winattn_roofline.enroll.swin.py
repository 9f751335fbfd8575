"""winattn_roofline.enroll.swin: K8's share of its roofline, in percent:
per launch the windowed attention of a chunk's faces at one block (4 x 49
x C float32 operations and 16 x C bytes a token: its q, k and v read once,
its output written once), bound by the larger of the bytes over the HBM
rate and the operations over the float32 peak, summed over every
``k8_window_attention_kernel`` launch in the trace, over their device
time. Nothing is read unless the trace holds exactly the launches the
program counted in the window, in whole chunks (one launch a block), so
that no other kernel is ever read as K8."""

from perfbench.readers import roofline

NAME = "k8_window_attention_kernel"


def _is_k8(kernel: str) -> bool:
    return NAME in kernel


def read(ctx):
    launches = ctx.entry.get("winattn_launches")
    work = ctx.entry.get("winattn_work")
    if ctx.trace is None or not launches or not work or launches % len(work):
        return None
    if ctx.trace.kernel_time_s(_is_k8)[1] != launches:
        return None
    chunk = [(nbytes, ops, "f32") for ops, nbytes in work]
    return roofline(ctx, _is_k8, _is_k8, lambda calls: chunk * (calls // len(chunk)))
