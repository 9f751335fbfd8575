"""k1_roofline.album: K1's share of its roofline, in percent: the least
time of the crops the traced calls' photos need (the plain reference's
stage-2 and stage-3 candidates and its faces: per crop the source pixels
its taps touch read once and the crop written once), over the device time
of every ``crop_resize_kernel`` launch in the traced calls (the padded
slots and the re-run lanes included: that is the gap)."""

from perfbench.readers import roofline


def read(ctx):
    work = ctx.entry.get("k1_work", [])
    return roofline(ctx, lambda k: "crop_resize_kernel" in k,
                    lambda k: "crop_resize_kernel" in k,
                    lambda launches: work) if work else None
