"""The hand-written CUDA kernels' wrappers (K1 ``crop``, K2 ``knn``, K3
``warp``, K4 ``pw_conv``, K5 ``attention``, K6 ``bn_act``, K7
``bias_relu6``, K8 ``window_attention``) and their launch counters.

Each wrapper adds one to its ``launches`` where it launches its kernel and
nowhere else; ``kernel_launches`` reads every counter and
``reset_launches`` sets them to 0, so a run can show which kernels a path
went through.
"""

from __future__ import annotations

from typing import Dict


def _wrappers() -> Dict[str, object]:
    from . import attention, bn_act, crop, knn, pw_conv, warp

    return {"knn_f32": knn.nearest_neighbor_f32,
            "knn_int8q": knn.nearest_neighbor_int8q,
            "knn_int8p": knn.nearest_neighbor_int8p,
            "crop_resize": crop.crop_resize,
            "pw_conv_int8": pw_conv.pw_conv_int8,
            "warp_batch": warp.warp_batch,
            "attention": attention.attention,
            "window_attention": attention.window_attention,
            "bn_act": bn_act.bn_act,
            "bias_relu6": bn_act.bias_relu6}


def kernel_launches() -> Dict[str, int]:
    """Each kernel's launches since the last ``reset_launches``."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
