"""On-device data augmentation for face training.

Counterpart of ``hse_facerec_tf_tpu/train/augment.py``: the reference's
Keras ImageDataGenerator policy (``facerec_keras_train.py:164-168``: shear
0.3, rotation ±10°, zoom ±0.2, width/height shift ±0.1, horizontal flip) as
one random inverse-affine warp per image, the whole batch on the device.
The warp is K3 (``ops/kernels/warp.py``) for a CUDA batch and its plain
version for a CPU batch; the device decides, so there is no backend knob.

The random numbers come from a ``torch.Generator``: seven uniforms per
image, drawn for the whole batch at once. They are not the reference's
``jax.random`` bits; ``affine_from_uniforms`` is the closed form of the
reference's ``_sample_affine`` on given uniforms, which the tests hold
against it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.kernels.warp import warp_batch


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    rotation_deg: float = 10.0
    shear: float = 0.3
    zoom: float = 0.2
    shift: float = 0.1
    horizontal_flip: bool = True
    fill_value: float = 0.0


def affine_from_uniforms(u, cfg: AugmentConfig, h: int, w: int):
    """(N, 7) f32 uniforms in [0, 1) -> (N, 2, 3) random inverse affines
    (output coords -> input coords, centered at the image midpoint), as the
    reference's ``_sample_affine`` makes one from the uniforms of its seven
    keys: rotation, shear, zoom x, zoom y, shift x, shift y, flip."""
    def between(k, lo, hi):                 # jax.random.uniform's affine map
        return torch.clamp(u[:, k] * (hi - lo) + lo, min=lo)

    theta = torch.deg2rad(between(0, -cfg.rotation_deg, cfg.rotation_deg))
    shear = between(1, -cfg.shear, cfg.shear)
    zx = 1.0 + between(2, -cfg.zoom, cfg.zoom)
    zy = 1.0 + between(3, -cfg.zoom, cfg.zoom)
    tx = between(4, -cfg.shift, cfg.shift) * w
    ty = between(5, -cfg.shift, cfg.shift) * h
    flip = torch.where((u[:, 6] < 0.5) & cfg.horizontal_flip, -1.0, 1.0)

    cos, sin = torch.cos(theta), torch.sin(theta)
    # forward = T(center+shift) @ R @ Shear @ Zoom @ Flip @ T(-center); a..d
    # are the inverse linear part: x_in = L_inv (x_out - center - t) + center
    a = cos / zx * flip
    b = (sin + shear * cos) / zy
    c = -sin / zx * flip
    d = (cos - shear * sin) / zy
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    row0 = torch.stack([a, b, cx - a * (cx + tx) - b * (cy + ty)], dim=1)
    row1 = torch.stack([c, d, cy - c * (cx + tx) - d * (cy + ty)], dim=1)
    return torch.stack([row0, row1], dim=1).to(torch.float32)


def sample_affine(generator: torch.Generator, cfg: AugmentConfig, n: int, h: int,
                  w: int):
    """(N, 2, 3) random inverse affines on the generator's device."""
    u = torch.rand((n, 7), generator=generator, device=generator.device)
    return affine_from_uniforms(u, cfg, h, w)


def augment_batch(generator: torch.Generator, images,
                  cfg: AugmentConfig = AugmentConfig()):
    """(N, H, W, C) f32 images -> the randomly warped batch (same shape),
    with ``generator`` on the images' device."""
    n, h, w, _ = images.shape
    return warp_batch(images, sample_affine(generator, cfg, n, h, w), cfg.fill_value)
