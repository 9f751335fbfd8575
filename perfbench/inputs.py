"""Seeded inputs, made on the device in bulk and copied to the host once:
the same seed gives the same inputs.

Both kinds follow the port's ``testing.synthetic_photo`` (a bilinear
upsample of a coarse colour field plus N(0, 8²) noise, rounded to uint8),
drawn here from the run's seed; the seeded MTCNN weights find faces in such
photos. A face crop is the same kind of image at the model's input size."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .weights import derive_seed, generator

FIELD_HW = (8, 10)       # the coarse colour field of synthetic_photo
NOISE_STD = 8.0


def images(n: int, h: int, w: int, seed: int, tag: str, device,
           chunk: int = 256) -> np.ndarray:
    """``n`` seeded uint8 RGB images (n, h, w, 3)."""
    gen = generator(seed, tag, device)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        low = torch.rand((m, 3) + FIELD_HW, generator=gen, device=device) * 255.0
        img = F.interpolate(low, size=(h, w), mode="bilinear")
        img = img + torch.randn(img.shape, generator=gen, device=device) * NOISE_STD
        img = torch.clamp(torch.round(img), 0.0, 255.0).to(torch.uint8)
        out[i:i + m] = img.permute(0, 2, 3, 1).cpu().numpy()
    return out


def noisy_copies(base: np.ndarray, amplitude: int, seed: int, tag: str,
                 device) -> np.ndarray:
    """``base`` uint8 images plus seeded uniform integer noise in
    [-amplitude, amplitude], clipped to 0-255."""
    gen = generator(seed, tag, device)
    x = torch.from_numpy(base).to(device).to(torch.int16)
    noise = torch.randint(-amplitude, amplitude + 1, x.shape, generator=gen,
                          device=device, dtype=torch.int16)
    return torch.clamp(x + noise, 0, 255).to(torch.uint8).cpu().numpy()


def unit_rows(n: int, dim: int, seed: int, tag: str, device,
              chunk: int = 1 << 18) -> np.ndarray:
    """``n`` seeded unit vectors (n, dim) f32: normals over their norms."""
    gen = generator(seed, tag, device)
    out = np.empty((n, dim), np.float32)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        x = torch.randn((m, dim), generator=gen, device=device)
        out[i:i + m] = (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).cpu().numpy()
    return out


def permutation(seed: int, tag: str, n: int) -> np.ndarray:
    """A permutation of ``n`` drawn from the seed on the host."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(
        derive_seed(seed, tag))).numpy()


def choice(seed: int, tag: str, n: int, k: int) -> np.ndarray:
    """``k`` distinct indices below ``n``, drawn from the seed, sorted."""
    return np.sort(permutation(seed, tag, n)[:min(k, n)])
