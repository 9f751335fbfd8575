"""Plain reference of the gallery's int8 1-NN (the reference package's
``nearest_neighbor_auto(int8=True)`` semantics), in PyTorch: rows
L2-normalised, one global symmetric scale ``max|x| / 127`` (exact
division), ``round`` half to even, clipped to [-127, 127]; a probe is
quantised the same way with its own scale; the squared L2 distance between
the dequantised vectors is ``sa²·|qa|² + sb²·|qb|² - 2·sa·sb·(qa·qb)``;
the nearest row is the least distance, the first index on ties.

``bits`` gives the control its lower precision: 4 quantises to [-7, 7]."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-10)


def quantize(x: torch.Tensor, bits: int = 8):
    """(q as float32 integers, scale), in float32 arithmetic: the scale is
    ``max|x| / top`` divided exactly, ``q = round(x / scale)`` clipped to
    [-top, top], top = 2^(bits-1) - 1."""
    top = float(2 ** (bits - 1) - 1)
    x = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(x)) / torch.tensor(top, device=x.device),
                        min=1e-30)
    q = x / scale
    q.round_().clamp_(-top, top)
    return q, float(scale)


class Gallery:
    """The quantised gallery of ``rows`` (N, D) float32 on their device."""

    def __init__(self, rows: torch.Tensor, bits: int = 8):
        self.bits = bits
        self.q, self.scale = quantize(l2_normalize(rows), bits)
        self.b2 = (self.q.to(torch.float64) ** 2).sum(dim=1)

    @torch.no_grad()
    def distances(self, probe: torch.Tensor) -> torch.Tensor:
        """(N,) float64 squared distances of one probe (D,) to every row.
        The integer dot is exact in float32: |qa·qb| < 2^24 for D <= 1040
        at 8 bits (with IEEE float32 matmuls)."""
        qa, sa = quantize(l2_normalize(probe[None].to(torch.float32)), self.bits)
        dot = (self.q @ qa[0]).to(torch.float64)
        a2 = float((qa.to(torch.float64) ** 2).sum())
        return sa * sa * a2 + self.scale * self.scale * self.b2 - 2.0 * sa * self.scale * dot

    def nearest(self, probe: torch.Tensor):
        """(index, distance) of the nearest row."""
        d2 = self.distances(probe)
        i = int(torch.argmin(d2))
        return i, float(torch.sqrt(torch.clamp(d2[i], min=0.0)))
