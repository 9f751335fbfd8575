"""LBP cascade face detector over OpenCV's cascade XML.

Counterpart of ``hse_facerec_tf_tpu/pipelines/lbp_cascade.py``. The
reference's fallback detector is ``cv2.CascadeClassifier`` over
``lbpcascade_frontalface.xml`` (``facial_analysis.py:63,210-223``); OpenCV 5
dropped the legacy cascade API, so both packages evaluate the XML
themselves: boosted stages of multi-block LBP features on an integral
image, over sliding windows at every scale, then min-neighbors rectangle
grouping. OpenCV's LBP semantics: a 3×3 grid of cells per feature, the 8
neighbour-vs-centre comparisons packed clockwise from the top left (TL =
128 ... L = 1), a 256-bit subset choosing between two leaf values, the
stage's sum against its threshold.

Where the work goes: the XML parse, the gray conversion, the area
downscale of each scale, its integral image (numpy, ``cumsum(0).cumsum(1)``)
and the grouping stay on the host. The stages run on ``device`` over the
windows of all scales at once, in float64: the integral images go up in
one copy, and each stage evaluates the windows still alive. The boxes equal
the JAX module's: every sum is formed in its order (the four-term cell sum
left to right, the leaf values added feature by feature), so each ``>=``
sees the same float64 values.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.zoo import REFERENCE_ROOT
from .detector import resolve_device

REFERENCE_CASCADE = os.path.join(REFERENCE_ROOT, "age_gender_identity",
                                 "lbpcascade_frontalface.xml")
GRAY = np.array([0.299, 0.587, 0.114])


@dataclass
class _Stage:
    threshold: float
    feat_idx: np.ndarray      # (F,) int
    subsets: np.ndarray       # (F, 8) int64 of the int32 bitmasks (256 bits)
    leaves: np.ndarray        # (F, 2) float64


@dataclass
class _Windows:
    """Every window of every scale: the scales' integral images flattened
    into one float64 buffer, and per window its image's offset in it, its
    row stride and its top left (x, y) at its scale."""
    integral: np.ndarray      # flat float64
    base: np.ndarray          # (n,) int64
    stride: np.ndarray
    x: np.ndarray
    y: np.ndarray
    scales: List[Tuple[float, int]]   # (scale, windows) in order


class LBPCascade:
    """An LBP cascade read from ``xml_path`` (OpenCV's format; a missing
    file raises), evaluated on ``device``."""

    def __init__(self, xml_path: Optional[str] = None, device="cuda"):
        root = ET.parse(xml_path or REFERENCE_CASCADE).getroot()
        c = root.find("cascade")
        self.win_h = int(c.findtext("height"))
        self.win_w = int(c.findtext("width"))
        if c.findtext("featureType").strip() != "LBP":
            raise ValueError("LBP cascades only")
        self.rects = np.asarray([[int(v) for v in f.findtext("rect").split()]
                                 for f in c.find("features")], dtype=np.int64)  # x, y, w, h
        self.stages: List[_Stage] = []
        for s in c.find("stages"):
            fidx, subsets, leaves = [], [], []
            for wc in s.find("weakClassifiers"):
                internal = wc.findtext("internalNodes").split()   # 0 -1 feature subset x8
                fidx.append(int(internal[2]))
                subsets.append([int(v) for v in internal[3:11]])
                leaves.append([float(v) for v in wc.findtext("leafValues").split()])
            self.stages.append(_Stage(float(s.findtext("stageThreshold")), np.asarray(fidx),
                                      np.asarray(subsets, dtype=np.int64),
                                      np.asarray(leaves, dtype=np.float64)))
        self.device = resolve_device(device)
        # per stage on the device: feature rects (F, 4), subsets (F, 8), leaves (F, 2)
        self._stage_tensors = [tuple(torch.from_numpy(a).to(self.device) for a in (
            self.rects[st.feat_idx], st.subsets, st.leaves)) for st in self.stages]

    def _windows(self, img_rgb: np.ndarray, scale_factor: float, min_size: int,
                 step: int) -> _Windows:
        """The reference's scale loop on the host: gray, area downscale and
        integral image per scale, and the window grid at each."""
        gray = np.asarray(img_rgb, dtype=np.float64) @ GRAY
        H, W = gray.shape
        flats, bases, strides, xs_all, ys_all, scales = [], [], [], [], [], []
        offset = 0
        scale = max(1.0, min_size / self.win_w)
        while self.win_w * scale <= W and self.win_h * scale <= H:
            sw, sh = int(W * (1.0 / scale)), int(H * (1.0 / scale))
            gx = np.arange(0, sw - self.win_w + 1, step)
            gy = np.arange(0, sh - self.win_h + 1, step)
            if len(gx) == 0 or len(gy) == 0:
                break
            integral = np.zeros((sh + 1, sw + 1))
            integral[1:, 1:] = _area_downscale(gray, sh, sw).cumsum(0).cumsum(1)
            xs, ys = np.meshgrid(gx, gy)
            n = xs.size
            flats.append(integral.ravel())
            bases.append(np.full(n, offset, np.int64))
            strides.append(np.full(n, sw + 1, np.int64))
            xs_all.append(xs.ravel())
            ys_all.append(ys.ravel())
            scales.append((scale, n))
            offset += integral.size
            scale *= scale_factor

        def cat(parts, dtype):
            return np.concatenate(parts).astype(dtype) if parts else np.zeros(0, dtype)
        return _Windows(cat(flats, np.float64), cat(bases, np.int64), cat(strides, np.int64),
                        cat(xs_all, np.int64), cat(ys_all, np.int64), scales)

    def _stage_totals(self, k: int, integral, win) -> torch.Tensor:
        """Stage ``k``'s sums (n,) float64 at windows ``win`` (4, n) [base,
        stride, x, y] of the flat ``integral``: per feature its 16 grid
        corners, 9 cell sums, the LBP code, the subset bit and a leaf,
        vectorized over windows and features; the leaves added feature by
        feature."""
        rects, subsets, leaves = self._stage_tensors[k]
        base, stride, x, y = (v[:, None] for v in win)               # (n, 1)
        rx, ry, cw, ch = rects.unbind(1)                               # (F,)
        x0, y0 = x + rx, y + ry                                        # (n, F)
        p = [[integral[base + (y0 + r * ch) * stride + (x0 + c * cw)] for c in range(4)]
             for r in range(4)]
        cells = [[p[r + 1][c + 1] - p[r][c + 1] - p[r + 1][c] + p[r][c] for c in range(3)]
                 for r in range(3)]
        center = cells[1][1]
        ring = (cells[0][0], cells[0][1], cells[0][2], cells[1][2],
                cells[2][2], cells[2][1], cells[2][0], cells[1][0])
        code = torch.zeros_like(x0)
        for i, cell in enumerate(ring):
            code = code | ((cell >= center).to(torch.int64) << (7 - i))
        words = subsets[torch.arange(subsets.shape[0], device=code.device), code >> 5]
        bit = (words >> (code & 31)) & 1
        vals = torch.where(bit == 1, leaves[:, 0], leaves[:, 1])      # (n, F)
        total = torch.zeros(vals.shape[0], dtype=torch.float64, device=vals.device)
        for f in range(vals.shape[1]):
            total = total + vals[:, f]
        return total

    def _eval_windows(self, integral, win) -> torch.Tensor:
        """Indices of the windows that pass every stage; each stage
        evaluates the windows alive after the one before (the reference's
        shrinking mask), and the loop ends when none is."""
        alive = torch.arange(win.shape[1], device=win.device)
        for k, stage in enumerate(self.stages):
            if alive.numel() == 0:
                break
            total = self._stage_totals(k, integral, win[:, alive])
            alive = alive[total >= stage.threshold]
        return alive

    def detect(self, img_rgb: np.ndarray, scale_factor: float = 1.1,
               min_neighbors: int = 3, min_size: int = 40, step: int = 2) -> np.ndarray:
        """(H, W, 3) RGB -> (n, 5) [x1, y1, x2, y2, neighbours] face boxes."""
        w = self._windows(img_rgb, scale_factor, min_size, step)
        keep = np.zeros(len(w.x), bool)
        if len(w.x):
            integral = torch.from_numpy(w.integral).to(self.device)
            win = torch.from_numpy(np.stack([w.base, w.stride, w.x, w.y])).to(self.device)
            keep[self._eval_windows(integral, win).cpu().numpy()] = True
        candidates: List[Tuple[int, int, int, int]] = []
        start = 0
        for scale, n in w.scales:
            sel = np.nonzero(keep[start:start + n])[0] + start
            for x, y in zip(w.x[sel], w.y[sel]):
                candidates.append((int(x * scale), int(y * scale),
                                   int((x + self.win_w) * scale),
                                   int((y + self.win_h) * scale)))
            start += n
        return _group_rectangles(candidates, min_neighbors)


def _area_downscale(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Quick area-average downscale (host numpy)."""
    H, W = img.shape
    yi = (np.linspace(0, H, oh + 1)).astype(np.int64)
    xi = (np.linspace(0, W, ow + 1)).astype(np.int64)
    integ = np.zeros((H + 1, W + 1))
    integ[1:, 1:] = img.cumsum(0).cumsum(1)
    ys0, ys1 = yi[:-1], yi[1:]
    xs0, xs1 = xi[:-1], xi[1:]
    sums = (integ[np.ix_(ys1, xs1)] - integ[np.ix_(ys0, xs1)]
            - integ[np.ix_(ys1, xs0)] + integ[np.ix_(ys0, xs0)])
    areas = np.maximum((ys1 - ys0)[:, None] * (xs1 - xs0)[None, :], 1)
    return sums / areas


def _group_rectangles(rects: List[Tuple[int, int, int, int]],
                      min_neighbors: int) -> np.ndarray:
    """cv2.groupRectangles-style clustering: union similar rects (every
    corner within 0.2 of the narrower width), average each group, keep
    groups with more than ``min_neighbors`` members. Groups come out in the
    order of their first member, as the reference's do; each rect's
    similar successors are found in one vectorized pass."""
    n = len(rects)
    if n == 0:
        return np.zeros((0, 5))
    r = np.asarray(rects, dtype=np.float64)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    w = r[:, 2] - r[:, 0]
    eps = 0.2
    for i in range(n - 1):
        delta = eps * np.minimum(w[i], w[i + 1:])
        close = np.all(np.abs(r[i] - r[i + 1:]) <= delta[:, None], axis=1)
        for j in np.nonzero(close)[0] + i + 1:
            ri, rj = find(i), find(int(j))
            if ri != rj:
                parent[rj] = ri
    groups = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    out = []
    for members in groups.values():
        if len(members) <= min_neighbors:
            continue
        avg = r[members].mean(axis=0)
        out.append([*avg, float(len(members))])
    return np.asarray(out) if out else np.zeros((0, 5))
