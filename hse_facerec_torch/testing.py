"""Seeded random parameters for the analyze path and the zoo's
backbones, numpy only, seeded synthetic photos and a seeded synthetic LBP
cascade, and codec-free inputs: 24-bit BMP files, an in-memory video
capture and an album organizer that reads them (``BmpAlbumOrganizer``).
The card's machine has no JPEG, PNG or MP4 codec, so ``chip_smoke.py``
feeds photos and clips in these forms.

The pytrees have the reference's layouts and shapes (HWIO convs,
(H, W, C, 1) depthwise, (in, out) dense), so the same arrays go through
the JAX package and, via ``params.to_torch``, through the port. Used by the
parity tests and by ``chip_smoke.py`` when the shipped weights are absent.
The cascade (``write_lbp_cascade``) stands in for OpenCV's
``lbpcascade_frontalface.xml`` in the same file format.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from .models.mobilenet import MOBILENET_V1_BLOCKS
from .pipelines.album import AlbumOrganizer

# (name, kernel shape) per MTCNN layer with weights; shapes of the shipped
# mtcnn.pb (hse_facerec_tf_tpu/models/mtcnn.py:9-16)
MTCNN_SHAPES = {
    "pnet": [("conv1", (3, 3, 3, 10)), ("conv2", (3, 3, 10, 16)),
             ("conv3", (3, 3, 16, 32)), ("cls", (1, 1, 32, 2)),
             ("reg", (1, 1, 32, 4))],
    "rnet": [("conv1", (3, 3, 3, 28)), ("conv2", (3, 3, 28, 48)),
             ("conv3", (2, 2, 48, 64)), ("fc", (576, 128)),
             ("cls", (128, 2)), ("reg", (128, 4))],
    "onet": [("conv1", (3, 3, 3, 32)), ("conv2", (3, 3, 32, 64)),
             ("conv3", (3, 3, 64, 64)), ("conv4", (2, 2, 64, 128)),
             ("fc", (1152, 256)), ("cls", (256, 2)), ("reg", (256, 4)),
             ("lmk", (256, 10))],
}
# PReLU layers: the conv/fc they follow
MTCNN_PRELUS = {
    "pnet": ["conv1", "conv2", "conv3"],
    "rnet": ["conv1", "conv2", "conv3", "fc"],
    "onet": ["conv1", "conv2", "conv3", "conv4", "fc"],
}


def _dense(rng, shape, gain=1.0):
    fan_in = int(np.prod(shape[:-1]))
    return (rng.randn(*shape) * gain * np.sqrt(2.0 / fan_in)).astype(np.float32)


# face-logit bias per net: lifts P(face) of random candidates to around the
# default thresholds (0.6, 0.7, 0.9), so that boxes survive to stage 3
FACE_LOGIT_BIAS = {"pnet": 0.3, "rnet": 1.0, "onet": 2.0}


def synthetic_photo(seed: int, h: int, w: int) -> np.ndarray:
    """A seeded photo-like uint8 (h, w, 3) image: a bilinear upsample of an
    8x10 colour field plus noise. The seeded MTCNN weights find faces in
    such images."""
    import torch

    rng = np.random.RandomState(seed)
    low = torch.from_numpy(rng.rand(1, 3, 8, 10).astype(np.float32) * 255)
    img = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear")
    img = img[0].permute(1, 2, 0).numpy() + rng.randn(h, w, 3) * 8
    return np.clip(img, 0, 255).round().astype(np.uint8)


def random_mtcnn_params(rng: np.random.RandomState) -> Dict[str, Dict]:
    """{pnet, rnet, onet} with He-scaled kernels; the regression heads are
    scaled down so boxes move by a few percent, as trained ones do."""
    out = {}
    for net, layers in MTCNN_SHAPES.items():
        p = {}
        for name, shape in layers:
            gain = 0.1 if name in ("reg", "lmk") else 1.0
            p[name] = {"kernel": _dense(rng, shape, gain),
                       "bias": (rng.randn(shape[-1]) * 0.1).astype(np.float32)}
        p["cls"]["bias"][1] += FACE_LOGIT_BIAS[net]
        for i, src in enumerate(MTCNN_PRELUS[net], start=1):
            c = dict(layers)[src][-1]
            p[f"prelu{i}"] = {"alpha": rng.uniform(0.1, 0.3, c).astype(np.float32)}
        out[net] = p
    return out


def random_mobilenet_params(rng: np.random.RandomState) -> Dict:
    """Full-width MobileNet-V1 backbone (alpha 1.0) in the folded form
    ``core/pb_import.py`` returns. conv1 is scaled for inputs of
    mean-subtracted 0-255 pixels."""
    backbone = {"conv1": {"kernel": _dense(rng, (3, 3, 3, 32), 1.0 / 64),
                          "bias": (rng.randn(32) * 0.1).astype(np.float32)}}
    cin = 32
    for i, (_, cout) in enumerate(MOBILENET_V1_BLOCKS, start=1):
        # depthwise fan-in is the 3x3 window of one channel
        dw = rng.randn(3, 3, cin, 1) * np.sqrt(2.0 / 9.0)
        backbone[f"dw{i}"] = {"kernel": dw.astype(np.float32),
                              "bias": (rng.randn(cin) * 0.1).astype(np.float32)}
        backbone[f"pw{i}"] = {"kernel": _dense(rng, (1, 1, cin, cout)),
                              "bias": (rng.randn(cout) * 0.1).astype(np.float32)}
        cin = cout
    return backbone


def random_resnet50_params(rng: np.random.RandomState) -> Dict:
    """Full-width ResNet-50 (``models/resnet.py``, 2048-d) in the folded
    form ``core/pb_import.py`` returns. The stem is scaled for inputs of
    mean-subtracted 0-255 pixels, and each block's last conv by 0.5, so
    the residual sums stay in range over the 16 blocks."""
    from .models.resnet import STAGES, STAGE_WIDTHS

    def conv(kh, kw, cin, cout, gain=1.0):
        return {"kernel": _dense(rng, (kh, kw, cin, cout), gain),
                "bias": (rng.randn(cout) * 0.1).astype(np.float32)}

    params: Dict = {"stem": conv(7, 7, 3, 64, 1.0 / 64)}
    cin = 64
    for si, n_blocks in enumerate(STAGES):
        w1, w2, w3 = STAGE_WIDTHS[si]
        for bi in range(n_blocks):
            p = {"conv1": conv(1, 1, cin, w1), "conv2": conv(3, 3, w1, w2),
                 "conv3": conv(1, 1, w2, w3, 0.5)}
            if bi == 0:
                p["proj"] = conv(1, 1, cin, w3, 0.5)
            params[f"stage{si + 1}_block{bi + 1}"] = p
            cin = w3
    return params


def random_multihead_params(rng: np.random.RandomState) -> Dict:
    """Full-width multi-head MobileNet-V1 (alpha 1.0, 1024-d identity) in
    the folded form ``import_multihead_params`` returns: the backbone of
    ``random_mobilenet_params``, then the heads."""
    backbone = random_mobilenet_params(rng)

    def head(n_in, n_out, gain):
        return {"kernel": _dense(rng, (n_in, n_out), gain),
                "bias": (rng.randn(n_out) * 0.1).astype(np.float32)}

    return {"backbone": backbone, "feats": head(1024, 256, 1.0),
            "age": head(256, 100, 0.5), "gender": head(256, 1, 0.5)}


# the synthetic cascade: a 24x24 window and 20 boosted stages, as OpenCV's
# lbpcascade_frontalface.xml has, of 3 to 10 weak classifiers each
LBP_WINDOW, LBP_STAGES, LBP_FEATURES = 24, 20, 136


def _cascade_xml(rects, stages) -> str:
    """OpenCV's cascade XML for LBP ``rects`` (x, y, cell w, cell h) and
    ``stages`` [(threshold, [(feature, subset x8, (leaf0, leaf1))])];
    floats written with ``repr`` so that they read back exactly."""
    out = ['<?xml version="1.0"?>', "<opencv_storage>",
           '<cascade type_id="opencv-cascade-classifier">',
           "  <stageType>BOOST</stageType>", "  <featureType>LBP</featureType>",
           f"  <height>{LBP_WINDOW}</height>", f"  <width>{LBP_WINDOW}</width>",
           "  <stageParams><maxWeakCount>"
           f"{max(len(w) for _, w in stages)}</maxWeakCount></stageParams>",
           "  <featureParams><maxCatCount>256</maxCatCount></featureParams>",
           f"  <stageNum>{len(stages)}</stageNum>", "  <stages>"]
    for threshold, weak in stages:
        out += ["    <_>", f"      <maxWeakCount>{len(weak)}</maxWeakCount>",
                f"      <stageThreshold>{threshold!r}</stageThreshold>",
                "      <weakClassifiers>"]
        for feature, subset, leaves in weak:
            out += ["        <_>", "          <internalNodes>0 -1 "
                    + " ".join(str(int(v)) for v in (feature, *subset)) + "</internalNodes>",
                    f"          <leafValues>{leaves[0]!r} {leaves[1]!r}</leafValues></_>"]
        out += ["      </weakClassifiers></_>"]
    out += ["  </stages>", "  <features>"]
    out += [f"    <_>\n      <rect>{' '.join(str(int(v)) for v in r)}</rect></_>"
            for r in rects]
    out += ["  </features>", "</cascade>", "</opencv_storage>", ""]
    return "\n".join(out)


def write_lbp_cascade(path: str, images: Sequence[np.ndarray], seed: int = 0,
                      survivors: float = 2e-3) -> str:
    """Write a seeded synthetic LBP cascade to ``path`` and return it.

    Feature rects, subsets and leaf values are seeded; each stage's
    threshold is set on the windows of ``images`` (at
    ``LBPCascade.detect``'s defaults) that the stages before it pass: the
    quantile that keeps ``survivors ** (1 / 20)`` of them, so that about
    ``survivors`` of all windows reach the end and some neighbours of
    those form groups. The thresholds are taken with the port's own
    evaluator on the CPU."""
    import torch

    from .pipelines.lbp_cascade import LBPCascade

    rng = np.random.RandomState(seed)
    rects = []
    for _ in range(LBP_FEATURES):
        cw, ch = rng.randint(1, LBP_WINDOW // 3 + 1, 2)
        rects.append((rng.randint(0, LBP_WINDOW - 3 * cw + 1),
                      rng.randint(0, LBP_WINDOW - 3 * ch + 1), cw, ch))
    weak_counts = np.linspace(3, 10, LBP_STAGES).round().astype(int)
    stages = [[-np.inf, [(int(rng.randint(LBP_FEATURES)),
                          rng.randint(-2 ** 31, 2 ** 31, 8, dtype=np.int64),
                          tuple(float(v) for v in rng.uniform(-1.0, 1.0, 2)))
                         for _ in range(n)]] for n in weak_counts]
    with open(path, "w") as f:
        f.write(_cascade_xml(rects, [(-1e300, w) for _, w in stages]))
    cascade = LBPCascade(path, device="cpu")
    grids = []
    for img in images:
        w = cascade._windows(img, 1.1, 40, 2)
        win = torch.from_numpy(np.stack([w.base, w.stride, w.x, w.y]))
        grids.append((torch.from_numpy(w.integral), win, torch.arange(win.shape[1])))
    keep = survivors ** (1.0 / LBP_STAGES)
    for k, stage in enumerate(stages):
        totals = [cascade._stage_totals(k, integral, win[:, alive])
                  for integral, win, alive in grids]
        stage[0] = float(np.quantile(torch.cat(totals).numpy(), 1.0 - keep))
        grids = [(integral, win, alive[t >= stage[0]])
                 for (integral, win, alive), t in zip(grids, totals)]
    with open(path, "w") as f:
        f.write(_cascade_xml(rects, stages))
    return path


def bmp_bytes(rgb: np.ndarray) -> bytes:
    """A 24-bit uncompressed BMP (bottom-up BGR rows padded to 4 bytes) of
    an RGB uint8 (H, W, 3) image."""
    h, w = rgb.shape[:2]
    row = (3 * w + 3) & ~3
    px = np.zeros((h, row), np.uint8)
    px[:, :3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    return (struct.pack("<2sIHHI", b"BM", 54 + px.size, 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, px.size, 2835, 2835, 0, 0)
            + px.tobytes())


def decode_bmp(data: bytes) -> Optional[np.ndarray]:
    """A 24-bit uncompressed BMP (as ``bmp_bytes`` writes) -> RGB uint8
    (H, W, 3), or None for anything else (a server's image decoder)."""
    if len(data) < 54 or data[:2] != b"BM":
        return None
    offset, = struct.unpack_from("<I", data, 10)
    w, h, _, bits, compression = struct.unpack_from("<iiHHI", data, 18)
    row = (3 * w + 3) & ~3
    if bits != 24 or compression != 0 or len(data) < offset + row * abs(h):
        return None
    px = np.frombuffer(data, np.uint8, row * abs(h), offset).reshape(abs(h), row)
    px = px[:, :3 * w].reshape(abs(h), w, 3)
    return np.ascontiguousarray((px[::-1] if h > 0 else px)[:, :, ::-1])


def write_bmp(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(bmp_bytes(rgb))


def read_bmp(path: str) -> np.ndarray:
    """``write_bmp``'s files -> RGB uint8 (H, W, 3)."""
    with open(path, "rb") as f:
        img = decode_bmp(f.read())
    if img is None:
        raise ValueError(f"{path}: not a 24-bit uncompressed BMP")
    return img


class FrameCapture:
    """A capture over BGR frames in memory (``isOpened/grab/retrieve/release``),
    as ``AlbumOrganizer._open_video`` may return."""

    def __init__(self, frames):
        self.frames, self.pos, self.opened = frames, 0, True

    def isOpened(self):
        return self.opened

    def grab(self):
        self.pos += 1
        return self.pos <= len(self.frames)

    def retrieve(self):
        return True, self.frames[self.pos - 1]

    def release(self):
        self.opened = False


class BmpAlbumOrganizer(AlbumOrganizer):
    """The album organizer on codec-free files: photos through ``read_bmp``,
    clips (video-named placeholder files) served from ``clips``, BGR frames
    keyed by file name."""

    def __init__(self, *args, clips: Optional[Dict[str, List[np.ndarray]]] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.clips = clips or {}

    def _read_photo(self, path: str) -> np.ndarray:
        return read_bmp(path)

    def _open_video(self, path: str):
        return FrameCapture(self.clips[os.path.basename(path)])
