"""Seeded weights, made on the device from the seed in one draw per
distribution and handed to the program and to the reference alike.

The trees have the layouts the port's loaders take (the reference's: HWIO
convs, (H, W, C, 1) depthwise, (in, out) dense), as numpy views of one
host copy. The scales follow the port's seeded initialisers
(``testing.py::random_multihead_params`` and ``random_mtcnn_params``),
copied here so that a change to those cannot move the yardstick; the
IResNet's BN and PReLU leaves are drawn, not left at identity as in
``models/arcface.py::init_iresnet_params``, so that the comparison sees
them."""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch

# crops whose activations set an IResNet's BN moments
BN_FIT_CROPS = 64


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of a run, from the run's ``--seed``
    (any whole number) and the stream's name."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, tag))


class _Leaves:
    """Leaf specs gathered first, then drawn in one call per distribution:
    ("normal", std, mean), ("uniform", low, high) or ("const", value)."""

    def __init__(self):
        self.specs: List[Tuple[Tuple[str, ...], Tuple[int, ...], tuple]] = []

    def add(self, path, shape, dist):
        self.specs.append((tuple(path), tuple(int(s) for s in shape), dist))

    def draw(self, seed: int, tag: str, device) -> Dict:
        gen = generator(seed, tag, device)
        sizes = {"normal": 0, "uniform": 0}
        for _, shape, dist in self.specs:
            if dist[0] in sizes:
                sizes[dist[0]] += int(np.prod(shape))
        flat = {"normal": torch.randn(sizes["normal"], generator=gen, device=device),
                "uniform": torch.rand(sizes["uniform"], generator=gen, device=device)}
        scaled, offs = [], {"normal": 0, "uniform": 0}
        for _, shape, dist in self.specs:
            n = int(np.prod(shape))
            if dist[0] == "const":
                scaled.append(torch.full((n,), float(dist[1]), device=device))
                continue
            x = flat[dist[0]][offs[dist[0]]:offs[dist[0]] + n]
            offs[dist[0]] += n
            if dist[0] == "normal":
                scaled.append(x * np.float32(dist[1]) + np.float32(dist[2]))
            else:
                scaled.append(x * np.float32(dist[2] - dist[1]) + np.float32(dist[1]))
        host = torch.cat(scaled).cpu().numpy()
        tree: Dict = {}
        off = 0
        for path, shape, _ in self.specs:
            n = int(np.prod(shape))
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = host[off:off + n].reshape(shape)
            off += n
        return tree


def iresnet(cfg: Dict, seed: int, device) -> Dict:
    """IResNet (``cfg``: name, units, widths, input_size, embedding_dim):
    He normals for the convs, BN gamma U(0.5, 1.5) and beta N(0, 0.1),
    PReLU slopes U(0.1, 0.3) per channel, ``pre_fc1`` with std
    sqrt(1 / fan-in) and bias N(0, 0.1). Each BN's moments are then those
    of what reaches it, as a trained network's running moments are: the
    mean and variance over ``BN_FIT_CROPS`` seeded crops, the variance
    times a factor U(0.5, 1.5), set layer by layer through the plain
    reference (``reference/<name>.py``, ``fit_moments``). So every BN and
    every slope changes what comes out, and a fault in any of them shows."""
    from . import inputs
    from .spec import HERE, load_module

    leaves = _Leaves()
    w = cfg["widths"]

    def conv(path, kh, cin, cout):
        leaves.add(path, (kh, kh, cin, cout), ("normal", np.sqrt(2.0 / (kh * kh * cin)), 0.0))

    def bn(path, ch):
        leaves.add(path + ("gamma",), (ch,), ("uniform", 0.5, 1.5))
        leaves.add(path + ("beta",), (ch,), ("normal", 0.1, 0.0))
        leaves.add(path + ("mean",), (ch,), ("const", 0.0))          # fitted below
        leaves.add(path + ("var",), (ch,), ("uniform", 0.5, 1.5))    # the factor

    def slope(path, ch):
        leaves.add(path, (ch,), ("uniform", 0.1, 0.3))

    conv(("conv0",), 3, 3, w[0])
    bn(("bn0",), w[0])
    slope(("relu0_alpha",), w[0])
    in_ch = w[0]
    for s, n_units in enumerate(cfg["units"], start=1):
        out_ch = w[s]
        for u in range(1, n_units + 1):
            p = (f"stage{s}_unit{u}",)
            bn(p + ("bn1",), in_ch)
            conv(p + ("conv1",), 3, in_ch, out_ch)
            bn(p + ("bn2",), out_ch)
            slope(p + ("relu1_alpha",), out_ch)
            conv(p + ("conv2",), 3, out_ch, out_ch)
            bn(p + ("bn3",), out_ch)
            if u == 1:
                conv(p + ("conv1sc",), 1, in_ch, out_ch)
                bn(p + ("sc",), out_ch)
            in_ch = out_ch
    bn(("bn1",), in_ch)
    flat = (cfg["input_size"] // 2 ** len(cfg["units"])) ** 2 * in_ch
    emb = cfg["embedding_dim"]
    leaves.add(("pre_fc1", "kernel"), (flat, emb), ("normal", np.sqrt(1.0 / flat), 0.0))
    leaves.add(("pre_fc1", "bias"), (emb,), ("normal", 0.1, 0.0))
    bn(("fc1",), emb)
    tree = leaves.draw(seed, "weights.iresnet", device)
    size = cfg["input_size"]
    crops = inputs.images(BN_FIT_CROPS, size, size, seed, "weights.bn_fit", device)
    ref = load_module(HERE / "reference" / f"{cfg['name']}.py")
    return ref.fit_moments(tree, crops, device)


def _dense_std(shape, gain=1.0):
    return gain * np.sqrt(2.0 / int(np.prod(shape[:-1])))


def mobilenet_multihead(cfg: Dict, seed: int, device) -> Dict:
    """The folded multi-head MobileNet-V1 (kernel + bias per layer): conv1
    scaled for mean-subtracted 0-255 pixels (gain 1/64), depthwise std
    sqrt(2/9), pointwise and heads He, biases N(0, 0.1)."""
    leaves = _Leaves()
    ch = cfg["stem_width"]
    leaves.add(("backbone", "conv1", "kernel"), (3, 3, 3, ch),
               ("normal", _dense_std((3, 3, 3, ch), 1.0 / 64), 0.0))
    leaves.add(("backbone", "conv1", "bias"), (ch,), ("normal", 0.1, 0.0))
    for i, (_, out_ch) in enumerate(cfg["blocks"], start=1):
        leaves.add(("backbone", f"dw{i}", "kernel"), (3, 3, ch, 1),
                   ("normal", np.sqrt(2.0 / 9.0), 0.0))
        leaves.add(("backbone", f"dw{i}", "bias"), (ch,), ("normal", 0.1, 0.0))
        leaves.add(("backbone", f"pw{i}", "kernel"), (1, 1, ch, out_ch),
                   ("normal", _dense_std((1, 1, ch, out_ch)), 0.0))
        leaves.add(("backbone", f"pw{i}", "bias"), (out_ch,), ("normal", 0.1, 0.0))
        ch = out_ch
    for name, n_in, n_out, gain in (("feats", ch, cfg["feats_dim"], 1.0),
                                    ("age", cfg["feats_dim"], cfg["age_bins"], 0.5),
                                    ("gender", cfg["feats_dim"], 1, 0.5)):
        leaves.add((name, "kernel"), (n_in, n_out), ("normal", _dense_std((n_in, n_out), gain), 0.0))
        leaves.add((name, "bias"), (n_out,), ("normal", 0.1, 0.0))
    return leaves.draw(seed, "weights.multihead", device)


# MTCNN layer shapes of the shipped mtcnn.pb, the PReLU layers and the face
# logit lift that makes random candidates pass the default thresholds
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
MTCNN_PRELUS = {"pnet": ["conv1", "conv2", "conv3"],
                "rnet": ["conv1", "conv2", "conv3", "fc"],
                "onet": ["conv1", "conv2", "conv3", "conv4", "fc"]}
FACE_LOGIT_BIAS = {"pnet": 0.3, "rnet": 1.0, "onet": 2.0}


def mtcnn(seed: int, device) -> Dict:
    """{pnet, rnet, onet}: He kernels (the regression and landmark heads at
    gain 0.1), biases N(0, 0.1) with the face logit lifted by
    ``FACE_LOGIT_BIAS``, PReLU slopes U(0.1, 0.3)."""
    leaves = _Leaves()
    for net, layers in MTCNN_SHAPES.items():
        for name, shape in layers:
            gain = 0.1 if name in ("reg", "lmk") else 1.0
            leaves.add((net, name, "kernel"), shape, ("normal", _dense_std(shape, gain), 0.0))
            leaves.add((net, name, "bias"), (shape[-1],), ("normal", 0.1, 0.0))
        for i, src in enumerate(MTCNN_PRELUS[net], start=1):
            leaves.add((net, f"prelu{i}", "alpha"), (dict(layers)[src][-1],),
                       ("uniform", 0.1, 0.3))
    tree = leaves.draw(seed, "weights.mtcnn", device)
    for net, lift in FACE_LOGIT_BIAS.items():
        bias = tree[net]["cls"]["bias"].copy()
        bias[1] += np.float32(lift)
        tree[net]["cls"]["bias"] = bias
    return tree


def for_config(cfg: Dict, seed: int, device) -> Dict:
    """The configuration's embedding or analysis weights."""
    if cfg["model"] == "iresnet":
        return iresnet(cfg, seed, device)
    if cfg["model"] == "mobilenet_multihead":
        return mobilenet_multihead(cfg, seed, device)
    raise ValueError(f"no seeded weights for model {cfg['model']!r}")
