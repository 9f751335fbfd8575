"""The ViT configurations' seeded weights and the work they need, counted
from shapes: ``weights``, ``flops``, ``params`` and ``attention_work``.
``weights.for_config`` and ``flops.model_flops`` name the models they
know; a ViT cell's entry (``entries/extract_batch_vit.py``) takes its
weights and FLOPs from here instead.

The seeded weights make the attention visible to the comparison: W_q and
W_k are scaled so that a query row's scores spread with a standard
deviation of about ``SCORE_STD``, so the softmax is peaked and not near
uniform (near-uniform attention would hide a dropped scale or a softmax
over the wrong axis); LN gammas, betas, biases and ``pos_embed`` are drawn
so that each of them changes what comes out; each BN1d's moments are those
of what reaches it on ``weights.BN_FIT_CROPS`` seeded crops, the variance
times U(0.5, 1.5), as PR 18's IResNet BNs are."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .weights import BN_FIT_CROPS, _Leaves

SCORE_STD = 4.0
# E[gamma^2] of an LN gamma drawn U(0.5, 1.5): the spread of a normalised
# channel that reaches W_q and W_k
GAMMA_SQ = 1.0 + 1.0 / 12.0


def _shape(cfg: Dict) -> Tuple[int, int, int, int, int]:
    """(tokens, channels, heads, head size, hidden)."""
    tokens = (cfg["input_size"] // cfg["patch_size"]) ** 2
    c, heads = cfg["embed_dim"], cfg["num_heads"]
    return tokens, c, heads, c // heads, c * cfg["mlp_ratio"]


def weights(cfg: Dict, seed: int, device) -> Dict:
    """The configuration's ViT (``cfg``: input_size, patch_size, embed_dim,
    depth, num_heads, mlp_ratio, embedding_dim) in the port's layouts: HWIO
    patch conv, (in, out) dense, ``W_qkv`` (C, 3, H, D). Patch conv and
    W_1 He-normal; W_q and W_k N(0, SCORE_STD / (C E[gamma^2])), so that
    ``q.k / sqrt(D)``, whose spread is var(q) = C E[gamma^2] var(W_q), has
    about SCORE_STD's; W_v, W_o, W_2 and
    the head's two Linears N(0, 1 / fan-in); biases N(0, 0.1); LN gamma
    U(0.5, 1.5), beta N(0, 0.1); ``pos_embed`` N(0, 0.5); then the BN1d
    moments, fitted through the plain reference."""
    from . import inputs
    from .spec import HERE, load_module

    tokens, c, heads, d, hidden = _shape(cfg)
    p, emb = cfg["patch_size"], cfg["embedding_dim"]
    leaves = _Leaves()

    def normal(path, shape, std):
        leaves.add(path, shape, ("normal", float(std), 0.0))

    def bias(path, n):
        normal(path, (n,), 0.1)

    def ln(path):
        leaves.add(path + ("gamma",), (c,), ("uniform", 0.5, 1.5))
        normal(path + ("beta",), (c,), 0.1)

    def bn(path, n):
        leaves.add(path + ("gamma",), (n,), ("uniform", 0.5, 1.5))
        normal(path + ("beta",), (n,), 0.1)
        leaves.add(path + ("mean",), (n,), ("const", 0.0))          # fitted below
        leaves.add(path + ("var",), (n,), ("uniform", 0.5, 1.5))    # the factor

    normal(("patch_embed", "kernel"), (p, p, 3, c), np.sqrt(2.0 / (p * p * 3)))
    bias(("patch_embed", "bias"), c)
    normal(("pos_embed",), (tokens, c), 0.5)
    qk_std = np.sqrt(SCORE_STD / (c * GAMMA_SQ))
    for i in range(cfg["depth"]):
        b = (f"block{i}",)
        ln(b + ("norm1",))
        for j, std in enumerate((qk_std, qk_std, np.sqrt(1.0 / c))):
            normal(b + ("qkv", f"part{j}"), (c, 1, heads, d), std)
        normal(b + ("proj", "kernel"), (c, c), np.sqrt(1.0 / c))
        bias(b + ("proj", "bias"), c)
        ln(b + ("norm2",))
        normal(b + ("fc1", "kernel"), (c, hidden), np.sqrt(2.0 / c))
        bias(b + ("fc1", "bias"), hidden)
        normal(b + ("fc2", "kernel"), (hidden, c), np.sqrt(1.0 / hidden))
        bias(b + ("fc2", "bias"), c)
    ln(("norm",))
    normal(("fc1", "kernel"), (tokens * c, c), np.sqrt(1.0 / (tokens * c)))
    bn(("bn1",), c)
    normal(("fc2", "kernel"), (c, emb), np.sqrt(1.0 / c))
    bn(("bn2",), emb)
    tree = leaves.draw(seed, "weights.vit", device)
    for i in range(cfg["depth"]):
        qkv = tree[f"block{i}"]["qkv"]
        tree[f"block{i}"]["qkv"] = {"kernel": np.concatenate(
            [qkv.pop(f"part{j}") for j in range(3)], axis=1)}
    size = cfg["input_size"]
    crops = inputs.images(BN_FIT_CROPS, size, size, seed, "weights.bn_fit", device)
    ref = load_module(HERE / "reference" / f"{cfg['name']}.py")
    return ref.fit_moments(tree, crops, device, cfg)


def flops(cfg: Dict) -> float:
    """FLOPs of one face: 2 x the multiply-adds of the patch conv, each
    block's qkv, q.k, A.v, projection and MLP GEMMs, and the head's two
    Linears (LN, softmax, ReLU6 and BN not counted)."""
    tokens, c, heads, d, hidden = _shape(cfg)
    p = cfg["patch_size"]
    block = tokens * c * 3 * c + 2 * heads * tokens * tokens * d + tokens * c * c \
        + 2 * tokens * c * hidden
    macs = tokens * p * p * 3 * c + cfg["depth"] * block + tokens * c * c \
        + c * cfg["embedding_dim"]
    return 2.0 * macs


def params(cfg: Dict) -> int:
    """Learned parameters: weights, biases, LN and BN gammas and betas (the
    BNs' running moments not counted)."""
    tokens, c, heads, d, hidden = _shape(cfg)
    p, emb = cfg["patch_size"], cfg["embedding_dim"]
    block = 2 * 2 * c + c * 3 * c + c * c + c + c * hidden + hidden + hidden * c + c
    return (p * p * 3 * c + c + tokens * c + cfg["depth"] * block + 2 * c
            + tokens * c * c + 2 * c + c * emb + 2 * emb)


def attention_work(cfg: Dict, rows: int) -> Tuple[float, float]:
    """(operations, bytes) of one K5 launch over ``rows`` faces: q.k and
    A.v, 4 x H x T^2 x D a face; the qkv tensor read once and the output
    written once, float32."""
    tokens, c, heads, d, _ = _shape(cfg)
    ops = 4.0 * rows * heads * tokens * tokens * d
    nbytes = 4.0 * rows * tokens * (3 * c + c)
    return ops, nbytes
