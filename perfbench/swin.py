"""The Swin configurations' seeded weights and the work they need, counted
from shapes: ``weights``, ``flops``, ``params`` and
``window_attention_work``. A Swin cell's entry
(``entries/extract_batch_swin.py``) takes its weights and FLOPs from here,
as a ViT cell's takes them from ``vit.py``.

The seeded weights make the windowed attention visible to the comparison:
W_q and W_k are scaled so that a query row's scores spread with a standard
deviation of about ``vit.SCORE_STD`` (a peaked softmax, so a dropped shift
or mask moves the output); each relative-position bias table is N(0, 1),
so that a dropped or transposed bias shows beside scores of that spread;
LN gammas U(0.5, 1.5), betas and biases N(0, 0.1); each BN1d's moments
those of what reaches it on ``weights.BN_FIT_CROPS`` seeded crops, the
variance times U(0.5, 1.5), as the ViT's are."""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

from .vit import GAMMA_SQ, SCORE_STD
from .weights import BN_FIT_CROPS, _Leaves


def stages(cfg: Dict) -> Iterator[Tuple[int, int, int, int, bool]]:
    """Per stage (blocks, map side R, channels C, heads, merged after)."""
    r, c = cfg["input_size"] // cfg["patch_size"], cfg["embed_dim"]
    last = len(cfg["depths"]) - 1
    for s, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        yield depth, r, c, heads, s < last
        r, c = r // 2, c * 2


def _final_width(cfg: Dict) -> int:
    return cfg["embed_dim"] * 2 ** (len(cfg["depths"]) - 1)


def weights(cfg: Dict, seed: int, device) -> Dict:
    """The configuration's Swin (``cfg``: input_size, patch_size,
    embed_dim, depths, num_heads, window_size, mlp_ratio, embedding_dim) in
    the port's layouts: HWIO patch conv, (in, out) dense, ``W_qkv`` (C, 3,
    H, D) with a (3 H D) bias, each block's bias table (169, H). Patch conv
    and W_1 He-normal; W_q and W_k N(0, SCORE_STD / (C E[gamma^2])); W_v,
    W_o, W_2, the merges' reductions and the head's two Linears N(0, 1 /
    fan-in); biases N(0, 0.1); bias tables N(0, 1); LN gamma U(0.5, 1.5),
    beta N(0, 0.1); then the BN1d moments, fitted through the plain
    reference."""
    from . import inputs
    from .spec import HERE, load_module

    p, emb, mlp = cfg["patch_size"], cfg["embedding_dim"], cfg["mlp_ratio"]
    table = (2 * cfg["window_size"] - 1) ** 2
    leaves = _Leaves()

    def normal(path, shape, std):
        leaves.add(path, shape, ("normal", float(std), 0.0))

    def bias(path, n):
        normal(path, (n,), 0.1)

    def ln(path, n):
        leaves.add(path + ("gamma",), (n,), ("uniform", 0.5, 1.5))
        normal(path + ("beta",), (n,), 0.1)

    def bn(path, n):
        leaves.add(path + ("gamma",), (n,), ("uniform", 0.5, 1.5))
        normal(path + ("beta",), (n,), 0.1)
        leaves.add(path + ("mean",), (n,), ("const", 0.0))          # fitted below
        leaves.add(path + ("var",), (n,), ("uniform", 0.5, 1.5))    # the factor

    c0 = cfg["embed_dim"]
    normal(("patch_embed", "kernel"), (p, p, 3, c0), np.sqrt(2.0 / (p * p * 3)))
    bias(("patch_embed", "bias"), c0)
    ln(("patch_norm",), c0)
    for s, (depth, _, c, heads, merged) in enumerate(stages(cfg)):
        qk_std = np.sqrt(SCORE_STD / (c * GAMMA_SQ))
        for i in range(depth):
            b = (f"stage{s}", f"block{i}")
            ln(b + ("norm1",), c)
            for j, std in enumerate((qk_std, qk_std, np.sqrt(1.0 / c))):
                normal(b + ("qkv", f"part{j}"), (c, 1, heads, c // heads), std)
            bias(b + ("qkv", "bias"), 3 * c)
            normal(b + ("rel_bias_table",), (table, heads), 1.0)
            normal(b + ("proj", "kernel"), (c, c), np.sqrt(1.0 / c))
            bias(b + ("proj", "bias"), c)
            ln(b + ("norm2",), c)
            normal(b + ("fc1", "kernel"), (c, mlp * c), np.sqrt(2.0 / c))
            bias(b + ("fc1", "bias"), mlp * c)
            normal(b + ("fc2", "kernel"), (mlp * c, c), np.sqrt(1.0 / (mlp * c)))
            bias(b + ("fc2", "bias"), c)
        if merged:
            m = (f"stage{s}", "merge")
            ln(m + ("norm",), 4 * c)
            normal(m + ("reduction", "kernel"), (4 * c, 2 * c), np.sqrt(1.0 / (4 * c)))
    c = _final_width(cfg)
    ln(("norm",), c)
    normal(("fc1", "kernel"), (c, c), np.sqrt(1.0 / c))
    bn(("bn1",), c)
    normal(("fc2", "kernel"), (c, emb), np.sqrt(1.0 / c))
    bn(("bn2",), emb)
    tree = leaves.draw(seed, "weights.swin", device)
    for s, (depth, *_) in enumerate(stages(cfg)):
        for i in range(depth):
            qkv = tree[f"stage{s}"][f"block{i}"]["qkv"]
            qkv["kernel"] = np.concatenate([qkv.pop(f"part{j}") for j in range(3)], axis=1)
    size = cfg["input_size"]
    crops = inputs.images(BN_FIT_CROPS, size, size, seed, "weights.bn_fit", device)
    ref = load_module(HERE / "reference" / f"{cfg['name']}.py")
    return ref.fit_moments(tree, crops, device, cfg)


def flops(cfg: Dict) -> float:
    """FLOPs of one face: 2 x the multiply-adds of the patch conv, each
    block's qkv, q.k, A.v, projection and MLP GEMMs, each merge's
    reduction and the head's two Linears (LN, softmax, GELU, the mean and
    BN not counted)."""
    r = cfg["input_size"] // cfg["patch_size"]
    macs = r * r * cfg["patch_size"] ** 2 * 3 * cfg["embed_dim"]
    t, mlp = cfg["window_size"] ** 2, cfg["mlp_ratio"]
    for depth, r, c, _, merged in stages(cfg):
        n = r * r
        macs += depth * (n * c * 3 * c + 2 * n * t * c + n * c * c + 2 * n * c * mlp * c)
        if merged:
            macs += (n // 4) * 4 * c * 2 * c
    c = _final_width(cfg)
    return 2.0 * (macs + c * c + c * cfg["embedding_dim"])


def params(cfg: Dict) -> int:
    """Learned parameters: weights, biases, bias tables, LN and BN gammas
    and betas (the BNs' running moments not counted)."""
    p, mlp = cfg["patch_size"], cfg["mlp_ratio"]
    table = (2 * cfg["window_size"] - 1) ** 2
    c0, emb = cfg["embed_dim"], cfg["embedding_dim"]
    n = p * p * 3 * c0 + c0 + 2 * c0
    for depth, _, c, heads, merged in stages(cfg):
        block = 2 * c + c * 3 * c + 3 * c + table * heads + c * c + c + 2 * c \
            + c * mlp * c + mlp * c + mlp * c * c + c
        n += depth * block
        if merged:
            n += 2 * 4 * c + 4 * c * 2 * c
    c = _final_width(cfg)
    return n + 2 * c + c * c + 2 * c + c * emb + 2 * emb


def window_attention_work(cfg: Dict, rows: int) -> List[Tuple[float, float]]:
    """(operations, bytes) of each K8 launch of a chunk of ``rows`` faces,
    in launch order (one a block): q.k and A.v, 4 x 49 x C operations a
    token; a token's q, k and v read once and its output written once,
    16 x C bytes float32."""
    t = cfg["window_size"] ** 2
    return [(4.0 * t * c * r * r * rows, 16.0 * c * r * r * rows)
            for depth, r, c, _, _ in stages(cfg) for _ in range(depth)]
