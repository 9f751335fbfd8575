"""SSR-Net: soft-stagewise regression network for age (and gender).

Counterpart of ``hse_facerec_tf_tpu/models/ssrnet.py``. The reference
benchmarks the external SSR-Net demo models on UTKFace (``utkface_test.py:
258-288``): 64² input min-max normalized to 0-255, an age model and a
"general" gender model (same trunk, V=1 output range). The published
SSR_net(64, [3,3,3], 1, 1) architecture: two VALID-padded conv trunks
(ReLU/avg-pool stream and tanh/max-pool stream), per-stage 1×1-conv taps off
layers 4/3/2 multiplied across streams, and the soft stagewise regression
merge

  age = V · Σ_k  (Σ_i (i + λℓ·localᵏᵢ) predᵏᵢ) / Π_{j≤k} sⱼ(1 + λd·Δⱼ)

Params are numpy pytrees in the reference's layouts; the forward takes them
as tensors (``params.tree_to_torch``). Input keeps the reference's NHWC.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..numerics import precision_scope
from ..params import normal
from .layers import batch_norm, dense

STAGE_NUM = (3, 3, 3)


def _conv_valid(x, p):
    return F.conv2d(x, p["kernel"], p.get("bias"))


def _pool(x, k: int, kind: str):
    # k is 2 or 4: the mean's division by k·k is exact, as the reference's
    return F.avg_pool2d(x, k) if kind == "avg" else F.max_pool2d(x, k)


def _flatten_nhwc(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _trunk(params: Dict, x, prefix: str, act, pool_kind: str):
    """4 × (conv3x3 VALID → BN → act), pooled after the first three —
    returns the (layer2, layer3, layer4) taps the stages consume."""
    taps = []
    h = x
    for li in range(1, 5):
        p = params[f"{prefix}{li}"]
        bn = p["bn"]
        h = act(batch_norm(_conv_valid(h, p), bn["gamma"], bn["beta"],
                           bn["mean"], bn["var"]))
        if li < 4:
            h = _pool(h, 2, pool_kind)
        taps.append(h)
    return taps[1], taps[2], taps[3]


def _stage(params: Dict, k: int, s_tap, x_tap, pool: int):
    """One SSR stage: 1×1 conv (relu) on each stream tap [+ extra pooling],
    flatten, cross-stream multiply → Δ; dense mixes multiplied → shared
    feature → (pred, local)."""
    p = params[f"stage{k}"]

    def branch(tap, name, pool_kind):
        h = torch.relu(_conv_valid(tap, p[f"{name}_conv"]))
        if pool > 1:
            h = _pool(h, pool, pool_kind)
        return _flatten_nhwc(h)

    def fc(x, name):
        return dense(x, p[name]["kernel"], p[name]["bias"])

    s_flat = branch(s_tap, "s", "max")
    x_flat = branch(x_tap, "x", "avg")
    delta = torch.tanh(fc(s_flat * x_flat, "delta"))[:, 0]
    s_mix = torch.relu(fc(s_flat, "s_mix"))
    x_mix = torch.relu(fc(x_flat, "x_mix"))
    feat = torch.relu(fc(s_mix * x_mix, "feat"))
    return torch.relu(fc(feat, "pred")), delta, torch.tanh(fc(feat, "local"))


def ssr_merge(preds, deltas, locals_, stage_num=STAGE_NUM,
              lambda_local: float = 1.0, lambda_d: float = 1.0,
              V: float = 101.0):
    """The soft stagewise regression merge (demo code ``merge_age``)."""
    total = 0.0
    divisor = 1.0
    for k, s_k in enumerate(stage_num):
        # tanh can round to exactly ±1 in f32, zeroing the divisor; clamp
        # epsilon-inside the asymptote (≤1e-6 relative effect on real models)
        delta = torch.clamp(deltas[k], -1.0 + 1e-6, 1.0 - 1e-6)
        divisor = divisor * (s_k * (1.0 + lambda_d * delta))
        i = torch.arange(s_k, dtype=torch.float32, device=preds[k].device)
        contrib = torch.sum((i[None, :] + lambda_local * locals_[k]) * preds[k], dim=1)
        total = total + contrib / divisor
    return total * V


def ssrnet_apply(params: Dict, x, *, V: float = 101.0,
                 lambda_local: float = 1.0, lambda_d: float = 1.0,
                 precision="highest"):
    """(N, 64, 64, 3) float 0-255 → (N,) regression output (age, or 0-1 for
    the general/gender variant with V=1), at ``precision``'s tier."""
    with precision_scope(precision):
        return _ssrnet(params, x, V, lambda_local, lambda_d)


def _ssrnet(params: Dict, x, V: float, lambda_local: float, lambda_d: float):
    x = x.to(torch.float32).permute(0, 3, 1, 2)
    x2, x3, x4 = _trunk(params, x, "x", torch.relu, "avg")
    s2, s3, s4 = _trunk(params, x, "s", torch.tanh, "max")
    preds, deltas, locals_ = [], [], []
    for k, (s_tap, x_tap, pool) in enumerate(
            [(s4, x4, 1), (s3, x3, 2), (s2, x2, 4)], start=1):
        pred, delta, local = _stage(params, k, s_tap, x_tap, pool)
        preds.append(pred)
        deltas.append(delta)
        locals_.append(local)
    return ssr_merge(preds, deltas, locals_, STAGE_NUM, lambda_local, lambda_d, V)


def _h5_layers(path: str):
    """[(layer name, [arrays in weight order])] of a Keras h5, in the
    ``layer_names`` attr's order (numeric-aware name order without it)."""
    import h5py

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        names = root.attrs.get("layer_names")
        if names is not None:
            layer_names = [n.decode() if isinstance(n, bytes) else str(n)
                           for n in names]
        else:
            # conv2d_10 must sort after conv2d_2
            import re

            def key(n):
                m = re.match(r"(.*?)(\d+)$", n)
                return (m.group(1), int(m.group(2))) if m else (n, 0)

            layer_names = sorted(root.keys(), key=key)

        layers = []
        for name in layer_names:
            if name not in root:
                continue
            g = root[name]
            wnames = g.attrs.get("weight_names")
            if wnames is not None and len(wnames):
                arrs = [np.asarray(g[w.decode() if isinstance(w, bytes) else str(w)])
                        for w in wnames]
            else:
                arrs = []

                def collect(_, obj):
                    if isinstance(obj, h5py.Dataset):
                        arrs.append(np.asarray(obj))

                g.visititems(collect)
            if arrs:
                layers.append((name, arrs))
    return layers


def ssrnet_params_from_h5(path: str) -> Dict:
    """Map a published SSR-Net Keras h5 (demo ``SSR_net``/``SSR_net_general``
    constructors, the files ``utkface_test.py:258-288`` loads) onto the param
    pytree, as the JAX package's importer does.

    The demo model names only its stage heads (``delta_s{k}``,
    ``pred_age_stage{k}`` / ``pred_gender_stage{k}``,
    ``local_delta_stage{k}``); everything else carries Keras auto-names
    assigned in construction order: the relu/avg-pool x-stream (32-ch
    convs), the tanh/max-pool s-stream (16-ch convs), then the per-stage
    blocks for stage 1 (layer-4 taps), 2 (layer 3) and 3 (layer 2). Weighted
    layers are classified by type in the h5's ``layer_names`` order and
    every shape is validated: a layout that is not SSR-Net's raises."""
    convs3, convs1, bns, denses = [], [], [], []
    named: Dict[str, list] = {}
    for name, arrs in _h5_layers(path):
        kernels = [a for a in arrs if a.ndim == 4]
        if kernels:
            (convs3 if kernels[0].shape[0] == 3 else convs1).append((name, arrs))
        elif len(arrs) == 4 and all(a.ndim == 1 for a in arrs):
            bns.append((name, arrs))
        elif any(a.ndim == 2 for a in arrs):
            for pat in ("delta_s", "pred_age_stage", "pred_gender_stage",
                        "local_delta_stage"):
                if name.startswith(pat):
                    named[name] = arrs
                    break
            else:
                denses.append((name, arrs))

    def conv_p(entry, want_cin, want_cout, what):
        name, arrs = entry
        k = next(a for a in arrs if a.ndim == 4)
        b = next((a for a in arrs if a.ndim == 1), None)
        if k.shape[2] != want_cin or k.shape[3] != want_cout:
            raise ValueError(f"{path}: layer {name!r} kernel {k.shape} does "
                             f"not fit {what} (in {want_cin}, out {want_cout})")
        out = {"kernel": np.asarray(k, np.float32)}
        if b is not None:
            out["bias"] = np.asarray(b, np.float32)
        return out

    def bn_p(entry, ch, what):
        name, arrs = entry
        if any(a.shape != (ch,) for a in arrs):
            raise ValueError(f"{path}: layer {name!r} BN shapes "
                             f"{[a.shape for a in arrs]} do not fit {what} ({ch}-ch)")
        g, b, m, v = arrs  # Keras order: gamma, beta, moving_mean, moving_var
        return {"gamma": np.asarray(g, np.float32), "beta": np.asarray(b, np.float32),
                "mean": np.asarray(m, np.float32), "var": np.asarray(v, np.float32)}

    def dense_p(arrs, din, dout, what):
        k = next(a for a in arrs if a.ndim == 2)
        b = next((a for a in arrs if a.ndim == 1), None)
        if k.shape != (din, dout):
            raise ValueError(f"{path}: dense kernel {k.shape} does not fit "
                             f"{what} ({din} -> {dout})")
        return {"kernel": np.asarray(k, np.float32),
                "bias": (np.asarray(b, np.float32) if b is not None
                         else np.zeros((dout,), np.float32))}

    x_convs = [c for c in convs3 if c[1][0].shape[3] == 32]
    s_convs = [c for c in convs3 if c[1][0].shape[3] == 16]
    x_bns = [b for b in bns if b[1][0].shape[0] == 32]
    s_bns = [b for b in bns if b[1][0].shape[0] == 16]
    if len(x_convs) != 4 or len(s_convs) != 4:
        raise ValueError(f"{path}: expected 4+4 trunk convs, found "
                         f"{len(x_convs)} 32-ch / {len(s_convs)} 16-ch")
    if len(x_bns) != 4 or len(s_bns) != 4:
        raise ValueError(f"{path}: expected 4+4 trunk BNs, found "
                         f"{len(x_bns)} 32-ch / {len(s_bns)} 16-ch")
    if len(convs1) != 6:
        raise ValueError(f"{path}: expected 6 stage 1x1 convs, found {len(convs1)}")

    p: Dict = {}
    for prefix, convs, norms, ch in (("x", x_convs, x_bns, 32), ("s", s_convs, s_bns, 16)):
        in_ch = 3
        for li in range(1, 5):
            c = conv_p(convs[li - 1], in_ch, ch, f"{prefix}{li}")
            c["bn"] = bn_p(norms[li - 1], ch, f"{prefix}{li} bn")
            p[f"{prefix}{li}"] = c
            in_ch = ch

    # stage blocks are built stage 1 -> 3; within a stage the demo creates
    # s-branch then x-branch 1x1 convs, and s_mix, x_mix, feat denses
    flat_dims = {1: 4 * 4 * 10, 2: 3 * 3 * 10, 3: 3 * 3 * 10}
    s1x1 = [c for c in convs1 if c[1][0].shape[2] == 16]
    x1x1 = [c for c in convs1 if c[1][0].shape[2] == 32]
    if len(s1x1) != 3 or len(x1x1) != 3:
        raise ValueError(f"{path}: stage 1x1 convs split {len(s1x1)}/{len(x1x1)},"
                         " want 3/3")
    dense_iter = iter(denses)

    def next_dense(din, dout, what):
        try:
            name, arrs = next(dense_iter)
        except StopIteration:
            raise ValueError(f"{path}: ran out of unnamed dense layers at {what}")
        return dense_p(arrs, din, dout, f"{what} ({name})")

    for k, s_k in enumerate(STAGE_NUM, start=1):
        flat = flat_dims[k]
        stage = {
            "s_conv": conv_p(s1x1[k - 1], 16, 10, f"stage{k} s_conv"),
            "x_conv": conv_p(x1x1[k - 1], 32, 10, f"stage{k} x_conv"),
            "s_mix": next_dense(flat, s_k, f"stage{k} s_mix"),
            "x_mix": next_dense(flat, s_k, f"stage{k} x_mix"),
            "feat": next_dense(s_k, 2 * s_k, f"stage{k} feat"),
        }
        for slot, prefixes, din, dout in (
                ("delta", (f"delta_s{k}",), flat, 1),
                ("pred", (f"pred_age_stage{k}", f"pred_gender_stage{k}"),
                 2 * s_k, s_k),
                ("local", (f"local_delta_stage{k}",), 2 * s_k, s_k)):
            arrs = next((named[n] for n in prefixes if n in named), None)
            if arrs is None:
                raise KeyError(f"{path}: missing named SSR-Net head "
                               f"{' / '.join(prefixes)}")
            stage[slot] = dense_p(arrs, din, dout, f"stage{k} {slot}")
        p[f"stage{k}"] = stage
    return p


def init_ssrnet_params(generator: torch.Generator) -> Dict:
    """He-normal convs, N(0, 0.05) dense layers, identity BN, zero biases:
    numpy params for 64² inputs, normals drawn from ``generator``."""
    def conv(kh, kw, cin, cout):
        return {"kernel": normal(generator, (kh, kw, cin, cout),
                                 np.sqrt(2.0 / (kh * kw * cin))),
                "bias": np.zeros(cout, np.float32)}

    def bn(ch):
        return {"gamma": np.ones(ch, np.float32), "beta": np.zeros(ch, np.float32),
                "mean": np.zeros(ch, np.float32), "var": np.ones(ch, np.float32)}

    def dense_p(din, dout):
        return {"kernel": normal(generator, (din, dout), 0.05),
                "bias": np.zeros(dout, np.float32)}

    p: Dict = {}
    for prefix, ch in (("x", 32), ("s", 16)):
        in_ch = 3
        for li in range(1, 5):
            c = conv(3, 3, in_ch, ch)
            c["bn"] = bn(ch)
            p[f"{prefix}{li}"] = c
            in_ch = ch
    # tap spatial sizes for 64² input: layer4 4², layer3 6²→pool2→3²,
    # layer2 14²→pool4→3²
    flat_dims = {1: 4 * 4 * 10, 2: 3 * 3 * 10, 3: 3 * 3 * 10}
    for k, s_k in enumerate(STAGE_NUM, start=1):
        flat = flat_dims[k]
        p[f"stage{k}"] = {
            "s_conv": conv(1, 1, 16, 10), "x_conv": conv(1, 1, 32, 10),
            "delta": dense_p(flat, 1), "s_mix": dense_p(flat, s_k),
            "x_mix": dense_p(flat, s_k), "feat": dense_p(s_k, 2 * s_k),
            "pred": dense_p(2 * s_k, s_k), "local": dense_p(2 * s_k, s_k),
        }
    return p
