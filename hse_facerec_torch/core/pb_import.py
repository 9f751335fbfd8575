"""Structural frozen-pb → native-pytree weight importers.

The port's own copy of ``hse_facerec_tf_tpu/core/pb_import.py`` (numpy, on
the port's ``CompiledGraph`` pruning): it returns the same params, bit for
bit, in the reference's numpy layouts.

The reference loads its two flagship embedders straight from frozen graphs
(``facerec_test.py:212-213``: ``models/vgg2_mobilenet.pb`` ``input_1:0 →
reshape_1/Reshape:0`` and ``models/vgg2_resnet.pb`` ``input:0 →
pool5_7x7_s1:0``). Those blobs are absent upstream, so this importer cannot
key on node NAMES; instead it walks the graph *structure* — the dataflow
from the input placeholder through conv/BN/activation chains — and binds
each weight constant to the corresponding slot of the native param pytree
(``models/mobilenet.py`` / ``models/resnet.py``). Learning-phase
``Switch``/``Merge`` branches and ``Dequantize`` weight triples are resolved
by the graph compiler's pruning pass, so frozen-Keras graphs (unfolded
``FusedBatchNorm`` + bool learning-phase placeholder, the form
``freeze_session`` emits — reference ``facerec_keras_train.py:70-83``) and
graph_transforms-folded graphs both import.

All affine ops between a conv and its activation (FusedBatchNorm, BiasAdd,
Mul/Add/Sub by constants — including constant *expressions* like
``gamma·rsqrt(var+eps)``) are folded numerically into a per-channel
(scale, bias); the scale is folded into the conv kernel, so every imported
block is the native folded form ``{"kernel", "bias"}``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph_compiler import CompiledGraph, _tname
from .graphdef import DT_FLOAT, NodeDef, extract_constants, load_graphdef


class GraphStructureError(ValueError):
    """The graph's dataflow does not match the expected architecture."""


_ACTIVATIONS = {"Relu", "Relu6", "Elu", "Selu", "Tanh", "Sigmoid", "Softmax"}
_PASS = {"Identity", "CheckNumerics", "StopGradient", "Switch", "Merge"}
_RELU6 = "Relu6"


class _Walk:
    """Consumer-graph walker over the pruned (live-branch) node set."""

    def __init__(self, pb_path: str, outputs: Sequence[str]):
        self.graph = load_graphdef(pb_path)
        self.consts = extract_constants(self.graph)
        cg = CompiledGraph(self.graph, outputs, self.consts)
        self.nodes: List[NodeDef] = cg._needed
        memo: Dict = {}
        self.eff_inputs = {n.name: list(cg._data_inputs(n, memo))
                           for n in self.nodes}
        self.succ: Dict[str, List[NodeDef]] = defaultdict(list)
        for n in self.nodes:
            for ref in self.eff_inputs[n.name]:
                self.succ[_tname(ref)].append(n)
        self._const_memo: Dict[str, Optional[np.ndarray]] = {}

    def placeholder(self) -> NodeDef:
        phs = [n for n in self.nodes if n.op == "Placeholder"
               and (n.attrs.get("dtype") is None
                    or n.attrs["dtype"].type == DT_FLOAT)]
        if len(phs) != 1:
            raise GraphStructureError(
                f"expected exactly one float input placeholder, found "
                f"{[p.name for p in phs]}")
        return phs[0]

    def eval_const(self, ref: str, _depth: int = 0) -> Optional[np.ndarray]:
        """Numerically evaluate a constant subexpression (frozen-Keras BN
        leaves ``gamma·rsqrt(var+eps)`` etc. as op chains over Consts).
        Memoized per node — shared subexpressions (dequantized weight
        triples, BN stat chains) evaluate once."""
        name = _tname(ref)
        memo = self._const_memo
        if name in memo:
            return memo[name]
        out = self._eval_const_uncached(name, _depth)
        memo[name] = out
        return out

    def _eval_const_uncached(self, name: str,
                             _depth: int) -> Optional[np.ndarray]:
        if name in self.consts:
            return np.asarray(self.consts[name])
        node = self.graph.by_name.get(name)
        if node is None or _depth > 32:
            return None
        ins = [i for i in node.inputs if not i.startswith("^")]
        if node.op in ("Identity", "Switch"):
            return self.eval_const(ins[0], _depth + 1)
        vals = [self.eval_const(i, _depth + 1) for i in ins]
        if any(v is None for v in vals):
            return None
        if node.op in ("Add", "AddV2", "BiasAdd"):
            return vals[0] + vals[1]
        if node.op == "Sub":
            return vals[0] - vals[1]
        if node.op == "Mul":
            return vals[0] * vals[1]
        if node.op == "RealDiv":
            return vals[0] / vals[1]
        if node.op == "Rsqrt":
            return 1.0 / np.sqrt(vals[0])
        if node.op == "Sqrt":
            return np.sqrt(vals[0])
        if node.op == "Neg":
            return -vals[0]
        if node.op == "Reshape":
            return vals[0].reshape([int(v) for v in np.asarray(vals[1]).ravel()])
        return None

    def consumers(self, name: str) -> List[NodeDef]:
        out, stack, seen = [], [name], set()
        while stack:
            n = stack.pop()
            for c in self.succ.get(n, []):
                if c.name in seen:
                    continue
                seen.add(c.name)
                if c.op in _PASS:
                    stack.append(c.name)
                else:
                    out.append(c)
        return out

    # --- conv-chain extraction ---

    def conv_consumers(self, name: str) -> List[Tuple[NodeDef, Tuple[int, int]]]:
        """Conv nodes fed (possibly through an explicit ``Pad``) by tensor
        ``name``; returns (conv_node, extra_symmetric_pad_hw)."""
        out = []
        for c in self.consumers(name):
            if c.op in ("Conv2D", "DepthwiseConv2dNative"):
                out.append((c, (0, 0)))
            elif c.op == "Pad":
                pads = self.eval_const(c.inputs[1])
                if pads is None:
                    raise GraphStructureError(f"non-const Pad at {c.name}")
                pads = np.asarray(pads).reshape(-1, 2)
                if pads[0].any() or pads[3].any() or (pads[1] != pads[1][0]).any() \
                        or (pads[2] != pads[2][0]).any():
                    raise GraphStructureError(
                        f"unsupported pad layout at {c.name}: {pads.tolist()}")
                for cc in self.consumers(c.name):
                    if cc.op in ("Conv2D", "DepthwiseConv2dNative"):
                        out.append((cc, (int(pads[1][0]), int(pads[2][0]))))
        return out

    def fold_affine(self, conv: NodeDef):
        """From a conv node, follow the single-consumer chain folding every
        affine op into per-channel (scale, bias); stop at an activation or
        structural op. Returns (scale, bias, act_kind, last_node) where
        ``last_node`` is the final node consumed (activation included)."""
        kernel = self.eval_const(conv.inputs[1])
        if kernel is None:
            raise GraphStructureError(f"non-const conv weights at {conv.name}")
        cout = kernel.shape[-2] * kernel.shape[-1] \
            if conv.op == "DepthwiseConv2dNative" else kernel.shape[-1]
        scale = np.ones((cout,), np.float32)
        bias = np.zeros((cout,), np.float32)
        act = None
        cur = conv
        clip_lo = clip_hi = None
        while True:
            cons = self.succ.get(cur.name, [])
            if len(cons) != 1:
                break
            c = cons[0]
            # once any activation/clip has been consumed, further affine ops
            # are POST-activation — folding them into (scale, bias) would
            # move them before the nonlinearity. Stop; the caller sees them
            # as the next structural op.
            past_act = act is not None or clip_lo is not None \
                or clip_hi is not None
            if c.op in _PASS:
                cur = c
                continue
            if c.op.startswith("FusedBatchNorm"):
                if past_act:
                    break
                gamma, beta, mean, var = (self.eval_const(c.inputs[k])
                                          for k in (1, 2, 3, 4))
                if any(v is None for v in (gamma, beta, mean, var)):
                    raise GraphStructureError(f"non-const BN stats at {c.name}")
                epsa = c.attrs.get("epsilon")
                eps = epsa.f if (epsa is not None and epsa.f is not None) else 1e-4
                inv = (np.asarray(gamma, np.float64)
                       / np.sqrt(np.asarray(var, np.float64) + eps))
                bias = (bias * inv + (beta - np.asarray(mean) * inv)).astype(np.float32)
                scale = (scale * inv).astype(np.float32)
            elif c.op in ("BiasAdd", "Add", "AddV2", "Sub", "Mul"):
                if past_act:
                    break
                data_pos = [k for k, i in enumerate(c.inputs)
                            if _tname(i) == cur.name]
                other = [i for i in c.inputs
                         if _tname(i) != cur.name and not i.startswith("^")]
                v = self.eval_const(other[0]) if len(other) == 1 else None
                if v is None:
                    break   # a residual Add etc. — structural, stop here
                v = np.asarray(v, np.float32).reshape(-1)
                if v.size == 1:
                    v = np.full((cout,), v[0], np.float32)
                if c.op == "Mul":
                    scale, bias = scale * v, bias * v
                elif c.op == "Sub":
                    if data_pos == [0]:          # x - c
                        bias = bias - v
                    else:                        # c - x: negate the data path
                        scale, bias = -scale, v - bias
                else:
                    bias = bias + v
            elif c.op in ("Minimum", "Maximum"):
                # ReLU6 in graph_transforms form: clip via Maximum(·,0) and
                # Minimum(·,6) in either order (SURVEY §2.2: "ReLU6 as
                # Relu+Minimum/Maximum")
                other = [i for i in c.inputs if _tname(i) != cur.name]
                v = self.eval_const(other[0]) if other else None
                if v is None or np.asarray(v).size != 1:
                    break
                val = float(np.asarray(v).ravel()[0])
                # only the ReLU6 clip bounds are activation forms; any other
                # clip value is not representable in the folded block — stop
                # (callers' expect_act validation then flags the mismatch)
                if (c.op == "Maximum" and val != 0.0) or \
                        (c.op == "Minimum" and val != 6.0):
                    break
                if c.op == "Maximum":
                    clip_lo = val
                else:
                    clip_hi = val
                if clip_lo == 0.0:
                    act = _RELU6 if clip_hi == 6.0 else "Relu"
                cur = c
                if clip_lo == 0.0 and clip_hi == 6.0:
                    break
                continue
            elif c.op in _ACTIVATIONS:
                act = c.op
                cur = c
                if c.op == "Relu":
                    clip_lo = 0.0
                    # a single following Minimum(6) upgrades Relu -> Relu6
                    nxt = self.succ.get(c.name, [])
                    if len(nxt) == 1 and nxt[0].op == "Minimum":
                        continue
                break
            else:
                break
            cur = c
        return scale, bias, act, cur


def _folded_block(walk: _Walk, conv: NodeDef,
                  expect_act: Optional[str] = None):
    """(block_dict, last_node): conv weights with the downstream affine chain
    folded in (scale into the kernel, bias kept)."""
    kernel = np.asarray(walk.eval_const(conv.inputs[1]), np.float32)
    scale, bias, act, last = walk.fold_affine(conv)
    if expect_act is not None and act != expect_act:
        raise GraphStructureError(
            f"{conv.name}: expected activation {expect_act}, found {act}")
    if conv.op == "DepthwiseConv2dNative":
        kh, kw, cin, mult = kernel.shape
        kernel = kernel * scale.reshape(1, 1, cin, mult)
    else:
        kernel = kernel * scale
    return {"kernel": kernel.astype(np.float32), "bias": bias}, last


def _conv_stride(conv: NodeDef) -> int:
    s = conv.attrs["strides"].list_i
    if s[1] != s[2]:
        raise GraphStructureError(f"{conv.name}: non-square stride {s}")
    return int(s[1])


def _find_embedding_output(graph, candidates: Sequence[str]) -> str:
    """First present candidate tensor name, else the terminal global-pool
    (Mean/AvgPool) node."""
    for c in candidates:
        if _tname(c) in graph.by_name:
            return c
    pools = [n for n in graph.nodes if n.op in ("Mean", "AvgPool")]
    if pools:
        return pools[-1].name
    raise GraphStructureError(
        f"no embedding output found (tried {list(candidates)}, no Mean/AvgPool)")


def mobilenet_params_from_pb(path: str,
                             output: Optional[str] = None) -> Dict:
    """``vgg2_mobilenet.pb``-style frozen MobileNet-V1 → mobilenet.py pytree
    (folded form). Reference tap: ``input_1:0 → reshape_1/Reshape:0``
    (``facerec_test.py:212``); structural walk, so renamed graphs import too."""
    from ..models.mobilenet import MOBILENET_V1_BLOCKS

    graph = load_graphdef(path)
    out = output or _find_embedding_output(
        graph, ["reshape_1/Reshape", "global_pooling/Mean"])
    walk = _Walk(path, [out])

    convs = [n for n in walk.nodes
             if n.op in ("Conv2D", "DepthwiseConv2dNative")]
    expect = 1 + 2 * len(MOBILENET_V1_BLOCKS)
    if len(convs) != expect:
        raise GraphStructureError(
            f"expected {expect} conv nodes for MobileNet-V1, found {len(convs)}")

    params: Dict = {}
    block, last = _folded_block(walk, convs[0], expect_act=_RELU6)
    k = block["kernel"]
    if convs[0].op != "Conv2D" or k.shape[:3] != (3, 3, 3):
        raise GraphStructureError(f"stem conv shape {k.shape} != (3,3,3,·)")
    if _conv_stride(convs[0]) != 2:
        raise GraphStructureError("stem conv stride != 2")
    params["conv1"] = block
    for i, (stride, cout) in enumerate(MOBILENET_V1_BLOCKS, start=1):
        dw, pw = convs[2 * i - 1], convs[2 * i]
        if dw.op != "DepthwiseConv2dNative" or pw.op != "Conv2D":
            raise GraphStructureError(
                f"block {i}: op order ({dw.op}, {pw.op}) not (dw, pw)")
        if _conv_stride(dw) != stride:
            raise GraphStructureError(
                f"block {i}: dw stride {_conv_stride(dw)} != {stride}")
        params[f"dw{i}"], _ = _folded_block(walk, dw, expect_act=_RELU6)
        params[f"pw{i}"], _ = _folded_block(walk, pw, expect_act=_RELU6)
        if params[f"pw{i}"]["kernel"].shape[-1] != cout:
            raise GraphStructureError(
                f"block {i}: pw out {params[f'pw{i}']['kernel'].shape[-1]} "
                f"!= {cout}")
    return params


def resnet50_params_from_pb(path: str,
                            output: Optional[str] = None) -> Dict:
    """``vgg2_resnet.pb``-style frozen keras_vggface ResNet-50 →
    resnet.py pytree (folded form). Reference tap: ``input:0 →
    pool5_7x7_s1:0`` (``facerec_test.py:213``). The walk disambiguates the
    bottleneck main path from the projection shortcut by output width."""
    from ..models.resnet import STAGES, STAGE_WIDTHS

    graph = load_graphdef(path)
    out = output or _find_embedding_output(graph, ["pool5_7x7_s1", "avg_pool"])
    walk = _Walk(path, [out])

    ph = walk.placeholder()
    stem_convs = walk.conv_consumers(ph.name)
    if len(stem_convs) != 1:
        raise GraphStructureError(
            f"expected 1 stem conv, found {[c.name for c, _ in stem_convs]}")
    stem, pad = stem_convs[0]
    k = walk.eval_const(stem.inputs[1])
    if k.shape != (7, 7, 3, 64) or _conv_stride(stem) != 2:
        raise GraphStructureError(
            f"stem conv {k.shape}/stride {_conv_stride(stem)} not 7x7/2")
    # keras_vggface stem = ZeroPadding2D((3,3)) + 7x7/2 VALID conv — the
    # native model reproduces exactly that (resnet.py stem padding (3,3));
    # a SAME-padded stem would shift the crop by one pixel
    stem_padding = stem.attrs["padding"].s.decode()
    if not ((stem_padding == "VALID" and pad == (3, 3))
            or (stem_padding == "SAME" and pad == (0, 0))):
        raise GraphStructureError(
            f"stem padding {stem_padding} + explicit pad {pad} is neither "
            "the keras ZeroPadding2D((3,3))+VALID form nor plain SAME")
    if stem_padding == "SAME":
        import warnings

        warnings.warn(
            "resnet50 pb stem uses SAME padding; the native model applies "
            "the keras (3,3) explicit pad — outputs may shift by one pixel",
            RuntimeWarning, stacklevel=2)
    params: Dict = {}
    params["stem"], last = _folded_block(walk, stem, expect_act="Relu")

    pools = [c for c in walk.consumers(last.name) if c.op == "MaxPool"]
    if len(pools) != 1:
        raise GraphStructureError("expected MaxPool after the stem")
    cur = pools[0]

    for si, n_blocks in enumerate(STAGES):
        w1, w2, w3 = STAGE_WIDTHS[si]
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            convs = walk.conv_consumers(cur.name)
            tag = f"stage{si + 1}_block{bi + 1}"
            p: Dict = {}
            if bi == 0:
                if len(convs) != 2:
                    raise GraphStructureError(
                        f"{tag}: expected main+proj convs, found "
                        f"{[c.name for c, _ in convs]}")
                by_width = {walk.eval_const(c.inputs[1]).shape[-1]: c
                            for c, _ in convs}
                if set(by_width) != {w1, w3}:
                    raise GraphStructureError(
                        f"{tag}: conv widths {sorted(by_width)} != "
                        f"{sorted((w1, w3))}")
                c1, proj = by_width[w1], by_width[w3]
                if _conv_stride(proj) != stride:
                    raise GraphStructureError(f"{tag}: proj stride mismatch")
                p["proj"], _ = _folded_block(walk, proj)
            else:
                if len(convs) != 1:
                    raise GraphStructureError(
                        f"{tag}: expected 1 main-path conv, found "
                        f"{[c.name for c, _ in convs]}")
                c1 = convs[0][0]
            if _conv_stride(c1) != stride:
                raise GraphStructureError(f"{tag}: conv1 stride mismatch")
            p["conv1"], last = _folded_block(walk, c1, expect_act="Relu")
            (c2, _), = walk.conv_consumers(last.name)
            p["conv2"], last = _folded_block(walk, c2, expect_act="Relu")
            (c3, _), = walk.conv_consumers(last.name)
            p["conv3"], last = _folded_block(walk, c3, expect_act=None)
            for key, cc, w in (("conv1", c1, w1), ("conv2", c2, w2),
                               ("conv3", c3, w3)):
                if p[key]["kernel"].shape[-1] != w:
                    raise GraphStructureError(
                        f"{tag}/{key}: width {p[key]['kernel'].shape[-1]} != {w}")
            adds = [c for c in walk.consumers(last.name)
                    if c.op in ("Add", "AddV2")]
            if len(adds) != 1:
                raise GraphStructureError(f"{tag}: no residual Add after conv3")
            relus = [c for c in walk.consumers(adds[0].name) if c.op == "Relu"]
            if len(relus) != 1:
                raise GraphStructureError(f"{tag}: no Relu after residual Add")
            cur = relus[0]
            params[tag] = p
    return params
