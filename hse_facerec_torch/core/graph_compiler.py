"""GraphDef → PyTorch program.

Counterpart of ``hse_facerec_tf_tpu/core/graph_compiler.py``: a frozen
GraphDef is compiled once into a plain function ``fn(params, feeds) ->
outputs`` over torch tensors in TF's NHWC layout, in place of the
reference's TF1 session (``facerec_test.py:41-48,114-122`` ``load_graph`` /
``sess.run``).

Constants live in a ``params`` dict (``CompiledGraph.torch_params`` puts
them on a device once) rather than in the function, so the same program
serves other weights. The pruning is numpy and the JAX package's own: the
reference's ``freeze_session`` (``facerec_keras_train.py:70-83``) does not
fold BatchNorm, so frozen-Keras graphs carry ``FusedBatchNorm`` behind
``Switch``/``Merge`` learning-phase control flow fed by a bool placeholder
(``conv1_bn/keras_learning_phase:0``, ``facerec_test.py:64,118-119,212``).
The learning phase is resolved when the graph is compiled (inference ⇒
False) and the dead branch is pruned, so the program has no control flow.

TF's numerics kept here: SAME padding puts the odd pixel at the end
(``models/layers.py``), MaxPool pads with -inf, SAME AvgPool divides by the
unpadded cells, and a division by a constant is a multiply by its float32
reciprocal (``numerics.div_const``), as inside the jitted reference.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.layers import conv2d
from ..numerics import div_const, fp32_precision, precision_scope
from .graphdef import DT_BOOL, NodeDef, TFGraph, extract_constants


def _tname(t: str) -> str:
    """Strip the output index from a TF tensor name ('x:0' -> 'x')."""
    return t.split(":")[0]


def _out_index(t: str) -> int:
    return int(t.split(":")[1]) if ":" in t else 0


def _as_tensor(value, device) -> torch.Tensor:
    """A constant as a tensor on ``device``, in the dtype the reference
    gives it: JAX runs without 64-bit types, so float64 and int64 constants
    become float32 and int32."""
    a = np.asarray(value)
    a = a.astype({np.dtype(np.float64): np.float32,
                  np.dtype(np.int64): np.int32}.get(a.dtype, a.dtype))
    return torch.from_numpy(np.array(a)).to(device)


def _reduce_axes(idx_const: np.ndarray, rank: int) -> Tuple[int, ...]:
    axes = np.atleast_1d(np.asarray(idx_const)).astype(int)
    return tuple(int(a) % rank for a in axes)


class CompiledGraph:
    """A frozen TF graph compiled to a plain PyTorch function.

    Attributes:
      params: dict name -> np.ndarray of the (dequantize-folded) constants
        the program reads; ``torch_params(device)`` moves them to a device.
      fn: ``fn(params, feeds: dict) -> tuple`` evaluating ``outputs`` on
        NHWC tensors; ``params`` as ``torch_params`` returns them. Its
        convolutions and matmuls run at ``precision``'s tier
        (``numerics``; "highest" by default, as in the reference).
    """

    # Input positions that must be constants (shapes, axes, pads).
    _STATIC_ARGS = {
        "Reshape": (1,),
        "Mean": (1,),
        "Sum": (1,),
        "Max": (1,),
        "Min": (1,),
        "Pad": (1,),
        "ExpandDims": (1,),
        "StridedSlice": (1, 2, 3),
    }

    def __init__(self, graph: TFGraph, outputs: Sequence[str],
                 consts: Dict[str, np.ndarray], precision="highest",
                 learning_phase: bool = False,
                 const_feeds: Optional[Dict[str, object]] = None):
        fp32_precision(precision)                 # refuse an unknown tier now
        self.graph = graph
        self.precision = precision
        self.output_names = [_tname(o) for o in outputs]
        self._consts = consts
        self.learning_phase = bool(learning_phase)
        # Placeholders pinned to constants: the reference's
        # additional_input_value convention (facerec_test.py:51,118-119 feeds
        # e.g. dropout_rate:0 = 0.9, phase_train:0 = False per session run).
        # A bool feed also drives Switch/Merge pruning through _static_bool.
        self.const_feeds = {_tname(k): np.asarray(v)
                            for k, v in (const_feeds or {}).items()}
        self._switch_live: Dict[str, int] = {}   # Switch node -> live output idx
        self._merge_choice: Dict[str, Tuple[str, int]] = {}  # Merge -> (input ref, idx)
        self._needed = self._prune(self.output_names)
        # Split constants into params vs static (shape-like) values. A const
        # consumed only at static positions stays out of params.
        static_only = set()
        dynamic_used = set()
        for node in self._needed:
            static_pos = self._STATIC_ARGS.get(node.op, ())
            if node.op == "ConcatV2":
                static_pos = (len(node.inputs) - 1,)
            for i, inp in enumerate(node.inputs):
                if inp.startswith("^"):
                    continue
                name = _tname(inp)
                if i in static_pos:
                    static_only.add(name)
                else:
                    dynamic_used.add(name)
        self.params = {
            n.name: consts[n.name]
            for n in self._needed
            if n.op in ("Const", "Dequantize") and n.name in consts
            and (n.name in dynamic_used or n.name not in static_only)
        }
        self.fn = self._build()

    def torch_params(self, device) -> Dict[str, torch.Tensor]:
        """``params`` as tensors on ``device``, moved once."""
        return {k: _as_tensor(v, device) for k, v in self.params.items()}

    def static_const(self, tensor_name: str) -> np.ndarray:
        return self._consts[_tname(tensor_name)]

    def _static_bool(self, ref: str, _depth: int = 0) -> Optional[bool]:
        """Resolve a tensor ref to a constant boolean, following Identity
        chains. Bool placeholders (Keras learning phase) resolve to
        ``self.learning_phase``; unresolvable refs return None."""
        if _depth > 64:
            return None
        name = _tname(ref)
        node = self.graph.by_name.get(name)
        if node is None:
            return None
        if node.op == "Identity":
            return self._static_bool(node.inputs[0], _depth + 1)
        if node.op == "Const":
            v = self._consts.get(name)
            if v is not None and v.dtype == np.bool_ and v.size == 1:
                return bool(np.asarray(v).reshape(-1)[0])
            return None
        if node.op in ("Placeholder", "PlaceholderWithDefault"):
            if name in self.const_feeds:
                v = self.const_feeds[name]
                if v.dtype == np.bool_ and v.size == 1:
                    return bool(v.reshape(-1)[0])
                return None
            dt = node.attrs.get("dtype")
            if dt is not None and dt.type == DT_BOOL:
                return self.learning_phase
        return None

    def _alive(self, ref: str, memo: Dict[Tuple[str, int], bool]) -> bool:
        """Whether a tensor ref carries a value once learning-phase branches
        are resolved. Dead = the untaken output of a statically-decided Switch,
        or anything (transitively) fed only by dead tensors."""
        name, idx = _tname(ref), _out_index(ref)
        key = (name, idx)
        if key in memo:
            return memo[key]
        node = self.graph.by_name.get(name)
        if node is None:
            memo[key] = False
            return False
        memo[key] = False  # provisional: cycles count as dead
        if node.op == "Switch":
            pred = self._static_bool(node.inputs[1])
            if pred is None:
                alive = all(self._alive(i, memo) for i in node.inputs
                            if not i.startswith("^"))
            else:
                alive = idx == int(pred) and self._alive(node.inputs[0], memo)
        elif node.op == "Merge":
            alive = any(self._alive(i, memo) for i in node.inputs
                        if not i.startswith("^"))
        elif node.op in ("Const", "Placeholder", "PlaceholderWithDefault"):
            alive = True
        else:
            alive = all(self._alive(i, memo) for i in node.inputs
                        if not i.startswith("^"))
        memo[key] = alive
        return alive

    def _data_inputs(self, node: NodeDef,
                     memo: Dict[Tuple[str, int], bool]) -> List[str]:
        """Input refs that must actually be evaluated for this node, with
        statically-decided Switch preds and dead Merge branches dropped."""
        if node.op == "Dequantize" and node.name in self._consts:
            return []  # folded to a constant; don't pull in quint8 inputs
        if node.op == "Switch":
            pred = self._static_bool(node.inputs[1])
            if pred is not None:
                self._switch_live[node.name] = int(pred)
                return [node.inputs[0]]
        elif node.op == "Merge":
            for i, inp in enumerate(node.inputs):
                if inp.startswith("^"):
                    continue
                if self._alive(inp, memo):
                    self._merge_choice[node.name] = (inp, i)
                    return [inp]
            raise ValueError(f"Merge node {node.name}: all branches dead")
        return [i for i in node.inputs if not i.startswith("^")]

    def _prune(self, outputs: List[str]) -> List[NodeDef]:
        """Topological list of nodes needed for the outputs (graph is already topo-sorted
        in frozen pbs, but we re-sort defensively), with statically-dead
        learning-phase branches excluded."""
        by_name = self.graph.by_name
        alive_memo: Dict[Tuple[str, int], bool] = {}
        needed: Dict[str, NodeDef] = {}
        stack = [o for o in outputs]
        while stack:
            name = _tname(stack.pop())
            if name in needed or name not in by_name:
                continue
            node = by_name[name]
            needed[name] = node
            stack.extend(self._data_inputs(node, alive_memo))
        # topo sort
        order: List[NodeDef] = []
        seen: Dict[str, int] = {}

        def visit(name: str):
            if seen.get(name) == 2 or name not in needed:
                return
            if seen.get(name) == 1:
                raise ValueError(f"cycle at {name}")
            seen[name] = 1
            node = needed[name]
            for inp in self._data_inputs(node, alive_memo):
                visit(_tname(inp))
            seen[name] = 2
            order.append(node)

        for o in outputs:
            visit(o)
        return order

    def _build(self) -> Callable:
        nodes = self._needed
        output_names = self.output_names
        const_feeds = self.const_feeds
        precision = self.precision

        def fn(params: Dict[str, torch.Tensor], feeds: Dict[str, torch.Tensor]):
            with precision_scope(precision):
                return run(params, feeds)

        def run(params, feeds):
            if const_feeds:
                device = next(iter(feeds.values())).device if feeds else "cpu"
                feeds = {**{k: _as_tensor(v, device)
                            for k, v in const_feeds.items()}, **feeds}
            env: Dict[str, object] = {}

            def get(t: str):
                v = env[_tname(t)]
                if isinstance(v, tuple):
                    return v[_out_index(t)]
                return v

            for node in nodes:
                if node.op == "Switch" and node.name in self._switch_live:
                    live = self._switch_live[node.name]
                    pair: List[object] = [None, None]
                    pair[live] = get(node.inputs[0])
                    env[node.name] = tuple(pair)
                elif node.op == "Merge" and node.name in self._merge_choice:
                    ref, idx = self._merge_choice[node.name]
                    env[node.name] = (get(ref), torch.tensor(idx, dtype=torch.int32))
                else:
                    env[node.name] = _eval_node(node, get, params, feeds,
                                                self.static_const,
                                                self.learning_phase)
            return tuple(env[o] for o in output_names)

        return fn


def _tf_same_pool_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    pad = max((out - 1) * s + k - size, 0)
    return pad // 2, pad - pad // 2


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _strided_slice(x, node: NodeDef, static):
    begin = np.asarray(static(node.inputs[1])).astype(int)
    end = np.asarray(static(node.inputs[2])).astype(int)
    strides = np.asarray(static(node.inputs[3])).astype(int)

    def mask(name):
        a = node.attrs.get(name)
        return a.i if (a is not None and a.i) else 0

    if mask("ellipsis_mask") or mask("new_axis_mask"):
        raise NotImplementedError(
            f"StridedSlice ellipsis/new_axis masks (node {node.name})")
    begin_mask = mask("begin_mask")
    end_mask = mask("end_mask")
    shrink_mask = mask("shrink_axis_mask")
    out = x
    for i, (b, e, s) in enumerate(zip(begin, end, strides)):
        # TF: a set mask bit means "use the full range" on that axis
        b_ = None if (begin_mask >> i) & 1 else int(b)
        e_ = None if (end_mask >> i) & 1 else int(e)
        if (shrink_mask >> i) & 1:        # one element, at ``begin``
            b_ = int(b) % out.shape[i]
            e_, s = b_ + 1, 1
        sl = slice(b_, e_, int(s))
        if s > 0:
            out = out[(slice(None),) * i + (sl,)]
        else:       # torch slices step forward only: gather the elements
            idx = list(range(*sl.indices(out.shape[i])))
            out = out.index_select(i, torch.tensor(idx, dtype=torch.int64,
                                                   device=out.device))
    if shrink_mask:
        axes = tuple(i for i in range(len(begin)) if (shrink_mask >> i) & 1)
        out = out.squeeze(axes)
    return out


def _eval_node(node: NodeDef, get, params, feeds, static, learning_phase=False):
    op = node.op
    if op == "Placeholder":
        if node.name in feeds:
            return feeds[node.name]
        dt = node.attrs.get("dtype")
        if dt is not None and dt.type == DT_BOOL:
            # Keras learning-phase tensor: inference unless asked otherwise
            # (reference feeds False at facerec_test.py:118-119).
            return np.bool_(learning_phase)
        raise KeyError(f"missing feed for placeholder {node.name}")
    if op == "PlaceholderWithDefault":
        if node.name in feeds:
            return feeds[node.name]
        dt = node.attrs.get("dtype")
        if dt is not None and dt.type == DT_BOOL:
            return np.bool_(learning_phase)
        return get(node.inputs[0])
    if op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
        # Inference form only; statically-pruned learning-phase branches mean
        # a live FusedBatchNorm in training mode is a real error.
        tr = node.attrs.get("is_training")
        if tr is not None and tr.b:
            raise NotImplementedError(
                f"FusedBatchNorm is_training=True reached the live graph "
                f"(node {node.name}); learning-phase pruning should have "
                "removed it")
        x = get(node.inputs[0])
        scale = get(node.inputs[1])
        offset = get(node.inputs[2])
        mean = get(node.inputs[3])
        var = get(node.inputs[4])
        epsa = node.attrs.get("epsilon")
        eps = epsa.f if (epsa is not None and epsa.f is not None) else 1e-4
        fmt = node.attrs.get("data_format")
        if fmt is not None and fmt.s and fmt.s.decode() != "NHWC":
            raise NotImplementedError(
                f"FusedBatchNorm data_format {fmt.s!r} (node {node.name})")
        y = (x - mean) * (scale * torch.rsqrt(var + eps)) + offset
        return (y, mean, var)
    if op == "Const" or op == "Dequantize":
        # Dequantize over const weights is pre-folded into params (graphdef.py).
        if node.name in params:
            return params[node.name]
        return static(node.name)  # shape-like const kept static
    if op == "Identity":
        return get(node.inputs[0])
    if op == "Relu":
        return torch.relu(get(node.inputs[0]))
    if op == "Relu6":
        return torch.clamp(get(node.inputs[0]), 0.0, 6.0)
    if op == "Sigmoid":
        return torch.sigmoid(get(node.inputs[0]))
    if op == "Softmax":
        return torch.softmax(get(node.inputs[0]), dim=-1)
    if op == "Neg":
        return -get(node.inputs[0])
    if op == "Exp":
        return torch.exp(get(node.inputs[0]))
    if op == "Abs":
        return torch.abs(get(node.inputs[0]))
    if op == "Sqrt":
        return torch.sqrt(get(node.inputs[0]))
    if op == "Rsqrt":
        return torch.rsqrt(get(node.inputs[0]))
    if op == "Square":
        return torch.square(get(node.inputs[0]))
    if op in ("Add", "AddV2", "BiasAdd"):
        return get(node.inputs[0]) + get(node.inputs[1])
    if op == "Sub":
        return get(node.inputs[0]) - get(node.inputs[1])
    if op == "Mul":
        return get(node.inputs[0]) * get(node.inputs[1])
    if op == "RealDiv":
        return get(node.inputs[0]) / get(node.inputs[1])
    if op == "Minimum":
        return torch.minimum(get(node.inputs[0]), get(node.inputs[1]))
    if op == "Maximum":
        return torch.maximum(get(node.inputs[0]), get(node.inputs[1]))
    if op == "MatMul":
        a = get(node.inputs[0])
        b = get(node.inputs[1])
        if node.attrs.get("transpose_a") and node.attrs["transpose_a"].b:
            a = a.T
        if node.attrs.get("transpose_b") and node.attrs["transpose_b"].b:
            b = b.T
        return a @ b
    if op == "Conv2D":
        x = get(node.inputs[0])
        w = get(node.inputs[1])                       # HWIO
        strides = node.attrs["strides"].list_i
        if strides[1] != strides[2]:
            raise NotImplementedError(f"Conv2D strides {strides} (node {node.name})")
        padding = node.attrs["padding"].s.decode()
        return _nhwc(conv2d(_nchw(x), w.permute(3, 2, 0, 1), stride=strides[1],
                            padding=padding))
    if op == "DepthwiseConv2dNative":
        x = get(node.inputs[0])
        w = get(node.inputs[1])  # (H, W, C_in, mult): output channel c·mult + m
        strides = node.attrs["strides"].list_i
        if strides[1] != strides[2]:
            raise NotImplementedError(
                f"DepthwiseConv2dNative strides {strides} (node {node.name})")
        padding = node.attrs["padding"].s.decode()
        h, wd, cin, mult = w.shape
        w = w.reshape(h, wd, 1, cin * mult).permute(3, 2, 0, 1)
        return _nhwc(conv2d(_nchw(x), w, stride=strides[1], padding=padding,
                            groups=cin))
    if op == "MaxPool":
        x = _nchw(get(node.inputs[0]))
        k = node.attrs["ksize"].list_i
        s = node.attrs["strides"].list_i
        padding = node.attrs["padding"].s.decode()
        if padding == "SAME":
            # TF MaxPool SAME pads with -inf (not zeros): explicit pads
            ph = _tf_same_pool_pads(x.shape[2], k[1], s[1])
            pw = _tf_same_pool_pads(x.shape[3], k[2], s[2])
            x = F.pad(x, (*pw, *ph), value=float("-inf"))
        return _nhwc(F.max_pool2d(x, (k[1], k[2]), (s[1], s[2])))
    if op == "AvgPool":
        x = _nchw(get(node.inputs[0]))
        k = node.attrs["ksize"].list_i
        s = node.attrs["strides"].list_i
        padding = node.attrs["padding"].s.decode()
        if padding == "SAME":
            # TF divides by the number of UNPADDED cells in each window
            ph = _tf_same_pool_pads(x.shape[2], k[1], s[1])
            pw = _tf_same_pool_pads(x.shape[3], k[2], s[2])

            def window_sums(t):
                return F.avg_pool2d(F.pad(t, (*pw, *ph)), (k[1], k[2]),
                                    (s[1], s[2]), divisor_override=1)

            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            return _nhwc(window_sums(x) / window_sums(ones))
        summed = F.avg_pool2d(x, (k[1], k[2]), (s[1], s[2]), divisor_override=1)
        return _nhwc(div_const(summed, k[1] * k[2]))
    if op in ("Mean", "Sum", "Max"):
        x = get(node.inputs[0])
        axes = _reduce_axes(static(node.inputs[1]), x.dim())
        keep = bool(node.attrs.get("keep_dims") and node.attrs["keep_dims"].b)
        if op == "Max":
            return torch.amax(x, dim=axes, keepdim=keep)
        summed = torch.sum(x, dim=axes, keepdim=keep)
        if op == "Sum":
            return summed
        return div_const(summed, int(np.prod([x.shape[a] for a in axes])))
    if op == "Reshape":
        x = get(node.inputs[0])
        shape = [int(v) for v in np.asarray(static(node.inputs[1])).reshape(-1)]
        return torch.reshape(x, shape)
    if op == "Squeeze":
        x = get(node.inputs[0])
        dims = node.attrs.get("squeeze_dims")
        axes = tuple(dims.list_i) if dims is not None and dims.list_i else None
        return torch.squeeze(x) if axes is None else torch.squeeze(x, axes)
    if op == "ConcatV2":
        xs = [get(i) for i in node.inputs[:-1]]
        axis = int(np.asarray(static(node.inputs[-1])).reshape(-1)[0])
        return torch.cat(xs, dim=axis)
    if op == "Pad":
        x = get(node.inputs[0])
        pads = np.asarray(static(node.inputs[1])).astype(int)
        # F.pad takes (before, after) pairs from the last axis back
        return F.pad(x, [int(v) for a, b in pads[::-1] for v in (a, b)])
    if op == "Shape":
        return torch.tensor(get(node.inputs[0]).shape, dtype=torch.int32)
    if op == "Pack":
        axis = node.attrs["axis"].i if "axis" in node.attrs and node.attrs["axis"].i else 0
        return torch.stack([torch.as_tensor(get(i)) for i in node.inputs], dim=axis)
    if op == "StridedSlice":
        return _strided_slice(get(node.inputs[0]), node, static)
    raise NotImplementedError(f"TF op not supported by graph_compiler: {op} (node {node.name})")


def compile_graph(graph: TFGraph, outputs: Sequence[str], precision="highest",
                  learning_phase: bool = False,
                  const_feeds: Optional[Dict[str, object]] = None) -> CompiledGraph:
    consts = extract_constants(graph)
    return CompiledGraph(graph, outputs, consts, precision=precision,
                         learning_phase=learning_phase, const_feeds=const_feeds)


def compile_pb(path: str, outputs: Sequence[str], precision="highest",
               learning_phase: bool = False,
               const_feeds: Optional[Dict[str, object]] = None) -> CompiledGraph:
    from .graphdef import load_graphdef

    return compile_graph(load_graphdef(path), outputs, precision=precision,
                         learning_phase=learning_phase, const_feeds=const_feeds)
