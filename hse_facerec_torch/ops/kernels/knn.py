"""Matrix-free 1-NN: wrappers of the CUDA kernels K2a/K2b/K2c
(``csrc/knn.cu``), their plain twins and the routing rule.

Counterpart of ``hse_facerec_tf_tpu/ops/pallas/knn.py``. The identification
hot path is "for each probe, the nearest gallery embedding". The plain path
writes the (M, N) distance matrix and argmins it; the kernels keep a
running (value, index) per probe instead, so memory traffic is O(M·D + N·D).

- ``nearest_neighbor_f32`` (K2a): squared L2, f32 or bf16 operands (bf16 by
  default, as the reference), f32 norms and f32 accumulation. On CUDA the
  bf16 form runs the tensor-core mainloop shared with K2b/K2c on the bf16
  rows as they are (``wgmma`` fed by TMA above 16 probes, ``mma.sync`` at
  16 or fewer; no k-major probe copy); the exact f32 form keeps its FFMA
  sweep.
- ``nearest_neighbor_int8q`` (K2b): probes quantized here, against a
  gallery quantized once by ``quantize_embeddings``; an exact int8 dot, the
  scales folded into the norm terms. ``pack_idx=True`` selects the
  reference's packed epilogue: the value ranked and reported is the
  distance key with its low 10 mantissa bits cleared.
- ``nearest_neighbor_int8p`` (K2c): the same sweep against
  ``pack_quantized_gallery``, whose row norms were computed once.

The int8 sweep runs on ``wgmma`` fed by TMA at every shape: TMA copies
rows of whole 16-byte words from 16-byte aligned bases, so the gallery's
rows are zero-padded to whole words (``_pad_dim``, once at enrollment for
K2c) and an operand whose base is off 16 bytes is copied (``_aligned``);
zero columns change no dot. K2b's two-pass sweep sums the gallery rows'
squares itself, in the sweep.

Each wrapper routes by the device its tensors lie on: CPU tensors take the
plain twin, CUDA tensors launch the kernel or raise. ``<wrapper>.launches``
counts kernel launches, under a lock (``build.count_launch``): the
server's threads rank at once. ``sweep_config`` picks the gallery splits here,
where the CPU tests reach it; the int8 block tile, which follows from the
kernel's shared memory, comes from ``knn.cu`` (``int8_tile``): the probe
tile resident in shared memory where it fits, else streamed through the
gallery's ring beside it (past 1408 bytes a row, e.g. the 4096-d
``vggface_vgg16`` embeddings). The
host-side arithmetic around the int8 kernels
(scales, norms, the packed offset) is computed as the jitted reference
computes it, so K2b/K2c equal their twins, and the twins the reference, bit
for bit in index and distance.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ...numerics import div_const, fma, precision_scope
from ..distance import pairwise_sqeuclidean
from . import build

PACK_MASK = -1024           # the packed epilogue clears 10 mantissa bits
HBM_LIMIT_BYTES = 4 * 1024 ** 3
PLAIN_CHUNK = 1024          # probes per (chunk, N) matrix of the int8 twin

# csrc/knn.cu's geometry (the int8 block tile comes from knn_int8_tile)
TILE_N = 128                # gallery rows per tile, every sweep
F32_TM = 128                # probes a block of the f32 sweep, 2 blocks an SM
SERVE_TM, BATCH_TM = 16, 128    # probes a block of the tensor-core sweeps
BF16_PER_SM = 2             # the bf16 sweep's streamed tile, 2 blocks an SM
MAX_SPLITS = 65535          # the grid's y extent
CUDA_ERROR_INVALID_VALUE = 1
ROW_WORD = 16               # TMA copies int8 rows of whole 16-byte words


# -- quantization --------------------------------------------------------


def quantize_embeddings(x, reciprocal: bool = False):
    """Symmetric global int8 quantization: ``q = round(x / s)``,
    ``s = max|x| / 127`` (one scale, so the dequantized dot factors as
    ``sa·sb·(qa·qb)``). Returns ``(q int8, scale f32 0-dim tensor)``.

    ``reciprocal`` picks how ``max|x| / 127`` is rounded. The reference
    quantizes probes inside ``jax.jit``, where XLA multiplies by the f32
    reciprocal of 127 (``reciprocal=True``, as the kernel wrappers do); it
    quantizes galleries eagerly or in numpy, which divide exactly (False).
    The division stays a tensor by a tensor: PyTorch on CUDA turns a
    division by a Python scalar into a reciprocal multiply."""
    x = x.to(torch.float32)
    m = torch.max(torch.abs(x))
    scale = (div_const(m, 127.0) if reciprocal
             else m / torch.tensor(127.0, device=x.device))
    scale = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _sumsq(q):
    """Row sums of squares of an int8 matrix, exact, as f32. The squares
    (at most 127² = 16129) fit int16, which halves the bytes of this pass
    over the gallery against int32."""
    q16 = q.to(torch.int16)
    return torch.sum(q16 * q16, dim=1, dtype=torch.int32).to(torch.float32)


def _pad_dim(q):
    """Zero-pad the last axis to whole 16-byte words (``ROW_WORD``), the
    rows TMA copies; zero columns change no dot or norm."""
    pad = (-q.shape[1]) % ROW_WORD
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
    return q.contiguous()


def _pad_to(qa, width: int):
    """Zero-pad the last axis to ``width`` (quantized probes to the
    gallery's padded width, K2a's operands to whole 16-byte words); zero
    columns change no dot."""
    if qa.shape[1] > width:
        raise ValueError(f"probe dim {qa.shape[1]} > gallery dim {width}")
    if qa.shape[1] == width:
        return qa
    return torch.nn.functional.pad(qa, (0, width - qa.shape[1]))


class PackedGallery(NamedTuple):
    q: torch.Tensor          # (N, Dp) int8, Dp a multiple of ROW_WORD
    b2i: torch.Tensor        # (N,) f32: sum of q² per row
    scale: torch.Tensor      # f32 0-dim


def pack_quantized_gallery(q_gallery, g_scale) -> PackedGallery:
    """One-time enrollment packing for repeated int8 queries: pad the rows
    to whole words and precompute the raw norms, so a query does no
    gallery-side pass but the kernel's (reference ``knn.py:418``)."""
    q = _pad_dim(q_gallery)
    return PackedGallery(q, _sumsq(q),
                         torch.as_tensor(g_scale, dtype=torch.float32,
                                         device=q.device))


def _packed_b2(a2raw, b2raw, c, valid):
    """Offset-shifted b2 operand for the packed epilogue (reference
    ``_packed_b2``, ``knn.py:391``): keys ``b2 + offset - qa·qb`` are >= 0
    (Cauchy-Schwarz over the raw norms), invalid rows get a large finite
    sentinel. ``b2 = b2raw · c``. Inside ``jax.jit`` XLA fuses
    ``x * 1.01 + 1``, ``3 * offset + max`` and ``b2raw * c + offset`` into
    FMAs; so does this, since the offset moves the masked bits of every
    key. Returns ``(offset, b2p)``."""
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=b2raw.device)
    zero = f32(0.0)
    bound = (torch.sqrt(torch.max(a2raw))
             * torch.sqrt(torch.max(torch.where(valid, b2raw, zero))))
    offset = fma(bound, f32(1.01), f32(1.0))
    sentinel = fma(f32(3.0), offset,
                   torch.max(torch.where(valid, b2raw * c, zero))) + 1.0
    b2p = fma(b2raw, c.expand_as(b2raw), offset.expand_as(b2raw))
    return offset, torch.where(valid, b2p, sentinel)


class _Int8Operands(NamedTuple):
    qa: torch.Tensor       # (M, D) int8 probes
    a2raw: torch.Tensor    # (M,) sum of qa² per probe
    a2c: torch.Tensor      # sa / (2·sb): a2 = a2raw · a2c
    s: torch.Tensor        # 2·sa·sb
    offset: torch.Tensor   # packed offset, 0 for the two-pass epilogue
    b2v: Optional[torch.Tensor]  # (N,) the per-row term the kernel ranks against
    c: torch.Tensor        # sb / (2·sa): b2 = b2raw · c


def _valid_rows(n: int, valid_n) -> int:
    return n if valid_n is None else max(0, min(int(valid_n), n))


def _int8_operands(probes, b2raw, g_scale, valid_n, pack_idx: bool):
    """Host side of K2b/K2c (reference ``knn.py:358-382``): quantize the
    probes, fold the scales into the norms (``d = s·(a2 + b2 − qa·qb)``
    with ``s = 2·sa·sb``), and build the ranked per-row term: b2 with +inf
    on invalid rows (two-pass), or the offset-shifted b2p (packed).
    ``b2raw=None`` (two-pass only) leaves b2v to the kernel, which forms it
    from ``c`` and the rows' squares in the sweep."""
    dev = probes.device
    qa, sa = quantize_embeddings(probes, reciprocal=True)
    sb = torch.as_tensor(g_scale, dtype=torch.float32, device=dev)
    c = sb / (2.0 * sa)
    a2raw = _sumsq(qa)
    offset = torch.zeros((), dtype=torch.float32, device=dev)
    b2v = None
    if b2raw is not None:
        n = b2raw.shape[0]
        if not pack_idx and valid_n is None:    # every row valid: the same values
            b2v = b2raw * c
        else:
            valid = torch.arange(n, device=dev) < _valid_rows(n, valid_n)
            if pack_idx:
                offset, b2v = _packed_b2(a2raw, b2raw, c, valid)
            else:
                b2v = torch.where(valid, b2raw * c,
                                  torch.tensor(float("inf"), device=dev))
        b2v = b2v.contiguous()
    return _Int8Operands(qa, a2raw, sa / (2.0 * sb), 2.0 * sa * sb, offset, b2v, c)


def _int8_distances(ops: _Int8Operands, emin, pack_idx: bool):
    """Squared L2 between the dequantized vectors from the ranked minimum,
    ``(emin − offset + a2) · s`` (reference ``knn.py:379,387``), with
    ``a2 = a2raw · a2c`` fused into the add as XLA fuses it."""
    e = emin - ops.offset if pack_idx else emin
    d = fma(ops.a2raw, ops.a2c.expand_as(e), e)
    return torch.clamp(d * ops.s, min=0.0)


def _rank_int8_plain(qa, qb, b2v, pack_idx: bool):
    """Plain twin of the int8 sweep: lexicographic minimum of (key, index)
    per probe, key = ``b2v − qa·qb`` (masked when packed). The dot runs in
    float64, exact for any D, so it rounds once to f32 as the kernel's
    int32 dot does."""
    qa = _pad_to(qa, qb.shape[1])
    qbf = qb.to(torch.float64)
    emins, idxs = [], []
    for i in range(0, qa.shape[0], PLAIN_CHUNK):
        dot = (qa[i:i + PLAIN_CHUNK].to(torch.float64) @ qbf.T).to(torch.float32)
        e = b2v[None, :] - dot
        if pack_idx:
            e = (e.view(torch.int32) & PACK_MASK).view(torch.float32)
        idx = torch.argmin(e, dim=1)
        emins.append(torch.gather(e, 1, idx[:, None])[:, 0])
        idxs.append(idx)
    return torch.cat(emins), torch.cat(idxs)


# -- kernel launch ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = build.load_library()
    tail = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    int8 = lib.knn_int8
    int8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_uint, ctypes.c_int, *tail]
    int8.restype = ctypes.c_int
    lib.knn_int8_tile.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
    lib.knn_int8_tile.restype = ctypes.c_int
    f32 = lib.knn_f32
    f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, *tail]
    f32.restype = ctypes.c_int
    bf16 = lib.knn_bf16
    bf16.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, *tail]
    bf16.restype = ctypes.c_int
    return lib, int8, f32, bf16


class SweepConfig(NamedTuple):
    tm: int                  # probes a block
    splits: int              # gallery splits, one block each per probe tile
    tiles_per_split: int     # 128-row gallery tiles a split


@functools.lru_cache(maxsize=1024)
def sweep_config(m: int, n: int, sms: int, tm: int, per_sm: int) -> SweepConfig:
    """Gallery splits of a 1-NN sweep of m probes, ``tm`` a block, against
    n gallery rows on a card of ``sms`` SMs that holds ``per_sm`` such
    blocks each: the fewest waves of resident blocks times the tiles a
    block sweeps, over split counts that fill 1-16 waves, with at least two
    blocks an SM launched where the work allows (then the fewest blocks);
    no split is empty."""
    m_tiles, n_tiles = -(-m // tm), -(-n // TILE_N)
    slots = sms * per_sm
    floor = min(2 * sms, m_tiles * n_tiles)
    best = None
    for waves in range(1, 17):
        s = min(n_tiles, MAX_SPLITS, -(-max(waves * slots, floor) // m_tiles))
        per = -(-n_tiles // s)
        s = -(-n_tiles // per)
        blocks = m_tiles * s
        key = (blocks < floor, -(-blocks // slots) * per, blocks)
        if best is None or key < best[0]:
            best = (key, s, per)
    return SweepConfig(tm, best[1], best[2])


class Int8Tile(NamedTuple):
    tm: int                  # probes a block
    per_sm: int              # blocks an SM
    streamed: bool           # the probe tile streams beside the gallery


@functools.lru_cache(maxsize=1024)
def int8_tile(m: int, dp: int, device_index: int, stream: int = -1) -> Int8Tile:
    """(probes a block, blocks an SM, streamed) of the int8 sweep for m
    probes of ``dp`` bytes on a CUDA device, from ``knn.cu``'s
    ``knn_int8_tile``: 128 probes (two ``wgmma`` warpgroups) at every m,
    the probe tile resident where it fits a block's shared memory, else
    streamed, which fits at every width. The serving query takes the
    128-probe tile too: an H100 swept 16 probes x 1M rows faster on it than
    on the earlier ``mma.sync`` design's 16-probe one (0.216 against
    0.274-0.278 ms of device time at D 512, 1.77-1.78 against 2.16-2.20 ms
    a call at D 4096), the gallery's bytes bounding both. ``stream`` 0 or 1 asks for the resident or the streamed tile
    (-1: the rule). Raises where ``dp`` is not whole 16-byte words or the
    resident tile asked for does not fit."""
    lib = _kernels()[0]
    tm, per_sm, streamed = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        code = lib.knn_int8_tile(m, dp, stream, ctypes.byref(tm), ctypes.byref(per_sm),
                                 ctypes.byref(streamed))
    if code == CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"int8 1-NN: no tile for {dp}-byte rows (stream={stream})")
    build.check(lib, code, "knn_int8_tile")
    return Int8Tile(tm.value, per_sm.value, bool(streamed.value))


def bf16_tile(m: int) -> int:
    """Probes a block of the bf16 sweep: 16 at m <= 16 (one m16 MMA tile,
    ``mma.sync``), else 128 (two ``wgmma`` warpgroups); its probe tile
    streams, so the width does not matter."""
    return SERVE_TM if m <= SERVE_TM else BATCH_TM


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_cuda(what: str, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: tensors on {[str(x.device) for x in tensors]}; "
                             "all must be on one CUDA device or all on the CPU")
    return dev


def _launch(what: str, fn, lib, m: int, cfg: SweepConfig, dev, args):
    part_v = torch.empty((m, cfg.splits), dtype=torch.float32, device=dev)
    part_i = torch.empty((m, cfg.splits), dtype=torch.int32, device=dev)
    out_v = torch.empty((m,), dtype=torch.float32, device=dev)
    out_i = torch.empty((m,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(*args, cfg.splits, cfg.tiles_per_split, part_v.data_ptr(),
                  part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), stream)
    build.check(lib, code, f"{what} launch")
    return out_v, out_i.to(torch.int64)


def _aligned(t, align: int):
    """``t`` itself, or a copy where its base is off ``align`` bytes."""
    return t if t.data_ptr() % align == 0 else t.clone()


def _rank_int8_cuda(qa, qb, b2v, pack_idx: bool, c=None, valid_n: int = 0,
                    stream: int = -1):
    """Launch the int8 sweep, its rows zero-padded to whole 16-byte words
    and its bases on 16 bytes first where they are not. ``b2v=None``: the
    kernel forms the two-pass b2v itself from the rows' squares, the device
    scalar ``c`` and ``valid_n``. ``stream`` (the probe tile,
    ``int8_tile``'s) is for measuring one against another."""
    dev = _check_cuda("int8 1-NN", qa, qb, b2v if b2v is not None else c)
    qb = _aligned(_pad_dim(qb), ROW_WORD)
    qa = _aligned(_pad_to(qa, qb.shape[1]).contiguous(), ROW_WORD)
    m, dp = qa.shape
    n = qb.shape[0]
    tile = int8_tile(m, dp, dev.index, stream)
    cfg = sweep_config(m, n, _sms(dev), tile.tm, tile.per_sm)
    lib, fn = _kernels()[:2]
    mask = (PACK_MASK if pack_idx else -1) & 0xFFFFFFFF
    return _launch("knn_int8", fn, lib, m, cfg, dev,
                   (qa.data_ptr(), qb.data_ptr(),
                    None if b2v is None else b2v.data_ptr(),
                    None if c is None else c.data_ptr(), valid_n, m, n, dp, mask, stream))


def _check_int8_args(probes, q_gallery):
    if probes.dim() != 2 or q_gallery.dim() != 2:
        raise ValueError(f"expected (M, D) probes and (N, D) gallery, got "
                         f"{tuple(probes.shape)} and {tuple(q_gallery.shape)}")
    if q_gallery.dtype != torch.int8:
        raise TypeError(f"gallery must be int8, got {q_gallery.dtype}")
    if q_gallery.shape[0] == 0 or probes.shape[0] == 0:
        raise ValueError("empty probes or gallery")


# -- public wrappers -------------------------------------------------------


def nearest_neighbor_f32(probes, gallery, bf16: bool = True):
    """K2a: (M, D) probes x (N, D) gallery -> (min squared L2 (M,), argmin
    (M,)), lowest index on ties. ``bf16`` feeds bf16 operands (norms stay
    f32, the dot accumulates in f32), as the reference's default; False is
    exact f32. CPU tensors take ``nearest_neighbor_plain``."""
    if _on_cpu(probes, gallery):
        return nearest_neighbor_plain(probes, gallery, bf16)
    dev = _check_cuda("nearest_neighbor_f32", probes, gallery)
    if probes.dim() != 2 or gallery.dim() != 2 or probes.shape[1] != gallery.shape[1]:
        raise ValueError(f"expected (M, D) and (N, D), got {tuple(probes.shape)} "
                         f"and {tuple(gallery.shape)}")
    if probes.shape[0] == 0 or gallery.shape[0] == 0:
        raise ValueError("empty probes or gallery")
    a = probes.to(torch.float32).contiguous()
    b = gallery.to(torch.float32).contiguous()
    a2 = torch.sum(a * a, dim=1)
    b2 = torch.sum(b * b, dim=1)
    (m, d), n = a.shape, b.shape[0]
    lib, _, f32, bf16_sweep = _kernels()
    if bf16:
        # bf16 rows of whole 16-byte words, zero past d
        dp = -(-d // 8) * 8
        a, b = (_aligned(_pad_to(x.to(torch.bfloat16), dp), 16) for x in (a, b))
        cfg = sweep_config(m, n, _sms(dev), bf16_tile(m), BF16_PER_SM)
        dmin, idx = _launch("knn_bf16", bf16_sweep, lib, m, cfg, dev,
                            (a.data_ptr(), b.data_ptr(), a2.data_ptr(), b2.data_ptr(),
                             m, n, dp))
    else:
        # f32 rows of whole 16-byte words; the probes k-major, zero past m and d
        cfg = sweep_config(m, n, _sms(dev), F32_TM, 2)
        dp = -(-d // 4) * 4
        mp = -(-m // cfg.tm) * cfg.tm
        a_t = torch.zeros((dp, mp), dtype=a.dtype, device=dev)
        a_t[:d, :m] = a.T
        b = _aligned(_pad_to(b, dp), 16)
        dmin, idx = _launch("knn_f32", f32, lib, m, cfg, dev,
                            (a_t.data_ptr(), b.data_ptr(), a2.data_ptr(), b2.data_ptr(),
                             m, mp, n, dp))
    build.count_launch(nearest_neighbor_f32)
    return torch.clamp(dmin, min=0.0), idx


def _nn_int8(probes, gallery: PackedGallery, valid_n, pack_idx: bool, counter):
    """Shared body of K2b and K2c: rank the probes against a packed
    gallery, on the CPU through the plain twin, on CUDA through the kernel
    (``counter.launches`` counts the launch)."""
    _check_int8_args(probes, gallery.q)
    ops = _int8_operands(probes, gallery.b2i, gallery.scale, valid_n, pack_idx)
    if _on_cpu(probes, gallery.q):
        emin, idx = _rank_int8_plain(ops.qa, gallery.q, ops.b2v, pack_idx)
    else:
        emin, idx = _rank_int8_cuda(ops.qa, gallery.q, ops.b2v, pack_idx)
        build.count_launch(counter)
    return _int8_distances(ops, emin, pack_idx), idx


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def nearest_neighbor_int8q(probes, q_gallery, g_scale, valid_n=None,
                           pack_idx: bool = False):
    """K2b: 1-NN of f32 probes against a gallery quantized by
    ``quantize_embeddings``. Ranks ``e = b2/s − qa·qb`` and returns the
    exact squared L2 between the dequantized vectors, ``s·(e + a2)``, and
    the argmin. ``valid_n``: only the first rows are real; the rest get
    +inf (two-pass) or the sentinel (packed). ``pack_idx`` ranks and
    reports the key with 10 low mantissa bits cleared, as the reference's
    packed epilogue; the default is the two-pass epilogue every path of the
    port runs. On CUDA the two-pass sweep sums the gallery rows' squares
    itself, so a call makes no pass over the gallery but the kernel's; the
    packed epilogue needs the largest norm first, so it (and the CPU's
    plain twin) takes ``pack_quantized_gallery`` and then K2c's sweep."""
    _check_int8_args(probes, q_gallery)
    if not (pack_idx or _on_cpu(probes, q_gallery)):
        _check_cuda("nearest_neighbor_int8q", probes, q_gallery)
        ops = _int8_operands(probes, None, g_scale, valid_n, False)
        emin, idx = _rank_int8_cuda(ops.qa, q_gallery, None, False, c=ops.c,
                                    valid_n=_valid_rows(q_gallery.shape[0], valid_n))
        build.count_launch(nearest_neighbor_int8q)
        return _int8_distances(ops, emin, False), idx
    return _nn_int8(probes, pack_quantized_gallery(q_gallery, g_scale), valid_n,
                    pack_idx, nearest_neighbor_int8q)


def nearest_neighbor_int8p(probes, q, b2i, g_scale, pack_idx: bool = False):
    """K2c: K2b against a ``pack_quantized_gallery`` result (``*packed``):
    per query only the probes are quantized. Same numerics, same ties."""
    return _nn_int8(probes, PackedGallery(q, b2i, g_scale), None, pack_idx,
                    nearest_neighbor_int8p)


nearest_neighbor_f32.launches = 0
nearest_neighbor_int8q.launches = 0
nearest_neighbor_int8p.launches = 0


def nearest_neighbor_int8(probes, gallery, **kw):
    """Convenience form: quantize the f32 gallery here (exactly, as the
    reference's eager call does), then ``nearest_neighbor_int8q``."""
    qb, sb = quantize_embeddings(gallery)
    return nearest_neighbor_int8q(probes, qb, sb, **kw)


# -- plain twins -------------------------------------------------------------


def nearest_neighbor_int8_plain(probes, q_gallery, g_scale, valid_n=None,
                                pack_idx: bool = False):
    """The int8 kernels' exact math in plain PyTorch, on any device: the
    twin the CPU path runs and the kernels are held against. With
    ``pack_idx=False`` it is the counterpart of the reference's
    ``nearest_neighbor_int8_xla``. Writes the (M, N) matrix in chunks of
    probes."""
    _check_int8_args(probes, q_gallery)
    ops = _int8_operands(probes, _sumsq(q_gallery), g_scale, valid_n, pack_idx)
    emin, idx = _rank_int8_plain(ops.qa, q_gallery, ops.b2v, pack_idx)
    return _int8_distances(ops, emin, pack_idx), idx


def nearest_neighbor_plain(probes, gallery, bf16: bool = True):
    """K2a's math in plain PyTorch: norms in f32, the dot on bf16-rounded
    operands upcast to f32 (a bf16 x bf16 matmul would round its sum to
    bf16, which the reference's f32 accumulation does not),
    ``d = (a2 + b2) − 2ab``, first index on ties, clamped at 0."""
    a = probes.to(torch.float32)
    b = gallery.to(torch.float32)
    a2 = torch.sum(a * a, dim=1)
    b2 = torch.sum(b * b, dim=1)
    if bf16:
        a = a.to(torch.bfloat16).to(torch.float32)
        b = b.to(torch.bfloat16).to(torch.float32)
    with precision_scope("highest"):
        ab = a @ b.T
    d = (a2[:, None] + b2[None, :]) - 2.0 * ab
    idx = torch.argmin(d, dim=1)
    return torch.clamp(torch.gather(d, 1, idx[:, None])[:, 0], min=0.0), idx


def nearest_neighbor_chunked(probes, gallery, chunk: int = 512,
                             bf16: bool = True):
    """``nearest_neighbor_plain`` over chunks of probes, so only a
    (chunk, N) matrix exists at a time: the plain alternative where the
    full matrix would not fit (reference ``nearest_neighbor_chunked_xla``,
    ``knn.py:521``)."""
    outs = [nearest_neighbor_plain(probes[i:i + chunk], gallery, bf16)
            for i in range(0, probes.shape[0], chunk)]
    return (torch.cat([d for d, _ in outs]), torch.cat([i for _, i in outs]))


# -- routing -------------------------------------------------------------------


def use_kernel_path(m: int, n: int, device, force: bool = False,
                    hbm_limit_bytes: int = HBM_LIMIT_BYTES) -> bool:
    """Routing rule of ``nearest_neighbor_auto`` for f32: on CUDA the
    matrix-free kernel runs when forced or when the (M, N) f32 matrix would
    exceed ``hbm_limit_bytes``; below that, matmul + argmin (reference
    ``use_pallas_path``, ``knn.py:510``). CPU tensors never take it."""
    return torch.device(device).type == "cuda" and (
        force or 4 * m * n > hbm_limit_bytes)


def nearest_neighbor_auto(probes, gallery, force_kernel: bool = False,
                          int8: bool = False, valid_n: Optional[int] = None):
    """1-NN -> (min squared L2 (M,), argmin (M,)).

    ``int8=True``: ``gallery`` is f32 (quantized here) or a
    ``(q int8, scale)`` pair; ranking goes through K2b on CUDA, always
    (plain PyTorch has no int8 GEMM on CUDA that is not a library call),
    and through its twin on the CPU, with the two-pass epilogue on both:
    exact distances, the reference's off-TPU answers. f32: matmul + argmin
    unless ``use_kernel_path`` says K2a, which then runs on exact f32
    operands, so the answer does not depend on the gallery's size or the
    device."""
    if int8:
        qb, sb = gallery if isinstance(gallery, tuple) else quantize_embeddings(gallery)
        return nearest_neighbor_int8q(probes, qb, sb, valid_n=valid_n)
    if valid_n is not None:
        raise ValueError("valid_n is only supported with int8=True")
    if use_kernel_path(probes.shape[0], gallery.shape[0], probes.device,
                       force_kernel):
        return nearest_neighbor_f32(probes, gallery, bf16=False)
    d = pairwise_sqeuclidean(probes.to(torch.float32), gallery.to(torch.float32))
    idx = torch.argmin(d, dim=1)
    return torch.gather(d, 1, idx[:, None])[:, 0], idx
