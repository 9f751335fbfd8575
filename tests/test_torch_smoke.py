"""``chip_smoke.py``'s card-independent parts on the CPU: the least time the
card could take for a piece of work (``perfbench.flops.bound_s``, which
the smoke reads in ms and the benchmark's cells in seconds), and the smoke's
K2 check, that K2b and K2c are bit-equal to the int8 twin in both
epilogues. On CPU tensors the kernels' wrappers take their plain twins, so
the check passes exactly, and a planted fault in one kernel's answer fails
it naming that kernel and epilogue. Also the tables the K7 and K8 phases
walk, the K8 phase's library yardstick, and the K7 launch counts.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from hse_facerec_torch.ops.kernels import attention, knn
from perfbench import flops, swin, vit
from perfbench.flops import HBM_BYTES_PER_S, PEAK_OPS, bound_s

REPO = pathlib.Path(__file__).resolve().parents[1]


def _vit_cfg():
    return json.loads((REPO / "perfbench" / "configs" / "vit-l-arcface.json").read_text())


@pytest.mark.parametrize("case", ["k2c_identify", "k5_vit_chunk", "tie"])
def test_bound_s(case):
    if case == "k2c_identify":
        # one probe against 1,000,000 x 512 int8 rows: the gallery's bytes
        ops, nbytes = flops.knn_int8_work(1, 1_000_000, 512)
        assert (ops, nbytes) == (1.024e9, 516_000_520.0)
        kind, want_ms, want_by = "int8", 0.154, "bytes"
    elif case == "k5_vit_chunk":
        # K5 over a vit-enroll chunk, 256 x 144 tokens x 8 heads x 96: f32 math
        ops, nbytes = vit.attention_work(_vit_cfg(), 256)
        assert ops == 4.0 * 256 * 8 * 144 * 144 * 96
        kind, want_ms, want_by = "f32", 0.2434, "operations"
    else:
        # one second of bytes and one of f32 operations: a tie reads "bytes"
        ops, nbytes = PEAK_OPS["f32"], HBM_BYTES_PER_S
        kind, want_ms, want_by = "f32", 1e3, "bytes"
    seconds, by = bound_s(nbytes, ops, kind)
    assert by == want_by
    assert seconds * 1e3 == pytest.approx(want_ms, abs=5e-4)
    assert seconds == max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[kind])


def test_smoke_bound_is_perfbench_bound_in_ms():
    """The smoke prints ``bound_s`` in ms, bit for bit the ms it computed
    from the same peaks before it read them from ``perfbench``."""
    for nbytes, ops, kind in ((516_000_520.0, 1.024e9, "int8"),
                              (4.5e8, 1.63e10, "f32"), (2.0e9, 5.0e14, "bf16")):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[kind] * 1e3
        want = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        assert chip_smoke.bound(nbytes, ops, kind) == want


def _int8_case(m, n, d):
    rng = np.random.RandomState(m + n + d)
    g = rng.randn(n, d).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    g[n // 2:n // 2 + 3] = g[1:4]            # exact ties with lower rows
    p = rng.randn(m, d).astype(np.float32)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    p = torch.from_numpy(p)
    qb, sb = knn.quantize_embeddings(torch.from_numpy(g))
    return p, qb, sb, knn.pack_quantized_gallery(qb, sb)


# D 64 on whole 16-byte words, D 100 padded to them; every probe against
# nearest_neighbor_int8_plain, or every 3rd on the operands of the whole call
@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("stride", [None, 3], ids=["all", "every3"])
def test_int8_bit_equal_check_passes_on_the_plain_twins(d, stride):
    p, qb, sb, packed = _int8_case(37, 300, d)
    sub = None if stride is None else torch.arange(0, 37, stride)
    results = {k: {"max_abs_err": 0.0} for k in ("knn_int8q", "knn_int8p")}
    chip_smoke.check_int8_bit_equal("cpu", p, qb, sb, packed, sub=sub, results=results)
    assert results == {k: {"max_abs_err": 0.0} for k in ("knn_int8q", "knn_int8p")}


@pytest.mark.parametrize("kname,pack", [("knn_int8q", True), ("knn_int8p", False)])
def test_int8_bit_equal_check_names_a_faulty_kernel(monkeypatch, kname, pack):
    """One index moved in one kernel's answer, in one epilogue only."""
    fn = getattr(knn, "nearest_neighbor_" + kname[4:])

    def faulty(*args, pack_idx=False, **kw):
        dist, idx = fn(*args, pack_idx=pack_idx, **kw)
        if pack_idx == pack:
            idx = idx.clone()
            idx[5] += 1
        return dist, idx

    monkeypatch.setattr(knn, "nearest_neighbor_" + kname[4:], faulty)
    p, qb, sb, packed = _int8_case(16, 200, 64)
    with pytest.raises(AssertionError, match=f"{kname} cpu pack_idx={pack}: 1 indices"):
        chip_smoke.check_int8_bit_equal("cpu", p, qb, sb, packed)


@pytest.mark.parametrize("size", [224, 192])
def test_bias_relu6_layers_are_the_backbones(size):
    """The smoke's K7 table: each folded layer's conv output (C, H, W) as
    the backbone computes it, and the zero edge on exactly the layers whose
    next conv pads one row and column at the bottom right."""
    from hse_facerec_torch.models import layers, mobilenet

    rows = chip_smoke.bias_relu6_layers(size)
    assert [r[0] for r in rows] == ["conv1"] + [f"{k}{i}" for i in range(1, 14)
                                                for k in ("dw", "pw")]
    h, c = -(-size // 2), 32
    strides = [s for s, _ in mobilenet.MOBILENET_V1_BLOCKS] + [1]
    for name, chw, edge in rows:
        if name.startswith("dw"):
            h = -(-h // strides[int(name[2:]) - 1])
        elif name.startswith("pw"):
            c = mobilenet.MOBILENET_V1_BLOCKS[int(name[2:]) - 1][1]
        assert chw == (c, h, h), name
        # the next conv's stride: the next block's depthwise conv after pw_i,
        # stride 1 after conv1 (dw1) and after dw_i (pw_i)
        nxt = strides[int(name[2:])] if name.startswith("pw") else 1
        assert edge == layers.bottom_right_edge((1, c, h, h), (c, 1, 3, 3), nxt), name
    assert sum(r[2] for r in rows) == 4


class _Heads:
    def forward(self, params, x):
        return x.shape[0]


@pytest.mark.parametrize("kind", ["method", "attribute"])
def test_forwards_counted_counts_non_empty_forwards_and_restores(kind):
    """The smoke's forward counter: the calls on a non-empty batch inside
    the block, each passed through, and the method or instance attribute
    put back after it."""
    obj = _Heads()
    if kind == "attribute":
        obj.forward = lambda params, x: -x.shape[0]
    before = obj.forward
    with chip_smoke.forwards_counted(obj, "forward") as count:
        assert obj.forward(None, torch.zeros(3, 2)) == (3 if kind == "method" else -3)
        obj.forward(None, torch.zeros(0, 2))
        obj.forward(None, x=torch.zeros(1, 2))
    assert count == [2]
    assert obj.forward == before and ("forward" in vars(obj)) == (kind == "attribute")


@pytest.mark.parametrize("launched,forwards,per_forward,ok",
                         [(54, 2, 27, True), (0, 3, 0, True), (27, 2, 27, False),
                          (27, 1, 0, False)])
def test_check_k7_launches(launched, forwards, per_forward, ok):
    """A main path's K7 count is held to ``per_forward`` a forward, exactly."""
    launches = {"bias_relu6": launched, "bn_act": 99}
    if ok:
        chip_smoke.check_k7_launches("path", launches, forwards, per_forward)
    else:
        with pytest.raises(AssertionError, match=f"path: {launched} K7 launches over "
                                                 f"{forwards} forwards"):
            chip_smoke.check_k7_launches("path", launches, forwards, per_forward)


def test_window_launches_are_swin_ts_blocks():
    """The smoke's K8 table: one launch a block of the swin-enroll cell's
    Swin-T, in order, the odd blocks shifted by 3 while the map holds more
    than one window, beside the benchmark's work of each launch."""
    cfg = chip_smoke.swin_config()
    rows = chip_smoke.window_launches(cfg)
    assert rows == ([(56, 3, 0), (56, 3, 3), (28, 6, 0), (28, 6, 3)]
                    + [(14, 12, 0), (14, 12, 3)] * 3 + [(7, 24, 0)] * 2)
    work = swin.window_attention_work(cfg, 1)
    assert [nbytes for _, nbytes in work] == [16.0 * 32 * h * r * r for r, h, _ in rows]


@pytest.mark.parametrize("shape", [(2, 14, 2, 3), (1, 7, 3, 0), (2, 21, 1, 3)], ids=str)
def test_window_sdpa_is_window_attention_plain(shape):
    """The smoke's library yardstick for K8 (``F.scaled_dot_product_attention``
    on torch's windows with the bias and mask as a float ``attn_mask``),
    put back in the map's order, computes K8's function: within 1e-5 of
    ``window_attention_plain`` in float32 (the two scale at different
    points and sum in different orders)."""
    b, r, h, shift = shape
    gen = torch.Generator().manual_seed(5)
    qkv = torch.randn(b, r, r, 3 * h * 32, generator=gen) * 1.5
    bias = torch.randn(h, 49, 49, generator=gen)
    _, got = chip_smoke.window_sdpa(qkv, h, shift, bias)
    want = attention.window_attention_plain(qkv, h, 7, shift, bias)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
