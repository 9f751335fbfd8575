"""The bias + ReLU6 kernel K7 (``ops/kernels/bn_act.py::bias_relu6``) and
MobileNet-V1's folded forward on it (``models/mobilenet.py::_backbone``).

On the CPU: ``bias_relu6_plain`` is the eager folded layer bit for bit at
every layer shape of MobileNet-V1 at 224² and 192², and with ``pad_next``
the ``F.pad`` the next conv would make; the wrapper's padded buffer has
``F.pad``'s shape and strides; the wrapper refuses what K7 does not take
and any call that autograd would record; the CPU's backbone never calls
it; and the K7 grouping of the backbone (with the plain version in K7's
place) gives the eager forward's bits, one pass a layer, four of them
padded, on NHWC memory and on an NHWC view of NCHW memory alike. On a
card (``-m cuda``): K7 at every (layer, shape) of a 256-face chunk is the
plain version's bits, NaN and ±inf included; the full ``multihead_apply``
forward is ``torch.equal`` to the eager forward at batch 8 and 256 with
27 launches a forward, in either memory layout, and holds no more memory
at its peak; the 192² backbone is the eager one's bits; a BN-form or bf16
forward launches none. No JAX here: the card's tests run
with ``--noconftest``."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hse_facerec_torch import testing
from hse_facerec_torch.models import layers, mobilenet, multihead, zoo
from hse_facerec_torch.ops.kernels import bn_act as k7
from hse_facerec_torch.ops.kernels import kernel_launches
from hse_facerec_torch.params import to_torch

SEED = 2 ** 33 + 2401
EDGE = ("pw1", "pw3", "pw5", "pw11")   # the layers whose next conv pads bottom-right


def mobilenet_layers(size: int):
    """(name, conv, input (C, H, W), weight shape, stride, pads the next
    conv's edge) of the 27 layers of MobileNet-V1 at ``size``²."""
    out = [("conv1", layers.conv2d, (3, size, size), (32, 3, 3, 3), 2, False)]
    c, h = 32, -(-size // 2)
    for i, (stride, cout) in enumerate(mobilenet.MOBILENET_V1_BLOCKS, start=1):
        out.append((f"dw{i}", layers.depthwise_conv2d, (c, h, h), (c, 1, 3, 3), stride, False))
        h = -(-h // stride)
        out.append((f"pw{i}", layers.conv2d, (c, h, h), (cout, c, 1, 1), 1, f"pw{i}" in EDGE))
        c = cout
    return out


LAYERS = {size: mobilenet_layers(size) for size in (224, 192)}


def _operands(chw, wshape, batch, gen):
    """A channels-last input of ``chw`` (normals times 3) and the layer's
    weight and bias, from ``gen``."""
    dev = gen.device
    x = (torch.randn((batch,) + chw, generator=gen, device=dev) * 3.0).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(wshape, generator=gen, device=dev) / np.sqrt(np.prod(wshape[1:]))
    return x, w, torch.randn(wshape[0], generator=gen, device=dev)


def _conv_out(name, size, batch, gen):
    """A layer's bias-free conv output at batch ``batch`` and its bias, the
    first elements 0, -0, NaN, ±inf, ±1e-30 and 6."""
    _, conv, chw, wshape, stride, edge = next(l for l in LAYERS[size] if l[0] == name)
    x, w, b = _operands(chw, wshape, batch, gen)
    y = conv(x, w, stride=stride)
    y.permute(0, 2, 3, 1).reshape(-1)[:8] = torch.tensor(
        [0.0, -0.0, float("nan"), float("inf"), -float("inf"), 1e-30, -1e-30, 6.0])
    return y, b, edge


def _same(got, want):
    return (got.shape == want.shape and got.stride() == want.stride()
            and torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.nan_to_num(), want.nan_to_num())
            and torch.equal(torch.signbit(got), torch.signbit(want)))


# ---------- on the CPU ----------

@pytest.mark.parametrize("size", [224, 192])
@pytest.mark.parametrize("index", range(27), ids=[l[0] for l in LAYERS[224]])
def test_plain_is_the_eager_layer(size, index):
    """``bias_relu6_plain`` of the bias-free conv is the eager layer
    ``relu6(conv(x, k, bias))``; at the four layers before a stride-2
    depthwise conv it is also that layer's ``F.pad``, and the next conv on
    it without padding is that conv with its SAME padding."""
    name, conv, chw, wshape, stride, edge = LAYERS[size][index]
    gen = torch.Generator().manual_seed(SEED + size + index)
    x, w, b = _operands(chw, wshape, 2, gen)
    want = layers.relu6(conv(x, w, b, stride=stride))
    assert _same(k7.bias_relu6_plain(conv(x, w, stride=stride), b), want)
    if edge:
        padded = k7.bias_relu6_plain(conv(x, w, stride=stride), b, pad_next=True)
        assert _same(padded, F.pad(want, (0, 1, 0, 1)))
        nxt = LAYERS[size][index + 1]
        wn = torch.randn(nxt[3], generator=gen)
        assert layers.bottom_right_edge(want.shape, wn.shape, nxt[4])
        assert torch.equal(nxt[1](padded, wn, stride=nxt[4], padding="VALID"),
                           nxt[1](want, wn, stride=nxt[4]))
    else:
        nxt = LAYERS[size][index + 1] if index + 1 < 27 else None
        assert nxt is None or not layers.bottom_right_edge(want.shape, nxt[3], nxt[4])


@pytest.mark.parametrize("shape", [(2, 64, 112, 112), (3, 256, 28, 28), (1, 512, 14, 14)])
def test_padded_buffer_is_f_pads(shape):
    """The padded activation: (N, C, H+1, W+1), channels-last, F.pad's
    strides and the ones the wrapper allocates, the last row and column
    +0.0 and the rest the activation."""
    gen = torch.Generator().manual_seed(SEED + shape[1])
    y = torch.randn(shape, generator=gen).contiguous(memory_format=torch.channels_last) * 4
    b = torch.randn(shape[1], generator=gen)
    out = k7.bias_relu6_plain(y, b, pad_next=True)
    n, c, h, w = shape
    assert out.shape == (n, c, h + 1, w + 1)
    assert out.stride() == F.pad(y, (0, 1, 0, 1)).stride()
    assert out.stride() == torch.empty(out.shape, memory_format=torch.channels_last).stride()
    edge = torch.cat([out[:, :, h].reshape(-1), out[:, :, :, w].reshape(-1)])
    assert torch.equal(edge, torch.zeros_like(edge)) and not bool(torch.signbit(edge).any())
    assert torch.equal(out[:, :, :h, :w], k7.bias_relu6_plain(y, b))


@pytest.mark.parametrize("case", ["cpu", "bfloat16", "nchw", "strided", "channels_5",
                                  "misaligned", "bias_shape", "y_grad", "bias_grad",
                                  "no_grad"])
def test_wrapper_refuses_what_k7_does_not_take(case):
    """CPU tensors, any dtype but float32, a layout other than
    channels-last (contiguous NCHW, a strided view), C off a multiple of
    4, a base off 16 bytes, a bias of another shape, and any call that
    autograd would record; under ``no_grad`` the same call goes on (to the
    CPU's refusal, here)."""
    gen = torch.Generator().manual_seed(SEED + 7)
    y = torch.randn(2, 8, 6, 6, generator=gen).contiguous(memory_format=torch.channels_last)
    b = torch.randn(8, generator=gen)
    err, match = ValueError, "runs on CUDA"
    if case == "bfloat16":
        y, b, err, match = y.bfloat16(), b.bfloat16(), TypeError, "float32"
    elif case == "nchw":
        y, match = y.contiguous(), "channels-last"
    elif case == "strided":
        y, match = y[:, :, ::2], "channels-last"
    elif case == "channels_5":
        y = torch.randn(2, 5, 6, 6, generator=gen).contiguous(memory_format=torch.channels_last)
        b, match = b[:5], "multiple of 4"
    elif case == "misaligned":
        flat = torch.randn(2 * 8 * 6 * 6 + 1, generator=gen)[1:]
        y, match = flat.view(2, 6, 6, 8).permute(0, 3, 1, 2), "16-byte"
    elif case == "bias_shape":
        b, match = torch.randn(4, generator=gen), "bias must be"
    elif case in ("y_grad", "no_grad"):
        y.requires_grad_()
    elif case == "bias_grad":
        b.requires_grad_()
    if case in ("y_grad", "bias_grad"):
        err, match = RuntimeError, "no backward"
    if case == "no_grad":
        with torch.no_grad(), pytest.raises(err, match=match):
            k7.bias_relu6(y, b)
    else:
        with pytest.raises(err, match=match):
            k7.bias_relu6(y, b, pad_next=True)


def _refuse(*args, **kwargs):
    raise AssertionError("the CPU's backbone called K7")


@pytest.mark.parametrize("form", ["folded", "bn", "bf16", "bf16_blocks_below_4", "train"])
def test_cpu_backbone_never_calls_k7(monkeypatch, form):
    """On CPU tensors every form of the backbone runs the eager passes: the
    folded form, the BN form (eval and train), bf16 and the bf16 dial."""
    monkeypatch.setattr(mobilenet, "bias_relu6", _refuse)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(2, 64, 64, 3).astype(np.float32) * 100 - 50)
    kw = {}
    if form in ("bn", "train"):
        params = mobilenet.init_mobilenet_params(torch.Generator().manual_seed(4), device="cpu")
        kw["train"] = form == "train"
    else:
        params = to_torch(testing.random_mobilenet_params(rng), "cpu")
    if form == "bf16":
        kw["compute_dtype"] = torch.bfloat16
    elif form == "bf16_blocks_below_4":
        kw["bf16_blocks_below"] = 4
    before = k7.bias_relu6.launches
    with torch.no_grad():
        out = mobilenet.mobilenet_v1_backbone(params, x, **kw)
    assert out.shape == (2, 2, 2, 1024) and bool(torch.isfinite(out.float()).all())
    assert k7.bias_relu6.launches == before


@pytest.mark.parametrize("size,bf16_blocks_below,calls,padded,layout",
                         [(224, 0, 27, 4, "nhwc"), (192, 0, 27, 4, "nhwc"),
                          (224, 4, 20, 2, "nhwc"), (112, 0, 27, 3, "nhwc"),
                          (224, 0, 27, 4, "nchw")])
def test_k7_grouping_gives_the_eager_bits(monkeypatch, size, bf16_blocks_below, calls,
                                          padded, layout):
    """The backbone's K7 path with ``bias_relu6_plain`` in K7's place (and
    the CPU taken for a card): the eager forward's bits, one channels-last
    pass for each float32 layer, the next conv's edge written where that
    conv is a stride-2 depthwise conv on an even size (at 112² dw12's input
    is 7 wide and pads both sides, in the conv); an NHWC view of NCHW
    memory, as the extractor's resize hands over, is made channels-last at
    a card's backbone entry, takes the same passes and gives the eager
    bits of the same images in NHWC memory."""
    seen = []

    def plain(y, bias, *, pad_next=False):
        seen.append(pad_next)
        assert y.is_contiguous(memory_format=torch.channels_last)
        return k7.bias_relu6_plain(y, bias, pad_next=pad_next)

    rng = np.random.RandomState(size)
    params = to_torch(testing.random_multihead_params(rng), "cpu")
    x = torch.from_numpy(rng.rand(2, size, size, 3).astype(np.float32) * 200 - 100)
    with torch.no_grad():
        want = multihead.multihead_apply(params, x, bf16_blocks_below=bf16_blocks_below)
        if layout == "nchw":    # NHWC view of contiguous NCHW memory, as a resize hands over
            x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        monkeypatch.setattr(mobilenet, "bias_relu6", plain)
        monkeypatch.setattr(mobilenet, "_on_card", lambda x: True)
        got = multihead.multihead_apply(params, x, bf16_blocks_below=bf16_blocks_below)
    assert len(seen) == calls and sum(seen) == padded
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_launches_lists_k7():
    assert kernel_launches()["bias_relu6"] == k7.bias_relu6.launches


# ---------- on a card ----------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [224, 192])
@pytest.mark.parametrize("index", range(27), ids=[l[0] for l in LAYERS[224]])
def test_k7_is_the_plain_passes_bit_for_bit(card, size, index):
    """One K7 launch at a layer's conv output of a 256-face chunk (cuDNN's
    output, channels-last) equals torch's add, clamp and, where the layer
    pads the next conv's edge, ``F.pad``: the same bits, NaN where they
    have NaN, ±inf clipped as ``torch.clamp`` clips it, the same strides."""
    name = LAYERS[size][index][0]
    gen = torch.Generator(device=card).manual_seed(SEED + 11 * size + index)
    with torch.no_grad():
        y, b, edge = _conv_out(name, size, 256, gen)
        assert y.is_contiguous(memory_format=torch.channels_last)
        for pad in sorted({False, edge}):
            before = k7.bias_relu6.launches
            got = k7.bias_relu6(y, b, pad_next=pad)
            assert k7.bias_relu6.launches == before + 1
            want = k7.bias_relu6_plain(y, b, pad_next=pad)
            torch.cuda.synchronize()
            assert _same(got, want), (name, pad)
            del got, want
    del y
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [False, True])
def test_empty_batch_launches_nothing(card, pad):
    y = torch.empty((0, 64, 112, 112), device=card).contiguous(memory_format=torch.channels_last)
    before = k7.bias_relu6.launches
    out = k7.bias_relu6(y, torch.zeros(64, device=card), pad_next=pad)
    assert out.shape == (0, 64, 112 + pad, 112 + pad) and k7.bias_relu6.launches == before


def _eager(monkeypatch):
    monkeypatch.setattr(mobilenet, "_on_k7", lambda p, dt, x: False)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,layout,launches", [(8, "nhwc", 27), (256, "nhwc", 27),
                                                   (8, "nchw", 27)])
def test_multihead_forward_is_the_eager_forward(card, monkeypatch, batch, layout, launches):
    """``multihead_apply`` at 224² on the card: 27 K7 launches a forward on
    NHWC memory and on an NHWC view of NCHW memory (copied to
    channels-last at the backbone's entry), every output ``torch.equal`` to
    the eager forward's on the same card."""
    rng = np.random.RandomState(batch)
    params = to_torch(testing.random_multihead_params(rng), "cuda")
    x = torch.from_numpy(rng.rand(batch, 224, 224, 3).astype(np.float32) * 200 - 100).cuda()
    if layout == "nchw":
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with torch.no_grad():
        before = k7.bias_relu6.launches
        got = multihead.multihead_apply(params, x)
        assert k7.bias_relu6.launches - before == launches
        _eager(monkeypatch)
        want = multihead.multihead_apply(params, x)
        assert k7.bias_relu6.launches - before == launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_k7_forward_peak_is_at_most_the_eager_forwards(card, monkeypatch):
    """A 256-face forward on K7 holds no more device memory at its peak
    than the eager forward: the padded buffers are one row and column
    larger, and the block's input is freed before its pointwise pass."""
    rng = np.random.RandomState(11)
    params = to_torch(testing.random_multihead_params(rng), "cuda")
    x = torch.from_numpy(rng.rand(256, 224, 224, 3).astype(np.float32) * 200 - 100).cuda()
    peaks = []
    for eager in (False, True):
        if eager:
            _eager(monkeypatch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            out = multihead.multihead_apply(params, x)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        del out
    assert peaks[0] <= peaks[1], peaks


@pytest.mark.cuda
def test_192_backbone_is_the_eager_backbone(card, monkeypatch):
    """``vgg2_mobilenet``'s size: the same four edges at 192², the same
    bits as the eager backbone."""
    rng = np.random.RandomState(192)
    params = to_torch(testing.random_mobilenet_params(rng), "cuda")
    x = torch.from_numpy(rng.rand(16, 192, 192, 3).astype(np.float32) * 200 - 100).cuda()
    with torch.no_grad():
        got = mobilenet.mobilenet_embed(params, x)
        _eager(monkeypatch)
        want = mobilenet.mobilenet_embed(params, x)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("crop", [224, 200])
def test_one_chunk_counts_27_k7_launches(card, monkeypatch, crop):
    """One 256-crop ``extract_batch`` through ``agegender_identity``'s
    extractor: 27 K7 launches and no other kernel of the library, on 224²
    crops and on 200² crops, which its resize (two einsums) brings to 224²
    in memory that is not channels-last; the eager extractor's embeddings
    in both."""
    params = testing.random_multihead_params(np.random.RandomState(5))
    ex = zoo.build_extractor("agegender_identity", batch_size=256, device="cuda",
                             params=params)
    crops = np.random.RandomState(6).randint(0, 256, (256, crop, crop, 3), dtype=np.uint8)
    ex.extract_batch(crops)
    torch.cuda.synchronize()
    before = kernel_launches()
    got = ex.extract_batch(crops)
    after = kernel_launches()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "bias_relu6": 27}
    _eager(monkeypatch)
    assert np.array_equal(got, ex.extract_batch(crops))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bn", "bf16"])
def test_bn_and_bf16_forwards_launch_no_k7(card, form):
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.rand(4, 224, 224, 3).astype(np.float32) * 200 - 100).cuda()
    before = k7.bias_relu6.launches
    with torch.no_grad():
        if form == "bn":
            params = mobilenet.init_mobilenet_params(torch.Generator().manual_seed(4),
                                                     device="cuda")
            out = mobilenet.mobilenet_embed(params, x)
        else:
            params = to_torch(testing.random_multihead_params(rng), "cuda")
            out = multihead.multihead_apply(params, x, torch.bfloat16).identity
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert k7.bias_relu6.launches == before


@pytest.mark.cuda
def test_card_forward_refuses_a_recorded_forward(card):
    """K7 has no backward: a folded forward on the card that autograd
    would record raises; under ``no_grad`` it runs on K7."""
    rng = np.random.RandomState(10)
    params = to_torch(testing.random_mobilenet_params(rng), "cuda")
    params["pw7"]["bias"].requires_grad_()
    x = torch.from_numpy(rng.rand(2, 224, 224, 3).astype(np.float32) * 200 - 100).cuda()
    with pytest.raises(RuntimeError, match="no backward"):
        mobilenet.mobilenet_embed(params, x)
    before = k7.bias_relu6.launches
    with torch.no_grad():
        mobilenet.mobilenet_embed(params, x)
    assert k7.bias_relu6.launches - before == 27
