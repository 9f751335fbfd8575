"""The port's benchmark (``hse_facerec_torch/bench.py``) and what it needs,
against the JAX package on the CPU: the bf16 inference tier of
``multihead_apply``, the analytic FLOP count against XLA's cost analysis,
the int8 cosine guard, K2a's bf16 route, every measured path at tiny
sizes, the codec-free inputs and the refusal to run without a card.

Tolerances and their reasons:
- ``multihead_apply`` float32 against the jitted JAX forward (HIGHEST):
  1e-4 of each output's largest magnitude (the packages sum the convs in
  another order);
- bf16 (``compute_dtype``) against JAX's bf16 forward: cosine of the
  identity at least 0.999 (both round every layer's activations to bf16,
  each after its own f32 sums; 0.99999 measured on these inputs);
- the analytic FLOPs of ``flops_bytes_multihead`` within 2% of XLA's
  ``cost_analysis()["flops"]`` at 224² (XLA also counts the bias, ReLU6
  and softmax work, 0.8% here);
- the int8 cosine guard (int8 against float32 identity, least over the
  images) within 1e-3 of JAX's (the two int8 paths flip a requant by one
  quantum on a few values);
- K2a's bf16 route and the chunked twin on bf16 operands: indices equal
  to JAX's ``nearest_neighbor_tpu(bf16=True, interpret=True)``.
The bench's paths run at tiny sizes on the CPU: their keys are checked,
with finite positive values; no number of theirs is a measurement.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu.models import int8_infer as jqi
from hse_facerec_tf_tpu.models import multihead as jmh
from hse_facerec_tf_tpu.ops.pallas import knn as jknn
from hse_facerec_torch import bench
from hse_facerec_torch.models.multihead import multihead_apply
from hse_facerec_torch.ops.kernels import knn as tknn
from hse_facerec_torch.params import to_torch
from hse_facerec_torch.testing import (ALBUM_SIZES, bmp_bytes, decode_bmp, read_bmp,
                                       random_mtcnn_params, random_multihead_params,
                                       synthetic_album, write_bmp)

HIGHEST = jax.lax.Precision.HIGHEST
MEANS_BGR = np.asarray((103.939, 116.779, 123.68), np.float32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mh_params():
    return random_multihead_params(np.random.RandomState(100))


def _preprocessed(n: int, size: int, seed: int) -> np.ndarray:
    """Seeded BGR mean-subtracted inputs, as ``build_forward`` makes them."""
    rgb = np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32) * 255
    return np.ascontiguousarray(rgb[..., ::-1]) - MEANS_BGR


def _cosines(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_multihead_apply_f32_matches_jax(mh_params):
    x = _preprocessed(3, 64, 1)
    want = jax.jit(lambda v: jmh.multihead_apply(mh_params, v, precision=HIGHEST))(x)
    got = multihead_apply(to_torch(mh_params, "cpu"), torch.from_numpy(x))
    for field in ("identity", "feats", "age_probs", "gender_prob"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field)
        assert g.dtype == torch.float32, field
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()), err_msg=field)


def test_multihead_apply_bf16_matches_jax_bf16(mh_params):
    """The bf16 tier: backbone in bf16, identity cast to float32 after the
    pool, heads in float32, as JAX ``compute_dtype=jnp.bfloat16``."""
    x = _preprocessed(4, 64, 2)
    want = jax.jit(lambda v: jmh.multihead_apply(mh_params, v,
                                                 compute_dtype=jnp.bfloat16))(x)
    got = multihead_apply(to_torch(mh_params, "cpu"), torch.from_numpy(x),
                          compute_dtype=torch.bfloat16)
    assert got.identity.dtype == torch.float32 and got.feats.dtype == torch.float32
    cos = _cosines(got.identity.numpy(), want.identity)
    print(f"bf16 identity cosine, port vs JAX: min {cos.min():.7f}")
    assert cos.min() >= 0.999
    # the tier is not the float32 forward: bf16 moved the identity
    f32 = multihead_apply(to_torch(mh_params, "cpu"), torch.from_numpy(x)).identity
    assert not torch.equal(f32, got.identity)


def test_analytic_flops_match_xla_cost_analysis(mh_params):
    x = jnp.zeros((1, 224, 224, 3), jnp.float32)
    compiled = jax.jit(lambda v: jmh.multihead_apply(mh_params, v, precision=HIGHEST)
                       ).lower(x).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    flops, bytes_ = bench.flops_bytes_multihead(mh_params, (224, 224))
    print(f"analytic {flops / 1e9:.4f} GFLOP an image, XLA {ca['flops'] / 1e9:.4f}")
    assert abs(flops / ca["flops"] - 1.0) < 0.02
    # the image read once, the weights once, the identity written once
    weights = sum(a.nbytes for layer in mh_params["backbone"].values() for a in layer.values())
    weights += sum(a.nbytes for h in ("feats", "age", "gender")
                   for a in mh_params[h].values())
    assert bytes_ == 224 * 224 * 3 * 4 + 1024 * 4 + weights
    flops8, bytes8 = bench.flops_bytes_multihead(mh_params, (224, 224), batch=8,
                                                 weight_bytes=1000)
    assert flops8 == 8 * flops and bytes8 == 8 * (224 * 224 * 3 * 4 + 1024 * 4) + 1000


def test_int8_cosine_guard_matches_jax(mh_params):
    rgb = np.random.RandomState(3).rand(8, 64, 64, 3).astype(np.float32) * 255
    got = bench.int8_cosine_vs_f32(mh_params, torch.from_numpy(rgb), "cpu")
    x = np.ascontiguousarray(rgb[..., ::-1]) - MEANS_BGR
    qp = jqi.quantize_multihead_int8(mh_params)
    a = jax.jit(lambda v: jqi.multihead_apply_int8(qp, v).identity)(x)
    b = jax.jit(lambda v: jmh.multihead_apply(mh_params, v, precision=HIGHEST).identity)(x)
    want = float(_cosines(a, b).min())
    print(f"int8 cosine guard: port {got:.6f}, JAX {want:.6f}")
    assert 0.0 < got <= 1.0
    assert abs(got - want) < 1e-3


def test_k2a_bf16_route_matches_jax():
    rng = np.random.RandomState(4)
    p = rng.randn(64, 32).astype(np.float32)
    g = rng.randn(1000, 32).astype(np.float32)
    _, want = jknn.nearest_neighbor_tpu(jnp.asarray(p), jnp.asarray(g), bf16=True,
                                        interpret=True)
    _, got = tknn.nearest_neighbor_f32(torch.from_numpy(p), torch.from_numpy(g), bf16=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the chunked twin on bf16 operands ranks as the bf16 kernel does (JAX's
    # chunked XLA form keeps f32 operands off the TPU, so it is no oracle here)
    _, got_c = tknn.nearest_neighbor_chunked(torch.from_numpy(p), torch.from_numpy(g),
                                             16, bf16=True)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want))


# every path at tiny sizes: (name, call, the bench.py keys it returns,
# the rooflines it returns)
_PARAMS = {}


def _seeded():
    if not _PARAMS:
        _PARAMS["p"] = (random_mtcnn_params(np.random.RandomState(2)),
                        random_multihead_params(np.random.RandomState(100)))
    return _PARAMS["p"]


ONE = dict(chain=1, warmup=1, iters=1, device="cpu")
PATHS = [
    ("embed_f32", lambda: bench.bench_embed(torch.float32, batch=2, size=32,
                                            params=_seeded()[1], **ONE),
     ("headline_ips",), ("embed_f32",)),
    ("embed_bf16", lambda: bench.bench_embed(torch.bfloat16, batch=2, size=32,
                                             params=_seeded()[1], **ONE),
     ("embed_bf16_ips",), ("embed_bf16",)),
    ("embed_int8", lambda: bench.bench_embed_int8(batch=8, size=32, params=_seeded()[1],
                                                  **ONE),
     ("embed_int8_ips", "embed_int8_cosine_vs_f32"), ("embed_int8",)),
    ("detection", lambda: bench.bench_detection(nb=2, hw=(96, 128),
                                                mtcnn_params=_seeded()[0], **ONE),
     ("detect_ms_per_image_640x480", "detect_batch8_ips_640x480"), ("detect_batch8",)),
    ("analyze", lambda: bench.bench_analyze(nb=2, hw=(96, 128), params=_seeded(), **ONE),
     ("analyze_ms_per_image_640x480", "analyze_batch8_ips_640x480"), ("analyze",)),
    ("knn", lambda: bench.bench_knn(m=8, n=100, d=16, **ONE),
     ("knn_8kx1M_pallas_ms", "knn_8kx1M_chunked_xla_ms", "knn_8kx1M_int8_ms"),
     ("knn_8kx1M", "knn_8kx1M_int8")),
    ("train", lambda: bench.bench_train(batch=2, size=32, n_classes=5, **ONE),
     ("train_face_id_ips_bs256",), ("train_bs256",)),
    ("train_age_gender", lambda: bench.bench_train_age_gender(batch=2, size=32, **ONE),
     ("train_age_gender_pairs_ips_bs256",), ("train_age_gender_bs256",)),
    ("album", lambda: bench.bench_album(n_photos=4, video_frames=2,
                                        sizes=((160, 120), (128, 96)),
                                        downscale=(160, 120), params=_seeded(),
                                        device="cpu"),
     ("album_photos_per_sec", "album_total_s", "album_n_photos", "album_n_videos",
      "album_n_faces", "album_n_clusters"), ()),
    ("serve", lambda: bench.bench_serve(n_clients=2, requests_per_client=2, size=32,
                                        max_batch=8, params=_seeded()[1], device="cpu"),
     ("serve_p50_ms", "serve_p95_ms", "serve_coalesced_ips", "serve_clients"), ()),
    ("pb_extractor", lambda: bench.bench_pb_extractor(batch=2, size=32,
                                                      params=_seeded()[1], **ONE),
     ("pb_extractor_highest_ips", "pb_extractor_high_ips", "native_high_b64_ips"), ()),
]


@pytest.mark.parametrize("name,call,keys,roofs", PATHS, ids=[p[0] for p in PATHS])
def test_bench_path_on_cpu(name, call, keys, roofs):
    out = call()
    extra = out["extra"]
    for k in keys:
        v = extra[k]
        assert isinstance(v, (int, float)) and np.isfinite(v) and v > 0, (k, v)
    assert set(out["roofline"]) == set(roofs)
    for entry in out["roofline"].values():
        assert entry["bound"] in ("compute", "hbm", "other")
        assert entry["gflop_per_unit"] > 0 and entry["mb_per_unit"] > 0
        # no card: no device profile, so no busy share
        assert "busy_share" not in entry
    for ms in out["samples"].values():
        assert ms and all(np.isfinite(ms))
    if name == "embed_int8":
        assert extra["embed_int8_cosine_vs_f32"] <= 1.0
    if name == "album":
        assert extra["album_n_photos"] == 4 and extra["album_n_videos"] == 1
        assert "phases" in extra["album_timings"]
    if name == "serve":
        assert set(extra["serve_decomposition"]) == {"queue_wait", "assemble", "process"}
    if name == "pb_extractor":
        # TF32 changes nothing on the CPU, and no profile: no busy rate
        assert extra["pb_extractor_high_max_abs_diff"] == 0.0
        assert extra["native_high_b64_device_ips_busy"] is None


def test_bench_serve_runs_build_server(monkeypatch):
    """The serve path measures the server ``build_server`` wires, with no
    analyzer, prewarmed, on the seeded weights and the BMP decoder."""
    import hse_facerec_torch.serve as serve_mod

    seen, real = {}, serve_mod.build_server

    def spy(**kw):
        seen.update(kw)
        return real(**kw)

    monkeypatch.setattr(serve_mod, "build_server", spy)
    out = bench.bench_serve(n_clients=1, requests_per_client=2, size=32, max_batch=8,
                            params=_seeded()[1], device="cpu")
    assert out["extra"]["serve_clients"] == 1
    assert (seen["port"], seen["host"], seen["max_batch"]) == (0, "127.0.0.1", 8)
    assert seen["with_analyzer"] is False and seen["prewarm"] is True
    assert seen["params"] is _seeded()[1] and seen["decode"] is decode_bmp
    assert seen["model"] == "agegender_identity" and seen["device"] == "cpu"


def test_every_bench_key_has_a_path():
    """The keys the paths return, with the headline and the profiled rate
    (present only with a card), are ``bench.py``'s ``extra`` keys."""
    returned = {k for _, _, keys, _ in PATHS for k in keys}
    assert returned - {"headline_ips"} | {"native_high_b64_device_ips_busy"} == set(
        bench.EXTRA_KEYS)


def test_time_calls_counts_units_over_the_total_time():
    calls = []
    rate, ms = bench.time_calls(lambda: calls.append(1), per_call=10, warmup=2, iters=3,
                                device="cpu")
    assert len(calls) == 5 and len(ms) == 3
    assert rate == pytest.approx(30 / (sum(ms) / 1e3))


@pytest.mark.parametrize("flops,bytes_,dtype,want", [
    (67e12 * 0.5, 1.0, "f32", "compute"),      # half the f32 peak
    (1.0, 3.35e12 * 0.5, "bf16", "hbm"),       # half the bandwidth
    (67e12 * 0.1, 3.35e12 * 0.1, "f32", "other"),
])
def test_roofline_entry_bound(flops, bytes_, dtype, want):
    e = bench.roofline_entry(flops, bytes_, 1.0, dtype)
    assert e["bound"] == want
    assert e["pct_compute_peak"] == pytest.approx(100 * flops / bench.PEAK_OPS[dtype])
    assert e["pct_hbm_peak"] == pytest.approx(100 * bytes_ / bench.HBM_BYTES_PER_S)


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 8, 3), (1, 1, 3)])
def test_bmp_round_trip(shape, tmp_path):
    import cv2

    x = np.random.RandomState(5).randint(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(decode_bmp(bmp_bytes(x)), x)
    path = str(tmp_path / "x.bmp")
    write_bmp(path, x)
    np.testing.assert_array_equal(cv2.imread(path)[:, :, ::-1], x)
    np.testing.assert_array_equal(read_bmp(path), x)
    assert decode_bmp(b"not a bmp") is None


def test_synthetic_album_structure(tmp_path):
    """bench.py's album: sizes in turn, every 4th photo noise, the others
    one base photo with jitter, one clip of rolled frames."""
    sizes = ((64, 48), (40, 30))
    n, n_videos, clips = synthetic_album(str(tmp_path), 5, 3, sizes=sizes)
    assert (n, n_videos) == (5, 1) and set(clips) == {"clip.mp4"}
    photos = [read_bmp(str(tmp_path / f"photo_{i:03d}.bmp")) for i in range(n)]
    assert [p.shape[:2] for p in photos] == [(48, 64), (30, 40)] * 2 + [(48, 64)]
    # photos 0 and 4 share a size: the same base under ±12 jitter
    assert np.abs(photos[0].astype(int) - photos[4].astype(int)).max() <= 24
    frames = clips["clip.mp4"]
    assert len(frames) == 3 and frames[0].shape == (480, 640, 3)
    np.testing.assert_array_equal(frames[2], np.roll(frames[0], 4, axis=1))
    assert (tmp_path / "clip.mp4").exists() and ALBUM_SIZES[0] == (1024, 768)


def test_cpu_baseline_is_measured_once_then_read_from_its_cache(mh_params, tmp_path):
    cache = tmp_path / "baseline.json"
    ips = bench.measure_cpu_baseline(mh_params, cache)
    assert ips > 0 and json.loads(cache.read_text()) == {"images_per_sec": ips}
    cache.write_text(json.dumps({"images_per_sec": 1.5}))
    assert bench.measure_cpu_baseline(mh_params, cache) == 1.5


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal needs a machine "
                    "without a CUDA device")
def test_main_refuses_without_a_card(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert "no CUDA device" in str(e.value)
    assert capsys.readouterr().out == ""
    r = subprocess.run([sys.executable, "-m", "hse_facerec_torch.bench", "--quick"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device" in r.stderr
    assert not any(c.isdigit() for c in r.stdout)

