"""The serving slice of the PyTorch port: the batching worker, the HTTP
endpoints over a real socket, the gallery behind them, ``build_server``,
the CLI's face-mode ``enroll``, and the repairs the server needs (locked
launch counters, CUDA defaults).

Every test of the JAX package's ``tests/test_serve.py`` has a twin here
against the port, on the CPU (``device="cpu"``); the sharded gallery's is
in ``test_torch_parallel.py``. The parity tests put the same seeded
numpy weights behind a JAX handler and a port handler and send both the
same request bodies: ``/embed`` within ``atol=1e-4`` (as
``test_torch_identification.py``), ``/analyze`` boxes within 1 px (as
``test_torch_batch.py``), ``/identify`` labels equal and distances within
``rtol=1e-5`` (``atol=1e-6`` for near-duplicates); ``cli enroll`` (face
mode) writes the JAX CLI's gallery.
"""

import http.client
import json
import os
import sys
import threading
import time
from http.server import ThreadingHTTPServer

import cv2
import numpy as np
import pytest
import torch

from hse_facerec_torch.pipelines.analyzer import FaceResult
from hse_facerec_torch.pipelines.gallery import EnrollmentGallery
from hse_facerec_torch.serve import _BatchingWorker, make_handler


@pytest.fixture
def rng():
    return np.random.RandomState(12345)


class _FakeExtractor:
    def __init__(self):
        self.batch_sizes = []

    def extract_batch(self, imgs):
        self.batch_sizes.append(len(imgs))
        return imgs.reshape(len(imgs), -1)[:, :8].astype(np.float32)


def _serve(handler):
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _png(img):
    return cv2.imencode(".png", img)[1].tobytes()


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


# ---------- the batching worker ----------

def test_batching_worker_coalesces(rng):
    ex = _FakeExtractor()
    worker = _BatchingWorker(ex.extract_batch, max_batch=8, max_wait_ms=500.0)
    imgs = [(rng.rand(16, 16, 3) * 255).astype(np.uint8) for _ in range(6)]
    results = [None] * 6

    def call(i):
        results[i] = worker.submit(imgs[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for i in range(6):
        np.testing.assert_allclose(results[i], imgs[i].reshape(-1)[:8])
    # concurrent submissions must have been coalesced into fewer calls
    assert max(ex.batch_sizes) > 1


def test_batching_worker_groups_by_shape_and_times_stages():
    """Mixed shapes in one batch go out as one call per shape, and every
    request leaves a queue_wait and an assemble sample, every call a
    process sample, in the shared timer."""
    from hse_facerec_torch.utils.profiling import StageTimer

    timer, shapes = StageTimer(), []

    def process(imgs):
        shapes.append(imgs.shape)
        return [im.reshape(-1)[:2] for im in imgs]

    worker = _BatchingWorker(process, max_batch=8, max_wait_ms=300.0,
                             name="w", timer=timer)
    imgs = [np.full((4, 4, 3), i, np.uint8) for i in range(3)] + [
        np.full((6, 4, 3), 9, np.uint8)]
    threads = [threading.Thread(target=worker.submit, args=(im, 10))
               for im in imgs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    # every request processed once, each call on one shape
    assert sum(s[0] for s in shapes) == 4
    assert sorted({s[1:] for s in shapes}) == [(4, 4, 3), (6, 4, 3)]
    stats = timer.stats()
    assert stats["w.queue_wait"]["count"] == stats["w.assemble"]["count"] == 4
    assert stats["w.process"]["count"] == len(shapes)


def test_analyze_pow2_padding():
    """Cross-request analyze batching pads lanes to powers of two so only a
    bounded set of lane counts reaches the analyzer per shape, and trims
    the results back."""
    from hse_facerec_torch.pipelines.analyzer import FacialAnalyzer
    from hse_facerec_torch.serve import _analyze_batch_pow2

    class FakeAnalyzer:
        # the real shared zero-pad + n_valid contract
        analyze_batch_padded = FacialAnalyzer.analyze_batch_padded
        _pad = FacialAnalyzer._pad

        def __init__(self):
            self.lane_counts = []

        def analyze_batch(self, imgs, n_valid=None):
            self.lane_counts.append(len(imgs))
            n = len(imgs) if n_valid is None else n_valid
            return [[("face", float(im.sum()))] for im in imgs[:n]]

    fa = FakeAnalyzer()
    for n, lanes in [(1, 1), (2, 2), (3, 4), (5, 8), (8, 8)]:
        imgs = np.arange(n, dtype=np.float32).reshape(n, 1, 1, 1) * np.ones(
            (n, 4, 4, 3), np.float32)
        out = _analyze_batch_pow2(fa, imgs)
        assert fa.lane_counts[-1] == lanes
        assert len(out) == n
        assert out[-1][0][1] == imgs[-1].sum()


@pytest.mark.parametrize("max_batch,cap", [
    (32, 64), (48, 64), (12, 64), (8, 64), (1, 64), (64, 64), (128, 64),
    (100, 48), (5, 4), (33, 64)])
def test_prewarm_buckets_cover_every_reachable_pad_shape(max_batch, cap):
    """--prewarm runs the exact bucket set the port's extract_batch padding
    can produce — including the NEXT pow2 above a non-pow2 max_batch —
    and the JAX package's set."""
    from hse_facerec_tf_tpu.serve import _prewarm_buckets as jax_buckets
    from hse_facerec_torch.pipelines.embedder import EmbeddingExtractor
    from hse_facerec_torch.serve import _prewarm_buckets

    seen = set()
    ex = EmbeddingExtractor(lambda p, x: x.reshape(len(x), -1)[:, :2], {},
                            (2, 2), normalization="none", batch_size=cap,
                            device="cpu")
    ex._forward = lambda chunk: (seen.add(len(chunk)),
                                 torch.zeros(len(chunk), 2))[1]
    for take in range(1, max_batch + 1):
        ex.extract_batch(np.zeros((take, 2, 2, 3), np.uint8))
    assert _prewarm_buckets(max_batch, cap) == sorted(seen)
    assert _prewarm_buckets(max_batch, cap) == jax_buckets(max_batch, cap)


# ---------- the endpoints ----------

def test_http_endpoints(rng):
    fake = _FakeExtractor()
    server, port = _serve(make_handler(_BatchingWorker(fake.extract_batch),
                                       analyze_worker=None, device="cpu"))
    try:
        status, body = _call(port, "GET", "/healthz")
        assert status == 200 and body == {"ok": True, "device": "cpu"}

        img = (rng.rand(20, 20, 3) * 255).astype(np.uint8)
        status, body = _call(port, "POST", "/embed", _png(img))
        assert status == 200 and len(body["embedding"]) == 8
        # the png holds BGR (cv2's order) and the decoder hands RGB on
        np.testing.assert_allclose(body["embedding"], img[..., ::-1].reshape(-1)[:8])

        assert _call(port, "POST", "/embed", b"not an image")[0] == 400
        assert _call(port, "POST", "/nope", _png(img))[0] == 404
        assert _call(port, "GET", "/nope")[0] == 404
        assert _call(port, "POST", "/analyze", _png(img))[0] == 503
        assert _call(port, "POST", "/embed?threshold=x", _png(img))[0] == 400

        status, stats = _call(port, "GET", "/stats")
        assert status == 200
        assert stats["embed"]["count"] == 1 and stats["embed"]["p95_ms"] >= 0

        # /profile: device kernels under torch.profiler; the CPU has none,
        # so 503 (no numbers are made up), 200 on the card
        status, prof = _call(port, "GET", "/profile")
        assert status in (200, 503)
        if status == 200:
            assert set(prof) == {"busy_ms", "top"}
    finally:
        server.shutdown()


def test_http_stats_split_the_embed_workers_process(rng):
    """With the handler's timer handed to a real extractor, ``/stats``
    keeps every key it had and splits the embed worker's ``process`` into
    the extractor's upload, launches and fetch, with its counters."""
    from hse_facerec_torch.pipelines.embedder import EmbeddingExtractor
    from hse_facerec_torch.utils.profiling import StageTimer

    timer = StageTimer()
    w = torch.from_numpy(rng.randn(20 * 20 * 3, 8).astype(np.float32))
    extractor = EmbeddingExtractor(lambda p, x: x.reshape(len(x), -1) @ p, w, (20, 20),
                                   normalization="none", device="cpu",
                                   convert=lambda p, dev: p.to(dev), timer=timer)
    server, port = _serve(make_handler(_BatchingWorker(extractor.extract_batch,
                                                       name="embed_worker", timer=timer),
                                       None, timer=timer, device="cpu"))
    try:
        img = (rng.rand(20, 20, 3) * 255).astype(np.uint8)
        assert _call(port, "POST", "/embed", _png(img))[0] == 200
        status, stats = _call(port, "GET", "/stats")
        assert status == 200
        for key in ("embed", "embed_worker.queue_wait", "embed_worker.assemble",
                    "embed_worker.process", "embed.call", "embed.upload", "embed.forward",
                    "embed.fetch"):
            assert stats[key]["count"] == 1 and stats[key]["p95_ms"] >= 0, key
        # one request padded to the bucket of 8 rows
        assert stats["embed.upload_bytes"] == {"total": 8 * 20 * 20 * 3}
        assert stats["embed.rows"] == {"total": 1}
        assert stats["embed.padded_rows"] == {"total": 7}
    finally:
        server.shutdown()


def test_http_custom_decoder(rng):
    """``make_handler(decode=...)`` replaces cv2 (the card's machine has
    none): the smoke posts raw BMP bodies through it."""
    img = (rng.rand(5, 6, 3) * 255).astype(np.uint8)
    decode = lambda data: img if data == b"raw" else None
    server, port = _serve(make_handler(_BatchingWorker(_FakeExtractor().extract_batch),
                                       None, decode=decode, device="cpu"))
    try:
        status, body = _call(port, "POST", "/embed", b"raw")
        assert status == 200
        np.testing.assert_allclose(body["embedding"], img.reshape(-1)[:8])
        assert _call(port, "POST", "/embed", _png(img))[0] == 400
    finally:
        server.shutdown()


def test_request_deadline_returns_504(rng):
    """A wedged device call must not hang the client: submit() raises
    TimeoutError at the deadline and the handler maps it to 504."""
    block = threading.Event()

    def stuck_process(imgs):
        block.wait(30)          # simulates a hung call on the card
        return [np.zeros(8, np.float32)] * len(imgs)

    worker = _BatchingWorker(stuck_process, max_batch=4, max_wait_ms=1.0)
    server, port = _serve(make_handler(worker, analyze_worker=None,
                                       request_timeout_s=0.5, device="cpu"))
    try:
        img = (rng.rand(16, 16, 3) * 255).astype(np.uint8)
        t0 = time.monotonic()
        status, body = _call(port, "POST", "/embed", _png(img))
        assert status == 504
        assert time.monotonic() - t0 < 5
        assert "within" in body["error"]
    finally:
        block.set()
        server.shutdown()


def test_abandoned_requests_dropped_after_recovery():
    """Requests that timed out while the card was wedged must NOT be
    processed once the worker recovers; ``pipeline_depth=1`` pins the
    strictly serial worker: only ONE request is in flight behind a wedge."""
    block = threading.Event()
    processed = []

    def process(imgs):
        block.wait(30)
        processed.append(len(imgs))
        return [im.reshape(-1)[:4] for im in imgs]

    worker = _BatchingWorker(process, max_batch=1, max_wait_ms=1.0,
                             pipeline_depth=1)
    imgs = [np.full((4, 4, 3), i, np.uint8) for i in range(3)]
    t0 = threading.Thread(target=lambda: worker.submit(imgs[0]), daemon=True)
    t0.start()
    time.sleep(0.2)
    with pytest.raises(TimeoutError):
        worker.submit(imgs[1], timeout_s=0.3)      # queued -> abandoned
    block.set()                                    # the card recovers
    out = worker.submit(imgs[2], timeout_s=10)     # live request succeeds
    np.testing.assert_array_equal(out, imgs[2].reshape(-1)[:4])
    t0.join(timeout=5)
    assert not t0.is_alive()
    assert len(processed) == 2


def test_abandoned_requests_dropped_pipelined():
    """Depth-2 pipelined worker: up to two requests are in flight behind a
    wedge, but requests still QUEUED when they time out are dropped."""
    block = threading.Event()
    processed = []

    def process(imgs):
        block.wait(30)
        processed.append(len(imgs))
        return [im.reshape(-1)[:4] for im in imgs]

    worker = _BatchingWorker(process, max_batch=1, max_wait_ms=1.0,
                             pipeline_depth=2)
    imgs = [np.full((4, 4, 3), i, np.uint8) for i in range(4)]
    threads = [threading.Thread(target=lambda i=i: worker.submit(imgs[i]),
                                daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    with pytest.raises(TimeoutError):
        worker.submit(imgs[2], timeout_s=0.3)      # QUEUED -> abandoned
    block.set()
    out = worker.submit(imgs[3], timeout_s=10)
    np.testing.assert_array_equal(out, imgs[3].reshape(-1)[:4])
    for t in threads:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in threads)
    assert len(processed) == 3


def test_worker_error_reaches_the_client(rng):
    """A failed batched call answers every request of its batch with 500."""
    def broken(imgs):
        raise RuntimeError("kernel exploded")

    server, port = _serve(make_handler(_BatchingWorker(broken), None, device="cpu"))
    try:
        status, body = _call(port, "POST", "/embed",
                             _png((rng.rand(8, 8, 3) * 255).astype(np.uint8)))
        assert status == 500 and "exploded" in body["error"]
    finally:
        server.shutdown()


# ---------- the gallery behind /enroll and /identify ----------

def test_enrollment_gallery_roundtrip(tmp_path, rng):
    """Enroll/identify/remove with persistence: the atomic .npz survives a
    reload, ranking is int8, the threshold gates the label but the nearest
    neighbor is always reported."""
    path = str(tmp_path / "gallery.npz")
    g = EnrollmentGallery(path=path, device="cpu")
    assert g.identify(rng.randn(16)) == (None, None, None)

    alice = rng.randn(16).astype(np.float32)
    bob = rng.randn(16).astype(np.float32)
    assert g.enroll("alice", alice) == 1
    assert g.enroll("bob", bob) == 2
    assert g.enroll("alice", alice + 0.01 * rng.randn(16)) == 3

    label, dist, nearest = g.identify(alice)
    assert label == "alice" and nearest == "alice" and dist < 0.05
    assert g.identify(bob + 0.01 * rng.randn(16))[0] == "bob"
    label, dist, nearest = g.identify(rng.randn(16), threshold=0.2)
    assert label is None and dist > 0.2 and nearest in ("alice", "bob")

    g2 = EnrollmentGallery(path=path, device="cpu")
    assert len(g2) == 3
    assert g2.identify(alice)[0] == "alice"
    assert g2.stats()["n_labels"] == 2

    assert g2.remove("alice") == 2
    assert g2.identify(alice, threshold=10.0)[0] == "bob"
    assert len(EnrollmentGallery(path=path, device="cpu")) == 1

    with pytest.raises(ValueError):
        g2.enroll("carol", rng.randn(8))        # dim mismatch
    with pytest.raises(ValueError):
        g2.enroll("", rng.randn(16))


def test_http_enroll_identify(tmp_path, rng):
    """/enroll -> /gallery -> /identify (match + below-threshold null) ->
    DELETE /enroll, over a real socket."""
    fake = _FakeExtractor()
    gallery = EnrollmentGallery(path=str(tmp_path / "g.npz"), device="cpu")
    server, port = _serve(make_handler(_BatchingWorker(fake.extract_batch),
                                       analyze_worker=None, gallery=gallery,
                                       identify_threshold=0.5, device="cpu"))
    try:
        img_a = np.full((16, 16, 3), 200, np.uint8)
        img_b = np.zeros((16, 16, 3), np.uint8)
        img_b[0, :4] = 255
        enc_a, enc_b = _png(img_a), _png(img_b)

        assert _call(port, "POST", "/enroll", enc_a)[0] == 400   # label required
        assert _call(port, "POST", "/enroll?label=alice", enc_a) == (
            200, {"label": "alice", "n_enrolled": 1})
        assert _call(port, "POST", "/enroll?label=bob", enc_b)[1]["n_enrolled"] == 2

        stats = _call(port, "GET", "/gallery")[1]
        assert stats["n_enrolled"] == 2 and stats["n_labels"] == 2

        r = _call(port, "POST", "/identify", enc_a)[1]
        assert r["label"] == "alice" and r["distance"] < 0.05
        r = _call(port, "POST", "/identify?threshold=-1", enc_a)[1]
        assert r["label"] is None and r["nearest"] == "alice"

        assert _call(port, "DELETE", "/enroll")[0] == 400
        assert _call(port, "DELETE", "/nope")[0] == 404
        assert _call(port, "DELETE", "/enroll?label=alice")[1]["removed"] == 1
        assert _call(port, "POST", "/identify", enc_a)[1]["label"] != "alice"

        stats = _call(port, "GET", "/stats")[1]
        assert stats["enroll"]["count"] == 2
        assert stats["identify"]["count"] == 3
    finally:
        server.shutdown()


def test_http_identify_empty_gallery(rng):
    server, port = _serve(make_handler(_BatchingWorker(_FakeExtractor().extract_batch),
                                       None, device="cpu"))
    try:
        status, body = _call(port, "POST", "/identify",
                             _png(np.zeros((8, 8, 3), np.uint8)))
        assert status == 200 and body["label"] is None and body["note"]
    finally:
        server.shutdown()


def _face(x1, y1, x2, y2, ident):
    return FaceResult(bbox=(x1, y1, x2, y2), raw_bbox=(x1, y1, x2, y2),
                      score=0.99, age=30.0, gender_prob=0.9,
                      identity=np.asarray(ident, np.float32),
                      landmarks=np.zeros(10, np.float32))


def test_http_face_mode_and_analyze_identify(rng):
    """/enroll and /identify default to the LARGEST detected face's
    identity when the analyzer runs; /analyze?identify=1 labels every face
    against the gallery; no-face probes are 422."""
    e1 = rng.randn(16).astype(np.float32)      # big face's identity
    e2 = rng.randn(16).astype(np.float32)      # small face's identity

    def fake_analyze(imgs):
        return [[] if im[0, 0, 0] == 255 else
                [_face(0, 0, 8, 8, e2), _face(0, 0, 60, 60, e1)] for im in imgs]

    def extract16(imgs):
        return imgs.reshape(len(imgs), -1)[:, :16].astype(np.float32)

    gallery = EnrollmentGallery(device="cpu")
    server, port = _serve(make_handler(
        _BatchingWorker(extract16), _BatchingWorker(fake_analyze, max_batch=4),
        gallery=gallery, identify_threshold=0.5, device="cpu"))
    try:
        enc = _png(np.full((64, 64, 3), 100, np.uint8))
        enc_nf = _png(np.full((64, 64, 3), 255, np.uint8))

        assert _call(port, "POST", "/enroll?label=alice", enc)[1]["n_enrolled"] == 1
        label, dist, _ = gallery.identify(e1 / np.linalg.norm(e1))
        assert label == "alice" and dist < 0.05

        r = _call(port, "POST", "/identify", enc)[1]
        assert r["label"] == "alice" and r["distance"] < 0.05

        assert _call(port, "POST", "/enroll?label=bob", enc_nf)[0] == 422
        assert _call(port, "POST", "/identify", enc_nf)[0] == 422
        assert _call(port, "POST", "/identify?mode=image", enc_nf)[0] == 200
        assert _call(port, "POST", "/identify?mode=sideways", enc)[0] == 400

        faces = _call(port, "POST", "/analyze?identify=1", enc)[1]["faces"]
        assert len(faces) == 2
        by_label = {f["label"]: f for f in faces}
        assert by_label[None]["nearest"] == "alice"
        assert by_label["alice"]["distance"] < 0.05
        faces = _call(port, "POST", "/analyze", enc)[1]["faces"]
        assert "label" not in faces[0]
    finally:
        server.shutdown()


def test_face_mode_needs_the_analyzer(rng):
    server, port = _serve(make_handler(_BatchingWorker(_FakeExtractor().extract_batch),
                                       None, device="cpu"))
    try:
        status, body = _call(port, "POST", "/identify?mode=face",
                             _png(np.zeros((8, 8, 3), np.uint8)))
        assert status == 400 and "analyzer" in body["error"]
    finally:
        server.shutdown()


def test_gallery_identify_many_batches(rng, monkeypatch):
    """identify_many ranks all probes in ONE call and matches per-probe
    identify (labels and nearest exactly, distances to quantization
    noise), including the empty-gallery and empty-probe edges."""
    from hse_facerec_torch.pipelines import gallery as gal_mod

    g = EnrollmentGallery(device="cpu")
    probes = rng.randn(5, 32).astype(np.float32)
    assert g.identify_many(probes) == [(None, None, None)] * 5
    for i in range(8):
        g.enroll(f"p{i % 4}", rng.randn(32))

    calls = []
    orig = gal_mod.nearest_neighbor_int8p

    def counting(p, *a, **kw):
        calls.append(len(p))
        return orig(p, *a, **kw)

    monkeypatch.setattr(gal_mod, "nearest_neighbor_int8p", counting)
    many = g.identify_many(probes, threshold=0.9)
    assert calls == [5]
    singles = [g.identify(p, threshold=0.9) for p in probes]
    for (l1, d1, n1), (l2, d2, n2) in zip(many, singles):
        assert (l1, n1) == (l2, n2)
        assert abs(d1 - d2) < 5e-3
    assert g.identify_many(np.zeros((0, 32), np.float32)) == []
    with pytest.raises(ValueError):
        g.identify_many(probes[:, :8])


def test_gallery_enroll_many(tmp_path, rng, monkeypatch):
    """Bulk enrollment appends everything under one lock, persists ONCE,
    and validates labels/dims like per-item enroll."""
    from hse_facerec_torch.pipelines import gallery as gal_mod

    path = str(tmp_path / "g.npz")
    g = gal_mod.EnrollmentGallery(path=path, device="cpu")
    g.enroll("seed", rng.randn(16))

    saves = []
    orig = gal_mod.EnrollmentGallery._save_locked
    monkeypatch.setattr(gal_mod.EnrollmentGallery, "_save_locked",
                        lambda self: (saves.append(1), orig(self)))
    n = g.enroll_many(["alice", "bob", "alice"], rng.randn(3, 16).astype(np.float32))
    assert n == 4 and saves == [1]
    assert len(gal_mod.EnrollmentGallery(path=path, device="cpu")) == 4
    assert g.stats()["n_labels"] == 3
    assert g.identify(np.asarray(g._feats[1]) * 3.0)[0] == "alice"

    with pytest.raises(ValueError):
        g.enroll_many(["x"], rng.randn(1, 8))          # dim mismatch
    with pytest.raises(ValueError):
        g.enroll_many(["x", ""], rng.randn(2, 16))     # empty label
    with pytest.raises(ValueError):
        g.enroll_many(["x"], rng.randn(2, 16))         # count mismatch
    assert len(g) == 4                                 # nothing partial


def test_gallery_replace_atomic(tmp_path, rng, monkeypatch):
    """enroll_many(replace_labels=...) swaps rows in ONE update: failed
    validation leaves memory and disk untouched, the swap persists in a
    single save, and replacing every row may change the dim."""
    from hse_facerec_torch.pipelines import gallery as gal_mod

    path = str(tmp_path / "g.npz")
    g = gal_mod.EnrollmentGallery(path=path, device="cpu")
    alice_old = rng.randn(16).astype(np.float32)
    g.enroll("alice", alice_old)
    g.enroll("bob", rng.randn(16))
    with pytest.raises(ValueError):
        g.enroll_many(["alice"], rng.randn(1, 8), replace_labels=["alice"])
    assert len(g) == 2 and g.identify(alice_old)[0] == "alice"
    assert len(gal_mod.EnrollmentGallery(path=path, device="cpu")) == 2

    saves = []
    orig = gal_mod.EnrollmentGallery._save_locked
    monkeypatch.setattr(gal_mod.EnrollmentGallery, "_save_locked",
                        lambda self: (saves.append(1), orig(self)))
    alice_new = rng.randn(2, 16).astype(np.float32)
    assert g.enroll_many(["alice", "alice"], alice_new, replace_labels=["alice"]) == 3
    assert saves == [1]
    assert g.identify(alice_new[0])[0] == "alice"
    assert g.identify(alice_old, threshold=10.0)[1] > 0.1

    assert g.enroll_many(["x", "y"], rng.randn(2, 32).astype(np.float32),
                         replace_labels=["alice", "bob"]) == 2
    assert g.stats()["dim"] == 32
    assert g.enroll_many([], np.zeros((0, 0), np.float32), replace_labels=["x"]) == 1
    assert len(gal_mod.EnrollmentGallery(path=path, device="cpu")) == 1


def test_gallery_ranking_mode_persists(tmp_path, rng):
    """--exact galleries stay f32 when reloaded without arguments; an
    explicit bool wins; fresh and legacy files rank int8."""
    path = str(tmp_path / "g.npz")
    g = EnrollmentGallery(path=path, quantized=False, device="cpu")
    g.enroll("a", rng.randn(16))
    assert EnrollmentGallery(path=path, device="cpu").quantized is False
    assert EnrollmentGallery(path=path, quantized=True, device="cpu").quantized is True
    assert EnrollmentGallery(device="cpu").quantized is True
    data = dict(np.load(path, allow_pickle=False))
    data.pop("ranking")
    np.savez(path, **data)
    assert EnrollmentGallery(path=path, device="cpu").quantized is True


def test_identify_honors_request_deadline(rng):
    """A wedged ranking call returns 504 within the request deadline."""
    block = threading.Event()

    class WedgedGallery:
        def identify(self, emb, threshold=0.82):
            block.wait(30)
            return ("x", 0.1, "x")

        def identify_many(self, embs, threshold=0.82):
            return [self.identify(e) for e in embs]

        def enroll(self, label, emb):
            return 1

        def stats(self):
            return {}

        def __len__(self):
            return 1

    server, port = _serve(make_handler(
        _BatchingWorker(_FakeExtractor().extract_batch), analyze_worker=None,
        request_timeout_s=0.5, gallery=WedgedGallery(), device="cpu"))
    try:
        t0 = time.monotonic()
        status, body = _call(port, "POST", "/identify?mode=image",
                             _png((rng.rand(16, 16, 3) * 255).astype(np.uint8)))
        assert status == 504 and time.monotonic() - t0 < 5
        assert "within" in body["error"]
    finally:
        block.set()
        server.shutdown()


# ---------- build_server and main ----------

def _fake_build(monkeypatch, seen):
    class FakeExtractor:
        input_size = (224, 224)
        batch_size = 64

        def extract_batch(self, imgs):
            seen.setdefault("prewarm", []).append(len(imgs))
            return imgs.reshape(len(imgs), -1)[:, :4]

    def fake_build_extractor(model, device="cuda", mesh=None, **kw):
        seen["extractor"] = (model, device)
        seen["extractor_mesh"] = mesh
        seen["extractor_timer"] = kw.get("timer")
        return FakeExtractor()

    class FakeAnalyzer:
        @classmethod
        def from_reference_models(cls, mtcnn_pb, agegender_pb, device="cuda",
                                  mesh=None, **kw):
            seen["analyzer"] = device
            seen["analyzer_mesh"] = mesh
            return cls()

    class FakeGallery:
        def __init__(self, path=None, device="cuda", mesh=None, **kw):
            seen["gallery"] = (path, device)
            seen["gallery_mesh"] = mesh

    monkeypatch.setattr("hse_facerec_torch.models.zoo.build_extractor",
                        fake_build_extractor)
    monkeypatch.setattr("hse_facerec_torch.pipelines.analyzer.FacialAnalyzer",
                        FakeAnalyzer)
    monkeypatch.setattr("hse_facerec_torch.pipelines.gallery.EnrollmentGallery",
                        FakeGallery)


def test_build_server_wiring(monkeypatch, tmp_path, capsys):
    """build_server wires the zoo model, the analyzer and the gallery on
    one device; --prewarm runs every embed bucket; --data-parallel is
    ignored on one card (the JAX package's message) and on several builds
    one mesh from ``parallel.sharding.make_mesh`` for all three."""
    import hse_facerec_torch.serve as serve_mod

    seen = {}
    _fake_build(monkeypatch, seen)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    srv = serve_mod.build_server(port=0, model="vgg2_mobilenet", max_batch=48,
                                 gallery_path=str(tmp_path / "g.npz"),
                                 data_parallel=True, prewarm=True, device="cpu")
    try:
        assert seen["extractor"] == ("vgg2_mobilenet", "cpu")
        assert seen["analyzer"] == "cpu"
        assert seen["gallery"] == (str(tmp_path / "g.npz"), "cpu")
        assert seen["prewarm"] == serve_mod._prewarm_buckets(48, 64) == [8, 16, 32, 64]
        assert "--data-parallel ignored (single device)" in capsys.readouterr().out
        assert seen["extractor_mesh"] is seen["analyzer_mesh"] is seen["gallery_mesh"] is None
        # the extractor's spans go to the timer behind GET /stats
        from hse_facerec_torch.utils.profiling import StageTimer

        assert isinstance(seen["extractor_timer"], StageTimer)
    finally:
        srv.server_close()

    seen.clear()
    srv = serve_mod.build_server(port=0, with_analyzer=False, device="cpu")
    try:
        assert "analyzer" not in seen and "prewarm" not in seen
    finally:
        srv.server_close()

    from hse_facerec_torch.parallel.sharding import make_mesh

    mesh = make_mesh(devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr("hse_facerec_torch.parallel.sharding.make_mesh", lambda: mesh)
    seen.clear()
    srv = serve_mod.build_server(port=0, data_parallel=True, device="cpu")
    try:
        assert seen["extractor_mesh"] is seen["analyzer_mesh"] is seen["gallery_mesh"] is mesh
        assert "ignored" not in capsys.readouterr().out
    finally:
        srv.server_close()


def test_build_server_serves_bmp_bodies_on_given_weights():
    """``build_server`` as a machine without image codecs runs it: the
    float32 ``agegender_identity`` extractor on the weights handed in,
    prewarmed, BMP bodies decoded by ``testing.decode_bmp``. ``/embed``
    answers the extractor's own embedding of the image, and ``/stats``
    counts the request and not the prewarm's calls."""
    import hse_facerec_torch.serve as serve_mod
    from hse_facerec_torch.models import zoo
    from hse_facerec_torch.testing import bmp_bytes, decode_bmp, random_multihead_params

    params = random_multihead_params(np.random.RandomState(100))
    img = np.random.RandomState(0).randint(0, 255, (32, 32, 3), np.uint8)
    srv = serve_mod.build_server(port=0, host="127.0.0.1", model="agegender_identity",
                                 max_batch=8, with_analyzer=False, prewarm=True,
                                 device="cpu", params=params, decode=decode_bmp)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        port = srv.server_address[1]
        status, body = _call(port, "POST", "/embed", bmp_bytes(img))
        assert status == 200
        assert _call(port, "POST", "/embed", _png(img))[0] == 400
        status, stats = _call(port, "GET", "/stats")
        assert status == 200
        for key in ("embed_worker.queue_wait", "embed_worker.assemble",
                    "embed_worker.process"):
            assert stats[key]["count"] == 1, key
    finally:
        srv.shutdown()
        srv.server_close()
    want = zoo.build_extractor("agegender_identity", device="cpu",
                               params=params).extract_batch(img[None])[0]
    np.testing.assert_allclose(body["embedding"], want, rtol=0, atol=1e-6)


def test_build_server_defaults_to_cuda():
    import hse_facerec_torch.serve as serve_mod

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_mod.make_handler(None, None)


@pytest.mark.parametrize("args", [["-m", "hse_facerec_torch.serve", "--help"],
                                  ["-m", "hse_facerec_torch.cli", "enroll", "--help"]])
def test_entry_points_help(args):
    import subprocess

    out = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout
    if "enroll" in args:
        assert "{face,image}" in out.stdout


# ---------- the repairs ----------

def test_cuda_defaults_raise_without_a_card():
    """``fused_distance_matrix`` and ``init_mobilenet_params`` default to
    CUDA like every entry point of the port: here, with no card, they
    raise ``resolve_device``'s error instead of running on the CPU."""
    import time as _time

    from hse_facerec_torch.models.mobilenet import init_mobilenet_params
    from hse_facerec_torch.pipelines.album import fused_distance_matrix

    feats = np.eye(3, 8, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused_distance_matrix(feats, np.full(3, 1990.0), [0, 0, 0],
                              [_time.gmtime(0)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_mobilenet_params(torch.Generator().manual_seed(0))
    assert fused_distance_matrix(feats, np.full(3, 1990.0), [0, 0, 0],
                                 [_time.gmtime(0)], device="cpu").shape == (3, 3)


@pytest.mark.parametrize("wrapper", ["nearest_neighbor_f32", "nearest_neighbor_int8q",
                                     "nearest_neighbor_int8p", "pw_conv_int8",
                                     "crop_resize", "warp_batch"])
def test_launch_counters_count_under_a_lock(wrapper, monkeypatch):
    """Two threads counting 10,000 launches each reach exactly 20,000 (the
    server's threads launch K2 and K4 at once); the switch interval is cut
    so a lost update would show."""
    from hse_facerec_torch.ops.kernels import build, crop, knn, pw_conv, warp

    module = next(m for m in (knn, pw_conv, crop, warp) if hasattr(m, wrapper))
    fn = getattr(module, wrapper)
    monkeypatch.setattr(fn, "launches", 0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [build.count_launch(fn)
                                                    for _ in range(10_000)])
                   for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == 20_000


def test_kernel_library_builds_once(monkeypatch, tmp_path):
    """Threads that need the kernels at the same moment wait for one
    build instead of each running nvcc."""
    from hse_facerec_torch.ops.kernels import build

    builds = []
    gate = threading.Event()

    def fake_build(lib_path):
        builds.append(lib_path)
        gate.wait(5)
        raise RuntimeError("no nvcc here")

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build, "library_path", lambda: tmp_path / "lib.so")
    build._load.cache_clear()
    errors = []

    def load():
        try:
            build.load_library()
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=load) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    assert len(builds) == 1          # the others wait on the lock
    gate.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(errors) == 4
    build._load.cache_clear()


# ---------- cli enroll, face mode ----------

def test_cli_enroll_face_mode_batches_and_retries(tmp_path, rng, monkeypatch, capsys):
    """`cli enroll` (face mode, the default) walks a people tree with
    same-shape photos fused into one pow2-padded batch-path call, embeds
    the LARGEST face per photo, rotation-retries then skips no-face photos,
    and --replace swaps a person's rows while keeping persons whose new
    photos all failed detection (JAX ``tests/test_serve.py::
    test_cli_enroll_face_mode`` on the port)."""
    from hse_facerec_torch import cli

    people = tmp_path / "people"
    vecs = {10: rng.randn(16).astype(np.float32), 20: rng.randn(16).astype(np.float32)}
    pixel = {"Alice/Smith": 10, "bob": 20}   # '/' must be sanitized later
    for name, n_imgs in [("Alice/Smith", 2), ("bob", 1)]:
        d = people / name.replace("/", "_")
        d.mkdir(parents=True)
        for i in range(n_imgs):
            cv2.imwrite(str(d / f"{i}.png"), np.full((32, 32, 3), pixel[name], np.uint8))
    cv2.imwrite(str(people / "Alice_Smith" / "noface.png"), np.zeros((32, 32, 3), np.uint8))

    def face(vec, scale):
        s = int(10 * scale)
        return FaceResult(bbox=(0, 0, s, s), raw_bbox=(0, 0, s, s), score=0.99,
                          age=30.0, gender_prob=0.9, identity=vec * scale,
                          landmarks=np.zeros(10))

    class _StubAnalyzer:
        batch_calls, rotation_calls = [], []

        def analyze_batch_padded(self, imgs, lanes):
            _StubAnalyzer.batch_calls.append((len(imgs), lanes))
            return [[] if int(im[0, 0, 0]) == 0 else
                    [face(vecs[int(im[0, 0, 0])], 0.5), face(vecs[int(im[0, 0, 0])], 1.0)]
                    for im in imgs]

        def analyze(self, img):
            _StubAnalyzer.rotation_calls.append(int(img[0, 0, 0]))
            return []

    monkeypatch.setattr(cli, "_build_analyzer", lambda a: _StubAnalyzer())
    gpath = str(tmp_path / "gal.npz")
    cli.main(["enroll", str(people), gpath, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["n_added"] == 3 and out["n_people_added"] == 2
    assert out["skipped_no_face"] == [os.path.join("Alice_Smith", "noface.png")]
    assert _StubAnalyzer.batch_calls == [(4, 4)]
    assert _StubAnalyzer.rotation_calls == [0, 0]

    g = EnrollmentGallery(path=gpath, device="cpu")
    assert len(g) == 3 and g.stats()["n_labels"] == 2
    assert g.identify(vecs[10])[0] == "Alice_Smith"
    assert g.identify(vecs[20])[0] == "bob"

    g.enroll("Carol", rng.randn(16))
    (people / "Carol").mkdir()
    cv2.imwrite(str(people / "Carol" / "bad.png"), np.zeros((32, 32, 3), np.uint8))
    cli.main(["enroll", str(people), gpath, "--replace", "--device", "cpu"])
    captured = capsys.readouterr()
    assert "Carol" in captured.err and "kept" in captured.err
    g2 = EnrollmentGallery(path=gpath, device="cpu")
    assert len(g2) == 4
    assert g2.identify(np.asarray(g._feats[-1]) * 2.0)[0] == "Carol"


@pytest.fixture(scope="module")
def multihead_np():
    from hse_facerec_torch.testing import random_multihead_params

    return random_multihead_params(np.random.RandomState(100))


@pytest.fixture(scope="module")
def analyzer_pair(multihead_np):
    """(JAX, port) analyzers on the same seeded weights, the batch tests'
    "fits" setting (96x128 photos, minsize 20, 64² face crops)."""
    from .test_torch_batch import _pair

    return _pair("fits", multihead_np)


def test_cli_enroll_face_mode(tmp_path, analyzer_pair, monkeypatch, capsys):
    """`enroll` in face mode writes the JAX CLI's gallery from the same
    people tree and seeded weights: the same rows in the same order, the
    same skipped photos, identities within cosine 0.9999."""
    from hse_facerec_tf_tpu import cli as jcli
    from hse_facerec_torch import cli as tcli

    from .test_torch_analyzer import _photo

    jax_an, port_an = analyzer_pair
    people = tmp_path / "people"
    for person, seeds in (("ann", (2, 4)), ("bob", (3, 5))):
        (people / person).mkdir(parents=True)
        for s in seeds:
            cv2.imwrite(str(people / person / f"{s}.png"),
                        cv2.cvtColor(_photo(s), cv2.COLOR_RGB2BGR))
    cv2.imwrite(str(people / "bob" / "blank.png"), np.zeros((96, 128, 3), np.uint8))
    monkeypatch.setattr(jcli, "_build_analyzer", lambda a: jax_an)
    monkeypatch.setattr(tcli, "_build_analyzer", lambda a: port_an)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jcli.main(["enroll", str(people), jpath])
    want = json.loads(capsys.readouterr().out)
    tcli.main(["enroll", str(people), tpath, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert {k: v for k, v in got.items() if k != "gallery"} == {
        k: v for k, v in want.items() if k != "gallery"}
    assert got["skipped_no_face"] == [os.path.join("bob", "blank.png")]
    assert got["n_added"] >= 3
    g, w = np.load(tpath), np.load(jpath)
    assert list(g["labels"]) == list(w["labels"]) and str(g["ranking"]) == "int8"
    cos = np.sum(g["features"] * w["features"], 1)     # rows are unit length
    assert cos.min() > 0.9999


class _Recording:
    """A gallery whose ranking answers are kept unrounded (the JSON rounds
    distances to 4 decimals)."""

    def __init__(self, gallery):
        self.gallery, self.answers = gallery, []

    def identify(self, emb, threshold=0.82):
        out = self.gallery.identify(emb, threshold=threshold)
        self.answers.append(out)
        return out

    def identify_many(self, embs, threshold=0.82):
        out = self.gallery.identify_many(embs, threshold=threshold)
        self.answers.extend(out)
        return out

    def __getattr__(self, name):
        return getattr(self.gallery, name)

    def __len__(self):
        return len(self.gallery)


def test_handler_matches_jax(analyzer_pair, multihead_np):
    """The same seeded weights behind a JAX handler and a port handler, the
    same bodies to both: /enroll, /embed within atol 1e-4, /analyze boxes
    within 1 px (ages and P(male) within the batch tests' bounds plus the
    JSON's rounding), /identify and /analyze?identify=1 labels equal and
    the unrounded distances within rtol 1e-5 (atol 1e-6)."""
    import functools

    from hse_facerec_tf_tpu import serve as jserve
    from hse_facerec_tf_tpu.models import zoo as jzoo
    from hse_facerec_tf_tpu.pipelines.embedder import EmbeddingExtractor as JaxExtractor
    from hse_facerec_tf_tpu.pipelines.gallery import EnrollmentGallery as JaxGallery
    from hse_facerec_torch import serve as tserve
    from hse_facerec_torch.models import zoo as tzoo
    from hse_facerec_torch.pipelines.embedder import EmbeddingExtractor

    from .test_torch_analyzer import _photo

    jax_an, port_an = analyzer_pair
    kw = dict(normalization="caffe", resize_method="cv2_linear", batch_size=8)
    jex = JaxExtractor(jzoo.MODEL_ZOO["agegender_identity"].model_fn(), multihead_np,
                       (64, 64), **kw)
    tex = EmbeddingExtractor(tzoo.MODEL_ZOO["agegender_identity"].model_fn(),
                             multihead_np, (64, 64), device="cpu", **kw)
    galleries = {"jax": _Recording(JaxGallery()),
                 "port": _Recording(EnrollmentGallery(device="cpu"))}
    servers = {
        "jax": _serve(jserve.make_handler(
            jserve._BatchingWorker(jex.extract_batch),
            jserve._BatchingWorker(functools.partial(jserve._analyze_batch_pow2, jax_an),
                                   max_batch=8), gallery=galleries["jax"])),
        "port": _serve(tserve.make_handler(
            tserve._BatchingWorker(tex.extract_batch),
            tserve._BatchingWorker(functools.partial(tserve._analyze_batch_pow2, port_an),
                                   max_batch=8), gallery=galleries["port"], device="cpu"))}
    photos = {s: _png(cv2.cvtColor(_photo(s), cv2.COLOR_RGB2BGR)) for s in (2, 3, 4, 5)}
    requests = ([("POST", f"/enroll?label=p{s}", photos[s]) for s in (2, 3)]
                + [("POST", "/embed", photos[s]) for s in (2, 5)]
                + [("POST", "/analyze?identify=1", photos[s]) for s in (2, 4)]
                + [("POST", f"/identify{q}", photos[s]) for s in (2, 4, 5)
                   for q in ("", "?mode=image")])
    try:
        answers = {name: [_call(port, *r) for r in requests]
                   for name, (_, port) in servers.items()}
    finally:
        for server, _ in servers.values():
            server.shutdown()
    n_faces = 0
    for (method, path, _), (gs, got), (ws, want) in zip(requests, answers["port"],
                                                          answers["jax"]):
        assert gs == ws == 200, (path, got, want)
        if path == "/embed":
            np.testing.assert_allclose(got["embedding"], want["embedding"],
                                       atol=1e-4, rtol=0)
        elif path.startswith("/analyze"):
            assert len(got["faces"]) == len(want["faces"])
            for g, w in zip(got["faces"], want["faces"]):
                np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1.0)
                assert abs(g["age"] - w["age"]) <= 0.1 + 1e-3
                assert abs(g["gender_prob"] - w["gender_prob"]) <= 1e-4 + 1e-4
                assert (g["label"], g["nearest"]) == (w["label"], w["nearest"])
                n_faces += 1
        elif path.startswith("/identify"):
            assert (got["label"], got["nearest"]) == (want["label"], want["nearest"])
        else:
            assert got == want
    assert n_faces >= 2
    g_ans, w_ans = galleries["port"].answers, galleries["jax"].answers
    assert len(g_ans) == len(w_ans) >= 8
    assert [(a[0], a[2]) for a in g_ans] == [(a[0], a[2]) for a in w_ans]
    # rtol 1e-5; the squared distance of two unit vectors is a difference
    # of terms near 1 in float32 (absolute error ~1e-7), so a near-duplicate
    # at distance d moves by ~1e-7/d: 1e-6 absolute covers d down to 0.01
    np.testing.assert_allclose([a[1] for a in g_ans], [a[1] for a in w_ans],
                               rtol=1e-5, atol=1e-6)
