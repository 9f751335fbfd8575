"""The port's multi-device layer against the JAX package's mesh functions.

The port's mesh repeats the CPU (``make_mesh(devices=["cpu"] * n)``: n
virtual shards run one after another), the JAX package's is the 8 virtual
XLA CPU devices of ``tests/conftest.py``. Inputs come from numpy seeds and
weights through ``params.to_torch``. Required:
- the sharded 1-NN: indices equal to the JAX package's and to a float64
  host argmin, ties across shards to the lowest global index, int8
  distances bit-equal to the port's single-device K2b plain version and
  within an ulp of JAX's, f32 distances within 1e-5 relative, past f32's
  cancellation (1e-6 of the operands' squared norms), of the port's
  single-device sweep, JAX's and the host's (with 1, 2, 4 and 8 shards;
  galleries of 19 and 13 rows over 8, so shards are padded);
- ``KNNIdentifier(mesh)``: the JAX package's labels;
- ``EnrollmentGallery(mesh)``: the single-device store's labels, squared
  distances within 1e-6 (the reported distance is their square root: at an
  exact hit f32 cancellation leaves ~2e-7, i.e. ~5e-4 after the root, in
  either layout), and one placement per gallery version;
- ``EmbeddingExtractor(mesh)``: the JAX package's mesh extractor within
  1e-4, the port's single-device one within 1e-5, input order kept;
- mesh ``analyze_batch``: the JAX package's mesh analyzer and the port's
  single-device analyzer: boxes equal, ages and identity within 1e-3
  (``__graft_entry__.py:194-198``), one compacted program per shard with
  the per-shard head budget;
- the album scan with a mesh analyzer, and the server's handler with a mesh
  extractor, analyzer and gallery: the single-device answers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from hse_facerec_tf_tpu.parallel import knn as jknn
from hse_facerec_tf_tpu.parallel import sharding as jsharding
from hse_facerec_tf_tpu.pipelines.analyzer import FacialAnalyzer as JaxAnalyzer
from hse_facerec_tf_tpu.pipelines.heads import MultiheadHeads as JaxHeads
from hse_facerec_tf_tpu.pipelines.identification import KNNIdentifier as JaxIdentifier
from hse_facerec_torch.ops.kernels import knn as tk
from hse_facerec_torch.parallel import knn as pknn
from hse_facerec_torch.parallel import sharding as ps
from hse_facerec_torch.pipelines.analyzer import FacialAnalyzer
from hse_facerec_torch.pipelines.gallery import EnrollmentGallery
from hse_facerec_torch.pipelines.identification import KNNIdentifier
from hse_facerec_torch.testing import random_mtcnn_params, random_multihead_params

from .test_torch_analyzer import CASES, H, W, _photo
from .test_torch_batch import _assert_same_batches

SHARDS = [1, 2, 4, 8]
HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the shards run many small ops one after another,
    which a thread team on cores that other test workers share slows down
    many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(n, shape=None, names=("data",)):
    return ps.make_mesh(shape, names, ["cpu"] * n)


def _jax_mesh(n):
    return JaxMesh(np.asarray(jax.devices()[:n]), ("data",))


# ---------- sharding ----------

def test_make_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ps.make_mesh(devices=["cuda"] * 2)
    with pytest.raises(ValueError, match="needs 8 devices"):
        ps.make_mesh((4, 2), ("data", "model"), ["cpu"] * 4)


def test_mesh_layout_and_shard_devices():
    mesh = ps.make_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh.devices.shape == (4, 2) and mesh.distinct_devices == [torch.device("cpu")]
    assert len(mesh.shard_devices("data")) == 4
    assert len(mesh.shard_devices("model")) == 2
    assert len(mesh.shard_devices()) == 8
    with pytest.raises(ValueError, match="not in mesh axes"):
        mesh.shard_devices("pipe")
    assert ps.make_mesh(devices=["cpu"] * 3).shape == {"data": 3}


def test_replicate_places_once_per_distinct_device_and_caches():
    mesh = _mesh(4)
    tree = {"w": torch.ones(3), "b": [torch.zeros(2)]}
    calls = []
    place = lambda t, d: calls.append(d) or ps.to_device(t, d)
    first = mesh.replicate(tree, place)
    assert mesh.replicate(tree, place) is first
    assert calls == [torch.device("cpu")] and list(first) == [torch.device("cpu")]
    assert first[torch.device("cpu")]["w"] is tree["w"]     # same device: no copy


def test_split_gather_sum_and_pad_match_the_reference():
    rng = np.random.RandomState(0)
    x = rng.rand(10, 3).astype(np.float32)
    got, n = ps.pad_batch(x, 4)
    want, wn = jsharding.pad_batch(x, 4)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert n == wn == 10 and len(got) == 12
    parts = ps.split_batch(got, _mesh(4).shard_devices())
    assert [p.shape[0] for p in parts] == [3] * 4
    np.testing.assert_array_equal(ps.gather(parts, "cpu").numpy(), got)
    with pytest.raises(ValueError, match="does not split"):
        ps.split_batch(x, _mesh(4).shard_devices())
    a, b = torch.ones(2, requires_grad=True), torch.full((2,), 2.0, requires_grad=True)
    total = ps.shard_sum([a * 3, b * b], "cpu").sum()
    ga, gb = torch.autograd.grad(total, [a, b])
    assert ga.tolist() == [3.0, 3.0] and gb.tolist() == [4.0, 4.0]


# ---------- the gallery-sharded 1-NN ----------

def _knn_data(n_gallery, seed=0):
    rng = np.random.RandomState(seed)
    gallery = rng.randn(n_gallery, 16).astype(np.float32)
    random = rng.randn(7, 16).astype(np.float32)
    near = gallery[[0, 5, n_gallery - 1]] + 0.05 * rng.randn(3, 16).astype(np.float32)
    return np.concatenate([random, near]).astype(np.float32), gallery


def _host_argmin(p, g):
    d = ((p.astype(np.float64)[:, None] - g.astype(np.float64)[None]) ** 2).sum(-1)
    return d.argmin(1), d.min(1)


@pytest.mark.parametrize("n_gallery", [19, 13])
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_knn_f32_matches_jax_and_host(shards, n_gallery):
    p, g = _knn_data(n_gallery)
    jd, ji = jknn.nearest_neighbor_sharded(jnp.asarray(p), jnp.asarray(g), _jax_mesh(shards))
    d, i = pknn.nearest_neighbor_sharded(torch.from_numpy(p), torch.from_numpy(g),
                                         _mesh(shards))
    host_i, host_d = _host_argmin(p, g)
    single_d, single_i = tk.nearest_neighbor_auto(torch.from_numpy(p), torch.from_numpy(g))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), host_i)
    np.testing.assert_array_equal(i.numpy(), single_i.numpy())
    # the expanded form |p|² + |g|² - 2 p·g cancels in f32 near a hit (and
    # a shard's few rows take another matmul path): its error scales with
    # the operands' squared norms, not with the distance
    atol = 1e-6 * ((p.astype(np.float64) ** 2).sum(1).max()
                   + (g.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(d.numpy(), single_d.numpy(), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(d.numpy(), host_d, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("n_gallery", [19, 13])
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_knn_int8_matches_jax_and_single_device(shards, n_gallery):
    p, g = _knn_data(n_gallery, seed=1)
    jd, ji = jknn.nearest_neighbor_sharded(jnp.asarray(p), jnp.asarray(g),
                                           _jax_mesh(shards), int8=True)
    tk.nearest_neighbor_int8q.launches = 0
    d, i = pknn.nearest_neighbor_sharded(torch.from_numpy(p), torch.from_numpy(g),
                                         _mesh(shards), int8=True)
    want_d, want_i = tk.nearest_neighbor_int8_plain(
        torch.from_numpy(p), *tk.quantize_embeddings(torch.from_numpy(g)))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), want_i.numpy())
    np.testing.assert_array_equal(d.numpy(), want_d.numpy())
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)    # an ulp
    # the near-duplicate probes: the float64 argmin, through the quantization
    np.testing.assert_array_equal(i.numpy()[-3:], _host_argmin(p, g)[0][-3:])
    assert tk.nearest_neighbor_int8q.launches == 0      # the CPU runs the twin


@pytest.mark.parametrize("int8", [False, True])
def test_sharded_knn_ties_go_to_the_lowest_global_index(int8):
    """Exact duplicates of the probe's nearest row in shards 0, 2 and 3 of
    a 4-shard layout (integer rows: every distance is exact)."""
    rng = np.random.RandomState(3)
    g = rng.randint(-3, 4, (8, 8)).astype(np.float32)
    g[[5, 7]] = g[1]
    p = g[[1, 1]] + np.array([[0.0] * 8, [0.25] + [0.0] * 7], np.float32)
    jd, ji = jknn.nearest_neighbor_sharded(jnp.asarray(p), jnp.asarray(g), _jax_mesh(4),
                                           int8=int8)
    d, i = pknn.nearest_neighbor_sharded(torch.from_numpy(p), torch.from_numpy(g),
                                         _mesh(4), int8=int8)
    assert i.tolist() == [1, 1] == np.asarray(ji).tolist()
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_sharded_knn_prequantized_gallery_with_n_valid():
    p, g = _knn_data(13, seed=2)
    q, scale = tk.quantize_embeddings(torch.from_numpy(g))
    qp = torch.cat([q, torch.zeros((3, 16), dtype=torch.int8)])      # 16 rows over 8
    jq = jnp.asarray(qp.numpy())
    jd, ji = jknn.nearest_neighbor_sharded(jnp.asarray(p), (jq, jnp.asarray(scale.numpy())),
                                           _jax_mesh(8), int8=True, n_valid=13)
    placed = pknn.place_gallery((qp, scale), _mesh(8), int8=True, n_valid=13)
    assert placed.n == 13 and placed.shard == 2 and len(placed.shards) == 8
    d, i = pknn.nearest_neighbor_sharded(torch.from_numpy(p), placed, _mesh(8))
    want_d, want_i = tk.nearest_neighbor_int8_plain(torch.from_numpy(p), q, scale)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), want_i.numpy())
    np.testing.assert_array_equal(d.numpy(), want_d.numpy())
    assert (i.numpy() < 13).all()
    with pytest.raises(ValueError, match="requires int8"):
        pknn.place_gallery((qp, scale), _mesh(8))
    with pytest.raises(ValueError, match="not a multiple"):
        pknn.place_gallery((q, scale), _mesh(8), int8=True)
    with pytest.raises(ValueError, match="n_valid requires"):
        pknn.place_gallery(torch.from_numpy(g), _mesh(8), n_valid=13)


def test_placed_shards_are_separate_buffers():
    g = torch.randn(16, 4)
    placed = pknn.place_gallery(g, _mesh(4))
    ptrs = {s.data_ptr() for s in placed.shards}
    assert len(ptrs) == 4 and g.data_ptr() not in ptrs


# ---------- identifier and gallery ----------

@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("shards", [2, 8])
def test_identifier_mesh_matches_jax(quantized, shards):
    p, g = _knn_data(19, seed=4)
    labels = np.arange(19) % 6
    want = JaxIdentifier(mesh=_jax_mesh(shards), quantized=quantized).fit(g, labels).predict(p)
    got = KNNIdentifier(mesh=_mesh(shards), quantized=quantized).fit(g, labels).predict(p)
    single = KNNIdentifier(quantized=quantized, device="cpu").fit(g, labels).predict(p)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, single)


@pytest.mark.parametrize("quantized", [True, False])
def test_gallery_mesh_matches_single_device(quantized):
    """19 enrollments over 8 shards (padded), as the JAX package's
    ``test_gallery_mesh_sharded_ranking``; queries reuse the placed state,
    an enrollment replaces it."""
    rng = np.random.RandomState(12345)
    feats = rng.randn(19, 32).astype(np.float32)
    labels = [f"p{i % 7}" for i in range(19)]
    probes = np.concatenate([rng.randn(5, 32).astype(np.float32), feats[3:4] * 2.0])
    local = EnrollmentGallery(quantized=quantized, device="cpu")
    sharded = EnrollmentGallery(quantized=quantized, mesh=_mesh(8))
    local.enroll_many(labels, feats)
    sharded.enroll_many(labels, feats)
    want = local.identify_many(probes, threshold=0.9)
    for _ in range(3):
        got = sharded.identify_many(probes, threshold=0.9)
        for (l1, d1, n1), (l2, d2, n2) in zip(want, got):
            assert (l1, n1) == (l2, n2)
            assert abs(d1 * d1 - d2 * d2) <= 1e-6
    assert sharded.placements == 1
    assert got[-1][0] == "p3" and got[-1][1] < 0.05
    new = rng.randn(32).astype(np.float32)
    sharded.enroll("newcomer", new)
    assert sharded.identify(new * 0.5)[0] == "newcomer"
    assert sharded.placements == 2


# ---------- the embedder ----------

@pytest.fixture(scope="module")
def embed_params():
    from hse_facerec_tf_tpu.models.mobilenet import init_mobilenet_params

    return jax.tree.map(np.asarray, init_mobilenet_params(jax.random.PRNGKey(0), width=0.25))


def test_embedder_mesh_matches_jax_and_single_device(embed_params):
    from hse_facerec_tf_tpu.models.mobilenet import mobilenet_embed as jembed
    from hse_facerec_tf_tpu.pipelines.embedder import EmbeddingExtractor as JaxExtractor
    from hse_facerec_torch.models.mobilenet import mobilenet_embed
    from hse_facerec_torch.pipelines.embedder import EmbeddingExtractor

    images = (np.random.RandomState(5).rand(11, 40, 40, 3) * 255).astype(np.uint8)
    kw = dict(normalization="caffe", resize_method="cv2_linear", batch_size=8)
    want = JaxExtractor(functools.partial(jembed, precision=HIGHEST), embed_params,
                        (32, 32), mesh=_jax_mesh(8), host_resize="never",
                        **kw).extract_batch(images)
    got = EmbeddingExtractor(mobilenet_embed, embed_params, (32, 32), mesh=_mesh(8),
                             **kw).extract_batch(images)
    single = EmbeddingExtractor(mobilenet_embed, embed_params, (32, 32), device="cpu",
                                **kw).extract_batch(images)
    assert got.shape == (11, 256)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, single, atol=1e-5, rtol=1e-5)


def test_embedder_mesh_pads_the_tail_to_every_shard(embed_params, monkeypatch):
    """A 3-image tail on a 16-shard mesh pads to 16 rows (one a shard), and
    ``extract_files`` keeps the input order across shards."""
    from hse_facerec_torch.models.mobilenet import mobilenet_embed
    from hse_facerec_torch.pipelines.embedder import EmbeddingExtractor

    ex = EmbeddingExtractor(mobilenet_embed, embed_params, (32, 32), normalization="none",
                            batch_size=32, mesh=_mesh(16))
    rows = []
    forward = EmbeddingExtractor._forward_on
    monkeypatch.setattr(EmbeddingExtractor, "_forward_on",
                        lambda self, p, x: rows.append(x.shape[0]) or forward(self, p, x))
    images = np.random.RandomState(6).rand(3, 32, 32, 3).astype(np.float32)
    got = ex.extract_batch(images)
    assert rows == [1] * 16 and got.shape == (3, 256)
    single = EmbeddingExtractor(mobilenet_embed, embed_params, (32, 32),
                                normalization="none", device="cpu").extract_batch(images)
    np.testing.assert_allclose(got, single, atol=1e-5, rtol=1e-5)
    files = ex.extract_files(list(range(5)), loader=lambda i: images[i % 3] * (1 + i),
                             decode_workers=0)
    want = EmbeddingExtractor(mobilenet_embed, embed_params, (32, 32), normalization="none",
                              device="cpu").extract_batch(
        np.stack([images[i % 3] * (1 + i) for i in range(5)]))
    np.testing.assert_allclose(files, want, atol=1e-5, rtol=1e-5)


def test_zoo_extractors_take_the_mesh(embed_params, monkeypatch):
    from hse_facerec_torch.models import zoo

    mesh = _mesh(2)
    ex = zoo.build_extractor("vgg2_mobilenet", params=embed_params, mesh=mesh)
    assert ex.mesh is mesh and ex.device == torch.device("cpu")

    class Graph:
        def torch_params(self, device):
            return {"w": torch.full((3, 2), 0.5, device=device)}

        def fn(self, params, feeds):
            (x,) = feeds.values()
            return (x.reshape(x.shape[0], -1)[:, :3] @ params["w"],)

    monkeypatch.setattr("hse_facerec_torch.core.graph_compiler.compile_pb",
                        lambda *a, **k: Graph())
    gex = zoo.graph_extractor("x.pb", "in:0", "out:0", (4, 4), normalization="none",
                              mesh=mesh)
    images = np.arange(5 * 4 * 4 * 3, dtype=np.float32).reshape(5, 4, 4, 3)
    np.testing.assert_allclose(gex.extract_batch(images),
                               images.reshape(5, -1)[:, :3].sum(1, keepdims=True)
                               .repeat(2, 1) * 0.5)


# ---------- the mesh analyzer ----------

@pytest.fixture(scope="module")
def multihead_np():
    return random_multihead_params(np.random.RandomState(100))


def _kw(case="fits"):
    _, _, det_kw, head_batch = CASES[case]
    return dict(minsize=20, face_size=64, head_batch=head_batch, **det_kw)


def _mtcnn(case="fits"):
    return random_mtcnn_params(np.random.RandomState(CASES[case][0]))


def _lanes(n):
    return np.stack([_photo(s) if s % 3 else np.zeros((H, W, 3), np.uint8)
                     for s in range(2, 2 + n)])


def test_mesh_analyze_batch_matches_jax(multihead_np, monkeypatch):
    """8 lanes over the 8-device meshes of both packages: one compacted
    program a shard, per-shard head budget max(16, 2·1)."""
    imgs = _lanes(8)
    jax_an = JaxAnalyzer(_mtcnn(), heads=JaxHeads(multihead_np, precision=HIGHEST),
                         precision=HIGHEST, mesh=jsharding.make_mesh(), **_kw())
    an = FacialAnalyzer(_mtcnn(), multihead_np, mesh=_mesh(8), **_kw())
    cores = []
    core = FacialAnalyzer.analyze_batch_core
    monkeypatch.setattr(FacialAnalyzer, "analyze_batch_core",
                        lambda self, x, t: cores.append((x.shape[0], t)) or core(self, x, t))
    got = an.analyze_batch(imgs)
    assert cores == [(1, 16)] * 8
    want = jax_an.analyze_batch(imgs)
    assert sum(map(len, got)) > 0 and got[1] == []      # a blank lane
    _assert_same_batches(got, want)
    for g, w in zip(got, want):
        for gf, wf in zip(g, w):
            assert gf.bbox == wf.bbox


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("shards", [2, 4])
def test_mesh_analyze_batch_matches_single_device(multihead_np, case, shards):
    """5 lanes zero-padded to the shard multiple, ``n_valid``, and in the
    crowded case lanes whose faces overflow the per-shard budget re-run
    through ``analyze``: the single-device answers."""
    imgs = _lanes(5)
    single = FacialAnalyzer(_mtcnn(case), multihead_np, device="cpu", **_kw(case))
    an = FacialAnalyzer(_mtcnn(case), multihead_np, mesh=_mesh(shards), **_kw(case))
    got = an.analyze_batch(imgs, n_valid=4)
    want = single.analyze_batch(imgs, n_valid=4)
    assert len(got) == 4 and sum(map(len, got)) > 0
    _assert_same_batches(got, want)
    for g, w in zip(got, want):
        assert [f.bbox for f in g] == [f.bbox for f in w]
    tight = FacialAnalyzer(_mtcnn(case), multihead_np, mesh=_mesh(shards),
                           batch_head_total=1, **_kw(case))
    _assert_same_batches(tight.analyze_batch(imgs), single.analyze_batch(imgs))


def test_mesh_oversample_runs_lane_by_lane_per_shard(multihead_np, monkeypatch):
    imgs = _lanes(4)
    single = FacialAnalyzer(_mtcnn(), multihead_np, device="cpu", oversample=True, **_kw())
    an = FacialAnalyzer(_mtcnn(), multihead_np, mesh=_mesh(2), oversample=True, **_kw())
    calls = []
    core = FacialAnalyzer.analyze_core
    monkeypatch.setattr(FacialAnalyzer, "analyze_core",
                        lambda self, x, *a: calls.append(tuple(x.shape)) or core(self, x, *a))
    got = an.analyze_batch(imgs)
    assert calls[:2] == [(2, H, W, 3)] * 2
    _assert_same_batches(got, single.analyze_batch(imgs))


def test_mesh_analyzer_with_minsize_keeps_the_mesh(multihead_np):
    an = FacialAnalyzer(_mtcnn(), multihead_np, mesh=_mesh(2), **_kw())
    clone = an.with_minsize(30)
    imgs = _lanes(4)
    want = FacialAnalyzer(_mtcnn(), multihead_np, device="cpu", **_kw()).with_minsize(30)
    assert clone.mesh is an.mesh
    _assert_same_batches(clone.analyze_batch(imgs), want.analyze_batch(imgs))


def test_to_device_copies_tensor_holders_only_across_devices(multihead_np):
    an = FacialAnalyzer(_mtcnn(), multihead_np, device="cpu", **_kw())
    assert ps.to_device(an.detector, torch.device("cpu")) is an.detector
    assert ps.to_device(an.heads, torch.device("cpu")) is an.heads
    packed = tk.pack_quantized_gallery(*tk.quantize_embeddings(torch.randn(4, 8)))
    moved = ps.to_device(packed, torch.device("cpu"))
    assert type(moved) is tk.PackedGallery and moved.q is packed.q
    # another device (the meta device stands in for a second card): a copy
    # whose detector and heads hold every tensor there, the original intact
    meta = torch.device("meta")
    replica = ps.to_device(an, meta)
    assert replica is not an and replica.device == replica.detector.device == meta
    assert replica.heads.device == meta and an.device == torch.device("cpu")
    for tree, orig in ((replica.detector.params, an.detector.params),
                       (replica.heads.params, an.heads.params)):
        assert all(t.device == meta for t in _leaves(tree))
        assert all(t.device == torch.device("cpu") for t in _leaves(orig))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    values = tree.values() if isinstance(tree, dict) else tree
    return [t for v in values for t in _leaves(v)]


# ---------- album and serve on a mesh ----------

def test_album_scan_with_a_mesh_analyzer(tmp_path, multihead_np):
    """A mesh analyzer keeps the deferred no-face collection and the
    batched rotation retry (the resident retry is single-device): the
    single-device scan's faces."""
    from hse_facerec_torch.config import AlbumConfig
    from hse_facerec_torch.pipelines import album as talbum

    from .test_torch_album import CFG, LANES, _album_photos, _assert_same_album_faces

    import cv2

    for name, (img, _) in _album_photos().items():
        cv2.imwrite(str(tmp_path / f"{name}.png"), img[:, :, ::-1])
    single = FacialAnalyzer(_mtcnn(), multihead_np, device="cpu", **_kw())
    sharded = FacialAnalyzer(_mtcnn(), multihead_np, mesh=_mesh(2), **_kw())
    want = talbum.AlbumOrganizer(single, AlbumConfig(**CFG), analyze_batch=LANES
                                 ).scan_album(str(tmp_path), use_cache=False)
    org = talbum.AlbumOrganizer(sharded, AlbumConfig(**CFG), analyze_batch=LANES)
    retried = []
    retry = org._batched_rotation_retry
    org._batched_rotation_retry = lambda entries, per_photo: retried.extend(
        i for i, _, _ in entries) or retry(entries, per_photo)
    got = org.scan_album(str(tmp_path), use_cache=False)
    _assert_same_album_faces(got, want)
    assert sorted(got.files[i] for i in retried) == ["r0.png", "r1.png", "r2.png",
                                                     "z_blank.png"]


def test_serve_handler_on_a_mesh_matches_single_device(multihead_np):
    """/enroll, /embed, /analyze?identify=1 and /identify over a socket,
    mesh extractor, analyzer and gallery against single-device ones."""
    import cv2

    from hse_facerec_torch import serve as tserve
    from hse_facerec_torch.models import zoo as tzoo
    from hse_facerec_torch.pipelines.embedder import EmbeddingExtractor

    from .test_torch_serve import _call, _png, _serve

    def handler(**where):
        ex = EmbeddingExtractor(tzoo.MODEL_ZOO["agegender_identity"].model_fn(),
                                multihead_np, (64, 64), normalization="caffe",
                                resize_method="cv2_linear", batch_size=8, **where)
        an = FacialAnalyzer(_mtcnn(), multihead_np, **_kw(), **where)
        return tserve.make_handler(
            tserve._BatchingWorker(ex.extract_batch),
            tserve._BatchingWorker(functools.partial(tserve._analyze_batch_pow2, an),
                                   max_batch=8),
            gallery=EnrollmentGallery(**where), device="cpu")

    servers = {"single": _serve(handler(device="cpu")),
               "mesh": _serve(handler(mesh=_mesh(4)))}
    photos = {s: _png(cv2.cvtColor(_photo(s), cv2.COLOR_RGB2BGR)) for s in (2, 3, 4)}
    requests = ([("POST", f"/enroll?label=p{s}", photos[s]) for s in (2, 3)]
                + [("POST", "/embed", photos[4]), ("POST", "/analyze?identify=1", photos[2]),
                   ("POST", "/identify", photos[4])])
    try:
        answers = {k: [_call(port, *r) for r in requests] for k, (_, port) in servers.items()}
    finally:
        for server, _ in servers.values():
            server.shutdown()
    for (_, path, _), (gs, got), (ws, want) in zip(requests, answers["mesh"],
                                                    answers["single"]):
        assert gs == ws == 200, (path, got, want)
        if path == "/embed":
            np.testing.assert_allclose(got["embedding"], want["embedding"], atol=1e-5)
        elif path.startswith("/analyze"):
            assert [f["bbox"] for f in got["faces"]] == [f["bbox"] for f in want["faces"]]
            assert [f.get("label") for f in got["faces"]] == [
                f.get("label") for f in want["faces"]]
        elif path == "/identify":
            assert got["label"] == want["label"] and got["nearest"] == want["nearest"]
