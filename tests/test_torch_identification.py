"""Parity of the port's identification slice with the JAX package, on the
CPU: distance ops, preprocessing and resize, ``EmbeddingExtractor``,
``KNNIdentifier``, ``EnrollmentGallery``, the LFW / gallery-probe
protocols, the CLI, and the slice as a whole.

The same seeded numpy inputs and random multi-head parameters go through
both packages; the port runs on the CPU with the plain twins of its
kernels. Tolerances:
- distance ops: ``rtol=1e-5`` (sums in another order);
- identity vectors: ``atol=1e-4``, as ``test_torch_models.py`` (fp32 sums
  in another order through 13 MobileNet blocks at Precision.HIGHEST);
- kNN predictions, gallery labels, protocol accuracies: equal; gallery
  distances ``rtol=1e-6`` for int8 (the reference's int8 twin fuses one
  rounding), ``atol=1e-5`` for f32 (``a2 + b2 - 2ab`` cancels near a match);
- PCA projections: equal up to a sign per column (an SVD fixes singular
  vectors only up to sign), and the kNN decisions on them equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu.eval import lfw as jlfw
from hse_facerec_tf_tpu.models import multihead as jmh
from hse_facerec_tf_tpu.ops import distance as jd
from hse_facerec_tf_tpu.ops import preprocess as jpre
from hse_facerec_tf_tpu.ops import resize as jres
from hse_facerec_tf_tpu.pipelines import gallery as jgal
from hse_facerec_tf_tpu.pipelines import identification as jid
from hse_facerec_tf_tpu.pipelines.embedder import EmbeddingExtractor as JaxExtractor
from hse_facerec_torch.eval import lfw as tlfw
from hse_facerec_torch.models import multihead as tmh
from hse_facerec_torch.models import zoo as tzoo
from hse_facerec_torch.ops import distance as td
from hse_facerec_torch.ops import preprocess as tpre
from hse_facerec_torch.ops import resize as tres
from hse_facerec_torch.ops.kernels import knn as tk
from hse_facerec_torch.pipelines import embedder as tembed
from hse_facerec_torch.pipelines import gallery as tgal
from hse_facerec_torch.pipelines import identification as tid
from hse_facerec_torch.pipelines.embedder import EmbeddingExtractor
from hse_facerec_torch.testing import random_multihead_params

HIGHEST = jax.lax.Precision.HIGHEST
SIZE = (64, 64)       # the extractor's input size in these tests


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jax_identity(params, x):
    return jmh.multihead_apply(params, x, precision=HIGHEST).identity


def _torch_identity(params, x):
    return tmh.multihead_apply(params, x).identity


@pytest.fixture(scope="module")
def mh_np():
    return random_multihead_params(np.random.RandomState(21))


def _extractors(mh_np, **kw):
    kw = dict(dict(normalization="caffe", resize_method="cv2_linear",
                   batch_size=4), **kw)
    return (JaxExtractor(_jax_identity, mh_np, SIZE, **kw),
            EmbeddingExtractor(_torch_identity, mh_np, SIZE, device="cpu", **kw))


def _classes(rng, n_classes=10, per_class=6, dim=48, noise=0.3):
    centers = rng.randn(n_classes, dim).astype(np.float32)
    feats = np.repeat(centers, per_class, 0) + noise * rng.randn(
        n_classes * per_class, dim).astype(np.float32)
    return feats, np.repeat(np.arange(n_classes), per_class)


# -- ops ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pairwise_sqeuclidean", "pairwise_euclidean",
                                  "pairwise_cosine", "pairwise_chi2",
                                  "pairwise_kl", "pairwise_emd_unit"])
def test_pairwise_distances(name):
    rng = np.random.RandomState(1)
    a = rng.rand(7, 24).astype(np.float32)      # histogram-like, >= 0
    b = rng.rand(11, 24).astype(np.float32)
    a[0, :5] = 0.0
    b[0, :5] = 0.0                              # chi2's 0/0 bins
    want = getattr(jd, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(td, name)(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_l2_normalize():
    x = np.random.RandomState(2).randn(9, 33).astype(np.float32)
    x[3] = 0.0
    np.testing.assert_allclose(td.l2_normalize(_t(x)).numpy(),
                               np.asarray(jd.l2_normalize(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "chi2", "kl"])
def test_nearest_neighbor(metric):
    rng = np.random.RandomState(3)
    g = rng.rand(30, 16).astype(np.float32)
    g[20] = g[4]                                   # a tie: index 4 wins
    p = np.concatenate([rng.rand(9, 16), g[4:5]]).astype(np.float32)
    labels = np.arange(30) * 10
    wl, wd = jd.nearest_neighbor(jnp.asarray(g), jnp.asarray(labels),
                                 jnp.asarray(p), metric)
    gl, gd = td.nearest_neighbor(_t(g), _t(labels), _t(p), metric)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-6)
    if metric != "kl":            # unnormalized KL can go below the self-match
        assert int(gl[-1]) == 40


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_top_k_neighbors_ties_lowest_index(metric):
    rng = np.random.RandomState(4)
    g = rng.randn(25, 8).astype(np.float32)
    g[[7, 12, 19]] = g[3]                           # four equal rows
    p = g[[3, 0]] + np.float32(0.0)
    wi, wd = jd.top_k_neighbors(jnp.asarray(g), jnp.asarray(p), 4, metric)
    gi, gd = td.top_k_neighbors(_t(g), _t(p), 4, metric)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gi.numpy()[0], [3, 7, 12, 19])


@pytest.mark.parametrize("name", sorted(jpre.NORMALIZERS))
def test_normalizers(name):
    x = (np.random.RandomState(5).rand(2, 6, 5, 3) * 255).astype(np.float32)
    want = jax.jit(jpre.NORMALIZERS[name])(x)
    got = tpre.NORMALIZERS[name](_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["cv2_linear", "cv2_area", "pil_bilinear",
                                    "pil_nearest", "cv2_cubic"])
def test_resize_and_resize_host(method):
    img = (np.random.RandomState(6).rand(2, 37, 51, 3) * 255).astype(np.float32)
    for src, dst in ((37, 64), (51, 20)):
        np.testing.assert_array_equal(tres._WEIGHT_FNS[method](src, dst),
                                      jres._WEIGHT_FNS[method](src, dst))
    want = jres.resize(jnp.asarray(img), (64, 20), method)
    got = tres.resize(_t(img), (64, 20), method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    np.testing.assert_array_equal(tres.resize_host(img, (64, 20), method),
                                  jres.resize_host(img, (64, 20), method))


# -- extractor -----------------------------------------------------------------


@pytest.mark.parametrize("case", ["native", "device_resize", "host_resize",
                                  "tail_bucket", "flip_l2"])
def test_extractor_matches_jax(mh_np, case, monkeypatch):
    device_resized = _record_device_resizes(monkeypatch)
    rng = np.random.RandomState(7)
    kw, shape = {}, (3, 64, 64, 3)
    if case == "device_resize":
        shape = (4, 48, 56, 3)
    elif case == "host_resize":
        kw, shape = dict(host_resize="always"), (3, 50, 41, 3)
    elif case == "tail_bucket":
        kw, shape = dict(batch_size=16), (5, 64, 64, 3)
    elif case == "flip_l2":
        kw = dict(flip_tta=True, l2_normalize_output=True)
    jx, tx = _extractors(mh_np, **kw)
    imgs = (rng.rand(*shape) * 255).astype(np.uint8)
    want = jx.extract_batch(imgs)
    got = tx.extract_batch(imgs)
    assert got.shape == (shape[0], 1024) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    want_resized = [shape[1:3]] if case == "device_resize" else []
    assert device_resized == want_resized


def _record_device_resizes(monkeypatch):
    """Source sizes the extractor resizes on the device, in call order."""
    seen = []

    def recording_resize(x, size, method):
        seen.append(tuple(x.shape[1:3]))
        return tres.resize(x, size, method)

    monkeypatch.setattr(tembed, "resize", recording_resize)
    return seen


def test_extractor_resizes_every_source_size_on_device(mh_np, monkeypatch):
    """By default every non-native size is resized on the device, however
    many sizes came before (nothing is compiled per shape), and matches the
    JAX extractor resizing on its device."""
    device_resized = _record_device_resizes(monkeypatch)
    jx, tx = _extractors(mh_np, batch_size=2, host_resize="never")
    rng = np.random.RandomState(8)
    sizes = [(50, 60), (70, 50), (90, 110), (41, 33), (52, 47), SIZE]
    for hw in sizes:
        imgs = (rng.rand(2, *hw, 3) * 255).astype(np.uint8)
        np.testing.assert_allclose(tx.extract_batch(imgs), jx.extract_batch(imgs),
                                   atol=1e-4)
    assert device_resized == sizes[:-1]


def test_extract_files_matches_batch(mh_np, tmp_path):
    """Streamed loading with mixed sizes, partial buckets and both decode
    modes equals the JAX extractor's streamed result."""
    rng = np.random.RandomState(9)
    sizes = [(64, 64), (40, 52), (64, 64), (64, 64), (40, 52), (64, 64)]
    paths = []
    for i, hw in enumerate(sizes):
        paths.append(str(tmp_path / f"img_{i}.npy"))
        np.save(paths[-1], (rng.rand(*hw, 3) * 255).astype(np.uint8))
    jx, tx = _extractors(mh_np, batch_size=3)
    want = jx.extract_files(paths, loader=np.load)
    for workers in (0, 3):
        got = tx.extract_files(paths, loader=np.load, decode_workers=workers)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_zoo_spec_and_build_extractor(mh_np, monkeypatch):
    from hse_facerec_tf_tpu.models import zoo as jzoo

    spec, jspec = tzoo.MODEL_ZOO["agegender_identity"], jzoo.MODEL_ZOO["agegender_identity"]
    for field in ("input_size", "normalization", "resize_method", "embedding_dim"):
        assert getattr(spec, field) == getattr(jspec, field)
    ex = tzoo.build_extractor("agegender_identity", batch_size=2, device="cpu",
                              params=mh_np)
    assert (ex.input_size, ex.normalization, ex.resize_method) == (
        (224, 224), "caffe", "cv2_linear")
    monkeypatch.setattr(tzoo, "_WEIGHT_FILES", {"agegender_identity": "/nonexistent"})
    assert tzoo.weights_origin("agegender_identity") == "missing"


# -- kNN and protocols ---------------------------------------------------------


@pytest.mark.parametrize("k,quantized", [(1, False), (3, False), (1, True)])
def test_knn_identifier_matches_jax(k, quantized):
    rng = np.random.RandomState(10 + k)
    data, classes = _classes(rng, dim=8, noise=1.2)
    feats, labels, probes = data[::2], classes[::2], data[1::2]
    want = jid.KNNIdentifier(k=k, quantized=quantized).fit(feats, labels).predict(probes)
    knn = tid.KNNIdentifier(k=k, quantized=quantized, device="cpu").fit(feats, labels)
    np.testing.assert_array_equal(knn.predict(probes), want)
    assert 0.3 < knn.score(probes, classes[1::2]) < 1.0  # errors to agree on
    if quantized:
        q, s = knn._gallery
        assert q.dtype == torch.int8 and q.shape == feats.shape and s.dim() == 0
        with pytest.raises(ValueError):
            tid.KNNIdentifier(k=3, quantized=True, device="cpu")


def test_pca_projection_up_to_sign_and_knn_decisions():
    rng = np.random.RandomState(12)
    feats, labels = _classes(rng, n_classes=8, per_class=5, dim=40, noise=1.0)
    tr, te = np.arange(0, 40, 2), np.arange(1, 40, 2)
    jtr, jte = jid.pca_project(feats[tr], feats[te], 6)
    ttr, tte = tid.pca_project(feats[tr], feats[te], 6, device="cpu")
    sign = np.sign(np.sum(ttr * jtr, axis=0))
    assert np.all(sign != 0)
    # two LAPACK SVDs of f32 data agree to ~1e-4 relative on these values
    np.testing.assert_allclose(ttr * sign, jtr, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tte * sign, jte, rtol=1e-3, atol=1e-3)
    for k in (1, 3):
        want = jid.KNNIdentifier(k=k, normalize=False).fit(jtr, labels[tr]).predict(jte)
        got = tid.KNNIdentifier(k=k, normalize=False, device="cpu").fit(
            ttr, labels[tr]).predict(tte)
        np.testing.assert_array_equal(got, want)


def test_protocol_helpers_match_jax():
    labels = np.array([5, 5, 2, 9, 9, 9, 7, 2, 4])
    feats = np.arange(len(labels), dtype=np.float32)[:, None]
    for a, b in zip(tid.drop_singleton_classes(feats, labels),
                    jid.drop_singleton_classes(feats, labels)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(13)
    lab = rng.randint(0, 6, 40)
    for (a, b), (c, d) in zip(tid.single_image_per_class_splits(lab, 4, seed=3),
                              jid.single_image_per_class_splits(lab, 4, seed=3)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("protocol", ["split50", "single"])
def test_identification_benchmark_matches_jax(protocol):
    rng = np.random.RandomState(14)
    feats, labels = _classes(rng, n_classes=9, per_class=4, noise=1.2)
    feats, labels = np.concatenate([feats, feats[:1]]), np.append(labels, 99)
    want = jlfw.identification_benchmark(feats, labels, protocol)
    got = tlfw.identification_benchmark(feats, labels, protocol, device="cpu")
    assert got == want
    assert got["n_classes"] == 9 and 0.0 < got["accuracy"] < 1.0


def test_classifier_suite_matches_jax():
    rng = np.random.RandomState(15)
    feats, labels = _classes(rng, n_classes=8, per_class=6, dim=40, noise=1.5)
    want = jlfw.classifier_suite(feats, labels, pca_components=8)
    got = tlfw.classifier_suite(feats, labels, pca_components=8, device="cpu")
    assert got == want


def test_gallery_probe_suite_matches_jax():
    rng = np.random.RandomState(16)
    feats, labels = _classes(rng, n_classes=6, per_class=6, dim=32, noise=1.5)
    g, p = np.arange(0, 36, 2), np.arange(1, 36, 2)
    args = (feats[g], labels[g], feats[p], labels[p])
    want = jid.gallery_probe_suite(*args, pca_components=5, rf_seed=0)
    got = tid.gallery_probe_suite(*args, pca_components=5, rf_seed=0, device="cpu")
    assert got == want


# -- enrollment gallery ----------------------------------------------------------


@pytest.mark.parametrize("quantized", [True, False])
def test_gallery_matches_jax(quantized, tmp_path):
    rng = np.random.RandomState(17)
    feats = rng.randn(12, 32).astype(np.float32)
    names = [f"p{i % 4}" for i in range(12)]
    probes = np.concatenate([feats[[2, 7]] + 0.05 * rng.randn(2, 32),
                             rng.randn(2, 32)]).astype(np.float32)
    jg = jgal.EnrollmentGallery(str(tmp_path / "j.npz"), quantized=quantized)
    tg = tgal.EnrollmentGallery(str(tmp_path / "t.npz"), quantized=quantized,
                                device="cpu")
    for g in (jg, tg):
        assert g.identify(probes[0]) == (None, None, None)
        assert g.enroll("solo", feats[0]) == 1
        assert g.enroll_many(names[1:8], feats[1:8]) == 8
        assert g.enroll_many(names[8:], feats[8:], replace_labels=["p1"]) == 10
        assert g.remove("solo") == 1 and g.remove("nobody") == 0
    assert tg.stats() == dict(jg.stats(), path=str(tmp_path / "t.npz"))
    want, got = jg.identify_many(probes, 0.9), tg.identify_many(probes, 0.9)
    assert [(a, c) for a, _, c in got] == [(a, c) for a, _, c in want]
    # int8: exact math, one fused rounding apart; f32: a2 + b2 - 2ab cancels
    # for near matches, and the sums run in another order
    tol = dict(rtol=1e-6) if quantized else dict(atol=1e-5)
    np.testing.assert_allclose([d for _, d, _ in got], [d for _, d, _ in want],
                               **tol)
    assert got[0][0] is not None and got[-1][0] is None
    with pytest.raises(ValueError):
        tg.enroll_many(["x"], np.zeros((1, 16), np.float32))
    with pytest.raises(ValueError):
        tg.identify_many(np.zeros((1, 16), np.float32))


def test_gallery_npz_round_trips_both_ways(tmp_path):
    rng = np.random.RandomState(18)
    feats = rng.randn(6, 16).astype(np.float32)
    names = ["ann", "bob", "cid", "ann", "bob", "cid"]
    probes = feats[[2, 3]] + 0.01
    # JAX writes an exact-ranking file; the port reads it and keeps 'f32'
    jg = jgal.EnrollmentGallery(str(tmp_path / "a.npz"), quantized=False)
    jg.enroll_many(names, feats)
    tg = tgal.EnrollmentGallery(str(tmp_path / "a.npz"), device="cpu")
    assert not tg.quantized and len(tg) == 6
    assert [r[2] for r in tg.identify_many(probes)] == ["cid", "ann"]
    # the port writes an int8 file; the JAX package reads it back as int8
    tg2 = tgal.EnrollmentGallery(str(tmp_path / "b.npz"), device="cpu")
    tg2.enroll_many(names, feats)
    jg2 = jgal.EnrollmentGallery(str(tmp_path / "b.npz"))
    assert jg2.quantized and jg2._labels == names
    np.testing.assert_array_equal(np.stack(jg2._feats), np.stack(tg2._feats))
    assert ([r[2] for r in jg2.identify_many(probes)]
            == [r[2] for r in tg2.identify_many(probes)])
    assert not os.path.exists(str(tmp_path / "b.npz") + ".tmp")


# -- the slice as a whole ----------------------------------------------------------


def _people_tree(root, rng, n_people=4, n_gallery=3, n_probe=2, hw=(56, 60)):
    """Seeded per-person .npy "photos": a base image per person plus noise."""
    paths = {"gallery": [], "probe": []}
    labels = {"gallery": [], "probe": []}
    for person in range(n_people):
        base = rng.rand(*hw, 3) * 255
        for i in range(n_gallery + n_probe):
            split = "gallery" if i < n_gallery else "probe"
            d = root / split / f"person{person}"
            d.mkdir(parents=True, exist_ok=True)
            img = np.clip(base + rng.randn(*hw, 3) * 25, 0, 255).astype(np.uint8)
            paths[split].append(str(d / f"{i}.npy"))
            labels[split].append(person)
            np.save(paths[split][-1], img)
    return paths, {k: np.asarray(v) for k, v in labels.items()}


def test_identify_slice_matches_jax(mh_np, tmp_path):
    """Photos -> extract_files(loader=np.load) -> gallery_probe_eval, exact
    and quantized, in both packages: the same accuracy and predictions."""
    paths, labels = _people_tree(tmp_path, np.random.RandomState(19))
    jx, tx = _extractors(mh_np, batch_size=4)
    feats = {}
    for split in ("gallery", "probe"):
        want = jx.extract_files(paths[split], loader=np.load)
        feats[split] = tx.extract_files(paths[split], loader=np.load)
        np.testing.assert_allclose(feats[split], want, atol=1e-4)
    args = (feats["gallery"], labels["gallery"], feats["probe"], labels["probe"])
    for quantized in (False, True):
        want = jid.gallery_probe_eval(*args, quantized=quantized)
        assert tid.gallery_probe_eval(*args, quantized=quantized,
                                      device="cpu") == want
        jp = jid.KNNIdentifier(quantized=quantized).fit(*args[:2]).predict(args[2])
        tp = tid.KNNIdentifier(quantized=quantized, device="cpu").fit(
            *args[:2]).predict(args[2])
        np.testing.assert_array_equal(tp, jp)
    assert want == 1.0


def _patch_zoo(monkeypatch, mh_np):
    spec = tzoo.MODEL_ZOO["agegender_identity"]
    monkeypatch.setitem(tzoo.MODEL_ZOO, "agegender_identity",
                        type(spec)(**dict(vars(spec), input_size=SIZE,
                                          build_params=lambda: mh_np)))


def _png_tree(root, rng):
    import cv2

    for split, count in (("gallery", 2), ("probe", 1)):
        for person in ("ann", "bob"):
            base = rng.rand(40, 40, 3) * 255
            (root / split / person).mkdir(parents=True)
            for i in range(count):
                img = np.clip(base + rng.randn(40, 40, 3) * 10, 0, 255)
                cv2.imwrite(str(root / split / person / f"{i}.png"),
                            img.astype(np.uint8))


def test_cli_identify_and_enroll(mh_np, tmp_path, capsys, monkeypatch):
    from hse_facerec_torch import cli

    _patch_zoo(monkeypatch, mh_np)
    _png_tree(tmp_path, np.random.RandomState(20))
    g, p = str(tmp_path / "gallery"), str(tmp_path / "probe")
    base = ["--device", "cpu", "--batch-size", "4"]
    cli.main(["identify", g, p, *base])
    cli.main(["identify", g, p, "--quantized", *base])
    cli.main(["identify", g, p, "--classifiers", "--pca-components", "2", *base])
    out = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert out[0]["accuracy"] == out[1]["accuracy"] == 1.0
    assert out[1]["gallery"] == "int8" and out[0]["n_gallery"] == 4
    assert set(out[2]["classifiers"]) == {
        "1-NN", "1-NN+PCA", "3-NN", "3-NN+PCA", "rf", "svm", "linear svm",
        "linear svm+PCA"}

    npz = str(tmp_path / "people.npz")
    # pre-cropped faces: whole frames (enroll's default mode is face)
    cli.main(["enroll", g, npz, "--mode", "image", "--exact", *base])
    cli.main(["enroll", g, npz, "--mode", "image", "--replace", *base])
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [r["n_enrolled_total"] for r in rows] == [4, 4]
    gal = tgal.EnrollmentGallery(npz, device="cpu")
    assert not gal.quantized and sorted(set(gal._labels)) == ["ann", "bob"]
    with pytest.raises(SystemExit):
        cli.main(["enroll", str(tmp_path / "missing"), npz, *base])


def test_cli_analyze_with_gallery(tmp_path, capsys):
    """``analyze --gallery`` names each face by its nearest enrollment."""
    import cv2

    from hse_facerec_torch import cli
    from hse_facerec_torch.pipelines.analyzer import FacialAnalyzer
    from hse_facerec_torch.testing import random_mtcnn_params

    from .test_torch_analyzer import _photo
    from .test_torch_models import write_mtcnn_pb, write_multihead_pb

    mtcnn_np = random_mtcnn_params(np.random.RandomState(2))
    mh = random_multihead_params(np.random.RandomState(100))
    write_mtcnn_pb(mtcnn_np, tmp_path / "mtcnn.pb")
    write_multihead_pb(mh, tmp_path / "ag.pb", np.random.RandomState(9))
    img = _photo(2)
    cv2.imwrite(str(tmp_path / "photo.png"), img[:, :, ::-1])
    analyzer = FacialAnalyzer.from_reference_models(
        str(tmp_path / "mtcnn.pb"), str(tmp_path / "ag.pb"), device="cpu",
        minsize=20)
    faces, _ = analyzer.analyze_with_rotations(img)
    assert faces
    gal = tgal.EnrollmentGallery(str(tmp_path / "g.npz"), device="cpu")
    gal.enroll_many([f"face{i}" for i in range(len(faces))],
                    np.stack([f.identity for f in faces]))
    cli.main(["analyze", str(tmp_path / "photo.png"), "--device", "cpu",
              "--minsize", "20", "--mtcnn-pb", str(tmp_path / "mtcnn.pb"),
              "--agegender-pb", str(tmp_path / "ag.pb"),
              "--gallery", str(tmp_path / "g.npz")])
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [r["nearest"] for r in rows] == [f"face{i}" for i in range(len(faces))]
    assert all(r["label"] == r["nearest"] and r["distance"] < 0.05 for r in rows)
    before = tk.nearest_neighbor_int8p.launches
    assert gal.identify(faces[0].identity)[0] == "face0"
    assert tk.nearest_neighbor_int8p.launches == before     # CPU: the twin
