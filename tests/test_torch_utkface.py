"""The UTKFace protocol of the PyTorch port against the JAX package.

A synthetic UTKFace-named directory (``{age}_{gender}_{race}_{n}.png``, 11
photo-like images in three sizes, so that size buckets, flushes at the batch
size and repeat-padded tails all occur) goes through each of the nine
backends of both packages with the same seeded params (the port's
``init_*`` from a ``torch.Generator``, or files both importers read):

- per-image predictions on the same batch: ages within rtol and atol 1e-4
  (the atol scaled to the ages' magnitude), P(male) within 1e-5, and the
  backends' hard decisions (argmax ages, 0/1 genders) equal;
- ``evaluate_age_gender``'s metric dicts equal (MAE within 1e-4), where no
  prediction lies within that tolerance of a decision boundary (a bucket
  edge, ±5 years, the 0.6 gender threshold): the test checks that it does
  not, so a flip there would fail it rather than pass unseen;
- the CLI ``utkface`` against the JAX CLI's JSON, and its refusals.
"""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from hse_facerec_tf_tpu import cli as jcli
from hse_facerec_tf_tpu.eval import utkface as JU
from hse_facerec_torch import cli as tcli
from hse_facerec_torch.eval import utkface as TU
from hse_facerec_torch.models import arcface as tarc
from hse_facerec_torch.models import bknet as tbk
from hse_facerec_torch.models import inception_resnet as tir
from hse_facerec_torch.models import mobilenet_v2 as tmn2
from hse_facerec_torch.models import ssrnet as tssr
from hse_facerec_torch.models import wide_resnet as twrn
from hse_facerec_torch.testing import random_multihead_params

from .test_torch_backbones import (_mxnet_weights, _slim_npz, _write_mobilenet_v2_h5,
                                   _write_ssrnet_h5, _write_wrn_h5)

AGE_TOL = 1e-4          # rtol and atol, the atol scaled to the ages' magnitude
# At their random init the SSR-Net merge sits on the tanh asymptote of Δ
# (ages near 1e18) and the WRN logits near 1e4, where float32 rounding, not
# the code, decides the softmax; a trained model has neither. The seeded
# SSR-Net Δ kernels and WRN head kernels are scaled by TAME.
TAME = 1e-3
DISCRETE = ("insightface", "bknet", "converted_pb", "converted_logits_pb")
MALE_TOL = 1e-5
EDGES = (3.0, 7.0, 13.5, 22.5, 35.0, 45.5, 56.5)
SIZES = [(72, 64), (72, 64), (72, 64), (72, 64), (72, 64), (96, 96), (96, 96),
         (96, 96), (50, 80), (72, 64), (96, 96)]
AGES = [1, 5, 9, 17, 28, 33, 41, 50, 63, 80, 24]
BACKENDS = ["ours", "insightface", "facenet", "wide_resnet", "agendernet", "ssrnet",
            "bknet", "converted_pb", "converted_logits_pb"]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _photo(rng, h, w):
    low = torch.from_numpy(rng.rand(1, 3, 4, 4).astype(np.float32) * 255)
    img = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear")
    img = img[0].permute(1, 2, 0).numpy() + rng.randn(h, w, 3) * 10
    return np.clip(img, 0, 255).round().astype(np.uint8)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("utkface")
    rng = np.random.RandomState(5)
    paths = []
    for i, ((h, w), age) in enumerate(zip(SIZES, AGES)):
        path = str(d / f"{age}_{i % 2}_0_2017011{i:02d}.png")
        cv2.imwrite(path, cv2.cvtColor(_photo(rng, h, w), cv2.COLOR_RGB2BGR))
        paths.append(path)
    (d / "not_a_face.png").write_bytes(b"")    # malformed name: skipped
    return str(d), sorted(paths)


def _pb(path, rng, hw, n_out, tap_in, tap_out):
    from hse_facerec_tf_tpu.core.graphdef_export import GraphBuilder

    b = GraphBuilder()
    x = b.placeholder(tap_in, [-1, hw, hw, 3])
    pooled = b.mean("pool", x, [1, 2])
    w = (rng.randn(3, n_out) * 0.05).astype(np.float32)
    raw = b.matmul("raw", pooled, b.const("w", w))
    b.simple("Softmax", tap_out, [raw])
    with open(path, "wb") as f:
        f.write(b.serialize())


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Per backend: the numpy params (or pb paths) and the file(s) the CLIs
    read, written in the published layouts."""
    d = tmp_path_factory.mktemp("weights")
    out = {}
    mh = random_multihead_params(np.random.RandomState(100))
    out["ours"] = ((mh,), None)
    npz = str(d / "insightface.npz")
    np.savez(npz, **_mxnet_weights((1, 1, 1, 1), 202, seed=3))
    out["insightface"] = ((tarc.iresnet_params_from_npz(npz),), [npz])
    ir = tir.init_inception_resnet_v1_params(_gen(20), with_heads=True)
    npz = str(d / "facenet.npz")
    _slim_npz(ir, npz)
    out["facenet"] = ((tir.inception_resnet_v1_params_from_npz(npz),), [npz])
    wrn = twrn.init_wide_resnet_params(_gen(21), k=2)
    for head in ("gender", "age"):
        wrn[head]["kernel"] = wrn[head]["kernel"] * np.float32(TAME)
    h5 = str(d / "wrn.h5")
    _write_wrn_h5(wrn, h5)
    out["wide_resnet"] = ((wrn,), [h5])
    mn2 = tmn2.init_mobilenet_v2_params(_gen(22))
    h5 = str(d / "agendernet.h5")
    _write_mobilenet_v2_h5(mn2, h5)
    out["agendernet"] = ((mn2,), [h5])
    ssr = (tssr.init_ssrnet_params(_gen(23)), tssr.init_ssrnet_params(_gen(24)))
    for p in ssr:
        for k in (1, 2, 3):
            p[f"stage{k}"]["delta"]["kernel"] = p[f"stage{k}"]["delta"]["kernel"] * np.float32(TAME)
    h5s = [str(d / "ssr_age.h5"), str(d / "ssr_gender.h5")]
    for p, h5 in zip(ssr, h5s):
        _write_ssrnet_h5(p, h5)
    out["ssrnet"] = (ssr, h5s)
    bk = tbk.init_bknet_params(_gen(25))
    npz = str(d / "bknet.npz")
    np.savez(npz, **{f"{layer}/{leaf}": a for layer, leaves in bk.items()
                     for leaf, a in leaves.items()})
    out["bknet"] = ((bk,), [npz])
    rng = np.random.RandomState(26)
    for name, tap_in, tap_out in (("converted_pb", "input", "prob"),
                                  ("converted_logits_pb", "Placeholder", "logits")):
        pbs = (str(d / f"{name}_age.pb"), str(d / f"{name}_gender.pb"))
        _pb(pbs[0], rng, 227, 8, tap_in, tap_out)
        _pb(pbs[1], rng, 200, 2, tap_in, tap_out)
        out[name] = (pbs, pbs)
    return out


# facenet at 96² (the published 160² runs on the card): the smallest input
# whose two reductions stay non-empty, for the CPU's sake
FACENET_SIZE = 96


def _predict_fns(backend, args):
    if backend == "ours":
        return JU.multihead_predict_fn(*args), TU.multihead_predict_fn(*args, device="cpu")
    if backend == "facenet":
        return (JU.facenet_predict_fn(*args, face_size=FACENET_SIZE),
                TU.facenet_predict_fn(*args, face_size=FACENET_SIZE, device="cpu"))
    name = {"insightface": "insightface_predict_fn", "wide_resnet": "wide_resnet_predict_fn",
            "agendernet": "agendernet_predict_fn", "ssrnet": "ssrnet_predict_fn",
            "bknet": "bknet_predict_fn", "converted_pb": "converted_pb_predict_fn",
            "converted_logits_pb": "converted_logits_predict_fn"}[backend]
    return getattr(JU, name)(*args), getattr(TU, name)(*args, device="cpu")


def _close_ages(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=AGE_TOL, atol=AGE_TOL * scale)


@pytest.fixture(scope="module")
def predictions(dataset, weights):
    """{backend: ((jax ages, jax p_male), (port ages, port p_male))} over the
    dataset's images of one size, in one batch."""
    from hse_facerec_torch.utils.image_io import imread_rgb

    _, paths = dataset
    batch = np.stack([imread_rgb(p) for p, hw in zip(paths, _sizes(paths)) if hw == (72, 64)])
    out = {}
    for backend in BACKENDS:
        jfn, tfn = _predict_fns(backend, weights[backend][0])
        out[backend] = ([np.asarray(a) for a in jfn(batch)], list(tfn(batch)))
    return out


def _sizes(paths):
    from hse_facerec_torch.utils.image_io import imread_rgb

    return [imread_rgb(p).shape[:2] for p in paths]


@pytest.mark.parametrize("backend", BACKENDS)
def test_predictions_match_jax(predictions, backend):
    (j_age, j_male), (t_age, t_male) = predictions[backend]
    assert t_age.shape == j_age.shape == (sum(s == (72, 64) for s in SIZES),)
    _close_ages(t_age, j_age)
    np.testing.assert_allclose(t_male, j_male, rtol=0, atol=MALE_TOL)
    if backend not in ("ours",):            # every other backend decides gender
        assert set(np.unique(t_male)) <= {0.0, 1.0}
        np.testing.assert_array_equal(t_male, j_male)
    if backend in DISCRETE:
        np.testing.assert_array_equal(t_age, j_age)     # argmax ages


def _near_boundary(ages, p_male, true_ages, tol):
    """Whether a prediction lies within ``tol`` of a decision boundary."""
    ages, tol = np.asarray(ages, np.float64), np.asarray(tol, np.float64)
    edges = np.abs(ages[:, None] - np.asarray(EDGES)[None, :]).min(1) < tol
    five = np.abs(np.abs(ages - true_ages) - 5.0) < tol
    male = np.abs(np.asarray(p_male) - 0.6) < MALE_TOL
    return bool(edges.any() or five.any() or male.any())


def _assert_same_metrics(got, want):
    assert sorted(got) == sorted(want) and got["n"] == want["n"]
    for k in ("gender_accuracy", "age_bucket_accuracy", "age_within5_accuracy"):
        assert got[k] == want[k], k
    assert got["age_mae"] == pytest.approx(want["age_mae"], rel=AGE_TOL, abs=AGE_TOL)


def _per_image(fn, paths):
    """(ages, P(male)) of each path, its size's images in one batch."""
    from hse_facerec_torch.utils.image_io import imread_rgb

    imgs = [imread_rgb(p) for p in paths]
    ages, male = np.zeros(len(paths)), np.zeros(len(paths))
    for hw in {im.shape[:2] for im in imgs}:
        idx = [i for i, im in enumerate(imgs) if im.shape[:2] == hw]
        a, m = fn(np.stack([imgs[i] for i in idx]))
        ages[idx], male[idx] = a, m
    return ages, male


@pytest.mark.parametrize("backend", BACKENDS)
def test_evaluate_age_gender_matches_jax(dataset, weights, backend):
    """Batch 4: the 72x64 bucket flushes once full and once as a padded
    tail, the other sizes as padded tails. Argmax and hard decisions are
    equal to JAX's; continuous ages lie clear of every decision boundary by
    more than their tolerance. So the metrics must be equal."""
    d, paths = dataset
    jfn, tfn = _predict_fns(backend, weights[backend][0])
    ages, male = _per_image(tfn, paths)
    j_ages, j_male = _per_image(jfn, paths)
    if backend in DISCRETE:            # the same decisions: the same metrics
        np.testing.assert_array_equal(ages, j_ages)
        np.testing.assert_array_equal(male, j_male)
    else:
        _close_ages(ages, j_ages)
        true_ages = np.array([TU.parse_utkface_filename(p)[0] for p in paths])
        assert not _near_boundary(ages, male, true_ages,
                                  AGE_TOL * np.maximum(1.0, np.abs(ages)))
    calls = []

    def counted(batch):
        calls.append(len(batch))
        return tfn(batch)

    got = TU.evaluate_age_gender(counted, paths + [f"{d}/not_a_face.png"], batch_size=4)
    want = JU.evaluate_age_gender(jfn, paths, batch_size=4)
    assert calls == [4] * 4 and got["n"] == len(AGES)
    _assert_same_metrics(got, want)


def test_evaluate_age_gender_loader_and_clamps(dataset):
    """``loader=`` reads the images (the card's machine decodes .npy), the
    CORAL subset filters and clamps, the CSV split reads utk_test.csv."""
    from hse_facerec_torch.utils.image_io import imread_rgb

    d, paths = dataset
    loaded = []

    def loader(path):
        loaded.append(path)
        return imread_rgb(path)

    predict = lambda batch: (np.full(len(batch), 80.0), np.ones(len(batch)))
    for kw in ({}, {"age_range": (21, 60)}, {"clamp_range": (21, 60)},
               {"age_range": (21, 60), "clamp_to_age_range": False}):
        got = TU.evaluate_age_gender(predict, paths, batch_size=4, loader=loader, **kw)
        assert got == JU.evaluate_age_gender(predict, paths, batch_size=4, **kw), kw
    assert sorted(set(loaded)) == paths
    names = [p.split("/")[-1] for p in paths[:3]]
    with open(f"{d}/utk_test.csv", "w") as f:
        f.write("index,file\n" + "".join(f"{i},{n}\n" for i, n in enumerate(names))
                + "9,missing.png\n")
    assert TU.read_csv_split(d) == JU.read_csv_split(d) == names


@pytest.mark.parametrize("age", [0, 2.9, 3, 3.1, 13.5, 22.5, 56.5, 57, 100])
def test_age_to_bucket_matches_jax(age):
    assert TU.age_to_bucket(age) == JU.age_to_bucket(age)


# ---------------------------------------------------------------- the CLI

def _run(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _cli_args(backend, weights, tmp_path, monkeypatch):
    if backend == "ours":
        from hse_facerec_tf_tpu.models import multihead as jmh
        from hse_facerec_torch.models import multihead as tmh

        pb = str(tmp_path / "agegender.pb")
        open(pb, "wb").close()
        mh = weights["ours"][0][0]
        for mod in (jmh, tmh):
            monkeypatch.setattr(mod, "import_multihead_params", lambda path: mh)
        return ["--agegender-pb", pb]
    files = weights[backend][1]
    if backend in ("converted_pb", "converted_logits_pb"):
        return ["--age-pb", files[0], "--gender-pb", files[1]]
    if backend == "ssrnet":
        return ["--weights", files[0], "--gender-weights", files[1]]
    return ["--weights", files[0]]


CLI_CASES = [(b, extra) for b in ("ours", "insightface", "wide_resnet", "ssrnet", "bknet",
                                   "converted_pb", "converted_logits_pb")
             for extra in ([], ["--coral-subset"])] + [
    (b, ["--host-resize", "64"]) for b in ("wide_resnet", "ssrnet")]


@pytest.mark.parametrize("backend,extra", CLI_CASES,
                         ids=[f"{b}-{'_'.join(e) or 'plain'}" for b, e in CLI_CASES])
def test_cli_utkface_matches_jax(dataset, weights, tmp_path, monkeypatch, backend, extra):
    """The same JSON as the JAX CLI (batch 64: each size one padded batch;
    ``--host-resize`` where 64 is the backend's input size). facenet and
    agendernet run at their published sizes on the card and through
    ``evaluate_age_gender`` here."""
    d, _ = dataset
    argv = ["utkface", d, "--backend", backend] + _cli_args(
        backend, weights, tmp_path, monkeypatch) + extra
    got = json.loads(_run(tcli.main, argv + ["--device", "cpu"]))
    want = json.loads(_run(jcli.main, argv))
    assert got["backend"] == want["backend"] == backend
    _assert_same_metrics({k: v for k, v in got.items() if k != "backend"},
                         {k: v for k, v in want.items() if k != "backend"})


@pytest.mark.parametrize("backend,size", [("insightface", "112"),
                                          ("converted_logits_pb", "227"),
                                          ("bknet", "64"), ("ours", "112")])
def test_cli_utkface_host_resize_refusals_match_jax(dataset, weights, tmp_path,
                                                    monkeypatch, backend, size):
    """--host-resize for the letterboxing and per-placeholder backends, or
    at another size than the backend's own, exits with the JAX CLI's
    message."""
    d, _ = dataset
    argv = ["utkface", d, "--backend", backend, "--host-resize", size] + _cli_args(
        backend, weights, tmp_path, monkeypatch)
    _assert_same_exit(argv)


def test_cli_utkface_missing_weights_match_jax(dataset, tmp_path):
    d, _ = dataset
    _assert_same_exit(["utkface", d, "--backend", "bknet", "--weights",
                       str(tmp_path / "absent.npz")])


def _assert_same_exit(argv):
    with pytest.raises(SystemExit) as t_exit:
        tcli.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as j_exit:
        jcli.main(argv)
    assert str(t_exit.value.code) == str(j_exit.value.code)
    assert str(t_exit.value.code).startswith("error:")
