"""UTKFace age/gender benchmark.

Counterpart of ``hse_facerec_tf_tpu/eval/utkface.py``: the reference's
``utkface_test.py`` protocol. Ground truth is encoded in filenames
``{age}_{gender}_{race}_{date}.jpg`` (:348-349); the metrics are gender
accuracy, exact-Adience-bucket accuracy, ±5-years accuracy and age MAE
(:359-377), with the buckets of ``get_age_range`` (:14-20).

Each ``*_predict_fn`` builds one of the reference's nine backends
(:22-314) on ``device``: a function from an RGB uint8 batch (N, H, W, 3) to
numpy (ages (N,), P(male) (N,)). The backends that decide gender by a
comparison of their own return it as a hard 0.0/1.0, so that the shared
0.6 threshold cannot re-read it.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..pipelines.detector import resolve_device

# Adience age buckets (reference adience_age_list, utkface_test.py:15)
ADIENCE_BUCKETS: Sequence[Tuple[int, int]] = (
    (0, 2), (4, 6), (8, 12), (15, 20), (25, 32), (38, 43), (48, 53), (60, 100))


def age_to_bucket(age: float) -> int:
    """Exact reference ``get_age_range`` (``utkface_test.py:16-20``): the first
    bucket whose boundary midpoint — (this bucket's upper + next bucket's
    lower) / 2 — is >= the age; the last bucket otherwise. Boundary midpoints:
    3, 7, 13.5, 22.5, 35, 45.5, 56.5."""
    age = float(age)
    for ind in range(len(ADIENCE_BUCKETS) - 1):
        if age <= (ADIENCE_BUCKETS[ind][1] + ADIENCE_BUCKETS[ind + 1][0]) / 2:
            return ind
    return len(ADIENCE_BUCKETS) - 1


_FNAME_RE = re.compile(r"^(\d+)_(\d)_")


def parse_utkface_filename(fname: str) -> Optional[Tuple[int, int]]:
    """-> (age, gender) with gender 0=male, 1=female; None if malformed."""
    m = _FNAME_RE.match(os.path.basename(fname))
    if not m:
        return None
    return int(m.group(1)), int(m.group(2))


def read_csv_split(db_dir: str, csv_name: str = "utk_test.csv") -> List[str]:
    """The reference's CSV test-split reader (``utkface_test.py:316-330``):
    second column of ``utk_test.csv`` (header skipped), existing files only."""
    import csv

    files: List[str] = []
    with open(os.path.join(db_dir, csv_name)) as f:
        for i, row in enumerate(csv.reader(f)):
            if i == 0 or len(row) < 2:
                continue
            if os.path.exists(os.path.join(db_dir, row[1])):
                files.append(row[1])
    return files


def evaluate_age_gender(predict_fn: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]],
                        image_paths: Sequence[str], batch_size: int = 64,
                        age_range: Optional[Tuple[int, int]] = None,
                        clamp_range: Optional[Tuple[int, int]] = None,
                        clamp_to_age_range: bool = True,
                        host_resize_to: Optional[Tuple[int, int]] = None,
                        host_resize_method: str = "cv2_linear",
                        loader: Optional[Callable[[str], np.ndarray]] = None,
                        ) -> Dict[str, float]:
    """predict_fn: batch of RGB uint8 (N,H,W,3) -> (ages (N,), p_male (N,)).

    age_range: optional (lo, hi) ground-truth filter — e.g. (21, 60) for the
    CORAL-paper subset (``age_gender_identity/README.md:32``).

    Predicted ages are clamped into ``clamp_range`` when given; otherwise
    into ``age_range`` while ``clamp_to_age_range`` (the default — the
    reference's CSV-split path clamps predictions to 21-60 unconditionally,
    ``utkface_test.py:354-358``).

    host_resize_to: resize every image on the host (``ops.resize.
    resize_host``) to one (H, W) before prediction; only for backends whose
    device path starts with a plain resize to that size.

    Decoding is streamed (``loader``, default: decode the image file, on
    threads) into per-size buckets flushed at ``batch_size``; a tail is
    padded by repeating its last image, so every call sees ``batch_size``.
    """
    from ..parallel.sharding import pad_batch
    from ..utils.prefetch import bounded_thread_map

    if loader is None:
        from ..utils.image_io import imread_rgb as loader

    records = []
    for p in image_paths:
        parsed = parse_utkface_filename(p)
        if parsed is None:
            continue
        age, gender = parsed
        if age_range is not None and not (age_range[0] <= age <= age_range[1]):
            continue
        records.append((p, age, gender))

    n = len(records)
    pred_age = np.zeros(n)
    pred_male = np.zeros(n)

    def _decode(item):
        i, path = item
        im = loader(path)
        if host_resize_to is not None and im.shape[:2] != tuple(host_resize_to):
            from ..ops.resize import resize_host

            im = resize_host(im, tuple(host_resize_to), host_resize_method)
        return i, im

    def _flush(bucket):
        idxs = [i for i, _ in bucket]
        ages, p_male = predict_fn(pad_batch(np.stack([im for _, im in bucket]),
                                            batch_size)[0])
        pred_age[idxs] = np.asarray(ages)[:len(idxs)]
        pred_male[idxs] = np.asarray(p_male)[:len(idxs)]
        bucket.clear()

    buckets: Dict[Tuple[int, int], List] = {}
    decoded = bounded_thread_map(
        _decode, [(i, p) for i, (p, _, _) in enumerate(records)],
        workers=4, depth=2 * batch_size)
    for i, im in decoded:
        bucket = buckets.setdefault(im.shape[:2], [])
        bucket.append((i, im))
        if len(bucket) == batch_size:
            _flush(bucket)
    for bucket in buckets.values():
        if bucket:
            _flush(bucket)

    effective_clamp = clamp_range if clamp_range is not None else (
        age_range if clamp_to_age_range else None)
    if effective_clamp is not None:
        pred_age = np.clip(pred_age, effective_clamp[0], effective_clamp[1])

    gender_ok = bucket_ok = within5 = 0
    abs_err = 0.0
    for i, (_, true_age, true_gender) in enumerate(records):
        pred_gender = 0 if pred_male[i] >= 0.6 else 1   # is_male threshold (:76-81)
        gender_ok += pred_gender == true_gender
        bucket_ok += age_to_bucket(pred_age[i]) == age_to_bucket(true_age)
        within5 += abs(pred_age[i] - true_age) <= 5
        abs_err += abs(pred_age[i] - true_age)

    return {
        "n": n,
        "gender_accuracy": gender_ok / n if n else 0.0,
        "age_bucket_accuracy": bucket_ok / n if n else 0.0,
        "age_within5_accuracy": within5 / n if n else 0.0,
        "age_mae": abs_err / n if n else 0.0,
    }


def _batch_fn(fn, device):
    """numpy uint8 batch -> float32 on the device -> ``fn`` -> numpy outputs."""
    @torch.no_grad()
    def predict(batch):
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
        return tuple(t.to(torch.float32).cpu().numpy() for t in fn(x.to(torch.float32)))

    return predict


def _bgr(x):
    return torch.flip(x, dims=(-1,))


def _midpoints(device):
    return torch.tensor([(lo + hi) / 2 for lo, hi in ADIENCE_BUCKETS],
                        dtype=torch.float32, device=device)


def multihead_predict_fn(mh_params, face_size: int = 224, device="cuda"):
    """Standard predictor over the multi-head model (aligned crops, no
    detection — reference :22-34 feeds pre-aligned UTKFace images
    directly): cv2-linear resize to ``face_size``², rounded and clipped to
    0-255 as the reference's uint8 crop is (facial_analysis.py:95), then
    BGR minus the Caffe means."""
    from ..models.multihead import expected_age_top_k, multihead_apply
    from ..ops.preprocess import IMAGENET_MEANS_BGR
    from ..ops.resize import resize
    from ..params import to_torch
    device = resolve_device(device)
    params = to_torch(mh_params, device)
    means = torch.tensor(IMAGENET_MEANS_BGR, dtype=torch.float32, device=device)

    def fn(images):
        x = resize(images, (face_size, face_size), "cv2_linear")
        x = _bgr(torch.clamp(torch.round(x), 0.0, 255.0)) - means
        out = multihead_apply(params, x)
        return 1.0 + expected_age_top_k(out.age_probs, 2), out.gender_prob

    return _batch_fn(fn, device)


def insightface_predict_fn(ga_params, device="cuda"):
    """InsightFace gender-age backend (reference ``utkface_test.py:227-238``
    with ``insightface.py:92-132`` semantics): black letterbox + cubic
    resize to 112², IResNet fc1(202), gender/age decoded from binary
    pairs. The hard gender class is P(male) (reference: is_female =
    genders[0] < 0.5)."""
    from ..models.arcface import decode_gender_age, iresnet_embed
    from ..ops.resize import resize
    from ..params import tree_to_torch

    device = resolve_device(device)

    params = tree_to_torch(ga_params, device)

    def fn(images):
        h, w = images.shape[1], images.shape[2]
        x = images
        if w < h:       # letterbox: pad left (w<h) or top (w>h) with black
            x = torch.nn.functional.pad(x, (0, 0, h - w, 0))
        elif w > h:
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, w - h, 0))
        gender, age = decode_gender_age(iresnet_embed(params, resize(x, (112, 112),
                                                                     "cv2_cubic")))
        return age, gender

    return _batch_fn(fn, device)


def _two_pbs(age_pb: str, gender_pb: str, tap_in: str, tap_out: str, device):
    """Both graphs compiled, their constants on ``device``, and each one's
    placeholder size ((227, 227) when dynamic)."""
    from ..core.graph_compiler import compile_pb
    from ..pipelines.heads import _placeholder_hw

    graphs = []
    for pb in (age_pb, gender_pb):
        cg = compile_pb(pb, [tap_out])
        graphs.append((cg, cg.torch_params(device),
                       _placeholder_hw(cg.graph, tap_in) or (227, 227)))
    return graphs


def _adience_decode(age_prob, gender_prob, n: int):
    """Age = the argmax bucket's midpoint; P(male) = 1.0 where the gender
    output's first entry is >= 0.5, else 0.0 (:106, :145)."""
    ages = _midpoints(age_prob.device)[torch.argmax(age_prob.reshape(n, -1), dim=1)]
    p_male = (gender_prob.reshape(n, -1)[:, 0] >= 0.5).to(torch.float32)
    return ages, p_male


def converted_pb_predict_fn(age_pb: str, gender_pb: str, mean: float = 127.0,
                            device="cuda"):
    """Converted-checkpoint pb backend (reference ``utkface_test.py:113-150``,
    consuming the ``age_net.pb``/``gender_net.pb`` its :41-86 conversion
    emits): taps ``input``→``prob``, resize to 256², subtract the scalar
    mean, resize to each placeholder's size, RGB→BGR; gender male iff
    prob[0] >= 0.5; age = midpoint of the argmax Adience bucket."""
    from ..ops.resize import resize
    device = resolve_device(device)
    (age_cg, age_p, age_hw), (g_cg, g_p, g_hw) = _two_pbs(
        age_pb, gender_pb, "input", "prob", device)

    def fn(images):
        x = resize(images, (256, 256), "cv2_linear") - mean
        (age_prob,) = age_cg.fn(age_p, {"input": _bgr(resize(x, age_hw, "cv2_linear"))})
        (gender_prob,) = g_cg.fn(g_p, {"input": _bgr(resize(x, g_hw, "cv2_linear"))})
        return _adience_decode(age_prob, gender_prob, images.shape[0])

    return _batch_fn(fn, device)


def converted_logits_predict_fn(age_pb: str, gender_pb: str, device="cuda"):
    """rude-carnie converted-pb backend (reference ``utkface_test.py:89-109``):
    taps ``Placeholder``→``logits``, a direct resize to each placeholder's
    size, RGB straight in (no mean, no flip); gender male iff logits[0] >=
    0.5; age = midpoint of the argmax Adience bucket."""
    from ..ops.resize import resize
    device = resolve_device(device)
    (age_cg, age_p, age_hw), (g_cg, g_p, g_hw) = _two_pbs(
        age_pb, gender_pb, "Placeholder", "logits", device)

    def fn(images):
        (age_prob,) = age_cg.fn(age_p, {"Placeholder": resize(images, age_hw, "cv2_linear")})
        (gender_prob,) = g_cg.fn(g_p, {"Placeholder": resize(images, g_hw, "cv2_linear")})
        return _adience_decode(age_prob, gender_prob, images.shape[0])

    return _batch_fn(fn, device)


def facenet_predict_fn(ir_params, face_size: int = 160, device="cuda"):
    """FaceNet Inception-ResNet-v1 backend (reference ``utkface_test.py:
    186-225``): 160² resize, tf.image.per_image_standardization, age =
    expectation over the 101-way softmax, gender argmax (index 1 = male)."""
    from ..models.inception_resnet import inception_resnet_v1_age_gender
    from ..ops.resize import resize
    from ..params import tree_to_torch

    device = resolve_device(device)

    params = tree_to_torch(ir_params, device)
    min_sd = 1.0 / float(np.sqrt(float(face_size * face_size * 3)))

    def fn(images):
        x = resize(images, (face_size, face_size), "cv2_linear")
        sd, m = torch.std_mean(x, dim=(1, 2, 3), keepdim=True, correction=0)
        age_logits, gender_logits = inception_resnet_v1_age_gender(
            params, (x - m) / torch.clamp(sd, min=min_sd))
        ages = torch.softmax(age_logits, dim=-1) @ torch.arange(
            0.0, 101.0, device=x.device)
        return ages, torch.argmax(gender_logits, dim=1)

    return _batch_fn(fn, device)


def agendernet_predict_fn(mn2_params, face_size: int = 96, device="cuda"):
    """AgenderNet MobileNetV2 backend (reference ``utkface_test.py:240-256``):
    96² resize, Keras mobilenet_v2 preprocessing (inside the model), gender
    argmax (0 = female, a hard decision), age = expectation. The reference
    feeds cv2's BGR image straight through (:246-249): RGB here, so the
    channels are flipped."""
    from ..models.mobilenet_v2 import agendernet_apply, decode_agendernet
    from ..ops.resize import resize
    from ..params import tree_to_torch

    device = resolve_device(device)

    params = tree_to_torch(mn2_params, device)

    def fn(images):
        x = resize(_bgr(images), (face_size, face_size), "cv2_linear")
        gender, ages = decode_agendernet(*agendernet_apply(params, x))
        return ages, gender

    return _batch_fn(fn, device)


def ssrnet_predict_fn(age_params, gender_params, face_size: int = 64, device="cuda"):
    """SSR-Net backend (reference ``utkface_test.py:258-288``): 64² resize,
    per-image min-max normalization to 0-255 (cv2.normalize NORM_MINMAX),
    separate age (V=101) and gender (V=1) models; male iff gender >= 0.5.
    BGR feed, as ``agendernet_predict_fn``."""
    from ..models.ssrnet import ssrnet_apply
    from ..ops.resize import resize
    from ..params import tree_to_torch

    device = resolve_device(device)

    age_p = tree_to_torch(age_params, device)
    gender_p = tree_to_torch(gender_params, device)

    def fn(images):
        x = resize(_bgr(images), (face_size, face_size), "cv2_linear")
        lo = torch.amin(x, dim=(1, 2, 3), keepdim=True)
        hi = torch.amax(x, dim=(1, 2, 3), keepdim=True)
        x = (x - lo) / torch.clamp(hi - lo, min=1e-6) * 255.0
        ages = ssrnet_apply(age_p, x, V=101.0)
        return ages, (ssrnet_apply(gender_p, x, V=1.0) >= 0.5).to(torch.float32)

    return _batch_fn(fn, device)


def bknet_predict_fn(bk_params, device="cuda"):
    """BKNet-style backend (reference ``utkface_test.py:153-184``): 48²
    grayscale (x − 128)/255 on the host (``preprocess_bknet``), age =
    argmax of the 101-way head, male iff gender argmax == 1."""
    from ..models.bknet import bknet_apply, preprocess_bknet
    from ..params import tree_to_torch

    device = resolve_device(device)

    params = tree_to_torch(bk_params, device)

    def fn(x):
        _, gender_logits, age_logits = bknet_apply(params, x)
        return torch.argmax(age_logits, dim=1), torch.argmax(gender_logits, dim=1)

    device_fn = _batch_fn(fn, device)
    return lambda batch: device_fn(preprocess_bknet(np.asarray(batch)))


def wide_resnet_predict_fn(wrn_params, face_size: int = 64, device="cuda"):
    """WideResNet-16-8 backend (reference ``utkface_test.py:290-314``):
    cv2-linear resize to 64², gender softmax [female, male], age =
    expectation over the 101-way softmax; male iff P(female) <= 0.5 (the
    reference: female iff P(female) > 0.5, :313). BGR feed, as
    ``agendernet_predict_fn``."""
    from ..models.wide_resnet import wide_resnet_16_8
    from ..ops.resize import resize
    from ..params import tree_to_torch

    device = resolve_device(device)

    params = tree_to_torch(wrn_params, device)

    def fn(images):
        x = resize(_bgr(images), (face_size, face_size), "cv2_linear")
        gender_probs, age_probs = wide_resnet_16_8(params, x)
        ages = age_probs @ torch.arange(0.0, 101.0, device=x.device)
        return ages, (gender_probs[:, 0] <= 0.5).to(torch.float32)

    return _batch_fn(fn, device)
