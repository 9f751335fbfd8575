"""The album and video layer of the PyTorch port against the JAX package.

Setting of ``test_torch_batch.py``: seeded random weights, photo-like images
(96x128 and 128x96), minsize 20 through ``AlbumConfig(minsize=20)``,
reduced caps, 64² face crops, the JAX side jitted at Precision.HIGHEST on
the CPU and the port on the CPU with the plain twins of its kernels.

The album: three photos in two variants each (light noise, so the same
faces recur across photos), a portrait pair (a second shape bucket), a
pair whose faces are found only after the 90° retry, and a blank photo,
with modification times 0-40 days old. Required, port against JAX: the same
faces photo for photo with identical boxes, born years within 1e-3, P(male)
within 1e-4, identity cosine above 0.9999, 224²-style crops equal (the port
resizes in cv2's uint8 fixed point, ``ops/resize.py::resize_linear_u8``);
fused distance matrices within 1e-5; identical clusters, genders,
born years, gallery labels, output directories and ``public/`` set. Where a
threshold could flip a result (a linkage height, an integer part), the test
asserts the margin first.
"""

import hashlib
import json
import os
import shutil
import struct
import threading
import time

import cv2
import jax
import numpy as np
import pytest
import scipy.cluster.hierarchy as hac
import torch
from scipy.spatial.distance import squareform

from hse_facerec_tf_tpu.config import AlbumConfig as JaxAlbumConfig
from hse_facerec_tf_tpu.pipelines import album as jalbum
from hse_facerec_tf_tpu.pipelines import video as jvideo
from hse_facerec_tf_tpu.pipelines.gallery import EnrollmentGallery as JaxGallery
from hse_facerec_torch.config import AlbumConfig
from hse_facerec_torch.ops.kernels import knn as tk
from hse_facerec_torch.ops.kernels.crop import crop_resize
from hse_facerec_torch.ops.resize import resize_linear_u8
from hse_facerec_torch.pipelines import album as talbum
from hse_facerec_torch.pipelines import video as tvideo
from hse_facerec_torch.pipelines.gallery import EnrollmentGallery
from hse_facerec_torch.testing import random_multihead_params

from .test_torch_analyzer import H, W, _photo
from .test_torch_batch import _assert_same_faces, _pair

DAY = 86400.0
THRESHOLD = 0.03      # same face across variants 0.011-0.015, others >= 0.05
LANES = 4
CFG = dict(minsize=20, distance_threshold=THRESHOLD, min_no_frames=4)


def _photo_hw(seed, h, w):
    """``_photo``'s recipe at another shape."""
    rng = np.random.RandomState(seed)
    low = torch.from_numpy(rng.rand(1, 3, 8, 10).astype(np.float32) * 255)
    img = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear")
    img = img[0].permute(1, 2, 0).numpy() + rng.randn(h, w, 3) * 8
    return np.clip(img, 0, 255).round().astype(np.uint8)


def _variant(img, seed):
    rng = np.random.RandomState(seed)
    return np.clip(img.astype(np.int16) + rng.randint(-3, 4, img.shape),
                   0, 255).astype(np.uint8)


def _album_photos():
    """name -> (RGB photo, age in days). Photo 9 finds no face upright nor
    turned by 180°, and two after the 90° turn (np.rot90(img, 3)) with these
    weights; stored turned by 90° (r2, a portrait), it finds them only after
    the 270° turn."""
    a, b, r, p = _photo(2), _photo(5), _photo(9), _photo_hw(2, W, H)
    return {"a0": (a, 40), "a1": (_variant(a, 1), 0), "b0": (b, 35),
            "b1": (_variant(b, 2), 3), "p0": (p, 30), "p1": (_variant(p, 3), 1),
            "r0": (r, 20), "r1": (_variant(r, 4), 0),
            "r2": (np.ascontiguousarray(np.rot90(_variant(r, 5), 1)), 12),
            "z_blank": (np.zeros((H, W, 3), np.uint8), 5)}


def _clip_frames(n=30):
    a = _photo(2)
    return [_variant(a, 10 + i % 3) for i in range(n)]


def _write_clip(path, frames, fps=10):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        writer.write(np.ascontiguousarray(f[:, :, ::-1]))
    writer.release()


@pytest.fixture(scope="module")
def album_src(tmp_path_factory):
    root = tmp_path_factory.mktemp("album_src")
    now = time.time() - 3600
    for name, (img, days) in _album_photos().items():
        path = root / f"{name}.png"
        cv2.imwrite(str(path), img[:, :, ::-1])
        os.utime(path, (now - days * DAY, now - days * DAY))
    return root


@pytest.fixture
def album(album_src, tmp_path):
    """A fresh copy of the album (mtimes kept): runs write into it."""
    dst = tmp_path / "album"
    shutil.copytree(album_src, dst)
    return dst


@pytest.fixture(scope="module")
def analyzers():
    """(JAX, port) analyzers of ``test_torch_batch``'s "fits" case."""
    return _pair("fits", random_multihead_params(np.random.RandomState(100)))


def _organizers(analyzers, gallery_pair=(None, None), **kw):
    jax_an, an = analyzers
    return (jalbum.AlbumOrganizer(jax_an, JaxAlbumConfig(**CFG), analyze_batch=LANES,
                                  gallery=gallery_pair[0], **kw),
            talbum.AlbumOrganizer(an, AlbumConfig(**CFG), analyze_batch=LANES,
                                  gallery=gallery_pair[1], **kw))


def _record_boxes(org):
    """Boxes per analyzed image with faces (keyed by its bytes, so the
    rotated image a retried photo is cut from keys apart), recorded as the
    organizer assembles its outputs. A photo with no face in any
    orientation is left out: the batch retry hands it over turned by 270°,
    the single-image retry upright (in both packages), and it yields no
    output either way."""
    boxes = {}
    assemble = org._faces_to_outputs

    def record(img, faces, content_w=None):
        if faces:
            key = hashlib.sha1(np.ascontiguousarray(img).tobytes()).hexdigest()
            boxes[(key, img.shape)] = [f.bbox for f in faces]
        return assemble(img, faces, content_w)

    org._faces_to_outputs = record
    return boxes


def _assert_same_album_faces(got, want):
    assert got.files == want.files
    assert got.indices == want.indices
    assert got.private_photo_indices == want.private_photo_indices
    assert [tuple(m) for m in got.mdates] == [tuple(m) for m in want.mdates]
    np.testing.assert_allclose(got.born_years, want.born_years, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.genders, want.genders, atol=1e-4, rtol=0)
    cos = np.sum(np.asarray(got.features) * np.asarray(want.features), axis=1)
    assert cos.min() > 0.9999
    assert len(got.facial_images) == len(want.facial_images)
    for g, w in zip(got.facial_images, want.facial_images):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


def _assert_margin(values, thresholds, margin, what):
    """No value within ``margin`` of a threshold: a difference below the
    margin cannot flip the result compared next."""
    if not len(values):
        return
    gaps = np.abs(np.subtract.outer(np.asarray(values, np.float64),
                                    np.asarray(thresholds, np.float64)))
    assert gaps.min() > margin, f"{what}: a value lies {gaps.min():.3g} from a threshold"


# ---------- the distance matrix and the host resize ----------

def _assert_same_distances(got, want):
    """Within 1e-5, except where float32 cancellation in |a|² + |b|² - 2 a·b
    (both packages compute it so) dominates: the squared distances agree
    within 1e-6, so a pair d apart agrees within 1e-6 / 2d, which passes
    1e-5 only below d = 0.05, far from any clustering threshold. On the
    diagonal either side holds the square root of a rounding residual,
    about 1e-3 at most and unread by HAC (``squareform(checks=False)``
    drops it)."""
    off = ~np.eye(len(got), dtype=bool)
    d = np.minimum(got[off], want[off])
    assert np.all(np.abs(got[off] - want[off]) <= np.maximum(1e-5, 1e-6 / (2 * d)))
    assert np.abs(np.diag(got)).max() < 2e-3 and np.abs(np.diag(want)).max() < 2e-3


def test_fused_distance_matrix_matches_jax():
    rng = np.random.RandomState(5)
    feats = rng.randn(40, 1024)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    born = 1990 + rng.rand(40) * 30
    indices = list(rng.randint(0, 12, 40))
    mdates = [time.gmtime(1.5e9 + i * 40 * DAY) for i in range(12)]
    # a near duplicate (the same face in the same photo, no age penalty)
    feats[7], born[7], indices[7] = feats[3] + 1e-4 * rng.randn(1024), born[3], indices[3]
    got = talbum.fused_distance_matrix(feats, born, indices, mdates, 0.1, device="cpu")
    want = jalbum.fused_distance_matrix(feats, born, indices, mdates, 0.1)
    assert got.dtype == want.dtype == np.float64
    _assert_same_distances(got, want)
    np.testing.assert_allclose(got, got.T, atol=1e-5, rtol=0)


@pytest.mark.parametrize("src,dst", [((160, 150), (224, 224)), ((40, 30), (224, 224)),
                                     ((480, 640), (240, 320)), ((97, 131), (64, 20)),
                                     ((1200, 900), (640, 480)), ((300, 200), (224, 224)),
                                     ((960, 1280), (480, 640)), ((1080, 1920), (480, 640)),
                                     ((3, 3), (224, 224))])
@pytest.mark.parametrize("channels", [3, None])
def test_host_resize_equals_cv2(src, dst, channels):
    """``resize_linear_u8`` against ``cv2.resize`` (INTER_LINEAR) of uint8
    (H, W, 3) and (H, W) images: equal bit for bit, at down- and upscales,
    the album's 224² crops, the video fit and exact 2x downscales (where
    cv2 takes its area path)."""
    rng = np.random.RandomState(sum(src))
    shape = src + ((channels,) if channels else ())
    img = cv2.GaussianBlur((rng.rand(*shape) * 255).astype(np.uint8), (0, 0), 1.5)
    noisy = (rng.rand(*shape) * 255).astype(np.uint8)
    for im in (img, noisy):
        got = resize_linear_u8(im, dst)
        want = cv2.resize(im, (dst[1], dst[0]))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_downscales_match_jax(analyzers):
    """The album's letterboxed ``_maybe_downscale`` and video's distorting
    ``_downscale`` against the JAX package's cv2 resizes: the same shapes,
    content box and pixels, at 300x500 and at an exact 2x."""
    jorg, torg = _organizers(analyzers, downscale=(128, 96))
    for h, w in ((300, 500), (192, 256)):
        big = _photo_hw(7, h, w)
        (g, g_hw), (want, w_hw) = torg._maybe_downscale(big), jorg._maybe_downscale(big)
        assert g.shape == (96, 128, 3) and tuple(g_hw) == tuple(w_hw)
        np.testing.assert_array_equal(g, want)
    small = _photo(3)
    assert torg._maybe_downscale(small)[0] is small
    for h, w in ((300, 500), (480, 640)):
        big = _photo_hw(7, h, w)
        g, want = tvideo._downscale(big, 320, 240), jvideo._downscale(big, 320, 240)
        assert g.shape == (240, 320, 3)
        np.testing.assert_array_equal(g, want)
    assert tvideo._downscale(small) is small


def _mp4_with_rotation(path, matrix_ab):
    """A file holding one ``tkhd`` box (version 0) whose matrix starts with
    (a, b) in 16.16 fixed point."""
    a, b = (int(v * 65536) for v in matrix_ab)
    body = (b"tkhd" + bytes(4) + bytes(20) + bytes(8) + bytes(8)
            + struct.pack(">9i", a, b, 0, -b, a, 0, 0, 0, 1 << 30))
    path.write_bytes(b"\x00\x00\x00\x10ftypisom" + bytes(4) + body)


def test_image_io_helpers_match_jax(tmp_path):
    """``imread_rgb_bounded`` (DCT-reduced JPEG decode), the EXIF and video
    rotation probes, ``apply_orientation``, ``rotate_image`` and
    ``bgr_to_rgb``: the port's copies against the JAX package's."""
    from PIL import Image

    from hse_facerec_tf_tpu.utils import image_io as jio
    from hse_facerec_torch.utils import image_io as tio

    big = cv2.GaussianBlur(_photo_hw(4, 1500, 2400), (0, 0), 3)
    jpg, png = tmp_path / "big.jpg", tmp_path / "big.png"
    cv2.imwrite(str(jpg), big[:, :, ::-1])
    cv2.imwrite(str(png), big[:, :, ::-1])
    for path in (jpg, png):
        got = tio.imread_rgb_bounded(str(path), 640, 480)
        np.testing.assert_array_equal(got, jio.imread_rgb_bounded(str(path), 640, 480))
    assert tio.imread_rgb_bounded(str(jpg), 640, 480).shape == (750, 1200, 3)
    exif = Image.Exif()
    exif[0x0112] = 6
    rotated = tmp_path / "exif.jpg"
    Image.fromarray(_photo(1)).save(rotated, exif=exif)
    assert tio.exif_orientation(str(rotated)) == jio.exif_orientation(str(rotated)) == 6
    assert tio.exif_orientation(str(png)) == 1
    img = _photo(1)
    for o in (1, 3, 6, 8):
        np.testing.assert_array_equal(tio.apply_orientation(img, o),
                                      jio.apply_orientation(img, o))
    for deg, ab in ((0, (1, 0)), (90, (0, 1)), (180, (-1, 0)), (270, (0, -1))):
        clip = tmp_path / f"r{deg}.mp4"
        _mp4_with_rotation(clip, ab)
        assert tio.video_rotation(str(clip)) == jio.video_rotation(str(clip)) == deg
        np.testing.assert_array_equal(tio.rotate_image(img, deg), jio.rotate_image(img, deg))
    assert tio.video_rotation(str(png)) == 0
    np.testing.assert_array_equal(tio.bgr_to_rgb(img), cv2.cvtColor(img, cv2.COLOR_BGR2RGB))


# ---------- the scan ----------

def test_scan_album_matches_jax(album, analyzers):
    jorg, torg = _organizers(analyzers)
    want_boxes, got_boxes = _record_boxes(jorg), _record_boxes(torg)
    crop_resize.launches = 0
    want = jorg.scan_album(str(album), use_cache=False)
    got = torg.scan_album(str(album), use_cache=False)
    _assert_same_album_faces(got, want)
    assert got_boxes == want_boxes
    assert crop_resize.launches == 0          # the CPU runs K1's plain twin
    files = got.files
    per_photo = {f: got.indices.count(i) for i, f in enumerate(files)}
    assert per_photo["z_blank.png"] == 0
    assert per_photo["r0.png"] and per_photo["r1.png"] and per_photo["r2.png"]
    assert per_photo["p0.png"] > 0 and per_photo["a0.png"] > 0
    assert len(got.facial_images[0]) == analyzers[1].face_size


@pytest.mark.parametrize("name,rotation", [("r0", 90), ("r2", 270)])
def test_rotation_retry_crops_from_the_turned_photo(analyzers, name, rotation):
    """A photo with faces only after the 90° (or 270°) turn: the batch retry
    (rotated on the device by ``torch.rot90``) reports the turn and boxes in
    ``np.rot90(img, 3)``'s (``np.rot90(img, 1)``'s) frame, and the album
    cuts its crops there."""
    _, an = analyzers
    img = _album_photos()[name][0]
    assert an.analyze(img) == []
    [(faces, rot)] = an.analyze_batch_retry_padded(img[None], LANES)
    turned = np.ascontiguousarray(np.rot90(img, 3 if rotation == 90 else 1))
    assert rot == rotation and faces
    _assert_same_faces(faces, an.analyze(turned))
    torg = talbum.AlbumOrganizer(an, AlbumConfig(**CFG))
    crops, *_ = torg._process_photo(img)
    want, *_ = torg._faces_to_outputs(turned, faces)
    assert len(crops) == len(faces)
    for c, w in zip(crops, want):
        np.testing.assert_array_equal(c, w)


def test_batched_scan_equals_sequential(album, analyzers):
    _, an = analyzers
    batched = talbum.AlbumOrganizer(an, AlbumConfig(**CFG), analyze_batch=LANES)
    seq = talbum.AlbumOrganizer(an, AlbumConfig(**CFG), analyze_batch=1)
    b_boxes, s_boxes = _record_boxes(batched), _record_boxes(seq)
    _assert_same_album_faces(batched.scan_album(str(album), use_cache=False),
                             seq.scan_album(str(album), use_cache=False))
    assert b_boxes == s_boxes


def test_two_flush_threads_equal_one_worker(album, analyzers):
    """Two flush threads on one analyzer: the first two flushes are held
    until both are inside ``analyze_batch_retry_padded`` at once, and the
    scan equals a one-worker scan photo for photo, bit for bit."""
    _, an = analyzers
    scans = {}
    for workers in (1, 2):
        org = talbum.AlbumOrganizer(an, AlbumConfig(**CFG), analyze_batch=2)
        org.flush_workers = workers
        barrier = threading.Barrier(workers, timeout=60)
        threads, calls = set(), []
        retry = an.analyze_batch_retry_padded

        def held(images, lanes, retry=retry, barrier=barrier, threads=threads,
                 calls=calls):
            calls.append(1)
            threads.add(threading.get_ident())
            if len(calls) <= 2:
                barrier.wait()
            return retry(images, lanes)

        org.analyzer = an.with_minsize(an.detector.minsize)
        org.analyzer.analyze_batch_retry_padded = held
        scans[workers] = org.scan_album(str(album), use_cache=False)
        assert len(threads) == workers and len(calls) >= 4
    one, two = scans[1], scans[2]
    assert one.indices == two.indices and one.private_photo_indices == two.private_photo_indices
    for name in ("born_years", "genders", "features"):
        np.testing.assert_array_equal(getattr(two, name), getattr(one, name))
    for g, w in zip(two.facial_images, one.facial_images):
        np.testing.assert_array_equal(g, w)


def test_retained_photo_cap_flushes_the_fullest_bucket_early(tmp_path, analyzers):
    """Six shapes, three photos each in turn, then one more of the first
    shape: past 4 x ``analyze_batch`` retained photos the fullest bucket
    flushes before it fills, so the last photo opens a bucket of its own;
    the scan still equals the sequential one."""
    _, an = analyzers
    widths = [100, 104, 108, 112, 116, 120]
    for i in range(19):
        w = widths[i % 6] if i < 18 else widths[0]
        cv2.imwrite(str(tmp_path / f"p{i:02d}.png"), _photo_hw(40 + i, H, w)[:, :, ::-1])
    org = talbum.AlbumOrganizer(an, AlbumConfig(**CFG), analyze_batch=4)
    org.analyzer = an.with_minsize(an.detector.minsize)
    sizes, retry = [], an.analyze_batch_retry_padded
    org.analyzer.analyze_batch_retry_padded = lambda images, lanes: sizes.append(
        len(images)) or retry(images, lanes)
    got = org.scan_album(str(tmp_path), use_cache=False)
    assert sorted(sizes) == [1, 3, 3, 3, 3, 3, 3]
    seq = talbum.AlbumOrganizer(an, AlbumConfig(**CFG), analyze_batch=1)
    _assert_same_album_faces(got, seq.scan_album(str(tmp_path), use_cache=False))
    assert len(got.indices) > 0


def test_downscaled_scan_matches_jax(album, analyzers):
    """With ``downscale`` set and every photo inside the bounds (nothing
    resized), the scan equals the JAX package's."""
    jorg, torg = _organizers(analyzers, downscale=(128, 128))
    _assert_same_album_faces(torg.scan_album(str(album), use_cache=False),
                             jorg.scan_album(str(album), use_cache=False))


def test_oversample_scan_matches_jax(album, analyzers):
    """An oversample analyzer, which the resident retry refuses, takes the
    deferred two-pass rotation retry after the sweep, in both packages."""
    jax_an, an = _pair("fits", random_multihead_params(np.random.RandomState(100)),
                       oversample=True)
    jorg = jalbum.AlbumOrganizer(jax_an, JaxAlbumConfig(**CFG), analyze_batch=LANES)
    torg = talbum.AlbumOrganizer(an, AlbumConfig(**CFG), analyze_batch=LANES)
    retried = []
    retry = torg._batched_rotation_retry
    torg._batched_rotation_retry = lambda entries, per_photo: retried.extend(
        i for i, _, _ in entries) or retry(entries, per_photo)
    want_boxes, got_boxes = _record_boxes(jorg), _record_boxes(torg)
    got = torg.scan_album(str(album), use_cache=False)
    _assert_same_album_faces(got, jorg.scan_album(str(album), use_cache=False))
    assert got_boxes == want_boxes
    assert sorted(got.files[i] for i in retried) == ["r0.png", "r1.png", "r2.png",
                                                     "z_blank.png"]


def test_batched_rotation_retry_pair_branch_matches_jax(analyzers):
    """``_batched_rotation_retry`` called directly with an analyzer that
    takes the rotation pair from one upload (90° first, 270° for photos
    still without a face)."""
    photos = _album_photos()
    entries = [(i, photos[k][0], photos[k][0].shape[:2])
               for i, k in enumerate(("r0", "z_blank", "r1", "a0"))]
    jorg, torg = _organizers(analyzers)
    got, want = {}, {}
    want_boxes, got_boxes = _record_boxes(jorg), _record_boxes(torg)
    torg._batched_rotation_retry(entries, got)
    jorg._batched_rotation_retry(entries, want)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    assert got_boxes == want_boxes and got_boxes
    for i in got:
        g_crops, g_ages, g_genders, g_feats, g_big = got[i]
        w_crops, w_ages, w_genders, w_feats, w_big = want[i]
        assert len(g_crops) == len(w_crops) and g_big == w_big
        np.testing.assert_allclose(g_ages, w_ages, atol=1e-3, rtol=0)
        np.testing.assert_allclose(g_genders, w_genders, atol=1e-4, rtol=0)
    assert got[1][1] == [] and got[0][1]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_features_cache_read_across_packages(album, analyzers, writer):
    """``features.npz`` written by one package is read by the other without
    a scan; both return the same faces."""
    jorg, torg = _organizers(analyzers)
    first, second = (torg, jorg) if writer == "port" else (jorg, torg)
    wrote = first.scan_album(str(album), use_cache=True)
    assert os.path.exists(album / "features.npz")
    second._analyze_photos = lambda *a: pytest.fail("the cache was not read")
    read = second.scan_album(str(album), use_cache=True)
    _assert_same_album_faces(read, wrote)


# ---------- video ----------

class _FrameCapture:
    """A capture over decoded BGR frames, as ``_open_video`` may return."""

    def __init__(self, frames):
        self.frames, self.pos, self.released = list(frames), 0, False

    def isOpened(self):
        return not self.released

    def grab(self):
        self.pos += 1
        return self.pos <= len(self.frames)

    def retrieve(self):
        return True, self.frames[self.pos - 1]

    def read(self):
        ok = self.grab()
        return ok, self.frames[self.pos - 1] if ok else None

    def release(self):
        self.released = True


def _decoded(path):
    cap, frames = cv2.VideoCapture(str(path)), []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def _assert_same_video_outputs(got, want):
    g_crops, g_ages, g_genders, g_feats, g_any = got
    w_crops, w_ages, w_genders, w_feats, w_any = want
    assert g_any == w_any and g_ages == w_ages
    np.testing.assert_allclose(g_genders, w_genders, atol=1e-4, rtol=0)
    for a, b in zip(g_crops, w_crops):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(g_feats, w_feats):
        assert np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.9999
    assert len(g_crops) == len(w_crops) == len(g_feats) == len(w_feats)


def _record_video(org, monkeypatch):
    """The per-face ages ``process_video`` sees, in order, and the clusters
    it forms."""
    ages, clusters = [], []
    assemble, cluster = org._faces_to_outputs, talbum.get_facial_clusters

    def record(img, faces, content_w=None):
        ages.extend(f.age for f in faces)
        return assemble(img, faces, content_w)

    org._faces_to_outputs = record
    monkeypatch.setattr(talbum, "get_facial_clusters",
                        lambda *a, **kw: clusters.append(cluster(*a, **kw)) or clusters[-1])
    return ages, clusters


def test_process_video_matches_jax_and_sequential(tmp_path, analyzers, monkeypatch):
    """The batched frame scan (candidates analyzed ahead, the adaptive skip
    replayed) equals the sequential policy and the JAX package's, on a clip
    cv2 decodes on both sides; a capture handed in through ``_open_video``
    gives the same outputs without cv2."""
    path = tmp_path / "clip.mp4"
    _write_clip(path, _clip_frames())
    mdate = time.gmtime(1.6e9)
    jorg, torg = _organizers(analyzers)
    seq = talbum.AlbumOrganizer(analyzers[1], AlbumConfig(**CFG), analyze_batch=1)
    ages, clusters = _record_video(torg, monkeypatch)
    got = torg.process_video(str(path), mdate)
    assert got[4] and len(got[0]) >= 1
    # a cluster's age is the integer part of its median age: check the margin
    medians = [np.median(np.asarray(ages)[c]) for c in clusters[0]
               if len(c) >= CFG["min_no_frames"]]
    assert len(medians) == len(got[1])
    _assert_margin(np.asarray(medians) % 1.0, [0.0, 1.0], 1e-3, "median ages")
    want = jorg.process_video(str(path), mdate)
    _assert_same_video_outputs(got, want)
    _assert_same_video_outputs(seq.process_video(str(path), mdate), got)
    frames = _decoded(path)
    torg._open_video = lambda p: _FrameCapture(frames)
    _assert_same_video_outputs(torg.process_video("clip.mp4", mdate), got)


def test_video_resolution_change_batched_equals_sequential(analyzers):
    """A capture whose frames change shape midway: the batched scan flushes
    at the change and still equals the sequential policy."""
    _, an = analyzers
    a, b = _photo(2), _photo_hw(6, H, 120)
    frames = [np.ascontiguousarray(_variant(a if i < 14 else b, 20 + i)[:, :, ::-1])
              for i in range(30)]
    outs = []
    for lanes in (LANES, 1):
        org = talbum.AlbumOrganizer(an, AlbumConfig(**CFG), analyze_batch=lanes)
        org._open_video = lambda path: _FrameCapture(frames)
        outs.append(org.process_video("clip.mp4", time.gmtime(1.6e9)))
    _assert_same_video_outputs(*outs)


# ---------- the whole album ----------

def _galleries(analyzers, album_dir, tmp_path):
    """An int8 gallery in each package holding one face of photo a0 and one
    of b0 ("ann", "bob"), from the port's own scan."""
    _, an = analyzers
    faces = talbum.AlbumOrganizer(an, AlbumConfig(**CFG)).scan_album(
        str(album_dir), use_cache=False)
    pick = [faces.indices.index(faces.files.index(f)) for f in ("a0.png", "b0.png")]
    labels, feats = ["ann", "bob"], faces.features[pick].astype(np.float32)
    tg = EnrollmentGallery(str(tmp_path / "port.npz"), device="cpu")
    jg = JaxGallery(str(tmp_path / "jax.npz"))
    tg.enroll_many(labels, feats)
    jg.enroll_many(labels, feats)
    assert tg.quantized and jg.quantized
    return jg, tg


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_process_album_matches_jax(album_src, analyzers, tmp_path):
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp_path / side
        shutil.copytree(album_src, dirs[side])
        clip = dirs[side] / "clip.mp4"
        _write_clip(clip, _clip_frames())
        os.utime(clip, (time.time() - 10 * DAY,) * 2)
    jorg, torg = _organizers(analyzers, _galleries(analyzers, album_src, tmp_path))
    seen = []
    cluster = torg.perform_clustering
    torg.perform_clustering = lambda faces, *a, **kw: seen.append(faces) or cluster(
        faces, *a, **kw)
    before = tk.nearest_neighbor_int8p.launches
    got = torg.process_album(str(dirs["port"]), use_cache=False)
    assert tk.nearest_neighbor_int8p.launches == before       # CPU: the twin
    # the margins before the comparison: linkage heights against the
    # threshold, born years against their integer parts
    [faces] = seen
    dist = talbum.fused_distance_matrix(faces.features, faces.born_years,
                                        faces.indices, faces.mdates, device="cpu")
    heights = hac.linkage(squareform(dist, checks=False), "single")[:, 2]
    _assert_margin(heights, [THRESHOLD], 1e-3, "linkage heights")
    years = [float(np.median(faces.born_years[c])) for c in got["clusters"]]
    _assert_margin(np.asarray(years) % 1.0, [0.0, 1.0], 1e-3, "born years")
    want = jorg.process_album(str(dirs["jax"]), use_cache=False)
    for key in ("n_photos", "n_videos", "n_faces", "clusters", "cluster_genders",
                "cluster_born_years", "cluster_labels"):
        assert got[key] == want[key], key
    assert got["n_videos"] == 1 and len(got["clusters"]) >= 4
    assert "ann" in got["cluster_labels"] and "bob" in got["cluster_labels"]
    assert None in got["cluster_labels"]
    assert _tree(dirs["port"] / "clusters") == _tree(dirs["jax"] / "clusters")
    public = sorted(os.listdir(dirs["port"] / "clusters" / "public"))
    assert public == ["z_blank.png"]
    assert set(got["timings"]["phases"]) == set(want["timings"]["phases"])
    assert "photo.analyze_batch" in got["timings"]["stages"]


def test_label_clusters_keeps_results_on_a_gallery_of_another_dim(analyzers, tmp_path):
    _, an = analyzers
    gallery = EnrollmentGallery(str(tmp_path / "g.npz"), device="cpu")
    gallery.enroll("x", np.ones(8, np.float32))
    org = talbum.AlbumOrganizer(an, AlbumConfig(**CFG), gallery=gallery)
    faces = talbum.AlbumFaces(["a"], [time.gmtime(0)], [], np.zeros(2), np.zeros(2),
                              np.ones((2, 1024)), [0, 0], [])
    with pytest.warns(RuntimeWarning, match="naming skipped"):
        assert org._label_clusters(faces, [[0, 1]]) == [None]


# ---------- the demo surfaces ----------

def _assert_same_annotated(got, want):
    assert len(got) == len(want)
    for (g_img, g_faces), (w_img, w_faces) in zip(got, want):
        _assert_same_faces(g_faces, w_faces)
        ages = [f.age for f in g_faces]
        _assert_margin(np.asarray(ages) % 1.0, [0.5], 1e-3, "ages drawn")
        np.testing.assert_array_equal(g_img, w_img)


@pytest.mark.parametrize("batch", [1, 3])
def test_annotated_video_frames_match_jax(tmp_path, analyzers, batch):
    jax_an, an = analyzers
    path = tmp_path / "clip.mp4"
    _write_clip(path, _clip_frames(23))
    got = list(tvideo.annotated_video_frames(an, str(path), frame_skip=2, batch=batch))
    want = list(jvideo.annotated_video_frames(jax_an, str(path), frame_skip=2,
                                              batch=batch))
    assert len(got) == 11
    _assert_same_annotated([(a, f) for a, f in got], [(a, f) for a, f in want])


def test_process_image_dir_matches_jax(album_src, analyzers):
    jax_an, an = analyzers
    got = list(tvideo.process_image_dir(an, str(album_src), batch=3))
    want = list(jvideo.process_image_dir(jax_an, str(album_src), batch=3))
    assert [n for n, _, _ in got] == [n for n, _, _ in want] == sorted(
        f"{k}.png" for k in _album_photos())
    _assert_same_annotated([(a, f) for _, a, f in got], [(a, f) for _, a, f in want])


def test_annotated_camera_frames(analyzers, monkeypatch):
    """The webcam loop on a fake camera: frames BGR -> RGB, analyzed one by
    one, until the camera stops."""
    _, an = analyzers
    frames = [np.ascontiguousarray(_photo(2)[:, :, ::-1]), np.zeros((H, W, 3), np.uint8)]
    cams = []
    monkeypatch.setattr(cv2, "VideoCapture",
                        lambda i: cams.append(_FrameCapture(frames)) or cams[-1])
    out = list(tvideo.annotated_camera_frames(an, 0))
    assert len(out) == 2 and out[1][1] == [] and cams[0].released
    _assert_same_faces(out[0][1], an.analyze(_photo(2)))


# ---------- the CLI ----------

class _Stop(Exception):
    pass


def test_cli_album_minsize_default(tmp_path, monkeypatch):
    """``album`` builds its engine with the reference album's minsize 112
    (``process_photos.py:385``) unless ``--minsize`` says otherwise."""
    from hse_facerec_torch import cli

    seen = {}

    def fake_build(args):
        seen["minsize"] = args.minsize
        raise _Stop

    monkeypatch.setattr(cli, "_build_analyzer", fake_build)
    (tmp_path / "x.jpg").write_bytes(b"")
    for argv, want in ((["album", str(tmp_path)], 112),
                       (["album", str(tmp_path), "--minsize", "40"], 40),
                       (["analyze", str(tmp_path / "x.jpg")], 40)):
        with pytest.raises(_Stop):
            cli.main(argv)
        assert seen.pop("minsize") == want, argv


@pytest.mark.parametrize("argv", [["album", "d"], ["images", "d", "o"],
                                  ["video", "v.mp4"], ["webcam"], ["cluster", "d"]])
def test_cli_new_subcommands_default_to_cuda(argv, monkeypatch):
    from hse_facerec_torch import cli
    from hse_facerec_torch.models import zoo

    seen = []

    def stop(*args, device=None, **kw):
        seen.append(device or args[0].device)
        raise _Stop

    monkeypatch.setattr(cli, "_build_analyzer", stop)
    monkeypatch.setattr(zoo, "build_extractor", stop)
    with pytest.raises(_Stop):
        cli.main(argv)
    assert seen == ["cuda"]


@pytest.mark.parametrize("extra,want", [([], False), (["--oversample"], True)])
def test_cli_oversample_reaches_the_analyzer(tmp_path, monkeypatch, extra, want):
    from hse_facerec_torch import cli

    seen = {}

    def build(*args, **kw):
        seen.update(kw)
        raise _Stop

    monkeypatch.setattr(talbum.FacialAnalyzer, "from_reference_models", build)
    pbs = [tmp_path / "m.pb", tmp_path / "a.pb"]
    for pb in pbs:
        pb.write_bytes(b"")
    with pytest.raises(_Stop):
        cli.main(["album", str(tmp_path), "--device", "cpu", "--mtcnn-pb", str(pbs[0]),
                  "--agegender-pb", str(pbs[1]), *extra])
    assert seen["oversample"] is want and seen["minsize"] == 112


def test_cli_album_images_video_webcam_on_cpu(album_src, analyzers, tmp_path, capsys,
                                               monkeypatch):
    """The new subcommands end to end with ``--device cpu`` on the port's
    CPU analyzer (the weights patched in, as the JAX package's CLI tests
    do), an int8 gallery naming the album's clusters."""
    from hse_facerec_torch import cli

    _, an = analyzers
    built = []
    monkeypatch.setattr(cli, "_build_analyzer",
                        lambda args: built.append(args.device) or an)
    _, tg = _galleries(analyzers, album_src, tmp_path)
    album = tmp_path / "album"
    shutil.copytree(album_src, album)
    cli.main(["album", str(album), "--device", "cpu", "--minsize", "20",
              "--threshold", str(THRESHOLD), "--batch-size", "4", "--no-cache",
              "--gallery", tg.path])
    out = capsys.readouterr().out
    result = json.loads(out[:out.rindex("}") + 1])
    assert result["n_faces"] > 0 and "ann" in result["cluster_labels"]
    assert any(d.startswith("ann ") for d in os.listdir(album / "clusters"))
    assert os.path.exists(album / "clusters" / "montage.png")

    cli.main(["images", str(album_src), str(tmp_path / "annotated"), "--device", "cpu",
              "--batch", "3", "--gallery", tg.path])
    assert sorted(os.listdir(tmp_path / "annotated")) == sorted(
        f"{k}.png" for k in _album_photos())

    clip = tmp_path / "clip.mp4"
    _write_clip(clip, _clip_frames(12))
    cli.main(["video", str(clip), "--out", str(tmp_path / "out.mp4"), "--device", "cpu",
              "--frame-skip", "3"])
    assert len(_decoded(tmp_path / "out.mp4")) == 4
    with pytest.raises(SystemExit):
        cli.main(["video", str(clip), "--frame-skip", "0", "--device", "cpu"])

    shown = []
    frames = _decoded(clip)[:2]
    monkeypatch.setattr(cv2, "VideoCapture", lambda i: _FrameCapture(frames))
    monkeypatch.setattr(cv2, "imshow", lambda name, img: shown.append(img.shape))
    monkeypatch.setattr(cv2, "waitKey", lambda ms: -1)
    monkeypatch.setattr(cv2, "destroyAllWindows", lambda: None)
    cli.main(["webcam", "--device", "cpu"])
    assert shown == [(H, W, 3)] * 2
    assert built == ["cpu"] * 4


def test_cli_cluster_on_cpu(tmp_path, capsys, monkeypatch):
    """``cluster`` over two directory-per-person datasets, scipy with the
    threshold search and rank-order, on a patched zoo entry."""
    from hse_facerec_torch import cli

    from .test_torch_identification import _patch_zoo, _png_tree

    _patch_zoo(monkeypatch, random_multihead_params(np.random.RandomState(100)))
    for k in range(2):
        _png_tree(tmp_path / f"ds{k}", np.random.RandomState(20 + k))
    sets = [str(tmp_path / "ds0" / "gallery"), str(tmp_path / "ds1" / "gallery")]
    cli.main(["cluster", *sets, "--device", "cpu", "--batch-size", "4",
              "--search-threshold"])
    cli.main(["cluster", *sets, "--device", "cpu", "--method", "rankorder"])
    text = capsys.readouterr().out
    outs, dec, pos = [], json.JSONDecoder(), 0
    while pos < len(text.strip()):
        obj, end = dec.raw_decode(text, pos)
        outs.append(obj)
        pos = end + 1
    assert "search" in outs[0] and outs[1]["method"] == "rankorder"
    for out in outs:
        assert set(out["datasets"]) == set(sets) and "mean" in out and "std" in out
        assert all(s["num_classes"] == 2 for s in out["datasets"].values())
