"""Photo/video album organizer: detect → analyze → cluster by person → output.

End-to-end product pipeline with the reference's semantics
(``age_gender_identity/process_photos.py``):
  - per photo: faces via the fused analyzer; 90°/270° retry when none found
    (:241-247); per-face born-year estimate ``photo_year - (age - 0.5)``
    (:257-258); "private" flag when a face is wide enough (:41-42);
  - per video: frame sampling with adaptive skip 5→3 (:118), rotation fix from
    container metadata, per-cluster median gender/born-year and mean feature
    (:145-153), minimum frame count per cluster;
  - clustering over all faces with the fused distance
    ``L2(features) + 0.1 · χ²-age-penalty`` (:46-51), same-photo constraint,
    cluster size + date-span filters (:66-75);
  - Dempster-Shafer gender fusion per cluster (:327);
  - outputs: ``clusters/<i> <gender> <age>/<face>.jpg`` crops (:333-342) and
    ``clusters/public/`` downscaled copies of unclustered photos (:344-358).

Feature extraction is cached per album (``features.npz`` — the reference's
``features.dump`` pickle, :220-273 — but in a safe format; the keys are the
JAX package's, so either package reads the other's file).

The port's own copy of ``hse_facerec_tf_tpu/pipelines/album.py``. The scan
runs on the batch path (``analyze_batch_retry_padded``: the detector's two
crop stages and the head crops on the crop kernel K1), the N×N feature
distances on the analyzer's device, the clustering in float64 on the host,
and cluster naming from an int8 gallery on the 1-NN kernel K2c. The scan,
video, clustering and naming paths need neither cv2 nor PIL: the 224²
output crops and the downscales use ``ops/resize.py``'s cv2 INTER_LINEAR
in cv2's uint8 fixed point (equal to ``cv2.resize``), video frames turn
BGR to RGB by reversing the channel axis, and the one cv2 call left,
opening a video file, is ``AlbumOrganizer._open_video``, which a caller
can override. cv2 and matplotlib are imported only by the functions that
decode photos or write outputs.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AlbumConfig
from ..ops.distance import pairwise_sqeuclidean
from ..ops.resize import resize_linear_u8
from ..utils.image_io import bgr_to_rgb, imread_rgb, rotate_image, video_rotation
from ..utils.profiling import StageTimer
from .analyzer import FacialAnalyzer
from .clustering import get_facial_clusters
from .detector import resolve_device
from .fusion import dempster_shafer_gender

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")
VIDEO_EXTS = (".mov", ".avi", ".mp4", ".mpg", ".mpeg", ".wmv")


def is_image(f: str) -> bool:
    return f.lower().endswith(IMAGE_EXTS)


def is_video(f: str) -> bool:
    return f.lower().endswith(VIDEO_EXTS)


@dataclasses.dataclass
class AlbumFaces:
    """Flat per-face arrays for one album (the reference's ``all_*`` lists)."""
    files: List[str]
    mdates: List[time.struct_time]
    facial_images: List[np.ndarray]      # 224² RGB crops
    born_years: np.ndarray
    genders: np.ndarray
    features: np.ndarray                 # L2-normalized
    indices: List[int]                   # photo index per face
    private_photo_indices: List[int]


def _photo_year(mdate: time.struct_time) -> float:
    return mdate.tm_year + (mdate.tm_mon - 1) / 12.0


def fused_distance_matrix(features: np.ndarray, born_years: np.ndarray,
                          indices: Sequence[int],
                          mdates: Sequence[time.struct_time],
                          age_weight: float = 0.1, device="cuda") -> np.ndarray:
    """L2 feature distance + weighted age penalty (reference :46-58), with the
    O(N²) feature part on ``device`` as one float32 matmul (parity numerics:
    no TF32) and the rest in float64 on the host, as the reference does."""
    f = torch.from_numpy(np.asarray(features, np.float32)).to(resolve_device(device))
    d_feat = np.sqrt(pairwise_sqeuclidean(f, f).cpu().numpy())
    years = np.array([mdates[i].tm_year for i in indices], dtype=np.float64)
    max_year = np.maximum(years[:, None], years[None, :])
    age_i = max_year - born_years[:, None]
    age_j = max_year - born_years[None, :]
    s = age_i + age_j
    age_pen = np.where(s != 0, (age_i - age_j) ** 2 / np.where(s != 0, s, 1.0), 0.0)
    return np.clip(d_feat + age_weight * age_pen, 0.0, None)


class AlbumOrganizer:
    """``analyze_batch``: photos sharing a (H, W) shape are analyzed in
    batches of this size through the batch path (partial batches padded
    with blank lanes to the same lane count). 1 disables batching (the
    reference's photo-at-a-time loop, ``process_photos.py:238-261``).

    ``downscale``: optional (max_w, max_h). Photos larger than this are
    aspect-preservingly resized to fit and letterboxed (black) to exactly
    (max_h, max_w) before analysis, collapsing arbitrary camera resolutions
    onto ONE analysis shape, so same-size buckets fill whatever the camera
    resolutions. (The
    reference's video path downsizes with a distorting min() rule,
    ``facial_analysis.py:653-655``; letterboxing keeps faces undistorted
    for portrait photos.) Off by default: the reference's PHOTO pipeline
    analyzes at native size, and face crops / features then derive from
    the downscaled image.

    Same-shape buckets flush on ``flush_workers`` threads (the reference's
    2), so one bucket's host work (launches, syncs, result assembly)
    overlaps another's device work. Both threads run
    ``analyze_batch_retry_padded`` on one analyzer: it mutates nothing but
    the detector's ``last_truncated`` flag (which then holds the last
    flush's value), K1's launch counter counts under a lock, and both
    threads queue on the device's current stream, so each flush's results
    equal a one-worker scan's (``tests/test_torch_album.py``)."""

    flush_workers = 2

    def __init__(self, analyzer: FacialAnalyzer, config: Optional[AlbumConfig] = None,
                 analyze_batch: int = 8,
                 downscale: Optional[Tuple[int, int]] = None,
                 gallery=None):
        self.analyzer = analyzer
        self.config = config or AlbumConfig()
        self.analyze_batch = max(1, int(analyze_batch))
        self.downscale = downscale
        self.gallery = gallery
        # per-stage wall-time split of the product loop (VERDICT-4 #3: the
        # scan was "99% host-bound" with no attribution); ``process_album``
        # returns the aggregate under result["timings"]. Stage samples from
        # concurrent decode/flush threads OVERLAP, so per-stage totals can
        # exceed the phase wall time — compare shapes, not sums.
        self.timer = StageTimer()
        det_minsize = getattr(getattr(analyzer, "detector", None),
                              "minsize", None)
        if det_minsize is not None and det_minsize != self.config.minsize:
            # AlbumConfig.minsize is AUTHORITATIVE (reference album parity:
            # the engine is constructed with minsize=112,
            # process_photos.py:385): reclone the engine at the config's
            # value (shares heads/params; the caller's analyzer is
            # untouched). Set AlbumConfig(minsize=...) to scan smaller faces.
            self.analyzer = analyzer.with_minsize(self.config.minsize)

    def _read_photo(self, path: str) -> np.ndarray:
        """Photo decode for the album scan. With ``--downscale`` active,
        large JPEGs decode at a reduced DCT scale that still covers the
        analysis box (``imread_rgb_bounded`` — ~8× faster on multi-MP
        camera files); ``_maybe_downscale`` then does the exact final fit.
        Without downscaling, full decode (reference native-size semantics)."""
        if self.downscale is None:
            return imread_rgb(path)
        from ..utils.image_io import imread_rgb_bounded

        return imread_rgb_bounded(path, *self.downscale)

    def _maybe_downscale(self, img: np.ndarray):
        """Returns ``(img, content_hw)``: the (possibly letterboxed) analysis
        image plus the (h, w) of the real photo content inside it — the
        letterbox padding must not count toward the big-face width fraction
        (reference ``min_face_width_percent`` divides by the PHOTO width,
        ``process_photos.py:41-42``)."""
        if self.downscale is None:
            return img, img.shape[:2]
        max_w, max_h = self.downscale
        h, w = img.shape[:2]
        if w <= max_w and h <= max_h:
            return img, (h, w)
        s = min(max_w / w, max_h / h)
        nw, nh = max(1, int(round(w * s))), max(1, int(round(h * s)))
        resized = resize_linear_u8(img, (nh, nw))
        out = np.zeros((max_h, max_w, 3), img.dtype)   # black letterbox
        out[:nh, :nw] = resized
        return out, (nh, nw)

    # ---------- per-item processing ----------

    def _faces_to_outputs(self, img: np.ndarray, faces, content_w: Optional[int] = None):
        """Host-side per-photo assembly from FaceResults: 224² crops, ages,
        genders, RAW identity features, big-face flag (reference
        ``process_image`` :30-42, which also returns raw features — the
        photo loop normalizes them :252-254 while the video loop means the
        RAW vectors per cluster :145-153). ``content_w``: real photo-content
        width when ``img`` is a letterboxed canvas — the big-face fraction
        divides by it, not by the padded canvas width."""
        width = content_w if content_w else img.shape[1]
        crops, ages, genders, feats = [], [], [], []
        has_center_face = False
        for f in faces:
            x1, y1, x2, y2 = f.bbox
            if x2 <= x1 or y2 <= y1:
                continue
            crops.append(resize_linear_u8(img[y1:y2, x1:x2],
                                          (self.analyzer.face_size,) * 2))
            ages.append(f.age)
            genders.append(f.gender_prob)
            feats.append(np.asarray(f.identity, np.float32))
            if (x2 - x1) / width >= self.config.min_face_width_percent:
                has_center_face = True
        return crops, ages, genders, feats, has_center_face

    def _process_photo(self, img: np.ndarray, content_hw=None):
        """One photo -> (face_crops_224, ages, genders, normed_features,
        has_big_face). Mirrors reference ``process_image`` (:30-42)."""
        faces, rotation = self.analyzer.analyze_with_rotations(img)
        if rotation:
            # face boxes are in rotated-image coordinates — crop from the same
            # orientation the detector saw (reference rotates the photo itself,
            # process_photos.py:241-247)
            img = np.ascontiguousarray(np.rot90(img, 3 if rotation == 90 else 1))
            if content_hw is not None:
                content_hw = content_hw[::-1]  # rot90 swaps content h/w
        return self._faces_to_outputs(
            img, faces, content_hw and content_hw[1])

    def _open_video(self, path: str):
        """A capture over ``path``: any object with ``isOpened``, ``grab``,
        ``retrieve`` (-> (ok, BGR frame)) and ``release``. The default is
        ``cv2.VideoCapture``; a machine without cv2 overrides this."""
        import cv2

        return cv2.VideoCapture(path)

    def _video_frames_sequential(self, video, rotation):
        """Reference frame loop: adaptive skip (delta 5, 3 once faces are
        found — ``process_photos.py:118``), one analyze per selected frame.
        NO rotation retry here: the reference retries 90°/270° only in the
        photo loop (:241-247); its video loop calls plain ``process_image``
        (:108)."""
        counter, delta = 0, 5
        while video.isOpened():
            if not video.grab():
                break
            counter += 1
            if counter % delta != 0:
                continue
            _, frame = video.retrieve()
            frame = rotate_image(bgr_to_rgb(frame), rotation)
            out = self._faces_to_outputs(frame, self.analyzer.analyze(frame))
            yield out
            delta = 5 if len(out[1]) == 0 else 3

    def _video_frames_batched(self, video, rotation):
        """Exactly the sequential policy's frames and outputs, but analyzed
        through the fused batch program: whichever delta sequence the policy
        takes, it only ever selects counters divisible by 3 or 5 — a
        POLICY-INDEPENDENT candidate set — so candidates batch-analyze ahead
        (detection is per-frame pure; analyzing never-selected candidates
        has no side effects) and the adaptive skip replays over the cached
        results. ~47% of frames are candidates vs the 20-33% the policy
        selects, but the batch program + one host fetch per group is several
        times cheaper than per-frame calls."""
        results: Dict[int, Tuple] = {}   # counter -> (frame, faces)
        pending: List[Tuple[int, np.ndarray]] = []
        outputs: List[Tuple] = []
        state = {"delta": 5, "replayed": 0}

        def flush():
            frames = np.stack([f for _, f in pending])
            with self.timer.stage("video.analyze_batch"):
                all_faces = self.analyzer.analyze_batch_padded(
                    frames, self.analyze_batch)
            for (c, fr), faces in zip(pending, all_faces):
                results[c] = (fr, faces)
            pending.clear()

        def replay(up_to: int):
            for c in range(state["replayed"] + 1, up_to + 1):
                if c % state["delta"] == 0:
                    fr, faces = results[c]
                    # no rotation retry for video frames — the reference's
                    # video loop calls plain process_image (:108); the
                    # 90°/270° retry is photo-loop-only (:241-247)
                    out = self._faces_to_outputs(fr, faces)
                    outputs.append(out)
                    state["delta"] = 5 if len(out[1]) == 0 else 3
                results.pop(c, None)   # bound memory to one batch window
            state["replayed"] = up_to

        counter = 0
        while video.isOpened():
            if not video.grab():
                break
            counter += 1
            if counter % 3 and counter % 5:
                continue   # never selectable under delta ∈ {5, 3}
            _, frame = video.retrieve()
            frame = rotate_image(bgr_to_rgb(frame), rotation)
            if pending and pending[0][1].shape != frame.shape:
                analyzed_to = pending[-1][0]
                flush()                  # mid-stream resolution change
                replay(analyzed_to)
            pending.append((counter, frame))
            if len(pending) == self.analyze_batch:
                analyzed_to = pending[-1][0]
                flush()
                replay(analyzed_to)
        if pending:
            flush()
        replay(counter)
        yield from outputs

    def process_video(self, path: str, mdate: time.struct_time):
        """Frame loop with adaptive skip; cluster within the clip; return
        per-person medians (reference ``process_video`` :80-156)."""
        video_year = _photo_year(mdate)
        rotation = video_rotation(path)
        video = self._open_video(path)
        crops, born_years, genders, feats, normed, indices = [], [], [], [], [], []
        frame_count = 0
        per_frame = (self._video_frames_batched(video, rotation)
                     if self.analyze_batch > 1
                     else self._video_frames_sequential(video, rotation))
        for c, ages, g, f, _ in per_frame:
            crops.extend(c)
            genders.extend(g)
            # RAW features for the per-cluster means (reference
            # all_features, :145-153: the mean is over raw vectors and only
            # normalized when merged into the album set), NORMALIZED copies
            # for the within-video distance matrix (all_normed_features)
            feats.extend(f)
            normed.extend(x / max(float(np.linalg.norm(x)), 1e-12)
                          for x in f)
            indices.extend([frame_count] * len(ages))
            born_years.extend([video_year - (a - 0.5) for a in ages])
            frame_count += 1
        video.release()

        if len(feats) < self.config.min_no_frames:
            # too few faces to form any cluster (reference guard, :54-56)
            return [], [], [], [], False
        born_years = np.asarray(born_years)
        genders = np.asarray(genders)
        feats = np.asarray(feats)
        mdates = [mdate] * frame_count
        dist = fused_distance_matrix(np.asarray(normed), born_years, indices, mdates,
                                     self.config.age_penalty_weight,
                                     self.analyzer.device)
        clusters = get_facial_clusters(dist, self.config.distance_threshold, indices,
                                       self.config.min_no_frames,
                                       method=self.config.clustering_method)
        clusters = [c for c in clusters if len(c) >= self.config.min_no_frames]
        out_crops, out_ages, out_genders, out_feats = [], [], [], []
        for cluster in clusters:
            out_crops.append(crops[cluster[0]])
            out_genders.append(float(np.median(genders[cluster])))
            avg_year = float(np.median(born_years[cluster]))
            out_ages.append(int(video_year - (avg_year - 0.5)))
            out_feats.append(feats[cluster].mean(axis=0))
        return out_crops, out_ages, out_genders, out_feats, len(clusters) > 0

    # ---------- album scan ----------

    def _analyze_photos(self, album_dir: str, files: List[str]) -> Dict[int, Tuple]:
        """Analyze every photo, batching same-shape photos through the batch
        path, with the reference's 90°/270° rotation retry for photos where
        the upright pass finds no face (``process_photos.py:241-247``).
        Returns {photo_index: per-photo outputs} (see
        ``_faces_to_outputs``)."""
        per_photo: Dict[int, Tuple] = {}
        if self.analyze_batch <= 1:
            for i, f in enumerate(files):
                img, chw = self._maybe_downscale(
                    self._read_photo(os.path.join(album_dir, f)))
                per_photo[i] = self._process_photo(img, chw)
            return per_photo

        from ..utils.prefetch import bounded_thread_map

        # the analyzer retries rotations IN the flush on the device-resident
        # batch (one upload per photo, ``analyze_batch_retry_padded``);
        # mesh and oversample analyzers, which that form refuses, keep the
        # deferred no_face collection + batched retry after the sweep
        resident_retry = self.analyzer.mesh is None and not self.analyzer.oversample
        no_face: List[Tuple[int, np.ndarray, Tuple[int, int]]] = []

        def flush(bucket):
            imgs = np.stack([im for _, im, _ in bucket])
            if resident_retry:
                with self.timer.stage("photo.analyze_batch"):
                    pairs = self.analyzer.analyze_batch_retry_padded(
                        imgs, self.analyze_batch)
                for (i, im, chw), (faces, rot) in zip(bucket, pairs):
                    if rot:   # crop from the orientation the detector saw
                        im = np.ascontiguousarray(
                            np.rot90(im, 3 if rot == 90 else 1))
                        chw = chw and chw[::-1]
                    per_photo[i] = self._faces_to_outputs(
                        im, faces, chw and chw[1])
                return
            with self.timer.stage("photo.analyze_batch"):
                all_faces = self.analyzer.analyze_batch_padded(
                    imgs, self.analyze_batch)
            for (i, im, chw), faces in zip(bucket, all_faces):
                if faces:
                    per_photo[i] = self._faces_to_outputs(im, faces, chw[1])
                else:
                    no_face.append((i, im, chw))

        buckets: Dict[Tuple[int, int], list] = {}
        # threaded decode, bounded in-flight (utils/prefetch): photo decode
        # overlaps the device-side batch analysis of earlier buckets.
        # Open buckets also retain decoded photos; a mixed-resolution album
        # without --downscale can open many shapes at once, so total
        # retention is capped — past it the fullest bucket flushes early
        # (a partial batch pads to the same lane count, costing nothing new)
        max_retained = 4 * self.analyze_batch
        def _decode(f):
            with self.timer.stage("photo.decode"):
                return self._maybe_downscale(
                    self._read_photo(os.path.join(album_dir, f)))

        decoded = bounded_thread_map(_decode, files, workers=4,
                                     depth=2 * self.analyze_batch)
        # flushes run on ``flush_workers`` threads so consecutive buckets
        # pipeline: one bucket's launches and host assembly overlap another's
        # device pass and copies (the device itself serializes). Each flush
        # writes disjoint per_photo keys and appends to no_face (GIL-atomic).
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=self.flush_workers) as pool:
            pending = []
            for i, (img, chw) in enumerate(decoded):
                shape = (img.shape[0], img.shape[1])
                bucket = buckets.setdefault(shape, [])
                bucket.append((i, img, chw))
                if len(bucket) == self.analyze_batch:
                    pending.append(pool.submit(flush, bucket))
                    buckets[shape] = []
                elif sum(len(b) for b in buckets.values()) > max_retained:
                    fullest = max(buckets, key=lambda s: len(buckets[s]))
                    pending.append(pool.submit(flush, buckets[fullest]))
                    buckets[fullest] = []
            for bucket in buckets.values():
                if bucket:
                    pending.append(pool.submit(flush, bucket))
            for fut in pending:
                fut.result()          # surface flush exceptions
        self._batched_rotation_retry(no_face, per_photo)
        return per_photo

    def _batched_rotation_retry(self, entries, per_photo) -> None:
        """Deferred batched rotation retry — only reached by analyzers whose
        flush path can't retry on the resident batch (mesh or oversample; the
        scan retries inside ``flush`` via ``analyze_batch_retry_padded``
        with zero extra uploads). Same
        per-photo policy (90° first, 270° only for photos still face-less,
        reference ``process_photos.py:241-247``); single-device analyzers
        that DO land here (direct callers) still batch both rotations from
        one upright upload (``analyze_batch_rotations_padded``).
        ``entries``: (index, img, content_hw) triples; fills ``per_photo``
        in place."""
        if self.analyzer.mesh is None and not self.analyzer.oversample:
            buckets: Dict[Tuple[int, int], list] = {}
            for (i, img, chw) in entries:
                buckets.setdefault(img.shape[:2], []).append((i, img, chw))
            for bucket in buckets.values():
                for s in range(0, len(bucket), self.analyze_batch):
                    group = bucket[s:s + self.analyze_batch]
                    imgs = np.stack([im for _, im, _ in group])
                    with self.timer.stage("photo.rotation_retry"):
                        pairs = self.analyzer.analyze_batch_rotations_padded(
                            imgs, self.analyze_batch)
                    for (i, img, chw), (f90, f270) in zip(group, pairs):
                        # reference order: 90° wins if it found anything (:243)
                        if f90:
                            per_photo[i] = self._faces_to_outputs(
                                np.ascontiguousarray(np.rot90(img, 3)), f90,
                                chw and chw[::-1][1])
                        elif f270:
                            per_photo[i] = self._faces_to_outputs(
                                np.ascontiguousarray(np.rot90(img, 1)), f270,
                                chw and chw[::-1][1])
                        else:
                            per_photo[i] = self._faces_to_outputs(
                                img, [], chw and chw[1])
            return
        # mesh and oversample analyzers: the rotation pair runs the
        # single-device compacted path only, so keep the two-pass
        # shape-bucketed retry through the mode-aware analyze_batch_padded
        pending = entries
        for rot in (90, 270):
            if not pending:
                return
            k = 3 if rot == 90 else 1   # np.rot90 is counter-clockwise
            still: List[Tuple[int, np.ndarray, Tuple[int, int]]] = []
            buckets2: Dict[Tuple[int, int], list] = {}
            for (i, img, chw) in pending:
                rotated = np.ascontiguousarray(np.rot90(img, k))
                buckets2.setdefault(rotated.shape[:2], []).append(
                    (i, img, chw, rotated))
            for bucket in buckets2.values():
                for s in range(0, len(bucket), self.analyze_batch):
                    group = bucket[s:s + self.analyze_batch]
                    imgs = np.stack([r for _, _, _, r in group])
                    with self.timer.stage("photo.rotation_retry"):
                        all_faces = self.analyzer.analyze_batch_padded(
                            imgs, self.analyze_batch)
                    for (i, img, chw, rotated), faces in zip(group, all_faces):
                        if faces:
                            per_photo[i] = self._faces_to_outputs(
                                rotated, faces, chw and chw[::-1][1])
                        else:
                            still.append((i, img, chw))
            pending = still
        for (i, img, chw) in pending:
            per_photo[i] = self._faces_to_outputs(img, [], chw and chw[1])

    def scan_album(self, album_dir: str, use_cache: bool = True) -> AlbumFaces:
        cache = os.path.join(album_dir, "features.npz")
        files = sorted(f for f in next(os.walk(album_dir))[2] if is_image(f))
        mtimes = [os.path.getmtime(os.path.join(album_dir, f)) for f in files]
        if use_cache and os.path.exists(cache):
            d = np.load(cache, allow_pickle=True)
            # the cache is keyed on the analysis resolution AND the album's
            # current content: features saved at another --downscale
            # setting, or from before photos were added/removed/edited,
            # must not be returned silently (the reference's features.dump
            # has the same staleness hole — process_photos.py:220-231)
            stored_ds = str(d["downscale"]) if "downscale" in d else "None"
            fresh = (stored_ds == str(self.downscale)
                     and list(d["files"]) == files
                     and np.array_equal(np.asarray(d["mtimes"], np.float64),
                                        np.asarray(mtimes, np.float64)))
            if fresh:
                return AlbumFaces(
                    files=list(d["files"]),
                    mdates=[time.gmtime(t) for t in d["mtimes"]],
                    facial_images=[np.asarray(c, dtype=np.uint8)
                                   for c in d["facial_images"]],
                    born_years=d["born_years"], genders=d["genders"],
                    features=d["features"], indices=list(d["indices"]),
                    private_photo_indices=list(d["private"]))

        mdates = [time.gmtime(t) for t in mtimes]
        per_photo = self._analyze_photos(album_dir, files)
        facial_images, born_years, genders, features, indices, private = \
            [], [], [], [], [], []
        for i in range(len(files)):
            crops, ages, g, feats, big_face = per_photo[i]
            if big_face:
                private.append(i)
            facial_images.extend(crops)
            genders.extend(g)
            # the photo loop stores NORMALIZED features (reference
            # :252-254); _faces_to_outputs returns them raw
            features.extend(x / max(float(np.linalg.norm(x)), 1e-12)
                            for x in feats)
            indices.extend([i] * len(ages))
            year = _photo_year(mdates[i])
            born_years.extend([year - (a - 0.5) for a in ages])

        out = AlbumFaces(files, mdates, facial_images,
                         np.asarray(born_years), np.asarray(genders),
                         np.asarray(features) if features else np.zeros((0, 1024)),
                         indices, private)
        if use_cache:
            s = self.analyzer.face_size
            crops = (np.stack(facial_images).astype(np.uint8) if facial_images
                     else np.zeros((0, s, s, 3), np.uint8))
            np.savez(cache, files=files, mtimes=mtimes, facial_images=crops,
                     born_years=out.born_years, genders=out.genders,
                     features=out.features, indices=np.asarray(indices),
                     private=np.asarray(private),
                     downscale=str(self.downscale))
        return out

    def perform_clustering(self, faces: AlbumFaces, min_size: int,
                           check_dates: bool = True) -> List[List[int]]:
        """Cluster + size/date-span filter (reference :45-77)."""
        if len(faces.indices) < min_size:
            return []
        dist = fused_distance_matrix(faces.features, faces.born_years, faces.indices,
                                     faces.mdates, self.config.age_penalty_weight,
                                     self.analyzer.device)
        clusters = get_facial_clusters(dist, self.config.distance_threshold,
                                       faces.indices, min_size,
                                       method=self.config.clustering_method)

        def good(cluster):
            if len(cluster) < min_size:
                return False
            if not check_dates:
                return True
            ts = [time.mktime(faces.mdates[faces.indices[i]]) for i in cluster]
            days = (max(ts) - min(ts)) / 86400.0
            return days >= self.config.min_days_difference

        return [c for c in clusters if good(c)]

    def process_album(self, album_dir: str, use_cache: bool = True,
                      write_outputs: bool = True) -> Dict:
        """Full pipeline; returns a summary dict (with a per-phase wall-time
        split under ``timings``) and (optionally) writes the cluster/public
        directories."""
        walls: Dict[str, float] = {}
        t0 = time.perf_counter()
        faces = self.scan_album(album_dir, use_cache=use_cache)
        walls["scan_photos_s"] = time.perf_counter() - t0
        n_image_files = len(faces.files)

        t0 = time.perf_counter()
        video_files = sorted(f for f in next(os.walk(album_dir))[2] if is_video(f))
        for vi, vf in enumerate(video_files):
            path = os.path.join(album_dir, vf)
            mdate = time.gmtime(os.path.getmtime(path))
            crops, ages, genders, feats, has_faces = self.process_video(path, mdate)
            idx = n_image_files + vi
            if has_faces:
                faces.private_photo_indices.append(idx)
            faces.facial_images.extend(crops)
            faces.genders = np.concatenate([faces.genders, genders])
            if feats:
                normed = [f / max(np.linalg.norm(f), 1e-12) for f in feats]
                faces.features = np.concatenate([faces.features, np.asarray(normed)])
            faces.indices.extend([idx] * len(ages))
            year = _photo_year(mdate)
            faces.born_years = np.concatenate(
                [faces.born_years, [year - (a - 0.5) for a in ages]])
            faces.files.append(vf)
            faces.mdates.append(mdate)
        walls["videos_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        clusters = self.perform_clustering(faces, self.config.min_no_photos)
        walls["cluster_s"] = time.perf_counter() - t0

        cluster_genders, cluster_ages = [], []
        for cluster in clusters:
            avg_year = float(np.median(faces.born_years[cluster]))
            ds = dempster_shafer_gender(faces.genders[cluster])
            cluster_genders.append("male" if ds == 0 else "female")
            cluster_ages.append(int(avg_year))
        cluster_labels = self._label_clusters(faces, clusters)

        result = {
            "n_photos": n_image_files,
            "n_videos": len(video_files),
            "n_faces": len(faces.indices),
            "clusters": clusters,
            "cluster_genders": cluster_genders,
            "cluster_born_years": cluster_ages,
            "cluster_labels": cluster_labels,
        }
        if write_outputs:
            t0 = time.perf_counter()
            self._write_outputs(album_dir, faces, clusters, cluster_genders,
                                cluster_ages, n_image_files, cluster_labels)
            walls["write_outputs_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            self.write_montage(album_dir, faces, clusters)
            walls["montage_s"] = time.perf_counter() - t0
        result["timings"] = {
            "phases": {k: round(v, 3) for k, v in walls.items()},
            # finer-grain stage stats (decode / device batches / rotation
            # retries); concurrent samples overlap, so totals are occupancy
            # per stage, not additive wall time
            "stages": {k: {"count": s["count"],
                           "total_s": round(s["total_s"], 3),
                           "p50_ms": round(s["p50_ms"], 1)}
                       for k, s in self.timer.stats().items()},
        }
        return result

    def write_montage(self, album_dir: str, faces: AlbumFaces,
                      clusters, max_clusters: int = 10) -> Optional[str]:
        """Per-cluster face-crop grid (the reference's matplotlib montage,
        ``process_photos.py:360-370`` — saved to a file instead of plt.show)."""
        if not clusters:
            return None
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        n_clusters = min(max_clusters, len(clusters))
        per_row = max(self.config.min_no_photos, 2)
        fig, axes = plt.subplots(n_clusters, per_row,
                                 figsize=(2 * per_row, 2 * n_clusters),
                                 squeeze=False)
        for i in range(n_clusters):
            for j in range(per_row):
                ax = axes[i][j]
                ax.axis("off")
                if j < len(clusters[i]):
                    ax.imshow(faces.facial_images[clusters[i][j]])
        out = os.path.join(album_dir, "clusters", "montage.png")
        fig.savefig(out, bbox_inches="tight")
        plt.close(fig)
        return out

    def _label_clusters(self, faces, clusters) -> List[Optional[str]]:
        """Name clusters from the enrollment gallery (no reference analog —
        the reference's dirs are anonymous ``{i} {gender} {age}``): every
        member face votes via batched 1-NN at the album's distance
        threshold; the majority label among matching faces wins, ties
        broken toward the smaller summed distance. None = unrecognized
        cluster (keeps its numeric name)."""
        if self.gallery is None or len(self.gallery) == 0 or not clusters:
            return [None] * len(clusters)
        flat = [e for c in clusters for e in c]
        try:
            idents = self.gallery.identify_many(
                faces.features[flat], threshold=self.config.distance_threshold)
        except ValueError as e:
            # e.g. gallery enrolled with a different embedder: the scan +
            # clustering results are minutes of work — keep them and fall
            # back to anonymous numeric names instead of aborting at the end
            import warnings

            warnings.warn(f"--gallery cluster naming skipped: {e}",
                          RuntimeWarning)
            return [None] * len(clusters)
        labels: List[Optional[str]] = []
        pos = 0
        for c in clusters:
            votes: Dict[str, Tuple[int, float]] = {}
            for (label, dist, _) in idents[pos:pos + len(c)]:
                if label is not None:
                    n, s = votes.get(label, (0, 0.0))
                    votes[label] = (n + 1, s + dist)
            pos += len(c)
            labels.append(min(votes, key=lambda l: (-votes[l][0],
                                                    votes[l][1]))
                          if votes else None)
        return labels

    def _write_outputs(self, album_dir, faces, clusters, cluster_genders,
                       cluster_ages, n_image_files, cluster_labels=None):
        import cv2

        res_dir = os.path.join(album_dir, "clusters")
        if os.path.exists(res_dir):
            shutil.rmtree(res_dir, ignore_errors=True)
        used_names = set()
        for i, cluster in enumerate(clusters):
            label = cluster_labels[i] if cluster_labels else None
            if label:
                # filesystem-safe, collision-suffixed person name
                safe = "".join(ch for ch in label
                               if ch.isalnum() or ch in " _-") or str(i)
                name = f"{safe} {cluster_genders[i]} {cluster_ages[i]}"
                if name in used_names:
                    name = f"{safe} ({i}) {cluster_genders[i]} {cluster_ages[i]}"
            else:
                name = f"{i} {cluster_genders[i]} {cluster_ages[i]}"
                if name in used_names:   # a digit-named person above took it
                    name = f"{i} ({i}) {cluster_genders[i]} {cluster_ages[i]}"
            used_names.add(name)
            cdir = os.path.join(res_dir, name)
            os.makedirs(cdir, exist_ok=True)
            for ind in cluster:
                bgr = cv2.cvtColor(faces.facial_images[ind], cv2.COLOR_RGB2BGR)
                cv2.imwrite(os.path.join(cdir, f"{ind}.jpg"), bgr)
        # "public" = photos with no clustered face and no big face (:344-358)
        private = {faces.indices[e] for c in clusters for e in c}
        private |= set(faces.private_photo_indices)
        pub_dir = os.path.join(res_dir, "public")
        os.makedirs(pub_dir, exist_ok=True)
        for i, f in enumerate(faces.files):
            if i in private:
                continue
            src = os.path.join(album_dir, f)
            if i < n_image_files:
                photo = cv2.imread(src)
                r = 200.0 / photo.shape[1]
                photo = cv2.resize(photo, (200, int(photo.shape[0] * r)))
                cv2.imwrite(os.path.join(pub_dir, f), photo)
            else:
                shutil.copy(src, pub_dir)
