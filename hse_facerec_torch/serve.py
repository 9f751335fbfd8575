"""HTTP inference server with cross-request batching.

Counterpart of ``hse_facerec_tf_tpu/serve.py`` (the reference has no
server — SURVEY.md §0): a threaded HTTP server whose handlers enqueue work
for batching workers that coalesce concurrent requests into one batched
call on the card (per-request batch-1 calls would leave it idle between
launches — the same lesson as the reference's per-image ``sess.run`` loop).

Endpoints:
  POST /embed    image bytes (jpeg/png) -> {"embedding": [...]}
  POST /analyze[?identify=1[&threshold=T]]  image bytes ->
                 {"faces": [{bbox, age, gender_prob, ...}]}; with
                 ``identify=1`` each face also carries {label|null,
                 distance, nearest} from the enrollment gallery
  POST /enroll?label=NAME[&mode=face|image]   image bytes ->
                 {"label", "n_enrolled"} — store the embedding under NAME
                 in the enrollment gallery (int8-packed ranking state,
                 persisted to --gallery if given). Default mode ``face``
                 detects and embeds the LARGEST face (422 when none);
                 ``image`` embeds the whole frame like /embed (the
                 reference's pre-cropped gallery-dir convention,
                 ``facerec_test.py:220-288``) and is the default when the
                 analyzer is disabled. Enroll and identify with the SAME
                 mode — the two views live in the same 1024-d space but
                 one sees background, the other a face crop.
  POST /identify[?threshold=T&mode=...]  image bytes ->
                 {"label": NAME|null, "distance", "nearest"} — 1-NN over
                 the enrolled gallery; null label when the nearest
                 enrollment is farther than the threshold (default
                 --identify-threshold, reference album semantics
                 DistanceThreshold=0.82)
  DELETE /enroll?label=NAME -> {"removed": k}
  GET  /gallery  -> enrollment stats {n_enrolled, n_labels, dim, ...}
  GET  /healthz  -> {"ok": true, "device": <the card's name>}
  GET  /stats    -> per-endpoint latency {count, mean_ms, p50_ms, p95_ms}
                    plus the batching workers' per-request decomposition
                    (``embed_worker.queue_wait`` / ``.assemble`` /
                    ``.process``) — where a request's latency goes — and,
                    from ``build_server``'s extractor, ``process`` split
                    into ``embed.upload`` / ``embed.forward`` (launches) /
                    ``embed.fetch`` (the wait for the card and the copy
                    back), with the counters ``embed.upload_bytes``,
                    ``embed.rows`` and ``embed.padded_rows`` as {"total": n}
  GET  /profile  -> on-demand device-time table of the embed program's
                    kernels (utils.profiling.fusion_profile)

The paths run the port's kernels: K1 (crop) under /analyze and face-mode
/enroll and /identify, K2c (int8 1-NN) under /identify and
/analyze?identify=1, K4 (int8 pointwise conv) under /embed with an
``_int8`` model.

Run: ``python -m hse_facerec_torch.serve --port 8000 [--gallery faces.npz]``
(on ``--device cuda`` unless asked for another).
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

import numpy as np


class _NoFace(ValueError):
    """Enrollment/identification probe contained no detectable face (422:
    the request was well-formed, the content can't be processed)."""


class _BatchingWorker:
    """Coalesces concurrent requests into batched device calls.

    ``process``: (stacked same-shape images (N, H, W, 3)) -> sequence of N
    per-image results (one array / FaceResult list per image).

    ``timer``/``name``: when given, every request's latency decomposes into
    three stages in the shared StageTimer:
      ``{name}.queue_wait`` — enqueue until the worker picks it into a batch
                              (the card busy with earlier generations);
      ``{name}.assemble``   — picked until its batch dispatches (the
                              coalescing window / later same-batch arrivals);
      ``{name}.process``    — the batched call itself (host stack + upload +
                              compute + copy back), one sample per
                              same-shape group.

    ``pipeline_depth``: batched calls run on a small pool so consecutive
    generations overlap: batch k+1's host work (stacking, upload, the
    launches) runs while batch k's kernels and copy back finish, and a
    queued request waits behind less than a whole ``process``. Depth 2 is
    one generation in flight and one being prepared; deeper only queues on
    the one card. Set 1 to restore the strictly serial worker."""

    def __init__(self, process, max_batch: int = 32, max_wait_ms: float = 5.0,
                 name: str = "worker", timer=None, pipeline_depth: int = 2):
        self.process = process
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.name = name
        self.timer = timer
        import concurrent.futures as _futures

        self._pool = _futures.ThreadPoolExecutor(
            max_workers=max(1, pipeline_depth),
            thread_name_prefix=f"{name}-process")
        # bounds in-flight generations: when full, the dispatch loop blocks
        # HERE (not in the pool's unbounded queue), so arriving requests
        # keep coalescing into the NEXT batch instead of splitting into many
        # tiny ones
        self._slots = threading.Semaphore(max(1, pipeline_depth))
        self.queue: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray,
               timeout_s: Optional[float] = None) -> np.ndarray:
        """Blocks for the batched result; raises TimeoutError after
        ``timeout_s`` (a call on the card cannot be cancelled — a stuck one
        would otherwise wedge every request behind it, so the handler
        surfaces a 504 and the client can retry/fail over). A timed-out
        request is marked abandoned so a recovered worker drops it instead
        of spending the card on clients that already left."""
        done = threading.Event()
        slot: dict = {"t_enqueue": time.perf_counter()}
        self.queue.put((image, done, slot))
        if not done.wait(timeout_s):
            slot["abandoned"] = True
            raise TimeoutError(
                f"inference did not complete within {timeout_s}s")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["result"]

    def _sample(self, stage: str, dt: float):
        if self.timer is not None:
            self.timer.add(f"{self.name}.{stage}", dt)

    def _run(self):
        while True:
            # acquire the dispatch slot BEFORE collecting: while every slot
            # is busy, arriving requests stay in the queue and coalesce into
            # ONE bigger next batch (acquiring after collection leaves picked
            # requests stalled mid-assembly at the semaphore and splits
            # traffic into smaller generations)
            self._slots.acquire()
            image, done, slot = self.queue.get()
            slot["t_picked"] = time.perf_counter()
            batch = [(image, done, slot)]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = self.queue.get(timeout=timeout)
                    item[2]["t_picked"] = time.perf_counter()
                    batch.append(item)
                except queue.Empty:
                    break
            # drop requests whose clients already got a 504 (post-outage
            # backlog would otherwise delay live traffic with dead work)
            batch = [it for it in batch if not it[2].get("abandoned")]
            # group by source size (the extractor resizes per size)
            by_size = {}
            for item in batch:
                by_size.setdefault(item[0].shape, []).append(item)
            if not by_size:
                self._slots.release()
                continue
            for gi, items in enumerate(by_size.values()):
                if gi:      # first group uses the pre-acquired slot
                    self._slots.acquire()
                self._pool.submit(self._process_group, items)

    def _process_group(self, items):
        t_dispatch = time.perf_counter()
        for _, _, s in items:
            self._sample("queue_wait", s["t_picked"] - s["t_enqueue"])
            self._sample("assemble", t_dispatch - s["t_picked"])
        try:
            # coalescing produces arbitrary batch sizes; the processors own
            # shape-bucketing (EmbeddingExtractor pads tails to power-of-2
            # buckets, _analyze_batch_pow2 ditto), so traffic reaches a
            # handful of shapes, each warmed once (cuDNN picks its
            # algorithms per shape)
            imgs = np.stack([it[0] for it in items])
            feats = self.process(imgs)
            self._sample("process", time.perf_counter() - t_dispatch)
            for (_, d, s), f in zip(items, feats):
                s["result"] = f
                d.set()
        except Exception as e:  # noqa: BLE001 — report to the caller
            for _, d, s in items:
                s["error"] = str(e)
                d.set()
        finally:
            self._slots.release()


def _analyze_batch_pow2(analyzer, imgs: np.ndarray):
    """Cross-request analyze batching: pad the lane count to the next power
    of two, so arbitrary coalesced batch sizes reach at most 4 lane counts
    per image shape (at 8 lanes)."""
    lanes = 1 << max(0, imgs.shape[0] - 1).bit_length()
    return analyzer.analyze_batch_padded(imgs, lanes)


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """Image bytes (jpeg/png/...) -> RGB uint8 (H, W, 3), or None when they
    do not decode: ``cv2.imdecode`` then BGR→RGB, as the reference does.
    cv2 is imported here: the card's machine has none, and a server there
    takes another decoder (``make_handler(decode=...)``)."""
    import cv2

    img = cv2.imdecode(np.frombuffer(data, dtype=np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        return None
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def make_handler(worker: _BatchingWorker, analyze_worker,
                 profile_input_hw: Tuple[int, int] = (224, 224),
                 request_timeout_s: float = 600.0,
                 gallery=None, identify_threshold: float = 0.82,
                 timer=None,
                 decode: Callable[[bytes], Optional[np.ndarray]] = decode_image,
                 device="cuda"):
    """The request handler class over the two workers and the gallery.
    ``decode``: body bytes -> RGB uint8 image or None (400). ``device``:
    where the default in-memory gallery ranks, and what ``/healthz``
    reports."""
    import torch

    from .pipelines.detector import resolve_device
    from .utils.profiling import StageTimer

    device = resolve_device(device)
    if gallery is None:
        from .pipelines.gallery import EnrollmentGallery

        gallery = EnrollmentGallery(device=device)
    device_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device))
    # shared with the batching workers so GET /stats carries both the
    # per-endpoint request latencies AND the worker-side decomposition
    # (queue_wait / assemble / process)
    timer = timer if timer is not None else StageTimer()
    profile_lock = threading.Lock()

    # Gallery RANKING is device work and must honor the same per-request
    # deadline as the worker paths — run it on one dedicated thread and map
    # a blown deadline to TimeoutError (-> 504) instead of hanging the
    # handler thread on a wedged call. One thread is the right width: the
    # card serializes the calls anyway, and queued requests behind a wedge
    # each time out cleanly.
    import concurrent.futures as _futures

    rank_pool = _futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="gallery-rank")

    def ranked(fn, *a, **kw):
        fut = rank_pool.submit(fn, *a, **kw)
        try:
            return fut.result(timeout=request_timeout_s)
        except _futures.TimeoutError:
            raise TimeoutError(
                f"identification did not complete within "
                f"{request_timeout_s:.0f}s") from None

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_image(self) -> Optional[np.ndarray]:
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                return None
            return decode(self.rfile.read(length))

        def do_GET(self):
            if self.path == "/gallery":
                self._json(200, gallery.stats())
            elif self.path == "/healthz":
                self._json(200, {"ok": True, "device": device_name})
            elif self.path == "/stats":
                # per-endpoint request latency (count / mean / p50 / p95 ms),
                # measured around the batching-worker round trip, and the
                # timer's counters
                counts = {k: {"total": n} for k, n in timer.counts().items()}
                self._json(200, {**timer.stats(), **counts})
            elif self.path == "/profile":
                # on-demand kernel profile of the embed program (a dummy
                # batch of 8 under torch.profiler; concurrent live
                # traffic's kernels land in the same trace window)
                if not profile_lock.acquire(blocking=False):
                    self._json(409, {"error": "a profile is already running"})
                    return
                try:
                    from .utils.profiling import fusion_profile

                    dummy = np.zeros((8,) + tuple(profile_input_hw) + (3,),
                                     np.uint8)
                    prof = fusion_profile(lambda: worker.process(dummy))
                    if prof is None:
                        self._json(503, {"error": "profiling unavailable on "
                                         "this backend"})
                    else:
                        self._json(200, prof)
                except Exception as e:  # the PROGRAM failed, not the profiler
                    self._json(500, {"error": str(e)})
                finally:
                    profile_lock.release()
            else:
                self._json(404, {"error": "unknown path"})

        def do_DELETE(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            if url.path == "/enroll":
                label = parse_qs(url.query).get("label", [""])[0]
                if not label:
                    self._json(400, {"error": "label query param required"})
                    return
                self._json(200, {"removed": gallery.remove(label)})
            else:
                self._json(404, {"error": "unknown path"})

        def _embedding_for(self, img, query):
            """The probe/enrollment embedding per the ``mode`` query param:
            ``face`` = identity feature of the LARGEST detected face (the
            face-recognition default when the analyzer runs), ``image`` =
            whole-frame embedding (the reference's pre-cropped gallery-dir
            convention; the only mode without the analyzer). Raises
            ValueError (-> 400/422) on bad modes / no face."""
            default = "face" if analyze_worker is not None else "image"
            mode = query.get("mode", [default])[0]
            if mode == "image":
                return worker.submit(img, request_timeout_s)
            if mode != "face":
                raise ValueError(f"mode must be 'face' or 'image', "
                                 f"got {mode!r}")
            if analyze_worker is None:
                raise ValueError("mode=face needs the analyzer "
                                 "(server started with --no-analyzer)")
            faces = analyze_worker.submit(img, request_timeout_s)
            if not faces:
                raise _NoFace("no face detected in the image")
            return _largest_face(faces).identity

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            query = parse_qs(url.query)
            try:
                thr = float(query.get("threshold", [identify_threshold])[0])
            except ValueError:
                self._json(400, {"error": "threshold must be a number"})
                return
            img = self._read_image()
            if img is None:
                self._json(400, {"error": "body must be a decodable image"})
                return
            try:
                if url.path == "/enroll":
                    label = query.get("label", [""])[0]
                    if not label:
                        self._json(400, {"error": "label query param "
                                         "required"})
                        return
                    with timer.stage("enroll"):
                        feats = self._embedding_for(img, query)
                        n = gallery.enroll(label, np.asarray(feats))
                    self._json(200, {"label": label, "n_enrolled": n})
                elif url.path == "/identify":
                    with timer.stage("identify"):
                        feats = self._embedding_for(img, query)
                        label, dist, nearest = ranked(
                            gallery.identify, np.asarray(feats),
                            threshold=thr)
                    if dist is None:
                        self._json(200, {"label": None, "distance": None,
                                         "nearest": None,
                                         "note": "gallery is empty"})
                    else:
                        self._json(200, {
                            "label": label, "distance": round(dist, 4),
                            "nearest": nearest, "threshold": thr})
                elif url.path == "/embed":
                    with timer.stage("embed"):
                        feats = worker.submit(img, request_timeout_s)
                    self._json(200, {"embedding": np.asarray(feats, np.float64)
                                     .round(6).tolist()})
                elif url.path == "/analyze":
                    if analyze_worker is None:
                        self._json(503, {"error": "analyzer disabled "
                                         "(server started with --no-analyzer)"})
                        return
                    with_ident = query.get("identify", ["0"])[0] not in (
                        "0", "", "false")
                    with timer.stage("analyze"):
                        faces = analyze_worker.submit(img, request_timeout_s)
                    rows = [{
                        "bbox": list(f.bbox), "score": round(f.score, 4),
                        "age": round(f.age, 1),
                        "gender_prob": round(f.gender_prob, 4),
                        "is_male": bool(f.is_male()),
                    } for f in faces]
                    if with_ident and faces:
                        # one batched call for every face's 1-NN
                        idents = ranked(
                            gallery.identify_many,
                            np.stack([f.identity for f in faces]),
                            threshold=thr)
                        for row, (label, dist, nearest) in zip(rows, idents):
                            row["label"] = label
                            row["nearest"] = nearest
                            row["distance"] = (None if dist is None
                                               else round(dist, 4))
                    self._json(200, {"faces": rows})
                else:
                    self._json(404, {"error": "unknown path"})
            except TimeoutError as e:
                self._json(504, {"error": str(e)})
            except _NoFace as e:
                self._json(422, {"error": str(e)})
            except ValueError as e:        # bad request data (e.g. embedding
                self._json(400, {"error": str(e)})     # dim != gallery dim)
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": str(e)})

    return Handler


def _largest_face(faces):
    return max(faces, key=lambda f: (f.bbox[2] - f.bbox[0])
               * (f.bbox[3] - f.bbox[1]))


def _prewarm_buckets(max_batch: int, cap: int):
    """The exact batch-size bucket set coalesced traffic can reach — the
    shapes ``--prewarm`` runs before serving. Mirrors
    ``EmbeddingExtractor.extract_batch``'s padding rule (tail of size
    ``take`` pads to ``max(8, next_pow2(take))`` clamped to the chunk size
    ``cap``): pow2 from 8 up to next_pow2(max_batch), each clamped to
    ``cap``. Warming only pow2 ≤ max_batch misses the TOP bucket whenever
    max_batch is not itself a power of two (e.g. --max-batch 48 → a
    33-48-image batch pads to 64)."""
    warm, b = set(), 8
    while True:
        warm.add(min(b, cap))
        if b >= min(max_batch, cap):
            return sorted(warm)
        b *= 2


def build_server(port: int = 8000, model: str = "agegender_identity",
                 max_batch: int = 32, with_analyzer: bool = True,
                 request_timeout_s: float = 600.0,
                 gallery_path: Optional[str] = None,
                 identify_threshold: float = 0.82,
                 data_parallel: bool = False,
                 prewarm: bool = False, device="cuda", host: str = "0.0.0.0",
                 params: Optional[Dict] = None,
                 decode: Callable[[bytes], Optional[np.ndarray]] = decode_image):
    """The server as ``main`` runs it: the zoo's ``model`` behind the embed
    worker, the reference's analyzer (``zoo.MTCNN_PB``/``AGEGENDER_PB``) at
    8 lanes behind the analyze worker, an ``EnrollmentGallery`` at
    ``gallery_path``, all on ``device``, listening on ``host``:``port``.
    ``params`` replaces the model's weights (``zoo.build_extractor``);
    ``decode`` turns request bodies into images (``make_handler``). ``data_parallel`` with several
    cards builds one 1-D ``data`` mesh over all of them
    (``parallel.sharding.make_mesh``) and hands it to the extractor, the
    analyzer and the gallery; on one card it is ignored, as in the
    reference."""
    import torch

    from .models import zoo
    from .models.zoo import build_extractor

    mesh = None
    if data_parallel:
        from .parallel.sharding import make_mesh

        if torch.cuda.device_count() > 1:
            mesh = make_mesh()
        else:
            print("serve: --data-parallel ignored (single device)")
    from .utils.profiling import StageTimer

    # one timer for the workers' stages, the endpoints' latencies and the
    # extractor's spans and counters, all under GET /stats
    timer = StageTimer()
    extractor = build_extractor(model, device=device, params=params, mesh=mesh,
                                timer=timer)
    if prewarm:
        # run every embed batch bucket once BEFORE serving traffic: the
        # first call builds the kernels and lets cuDNN pick its algorithms
        # for the shape, which would otherwise stall the requests queued
        # behind it
        h, w = extractor.input_size
        for n in _prewarm_buckets(max_batch, extractor.batch_size):
            extractor.extract_batch(np.zeros((n, h, w, 3), np.uint8))
        timer.reset()
    worker = _BatchingWorker(extractor.extract_batch, max_batch=max_batch,
                             name="embed_worker", timer=timer)
    analyze_worker = None
    if with_analyzer:
        import functools

        from .pipelines.analyzer import FacialAnalyzer

        analyzer = FacialAnalyzer.from_reference_models(
            zoo.MTCNN_PB, zoo.AGEGENDER_PB, device=device, mesh=mesh)
        analyze_worker = _BatchingWorker(
            functools.partial(_analyze_batch_pow2, analyzer), max_batch=8,
            name="analyze_worker", timer=timer)
    from .pipelines.gallery import EnrollmentGallery

    # under --data-parallel the gallery's ranking state is split over the
    # same mesh: its capacity grows with the cards
    gallery = EnrollmentGallery(path=gallery_path, device=device, mesh=mesh)
    return ThreadingHTTPServer(
        (host, port),
        make_handler(worker, analyze_worker,
                     profile_input_hw=extractor.input_size,
                     request_timeout_s=request_timeout_s,
                     gallery=gallery,
                     identify_threshold=identify_threshold,
                     timer=timer, decode=decode, device=device))


def main(argv=None):
    from .models.zoo import MODEL_ZOO

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--model", default="agegender_identity",
                   choices=sorted(MODEL_ZOO))
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--no-analyzer", action="store_true")
    p.add_argument("--request-timeout", type=float, default=600.0,
                   help="seconds before an in-flight request returns 504 "
                        "(a stuck call on the card cannot be cancelled; the "
                        "deadline keeps clients from hanging with it)")
    p.add_argument("--gallery", default=None,
                   help="path to the enrollment gallery .npz — loaded at "
                        "boot, atomically rewritten after every "
                        "/enroll (omit for an in-memory gallery)")
    p.add_argument("--identify-threshold", type=float, default=0.82,
                   help="max L2 distance for an /identify match (reference "
                        "album DistanceThreshold, process_photos.py:26)")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard coalesced request batches over all local "
                        "cards (one 1-D data mesh for the embed extractor, "
                        "the analyzer and the gallery); ignored on one card")
    p.add_argument("--prewarm", action="store_true",
                   help="run every embed batch bucket once before accepting "
                        "traffic (kernel build, cuDNN algorithm choice), so "
                        "the first requests of a bucket do not stall the "
                        "queue")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    server = build_server(args.port, args.model, args.max_batch,
                          with_analyzer=not args.no_analyzer,
                          request_timeout_s=args.request_timeout,
                          gallery_path=args.gallery,
                          identify_threshold=args.identify_threshold,
                          data_parallel=args.data_parallel,
                          prewarm=args.prewarm, device=args.device)
    print(f"serving on :{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
