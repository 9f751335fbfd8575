"""Open-loop identification, as the server's ``/identify`` runs it: each
request is one face crop, embedded through serve's ``_BatchingWorker``
(its coalescing window and depth) with ``extract_batch`` as its process,
then ranked by ``EnrollmentGallery.identify`` on one ranking thread.
Requests arrive on a schedule drawn from the seed, whether or not earlier
ones have finished; each is timed from when it was due.

The gallery holds ``gallery_rows`` rows: seeded unit vectors (the
distractors) and the port's embeddings of ``enrolled`` seeded crops,
quantised to int8 by the gallery and ranked on K2c. Half of the probe pool
are noisy copies of enrolled crops, half crops of no enrolled identity.

What is compared, on a sample of the finished requests drawn from the
seed: the probe's embedding against the plain reference's
(``emb_rel_err``); the ranking of the program's embedding against the
reference's int8 1-NN over the gallery the reference builds itself from
the same distractors and its own embeddings of the enrolled crops
(``rank_gap``: how far the returned row lies behind the best;
``dist_gap``: the returned distance against the reference's for that
row); and the threshold decision against the returned distance
(``decision_errors``)."""

from __future__ import annotations

import concurrent.futures as futures
import math
import time
from typing import Dict, List

import numpy as np
import torch

from .. import flops, inputs, weights
from ..stats import percentile
from . import Window, now_ns


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s) of a Poisson stream at ``rate`` over ``seconds``: the
    ``n = round(rate·seconds)`` gaps before each arrival are the
    exponential distribution's quantiles at (i + 0.5)/n, scaled to fill the
    window, in an order drawn from the seed, so every seed offers the same
    gaps and the same count."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps *= seconds / gaps.sum()
    gaps = gaps[inputs.permutation(seed, "schedule", n)]
    return np.cumsum(gaps)


class Entry:
    span_priority = ["extract_batch", "identify", "in_flight", "generate"]

    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic = run.cfg, run.traffic

    # -- set-up --------------------------------------------------------------

    def setup(self) -> None:
        from hse_facerec_torch.models.zoo import build_extractor
        from hse_facerec_torch.pipelines.gallery import EnrollmentGallery
        from hse_facerec_torch.serve import _BatchingWorker
        from hse_facerec_torch.utils.profiling import StageTimer

        run, cfg, tr = self.run, self.cfg, self.traffic
        phases, t = run.phases, time.perf_counter()
        self.params = weights.for_config(cfg, run.seed, run.device)
        self.extractor = build_extractor(cfg["zoo_entry"], batch_size=tr["extractor_batch"],
                                         device=run.device, params=self.params,
                                         precision=cfg["precision"])
        phases["weights_s"], t = time.perf_counter() - t, time.perf_counter()
        size, n_enr = cfg["input_size"], tr["enrolled"]
        self.enrolled = inputs.images(n_enr, size, size, run.seed, "inputs.enrolled", run.device)
        enrolled_emb = self.extractor.extract_batch(self.enrolled)
        self.distractors = inputs.unit_rows(tr["gallery_rows"] - n_enr, cfg["embedding_dim"],
                                            run.seed, "inputs.distractors", run.device)
        self.labels = [f"d{i}" for i in range(len(self.distractors))] + \
                      [f"e{j}" for j in range(n_enr)]
        self.row_of = {label: i for i, label in enumerate(self.labels)}
        self.gallery = EnrollmentGallery(device=run.device)
        self.gallery.enroll_many(self.labels, np.concatenate([self.distractors, enrolled_emb]))
        self.gallery.identify(enrolled_emb[0], tr["threshold"])     # builds the int8 state
        phases["gallery_s"], t = time.perf_counter() - t, time.perf_counter()

        half = tr["probe_pool"] // 2
        src = inputs.choice(run.seed, "probes.src", n_enr, half)
        probes = np.concatenate([
            inputs.noisy_copies(self.enrolled[src], tr["probe_noise"], run.seed,
                                "probes.noise", run.device),
            inputs.images(tr["probe_pool"] - half, size, size, run.seed, "inputs.open",
                          run.device)])
        # the two kinds interleaved in an order drawn from the seed
        self.probes = probes[inputs.permutation(run.seed, "probes.order", len(probes))]
        self.timer = StageTimer(max_samples=1 << 22)
        self.worker = _BatchingWorker(self._process, max_batch=tr["max_batch"],
                                      max_wait_ms=tr["max_wait_ms"], name="embed_worker",
                                      timer=self.timer, pipeline_depth=tr["pipeline_depth"])
        self.rank_pool = futures.ThreadPoolExecutor(1, thread_name_prefix="gallery-rank")
        self.clients = futures.ThreadPoolExecutor(tr["clients"], thread_name_prefix="client")
        # every batch bucket the worker can reach (serve's prewarm), then a
        # burst through the whole path
        b = 8
        while True:
            self.extractor.extract_batch(self.probes[:min(b, tr["max_batch"])])
            if b >= tr["max_batch"]:
                break
            b *= 2
        self.results: Dict[int, tuple] = {}
        self.latency_ms: Dict[int, float] = {}
        burst = [self.clients.submit(self._request, i, now_ns()) for i in range(2 * tr["max_batch"])]
        for f in burst:
            f.result()
        self.results.clear()
        self.latency_ms.clear()
        self.timer.reset()
        run.spans.clear()
        phases["warmup_s"] = time.perf_counter() - t

    def _process(self, imgs: np.ndarray):
        t = now_ns()
        out = self.extractor.extract_batch(imgs)
        self.run.spans.add("extract_batch", t, now_ns(), size=len(imgs))
        return out

    def _probe(self, i: int) -> int:
        return i % len(self.probes)

    def _request(self, i: int, due_ns: int) -> None:
        emb = self.worker.submit(self.probes[self._probe(i)])
        t = now_ns()
        answer = self.rank_pool.submit(self.gallery.identify, emb,
                                       self.traffic["threshold"]).result()
        end = now_ns()
        self.run.spans.add("identify", t, end)
        self.run.spans.add("in_flight", due_ns, end)
        self.results[i] = (answer, emb)
        self.latency_ms[i] = (end - due_ns) / 1e6

    # -- the window ------------------------------------------------------------

    def window(self, seconds: float) -> Window:
        tr, spans = self.traffic, self.run.spans
        due = schedule(tr["rate_per_s"], seconds, self.run.seed)
        self.n_due = len(due)
        self.lag_ms: List[float] = []
        pending = []
        t0 = now_ns()
        for i, d in enumerate(due):
            target = t0 + int(d * 1e9)
            wait = target - now_ns()
            if wait > 0:
                time.sleep(wait / 1e9)
            t = now_ns()
            pending.append(self.clients.submit(self._request, i, target))
            spans.add("generate", t, now_ns())
            self.lag_ms.append((t - target) / 1e6)
        close = t0 + int(seconds * 1e9)
        # answers are waited for up to a minute past the close: late is late,
        # not wrong; one that never comes is a failure
        done, _ = futures.wait(pending, timeout=max(0.0, (close - now_ns()) / 1e9) + 60.0)
        self.errors = [f.exception() for f in done if f.exception() is not None]
        lat = [self.latency_ms.get(i, math.inf) for i in range(self.n_due)]
        failed = sum(1 for v in lat if math.isinf(v))
        return Window(seconds=seconds, attempted=self.n_due, failed=failed,
                      end_to_end={"query_p95_ms": percentile(lat, 95)},
                      units=self.n_due - failed)

    def work_at_peak_s(self) -> float:
        """Least time the window's work needs at the card's peaks: the real
        faces embedded at the f32 peak, one int8 1-NN a query at the int8
        peak."""
        faces = sum(self.run.spans.sizes.get("extract_batch", []))
        ops, _ = flops.knn_int8_work(1, self.traffic["gallery_rows"], self.cfg["embedding_dim"])
        return (faces * flops.model_flops(self.cfg) / flops.PEAK_OPS["f32"]
                + len(self.results) * ops / flops.PEAK_OPS["int8"])

    def context(self) -> Dict:
        return {"work_at_peak_s": self.work_at_peak_s(),
                "stage_ms": {k: [v * 1e3 for v in vs] for k, vs in self.timer.samples.items()},
                "lag_ms": self.lag_ms,
                "knn_shape": (1, self.traffic["gallery_rows"], self.cfg["embedding_dim"])}

    def release(self) -> None:
        self.worker.process = None
        self.rank_pool.shutdown(wait=True)
        self.clients.shutdown(wait=True)
        self.worker._pool.shutdown(wait=True)
        del self.extractor, self.gallery
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------------

    def checks(self, control: bool = False) -> Dict[str, float]:
        from perfbench.reference import knn_int8

        run, tr, dev = self.run, self.traffic, self.run.device
        fp32, bits = ("tf32", 4) if control else ("ieee", 8)
        finished = sorted(self.results)
        pick = [finished[j] for j in inputs.choice(run.seed, "check", len(finished),
                                                   tr["check_sample"])]
        imgs = self.probes[[self._probe(i) for i in pick]]
        ref_emb = run.reference.embed(self.params, imgs, dev, self.cfg)
        enrolled_ref = run.reference.embed(self.params, self.enrolled, dev, self.cfg)
        rows = torch.cat([torch.as_tensor(self.distractors, device=dev), enrolled_ref])
        gallery = knn_int8.Gallery(rows)
        if control:
            got_emb = run.reference.embed(self.params, imgs, dev, self.cfg, fp32=fp32)
            enrolled_ctl = run.reference.embed(self.params, self.enrolled, dev, self.cfg,
                                               fp32=fp32)
            ctl = knn_int8.Gallery(torch.cat([rows[:len(self.distractors)], enrolled_ctl]),
                                   bits=bits)
            answers = []
            for e in got_emb:
                idx, dist = ctl.nearest(e)
                nearest = self.labels[idx]
                answers.append((nearest if dist <= tr["threshold"] else None, dist, nearest))
            del ctl
        else:
            got_emb = torch.as_tensor(np.stack([self.results[i][1] for i in pick]), device=dev)
            answers = [self.results[i][0] for i in pick]
        err = (torch.linalg.vector_norm(got_emb - ref_emb, dim=1)
               / torch.linalg.vector_norm(ref_emb, dim=1).clamp_min(1e-30))
        rank_gap = dist_gap = 0.0
        decision_errors = 0
        with torch.no_grad():
            for e, (label, dist, nearest) in zip(got_emb, answers):
                d2 = gallery.distances(e)
                best = float(torch.sqrt(torch.clamp(d2.min(), min=0.0)))
                at = float(torch.sqrt(torch.clamp(d2[self.row_of[nearest]], min=0.0)))
                rank_gap = max(rank_gap, at - best)
                dist_gap = max(dist_gap, abs(dist - at))
                decision_errors += label != (nearest if dist <= tr["threshold"] else None)
        return {"emb_rel_err": float(err.max()), "rank_gap": rank_gap,
                "dist_gap": dist_gap, "decision_errors": float(decision_errors)}
