"""Closed-loop album analysis: ``FacialAnalyzer.analyze_batch`` on
``batch`` distinct photos a call, the calls cycling through a pool of
photos made in set-up (an album organiser's batch of photos). The pool is
the same for every seed (``photo_set_seed``), so the seed changes only the
order of the calls and not the work: how many faces the cascade finds,
and how many lanes overflow the head slots, is a property of the photos. Lanes
whose faces overflow the batch's head slots, or whose detector caps
truncated, are re-run one by one through ``FacialAnalyzer.analyze``, which
the benchmark counts through a wrapper of that method.

What is compared, on a sample of the window's photos drawn from the seed:
each photo's faces against the plain reference's (the cascade, the crops
and the heads, per photo). Faces pair up when their raw boxes agree to
``same_box_px``; ``box_mismatch_share`` is the share of all faces, of both
sides, left without a pair, and the pairs' worst gaps are compared:
``score_gap`` (O-Net's P(face)), ``age_gap``, ``male_gap`` (P(male)) and
``ident_rel_err`` (the identity's relative L2 error)."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import flops, inputs, weights
from ..stats import rate
from . import Window, closed_loop


class Entry:
    span = "analyze_batch"
    span_priority = ["analyze", "analyze_batch"]

    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic = run.cfg, run.traffic
        self.results: Dict[int, tuple] = {}
        self.reruns: List[int] = []
        self._ref: Dict[int, Dict] = {}

    def setup(self) -> None:
        from hse_facerec_torch.pipelines.analyzer import FacialAnalyzer

        run, cfg, tr = self.run, self.cfg, self.traffic
        det = cfg["detector"]
        phases, t = run.phases, time.perf_counter()
        h, w = tr["photo_hw"]
        self.pool = inputs.images(tr["pool"], h, w, tr["photo_set_seed"], "inputs.photos",
                                  run.device)
        starts = list(range(0, tr["pool"] - tr["batch"] + 1, tr["batch"]))
        order = inputs.permutation(run.seed, "inputs.order", len(starts))
        self.starts = [starts[i] for i in order]
        phases["inputs_s"], t = time.perf_counter() - t, time.perf_counter()
        # one detector draw for every seed (the configuration says why)
        self.mtcnn = weights.mtcnn(cfg["detector_weights_seed"], run.device)
        self._seed_face_rates()
        self.params = weights.for_config(cfg, run.seed, run.device)
        self.analyzer = FacialAnalyzer(
            self.mtcnn, self.params, device=run.device, minsize=det["minsize"],
            face_size=det["face_size"], bbox_dilation=det["bbox_dilation"],
            thresholds=tuple(det["thresholds"]), factor=det["factor"],
            max_level_boxes=det["caps"][0], max_stage2=det["caps"][1],
            max_stage3=det["caps"][2], supersample=det["supersample"],
            precision=cfg["precision"])
        # the lanes re-run one by one go through the instance's ``analyze``
        self._rerun_count = 0
        analyze = self.analyzer.analyze

        def counted(img):
            self._rerun_count += 1
            t0 = time.time_ns()
            try:
                return analyze(img)
            finally:
                run.spans.add("analyze", t0, time.time_ns())

        self.analyzer.analyze = counted
        phases["weights_s"], t = time.perf_counter() - t, time.perf_counter()
        for k in range(len(self.starts)):         # every batch of the pool once
            self._call(k, keep=False)
        run.spans.clear()
        phases["warmup_s"] = time.perf_counter() - t

    def _seed_face_rates(self) -> None:
        """Seeded MTCNN weights make as many faces as their draw happens
        to: from a few a photo to thousands, which overflow every cap. So
        each net's face logit bias is set, stage by stage through the plain
        reference's nets, on calibration photos drawn like the pool's from
        the detector's own seed, so that the configuration's
        ``seeded_face_rates`` of the P-Net cells and of the R-Net and O-Net
        candidates pass their thresholds. The detector is then the same for
        every run, and only the photos change with the seed."""
        ref, cfg, dev = self.run.reference, self.cfg, self.run.device
        det = cfg["detector"]
        h, w = self.traffic["photo_hw"]
        photos = [torch.as_tensor(p, device=dev).to(torch.float32) for p in inputs.images(
            cfg["seeded_calibration_photos"], h, w, cfg["detector_weights_seed"],
            "inputs.calibration", dev)]
        s = det["supersample"]
        for net, rate, th in zip(("pnet", "rnet", "onet"), cfg["seeded_face_rates"],
                                 det["thresholds"]):
            mt = ref.on_device(self.mtcnn, dev)
            probs = []
            with torch.no_grad(), ref.fp32_mode("ieee"):
                for img in photos:
                    if net == "pnet":
                        probs += [p.reshape(-1) for *_, p in ref.pnet_maps(mt, img, det)]
                        continue
                    _, _, _, counts = ref.detect(mt, img, det)
                    rects = torch.as_tensor(counts[f"stage{2 if net == 'rnet' else 3}_rects"],
                                            device=dev)
                    if len(rects):
                        x = ref.net_input(img, rects, 24 if net == "rnet" else 48, s)
                        probs.append((ref.rnet if net == "rnet" else ref.onet)(mt[net], x)[-1])
            p = torch.cat(probs).double().clamp(1e-12, 1 - 1e-12) if probs else None
            if p is None or not len(p):
                continue
            margin = torch.log(p) - torch.log1p(-p)       # the face logit's lead
            shift = float(np.log(th / (1 - th)) - torch.quantile(margin, 1.0 - rate))
            bias = self.mtcnn[net]["cls"]["bias"].copy()
            bias[1] += np.float32(shift)
            self.mtcnn[net]["cls"]["bias"] = bias

    def _call(self, k: int, keep: bool = True) -> int:
        start = self.starts[k % len(self.starts)]
        before = self._rerun_count
        out = self.analyzer.analyze_batch(self.pool[start:start + self.traffic["batch"]])
        if keep:
            self.results[k] = (start, out)
            self.reruns.append(self._rerun_count - before)
        return len(out)

    def window(self, seconds: float) -> Window:
        w = closed_loop(self._call, seconds, self.run.spans, self.span)
        w.end_to_end["photos_per_s"] = rate(w.units, w.seconds)
        return w

    def release(self) -> None:
        del self.analyzer
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the plain reference -------------------------------------------------

    def reference(self, photo: int, fp32: str = "ieee") -> Dict:
        key = (photo, fp32)
        if key not in self._ref:
            self._ref[key] = self.run.reference.analyze(
                self.mtcnn, self.params, self.pool[photo], self.run.device, self.cfg, fp32)
        return self._ref[key]

    def context(self) -> Dict:
        """The work figures the per-layer readers take, from the plain
        reference's counts on the pool's photos: the analysis FLOPs and
        K1's crops of the window's photos (the window is the traced one)."""
        if not self.run.traced:
            return {}
        refs = [self.reference(photo) for photo in range(len(self.pool))]
        model = [flops.analysis_flops(r["counts"], self.cfg) for r in refs]
        crops = [self._k1_work(r) for r in refs]
        done = [start + i for start, out in self.results.values() for i in range(len(out))]
        return {"work_at_peak_s": sum(model[p] for p in done) / flops.PEAK_OPS["f32"],
                "reruns": self.reruns, "photos": len(done),
                "k1_work": [w for p in done for w in crops[p]]}

    def _k1_work(self, ref: Dict) -> List[tuple]:
        """[(bytes, ops, "f32")] of the crops one photo needs: the stage 2
        and 3 crops of the reference's candidates (24² and 48², 2x2
        supersampled, zero outside) and the head crops of its faces."""
        h, w = self.traffic["photo_hw"]
        det = self.cfg["detector"]
        out = []
        for key, size in (("stage2_rects", 24), ("stage3_rects", 48)):
            ops, nbytes = flops.crop_work([tuple(map(float, r)) for r in ref["counts"][key]],
                                          h, w, 3, size, det["supersample"], clamp=False)
            out.append((nbytes, ops, "f32"))
        rects = [(float(y1), float(x1), float(y2), float(x2)) for x1, y1, x2, y2 in ref["dilated"]]
        ops, nbytes = flops.crop_work(rects, h, w, 3, det["face_size"], 1, clamp=True)
        out.append((nbytes, ops, "f32"))
        return out

    # -- the comparison ------------------------------------------------------

    def checks(self, control: bool = False) -> Dict[str, float]:
        run, tr = self.run, self.traffic
        pairs = [(k, i) for k in sorted(self.results) for i in range(len(self.results[k][1]))]
        pick = inputs.choice(run.seed, "check", len(pairs), tr["check_sample"])
        mismatched = total = 0
        gaps = {"score_gap": 0.0, "age_gap": 0.0, "male_gap": 0.0, "ident_rel_err": 0.0}
        for j in pick:
            k, lane = pairs[j]
            photo = self.results[k][0] + lane
            ref = self.reference(photo)
            if control:
                c = self.reference(photo, "tf32")
                got = [(c["boxes"][f], c["scores"][f], c["ages"][f], c["male"][f],
                        c["identity"][f]) for f in range(len(c["boxes"]))]
            else:
                got = [(np.array(f.raw_bbox, np.float32), f.score, f.age, f.gender_prob,
                        f.identity) for f in self.results[k][1][lane]]
            used = set()
            for r in range(len(ref["boxes"])):
                match = next((g for g in range(len(got)) if g not in used and np.max(
                    np.abs(got[g][0] - ref["boxes"][r])) <= tr["same_box_px"]), None)
                if match is None:
                    continue
                used.add(match)
                box, score, age, male, ident = got[match]
                gaps["score_gap"] = max(gaps["score_gap"], abs(score - ref["scores"][r]))
                gaps["age_gap"] = max(gaps["age_gap"], abs(age - ref["ages"][r]))
                gaps["male_gap"] = max(gaps["male_gap"], abs(male - ref["male"][r]))
                rid = ref["identity"][r]
                gaps["ident_rel_err"] = max(gaps["ident_rel_err"], float(
                    np.linalg.norm(ident - rid) / max(np.linalg.norm(rid), 1e-30)))
            total += len(ref["boxes"]) + len(got)
            mismatched += len(ref["boxes"]) + len(got) - 2 * len(used)
        return {"box_mismatch_share": mismatched / total if total else 0.0,
                **{k: float(v) for k, v in gaps.items()}}
