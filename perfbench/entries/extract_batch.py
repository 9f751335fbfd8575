"""Closed-loop batch embedding: ``EmbeddingExtractor.extract_batch`` on
``batch`` crops a call, at the extractor's ``batch_size``, the calls
cycling through a seeded pool of crops made in set-up (the enrolment of a
photo collection into a face-ID system).

What is compared: a sample of the embeddings the window returned, drawn
from the seed (``per_call`` rows kept from each call, ``sample`` of those
judged), against the plain reference on the same crops: the worst row's
relative L2 error, ``emb_rel_err``."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import flops, inputs, weights
from ..stats import rate
from . import Window, closed_loop


class Entry:
    span = "extract_batch"
    span_priority = ["extract_batch"]

    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic = run.cfg, run.traffic
        self.kept: List[tuple] = []          # (pool row, program's embedding)

    def setup(self) -> None:
        from hse_facerec_torch.models.zoo import build_extractor

        run, cfg, tr = self.run, self.cfg, self.traffic
        phases, t = run.phases, time.perf_counter()
        self.params = weights.for_config(cfg, run.seed, run.device)
        self.extractor = build_extractor(cfg["zoo_entry"], batch_size=tr["batch_size"],
                                         device=run.device, params=self.params,
                                         precision=cfg["precision"])
        phases["weights_s"], t = time.perf_counter() - t, time.perf_counter()
        size = cfg["input_size"]
        self.pool = inputs.images(tr["pool"], size, size, run.seed, "inputs.crops",
                                  run.device)
        self.starts = list(range(0, tr["pool"] - tr["batch"] + 1, tr["batch"]))
        phases["inputs_s"], t = time.perf_counter() - t, time.perf_counter()
        for k in range(tr["warmup_calls"]):
            self._call(k, keep=False)
        phases["warmup_s"] = time.perf_counter() - t

    def _call(self, k: int, keep: bool = True) -> int:
        start = self.starts[k % len(self.starts)]
        out = self.extractor.extract_batch(self.pool[start:start + self.traffic["batch"]])
        if keep:
            rows = inputs.choice(self.run.seed, f"keep.{k}", len(out),
                                 self.traffic["check_per_call"])
            self.kept += [(start + int(r), out[r].copy()) for r in rows]
        return len(out)

    def window(self, seconds: float) -> Window:
        w = closed_loop(self._call, seconds, self.run.spans, self.span)
        w.end_to_end["faces_per_s"] = rate(w.units, w.seconds)
        self.faces = w.units
        return w

    def work_at_peak_s(self) -> float:
        """Least time the window's embeddings need at the f32 peak."""
        return self.faces * flops.model_flops(self.cfg) / flops.PEAK_OPS["f32"]

    def release(self) -> None:
        del self.extractor
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def checks(self, control: bool = False) -> Dict[str, float]:
        run = self.run
        pick = inputs.choice(run.seed, "check", len(self.kept), self.traffic["check_sample"])
        rows = np.array([self.kept[i][0] for i in pick])
        ref = run.reference.embed(self.params, self.pool[rows], run.device, self.cfg)
        if control:
            got = run.reference.embed(self.params, self.pool[rows], run.device, self.cfg,
                                      fp32="tf32")
        else:
            got = torch.as_tensor(np.stack([self.kept[i][1] for i in pick]),
                                  device=ref.device)
        err = (torch.linalg.vector_norm(got.to(ref.dtype) - ref, dim=1)
               / torch.linalg.vector_norm(ref, dim=1).clamp_min(1e-30))
        return {"emb_rel_err": float(err.max())}

    def context(self) -> Dict:
        return {"work_at_peak_s": self.work_at_peak_s()}
