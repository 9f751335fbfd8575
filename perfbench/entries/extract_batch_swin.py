"""``extract_batch`` (closed-loop batch embedding, ``extract_batch.py``) on
a Swin configuration: the seeded weights and the FLOP count come from
``perfbench/swin.py``, and the window counts K8's launches, which the
windowed attention's roofline reader matches against the trace's."""

from __future__ import annotations

import time
from typing import Dict

from .. import flops, inputs, swin
from . import Window
from .extract_batch import Entry as BatchEntry


def k8_launches() -> int:
    """K8's launches so far in this process."""
    from hse_facerec_torch.ops.kernels.attention import window_attention

    return window_attention.launches


class Entry(BatchEntry):
    def setup(self) -> None:
        from hse_facerec_torch.models.zoo import build_extractor

        run, cfg, tr = self.run, self.cfg, self.traffic
        phases, t = run.phases, time.perf_counter()
        self.params = swin.weights(cfg, run.seed, run.device)
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

    def window(self, seconds: float) -> Window:
        before = k8_launches()
        w = super().window(seconds)
        self.winattn_launches = k8_launches() - before
        return w

    def work_at_peak_s(self) -> float:
        """Least time the window's embeddings need at the f32 peak."""
        return self.faces * swin.flops(self.cfg) / flops.PEAK_OPS["f32"]

    def context(self) -> Dict:
        """Besides the work at the peak: K8's launches in the window and the
        (operations, bytes) of each launch of a chunk of ``batch_size``
        rows, in launch order."""
        return {"work_at_peak_s": self.work_at_peak_s(),
                "winattn_launches": self.winattn_launches,
                "winattn_work": swin.window_attention_work(self.cfg,
                                                           self.traffic["batch_size"])}
