"""The port's tracing: ``StageTimer``'s spans and counters on the device
trace's clock, the spans and counters ``EmbeddingExtractor`` records with
a timer (and that it records nothing and reads no clock without one), and
the benchmark's readers of them (``perfbench/embed_spans.py``): on
synthetic traces, and in tiny runs of the enrolment cells on the CPU,
where no device metric may be reported."""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from hse_facerec_torch.pipelines.embedder import EmbeddingExtractor
from hse_facerec_torch.utils import profiling
from hse_facerec_torch.utils.profiling import StageTimer

STATS_KEYS = {"count", "total_s", "mean_ms", "p50_ms", "p95_ms"}
CHUNK_SPANS = ("embed.upload", "embed.forward", "embed.fetch")
SIZE = (8, 8)


# ---------- StageTimer ----------

def test_stage_keeps_spans_with_their_parents_and_samples():
    timer = StageTimer()
    with timer.stage("outer") as outer:
        with timer.stage("inner") as inner:
            pass
        with timer.stage("adopted", parent=99) as adopted:
            pass
    with timer.stage("root") as root:
        pass
    spans = {s.name: s for s in timer.spans()}
    assert len({outer, inner, adopted, root}) == 4
    assert spans["outer"].parent_id is None and spans["root"].parent_id is None
    assert spans["inner"].parent_id == outer and spans["inner"].span_id == inner
    assert spans["adopted"].parent_id == 99
    for s in spans.values():
        assert s.start_ns <= s.end_ns
    assert spans["outer"].start_ns <= spans["inner"].start_ns <= spans["inner"].end_ns \
        <= spans["outer"].end_ns
    stats = timer.stats()
    assert set(stats) == {"outer", "inner", "adopted", "root"}
    assert all(set(v) == STATS_KEYS and v["count"] == 1 for v in stats.values())
    assert stats["outer"]["total_s"] == pytest.approx(
        (spans["outer"].end_ns - spans["outer"].start_ns) / 1e9)


def test_counts_and_added_samples_add_up():
    timer = StageTimer()
    for n in (3, 4, 5):
        timer.count("bytes", n)
    timer.count("calls")
    timer.add("process", 0.25)
    timer.add("process", 0.75)
    assert timer.counts() == {"bytes": 12, "calls": 1}
    stats = timer.stats()["process"]
    assert set(stats) == STATS_KEYS
    assert stats["count"] == 2 and stats["total_s"] == pytest.approx(1.0)
    assert stats["mean_ms"] == pytest.approx(500.0)
    assert timer.spans() == []             # a sample taken elsewhere is no span


def test_spans_and_samples_are_bounded():
    timer = StageTimer(max_samples=2, max_spans=3)
    for _ in range(5):
        with timer.stage("s"):
            pass
    ids = [s.span_id for s in timer.spans()]
    assert len(ids) == 3 and ids == sorted(ids)
    assert timer.stats()["s"]["count"] == 2


@pytest.mark.parametrize("how", ["disabled", "reset"])
def test_disabled_and_reset_keep_nothing(how):
    timer = StageTimer(enabled=how != "disabled")
    with timer.stage("s") as span_id:
        pass
    timer.count("n", 2)
    timer.add("a", 1.0)
    if how == "reset":
        assert span_id is not None and timer.spans() and timer.counts()
        timer.reset()
    else:
        assert span_id is None
    assert timer.spans() == [] and timer.counts() == {} and timer.stats() == {}


def test_each_thread_names_its_own_parents():
    """More threads than cores, switching often: no span, id or count is
    lost, and each chunk names its own thread's call."""
    n = (os.cpu_count() or 4) + 2
    timer = StageTimer()
    barrier = threading.Barrier(n)

    def work(k):
        with timer.stage(f"call{k}"):
            barrier.wait(timeout=60)
            for _ in range(50):
                with timer.stage(f"chunk{k}"):
                    timer.count("chunks")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    spans = timer.spans()
    calls = {s.name: s.span_id for s in spans if s.name.startswith("call")}
    assert len({s.span_id for s in spans}) == len(spans) == 51 * n
    for s in spans:
        if s.name.startswith("chunk"):
            assert s.parent_id == calls[f"call{s.name[5:]}"]
    assert timer.counts() == {"chunks": 50 * n}


def test_a_span_and_the_profilers_event_share_one_clock():
    from torch.profiler import ProfilerActivity, profile

    timer = StageTimer()
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("mm"):
            torch.mm(a, a)
    (span,) = timer.spans()
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert span.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= span.end_ns
    assert abs(profiling.now_ns() - time.time_ns()) < 10**9


# ---------- EmbeddingExtractor ----------

def _extractor(timer=None, **kw):
    w = np.random.RandomState(0).randn(SIZE[0] * SIZE[1] * 3, 16).astype(np.float32)
    kw.setdefault("device", "cpu")
    return EmbeddingExtractor(lambda p, x: x.reshape(len(x), -1) @ p["w"], {"w": w}, SIZE,
                              normalization="caffe", batch_size=256, l2_normalize_output=True,
                              convert=lambda p, dev: {k: torch.as_tensor(v, device=dev)
                                                      for k, v in p.items()},
                              timer=timer, **kw)


def _images(n, seed=1):
    return (np.random.RandomState(seed).rand(n, *SIZE, 3) * 255).astype(np.uint8)


def _names(spans):
    return sorted(s.name for s in spans)


@pytest.mark.parametrize("n,chunks,padded", [(1024, 4, 0), (300, 2, 20)])
def test_extract_batch_records_its_spans_and_counts(n, chunks, padded):
    """1,024 rows at batch 256 are four chunks; 300 are a full chunk and
    a tail of 44 padded to the bucket of 64."""
    images = _images(n)
    want = _extractor().extract_batch(images)
    timer = StageTimer()
    with timer.stage("caller") as caller:
        got = _extractor(timer).extract_batch(images)
    np.testing.assert_array_equal(got, want)          # bit-equal with the timer
    spans = timer.spans()
    assert _names(spans) == sorted(["caller", "embed.call", "embed.fetch"]
                                   + ["embed.upload", "embed.forward"] * chunks)
    (call,) = [s for s in spans if s.name == "embed.call"]
    assert call.parent_id == caller
    for s in spans:
        if s.name in CHUNK_SPANS:
            assert s.parent_id == call.span_id
            assert call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
    assert timer.counts() == {"embed.upload_bytes": (n + padded) * SIZE[0] * SIZE[1] * 3,
                              "embed.rows": n, "embed.padded_rows": padded}
    stats = timer.stats()
    assert stats["embed.upload"]["count"] == stats["embed.forward"]["count"] == chunks


def test_without_a_timer_no_clock_is_read(monkeypatch):
    images = _images(300)
    want = _extractor(StageTimer()).extract_batch(images)

    def no_clock():
        raise AssertionError("a clock was read")

    ex = _extractor()
    with monkeypatch.context() as m:
        for mod, name in ((profiling, "now_ns"), (time, "time_ns"), (time, "perf_counter"),
                          (time, "monotonic"), (time, "time")):
            m.setattr(mod, name, no_clock)
        got = ex.extract_batch(images)
    np.testing.assert_array_equal(got, want)
    assert ex.timer is None


@pytest.mark.parametrize("timed", [False, True], ids=["untimed", "timed"])
def test_the_uploaded_rows_are_freed_once_converted(monkeypatch, timed):
    """The forward holds the only reference to a chunk's uploaded uint8
    rows, so they are freed when converted to f32, as without spans: the
    card's peak memory stays the same."""
    import weakref

    uploaded, alive = [], []
    real = EmbeddingExtractor._forward_on

    def spy(self, params, x):
        uploaded.append(weakref.ref(x))
        box = [x]
        del x
        return real(self, params, box.pop())

    monkeypatch.setattr(EmbeddingExtractor, "_forward_on", spy)
    ex = _extractor(StageTimer() if timed else None)
    model_fn = ex.model_fn
    ex.model_fn = lambda p, x: alive.append(uploaded[-1]() is not None) or model_fn(p, x)
    ex.extract_batch(_images(300))
    assert alive == [False, False]


def test_extract_files_records_the_same_spans():
    images = _images(300)
    timer = StageTimer()
    got = _extractor(timer).extract_files(list(range(300)), loader=lambda i: images[i],
                                          decode_workers=0)
    np.testing.assert_array_equal(got, _extractor().extract_batch(images))
    spans = timer.spans()
    (call,) = [s for s in spans if s.name == "embed.call"]
    assert {s.name for s in spans} == {"embed.call", *CHUNK_SPANS}
    assert all(s.parent_id == call.span_id for s in spans if s.name != "embed.call")
    # two full batches, then the tail of 44 padded to a whole batch
    assert [s.name for s in spans].count("embed.upload") == 2
    assert timer.counts() == {"embed.upload_bytes": 512 * SIZE[0] * SIZE[1] * 3,
                              "embed.rows": 300, "embed.padded_rows": 212}


def test_the_mesh_branch_records_the_same_spans():
    from hse_facerec_torch.parallel.sharding import make_mesh

    images = _images(300)
    timer = StageTimer()
    got = _extractor(timer, mesh=make_mesh(devices=["cpu"] * 2)).extract_batch(images)
    np.testing.assert_allclose(got, _extractor().extract_batch(images), rtol=1e-6, atol=1e-6)
    spans = timer.spans()
    (call,) = [s for s in spans if s.name == "embed.call"]
    assert all(s.parent_id == call.span_id for s in spans if s.name != "embed.call")
    # each chunk: its upload, forward and gather; then the copy back
    assert _names(spans) == sorted(["embed.call", "embed.fetch"] + list(CHUNK_SPANS) * 2)
    counts = timer.counts()
    assert counts["embed.rows"] == 300 and counts["embed.padded_rows"] == 20
    assert counts["embed.upload_bytes"] == 320 * SIZE[0] * SIZE[1] * 3


@pytest.mark.parametrize("shards", [1, 2], ids=["cpu", "mesh"])
def test_the_cpu_and_the_mesh_keep_the_direct_copy(monkeypatch, shards):
    """Only a card without a mesh stages its uploads (``UploadRing``): the
    CPU and the mesh's ``split_batch`` copy directly, count no staged chunk
    and return the direct copy's forwards bit for bit."""
    from hse_facerec_torch.parallel.sharding import make_mesh
    from hse_facerec_torch.pipelines.embedder import UploadRing

    def refuse(self, rows):
        raise AssertionError("staged off the card")

    monkeypatch.setattr(UploadRing, "upload", refuse)
    images = _images(300)
    timer = StageTimer()
    mesh = make_mesh(devices=["cpu"] * shards) if shards > 1 else None
    ex = _extractor(timer, mesh=mesh)
    got = ex.extract_batch(images)
    assert ex._uploads is None
    counts = timer.counts()
    assert "embed.upload_staged" not in counts and "embed.upload_slot_waits" not in counts
    # a chunk of 256, then the tail of 44 padded with its last row to 64;
    # each chunk's shards forward on their own
    padded = np.concatenate([images, np.repeat(images[-1:], 20, axis=0)])
    want = np.concatenate([ex._forward_on(ex.params, torch.from_numpy(part)).numpy()
                           for chunk in (padded[:256], padded[256:])
                           for part in np.split(chunk, shards)])[:300]
    np.testing.assert_array_equal(got, want)


def test_build_extractor_hands_on_the_timer():
    from hse_facerec_torch.models.zoo import build_extractor

    timer = StageTimer()
    assert build_extractor("vgg2_mobilenet", device="cpu", timer=timer).timer is timer
    assert build_extractor("vgg2_mobilenet", device="cpu").timer is None


# ---------- the benchmark's readers ----------

S = 1_000_000_000


class _Ctx:
    def __init__(self, trace, spans, counts=None):
        from perfbench.trace import Spans

        self.trace = trace
        self.spans = Spans()
        for name, s, e in spans:
            self.spans.add(name, s, e)
        self.entry = {"work_at_peak_s": 0.0}
        if counts is not None:
            self.entry["counts"] = counts


def _trace():
    """One second: kernels over [0.1, 0.3], [0.5, 0.6] and [0.9, 1.0] s, a
    0.1-s upload copy over [0.0, 0.1]; idle [0, 0.1], [0.3, 0.5] and
    [0.6, 0.9]: 60%."""
    from perfbench.trace import TraceSummary

    return TraceSummary([("Memcpy HtoD (Pageable -> Device)", S, S + S // 10),
                         ("conv", S + S // 10, S + 3 * S // 10),
                         ("bn", S + 5 * S // 10, S + 6 * S // 10),
                         ("conv", S + 9 * S // 10, 2 * S)], S, 2 * S)


# the program's spans over the idle gaps' midpoints (0.05, 0.4, 0.75 s):
# the upload, the launches, and the caller's loop outside the program
SPANS = [("extract_batch", S, 2 * S), ("embed.upload", S, S + S // 10 + 1),
         ("embed.forward", S + 3 * S // 10, S + 5 * S // 10)]


def _reader(name):
    from perfbench.spec import HERE, load_module

    return load_module(HERE / "metrics" / f"{name}.py")


READERS = ["idle_upload.enroll", "idle_upload.enroll.multihead", "idle_launch.enroll",
           "idle_launch.enroll.multihead", "idle_fetch.enroll", "idle_fetch.enroll.multihead",
           "upload_gbps.enroll.multihead"]


@pytest.mark.parametrize("tag", ["enroll", "enroll.multihead"])
def test_the_idle_shares_partition_device_idle(tag):
    from perfbench import readers

    ctx = _Ctx(_trace(), SPANS, {"embed.upload_bytes": 5 * 10**8})
    shares = {n: _reader(f"{n}.{tag}").read(ctx)
              for n in ("idle_upload", "idle_launch", "idle_fetch")}
    assert shares == {"idle_upload": pytest.approx(10.0), "idle_launch": pytest.approx(20.0),
                      "idle_fetch": 0.0}
    outside = dict(ctx.trace.idle_gaps(ctx.spans.items, ["embed.upload", "embed.forward",
                                                         "embed.fetch"]))["no span"]
    assert sum(shares.values()) + 100 * outside / ctx.trace.window_s == pytest.approx(
        readers.device_idle(ctx)) == pytest.approx(60.0)
    # a fetch span over the last gap takes it from the caller's loop
    ctx = _Ctx(_trace(), SPANS + [("embed.fetch", S + 6 * S // 10, S + 9 * S // 10)])
    assert _reader(f"idle_fetch.{tag}").read(ctx) == pytest.approx(30.0)


def test_upload_gbps_is_bytes_over_the_copies_device_time():
    ctx = _Ctx(_trace(), SPANS, {"embed.upload_bytes": 5 * 10**8})
    assert _reader("upload_gbps.enroll.multihead").read(ctx) == pytest.approx(5.0)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("missing", ["trace", "program"])
def test_a_reader_finds_nothing_without_a_trace_or_the_programs_spans(name, missing):
    if missing == "trace":
        ctx = _Ctx(None, SPANS, {"embed.upload_bytes": 5 * 10**8})
    else:
        ctx = _Ctx(_trace(), [("extract_batch", S, 2 * S)])
    assert _reader(name).read(ctx) is None


# ---------- tiny runs of the enrolment cells on the CPU ----------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from perfbench.spec import Benchmark
    from perfbench.tests.conftest import make_tiny

    root = make_tiny(tmp_path_factory.mktemp("tiny"))
    return Benchmark(root, pkg=root / "perfbench")


@pytest.mark.parametrize("timed", [False, True], ids=["plain", "timed"])
@pytest.mark.parametrize("cell", ["arcface-enroll", "multihead-enroll"])
def test_a_traced_enrol_run_reports_no_device_metric_on_the_cpu(tiny, cell, timed):
    from perfbench import embed_spans, run

    execute = embed_spans.execute_timed if timed else run.execute
    result, compared = execute(tiny, tiny.workload(cell), 2 ** 31 + 77, 1.0, True,
                               device="cpu", t0_ns=time.time_ns())
    assert result["correct"], compared
    names = {m["name"] for m in tiny.per_layer(cell)}
    assert set(result["metrics"]) <= names and result["metrics"]
    # no card here: the device's numbers are left out, never read as 0
    assert not any("idle" in n or "gbps" in n for n in result["metrics"])
    assert "breakdown" not in result


def test_the_timed_entry_hands_the_window_its_spans_and_counts(tiny):
    from perfbench import embed_spans, entries, run

    r = run.Run(tiny, tiny.workload("multihead-enroll"), 2 ** 31 + 78, "cpu")
    r.traced = True
    entry = embed_spans.timed(entries.load(r.traffic["entry"]))(r)
    entry.setup()
    w = entry.window(0.5)
    names = {n for n, _, _ in r.spans.items}
    assert names == {"extract_batch", *CHUNK_SPANS}
    assert entry.span_priority == [*CHUNK_SPANS, "extract_batch"]
    counts = entry.context()["counts"]
    size = r.cfg["input_size"]
    assert counts == {"embed.upload_bytes": w.units * size * size * 3, "embed.rows": w.units,
                      "embed.padded_rows": 0}
    entry.release()
