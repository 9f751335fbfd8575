"""``UploadRing``: a chunk's host rows staged in page-locked slots and
copied to the card on a side stream, one ring per calling thread.

On the CPU, fakes of ``CudaStaging`` drive the ring: a slot is rewritten
only after its last copy's event has been waited on, slots grow to the
largest chunk and are reused below it, each thread gets its own ring, and
an extractor counts its staged chunks and its waits. On the card (tests
marked ``cuda``, which skip without one) the staged path's embeddings are
bit-equal to the direct copy's, from one thread and from two at once, the
host queues a call's chunks without waiting for a busy card, and the rows
handed to the forward belong to the side stream and are recorded onto the
caller's.

This file imports no JAX, so the card tests run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_upload.py
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from hse_facerec_torch.pipelines.embedder import EmbeddingExtractor, UploadRing
from hse_facerec_torch.utils.profiling import StageTimer

SIZE = (8, 8)


class FakeEvent:
    """A copy's event: unfinished from its record until waited on, or
    until a test marks it done."""

    def __init__(self, log):
        self.log = log
        self.done = True

    def record(self, stream):
        self.log.append(("record", self, stream))
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.log.append(("synchronize", self))
        self.done = True


class FakeStream:
    def __init__(self, log, name):
        self.log = log
        self.name = name

    def wait_event(self, event):
        self.log.append(("wait_event", self, event))


class FakeCuda:
    """``CudaStaging`` on the CPU: pinned buffers are plain tensors, and
    every call the ring makes is logged with its thread."""

    def __init__(self):
        self.log = []
        self.allocs = []
        self._current = FakeStream(self.log, "current")
        self._sides = 0
        self._lock = threading.Lock()

    def pinned(self, nbytes):
        buf = torch.zeros(nbytes, dtype=torch.uint8)
        with self._lock:
            self.allocs.append((threading.get_ident(), nbytes))
            self.log.append(("pinned", buf))
        return buf

    def event(self):
        return FakeEvent(self.log)

    def stream(self):
        with self._lock:
            self._sides += 1
            return FakeStream(self.log, f"side{self._sides}")

    def current(self):
        return self._current

    @contextlib.contextmanager
    def on(self, stream):
        with self._lock:
            self.log.append(("on", threading.get_ident(), stream))
        yield

    def record(self, tensor, stream):
        self.log.append(("record_stream", weakref.ref(tensor), stream))


def _rows(n, seed, dtype=np.uint8):
    return (np.random.RandomState(seed).rand(n, *SIZE, 3) * 255).astype(dtype)


def _ring():
    cuda = FakeCuda()
    return UploadRing("cpu", cuda), cuda


def test_a_slot_is_rewritten_only_after_its_copy_was_waited_on(monkeypatch):
    ring, cuda = _ring()
    a, b, c, d = (_rows(4, s) for s in range(4))
    seen_at_wait = []
    synchronize = FakeEvent.synchronize

    def spy(event):
        # what slot 0 holds when the host waits: still the rows of its last copy
        seen_at_wait.append(ring._local.slots[0].buf[:a.nbytes].numpy().copy())
        synchronize(event)

    monkeypatch.setattr(FakeEvent, "synchronize", spy)
    xa, wa = ring.upload(a)
    xb, wb = ring.upload(b)
    xc, wc = ring.upload(c)                 # slot 0 again, its copy unfinished
    ring._local.slots[1].event.done = True  # slot 1's copy has finished
    xd, wd = ring.upload(d)
    assert (wa, wb, wc, wd) == (False, False, True, False)
    assert len(seen_at_wait) == 1
    np.testing.assert_array_equal(seen_at_wait[0], a.reshape(-1))
    for x, rows in ((xa, a), (xb, b), (xc, c), (xd, d)):
        np.testing.assert_array_equal(x.numpy(), rows)
    np.testing.assert_array_equal(ring._local.slots[0].buf.numpy(), c.reshape(-1))
    # each upload: its copy under the side stream, the slot's event recorded
    # there, the caller's stream waiting on it, the rows recorded onto it
    side, current = ring._local.side, cuda.current()
    per_upload = [("on", side), ("record", side), ("wait_event", current),
                  ("record_stream", current)]
    streams = {"on": 2, "record": 2, "wait_event": 1, "record_stream": 2}
    got = [(e[0], e[streams[e[0]]]) if e[0] in streams else (e[0],)
           for e in cuda.log if e[0] != "pinned"]
    assert got == per_upload * 2 + [("synchronize",)] + per_upload * 2
    assert len(ring._local.slots) == UploadRing.SLOTS == 2


def test_a_slot_grows_to_the_largest_chunk_and_is_reused_below_it():
    ring, cuda = _ring()
    row = SIZE[0] * SIZE[1] * 3
    for n, seed in ((8, 0), (8, 1), (16, 2), (4, 3), (16, 4), (12, 5), (2, 6)):
        x, _ = ring.upload(_rows(n, seed))
        np.testing.assert_array_equal(x.numpy(), _rows(n, seed))
    # slot 0 took 8, 16, 16, 2 rows; slot 1 took 8, 4, 12
    assert [b for _, b in cuda.allocs] == [8 * row, 8 * row, 16 * row, 12 * row]
    assert [s.buf.numel() for s in ring._local.slots] == [16 * row, 12 * row]
    # a byte buffer viewed as the rows' dtype: float rows stage as well
    f = _rows(3, 7, np.float32)
    x, _ = ring.upload(f)
    assert x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), f)
    assert len(cuda.allocs) == 4                # 3 float rows fit slot 1's bytes


def test_each_thread_gets_its_own_ring():
    ring, cuda = _ring()
    barrier = threading.Barrier(2)
    out, errors = {}, []

    def work(k):
        try:
            barrier.wait(timeout=10)
            got = [ring.upload(_rows(4, 10 * k + i))[0].numpy() for i in range(3)]
            out[k] = (threading.get_ident(), ring._local.side, got)
        except Exception as e:          # reported below, with its thread
            errors.append((k, e))

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    (id0, side0, got0), (id1, side1, got1) = out[0], out[1]
    assert side0 is not side1
    for k, got in ((0, got0), (1, got1)):
        for i, x in enumerate(got):
            np.testing.assert_array_equal(x, _rows(4, 10 * k + i))
    # two slots a thread, each used on its own thread's side stream only
    assert sorted(t for t, _ in cuda.allocs) == sorted([id0, id0, id1, id1])
    sides = {(t, s.name) for kind, t, s in (e for e in cuda.log if e[0] == "on")}
    assert sides == {(id0, side0.name), (id1, side1.name)}
    assert not hasattr(ring._local, "slots")    # the main thread has none


def _extractor(timer=None):
    w = np.random.RandomState(0).randn(SIZE[0] * SIZE[1] * 3, 16).astype(np.float32)
    return EmbeddingExtractor(lambda p, x: x.reshape(len(x), -1) @ p["w"], {"w": w}, SIZE,
                              normalization="caffe", batch_size=256, l2_normalize_output=True,
                              device="cpu",
                              convert=lambda p, dev: {k: torch.as_tensor(v, device=dev)
                                                      for k, v in p.items()},
                              timer=timer)


@pytest.mark.parametrize("n,chunks", [(1024, 4), (300, 2)])
def test_an_extractor_counts_its_staged_chunks_and_waits(n, chunks):
    """With the ring's fakes (copies that finish only when waited on),
    every chunk past the second waits for its slot."""
    images = _rows(n, 3)
    want = _extractor().extract_batch(images)
    timer = StageTimer()
    ex = _extractor(timer)
    ex._uploads = UploadRing("cpu", FakeCuda())
    np.testing.assert_array_equal(ex.extract_batch(images), want)
    counts = timer.counts()
    assert counts["embed.upload_staged"] == chunks
    assert counts["embed.upload_slot_waits"] == max(0, chunks - UploadRing.SLOTS)
    assert timer.stats()["embed.upload"]["count"] == chunks


def test_the_staged_rows_are_freed_once_converted(monkeypatch):
    """The ring keeps no reference to the device rows it hands over, so
    they are freed when the forward converts them, as on the direct path."""
    uploaded, alive = [], []
    real = EmbeddingExtractor._forward_on

    def spy(self, params, x):
        uploaded.append(weakref.ref(x))
        box = [x]
        del x
        return real(self, params, box.pop())

    monkeypatch.setattr(EmbeddingExtractor, "_forward_on", spy)
    ex = _extractor(StageTimer())
    ex._uploads = UploadRing("cpu", FakeCuda())
    model_fn = ex.model_fn
    ex.model_fn = lambda p, x: alive.append(uploaded[-1]() is not None) or model_fn(p, x)
    ex.extract_batch(_rows(300, 4))
    assert alive == [False, False]


# ---------- on the card ----------

CROP = 224


@pytest.fixture(scope="module")
def card():
    """The multi-head MobileNet's identity embedder at batch 256 on the
    card, on seeded weights: 224² crops, no resize."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hse_facerec_torch.models.zoo import build_extractor
    from hse_facerec_torch.testing import random_multihead_params

    return build_extractor("agegender_identity", batch_size=256, device="cuda",
                           params=random_multihead_params(np.random.RandomState(0)))


def _crops(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, CROP, CROP, 3), dtype=np.uint8)


def _direct(ex, images):
    """The same extractor with the direct pageable copy."""
    ring, ex._uploads = ex._uploads, None
    try:
        return ex.extract_batch(images)
    finally:
        ex._uploads = ring


@pytest.mark.cuda
def test_staged_embeddings_equal_the_direct_copys_on_the_card(card):
    timer = StageTimer()
    card.timer = timer
    try:
        images = np.empty((1024, CROP, CROP, 3), np.uint8)
        for call in range(3):
            images[...] = _crops(1024, 20 + call)    # the caller rewrites its array
            got = card.extract_batch(images)
            np.testing.assert_array_equal(got, _direct(card, _crops(1024, 20 + call)))
        counts = timer.counts()
        assert counts["embed.upload_staged"] == 3 * 4      # the direct calls stage nothing
        assert counts["embed.upload_slot_waits"] <= 3 * 2
        timer.reset()
        tail = _crops(300, 30)
        np.testing.assert_array_equal(card.extract_batch(tail), _direct(card, tail))
        assert timer.counts()["embed.upload_staged"] == 2
    finally:
        card.timer = None


@pytest.mark.cuda
def test_two_threads_on_one_extractor_get_the_direct_copys_embeddings(card):
    inputs = {k: [_crops(512, 40 + 10 * k + i) for i in range(3)] for k in range(2)}
    want = {k: [_direct(card, x) for x in xs] for k, xs in inputs.items()}
    barrier = threading.Barrier(2)
    got, errors = {}, []

    def work(k):
        try:
            barrier.wait(timeout=60)
            got[k] = [card.extract_batch(x) for x in inputs[k]]
        except Exception as e:          # reported below, with its thread
            errors.append((k, e))

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for k in range(2):
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_queueing_a_calls_chunks_does_not_wait_for_the_card(card):
    """With the card busy for most of a second, the host stages and queues
    four chunks' uploads and forwards without waiting for it: the copies
    run on the side stream, and the forward copies nothing from the
    host."""
    chunk = _crops(256, 60)
    card.extract_batch(chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(1_500_000_000)        # cycles: about 0.8 s at the H100's clock
    outs = [card._forward(chunk) for _ in range(4)]
    queued = time.perf_counter() - t0
    torch.cuda.synchronize()
    done = time.perf_counter() - t0
    assert done > 0.4 and queued < 0.25 * done, (queued, done)
    assert len(outs) == 4


def _segment_stream(ptr):
    """The stream that owns the caching allocator's block holding ``ptr``."""
    for seg in torch.cuda.memory_snapshot():
        if seg["address"] <= ptr < seg["address"] + seg["total_size"]:
            return seg["stream"]
    raise AssertionError(f"no segment holds {ptr:#x}")


@pytest.mark.cuda
def test_the_forwards_rows_belong_to_the_side_stream_and_are_recorded_onto_the_callers(
        card, monkeypatch):
    seen, recorded = [], []
    real = EmbeddingExtractor._forward_on

    def spy(self, params, x):
        seen.append((x.data_ptr(), _segment_stream(x.data_ptr()),
                     torch.cuda.current_stream().cuda_stream))
        return real(self, params, x)

    monkeypatch.setattr(EmbeddingExtractor, "_forward_on", spy)
    staging = card._uploads.cuda
    record = staging.record
    monkeypatch.setattr(staging, "record",
                        lambda t, s: recorded.append((t.data_ptr(), s.cuda_stream))
                        or record(t, s))
    compute = torch.cuda.Stream()
    with torch.cuda.stream(compute):        # the caller's stream, whatever it is
        card.extract_batch(_crops(512, 50))
    card.extract_batch(_crops(512, 51))
    side = card._uploads._local.side.cuda_stream
    default = torch.cuda.default_stream().cuda_stream
    assert [s for _, s, _ in seen] == [side] * 4
    assert [c for _, _, c in seen] == [compute.cuda_stream] * 2 + [default] * 2
    assert recorded == [(p, c) for p, _, c in seen]
    assert side not in (compute.cuda_stream, default)
