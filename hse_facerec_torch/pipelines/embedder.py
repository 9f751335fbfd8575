"""Batched face-embedding extraction.

Counterpart of ``hse_facerec_tf_tpu/pipelines/embedder.py``: a uint8 batch
goes to the device, is resized (matmuls), normalized and run through the
backbone, in batches instead of the reference's one ``sess.run`` per image
(``facerec_test.py:114-122``). With a ``mesh`` the params are replicated on
its devices and each batch is split over them.

On a CUDA device without a mesh, a chunk's rows reach the card through
``UploadRing``: staged in page-locked memory and copied on a side stream,
so the copy engine moves the next chunk while the SMs run this one's
forward, and the host queues a whole call's forwards without blocking.

With a ``timer`` (``utils.profiling.StageTimer``) every call records its
spans on the device trace's clock: ``embed.call`` around the call and,
each with the call as its parent, ``embed.upload`` (host rows to a device
tensor; through the ring: the wait for a free slot, the host copy into it
and the copy's launch), ``embed.forward`` (the launches of one chunk's
forward: host enqueue time, no sync) and ``embed.fetch`` (the copies back,
where the host waits for the card); and the counters
``embed.upload_bytes``, ``embed.upload_staged`` (chunks that went through
the ring), ``embed.upload_slot_waits`` (times the host waited for a slot's
last copy), ``embed.rows`` (rows returned) and ``embed.padded_rows``
(padding computed and thrown away).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.preprocess import NORMALIZERS
from ..ops.resize import resize, resize_host
from ..params import to_torch
from ..parallel.sharding import gather, pad_batch, split_batch
from .detector import resolve_device

_UNTIMED = contextlib.nullcontext()


class CudaStaging:
    """What ``UploadRing`` asks of CUDA on ``device``; the CPU tests hand
    the ring fakes of it."""

    def __init__(self, device):
        self.device = torch.device(device)

    def pinned(self, nbytes: int) -> torch.Tensor:
        """A page-locked host byte buffer."""
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def event(self):
        return torch.cuda.Event()

    def stream(self):
        """A side stream for the copies."""
        return torch.cuda.Stream(self.device)

    def current(self):
        """The caller's stream, read at each upload."""
        return torch.cuda.current_stream(self.device)

    def on(self, stream):
        """Make ``stream`` current for the block: tensors allocated in it
        belong to ``stream`` in the caching allocator."""
        return torch.cuda.stream(stream)

    def record(self, tensor: torch.Tensor, stream) -> None:
        """Tell the caching allocator that ``stream`` uses ``tensor``."""
        tensor.record_stream(stream)


class _Slot:
    __slots__ = ("buf", "event")

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None   # pinned bytes
        self.event = None                          # recorded after its last copy


class UploadRing:
    """Host rows to the card through a ring of two page-locked slots and
    a side copy stream, one ring per calling thread.

    An upload takes the thread's next slot and, if that slot's last copy
    has not finished, waits for it (a slot is never rewritten under a
    copy); copies the rows into the slot on the host; allocates the device
    rows under the side stream and copies them there without blocking;
    records the slot's event on the side stream; makes the caller's current
    stream wait on that event and records the rows onto it, so that the
    caching allocator hands their block to no later copy before the
    caller's queued work has read them. The host returns once the copy is
    queued: the copy engine moves a chunk while the SMs run the forward
    queued before it.

    A slot is a byte buffer viewed as the rows' dtype, grown to the largest
    chunk's bytes seen on its thread. Each thread has its own slots and
    side stream (serve's worker calls one extractor from two threads); the
    caller's stream is read at each upload.

    ``cuda``: what the ring asks of CUDA (``CudaStaging(device)`` by
    default)."""

    SLOTS = 2

    def __init__(self, device, cuda: Optional[CudaStaging] = None):
        self.device = torch.device(device)
        self.cuda = CudaStaging(self.device) if cuda is None else cuda
        self._local = threading.local()

    def _ring(self):
        """This thread's (side stream, slots, next slot's index)."""
        local = self._local
        if not hasattr(local, "slots"):
            local.side = self.cuda.stream()
            local.slots = [_Slot() for _ in range(self.SLOTS)]
            local.turn = 0
        return local

    def upload(self, rows: np.ndarray) -> Tuple[torch.Tensor, bool]:
        """``rows`` as a device tensor that the caller's current stream may
        read, and whether the host waited for the slot's last copy."""
        src = torch.from_numpy(np.ascontiguousarray(rows))
        ring = self._ring()
        slot = ring.slots[ring.turn]
        ring.turn = (ring.turn + 1) % len(ring.slots)
        waited = slot.event is not None and not slot.event.query()
        if waited:
            slot.event.synchronize()
        if slot.buf is None or slot.buf.numel() < src.nbytes:
            slot.buf = None                 # the old buffer goes before the new one comes
            slot.buf = self.cuda.pinned(src.nbytes)
        staged = slot.buf[:src.nbytes].view(src.dtype).view(src.shape)
        staged.copy_(src)
        current = self.cuda.current()
        with self.cuda.on(ring.side):
            x = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            x.copy_(staged, non_blocking=True)
        if slot.event is None:
            slot.event = self.cuda.event()
        slot.event.record(ring.side)
        current.wait_event(slot.event)
        self.cuda.record(x, current)
        return x, waited


class EmbeddingExtractor:
    """Turns a backbone into a batched feature extractor on one device or
    over a mesh.

    Args:
      model_fn: ``f(params, images_f32_nhwc) -> (N, D)`` on torch tensors.
      params: the model's parameters in the reference's numpy layouts;
        moved to ``device`` once (``params.to_torch``; a quantized
        pytree takes the int8 layouts).
      input_size: (H, W) the model expects.
      normalization: key into ``ops.preprocess.NORMALIZERS``.
      resize_method: 'cv2_linear' | 'cv2_area' | 'pil_bilinear' | ...
      batch_size: device batch.
      flip_tta: sum the features of the image and its horizontal mirror;
      l2_normalize_output: normalize rows (the reference's InsightFace
        extractor, ``insightface_face_embedding.py:47-62``).
      host_resize: 'never' resizes on the device; 'always' resizes every
        non-native size on the host (same weight matrices,
        ``ops.resize.resize_host``). The reference's 'auto' bounds its
        compiled programs; eager PyTorch compiles none, so it is not here.
      convert: ``f(params, device)`` -> the tensors ``model_fn`` takes
        (default ``params.to_torch``, for pytrees of layer dicts).
      mesh: a ``parallel.sharding.Mesh``: ``convert`` places one copy of
        the params per distinct device, every forward splits its rows over
        all the mesh's shards (padded by repeating the last row), and the
        features come back in input order. The mesh's first device
        replaces ``device``.
      compute_dtype: stored as ``self.compute_dtype``, as the reference
        stores it; the forward's own dtype and tier are ``model_fn``'s
        (``zoo.build_extractor(precision=...)``). The device resize runs
        at "highest", as there.
      timer: a ``utils.profiling.StageTimer`` that takes the spans and
        counters above; None (the default) records nothing and reads no
        clock.
    """

    def __init__(self, model_fn: Callable, params, input_size: Tuple[int, int],
                 normalization: str = "caffe", resize_method: str = "pil_bilinear",
                 batch_size: int = 64, device="cuda", flip_tta: bool = False,
                 l2_normalize_output: bool = False, host_resize: str = "never",
                 convert: Callable = to_torch, mesh=None,
                 compute_dtype=torch.float32, timer=None):
        if host_resize not in ("always", "never"):
            raise ValueError(f"host_resize must be always|never, "
                             f"got {host_resize!r}")
        self.model_fn = model_fn
        self.compute_dtype = compute_dtype
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            self.params = convert(params, self.device)
        else:
            self.device = mesh.devices.flat[0]
            self._replicas = mesh.replicate(params, convert)
            self.params = self._replicas[self.device]
        self.input_size = tuple(input_size)
        self.normalization = normalization
        self.resize_method = resize_method
        self.batch_size = batch_size
        self.flip_tta = flip_tta
        self.l2_normalize_output = l2_normalize_output
        self.host_resize = host_resize
        self.timer = timer
        # staged uploads on a card; the CPU and the mesh's split_batch copy directly
        self._uploads = (UploadRing(self.device)
                         if mesh is None and self.device.type == "cuda" else None)

    def _span(self, name: str):
        """The timer's span ``name`` (its parent the span open on this
        thread), or the shared no-op context without a timer."""
        return _UNTIMED if self.timer is None else self.timer.stage(name)

    def _count(self, name: str, n: int) -> None:
        if self.timer is not None:
            self.timer.count(name, n)

    def _maybe_host_resize(self, batch: np.ndarray) -> np.ndarray:
        """Resize on the host when ``host_resize='always'``."""
        if (self.host_resize == "always"
                and (batch.shape[1], batch.shape[2]) != self.input_size):
            return resize_host(batch, self.input_size, self.resize_method)
        return batch

    def _upload(self, images: np.ndarray) -> torch.Tensor:
        """A chunk's host rows as a device tensor: through the ring on a
        card, else copied directly."""
        if self._uploads is None:
            return torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        x, waited = self._uploads.upload(images)
        self._count("embed.upload_staged", 1)
        self._count("embed.upload_slot_waits", int(waited))
        return x

    @torch.no_grad()
    def _forward(self, images: np.ndarray) -> torch.Tensor:
        if self.mesh is None:
            with self._span("embed.upload"):
                up = [self._upload(images)]
            self._count("embed.upload_bytes", up[0].nbytes)
            with self._span("embed.forward"):
                # handed over, not held: the forward frees the uint8 rows
                # once it has converted them
                return self._forward_on(self.params, up.pop())
        # each shard's rows on its device, the features gathered in order
        shards = self.mesh.shard_devices()
        padded, n = pad_batch(np.asarray(images), len(shards))
        self._count("embed.padded_rows", len(padded) - n)
        with self._span("embed.upload"):
            xs = split_batch(padded, shards)
        self._count("embed.upload_bytes", padded.nbytes)
        with self._span("embed.forward"):
            feats = [self._forward_on(self._replicas[d], x) for d, x in zip(shards, xs)]
        with self._span("embed.fetch"):
            return gather(feats, self.device)[:n]

    def _fetch(self, outs: Sequence[torch.Tensor], takes: Sequence[int]) -> np.ndarray:
        """The first ``take`` rows of each device result, copied back and
        concatenated in order."""
        with self._span("embed.fetch"):
            out = np.concatenate([o[:t].cpu().numpy() for o, t in zip(outs, takes)])
        self._count("embed.rows", len(out))
        return out

    def _forward_on(self, params, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if (x.shape[1], x.shape[2]) != self.input_size:
            x = resize(x, self.input_size, self.resize_method)
        x = NORMALIZERS[self.normalization](x)
        feats = self.model_fn(params, x)
        if self.flip_tta:
            feats = feats + self.model_fn(params, torch.flip(x, dims=(2,)))
        if self.l2_normalize_output:
            feats = feats / torch.clamp(
                torch.linalg.vector_norm(feats, dim=-1, keepdim=True), min=1e-12)
        return feats

    def extract_batch(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8/float RGB (uniform size) -> (N, D) float32.

        A tail chunk pads to the next power of two (floor 8, at most
        ``batch_size``), so a run sees a handful of batch shapes, as in the
        reference; each chunk is queued on the device before any result is
        copied back. Under a mesh the tail bucket holds at least one row a
        shard."""
        with self._span("embed.call"):
            images = self._maybe_host_resize(np.asarray(images))
            outs, takes, padded = [], [], 0
            for i in range(0, len(images), self.batch_size):
                chunk = images[i:i + self.batch_size]
                take = len(chunk)
                if take < self.batch_size:
                    bucket = max(8, 1 << max(0, (take - 1).bit_length()))
                    if self.mesh is not None:
                        bucket = max(bucket, self.mesh.size)
                    chunk = pad_batch(chunk, min(bucket, self.batch_size))[0]
                    padded = len(chunk) - take
                outs.append(self._forward(chunk))
                takes.append(take)
            self._count("embed.padded_rows", padded)
            return self._fetch(outs, takes)

    def extract_files(self, paths: Sequence[str], loader=None,
                      decode_workers: int = 4) -> np.ndarray:
        """Streamed file extraction, order preserved: threaded decode
        (``utils/prefetch.bounded_thread_map``) feeds per-source-size
        buckets; a full bucket is queued on the device at once, so decoding
        the next batch overlaps the device's work on this one.
        ``decode_workers=0`` decodes inline. ``loader`` maps a path to an
        RGB array (default: decode the image file). A timer sees the
        spans and counters of ``extract_batch``, ``embed.call`` around the
        whole stream."""
        from ..utils.image_io import imread_rgb
        from ..utils.prefetch import bounded_thread_map

        loader = loader or imread_rgb
        feats: List[Optional[np.ndarray]] = [None] * len(paths)
        buckets: Dict[Tuple[int, int], List[Tuple[int, np.ndarray]]] = {}
        in_flight: List[Tuple[List[int], torch.Tensor]] = []

        def dispatch(bucket):
            idxs = [i for i, _ in bucket]
            batch = self._maybe_host_resize(np.stack([im for _, im in bucket]))
            padded = pad_batch(batch, self.batch_size)[0]
            self._count("embed.padded_rows", len(padded) - len(idxs))
            for s in range(0, len(padded), self.batch_size):
                in_flight.append((idxs[s:s + self.batch_size],
                                  self._forward(padded[s:s + self.batch_size])))

        def drain():
            if in_flight:
                emb = self._fetch([dev for _, dev in in_flight],
                                  [len(idxs) for idxs, _ in in_flight])
                order = [i for idxs, _ in in_flight for i in idxs]
                for j, i in enumerate(order):
                    feats[i] = emb[j]
                in_flight.clear()

        with self._span("embed.call"):
            for i, img in enumerate(bounded_thread_map(loader, paths,
                                                       workers=decode_workers,
                                                       depth=2 * self.batch_size)):
                bucket = buckets.setdefault(img.shape[:2], [])
                bucket.append((i, img))
                if len(bucket) == self.batch_size:
                    dispatch(bucket)
                    buckets[img.shape[:2]] = []
                if len(in_flight) >= 2:   # bound device-side queueing + host copies
                    drain()
            for bucket in buckets.values():
                if bucket:
                    dispatch(bucket)
            drain()
        return np.stack(feats)
