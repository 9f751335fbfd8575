"""Bounded-prefetch host data loading.

The port's own copy of ``hse_facerec_tf_tpu/utils/prefetch.py``.
``bounded_thread_map`` is an ordered thread-pool map with a bounded number
of in-flight items: cv2/PIL release the GIL during decode, so threads give
real parallelism without decoding everything up front. PyTorch's
asynchronous CUDA launches do the device-side half: callers queue a batch
and keep decoding while it runs (``EmbeddingExtractor.extract_files``).
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")


def bounded_thread_map(fn: Callable[[T], U], items: Iterable[T],
                       workers: int = 4, depth: int = 16) -> Iterator[U]:
    """Yield ``fn(item)`` in input order, computed by ``workers`` threads with
    at most ``depth`` results in flight (decoded-but-unconsumed). Unlike
    ``ThreadPoolExecutor.map``, submission is throttled, so memory stays
    bounded for arbitrarily long inputs."""
    if workers <= 0:
        for it in items:
            yield fn(it)
        return
    it = iter(items)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        queue = collections.deque()
        try:
            for _ in range(depth):
                queue.append(pool.submit(fn, next(it)))
        except StopIteration:
            it = None
        while queue:
            out = queue.popleft().result()
            if it is not None:
                try:
                    queue.append(pool.submit(fn, next(it)))
                except StopIteration:
                    it = None
            yield out
