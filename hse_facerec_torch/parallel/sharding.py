"""Device mesh and sharding helpers.

Counterpart of ``hse_facerec_tf_tpu/parallel/sharding.py``. The JAX mesh is
single-controller: one process sees every local device and GSPMD turns a
one-device program into a sharded one. Here the mesh is the same thing
spelled out: a set of torch devices with named axes, driven from one
process. A shard's work is launched on its device; the collectives are
device-to-device copies (``Tensor.to``) and sums, which autograd
differentiates where gradients cross them. There is no
``torch.distributed`` group: on one machine it would add processes the
JAX package does not have, and on one card its world size would be 1.

A mesh may repeat a device (``make_mesh(devices=["cpu"] * 8)``): N shards
then run one after another on one card or on the CPU, which is how the
tests and the smoke run drive every sharded path on one device. Each shard
still gets its own buffers: nothing a step updates in place is shared by
two shards.
"""

from __future__ import annotations

import copy
import functools
import operator
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _canonical(device) -> torch.device:
    """``torch.device`` with an explicit index for CUDA, so that 'cuda' and
    'cuda:0' name one device; raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _placeable(obj) -> bool:
    """An object with a ``device`` whose attributes hold its tensors (a
    detector, a heads object, an analyzer)."""
    return hasattr(obj, "device") and hasattr(obj, "__dict__")


def to_device(obj, device):
    """``obj`` with every tensor it holds on ``device``: a tensor, a dict,
    list or tuple of them (named tuples included), or a placeable object
    (``_placeable``), shallow-copied with its ``device`` attribute reset
    and its attributes moved, placeable ones included. An object already
    on ``device`` is returned as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return type(obj)((k, to_device(v, device)) for k, v in obj.items())
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(v, device) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    if _placeable(obj):
        if torch.device(obj.device) == device:
            return obj
        out = copy.copy(obj)
        for name, value in vars(obj).items():
            if isinstance(value, (torch.Tensor, dict, list, tuple)) or _placeable(value):
                setattr(out, name, to_device(value, device))
        out.device = device
        return out
    return obj


class Mesh:
    """Devices in a named-axis grid (``jax.sharding.Mesh``'s counterpart).

    ``devices``: object ndarray of ``torch.device`` in the mesh's shape;
    ``axis_names``; ``shape``: name -> size; ``size``: the shard count."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        self._replicas: Dict[Tuple[int, int], Tuple] = {}

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")

    @property
    def distinct_devices(self) -> List[torch.device]:
        """Each device once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def shard_devices(self, axes=None) -> List[torch.device]:
        """The device of each shard of a batch split over ``axes`` (an axis
        name or a tuple of them; default every axis), row-major over those
        axes; along the other axes the shard sits at index 0."""
        if axes is None:
            axes = self.axis_names
        elif isinstance(axes, str):
            axes = (axes,)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} not in mesh axes {self.axis_names}")
        index = tuple(slice(None) if a in axes else 0 for a in self.axis_names)
        return list(np.asarray(self.devices[index]).reshape(-1))

    def replicate(self, obj, place: Callable = to_device) -> Dict[torch.device, object]:
        """One copy of ``obj`` per distinct device, ``place(obj, device)``
        each, made once per (object, placement) and kept by the mesh."""
        key = (id(obj), id(place))
        if key not in self._replicas:
            # the entry holds obj and place, so neither id can be reused
            self._replicas[key] = (obj, place, {d: place(obj, d)
                                                for d in self.distinct_devices})
        return self._replicas[key][2]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA card, ``torch.cuda
    .device_count()`` of them), 1-D over all of them unless ``shape`` is
    given; its first ``prod(shape)`` devices are used. ``devices`` may
    repeat a device: ``make_mesh((2, 2), ("data", "model"), ["cuda"] * 4)``
    runs four virtual shards on one card. Without a card and without
    ``devices`` it raises: a mesh never falls back to the CPU."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[...] "
                               "to build virtual shards on another device")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_canonical(d) for d in devices]
    if shape is None:
        shape = (len(devices),)
    n = int(np.prod(shape))
    if n > len(devices) or n < 1:
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, "
                         f"got {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(shape), axis_names)


def split_batch(x, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Split the leading axis of ``x`` (numpy or a tensor) into
    ``len(devices)`` equal slices, slice s placed on ``devices[s]`` (the
    counterpart of ``batch_sharding``)."""
    n = len(devices)
    if len(x) % n:
        raise ValueError(f"batch of {len(x)} does not split over {n} shards")
    per = len(x) // n
    out = []
    for s, dev in enumerate(devices):
        part = x[s * per:(s + 1) * per]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        out.append(part.to(dev, non_blocking=True))
    return out


def gather(tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Per-shard tensors concatenated on ``device``, in shard order."""
    return torch.cat([t.to(device) for t in tensors])


def shard_sum(tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of per-shard tensors on ``device``, in shard order;
    differentiable: each shard's gradient flows back to its device."""
    return functools.reduce(operator.add, (t.to(device) for t in tensors))


def pad_batch(x: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad the leading axis up to a multiple by repeating the last row.
    Returns (padded, original_n)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem:
        x = np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0)
    return x, n
