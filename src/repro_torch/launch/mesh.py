"""Device meshes over the process's devices (the JAX package's
``launch/mesh.py``).

JAX's single controller drives every device of the process through one
program; the port's counterpart is one Python process that drives every
visible CUDA device itself (no ``torch.distributed``, no NCCL).  A
``Mesh`` names devices by integer id, laid out as an ndarray with named
axes, and resolves each id to the ``torch.device`` it stands for: on the
card, id k is ``cuda:k``; on the CPU there is one device, id 0.

``make_production_mesh`` gives the dry run's 16x16 and 2x16x16 pod
meshes; their device ids are abstract, every one on the ``meta`` device
(``process_devices("meta", count)``), so that a dry run never touches a
card.

``logical_devices(count, device)`` is a helper for tests and the smoke
script, never called on the main path: inside it, the process has
``count`` devices, ids ``0..count-1``, all on one physical ``device``,
the way JAX's ``--xla_force_host_platform_device_count`` carves several
host devices out of one CPU.  A CPU test can so split a fleet over 4 or
8 "devices", and one H100 can hold 4 logical shards.  A mesh made inside
it keeps its devices after the block ends.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

#: (count, physical device) while a ``logical_devices`` block is open
_LOGICAL: Optional[Tuple[int, torch.device]] = None


@contextlib.contextmanager
def logical_devices(count: int, device="cuda") -> Iterator[None]:
    """Make the process look as if it had ``count`` devices of
    ``device``'s type, ids ``0..count-1``, all of them ``device`` itself
    (tests and the smoke script only; see module docstring)."""
    global _LOGICAL
    if count < 1:
        raise ValueError(f"logical_devices: count must be >= 1, got "
                         f"{count}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and \
            torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    prev, _LOGICAL = _LOGICAL, (int(count), dev)
    try:
        yield
    finally:
        _LOGICAL = prev


def process_devices(platform: str = "cuda",
                    count: Optional[int] = None) -> Dict[int, torch.device]:
    """id -> torch.device of every device of ``platform`` ("cuda", "cpu"
    or "meta") this process can use: the logical ones inside a
    ``logical_devices`` block of that platform, else ``cuda:0..`` (none
    without a card) or the one CPU.  "meta": ``count`` abstract devices,
    ids ``0..count-1``, each the ``meta`` device (no memory, no card)."""
    if platform == "meta":
        return {i: torch.device("meta") for i in range(int(count or 1))}
    if _LOGICAL is not None and _LOGICAL[1].type == platform:
        count, dev = _LOGICAL
        return {i: dev for i in range(count)}
    if platform == "cuda":
        if not torch.cuda.is_available():
            return {}
        return {i: torch.device("cuda", i)
                for i in range(torch.cuda.device_count())}
    if platform == "cpu":
        return {0: torch.device("cpu")}
    raise ValueError(f"unknown device platform {platform!r}")


class Mesh:
    """Device ids laid out as an ndarray with named axes.

    ``device_ids``: the ndarray of ids (its shape is the mesh's);
    ``axis_names``: one name per axis; ``shape``: axis name -> size, in
    axis order (JAX's ``Mesh.shape``); ``device(i)``: the torch device of
    id i; ``devices()``: the torch devices of every id, in id order."""

    def __init__(self, device_ids, axis_names: Sequence[str],
                 devices: Dict[int, torch.device]):
        self.device_ids = np.asarray(device_ids, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.device_ids.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.device_ids.shape} needs "
                             f"{self.device_ids.ndim} axis names, got "
                             f"{self.axis_names}")
        missing = [int(i) for i in self.device_ids.ravel()
                   if int(i) not in devices]
        if missing:
            raise ValueError(f"mesh names device ids {missing} it has no "
                             "device for")
        self._devices = {int(i): torch.device(devices[int(i)])
                         for i in self.device_ids.ravel()}

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.device_ids.shape))

    @property
    def size(self) -> int:
        return int(self.device_ids.size)

    @property
    def platform(self) -> str:
        return next(iter(self._devices.values())).type

    def device(self, device_id: int) -> torch.device:
        return self._devices[int(device_id)]

    def devices(self) -> list:
        return [self._devices[int(i)] for i in sorted(self._devices)]

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, ids={self.device_ids.tolist()}, "
                f"{self.platform})")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 ("data","model") single pod; 2x16x16 ("pod","data","model")
    for the 512-chip two-pod configuration.  Its ids are abstract, on the
    ``meta`` platform: the dry run's shardings read its shape and names."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    return Mesh(np.arange(n).reshape(shape), axes,
                process_devices("meta", n))


def make_local_mesh(model_axis: int = 1, device="cuda") -> Mesh:
    """("data", "model") mesh over every device of ``device``'s platform
    that the process has (``process_devices``); raises the JAX package's
    ``ValueError`` when they cannot be factored into ``model_axis``."""
    platform = torch.device(device).type
    devs = process_devices(platform)
    n = len(devs)
    if model_axis <= 0 or n == 0 or n % model_axis != 0:
        raise ValueError(
            f"make_local_mesh: {n} visible device(s) cannot be factored "
            f"into a model axis of {model_axis} (need model_axis >= 1 and "
            f"{n} % model_axis == 0)")
    ids = np.array(sorted(devs)).reshape(n // model_axis, model_axis)
    return Mesh(ids, ("data", "model"), devs)
