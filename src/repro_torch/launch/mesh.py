"""Meshes over logical devices (port of ``src/repro/launch/mesh.py``).

The port has no ``jax.sharding.Mesh``; its :class:`Mesh` is a numpy object
grid of :class:`LogicalDevice` entries with ``axis_names`` and a ``shape``
dict — the attributes the submesh allocator and the sharding rules read.

A logical device is an ``id`` and the ``torch.device`` that holds its
tensors.  Several logical devices may name the same physical device: one
card then stands in for a mesh of them, as the reference's CPU tests force
``--xla_force_host_platform_device_count`` host devices.  On such a set the
shards of a replica are placed, launched and reduced one logical device at a
time on the one card, so the sharded arithmetic runs at shard shapes but no
transfer crosses an interconnect.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class LogicalDevice:
    """One device of a mesh: its id (allocation order) and where its
    tensors live (None on a shape-only mesh)."""
    id: int
    device: Optional[torch.device]


class Mesh:
    """A device grid with named axes (``jax.sharding.Mesh``'s attributes)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"device grid of rank {self.devices.ndim} for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The torch devices along ``axis`` in the first row of every other
        axis, in shard order."""
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), -1)
        return [d.device for d in grid.reshape(-1, grid.shape[-1])[0]]

    def __repr__(self) -> str:
        ids = [d.id for d in self.devices.flatten()]
        return f"Mesh({self.shape}, ids={ids})"


def logical_devices(n: Optional[int] = None,
                    device: DeviceLike = None) -> List[LogicalDevice]:
    """``n`` logical devices.  With ``device`` given, all on it (the tests
    use ``device="cpu"``); by default one entry per visible card, entry i on
    card ``i % cards`` when ``n`` asks for more.  No card raises, as every
    entry point of the port does."""
    if device is not None:
        dev = resolve_device(device)
        return [LogicalDevice(i, dev) for i in range(1 if n is None else n)]
    resolve_device(None)
    cards = torch.cuda.device_count()
    n = cards if n is None else n
    return [LogicalDevice(i, torch.device("cuda", i % cards)) for i in range(n)]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh shape — single pod 16 × 16, multi-pod
    2 × 16 × 16 — over placeholder devices: shape only, nothing allocated."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    grid = np.array([LogicalDevice(i, None) for i in range(n)], dtype=object)
    return Mesh(grid.reshape(shape), axes)


def make_host_mesh(model_axis: int = 1,
                   devices: Optional[Sequence[LogicalDevice]] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: one per card)."""
    devices = list(logical_devices() if devices is None else devices)
    data = len(devices) // model_axis
    grid = np.array(devices[:data * model_axis], dtype=object)
    return Mesh(grid.reshape(data, model_axis), ("data", "model"))


def carve_submeshes(mesh: Mesh, shapes: Sequence[Tuple[int, ...]],
                    axes: Tuple[str, ...] = ("pipe", "data", "model")) -> List[Mesh]:
    """Partition ``mesh``'s devices into per-replica submeshes.

    Deterministic: devices are consumed in sorted-id order, so the same
    (mesh, shapes) always yields the same assignment.  Shapes map onto the
    TRAILING axis names: a 2-D shape becomes a ``(data, model)`` submesh, a
    3-D shape ``(pipe, data, model)``.  Raises ``ValueError`` when the
    requested shapes oversubscribe the mesh.
    """
    devices = sorted(mesh.devices.flatten().tolist(), key=lambda d: d.id)
    need = sum(int(np.prod(s)) for s in shapes)
    if need > len(devices):
        raise ValueError(
            f"carve_submeshes: shapes {list(shapes)} need {need} devices "
            f"but the mesh has {len(devices)}")
    out, off = [], 0
    for s in shapes:
        n = int(np.prod(s))
        grid = np.array(devices[off:off + n], dtype=object).reshape(s)
        out.append(Mesh(grid, axes[-len(s):]))
        off += n
    return out
