"""Device meshes for the sharded indexes (port of
vector_db_tpu/parallel/mesh.py).

The reference's only scale-out story is docker-compose ``replicas`` — full
index copies with no sharding (README.md:123-126, docker-compose.yml:48-50).
Here the corpus (embedding table, neighbor tables, inverted lists) splits by
row across the mesh's devices, each shard searches on its own device, and
the per-shard winners merge on the first device.

JAX's ``shard_map`` is single-controller: one Python process drives every
device of a ``jax.sharding.Mesh``. The port keeps that shape: a mesh is a
flat list of ``torch.device`` with named axes, and one process holds one
tensor per shard on its own device; work queues asynchronously on each
device, and a merge copies ``[B, k]`` pairs to the first device. A list may
name one device more than once (four shards on one card), the port's
counterpart of JAX's virtual host devices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from vector_db_tpu_torch.device import resolve_device

SHARD_AXIS = "shard"
SLICE_AXIS = "slice"


def shard_axis() -> str:
    return SHARD_AXIS


@dataclass(frozen=True)
class Mesh:
    """Devices laid out row-major over named axes (the slowest first)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)


def _visible(devices: Optional[Sequence]) -> Tuple[torch.device, ...]:
    """The given devices resolved, or every visible CUDA device (raises
    without one: the CPU is used only when asked for)."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return tuple(resolve_device(d) for d in devices)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all visible devices)."""
    devices = _visible(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"Requested {n_devices} devices, only {len(devices)} visible"
            )
        devices = devices[:n_devices]
    return Mesh(devices, (SHARD_AXIS,), (len(devices),))


def make_mesh_2d(n_slices: int, shards_per_slice: int,
                 devices: Optional[Sequence] = None) -> Mesh:
    """2-D mesh ("slice", "shard") for multi-slice deployments.

    The inner ``shard`` axis maps to devices within one slice (one host's
    NVLink domain); the outer ``slice`` axis crosses slices. Sharded-search
    merges run per axis: over "shard" first, and only the per-slice winners
    — B·k pairs — cross "slice". Pass the slice-ordered device list.
    """
    devices = _visible(devices)
    need = n_slices * shards_per_slice
    if need > len(devices):
        raise ValueError(
            f"Requested {need} devices, only {len(devices)} visible"
        )
    return Mesh(devices[:need], (SLICE_AXIS, SHARD_AXIS),
                (n_slices, shards_per_slice))
