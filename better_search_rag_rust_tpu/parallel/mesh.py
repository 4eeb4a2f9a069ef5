"""Device mesh construction — the replacement for the MPI world.

The reference initializes an MPI universe and derives (rank, size)
(reference: src/main.rs:27-30); every collective and barrier is hand-written
against that world (SURVEY.md §2 "Distributed communication backend"). Here
the world is a ``jax.sharding.Mesh``:

* the reference's SPMD data parallelism (block sharding over store rows /
  files) maps to a 1-D ``("data",)`` mesh axis;
* broadcast of the query vector is implicit replication;
* the counts-all_gather + hand-rolled p2p gather-v of candidates
  (src/mpi_helpers/metrics.rs:56-138) becomes ``jax.lax.all_gather`` of
  fixed-size per-shard top-k blocks inside ``shard_map``;
* barriers (src/main.rs:82,107,139,...) disappear into XLA program order.

Multi-host: call ``jax.distributed.initialize()`` before ``create_mesh`` and
the same code runs across hosts — collectives ride ICI within a slice and DCN
across slices; nothing here changes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def create_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = ("data",),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a mesh over the visible devices.

    ``shape=None`` places all devices on the first axis (pure data
    parallelism, the reference's one strategy) with trailing axes of size 1.
    """
    devs = list(devices) if devices is not None else jax.devices()
    n = len(devs)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} vs axis names {axis_names}")
    dev_array = np.asarray(devs).reshape(shape)
    return Mesh(dev_array, axis_names)


def data_axis_size(mesh: Mesh, axis: str = "data") -> int:
    return mesh.shape[axis]
