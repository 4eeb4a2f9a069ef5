"""Device-store snapshots: the fast serve-startup path.

The ``.npy`` store (:mod:`.vectorstore`) is the canonical interchange format
(parity with the reference's store, src/vectorstore/polars.rs); this module
adds a cache next to it: the *already normalized, padded, dtype-cast* device
matrix saved as one ``.npy`` file per data shard, so a serving host restores
straight onto its devices without re-normalizing/padding/casting. Each host
writes and reads only its own shards, the same discipline as
:meth:`DeviceStore.from_file_sharded`. A snapshot written on one data-axis
size restores onto another as long as it divides the padded rows.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .device_store import DeviceStore

_META = "device_store.json"


def _shard_path(cache_dir: Path, shard: int) -> Path:
    return cache_dir / f"shard_{shard}.npy"


def _host_dtype(dtype) -> np.dtype:
    """bfloat16 has no ``.npy`` descriptor: store its bits as uint16."""
    return np.dtype(np.uint16) if jnp.dtype(dtype) == jnp.bfloat16 else (
        np.dtype(jnp.dtype(dtype))
    )


def _local_shards(mesh: Mesh, data_axis: str):
    """``(device, data-shard index)`` for this process's devices."""
    axis_pos = mesh.axis_names.index(data_axis)
    for dev in mesh.devices.flatten():
        if dev.process_index == jax.process_index():
            yield dev, int(np.argwhere(mesh.devices == dev)[0][axis_pos])


def save_device_store(
    cache_dir: str | os.PathLike,
    store: DeviceStore,
    source: Optional[dict] = None,
) -> None:
    """Snapshot a built :class:`DeviceStore` (array + layout metadata).

    ``source``: identity of the store file this snapshot was built from
    (e.g. ``{"rows": N, "bytes": sz}``) — recorded so loaders can verify the
    snapshot still matches the store on disk instead of trusting mtimes
    (a restored-from-backup store can carry an older mtime)."""
    cache_dir = Path(cache_dir).absolute()
    cache_dir.mkdir(parents=True, exist_ok=True)
    per_dev = store.per_device_rows
    hdt = _host_dtype(store.data.dtype)
    for shard in store.data.addressable_shards:
        idx = (shard.index[0].start or 0) // per_dev
        rows = np.asarray(shard.data).view(hdt)
        tmp = cache_dir / f"shard_{idx}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.save(f, rows)
        os.replace(tmp, _shard_path(cache_dir, idx))
    # Metadata LAST: it is what makes the snapshot look valid.
    meta = {
        "num_rows": store.num_rows,
        "dim": store.dim,
        "per_device_rows": per_dev,
        "chunk": store.chunk,
        "matryoshka_from": store.matryoshka_from,
        "dtype": str(store.data.dtype),
        "shape": list(store.data.shape),
        "data_shards": int(store.mesh.shape["data"]),
        "source": source,
    }
    tmp = cache_dir / f"{_META}.{os.getpid()}.tmp"
    tmp.write_text(json.dumps(meta))
    os.replace(tmp, cache_dir / _META)


def load_device_store(
    cache_dir: str | os.PathLike, mesh: Mesh, data_axis: str = "data"
) -> DeviceStore:
    """Restore a snapshot as a block-sharded array over ``mesh``.

    The mesh may differ from the one that wrote the snapshot as long as its
    ``data``-axis size divides the padded rows evenly — the serve-on-M-hosts
    half of the store lifecycle.
    """
    cache_dir = Path(cache_dir).absolute()
    meta = json.loads((cache_dir / _META).read_text())
    shape = tuple(meta["shape"])
    n_shards = mesh.shape[data_axis]
    if shape[0] % n_shards:
        raise ValueError(
            f"snapshot rows {shape[0]} not divisible by mesh "
            f"data axis {n_shards}"
        )
    dtype = jnp.dtype(meta["dtype"])
    saved = [
        np.load(_shard_path(cache_dir, i), mmap_mode="r")
        for i in range(meta["data_shards"])
    ]
    saved_rows = meta["per_device_rows"]
    per_dev = shape[0] // n_shards
    buffers = []
    for dev, idx in _local_shards(mesh, data_axis):
        lo, hi = idx * per_dev, (idx + 1) * per_dev
        parts = [
            saved[s][max(lo, s * saved_rows) - s * saved_rows:
                     min(hi, (s + 1) * saved_rows) - s * saved_rows]
            for s in range(lo // saved_rows, -(-hi // saved_rows))
        ]
        block = np.concatenate(parts) if len(parts) > 1 else parts[0]
        buffers.append(jax.device_put(
            np.ascontiguousarray(block).view(dtype), dev
        ))
    data = jax.make_array_from_single_device_arrays(
        shape, NamedSharding(mesh, P(data_axis, None)), buffers
    )
    # Resharding onto more shards can shrink per-device rows below the
    # recorded scan chunk; the scan kernels require chunk | per_device_rows.
    chunk = min(int(meta["chunk"]), per_dev)
    if per_dev % chunk:
        chunk = per_dev  # single-chunk scan is always valid
    return DeviceStore(
        data=data,
        mesh=mesh,
        num_rows=meta["num_rows"],
        dim=meta["dim"],
        per_device_rows=per_dev,
        chunk=chunk,
        matryoshka_from=meta["matryoshka_from"],
    )


def snapshot_exists(cache_dir: str | os.PathLike) -> bool:
    return (Path(cache_dir) / _META).exists()
