"""Device-resident sharded embedding store.

This replaces the reference's search-time store access: there, **every rank
parses the entire global.parquet and then slices its block** (reference:
src/mpi_helpers/metrics.rs:23-33 → polars.rs:50-77), so search memory is
O(total rows) per process. Here the store lives in device memory as one
block-sharded ``jax.Array`` over the mesh's ``data`` axis — each device
holds only its contiguous row block (the ``interval_by_rank`` layout,
reference: src/mpi_helpers/load_balance.rs:24-42, expressed as
``NamedSharding(mesh, P("data", None))``).

Rows are L2-normalized once at load (with the reference's zero-magnitude
guard: zero rows stay zero so their cosine distance is 1.0 —
src/metrics.rs:157-159) and stored in ``bfloat16`` by default; scoring then
reduces to a matmul with float32 accumulation.

Padding discipline:
* rows are padded so every device owns the same multiple of the scan chunk
  (static shapes for XLA);
* features are padded to a multiple of 128 with zeros, which leaves dot
  products unchanged;
* padded rows are masked to a sentinel similarity inside the kernel and can
  never displace valid rows (see :mod:`..ops.topk`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..parallel.partition import pad_to_multiple

LANE = 128


def check_row_capacity(padded_rows: int) -> None:
    """Global row ids travel through the kernels as int32 (ops/topk.py
    computes gid = base + local index in int32); refuse stores whose padded
    row space would overflow that rather than silently wrapping at scale."""
    if padded_rows >= 2**31:
        raise ValueError(
            f"store has {padded_rows} padded rows, which overflows the int32 "
            "global row-id space (max 2**31 - 1); shard across more hosts "
            "or split the store"
        )


def _choose_chunk(per_device_target: int, chunk_rows: int) -> int:
    """Scan-chunk size: at most ``chunk_rows``, at least one 128-row tile,
    and small stores collapse to a single chunk."""
    tile_rows = pad_to_multiple(per_device_target, LANE)
    return min(chunk_rows, tile_rows)


@partial(jax.jit, static_argnames=("dtype",), donate_argnums=(0,))
def _normalize_cast(x: jax.Array, dtype: str) -> jax.Array:
    """Row-wise L2 normalize in f32 with zero-guard, then cast (int8:
    symmetric lattice quantization, :mod:`..ops.quantize`)."""
    from ..ops.quantize import cast_rows_to

    x = x.astype(jnp.float32)
    norms = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
    x = x / jnp.where(norms == 0.0, 1.0, norms)
    return cast_rows_to(x, dtype)


@dataclass
class DeviceStore:
    """Normalized, padded, block-sharded embedding matrix in device memory."""

    data: jax.Array  #: [padded_rows, padded_dim], normalized, store dtype
    mesh: Mesh
    num_rows: int  #: valid rows (un-padded)
    dim: int  #: valid feature dim (un-padded)
    per_device_rows: int
    chunk: int  #: scan chunk; divides per_device_rows
    #: Original embedding dim when rows were Matryoshka-truncated, else None.
    matryoshka_from: Optional[int] = None

    def __post_init__(self) -> None:
        check_row_capacity(int(self.data.shape[0]))

    @staticmethod
    def from_host(
        matrix: np.ndarray,
        mesh: Mesh,
        dtype: str = "bfloat16",
        chunk_rows: int = 16384,
        data_axis: str = "data",
        matryoshka_dim: Optional[int] = None,
    ) -> "DeviceStore":
        """Upload a host ``[N, D]`` float32 matrix as a normalized sharded
        device store.

        ``matryoshka_dim``: keep only the first ``matryoshka_dim`` features
        before normalizing (nomic-embed-text-v1.5 is Matryoshka-trained, so
        truncation + re-normalization is the intended memory/quality trade —
        BASELINE.json config 5 serves 10M vectors at 256-d this way). Queries
        are truncated symmetrically by the engine.
        """
        if matrix.ndim != 2:
            raise ValueError(f"expected [N, D], got {matrix.shape}")
        matryoshka_from = None
        if matryoshka_dim is not None and matryoshka_dim < matrix.shape[1]:
            matryoshka_from = matrix.shape[1]
            matrix = np.ascontiguousarray(matrix[:, :matryoshka_dim])
        n, d = matrix.shape
        if n == 0:
            raise ValueError("cannot build a device store from 0 rows")
        n_shards = mesh.shape[data_axis]

        chunk = _choose_chunk(-(-n // n_shards), chunk_rows)
        per_dev = pad_to_multiple(-(-n // n_shards), chunk)
        padded_rows = per_dev * n_shards
        padded_dim = pad_to_multiple(d, LANE)

        host = np.zeros((padded_rows, padded_dim), dtype=np.float32)
        host[:n, :d] = matrix

        spec = [None] * 2
        spec[0] = data_axis
        sharding = NamedSharding(mesh, P(*spec))
        device_raw = jax.device_put(host, sharding)
        # Elementwise normalize+cast preserves the block sharding (no comms).
        arr = _normalize_cast(device_raw, dtype)
        arr = jax.device_put(arr, sharding)
        return DeviceStore(
            data=arr,
            mesh=mesh,
            num_rows=n,
            dim=d,
            per_device_rows=per_dev,
            chunk=chunk,
            matryoshka_from=matryoshka_from,
        )

    @staticmethod
    def from_file_sharded(
        path,
        mesh: Mesh,
        dtype: str = "bfloat16",
        chunk_rows: int = 16384,
        data_axis: str = "data",
        matryoshka_dim: Optional[int] = None,
    ) -> "DeviceStore":
        """Build the device store with each host reading **only its own row
        blocks** from the merged store file.

        This is the multi-host store lifecycle (build on N ingest hosts,
        serve on M search hosts): row count comes from the file header,
        each addressable device's block is read with
        :func:`..store.vectorstore.read_matrix_slice`, and the global sharded
        array is assembled with ``jax.make_array_from_single_device_arrays``
        — no host ever holds the full matrix. The reference's equivalent
        path makes every rank parse the entire global.parquet
        (src/mpi_helpers/metrics.rs:23-33).
        """
        from .vectorstore import read_matrix_slice, store_row_count

        n = store_row_count(path)
        if n == 0:
            raise ValueError(f"store at {path} is empty")
        probe = read_matrix_slice(path, 0, 1)
        d_full = probe.shape[1]
        d = min(matryoshka_dim, d_full) if matryoshka_dim else d_full
        matryoshka_from = d_full if d < d_full else None

        n_shards = mesh.shape[data_axis]
        chunk = _choose_chunk(-(-n // n_shards), chunk_rows)
        per_dev = pad_to_multiple(-(-n // n_shards), chunk)
        padded_rows = per_dev * n_shards
        padded_dim = pad_to_multiple(d, LANE)

        spec = [None, None]
        spec[0] = data_axis
        sharding = NamedSharding(mesh, P(*spec))
        axis_pos = mesh.axis_names.index(data_axis)

        buffers = []
        for dev in mesh.devices.flatten():
            if dev.process_index != jax.process_index():
                continue
            coords = np.argwhere(mesh.devices == dev)[0]
            shard_idx = int(coords[axis_pos])
            start = shard_idx * per_dev
            valid = max(0, min(per_dev, n - start))
            block = np.zeros((per_dev, padded_dim), dtype=np.float32)
            if valid:
                rows = read_matrix_slice(path, start, valid)[:, :d]
                norms = np.linalg.norm(rows, axis=1, keepdims=True)
                block[:valid, :d] = rows / np.where(norms == 0.0, 1.0, norms)
            from ..ops.quantize import cast_rows_to_host

            buffers.append(
                jax.device_put(cast_rows_to_host(block, dtype), dev)
            )
        arr = jax.make_array_from_single_device_arrays(
            (padded_rows, padded_dim), sharding, buffers
        )
        return DeviceStore(
            data=arr,
            mesh=mesh,
            num_rows=n,
            dim=d,
            per_device_rows=per_dev,
            chunk=chunk,
            matryoshka_from=matryoshka_from,
        )

    def effective_matrix(self) -> np.ndarray:
        """The valid rows as host float32, **after** normalization and dtype
        rounding — i.e. exactly what the engine scores against. This is the
        "serial scan at equal memory" oracle input (BASELINE.json).

        For int8 stores the returned values are the LATTICE INTEGERS
        (exact in f32); the engine's score of such rows is the scaled
        integer dot (:func:`..ops.quantize.int8_sims_host`), so oracles
        over int8 stores must pass explicit ``sims`` to ``serial_topk``
        (which :meth:`..ops.engine.SearchEngine.oracle_topk` does) rather
        than re-normalizing these rows in f32."""
        host = np.asarray(jax.device_get(self.data), dtype=np.float32)
        return host[: self.num_rows, : self.dim]
