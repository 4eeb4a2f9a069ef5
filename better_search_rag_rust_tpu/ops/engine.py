"""Distributed exact top-k search engine over a sharded device store.

This is the device-mesh rebuild of the reference's parallel search coordinator
(reference: src/mpi_helpers/metrics.rs:174-206 ``parallel_top_k_similarity_search``):

reference (MPI)                               | here (JAX)
----------------------------------------------|----------------------------------
every rank re-parses global.parquet, slices   | store lives block-sharded on device
its `interval_by_rank` block (:23-33)         | (:class:`..store.DeviceStore`)
per-row scalar `cosine_distance` loop (:36-44)| one matmul per query tile
local sort + truncate(k) (:47-50)             | running top-k merge (O(k) carry)
all_gather of candidate counts (:67-69) +     | `lax.all_gather` of fixed-size
hand-rolled p2p gather-v (:93-132)            | [k] candidate blocks (k is static,
                                              | so no ragged gather exists at all)
root-only sort + dedup-by-index (:141-171)    | replicated `lax.top_k` merge
barriers (:135,197)                           | XLA program order

The whole search is one jitted SPMD program; there is no root rank — every
host gets the identical replicated result.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from jax import shard_map as _shard_map

from ..config import SearchConfig
from ..store.device_store import DeviceStore
from .distance import normalize_rows
from .topk import global_topk, local_topk, serial_topk

DATA_AXIS = "data"
#: Values of ``SearchConfig.kernel``; "auto" resolves to "global".
KERNELS = ("auto", "global", "scan", "blockmax")
#: Widest query tile: each tile re-streams the shard once, and its f32
#: sims buffer is ``Q_TILE * macro_rows * 4`` bytes.
Q_TILE = 512


#: Largest store size whose row ids are EXACT in float32 (2^24): above it
#: the packed single-readback path is disabled and collect falls back to
#: two transfers. Do NOT bitcast ids instead — small int32 bit patterns
#: are f32 denormals, which accelerators may flush to zero in any
#: copy or compute, silently zeroing the ids.
PACK_MAX_ROWS = 1 << 24


@jax.jit
def _pack_results(vals: jax.Array, ids: jax.Array) -> jax.Array:
    """``(sims f32 [Q,k], ids int [Q,k]) -> [Q, 2k]`` f32 with the ids
    VALUE-converted into the second half (exact for ids < 2^24)."""
    return jnp.concatenate(
        [vals.astype(jnp.float32), ids.astype(jnp.float32)], axis=1
    )


class SearchEngine:
    """Exact batched cosine top-k over a :class:`DeviceStore`."""

    def __init__(self, store: DeviceStore, config: Optional[SearchConfig] = None):
        self.store = store
        self.config = config or SearchConfig()
        self._compiled: Dict[Tuple[int, int, str], jax.stages.Compiled] = {}

    # -- public API -----------------------------------------------------------

    def _prepare_queries(self, queries: np.ndarray) -> np.ndarray:
        """2-D f32 queries, Matryoshka-truncated to the store dim when the
        store was truncated (the engine re-normalizes before scoring)."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if (
            self.store.matryoshka_from is not None
            and queries.shape[1] == self.store.matryoshka_from
        ):
            queries = np.ascontiguousarray(queries[:, : self.store.dim])
        if queries.shape[1] != self.store.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != store dim {self.store.dim}"
            )
        return queries

    def _resolve_k(self, k: Optional[int]) -> int:
        k = self.config.top_k if k is None else k
        if k <= 0:
            raise ValueError(f"top_k must be positive, got {k}")
        return min(k, self.store.num_rows)

    def _dispatch(self, queries: np.ndarray, k_eff: int):
        """Prepare + zero-pad queries to the store's padded dim and launch
        the compiled search; returns device arrays (async)."""
        queries = self._prepare_queries(queries)
        padded_dim = self.store.data.shape[1]
        if padded_dim != queries.shape[1]:
            padded = np.zeros((queries.shape[0], padded_dim), dtype=np.float32)
            padded[:, : queries.shape[1]] = queries
            queries = padded
        fn = self._get_fn(queries.shape[0], k_eff)
        return fn(self.store.data, jnp.asarray(queries))

    def _pack(self, out):
        """Fuse (similarities f32, ids int32) into ONE ``[Q, 2k]`` f32
        buffer (ids value-converted — exact below ``PACK_MAX_ROWS``) so
        collect needs a single host readback instead of two. Stores with
        ids beyond f32-exact range pass through unpacked."""
        if self.store.num_rows >= PACK_MAX_ROWS:
            return out
        vals, ids = out
        return _pack_results(vals, ids)

    @staticmethod
    def _collect(out) -> Tuple[np.ndarray, np.ndarray]:
        """Device (similarities, ids) -> host (ids int64, distances)."""
        if isinstance(out, jax.Array):  # packed buffer from _pack
            host = np.asarray(jax.device_get(out))
            k = host.shape[1] // 2
            sims = host[:, :k]
            indices = host[:, k:].astype(np.int64)
        else:
            vals, ids = out
            sims = np.asarray(jax.device_get(vals), dtype=np.float32)
            indices = np.asarray(jax.device_get(ids), dtype=np.int64)
        return indices, 1.0 - np.clip(sims, -1.0, 1.0)

    def search(
        self, queries: np.ndarray, k: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k rows for a batch of queries.

        Returns ``(indices [Q, k'], distances [Q, k'])`` with
        ``k' = min(k, num_rows)`` (the reference likewise returns at most the
        stored row count, src/mpi_helpers/metrics.rs:169), distances
        ascending, ties by lowest store row index.
        """
        return self._collect(self._pack(self._dispatch(queries, self._resolve_k(k))))

    def supports_store_upload(self) -> bool:
        """Whether ``upload="store"`` actually shrinks query upload bytes
        here: true for sub-f32 store dtypes — 2x for bf16/f16, 4x for
        int8."""
        return jnp.dtype(self.store.data.dtype).itemsize < 4

    def prepare_upload_queries(self, queries: np.ndarray) -> np.ndarray:
        """Host-side query prep for the halved-upload streaming path:
        :func:`normalize_rows`' arithmetic evaluated in host f32, then ONE
        rounding to the store dtype, padded to the store's padded dim.

        These are the exact bits the precast program scores with, so the
        oracle contract holds verbatim — feed the same array to
        :meth:`oracle_topk` via ``upload="store"``. The rounding is defined
        HOST-side on this path (the default path rounds on device after an
        on-device f32 normalize); the two can differ on elements whose f32
        normalized value sits within an f32 ulp of a store-dtype rounding
        boundary, so each path is exact against its own query bits.
        """
        queries = self._prepare_queries(queries)
        norms = np.sqrt(
            np.sum(queries * queries, axis=-1, keepdims=True, dtype=np.float32)
        )
        qn = queries / np.where(norms == 0.0, 1.0, norms)
        from .quantize import cast_rows_to_host

        padded_dim = self.store.data.shape[1]
        out = np.zeros((qn.shape[0], padded_dim), dtype=self.store.data.dtype)
        out[:, : qn.shape[1]] = cast_rows_to_host(qn, self.store.data.dtype)
        return out

    def _resolve_upload(self, upload: str) -> bool:
        """True when this dispatch should take the precast (store-dtype
        upload) program. ``"store"`` engages only where it shrinks bytes
        (sub-f32 stores); f32 stores keep the default device-side
        rounding."""
        if upload not in ("f32", "store"):
            raise ValueError(f"upload must be 'f32' or 'store', got {upload!r}")
        return upload == "store" and self.supports_store_upload()

    def _dispatch_cast(self, queries: np.ndarray, k_eff: int):
        """Launch the precast program on host-rounded store-dtype queries
        (from :meth:`prepare_upload_queries`) — half the upload bytes of
        :meth:`_dispatch` on bf16 stores."""
        qc = self.prepare_upload_queries(queries)
        fn = self._get_fn(qc.shape[0], k_eff, precast=True)
        return fn(self.store.data, jnp.asarray(qc))

    def _dispatch_device(self, queries: jax.Array, k_eff: int):
        """Launch the standard program on DEVICE-resident f32 queries (e.g.
        straight from the encoder) — no host round trip on the query side.
        Mirrors :meth:`_prepare_queries`' Matryoshka truncation and dim
        padding as (tiny, async) device ops."""
        if (
            self.store.matryoshka_from is not None
            and queries.shape[1] == self.store.matryoshka_from
        ):
            queries = queries[:, : self.store.dim]
        if queries.shape[1] != self.store.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != store dim {self.store.dim}"
            )
        if queries.dtype != jnp.float32:
            queries = queries.astype(jnp.float32)
        padded_dim = self.store.data.shape[1]
        if padded_dim != queries.shape[1]:
            queries = jnp.pad(
                queries, ((0, 0), (0, padded_dim - queries.shape[1]))
            )
        fn = self._get_fn(queries.shape[0], k_eff)
        return fn(self.store.data, queries)

    def search_async(
        self, queries: np.ndarray, k: Optional[int] = None,
        upload: str = "f32",
    ):
        """Dispatch a search WITHOUT waiting: launches the compiled program
        and starts the device->host copy of the packed result buffer
        asynchronously, so by :meth:`collect` time the bytes are already in
        flight. Returns an opaque handle for :meth:`collect`. This is the
        building block under :meth:`search_stream` and the serve loop's
        request pipelining.

        ``upload="store"`` rounds queries to the store dtype on the HOST
        (:meth:`prepare_upload_queries`) and uploads half the bytes — the
        win where the host->device link is the serving bottleneck.

        ``queries`` may also be a DEVICE array (``jax.Array``, e.g. straight
        from the encoder): then nothing uploads at all — the query side
        stays on device (``upload`` is ignored; results are bitwise the
        round trip's, since an f32 host round trip is lossless)."""
        k_eff = self._resolve_k(k)
        if isinstance(queries, jax.Array):
            buf = self._pack(self._dispatch_device(queries, k_eff))
        elif self._resolve_upload(upload):
            buf = self._pack(self._dispatch_cast(queries, k_eff))
        else:
            buf = self._pack(self._dispatch(queries, k_eff))
        for arr in (buf,) if isinstance(buf, jax.Array) else buf:
            arr.copy_to_host_async()
        return buf

    def collect(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for a :meth:`search_async` handle and return the host-facing
        ``(indices [Q, k'], distances [Q, k'])`` contract of :meth:`search`."""
        return self._collect(handle)

    def search_stream(
        self, batches, k: Optional[int] = None, depth: int = 1,
        upload: str = "f32",
    ):
        """Pipelined streaming search: yields ``(indices, distances)`` per
        query batch, keeping up to ``depth`` batches in flight on the device
        before batch results are pulled back, so host transfer overlaps
        device compute (BASELINE.json config 5: "streaming queries").

        Per batch, results are packed into a single readback buffer (see
        :meth:`_pack`) and the device->host copy starts ASYNCHRONOUSLY at
        dispatch time, so by collect time the bytes are already in flight.

        Batches sharing one shape reuse a single compiled program; a new
        shape compiles once.

        ``upload="store"`` uploads host-rounded store-dtype query bits —
        half the bytes on bf16 stores, the direct lever on an upload-bound
        stream (see :meth:`search_async`).
        """
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        from collections import deque

        k_eff = self._resolve_k(k)
        pending = deque()
        for q in batches:
            pending.append(self.search_async(q, k_eff, upload=upload))
            if len(pending) > depth:
                yield self.collect(pending.popleft())
        while pending:
            yield self.collect(pending.popleft())

    def prepare_device_queries(self, queries: np.ndarray) -> jax.Array:
        """Host ``[Q, D]`` queries -> normalized f32 device array padded to
        the store's padded dim — the exact input ``search_device`` wants."""
        queries = self._prepare_queries(queries)
        padded_dim = self.store.data.shape[1]
        if padded_dim != queries.shape[1]:
            padded = np.zeros((queries.shape[0], padded_dim), dtype=np.float32)
            padded[:, : queries.shape[1]] = queries
            queries = padded
        return jax.device_put(jnp.asarray(queries))

    def search_device(
        self, queries: jax.Array, k: Optional[int] = None
    ) -> Tuple[jax.Array, jax.Array]:
        """Device-resident search: queries already on device (e.g. straight from
        the encoder or :meth:`prepare_device_queries`), results stay on
        device as ``(similarities [Q, k], ids [Q, k])``.

        This is the serving hot path — no host transfer on either side, so
        dispatches pipeline freely. Use :meth:`search` for the host-facing
        ``(indices, distances)`` contract.
        """
        k_eff = self._resolve_k(k)
        if queries.shape[1] != self.store.data.shape[1]:
            raise ValueError(
                f"device queries must be padded to {self.store.data.shape[1]}"
                f" features (got {queries.shape[1]}); use"
                " prepare_device_queries"
            )
        fn = self._get_fn(queries.shape[0], k_eff)
        return fn(self.store.data, queries)

    def kernel_name(self, k: Optional[int] = None) -> str:
        """The kernel the engine will run for this ``k`` (public mirror of
        the internal resolution, for reporting/benchmarks)."""
        self._resolve_k(k)
        return self._resolve_kernel()

    def search_single(
        self, query: np.ndarray, k: Optional[int] = None
    ) -> list[tuple[int, float]]:
        """Single-query convenience matching the reference driver's shape:
        a ranked ``[(store row id, distance)]`` list
        (reference: src/mpi_helpers/metrics.rs:174-206)."""
        ids, dists = self.search(np.asarray(query).reshape(1, -1), k)
        return list(zip(ids[0].tolist(), dists[0].tolist()))

    # -- oracle hooks ----------------------------------------------------------

    def oracle_topk(
        self, queries: np.ndarray, k: Optional[int] = None,
        upload: str = "f32",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Serial-scan oracle over the *same scoring arithmetic* the engine
        uses (one full similarity matrix on one device, selection by stable
        numpy argsort). This is the faithful generalization of the
        reference's exactness check, where serial and parallel paths shared
        one cosine kernel (src/metrics.rs:143) and only the distribution
        machinery differed. ``top_k_overlap(oracle, engine) == 1.0`` is the
        correctness contract for every store size, dtype and mesh.

        ``upload`` selects which query-bit definition the oracle pins:
        ``"f32"`` = the default path's on-device normalize + rounding;
        ``"store"`` = the host-rounded bits of
        :meth:`prepare_upload_queries`, matching
        ``search_stream(..., upload="store")``.
        """
        queries = self._prepare_queries(queries)
        k = min(self.config.top_k if k is None else k, self.store.num_rows)
        n = self.store.num_rows
        dev = jax.devices()[0]
        # One unsharded copy of the store on one device (a device-to-device
        # gather, never through the host).
        data = jax.device_put(self.store.data, dev)

        if self._resolve_upload(upload):
            qp = self.prepare_upload_queries(queries)

            @jax.jit
            def _sims_cast(data, qc):
                from .topk import xla_sims

                return xla_sims(qc, data)

            sims = np.asarray(_sims_cast(data, jax.device_put(qp, dev)))
            return serial_topk(None, queries, k, sims=sims[:, :n])

        padded_dim = self.store.data.shape[1]
        qp = np.zeros((queries.shape[0], padded_dim), dtype=np.float32)
        qp[:, : queries.shape[1]] = queries

        @jax.jit
        def _sims(data, q):
            # The barrier pins the query's store-dtype rounding: without
            # it XLA folds the convert into this small program's single
            # matmul and effectively scores with higher-precision queries,
            # which can flip near-ties against the engine's materialized
            # store-dtype query bits. The contract is scores over
            # store-rounded rows AND queries.
            from .quantize import cast_rows_to
            from .topk import xla_sims

            qc = jax.lax.optimization_barrier(
                cast_rows_to(normalize_rows(q), data.dtype))
            return xla_sims(qc, data)

        sims = np.asarray(_sims(data, jax.device_put(qp, dev)))
        return serial_topk(None, queries, k, sims=sims[:, :n])

    # -- host-side reference oracle --------------------------------------------

    def effective_store(self) -> np.ndarray:
        """What the engine actually scores against (normalized + dtype-rounded
        valid rows, as float32) — feed this to :func:`..ops.topk.serial_topk`
        for the equal-memory exactness oracle."""
        return self.store.effective_matrix()

    def effective_queries(self, queries: np.ndarray) -> np.ndarray:
        """Queries after the engine's normalize + store-dtype cast, as f32
        (int8 stores: the lattice integers, exact in f32 — pair with
        :meth:`effective_store` through
        :func:`..ops.quantize.int8_sims_host`)."""
        from .quantize import cast_rows_to

        queries = self._prepare_queries(queries)
        qn = np.asarray(normalize_rows(jnp.asarray(queries)))
        return np.asarray(
            cast_rows_to(jnp.asarray(qn), self.store.data.dtype).astype(
                jnp.float32)
        )

    # -- compilation -----------------------------------------------------------

    def _resolve_kernel(self) -> str:
        kernel = self.config.kernel
        if kernel not in KERNELS:
            raise ValueError(
                f"unknown search kernel {kernel!r}; expected one of {KERNELS}"
            )
        # Dense two-stage selection with macro chunking handles every
        # shard size at a bounded sims buffer.
        return "global" if kernel == "auto" else kernel

    def _plan(self, q: int) -> Tuple[int, int]:
        """``(q_tile, macro_rows)``: query tiles of up to ``Q_TILE`` rows,
        and macro chunks as large as the f32 sims budget allows at that
        tile. Exactness never depends on this choice."""
        q_tile = min(q, Q_TILE)
        return q_tile, self._macro_rows(q_tile)

    def _sims_budget(self) -> int:
        """f32 sims-buffer budget in bytes for the dense sims-path kernels.
        ``config.sims_buffer_bytes`` when positive; otherwise sized from
        free device memory, between 1 and 4 GB. The budget sets the
        macro-chunk count; each chunk pays a candidate-gather rescan of its
        sims plus fixed selection ops."""
        b = self.config.sims_buffer_bytes
        if b > 0:
            return b
        # The CPU backend reports no memory stats: fixed 2 GB there.
        stats = jax.local_devices()[0].memory_stats() or {}
        free = stats.get("bytes_limit", 0) - stats.get("bytes_in_use", 0)
        if free > 0:
            return int(min(4 << 30, max(1 << 30, free - (2 << 30))))
        return 2 << 30

    def _macro_rows(self, q_tile: int) -> int:
        """Rows per macro chunk: bound the f32 sims buffer at this tile."""
        return max(self.config.row_block, self._sims_budget() // (q_tile * 4))

    def _get_fn(self, q: int, k_eff: int, precast: bool = False):
        kernel = self._resolve_kernel()
        key = (q, k_eff, kernel, precast)
        cached = self._compiled.get(key)
        if cached is not None:
            return cached

        store = self.store
        mesh = store.mesh
        per_dev = store.per_device_rows
        chunk = store.chunk
        num_rows = store.num_rows
        store_dtype = store.data.dtype

        q_tile, macro_rows = self._plan(q)

        def shard_fn(shard, queries_cast):
            base = jax.lax.axis_index(DATA_AXIS) * per_dev
            if kernel == "global":
                return global_topk(
                    shard, queries_cast, k_eff, base, num_rows, q_tile,
                    block=self.config.row_block,
                    macro_rows=macro_rows,
                )
            return local_topk(
                shard, queries_cast, k_eff, chunk, base, num_rows, kernel
            )

        # Each shard emits a fixed-size [Q, k] candidate block; the out_specs
        # concatenate them along a sharded axis in shard order, replacing the
        # reference's counts-all_gather + ragged p2p gather-v
        # (src/mpi_helpers/metrics.rs:56-138) — k is static, so no
        # variable-length gather exists at all.
        mapped = _shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(DATA_AXIS, None), P(None, None)),
            out_specs=(P(None, DATA_AXIS), P(None, DATA_AXIS)),
        )

        n_shards = mesh.devices.size

        def merge(cand_vals, cand_ids):
            # Final merge (≙ root-only compute_global_top_k,
            # src/mpi_helpers/metrics.rs:141-171) — XLA inserts the gather,
            # and shard order keeps ties resolving to the lowest index.
            # Every kernel emits its [Q, k] block already sorted
            # (value desc, gid asc), so with ONE shard the top_k is an
            # identity reorder — skip it.
            if n_shards == 1:
                return cand_vals, cand_ids
            top_vals, pos = jax.lax.top_k(cand_vals, k_eff)
            return top_vals, jnp.take_along_axis(cand_ids, pos, axis=1)

        sharded = NamedSharding(mesh, P(DATA_AXIS, None))
        replicated = NamedSharding(mesh, P(None, None))

        if precast:
            # Queries arrive already normalized + rounded to the store
            # dtype on the HOST (prepare_upload_queries) — the bits are
            # materialized by construction, so no barrier is needed.
            def search_fn(data, queries_cast):
                return merge(*mapped(data, queries_cast))
        else:
            from .quantize import cast_rows_to

            def search_fn(data, queries):
                # barrier: guarantee the kernels consume materialized
                # store-dtype query bits whatever XLA fusion decides (the
                # oracle pins the same — see oracle_topk)
                queries_cast = jax.lax.optimization_barrier(
                    cast_rows_to(normalize_rows(queries), store_dtype))
                return merge(*mapped(data, queries_cast))

        fn = jax.jit(search_fn, in_shardings=(sharded, replicated))
        self._compiled[key] = fn
        return fn
