"""Performance benchmark suites (configs from BASELINE.json).

The reference measures per-op wall time per rank and an optional
speedup-vs-sequential report at runtime, publishing nothing
(reference: src/mpi_helpers/benchmark.rs:296-438; README.md:155-191 documents
the setup only — AWS c6i.24xlarge, JabRef, ranks 1-24). These suites produce
the numbers BASELINE.json asks for:

* ``search_100k``       — quick: 100k x 768, 256-query batch, top-100
* ``search_1m``         — headline: 1M x 768, 1024-query batch, top-100,
                          bf16 scoring with f32 accumulation
* ``search_10m_mat256`` — 10M vectors, Matryoshka 256-d truncation
* ``search_1m_int8`` / ``search_10m_int8_mat256`` — the same stores on the
                          int8 lattice (exact integer scoring)
* ``search_10m_int8``   — 10M x FULL 768-d on one chip (7.7 GB resident;
                          a scale bf16 cannot fit)
* ``search_1m_f32``     — the reference's own store dtype (XLA kernels;
                          the honest dtype-parity point)
* ``pipeline``          — synthetic-corpus ingest throughput (hash encoder)
* ``encode``            — nomic forward throughput (random init), files/sec
* ``serve``             — many-concurrent-clients q/s through the dynamic
                          micro-batcher on the 1M store (``serve_100k`` is
                          the quick variant)

Design notes: the synthetic store is generated *on device* (no multi-GB
host->device upload) and every exactness/recall check reads back only
``[Q, k]`` index blocks, never the store.

Baseline semantics: the reference ships no absolute numbers, so the serial
baseline is measured in-process — a NumPy f32 scan (matmul + argsort, the
reference's sequential path at equal math) on a subsample, extrapolated
linearly to the full store. ``vs_baseline`` divides engine queries/sec by
**24x** that serial rate — a generous stand-in for the 24-rank c6i.24xlarge
MPI config (linear scaling is the best MPI could possibly do; BASELINE.json
targets >=20x over it).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Optional

import numpy as np

from ..config import SearchConfig

SERIAL_SCALE_RANKS = 24  # the reference's paper benchmark rank count


def device_peak_flops() -> Optional[float]:
    """Peak bf16 FLOP/s of the local device, or None when unknown (shared
    per-device table: :mod:`..ops.device_profile`)."""
    import jax

    from ..ops.device_profile import peak_bf16_flops

    return peak_bf16_flops(getattr(jax.devices()[0], "device_kind", ""))


@dataclass(frozen=True)
class SearchSuite:
    rows: int
    dim: int
    queries: int
    top_k: int
    store_dtype: str = "bfloat16"
    matryoshka_dim: Optional[int] = None
    iters: int = 8
    chunk_rows: int = 16384
    baseline_rows: int = 100_000
    baseline_queries: int = 8


SUITES: Dict[str, SearchSuite] = {
    # BASELINE.json config 4: "1M synthetic 768-d vectors, 1024-query batch,
    # top-100, bf16 scoring with f32 accumulation"
    "search_1m": SearchSuite(rows=1_000_000, dim=768, queries=1024, top_k=100),
    "search_100k": SearchSuite(
        rows=100_000, dim=768, queries=256, top_k=100, iters=16
    ),
    # BASELINE.json config 5 (single-chip stand-in for the 8-chip mesh
    # run): "10M vectors ... Matryoshka 256-d truncation at equal memory"
    "search_10m_mat256": SearchSuite(
        rows=10_000_000, dim=256, queries=1024, top_k=100,
        matryoshka_dim=256, iters=4, chunk_rows=65536,
    ),
    # Dtype-parity honest point: the reference's store IS f32
    # (reference: src/vectorstore/polars.rs:35-37), scored at
    # Precision.HIGHEST — slower than bf16 by design, published anyway as
    # the like-for-like number.
    "search_1m_f32": SearchSuite(
        rows=1_000_000, dim=768, queries=1024, top_k=100,
        store_dtype="float32", iters=4,
    ),
    # int8 quantized-store variants: symmetric lattice scoring (exact vs
    # the integer oracle — ops/quantize.py), half of bf16's bytes. recall_at_10 here is still self-retrieval over
    # the store's own rows, exact by construction.
    "search_1m_int8": SearchSuite(
        rows=1_000_000, dim=768, queries=1024, top_k=100,
        store_dtype="int8",
    ),
    "search_10m_int8_mat256": SearchSuite(
        rows=10_000_000, dim=256, queries=1024, top_k=100,
        matryoshka_dim=256, iters=4, chunk_rows=65536, store_dtype="int8",
    ),
    # Full-dimension 10M store on the int8 lattice (7.7 GB resident).
    "search_10m_int8": SearchSuite(
        rows=10_000_000, dim=768, queries=1024, top_k=100,
        iters=4, chunk_rows=65536, store_dtype="int8",
    ),
}


def synthetic_device_store(mesh, rows: int, dim: int, dtype: str,
                           chunk_rows: int, seed: int = 0,
                           gen_f32_budget: int = 11 * 2**30):
    """Build a random normalized store directly in device memory — the bench
    analogue of :meth:`DeviceStore.from_host` without the host round-trip.

    When the one-shot f32 working set (``padded_rows x padded_dim x 4``
    bytes — the normal/normalize intermediate XLA must materialize around
    the row-norm reduction) exceeds ``gen_f32_budget``, generation switches
    to a chunked fill: a donated store-dtype buffer is populated slice by
    slice, so only one small f32 chunk is ever live next to the store. This
    is what makes stores above half of device memory buildable — e.g. the
    ``search_10m_int8`` suite's 10M x 768 int8 store (7.7 GB resident) whose
    f32 intermediate would be 30.8 GB. Slices never cross device-shard
    boundaries, so the fill is local to each shard (no collectives)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..store.device_store import DeviceStore, _choose_chunk, LANE
    from ..parallel.partition import pad_to_multiple

    n_shards = mesh.shape["data"]
    chunk = _choose_chunk(-(-rows // n_shards), chunk_rows)
    per_dev = pad_to_multiple(-(-rows // n_shards), chunk)
    padded_rows = per_dev * n_shards
    padded_dim = pad_to_multiple(dim, LANE)
    sharding = NamedSharding(mesh, P("data", None))

    from ..ops.quantize import cast_rows_to

    def norm_cast(x):
        # zero the dim padding, normalize, cast (int8: lattice quantize)
        col = jnp.arange(padded_dim) < dim
        x = jnp.where(col[None, :], x, 0.0)
        norms = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
        x = x / jnp.where(norms == 0.0, 1.0, norms)
        return cast_rows_to(x, dtype)

    key0 = jax.random.PRNGKey(seed)
    if padded_rows * padded_dim * 4 <= gen_f32_budget:

        @jax.jit
        def gen(key):
            x = jax.random.normal(
                key, (padded_rows, padded_dim), dtype=jnp.float32
            )
            return jax.lax.with_sharding_constraint(norm_cast(x), sharding)

        data = gen(key0)
    else:
        store_dtype = cast_rows_to(jnp.zeros((1, 1), jnp.float32), dtype).dtype
        data = jax.jit(
            lambda: jnp.zeros((padded_rows, padded_dim), store_dtype),
            out_shardings=sharding,
        )()
        # Per-shard-local slices: fill_rows rows of f32 at a time (~<=1.5 GB),
        # never spanning a shard boundary.
        fill_rows = max(chunk, (gen_f32_budget // 8) // (padded_dim * 4))
        fill_rows -= fill_rows % chunk

        fill_fns: Dict[int, Callable] = {}

        def fill_for(n_fill: int):
            if n_fill not in fill_fns:

                @partial(jax.jit, donate_argnums=(0,))
                def fill(buf, key, start):
                    x = jax.random.normal(
                        key, (n_fill, padded_dim), dtype=jnp.float32
                    )
                    return jax.lax.dynamic_update_slice(
                        buf, norm_cast(x), (start, 0)
                    )

                fill_fns[n_fill] = fill
            return fill_fns[n_fill]

        i = 0
        for d in range(n_shards):
            off = 0
            while off < per_dev:
                n_fill = min(fill_rows, per_dev - off)
                data = fill_for(n_fill)(
                    data, jax.random.fold_in(key0, i),
                    jnp.int32(d * per_dev + off),
                )
                off += n_fill
                i += 1
    jax.block_until_ready(data)
    return DeviceStore(
        data=data, mesh=mesh, num_rows=rows, dim=dim,
        per_device_rows=per_dev, chunk=chunk,
    )


def _serial_baseline_qps(store_rows: int, dim: int, top_k: int,
                         sample_rows: int, sample_queries: int) -> float:
    """Measured NumPy serial scan on a subsample, extrapolated linearly to
    ``store_rows``.

    Deliberately a *competent* baseline, not a strawman: BLAS matmul with
    every host core, then ``argpartition`` (O(N)) + a sort of only the top-k
    — strictly faster than the reference's per-row scalar cosine + full sort
    (src/mpi_helpers/metrics.rs:16-53). The subsample is timed over several
    repeats and the fastest repeat is used, bounding extrapolation error
    from warmup/allocator noise on the generous side."""
    rng = np.random.default_rng(7)
    sample_rows = min(sample_rows, store_rows)
    store = rng.standard_normal((sample_rows, dim), dtype=np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    queries = store[:sample_queries]
    k = min(top_k, sample_rows)

    def scan() -> float:
        t0 = time.perf_counter()
        sims = queries @ store.T
        part = np.argpartition(-sims, k - 1, axis=1)[:, :k]
        part_sims = np.take_along_axis(sims, part, axis=1)
        order = np.argsort(-part_sims, axis=1, kind="stable")
        np.take_along_axis(part, order, axis=1).copy()
        return time.perf_counter() - t0

    scan()  # warm BLAS thread pool + page cache
    dt = min(scan() for _ in range(3))
    per_query_per_row = dt / (sample_queries * sample_rows)
    return 1.0 / (per_query_per_row * store_rows)


def run_search_suite(name: str, suite: SearchSuite) -> dict:
    import jax
    import jax.numpy as jnp

    from ..ops.engine import SearchEngine
    from ..parallel.mesh import create_mesh

    mesh = create_mesh()
    t_build = time.perf_counter()
    store = synthetic_device_store(
        mesh, suite.rows, suite.dim, suite.store_dtype, suite.chunk_rows
    )
    build_s = time.perf_counter() - t_build

    engine = SearchEngine(
        store,
        SearchConfig(
            top_k=suite.top_k, chunk_rows=suite.chunk_rows,
            store_dtype=suite.store_dtype,
        ),
    )

    # Queries = store rows (self-retrieval ground truth), pulled back as the
    # only store bytes that ever leave the device.
    q_idx = np.linspace(0, suite.rows - 1, suite.queries, dtype=np.int64)
    queries = np.asarray(
        jax.device_get(store.data[jnp.asarray(q_idx)]), dtype=np.float32
    )[:, : suite.dim]

    # Warmup (compile) then timed iterations.
    ids, dists = engine.search(queries, k=suite.top_k)
    t0 = time.perf_counter()
    for _ in range(suite.iters):
        ids, dists = engine.search(queries, k=suite.top_k)
    elapsed = time.perf_counter() - t0
    e2e_qps = suite.queries * suite.iters / elapsed
    p50_latency_s = elapsed / suite.iters

    # Streaming serving (BASELINE.json config 5: "streaming query batches"):
    # search_stream dispatches batch i+1 before pulling batch i's results,
    # so host readback overlaps device compute — the host-facing number a
    # serving deployment sees (vs the serial e2e loop above).
    t0 = time.perf_counter()
    n_streamed = 0
    for s_ids, _sd in engine.search_stream(
        (queries for _ in range(suite.iters)), k=suite.top_k
    ):
        n_streamed += s_ids.shape[0]
    stream_qps = n_streamed / max(time.perf_counter() - t0, 1e-9)

    # Store-dtype upload: host-rounded bf16 query bits halve the upload
    # bytes — the direct lever when the host->device link bounds the
    # stream.
    stream_store_qps = None
    if engine.supports_store_upload():
        warm = list(  # compile the precast program outside the timing
            engine.search_stream([queries], k=suite.top_k, upload="store")
        )
        del warm
        t0 = time.perf_counter()
        n_streamed = 0
        for s_ids, _sd in engine.search_stream(
            (queries for _ in range(suite.iters)), k=suite.top_k,
            upload="store",
        ):
            n_streamed += s_ids.shape[0]
        stream_store_qps = n_streamed / max(time.perf_counter() - t0, 1e-9)

    # Device-resident throughput: queries already on device (the serving
    # shape — the encoder produces them there), results consumed there.
    # Dispatches are pipelined and waited for ONCE with block_until_ready.
    qdev = engine.prepare_device_queries(queries)
    jax.block_until_ready(engine.search_device(qdev, k=suite.top_k))
    # >=3 repeats; the published number is the BEST repeat and the spread is
    # reported alongside so the ledger can state its variance.
    repeats = []
    for _rep in range(3):
        t0 = time.perf_counter()
        for _ in range(suite.iters):
            out = engine.search_device(qdev, k=suite.top_k)
        jax.block_until_ready(out)
        rep_elapsed = max(time.perf_counter() - t0, 1e-9)
        repeats.append(suite.queries * suite.iters / rep_elapsed)
    qps = max(repeats)
    dev_elapsed = suite.queries * suite.iters / qps
    spread_pct = 100.0 * (max(repeats) - min(repeats)) / max(repeats)

    # recall@10: self-index must appear in the top-10 (exact search on
    # normalized rows => guaranteed unless bf16 rounding created a duplicate).
    k_r = min(10, suite.top_k)
    recall_at_10 = float(
        np.mean([q_idx[i] in ids[i, :k_r] for i in range(len(q_idx))])
    )

    baseline_serial = _serial_baseline_qps(
        suite.rows, suite.matryoshka_dim or suite.dim, suite.top_k,
        suite.baseline_rows, suite.baseline_queries,
    )
    baseline_24rank = baseline_serial * SERIAL_SCALE_RANKS

    # MFU: useful scan ops (2 * rows * dim per query) over the peak matmul
    # rate AT THE STORE DTYPE (ops/device_profile.py).
    from ..ops.device_profile import peak_matmul_flops

    peak = peak_matmul_flops(
        getattr(jax.devices()[0], "device_kind", ""), suite.store_dtype
    )
    flops = 2.0 * suite.rows * (suite.matryoshka_dim or suite.dim)
    mfu = round(flops * qps / (peak * len(jax.devices())), 4) if peak else None

    return {
        "metric": f"{name}_qps",
        "value": round(qps, 2),
        "unit": "queries/sec",
        "vs_baseline": round(qps / baseline_24rank, 2),
        "recall_at_10": recall_at_10,
        "mfu": mfu,
        "qps_repeats": [round(r, 2) for r in repeats],
        "spread_pct": round(spread_pct, 2),
        "e2e_qps": round(e2e_qps, 2),
        "stream_e2e_qps": round(stream_qps, 2),
        "stream_store_upload_qps": (
            round(stream_store_qps, 2) if stream_store_qps else None
        ),
        "p50_batch_latency_s": round(p50_latency_s, 4),
        "device_batch_latency_s": round(dev_elapsed / suite.iters, 4),
        "kernel": engine.kernel_name(suite.top_k),
        "rows": suite.rows,
        "dim": suite.dim,
        "batch": suite.queries,
        "top_k": suite.top_k,
        "store_dtype": suite.store_dtype,
        "store_build_s": round(build_s, 2),
        "serial_baseline_qps": round(baseline_serial, 2),
        "baseline_24rank_qps": round(baseline_24rank, 2),
        "devices": len(jax.devices()),
        "platform": jax.devices()[0].platform,
    }


def run_serve_suite(base: str = "search_1m", clients: int = 64,
                    requests_per_client: int = 24, window_ms: float = 2.0,
                    depth: int = 2, warm_requests: int = 4,
                    outstanding: int = 1, upload: str = "f32",
                    suite: Optional[SearchSuite] = None) -> dict:
    """Many-concurrent-clients serving throughput through the dynamic
    micro-batcher (`batcher.DynamicBatcher`) — the third serving regime
    next to device-resident batches (`run_search_suite`) and the single
    pipelined stream (``stream_e2e_qps``).

    ``clients`` threads each issue ``requests_per_client`` single-query
    requests in a closed loop (submit, wait, repeat — with ``outstanding``
    requests in flight per client; 1 is the strict request/response
    client, the worst case for batching, and higher values model
    open-loop clients and expose the device-side ceiling instead of the
    round-trip latency); requests landing within ``window_ms`` coalesce
    into one fixed-shape dispatch. The
    baseline is the same workload WITHOUT coalescing: one dispatch per
    request, serially — what a naive per-request server pays (the
    reference's only serving story is one whole process per query,
    src/main.rs:42-45). ``vs_baseline`` is therefore the coalescing win
    itself, not the MPI-baseline ratio the search suites report.

    Every batch shape the run can produce is compiled up front (the
    power-of-two ladder up to ``_serve_batch_shape(clients)``), so the
    timed section never hits a compile — one stray compile would swamp
    seconds of serving."""
    import threading

    import jax
    import jax.numpy as jnp

    from ..batcher import DynamicBatcher
    from ..ops.engine import SearchEngine
    from ..parallel.mesh import create_mesh
    from ..pipeline import _serve_batch_shape

    suite = suite or SUITES[base]
    mesh = create_mesh()
    store = synthetic_device_store(
        mesh, suite.rows, suite.dim, suite.store_dtype, suite.chunk_rows
    )
    engine = SearchEngine(
        store,
        SearchConfig(top_k=suite.top_k, chunk_rows=suite.chunk_rows,
                     store_dtype=suite.store_dtype),
    )
    q_idx = np.linspace(0, suite.rows - 1, clients, dtype=np.int64)
    queries = np.asarray(
        jax.device_get(store.data[jnp.asarray(q_idx)]), dtype=np.float32
    )[:, : suite.dim]

    # Compile the whole reachable shape ladder before timing anything —
    # in the SAME upload mode the batcher will dispatch (the store-upload
    # precast program is a different compiled program than the f32 path).
    if upload == "store" and not engine.supports_store_upload():
        upload = "f32"
    # The reachable set of padded shapes, NOT just powers of two: above
    # 1024 `_serve_batch_shape` pads to multiples of 1024, so e.g. 256
    # clients x 16 outstanding can dispatch 3072 — warm exactly the set
    # the batcher can produce so no compile lands in the timed section.
    top = _serve_batch_shape(clients * outstanding)
    ladder = sorted({_serve_batch_shape(n) for n in range(1, clients * outstanding + 1)})
    for shape in ladder:
        qs = queries[np.arange(shape) % clients]
        engine.collect(engine.search_async(qs, k=suite.top_k, upload=upload))

    # Baseline: one dispatch per request, serially (no coalescing, no
    # pipelining) — the per-request cost a request-scoped server pays.
    n_single = min(32, clients * requests_per_client)
    engine.search(queries[:1], k=suite.top_k)  # warm the f32 Q=1 program
    t0 = time.perf_counter()
    for i in range(n_single):
        engine.search(queries[i % clients][None], k=suite.top_k)
    single_qps = n_single / max(time.perf_counter() - t0, 1e-9)

    lat_lock = threading.Lock()
    latencies: list = []
    hits: list = []
    errors: list = []

    def client_loop(ci: int, n: int, record: bool) -> None:
        from collections import deque

        inflight: deque = deque()
        issued = 0
        while issued < n or inflight:
            while issued < n and len(inflight) < outstanding:
                inflight.append((time.perf_counter(),
                                 batcher.submit(queries[ci])))
                issued += 1
            t_req, fut = inflight.popleft()
            try:
                ids, _dists = fut.result()
            except Exception as exc:  # count, don't kill the client thread
                with lat_lock:
                    errors.append(f"client {ci}: {exc!r}")
                continue
            dt = time.perf_counter() - t_req
            if record:
                with lat_lock:
                    latencies.append(dt)
                    hits.append(int(q_idx[ci]) in ids[0, : min(10, suite.top_k)])

    def run_clients(n: int, record: bool) -> float:
        start = threading.Barrier(clients + 1)
        threads = [
            threading.Thread(target=lambda c=ci: (start.wait(),
                                                  client_loop(c, n, record)),
                             daemon=True)
            for ci in range(clients)
        ]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        return time.perf_counter() - t0

    with DynamicBatcher(engine, k=suite.top_k, max_batch=top,
                        window_ms=window_ms, depth=depth,
                        upload=upload) as batcher:
        run_clients(warm_requests, record=False)  # thread/queue warmup
        # Snapshot stats so the reported coalescing covers ONLY the timed
        # run (the low-concurrency warmup batches would dilute it).
        warm_batches = batcher.stats.batches
        warm_rows = batcher.stats.batched_queries
        errors.clear()
        wall = run_clients(requests_per_client, record=True)
        timed_batches = batcher.stats.batches - warm_batches
        timed_rows = batcher.stats.batched_queries - warm_rows

    n_req = clients * requests_per_client
    answered = len(latencies)
    if errors:
        print(f"serve suite: {len(errors)} failed requests "
              f"({answered}/{n_req} answered); first: {errors[0]}")
    if answered == 0:
        raise RuntimeError(f"serve suite: every request failed: {errors[:3]}")
    serve_qps = answered / max(wall, 1e-9)
    lat = np.sort(np.asarray(latencies))
    return {
        "metric": "serve_qps",
        "value": round(serve_qps, 2),
        "unit": "queries/sec",
        "vs_baseline": round(serve_qps / max(single_qps, 1e-9), 2),
        "recall_at_10": round(float(np.mean(hits)), 4),
        "single_request_qps": round(single_qps, 2),
        "coalescing": round(timed_rows / timed_batches if timed_batches else 0.0, 2),
        "answered": answered,
        "failed": len(errors),
        "p50_latency_ms": round(float(lat[len(lat) // 2]) * 1e3, 2),
        "p99_latency_ms": round(float(lat[min(int(len(lat) * 0.99), len(lat) - 1)]) * 1e3, 2),
        "clients": clients,
        "outstanding": outstanding,
        "upload": upload,
        "requests": n_req,
        "window_ms": window_ms,
        "depth": depth,
        "rows": suite.rows,
        "dim": suite.dim,
        "top_k": suite.top_k,
        "store_dtype": suite.store_dtype,
        "devices": len(jax.devices()),
        "platform": jax.devices()[0].platform,
    }


def run_pipeline_suite(files: int = 512, dim: int = 768,
                       backend: str = "hash", batch: int = 32,
                       inflight: Optional[int] = None) -> dict:
    """Synthetic-corpus ingest throughput — the analogue of the reference's
    ``embedding_generation`` timing (reference: src/main.rs:61-79,
    src/mpi_helpers/tasks.rs:94-148).

    ``backend="hash"`` isolates the host pipeline (I/O + tokenize + store);
    ``backend="nomic"`` (suite ``pipeline_nomic``) composes the REAL encoder
    forward into the loop — read -> tokenize -> nomic forward -> append —
    measuring whether the prefetch pipeline actually hides host work under
    the device forward (compare against the forward-only ``encode`` suite).
    """
    import shutil
    import tempfile

    from ..config import (CorpusConfig, EncoderConfig, PipelineConfig,
                          SearchConfig, StoreConfig)
    from ..pipeline import Pipeline

    tmp = tempfile.mkdtemp(prefix="bsr_bench_")
    try:
        import os

        src = os.path.join(tmp, "src")
        os.makedirs(src)
        rng = np.random.default_rng(0)
        for i in range(files):
            body = " ".join(
                f"tok{rng.integers(0, 5000)}" for _ in range(400)
            )
            with open(os.path.join(src, f"F{i}.java"), "w") as f:
                f.write(f"class F{i} {{ {body} }}")
        if inflight is None:
            inflight = int(os.environ.get("BSR_INGEST_INFLIGHT", "0")) or \
                CorpusConfig.inflight_batches
        cfg = PipelineConfig(
            corpus=CorpusConfig(root=src, extensions=("java",),
                                files_per_batch=batch,
                                inflight_batches=inflight),
            encoder=EncoderConfig(backend=backend, dim=dim, batch_size=batch),
            store=StoreConfig(dir=os.path.join(tmp, "vstore")),
            search=SearchConfig(top_k=50),
        )
        p = Pipeline(cfg)
        # Startup (encoder init + first-compile) is reported separately —
        # the one-time compile would swamp a 512-file throughput number.
        t0 = time.perf_counter()
        p.encoder.get_embeddings(["warm up the compiled forward"])
        startup = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = p.ingest_shard()
        p.merge()
        elapsed = time.perf_counter() - t0
        return {
            "metric": f"ingest_{backend}_files_per_sec",
            "value": round(stats.embeddings / elapsed, 2),
            "unit": "files/sec",
            "vs_baseline": 0.0,
            "files": stats.embeddings,
            "elapsed_s": round(elapsed, 2),
            "startup_s": round(startup, 2),
            "backend": backend,
            "files_per_batch": batch,
            "inflight_batches": inflight,
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def encoder_forward_flops(cfg, batch: int, seq: int) -> float:
    """Analytic forward FLOPs of the NomicBERT backbone (matmuls only):
    per layer QKV + attention output projections (4 d^2 per token), QK^T and
    AV (2 * 2 * S * d per token), and the SwiGLU MLP (fused fc1 emits
    2*mlp_dim, fc2 reads mlp_dim -> 3 * d * mlp per token); 2 FLOP per MAC."""
    d = cfg.hidden_size
    per_token = cfg.num_layers * (
        2 * (4 * d * d)            # qkv (3d^2) + attn out (d^2)
        + 2 * (2 * seq * d)        # QK^T + AV
        + 2 * (3 * d * cfg.mlp_dim)  # swiglu fc1 (2x) + fc2
    )
    return float(per_token) * batch * seq


def run_encode_suite(batch: int = 256, iters: int = 8,
                     max_tokens: int = 512) -> dict:
    """Nomic forward throughput (random init — measures the compute path the
    checkpoint weights would ride) at ``batch`` files per forward."""
    import jax

    from ..models.nomic import (
        NomicBertConfig, NomicEncoder, resolve_attention_impl)

    cfg = NomicBertConfig(max_tokens=max_tokens)
    enc = NomicEncoder(cfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, cfg.vocab_size, size=(batch, max_tokens)).astype(np.int32)
    mask = np.ones((batch, max_tokens), np.int32)

    jax.block_until_ready(enc.encode_tokens_device(ids, mask))  # compile
    # Device-resident throughput: pipelined dispatches, one wait.
    t0 = time.perf_counter()
    for _ in range(iters):
        out = enc.encode_tokens_device(ids, mask)
    jax.block_until_ready(out)
    elapsed = max(time.perf_counter() - t0, 1e-9)
    peak = device_peak_flops()
    flops = encoder_forward_flops(cfg, batch, max_tokens) * iters
    return {
        "metric": "encode_files_per_sec",
        "value": round(batch * iters / elapsed, 2),
        "unit": "files/sec",
        "vs_baseline": 0.0,
        "mfu": round(flops / elapsed / peak, 4) if peak else None,
        "batch": batch,
        "max_tokens": max_tokens,
        "attention_impl": resolve_attention_impl(cfg.attention_impl,
                                                 cfg.dtype),
        "platform": jax.devices()[0].platform,
    }


def run_finetune_suite(batch: int = 64, steps: int = 8,
                       max_tokens: int = 512, num_layers: int = 12,
                       hidden: int = 768) -> dict:
    """Contrastive train-step throughput on the serving model size
    (12L/768, random init): files/sec through one optimization step
    (forward ×2 towers + backward + adamw). MFU counts ~3x the two
    towers' forward matmul FLOPs (the standard fwd:bwd = 1:2 accounting)."""
    import jax

    from ..models.nomic import NomicBertConfig, resolve_attention_impl
    from ..models.train import ContrastiveTrainer
    from ..parallel.mesh import create_mesh

    cfg = NomicBertConfig(max_tokens=max_tokens, num_layers=num_layers,
                          hidden_size=hidden, mlp_dim=4 * hidden)
    n_dev = len(jax.devices())
    mesh = create_mesh(shape=(n_dev, 1), axis_names=("data", "model"))
    batch += (-batch) % n_dev  # DP shards the batch over the data axis
    tr = ContrastiveTrainer(cfg, mesh, learning_rate=1e-5)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, cfg.vocab_size, size=(batch, max_tokens)).astype(np.int32)
    mask = np.ones((batch, max_tokens), np.int32)
    ids_b = rng.integers(1, cfg.vocab_size, size=(batch, max_tokens)).astype(np.int32)

    # Warm (compile) one step, then time ``steps`` pipelined steps.
    jax.block_until_ready(tr.train_step_device(ids, mask, ids_b, mask))
    t0 = time.perf_counter()
    for _ in range(steps):
        loss_dev = tr.train_step_device(ids, mask, ids_b, mask)
    loss = float(jax.device_get(jax.block_until_ready(loss_dev)))
    elapsed = max(time.perf_counter() - t0, 1e-9)
    peak = device_peak_flops()
    flops = 3 * 2 * encoder_forward_flops(cfg, batch, max_tokens) * steps
    return {
        "metric": "finetune_files_per_sec",
        "value": round(batch * steps / elapsed, 2),
        "unit": "files/sec",
        "vs_baseline": 0.0,
        "steps_per_sec": round(steps / elapsed, 3),
        "final_loss": float(loss),
        "mfu": round(flops / elapsed / peak, 4) if peak else None,
        "batch": batch,
        "max_tokens": max_tokens,
        "attention_impl": resolve_attention_impl(tr.config.attention_impl,
                                                 tr.config.dtype),
        "devices": mesh.size,
        "platform": jax.devices()[0].platform,
    }


def run_battery_suite() -> dict:
    """Time-boxed multi-suite battery: ONE summary line whose headline
    keys are the ``search_1m`` result (full protocol — the driver's
    recorded metric stays the headline q/s) plus per-suite sub-objects
    under ``battery`` covering the breadth the ledger claims: int8
    stores, the 10M low-dim config, the encoder forward, and the
    micro-batched serve path.

    ``BSR_BATTERY_BUDGET_S`` (default 1500) bounds the run: suites that
    would start after the budget is spent are recorded under
    ``battery_skipped`` instead of running — no silent truncation."""
    import dataclasses

    budget_s = float(os.environ.get("BSR_BATTERY_BUDGET_S", "1500"))
    t_start = time.perf_counter()

    def _run_jabref():
        from .jabref import run_jabref_suite

        return run_jabref_suite()

    # Ordering rule: after the mandatory search_1m headline, the plan runs
    # the reference's flagship experiment and the cheap suites first, so a
    # tight budget skips the expensive 10M builds, not them. The tail runs
    # with trimmed iters.
    plan = [
        ("search_1m", lambda: run_search_suite("search_1m",
                                               SUITES["search_1m"])),
        # The reference's actual experiment (README.md:155-166,
        # src/main.rs:38-40): 2,305-file JabRef-shaped corpus, full
        # ingest -> merge -> search with the serial anchor + speedup.
        ("jabref", _run_jabref),
        ("serve_100k", lambda: run_serve_suite(
            base="search_100k", clients=16, requests_per_client=12)),
        # Reference-dtype parity point (f32 store).
        ("search_1m_f32", lambda: run_search_suite(
            "search_1m_f32", SUITES["search_1m_f32"])),
        # bf16 10M low-dim.
        ("search_10m_mat256", lambda: run_search_suite(
            "search_10m_mat256",
            dataclasses.replace(SUITES["search_10m_mat256"], iters=3))),
        ("finetune", run_finetune_suite),
        # Open-loop serve on the 1M store: 64 clients x outstanding=8
        # keeps ~512 requests in flight.
        ("serve_open", lambda: run_serve_suite(
            base="search_1m", clients=64, outstanding=8,
            requests_per_client=256)),
        ("encode", run_encode_suite),
        ("search_1m_int8", lambda: run_search_suite(
            "search_1m_int8",
            dataclasses.replace(SUITES["search_1m_int8"], iters=3))),
        ("search_10m_int8_mat256", lambda: run_search_suite(
            "search_10m_int8_mat256",
            dataclasses.replace(SUITES["search_10m_int8_mat256"], iters=3))),
        # Full-dimension 10M int8 (7.7 GB store) — the most expensive
        # build.
        ("search_10m_int8", lambda: run_search_suite(
            "search_10m_int8",
            dataclasses.replace(SUITES["search_10m_int8"], iters=3))),
    ]

    battery: Dict[str, dict] = {}
    skipped = []
    for name, fn in plan:
        if name != "search_1m" and time.perf_counter() - t_start > budget_s:
            skipped.append(name)
            continue
        t_suite = time.perf_counter()
        try:
            battery[name] = fn()
        except Exception as exc:  # a broken sub-suite must not hide the rest
            # Truncate: a compile error can carry a multi-KB log dump, and
            # an oversized error string would force the compact line to
            # shed every other suite's keys.
            battery[name] = {
                "error": f"{type(exc).__name__}: {exc}"[:300]}
        # Per-suite wall time (detail file only — compact line drops it):
        # the budget-fitting evidence.
        battery[name]["wall_s"] = round(time.perf_counter() - t_suite, 1)

    headline = dict(battery.get("search_1m", {}))
    headline["battery"] = {
        n: r for n, r in battery.items() if n != "search_1m"
    }
    if skipped:
        headline["battery_skipped"] = skipped
    headline["battery_wall_s"] = round(time.perf_counter() - t_start, 1)
    return headline


#: Headline (search_1m) keys kept in the compact battery line.
_COMPACT_HEAD_KEYS = (
    "metric", "value", "unit", "vs_baseline", "recall_at_10", "mfu",
    "qps_repeats", "spread_pct", "kernel", "devices", "platform",
)
#: Per-sub-suite keys kept, most important first — the tail of this tuple
#: is dropped first if the line would exceed the hard cap.
_COMPACT_SUB_KEYS = (
    "value", "error", "recall_at_10", "mfu", "spread_pct", "oracle_overlap",
    "speedup_vs_serial", "coalescing", "outstanding", "unit", "vs_baseline",
)


def compact_battery_summary(full: dict, cap_bytes: int = 1500) -> dict:
    """Compress a ``run_battery_suite`` result to ONE parseable line of at
    most ``cap_bytes`` when JSON-serialized.

    A capture of only the output's last ~2000 characters would lose the
    headline keys of a full-detail battery line. The compact form keeps the headline ``search_1m`` keys
    plus ``{value, recall_at_10, mfu, spread_pct, ...}`` per sub-suite;
    the full result goes to the detail file ``bench.py`` writes."""
    import json

    def build(sub_keys) -> dict:
        out = {k: full[k] for k in _COMPACT_HEAD_KEYS if k in full}
        out["battery"] = {
            name: {k: sub[k] for k in sub_keys if sub.get(k) is not None}
            for name, sub in full.get("battery", {}).items()
        }
        for k in ("battery_skipped", "battery_wall_s"):
            if k in full:
                out[k] = full[k]
        return out

    keys = list(_COMPACT_SUB_KEYS)
    out = build(keys)
    while len(json.dumps(out)) > cap_bytes and keys:
        keys.pop()
        out = build(keys)
    # With enough sub-suites even the empty-keys form can overflow the
    # cap; drop whole sub-suite entries (last-listed first — the plan
    # orders the most artifact-starved suites earliest), then the
    # battery dict itself, so the search_1m headline keys ALWAYS fit a
    # ~2000-char tail capture.
    while len(json.dumps(out)) > cap_bytes and out.get("battery"):
        dropped = list(out["battery"])[-1]
        del out["battery"][dropped]
        out.setdefault("battery_truncated", []).append(dropped)
    if len(json.dumps(out)) > cap_bytes:
        out.pop("battery", None)
        out.pop("battery_truncated", None)
    return out


def run_suite(name: str) -> dict:
    if name == "battery":
        return run_battery_suite()
    if name in SUITES:
        return run_search_suite(name, SUITES[name])
    if name == "pipeline":
        return run_pipeline_suite()
    if name == "pipeline_nomic":
        # Composed real-encoder ingest (reference's actual
        # embedding_generation phase, src/mpi_helpers/tasks.rs:94-148) at
        # B=256, 12 batches.
        return run_pipeline_suite(files=3072, backend="nomic", batch=256)
    if name == "serve":
        # Closed-loop clients (one outstanding request each) are bound by
        # the round trip; scale the client count to probe the device-side
        # ceiling.
        return run_serve_suite(
            clients=int(os.environ.get("BSR_SERVE_CLIENTS", "64")),
            requests_per_client=int(
                os.environ.get("BSR_SERVE_REQUESTS", "24")
            ),
            window_ms=float(os.environ.get("BSR_SERVE_WINDOW_MS", "2.0")),
            outstanding=int(os.environ.get("BSR_SERVE_OUTSTANDING", "1")),
            upload=os.environ.get("BSR_SERVE_UPLOAD", "f32"),
        )
    if name == "serve_100k":
        # Cheap variant (store builds in <1 s) for quick serve-path checks.
        return run_serve_suite(base="search_100k", clients=16,
                               requests_per_client=12)
    if name == "encode":
        return run_encode_suite()
    if name == "finetune":
        return run_finetune_suite()
    if name == "jabref":
        from .jabref import run_jabref_suite

        return run_jabref_suite()
    raise ValueError(
        f"unknown suite {name!r}; available: "
        f"{sorted(SUITES) + ['battery', 'pipeline', 'pipeline_nomic', 'encode', 'finetune', 'jabref', 'serve', 'serve_100k']}"
    )
