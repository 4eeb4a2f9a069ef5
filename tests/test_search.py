"""Exact search engine tests: the engine must match the serial-scan oracle
with top-k overlap 1.0 — the reference's parallel-vs-sequential exactness
check (src/metrics.rs:98-141), run here on an emulated 8-device mesh."""

import jax
import numpy as np
import pytest

from better_search_rag_rust_tpu.config import SearchConfig
from better_search_rag_rust_tpu.metrics import top_k_overlap
from better_search_rag_rust_tpu.ops import SearchEngine, serial_topk
from better_search_rag_rust_tpu.store import DeviceStore
from better_search_rag_rust_tpu.utils.testing import mock_embeddings


def _engine(mesh, n, dim=64, dtype="float32", seed=0, kernel="auto", chunk_rows=256):
    mat = mock_embeddings(n, dim=dim, seed=seed)
    store = DeviceStore.from_host(mat, mesh, dtype=dtype, chunk_rows=chunk_rows)
    cfg = SearchConfig(kernel=kernel, chunk_rows=chunk_rows)
    return mat, SearchEngine(store, cfg)


def _assert_matches_oracle(engine, queries, k):
    """Engine vs serial oracle: exact overlap over shared scoring arithmetic
    (the reference's parallel-vs-serial relationship), plus a tolerance-aware
    cross-check against an independent pure-NumPy scan (whose matmul sums in
    a different order, so ulp-level near-ties may legitimately reorder)."""
    ids, dists = engine.search(queries, k)
    o_ids, o_dists = engine.oracle_topk(queries, k)
    assert ids.shape == o_ids.shape
    assert (
        top_k_overlap(o_ids.tolist(), ids.tolist(), k=ids.shape[1]) == 1.0
    ), f"engine {ids[:2]} vs oracle {o_ids[:2]}"
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_allclose(dists, o_dists, atol=1e-6)

    np_ids, np_dists = serial_topk(
        engine.effective_store(), engine.effective_queries(queries), k
    )
    # backend accumulation for bf16 operands differs from numpy f32 by more
    # than f32 ulp; the exactness contract above is the authoritative check
    atol = 1e-5 if engine.store.data.dtype == np.float32 else 4e-3
    np.testing.assert_allclose(dists, np_dists, atol=atol)
    assert top_k_overlap(np_ids.tolist(), ids.tolist(), k=ids.shape[1]) > 0.9
    return ids, dists


@pytest.mark.parametrize("kernel", ["scan", "blockmax", "global"])
def test_exact_vs_oracle_f32(mesh8, kernel):
    mat, engine = _engine(mesh8, n=999, kernel=kernel)
    queries = mock_embeddings(8, dim=64, seed=42)
    _assert_matches_oracle(engine, queries, k=10)


def test_exact_vs_oracle_k50(mesh8):
    mat, engine = _engine(mesh8, n=2305, seed=7)  # JabRef-sized corpus
    queries = mock_embeddings(4, dim=64, seed=11)
    _assert_matches_oracle(engine, queries, k=50)


def test_self_retrieval(mesh8):
    """Stored vector 0 as the query must retrieve itself at rank 1 — the
    reference driver's accuracy check (src/main.rs:110-155)."""
    mat, engine = _engine(mesh8, n=500, seed=3)
    ids, dists = engine.search(mat[0], k=10)
    assert ids[0, 0] == 0
    assert dists[0, 0] == pytest.approx(0.0, abs=1e-5)


def test_single_query_api(mesh8):
    mat, engine = _engine(mesh8, n=100, seed=5)
    results = engine.search_single(mat[17], k=5)
    assert len(results) == 5
    assert results[0][0] == 17


def test_k_clamped_to_row_count(mesh8):
    mat, engine = _engine(mesh8, n=7, seed=9)
    ids, dists = engine.search(mock_embeddings(2, dim=64, seed=1), k=50)
    assert ids.shape == (2, 7)
    # no padded rows may leak out
    assert ids.max() < 7


def test_more_devices_than_meaningful_rows(mesh8):
    # 3 rows over 8 devices — the reference panics here
    # (src/mpi_helpers/metrics.rs:27 has no rank>=rows guard)
    mat, engine = _engine(mesh8, n=3, seed=2)
    ids, dists = engine.search(mat[1], k=3)
    assert ids[0, 0] == 1
    assert sorted(ids[0].tolist()) == [0, 1, 2]


def test_duplicate_rows_tie_break_by_lowest_index(mesh8):
    """Exact ties must resolve to the lowest store row index, matching the
    oracle (reference dedups on index, src/mpi_helpers/metrics.rs:156-168)."""
    base = mock_embeddings(64, dim=32, seed=21)
    # duplicate row 5 at positions scattered across shards
    mat = base.copy()
    for pos in (13, 29, 47, 61):
        mat[pos] = mat[5]
    store = DeviceStore.from_host(mat, mesh8, dtype="float32", chunk_rows=128)
    engine = SearchEngine(store, SearchConfig(kernel="scan"))
    ids, dists = engine.search(mat[5], k=5)
    assert ids[0].tolist() == [5, 13, 29, 47, 61]

    engine_bm = SearchEngine(store, SearchConfig(kernel="blockmax"))
    ids_bm, _ = engine_bm.search(mat[5], k=5)
    assert ids_bm[0].tolist() == [5, 13, 29, 47, 61]

    engine_g = SearchEngine(store, SearchConfig(kernel="global"))
    ids_g, _ = engine_g.search(mat[5], k=5)
    assert ids_g[0].tolist() == [5, 13, 29, 47, 61]


def test_zero_store_rows_have_distance_one(mesh8):
    mat = mock_embeddings(32, dim=16, seed=4)
    mat[10] = 0.0  # zero-magnitude row => distance 1.0 (src/metrics.rs:157-159)
    store = DeviceStore.from_host(mat, mesh8, dtype="float32")
    engine = SearchEngine(store)
    ids, dists = engine.search(mat[0], k=32)
    pos = ids[0].tolist().index(10)
    assert dists[0, pos] == pytest.approx(1.0, abs=1e-6)


def test_zero_query_all_distances_one(mesh8):
    mat, engine = _engine(mesh8, n=20, dim=16, seed=6)
    ids, dists = engine.search(np.zeros(16, dtype=np.float32), k=20)
    np.testing.assert_allclose(dists[0], 1.0, atol=1e-6)
    # ties at distance 1.0 resolve to ascending index, like the oracle
    assert ids[0].tolist() == list(range(20))


def test_bf16_store_matches_equal_memory_oracle(mesh8):
    """bf16 shards on device with f32 accumulation must match a serial f32 scan
    over the same bf16-rounded data (BASELINE.json equal-memory harness)."""
    mat, engine = _engine(mesh8, n=512, dtype="bfloat16", seed=8)
    queries = mock_embeddings(4, dim=64, seed=13)
    _assert_matches_oracle(engine, queries, k=10)


def test_single_device_mesh(mesh1):
    mat, engine = _engine(mesh1, n=333, seed=14)
    queries = mock_embeddings(3, dim=64, seed=15)
    _assert_matches_oracle(engine, queries, k=10)


def test_blockmax_equals_scan(mesh8):
    mat = mock_embeddings(1024, dim=32, seed=17)
    store = DeviceStore.from_host(mat, mesh8, dtype="float32", chunk_rows=256)
    queries = mock_embeddings(5, dim=32, seed=18)
    ids_a, d_a = SearchEngine(store, SearchConfig(kernel="scan")).search(queries, 20)
    ids_b, d_b = SearchEngine(store, SearchConfig(kernel="blockmax")).search(
        queries, 20
    )
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, atol=1e-7)


def test_query_dim_mismatch_raises(mesh8):
    mat, engine = _engine(mesh8, n=10, dim=64)
    with pytest.raises(ValueError):
        engine.search(np.zeros(32, dtype=np.float32), k=3)


def test_global_equals_scan(mesh8):
    """The dense two-stage kernel must agree bit-for-bit with the scanning
    kernel on indices (same scoring arithmetic, same tie discipline)."""
    mat = mock_embeddings(1024, dim=32, seed=23)
    store = DeviceStore.from_host(mat, mesh8, dtype="float32", chunk_rows=256)
    queries = mock_embeddings(5, dim=32, seed=24)
    ids_a, d_a = SearchEngine(store, SearchConfig(kernel="scan")).search(queries, 20)
    ids_g, d_g = SearchEngine(store, SearchConfig(kernel="global")).search(
        queries, 20
    )
    np.testing.assert_array_equal(ids_a, ids_g)
    np.testing.assert_allclose(d_a, d_g, atol=1e-7)


def test_global_kernel_k_exceeds_shard(mesh8):
    """k larger than any single shard's rows: candidate padding must keep the
    merged result exact."""
    mat, engine = _engine(mesh8, n=100, seed=25, kernel="global")
    queries = mock_embeddings(3, dim=64, seed=26)
    _assert_matches_oracle(engine, queries, k=80)


def test_global_kernel_query_tiling(mesh8):
    """More queries than one tile (force q_tile < Q) stays exact."""
    mat = mock_embeddings(512, dim=32, seed=27)
    store = DeviceStore.from_host(mat, mesh8, dtype="float32", chunk_rows=128)
    engine = SearchEngine(store, SearchConfig(kernel="global"))
    engine._plan = lambda q: (8, 10**9)  # force query tiling
    queries = mock_embeddings(37, dim=32, seed=28)  # non-multiple of tile
    ids, dists = engine.search(queries, k=9)
    o_ids, o_dists = engine.oracle_topk(queries, k=9)
    np.testing.assert_array_equal(ids, o_ids)


def test_duplicate_ties_still_exact_with_verified_selection(mesh8):
    """End-to-end: a store saturated with duplicates (every selection hits
    the fallback path) still matches the oracle exactly."""
    base = mock_embeddings(8, dim=32, seed=52)
    mat = np.tile(base, (32, 1))  # 256 rows, every row duplicated 32x
    store = DeviceStore.from_host(mat, mesh8, dtype="float32", chunk_rows=128)
    engine = SearchEngine(store, SearchConfig(kernel="global"))
    ids, dists = engine.search(mat[:3], k=40)
    o_ids, o_dists = engine.oracle_topk(mat[:3], k=40)
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_allclose(dists, o_dists, atol=1e-7)


def test_macro_chunk_scan_exact(mesh8):
    """Shards larger than the sims-buffer budget scan in macro chunks with a
    running merge; result must stay oracle-exact (incl. duplicates crossing
    chunk boundaries)."""
    rng = np.random.default_rng(70)
    mat = rng.standard_normal((6000, 32)).astype(np.float32)
    mat[4000] = mat[10]  # duplicate pair straddling macro chunks
    mat[5500:5510] = mat[100]  # tie cluster in the last chunk
    queries = mat[rng.integers(0, 6000, 16)]
    store = DeviceStore.from_host(mat, mesh8, dtype="float32", chunk_rows=256)
    # per-device rows = 768; a 16-query tile at this budget scores 256-row
    # macro chunks, so every device runs 3 chunks
    engine = SearchEngine(
        store, SearchConfig(kernel="global", sims_buffer_bytes=16 * 256 * 4),
    )
    assert engine._plan(16) == (16, 256)
    ids, dists = engine.search(queries, k=17)
    o_ids, o_dists = engine.oracle_topk(queries, k=17)
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_allclose(dists, o_dists, atol=1e-7)


def test_select_blocks_approx_certificate_matches_exact():
    """_select_blocks' approx fast path must return exactly lax.top_k's
    block ids (value desc, index asc ties), and its certificate must route
    heavy-tie inputs through the exact fallback."""
    import jax
    import jax.numpy as jnp

    from better_search_rag_rust_tpu.ops.topk import _select_blocks

    rng = np.random.default_rng(71)
    # 1024 blocks, kb=20 -> kp=128 < nb//2: approx path taken
    bm = rng.standard_normal((8, 1024)).astype(np.float32)
    bm[:, 500:520] = bm[:, 100:120]  # duplicated maxima across blocks
    got = np.asarray(_select_blocks(jnp.asarray(bm), 20))
    want = np.asarray(jax.lax.top_k(jnp.asarray(bm), 20)[1])
    np.testing.assert_array_equal(np.sort(got, 1), np.sort(want, 1))

    # all-equal maxima: certificate must fail -> exact fallback, still right
    bm_t = np.ones((4, 1024), np.float32)
    got_t = np.asarray(_select_blocks(jnp.asarray(bm_t), 20))
    np.testing.assert_array_equal(np.sort(got_t, 1),
                                  np.arange(20)[None, :].repeat(4, 0))


def test_row_capacity_guard():
    """Stores whose padded rows would overflow int32 global row ids must be
    refused loudly (ops/topk.py computes gid = base + local idx as int32)."""
    import pytest

    from better_search_rag_rust_tpu.store.device_store import (
        check_row_capacity,
    )

    check_row_capacity(2**31 - 1)  # max addressable: fine
    with pytest.raises(ValueError, match="int32"):
        check_row_capacity(2**31)


def test_k_exceeds_rows_on_pallas_macro_path(mesh8):
    """k larger than a macro chunk's rows (and than some shards' rows) must
    pad candidates, never crash, and stay oracle-exact."""
    mat = mock_embeddings(300, dim=32, seed=72)
    store = DeviceStore.from_host(mat, mesh8, dtype="float32", chunk_rows=128)
    engine = SearchEngine(
        store, SearchConfig(kernel="global", sims_buffer_bytes=128 * 512 * 4)
    )
    ids, dists = engine.search(mat[:4], k=250)  # k > per-device rows
    o_ids, o_dists = engine.oracle_topk(mat[:4], k=250)
    np.testing.assert_array_equal(ids, o_ids)


def test_fast_topk_matches_lax_topk():
    """_fast_topk == lax.top_k on every (vals, positions) pair, including
    heavy ties (forces the certificate's count-check), PAD_SIM-flooded
    rows (forces the exact fallback), and the narrow-row passthrough."""
    import jax
    import jax.numpy as jnp

    from better_search_rag_rust_tpu.ops.topk import PAD_SIM, _fast_topk

    rng = np.random.default_rng(77)
    # wide row, approx path eligible (kp < n//2)
    x = rng.standard_normal((32, 1600)).astype(np.float32)
    # inject tie plateaus exactly at plausible boundaries
    x[:, 100:140] = x[:, 99:100]
    x[5] = 1.0                    # fully tied row
    x[7, :] = PAD_SIM             # fully padded row
    for kk in (1, 100, 128):
        fv, fp = jax.jit(lambda a, kk=kk: _fast_topk(a, kk))(jnp.asarray(x))
        tv, tp = jax.lax.top_k(jnp.asarray(x), kk)
        np.testing.assert_array_equal(np.asarray(fv), np.asarray(tv))
        np.testing.assert_array_equal(np.asarray(fp), np.asarray(tp))
    # narrow row: passthrough branch
    xn = rng.standard_normal((8, 64)).astype(np.float32)
    fv, fp = _fast_topk(jnp.asarray(xn), 60)
    tv, tp = jax.lax.top_k(jnp.asarray(xn), 60)
    np.testing.assert_array_equal(np.asarray(fv), np.asarray(tv))
    np.testing.assert_array_equal(np.asarray(fp), np.asarray(tp))


def test_serial_oracle_orders_by_raw_sims_not_distance():
    """The oracle must select by RAW f32 similarity (the engine's
    comparator). ``1 - sim`` loses up to one ulp near sim ~ 0: two
    distinct f32 sims can share one f32 distance, and an oracle sorting
    by distance would spuriously tie them (observed on chip). The row
    with the strictly higher sim must rank first even when the distances
    round to the same f32."""
    from better_search_rag_rust_tpu.ops.topk import serial_topk

    lo = np.float32(0.109457016)
    hi = np.float32(0.109457046)
    assert lo != hi
    # the f32 distances collapse — exactly the observed hazard
    assert np.float32(1.0 - lo) == np.float32(1.0 - hi)
    sims = np.array([[lo, hi, -0.5]], dtype=np.float32)
    store = np.zeros((3, 4), dtype=np.float32)  # unused when sims given
    ids, dists = serial_topk(store, np.zeros((1, 4), np.float32), 3,
                             sims=sims)
    np.testing.assert_array_equal(ids[0], [1, 0, 2])


def _matrix_store(case):
    """``(store matrix, queries, k, store kwargs, config kwargs)`` for one
    adversarial case of the exactness matrix."""
    rng = np.random.default_rng(80)
    if case == "duplicates":
        mat = rng.standard_normal((3000, 32)).astype(np.float32)
        mat[100] = mat[7]
        mat[2000:2010] = mat[50]  # 11-way duplicate cluster
        queries = np.concatenate([mat[[7, 50, 100, 2005]], -mat[:2]])
        return mat, queries, 9, {"chunk_rows": 256}, {}
    if case == "shard_boundary_ties":
        base = mock_embeddings(8, dim=32, seed=52)
        mat = np.tile(base, (32, 1))  # 256 rows: every row 32x, every shard
        return mat, mat[:3], 40, {"chunk_rows": 128}, {}
    if case == "zero_rows":
        mat = mock_embeddings(300, dim=32, seed=4)
        mat[[10, 37, 299]] = 0.0  # distance exactly 1.0
        queries = np.concatenate([mat[:2], np.zeros((1, 32), np.float32)])
        return mat, queries, 20, {"chunk_rows": 128}, {}
    if case == "k_over_shard_rows":
        mat = mock_embeddings(90, dim=16, seed=81)
        return mat, mat[:3], 80, {"chunk_rows": 64}, {}
    if case == "matryoshka_256":
        mat = mock_embeddings(600, dim=384, seed=33)
        return mat, mat[[1, 200, 599]], 12, {
            "chunk_rows": 128, "matryoshka_dim": 256}, {}
    if case == "macro_chunked":
        mat = rng.standard_normal((6000, 32)).astype(np.float32)
        mat[4000] = mat[10]  # duplicate pair straddling macro chunks
        mat[5500:5510] = mat[100]  # tie cluster in the last chunk
        queries = mat[rng.integers(0, 6000, 16)]
        return mat, queries, 17, {"chunk_rows": 256}, {
            "sims_buffer_bytes": 16 * 256 * 4}
    if case == "padded_tail":
        mat = mock_embeddings(1500, dim=32, seed=61)  # 188/device -> 272
        return mat, mat[[0, 750, 1499]], 7, {"chunk_rows": 136}, {}
    raise ValueError(case)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", [
    "duplicates", "shard_boundary_ties", "zero_rows", "k_over_shard_rows",
    "matryoshka_256", "macro_chunked", "padded_tail",
])
def test_global_exactness_matrix(mesh8, case, dtype):
    """The dense two-stage kernel equals the oracle (ids exactly, distances
    to f32 rounding) on every adversarial store shape, for every store
    dtype."""
    mat, queries, k, store_kw, cfg_kw = _matrix_store(case)
    store = DeviceStore.from_host(mat, mesh8, dtype=dtype, **store_kw)
    engine = SearchEngine(store, SearchConfig(kernel="auto", **cfg_kw))
    assert engine.kernel_name(k) == "global"
    ids, dists = engine.search(queries, k=k)
    o_ids, o_dists = engine.oracle_topk(queries, k=k)
    assert ids.shape == (len(queries), min(k, len(mat)))
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_allclose(dists, o_dists, atol=1e-6)


def test_unknown_kernel_rejected(mesh8):
    """Kernel names outside ``SearchConfig.kernel``'s values raise."""
    mat, engine = _engine(mesh8, n=10, kernel="rescore")
    with pytest.raises(ValueError, match="unknown search kernel"):
        engine.search(mat[0], k=3)


def test_serial_topk_partition_equals_full_stable_sort():
    """The oracle's partition shortcut returns exactly the first k of a full
    stable argsort by descending score, ties included."""
    from better_search_rag_rust_tpu.ops.topk import serial_topk

    rng = np.random.default_rng(91)
    sims = rng.integers(-20, 20, size=(6, 500)).astype(np.float32) / 20
    sims[2] = 0.5  # one fully tied row
    for k in (1, 7, 100, 499, 500, 800):
        ids, dists = serial_topk(None, np.zeros((6, 4), np.float32), k,
                                 sims=sims)
        want = np.argsort(-sims, axis=1, kind="stable")[:, :min(k, 500)]
        np.testing.assert_array_equal(ids, want)
        np.testing.assert_array_equal(
            dists, 1.0 - np.take_along_axis(sims, want, axis=1))

