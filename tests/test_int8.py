"""int8 quantized-store tests: lattice quantization, integer-exact scoring,
engine-vs-oracle exactness on the 8-device mesh, and the interpret-mode
Pallas kernels — all bitwise, because int8 scoring is exact integer
arithmetic on every backend (ops/quantize.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from better_search_rag_rust_tpu.config import SearchConfig
from better_search_rag_rust_tpu.metrics import top_k_overlap
from better_search_rag_rust_tpu.ops import SearchEngine, serial_topk
from better_search_rag_rust_tpu.ops.quantize import (
    INT8_INV_SCALE2,
    cast_rows_to_host,
    int8_sims_host,
    quantize_unit,
    quantize_unit_host,
)
from better_search_rag_rust_tpu.store import DeviceStore
from better_search_rag_rust_tpu.utils.testing import mock_embeddings


def _unit_rows(n, dim, seed=0):
    mat = mock_embeddings(n, dim=dim, seed=seed)
    norms = np.linalg.norm(mat, axis=1, keepdims=True)
    return (mat / np.where(norms == 0.0, 1.0, norms)).astype(np.float32)


def _engine(mesh, n, dim=64, seed=0, kernel="auto", chunk_rows=256, k=None):
    mat = mock_embeddings(n, dim=dim, seed=seed)
    store = DeviceStore.from_host(mat, mesh, dtype="int8", chunk_rows=chunk_rows)
    cfg = SearchConfig(kernel=kernel, chunk_rows=chunk_rows)
    return mat, SearchEngine(store, cfg)


def _assert_matches_oracle(engine, queries, k):
    """Engine vs the device-side oracle (exact ids), plus a host-side
    pure-NumPy INTEGER oracle — bitwise for int8 stores, so even distances
    must agree exactly."""
    ids, dists = engine.search(queries, k)
    o_ids, o_dists = engine.oracle_topk(queries, k)
    assert top_k_overlap(o_ids.tolist(), ids.tolist(), k=ids.shape[1]) == 1.0
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_array_equal(dists, o_dists)

    # Independent host oracle over the same lattice: int32 matmul in NumPy.
    eff_store = engine.effective_store().astype(np.int8)
    eff_q = engine.effective_queries(queries).astype(np.int8)
    sims = int8_sims_host(eff_store, eff_q)
    np_ids, np_dists = serial_topk(eff_store, queries, k, sims=sims)
    np.testing.assert_array_equal(ids, np_ids)
    np.testing.assert_array_equal(dists, np_dists)
    return ids, dists


# ---------------------------------------------------------------------------
# Quantization mapping
# ---------------------------------------------------------------------------


def test_quantize_host_device_bitwise():
    rows = _unit_rows(257, 96, seed=3)
    host = quantize_unit_host(rows)
    dev = np.asarray(quantize_unit(jnp.asarray(rows)))
    np.testing.assert_array_equal(host, dev)
    assert host.dtype == np.int8
    assert host.min() >= -127  # -128 never produced (symmetric lattice)


def test_quantize_zero_row_scores_zero():
    """A zero row stays the zero lattice point: distance exactly 1.0
    (reference semantics, src/metrics.rs:157-159)."""
    rows = np.zeros((1, 64), np.float32)
    assert np.all(quantize_unit_host(rows) == 0)


def test_cast_rows_to_host_non_int8_passthrough():
    rows = _unit_rows(4, 32)
    out = cast_rows_to_host(rows, "bfloat16")
    assert out.dtype == jnp.bfloat16


def test_scaled_score_range():
    """Scaled integer dots of quantized unit rows stay within [-1-eps,
    1+eps], above the PAD_SIM sentinel."""
    rows = _unit_rows(128, 768, seed=5)
    q = quantize_unit_host(rows)
    sims = int8_sims_host(q, q)
    assert sims.max() <= 1.02 and sims.min() >= -1.02


# ---------------------------------------------------------------------------
# Engine exactness on the 8-device mesh (XLA kernels on CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["scan", "blockmax", "global"])
def test_engine_exact_vs_oracle(mesh8, kernel):
    mat, engine = _engine(mesh8, n=999, kernel=kernel)
    queries = mock_embeddings(8, dim=64, seed=42)
    _assert_matches_oracle(engine, queries, k=10)


def test_engine_exact_k50_jabref_size(mesh8):
    mat, engine = _engine(mesh8, n=2305, seed=7)
    queries = mock_embeddings(4, dim=64, seed=11)
    _assert_matches_oracle(engine, queries, k=50)


def test_duplicate_rows_tie_to_lowest_index(mesh8):
    """Duplicate f32 rows quantize to identical lattice rows: exact integer
    ties, resolved to the lowest store row index."""
    base = mock_embeddings(300, dim=64, seed=13)
    mat = np.concatenate([base, base[:50]], axis=0)  # rows 300..349 dup 0..49
    store = DeviceStore.from_host(mat, mesh8, dtype="int8", chunk_rows=128)
    engine = SearchEngine(store, SearchConfig(chunk_rows=128))
    queries = base[:4]
    ids, dists = _assert_matches_oracle(engine, queries, k=5)
    # self-retrieval: the duplicated row's LOW copy must win the tie
    for qi in range(4):
        assert ids[qi, 0] == qi


def test_self_retrieval(mesh8):
    mat, engine = _engine(mesh8, n=500, seed=3)
    ids, dists = engine.search(mat[0], k=10)
    assert ids[0, 0] == 0
    assert dists[0, 0] == pytest.approx(0.0, abs=1e-2)


def test_store_upload_path(mesh8):
    """upload="store" quantizes on the HOST and uploads int8 bits (4x fewer
    bytes); results must match the oracle pinned to the same query bits."""
    mat, engine = _engine(mesh8, n=777, seed=21)
    assert engine.supports_store_upload()
    queries = mock_embeddings(6, dim=64, seed=22)
    qprep = engine.prepare_upload_queries(queries)
    assert qprep.dtype == np.int8
    out = list(engine.search_stream([queries], k=7, upload="store"))
    ids, dists = out[0]
    o_ids, o_dists = engine.oracle_topk(queries, 7, upload="store")
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_array_equal(dists, o_dists)


def test_matryoshka_int8(mesh8):
    """Matryoshka truncation composes with int8 quantization."""
    mat = mock_embeddings(400, dim=128, seed=31)
    store = DeviceStore.from_host(
        mat, mesh8, dtype="int8", chunk_rows=128, matryoshka_dim=64
    )
    engine = SearchEngine(store, SearchConfig(chunk_rows=128))
    queries = mock_embeddings(3, dim=128, seed=32)
    ids, dists = engine.search(queries, k=9)
    o_ids, _ = engine.oracle_topk(queries, 9)
    np.testing.assert_array_equal(ids, o_ids)


# ---------------------------------------------------------------------------
# The shared scoring arithmetic: bitwise vs the integer oracle
# ---------------------------------------------------------------------------


def _int8_fixture(rows=512, t=16, dim=128, seed=17):
    s = quantize_unit_host(_unit_rows(rows, dim, seed=seed))
    q = quantize_unit_host(_unit_rows(t, dim, seed=seed + 1))
    ref = int8_sims_host(s, q)  # [T, R]
    return jnp.asarray(q), jnp.asarray(s), ref


def test_xla_sims_int8_bitwise_vs_host():
    """Every kernel scores int8 rows through ``xla_sims``; its scaled
    integer dot must equal the host integer oracle bit for bit."""
    from better_search_rag_rust_tpu.ops.topk import xla_sims

    q, s, ref = _int8_fixture()
    np.testing.assert_array_equal(np.asarray(xla_sims(q, s)), ref)
