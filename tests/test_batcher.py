"""Dynamic micro-batching serving layer (better_search_rag_rust_tpu/batcher.py).

The reference has no serving daemon at all (SURVEY.md §2: SKIP_PROCESS re-runs
the binary per query); the batcher is the many-concurrent-clients regime of
the serve stack. The contract under test: a submit()'s future resolves to
exactly what engine.search() of the same rows returns, regardless of how
requests were coalesced, interleaved or padded.
"""

import threading
import time

import numpy as np
import pytest

from better_search_rag_rust_tpu.batcher import DynamicBatcher
from better_search_rag_rust_tpu.config import SearchConfig
from better_search_rag_rust_tpu.ops.engine import SearchEngine
from better_search_rag_rust_tpu.parallel.mesh import create_mesh
from better_search_rag_rust_tpu.store.device_store import DeviceStore
from better_search_rag_rust_tpu.utils.testing import mock_embeddings


@pytest.fixture(scope="module")
def engine():
    mesh = create_mesh()
    mat = mock_embeddings(600, dim=32, seed=11)
    store = DeviceStore.from_host(mat, mesh, dtype="bfloat16", chunk_rows=128)
    return SearchEngine(store, SearchConfig(top_k=10))


def test_concurrent_submits_match_search(engine):
    """32 threads x mixed batch sizes: every future must equal the direct
    engine.search of its own rows (the batcher's core exactness claim)."""
    rng = np.random.default_rng(0)
    mat = engine.effective_store()
    with DynamicBatcher(engine, k=10, window_ms=5.0) as b:
        results = {}

        def client(i):
            nq = 1 + (i % 3)
            q = mat[rng.integers(0, 600, nq).tolist()]
            results[i] = (q, b.submit(q))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, (q, fut) in results.items():
            ids, dists = fut.result(timeout=60)
            ref_ids, ref_dists = engine.search(q, k=10)
            np.testing.assert_array_equal(ids, ref_ids, err_msg=f"client {i}")
            # CPU-backend matmul blocking varies with batch shape -> 1-ulp
            # sims drift; ids stay exact.
            np.testing.assert_allclose(dists, ref_dists, atol=1e-6)
    assert b.stats.requests == 32
    assert b.stats.batched_queries == b.stats.queries


def test_coalescing_actually_happens(engine):
    """Requests landing within one window must share dispatches: with a
    generous window and simultaneous submits, far fewer batches than
    requests."""
    mat = engine.effective_store()
    with DynamicBatcher(engine, k=10, window_ms=200.0) as b:
        barrier = threading.Barrier(16)
        futs = []
        lock = threading.Lock()

        def client(i):
            barrier.wait()
            f = b.submit(mat[i : i + 1])
            with lock:
                futs.append(f)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for f in futs:
            f.result(timeout=60)
    assert b.stats.requests == 16
    assert b.stats.batches < 16, b.stats
    assert b.stats.coalescing() > 1.0


def test_bad_dim_rejected_at_submit_without_killing_batch(engine):
    mat = engine.effective_store()
    with DynamicBatcher(engine, k=10, window_ms=20.0) as b:
        good = b.submit(mat[:2])
        with pytest.raises(ValueError, match="query dim"):
            b.submit(np.zeros((1, 7), np.float32))
        ids, _ = good.result(timeout=60)
        ref_ids, _ = engine.search(mat[:2], k=10)
        np.testing.assert_array_equal(ids, ref_ids)


def test_oversized_request_dispatches_alone(engine):
    mat = engine.effective_store()
    with DynamicBatcher(engine, k=10, max_batch=8, window_ms=1.0) as b:
        fut = b.submit(mat[:50])  # 50 rows > max_batch=8
        ids, _ = fut.result(timeout=60)
    ref_ids, _ = engine.search(mat[:50], k=10)
    np.testing.assert_array_equal(ids, ref_ids)


def test_close_drains_and_rejects_new_work(engine):
    mat = engine.effective_store()
    b = DynamicBatcher(engine, k=10, window_ms=500.0)
    fut = b.submit(mat[:1])
    b.close()  # must flush the open window, not wait 500 ms then drop
    assert fut.done()
    ids, _ = fut.result(timeout=0)
    assert ids.shape == (1, 10)
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(mat[:1])


def test_1d_query_auto_promotes(engine):
    mat = engine.effective_store()
    with DynamicBatcher(engine, k=10, window_ms=1.0) as b:
        ids, dists = b.submit(mat[3]).result(timeout=60)
    assert ids.shape == (1, 10)
    assert ids[0, 0] == 3


def test_backpressure_bounded_inflight(engine):
    """depth=1: the former must still make progress (no deadlock) when many
    batches are formed faster than they are collected."""
    mat = engine.effective_store()
    with DynamicBatcher(engine, k=10, max_batch=2, window_ms=0.0, depth=1) as b:
        futs = [b.submit(mat[i : i + 1]) for i in range(24)]
        for f in futs:
            f.result(timeout=60)
    assert b.stats.batched_queries == 24
