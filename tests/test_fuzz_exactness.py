"""Randomized exactness sweep: the engine must equal the serial oracle
bit-for-bit on indices for arbitrary (rows, dim, dtype, kernel, k, queries)
combinations — the property the whole framework is built around
(reference's intended check: src/metrics.rs:98-141)."""

import numpy as np
import pytest

from better_search_rag_rust_tpu.config import SearchConfig
from better_search_rag_rust_tpu.ops import SearchEngine
from better_search_rag_rust_tpu.store import DeviceStore
from better_search_rag_rust_tpu.utils.testing import mock_embeddings


@pytest.mark.parametrize("trial", range(18))
def test_engine_equals_oracle_random_configs(mesh8, trial):
    rng = np.random.default_rng(1000 + trial)
    n = int(rng.integers(3, 1800))
    dim = int(rng.choice([8, 17, 64, 96, 200]))
    dtype = str(rng.choice(["float32", "bfloat16"]))
    kernel = str(rng.choice(["global", "scan", "blockmax"]))
    k = int(rng.integers(1, 70))
    nq = int(rng.integers(1, 9))
    chunk = int(rng.choice([128, 136, 256, 512]))

    # Half the trials force macro chunking at a random tiny sims budget so
    # the chunked running-merge path (incl. the padded tail and carry ties)
    # fuzzes alongside the single-chunk path. 0 = the auto budget.
    sims_budget = (
        int(rng.integers(16, 600)) * 1024 if trial % 2 else 0
    )

    mat = mock_embeddings(n, dim=dim, seed=2000 + trial)
    if trial % 3 == 0 and n > 10:
        # inject duplicates + a zero row for tie/edge coverage
        mat[n // 2] = mat[0]
        mat[n - 1] = mat[0]
        mat[n // 3] = 0.0
    store = DeviceStore.from_host(mat, mesh8, dtype=dtype, chunk_rows=chunk)
    engine = SearchEngine(
        store,
        SearchConfig(kernel=kernel, chunk_rows=chunk,
                     sims_buffer_bytes=sims_budget),
    )
    queries = mock_embeddings(nq, dim=dim, seed=3000 + trial)
    if trial % 4 == 0:
        queries[0] = mat[min(5, n - 1)]  # exact-hit query

    ids, dists = engine.search(queries, k=k)
    o_ids, o_dists = engine.oracle_topk(queries, k=k)
    cfgstr = f"n={n} dim={dim} {dtype} {kernel} k={k} nq={nq} chunk={chunk}"
    np.testing.assert_array_equal(ids, o_ids, err_msg=cfgstr)
    np.testing.assert_allclose(dists, o_dists, atol=1e-6, err_msg=cfgstr)
