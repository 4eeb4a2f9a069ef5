"""Sliced store-file reads, sharded device-store loading, Matryoshka truncation."""

import numpy as np
import pytest

from better_search_rag_rust_tpu.config import SearchConfig
from better_search_rag_rust_tpu.ops import SearchEngine
from better_search_rag_rust_tpu.store import DeviceStore
from better_search_rag_rust_tpu.store.vectorstore import (
    VectorStore,
    store_row_count,
    read_matrix_slice,
)
from better_search_rag_rust_tpu.utils.testing import mock_embeddings


@pytest.fixture()
def parquet_store(tmp_path):
    path = tmp_path / "global.npy"
    mat = mock_embeddings(257, dim=48, seed=31)
    st = VectorStore(path, empty=True)
    st.append_many(mat)
    st.persist()
    return path, mat


def test_parquet_row_count_metadata_only(parquet_store, tmp_path):
    path, mat = parquet_store
    assert store_row_count(path) == 257
    assert store_row_count(tmp_path / "missing.npy") == 0


def test_read_matrix_slice(parquet_store):
    path, mat = parquet_store
    np.testing.assert_allclose(read_matrix_slice(path, 0, 257), mat)
    np.testing.assert_allclose(read_matrix_slice(path, 100, 57), mat[100:157])
    np.testing.assert_allclose(read_matrix_slice(path, 256, 1), mat[256:257])
    assert read_matrix_slice(path, 0, 0).size == 0
    with pytest.raises(IndexError):
        read_matrix_slice(path, 250, 100)


def test_from_parquet_sharded_matches_from_host(parquet_store, mesh8):
    path, mat = parquet_store
    a = DeviceStore.from_host(mat, mesh8, dtype="float32", chunk_rows=64)
    b = DeviceStore.from_file_sharded(
        path, mesh8, dtype="float32", chunk_rows=64
    )
    assert (a.num_rows, a.dim) == (b.num_rows, b.dim)
    np.testing.assert_allclose(
        a.effective_matrix(), b.effective_matrix(), atol=1e-6
    )
    # search parity
    qs = mock_embeddings(4, dim=48, seed=32)
    ia, da = SearchEngine(a, SearchConfig(kernel="global")).search(qs, 7)
    ib, db = SearchEngine(b, SearchConfig(kernel="global")).search(qs, 7)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(da, db, atol=1e-6)


def test_matryoshka_store_truncation(mesh8):
    mat = mock_embeddings(200, dim=64, seed=33)
    store = DeviceStore.from_host(
        mat, mesh8, dtype="float32", chunk_rows=64, matryoshka_dim=32
    )
    assert store.dim == 32
    assert store.matryoshka_from == 64
    engine = SearchEngine(store, SearchConfig(kernel="global"))
    # full-dim queries are truncated symmetrically
    ids, dists = engine.search(mat[:3], k=5)
    assert ids[0, 0] == 0 and ids[1, 0] == 1 and ids[2, 0] == 2
    # truncated search == search over host-truncated+renormalized rows
    ref_store = DeviceStore.from_host(
        np.ascontiguousarray(mat[:, :32]), mesh8, dtype="float32",
        chunk_rows=64,
    )
    ref_ids, ref_d = SearchEngine(
        ref_store, SearchConfig(kernel="global")
    ).search(np.ascontiguousarray(mat[:3, :32]), k=5)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(dists, ref_d, atol=1e-6)


def test_matryoshka_sharded_loader(parquet_store, mesh8):
    path, mat = parquet_store
    store = DeviceStore.from_file_sharded(
        path, mesh8, dtype="float32", chunk_rows=64, matryoshka_dim=16
    )
    assert store.dim == 16 and store.matryoshka_from == 48
    engine = SearchEngine(store, SearchConfig(kernel="global"))
    ids, _ = engine.search(mat[5], k=3)  # full-dim query auto-truncates
    assert ids[0, 0] == 5


def test_profiling_utils_smoke(tmp_path):
    import jax.numpy as jnp

    from better_search_rag_rust_tpu.utils.profiling import (
        annotate,
        device_trace,
        memory_stats,
    )

    with device_trace(str(tmp_path / "trace")):
        with annotate("phase"):
            _ = jnp.ones((8, 8)) @ jnp.ones((8, 8))
    assert (tmp_path / "trace").exists()
    assert isinstance(memory_stats(), dict)


def test_device_store_snapshot_roundtrip(tmp_path, mesh8, dtype="bfloat16"):
    from better_search_rag_rust_tpu.store.device_cache import (
        load_device_store,
        save_device_store,
        snapshot_exists,
    )

    mat = mock_embeddings(300, dim=40, seed=71)
    store = DeviceStore.from_host(mat, mesh8, dtype=dtype, chunk_rows=128)
    cache = tmp_path / "snap"
    assert not snapshot_exists(cache)
    save_device_store(cache, store)
    assert snapshot_exists(cache)

    restored = load_device_store(cache, mesh8)
    assert restored.data.dtype == store.data.dtype
    assert restored.num_rows == 300 and restored.dim == 40
    assert restored.chunk == store.chunk
    np.testing.assert_array_equal(
        store.effective_matrix(), restored.effective_matrix()
    )
    # search parity on the restored store
    q = mock_embeddings(3, dim=40, seed=72)
    ia, _ = SearchEngine(store, SearchConfig(kernel="global")).search(q, 7)
    ib, _ = SearchEngine(restored, SearchConfig(kernel="global")).search(q, 7)
    np.testing.assert_array_equal(ia, ib)


def test_device_store_snapshot_roundtrip_int8(tmp_path, mesh8):
    """int8 lattice rows survive the snapshot bit-for-bit too."""
    test_device_store_snapshot_roundtrip(tmp_path, mesh8, dtype="int8")


def test_device_store_snapshot_reshard(tmp_path, mesh8, mesh1):
    """Snapshot written on an 8-way mesh restores onto a 1-device mesh
    (serve-on-M-hosts lifecycle)."""
    from better_search_rag_rust_tpu.store.device_cache import (
        load_device_store,
        save_device_store,
    )

    mat = mock_embeddings(128, dim=24, seed=73)
    store = DeviceStore.from_host(mat, mesh8, dtype="float32", chunk_rows=128)
    cache = tmp_path / "snap"
    save_device_store(cache, store)
    restored = load_device_store(cache, mesh1)
    np.testing.assert_allclose(
        store.effective_matrix(), restored.effective_matrix(), atol=1e-6
    )


def test_snapshot_reshard_fixes_chunk(tmp_path, mesh1, mesh8):
    """Resharding a snapshot onto MORE shards must keep chunk dividing
    per-device rows (scan kernels require it)."""
    from better_search_rag_rust_tpu.store.device_cache import (
        load_device_store,
        save_device_store,
    )

    mat = mock_embeddings(256, dim=16, seed=81)
    store = DeviceStore.from_host(mat, mesh1, dtype="float32", chunk_rows=256)
    assert store.chunk == 256
    cache = tmp_path / "snap"
    save_device_store(cache, store)
    restored = load_device_store(cache, mesh8)  # per_dev = 32 < chunk
    assert restored.per_device_rows % restored.chunk == 0
    ids, _ = SearchEngine(restored, SearchConfig(kernel="scan")).search(
        mat[:2], k=5
    )
    o_ids, _ = SearchEngine(restored, SearchConfig(kernel="scan")).oracle_topk(
        mat[:2], k=5
    )
    np.testing.assert_array_equal(ids, o_ids)


def test_snapshot_dtype_mismatch_falls_back(tmp_path):
    """Requesting a different --store-dtype than the snapshot was built with
    must fall back to the store file (scores are per-dtype)."""
    import dataclasses

    from better_search_rag_rust_tpu.config import (
        CorpusConfig,
        EncoderConfig,
        PipelineConfig,
        SearchConfig,
        StoreConfig,
    )
    from better_search_rag_rust_tpu.pipeline import Pipeline

    root = tmp_path / "src"
    root.mkdir()
    for i in range(6):
        (root / f"F{i}.java").write_text(f"class F{i} {{ int x{i}; }}")
    cfg = PipelineConfig(
        corpus=CorpusConfig(root=str(root), extensions=("java",),
                            files_per_batch=4),
        encoder=EncoderConfig(backend="hash", dim=64, vocab_size=1024,
                              max_tokens=32, batch_size=4),
        store=StoreConfig(dir=str(tmp_path / "vs"), use_snapshot=True),
        search=SearchConfig(top_k=3, store_dtype="bfloat16"),
    )
    Pipeline(cfg).run()  # writes a bf16 snapshot
    f32_cfg = cfg.replace(
        skip_process=True,
        search=dataclasses.replace(cfg.search, store_dtype="float32"),
    )
    p = Pipeline(f32_cfg)
    store = p.load_device_store()
    assert str(store.data.dtype) == "float32"  # store file, not snapshot
