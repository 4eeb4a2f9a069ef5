"""Vector store tests (modeled on reference: src/vectorstore/polars.rs:249-395)."""

import numpy as np
import pytest

from better_search_rag_rust_tpu.store import (
    VectorStore,
    global_store,
    global_store_path,
    local_store,
    local_store_path,
    merge_vector_stores,
)
from better_search_rag_rust_tpu.utils.testing import DIMENSION, mock_embeddings


def test_append_and_count(tmp_path):
    s = VectorStore(tmp_path / "s.npy")
    assert s.count == 0
    s.append(np.ones(DIMENSION, dtype=np.float32))
    s.append_many(mock_embeddings(4, seed=1))
    assert s.count == 5


def test_get_roundtrip(tmp_path):
    s = VectorStore(tmp_path / "s.npy")
    vecs = mock_embeddings(3, dim=8, seed=2)
    s.append_many(vecs)
    np.testing.assert_array_equal(s.get(1), vecs[1])
    with pytest.raises(IndexError):
        s.get(3)


def test_get_many_slice(tmp_path):
    # reference: polars.rs:121-156 — contiguous slice reads
    s = VectorStore(tmp_path / "s.npy")
    vecs = mock_embeddings(10, dim=4, seed=3)
    s.append_many(vecs)
    np.testing.assert_array_equal(s.get_many((2, 5)), vecs[2:7])
    np.testing.assert_array_equal(s.get_many(None), vecs)
    with pytest.raises(IndexError):
        s.get_many((8, 5))


def test_persist_reload_roundtrip(tmp_path):
    # reference: polars.rs:337-351
    path = tmp_path / "sub" / "s.npy"
    s = VectorStore(path)
    vecs = mock_embeddings(7, dim=16, seed=4)
    s.append_many(vecs)
    s.persist()

    s2 = VectorStore(path, empty=False)
    assert s2.count == 7
    np.testing.assert_array_equal(s2.get_many(None), vecs)


def test_open_missing_creates_empty_file(tmp_path):
    # reference: polars.rs:50-77 — creates dirs + an empty store file on miss
    path = tmp_path / "deep" / "dir" / "s.npy"
    s = VectorStore(path, empty=False)
    assert s.count == 0
    assert path.exists()


def test_reload_empty_errors_unless_forced(tmp_path):
    # reference: polars.rs:171-181,353-365
    path = tmp_path / "s.npy"
    s = VectorStore(path)
    s.append_many(mock_embeddings(2, dim=4))
    with pytest.raises(IOError):
        s.reload(force=False)  # nothing persisted yet
    s.reload(force=True)
    assert s.count == 0


def test_reset(tmp_path):
    s = VectorStore(tmp_path / "s.npy")
    s.append_many(mock_embeddings(3, dim=4))
    s.reset()
    assert s.count == 0


def test_large_slice_reads(tmp_path):
    # reference: polars.rs:367-394 — 1000-row store slice reads
    s = VectorStore(tmp_path / "s.npy")
    vecs = mock_embeddings(1000, dim=32, seed=5)
    s.append_many(vecs)
    s.persist()
    s2 = VectorStore(s.path, empty=False)
    np.testing.assert_array_equal(s2.get_many((990, 10)), vecs[990:])


def test_shard_naming(tmp_path):
    # reference: src/mpi_helpers/vectorstore.rs:5-20
    assert local_store_path(tmp_path, 3).name == "rank_3.npy"
    assert global_store_path(tmp_path).name == "global.npy"


def test_merge_in_shard_order(tmp_path):
    """Merged rows must appear in shard order so local→global index
    translation stays valid (reference: src/mpi_helpers/tasks.rs:181-217)."""
    per_shard = [3, 2, 4]
    all_vecs = []
    for shard, n in enumerate(per_shard):
        vecs = mock_embeddings(n, dim=8, seed=10 + shard)
        st = local_store(tmp_path, shard)
        st.append_many(vecs)
        st.persist()
        all_vecs.append(vecs)
    merged = merge_vector_stores(3, tmp_path)
    np.testing.assert_array_equal(merged.get_many(None), np.concatenate(all_vecs))


def test_merge_skips_empty_and_missing_shards(tmp_path):
    # Present-but-empty shards merge as zero rows; a MISSING shard means a
    # crashed ingest host and fails the merge unless explicitly allowed
    # (tightened vs the reference's skip-and-log, tasks.rs:202-212).
    import pytest

    from better_search_rag_rust_tpu.store.vectorstore import partial_merge_marker

    st = local_store(tmp_path, 0)
    st.append_many(mock_embeddings(2, dim=8, seed=1))
    st.persist()
    empty = local_store(tmp_path, 1)
    empty.persist()  # shard 1 empty, shard 2 missing entirely
    with pytest.raises(FileNotFoundError):
        merge_vector_stores(3, tmp_path)
    merged = merge_vector_stores(3, tmp_path, allow_partial=True)
    assert merged.count == 2
    assert partial_merge_marker(tmp_path).exists()
    # A subsequent complete merge clears the marker.
    st2 = local_store(tmp_path, 2)
    st2.persist()
    merge_vector_stores(3, tmp_path)
    assert not partial_merge_marker(tmp_path).exists()


def test_persisted_file_readable_by_numpy(tmp_path):
    s = VectorStore(tmp_path / "s.npy")
    vecs = mock_embeddings(5, dim=8, seed=6)
    s.append_many(vecs)
    s.persist()
    mat = np.load(s.path)
    assert mat.dtype == np.float32 and mat.shape == (5, 8)
    np.testing.assert_array_equal(mat, vecs)


@pytest.mark.parametrize("content", [b"not a numpy file", "int64", "3-d"])
def test_corrupt_store_file_rejected_at_open(tmp_path, content):
    """A file that is not an [N, D] float32 matrix fails loudly at open
    instead of serving garbage rows."""
    path = tmp_path / "s.npy"
    if content == "int64":
        np.save(path, np.zeros((2, 3), dtype=np.int64))
    elif content == "3-d":
        np.save(path, np.zeros((2, 3, 4), dtype=np.float32))
    else:
        path.write_bytes(content)
    with pytest.raises(ValueError):
        VectorStore(path, empty=False)


def test_merge_does_not_fabricate_missing_shards(tmp_path):
    """A missing shard is logged and skipped without creating an empty
    store file on disk (a crashed ingest host must stay visibly missing)."""
    from better_search_rag_rust_tpu.store.vectorstore import (
        VectorStore,
        local_store_path,
        merge_vector_stores,
    )
    from better_search_rag_rust_tpu.utils.testing import mock_embeddings

    st = VectorStore(local_store_path(tmp_path, 0), empty=True)
    st.append_many(mock_embeddings(4, 16, seed=1))
    st.persist()
    # shard 1 missing entirely
    merged = merge_vector_stores(2, tmp_path, allow_partial=True)
    assert merged.count == 4
    assert not local_store_path(tmp_path, 1).exists()


def test_truncate(tmp_path):
    from better_search_rag_rust_tpu.store.vectorstore import VectorStore
    from better_search_rag_rust_tpu.utils.testing import mock_embeddings

    st = VectorStore(tmp_path / "t.npy", empty=True)
    mat = mock_embeddings(10, 8, seed=2)
    st.append_many(mat)
    st.truncate(6)
    assert st.count == 6
    np.testing.assert_array_equal(st.matrix(), mat[:6])
    st.truncate(100)  # no-op beyond count
    assert st.count == 6
    st.truncate(0)
    assert st.count == 0


def test_take_matrix_detaches_writable(tmp_path):
    """take_matrix hands over ONE writable consolidated matrix and leaves
    the store empty — update()'s in-place mutation surface without the
    transient 2x-store-size copy. File-backed chunks are mmap views
    (read-only); the handover must still be writable and
    mutations must not leak to disk until an explicit persist."""
    from better_search_rag_rust_tpu.store.vectorstore import (
        VectorStore,
    )

    path = tmp_path / "s.npy"
    s = VectorStore(path, empty=True)
    rows = np.arange(12, dtype=np.float32).reshape(4, 3)
    s.append_many(rows)
    s.persist()

    loaded = VectorStore(path, empty=False)
    mat = loaded.take_matrix()
    assert mat.flags.writeable
    np.testing.assert_array_equal(mat, rows)
    assert loaded.count == 0 and loaded.matrix().size == 0

    mat[0, 0] = 99.0  # in-place edit, then hand back + persist
    loaded.append_many(mat[:3])  # compaction keeps a leading slice
    loaded.persist()
    again = VectorStore(path, empty=False)
    assert again.count == 3
    assert again.get(0)[0] == 99.0

    # empty store: degenerate matrix, still detached
    empty = VectorStore(tmp_path / "e.npy", empty=True)
    m = empty.take_matrix()
    assert m.size == 0 and empty.count == 0
