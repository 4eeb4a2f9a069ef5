"""Ingest resume (partial-progress checkpointing) and streaming search."""

import numpy as np
import pytest

from better_search_rag_rust_tpu.config import (
    CorpusConfig,
    EncoderConfig,
    PipelineConfig,
    SearchConfig,
    StoreConfig,
)
from better_search_rag_rust_tpu.metrics import top_k_overlap
from better_search_rag_rust_tpu.ops import SearchEngine
from better_search_rag_rust_tpu.pipeline import Pipeline
from better_search_rag_rust_tpu.store import DeviceStore
from better_search_rag_rust_tpu.store.vectorstore import local_store_path
from better_search_rag_rust_tpu.utils.testing import mock_embeddings


@pytest.fixture()
def corpus(tmp_path):
    root = tmp_path / "src"
    root.mkdir()
    for i in range(20):
        (root / f"F{i:02d}.java").write_text(f"class F{i} {{ int v{i}; }}")
    return root


def _cfg(root, tmp_path, **kw):
    return PipelineConfig(
        corpus=CorpusConfig(root=str(root), extensions=("java",),
                            files_per_batch=4),
        encoder=EncoderConfig(backend="hash", dim=64, vocab_size=1024,
                              max_tokens=32, batch_size=4),
        store=StoreConfig(dir=str(tmp_path / "vstore")),
        search=SearchConfig(top_k=5, chunk_rows=128),
        **kw,
    )


def test_checkpoint_marker_written(corpus, tmp_path):
    cfg = _cfg(corpus, tmp_path, checkpoint_every_batches=2)
    p = Pipeline(cfg)
    stats = p.ingest_shard()
    assert stats.embeddings == 20
    import json

    marker = json.loads(
        local_store_path(cfg.store.dir, 0).with_suffix(".progress").read_text()
    )
    assert marker == {"files": 20, "rows": 20}


def test_resume_skips_done_files(corpus, tmp_path):
    """Simulate a crash after a mid-phase checkpoint: a resumed run embeds
    only the remaining files, and the shard equals a clean full run."""
    cfg = _cfg(corpus, tmp_path, checkpoint_every_batches=1)
    p = Pipeline(cfg)

    # Crash after 3 batches (12 files): run the loop manually via a limited
    # corpus view, then restore the full view and resume.
    partial_root = tmp_path / "partial"
    partial_root.mkdir()
    files = sorted((corpus).glob("*.java"))
    for f in files[:12]:
        (partial_root / f.name).write_text(f.read_text())
    p_partial = Pipeline(_cfg(partial_root, tmp_path, checkpoint_every_batches=1))
    p_partial.ingest_shard()
    import json

    marker = json.loads(
        local_store_path(cfg.store.dir, 0).with_suffix(".progress").read_text()
    )
    assert marker == {"files": 12, "rows": 12}

    resumed = Pipeline(_cfg(corpus, tmp_path, resume=True)).ingest_shard()
    assert resumed.files_read == 8  # only the remaining files were embedded
    assert resumed.embeddings == 20

    clean = Pipeline(_cfg(corpus, tmp_path / "clean")).ingest_shard()
    from better_search_rag_rust_tpu.store.vectorstore import local_store

    a = local_store(cfg.store.dir, 0, empty=False).matrix()
    b = local_store(str(tmp_path / "clean" / "vstore"), 0, empty=False).matrix()
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_resume_ignored_without_flag(corpus, tmp_path):
    cfg = _cfg(corpus, tmp_path)
    Pipeline(cfg).ingest_shard()
    stats = Pipeline(cfg).ingest_shard()  # re-run without resume: fresh
    assert stats.files_read == 20


def test_search_stream_matches_batch(mesh8):
    mat = mock_embeddings(300, dim=32, seed=41)
    store = DeviceStore.from_host(mat, mesh8, dtype="float32", chunk_rows=128)
    engine = SearchEngine(store, SearchConfig(kernel="global"))
    batches = [mat[0:8], mat[8:16], mat[16:24]]
    streamed = list(engine.search_stream(batches, k=6))
    assert len(streamed) == 3
    for i, (ids, dists) in enumerate(streamed):
        ref_ids, ref_d = engine.search(batches[i], k=6)
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_allclose(dists, ref_d, atol=1e-7)
    # exactness against the oracle as well
    o_ids, _ = engine.oracle_topk(batches[0], k=6)
    assert top_k_overlap(o_ids.tolist(), streamed[0][0].tolist(), 6) == 1.0


def test_search_stream_empty_and_ragged(mesh8):
    mat = mock_embeddings(64, dim=16, seed=43)
    store = DeviceStore.from_host(mat, mesh8, dtype="float32", chunk_rows=128)
    engine = SearchEngine(store, SearchConfig(kernel="global"))
    assert list(engine.search_stream([], k=3)) == []
    out = list(engine.search_stream([mat[:5], mat[5:6]], k=3))  # ragged shapes
    assert out[0][0].shape == (5, 3) and out[1][0].shape == (1, 3)
    assert out[1][0][0, 0] == 5


def test_resume_reconciles_crash_window(corpus, tmp_path):
    """Rows persisted past the last committed marker (a crash between
    store.persist() and the marker write) are truncated on resume — no
    duplicate rows can survive."""
    import json

    import numpy as np

    from better_search_rag_rust_tpu.store.vectorstore import local_store

    cfg = _cfg(corpus, tmp_path, checkpoint_every_batches=1)
    Pipeline(cfg).ingest_shard()

    # Simulate the crash window: roll the marker back to 8 files / 8 rows
    # while the store still holds all 20 rows.
    marker_path = local_store_path(cfg.store.dir, 0).with_suffix(".progress")
    marker_path.write_text(json.dumps({"files": 8, "rows": 8}))

    resumed = Pipeline(_cfg(corpus, tmp_path, resume=True)).ingest_shard()
    assert resumed.embeddings == 20  # no duplicates
    store = local_store(cfg.store.dir, 0, empty=False)
    assert store.count == 20
    clean = Pipeline(_cfg(corpus, tmp_path / "clean")).ingest_shard()
    ref = local_store(str(tmp_path / "clean" / "vstore"), 0, empty=False)
    np.testing.assert_allclose(store.matrix(), ref.matrix(), atol=1e-6)


def test_resume_with_corrupt_marker_restarts(corpus, tmp_path):
    cfg = _cfg(corpus, tmp_path)
    Pipeline(cfg).ingest_shard()
    marker_path = local_store_path(cfg.store.dir, 0).with_suffix(".progress")
    marker_path.write_text("garbage not json")
    resumed = Pipeline(_cfg(corpus, tmp_path, resume=True)).ingest_shard()
    assert resumed.embeddings == 20
    assert resumed.files_read == 20  # full restart


def test_packed_collect_bitexact(mesh8):
    """The single-readback packed buffer reproduces the two-transfer
    collect exactly. Ids travel VALUE-converted to f32 — NOT bitcast:
    small int32 bit patterns are f32 denormals, which accelerators may
    flush to zero in copies while CPU tests stay green."""
    mat = mock_embeddings(300, dim=32, seed=47)
    store = DeviceStore.from_host(mat, mesh8, dtype="float32", chunk_rows=128)
    engine = SearchEngine(store, SearchConfig(kernel="global"))
    qs = mat[:16]
    out = engine._dispatch(qs, 7)
    ids_u, dists_u = SearchEngine._collect(out)
    ids_p, dists_p = SearchEngine._collect(engine._pack(out))
    np.testing.assert_array_equal(ids_p, ids_u)
    np.testing.assert_array_equal(dists_p, dists_u)
    assert ids_p.dtype == np.int64


def test_pack_results_exact_to_f32_limit():
    """Value-converted ids are exact up to PACK_MAX_ROWS - 1, and stores
    at/above the limit skip packing entirely."""
    import jax.numpy as jnp

    from better_search_rag_rust_tpu.ops.engine import (
        PACK_MAX_ROWS, _pack_results,
    )

    ids = np.array(
        [[0, 1, 123, 8_388_607, 10_000_000, PACK_MAX_ROWS - 1]],
        dtype=np.int32,
    )
    vals = np.linspace(-1, 1, ids.size, dtype=np.float32).reshape(ids.shape)
    packed = np.asarray(_pack_results(jnp.asarray(vals), jnp.asarray(ids)))
    k = ids.shape[1]
    np.testing.assert_array_equal(packed[:, k:].astype(np.int64), ids)
    np.testing.assert_array_equal(packed[:, :k], vals)

    class FakeStore:
        num_rows = PACK_MAX_ROWS

    class FakeEngine:
        store = FakeStore()
        _pack = SearchEngine._pack

    out = ("vals", "ids")
    assert FakeEngine()._pack(out) is out  # passthrough, no packing


def test_search_stream_depths(mesh8):
    """Any in-flight depth yields identical results in input order."""
    mat = mock_embeddings(200, dim=32, seed=48)
    store = DeviceStore.from_host(mat, mesh8, dtype="float32", chunk_rows=128)
    engine = SearchEngine(store, SearchConfig(kernel="global"))
    batches = [mat[i * 8:(i + 1) * 8] for i in range(5)]
    want = [engine.search(b, k=4) for b in batches]
    for depth in (1, 3, 16):
        got = list(engine.search_stream(iter(batches), k=4, depth=depth))
        assert len(got) == 5
        for (gi, gd), (wi, wd) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gd, wd)
    import pytest

    with pytest.raises(ValueError):
        list(engine.search_stream(iter(batches), k=4, depth=0))


def test_search_stream_store_upload_exact(mesh8):
    """``upload="store"`` streams host-rounded store-dtype query bits (half
    the upload bytes on bf16 stores); results are exactly the oracle fed
    the SAME bits — including duplicates, ties and a zero query."""
    mat = mock_embeddings(300, dim=32, seed=44)
    mat[10] = mat[3]  # duplicate rows: ties must resolve to the lowest id
    mat[250] = mat[3]
    store = DeviceStore.from_host(mat, mesh8, dtype="bfloat16", chunk_rows=128)
    engine = SearchEngine(store, SearchConfig())
    assert engine.supports_store_upload()
    queries = np.concatenate([mat[:8], np.zeros((1, 32), np.float32)])
    (ids, dists), = engine.search_stream([queries], k=7, upload="store")
    o_ids, o_d = engine.oracle_topk(queries, k=7, upload="store")
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_allclose(dists, o_d, atol=1e-7)
    # the duplicate triple ranks id-ascending for the self-query
    assert list(ids[3, :3]) == [3, 10, 250]


def test_prepare_upload_queries_bits(mesh8):
    """The uploaded array is store-dtype, padded to the store's padded dim,
    and carries exactly one rounding of the host-normalized f32 queries."""
    mat = mock_embeddings(64, dim=24, seed=45)
    store = DeviceStore.from_host(mat, mesh8, dtype="bfloat16", chunk_rows=128)
    engine = SearchEngine(store, SearchConfig())
    q = mat[:4] * 3.7  # un-normalized on purpose
    qc = engine.prepare_upload_queries(q)
    assert qc.dtype == store.data.dtype
    assert qc.shape == (4, store.data.shape[1])
    norms = np.sqrt(np.sum(q * q, axis=-1, keepdims=True, dtype=np.float32))
    want = (q / norms).astype(store.data.dtype)
    np.testing.assert_array_equal(qc[:, :24], want)
    assert not qc[:, 24:].astype(np.float32).any()  # zero padding


def test_store_upload_f32_fallback(mesh8):
    """On f32 stores ``upload="store"`` buys nothing, so it falls back to
    the default path — results identical to plain search; bad values raise."""
    mat = mock_embeddings(100, dim=16, seed=46)
    store = DeviceStore.from_host(mat, mesh8, dtype="float32", chunk_rows=128)
    engine = SearchEngine(store, SearchConfig(kernel="global"))
    assert not engine.supports_store_upload()
    (ids, dists), = engine.search_stream([mat[:6]], k=5, upload="store")
    wi, wd = engine.search(mat[:6], k=5)
    np.testing.assert_array_equal(ids, wi)
    np.testing.assert_array_equal(dists, wd)
    with pytest.raises(ValueError):
        list(engine.search_stream([mat[:6]], k=5, upload="bf16"))


def test_ingest_failed_batch_log_and_continue(corpus, tmp_path):
    """A batch whose forward dies mid-pipeline is logged and skipped
    (reference: tasks.rs:118-124); every other batch's rows land, the
    row->path manifest stays aligned with the store, and stats count the
    failure — under the lag-1 dispatch/collect loop."""
    import json

    cfg = _cfg(corpus, tmp_path)
    p = Pipeline(cfg)
    real_collect = p.encoder.collect
    calls = {"n": 0}

    def flaky_collect(pending):
        calls["n"] += 1
        if calls["n"] == 2:  # second batch fails at collect time
            raise RuntimeError("injected device failure")
        return real_collect(pending)

    p.encoder.collect = flaky_collect
    stats = p.ingest_shard()
    assert stats.failed_batches == 1
    assert stats.embeddings == 16  # 20 files, one 4-file batch dropped
    paths = json.loads(
        local_store_path(cfg.store.dir, 0).with_suffix(".paths.json").read_text()
    )
    assert len(paths) == 16
    # rows and manifest agree batch-by-batch: re-encode each surviving
    # file and find it at its manifest position
    from better_search_rag_rust_tpu.store.vectorstore import local_store

    store = local_store(cfg.store.dir, 0, empty=False)
    assert store.count == 16
    emb = p.encoder.get_embeddings(
        [open(paths[4]).read()]
    )  # first file after the dropped batch
    np.testing.assert_array_equal(store.get(4), emb[0])


def test_ingest_failed_tokenize_batch(corpus, tmp_path):
    """A batch whose background read+tokenize raises is likewise skipped
    without derailing neighbors."""
    cfg = _cfg(corpus, tmp_path)
    p = Pipeline(cfg)
    real_tok = p.encoder.tokenize
    calls = {"n": 0}

    def flaky_tokenize(texts):
        calls["n"] += 1
        if calls["n"] == 3:
            raise ValueError("injected tokenizer failure")
        return real_tok(texts)

    p.encoder.tokenize = flaky_tokenize
    stats = p.ingest_shard()
    assert stats.failed_batches == 1
    assert stats.embeddings == 16


@pytest.mark.parametrize("depth", [1, 2, 4, 7])
def test_ingest_inflight_depth_same_shard(corpus, tmp_path, depth):
    """Deeper dispatch windows (CorpusConfig.inflight_batches) must change
    ONLY scheduling: on_batch stays strictly batch-ordered, so the shard,
    its row order, and the path manifest are identical to the depth-2
    double-buffer at every depth (incl. depth > number of batches)."""
    import dataclasses
    import json

    ref_cfg = _cfg(corpus, tmp_path)
    ref = Pipeline(ref_cfg)
    assert ref.ingest_shard().embeddings == 20
    ref_store = local_store_path(ref_cfg.store.dir, 0)
    ref_mat = np.load(ref_store)
    ref_paths = json.loads(ref_store.with_suffix(".paths.json").read_text())

    cfg = dataclasses.replace(
        ref_cfg,
        corpus=dataclasses.replace(ref_cfg.corpus, inflight_batches=depth),
        store=StoreConfig(dir=str(tmp_path / f"vstore_d{depth}")),
    )
    p = Pipeline(cfg)
    assert p.ingest_shard().embeddings == 20
    spath = local_store_path(cfg.store.dir, 0)
    mat = np.load(spath)
    np.testing.assert_array_equal(mat, ref_mat)
    assert json.loads(
        spath.with_suffix(".paths.json").read_text()) == ref_paths
