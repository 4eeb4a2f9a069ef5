"""End-to-end pipeline tests: corpus -> embed -> shards -> merge -> device
store -> search -> accuracy, on the emulated 8-device mesh.

This is the coverage the reference never had: its distributed layer was only
validated by running the binary under mpiexec and eyeballing the report
(SURVEY.md §4). The full driver path here runs in-process in CI.
"""

import numpy as np
import pytest

from better_search_rag_rust_tpu.config import (
    CorpusConfig,
    EncoderConfig,
    PipelineConfig,
    SearchConfig,
    StoreConfig,
)
from better_search_rag_rust_tpu.pipeline import Pipeline
from better_search_rag_rust_tpu.store.vectorstore import global_store, local_store


@pytest.fixture()
def corpus_dir(tmp_path):
    """A small synthetic java corpus (≙ the reference's JabRef target,
    src/main.rs:38-39)."""
    root = tmp_path / "repo"
    (root / "a").mkdir(parents=True)
    (root / "b").mkdir()
    for i in range(7):
        (root / "a" / f"File{i}.java").write_text(
            f"public class File{i} {{ int field{i}; void method{i}() {{}} }}"
        )
    for i in range(5):
        (root / "b" / f"Util{i}.java").write_text(
            f"class Util{i} {{ static String helper{i}() {{ return \"x{i}\"; }} }}"
        )
    (root / "a" / "README.md").write_text("not java")
    (root / "b" / "script.py").write_text("print('not java')")
    return root


def _config(corpus_dir, tmp_path, **search_kw):
    return PipelineConfig(
        corpus=CorpusConfig(root=str(corpus_dir), extensions=("java",),
                            files_per_batch=4),
        encoder=EncoderConfig(backend="hash", dim=96, vocab_size=4096,
                              max_tokens=64, batch_size=4),
        store=StoreConfig(dir=str(tmp_path / "vstore")),
        search=SearchConfig(top_k=5, query_idx=0, chunk_rows=256,
                            **search_kw),
    )


def test_full_pipeline_self_retrieval(corpus_dir, tmp_path):
    """The reference's headline check: exact search retrieves the query row
    at rank 1 => MRR = Recall = overlap = 1.0
    (reference: src/main.rs:147-155)."""
    cfg = _config(corpus_dir, tmp_path)
    result = Pipeline(cfg).run()
    assert result.num_vectors == 12
    assert result.ingest.files_found == 12
    assert result.ingest.embeddings == 12
    assert result.top_k[0][0] == 0  # self-retrieval at rank 1
    assert result.top_k[0][1] < 1e-3  # ~zero cosine distance
    assert (result.mrr, result.recall, result.overlap) == (1.0, 1.0, 1.0)
    assert "BENCHMARK REPORT" in result.report
    assert "embedding_generation" in result.report


def test_pipeline_persists_shards_and_global(corpus_dir, tmp_path):
    cfg = _config(corpus_dir, tmp_path)
    p = Pipeline(cfg)
    stats = p.ingest_shard()
    assert stats.embeddings == 12
    count = p.merge()
    assert count == 12
    # rank_0.parquet + global.parquet on disk (reference:
    # src/mpi_helpers/vectorstore.rs:5-20)
    assert local_store(cfg.store.dir, 0, empty=False).count == 12
    assert global_store(cfg.store.dir, empty=False).count == 12


def test_skip_process_serves_from_persisted_store(corpus_dir, tmp_path):
    """SKIP_PROCESS mode: search runs from global.parquet without re-embedding
    (reference: src/main.rs:42-45, README.md:135)."""
    cfg = _config(corpus_dir, tmp_path)
    Pipeline(cfg).run()  # build
    serve_cfg = cfg.replace(skip_process=True)
    result = Pipeline(serve_cfg).run()
    assert result.ingest is None
    assert result.num_vectors == 12
    assert result.mrr == 1.0


def test_skip_process_without_store_errors(tmp_path):
    cfg = PipelineConfig(
        store=StoreConfig(dir=str(tmp_path / "nope")), skip_process=True
    )
    with pytest.raises(Exception):
        Pipeline(cfg).run()


def test_pipeline_engine_matches_oracle(corpus_dir, tmp_path):
    """top_k_overlap(serial oracle, engine) == 1.0 on real pipeline output."""
    from better_search_rag_rust_tpu.metrics.quality import top_k_overlap

    cfg = _config(corpus_dir, tmp_path)
    p = Pipeline(cfg)
    p.run()
    engine = p.engine()
    queries = engine.effective_store()[:4]
    par_ids, _ = engine.search(queries, k=5)
    ser_ids, _ = engine.oracle_topk(queries, k=5)
    assert top_k_overlap(ser_ids.tolist(), par_ids.tolist(), 5) == 1.0


def test_multi_shard_ingest_merge_order(corpus_dir, tmp_path):
    """Simulate a 3-host ingest on one host: shard stores merge in shard
    order, keeping global indices aligned with the sorted file list
    (reference: src/mpi_helpers/tasks.rs:181-217)."""
    cfg = _config(corpus_dir, tmp_path)
    p = Pipeline(cfg)
    all_stats = [p.ingest_shard(shard=s, num_shards=3) for s in range(3)]
    assert sum(s.embeddings for s in all_stats) == 12
    count = p.merge(num_shards=3)
    assert count == 12
    # Global row i must equal the single-shard embedding of file i: rebuild
    # with one shard into a second dir and compare matrices.
    cfg2 = _config(corpus_dir, tmp_path / "second")
    p2 = Pipeline(cfg2)
    p2.ingest_shard(shard=0, num_shards=1)
    p2.merge(num_shards=1)
    m1 = global_store(cfg.store.dir, empty=False).matrix()
    m2 = global_store(cfg2.store.dir, empty=False).matrix()
    np.testing.assert_allclose(m1, m2, atol=1e-6)


def test_unreadable_files_are_skipped(corpus_dir, tmp_path):
    """Oversized files skip without killing the shard
    (reference: src/source.rs:36-39, tasks.rs:95-116)."""
    big = corpus_dir / "a" / "Big.java"
    big.write_text("x" * (2 * 1024 * 1024))
    cfg = _config(corpus_dir, tmp_path)
    cfg = cfg.replace(
        corpus=CorpusConfig(
            root=str(corpus_dir), extensions=("java",),
            files_per_batch=4, max_file_bytes=1024 * 1024,
        )
    )
    result = Pipeline(cfg).run()
    assert result.ingest.files_skipped == 1
    assert result.num_vectors == 12


def test_cli_run_and_search(corpus_dir, tmp_path, capsys):
    from better_search_rag_rust_tpu.cli import main

    store_dir = str(tmp_path / "cli_store")
    rc = main([
        "run", "--root", str(corpus_dir), "--store-dir", store_dir,
        "--encoder-backend", "hash", "--dim", "64", "--max-tokens", "32",
        "--top-k", "3", "--encode-batch-size", "4",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "MRR=1.0000" in out
    assert "BENCHMARK REPORT" in out

    rc = main([
        "search", "--store-dir", store_dir, "--encoder-backend", "hash",
        "--dim", "64", "--top-k", "3",
    ])
    assert rc == 0
    assert "MRR=1.0000" in capsys.readouterr().out


def test_text_query_returns_paths(corpus_dir, tmp_path):
    """Free-text retrieval maps results back to source files via the row
    manifest written at ingest."""
    cfg = _config(corpus_dir, tmp_path)
    p = Pipeline(cfg)
    p.ingest_shard()
    p.merge()
    ranked = p.query(["public class File3 int field3 void method3"], k=3)[0]
    assert len(ranked) == 3
    paths = [r[0] for r in ranked]
    assert any(path.endswith("File3.java") for path in paths)
    assert paths[0].endswith(".java")
    # (path, row, distance) triples, distances ascending
    dists = [r[2] for r in ranked]
    assert dists == sorted(dists)


def test_text_query_without_manifest_degrades(corpus_dir, tmp_path):
    from better_search_rag_rust_tpu.store.vectorstore import manifest_path

    cfg = _config(corpus_dir, tmp_path)
    p = Pipeline(cfg)
    p.ingest_shard()
    p.merge()
    manifest_path(cfg.store.dir).unlink()
    ranked = Pipeline(cfg.replace(skip_process=True)).query(["class Util0"], k=2)[0]
    assert all(path.startswith("row:") for path, _i, _d in ranked)


def test_cli_text_query(corpus_dir, tmp_path, capsys):
    from better_search_rag_rust_tpu.cli import main

    store_dir = str(tmp_path / "q_store")
    rc = main([
        "run", "--root", str(corpus_dir), "--store-dir", store_dir,
        "--encoder-backend", "hash", "--dim", "64", "--max-tokens", "32",
        "--encode-batch-size", "4", "--query", "static String helper2",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Top-" in out and ".java" in out


def test_evaluate_batch_metrics(corpus_dir, tmp_path, capsys):
    cfg = _config(corpus_dir, tmp_path)
    p = Pipeline(cfg)
    p.run()
    report = p.evaluate(num_queries=8, k=5)
    assert report["mrr"] == 1.0
    assert report["recall_at_k"] == 1.0
    assert report["oracle_overlap"] == 1.0
    assert report["num_queries"] == 8.0

    from better_search_rag_rust_tpu.cli import main

    rc = main([
        "evaluate", "--store-dir", cfg.store.dir, "--encoder-backend", "hash",
        "--dim", "96", "--top-k", "5", "--num-queries", "6",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert '"oracle_overlap": 1.0' in out


def test_snapshot_serve_path(corpus_dir, tmp_path):
    """use_snapshot: first serve builds + writes the snapshot, second serve
    restores from it; results identical."""
    import dataclasses

    cfg = _config(corpus_dir, tmp_path)
    cfg = cfg.replace(store=dataclasses.replace(cfg.store, use_snapshot=True))
    r1 = Pipeline(cfg).run()
    assert (tmp_path / "vstore" / "device_cache" / "device_store.json").exists()
    r2 = Pipeline(cfg.replace(skip_process=True)).run()
    assert [i for i, _ in r2.top_k] == [i for i, _ in r1.top_k]
    assert r2.mrr == 1.0


def test_incremental_update(corpus_dir, tmp_path, capsys):
    """update embeds only files missing from the manifest and appends them;
    existing rows and their indices are untouched."""
    cfg = _config(corpus_dir, tmp_path)
    p = Pipeline(cfg)
    p.run()
    before = global_store(cfg.store.dir, empty=False).matrix().copy()

    # add two new files
    (corpus_dir / "a" / "New1.java").write_text("class New1 { int brand; }")
    (corpus_dir / "b" / "New2.java").write_text("class New2 { int fresh; }")

    p2 = Pipeline(cfg.replace(skip_process=True))
    stats = p2.update()
    assert stats.files_assigned == 2
    assert stats.embeddings == 2
    after = global_store(cfg.store.dir, empty=False).matrix()
    assert after.shape[0] == before.shape[0] + 2
    np.testing.assert_array_equal(after[: before.shape[0]], before)

    # the new file is retrievable by text and maps to its path
    ranked = p2.query(["class New1 int brand"], k=2)[0]
    assert any(path.endswith("New1.java") for path, _i, _d in ranked)

    # idempotent: nothing new on a second run
    stats2 = Pipeline(cfg.replace(skip_process=True)).update()
    assert stats2.files_assigned == 0

    # CLI surface
    from better_search_rag_rust_tpu.cli import main

    (corpus_dir / "a" / "New3.java").write_text("class New3 {}")
    rc = main([
        "update", "--root", str(corpus_dir), "--store-dir", cfg.store.dir,
        "--encoder-backend", "hash", "--dim", "96", "--max-tokens", "64",
        "--encode-batch-size", "4",
    ])
    assert rc == 0
    assert "appended 1 embeddings" in capsys.readouterr().out


def test_update_invalidates_cached_engine(corpus_dir, tmp_path):
    """An engine cached on the pipeline BEFORE update() must not serve the
    stale store afterwards (VERDICT r1: only host 0 invalidated before)."""
    cfg = _config(corpus_dir, tmp_path)
    p = Pipeline(cfg)
    p.run()
    stale = p.engine()
    rows_before = stale.store.num_rows

    (corpus_dir / "a" / "Hot1.java").write_text("class Hot1 { int unique; }")
    p.update()
    fresh = p.engine()
    assert fresh is not stale
    assert fresh.store.num_rows == rows_before + 1


def test_serving_refuses_partial_store(corpus_dir, tmp_path):
    """A global store published by an allow-partial merge must not serve
    silently: load refuses unless allow_partial_merge is set (and then
    warns)."""
    import pytest

    from better_search_rag_rust_tpu.store.vectorstore import (
        local_store_path,
        partial_merge_marker,
    )

    cfg = _config(corpus_dir, tmp_path)
    p = Pipeline(cfg)
    p.run()
    # Simulate a crashed second ingest host: merge expects 2 shards but
    # rank_1.parquet never appeared.
    assert local_store_path(cfg.store.dir, 0).exists()
    from better_search_rag_rust_tpu.store.vectorstore import merge_vector_stores

    merged = merge_vector_stores(2, cfg.store.dir, allow_partial=True)
    merged.persist()
    assert partial_merge_marker(cfg.store.dir).exists()

    with pytest.raises(RuntimeError, match="partial merge"):
        Pipeline(cfg.replace(skip_process=True)).load_device_store()
    # explicit opt-in serves (and logs a warning)
    Pipeline(
        cfg.replace(skip_process=True, allow_partial_merge=True)
    ).load_device_store()


def test_update_then_merge_refuses_without_force(corpus_dir, tmp_path):
    """update() appends rows that live in NO shard; a later merge would
    rebuild global.parquet from the stale shards and silently drop them.
    The global.ahead marker makes that loud (VERDICT r2 weak #6)."""
    import pytest

    from better_search_rag_rust_tpu.store.vectorstore import (
        global_ahead_marker,
        merge_vector_stores,
    )

    cfg = _config(corpus_dir, tmp_path)
    p = Pipeline(cfg)
    p.run()
    (corpus_dir / "a" / "Ahead1.java").write_text("class Ahead1 { int x; }")
    p2 = Pipeline(cfg.replace(skip_process=True))
    assert p2.update().embeddings == 1
    assert global_ahead_marker(cfg.store.dir).exists()
    rows_with_update = global_store(cfg.store.dir, empty=False).count

    # the trap from the verdict: update-then-run must NOT silently drop rows
    with pytest.raises(RuntimeError, match="AHEAD"):
        Pipeline(cfg).run()
    assert global_store(cfg.store.dir, empty=False).count == rows_with_update

    # a full re-ingest re-embeds the new file too, so force-merge is safe
    # here: the rebuilt global covers the corpus and the marker clears.
    p3 = Pipeline(cfg.replace(force_merge=True))
    result = p3.run()
    assert result.num_vectors == rows_with_update  # 13 files incl. Ahead1
    assert not global_ahead_marker(cfg.store.dir).exists()
    # direct API surface too
    merged = merge_vector_stores(1, cfg.store.dir, force=True)
    assert merged.count == rows_with_update


def test_encoder_meta_recorded_and_drift_warned(corpus_dir, tmp_path, caplog):
    """Ingest records the encoder numerics next to the store; a query-time
    encoder with different numerics warns instead of drifting silently
    (ADVICE r2: attention_impl/dtype changes move embeddings at bf16-noise
    level)."""
    from better_search_rag_rust_tpu.store.vectorstore import load_encoder_meta

    cfg = _config(corpus_dir, tmp_path)
    Pipeline(cfg).run()
    meta = load_encoder_meta(cfg.store.dir)
    assert meta is not None
    assert meta["backend"] == "hash"
    assert meta["dim"] == 96

    import logging

    # the package logger does not propagate (own stdout handler); let
    # caplog see it for the duration of this test
    logger = logging.getLogger("bsr")
    logger.propagate = True
    try:
        # same numerics: no warning
        with caplog.at_level(logging.INFO):
            Pipeline(cfg.replace(skip_process=True)).query(["class Util0"], k=2)
        assert "encoder numerics differ" not in caplog.text
        caplog.clear()

        # drifted numerics (different max_tokens): loud warning, still serves
        import dataclasses

        drifted = cfg.replace(
            skip_process=True,
            encoder=dataclasses.replace(cfg.encoder, max_tokens=32),
        )
        with caplog.at_level(logging.INFO):
            ranked = Pipeline(drifted).query(["class Util0"], k=2)[0]
        assert len(ranked) == 2
        assert "encoder numerics differ" in caplog.text
    finally:
        logger.propagate = False


def test_pipeline_local_encode_mesh(corpus_dir, tmp_path):
    """Multi-device hosts encode data-parallel over a local mesh: the nomic
    backend shards batches when batch_size divides the local device count
    (numerics records dp_devices); indivisible batch sizes fall back to one
    device; the hash backend ignores the mesh."""
    import dataclasses

    cfg = _config(corpus_dir, tmp_path)
    nomic_enc = dataclasses.replace(
        cfg.encoder, backend="nomic", dim=64, num_heads=4, max_tokens=32,
        batch_size=8,
    )
    pipe = Pipeline(dataclasses.replace(cfg, encoder=nomic_enc))
    assert pipe._local_encode_mesh() is not None  # 8 emulated devices
    assert pipe.encoder.numerics.get("dp_devices") == 8

    odd = dataclasses.replace(nomic_enc, batch_size=12)
    pipe_odd = Pipeline(dataclasses.replace(cfg, encoder=odd))
    assert pipe_odd._local_encode_mesh() is None
    assert "dp_devices" not in pipe_odd.encoder.numerics

    # hash backend: mesh offered but unused, contract unchanged
    hash_pipe = Pipeline(cfg)
    emb = hash_pipe.encoder.get_embeddings(["class A {}", "class B {}"])
    assert emb.shape == (2, 96)
    assert "dp_devices" not in hash_pipe.encoder.numerics


def test_update_reembeds_edited_files(corpus_dir, tmp_path):
    """An EDITED file's row is re-embedded IN PLACE: same global row index,
    new embedding, retrievable by its new content (VERDICT r2 weak #4 — the
    old update() served stale vectors for any modified file forever)."""
    cfg = _config(corpus_dir, tmp_path)
    p = Pipeline(cfg)
    p.run()
    before = global_store(cfg.store.dir, empty=False).matrix().copy()

    from better_search_rag_rust_tpu.store.vectorstore import load_manifest

    manifest = load_manifest(cfg.store.dir)
    target = str(corpus_dir / "a" / "File3.java")
    row = manifest.index(target)
    (corpus_dir / "a" / "File3.java").write_text(
        "public class File3 { String zanzibar; void completelyNew() {} }"
    )

    p2 = Pipeline(cfg.replace(skip_process=True))
    stats = p2.update()
    assert stats.rows_reembedded == 1
    assert stats.embeddings == 0  # nothing appended
    assert stats.rows_deleted == 0

    after = global_store(cfg.store.dir, empty=False).matrix()
    assert after.shape == before.shape  # in-place, no index shift
    assert not np.array_equal(after[row], before[row])
    mask = np.ones(before.shape[0], dtype=bool)
    mask[row] = False
    np.testing.assert_array_equal(after[mask], before[mask])

    # the new content retrieves the SAME row
    ranked = p2.query(["class File3 String zanzibar completelyNew"], k=2)[0]
    assert ranked[0][0].endswith("File3.java")
    assert ranked[0][1] == row

    # idempotent: a second update sees nothing to do
    stats2 = Pipeline(cfg.replace(skip_process=True)).update()
    assert (stats2.rows_reembedded, stats2.embeddings, stats2.rows_deleted) \
        == (0, 0, 0)


def test_update_compacts_deleted_files(corpus_dir, tmp_path):
    """A DELETED file's row is compacted away: it stops being returned, later
    rows shift down, and the manifest stays row-aligned."""
    cfg = _config(corpus_dir, tmp_path)
    p = Pipeline(cfg)
    p.run()
    n_before = global_store(cfg.store.dir, empty=False).count

    from better_search_rag_rust_tpu.store.vectorstore import (
        load_attrs,
        load_manifest,
    )

    gone = corpus_dir / "a" / "File2.java"
    gone_str = str(gone)
    gone.unlink()

    p2 = Pipeline(cfg.replace(skip_process=True))
    stats = p2.update()
    assert stats.rows_deleted == 1
    assert stats.embeddings == 0

    manifest = load_manifest(cfg.store.dir)
    attrs = load_attrs(cfg.store.dir)
    assert gone_str not in manifest
    assert len(manifest) == len(attrs) == n_before - 1
    assert global_store(cfg.store.dir, empty=False).count == n_before - 1

    # the deleted file is never returned; every returned path still exists
    ranked = p2.query(["class File2 field2 method2"], k=n_before - 1)[0]
    returned = {path for path, _i, _d in ranked}
    assert gone_str not in returned


def test_update_touch_only_refreshes_identity(corpus_dir, tmp_path):
    """A touched-but-identical file (new mtime, same content) is NOT
    re-embedded — the fingerprint check stops at identity refresh, and the
    global store bytes are untouched."""
    import os

    cfg = _config(corpus_dir, tmp_path)
    Pipeline(cfg).run()
    from better_search_rag_rust_tpu.store.vectorstore import global_store_path

    gpath = global_store_path(cfg.store.dir)
    mtime_before = gpath.stat().st_mtime_ns

    f = corpus_dir / "b" / "Util1.java"
    st = f.stat()
    os.utime(f, ns=(st.st_atime_ns, st.st_mtime_ns + 5_000_000_000))

    stats = Pipeline(cfg.replace(skip_process=True)).update()
    assert (stats.rows_reembedded, stats.embeddings, stats.rows_deleted) \
        == (0, 0, 0)
    assert gpath.stat().st_mtime_ns == mtime_before  # store not rewritten

    # identity refreshed: the next update's stat fast path is quiet again
    stats2 = Pipeline(cfg.replace(skip_process=True)).update()
    assert stats2.files_read == 0  # no content read at all


def test_update_combined_add_edit_delete(corpus_dir, tmp_path):
    """One update() handling add + edit + delete together keeps the
    manifest/store row-aligned and end-to-end retrieval correct."""
    cfg = _config(corpus_dir, tmp_path)
    p = Pipeline(cfg)
    p.run()
    n_before = global_store(cfg.store.dir, empty=False).count

    (corpus_dir / "b" / "Util4.java").unlink()
    (corpus_dir / "a" / "File5.java").write_text(
        "public class File5 { int quetzalcoatl; }"
    )
    (corpus_dir / "a" / "Brand.java").write_text(
        "class Brand { double sparkling; }"
    )

    p2 = Pipeline(cfg.replace(skip_process=True))
    stats = p2.update()
    assert stats.rows_deleted == 1
    assert stats.rows_reembedded == 1
    assert stats.embeddings == 1
    assert global_store(cfg.store.dir, empty=False).count == n_before

    ranked = p2.query(["class File5 int quetzalcoatl"], k=2)[0]
    assert ranked[0][0].endswith("File5.java")
    ranked = p2.query(["class Brand double sparkling"], k=2)[0]
    assert ranked[0][0].endswith("Brand.java")

    from better_search_rag_rust_tpu.store.vectorstore import (
        load_attrs,
        load_manifest,
    )

    manifest = load_manifest(cfg.store.dir)
    attrs = load_attrs(cfg.store.dir)
    assert len(manifest) == len(attrs) == n_before
    assert str(corpus_dir / "b" / "Util4.java") not in manifest
    assert manifest[-1].endswith("Brand.java")


def test_long_doc_mean_recovers_late_content_retrieval(tmp_path):
    """RETRIEVAL evidence for --long-doc mean (VERDICT r2 weak #5): with
    documents whose discriminative content sits PAST the truncation point,
    truncate-mode retrieval cannot find the right file (all truncated
    embeddings are identical), while mean-windowing ranks it first. The
    reference can only truncate (silent drop at src/llm/hf.rs:62-67)."""
    import dataclasses

    root = tmp_path / "corpus"
    root.mkdir()
    # Identical filler that fills the whole 64-token window; each file's
    # distinguishing term appears ONLY after the truncation point.
    filler = " ".join(f"common{i % 7}" for i in range(80))
    terms = ["zanzibar", "quetzal", "obsidian", "palimpsest"]
    for i, term in enumerate(terms):
        (root / f"Doc{i}.java").write_text(f"{filler} {term} {term} {term}")

    def build(long_doc, store):
        cfg = PipelineConfig(
            corpus=CorpusConfig(root=str(root), extensions=("java",),
                                files_per_batch=4),
            encoder=EncoderConfig(backend="hash", dim=96, vocab_size=4096,
                                  max_tokens=64, batch_size=4,
                                  long_doc=long_doc),
            store=StoreConfig(dir=str(tmp_path / store)),
            search=SearchConfig(top_k=4, query_idx=0, chunk_rows=256),
        )
        p = Pipeline(cfg)
        p.ingest_shard()
        p.merge()
        return p

    p_trunc = build("truncate", "vs_trunc")
    p_mean = build("mean", "vs_mean")

    hits_trunc = hits_mean = 0
    for i, term in enumerate(terms):
        query = f"{term} {term} {term}"
        top_t = p_trunc.query([query], k=1)[0][0]
        top_m = p_mean.query([query], k=1)[0][0]
        hits_trunc += top_t[0].endswith(f"Doc{i}.java")
        hits_mean += top_m[0].endswith(f"Doc{i}.java")

    # truncate: every embedding is the identical filler head -> ties, the
    # lowest row wins regardless of the query; it cannot hit all 4.
    assert hits_trunc <= 1
    # mean windowing: the late window carries the term -> recall@1 = 1.0.
    assert hits_mean == len(terms)


def test_update_pre_attrs_store_is_append_only(corpus_dir, tmp_path):
    """Stores built before the identity sidecar existed (no
    manifest.attrs.json) must stay APPEND-ONLY under update(): edits are
    undetectable (loudly logged), deletions of known rows still compact
    (path absence needs no identity), new files still append."""
    from better_search_rag_rust_tpu.store.vectorstore import attrs_path

    cfg = _config(corpus_dir, tmp_path)
    p = Pipeline(cfg)
    p.run()
    # simulate a pre-identity store
    attrs_path(cfg.store.dir).unlink()
    before = global_store(cfg.store.dir, empty=False).matrix().copy()

    (corpus_dir / "a" / "File1.java").write_text(
        "public class File1 { int totallyChanged; }"
    )
    (corpus_dir / "a" / "Novel.java").write_text("class Novel { int q; }")

    # (the "no recorded file identity" warning is logged via the bsr
    # logger, which does not propagate to pytest's capture — the behavior
    # asserts below are the contract)
    stats = Pipeline(cfg.replace(skip_process=True)).update()
    assert stats.rows_reembedded == 0  # edit invisible without identity
    assert stats.embeddings == 1       # new file appended
    after = global_store(cfg.store.dir, empty=False).matrix()
    assert after.shape[0] == before.shape[0] + 1
    np.testing.assert_array_equal(after[: before.shape[0]], before)


def test_snapshot_invalidated_by_edit_in_place_update(corpus_dir, tmp_path):
    """An edit-in-place update keeps the parquet's row count AND byte size
    identical (PLAIN encoding, same rows) — the device snapshot's source
    identity must still notice (mtime_ns) and rebuild, not serve the stale
    vectors."""
    import dataclasses

    cfg = _config(corpus_dir, tmp_path)
    cfg = cfg.replace(store=dataclasses.replace(cfg.store, use_snapshot=True))
    Pipeline(cfg).run()  # builds store + snapshot

    from better_search_rag_rust_tpu.store.vectorstore import (
        global_store_path,
        load_manifest,
    )

    target = str(corpus_dir / "a" / "File4.java")
    row = load_manifest(cfg.store.dir).index(target)
    # same-length edit => identical parquet byte size after rewrite
    (corpus_dir / "a" / "File4.java").write_text(
        f"public class File4 {{ int qqqqq4; void zzzzzz4() {{}} }}"
    )
    size_before = global_store_path(cfg.store.dir).stat().st_size
    stats = Pipeline(cfg.replace(skip_process=True)).update()
    assert stats.rows_reembedded == 1
    assert global_store_path(cfg.store.dir).stat().st_size == size_before

    p2 = Pipeline(cfg.replace(skip_process=True))
    ranked = p2.query(["class File4 int qqqqq4 zzzzzz4"], k=2)[0]
    assert ranked[0][0].endswith("File4.java")
    assert ranked[0][1] == row


def test_update_refuses_to_wipe_on_empty_enumeration(corpus_dir, tmp_path):
    """An empty corpus enumeration against a populated store (unmounted
    root, config typo) must REFUSE, not compact every row away (review
    finding: the compaction path would silently wipe hours of embed work)."""
    import shutil

    cfg = _config(corpus_dir, tmp_path)
    Pipeline(cfg).run()
    n = global_store(cfg.store.dir, empty=False).count
    shutil.rmtree(corpus_dir)  # the "unmounted/missing root" scenario

    with pytest.raises(RuntimeError, match="refusing to compact"):
        Pipeline(cfg.replace(skip_process=True)).update()
    assert global_store(cfg.store.dir, empty=False).count == n


def test_update_deletes_row_for_file_truncated_to_empty(corpus_dir, tmp_path):
    """A file truncated to EMPTY must lose its row (ingest never stores
    empty files) — not stay classified 'edited' forever while serving the
    stale embedding (review finding: the pipeline's empty-content filter
    would silently drop the re-embed)."""
    cfg = _config(corpus_dir, tmp_path)
    Pipeline(cfg).run()
    n = global_store(cfg.store.dir, empty=False).count

    target = corpus_dir / "b" / "Util2.java"
    target.write_text("")

    p2 = Pipeline(cfg.replace(skip_process=True))
    stats = p2.update()
    assert stats.rows_deleted == 1
    assert stats.rows_reembedded == 0
    assert global_store(cfg.store.dir, empty=False).count == n - 1

    from better_search_rag_rust_tpu.store.vectorstore import load_manifest

    assert str(target) not in load_manifest(cfg.store.dir)

    # converged: a second update sees nothing to do
    stats2 = Pipeline(cfg.replace(skip_process=True)).update()
    assert (stats2.rows_deleted, stats2.rows_reembedded,
            stats2.embeddings) == (0, 0, 0)


def test_update_commit_marker_detects_torn_store(corpus_dir, tmp_path):
    """A crash between update()'s three atomic renames leaves e.g. a NEW
    parquet paired with an OLD manifest — row-shifted paths the length
    check alone cannot catch (same-length manifests slip through). The
    update-commit marker (written LAST, the commit point) binds the triple;
    update() and query() must refuse the torn state, and a full rebuild
    re-baselines it."""
    import json

    from better_search_rag_rust_tpu.store.vectorstore import (
        load_manifest,
        manifest_path,
        update_commit_path,
    )

    cfg = _config(corpus_dir, tmp_path)
    Pipeline(cfg).run()
    assert update_commit_path(cfg.store.dir).exists()  # baselined at merge

    # Simulate the torn state: manifest content changed (same LENGTH —
    # a reversed row order) without the marker being rewritten.
    manifest = load_manifest(cfg.store.dir)
    manifest_path(cfg.store.dir).write_text(json.dumps(manifest[::-1]))

    with pytest.raises(RuntimeError, match="torn"):
        Pipeline(cfg.replace(skip_process=True)).update()
    with pytest.raises(RuntimeError, match="torn"):
        Pipeline(cfg.replace(skip_process=True)).query(["class Util0"], k=2)

    # Recovery: a full ingest+merge rewrites the triple and re-baselines.
    rebuilt = Pipeline(cfg)
    rebuilt.ingest_shard()
    rebuilt.merge()
    ranked = Pipeline(cfg.replace(skip_process=True)).query(
        ["class Util0 static String helper0"], k=2
    )[0]
    assert ranked[0][0].endswith("Util0.java")


def test_update_identity_survives_reembed_stat_failure(
    corpus_dir, tmp_path, monkeypatch
):
    """If the pipelined re-embed's own stat fails (file_attr -> None) for an
    EDITED row, update must fall back to the classification-time identity
    instead of erasing it — otherwise a just-re-embedded row is permanently
    demoted to the never-edit-detected pre-attrs class (ADVICE r3)."""
    import json

    from better_search_rag_rust_tpu.corpus import walker
    from better_search_rag_rust_tpu.store.vectorstore import (
        attrs_path,
        load_manifest,
    )

    cfg = _config(corpus_dir, tmp_path)
    Pipeline(cfg).run()

    edited = corpus_dir / "a" / "File1.java"
    edited.write_text("public class File1 { int totallyChanged; }")

    monkeypatch.setattr(walker, "file_attr", lambda st, content: None)
    stats = Pipeline(cfg.replace(skip_process=True)).update()
    assert stats.rows_reembedded == 1
    monkeypatch.undo()

    manifest = load_manifest(cfg.store.dir)
    attrs = json.loads(attrs_path(cfg.store.dir).read_text())
    row = manifest.index(str(edited))
    assert attrs[row] is not None  # classification-time identity kept

    # and the row is NOT re-embedded again: identity matches on disk
    stats2 = Pipeline(cfg.replace(skip_process=True)).update()
    assert (stats2.rows_reembedded, stats2.embeddings) == (0, 0)


def test_update_commit_survives_store_copy_restore(corpus_dir, tmp_path):
    """A byte-identical rewrite of global.parquet (backup restore, image
    layer — new mtime, same content) must NOT brick the store: the
    sampled content fingerprint accepts it. A content change that keeps
    the byte LENGTH (the case size/row-count checks cannot see) is
    refused as torn here because this store is small enough (< 512 KB)
    that ``_store_sample_sha`` hashes it WHOLE; for larger stores
    same-size detection is probabilistic (see the fingerprint docstring —
    row-shifting edits always change size/EOF and are always caught)."""
    from better_search_rag_rust_tpu.store.vectorstore import (
        global_store_path,
    )

    cfg = _config(corpus_dir, tmp_path)
    Pipeline(cfg).run()

    g = global_store_path(cfg.store.dir)
    data = bytearray(g.read_bytes())
    g.write_bytes(bytes(data))  # same bytes, fresh mtime

    ranked = Pipeline(cfg.replace(skip_process=True)).query(
        ["class Util0 static String helper0"], k=2
    )[0]
    assert ranked[0][0].endswith("Util0.java")
    stats = Pipeline(cfg.replace(skip_process=True)).update()
    assert (stats.rows_deleted, stats.embeddings) == (0, 0)

    # same-length content divergence: flip bytes mid-file (a data page —
    # the parquet stays readable, size and row count unchanged)
    mid = len(data) // 2
    data[mid: mid + 16] = bytes(16)
    g.write_bytes(bytes(data))
    with pytest.raises(RuntimeError, match="torn"):
        Pipeline(cfg.replace(skip_process=True)).update()
    with pytest.raises(RuntimeError, match="torn"):
        Pipeline(cfg.replace(skip_process=True)).query(["class Util0"], k=2)
