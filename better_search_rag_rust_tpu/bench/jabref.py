"""JabRef-corpus benchmark: the reference's actual experiment, end to end.

The reference's paper benchmark is: JabRef's ~2,305 Java files, embedded with
nomic-embed-text-v1.5, then a self-retrieval top-k search, timed per MPI rank
for N = 1..24 on a c6i.24xlarge (reference: README.md:155-166,
src/main.rs:38-39). No absolute numbers were published (BASELINE.md), so this
suite measures all three BASELINE.json configs on our side:

  1. ``serial``      — single-thread-style NumPy scan over the real built
                       store (matmul + argpartition), the sequential anchor.
  2. ``search_only`` — SKIP_PROCESS=true analogue: serve search straight from
                       the persisted global.npy.
  3. ``pipeline``    — the full ingest -> merge -> search driver, with the
                       measured sequential scan wired into
                       ``generate_report``'s speedup hook
                       (reference: src/mpi_helpers/benchmark.rs:361-416).

Zero-egress environment: the real JabRef checkout and the real nomic
checkpoint are not downloadable here, so the corpus is a deterministic
synthetic Java tree of the same shape (2,305 files, JabRef-like size
distribution) and the encoder falls back to the hash backend unless
``checkpoint_dir`` points at a real export — the result JSON labels which
encoder produced the embeddings. Search-side numbers (q/s, recall, speedup)
are encoder-independent: they measure the same [N, 768] store math either
way.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Optional

import numpy as np

JABREF_FILES = 2305  # reference: README.md:159


_WORDS = (
    "entry database citation bib field author title year journal editor "
    "crossref groups preferences importer exporter fetcher layout cleanup "
    "formatter util logic model gui action dialog table view preview "
    "undo redo event listener optional string integer boolean list map"
).split()


def synthesize_jabref_corpus(
    root: str | os.PathLike, files: int = JABREF_FILES, seed: int = 0
) -> Path:
    """Deterministic Java tree of ``files`` files with a JabRef-like layout
    (nested org/jabref packages) and size profile (lognormal around ~4 KB,
    capped at 64 KB). Idempotent: reuses the tree when already complete."""
    root = Path(root)
    marker = root / ".complete"
    if marker.exists() and marker.read_text() == f"{files}:{seed}":
        return root
    rng = np.random.default_rng(seed)
    packages = [
        "org/jabref/model/entry", "org/jabref/model/database",
        "org/jabref/logic/importer", "org/jabref/logic/exporter",
        "org/jabref/logic/citation", "org/jabref/logic/util",
        "org/jabref/gui/maintable", "org/jabref/gui/preferences",
        "org/jabref/gui/edit", "org/jabref/preferences",
    ]
    for i in range(files):
        pkg = packages[int(rng.integers(0, len(packages)))]
        d = root / pkg
        d.mkdir(parents=True, exist_ok=True)
        size = int(min(np.exp(rng.normal(8.2, 0.8)), 65536))
        name = f"Class{i:04d}"
        body = []
        while sum(len(b) for b in body) < size:
            method = rng.choice(_WORDS) + rng.choice(_WORDS).capitalize()
            words = " ".join(
                rng.choice(_WORDS) for _ in range(int(rng.integers(4, 14)))
            )
            body.append(
                f"    public void {method}{len(body)}() {{\n"
                f"        // {words}\n"
                f"        this.{rng.choice(_WORDS)} = \"{words}\";\n    }}\n"
            )
        (d / f"{name}.java").write_text(
            f"package {pkg.replace('/', '.')};\n\n"
            f"public class {name} {{\n" + "".join(body) + "}\n"
        )
    marker.write_text(f"{files}:{seed}")
    return root


def _serial_scan_qps(store_mat: np.ndarray, queries: np.ndarray,
                     k: int) -> tuple[float, float]:
    """(queries/sec, elapsed_s) of the sequential NumPy scan over the REAL
    store — the reference's 1-rank anchor (src/mpi_helpers/metrics.rs:16-53),
    strengthened to argpartition."""
    t0 = time.perf_counter()
    sims = queries @ store_mat.T
    kk = min(k, store_mat.shape[0])
    part = np.argpartition(-sims, kk - 1, axis=1)[:, :kk]
    part_sims = np.take_along_axis(sims, part, axis=1)
    order = np.argsort(-part_sims, axis=1, kind="stable")
    np.take_along_axis(part, order, axis=1).copy()
    dt = time.perf_counter() - t0
    return queries.shape[0] / dt, dt


def run_jabref_suite(
    corpus_dir: Optional[str] = None,
    work_dir: Optional[str] = None,
    queries_n: int = 256,
    top_k: int = 50,  # reference: src/main.rs:110
) -> dict:
    import shutil
    import tempfile

    import jax

    from ..config import (CorpusConfig, EncoderConfig, PipelineConfig,
                          SearchConfig, StoreConfig)
    from ..metrics.quality import top_k_overlap
    from ..pipeline import Pipeline

    tmp = work_dir or tempfile.mkdtemp(prefix="bsr_jabref_")
    created_tmp = work_dir is None
    try:
        corpus = corpus_dir or os.path.join(tmp, "jabref")
        # An existing corpus (e.g. a real JabRef checkout) is used as-is;
        # otherwise synthesize the reference-shaped tree.
        has_java = Path(corpus).exists() and any(Path(corpus).rglob("*.java"))
        if not has_java:
            synthesize_jabref_corpus(corpus)

        cfg = PipelineConfig(
            corpus=CorpusConfig(root=str(corpus), extensions=("java",),
                                files_per_batch=32),  # reference chunk=32
            encoder=EncoderConfig(
                backend="auto",
                checkpoint_dir=os.environ.get("BSR_CHECKPOINT_DIR"),
            ),
            store=StoreConfig(dir=os.path.join(tmp, "vstore")),
            search=SearchConfig(top_k=top_k),
        )
        p = Pipeline(cfg)
        # Warm the encoder outside the timed pipeline (the first compile
        # would swamp config 3).
        p.encoder.get_embeddings(["warm up"])
        encoder_kind = getattr(p.encoder, "backend_label", type(p.encoder).__name__)

        # --- config 3: full pipeline (ingest -> merge -> search -> report)
        t0 = time.perf_counter()
        stats = p.ingest_shard()
        p.merge()
        ingest_s = time.perf_counter() - t0
        engine = p.engine()

        # Self-retrieval query set: evenly spaced stored rows.
        n = engine.store.num_rows
        qn = min(queries_n, n)
        q_rows = np.linspace(0, n - 1, qn, dtype=np.int64)
        store_mat = engine.effective_store()
        queries = store_mat[q_rows]

        # --- config 1: serial scan over the real store
        _serial_scan_qps(store_mat, queries[:8], top_k)  # warm BLAS
        serial_qps, serial_s = _serial_scan_qps(store_mat, queries, top_k)

        # --- config 2: search-only serving (device-resident + e2e)
        timer = p.bench.start("similarity_search")
        t0 = time.perf_counter()
        ids, _ = engine.search(queries, k=top_k)
        e2e_elapsed = time.perf_counter() - t0
        p.bench.record(timer.stop(items_processed=n * qn))

        qdev = engine.prepare_device_queries(queries)
        jax.block_until_ready(engine.search_device(qdev, k=top_k))
        iters = 16
        t0 = time.perf_counter()
        for _ in range(iters):
            out = engine.search_device(qdev, k=top_k)
        jax.block_until_ready(out)
        dev_elapsed = max(time.perf_counter() - t0, 1e-9)
        qps = qn * iters / dev_elapsed

        # Exactness on the real corpus: recall@10 (self-retrieval) + full
        # oracle overlap — the north-star "recall@10 = 1.0 on JabRef".
        o_ids, _ = engine.oracle_topk(queries, k=top_k)
        overlap = top_k_overlap(o_ids.tolist(), ids.tolist(), top_k)
        k_r = min(10, top_k)
        recall_at_10 = float(
            np.mean([q_rows[i] in ids[i, :k_r] for i in range(qn)])
        )

        # Speedup hook: the measured sequential scan of the same query set
        # (reference: benchmark.rs:361-416 prints speedup vs supplied
        # sequential times).
        report = p.bench.generate_report(
            sequential_times={"similarity_search": serial_s}
        )

        return {
            "metric": "jabref_search_qps",
            "value": round(qps, 2),
            "unit": "queries/sec",
            "vs_baseline": round(qps / (serial_qps * 24), 2),
            "recall_at_10": recall_at_10,
            "oracle_overlap": overlap,
            "files": stats.embeddings,
            "rows": n,
            "top_k": top_k,
            "queries": qn,
            "encoder": encoder_kind,
            "serial_qps": round(serial_qps, 2),
            "speedup_vs_serial": round(qps / serial_qps, 2),
            "e2e_qps": round(qn / e2e_elapsed, 2),
            "ingest_files_per_sec": round(stats.embeddings / ingest_s, 2),
            "ingest_s": round(ingest_s, 2),
            "report_has_speedup": "speedup" in report,
            "platform": jax.devices()[0].platform,
        }
    finally:
        if created_tmp:
            shutil.rmtree(tmp, ignore_errors=True)
