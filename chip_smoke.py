#!/usr/bin/env python
"""Smoke test of the main path on NVIDIA GPUs, through the normal entry points.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # the multi-card paths, on four cards

One card: the full-width NomicBERT encoder (12 layers, 768 hidden, 512
tokens, random weights from a seed) against the float32 XLA reference, one
contrastive train step, the ``bsr`` CLI's ingest -> search -> serve path over
a generated JabRef-shaped Java tree, and exact top-k search over stores of
1M x 768 (bfloat16, int8, float32), 10M x 768 int8 and duplicate-heavy
stores, each against the serial oracle. ``--four``: sharded search of a
4M x 768 store over a four-card mesh and one DP x TP (2 x 2) train step
against the same step on one card.

Every phase must pass; a failing phase ends the run with a non-zero exit and
no result line. The timings printed are smoke timings (compile, wall, peak
device memory), not benchmark metrics. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
There is no CPU fallback: without a GPU the script exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

#: Full width of the one supported model (nomic-embed-text-v1.5).
ENCODER_WIDTH = dict(hidden_size=768, num_layers=12, num_heads=12,
                     mlp_dim=3072, max_tokens=512)
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power limit`` of the cards, read by a child process that
    does not touch JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def require_gpu(n: int):
    """The first ``n`` JAX devices, which must be GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX found {devices[0].platform!r}"
        )
    if len(devices) < n:
        raise SystemExit(f"chip_smoke needs {n} GPUs; JAX found {len(devices)}")
    return devices[:n]


def peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def timed(fn):
    """``(result, seconds)`` of ``fn()`` with every output waited for."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase: encoder at full width
# ---------------------------------------------------------------------------


def _token_batch(cfg, batch: int, seed: int):
    """Right-padded ids + mask with mixed lengths (one full row)."""
    rng = np.random.default_rng(seed)
    s = cfg.max_tokens
    ids = rng.integers(1, cfg.vocab_size, size=(batch, s)).astype(np.int32)
    lengths = rng.integers(1, s + 1, size=batch)
    lengths[0] = s
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return ids * mask, mask


def phase_encoder(width=ENCODER_WIDTH, batch: int = 32,
                  min_cos: float = 0.999) -> dict:
    """Forward with the platform's attention vs the float32 XLA path under
    ``highest`` matmul precision: per-row embedding cosine >= ``min_cos``."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from better_search_rag_rust_tpu.models.nomic import (
        NomicBertConfig, NomicEncoder, init_params, resolve_attention_impl)

    cfg = NomicBertConfig(**width)
    params = init_params(cfg, SEED)
    ids, mask = _token_batch(cfg, batch, seed=1)
    fast = NomicEncoder(cfg, params=params)
    out, compile_s = timed(lambda: fast.encode_tokens_device(ids, mask))
    _, wall_s = timed(lambda: fast.encode_tokens_device(ids, mask))
    ref_cfg = dataclasses.replace(cfg, dtype=jnp.float32, attention_impl="xla")
    with jax.default_matmul_precision("highest"):
        ref = NomicEncoder(ref_cfg, params=params).encode_tokens(ids, mask)
    got = np.asarray(out, dtype=np.float32)
    check(got.shape == (batch, cfg.hidden_size), f"shape {got.shape}")
    check(bool(np.isfinite(got).all()), "non-finite embeddings")
    cos = np.sum(got * ref, axis=1)  # both rows are unit-norm
    check(float(cos.min()) >= min_cos,
          f"encoder cosine {cos.min():.6f} < {min_cos}")
    return {"attention": resolve_attention_impl(cfg.attention_impl,
                                                cfg.dtype),
            "batch": batch, "seq": cfg.max_tokens,
            "min_cosine": float(cos.min()),
            "compile_s": compile_s, "wall_s": wall_s,
            "peak_bytes_in_use": peak_bytes()}


# ---------------------------------------------------------------------------
# Phase: contrastive train step
# ---------------------------------------------------------------------------


def _train_loss(cfg, mesh, batch: int) -> float:
    from better_search_rag_rust_tpu.models.train import ContrastiveTrainer

    trainer = ContrastiveTrainer(cfg, mesh, seed=SEED)
    a_ids, a_mask = _token_batch(cfg, batch, seed=2)
    p_ids, p_mask = _token_batch(cfg, batch, seed=3)
    return trainer.train_step(a_ids, a_mask, p_ids, p_mask)


def phase_train(width=ENCODER_WIDTH, batch: int = 16,
                rtol: float = 1e-2) -> dict:
    """One ``ContrastiveTrainer`` step with the platform's attention: a
    finite loss within ``rtol`` of the same step with XLA attention."""
    import dataclasses

    import jax

    from better_search_rag_rust_tpu.models.nomic import NomicBertConfig
    from better_search_rag_rust_tpu.parallel.mesh import create_mesh

    cfg = NomicBertConfig(**width)
    mesh = create_mesh(shape=(1, 1), axis_names=("data", "model"),
                       devices=jax.devices()[:1])
    t0 = time.perf_counter()
    loss = _train_loss(cfg, mesh, batch)
    wall_s = time.perf_counter() - t0
    ref = _train_loss(dataclasses.replace(cfg, attention_impl="xla"), mesh,
                      batch)
    check(bool(np.isfinite(loss)), f"non-finite train loss {loss}")
    check(abs(loss - ref) <= rtol * abs(ref),
          f"train loss {loss} vs xla-attention {ref}")
    return {"batch": batch, "loss": loss, "xla_attention_loss": ref,
            "compile_and_step_s": wall_s, "peak_bytes_in_use": peak_bytes()}


# ---------------------------------------------------------------------------
# Phase: the CLI pipeline (ingest -> search -> serve) in this process
# ---------------------------------------------------------------------------


def _cli(argv, stdin_text=None) -> str:
    """Run ``bsr`` in this process (one process owns the card); returns
    what it printed."""
    from better_search_rag_rust_tpu.cli import main

    out = io.StringIO()
    old_stdin = sys.stdin
    if stdin_text is not None:
        sys.stdin = io.StringIO(stdin_text)
    try:
        with contextlib.redirect_stdout(out):
            rc = main(argv)
    finally:
        sys.stdin = old_stdin
    check(rc == 0, f"bsr {argv[0]} exited {rc}")
    return out.getvalue()


def phase_pipeline(work: Path, files: int = 2305, width=ENCODER_WIDTH,
                   batch: int = 32) -> dict:
    """``bsr run`` over a JabRef-shaped tree (self-retrieval MRR, recall
    and overlap 1.0), one ``bsr search --query``, and ``bsr serve``
    answering text, batch and raw-vector requests."""
    from better_search_rag_rust_tpu.bench.jabref import (
        synthesize_jabref_corpus)

    tree = synthesize_jabref_corpus(work / "jabref", files=files)
    store = work / "vstore"
    common = [
        "--root", str(tree), "--store-dir", str(store),
        "--encoder-backend", "nomic", "--encode-batch-size", str(batch),
        "--dim", str(width["hidden_size"]),
        "--num-layers", str(width["num_layers"]),
        "--num-heads", str(width["num_heads"]),
        "--mlp-dim", str(width["mlp_dim"]),
        "--max-tokens", str(width["max_tokens"]),
    ]
    t0 = time.perf_counter()
    out = _cli(["run", *common])
    run_s = time.perf_counter() - t0
    m = re.search(r"MRR=([\d.]+) Recall@k=([\d.]+) overlap=([\d.]+)", out)
    check(m is not None, f"no accuracy line in: {out[-500:]}")
    mrr, recall, overlap = map(float, m.groups())
    check((mrr, recall, overlap) == (1.0, 1.0, 1.0),
          f"MRR={mrr} recall={recall} overlap={overlap}")

    probe = sorted(tree.rglob("*.java"))[files // 2]
    out = _cli(["search", *common, "--query", probe.read_text()])
    ranked = re.findall(r"^\s+\d+\. (\S+)\s+\(row (\d+), dist ([\d.]+)\)",
                        out, flags=re.M)
    check(len(ranked) > 0, f"text query returned nothing: {out[-500:]}")
    check(all(Path(p).is_file() for p, _, _ in ranked),
          "text query returned rows that resolve to no file")
    check(Path(ranked[0][0]) == probe and float(ranked[0][2]) < 1e-3,
          f"text query top hit {ranked[0]} is not {probe}")

    vecs = np.load(store / "global.npy", mmap_mode="r")
    requests = [
        {"id": "text", "query": probe.read_text()},
        {"id": "batch", "queries": ["public class Entry", "bib citation"]},
        {"id": "vector", "vector": vecs[7].tolist(), "k": 5},
        {"id": "vectors", "vectors": vecs[[0, 1]].tolist()},
    ]
    out = _cli(["serve", *common, "--top-k", "10"],
               stdin_text="".join(json.dumps(r) + "\n" for r in requests))
    responses = {r["id"]: r for r in map(json.loads, out.splitlines())}
    check(set(responses) == {r["id"] for r in requests},
          f"serve answered {sorted(responses)}")
    check(all("results" in r for r in responses.values()),
          f"serve errors: {responses}")
    check(responses["vector"]["results"][0][0]["row"] == 7,
          "raw-vector request did not retrieve its own row")
    check([q[0]["row"] for q in responses["vectors"]["results"]] == [0, 1],
          "batched vector request did not retrieve its own rows")
    check(len(responses["batch"]["results"]) == 2, "batch answered wrong")
    return {"files": files, "mrr": mrr, "recall": recall,
            "overlap": overlap, "text_query_hits": len(ranked),
            "serve_responses": len(responses), "run_wall_s": run_s,
            "peak_bytes_in_use": peak_bytes()}


# ---------------------------------------------------------------------------
# Phase: exact search at real size
# ---------------------------------------------------------------------------


def _duplicate_store(rows: int, dim: int, seed: int) -> np.ndarray:
    """Host rows with exact ties: a duplicate cluster, far duplicates across
    shards, a tiled block and a zero row."""
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((rows, dim)).astype(np.float32)
    mat[rows // 2: rows // 2 + 10] = mat[7]
    mat[rows - 1] = mat[7]
    mat[rows // 4: rows // 4 + 256] = np.tile(mat[100:108], (32, 1))
    mat[3] = 0.0
    return mat


def _search_vs_oracle(engine, queries: np.ndarray, k: int,
                      checked: int) -> dict:
    """Search all ``queries``; the ids of ``checked`` of them, spread over
    the batch, must equal the oracle's exactly."""
    from better_search_rag_rust_tpu.metrics.quality import top_k_overlap

    (ids, _), compile_s = timed(lambda: engine.search(queries, k=k))
    (ids, dists), wall_s = timed(lambda: engine.search(queries, k=k))
    pick = np.linspace(0, len(queries) - 1, checked).astype(np.int64)
    o_ids, o_dists = engine.oracle_topk(queries[pick], k=k)
    mismatched = int(np.sum(np.any(ids[pick] != o_ids, axis=1)))
    if mismatched:
        gap = float(np.max(np.abs(dists[pick] - o_dists)))
        raise AssertionError(
            f"{mismatched}/{checked} queries differ from the oracle "
            f"(largest distance gap {gap:.3g})")
    overlap = top_k_overlap(o_ids.tolist(), ids[pick].tolist(), k)
    check(overlap == 1.0, f"oracle overlap {overlap}")
    return {"queries": len(queries), "checked": checked, "k": k,
            "overlap": overlap, "kernel": engine.kernel_name(k),
            "compile_s": compile_s, "wall_s": wall_s,
            "peak_bytes_in_use": peak_bytes()}


def phase_search(mesh, rows: int, dim: int, dtype: str, queries: int = 1024,
                 k: int = 100, checked: int = 64,
                 chunk_rows: int = 65536) -> dict:
    """A random normalized store built on device, searched through
    ``SearchEngine.search`` against the oracle."""
    import jax

    from better_search_rag_rust_tpu.bench.suite import synthetic_device_store
    from better_search_rag_rust_tpu.config import SearchConfig
    from better_search_rag_rust_tpu.ops.engine import SearchEngine

    t0 = time.perf_counter()
    store = synthetic_device_store(mesh, rows, dim, dtype, chunk_rows,
                                   seed=SEED)
    build_s = time.perf_counter() - t0
    q_idx = np.linspace(0, rows - 1, queries).astype(np.int64)
    qs = np.asarray(jax.device_get(store.data[q_idx]), np.float32)[:, :dim]
    # perturbed rows: self-retrieval plus non-trivial neighbourhoods
    qs = qs + np.random.default_rng(1).standard_normal(qs.shape).astype(
        np.float32) * 0.05
    engine = SearchEngine(store, SearchConfig(top_k=k, store_dtype=dtype))
    out = _search_vs_oracle(engine, qs, k, checked)
    out.update(rows=rows, dim=dim, dtype=dtype, build_s=build_s)
    return out


def phase_search_duplicates(mesh, rows: int, dim: int, dtype: str,
                            k: int = 100, chunk_rows: int = 65536) -> dict:
    """A store saturated with exact ties, against the oracle."""
    from better_search_rag_rust_tpu.config import SearchConfig
    from better_search_rag_rust_tpu.ops.engine import SearchEngine
    from better_search_rag_rust_tpu.store.device_store import DeviceStore

    mat = _duplicate_store(rows, dim, seed=SEED)
    store = DeviceStore.from_host(mat, mesh, dtype=dtype,
                                  chunk_rows=chunk_rows)
    qs = mat[[7, 100, 3, rows // 2, rows - 2] + list(range(11, 70))]
    engine = SearchEngine(store, SearchConfig(top_k=k, store_dtype=dtype))
    out = _search_vs_oracle(engine, qs, k, checked=len(qs))
    out.update(rows=rows, dim=dim, dtype=dtype, duplicates=True)
    return out


def free_device_memory() -> None:
    import jax

    gc.collect()
    jax.clear_caches()


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def run_one_card(work: Path) -> None:
    import jax

    from better_search_rag_rust_tpu.parallel.mesh import create_mesh

    log(f"encoder {json.dumps(phase_encoder())}")
    free_device_memory()
    log(f"train {json.dumps(phase_train())}")
    free_device_memory()
    log(f"pipeline {json.dumps(phase_pipeline(work))}")
    free_device_memory()
    mesh = create_mesh(shape=(1,), axis_names=("data",),
                       devices=jax.devices()[:1])
    for rows, dtype in ((1 << 20, "bfloat16"), (1 << 20, "int8"),
                        (1 << 20, "float32"), (10_000_000, "int8")):
        log(f"search {json.dumps(phase_search(mesh, rows, 768, dtype))}")
        free_device_memory()
    for dtype in ("bfloat16", "int8", "float32"):
        res = phase_search_duplicates(mesh, 131072, 768, dtype)
        log(f"search {json.dumps(res)}")
        free_device_memory()


def phase_dp_tp_train(devices, width=ENCODER_WIDTH, batch: int = 16,
                      rtol: float = 1e-2) -> dict:
    """One DP x TP (2 x 2) ``ContrastiveTrainer`` step: its loss within
    ``rtol`` of the same step on one card."""
    from better_search_rag_rust_tpu.models.nomic import NomicBertConfig
    from better_search_rag_rust_tpu.parallel.mesh import create_mesh

    cfg = NomicBertConfig(**width)
    dp_tp = create_mesh(shape=(2, 2), axis_names=("data", "model"),
                        devices=devices[:4])
    one = create_mesh(shape=(1, 1), axis_names=("data", "model"),
                      devices=devices[:1])
    t0 = time.perf_counter()
    loss = _train_loss(cfg, dp_tp, batch)
    wall_s = time.perf_counter() - t0
    free_device_memory()
    ref = _train_loss(cfg, one, batch)
    check(bool(np.isfinite(loss)), f"non-finite DP x TP loss {loss}")
    check(abs(loss - ref) <= rtol * abs(ref),
          f"DP x TP loss {loss} vs one-card {ref}")
    return {"mesh": [2, 2], "batch": batch, "loss": loss,
            "one_card_loss": ref, "compile_and_step_s": wall_s,
            "peak_bytes_in_use": peak_bytes()}


def run_four_cards(devices, rows: int = 4 << 20, dim: int = 768,
                   width=ENCODER_WIDTH, chunk_rows: int = 65536) -> None:
    from better_search_rag_rust_tpu.parallel.mesh import create_mesh

    mesh = create_mesh(shape=(4,), axis_names=("data",), devices=devices[:4])
    for dtype in ("bfloat16", "int8"):
        res = phase_search(mesh, rows, dim, dtype, chunk_rows=chunk_rows)
        log(f"sharded_search {json.dumps(res)}")
        free_device_memory()
    log(f"dp_tp_train {json.dumps(phase_dp_tp_train(devices, width))}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths (sharded search, "
                         "DP x TP training)")
    args = ap.parse_args(argv)
    n = 4 if args.four else 1

    import jax

    devices = require_gpu(n)
    log(card_line())
    from better_search_rag_rust_tpu.launch import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    log("timings below are smoke timings, not benchmark metrics")
    if args.four:
        run_four_cards(devices)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            run_one_card(Path(tmp))
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
