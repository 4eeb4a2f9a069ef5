"""Command-line interface.

The reference has no CLI at all — its knobs are compile-time constants
(``extensions``, ``dir``, ``chunk_size``, ``top_k``, ``query_idx``,
reference: src/main.rs:38-45) and env vars (``SKIP_PROCESS``, ``N``,
makefile:1), and the README literally says "adjust the chunk size in main.rs"
(README.md:167). Every one of those knobs is a flag here.

Subcommands:

* ``run``     — the full pipeline (≙ ``mpiexec -n N better-search-rag-rust``)
* ``ingest``  — embed + persist shards + merge only
* ``search``  — serve search from the persisted store (≙ ``SKIP_PROCESS=true``)
* ``serve``   — persistent JSONL request/response server over the pipelined
  streaming search path (one request per stdin line; beyond-parity)
* ``bench``   — the performance benchmark suite (see :mod:`.bench.suite`)
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from .config import (
    CorpusConfig,
    EncoderConfig,
    MeshConfig,
    PipelineConfig,
    SearchConfig,
    StoreConfig,
)


def _add_common(p: argparse.ArgumentParser) -> None:
    corp = p.add_argument_group("corpus")
    corp.add_argument("--root", default=".repos/jabref",
                      help="corpus directory (reference: src/main.rs:39)")
    corp.add_argument("--extensions", default="java",
                      help="comma-separated extensions (src/main.rs:38)")
    corp.add_argument("--files-per-batch", type=int, default=32,
                      help="files per embedding batch (src/main.rs:40)")
    corp.add_argument("--max-file-mb", type=float, default=10.0,
                      help="per-file read cap in MB (src/source.rs:36-39)")

    enc = p.add_argument_group("encoder")
    enc.add_argument("--encoder-backend", default="auto",
                     choices=["auto", "nomic", "hash"])
    enc.add_argument("--checkpoint-dir", default=None,
                     help="local HF export of nomic-embed-text-v1.5")
    enc.add_argument("--dim", type=int, default=768)
    enc.add_argument("--max-tokens", type=int, default=512)
    enc.add_argument("--encode-batch-size", type=int, default=32)
    enc.add_argument("--num-layers", type=int, default=12)
    enc.add_argument("--num-heads", type=int, default=12)
    enc.add_argument("--mlp-dim", type=int, default=3072)
    enc.add_argument("--matryoshka-dim", type=int, default=None,
                     help="truncate embeddings to this dim and re-normalize")
    enc.add_argument("--long-doc", default="truncate",
                     choices=["truncate", "mean"],
                     help="long files: drop past max-tokens (reference "
                          "semantics) or window + mean-pool everything")

    st = p.add_argument_group("store")
    st.add_argument("--store-dir", default=".volumes/vstore",
                    help="vector store directory (src/main.rs:41)")
    st.add_argument("--snapshot", action="store_true",
                    help="maintain a device-store snapshot for fast "
                         "serve startup")
    st.add_argument("--force-merge", action="store_true",
                    help="let a merge rebuild global.npy even when an "
                         "incremental update left it ahead of the shards "
                         "(the appended rows are DISCARDED; only safe after "
                         "a full re-ingest)")

    srch = p.add_argument_group("search")
    srch.add_argument("--top-k", type=int, default=50,
                      help="(src/main.rs:110)")
    srch.add_argument("--query-idx", type=int, default=0,
                      help="self-retrieval query row (src/main.rs:111)")
    srch.add_argument("--store-dtype", default="bfloat16",
                      choices=["bfloat16", "float32"])
    srch.add_argument("--chunk-rows", type=int, default=16384)
    srch.add_argument("--search-kernel", default="auto",
                      choices=["auto", "global", "scan", "blockmax"])
    srch.add_argument("--query-upload", default="f32",
                      choices=["f32", "store"],
                      help="streaming/serve query upload: 'store' rounds "
                           "queries to the store dtype on the host and "
                           "uploads half the bytes (bf16 stores)")
    srch.add_argument("--query", default=None, metavar="TEXT",
                      help="free-text query: encode and retrieve matching "
                           "corpus files instead of the self-retrieval check")

    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="capture a jax.profiler device trace of the run "
                        "(view in TensorBoard/Perfetto)")
    p.add_argument("--speedup-baseline", action="store_true",
                   help="also measure a sequential NumPy scan and print "
                        "speedup in the benchmark report (reference: "
                        "benchmark.rs:361-416; pulls the store to the host)")


def _config_from_args(args, skip_process: bool) -> PipelineConfig:
    return PipelineConfig(
        corpus=CorpusConfig(
            root=args.root,
            extensions=tuple(
                e.strip() for e in args.extensions.split(",") if e.strip()
            ),
            max_file_bytes=int(args.max_file_mb * 1024 * 1024),
            files_per_batch=args.files_per_batch,
        ),
        encoder=EncoderConfig(
            backend=args.encoder_backend,
            checkpoint_dir=args.checkpoint_dir,
            dim=args.dim,
            max_tokens=args.max_tokens,
            batch_size=args.encode_batch_size,
            num_layers=args.num_layers,
            num_heads=args.num_heads,
            mlp_dim=args.mlp_dim,
            matryoshka_dim=args.matryoshka_dim,
            long_doc=args.long_doc,
        ),
        store=StoreConfig(dir=args.store_dir, use_snapshot=args.snapshot),
        mesh=MeshConfig(),
        search=SearchConfig(
            top_k=args.top_k,
            query_idx=args.query_idx,
            store_dtype=args.store_dtype,
            chunk_rows=args.chunk_rows,
            kernel=args.search_kernel,
            query_upload=getattr(args, "query_upload", "f32"),
        ),
        skip_process=skip_process,
        measure_serial_baseline=getattr(args, "speedup_baseline", False),
        force_merge=getattr(args, "force_merge", False),
    )


def _print_result(result) -> None:
    # ≙ print_top_k_results + accuracy print (reference: src/main.rs:142-163,
    # src/mpi_helpers/metrics.rs:209-214)
    print(f"\nTop-{len(result.top_k)} results (store row, cosine distance):")
    for rank, (idx, dist) in enumerate(result.top_k[:10], 1):
        print(f"  {rank:>3}. row {idx:>8}  dist {dist:.6f}")
    if len(result.top_k) > 10:
        print(f"  ... ({len(result.top_k) - 10} more)")
    print(
        f"\nAccuracy: MRR={result.mrr:.4f} "
        f"Recall@k={result.recall:.4f} overlap={result.overlap:.4f}"
    )
    print(result.report)


def _finetune(args) -> int:
    """Contrastive fine-tune over a (data, model) mesh fed by corpus pairs."""
    import jax
    import numpy as np

    from .models.nomic import NomicBertConfig
    from .models.tokenizer import load_tokenizer
    from .models.train import ContrastiveTrainer
    from .models.train_data import corpus_pair_batches
    from .parallel.mesh import create_mesh

    cfg = _config_from_args(args, skip_process=True)
    enc_cfg = cfg.encoder
    model_cfg = NomicBertConfig.from_encoder_config(enc_cfg)
    params = None
    if enc_cfg.checkpoint_dir:
        from .models.nomic import load_hf_checkpoint

        model_cfg, params = load_hf_checkpoint(enc_cfg.checkpoint_dir, model_cfg)

    n_dev = len(jax.devices())
    tp = max(1, args.tp)
    if n_dev % tp:
        raise SystemExit(f"--tp {tp} does not divide {n_dev} devices")
    mesh = create_mesh(shape=(n_dev // tp, tp), axis_names=("data", "model"))
    trainer = ContrastiveTrainer(
        model_cfg, mesh, learning_rate=args.learning_rate, params=params
    )
    tokenizer = load_tokenizer(
        enc_cfg.checkpoint_dir, enc_cfg.max_tokens, enc_cfg.vocab_size
    )
    batches = corpus_pair_batches(
        cfg.corpus.root, cfg.corpus.extensions,
        tokenizer, args.train_batch,
        max_file_bytes=cfg.corpus.max_file_bytes,
        epochs=10_000,  # bounded by --steps below
    )
    losses = []
    for step, (a_ids, a_mask, p_ids, p_mask) in enumerate(batches):
        if step >= args.steps:
            break
        loss = trainer.train_step(a_ids, a_mask, p_ids, p_mask)
        losses.append(loss)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:>5}  loss {loss:.4f}")
    if not losses:
        print("no training steps ran (--steps must be positive)")
        return 1
    if args.save_dir:
        from .models.checkpoint import save_params

        save_params(args.save_dir, trainer.state.params)
        print(f"params saved to {args.save_dir}")
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return 0


def serve_loop(pipeline, in_stream, out_stream, k=None, depth: int = 1,
               batcher=None) -> int:
    """Drive :meth:`Pipeline.serve` over line-delimited JSON streams.

    One request object per input line, one response object per output line,
    flushed immediately (the loop is usable behind a pipe or socket).
    Malformed JSON lines produce an in-order ``{"error": ...}`` response and
    the server keeps going. Blank lines are skipped.

    Input is read by a background thread so the loop can tell "the client is
    waiting for answers" apart from "the next request is already here": when
    no line is ready, a flush token makes :meth:`Pipeline.serve` emit every
    in-flight response before the loop blocks on input again. Without that, a
    synchronous request/response client would deadlock at any depth — the
    server would sit in readline() while the client waits for its answer.
    """
    import queue
    import threading

    from .pipeline import MalformedRequest

    q: "queue.Queue" = queue.Queue()
    _EOF = object()

    def _reader():
        try:
            for line in in_stream:
                q.put(line)
        except (UnicodeDecodeError, OSError) as exc:
            # Undecodable bytes / a vanished stream end the connection after
            # the lines already read; queued requests still get answers.
            q.put(MalformedRequest(f"unreadable input stream: {exc}"))
        finally:
            q.put(_EOF)

    threading.Thread(target=_reader, daemon=True).start()

    def _requests():
        while True:
            try:
                line = q.get(timeout=0.002)
            except queue.Empty:
                yield None  # flush: answer everything in flight, THEN block
                line = q.get()
            if line is _EOF:
                return
            if isinstance(line, MalformedRequest):
                yield line
                continue
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError as exc:
                yield MalformedRequest(str(exc))

    for resp in pipeline.serve(_requests(), k=k, depth=depth, batcher=batcher):
        out_stream.write(json.dumps(resp) + "\n")
        out_stream.flush()
    return 0


def make_tcp_server(pipeline, host: str, port: int, k=None, depth: int = 1,
                    batcher=None):
    """A threading JSONL-over-TCP server: each connection speaks the same
    one-request-per-line protocol as the stdio loop. Connections are handled
    concurrently (JAX dispatch is thread-safe; concurrent streams simply
    interleave on the device queue). Returned unstarted — call
    ``serve_forever()``; the bound address is ``server.server_address``
    (useful with port 0)."""
    import io
    import socketserver

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            # errors="replace": undecodable bytes become U+FFFD, the JSON
            # parse then fails, and the CLIENT gets a malformed-JSON error
            # response for that line instead of a dead connection.
            rin = io.TextIOWrapper(self.rfile, encoding="utf-8", errors="replace")
            wout = io.TextIOWrapper(
                self.wfile, encoding="utf-8", write_through=True
            )
            try:
                serve_loop(pipeline, rin, wout, k=k, depth=depth,
                           batcher=batcher)
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away mid-stream; nothing to answer

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    return Server((host, port), Handler)


def _serve(args) -> int:
    from .pipeline import Pipeline

    cfg = _config_from_args(args, skip_process=True)
    pipeline = Pipeline(cfg)
    engine = pipeline.engine()  # build the device store before accepting
    where = (
        f"one JSON request per line on {args.host}:{args.port}"
        if args.port is not None
        else "one JSON request per line on stdin"
    )
    batcher = None
    if args.serve_window_ms > 0:
        from .batcher import DynamicBatcher

        batcher = DynamicBatcher(
            engine, k=args.top_k, max_batch=args.serve_max_batch,
            window_ms=args.serve_window_ms,
            upload=cfg.search.query_upload,
        )
    print(
        f"serving {engine.store.num_rows} rows "
        f"(top_k={args.top_k}, kernel={engine.kernel_name()}, "
        f"depth={args.serve_depth}"
        + (f", batch window {args.serve_window_ms} ms" if batcher else "")
        + f"); {where}",
        file=sys.stderr,
        flush=True,
    )
    try:  # tolerate binary garbage on stdin the same way the TCP path does
        sys.stdin.reconfigure(errors="replace")
    except (AttributeError, ValueError):  # pragma: no cover — exotic stdin
        pass
    try:
        if args.port is not None:
            with make_tcp_server(
                pipeline, args.host, args.port, k=args.top_k,
                depth=args.serve_depth, batcher=batcher,
            ) as server:
                print(
                    f"listening on {server.server_address[0]}:"
                    f"{server.server_address[1]}",
                    file=sys.stderr,
                    flush=True,
                )
                try:
                    server.serve_forever()
                except KeyboardInterrupt:
                    pass
            return 0
        return serve_loop(
            pipeline, sys.stdin, sys.stdout, k=args.top_k,
            depth=args.serve_depth, batcher=batcher,
        )
    finally:
        if batcher is not None:
            batcher.close()


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="bsr",
        description="exact top-k retrieval framework",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    for name, desc in [
        ("run", "full pipeline: ingest + merge + search + report"),
        ("ingest", "embed the corpus and persist the global store"),
        ("search", "serve search from the persisted store (SKIP_PROCESS=true)"),
        ("evaluate", "batch self-retrieval quality report on a built store"),
        ("update", "incrementally embed corpus files not yet in the store"),
    ]:
        sp = sub.add_parser(name, help=desc)
        _add_common(sp)
        if name == "evaluate":
            sp.add_argument("--num-queries", type=int, default=64)

    sv = sub.add_parser(
        "serve",
        help="persistent JSONL search server: one request per stdin line, "
             "one response per stdout line (pipelined on-device)",
    )
    _add_common(sv)
    sv.add_argument("--serve-depth", type=int, default=1,
                    help="requests kept in flight on the device before "
                         "results are pulled (1 = synchronous; 2-3 hides "
                         "device compute on directly-attached hosts)")
    sv.add_argument("--port", type=int, default=None,
                    help="listen for JSONL connections on this TCP port "
                         "instead of stdin/stdout (0 = ephemeral; each "
                         "connection is an independent pipelined stream)")
    sv.add_argument("--host", default="127.0.0.1",
                    help="bind address for --port")
    sv.add_argument("--serve-window-ms", type=float, default=0.0,
                    help="dynamic micro-batching: coalesce requests landing "
                         "within this window (across ALL connections under "
                         "--port) into one fixed-shape device dispatch; "
                         "0 disables. Right for many concurrent low-rate "
                         "clients; adds up to one window of latency")
    sv.add_argument("--serve-max-batch", type=int, default=1024,
                    help="max coalesced query rows per dispatch when "
                         "--serve-window-ms is on")

    ft = sub.add_parser(
        "finetune",
        help="contrastive fine-tuning of the encoder on the corpus",
    )
    _add_common(ft)
    ft.add_argument("--steps", type=int, default=50)
    ft.add_argument("--learning-rate", type=float, default=2e-5)
    ft.add_argument("--train-batch", type=int, default=32)
    ft.add_argument("--tp", type=int, default=1,
                    help="model (tensor-parallel) mesh axis size")
    ft.add_argument("--save-dir", default=None,
                    help="checkpoint dir for the tuned params")

    bp = sub.add_parser("bench", help="performance benchmark suite")
    bp.add_argument("--suite", default="search_1m",
                    help="benchmark config name (see bench/suite.py)")
    bp.add_argument("--json", action="store_true", dest="as_json")
    bp.add_argument("--profile-dir", default=None, metavar="DIR")

    args = parser.parse_args(argv)

    from .launch import enable_compile_cache, maybe_init_distributed

    maybe_init_distributed()
    enable_compile_cache()

    from contextlib import nullcontext

    profile_dir = getattr(args, "profile_dir", None)
    if profile_dir:
        from .utils.profiling import device_trace

        trace_ctx = device_trace(profile_dir)
    else:
        trace_ctx = nullcontext()

    with trace_ctx:
        if args.command == "bench":
            from .bench.suite import run_suite

            result = run_suite(args.suite)
            print(json.dumps(result) if args.as_json else result)
            return 0

        if args.command == "finetune":
            return _finetune(args)

        if args.command == "serve":
            return _serve(args)

        from .pipeline import Pipeline

        cfg = _config_from_args(
            args,
            skip_process=(args.command in ("search", "evaluate", "update")),
        )
        pipeline = Pipeline(cfg)
        if args.command == "evaluate":
            report = pipeline.evaluate(args.num_queries, args.top_k)
            print(json.dumps(report))
            print(pipeline.bench.generate_report())
            return 0
        if args.command == "update":
            stats = pipeline.update()
            print(
                f"appended {stats.embeddings} embeddings, re-embedded "
                f"{stats.rows_reembedded}, deleted {stats.rows_deleted} "
                f"({stats.files_assigned} new files, "
                f"{stats.files_skipped} skipped)"
            )
            return 0
        if args.command == "ingest":
            stats = pipeline.ingest_shard()
            pipeline.merge()
            print(
                f"ingested {stats.embeddings} embeddings "
                f"from {stats.files_read} files ({stats.files_skipped} skipped)"
            )
            print(pipeline.bench.generate_report())
            return 0

        if args.query is not None:
            if args.command == "run":
                pipeline.ingest_shard()
                pipeline.merge()
            ranked = pipeline.query([args.query])[0]
            print(f"\nTop-{len(ranked)} files for query: {args.query!r}")
            for rank, (path, idx, dist) in enumerate(ranked, 1):
                print(f"  {rank:>3}. {path}  (row {idx}, dist {dist:.6f})")
            return 0

        result = pipeline.run()
        _print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
