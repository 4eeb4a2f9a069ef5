"""End-to-end pipeline driver: ingest -> embed -> store -> search -> report.

This is the rebuild of the reference's SPMD driver and task layer
(reference: src/main.rs:25-189, src/mpi_helpers/tasks.rs:17-217):

reference (MPI ranks)                       | here (JAX)
--------------------------------------------|--------------------------------
every rank re-walks the tree (tasks.rs:52)  | deterministic sorted walk; each
and relies on walkdir order                 | host takes its block slice
rank slice via slice_by_rank (tasks.rs:68)  | :func:`..parallel.slice_for_shard`
chunked read -> embed -> append loop with   | same loop, per-batch failures
per-chunk log-and-continue (tasks.rs:94-148)| logged and skipped
persist rank_r.parquet (tasks.rs:163-172)   | per-host shard persist
barrier; root merges in rank order          | host barrier; host 0 merges in
(main.rs:82-107, tasks.rs:181-217)          | shard order (index discipline)
every rank re-reads ALL of global.parquet   | ONE block-sharded jax.Array in
at search time (metrics.rs:23-33)           | device memory over the mesh
root broadcasts query (main.rs:123-125)     | implicit replication
SKIP_PROCESS env (main.rs:42-45)            | ``config.skip_process``
barriers everywhere                         | XLA program order + one host sync

The embedding model is loaded **once per host process** and jitted over the
chip mesh — not once per rank as in the reference, whose per-rank ~0.5 GB
replica is its scaling bottleneck (OOM at N=32, README.md:164-166).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .bench import BenchmarkManager
from .config import PipelineConfig
from .corpus.walker import find_files_by_extensions, read_files
from .metrics.quality import accuracy_metrics_for_query
from .models import EncoderService, create_encoder
from .ops.engine import SearchEngine
from .parallel.mesh import create_mesh
from .parallel.partition import slice_for_shard
from .store.device_store import DeviceStore
from .store.vectorstore import (
    VectorStore,
    global_store,
    local_store,
    merge_vector_stores,
)
from .utils.logging import host_log


def _process_info() -> Tuple[int, int]:
    import jax

    return jax.process_index(), jax.process_count()


def _host_barrier(name: str) -> None:
    """Cross-host sync between filesystem phases (≙ world.barrier(),
    reference: src/main.rs:82,107). No-op on a single host; on device the
    search itself needs no barriers — XLA program order replaces them."""
    import jax

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


@dataclass
class IngestStats:
    """Per-host ingest outcome (≙ return of
    ``process_files_embeddings_chunked``, reference: src/mpi_helpers/tasks.rs:39-179)."""

    files_found: int = 0
    files_assigned: int = 0
    files_read: int = 0
    files_skipped: int = 0
    embeddings: int = 0
    failed_batches: int = 0
    #: update() only: rows whose file content changed and were re-embedded
    #: in place, and rows whose file vanished and were compacted away.
    rows_reembedded: int = 0
    rows_deleted: int = 0


@dataclass
class PipelineResult:
    """What the reference's driver prints, as data
    (reference: src/main.rs:142-169)."""

    top_k: List[Tuple[int, float]]
    mrr: float
    recall: float
    overlap: float
    num_vectors: int
    report: str
    ingest: Optional[IngestStats] = None


class MalformedRequest:
    """Out-of-band wrapper the serve reader hands to :meth:`Pipeline.serve`
    for an input line that was not valid JSON. A wrapper type (not a magic
    dict key) so no well-formed client request can collide with it."""

    def __init__(self, error: str):
        self.error = error


#: Serve pads client batches up to these fixed shapes so a long-lived server
#: compiles O(log max_batch) XLA programs, not one per distinct client batch
#: size (each jit is seconds; the compiled cache lives forever).
def _serve_batch_shape(nq: int) -> int:
    if nq <= 1024:
        return max(1, 1 << (nq - 1).bit_length())
    return nq + (-nq) % 1024


_UNSET = object()


class Pipeline:
    """The full-capability driver (reference: src/main.rs:25-189)."""

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        encoder: Optional[EncoderService] = None,
        mesh=None,
    ):
        self.config = config or PipelineConfig.from_env()
        self.bench = BenchmarkManager()
        self._encoder = encoder
        self._mesh = mesh
        self._engine: Optional[SearchEngine] = None
        self._manifest_cache = _UNSET
        self._drift_warned: set = set()
        # Serializes engine builds + manifest-cache mutation: one Pipeline
        # is shared across ThreadingTCPServer connection threads, and a
        # reload's clear-then-rebuild racing a concurrent engine() would
        # build (and hold) a second multi-GB device store.
        import threading

        self._build_lock = threading.RLock()

    # -- lazy pieces -----------------------------------------------------------

    @property
    def mesh(self):
        if self._mesh is None:
            mc = self.config.mesh
            self._mesh = create_mesh(mc.shape, mc.axis_names)
        return self._mesh

    @property
    def encoder(self) -> EncoderService:
        if self._encoder is None:
            timer = self.bench.start("llm_service_loading")
            self._encoder = create_encoder(
                self.config.encoder, mesh=self._local_encode_mesh()
            )
            self.bench.record(timer.stop())  # reference: src/main.rs:53-55
        return self._encoder

    def _local_encode_mesh(self):
        """Mesh over THIS PROCESS's devices for data-parallel encoding.

        Multi-host ingest is one process per host (SPMD block DP over
        files); on hosts that own several chips the nomic forward would
        otherwise run on one device only. Batches shard over a local mesh
        when the fixed batch size divides it (numerics metadata records
        ``dp_devices``). The host-side hash backend never encodes on
        device, so it gets no mesh (and no fallback warning)."""
        enc_cfg = self.config.encoder
        if enc_cfg.backend == "hash" or (
            enc_cfg.backend == "auto"
            and not (
                enc_cfg.checkpoint_dir
                and os.path.isdir(enc_cfg.checkpoint_dir)
            )
        ):
            return None
        import jax

        local = jax.local_devices()
        if len(local) <= 1:
            return None
        if self.config.encoder.batch_size % len(local):
            host_log(
                f"encode batch_size {self.config.encoder.batch_size} does "
                f"not divide {len(local)} local devices; encoding on one"
            )
            return None
        return create_mesh(
            (len(local),), ("data",), devices=local
        )

    # -- phase 1: ingest + embed ------------------------------------------------

    def ingest_shard(
        self, shard: Optional[int] = None, num_shards: Optional[int] = None
    ) -> IngestStats:
        """Embed this host's block of the corpus into its shard store
        (reference: src/mpi_helpers/tasks.rs:39-179).

        Per-batch failures are logged and skipped, never fatal
        (reference: tasks.rs:118-124)."""
        cfg = self.config
        proc, nprocs = _process_info()
        shard = proc if shard is None else shard
        num_shards = nprocs if num_shards is None else num_shards
        stats = IngestStats()

        files = find_files_by_extensions(cfg.corpus.root, cfg.corpus.extensions)
        stats.files_found = len(files)
        if shard == 0:
            host_log(f"found {len(files)} files under {cfg.corpus.root}")

        mine = slice_for_shard(shard, num_shards, files)
        stats.files_assigned = len(mine)

        # Partial-progress resume. The `.progress` marker is the COMMIT
        # POINT: it records (files consumed, rows committed) and is written
        # atomically, strictly after the store and manifest writes. A crash
        # anywhere in the window leaves the marker describing the last fully
        # consistent state; resume reconciles by truncating anything the
        # crashed run persisted past it. (The reference restarts its whole
        # embed phase on any crash — SURVEY.md §5 "Checkpoint / resume".)
        import json
        import os as _os

        from .store.vectorstore import local_store_path

        progress_path = local_store_path(cfg.store.dir, shard).with_suffix(
            ".progress"
        )
        paths_file = local_store_path(cfg.store.dir, shard).with_suffix(
            ".paths.json"
        )
        attrs_file = local_store_path(cfg.store.dir, shard).with_suffix(
            ".attrs.json"
        )
        done_files = 0
        committed_rows = 0
        if cfg.resume and progress_path.exists():
            try:
                marker = json.loads(progress_path.read_text())
                done_files = min(int(marker["files"]), len(mine))
                committed_rows = int(marker["rows"])
            except (ValueError, KeyError, TypeError):
                done_files = 0

        row_paths: List[str] = []
        row_attrs: List = []
        store = None
        if done_files > 0:
            try:
                store = local_store(cfg.store.dir, shard, empty=False)
                if store.count < committed_rows or not paths_file.exists():
                    raise ValueError("shard behind its commit marker")
                store.truncate(committed_rows)  # drop post-marker crash rows
                row_paths = json.loads(paths_file.read_text())[:committed_rows]
                if len(row_paths) != committed_rows:
                    raise ValueError("manifest shorter than committed rows")
                # Identity sidecar: absent on pre-attrs stores — those rows
                # simply have no recorded identity (never edit-detected).
                row_attrs = [None] * committed_rows
                if attrs_file.exists():
                    loaded = json.loads(attrs_file.read_text())[:committed_rows]
                    row_attrs[: len(loaded)] = loaded
            except Exception as exc:
                host_log(
                    f"shard {shard}: resume state unusable ({exc}); "
                    "restarting the shard from scratch"
                )
                store, row_paths, row_attrs, done_files = None, [], [], 0
        if store is None:
            store = local_store(cfg.store.dir, shard, empty=True)
        else:
            stats.embeddings = store.count
            host_log(
                f"shard {shard}: resuming after {done_files} files "
                f"({store.count} embeddings already persisted)"
            )

        def _atomic_write(path, text: str) -> None:
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(path.suffix + f".{_os.getpid()}.tmp")
            tmp.write_text(text)
            _os.replace(tmp, path)

        def checkpoint(files_done: int) -> None:
            store.persist()  # atomic, reference: tasks.rs:163-172
            # Row -> source-file manifest (one path per stored row, in row
            # order). The reference only ever reports bare row indices; this
            # is what lets search results resolve back to files.
            _atomic_write(paths_file, json.dumps(row_paths))
            # Row -> file-identity sidecar: what update() compares to detect
            # edited files without re-embedding the whole corpus.
            _atomic_write(attrs_file, json.dumps(row_attrs))
            # Marker LAST: it commits the writes above.
            _atomic_write(
                progress_path,
                json.dumps({"files": files_done, "rows": store.count}),
            )

        # Record the encoder numerics that produced this store (backend,
        # attention impl, dtype): query-time embeddings from different
        # numerics drift at bf16-noise level, which must be visible.
        from .store.vectorstore import write_encoder_meta

        if self.encoder.numerics:
            write_encoder_meta(cfg.store.dir, self.encoder.numerics)

        timer = self.bench.start("embedding_generation")
        bsz = cfg.corpus.files_per_batch
        ckpt_every = cfg.checkpoint_every_batches

        def on_batch(batch_idx, files_through, kept, emb) -> None:
            if emb is not None and kept:
                store.append_many(emb)
                row_paths.extend(str(p) for p, _c, _a in kept)
                row_attrs.extend(a for _p, _c, a in kept)
                stats.embeddings += emb.shape[0]
            if ckpt_every and (batch_idx + 1) % ckpt_every == 0:
                checkpoint(files_through)

        self._embed_paths_pipelined(
            mine[done_files:], stats, on_batch, file_offset=done_files
        )
        checkpoint(len(mine))
        self.bench.record(timer.stop(items_processed=stats.embeddings))
        host_log(
            f"shard {shard}: {stats.embeddings} embeddings "
            f"({stats.files_skipped} files skipped)"
        )
        return stats

    def _embed_paths_pipelined(
        self, paths, stats: IngestStats, on_batch, file_offset: int = 0
    ) -> None:
        """Three-stage software pipeline over ``paths`` (the reference's chunk
        loop is fully serial — read, embed, append per chunk;
        src/mpi_helpers/tasks.rs:94-148):

          A (background thread): read + tokenize batch i+1 — file I/O
            (threaded C++ reader when available) AND pure-Python tokenization
            hide under the device forward;
          B (main): dispatch batch i's forward asynchronously;
          C (main): collect batch i-1's embeddings and hand them to
            ``on_batch``.

        B-before-C keeps the device busy across batch boundaries: the next
        forward is already queued while the previous readback and any
        host-side append run.

        ``on_batch(batch_idx, files_through, kept, emb)`` is called once per
        batch in order; ``kept`` is ``[(path, content, attr)]`` for the files
        that read successfully, ``emb`` is the ``[len(kept), D]`` embedding
        matrix or ``None`` when the batch failed (failures are logged and
        counted, never fatal — reference: tasks.rs:118-124);
        ``files_through = file_offset + files consumed`` so callers can
        checkpoint at batch granularity."""
        from concurrent.futures import ThreadPoolExecutor

        from .corpus.walker import file_attr, file_stat

        cfg = self.config
        bsz = cfg.corpus.files_per_batch
        starts = list(range(0, len(paths), bsz))
        prefetcher = ThreadPoolExecutor(max_workers=1)
        futures = {}

        def _read_and_tokenize(batch_paths):
            # Stat BEFORE read (see walker.file_stat: a rewrite landing
            # between the two then mismatches the next update's stat fast
            # path instead of masking the edit forever).
            stats_pre = [file_stat(p) for p in batch_paths]
            contents = read_files(batch_paths, cfg.corpus.max_file_bytes)
            kept = [
                (p, c, file_attr(st, c))
                for (p, c), st in zip(contents, stats_pre)
                if c
            ]
            tb = self.encoder.tokenize([c for _p, c, _a in kept])
            return kept, tb

        def _submit(idx):
            if 0 <= idx < len(starts) and idx not in futures:
                s = starts[idx]
                futures[idx] = prefetcher.submit(
                    _read_and_tokenize, paths[s : s + bsz]
                )

        def _collect(inflight) -> None:
            batch_idx, files_through, kept, pending = inflight
            emb = None
            if pending is not None:
                try:
                    emb = self.encoder.collect(pending)
                except Exception as exc:  # log-and-continue, tasks.rs:118-124
                    host_log(
                        f"batch {batch_idx} failed ({len(kept)} files): {exc}"
                    )
                    stats.failed_batches += 1
            on_batch(batch_idx, files_through, kept, emb)

        from collections import deque

        # Depth-D in-flight window (D=2 is the classic double-buffer:
        # dispatch i, collect i-1). Deeper windows keep the device queue
        # full across each synchronous collect; on_batch stays strictly in
        # batch order.
        depth = max(int(getattr(cfg.corpus, "inflight_batches", 2)), 1)
        inflight: deque = deque()
        _submit(0)
        try:
            for batch_idx, start in enumerate(starts):
                _submit(batch_idx + 1)
                batch_paths = paths[start : start + bsz]
                pending, kept = None, []
                try:
                    kept, tb = futures.pop(batch_idx).result()
                    stats.files_skipped += len(batch_paths) - len(kept)
                    stats.files_read += len(kept)
                    if kept:
                        pending = self.encoder.dispatch(tb)
                except Exception as exc:  # log-and-continue, tasks.rs:118-124
                    host_log(
                        f"batch {batch_idx} failed "
                        f"({len(batch_paths)} files): {exc}"
                    )
                    stats.failed_batches += 1
                inflight.append((
                    batch_idx,
                    file_offset + start + len(batch_paths),
                    kept,
                    pending,
                ))
                # Per-batch collects at EVERY depth: the copy_to_host_async
                # started at dispatch already overlaps the readback with
                # the next forward, so deeper windows change queue depth
                # only.
                while len(inflight) >= depth:
                    _collect(inflight.popleft())
            while inflight:
                _collect(inflight.popleft())
        finally:
            prefetcher.shutdown(wait=False, cancel_futures=True)

    def merge(self, num_shards: Optional[int] = None) -> int:
        """Merge shard stores into global.npy in shard order — host 0 only
        (reference: src/main.rs:85-105, tasks.rs:181-217). Returns the merged
        row count."""
        proc, nprocs = _process_info()
        num_shards = nprocs if num_shards is None else num_shards
        # Every ingest host must have persisted its shard BEFORE host 0
        # reads them (≙ world.barrier() before the root merge, reference:
        # src/main.rs:82) — without this, host 0 would merge half-written
        # shards from slower hosts.
        _host_barrier("pre-merge")
        count = 0
        try:
            if proc == 0:
                count = self._merge_host0(num_shards)
        finally:
            # Host 0 must reach this barrier even when the merge fails
            # (missing shard) — otherwise every other host hangs.
            _host_barrier("merge")  # ≙ main.rs:107
        return count

    def _merge_host0(self, num_shards: int) -> int:
        import json

        timer = self.bench.start("vector_store_merge")
        merged = merge_vector_stores(
            num_shards,
            self.config.store.dir,
            allow_partial=self.config.allow_partial_merge,
            force=self.config.force_merge,
        )
        merged.persist()
        count = merged.count
        # Merge per-shard row->path manifests in the same shard order the
        # embeddings merged in, keeping global indices aligned.
        from .store.vectorstore import (
            attrs_path,
            local_store_path,
            manifest_path,
        )

        all_paths: List[str] = []
        all_attrs: List = []
        have_all = True
        for s_idx in range(num_shards):
            pf = local_store_path(self.config.store.dir, s_idx).with_suffix(
                ".paths.json"
            )
            af = local_store_path(self.config.store.dir, s_idx).with_suffix(
                ".attrs.json"
            )
            if pf.exists():
                shard_paths = json.loads(pf.read_text())
                all_paths.extend(shard_paths)
                # Identity sidecar may be absent (pre-attrs shard): those
                # rows keep null identity and are never edit-detected.
                shard_attrs = (
                    json.loads(af.read_text()) if af.exists() else []
                )
                shard_attrs = shard_attrs[: len(shard_paths)]
                all_attrs.extend(
                    shard_attrs + [None] * (len(shard_paths) - len(shard_attrs))
                )
            else:
                have_all = False
        if have_all and len(all_paths) == count:
            manifest_path(self.config.store.dir).write_text(
                json.dumps(all_paths)
            )
            attrs_path(self.config.store.dir).write_text(
                json.dumps(all_attrs)
            )
            # Re-baseline the update-commit marker: a full merge defines a
            # fresh consistent (store, manifest, attrs) triple, superseding
            # any previous update()'s marker (a stale one would flag this
            # brand-new store as torn).
            from .store.vectorstore import write_update_commit

            write_update_commit(self.config.store.dir)
        else:
            # No trustworthy manifest for the rebuilt store: drop any stale
            # binding marker rather than let it flag the fresh store torn.
            from .store.vectorstore import update_commit_path

            update_commit_path(self.config.store.dir).unlink(missing_ok=True)
        self.bench.record(timer.stop(items_processed=count))
        host_log(f"merged {num_shards} shards -> {count} vectors")
        return count

    # -- phase 2: device store + search -----------------------------------------

    def load_device_store(self) -> DeviceStore:
        """global.npy -> normalized block-sharded device store. Unlike the
        reference (every rank parses the whole file, metrics.rs:23-33), each
        host parses only the row blocks its devices own. With
        ``store.use_snapshot`` a fresh snapshot of the built device
        store restores straight into device memory and is (re)written after a
        store-file load."""
        from .store.vectorstore import (
            global_store_path,
            store_row_count,
            partial_merge_marker,
        )

        cfg = self.config
        path = global_store_path(cfg.store.dir)
        marker = partial_merge_marker(cfg.store.dir)
        if marker.exists():
            if cfg.allow_partial_merge:
                host_log(
                    f"WARNING: serving a PARTIAL store ({marker.read_text()})"
                )
            else:
                raise RuntimeError(
                    f"global store at {cfg.store.dir} was published by a "
                    f"partial merge ({marker.read_text()}); re-run the "
                    "missing shards' ingest and merge again, or set "
                    "allow_partial_merge to serve it anyway"
                )
        snap_dir = Path(cfg.store.dir) / "device_cache"
        if cfg.store.use_snapshot:
            import json as _json

            from .store.device_cache import load_device_store, snapshot_exists

            meta_path = snap_dir / "device_store.json"
            if (
                snapshot_exists(snap_dir)
                and path.exists()
                and meta_path.stat().st_mtime >= path.stat().st_mtime
            ):
                try:
                    import jax.numpy as jnp

                    meta = _json.loads(meta_path.read_text())
                    # The snapshot must match the *requested* serving config:
                    # dtype changes the scores (exactness is per-dtype).
                    want = str(jnp.dtype(cfg.search.store_dtype))
                    if meta.get("dtype") != want:
                        raise ValueError(
                            f"snapshot dtype {meta.get('dtype')} != requested {want}"
                        )
                    # mtimes alone can lie (a store file restored from backup
                    # keeps its old mtime): verify the recorded source
                    # identity against the file actually on disk.
                    src = meta.get("source") or {}
                    st_now = path.stat()
                    rows_now = store_row_count(path)
                    # mtime_ns matters since incremental update(): an
                    # edit-in-place rewrite keeps rows AND byte size
                    # identical (same row count, PLAIN encoding) — only
                    # the rewrite's fresh mtime distinguishes the stale
                    # snapshot. (rows/bytes still guard the backup-restore
                    # case where mtimes lie backwards.)
                    if (
                        src.get("rows") != rows_now
                        or src.get("bytes") != st_now.st_size
                        or src.get("mtime_ns") != st_now.st_mtime_ns
                    ):
                        raise ValueError(
                            f"snapshot source {src} != store file on disk "
                            f"(rows={rows_now}, bytes={st_now.st_size}, "
                            f"mtime_ns={st_now.st_mtime_ns})"
                        )
                    store = load_device_store(snap_dir, self.mesh)
                    host_log(f"device store restored from snapshot {snap_dir}")
                    return store
                except Exception as exc:
                    host_log(f"snapshot unusable ({exc}); falling back to the store file")

        if store_row_count(path) == 0:
            raise RuntimeError(
                f"global store at {cfg.store.dir} is empty — "
                "run ingest first or unset skip_process"
            )
        store = DeviceStore.from_file_sharded(
            path,
            self.mesh,
            dtype=cfg.search.store_dtype,
            chunk_rows=cfg.search.chunk_rows,
        )
        if cfg.store.use_snapshot:
            from .store.device_cache import save_device_store

            save_device_store(
                snap_dir,
                store,
                source={
                    "rows": store_row_count(path),
                    "bytes": path.stat().st_size,
                    "mtime_ns": path.stat().st_mtime_ns,
                },
            )
            host_log(f"device store snapshot written to {snap_dir}")
        return store

    def engine(self, store: Optional[DeviceStore] = None) -> SearchEngine:
        with self._build_lock:
            if self._engine is None:
                self._engine = SearchEngine(
                    store or self.load_device_store(), self.config.search
                )
            return self._engine

    # -- text retrieval -----------------------------------------------------------

    def query(
        self, texts: Sequence[str], k: Optional[int] = None
    ) -> List[List[Tuple[str, int, float]]]:
        """Retrieve the top-k corpus files for text queries.

        Returns, per query, a ranked ``[(source path, store row, cosine
        distance)]`` list. Paths come from the row manifest written at
        ingest; when the store predates the manifest (or was built by other
        tooling), the path field degrades to ``"row:{idx}"``. The reference
        has no text-query path at all — its only query is a stored vector
        (src/main.rs:110-121).
        """
        k = self.config.search.top_k if k is None else k
        self._warn_encoder_drift("query")
        emb = self.encoder.get_embeddings(list(texts))
        engine = self.engine()
        ids, dists = engine.search(emb, k)
        # Cached + validated once per (engine, manifest) pair: re-parsing
        # and re-hashing a multi-million-row manifest per query would
        # dwarf the search itself; the cache invalidates exactly when the
        # engine does (update()/reload), so the pair stays consistent.
        manifest = self._serve_manifest(int(engine.store.num_rows))
        out: List[List[Tuple[str, int, float]]] = []
        for row_ids, row_dists in zip(ids, dists):
            ranked = []
            for idx, dist in zip(row_ids.tolist(), row_dists.tolist()):
                path = (
                    manifest[idx]
                    if manifest is not None and 0 <= idx < len(manifest)
                    else f"row:{idx}"
                )
                ranked.append((path, int(idx), float(dist)))
            out.append(ranked)
        return out

    def _warn_encoder_drift(self, where: str) -> None:
        """Warn when the current encoder's numerics differ from what the
        store's ``encoder.json`` recorded at ingest (e.g. an ``auto``
        attention default change): embeddings drift at bf16-noise level
        across implementations — not wrong, but never silent. Warns once per
        call site per Pipeline (serve runs once per TCP connection)."""
        if where in self._drift_warned:
            return
        self._drift_warned.add(where)
        from .store.vectorstore import load_encoder_meta

        recorded = load_encoder_meta(self.config.store.dir)
        current = self.encoder.numerics
        if recorded and current and recorded != current:
            diff = {
                key: (recorded.get(key), current.get(key))
                for key in sorted(set(recorded) | set(current))
                if recorded.get(key) != current.get(key)
            }
            host_log(
                f"WARNING ({where}): encoder numerics differ from the ones "
                f"that built this store (recorded vs current): {diff}. "
                "Query/stored embeddings may drift at bf16-noise level; "
                "re-ingest to realign."
            )

    # -- persistent serving ---------------------------------------------------

    def serve(self, requests, k: Optional[int] = None, depth: int = 1,
              batcher=None):
        """Pipelined request/response serving over the streaming search path.

        ``batcher`` (a :class:`..batcher.DynamicBatcher`, usually shared
        across TCP connections) re-routes dispatches through dynamic
        micro-batching: requests from MANY streams landing within the
        batcher's window coalesce into one fixed-shape device dispatch —
        the many-concurrent-clients serving regime (``--serve-window-ms``).
        Responses are identical (same compiled program as a direct search
        of the coalesced rows; each request reads back its own row slice);
        the in-order, flush-token and error semantics below are unchanged.
        Text requests take the host-embedding path when batching (the
        device-resident encoder fast path cannot join a host-side batch).

        ``requests`` is any iterator of request dicts (the ``bsr serve``
        JSONL protocol); yields exactly one response dict per request, in
        request order. Up to ``depth`` searches stay in flight on the device
        while earlier results transfer back (async dispatch + async
        device->host copies). A ``None`` item is a FLUSH token, not a
        request: every in-flight response is emitted before the next item is
        consumed. The CLI reader yields one whenever its input has no line
        ready, so a synchronous request/response client always gets its
        answer without having to send more traffic (without flush tokens, a
        generator cannot overlap "wait for input" with "deliver output").

        Request protocol — exactly one of:

        * ``{"query": "text"}`` — encode one text and search
        * ``{"queries": ["a", "b"]}`` — a batch of texts (one dispatch)
        * ``{"vector": [...]}`` / ``{"vectors": [[...]]}`` — raw embeddings,
          encoder bypassed (must match the store/encoder dim)

        plus optional ``"id"`` (echoed back verbatim) and ``"k"`` (trimmed
        client-side; must be <= the serve-wide ``k`` the engine was compiled
        for). Responses: ``{"id", "results": [[{path, row, distance}, ...]
        per query]}`` or ``{"id", "error": "..."}``. A bad request never
        kills the stream — it produces an in-order error response (emitted
        immediately when nothing is in flight) and serving continues.

        ``{"cmd": "reload"}`` hot-reloads the store: every in-flight search
        drains, then the engine, device store and row manifest rebuild from
        disk — the companion of incremental :meth:`update` (run ``update``
        in another process, send ``reload``, and the live server serves the
        reconciled store without a restart; the reference would re-launch
        the whole binary). Response: ``{"id", "reloaded": true, "rows": N}``.
        Through a shared ``batcher`` the reload HOT-SWAPS the batcher's
        engine (``DynamicBatcher.swap_engine``): other connections keep
        serving without interruption — in-flight batches finish on the old
        store and every response formats with the manifest of the
        generation that served it (futures are generation-tagged), so a
        swap landing between a request's submit and its dispatch still
        yields correct paths. Note both device stores are resident until
        the old engine's last reference drops; on a memory-tight card prefer
        per-connection (batcher-less) serving for reloads.

        Client-controlled batch sizes are padded up to a small set of fixed
        shapes (powers of two to 1024, then multiples of 1024) before
        dispatch, so a long-lived server compiles O(log max_batch) programs
        instead of one per distinct size (CLAUDE.md invariant: fixed shapes
        everywhere under jit); pad rows replicate the last query and are
        trimmed from the response.

        The reference's only serving story is re-running the binary with
        ``SKIP_PROCESS=true`` for a single hardcoded query index
        (src/main.rs:42-45,110-121); a persistent accept-loop is new
        capability, but the retrieval semantics per request are exactly
        :meth:`query`'s.
        """
        from collections import deque

        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        k_serve = self.config.search.top_k if k is None else k
        self._warn_encoder_drift("serve")
        engine = self.engine()
        if batcher is not None and batcher.k < min(k_serve, engine.store.num_rows):
            raise ValueError(
                f"batcher was built for k={batcher.k} < serve-wide "
                f"top_k={k_serve}; build it with k >= the serve k"
            )
        manifest = self._serve_manifest(int(engine.store.num_rows))
        if batcher is not None:
            # Register this store's manifest for the batcher's current
            # generation: after a hot swap (possibly by ANOTHER connection)
            # each resolved future formats with the manifest matching the
            # engine that actually served it. register_manifest guards on
            # engine identity under the batcher lock: if this Pipeline's
            # cache was invalidated (an in-process ``update()``) and a
            # fresh connection rebuilt a NEW engine before anyone called
            # ``swap_engine``, filing the new store's manifest for the OLD
            # engine's generation would silently row-shift formatted
            # paths. On refusal, futures fail safe to ``row:N``.
            batcher.register_manifest(engine, manifest)
        meta: deque = deque()  # ("error", resp) | ("ok", id, k_req, nq)
        bufs: deque = deque()  # async search handles, aligned with "ok" metas

        def _parse(req):
            """-> (embeddings [Q, dim] f32, req_id, k_req); raises ValueError."""
            if isinstance(req, MalformedRequest):
                raise ValueError(f"malformed JSON: {req.error}")
            if not isinstance(req, dict):
                raise ValueError(f"request must be a JSON object, got {type(req).__name__}")
            req_id = req.get("id")
            k_req = req.get("k", k_serve)
            if isinstance(k_req, bool) or not isinstance(k_req, int) or k_req <= 0:
                raise ValueError(f"k must be a positive integer, got {k_req!r}")
            if k_req > k_serve:
                raise ValueError(
                    f"k={k_req} exceeds the serve-wide top_k={k_serve} the "
                    "engine was started with; restart serve with a larger --top-k"
                )
            kinds = [key for key in ("query", "queries", "vector", "vectors") if key in req]
            if len(kinds) != 1:
                raise ValueError(
                    "request needs exactly one of query/queries/vector/vectors"
                    f" (got {kinds or 'none'})"
                )
            kind = kinds[0]
            if kind in ("query", "queries"):
                texts = [req["query"]] if kind == "query" else list(req["queries"])
                if not texts:
                    raise ValueError("queries must be non-empty")
                if not all(isinstance(t, str) for t in texts):
                    raise ValueError("query texts must be strings")
                # Serve fast path: keep the embeddings ON DEVICE and hand
                # them straight to search — skips the synchronous
                # embeddings readback AND the query re-upload (two
                # host<->device round trips per text request). Backends
                # without a device forward (or window pooling) fall back
                # to the host path; results are bitwise identical either
                # way (an f32 round trip is lossless).
                emb = (
                    None if batcher is not None
                    else self.encoder.get_embeddings_device(texts)
                )
                if emb is None:
                    emb = self.encoder.get_embeddings(texts)
            else:
                vecs = [req["vector"]] if kind == "vector" else list(req["vectors"])
                if not vecs:
                    raise ValueError("vectors must be non-empty")
                emb = np.asarray(vecs, dtype=np.float32)
                if emb.ndim != 2:
                    raise ValueError(f"vectors must be rank-2, got shape {emb.shape}")
            # Fail bad dims HERE (per-request error response), not inside the
            # already-running stream; acceptance mirrors engine._prepare_queries.
            # In batcher mode validate against the batcher's CURRENT engine:
            # a hot swap by another connection may have changed the
            # matryoshka acceptance, and this connection's local engine
            # snapshot would reject (or accept) queries the serving store
            # doesn't.
            store = (batcher.engine if batcher is not None else engine).store
            if emb.shape[1] != store.dim and not (
                store.matryoshka_from is not None
                and emb.shape[1] == store.matryoshka_from
            ):
                raise ValueError(
                    f"query dim {emb.shape[1]} != store dim {store.dim}"
                )
            return emb, req_id, k_req

        def _path(idx: int, m=_UNSET) -> str:
            m = manifest if m is _UNSET else m
            if m is not None and 0 <= idx < len(m):
                return m[idx]
            return f"row:{idx}"

        def _drain(target: int):
            """Emit responses until at most ``target`` searches stay in
            flight. Head-of-queue errors are always emittable (every earlier
            response is already out)."""
            while meta and meta[0][0] == "error":
                yield meta.popleft()[1]
            while len(bufs) > target:
                handle = bufs.popleft()
                m = _UNSET
                if batcher is not None:
                    _, req_id, k_req, nq = meta.popleft()
                    try:
                        ids, dists = handle.result()
                    except Exception as exc:  # noqa: BLE001 — one batch
                        # failing (e.g. a poisoned co-batched request) must
                        # answer in order, not kill every other stream.
                        yield {"id": req_id, "error": f"search failed: {exc}"}
                        while meta and meta[0][0] == "error":
                            yield meta.popleft()[1]
                        continue
                    # Format with the manifest of the generation that
                    # served this future (a hot swap may have landed
                    # between submit and dispatch). A generation pruned
                    # from the window (a client-paced connection sitting
                    # on an undrained handle across many reloads) degrades
                    # to "row:N" — fail safe, never a stale manifest's
                    # silently wrong path.
                    fut_gen = getattr(handle, "generation", None)
                    if fut_gen is not None:
                        m = batcher.manifest_by_gen.get(fut_gen, None)
                else:
                    ids, dists = engine.collect(handle)
                    _, req_id, k_req, nq = meta.popleft()
                results = [
                    [
                        {"path": _path(int(i), m), "row": int(i),
                         "distance": float(d)}
                        for i, d in zip(row_ids[:k_req], row_dists[:k_req])
                    ]
                    for row_ids, row_dists in zip(
                        ids[:nq].tolist(), dists[:nq].tolist()
                    )
                ]
                yield {"id": req_id, "results": results}
                while meta and meta[0][0] == "error":
                    yield meta.popleft()[1]

        for req in requests:
            if req is None:  # flush token: answer everything in flight
                yield from _drain(0)
                continue
            if isinstance(req, dict) and req.get("cmd") == "reload":
                rid = req.get("id")
                if batcher is not None:
                    # Shared-batcher hot swap: build the NEW engine first
                    # (the batcher and other connections keep serving the
                    # old store meanwhile — note both stores are resident
                    # until the old engine's last reference drops), then
                    # swap atomically with its manifest so every future
                    # formats against the store that served it.
                    yield from _drain(0)  # in-order response discipline
                    try:
                        with self._build_lock:
                            self._engine = None
                            self._manifest_cache = _UNSET
                            new_engine = self.engine()
                            new_manifest = self._serve_manifest(
                                int(new_engine.store.num_rows)
                            )
                        batcher.swap_engine(new_engine, new_manifest)
                    except Exception as exc:  # noqa: BLE001 — mid-update
                        with self._build_lock:
                            self._engine = None
                            self._manifest_cache = _UNSET
                        yield {"id": rid,
                               "error": f"reload failed: {exc}; retry reload"}
                        continue
                    engine = new_engine
                    manifest = new_manifest
                    self._warn_encoder_drift("serve")
                    yield {"id": rid, "reloaded": True,
                           "rows": int(new_engine.store.num_rows)}
                    continue
                yield from _drain(0)  # old-engine handles must finish first
                # Drop every reference to the old engine BEFORE building
                # the new one: the device store can occupy most of device
                # memory, so two resident copies would OOM and kill the
                # server. The build
                # lock makes clear+rebuild atomic against other connection
                # threads' engine() calls.
                engine = None
                manifest = None
                try:
                    with self._build_lock:
                        self._engine = None
                        self._manifest_cache = _UNSET
                        engine = self.engine()
                        manifest = self._serve_manifest(
                            int(engine.store.num_rows)
                        )
                except Exception as exc:  # noqa: BLE001 — reload mid-update
                    # A reload landing mid-update can pair the NEW store file
                    # with the OLD manifest (ADVICE r3): answer a retryable
                    # error instead of serving a misaligned pair. The next
                    # request (or reload) rebuilds from scratch.
                    with self._build_lock:
                        self._engine = None
                        self._manifest_cache = _UNSET
                    engine = None
                    manifest = None
                    yield {"id": rid,
                           "error": f"reload failed: {exc}; retry reload"}
                    continue
                self._warn_encoder_drift("serve")
                yield {"id": rid, "reloaded": True,
                       "rows": int(engine.store.num_rows)}
                continue
            if engine is None and batcher is None:
                # A previous reload failed (store mid-update): retry the
                # rebuild per request so the server heals once the update
                # commits, answering retryable errors meanwhile. Must run
                # before _parse (dim validation reads engine.store).
                try:
                    with self._build_lock:
                        engine = self.engine()
                        manifest = self._serve_manifest(
                            int(engine.store.num_rows)
                        )
                except Exception as exc:  # noqa: BLE001
                    with self._build_lock:
                        self._engine = None
                        self._manifest_cache = _UNSET
                    engine = None
                    rid = req.get("id") if isinstance(req, dict) else None
                    meta.append(("error", {
                        "id": rid,
                        "error": f"store unavailable: {exc}; retry",
                    }))
                    yield from _drain(depth)
                    continue
            try:
                emb, req_id, k_req = _parse(req)
            except Exception as exc:  # noqa: BLE001 — bad request != dead server
                rid = req.get("id") if isinstance(req, dict) else None
                meta.append(("error", {"id": rid, "error": str(exc)}))
                yield from _drain(depth)
                continue
            nq = emb.shape[0]
            if batcher is not None:
                # The batcher pads/coalesces itself and resolves to exactly
                # this request's rows. submit() re-validates against the
                # batcher's CURRENT store (authoritative across hot swaps)
                # and raises on mismatch or a closed batcher — answer an
                # in-order error, never kill the stream. Submit BEFORE
                # appending meta so a raise leaves no orphaned entry.
                try:
                    handle = batcher.submit(emb)
                except Exception as exc:  # noqa: BLE001
                    meta.append(("error", {"id": req_id, "error": str(exc)}))
                    yield from _drain(depth)
                    continue
                meta.append(("ok", req_id, k_req, nq))
                bufs.append(handle)
                yield from _drain(depth)
                continue
            padded = _serve_batch_shape(nq)
            if padded != nq:
                # Pad rows by replicating the last query (trimmed from the
                # response) — with jnp for device-resident embeddings so the
                # fast path never bounces through the host.
                import jax
                import jax.numpy as jnp

                xp = jnp if isinstance(emb, jax.Array) else np
                emb = xp.concatenate(
                    [emb, xp.repeat(emb[-1:], padded - nq, axis=0)], axis=0
                )
            meta.append(("ok", req_id, k_req, nq))
            bufs.append(
                engine.search_async(
                    emb, k_serve, upload=self.config.search.query_upload
                )
            )
            yield from _drain(depth)
        yield from _drain(0)

    def _serve_manifest(self, num_rows: Optional[int] = None):
        """The row->file manifest, read once per Pipeline (every TCP
        connection runs its own :meth:`serve`; re-parsing a multi-million-row
        manifest per connection is pure waste). With ``num_rows`` the load is
        validated against the store before caching."""
        with self._build_lock:
            if self._manifest_cache is _UNSET:
                self._manifest_cache = self._validated_manifest(num_rows)
            return self._manifest_cache

    def _validated_manifest(self, num_rows: Optional[int]):
        """Load the row->path manifest, refusing torn or misaligned
        (store, manifest) pairs.

        Two hazards both yield silently wrong paths for every row after a
        shifted index: an ``update()`` that crashed between its atomic
        renames (detected by the update-commit marker), and a reload that
        lands mid-update, pairing the NEW store file with the OLD manifest
        (detected by the row-count cross-check). Raising here turns both
        into a loud, retryable error instead of wrong answers."""
        from .store.vectorstore import load_manifest, validate_update_commit

        torn = validate_update_commit(self.config.store.dir)
        if torn:
            raise RuntimeError(f"refusing to serve a torn store: {torn}")
        manifest = load_manifest(self.config.store.dir)
        if (manifest is not None and num_rows is not None
                and len(manifest) != num_rows):
            raise RuntimeError(
                f"row manifest ({len(manifest)} paths) does not match the "
                f"store ({num_rows} rows) — an update() may be writing "
                "concurrently; retry once it completes"
            )
        return manifest

    def update(self) -> IngestStats:
        """Incremental ingest: reconcile the global store with the corpus.

        Three reconciliations, none of which the reference has (its only
        refresh path is a full rebuild, src/main.rs:85-105):

        * **new** files (absent from the row->path manifest) are embedded and
          appended;
        * **edited** files are detected via the per-row identity triple
          ``[size, mtime_ns, content-fingerprint]`` recorded at ingest
          (size+mtime as the no-read fast path, fingerprint as truth) and
          re-embedded IN PLACE — their global row index is stable;
        * **deleted** files (or files that became unreadable/oversized) have
          their rows compacted away — row indices after a deleted row shift
          down, and the rewritten manifest is the authority.

        Rows from pre-identity stores (null attrs) are append-only: kept
        verbatim, never edit-detected. Embedding work rides the same 3-stage
        pipelined loop as ingest. Single-host operation (runs on host 0;
        other hosts just resync their engine after the barrier)."""
        import json
        import os as _os

        from .corpus.walker import content_fingerprint, read_file
        from .store.vectorstore import (
            attrs_path,
            global_ahead_marker,
            load_attrs,
            load_manifest,
            manifest_path,
        )

        cfg = self.config
        proc, _ = _process_info()
        stats = IngestStats()
        if proc != 0:
            try:
                _host_barrier("update")
            finally:
                # Host 0 may have rewritten the store: this host's cached
                # engine (and its device store) is stale the moment the
                # barrier releases — and so is the cached row->path
                # manifest (rows may have shifted). Reload lazily on next
                # use so every host serves the same store version.
                self._engine = None
                self._manifest_cache = _UNSET
            return stats

        # Host 0 must reach the barrier even on failure — otherwise every
        # other host hangs in sync_global_devices.
        try:
            files = find_files_by_extensions(
                cfg.corpus.root, cfg.corpus.extensions
            )
            stats.files_found = len(files)
            manifest = load_manifest(cfg.store.dir) or []
            attrs = load_attrs(cfg.store.dir) or []
            attrs = (attrs + [None] * len(manifest))[: len(manifest)]
            if not files and manifest:
                # An empty enumeration against a populated store is far
                # more likely a bad/unmounted root or a config typo than a
                # real mass deletion — compacting here would silently WIPE
                # the whole store. Destroying everything requires an
                # explicit full ingest.
                raise RuntimeError(
                    f"update: no files found under {cfg.corpus.root} "
                    f"(extensions {cfg.corpus.extensions}) but the store "
                    f"holds {len(manifest)} rows — refusing to compact "
                    "everything away; check the corpus root, or run a "
                    "full ingest to rebuild intentionally"
                )
            known = set(manifest)
            fset = {str(f) for f in files}
            new_files = [f for f in files if str(f) not in known]
            stats.files_assigned = len(new_files)

            from .store.vectorstore import global_store_path, store_row_count

            store_rows = store_row_count(global_store_path(cfg.store.dir))
            if store_rows != len(manifest):
                raise RuntimeError(
                    f"manifest ({len(manifest)} paths) out of sync with store "
                    f"({store_rows} rows) — rebuild with a full ingest"
                )
            from .store.vectorstore import validate_update_commit

            torn = validate_update_commit(cfg.store.dir)
            if torn:
                raise RuntimeError(f"update: torn store detected: {torn}")

            # Classify every existing row: deleted / edited / identity-
            # refresh (touched but content-identical) / unchanged.
            deleted: List[int] = []
            edited_rows: Dict[str, int] = {}  # path -> row index
            edited_attr: Dict[str, list] = {}  # path -> classification attr
            refresh: Dict[int, Optional[list]] = {}  # row -> new identity
            pre_attrs_rows = 0
            for i, (p, a) in enumerate(zip(manifest, attrs)):
                if p not in fset:
                    deleted.append(i)
                    continue
                if a is None:
                    pre_attrs_rows += 1
                    continue  # no recorded identity: keep as-is
                try:
                    st = _os.stat(p)
                except OSError:
                    deleted.append(i)
                    continue
                if st.st_size == a[0] and st.st_mtime_ns == a[1]:
                    continue  # unchanged (no read needed)
                content = read_file(p, cfg.corpus.max_file_bytes)
                if not content:
                    # Now unreadable, over the size cap, or truncated to
                    # EMPTY — ingest never stores empty files, so the row
                    # must go (classifying empties as "edited" would hit
                    # the pipeline's empty-content filter and leave the
                    # stale embedding served forever).
                    deleted.append(i)
                    continue
                fp = content_fingerprint(content)
                if fp == a[2]:
                    refresh[i] = [st.st_size, st.st_mtime_ns, a[2]]
                else:
                    edited_rows[p] = i
                    # Classification-time identity: the fallback when the
                    # re-embed pass's own stat fails (ADVICE r3: writing
                    # None there would permanently demote a just-re-embedded
                    # row to the never-edit-detected class). Conservative:
                    # if the file changes again before the re-embed reads
                    # it, the next update re-detects via mtime/fingerprint.
                    edited_attr[p] = [st.st_size, st.st_mtime_ns, fp]
            if pre_attrs_rows:
                host_log(
                    f"update: {pre_attrs_rows} rows have no recorded file "
                    "identity (pre-attrs store) — edits to those files are "
                    "undetectable; run a full ingest to record identities"
                )

            if not (new_files or edited_rows or deleted or refresh):
                host_log("update: store already covers the corpus")
                return stats

            self._warn_encoder_drift("update")
            timer = self.bench.start("embedding_generation")

            # Re-embeds and new-file embeds share one pipelined pass.
            replacements: Dict[int, np.ndarray] = {}
            appended: List[np.ndarray] = []
            new_paths: List[str] = []
            new_attrs: List = []
            to_embed = [Path(p) for p in edited_rows] + list(new_files)

            def on_batch(batch_idx, files_through, kept, emb) -> None:
                if emb is None or not kept:
                    return
                for (p, _c, a), vec in zip(kept, emb):
                    sp = str(p)
                    row = edited_rows.get(sp)
                    if row is not None:
                        replacements[row] = np.asarray(vec, dtype=np.float32)
                        refresh[row] = a if a is not None else edited_attr.get(sp)
                    else:
                        appended.append(np.asarray(vec, dtype=np.float32))
                        new_paths.append(sp)
                        new_attrs.append(a)

            if to_embed:
                self._embed_paths_pipelined(to_embed, stats, on_batch)
            stats.rows_reembedded = len(replacements)
            stats.rows_deleted = len(deleted)
            stats.embeddings = len(appended)

            store_changed = bool(replacements or deleted or appended)
            if store_changed:
                # The store matrix is only materialized on the rewrite
                # branch — a no-op update never loads row data (the count
                # check above reads the store file's header only). take_matrix
                # detaches the store's own buffer (at most ONE materialized
                # copy, never the transient 2x of copy-on-top — ~60 GB for
                # a 10M x 768 f32 store) and edits land in place.
                gstore = global_store(cfg.store.dir, empty=False)
                mat = gstore.take_matrix()
                for i, vec in replacements.items():
                    mat[i] = vec
                for i, a in refresh.items():
                    attrs[i] = a
                if deleted:
                    keep = np.ones(len(manifest), dtype=bool)
                    keep[deleted] = False
                    if mat.size:
                        # In-place blocked compaction: shift kept rows down
                        # without materializing a second full matrix.
                        write = 0
                        blk = 65536
                        for start in range(0, len(manifest), blk):
                            sel = keep[start:start + blk]
                            n = int(sel.sum())
                            if n:
                                mat[write:write + n] = \
                                    mat[start:start + blk][sel]
                                write += n
                        mat = mat[:write]
                    manifest = [p for j, p in enumerate(manifest) if keep[j]]
                    attrs = [a for j, a in enumerate(attrs) if keep[j]]
                if mat.size:
                    gstore.append_many(mat)
                if appended:
                    gstore.append_many(np.stack(appended))
                    manifest.extend(new_paths)
                    attrs.extend(new_attrs)
                gstore.persist()  # atomic (tmp+rename inside)
            else:
                for i, a in refresh.items():
                    attrs[i] = a

            for path, payload in (
                (manifest_path(cfg.store.dir), manifest),
                (attrs_path(cfg.store.dir), attrs),
            ):
                tmp = path.with_suffix(f".{_os.getpid()}.tmp")
                tmp.write_text(json.dumps(payload))
                _os.replace(tmp, path)
            # COMMIT POINT (mirrors ingest's .progress discipline): the
            # marker binds the just-renamed (store, manifest, attrs) triple;
            # a crash before this line leaves a torn state that
            # validate_update_commit detects and loaders refuse.
            from .store.vectorstore import write_update_commit

            write_update_commit(cfg.store.dir)

            if store_changed:
                # global.npy has now DIVERGED from the rank_*.npy
                # shards (edits/deletions/appends live in no shard), so a
                # later merge() would rebuild global without them. The marker
                # makes merge refuse until a full re-ingest (or an explicit
                # force_merge).
                global_ahead_marker(cfg.store.dir).write_text(
                    json.dumps(
                        {
                            "rows": gstore.count,
                            "appended": stats.embeddings,
                            "reembedded": stats.rows_reembedded,
                            "deleted": stats.rows_deleted,
                        }
                    )
                )
            self.bench.record(
                timer.stop(
                    items_processed=stats.embeddings + stats.rows_reembedded
                )
            )
            host_log(
                f"update: appended {stats.embeddings} embeddings, "
                f"re-embedded {stats.rows_reembedded} rows, deleted "
                f"{stats.rows_deleted} rows ({stats.files_skipped} skipped)"
            )
            return stats
        finally:
            _host_barrier("update")
            self._engine = None  # stale device store: force a reload
            self._manifest_cache = _UNSET  # rows may have shifted

    def evaluate(
        self, num_queries: int = 64, k: Optional[int] = None
    ) -> Dict[str, float]:
        """Batch retrieval-quality report over the stored corpus.

        Uses ``num_queries`` stored rows (evenly spaced) as self-retrieval
        queries and reports batch MRR / recall@k (each row must retrieve
        itself) plus top-k overlap between the engine and the serial oracle
        (must be 1.0 — the reference's parallel-vs-sequential exactness
        check, src/metrics.rs:98-141, which it only ever ran in unit tests).
        """
        from .metrics.quality import (
            mean_reciprocal_rank,
            recall_at_k,
            top_k_overlap,
        )

        k = self.config.search.top_k if k is None else k
        engine = self.engine()
        n = engine.store.num_rows
        num_queries = min(num_queries, n)
        q_rows = np.linspace(0, n - 1, num_queries, dtype=np.int64)
        queries = engine.effective_store()[q_rows]

        timer = self.bench.start("similarity_search")
        ids, _dists = engine.search(queries, k)
        self.bench.record(timer.stop(items_processed=n * num_queries))

        timer = self.bench.start("metrics_calculation")
        o_ids, _ = engine.oracle_topk(queries, k)
        results = ids.tolist()
        report = {
            "num_queries": float(num_queries),
            "k": float(min(k, n)),
            "mrr": mean_reciprocal_rank(q_rows.tolist(), results),
            "recall_at_k": recall_at_k(q_rows.tolist(), results, k),
            "oracle_overlap": top_k_overlap(o_ids.tolist(), results, k),
        }
        self.bench.record(timer.stop())
        return report

    # -- full driver --------------------------------------------------------------

    def run(self) -> PipelineResult:
        """The whole reference ``main()`` (src/main.rs:25-189): optional
        ingest+merge, self-retrieval search, accuracy metrics, benchmark
        report."""
        cfg = self.config
        total = self.bench.start("total_execution")
        ingest_stats = None
        if not cfg.skip_process:  # reference: main.rs:42-45
            ingest_stats = self.ingest_shard()
            self.merge()

        engine = self.engine()
        store = engine.store

        # Query = stored vector ``query_idx`` (reference: main.rs:110-121).
        # The reference root-reads it then MPI-broadcasts (main.rs:123-125);
        # here one row is sliced out of the store file and replication is implicit.
        from .store.vectorstore import global_store_path, read_matrix_slice

        query = read_matrix_slice(
            global_store_path(cfg.store.dir), cfg.search.query_idx, 1
        )[0]

        timer = self.bench.start("similarity_search")
        top_k = engine.search_single(query, cfg.search.top_k)
        # items unit for similarity_search = (query, row) comparisons
        # everywhere (1 query x num_rows here; evaluate() and the JabRef
        # suite record n * num_queries), so the report's items/s column is
        # comparable across code paths.
        self.bench.record(timer.stop(items_processed=store.num_rows * 1))

        timer = self.bench.start("metrics_calculation")
        mrr, recall, overlap = accuracy_metrics_for_query(
            top_k, cfg.search.query_idx, cfg.search.top_k
        )
        self.bench.record(timer.stop())

        self.bench.record(total.stop())
        sequential_times = None
        if cfg.measure_serial_baseline:
            # Sequential anchor for the report's speedup column: the same
            # single-query scan, NumPy on the host (argpartition selection).
            import time as _time

            eff = engine.effective_store()
            qv = np.asarray(query, dtype=np.float32)[: eff.shape[1]]
            t0 = _time.perf_counter()
            from .ops.topk import serial_topk

            serial_topk(eff, qv, cfg.search.top_k)
            sequential_times = {
                "similarity_search": _time.perf_counter() - t0
            }
        report = self.bench.generate_report(sequential_times)
        return PipelineResult(
            top_k=top_k,
            mrr=mrr,
            recall=recall,
            overlap=overlap,
            num_vectors=store.num_rows,
            report=report,
            ingest=ingest_stats,
        )
