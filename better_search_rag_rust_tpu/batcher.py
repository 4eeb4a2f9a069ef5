"""Dynamic cross-request micro-batching for the serving path.

The reference's only serving story is one process per query run
(src/main.rs:42-45 ``SKIP_PROCESS``); the JSONL server already generalizes
that to persistent per-connection streams (``Pipeline.serve``). This module
adds the third serving regime: MANY concurrent low-rate clients. Without it,
every single-query request pays one full device dispatch (dispatch
overhead + a Q=1 program) — with it, requests arriving within a small
window are coalesced into ONE fixed-shape batch dispatch and the
per-request cost collapses to its slice of a wide, matmul-efficient
program.

Shaped for a compiled accelerator program by construction:

* coalesced batches are padded to the same O(log max_batch) shape ladder the
  per-connection server uses (powers of two, then multiples of 1024), so a
  long-lived server still compiles a handful of programs total;
* forming a batch never blocks the device: the former thread dispatches
  asynchronously and hands the in-flight handle to a collector thread, so
  batch i+1 accumulates while batch i computes (the same
  dispatch-then-collect overlap as ``SearchEngine.search_stream``);
* a bounded in-flight queue applies backpressure instead of queueing
  unbounded device work.

Exactness is untouched: a batched dispatch runs the identical compiled
program a ``search(queries)`` of the concatenated rows would run, and each
request reads back exactly its own row slice.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["DynamicBatcher", "BatcherStats"]


def _addressable_bytes_limit(arrays) -> int:
    """Total ``bytes_limit`` over the device set holding ``arrays``
    (0 = unknown — platforms without memory stats, e.g. CPU emulation).
    Module-level so tests can inject a limit without a real chip."""
    devices = {d for a in arrays for d in a.devices()}
    return sum(
        (d.memory_stats() or {}).get("bytes_limit", 0) for d in devices
    )


@dataclass
class BatcherStats:
    """Counters for observability/tests (snapshot under the batcher lock)."""

    requests: int = 0  #: submit() calls accepted
    queries: int = 0  #: total query rows submitted
    batches: int = 0  #: device dispatches issued
    batched_queries: int = 0  #: rows dispatched (== queries once drained)

    def coalescing(self) -> float:
        """Mean queries per dispatch (1.0 = no coalescing happened)."""
        return self.batched_queries / self.batches if self.batches else 0.0


@dataclass
class _Pending:
    emb: np.ndarray
    nq: int
    future: "Future[Tuple[np.ndarray, np.ndarray]]" = field(
        default_factory=Future
    )


class DynamicBatcher:
    """Coalesce concurrent search requests into shared device dispatches.

    ``submit(embeddings)`` returns a :class:`concurrent.futures.Future`
    resolving to ``(indices, distances)`` for exactly the submitted rows —
    the same values ``engine.search(embeddings, k)`` would return. Requests
    are accumulated until ``max_batch`` rows are waiting or ``window_ms``
    has passed since the batch opened, then dispatched as one padded batch.

    ``depth`` bounds the number of dispatched-but-uncollected batches; a
    full queue blocks the former (backpressure), never the device.
    """

    def __init__(
        self,
        engine,
        k: Optional[int] = None,
        max_batch: int = 1024,
        window_ms: float = 2.0,
        depth: int = 2,
        upload: str = "f32",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if window_ms < 0:
            raise ValueError(f"window_ms must be >= 0, got {window_ms}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.engine = engine
        self.k = engine._resolve_k(k)
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.upload = upload
        self.stats = BatcherStats()
        #: Bumped by :meth:`swap_engine`. Every resolved future carries the
        #: ``generation`` of the engine that served it, and
        #: :attr:`manifest_by_gen` maps generations to row->path manifests —
        #: so serve loops sharing this batcher always format a response
        #: with the manifest matching the store that produced its row ids,
        #: even when a hot swap lands between submit and dispatch.
        self.generation = 0
        self.manifest_by_gen: dict = {}
        self._requested_k = k
        self._dim = engine.store.dim
        self._mat_from = engine.store.matryoshka_from

        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._pending: List[_Pending] = []
        self._pending_rows = 0
        self._closed = False

        import queue

        self._inflight: "queue.Queue" = queue.Queue(maxsize=depth)
        self._former = threading.Thread(
            target=self._form_loop, name="bsr-batch-former", daemon=True
        )
        self._collector = threading.Thread(
            target=self._collect_loop, name="bsr-batch-collector", daemon=True
        )
        self._former.start()
        self._collector.start()

    # -- client side ---------------------------------------------------------

    def submit(
        self, embeddings: np.ndarray
    ) -> "Future[Tuple[np.ndarray, np.ndarray]]":
        """Queue ``[Q, dim]`` f32 embeddings (or ``[dim]``, auto-promoted)
        for the next coalesced dispatch. Dim mismatches raise HERE (the
        caller's request is bad; the shared batch must not die for it)."""
        emb = np.atleast_2d(np.asarray(embeddings, dtype=np.float32))
        if emb.shape[1] != self._dim and not (
            self._mat_from is not None and emb.shape[1] == self._mat_from
        ):
            raise ValueError(
                f"query dim {emb.shape[1]} != store dim {self._dim}"
            )
        if self._mat_from is not None and emb.shape[1] == self._mat_from:
            emb = np.ascontiguousarray(emb[:, : self._dim])
        item = _Pending(emb=emb, nq=emb.shape[0])
        with self._nonempty:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._pending.append(item)
            self._pending_rows += item.nq
            self.stats.requests += 1
            self.stats.queries += item.nq
            self._nonempty.notify_all()
        return item.future

    def register_manifest(self, engine, manifest) -> bool:
        """Register ``manifest`` for the CURRENT generation iff the batcher
        still serves ``engine`` — the engine the manifest describes.

        Serve loops call this instead of writing :attr:`manifest_by_gen`
        directly: if the caller's pipeline rebuilt its engine (cache
        invalidated by an in-process ``update()``) while the batcher still
        holds the old one, filing the NEW store's manifest under the OLD
        engine's generation would format old-store row ids with new-store
        paths — silently row-shifted. Returns whether it registered; on
        ``False`` callers fall back to ``row:N`` formatting (fail safe).
        An existing manifest for the generation is never overwritten
        (first registration wins — same setdefault semantics concurrent
        serve loops relied on)."""
        with self._lock:
            if self.engine is not engine:
                return False
            self.manifest_by_gen.setdefault(self.generation, manifest)
            return True

    def _check_swap_memory(self, engine, force: bool) -> None:
        """Refuse a swap whose transient double-residency (old + new device
        store, both live until in-flight handles drop) cannot fit device
        memory. Platforms without ``memory_stats`` (CPU emulation) skip the
        check — host RAM is the only bound there."""
        if force:
            return
        try:
            old_bytes = int(self.engine.store.data.nbytes)
            new_bytes = int(engine.store.data.nbytes)
            limit = _addressable_bytes_limit(
                (self.engine.store.data, engine.store.data))
        except Exception:
            return
        if limit and old_bytes + new_bytes > 0.9 * limit:
            raise RuntimeError(
                f"swap_engine: old ({old_bytes / 1e9:.2f} GB) + new "
                f"({new_bytes / 1e9:.2f} GB) device stores exceed 90% of "
                f"addressable device memory ({limit / 1e9:.2f} GB); the "
                "transient double-residency would OOM mid-serve. Use the "
                "batcher-less drain-then-rebuild reload (drops the old "
                "store first), or pass force=True if the headroom is real."
            )

    def swap_engine(self, engine, manifest=None, force: bool = False) -> int:
        """Hot-swap the engine behind the batcher (the shared-batcher arm
        of serve's ``{"cmd": "reload"}``): dispatches formed AFTER the swap
        run on the new engine; batches already in flight finish on the old
        one and resolve normally (their futures carry the OLD generation).
        The store dim must match (clients' queries were validated against
        it); ``k`` re-resolves against the new store's row count.
        ``manifest`` is the new store's row->path manifest, registered in
        :attr:`manifest_by_gen` atomically with the generation bump so no
        dispatch can observe the new generation without its manifest.
        Returns the new generation.

        Memory caveat: both device stores are resident until the old
        engine's last reference drops (in-flight handles + callers) — on a
        memory-tight card prefer the batcher-less serve reload, which drops
        the old store before building the new one. When the combined
        resident footprint would exceed ~90% of addressable device memory
        (e.g. swapping a store larger than half of it), this method refuses
        up front rather than
        letting the allocator OOM mid-serve and kill the server; pass
        ``force=True`` to override (multi-chip meshes with headroom)."""
        self._check_swap_memory(engine, force)
        if engine.store.dim != self._dim:
            raise ValueError(
                f"swap_engine: store dim {engine.store.dim} != the dim "
                f"this batcher was built for ({self._dim})"
            )
        k_new = engine._resolve_k(self._requested_k)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self.engine = engine
            self.k = k_new
            self._mat_from = engine.store.matryoshka_from
            self.generation += 1
            self.manifest_by_gen[self.generation] = manifest
            # Bound memory across many reloads (a multi-million-row
            # manifest is big): keep a window of recent generations —
            # in-flight futures can only be a few dispatches old (the
            # inflight queue is depth-bounded), so anything 8 swaps back
            # is unreachable.
            for g in [g for g in self.manifest_by_gen
                      if g < self.generation - 8]:
                del self.manifest_by_gen[g]
            return self.generation

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work, drain everything in flight, join threads."""
        with self._nonempty:
            if self._closed:
                return
            self._closed = True
            self._nonempty.notify_all()
        self._former.join(timeout=timeout)
        self._inflight.put(None)  # collector stop token (after former exits)
        self._collector.join(timeout=timeout)

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- former thread: accumulate -> dispatch --------------------------------

    def _take_batch(self) -> Optional[List[_Pending]]:
        """Block until a batch is ready (window elapsed or max_batch rows),
        or None at close-with-nothing-pending."""
        with self._nonempty:
            while not self._pending and not self._closed:
                self._nonempty.wait()
            if not self._pending:
                return None  # closed and drained
            deadline = time.monotonic() + self.window_s
            while (
                self._pending_rows < self.max_batch
                and not self._closed
            ):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._nonempty.wait(timeout=remaining)
            batch = self._pending
            self._pending = []
            self._pending_rows = 0
            return batch

    def _form_loop(self) -> None:
        from .pipeline import _serve_batch_shape

        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                total = sum(p.nq for p in batch)
                emb = (
                    batch[0].emb
                    if len(batch) == 1
                    else np.concatenate([p.emb for p in batch], axis=0)
                )
                padded = _serve_batch_shape(total)
                if padded != total:
                    emb = np.concatenate(
                        [emb, np.repeat(emb[-1:], padded - total, axis=0)],
                        axis=0,
                    )
                with self._lock:  # engine+k+gen as one consistent snapshot
                    eng, kk, gen = self.engine, self.k, self.generation
                handle = eng.search_async(emb, kk, upload=self.upload)
                with self._lock:
                    self.stats.batches += 1
                    self.stats.batched_queries += total
            except Exception as exc:  # noqa: BLE001 — fail THIS batch only
                for p in batch:
                    if not p.future.cancelled():
                        p.future.set_exception(exc)
                continue
            self._inflight.put((handle, eng, gen, batch))

    # -- collector thread: collect -> resolve ----------------------------------

    def _collect_loop(self) -> None:
        while True:
            got = self._inflight.get()
            if got is None:
                return
            handle, eng, gen, batch = got  # collect on the DISPATCHING engine
            try:
                ids, dists = eng.collect(handle)
            except Exception as exc:  # noqa: BLE001
                for p in batch:
                    if not p.future.cancelled():
                        p.future.generation = gen
                        p.future.set_exception(exc)
                continue
            off = 0
            for p in batch:
                if not p.future.cancelled():
                    # Tag BEFORE resolving so a reader never sees a resolved
                    # future without its generation.
                    p.future.generation = gen
                    p.future.set_result(
                        (ids[off : off + p.nq], dists[off : off + p.nq])
                    )
                off += p.nq
