"""Benchmark harness: phase timers, cross-host aggregation, speedup report.

Capability parity with the reference's benchmark subsystem
(reference: src/mpi_helpers/benchmark.rs:1-487):

* ``BenchmarkTiming`` — name + duration + optional items processed, with a
  ``throughput()`` items/sec helper (benchmark.rs:16-40);
* ``BenchmarkManager`` — per-host recorder keyed by op name
  (benchmark.rs:80-110), ``gather_timings`` across hosts, ``generate_report``
  with per-op min/max/avg + host attribution + optional speedup vs a supplied
  sequential baseline (benchmark.rs:296-438);
* ``time_operation`` wrapper (benchmark.rs:442-466) and ``format_time``
  humanizer (benchmark.rs:469-486).

The reference gathers records with an all_gather of counts plus hand-rolled
length-prefixed p2p sends of name bytes / f64 seconds / i32 item counts with a
-1 sentinel (benchmark.rs:112-281). Here cross-host exchange is one
``multihost_utils.process_allgather`` of a fixed-size float array per op —
names are identical on every host by construction (SPMD), so no byte-shipping
exists at all. On a single host it degrades to the identity.

Device-specific: ``stop()`` optionally blocks on a JAX array first, because an
un-synchronized timer would measure dispatch, not execution.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, TypeVar

import numpy as np

T = TypeVar("T")


def format_time(seconds: float) -> str:
    """Humanize a duration (reference: benchmark.rs:469-486)."""
    if seconds < 1e-6:
        return f"{seconds * 1e9:.2f} ns"
    if seconds < 1e-3:
        return f"{seconds * 1e6:.2f} µs"
    if seconds < 1.0:
        return f"{seconds * 1e3:.2f} ms"
    if seconds < 60.0:
        return f"{seconds:.2f} s"
    mins, secs = divmod(seconds, 60.0)
    return f"{int(mins)}m {secs:.1f}s"


@dataclass
class BenchmarkTiming:
    """One timed operation (reference: benchmark.rs:16-40)."""

    name: str
    duration: float  #: seconds
    items_processed: Optional[int] = None

    def throughput(self) -> Optional[float]:
        """items/sec (reference: benchmark.rs:37-40)."""
        if self.items_processed is None or self.duration <= 0:
            return None
        return self.items_processed / self.duration


class BenchmarkTimer:
    """start/stop timer (reference: benchmark.rs:44-77)."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = time.perf_counter()

    def stop(
        self, items_processed: Optional[int] = None, block_on=None
    ) -> BenchmarkTiming:
        if block_on is not None:
            import jax

            jax.block_until_ready(block_on)
        return BenchmarkTiming(
            self.name, time.perf_counter() - self._t0, items_processed
        )


@dataclass
class OpStats:
    """Cross-host aggregate for one op."""

    name: str
    min_s: float
    max_s: float
    avg_s: float
    min_host: int
    max_host: int
    total_items: Optional[int]

    def throughput(self) -> Optional[float]:
        if self.total_items is None or self.max_s <= 0:
            return None
        return self.total_items / self.max_s


class BenchmarkManager:
    """Records timings per host; aggregates and reports across hosts
    (reference: benchmark.rs:80-438)."""

    def __init__(self):
        self._timings: Dict[str, List[BenchmarkTiming]] = {}

    # -- recording -----------------------------------------------------------

    def start(self, name: str) -> BenchmarkTimer:
        return BenchmarkTimer(name)

    def record(self, timing: BenchmarkTiming) -> None:
        """(reference: benchmark.rs:93-98)"""
        self._timings.setdefault(timing.name, []).append(timing)

    def record_duration(
        self, name: str, seconds: float, items: Optional[int] = None
    ) -> None:
        self.record(BenchmarkTiming(name, seconds, items))

    @property
    def operations(self) -> List[str]:
        return list(self._timings)

    def local_total(self, name: str) -> float:
        return sum(t.duration for t in self._timings.get(name, []))

    def local_items(self, name: str) -> Optional[int]:
        items = [
            t.items_processed
            for t in self._timings.get(name, [])
            if t.items_processed is not None
        ]
        return sum(items) if items else None

    # -- cross-host gather -----------------------------------------------------

    #: Fixed-shape caps for the cross-host exchange (names travel too —
    #: hosts may record different op sets, e.g. root-only vector_store_merge).
    MAX_OPS = 64
    NAME_BYTES = 48

    def gather_timings(self) -> Dict[str, OpStats]:
        """Aggregate per-op totals across all hosts
        (reference: benchmark.rs:112-293, reimagined as fixed-size
        allgathers instead of ragged p2p). Hosts may have recorded
        *different* op sets — the reference's root-only merge timing is the
        canonical case — so each host ships a padded name table alongside
        its numbers and the union is taken on every host."""
        import jax

        names = sorted(self._timings)[: self.MAX_OPS]
        if len(self._timings) > self.MAX_OPS:
            from ..utils.logging import host_log

            host_log(
                f"WARNING: {len(self._timings) - self.MAX_OPS} ops beyond the "
                f"{self.MAX_OPS}-op cross-host cap were dropped from the report"
            )
        long_names = [n for n in names if len(n.encode("utf-8")) > self.NAME_BYTES]
        if long_names:
            from ..utils.logging import host_log

            host_log(
                f"WARNING: op names longer than {self.NAME_BYTES} bytes are "
                f"truncated in the cross-host report (prefix collisions merge "
                f"their rows): {long_names}"
            )

        # [ops, 3] rows: (total seconds, item-count high 24 bits, low 24
        # bits). process_allgather coerces to float32 under the default
        # x64-disabled config, so counts > 2^24 are split into two exactly-
        # representable halves (-1/-1 = the reference's no-items sentinel,
        # benchmark.rs:267).
        def _split(n):
            if self.local_items(n) is None:
                return (-1.0, -1.0)
            v = int(self.local_items(n))
            return (float(v >> 24), float(v & 0xFFFFFF))

        local = np.zeros((self.MAX_OPS, 3), dtype=np.float32)
        local[:, 1:] = -1.0  # unused rows carry the no-items sentinel
        name_blob = np.zeros((self.MAX_OPS, self.NAME_BYTES), dtype=np.uint8)
        for i, n in enumerate(names):
            local[i] = [self.local_total(n), *_split(n)]
            raw = n.encode("utf-8")[: self.NAME_BYTES]
            name_blob[i, : len(raw)] = np.frombuffer(raw, dtype=np.uint8)

        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            gathered = np.asarray(
                multihost_utils.process_allgather(local)
            )  # [hosts, MAX_OPS, 3]
            all_names = np.asarray(
                multihost_utils.process_allgather(name_blob.astype(np.int32))
            ).astype(np.uint8)  # [hosts, MAX_OPS, NAME_BYTES]
        else:
            gathered = local[None]
            all_names = name_blob[None]

        def _decode(row: np.ndarray) -> str:
            return bytes(row[row > 0].tolist()).decode("utf-8", "replace")

        # Union of op names across hosts, with each host's row index for it.
        per_host_names = [
            [_decode(all_names[h, i]) for i in range(self.MAX_OPS)]
            for h in range(all_names.shape[0])
        ]
        union = sorted(
            {n for host in per_host_names for n in host if n}
        )

        stats: Dict[str, OpStats] = {}
        for name in union:
            secs, items_list, hosts = [], [], []
            for h, host_names in enumerate(per_host_names):
                if name not in host_names:
                    continue
                i = host_names.index(name)
                hosts.append(h)
                secs.append(gathered[h, i, 0])
                hi, lo = gathered[h, i, 1], gathered[h, i, 2]
                items_list.append(
                    int(hi) * (1 << 24) + int(lo) if hi >= 0 else -1
                )
            secs = np.asarray(secs)
            items = np.asarray(items_list)
            total_items = None
            if (items >= 0).any():
                total_items = int(items[items >= 0].sum())
            stats[name] = OpStats(
                name=name,
                min_s=float(secs.min()),
                max_s=float(secs.max()),
                avg_s=float(secs.mean()),
                min_host=int(hosts[int(secs.argmin())]),
                max_host=int(hosts[int(secs.argmax())]),
                total_items=total_items,
            )
        return stats

    # -- reporting ---------------------------------------------------------------

    def generate_report(
        self, sequential_times: Optional[Dict[str, float]] = None
    ) -> str:
        """Printable per-op report with min/max/avg, host attribution,
        throughput and optional speedup vs a sequential baseline
        (reference: benchmark.rs:296-438)."""
        stats = self.gather_timings()
        lines = ["", "=" * 72, "BENCHMARK REPORT", "=" * 72]
        header = f"{'operation':<28}{'min':>10}{'max':>10}{'avg':>10}  notes"
        lines.append(header)
        lines.append("-" * 72)
        for name, s in stats.items():
            notes = []
            if s.min_host != s.max_host:
                notes.append(f"min@h{s.min_host} max@h{s.max_host}")
            tp = s.throughput()
            if tp is not None:
                notes.append(f"{tp:,.1f} items/s")
            if sequential_times and name in sequential_times:
                seq = sequential_times[name]
                if s.max_s > 0:
                    notes.append(f"speedup {seq / s.max_s:.2f}x")
            lines.append(
                f"{name:<28}{format_time(s.min_s):>10}{format_time(s.max_s):>10}"
                f"{format_time(s.avg_s):>10}  {' '.join(notes)}"
            )
        lines.append("=" * 72)
        return "\n".join(lines)

    def as_json(self) -> str:
        """Machine-readable dump (one line per op)."""
        stats = self.gather_timings()
        return json.dumps(
            {
                n: {
                    "min_s": s.min_s,
                    "max_s": s.max_s,
                    "avg_s": s.avg_s,
                    "items": s.total_items,
                    "throughput": s.throughput(),
                }
                for n, s in stats.items()
            }
        )


def time_operation(
    manager: BenchmarkManager,
    name: str,
    op: Callable[[], T],
    items: Optional[Callable[[T], int]] = None,
) -> T:
    """Run ``op`` under a timer and record it
    (reference: benchmark.rs:442-466)."""
    timer = manager.start(name)
    result = op()
    manager.record(
        timer.stop(items_processed=items(result) if items else None)
    )
    return result
