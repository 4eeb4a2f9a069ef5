#!/usr/bin/env python
"""Headline benchmark — prints ONE JSON line.

Runs the BASELINE.json headline config (1M synthetic 768-d vectors,
1024-query batch, top-100, bf16 scoring with f32 accumulation) through the
exact sharded search engine on whatever devices are visible (override the
suite with BENCH_SUITE).

The reference publishes no absolute numbers (BASELINE.md), so ``vs_baseline``
is engine queries/sec divided by 24x an in-process-measured NumPy serial scan
— a linear-scaling stand-in for the reference's 24-rank c6i.24xlarge MPI
config. recall_at_10 is included as the exactness sanity (must be 1.0).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    # Default = the time-boxed battery: the search_1m headline keys (same
    # metric/value as before) PLUS per-suite sub-objects under "battery"
    # (int8 configs, encode, serve) so the driver artifact captures the
    # breadth, not just the headline. BENCH_SUITE selects a single suite.
    suite = os.environ.get("BENCH_SUITE", "battery")
    from better_search_rag_rust_tpu.bench.suite import (
        compact_battery_summary, run_suite)
    from better_search_rag_rust_tpu.launch import enable_compile_cache

    enable_compile_cache()

    result = run_suite(suite)
    if "battery" in result:
        # Full detail goes to a file; stdout gets ONE compact line
        # (<=1.5 kB) that survives a capture of only the output's tail.
        detail_path = os.environ.get(
            "BSR_BENCH_DETAIL",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "bench_detail.json"),
        )
        try:
            with open(detail_path, "w") as f:
                json.dump(result, f, indent=1)
            print(f"full battery detail -> {detail_path}", file=sys.stderr)
        except OSError as exc:
            print(f"could not write {detail_path}: {exc}", file=sys.stderr)
        result = compact_battery_summary(result)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
