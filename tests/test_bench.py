"""Benchmark harness tests (reference: src/mpi_helpers/benchmark.rs)."""

import time

import numpy as np
import pytest

from better_search_rag_rust_tpu.bench import (
    BenchmarkManager,
    BenchmarkTiming,
    format_time,
    time_operation,
)


def test_format_time_humanizer():
    # reference: benchmark.rs:469-486
    assert format_time(5e-10).endswith("ns")
    assert format_time(5e-5).endswith("µs")
    assert format_time(5e-3).endswith("ms")
    assert format_time(5.0) == "5.00 s"
    assert format_time(125.0) == "2m 5.0s"


def test_throughput():
    # reference: benchmark.rs:37-40
    t = BenchmarkTiming("op", duration=2.0, items_processed=100)
    assert t.throughput() == 50.0
    assert BenchmarkTiming("op", 2.0).throughput() is None
    assert BenchmarkTiming("op", 0.0, 10).throughput() is None


def test_record_and_aggregate():
    m = BenchmarkManager()
    m.record_duration("embed", 1.0, items=10)
    m.record_duration("embed", 3.0, items=30)
    m.record_duration("search", 0.5)
    stats = m.gather_timings()
    assert stats["embed"].min_s == stats["embed"].max_s == 4.0
    assert stats["embed"].total_items == 40
    assert stats["search"].total_items is None
    assert stats["embed"].throughput() == pytest.approx(10.0)


def test_timer_measures():
    m = BenchmarkManager()
    timer = m.start("sleepy")
    time.sleep(0.01)
    m.record(timer.stop())
    assert m.local_total("sleepy") >= 0.01


def test_time_operation_wrapper():
    # reference: benchmark.rs:442-466
    m = BenchmarkManager()
    out = time_operation(m, "square", lambda: np.arange(4) ** 2,
                         items=lambda r: r.size)
    np.testing.assert_array_equal(out, [0, 1, 4, 9])
    assert m.local_items("square") == 4


def test_report_contains_speedup():
    # reference: benchmark.rs:361-416 (speedup vs sequential baseline)
    m = BenchmarkManager()
    m.record_duration("search", 1.0, items=1000)
    report = m.generate_report(sequential_times={"search": 8.0})
    assert "BENCHMARK REPORT" in report
    assert "speedup 8.00x" in report
    assert "items/s" in report


def test_as_json_machine_readable():
    import json

    m = BenchmarkManager()
    m.record_duration("op", 2.0, items=10)
    parsed = json.loads(m.as_json())
    assert parsed["op"]["throughput"] == 5.0


def test_finetune_suite_smoke():
    """The finetune suite runs a real train step end to end on the
    emulated mesh and reports throughput + MFU fields."""
    from better_search_rag_rust_tpu.bench.suite import run_finetune_suite

    out = run_finetune_suite(batch=4, steps=1, max_tokens=32,
                             num_layers=2, hidden=96)
    assert out["metric"] == "finetune_files_per_sec"
    assert out["value"] > 0
    assert np.isfinite(out["final_loss"])
    assert out["devices"] >= 1


def test_serve_suite_smoke():
    """The serve suite (many concurrent clients through the dynamic
    micro-batcher) runs end to end on the emulated mesh: exact results
    (recall 1.0), every request answered, and coalescing observed."""
    from better_search_rag_rust_tpu.bench.suite import (
        SearchSuite,
        run_serve_suite,
    )

    tiny = SearchSuite(rows=512, dim=64, queries=8, top_k=5, chunk_rows=512)
    out = run_serve_suite(suite=tiny, clients=8, requests_per_client=4,
                          window_ms=5.0, warm_requests=2)
    assert out["metric"] == "serve_qps"
    assert out["value"] > 0
    assert out["requests"] == 32
    assert out["recall_at_10"] == 1.0
    assert out["coalescing"] >= 1.0
    assert out["p99_latency_ms"] >= out["p50_latency_ms"]
    # Open-loop mode (multiple outstanding per client) stays exact, and
    # upload="store" resolves to a supported mode (falls back to f32
    # where the precast path is unavailable) without losing exactness.
    out = run_serve_suite(suite=tiny, clients=4, requests_per_client=6,
                          window_ms=5.0, warm_requests=2, outstanding=3,
                          upload="store")
    assert out["requests"] == 24
    assert out["recall_at_10"] == 1.0
    assert out["upload"] in ("store", "f32")


def test_search_suite_f32_smoke():
    """The f32 store path (the reference's own store dtype,
    src/vectorstore/polars.rs:35-37) runs through run_search_suite with
    exact self-retrieval — the battery's new dtype-parity point."""
    from better_search_rag_rust_tpu.bench.suite import (
        SUITES,
        SearchSuite,
        run_search_suite,
    )

    assert SUITES["search_1m_f32"].store_dtype == "float32"
    tiny = SearchSuite(rows=512, dim=64, queries=8, top_k=5, chunk_rows=512,
                       store_dtype="float32", iters=1, baseline_rows=512,
                       baseline_queries=2)
    out = run_search_suite("search_f32_smoke", tiny)
    assert out["recall_at_10"] == 1.0
    assert out["store_dtype"] == "float32"
    assert out["value"] > 0


def test_pipeline_suite_smoke():
    """The pipeline suite (driver-recorded ingest throughput) runs end to
    end on the hash backend with a tiny synthetic corpus."""
    from better_search_rag_rust_tpu.bench.suite import run_pipeline_suite

    out = run_pipeline_suite(files=6, dim=32, backend="hash", batch=4)
    assert out["metric"] == "ingest_hash_files_per_sec"
    assert out["value"] > 0
    assert out["files"] == 6
    assert out["startup_s"] >= 0


def test_encode_suite_smoke():
    """The encode suite (driver-recorded forward throughput) runs on the
    full-architecture model at a tiny batch/sequence."""
    from better_search_rag_rust_tpu.bench.suite import run_encode_suite

    out = run_encode_suite(batch=4, iters=1, max_tokens=32)
    assert out["metric"] == "encode_files_per_sec"
    assert out["value"] > 0
    assert out["batch"] == 4


@pytest.mark.parametrize("store_dtype", ["bfloat16", "int8"])
def test_synthetic_store_chunked_fill_matches_oracle(store_dtype):
    """A tiny gen_f32_budget forces the chunked fill path (the one the
    >half-HBM suites like search_10m_int8 take); the store it builds must
    be exactly searchable (engine == serial oracle) and its rows must be
    unit-normalized in the store dtype's lattice."""
    import jax
    import numpy as np

    from better_search_rag_rust_tpu.bench.suite import synthetic_device_store
    from better_search_rag_rust_tpu.config import SearchConfig
    from better_search_rag_rust_tpu.metrics.quality import top_k_overlap
    from better_search_rag_rust_tpu.ops.engine import SearchEngine
    from better_search_rag_rust_tpu.parallel.mesh import create_mesh

    mesh = create_mesh()
    rows, dim = 700, 48
    store = synthetic_device_store(
        mesh, rows, dim, store_dtype, chunk_rows=64, gen_f32_budget=1
    )
    assert store.num_rows == rows and store.dim == dim
    host = np.asarray(jax.device_get(store.data), dtype=np.float32)
    norms = np.linalg.norm(host[:rows, :dim], axis=1)
    if store_dtype == "int8":
        assert np.all(np.abs(host) <= 127)
        # quantized unit rows: |row|/127 within the lattice error band
        assert np.all(np.abs(norms / 127.0 - 1.0) < 0.05)
    else:
        assert np.all(np.abs(norms - 1.0) < 0.02)
    assert np.all(host[:, dim:] == 0.0)

    engine = SearchEngine(
        store, SearchConfig(top_k=10, store_dtype=store_dtype)
    )
    queries = host[:rows: rows // 16, :dim].copy()
    ids, _ = engine.search(queries, k=10)
    o_ids, _ = engine.oracle_topk(queries, k=10)
    assert top_k_overlap(ids, o_ids, k=10) == 1.0
    # self-retrieval: each query row must rank itself first
    assert np.array_equal(ids[:, 0], np.arange(0, rows, rows // 16)[: len(ids)])


def test_battery_suite_assembles_headline(monkeypatch):
    """battery = search_1m headline keys + per-suite sub-objects; suites
    past the time budget are recorded as skipped, not silently dropped."""
    from better_search_rag_rust_tpu.bench import suite as S

    calls = []

    def fake_search(name, _suite):
        calls.append(name)
        return {"metric": f"{name}_qps", "value": 42.0, "recall_at_10": 1.0}

    monkeypatch.setattr(S, "run_search_suite", fake_search)
    monkeypatch.setattr(S, "run_encode_suite",
                        lambda: {"metric": "encode", "value": 7.0})
    monkeypatch.setattr(S, "run_finetune_suite",
                        lambda: {"metric": "finetune", "value": 5.0})
    monkeypatch.setattr(
        S, "run_serve_suite",
        lambda **kw: {"metric": "serve_qps", "value": 3.0})
    from better_search_rag_rust_tpu.bench import jabref as J

    monkeypatch.setattr(J, "run_jabref_suite",
                        lambda: {"metric": "jabref", "value": 9.0})

    sub_suites = {
        "jabref", "serve_100k", "search_1m_f32", "search_10m_mat256",
        "finetune", "serve_open", "encode", "search_1m_int8",
        "search_10m_int8_mat256", "search_10m_int8",
    }
    out = S.run_battery_suite()
    assert out["metric"] == "search_1m_qps"
    assert out["value"] == 42.0
    assert set(out["battery"]) == sub_suites
    assert "search_1m" in calls
    # Artifact-starved suites run BEFORE the r04-artifact-backed tail
    # (VERDICT r4 #1: a tight budget must skip the covered suites, not
    # the reference's flagship jabref experiment) and every suite
    # records its wall time for budget planning.
    names = list(out["battery"])
    assert names.index("jabref") < names.index("encode")
    assert names.index("serve_100k") < names.index("search_1m_int8")
    assert all("wall_s" in sub for sub in out["battery"].values())

    # zero budget: only the headline runs, the rest are recorded skipped
    monkeypatch.setenv("BSR_BATTERY_BUDGET_S", "0")
    out = S.run_battery_suite()
    assert out["value"] == 42.0
    assert set(out["battery_skipped"]) == sub_suites

    # a failing sub-suite surfaces as an error object, not a crash
    monkeypatch.delenv("BSR_BATTERY_BUDGET_S")
    monkeypatch.setattr(S, "run_encode_suite",
                        lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    out = S.run_battery_suite()
    assert "RuntimeError" in out["battery"]["encode"]["error"]


def test_compact_battery_summary_fits_capture_channel():
    """The compact line must survive the driver's ~2000-char tail capture
    (round-3 regression: full battery detail overflowed it and the
    artifact lost every headline key) while keeping each sub-suite's
    decision-grade scalars."""
    import json

    from better_search_rag_rust_tpu.bench import suite as S

    def search_like(name):
        return {
            "metric": f"{name}_qps", "value": 84321.12,
            "unit": "queries/sec", "vs_baseline": 379.27,
            "recall_at_10": 1.0, "mfu": 0.6513,
            "qps_repeats": [84321.12, 83211.45, 82999.01],
            "spread_pct": 1.57, "e2e_qps": 5123.45,
            "stream_e2e_qps": 13411.22, "stream_store_upload_qps": 19900.12,
            "p50_batch_latency_s": 0.1162, "device_batch_latency_s": 0.0123,
            "kernel": "global", "rows": 10_000_000, "dim": 768,
            "batch": 1024, "top_k": 100, "store_dtype": "int8",
            "store_build_s": 11.14, "serial_baseline_qps": 2.45,
            "baseline_24rank_qps": 58.91, "devices": 1, "platform": "gpu",
        }

    full = search_like("search_1m")
    full["battery"] = {
        "search_1m_int8": search_like("search_1m_int8"),
        "search_10m_int8_mat256": search_like("search_10m_int8_mat256"),
        "search_1m_f32": search_like("search_1m_f32"),
        "encode": {"metric": "encode_files_per_sec", "value": 1130.67,
                   "unit": "files/sec", "vs_baseline": 0.0, "mfu": 0.721,
                   "batch": 256, "max_tokens": 512,
                   "attention_impl": "auto", "platform": "gpu"},
        "jabref": {"metric": "jabref_search_qps", "value": 664032.58,
                   "unit": "queries/sec", "vs_baseline": 1.41,
                   "recall_at_10": 1.0, "oracle_overlap": 1.0,
                   "files": 2305, "rows": 2305, "top_k": 50,
                   "speedup_vs_serial": 33.88, "serial_qps": 19601.2,
                   "e2e_qps": 59.86, "ingest_files_per_sec": 1309.44,
                   "report_has_speedup": True, "platform": "gpu"},
        "serve_100k": {"metric": "serve_qps", "value": 549.27,
                       "unit": "queries/sec", "vs_baseline": 14.57,
                       "recall_at_10": 1.0, "coalescing": 16.0,
                       "p50_latency_ms": 40.1, "clients": 16,
                       "outstanding": 1, "answered": 192, "failed": 0},
        "serve_open": {"metric": "serve_qps", "value": 4551.3,
                       "unit": "queries/sec", "vs_baseline": 156.2,
                       "recall_at_10": 1.0, "coalescing": 196.4,
                       "p50_latency_ms": 110.2, "clients": 64,
                       "outstanding": 8, "answered": 16384, "failed": 0},
        "broken": {"error": "RuntimeError: boom"},
    }
    full["battery_wall_s"] = 1321.7

    out = S.compact_battery_summary(full)
    line = json.dumps(out)
    assert len(line) <= 1500, len(line)
    # headline keys survive verbatim
    assert out["metric"] == "search_1m_qps" and out["value"] == 84321.12
    assert out["recall_at_10"] == 1.0 and out["mfu"] == 0.6513
    assert out["qps_repeats"] == [84321.12, 83211.45, 82999.01]
    # every sub-suite keeps its decision scalars
    sub = out["battery"]["search_10m_int8_mat256"]
    assert sub["value"] == 84321.12 and sub["spread_pct"] == 1.57
    assert out["battery"]["serve_open"]["coalescing"] == 196.4
    assert out["battery"]["jabref"]["oracle_overlap"] == 1.0
    assert "boom" in out["battery"]["broken"]["error"]
    assert out["battery_wall_s"] == 1321.7
    # the whole line parses back
    assert json.loads(line)["battery"]["encode"]["mfu"] == 0.721


def test_compact_battery_summary_many_suites_still_fits():
    """With enough sub-suites the key-dropping loop alone cannot reach the
    cap (round-4 ADVICE): the fallback drops whole sub-suite entries
    (recorded under battery_truncated) — and in the extreme the battery
    dict itself — so the search_1m headline ALWAYS fits the driver's
    tail capture."""
    import json

    from better_search_rag_rust_tpu.bench import suite as S

    full = {
        "metric": "search_1m_qps", "value": 84321.12,
        "unit": "queries/sec", "vs_baseline": 379.27,
        "recall_at_10": 1.0, "mfu": 0.6513,
        "qps_repeats": [84321.12, 83211.45, 82999.01],
        "spread_pct": 1.57, "kernel": "global", "devices": 1,
        "platform": "gpu",
        "battery": {
            f"suite_with_a_fairly_long_name_{i:03d}": {
                "value": 12345.67, "recall_at_10": 1.0, "mfu": 0.5,
                "spread_pct": 1.0, "unit": "queries/sec",
                "vs_baseline": 99.9,
            }
            for i in range(60)
        },
        "battery_wall_s": 1499.9,
    }
    out = S.compact_battery_summary(full)
    line = json.dumps(out)
    assert len(line) <= 1500, len(line)
    assert out["value"] == 84321.12 and out["qps_repeats"]
    # entries dropped from the END of the plan (artifact-backed tail),
    # and the drops are recorded, not silent
    if "battery_truncated" in out:
        kept = set(out["battery"])
        assert "suite_with_a_fairly_long_name_000" in kept or not kept
        assert all(n not in kept for n in out["battery_truncated"])


def test_bench_main_writes_detail_and_compact_stdout(monkeypatch, tmp_path,
                                                     capsys):
    """bench.py's driver channel: for the battery, the FULL result goes to
    the detail file and stdout's last line is the compact (<=1.5 kB)
    parseable summary — the exact contract the round-3 artifact broke."""
    import importlib.util
    import json
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "bench_main", Path(__file__).resolve().parents[1] / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    big = {"metric": "search_1m_qps", "value": 84000.0,
           "unit": "queries/sec", "vs_baseline": 379.0, "recall_at_10": 1.0,
           "mfu": 0.65, "qps_repeats": [84000.0, 83000.0, 82000.0],
           "spread_pct": 2.4, "kernel": "global",
           "filler": "x" * 4000,  # guarantees the full form would overflow
           "battery": {
               "encode": {"metric": "encode_files_per_sec", "value": 1133.0,
                          "unit": "files/sec", "mfu": 0.72},
           },
           "battery_wall_s": 476.4}
    detail = tmp_path / "detail.json"
    monkeypatch.setenv("BSR_BENCH_DETAIL", str(detail))
    monkeypatch.setenv("BENCH_SUITE", "battery")

    from better_search_rag_rust_tpu.bench import suite as S

    monkeypatch.setattr(S, "run_battery_suite", lambda: big)
    assert bench.main() == 0
    out_lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    compact = json.loads(out_lines[-1])
    assert len(out_lines[-1]) <= 1500
    assert compact["value"] == 84000.0 and "filler" not in compact
    assert compact["battery"]["encode"]["mfu"] == 0.72
    saved = json.loads(detail.read_text())
    assert saved["filler"] == "x" * 4000  # full detail preserved on disk
