"""Device profiling — the replacement for the reference's tracing.

The reference installs ``tracing_subscriber`` inside its model constructor to
capture ONNX Runtime events (reference: src/llm/hf.rs:30) and otherwise times
phases with ``Instant::now()`` (src/mpi_helpers/tasks.rs:94-163). Here the
device side is covered by ``jax.profiler`` (XLA op-level traces viewable in
TensorBoard/Perfetto) and the host side by :mod:`..bench`.

Usage::

    from better_search_rag_rust_tpu.utils.profiling import device_trace

    with device_trace("/tmp/bsr-trace"):
        engine.search(queries)

    # or annotate phases inside a trace:
    with device_trace("/tmp/bsr-trace"):
        with annotate("embed"):
            encoder.get_embeddings(batch)
        with annotate("search"):
            engine.search(queries)
"""

from __future__ import annotations

from contextlib import contextmanager

import jax

from .logging import host_log


@contextmanager
def device_trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a jax.profiler trace of the enclosed block."""
    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        host_log(f"device trace written to {log_dir}")


@contextmanager
def annotate(name: str):
    """Named sub-span inside a device trace (shows up in the timeline)."""
    with jax.profiler.TraceAnnotation(name):
        yield


def memory_stats() -> dict:
    """Per-device HBM usage, when the backend reports it."""
    stats = {}
    for dev in jax.local_devices():
        try:
            s = dev.memory_stats()
        except Exception:
            s = None
        if s:
            stats[str(dev)] = {
                "bytes_in_use": s.get("bytes_in_use"),
                "bytes_limit": s.get("bytes_limit"),
            }
    return stats
