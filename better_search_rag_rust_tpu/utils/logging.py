"""Structured logging with host prefixes.

Replaces the reference's ``println!("[Rank {}] ...")`` pattern
(reference: src/main.rs:21-23 ``generate_msg``) and its
``tracing_subscriber::fmt::init()`` call buried inside the model constructor
(reference: src/llm/hf.rs:30) with a normal process-level logger. In the JAX
SPMD model the analogue of an MPI rank is the host process index
(``jax.process_index()``), so messages are prefixed with it.
"""

from __future__ import annotations

import logging
import sys
import time
from contextlib import contextmanager

_CONFIGURED = False


def _host_index() -> int:
    try:
        import jax

        return jax.process_index()
    except Exception:
        return 0


def get_logger(name: str = "bsr") -> logging.Logger:
    global _CONFIGURED
    logger = logging.getLogger(name)
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
        _CONFIGURED = True
    return logger


def host_log(msg: str) -> None:
    """Log with a ``[Host h]`` prefix (≙ reference ``[Rank N]`` prefix)."""
    get_logger().info("[Host %d] %s", _host_index(), msg)


@contextmanager
def phase_timer(name: str, sink=None):
    """Lightweight phase timer; pairs with :mod:`..bench` for aggregation."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink(name, dt)
        else:
            host_log(f"{name} took {dt:.3f}s")
