"""Launch helpers: multi-process cluster join and the compile cache — the
replacement for the reference's launch infra (reference: makefile:13-14
``mpiexec -n $(N)``, run-slurm.sh, hostfile ``localhost slots=32``).

There is no mpiexec: every process runs the same program and joins the
cluster via ``jax.distributed.initialize``, configured by:

    BSR_COORDINATOR=host0:8476  BSR_NUM_PROCESSES=4  BSR_PROCESS_ID=0..3
"""

from __future__ import annotations

import os
from pathlib import Path

from .utils.logging import host_log

#: Compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset:
#: a fixed path in the checkout, because the path is part of the cache key.
DEFAULT_COMPILE_CACHE = Path(__file__).resolve().parent.parent / ".jax_cache"


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else the checkout's
    ``.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        DEFAULT_COMPILE_CACHE
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    (JAX itself reads ``JAX_COMPILATION_CACHE_DIR``, so nothing changes when
    it is set). Call before the first compile; returns the directory."""
    import jax

    path = compile_cache_dir()
    if jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def maybe_init_distributed() -> bool:
    """Join the multi-process cluster when the env asks for it; no-op
    (False) for single-process runs. Safe to call more than once.

    Must run BEFORE anything touches the XLA backend, so the
    already-initialized check inspects the distributed client directly
    instead of calling ``jax.process_count()`` (which would initialize it).
    """
    import jax

    if jax.distributed.is_initialized():
        return True  # explicitly initialized earlier
    coord = os.environ.get("BSR_COORDINATOR")
    nproc = os.environ.get("BSR_NUM_PROCESSES")
    if not coord or not nproc:
        return False
    pid = int(os.environ.get("BSR_PROCESS_ID", "0"))
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(nproc),
        process_id=pid,
    )
    host_log(
        f"joined cluster {coord} as process {pid}/{nproc} "
        f"({len(jax.local_devices())} local devices)"
    )
    return True
