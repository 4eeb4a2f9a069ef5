"""Native (C++) runtime components, loaded over ctypes.

The reference's runtime is 100% native Rust (SURVEY.md §2); the device
compute path here is JAX/XLA, and the host-side runtime pieces that the
reference implemented natively are C++:

* ``bsr_corpus.cpp`` — multithreaded corpus walker + capped file reader
  (reference: src/source.rs:8-49, where ingest spends its host time).
* ``bsr_tokenize.cpp`` — the hermetic hashing tokenizer's hot loop
  (blake2b + word split, bitwise-compatible with
  models/tokenizer.py:HashingTokenizer for ASCII inputs), GIL-free on a
  thread pool.

The shared library is built on demand with g++ (cached next to the sources);
every consumer falls back to the pure-Python implementation when the
toolchain or the build is unavailable, so the package never hard-depends on
a compiler at runtime.
"""

from __future__ import annotations

import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).parent
_LIB = _DIR / "libbsr_native.so"
_SRCS = [_DIR / "bsr_corpus.cpp", _DIR / "bsr_tokenize.cpp"]
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> bool:
    """Compile to a process-unique temp file and atomically rename into
    place, so concurrent processes can never dlopen a half-written .so."""
    import os

    tmp = _LIB.with_suffix(f".{os.getpid()}.tmp.so")
    try:
        subprocess.run(
            [
                "g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
                *[str(s) for s in _SRCS], "-o", str(tmp),
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _LIB)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def load():
    """The loaded ctypes library, or None when unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not _LIB.exists() or _LIB.stat().st_mtime < max(
            s.stat().st_mtime for s in _SRCS
        ):
            if not _build():
                _build_failed = True
                return None
        try:
            import ctypes

            lib = ctypes.CDLL(str(_LIB))
            lib.bsr_walk.restype = ctypes.c_void_p
            lib.bsr_walk.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            lib.bsr_free.argtypes = [ctypes.c_void_p]
            lib.bsr_read_files.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int32,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
            lib.bsr_tokenize.restype = ctypes.c_int32
            lib.bsr_tokenize.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
            _lib = lib
            return _lib
        except Exception:
            _build_failed = True
            return None
