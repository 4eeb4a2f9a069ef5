"""What the program needs from the platform: the device peak table, the
compile-cache location and its importable dependencies."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from better_search_rag_rust_tpu import launch
from better_search_rag_rust_tpu.ops import device_profile

REPO = Path(__file__).resolve().parent.parent


def test_h100_row_has_data_sheet_peaks():
    prof = device_profile.resolve_profile("NVIDIA H100 80GB HBM3")
    assert (prof.hbm_gb, prof.hbm_gbps) == (80, 3350)
    assert device_profile.peak_bf16_flops(prof.kind) == 989e12
    assert device_profile.peak_matmul_flops(prof.kind, "int8") == 1979e12
    assert device_profile.peak_matmul_flops(prof.kind, "bfloat16") == 989e12


def test_cpu_row_reports_no_peak():
    assert jax.devices()[0].device_kind == "cpu"
    assert device_profile.peak_bf16_flops("cpu") is None
    assert device_profile.peak_matmul_flops("cpu", "int8") is None


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "NVIDIA H100",
                                  "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_device_kind_raises(kind):
    """Exact-match table: a prefix (or a different part) never borrows
    another card's peaks."""
    with pytest.raises(KeyError, match="no device profile"):
        device_profile.resolve_profile(kind)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    want = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert launch.compile_cache_dir() == want
        assert launch.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert launch.compile_cache_dir() == str(REPO / ".jax_cache")
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_main_path_imports_without_optional_packages():
    """The pipeline and the CLI import with flax, pyarrow, orbax and torch
    absent (a ``None`` entry in ``sys.modules`` makes an import fail)."""
    code = (
        "import sys\n"
        "for m in ('flax', 'pyarrow', 'orbax', 'orbax.checkpoint', 'torch'):\n"
        "    sys.modules[m] = None\n"
        "import better_search_rag_rust_tpu.pipeline\n"
        "import better_search_rag_rust_tpu.cli\n"
        "import better_search_rag_rust_tpu.models.train\n"
        "import better_search_rag_rust_tpu.store.device_cache\n"
        "print('ok')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"

