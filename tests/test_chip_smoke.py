"""``chip_smoke.py``'s phases at tiny widths on the CPU mesh, and its
refusal to run without a GPU. On the card the same phases run at full
width (``python chip_smoke.py``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TINY = dict(hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64,
            max_tokens=32)


def test_refuses_to_run_without_gpu():
    """No CPU fallback: without a GPU the script exits non-zero and prints
    no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_require_gpu_rejects_cpu_in_process():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu(1)


def test_phase_encoder_tiny():
    res = chip_smoke.phase_encoder(width=TINY, batch=8)
    assert res["attention"] == "xla"  # the CPU's resolution of "auto"
    assert res["min_cosine"] >= 0.999


def test_phase_train_tiny():
    res = chip_smoke.phase_train(width=TINY, batch=4)
    assert abs(res["loss"] - res["xla_attention_loss"]) <= 1e-2 * abs(
        res["xla_attention_loss"])


def test_phase_pipeline_tiny(tmp_path):
    """The CLI's run -> search --query -> serve path, in process."""
    res = chip_smoke.phase_pipeline(tmp_path, files=48, width=TINY, batch=8)
    assert (res["mrr"], res["recall"], res["overlap"]) == (1.0, 1.0, 1.0)
    assert res["serve_responses"] == 4
    json.dumps(res)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_phase_search_tiny(mesh8, dtype):
    res = chip_smoke.phase_search(mesh8, rows=5000, dim=64, dtype=dtype,
                                  queries=128, k=20, checked=16,
                                  chunk_rows=256)
    assert res["overlap"] == 1.0 and res["kernel"] == "global"


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_phase_search_duplicates_tiny(mesh8, dtype):
    res = chip_smoke.phase_search_duplicates(mesh8, rows=4096, dim=32,
                                             dtype=dtype, chunk_rows=256)
    assert res["overlap"] == 1.0 and res["checked"] == res["queries"]


def test_four_card_paths_on_cpu_mesh():
    """The ``--four`` phases (sharded search, DP x TP train step vs one
    device) on four emulated devices."""
    chip_smoke.run_four_cards(jax.devices()[:4], rows=4096, dim=64,
                              width=TINY, chunk_rows=256)
