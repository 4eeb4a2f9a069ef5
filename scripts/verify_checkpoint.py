#!/usr/bin/env python
"""Turnkey real-checkpoint parity verification — ONE command, ONE verdict.

Given a local nomic-embed-text-v1.5 export (made by
``scripts/export_checkpoint.py`` on a connected machine), this runs every
parity check the framework has and writes a machine-readable verdict:

    BSR_CHECKPOINT_DIR=/path/to/nomic-embed-text-v1.5 \
        python scripts/verify_checkpoint.py

Checks, in order (each recorded as pass/fail/skip in ``PARITY_REAL.json``):

1. **tokenizer_contract** — the reference's tokenizer configuration
   (src/llm/hf.rs:59-106): truncation at 512, fixed right-padding with
   pad_id 0, ``[B, 512]`` int shapes, determinism, and the
   ``add_special_tokens=False`` parity pin (hf.rs:83) validated against the
   tokenizer's OWN declared [CLS] id — no hardcoded vocab guesses.
2. **tokenizer_golden** — exact token ids for fixed probe texts vs the
   committed ``tests/golden/tokenizer_real_golden.json``. Skipped (and
   called out) when the golden is absent; generate it ONCE on a machine
   with the real export via ``--write-golden``.
3. **golden_suite** — the full ``tests/test_golden_parity.py`` pytest run
   with the checkpoint engaged: double-implementation torch-vs-JAX parity
   on synthetic weights, the committed golden fixture, and — when the
   export carries its ``modeling_hf_nomic_bert.py`` — the definitive
   cross-implementation check on the REAL weights
   (reference contract: embeddings are the model's second output,
   src/llm/hf.rs:112).
4. **real_forward** — load the real weights into the JAX encoder and
   check the output contract on the checkpoint's own tokenizer: shape
   ``[B, hidden]``, finite, unit-norm (mean-pool + L2).
5. **chip_parity** — on a GPU only: the bf16 forward with the platform's
   attention (cuDNN) vs the f32 XLA path on the real weights, per-row
   embedding cosine >= 0.999. Skipped on CPU (or ``--skip-chip``).

Exit code 0 and ``"verdict": "PASS"`` mean every non-skipped check passed.
The chain itself is CI-verified against a synthetic HF-format export
(``tests/test_checkpoint_verify.py``), so the first run against a real
export exercises known-good plumbing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

GOLDEN_PATH = REPO / "tests" / "golden" / "tokenizer_real_golden.json"

#: Fixed probe texts for the golden-ids check: code-shaped (the corpus this
#: framework retrieves over) plus a unicode + a long-repetition probe.
PROBE_TEXTS = [
    "public class VectorStore { void append(float[] row) {} }",
    "def cosine(a, b): return a @ b",
    "hello world",
    "package org.jabref.model.entry; // ümlaut 中文",
    "x " * 600,  # > 512 tokens -> truncation must bite
]


def _tokenizer(ckpt: str, add_special_tokens: bool):
    from better_search_rag_rust_tpu.models.tokenizer import (
        FixedLengthTokenizer, load_tokenizer,
    )

    tok = load_tokenizer(ckpt, 512, add_special_tokens=add_special_tokens)
    if not isinstance(tok, FixedLengthTokenizer):
        raise AssertionError(
            f"no tokenizer.json under {ckpt} — load_tokenizer fell back to "
            "the hashing tokenizer; a real-checkpoint parity run needs the "
            "real tokenizer"
        )
    return tok


def check_tokenizer_contract(ckpt: str) -> dict:
    import numpy as np

    tok = _tokenizer(ckpt, add_special_tokens=False)
    ids, mask = tok.encode_batch(PROBE_TEXTS)
    assert ids.shape == (len(PROBE_TEXTS), 512), ids.shape
    assert mask.shape == ids.shape
    assert ids.dtype == np.int32 and mask.dtype == np.int32
    # fixed right-padding with pad_id 0 (hf.rs:70-71): every position the
    # mask excludes is PAD_ID, and the mask is a left-packed 1-run
    assert ((ids == 0) | (mask == 1)).all(), "non-PAD id at a masked slot"
    runs = mask.sum(axis=1)
    for r, row in zip(runs, mask):
        assert (row[:r] == 1).all() and (row[r:] == 0).all(), "ragged mask"
    assert runs[-1] == 512, f"truncation did not bite: {runs[-1]}"
    # determinism (hf.rs contract is a pure function of the text)
    ids2, mask2 = tok.encode_batch(PROBE_TEXTS)
    assert (ids == ids2).all() and (mask == mask2).all()
    # the add_special_tokens=False parity pin, judged by the tokenizer's
    # OWN [CLS]: with specials ON the first token is [CLS]; with the parity
    # default OFF it must not be
    detail = {"mask_runs": runs.tolist()}
    cls_id = tok._tok.token_to_id("[CLS]")
    if cls_id is not None:
        tok_on = _tokenizer(ckpt, add_special_tokens=True)
        ids_on, _ = tok_on.encode_batch(PROBE_TEXTS[:1])
        assert ids_on[0, 0] == cls_id, (
            f"add_special_tokens=True did not prepend [CLS]={cls_id}"
        )
        assert ids[0, 0] != cls_id, (
            "parity default add_special_tokens=False still prepends [CLS]"
        )
        detail["cls_id"] = int(cls_id)
    else:
        detail["cls_id"] = None  # tokenizer declares no [CLS]; pin n/a
    return detail


def check_tokenizer_golden(ckpt: str, write: bool) -> dict:
    tok = _tokenizer(ckpt, add_special_tokens=False)
    ids, mask = tok.encode_batch(PROBE_TEXTS)
    payload = {
        "add_special_tokens": False,
        "max_tokens": 512,
        "texts": PROBE_TEXTS,
        "ids": ids.tolist(),
        "mask": mask.tolist(),
    }
    if write:
        GOLDEN_PATH.write_text(json.dumps(payload))
        return {"written": str(GOLDEN_PATH)}
    if not GOLDEN_PATH.exists():
        raise _Skip(
            f"{GOLDEN_PATH.name} not committed — run once with "
            "--write-golden on a machine with the real export"
        )
    want = json.loads(GOLDEN_PATH.read_text())
    assert want["texts"] == PROBE_TEXTS, (
        "golden was generated for different probe texts; regenerate with "
        "--write-golden"
    )
    assert want["ids"] == payload["ids"], "token ids diverge from golden"
    assert want["mask"] == payload["mask"], "masks diverge from golden"
    return {"probes": len(PROBE_TEXTS)}


def check_golden_suite(ckpt: str) -> dict:
    env = dict(os.environ, BSR_CHECKPOINT_DIR=ckpt)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_golden_parity.py",
         "-q", "--no-header"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1800,
    )
    tail = "\n".join((proc.stdout or "").strip().splitlines()[-3:])
    if proc.returncode != 0:
        raise AssertionError(
            f"golden suite rc={proc.returncode}:\n{tail}\n{proc.stderr[-800:]}"
        )
    return {"pytest_tail": tail}


def check_real_forward(ckpt: str) -> dict:
    import jax.numpy as jnp
    import numpy as np

    from better_search_rag_rust_tpu.models.nomic import (
        NomicEncoder, load_hf_checkpoint,
    )

    cfg, params = load_hf_checkpoint(ckpt)
    # f32 + XLA attention: the reference-arithmetic path that runs on any
    # backend; the bf16 cuDNN variant is stage 5's job (GPU only).
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": jnp.float32,
                       "attention_impl": "xla"})
    enc = NomicEncoder(cfg, params=params)
    tok = _tokenizer(ckpt, add_special_tokens=True)
    ids, mask = tok.encode_batch(PROBE_TEXTS[:2])
    out = enc.encode_tokens(ids, mask)
    assert out.shape == (2, cfg.hidden_size), out.shape
    assert np.all(np.isfinite(out)), "non-finite embedding values"
    norms = np.linalg.norm(out, axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)
    # distinct inputs must embed distinctly (hf.rs:204-239's batch-of-2 test)
    assert float(np.dot(out[0], out[1])) < 0.999, "degenerate embeddings"
    return {"hidden": cfg.hidden_size, "layers": cfg.num_layers}


def check_chip_parity(ckpt: str, skip_chip: bool) -> dict:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from better_search_rag_rust_tpu.models.nomic import (
        NomicEncoder, load_hf_checkpoint,
    )

    platform = jax.devices()[0].platform
    if skip_chip:
        raise _Skip("--skip-chip")
    if platform != "gpu":
        raise _Skip(f"no GPU attached (platform={platform}); run on the "
                    "card for the bf16 attention parity leg")
    cfg, params = load_hf_checkpoint(ckpt)
    tok = _tokenizer(ckpt, add_special_tokens=True)
    ids, mask = tok.encode_batch(PROBE_TEXTS)
    fast = NomicEncoder(dataclasses.replace(cfg, attention_impl="auto"),
                        params=params).encode_tokens(ids, mask)
    ref_cfg = dataclasses.replace(cfg, dtype=jnp.float32,
                                  attention_impl="xla")
    with jax.default_matmul_precision("highest"):
        ref = NomicEncoder(ref_cfg, params=params).encode_tokens(ids, mask)
    cos = np.sum(fast * ref, axis=1)  # both rows are unit-norm
    assert cos.min() >= 0.999, f"bf16 vs f32 cosine {cos.min():.6f} < 0.999"
    return {"platform": platform, "min_cosine": float(cos.min())}


class _Skip(Exception):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint-dir",
                    default=os.environ.get("BSR_CHECKPOINT_DIR"))
    ap.add_argument("--out", default=str(REPO / "PARITY_REAL.json"))
    ap.add_argument("--write-golden", action="store_true",
                    help="(re)generate tests/golden/tokenizer_real_golden"
                         ".json from this checkpoint's tokenizer")
    ap.add_argument("--skip-chip", action="store_true")
    args = ap.parse_args(argv)
    if not args.checkpoint_dir:
        ap.error("set BSR_CHECKPOINT_DIR or pass --checkpoint-dir")
    ckpt = args.checkpoint_dir

    stages = [
        ("tokenizer_contract", lambda: check_tokenizer_contract(ckpt)),
        ("tokenizer_golden",
         lambda: check_tokenizer_golden(ckpt, args.write_golden)),
        ("golden_suite", lambda: check_golden_suite(ckpt)),
        ("real_forward", lambda: check_real_forward(ckpt)),
        ("chip_parity", lambda: check_chip_parity(ckpt, args.skip_chip)),
    ]
    checks: dict = {}
    failed = False
    for name, fn in stages:
        try:
            detail = fn()
            checks[name] = {"status": "pass", **(detail or {})}
        except _Skip as s:
            checks[name] = {"status": "skip", "reason": str(s)}
        except Exception as exc:  # noqa: BLE001 — record, keep going
            failed = True
            checks[name] = {
                "status": "fail",
                "error": f"{type(exc).__name__}: {exc}",
                "trace": traceback.format_exc(limit=4),
            }
        print(f"[verify_checkpoint] {name}: {checks[name]['status']}",
              flush=True)

    verdict = {
        "checkpoint_dir": str(ckpt),
        "verdict": "FAIL" if failed else "PASS",
        "checks": checks,
    }
    Path(args.out).write_text(json.dumps(verdict, indent=2))
    print(f"[verify_checkpoint] verdict: {verdict['verdict']} -> {args.out}",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
