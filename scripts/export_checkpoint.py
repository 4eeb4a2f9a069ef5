#!/usr/bin/env python
"""Export nomic-embed-text-v1.5 from the HF hub into a local checkpoint dir.

Run this on a machine WITH network access, then point ``BSR_CHECKPOINT_DIR``
at the output directory (copy it into the zero-egress environment if needed):

    python scripts/export_checkpoint.py --out /path/to/nomic-embed-text-v1.5
    BSR_CHECKPOINT_DIR=/path/to/nomic-embed-text-v1.5 python -m pytest \
        tests/test_golden_parity.py -q

This is the analogue of the reference's on-demand model export
(run-slurm.sh:27-32 runs ``optimum-cli export onnx`` before every job); the
framework consumes the raw HF checkpoint directly (safetensors/.bin +
config.json + tokenizer.json — see ``models/nomic.py load_hf_checkpoint`` and
``models/tokenizer.py load_tokenizer``), so the export is a plain snapshot
download, no ONNX conversion step.

The produced directory enables, in order of strength:
  * the real-tokenizer path (``tokenizer.json``),
  * the JAX forward on real weights (``*.safetensors`` + ``config.json``),
  * the definitive torch-vs-JAX cross-implementation check when the
    checkpoint's own ``modeling_hf_nomic_bert.py`` is present
    (``tests/test_golden_parity.py::test_real_checkpoint_cross_implementation``),
  * on-card encoder parity (``scripts/verify_checkpoint.py``'s
    ``chip_parity`` stage).
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

MODEL_ID = "nomic-ai/nomic-embed-text-v1.5"

#: Everything the framework + parity tests can consume. Weights come first;
#: the trailing entries (modeling code) are optional but unlock the
#: cross-implementation check.
WANTED = [
    "config.json",
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
    "vocab.txt",
    "model.safetensors",
    "pytorch_model.bin",
    "configuration_hf_nomic_bert.py",
    "modeling_hf_nomic_bert.py",
]


def export(out: Path, model_id: str = MODEL_ID, revision: str | None = None) -> int:
    out.mkdir(parents=True, exist_ok=True)
    try:
        from huggingface_hub import hf_hub_download
    except ImportError:
        print(
            "huggingface_hub is not installed; on a connected machine run\n"
            "  pip install huggingface_hub\n"
            "or download the files manually from "
            f"https://huggingface.co/{model_id}/tree/main into {out}:",
            file=sys.stderr,
        )
        for name in WANTED:
            print(f"  {name}", file=sys.stderr)
        return 1

    got_weights = False
    for name in WANTED:
        try:
            path = hf_hub_download(model_id, name, revision=revision)
        except Exception as exc:
            # Not every checkpoint ships every filename (e.g. only one of
            # model.safetensors / pytorch_model.bin exists).
            print(f"  skip {name}: {type(exc).__name__}")
            continue
        shutil.copy2(path, out / name)
        print(f"  {name} -> {out / name}")
        if name.endswith((".safetensors", ".bin")):
            got_weights = True

    if not got_weights:
        print("ERROR: no weight file downloaded", file=sys.stderr)
        return 1
    if not (out / "config.json").exists() or not (out / "tokenizer.json").exists():
        print("ERROR: config.json / tokenizer.json missing", file=sys.stderr)
        return 1
    print(f"\nExport complete. Use it with:\n  BSR_CHECKPOINT_DIR={out}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, required=True,
                    help="output checkpoint directory (BSR_CHECKPOINT_DIR)")
    ap.add_argument("--model", default=MODEL_ID,
                    help=f"HF hub model id (default {MODEL_ID})")
    ap.add_argument("--revision", default=None,
                    help="optional hub revision/commit to pin")
    args = ap.parse_args()
    return export(args.out, args.model, args.revision)


if __name__ == "__main__":
    raise SystemExit(main())
