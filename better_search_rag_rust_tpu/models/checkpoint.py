"""Model parameter checkpointing.

The reference's only model artifact is an offline ONNX export
(reference: environment.yaml:8-11, run-slurm.sh:27-32); there is no way to
persist a modified model because nothing can modify one. With the
contrastive trainer (:mod:`.train`) the framework can, so params get a
checkpoint story: one ``params.npz`` per checkpoint directory, keyed by the
``/``-joined path of each leaf in the parameter tree, written atomically.
Sharded arrays are gathered to the host on save, so the writing process
must address every shard (one process per host, as the CLI runs).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

import jax
import numpy as np

_FILE = "params.npz"


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "/"))
        else:
            out[name] = val
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict:
    tree: Dict = {}
    for name, val in flat.items():
        node = tree
        *parents, leaf = name.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = val
    return tree


def save_params(path: str | os.PathLike, params: Dict) -> None:
    """Write a param tree (sharded arrays welcome) under directory
    ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    arrays = {
        name: np.asarray(jax.device_get(leaf), dtype=np.float32)
        for name, leaf in _flatten(params).items()
    }
    tmp = path / f"{_FILE}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path / _FILE)


def load_params(path: str | os.PathLike, like: Optional[Dict] = None) -> Dict:
    """Read a param tree. ``like`` (a tree of arrays, e.g. a freshly
    initialized and sharded model) places each leaf with the matching
    leaf's sharding; without it, leaves arrive as host NumPy arrays."""
    with np.load(Path(path) / _FILE, allow_pickle=False) as blob:
        tree = _unflatten({name: blob[name] for name in blob.files})
    if like is None:
        return tree
    return jax.tree.map(
        lambda arr, ref: jax.device_put(arr.astype(ref.dtype), ref.sharding),
        tree, like,
    )
