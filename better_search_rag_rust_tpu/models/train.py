"""Contrastive fine-tuning of the embedding model over a device mesh.

The reference has no training at all — its encoder is a frozen ONNX artifact
exported offline (reference: environment.yaml:8-11, run-slurm.sh:27-32), and
retrieval quality is whatever the checkpoint gives. This module adds the
capability the reference's architecture could never host: in-place
contrastive adaptation of the retriever (InfoNCE over in-batch negatives, the
objective family nomic-embed itself was trained with), sharded over a 2-D
``(data, model)`` mesh:

* **DP** — the batch is block-sharded over the ``data`` axis; gradients are
  combined by XLA's automatic ``psum`` (no hand-written all_reduce).
* **TP** — attention QKV / output projections and the SwiGLU MLP are sharded
  over the ``model`` axis (column-then-row parallel, so each block needs one
  reduce per projection pair and XLA inserts it).
* Logits for InfoNCE use the *global* batch as negatives: embeddings are
  replicated via sharding constraints, so every anchor sees every positive —
  equivalent to an all_gather of negatives, expressed declaratively.

Everything is a pure function under ``jax.jit`` with ``NamedSharding``
annotations — no data-dependent Python control flow, static shapes.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .nomic import NomicBertConfig, embed, init_params

DATA_AXIS = "data"
MODEL_AXIS = "model"


# ---------------------------------------------------------------------------
# Parameter sharding rules (tensor parallelism)
# ---------------------------------------------------------------------------


def _spec_for_path(path: Tuple[str, ...]) -> P:
    """Megatron-style column/row split of each transformer block:

    * ``Wqkv``/``fc11``/``fc12`` kernels  -> split output features (column)
    * ``out_proj``/``fc2`` kernels        -> split input features (row)
    * embeddings, norms, biases           -> replicated
    """
    names = set(path)
    if "kernel" in path:
        if names & {"Wqkv", "fc11", "fc12", "fc1"}:
            return P(None, MODEL_AXIS)
        if names & {"out_proj", "fc2"}:
            return P(MODEL_AXIS, None)
    return P()


def param_specs(params: Dict) -> Dict:
    """PartitionSpec tree matching ``params``."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    specs = {}
    for path, _leaf in flat:
        keys = tuple(
            k.key if hasattr(k, "key") else str(k) for k in path
        )
        specs[keys] = _spec_for_path(keys)

    def build(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (k,)) for k, v in tree.items()}
        return specs[prefix]

    return build(params)


def shard_params(params: Dict, mesh: Mesh) -> Dict:
    """Place a host param tree onto the mesh under the TP specs."""
    specs = param_specs(params)
    return jax.tree.map(
        lambda leaf, spec: jax.device_put(leaf, NamedSharding(mesh, spec)),
        params,
        specs,
    )


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def info_nce_loss(
    anchor_emb: jax.Array, positive_emb: jax.Array, temperature: float = 0.05
) -> jax.Array:
    """Symmetric InfoNCE with in-batch negatives. ``[B, D] x [B, D] ->``
    scalar. Diagonal pairs are positives; all off-diagonal rows/cols are
    negatives."""
    logits = (
        jnp.dot(
            anchor_emb, positive_emb.T, preferred_element_type=jnp.float32
        )
        / temperature
    )
    labels = jnp.arange(logits.shape[0])
    loss_a = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
    loss_b = optax.softmax_cross_entropy_with_integer_labels(logits.T, labels)
    return 0.5 * (jnp.mean(loss_a) + jnp.mean(loss_b))


# ---------------------------------------------------------------------------
# Train state + step
# ---------------------------------------------------------------------------


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jax.Array


class ContrastiveTrainer:
    """Jitted contrastive training over a ``(data, model)`` mesh."""

    def __init__(
        self,
        config: NomicBertConfig,
        mesh: Mesh,
        learning_rate: float = 2e-5,
        temperature: float = 0.05,
        seed: int = 0,
        params: Optional[Dict] = None,
        sequence_parallel: bool = True,
    ):
        import dataclasses

        if (
            sequence_parallel
            and mesh.shape.get(MODEL_AXIS, 1) > 1
            and config.max_tokens % mesh.shape[MODEL_AXIS] == 0
            and config.sp_mesh_axes is None
        ):
            # SP over the TP axis: residual-stream norms split their
            # sequence dim across 'model' (see nomic._sp_constrain).
            config = dataclasses.replace(
                config, sp_mesh_axes=(DATA_AXIS, MODEL_AXIS)
            )
        self.config = config
        self.mesh = mesh
        self.tx = optax.adamw(learning_rate)

        if params is None:
            params = init_params(config, seed)
        params = shard_params(params, mesh)
        opt_state = self.tx.init(params)
        self.state = TrainState(params, opt_state, jnp.zeros((), jnp.int32))

        batch_sharding = NamedSharding(mesh, P(DATA_AXIS, None))
        repl = NamedSharding(mesh, P())

        def loss_fn(params, a_ids, a_mask, p_ids, p_mask):
            anchor = embed(params, a_ids, a_mask, config)
            positive = embed(params, p_ids, p_mask, config)
            # Global in-batch negatives: pull both embedding matrices to a
            # replicated layout (XLA emits the all_gather).
            anchor = jax.lax.with_sharding_constraint(anchor, repl)
            positive = jax.lax.with_sharding_constraint(positive, repl)
            return info_nce_loss(anchor, positive, temperature)

        tx = self.tx

        def step_fn(state: TrainState, a_ids, a_mask, p_ids, p_mask):
            loss, grads = jax.value_and_grad(loss_fn)(
                state.params, a_ids, a_mask, p_ids, p_mask
            )
            updates, opt_state = tx.update(
                grads, state.opt_state, state.params
            )
            params = optax.apply_updates(state.params, updates)
            return TrainState(params, opt_state, state.step + 1), loss

        # Input shardings are carried by the arrays themselves: params were
        # placed by :func:`shard_params`, the optimizer state inherits the
        # param shardings at init, and batches are device_put below — jit
        # honours committed input layouts, so no in_shardings tree is needed.
        self._batch_sharding = batch_sharding
        self._step = jax.jit(step_fn, donate_argnums=(0,))

    def train_step_device(
        self,
        a_ids: np.ndarray,
        a_mask: np.ndarray,
        p_ids: np.ndarray,
        p_mask: np.ndarray,
    ) -> jax.Array:
        """One optimizer step; returns the loss STILL ON DEVICE so callers
        can pipeline steps without a synchronous readback per step (the
        bench suite reads the loss back once at the end)."""
        to_dev = lambda x: jax.device_put(
            np.asarray(x, dtype=np.int32), self._batch_sharding
        )
        # Mesh context so P(...)-form sharding constraints (the SP
        # annotations inside the model) resolve axis names.
        with jax.set_mesh(self.mesh):
            self.state, loss = self._step(
                self.state, to_dev(a_ids), to_dev(a_mask),
                to_dev(p_ids), to_dev(p_mask),
            )
        return loss

    def train_step(
        self,
        a_ids: np.ndarray,
        a_mask: np.ndarray,
        p_ids: np.ndarray,
        p_mask: np.ndarray,
    ) -> float:
        """One optimizer step; returns the loss (synchronous)."""
        return float(jax.device_get(
            self.train_step_device(a_ids, a_mask, p_ids, p_mask)
        ))
