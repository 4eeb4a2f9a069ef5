"""Deterministic hash encoder — the hermetic embedding backend.

The reference tests its store/metrics layers with random vectors instead of a
fake model (src/utils.rs:14-27) and gates real-model tests on an on-disk ONNX
artifact (src/llm/hf.rs:138-144). This module combines both ideas into a
*runnable backend*: a tiny fixed "model" (token-hash -> embedding-table gather
-> masked mean -> L2 norm) that

* is fully deterministic across hosts and runs (seeded table),
* exercises the exact same fixed-shape ``[B, S]`` jitted path as the real
  encoder (tokenize -> device forward -> ``[B, D]`` f32), and
* needs zero artifacts, so the end-to-end pipeline, tests, and ingest
  benchmarks run hermetically.

Semantically it is a random-projection bag-of-words: similar files share
tokens and thus land near each other, so self-retrieval (the reference's
accuracy check, src/mpi_helpers/metrics.rs:217-249) behaves sensibly.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .tokenizer import HashingTokenizer


class HashEncoder:
    """Text -> deterministic ``[B, dim]`` f32 embeddings."""

    def __init__(
        self,
        dim: int = 768,
        max_tokens: int = 512,
        vocab_size: int = 30528,
        seed: int = 0,
        dtype: str = "bfloat16",
    ):
        self.dim = dim
        self.max_tokens = max_tokens
        self.tokenizer = HashingTokenizer(vocab_size, max_tokens)
        # Deterministic table; unit-normal so pooled vectors are well-scaled.
        # Generated host-side: numpy is stable across backends/JAX versions.
        table = np.random.default_rng(seed).standard_normal(
            (vocab_size, dim), dtype=np.float32
        )
        self.table = jax.device_put(table).astype(jnp.dtype(dtype))

        @jax.jit
        def fwd(table, ids, mask):
            emb = jnp.take(table, ids, axis=0)  # [B, S, D]
            m = mask.astype(jnp.float32)[:, :, None]
            pooled = jnp.sum(emb.astype(jnp.float32) * m, axis=1)
            pooled = pooled / jnp.maximum(jnp.sum(m, axis=1), 1.0)
            norms = jnp.sqrt(jnp.sum(pooled * pooled, axis=-1, keepdims=True))
            return pooled / jnp.where(norms == 0.0, 1.0, norms)

        self._fwd = fwd

    def encode_tokens_device(
        self, input_ids: np.ndarray, attention_mask: np.ndarray
    ) -> jax.Array:
        """Device-resident forward (dispatches pipeline; see
        EncoderService.dispatch)."""
        return self._fwd(
            self.table,
            jnp.asarray(input_ids, dtype=jnp.int32),
            jnp.asarray(attention_mask, dtype=jnp.int32),
        )

    def encode_tokens(
        self, input_ids: np.ndarray, attention_mask: np.ndarray
    ) -> np.ndarray:
        out = self.encode_tokens_device(input_ids, attention_mask)
        return np.asarray(jax.device_get(out), dtype=np.float32)
