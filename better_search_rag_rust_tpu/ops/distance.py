"""Batched cosine distance primitives.

The reference scores one (query, row) pair at a time with a scalar loop
(reference: src/metrics.rs:143-165 ``cosine_distance`` called per row in
src/mpi_helpers/metrics.rs:36-44). Here the same math is one matmul over
normalized operands; these helpers define that mapping and its edge-case
semantics:

* zero-magnitude rows normalize to the zero vector, so their similarity is 0
  and their distance is exactly 1.0 — matching src/metrics.rs:157-159;
* similarities are clamped to [-1, 1] before ``1 - sim`` — matching
  src/metrics.rs:162-164.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def normalize_rows(x: jax.Array) -> jax.Array:
    """Row-wise L2 normalization in float32 with the zero-magnitude guard."""
    x = x.astype(jnp.float32)
    norms = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
    return x / jnp.where(norms == 0.0, 1.0, norms)


def similarity_matrix(
    queries_norm: jax.Array, store_norm: jax.Array
) -> jax.Array:
    """[Q, N] cosine similarities of pre-normalized operands, accumulated in
    float32 regardless of operand dtype."""
    return jnp.dot(
        queries_norm, store_norm.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def cosine_distance_matrix(queries: jax.Array, store: jax.Array) -> jax.Array:
    """[Q, N] cosine distances with reference edge-case semantics. Intended
    for small stores and tests; the engine path never materializes [Q, N]."""
    sims = similarity_matrix(normalize_rows(queries), normalize_rows(store))
    return 1.0 - jnp.clip(sims, -1.0, 1.0)
