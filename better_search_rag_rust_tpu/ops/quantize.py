"""Symmetric int8 quantization for the scored store.

The int8 store dtype trades a one-time, bounded quantization of the row
DIRECTIONS for the int8 tensor-core rate (twice bf16's on the data sheet)
and half of bf16's memory footprint/traffic. The contract:

* store rows are L2-normalized in f32 (the reference's zero-magnitude
  guard included, reference: src/metrics.rs:157-159) and then mapped onto
  the symmetric int8 lattice ``round(x * 127)`` (clipped to [-127, 127];
  -128 is never produced, keeping the scale symmetric);
* queries take the identical normalize + quantize mapping;
* the score is ``f32(int32_dot(q_i8, s_i8)) * INT8_INV_SCALE2`` — the
  integer dot is EXACT (768-dim worst case |dot| <= 768 * 127^2 ~ 1.2e7,
  far below both int32 overflow and f32's 2^24 integer-exact range), so
  every accumulation order, every backend (XLA GPU, XLA CPU, NumPy) and
  every kernel produce bitwise-identical scores. The exactness story is
  STRONGER than bf16's, which rests on every path sharing one scoring
  arithmetic (``ops.topk.xla_sims``): here it is a property of integer
  arithmetic itself.

Like the bf16 store, the serial oracle is defined over the SAME
dtype-rounded rows: ``top_k_overlap(oracle, engine) == 1.0`` holds exactly,
ties (equal int32 dots) resolving to the lowest store row index. What the
quantization costs is fidelity to the ORIGINAL f32 vectors — the score is
the scaled integer dot of the quantized directions (the standard scalar-
quantization retrieval semantic), not the f32 cosine; rank inversions vs
the f32 oracle are confined to neighbor pairs whose true similarities
differ by less than the lattice error (~1e-2 worst case per coordinate
pair, ~4e-3 rms at 768-d). Measure with
:func:`..metrics.quality.top_k_overlap` against an f32 engine when that
trade matters.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

#: Lattice scale: normalized coordinates in [-1, 1] map to [-127, 127].
INT8_SCALE = 127.0
#: f32(1 / 127^2), the one scaling constant every scoring path multiplies
#: the exact integer dot by. A single shared f32 constant + one f32
#: multiply per score keeps the scaled values bitwise identical across
#: kernels and the NumPy oracle.
INT8_INV_SCALE2 = float(np.float32(1.0) / np.float32(INT8_SCALE * INT8_SCALE))


def is_int8(dtype) -> bool:
    return jnp.dtype(dtype) == jnp.int8


def quantize_unit(x: jax.Array) -> jax.Array:
    """Device map of f32 (unit-norm) rows onto the int8 lattice:
    ``clip(round(x * 127), -127, 127)``. ``round`` is IEEE
    round-half-to-even, matching :func:`quantize_unit_host` bit for bit."""
    return jnp.clip(
        jnp.round(x.astype(jnp.float32) * jnp.float32(INT8_SCALE)),
        -INT8_SCALE,
        INT8_SCALE,
    ).astype(jnp.int8)


def quantize_unit_host(x: np.ndarray) -> np.ndarray:
    """Host (NumPy) twin of :func:`quantize_unit`: same f32 multiply, same
    round-half-to-even (``np.rint``), same clip — bitwise identical ids."""
    return np.clip(
        np.rint(np.asarray(x, dtype=np.float32) * np.float32(INT8_SCALE)),
        -INT8_SCALE,
        INT8_SCALE,
    ).astype(np.int8)


def cast_rows_to(x: jax.Array, dtype) -> jax.Array:
    """Normalized f32 rows -> store dtype: lattice quantization for int8,
    plain cast otherwise (the one place the two store families differ)."""
    if is_int8(dtype):
        return quantize_unit(x)
    return x.astype(dtype)


def cast_rows_to_host(x: np.ndarray, dtype) -> np.ndarray:
    """Host twin of :func:`cast_rows_to`."""
    if is_int8(dtype):
        return quantize_unit_host(x)
    return np.asarray(x).astype(jnp.dtype(dtype))


def int8_sims_host(store_i8: np.ndarray, queries_i8: np.ndarray) -> np.ndarray:
    """The NumPy oracle's ``[Q, N]`` scaled scores over int8 operands:
    exact int32 dot, f32 value-convert (exact below 2^24), ONE f32 multiply
    by :data:`INT8_INV_SCALE2` — bitwise equal to every device kernel."""
    dots = queries_i8.astype(np.int32) @ store_i8.astype(np.int32).T
    return dots.astype(np.float32) * np.float32(INT8_INV_SCALE2)
