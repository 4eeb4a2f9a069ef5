"""Exact top-k primitives: serial oracle, streaming merge, per-shard scan.

This replaces the reference's brute-force scan + hand-rolled distributed merge
(reference: src/mpi_helpers/metrics.rs:16-171):

* ``serial_topk``          — the NumPy serial-scan oracle. The reference's
  sequential baseline and correctness oracle (``top_k_overlap(serial,
  parallel) == 1.0``, src/metrics.rs:98-141) generalize to this function.
* ``merge_topk``           — merge a candidate block into a running top-k.
  Replaces sort-whole-candidate-list-then-truncate
  (src/mpi_helpers/metrics.rs:141-171) with an O(k) carry.
* ``local_topk``           — one device's scan over its row block: a
  ``lax.scan`` whose body is a matmul + top-k merge. Replaces the
  per-row ``cosine_distance`` loop (src/mpi_helpers/metrics.rs:36-44).
  Two merge strategies:

  - ``"scan"``     — direct ``top_k(concat(carry, chunk_sims))``.
  - ``"blockmax"`` — hierarchical exact two-stage: reduce the chunk to
    per-128-row-block maxima, select the top-k blocks, and only sort the
    selected blocks' scores. Exact for every input, including ties (see
    proof in ``_merge_blockmax``), and much cheaper than a full sort when
    ``k`` is small relative to the chunk.

Ordering contract (matches the oracle): candidates sort by descending
similarity, ties broken by **lowest global row index** — the discipline the
reference gets from sorting distances then deduping on index
(src/mpi_helpers/metrics.rs:153-168). ``lax.top_k`` returns the first
occurrence among ties, and every concatenation in this module places
lower-index candidates first, so the property holds end to end.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

#: Sentinel similarity for padded rows; any valid cosine similarity is >= -1.
#: (int8 stores score the scaled integer dot, also within [-1-eps, 1+eps].)
PAD_SIM = -3.0
#: Row-block width for the hierarchical merge.
BLOCK = 128


def xla_sims(queries_cast: jax.Array, rows: jax.Array) -> jax.Array:
    """``[Q, RC] f32`` scores of store-dtype queries against store rows —
    the one scoring arithmetic shared by every kernel and the oracle.
    f32/bf16: HIGHEST-precision matmul with f32 accumulation (f32 stores
    never drop to TF32). int8: exact int32 dot, value-converted and scaled
    by the shared constant — bitwise equal across paths by integer
    exactness."""
    if jnp.dtype(rows.dtype) == jnp.int8:
        from .quantize import INT8_INV_SCALE2

        dots = jnp.dot(
            queries_cast, rows.T, preferred_element_type=jnp.int32
        )
        return dots.astype(jnp.float32) * jnp.float32(INT8_INV_SCALE2)
    return jnp.dot(
        queries_cast, rows.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


# ---------------------------------------------------------------------------
# Serial oracle (NumPy)
# ---------------------------------------------------------------------------


def serial_topk(
    store: Optional[np.ndarray], queries: np.ndarray, k: int,
    sims: np.ndarray | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact serial scan: ``(indices [Q, k'], distances [Q, k'])`` with
    ``k' = min(k, N)``, distances ascending, ties by lowest index.

    Semantics match the reference's sequential path: cosine distance with
    zero-magnitude rows at distance 1.0 and similarities clamped to [-1, 1]
    (src/metrics.rs:143-165), sorted ascending and truncated to k
    (src/mpi_helpers/metrics.rs:47-50).

    ``sims``: optionally supply precomputed ``[Q, N]`` similarities so the
    oracle *selects* independently over the same scores the engine computes —
    the same relationship the reference's parallel-vs-sequential check had
    (both paths shared one scalar cosine kernel, src/metrics.rs:143).
    ``store`` is then unused and may be None.
    """
    queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
    if sims is None:
        store = np.asarray(store, dtype=np.float32)

        def _norm(x):
            norms = np.sqrt(np.sum(x * x, axis=-1, keepdims=True))
            return x / np.where(norms == 0.0, 1.0, norms)

        sims = _norm(queries) @ _norm(store).T
    sims = np.asarray(sims, dtype=np.float32)
    n = sims.shape[1]
    k_eff = min(k, n)
    # Selection orders by the RAW f32 similarity (negation is exact), the
    # engine's comparator — NOT by the reported distance: ``1 - sim``
    # loses up to one ulp near sim ~ 0, collapsing distinct sims into a
    # spurious exact tie the engine would still order by score.
    # Distances are derived afterward for the reference's metric API
    # (1 - clamp(cos), src/metrics.rs:143-165).
    neg = -sims
    if k_eff < n:
        # Same order as a full stable argsort's first k: every row at or
        # above the k-th score (ties included) is a candidate, candidates
        # stay in ascending index order, and a stable sort by score keeps
        # the lowest index first among equal scores.
        kth = np.partition(neg, k_eff - 1, axis=1)[:, k_eff - 1]
        order = np.empty((neg.shape[0], k_eff), dtype=np.int64)
        for r in range(neg.shape[0]):
            cand = np.flatnonzero(neg[r] <= kth[r])
            order[r] = cand[np.argsort(neg[r, cand], kind="stable")[:k_eff]]
    else:
        order = np.argsort(neg, axis=1, kind="stable")
    dist = 1.0 - np.clip(np.take_along_axis(sims, order, axis=1), -1.0, 1.0)
    return order.astype(np.int64), dist


# ---------------------------------------------------------------------------
# Device-side merge primitives
# ---------------------------------------------------------------------------


def merge_topk(
    carry_vals: jax.Array,
    carry_ids: jax.Array,
    new_vals: jax.Array,
    new_ids: jax.Array,
    k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Merge ``[Q, M]`` candidates into a ``[Q, k]`` running top-k (by
    descending value). The carry is concatenated first so earlier (lower
    global index) candidates win ties."""
    vals = jnp.concatenate([carry_vals, new_vals], axis=1)
    ids = jnp.concatenate([carry_ids, new_ids], axis=1)
    top_vals, pos = jax.lax.top_k(vals, k)
    return top_vals, jnp.take_along_axis(ids, pos, axis=1)


def _merge_blockmax(
    carry_vals: jax.Array,
    carry_ids: jax.Array,
    sims: jax.Array,
    gids: jax.Array,
    k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Hierarchical exact merge of a ``[Q, C]`` chunk (C a multiple of 128).

    Stage 1 reduces the chunk to per-128-block maxima ``[Q, C/128]`` and
    selects the top ``kb = min(k, C/128)`` blocks per query; stage 2 sorts
    only the selected blocks' scores against the carry.

    Exactness (including ties): any element e of the chunk that belongs to
    the true top-k of (carry ∪ chunk) must come from a selected block.
    Suppose e's block was not selected. Each of the kb = k selected blocks
    has blockmax ≥ e's blockmax ≥ score(e); when equal, the selected block
    has a lower block index (``top_k`` keeps the first occurrence among
    ties), hence its max element has a lower global index than e. So the
    selected blocks contain ≥ k elements that precede e in the
    (score desc, index asc) order, and e cannot be in the top-k.
    """
    q, c = sims.shape
    nb = c // BLOCK
    kb = min(k, nb)
    sims3 = sims.reshape(q, nb, BLOCK)
    block_max = jnp.max(sims3, axis=2)  # [Q, NB]
    _, block_ids = jax.lax.top_k(block_max, kb)  # [Q, kb]
    # Gather selected blocks in ascending block-index order so the candidate
    # list is globally index-ascending and top_k's first-occurrence rule
    # resolves score ties to the lowest global index, exactly like the oracle.
    block_ids = jnp.sort(block_ids, axis=1)
    cand_vals = jnp.take_along_axis(
        sims3, block_ids[:, :, None], axis=1, mode="promise_in_bounds"
    ).reshape(q, kb * BLOCK)
    gids3 = jnp.broadcast_to(gids.reshape(1, nb, BLOCK), (q, nb, BLOCK))
    cand_ids = jnp.take_along_axis(
        gids3, block_ids[:, :, None], axis=1, mode="promise_in_bounds"
    ).reshape(q, kb * BLOCK)
    return merge_topk(carry_vals, carry_ids, cand_vals, cand_ids, k)


# ---------------------------------------------------------------------------
# Dense two-stage selection (no scan)
# ---------------------------------------------------------------------------


def _fast_topk(x: jax.Array, kk: int) -> Tuple[jax.Array, jax.Array]:
    """Exact ``(vals, positions)`` top-``kk`` of ``x [T, N]`` by (value
    desc, position asc) — same contract and tie discipline as
    ``lax.top_k``, but through the ``approx_max_k(recall_target=1.0)``
    PartialReduce fast path with the :func:`_select_blocks` certificate
    (count of elements >= the kk-th candidate value over the FULL row must
    match the count among candidates; any approx miss falls back to exact
    ``lax.top_k`` via ``lax.cond``). Narrow rows and huge k go straight to
    ``top_k``, where the candidate pass cannot shrink the work."""
    n = x.shape[1]
    # kp slack beyond kk only buys LESS frequent certificate fallback on
    # tie-saturated rows (never exactness — the fallback is exact top_k);
    # the approx reduce + repair sort cost scales with kp, so keep it tight.
    kp = min(n, max(kk + 24, 128))
    if kp >= n // 2 or kk > 1024:
        return jax.lax.top_k(x, kk)
    av, ap = jax.lax.approx_max_k(x, kp, recall_target=1.0)
    w = jax.lax.dynamic_slice_in_dim(av, kk - 1, 1, axis=1)
    row_count = jnp.sum((x >= w).astype(jnp.int32), axis=1)
    cand_count = jnp.sum((av >= w).astype(jnp.int32), axis=1)
    cert = jnp.all(row_count == cand_count)

    def fast(_):
        neg, ids = jax.lax.sort((-(av + 0.0), ap), num_keys=2)
        return -neg[:, :kk], ids[:, :kk]

    def exact(_):
        vals, ids = jax.lax.top_k(x, kk)
        return vals, ids  # tuple, matching fast (top_k returns a list)

    return jax.lax.cond(cert, fast, exact, None)


def _select_blocks(block_max: jax.Array, kb: int) -> jax.Array:
    """Top ``kb`` blocks of ``block_max [T, NB]`` by (max desc, block idx
    asc) — the oracle's tie discipline.

    Fast path: ``lax.approx_max_k(recall_target=1.0)`` with a
    runtime certificate counted against the FULL row: with ``w`` the
    ``kb``-th candidate value, if the number of elements ``>= w`` in the
    whole row equals the number among the returned candidates, then every
    element ``>= w`` is inside the candidate set, and since ``w <=`` the
    true kb-th value (the candidates are a subset of the row), that set
    covers the exact top-kb — the (value desc, index asc) top-kb follows
    from a two-key sort of the candidates alone. The certificate makes NO
    assumption about the approx op's recall or set-validity: a miss above
    the boundary shows up as a count mismatch and falls back to exact
    ``lax.top_k`` via ``lax.cond``. The logic now lives in
    :func:`_fast_topk` (the generalization used at every selection level);
    this stays as the named block-selection entry point.
    """
    return _fast_topk(block_max, kb)[1]


def _dense_chunk_topk(
    shard_chunk: jax.Array,
    q_block: jax.Array,
    k: int,
    gid_base,
    valid_rows,
    block: int,
) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k of ``q_block [T, D]`` against one resident row chunk
    ``[RC, D]``: one matmul, per-block maxima, top-kb block selection,
    candidate gather, one final ``top_k``.

    ``gid_base``: global row id of chunk row 0 (may be traced).
    ``valid_rows``: valid row count within the chunk (may be traced); rows
    beyond it score ``PAD_SIM`` and their candidate ids are INT32_MAX.
    Returns ``(vals [T, k], gids [T, k])``, vals descending, ties by lowest
    global row index.
    """
    rc, _d = shard_chunk.shape
    t = q_block.shape[0]
    nb = rc // block
    kb = min(k, nb)
    base_i32 = (
        gid_base.astype(jnp.int32)
        if hasattr(gid_base, "astype")
        else jnp.int32(gid_base)
    )
    limit = jnp.asarray(valid_rows, dtype=jnp.int32)

    local_ids = jnp.arange(rc, dtype=jnp.int32)
    sims = xla_sims(q_block, shard_chunk)  # [T, RC] f32
    sims = jnp.where((local_ids < limit)[None, :], sims, PAD_SIM)
    sims3 = sims.reshape(t, nb, block)
    block_max = jnp.max(sims3, axis=2)  # [T, NB]

    block_ids = _select_blocks(block_max, kb)
    block_ids = jnp.sort(block_ids, axis=1)  # ascending: oracle tie order
    # promise_in_bounds: block_ids are top_k positions into [0, nb) by
    # construction; skipping the clamp speeds the sims rescan ~20%
    # (chip-measured on the group-selection pool gather).
    cand_vals = jnp.take_along_axis(
        sims3, block_ids[:, :, None], axis=1, mode="promise_in_bounds"
    ).reshape(t, kb * block)
    local_cand = (
        block_ids[:, :, None] * block
        + jnp.arange(block, dtype=jnp.int32)[None, None, :]
    ).reshape(t, kb * block)
    # Padded rows keep PAD_SIM scores, but their gids must not leak into the
    # merged candidate stream looking valid: mark them unmistakably invalid.
    cand_ids = jnp.where(
        local_cand < limit, base_i32 + local_cand, jnp.iinfo(jnp.int32).max
    )
    if kb * block < k:  # tiny chunk: fewer rows than k — pad candidates
        pad = k - kb * block
        cand_vals = jnp.pad(cand_vals, ((0, 0), (0, pad)),
                            constant_values=PAD_SIM)
        cand_ids = jnp.pad(cand_ids, ((0, 0), (0, pad)),
                           constant_values=jnp.iinfo(jnp.int32).max)
    # top_k keeps the first occurrence among ties and the candidates are
    # laid out index-ascending, so the oracle's tie order falls out free.
    top_vals, pos = jax.lax.top_k(cand_vals, k)
    return top_vals, jnp.take_along_axis(cand_ids, pos, axis=1)


def global_topk(
    shard: jax.Array,
    queries_cast: jax.Array,
    k: int,
    base: jax.Array,
    num_rows: int,
    q_tile: int = 256,
    block: int = BLOCK,
    macro_rows: int = 4 * 1024 * 1024,
) -> Tuple[jax.Array, jax.Array]:
    """One device's exact top-k via dense two-stage block selection.

    Unlike :func:`local_topk` (a ``lax.scan`` of chunk matmuls with a top-k
    merge per chunk), this computes a ``[T, macro]`` similarity tile in ONE
    matmul, reduces it to per-128-row block maxima, selects the top
    ``min(k, n_blocks)`` blocks *once*, gathers only those blocks' scores,
    and runs ONE final ``top_k``. Exactness argument is identical to
    :func:`_merge_blockmax`; ties resolve to the lowest global row index
    because blocks are gathered in ascending block order and ``top_k`` keeps
    the first occurrence.

    ``q_tile`` bounds the f32 similarity buffer (``q_tile * macro * 4``
    bytes); query tiles run under ``lax.map`` so peak memory stays flat
    while the matmul stays large.

    ``macro_rows`` caps the rows scored per matmul: shards larger than that
    are processed as a ``lax.scan`` over macro chunks with an O(k) running
    merge, so the f32 sims buffer stays bounded WITHOUT shrinking the query
    tile (a narrower query tile would re-stream the whole shard once per
    tile).
    """
    rows_valid, d = shard.shape
    q = queries_cast.shape[0]
    q_tile = max(1, min(q_tile, q))

    align = block
    macro = min(max(align, (macro_rows // align) * align),
                rows_valid + (-rows_valid) % align)
    n_full = rows_valid // macro
    tail = rows_valid - n_full * macro

    base_i32 = base.astype(jnp.int32) if hasattr(base, "astype") else jnp.int32(base)
    # Rows past the shard's valid count OR past the global row count are
    # padding (a locally padded row's gid may collide with the next shard's).
    total_valid = jnp.minimum(jnp.int32(rows_valid), num_rows - base_i32)

    # Memory discipline: the scan part is a PREFIX view of the shard
    # (reshape of a contiguous slice — no copy); only the sub-macro tail is
    # padded, which copies at most ~macro rows instead of repadding the
    # whole shard (a full jnp.pad inside jit materializes a second copy of
    # the store).
    tail_rows = tail + ((-tail) % align) if tail else 0
    tail_part = None
    if tail_rows:
        tail_part = shard[n_full * macro:]
        if tail_rows != tail:
            tail_part = jnp.pad(tail_part, ((0, tail_rows - tail), (0, 0)))

    pad_q = (-q) % q_tile
    padded_queries = (
        jnp.concatenate(
            [queries_cast, jnp.zeros((pad_q, shard.shape[1]), shard.dtype)]
        )
        if pad_q
        else queries_cast
    )
    n_tiles = padded_queries.shape[0] // q_tile
    tiles = padded_queries.reshape(n_tiles, q_tile, shard.shape[1])

    def tile_fn(q_block):
        if n_full == 1 and not tail_rows:
            return _dense_chunk_topk(
                shard, q_block, k, base_i32, total_valid, block
            )
        if n_full == 0:
            return _dense_chunk_topk(
                tail_part, q_block, k, base_i32, total_valid, block
            )
        # Chunk loop unrolled in Python, NOT lax.scan: chunk counts are tiny
        # and static slices let XLA alias the shard buffer — a scan
        # dynamic-slices a multi-GB chunk copy per iteration.
        vals, ids = None, None
        for c in range(n_full):
            off = c * macro
            v, i = _dense_chunk_topk(
                shard[off: off + macro], q_block, k, base_i32 + off,
                jnp.clip(total_valid - off, 0, macro), block,
            )
            # Carry first: earlier chunks hold lower gids, so top_k's
            # first-occurrence rule keeps the oracle's tie order.
            vals, ids = (v, i) if vals is None else merge_topk(vals, ids, v, i, k)
        if tail_rows:
            off = n_full * macro
            v, i = _dense_chunk_topk(
                tail_part, q_block, k, base_i32 + off,
                jnp.clip(total_valid - off, 0, tail_rows), block,
            )
            vals, ids = merge_topk(vals, ids, v, i, k)
        return vals, ids

    vals, ids = jax.lax.map(tile_fn, tiles)
    vals = vals.reshape(n_tiles * q_tile, k)[:q]
    ids = ids.reshape(n_tiles * q_tile, k)[:q]
    return vals, ids


def local_topk(
    shard: jax.Array,
    queries_cast: jax.Array,
    k: int,
    chunk: int,
    base: jax.Array,
    num_rows: int,
    kernel: str = "scan",
) -> Tuple[jax.Array, jax.Array]:
    """One device's exact top-k over its ``[rows_local, D]`` block.

    ``base`` is the device's global row offset (the ``global_idx =
    start_index + i`` translation, reference: src/mpi_helpers/metrics.rs:41).
    Rows with global index >= ``num_rows`` are padding and are masked to
    ``PAD_SIM``. Returns ``(vals [Q, k], ids [Q, k])`` with vals descending.
    """
    rows_local, _d = shard.shape
    if rows_local % chunk:
        raise ValueError(f"rows_local {rows_local} not divisible by {chunk}")
    n_chunks = rows_local // chunk
    q = queries_cast.shape[0]

    chunked = shard.reshape(n_chunks, chunk, shard.shape[1])
    starts = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    local_offsets = jnp.arange(chunk, dtype=jnp.int32)

    def body(carry, xs):
        c_vals, c_ids = carry
        chunk_data, chunk_start = xs
        sims = xla_sims(queries_cast, chunk_data)  # [Q, chunk] f32
        gids = base.astype(jnp.int32) + chunk_start + local_offsets
        sims = jnp.where((gids < num_rows)[None, :], sims, PAD_SIM)
        gids_b = jnp.broadcast_to(gids[None, :], sims.shape)
        if kernel == "blockmax" and chunk % BLOCK == 0 and chunk // BLOCK > 1:
            new = _merge_blockmax(c_vals, c_ids, sims, gids, k)
        else:
            new = merge_topk(c_vals, c_ids, sims, gids_b, k)
        return new, None

    # The carry must have the same varying-axes type as the scan body output;
    # deriving it from ``base`` (device-varying inside shard_map, a plain
    # scalar outside) keeps this function usable in both contexts.
    base_i32 = base.astype(jnp.int32) if hasattr(base, "astype") else jnp.int32(base)
    init = (
        jnp.full((q, k), PAD_SIM, dtype=jnp.float32) + 0.0 * base_i32.astype(jnp.float32),
        jnp.full((q, k), jnp.iinfo(jnp.int32).max, dtype=jnp.int32) - 0 * base_i32,
    )
    (vals, ids), _ = jax.lax.scan(body, init, (chunked, starts))
    return vals, ids
