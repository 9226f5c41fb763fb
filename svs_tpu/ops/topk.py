"""Exact cosine scoring + top-k on device (single chip).

The retrieval hot path is two fused stages under one ``jit``:

1. ``scores = docs @ queries.T`` — one matmul over the device-resident
   corpus (bf16 or f32 storage, always f32 accumulation via
   ``preferred_element_type``), replacing the reference's NumPy GEMV
   (``svs/kb.py:1185``).
2. masked top-k — padding rows (index >= n_valid) are forced to ``-inf``
   before selection, so padding can never appear in results.

Shapes are static: corpora are padded to tile multiples at pack time and
``k`` is a Python int (jit caches one executable per distinct ``k``).
"""

from __future__ import annotations

import functools
from typing import Any, Tuple

import jax
import jax.numpy as jnp

NEG_INF = float("-inf")


def f32_dot_precision(dtype: "jnp.dtype | None") -> "jax.lax.Precision | None":
    """Dot precision for a float dot whose operands have ``dtype``.

    At DEFAULT precision the GPU runs an f32 x f32 dot on the tensor
    cores in TF32, which keeps a 10-bit mantissa: ~1e-3 relative error,
    far above the 1e-4 the engine's error bounds claim for f32 corpora.
    HIGHEST asks for true f32 arithmetic — required for the f32 scoring
    paths and for every exact-rescore dot.  bf16 operands with f32
    accumulation are exact as specified at DEFAULT (the product of two
    bf16 values fits an f32), so they keep ``None``.
    """
    return jax.lax.Precision.HIGHEST if dtype == jnp.float32 else None


def scores_matmul(docs: jax.Array, queries: jax.Array) -> jax.Array:
    """Cosine scores of every (query, doc) pair: ``[B, N]`` f32.

    ``docs`` is ``[N, d]`` (any float dtype), ``queries`` is ``[B, d]``.
    Because stored vectors are unit-norm, the plain dot product *is* the
    cosine similarity.

    Queries are cast to the docs' storage dtype so a bf16 corpus runs a
    bf16xbf16 matmul (half the memory traffic) instead of being silently
    promoted to f32; accumulation stays f32 either way.  f32 corpora run
    at HIGHEST precision so the result is a true f32 dot (see
    :func:`f32_dot_precision`) — the engine's f32 error bound depends on
    this.
    """
    if docs.dtype != queries.dtype and jnp.issubdtype(docs.dtype, jnp.floating):
        queries = queries.astype(docs.dtype)
    return jax.lax.dot_general(
        queries,
        docs,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=f32_dot_precision(docs.dtype),
    )


def mask_cols(scores: jax.Array, n_valid: jax.Array) -> jax.Array:
    """Replace columns >= ``n_valid`` (padding rows of the pack) with
    ``NEG_INF`` along the last axis — THE validity-mask idiom every
    scoring path shares (one definition so a masking-rule change, e.g.
    an iota dtype bump, lands everywhere at once)."""
    live = jax.lax.broadcasted_iota(jnp.int32, scores.shape, scores.ndim - 1)
    return jnp.where(live < n_valid, scores, NEG_INF)


def masked_topk(
    scores: jax.Array, k: int, n_valid: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Top-k over the last axis of ``scores`` with positions >= ``n_valid``
    masked out.  Returns ``(values f32, indices int32)``."""
    vals, idx = jax.lax.top_k(mask_cols(scores, n_valid), k)
    return vals, idx  # normalize: lax returns a list


@functools.partial(jax.jit, static_argnames=("k",))
def score_topk(
    docs: jax.Array,
    queries: jax.Array,
    n_valid: jax.Array,
    k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Fused scoring + exact top-k: ``[B, k]`` values and indices."""
    scores = scores_matmul(docs, queries)
    return masked_topk(scores, k, n_valid)


def verified_topk(
    scores: jax.Array, k: int
) -> Tuple[jax.Array, jax.Array]:
    """**Verified-exact** fast top-k over pre-masked ``[B, N]`` scores.

    Uses ``lax.approx_max_k`` to pull an over-provisioned candidate set,
    then *proves* exactness with one cheap counting pass (on backends
    without an approximate top-k, ``approx_max_k`` lowers to an exact
    one and the proof passes trivially):

      let v = the k-th largest candidate value.  If the number of elements
      STRICTLY greater than v matches between the candidate set and the
      full array, then no element above v was missed; the candidate top-k
      (all elements > v, padded to k with v-valued ties) has exactly the
      true top-k score multiset.  Ties at v itself are interchangeable, so
      the strict comparison keeps the proof robust on tie-heavy corpora
      (an ``>=`` version falls back almost always when scores repeat).

    If the check fails for any query in the batch (probability ~0 at 4x
    over-provisioning), fall back to full ``lax.top_k`` inside ``lax.cond``
    — so the result is always exact, and the fast path is just a fast path.
    """
    n = scores.shape[-1]
    c_width = min(n, max(4 * k, k + 128))
    if c_width >= n:  # tiny corpus: nothing to accelerate
        vals, idx = jax.lax.top_k(scores, k)
        return vals, idx

    # High recall target: at 0.95 the expected misses land above the k-th
    # candidate often enough that the proof fails (and the fallback runs)
    # for ~half of realistic queries, making the "fast" path pay for both
    # stages.  0.999 keeps PartialReduce cheap and the proof almost always
    # passing.
    cand_v, cand_i = jax.lax.approx_max_k(
        scores, c_width, recall_target=0.999, aggregate_to_topk=True
    )
    kth = cand_v[:, k - 1 : k]  # [B, 1] (sorted desc by aggregate_to_topk)
    in_cand = jnp.sum((cand_v > kth).astype(jnp.int32), axis=1)
    in_all = jnp.sum((scores > kth).astype(jnp.int32), axis=1)
    all_covered = jnp.all(in_cand == in_all)

    def from_candidates(_: None) -> Tuple[jax.Array, jax.Array]:
        vals, pos = jax.lax.top_k(cand_v, k)
        return vals, jnp.take_along_axis(cand_i, pos, axis=1)

    def full_fallback(_: None) -> Tuple[jax.Array, jax.Array]:
        vals, idx = jax.lax.top_k(scores, k)
        return vals, idx

    return jax.lax.cond(all_covered, from_candidates, full_fallback, None)


@functools.partial(jax.jit, static_argnames=("k",))
def score_topk_fast(
    docs: jax.Array,
    queries: jax.Array,
    n_valid: jax.Array,
    k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Fused scoring + :func:`verified_topk` selection."""
    scores = mask_cols(scores_matmul(docs, queries), n_valid)
    return verified_topk(scores, k)


def streaming_score_topk(
    docs: jax.Array,
    queries: jax.Array,
    n_valid: jax.Array,
    k: int,
    row_scales: "jax.Array | None" = None,
    max_block_rows: int = 1 << 21,
) -> Tuple[jax.Array, jax.Array]:
    """Exact masked scoring + top-k with O(B x block) score memory.

    Result contract of :func:`score_topk` (``row_scales=None``) or
    ``quant.score_topk_int8`` (int8 corpus + per-row scales), including
    the smaller-index-first tie rule, but the ``[B, N]`` f32 score matrix
    never materializes: a ``fori_loop`` scores one row block at a time
    and merges a running top-k carry (``concat([carry, block]) -> top_k``
    — carry first, so global tie order is preserved).  This is the exact
    path once a materializing one would exceed the device's scores
    budget (``utils.device_memory.scores_budget``).

    The block size is the largest divisor of ``n`` at most
    ``max_block_rows`` (packed corpora are block-multiple-sized, so a
    divisor near the target always exists) and never below ``k``.
    """
    n, d = docs.shape
    b = queries.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds the corpus row count {n}")
    target = max(1, -(-n // max_block_rows))
    steps = target  # prefer MORE steps (blocks under the memory target)
    while steps * max(k, 1) <= n and n % steps != 0:
        steps += 1
    if steps * max(k, 1) > n or n % steps != 0:
        steps = target  # no divisor small enough: take the next larger block
        while steps > 1 and n % steps != 0:
            steps -= 1
    block = n // steps

    if row_scales is None:
        q = queries
        if docs.dtype != q.dtype and jnp.issubdtype(docs.dtype, jnp.floating):
            q = q.astype(docs.dtype)
        prec = f32_dot_precision(docs.dtype)
        q_int8 = q_scales = None
    else:
        from .quant import quantize_rows_int8

        q_int8, q_scales = quantize_rows_int8(queries)
        prec = None

    def block_scores(start: jax.Array) -> jax.Array:
        blk = jax.lax.dynamic_slice(docs, (start, 0), (block, d))
        if row_scales is None:
            s = jax.lax.dot_general(
                q,
                blk,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=prec,
            )
        else:
            rs = jax.lax.dynamic_slice(row_scales, (start,), (block,))
            raw = jax.lax.dot_general(
                q_int8,
                blk,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            s = raw.astype(jnp.float32) * rs[None, :] * q_scales[:, None]
        live = jax.lax.broadcasted_iota(jnp.int32, (b, block), 1) + start
        return jnp.where(live < n_valid, s, NEG_INF)

    vals0, idx0 = jax.lax.top_k(block_scores(jnp.int32(0)), k)

    def body(
        i: jax.Array, carry: Tuple[jax.Array, jax.Array]
    ) -> Tuple[jax.Array, jax.Array]:
        cv, ci = carry
        start = i * block
        bv, bi = jax.lax.top_k(block_scores(start), k)
        mv = jnp.concatenate([cv, bv], axis=1)
        mi = jnp.concatenate([ci, bi + start], axis=1)
        v, p = jax.lax.top_k(mv, k)
        return v, jnp.take_along_axis(mi, p, axis=1)

    return jax.lax.fori_loop(1, steps, body, (vals0, idx0))


def exact_topk(
    docs: jax.Array,
    queries: jax.Array,
    n_valid: jax.Array,
    k: int,
    row_scales: "jax.Array | None" = None,
    budget: "int | None" = None,
) -> Tuple[jax.Array, jax.Array]:
    """THE plain XLA exact top-k over a pack (int8 corpora pass their
    ``row_scales``): it materializes the ``[B, N]`` f32 score matrix
    while that fits ``budget`` bytes, and streams row blocks
    (:func:`streaming_score_topk`) past it.  ``budget`` defaults to the
    default device's ``utils.device_memory.scores_budget``; the engine
    passes its own device's.  Returns ``(vals f32, rows int32)``."""
    if budget is None:
        from ..utils import device_memory

        budget = device_memory.scores_budget()
    if queries.shape[0] * docs.shape[0] * 4 > budget:
        return streaming_score_topk(
            docs, queries, n_valid, k, row_scales=row_scales
        )
    if row_scales is not None:
        from .quant import score_topk_int8

        return score_topk_int8(docs, row_scales, queries, n_valid, k)
    return score_topk(docs, queries, n_valid, k)


@functools.partial(jax.jit, static_argnames=("k", "wide", "budget"))
def exact_topk_packed(
    docs: jax.Array,
    queries: jax.Array,
    n_valid: jax.Array,
    k: int,
    row_scales: "jax.Array | None" = None,
    wide: bool = False,
    budget: "int | None" = None,
) -> jax.Array:
    """:func:`exact_topk` + result packing in one dispatch — the
    engine's XLA prescore path."""
    return pack_vals_idx(
        *exact_topk(docs, queries, n_valid, k, row_scales, budget), wide=wide
    )


def pack_vals_idx(vals: jax.Array, idx: jax.Array, wide: bool = False) -> jax.Array:
    """Scores ++ indices in ONE array so a single host fetch retrieves both.

    Default layout (f32): indices travel as exact f32 *values* — exact
    below 2^24 rows.  (Bitcasting f32 score bits into small ints instead
    would produce denormals, which some transports flush to zero.)

    ``wide`` layout (int32): score f32 bits are bitcast into an int32
    array and concatenated with raw int32 indices — exact for any corpus
    size, at the cost of the host-side bitcast back.  Integer wire dtypes
    carry arbitrary bit patterns safely (no denormal flushing).
    """
    if wide:
        return jnp.concatenate(
            [jax.lax.bitcast_convert_type(vals, jnp.int32), idx], axis=1
        )
    return jnp.concatenate([vals, idx.astype(jnp.float32)], axis=1)


def unpack_rows_tail(
    packed: jax.Array, c: int, wide: bool
) -> Tuple[jax.Array, jax.Array]:
    """In-graph decode of a ``pack_vals_idx`` wire's candidate rows and
    boundary (C-th, lowest) prescore: returns ``(rows int32 [B, C],
    tail_bits int32 [B, 1])``.  Shared by the single-chip and mesh
    device-rescore paths (``engine.index``, ``parallel.sharded``)."""
    if wide:
        rows = packed[:, c:]  # already int32
        tail_bits = packed[:, c - 1 : c]  # f32 bits as int32
    else:
        rows = packed[:, c:].astype(jnp.int32)
        tail_bits = jax.lax.bitcast_convert_type(
            packed[:, c - 1 : c], jnp.int32
        )
    return rows, tail_bits


def final_select_wire(
    exact: jax.Array, emb_of: jax.Array, tail_bits: jax.Array, k: int
) -> jax.Array:
    """Final top-k selection with the REFERENCE tie rule — descending
    exact score, equal scores break to the larger emb id
    (``svs/util.py:190-203``) — as ONE lexicographic ``lax.sort``, encoded
    as the compact int32 wire ``[B, 2k + 1]``: top-k emb ids ++ top-k
    exact score bits ++ boundary-prescore bits.  ``exact + 0.0``
    canonicalizes -0.0 so an exact-zero tie can't split on zero sign."""
    neg_score = jnp.negative(exact + 0.0)
    _, _, top_emb, top_exact = jax.lax.sort(
        (neg_score, jnp.negative(emb_of), emb_of, exact),
        dimension=1,
        num_keys=2,
        is_stable=False,
    )
    return jnp.concatenate(
        [
            top_emb[:, :k],
            jax.lax.bitcast_convert_type(top_exact[:, :k], jnp.int32),
            tail_bits,
        ],
        axis=1,
    )


def unpack_vals_idx(
    packed: "jnp.ndarray", k: int, wide: bool = False
) -> "Tuple[Any, Any]":
    """Host-side inverse of :func:`pack_vals_idx` on a fetched ndarray:
    returns ``(scores f32 [B, k], rows int64 [B, C-k])``."""
    import numpy as np

    packed = np.asarray(packed)
    if wide:
        vals = np.ascontiguousarray(packed[:, :k]).view(np.float32)
        rows = packed[:, k:].astype(np.int64)
    else:
        vals = packed[:, :k].astype(np.float32, copy=False)
        rows = packed[:, k:].astype(np.int64)
    return vals, rows


@functools.partial(jax.jit, static_argnames=("k", "wide"))
def score_topk_packed(
    docs: jax.Array,
    queries: jax.Array,
    n_valid: jax.Array,
    k: int,
    wide: bool = False,
) -> jax.Array:
    """:func:`score_topk` + result packing in ONE device dispatch and
    one host fetch — the engine's XLA prescore path."""
    return pack_vals_idx(*score_topk(docs, queries, n_valid, k), wide=wide)


#: Per-tile width of the hierarchical selection.  256 divides every packed
#: corpus height by construction (``engine.packing.ROW_MULTIPLE``).
SELECT_TILE = 256


def tiled_topk(
    scores: jax.Array, k: int, m: int = 16, tile: int = SELECT_TILE
) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k over large score rows via per-tile partial selection.

    Splits each row into tiles, takes a per-tile top-``m`` (small sorts),
    and merges the ``T*m`` survivors with one small ``lax.top_k`` — an
    alternative to one ``lax.top_k`` over the whole ``[B, N]`` row.

    Exactness is *verified in-graph*: a tile can only hide a true top-k
    element beyond its kept ``m`` if its m-th (smallest kept) value beats
    the merged k-th value.  When any tile trips that check (probability ~0
    for k << T*m unless scores are adversarially clustered), fall back to
    the full ``lax.top_k`` inside ``lax.cond`` — so the result is always
    the exact top-k multiset, and the tiled path is purely a fast path.
    (Ties at the k-th value may swap with equal-valued hidden elements;
    the score multiset — the exactness contract, same as the reference's
    argpartition — is unaffected.)
    """
    b, n = scores.shape
    m_eff = min(m, tile)  # the candidate pool is built from m_eff, so
    # the bypass guard must use it too (m > tile with k > T*tile would
    # otherwise pass the guard and crash the merge top_k)
    if n % tile != 0 or n // tile < 2 or k > (n // tile) * m_eff:
        _v, _i = jax.lax.top_k(scores, k)
        return _v, _i
    t = n // tile
    tiles = scores.reshape(b, t, tile)
    tv, ti = jax.lax.top_k(tiles, m_eff)  # [B, T, m]
    base = (jnp.arange(t, dtype=jnp.int32) * tile)[None, :, None]
    cand_v = tv.reshape(b, t * m_eff)
    cand_i = (ti + base).reshape(b, t * m_eff)
    vals, pos = jax.lax.top_k(cand_v, k)
    idx = jnp.take_along_axis(cand_i, pos, axis=1)
    if m_eff == tile:  # nothing hidden: per-tile selection was total
        return vals, idx
    v_k = vals[:, k - 1 : k]  # [B, 1]
    covered = jnp.logical_not(jnp.any(tv[:, :, m_eff - 1] > v_k))

    def fast(_: None) -> Tuple[jax.Array, jax.Array]:
        return vals, idx

    def full(_: None) -> Tuple[jax.Array, jax.Array]:
        fv, fi = jax.lax.top_k(scores, k)
        return fv, fi

    return jax.lax.cond(covered, fast, full, None)


@functools.partial(jax.jit, static_argnames=("k", "m", "score_dtype", "wide"))
def score_topk_tiled_packed(
    docs: jax.Array,
    queries: jax.Array,
    n_valid: jax.Array,
    k: int,
    m: int = 16,
    score_dtype: str = "f32",
    wide: bool = False,
) -> jax.Array:
    """Fused scoring + :func:`tiled_topk` selection + result packing.

    ``score_dtype='bf16'`` stores the score matrix in bf16 before selection
    — halves the selection stage's memory traffic; the added ~2^-9 relative
    rounding is covered by the engine's prescore error bound (rescore
    stays verified-exact).
    """
    scores = mask_cols(scores_matmul(docs, queries), n_valid)
    if score_dtype == "bf16":
        scores = scores.astype(jnp.bfloat16)
    vals, idx = tiled_topk(scores, k, m=m)
    return pack_vals_idx(vals.astype(jnp.float32), idx, wide=wide)


def coarse_topk(
    scores: jax.Array,
    k: int,
    tiles_kept: int = 0,
    m: int = 8,
    tile: int = SELECT_TILE,
) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k via tile-max screening + block gather + narrow selection.

    Three cheap stages instead of one expensive ``lax.top_k`` over [B, N]:

    1. per-tile max ([B, T], a pure bandwidth-bound reduce);
    2. keep the ``tiles_kept`` highest-max tiles (small ``top_k``), gather
       their score blocks ([B, kt, tile] — contiguous-slice gather);
    3. per-kept-tile top-``m`` + merge (selection now runs over ~kt*tile
       elements instead of N).

    In-graph exactness verification (fallback to full ``lax.top_k``):

    - screening: every tile that could hold an element above the merged
      k-th value must have been kept — count tile-maxes above v_k in the
      kept set vs all tiles;
    - within kept tiles: same hidden-beyond-m check as :func:`tiled_topk`.
    """
    b, n = scores.shape
    if n % tile != 0:
        _v, _i = jax.lax.top_k(scores, k)
        return _v, _i
    t = n // tile
    kt = min(t, max(tiles_kept, k))
    m_eff = min(m, tile)
    if kt * m_eff < k or kt == t:
        return tiled_topk(scores, k, m=m, tile=tile)
    t3 = scores.reshape(b, t, tile)
    tmax = jnp.max(t3, axis=-1)  # [B, T]
    tv, ti = jax.lax.top_k(tmax, kt)  # [B, kt]
    g = jnp.take_along_axis(t3, ti[:, :, None], axis=1)  # [B, kt, tile]
    sv, si = jax.lax.top_k(g, m_eff)  # [B, kt, m]
    gidx = ti[:, :, None] * tile + si
    cand_v = sv.reshape(b, kt * m_eff)
    cand_i = gidx.reshape(b, kt * m_eff)
    vals, pos = jax.lax.top_k(cand_v, k)
    idx = jnp.take_along_axis(cand_i, pos, axis=1)
    v_k = vals[:, k - 1 : k]
    in_kept = jnp.sum((tv > v_k).astype(jnp.int32), axis=1)
    in_all = jnp.sum((tmax > v_k).astype(jnp.int32), axis=1)
    screened_ok = jnp.all(in_kept == in_all)
    hidden_ok = jnp.logical_not(jnp.any(sv[:, :, m_eff - 1] > v_k))
    covered = jnp.logical_and(screened_ok, hidden_ok)

    def fast(_: None) -> Tuple[jax.Array, jax.Array]:
        return vals, idx

    def full(_: None) -> Tuple[jax.Array, jax.Array]:
        fv, fi = jax.lax.top_k(scores, k)
        return fv, fi

    return jax.lax.cond(covered, fast, full, None)


def merge_topk(
    values: jax.Array, indices: jax.Array, k: int
) -> Tuple[jax.Array, jax.Array]:
    """Merge candidate sets along the last axis into one exact top-k.

    ``values``/``indices`` are ``[..., C]`` with C >= k (e.g. concatenated
    per-shard or per-block winners).  Exactness: any global top-k element is
    present in the union of per-source top-k sets, so re-selecting over the
    union is exact.
    """
    top_vals, top_pos = jax.lax.top_k(values, k)
    top_idx = jnp.take_along_axis(indices, top_pos, axis=-1)
    return top_vals, top_idx
