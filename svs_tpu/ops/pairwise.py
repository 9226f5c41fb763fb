"""Blocked all-pairs similarity: exact top-k pairs without the O(n^2) matrix.

The reference materializes ``docs @ docs.T`` in RAM and flattens its upper
triangle (``svs/kb.py:1219``, ``svs/util.py:206-233``) — a known scaling
cliff.  Here the computation streams over row blocks under one ``jit``:

  for each block of R rows:
      S = block @ docs.T                      # [R, N] lives only this step
      mask to the strict upper triangle (col > row) and valid docs
      per-row top-m                            # m << k: a row RARELY holds
                                               # many of the global top-k
      merge with the running global top-k carry

Peak memory is O(R*N) instead of O(N^2), and each step is one large matmul.

Exactness with ``m < k`` is *verified*, in the same style as the
retrieval kernels: the scan carries the maximum per-row m-th value
("tail"), and a row can only hide a true top-k pair if its tail reaches
the merged k-th value.  When that check fails the host escalates m
(64 -> 1024 -> k); the final stage is exact by construction.  The naive
per-row top-k costs dominate at scale (lax.top_k at k=10000 over
[256, 100k] per block measured ~18 s total at 100k docs; m=64 cuts the
selection ~100x).
"""

from __future__ import annotations

import functools
from typing import Any, List, Tuple

import jax
import jax.numpy as jnp

from .topk import NEG_INF, scores_matmul

#: Per-row selection widths tried in order; the last stage uses m = k and
#: is exact by construction.  64 covers any plausible non-adversarial
#: distribution (global top-k spread over >= n/2 rows).
_ESCALATION = (64, 1024)


def escalation_widths(k: int, n_rows_total: int, width_cap: int) -> "List[int]":
    """The per-row widths to attempt: escalation stages capped at
    ``width_cap`` (the per-row maximum), skipping widths whose total
    selected lanes (``n_rows_total * m``) could not even hold ``k``
    winners (the final merge would be ill-posed), ending at the
    exact-by-construction ``min(k, width_cap)``."""
    last = min(k, width_cap)
    widths = [
        m
        for m in _ESCALATION
        if m < last and n_rows_total * m >= k
    ]
    widths.append(last)
    return widths


@functools.partial(jax.jit, static_argnames=("k", "per_row_k", "block_rows"))
def _pairwise_attempt(
    docs: jax.Array,
    n_valid: jax.Array,
    k: int,
    per_row_k: int,
    block_rows: int,
    row_scales: "jax.Array | None" = None,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """One blocked pass with per-row top-``per_row_k`` selection.  Returns
    ``(vals, rows, cols, covered)``; ``covered`` is False when some row's
    per-row tail reached the merged k-th value (possible hidden pairs)."""
    n_padded, _ = docs.shape
    assert n_padded % block_rows == 0, "pad the corpus to a block multiple"
    n_blocks = n_padded // block_rows

    # Collect-then-merge vs merge-per-step: a running global top-k carry
    # pays a k-sized lax.top_k every block (measured ~16 s of a 16 s pass
    # at 100k docs, k=10k), so when the collected winners fit a sane
    # buffer, the scan just emits them and ONE final top_k merges.  The
    # carry variant remains for sizes where the collect buffer would be
    # GBs (1M docs at the escalated widths).
    collect = n_blocks * block_rows * per_row_k <= (1 << 27)

    col_ids = jax.lax.broadcasted_iota(jnp.int32, (block_rows, n_padded), 1)

    def step(
        carry: Tuple[jax.Array, jax.Array, jax.Array, jax.Array],
        block_idx: jax.Array,
    ) -> Tuple[
        Tuple[jax.Array, jax.Array, jax.Array, jax.Array], Any
    ]:
        c_vals, c_rows, c_cols, c_tail = carry
        row0 = block_idx * block_rows
        block = jax.lax.dynamic_slice(docs, (row0, 0), (block_rows, docs.shape[1]))
        if row_scales is not None:
            raw = jax.lax.dot_general(
                block,
                docs,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )  # [block_rows, n_padded] int32
            s_blk = jax.lax.dynamic_slice(row_scales, (row0,), (block_rows,))
            scores = raw.astype(jnp.float32) * s_blk[:, None] * row_scales[None, :]
        else:
            scores = scores_matmul(docs, block)  # [block_rows, n_padded]
        row_ids = row0 + jax.lax.broadcasted_iota(
            jnp.int32, (block_rows, n_padded), 0
        )
        live = (col_ids > row_ids) & (col_ids < n_valid) & (row_ids < n_valid)
        scores = jnp.where(live, scores, NEG_INF)

        blk_vals, blk_cols = jax.lax.top_k(scores, per_row_k)
        blk_rows = jnp.broadcast_to(row_ids[:, :1], blk_cols.shape)
        # the m-th (smallest selected) value per row bounds anything hidden
        c_tail = jnp.maximum(c_tail, jnp.max(blk_vals[:, -1]))
        blk_cols = blk_cols.astype(jnp.int32)

        if collect:
            return (c_vals, c_rows, c_cols, c_tail), (
                blk_vals.reshape(-1),
                blk_rows.reshape(-1),
                blk_cols.reshape(-1),
            )
        all_vals = jnp.concatenate([c_vals, blk_vals.reshape(-1)])
        all_rows = jnp.concatenate([c_rows, blk_rows.reshape(-1)])
        all_cols = jnp.concatenate([c_cols, blk_cols.reshape(-1)])
        top_vals, top_pos = jax.lax.top_k(all_vals, k)
        return (
            top_vals,
            jnp.take(all_rows, top_pos),
            jnp.take(all_cols, top_pos),
            c_tail,
        ), None

    init = (
        jnp.full((k,), NEG_INF, dtype=jnp.float32),
        jnp.zeros((k,), dtype=jnp.int32),
        jnp.zeros((k,), dtype=jnp.int32),
        jnp.float32(NEG_INF),
    )
    (vals, rows, cols, tail_max), collected = jax.lax.scan(
        step, init, jnp.arange(n_blocks, dtype=jnp.int32)
    )
    if collect:
        all_vals, all_rows, all_cols = (a.reshape(-1) for a in collected)
        vals, pos = jax.lax.top_k(all_vals, k)
        rows = jnp.take(all_rows, pos)
        cols = jnp.take(all_cols, pos)
    exact_by_construction = per_row_k >= min(k, n_padded)
    covered = jnp.logical_or(
        jnp.array(exact_by_construction), tail_max < vals[k - 1]
    )
    return vals, rows, cols, covered


def pairwise_topk_blocked(
    docs: jax.Array,
    n_valid: jax.Array,
    k: int,
    block_rows: int = 256,
    row_scales: "jax.Array | None" = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Exact top-``k`` upper-triangle pairs of the row-wise similarity matrix.

    ``docs`` is ``[N, d]`` with N a multiple of ``block_rows`` (pad rows are
    ignored via ``n_valid``).  Returns ``(scores f32 [k], rows int32 [k],
    cols int32 [k])`` sorted by score descending.  The caller must clamp
    ``k`` to the number of real pairs, ``n_valid * (n_valid - 1) / 2``.

    With ``row_scales`` (int8 corpora), each block runs an int8 x int8
    matmul with int32 accumulation and rescales to f32 on the fly — no
    dequantized copy of the corpus ever materializes (the extra HBM is
    O(block x N) scores, same as the float path).
    """
    n_padded = docs.shape[0]
    widths = escalation_widths(k, n_padded, n_padded)
    for m in widths:
        vals, rows, cols, covered = _pairwise_attempt(
            docs, n_valid, k, m, block_rows, row_scales
        )
        if bool(covered):
            return vals, rows, cols
    return vals, rows, cols  # last stage was exact by construction
