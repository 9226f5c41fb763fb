"""Mesh-sharded all-pairs similarity: a ppermute ring over corpus blocks.

Single-device pairwise (ops/pairwise.py) streams row blocks against the
whole corpus.  Across a mesh, the corpus is already row-sharded; instead of
gathering it anywhere, the shards themselves rotate around the ring:

  ring step s (of D): every chip holds the shard that originated on chip
  (me + s) mod D.  The chip streams its RESIDENT rows in row-blocks
  against that visiting shard -> [R, N/D] matmuls (never an
  O((N/D)^2) score matrix), masks to the strict-upper global triangle,
  keeps a verified per-row top-m, and folds the winners into a running
  carry.  Then the visiting shard ppermutes one hop.

After D ring steps every global pair has been scored exactly once, each
chip holds its rows' top-k pairs, and one candidate merge (k per chip
across devices) yields the exact global top-k.  Peak memory per chip is
O(R * N/D) scores; traffic per chip is one corpus's worth over the ring.

Per-row selection uses the same verified width escalation as the
single-chip pass (ops/pairwise.py): start at m=64, escalate when any
row's m-th value reaches the merged k-th (the hidden-pair bound); the
final stage is exact by construction.
"""

from __future__ import annotations

import functools
from typing import Any, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops.pairwise import escalation_widths
from ..ops.topk import NEG_INF, scores_matmul


def sharded_pairwise_topk(
    docs: jax.Array,
    n_valid: jax.Array,
    k: int,
    *,
    mesh: jax.sharding.Mesh,
    data_axis: str = "data",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Exact top-``k`` upper-triangle pairs over a row-sharded corpus.

    ``docs``: ``[N, d]`` sharded ``P(data_axis, None)``.  Returns
    ``(scores f32 [k], rows int32 [k], cols int32 [k])``, sorted descending.
    Caller clamps ``k`` to the true pair count.
    """
    n_shards = int(mesh.shape[data_axis])
    n_local = docs.shape[0] // n_shards
    widths = escalation_widths(k, docs.shape[0], n_local)
    for m in widths:
        fn = _build(mesh, data_axis, int(k), int(m))
        vals, rows, cols, covered = fn(docs, n_valid)
        if bool(covered):
            return vals, rows, cols
    return vals, rows, cols  # last stage exact by construction


# Bounded: k varies with the caller's n and the x4 widen ladder, and each
# entry pins a jitted executable (plus the Mesh) — unbounded growth in a
# long-lived server.  32 covers every ladder width of several active n's;
# eviction only costs a recompile on the next use.
@functools.lru_cache(maxsize=32)
def _build(
    mesh: jax.sharding.Mesh,
    data_axis: str,
    k: int,
    per_row_k: int,
) -> "Any":
    n_shards = int(mesh.shape[data_axis])
    ring = [(j, (j - 1) % n_shards) for j in range(n_shards)]

    def local_pairs(
        docs_local: jax.Array, n_valid: jax.Array
    ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
        n_local = docs_local.shape[0]
        # largest power-of-two row-block <= 256 dividing the shard (any
        # shard size works; engine-packed corpora always divide by 256)
        rb = next(c for c in (256, 128, 64, 32, 16, 8, 4, 2, 1) if n_local % c == 0)
        n_rblocks = n_local // rb
        m_eff = min(per_row_k, n_local)
        me = jax.lax.axis_index(data_axis).astype(jnp.int32)
        row_base = me * n_local

        carry_v = jnp.full((k,), NEG_INF, jnp.float32)
        carry_r = jnp.zeros((k,), jnp.int32)
        carry_c = jnp.zeros((k,), jnp.int32)
        tail_max = jnp.float32(NEG_INF)
        block = docs_local  # the visiting shard (starts as our own)

        for ring_step in range(n_shards):
            src = (me + ring_step) % n_shards
            col_base = src * n_local

            def inner(
                carry: jax.Array,
                i: jax.Array,
                block: jax.Array = block,
                col_base: int = col_base,
            ) -> jax.Array:
                c_tail = carry
                rows_blk = jax.lax.dynamic_slice(
                    docs_local, (i * rb, 0), (rb, docs_local.shape[1])
                )
                scores = scores_matmul(block, rows_blk)  # [rb, n_local]
                rows_g = (
                    row_base
                    + i * rb
                    + jax.lax.broadcasted_iota(jnp.int32, (rb, n_local), 0)
                )
                cols_g = col_base + jax.lax.broadcasted_iota(
                    jnp.int32, (rb, n_local), 1
                )
                live = (
                    (cols_g > rows_g) & (cols_g < n_valid) & (rows_g < n_valid)
                )
                scores = jnp.where(live, scores, NEG_INF)
                blk_v, blk_c = jax.lax.top_k(scores, m_eff)
                c_tail = jnp.maximum(c_tail, jnp.max(blk_v[:, -1]))
                blk_cg = col_base + blk_c.astype(jnp.int32)
                blk_r = jnp.broadcast_to(rows_g[:, :1], blk_cg.shape)
                return c_tail, (
                    blk_v.reshape(-1),
                    blk_r.reshape(-1),
                    blk_cg.reshape(-1),
                )

            tail_max, (ys_v, ys_r, ys_c) = jax.lax.scan(
                inner, tail_max, jnp.arange(n_rblocks, dtype=jnp.int32)
            )
            all_v = jnp.concatenate([carry_v, ys_v.reshape(-1)])
            all_r = jnp.concatenate([carry_r, ys_r.reshape(-1)])
            all_c = jnp.concatenate([carry_c, ys_c.reshape(-1)])
            carry_v, pos = jax.lax.top_k(all_v, k)
            carry_r = jnp.take(all_r, pos)
            carry_c = jnp.take(all_c, pos)

            if ring_step + 1 < n_shards:
                block = jax.lax.ppermute(block, data_axis, ring)

        # Stack per-shard winners along the data axis for the outer merge.
        return carry_v[None], carry_r[None], carry_c[None], tail_max[None]

    shard_fn = jax.shard_map(
        local_pairs,
        mesh=mesh,
        in_specs=(P(data_axis, None), P()),
        out_specs=(P(data_axis), P(data_axis), P(data_axis), P(data_axis)),
        check_vma=False,
    )

    def merged(
        docs: jax.Array, n_valid: jax.Array
    ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
        vals, rows, cols, tails = shard_fn(docs, n_valid)  # [D, k] + [D]
        flat_v = vals.reshape(1, -1)
        top_v, pos = jax.lax.top_k(flat_v, k)
        n_local = docs.shape[0] // n_shards
        exact = per_row_k >= min(k, n_local)
        covered = jnp.logical_or(
            jnp.array(exact), jnp.max(tails) < top_v[0, k - 1]
        )
        return (
            top_v[0],
            jnp.take(rows.reshape(-1), pos[0]),
            jnp.take(cols.reshape(-1), pos[0]),
            covered,
        )

    return jax.jit(merged)
