"""Corpus-sharded exact retrieval over a device mesh.

Design (net-new vs the reference; see SURVEY.md sections 2.3/5):

- the packed corpus is sharded row-wise along the ``data`` mesh axis (and
  optionally column-wise along a ``model`` axis for very wide embeddings);
- under ``shard_map``, every device scores **only its shard** (one local
  matmul, full local memory bandwidth), masks padding by *global* row index,
  and selects a local top-k;
- only ``k`` candidates per chip leave the chip; the exact global top-k is
  a merge over those ``D * k`` candidates.  Exactness: each global top-k hit
  lives in some shard and is therefore in that shard's local top-k;
- with a ``model`` axis, partial dot products are reduced with one
  ``psum`` before selection.

Per-shard winners are returned from ``shard_map`` stacked along the data
axis and merged in plain jit-land, so the result needs no replication
bookkeeping inside the mapped function.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops.quant import quantize_rows_int8
from ..ops.topk import NEG_INF, merge_topk, scores_matmul


def sharded_score_topk(
    docs: jax.Array,
    row_scales: Optional[jax.Array],
    queries: jax.Array,
    n_valid: jax.Array,
    k: int,
    *,
    mesh: jax.sharding.Mesh,
    data_axis: str = "data",
    model_axis: Optional[str] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Exact top-``k`` over a mesh-sharded corpus.

    ``docs``: ``[N, d]`` sharded ``P(data_axis, model_axis)``;
    ``row_scales``: ``[N]`` f32 for int8 corpora (data-axis sharded) or
    ``None``; ``queries``: ``[B, d]``.  Returns replicated
    ``(values f32 [B, k], global row indices int32 [B, k])``.
    """
    if row_scales is not None and model_axis is not None:
        raise NotImplementedError(
            "int8 corpora shard over the data axis only (per-query scales "
            "must see the full query vector)"
        )
    fn = _build_sharded_topk(
        mesh, data_axis, model_axis, int(k), row_scales is not None
    )
    if row_scales is not None:
        return fn(docs, row_scales, queries, n_valid)
    return fn(docs, queries, n_valid)


@functools.lru_cache(maxsize=None)
def _build_sharded_topk(
    mesh: jax.sharding.Mesh,
    data_axis: str,
    model_axis: Optional[str],
    k: int,
    has_scales: bool,
) -> "Any":
    def local_topk(
        docs: jax.Array,
        scales: Optional[jax.Array],
        q: jax.Array,
        n_valid: jax.Array,
    ) -> Tuple[jax.Array, ...]:
        n_local = docs.shape[0]
        k_local = min(k, n_local)
        offset = jax.lax.axis_index(data_axis).astype(jnp.int32) * n_local

        if model_axis is None:
            from ..ops.topk import streaming_score_topk
            from ..utils import device_memory

            if q.shape[0] * n_local * 4 > device_memory.scores_budget():
                # The materializing path below allocates a [B, N/D] f32
                # score matrix PER SHARD; past the budget, stream row
                # blocks instead (exact, same tie rule, O(B x block)).
                nv_local = jnp.clip(
                    n_valid.astype(jnp.int32) - offset, 0, n_local
                )
                vals, idx = streaming_score_topk(
                    docs, q, nv_local, k_local,
                    row_scales=scales if has_scales else None,
                )
                return vals[None], (idx + offset)[None]

        if has_scales:
            q_int8, q_scales = quantize_rows_int8(q)
            raw = jax.lax.dot_general(
                q_int8,
                docs,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            scores = raw.astype(jnp.float32) * scales[None, :] * q_scales[:, None]
        else:
            scores = scores_matmul(docs, q)
            if model_axis is not None:
                scores = jax.lax.psum(scores, model_axis)
        global_col = offset + jax.lax.broadcasted_iota(
            jnp.int32, scores.shape, scores.ndim - 1
        )
        masked = jnp.where(global_col < n_valid, scores, NEG_INF)
        vals, idx = jax.lax.top_k(masked, k_local)
        gidx = idx.astype(jnp.int32) + offset
        # Stack per-shard winners along a leading data-axis dim.
        return vals[None], gidx[None]

    if has_scales:
        in_specs = (P(data_axis, model_axis), P(data_axis), P(None, model_axis), P())
        def mapped(
            docs: jax.Array, scales: jax.Array, q: jax.Array, n_valid: jax.Array
        ) -> Tuple[jax.Array, ...]:
            return local_topk(docs, scales, q, n_valid)
    else:
        in_specs = (P(data_axis, model_axis), P(None, model_axis), P())
        def mapped(
            docs: jax.Array, q: jax.Array, n_valid: jax.Array
        ) -> Tuple[jax.Array, ...]:
            return local_topk(docs, None, q, n_valid)

    shard_fn = jax.shard_map(
        mapped,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(data_axis, None, None), P(data_axis, None, None)),
        check_vma=False,
    )

    def merged(*args: jax.Array) -> Tuple[jax.Array, jax.Array]:
        vals, gidx = shard_fn(*args)  # [D, B, k_local]
        b = vals.shape[1]
        vals = jnp.moveaxis(vals, 0, 1).reshape(b, -1)
        gidx = jnp.moveaxis(gidx, 0, 1).reshape(b, -1)
        return merge_topk(vals, gidx, k)

    return jax.jit(merged)


def sharded_rescore_final(
    packed: jax.Array,
    mirror: jax.Array,
    dev_emb: jax.Array,
    queries: jax.Array,
    k: int,
    *,
    wide: bool,
    mesh: jax.sharding.Mesh,
    data_axis: str = "data",
    dim: Optional[int] = None,
) -> jax.Array:
    """Mesh analog of the engine's on-device rescore + final selection
    (``engine.index._final_from_packed``): the exact f32 rescore of the
    merged candidates runs WHERE THE ROWS LIVE — each shard gathers the
    candidate rows in its global range from its slice of the f32 mirror,
    computes partial exact dots, and one ``psum`` produces the
    replicated exact scores; the final top-k selection (reference tie
    rule) then runs replicated, and the caller fetches one compact
    ``[B, 2k+1]`` int32 wire.  Only candidate metadata crosses devices —
    never embedding vectors.

    ``packed``: replicated prescore wire from :func:`sharded_score_topk`
    via ``pack_vals_idx`` (scores ++ GLOBAL row indices);
    ``mirror``: ``[N_padded, dim]`` f32 in pack-row order, sharded
    ``P(data_axis)``; ``dev_emb``: ``[N_padded]`` int32 emb ids in
    pack-row order, replicated; ``queries``: ``[B, dim_padded]`` f32
    replicated.
    """
    fn = _build_sharded_rescore_final(
        mesh, data_axis, int(k), bool(wide),
        None if dim is None else int(dim),
    )
    return fn(packed, mirror, dev_emb, queries)


@functools.lru_cache(maxsize=None)
def _build_sharded_rescore_final(
    mesh: jax.sharding.Mesh,
    data_axis: str,
    k: int,
    wide: bool,
    dim: Optional[int],
) -> "Any":
    def local_partial(
        mirror: jax.Array, rows: jax.Array, q: jax.Array
    ) -> jax.Array:
        n_local = mirror.shape[0]
        offset = jax.lax.axis_index(data_axis).astype(jnp.int32) * n_local
        lr = rows - offset
        valid = (lr >= 0) & (lr < n_local)
        cand = mirror[jnp.clip(lr, 0, n_local - 1)]  # [B, C, d] local HBM
        # HIGHEST: exact-f32 rescore partials (the margin proof's ground
        # truth); the default runs f32 in TF32 (ops.topk.f32_dot_precision).
        partial = jax.lax.dot_general(
            cand,
            q,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        partial = jnp.where(valid, partial, 0.0)
        return jax.lax.psum(partial, data_axis)

    shard_fn = jax.shard_map(
        local_partial,
        mesh=mesh,
        in_specs=(P(data_axis, None), P(None, None), P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )

    def final(
        packed: jax.Array,
        mirror: jax.Array,
        dev_emb: jax.Array,
        queries: jax.Array,
    ) -> jax.Array:
        from ..ops.topk import final_select_wire, unpack_rows_tail

        if dim is not None and dim != queries.shape[1]:
            queries = queries[:, :dim]
        rows, tail_bits = unpack_rows_tail(packed, packed.shape[1] // 2, wide)
        exact = shard_fn(mirror, rows, queries)  # [B, C] replicated
        emb_of = dev_emb[rows]  # [B, C] int32
        return final_select_wire(exact, emb_of, tail_bits, k)

    return jax.jit(final)


def sharded_subset_topk(
    mirror: jax.Array,
    dev_emb: jax.Array,
    rows: jax.Array,
    n_live: jax.Array,
    queries: jax.Array,
    k: int,
    *,
    mesh: jax.sharding.Mesh,
    data_axis: str = "data",
    dim: Optional[int] = None,
) -> jax.Array:
    """Mesh analog of the engine's pre-filter fast path
    (``engine.index._subset_final``): exact top-``k`` over an EXPLICIT
    pack-row subset, computed where the rows live.  Each shard gathers
    the subset rows in its global range from its slice of the f32
    mirror and computes partial exact dots (``HIGHEST``); one ``psum``
    replicates the full ``[B, F]`` exact score matrix; the
    final tie-rule selection runs replicated and the caller fetches one
    compact ``[B, 2k+1]`` wire.  Only the tiny row-index vector and the
    ``[B, F]`` partials cross devices — never embedding vectors.

    ``mirror``: ``[N_padded, dim]`` f32 in pack-row order, sharded
    ``P(data_axis)``; ``dev_emb``: ``[N_padded]`` int32 emb ids in
    pack-row order, replicated; ``rows``: ``[F_pad]`` int32 pack rows
    (padding repeats row 0 — masked via ``n_live``), replicated;
    ``queries``: ``[B, dim_padded]`` f32 replicated."""
    fn = _build_sharded_subset(
        mesh, data_axis, int(k), None if dim is None else int(dim)
    )
    return fn(mirror, dev_emb, rows, n_live, queries)


@functools.lru_cache(maxsize=None)
def _build_sharded_subset(
    mesh: jax.sharding.Mesh,
    data_axis: str,
    k: int,
    dim: Optional[int],
) -> "Any":
    def local_partial(
        mirror: jax.Array, rows: jax.Array, q: jax.Array
    ) -> jax.Array:
        n_local = mirror.shape[0]
        offset = jax.lax.axis_index(data_axis).astype(jnp.int32) * n_local
        lr = rows - offset  # [F]
        valid = (lr >= 0) & (lr < n_local)
        cand = mirror[jnp.clip(lr, 0, n_local - 1)]  # [F, d] local HBM
        # HIGHEST: these ARE the returned scores (same contract as the
        # single-chip _subset_final).
        partial = jax.lax.dot_general(
            q,
            cand,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # [B, F]
        partial = jnp.where(valid[None, :], partial, 0.0)
        return jax.lax.psum(partial, data_axis)

    shard_fn = jax.shard_map(
        local_partial,
        mesh=mesh,
        in_specs=(P(data_axis, None), P(None), P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )

    def final(
        mirror: jax.Array,
        dev_emb: jax.Array,
        rows: jax.Array,
        n_live: jax.Array,
        queries: jax.Array,
    ) -> jax.Array:
        from ..ops.topk import final_select_wire

        if dim is not None and dim != queries.shape[1]:
            queries = queries[:, :dim]
        exact = shard_fn(mirror, rows, queries)  # [B, F] replicated
        live = (
            jnp.arange(rows.shape[0], dtype=jnp.int32)[None, :] < n_live
        )
        exact = jnp.where(live, exact, -jnp.inf)
        emb_of = dev_emb[rows]  # [F] int32 (padding masked via -inf)
        emb_b = jnp.broadcast_to(emb_of[None, :], exact.shape)
        tail = jnp.zeros((exact.shape[0], 1), dtype=jnp.int32)
        return final_select_wire(exact, emb_b, tail, k)

    return jax.jit(final)
