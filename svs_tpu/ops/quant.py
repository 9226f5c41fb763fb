"""Int8-quantized scoring: 2x the corpus per chip over bf16, 4x over f32.

Storage is symmetric per-row int8 (``q = round(row * 127 / max|row|)``); the
query is quantized per-query the same way, the dot runs int8 x int8 with
int32 accumulation, and scores are rescaled to f32.  Quantized
scores are a *prescore*: exact final ordering comes from the engine's f32
rescore of the candidate set (see ``RetrievalEngine``), so recall stays 1.0
while the device-memory read per query halves.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from .topk import masked_topk

_EPS = 1e-30


def quantize_rows_int8(matrix: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Per-row symmetric int8 quantization.

    Returns ``(q int8 [N, d], scales f32 [N])`` with
    ``matrix ~= q * scales[:, None]``.
    """
    matrix = matrix.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(matrix), axis=1)
    scales = jnp.maximum(absmax, _EPS) / 127.0
    q = jnp.clip(jnp.round(matrix / scales[:, None]), -127, 127).astype(jnp.int8)
    return q, scales


def _int8_scores(
    q_docs: jax.Array, row_scales: jax.Array, queries: jax.Array
) -> jax.Array:
    q_queries, query_scales = quantize_rows_int8(queries)
    raw = jax.lax.dot_general(
        q_queries,
        q_docs,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # [B, N] int32
    return (
        raw.astype(jnp.float32)
        * row_scales[None, :]
        * query_scales[:, None]
    )


@functools.partial(jax.jit, static_argnames=("k",))
def score_topk_int8(
    q_docs: jax.Array,
    row_scales: jax.Array,
    queries: jax.Array,
    n_valid: jax.Array,
    k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Quantized scoring + top-k: ``[B, k]`` f32 values and int32 indices."""
    return masked_topk(_int8_scores(q_docs, row_scales, queries), k, n_valid)


@functools.partial(jax.jit, static_argnames=("k", "wide"))
def score_topk_int8_packed(
    q_docs: jax.Array,
    row_scales: jax.Array,
    queries: jax.Array,
    n_valid: jax.Array,
    k: int,
    wide: bool = False,
) -> jax.Array:
    """:func:`score_topk_int8` + result packing in one device dispatch."""
    from .topk import pack_vals_idx

    return pack_vals_idx(
        *score_topk_int8(q_docs, row_scales, queries, n_valid, k), wide=wide
    )


@functools.partial(jax.jit, static_argnames=("k",))
def score_topk_int8_fast(
    q_docs: jax.Array,
    row_scales: jax.Array,
    queries: jax.Array,
    n_valid: jax.Array,
    k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Quantized scoring + the verified-exact approx_max_k selection (see
    ``ops.topk.score_topk_fast`` for the counting-proof argument)."""
    from .topk import mask_cols, verified_topk

    scores = mask_cols(_int8_scores(q_docs, row_scales, queries), n_valid)
    return verified_topk(scores, k)
