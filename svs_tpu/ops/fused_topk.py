"""Fused scoring + per-tile selection: the GPU retrieval kernel.

The plain XLA path (:func:`svs_tpu.ops.topk.score_topk_packed`) writes
the ``[B, N]`` f32 score matrix to device memory, reads it back, and
selects with ``lax.top_k``.  At B=256 over 1M rows that matrix is 1 GB
each way, and the selection sorts every row.  This kernel (Pallas
through Triton) keeps the scores on chip instead:

- one program per (query block, doc block), query blocks fastest in
  the launch grid so that the programs sharing a doc block are
  scheduled together (whether the corpus then crosses device memory
  only once per step is not measured: PERF.md, open questions);
- each program runs the whole contraction over ``d`` in a loop
  (``pl.dot`` on bf16 accumulating in f32, or on int8 accumulating in
  int32 with the query and row scales applied after), then extracts its
  tile's top ``TILE_H`` per query by max-and-clear in registers;
- only ``[B, (N / BLOCK_N) * TILE_H]`` candidates (exact f32 prescores
  with their int32 rows) reach device memory, and one narrow
  ``lax.top_k`` merges them.

Exactness is verified in-graph (:func:`_verified_merge`): a tile can
hide a true top-k element beyond its ``TILE_H`` only if its ``TILE_H``-th
value beats the merged k-th value; any such tile sends the whole batch
through the exact XLA path inside ``lax.cond``.  Pack-time row
permutation (``engine.packing``) spreads the top-k over tiles, so the
fallback is for adversarial score distributions only.

The engine picks this path on a GPU backend for batched queries over
bf16 and int8 packs of supported shapes (:func:`fused_route`).  f32 packs stay on XLA: the
kernel's f32 dot runs without tensor cores and measured slower than
cuBLAS there (PERF.md).  ``interpret=True`` runs the kernel through the
Pallas interpreter, which is how the CPU tests reach it.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .topk import NEG_INF, exact_topk, pack_vals_idx

#: Pallas memory-ref handle type inside kernel bodies (no public class).
Ref = Any

#: Docs per program: one selection tile.
BLOCK_N = 256
#: Winners extracted per (query, tile).  With permuted rows the top-C of
#: a corpus lands ~Poisson(C / tiles) per tile (C=432 over the 3,968
#: tiles of 1M rows: mean 0.11), so a tile holding more than 8 is
#: vanishingly rare and the coverage check almost never falls back.
TILE_H = 8
#: ``pl.dot``'s smallest row count; query batches pad up to it.
MIN_BLOCK_Q = 16
#: Largest query block per program (accumulator registers bound it).
MAX_BLOCK_Q = 64

#: Contraction chunk per loop step, by storage dtype: 128 bytes of each
#: row per step keeps a pipeline stage at ~40 KB of shared memory.
_BLOCK_D = {"int8": 128, "bfloat16": 64}
#: Triton launch settings, from a sweep on an H100 at 1M x 1536
#: (block_n 128/256 x warps 4/8 x stages 2/3; PERF.md): 4 warps and
#: 2 stages were fastest at b=256 and within noise at b=1.
NUM_WARPS = 4
NUM_STAGES = 2
#: Smallest batch the engine sends here.  On an H100 at 1M x 1536 the
#: solo query is bound by the corpus read on both routes and XLA's was
#: ~6% faster (int8 0.96 vs 1.01 ms, bf16 1.48 vs 1.58 ms); from b=2 on
#: XLA's full sort of the scores costs more than the whole fused step
#: (int8 b=2 1.52 vs 1.01 ms, b=64 9.3 vs 1.4 ms; PERF.md).
FUSED_MIN_BATCH = 2


def _block_d(dtype: Any) -> int:
    return _BLOCK_D[jnp.dtype(dtype).name]


def block_q_for(b: int) -> int:
    """Query rows per program: the batch rounded up to a power of two,
    within ``[MIN_BLOCK_Q, MAX_BLOCK_Q]``."""
    q = MIN_BLOCK_Q
    while q < b and q < MAX_BLOCK_Q:
        q *= 2
    return q


def fused_supported(n: int, d: int, k: int, dtype: Any = jnp.bfloat16) -> bool:
    """Shapes the kernel handles: whole tiles, a dim that the contraction
    chunk divides, and enough tiles that ``k`` fits the candidate pool."""
    if jnp.dtype(dtype).name not in _BLOCK_D:
        return False
    t = n // BLOCK_N
    return (
        n % BLOCK_N == 0
        and d % _block_d(dtype) == 0
        and t >= 2
        and 0 < k <= t * TILE_H
    )


def fused_route(
    platform: str, b: int, n: int, d: int, k: int, dtype: Any
) -> bool:
    """THE single-device dispatch rule: the fused kernel runs on a GPU
    platform for batches of at least :data:`FUSED_MIN_BATCH` at the
    shapes it supports; everything else takes XLA."""
    return (
        platform == "gpu"
        and b >= FUSED_MIN_BATCH
        and fused_supported(n, d, k, dtype)
    )


def _tile_kernel(
    nv_ref: Ref,
    q_ref: Ref,
    docs_ref: Ref,
    *rest: Ref,
    block_q: int,
    block_n: int,
    block_d: int,
    h: int,
    scaled: bool,
) -> None:
    if scaled:
        qs_ref, rs_ref, vals_ref, idx_ref = rest
    else:
        vals_ref, idx_ref = rest
    j = pl.program_id(1)
    d = q_ref.shape[1]
    integer = q_ref.dtype == jnp.int8

    def body(c: jax.Array, acc: jax.Array) -> jax.Array:
        q = q_ref[:, pl.ds(c * block_d, block_d)]
        x = docs_ref[:, pl.ds(c * block_d, block_d)]
        return acc + pl.dot(q, x, trans_b=True)

    acc = jax.lax.fori_loop(
        0,
        d // block_d,
        body,
        jnp.zeros((block_q, block_n), jnp.int32 if integer else jnp.float32),
    )
    s = acc.astype(jnp.float32)
    if scaled:
        # same operation order as quant._int8_scores: raw * row * query
        s = s * rs_ref[...][None, :] * qs_ref[...][:, None]
    col = j * block_n + jax.lax.broadcasted_iota(jnp.int32, (block_q, block_n), 1)
    s = jnp.where(col < nv_ref[0], s, NEG_INF)
    slot = jax.lax.broadcasted_iota(jnp.int32, (block_q, h), 1)
    out_v = jnp.full((block_q, h), NEG_INF, jnp.float32)
    out_i = jnp.zeros((block_q, h), jnp.int32)
    for t in range(h):
        m = jnp.max(s, axis=1)
        # the highest column among equal maxima, then clear exactly it
        i = jnp.max(jnp.where(s == m[:, None], col, -1), axis=1)
        out_v = jnp.where(slot == t, m[:, None], out_v)
        out_i = jnp.where(slot == t, i[:, None], out_i)
        s = jnp.where(col == i[:, None], NEG_INF, s)
    vals_ref[...] = out_v
    idx_ref[...] = out_i


@functools.partial(
    jax.jit,
    static_argnames=("block_n", "num_warps", "num_stages", "interpret"),
)
def tile_candidates(
    docs: jax.Array,
    queries: jax.Array,
    n_valid: jax.Array,
    row_scales: Optional[jax.Array] = None,
    query_scales: Optional[jax.Array] = None,
    block_n: int = BLOCK_N,
    num_warps: int = NUM_WARPS,
    num_stages: int = NUM_STAGES,
    interpret: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Per-tile top-:data:`TILE_H` of ``queries @ docs.T`` with rows
    ``>= n_valid`` masked: ``(vals f32 [B, T*H], rows int32 [B, T*H])``,
    T = N // block_n, each H-group descending.  ``queries`` are already in the
    docs' dtype (int8 with ``query_scales`` for int8 corpora) and B is a
    multiple of :func:`block_q_for` of itself."""
    n, d = docs.shape
    b = queries.shape[0]
    h = TILE_H
    block_q = block_q_for(b)
    block_d = _block_d(docs.dtype)
    scaled = row_scales is not None
    kernel = functools.partial(
        _tile_kernel,
        block_q=block_q,
        block_n=block_n,
        block_d=block_d,
        h=h,
        scaled=scaled,
    )
    in_specs = [
        pl.BlockSpec((1,), lambda i, j: (0,)),
        pl.BlockSpec((block_q, d), lambda i, j: (i, 0)),
        pl.BlockSpec((block_n, d), lambda i, j: (j, 0)),
    ]
    args = [jnp.asarray(n_valid, jnp.int32).reshape(1), queries, docs]
    if scaled:
        in_specs += [
            pl.BlockSpec((block_q,), lambda i, j: (i,)),
            pl.BlockSpec((block_n,), lambda i, j: (j,)),
        ]
        args += [query_scales.astype(jnp.float32), row_scales.astype(jnp.float32)]
    width = (n // block_n) * h
    return pl.pallas_call(
        kernel,
        grid=(b // block_q, n // block_n),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((block_q, h), lambda i, j: (i, j)),
            pl.BlockSpec((block_q, h), lambda i, j: (i, j)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((b, width), jnp.float32),
            jax.ShapeDtypeStruct((b, width), jnp.int32),
        ],
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        backend="triton",
        interpret=interpret,
        name="fused_tile_topk",
    )(*args)


def _verified_merge(
    ev: jax.Array,
    ei: jax.Array,
    k: int,
    h: int,
    fallback: Callable[[], Tuple[jax.Array, jax.Array]],
) -> Tuple[jax.Array, jax.Array]:
    """Merge per-tile winners with one ``top_k`` and prove coverage: a
    tile can hide a true top-k element only if its h-th (smallest
    extracted) value still beats the merged k-th value; any such tile
    routes the batch through ``fallback`` (an exact top-k) inside
    ``lax.cond``.  Returns ``(vals f32, rows int32)``."""
    vals, pos = jax.lax.top_k(ev, k)
    idx = jnp.take_along_axis(ei, pos, axis=1)
    tails = ev[:, h - 1 :: h]  # [B, T]: each tile's h-th value
    covered = jnp.logical_not(jnp.any(tails > vals[:, k - 1 : k]))

    def fast(_: None) -> Tuple[jax.Array, jax.Array]:
        return vals, idx

    def full(_: None) -> Tuple[jax.Array, jax.Array]:
        fv, fi = fallback()
        return fv.astype(jnp.float32), fi.astype(jnp.int32)

    return jax.lax.cond(covered, fast, full, None)


@functools.partial(
    jax.jit, static_argnames=("k", "wide", "budget", "interpret")
)
def fused_topk_packed(
    docs: jax.Array,
    queries: jax.Array,
    n_valid: jax.Array,
    k: int,
    row_scales: Optional[jax.Array] = None,
    wide: bool = False,
    budget: Optional[int] = None,
    interpret: bool = False,
) -> jax.Array:
    """Exact masked top-``k`` through the fused kernel + verified merge,
    packed as the engine's wire (``ops.topk.pack_vals_idx``).  ``docs``
    is ``[N, d]`` bf16, or int8 with per-row ``row_scales``;
    ``queries`` ``[B, d]`` f32.  The fallback is
    :func:`svs_tpu.ops.topk.exact_topk` under the scores ``budget``.
    Requires :func:`fused_supported`."""
    b, d = queries.shape
    block_q = block_q_for(b)
    b_pad = -(-b // block_q) * block_q
    q = queries
    if b_pad != b:
        q = jnp.concatenate([q, jnp.zeros((b_pad - b, d), q.dtype)], axis=0)
    if row_scales is not None:
        from .quant import quantize_rows_int8

        q_int8, q_scales = quantize_rows_int8(q)
        ev, ei = tile_candidates(
            docs, q_int8, n_valid, row_scales, q_scales, interpret=interpret
        )
    else:
        ev, ei = tile_candidates(
            docs, q.astype(docs.dtype), n_valid, interpret=interpret
        )
    vals, idx = _verified_merge(
        ev[:b],
        ei[:b],
        k,
        TILE_H,
        lambda: exact_topk(docs, queries, n_valid, k, row_scales, budget),
    )
    return pack_vals_idx(vals, idx, wide=wide)
