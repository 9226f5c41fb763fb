"""Stage profile of the blocked pairwise path at the 100k headline shape.

Times, on the real device (chained where possible, else repeated e2e):

  1. full pairwise_topk_blocked (m=64 attempt)     — the headline number
  2. matmul+mask scan only (no selection, no merge) — the matmul floor
  3. matmul+mask+select scan (collect, no final merge)
  4. the final flat lax.top_k merge alone at the collected width

Run on the GPU: python benchmarks/pairwise_prof.py [n] [k]
"""

from __future__ import annotations

import functools
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from svs_tpu.ops.pairwise import _pairwise_attempt
from svs_tpu.ops.topk import NEG_INF, scores_matmul

N = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
K = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000
D = 1536
BLOCK = 256
M = 64
N_PAD = ((N + BLOCK - 1) // BLOCK) * BLOCK


@jax.jit
def synth(_):
    r = jax.lax.broadcasted_iota(jnp.float32, (N_PAD, D), 0)
    c = jax.lax.broadcasted_iota(jnp.float32, (N_PAD, D), 1)
    x = jnp.sin(r * 12.9898 + c * 78.233) * 43758.5453
    x = x - jnp.floor(x) - 0.5
    x = x / jnp.sqrt(jnp.sum(x * x, axis=1, keepdims=True))
    return x.astype(jnp.bfloat16)


def scan_stages(docs, n_valid, with_select):
    n_padded = docs.shape[0]
    n_blocks = n_padded // BLOCK
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (BLOCK, n_padded), 1)

    def step(carry, block_idx):
        row0 = block_idx * BLOCK
        block = jax.lax.dynamic_slice(docs, (row0, 0), (BLOCK, D))
        scores = scores_matmul(docs, block)
        row_ids = row0 + jax.lax.broadcasted_iota(
            jnp.int32, (BLOCK, n_padded), 0
        )
        live = (col_ids > row_ids) & (col_ids < n_valid) & (row_ids < n_valid)
        scores = jnp.where(live, scores, NEG_INF)
        if with_select:
            blk_vals, blk_cols = jax.lax.top_k(scores, M)
            return carry + jnp.max(blk_vals[:, -1]), (
                blk_vals.reshape(-1),
                blk_cols.reshape(-1),
            )
        return carry + jnp.max(scores), None

    acc, collected = jax.lax.scan(
        step, jnp.float32(0.0), jnp.arange(n_blocks, dtype=jnp.int32)
    )
    if with_select:
        return acc, collected[0].reshape(-1)
    return acc, None


@jax.jit
def matmul_mask_only(docs, n_valid):
    return scan_stages(docs, n_valid, False)[0]


@jax.jit
def matmul_select(docs, n_valid):
    acc, flat = scan_stages(docs, n_valid, True)
    return acc + flat[0]


@jax.jit
def matmul_select_merge(docs, n_valid):
    acc, flat = scan_stages(docs, n_valid, True)
    vals, _pos = jax.lax.top_k(flat, K)
    return acc + vals[-1]


@functools.partial(jax.jit, static_argnames=("w",))
def flat_topk(flat, w):
    return jax.lax.top_k(flat, w)[0][-1]


def timeit(label, fn, args, reps=5):
    np.asarray(fn(*args))
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r = fn(*args)
        np.asarray(r)
        runs.append(time.perf_counter() - t0)
    runs.sort()
    print(
        f"{label:34}: median {runs[len(runs) // 2] * 1e3:9.1f} ms "
        f"(spread {runs[0] * 1e3:.1f}-{runs[-1] * 1e3:.1f})",
        flush=True,
    )
    return runs[len(runs) // 2]


def main():
    print("device:", jax.devices()[0], flush=True)
    print(f"N={N} (pad {N_PAD}), D={D}, K={K}, block={BLOCK}, m={M}")
    docs = synth(0)
    np.asarray(docs[0, :1])
    nv = jnp.int32(N)

    def full(d_, nv_):
        return _pairwise_attempt(d_, nv_, K, M, BLOCK)[0]

    timeit("1 full attempt m=64 (headline)", full, (docs, nv), reps=3)
    timeit("2 matmul+mask scan only", matmul_mask_only, (docs, nv), reps=3)
    timeit("3 matmul+mask+select (no merge)", matmul_select, (docs, nv), reps=3)
    timeit("4 scan + final merge", matmul_select_merge, (docs, nv), reps=3)

    flat = jnp.zeros((N_PAD * M,), jnp.float32)
    timeit(f"5 flat top_k {N_PAD * M} -> {K}", flat_topk, (flat, K), reps=3)


if __name__ == "__main__":
    main()
