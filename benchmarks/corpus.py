"""Reusable benchmark corpus: a REAL on-disk KB at benchmark scale.

The kernel benchmarks in ``bench.py`` synthesize their corpus directly on
the device; the full-stack phase needs the real thing — a SQLite store
with 1M embedding BLOBs, documents to hydrate, and a sidecar — because
the round-2 lesson is that the host side (rescore gather + hydration) is
where end-to-end throughput goes to die, and only a real store exercises
it.

Building 1M x 1536 takes a few minutes of disk writes, so the corpus is
built ONCE per (n, dim, seed) into a cache directory and reused across
bench runs (the sidecar written at close makes reopening a zero-scan
mmap).  Vectors are seeded-deterministic unit rows; queries come from
:func:`query_embedder`, which mirrors the row construction so every query
has a known best match.
"""

from __future__ import annotations

import os
import time
import zlib
from pathlib import Path
from typing import Awaitable, Callable, Iterator, List

import numpy as np

#: Built corpora live at a fixed git-ignored path inside the checkout
#: (``SVS_TPU_BENCH_CACHE`` overrides it).
CACHE_DIR = Path(
    os.environ.get(
        "SVS_TPU_BENCH_CACHE",
        Path(__file__).resolve().parent.parent / ".cache" / "bench",
    )
)

#: Insert batch: one executemany per chunk keeps the transaction hot
#: without holding 6 GB of blobs in RAM.
_CHUNK = 20_000


def _rows(rng: np.random.Generator, count: int, dim: int) -> np.ndarray:
    x = rng.standard_normal((count, dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def query_matrix(ids: np.ndarray, dim: int, seed: int = 7) -> np.ndarray:
    """Deterministic unit queries for indices ``ids`` — hash-style rows,
    vectorized over the whole batch (a per-query ``default_rng`` measured
    ~0.2 ms/query, 53 ms of a 256-query batch)."""
    r = np.asarray(ids, np.float64)[:, None]
    c = np.arange(dim, dtype=np.float64)[None, :]
    x = np.sin(r * 12.9898 + c * 78.233 + seed * 1.6180) * 43758.5453
    x = (x - np.floor(x) - 0.5).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def query_vector(i: int, dim: int, seed: int = 7) -> np.ndarray:
    return query_matrix(np.asarray([i]), dim, seed)[0]


def query_embedder(dim: int, seed: int = 7) -> "Callable[[List[str]], Awaitable[List[List[float]]]]":
    """Embedding function for the bench KB: texts ``'q:<i>'`` map to
    :func:`query_matrix` rows; anything else hashes to a seeded index."""

    async def embed(texts: List[str]) -> List[List[float]]:
        # zlib.crc32, not hash(): PYTHONHASHSEED salting would give the
        # reused on-disk corpus different embeddings every process
        ids = [
            int(t.split(":")[1]) if t.startswith("q:")
            else zlib.crc32(t.encode()) % (2**31)
            for t in texts
        ]
        # returned as ndarray: EmbeddingFunc consumers np.asarray() it,
        # and a [256, 1536] tolist()/re-parse round trip costs ~60 ms
        return query_matrix(np.asarray(ids), dim, seed)

    embed.__embedding_func_params__ = {"provider": "mock"}  # type: ignore[attr-defined]
    return embed


def corpus_blocks(
    n: int, dim: int, seed: int = 7, dupe_frac: float = 0.0
) -> "Iterator[np.ndarray]":
    """The bench corpus's rows, ``[count, dim]`` f32 per insert chunk, in
    insertion order: row ``i`` is document ``'doc <i>'`` with embedding
    id ``i + 1``.  Deterministic in ``(n, dim, seed, dupe_frac)``, so a
    reference can regenerate the exact stored vectors."""
    rng = np.random.default_rng(seed)
    done = 0
    while done < n:
        count = min(_CHUNK, n - done)
        block = _rows(rng, count, dim)
        # Each dupe needs a distinct non-dupe source row in the
        # chunk, so at most half the chunk can be dupes.
        n_dupes = min(int(count * dupe_frac), count // 2)
        if n_dupes:
            # Last n_dupes rows become perturbed copies of distinct
            # earlier rows in this chunk: cos ~ 1/sqrt(1+0.35^2).
            srcs = rng.permutation(count - n_dupes)[:n_dupes]
            noise = rng.standard_normal((n_dupes, dim)).astype(np.float32)
            noise /= np.linalg.norm(noise, axis=1, keepdims=True)
            dup = block[srcs] + 0.35 * noise
            dup /= np.linalg.norm(dup, axis=1, keepdims=True)
            block[count - n_dupes:] = dup
        yield block
        done += count


def corpus_matrix(
    n: int, dim: int, seed: int = 7, dupe_frac: float = 0.0
) -> np.ndarray:
    """All of :func:`corpus_blocks` as one ``[n, dim]`` f32 matrix."""
    out = np.empty((n, dim), np.float32)
    done = 0
    for block in corpus_blocks(n, dim, seed, dupe_frac):
        out[done : done + len(block)] = block
        done += len(block)
    return out


def ensure_bench_kb(
    n: int, dim: int, seed: int = 7, dupe_frac: float = 0.0
) -> Path:
    """Build (once) and return the path of the benchmark KB.

    ``dupe_frac`` > 0 plants that fraction of rows as near-duplicates of
    other rows in the same insert chunk (perturbed copies, cosine ~0.94) —
    the shape a real dedup corpus has, where the top pairs separate from
    the random bulk (~0.16 max at 100k) by a wide margin.  The default
    flat-random corpus is near-adversarial for the keyed pairwise margin
    (every top pair sits in the bulk's extreme tail); both are benchmarked.
    """
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"_dup{int(dupe_frac * 100)}" if dupe_frac else ""
    path = CACHE_DIR / f"kb_{n}_{dim}_{seed}{tag}.sqlite"
    marker = Path(f"{path}.done")
    if marker.exists():
        return path
    import sys

    from svs_tpu.store.blob import matrix_rows_to_blobs
    from svs_tpu.store.db import Database

    print(
        f"[bench corpus] building {n}x{dim} store at {path} ...",
        file=sys.stderr, flush=True,
    )
    t0 = time.perf_counter()
    if path.exists():
        path.unlink()
    db = Database(path)
    try:
        with db.transaction() as tx:
            tx.set_key(
                "embedding_func_params", '{"provider": "mock"}'
            )
            done = 0
            for block in corpus_blocks(n, dim, seed, dupe_frac):
                count = len(block)
                blobs = matrix_rows_to_blobs(block)
                tx.add_docs_bulk(
                    [f"doc {done + i}" for i in range(count)], blobs
                )
                done += count
                if done % 200_000 == 0:
                    print(
                        f"[bench corpus] {done}/{n} rows "
                        f"({time.perf_counter() - t0:.0f}s)",
                        file=sys.stderr, flush=True,
                    )
            tx.bump_matrix_version()
    finally:
        db.close()
    marker.write_text("ok")
    print(
        f"[bench corpus] built in {time.perf_counter() - t0:.0f}s",
        file=sys.stderr, flush=True,
    )
    return path
