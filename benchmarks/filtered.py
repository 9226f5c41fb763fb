"""Filtered retrieval benchmark: exact `where=` retrieval at 1M docs.

Measures ``KB.retrieve_batch(..., where=predicate)`` end-to-end (device
prefix search -> verified f32 rescore -> hydration -> host predicate ->
widen ladder) across filter selectivities.  The corpus texts are
``'doc <i>'``, so ``i % mod == 0`` gives selectivity 1/mod without
re-embedding anything; the design predicts O(log4(mod)) search rounds
(kb._filter_round) with the prefix m growing 4x per round from 4n.

Run on the GPU:  python benchmarks/filtered.py [n_docs] [batch]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from corpus import ensure_bench_kb, query_embedder  # noqa: E402

N = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
BATCH = int(sys.argv[2]) if len(sys.argv) > 2 else 64
DIM = 1536
TOP_N = 10
REPEATS = 5


def main() -> None:
    from svs_tpu import KB

    t0 = time.perf_counter()
    path = ensure_bench_kb(N, DIM)
    print(f"corpus ready in {time.perf_counter() - t0:.1f}s ({path})",
          flush=True)
    kb = KB(str(path), query_embedder(DIM))
    t0 = time.perf_counter()
    kb.load()
    print(f"load (pack + caches): {time.perf_counter() - t0:.1f}s",
          flush=True)

    rounds: list[int] = []
    real = kb._search_hydrated

    def spy(corpus, vectors, n):  # noqa: ANN001
        rounds.append(n)
        return real(corpus, vectors, n)

    kb._search_hydrated = spy  # type: ignore[method-assign]

    queries = [f"q:{i}" for i in range(BATCH)]
    # warm the unfiltered path (compile + caches)
    kb.retrieve_batch(queries, TOP_N)

    print(f"\n{N}x{DIM} | batch {BATCH} | top-{TOP_N} | median of "
          f"{REPEATS}\n")
    print(f"{'filter':>12} {'selectivity':>12} {'p50/batch':>12} "
          f"{'per query':>12} {'rounds':>7} {'final m':>8}")
    for mod in [0, 2, 10, 100, 1000]:
        where = None if mod == 0 else (
            lambda d, _m=mod: int(d["text"].split(" ")[1]) % _m == 0
        )
        times = []
        n_rounds = final_m = 0
        for _ in range(REPEATS):
            rounds.clear()
            t0 = time.perf_counter()
            res = kb.retrieve_batch(queries, TOP_N, where=where)
            times.append(time.perf_counter() - t0)
            n_rounds, final_m = len(rounds), (rounds[-1] if rounds else 0)
            assert all(len(r) == TOP_N for r in res)
            if where is not None:
                assert all(
                    where(h["doc"]) for r in res for h in r
                )
        times.sort()
        p50 = times[len(times) // 2]
        label = "none" if mod == 0 else f"i%{mod}==0"
        sel = "1" if mod == 0 else f"1/{mod}"
        print(f"{label:>12} {sel:>12} {p50 * 1e3:>10.1f}ms "
              f"{p50 * 1e3 / BATCH:>10.3f}ms {n_rounds:>7} {final_m:>8}",
              flush=True)
    kb.close()


if __name__ == "__main__":
    main()
