"""Pre-filter vs post-filter ladder A/B at 1M docs on silicon.

Same selectivities, same queries, two exact routes:

- **ladder** (opaque predicate): exact global prefix, host predicate,
  widen 4x per under-filled round — cost grows ~log4(1/selectivity)
  device rounds plus prefix hydration;
- **pre-filter** (declarative filter): ``RetrievalEngine.subset_topk``
  gathers ONLY the matching rows from the f32 HBM mirror, one exact dot
  + tie-rule selection on device, [B, 2k+1] wire — cost grows with the
  MATCH COUNT, independent of selectivity's log.

The bench corpus has no metas, so the declarative filter is simulated
by patching ``MetaRowIndex.lookup`` to return the precomputed matching
emb ids (texts are ``'doc <i>'`` -> emb id i+1; ``i % mod == 0``
matches).  That is exactly what a real index lookup returns — the
patched cost (a dict hit) matches the real warm-index cost; the one-off
index build scan is reported separately by its real implementation in
``tests/test_filter_prefilter.py`` corpora.

Run on the GPU:  python benchmarks/prefilter.py [n_docs] [batch]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from corpus import ensure_bench_kb, query_embedder  # noqa: E402

N = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
BATCH = int(sys.argv[2]) if len(sys.argv) > 2 else 64
DIM = 1536
TOP_N = 10
REPEATS = 5
MODS = [64, 1024, 16384]  # 15,625 / 977 / 62 matching docs at 1M


def main() -> None:
    from svs_tpu import KB

    t0 = time.perf_counter()
    path = ensure_bench_kb(N, DIM)
    print(f"corpus ready in {time.perf_counter() - t0:.1f}s", flush=True)
    kb = KB(str(path), query_embedder(DIM))
    t0 = time.perf_counter()
    kb.load()
    print(f"load: {time.perf_counter() - t0:.1f}s", flush=True)

    queries = [f"q:{i}" for i in range(BATCH)]
    kb.retrieve_batch(queries, TOP_N)  # warm the unfiltered path

    # Patch the index: filter {"mod": m} -> emb ids of docs i % m == 0.
    subsets = {
        m: np.arange(0, N, m, dtype=np.int64) + 1 for m in MODS
    }
    kb._meta_index.lookup = (  # type: ignore[method-assign]
        lambda tx, flt: subsets[flt["mod"]]
    )

    print(
        f"\n{N}x{DIM} | batch {BATCH} | top-{TOP_N} | median of {REPEATS}\n"
    )
    print(
        f"{'selectivity':>12} {'matches':>8} {'ladder p50':>12} "
        f"{'prefilter p50':>14} {'speedup':>8} {'pf/query':>10}"
    )
    for mod in MODS:
        pred = lambda d, _m=mod: int(d["text"].split(" ")[1]) % _m == 0

        def run(where):  # noqa: ANN001
            times = []
            res = None
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                res = kb.retrieve_batch(queries, TOP_N, where=where)
                times.append(time.perf_counter() - t0)
            times.sort()
            return times[len(times) // 2], res

        p50_l, res_l = run(pred)
        p50_p, res_p = run({"mod": mod})
        key = lambda rs: [
            [(h["doc"]["id"], h["score"]) for h in r] for r in rs
        ]
        assert key(res_l) == key(res_p), f"route mismatch at mod={mod}"
        print(
            f"{f'1/{mod}':>12} {len(subsets[mod]):>8} "
            f"{p50_l * 1e3:>10.1f}ms {p50_p * 1e3:>12.1f}ms "
            f"{p50_l / p50_p:>7.1f}x {p50_p * 1e3 / BATCH:>8.3f}ms",
            flush=True,
        )
    kb.close()


if __name__ == "__main__":
    main()
