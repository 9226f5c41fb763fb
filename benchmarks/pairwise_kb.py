"""Full-KB pairwise dedup benchmark: flat-random vs dupe-planted corpus.

Flat-random corpora are near-adversarial for the pairwise rescore
margin: the exact k-th pair sits in the bulk distribution's extreme
tail.  Real dedup corpora (the tool's actual use, reference
``svs/kb.py`` ``document_top_pairwise_scores``) have the opposite shape
— near-dupes at cos ~0.94 vs a ~0.16 bulk — so the margin clears at the
first attempt.

This script measures ``KB.document_top_pairwise_scores`` (the WHOLE
verified pipeline: blocked candidates -> f32 rescore -> margin check ->
widen-retry if needed -> hydration) on both corpus shapes, counting
widen retries via the kb log.

Run on the GPU:  python benchmarks/pairwise_kb.py [n] [k]
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from corpus import ensure_bench_kb, query_embedder  # noqa: E402

N = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
K = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000
DIM = 1536
# >= K/N so the whole top-K is dupe pairs (cos ~0.94) and the margin at
# the K-th boundary separates from the ~0.16 bulk by ~0.8.
DUPE_FRAC = 0.12


class _WidenCounter(logging.Handler):
    def __init__(self) -> None:
        super().__init__()
        self.widens = 0

    def emit(self, record: logging.LogRecord) -> None:
        if "pairwise rescore margin insufficient" in record.getMessage():
            self.widens += 1


def run_one(label: str, dupe_frac: float) -> None:
    from svs_tpu import KB

    t0 = time.perf_counter()
    path = ensure_bench_kb(N, DIM, dupe_frac=dupe_frac)
    print(f"[{label}] corpus ready in {time.perf_counter() - t0:.1f}s "
          f"({path})", flush=True)

    counter = _WidenCounter()
    kb_log = logging.getLogger("svs_tpu.kb")
    kb_log.addHandler(counter)
    # Handlers only see records that pass the LOGGER's level check; the
    # widen message is INFO, so the default WARNING level would hide it.
    kb_log.setLevel(logging.INFO)
    kb = KB(path, query_embedder(DIM))
    try:
        t0 = time.perf_counter()
        kb.load()
        print(f"[{label}] load {time.perf_counter() - t0:.1f}s", flush=True)
        runs = []
        for i in range(3):
            before = counter.widens
            t0 = time.perf_counter()
            pairs = kb.document_top_pairwise_scores(K)
            runs.append(time.perf_counter() - t0)
            assert len(pairs) == K
            print(
                f"[{label}] run {i}: {runs[-1] * 1e3:8.0f} ms  "
                f"widens={counter.widens - before}  "
                f"top={pairs[0][0]:.4f}  kth={pairs[-1][0]:.4f}",
                flush=True,
            )
        runs.sort()
        print(f"[{label}] median {runs[len(runs) // 2] * 1e3:.0f} ms "
              f"(spread {runs[0] * 1e3:.0f}-{runs[-1] * 1e3:.0f})",
              flush=True)
    finally:
        kb.close()
        logging.getLogger("svs_tpu.kb").removeHandler(counter)


def main() -> None:
    import jax

    print("device:", jax.devices()[0], flush=True)
    print(f"N={N}, D={DIM}, K={K}, dupe_frac={DUPE_FRAC}", flush=True)
    run_one("dupes", DUPE_FRAC)
    run_one("flat", 0.0)


if __name__ == "__main__":
    main()
