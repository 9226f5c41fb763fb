"""On-device oracle stress: the FULL retrieve pipeline vs exhaustive NumPy.

Randomized end-to-end soundness evidence on real hardware: for a grid of
corpora (precision x shape, with planted adversarial structure) and
(batch, k) combos, drive ``KB.retrieve_batch`` — embed, the device
prescore, on-device f32 rescore + final selection, margin proof,
widen-and-retry, width-hint adaptation, hydration — and verify every
result against the obviously-correct host oracle (exact f32 scores +
the reference tie rule, ``/root/reference/src/svs/util.py:190-203``).

Planted structure per corpus:
- an exact-duplicate block (score ties -> larger emb id must win);
- near-tie rows (1e-4 perturbations of one direction) straddling k;
- a HOT subtile: many top docs packed contiguously in insertion order —
  adversarial for per-subtile extraction coverage and the v3 guard
  bound (forces margin failures -> widen path on silicon);
- random ``n_valid`` offsets (padding-mask edges).

Each (batch, k) combo runs several query draws and REPEATS queries to
push the width-hint ladder into steady state — narrowed widths must
stay exact.

Verification per query (tolerant only to f32 summation-order ties):
- every returned score equals the true np.dot score of its doc (2e-6);
- the returned set matches the oracle top-k exactly wherever adjacent
  oracle scores are separated by > 1e-5; within closer groups, set
  equality (device f32 dots may legitimately order ulp-level ties
  differently than BLAS);
- planted exact ties surface largest-emb-id first.

Run on the GPU: ``python benchmarks/stress_oracle.py [trials_seed]``
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from svs_tpu import KB  # noqa: E402
from svs_tpu.store.blob import matrix_rows_to_blobs  # noqa: E402
from svs_tpu.store.db import Database  # noqa: E402

WORK = Path(tempfile.gettempdir()) / "svs_tpu_stress"

import os

if os.environ.get("SVS_STRESS_MICRO"):
    # Default-suite tier (seconds on a 1-vCPU CPU backend): the full
    # KB pipeline oracle — adversarial ties, margin widen, hints,
    # hydration — on the CPU backend's XLA routes.  The fused GPU
    # kernel is covered by tests/test_fused_topk.py (interpreter) and
    # chip_smoke.py (on the card).
    CORPORA = [
        ("bf16", 2_048 + 117, 64, None),
        ("f32", 1_024 + 33, 64, None),
        ("int8", 1_024 + 33, 64, None),
    ]
    COMBOS = [(1, 5), (8, 9)]
    DRAWS, REPEATS = 1, 1
elif os.environ.get("SVS_STRESS_SMOKE"):
    # f32 included: its rescore path (device gather from the pack
    # itself) regressed tie order in round 3 and only this harness
    # caught it — the smoke must keep covering all three precisions'
    # dispatch, so int8 rides the smaller shape too.
    CORPORA = [
        ("bf16", 16_384 + 517, 256, None),
        ("f32", 8_192 + 321, 128, None),
        ("int8", 8_192 + 321, 128, None),
        # replica fan-out: same adversarial corpus, query batches split
        # across devices — the oracle must hold through the slicing
        ("bf16", 16_384 + 517, 256, 4),
    ]
    COMBOS = [(1, 10), (32, 25)]
    DRAWS, REPEATS = 1, 1
else:
    CORPORA = [
        # (precision, n_docs, dim, replicas[, combos override])
        ("bf16", 16_384 + 517, 256, None),
        ("bf16", 40_000, 768, None),
        ("int8", 50_000, 1536, None),
        ("int8", 20_123, 256, None),
        ("f32", 30_000, 512, None),
        ("bf16", 40_000, 768, 4),  # replica fan-out (degrades to the
        # available device count; exercises slice-level dispatch + eps)
        # a large corpus: thousands of fused-kernel tiles, so the merge
        # and its coverage check run at scale.  Few combos (the
        # host-side exhaustive oracle costs ~0.2 s/query here).
        ("bf16", 852_000, 128, None, [(256, 100), (16, 10)]),
        ("int8", 852_000, 128, None, [(256, 100)]),
    ]
    COMBOS = [(1, 10), (8, 100), (32, 25), (64, 100), (256, 100), (256, 400)]
    DRAWS = 3  # query draws per combo
    REPEATS = 2  # re-runs of the last draw (width-hint steady state)

TIE_ATOL = 1e-5  # adjacent-oracle-score gap below which order is free
SCORE_ATOL = 2e-6  # device f32 dot vs np.dot


def build_matrix(rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    m = rng.standard_normal((n, dim)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    # Adversary positions scale down for the MICRO tier's small corpora
    # (fixed rows assume n > 8291); semantics unchanged at full size.
    big = n > 8292
    dup = 100 if big else n // 10
    tie = 600 if big else n // 4
    hot0 = 8192 if big else (2 * n) // 3
    # exact-duplicate block: 20 rows all equal the first
    m[dup : dup + 20] = m[dup]
    # near-ties: 30 rows = one direction + 1e-4 jitters, re-normalized
    base = m[tie - 100 if big else tie - 1] + 0.0
    for i in range(30):
        v = base + 1e-4 * rng.standard_normal(dim).astype(np.float32)
        m[tie + i] = v / np.linalg.norm(v)
    # HOT subtile: jittered copies of one direction — near-top docs
    # packed inside ~one extraction subtile
    hot = rng.standard_normal(dim).astype(np.float32)
    hot /= np.linalg.norm(hot)
    for i in range(min(100, n - hot0 - 1)):
        v = hot + 3e-3 * rng.standard_normal(dim).astype(np.float32)
        m[hot0 + i] = v / np.linalg.norm(v)
    return m


def build_kb(path: Path, m: np.ndarray) -> None:
    if path.exists():
        path.unlink()
    db = Database(path)
    db.check_or_set_schema_version()
    try:
        with db.transaction() as tx:
            tx.set_key("embedding_func_params", '{"provider": "mock"}')
            tx.add_docs_bulk(
                [f"d:{i}" for i in range(m.shape[0])],
                matrix_rows_to_blobs(m),
            )
            tx.bump_matrix_version()
    finally:
        db.close()


def make_embedder(qvecs: dict):
    async def embed(texts):
        return np.asarray([qvecs[t] for t in texts], dtype=np.float32)

    embed.__embedding_func_params__ = {"provider": "mock"}
    return embed, qvecs


def draw_queries(
    rng: np.random.Generator, m: np.ndarray, b: int, tag: str, qvecs: dict
) -> list:
    dim = m.shape[1]
    n = m.shape[0]
    big = n > 8292  # mirror build_matrix's scaled adversary positions
    dup = 100 if big else n // 10
    hot0 = 8192 if big else (2 * n) // 3
    names = []
    for i in range(b):
        mode = rng.integers(0, 4)
        if mode == 0:  # exact corpus row (likely unique top-1)
            v = m[int(rng.integers(0, m.shape[0]))] + 0.0
        elif mode == 1:  # the duplicate-block direction (exact ties at top)
            v = m[dup] + 0.0
        elif mode == 2:  # the hot direction (margin stress)
            v = m[hot0] + 0.0
        else:  # noise
            v = rng.standard_normal(dim).astype(np.float32)
            v /= np.linalg.norm(v)
        name = f"q:{tag}:{i}"
        qvecs[name] = v.astype(np.float32)
        names.append(name)
    return names


def oracle_check(
    m: np.ndarray, q: np.ndarray, k: int, hits: list, where: str
) -> None:
    exact = m.astype(np.float32) @ q.astype(np.float32)
    emb_ids = np.arange(1, m.shape[0] + 1, dtype=np.int64)
    order = np.lexsort((-emb_ids, -exact))
    k_eff = min(k, m.shape[0])
    want = order[:k_eff]
    got_idx = np.asarray([int(h["doc"]["text"].split(":")[1]) for h in hits])
    got_scores = np.asarray([float(h["score"]) for h in hits])
    assert len(hits) == k_eff, f"{where}: {len(hits)} hits != {k_eff}"
    # (1) reported scores are the true scores of the returned docs
    true_of_got = exact[got_idx]
    bad = np.abs(got_scores - true_of_got) > SCORE_ATOL
    assert not bad.any(), (
        f"{where}: reported score != true score at {np.nonzero(bad)[0][:5]}"
        f" ({got_scores[bad][:3]} vs {true_of_got[bad][:3]})"
    )
    # (2) exact match wherever the oracle separates scores by > TIE_ATOL;
    # within closer runs, set equality
    ws = exact[want]
    i = 0
    while i < k_eff:
        j = i + 1
        while j < k_eff and ws[j] > ws[i] - TIE_ATOL:
            j += 1
        # group [i, j): compare as sets (extend group membership in `got`
        # by score closeness, since the boundary may land inside a tie)
        w_set = set(want[i:j].tolist())
        g_set = set(got_idx[i:j].tolist())
        if w_set != g_set:
            # allow a swap across the group edge only if scores tie there
            diff = w_set ^ g_set
            ok = all(
                abs(exact[d] - ws[min(j - 1, k_eff - 1)]) <= TIE_ATOL
                for d in diff
            )
            assert ok, (
                f"{where}: rank group [{i},{j}) mismatch: "
                f"want {sorted(w_set)[:6]} got {sorted(g_set)[:6]}"
            )
        i = j
    # (3) exact ties surface largest emb id (largest row index) first
    for i in range(k_eff - 1):
        if got_scores[i] == got_scores[i + 1] and np.isclose(
            true_of_got[i], true_of_got[i + 1], atol=0
        ):
            assert got_idx[i] > got_idx[i + 1], (
                f"{where}: tie order broken at rank {i}: "
                f"{got_idx[i]} before {got_idx[i + 1]}"
            )


def main(seed: int = 0) -> None:
    WORK.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    t_start = time.perf_counter()
    checks = 0
    for entry in CORPORA:
        precision, n, dim, replicas = entry[:4]
        combos = entry[4] if len(entry) > 4 else COMBOS
        m = build_matrix(rng, n, dim)
        path = WORK / f"stress_{precision}_{n}_{dim}.sqlite"
        build_kb(path, m)
        qvecs: dict = {}
        embed, _ = make_embedder(qvecs)
        rep = None
        if replicas is not None:
            import jax

            rep = min(replicas, len(jax.devices()))
        kb = KB(
            path, embed, precision=precision, sidecar=False, replicas=rep
        )
        try:
            for b, k in combos:
                for d in range(DRAWS + REPEATS):
                    tag = f"{precision}{n}x{dim}b{b}k{k}d{min(d, DRAWS - 1)}"
                    if d < DRAWS:
                        names = draw_queries(rng, m, b, tag, qvecs)
                        last = names
                    else:
                        names = last  # repeat: width-hint steady state
                    res = kb.retrieve_batch(names, k)
                    for qi, name in enumerate(names):
                        oracle_check(
                            m, qvecs[name], k, res[qi],
                            f"{tag} rep{d} q{qi}",
                        )
                        checks += 1
            print(
                f"[stress] {precision} {n}x{dim}"
                f"{f' x{rep} replicas' if rep else ''}: OK "
                f"({len(combos) * (DRAWS + REPEATS)} batches)",
                flush=True,
            )
        finally:
            kb.close()
    print(
        f"[stress] ALL OK: {checks} query-level oracle checks in "
        f"{time.perf_counter() - t_start:.0f}s (seed {seed})"
    )


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
