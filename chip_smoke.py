"""Smoke test of svs_tpu on NVIDIA GPUs: the main path against NumPy.

Run from the root of a checkout, on a machine with a GPU:

    python chip_smoke.py              # one GPU, phases 1-6 below
    python chip_smoke.py --chips 4    # four GPUs: the multi-device paths

Data: a real on-disk KB built by ``benchmarks/corpus.py`` — 1,000,000 x
1536 seeded unit rows, the reference package's published "one million
documents" configuration (BASELINE.md) — cached under ``.cache/bench``.
The reference is plain NumPy f32: it regenerates the same rows from
``--seed``, scores every document, and orders by the reference's tie
rule (equal scores go to the larger embedding id).

Tolerances: returned scores within 2e-6 of the reference's f32 score,
and the reference's ordered ids, except that two documents whose
reference scores lie within 1e-6 of each other may swap (f32
accumulation order differs between the card and the host BLAS).

Phases on one GPU:

1. ``retrieve`` (b=1) and ``retrieve_batch`` (b=256), top-100, for
   precision 'auto' (int8 prescore), 'bf16' and 'f32';
2. the device prescore against exact f32 scores: every candidate within
   ``prescore_eps``, every document clearly above the boundary present;
3. filtered ``retrieve(..., where=...)``, a selective and an
   unselective predicate;
4. 100 documents added and 100 deleted, then retrieval again on the
   incremental pack path (on a copy of the KB);
5. ``document_top_pairwise_scores(10_000)`` on a 100,000 x 1536 KB;
6. the fused GPU kernel alone against the plain XLA prescore at
   1M x 1536, b=1 and b=256.

With ``--chips 4``: a row-sharded mesh (int8), a 2x2 mesh sharding rows
and the dim (bf16) and four replicas, each against the reference and the
one-GPU answer.

Each phase shows from the program's own state that the GPU answered:
the pack's arrays live on GPU devices and the host route is off.  Any
failure raises, so the script exits non-zero and prints no result; the
last line of a passing run is ``{"ok": true, "device": {...}}``.
Timings are printed for information only.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
#: Returned scores vs the reference's f32 scores.
SCORE_TOL = 2e-6
#: Reference scores this close may swap places (accumulation order).
TIE_TOL = 1e-6
K = 100
BATCH = 256
#: Pairwise phase: top PAIRS_K pairs of a PAIRS_N-document KB.
PAIRS_N = 100_000
PAIRS_K = 10_000


class SmokeFailure(AssertionError):
    """A phase's answer disagreed with the reference."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*parts: object) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# -- the reference ---------------------------------------------------------------


def ref_order(scores: np.ndarray, ids: np.ndarray, k: int) -> np.ndarray:
    """Positions of the top-``k`` by (score desc, id desc)."""
    m = min(len(scores), k + 64)
    part = np.argpartition(-scores, m - 1)[:m]
    order = np.lexsort((-ids[part], -scores[part]))[:k]
    return part[order]


def check_ranked(
    label: str,
    got_keys: list,
    got_scores: list,
    ref_keys: list,
    ref_scores: np.ndarray,
    exact_of: "dict[object, float]",
) -> int:
    """Compare one ranked answer with the reference's; returns how many
    near-tie swaps were accepted."""
    check(
        len(got_keys) == len(ref_keys),
        f"{label}: {len(got_keys)} results, reference has {len(ref_keys)}",
    )
    check(len(set(got_keys)) == len(got_keys), f"{label}: duplicate results")
    swaps = 0
    for j, (key, score) in enumerate(zip(got_keys, got_scores)):
        check(key in exact_of, f"{label}: result {key!r} is not a document")
        exact = exact_of[key]
        check(
            abs(score - exact) <= SCORE_TOL,
            f"{label}[{j}]: score {score} vs reference {exact}",
        )
        if key != ref_keys[j]:
            check(
                abs(exact - float(ref_scores[j])) <= TIE_TOL,
                f"{label}[{j}]: {key!r} ({exact}) where the reference has "
                f"{ref_keys[j]!r} ({float(ref_scores[j])})",
            )
            swaps += 1
    return swaps


class Reference:
    """Exact f32 scores of the smoke queries over the base corpus."""

    def __init__(self, matrix: np.ndarray, queries: np.ndarray) -> None:
        self.matrix = matrix
        self.queries = queries
        self.ids = np.arange(1, len(matrix) + 1, dtype=np.int64)
        t0 = time.perf_counter()
        self.scores = queries @ matrix.T  # [B, n] f32
        say(f"  reference scores {self.scores.shape} in "
            f"{time.perf_counter() - t0:.1f}s")

    def check_hits(
        self,
        label: str,
        q: int,
        hits: list,
        k: int = K,
        keep: "np.ndarray | None" = None,
        extra: "tuple[np.ndarray, list] | None" = None,
    ) -> int:
        """The top-``k`` ``hits`` of query ``q`` against the reference
        over the live rows ``keep`` (default all) plus ``extra`` =
        (scores, texts) of documents added after the build (their ids
        follow the base corpus's)."""
        row = self.scores[q]
        idx = np.arange(len(row)) if keep is None else np.flatnonzero(keep)
        cand_scores = row[idx]
        cand_ids = self.ids[idx]
        texts = None
        if extra is not None:
            extra_scores, texts = extra
            cand_scores = np.concatenate([cand_scores, extra_scores])
            cand_ids = np.concatenate([
                cand_ids,
                len(self.ids) + 1 + np.arange(len(extra_scores)),
            ])
        top = ref_order(cand_scores, cand_ids, k)

        def key_of(pos: int) -> str:
            if pos < len(idx):
                return f"doc {idx[pos]}"
            return texts[pos - len(idx)]

        ref_keys = [key_of(int(p)) for p in top]
        got_keys = [h["doc"]["text"] for h in hits]
        exact_of = {}
        for key in got_keys:
            if key.startswith("doc "):
                exact_of[key] = float(row[int(key[4:])])
            elif texts is not None and key in texts:
                exact_of[key] = float(extra[0][texts.index(key)])
        return check_ranked(
            label, got_keys, [h["score"] for h in hits], ref_keys,
            cand_scores[top], exact_of,
        )


# -- proof that the card answered ----------------------------------------------------


def prove_on_gpu(kb, devices: "list | None" = None) -> str:
    """The pack and the rescore mirror live on GPU devices (all of
    ``devices`` when given), and the host route is off."""
    corpus = kb._ensure_engine_fresh()
    eng = kb.engine
    check(eng.host_dispatch == "off", "host route is not off")
    used = set(corpus.data.devices())
    check(all(d.platform == "gpu" for d in used), f"pack on {used}")
    if devices is not None:
        check(used == set(devices), f"pack on {used}, want {set(devices)}")
    if corpus.dev_rescore is not None:
        mirror = set(corpus.dev_rescore[0].devices())
        check(all(d.platform == "gpu" for d in mirror), f"mirror on {mirror}")
    return (
        f"pack {corpus.precision} {tuple(corpus.data.shape)} on "
        f"{sorted(d.id for d in used)}, mirror "
        f"{'on device' if corpus.dev_rescore is not None else 'absent'}, "
        f"host route off"
    )


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


# -- phases -------------------------------------------------------------------------


def retrieval_phase(label, kb, ref: Reference, texts: list) -> list:
    """Solo (b=1) and batched (b=256) top-K against the reference;
    returns the batched hits."""
    swaps = 0
    for q in range(4):
        hits, ms = _timed(lambda: kb.retrieve(texts[q], K))
        swaps += ref.check_hits(f"{label} solo q{q}", q, hits)
    say(f"  {label} solo: 4 queries match (last {ms:.1f} ms)")
    kb.retrieve_batch(texts, K)  # compile + settle the width hints
    batch, ms = _timed(lambda: kb.retrieve_batch(texts, K))
    for q, hits in enumerate(batch):
        swaps += ref.check_hits(f"{label} batch q{q}", q, hits)
    say(f"  {label} batch {len(texts)}: all match ({ms:.1f} ms), "
        f"near-tie swaps {swaps}")
    return batch


def prescore_phase(label, kb, ref: Reference) -> None:
    """The device prescore against exact f32 scores, at b=1 and b=256."""
    corpus = kb._ensure_engine_fresh()
    eng = kb.engine
    c = eng.candidate_count(K)
    for b in (1, BATCH):
        q = ref.queries[:b]
        vals, rows = eng.topk(corpus, q, c)
        eps = eng.prescore_eps(corpus, q, c)
        route = "fused" if eng._fused_route(corpus, b, c) else "xla"
        worst = 0.0
        for i in range(b):
            matrix_rows = corpus.emb_ids[rows[i]] - 1
            exact = ref.scores[i][matrix_rows]
            err = np.abs(vals[i] - exact)
            worst = max(worst, float((err / eps[i]).max()))
            check((err <= eps[i]).all(),
                  f"{label} prescore b={b} q{i}: error {err.max()} > "
                  f"eps {eps[i]}")
            must = np.flatnonzero(ref.scores[i] > vals[i][-1] + eps[i])
            check(set(must.tolist()) <= set(matrix_rows.tolist()),
                  f"{label} prescore b={b} q{i}: misses a row above the "
                  "boundary")
        say(f"  {label} prescore b={b} ({route}): {c} candidates within "
            f"eps (worst {worst:.3f} of eps), boundary covered")


def kernel_phase(label, kb, ref: Reference) -> None:
    """The fused kernel alone against the plain XLA prescore on this pack."""
    import jax
    import jax.numpy as jnp

    from svs_tpu.engine.packing import pad_queries
    from svs_tpu.ops import fused_topk as ft
    from svs_tpu.ops.quant import score_topk_int8_packed
    from svs_tpu.ops.topk import score_topk_packed, unpack_vals_idx

    corpus = kb._ensure_engine_fresh()
    scales = corpus.row_scales if corpus.precision == "int8" else None
    c = kb.engine.candidate_count(K)
    nv = corpus.n_valid_device()
    check(ft.fused_supported(
        corpus.n_padded, corpus.dim_padded, c, corpus.data.dtype
    ), f"{label}: fused kernel does not support this pack")
    for b in (1, BATCH):
        q = jnp.asarray(pad_queries(ref.queries[:b], corpus.dim_padded))
        fused = jax.jit(lambda d, s, q, n: ft.fused_topk_packed(
            d, q, n, c, row_scales=s
        ))
        if scales is not None:
            xla = jax.jit(lambda d, s, q, n: score_topk_int8_packed(
                d, s, q, n, c
            ))
        else:
            xla = jax.jit(lambda d, s, q, n: score_topk_packed(d, q, n, c))
        args = (corpus.data, scales, q, nv)
        outs = {}
        times = {"fused": [], "xla": []}
        for name, fn in (("fused", fused), ("xla", xla)):
            outs[name] = np.asarray(fn(*args))
        for name in ("xla", "fused", "fused", "xla") * 3:
            fn = fused if name == "fused" else xla
            t0 = time.perf_counter()
            fn(*args).block_until_ready()
            times[name].append((time.perf_counter() - t0) * 1e3)
        eps = kb.engine.prescore_eps(corpus, ref.queries[:b], c)
        overlap = []
        for name in ("fused", "xla"):
            vals, rows = unpack_vals_idx(outs[name], c)
            for i in range(b):
                matrix_rows = corpus.emb_ids[rows[i]] - 1
                err = np.abs(vals[i] - ref.scores[i][matrix_rows])
                check((err <= eps[i]).all(),
                      f"{label} {name} b={b} q{i}: error {err.max()}")
                must = np.flatnonzero(ref.scores[i] > vals[i][-1] + eps[i])
                check(set(must.tolist()) <= set(matrix_rows.tolist()),
                      f"{label} {name} b={b} q{i}: boundary not covered")
            outs[name] = rows
        for i in range(b):
            overlap.append(len(
                set(outs["fused"][i].tolist()) & set(outs["xla"][i].tolist())
            ) / c)
        say(f"  {label} kernel b={b}: fused and XLA prescores both within "
            f"eps, candidate overlap {np.mean(overlap):.4f}; "
            f"fused {np.median(times['fused']):.3f} ms, "
            f"XLA {np.median(times['xla']):.3f} ms (median of 6, "
            "block_until_ready)")


def filtered_phase(label, kb, ref: Reference, texts: list) -> None:
    """Selective (1 in 1000) and unselective (1 in 2) predicates."""
    n = len(ref.matrix)
    index = np.arange(n)
    for name, mod in (("selective 1/1000", 1000), ("unselective 1/2", 2)):
        keep = index % mod == 0

        def where(doc, mod=mod):
            return int(doc["text"].split()[1]) % mod == 0

        for q in range(2):
            hits, ms = _timed(lambda: kb.retrieve(texts[q], 10, where=where))
            ref.check_hits(f"{label} {name} q{q}", q, hits, k=10, keep=keep)
        say(f"  {label} filtered {name}: matches ({ms:.1f} ms)")


def incremental_phase(path: Path, embed, ref: Reference, texts: list) -> None:
    """Add 100 documents (the texts of queries 0-99, so each becomes its
    own query's exact top hit) and delete the reference's top hit of
    queries 100-199, then retrieve on the incrementally updated pack."""
    from svs_tpu import KB

    copy = path.with_name("smoke_incremental.sqlite")
    shutil.copyfile(path, copy)
    kb = KB(copy, embed, sidecar=False)
    try:
        kb.load()
        kb.retrieve_batch(texts, K)
        before = dict(kb.engine.pack_events)
        added = texts[:100]
        with kb.bulk_add_docs() as add:
            for t in added:
                add(t)
        kb.retrieve_batch(texts[:8], K)  # picks up the append
        gone = sorted({
            int(ref_order(ref.scores[q], ref.ids, 1)[0])
            for q in range(100, 200)
        })
        with kb.bulk_del_docs() as delete:
            for row in gone:
                delete(row + 1)  # doc ids follow insertion order
        batch, ms = _timed(lambda: kb.retrieve_batch(texts, K))
        after = dict(kb.engine.pack_events)
        say(f"  incremental: {prove_on_gpu(kb)}")
        check(after.get("scan", 0) == before.get("scan", 0),
              f"pack rebuilt from a scan: {before} -> {after}")
        check(after.get("append", 0) > before.get("append", 0)
              and after.get("delete", 0) > before.get("delete", 0),
              f"incremental pack paths not taken: {before} -> {after}")
        keep = np.ones(len(ref.matrix), bool)
        keep[gone] = False
        deleted = {f"doc {row}" for row in gone}
        check(not any(deleted & set(hits_text(h)) for h in batch),
              "incremental: a deleted document came back")
        added_scores = ref.queries @ ref.queries[:100].T  # [B, 100]
        for q, hits in enumerate(batch):
            ref.check_hits(f"incremental q{q}", q, hits, keep=keep,
                           extra=(added_scores[q], added))
        for q in range(100):
            check(hits_text(batch[q])[0] == texts[q],
                  f"incremental q{q}: added twin is not the top hit")
        say(f"  incremental +100/-{len(gone)}: batch matches ({ms:.1f} ms), "
            f"pack events {after}")
    finally:
        kb.close(write_sidecar=False)
        copy.unlink(missing_ok=True)


def hits_text(hits: list) -> list:
    return [h["doc"]["text"] for h in hits]


def pairwise_phase(dim: int, seed: int, embed) -> None:
    """Top 10,000 pairs of a 100,000-document KB against a blocked NumPy
    scan of all 5e9 pairs."""
    from corpus import corpus_matrix, ensure_bench_kb

    from svs_tpu import KB

    n, k = PAIRS_N, PAIRS_K
    path = ensure_bench_kb(n, dim, seed=seed)
    m = corpus_matrix(n, dim, seed)
    t0 = time.perf_counter()
    best_v = np.empty(0, np.float32)
    best_i = np.empty(0, np.int64)
    best_j = np.empty(0, np.int64)
    for r0 in range(0, n, 2048):
        r1 = min(r0 + 2048, n)
        s = m[r0:r1] @ m.T
        rows = np.arange(r0, r1)[:, None]
        head = s[:, :r1]
        head[np.arange(r1)[None, :] <= rows] = -np.inf  # strict upper
        if len(best_v) < k:
            flat = np.argpartition(-s.ravel(), k - 1)[:k]
        else:
            flat = np.flatnonzero(s > best_v.min())
        best_v = np.concatenate([best_v, s.ravel()[flat]])
        best_i = np.concatenate([best_i, r0 + flat // n])
        best_j = np.concatenate([best_j, flat % n])
        if len(best_v) > k:
            keep = np.argpartition(-best_v, k - 1)[:k]
            best_v, best_i, best_j = best_v[keep], best_i[keep], best_j[keep]
    order = np.lexsort((-best_j, -best_i, -best_v))
    ref_keys = [(int(best_i[o]), int(best_j[o])) for o in order]
    ref_scores = best_v[order]
    say(f"  pairwise reference: {n}x{n} scan in "
        f"{time.perf_counter() - t0:.1f}s")

    kb = KB(path, embed, sidecar=False)
    try:
        kb.load()
        check(kb.engine.wait_for_mirror(900), "pack upload timed out")
        say(f"  pairwise: {prove_on_gpu(kb)}")
        pairs, ms = _timed(lambda: kb.document_top_pairwise_scores(k))
        got_keys, got_scores, exact_of = [], [], {}
        for score, a, b in pairs:
            i, j = sorted((int(a["text"][4:]), int(b["text"][4:])))
            got_keys.append((i, j))
            got_scores.append(score)
            exact_of[(i, j)] = float(m[i] @ m[j])
        swaps = check_ranked("pairwise", got_keys, got_scores, ref_keys,
                             ref_scores, exact_of)
        say(f"  pairwise top {k} of {n}: matches ({ms:.0f} ms), "
            f"near-tie swaps {swaps}")
    finally:
        kb.close(write_sidecar=False)


# -- drivers ------------------------------------------------------------------------


def one_gpu(args, path: Path, embed, ref: Reference, texts: list) -> None:
    from svs_tpu import KB

    for precision in ("auto", "bf16", "f32"):
        label = f"[{precision}]"
        kb = KB(path, embed, precision=precision, sidecar=False)
        try:
            t0 = time.perf_counter()
            kb.load()
            check(kb.engine.wait_for_mirror(900), "mirror upload timed out")
            say(f"{label} open {time.perf_counter() - t0:.1f}s: "
                f"{prove_on_gpu(kb)}")
            corpus = kb._ensure_engine_fresh()
            c = kb.engine.candidate_count(K)
            say(f"  routes: b=1 "
                f"{'fused' if kb.engine._fused_route(corpus, 1, c) else 'xla'}"
                f", b={BATCH} "
                f"{'fused' if kb.engine._fused_route(corpus, BATCH, c) else 'xla'}")
            retrieval_phase(label, kb, ref, texts)
            prescore_phase(label, kb, ref)
            if precision != "f32":
                kernel_phase(label, kb, ref)
            if precision == "auto":
                filtered_phase(label, kb, ref, texts)
        finally:
            kb.close(write_sidecar=False)
    say("[incremental]")
    incremental_phase(path, embed, ref, texts)
    say("[pairwise]")
    pairwise_phase(args.dim, args.seed, embed)


def four_gpus(args, path: Path, embed, ref: Reference, texts: list) -> None:
    import jax

    from svs_tpu import KB
    from svs_tpu.parallel.mesh import default_mesh, mesh_2d

    devs = jax.devices()[:4]
    check(len(devs) == 4, f"--chips 4 needs four GPUs, found {len(devs)}")
    cases = [
        ("mesh 1x4 rows, int8", dict(mesh=default_mesh(devices=devs)),
         "auto"),
        ("mesh 2x2 rows x dim, bf16",
         dict(mesh=mesh_2d(2, 2, devices=devs)), "bf16"),
        ("replicas=4, int8", dict(replicas=4), "auto"),
    ]
    single = {}
    for precision in ("auto", "bf16"):
        kb = KB(path, embed, precision=precision, device=devs[0],
                sidecar=False)
        try:
            kb.load()
            say(f"[single GPU {precision}] {prove_on_gpu(kb, [devs[0]])}")
            single[precision] = (
                kb.retrieve(texts[0], K), kb.retrieve_batch(texts, K)
            )
        finally:
            kb.close(write_sidecar=False)
    for label, kwargs, precision in cases:
        kb = KB(path, embed, precision=precision, sidecar=False, **kwargs)
        try:
            t0 = time.perf_counter()
            kb.load()
            check(kb.engine.wait_for_mirror(900), "mirror upload timed out")
            if "replicas" in kwargs:
                corpus = kb._ensure_engine_fresh()
                kb.retrieve_batch(texts, K)  # clones the pack per device
                clones = corpus.replica_clones or ()
                placed = [set(corpus.data.devices())] + [
                    set(cl.data.devices()) for cl in clones
                ]
                check([sorted(d.id for d in p) for p in placed]
                      == [[d.id] for d in devs],
                      f"replica packs on {placed}")
                proof = prove_on_gpu(kb, [devs[0]]) + (
                    f"; clones on {[sorted(d.id for d in p) for p in placed]}"
                )
            else:
                proof = prove_on_gpu(kb, devs)
            say(f"[{label}] open {time.perf_counter() - t0:.1f}s: {proof}")
            batch = retrieval_phase(f"[{label}]", kb, ref, texts)
            solo = kb.retrieve(texts[0], K)
            one_solo, one_batch = single[precision]
            for q, (a, b) in enumerate(zip([solo] + batch,
                                           [one_solo] + one_batch)):
                q = max(q - 1, 0)
                check_ranked(
                    f"[{label}] vs one GPU q{q}", hits_text(a),
                    [h["score"] for h in a], hits_text(b),
                    ref.scores[q][[int(t[4:]) for t in hits_text(b)]],
                    {t: float(ref.scores[q][int(t[4:])])
                     for t in hits_text(a)},
                )
            say(f"  [{label}] agrees with the one-GPU answer")
        finally:
            kb.close(write_sidecar=False)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--dim", type=int, default=1536)
    args = p.parse_args()
    if not (ROOT / "svs_tpu").is_dir() or not (
        ROOT / "benchmarks" / "corpus.py"
    ).is_file():
        sys.exit("chip_smoke.py runs from the root of an svs_tpu checkout")
    # the device must answer every query: no host-scan route
    os.environ["SVS_TPU_HOST_DISPATCH"] = "off"
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "benchmarks"))
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found {dev.platform}")
    say(f"card: {card_line()}")
    say(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}")

    from corpus import (
        corpus_matrix,
        ensure_bench_kb,
        query_embedder,
        query_matrix,
    )

    t0 = time.perf_counter()
    path = ensure_bench_kb(args.n, args.dim, seed=args.seed)
    say(f"KB {args.n}x{args.dim} ready in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    matrix = corpus_matrix(args.n, args.dim, args.seed)
    embed = query_embedder(args.dim, args.seed)
    texts = [f"q:{i}" for i in range(BATCH)]
    queries = query_matrix(np.arange(BATCH), args.dim, args.seed)
    say(f"reference corpus regenerated in {time.perf_counter() - t0:.1f}s; "
        f"tolerances: score {SCORE_TOL}, near-tie swap {TIE_TOL}")
    ref = Reference(matrix, queries)
    if args.chips == 4:
        four_gpus(args, path, embed, ref, texts)
    else:
        one_gpu(args, path, embed, ref, texts)
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
