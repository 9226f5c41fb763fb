"""Same-host head-to-head: the actual reference package vs svs_tpu.

BASELINE.md quotes the reference's published numbers from a 2018 i3-8100;
this script measures the reference package itself (/root/reference/src,
v0.7.4) and svs_tpu on the SAME machine and the SAME on-disk SQLite KB
(the bench corpus from :mod:`benchmarks.corpus`), so the comparison has
no hardware asterisk: identical store bytes, identical (deterministic)
embedding function, identical query texts.

Phases per system (each wall-timed):

  reference (``--system ref``)
    - open + cold first top-k query (full BLOB scan -> RAM f32 matrix,
      the reference's documented cold start: ``svs/kb.py:573-618``)
    - warm top-k queries (p50 / min / max over ``--queries`` runs; the
      hot path is ``np.dot(matrix, q)`` + argpartition,
      ``svs/kb.py:1171-1206``)

  svs_tpu (``--system svs``)
    - open + cold first top-k query (sidecar mmap -> device upload when
      a ``.svsx`` sibling exists — the publish-time cold-start path)
    - warm solo ``retrieve`` end-to-end
    - warm ``retrieve_batch`` at ``--batch`` queries/step, per-query

Run both and print a combined markdown table (each system in its own
subprocess, so the reference's multi-GB RAM matrix never coexists with
the device pipeline):

    python benchmarks/head_to_head.py --n 1000000

Quick variant (also exercises the reference's published 10k shape):

    python benchmarks/head_to_head.py --n 10000 --queries 30
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

REF_SRC = "/root/reference/src"


def _timed(fn, count: int):
    """p50/min/max wall seconds over ``count`` calls (no warm-up here —
    callers time the cold call separately)."""
    walls = []
    for _ in range(count):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return {
        "p50_s": statistics.median(walls),
        "min_s": min(walls),
        "max_s": max(walls),
    }


def _agreement_ids(kb, k: int) -> list:
    """Top-k doc ids for 3 fixed queries — both systems run exact search
    over the same bytes, so ``run_both`` asserts they agree exactly."""
    # Plain texts (not "q:<i>"): query_embedder hashes them, so both
    # systems embed identically and the queries differ from the warm set.
    return [
        [hit["doc"]["id"] for hit in kb.retrieve(f"agreement probe {j}", k)]
        for j in range(3)
    ]


def run_ref(args: argparse.Namespace) -> dict:
    sys.path.insert(0, REF_SRC)
    import svs  # the reference package

    from benchmarks.corpus import ensure_bench_kb, query_embedder

    path = ensure_bench_kb(args.n, args.dim)
    embed = query_embedder(args.dim)

    t0 = time.perf_counter()
    kb = svs.KB(str(path), embedding_func=embed)
    open_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    hits = kb.retrieve("q:0", args.k)
    cold_s = time.perf_counter() - t0
    assert len(hits) == args.k, len(hits)

    qi = iter(range(1, 10**9))
    warm = _timed(lambda: kb.retrieve(f"q:{next(qi)}", args.k), args.queries)
    agree = _agreement_ids(kb, args.k)
    kb.close()
    return {
        "system": f"reference svs {svs.__version__}",
        "open_s": open_s,
        "cold_first_query_s": cold_s,
        "warm_query": warm,
        "batch": None,
        "agreement_ids": agree,
    }


def run_svs(args: argparse.Namespace) -> dict:
    from benchmarks.corpus import ensure_bench_kb, query_embedder

    import svs_tpu

    path = ensure_bench_kb(args.n, args.dim)
    embed = query_embedder(args.dim)

    t0 = time.perf_counter()
    kb = svs_tpu.KB(str(path), embedding_func=embed, sidecar=True)
    open_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    hits = kb.retrieve("q:0", args.k)
    cold_s = time.perf_counter() - t0
    assert len(hits) == args.k, len(hits)

    qi = iter(range(1, 10**9))
    # Transitional window: the f32 rescore mirror may still be uploading
    # in the background (it yields the device link to these queries, but
    # contends between them) — time it as its own phase.
    transitional = _timed(
        lambda: kb.retrieve(f"q:{next(qi)}", args.k), args.queries
    )

    # Steady state: wait for the background mirror upload to finish
    # (idle time does this naturally in production), then re-time.
    t0 = time.perf_counter()
    kb.engine.wait_for_mirror()
    mirror_wait_s = time.perf_counter() - t0
    warm = _timed(lambda: kb.retrieve(f"q:{next(qi)}", args.k), args.queries)

    def one_batch() -> None:
        texts = [f"q:{next(qi)}" for _ in range(args.batch)]
        out = kb.retrieve_batch(texts, args.k)
        assert len(out) == args.batch

    one_batch()  # compile/warm the batched shape before timing
    batch = _timed(one_batch, max(3, args.queries // 4))
    batch["batch"] = args.batch
    batch["per_query_p50_s"] = batch["p50_s"] / args.batch

    sidecar_used = Path(f"{path}.svsx").exists()
    agree = _agreement_ids(kb, args.k)
    stats = kb.stats()
    kb.close()
    return {
        "system": f"svs_tpu {svs_tpu.__version__}",
        "open_s": open_s,
        "cold_first_query_s": cold_s,
        "cold_start_via_sidecar": sidecar_used,
        "transitional_query": transitional,
        "mirror_wait_s": mirror_wait_s,
        "warm_query": warm,
        "batch": batch,
        "agreement_ids": agree,
        # which engine answered the solo warm queries: the automatic
        # host-path dispatch serves small corpora from the host f32
        # cache when the device RPC floor exceeds the scan cost
        # (``RetrievalEngine.host_route``)
        "host_search_count": stats.get("host_search", {}).get("count", 0),
        "device_search_count": (
            stats.get("device_search", {}).get("count", 0)
        ),
    }


def _fmt_s(s: float) -> str:
    return f"{s * 1000:.1f} ms" if s < 1 else f"{s:.2f} s"


def _fmt_ratio(r: float) -> str:
    """Reference-time / svs-time: >1 means svs_tpu is faster."""
    if r >= 10:
        return f"{r:,.0f}x faster"
    if r >= 1:
        return f"{r:.1f}x faster"
    return f"{1 / r:.1f}x slower"


def run_both(args: argparse.Namespace) -> int:
    # Build the corpus BEFORE timing anyone, and make sure the packed
    # sidecar exists so svs_tpu's cold number measures the publish-time
    # consumer flow (reference consumers have no analog — their cold
    # start is always the full BLOB scan).
    from benchmarks.corpus import ensure_bench_kb

    path = ensure_bench_kb(args.n, args.dim)
    if not Path(f"{path}.svsx").exists():
        print("[head-to-head] writing sidecar (one-time) ...",
              file=sys.stderr, flush=True)
        code = (
            "import sys; sys.path.insert(0, sys.argv[1]);"
            "from benchmarks.corpus import query_embedder;"
            "from svs_tpu import KB;"
            "kb = KB(sys.argv[2], query_embedder(int(sys.argv[3])),"
            " sidecar=True); kb.load(); kb.close(write_sidecar=True)"
        )
        subprocess.run(
            [sys.executable, "-c", code,
             str(Path(__file__).resolve().parent.parent),
             str(path), str(args.dim)],
            check=True,
        )
    results = {}
    for system in ("svs", "ref"):
        cmd = [
            sys.executable, __file__, "--system", system,
            "--n", str(args.n), "--dim", str(args.dim),
            "--k", str(args.k), "--queries", str(args.queries),
            "--batch", str(args.batch),
        ]
        print(f"[head-to-head] running {system} ...", file=sys.stderr,
              flush=True)
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True)
        if proc.returncode != 0:
            print(f"[head-to-head] {system} failed", file=sys.stderr)
            return proc.returncode
        results[system] = json.loads(proc.stdout.splitlines()[-1])

    ref, svs = results["ref"], results["svs"]
    if ref["agreement_ids"] != svs["agreement_ids"]:
        print("[head-to-head] EXACTNESS DISAGREEMENT between systems:",
              file=sys.stderr)
        print(json.dumps({"ref": ref["agreement_ids"],
                          "svs": svs["agreement_ids"]}), file=sys.stderr)
        return 1
    rw, tw = ref["warm_query"]["p50_s"], svs["warm_query"]["p50_s"]
    pq = svs["batch"]["per_query_p50_s"]
    print(f"\n## Same-host head-to-head — {args.n:,} docs x {args.dim}, "
          f"top-{args.k}\n")
    print("| metric | reference (this host) | svs_tpu (this host + "
          "its device) | svs_tpu is |")
    print("|---|---|---|---|")
    print(f"| cold first query | {_fmt_s(ref['cold_first_query_s'])} | "
          f"{_fmt_s(svs['cold_first_query_s'])} | "
          f"{_fmt_ratio(ref['cold_first_query_s'] / svs['cold_first_query_s'])} |")
    tq = svs.get("transitional_query")
    if tq:
        print(f"| query p50 during background mirror upload "
              f"({_fmt_s(svs.get('mirror_wait_s', 0))} to finish) | — | "
              f"{_fmt_s(tq['p50_s'])} | {_fmt_ratio(rw / tq['p50_s'])} |")
    print(f"| warm query p50 (solo) | {_fmt_s(rw)} | {_fmt_s(tw)} | "
          f"{_fmt_ratio(rw / tw)} |")
    print(f"| warm per-query, batch={args.batch} | — | {_fmt_s(pq)} | "
          f"{_fmt_ratio(rw / pq)} |")
    print(json.dumps({"ref": ref, "svs": svs}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--system", choices=("ref", "svs", "both"),
                    default="both")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=1536)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--queries", type=int, default=12)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()
    if args.system == "both":
        return run_both(args)
    result = run_ref(args) if args.system == "ref" else run_svs(args)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
