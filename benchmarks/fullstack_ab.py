"""A/B the full-stack retrieve_batch pipeline: bf16 vs int8 storage.

Both configurations run the SAME verified-exact pipeline (device
prescore -> on-device f32 rescore of the candidate set -> margin proof
-> final tie-rule selection -> hydration); the only difference is the
storage precision of the prescore pack.  Exact f32 scores come out of
both — this measures what a `precision='auto'` dispatch should pick.

Per precision, at 1M x 1536 k=100:
  - b=256 sequential p50 over 6 reps + per-stage p50s
  - b=1 latency p50 over 20 reps
  - widen-retry count (kb.stats() searches vs batches)

The bf16 sidecar is saved/restored around the int8 run so the cached
benchmark corpus keeps its bf16 sidecar for later runs.

Run:  python benchmarks/fullstack_ab.py [n_docs]
"""
import asyncio
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def main() -> None:
    from corpus import ensure_bench_kb, query_embedder
    from svs_tpu import AsyncKB
    from svs_tpu.engine.sidecar import sidecar_path_for

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    dim, B, K = 1536, 256, 100
    path = ensure_bench_kb(n, dim)
    scar = sidecar_path_for(path)
    results = {}

    for precision in ("bf16", "int8"):
        kb = AsyncKB(path, query_embedder(dim), precision=precision,
                     sidecar=True)

        async def run() -> dict:
            t0 = time.perf_counter()
            await kb.load()
            open_s = time.perf_counter() - t0

            async def batch(r: int, b: int):
                qs = [f"q:{r * b + i}" for i in range(b)]
                return await kb.retrieve_batch(qs, K)

            for w in range(2):  # warm: compile + width hints
                await batch(w, B)

            seq = []
            for r in range(6):
                t0 = time.perf_counter()
                out = await batch(100 + r, B)
                seq.append(time.perf_counter() - t0)
                assert len(out) == B and len(out[0]) == K

            solo = []
            for r in range(22):
                t0 = time.perf_counter()
                await batch(1000 + r, 1)
                solo.append(time.perf_counter() - t0)
            solo = solo[2:]  # first solos pay their own compile

            stats = kb.stats()
            await kb.close()
            return {
                "open_s": round(open_s, 1),
                "b256_p50_ms": round(sorted(seq)[len(seq) // 2] * 1e3, 1),
                "b256_spread_ms": [round(min(seq) * 1e3, 1),
                                   round(max(seq) * 1e3, 1)],
                "b1_p50_ms": round(sorted(solo)[len(solo) // 2] * 1e3, 1),
                "b1_min_ms": round(min(solo) * 1e3, 1),
                "stages": {
                    name: round(st.get("p50_s", 0) * 1e3, 1)
                    for name, st in sorted(stats.items())
                    if isinstance(st, dict)
                },
                "pack_events": stats.get("pack_events"),
            }

        print(f"\n=== precision={precision} ===", flush=True)
        results[precision] = asyncio.run(run())
        for k_, v in results[precision].items():
            print(f"  {k_:18s} {v}", flush=True)
        if precision == "bf16" and scar.exists():
            shutil.copy2(scar, f"{scar}.bf16.bak")

    # restore the bf16 sidecar so later default-precision runs cold-start
    bak = Path(f"{scar}.bf16.bak")
    if bak.exists():
        bak.replace(scar)
        print("\n(bf16 sidecar restored)", flush=True)

    b, i = results["bf16"], results["int8"]
    print(f"\nb=256/query: bf16 {b['b256_p50_ms'] / B:.3f} ms  "
          f"int8 {i['b256_p50_ms'] / B:.3f} ms  "
          f"({b['b256_p50_ms'] / max(i['b256_p50_ms'], 1e-9):.2f}x)",
          flush=True)
    print(f"b=1 latency: bf16 {b['b1_p50_ms']:.1f} ms  "
          f"int8 {i['b1_p50_ms']:.1f} ms  "
          f"({b['b1_p50_ms'] / max(i['b1_p50_ms'], 1e-9):.2f}x)", flush=True)


if __name__ == "__main__":
    main()
