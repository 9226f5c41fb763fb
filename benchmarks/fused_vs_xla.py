"""The fused GPU kernel (``ops.fused_topk``) against the plain XLA path.

Two measurements, each in turns (xla, fused, fused, xla, ...) inside
one process so both sides see the same card and clocks:

- ``--mode kernel``: the prescore step alone (``fused_topk_packed`` vs
  ``score_topk_packed`` / ``score_topk_int8_packed``) over a corpus
  synthesized on the device, per precision and batch, with a check that
  both return the same rows;
- ``--mode e2e``: ``KB.retrieve_batch`` through a real on-disk KB
  (``benchmarks/corpus.py``), one KB per route (``kernel='auto'`` vs
  ``kernel='xla'``), per precision and batch.  Each round is two
  alternating pairs, so ``--rounds R`` gives 2R samples per side, each
  the median of ``--reps`` calls.  Below ``FUSED_MIN_BATCH`` both KBs
  take the same XLA route: that batch is a control for the noise.

``--sweep`` adds kernel tile configurations (block_n, num_warps,
num_stages) to the kernel mode.  Prints one JSON line per measurement
and the card's name and power limit first.

Run:  python benchmarks/fused_vs_xla.py --mode kernel [--n 1000000]
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "unknown"


def _timed(fn, reps: int) -> float:
    """Median seconds per call of ``fn`` (which blocks until ready)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def kernel_mode(args: argparse.Namespace) -> None:
    import jax
    import jax.numpy as jnp

    from svs_tpu.ops import fused_topk as ft
    from svs_tpu.ops.quant import quantize_rows_int8, score_topk_int8_packed
    from svs_tpu.ops.topk import score_topk_packed, unpack_vals_idx

    n, d = args.n, args.dim
    n_pad = -(-n // ft.BLOCK_N) * ft.BLOCK_N
    key = jax.random.PRNGKey(args.seed)

    @functools.partial(jax.jit, static_argnums=(1,))
    def synth(key, rows):
        x = jax.random.normal(key, (rows, d), jnp.float32)
        return x / jnp.linalg.norm(x, axis=1, keepdims=True)

    chunk = 65536
    parts = []
    for i, s in enumerate(range(0, n_pad, chunk)):
        rows = min(chunk, n_pad - s)
        parts.append(synth(jax.random.fold_in(key, i), rows).astype(jnp.bfloat16))
    base = jnp.concatenate(parts)  # bf16 [n_pad, d]
    del parts
    nv = jnp.int32(n)
    c = max(4 * args.k, args.k + 32)  # the engine's candidate count
    for precision in args.precisions.split(","):
        if precision == "int8":
            docs, scales = jax.jit(quantize_rows_int8)(base)
        elif precision == "bf16":
            docs, scales = base, None
        else:
            sys.exit(f"the fused kernel takes bf16 or int8, not {precision}")
        for b in [int(x) for x in args.batches.split(",")]:
            q = synth(jax.random.fold_in(key, 10_000 + b), b)
            if scales is not None:
                xla = jax.jit(functools.partial(score_topk_int8_packed, k=c))
                run_xla = lambda: xla(docs, scales, q, nv).block_until_ready()
            else:
                xla = jax.jit(functools.partial(score_topk_packed, k=c))
                run_xla = lambda: xla(docs, q, nv).block_until_ready()
            configs = [(ft.BLOCK_N, ft.NUM_WARPS, ft.NUM_STAGES)]
            if args.sweep:
                configs += [
                    (bn, w, st)
                    for bn in (128, 256)
                    for w in (4, 8)
                    for st in (2, 3)
                    if (bn, w, st) != (ft.BLOCK_N, ft.NUM_WARPS, ft.NUM_STAGES)
                ]
            t0 = time.perf_counter()
            xla_args = (docs, scales, q, nv) if scales is not None else (
                docs, q, nv
            )
            want = np.asarray(xla(*xla_args))
            compile_xla = time.perf_counter() - t0
            print(json.dumps({
                "mode": "lowering", "precision": precision, "b": b,
                "xla": _compiled_facts(xla, xla_args),
                "fused": _compiled_facts(
                    _fused_fn(ft, c, ft.BLOCK_N, ft.NUM_WARPS, ft.NUM_STAGES),
                    (docs, q, nv, scales),
                ),
            }), flush=True)
            for block_n, warps, stages in configs:
                fused = _fused_fn(ft, c, block_n, warps, stages)
                run_fused = lambda: fused(docs, q, nv, scales).block_until_ready()
                t0 = time.perf_counter()
                try:
                    got = np.asarray(fused(docs, q, nv, scales))
                except Exception as exc:  # report and go on with the sweep
                    print(json.dumps({
                        "mode": "kernel", "precision": precision, "b": b,
                        "block_n": block_n, "num_warps": warps,
                        "num_stages": stages,
                        "error": f"{type(exc).__name__}: {str(exc)[:300]}",
                    }), flush=True)
                    if (block_n, warps, stages) == configs[0]:
                        raise
                    continue
                compile_fused = time.perf_counter() - t0
                gv, gi = unpack_vals_idx(got, c)
                wv, wi = unpack_vals_idx(want, c)
                same_rows = float(np.mean([
                    len(set(gi[r]) & set(wi[r])) / c for r in range(b)
                ]))
                max_dv = float(np.abs(gv - wv).max())
                for _ in range(2):  # warm both
                    run_xla(); run_fused()
                t_x, t_f = [], []
                for _ in range(args.rounds):
                    t_x.append(_timed(run_xla, args.reps))
                    t_f.append(_timed(run_fused, args.reps))
                    t_f.append(_timed(run_fused, args.reps))
                    t_x.append(_timed(run_xla, args.reps))
                print(json.dumps({
                    "mode": "kernel", "precision": precision, "b": b,
                    "n": n, "d": d, "c": c,
                    "block_n": block_n, "num_warps": warps,
                    "num_stages": stages,
                    "xla_ms": round(statistics.median(t_x) * 1e3, 4),
                    "fused_ms": round(statistics.median(t_f) * 1e3, 4),
                    "xla_ms_all": [round(t * 1e3, 4) for t in t_x],
                    "fused_ms_all": [round(t * 1e3, 4) for t in t_f],
                    "compile_s": [round(compile_xla, 2),
                                  round(compile_fused, 2)],
                    "row_overlap": round(same_rows, 6),
                    "max_abs_dval": max_dv,
                }), flush=True)


def _compiled_facts(fn, args) -> dict:
    """What XLA made of ``fn``: the library and kernel calls it emits
    (cuBLAS GEMMs, Triton kernels) and its memory footprint."""
    import re

    compiled = fn.lower(*args).compile()
    text = compiled.as_text()
    mem = compiled.memory_analysis()
    return {
        "custom_calls": sorted(set(
            re.findall(r'custom_call_target="([^"]+)"', text)
        )),
        "fusions": len(re.findall(r"\bfusion\(", text)),
        "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
        "output_bytes": getattr(mem, "output_size_in_bytes", None),
    }


def _fused_fn(ft, c, block_n, warps, stages):
    """``fused_topk_packed`` with a chosen tile configuration."""
    import jax
    import jax.numpy as jnp

    from svs_tpu.ops.quant import quantize_rows_int8
    from svs_tpu.ops.topk import pack_vals_idx

    if (block_n, warps, stages) == (ft.BLOCK_N, ft.NUM_WARPS, ft.NUM_STAGES):
        @jax.jit
        def run(docs, q, nv, scales):
            return ft.fused_topk_packed(docs, q, nv, c, row_scales=scales)

        return run

    @jax.jit
    def run(docs, q, nv, scales):
        b, d = q.shape
        bq = ft.block_q_for(b)
        bp = -(-b // bq) * bq
        qp = jnp.concatenate([q, jnp.zeros((bp - b, d), q.dtype)]) if bp != b else q
        if scales is not None:
            qi, qs = quantize_rows_int8(qp)
            ev, ei = ft.tile_candidates(
                docs, qi, nv, scales, qs, block_n=block_n,
                num_warps=warps, num_stages=stages,
            )
        else:
            ev, ei = ft.tile_candidates(
                docs, qp.astype(docs.dtype), nv, block_n=block_n,
                num_warps=warps, num_stages=stages,
            )
        vals, pos = jax.lax.top_k(ev[:b], c)
        return pack_vals_idx(vals, jnp.take_along_axis(ei[:b], pos, axis=1))

    return run


def e2e_mode(args: argparse.Namespace) -> None:
    from corpus import ensure_bench_kb, query_embedder

    from svs_tpu import KB

    path = ensure_bench_kb(args.n, args.dim, seed=args.seed)
    batches = [int(x) for x in args.batches.split(",")]
    for precision in args.precisions.split(","):
        kbs = {
            route: KB(path, query_embedder(args.dim, args.seed),
                      precision=precision, kernel=route)
            for route in ("xla", "auto")
        }
        try:
            for kb in kbs.values():
                kb.load()
                kb.engine.wait_for_mirror(900)
            for b in batches:
                texts = [f"q:{i}" for i in range(b)]
                out = {}
                for route, kb in kbs.items():
                    for _ in range(3):  # compile + widen hints settle
                        out[route] = kb.retrieve_batch(texts, args.k)
                same = all(
                    [h["doc"]["id"] for h in x] == [h["doc"]["id"] for h in y]
                    for x, y in zip(out["xla"], out["auto"])
                )
                t = {"xla": [], "auto": []}
                for _ in range(args.rounds):
                    for route in ("xla", "auto", "auto", "xla"):
                        kb = kbs[route]
                        t[route].append(_timed(
                            lambda: kb.retrieve_batch(texts, args.k), args.reps
                        ))
                print(json.dumps({
                    "mode": "e2e", "precision": precision, "b": b,
                    "n": args.n, "d": args.dim, "k": args.k,
                    "xla_ms": round(statistics.median(t["xla"]) * 1e3, 3),
                    "fused_ms": round(statistics.median(t["auto"]) * 1e3, 3),
                    "xla_ms_all": [round(x * 1e3, 3) for x in t["xla"]],
                    "fused_ms_all": [round(x * 1e3, 3) for x in t["auto"]],
                    "fused_dispatched": kbs["auto"].engine._fused_route(
                        kbs["auto"]._ensure_engine_fresh(), b,
                        kbs["auto"].engine.candidate_count(args.k),
                    ),
                    "same_results": same,
                }), flush=True)
        finally:
            for kb in kbs.values():
                kb.close(write_sidecar=None)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", choices=["kernel", "e2e"], default="kernel")
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--dim", type=int, default=1536)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--batches", default="1,256")
    p.add_argument("--precisions", default="int8,bf16")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--sweep", action="store_true")
    args = p.parse_args()
    print(f"card: {card()}", flush=True)
    import jax

    dev = jax.devices()[0]
    print(json.dumps({"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}), flush=True)
    if dev.platform != "gpu":
        sys.exit("fused_vs_xla measures the GPU kernel: no GPU found")
    if args.mode == "kernel":
        kernel_mode(args)
    else:
        e2e_mode(args)


if __name__ == "__main__":
    main()
