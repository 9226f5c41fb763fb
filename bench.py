"""Benchmark harness: reproduces the reference's headline configuration
(1M docs x 1536 dims, exact cosine top-100; BASELINE.md) on the current
JAX device and prints ONE JSON line to stdout:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

``vs_baseline`` is the speedup over the reference's published warm-query
number on the same configuration (0.24 s at 1M x 1536,
``/root/reference/README.md:129``); >1 means faster than the reference.

The default ``--precision auto`` measures the engine's actual default
dispatch: int8 prescore kernels under the verified exact f32 rescore.
On the headline preset it additionally records a bf16 batched row (the
same data the engine's ``precision='bf16'`` mode runs) so both headline
kernels are captured in one run.

Reported timings (details on stderr):

- ``p50``/``p99``: one prescore step (the engine's
  ``_prescore_dispatch``) from dispatch to host fetch — not a whole
  ``KB.retrieve``: no embedding, rescore or hydration (``--full-stack``
  measures those);
- ``device``: isolated device time, measured by chaining N dependent
  iterations inside one jit and fetching once (slope between two chain
  lengths removes dispatch/fetch overhead);
- ``kernel``: which prescore path the engine dispatched (``fused`` =
  the GPU kernel in ``ops.fused_topk``, ``xla`` = XLA matmul + top-k).
  Exact exhaustive search must read the whole corpus per step, so device
  memory bandwidth sets the physical floor; batching amortizes it.

Resilience contract (the driver parses stdout): this script ALWAYS emits
one JSON line.  Corpus materialization is chunked into preallocated
donated buffers (peak HBM = corpus + ~200 MB, not a 6 GB f32
intermediate); on RESOURCE_EXHAUSTED it drops buffers, clears jit
caches, backs off and retries; if the headline shape still will not fit
it degrades the corpus size and marks the result ``"degraded": true``;
any other error produces a parsed error line, and a watchdog converts a
wedged device link into a parsed timeout line.

Timing is fetch-based (``np.asarray``): the host holds the result when
the clock stops.

Usage:
    python bench.py                  # headline: 1M x 1536, engine default
    python bench.py --preset smoke   # tiny CPU-safe sanity run
    python bench.py --batch 256      # batched-throughput variant
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import sys
import time

import numpy as np


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def _arm_watchdog(seconds: float, preset: str) -> None:
    """Guarantee ONE JSON line on stdout even if the device link wedges.

    A device fetch over a stalled link can block indefinitely (no
    exception, no timeout anywhere in the stack), which would hang the
    harness that invokes this script.  A daemon timer prints a machine-readable failure line and
    hard-exits instead.  Generous default (45 min vs ~10 min for a cold
    headline run): a legitimate run never gets close.  Override/disable
    via SVS_TPU_BENCH_TIMEOUT (seconds; 0 disables)."""
    import os
    import threading

    def fire() -> None:
        print(
            json.dumps(
                {
                    "metric": "bench aborted by watchdog: no result "
                    f"within {seconds:.0f}s (device link stalled?)",
                    "value": None,
                    "unit": "timeout",
                    "vs_baseline": None,
                    "error": "watchdog_timeout",
                    "preset": preset,
                }
            ),
            flush=True,
        )
        os._exit(2)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()


# Reference warm-query latencies (seconds) for the two corpus sizes it
# published (BASELINE.md).
REF_WARM_1M_S = 0.240
REF_WARM_10K_S = 0.011

PRESETS = {
    # name: (n_docs, dim, k, ref_seconds)
    "headline": (1_000_000, 1536, 100, REF_WARM_1M_S),
    "dadjokes": (10_548, 1536, 100, REF_WARM_10K_S),
    "smoke": (10_000, 256, 10, None),
}

# If the headline corpus will not fit (shared chip, other tenants
# holding HBM), shrink rather than die.  The reference's warm query is a
# linear exact scan, so its latency scales ~linearly with corpus size —
# the scaled ref numbers keep vs_baseline fair and are marked as scaled.
HEADLINE_DEGRADE_CHAIN = [1_000_000, 500_000, 250_000, 100_000]

def _percentile(values, q):
    values = sorted(values)
    idx = min(len(values) - 1, int(round(q * (len(values) - 1))))
    return values[idx]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--preset", choices=PRESETS, default="headline")
    parser.add_argument("--precision", choices=["auto", "f32", "bf16", "int8"],
                        default="auto",
                        help="'auto' = the engine's default dispatch: int8 "
                        "prescore kernels (device phases) + the verified "
                        "exact f32 rescore (full-stack phase); on the "
                        "headline preset a bf16 batched row is also recorded")
    parser.add_argument("--batch", type=int, default=1,
                        help="queries per retrieval step")
    parser.add_argument(
        "--batched-phase", type=int, default=None,
        help="additionally measure this batch size on the same corpus and "
        "report it under 'batched' (default: 256 for the 1M presets when "
        "--batch is 1; 0 disables)",
    )
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument(
        "--full-stack", type=int, choices=(0, 1), default=None,
        help="measure end-to-end retrieve_batch through a real on-disk KB "
        "(default: on for the headline preset on an accelerator)",
    )
    parser.add_argument("--k", type=int, default=None)
    parser.add_argument("--chain", type=int, default=6,
                        help="chained iterations for device-time isolation "
                        "(min 2: device time is the slope between chain "
                        "lengths)")
    args = parser.parse_args()
    args.chain = max(2, args.chain)

    import os

    wd = float(os.environ.get("SVS_TPU_BENCH_TIMEOUT", "2700"))
    if wd > 0:
        _arm_watchdog(wd, args.preset)

    import jax
    import jax.numpy as jnp

    from svs_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()  # repeat runs reuse kernel binaries

    from svs_tpu.engine.index import RetrievalEngine
    from svs_tpu.engine.packing import PackedCorpus, ROW_MULTIPLE
    from svs_tpu.ops.topk import unpack_vals_idx

    preset_n, dim, k_default, _preset_ref = PRESETS[args.preset]
    k = args.k or k_default
    dev = jax.devices()[0]
    on_cpu = jax.default_backend() == "cpu"

    # 'auto' is the engine's default dispatch: int8 prescore storage under
    # the verified exact f32 rescore (see RetrievalEngine).  Device phases
    # here measure the int8 prescore kernels; the full-stack phase passes
    # 'auto' through to the real KB, which includes the rescore chain.
    precision_label = args.precision
    device_precision = "int8" if args.precision == "auto" else args.precision

    def run_sized(n: int, ref_s, degraded: bool) -> dict:
        """One full bench at corpus size ``n``; raises on unrecoverable
        device errors (the degrade chain in the caller handles those)."""
        # Padding mirrors the engine's row multiple.
        row_multiple = ROW_MULTIPLE
        n_pad = ((n + row_multiple - 1) // row_multiple) * row_multiple
        log(f"device: {dev} | corpus {n}x{dim} {precision_label} "
            f"(padded {n_pad}) | top-{k} | batch {args.batch}"
            + (" | DEGRADED" if degraded else ""))

        n_valid = jnp.int32(n)

        # ---- corpus materialization (chunked, OOM-resilient) ----

        def _pick_chunk(n_rows: int, multiple: int,
                        target: int = 65536) -> int:
            """Largest power-of-two multiple of ``multiple`` that divides
            ``n_rows`` and stays <= ``target`` rows (so the f32 synth
            intermediate is ~200 MB, not ~6 GB)."""
            best = multiple
            m = multiple
            while m <= target:
                if n_rows % m == 0:
                    best = m
                m *= 2
            return best

        chunk = _pick_chunk(n_pad, row_multiple)

        def _synth_chunk(start):
            # Hash-style pseudo-random rows (decorrelated: a plain sin
            # over the row index produces lockstep near-duplicate rows —
            # unrealistic and adversarial for tile-sparse selection).
            # ``start`` is a traced scalar: every chunk shares one
            # compiled program.
            r = jax.lax.broadcasted_iota(jnp.float32, (chunk, dim), 0)
            r = r + start.astype(jnp.float32)
            c = jax.lax.broadcasted_iota(jnp.float32, (chunk, dim), 1)
            x = jnp.sin(r * 12.9898 + c * 78.233) * 43758.5453
            x = x - jnp.floor(x) - 0.5
            return x / jnp.sqrt(jnp.sum(x * x, axis=1, keepdims=True))

        def _quant_chunk(x):
            absmax = jnp.max(jnp.abs(x), axis=1)
            scales = jnp.maximum(absmax, 1e-12) / 127.0
            q = jnp.clip(
                jnp.round(x / scales[:, None]), -127, 127
            ).astype(jnp.int8)
            return q, scales

        def materialize(precision: str):
            """Build the on-device corpus chunk-by-chunk into
            preallocated buffers (donated each step, so peak HBM =
            final corpus + one ~200 MB chunk — the round-3 bench OOM'd
            because it materialized a full [n_pad, dim] f32
            intermediate, ~6.2 GB, on a shared 16 GB chip)."""
            if precision == "int8":
                @functools.partial(jax.jit, donate_argnums=(0, 1))
                def fill_q(qbuf, sbuf, start):
                    q, s = _quant_chunk(_synth_chunk(start))
                    return (
                        jax.lax.dynamic_update_slice(qbuf, q, (start, 0)),
                        jax.lax.dynamic_update_slice(sbuf, s, (start,)),
                    )

                qbuf = jnp.zeros((n_pad, dim), jnp.int8)
                sbuf = jnp.zeros((n_pad,), jnp.float32)
                for s in range(0, n_pad, chunk):
                    qbuf, sbuf = fill_q(qbuf, sbuf, jnp.int32(s))
                _ = np.asarray(qbuf[0, :1])  # force materialization
                return qbuf, sbuf

            dtype = jnp.bfloat16 if precision != "f32" else jnp.float32

            @functools.partial(jax.jit, donate_argnums=(0,))
            def fill(buf, start):
                x = _synth_chunk(start).astype(dtype)
                return jax.lax.dynamic_update_slice(buf, x, (start, 0))

            buf = jnp.zeros((n_pad, dim), dtype)
            for s in range(0, n_pad, chunk):
                buf = fill(buf, jnp.int32(s))
            _ = np.asarray(buf[0, :1])
            return buf, None

        def quantize_from(docs_any):
            """Chunked bf16 -> int8 requantization of an existing
            on-device corpus (reads slices; never materializes a full
            f32 copy)."""
            @functools.partial(jax.jit, donate_argnums=(1, 2))
            def fill_q(src, qbuf, sbuf, start):
                x = jax.lax.dynamic_slice(
                    src, (start, 0), (chunk, dim)
                ).astype(jnp.float32)
                q, s = _quant_chunk(x)
                return (
                    jax.lax.dynamic_update_slice(qbuf, q, (start, 0)),
                    jax.lax.dynamic_update_slice(sbuf, s, (start,)),
                )

            qbuf = jnp.zeros((n_pad, dim), jnp.int8)
            sbuf = jnp.zeros((n_pad,), jnp.float32)
            for s in range(0, n_pad, chunk):
                qbuf, sbuf = fill_q(docs_any, qbuf, sbuf, jnp.int32(s))
            _ = np.asarray(qbuf[0, :1])
            return qbuf, sbuf

        def with_retries(fn):
            """The first materialization moves GBs on a shared device —
            long enough to hit transient link errors
            (FAILED_PRECONDITION mid-fetch) or RESOURCE_EXHAUSTED if
            another process holds device memory.  On failure: drop every reference
            (a failed fetch can leave the buffer poisoned), clear jit
            caches, back off, retry.  Raises after the last attempt —
            the caller's degrade chain takes over."""
            for attempt in range(4):
                try:
                    return fn()
                except Exception as exc:
                    gc.collect()
                    jax.clear_caches()
                    if attempt == 3:
                        raise
                    delay = 5.0 * (attempt + 1)
                    log(f"corpus materialization failed ({exc}); "
                        f"cleared caches, retrying in {delay:.0f}s")
                    time.sleep(delay)

        # ---- measurement ----

        def measure(batch: int, iters: int, precision: str,
                    docs, row_scales) -> dict:
            """One full measurement (compile, step p50/p99, isolated
            device time, utilization) at the given batch size over the
            given on-device corpus."""
            engine = RetrievalEngine(precision=precision)
            emb_ids = np.arange(1, n + 1, dtype=np.int64)

            # unit-norm queries: scores are genuine cosines in [-1, 1],
            # the domain the engine guarantees (magnitude guard at
            # insert+query)
            def unit_q(i):
                v = jax.random.normal(
                    jax.random.PRNGKey(100 + i), (batch, dim),
                    dtype=jnp.float32,
                )
                return v / jnp.linalg.norm(v, axis=1, keepdims=True)

            queries = [jax.jit(unit_q)(i) for i in range(8)]

            # The corpus is an explicit argument (NOT a closure
            # capture): captured device constants get embedded in the
            # lowered program.  The step is the engine's own prescore
            # dispatch over a pack of these arrays.
            def pack_of(corpus, scales):
                return PackedCorpus(
                    data=corpus, row_scales=scales, emb_ids=emb_ids,
                    n_valid=n, dim=dim, version=0, precision=precision,
                )

            def step_fn(corpus, scales, q, nvv):
                return engine._prescore_dispatch(
                    pack_of(corpus, scales), q, nvv, k
                )

            phase_kernel = (
                "fused"
                if engine._fused_route(pack_of(docs, row_scales), batch, k)
                else "xla"
            )
            step = jax.jit(step_fn)

            # warmup / compile
            t0 = time.perf_counter()
            _ = np.asarray(step(docs, row_scales, queries[0], n_valid))
            log(f"[{precision} batch {batch}] compile+first query: "
                f"{time.perf_counter() - t0:.2f}s (kernel {phase_kernel})")

            # step: each iteration is one prescore dispatch -> host-visible result
            times = []
            for i in range(iters):
                t0 = time.perf_counter()
                packed = np.asarray(
                    step(docs, row_scales, queries[i % len(queries)], n_valid)
                )
                times.append(time.perf_counter() - t0)
            vals, idx = unpack_vals_idx(packed, k)
            assert (idx >= 0).all() and (idx < n).all(), \
                "padding leaked into top-k"
            assert len(np.unique(idx[0])) == k, "duplicate/corrupted indices"

            p50 = _percentile(times, 0.50)
            p99 = _percentile(times, 0.99)

            # device time: chained iterations, fetch once
            def chained(length):
                @jax.jit
                def run(corpus, scales, q, nvv):
                    def body(i, qc):
                        out = step_fn(corpus, scales, qc, nvv)
                        return qc + 0.0 * out[0, 0].astype(qc.dtype)

                    qf = jax.lax.fori_loop(0, length, body, q)
                    return step_fn(corpus, scales, qf, nvv)

                return run

            short, long_ = chained(1), chained(args.chain)
            np.asarray(short(docs, row_scales, queries[0], n_valid))
            np.asarray(long_(docs, row_scales, queries[0], n_valid))
            # Run-to-run spread, reported honestly (median + min..max
            # over independent chained measurements) instead of quoting
            # the single best pair — see BASELINE.md "scoreboard
            # honesty".
            device_runs = []
            for _ in range(5):
                t0 = time.perf_counter()
                np.asarray(short(docs, row_scales, queries[0], n_valid))
                ts_i = time.perf_counter() - t0
                t0 = time.perf_counter()
                np.asarray(long_(docs, row_scales, queries[0], n_valid))
                tl_i = time.perf_counter() - t0
                device_runs.append(
                    max(0.0, (tl_i - ts_i) / (args.chain - 1))
                )
            device_s = _percentile(device_runs, 0.50)
            device_spread = (min(device_runs), max(device_runs))

            per_query_step = p50 / batch
            per_query_dev = device_s / batch if device_s else None
            log(f"[{precision} batch {batch}] step p50 {p50 * 1e3:.3f} ms | "
                f"p99 {p99 * 1e3:.3f} ms | per-query "
                f"{per_query_step * 1e3:.4f} ms | QPS {batch / p50:,.0f}")
            log(f"[{precision} batch {batch}] device "
                f"{device_s * 1e3:.3f} ms/step "
                f"(spread {device_spread[0] * 1e3:.3f}-"
                f"{device_spread[1] * 1e3:.3f}) | "
                f"per-query {device_s / batch * 1e3:.4f} ms")
            return {
                "batch": batch,
                "precision": precision,
                "p50_ms": round(p50 * 1e3, 4),
                "p99_ms": round(p99 * 1e3, 4),
                "per_query_ms": round(per_query_step * 1e3, 4),
                "qps": round(batch / p50, 1),
                "vs_baseline": (
                    round(ref_s / per_query_step, 1) if ref_s else None
                ),
                "device_ms": round(device_s * 1e3, 4),
                "device_ms_spread": [
                    round(device_spread[0] * 1e3, 4),
                    round(device_spread[1] * 1e3, 4),
                ],
                "device_per_query_ms": (
                    round(per_query_dev * 1e3, 4) if per_query_dev else None
                ),
                "device_vs_baseline": (
                    round(ref_s / per_query_dev, 1)
                    if (ref_s and per_query_dev) else None
                ),
                "kernel": phase_kernel,
            }

        def measure_full_stack(batch: int, k: int) -> dict:
            """End-to-end through the REAL KB: embed -> device search ->
            verified f32 rescore -> hydration, against an on-disk store
            (the kernel phases above synthesize their corpus on-device
            and skip the host side entirely — which round 2 showed is
            where end-to-end throughput actually goes).

            Reports BOTH sequential latency (await each batch) and
            pipelined throughput (batches in flight: batch r+1's device
            phase overlaps batch r's host finalize — the micro-batching
            server's natural operating mode)."""
            import asyncio
            from pathlib import Path

            sys.path.insert(0, str(Path(__file__).parent / "benchmarks"))
            from corpus import ensure_bench_kb, query_embedder

            from svs_tpu import AsyncKB

            path = ensure_bench_kb(n, dim)

            async def run() -> dict:
                t0 = time.perf_counter()
                kb = AsyncKB(
                    path, query_embedder(dim),
                    precision=(
                        "auto" if precision_label == "auto"
                        else device_precision
                        if device_precision != "f32" else "bf16"
                    ),
                    sidecar=True,
                )
                await kb.load()
                log(f"[full-stack] open+pack: "
                    f"{time.perf_counter() - t0:.1f}s")
                # Steady-state measurement: the background f32 rescore
                # mirror decides whether the rescore chain runs on-device
                # (compact wire) or falls back to host gathers (~630 MB
                # of candidate traffic per 256-batch at 1M x 1536).
                # Measuring mid-upload mixes the two regimes — and the
                # round-4 capture couldn't even SAY which regime it
                # measured.  wait_for_mirror now covers the whole chain
                # (pack upload -> cache rebuild -> mirror build); wait in
                # slices so stderr shows progress on slow links.
                t0 = time.perf_counter()
                import asyncio as _aio

                loop = _aio.get_running_loop()
                mirror_wait = float(
                    os.environ.get("SVS_TPU_BENCH_MIRROR_WAIT", "900")
                )
                ready = False
                while (elapsed := time.perf_counter() - t0) < mirror_wait:
                    ready = await loop.run_in_executor(
                        None,
                        lambda: kb.engine.wait_for_mirror(
                            timeout=min(60.0, mirror_wait - elapsed)
                        ),
                    )
                    if ready:
                        break
                    log(f"[full-stack] still waiting for steady state "
                        f"({elapsed:.0f}s: pack_uploading="
                        f"{kb.engine.pack_uploading} mirror_uploading="
                        f"{kb.engine.mirror_uploading})")
                log(f"[full-stack] steady state: "
                    f"{'ready' if ready else 'NOT ready (timed out)'} "
                    f"after {time.perf_counter() - t0:.1f}s")

                corpus = kb.engine.corpus
                dev_final = (
                    corpus is not None
                    and corpus.dev_rescore is not None
                    and corpus.dev_emb is not None
                )
                host_f32 = (
                    corpus.host_f32 if corpus is not None else None
                )
                if not dev_final and host_f32 is not None:
                    # Host-rescore regime: page-warm the mmap'd f32
                    # cache so the timed phase measures the regime, not
                    # first-touch disk paging of a 6 GB file.
                    t0 = time.perf_counter()
                    probe = np.zeros(host_f32.shape[1], dtype=np.float32)
                    _ = host_f32 @ probe
                    log(f"[full-stack] page-warmed host f32 cache "
                        f"({host_f32.nbytes / 1e9:.1f} GB) in "
                        f"{time.perf_counter() - t0:.1f}s")
                regime = {
                    "mirror_ready": bool(ready),
                    "device_final_pipeline": bool(dev_final),
                    "host_f32_present": host_f32 is not None,
                    "doc_cache_warm": bool(
                        getattr(kb._doc_cache, "_warm", False)
                    ),
                    "precision": (
                        corpus.precision if corpus is not None else None
                    ),
                }
                if not dev_final and host_f32 is not None:
                    # the per-batch host candidate gather this regime pays
                    c0 = kb.engine.initial_candidates(
                        k, corpus.n_valid
                    )
                    regime["est_host_gather_bytes_per_batch"] = int(
                        batch * c0 * corpus.dim * 4
                    )
                n_sets = 12
                queries = [[f"q:{r * batch + i}" for i in range(batch)]
                           for r in range(n_sets)]
                for w in range(2):  # warmup: compile + caches
                    await kb.retrieve_batch(queries[w], k)
                times = []
                for r in range(6):
                    t0 = time.perf_counter()
                    res = await kb.retrieve_batch(queries[r], k)
                    times.append(time.perf_counter() - t0)
                assert len(res) == batch and len(res[0]) == k
                stats = kb.stats()

                # pipelined: keep D batches in flight over fresh query
                # sets — batch r+1's upload/device/fetch (IO waits on
                # the link) overlaps batch r's host finalize; measure
                # depth 2 and 3 and report the better (host-core count
                # bounds useful depth)
                async def run_depth(depth: int) -> float:
                    sem = asyncio.Semaphore(depth)

                    async def one(r: int) -> None:
                        async with sem:
                            await kb.retrieve_batch(queries[r % n_sets], k)

                    t0 = time.perf_counter()
                    await asyncio.gather(*(one(r) for r in range(10)))
                    return (time.perf_counter() - t0) / 10

                # depth 4 included: when the link (not the host) is the
                # bottleneck, deeper pipelining keeps winning — measured
                # depth-3 vs depth-2 gaps of 10-20% under stall-heavy
                # hours; the best depth is reported alongside the value
                by_depth = {d: await run_depth(d) for d in (2, 3, 4)}
                pipelined_depth = min(by_depth, key=by_depth.get)
                pipelined_s = by_depth[pipelined_depth]
                # Post-run observability: which route answered, what the
                # dispatch inputs were, whether hedges fired.  The RPC
                # floor is probed explicitly here (quiet moment): the
                # b=256 route check short-circuits before ever probing
                # it, which left the field null in early captures.
                try:
                    await loop.run_in_executor(
                        None, kb.engine.device_rpc_floor
                    )
                except Exception:
                    pass
                final_stats = kb.stats()
                disp = final_stats.get("dispatch", {})
                regime["host_search_count"] = int(
                    final_stats.get("host_search", {}).get("count", 0)
                )
                regime["device_search_count"] = int(
                    final_stats.get("device_search", {}).get("count", 0)
                )
                regime["rpc_floor_ms"] = disp.get("rpc_floor_ms")
                regime["host_scan_bw_gbs"] = round(
                    disp.get("host_scan_bw", 0.0) / 1e9, 3
                )
                regime["hedge_fired"] = int(disp.get("hedge_fired", 0))
                regime["hedge_won"] = int(disp.get("hedge_won", 0))
                stats = final_stats
                await kb.close(write_sidecar=False)
                p50 = _percentile(times, 0.50)
                log(f"[full-stack] batch {batch} top-{k}: p50 "
                    f"{p50 * 1e3:.1f} ms "
                    f"({p50 / batch * 1e3:.3f} ms/query, "
                    f"{batch / p50:,.0f} QPS) "
                    f"| spread {min(times) * 1e3:.0f}-"
                    f"{max(times) * 1e3:.0f} ms")
                log(f"[full-stack] pipelined ({pipelined_depth} in "
                    f"flight): {pipelined_s * 1e3:.1f} ms/batch "
                    f"({pipelined_s / batch * 1e3:.3f} ms/query, "
                    f"{batch / pipelined_s:,.0f} QPS) "
                    f"[depths: " + ", ".join(
                        f"{d}={v * 1e3:.0f}ms" for d, v in by_depth.items()
                    ) + "]")
                log(f"[full-stack] stages: " + ", ".join(
                    f"{name} p50 {st.get('p50_s', 0) * 1e3:.1f}ms"
                    for name, st in sorted(stats.items())
                    if isinstance(st, dict) and "p50_s" in st
                ))
                log(f"[full-stack] regime: {json.dumps(regime)}")
                return {
                    "batch": batch,
                    "k": k,
                    "p50_ms": round(p50 * 1e3, 3),
                    "spread_ms": [round(min(times) * 1e3, 3),
                                  round(max(times) * 1e3, 3)],
                    "per_query_ms": round(p50 / batch * 1e3, 4),
                    "qps": round(batch / p50, 1),
                    "pipelined_ms": round(pipelined_s * 1e3, 3),
                    "pipelined_depth": pipelined_depth,
                    "pipelined_per_query_ms": round(
                        pipelined_s / batch * 1e3, 4
                    ),
                    "pipelined_qps": round(batch / pipelined_s, 1),
                    "regime": regime,
                    "stages": {
                        name: st
                        for name, st in stats.items() if isinstance(st, dict)
                    },
                }

            return asyncio.run(run())

        # ---- phase orchestration ----

        batched_n = args.batched_phase
        if batched_n is None:
            batched_n = 256 if (
                args.preset == "headline" and args.batch == 1
            ) else 0

        bf16_batched = None
        if precision_label == "auto" and args.preset == "headline":
            # bf16 batched row first (it needs the bf16 corpus), then
            # requantize the same data to int8 for the auto phases —
            # peak HBM ~4.7 GB (3.1 bf16 + 1.5 int8 + one chunk).
            docs16, _ = with_retries(lambda: materialize("bf16"))
            if batched_n:
                bf16_batched = measure(
                    batched_n, max(10, args.iters // 3), "bf16", docs16, None
                )
            docs, row_scales = with_retries(lambda: quantize_from(docs16))
            del docs16
            gc.collect()
        else:
            docs, row_scales = with_retries(
                lambda: materialize(device_precision)
            )

        primary = measure(
            args.batch, args.iters, device_precision, docs, row_scales
        )

        # Batched-throughput phase on the same corpus: one corpus read
        # serves the whole batch, which is where the per-query targets
        # live (BASELINE.md).  On by default for the 1M presets.
        batched = None
        if batched_n and batched_n != args.batch:
            try:
                batched = measure(
                    batched_n, max(10, args.iters // 3),
                    device_precision, docs, row_scales,
                )
            except Exception:
                import traceback

                log("batched phase failed (primary unaffected):")
                log(traceback.format_exc())

        # Full-stack phase: on by default for the 1M presets (off on
        # the CPU smoke preset, where a 1M-row device matmul is
        # impractical; off when degraded — the on-disk bench KB exists
        # at the headline size only).
        full_stack = None
        do_full = args.full_stack if args.full_stack is not None else (
            args.preset == "headline" and not on_cpu and not degraded
        )
        if do_full:
            try:
                full_stack = measure_full_stack(256, k)
            except Exception:
                import traceback

                log("full-stack phase failed (kernel numbers unaffected):")
                log(traceback.format_exc())

        result = {
            "metric": (
                f"p50 exact cosine top-{k} over {n}x{dim} "
                f"({'auto=int8+f32-rescore' if precision_label == 'auto' else device_precision}, "
                f"batch={args.batch}, prescore step, dispatch to "
                f"host fetch)"
            ),
            "value": primary["p50_ms"],
            "unit": "ms",
            "vs_baseline": primary["vs_baseline"],
            **{kk: primary[kk] for kk in (
                "per_query_ms", "qps", "p99_ms", "device_ms",
                "device_per_query_ms", "device_vs_baseline", "kernel",
            )},
            "device": {
                "platform": dev.platform,
                "kind": dev.device_kind,
                "count": len(jax.devices()),
            },
        }
        if degraded:
            result["degraded"] = True
            result["degraded_n"] = n
            result["ref_scaled"] = True
        if bf16_batched is not None:
            result["bf16_batched"] = bf16_batched
        if batched is not None:
            result["batched"] = batched
        if full_stack is not None:
            result["full_stack"] = full_stack
        return result

    # Degrade chain: if the headline shape will not fit on the device
    # after retries, shrink the corpus and mark the row degraded instead
    # of dying with rc!=0.
    if args.preset == "headline":
        chain = [
            (cand, REF_WARM_1M_S * cand / 1_000_000)
            for cand in HEADLINE_DEGRADE_CHAIN
            if cand <= preset_n
        ]
    else:
        chain = [(preset_n, _preset_ref)]
    result = None
    for i, (cand_n, cand_ref) in enumerate(chain):
        try:
            result = run_sized(cand_n, cand_ref, degraded=i > 0)
            break
        except Exception as exc:
            gc.collect()
            try:
                jax.clear_caches()
            except Exception:
                pass
            if i == len(chain) - 1:
                raise
            log(f"bench at n={cand_n} failed "
                f"({type(exc).__name__}: {exc}); degrading corpus size")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException as exc:  # noqa: BLE001 — contract: always emit JSON
        import traceback

        log(traceback.format_exc())
        print(
            json.dumps(
                {
                    "metric": "bench failed",
                    "value": None,
                    "unit": "error",
                    "vs_baseline": None,
                    "error": f"{type(exc).__name__}: {exc}",
                }
            ),
            flush=True,
        )
        sys.exit(0)
