"""HTTP serving load benchmark: measured QPS through the full facade.

Drives ``svs_tpu.serve`` over loopback HTTP against the cached benchmark
corpus — request parsing, micro-batch coalescing (power-of-two ``n``
buckets), the device pipeline, and JSON hydration all included — with C
concurrent closed-loop clients.  This is the serving-throughput analog
of ``bench.py``'s full-stack phase (reference has no serving facade at
all; its single-process sync ``retrieve`` measures 240 ms/query at 1M:
``/root/reference/README.md:129``).

Run on the GPU:  python benchmarks/serve_load.py [n_docs] [clients] [seconds]
"""

from __future__ import annotations

import asyncio
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from corpus import ensure_bench_kb, query_embedder  # noqa: E402

N = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
CLIENTS = int(sys.argv[2]) if len(sys.argv) > 2 else 64
SECONDS = float(sys.argv[3]) if len(sys.argv) > 3 else 30.0
DIM = 1536
TOP_N = 10
PORT = 8765


async def run() -> None:
    import aiohttp
    from aiohttp import web

    from svs_tpu import AsyncKB
    from svs_tpu.serve import make_app

    path = ensure_bench_kb(N, DIM)
    kb = AsyncKB(path, query_embedder(DIM))
    t0 = time.perf_counter()
    await kb.load()
    print(f"load {time.perf_counter() - t0:.1f}s", flush=True)
    # steady-state measurement: the deferred pack + f32 mirror uploads
    # contend for the device link and the (single) host core
    t0 = time.perf_counter()
    ok = await asyncio.get_running_loop().run_in_executor(
        None, lambda: kb.engine.wait_for_mirror(900)
    )
    print(f"uploads settled={ok} {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    # warm only the buckets this closed-loop load reaches (1 and the
    # full CLIENTS bucket) at the n BUCKET the batcher will run
    from svs_tpu.serve import _n_bucket

    buckets = sorted({1, min(256, 1 << (CLIENTS - 1).bit_length())})
    await kb.warmup(buckets, n=_n_bucket(TOP_N))
    print(f"shape warmup {time.perf_counter() - t0:.1f}s", flush=True)
    app = make_app(kb)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", PORT)
    await site.start()

    url = f"http://127.0.0.1:{PORT}/retrieve"
    lat: list = []
    errors = [0]
    # set AFTER warmup (the first request pays compile + first device step —
    # seconds or more — which must not eat the timed window)
    stop = 0.0

    async def client(cid: int, session: "aiohttp.ClientSession") -> None:
        i = 0
        while time.perf_counter() < stop:
            q = f"query {cid}-{i}"
            i += 1
            t = time.perf_counter()
            try:
                async with session.post(
                    url, json={"query": q, "n": TOP_N}
                ) as resp:
                    if resp.status != 200:
                        # 504 = a device stall outlived the handler;
                        # count it, keep the load running (a crashed
                        # client would abort the whole measurement)
                        await resp.read()
                        errors[0] += 1
                        continue
                    body = await resp.json()
                    if len(body["results"]) != TOP_N:
                        errors[0] += 1
                        continue
            except aiohttp.ClientError:
                errors[0] += 1
                continue
            lat.append(time.perf_counter() - t)

    # no client timeout: the warmup request pays compile + first device
    # step, which can exceed aiohttp's 5-minute default on a slow link
    async with aiohttp.ClientSession(
        timeout=aiohttp.ClientTimeout(total=None)
    ) as session:
        # warm the device pipeline (compile) before the timed window —
        # including the BATCHED shapes the window will hit: the batcher
        # buckets coalesced batch sizes to powers of two, so a few
        # full-concurrency bursts compile every bucket the load will use
        async with session.post(
            url, json={"query": "warmup", "n": TOP_N}
        ) as resp:
            await resp.json()
            assert resp.status == 200

        async def one_warm(i: int) -> None:
            async with session.post(
                url, json={"query": f"warm {i}", "n": TOP_N}
            ) as resp:
                await resp.json()

        t0 = time.perf_counter()
        for _ in range(3):
            await asyncio.gather(*(one_warm(i) for i in range(CLIENTS)))
        print(f"batched warmup {time.perf_counter() - t0:.1f}s", flush=True)
        stop = time.perf_counter() + SECONDS
        t0 = time.perf_counter()
        await asyncio.gather(*(client(c, session) for c in range(CLIENTS)))
        wall = time.perf_counter() - t0

        async with session.get(
            f"http://127.0.0.1:{PORT}/stats"
        ) as resp:
            stats = await resp.json()

    await runner.cleanup()
    await kb.close()

    lat.sort()
    n_ok = len(lat)
    srv = stats["server"]
    print(
        f"docs={N} clients={CLIENTS} window={wall:.1f}s  "
        f"ok={n_ok} errors={errors[0]}",
        flush=True,
    )
    if n_ok:
        print(
            f"QPS {n_ok / wall:,.0f}  "
            f"latency p50 {lat[n_ok // 2] * 1e3:.1f} ms  "
            f"p99 {lat[int(n_ok * 0.99)] * 1e3:.1f} ms  "
            f"avg_batch {srv['avg_batch']:.1f}  shed {srv['shed']}",
            flush=True,
        )
        kb_stages = stats.get("kb", {})
        if isinstance(kb_stages, dict):
            print("  " + "  ".join(
                f"{name}: p50 {st['p50_s'] * 1e3:.1f}ms mean "
                f"{st['mean_s'] * 1e3:.1f}ms x{st['count']}"
                for name, st in sorted(kb_stages.items())
                if isinstance(st, dict) and "p50_s" in st
            ), flush=True)


def main() -> None:
    import jax

    print("device:", jax.devices()[0], flush=True)
    asyncio.run(run())


if __name__ == "__main__":
    main()
