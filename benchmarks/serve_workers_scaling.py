"""Serving worker-scaling measurement: ``--workers 1`` vs ``--workers N``.

Starts the REAL CLI server (``python -m svs_tpu serve ... --workers N``,
SO_REUSEPORT fork sharing) as a subprocess against the cached bench
corpus, hammers ``/retrieve`` over loopback with closed-loop clients,
and reports QPS per worker count.

Scaling model under test (see ``serve.run_server``): workers multiply
the HOST side — HTTP parsing, JSON render, hydration, host-path scans —
which is exactly what saturates first on small-core hosts (round-4
measurement: one event loop on one core capped the layer at ~228 QPS
@1M while the device sustained ~39k).  On a 1-vCPU harness the workers
oversubscribe one core, so the expected result there is ~flat — the row
is still worth recording because it pins the ceiling to the core count,
not to the architecture.  Workers run only on the CPU backend (each
starts its own JAX client; see ``serve.run_server``), so the servers
here are started with ``JAX_PLATFORMS=cpu``.

Run:  python benchmarks/serve_workers_scaling.py [n_docs] [clients] [seconds] [workers...]
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from corpus import ensure_bench_kb  # noqa: E402

N = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
CLIENTS = int(sys.argv[2]) if len(sys.argv) > 2 else 32
SECONDS = float(sys.argv[3]) if len(sys.argv) > 3 else 10.0
WORKER_COUNTS = [int(x) for x in sys.argv[4:]] or [1, 2]
DIM = 1536
TOP_N = 10
PORT = 8931


async def _wait_healthy(base: str, timeout: float = 300.0) -> None:
    """Healthy AND settled: a worker still uploading its pack/mirror
    steals the (single) host core from the very requests being timed."""
    import aiohttp

    deadline = time.monotonic() + timeout
    settled = 0
    async with aiohttp.ClientSession() as s:
        while time.monotonic() < deadline:
            try:
                async with s.get(base + "/healthz") as r:
                    if r.status == 200:
                        body = await r.json()
                        if not body.get("warming"):
                            settled += 1
                            if settled >= 4:  # all workers likely seen
                                return
            except aiohttp.ClientError:
                pass
            await asyncio.sleep(0.5)
    raise TimeoutError("server never became healthy+settled")


async def _load(base: str) -> dict:
    import aiohttp

    stop = time.monotonic() + SECONDS
    counts = [0] * CLIENTS
    lat: list = []

    statuses: dict = {}

    async def client(ci: int) -> None:
        async with aiohttp.ClientSession() as s:
            i = ci * 100_000
            while time.monotonic() < stop:
                i += 1
                t0 = time.perf_counter()
                try:
                    async with s.post(
                        base + "/retrieve",
                        json={"query": f"q:{i % N}", "n": TOP_N},
                    ) as r:
                        body = await r.read()
                        statuses[r.status] = statuses.get(r.status, 0) + 1
                        if r.status == 200:
                            counts[ci] += 1
                            lat.append(time.perf_counter() - t0)
                        elif statuses[r.status] == 1:
                            print(f"  status {r.status}: {body[:200]!r}",
                                  flush=True)
                except aiohttp.ClientError as exc:
                    statuses[str(type(exc).__name__)] = (
                        statuses.get(str(type(exc).__name__), 0) + 1
                    )

    t0 = time.perf_counter()
    await asyncio.gather(*(client(i) for i in range(CLIENTS)))
    wall = time.perf_counter() - t0
    lat.sort()
    total = sum(counts)
    return {
        "qps": round(total / wall, 1),
        "requests": total,
        "p50_ms": round(lat[len(lat) // 2] * 1e3, 2) if lat else None,
        "p99_ms": round(lat[int(len(lat) * 0.99)] * 1e3, 2) if lat else None,
        "statuses": statuses,
    }


def main() -> None:
    path = ensure_bench_kb(N, DIM)
    rows = {}
    for workers in WORKER_COUNTS:
        port = PORT + workers
        cmd = [
            sys.executable, "-m", "svs_tpu", "serve", str(path),
            "--port", str(port), "--workers", str(workers),
            "--precision", "auto", "--max-batch", "64",
        ]
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        errlog = open(
            Path(tempfile.gettempdir()) / f"serve_workers_{workers}.log", "w"
        )
        proc = subprocess.Popen(
            cmd, env=env, stderr=errlog,
            start_new_session=True,
        )
        base = f"http://127.0.0.1:{port}"
        try:
            asyncio.run(_wait_healthy(base))
            # brief warm spin so every worker compiles/caches
            warm = dict(globals())  # noqa: F841 - readability anchor
            asyncio.run(_load(base))
            row = asyncio.run(_load(base))
            rows[workers] = row
            print(f"workers={workers}: {json.dumps(row)}", flush=True)
        finally:
            os.killpg(proc.pid, signal.SIGINT)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
        time.sleep(2.0)
    print(json.dumps({"n": N, "clients": CLIENTS, "rows": rows}))


if __name__ == "__main__":
    main()
