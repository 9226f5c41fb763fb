"""Cold-start benchmark: sidecar mmap vs full BLOB rescan.

Builds a synthetic KB of --n docs, then measures the time from "fresh
process state" to "first retrieval result" along both cold paths:

  1. no sidecar: scan every embedding BLOB out of SQLite, pack, search
     (the reference's only path — ~100 s at 1M docs on its hardware);
  2. sidecar: mmap the packed matrix straight to the device.

Appends a markdown row to ``--out`` (default ``cold_start.md``).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=200_000)
    parser.add_argument("--dim", type=int, default=1536)
    parser.add_argument(
        "--db",
        default=str(Path(tempfile.gettempdir()) / "coldstart.sqlite"),
    )
    parser.add_argument("--out", default="cold_start.md")
    args = parser.parse_args()

    from svs_tpu import KB
    from svs_tpu.engine.sidecar import sidecar_path_for
    from svs_tpu.store import Database, embedding_to_bytes
    from svs_tpu.utils.files import delete_file_if_exists

    async def embedder(texts):
        v = np.zeros(args.dim, dtype=np.float32)
        v[0] = 1.0
        return [v.tolist() for _ in texts]

    if not os.path.exists(args.db):
        print(f"building {args.n}-doc corpus...", file=sys.stderr)
        db = Database(args.db)
        rng = np.random.default_rng(0)
        with db.transaction() as tx:
            chunk = 20_000
            for start in range(0, args.n, chunk):
                rows = rng.standard_normal(
                    (min(chunk, args.n - start), args.dim)
                ).astype(np.float32)
                rows /= np.linalg.norm(rows, axis=1, keepdims=True)
                for i, row in enumerate(rows):
                    tx.add_doc(f"doc {start + i}", None, None,
                               embedding_to_bytes(row))
            tx.bump_matrix_version()
        db.close()

    delete_file_if_exists(sidecar_path_for(args.db))

    # --- cold path 1: BLOB rescan -------------------------------------------
    kb = KB(args.db, embedder, sidecar=False)
    t0 = time.perf_counter()
    kb.retrieve("q", 100)
    rescan_s = time.perf_counter() - t0
    print(f"cold (BLOB rescan): {rescan_s:.2f}s", file=sys.stderr)
    kb.close()

    # write the sidecar once
    kb = KB(args.db, embedder, sidecar=True)
    kb.load()
    kb.close()

    # --- cold path 2: sidecar mmap -----------------------------------------
    kb = KB(args.db, embedder, sidecar=True)
    t0 = time.perf_counter()
    kb.retrieve("q", 100)
    sidecar_s = time.perf_counter() - t0
    print(f"cold (sidecar mmap): {sidecar_s:.2f}s", file=sys.stderr)
    kb.close()

    import jax

    with open(args.out, "a") as f:
        f.write(
            f"\n## {time.strftime('%Y-%m-%d %H:%M')} — cold start, "
            f"{args.n}x{args.dim}, {jax.devices()[0]}\n\n"
            f"| path | first-query time |\n|---|---|\n"
            f"| BLOB rescan (reference's only path) | {rescan_s:.2f} s |\n"
            f"| sidecar mmap | {sidecar_s:.2f} s "
            f"({rescan_s / max(sidecar_s, 1e-9):.1f}x faster) |\n"
        )
    print(f"appended to {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
