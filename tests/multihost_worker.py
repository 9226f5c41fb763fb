"""Worker process for the multi-host test: one of N jax.distributed
processes on the CPU backend, each owning 4 virtual devices of a global
2xN-device data mesh.  Opens the SHARED store file, runs a mesh-sharded
retrieve through the full KB facade, and writes its results as JSON.

Run by tests/test_multihost.py; also usable manually:

    python tests/multihost_worker.py --coordinator localhost:9911 \
        --num-processes 2 --process-id 0 --db /tmp/mh.sqlite --out /tmp/r0.json
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--db", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    # 4 local virtual devices per process -> an 8-device global mesh at N=2
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    )

    import jax

    from svs_tpu import KB
    from svs_tpu.parallel import multihost

    mesh = multihost.initialize(
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    assert jax.process_count() == args.num_processes
    assert len(jax.devices()) == 4 * args.num_processes

    from kb_helpers import make_onehot_embedder

    kb = KB(args.db, make_onehot_embedder(dim=64), mesh=mesh)
    hits = kb.retrieve("vec:37", 5)
    batch = kb.retrieve_batch(["vec:3", "vec:50"], 3)
    out = {
        "process_id": args.process_id,
        "devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
        "single": [(h["doc"]["text"], round(h["score"], 5)) for h in hits],
        "batch": [
            [(h["doc"]["text"], round(h["score"], 5)) for h in hs]
            for hs in batch
        ],
    }
    kb.close()
    Path(args.out).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
