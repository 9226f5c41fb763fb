"""Multi-host retrieval, actually executed: 2 jax.distributed processes on
the CPU backend (4 virtual devices each -> one 8-device global data mesh),
both opening the same store file and running the full KB retrieve through
``parallel.multihost.initialize``.  Asserts cross-process agreement and
oracle correctness (SURVEY.md section 5: "DCN across slices via
jax.distributed" — the reference has no distributed anything)."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from svs_tpu import KB

sys.path.insert(0, str(Path(__file__).resolve().parent))
from kb_helpers import make_onehot_embedder  # noqa: E402


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_mesh_retrieve(tmp_path):
    db = tmp_path / "mh.sqlite"
    kb = KB(db, make_onehot_embedder(dim=64), force_fresh_db=True, sidecar=False)
    with kb.bulk_add_docs() as add:
        for i in range(300):
            add(f"vec:{i}")
    kb.close()

    port = _free_port()
    worker = Path(__file__).parent / "multihost_worker.py"
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    for i in range(2):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, str(worker),
                    "--coordinator", f"localhost:{port}",
                    "--num-processes", "2",
                    "--process-id", str(i),
                    "--db", str(db),
                    "--out", str(outs[i]),
                ],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
        )
    results = []
    for i, proc in enumerate(procs):
        try:
            stdout, stderr = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for p_ in procs:
                p_.kill()
            pytest.fail(f"worker {i} timed out")
        assert proc.returncode == 0, (
            f"worker {i} failed:\n{stderr.decode()[-3000:]}"
        )
        results.append(json.loads(outs[i].read_text()))

    r0, r1 = results
    assert r0["devices"] == 8 and r0["local_devices"] == 4
    # both hosts compute identical results from their replicated merge
    assert r0["single"] == r1["single"]
    assert r0["batch"] == r1["batch"]
    # oracle: one-hot embeddings -> 'vec:37' matches itself at score 1.0,
    # then the 64-aliased duplicates (37+64, 37+128, ...) also at 1.0
    texts = [t for t, _ in r0["single"]]
    scores = [s for _, s in r0["single"]]
    assert all(abs(s - 1.0) < 1e-4 for s in scores)
    assert set(texts) <= {f"vec:{37 + 64 * j}" for j in range(5)}
    assert r0["batch"][0][0][0] in {f"vec:{3 + 64 * j}" for j in range(5)}
    assert r0["batch"][1][0][0] in {f"vec:{50 + 64 * j}" for j in range(5)}
