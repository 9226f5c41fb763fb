"""The executable typing gate.

This image has no mypy (and no network to install one), so the configured
mypy-strict CI job cannot be proven here.  Instead two gates that DO
execute everywhere, including this suite:

1. static annotation-completeness lint (``tools/typecheck_lite.py``) —
   the ``disallow_untyped_defs``/``disallow_incomplete_defs`` core of
   strict mode, enforced over every def in ``svs_tpu``;
2. a typeguard-instrumented end-to-end drive — the package is imported
   under ``typeguard``'s import hook in a fresh subprocess and a KB is
   driven through add/retrieve/batch/pairwise/graph/KV/close, so the
   annotations are *checked against real values* at every call.

See ``docs/compatibility.md`` ("Typing") for how these relate to the
mypy gate in CI.
"""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def test_static_annotation_lint_clean():
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "typecheck_lite.py"),
         str(REPO / "svs_tpu")],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_lint_detects_violations(tmp_path):
    """The gate must actually FIRE on each rule it claims to enforce —
    a lint that only ever passes proves nothing."""
    bad = tmp_path / "pkg"
    bad.mkdir()
    (bad / "mod.py").write_text(
        "from typing import List, Optional\n"
        "def f(x): ...\n"                          # untyped param+return
        "def g(x: List) -> None: ...\n"            # bare generic
        "def h(x: int = None) -> None: ...\n"      # implicit optional
        "def ok(x: Optional[int] = None) -> None: ...\n"
        "def ok2(x: 'int | None' = None) -> None: ...\n"
        "y = 1  # type: ignore\n"                  # bare ignore
    )
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "typecheck_lite.py"),
         str(bad)],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1
    out = proc.stdout
    assert "missing annotation" in out
    assert "bare generic 'List'" in out
    assert "no_implicit_optional" in out
    assert "bare '# type: ignore'" in out
    # the two Optional spellings are accepted
    assert "def ok" not in out


_DRIVE = r"""
import warnings
from typeguard.importhook import install_import_hook

with warnings.catch_warnings():
    warnings.simplefilter("ignore")  # typeguard warns on some Protocol uses
    install_import_hook("svs_tpu")
    import svs_tpu
    from svs_tpu import KB

import asyncio, math

dim = 8

async def embed(texts):
    out = []
    for t in texts:
        v = [0.0] * dim
        if t.startswith("vec:"):
            v[int(t.split(":")[1]) % dim] = 1.0
        else:
            v = [1.0 / math.sqrt(dim)] * dim
        out.append(v)
    return out

embed.__embedding_func_params__ = {"provider": "mock"}

kb = KB(DB_PATH, embed, force_fresh_db=True)
with kb.bulk_add_docs() as add:
    ids = [add(f"vec:{i}", meta={"i": i}) for i in range(6)]
hits = kb.retrieve("vec:3", 2)
assert hits[0]["doc"]["text"] == "vec:3"
batch = kb.retrieve_batch(["vec:1", "vec:4"], 2)
assert batch[0][0]["doc"]["text"] == "vec:1"
pairs = kb.document_top_pairwise_scores(3)
assert len(pairs) == 3
with kb.bulk_graph_update() as g:
    eid = g.add_edge(ids[0], ids[1], ids[2])
    graph = g.build_networkx_graph()
with kb.bulk_keyval_update() as kv:
    kv["a"] = 1
    assert kv["a"] == 1 and "a" in kv and len(kv) == 1
    del kv["a"]
with kb.bulk_query_docs() as q:
    assert q.count() == 6
    doc = q.query_doc(ids[0])
with kb.bulk_del_docs() as dd:
    dd(ids[5])
kb.close(vacuum=True, write_sidecar=True)
print("TYPEGUARD-DRIVE-OK")
"""


def test_typeguard_runtime_drive(tmp_path):
    pytest.importorskip("typeguard")
    script = f"DB_PATH = {str(tmp_path / 'tg.sqlite')!r}\n" + _DRIVE
    import os

    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env,
    )
    assert proc.returncode == 0 and "TYPEGUARD-DRIVE-OK" in proc.stdout, (
        proc.stdout + "\n" + proc.stderr
    )
