"""Examples must keep running (they are the de-facto tutorials)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(script, *args, cwd):
    env = dict(
        os.environ,
        PYTHONPATH=str(REPO),
        JAX_PLATFORMS="cpu",
    )
    return subprocess.run(
        [sys.executable, str(REPO / "examples" / script), *args],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=180,
    )


def test_quickstart(tmp_path):
    result = _run("quickstart.py", cwd=tmp_path)
    assert result.returncode == 0, result.stderr[-2000:]
    assert "tensor" in result.stdout or "+" in result.stdout
    assert (tmp_path / "quickstart.sqlite.gz").exists()


def test_graph(tmp_path):
    result = _run("graph.py", cwd=tmp_path)
    assert result.returncode == 0, result.stderr[-2000:]
    assert "directed: True" in result.stdout


def test_million_docs_scaled_down(tmp_path):
    result = _run(
        "million_docs_benchmark.py",
        "--n", "2000", "--dim", "32", "--db", str(tmp_path / "m.sqlite"),
        cwd=tmp_path,
    )
    assert result.returncode == 0, result.stderr[-2000:]
    assert "warm top-100 query p50" in result.stdout


def test_dad_jokes_with_mock(tmp_path):
    csv = tmp_path / "jokes.csv"
    csv.write_text("joke\nwhy did X\nknock knock\n\n")
    result = _run(
        "dad_jokes.py", str(csv), "--db", str(tmp_path / "j.sqlite"),
        "--mock", cwd=tmp_path,
    )
    assert result.returncode == 0, result.stderr[-2000:]
    assert (tmp_path / "j.sqlite.gz").exists()


def test_serving_example(tmp_path):
    result = _run("serving.py", cwd=tmp_path)
    assert "device steps" in result.stdout, result.stderr


def test_walkthrough_notebook_has_recorded_outputs():
    """The committed walkthrough notebook is the repo's recorded
    end-to-end artifact: every code cell must carry executed outputs and
    none may have errored (regenerate with examples/make_walkthrough.py)."""
    import json
    from pathlib import Path

    nb_path = Path(__file__).parent.parent / "examples" / "walkthrough.ipynb"
    nb = json.loads(nb_path.read_text())
    code_cells = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert len(code_cells) >= 8
    for cell in code_cells:
        assert cell["execution_count"], "cell never executed"
        for out in cell["outputs"]:
            assert out["output_type"] != "error", out
    # a few load-bearing recorded facts
    text = nb_path.read_text()
    assert "Fortune favors the bold." in text
    assert "docs served from http" in text
    assert "~" in text  # near-duplicate pair lines


def test_local_embeddings_example(tmp_path):
    pytest.importorskip("transformers")
    result = _run("local_embeddings.py", cwd=tmp_path)
    assert result.returncode == 0, result.stderr[-2000:]
    assert "reopened: SQLite is a single-file embedded database." in (
        result.stdout
    )
    assert (tmp_path / "local_kb.sqlite").exists()


def test_replicas_example(tmp_path):
    result = _run("replicas.py", cwd=tmp_path)
    assert result.returncode == 0, result.stderr[-2000:]
    assert "verified" in result.stdout


def test_observability_example(tmp_path):
    result = _run("observability.py", cwd=tmp_path)
    assert result.returncode == 0, result.stderr[-2000:]
    assert "per-phase timings" in result.stdout
    assert "pack events" in result.stdout
    assert "dispatch inputs" in result.stdout
    assert "host_scan_bw" in result.stdout
