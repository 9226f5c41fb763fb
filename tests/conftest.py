"""Test harness configuration.

Tests run on the JAX CPU backend with 8 virtual devices so the full
multi-device sharding paths (mesh, shard_map, top-k merge) execute
without an accelerator — the environment must be set before JAX
imports.  The fused GPU kernel runs here through the Pallas interpreter
(the ``fused_interpret`` fixture).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Also pin the platform through jax.config, in case JAX was configured
# before this conftest ran — the backend only materializes on first use,
# which happens after collection.
import jax

jax.config.update("jax_platforms", "cpu")

# On the CPU test backend the "device" RPC floor is host-function-call
# time, so the automatic host-path dispatch would route most tiny test
# corpora to the host scan and silently strip device-kernel coverage
# from every KB-level test.  Default it off here; the dedicated
# host-dispatch tests turn it on explicitly.
os.environ.setdefault("SVS_TPU_HOST_DISPATCH", "off")

import asyncio
import inspect

import numpy as np
import pytest


def pytest_pyfunc_call(pyfuncitem):
    """Minimal async-test support (pytest-asyncio is not in this image):
    coroutine test functions run under ``asyncio.run``."""
    func = pyfuncitem.obj
    if inspect.iscoroutinefunction(func):
        kwargs = {
            name: pyfuncitem.funcargs[name]
            for name in pyfuncitem._fixtureinfo.argnames
        }
        asyncio.run(func(**kwargs))
        return True
    return None


@pytest.fixture
def fused_interpret(monkeypatch):
    """Route single-device prescores through the fused GPU kernel
    (``ops.fused_topk``) on the CPU backend, run by the Pallas
    interpreter.  Returns the list of recorded kernel calls."""
    import functools

    from svs_tpu.ops import fused_topk as ft

    calls = []
    real = ft.fused_topk_packed

    @functools.wraps(real)
    def spy(*a, **kw):
        calls.append(1)
        return real(*a, interpret=True, **kw)

    monkeypatch.setattr(
        ft, "fused_route",
        lambda platform, b, *a: b >= ft.FUSED_MIN_BATCH
        and ft.fused_supported(*a),
    )
    monkeypatch.setattr(ft, "fused_topk_packed", spy)
    return calls


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def db_path(tmp_path):
    """A per-test throwaway database path."""
    return tmp_path / "testdb.sqlite"


def make_unit_rows(rng, n, d):
    """Random unit-norm float32 row vectors."""
    m = rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    return m


@pytest.fixture
def unit_rows(rng):
    return lambda n, d: make_unit_rows(rng, n, d)
