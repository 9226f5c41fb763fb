"""Regression tests for the round-4 advisor findings.

Each test pins one fix:

- medium: the deferred-pack uploader's throttle must stop yielding when
  a query is BLOCKED waiting on that very upload (priority inversion —
  the waiter is counted in-flight while it sleeps, so the old busy check
  deferred every chunk its full budget).
- low: a transient device error during the one-shot RPC-floor probe must
  not cache ``inf`` forever (that routed all eligible traffic to the
  host scan for the life of the engine).
- low: ``enable_compilation_cache`` must not clobber a cache directory
  the user configured via ``JAX_COMPILATION_CACHE_DIR``/``jax.config``.
- low: KB warmup must compile the DEVICE route even when the host
  dispatch answers the ladder, so a later dispatch flip never jit-compiles
  on live traffic.

(The high finding — the margin bound recomputed at the current candidate
count on every widen retry — is pinned in
``test_rescore_exactness.test_prescore_eps_recomputed_at_each_widen``.)
"""

import threading
import time
from pathlib import Path

import numpy as np
import pytest

from svs_tpu import KB
from svs_tpu.engine import RetrievalEngine
from tests.kb_helpers import make_angle_embedder


def _build(db_path, n=40):
    kb = KB(db_path, make_angle_embedder(), force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(n):
            add(f"angle:{(i * 11) % 360}")
    return kb


# -- medium: pack-upload priority inversion ---------------------------------


def test_throttle_skips_deferral_when_pack_has_waiters():
    """With a query in flight AND recent arrivals, the throttle normally
    defers up to ``max_defer`` — but a positive pack-waiter count must
    short-circuit it immediately (the "busy" traffic IS the waiter)."""
    eng = RetrievalEngine()
    stop = threading.Event()
    eng._inflight = 1
    eng._last_query_t = time.monotonic()

    # sanity: without waiters this would sit in the defer loop
    t0 = time.perf_counter()
    eng._mirror_throttle(stop, max_defer=0.4)
    assert time.perf_counter() - t0 >= 0.35

    eng._pack_waiters = 1
    t0 = time.perf_counter()
    eng._mirror_throttle(stop, max_defer=30.0)
    assert time.perf_counter() - t0 < 0.5


def test_await_pack_device_counts_waiters(db_path, monkeypatch):
    """A device-path query blocked on the deferred upload registers as a
    pack waiter for exactly the duration of the wait."""
    import svs_tpu.engine.packing as packing

    monkeypatch.setattr(packing, "DEFER_MIN_BYTES", 0)
    gate = threading.Event()
    seen = []
    real = packing.staged_device_put

    def gated(host, device, chunk_bytes=None, throttle=None):
        assert gate.wait(timeout=30)
        return real(host, device, chunk_bytes=chunk_bytes, throttle=throttle)

    monkeypatch.setattr(packing, "staged_device_put", gated)

    kb = _build(db_path)
    try:
        kb.engine.host_dispatch = "off"  # force the device path
        waiter_counts = []
        done = threading.Event()

        def query():
            kb.retrieve("angle:33", 4)
            done.set()

        t = threading.Thread(target=query, daemon=True)
        t.start()
        # the query should block in _await_pack_device behind the gate
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with kb.engine._inflight_lock:
                w = kb.engine._pack_waiters
            waiter_counts.append(w)
            if w > 0:
                break
            time.sleep(0.02)
        assert max(waiter_counts) >= 1, "query never registered as waiter"
        gate.set()
        assert done.wait(timeout=30)
        with kb.engine._inflight_lock:
            assert kb.engine._pack_waiters == 0
    finally:
        gate.set()
        kb.close()


# -- low: RPC-floor probe resilience ----------------------------------------


def test_rpc_floor_probe_failure_not_cached(monkeypatch):
    """A transient exception during the probe returns the prior WITHOUT
    caching, and a later successful probe measures the real floor."""
    import jax

    eng = RetrievalEngine()
    calls = {"n": 0}
    real_put = jax.device_put

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient link error")
        return real_put(*a, **kw)

    monkeypatch.setattr(jax, "device_put", flaky)
    floor1 = eng.device_rpc_floor()
    assert np.isfinite(floor1)  # the prior, not inf
    assert eng._rpc_floor is None  # NOT cached
    floor2 = eng.device_rpc_floor()  # re-probes, succeeds
    assert np.isfinite(floor2)
    assert eng._rpc_floor is not None


# -- low: user-configured compilation cache respected ------------------------


def test_compile_cache_respects_existing_config(monkeypatch, tmp_path):
    import jax

    import svs_tpu.utils.compile_cache as cc

    monkeypatch.setattr(cc, "_done", False)
    user_dir = str(tmp_path / "user_xla_cache")
    jax.config.update("jax_compilation_cache_dir", user_dir)
    try:
        cc.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == user_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", None)
        monkeypatch.setattr(cc, "_done", False)


# -- low: warmup compiles the device route under host dispatch ---------------


def test_warmup_warms_device_route_when_host_answers(db_path):
    kb = _build(db_path)
    try:
        eng = kb.engine
        # 'auto' with a dispatch that picks the host: inflated RPC floor
        eng.host_dispatch = "auto"
        eng._rpc_floor = 10.0
        eng._rpc_floor_t = time.monotonic()
        eng._rpc_probes = 1
        eng._host_scan_bw = 1e12
        kb.warmup([1, 2], n=3, rounds=1)
        stats = kb.stats()
        # the ladder itself went to the host...
        assert stats.get("host_search", {}).get("count", 0) >= 2
        # ...but the device path was compiled too (one extra drive per
        # batch size), so a dispatch flip never compiles on live traffic
        assert stats.get("device_search", {}).get("count", 0) >= 2
        # and the override was restored
        assert eng.host_dispatch == "auto"
    finally:
        kb.close()


def test_warmup_never_blocks_on_deferred_upload(db_path, monkeypatch):
    """REGRESSION (round-5 self-review): pre-upload, host_route answers
    True because device_ready is False — the device-warm block must NOT
    flip to the device route there, or server startup stalls for the
    whole multi-GB background upload."""
    import threading as _threading

    import svs_tpu.engine.packing as packing

    monkeypatch.setattr(packing, "DEFER_MIN_BYTES", 0)
    gate = _threading.Event()
    real = packing.staged_device_put

    def gated(host, device, chunk_bytes=None, throttle=None):
        assert gate.wait(timeout=30)
        return real(host, device, chunk_bytes=chunk_bytes, throttle=throttle)

    monkeypatch.setattr(packing, "staged_device_put", gated)
    kb = _build(db_path)
    try:
        kb.engine.host_dispatch = "auto"
        done = _threading.Event()

        def warm():
            kb.warmup([1], n=2, rounds=1)
            done.set()

        t = _threading.Thread(target=warm, daemon=True)
        t.start()
        # warmup must finish on the host path without the upload landing
        assert done.wait(timeout=30), (
            "warmup blocked on the deferred pack upload"
        )
    finally:
        gate.set()
        kb.close()


@pytest.mark.parametrize("ambient_via", ["env", "config"])
def test_compile_cache_ambient_dir_beats_explicit_override(
    monkeypatch, tmp_path, ambient_via
):
    """A compilation cache directory JAX already knows about (env
    JAX_COMPILATION_CACHE_DIR, or jax.config) is used as it is: the
    program sets no other directory, not even from an explicit
    SVS_TPU_COMPILE_CACHE."""
    import jax

    import svs_tpu.utils.compile_cache as cc

    ambient = str(tmp_path / "ambient")
    explicit = str(tmp_path / "explicit")
    if ambient_via == "env":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", ambient)
    else:
        jax.config.update("jax_compilation_cache_dir", ambient)
    monkeypatch.setenv("SVS_TPU_COMPILE_CACHE", explicit)
    monkeypatch.setattr(cc, "_done", False)
    try:
        cc.enable_compilation_cache()
        expected = ambient if ambient_via == "config" else None
        assert jax.config.jax_compilation_cache_dir == expected
        assert not (tmp_path / "explicit").exists()
    finally:
        jax.config.update("jax_compilation_cache_dir", None)
        monkeypatch.setattr(cc, "_done", False)


@pytest.mark.parametrize("explicit", [False, True])
def test_compile_cache_default_is_fixed_in_checkout(
    monkeypatch, tmp_path, explicit
):
    """Without an ambient directory the cache goes to SVS_TPU_COMPILE_CACHE
    when given, else to the fixed in-checkout default (git-ignored); the
    CPU backend caches only on the explicit path."""
    import jax

    import svs_tpu.utils.compile_cache as cc

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    target = tmp_path / "explicit"
    if explicit:
        monkeypatch.setenv("SVS_TPU_COMPILE_CACHE", str(target))
    else:
        monkeypatch.delenv("SVS_TPU_COMPILE_CACHE", raising=False)
        monkeypatch.setattr(cc, "DEFAULT_DIR", target)
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(cc, "_done", False)
    try:
        cc.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(target)
        assert target.is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", None)
        monkeypatch.setattr(cc, "_done", False)
    if explicit:
        repo = Path(cc.__file__).resolve().parents[2]
        assert repo in Path(cc.DEFAULT_DIR).parents
        assert ".cache/" in (repo / ".gitignore").read_text().splitlines()
