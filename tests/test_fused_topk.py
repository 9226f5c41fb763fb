"""The fused GPU retrieval kernel (``ops.fused_topk``) in the Pallas
interpreter, against the plain XLA path and NumPy; plus the dispatch
rule, the device-memory budgets and the package's import footprint."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svs_tpu.ops import fused_topk as ft
from svs_tpu.ops.quant import quantize_rows_int8, score_topk_int8_packed
from svs_tpu.ops.topk import score_topk_packed, unpack_vals_idx
from svs_tpu.utils import device_memory

PRECISIONS = ["bf16", "int8"]


def _store(m, precision):
    """``(docs, row_scales)`` as the engine's pack stores ``m``."""
    if precision == "int8":
        return quantize_rows_int8(jnp.asarray(m))
    dtype = jnp.float32 if precision == "f32" else jnp.bfloat16
    return jnp.asarray(m, dtype), None


def _xla_packed(docs, scales, q, n_valid, k):
    if scales is not None:
        return score_topk_int8_packed(docs, scales, q, n_valid, k)
    return score_topk_packed(docs, q, n_valid, k)


def _model_scores(docs, scales, q):
    """Prescores in the storage model, computed on the host."""
    if scales is not None:
        qi, qs = quantize_rows_int8(jnp.asarray(q))
        raw = np.asarray(qi, np.int64) @ np.asarray(docs, np.int64).T
        return (
            raw.astype(np.float32)
            * np.asarray(scales)[None, :]
            * np.asarray(qs)[:, None]
        )
    d = np.asarray(docs.astype(jnp.float32))
    qq = np.asarray(jnp.asarray(q).astype(docs.dtype).astype(jnp.float32))
    return qq @ d.T


# -- the kernel's per-tile extraction -----------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
def test_tile_candidates_are_per_tile_top_h(unit_rows, precision):
    """Each (query, tile) group holds that tile's top TILE_H prescores in
    descending order with their rows; rows at or past n_valid never
    appear with a finite value."""
    n, d, b = 4 * ft.BLOCK_N, 128, 16
    n_valid = n - 40
    m = unit_rows(n, d)
    docs, scales = _store(m, precision)
    q = unit_rows(b, d)
    if scales is not None:
        qi, qs = quantize_rows_int8(jnp.asarray(q))
        ev, ei = ft.tile_candidates(
            docs, qi, jnp.int32(n_valid), scales, qs, interpret=True
        )
    else:
        ev, ei = ft.tile_candidates(
            docs, jnp.asarray(q).astype(docs.dtype), jnp.int32(n_valid),
            interpret=True,
        )
    ev, ei = np.asarray(ev), np.asarray(ei)
    assert ev.shape == ei.shape == (b, (n // ft.BLOCK_N) * ft.TILE_H)
    model = _model_scores(docs, scales, q)
    model[:, n_valid:] = -np.inf
    tiles = model.reshape(b, -1, ft.BLOCK_N)
    want = -np.sort(-tiles, axis=2)[:, :, : ft.TILE_H].reshape(b, -1)
    np.testing.assert_allclose(ev, want, rtol=0, atol=2e-6)
    live = np.isfinite(ev)
    assert (ei[live] < n_valid).all()
    np.testing.assert_allclose(
        np.take_along_axis(model, ei, axis=1)[live], ev[live], atol=2e-6
    )


# -- end to end against the XLA path ------------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("b", [1, 8, 256])
def test_fused_topk_matches_xla(unit_rows, precision, b):
    """Padded batches (b=1 pads to one 16-row block, b=256 is four 64-row
    blocks) and n_valid masking: the same top-k rows as the XLA path and
    prescores equal up to accumulation order."""
    n, d, k = 8 * ft.BLOCK_N, 128, 20
    n_valid = n - 100
    m = unit_rows(n, d)
    docs, scales = _store(m, precision)
    q = jnp.asarray(unit_rows(b, d))
    got = ft.fused_topk_packed(
        docs, q, jnp.int32(n_valid), k, row_scales=scales, interpret=True
    )
    want = _xla_packed(docs, scales, q, jnp.int32(n_valid), k)
    gv, gi = unpack_vals_idx(np.asarray(got), k)
    wv, wi = unpack_vals_idx(np.asarray(want), k)
    assert got.shape == want.shape == (b, 2 * k)
    assert (gi < n_valid).all()
    np.testing.assert_allclose(gv, wv, atol=2e-6)
    for row in range(b):
        # rows agree wherever the prescores are not tied to the last ulp
        sep = np.abs(np.diff(wv[row])) > 4e-6
        keep = np.concatenate([[True], sep]) & np.concatenate([sep, [True]])
        assert set(gi[row][keep]) == set(wi[row][keep])


@pytest.mark.parametrize("nv_off", [0, 1, 255, 300])
def test_fused_topk_never_returns_padding(unit_rows, nv_off):
    """Rows at or past n_valid are masked inside the kernel: with k equal
    to the live count every live row comes back and no padded one does."""
    n, d = 4 * ft.BLOCK_N, 128
    n_valid = n - nv_off
    k = min(n_valid, 4 * ft.TILE_H)
    m = unit_rows(n, d)
    docs, _ = _store(m, "bf16")
    q = jnp.asarray(unit_rows(2, d))
    packed = ft.fused_topk_packed(docs, q, jnp.int32(n_valid), k, interpret=True)
    vals, rows = unpack_vals_idx(np.asarray(packed), k)
    assert np.isfinite(vals).all()
    assert (rows < n_valid).all()


@pytest.mark.parametrize("precision", PRECISIONS)
def test_fused_topk_hidden_cluster_falls_back_exact(precision):
    """A tile holding more than TILE_H of the top-k: its TILE_H-th value
    beats the merged k-th, so the coverage check must route the batch
    through the exact path — and the result must be the exact top-k."""
    n, d, k = 4 * ft.BLOCK_N, 128, 12
    m = np.zeros((n, d), np.float32)
    m[:, 1] = 1.0
    hot = (0.9 - np.arange(k) * 0.02).astype(np.float32)
    m[ft.BLOCK_N : ft.BLOCK_N + k, 0] = hot  # all in tile 1
    m[ft.BLOCK_N : ft.BLOCK_N + k, 1] = np.sqrt(1.0 - hot**2)
    docs, scales = _store(m, precision)
    q = np.zeros((1, d), np.float32)
    q[0, 0] = 1.0
    packed = ft.fused_topk_packed(
        docs, jnp.asarray(q), jnp.int32(n), k, row_scales=scales,
        interpret=True,
    )
    _, rows = unpack_vals_idx(np.asarray(packed), k)
    assert rows[0].tolist() == list(range(ft.BLOCK_N, ft.BLOCK_N + k))


@pytest.mark.parametrize("wide", [False, True])
def test_fused_topk_wire_formats(unit_rows, wide):
    """Both wire layouts decode to the same rows and scores."""
    n, d, k = 4 * ft.BLOCK_N, 128, 9
    m = unit_rows(n, d)
    docs, _ = _store(m, "bf16")
    q = jnp.asarray(unit_rows(3, d))
    packed = ft.fused_topk_packed(
        docs, q, jnp.int32(n), k, wide=wide, interpret=True
    )
    vals, rows = unpack_vals_idx(np.asarray(packed), k, wide=wide)
    model = _model_scores(docs, None, q)
    for b in range(3):
        assert rows[b].tolist() == np.argsort(-model[b])[:k].tolist()
        np.testing.assert_allclose(vals[b], model[b, rows[b]], atol=2e-6)


# -- the merge ------------------------------------------------------------------


@pytest.mark.parametrize("covered", [True, False])
def test_verified_merge_takes_fallback_only_when_a_tile_hides(covered):
    """Two tiles of h=2 winners, k=3: the merge keeps the fast result
    while no tile's h-th value beats the merged k-th, and otherwise
    (tile 0 could hide a third winner) returns the fallback's answer."""
    ev = np.array([[0.9, 0.5, 0.8, 0.1]], np.float32)
    if not covered:
        ev = np.array([[0.9, 0.8, 0.7, 0.1]], np.float32)
    ei = np.array([[10, 11, 20, 21]], np.int32)
    sentinel = (jnp.full((1, 3), -7.0), jnp.full((1, 3), 99, jnp.int32))
    vals, idx = ft._verified_merge(
        jnp.asarray(ev), jnp.asarray(ei), 3, 2, lambda: sentinel
    )
    if covered:
        assert np.asarray(idx).tolist() == [[10, 20, 11]]
    else:
        assert np.asarray(idx).tolist() == [[99, 99, 99]]
        np.testing.assert_array_equal(np.asarray(vals), -7.0)


# -- shapes and the dispatch rule ----------------------------------------------


@pytest.mark.parametrize(
    "b,block", [(1, 16), (16, 16), (17, 32), (64, 64), (100, 64), (256, 64)]
)
def test_block_q_for(b, block):
    assert ft.block_q_for(b) == block


@pytest.mark.parametrize(
    "n,d,k,dtype,ok",
    [
        (4 * ft.BLOCK_N, 128, 32, jnp.bfloat16, True),
        (4 * ft.BLOCK_N, 128, 33, jnp.bfloat16, False),  # k > tiles * H
        (ft.BLOCK_N, 128, 4, jnp.bfloat16, False),  # one tile only
        (4 * ft.BLOCK_N + 128, 128, 8, jnp.bfloat16, False),  # partial tile
        (4 * ft.BLOCK_N, 192, 8, jnp.bfloat16, True),  # 192 % 64 == 0
        (4 * ft.BLOCK_N, 192, 8, jnp.int8, False),  # 192 % 128 != 0
        (4 * ft.BLOCK_N, 128, 8, jnp.float32, False),  # f32 stays on XLA
        (4 * ft.BLOCK_N, 128, 8, jnp.float16, False),  # no fp16 storage
    ],
)
def test_fused_supported(n, d, k, dtype, ok):
    assert ft.fused_supported(n, d, k, dtype) is ok


@pytest.mark.parametrize("platform,b,ok", [
    ("gpu", 8, True), ("gpu", 2, True), ("gpu", 1, False), ("cpu", 8, False),
])
def test_fused_route_needs_a_gpu_and_a_batch(platform, b, ok):
    """A GPU, and a batch of at least FUSED_MIN_BATCH: a solo query is
    bound by the corpus read and XLA measured faster there."""
    assert ft.FUSED_MIN_BATCH == 2
    assert ft.fused_route(platform, b, 4 * ft.BLOCK_N, 128, 8, jnp.int8) is ok


def test_engine_takes_xla_path_on_cpu(unit_rows):
    """On the CPU backend the engine never routes to the kernel (it
    would need the interpreter, which only tests ask for)."""
    from svs_tpu.engine import RetrievalEngine
    from svs_tpu.engine.packing import pack_corpus

    m = unit_rows(4 * ft.BLOCK_N, 32)
    ids = np.arange(1, len(m) + 1, dtype=np.int64)
    corpus = pack_corpus(m, ids, version=1, precision="bf16")
    assert not RetrievalEngine(precision="bf16")._fused_route(corpus, 8, 16)


@pytest.mark.parametrize("precision", PRECISIONS + ["f32"])
@pytest.mark.parametrize("budget", [None, 0])
def test_exact_topk_streams_past_budget_with_same_answer(
    unit_rows, precision, budget
):
    """The one exact XLA path: within the scores budget it materializes,
    past it it streams row blocks, and both return the materializing
    kernels' rows and values."""
    from svs_tpu.ops.topk import exact_topk_packed

    m = unit_rows(4 * ft.BLOCK_N, 64)
    docs, scales = _store(m, precision)
    q = jnp.asarray(unit_rows(3, 64))
    nv = jnp.int32(len(m) - 7)
    k = 20
    want = np.asarray(_xla_packed(docs, scales, q, nv, k))
    got = np.asarray(
        exact_topk_packed(docs, q, nv, k, row_scales=scales, budget=budget)
    )
    np.testing.assert_array_equal(got[:, k:], want[:, k:])
    np.testing.assert_allclose(got[:, :k], want[:, :k], rtol=1e-6)


# -- device-memory budgets -------------------------------------------------------


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_budgets_keep_16gb_values_where_unreported():
    """The CPU backend reports no memory limit: the budgets are the
    values they were drawn from."""
    assert jax.devices()[0].memory_stats() is None
    assert device_memory.bytes_limit() is None
    assert device_memory.scores_budget() == 1 << 31
    assert device_memory.gather_budget() == 4_000_000_000
    assert device_memory.mirror_budget() == 8_000_000_000


@pytest.mark.parametrize("limit", [16 * 2**30, 60 * 2**30])
def test_budgets_scale_with_reported_limit(limit):
    dev = _FakeDevice({"bytes_limit": limit, "bytes_in_use": 0})
    share = limit / (16 * 2**30)
    assert device_memory.bytes_limit(dev) == limit
    assert device_memory.scores_budget(dev) == int((1 << 31) * share)
    assert device_memory.gather_budget(dev) == int(4_000_000_000 * share)
    assert device_memory.mirror_budget(dev) == int(8_000_000_000 * share)


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_budgets_ignore_devices_without_a_limit(stats):
    dev = _FakeDevice(stats)
    assert device_memory.bytes_limit(dev) is None
    assert device_memory.scores_budget(dev) == 1 << 31


# -- installation ------------------------------------------------------------------


def test_import_without_networkx():
    """``import svs_tpu`` needs nothing beyond numpy, scipy and JAX:
    networkx is imported only where a graph is built."""
    code = (
        "import sys; sys.modules['networkx'] = None; "
        "import svs_tpu; from svs_tpu import KB; "
        "assert 'aiohttp' not in sys.modules; print('ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_serve_workers_need_the_cpu_backend(monkeypatch, platform):
    """``--workers N`` forks N JAX clients, so it is refused off the CPU
    backend before anything forks or starts JAX."""
    from svs_tpu import serve

    monkeypatch.setattr(serve, "backend_platform", lambda: platform)
    monkeypatch.setattr(serve, "web", None)  # stop right after the check
    if platform == "gpu":
        with pytest.raises(ValueError, match="--workers 2 needs the CPU"):
            serve.run_server("unused.sqlite", workers=2)
    else:
        with pytest.raises(RuntimeError, match="aiohttp is required"):
            serve.run_server("unused.sqlite", workers=2)
