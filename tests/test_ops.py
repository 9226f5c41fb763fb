"""Device-op equivalence tests: every accelerated path must reproduce the
NumPy oracle (SURVEY.md section 4's kernel-vs-oracle mandate)."""

import jax.numpy as jnp
import numpy as np
import pytest

from svs_tpu.engine.packing import pad_matrix, pad_queries
from svs_tpu.ops.pairwise import pairwise_topk_blocked
from svs_tpu.ops.quant import quantize_rows_int8, score_topk_int8
from svs_tpu.ops.topk import (
    masked_topk,
    merge_topk,
    score_topk,
    score_topk_fast,
)
from svs_tpu.utils.topk_np import top_k_numpy, top_pairs_numpy


def _setup(unit_rows, n=777, d=48, b=3):
    m = unit_rows(n, d)
    q = unit_rows(b, d)
    mp = pad_matrix(m)
    qp = pad_queries(q, mp.shape[1])
    return m, q, mp, qp


def test_score_topk_matches_oracle_f32(unit_rows):
    m, q, mp, qp = _setup(unit_rows)
    k = 17
    vals, idx = score_topk(jnp.asarray(mp), jnp.asarray(qp), jnp.int32(len(m)), k)
    for b in range(q.shape[0]):
        oracle = top_k_numpy(m @ q[b], k)
        assert list(np.asarray(idx)[b]) == [i for _, i in oracle]
        np.testing.assert_allclose(
            np.asarray(vals)[b], [s for s, _ in oracle], rtol=1e-5
        )


def test_score_topk_bf16_candidates_cover_true_topk(unit_rows):
    m, q, mp, qp = _setup(unit_rows, n=500)
    k, c = 10, 40  # engine over-provisions candidates for rescore
    vals, idx = score_topk(
        jnp.asarray(mp, dtype=jnp.bfloat16), jnp.asarray(qp), jnp.int32(len(m)), c
    )
    for b in range(q.shape[0]):
        true = {i for _, i in top_k_numpy(m @ q[b], k)}
        assert true <= set(np.asarray(idx)[b].tolist())


def test_masked_topk_never_returns_padding(unit_rows):
    m, q, mp, qp = _setup(unit_rows, n=10)
    scores = jnp.asarray(mp) @ jnp.asarray(qp).T
    vals, idx = masked_topk(scores.T, 10, jnp.int32(10))
    assert np.asarray(idx).max() < 10
    # every padded position would otherwise win on ties with score 0
    assert np.isfinite(np.asarray(vals)).all()


def test_score_topk_k_equals_n(unit_rows):
    m, q, mp, qp = _setup(unit_rows, n=100)
    vals, idx = score_topk(jnp.asarray(mp), jnp.asarray(qp), jnp.int32(100), 100)
    assert sorted(np.asarray(idx)[0].tolist()) == list(range(100))


@pytest.mark.parametrize("n,k", [(5000, 100), (2048, 10), (300, 100), (5000, 1)])
def test_score_topk_fast_is_exact(unit_rows, n, k):
    m = unit_rows(n, 48)
    q = unit_rows(2, 48)
    mp = pad_matrix(m)
    qp = pad_queries(q, mp.shape[1])
    nv = n - 7
    kk = min(k, nv)
    vals, idx = score_topk_fast(
        jnp.asarray(mp), jnp.asarray(qp), jnp.int32(nv), kk
    )
    for b in range(2):
        oracle = top_k_numpy(m[:nv] @ q[b], kk)
        assert list(np.asarray(idx)[b]) == [i for _, i in oracle]
        np.testing.assert_allclose(
            np.asarray(vals)[b], [s for s, _ in oracle], rtol=1e-5
        )


def test_score_topk_fast_clustered_scores(unit_rows):
    """Near-duplicate corpus: many candidates tie near the k-th boundary —
    the verification counting must still guarantee exactness."""
    base = unit_rows(1, 64)
    noise = unit_rows(4096, 64) * 0.001
    m = base + noise
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    q = base
    mp = pad_matrix(m.astype(np.float32))
    qp = pad_queries(q.astype(np.float32), mp.shape[1])
    vals, idx = score_topk_fast(
        jnp.asarray(mp), jnp.asarray(qp), jnp.int32(len(m)), 50
    )
    exact = m @ q[0]
    oracle = top_k_numpy(exact, 50)
    np.testing.assert_allclose(
        np.asarray(vals)[0], [s for s, _ in oracle], rtol=1e-5
    )
    # XLA and NumPy matmuls differ in the last ulp, so among near-ties the
    # exact index sets can legitimately differ; every selected doc must
    # still score at least the oracle's k-th value (minus float slack).
    kth = oracle[-1][0]
    assert (exact[np.asarray(idx)[0]] >= kth - 1e-5).all()


def test_merge_topk_exact():
    vals = jnp.asarray([[0.1, 0.9, 0.5, 0.7]])
    idx = jnp.asarray([[10, 20, 30, 40]])
    v, i = merge_topk(vals, idx, 2)
    assert np.asarray(i)[0].tolist() == [20, 40]
    np.testing.assert_allclose(np.asarray(v)[0], [0.9, 0.7])


def test_quantize_rows_int8_roundtrip(unit_rows):
    m = unit_rows(64, 32)
    q, scales = quantize_rows_int8(jnp.asarray(m))
    recon = np.asarray(q, dtype=np.float32) * np.asarray(scales)[:, None]
    np.testing.assert_allclose(recon, m, atol=1 / 127)


def test_score_topk_int8_candidates_cover_true_topk(unit_rows):
    m, q, mp, qp = _setup(unit_rows, n=600)
    qd, scales = quantize_rows_int8(jnp.asarray(mp))
    k, c = 10, 60
    vals, idx = score_topk_int8(qd, scales, jnp.asarray(qp), jnp.int32(len(m)), c)
    for b in range(q.shape[0]):
        true = {i for _, i in top_k_numpy(m @ q[b], k)}
        assert true <= set(np.asarray(idx)[b].tolist())


@pytest.mark.parametrize("n,k", [(100, 5), (500, 50), (300, 1)])
def test_pairwise_blocked_matches_oracle(unit_rows, n, k):
    m = unit_rows(n, 32)
    mp = pad_matrix(m)
    vals, rows, cols = pairwise_topk_blocked(
        jnp.asarray(mp), jnp.int32(n), k, block_rows=256
    )
    oracle = top_pairs_numpy(m @ m.T, k)
    assert list(zip(np.asarray(rows), np.asarray(cols))) == [
        (r, c) for _, r, c in oracle
    ]
    np.testing.assert_allclose(
        np.asarray(vals), [s for s, _, _ in oracle], rtol=1e-4
    )


def test_pairwise_blocked_ignores_padding_and_diagonal(unit_rows):
    # with only 2 real docs there is exactly one pair
    m = unit_rows(2, 16)
    mp = pad_matrix(m)
    vals, rows, cols = pairwise_topk_blocked(jnp.asarray(mp), jnp.int32(2), 1,
                                             block_rows=256)
    assert (int(np.asarray(rows)[0]), int(np.asarray(cols)[0])) == (0, 1)


def test_pad_matrix_shapes(unit_rows):
    m = unit_rows(10, 3)
    p = pad_matrix(m)
    assert p.shape == (256, 128)
    np.testing.assert_array_equal(p[:10, :3], m)
    assert p[10:].sum() == 0 and p[:, 3:].sum() == 0
    # already aligned: no copy semantics change
    m2 = unit_rows(256, 128)
    assert pad_matrix(m2).shape == (256, 128)


def test_wide_packing_roundtrip_any_bits():
    """int32 wire layout: score f32 bits survive bitcast round trip even for
    values that would be denormal-flushed as f32 payloads (tiny magnitudes),
    and indices are exact past 2^24."""
    import numpy as np
    from svs_tpu.ops.topk import pack_vals_idx, unpack_vals_idx

    vals = jnp.asarray(
        np.array([[1e-40, -0.5, 3.14159, 0.0]], dtype=np.float32)
    )
    idx = jnp.asarray(np.array([[2**24 + 1, 0, 7, 2**30]], dtype=np.int32))
    packed = pack_vals_idx(vals, idx, wide=True)
    assert packed.dtype == jnp.int32
    v, r = unpack_vals_idx(np.asarray(packed), 4, wide=True)
    np.testing.assert_array_equal(v, np.asarray(vals))
    np.testing.assert_array_equal(r, np.asarray(idx, dtype=np.int64))


def test_topk_selection_past_2_24_positions():
    """Exact selection over a score vector longer than 2^24: the index of a
    planted winner far past 2^24 must come back exactly (the f32-value
    layout could not represent it)."""
    import numpy as np
    from svs_tpu.ops.topk import masked_topk, pack_vals_idx, unpack_vals_idx

    n = (1 << 24) + 4096
    scores = np.zeros((1, n), dtype=np.float32)
    winner = (1 << 24) + 1234  # odd index: not representable in f32
    scores[0, winner] = 0.75
    scores[0, 12345] = 0.5
    vals, idx = masked_topk(jnp.asarray(scores), 2, jnp.int32(n))
    packed = pack_vals_idx(vals, idx, wide=True)
    v, r = unpack_vals_idx(np.asarray(packed), 2, wide=True)
    assert list(r[0]) == [winner, 12345]
    np.testing.assert_allclose(v[0], [0.75, 0.5])


def test_score_topk_packed_wide_matches_narrow():
    """Same query/corpus: wide and narrow layouts must decode identically."""
    import numpy as np
    from svs_tpu.ops.topk import score_topk_packed, unpack_vals_idx

    rng = np.random.default_rng(3)
    docs = rng.normal(size=(512, 128)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = docs[17:19]
    narrow = score_topk_packed(jnp.asarray(docs), jnp.asarray(q), jnp.int32(512), 9)
    wide = score_topk_packed(
        jnp.asarray(docs), jnp.asarray(q), jnp.int32(512), 9, wide=True
    )
    v1, r1 = unpack_vals_idx(np.asarray(narrow), 9, wide=False)
    v2, r2 = unpack_vals_idx(np.asarray(wide), 9, wide=True)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(v1, v2)


def test_tiled_topk_matches_oracle_random():
    import numpy as np
    from svs_tpu.ops.topk import tiled_topk

    rng = np.random.default_rng(11)
    scores = rng.normal(size=(3, 4096)).astype(np.float32)
    vals, idx = tiled_topk(jnp.asarray(scores), 37, m=8)
    for b in range(3):
        oracle = top_k_numpy(scores[b], 37)
        np.testing.assert_allclose(np.asarray(vals)[b], [s for s, _ in oracle])
        assert list(np.asarray(idx)[b]) == [i for _, i in oracle]


def test_tiled_topk_adversarial_single_tile_fallback():
    """All true top-k hides inside ONE tile beyond its kept m — the in-graph
    verification must trip and the fallback must return the exact result."""
    import numpy as np
    from svs_tpu.ops.topk import tiled_topk

    scores = np.zeros((2, 2048), dtype=np.float32)
    scores[:, 100:180] = np.linspace(0.99, 0.9, 80, dtype=np.float32)[None, :]
    vals, idx = tiled_topk(jnp.asarray(scores), 50, m=8)  # 50 > m hides 42
    for b in range(2):
        oracle = top_k_numpy(scores[b], 50)
        np.testing.assert_allclose(np.asarray(vals)[b], [s for s, _ in oracle])
        assert list(np.asarray(idx)[b]) == [i for _, i in oracle]


def test_score_topk_tiled_packed_matches_plain(unit_rows):
    import numpy as np
    from svs_tpu.ops.topk import (
        score_topk_packed,
        score_topk_tiled_packed,
        unpack_vals_idx,
    )

    docs, q, _, _ = _setup(unit_rows, n=2048, d=64, b=4)
    plain = score_topk_packed(docs, q, jnp.int32(2000), 25)
    tiled = score_topk_tiled_packed(docs, q, jnp.int32(2000), 25, m=8)
    v1, r1 = unpack_vals_idx(np.asarray(plain), 25)
    v2, r2 = unpack_vals_idx(np.asarray(tiled), 25)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(v1, v2)


def test_score_topk_tiled_bf16_scores_candidates_cover(unit_rows):
    """bf16 score storage: indices may tie differently, but every true
    top-k doc (by exact f32 score) must be inside the returned candidate
    set when k is over-provisioned (the engine always over-provisions)."""
    import numpy as np
    from svs_tpu.ops.topk import score_topk_tiled_packed, unpack_vals_idx

    docs, q, m_np, q_np = _setup(unit_rows, n=1024, d=64, b=2)
    c = 64
    packed = score_topk_tiled_packed(
        docs, q, jnp.int32(1000), c, m=8, score_dtype="bf16"
    )
    _, rows = unpack_vals_idx(np.asarray(packed), c)
    exact = m_np[:1000] @ q_np.T
    for b in range(2):
        true_top = {i for _, i in top_k_numpy(exact[:, b], 10)}
        assert true_top <= set(rows[b].tolist())


def test_coarse_topk_matches_oracle_random():
    import numpy as np
    from svs_tpu.ops.topk import coarse_topk

    rng = np.random.default_rng(5)
    scores = rng.normal(size=(3, 8192)).astype(np.float32)
    vals, idx = coarse_topk(jnp.asarray(scores), 20, tiles_kept=24, m=8)
    for b in range(3):
        oracle = top_k_numpy(scores[b], 20)
        np.testing.assert_allclose(np.asarray(vals)[b], [s for s, _ in oracle])
        assert list(np.asarray(idx)[b]) == [i for _, i in oracle]


def test_coarse_topk_adversarial_tie_maxes_fallback():
    """Every tile has the SAME max, so the tile screen keeps an arbitrary
    subset — the count check must trip and the fallback must stay exact."""
    import numpy as np
    from svs_tpu.ops.topk import coarse_topk

    n, tile = 8192, 256
    scores = np.zeros((2, n), dtype=np.float32)
    scores[:, ::tile] = 0.5  # identical max in every tile
    # true top-k spread across MANY tiles at second-rank positions
    scores[0, 5 + tile * 20] = 0.4
    scores[0, 5 + tile * 27] = 0.45
    vals, idx = coarse_topk(jnp.asarray(scores), 25, tiles_kept=25, m=4)
    for b in range(2):
        oracle = top_k_numpy(scores[b], 25)
        np.testing.assert_allclose(np.asarray(vals)[b], [s for s, _ in oracle])


import os



def test_escalation_widths_for_headline_shapes():
    """Pin the per-row width ladder of the 100k-doc pairwise headline
    (k=10,000 over 100k rows): start at 64, escalate through 1024, end
    exact at k; small corpora go straight to the exact width."""
    from svs_tpu.engine.packing import LARGE_ROW_MULTIPLE
    from svs_tpu.ops.pairwise import escalation_widths

    n_pad_100k = -(-100_000 // LARGE_ROW_MULTIPLE) * LARGE_ROW_MULTIPLE
    assert escalation_widths(10_000, n_pad_100k, n_pad_100k) == [
        64, 1024, 10_000
    ]
    assert escalation_widths(9, 1024, 1024) == [9]


@pytest.mark.parametrize(
    "n_valid,n_pad,blk,k",
    [(700, 1024, 512, 9), (1000, 1024, 256, 40), (257, 512, 256, 5)],
)
def test_pairwise_blocked_padded_matches_oracle(
    unit_rows, n_valid, n_pad, blk, k
):
    """Blocked pairwise over a zero-padded pack (padding rows and
    columns masked by n_valid, several row blocks) returns exactly the
    oracle's top pairs."""
    m = unit_rows(n_valid, 16)
    padded = np.zeros((n_pad, 128), np.float32)
    padded[:n_valid, :16] = m
    vals, rows, cols = pairwise_topk_blocked(
        jnp.asarray(padded), jnp.int32(n_valid), k, block_rows=blk
    )
    oracle = top_pairs_numpy(m @ m.T, k)
    assert [(r, c) for r, c in zip(rows, cols)] == [
        (r, c) for _, r, c in oracle
    ]
    np.testing.assert_allclose(
        np.asarray(vals), [v for v, _, _ in oracle], atol=2e-6
    )


def test_pairwise_escalates_when_rows_hoard_winners(unit_rows):
    """Adversarial dedup shape: one doc near-duplicated hundreds of times,
    so single rows hold far more than the per-row selection width — the
    tail check must escalate until the result is exact."""
    import jax.numpy as jnp
    from svs_tpu.ops import pairwise as pw
    from svs_tpu.ops.pairwise import pairwise_topk_blocked
    from svs_tpu.utils.topk_np import top_k_numpy

    rng = np.random.default_rng(3)
    n, d = 512, 16
    base = rng.standard_normal(d).astype(np.float32)
    m = base[None, :] + 0.001 * rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    k = 200
    assert k > pw._ESCALATION[0], "test must exceed the first stage width"
    vals, rows, cols = pairwise_topk_blocked(
        jnp.asarray(m), jnp.int32(n), k, block_rows=256
    )
    sims = m @ m.T
    iu = np.triu_indices(n, 1)
    flat = sims[iu]
    oracle = top_k_numpy(flat, k)
    # near-duplicates tie heavily (many pairs share identical f32 scores),
    # so assert exactness, not a specific tie resolution: the k selected
    # VALUES equal the oracle's, every returned pair really has its
    # claimed score, and every pair strictly above the k-th is present.
    np.testing.assert_array_equal(
        np.asarray(vals), np.asarray([s for s, _ in oracle], np.float32)
    )
    got_pairs = set(
        zip(np.asarray(rows).tolist(), np.asarray(cols).tolist())
    )
    rr, cc = np.asarray(rows), np.asarray(cols)
    np.testing.assert_allclose(sims[rr, cc], np.asarray(vals), rtol=1e-6)
    v_k = oracle[-1][0]
    must_have = {
        (int(iu[0][i]), int(iu[1][i]))
        for i in np.nonzero(flat > v_k)[0]
    }
    assert must_have <= got_pairs


def test_pairwise_huge_k_skips_too_narrow_widths(unit_rows):
    """k larger than n_padded * first_width: the escalation must skip
    widths whose total selected lanes could not hold k (the final merge
    would be ill-posed) instead of crashing."""
    import jax.numpy as jnp
    from svs_tpu.ops.pairwise import escalation_widths, pairwise_topk_blocked
    from svs_tpu.utils.topk_np import top_pairs_numpy

    n = 512
    k = 40_000  # > 512 * 64, < max_pairs = 130816
    assert escalation_widths(k, n, n) == [min(k, n)]
    m = unit_rows(n, 8)
    vals, rows, cols = pairwise_topk_blocked(
        jnp.asarray(m), jnp.int32(n), k, block_rows=256
    )
    oracle = top_pairs_numpy(m @ m.T, k)
    np.testing.assert_allclose(
        np.asarray(vals), [s for s, _, _ in oracle], rtol=1e-5
    )


def test_stress_oracle_micro(monkeypatch, tmp_path):
    """Default-suite miniature of the randomized end-to-end oracle
    stress: the full KB retrieve pipeline (XLA prescore dispatch,
    device/host rescore, margin widen, hints, hydration) against the
    exhaustive NumPy oracle with planted ties / near-ties, at shapes
    that run in seconds.  The weekly SMOKE tier runs the same harness
    at block-aligned shapes where the pallas kernels engage."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    monkeypatch.setenv("SVS_STRESS_MICRO", "1")
    monkeypatch.delenv("SVS_STRESS_SMOKE", raising=False)
    import importlib

    import benchmarks.stress_oracle as stress

    importlib.reload(stress)  # re-read the MICRO env gate
    monkeypatch.setattr(stress, "WORK", tmp_path)
    stress.main(seed=3)


@pytest.mark.skipif(
    not os.environ.get("SVS_TPU_SLOW_TESTS"),
    reason="full-pipeline oracle stress takes ~10 minutes on the CPU "
    "backend; set SVS_TPU_SLOW_TESTS=1 to run",
)
def test_stress_oracle_smoke(monkeypatch, tmp_path):
    """The randomized end-to-end oracle stress (benchmarks/
    stress_oracle.py) in its smoke configuration: drives the full
    KB retrieve pipeline (prescore kernels, device/host rescore, margin
    widen, hints, hydration) against the exhaustive NumPy oracle with
    planted ties / near-ties / hot-subtile adversaries."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    monkeypatch.setenv("SVS_STRESS_SMOKE", "1")
    import importlib

    import benchmarks.stress_oracle as stress

    importlib.reload(stress)  # re-read the SMOKE env gate
    monkeypatch.setattr(stress, "WORK", tmp_path)
    stress.main(seed=1)


# --- streaming exact fallback (memory-bounded scoring) ----------------------


def test_streaming_score_topk_matches_materializing(unit_rows):
    from svs_tpu.ops.topk import streaming_score_topk

    m, q, mp, qp = _setup(unit_rows)
    nv, k = jnp.int32(len(m)), 17
    qj = jnp.asarray(qp)
    for dtype in (jnp.float32, jnp.bfloat16):
        docs = jnp.asarray(mp, dtype)
        ref_v, ref_i = score_topk(docs, qj, nv, k)
        got_v, got_i = streaming_score_topk(
            docs, qj, nv, k, max_block_rows=128
        )
        np.testing.assert_array_equal(np.asarray(got_i), np.asarray(ref_i))
        np.testing.assert_allclose(
            np.asarray(got_v), np.asarray(ref_v), rtol=1e-6
        )


def test_streaming_score_topk_tie_rule_across_blocks(unit_rows):
    """Duplicated rows land in different blocks; the smaller-index-first
    tie rule of lax.top_k must survive the block merge."""
    from svs_tpu.ops.topk import streaming_score_topk

    base = unit_rows(64, 32)
    m = np.concatenate([base] * 4, axis=0)  # dup groups 64 rows apart
    q = base[:3]
    mp = pad_matrix(m)
    qp = jnp.asarray(pad_queries(q, mp.shape[1]))
    nv, k = jnp.int32(len(m)), 9
    docs = jnp.asarray(mp)
    ref_v, ref_i = score_topk(docs, qp, nv, k)
    got_v, got_i = streaming_score_topk(docs, qp, nv, k, max_block_rows=64)
    np.testing.assert_array_equal(np.asarray(got_i), np.asarray(ref_i))
    np.testing.assert_allclose(np.asarray(got_v), np.asarray(ref_v))


def test_streaming_score_topk_int8_matches_materializing(unit_rows):
    from svs_tpu.ops.topk import streaming_score_topk

    m, q, mp, qp = _setup(unit_rows)
    nv, k = jnp.int32(len(m)), 13
    qd, scales = quantize_rows_int8(jnp.asarray(mp))
    qj = jnp.asarray(qp)
    ref_v, ref_i = score_topk_int8(qd, scales, qj, nv, k)
    got_v, got_i = streaming_score_topk(
        qd, qj, nv, k, row_scales=scales, max_block_rows=96
    )
    np.testing.assert_array_equal(np.asarray(got_i), np.asarray(ref_i))
    np.testing.assert_allclose(np.asarray(got_v), np.asarray(ref_v), rtol=1e-6)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_fused_fallback_streams_past_scores_budget(monkeypatch, precision):
    """Over the device's scores budget, the fused kernel's in-graph
    exact fallback must stream (``lax.cond`` allocates the untaken
    branch too) — and stay exact when coverage fails: a cluster of 12
    winners in the first tile exceeds its TILE_H extraction width."""
    import svs_tpu.ops.topk as topk_mod
    import svs_tpu.utils.device_memory as device_memory
    from svs_tpu.ops import fused_topk as ft

    calls = []
    real = topk_mod.streaming_score_topk

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(device_memory, "scores_budget", lambda *a: 0)
    monkeypatch.setattr(topk_mod, "streaming_score_topk", spy)
    n, d, k = 4 * ft.BLOCK_N, 128, 10
    m = np.zeros((n, d), np.float32)
    m[:, 1] = 1.0
    hot = (0.9 - np.arange(12) * 0.02).astype(np.float32)
    m[:12, 0] = hot
    m[:12, 1] = np.sqrt(1.0 - hot**2)
    q = np.zeros((1, d), np.float32)
    q[0, 0] = 1.0
    if precision == "int8":
        docs, scales = quantize_rows_int8(jnp.asarray(m))
    else:
        docs, scales = jnp.asarray(m, jnp.bfloat16), None
    packed = ft.fused_topk_packed(
        docs, jnp.asarray(q), jnp.int32(n - 5), k, row_scales=scales,
        interpret=True,
    )
    assert calls, "streaming fallback not traced"
    idx = np.asarray(packed)[0, k:].astype(int)
    assert idx.tolist() == list(range(k))
