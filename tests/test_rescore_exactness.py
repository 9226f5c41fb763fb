"""Verified-exact rescore: adversarial corpora whose scores cluster inside
the prescore's quantization error at the candidate boundary.

Round 1 asserted that 4x candidate over-provisioning "cannot evict a true
top-k hit"; these tests construct corpora where it absolutely can (hundreds
of scores inside one bf16 ulp, best docs stored last so prescore ties
resolve toward the WRONG rows) and prove the margin check + candidate
widening restores exactness (reference guarantee: full-f32 exhaustive dot,
``svs/kb.py:1185``).
"""

import logging
import math

import numpy as np
import pytest

from svs_tpu import KB
from svs_tpu.engine import RetrievalEngine
from svs_tpu.store import Database, embedding_to_bytes
from svs_tpu.utils.topk_np import top_k_numpy


def _cluster_vectors(scores, dim=16):
    """Unit vectors whose dot with e1 is exactly ``scores`` (f32)."""
    out = np.zeros((len(scores), dim), dtype=np.float32)
    for i, s in enumerate(scores):
        out[i, 0] = s
        out[i, 1] = math.sqrt(1.0 - float(s) ** 2)
    return out


def _cluster_embedder(vectors, dim=16):
    """Deterministic provider: 'c:<i>' -> vectors[i], 'probe' -> e1."""

    async def embed(texts):
        res = []
        for t in texts:
            if t == "probe":
                v = np.zeros(dim, dtype=np.float32)
                v[0] = 1.0
            else:
                v = vectors[int(t.split(":")[1])]
            res.append([float(x) for x in v])
        return res

    embed.__embedding_func_params__ = {"provider": "mock"}
    return embed


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_adversarial_boundary_cluster_is_exact(db_path, precision, caplog):
    """200 docs within one prescore ulp, best-scoring stored LAST (prescore
    ties resolve to the lowest rows, i.e. the worst docs) -> the fixed
    4x candidate set provably cannot determine the true top-10; the margin
    check must fire and widen until the result matches the f32 oracle."""
    n_cluster, k = 200, 10
    scores = 0.7 + np.arange(n_cluster, dtype=np.float64) * 1e-6  # ascending
    vectors = _cluster_vectors(scores)

    kb = KB(
        db_path,
        _cluster_embedder(vectors),
        force_fresh_db=True,
        precision=precision,
    )
    with kb.bulk_add_docs() as add:
        for i in range(n_cluster):
            add(f"c:{i}")

    with caplog.at_level(logging.INFO, logger="svs_tpu.kb"):
        hits = kb.retrieve("probe", k)

    oracle = [f"c:{n_cluster - 1 - j}" for j in range(k)]  # best are last
    assert [h["doc"]["text"] for h in hits] == oracle
    expect_scores = [float(np.float32(s)) for s in scores[::-1][:k]]
    got = [h["score"] for h in hits]
    np.testing.assert_allclose(got, expect_scores, atol=2e-6)
    # the test is only meaningful if the margin check actually fired
    assert any("widening" in r.message for r in caplog.records)
    kb.close()


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("device_rescore", ["auto", "host"])
def test_duplicate_ties_break_to_larger_emb_id(
    db_path, precision, device_rescore
):
    """REGRESSION (round 3, caught by the silicon stress oracle): with
    MORE exactly-tied documents than k, every precision must return the
    larger-emb-id half in descending-id order (the reference tie rule,
    ``svs/util.py:190-203``).  The f32 path used to skip the rescore
    stage entirely, taking the device's smaller-row-first tie order —
    wrong SET and wrong ORDER."""
    n, dim, k = 120, 16, 10
    rng = np.random.default_rng(7)
    m = rng.standard_normal((n, dim)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    m[40:70] = m[40]  # 30 exact duplicates, docs c:40..c:69

    async def embed(texts):
        out = []
        for t in texts:
            v = m[40] if t == "probe" else m[int(t.split(":")[1])]
            out.append([float(x) for x in v])
        return out

    embed.__embedding_func_params__ = {"provider": "mock"}
    kb = KB(
        db_path,
        embed,
        force_fresh_db=True,
        precision=precision,
        device_rescore=device_rescore,
    )
    with kb.bulk_add_docs() as add:
        for i in range(n):
            add(f"c:{i}")
    for hits in (kb.retrieve("probe", k), kb.retrieve_batch(["probe"], k)[0]):
        got = [h["doc"]["text"] for h in hits]
        assert got == [f"c:{69 - j}" for j in range(k)]
    kb.close()


def test_well_separated_corpus_never_widens(db_path, caplog):
    """Sanity: on orthogonal-ish data the margin check passes first try —
    the verification is free in the common case."""
    rng = np.random.default_rng(7)
    m = rng.normal(size=(300, 32)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)

    async def embed(texts):
        out = []
        for t in texts:
            if t.startswith("d:"):
                out.append([float(x) for x in m[int(t[2:])]])
            else:
                out.append([float(x) for x in m[17]])
        return out

    embed.__embedding_func_params__ = {"provider": "mock"}
    kb = KB(db_path, embed, force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(len(m)):
            add(f"d:{i}")
    with caplog.at_level(logging.INFO, logger="svs_tpu.kb"):
        hits = kb.retrieve("q", 5)
    assert hits[0]["doc"]["text"] == "d:17"
    assert not any("widening" in r.message for r in caplog.records)
    kb.close()


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_prescore_eps_is_sound_empirically(db_path, unit_rows, precision):
    """The per-query error bound must dominate every observed
    |device prescore - exact f32 score| on random data (by a margin —
    it's meant to be sound, not tight)."""
    m = unit_rows(512, 64)
    db = Database(db_path)
    with db.transaction() as tx:
        for i, v in enumerate(m):
            tx.add_doc(f"d{i}", None, None, embedding_to_bytes(list(map(float, v))))
        tx.bump_matrix_version()
    eng = RetrievalEngine(precision=precision)
    corpus = eng.ensure_fresh(db)
    q = unit_rows(8, 64)
    vals, rows = eng.topk(corpus, q, 50)
    eps = eng.prescore_eps(corpus, q, 50)
    exact = m @ q.T  # [N, B] f32
    for b in range(q.shape[0]):
        observed = np.abs(vals[b] - exact[rows[b], b])
        assert observed.max() < eps[b], (
            precision, observed.max(), eps[b]
        )
    db.close()


def test_adversarial_pairwise_cluster_is_exact(db_path, caplog):
    """Pairwise analog: a tight cone of vectors whose pair scores all sit
    within one bf16 ulp of each other; top pairs must match the f32
    oracle.  Adjacent angle gaps grow so every pair score is DISTINCT in
    f32 (a constant gap would make all adjacent pairs exact ties, leaving
    the oracle ill-defined)."""
    n, k = 40, 5
    gaps = (np.arange(n, dtype=np.float64) + 1.0) * 1e-3
    angles = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    vectors = np.zeros((n, 16), dtype=np.float32)
    vectors[:, 0] = np.cos(angles)
    vectors[:, 1] = np.sin(angles)

    kb = KB(db_path, _cluster_embedder(vectors), force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(n):
            add(f"c:{i}")

    with caplog.at_level(logging.INFO, logger="svs_tpu.kb"):
        pairs = kb.document_top_pairwise_scores(k)

    sims = vectors.astype(np.float32) @ vectors.astype(np.float32).T
    iu = np.triu_indices(n, k=1)
    flat = sims[iu]
    oracle = top_k_numpy(flat, k)
    oracle_pairs = {
        (f"c:{iu[0][i]}", f"c:{iu[1][i]}") for _, i in oracle
    }
    got_pairs = {(a["text"], b["text"]) for _, a, b in pairs}
    assert got_pairs == oracle_pairs
    got_scores = sorted((s for s, _, _ in pairs), reverse=True)
    oracle_scores = [s for s, _ in oracle]
    np.testing.assert_allclose(got_scores, oracle_scores, atol=1e-6)
    kb.close()


@pytest.mark.parametrize("route", ["xla", "fused"])
def test_kernel_cluster_exact_end_to_end(db_path, caplog, request, route):
    """Full KB drive of each prescore route: an adversarial within-ulp
    cluster that the bf16 prescore cannot order, through ``kb.retrieve_batch``
    — the margin must fail, the ladder must widen, and the final result
    must match the f32 oracle (reference guarantee: ``svs/kb.py:1185``).
    On the fused route the cluster also fills the first tiles past their
    extraction width, so the in-graph coverage fallback runs too."""
    calls = (
        request.getfixturevalue("fused_interpret") if route == "fused"
        else None
    )
    n_cluster, n_bg, k = 1200, 4000, 10
    dim = 16
    scores = 0.7 + np.arange(n_cluster, dtype=np.float64) * 1e-6  # ascending
    cluster = _cluster_vectors(scores, dim=dim)
    rng = np.random.default_rng(11)
    bg = rng.normal(size=(n_bg, dim)).astype(np.float32)
    bg[:, 0] = 0.0  # exactly orthogonal to the probe
    bg /= np.linalg.norm(bg, axis=1, keepdims=True)

    async def embed(texts):
        out = []
        for t in texts:
            if t == "probe":
                v = np.zeros(dim, dtype=np.float32)
                v[0] = 1.0
            elif t.startswith("c:"):
                v = cluster[int(t[2:])]
            else:
                v = bg[int(t[2:])]
            out.append([float(x) for x in v])
        return out

    embed.__embedding_func_params__ = {"provider": "mock"}
    kb = KB(db_path, embed, force_fresh_db=True, precision="bf16")
    with kb.bulk_add_docs() as add:
        for i in range(n_cluster):
            add(f"c:{i}")
        for i in range(n_bg):
            add(f"b:{i}")

    with caplog.at_level(logging.INFO, logger="svs_tpu.kb"):
        # a batch of two: solo queries take XLA on every platform
        hits, twin = kb.retrieve_batch(["probe", "probe"], k)
    assert twin == hits

    if calls is not None:
        assert calls, "fused kernel never dispatched"
    oracle = [f"c:{n_cluster - 1 - j}" for j in range(k)]  # best stored last
    assert [h["doc"]["text"] for h in hits] == oracle
    expect = [float(np.float32(s)) for s in scores[::-1][:k]]
    np.testing.assert_allclose([h["score"] for h in hits], expect, atol=2e-6)
    assert any("widening" in r.message for r in caplog.records)
    kb.close()


def test_prescore_eps_recomputed_at_each_widen(db_path, monkeypatch):
    """The margin bound is recomputed at the CURRENT candidate count on
    every widen retry (the bound is the engine's to define, and a retry
    may dispatch a different prescore route than the first attempt).
    Drive an adversarial cluster that must widen and assert the bound
    was re-derived at every width the ladder visited."""
    n_cluster, k = 200, 10
    scores = 0.7 + np.arange(n_cluster, dtype=np.float64) * 1e-6
    vectors = _cluster_vectors(scores)
    kb = KB(
        db_path,
        _cluster_embedder(vectors),
        force_fresh_db=True,
        precision="bf16",
    )
    with kb.bulk_add_docs() as add:
        for i in range(n_cluster):
            add(f"c:{i}")

    seen = []
    real = kb.engine.prescore_eps

    def spy(corpus, queries, c):
        seen.append(int(c))
        return real(corpus, queries, c)

    monkeypatch.setattr(kb.engine, "prescore_eps", spy)
    hits = kb.retrieve("probe", k)
    assert [h["doc"]["text"] for h in hits] == [
        f"c:{n_cluster - 1 - j}" for j in range(k)
    ]
    # the ladder widened at least once, and the bound was recomputed at
    # each visited width (strictly increasing c values, one per attempt)
    assert len(seen) >= 2, seen
    assert seen == sorted(seen) and seen[-1] > seen[0], seen
    kb.close()


def test_width_hint_prevents_repeat_widening(db_path, caplog):
    """After one batch widens, the learned candidate-width hint makes the
    NEXT batch start at the working width — steady state is ONE device
    search per batch even on margin-adversarial corpora (measured ~50%
    retry rate at 1M iid vectors without the hint, each retry a full
    second search)."""
    n_cluster, k = 200, 10
    scores = 0.7 + np.arange(n_cluster, dtype=np.float64) * 1e-6
    vectors = _cluster_vectors(scores)
    kb = KB(
        db_path,
        _cluster_embedder(vectors),
        force_fresh_db=True,
        precision="bf16",
    )
    with kb.bulk_add_docs() as add:
        for i in range(n_cluster):
            add(f"c:{i}")

    with caplog.at_level(logging.INFO, logger="svs_tpu.kb"):
        first = kb.retrieve("probe", k)
    assert any("widening" in r.message for r in caplog.records)
    assert kb.engine._cand_hint[k][0] > kb.engine.candidate_count(k)

    caplog.clear()
    with caplog.at_level(logging.INFO, logger="svs_tpu.kb"):
        second = kb.retrieve("probe", k)
    assert second == first
    assert not any("widening" in r.message for r in caplog.records)
    kb.close()
