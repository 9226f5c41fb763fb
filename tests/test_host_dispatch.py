"""Automatic host-path dispatch: small corpora / small batches answer
from the host f32 cache when the measured device round-trip floor
exceeds the host exact-scan cost.

The reference's warm query at 10k docs is ~11 ms on 2018 hardware
(``/root/reference/README.md:128``); where every device call pays a
~30 ms round trip (a remote device), without this dispatch the device
engine loses exactly those shapes.  The host path must be *identical*
in results (same exact f32 scores, same tie rule) — these tests pin
that, plus the dispatch decision rule itself.
"""

import numpy as np
import pytest

from svs_tpu import KB
from tests.kb_helpers import make_angle_embedder, make_onehot_embedder


def _build(db_path, n_docs=40):
    kb = KB(db_path, make_angle_embedder(), force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(n_docs):
            add(f"angle:{(i * 11) % 360}")
    return kb


# -- the dispatch rule -------------------------------------------------------


def test_host_route_decision_rule(db_path):
    kb = _build(db_path)
    try:
        eng = kb.engine
        corpus = kb._ensure_engine_fresh()
        assert corpus.host_f32 is not None

        # inject measured values: expensive device, known host bandwidth
        eng._rpc_floor = 0.030  # a remote device link
        eng._host_scan_bw = 1e9
        eng.host_dispatch = "auto"
        # host cost = batch * nbytes / 1e9 ~ microseconds << 30 ms
        assert eng.host_route(corpus, 1)
        assert eng.host_route(corpus, 4)

        # cheap device -> device path
        eng._rpc_floor = 1e-9
        assert not eng.host_route(corpus, 1)

        # overrides
        eng._rpc_floor = 0.030
        eng.host_dispatch = "off"
        assert not eng.host_route(corpus, 1)
        eng.host_dispatch = "force"
        eng._rpc_floor = 1e-9
        assert eng.host_route(corpus, 1)
    finally:
        kb.close()


def test_host_route_requires_exactness_machinery(db_path):
    # rescore opted out -> no host route (the host path IS the rescore
    # definition of exact)
    kb = KB(db_path, make_angle_embedder(), force_fresh_db=True,
            rescore=False, precision="f32")
    try:
        with kb.bulk_add_docs() as add:
            for i in range(8):
                add(f"angle:{i * 13}")
        corpus = kb._ensure_engine_fresh()
        kb.engine._rpc_floor = 10.0
        kb.engine.host_dispatch = "auto"
        assert not kb.engine.host_route(corpus, 1)
    finally:
        kb.close()


def test_host_route_declines_large_score_matrix(db_path):
    kb = _build(db_path, n_docs=16)
    try:
        corpus = kb._ensure_engine_fresh()
        kb.engine._rpc_floor = 10.0
        kb.engine.host_dispatch = "auto"
        # batch so large the [B, n] score matrix exceeds the guard
        huge_batch = (256 * 1024 * 1024) // (corpus.n_valid * 4) + 1
        assert not kb.engine.host_route(corpus, huge_batch)
        assert kb.engine.host_route(corpus, 1)
    finally:
        kb.close()


def test_calibration_overrides_wrong_prior(db_path):
    """A wrong bandwidth prior is corrected by the measured scan: after
    one host_topk_exact call the EWMA moves toward the real machine and
    the dispatch decision flips accordingly."""
    kb = _build(db_path)
    try:
        eng = kb.engine
        corpus = kb._ensure_engine_fresh()
        # absurd prior: host "slower" than a 50 us device floor
        eng._host_scan_bw = 1.0  # 1 byte/s
        eng._rpc_floor = 50e-6
        eng.host_dispatch = "auto"
        assert not eng.host_route(corpus, 1)
        q = np.asarray([[1.0, 0.0]], dtype=np.float32)
        eng.host_topk_exact(corpus, q, 5)
        # measured bandwidth >> 1 byte/s; EWMA must have moved enough
        assert eng._host_scan_bw > 1e3
    finally:
        kb.close()


# -- result parity -----------------------------------------------------------


@pytest.mark.parametrize("precision", ["auto", "bf16", "f32"])
def test_host_and_device_paths_agree(db_path, tmp_path, precision):
    texts = [f"angle:{(i * 7) % 360}" for i in range(60)]
    kb_dev = KB(db_path, make_angle_embedder(), force_fresh_db=True,
                precision=precision)
    with kb_dev.bulk_add_docs() as add:
        for t in texts:
            add(t)
    kb_dev.engine.host_dispatch = "off"
    queries = ["angle:3", "angle:181", "angle:90"]
    dev_hits = [kb_dev.retrieve(q, 7) for q in queries]
    kb_dev.close()

    kb_host = KB(db_path, make_angle_embedder(), precision=precision)
    kb_host.engine.host_dispatch = "force"
    host_hits = [kb_host.retrieve(q, 7) for q in queries]
    stats = kb_host.stats()
    kb_host.close()

    assert "host_search" in stats, sorted(stats)
    assert stats["host_search"]["count"] == len(queries)
    for dh, hh in zip(dev_hits, host_hits):
        assert [h["doc"]["id"] for h in dh] == [h["doc"]["id"] for h in hh]
        np.testing.assert_allclose(
            [h["score"] for h in dh], [h["score"] for h in hh],
            rtol=0, atol=1e-6,
        )


async def test_async_host_path_and_stats(tmp_path):
    from svs_tpu import AsyncKB

    path = tmp_path / "hd.sqlite"
    kb = AsyncKB(path, make_onehot_embedder(8), force_fresh_db=True)
    kb.engine.host_dispatch = "force"
    async with kb.bulk_add_docs() as add:
        for i in range(12):
            await add(f"vec:{i % 8}")
    hits = await kb.retrieve("vec:3", 4)
    assert len(hits) == 4
    assert hits[0]["score"] == pytest.approx(1.0)
    # exact-tie block: every vec:3 dup scores 1.0, larger emb id first
    top_ids = [h["doc"]["id"] for h in hits if h["score"] > 0.999]
    assert top_ids == sorted(top_ids, reverse=True)
    assert "host_search" in kb.stats()
    await kb.close()


def test_host_path_tie_rule_matches_reference(db_path):
    """Duplicate texts -> exactly tied scores; the reference breaks to
    the larger matrix index (= larger emb id).  Host path must match."""
    kb = KB(db_path, make_onehot_embedder(8), force_fresh_db=True)
    try:
        kb.engine.host_dispatch = "force"
        with kb.bulk_add_docs() as add:
            for _ in range(6):
                add("vec:2")
            for _ in range(4):
                add("vec:5")
        hits = kb.retrieve("vec:2", 8)
        scores = [h["score"] for h in hits]
        assert scores == sorted(scores, reverse=True)
        tied = [h["doc"]["id"] for h in hits if h["score"] > 0.999]
        assert len(tied) == 6
        assert tied == sorted(tied, reverse=True)
    finally:
        kb.close()


def test_host_path_with_permuted_row_map(db_path):
    """A non-identity host_row_map (the fused native pack keeps the scan
    matrix unpermuted) must not change host-path results."""
    import dataclasses

    kb = _build(db_path, n_docs=30)
    try:
        corpus = kb._ensure_engine_fresh()
        hf = corpus.host_f32
        assert hf is not None and corpus.host_row_map is None
        q = np.asarray(
            [[np.cos(np.radians(45)), np.sin(np.radians(45))]], np.float32
        )
        emb0, scores0 = kb.engine.host_topk_exact(corpus, q, 6)

        rng = np.random.default_rng(7)
        rm = rng.permutation(corpus.n_valid).astype(np.int64)
        hf_perm = np.empty_like(hf)
        hf_perm[rm] = hf  # hf_perm[rm[p]] == pack row p's vector
        permuted = dataclasses.replace(corpus, host_cache=(hf_perm, rm))
        emb1, scores1 = kb.engine.host_topk_exact(permuted, q, 6)
        np.testing.assert_array_equal(emb0, emb1)
        np.testing.assert_array_equal(scores0, scores1)
    finally:
        kb.close()
