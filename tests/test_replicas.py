"""Replica mode: corpus copied to N devices, query batches split across
them (``parallel.replicas.ReplicaEngine``, ``KB(replicas=...)``).

Replication is the throughput axis (corpus fits one chip, QPS scales
with devices); the mesh is the capacity axis.  The contract under test:
replicated results are IDENTICAL to single-chip results — same docs,
same scores, same reference tie ordering — for every batch size,
including batches smaller than the replica count and splits that cross
kernel-dispatch boundaries.

Reference counterpart: none (single process, one ``np.dot`` hot loop,
``svs/kb.py:1185``); this is net-new design per SURVEY.md section 2.3.
"""

import numpy as np
import pytest

from svs_tpu import KB
from svs_tpu.engine.index import RetrievalEngine
from svs_tpu.parallel import ReplicaEngine
from svs_tpu.store import Database, embedding_to_bytes

from kb_helpers import make_onehot_embedder


def _fill(db_path, vectors):
    db = Database(db_path)
    with db.transaction() as tx:
        for i, v in enumerate(vectors):
            tx.add_doc(
                f"d{i}", None, None, embedding_to_bytes(list(map(float, v)))
            )
        tx.bump_matrix_version()
    return db


@pytest.mark.parametrize("precision", ["bf16", "f32", "int8"])
def test_replica_topk_matches_single_chip(db_path, unit_rows, precision):
    """Every replica fan-out (prescore, rescore, final) returns exactly
    what one chip returns — including planted exact ties resolving to the
    larger emb id."""
    m = unit_rows(300, 24)
    m[40:48] = m[40]  # exact ties
    db = _fill(db_path, m)

    solo = RetrievalEngine(precision=precision)
    rep = ReplicaEngine(precision=precision, n_replicas=4)
    c_solo = solo.ensure_fresh(db)
    c_rep = rep.ensure_fresh(db)

    q = np.concatenate([m[40:41], unit_rows(9, 24)], axis=0)
    n = 7
    c = rep.initial_candidates(n, c_rep.n_valid)

    f_solo = solo.topk_final(c_solo, q, n, c)
    f_rep = rep.topk_final(c_rep, q, n, c)
    assert (f_solo is None) == (f_rep is None)
    if f_rep is not None:
        np.testing.assert_array_equal(f_rep[0], f_solo[0])  # emb ids
        np.testing.assert_allclose(f_rep[1], f_solo[1], atol=2e-6)
        assert f_rep[0].shape == (10, n)
        # planted tie block: largest emb id first
        assert list(f_rep[0][0][:5]) == [48, 47, 46, 45, 44]

    vals_s, rows_s, _ = solo.topk_with_rescore(c_solo, q, c)
    vals_r, rows_r, _ = rep.topk_with_rescore(c_rep, q, c)
    assert vals_r.shape == vals_s.shape and rows_r.shape == rows_s.shape
    # candidate SETS must agree per query (order within a replica's
    # slice is single-chip order by construction)
    for b in range(q.shape[0]):
        assert set(rows_r[b].tolist()) == set(rows_s[b].tolist())
    db.close()


def test_replica_kb_matches_single_kb(db_path, tmp_path):
    """Full KB parity: retrieve_batch through 4 replicas == single chip,
    for batches below/at/above the replica count and uneven splits."""
    emb = make_onehot_embedder(dim=64)
    kb1 = KB(tmp_path / "solo.sqlite", emb, force_fresh_db=True)
    kb4 = KB(
        tmp_path / "rep.sqlite", emb, force_fresh_db=True, replicas=4
    )
    for kb in (kb1, kb4):
        with kb.bulk_add_docs() as add:
            for i in range(60):
                add(f"vec:{i}")
    for batch in (1, 3, 4, 7, 20):
        qs = [f"vec:{i}" for i in range(batch)]
        r1 = kb1.retrieve_batch(qs, 3)
        r4 = kb4.retrieve_batch(qs, 3)
        for h1, h4 in zip(r1, r4):
            assert [x["doc"]["text"] for x in h4] == [
                x["doc"]["text"] for x in h1
            ]
            np.testing.assert_allclose(
                [x["score"] for x in h4], [x["score"] for x in h1]
            )
    kb1.close()
    kb4.close()


def test_replica_clones_and_recloning(db_path, unit_rows):
    """Clones ride the corpus snapshot (one per secondary device, host
    state shared by reference), and a store change produces a NEW corpus
    with its own clones — an in-flight search pinned to the old snapshot
    keeps the old clones (the single-chip snapshot contract)."""
    m = unit_rows(64, 16)
    db = _fill(db_path, m)
    rep = ReplicaEngine(precision="bf16", n_replicas=3)
    corpus = rep.ensure_fresh(db)
    assert corpus.replica_clones is not None
    assert len(corpus.replica_clones) == 2
    devs = {tuple(corpus.data.devices())}
    for c in corpus.replica_clones:
        assert c.emb_ids is corpus.emb_ids  # host state shared
        assert c.host_cache is corpus.host_cache
        devs.add(tuple(c.data.devices()))
    assert len(devs) == 3  # one copy per device

    from svs_tpu.store import embedding_to_bytes as e2b

    with db.transaction() as tx:
        v = np.zeros(16)
        v[3] = 1.0
        tx.add_doc("new", None, None, e2b(list(map(float, v))))
        tx.bump_matrix_version()
    c2 = rep.ensure_fresh(db)
    assert c2.n_valid == 65
    assert c2.replica_clones is not None
    assert all(c.n_valid == 65 for c in c2.replica_clones)
    # the old snapshot keeps ITS clones: an in-flight search using it
    # still fans out against matching packs
    assert all(c.n_valid == 64 for c in corpus.replica_clones)
    vals, rows = rep.topk(corpus, m[:6], 3)
    assert rows.shape == (6, 3) and (rows < 64).all()
    db.close()


def test_replica_eps_matches_slice_dispatch(db_path, unit_rows):
    """prescore_eps over a replicated batch equals a plain engine's bound
    on each replica's slice (the bound depends on the storage precision
    alone, so every slice's dispatch is covered)."""
    m = unit_rows(300, 24)
    db = _fill(db_path, m)
    rep = ReplicaEngine(precision="bf16", n_replicas=4)
    corpus = rep.ensure_fresh(db)
    q = unit_rows(18, 24)
    eps = rep.prescore_eps(corpus, q, 5)
    assert eps.shape == (18,)
    # slices of 18 over 4 replicas are [5,5,4,4]; each slice's bound must
    # equal a plain engine's bound at that slice size
    solo = RetrievalEngine(precision="bf16")
    start = 0
    for size in (5, 5, 4, 4):
        want = solo.prescore_eps(corpus, q[start : start + size], 5)
        np.testing.assert_array_equal(eps[start : start + size], want)
        start += size
    db.close()


def test_replica_mixed_rescore_degrades_whole_batch(db_path, unit_rows):
    """If any replica can't rescore on-device (mirror missing), the whole
    batch degrades together: topk_with_rescore returns exact=None (host
    rescore for everyone) and topk_final returns None (caller falls back)
    — never a mix of exact-score sources within one batch."""
    m = unit_rows(200, 16)
    db = _fill(db_path, m)
    rep = ReplicaEngine(precision="bf16", n_replicas=3)
    corpus = rep.ensure_fresh(db)
    assert corpus.replica_clones is not None
    q = unit_rows(9, 16)
    c = rep.candidate_count(5)

    # strip ONE clone's device mirrors (e.g. an HBM budget edge)
    object.__setattr__(corpus.replica_clones[0], "dev_rescore", None)
    object.__setattr__(corpus.replica_clones[0], "dev_emb", None)

    assert rep.topk_final(corpus, q, 5, c) is None
    vals, rows, exact = rep.topk_with_rescore(corpus, q, c)
    assert exact is None  # degrade together -> host rescore everywhere
    assert vals.shape[0] == 9 and rows.shape[0] == 9
    # candidate sets still correct per query
    for b in range(9):
        true_top = np.argsort(-(m @ q[b]))[:5]
        assert set(true_top.tolist()) <= set(rows[b].tolist())
    db.close()


def test_replica_pool_shutdown_on_close(tmp_path):
    """KB.close() must release the fan-out worker threads (a long-lived
    process opening/closing replica KBs must not accumulate them)."""
    import threading

    def replica_threads():
        return [
            t for t in threading.enumerate()
            if t.name.startswith("svs-tpu-replica") and t.is_alive()
        ]

    kb = KB(
        tmp_path / "s.sqlite",
        make_onehot_embedder(),
        force_fresh_db=True,
        replicas=3,
    )
    with kb.bulk_add_docs() as add:
        for i in range(8):
            add(f"vec:{i}")
    kb.retrieve_batch(["vec:1", "vec:2", "vec:3"], 1)  # spin up workers
    assert replica_threads()
    kb.close()
    assert kb.engine._pool is None
    import time

    for _ in range(50):  # workers exit asynchronously after shutdown
        if not replica_threads():
            break
        time.sleep(0.1)
    assert not replica_threads()


def test_replica_close_stops_secondary_uploaders(tmp_path, monkeypatch):
    """KB.close() must stop every replica's background uploads, not only
    the primary's: a secondary's mirror upload still running at
    interpreter exit aborts the process."""
    kb = KB(
        tmp_path / "s.sqlite",
        make_onehot_embedder(),
        force_fresh_db=True,
        replicas=3,
    )
    with kb.bulk_add_docs() as add:
        for i in range(8):
            add(f"vec:{i}")
    kb.retrieve_batch(["vec:1", "vec:2", "vec:3"], 1)
    stopped = []
    for eng in kb.engine._secondaries:
        real = eng.shutdown
        monkeypatch.setattr(
            eng, "shutdown", lambda real=real: (stopped.append(1), real())
        )
    kb.close()
    assert len(stopped) == len(kb.engine._secondaries) == 2


def test_replica_host_fallback_never_resplits(db_path, unit_rows):
    """The parent engine's host-rescore fallback must not re-enter the
    replica splitter (virtual dispatch): each slice runs single-chip at
    ITS batch size instead of splitting the work twice."""
    m = unit_rows(300, 16)
    db = _fill(db_path, m)
    rep = ReplicaEngine(
        precision="bf16", n_replicas=3, device_rescore="host"
    )
    corpus = rep.ensure_fresh(db)
    assert corpus.dev_rescore is None  # host mode: fallback path taken

    calls = []
    orig = ReplicaEngine._plan

    def spying(self, c, q):
        calls.append(q.shape[0])
        return orig(self, c, q)

    ReplicaEngine._plan = spying  # type: ignore[method-assign]
    try:
        q = unit_rows(12, 16)
        vals, rows, exact = rep.topk_with_rescore(
            corpus, q, rep.candidate_count(5)
        )
    finally:
        ReplicaEngine._plan = orig  # type: ignore[method-assign]
    assert exact is None
    # exactly ONE fan-out (the outer topk_with_rescore); the per-slice
    # host fallback must not have re-planned at nested batch sizes
    assert calls == [12], calls
    for b in range(12):
        true_top = np.argsort(-(m @ q[b]))[:5]
        assert set(true_top.tolist()) <= set(rows[b].tolist())
    db.close()


def test_replica_shutdown_race_degrades_inline(db_path, unit_rows):
    """A search overlapping close(): the pool may vanish between
    planning and running — slices then run inline (correct results,
    no internal error)."""
    m = unit_rows(128, 16)
    db = _fill(db_path, m)
    rep = ReplicaEngine(precision="bf16", n_replicas=3)
    corpus = rep.ensure_fresh(db)
    rep.shutdown()  # pool gone; clones + secondaries still exist
    q = unit_rows(9, 16)
    c = rep.candidate_count(5)  # overprovision absorbs bf16 prescore err
    vals, rows = rep.topk(corpus, q, c)
    assert rows.shape == (9, min(c, 128))
    for b in range(9):
        true_top = np.argsort(-(m @ q[b]))[:5]
        assert set(true_top.tolist()) <= set(rows[b].tolist())
    db.close()


def test_replica_pool_recreated_on_reopen(db_path, unit_rows):
    """AsyncKB documents reopen-after-close; ensure_fresh must re-arm
    the fan-out pool so a reopened replica KB keeps its throughput."""
    m = unit_rows(64, 16)
    db = _fill(db_path, m)
    rep = ReplicaEngine(precision="bf16", n_replicas=3)
    rep.ensure_fresh(db)
    rep.shutdown()
    assert rep._pool is None
    corpus = rep.ensure_fresh(db)
    assert rep._pool is not None  # re-armed
    vals, rows = rep.topk(corpus, unit_rows(6, 16), 3)
    assert rows.shape == (6, 3)
    rep.shutdown()
    db.close()


def test_replica_argument_validation(tmp_path):
    with pytest.raises(ValueError, match="mutually exclusive"):
        from svs_tpu.parallel import default_mesh

        KB(
            tmp_path / "x.sqlite",
            make_onehot_embedder(),
            force_fresh_db=True,
            mesh=default_mesh(),
            replicas=2,
        )
    with pytest.raises(ValueError, match="replicas"):
        import jax

        KB(
            tmp_path / "y.sqlite",
            make_onehot_embedder(),
            force_fresh_db=True,
            device=jax.devices()[0],
            replicas=2,
        )
    with pytest.raises(ValueError):
        ReplicaEngine(n_replicas=0)
    with pytest.raises(ValueError):
        ReplicaEngine(n_replicas=10_000)


def test_replica_filtered_retrieval(tmp_path):
    """Filtered retrieval on a replica KB: the pre-filter subset route
    runs on the primary (correct results; batch split applies to the
    unfiltered path) and agrees exactly with the post-filter ladder."""
    kb = KB(
        tmp_path / "rf.sqlite",
        make_onehot_embedder(),
        force_fresh_db=True,
        replicas=4,
    )
    with kb.bulk_add_docs() as add:
        for i in range(64):
            add(f"doc {i}", meta={"b": i % 4})
    qs = [f"doc {q}" for q in range(8)]
    filt = kb.retrieve_batch(qs, 3, where={"b": 2})
    ladder = kb.retrieve_batch(
        qs, 3, where=lambda d: d["meta"]["b"] == 2
    )
    key = lambda rs: [
        [(h["doc"]["id"], h["score"]) for h in r] for r in rs
    ]
    assert key(filt) == key(ladder)
    assert all(h["doc"]["meta"]["b"] == 2 for r in filt for h in r)
    kb.close()
