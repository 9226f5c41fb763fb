"""Sync KB facade tests (mirrors the reference's KB suite,
``tests/test_kb.py:1464-2011``): lifecycle, bulk ops, retrieval ordering
with deterministic embedders, KV dunders, graph, rollback, escape guards."""

import numpy as np
import pytest

from svs_tpu import KB, make_mock_embeddings_func
from svs_tpu.store import Database

from kb_helpers import make_angle_embedder, make_onehot_embedder


def test_init_creates_db_and_stores_params(db_path):
    kb = KB(db_path, make_mock_embeddings_func())
    kb.close()
    # reopen with no func: rebuilt from stored params
    kb2 = KB(db_path)
    with kb2.bulk_add_docs() as add:
        add("hello")
    assert len(kb2) == 1
    kb2.close()


def test_init_no_func_anywhere_raises(db_path):
    with pytest.raises(RuntimeError, match="No embedding function"):
        KB(db_path)
    assert not db_path.exists() or True  # ctor cleanup must not crash


def test_force_fresh_db(db_path):
    kb = KB(db_path, make_mock_embeddings_func())
    with kb.bulk_add_docs() as add:
        add("old")
    kb.close()
    kb2 = KB(db_path, make_mock_embeddings_func(), force_fresh_db=True)
    assert len(kb2) == 0
    kb2.close()


def test_retrieve_ordering_deterministic(db_path):
    kb = KB(db_path, make_angle_embedder(), rescore=True)
    with kb.bulk_add_docs() as add:
        for deg in [0, 10, 20, 45, 90, 180]:
            add(f"angle:{deg}")
    hits = kb.retrieve("angle:12", 3)
    assert [h["doc"]["text"] for h in hits] == ["angle:10", "angle:20", "angle:0"]
    assert hits[0]["score"] > hits[1]["score"] > hits[2]["score"]
    # scores are exact f32 cosines (rescored)
    assert hits[0]["score"] == pytest.approx(np.cos(np.radians(2)), abs=1e-6)
    kb.close()


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_retrieve_precisions_agree(db_path, precision):
    kb = KB(db_path, make_onehot_embedder(), precision=precision)
    with kb.bulk_add_docs() as add:
        for i in range(12):
            add(f"vec:{i}")
    hits = kb.retrieve("vec:7", 1)
    assert hits[0]["doc"]["text"] == "vec:7"
    assert hits[0]["score"] == pytest.approx(1.0, abs=1e-6)
    kb.close()


def test_retrieve_via_fused_kernel(db_path, fused_interpret):
    """kernel='auto' routes retrieval through the fused GPU kernel where
    it applies (run by the Pallas interpreter here) — same exact
    results as the XLA route."""
    texts = [f"angle:{deg}" for deg in range(0, 360, 6)]
    texts += [f"angle:{d / 6:.4f}" for d in range(1, 2160) if d % 36]
    kb = KB(db_path, make_angle_embedder(), kernel="auto")
    with kb.bulk_add_docs() as add:
        for t in texts:
            add(t)
    queries = ["angle:12", "angle:204"]
    hits = kb.retrieve_batch(queries, 3)  # batched: the fused route
    assert fused_interpret, "fused kernel never dispatched"
    kb.close()
    xla = KB(db_path, make_angle_embedder(), kernel="xla")
    assert xla.retrieve_batch(queries, 3) == hits
    assert [h[0]["doc"]["text"] for h in hits] == queries
    xla.close()


def test_retrieve_batch(db_path):
    kb = KB(db_path, make_onehot_embedder())
    with kb.bulk_add_docs() as add:
        for i in range(8):
            add(f"vec:{i}")
    results = kb.retrieve_batch(["vec:2", "vec:5"], 1)
    assert [r[0]["doc"]["text"] for r in results] == ["vec:2", "vec:5"]
    kb.close()


def test_retrieve_n_larger_than_corpus(db_path):
    kb = KB(db_path, make_onehot_embedder())
    with kb.bulk_add_docs() as add:
        add("vec:1"), add("vec:2")
    assert len(kb.retrieve("vec:1", 50)) == 2
    kb.close()


def test_retrieve_batch_empty_list(db_path):
    kb = KB(db_path, make_onehot_embedder())
    with kb.bulk_add_docs() as add:
        add("vec:1")
    assert kb.retrieve_batch([], 5) == []
    kb.close()


def test_retrieve_empty_corpus(db_path):
    kb = KB(db_path, make_onehot_embedder())
    assert kb.retrieve("vec:1", 5) == []
    kb.close()


def test_no_embedding_docs_excluded_from_retrieval(db_path):
    kb = KB(db_path, make_onehot_embedder())
    with kb.bulk_add_docs() as add:
        add("vec:1")
        add("vec:2", no_embedding=True)
    hits = kb.retrieve("vec:2", 5)
    assert [h["doc"]["text"] for h in hits] == ["vec:1"]
    kb.close()


def test_bulk_add_rollback_on_exception(db_path):
    kb = KB(db_path, make_mock_embeddings_func())
    with pytest.raises(RuntimeError, match="boom"):
        with kb.bulk_add_docs() as add:
            add("doomed")
            raise RuntimeError("boom")
    assert len(kb) == 0
    kb.close()


def test_bulk_add_rollback_on_embedding_failure(db_path):
    async def flaky(texts):
        raise ConnectionError("provider down")

    kb = KB(db_path, flaky)
    with pytest.raises(ConnectionError):
        with kb.bulk_add_docs() as add:
            add("doomed")
    assert len(kb) == 0
    kb.close()


def test_escape_guard(db_path):
    kb = KB(db_path, make_mock_embeddings_func())
    with kb.bulk_add_docs() as add:
        add("x")
    with pytest.raises(AssertionError):
        add("outside")
    with kb.bulk_query_docs() as q:
        pass
    with pytest.raises(AssertionError):
        q.count()
    kb.close()


def test_bulk_del_and_hierarchy(db_path):
    kb = KB(db_path, make_mock_embeddings_func())
    with kb.bulk_add_docs() as add:
        root = add("root")
        kid = add("kid", parent_id=root, meta={"tag": "t"})
    with kb.bulk_query_docs() as q:
        assert q.count() == 2
        assert q.query_doc(kid)["level"] == 1
        assert [d["id"] for d in q.query_children(root)] == [kid]
        assert [d["id"] for d in q.query_level(0)] == [root]
        assert [d["id"] for d in q.dfs_traversal()] == [root, kid]
        q.update_doc_meta(kid, {"tag": "u"})
        assert q.query_doc(kid)["meta"] == {"tag": "u"}
    with pytest.raises(RuntimeError):
        with kb.bulk_del_docs() as dd:
            dd(root)  # still has a child
    with kb.bulk_del_docs() as dd:
        dd(kid)
        dd(root)
    assert len(kb) == 0
    kb.close()


def test_keyval_dunder_protocol(db_path):
    kb = KB(db_path, make_mock_embeddings_func())
    with kb.bulk_keyval_update() as kv:
        assert len(kv) == 0
        kv["a"] = 1
        kv.set("b", "two")
        assert kv["a"] == 1 and kv.get("b") == "two"
        assert "a" in kv and "z" not in kv
        assert kv.get("z", None) is None
        with pytest.raises(KeyError):
            kv["z"]
        assert sorted(kv) == ["a", "b"]
        assert sorted(kv.items()) == [("a", 1), ("b", "two")]
        del kv["a"]
        with pytest.raises(KeyError):
            kv.remove("a")
        assert kv.count() == 1
    # persists across transactions
    with kb.bulk_keyval_update() as kv:
        assert kv["b"] == "two"
    kb.close()


def test_graph_update_and_networkx(db_path):
    import networkx as nx

    kb = KB(db_path, make_mock_embeddings_func())
    with kb.bulk_add_docs() as add:
        a, b, r = add("a"), add("b"), add("rel")
    with kb.bulk_graph_update() as g:
        assert g.count_edges() == 0
        e1 = g.add_edge(a, b, r, weight=0.5)
        e2 = g.add_directed_edge(b, a, r)
        assert g.count_edges() == 2
        graph = g.build_networkx_graph(multigraph=False)
        assert isinstance(graph, nx.DiGraph)
        g.del_edge(e2)
        assert g.count_edges() == 1
    kb.close()


def test_graph_edges_enumeration(db_path):
    """edges() lists id-bearing rows with the undirected flag intact —
    the enumeration a networkx export loses (svs_tpu extension)."""
    kb = KB(db_path, make_mock_embeddings_func())
    with kb.bulk_add_docs() as add:
        a, b, r = add("a"), add("b"), add("rel")
    with kb.bulk_graph_update() as g:
        e1 = g.add_edge(a, b, r, weight=0.5)
        e2 = g.add_directed_edge(b, a, r)
        rows = g.edges()
        assert rows == [
            {"id": e1, "a": a, "b": b, "relationship": r, "weight": 0.5,
             "directed": False},
            {"id": e2, "a": b, "b": a, "relationship": r, "weight": None,
             "directed": True},
        ]
        # paging
        assert g.edges(limit=1) == rows[:1]
        assert g.edges(limit=5, offset=1) == rows[1:]
        assert g.edges(offset=1) == rows[1:]
        # enumerate-then-delete is the use case ids exist for
        g.del_edge(rows[0]["id"])
        assert [e["id"] for e in g.edges()] == [e2]
    kb.close()


def test_pairwise_scores(db_path):
    kb = KB(db_path, make_angle_embedder())
    with kb.bulk_add_docs() as add:
        for deg in [0, 5, 90]:
            add(f"angle:{deg}")
    pairs = kb.document_top_pairwise_scores(2)
    assert len(pairs) == 2
    score, d1, d2 = pairs[0]
    assert {d1["text"], d2["text"]} == {"angle:0", "angle:5"}
    assert score == pytest.approx(np.cos(np.radians(5)), abs=1e-6)
    kb.close()


def test_close_gzip_and_reopen(db_path):
    kb = KB(db_path, make_mock_embeddings_func())
    with kb.bulk_add_docs() as add:
        add("persisted")
    kb.close(vacuum=True, also_gzip=True)
    gz = f"{db_path}.gz"
    kb2 = KB(gz)
    assert len(kb2) == 1
    kb2.close()


def test_len(db_path):
    kb = KB(db_path, make_mock_embeddings_func())
    assert len(kb) == 0
    with kb.bulk_add_docs() as add:
        add("1"), add("2")
    assert len(kb) == 2
    kb.close()


def test_concurrent_threads_share_one_kb(db_path):
    """Multiple threads retrieving while another adds docs: the per-KB lock
    and engine freshness tracking must keep every result coherent."""
    import threading

    kb = KB(db_path, make_onehot_embedder())
    with kb.bulk_add_docs() as add:
        for i in range(8):
            add(f"vec:{i}")

    errors = []

    def reader(tid):
        try:
            for i in range(10):
                q = f"vec:{(tid + i) % 8}"
                hits = kb.retrieve(q, 1)
                assert hits[0]["doc"]["text"] == q, (tid, i, hits)
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    def writer():
        try:
            for i in range(3):
                with kb.bulk_add_docs() as add:
                    add(f"extra {i}", no_embedding=True)
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(4)]
    threads.append(threading.Thread(target=writer))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    kb.close()


def test_retrieval_reflects_mutations(db_path):
    """The device corpus must refresh after adds and deletes."""
    kb = KB(db_path, make_onehot_embedder())
    with kb.bulk_add_docs() as add:
        add("vec:1")
    assert kb.retrieve("vec:3", 1)[0]["doc"]["text"] == "vec:1"
    with kb.bulk_add_docs() as add:
        v3 = add("vec:3")
    assert kb.retrieve("vec:3", 1)[0]["doc"]["text"] == "vec:3"
    with kb.bulk_del_docs() as dd:
        dd(v3)
    assert kb.retrieve("vec:3", 1)[0]["doc"]["text"] == "vec:1"
    kb.close()


def test_device_rescore_results_match_host_rescore(db_path):
    """End-to-end: retrieval under the on-device rescore returns the same
    documents and ordering as device_rescore='host' (the np.dot path);
    scores agree to f32 accumulation tolerance and 'host' mode stays
    bit-identical to the reference math."""
    import numpy as np

    from kb_helpers import make_onehot_embedder

    kb = KB(db_path, make_onehot_embedder(), force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(12):
            add(f"vec:{i}")
    assert kb.engine.corpus is None or True
    dev_hits = kb.retrieve_batch([f"vec:{i}" for i in range(4)], 3)
    kb.close()

    kb2 = KB(db_path, make_onehot_embedder(), device_rescore="host")
    host_hits = kb2.retrieve_batch([f"vec:{i}" for i in range(4)], 3)
    kb2.close()

    for dh, hh in zip(dev_hits, host_hits):
        assert [x["doc"]["id"] for x in dh] == [x["doc"]["id"] for x in hh]
        for a, b in zip(dh, hh):
            assert abs(a["score"] - b["score"]) <= 3e-5


def test_device_pairwise_rescore_matches_host_rescore(db_path):
    """document_top_pairwise_scores under the on-device pair rescore
    returns the same pairs and ordering as device_rescore='host' (the
    blocked host-gather path); scores agree to f32 accumulation
    tolerance and 'host' mode stays bit-identical to the reference
    math."""
    from kb_helpers import make_onehot_embedder

    kb = KB(db_path, make_onehot_embedder(), force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(14):
            add(f"vec:{i % 7}")  # planted duplicates -> strong top pairs
    corpus = kb._ensure_engine_fresh()
    assert corpus.dev_rescore is not None  # mirror built on CPU backend
    dev_pairs = kb.document_top_pairwise_scores(6)
    kb.close()

    kb2 = KB(db_path, make_onehot_embedder(), device_rescore="host")
    host_pairs = kb2.document_top_pairwise_scores(6)
    kb2.close()

    assert len(dev_pairs) == len(host_pairs) == 6
    for (sa, da1, da2), (sb, db1, db2) in zip(dev_pairs, host_pairs):
        assert (da1["id"], da2["id"]) == (db1["id"], db2["id"])
        assert abs(sa - sb) <= 3e-5


def test_pairwise_widen_teaches_width_hint(db_path, monkeypatch):
    """A pairwise call that had to widen teaches the engine's hint, so
    the NEXT call starts at the working width (one candidate pass)."""
    from kb_helpers import make_onehot_embedder

    kb = KB(db_path, make_onehot_embedder(), force_fresh_db=True)
    with kb.bulk_add_docs() as add:
        for i in range(30):
            add(f"vec:{i % 15}")

    widths = []
    real = kb.engine.pairwise_topk

    def spy(corpus, c):
        widths.append(c)
        return real(corpus, c)

    monkeypatch.setattr(kb.engine, "pairwise_topk", spy)
    first = kb.document_top_pairwise_scores(5)
    n_first = len(widths)
    second = kb.document_top_pairwise_scores(5)
    assert first == second
    if n_first > 1:  # the first call widened: the hint must stick
        assert widths[n_first:] == [widths[n_first - 1]]
    else:  # no widen needed: the second call repeats the base width
        assert widths == [widths[0]] * 2
    kb.close()


# -- filtered retrieval (where=; svs_tpu extension) ---------------------------


def _bucket_where(want):
    return lambda d: (d["meta"] or {}).get("bucket") == want


def test_retrieve_filtered_matches_oracle(db_path):
    """Filtered top-n == filter applied to the full exact ranking: the
    predicate runs host-side over an exact prefix, so survivors are the
    exact filtered top-n (see kb._filter_round)."""
    from kb_helpers import make_angle_embedder

    kb = KB(db_path, make_angle_embedder(), rescore=True)
    with kb.bulk_add_docs() as add:
        for deg in range(0, 180, 5):
            add(f"angle:{deg}", meta={"bucket": deg % 3})
    where = _bucket_where(0)
    hits = kb.retrieve("angle:47", 4, where=where)
    assert len(hits) == 4 and all(where(h["doc"]) for h in hits)
    full = kb.retrieve("angle:47", len(kb))
    oracle = [h for h in full if where(h["doc"])][:4]
    assert [(h["doc"]["id"], h["score"]) for h in hits] == [
        (h["doc"]["id"], h["score"]) for h in oracle
    ]
    kb.close()


def test_retrieve_filtered_widens_to_reach_rare_matches(db_path):
    """Matches ranked below the initial 4n over-fetch prefix force the
    ladder to widen (spied) and still come back exact."""
    from kb_helpers import make_angle_embedder

    kb = KB(db_path, make_angle_embedder(), rescore=True)
    with kb.bulk_add_docs() as add:
        for deg in range(0, 180, 5):  # 36 docs; query angle 0
            add(f"angle:{deg}", meta={"far": deg >= 165})
    searches = []
    real = kb._search_hydrated

    def spy(corpus, vectors, n):
        searches.append(n)
        return real(corpus, vectors, n)

    kb._search_hydrated = spy
    # the 3 matching docs (165/170/175 degrees) are the WORST-ranked for
    # an angle-0 query: the first prefix (m = 4*3 = 12) cannot hold them
    hits = kb.retrieve("angle:0", 3, where=lambda d: (d["meta"] or {})["far"])
    assert [h["doc"]["text"] for h in hits] == [
        "angle:165", "angle:170", "angle:175"
    ]
    assert len(searches) >= 2 and searches[0] == 12
    assert searches[-1] == 36  # terminal round covered the corpus
    kb.close()


def test_retrieve_filtered_fewer_matches_than_n(db_path):
    """A corpus holding fewer matches than n returns just the matches
    (after the ladder proves it covered the whole corpus)."""
    from kb_helpers import make_angle_embedder

    kb = KB(db_path, make_angle_embedder(), rescore=True)
    with kb.bulk_add_docs() as add:
        for deg in range(0, 90, 10):
            add(f"angle:{deg}", meta={"bucket": 1 if deg == 40 else 2})
    hits = kb.retrieve("angle:0", 5, where=_bucket_where(1))
    assert [h["doc"]["text"] for h in hits] == ["angle:40"]
    assert kb.retrieve("angle:0", 5, where=_bucket_where(99)) == []
    kb.close()


def test_retrieve_batch_filtered_mixed_satisfaction(db_path):
    """Per-query convergence: an easy query (matches everywhere) and a
    hard one (matches only at the bottom) in ONE batch both come back
    exact; the easy one must not be re-searched in widen rounds."""
    from kb_helpers import make_angle_embedder

    kb = KB(db_path, make_angle_embedder(), rescore=True)
    with kb.bulk_add_docs() as add:
        for deg in range(0, 180, 5):
            add(f"angle:{deg}", meta={"far": deg >= 165})
    batch_sizes = []
    real = kb._search_hydrated

    def spy(corpus, vectors, n):
        batch_sizes.append(vectors.shape[0])
        return real(corpus, vectors, n)

    kb._search_hydrated = spy
    res = kb.retrieve_batch(["angle:0", "angle:0"], 2, where=lambda d: True)
    assert all(len(r) == 2 for r in res)
    first_rounds = len(batch_sizes)
    batch_sizes.clear()
    res2 = kb.retrieve_batch(["angle:0"] * 2, 2, where=lambda d: (d["meta"] or {})["far"])
    assert all(
        [h["doc"]["text"] for h in r] == ["angle:165", "angle:170"]
        for r in res2
    )
    assert first_rounds == 1  # all-matching filter satisfied round one
    kb.close()


def test_retrieve_filtered_predicate_exception_propagates(db_path):
    from kb_helpers import make_angle_embedder

    kb = KB(db_path, make_angle_embedder())
    with kb.bulk_add_docs() as add:
        add("angle:0")

    def boom(doc):
        raise RuntimeError("predicate exploded")

    with pytest.raises(RuntimeError, match="predicate exploded"):
        kb.retrieve("angle:0", 1, where=boom)
    kb.close()
