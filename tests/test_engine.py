"""Engine tests: pack/freshness lifecycle, sidecar cold start, rescore
exactness, and the empty-corpus edge cases."""

import numpy as np
import pytest

from svs_tpu.engine import RetrievalEngine, sidecar_path_for
from svs_tpu.engine.packing import pack_corpus
from svs_tpu.engine.sidecar import load_sidecar, save_sidecar
from svs_tpu.store import Database, embedding_to_bytes
from svs_tpu.utils.topk_np import top_k_numpy


def _fill(db_path, vectors):
    db = Database(db_path)
    with db.transaction() as tx:
        for i, v in enumerate(vectors):
            tx.add_doc(f"d{i}", None, None, embedding_to_bytes(list(map(float, v))))
        tx.bump_matrix_version()
    return db


def test_ensure_fresh_packs_and_caches(db_path, unit_rows):
    m = unit_rows(50, 16)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="f32")
    c1 = eng.ensure_fresh(db)
    assert c1.n_valid == 50 and c1.dim == 16
    assert c1.n_padded % 256 == 0 and c1.dim_padded == 128
    assert eng.ensure_fresh(db) is c1  # cached, no repack

    # a mutation (bump + new row) invalidates
    with db.transaction() as tx:
        tx.add_doc("new", None, None, embedding_to_bytes([1.0] + [0.0] * 15))
        tx.bump_matrix_version()
    c2 = eng.ensure_fresh(db)
    assert c2 is not c1 and c2.n_valid == 51
    db.close()


def test_fingerprint_catches_foreign_writes(db_path, unit_rows):
    """Writes from ANOTHER connection that don't bump matrix_version (e.g.
    the reference implementation on a shared file) are detected via
    SQLite's data_version pragma."""
    m = unit_rows(10, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="f32")
    c1 = eng.ensure_fresh(db)
    foreign = Database(db_path)  # separate connection, like the reference
    with foreign.transaction() as tx:  # note: no bump_matrix_version
        tx.add_doc("foreign", None, None, embedding_to_bytes([1.0] * 8))
    foreign.close()
    c2 = eng.ensure_fresh(db)
    assert c2.n_valid == 11
    db.close()


def test_topk_rescore_pipeline_is_exact(db_path, unit_rows):
    m = unit_rows(300, 24)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")  # rescore defaults on
    corpus = eng.ensure_fresh(db)
    q = unit_rows(1, 24)[0]
    c = eng.candidate_count(10)
    vals, rows = eng.topk(corpus, q, c)
    emb_ids = corpus.emb_ids[rows[0]]
    with db.transaction() as tx:
        exact = tx.fetch_embedding_rows(emb_ids) @ q
    final = [int(emb_ids[i]) for _, i in top_k_numpy(exact, 10)]
    oracle_rows = [i for _, i in top_k_numpy(m @ q, 10)]
    oracle_ids = [int(corpus.emb_ids[i]) for i in oracle_rows]
    assert final == oracle_ids
    db.close()


def test_topk_empty_corpus(db_path):
    db = Database(db_path)
    eng = RetrievalEngine()
    corpus = eng.ensure_fresh(db)
    assert corpus.n_valid == 0
    vals, rows = eng.topk(corpus, np.zeros((1, 0), np.float32), 5)
    assert vals.shape == (1, 0)
    db.close()


def test_pairwise_topk_via_engine(db_path, unit_rows):
    m = unit_rows(120, 16)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="f32")
    corpus = eng.ensure_fresh(db)
    vals, ra, rb = eng.pairwise_topk(corpus, 5)
    from svs_tpu.utils.topk_np import top_pairs_numpy

    oracle = top_pairs_numpy(m @ m.T, 5)
    assert list(zip(ra, rb)) == [(r, c) for _, r, c in oracle]
    db.close()


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_incremental_append_no_full_repack(db_path, unit_rows, precision, monkeypatch):
    """Adding docs after a pack appends to the device matrix instead of
    rescanning every BLOB (full rebuild is sabotaged to prove it)."""
    from svs_tpu.store.tx import Tx
    from svs_tpu.utils.topk_np import top_k_numpy

    m1 = unit_rows(40, 8)
    db = _fill(db_path, m1)
    eng = RetrievalEngine(precision=precision)
    c1 = eng.ensure_fresh(db)

    m2 = unit_rows(300, 8)  # forces buffer growth past 256-row padding
    with db.transaction() as tx:
        for i, v in enumerate(m2):
            tx.add_doc(f"x{i}", None, None,
                       embedding_to_bytes(list(map(float, v))))
        tx.bump_matrix_version()

    def boom(self):
        raise AssertionError("full repack should not happen")

    monkeypatch.setattr(Tx, "build_embeddings_matrix", boom)
    c2 = eng.ensure_fresh(db)
    assert c2.n_valid == 340
    assert c2.n_padded % 256 == 0 and c2.n_padded >= 340

    full = np.concatenate([m1, m2])
    q = unit_rows(1, 8)[0]
    vals, rows = eng.topk(c2, q, 5)
    emb_ids = c2.emb_ids[rows[0]]
    with db.transaction() as tx:
        exact = tx.fetch_embedding_rows(emb_ids) @ q
    got = [int(emb_ids[i]) for _, i in top_k_numpy(exact, 5)]
    oracle_rows = [i for _, i in top_k_numpy(full @ q, 5)]
    assert got == [int(c2.emb_ids[i]) for i in oracle_rows]
    db.close()


def test_incremental_append_not_used_after_delete(db_path, unit_rows):
    """A delete breaks append-only detection -> full repack, still correct."""
    m = unit_rows(20, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="f32")
    eng.ensure_fresh(db)
    with db.transaction() as tx:
        doc_id = tx.doc_id_for_emb_id(int(eng.corpus.emb_ids[0]))
        tx.del_doc(doc_id)
        tx.add_doc("new", None, None, embedding_to_bytes([1.0] * 8))
        tx.bump_matrix_version()
    c2 = eng.ensure_fresh(db)
    assert c2.n_valid == 20  # 20 - 1 + 1
    db.close()


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_sidecar_roundtrip(db_path, unit_rows, tmp_path, precision):
    m = unit_rows(70, 12)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision=precision)
    c1 = eng.ensure_fresh(db)
    side = tmp_path / "s.svsx"
    eng.write_sidecar(side)

    # a fresh engine loads from the sidecar without touching BLOBs
    eng2 = RetrievalEngine(precision=precision)
    c2 = eng2.ensure_fresh(db, sidecar_path=side)
    assert c2.n_valid == c1.n_valid and c2.version == c1.version
    np.testing.assert_array_equal(c2.emb_ids, c1.emb_ids)
    np.testing.assert_array_equal(np.asarray(c2.data), np.asarray(c1.data))
    db.close()


def test_sidecar_stale_is_ignored(db_path, unit_rows, tmp_path):
    m = unit_rows(30, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="f32")
    eng.ensure_fresh(db)
    side = tmp_path / "s.svsx"
    eng.write_sidecar(side)

    with db.transaction() as tx:
        tx.add_doc("new", None, None, embedding_to_bytes([1.0] * 8))
        tx.bump_matrix_version()

    eng2 = RetrievalEngine(precision="f32")
    c2 = eng2.ensure_fresh(db, sidecar_path=side)  # stale -> rebuilt
    assert c2.n_valid == 31
    db.close()


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_sidecar_written_from_host_pack_matches_device(
    db_path, unit_rows, tmp_path, precision
):
    """write_sidecar after a fresh pack uses the host bytes (no device
    pull); the file must load back identical to the device copy."""
    m = unit_rows(40, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision=precision)
    c1 = eng.ensure_fresh(db)
    assert eng._host_pack is not None
    side = tmp_path / "s.svsx"
    eng.write_sidecar(side)
    loaded = load_sidecar(side)
    assert loaded is not None
    data, scales, ids, header = loaded
    np.testing.assert_array_equal(np.asarray(data), np.asarray(c1.data))
    db.close()


def test_sidecar_after_incremental_append_uses_device_bytes(
    db_path, unit_rows, tmp_path
):
    """After an in-place append the cached host bytes are stale — the
    sidecar must reflect the device state, not the old pack."""
    m = unit_rows(10, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="f32")
    eng.ensure_fresh(db)
    with db.transaction() as tx:  # fits within the 256-row padding
        tx.add_doc("new", None, None, embedding_to_bytes([1.0] + [0.0] * 7))
        tx.bump_matrix_version()
    c2 = eng.ensure_fresh(db)
    assert c2.n_valid == 11
    side = tmp_path / "s.svsx"
    eng.write_sidecar(side)
    data, scales, ids, header = load_sidecar(side)
    assert header["n_valid"] == 11
    np.testing.assert_array_equal(np.asarray(data), np.asarray(c2.data))
    db.close()


def test_sidecar_stale_even_without_version_bump(db_path, unit_rows, tmp_path):
    """A foreign writer (e.g. the reference impl) mutates embeddings WITHOUT
    bumping matrix_version — the sidecar must still be recognized as stale
    via the count/max-id fingerprint."""
    m = unit_rows(30, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="f32")
    eng.ensure_fresh(db)
    side = tmp_path / "s.svsx"
    eng.write_sidecar(side)

    foreign = Database(db_path)  # separate connection (the realistic case)
    with foreign.transaction() as tx:  # no bump_matrix_version
        tx.add_doc("foreign", None, None, embedding_to_bytes([1.0] * 8))
    foreign.close()

    eng2 = RetrievalEngine(precision="f32")
    c2 = eng2.ensure_fresh(db, sidecar_path=side)
    assert c2.n_valid == 31  # rebuilt, not served stale from the sidecar
    db.close()


def test_sidecar_precision_mismatch_rebuilds(db_path, unit_rows, tmp_path):
    m = unit_rows(30, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")
    eng.ensure_fresh(db)
    side = tmp_path / "s.svsx"
    eng.write_sidecar(side)
    eng2 = RetrievalEngine(precision="int8")
    c2 = eng2.ensure_fresh(db, sidecar_path=side)
    assert c2.precision == "int8" and c2.row_scales is not None
    db.close()


def test_incremental_append_on_sidecar_loaded_corpus(db_path, unit_rows, tmp_path):
    """Open from sidecar, then bulk-add: the append fast path must work on
    a sidecar-loaded corpus too (fingerprint carried through the load)."""
    m = unit_rows(40, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")
    eng.ensure_fresh(db)
    side = tmp_path / "s.svsx"
    eng.write_sidecar(side)

    eng2 = RetrievalEngine(precision="bf16")
    c1 = eng2.ensure_fresh(db, sidecar_path=side)  # loaded via mmap
    with db.transaction() as tx:
        tx.add_doc("new", None, None, embedding_to_bytes([1.0] + [0.0] * 7))
        tx.bump_matrix_version()

    from svs_tpu.store.tx import Tx

    original = Tx.build_embeddings_matrix
    calls = []
    Tx.build_embeddings_matrix = lambda self: calls.append(1) or original(self)
    try:
        c2 = eng2.ensure_fresh(db, sidecar_path=side)
    finally:
        Tx.build_embeddings_matrix = original
    assert c2.n_valid == 41
    assert calls == []  # appended incrementally, no rescan
    db.close()


def test_sidecar_corrupt_file_ignored(tmp_path):
    bad = tmp_path / "bad.svsx"
    bad.write_bytes(b"not a sidecar at all")
    assert load_sidecar(bad) is None
    assert load_sidecar(tmp_path / "missing.svsx") is None


def test_sidecar_path_for():
    assert str(sidecar_path_for("/x/y.sqlite")).endswith("y.sqlite.svsx")

def test_foreign_delete_insert_reusing_rowid_detected(db_path, unit_rows):
    """A foreign re-embed done as DELETE+INSERT reuses the freed max rowid,
    so (count, max id) is unchanged — the trigger-maintained generation is
    what forces the repack.  Served-stale here means retrieval silently
    returns the OLD vector's neighbors."""
    m = unit_rows(10, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="f32")
    c1 = eng.ensure_fresh(db)

    foreign = Database(db_path)  # like the reference on a shared file
    with foreign.transaction() as tx:  # no bump_matrix_version
        doc_id = tx.doc_id_for_emb_id(int(c1.emb_ids[-1]))
        tx.set_doc_embedding(doc_id, embedding_to_bytes([1.0] + [0.0] * 7))
    foreign.close()

    c2 = eng.ensure_fresh(db)
    assert c2 is not c1  # repacked
    new_row = np.asarray(c2.data)[len(m) - 1, :8]
    np.testing.assert_allclose(new_row, [1.0] + [0.0] * 7, atol=1e-6)
    db.close()


def test_write_sidecar_skipped_when_loaded_from_it(db_path, unit_rows, tmp_path):
    """Warm load from a fresh sidecar then write_sidecar to the same path:
    must be a no-op (no device->host pull, no byte-identical rewrite)."""
    m = unit_rows(30, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")
    eng.ensure_fresh(db)
    side = tmp_path / "s.svsx"
    eng.write_sidecar(side)

    eng2 = RetrievalEngine(precision="bf16")
    eng2.ensure_fresh(db, sidecar_path=side)
    import svs_tpu.engine.index as index_mod

    def boom(*a, **kw):
        raise AssertionError("write_sidecar should have been skipped")

    orig = index_mod.save_sidecar
    index_mod.save_sidecar = boom
    try:
        eng2.write_sidecar(side)  # no-op: loaded from this very file
    finally:
        index_mod.save_sidecar = orig
    db.close()


def test_write_sidecar_after_append_uses_host_bytes(db_path, unit_rows, tmp_path):
    """Sidecar load -> incremental append -> write_sidecar must stream the
    host-side mirror (memmap + appended rows), never pull the device copy."""
    m = unit_rows(20, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")
    eng.ensure_fresh(db)
    side = tmp_path / "s.svsx"
    eng.write_sidecar(side)

    eng2 = RetrievalEngine(precision="bf16")
    eng2.ensure_fresh(db, sidecar_path=side)
    with db.transaction() as tx:
        tx.add_doc("new", None, None, embedding_to_bytes([1.0] + [0.0] * 7))
        tx.bump_matrix_version()
    c2 = eng2.ensure_fresh(db, sidecar_path=side)
    assert c2.n_valid == 21

    import svs_tpu.engine.index as index_mod

    seen = {}
    orig = index_mod.save_sidecar

    def spy(path, corpus, fingerprint=None, host_pack=None):
        seen["host_pack"] = host_pack
        return orig(path, corpus, fingerprint=fingerprint, host_pack=host_pack)

    index_mod.save_sidecar = spy
    try:
        eng2.write_sidecar(side)
    finally:
        index_mod.save_sidecar = orig
    assert seen["host_pack"] is not None  # streamed from host, no device pull
    np.testing.assert_array_equal(
        np.asarray(seen["host_pack"].data), np.asarray(c2.data)
    )
    # and the rewritten sidecar round-trips
    eng3 = RetrievalEngine(precision="bf16")
    c3 = eng3.ensure_fresh(db, sidecar_path=side)
    np.testing.assert_array_equal(np.asarray(c3.data), np.asarray(c2.data))
    db.close()


def test_topk_against_superseded_corpus_still_consistent(db_path, unit_rows):
    """The search API takes the pack as an argument: a caller holding an
    older pack (because a writer repacked concurrently) still gets results
    consistent with THAT pack — row indices resolve through its emb_ids."""
    m = unit_rows(50, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="f32")
    c1 = eng.ensure_fresh(db)

    with db.transaction() as tx:  # concurrent writer: delete + add => repack
        tx.del_doc(tx.doc_id_for_emb_id(int(c1.emb_ids[0])))
        tx.add_doc("new", None, None, embedding_to_bytes([1.0] + [0.0] * 7))
        tx.bump_matrix_version()
    c2 = eng.ensure_fresh(db)
    assert c2 is not c1

    q = unit_rows(1, 8)[0]
    vals, rows = eng.topk(c1, q, 5)  # search the OLD pack
    oracle = [i for _, i in top_k_numpy(m @ q, 5)]
    assert list(rows[0]) == oracle  # rows index c1's layout, not c2's
    db.close()


@pytest.mark.parametrize("precision", ["bf16", "int8", "f32"])
def test_wide_index_engine_path(db_path, unit_rows, precision, monkeypatch):
    """Engine dispatch past the wide-index threshold (lowered for the test):
    results must match the narrow path exactly — no 2^24 scale cliff."""
    import svs_tpu.engine.index as index_mod

    m = unit_rows(600, 16)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision=precision)
    corpus = eng.ensure_fresh(db)
    q = unit_rows(2, 16)
    vals_narrow, rows_narrow = eng.topk(corpus, q, 7)

    monkeypatch.setattr(index_mod, "WIDE_INDEX_MIN_ROWS", 1)
    vals_wide, rows_wide = eng.topk(corpus, q, 7)
    np.testing.assert_array_equal(rows_narrow, rows_wide)
    np.testing.assert_array_equal(vals_narrow, vals_wide)
    db.close()


def test_pairwise_topk_int8_no_dequant(db_path, unit_rows):
    """int8 pairwise runs quantized blocks directly; prescore pairs must
    match the int8-dequantized oracle (exact ordering restored later by the
    KB rescore, which test_rescore_exactness covers)."""
    m = unit_rows(100, 16)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="int8", rescore=False)
    corpus = eng.ensure_fresh(db)
    vals, ra, rb = eng.pairwise_topk(corpus, 5)

    q = np.asarray(corpus.data, dtype=np.float32)[: corpus.n_valid]
    s = np.asarray(corpus.row_scales)[: corpus.n_valid]
    deq = q * s[:, None]
    from svs_tpu.utils.topk_np import top_pairs_numpy

    oracle = top_pairs_numpy(deq @ deq.T, 5)
    assert list(zip(ra, rb)) == [(r, c) for _, r, c in oracle]
    np.testing.assert_allclose(vals, [v for v, _, _ in oracle], atol=1e-5)
    db.close()


@pytest.mark.parametrize("kernel,ok", [
    ("auto", True), ("xla", True), ("pallas", False), ("extract", False),
])
def test_kernel_option_accepts_auto_and_xla(kernel, ok):
    """``kernel`` keeps only the values that select something: 'auto'
    (the fused GPU kernel where it applies) and 'xla'; both work with
    every precision and with a mesh."""
    import jax

    if not ok:
        with pytest.raises(ValueError, match="unknown kernel"):
            RetrievalEngine(kernel=kernel)
        return
    for precision in ("f32", "bf16", "int8", "auto"):
        assert RetrievalEngine(precision=precision, kernel=kernel).kernel == kernel
    devs = jax.devices()
    mesh = jax.sharding.Mesh(np.array(devs), ("data",))
    assert RetrievalEngine(kernel=kernel, mesh=mesh).precision == "int8"


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_large_corpus_uses_extraction_kernel(db_path, unit_rows, precision):
    """Past the large-row threshold the pack is block-aligned, rows are
    shuffled, and auto dispatch runs the extraction kernel — f32 results
    must match the oracle exactly through the permutation; reduced
    precisions must cover the true top-k in their candidate set (exact
    ordering is the KB rescore's job, proven in test_rescore_exactness)."""
    from svs_tpu.engine.packing import LARGE_ROW_MULTIPLE

    n = LARGE_ROW_MULTIPLE + 100  # crosses the threshold -> 2 blocks padded
    m = unit_rows(n, 16)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision=precision)
    corpus = eng.ensure_fresh(db)
    assert corpus.n_padded % LARGE_ROW_MULTIPLE == 0
    assert corpus.n_padded >= 2 * LARGE_ROW_MULTIPLE
    # rows were permuted: emb_ids is not the identity-ish insertion order
    assert not np.array_equal(corpus.emb_ids, np.sort(corpus.emb_ids))

    q = unit_rows(3, 16)
    exact = m @ q.T
    if precision == "f32":
        vals, rows = eng.topk(corpus, q, 9)
        for b in range(3):
            oracle_ids = [
                int(i) + 1 for _, i in top_k_numpy(exact[:, b], 9)
            ]  # emb ids are 1-based insertion order here
            got_ids = [int(corpus.emb_ids[r]) for r in rows[b]]
            assert got_ids == oracle_ids, b
    else:
        c = eng.candidate_count(9)
        vals, rows = eng.topk(corpus, q, c)
        for b in range(3):
            true_ids = {int(i) + 1 for _, i in top_k_numpy(exact[:, b], 9)}
            got_ids = {int(corpus.emb_ids[r]) for r in rows[b]}
            assert true_ids <= got_ids, (precision, b)
    db.close()


def test_rescore_cache_attached_and_snapshot_consistent(db_path, unit_rows):
    """Packs built from a scan carry the f32 rows in pack order — the
    rescore gather source (SQLite IN-fetches measured 4-6 s per 256-query
    batch at 1M docs; the cache is a NumPy take)."""
    m = unit_rows(60, 12)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")
    corpus = eng.ensure_fresh(db)
    assert corpus.host_f32 is not None
    assert corpus.host_f32.shape == (60, 12)
    # row i of the cache is the store row for emb_ids[i]
    with db.transaction() as tx:
        fetched = tx.fetch_embedding_rows([int(e) for e in corpus.emb_ids])
    np.testing.assert_array_equal(corpus.host_f32, fetched)
    db.close()


def test_rescore_cache_size_gate(db_path, unit_rows, monkeypatch):
    m = unit_rows(40, 8)
    db = _fill(db_path, m)
    monkeypatch.setenv("SVS_TPU_RESCORE_CACHE_MAX_BYTES", "0")
    eng = RetrievalEngine(precision="bf16")
    corpus = eng.ensure_fresh(db)
    assert corpus.host_f32 is None
    # rescore still works through the store-fetch fallback
    q = m[3:4]
    vals, rows = eng.topk(corpus, q, eng.candidate_count(5))
    assert rows.shape[1] >= 5
    db.close()


def test_rescore_cache_follows_incremental_append(db_path, unit_rows):
    m = unit_rows(50, 16)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")
    c1 = eng.ensure_fresh(db)
    assert c1.host_f32 is not None
    extra = unit_rows(7, 16)
    with db.transaction() as tx:
        for i, v in enumerate(extra):
            tx.add_doc(
                f"x{i}", None, None,
                embedding_to_bytes(list(map(float, v))),
            )
        tx.bump_matrix_version()
    c2 = eng.ensure_fresh(db)
    assert c2.n_valid == 57 and c2.host_f32 is not None
    assert c2.host_f32.shape == (57, 16)
    with db.transaction() as tx:
        fetched = tx.fetch_embedding_rows([int(e) for e in c2.emb_ids])
    np.testing.assert_array_equal(c2.host_f32, fetched)
    db.close()


def test_sidecar_loaded_pack_mmaps_published_rescore_cache(
    db_path, unit_rows, tmp_path
):
    """Sidecars written from a scan-built pack carry the f32 rescore
    cache; loading one attaches it (mmap) with NO background rebuild."""
    m = unit_rows(30, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")
    eng.ensure_fresh(db)
    side = tmp_path / "s.svsidecar"
    eng.write_sidecar(side)

    eng2 = RetrievalEngine(precision="bf16")
    c2 = eng2.ensure_fresh(db, sidecar_path=side)
    assert c2.host_f32 is not None  # published cache, mmap'd
    assert eng2._cache_rebuild_thread is None  # nothing to rebuild
    rows = (
        c2.host_f32
        if c2.host_row_map is None
        else c2.host_f32[c2.host_row_map]
    )
    with db.transaction() as tx:
        fetched = tx.fetch_embedding_rows([int(e) for e in c2.emb_ids])
    np.testing.assert_array_equal(rows, fetched)
    db.close()


def test_f32_sidecar_cold_start_reuses_pack_no_rescan(
    db_path, unit_rows, tmp_path
):
    """f32 sidecars omit the f32 cache on purpose (the pack IS the exact
    bytes); loading one must reuse the mmap'd pack as the host gather
    source — NO background store rescan, NO RAM duplicate — and the
    reused view must match the store rows bit-for-bit."""
    m = unit_rows(30, 12)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="f32")
    eng.ensure_fresh(db)
    side = tmp_path / "s.svsidecar"
    eng.write_sidecar(side)

    eng2 = RetrievalEngine(precision="f32")
    c2 = eng2.ensure_fresh(db, sidecar_path=side)
    assert c2.host_f32 is not None  # the pack view, not a rebuilt cache
    assert c2.host_row_map is None  # pack order by construction
    assert eng2._cache_rebuild_thread is None  # zero-scan promise holds
    assert c2.host_f32.shape == (30, 12)
    with db.transaction() as tx:
        fetched = tx.fetch_embedding_rows([int(e) for e in c2.emb_ids])
    np.testing.assert_array_equal(c2.host_f32, fetched)
    # the full exact pipeline runs against the reused view
    q = m[11:12]
    vals, rows = eng2.topk(c2, q, eng2.candidate_count(5))
    assert int(c2.emb_ids[rows[0][0]]) == 12
    db.close()


def test_fused_native_pack_matches_stepwise_and_maps_rows(
    monkeypatch, unit_rows
):
    """The fused permute+pad+cast native pack must produce byte-identical
    device data to the step-by-step path, and its unpermuted rescore cache
    must map pack rows correctly through host_row_map."""
    from svs_tpu.engine import packing
    from svs_tpu import native as native_mod

    monkeypatch.setattr(packing, "PERMUTE_MIN_ROWS", 64)
    m = unit_rows(100, 16)
    ids = np.arange(1, 101, dtype=np.int64)

    for precision in ("f32", "bf16", "int8"):
        c_native = packing.pack_corpus(m, ids, version=1, precision=precision)
        monkeypatch.setenv("SVS_TPU_NO_NATIVE", "1")
        c_plain = packing.pack_corpus(m, ids, version=1, precision=precision)
        monkeypatch.delenv("SVS_TPU_NO_NATIVE")

        np.testing.assert_array_equal(c_native.emb_ids, c_plain.emb_ids)
        np.testing.assert_array_equal(
            np.asarray(c_native.data).view(np.uint8),
            np.asarray(c_plain.data).view(np.uint8),
        )
        if precision == "int8":
            np.testing.assert_array_equal(
                np.asarray(c_native.row_scales), np.asarray(c_plain.row_scales)
            )

        # rescore-cache row mapping: pack row r is the store row emb_ids[r]
        for corpus in (c_native, c_plain):
            assert corpus.host_f32 is not None
            for r in (0, 7, 63, 99):
                row = (
                    corpus.host_f32[corpus.host_row_map[r]]
                    if corpus.host_row_map is not None
                    else corpus.host_f32[r]
                )
                np.testing.assert_array_equal(row, m[corpus.emb_ids[r] - 1])
        if native_mod.native_available():
            assert c_native.host_row_map is not None  # fused kept it unpermuted
        assert c_plain.host_row_map is None  # fallback permuted the cache


def test_sidecar_rescore_cache_rebuilt_in_background(
    db_path, unit_rows, tmp_path
):
    """After a cold start from a CACHE-LESS sidecar (pre-publish format,
    or one that exceeded the cache size limit) the rescore cache is
    rebuilt by a background scan and attached to the live corpus — mapped
    correctly through host_row_map — but never attached if the store
    moved."""
    m = unit_rows(30, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")
    eng.ensure_fresh(db)
    side = tmp_path / "s.svsidecar"
    # strip the pack's host cache so the written sidecar has no f32 section
    object.__setattr__(eng._corpus, "host_cache", None)
    eng.write_sidecar(side)

    eng2 = RetrievalEngine(precision="bf16")
    c2 = eng2.ensure_fresh(db, sidecar_path=side)
    assert eng2._cache_rebuild_thread is not None
    eng2._cache_rebuild_thread.join(timeout=30)
    assert c2.host_f32 is not None
    with db.transaction() as tx:
        fetched = tx.fetch_embedding_rows([int(e) for e in c2.emb_ids])
    rows = (
        c2.host_f32
        if c2.host_row_map is None
        else c2.host_f32[c2.host_row_map]
    )
    np.testing.assert_array_equal(rows, fetched)

    # store moves between load and rebuild -> cache must not attach
    eng3 = RetrievalEngine(precision="bf16")

    orig = eng3._spawn_rescore_cache_rebuild
    captured = {}

    def capture(db_path_, corpus, fingerprint):
        captured["args"] = (db_path_, corpus, fingerprint)

    eng3._spawn_rescore_cache_rebuild = capture  # defer the thread
    c3 = eng3.ensure_fresh(db, sidecar_path=side)
    with db.transaction() as tx:
        tx.add_doc("new", None, None, embedding_to_bytes([1.0] + [0.0] * 7))
        tx.bump_matrix_version()
    orig(*captured["args"])  # now run the rebuild against the moved store
    eng3._cache_rebuild_thread.join(timeout=30)
    assert c3.host_f32 is None  # fingerprint mismatch -> never attached
    db.close()


def test_incremental_append_declined_on_empty_pack(db_path, unit_rows):
    """An empty pack has no established dim — appending onto it must
    trigger a full repack, not a crash."""
    db = Database(db_path)
    with db.transaction() as tx:
        tx.bump_matrix_version()
    eng = RetrievalEngine(precision="bf16")
    c0 = eng.ensure_fresh(db)
    assert c0.n_valid == 0
    m = unit_rows(5, 8)
    with db.transaction() as tx:
        for i, v in enumerate(m):
            tx.add_doc(f"d{i}", None, None, embedding_to_bytes(list(map(float, v))))
        tx.bump_matrix_version()
    c1 = eng.ensure_fresh(db)
    assert c1.n_valid == 5 and c1.dim == 8
    vals, rows = eng.topk(c1, m[2:3], 3)
    assert rows.shape == (1, 3)
    db.close()


def test_fused_route_not_refused_for_wide_corpora():
    """Corpora past 2^24 padded rows keep the fused GPU kernel (its rows
    travel as int32, so no f32-index ceiling applies), and the rescore
    bound is the precision's own term at any size."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from svs_tpu.engine.index import WIDE_INDEX_MIN_ROWS
    from svs_tpu.ops.fused_topk import BLOCK_N, fused_route

    n_pad = WIDE_INDEX_MIN_ROWS + 2 * BLOCK_N
    assert fused_route("gpu", 256, n_pad, 1536, 400, jnp.bfloat16)
    assert fused_route("gpu", 256, n_pad, 1536, 400, jnp.int8)
    assert not fused_route("cpu", 256, n_pad, 1536, 400, jnp.bfloat16)
    eng = RetrievalEngine(precision="bf16")
    fake = SimpleNamespace(
        n_padded=n_pad, dim_padded=1536, n_valid=n_pad - 100,
        precision="bf16", scale_max=0.0, dim=1536,
    )
    q = np.zeros((4, 1536), np.float32)
    np.testing.assert_allclose(
        eng.prescore_eps(fake, q, 400), 2.0**-8 * (1 + 2.0**-9) + 3e-5
    )


def test_device_rescore_mirror_and_exact_scores(db_path, unit_rows):
    """With the device mirror built, topk_with_rescore returns exact f32
    candidate scores (within float32 accumulation tolerance of the host
    dot), and device_rescore='host' keeps the mirror off entirely."""
    m = unit_rows(300, 24)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")  # device_rescore defaults auto
    corpus = eng.ensure_fresh(db)
    assert corpus.dev_rescore is not None
    q = unit_rows(3, 24)
    vals, rows, exact = eng.topk_with_rescore(corpus, q, 40)
    assert exact is not None and exact.shape == (3, 40)
    for b in range(3):
        host_exact = corpus.host_f32[
            rows[b] if corpus.host_row_map is None
            else corpus.host_row_map[rows[b]]
        ] @ q[b].astype(np.float32)
        np.testing.assert_allclose(exact[b], host_exact, atol=3e-5)

    eng2 = RetrievalEngine(precision="bf16", device_rescore="host")
    c2 = eng2.ensure_fresh(db)
    assert c2.dev_rescore is None
    _, _, none_exact = eng2.topk_with_rescore(c2, q, 40)
    assert none_exact is None
    db.close()


def test_device_rescore_budget_gate(db_path, unit_rows, monkeypatch):
    m = unit_rows(64, 16)
    db = _fill(db_path, m)
    monkeypatch.setenv("SVS_TPU_DEVICE_RESCORE_MAX_BYTES", "10")
    eng = RetrievalEngine(precision="bf16")
    corpus = eng.ensure_fresh(db)
    assert corpus.dev_rescore is None  # over budget -> host path
    monkeypatch.setenv("SVS_TPU_DEVICE_RESCORE_MAX_BYTES", "0")
    eng.invalidate()
    assert eng.ensure_fresh(db).dev_rescore is None  # 0 disables
    db.close()


def test_mirror_uploads_in_background_above_sync_threshold(
    db_path, unit_rows, monkeypatch
):
    """Mirrors past _MIRROR_SYNC_MAX_BYTES must not block ensure_fresh
    (the 6 GB cold-start case): the first query runs on the host rescore
    fallback with exact results, and once the background uploader
    publishes, the device path returns the same candidates."""
    import svs_tpu.engine.index as index_mod

    monkeypatch.setattr(index_mod, "_MIRROR_SYNC_MAX_BYTES", 0)
    m = unit_rows(300, 24)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")
    corpus = eng.ensure_fresh(db)
    q = unit_rows(3, 24)
    # the mirror may already have landed (tiny upload) — but ensure_fresh
    # itself must have returned without one attached synchronously, which
    # we can only observe via the thread having been spawned at all
    assert eng._mirror_thread is not None
    vals_early, rows_early, _ = eng.topk_with_rescore(corpus, q, 40)
    eng._mirror_thread.join(timeout=30)
    assert not eng._mirror_thread.is_alive()
    assert corpus.dev_rescore is not None  # published by the uploader
    vals_late, rows_late, exact = eng.topk_with_rescore(corpus, q, 40)
    np.testing.assert_array_equal(rows_early, rows_late)
    assert exact is not None
    db.close()


def test_mirror_chunked_upload_matches_whole(db_path, unit_rows, monkeypatch):
    """The staged-copy uploader (multiple dynamic_update_slice chunks,
    including a ragged tail) must produce a bit-identical mirror."""
    import svs_tpu.engine.index as index_mod

    m = unit_rows(300, 24)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")
    corpus = eng.ensure_fresh(db)
    cache_f32, _ = corpus.host_cache
    # 300 rows x 24 f32 = 96 B/row; 7 rows/chunk -> 43 chunks + tail
    monkeypatch.setattr(index_mod, "_MIRROR_CHUNK_BYTES", 7 * 24 * 4)
    staged = np.asarray(eng._upload_f32_mirror(cache_f32))
    np.testing.assert_array_equal(staged, np.asarray(cache_f32))
    db.close()


def test_mirror_background_publish_skips_superseded_corpus(
    db_path, unit_rows
):
    """A mirror built for a pack that was replaced mid-upload must be
    discarded, never attached to the stale corpus object."""
    m = unit_rows(64, 16)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")
    corpus = eng.ensure_fresh(db)
    cache_f32, row_map = corpus.host_cache
    object.__setattr__(corpus, "dev_rescore", None)
    object.__setattr__(corpus, "dev_emb", None)
    eng.invalidate()  # corpus is no longer current
    eng._upload_and_publish_mirror(
        corpus, cache_f32, row_map, check_current=True
    )
    assert corpus.dev_rescore is None and corpus.dev_emb is None
    db.close()


def test_mirror_straggler_honors_spawn_time_stop_event(
    db_path, unit_rows, monkeypatch
):
    """shutdown() re-arms _mirror_stop with a fresh Event after its join
    attempt; an upload thread that outlives the join must still abort on
    the OLD event it captured at spawn time — if it re-read the engine
    attribute it would see the new, unset event and keep uploading past
    the close."""
    import threading

    import svs_tpu.engine.index as index_mod

    monkeypatch.setattr(index_mod, "_MIRROR_SYNC_MAX_BYTES", 0)
    # Force many chunks so the throttle runs between them.
    monkeypatch.setattr(index_mod, "_MIRROR_CHUNK_BYTES", 7 * 24 * 4)
    m = unit_rows(300, 24)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")
    # Hold the throttle open: pretend a query is always in flight so the
    # uploader parks in _mirror_throttle instead of finishing instantly.
    eng._inflight = 1
    corpus = eng.ensure_fresh(db)
    t = eng._mirror_thread
    assert t is not None and t.is_alive()
    old_stop = eng._mirror_stop
    # Simulate the post-timeout re-arm WITHOUT waiting out the 30 s join:
    # swap in a fresh event first, then set the old one.
    eng._mirror_stop = threading.Event()
    old_stop.set()
    t.join(timeout=10)
    assert not t.is_alive()  # aborted on the captured event
    assert corpus.dev_rescore is None  # nothing published after abort
    eng._inflight = 0
    db.close()


def test_device_rescore_f32_reuses_pack(db_path, unit_rows):
    """f32 corpora rescore by default (the rescore stage owns the tie
    rule), and their device gather source is the PACK ITSELF — no second
    HBM copy is ever uploaded.  topk_with_rescore through the padded
    source returns exact f32 scores."""
    m = unit_rows(40, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="f32")
    assert eng.rescore  # default on for every precision
    corpus = eng.ensure_fresh(db)
    assert corpus.dev_rescore is not None
    assert corpus.dev_rescore[0] is corpus.data  # reuse, not a mirror
    assert corpus.dev_rescore[1] is None  # pack rows index it directly
    q = unit_rows(2, 8)
    _, rows, exact = eng.topk_with_rescore(corpus, q, 7)
    assert exact is not None
    for b in range(2):
        host_exact = m[
            np.asarray(corpus.emb_ids[rows[b]]) - 1
        ] @ q[b].astype(np.float32)
        np.testing.assert_allclose(exact[b], host_exact, atol=3e-5)
    # 'host' policy still disables it
    eng2 = RetrievalEngine(precision="f32", device_rescore="host")
    assert eng2.ensure_fresh(db).dev_rescore is None
    db.close()


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_fused_dispatch_and_eps(fused_interpret, precision):
    """The fused route: taken for bf16/int8 packs of supported shapes
    under kernel='auto', never under kernel='xla' or for f32 packs; the
    error bound is the same on every route; and it returns exact winners
    on a well-separated corpus."""
    n, d = 4096, 128
    m = np.zeros((n, d), dtype=np.float32)
    m[:, 1] = 1.0
    hot_rows = np.arange(32) * 120 + 11  # distinct, spread over tiles
    hot = (0.9 - np.arange(32) * 0.01).astype(np.float32)  # >> bf16 ulp
    m[hot_rows, 0] = hot
    m[hot_rows, 1] = np.sqrt(1.0 - hot**2)
    ids = np.arange(1, n + 1, dtype=np.int64)
    corpus = pack_corpus(m, ids, version=1, precision=precision, dim_multiple=d)
    calls = fused_interpret
    eng = RetrievalEngine(precision=precision)
    xla = RetrievalEngine(precision=precision, kernel="xla")
    q = np.zeros((4, d), dtype=np.float32)
    q[:, 0] = 1.0
    # f32 packs stay on XLA (the kernel's f32 dot has no tensor cores)
    assert eng._fused_route(corpus, 4, 40) is (precision != "f32")
    assert not xla._fused_route(corpus, 4, 40)
    np.testing.assert_array_equal(
        eng.prescore_eps(corpus, q, 40), xla.prescore_eps(corpus, q, 40)
    )
    vals, rows = eng.topk(corpus, q, 40)
    assert bool(calls) is (precision != "f32")
    got_ids = [int(corpus.emb_ids[r]) for r in rows[0][:32]]
    want_ids = [int(r) + 1 for r in hot_rows]  # descending-score order
    assert got_ids == want_ids
    xv, xr = xla.topk(corpus, q, 40)
    np.testing.assert_array_equal(rows[:, :32], xr[:, :32])


@pytest.mark.parametrize("route", ["xla", "fused"])
def test_margin_fires_on_hidden_cluster(request, route):
    """A cluster packed inside one bf16 ulp: the bf16 prescore cannot
    order it, so after the f32 rescore the k-th value must fail the
    margin check against the boundary prescore (the widen signal) — on
    every prescore route.  This is the soundness hinge of the rescore."""
    n, d = 4096, 128
    m = np.zeros((n, d), dtype=np.float32)
    m[:, 1] = 1.0
    n_cl = 1000
    cl_rows = np.arange(n_cl) * 4  # spread over every tile
    scores = (0.7 + np.arange(n_cl) * 1e-6).astype(np.float32)
    m[cl_rows, 0] = scores
    m[cl_rows, 1] = np.sqrt(1.0 - scores**2)
    ids = np.arange(1, n + 1, dtype=np.int64)
    corpus = pack_corpus(m, ids, version=1, precision="bf16", dim_multiple=d)
    if route == "fused":
        calls = request.getfixturevalue("fused_interpret")
    eng = RetrievalEngine(precision="bf16")
    q = np.zeros((4, d), dtype=np.float32)
    q[:, 0] = 1.0
    k = 10
    c = eng.candidate_count(k)
    pre_vals, rows = eng.topk(corpus, q, c)
    if route == "fused":
        assert calls
    eps = eng.prescore_eps(corpus, q, c)
    # f32 rescore of the candidates, as _finalize_batch does
    orig = corpus.emb_ids[rows[0]] - 1  # ids are insertion order here
    exact = (m[orig] @ q[0]).astype(np.float32)
    v_k = np.sort(exact)[::-1][k - 1]
    assert v_k < pre_vals[0, -1] + eps[0], (
        "margin must fire so the kb ladder widens"
    )


def test_topk_final_matches_host_selection(db_path, unit_rows):
    """The fully-on-device pipeline (topk_final: prescore -> rescore ->
    final top-k with the reference tie rule) must return exactly the
    (emb id, score) sequence the host finalize computes from
    topk_with_rescore — including ties, which break to the larger emb
    id (reference ``svs/util.py:190-203`` semantics)."""
    rng = np.random.default_rng(3)
    m = unit_rows(400, 24)
    # plant exact ties: rows 50..59 share one direction
    m[50:60] = m[50]
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")
    corpus = eng.ensure_fresh(db)
    assert corpus.dev_rescore is not None and corpus.dev_emb is not None
    q = np.concatenate([m[50:51], unit_rows(3, 24)], axis=0)
    n, c = 15, eng.candidate_count(15)
    final = eng.topk_final(corpus, q, n, c)
    assert final is not None
    emb, scores, boundary = final
    assert emb.shape == (4, n) and scores.shape == (4, n)
    assert boundary.shape == (4,)

    # host reference: topk_with_rescore + the _finalize_batch ordering
    pre_vals, pre_rows, exact = eng.topk_with_rescore(corpus, q, c)
    assert exact is not None
    emb_of = corpus.emb_ids[pre_rows]
    id_order = np.argsort(emb_of, axis=1, kind="stable")
    exact_o = np.take_along_axis(exact, id_order, axis=1)
    rows_o = np.take_along_axis(pre_rows, id_order, axis=1)
    rev = exact_o[:, ::-1]
    order_rev = np.argsort(-rev, axis=1, kind="stable")[:, :n]
    order = c - 1 - order_rev
    want_scores = np.take_along_axis(exact_o, order, axis=1)
    want_emb = corpus.emb_ids[np.take_along_axis(rows_o, order, axis=1)]
    np.testing.assert_array_equal(emb, want_emb)
    np.testing.assert_array_equal(scores, want_scores)
    # the planted tie block (identical vectors, emb ids 51..60 in
    # insertion order) must surface largest-emb-id first
    tied = emb[0][scores[0] >= scores[0][0] - 1e-7]
    assert len(tied) >= 10 and list(tied) == sorted(tied, reverse=True)
    db.close()


def test_topk_final_unavailable_paths(db_path, unit_rows):
    """topk_final returns None whenever its device mirrors are absent
    (host rescore policy / f32 precision) so callers fall back."""
    m = unit_rows(100, 16)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16", device_rescore="host")
    corpus = eng.ensure_fresh(db)
    assert eng.topk_final(corpus, unit_rows(2, 16), 5, 20) is None
    db.close()


def test_candidate_width_hint_learns_and_decays():
    """initial_candidates starts at the learned width after a widen and
    steps back down the x4 ladder after a streak of first-try successes
    — and every width it ever emits is a recurring static shape (the
    ladder values), so XLA's compile cache always hits."""
    eng = RetrievalEngine(precision="bf16")
    base = eng.candidate_count(100)
    assert eng.initial_candidates(100, 10**6) == base
    # a widen to 6400 (two ladder rungs) teaches the hint
    eng.record_candidates(100, 6400, widened=True)
    assert eng.initial_candidates(100, 10**6) == 6400
    # clamped by corpus size
    assert eng.initial_candidates(100, 500) == 500
    # first-try successes step it down one rung per streak; every width
    # seen along the way is on the ladder {base * 4^j}
    seen = set()
    for _ in range(3 * eng.HINT_PROBE_STREAK + 3):
        c = eng.initial_candidates(100, 10**6)
        seen.add(c)
        eng.record_candidates(100, c, widened=False)
    assert eng.initial_candidates(100, 10**6) == base
    assert seen <= {base, base * 4, base * 16}


def test_oversized_gather_falls_back_to_host(db_path, unit_rows, monkeypatch):
    """Widen retries can reach widths where the on-device [B, C, d] f32
    candidate gather alone would crowd out HBM — those must route to the
    host fallback, not OOM the chip."""
    import svs_tpu.utils.device_memory as device_memory

    m = unit_rows(300, 24)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16")
    corpus = eng.ensure_fresh(db)
    assert corpus.dev_rescore is not None
    q = unit_rows(4, 24)
    monkeypatch.setattr(device_memory, "gather_budget", lambda *a: 1)
    assert eng.topk_final(corpus, q, 5, 40) is None
    vals, rows, exact = eng.topk_with_rescore(corpus, q, 40)
    assert exact is None  # host path took over
    # and the candidate rows still match the per-query oracle
    for b in range(q.shape[0]):
        want = {i for _, i in top_k_numpy((m @ q[b]).astype(np.float32), 40)}
        assert set(rows[b].tolist()) == want
    db.close()


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_pairwise_eps_and_verified_result(unit_rows, precision):
    """``pairwise_eps`` is the storage precision's own term, and the
    blocked candidates + their boundary satisfy the margin contract that
    makes the KB's pairwise rescore provably exact."""
    n_valid, d = 600, 32
    m = unit_rows(n_valid, d)
    ids = np.arange(1, n_valid + 1, dtype=np.int64)
    corpus = pack_corpus(m, ids, version=1, precision=precision)
    eng = RetrievalEngine(precision=precision)
    bf16_term = 2.0**-8 * (1.0 + 2.0**-9) + 3e-5
    if precision == "f32":
        assert eng.pairwise_eps(corpus) == 1e-4
    elif precision == "bf16":
        assert eng.pairwise_eps(corpus) == bf16_term
    else:
        assert eng.pairwise_eps(corpus) > bf16_term
    k, c = 20, 84  # the KB's first-attempt widening for n=20
    vals, rows, cols = eng.pairwise_topk(corpus, c)
    # the margin contract, exactly as _finalize_pairwise runs it:
    # rescore candidates in f32, take top-k, k-th must clear the
    # boundary + eps; then the result IS the exhaustive oracle's top-k.
    exact = np.einsum("ij,ij->i", m[rows], m[cols])
    order = top_k_numpy(exact, k)
    v_k = order[-1][0]
    if v_k >= float(vals[-1]) + eng.pairwise_eps(corpus):
        got = [(int(rows[i]), int(cols[i])) for _, i in order]
        iu = np.triu_indices(n_valid, 1)
        flat = (m @ m.T)[iu]
        oracle = top_k_numpy(flat, k)
        want = [(int(iu[0][i]), int(iu[1][i])) for _, i in oracle]
        assert got == want
    else:
        assert precision != "f32", "f32 prescores must clear the margin"


def test_pairwise_rescore_device_matches_numpy(db_path, unit_rows):
    """``pairwise_rescore`` gathers both rows of each pair from the HBM
    mirror and dots them on-device; values must match the host f32 dot to
    accumulation tolerance, for bf16 (mirror) and f32 (pack-as-mirror)
    corpora, including the 8192-bucket padding path."""
    for precision in ("bf16", "f32"):
        m = unit_rows(150, 16)
        db = _fill(db_path, m)
        eng = RetrievalEngine(precision=precision)
        corpus = eng.ensure_fresh(db)
        rng = np.random.default_rng(3)
        ra = rng.integers(0, 150, size=777).astype(np.int64)
        rb = rng.integers(0, 150, size=777).astype(np.int64)
        exact = eng.pairwise_rescore(corpus, ra, rb)
        assert exact is not None and exact.shape == (777,)
        assert exact.dtype == np.float32
        # pack rows -> original rows via emb ids (emb id = row + 1 here)
        oa = np.asarray(corpus.emb_ids)[ra] - 1
        ob = np.asarray(corpus.emb_ids)[rb] - 1
        want = np.einsum("ij,ij->i", m[oa], m[ob])
        np.testing.assert_allclose(exact, want, atol=3e-5)
        db.close()
        db_path.unlink()

    # empty pair list short-circuits without a device call
    db = _fill(db_path, unit_rows(8, 8))
    eng = RetrievalEngine(precision="bf16")
    corpus = eng.ensure_fresh(db)
    out = eng.pairwise_rescore(
        corpus, np.zeros((0,), np.int64), np.zeros((0,), np.int64)
    )
    assert out is not None and out.shape == (0,)
    db.close()


def test_pairwise_rescore_declines_without_mirror(db_path, unit_rows):
    """Policy 'host' (and any other no-mirror state) returns None so the
    KB's finalize falls back to the host gather."""
    m = unit_rows(60, 8)
    db = _fill(db_path, m)
    eng = RetrievalEngine(precision="bf16", device_rescore="host")
    corpus = eng.ensure_fresh(db)
    assert corpus.dev_rescore is None
    assert eng.pairwise_rescore(
        corpus, np.arange(4, dtype=np.int64), np.arange(4, dtype=np.int64)
    ) is None
    db.close()


def test_pairwise_width_hint_learns_and_decays():
    """initial_pairwise_candidates mirrors the retrieve-side hint: starts
    at the learned width after a widen, steps back down the x4 ladder
    after a streak of first-try successes, and every width emitted is a
    recurring static shape (the ladder values)."""
    eng = RetrievalEngine(precision="bf16")
    base = eng.pairwise_candidate_base(10_000)
    assert base == 12_500
    assert eng.initial_pairwise_candidates(10_000, 10**6) == base
    eng.record_pairwise_candidates(10_000, 50_000, widened=True)
    assert eng.initial_pairwise_candidates(10_000, 10**6) == 50_000
    # clamped by the pair count
    assert eng.initial_pairwise_candidates(10_000, 300) == 300 * 299 // 2
    seen = set()
    for _ in range(2 * eng.HINT_PROBE_STREAK + 2):
        c = eng.initial_pairwise_candidates(10_000, 10**6)
        seen.add(c)
        eng.record_pairwise_candidates(10_000, c, widened=False)
    assert eng.initial_pairwise_candidates(10_000, 10**6) == base
    assert seen <= {base, 50_000}
    # pair and retrieve hints are independent tables
    assert eng.initial_candidates(10_000, 10**6) == eng.candidate_count(10_000)


def test_auto_precision_resolution():
    """'auto' = fastest storage whose RESULTS stay exact: int8 under the
    verified device rescore, bf16 wherever the int8 path doesn't apply
    (rescore off, host rescore, dim-sharded mesh).
    The requested value is preserved for introspection."""
    eng = RetrievalEngine(precision="auto")
    assert eng.precision == "int8"
    assert eng.requested_precision == "auto"
    assert RetrievalEngine(precision="auto", rescore=False).precision == "bf16"
    assert (
        RetrievalEngine(precision="auto", device_rescore="host").precision
        == "bf16"
    )
    assert RetrievalEngine(precision="auto", kernel="xla").precision == "int8"
    # explicit precisions resolve to themselves
    for p in ("f32", "bf16", "int8"):
        eng = RetrievalEngine(precision=p)
        assert eng.precision == p and eng.requested_precision == p
    with pytest.raises(ValueError, match="unknown precision"):
        RetrievalEngine(precision="fast")


def test_auto_precision_mesh_resolution():
    """1-D data meshes keep int8 (row scales shard with the rows); a
    dim-sharded 2-D mesh falls back to bf16."""
    import jax

    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs multiple devices")
    mesh1d = jax.sharding.Mesh(np.array(devs), ("data",))
    assert RetrievalEngine(precision="auto", mesh=mesh1d).precision == "int8"
    if len(devs) >= 4:
        mesh2d = jax.sharding.Mesh(
            np.array(devs[:4]).reshape(2, 2), ("data", "model")
        )
        eng = RetrievalEngine(precision="auto", mesh=mesh2d)
        assert eng.precision == "bf16"


def test_auto_precision_end_to_end(db_path, unit_rows):
    """A KB opened with precision='auto' retrieves exactly (vs the numpy
    oracle) through the int8 prescore + verified f32 rescore pipeline."""
    from svs_tpu import KB
    from tests.kb_helpers import make_angle_embedder

    kb = KB(db_path, make_angle_embedder(), force_fresh_db=True,
            precision="auto", sidecar=False)
    try:
        with kb.bulk_add_docs() as add:
            for i in range(120):
                add(f"angle:{i * 0.5}")
        assert kb.engine.precision == "int8"
        hits = kb.retrieve("angle:30.0", 5)
        assert hits[0]["doc"]["text"] == "angle:30.0"
        assert hits[0]["score"] == pytest.approx(1.0, abs=1e-6)
        # int8 storage, exact f32 results: nearest neighbours by angular
        # distance, scores strictly sorted
        assert {h["doc"]["text"] for h in hits[1:3]} == {
            "angle:29.5", "angle:30.5"
        }
        scores = [h["score"] for h in hits]
        assert scores == sorted(scores, reverse=True)
    finally:
        kb.close()


def test_xla_ladder_streams_past_scores_budget(
    db_path, unit_rows, monkeypatch
):
    """When the materializing [B, N] f32 score matrix would exceed the
    device's scores budget, the XLA path must dispatch the streaming
    exact path — and the results must be oracle-identical."""
    import svs_tpu.ops.topk as topk_mod
    import svs_tpu.utils.device_memory as device_memory

    m = unit_rows(300, 24)
    db = _fill(db_path, m)
    calls = []
    real = topk_mod.streaming_score_topk

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(device_memory, "scores_budget", lambda *a: 0)
    monkeypatch.setattr(topk_mod, "streaming_score_topk", spy)
    q = unit_rows(3, 24)
    for precision in ("bf16", "int8"):
        calls.clear()
        eng = RetrievalEngine(precision=precision, kernel="xla")
        corpus = eng.ensure_fresh(db)
        vals, rows, _ = eng.topk_with_rescore(corpus, q, 7)
        assert calls, f"streaming bottom not dispatched for {precision}"
        for b in range(3):
            oracle = {i for _, i in top_k_numpy(m @ q[b], 7)}
            got = set(np.asarray(rows)[b].tolist())
            # candidate sets from quantized prescores: near-total overlap
            assert len(got & oracle) >= 6


def test_prescore_budget_is_the_engines_device(db_path, unit_rows, monkeypatch):
    """The exact path is sized by the scores budget of the device the
    engine runs on, not by the process's first device."""
    import jax

    import svs_tpu.utils.device_memory as device_memory

    seen = []
    real = device_memory.scores_budget

    def spy(device=None):
        seen.append(device)
        return real(device)

    monkeypatch.setattr(device_memory, "scores_budget", spy)
    dev = jax.devices()[-1]
    db = _fill(db_path, unit_rows(40, 16))
    eng = RetrievalEngine(precision="bf16", device=dev, kernel="xla")
    corpus = eng.ensure_fresh(db)
    eng.topk_with_rescore(corpus, unit_rows(2, 16), 5)
    assert seen and all(d is dev for d in seen)
