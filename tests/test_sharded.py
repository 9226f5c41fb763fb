"""Multi-device property tests on the virtual 8-CPU-device mesh: sharded
retrieval must be *indistinguishable* from single-device retrieval."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from svs_tpu.engine.packing import pad_matrix, pad_queries
from svs_tpu.ops.quant import quantize_rows_int8
from svs_tpu.parallel import default_mesh, mesh_2d, sharded_score_topk
from svs_tpu.utils.topk_np import top_k_numpy


@pytest.fixture(scope="module")
def devices_available():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (see conftest)")


def _corpus(unit_rows, n=1000, d=64, b=4):
    m = unit_rows(n, d)
    q = unit_rows(b, d)
    mp = pad_matrix(m, row_multiple=256 * 8)  # divisible across 8 shards
    qp = pad_queries(q, mp.shape[1])
    return m, q, mp, qp


def test_sharded_1d_matches_oracle(devices_available, unit_rows):
    m, q, mp, qp = _corpus(unit_rows)
    mesh = default_mesh()
    docs = jax.device_put(jnp.asarray(mp), NamedSharding(mesh, P("data", None)))
    vals, idx = sharded_score_topk(
        docs, None, jnp.asarray(qp), jnp.int32(len(m)), 13, mesh=mesh
    )
    for b in range(q.shape[0]):
        oracle = top_k_numpy(m @ q[b], 13)
        assert list(np.asarray(idx)[b]) == [i for _, i in oracle]
        np.testing.assert_allclose(
            np.asarray(vals)[b], [s for s, _ in oracle], rtol=1e-5
        )


def test_sharded_2d_matches_oracle(devices_available, unit_rows):
    m, q, mp, qp = _corpus(unit_rows, d=100)  # pads to 128 = 2 x 64 cols
    mesh = mesh_2d(4, 2)
    docs = jax.device_put(jnp.asarray(mp), NamedSharding(mesh, P("data", "model")))
    vals, idx = sharded_score_topk(
        docs,
        None,
        jnp.asarray(qp),
        jnp.int32(len(m)),
        7,
        mesh=mesh,
        model_axis="model",
    )
    for b in range(q.shape[0]):
        oracle = top_k_numpy(m @ q[b], 7)
        assert list(np.asarray(idx)[b]) == [i for _, i in oracle]


def test_sharded_int8_covers_true_topk(devices_available, unit_rows):
    m, q, mp, qp = _corpus(unit_rows)
    mesh = default_mesh()
    qd, scales = quantize_rows_int8(jnp.asarray(mp))
    docs = jax.device_put(qd, NamedSharding(mesh, P("data", None)))
    sc = jax.device_put(scales, NamedSharding(mesh, P("data")))
    vals, idx = sharded_score_topk(
        docs, sc, jnp.asarray(qp), jnp.int32(len(m)), 50, mesh=mesh
    )
    for b in range(q.shape[0]):
        true = {i for _, i in top_k_numpy(m @ q[b], 10)}
        assert true <= set(np.asarray(idx)[b].tolist())


def test_sharded_int8_model_axis_rejected(devices_available, unit_rows):
    m, q, mp, qp = _corpus(unit_rows)
    mesh = mesh_2d(4, 2)
    qd, scales = quantize_rows_int8(jnp.asarray(mp))
    with pytest.raises(NotImplementedError):
        sharded_score_topk(
            qd, scales, jnp.asarray(qp), jnp.int32(len(m)), 5,
            mesh=mesh, model_axis="model",
        )


@pytest.mark.parametrize("n,k", [(500, 20), (1000, 7)])
def test_sharded_pairwise_matches_oracle(devices_available, unit_rows, n, k):
    from svs_tpu.parallel.pairwise_sharded import sharded_pairwise_topk
    from svs_tpu.utils.topk_np import top_pairs_numpy

    m = unit_rows(n, 32)
    mp = pad_matrix(m, row_multiple=8 * 8)
    mesh = default_mesh()
    docs = jax.device_put(jnp.asarray(mp), NamedSharding(mesh, P("data", None)))
    vals, rows, cols = sharded_pairwise_topk(
        docs, jnp.int32(n), k, mesh=mesh
    )
    oracle = top_pairs_numpy(m @ m.T, k)
    assert list(zip(np.asarray(rows), np.asarray(cols))) == [
        (r, c) for _, r, c in oracle
    ]
    np.testing.assert_allclose(
        np.asarray(vals), [s for s, _, _ in oracle], rtol=1e-4
    )


def test_sharded_k_larger_than_shard(devices_available, unit_rows):
    """k bigger than any single shard's row count still returns the exact
    global top-k (the per-shard k clamps to local rows)."""
    m, q, mp, qp = _corpus(unit_rows, n=900)
    mesh = default_mesh()
    docs = jax.device_put(jnp.asarray(mp), NamedSharding(mesh, P("data", None)))
    k = 400  # > 2048/8 = 256 rows per shard
    vals, idx = sharded_score_topk(
        docs, None, jnp.asarray(qp), jnp.int32(len(m)), k, mesh=mesh
    )
    oracle = [i for _, i in top_k_numpy(m @ q[0], k)]
    assert list(np.asarray(idx)[0]) == oracle


def test_sharded_per_shard_selection_matches_oracle(unit_rows):
    """Block-aligned shards with trailing padding (n_valid masks by
    GLOBAL row): the merged global top-k of the per-shard selections must
    match the single-device oracle exactly."""
    from svs_tpu.engine.packing import LARGE_ROW_MULTIPLE

    devices = jax.devices()[:2]
    mesh = default_mesh(devices=devices)
    n = 2 * LARGE_ROW_MULTIPLE  # one large block per shard
    m = unit_rows(n, 16)
    padded = np.zeros((n, 128), np.float32)
    padded[:, :16] = m
    docs = jax.device_put(padded, NamedSharding(mesh, P("data", None)))
    q = np.zeros((3, 128), np.float32)
    q[:, :16] = m[[7, 1000, 20000]][:, :16]
    n_valid = n - 57
    vals, idx = sharded_score_topk(
        docs, None, jnp.asarray(q), jnp.int32(n_valid), 9, mesh=mesh,
    )
    exact = m[:n_valid] @ m[[7, 1000, 20000]].T
    for b in range(3):
        oracle = [i for _, i in top_k_numpy(exact[:, b], 9)]
        assert list(np.asarray(idx)[b]) == oracle, b


def test_sharded_pairwise_escalates_and_subblocks(devices_available, unit_rows):
    """Sharded pairwise with (a) shard rows larger than the 256-row inner
    block (exercising the streamed sub-block scan) and (b) a
    near-duplicate cluster that overwhelms the first per-row width
    (exercising the verified escalation)."""
    from svs_tpu.parallel.pairwise_sharded import sharded_pairwise_topk
    from svs_tpu.ops import pairwise as pw
    from svs_tpu.utils.topk_np import top_pairs_numpy

    rng = np.random.default_rng(7)
    n = 4096  # 8 shards x 512 local rows -> 2 inner row-blocks per shard
    d = 16
    base = rng.standard_normal(d).astype(np.float32)
    m = np.zeros((n, d), dtype=np.float32)
    # 200 near-duplicates of one vector concentrated in the first rows,
    # the rest random background
    m[:200] = base[None, :] + 0.01 * rng.standard_normal((200, d))
    m[200:] = rng.standard_normal((n - 200, d))
    m /= np.linalg.norm(m, axis=1, keepdims=True)

    k = 150
    assert k > pw._ESCALATION[0]
    mesh = default_mesh()
    docs = jax.device_put(
        jnp.asarray(m), NamedSharding(mesh, P("data", None))
    )
    vals, rows, cols = sharded_pairwise_topk(docs, jnp.int32(n), k, mesh=mesh)
    oracle = top_pairs_numpy(m @ m.T, k)
    # values must match exactly; pairs up to ties at equal scores
    np.testing.assert_allclose(
        np.asarray(vals), [s for s, _, _ in oracle], rtol=1e-5
    )
    v_k = oracle[-1][0]
    sims = m @ m.T
    got = set(zip(np.asarray(rows).tolist(), np.asarray(cols).tolist()))
    np.testing.assert_allclose(
        sims[np.asarray(rows), np.asarray(cols)], np.asarray(vals), rtol=1e-5
    )
    iu = np.triu_indices(n, 1)
    flat = sims[iu]
    must_have = {
        (int(iu[0][i]), int(iu[1][i])) for i in np.nonzero(flat > v_k)[0]
    }
    assert must_have <= got

@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_sharded_candidate_contract(unit_rows, precision):
    """Per-shard selection inside shard_map: merged candidate values sit
    within the precision's prescore bound of the storage-model truth, and
    every document clearly above the k-th returned value is among them —
    the contract the engine's verified rescore consumes."""
    devices = jax.devices()[:2]
    mesh = default_mesh(devices=devices)
    n = 4096
    m = unit_rows(n, 16)
    padded = np.zeros((n, 128), np.float32)
    padded[:, :16] = m
    q_rows = [3, 900, 1700, 2500, 3100, 50, 1650, 4000]
    q = np.zeros((8, 128), np.float32)
    q[:, :16] = m[q_rows][:, :16]
    nv = n - 123
    k = 40
    if precision == "int8":
        di, rs = quantize_rows_int8(jnp.asarray(padded))
        docs = jax.device_put(di, NamedSharding(mesh, P("data", None)))
        scales = jax.device_put(rs, NamedSharding(mesh, P("data")))
        qi, qs = quantize_rows_int8(jnp.asarray(q))
        model = (
            np.asarray(qi, np.int32) @ np.asarray(di, np.int32).T
        ).astype(np.float32) * np.asarray(rs)[None, :] * np.asarray(qs)[:, None]
        eps = 1e-4
    else:
        docs = jax.device_put(
            jnp.asarray(padded, jnp.bfloat16),
            NamedSharding(mesh, P("data", None)),
        )
        scales = None
        model = (m[:, :16] @ m[q_rows][:, :16].T).T.astype(np.float32)
        eps = 2.0**-8 * (1 + 2.0**-9) + 3e-5
    vals, idx = sharded_score_topk(
        docs, scales, jnp.asarray(q), jnp.int32(nv), k, mesh=mesh
    )
    vals, idx = np.asarray(vals), np.asarray(idx)
    assert (idx >= 0).all() and (idx < nv).all()
    for b in range(8):
        assert len(set(idx[b].tolist())) == k
        model_of_returned = model[b][idx[b]]
        assert (np.abs(vals[b] - model_of_returned) <= eps).all()
        must_have = set(np.nonzero(model[b][:nv] > vals[b][-1] + eps)[0])
        assert must_have <= set(idx[b].tolist())


@pytest.mark.parametrize("precision,b", [
    ("bf16", 8), ("bf16", 32), ("int8", 8), ("int8", 32),
])
def test_engine_mesh_dispatch_verified_result(
    unit_rows, monkeypatch, precision, b
):
    """The engine's mesh branch routes through ``sharded_score_topk``
    with the same error bound as one device (the bound depends on the
    storage precision alone), and the rescored result matches the
    oracle exactly."""
    from svs_tpu.engine.index import RetrievalEngine
    from svs_tpu.engine.packing import pack_corpus
    from svs_tpu.parallel import sharded as sharded_mod

    calls = []
    real = sharded_mod.sharded_score_topk

    def spy(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return real(*args, **kwargs)

    monkeypatch.setattr(sharded_mod, "sharded_score_topk", spy)
    mesh = default_mesh(devices=jax.devices()[:2])
    n = 5000
    m = unit_rows(n, 16)
    eng = RetrievalEngine(precision=precision, mesh=mesh)
    single = RetrievalEngine(precision=precision)
    corpus = pack_corpus(
        m,
        np.arange(1, n + 1, dtype=np.int64),
        version=1,
        precision=precision,
        placement=eng._placement(),
        row_multiple=eng._row_multiple(n),
        dim_multiple=eng._dim_multiple(),
    )
    c = eng.candidate_count(10)
    q = m[:b].astype(np.float32)
    np.testing.assert_array_equal(
        eng.prescore_eps(corpus, q, c), single.prescore_eps(corpus, q, 4 * c)
    )
    vals, rows = eng.topk(corpus, q, c)
    assert calls, "mesh path must route through sharded_score_topk"
    for bi in range(b):
        cand = (corpus.emb_ids[rows[bi].astype(int)] - 1).astype(int)
        exact_cand = m[cand].astype(np.float32) @ q[bi]
        order = sorted(
            range(len(cand)), key=lambda i: (exact_cand[i], cand[i]),
            reverse=True,
        )
        got = sorted(int(cand[i]) for i in order[:10])
        oracle = sorted(i for _, i in top_k_numpy(m @ q[bi], 10))
        assert got == oracle, bi


def test_mesh_topk_final_matches_host_selection(devices_available, unit_rows):
    """Mesh analog of test_engine.test_topk_final_matches_host_selection:
    the sharded on-device pipeline (per-shard prescore -> per-shard exact
    f32 rescore where the rows live -> one psum -> replicated final
    selection, ``parallel.sharded.sharded_rescore_final``) must return
    exactly the (emb id, score) sequence host finalize computes — ties
    break to the larger emb id (reference ``svs/util.py:190-203``)."""
    from svs_tpu.engine.index import RetrievalEngine
    from svs_tpu.engine.packing import pack_corpus
    from svs_tpu.parallel import default_mesh

    m = unit_rows(500, 24)
    m[50:60] = m[50]  # exact ties: one direction, emb ids 51..60
    emb_ids = np.arange(1, 501, dtype=np.int64)
    eng = RetrievalEngine(precision="bf16", mesh=default_mesh())
    corpus = pack_corpus(
        m, emb_ids, version=1, precision="bf16",
        placement=eng._placement(),
        row_multiple=eng._row_multiple(500),
        dim_multiple=eng._dim_multiple(),
    )
    eng._maybe_build_device_rescore(corpus)
    assert corpus.dev_rescore is not None and corpus.dev_emb is not None
    q = np.concatenate([m[50:51], unit_rows(3, 24)], axis=0)
    n, c = 15, eng.candidate_count(15)
    final = eng.topk_final(corpus, q, n, c)
    assert final is not None
    emb, scores, boundary = final
    assert emb.shape == (4, n) and boundary.shape == (4,)

    # host reference ordering from topk_with_rescore (mesh -> host rescore)
    pre_vals, pre_rows, exact = eng.topk_with_rescore(corpus, q, c)
    assert exact is None  # mesh rescore lives in topk_final only
    exact = (m[pre_rows.astype(int)].astype(np.float32) @
             q.astype(np.float32)[:, :, None])[:, :, 0]
    for b in range(4):
        order = np.lexsort((-emb_ids[pre_rows[b].astype(int)], -exact[b]))[:n]
        want_emb = emb_ids[pre_rows[b][order].astype(int)]
        np.testing.assert_array_equal(emb[b], want_emb)
        np.testing.assert_allclose(scores[b], exact[b][order], atol=2e-6)
    # the planted tie block must surface largest-emb-id first
    tied = emb[0][scores[0] >= scores[0][0] - 1e-7]
    assert len(tied) >= 10 and list(tied)[:10] == sorted(tied, reverse=True)[:10]


def test_mesh_topk_final_f32_pack_reuse(devices_available, unit_rows):
    """f32 mesh corpora reuse the sharded PACK as the rescore mirror (no
    second HBM copy; padded width, so the query slice is skipped via
    ``_mirror_dim``) — the final on-device selection must still match the
    host tie-rule ordering exactly."""
    from svs_tpu.engine.index import RetrievalEngine
    from svs_tpu.engine.packing import pack_corpus
    from svs_tpu.parallel import default_mesh

    m = unit_rows(400, 20)
    m[30:38] = m[30]  # exact ties straddling k
    emb_ids = np.arange(1, 401, dtype=np.int64)
    eng = RetrievalEngine(precision="f32", mesh=default_mesh())
    corpus = pack_corpus(
        m, emb_ids, version=1, precision="f32",
        placement=eng._placement(),
        row_multiple=eng._row_multiple(400),
        dim_multiple=eng._dim_multiple(),
    )
    eng._maybe_build_device_rescore(corpus)
    assert corpus.dev_rescore is not None and corpus.dev_emb is not None
    assert corpus.dev_rescore[0] is corpus.data  # pack reuse, not a copy
    assert int(corpus.dev_rescore[0].shape[1]) == corpus.dim_padded

    q = np.concatenate([m[30:31], unit_rows(2, 20)], axis=0)
    n = 5
    final = eng.topk_final(corpus, q, n, eng.candidate_count(n))
    assert final is not None
    emb, scores, _ = final
    for b in range(3):
        exact = m.astype(np.float32) @ q[b].astype(np.float32)
        order = np.lexsort((-emb_ids, -exact))[:n]
        np.testing.assert_array_equal(emb[b], emb_ids[order])
        np.testing.assert_allclose(scores[b], exact[order], atol=2e-6)
    # the planted tie block surfaces largest-emb-id first
    assert list(emb[0][:5]) == [38, 37, 36, 35, 34]


def test_mesh_topk_final_int8_and_model_axis_policy(
    devices_available, unit_rows
):
    """int8 mesh corpora get the sharded rescore mirror (exact f32 final
    scores); 2-D model-axis meshes keep host rescore (the dim split makes
    per-shard dots partial in d, not rows) and topk_final declines."""
    from svs_tpu.engine.index import RetrievalEngine
    from svs_tpu.engine.packing import pack_corpus
    from svs_tpu.parallel import default_mesh, mesh_2d

    m = unit_rows(320, 24)
    emb_ids = np.arange(1, 321, dtype=np.int64)
    eng = RetrievalEngine(precision="int8", mesh=default_mesh())
    corpus = pack_corpus(
        m, emb_ids, version=1, precision="int8",
        placement=eng._placement(),
        row_multiple=eng._row_multiple(320),
        dim_multiple=eng._dim_multiple(),
    )
    eng._maybe_build_device_rescore(corpus)
    assert corpus.dev_rescore is not None
    q = m[:2].astype(np.float32)
    final = eng.topk_final(corpus, q, 5, 40)
    assert final is not None
    emb, scores, _ = final
    for b in range(2):
        exact = m.astype(np.float32) @ q[b]
        order = np.lexsort((-emb_ids, -exact))[:5]
        np.testing.assert_array_equal(emb[b], emb_ids[order])
        np.testing.assert_allclose(scores[b], exact[order], atol=2e-6)

    eng2 = RetrievalEngine(precision="f32", mesh=mesh_2d(4, 2))
    corpus2 = pack_corpus(
        m, emb_ids, version=1, precision="f32",
        placement=eng2._placement(),
        row_multiple=eng2._row_multiple(320),
        dim_multiple=eng2._dim_multiple(),
    )
    eng2._maybe_build_device_rescore(corpus2)
    assert corpus2.dev_rescore is None


def test_sharded_streams_past_scores_budget(
    devices_available, unit_rows, monkeypatch
):
    """Past the score-matrix budget, each shard's scoring must
    stream row blocks instead of materializing [B, N/D] f32 (a per-chip
    compile-time OOM at wide shapes) — with oracle-identical results."""
    import svs_tpu.ops.topk as topk_mod

    calls = []
    real = topk_mod.streaming_score_topk

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    import svs_tpu.utils.device_memory as device_memory

    monkeypatch.setattr(device_memory, "scores_budget", lambda *a: 0)
    monkeypatch.setattr(topk_mod, "streaming_score_topk", spy)
    # lru_cache on _build_sharded_topk would replay a pre-patch trace:
    # clear it so this mesh/k combination re-traces under the spy.
    from svs_tpu.parallel import sharded as sharded_mod

    sharded_mod._build_sharded_topk.cache_clear()

    m, q, mp, qp = _corpus(unit_rows)
    mesh = default_mesh()
    docs = jax.device_put(jnp.asarray(mp), NamedSharding(mesh, P("data", None)))
    vals, idx = sharded_score_topk(
        docs, None, jnp.asarray(qp), jnp.int32(len(m)), 11, mesh=mesh
    )
    assert calls, "per-shard streaming path not traced"
    for b in range(q.shape[0]):
        oracle = top_k_numpy(m @ q[b], 11)
        assert list(np.asarray(idx)[b]) == [i for _, i in oracle]

    # int8 shards stream through the same seam
    calls.clear()
    sharded_mod._build_sharded_topk.cache_clear()
    qd, scales = quantize_rows_int8(jnp.asarray(mp))
    docs8 = jax.device_put(qd, NamedSharding(mesh, P("data", None)))
    scales8 = jax.device_put(scales, NamedSharding(mesh, P("data")))
    vals8, idx8 = sharded_score_topk(
        docs8, scales8, jnp.asarray(qp), jnp.int32(len(m)), 11, mesh=mesh
    )
    assert calls, "int8 per-shard streaming path not traced"
    for b in range(q.shape[0]):
        true = {i for _, i in top_k_numpy(m @ q[b], 11)}
        got = set(np.asarray(idx8)[b].tolist())
        assert len(true & got) >= 10

    sharded_mod._build_sharded_topk.cache_clear()


def test_sharded_subset_topk_matches_oracle(devices_available, unit_rows):
    """The mesh pre-filter kernel: exact scores and reference tie rule
    over an explicit pack-row subset, vs the host oracle — including
    planted exact score ties and n_live padding."""
    from svs_tpu.engine.index import _subset_select_np
    from svs_tpu.parallel.sharded import sharded_subset_topk

    mesh = default_mesh()
    n, d, b, k = 2048, 64, 3, 7
    m = unit_rows(n, d).astype(np.float32)
    m[100] = m[700] = m[40]  # exact ties across different shards
    q = unit_rows(b, d).astype(np.float32)

    rows = np.arange(0, n, 3, dtype=np.int64)  # every 3rd pack row
    emb_ids = rows * 10 + 5  # arbitrary non-contiguous emb ids
    f = rows.size
    f_pad = 1 << (f - 1).bit_length()
    rows_p = np.zeros(f_pad, dtype=np.int32)
    rows_p[:f] = rows

    mirror = jax.device_put(m, NamedSharding(mesh, P("data", None)))
    dev_emb_np = np.zeros(n, dtype=np.int32)
    dev_emb_np[rows] = emb_ids.astype(np.int32)
    dev_emb = jax.device_put(dev_emb_np, NamedSharding(mesh, P(None)))
    rows_dev = jax.device_put(rows_p, NamedSharding(mesh, P(None)))
    q_dev = jax.device_put(q, NamedSharding(mesh, P(None, None)))

    wire = np.asarray(
        sharded_subset_topk(
            mirror, dev_emb, rows_dev, jnp.int32(f), q_dev, k, mesh=mesh
        )
    )
    got_emb = wire[:, :k].astype(np.int64)
    got_scores = np.ascontiguousarray(wire[:, k : 2 * k]).view(np.float32)

    exact = q @ m[rows].T  # [B, F] host f32 oracle
    want_emb, want_scores = _subset_select_np(exact, emb_ids, k)
    assert np.array_equal(got_emb, want_emb)
    # HIGHEST-precision device dots vs host BLAS: tiny accumulation skew
    np.testing.assert_allclose(got_scores, want_scores, atol=1e-6)
