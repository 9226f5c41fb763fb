"""The knowledge-base facades: :class:`AsyncKB` and :class:`KB`.

API parity with the reference (Rhobota/svs ``src/svs/kb.py:925-1799``):
constructor signature, bulk context managers (each one database
transaction that rolls back atomically on exception), ``retrieve``,
``document_top_pairwise_scores``, ``load``/``close(vacuum, also_gzip)``,
and the self-describing embedding-function handshake.  On top of that,
extensions: ``retrieve_batch`` (many queries in one fused device step),
engine precision/rescore/mesh knobs, and sidecar cold-start files.

Architecture difference worth knowing: the reference implements the async
and sync stacks twice (~900 duplicated lines).  Here all storage logic is
synchronous and shared; :class:`AsyncKB` runs it in the default executor
under an ``asyncio.Lock``, while :class:`KB` calls it directly under a
``threading.Lock`` and owns a private event-loop thread *only* to await
embedding providers and remote-file resolution (the same trick the
reference's ``KB`` uses, ``kb.py:1422-1427``).

Retrieval pipeline (vs the reference's NumPy dot at ``kb.py:1184-1190``):

1. the engine keeps the corpus packed on device (bf16 by default) and runs
   a jitted matmul + masked top-k, over-provisioning candidates;
2. candidates are **rescored in f32** with a per-query verified margin, so
   recall stays exact even with reduced-precision device storage.  The
   rescore runs on-device when the f32 mirror fits HBM (exact f32 dot
   products of the stored vectors; device accumulation order, so values
   can differ from CPU BLAS in the last ulp) and on the host otherwise —
   or always, with ``device_rescore='host'``, for scores bit-identical to
   the reference's ``np.dot``;
3. the whole batch's winners are hydrated in chunked IN queries.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
from pathlib import Path
from typing import (
    Any,
    AsyncIterator,
    Callable,
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)
from contextlib import asynccontextmanager, contextmanager

import numpy as np

from .embeddings import make_embeddings_func
from .embeddings.base import (
    MAGNITUDE_TOLERANCE,
    wrap_embeddings_func_check_magnitude,
)
from .engine.index import RetrievalEngine
from .engine.packing import PackedCorpus
from .engine.sidecar import sidecar_path_for
from .store.blob import embedding_to_bytes
from .store.db import Database
from .store.tx import Tx
from .types import (
    AsyncDocumentAdder,
    AsyncDocumentDeleter,
    AsyncDocumentQuerier,
    AsyncGraphInterface,
    AsyncKeyValueInterface,
    DocumentAdder,
    DocumentDeleter,
    DocumentId,
    DocumentPredicate,
    DocumentQuerier,
    DocumentRecord,
    EdgeId,
    EdgeRecord,
    EmbeddingFunc,
    GraphInterface,
    KeyValueInterface,
    NetworkXGraphTypes,
    Retrieval,
)
from .utils import (
    EventLoopThread,
    chunkify,
    delete_file_if_exists,
    atomic_gzip_file,
    resolve_to_local_uncompressed_file,
    try_fetch_remote_sidecar,
)
from .utils.topk_np import top_k_numpy
from .utils.typecheck import typeguard_exempt
from .utils.trace import QueryStats, phase, profiler_trace

log = logging.getLogger(__name__)

#: How many texts go to the embedding provider per request during bulk-add.
BULK_EMBEDDING_CHUNK_SIZE = 200

#: 'auto' sidecar policy: persist the packed matrix for corpora at least
#: this large (small ones repack faster than they mmap).
SIDECAR_AUTO_MIN_DOCS = 50_000

_OUT_OF_CONTEXT = "You may not call this function outside of the context manager!"


# ---------------------------------------------------------------------------
# Shared synchronous core
# ---------------------------------------------------------------------------


def _reconcile_embedding_func(
    db: Database, embedding_func: Optional[EmbeddingFunc]
) -> EmbeddingFunc:
    """The open-time handshake that makes a KB self-describing.

    Four cases over (constructor func, params stored in the DB), matching
    the reference (``svs/kb.py:896-922``): both known -> warn if they
    differ (constructor wins); only DB -> rebuild from stored params (or
    warn-override with a non-introspectable constructor func); only
    constructor -> persist its params; neither -> error (a brand-new DB
    needs a function) or warn (non-introspectable funcs can't be stored).
    """
    db.check_or_set_schema_version()
    with db.transaction() as tx:
        try:
            db_params = json.loads(tx.get_key("embedding_func_params"))
        except KeyError:
            db_params = None
    ctor_params = getattr(embedding_func, "__embedding_func_params__", None)

    if db_params is not None and ctor_params is not None:
        if db_params != ctor_params:
            log.warning(
                "You are overriding the embedding function stored in the "
                "database! Your function: %s, database function: %s",
                ctor_params,
                db_params,
            )
        assert embedding_func is not None
    elif db_params is not None:
        if embedding_func is not None:
            log.warning(
                "You are overriding the embedding function stored in the "
                "database! Your function: *unknown params*, database "
                "function: %s",
                db_params,
            )
        else:
            embedding_func = make_embeddings_func(db_params, trusted=False)
    elif ctor_params is not None:
        with db.transaction() as tx:
            tx.set_key("embedding_func_params", json.dumps(ctor_params))
        assert embedding_func is not None
    else:
        if embedding_func is not None:
            log.warning(
                "Cannot store this non-standard embeddings function to the "
                "database. You'll have to pass it explicitly to all future "
                "instantiations of this database."
            )
        else:
            raise RuntimeError(
                "No embedding function. You did not pass one to the "
                "constructor and there is not one in the database. Pass the "
                "embedding function on the *first* usage of a new database; "
                "it will be stored there for later use."
            )
    return embedding_func


def _open_database(
    local_path: Union[str, Path],
    force_fresh_db: bool,
    embedding_func: Optional[EmbeddingFunc],
) -> Tuple[Database, EmbeddingFunc]:
    if force_fresh_db:
        delete_file_if_exists(local_path)
        delete_file_if_exists(sidecar_path_for(local_path))
    db = Database(local_path)
    try:
        return db, _reconcile_embedding_func(db, embedding_func)
    except BaseException:
        db.close()
        raise


def _publish_sidecar(
    engine: "RetrievalEngine",
    policy: Union[bool, str],
    db: Database,
    override: Optional[bool],
) -> None:
    """Close-time sidecar policy shared by both facades: leave a current
    ``<db>.svsx`` behind so consumers skip the cold-start rescan.  Never
    fatal — a failed write only costs the next opener a rebuild.

    Under the default ``'auto'`` policy a full store scan+pack only
    happens when this connection actually wrote (``total_changes`` — the
    builder/publisher case); a pure consumer's ``close()`` at most
    serializes a pack it already holds, never a multi-minute rescan."""
    if override is False or (override is None and policy is False):
        return
    auto = override is None and policy == "auto"
    min_docs = SIDECAR_AUTO_MIN_DOCS if auto else 0
    wrote = db.conn is not None and db.conn.total_changes > 0
    try:
        engine.write_sidecar_from_store(
            db,
            sidecar_path_for(db.path),
            min_docs=min_docs,
            scan_ok=(not auto) or wrote,
        )
    except Exception:
        log.warning("publish-time sidecar write failed", exc_info=True)


def _prebuilt_record(
    rec_id: Any, parent_id: Any, level: Any, text: Any, meta_str: Any
) -> Tuple[DocumentRecord, Optional[str]]:
    """Cacheable (record, meta_json) pair: the record's values are all
    immutable, so hits shallow-copy it and patch meta from the JSON."""
    return (
        {
            "id": rec_id,
            "parent_id": parent_id,
            "level": level,
            "text": text,
            "embedding": True,
            "meta": None,
        },
        meta_str,
    )


def _edge_record(
    row: "Tuple[EdgeId, DocumentId, DocumentId, DocumentId, Optional[float], bool]",
) -> EdgeRecord:
    edge_id, a, b, r, w, d = row
    return {
        "id": edge_id,
        "a": a,
        "b": b,
        "relationship": r,
        "weight": w,
        "directed": d,
    }


class DocRowCache:
    """Host cache of raw doc rows keyed by embedding id — the hydration
    analog of the pack's f32 rescore cache.

    The reference hydrates each hit with two SQLite point queries
    (``svs/kb.py:1192-1206``); at this framework's batch sizes (256
    queries x top-100 = ~25k hits) even batched IN-queries measured
    ~100 ms per batch, all of it re-reading rows the previous batch just
    read.  Rows cached here are raw ``(id, parent_id, level, text,
    meta_json)`` tuples: minting a result record is one dict literal +
    ``json.loads`` of the meta text, so callers get fresh, never-aliased
    objects without per-hit ``copy.deepcopy``.

    Staleness: guarded by ``Tx.change_token()`` — O(1), and moves on ANY
    write from this connection (including doc-meta updates) or any other
    writer of the file.  The cache empties whenever the token moves; a
    correctness-over-cleverness choice (writes also invalidate the device
    pack, which costs far more).

    Values are ``(record, meta_json)`` where ``record`` is a PREBUILT
    DocumentRecord dict with ``meta=None``: minting a hit is one shallow
    ``dict(record)`` (all values immutable scalars/strings) plus a fresh
    ``json.loads`` when meta exists — measured ~35% faster than building
    the 6-key literal per hit at 25.6k hits/batch, still never aliasing.
    """

    def __init__(
        self,
        max_rows: Optional[int] = None,
        max_bytes: Optional[int] = None,
    ) -> None:
        from .utils.env import env_int

        if max_rows is None:
            max_rows = env_int("SVS_TPU_DOC_CACHE_MAX_ROWS", 4_000_000)
        if max_bytes is None:
            max_bytes = env_int("SVS_TPU_DOC_CACHE_MAX_BYTES", 2_000_000_000)
        self.max_rows = max_rows
        #: Approximate text+meta byte budget for ``prewarm`` — row COUNT
        #: alone would let a long-document corpus silently pin many GB of
        #: host RAM at ``load()``.
        self.max_bytes = max_bytes
        self._rows: Dict[int, Tuple[DocumentRecord, Optional[str]]] = {}
        self._token: Optional[Tuple[int, int]] = None
        #: True when the cache was prewarmed for the current token — every
        #: embedded doc is present, so lookups can skip the missing-scan.
        self._warm = False

    def is_warm_for(self, tx: Tx) -> bool:
        """True when the cache is prewarmed AND current — callers may then
        use the full mapping directly (no per-batch missing scan)."""
        return self._warm and tx.change_token() == self._token

    def prewarm(self, tx: Tx) -> int:
        """Load EVERY embedded document's raw row up front (one full
        scan), so batched hydration never touches SQLite afterwards —
        cold random-query batches measured ~100 ms of IN-queries per 256
        queries at 1M docs.  Policy-gated by the callers (``load()``);
        respects both ``max_rows`` and the approximate ``max_bytes``
        budget.  Returns the number of cached rows (0 = over budget,
        demand-filled behavior kept)."""
        token = tx.change_token()
        rows: Dict[int, Tuple[DocumentRecord, Optional[str]]] = {}
        approx_bytes = 0
        for emb_id, rec_id, parent_id, level, text, meta_str in (
            tx.iter_doc_rows_with_emb()
        ):
            rows[int(emb_id)] = _prebuilt_record(
                rec_id, parent_id, level, text, meta_str
            )
            approx_bytes += len(text) + (len(meta_str) if meta_str else 0)
            if len(rows) > self.max_rows or approx_bytes > self.max_bytes:
                return 0  # over budget: keep the demand-filled behavior
        self._rows = rows
        self._token = token
        self._warm = True
        return len(rows)

    def rows_for(
        self, tx: Tx, emb_ids: List[int]
    ) -> Dict[int, Tuple[DocumentRecord, Optional[str]]]:
        """Prebuilt doc records for ``emb_ids``, reading through the
        cache."""
        token = tx.change_token()
        if token != self._token:
            self._rows.clear()
            self._warm = False
            self._token = token
        rows = self._rows
        if self._warm:
            # prewarmed and store unchanged: every embedded doc is here
            return rows
        missing = [e for e in emb_ids if e not in rows]
        if missing:
            fetched = {
                emb_id: _prebuilt_record(*raw)
                for emb_id, raw in tx.fetch_doc_rows_by_emb_ids(
                    missing
                ).items()
            }
            if len(rows) + len(fetched) > self.max_rows:
                # Over budget: reset the cache — but the caller still
                # needs this batch's already-cached ids, so hand back a
                # detached mapping covering exactly this batch.
                out = {e: rows[e] for e in emb_ids if e in rows}
                out.update(fetched)
                self._rows = fetched if len(fetched) <= self.max_rows else {}
                return out
            rows.update(fetched)
        return rows


def meta_filter_predicate(flt: Dict[str, Any]) -> DocumentPredicate:
    """A :data:`~svs_tpu.types.DocumentPredicate` testing meta-key
    equalities: every key in ``flt`` must be present in the document's
    meta with exactly the given value (docs without meta match only the
    empty filter).  This is the declaratively-expressible filter subset
    used by the HTTP ``meta_filter`` field and the CLI ``--meta-filter``
    flag; Python callers can pass any predicate to ``where=`` directly
    (or pass the dict itself as ``where=`` — same as calling this).

    The returned predicate carries its spec (``__meta_filter__``), which
    lets the retrieval facades engage the PRE-FILTER fast path for
    selective filters: look the matching emb ids up in the
    :class:`MetaRowIndex` and score only those rows
    (``RetrievalEngine.subset_topk``) instead of widening an exact
    global prefix.  Hand-written predicates are opaque — they always
    take the post-filter ladder."""

    def predicate(doc: DocumentRecord) -> bool:
        meta = doc.get("meta") or {}
        return all(k in meta and meta[k] == v for k, v in flt.items())

    predicate.__meta_filter__ = dict(flt)  # type: ignore[attr-defined]
    return predicate


class MetaRowIndex:
    """Generation-gated map from a meta equality ``(key, value)`` to the
    sorted emb ids of matching documents — the lookup side of pre-filter
    retrieval (new capability; the reference has no filtering).

    Entries build lazily on first lookup.  Scalar equalities evaluate
    inside SQLite (``Tx.meta_eq_emb_ids`` — a JSON1 C scan, no per-row
    Python JSON parse); pairs SQL can't express with Python-equality
    semantics batch into ONE ``(emb_id, meta)`` Python scan evaluating
    literally the same comparison as :func:`meta_filter_predicate`
    (``key in meta and meta[key] == value``), so the routes can never
    disagree.  The whole index drops on ANY store change
    (``Tx.change_token`` — the ``DocRowCache`` gate)."""

    def __init__(self, max_entries: int = 64) -> None:
        self._token: Optional[Tuple[int, int]] = None
        self._entries: Dict[Tuple[str, str], np.ndarray] = {}
        self.max_entries = max_entries

    def _store(self, ck: Tuple[str, str], ids: np.ndarray) -> None:
        while len(self._entries) >= self.max_entries:
            self._entries.pop(next(iter(self._entries)))
        self._entries[ck] = ids

    @staticmethod
    def canonical(flt: Dict[str, Any]) -> str:
        """Canonical cache string for a filter dict (sorted, compact)."""
        return json.dumps(flt, sort_keys=True, separators=(",", ":"))

    def lookup(self, tx: Tx, flt: Dict[str, Any]) -> Optional[np.ndarray]:
        """Sorted int64 emb ids of documents matching EVERY equality in
        ``flt``, or ``None`` for the empty filter (matches everything —
        the post-filter path is free there)."""
        if not flt:
            return None
        token = tx.change_token()
        if token != self._token:
            self._entries.clear()
            self._token = token
        # json.dumps can refuse a filter VALUE (numpy scalar, set, ...);
        # such filters can't be cache-keyed — raise the ladder's signal.
        keys = [
            (k, json.dumps(v, sort_keys=True, separators=(",", ":")))
            for k, v in flt.items()
        ]
        # Resolve into a LOCAL map: `_store`'s eviction may drop an entry
        # this very lookup still needs once the cache is full.
        have: Dict[Tuple[str, str], np.ndarray] = {}
        scan: List[Tuple[str, str]] = []
        for ck in keys:
            cached = self._entries.get(ck)
            if cached is not None:
                have[ck] = cached
                continue
            # SQL fast path: JSON1 evaluates the same equality inside
            # SQLite's C scan (Tx.meta_eq_emb_ids documents the exact
            # semantics match); unroutable pairs batch into ONE Python
            # scan below.
            ids_sql = tx.meta_eq_emb_ids(ck[0], flt[ck[0]])
            if ids_sql is None:
                scan.append(ck)
            else:
                have[ck] = np.asarray(ids_sql, dtype=np.int64)
                self._store(ck, have[ck])
        if scan:
            want = {ck: (ck[0], flt[ck[0]]) for ck in scan}
            found: Dict[Tuple[str, str], List[int]] = {
                ck: [] for ck in scan
            }
            loads = json.loads
            for emb_id, meta_str in tx.iter_emb_meta():
                if meta_str is None:
                    continue
                meta = loads(meta_str)
                for ck, (k, v) in want.items():
                    if k in meta and meta[k] == v:
                        found[ck].append(emb_id)
            for ck, ids in found.items():
                have[ck] = np.asarray(sorted(ids), dtype=np.int64)
                self._store(ck, have[ck])
        out = have[keys[0]]
        for ck in keys[1:]:
            out = np.intersect1d(out, have[ck], assume_unique=True)
        return out


#: Pre-filter engagement ceiling: past this many matching rows the
#: subset gather stops beating the streamed full-corpus kernels and the
#: post-filter ladder converges in one round anyway.
_PREFILTER_MAX_ROWS = 1 << 16


def _prefilter_emb_ids(
    tx: Tx,
    index: MetaRowIndex,
    corpus: "PackedCorpus",
    flt: Dict[str, Any],
    n: int,
) -> Optional[np.ndarray]:
    """Matching emb ids when the pre-filter path should run, else
    ``None`` (unselective or unindexable filters take the post-filter
    widen ladder).  Gate: match count within ``_PREFILTER_MAX_ROWS`` AND
    under a quarter of the corpus (subset gathers read HBM ~4x slower
    per row than the streamed kernels), OR no more matches than ``n``
    (the answer is just "all of them, ranked")."""
    try:
        ids = index.lookup(tx, flt)
    except TypeError:
        # Filter values json.dumps refuses (numpy scalars, sets, ...)
        # can't be indexed or cache-keyed; the ladder's host predicate
        # compares them with plain Python equality just fine.
        return None
    if ids is None:
        return None
    f = int(ids.size)
    if f <= n:
        return ids
    if f > _PREFILTER_MAX_ROWS or f * 4 > corpus.n_valid:
        return None
    return ids


def _filter_match_emb_ids(
    tx: Tx,
    index: MetaRowIndex,
    where: Union[DocumentPredicate, Dict[str, Any]],
) -> Optional[np.ndarray]:
    """Sorted emb ids of EVERY embedded document passing ``where``, or
    ``None`` when the filter matches everything (empty dict) — the
    match-set resolver for filtered pairwise, where the whole subset is
    needed up front (pairs can't be post-filtered one candidate at a
    time the way retrieval hits can).  Declarative filters ride the
    :class:`MetaRowIndex`; opaque predicates pay one full hydrated
    scan — noise next to the O(F²·d) pairwise work that follows."""
    flt = (
        where
        if isinstance(where, dict)
        else getattr(where, "__meta_filter__", None)
    )
    if flt is not None:
        if not flt:
            return None
        try:
            ids = index.lookup(tx, flt)
        except TypeError:
            ids = None  # unserializable values: predicate scan below
        if ids is not None:
            return ids
    pred = meta_filter_predicate(where) if isinstance(where, dict) else where
    loads = json.loads
    out = [
        int(emb_id)
        for emb_id, rec_id, parent_id, level, text, meta_str
        in tx.iter_doc_rows_with_emb()
        if pred(
            {
                "id": rec_id,
                "parent_id": parent_id,
                "level": level,
                "text": text,
                "embedding": True,
                "meta": loads(meta_str) if meta_str is not None else None,
            }
        )
    ]
    return np.asarray(sorted(out), dtype=np.int64)


#: Initial candidate over-fetch for filtered retrieval: each widen round
#: searches min(n * 4^round, corpus) — geometric like the rescore ladder,
#: so a selectivity-s filter converges in O(log_4(1/s)) device steps.
_FILTER_OVERFETCH = 4


def _filter_round(
    results: List[List[Retrieval]],
    pending: List[int],
    out: List[Optional[List[Retrieval]]],
    where: DocumentPredicate,
    n: int,
    n_valid: int,
    m: int,
) -> List[int]:
    """One round of the filtered-retrieval widen ladder (shared by the
    sync and async facades).

    ``results`` are the exact (verified) top-``m`` lists for the queries
    at positions ``pending``.  Each query keeps its first ``n``
    predicate-passing hits; because candidates arrive in exact global
    score order, ``n`` survivors inside an exact top-``m`` prefix ARE the
    exact filtered top-``n`` (every doc outside the prefix scores <= the
    m-th, which scores <= the n-th survivor under the tie rule).  A query
    with fewer survivors is done only when the prefix already covers the
    whole corpus (``m >= n_valid``); otherwise it stays pending for the
    next, 4x-wider round.  Returns the still-pending positions.
    """
    still: List[int] = []
    for qi, rlist in zip(pending, results):
        survivors: List[Retrieval] = []
        for r in rlist:
            if where(r["doc"]):
                survivors.append(r)
                if len(survivors) == n:
                    break
        if len(survivors) >= n or m >= n_valid:
            out[qi] = survivors
        else:
            still.append(qi)
    return still


def _finalize_batch(
    tx: Tx,
    corpus: PackedCorpus,
    vectors: np.ndarray,
    pre_vals: np.ndarray,
    pre_rows: np.ndarray,
    k: int,
    rescore: bool,
    pre_eps: Optional[np.ndarray] = None,
    doc_cache: Optional[DocRowCache] = None,
    device_exact: Optional[np.ndarray] = None,
) -> Optional[List[List[Retrieval]]]:
    """Turn device candidates for a query batch into hydrated results.

    With ``rescore``, candidate embeddings are re-scored with a float32
    dot product, so scores (and their ordering) are bit-identical to the
    reference's CPU math regardless of the device storage precision.  The
    gather prefers the pack's host f32 cache (``corpus.host_f32`` — the
    exact bytes the pack was built from, snapshot-consistent, and
    memory-bandwidth-fast); packs without one (sidecar cold starts,
    cache-size limit) fall back to one batched IN-query fetch for the
    union of candidate embeddings.  Hits are minted as fresh dicts from
    raw cached rows — results never alias each other or the cache.

    ``pre_eps`` (per-query prescore-error bounds from
    ``RetrievalEngine.prescore_eps``) turns the rescore into *verified*
    exact: if any query's k-th rescored score does not clear the lowest
    returned prescore by its bound, some true top-k hit could be hiding
    outside the candidate set — return ``None`` so the caller widens the
    candidates and retries.  Skipped when every document is already a
    candidate (exact by construction).
    """
    n_queries = vectors.shape[0]
    if pre_rows.size == 0:
        return [[] for _ in range(n_queries)]

    if rescore:
        c_count = pre_rows.shape[1]
        k_eff = min(k, c_count)
        vec32 = vectors.astype(np.float32, copy=False)
        exact = np.empty((n_queries, c_count), dtype=np.float32)
        if device_exact is not None:
            # Rescore already ran on-device (gather from the HBM f32
            # mirror + f32 dot): exact f32 values of the stored vectors,
            # possibly last-ulp off CPU BLAS accumulation — covered by
            # the +3e-5 cushion in prescore_eps.  The host never touches
            # the O(B*C*d) candidate bytes.
            exact = np.asarray(device_exact, dtype=np.float32)
            assert exact.shape == (n_queries, c_count), exact.shape
        elif corpus.host_f32 is not None:
            # Per-query direct gather+matvec: the earlier union-dedup pass
            # (np.unique + one big sub-matrix copy) read the candidate
            # bytes TWICE (600 MB union copy, then per-query gathers out
            # of it); candidates barely overlap across queries, so dedup
            # saved ~2% of bytes and doubled the traffic.  The dot stays
            # a per-query BLAS matvec — the SAME per-row accumulation as
            # the reference's np.dot, keeping returned scores
            # bit-identical (a batched einsum reorders the f32
            # accumulation).
            hf, rm = corpus.host_f32, corpus.host_row_map
            for b in range(n_queries):
                rows_b = pre_rows[b] if rm is None else rm[pre_rows[b]]
                exact[b] = hf[rows_b] @ vec32[b]
        else:
            unique_rows = np.unique(pre_rows)
            sub_matrix = tx.fetch_embedding_rows(corpus.emb_ids[unique_rows])
            pos_arr = np.searchsorted(unique_rows, pre_rows)  # [B, C]
            for b in range(n_queries):
                exact[b] = sub_matrix[pos_arr[b]] @ vec32[b]
        # Reference tie rule: equal scores break toward the LARGER matrix
        # index, and the reference's matrix is in embedding-id order
        # (``svs/util.py:190-203``).  Pack rows are permuted at scale, so
        # order candidates by emb id first; the reversed-stable argsort
        # then resolves ties to the larger emb id.
        emb_of = corpus.emb_ids[pre_rows]  # [B, C]
        id_order = np.argsort(emb_of, axis=1, kind="stable")
        exact_o = np.take_along_axis(exact, id_order, axis=1)
        rows_o = np.take_along_axis(pre_rows, id_order, axis=1)
        rev = exact_o[:, ::-1]
        order_rev = np.argsort(-rev, axis=1, kind="stable")[:, :k_eff]
        order = c_count - 1 - order_rev  # ties -> larger emb id
        top_scores = np.take_along_axis(exact_o, order, axis=1)
        top_rows = np.take_along_axis(rows_o, order, axis=1)
        verify = pre_eps is not None and c_count < corpus.n_valid
        if verify and k_eff > 0:
            # No non-candidate's true score can exceed its prescore
            # (<= the lowest returned prescore) plus the error bound.
            v_k = top_scores[:, k_eff - 1]
            if np.any(v_k < pre_vals[:, -1] + np.asarray(pre_eps)):
                return None
        top_emb = corpus.emb_ids[top_rows]  # [B, k_eff]
    else:
        # rescore=False opt-out: raw device prescores in device order.
        # Among exactly tied scores the device breaks toward the SMALLER
        # pack row (and fetched only k candidates), so the reference tie
        # rule does not apply here — documented on the KB constructors.
        k_eff = min(k, pre_rows.shape[1])
        top_scores = pre_vals[:, :k_eff]
        top_emb = corpus.emb_ids[pre_rows[:, :k_eff]]

    return _hydrate_and_mint(tx, top_emb, top_scores, doc_cache)


def _hydrate_and_mint(
    tx: Tx,
    top_emb: np.ndarray,
    top_scores: np.ndarray,
    doc_cache: Optional[DocRowCache],
) -> List[List[Retrieval]]:
    """One batched hydration for the whole batch's unique docs, through
    the generation-gated row cache when the caller has one (a prewarmed
    cache returns its full mapping without the np.unique/missing scan),
    then mint fresh, never-aliasing hit dicts."""
    emb_list: List[List[int]] = top_emb.tolist()
    score_list: List[List[float]] = np.asarray(
        top_scores, dtype=np.float32
    ).tolist()
    if doc_cache is not None and doc_cache.is_warm_for(tx):
        row_by_emb = doc_cache.rows_for(tx, [])
    else:
        unique_emb = np.unique(top_emb)
        if doc_cache is not None:
            row_by_emb = doc_cache.rows_for(tx, [int(e) for e in unique_emb])
        else:
            row_by_emb = {
                emb_id: _prebuilt_record(*raw)
                for emb_id, raw in tx.fetch_doc_rows_by_emb_ids(
                    [int(e) for e in unique_emb]
                ).items()
            }
    loads = json.loads
    results: List[List[Retrieval]] = []
    for scores_b, embs_b in zip(score_list, emb_list):
        hits: List[Retrieval] = []
        for score, emb_id in zip(scores_b, embs_b):
            rec, meta_str = row_by_emb[emb_id]
            doc = dict(rec)  # fresh per hit; values are immutable
            if meta_str is not None:
                doc["meta"] = loads(meta_str)
            hits.append({"score": score, "doc": doc})
        results.append(hits)
    return results


def _finalize_device_final(
    tx: Tx,
    corpus: PackedCorpus,
    emb: np.ndarray,
    scores: np.ndarray,
    boundary: np.ndarray,
    c_count: int,
    pre_eps: Optional[np.ndarray],
    doc_cache: Optional[DocRowCache] = None,
) -> Optional[List[List[Retrieval]]]:
    """Finalize for the fully-on-device pipeline
    (:meth:`RetrievalEngine.topk_final`): the device already rescored in
    exact f32 AND selected the final top-k with the reference tie rule,
    so the host's only math is the margin proof — if any query's weakest
    returned score does not clear the boundary prescore by its error
    bound, return ``None`` so the caller widens the candidates (same
    verified-exactness contract as :func:`_finalize_batch`)."""
    if emb.size == 0:
        return [[] for _ in range(emb.shape[0])]
    verify = pre_eps is not None and c_count < corpus.n_valid
    if verify:
        v_k = scores[:, -1]
        if np.any(v_k < boundary + np.asarray(pre_eps)):
            return None
    return _hydrate_and_mint(tx, emb, scores, doc_cache)


def _finalize_pairwise(
    tx: Tx,
    corpus: PackedCorpus,
    pre_vals: np.ndarray,
    rows_a: np.ndarray,
    rows_b: np.ndarray,
    k: int,
    rescore: bool,
    pre_eps: Optional[float] = None,
    device_rescorer: Optional[
        Callable[[np.ndarray, np.ndarray], Optional[np.ndarray]]
    ] = None,
) -> Optional[List[Tuple[float, DocumentRecord, DocumentRecord]]]:
    """Hydrate top pairs; optionally f32-rescore the candidate pairs.
    Returns ``None`` when the verified-exactness margin check fails (same
    contract as :func:`_finalize_batch`).

    ``device_rescorer`` (``RetrievalEngine.pairwise_rescore`` bound to
    this corpus) computes the exact pair scores on-device from the HBM
    f32 mirror; when it declines (``None``) the host gathers — in
    fixed-size blocks, because one flat gather materializes 2·C·d f32
    bytes (614 MB at C=50k, d=1536) and the mmap/munmap churn of
    transients that size measured seconds of kernel time per call on
    small VMs."""
    emb_a = corpus.emb_ids[rows_a]
    emb_b = corpus.emb_ids[rows_b]
    n_pairs = len(emb_a)
    if n_pairs == 0:
        return []
    total_pairs = corpus.n_valid * (corpus.n_valid - 1) // 2
    if rescore:
        exact: Optional[np.ndarray] = None
        if device_rescorer is not None:
            exact = device_rescorer(
                np.asarray(rows_a), np.asarray(rows_b)
            )
        if exact is None and corpus.host_f32 is not None:
            ra = np.asarray(rows_a, dtype=np.int64)
            rb = np.asarray(rows_b, dtype=np.int64)
            if corpus.host_row_map is not None:
                ra = corpus.host_row_map[ra]
                rb = corpus.host_row_map[rb]
            host = corpus.host_f32
            exact = np.empty((n_pairs,), dtype=np.float32)
            blk = 4096  # caps gathered transients at ~2*blk*d*4 bytes
            for i in range(0, n_pairs, blk):
                exact[i : i + blk] = np.einsum(
                    "ij,ij->i",
                    host[ra[i : i + blk]],
                    host[rb[i : i + blk]],
                )
        elif exact is None:
            unique = sorted(set(map(int, emb_a)) | set(map(int, emb_b)))
            vectors = tx.fetch_embedding_rows(unique)
            pos = {e: i for i, e in enumerate(unique)}
            va = vectors[[pos[int(e)] for e in emb_a]]
            vb = vectors[[pos[int(e)] for e in emb_b]]
            exact = np.einsum("ij,ij->i", va, vb)
        order = top_k_numpy(exact, k)
        triples = [
            (score, int(emb_a[i]), int(emb_b[i])) for score, i in order
        ]
        if pre_eps is not None and n_pairs < total_pairs and triples:
            v_k = triples[-1][0]
            if v_k < float(pre_vals[-1]) + pre_eps:
                return None
    else:
        triples = [
            (float(pre_vals[i]), int(emb_a[i]), int(emb_b[i]))
            for i in range(min(k, n_pairs))
        ]
    doc_by_emb = tx.fetch_docs_by_emb_ids(
        sorted({e for _, e1, e2 in triples for e in (e1, e2)})
    )
    return [
        (score, doc_by_emb[e1], doc_by_emb[e2]) for score, e1, e2 in triples
    ]


# ---------------------------------------------------------------------------
# AsyncKB
# ---------------------------------------------------------------------------


def _make_engine(
    precision: str,
    rescore: Optional[bool],
    mesh: Optional[Any],
    device: Optional[Any],
    kernel: str,
    device_rescore: str,
    replicas: Optional[Any],
) -> RetrievalEngine:
    """Engine factory shared by both facades: a plain single-chip/mesh
    engine, or a :class:`parallel.replicas.ReplicaEngine` when
    ``replicas`` is set (int = first N devices, or an explicit device
    sequence).  Replication multiplies query THROUGHPUT for corpora that
    fit one chip; a mesh multiplies CAPACITY — they are different axes
    and mutually exclusive here."""
    if replicas is None:
        return RetrievalEngine(
            precision=precision,
            rescore=rescore,
            mesh=mesh,
            device=device,
            kernel=kernel,
            device_rescore=device_rescore,
        )
    if mesh is not None:
        raise ValueError(
            "mesh and replicas are mutually exclusive: a mesh SHARDS the "
            "corpus (capacity/latency), replicas COPY it (throughput)"
        )
    if device is not None:
        raise ValueError(
            "pass devices via replicas=[dev, ...] instead of device= in "
            "replica mode"
        )
    from .parallel.replicas import ReplicaEngine

    by_count = isinstance(replicas, int)
    return ReplicaEngine(
        precision=precision,
        rescore=rescore,
        n_replicas=replicas if by_count else None,
        devices=None if by_count else list(replicas),
        kernel=kernel,
        device_rescore=device_rescore,
    )


class AsyncKB:
    """Async knowledge base for web services and pipelines.

    ``local_path_or_remote_url`` accepts a local ``.sqlite`` path, a
    ``file://`` path, a ``.gz`` of either, or an ``http(s)`` URL (downloaded
    once into ``./.remote_cache/``).  The database opens lazily on first
    use, or eagerly via :meth:`load` (which also warms the device corpus).

    Engine knobs (all optional): ``precision`` ('auto' default — the
    fastest storage whose results stay exact: int8 prescore under the
    verified f32 rescore, bf16 where the int8 path doesn't apply; or an
    explicit 'f32'/'bf16'/'int8'), ``rescore`` (verified-exact f32 re-ranking with the
    reference tie rule; default on for every precision — ``False`` is a
    raw-prescore opt-out whose ordering among exactly tied scores is
    the device's), ``mesh`` (a ``jax.sharding.Mesh`` to shard the corpus
    across chips — capacity), ``replicas`` (int or device list: REPLICATE
    the corpus across chips and split query batches over them —
    throughput; mutually exclusive with ``mesh``), ``device``, and
    ``sidecar`` (True/False/'auto': persist the packed matrix next to the
    DB for mmap cold starts).
    """

    def __init__(
        self,
        local_path_or_remote_url: Union[Path, str],
        embedding_func: Optional[EmbeddingFunc] = None,
        force_fresh_db: bool = False,
        *,
        precision: str = "auto",
        rescore: Optional[bool] = None,
        mesh: Optional[Any] = None,
        device: Optional[Any] = None,
        sidecar: Union[bool, str] = "auto",
        kernel: str = "auto",
        device_rescore: str = "auto",
        replicas: Optional[Any] = None,
    ) -> None:
        self.local_path_or_remote_url = local_path_or_remote_url
        self.db: Optional[Database] = None
        self.db_lock: Optional[asyncio.Lock] = None
        self.embedding_func = embedding_func
        self.embedding_func_orig = embedding_func
        self.force_fresh_db = force_fresh_db
        self.engine = _make_engine(
            precision, rescore, mesh, device, kernel, device_rescore,
            replicas,
        )
        self.sidecar = sidecar
        self._stats = QueryStats()
        self._doc_cache = DocRowCache()
        self._meta_index = MetaRowIndex()

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Rolling per-phase timing stats (pack/embed/search/finalize) plus
        ``pack_events`` — how each freshness check was satisfied (reuse /
        append / delete / sidecar / scan), for confirming writes ride the
        incremental pack paths."""
        out = self._stats.snapshot()
        out["pack_events"] = {k: float(v) for k, v in self.engine.pack_events.items()}
        out["dispatch"] = self.engine.dispatch_stats()
        return out

    # -- plumbing -----------------------------------------------------------

    def _get_lock(self) -> asyncio.Lock:
        if self.db_lock is None:
            self.db_lock = asyncio.Lock()
        return self.db_lock

    async def _ensure_db(self) -> Database:
        if self.db is None:
            local_path = await resolve_to_local_uncompressed_file(
                self.local_path_or_remote_url
            )
            if self.sidecar is not False and not self.force_fresh_db:
                # publishers upload <db>.svsx next to <db>.gz; grabbing it
                # skips the cold-start BLOB rescan (stale ones are ignored
                # by the sidecar fingerprint check)
                await try_fetch_remote_sidecar(
                    self.local_path_or_remote_url, local_path
                )
            loop = asyncio.get_running_loop()

            def heavy() -> Tuple[Database, EmbeddingFunc]:
                return _open_database(
                    local_path, self.force_fresh_db, self.embedding_func
                )

            self.db, self.embedding_func = await loop.run_in_executor(None, heavy)
        return self.db

    def _sidecar_path(self) -> Optional[Path]:
        if self.sidecar is False or self.db is None:
            return None
        return sidecar_path_for(self.db.path)

    def _should_write_sidecar(self, corpus: PackedCorpus) -> bool:
        if self.sidecar is True:
            return True
        return self.sidecar == "auto" and corpus.n_valid >= SIDECAR_AUTO_MIN_DOCS

    async def _ensure_engine_fresh(self) -> PackedCorpus:
        """Pack (or reuse) the device corpus.  Caller must hold the lock."""
        db = await self._ensure_db()
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, self.engine.ensure_fresh, db, self._sidecar_path()
        )

    async def load(self) -> None:
        """Open the DB and warm the device corpus now (instead of lazily on
        the first query); persists a sidecar according to policy and
        prewarms the hydration row cache (batched hydration then never
        touches the store)."""
        async with self._get_lock():
            corpus = await self._ensure_engine_fresh()
            path = self._sidecar_path()
            loop = asyncio.get_running_loop()
            if path is not None and self._should_write_sidecar(corpus):
                await loop.run_in_executor(None, self.engine.write_sidecar, path)
            db = await self._ensure_db()

            def warm() -> int:
                with db.transaction() as tx:
                    return self._doc_cache.prewarm(tx)

            warmed = await loop.run_in_executor(None, warm)
            if warmed:
                log.info("hydration cache prewarmed (%d rows)", warmed)

    async def warmup(
        self,
        batch_sizes: Sequence[int] = (1,),
        n: int = 16,
        rounds: int = 2,
        routes: str = "both",
    ) -> None:
        """Pre-compile the search pipeline for the given batch sizes.

        Every distinct batch size is a distinct jit shape; at 1M x 1536
        each compile costs seconds, so a server that
        coalesces variable-size bursts pays multi-second tail latencies
        until every bucket it uses has compiled (measured: 36 s p99
        through a whole serve load window).  This drives one synthetic
        random-unit-vector batch per size through the REAL search +
        hydration path (results discarded), so steady state starts warm.
        ``serve`` calls it on startup with the micro-batcher's bucket
        ladder and its ``n`` BUCKET (the compiled shape depends on the
        bucketed n, not the client's raw n).  ``rounds=2`` (default)
        repeats each size so the second pass runs at the LEARNED
        candidate width — margin-driven widening otherwise compiles a
        fresh width on the first live batch."""
        corpus = await self._ensure_engine_fresh()
        if corpus.n_valid == 0 or corpus.dim == 0:
            return
        rng = np.random.default_rng(0)
        for b in batch_sizes:
            for _ in range(max(1, rounds)):
                v = rng.standard_normal(
                    (int(b), corpus.dim)
                ).astype(np.float32)
                v /= np.linalg.norm(v, axis=1, keepdims=True)
                with phase("warmup", self._stats):
                    await self._search_hydrated(
                        corpus, v, min(n, corpus.n_valid)
                    )
            if (
                routes == "both"
                and corpus.device_ready  # NEVER block startup on upload
                and self.engine.host_dispatch == "auto"
                and self.engine.host_route(corpus, int(b), k=n)
            ):
                # Host dispatch answered every round above, so this batch
                # shape never compiled on the device.  Warm that route
                # too: if the host-scan bandwidth estimate later degrades
                # and the dispatch flips mid-traffic, live requests must
                # not pay the 5-20 s jit compile warmup exists to absorb.
                # Gated on device_ready (a deferred pack upload would
                # otherwise stall startup for the whole multi-GB
                # transfer) and on 'auto' ('force' can only flip by an
                # explicit user action — compiling its device shapes
                # would pay minutes for an unreachable route).
                # ``routes='live'`` (concurrent-with-traffic callers,
                # e.g. serve's post-upload rewarm) skips this block: it
                # TOGGLES the shared host_dispatch attribute, which
                # would misroute live requests mid-warm.
                prev = self.engine.host_dispatch
                self.engine.host_dispatch = "off"
                try:
                    v = rng.standard_normal(
                        (int(b), corpus.dim)
                    ).astype(np.float32)
                    v /= np.linalg.norm(v, axis=1, keepdims=True)
                    with phase("warmup", self._stats):
                        await self._search_hydrated(
                            corpus, v, min(n, corpus.n_valid)
                        )
                finally:
                    self.engine.host_dispatch = prev

    async def close(
        self,
        vacuum: bool = False,
        also_gzip: bool = False,
        write_sidecar: Optional[bool] = None,
    ) -> None:
        """Flush and close.  ``vacuum`` compacts the file; ``also_gzip``
        atomically writes the shareable ``<path>.gz`` artifact.

        ``write_sidecar`` controls the publish-time sidecar: by default
        (``None``) the instance's sidecar policy decides — ``True`` always
        writes, ``'auto'`` writes for corpora past the auto threshold —
        so a builder who adds documents and closes leaves a current
        ``<path>.svsx`` behind and no consumer ever pays the cold-start
        BLOB rescan (upload it next to the ``.gz``).  Pass ``False`` to
        skip, ``True`` to force regardless of policy."""
        async with self._get_lock():
            db = await self._ensure_db()
            loop = asyncio.get_running_loop()

            def heavy() -> Union[str, Path]:
                _publish_sidecar(self.engine, self.sidecar, db, write_sidecar)
                if vacuum:
                    db.vacuum()
                db.close()
                return db.path

            path = await loop.run_in_executor(None, heavy)
            self.db = None
            self.embedding_func = self.embedding_func_orig
            self.engine.invalidate()
            self.engine.shutdown()
            if also_gzip:
                await loop.run_in_executor(
                    None, atomic_gzip_file, path, f"{path}.gz"
                )

    def _checked_embedding_func(self) -> EmbeddingFunc:
        assert self.embedding_func  # the db has been opened by every caller
        return wrap_embeddings_func_check_magnitude(
            self.embedding_func, MAGNITUDE_TOLERANCE
        )

    async def _embed(self, texts: List[str]) -> List[List[float]]:
        return await self._checked_embedding_func()(texts)

    async def _embed_to_bytes(self, texts: List[str]) -> List[bytes]:
        vectors = await self._embed(texts)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, lambda: [embedding_to_bytes(v) for v in vectors]
        )

    # -- bulk operations -------------------------------------------------------

    @typeguard_exempt
    @asynccontextmanager
    async def bulk_add_docs(self) -> AsyncIterator[AsyncDocumentAdder]:
        """One transaction: add documents, then fetch + store their
        embeddings in provider-sized chunks before commit.  An exception
        anywhere (including mid-embedding) rolls back the entire batch."""
        loop = asyncio.get_running_loop()
        async with self._get_lock():
            db = await self._ensure_db()
            txn = db.transaction()
            tx = await loop.run_in_executor(None, txn.__enter__)
            ok = False
            try:
                in_context = True
                call_lock = asyncio.Lock()
                pending: List[Tuple[DocumentId, str]] = []

                async def add_doc(
                    text: str,
                    parent_id: Optional[DocumentId] = None,
                    meta: Optional[Dict[str, Any]] = None,
                    no_embedding: bool = False,
                ) -> DocumentId:
                    assert in_context, _OUT_OF_CONTEXT
                    async with call_lock:
                        doc_id = await loop.run_in_executor(
                            None, tx.add_doc, text, parent_id, meta, None
                        )
                        if not no_embedding:
                            pending.append((doc_id, text))
                        return doc_id

                try:
                    log.info("bulk-add: transaction open")
                    yield add_doc
                finally:
                    in_context = False
                log.info("bulk-add: embedding %d documents", len(pending))
                for chunk in chunkify(pending, BULK_EMBEDDING_CHUNK_SIZE):
                    blobs = await self._embed_to_bytes([t for _, t in chunk])

                    def backfill() -> None:
                        for (doc_id, _), blob in zip(chunk, blobs):
                            tx.set_doc_embedding(doc_id, blob, skip_check_old=True)

                    await loop.run_in_executor(None, backfill)
                if pending:
                    await loop.run_in_executor(None, tx.bump_matrix_version)
                ok = True
            finally:
                # Commit on success; roll back if anything above raised.
                exc = None if ok else BaseException("rollback")
                await loop.run_in_executor(
                    None, txn.__exit__, None if ok else type(exc), exc, None
                )
                log.info("bulk-add: transaction %s", "committed" if ok else "rolled back")

    @typeguard_exempt
    @asynccontextmanager
    async def bulk_del_docs(self) -> AsyncIterator[AsyncDocumentDeleter]:
        """One transaction deleting documents (with their embeddings and
        incident edges); refuses to delete docs that still have children."""
        loop = asyncio.get_running_loop()
        async with self._get_lock():
            db = await self._ensure_db()
            txn = db.transaction()
            tx = await loop.run_in_executor(None, txn.__enter__)
            ok = False
            try:
                in_context = True
                call_lock = asyncio.Lock()

                async def del_doc(doc_id: DocumentId) -> None:
                    assert in_context, _OUT_OF_CONTEXT
                    async with call_lock:
                        await loop.run_in_executor(None, tx.del_doc, doc_id)

                try:
                    yield del_doc
                finally:
                    in_context = False
                await loop.run_in_executor(None, tx.bump_matrix_version)
                ok = True
            finally:
                exc = None if ok else BaseException("rollback")
                await loop.run_in_executor(
                    None, txn.__exit__, None if ok else type(exc), exc, None
                )

    @typeguard_exempt
    @asynccontextmanager
    async def bulk_query_docs(self) -> AsyncIterator[AsyncDocumentQuerier]:
        loop = asyncio.get_running_loop()
        async with self._get_lock():
            db = await self._ensure_db()
            txn = db.transaction()
            tx = await loop.run_in_executor(None, txn.__enter__)
            ok = False
            try:
                in_context = True
                call_lock = asyncio.Lock()

                class Querier(AsyncDocumentQuerier):
                    async def count(self) -> int:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            return await loop.run_in_executor(None, tx.count_docs)

                    async def query_doc(
                        self, doc_id: DocumentId, include_embedding: bool = False
                    ) -> DocumentRecord:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            return await loop.run_in_executor(
                                None, tx.fetch_doc, doc_id, include_embedding
                            )

                    async def query_children(
                        self, doc_id: DocumentId, include_embedding: bool = False
                    ) -> List[DocumentRecord]:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            return await loop.run_in_executor(
                                None, tx.fetch_doc_children, doc_id, include_embedding
                            )

                    async def query_level(
                        self,
                        level: int,
                        include_embedding: bool = False,
                        limit: Optional[int] = None,
                    ) -> List[DocumentRecord]:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            return await loop.run_in_executor(
                                None,
                                tx.fetch_docs_at_level,
                                level,
                                include_embedding,
                                limit,
                            )

                    async def dfs_traversal(
                        self, include_embedding: bool = False
                    ) -> AsyncIterator[DocumentRecord]:
                        async def visit(
                            doc: DocumentRecord,
                        ) -> AsyncIterator[DocumentRecord]:
                            yield doc
                            for child in await self.query_children(
                                doc["id"], include_embedding
                            ):
                                async for sub in visit(child):
                                    yield sub

                        for root in await self.query_level(0, include_embedding):
                            async for doc in visit(root):
                                yield doc

                    async def update_doc_meta(
                        self,
                        doc_id: DocumentId,
                        new_meta: Optional[Dict[str, Any]],
                    ) -> None:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            await loop.run_in_executor(
                                None, tx.update_doc_meta, doc_id, new_meta
                            )

                try:
                    yield Querier()
                finally:
                    in_context = False
                ok = True
            finally:
                exc = None if ok else BaseException("rollback")
                await loop.run_in_executor(
                    None, txn.__exit__, None if ok else type(exc), exc, None
                )

    @typeguard_exempt
    @asynccontextmanager
    async def bulk_graph_update(self) -> AsyncIterator[AsyncGraphInterface]:
        loop = asyncio.get_running_loop()
        async with self._get_lock():
            db = await self._ensure_db()
            txn = db.transaction()
            tx = await loop.run_in_executor(None, txn.__enter__)
            ok = False
            try:
                in_context = True
                call_lock = asyncio.Lock()

                class Graph(AsyncGraphInterface):
                    async def count_edges(self) -> int:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            return await loop.run_in_executor(None, tx.count_edges)

                    async def add_directed_edge(
                        self,
                        from_doc: DocumentId,
                        to_doc: DocumentId,
                        relationship: DocumentId,
                        weight: Optional[float] = None,
                    ) -> EdgeId:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            return await loop.run_in_executor(
                                None,
                                tx.add_directed_edge,
                                from_doc,
                                to_doc,
                                relationship,
                                weight,
                            )

                    async def add_edge(
                        self,
                        doc1: DocumentId,
                        doc2: DocumentId,
                        relationship: DocumentId,
                        weight: Optional[float] = None,
                    ) -> EdgeId:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            return await loop.run_in_executor(
                                None, tx.add_edge, doc1, doc2, relationship, weight
                            )

                    async def del_edge(self, edge_id: EdgeId) -> None:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            await loop.run_in_executor(None, tx.del_edge, edge_id)

                    async def edges(
                        self, limit: Optional[int] = None, offset: int = 0
                    ) -> List[EdgeRecord]:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            rows = await loop.run_in_executor(
                                None, tx.list_edges, limit, offset
                            )
                        return [_edge_record(row) for row in rows]

                    async def build_networkx_graph(
                        self, multigraph: bool = True
                    ) -> NetworkXGraphTypes:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            return await loop.run_in_executor(
                                None, tx.build_networkx_graph, multigraph
                            )

                try:
                    yield Graph()
                finally:
                    in_context = False
                ok = True
            finally:
                exc = None if ok else BaseException("rollback")
                await loop.run_in_executor(
                    None, txn.__exit__, None if ok else type(exc), exc, None
                )

    @typeguard_exempt
    @asynccontextmanager
    async def bulk_keyval_update(self) -> AsyncIterator[AsyncKeyValueInterface]:
        loop = asyncio.get_running_loop()
        async with self._get_lock():
            db = await self._ensure_db()
            txn = db.transaction()
            tx = await loop.run_in_executor(None, txn.__enter__)
            ok = False
            try:
                in_context = True
                call_lock = asyncio.Lock()

                class KeyVal(AsyncKeyValueInterface):
                    async def has(self, key: str) -> bool:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            return await loop.run_in_executor(
                                None, tx.has_key_user, key
                            )

                    async def get(self, key: str, default: Any = KeyError) -> Any:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            try:
                                return await loop.run_in_executor(
                                    None, tx.get_key_user, key
                                )
                            except KeyError:
                                if default is KeyError:
                                    raise
                                return default

                    async def set(self, key: str, val: Any) -> None:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            await loop.run_in_executor(None, tx.set_key_user, key, val)

                    async def remove(self, key: str) -> None:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            await loop.run_in_executor(None, tx.del_key_user, key)

                    async def count(self) -> int:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            return await loop.run_in_executor(
                                None, tx.count_keys_user
                            )

                    async def items(self) -> AsyncIterator[Tuple[str, Any]]:
                        assert in_context, _OUT_OF_CONTEXT
                        async with call_lock:
                            queue: asyncio.Queue = asyncio.Queue()

                            def pump() -> None:
                                try:
                                    for item in tx.iter_keyval_user():
                                        loop.call_soon_threadsafe(
                                            queue.put_nowait, item
                                        )
                                    loop.call_soon_threadsafe(queue.put_nowait, None)
                                except Exception as exc:  # forwarded below
                                    loop.call_soon_threadsafe(queue.put_nowait, exc)

                            task = loop.run_in_executor(None, pump)
                            while True:
                                item = await queue.get()
                                if item is None:
                                    break
                                if isinstance(item, Exception):
                                    raise item
                                yield item
                            await task

                try:
                    yield KeyVal()
                finally:
                    in_context = False
                ok = True
            finally:
                exc = None if ok else BaseException("rollback")
                await loop.run_in_executor(
                    None, txn.__exit__, None if ok else type(exc), exc, None
                )

    # -- retrieval ---------------------------------------------------------------

    async def retrieve(
        self,
        query: str,
        n: int,
        where: Optional[Union[DocumentPredicate, Dict[str, Any]]] = None,
    ) -> List[Retrieval]:
        """Exact cosine top-``n`` for one query string.

        ``where`` (svs_tpu extension; the reference has no filtering)
        restricts results to documents the predicate accepts — see
        :meth:`retrieve_batch`.
        """
        results = await self.retrieve_batch([query], n, where=where)
        return results[0]

    async def retrieve_batch(
        self,
        queries: List[str],
        n: int,
        where: Optional[Union[DocumentPredicate, Dict[str, Any]]] = None,
    ) -> List[List[Retrieval]]:
        """Exact cosine top-``n`` for a batch of queries: one provider call
        for the embeddings and one fused device matmul+top-k for the whole
        batch (new capability; the reference is one-query-at-a-time).

        ``where`` filters results to predicate-passing documents while
        keeping exactness: the device over-fetches an exact top-``m``
        prefix (``m = 4n`` initially), the predicate runs host-side on the
        hydrated hits in score order, and queries with fewer than ``n``
        survivors retry with ``m *= 4`` (sub-batched: satisfied queries
        don't re-run) until satisfied or the prefix covers the corpus —
        the accelerator-shaped design, since exhaustive scoring is the cheap part
        and per-document host branching must never enter the device loop.
        The predicate sees hydrated records (embedding as a presence
        boolean) and may be evaluated on a document more than once across
        rounds; a returned list shorter than ``n`` means the whole corpus
        holds fewer than ``n`` matching documents.  Predicate exceptions
        propagate to the caller.
        """
        if not queries:
            return []
        log.info("retrieving top %d for %d queries", n, len(queries))
        with phase("pack", self._stats):
            async with self._get_lock():
                corpus = await self._ensure_engine_fresh()
        if corpus.n_valid == 0 or n <= 0:
            return [[] for _ in queries]
        with phase("embed", self._stats):
            vectors = np.asarray(await self._embed(queries), dtype=np.float32)
        if where is None:
            return await self._search_hydrated(corpus, vectors, n)
        if isinstance(where, dict):
            flt: Optional[Dict[str, Any]] = where
            where = meta_filter_predicate(where)
        else:
            flt = getattr(where, "__meta_filter__", None)
        if flt is not None:
            fast = await self._prefiltered(corpus, vectors, n, flt)
            if fast is not None:
                return fast
        m = min(corpus.n_valid, max(n * _FILTER_OVERFETCH, n))
        out: List[Optional[List[Retrieval]]] = [None] * len(queries)
        pending = list(range(len(queries)))
        while True:
            results = await self._search_hydrated(
                corpus, vectors[pending], m
            )
            pending = _filter_round(
                results, pending, out, where, n, corpus.n_valid, m
            )
            if not pending:
                return [r if r is not None else [] for r in out]
            m = min(corpus.n_valid, m * 4)
            log.info(
                "filter left %d queries under-filled; widening the exact "
                "prefix to %d and retrying", len(pending), m,
            )

    async def _prefiltered(
        self,
        corpus: "PackedCorpus",
        vectors: np.ndarray,
        n: int,
        flt: Dict[str, Any],
    ) -> Optional[List[List[Retrieval]]]:
        """The pre-filter fast path for declarative meta filters: look
        the matching emb ids up (:class:`MetaRowIndex`), exactly score
        ONLY those rows (:meth:`RetrievalEngine.subset_topk` — no widen
        ladder; exact by construction), hydrate.  ``None`` = no route
        (unselective filter, mesh engine, no f32 gather source) — the
        caller runs the post-filter widen ladder instead."""
        loop = asyncio.get_running_loop()
        async with self._get_lock():
            db = await self._ensure_db()

            def plan() -> Optional[np.ndarray]:
                with db.transaction() as tx:
                    return _prefilter_emb_ids(
                        tx, self._meta_index, corpus, flt, n
                    )

            ids = await loop.run_in_executor(None, plan)
        if ids is None:
            return None
        if ids.size == 0:
            return [[] for _ in range(vectors.shape[0])]
        with phase("device_search", self._stats), profiler_trace("retrieve"):
            sub = await loop.run_in_executor(
                None,
                self.engine.subset_topk,
                corpus,
                vectors,
                ids,
                n,
                MetaRowIndex.canonical(flt),
            )
        if sub is None:
            return None
        emb, scores = sub
        with phase("finalize", self._stats):
            async with self._get_lock():
                db = await self._ensure_db()

                def heavy() -> List[List[Retrieval]]:
                    with db.transaction() as tx:
                        return _hydrate_and_mint(
                            tx, emb, scores, self._doc_cache
                        )

                return await loop.run_in_executor(None, heavy)

    async def _search_hydrated(
        self, corpus: "PackedCorpus", vectors: np.ndarray, n: int
    ) -> List[List[Retrieval]]:
        """Verified-exact top-``n`` device search + hydration for embedded
        query ``vectors`` (the widen-on-insufficient-margin loop)."""
        loop = asyncio.get_running_loop()
        if self.engine.host_route(corpus, vectors.shape[0], k=n):
            # Small corpus / small batch on a high-RPC-floor device: the
            # host exact scan beats the device round trip (identical
            # results by construction).  ``host_search`` in kb.stats()
            # says this engine answered.
            with phase("host_search", self._stats):
                emb, scores = await loop.run_in_executor(
                    None, self.engine.host_topk_exact, corpus, vectors, n
                )
            with phase("finalize", self._stats):
                async with self._get_lock():
                    db = await self._ensure_db()

                    def hydrate() -> List[List[Retrieval]]:
                        with db.transaction() as tx:
                            return _hydrate_and_mint(
                                tx, emb, scores, self._doc_cache
                            )

                    return await loop.run_in_executor(None, hydrate)
        c = c0 = self.engine.initial_candidates(n, corpus.n_valid)
        while True:
            # Recomputed each retry, at the candidate count the retry
            # dispatches: the bound is the engine's to define.
            pre_eps = (
                self.engine.prescore_eps(corpus, vectors, c)
                if self.engine.rescore
                else None
            )
            with phase("device_search", self._stats), profiler_trace("retrieve"):
                # Fastest path: prescore -> rescore -> final top-k all
                # chained on-device, compact [B, 2n+1] wire (None when
                # the device mirrors are absent).
                final = await loop.run_in_executor(
                    None, self.engine.topk_final, corpus, vectors, n, c
                )
                if final is None:
                    pre_vals, pre_rows, dev_exact = await loop.run_in_executor(
                        None, self.engine.topk_with_rescore, corpus, vectors, c
                    )
            with phase("finalize", self._stats):
                async with self._get_lock():
                    db = await self._ensure_db()

                    def heavy() -> Optional[List[List[Retrieval]]]:
                        with db.transaction() as tx:
                            if final is not None:
                                emb, scores, boundary = final
                                return _finalize_device_final(
                                    tx,
                                    corpus,
                                    emb,
                                    scores,
                                    boundary,
                                    min(c, corpus.n_valid),
                                    pre_eps,
                                    doc_cache=self._doc_cache,
                                )
                            return _finalize_batch(
                                tx,
                                corpus,
                                vectors,
                                pre_vals,
                                pre_rows,
                                n,
                                self.engine.rescore,
                                pre_eps,
                                doc_cache=self._doc_cache,
                                device_exact=dev_exact,
                            )

                    results = await loop.run_in_executor(None, heavy)
            if results is not None:
                self.engine.record_candidates(n, c, widened=(c != c0))
                return results
            # Margin check failed: prescore resolution can't separate the
            # candidate boundary.  Widen geometrically; at C = n_valid the
            # whole corpus is rescored in f32 — exact by construction.
            c = min(corpus.n_valid, c * 4)
            log.info(
                "rescore margin insufficient at the candidate boundary; "
                "widening device candidates to %d and retrying", c,
            )

    async def document_top_pairwise_scores(
        self,
        n: int,
        where: Optional[Union[DocumentPredicate, Dict[str, Any]]] = None,
    ) -> List[Tuple[float, DocumentRecord, DocumentRecord]]:
        """Top-``n`` most-similar document pairs (dedup / NSFW-filter tool).
        Runs blocked on device — no O(n_docs^2) host matrix.

        ``where`` (svs_tpu extension) restricts pairs to documents
        passing the filter — BOTH endpoints must pass — while staying
        exact: the verified pairwise loop runs against a derived corpus
        of only the matching documents
        (:meth:`RetrievalEngine.subset_pairwise_corpus`), so results
        equal running the unfiltered op on a store containing just
        those docs.  Mesh engines post-filter the exact global pair
        prefix with 4x widening instead (sound either way)."""
        loop = asyncio.get_running_loop()
        async with self._get_lock():
            corpus = await self._ensure_engine_fresh()
        filtered = False
        if where is not None:
            async with self._get_lock():
                db = await self._ensure_db()

                def resolve() -> Optional[np.ndarray]:
                    with db.transaction() as tx:
                        return _filter_match_emb_ids(
                            tx, self._meta_index, where
                        )

                ids = await loop.run_in_executor(None, resolve)
            if ids is not None:
                rows, present = corpus.rows_for_emb_ids(ids)
                if not bool(present.all()):
                    rows, ids = rows[present], ids[present]
                if rows.size < 2:
                    return []
                sub = await loop.run_in_executor(
                    None,
                    self.engine.subset_pairwise_corpus,
                    corpus, rows, ids,
                )
                if sub is None:
                    return await self._pairwise_postfiltered(n, where)
                corpus = sub
                filtered = True
        if corpus.n_valid < 2 or n <= 0:
            return []
        c = n
        c0 = None
        pre_eps = None
        if self.engine.rescore:
            c0 = c = self.engine.initial_pairwise_candidates(
                n, corpus.n_valid
            )
            pre_eps = self.engine.pairwise_eps(corpus)
        total_pairs = corpus.n_valid * (corpus.n_valid - 1) // 2
        while True:
            vals, rows_a, rows_b = await loop.run_in_executor(
                None, self.engine.pairwise_topk, corpus, c
            )
            async with self._get_lock():
                db = await self._ensure_db()

                def heavy() -> Optional[
                    List[Tuple[float, DocumentRecord, DocumentRecord]]
                ]:
                    with db.transaction() as tx:
                        return _finalize_pairwise(
                            tx, corpus, vals, rows_a, rows_b, n,
                            self.engine.rescore, pre_eps,
                            device_rescorer=lambda ra, rb:
                                self.engine.pairwise_rescore(corpus, ra, rb),
                        )

                results = await loop.run_in_executor(None, heavy)
            if results is not None:
                if c0 is not None and not filtered:
                    # subset widths would pollute the full-corpus hint
                    self.engine.record_pairwise_candidates(
                        n, c, widened=(c != c0)
                    )
                return results
            c = min(total_pairs, c * 4)
            log.info("pairwise rescore margin insufficient; widening to %d", c)

    async def _pairwise_postfiltered(
        self,
        n: int,
        where: Union[DocumentPredicate, Dict[str, Any]],
    ) -> List[Tuple[float, DocumentRecord, DocumentRecord]]:
        """Filtered pairwise for engines without a subset route (mesh):
        take the exact global top-``c`` pairs, keep those whose BOTH
        endpoints pass, widen ``c`` 4x while under-filled.  Exactness:
        any qualifying pair outside an exact top-``c`` prefix scores at
        most the c-th pair, which scores at most the n-th survivor."""
        pred = (
            meta_filter_predicate(where) if isinstance(where, dict)
            else where
        )
        async with self._get_lock():
            corpus = await self._ensure_engine_fresh()
        total = corpus.n_valid * (corpus.n_valid - 1) // 2
        c = max(n * _FILTER_OVERFETCH, n)
        while True:
            pairs = await self.document_top_pairwise_scores(min(c, total))
            kept = [t for t in pairs if pred(t[1]) and pred(t[2])]
            if len(kept) >= n or c >= total:
                return kept[:n]
            c = min(total, c * 4)
            log.info(
                "pairwise filter under-filled (%d/%d); widening the "
                "exact pair prefix to %d", len(kept), n, c,
            )


# ---------------------------------------------------------------------------
# KB (sync facade)
# ---------------------------------------------------------------------------


class KB:
    """Synchronous knowledge base for scripts and notebooks.

    Same surface as :class:`AsyncKB` with plain functions and context
    managers.  Opens eagerly.  A private event-loop thread awaits the async
    embedding providers; everything else runs on the calling thread under
    one re-entrant-free lock.
    """

    def __init__(
        self,
        local_path_or_remote_url: Union[Path, str],
        embedding_func: Optional[EmbeddingFunc] = None,
        force_fresh_db: bool = False,
        *,
        precision: str = "auto",
        rescore: Optional[bool] = None,
        mesh: Optional[Any] = None,
        device: Optional[Any] = None,
        sidecar: Union[bool, str] = "auto",
        kernel: str = "auto",
        device_rescore: str = "auto",
        replicas: Optional[Any] = None,
    ) -> None:
        self.local_path_or_remote_url = local_path_or_remote_url
        self.embedding_func = embedding_func
        self.embedding_func_orig = embedding_func
        self.engine = _make_engine(
            precision, rescore, mesh, device, kernel, device_rescore,
            replicas,
        )
        self.sidecar = sidecar
        self._stats = QueryStats()
        self._doc_cache = DocRowCache()
        self._meta_index = MetaRowIndex()
        self._lock = threading.Lock()
        self._loop = EventLoopThread()
        self.db: Optional[Database] = None
        local_path = self._loop.run(
            resolve_to_local_uncompressed_file(local_path_or_remote_url)
        )
        if sidecar is not False and not force_fresh_db:
            # see AsyncKB._ensure_db: publishers ship <db>.svsx siblings
            self._loop.run(
                try_fetch_remote_sidecar(local_path_or_remote_url, local_path)
            )
        try:
            self.db, self.embedding_func = _open_database(
                local_path, force_fresh_db, embedding_func
            )
        except BaseException:
            self._loop.stop()
            raise

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Rolling per-phase timing stats (pack/embed/search/finalize) plus
        ``pack_events`` — how each freshness check was satisfied (reuse /
        append / delete / sidecar / scan), for confirming writes ride the
        incremental pack paths."""
        out = self._stats.snapshot()
        out["pack_events"] = {k: float(v) for k, v in self.engine.pack_events.items()}
        out["dispatch"] = self.engine.dispatch_stats()
        return out

    # -- plumbing ------------------------------------------------------------

    def _require_db(self) -> Database:
        assert self.db is not None, "KB is closed"
        return self.db

    def _sidecar_path(self) -> Optional[Path]:
        if self.sidecar is False or self.db is None:
            return None
        return sidecar_path_for(self.db.path)

    def _ensure_engine_fresh(self) -> PackedCorpus:
        return self.engine.ensure_fresh(self._require_db(), self._sidecar_path())

    def load(self) -> None:
        """Warm the device corpus now; persists a sidecar per policy and
        prewarms the hydration row cache (batched hydration then never
        touches the store)."""
        with self._lock:
            corpus = self._ensure_engine_fresh()
            path = self._sidecar_path()
            if path is not None and (
                self.sidecar is True
                or (self.sidecar == "auto" and corpus.n_valid >= SIDECAR_AUTO_MIN_DOCS)
            ):
                self.engine.write_sidecar(path)
            with self._require_db().transaction() as tx:
                warmed = self._doc_cache.prewarm(tx)
            if warmed:
                log.info("hydration cache prewarmed (%d rows)", warmed)

    def warmup(
        self,
        batch_sizes: Sequence[int] = (1,),
        n: int = 16,
        rounds: int = 2,
        routes: str = "both",
    ) -> None:
        """Sync mirror of :meth:`AsyncKB.warmup` (pre-compile the search
        pipeline for the given batch sizes)."""
        corpus = self._ensure_engine_fresh()
        if corpus.n_valid == 0 or corpus.dim == 0:
            return
        rng = np.random.default_rng(0)
        for b in batch_sizes:
            for _ in range(max(1, rounds)):
                v = rng.standard_normal(
                    (int(b), corpus.dim)
                ).astype(np.float32)
                v /= np.linalg.norm(v, axis=1, keepdims=True)
                with phase("warmup", self._stats):
                    self._search_hydrated(corpus, v, min(n, corpus.n_valid))
            if (
                routes == "both"
                and corpus.device_ready
                and self.engine.host_dispatch == "auto"
                and self.engine.host_route(corpus, int(b), k=n)
            ):
                # see AsyncKB.warmup: also compile the device route so a
                # later dispatch flip never compiles on live traffic
                # (gated on device_ready and 'auto' — see there)
                prev = self.engine.host_dispatch
                self.engine.host_dispatch = "off"
                try:
                    v = rng.standard_normal(
                        (int(b), corpus.dim)
                    ).astype(np.float32)
                    v /= np.linalg.norm(v, axis=1, keepdims=True)
                    with phase("warmup", self._stats):
                        self._search_hydrated(
                            corpus, v, min(n, corpus.n_valid)
                        )
                finally:
                    self.engine.host_dispatch = prev

    def close(
        self,
        vacuum: bool = False,
        also_gzip: bool = False,
        write_sidecar: Optional[bool] = None,
    ) -> None:
        """See :meth:`AsyncKB.close` — same ``vacuum`` / ``also_gzip`` /
        publish-time ``write_sidecar`` semantics."""
        self._loop.stop()
        with self._lock:
            if self.db is None:
                return
            db = self.db
            _publish_sidecar(self.engine, self.sidecar, db, write_sidecar)
            if vacuum:
                db.vacuum()
            db.close()
            path = db.path
            self.db = None
            self.embedding_func = self.embedding_func_orig
            self.engine.invalidate()
            self.engine.shutdown()
            if also_gzip:
                atomic_gzip_file(path, f"{path}.gz")

    def _checked_embedding_func(self) -> EmbeddingFunc:
        assert self.embedding_func  # true unless closed
        return wrap_embeddings_func_check_magnitude(
            self.embedding_func, MAGNITUDE_TOLERANCE
        )

    def _embed(self, texts: List[str]) -> List[List[float]]:
        return self._loop.run(self._checked_embedding_func()(texts))

    def _embed_to_bytes(self, texts: List[str]) -> List[bytes]:
        return [embedding_to_bytes(v) for v in self._embed(texts)]

    # -- bulk operations --------------------------------------------------------

    @typeguard_exempt
    @contextmanager
    def bulk_add_docs(self) -> Iterator[DocumentAdder]:
        with self._lock:
            db = self._require_db()
            with db.transaction() as tx:
                in_context = True
                pending: List[Tuple[DocumentId, str]] = []

                def add_doc(
                    text: str,
                    parent_id: Optional[DocumentId] = None,
                    meta: Optional[Dict[str, Any]] = None,
                    no_embedding: bool = False,
                ) -> DocumentId:
                    assert in_context, _OUT_OF_CONTEXT
                    doc_id = tx.add_doc(text, parent_id, meta, None)
                    if not no_embedding:
                        pending.append((doc_id, text))
                    return doc_id

                try:
                    yield add_doc
                finally:
                    in_context = False
                for chunk in chunkify(pending, BULK_EMBEDDING_CHUNK_SIZE):
                    blobs = self._embed_to_bytes([t for _, t in chunk])
                    for (doc_id, _), blob in zip(chunk, blobs):
                        tx.set_doc_embedding(doc_id, blob, skip_check_old=True)
                if pending:
                    tx.bump_matrix_version()

    @typeguard_exempt
    @contextmanager
    def bulk_del_docs(self) -> Iterator[DocumentDeleter]:
        with self._lock:
            db = self._require_db()
            with db.transaction() as tx:
                in_context = True

                def del_doc(doc_id: DocumentId) -> None:
                    assert in_context, _OUT_OF_CONTEXT
                    tx.del_doc(doc_id)

                try:
                    yield del_doc
                finally:
                    in_context = False
                tx.bump_matrix_version()

    @typeguard_exempt
    @contextmanager
    def bulk_query_docs(self) -> Iterator[DocumentQuerier]:
        with self._lock:
            db = self._require_db()
            with db.transaction() as tx:
                in_context = True

                class Querier(DocumentQuerier):
                    def count(self) -> int:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.count_docs()

                    def query_doc(
                        self, doc_id: DocumentId, include_embedding: bool = False
                    ) -> DocumentRecord:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.fetch_doc(doc_id, include_embedding)

                    def query_children(
                        self, doc_id: DocumentId, include_embedding: bool = False
                    ) -> List[DocumentRecord]:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.fetch_doc_children(doc_id, include_embedding)

                    def query_level(
                        self,
                        level: int,
                        include_embedding: bool = False,
                        limit: Optional[int] = None,
                    ) -> List[DocumentRecord]:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.fetch_docs_at_level(
                            level, include_embedding, limit
                        )

                    def dfs_traversal(
                        self, include_embedding: bool = False
                    ) -> Iterator[DocumentRecord]:
                        def visit(doc: DocumentRecord) -> Iterator[DocumentRecord]:
                            yield doc
                            for child in self.query_children(
                                doc["id"], include_embedding
                            ):
                                yield from visit(child)

                        for root in self.query_level(0, include_embedding):
                            yield from visit(root)

                    def update_doc_meta(
                        self,
                        doc_id: DocumentId,
                        new_meta: Optional[Dict[str, Any]],
                    ) -> None:
                        assert in_context, _OUT_OF_CONTEXT
                        tx.update_doc_meta(doc_id, new_meta)

                try:
                    yield Querier()
                finally:
                    in_context = False

    @typeguard_exempt
    @contextmanager
    def bulk_graph_update(self) -> Iterator[GraphInterface]:
        with self._lock:
            db = self._require_db()
            with db.transaction() as tx:
                in_context = True

                class Graph(GraphInterface):
                    def count_edges(self) -> int:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.count_edges()

                    def add_directed_edge(
                        self,
                        from_doc: DocumentId,
                        to_doc: DocumentId,
                        relationship: DocumentId,
                        weight: Optional[float] = None,
                    ) -> EdgeId:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.add_directed_edge(
                            from_doc, to_doc, relationship, weight
                        )

                    def add_edge(
                        self,
                        doc1: DocumentId,
                        doc2: DocumentId,
                        relationship: DocumentId,
                        weight: Optional[float] = None,
                    ) -> EdgeId:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.add_edge(doc1, doc2, relationship, weight)

                    def del_edge(self, edge_id: EdgeId) -> None:
                        assert in_context, _OUT_OF_CONTEXT
                        tx.del_edge(edge_id)

                    def edges(
                        self, limit: Optional[int] = None, offset: int = 0
                    ) -> List[EdgeRecord]:
                        assert in_context, _OUT_OF_CONTEXT
                        return [
                            _edge_record(row)
                            for row in tx.list_edges(limit, offset)
                        ]

                    def build_networkx_graph(
                        self, multigraph: bool = True
                    ) -> NetworkXGraphTypes:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.build_networkx_graph(multigraph)

                try:
                    yield Graph()
                finally:
                    in_context = False

    @typeguard_exempt
    @contextmanager
    def bulk_keyval_update(self) -> Iterator[KeyValueInterface]:
        with self._lock:
            db = self._require_db()
            with db.transaction() as tx:
                in_context = True

                class KeyVal(KeyValueInterface):
                    def has(self, key: str) -> bool:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.has_key_user(key)

                    def __contains__(self, key: str) -> bool:
                        return self.has(key)

                    def get(self, key: str, default: Any = KeyError) -> Any:
                        assert in_context, _OUT_OF_CONTEXT
                        try:
                            return tx.get_key_user(key)
                        except KeyError:
                            if default is KeyError:
                                raise
                            return default

                    def __getitem__(self, key: str) -> Any:
                        return self.get(key)

                    def set(self, key: str, val: Any) -> None:
                        assert in_context, _OUT_OF_CONTEXT
                        tx.set_key_user(key, val)

                    def __setitem__(self, key: str, val: Any) -> None:
                        self.set(key, val)

                    def remove(self, key: str) -> None:
                        assert in_context, _OUT_OF_CONTEXT
                        tx.del_key_user(key)

                    def __delitem__(self, key: str) -> None:
                        self.remove(key)

                    def count(self) -> int:
                        assert in_context, _OUT_OF_CONTEXT
                        return tx.count_keys_user()

                    def __len__(self) -> int:
                        return self.count()

                    def items(self) -> Iterator[Tuple[str, Any]]:
                        assert in_context, _OUT_OF_CONTEXT
                        yield from tx.iter_keyval_user()

                    def __iter__(self) -> Iterator[str]:
                        assert in_context, _OUT_OF_CONTEXT
                        yield from tx.iter_keys_user()

                try:
                    yield KeyVal()
                finally:
                    in_context = False

    # -- retrieval ------------------------------------------------------------------

    def retrieve(
        self,
        query: str,
        n: int,
        where: Optional[Union[DocumentPredicate, Dict[str, Any]]] = None,
    ) -> List[Retrieval]:
        return self.retrieve_batch([query], n, where=where)[0]

    def retrieve_batch(
        self,
        queries: List[str],
        n: int,
        where: Optional[Union[DocumentPredicate, Dict[str, Any]]] = None,
    ) -> List[List[Retrieval]]:
        """Sync mirror of :meth:`AsyncKB.retrieve_batch` (incl. the
        ``where`` filtered-retrieval extension)."""
        if not queries:
            return []
        log.info("retrieving top %d for %d queries", n, len(queries))
        with phase("pack", self._stats), self._lock:
            corpus = self._ensure_engine_fresh()
        if corpus.n_valid == 0 or n <= 0:
            return [[] for _ in queries]
        with phase("embed", self._stats):
            vectors = np.asarray(self._embed(queries), dtype=np.float32)
        if where is None:
            return self._search_hydrated(corpus, vectors, n)
        if isinstance(where, dict):
            flt: Optional[Dict[str, Any]] = where
            where = meta_filter_predicate(where)
        else:
            flt = getattr(where, "__meta_filter__", None)
        if flt is not None:
            fast = self._prefiltered(corpus, vectors, n, flt)
            if fast is not None:
                return fast
        m = min(corpus.n_valid, max(n * _FILTER_OVERFETCH, n))
        out: List[Optional[List[Retrieval]]] = [None] * len(queries)
        pending = list(range(len(queries)))
        while True:
            results = self._search_hydrated(corpus, vectors[pending], m)
            pending = _filter_round(
                results, pending, out, where, n, corpus.n_valid, m
            )
            if not pending:
                return [r if r is not None else [] for r in out]
            m = min(corpus.n_valid, m * 4)
            log.info(
                "filter left %d queries under-filled; widening the exact "
                "prefix to %d and retrying", len(pending), m,
            )

    def _prefiltered(
        self,
        corpus: PackedCorpus,
        vectors: np.ndarray,
        n: int,
        flt: Dict[str, Any],
    ) -> Optional[List[List[Retrieval]]]:
        """Sync mirror of :meth:`AsyncKB._prefiltered`."""
        with self._lock:
            db = self._require_db()
            with db.transaction() as tx:
                ids = _prefilter_emb_ids(
                    tx, self._meta_index, corpus, flt, n
                )
        if ids is None:
            return None
        if ids.size == 0:
            return [[] for _ in range(vectors.shape[0])]
        with phase("device_search", self._stats), profiler_trace("retrieve"):
            sub = self.engine.subset_topk(
                corpus, vectors, ids, n, MetaRowIndex.canonical(flt)
            )
        if sub is None:
            return None
        emb, scores = sub
        with phase("finalize", self._stats), self._lock:
            db = self._require_db()
            with db.transaction() as tx:
                return _hydrate_and_mint(tx, emb, scores, self._doc_cache)

    def _search_hydrated(
        self, corpus: PackedCorpus, vectors: np.ndarray, n: int
    ) -> List[List[Retrieval]]:
        if self.engine.host_route(corpus, vectors.shape[0], k=n):
            # see AsyncKB._search_hydrated: host exact scan beats the
            # device round trip at this corpus x batch size
            with phase("host_search", self._stats):
                emb, scores = self.engine.host_topk_exact(
                    corpus, vectors, n
                )
            with phase("finalize", self._stats), self._lock:
                db = self._require_db()
                with db.transaction() as tx:
                    return _hydrate_and_mint(tx, emb, scores, self._doc_cache)
        c = c0 = self.engine.initial_candidates(n, corpus.n_valid)
        while True:
            # Recomputed each retry — see AsyncKB._search_hydrated.
            pre_eps = (
                self.engine.prescore_eps(corpus, vectors, c)
                if self.engine.rescore
                else None
            )
            with phase("device_search", self._stats), profiler_trace("retrieve"):
                final = self.engine.topk_final(corpus, vectors, n, c)
                if final is None:
                    pre_vals, pre_rows, dev_exact = (
                        self.engine.topk_with_rescore(corpus, vectors, c)
                    )
            with phase("finalize", self._stats), self._lock:
                db = self._require_db()
                with db.transaction() as tx:
                    if final is not None:
                        emb, scores, boundary = final
                        results = _finalize_device_final(
                            tx, corpus, emb, scores, boundary,
                            min(c, corpus.n_valid), pre_eps,
                            doc_cache=self._doc_cache,
                        )
                    else:
                        results = _finalize_batch(
                            tx, corpus, vectors, pre_vals, pre_rows, n,
                            self.engine.rescore, pre_eps,
                            doc_cache=self._doc_cache,
                            device_exact=dev_exact,
                        )
            if results is not None:
                self.engine.record_candidates(n, c, widened=(c != c0))
                return results
            c = min(corpus.n_valid, c * 4)
            log.info(
                "rescore margin insufficient at the candidate boundary; "
                "widening device candidates to %d and retrying", c,
            )

    def document_top_pairwise_scores(
        self,
        n: int,
        where: Optional[Union[DocumentPredicate, Dict[str, Any]]] = None,
    ) -> List[Tuple[float, DocumentRecord, DocumentRecord]]:
        """Sync mirror of :meth:`AsyncKB.document_top_pairwise_scores`
        (incl. the ``where=`` filtered-pairwise extension)."""
        with self._lock:
            corpus = self._ensure_engine_fresh()
        filtered = False
        if where is not None:
            with self._lock:
                db = self._require_db()
                with db.transaction() as tx:
                    ids = _filter_match_emb_ids(
                        tx, self._meta_index, where
                    )
            if ids is not None:
                rows, present = corpus.rows_for_emb_ids(ids)
                if not bool(present.all()):
                    rows, ids = rows[present], ids[present]
                if rows.size < 2:
                    return []
                sub = self.engine.subset_pairwise_corpus(
                    corpus, rows, ids
                )
                if sub is None:
                    return self._pairwise_postfiltered(n, where)
                corpus = sub
                filtered = True
        if corpus.n_valid < 2 or n <= 0:
            return []
        c = n
        c0 = None
        pre_eps = None
        if self.engine.rescore:
            c0 = c = self.engine.initial_pairwise_candidates(
                n, corpus.n_valid
            )
            pre_eps = self.engine.pairwise_eps(corpus)
        total_pairs = corpus.n_valid * (corpus.n_valid - 1) // 2
        while True:
            vals, rows_a, rows_b = self.engine.pairwise_topk(corpus, c)
            with self._lock:
                db = self._require_db()
                with db.transaction() as tx:
                    results = _finalize_pairwise(
                        tx, corpus, vals, rows_a, rows_b, n,
                        self.engine.rescore, pre_eps,
                        device_rescorer=lambda ra, rb:
                            self.engine.pairwise_rescore(corpus, ra, rb),
                    )
            if results is not None:
                if c0 is not None and not filtered:
                    # subset widths would pollute the full-corpus hint
                    self.engine.record_pairwise_candidates(
                        n, c, widened=(c != c0)
                    )
                return results
            c = min(total_pairs, c * 4)
            log.info("pairwise rescore margin insufficient; widening to %d", c)

    def _pairwise_postfiltered(
        self,
        n: int,
        where: Union[DocumentPredicate, Dict[str, Any]],
    ) -> List[Tuple[float, DocumentRecord, DocumentRecord]]:
        """Sync mirror of :meth:`AsyncKB._pairwise_postfiltered`."""
        pred = (
            meta_filter_predicate(where) if isinstance(where, dict)
            else where
        )
        with self._lock:
            corpus = self._ensure_engine_fresh()
        total = corpus.n_valid * (corpus.n_valid - 1) // 2
        c = max(n * _FILTER_OVERFETCH, n)
        while True:
            pairs = self.document_top_pairwise_scores(min(c, total))
            kept = [t for t in pairs if pred(t[1]) and pred(t[2])]
            if len(kept) >= n or c >= total:
                return kept[:n]
            c = min(total, c * 4)
            log.info(
                "pairwise filter under-filled (%d/%d); widening the "
                "exact pair prefix to %d", len(kept), n, c,
            )

    def __len__(self) -> int:
        with self._lock:
            db = self._require_db()
            with db.transaction() as tx:
                return tx.count_docs()
