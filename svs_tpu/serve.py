"""HTTP serving facade with request micro-batching.

The reference positions its async KB for web services
(``/root/reference/README.md:42-44``) but has no serving layer, and its
engine pays a full corpus scan per query either way.  On an accelerator
the economics invert: one batched device step over ``B`` queries costs
ONE corpus read, so the right server shape is a **micro-batcher** —
concurrent ``/retrieve`` requests coalesce into single
:meth:`AsyncKB.retrieve_batch` steps bounded by a small time window.

Overload behavior: the batcher bounds *outstanding* queries — queued
AND in flight on the device (``max_queue``, default 16 batches' worth);
a request that would exceed the bound is shed immediately with **429
Too Many Requests**, and admission is all-or-nothing per request (a
multi-query request is never half-enqueued, so no device time is spent
on work the client will see 429'd) — on a saturated device, queueing
further only converts overload into timeout storms.

Routes (JSON in/out):

- ``GET  /healthz``   -> ``{"ok": true, "docs": N, "warming": bool}``
  (doc count cached ~1 s so health probes never add store queries under
  load; ``warming`` is true while a background pack or f32-mirror
  upload runs)
- ``GET  /stats``     -> KB phase timings + server batching counters
- ``POST /retrieve``  -> ``{"query": str | "queries": [str], "n": int,
  "meta_filter"?: {key: value}}`` -> one result list per query; each hit
  is ``{"score": float, "doc": DocumentRecord}`` (embeddings reported as
  presence booleans).  ``meta_filter`` restricts hits to documents whose
  meta carries every given key at exactly the given value (exact
  filtered retrieval via the KB's ``where=`` widen ladder; filtered
  requests skip co-batching but share the admission bound)
- ``POST /pairwise``  -> ``{"n": int, "meta_filter"?: {key: value}}`` ->
  top-n most-similar document pairs (the reference's
  ``document_top_pairwise_scores``); ``meta_filter`` restricts pairs to
  documents whose meta equals every given value (both endpoints)
- ``POST /add``       -> ``{"texts": [str], "metas": [obj]?}`` (only with
  ``writable=True``; at most ``MAX_ADD_TEXTS`` per request) -> ``{"ids":
  [int]}``
- ``POST /delete``    -> ``{"ids": [int]}`` (writable only)
- ``GET  /doc/{id}``  -> ``{"doc": DocumentRecord}``; 404 unknown id
- ``GET  /doc/{id}/children`` -> ``{"docs": [DocumentRecord]}``
- ``GET  /level/{level}``     -> ``{"docs": [...], "truncated": bool}``
  (at most ``MAX_LEVEL_DOCS`` records per response)
- ``PUT  /doc/{id}/meta``     -> JSON body = the new meta object or
  ``null`` (writable only)
- ``GET  /graph/edges``       -> ``{"edges": [EdgeRecord], "total": N}``
  (``?limit=`` up to ``MAX_EDGE_LIST``, ``?offset=`` for paging)
- ``POST /graph/edge``        -> ``{"a": id, "b": id, "relationship": id,
  "weight"?: float, "directed"?: bool}`` (writable only) ->
  ``{"edge_id": int}``; 409 on a duplicate ``(a, b, r)`` triplet
- ``DELETE /graph/edge/{id}`` (writable only); 404 unknown edge
- ``GET  /kv/{key}``, ``PUT /kv/{key}`` (JSON body = value, writable
  only), ``DELETE /kv/{key}`` (writable only) — the user key/value store

Start from the CLI: ``svs-tpu serve kb.sqlite --port 8080``.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import logging

from .kb import AsyncKB, meta_filter_predicate
from .types import Retrieval

log = logging.getLogger(__name__)

try:  # aiohttp is the 'http' extra (same dependency as the providers)
    from aiohttp import web
except ImportError:  # pragma: no cover - exercised by import guard test
    web = None  # type: ignore[assignment]

#: Typed application keys (created at import time — lazy creation in
#: make_app raced: two first-callers could mint distinct AppKey objects,
#: leaving the module attribute mismatched with the key an app was
#: stored under).  None only when aiohttp is absent, so the module still
#: imports.  Embedders: ``app[serve.KB_KEY]``.
KB_KEY: "Optional[Any]" = (
    web.AppKey("kb", object) if web is not None else None
)
BATCHER_KEY: "Optional[Any]" = (
    web.AppKey("batcher", object) if web is not None else None
)

#: Default micro-batch window: long enough to coalesce a burst arriving
#: within one event-loop tick + scheduling jitter, short next to the
#: ~4 ms device step it feeds.
DEFAULT_WINDOW_MS = 2.0
#: Largest micro-batch: the batch the engine's headline cell measures.
DEFAULT_MAX_BATCH = 256
#: Default outstanding-query bound, in batches (queued + in flight):
#: past this the server sheds (429) rather than queueing — see module
#: docstring.
DEFAULT_MAX_QUEUE_BATCHES = 16
#: Upper bound on per-request result count (rescore over-provisions 4x
#: on the device; an unbounded n would let one request drive an
#: arbitrarily large device top-k).
MAX_RETRIEVE_N = 1000
#: Upper bound on texts per /add request: one request is one transaction
#: (and one embedding-provider burst); callers with more chunk client-side.
MAX_ADD_TEXTS = 1000
#: Upper bound on /pairwise n (pair hydration is 2 docs per pair).
MAX_PAIRWISE_N = 10_000
#: Upper bound on documents per /level/{level} response (a level can hold
#: the whole corpus; the route reports ``truncated`` when it clips).
MAX_LEVEL_DOCS = 1000
#: Upper bound on edges per /graph/edges page (?limit= is clamped here);
#: unpaginated requests get DEFAULT_EDGE_LIST edges.
MAX_EDGE_LIST = 10_000
DEFAULT_EDGE_LIST = 1000
#: /healthz doc-count cache lifetime.
HEALTH_CACHE_S = 1.0


class Overloaded(Exception):
    """Raised by :meth:`MicroBatcher.retrieve` when the queue is full."""


def _n_bucket(n: int) -> int:
    """Next power of two >= n: requests in the same bucket co-batch.

    ``retrieve_batch`` runs the whole batch at one candidate width, so one
    n=1000 request co-batched with 255 n=10 requests would multiply the
    device candidate count (and the rescore gather) for everyone by 100x.
    Bucketing bounds that inflation at 2x while keeping the batching win
    for the (typical) homogeneous-n traffic.
    """
    b = 1
    while b < n:
        b <<= 1
    return b


class MicroBatcher:
    """Coalesces concurrent retrieve calls into batched device steps.

    Single-event-loop discipline: all state is touched only from loop
    callbacks, so no locks are needed.  A request either rides the next
    flush (queue below ``max_batch``) or triggers an immediate one; a
    request arriving at a full queue raises :class:`Overloaded`.
    """

    def __init__(
        self,
        kb: AsyncKB,
        max_batch: int = DEFAULT_MAX_BATCH,
        window_ms: float = DEFAULT_WINDOW_MS,
        max_queue: Optional[int] = None,
    ) -> None:
        self._kb = kb
        self._max_batch = max(1, int(max_batch))
        self._window_s = max(0.0, float(window_ms)) / 1e3
        if max_queue is None:
            max_queue = DEFAULT_MAX_QUEUE_BATCHES * self._max_batch
        self._max_queue = max(1, int(max_queue))
        self._queue: List[Tuple[str, int, "asyncio.Future[List[Retrieval]]"]] = []
        self._timer: Optional[asyncio.TimerHandle] = None
        #: Admitted-but-unresolved queries (queued + in flight on the
        #: device).  The overload bound must count in-flight work too:
        #: _flush drains the queue synchronously, so under sustained
        #: saturation the *queue* stays near-empty while unbounded
        #: concurrent batches pile up — bounding only queue length would
        #: never shed.
        self._pending = 0
        # observability
        self.requests = 0
        self.batches = 0
        self.batched_queries = 0
        self.shed = 0

    async def retrieve(self, query: str, n: int) -> List[Retrieval]:
        return (await self.retrieve_many([query], n))[0]

    async def run_unbatched(
        self,
        queries: List[str],
        n: int,
        where: "Any",
    ) -> List[List[Retrieval]]:
        """Run a filtered request directly on the KB (per-request
        predicates can't co-batch), still charged against the same
        admission bound as batched queries so the overload contract
        (bounded outstanding device work, 429 past it) holds."""
        if self._pending + len(queries) > self._max_queue:
            self.shed += len(queries)
            raise Overloaded(
                f"retrieve queue full ({self._max_queue} outstanding)"
            )
        self._pending += len(queries)
        self.requests += len(queries)
        try:
            return await self._kb.retrieve_batch(queries, n, where=where)
        finally:
            self._pending -= len(queries)

    async def retrieve_many(
        self, queries: List[str], n: int
    ) -> List[List[Retrieval]]:
        """Admit ``queries`` all-or-nothing, then await their results.

        Capacity is checked for the WHOLE request before any query is
        enqueued (admission is synchronous — no await between check and
        enqueue), so an overloaded server never spends device time on a
        request it is about to 429.
        """
        if self._pending + len(queries) > self._max_queue:
            self.shed += len(queries)
            raise Overloaded(
                f"retrieve queue full ({self._max_queue} outstanding)"
            )
        loop = asyncio.get_running_loop()
        futs: List["asyncio.Future[List[Retrieval]]"] = []
        for query in queries:
            fut: "asyncio.Future[List[Retrieval]]" = loop.create_future()
            fut.add_done_callback(self._on_done)
            self._queue.append((query, n, fut))
            self._pending += 1
            futs.append(fut)
        self.requests += len(queries)
        if len(self._queue) >= self._max_batch:
            self._cancel_timer()
            asyncio.ensure_future(self._flush())
        elif self._queue and self._timer is None:
            self._timer = loop.call_later(
                self._window_s, lambda: asyncio.ensure_future(self._flush())
            )
        # return_exceptions so a failed batch's sibling futures are all
        # retrieved here (a bare gather left "exception was never
        # retrieved" warnings for every query after the first); re-raise
        # the first failure for the route's error handling
        results = await asyncio.gather(*futs, return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return list(results)  # type: ignore[arg-type]

    def _on_done(self, fut: "asyncio.Future[List[Retrieval]]") -> None:
        self._pending -= 1
        if fut.cancelled():
            # a disconnected client's query must leave the queue with its
            # capacity slot, or a timeout storm defeats the overload bound
            # (pending drains while dead queries still fill the queue AND
            # burn device batches)
            self._queue = [it for it in self._queue if it[2] is not fut]

    def _cancel_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    async def _flush(self) -> None:
        self._cancel_timer()
        batch = self._queue[: self._max_batch]
        self._queue = self._queue[self._max_batch :]
        if not batch:
            return
        if self._queue:
            # leftover burst: keep draining without waiting another window
            asyncio.ensure_future(self._flush())
        self.batches += 1
        self.batched_queries += len(batch)
        # co-batch per n-bucket: a single outlier n must not multiply the
        # device candidate width for the whole batch (see _n_bucket)
        groups: Dict[int, List[Tuple[str, int, Any]]] = {}
        for item in batch:
            # cap at MAX_RETRIEVE_N: bucketing must not round a legal n
            # (<= the cap) up past the cap it exists to enforce
            groups.setdefault(
                min(_n_bucket(item[1]), MAX_RETRIEVE_N), []
            ).append(item)
        await asyncio.gather(
            *(self._run_group(bucket_n, items)
              for bucket_n, items in groups.items())
        )

    async def _run_group(
        self, bucket_n: int, items: List[Tuple[str, int, Any]]
    ) -> None:
        # Bucket the BATCH SIZE too (pad with copies of the first
        # query, results discarded): every distinct batch size is a
        # distinct jit shape, so coalescing bursts of 14, 23, 61, ...
        # queries would compile a fresh kernel per burst size — measured
        # as 10s-class p99 stalls through the whole load window.
        # Padding with a REAL query (not zeros) keeps every batch row
        # unit-norm, so the rescore margin proof behaves identically.
        texts = [q for q, _, _ in items]
        pad_to = min(self._max_batch, _n_bucket(len(texts)))
        if pad_to > len(texts):
            texts = texts + [texts[0]] * (pad_to - len(texts))
        try:
            results = await self._kb.retrieve_batch(texts, bucket_n)
        except Exception as exc:  # propagate to every waiter
            for _, _, fut in items:
                if not fut.done():
                    fut.set_exception(exc)
            return
        for (_, n, fut), res in zip(items, results):
            if not fut.done():
                fut.set_result(res[:n])


def _doc_json(doc: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(doc)
    # embeddings may be float lists when callers asked for them; the wire
    # format reports presence only (payloads are corpus-sized)
    if not isinstance(out.get("embedding"), (bool, type(None))):
        out["embedding"] = True
    return out


class _DocFragmentCache:
    """Per-doc preserialized JSON fragments for the /retrieve hot path.

    Measured: at 100k docs x 64 clients the server tops out ~554 QPS
    with the device under it sustaining ~39k — the residual is Python
    JSON encoding of ``{"score": s, "doc": {...}}`` per hit.  Hot docs
    repeat across requests, so serialize each DocumentRecord ONCE and
    assemble responses by byte concatenation.

    Staleness: each cached fragment stores the doc dict it was built
    from and re-validates by ONE C-level dict equality per hit (~25x
    cheaper than re-serializing).  This is airtight under any write
    concurrency — a changed doc (meta update, re-add, foreign writer)
    simply compares unequal and re-serializes — with no epoch/token
    plumbing to race.
    """

    def __init__(self, max_entries: int = 200_000) -> None:
        # Two-generation (segmented) eviction: on overflow the current
        # segment becomes the old one and a fresh segment starts; hits
        # in the old segment promote.  A wholesale clear() thrashed at
        # corpora larger than the cache (1M docs, uniform hits): every
        # clear dropped the hottest entries along with the coldest, so
        # the hit rate collapsed to ~0 right when the cache was full.
        # Segments keep roughly the hottest half resident forever.
        self._seg_max = max(1, max_entries // 2)
        self._frags: Dict[int, Tuple[Dict[str, Any], bytes]] = {}
        self._old: Dict[int, Tuple[Dict[str, Any], bytes]] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._frags) + len(self._old)

    def frag(self, doc: Dict[str, Any]) -> bytes:
        key = doc["id"]
        entry = self._frags.get(key)
        if entry is None:
            entry = self._old.get(key)
            promoted = entry is not None
        else:
            promoted = False
        if entry is not None and entry[0] == doc:
            self.hits += 1
            if promoted:
                self._store(key, entry)
            return entry[1]
        self.misses += 1
        raw = json.dumps(
            _doc_json(doc), separators=(",", ":"), ensure_ascii=False
        ).encode()
        # ``doc`` is the minted hit dict (never aliased by the caller
        # after rendering), so retaining it as the validation witness is
        # safe.
        self._store(key, (doc, raw))
        return raw

    def _store(
        self, key: int, entry: Tuple[Dict[str, Any], bytes]
    ) -> None:
        if len(self._frags) >= self._seg_max:
            self._old = self._frags
            self._frags = {}
        # AFTER any rotation: drop the old-segment copy on promotion or
        # refresh — popping before rotation would leave a stale
        # duplicate behind when the refreshed key was in the segment
        # that just rotated out (double-counted in __len__, wasted
        # protected slot).
        self._old.pop(key, None)
        self._frags[key] = entry

    def render(
        self, results: List[List[Retrieval]], single: bool
    ) -> bytes:
        """The full ``{"results": ...}`` response body as bytes."""
        frag = self.frag
        qparts = []
        for res in results:
            qparts.append(
                b"[" + b",".join(
                    b'{"score":%s,"doc":%s}'
                    % (repr(r["score"]).encode(), frag(r["doc"]))
                    for r in res
                ) + b"]"
            )
        if single:
            return b'{"results":' + qparts[0] + b"}"
        return b'{"results":[' + b",".join(qparts) + b"]}"


async def _json_body(request: "web.Request") -> Dict[str, Any]:
    try:
        body = await request.json()
    except ValueError:
        raise web.HTTPBadRequest(text="body must be JSON")
    if not isinstance(body, dict):
        raise web.HTTPBadRequest(text="body must be a JSON object")
    return body


def _int_match(request: "web.Request", name: str) -> int:
    """Parse an integer path segment (400 on garbage)."""
    raw = request.match_info[name]
    try:
        return int(raw)
    except ValueError:
        raise web.HTTPBadRequest(text=f"'{name}' must be an integer, got {raw!r}")


def _int_field(body: Dict[str, Any], name: str) -> int:
    val = body.get(name)
    if isinstance(val, bool) or not isinstance(val, int):
        raise web.HTTPBadRequest(text=f"'{name}' must be an integer")
    return val


def make_app(
    kb: AsyncKB,
    *,
    writable: bool = False,
    max_batch: int = DEFAULT_MAX_BATCH,
    window_ms: float = DEFAULT_WINDOW_MS,
    max_queue: Optional[int] = None,
) -> "web.Application":
    """Build the aiohttp application serving ``kb``."""
    if web is None:  # pragma: no cover
        raise RuntimeError(
            "aiohttp is required for serving: pip install 'svs-tpu[http]'"
        )
    fragcache = _DocFragmentCache()
    batcher = MicroBatcher(
        kb, max_batch=max_batch, window_ms=window_ms, max_queue=max_queue
    )
    app = web.Application()
    # typed AppKeys (aiohttp 3.9+ deprecates bare string keys); exposed
    # as module attributes so embedders can read app[serve.KB_KEY]
    app[KB_KEY] = kb
    app[BATCHER_KEY] = batcher
    # (count, monotonic deadline); shared mutable cell for the health cache
    health_cache: List[Tuple[int, float]] = []

    async def healthz(request: "web.Request") -> "web.Response":
        now = time.monotonic()
        if health_cache and now < health_cache[0][1]:
            docs = health_cache[0][0]
        else:
            async with kb.bulk_query_docs() as q:
                docs = await q.count()
            health_cache[:] = [(docs, now + HEALTH_CACHE_S)]
        return web.json_response(
            {
                "ok": True,
                "docs": docs,
                # true while the background f32-mirror upload is still in
                # flight: results are exact either way, but batched
                # latency improves once it lands — load balancers can
                # prefer non-warming replicas.
                "warming": (kb.engine.pack_uploading
                            or kb.engine.mirror_uploading),
                # live serving internals: a collapsing fragment-cache
                # hit rate or a deep batcher queue is the first sign of
                # host-side saturation
                "fragment_cache": {
                    "hits": fragcache.hits,
                    "misses": fragcache.misses,
                    "entries": len(fragcache),
                },
                "queue_depth": batcher._pending,
            }
        )

    async def stats(request: "web.Request") -> "web.Response":
        return web.json_response(
            {
                "kb": kb.stats(),
                "server": {
                    "requests": batcher.requests,
                    "batches": batcher.batches,
                    "batched_queries": batcher.batched_queries,
                    "shed": batcher.shed,
                    "avg_batch": (
                        batcher.batched_queries / batcher.batches
                        if batcher.batches
                        else 0.0
                    ),
                },
            }
        )

    async def retrieve(request: "web.Request") -> "web.Response":
        body = await _json_body(request)
        n = body.get("n", 10)
        if isinstance(n, bool) or not isinstance(n, int) or not (
            0 < n <= MAX_RETRIEVE_N
        ):
            raise web.HTTPBadRequest(
                text=f"'n' must be an integer in [1, {MAX_RETRIEVE_N}]"
            )
        if "queries" in body:
            queries = body["queries"]
            single = False
        elif "query" in body:
            queries = [body["query"]]
            single = True
        else:
            raise web.HTTPBadRequest(text="missing 'query' or 'queries'")
        if not isinstance(queries, list) or not all(
            isinstance(q, str) for q in queries
        ):
            raise web.HTTPBadRequest(text="'queries' must be a list of strings")
        meta_filter = body.get("meta_filter")
        if meta_filter is not None and not isinstance(meta_filter, dict):
            raise web.HTTPBadRequest(
                text="'meta_filter' must be a JSON object of "
                "meta-key -> required-value equalities"
            )
        try:
            if meta_filter:
                # Filtered requests can't co-batch (each carries its own
                # predicate + widen ladder): run them directly on the KB,
                # but count them against the same admission bound so the
                # overload contract holds for every route.
                results = await batcher.run_unbatched(
                    queries, n, where=meta_filter_predicate(meta_filter)
                )
            else:
                results = await batcher.retrieve_many(queries, n)
        except Overloaded as exc:
            raise web.HTTPTooManyRequests(text=str(exc))
        return web.Response(
            body=fragcache.render(results, single),
            content_type="application/json",
        )

    async def pairwise(request: "web.Request") -> "web.Response":
        body = await _json_body(request)
        n = body.get("n", 10)
        if isinstance(n, bool) or not isinstance(n, int) or not (
            0 < n <= MAX_PAIRWISE_N
        ):
            raise web.HTTPBadRequest(
                text=f"'n' must be an integer in [1, {MAX_PAIRWISE_N}]"
            )
        meta_filter = body.get("meta_filter")
        if meta_filter is not None and not isinstance(meta_filter, dict):
            raise web.HTTPBadRequest(
                text="'meta_filter' must be a JSON object of "
                "meta-key -> required-value equalities"
            )
        pairs = await kb.document_top_pairwise_scores(
            n, where=meta_filter or None
        )
        payload = [
            {
                "score": score,
                "doc_a": _doc_json(dict(a)),
                "doc_b": _doc_json(dict(b)),
            }
            for score, a, b in pairs
        ]
        return web.json_response({"pairs": payload})

    def _require_writable() -> None:
        if not writable:
            raise web.HTTPForbidden(text="server started read-only")

    async def add(request: "web.Request") -> "web.Response":
        _require_writable()
        body = await _json_body(request)
        texts = body.get("texts")
        if not isinstance(texts, list) or not all(
            isinstance(t, str) for t in texts
        ):
            raise web.HTTPBadRequest(text="'texts' must be a list of strings")
        if len(texts) > MAX_ADD_TEXTS:
            raise web.HTTPRequestEntityTooLarge(
                max_size=MAX_ADD_TEXTS, actual_size=len(texts)
            )
        metas = body.get("metas")
        if metas is None:
            metas = [None] * len(texts)
        if not isinstance(metas, list) or len(metas) != len(texts):
            raise web.HTTPBadRequest(
                text="'metas' must be a list matching 'texts'"
            )
        ids: List[int] = []
        async with kb.bulk_add_docs() as add_doc:
            for text, meta in zip(texts, metas):
                ids.append(await add_doc(text, meta=meta))
        return web.json_response({"ids": ids})

    async def delete(request: "web.Request") -> "web.Response":
        _require_writable()
        body = await _json_body(request)
        ids = body.get("ids")
        if not isinstance(ids, list) or not all(
            isinstance(i, int) and not isinstance(i, bool) for i in ids
        ):
            raise web.HTTPBadRequest(text="'ids' must be a list of integers")
        if len(ids) > MAX_ADD_TEXTS:
            raise web.HTTPRequestEntityTooLarge(
                max_size=MAX_ADD_TEXTS, actual_size=len(ids)
            )
        try:
            async with kb.bulk_del_docs() as del_doc:
                for doc_id in ids:
                    await del_doc(doc_id)
        except RuntimeError as exc:  # delete-with-children etc.
            raise web.HTTPConflict(text=str(exc))
        except KeyError as exc:
            raise web.HTTPNotFound(text=f"no such document: {exc}")
        return web.json_response({"deleted": len(ids)})

    async def doc_get(request: "web.Request") -> "web.Response":
        doc_id = _int_match(request, "id")
        async with kb.bulk_query_docs() as q:
            try:
                doc = await q.query_doc(doc_id)
            except KeyError:
                raise web.HTTPNotFound(text=f"no such document: {doc_id}")
        return web.json_response({"doc": _doc_json(dict(doc))})

    async def doc_children(request: "web.Request") -> "web.Response":
        doc_id = _int_match(request, "id")
        async with kb.bulk_query_docs() as q:
            try:
                await q.query_doc(doc_id)  # 404 on unknown parent
            except KeyError:
                raise web.HTTPNotFound(text=f"no such document: {doc_id}")
            docs = await q.query_children(doc_id)
        return web.json_response(
            {"docs": [_doc_json(dict(d)) for d in docs]}
        )

    async def doc_level(request: "web.Request") -> "web.Response":
        level = _int_match(request, "level")
        # limit pushed into SQL: a level can hold the whole corpus, and a
        # bounded response must not hydrate O(corpus) docs to produce it.
        async with kb.bulk_query_docs() as q:
            docs = await q.query_level(level, limit=MAX_LEVEL_DOCS + 1)
        truncated = len(docs) > MAX_LEVEL_DOCS
        return web.json_response(
            {
                "docs": [_doc_json(dict(d)) for d in docs[:MAX_LEVEL_DOCS]],
                "truncated": truncated,
            }
        )

    async def doc_meta_put(request: "web.Request") -> "web.Response":
        _require_writable()
        doc_id = _int_match(request, "id")
        try:
            meta = await request.json()
        except ValueError:
            raise web.HTTPBadRequest(text="body must be JSON (the new meta)")
        if meta is not None and not isinstance(meta, dict):
            raise web.HTTPBadRequest(text="meta must be a JSON object or null")
        async with kb.bulk_query_docs() as q:
            try:
                await q.update_doc_meta(doc_id, meta)
            except KeyError:
                raise web.HTTPNotFound(text=f"no such document: {doc_id}")
        return web.json_response({"id": doc_id, "ok": True})

    async def graph_edges(request: "web.Request") -> "web.Response":
        try:
            limit = int(request.query.get("limit", DEFAULT_EDGE_LIST))
            offset = int(request.query.get("offset", 0))
        except ValueError:
            raise web.HTTPBadRequest(text="limit/offset must be integers")
        if not (0 < limit <= MAX_EDGE_LIST) or offset < 0:
            raise web.HTTPBadRequest(
                text=f"limit must be in [1, {MAX_EDGE_LIST}], offset >= 0"
            )
        async with kb.bulk_graph_update() as g:
            total = await g.count_edges()
            edges = await g.edges(limit, offset)
        return web.json_response({"edges": edges, "total": total})

    async def graph_edge_add(request: "web.Request") -> "web.Response":
        _require_writable()
        body = await _json_body(request)
        a = _int_field(body, "a")
        b = _int_field(body, "b")
        rel = _int_field(body, "relationship")
        weight = body.get("weight")
        if weight is not None and not isinstance(weight, (int, float)):
            raise web.HTTPBadRequest(text="'weight' must be a number")
        directed = body.get("directed", False)
        if not isinstance(directed, bool):
            raise web.HTTPBadRequest(text="'directed' must be a boolean")
        try:
            async with kb.bulk_graph_update() as g:
                if directed:
                    edge_id = await g.add_directed_edge(a, b, rel, weight)
                else:
                    edge_id = await g.add_edge(a, b, rel, weight)
        except RuntimeError as exc:  # duplicate (a, b, r) triplet
            # (endpoints are NOT validated: SQLite FK enforcement is off
            # by default and the reference leaves it off — parity)
            raise web.HTTPConflict(text=str(exc))
        return web.json_response({"edge_id": edge_id})

    async def graph_edge_delete(request: "web.Request") -> "web.Response":
        _require_writable()
        edge_id = _int_match(request, "id")
        try:
            async with kb.bulk_graph_update() as g:
                await g.del_edge(edge_id)
        except KeyError:
            raise web.HTTPNotFound(text=f"no such edge: {edge_id}")
        return web.json_response({"edge_id": edge_id, "ok": True})

    async def kv_get(request: "web.Request") -> "web.Response":
        key = request.match_info["key"]
        async with kb.bulk_keyval_update() as kv:
            if not await kv.has(key):
                raise web.HTTPNotFound(text=f"no such key: {key!r}")
            val = await kv.get(key)
        return web.json_response({"key": key, "value": val})

    async def kv_put(request: "web.Request") -> "web.Response":
        _require_writable()
        key = request.match_info["key"]
        try:
            value = await request.json()
        except ValueError:
            raise web.HTTPBadRequest(text="body must be JSON (the value)")
        if isinstance(value, bool) or not isinstance(value, (str, int, float)):
            # KV values are SQLite-bindable scalars (reference semantics:
            # whatever `keyval_user.val` accepts) — a dict/list/bool would
            # come back as something else on read, and the schema's
            # NOT NULL rejects null at the store layer
            raise web.HTTPBadRequest(
                text="value must be a JSON string or number"
            )
        async with kb.bulk_keyval_update() as kv:
            await kv.set(key, value)
        return web.json_response({"key": key, "ok": True})

    async def kv_delete(request: "web.Request") -> "web.Response":
        _require_writable()
        key = request.match_info["key"]
        async with kb.bulk_keyval_update() as kv:
            if not await kv.has(key):
                raise web.HTTPNotFound(text=f"no such key: {key!r}")
            await kv.remove(key)
        return web.json_response({"key": key, "ok": True})

    app.router.add_get("/healthz", healthz)
    app.router.add_get("/stats", stats)
    app.router.add_post("/retrieve", retrieve)
    app.router.add_post("/pairwise", pairwise)
    app.router.add_post("/add", add)
    app.router.add_post("/delete", delete)
    app.router.add_get("/doc/{id}", doc_get)
    app.router.add_get("/doc/{id}/children", doc_children)
    app.router.add_get("/level/{level}", doc_level)
    app.router.add_put("/doc/{id}/meta", doc_meta_put)
    app.router.add_get("/graph/edges", graph_edges)
    app.router.add_post("/graph/edge", graph_edge_add)
    app.router.add_delete("/graph/edge/{id}", graph_edge_delete)
    app.router.add_get("/kv/{key}", kv_get)
    app.router.add_put("/kv/{key}", kv_put)
    app.router.add_delete("/kv/{key}", kv_delete)
    return app


def warm_bucket_ladder(max_batch: int) -> List[int]:
    """The batch sizes a server should pre-compile: the micro-batcher
    pads coalesced bursts to powers of two (``_run_group``), so the
    reachable jit shapes are exactly 1, 2, 4, ..., max_batch."""
    out = [1]
    while out[-1] < max_batch:
        out.append(min(out[-1] * 2, max_batch))
    return out


def backend_platform() -> str:
    """The platform JAX would pick in this environment, asked of a child
    process (with preallocation off) so that THIS process starts no JAX
    backend before it forks."""
    import subprocess
    import sys

    env = dict(os.environ, XLA_PYTHON_CLIENT_PREALLOCATE="false")
    out = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.default_backend())"],
        env=env, capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def run_server(
    db_path: str,
    *,
    host: str = "127.0.0.1",
    port: int = 8080,
    writable: bool = False,
    max_batch: int = DEFAULT_MAX_BATCH,
    window_ms: float = DEFAULT_WINDOW_MS,
    max_queue: Optional[int] = None,
    warm: bool = True,
    warm_n: int = 16,
    workers: int = 1,
    **kb_kwargs: Any,
) -> None:
    """Open ``db_path`` and serve it until interrupted (CLI entry).

    ``warm`` (default on) pre-compiles the batcher's power-of-two batch
    shapes before accepting traffic — at 1M x 1536 each first-use
    compile costs seconds, which otherwise lands as multi-second tail
    latency on early live requests.

    ``workers`` > 1 forks that many processes sharing the port via
    ``SO_REUSEPORT`` (the kernel load-balances accepts); each worker
    opens the KB independently — reads share the SQLite file and the
    sidecar, writes serialize through SQLite's own locking.  Workers
    multiply the HOST side (HTTP, JSON render, hydration, host-path
    scans), and each starts its own JAX client, so they run only on the
    CPU backend: on a GPU the first client reserves most of the card's
    memory and the others could not hold a pack.  With a GPU, serve one
    worker; several cards go to one worker with the replica engine
    (``parallel.ReplicaEngine``).  The backend is decided by a probe
    process before anything here starts JAX (:func:`backend_platform`)."""
    if workers > 1:
        platform = backend_platform()
        if platform != "cpu":
            raise ValueError(
                f"--workers {workers} needs the CPU backend, but JAX "
                f"would run on {platform!r}: every worker starts its own "
                "JAX client and the first takes most of the device's "
                "memory.  Serve with --workers 1 (and replicas for "
                "several devices), or set JAX_PLATFORMS=cpu."
            )
    if web is None:
        raise RuntimeError(
            "aiohttp is required for serving: pip install 'svs-tpu[http]'"
        )

    worker_pids: List[int] = []
    forked = False
    if workers > 1:
        import os as _os

        if not hasattr(_os, "fork"):  # pragma: no cover - windows
            log.warning("--workers needs fork(); serving single-process")
        else:
            # Fork BEFORE any JAX backend / KB initialization: a forked
            # XLA client is undefined behavior, so each worker must
            # initialize its own from scratch.
            forked = True
            for _ in range(workers - 1):
                pid = _os.fork()
                if pid == 0:
                    worker_pids = []  # child: serves, owns no siblings
                    break
                worker_pids.append(pid)
            if worker_pids:
                # Parent: translate SIGTERM (systemd/docker stop) into
                # the KeyboardInterrupt path so the finally block below
                # reaps the children — the default disposition would
                # kill only the parent and orphan workers still holding
                # the SO_REUSEPORT socket.
                import signal as _signal

                def _term(_sig: int, _frm: object) -> None:
                    raise KeyboardInterrupt

                _signal.signal(_signal.SIGTERM, _term)

    async def _main() -> None:
        kb = AsyncKB(db_path, **kb_kwargs)
        await kb.load()  # pack the corpus before accepting traffic
        if warm:
            t0 = time.perf_counter()
            await kb.warmup(warm_bucket_ladder(max_batch), n=warm_n)
            log.info("warmup (%d batch shapes): %.1fs",
                     len(warm_bucket_ladder(max_batch)),
                     time.perf_counter() - t0)
        app = make_app(
            kb,
            writable=writable,
            max_batch=max_batch,
            window_ms=window_ms,
            max_queue=max_queue,
        )
        runner = web.AppRunner(app)
        await runner.setup()
        # reuse_port only when fork actually happened — on platforms
        # without fork/SO_REUSEPORT the documented fallback is plain
        # single-process serving, not a TCPSite ValueError.
        site = web.TCPSite(
            runner, host, port, reuse_port=forked or None
        )
        await site.start()
        log.info("serving %s on http://%s:%d (pid %d)",
                 db_path, host, port, __import__("os").getpid())

        closing = asyncio.Event()

        async def rewarm_after_uploads() -> None:
            """A deferred-upload cold start warms host-only (blocking
            startup on the multi-GB transfer would be worse); once the
            uploads land, warm the shapes the LIVE dispatch now picks —
            routes='live' so no shared dispatch state is toggled while
            traffic flows — in the background, so the host->device flip
            doesn't jit-compile on live requests."""
            try:
                if not warm:
                    return
                corpus = kb.engine.corpus
                if corpus is None or corpus.device_ready:
                    return
                loop = asyncio.get_running_loop()
                settled = await loop.run_in_executor(
                    None, lambda: kb.engine.wait_for_mirror(timeout=1800)
                )
                if settled and not closing.is_set():
                    t0 = time.perf_counter()
                    await kb.warmup(
                        warm_bucket_ladder(max_batch), n=warm_n,
                        routes="live",
                    )
                    log.info("post-upload device warmup: %.1fs",
                             time.perf_counter() - t0)
            except asyncio.CancelledError:
                raise
            except Exception:
                # fire-and-forget: an unlogged failure here would
                # silently re-expose live traffic to first-use compiles
                log.warning("post-upload warmup failed", exc_info=True)

        rewarm = asyncio.ensure_future(rewarm_after_uploads())
        try:
            await asyncio.Event().wait()
        finally:
            closing.set()  # the executor leg of rewarm checks this
            rewarm.cancel()
            await runner.cleanup()
            await kb.close()

    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        pass
    finally:
        if worker_pids:
            import os as _os
            import signal as _signal

            for pid in worker_pids:
                try:
                    _os.kill(pid, _signal.SIGINT)
                except OSError:
                    pass
            for pid in worker_pids:
                try:
                    _os.waitpid(pid, 0)
                except OSError:
                    pass
