"""Corpus replication: N single-chip replicas, queries split across them.

The mesh path (``parallel.sharded``) shards the CORPUS — it buys
capacity (corpora past one chip's HBM) and per-query latency, at the
cost of a cross-device merge per batch.  Replication is the opposite trade for
corpora that FIT one chip: every device holds a full copy of the pack,
an incoming query batch splits into per-device sub-batches, and each
replica runs the unmodified single-chip pipeline (fused prescore
kernels, on-device f32 rescore, final tie-rule selection) on its slice.
No collectives, no merge — results concatenate — so throughput scales
~linearly with devices while each query sees single-chip latency.

This is the throughput analog of scaling the reference by
running more processes against the same SQLite file (its hot path is
one ``np.dot`` per process, ``svs/kb.py:1185``): here one process
drives all replicas, the store stays the single source of truth, and
the pack is cloned device-to-device once per store change.

Design notes:

- The PRIMARY engine (devices[0]) owns the store relationship: packing,
  sidecar reads/writes, incremental appends, width hints.  Secondaries
  never touch SQLite; they receive clones of the primary's pack via
  ``jax.device_put`` (device-to-device, no host round trip on real
  hardware) keyed by pack identity — a store change reclones.
- Host-side state (``emb_ids``, the f32 rescore cache) is shared by
  reference across replicas; device mirrors (rescore gather source,
  int32 emb ids) are built per device by the same policy code the
  single-chip engine uses.
- Per-replica batch sizes can differ by one query (``np.array_split``);
  kernel dispatch is evaluated at the REPLICA batch size, and the
  prescore error bound depends on the storage precision alone, so it
  holds whichever route a slice takes.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import jax
import numpy as np

from ..engine.index import RetrievalEngine
from ..engine.packing import PackedCorpus
from ..store.db import Database

log = logging.getLogger(__name__)


class ReplicaEngine(RetrievalEngine):
    """A :class:`RetrievalEngine` whose corpus is replicated over
    ``devices`` and whose batched searches fan out across them.

    Single-query calls run on the primary device exactly like a plain
    engine; batches of ``B`` queries split into ``min(B, n_devices)``
    contiguous slices dispatched concurrently (JAX dispatch is async —
    the slices execute in parallel; threads only overlap the blocking
    result fetches).  Pairwise scoring (corpus x corpus, no query batch
    to split) runs on the primary, inherited unchanged.
    """

    def __init__(
        self,
        precision: str = "auto",
        rescore: Optional[bool] = None,
        devices: Optional[Sequence[jax.Device]] = None,
        n_replicas: Optional[int] = None,
        kernel: str = "auto",
        device_rescore: str = "auto",
    ) -> None:
        devs = list(devices) if devices is not None else jax.devices()
        if n_replicas is not None:
            if n_replicas < 1:
                raise ValueError("n_replicas must be >= 1")
            if n_replicas > len(devs):
                raise ValueError(
                    f"n_replicas={n_replicas} but only {len(devs)} "
                    "devices available"
                )
            devs = devs[:n_replicas]
        if not devs:
            raise ValueError("no devices for replication")
        super().__init__(
            precision=precision,
            rescore=rescore,
            device=devs[0],
            kernel=kernel,
            device_rescore=device_rescore,
        )
        self.devices: List[jax.Device] = devs
        #: Secondary engines (one per extra device) — pure, stateless
        #: compute endpoints: they never see the store, and they carry NO
        #: corpus state (clones ride the corpus snapshot itself, see
        #: ``PackedCorpus.replica_clones``) — every engine method takes
        #: the corpus explicitly, so an in-flight search is pinned to its
        #: snapshot's clones even across a concurrent re-pack.
        self._secondaries: List[RetrievalEngine] = [
            RetrievalEngine(
                precision=precision,
                rescore=rescore,
                device=d,
                kernel=kernel,
                device_rescore=device_rescore,
            )
            for d in devs[1:]
        ]
        self._clone_lock = threading.Lock()
        # Eager pool (no lazy check-then-set race); shut down via
        # :meth:`shutdown` (KB.close calls it) and re-created by
        # :meth:`ensure_fresh` if the KB reopens (AsyncKB is documented
        # to lazily reopen after close()).
        self._pool: Optional[ThreadPoolExecutor] = (
            self._make_pool() if len(devs) > 1 else None
        )

    # -- replication ---------------------------------------------------------

    def _make_pool(self) -> ThreadPoolExecutor:
        return ThreadPoolExecutor(
            max_workers=max(1, len(self.devices) - 1),
            thread_name_prefix="svs-tpu-replica",
        )

    def shutdown(self) -> None:
        """Release the fan-out worker threads (KB/AsyncKB ``close()``
        call this) and every engine's background uploaders — the
        secondaries upload their own rescore mirrors, and a daemon
        thread caught mid-transfer at interpreter exit aborts the
        process.  A search racing the shutdown degrades to running its
        slices inline (see :meth:`_run`); the next :meth:`ensure_fresh`
        re-creates the pool if the KB reopens."""
        super().shutdown()
        for eng in self._secondaries:
            eng.shutdown()
        with self._clone_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def _clone_corpus(
        self, corpus: PackedCorpus, dev: jax.Device
    ) -> PackedCorpus:
        clone = PackedCorpus(
            data=jax.device_put(corpus.data, dev),
            row_scales=(
                jax.device_put(corpus.row_scales, dev)
                if corpus.row_scales is not None
                else None
            ),
            emb_ids=corpus.emb_ids,  # host state: shared by reference
            n_valid=corpus.n_valid,
            dim=corpus.dim,
            version=corpus.version,
            precision=corpus.precision,
            scale_max=corpus.scale_max,
            host_cache=corpus.host_cache,
        )
        return clone

    def _sync_replicas(self, corpus: PackedCorpus) -> None:
        """Attach one clone per secondary device to ``corpus`` (idempotent
        per pack).  Also re-checks per call: the primary's host rescore
        cache can attach late (background rebuild), and the clones'
        device mirrors should follow without waiting for a store change.
        """
        with self._clone_lock:
            clones = corpus.replica_clones
            if clones is None:
                # a deferred cold-start pack must land on the primary
                # before clones copy device->device
                self._await_pack_device(corpus)
                log.info(
                    "cloning pack to %d replica device(s)",
                    len(self._secondaries),
                )
                clones = tuple(
                    self._clone_corpus(corpus, eng.device)
                    for eng in self._secondaries
                )
                # single atomic publish: readers see all clones or none
                object.__setattr__(corpus, "replica_clones", clones)
            for eng, c in zip(self._secondaries, clones):
                if c.host_cache is None and corpus.host_cache is not None:
                    # late-attached rescore cache: share it so the clone
                    # can build its device mirror too
                    object.__setattr__(c, "host_cache", corpus.host_cache)
                eng._maybe_build_device_rescore(c)

    def ensure_fresh(
        self,
        db: Database,
        sidecar_path: Union[str, Path, None] = None,
    ) -> PackedCorpus:
        corpus = super().ensure_fresh(db, sidecar_path=sidecar_path)
        if self._secondaries:
            with self._clone_lock:
                if self._pool is None:  # reopened after close()
                    self._pool = self._make_pool()
        self._sync_replicas(corpus)
        return corpus

    # -- fan-out -------------------------------------------------------------

    def _plan(
        self, corpus: PackedCorpus, queries: np.ndarray
    ) -> List[Tuple[RetrievalEngine, PackedCorpus, np.ndarray]]:
        """Split a query batch into per-replica ``(engine, clone, slice)``
        work items (contiguous slices, sizes within one of each other).
        Fewer queries than replicas -> only the first ``B`` replicas run.
        The clones come from the CALLER's corpus snapshot
        (``replica_clones``), so a concurrent re-pack can never mix packs
        within one search; a corpus that was never synced (no clones)
        runs entirely on the primary."""
        b = queries.shape[0]
        clones = corpus.replica_clones
        if clones is None or b <= 1 or not self._secondaries:
            return [(self, corpus, queries)]
        pairs: List[Tuple[RetrievalEngine, PackedCorpus]] = [
            (self, corpus),
            *zip(self._secondaries, clones),
        ]
        r = min(len(pairs), b)
        return [
            (eng, c, q)
            for (eng, c), q in zip(pairs[:r], np.array_split(queries, r))
        ]

    def topk(
        self, corpus: PackedCorpus, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        plan = self._plan(corpus, queries)
        if len(plan) == 1:
            return super().topk(corpus, queries, k)
        outs = self._run(
            plan, lambda eng, c, q: RetrievalEngine.topk(eng, c, q, k)
        )
        return (
            np.concatenate([o[0] for o in outs], axis=0),
            np.concatenate([o[1] for o in outs], axis=0),
        )

    def topk_with_rescore(
        self, corpus: PackedCorpus, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        plan = self._plan(corpus, queries)
        if len(plan) == 1:
            return super().topk_with_rescore(corpus, queries, k)
        outs = self._run(
            plan,
            lambda eng, c, q: RetrievalEngine.topk_with_rescore(
                eng, c, q, k
            ),
        )
        vals = np.concatenate([o[0] for o in outs], axis=0)
        rows = np.concatenate([o[1] for o in outs], axis=0)
        if any(o[2] is None for o in outs):
            # mixed device/host rescore across replicas (e.g. a mirror
            # budget edge): callers treat None as "host rescore needed";
            # degrade the whole batch rather than mix exact sources
            return vals, rows, None
        exact = np.concatenate([o[2] for o in outs], axis=0)
        return vals, rows, exact

    def topk_final(
        self, corpus: PackedCorpus, queries: np.ndarray, n: int, c: int
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        plan = self._plan(corpus, queries)
        if len(plan) == 1:
            return super().topk_final(corpus, queries, n, c)
        outs = self._run(
            plan,
            lambda eng, cl, q: RetrievalEngine.topk_final(
                eng, cl, q, n, c
            ),
        )
        if any(o is None for o in outs):
            return None  # callers fall back to topk_with_rescore
        return (
            np.concatenate([o[0] for o in outs], axis=0),
            np.concatenate([o[1] for o in outs], axis=0),
            np.concatenate([o[2] for o in outs], axis=0),
        )

    def _run(
        self,
        plan: List[Tuple[RetrievalEngine, PackedCorpus, np.ndarray]],
        fn: "Callable[[RetrievalEngine, PackedCorpus, np.ndarray], Any]",
    ) -> List[Any]:
        """Run ``fn(engine, clone, slice)`` for every plan entry —
        secondaries on the pool (their fetches block concurrently), the
        primary's slice on the calling thread.  A ``close()`` racing an
        in-flight search (pool gone or shut down between planning and
        here) degrades to running the slices inline — slower, never
        wrong, never an internal error."""
        pool = self._pool
        futures: List[Tuple[bool, Any]] = []
        for entry in plan[1:]:
            try:
                if pool is None:
                    raise RuntimeError("no pool")
                futures.append((True, pool.submit(fn, *entry)))
            except RuntimeError:  # shut down mid-flight
                pool = None
                futures.append((False, entry))
        first = fn(*plan[0])
        out = [first]
        for ok, item in futures:
            out.append(item.result() if ok else fn(*item))
        return out
