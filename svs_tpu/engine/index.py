"""RetrievalEngine: owns the device-resident corpus and runs searches.

This is the device-resident replacement for the reference's ``_EmbeddingsMatrix``
RAM cache (``svs/kb.py:856-893``).  Responsibilities:

- **freshness** — derived device state is keyed by the store's
  ``matrix_version`` counter plus a ``(count, max id, generation)``
  fingerprint of the embeddings table (generation = trigger-maintained
  write counter, see ``store.db``), so packs are reused across queries and
  rebuilt exactly when the store changed — including changes made by the
  reference implementation, which doesn't know about the counters but
  can't write the shared file without firing the triggers;
- **cold start** — on open, a fresh sidecar file is mmap'd straight to the
  device instead of rescanning BLOBs;
- **search dispatch** — single-chip jitted matmul+top-k (f32/bf16/int8) or
  the mesh-sharded path with per-shard top-k and a cross-device merge;
- **candidate sizing** — when rescoring is on (the default for every
  precision: beyond undoing storage quantization, the rescore stage owns
  the reference tie rule and the exactness proof), the device returns an
  over-provisioned candidate set whose exact f32 rescore happens against
  the store (see ``KB.retrieve``), keeping recall exact.
"""

from __future__ import annotations

import functools
import hashlib
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..store.db import Database
from ..utils import device_memory
from .packing import (
    DIM_MULTIPLE,
    LARGE_ROW_MULTIPLE,
    ROW_MULTIPLE,
    HostPack,
    PackedCorpus,
    pack_corpus,
    pad_queries,
)
from .sidecar import load_sidecar, save_sidecar

log = logging.getLogger(__name__)

#: Initial candidate over-provisioning for the rescore stage.  This is a
#: starting point, not a guarantee: exactness is *verified* per query by the
#: margin check in the KB facades (``prescore_eps``), which widens the
#: candidate set geometrically whenever prescore resolution can't separate
#: the boundary (e.g. score clusters inside one bf16 ulp).
CANDIDATE_MULTIPLIER = 4
CANDIDATE_MIN_EXTRA = 32

#: Corpora with at least this many padded rows switch the result wire
#: format from indices-as-f32-values (exact below 2^24) to the int32
#: layout (exact for any size; see ``ops.topk.pack_vals_idx``).
WIDE_INDEX_MIN_ROWS = 1 << 24

#: f32 rescore mirrors up to this size upload synchronously inside
#: ``ensure_fresh`` (deterministic for small corpora and tests); larger
#: ones move to a background thread so the cold first query never waits
#: on the device transfer — rescore rides the host cache until the
#: mirror publishes.  32 MB: big enough that every test corpus stays
#: deterministic, small enough that a 10k x 1536 cold start (61 MB
#: mirror, seconds over a slow device link) answers its first query from the
#: host path instead of waiting out the upload.
_MIRROR_SYNC_MAX_BYTES = 32 * 1024 * 1024

#: Staged-copy granularity for mirror uploads (see
#: ``RetrievalEngine._upload_f32_mirror``).
_MIRROR_CHUNK_BYTES = 64 * 1024 * 1024

#: Host-dispatch guard: ceiling on the ``[B, n_valid]`` f32 score matrix
#: the host exact scan materializes.  Bounds batch x corpus at the sizes
#: where the host can win anyway (small corpora / small batches).
_HOST_SCAN_MAX_SCORE_BYTES = 256 * 1024 * 1024

#: Prior for the host's exact-scan bandwidth (bytes/s the per-query
#: ``np.dot`` matvec sustains over the f32 cache).  Deliberately
#: conservative for 1-vCPU-class hosts; refined in place by an EWMA of
#: measured scans (``RetrievalEngine.host_topk_exact``).  Env override:
#: ``SVS_TPU_HOST_SCAN_BW``.
_HOST_SCAN_BW_PRIOR = 6e9

#: Prior for the device round-trip floor, used until a clean measurement
#: lands (remote devices measured ~25-30 ms; local PCIe <1 ms).
#: The floor must NOT be measured while uploads or queries are in
#: flight: a tiny probe queued behind a 600 MB mirror chunk measured
#: 50 s and poisoned the dispatch into host scans under load.  Env
#: override: ``SVS_TPU_RPC_FLOOR``.
_RPC_FLOOR_PRIOR = 0.030


@jax.jit
def _write_rows(buf: jax.Array, new: jax.Array, n0: jax.Array) -> jax.Array:
    start = (n0,) + (0,) * (buf.ndim - 1)
    return jax.lax.dynamic_update_slice(buf, new, start)


class _MirrorUploadAborted(Exception):
    """Raised inside the background mirror uploader when shutdown() asks
    it to stop mid-transfer."""


def _marks_inflight(fn: Callable[..., Any]) -> Callable[..., Any]:
    """Bracket a device-touching engine method with the in-flight count
    and last-arrival timestamp the background mirror uploader yields to —
    queries (including their multi-second first compiles) always win the
    device link over the opportunistic mirror transfer."""

    @functools.wraps(fn)
    def wrapper(self: Any, *args: Any, **kwargs: Any) -> Any:
        self._last_query_t = time.monotonic()
        with self._inflight_lock:
            self._inflight += 1
        try:
            return fn(self, *args, **kwargs)
        finally:
            with self._inflight_lock:
                self._inflight -= 1
            self._last_query_t = time.monotonic()

    return wrapper


def _grow_rows(
    old: jax.Array, new: jax.Array, n0: int, row_multiple: int
) -> jax.Array:
    """Write ``new`` rows at offset ``n0`` of ``old`` (leading axis),
    growing the zero-padded buffer to the next row multiple if needed."""
    needed = n0 + new.shape[0]
    if needed > old.shape[0]:
        grown_rows = ((needed + row_multiple - 1) // row_multiple) * row_multiple
        grown = jnp.zeros((grown_rows,) + old.shape[1:], old.dtype)
        old = _write_rows(grown, old, 0)
    return _write_rows(old, new, jnp.int32(n0))


@jax.jit
def _move_rows(buf: jax.Array, src: jax.Array, dst: jax.Array) -> jax.Array:
    """Copy rows ``src`` over rows ``dst`` along the leading axis — the
    swap-compaction step of the incremental-delete pack path.  Functional
    (`.at[].set` allocates a fresh buffer), so in-flight searches holding
    the previous corpus snapshot keep exactly the rows they started with."""
    return buf.at[dst].set(buf[src], unique_indices=True)


def _grow_rows_np(
    old: np.ndarray, new: np.ndarray, n0: int, row_multiple: int
) -> np.ndarray:
    """Host mirror of :func:`_grow_rows` (always copies: ``old`` may be a
    read-only sidecar memmap)."""
    needed = n0 + new.shape[0]
    if needed > old.shape[0]:
        grown_rows = ((needed + row_multiple - 1) // row_multiple) * row_multiple
        out = np.zeros((grown_rows,) + old.shape[1:], old.dtype)
        out[: old.shape[0]] = old
    else:
        out = np.array(old)
    out[n0 : n0 + new.shape[0]] = new.astype(old.dtype, copy=False)
    return out


def _mirror_dim(mirror: jax.Array, corpus: "PackedCorpus") -> Optional[int]:
    """``dim`` argument for the rescore stages: a true-dim mirror (the
    uploaded f32 cache) needs the padded queries sliced down to match;
    an f32 pack reused as the gather source is padded-width, and its
    zero columns against the zero query padding make the slice
    unnecessary (``None`` keeps the shapes aligned)."""
    return corpus.dim if int(mirror.shape[1]) == corpus.dim else None


@functools.partial(jax.jit, static_argnames=("k", "wide", "dim"))
def _rescore_from_packed(
    packed: jax.Array,
    dev_f32: jax.Array,
    dev_map: Optional[jax.Array],
    queries: jax.Array,
    k: int,
    wide: bool,
    dim: Optional[int] = None,
) -> jax.Array:
    """Device-side rescore chained onto the packed prescore wire: decode
    candidate rows in-graph, gather their exact f32 vectors from the HBM
    mirror, dot against the (true-dim) queries, and emit a COMPACT wire —
    one array, one host fetch.  ``dev_map is None`` vs not are separate
    traces (static pytree structure).

    Compact layout ``[B, 2C + 1]``: candidate rows (C) ++ exact scores
    (C) ++ the C-th (lowest) prescore value (1) — of the C prescore
    values, the margin proof needs only the boundary one, and dropping
    the rest cuts a third of the fetch bytes."""
    if dim is not None and dim != queries.shape[1]:
        queries = queries[:, :dim]  # padded upload; mirror rows are true-dim
    if wide:
        rows = packed[:, k:]  # already int32
        rows_wire = rows
        tail = jax.lax.bitcast_convert_type(
            packed[:, k - 1 : k], jnp.float32
        )
    else:
        rows = packed[:, k:].astype(jnp.int32)
        rows_wire = packed[:, k:]
        tail = packed[:, k - 1 : k]
    gr = rows if dev_map is None else dev_map[rows]
    cand = dev_f32[gr]  # [B, C, d] gather in HBM
    # HIGHEST: this IS the exact-f32 rescore the margin proof stands on;
    # the default runs f32 in TF32, ~1e-3 relative (see
    # ops.topk.f32_dot_precision) — far beyond the proof's cushion.
    exact = jax.lax.dot_general(
        cand,
        queries,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    if wide:
        return jnp.concatenate(
            [
                rows_wire,
                jax.lax.bitcast_convert_type(exact, jnp.int32),
                jax.lax.bitcast_convert_type(tail, jnp.int32),
            ],
            axis=1,
        )
    return jnp.concatenate([rows_wire, exact, tail], axis=1)


@functools.partial(jax.jit, static_argnames=("k", "wide", "dim"))
def _final_from_packed(
    packed: jax.Array,
    dev_f32: jax.Array,
    dev_map: Optional[jax.Array],
    dev_emb: jax.Array,
    queries: jax.Array,
    k: int,
    wide: bool,
    dim: Optional[int] = None,
) -> jax.Array:
    """Device-side rescore AND final top-k selection chained onto the
    packed prescore wire (C candidates): gather + exact f32 dot as in
    :func:`_rescore_from_packed`, then order the candidates with the
    REFERENCE tie rule — descending exact score, equal scores break to
    the larger emb id (``svs/util.py:190-203``: the reference sorts a
    matrix in emb-id order, so its argpartition ties resolve that way) —
    in ONE lexicographic ``lax.sort``, and emit only the winners.

    Compact int32 wire ``[B, 2k + 1]``: top-k emb ids ++ top-k exact
    score bits ++ boundary-prescore bits (the one value of the C
    prescores the margin proof reads).  vs the ``[B, 2C + 1]`` rescore
    wire this cuts fetch bytes ~4x at the default C = 4k and moves the
    two [B, C] host argsorts onto the device."""
    from ..ops.topk import final_select_wire, unpack_rows_tail

    if dim is not None and dim != queries.shape[1]:
        queries = queries[:, :dim]  # padded upload; mirror rows are true-dim
    rows, tail_bits = unpack_rows_tail(packed, packed.shape[1] // 2, wide)
    gr = rows if dev_map is None else dev_map[rows]
    cand = dev_f32[gr]  # [B, C, d] gather in HBM
    # HIGHEST: exact-f32 rescore (see _rescore_from_packed).
    exact = jax.lax.dot_general(
        cand,
        queries,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    emb_of = dev_emb[rows]  # [B, C] int32
    return final_select_wire(exact, emb_of, tail_bits, k)


@functools.partial(jax.jit, static_argnames=("k", "dim"))
def _subset_final(
    dev_f32: jax.Array,
    dev_map: Optional[jax.Array],
    rows: jax.Array,
    emb_of: jax.Array,
    n_live: jax.Array,
    queries: jax.Array,
    k: int,
    dim: Optional[int] = None,
) -> jax.Array:
    """Exact top-``k`` over an EXPLICIT row subset — the pre-filter fast
    path for selective metadata filters (the reference has no filtering;
    this is the device analog of scanning only the matching rows).

    ``rows`` are int32 pack rows padded to a static width (padding
    repeats row 0), ``emb_of`` the matching int32 emb ids (padding
    value irrelevant — masked scores are ``-inf`` and ``k`` never
    exceeds the live count), ``n_live`` the live prefix length.  Gather
    the subset's exact f32 vectors from the HBM mirror, one HIGHEST
    [B, d] x [F, d]^T dot, mask the padding, and reuse the final
    tie-rule selection wire — exact by construction (every matching
    document is scored in f32), so no margin proof and no widen loop."""
    if dim is not None and dim != queries.shape[1]:
        queries = queries[:, :dim]  # padded upload; mirror rows true-dim
    gr = rows if dev_map is None else dev_map[rows]
    cand = dev_f32[gr]  # [F, d] gather in HBM
    # HIGHEST: these ARE the returned scores (see _rescore_from_packed).
    exact = jax.lax.dot_general(
        queries,
        cand,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # [B, F]
    live = jnp.arange(rows.shape[0], dtype=jnp.int32)[None, :] < n_live
    exact = jnp.where(live, exact, -jnp.inf)
    from ..ops.topk import final_select_wire

    emb_b = jnp.broadcast_to(emb_of[None, :], exact.shape)
    tail = jnp.zeros((exact.shape[0], 1), dtype=jnp.int32)
    return final_select_wire(exact, emb_b, tail, k)


def _subset_select_np(
    exact: np.ndarray, emb: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Host top-``k`` of exact subset scores with the reference tie rule
    (descending score, equal scores break to the larger emb id) —
    boundary-tie safe: the argpartition prefilter keeps EVERY row tied
    with the k-th score, then the lexsort decides among them."""
    n_q, f = exact.shape
    k = min(int(k), f)
    out_emb = np.empty((n_q, k), dtype=np.int64)
    out_scores = np.empty((n_q, k), dtype=np.float32)
    for b in range(n_q):
        row = exact[b]
        if k < f:
            part = np.argpartition(row, f - k)[f - k :]
            boundary = row[part].min()
            cand = np.nonzero(row >= boundary)[0]
        else:
            cand = np.arange(f)
        order = np.lexsort((-emb[cand], -row[cand]))[:k]
        sel = cand[order]
        out_emb[b] = emb[sel]
        out_scores[b] = row[sel]
    return out_emb, out_scores


#: Host-route ceiling for the pre-filter subset dot (B * F * d mults):
#: past it the 1-vCPU-class host would be slower than the post-filter
#: device ladder, so ``subset_topk`` declines and the caller widens.
_SUBSET_HOST_MAX_FLOPS = 2_000_000_000

#: Entries kept in the engine's device-side subset cache (rows + emb ids
#: per distinct filter); bounds HBM held for dead corpora/filters.
_SUBSET_DEV_CACHE_MAX = 16


@jax.jit
def _pairwise_rescore_from_rows(
    dev_f32: jax.Array,
    dev_map: Optional[jax.Array],
    rows_a: jax.Array,
    rows_b: jax.Array,
) -> jax.Array:
    """Exact f32 scores for candidate PAIRS from the HBM rescore mirror:
    gather both rows of each pair on-device and dot them — one batched
    vector-vector ``dot_general`` — so the host fetches C floats instead
    of gathering 2·C·d candidate bytes itself (measured: the 614 MB host
    gather at C=50k intermittently costs seconds of kernel time on small
    VMs; the device fetch is ~200 KB).  ``dev_map is None`` vs not are
    separate traces (static pytree structure).

    For f32 corpora ``dev_f32`` is the padded pack itself — zero padding
    columns contribute nothing to a row·row dot, so no width slicing is
    needed.  HIGHEST: this result is treated as the exact-f32 rescore the
    pairwise margin proof stands on (see ``_rescore_from_packed``)."""
    ga = rows_a if dev_map is None else dev_map[rows_a]
    gb = rows_b if dev_map is None else dev_map[rows_b]
    va = dev_f32[ga]  # [C, d] gather in HBM
    vb = dev_f32[gb]
    return jax.lax.dot_general(
        va,
        vb,
        dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


@functools.partial(jax.jit, static_argnames=("wide",))
def _pack_results(vals: jax.Array, idx: jax.Array, wide: bool = False) -> jax.Array:
    """One-dispatch packing for paths that return (vals, idx) pairs; see
    ``ops.topk.pack_vals_idx`` for the two wire layouts."""
    from ..ops.topk import pack_vals_idx

    return pack_vals_idx(vals, idx, wide=wide)


class RetrievalEngine:
    """Packs the corpus onto device(s) and runs exact cosine top-k."""

    def __init__(
        self,
        precision: str = "auto",
        rescore: Optional[bool] = None,
        mesh: Optional[jax.sharding.Mesh] = None,
        data_axis: str = "data",
        model_axis: Optional[str] = None,
        device: Optional[jax.Device] = None,
        kernel: str = "auto",
        device_rescore: str = "auto",
    ) -> None:
        from ..utils.compile_cache import enable_compilation_cache

        enable_compilation_cache()
        if precision not in ("auto", "f32", "bf16", "int8"):
            raise ValueError(f"unknown precision: {precision!r}")
        if device_rescore not in ("auto", "host"):
            raise ValueError(
                "device_rescore must be 'auto' (on-device f32 rescore when "
                "the mirror fits HBM) or 'host' (reference-bit-identical "
                "np.dot rescore)"
            )
        if kernel not in ("auto", "xla"):
            raise ValueError(f"unknown kernel: {kernel!r}")
        #: 'auto' runs the fused GPU kernel (``ops.fused_topk``) on a GPU
        #: for the batches and shapes it supports and the XLA matmul +
        #: top-k otherwise; 'xla' always takes the XLA path.
        self.kernel = kernel
        #: 'auto' = rescore on-device when the f32 mirror fits the HBM
        #: budget (exact f32 values; accumulation order is the device's,
        #: so last-ulp deltas vs CPU BLAS are possible); 'host' = always
        #: gather+np.dot on the host (bit-identical to the reference).
        self.device_rescore = device_rescore
        #: Learned candidate-width hints per final-k, as (width, streak)
        #: — see :meth:`initial_candidates`.
        self._cand_hint: Dict[int, Tuple[int, int]] = {}
        self._pair_hint: Dict[int, Tuple[int, int]] = {}
        #: Precision as requested; ``self.precision`` is always concrete.
        self.requested_precision = precision
        self.precision = precision
        #: Exact f32 re-ranking of the device candidate set.  Defaults on
        #: for EVERY precision: beyond undoing storage quantization, the
        #: rescore stage is what applies the reference tie rule (equal
        #: scores break to the larger emb id) and what proves the
        #: candidate SET covered boundary ties — raw device selection
        #: breaks ties to the SMALLER row and fetches exactly k, so an
        #: f32 corpus with >k tied documents would return the wrong tied
        #: subset in the wrong order.  ``rescore=False`` is an explicit
        #: opt-out: device prescore order, tie order unspecified.
        self.rescore = rescore if rescore is not None else True
        self.mesh = mesh
        if mesh is not None:
            assert data_axis in mesh.axis_names, (
                f"mesh has axes {mesh.axis_names}, expected a {data_axis!r} axis"
            )
            # Convention: a mesh axis named 'model' shards the embedding dim.
            if model_axis is None and "model" in mesh.axis_names:
                model_axis = "model"
        self.data_axis = data_axis
        self.model_axis = model_axis
        if self.precision == "auto":
            # 'auto' = the fastest storage whose RESULTS are still exact.
            # With the verified rescore on, returned scores are exact f32
            # dots of the original vectors for every storage precision
            # (the prescore only proposes candidates; the margin proof +
            # widen-retry guarantees coverage) — so pick int8: its device
            # read is half of bf16's (PERF.md has the measured steps).
            # Fall back to bf16 where the int8 path doesn't apply: rescore
            # disabled (raw prescore order would be quantized), 'host'
            # device_rescore (candidate widths amplify the host gather),
            # and dim-sharded 2-D meshes (per-row int8 scales can't shard
            # over the model axis).
            self.precision = (
                "int8"
                if (
                    self.rescore
                    and device_rescore == "auto"
                    and self.model_axis is None
                )
                else "bf16"
            )
        self.device = device
        #: Automatic host-path dispatch: 'auto' answers solo/small-batch
        #: queries straight from the host f32 cache when the measured
        #: device round-trip floor exceeds the estimated host exact-scan
        #: cost — where every device call pays a ~30 ms round trip (a
        #: remote device), a 10k-doc corpus is faster to scan on the host (the
        #: reference wins exactly these otherwise,
        #: ``/root/reference/README.md:128``).  Results are identical by
        #: construction: the host scan IS the engine's definition of
        #: exact (np.dot matvec + reference tie rule).  'off' / 'force'
        #: override; env ``SVS_TPU_HOST_DISPATCH``.
        self.host_dispatch = os.environ.get("SVS_TPU_HOST_DISPATCH", "auto")
        if self.host_dispatch not in ("auto", "off", "force"):
            log.warning("ignoring SVS_TPU_HOST_DISPATCH=%r "
                        "(want auto/off/force)", self.host_dispatch)
            self.host_dispatch = "auto"
        from ..utils.env import env_float

        #: Learned host-scan bandwidth (bytes/s); EWMA-updated by every
        #: host scan, and refreshed by a cheap background slab probe when
        #: it goes stale while the device path is winning (without that,
        #: the estimate and the RPC floor starve each other — each only
        #: updates when its own path runs).
        self._host_scan_bw = env_float(
            "SVS_TPU_HOST_SCAN_BW", _HOST_SCAN_BW_PRIOR
        )
        self._host_bw_t = 0.0
        self._host_bw_thread: Optional[threading.Thread] = None
        #: Background builder for large host int8 prescore arrays
        #: (:meth:`_ensure_host_i8`).
        self._host_i8_thread: Optional[threading.Thread] = None
        #: Separate EWMA for the two-pass host search's EFFECTIVE
        #: bandwidth — one scalar cannot model both cost functions (the
        #: two-pass runs ~4x the full scan's effective rate, but only at
        #: b <= HOST_TWOPASS_MAX_BATCH shapes).
        self._host_twopass_bw: Optional[float] = None
        #: Measured device round-trip floor + re-probe schedule: a remote
        #: link's floor moves by 10x across hours, so one
        #: cached measurement under/over-routes for the process lifetime.
        #: Quiet-moment re-probes on a decaying schedule blend in.
        self._rpc_floor: Optional[float] = None
        self._rpc_floor_t = 0.0
        self._rpc_probes = 0
        self._rpc_probe_thread: Optional[threading.Thread] = None
        self._corpus: Optional[PackedCorpus] = None
        self._fingerprint: Optional[Tuple[int, int, int, int]] = None
        self._quick_token: Optional[Tuple[int, int]] = None
        #: Host bytes matching the device pack (for sidecar writes without
        #: a device->host pull); kept in sync across incremental appends.
        self._host_pack: Optional[HostPack] = None
        #: Sidecar file the current pack was loaded from (bytes on disk are
        #: known-identical, so re-writing it would be pure waste).
        self._sidecar_source: Optional[Path] = None
        self._cache_rebuild_thread: Optional[threading.Thread] = None
        #: Fingerprint at the last rebuild attempt — one attempt per store
        #: state, so a failing rebuild can't respawn a scan per query.
        self._cache_rebuild_fp: Optional[Tuple[int, int, int, int]] = None
        #: Background uploader for large f32 rescore mirrors (joinable —
        #: tests and clean shutdown); spawn bookkeeping under _mirror_lock.
        self._mirror_thread: Optional[threading.Thread] = None
        #: Deferred PACK uploader (see ``_spawn_pack_upload``): runs
        #: before any mirror upload for the same corpus; spawn
        #: bookkeeping under ``_mirror_lock`` like the mirror thread.
        self._pack_thread: Optional[threading.Thread] = None
        self._mirror_lock = threading.Lock()
        #: Monotonic time of the last query arrival plus an in-flight
        #: count — the background mirror uploader yields the device link
        #: while queries flow (including mid-compile, which can take
        #: ~30 s with no new arrivals).
        self._last_query_t = 0.0
        self._inflight = 0
        #: Threads currently BLOCKED in ``_await_pack_device`` waiting
        #: for the deferred pack upload.  The uploader's throttle treats
        #: a positive count as "stop yielding": the waiter is (often) an
        #: in-flight query, so deferring to it would be a priority
        #: inversion — the query sleeps on the very upload the throttle
        #: is politely holding back (round-4 advisor, medium).
        self._pack_waiters = 0
        self._inflight_lock = threading.Lock()
        #: Set by shutdown(): aborts any in-progress background mirror
        #: upload (a daemon thread mid-device-call at interpreter exit
        #: aborts the process).
        self._mirror_stop = threading.Event()
        #: Hedged-fetch bookkeeping: EWMA of healthy fetch seconds per
        #: (path, shape) label, and counters surfaced via
        #: :meth:`dispatch_stats`.  See :meth:`_fetch_hedged`.
        self._fetch_ewma: Dict[str, float] = {}
        self._hedge_fired = 0
        self._hedge_won = 0
        #: How each :meth:`ensure_fresh` call was satisfied (``reuse`` =
        #: token/fingerprint hit, ``append``/``delete`` = incremental,
        #: ``sidecar`` = mmap load, ``scan`` = full BLOB rescan) — surfaced
        #: through ``kb.stats()['pack_events']`` so operators can see
        #: whether writes are riding the fast paths.
        self.pack_events: Dict[str, int] = {
            "reuse": 0, "append": 0, "delete": 0, "sidecar": 0, "scan": 0,
        }
        #: Device-side (rows, emb ids) uploads per distinct pre-filter —
        #: repeated filtered queries then cost only the query upload and
        #: the [B, 2k+1] fetch.  Keyed by the filter's canonical string;
        #: an entry is valid only for (the same corpus object, the same
        #: match-set digest) — meta-only updates can change WHICH ids a
        #: filter matches without re-packing, so identity+count is not
        #: enough.  Stores to the cache sweep out entries pinning a
        #: superseded corpus (each pins multi-GB device arrays via
        #: ``entry[0]``).  Guarded by ``self._lock``.
        self._subset_dev: Dict[
            str,
            Tuple[PackedCorpus, jax.Array, Optional[jax.Array], bytes],
        ] = {}
        self._lock = threading.Lock()

    def shutdown(self) -> None:
        """Release engine-owned background resources: abort + join any
        in-progress background mirror upload (a daemon thread caught
        mid-device-call at interpreter exit aborts the whole process).
        The replica engine extends this to stop its fan-out pool.
        Called by ``KB.close()``/``AsyncKB.close()``."""
        self._mirror_stop.set()
        # _rpc_probe_thread does device calls too: a daemon thread
        # caught mid-RPC at interpreter exit aborts the process, same
        # hazard as the uploaders.  The host-side builders join fast.
        for attr in (
            "_pack_thread", "_mirror_thread", "_rpc_probe_thread",
            "_host_bw_thread", "_host_i8_thread",
        ):
            t = getattr(self, attr)
            if t is not None and t.is_alive():
                t.join(timeout=30.0)
            setattr(self, attr, None)
        # The engine can be queried again after close() (the replica pool
        # pattern does this) — a fresh event re-arms future uploads; a
        # straggler thread keeps the old, permanently-set one, which it
        # captured at spawn time (it never re-reads this attribute).
        self._mirror_stop = threading.Event()

    # -- freshness ----------------------------------------------------------

    def invalidate(self) -> None:
        with self._lock:
            self._corpus = None
            self._fingerprint = None
            self._quick_token = None
            self._host_pack = None
            self._sidecar_source = None

    @property
    def corpus(self) -> Optional[PackedCorpus]:
        return self._corpus

    def _placement(self) -> "Union[jax.Device, jax.sharding.Sharding, None]":
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            return NamedSharding(
                self.mesh, PartitionSpec(self.data_axis, self.model_axis)
            )
        return self.device

    def _row_multiple(self, n_rows: int = 0) -> int:
        """Row padding granularity.  Large corpora align to a coarse
        multiple (whole fused-kernel tiles on every mesh shard, fewer
        regrows on append); small ones keep the small multiple so toy
        stores stay toy-sized."""
        base = LARGE_ROW_MULTIPLE if n_rows >= LARGE_ROW_MULTIPLE else ROW_MULTIPLE
        if self.mesh is not None:
            return base * int(self.mesh.shape[self.data_axis])
        return base

    def _dim_multiple(self) -> int:
        if self.mesh is not None and self.model_axis is not None:
            return DIM_MULTIPLE * int(self.mesh.shape[self.model_axis])
        return DIM_MULTIPLE

    @staticmethod
    def _store_fingerprint(db: Database) -> Tuple[int, int, int, int]:
        with db.transaction() as tx:
            version = tx.matrix_version()
            count, max_id, generation = tx.embeddings_fingerprint()
        return (version, count, max_id, generation)

    @_marks_inflight
    def ensure_fresh(
        self,
        db: Database,
        sidecar_path: Union[str, Path, None] = None,
    ) -> PackedCorpus:
        """Return a corpus reflecting the store's current embeddings,
        re-packing (from sidecar when possible, else from BLOBs) if stale.

        Staleness checking is two-tier: per query, an O(1) token
        (``matrix_version`` for our own writes + SQLite's ``data_version``
        for foreign writers).  Only when the token moves does the O(n)
        count/max fingerprint (needed for append detection and sidecar
        keying) get recomputed — COUNT(*) at 1M rows costs ~1 s, far too
        much to pay per retrieval.

        Caller is responsible for serializing store access (the KB facade
        holds its per-instance lock around this).
        """
        with db.transaction() as tx:
            quick = (tx.matrix_version(), tx.data_version())
        with self._lock:
            if self._corpus is not None and self._quick_token == quick:
                self.pack_events["reuse"] += 1
                self._maybe_respawn_cache_rebuild(db)
                # mirror may be missing if the host cache attached late
                # (background rebuild) — cheap no-op check otherwise
                self._maybe_build_device_rescore(self._corpus)
                return self._corpus
        fingerprint = self._store_fingerprint(db)
        with self._lock:
            if self._corpus is not None and self._fingerprint == fingerprint:
                # A foreign write happened, but not to the embeddings
                # (e.g. doc meta or KV) — keep the pack, refresh the token.
                self._quick_token = quick
                self.pack_events["reuse"] += 1
                self._maybe_respawn_cache_rebuild(db)
                return self._corpus

            # Each pack path manages self._host_pack (bytes matching the
            # device copy, for sidecar writes) and self._sidecar_source.
            corpus = self._try_incremental_append(db, fingerprint)
            if corpus is not None:
                self.pack_events["append"] += 1
            if corpus is None:
                corpus = self._try_incremental_delete(db, fingerprint)
                if corpus is not None:
                    self.pack_events["delete"] += 1
            if corpus is None and sidecar_path is not None:
                corpus = self._try_sidecar(sidecar_path, fingerprint)
                if corpus is not None:
                    self.pack_events["sidecar"] += 1
                    if not corpus.device_ready:
                        self._spawn_pack_upload(corpus)
                    self._spawn_rescore_cache_rebuild(
                        db.path, corpus, fingerprint
                    )
            if corpus is None:
                self.pack_events["scan"] += 1
                log.info("packing corpus from store (fingerprint %s)", fingerprint)
                self._sidecar_source = None
                with db.transaction() as tx:
                    matrix, emb_ids = tx.build_embeddings_matrix()
                corpus, self._host_pack = pack_corpus(
                    matrix,
                    emb_ids,
                    version=fingerprint[0],
                    precision=self.precision,
                    placement=self._placement(),
                    row_multiple=self._row_multiple(matrix.shape[0]),
                    dim_multiple=self._dim_multiple(),
                    keep_host=True,
                    # Large single-chip packs upload in the background:
                    # queries answer exactly from the host f32 cache
                    # meanwhile, so the cold first query is bounded by
                    # the host scan — not the multi-GB device transfer
                    # (minutes over a slow link).
                    defer_upload=self.mesh is None,
                )
                if not corpus.device_ready:
                    self._spawn_pack_upload(corpus)
            self._corpus = corpus
            self._fingerprint = fingerprint
            self._quick_token = quick
            if corpus.device_ready:
                corpus.n_valid_device()  # warm the device scalar w/ the pack
                self._maybe_build_device_rescore(corpus)
            return corpus

    def _try_incremental_append(
        self, db: Database, fingerprint: Tuple[int, int, int, int]
    ) -> Optional[PackedCorpus]:
        """Append-only fast path: when the only change since the last pack
        is newly added embeddings (public bulk ops can only append new
        embedding rows or delete; count/max-id deltas distinguish the two),
        fetch just the new rows and write them into the padding region of
        the device matrix instead of rescanning every BLOB.

        Skipped under a mesh (appending to a sharded array would reshard
        everything anyway).
        """
        old = self._corpus
        if old is None or self._fingerprint is None or self.mesh is not None:
            return None
        if old.n_valid == 0:
            # an empty pack has no established dim (dim=0, padded buffers
            # sized for nothing) — appends onto it must be full packs
            return None
        _, old_count, old_max, old_gen = self._fingerprint
        _, new_count, new_max, new_gen = fingerprint
        added = new_count - old_count
        if added <= 0 or added != new_max - old_max or old.n_valid != old_count:
            return None
        # Generation counts every embeddings-table write: pure appends move
        # it by exactly `added`.  Anything else (a delete+insert pair, an
        # UPDATE) moves it further -> full repack.
        if new_gen - old_gen != added:
            return None
        with db.transaction() as tx:
            new_rows, new_ids = tx.fetch_embeddings_after(old_max)
        if new_rows.shape[0] != added or (
            old.n_valid and new_rows.shape[1] != old.dim
        ):
            return None
        log.info("incremental append: +%d docs (no full repack)", added)
        self._await_pack_device(old)  # deferred cold-start upload lands first

        padded_new = np.zeros((added, old.dim_padded), dtype=np.float32)
        padded_new[:, : new_rows.shape[1]] = new_rows
        n0, n1 = old.n_valid, old.n_valid + added
        host = self._host_pack
        host_scales = None

        if old.precision == "int8":
            from ..native import quantize_int8

            q_new, s_new = quantize_int8(padded_new)
            data_new, scales_new = _grow_rows(
                old.data, jnp.asarray(q_new), n0, self._row_multiple(n1)
            ), _grow_rows(
                old.row_scales, jnp.asarray(s_new), n0, self._row_multiple(n1)
            )
            if host is not None:
                host_data = _grow_rows_np(host.data, q_new, n0, self._row_multiple(n1))
                host_scales = _grow_rows_np(
                    host.row_scales, s_new, n0, self._row_multiple(n1)
                )
        else:
            if old.precision == "bf16":
                from ..native import f32_to_bf16

                padded_new = f32_to_bf16(padded_new)
            data_new = _grow_rows(
                old.data,
                jnp.asarray(padded_new, dtype=old.data.dtype),
                n0,
                self._row_multiple(n1),
            )
            scales_new = None
            if host is not None:
                host_data = _grow_rows_np(
                    host.data, padded_new, n0, self._row_multiple(n1)
                )

        # The device copy moved past any sidecar/host bytes we had; keep the
        # host mirror in step so a later write_sidecar never pulls from the
        # device (a multi-GB transfer).
        self._sidecar_source = None
        self._host_pack = (
            HostPack(data=host_data, row_scales=host_scales)
            if host is not None
            else None
        )
        scale_max = old.scale_max
        if old.precision == "int8":
            scale_max = max(scale_max, float(np.max(s_new)))
        from .packing import rescore_cache_limit

        host_cache = None
        old_cache = old.host_cache  # one read: (f32, row_map) or None
        grown_bytes = (
            (old_cache[0].shape[0] + added) * old_cache[0].shape[1] * 4
            if old_cache is not None
            else 0
        )
        if old_cache is not None and grown_bytes <= rescore_cache_limit():
            # keep the rescore gather source in step with the pack:
            # appended pack rows land at the cache's end in both layouts
            old_f32, old_map = old_cache
            host_f32 = np.concatenate(
                [old_f32, new_rows.astype(np.float32, copy=False)]
            )
            host_row_map = None
            if old_map is not None:
                host_row_map = np.concatenate(
                    [
                        old_map,
                        np.arange(
                            len(old_f32), len(old_f32) + added, dtype=np.int64
                        ),
                    ]
                )
            host_cache = (host_f32, host_row_map)
        return PackedCorpus(
            data=data_new,
            row_scales=scales_new,
            emb_ids=np.concatenate([old.emb_ids, new_ids]),
            n_valid=n1,
            dim=old.dim,
            version=fingerprint[0],
            precision=old.precision,
            scale_max=scale_max,
            host_cache=host_cache,
        )

    def _try_incremental_delete(
        self, db: Database, fingerprint: Tuple[int, int, int, int]
    ) -> Optional[PackedCorpus]:
        """Delete-only fast path: when the only change since the last pack
        is removed embedding rows (count down by ``d``, generation up by
        exactly ``d`` — the same algebra that gates the append path — and
        the surviving ids a subset of the packed ids), compact the device
        matrix in place: live rows from the tail move into the deleted
        slots and ``n_valid`` shrinks.  The kernels mask strictly by the
        runtime ``n_valid`` scalar, so the stale rows left between the new
        boundary and the buffer capacity are never scored.  Cost is an
        id-only PK scan plus an O(deleted) on-device row move — vs the
        full BLOB rescan a repack pays (~46 s at 1M docs).

        The f32 rescore cache follows by re-pointing its row MAP (cache
        rows never move — they may be a read-only sidecar mmap, and for
        f32 packs they alias the pack bytes), so verified rescore stays
        exact.  Device mirrors (``dev_rescore``/``dev_emb``) drop with the
        fresh corpus object and are rebuilt by
        :meth:`_maybe_build_device_rescore` on the next query — the same
        policy appends use.  The host pack is dropped too (publish after a
        delete re-packs host-side rather than risk aliasing the cache).

        Skipped under a mesh (compaction of a sharded array would reshard
        anyway), when everything was deleted (empty packs re-establish
        dim via a full pack), or when at least half the pack died (a
        repack then reclaims the buffer).
        """
        old = self._corpus
        if old is None or self._fingerprint is None or self.mesh is not None:
            return None
        if old.n_valid == 0:
            return None
        _, old_count, old_max, old_gen = self._fingerprint
        _, new_count, new_max, new_gen = fingerprint
        removed = old_count - new_count
        if removed <= 0 or new_count <= 0 or old.n_valid != old_count:
            return None
        # Generation counts every embeddings-table write: pure deletes move
        # it by exactly `removed`.  Any insert/update mix moves it further
        # (deletes - inserts == removed and deletes + inserts + updates ==
        # removed has only the inserts == updates == 0 solution).
        if new_gen - old_gen != removed or new_max > old_max:
            return None
        if removed * 2 >= old_count:
            return None  # bulk wipe: repack to reclaim the buffer
        with db.transaction() as tx:
            cur_ids = tx.embedding_ids()
        if cur_ids.shape[0] != new_count:
            return None  # raced a foreign writer; fingerprint is stale
        keep = np.isin(old.emb_ids, cur_ids, assume_unique=True)
        if int(keep.sum()) != new_count:
            return None  # survivors not a subset of the pack (foreign churn)
        old_n, new_n = old.n_valid, new_count
        dead = np.flatnonzero(~keep)
        dead_below = dead[dead < new_n]
        live_tail = new_n + np.flatnonzero(keep[new_n:])
        log.info(
            "incremental delete: -%d docs (no full repack; %d rows moved)",
            removed,
            int(dead_below.size),
        )

        emb_ids = old.emb_ids.copy()
        emb_ids[dead_below] = emb_ids[live_tail]
        emb_ids = emb_ids[:new_n]

        self._await_pack_device(old)  # deferred cold-start upload lands first
        if dead_below.size:
            src = jnp.asarray(live_tail, dtype=jnp.int32)
            dst = jnp.asarray(dead_below, dtype=jnp.int32)
            data_new = _move_rows(old.data, src, dst)
            scales_new = (
                _move_rows(old.row_scales, src, dst)
                if old.row_scales is not None
                else None
            )
        else:
            # pure tail deletion: nothing moves, only the mask boundary
            data_new, scales_new = old.data, old.row_scales

        host_cache = None
        old_cache = old.host_cache  # one read: (f32, row_map) or None
        if old_cache is not None:
            cache_f32, old_map = old_cache
            # Re-point the map instead of moving cache rows.  Always make
            # the map explicit afterwards: a later incremental append
            # concatenates new cache rows at the END of the f32 array and
            # relies on map-is-None meaning "cache row i == pack row i",
            # which compaction breaks for i past the first moved slot.
            base = (
                old_map
                if old_map is not None
                else np.arange(old_n, dtype=np.int64)
            )
            new_map = base[:old_n].copy()
            new_map[dead_below] = base[live_tail]
            host_cache = (cache_f32, new_map[:new_n])

        self._host_pack = None
        self._sidecar_source = None
        return PackedCorpus(
            data=data_new,
            row_scales=scales_new,
            emb_ids=emb_ids,
            n_valid=new_n,
            dim=old.dim,
            version=fingerprint[0],
            precision=old.precision,
            scale_max=old.scale_max,  # still an upper bound for survivors
            host_cache=host_cache,
        )

    def _maybe_respawn_cache_rebuild(self, db: Database) -> None:
        """A live pack can lack its f32 rescore cache beyond the sidecar
        cold start (rebuild rejected after a store move, incremental
        appends onto a cache-less pack).  Re-attempt ONCE per store state
        whenever queries keep flowing against such a pack — otherwise
        batched rescores stay on the slow store-fetch path for the life
        of the process.  Caller holds the engine lock."""
        corpus, fp = self._corpus, self._fingerprint
        if (
            corpus is None
            or fp is None
            or corpus.host_f32 is not None
            or not self.rescore
            or fp == self._cache_rebuild_fp
        ):
            return
        t = self._cache_rebuild_thread
        if t is not None and t.is_alive():
            return
        self._spawn_rescore_cache_rebuild(db.path, corpus, fp)

    def _spawn_rescore_cache_rebuild(
        self,
        db_path: "Union[str, Path]",
        corpus: PackedCorpus,
        fingerprint: Tuple[int, int, int, int],
    ) -> None:
        """Sidecar-loaded packs carry no f32 rescore cache (no scan
        happened), so batched rescores fall back to SQLite IN-fetches
        (~5 s per 256-query batch at 1M).  Rebuild the cache from a
        BACKGROUND scan and attach it to the live corpus — queries keep
        flowing on the fallback meanwhile.  The scan runs in one
        transaction and only attaches when the store fingerprint still
        matches the pack (otherwise the pack is about to be rebuilt
        anyway)."""
        from .packing import rescore_cache_limit

        if (
            not self.rescore
            or corpus.host_f32 is not None
            or corpus.n_valid == 0
            or corpus.n_valid * corpus.dim * 4 > rescore_cache_limit()
        ):
            return

        def work() -> None:
            try:
                db2 = Database(db_path)
                try:
                    with db2.transaction() as tx:
                        version = tx.matrix_version()
                        count, max_id, generation = tx.embeddings_fingerprint()
                        if (version, count, max_id, generation) != fingerprint:
                            return
                        matrix, ids = tx.build_embeddings_matrix()
                finally:
                    db2.close()
                row_map = np.searchsorted(ids, corpus.emb_ids).astype(np.int64)
                if not np.array_equal(ids[row_map], corpus.emb_ids):
                    return  # ids diverged from the pack — never attach
                with self._lock:
                    if self._corpus is corpus:
                        # ONE store publishes the whole pair — readers can
                        # never see a torn (f32, row_map) combination
                        object.__setattr__(
                            corpus, "host_cache", (matrix, row_map)
                        )
                        log.info(
                            "rescore cache rebuilt in background (%d rows)",
                            matrix.shape[0],
                        )
            except Exception:
                log.debug(
                    "background rescore-cache rebuild failed", exc_info=True
                )

        self._cache_rebuild_fp = fingerprint
        t = threading.Thread(
            target=work, name="svs-tpu-rescore-cache", daemon=True
        )
        t.start()
        self._cache_rebuild_thread = t  # joinable (tests, clean shutdown)

    def _try_sidecar(
        self, path: Union[str, Path], fingerprint: Tuple[int, int, int, int]
    ) -> Optional[PackedCorpus]:
        loaded = load_sidecar(path, expected_version=fingerprint)
        if loaded is None:
            return None
        data, row_scales, emb_ids, header = loaded
        if header["precision"] != self.precision:
            log.info("sidecar precision %s != engine %s; rebuilding",
                     header["precision"], self.precision)
            return None
        if header["n_padded"] % self._row_multiple(header["n_valid"]) != 0:
            log.info("sidecar row padding incompatible with mesh; rebuilding")
            return None
        if header["dim_padded"] % self._dim_multiple() != 0:
            log.info("sidecar dim padding incompatible with mesh; rebuilding")
            return None
        placement = self._placement()
        log.info("loading corpus from sidecar %s", path)
        from .packing import DEFER_MIN_BYTES, _put, _scales_placement

        # The mmap'd file bytes double as the host pack: a later sidecar
        # write (to another path) can stream them without touching the
        # device, and a write to *this* path is skipped entirely.
        self._host_pack = HostPack(data=data, row_scales=row_scales)
        self._sidecar_source = Path(path)
        n_valid = int(header["n_valid"])
        # Publish-time sidecars carry the f32 rescore cache (mmap'd):
        # zero-scan cold start — no background rebuild thread either.
        host_cache = None
        if "_f32_cache" in header:
            from .packing import rescore_cache_limit

            cache = header["_f32_cache"]
            if cache.nbytes <= rescore_cache_limit():
                host_cache = (cache, header.get("_f32_row_map"))
        elif self.precision == "f32":
            # f32 sidecars omit the cache on purpose: the mmap'd pack
            # already IS the exact bytes.  A true-dim view of it (rows
            # in pack order, zero padding columns sliced away) makes the
            # host gather source free — no background rescan thread, no
            # RAM duplicate (reads page in from the sidecar file), and
            # the zero-scan cold-start promise holds for f32 too.
            host_cache = (
                np.asarray(data)[:n_valid, : header["dim"]],
                None,
            )
        # Small host caches materialize into RAM: BLAS over the sidecar
        # mmap measures 4-5x slower than over RAM even when page-warm
        # (24 vs 5.5 ms per 61 MB matvec on the bench host), and small
        # corpora are exactly where the host dispatch serves whole
        # queries from this cache.  Large caches stay mmap'd (rescore
        # GATHERS touch only candidate rows; duplicating 6 GB of RAM to
        # speed a path the device wins anyway would be a bad trade).
        if host_cache is not None:
            from ..utils.env import env_int
            from .packing import _is_mmap_backed

            cache_arr, rmap = host_cache
            ram_max = env_int(
                "SVS_TPU_HOST_CACHE_RAM_MAX", _HOST_SCAN_MAX_SCORE_BYTES
            )
            if _is_mmap_backed(cache_arr) and cache_arr.nbytes <= ram_max:
                host_cache = (np.array(cache_arr, copy=True), rmap)
        # Same deferral as the scan path (ensure_fresh): when the
        # sidecar carries an exact host cache, queries can answer from
        # it immediately — the multi-GB device upload moves to the
        # background instead of sitting on the cold first query.
        defer = (
            self.mesh is None
            and np.asarray(data).nbytes >= DEFER_MIN_BYTES
            and host_cache is not None
        )
        ready: Optional[threading.Event] = None
        if defer:
            device_data: "jax.Array" = np.asarray(data)  # type: ignore[assignment]
            scales_arr = (
                np.asarray(row_scales) if row_scales is not None else None
            )
            ready = threading.Event()
        else:
            device_data = _put(np.asarray(data), placement)
            scales_arr = None
            if row_scales is not None:
                scales_arr = _put(
                    np.asarray(row_scales), _scales_placement(placement)
                )
        return PackedCorpus(
            data=device_data,
            row_scales=scales_arr,
            emb_ids=np.asarray(emb_ids, dtype=np.int64),
            n_valid=n_valid,
            dim=header["dim"],
            version=header["matrix_version"],
            precision=self.precision,
            scale_max=float(np.max(row_scales[:n_valid])) if (
                row_scales is not None and n_valid > 0
            ) else 0.0,
            host_cache=host_cache,
            _device_ready=ready,
        )

    def write_sidecar(self, path: Union[str, Path]) -> None:
        assert self._corpus is not None, "nothing packed yet"
        if self._sidecar_source is not None and Path(path) == self._sidecar_source:
            # Corpus was loaded from this very file and is still fresh —
            # rewriting byte-identical content would cost a full pass (and,
            # with no host pack, a device->host pull) for nothing.
            log.debug("sidecar %s already current; skipping write", path)
            return
        host = self._host_pack
        if host is not None and host.data.shape != self._corpus.data.shape:
            host = None  # shouldn't happen: appends keep the mirror in step
        save_sidecar(
            path, self._corpus, fingerprint=self._fingerprint, host_pack=host
        )

    def write_sidecar_from_store(
        self,
        db: Database,
        path: Union[str, Path],
        *,
        min_docs: int = 0,
        scan_ok: bool = True,
    ) -> bool:
        """Write/refresh the sidecar at ``path`` to match the store's
        CURRENT embeddings — the publish flow (``close()``): a builder who
        bulk-adds and closes pays the pack once here so no consumer ever
        pays the cold-start BLOB rescan (reference publish flow:
        ``svs/kb.py:969-995``, which ships nothing and leaves every
        consumer a ~100 s rebuild at 1M docs).

        Device-free: reuses the live host pack when it is current,
        otherwise scans + packs on the host only (``packing.pack_host``).
        Skips corpora below ``min_docs`` and files already current.
        ``scan_ok=False`` (pure-consumer close under the ``'auto'``
        policy) limits the work to reusing a current in-hand pack — a
        reader who never wrote must not pay a full store scan in
        ``close()``.  Returns True iff a current sidecar exists at
        ``path`` on return.
        """
        from .packing import pack_host
        from .sidecar import save_sidecar_arrays, sidecar_fingerprint

        fingerprint = self._store_fingerprint(db)
        if fingerprint[1] < max(1, min_docs):
            return False
        if sidecar_fingerprint(path) == list(fingerprint):
            return True  # already current — skip the rewrite
        with self._lock:
            corpus, host = self._corpus, self._host_pack
            if (
                corpus is not None
                and host is not None
                and self._fingerprint == fingerprint
            ):
                save_sidecar(
                    path, corpus, fingerprint=fingerprint, host_pack=host
                )
                return True
        # No usable pack in hand (fresh writes invalidated it, or the pack
        # came from a sidecar of another path): host-only scan + pack.
        if not scan_ok:
            log.debug(
                "publish: no current pack and scan_ok=False — skipping "
                "sidecar %s", path,
            )
            return False
        log.info("publish: packing corpus for sidecar %s", path)
        with db.transaction() as tx:
            matrix, emb_ids = tx.build_embeddings_matrix()
        host_data, host_scales, emb_ids, cache_f32, row_map, n, d = pack_host(
            matrix,
            emb_ids,
            self.precision,
            row_multiple=self._row_multiple(matrix.shape[0]),
            dim_multiple=self._dim_multiple(),
        )
        save_sidecar_arrays(
            path,
            n_valid=n,
            dim=d,
            precision=self.precision,
            matrix_version=fingerprint[0],
            fingerprint=fingerprint,
            emb_ids=emb_ids,
            row_scales=host_scales,
            data=host_data,
            f32_cache=cache_f32,
            f32_row_map=row_map,
        )
        return True

    # -- device rescore mirror ------------------------------------------------

    def _await_pack_device(self, corpus: PackedCorpus) -> None:
        """Block until a deferred pack's device arrays are live, counted
        as a PACK WAITER so the uploader's throttle stops yielding — a
        device-path query sleeping here is still in the ``_inflight``
        count, and without the waiter signal the throttle would defer
        every chunk its full budget while the query waits on the upload
        (priority inversion: ~5 s of pure sleep per 64 MB chunk)."""
        if corpus.device_ready:
            return
        with self._inflight_lock:
            self._pack_waiters += 1
        try:
            corpus.wait_device()
        finally:
            with self._inflight_lock:
                self._pack_waiters -= 1

    def _spawn_pack_upload(self, corpus: PackedCorpus) -> None:
        """Background uploader for a deferred pack
        (``pack_corpus(defer_upload=True)``): stage the host pack onto
        the device (yielding the link to live queries between chunks),
        publish the device arrays on the corpus, then kick the rescore
        mirror build.  While it runs, ``host_route`` answers queries
        from the host f32 cache; device-only paths block in
        ``wait_device``.

        Failure policy: transient link errors retry with cleared jit
        caches; a permanent failure publishes the HOST arrays instead —
        device calls then pay an implicit per-call upload (correct, slow,
        loudly logged) rather than deadlocking waiters."""
        with self._mirror_lock:
            t = self._pack_thread
            if t is not None and t.is_alive():
                return
            stop = self._mirror_stop
            host_data = corpus.data
            host_scales = corpus.row_scales

            def work() -> None:
                from .packing import staged_device_put

                published = False
                try:
                    throttle = functools.partial(
                        self._mirror_throttle, stop, 5.0
                    )
                    log.info(
                        "uploading pack to device in background (%.2f GB); "
                        "queries answer from the host cache meanwhile",
                        host_data.nbytes / 1e9,
                    )
                    for attempt in range(3):
                        try:
                            dev = staged_device_put(
                                np.asarray(host_data), self.device,
                                throttle=throttle,
                            )
                            sc = (
                                jax.device_put(host_scales, self.device)
                                if host_scales is not None else None
                            )
                            dev.block_until_ready()
                            corpus.publish_device(dev, sc)
                            published = True
                            log.info("pack live on device")
                            self._maybe_build_device_rescore(corpus)
                            return
                        except _MirrorUploadAborted:
                            return
                        except Exception as exc:
                            jax.clear_caches()
                            if attempt == 2:
                                raise
                            log.warning(
                                "pack upload failed (%s); retrying", exc
                            )
                            time.sleep(2.0 * (attempt + 1))
                except Exception:
                    log.warning(
                        "background pack upload failed permanently; "
                        "device calls will pay per-call uploads",
                        exc_info=True,
                    )
                finally:
                    if not published:
                        # release waiters even on abort/failure — the
                        # host arrays stay (correct; device paths
                        # implicitly upload per call)
                        corpus.publish_device(host_data, host_scales)

            t = threading.Thread(
                target=work, name="svs-tpu-pack-upload", daemon=True
            )
            t.start()
            self._pack_thread = t

    @property
    def pack_uploading(self) -> bool:
        """True while a deferred pack upload is in flight (cold start:
        queries answer from the host cache, exactly)."""
        t = self._pack_thread
        return t is not None and t.is_alive()

    def _maybe_build_device_rescore(self, corpus: PackedCorpus) -> None:
        """Upload the f32 rescore cache to HBM (policy-gated) so batched
        rescores gather on-device instead of dragging ~O(B*C*d) candidate
        bytes through the host (630 MB per 256-query batch at 1M x 1536 —
        the measured end-to-end bottleneck on small host VMs).

        Policy: single chip, rescoring on, ``device_rescore`` not 'host',
        and an exact f32 gather source available — for bf16/int8 the host
        cache uploaded within ``SVS_TPU_DEVICE_RESCORE_MAX_BYTES``
        (default ``utils.device_memory.mirror_budget``; 0 disables); for
        f32 the pack itself (already in
        HBM — no second copy, no host cache required).  Incremental
        appends drop the mirror (a fresh corpus object) and it is rebuilt
        here on the next query — a full re-upload, cheap on-chip,
        deliberate simplicity over incremental HBM appends.
        """
        if (
            corpus.dev_rescore is not None
            or not corpus.device_ready  # pack uploader calls back after
            or not self.rescore
            or self.device_rescore == "host"
            or corpus.n_valid == 0
        ):
            return
        # NOTE: no "is this the engine's current pack" guard here —
        # derived subset corpora (filtered pairwise) and replica clones
        # legitimately build mirrors for packs the engine never owns.
        # Stale-primary spawns are already harmless: the background
        # publish path re-checks ``self._corpus`` at publish time
        # (``check_current``) and discards mirrors for superseded packs.
        if self.mesh is not None and self.model_axis is not None:
            return  # model-axis shards split the dim; rescore stays host
        from ..utils.env import env_int

        budget = env_int(
            "SVS_TPU_DEVICE_RESCORE_MAX_BYTES",
            device_memory.mirror_budget(self.device),
        )
        if budget <= 0:
            return
        # emb-id mirror (int32, pack-row order): lets the final top-k
        # selection run on-device with the reference tie rule (equal
        # scores -> larger emb id), shrinking the result wire from
        # [B, 2C+1] to [B, 2k+1].  (``emb_ids_fit_int32`` is memoized —
        # this runs on the query hot path whenever the mirror is gated
        # off and must stay O(1) after the first call.)
        if corpus.precision == "f32":
            # The pack itself IS an exact f32 gather source: pack rows
            # index it directly, and its zero padding columns contribute
            # nothing to the padded-query dot — so the mirror is free (no
            # second HBM copy, no host cache required).  The rescore
            # callers detect the padded width and skip the query slice.
            if self.mesh is not None:
                if not corpus.emb_ids_fit_int32():
                    return  # the mesh path IS the final selection
                self._put_mesh_emb_mirror(corpus)
            elif corpus.emb_ids_fit_int32():
                self._put_emb_mirror(corpus)
            object.__setattr__(corpus, "dev_rescore", (corpus.data, None))
            return
        if corpus.host_cache is None:
            return
        cache_f32, row_map = corpus.host_cache
        if cache_f32.nbytes > budget:
            return
        if self.mesh is not None:
            if not corpus.emb_ids_fit_int32():
                return  # the mesh path IS the final selection; no mirror
            self._build_mesh_rescore(corpus, cache_f32, row_map)
            return
        if cache_f32.nbytes <= _MIRROR_SYNC_MAX_BYTES:
            try:
                self._upload_and_publish_mirror(corpus, cache_f32, row_map)
            except Exception:
                # The mirror is an optimization: a failed upload (dead
                # link, OOM) must degrade to the host rescore, never
                # fail the query/ensure_fresh that triggered the build.
                log.warning(
                    "device rescore mirror upload failed; rescore stays "
                    "on the host cache", exc_info=True,
                )
            return
        # Large mirrors upload in a BACKGROUND thread: shipping the f32
        # cache (6.1 GB at 1M x 1536) across the device link would
        # otherwise sit on the cold first query.  Rescore rides the host
        # cache until the
        # mirror publishes; one uploader at a time, and a publish onto a
        # superseded corpus is dropped at the final check.
        with self._mirror_lock:
            t = self._mirror_thread
            if t is not None and t.is_alive():
                return

            # Capture the CURRENT stop event: shutdown() re-arms the
            # attribute after its join attempt, so a straggler thread
            # reading ``self._mirror_stop`` would see the fresh, unset
            # event and keep uploading past the close.
            stop = self._mirror_stop

            def work() -> None:
                try:
                    self._upload_and_publish_mirror(
                        corpus, cache_f32, row_map,
                        check_current=True, stop=stop,
                    )
                except Exception:
                    log.debug("device mirror upload failed", exc_info=True)

            t = threading.Thread(
                target=work, name="svs-tpu-mirror-upload", daemon=True
            )
            t.start()
            self._mirror_thread = t

    def _upload_and_publish_mirror(
        self,
        corpus: PackedCorpus,
        cache_f32: np.ndarray,
        row_map: Optional[np.ndarray],
        check_current: bool = False,
        stop: Optional[threading.Event] = None,
    ) -> None:
        """Upload the f32 mirror (+ int32 row map) and publish both on
        ``corpus``.  ``check_current`` (the background path) re-reads
        ``self._corpus`` at publish time so a mirror built for a
        superseded pack is discarded instead of attached; ``stop`` is the
        shutdown event captured at spawn time (NOT re-read from the
        engine, which re-arms the attribute after a timed-out join)."""
        log.info(
            "uploading f32 rescore mirror to device (%.2f GB)",
            cache_f32.nbytes / 1e9,
        )
        dev = self._upload_f32_mirror(
            cache_f32, background=check_current, stop=stop
        )
        dev_map = (
            jax.device_put(row_map.astype(np.int32), self.device)
            if row_map is not None
            else None
        )
        if check_current:
            dev.block_until_ready()
            # The engine lock (NOT held by this background thread) makes
            # the superseded-corpus check and the publish one atomic step
            # against ensure_fresh swapping packs.
            with self._lock:
                if (
                    self._corpus is not corpus
                    or corpus.dev_rescore is not None
                ):
                    return
                self._publish_mirror(corpus, dev, dev_map)
            log.info("f32 rescore mirror live on device")
            return
        self._publish_mirror(corpus, dev, dev_map)

    def _publish_mirror(
        self,
        corpus: PackedCorpus,
        dev: jax.Array,
        dev_map: Optional[jax.Array],
    ) -> None:
        # dev_emb is published BEFORE dev_rescore: consumers gate on
        # dev_rescore and may then read dev_emb without re-checking.
        if corpus.emb_ids_fit_int32():
            self._put_emb_mirror(corpus)
        object.__setattr__(corpus, "dev_rescore", (dev, dev_map))

    def _upload_f32_mirror(
        self,
        cache_f32: np.ndarray,
        background: bool = False,
        stop: Optional[threading.Event] = None,
    ) -> jax.Array:
        """Stage the f32 cache onto the device in chunks — see
        :func:`packing.staged_device_put` for why a direct ``device_put``
        of a sidecar-mmap-backed cache is ~40x slower.  Background
        uploads additionally yield the link to live queries between
        chunks."""
        from .packing import staged_device_put

        if cache_f32.dtype != np.float32:  # defensive; caches are f32
            cache_f32 = np.asarray(cache_f32, dtype=np.float32)
        throttle = None
        if background:
            ev = stop if stop is not None else self._mirror_stop
            throttle = functools.partial(self._mirror_throttle, ev)
        return staged_device_put(
            cache_f32,
            self.device,
            chunk_bytes=_MIRROR_CHUNK_BYTES,
            throttle=throttle,
        )

    @property
    def mirror_uploading(self) -> bool:
        """True while a background f32 mirror upload is in flight —
        queries still answer exactly (host rescore fallback) but contend
        with the transfer; ``serve`` surfaces this as ``warming``."""
        t = self._mirror_thread
        return t is not None and t.is_alive()

    def wait_for_mirror(self, timeout: Optional[float] = None) -> bool:
        """Block until the engine reaches its steady-state fast regime:
        the deferred pack upload, the background rescore-cache rebuild
        (sidecar cold starts scan SQLite for the f32 bytes), and the f32
        device-mirror upload have all finished — INCLUDING uploads those
        earlier stages spawn when they land (the cache rebuild attaching
        ``host_cache`` is what makes the mirror build possible, so a
        single join pass could return "ready" while the corpus still had
        neither a host f32 cache nor a device mirror — exactly the
        undiagnosable slow-regime measurement round 4 shipped).  Returns
        False when a timeout elapsed first OR background work kept
        respawning past a bounded number of re-kicks (a fast-failing
        upload cycle) — either way "not settled", and the caller's
        regime/record should read the actual corpus state."""
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )

        def join(t: Optional[threading.Thread]) -> bool:
            if t is None:
                return True
            left = (
                None if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
            t.join(left)
            return not t.is_alive()

        # Loop: each completed stage can spawn the next (pack upload ->
        # mirror build; cache rebuild -> mirror build on the next kick).
        # Runs until nothing respawns or the deadline passes — a fixed
        # iteration cap falling through to True would report a steady
        # state that was never reached (e.g. a transiently-failing
        # mirror upload re-kicked every pass).  The re-kick cap applies
        # WITH a deadline too: a fast-failing upload would otherwise be
        # respawned every pass in a hot loop until the deadline (a
        # 10-minute timeout = hundreds of doomed upload threads).
        spins = 0
        while True:
            spins += 1
            if spins > 8:
                return False
            if not join(self._pack_thread):
                return False
            if not join(self._cache_rebuild_thread):
                return False
            corpus = self._corpus
            if corpus is not None and corpus.device_ready:
                # The cache may have attached after the pack upload's
                # own mirror kick — re-kick so the mirror build isn't
                # stranded until the next query.
                self._maybe_build_device_rescore(corpus)
            if not join(self._mirror_thread):
                return False
            # Done only when nothing respawned behind our backs.
            threads = (
                self._pack_thread,
                self._cache_rebuild_thread,
                self._mirror_thread,
            )
            if all(t is None or not t.is_alive() for t in threads):
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False

    def _mirror_throttle(
        self, stop: threading.Event, max_defer: float = 60.0
    ) -> None:
        """Called between background-upload chunks: wait until no query
        is in flight AND arrivals have a 250 ms quiet gap, so the upload
        never starves live traffic on a slow device link — but never
        defer a single chunk past ``max_defer`` seconds (progress
        guarantee under sustained load; the PACK upload uses a tight
        bound — finishing it is what ends the slower host-answering
        phase).  Aborts when ``stop`` (the shutdown event captured when
        this upload was spawned) is set."""
        deadline = time.monotonic() + max_defer
        while True:
            if stop.is_set():
                raise _MirrorUploadAborted()
            if time.monotonic() >= deadline:
                return
            with self._inflight_lock:
                busy = self._inflight > 0
                waited_on = self._pack_waiters > 0
            if waited_on:
                # Someone is blocked in wait_device on THIS upload —
                # yielding to "in-flight" traffic would be a priority
                # inversion (the waiter is counted in-flight while it
                # sleeps).  Finishing the upload is what unblocks them.
                return
            if not busy and time.monotonic() - self._last_query_t >= 0.25:
                return
            time.sleep(0.05)

    def _build_mesh_rescore(
        self,
        corpus: PackedCorpus,
        cache_f32: np.ndarray,
        row_map: Optional[np.ndarray],
    ) -> None:
        """Shard the f32 rescore mirror over the data axis (pack-row
        order, padded to ``n_padded`` so shard boundaries match the
        corpus) and replicate the int32 emb-id mirror.  Each shard then
        rescores the merged candidates that live in its row range — only
        candidate metadata ever crosses devices (see
        ``parallel.sharded.sharded_rescore_final``)."""
        from jax.sharding import NamedSharding, PartitionSpec

        assert self.mesh is not None
        n_pad, n_valid = corpus.n_padded, corpus.n_valid
        d = corpus.dim
        sharding = NamedSharding(self.mesh, PartitionSpec(self.data_axis, None))

        def shard_rows(idx: Tuple[slice, ...]) -> np.ndarray:
            r = idx[0].indices(n_pad)
            r0, r1 = r[0], r[1]
            out = np.zeros((r1 - r0, d), dtype=np.float32)
            hi = min(r1, n_valid)
            if hi > r0:
                rows = np.arange(r0, hi)
                src = rows if row_map is None else row_map[rows]
                out[: hi - r0] = cache_f32[src]
            return out

        log.info(
            "uploading sharded f32 rescore mirror (%.2f GB over %d shards)",
            n_pad * d * 4 / 1e9, int(self.mesh.shape[self.data_axis]),
        )
        dev = jax.make_array_from_callback((n_pad, d), sharding, shard_rows)
        self._put_mesh_emb_mirror(corpus)
        object.__setattr__(corpus, "dev_rescore", (dev, None))

    def _put_emb_mirror(self, corpus: PackedCorpus) -> None:
        """Single-chip int32 emb-id mirror ([n_valid], pack-row order) —
        the final-selection input of :meth:`topk_final`."""
        object.__setattr__(
            corpus,
            "dev_emb",
            jax.device_put(
                np.ascontiguousarray(corpus.emb_ids.astype(np.int32)),
                self.device,
            ),
        )

    def _put_mesh_emb_mirror(self, corpus: PackedCorpus) -> None:
        """Replicate the int32 emb-id mirror ([n_padded], pack-row order)
        over the mesh — the final-selection input of
        ``parallel.sharded.sharded_rescore_final``."""
        from jax.sharding import NamedSharding, PartitionSpec

        assert self.mesh is not None
        emb_pad = np.zeros(corpus.n_padded, dtype=np.int32)
        emb_pad[: corpus.n_valid] = corpus.emb_ids.astype(np.int32)
        dev_emb = jax.device_put(
            emb_pad, NamedSharding(self.mesh, PartitionSpec(None))
        )
        object.__setattr__(corpus, "dev_emb", dev_emb)

    # -- host-path dispatch --------------------------------------------------

    #: Re-probe schedule for the RPC floor: 30 s after the first
    #: measurement, doubling to a 15-minute steady state — frequent
    #: enough to track hour-scale link drift, rare enough to cost
    #: nothing (one probe = 3 tiny RPCs at a quiet moment).
    RPC_REPROBE_BASE_S = 30.0
    RPC_REPROBE_MAX_S = 900.0

    def _measure_rpc_floor_once(self) -> float:
        """min-of-3 round trips of a pre-compiled 8-element reduction —
        the time is all RPC.  Raises on device errors (callers decide
        caching policy)."""
        dev = self.device
        if dev is None and self.mesh is not None:
            dev = next(iter(self.mesh.devices.flat))
        x = jax.device_put(np.zeros(8, np.float32), dev)
        f = jax.jit(jnp.sum)
        np.asarray(f(x))  # compile outside the timed runs
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(f(x))
            best = min(best, time.perf_counter() - t0)
        return best

    def _rpc_refresh_interval(self) -> float:
        return min(
            self.RPC_REPROBE_MAX_S,
            self.RPC_REPROBE_BASE_S * (2.0 ** max(0, self._rpc_probes - 1)),
        )

    def _quiet(self) -> bool:
        with self._inflight_lock:
            busy = self._inflight > 0
        return not (busy or self.pack_uploading or self.mirror_uploading)

    def _maybe_spawn_rpc_probe(self) -> None:
        """Background re-measure of the RPC floor at a quiet moment; the
        result blends in (EWMA) so one outlier probe can't swing the
        dispatch, while a genuinely moved floor converges in a few
        probes."""
        if not self._quiet():
            return
        t = self._rpc_probe_thread
        if t is not None and t.is_alive():
            return

        def work() -> None:
            try:
                new = self._measure_rpc_floor_once()
            except Exception:
                log.debug("rpc floor re-probe failed", exc_info=True)
                return
            old = self._rpc_floor
            blended = new if old is None else 0.5 * old + 0.5 * new
            self._rpc_floor = blended
            self._rpc_floor_t = time.monotonic()
            self._rpc_probes += 1
            log.info(
                "device RPC floor re-probed: %.2f ms (blended %.2f ms)",
                new * 1e3, blended * 1e3,
            )

        t = threading.Thread(
            target=work, name="svs-tpu-rpc-probe", daemon=True
        )
        t.start()
        self._rpc_probe_thread = t

    def device_rpc_floor(self) -> float:
        """Time-weighted round-trip floor of one minimal dispatch+fetch
        on this engine's device: ~30 ms for a remote device, ~0.1 ms
        locally.  First measured lazily at a quiet moment, then
        re-probed in the background on a decaying schedule
        (:meth:`_maybe_spawn_rpc_probe`) — a remote link's real floor
        moves by 10x across hours, so a single cached measurement would
        mis-route load for the process lifetime.

        Never measured while uploads or searches are in flight: the
        probe would queue behind them (a 600 MB mirror chunk held one
        probe for ~50 s) and the inflated floor would mis-route load to
        host scans.  Until a quiet moment arrives, the prior stands
        (``SVS_TPU_RPC_FLOOR``, default 30 ms)."""
        if self._rpc_floor is not None:
            if (
                time.monotonic() - self._rpc_floor_t
                >= self._rpc_refresh_interval()
            ):
                self._maybe_spawn_rpc_probe()
            return self._rpc_floor
        from ..utils.env import env_float

        prior = env_float("SVS_TPU_RPC_FLOOR", _RPC_FLOOR_PRIOR)
        if not self._quiet():
            return prior  # uncached: re-attempt at the next quiet call
        try:
            best = self._measure_rpc_floor_once()
        except Exception:
            # A TRANSIENT device error must not poison the cache: a
            # permanently-cached inf would route all eligible traffic to
            # the host scan for the life of the engine.  Leave the floor
            # unset (return the prior) so a later quiet call re-measures;
            # a truly absent backend keeps failing and keeps the prior,
            # which host_route treats conservatively.
            log.warning(
                "device RPC floor probe failed; keeping the prior "
                "(%.1f ms) and re-probing at the next quiet call",
                prior * 1e3, exc_info=True,
            )
            return prior
        self._rpc_floor = best
        self._rpc_floor_t = time.monotonic()
        self._rpc_probes = 1
        log.info("device RPC floor: %.2f ms", best * 1e3)
        return best

    def host_route(
        self, corpus: PackedCorpus, batch: int, k: Optional[int] = None
    ) -> bool:
        """The dispatch rule: answer from the host f32 cache when the
        estimated host exact-scan cost (batch x cache bytes / learned
        host bandwidth) beats the measured device round-trip floor.

        Never routes to the host when the exactness machinery there is
        unavailable (no host cache, rescore opted out) — and never at
        batch x corpus sizes whose score matrix would not be small
        (``_HOST_SCAN_MAX_SCORE_BYTES``): the device wins those anyway.

        ``k`` (when the caller knows it) keeps the cost model honest at
        two-pass shapes: the faster two-pass bandwidth only applies when
        the executor would actually take the two-pass, which declines at
        ``k >= n/8`` — without the check, a large-``k`` small-batch
        request would be modeled at int8 speed and then execute the full
        f32 GEMM.
        """
        if (
            self.host_dispatch == "off"
            or not self.rescore
            or corpus.host_f32 is None
            or corpus.n_valid == 0
        ):
            return False
        if not corpus.device_ready:
            # Pre-upload cold start: the pack is still crossing the
            # device link in the background — the host exact scan
            # (sub-second at 1M) beats waiting out a multi-GB upload at
            # ANY batch size, so no score-matrix guard here
            # (host_topk_exact slabs the batch to bound memory).
            return True
        if self.host_dispatch == "force":
            return True
        if batch * corpus.n_valid * 4 > _HOST_SCAN_MAX_SCORE_BYTES:
            return False
        # One GEMM pass per query slab (host_topk_exact); one device RPC
        # serves the whole batch.  At two-pass-eligible shapes the host
        # answers from the int8 prescore at its own (faster) measured
        # rate — use that estimate there, and ONLY there (the full-scan
        # EWMA stays calibrated for larger batches).
        self._maybe_refresh_host_bw(corpus)
        bw = self._host_scan_bw
        if (
            batch <= self.HOST_TWOPASS_MAX_BATCH
            and self._host_twopass_bw is not None
            and corpus.host_i8 is not None
            and k is not None and k < corpus.n_valid // 8
        ):
            bw = max(bw, self._host_twopass_bw)
        slab = max(
            1, _HOST_SCAN_MAX_SCORE_BYTES // max(1, corpus.n_valid * 4)
        )
        passes = -(-batch // slab)
        host_s = passes * corpus.host_f32.nbytes / bw
        return host_s < self.device_rpc_floor()

    #: Re-probe the host-scan bandwidth estimate when it has not been
    #: refreshed (by a real host scan or a probe) for this long.
    HOST_BW_REFRESH_S = 300.0

    def _maybe_refresh_host_bw(self, corpus: PackedCorpus) -> None:
        """Cheap background slab probe of the host-scan bandwidth when
        the EWMA has gone stale — the estimate otherwise only updates
        when the host path RUNS, so a device-winning steady state would
        starve it forever (and a stale low estimate can keep the host
        path off exactly when link drift makes it the right
        route)."""
        if time.monotonic() - self._host_bw_t < self.HOST_BW_REFRESH_S:
            return
        t = self._host_bw_thread
        if t is not None and t.is_alive():
            return
        hf = corpus.host_f32
        if hf is None or hf.shape[0] == 0:
            return
        self._host_bw_t = time.monotonic()  # claim before the thread runs

        def work() -> None:
            try:
                rows = min(
                    hf.shape[0],
                    max(1, 64 * 1024 * 1024 // max(1, hf.shape[1] * 4)),
                )
                q = np.zeros(hf.shape[1], dtype=np.float32)
                q[0] = 1.0
                t0 = time.perf_counter()
                _ = hf[:rows] @ q
                dt = time.perf_counter() - t0
                if dt > 1e-6:
                    measured = rows * hf.shape[1] * 4 / dt
                    self._host_scan_bw = (
                        0.5 * self._host_scan_bw + 0.5 * measured
                    )
                    log.debug(
                        "host scan bandwidth probe: %.2f GB/s "
                        "(EWMA %.2f GB/s)",
                        measured / 1e9, self._host_scan_bw / 1e9,
                    )
            except Exception:
                log.debug("host bandwidth probe failed", exc_info=True)

        t = threading.Thread(
            target=work, name="svs-tpu-hostbw-probe", daemon=True
        )
        t.start()
        self._host_bw_thread = t

    def host_topk_exact(
        self, corpus: PackedCorpus, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-``k`` over the WHOLE corpus on the host + the
        reference tie rule.  Solo queries use a ``np.dot`` matvec (the
        reference's exact accumulation, ``svs/kb.py:1185`` —
        bit-identical scores); batches use ONE BLAS GEMM per query slab
        so the cache is read once per slab, not once per query (a
        256-query pre-upload batch over a 6.1 GB cache measured ~560 s
        as per-query matvecs vs seconds as a GEMM).  GEMM accumulation
        can differ from the matvec in the last ulp — the same contract
        as the default on-device rescore (``device_rescore='auto'``).

        This is the small-corpus fast path ``host_route`` dispatches to
        (and the pre-upload cold-start path) — same exact f32 scores,
        same tie rule as the device path; no margin proof needed, every
        document is scored in f32.  Returns ``(emb_ids int64 [B, k'],
        scores f32 [B, k'])`` with ``k' = min(k, n_valid)``.  Also feeds
        the measured scan bandwidth back into the dispatch rule's
        EWMA."""
        hf, rm = corpus.host_f32, corpus.host_row_map
        assert hf is not None, "host_topk_exact requires the host f32 cache"
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        b = queries.shape[0]
        k_eff = min(int(k), corpus.n_valid)
        if k_eff <= 0:
            return (
                np.zeros((b, 0), dtype=np.int64),
                np.zeros((b, 0), dtype=np.float32),
            )
        if rm is None:
            emb_hf = corpus.emb_ids
        else:
            # hf row rm[p] holds pack row p's vector -> emb id of hf row
            emb_hf = np.empty_like(corpus.emb_ids)
            emb_hf[rm] = corpus.emb_ids
        two = self._host_two_pass(corpus, hf, emb_hf, queries, k_eff)
        if two is not None:
            return two
        t0 = time.perf_counter()
        # Slab the batch so the [B, n] score matrix stays bounded (the
        # pre-upload path routes ANY batch size here).
        slab = max(1, _HOST_SCAN_MAX_SCORE_BYTES // max(1, hf.shape[0] * 4))
        emb_out = np.empty((b, k_eff), dtype=np.int64)
        score_out = np.empty((b, k_eff), dtype=np.float32)
        passes = 0
        for lo in range(0, b, slab):
            hi = min(b, lo + slab)
            passes += 1
            if hi - lo == 1:
                # matvec: the reference's exact accumulation order
                exact = (hf @ queries[lo])[None, :]
            else:
                # one GEMM: single pass over the cache for the slab
                exact = queries[lo:hi] @ hf.T
            emb_out[lo:hi], score_out[lo:hi] = _subset_select_np(
                exact, emb_hf, k_eff
            )
        elapsed = time.perf_counter() - t0
        if elapsed > 1e-5:
            measured = passes * hf.nbytes / elapsed
            self._host_scan_bw = 0.5 * self._host_scan_bw + 0.5 * measured
            self._host_bw_t = time.monotonic()  # real scan = fresh sample
        return emb_out, score_out

    #: Host two-pass dispatch bounds: below MIN_ROWS a single BLAS
    #: matvec is already ~100 us (selection overhead would dominate);
    #: above MAX_BATCH the per-query int8 scan re-reads the matrix b
    #: times while the full-scan GEMM reads the f32 cache once per slab,
    #: so the crossover is b ~ f32_bytes/int8_bytes = 4.
    HOST_TWOPASS_MIN_ROWS = 4096
    HOST_TWOPASS_MAX_BATCH = 4
    #: Build the int8 host arrays synchronously below this f32-cache
    #: size (one ~quantize pass); larger corpora build in a background
    #: thread and answer with the full scan meanwhile.
    HOST_I8_SYNC_MAX_BYTES = 128 * 1024 * 1024

    def _ensure_host_i8(
        self, corpus: PackedCorpus, hf: np.ndarray
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """The corpus's host int8 prescore arrays, built lazily from the
        host f32 cache (native quantization; row sums for the VNNI
        kernel).  Attached atomically to the immutable pack object —
        same publication pattern as ``host_cache``."""
        tri = corpus.host_i8
        if tri is not None:
            return tri
        from ..native import native_available, quantize_int8

        if not native_available():
            return None

        def build() -> None:
            di8, scales = quantize_int8(hf)
            sums = di8.sum(axis=1, dtype=np.int32)
            object.__setattr__(corpus, "host_i8", (di8, scales, sums))

        if hf.nbytes <= self.HOST_I8_SYNC_MAX_BYTES:
            build()
            return corpus.host_i8
        # large: background build, full scan until it lands
        t = getattr(self, "_host_i8_thread", None)
        if t is None or not t.is_alive():
            t = threading.Thread(
                target=build, name="svs-tpu-host-i8", daemon=True
            )
            t.start()
            self._host_i8_thread = t
        return None

    def _host_two_pass(
        self,
        corpus: PackedCorpus,
        hf: np.ndarray,
        emb_hf: np.ndarray,
        queries: np.ndarray,
        k_eff: int,
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Two-pass host search: native int8 prescore selects candidates
        (1/4 the scanned bytes of the full f32 matvec the reference
        does, ``svs/kb.py:1185``), an exact f32 rescore of the candidate
        set applies the reference tie rule, and the SAME margin proof as
        the device path verifies coverage — widen x4 and retry on
        failure, full rescore (= exact by construction) at C = n.
        Returned scores are per-row f32 dots of the stored vectors —
        bit-identical to the reference's accumulation.  Returns ``None``
        when the route doesn't apply (no native kernel, tiny corpus,
        batch past the int8-rescan crossover, rescore opted out)."""
        b = queries.shape[0]
        n = hf.shape[0]
        if (
            not self.rescore
            or b > self.HOST_TWOPASS_MAX_BATCH
            or n < self.HOST_TWOPASS_MIN_ROWS
            or k_eff >= n // 8  # candidate set would be most of the corpus
        ):
            return None
        tri = self._ensure_host_i8(corpus, hf)
        if tri is None:
            return None
        from ..native import int8_topc_prescore

        di8, scales, sums = tri
        t0 = time.perf_counter()
        s_q = (
            np.maximum(np.max(np.abs(queries), axis=1), 1e-30) / 127.0
        ).astype(np.float32)
        q_i8 = np.clip(
            np.rint(queries / s_q[:, None]), -127, 127
        ).astype(np.int8)
        # Same int8 error bound as the device path (prescore_eps
        # derivation), minus the packed-key term (no key quantization
        # here): concentration + deterministic residual + f32 cushion.
        d = hf.shape[1]
        s_d = float(scales.max()) if scales.size else 0.0
        t_conc = float(np.sqrt(2.0 * np.log(2.0 / 1e-15)))
        eps = (
            0.5 * t_conc * (s_q.astype(np.float64) + s_d) * 1.001
            + 0.25 * d * s_q.astype(np.float64) * s_d
            + 3e-5
        )
        c = self.candidate_count(k_eff)
        while True:
            c_eff = min(c, n)
            out = int8_topc_prescore(di8, scales, sums, q_i8, s_q, c_eff)
            if out is None:
                return None
            pre_vals, pre_idx = out
            emb_out = np.empty((b, k_eff), dtype=np.int64)
            score_out = np.empty((b, k_eff), dtype=np.float32)
            ok = True
            for bi in range(b):
                rows = pre_idx[bi].astype(np.int64)
                # per-row dots: the reference's exact accumulation order
                exact = hf[rows] @ queries[bi]
                e_sel, s_sel = _subset_select_np(
                    exact[None, :], emb_hf[rows], k_eff
                )
                if c_eff < n and s_sel[0, -1] < pre_vals[bi, -1] + eps[bi]:
                    ok = False
                    break
                emb_out[bi] = e_sel[0]
                score_out[bi] = s_sel[0]
            if ok:
                elapsed = time.perf_counter() - t0
                if elapsed > 1e-5:
                    # Record the two-pass EFFECTIVE bandwidth (model
                    # cost: passes * f32 bytes / bw) in its OWN EWMA —
                    # folding it into _host_scan_bw would teach the
                    # full-scan cost model a ~4x-inflated speed and
                    # mis-route batches past HOST_TWOPASS_MAX_BATCH,
                    # which must pay the real f32 GEMM.  host_route
                    # consults this estimate only at two-pass-eligible
                    # shapes.
                    slab = max(
                        1, _HOST_SCAN_MAX_SCORE_BYTES // max(1, n * 4)
                    )
                    passes = -(-b // slab)
                    measured = passes * hf.nbytes / elapsed
                    prev = self._host_twopass_bw
                    self._host_twopass_bw = (
                        measured if prev is None
                        else 0.5 * prev + 0.5 * measured
                    )
                return emb_out, score_out
            c *= 4
            log.info(
                "host two-pass margin insufficient; widening candidates "
                "to %d", min(c, n),
            )

    @_marks_inflight
    def topk_with_rescore(
        self, corpus: PackedCorpus, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """:meth:`topk` plus, when the corpus carries a device rescore
        mirror, the exact f32 scores of every returned candidate —
        computed on-device (gather from the HBM f32 mirror + f32 dot).

        Returned exact scores are true f32 dot products of the stored
        vectors; the accumulation order is the device's, so values can
        differ from CPU BLAS in the last ulp (the ``+3e-5`` cushion in
        :meth:`prescore_eps` covers this for the margin proof).  Callers
        wanting reference-bit-identical values pass
        ``device_rescore='host'`` to the engine.  Third element is
        ``None`` when the mirror is absent — callers fall back to the
        host gather.

        When exact scores are returned, the first element carries only
        the BOUNDARY prescore broadcast to ``[B, C]`` (the compact wire
        ships one prescore per query — the margin proof reads
        ``pre_vals[:, -1]`` and the exact scores supersede the rest).
        """
        dev = corpus.dev_rescore
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        k_eff = min(int(k), corpus.n_valid)
        # Size the [B, C, d] gather guard with the MIRROR's width: the
        # f32 pack-reuse mirror materializes dim_padded columns per
        # candidate, not corpus.dim.
        if dev is not None and (
            self.mesh is not None  # mesh rescore lives in topk_final only
            or queries.shape[0] * k_eff * int(dev[0].shape[1]) * 4
            > device_memory.gather_budget(self.device)
        ):
            dev = None  # host rescore instead
        if dev is None:
            # NON-virtual on purpose: under a ReplicaEngine this method
            # already runs on a per-replica slice; a virtual self.topk
            # would re-enter the replica splitter and split the work
            # twice.
            vals, rows = RetrievalEngine.topk(self, corpus, queries, k)
            return vals, rows, None
        if k_eff <= 0:
            b = queries.shape[0]
            empty = np.zeros((b, 0), dtype=np.float32)
            return empty, np.zeros((b, 0), dtype=np.int64), empty
        # The rescore CHAINS off the on-device prescore handle — no host
        # fetch, no candidate-row re-upload in between — and everything
        # (prescores, rows, exact scores) lands in ONE fetched array: one
        # round trip instead of three.
        # ONE query upload serves prescore and rescore (see
        # ``_prescore_packed``).
        holder: Dict[str, bool] = {}

        def dispatch() -> jax.Array:
            q_dev = self._put_queries(corpus, queries)
            packed_dev, w = self._prescore_packed(
                corpus, queries, k_eff, q_dev=q_dev
            )
            holder["wide"] = w
            return _rescore_from_packed(
                packed_dev, dev[0], dev[1], q_dev, k_eff, w,
                dim=_mirror_dim(dev[0], corpus),
            )

        # [B, 2C + 1] compact wire; hedged — see _fetch_hedged
        arr = self._fetch_hedged(
            dispatch, f"rescore:{queries.shape[0]}x{k_eff}"
        )
        wide = holder["wide"]
        if wide:
            rows = arr[:, :k_eff].astype(np.int64)
            f32_part = np.ascontiguousarray(arr[:, k_eff:]).view(np.float32)
        else:
            rows = arr[:, :k_eff].astype(np.int64)
            f32_part = arr[:, k_eff:].astype(np.float32, copy=False)
        exact = f32_part[:, :k_eff]
        # of the C prescores only the boundary value crossed the wire;
        # the margin proof reads pre_vals[:, -1], so a broadcast view of
        # the tail column is a faithful stand-in
        tail = np.ascontiguousarray(f32_part[:, k_eff])
        vals = np.broadcast_to(tail[:, None], exact.shape)
        return vals, rows, exact

    #: Hedge only after the fetch has exceeded ``clamp(HEDGE_FACTOR x
    #: EWMA, HEDGE_MIN_S, HEDGE_MAX_S)`` — generous so a mid-traffic jit
    #: compile (a widen retry's fresh shape) never fires a spurious
    #: duplicate, tight enough that a wedged device fetch (a stalled
    #: link can stream 0 bytes forever) costs one deadline instead
    #: of an unbounded stall.  The MAX cap matters under sustained bad
    #: weather: stall-inflated samples would otherwise grow the EWMA —
    #: and with it the deadline — until a single request could sit for
    #: a minute before hedging (observed: a 504 through the serve layer
    #: whose handler timed out first).  EWMA samples are clamped to the
    #: deadline for the same reason.
    HEDGE_MIN_S = 2.0
    HEDGE_MAX_S = 20.0
    HEDGE_FACTOR = 8.0

    def _fetch_hedged(
        self,
        dispatch: Callable[[], Any],
        label: str,
    ) -> np.ndarray:
        """``np.asarray(dispatch())`` with a wedge deadline.

        Remote device links can stall for multi-second stretches with
        the device itself idle.  When a
        result fetch exceeds a deadline derived from this label's recent
        healthy fetches, the SAME step is dispatched again — pure jitted
        math over on-device arrays, ~ms — and whichever fetch lands
        first wins; the wedged thread is abandoned (daemon).  First call
        per label (the compile) is never hedged and seeds the EWMA.
        ``SVS_TPU_HEDGE=off`` disables."""
        import os as _os

        ewma = self._fetch_ewma.get(label)
        if ewma is None or _os.environ.get("SVS_TPU_HEDGE", "") in (
            "0", "off"
        ):
            t0 = time.perf_counter()
            out = np.asarray(dispatch())
            dt = time.perf_counter() - t0
            prev = self._fetch_ewma.get(label)
            self._fetch_ewma[label] = (
                dt if prev is None else 0.7 * prev + 0.3 * dt
            )
            return out

        deadline = min(
            self.HEDGE_MAX_S,
            max(self.HEDGE_MIN_S, self.HEDGE_FACTOR * ewma),
        )
        lock = threading.Lock()
        done = threading.Event()
        box: Dict[str, Any] = {}

        def fetch(slot: str) -> None:
            try:
                a = np.asarray(dispatch())
                with lock:
                    if "result" not in box:
                        box["result"] = a
                        box["winner"] = slot
            except Exception as exc:  # noqa: BLE001 — re-raised below
                with lock:
                    box.setdefault("errors", []).append(exc)
                    if len(box.get("errors", ())) < box.get("racers", 1):
                        return  # the other racer may still win
            done.set()

        t0 = time.perf_counter()
        box["racers"] = 1
        threading.Thread(
            target=fetch, args=("primary",), daemon=True,
            name="svs-tpu-fetch",
        ).start()
        if not done.wait(deadline):
            self._hedge_fired += 1
            log.warning(
                "device fetch %s exceeded %.1fs (healthy ~%.0fms); "
                "hedging with a duplicate dispatch", label, deadline,
                ewma * 1e3,
            )
            with lock:
                box["racers"] = 2
            threading.Thread(
                target=fetch, args=("hedge",), daemon=True,
                name="svs-tpu-fetch-hedge",
            ).start()
            # Bounded: if the primary ERRORED and the hedge also wedges,
            # an unbounded wait would hang the query forever.
            if not done.wait(max(120.0, 4.0 * deadline)):
                raise TimeoutError(
                    f"device fetch {label} wedged: primary and hedge "
                    f"both silent past {max(120.0, 4.0 * deadline):.0f}s"
                )
        with lock:
            if "result" not in box:
                raise box["errors"][0]
            if box.get("winner") == "hedge":
                self._hedge_won += 1
            else:
                # clamp: a stall that barely beat the deadline must not
                # teach the EWMA that stalls are normal
                dt = min(time.perf_counter() - t0, deadline)
                self._fetch_ewma[label] = 0.7 * ewma + 0.3 * dt
            return box["result"]

    def dispatch_stats(self) -> Dict[str, float]:
        """Current adaptive-dispatch inputs and hedge counters, surfaced
        through ``kb.stats()['dispatch']`` so operators can see WHY the
        engine routes the way it does (a stale RPC floor or host-scan
        bandwidth estimate silently mis-routes load otherwise)."""
        out: Dict[str, float] = {
            "host_scan_bw": float(self._host_scan_bw),
            "hedge_fired": float(self._hedge_fired),
            "hedge_won": float(self._hedge_won),
        }
        if self._rpc_floor is not None:
            out["rpc_floor_ms"] = float(self._rpc_floor * 1e3)
        return out

    def _put_queries(
        self, corpus: PackedCorpus, queries: np.ndarray
    ) -> jax.Array:
        """One host->device upload of the padded f32 query batch, shared
        by the prescore and rescore stages.  Replicated over the mesh
        when sharded."""
        q = pad_queries(queries, corpus.dim_padded)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            return jax.device_put(
                q, NamedSharding(self.mesh, PartitionSpec(None, None))
            )
        return jax.device_put(q, self.device)

    @_marks_inflight
    def topk_final(
        self, corpus: PackedCorpus, queries: np.ndarray, n: int, c: int
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """The fully-on-device batch pipeline: prescore (``c``
        candidates) -> exact f32 rescore -> final top-``n`` selection
        with the reference tie rule, all chained on-device; ONE query
        upload, ONE compact ``[B, 2n+1]`` fetch.

        Returns ``(emb_ids int64 [B, n'], scores f32 [B, n'], boundary
        f32 [B])`` with ``n' = min(n, c, n_valid)`` — emb ids directly
        (not pack rows), ready for hydration.  ``boundary`` is the
        per-query margin-proof bound (the C-th prescore); the
        caller proves exactness via ``scores[:, -1] >= boundary +
        prescore_eps`` and widens ``c`` on failure, exactly as with
        :meth:`topk_with_rescore`.

        Returns ``None`` when the path is unavailable (no device rescore
        mirror or no int32 emb-id mirror) — callers fall back to
        :meth:`topk_with_rescore` + host selection.  On mesh engines the
        rescore gather + partial dots run per shard with one ``psum``
        (``parallel.sharded.sharded_rescore_final``); the wire
        is identical.
        """
        dev = corpus.dev_rescore
        if dev is None or corpus.dev_emb is None:
            return None
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        c_eff = min(int(c), corpus.n_valid)
        # the rescore gather materializes [B, C, d] f32 in HBM; at wide
        # retry widths (C >= 16k at B=256, d=1536) that alone exceeds the
        # chip — route pathological widths to the host fallback instead.
        # d is the MIRROR's width (dim_padded when the f32 pack is the
        # gather source), which is what the gather actually materializes.
        if (
            queries.shape[0] * c_eff * int(dev[0].shape[1]) * 4
            > device_memory.gather_budget(self.device)
        ):
            return None
        n_eff = min(int(n), c_eff)
        if n_eff <= 0:
            b = queries.shape[0]
            empty = np.zeros((b, 0), dtype=np.float32)
            return (
                np.zeros((b, 0), dtype=np.int64),
                empty,
                np.full((b,), -np.inf, dtype=np.float32),
            )
        def dispatch() -> jax.Array:
            q_dev = self._put_queries(corpus, queries)
            packed_dev, wide = self._prescore_packed(
                corpus, queries, c_eff, q_dev=q_dev
            )
            if self.mesh is not None:
                from ..parallel.sharded import sharded_rescore_final

                return sharded_rescore_final(
                    packed_dev,
                    dev[0],
                    corpus.dev_emb,
                    q_dev,
                    n_eff,
                    wide=wide,
                    mesh=self.mesh,
                    data_axis=self.data_axis,
                    dim=_mirror_dim(dev[0], corpus),
                )
            return _final_from_packed(
                packed_dev,
                dev[0],
                dev[1],
                corpus.dev_emb,
                q_dev,
                n_eff,
                wide,
                dim=_mirror_dim(dev[0], corpus),
            )

        # [B, 2n+1] int32 wire; hedged — see _fetch_hedged
        arr = self._fetch_hedged(
            dispatch, f"final:{queries.shape[0]}x{c_eff}x{n_eff}"
        )
        emb = arr[:, :n_eff].astype(np.int64)
        scores = np.ascontiguousarray(arr[:, n_eff : 2 * n_eff]).view(
            np.float32
        )
        boundary = np.ascontiguousarray(arr[:, 2 * n_eff]).view(np.float32)
        return emb, scores, boundary

    @_marks_inflight
    def subset_topk(
        self,
        corpus: PackedCorpus,
        queries: np.ndarray,
        emb_sub: np.ndarray,
        k: int,
        cache_key: Optional[str] = None,
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Exact top-``k`` restricted to the documents whose embedding
        ids are in ``emb_sub`` — the PRE-FILTER fast path for selective
        metadata filters (``KB.retrieve(..., where=...)``): instead of
        over-fetching an exact global prefix and filtering host-side
        (the post-filter widen ladder), score ONLY the matching rows in
        exact f32 and select with the reference tie rule.  Exact by
        construction — every matching document is scored — so there is
        no margin proof and no widen loop.

        Returns ``(emb_ids int64 [B, k'], scores f32 [B, k'])`` with
        ``k' = min(k, |matching rows in this pack snapshot|)``, or
        ``None`` when no route applies (no f32 gather source, emb ids
        past int32, or a host-route shape past
        ``_SUBSET_HOST_MAX_FLOPS``) — the caller falls back to the
        post-filter ladder.  Mesh engines route through
        :func:`parallel.sharded.sharded_subset_topk` (each shard
        gathers+scores the subset rows in its range, one psum).  Ids
        absent from the pack snapshot are dropped (same snapshot
        semantics as the ladder).  ``cache_key`` (the filter's
        canonical string) caches the subset's device arrays across
        calls."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        emb_sub = np.asarray(emb_sub, dtype=np.int64)
        rows, present = corpus.rows_for_emb_ids(emb_sub)
        if not bool(present.all()):
            rows, emb_sub = rows[present], emb_sub[present]
        f = int(rows.size)
        b = queries.shape[0]
        if f == 0:
            return (
                np.zeros((b, 0), dtype=np.int64),
                np.zeros((b, 0), dtype=np.float32),
            )
        k_eff = min(int(k), f)
        dev = corpus.dev_rescore
        if (
            dev is not None
            and self.mesh is None
            and int(emb_sub.max()) < 2**31
        ):
            f_pad = max(512, 1 << (f - 1).bit_length())
            gather = f_pad * int(dev[0].shape[1]) * 4
            if gather <= device_memory.gather_budget(self.device):
                # Digest of the actual match set: a meta-only update can
                # swap WHICH ids match (same count, same pack object), so
                # identity+count alone would serve stale rows.
                digest = hashlib.blake2b(
                    emb_sub.tobytes(), digest_size=16
                ).digest()
                entry = None
                if cache_key is not None:
                    with self._lock:
                        entry = self._subset_dev.get(cache_key)
                if (
                    entry is not None
                    and entry[0] is corpus
                    and entry[3] == digest
                ):
                    _, rows_dev, emb_dev, _ = entry
                else:
                    rows_p = np.zeros(f_pad, dtype=np.int32)
                    rows_p[:f] = rows
                    emb_p = np.full(f_pad, -1, dtype=np.int32)
                    emb_p[:f] = emb_sub
                    rows_dev = jax.device_put(rows_p, self.device)
                    emb_dev = jax.device_put(emb_p, self.device)
                    if cache_key is not None:
                        with self._lock:
                            # Re-packs make every old-corpus entry dead
                            # weight (each pins the old pack + mirror in
                            # HBM); sweep them on any store.
                            stale = [
                                ck
                                for ck, e in self._subset_dev.items()
                                if e[0] is not corpus
                            ]
                            for ck in stale:
                                del self._subset_dev[ck]
                            while (
                                len(self._subset_dev)
                                >= _SUBSET_DEV_CACHE_MAX
                            ):
                                self._subset_dev.pop(
                                    next(iter(self._subset_dev))
                                )
                            self._subset_dev[cache_key] = (
                                corpus, rows_dev, emb_dev, digest,
                            )
                q_dev = self._put_queries(corpus, queries)
                wire = _subset_final(
                    dev[0],
                    dev[1],
                    rows_dev,
                    emb_dev,
                    jnp.int32(f),
                    q_dev,
                    k_eff,
                    dim=_mirror_dim(dev[0], corpus),
                )
                arr = np.asarray(wire)
                emb = arr[:, :k_eff].astype(np.int64)
                scores = np.ascontiguousarray(
                    arr[:, k_eff : 2 * k_eff]
                ).view(np.float32)
                return emb, scores
        if (
            dev is not None
            and self.mesh is not None
            and corpus.dev_emb is not None
            and int(emb_sub.max()) < 2**31
        ):
            from ..parallel.sharded import sharded_subset_topk

            f_pad = max(512, 1 << (f - 1).bit_length())
            # Each shard's gather materializes [F_pad, dim] — same
            # budget as the single-chip route, applied per chip.
            gather = f_pad * int(dev[0].shape[1]) * 4
            if gather <= device_memory.gather_budget(self.device):
                digest = hashlib.blake2b(
                    emb_sub.tobytes(), digest_size=16
                ).digest()
                entry = None
                if cache_key is not None:
                    with self._lock:
                        entry = self._subset_dev.get(cache_key)
                if (
                    entry is not None
                    and entry[0] is corpus
                    and entry[3] == digest
                ):
                    rows_dev = entry[1]
                else:
                    from jax.sharding import NamedSharding, PartitionSpec

                    rows_p = np.zeros(f_pad, dtype=np.int32)
                    rows_p[:f] = rows
                    rows_dev = jax.device_put(
                        rows_p,
                        NamedSharding(self.mesh, PartitionSpec(None)),
                    )
                    if cache_key is not None:
                        with self._lock:
                            stale = [
                                ck
                                for ck, e in self._subset_dev.items()
                                if e[0] is not corpus
                            ]
                            for ck in stale:
                                del self._subset_dev[ck]
                            while (
                                len(self._subset_dev)
                                >= _SUBSET_DEV_CACHE_MAX
                            ):
                                self._subset_dev.pop(
                                    next(iter(self._subset_dev))
                                )
                            self._subset_dev[cache_key] = (
                                corpus, rows_dev, None, digest,
                            )
                q_dev = self._put_queries(corpus, queries)
                wire = sharded_subset_topk(
                    dev[0],
                    corpus.dev_emb,
                    rows_dev,
                    jnp.int32(f),
                    q_dev,
                    k_eff,
                    mesh=self.mesh,
                    data_axis=self.data_axis,
                    dim=_mirror_dim(dev[0], corpus),
                )
                arr = np.asarray(wire)
                emb = arr[:, :k_eff].astype(np.int64)
                scores = np.ascontiguousarray(
                    arr[:, k_eff : 2 * k_eff]
                ).view(np.float32)
                return emb, scores
        host = corpus.host_f32
        if host is None:
            return None
        if b * f * corpus.dim > _SUBSET_HOST_MAX_FLOPS:
            return None
        row_map = corpus.host_row_map
        src = rows if row_map is None else row_map[rows]
        sub = host[src]  # [F, dim] f32 gather
        exact = queries @ sub.T  # [B, F] exact f32 (the returned scores)
        return _subset_select_np(exact, emb_sub, k_eff)

    # -- search ---------------------------------------------------------------

    def candidate_count(self, k: int) -> int:
        """How many candidates the device should return for a final top-k."""
        if not self.rescore:
            return k
        return max(k * CANDIDATE_MULTIPLIER, k + CANDIDATE_MIN_EXTRA)

    #: First-try successes at a hinted width before probing one ladder
    #: step narrower.  The probe's cost on a still-adversarial corpus is
    #: one widen retry (~one extra device step), so amortized overhead is
    #: ~1/(streak+1); higher values trade slower recovery of narrow-width
    #: performance for fewer probe retries.
    HINT_PROBE_STREAK = 64

    def initial_candidates(self, k: int, n_valid: int) -> int:
        """:meth:`candidate_count` with the learned per-``k`` width hint
        applied.  Corpora whose score distribution is dense near the
        boundary (e.g. iid synthetic vectors: the top-100/top-400 gap is
        the same size as the sound bf16 prescore bound) fail the rescore
        margin on most batches at the base width — each failure costing a
        full second device search.  The hint remembers the width that
        last satisfied the margin so steady state is ONE search at the
        working width.

        Hints live ON the widen ladder (base x 4^j, the exact values the
        retry loop produces) and step down one rung only after
        ``HINT_PROBE_STREAK`` consecutive first-try successes: every
        width the engine ever runs is one of a handful of recurring
        static shapes, so XLA's compile cache always hits (a
        continuously-decaying width recompiled the whole search pipeline
        EVERY batch)."""
        c = self._hinted_width(self._cand_hint, self.candidate_count(k), k)
        return min(c, n_valid) if n_valid > 0 else c

    def record_candidates(self, k: int, c_final: int, widened: bool) -> None:
        """Feed the widen loop's outcome back into the width hint."""
        self._record_width(
            self._cand_hint, self.candidate_count(k), k, c_final, widened
        )

    @staticmethod
    def pairwise_candidate_base(k: int) -> int:
        """The KB's first-attempt pairwise over-provisioning (mirror of
        :meth:`candidate_count` for the pair ladder)."""
        return max(k + 64, k * 5 // 4)

    def initial_pairwise_candidates(self, k: int, n_valid: int) -> int:
        """First-attempt pairwise candidate width with the learned
        per-``k`` hint applied — same design and rationale as
        :meth:`initial_candidates` (hints live on the ×4 widen ladder so
        every width is a recurring static shape; see that docstring).
        Flat score distributions fail the pairwise margin at the base
        width on EVERY call, each failure costing a full candidate pass
        + rescore — the hint makes steady state one pass."""
        c = self._hinted_width(
            self._pair_hint, self.pairwise_candidate_base(k), k
        )
        total = n_valid * (n_valid - 1) // 2
        return min(c, total) if total > 0 else c

    def record_pairwise_candidates(
        self, k: int, c_final: int, widened: bool
    ) -> None:
        """Feed the pairwise widen loop's outcome back into its hint."""
        self._record_width(
            self._pair_hint,
            self.pairwise_candidate_base(k),
            k,
            c_final,
            widened,
        )

    @staticmethod
    def _hinted_width(
        hints: Dict[int, Tuple[int, int]], base: int, k: int
    ) -> int:
        hint = hints.get(k)
        return base if hint is None else max(base, hint[0])

    def _record_width(
        self,
        hints: Dict[int, Tuple[int, int]],
        base: int,
        k: int,
        c_final: int,
        widened: bool,
    ) -> None:
        if widened:
            hints[k] = (c_final, 0)
            return
        hint = hints.get(k)
        if hint is None:
            return
        c_hint, streak = hint
        if streak + 1 >= self.HINT_PROBE_STREAK:
            narrower = max(base, c_hint // 4)
            if narrower <= base:
                hints.pop(k, None)
            else:
                hints[k] = (narrower, 0)
        else:
            hints[k] = (c_hint, streak + 1)

    def _fused_route(self, corpus: PackedCorpus, b: int, k: int) -> bool:
        """Whether the single-device prescore runs the fused GPU kernel
        (``ops.fused_topk.fused_route``); ``kernel='xla'`` and meshes
        always take the XLA path."""
        from ..ops.fused_topk import fused_route

        if self.kernel != "auto" or self.mesh is not None:
            return False
        dev = self.device if self.device is not None else jax.devices()[0]
        return fused_route(
            dev.platform, b, corpus.n_padded, corpus.dim_padded,
            min(k, corpus.n_valid), corpus.data.dtype,
        )

    def prescore_eps(
        self, corpus: PackedCorpus, queries: np.ndarray, k: int
    ) -> np.ndarray:
        """Per-query bound on ``|device prescore - exact f32 score|``.

        This is what turns the rescore stage from "probably exact" into
        *verified* exact: after the f32 rescore, if the k-th rescored value
        clears the lowest returned prescore by at least this bound, then no
        non-candidate document can have a true score above the k-th value —
        so the candidate set provably covered the true top-k.  Callers
        widen the candidate set and retry when the margin check fails
        (``KB.retrieve``); at C = n_valid every document is rescored, which
        is exact by construction.

        Derivation (unit-norm vectors, so ``|score| <= 1``):

        - ``bf16``: inputs are round-to-nearest bf16 (unit roundoff
          ``u = 2**-9``); both sides quantized gives
          ``|q^·d^ - q·d| <= 2u(1+u)·||q||·||d|| = 2**-8·(1+2**-9)``,
          plus small f32-accumulation cushions on both the device matmul
          and the host rescore.  This bound is deterministic (sound).
        - ``int8``: with per-row scale ``s_d`` (<= corpus ``scale_max``)
          and per-query scale ``s_q``, the error is a sum of ``d`` terms
          each bounded by half a quantization step.  The deterministic
          bound ``~0.5·(s_q + s_d)·sqrt(d)`` is hopelessly loose (rounding
          residuals never align), so we use a Hoeffding-style concentration
          bound at ``delta = 1e-15`` per (query, doc) pair — failure
          probability < 1e-9 per query at 1M docs, and a failure is not an
          error: it only means the margin check passes when it shouldn't
          have, with the miss still bounded by the deterministic bound.
        - ``f32``: accumulation-order differences only — REQUIRES every
          f32 scoring/rescore dot to run at ``Precision.HIGHEST`` (the
          default GPU precision runs f32 dots in TF32, ~3 decimal digits,
          which would swamp this bound; see ``ops.topk.f32_dot_precision``).

        Every prescore path (the fused GPU kernel and the XLA paths)
        returns the same f32 prescore up to accumulation order, so the
        bound depends on the storage precision alone, never on the
        candidate count or the kernel.
        """
        b = queries.shape[0]
        if corpus.precision == "bf16":
            eps = 2.0**-8 * (1.0 + 2.0**-9) + 3e-5
            return np.full((b,), eps, dtype=np.float64)
        if corpus.precision == "int8":
            d = corpus.dim
            s_d = corpus.scale_max
            s_q = np.max(np.abs(queries), axis=1).astype(np.float64) / 127.0
            t = np.sqrt(2.0 * np.log(2.0 / 1e-15))  # ~8.3
            eps = (
                0.5 * t * (s_q + s_d) * 1.001  # concentration terms
                + 0.25 * d * s_q * s_d  # residual x residual (deterministic)
                + 3e-5
            )
            return eps
        return np.full((b,), 1e-4, dtype=np.float64)

    def pairwise_eps(self, corpus: PackedCorpus) -> float:
        """Bound on ``|device pairwise prescore - exact f32 score|`` (both
        sides of each dot are stored vectors; int8 pairs run dequantized to
        bf16, so the error stacks the quantization residual of both rows on
        top of the bf16 term — same derivation as :meth:`prescore_eps`)."""
        bf16_term = 2.0**-8 * (1.0 + 2.0**-9) + 3e-5
        if corpus.precision == "f32":
            return 1e-4
        if corpus.precision == "bf16":
            return bf16_term
        s = corpus.scale_max
        t = float(np.sqrt(2.0 * np.log(2.0 / 1e-15)))
        return bf16_term + t * s * 1.001 + 0.25 * corpus.dim * s * s

    @_marks_inflight
    def topk(
        self, corpus: PackedCorpus, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Device prescore: top-``k`` per query against ``corpus``.

        ``corpus`` is the pack returned by :meth:`ensure_fresh` — passed
        explicitly (never re-read from the engine) so a concurrent writer
        repacking between freshness check and search can't make the caller
        finalize row indices against a different pack's ``emb_ids``.

        ``queries``: ``[d]`` or ``[B, d]`` f32 (unit-norm).  Returns
        ``(scores f32 [B, k'], rows int64 [B, k'])`` with ``k' = min(k,
        n_valid)``; ``rows`` index into ``corpus.emb_ids``.
        """
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        assert queries.shape[1] == corpus.dim, (
            f"query dim {queries.shape[1]} != corpus dim {corpus.dim}"
        )
        k_eff = min(int(k), corpus.n_valid)
        if k_eff <= 0:
            b = queries.shape[0]
            return (
                np.zeros((b, 0), dtype=np.float32),
                np.zeros((b, 0), dtype=np.int64),
            )
        from ..ops.topk import unpack_vals_idx

        holder: Dict[str, bool] = {}

        def dispatch() -> jax.Array:
            arr, w = self._prescore_packed(corpus, queries, k_eff)
            holder["wide"] = w
            return arr

        packed_np = self._fetch_hedged(
            dispatch, f"prescore:{queries.shape[0]}x{k_eff}"
        )
        vals_np, rows_np = unpack_vals_idx(
            packed_np, k_eff, wide=holder["wide"]
        )
        return vals_np, rows_np

    def _prescore_packed(
        self,
        corpus: PackedCorpus,
        queries: np.ndarray,
        k_eff: int,
        q_dev: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, bool]:
        """Dispatch the device prescore; returns the ON-DEVICE packed
        wire array (scores ++ indices) and its wire format.  Split from
        :meth:`topk` so the device-rescore stage can chain off the device
        handle without a host fetch in between.  ``q_dev`` (an already
        on-device padded f32 query array) skips the upload here — the
        rescore stage needs the same f32 queries, and without sharing the
        handle they would cross the host->device link TWICE per batch
        (1.5 MB each at B=256 d=1536).
        """
        self._await_pack_device(corpus)  # deferred cold-start packs finish uploading
        q = (
            q_dev
            if q_dev is not None
            else jnp.asarray(pad_queries(queries, corpus.dim_padded))
        )
        n_valid = corpus.n_valid_device()

        wide = corpus.n_padded >= WIDE_INDEX_MIN_ROWS
        return self._prescore_dispatch(corpus, q, n_valid, k_eff), wide

    def _prescore_dispatch(
        self, corpus: PackedCorpus, q: jax.Array, n_valid: jax.Array, k: int
    ) -> jax.Array:
        """THE prescore dispatch over device arrays (traceable: the
        choice depends only on the device, shapes and dtypes): the mesh
        path, the fused GPU kernel, or XLA's matmul + top-k — streamed
        when the score matrix would exceed the device's budget.  Every
        path returns ONE packed array ([B, k] scores ++ indices) from one
        dispatch.  Corpora below 2^24 padded rows ship indices as exact
        f32 values; larger corpora switch to the int32 wire layout (see
        ``ops.topk.pack_vals_idx``)."""
        wide = corpus.n_padded >= WIDE_INDEX_MIN_ROWS
        scales = corpus.row_scales if corpus.precision == "int8" else None
        if self.mesh is not None:
            from ..parallel.sharded import sharded_score_topk

            vals, idx = sharded_score_topk(
                corpus.data,
                corpus.row_scales,
                q,
                n_valid,
                k,
                mesh=self.mesh,
                data_axis=self.data_axis,
                model_axis=self.model_axis,
            )
            return _pack_results(vals, idx, wide=wide)
        budget = device_memory.scores_budget(self.device)
        if self._fused_route(corpus, q.shape[0], k):
            from ..ops.fused_topk import fused_topk_packed

            return fused_topk_packed(
                corpus.data, q, n_valid, k, row_scales=scales, wide=wide,
                budget=budget,
            )
        from ..ops.topk import exact_topk_packed

        return exact_topk_packed(
            corpus.data, q, n_valid, k, row_scales=scales, wide=wide,
            budget=budget,
        )

    @_marks_inflight
    def subset_pairwise_corpus(
        self,
        corpus: PackedCorpus,
        rows: np.ndarray,
        emb_sub: np.ndarray,
    ) -> Optional[PackedCorpus]:
        """A derived :class:`PackedCorpus` of ONLY the given pack rows —
        the filtered-pairwise route (``where=`` on
        ``document_top_pairwise_scores``; svs_tpu extension, the
        reference has no filtering): the unmodified verified pairwise
        loop then runs against "a corpus of just the matching
        documents", inheriting every exactness invariant (eps bound,
        margin check, widen-retry, tie rule) for free.

        The gather runs on device (``jnp.take`` over the resident pack
        — O(F·d) HBM, trivial next to the O(F²·d) pairwise FLOPs);
        padding rows are zeroed to mirror real pack semantics.  The
        host f32 cache subsets along (so rescore gathers stay
        memory-fast); without one, the finalize path's store fetch by
        emb id works unchanged.  ``None`` on mesh engines (the pack is
        sharded; the caller post-filters the exact global pair prefix
        instead) — sound either way."""
        if self.mesh is not None:
            return None
        self._await_pack_device(corpus)  # deferred cold-start packs finish uploading
        f = int(rows.size)
        f_pad = max(-(-f // ROW_MULTIPLE) * ROW_MULTIPLE, ROW_MULTIPLE)
        rows_p = np.zeros(f_pad, dtype=np.int32)
        rows_p[:f] = rows
        rows_dev = jax.device_put(rows_p, self.device)
        live = (jnp.arange(f_pad, dtype=jnp.int32) < f)[:, None]
        data = jnp.where(
            live,
            jnp.take(corpus.data, rows_dev, axis=0),
            jnp.zeros((), corpus.data.dtype),
        )
        scales = None
        if corpus.row_scales is not None:
            scales = jnp.where(
                live[:, 0],
                jnp.take(corpus.row_scales, rows_dev),
                jnp.zeros((), corpus.row_scales.dtype),
            )
        host_cache = None
        if corpus.host_f32 is not None:
            src = (
                rows
                if corpus.host_row_map is None
                else corpus.host_row_map[rows]
            )
            host_cache = (
                np.ascontiguousarray(corpus.host_f32[src]), None,
            )
        return PackedCorpus(
            data=data,
            row_scales=scales,
            emb_ids=np.asarray(emb_sub, dtype=np.int64),
            n_valid=f,
            dim=corpus.dim,
            version=corpus.version,
            precision=corpus.precision,
            scale_max=corpus.scale_max,  # upper bound: eps stays sound
            host_cache=host_cache,
        )

    @_marks_inflight
    def pairwise_topk(
        self, corpus: PackedCorpus, k: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Exact top-``k`` document pairs by similarity (strict upper
        triangle) against ``corpus`` (see :meth:`topk` for why it's an
        explicit argument).  Returns ``(scores [k'], rows_a [k'],
        rows_b [k'])`` with indices into ``corpus.emb_ids``."""
        n = corpus.n_valid
        max_pairs = n * (n - 1) // 2
        k_eff = min(int(k), max_pairs)
        if k_eff <= 0:
            empty_i = np.zeros((0,), dtype=np.int64)
            return np.zeros((0,), dtype=np.float32), empty_i, empty_i
        self._await_pack_device(corpus)  # deferred cold-start packs finish uploading

        if self.mesh is not None:
            from ..parallel.pairwise_sharded import sharded_pairwise_topk

            data = corpus.data
            if corpus.precision == "int8":
                # The sharded ring kernel is float-only; dequantize to bf16
                # (per-shard O(N/D * d) transient, acceptable on a mesh).
                data = (
                    data.astype(jnp.float32) * corpus.row_scales[:, None]
                ).astype(jnp.bfloat16)
            vals, rows, cols = sharded_pairwise_topk(
                data,
                jnp.int32(n),
                k_eff,
                mesh=self.mesh,
                data_axis=self.data_axis,
            )
        else:
            from ..ops.pairwise import pairwise_topk_blocked

            # int8 corpora run int8 x int8 blocks with on-the-fly
            # rescale — no O(N*d) dequantized copy (see
            # pairwise_topk_blocked).
            vals, rows, cols = pairwise_topk_blocked(
                corpus.data,
                jnp.int32(n),
                k_eff,
                block_rows=min(256, corpus.n_padded),
                row_scales=corpus.row_scales,
            )
        return (
            np.asarray(vals, dtype=np.float32),
            np.asarray(rows, dtype=np.int64),
            np.asarray(cols, dtype=np.int64),
        )

    @_marks_inflight
    def pairwise_rescore(
        self, corpus: PackedCorpus, rows_a: np.ndarray, rows_b: np.ndarray
    ) -> Optional[np.ndarray]:
        """Exact f32 scores for the candidate pairs ``(rows_a[i],
        rows_b[i])`` (pack-row indices), gathered and dotted on-device
        from the HBM rescore mirror when one is available — ``None``
        means no mirror (mesh shards, policy ``device_rescore='host'``,
        budget exceeded, no f32 cache yet): callers fall back to the
        host gather in ``kb._finalize_pairwise``.  Pads the pair count
        to an 8192 bucket so the widen ladder reuses compiled traces."""
        if self.mesh is not None or corpus.n_padded >= 2**31:
            return None
        self._maybe_build_device_rescore(corpus)
        if corpus.dev_rescore is None:
            return None
        dev_f32, dev_map = corpus.dev_rescore
        c = int(len(rows_a))
        if c == 0:
            return np.zeros((0,), dtype=np.float32)
        ra = np.asarray(rows_a, dtype=np.int32)
        rb = np.asarray(rows_b, dtype=np.int32)
        pad = (-c) % 8192
        if pad:
            ra = np.concatenate([ra, np.zeros((pad,), dtype=np.int32)])
            rb = np.concatenate([rb, np.zeros((pad,), dtype=np.int32)])
        out = _pairwise_rescore_from_rows(
            dev_f32,
            dev_map,
            jax.device_put(ra, self.device),
            jax.device_put(rb, self.device),
        )
        return np.asarray(out, dtype=np.float32)[:c]
