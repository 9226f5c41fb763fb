"""Corpus packing: host float32 matrix -> device-resident search layout.

Padding rules (all static so every downstream kernel sees tile-aligned
shapes):

- rows padded up to a multiple of ``row_multiple`` (default 256, and the
  engine additionally rounds to the mesh size when sharding) with zero
  vectors — masked out of every search by ``n_valid``;
- the embedding dim padded up to a multiple of 128 (kernel tile widths)
  with zero columns — mathematically inert for dot products.

Precision modes:

- ``'f32'``  — full precision storage;
- ``'bf16'`` — half the HBM traffic; f32 accumulation keeps scores tight,
  and the engine's rescore stage restores exact f32 ordering;
- ``'int8'`` — quarter traffic via per-row symmetric quantization
  (:mod:`svs_tpu.ops.quant`), prescore-only, always rescored.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

ROW_MULTIPLE = 256
DIM_MULTIPLE = 128
#: Large corpora pad (and the engine aligns) to a coarse multiple: whole
#: fused-kernel tiles (``ops.fused_topk.BLOCK_N``) on every mesh shard,
#: and fewer buffer regrows as appends arrive.
LARGE_ROW_MULTIPLE = 16384
#: At this size rows are also shuffled at pack time: the fused kernel's
#: per-tile selection needs top-k hits spread across tiles, and real
#: corpora cluster near-duplicates in insertion order (bulk-added crawls,
#: sorted dumps).  A seeded permutation makes per-subtile top-k occupancy
#: binomial regardless of insertion order; the row->doc mapping already
#: flows through emb_ids, so correctness is untouched.
PERMUTE_MIN_ROWS = LARGE_ROW_MULTIPLE
_PERMUTE_SEED = 0xC0FFEE

Precision = str  # 'f32' | 'bf16' | 'int8'

#: Keep the f32 scan matrix on the host (rescore gather source) up to this
#: many bytes; beyond it, rescore falls back to store fetches.  The default
#: (16 GB ~ 2.6M docs at dim 1536) mirrors the reference's own footprint —
#: its only mode IS a host-RAM f32 matrix (``svs/kb.py:856-893``).
_RESCORE_CACHE_DEFAULT = 16_000_000_000


def rescore_cache_limit() -> int:
    from ..utils.env import env_int

    return env_int("SVS_TPU_RESCORE_CACHE_MAX_BYTES", _RESCORE_CACHE_DEFAULT)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


#: Staged-upload granularity (and the threshold above which mmap-backed
#: sources are staged at all) — see :func:`staged_device_put`.  64 MB:
#: big enough to amortize per-transfer overhead, small enough that a
#: query arriving mid-chunk waits well under a second at healthy link
#: rates (and the background uploader yields between chunks).
STAGE_CHUNK_BYTES = 64 * 1024 * 1024


def _is_mmap_backed(a: np.ndarray) -> bool:
    """True when ``a`` is (a view chain over) a ``np.memmap``."""
    seen: object = a
    while isinstance(seen, np.ndarray):
        if isinstance(seen, np.memmap):
            return True
        seen = seen.base
    return False


def staged_device_put(
    host: np.ndarray,
    device: Optional[jax.Device],
    chunk_bytes: Optional[int] = None,
    throttle: Optional["Callable[[], None]"] = None,
) -> jax.Array:
    """``device_put`` a 2-D host array via ~256 MB in-RAM staging chunks.

    ``device_put`` straight from a sidecar ``np.memmap`` interleaves 4 KiB
    page faults with link writes — measured ~12 MB/s over a slow link vs
    ~470 MB/s from RAM (a 40x cliff).  Copying each chunk into RAM first
    keeps the disk read
    sequential (readahead-friendly) and the link at full rate, and the
    donated row-writer keeps peak HBM at one array plus one chunk.
    Chunking also bounds how long a concurrent query stalls behind a
    background upload (one chunk, not the whole array); background
    callers pass ``throttle`` (called before each chunk) to yield the
    link to live queries entirely.
    """
    chunk = STAGE_CHUNK_BYTES if chunk_bytes is None else chunk_bytes
    n = host.shape[0]
    row_bytes = max(1, host.nbytes // max(1, n))
    rows = max(1, chunk // row_bytes)
    if n <= rows or host.ndim != 2:
        return jax.device_put(np.array(host, copy=True), device)
    with jax.default_device(device):
        buf = jnp.zeros(host.shape, dtype=host.dtype)
    writer = _row_writer_donated()
    for lo in range(0, n, rows):
        if throttle is not None:
            throttle()
        hi = min(n, lo + rows)
        piece = jax.device_put(np.array(host[lo:hi], copy=True), device)
        buf = writer(buf, piece, jnp.int32(lo))
        if throttle is not None:
            # One chunk fully lands before the next queues: an unbounded
            # dispatch queue would monopolize the link regardless of any
            # yielding above.
            buf.block_until_ready()
    return buf


_ROW_WRITER = None


def _row_writer_donated() -> "Callable[[jax.Array, jax.Array, jax.Array], jax.Array]":
    """Jitted in-place row write (buffer donated), built lazily so module
    import never touches the JAX backend."""
    global _ROW_WRITER
    if _ROW_WRITER is None:
        def write(buf: jax.Array, new: jax.Array, n0: jax.Array) -> jax.Array:
            start = (n0,) + (0,) * (buf.ndim - 1)
            return jax.lax.dynamic_update_slice(buf, new, start)

        _ROW_WRITER = jax.jit(write, donate_argnums=(0,))
    return _ROW_WRITER


def _put(
    host: np.ndarray,
    placement: Union[jax.Device, jax.sharding.Sharding, None],
) -> jax.Array:
    """Place a host array on device(s).

    For a Sharding this uses ``make_array_from_callback`` — each process
    materializes ONLY its addressable shards from the host copy, which (a)
    never bounces the full array through one device and (b) is the
    multi-host path: every host opens the same store, builds the same host
    matrix, and uploads just its own rows (``parallel.multihost``).

    Single-device placements of large mmap-backed sources (sidecar loads)
    go through :func:`staged_device_put` — see the 40x cliff there.
    """
    if isinstance(placement, jax.sharding.Sharding):
        return jax.make_array_from_callback(
            host.shape, placement, lambda idx: np.array(host[idx], copy=True)
        )
    if (
        host.ndim == 2
        and host.nbytes > STAGE_CHUNK_BYTES
        and _is_mmap_backed(host)
    ):
        return staged_device_put(host, placement)
    return jax.device_put(jnp.asarray(host), placement)


def pad_matrix(
    matrix: np.ndarray,
    row_multiple: int = ROW_MULTIPLE,
    dim_multiple: int = DIM_MULTIPLE,
) -> np.ndarray:
    """Zero-pad an ``[n, d]`` f32 matrix to tile-aligned shape."""
    n, d = matrix.shape
    n_pad = max(_round_up(n, row_multiple), row_multiple)
    d_pad = max(_round_up(d, dim_multiple), dim_multiple)
    if (n_pad, d_pad) == (n, d):
        return np.ascontiguousarray(matrix, dtype=np.float32)
    out = np.zeros((n_pad, d_pad), dtype=np.float32)
    out[:n, :d] = matrix
    return out


def pad_queries(queries: np.ndarray, dim_padded: int) -> np.ndarray:
    """Zero-pad query vectors ``[B, d]`` to the corpus's padded dim."""
    b, d = queries.shape
    if d == dim_padded:
        return np.ascontiguousarray(queries, dtype=np.float32)
    out = np.zeros((b, dim_padded), dtype=np.float32)
    out[:, :d] = queries
    return out


@dataclasses.dataclass(frozen=True)
class HostPack:
    """Host-side copies of the packed arrays (for sidecar writes)."""

    data: np.ndarray
    row_scales: Optional[np.ndarray]


@dataclasses.dataclass(frozen=True)
class PackedCorpus:
    """Device-resident packed corpus plus host-side id mapping."""

    data: jax.Array  # [n_padded, dim_padded]; f32 / bf16 / int8
    row_scales: Optional[jax.Array]  # [n_padded] f32, int8 mode only
    emb_ids: np.ndarray  # [n_valid] int64: matrix row -> embeddings.id
    n_valid: int
    dim: int  # true (unpadded) embedding dim
    version: int  # store matrix_version this pack reflects
    precision: Precision
    #: Largest per-row quantization scale (int8 only; 0.0 otherwise) — input
    #: to the engine's sound prescore-error bound for rescore verification.
    scale_max: float = 0.0
    #: Host f32 rows in pack order (``[n_valid, dim]``, the exact bytes the
    #: pack was built from) — the rescore stage's gather source.  A batched
    #: rescore touches ~100k rows (256 queries x 400 candidates); fetching
    #: them from SQLite measured 4-6 s vs 0.4-0.9 s from this array, and
    #: the array is snapshot-consistent with the pack by construction
    #: (store rows may have changed since).  ``None`` when the pack came
    #: from a sidecar (no f32 scan happened) or exceeded
    #: ``SVS_TPU_RESCORE_CACHE_MAX_BYTES`` — rescore then falls back to
    #: store fetches.
    #: Published as ONE atomically-assigned ``(host_f32, host_row_map)``
    #: tuple so the background rescore-cache rebuild can attach it to a
    #: live corpus with a single store — readers (``_finalize_batch``,
    #: pairwise) can never observe a torn pair, GIL or no GIL.  The
    #: second element is the pack-row -> ``host_f32``-row map (``None`` =
    #: identity: the cache is in pack order; set when the fused native
    #: pack kept the scan matrix unpermuted instead of paying a
    #: full-matrix gather copy).
    host_cache: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = (
        dataclasses.field(default=None, repr=False, compare=False)
    )
    #: Device mirror of the f32 rescore cache, published as ONE
    #: ``(dev_f32, dev_row_map int32 | None)`` tuple (same atomic-publish
    #: rule as ``host_cache``).  ``dev_f32`` is either a true-dim
    #: ``[n_valid, dim]`` upload of the host cache (bf16/int8) or, for
    #: f32 corpora, the ``[n_padded, dim_padded]`` pack itself reused as
    #: the gather source (its zero padding columns are exact against the
    #: zero-padded queries; see ``index._mirror_dim``).  When present,
    #: the rescore stage runs on-device: gather candidate rows from HBM
    #: + f32 dot —
    #: the host never touches the ~O(B*C*d) candidate bytes (measured
    #: 630 MB per 256-query batch at 1M x 1536, the end-to-end
    #: bottleneck on small hosts).  Built by the engine when policy
    #: allows (single chip, rescore on, fits the HBM budget).
    dev_rescore: Optional[Tuple[jax.Array, Optional[jax.Array]]] = (
        dataclasses.field(default=None, repr=False, compare=False)
    )
    #: Device mirror of ``emb_ids`` as int32 in pack-row order (absent
    #: when any id exceeds int32 — the engine then finishes on the host).
    #: With BOTH mirrors present the engine runs the entire
    #: search->rescore->final-top-k selection on-device and fetches a
    #: ``[B, 2k+1]`` wire (k = the user's n) instead of ``[B, 2C+1]``
    #: (C = candidates, 4x k) — a quarter of the fetch bytes, and the
    #: host drops its [B, C] argsorts too.
    dev_emb: Optional[jax.Array] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # lazily-cached device copy of n_valid (one upload per pack, not
    # one per query)
    _n_valid_dev: Optional[jax.Array] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # memoized max(emb_ids) for :meth:`emb_ids_fit_int32` (the scan is
    # O(n_valid) — never pay it per query on an engine hot path)
    _emb_ids_max: Optional[int] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # memoized (sorted emb ids, argsort order) for
    # :meth:`rows_for_emb_ids` — incremental deletes backfill holes with
    # tail rows, so ``emb_ids`` is NOT sorted in general and the inverse
    # mapping needs one O(n log n) sort, paid once per pack
    _emb_sort: Optional[Tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    #: Deferred-upload gate: ``None`` = the pack was born on device; an
    #: Event = ``data``/``row_scales`` are HOST arrays until a background
    #: upload publishes the device copies and sets it
    #: (``RetrievalEngine._spawn_pack_upload``).  While unset, queries
    #: answer exactly from the host f32 cache (``host_route``) — cold
    #: start is bounded by the host scan, not the multi-GB upload.
    _device_ready: Optional[threading.Event] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    #: Host int8 prescore arrays ``(docs_i8, scales, row_sums)`` in
    #: HOST-CACHE row order — first pass of the host two-pass search
    #: (``RetrievalEngine.host_topk_exact``).  Derived lazily from
    #: ``host_cache`` (one atomic attach, like the cache itself);
    #: snapshot-consistent by construction since both live on this
    #: immutable pack object.
    host_i8: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = (
        dataclasses.field(default=None, repr=False, compare=False)
    )
    #: Replica-mode clones of this pack on other devices (one per
    #: secondary device, set by ``parallel.replicas.ReplicaEngine``).
    #: Attached to the CORPUS — not to engine state — so an in-flight
    #: search holding this snapshot keeps exactly its clones even if a
    #: concurrent store write re-packs and re-clones (same snapshot
    #: contract as the single-chip engine: the caller's corpus object is
    #: authoritative for the whole search).
    replica_clones: Optional[Tuple["PackedCorpus", ...]] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def device_ready(self) -> bool:
        """Whether ``data``/``row_scales`` are live device arrays (True
        for every non-deferred pack)."""
        ev = self._device_ready
        return ev is None or ev.is_set()

    def wait_device(self, timeout: Optional[float] = None) -> bool:
        """Block until the background pack upload publishes the device
        arrays; device-path entry points call this so a query that needs
        the device (big batch, pairwise) waits instead of touching host
        arrays."""
        ev = self._device_ready
        return True if ev is None else bool(ev.wait(timeout))

    def publish_device(
        self,
        data: "Union[jax.Array, np.ndarray]",
        row_scales: "Optional[Union[jax.Array, np.ndarray]]",
    ) -> None:
        """Swap the host arrays for their device copies and release
        waiters (called exactly once, by the engine's uploader thread)."""
        object.__setattr__(self, "data", data)
        object.__setattr__(self, "row_scales", row_scales)
        ev = self._device_ready
        if ev is not None:
            ev.set()

    @property
    def host_f32(self) -> Optional[np.ndarray]:
        cache = self.host_cache
        return cache[0] if cache is not None else None

    @property
    def host_row_map(self) -> Optional[np.ndarray]:
        cache = self.host_cache
        return cache[1] if cache is not None else None

    def rows_for_emb_ids(
        self, ids: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Inverse of ``emb_ids``: pack rows holding the given embedding
        ids, as ``(rows int64, present bool)`` aligned with ``ids`` —
        ``rows`` is meaningful only where ``present`` (ids the pack
        snapshot doesn't hold map to row 0, masked off).  The sorted
        order is memoized per pack (same pattern as ``_emb_ids_max``)."""
        if self._emb_sort is None:
            order = np.argsort(self.emb_ids, kind="stable")
            object.__setattr__(
                self, "_emb_sort", (self.emb_ids[order], order)
            )
        sorted_ids, order = self._emb_sort  # type: ignore[misc]
        ids = np.asarray(ids, dtype=np.int64)
        pos = np.searchsorted(sorted_ids, ids)
        pos_c = np.minimum(pos, len(sorted_ids) - 1) if len(
            sorted_ids
        ) else np.zeros_like(pos)
        present = (
            (sorted_ids[pos_c] == ids) if len(sorted_ids) else
            np.zeros(len(ids), dtype=bool)
        )
        rows = np.where(present, order[pos_c], 0).astype(np.int64)
        return rows, present

    def emb_ids_fit_int32(self) -> bool:
        """Whether every emb id fits the int32 device mirror (the
        final-selection wire).  Ids past int32 are ~impossible for SQLite
        rowids in practice; when seen, the engine finishes on the host."""
        if self._emb_ids_max is None:
            mx = int(self.emb_ids.max()) if self.n_valid > 0 else 0
            object.__setattr__(self, "_emb_ids_max", mx)
        return self._emb_ids_max < 2**31  # type: ignore[operator]

    def n_valid_device(self) -> jax.Array:
        if self._n_valid_dev is None:
            object.__setattr__(self, "_n_valid_dev", jnp.int32(self.n_valid))
        return self._n_valid_dev  # type: ignore[return-value]

    @property
    def n_padded(self) -> int:
        return self.data.shape[0]

    @property
    def dim_padded(self) -> int:
        return self.data.shape[1]

    def nbytes_device(self) -> int:
        n = self.data.size * self.data.dtype.itemsize
        if self.row_scales is not None:
            n += self.row_scales.size * self.row_scales.dtype.itemsize
        return n


def pack_host(
    matrix: np.ndarray,
    emb_ids: np.ndarray,
    precision: Precision,
    row_multiple: int = ROW_MULTIPLE,
    dim_multiple: int = DIM_MULTIPLE,
) -> Tuple[
    np.ndarray,
    Optional[np.ndarray],
    np.ndarray,
    np.ndarray,
    Optional[np.ndarray],
    int,
    int,
]:
    """Permute + pad + cast/quantize on the HOST only — no device touch.

    The shared front half of :func:`pack_corpus`, also used standalone by
    publish-time sidecar writes (``close()`` leaves a ``.svsx`` behind
    without paying a device upload).  Returns ``(host_data, host_scales,
    emb_ids, cache_f32, host_row_map, n, d)`` where ``cache_f32`` is the
    f32 matrix aligned with the rescore-cache layout (pack order when the
    fallback path permuted it, scan order + ``host_row_map`` when the
    fused native pack kept it unpermuted).
    """
    assert matrix.ndim == 2
    n, d = matrix.shape
    if precision not in ("f32", "bf16", "int8"):
        raise ValueError(f"unknown precision: {precision!r}")
    emb_ids = np.asarray(emb_ids, dtype=np.int64)
    perm = None
    if n >= PERMUTE_MIN_ROWS:
        perm = np.random.default_rng(_PERMUTE_SEED).permutation(n)
        emb_ids = emb_ids[perm]
    n_pad = max(_round_up(n, row_multiple), row_multiple)
    d_pad = max(_round_up(d, dim_multiple), dim_multiple)

    # Fused native pack: permute + pad + cast/quantize in ONE multithreaded
    # pass (the separate gather/pad/cast passes measured 84 s at 1M x 1536;
    # bit-identical to the step-by-step path, covered by tests).  Host f32
    # stays UNPERMUTED in that case — the rescore cache maps pack rows
    # through ``host_row_map`` instead of paying a 6 GB gather copy.
    from ..native import permute_cast_pack

    host_row_map = None
    fused = permute_cast_pack(
        matrix,
        perm if perm is not None else np.arange(n, dtype=np.int64),
        precision,
        n_pad,
        d_pad,
    )
    if fused is not None:
        host_data, host_scales = fused
        host_row_map = perm  # None = cache already in pack order
    else:
        if perm is not None:
            matrix = matrix[perm]
        padded = pad_matrix(
            matrix, row_multiple=row_multiple, dim_multiple=dim_multiple
        )
        if precision == "int8":
            from ..native import quantize_int8

            # Host-side quantization (bit-identical to the device
            # quantizer) so only int8 bytes cross host->device, and
            # sharded placements never bounce through a single device.
            host_data, host_scales = quantize_int8(padded)
        elif precision == "bf16":
            from ..native import f32_to_bf16

            # Host-side RNE cast halves the host->device transfer.
            host_data, host_scales = f32_to_bf16(padded), None
        else:
            host_data, host_scales = padded, None
    return host_data, host_scales, emb_ids, matrix, host_row_map, n, d


#: Packs at/above this many device bytes may defer their upload to a
#: background thread (``pack_corpus(defer_upload=True)``): the corpus
#: publishes immediately with HOST arrays + an unset ``_device_ready``
#: event, queries answer exactly from the host f32 cache meanwhile, and
#: the engine's uploader swaps in the device copies.  Below it the
#: upload is cheaper than the machinery.
DEFER_MIN_BYTES = STAGE_CHUNK_BYTES


def pack_corpus(
    matrix: np.ndarray,
    emb_ids: np.ndarray,
    version: int,
    precision: Precision = "bf16",
    placement: Union[jax.Device, jax.sharding.Sharding, None] = None,
    row_multiple: int = ROW_MULTIPLE,
    dim_multiple: int = DIM_MULTIPLE,
    keep_host: bool = False,
    defer_upload: bool = False,
) -> "Union[PackedCorpus, Tuple[PackedCorpus, HostPack]]":
    """Pack a host f32 ``[n, d]`` matrix for device search.

    ``placement`` may be a device (single chip), a Sharding (corpus split
    over a mesh), or ``None`` (JAX default device).  With ``keep_host``,
    also return the host-side packed arrays (same bytes that went to the
    device) so a sidecar write never has to pull them back off the device
    — a multi-GB device->host read.

    ``defer_upload`` (single-device placements, packs past
    ``DEFER_MIN_BYTES``, host f32 cache retained): skip the device
    upload entirely — ``data``/``row_scales`` hold the HOST pack and
    ``_device_ready`` is an unset event.  The caller owns getting the
    bytes to the device (``RetrievalEngine._spawn_pack_upload``) and
    publishing via :meth:`PackedCorpus.publish_device`; until then the
    engine answers queries from the host cache, so a cold first query
    costs one host scan instead of waiting out a multi-GB upload.
    """
    (
        host_data,
        host_scales,
        emb_ids,
        matrix,
        host_row_map,
        n,
        d,
    ) = pack_host(
        matrix,
        emb_ids,
        precision,
        row_multiple=row_multiple,
        dim_multiple=dim_multiple,
    )
    keep_cache = matrix.nbytes <= rescore_cache_limit()
    defer = (
        defer_upload
        and not isinstance(placement, jax.sharding.Sharding)
        and host_data.nbytes >= DEFER_MIN_BYTES
        and keep_cache  # no host cache -> nothing to answer from; upload now
    )
    if defer:
        data: "jax.Array" = host_data  # type: ignore[assignment]
        row_scales = host_scales  # type: ignore[assignment]
        ready: Optional[threading.Event] = threading.Event()
    else:
        data = _put(host_data, placement)
        row_scales = (
            _put(host_scales, _scales_placement(placement))
            if host_scales is not None
            else None
        )
        ready = None

    corpus = PackedCorpus(
        data=data,
        row_scales=row_scales,
        emb_ids=np.asarray(emb_ids, dtype=np.int64),
        n_valid=n,
        dim=d,
        version=version,
        precision=precision,
        scale_max=float(host_scales[:n].max()) if (
            host_scales is not None and n > 0
        ) else 0.0,
        # the scan matrix is already in hand — keeping it costs no copy,
        # just residency
        host_cache=(
            (np.asarray(matrix, dtype=np.float32), host_row_map)
            if keep_cache
            else None
        ),
        _device_ready=ready,
    )
    if keep_host:
        return corpus, HostPack(data=host_data, row_scales=host_scales)
    return corpus


def _scales_placement(
    placement: Union[jax.Device, jax.sharding.Sharding, None],
) -> Union[jax.Device, jax.sharding.Sharding, None]:
    """Row scales shard like the corpus's row axis (1-D)."""
    if isinstance(placement, jax.sharding.NamedSharding):
        row_axis = placement.spec[0] if len(placement.spec) else None
        return jax.sharding.NamedSharding(
            placement.mesh, jax.sharding.PartitionSpec(row_axis)
        )
    return placement
