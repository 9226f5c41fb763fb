"""Sidecar cold-start cache: the packed corpus persisted next to the DB.

The reference pays a full BLOB rescan on every cold open (~100 s at 1M docs,
``svs/kb.py:573-618``).  Here the packed matrix (already padded, already in
its storage dtype) is written once to ``<db>.svsx`` and mmap'd straight to
the device on the next open.  Staleness is exact: the header records the
store's ``matrix_version``; any embedding mutation bumps that counter, so a
stale sidecar is silently ignored and rebuilt.

Layout (little-endian):

    8 bytes   magic ``SVSTPUSC``
    4 bytes   u32 JSON header length L
    L bytes   JSON: {format, n_valid, dim, n_padded, dim_padded,
                      precision, matrix_version, fingerprint,
                      f32_cache, f32_row_map}
    n_valid*8 emb_ids (int64)
    [n_padded*4 row_scales (f32) — int8 precision only]
    n_padded*dim_padded*itemsize packed matrix (row-major)
    [n_valid*8 f32_row_map (int64) — when header.f32_row_map]
    [n_valid*dim*4 f32 rescore cache (row-major) — when header.f32_cache]

The trailing f32 sections (publish-time writes include them for
reduced-precision corpora) carry the exact scan bytes the pack was built
from: consumers mmap them as the rescore-gather source, so a published KB
cold-starts with ZERO store scans — no blocking matrix build AND no
background rescore-cache rebuild.  Readers ignore unknown absent
sections, so pre-cache files stay loadable.

All writes go through a ``.tmp`` + ``os.replace`` so a crash never leaves a
torn sidecar.
"""

from __future__ import annotations

import json
import logging
import os
import struct
from pathlib import Path
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple, Union

if TYPE_CHECKING:  # avoid a runtime import cycle with .packing
    from .packing import HostPack, PackedCorpus

import numpy as np
import ml_dtypes

log = logging.getLogger(__name__)

_MAGIC = b"SVSTPUSC"
_FORMAT = 1

_NP_DTYPES = {
    "f32": np.dtype("<f4"),
    "bf16": np.dtype(ml_dtypes.bfloat16),
    "int8": np.dtype(np.int8),
}


def sidecar_path_for(db_path: Union[str, Path]) -> Path:
    return Path(f"{db_path}.svsx")


def save_sidecar(
    path: Union[str, Path],
    corpus: "PackedCorpus",
    fingerprint: Optional[Sequence[int]] = None,
    host_pack: "Optional[HostPack]" = None,
) -> None:
    """Persist a :class:`~svs_tpu.engine.packing.PackedCorpus` to ``path``.

    ``fingerprint`` is the store's full ``(matrix_version, count, max_id)``
    at pack time; staleness is checked against all three so even databases
    mutated by tools that don't bump the version counter (e.g. the
    reference implementation) can never serve a stale sidecar.
    ``host_pack`` (a ``packing.HostPack``) supplies the bytes without
    reading them back from the device.
    """
    if host_pack is not None:
        # The packer's host-side bytes — avoids a device->host pull of the
        # whole matrix.
        data_np = host_pack.data
        scales_np = host_pack.row_scales
    else:
        data_np = np.asarray(corpus.data)  # device -> host, packed dtype
        scales_np = (
            np.asarray(corpus.row_scales)
            if corpus.row_scales is not None
            else None
        )
    cache = corpus.host_cache
    save_sidecar_arrays(
        path,
        n_valid=corpus.n_valid,
        dim=corpus.dim,
        precision=corpus.precision,
        matrix_version=corpus.version,
        fingerprint=fingerprint,
        emb_ids=corpus.emb_ids,
        row_scales=scales_np,
        data=data_np,
        f32_cache=cache[0] if cache is not None else None,
        f32_row_map=cache[1] if cache is not None else None,
    )


def save_sidecar_arrays(
    path: Union[str, Path],
    *,
    n_valid: int,
    dim: int,
    precision: str,
    matrix_version: int,
    fingerprint: Optional[Sequence[int]],
    emb_ids: np.ndarray,
    row_scales: Optional[np.ndarray],
    data: np.ndarray,
    f32_cache: Optional[np.ndarray] = None,
    f32_row_map: Optional[np.ndarray] = None,
) -> None:
    """Raw-array sidecar write — the device-free core of
    :func:`save_sidecar`, used directly by publish-time writes where only
    host bytes exist (``engine.write_sidecar_from_store``).

    ``f32_cache``/``f32_row_map`` (the engine's host rescore cache pair)
    append the zero-scan sections — see the module docstring.  The cache
    is skipped for f32 precision, where the pack already IS the exact
    bytes.
    """
    n_padded, dim_padded = data.shape
    if precision == "f32":
        f32_cache = f32_row_map = None
    if f32_cache is None:
        f32_row_map = None  # a map without a cache is meaningless
    header = {
        "format": _FORMAT,
        "n_valid": int(n_valid),
        "dim": int(dim),
        "n_padded": int(n_padded),
        "dim_padded": int(dim_padded),
        "precision": precision,
        "matrix_version": int(matrix_version),
        "fingerprint": list(fingerprint) if fingerprint is not None else None,
        "f32_cache": f32_cache is not None,
        "f32_row_map": f32_row_map is not None,
    }
    header_bytes = json.dumps(header).encode()
    tmp = Path(f"{path}.tmp")
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header_bytes)))
        f.write(header_bytes)
        f.write(np.asarray(emb_ids, dtype="<i8").tobytes())
        if row_scales is not None:
            f.write(np.asarray(row_scales, dtype="<f4").tobytes())
        f.write(np.ascontiguousarray(data).tobytes())
        if f32_row_map is not None:
            f.write(np.asarray(f32_row_map, dtype="<i8").tobytes())
        if f32_cache is not None:
            assert f32_cache.shape == (n_valid, dim), f32_cache.shape
            f.write(
                np.ascontiguousarray(f32_cache, dtype="<f4").tobytes()
            )
    os.replace(tmp, path)
    log.info(
        "wrote sidecar %s (%d docs, %s%s)",
        path, n_valid, precision,
        ", +f32 cache" if f32_cache is not None else "",
    )


def sidecar_fingerprint(path: Union[str, Path]) -> "Optional[List[int]]":
    """The stored fingerprint of the sidecar at ``path`` (header-only
    read), or ``None`` when missing/unreadable.  Lets publish-time writes
    skip rewriting an already-current file without mapping its data."""
    try:
        with open(path, "rb") as f:
            if f.read(8) != _MAGIC:
                return None
            (header_len,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(header_len))
    except (OSError, ValueError, json.JSONDecodeError, struct.error):
        return None
    if header.get("format") != _FORMAT:
        return None
    stored = header.get("fingerprint")
    return list(stored) if stored is not None else None


def load_sidecar(
    path: Union[str, Path],
    expected_version: Union[int, Sequence[int], None] = None,
) -> "Optional[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray, Dict[str, Any]]]":
    """Load a sidecar as memory-mapped arrays.

    Returns ``(data, row_scales, emb_ids, header)`` or ``None`` when the
    file is missing, unreadable, or stale versus ``expected_version``.
    """
    path = Path(path)
    try:
        with open(path, "rb") as f:
            if f.read(8) != _MAGIC:
                log.warning("sidecar %s: bad magic; ignoring", path)
                return None
            (header_len,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(header_len))
            base = f.tell()
    except (OSError, ValueError, json.JSONDecodeError):
        return None
    if header.get("format") != _FORMAT:
        log.warning("sidecar %s: unsupported format; ignoring", path)
        return None
    stored = header.get("fingerprint")
    if expected_version is not None:
        expected = (
            list(expected_version)
            if isinstance(expected_version, (tuple, list))
            else [expected_version]
        )
        have = stored if stored is not None else [header["matrix_version"]]
        if have[: len(expected)] != expected:
            log.info(
                "sidecar %s is stale (has %s, store at %s); rebuilding",
                path,
                have,
                expected,
            )
            return None

    dtype = _NP_DTYPES[header["precision"]]
    n_valid = header["n_valid"]
    n_padded, dim_padded = header["n_padded"], header["dim_padded"]

    offset = base
    emb_ids = np.fromfile(path, dtype="<i8", count=n_valid, offset=offset)
    offset += n_valid * 8
    row_scales = None
    if header["precision"] == "int8":
        row_scales = np.fromfile(path, dtype="<f4", count=n_padded, offset=offset)
        offset += n_padded * 4
    data_bytes = n_padded * dim_padded * dtype.itemsize
    dim = header["dim"]
    expected_bytes = offset + data_bytes
    if header.get("f32_row_map"):
        expected_bytes += n_valid * 8
    if header.get("f32_cache"):
        expected_bytes += n_valid * dim * 4
    if path.stat().st_size < expected_bytes:
        log.warning("sidecar %s: truncated; ignoring", path)
        return None
    data = np.memmap(
        path, dtype=dtype, mode="r", offset=offset, shape=(n_padded, dim_padded)
    )
    # optional zero-scan rescore-cache sections ride along in the header
    # dict (keeps the 4-tuple return stable for existing callers)
    tail = offset + data_bytes
    if header.get("f32_row_map"):
        header["_f32_row_map"] = np.fromfile(
            path, dtype="<i8", count=n_valid, offset=tail
        )
        tail += n_valid * 8
    if header.get("f32_cache"):
        header["_f32_cache"] = np.memmap(
            path, dtype="<f4", mode="r", offset=tail, shape=(n_valid, dim)
        )
    return data, row_scales, emb_ids, header
