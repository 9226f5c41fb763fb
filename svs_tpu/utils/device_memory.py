"""Device-memory budgets, derived from what the device reports.

Three allocations scale with the device's memory: the ``[B, N]`` f32
score matrix a materializing exact path may build, the ``[B, C, d]``
candidate gather of the on-device rescore, and the f32 rescore mirror
kept beside the pack.  Each is a fixed share of
``device.memory_stats()["bytes_limit"]`` (what this process may
allocate).  Backends that report no limit (the CPU) get the constants
the shares were drawn from: those of a 16 GB device.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax

#: Limit assumed where the backend reports none (the CPU backend).
_UNREPORTED_LIMIT = 16 * 2**30

#: Fallback values where the backend reports no limit.
_SCORES_DEFAULT = 1 << 31  # 2 GiB
_GATHER_DEFAULT = 4_000_000_000
_MIRROR_DEFAULT = 8_000_000_000


@functools.lru_cache(maxsize=None)
def bytes_limit(device: Optional[jax.Device] = None) -> Optional[int]:
    """``memory_stats()["bytes_limit"]`` of ``device`` (default: the
    first device), or ``None`` where the backend reports nothing."""
    dev = device if device is not None else jax.devices()[0]
    try:
        stats = dev.memory_stats()
    except (NotImplementedError, RuntimeError):
        return None
    if not stats or not stats.get("bytes_limit"):
        return None
    return int(stats["bytes_limit"])


def _share(default: int, device: Optional[jax.Device]) -> int:
    limit = bytes_limit(device)
    if limit is None:
        return default
    return int(limit * (default / _UNREPORTED_LIMIT))


def scores_budget(device: Optional[jax.Device] = None) -> int:
    """Ceiling on the f32 score matrix a materializing exact path may
    allocate in-graph (``lax.cond`` branches allocate even untaken);
    past it the exact path streams row blocks."""
    return _share(_SCORES_DEFAULT, device)


def gather_budget(device: Optional[jax.Device] = None) -> int:
    """Ceiling on the on-device rescore's ``[B, C, d]`` f32 candidate
    gather; wider widen retries rescore on the host instead."""
    return _share(_GATHER_DEFAULT, device)


def mirror_budget(device: Optional[jax.Device] = None) -> int:
    """Default ceiling on the f32 rescore mirror kept on the device."""
    return _share(_MIRROR_DEFAULT, device)
