"""Shared provider machinery: the unit-norm guard and cache sizing.

The whole framework relies on one invariant: *stored vectors are unit-norm*,
so cosine similarity is a plain dot product (no per-query normalization on
the hot path, and the device kernel is a pure matmul).  The guard below wraps
every embedding function at use time and rejects out-of-spec vectors
(reference: ``svs/embeddings/util.py:26-41``, tolerance at ``svs/kb.py:58``).
"""

from __future__ import annotations

import functools
import os
from typing import List

import numpy as np

from ..types import EmbeddingFunc

#: Max entries in each provider's async LRU response cache.
EMBEDDINGS_MAX_CACHE_SIZE = int(os.environ.get("EMBEDDINGS_MAX_CACHE_SIZE", 100))

#: |magnitude - 1.0| beyond this raises.  Matches the reference tolerance.
MAGNITUDE_TOLERANCE = 0.001


def wrap_embeddings_func_check_magnitude(
    embedding_func: EmbeddingFunc,
    tolerance: float = MAGNITUDE_TOLERANCE,
) -> EmbeddingFunc:
    """Wrap ``embedding_func`` to verify every returned vector is unit-norm
    (within ``tolerance``); raise ``ValueError`` otherwise."""

    @functools.wraps(embedding_func)
    async def checked(list_of_strings: List[str]) -> List[List[float]]:
        vectors = await embedding_func(list_of_strings)
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.size:
            mags = np.linalg.norm(arr, axis=1)
            if np.any(np.abs(mags - 1.0) > tolerance):
                raise ValueError("embedding magnitude out of spec")
        return vectors

    return checked
