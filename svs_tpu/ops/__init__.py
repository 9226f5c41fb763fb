"""Device compute primitives: exact cosine scoring + top-k selection.

All functions here are pure, jittable, and shape-static (``k`` and tile
sizes are Python ints; document counts are padded).  They are the single
source of the math used by the engine, the sharded path, and the fused
GPU kernel (:mod:`svs_tpu.ops.fused_topk`) — each alternative
implementation is tested for equivalence against the NumPy oracle in
:mod:`svs_tpu.utils.topk_np`.
"""

from .topk import (
    masked_topk,
    merge_topk,
    pack_vals_idx,
    score_topk,
    score_topk_fast,
    score_topk_packed,
    scores_matmul,
    streaming_score_topk,
    verified_topk,
)
from .pairwise import pairwise_topk_blocked
from .quant import (
    quantize_rows_int8,
    score_topk_int8,
    score_topk_int8_fast,
    score_topk_int8_packed,
)

__all__ = [
    "masked_topk",
    "merge_topk",
    "pack_vals_idx",
    "score_topk",
    "score_topk_fast",
    "score_topk_packed",
    "scores_matmul",
    "streaming_score_topk",
    "verified_topk",
    "pairwise_topk_blocked",
    "quantize_rows_int8",
    "score_topk_int8",
    "score_topk_int8_fast",
    "score_topk_int8_packed",
]
