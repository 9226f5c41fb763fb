"""The device retrieval engine.

Where the reference keeps a lazily-built NumPy matrix in RAM
(``svs/kb.py:856-893``) and dots against it on the CPU, this engine keeps
the corpus **on device**: packed (padded, tile-aligned, bf16/f32/int8) and
HBM-resident, with retrieval running as a jitted matmul + masked top-k.
Derived state is keyed by the store's ``matrix_version`` counter, and can be
persisted as a *sidecar* file next to the database for mmap-fast cold starts
instead of the reference's full BLOB rescan.
"""

from .packing import PackedCorpus, pack_corpus, pad_matrix
from .index import RetrievalEngine
from .sidecar import load_sidecar, save_sidecar, sidecar_path_for

__all__ = [
    "PackedCorpus",
    "pack_corpus",
    "pad_matrix",
    "RetrievalEngine",
    "save_sidecar",
    "load_sidecar",
    "sidecar_path_for",
]
