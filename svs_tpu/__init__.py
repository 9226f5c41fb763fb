"""svs_tpu — an exact vector knowledge base on JAX.

A self-describing single-file store for documents, unit-norm embedding
vectors, parent/child hierarchy, a general document graph, and a key/value
store — with exact cosine retrieval running as a fused matmul + top-k on
the accelerator (an NVIDIA GPU; the CPU for tests) via JAX/XLA/Pallas,
scaling across devices by sharding the corpus over a device mesh.

Drop-in capability parity with Rhobota/svs (the reference implementation;
see SURVEY.md): the same public API (``KB``, ``AsyncKB``, the embedding
provider factories) and the same on-disk SQLite format, so existing
``.sqlite``/``.sqlite.gz`` knowledge bases open unchanged.
"""

from .types import *  # noqa: F401,F403  (re-export the public type surface)
from .kb import KB, AsyncKB, meta_filter_predicate
from .embeddings import (
    make_embeddings_func,
    make_local_embeddings_func,
    make_mock_embeddings_func,
    make_ollama_embeddings_func,
    make_openai_embeddings_func,
)
from .version import __version__

__all__ = [
    "KB",
    "AsyncKB",
    "meta_filter_predicate",
    "make_embeddings_func",
    "make_local_embeddings_func",
    "make_mock_embeddings_func",
    "make_openai_embeddings_func",
    "make_ollama_embeddings_func",
    "__version__",
]
