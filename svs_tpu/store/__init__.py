"""Single-file SQLite storage engine.

The on-disk format is byte-compatible with the reference implementation
(Rhobota/svs schema v1, ``svs/kb.py:64-113``): the same five tables
(``keyval``, ``keyval_user``, ``embeddings``, ``docs``, ``edges``), the same
internal keys (``schema_version``, ``created_datetime``,
``embedding_func_params``), and the same little-endian float32 embedding
BLOBs — so an existing ``.sqlite``/``.sqlite.gz`` artifact published by the
reference opens here unchanged, and vice versa.

What is new relative to the reference is the ``matrix_version`` counter
(see :meth:`Tx.bump_matrix_version`): a monotonically increasing integer in
the internal keyval table, bumped inside any transaction that mutates
embeddings.  The retrieval engine and the sidecar cold-start cache key their
derived state off it, replacing the reference's blunt invalidate-everything
scheme (``svs/kb.py:856-893``) with cheap staleness checks.
"""

from .blob import embedding_from_bytes, embedding_to_bytes, matrix_from_blob_rows
from .db import Database, SCHEMA_VERSION
from .tx import Tx

__all__ = [
    "Database",
    "Tx",
    "SCHEMA_VERSION",
    "embedding_to_bytes",
    "embedding_from_bytes",
    "matrix_from_blob_rows",
]
