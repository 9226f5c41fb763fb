"""Public type surface of svs_tpu.

This module defines the data shapes and the abstract bulk-operation
interfaces of the knowledge base.  The surface intentionally mirrors the
reference implementation (Rhobota/svs ``src/svs/types.py:1-262``) so a user
of the reference can switch to this framework without changing call sites:
the same ``DocumentRecord``/``Retrieval`` dicts, the same adder/deleter
callables, and the same querier / graph / key-value interfaces, each in an
async and a sync flavor.
"""

from __future__ import annotations

import abc
from typing import (
    Any,
    AsyncIterator,
    Awaitable,
    Callable,
    Dict,
    Iterator,
    List,
    Optional,
    TYPE_CHECKING,
    Protocol,
    Tuple,
    TypedDict,
    Union,
)

if TYPE_CHECKING:
    # networkx is imported only where a graph is built (store.tx), so
    # importing the package needs nothing beyond numpy, scipy and JAX.
    import networkx as nx  # type: ignore[import-untyped]

#: An embedding function maps a batch of strings to a batch of unit-norm
#: vectors.  It is async because real providers are remote HTTP APIs.
#: (Reference: ``types.py:12``.)
EmbeddingFunc = Callable[[List[str]], Awaitable[List[List[float]]]]

DocumentId = int
EdgeId = int

if TYPE_CHECKING:
    NetworkXGraphTypes = Union[
        nx.Graph, nx.DiGraph, nx.MultiGraph, nx.MultiDiGraph
    ]
else:
    NetworkXGraphTypes = Any


class DocumentRecord(TypedDict):
    """A single document row.

    ``embedding`` is a list of floats when embeddings were requested, or a
    bool flag (does an embedding exist?) when they were not, or ``None`` when
    requested but absent.  (Reference: ``types.py:23-29``.)
    """

    id: DocumentId
    parent_id: Optional[DocumentId]
    level: int
    text: str
    embedding: Union[List[float], None, bool]
    meta: Optional[Dict[str, Any]]


class Retrieval(TypedDict):
    """One retrieval hit: cosine score plus the hydrated document."""

    score: float
    doc: DocumentRecord


#: Host-side document filter for filtered retrieval (an svs_tpu
#: extension; the reference has no filtering).  Receives the hydrated
#: record (embedding reported as a presence boolean, not the vector) and
#: returns whether the document is eligible.  Must be pure/deterministic
#: for the duration of one call: the widen ladder may evaluate it on the
#: same document more than once.
DocumentPredicate = Callable[["DocumentRecord"], bool]


class EdgeRecord(TypedDict):
    """A single graph edge row, as returned by the graph interfaces'
    ``edges()`` enumeration (an svs_tpu extension: the reference's graph
    surface, ``types.py:90-119``, can only export edges through a networkx
    view, which loses the row id :meth:`del_edge` consumes and the
    undirected flag whenever any directed edge exists)."""

    id: EdgeId
    a: DocumentId
    b: DocumentId
    relationship: DocumentId
    weight: Optional[float]
    directed: bool


# --------------------------------------------------------------------------
# Async interfaces (used by AsyncKB's bulk context managers)
# --------------------------------------------------------------------------


class AsyncDocumentAdder(Protocol):
    async def __call__(
        self,
        text: str,
        parent_id: Optional[DocumentId] = None,
        meta: Optional[Dict[str, Any]] = None,
        no_embedding: bool = False,
    ) -> DocumentId: ...


class AsyncDocumentDeleter(Protocol):
    async def __call__(self, doc_id: DocumentId) -> None: ...


class AsyncDocumentQuerier(abc.ABC):
    """Read/update documents inside a single transaction."""

    @abc.abstractmethod
    async def count(self) -> int: ...

    @abc.abstractmethod
    async def query_doc(
        self, doc_id: DocumentId, include_embedding: bool = False
    ) -> DocumentRecord: ...

    @abc.abstractmethod
    async def query_children(
        self, doc_id: DocumentId, include_embedding: bool = False
    ) -> List[DocumentRecord]: ...

    @abc.abstractmethod
    async def query_level(
        self, level: int, include_embedding: bool = False
    ) -> List[DocumentRecord]: ...

    @abc.abstractmethod
    def dfs_traversal(
        self, include_embedding: bool = False
    ) -> AsyncIterator[DocumentRecord]: ...

    @abc.abstractmethod
    async def update_doc_meta(
        self, doc_id: DocumentId, new_meta: Optional[Dict[str, Any]]
    ) -> None: ...


class AsyncGraphInterface(abc.ABC):
    """Edge CRUD over the document graph, inside a single transaction."""

    @abc.abstractmethod
    async def count_edges(self) -> int: ...

    @abc.abstractmethod
    async def add_directed_edge(
        self,
        from_doc: DocumentId,
        to_doc: DocumentId,
        relationship: DocumentId,
        weight: Optional[float] = None,
    ) -> EdgeId: ...

    @abc.abstractmethod
    async def add_edge(
        self,
        doc1: DocumentId,
        doc2: DocumentId,
        relationship: DocumentId,
        weight: Optional[float] = None,
    ) -> EdgeId: ...

    @abc.abstractmethod
    async def del_edge(self, edge_id: EdgeId) -> None: ...

    @abc.abstractmethod
    async def edges(
        self, limit: Optional[int] = None, offset: int = 0
    ) -> List[EdgeRecord]: ...

    @abc.abstractmethod
    async def build_networkx_graph(
        self, multigraph: bool = True
    ) -> NetworkXGraphTypes: ...


class AsyncKeyValueInterface(abc.ABC):
    """User key/value store, inside a single transaction."""

    @abc.abstractmethod
    async def has(self, key: str) -> bool: ...

    @abc.abstractmethod
    async def get(self, key: str, default: Any = KeyError) -> Any: ...

    @abc.abstractmethod
    async def set(self, key: str, val: Any) -> None: ...

    @abc.abstractmethod
    async def remove(self, key: str) -> None: ...

    @abc.abstractmethod
    async def count(self) -> int: ...

    @abc.abstractmethod
    def items(self) -> AsyncIterator[Tuple[str, Any]]: ...


# --------------------------------------------------------------------------
# Sync interfaces (used by KB's bulk context managers)
# --------------------------------------------------------------------------


class DocumentAdder(Protocol):
    def __call__(
        self,
        text: str,
        parent_id: Optional[DocumentId] = None,
        meta: Optional[Dict[str, Any]] = None,
        no_embedding: bool = False,
    ) -> DocumentId: ...


class DocumentDeleter(Protocol):
    def __call__(self, doc_id: DocumentId) -> None: ...


class DocumentQuerier(abc.ABC):
    @abc.abstractmethod
    def count(self) -> int: ...

    @abc.abstractmethod
    def query_doc(
        self, doc_id: DocumentId, include_embedding: bool = False
    ) -> DocumentRecord: ...

    @abc.abstractmethod
    def query_children(
        self, doc_id: DocumentId, include_embedding: bool = False
    ) -> List[DocumentRecord]: ...

    @abc.abstractmethod
    def query_level(
        self, level: int, include_embedding: bool = False
    ) -> List[DocumentRecord]: ...

    @abc.abstractmethod
    def dfs_traversal(
        self, include_embedding: bool = False
    ) -> Iterator[DocumentRecord]: ...

    @abc.abstractmethod
    def update_doc_meta(
        self, doc_id: DocumentId, new_meta: Optional[Dict[str, Any]]
    ) -> None: ...


class GraphInterface(abc.ABC):
    @abc.abstractmethod
    def count_edges(self) -> int: ...

    @abc.abstractmethod
    def add_directed_edge(
        self,
        from_doc: DocumentId,
        to_doc: DocumentId,
        relationship: DocumentId,
        weight: Optional[float] = None,
    ) -> EdgeId: ...

    @abc.abstractmethod
    def add_edge(
        self,
        doc1: DocumentId,
        doc2: DocumentId,
        relationship: DocumentId,
        weight: Optional[float] = None,
    ) -> EdgeId: ...

    @abc.abstractmethod
    def del_edge(self, edge_id: EdgeId) -> None: ...

    @abc.abstractmethod
    def edges(
        self, limit: Optional[int] = None, offset: int = 0
    ) -> List[EdgeRecord]: ...

    @abc.abstractmethod
    def build_networkx_graph(self, multigraph: bool = True) -> NetworkXGraphTypes: ...


class KeyValueInterface(abc.ABC):
    """Sync KV interface; additionally speaks the dict dunder protocol
    (``in``, ``[]``, ``del``, ``len``, iteration), mirroring the reference's
    sync-only extension (``types.py:227-262``)."""

    @abc.abstractmethod
    def has(self, key: str) -> bool: ...

    @abc.abstractmethod
    def __contains__(self, key: str) -> bool: ...

    @abc.abstractmethod
    def get(self, key: str, default: Any = KeyError) -> Any: ...

    @abc.abstractmethod
    def __getitem__(self, key: str) -> Any: ...

    @abc.abstractmethod
    def set(self, key: str, val: Any) -> None: ...

    @abc.abstractmethod
    def __setitem__(self, key: str, val: Any) -> None: ...

    @abc.abstractmethod
    def remove(self, key: str) -> None: ...

    @abc.abstractmethod
    def __delitem__(self, key: str) -> None: ...

    @abc.abstractmethod
    def count(self) -> int: ...

    @abc.abstractmethod
    def __len__(self) -> int: ...

    @abc.abstractmethod
    def items(self) -> Iterator[Tuple[str, Any]]: ...

    @abc.abstractmethod
    def __iter__(self) -> Iterator[str]: ...


__all__ = [
    "EmbeddingFunc",
    "DocumentId",
    "EdgeId",
    "NetworkXGraphTypes",
    "DocumentRecord",
    "DocumentPredicate",
    "Retrieval",
    "EdgeRecord",
    "AsyncDocumentAdder",
    "AsyncDocumentDeleter",
    "AsyncDocumentQuerier",
    "AsyncGraphInterface",
    "AsyncKeyValueInterface",
    "DocumentAdder",
    "DocumentDeleter",
    "DocumentQuerier",
    "GraphInterface",
    "KeyValueInterface",
]
