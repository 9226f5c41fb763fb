"""Multi-device scaling: device meshes, corpus sharding, and replication.

The reference is single-process/single-node with no distributed anything
(SURVEY.md section 2.3), so everything here is net-new design, along
two orthogonal axes:

- **Sharding** (``sharded``, ``pairwise_sharded``): the corpus splits
  row-wise across a ``jax.sharding.Mesh`` — capacity (corpora past one
  device's memory) and per-query latency.  Each device scores its shard
  and selects a local top-k; only ``k`` candidates per device cross to
  be merged — the retrieval analogue of "exchange candidates, not
  scores".
- **Replication** (``replicas``): every chip holds a full copy of a
  corpus that FITS one chip, and query batches split across them —
  throughput scales ~linearly with devices, no collectives at all.
"""

from .mesh import default_mesh, mesh_2d
from .sharded import sharded_score_topk
from .pairwise_sharded import sharded_pairwise_topk
from .replicas import ReplicaEngine
from . import multihost

__all__ = [
    "default_mesh",
    "mesh_2d",
    "sharded_score_topk",
    "sharded_pairwise_topk",
    "ReplicaEngine",
    "multihost",
]
