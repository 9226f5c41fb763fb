"""Multi-host scaling helpers.

A corpus that outgrows one host's chips shards across a multi-host
deployment the same way it shards across a slice: the mesh just spans all
hosts' devices.  XLA lowers the collectives to the interconnect within
a host and the network across hosts; the retrieval design (only ``k``
candidates leave each device) keeps cross-host traffic tiny.

Typical serving worker:

    from svs_tpu.parallel import multihost
    mesh = multihost.initialize(coordinator="host0:1234",
                                num_processes=4, process_id=RANK)
    kb = KB("corpus.sqlite", embed_fn, mesh=mesh)

Every process must open the same database file (e.g. on shared storage or
replicated locally); each packs and uploads only its own shard rows
(``jax.device_put`` with a NamedSharding places per-device data from the
local host).
"""

from __future__ import annotations

from typing import Optional

import jax

from .mesh import default_mesh


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    data_axis: str = "data",
) -> jax.sharding.Mesh:
    """Initialize ``jax.distributed`` (no-op when single-process) and return
    a 1-D mesh over every device of every host."""
    if coordinator is None and (
        num_processes is not None or process_id is not None
    ):
        raise ValueError(
            "num_processes/process_id were given without a coordinator "
            "address — jax.distributed would never initialize and this "
            "process would silently build a LOCAL-only mesh (wrong "
            "topology, discovered only via wrong results or OOM)"
        )
    if coordinator is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    return default_mesh(data_axis=data_axis)
