"""Data and tensor parallelism over torch.distributed (the port of
``dmlc_core_tpu/parallel``).

One process per rank, one device per rank: ``init_process_group`` joins
the world (through the port's tracker under the launcher),
``make_mesh`` arranges the ranks into named axes with a process group
per line, and ``data_parallel_step`` runs a model's step on this rank's
rows of the global batch and its block of each parameter, with the
collectives that make it the global step (``spmd.py``).
``process_shard()`` is ``(rank, world)``, and ``process_shard(mesh)``
the ``(part, parts)`` a rank reads when it stages only its own rows.
"""

from .mesh import (
    Mesh,
    destroy_process_group,
    init_process_group,
    make_mesh,
    process_shard,
)
from .spmd import (
    P,
    Placed,
    data_parallel_step,
    place,
    place_model,
    replicate,
    shard_batch,
    shard_params,
)

__all__ = [
    "Mesh",
    "P",
    "Placed",
    "data_parallel_step",
    "destroy_process_group",
    "init_process_group",
    "make_mesh",
    "place",
    "place_model",
    "process_shard",
    "replicate",
    "shard_batch",
    "shard_params",
]
