"""Distributed launcher: the rank rendezvous tracker, the local backend
and the fault-tolerant collective engine (the port of
``dmlc_core_tpu/tracker/``).

Numpy, sockets and subprocesses only: no module here imports torch. The
wire protocols (the rabit rendezvous, magic 0xff99, and the collective's
peer frames) are the JAX package's, so port workers rendezvous under a
JAX tracker and the reverse, and port and JAX engines share rounds.

Ported: ``protocol``, ``topology``, ``supervisor``, ``client``
(``RabitWorker``), ``tracker`` (``RabitTracker``, ``PSTracker``,
``submit``), ``collective``, ``shardsvc`` (the dynamic shard service and
``ShardLeaseClient``), ``journal`` (the control-plane journal behind the
supervised tracker), ``opts``, ``launcher``, ``submit``, the ``local``
backend with ``TrackerSupervisor``, the dsserve tier (``DsServeTier``,
``--dsserve``) and its ``ElasticActuator``, ``autoscale`` (the
controller that scales that tier, ``--autoscale``), the cluster backends
``ssh``, ``mpi``, ``sge``, ``slurm``, ``yarn``, ``mesos``, ``kubernetes``
and ``tpu-pod``, and ``yarn_am`` (the YARN application master).
"""

from .topology import get_link_map, get_ring, get_tree
from .tracker import PSTracker, RabitTracker, submit, worker_env

__all__ = [
    "RabitTracker",
    "PSTracker",
    "submit",
    "worker_env",
    "get_tree",
    "get_ring",
    "get_link_map",
]
