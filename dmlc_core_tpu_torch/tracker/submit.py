"""dmlc-submit compatible CLI (the port of
``dmlc_core_tpu/tracker/submit.py``).

``python -m dmlc_core_tpu_torch.tracker.submit --cluster local -n 2 cmd ...``
takes the same arguments as ``dmlc_core_tpu.tracker.submit``, and every
cluster dispatches (``backends.get_backend``): local, ssh, mpi, sge,
slurm, yarn, mesos, kubernetes and tpu-pod. ``--shard-oversplit``,
``--shard-lease-ttl``, ``--tracker-journal`` and ``--autoscale*``
export their env (``DMLC_SHARD_OVERSPLIT``, ``DMLC_SHARD_LEASE_TTL``,
``DMLC_TRACKER_JOURNAL``, ``DMLC_AUTOSCALE``,
``DMLC_AUTOSCALE_COST_CEILING``, ``DMLC_AUTOSCALE_DWELL``) to the
tracker and the workers.
"""

from __future__ import annotations

import logging
import os
import random
import sys
from typing import List, Optional

from . import opts
from .backends import get_backend

__all__ = ["main"]


def config_logger(args) -> None:
    fmt = "%(asctime)s %(levelname)s %(message)s"
    level = logging.DEBUG if args.log_level == "DEBUG" else logging.INFO
    if args.log_file is None:
        logging.basicConfig(format=fmt, level=level)
    else:
        logging.basicConfig(format=fmt, level=level, filename=args.log_file)
        console = logging.StreamHandler()
        console.setFormatter(logging.Formatter(fmt))
        console.setLevel(level)
        logging.getLogger("").addHandler(console)


def main(argv: Optional[List[str]] = None) -> None:
    args = opts.get_opts(argv)
    config_logger(args)
    if getattr(args, "shard_oversplit", 0):
        # env, not plumbing: the tracker reads it when its ShardService
        # pins the micro-shard count, and workers inherit it (the count
        # they use always comes from the lease answer)
        os.environ["DMLC_SHARD_OVERSPLIT"] = str(args.shard_oversplit)
    if getattr(args, "shard_lease_ttl", 0.0):
        os.environ["DMLC_SHARD_LEASE_TTL"] = str(args.shard_lease_ttl)
    if getattr(args, "autoscale", ""):
        # the tracker (this process) reads DMLC_AUTOSCALE when it starts
        # its controller thread; the backend sizes the first dsserve
        # fleet from the same bounds
        os.environ["DMLC_AUTOSCALE"] = str(args.autoscale)
        if getattr(args, "autoscale_cost_ceiling", 0.0):
            os.environ["DMLC_AUTOSCALE_COST_CEILING"] = str(
                args.autoscale_cost_ceiling)
        if getattr(args, "autoscale_dwell", 0.0):
            os.environ["DMLC_AUTOSCALE_DWELL"] = str(args.autoscale_dwell)
    if getattr(args, "tracker_journal", None):
        # the tracker (in this process, or the supervised subprocess of
        # backends/local.py) reads DMLC_TRACKER_JOURNAL when it opens its
        # control-plane journal (tracker/journal.py)
        os.makedirs(args.tracker_journal, exist_ok=True)
        os.environ["DMLC_TRACKER_JOURNAL"] = args.tracker_journal
    if getattr(args, "trace_dir", None):
        # one env export covers every process of the job: the tracker
        # (this process) and the workers inherit os.environ at launch,
        # and each dumps its flight-recorder rings into the directory
        # at exit (telemetry/tracing.py)
        os.makedirs(args.trace_dir, exist_ok=True)
        os.environ["DMLC_TRACE_DIR"] = args.trace_dir
    # one trace id for the whole job: every launched process inherits
    # it, so spans of the tracker and the workers share a trace
    os.environ.setdefault(
        "DMLC_TRACE_ID", f"{random.getrandbits(63) | 1:x}"
    )
    get_backend(args.cluster)(args)


if __name__ == "__main__":
    main(sys.argv[1:])
