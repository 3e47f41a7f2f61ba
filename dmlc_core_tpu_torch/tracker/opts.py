"""Submission option parsing (the port of
``dmlc_core_tpu/tracker/opts.py``, whole: the same flags and defaults).

Same surface as the reference CLI (tracker/dmlc_tracker/opts.py) plus the
JAX package's ``tpu-pod`` cluster. Unknown trailing args join the
command, and ``--cluster`` falls back to $DMLC_SUBMIT_CLUSTER.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Set, Tuple

__all__ = ["get_opts", "get_memory_mb", "get_cache_file_set"]

CLUSTERS = [
    "local",
    "ssh",
    "mpi",
    "sge",
    "slurm",
    "yarn",
    "mesos",
    "kubernetes",
    "tpu-pod",
]


def _str2bool(v: str) -> bool:
    return str(v).lower() not in ("0", "false", "no", "off", "")


def get_memory_mb(mem_str: str) -> int:
    """'4g'/'512m' → MB (reference get_memory_mb, opts.py:39-57)."""
    s = mem_str.lower()
    if s.endswith("g"):
        return int(float(s[:-1]) * 1024)
    if s.endswith("m"):
        return int(float(s[:-1]))
    raise RuntimeError(
        f"Invalid memory specification {mem_str}, need a number ending in g or m"
    )


def get_cache_file_set(args) -> Tuple[Set[str], List[str]]:
    """Files referenced by the command that should ship to executors; the
    command is rewritten to use local basenames (reference
    get_cache_file_set, opts.py:6-36)."""
    fset = set(args.files)
    rewritten: List[str] = []
    if not args.auto_file_cache:
        return fset, list(args.command)
    for i, token in enumerate(args.command):
        if os.path.exists(token):
            fset.add(token)
            rewritten.append("./" + os.path.basename(token))
        else:
            rewritten.append(token)
    return fset, rewritten


def get_opts(args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="DMLC TPU job submission.")
    parser.add_argument(
        "--cluster", type=str, choices=CLUSTERS, default=None,
        help="Cluster type; defaults to $DMLC_SUBMIT_CLUSTER.",
    )
    parser.add_argument("--num-workers", required=True, type=int)
    parser.add_argument("--worker-cores", default=1, type=int)
    parser.add_argument("--worker-memory", default="1g", type=str)
    parser.add_argument("--num-servers", default=0, type=int)
    parser.add_argument("--server-cores", default=1, type=int)
    parser.add_argument("--server-memory", default="1g", type=str)
    parser.add_argument("--jobname", default=None, type=str)
    parser.add_argument("--queue", default="default", type=str)
    parser.add_argument(
        "--log-level", default="INFO", choices=["INFO", "DEBUG"], type=str
    )
    parser.add_argument("--log-file", default=None, type=str)
    parser.add_argument("--host-ip", default=None, type=str)
    parser.add_argument(
        "--host-file", default=None, type=str,
        help="File listing host[:port], for MPI and ssh.",
    )
    parser.add_argument("--sge-log-dir", default=None, type=str)
    parser.add_argument(
        "--auto-file-cache", default=True, type=_str2bool,
        help="Ship command-referenced files and rewrite them to basenames.",
    )
    parser.add_argument("--files", default=[], action="append")
    parser.add_argument("--archives", default=[], action="append")
    parser.add_argument("--env", action="append", default=[])
    parser.add_argument("--sync-dst-dir", type=str, default=None)
    parser.add_argument("--mesos-master", type=str, default=None)
    parser.add_argument("--slurm-worker-nodes", default=None, type=int)
    parser.add_argument("--slurm-server-nodes", default=None, type=int)
    parser.add_argument("--kube-namespace", default="default", type=str)
    parser.add_argument("--kube-worker-image", default="mxnet/python", type=str)
    parser.add_argument("--kube-server-image", default="mxnet/python", type=str)
    parser.add_argument("--local-num-attempt", default=0, type=int)
    # host-level shared decoded-block cache (io/blockcache.py): start
    # ONE daemon per host and point every worker at it, so colocated
    # workers over the same compressed corpus decode each block once
    parser.add_argument(
        "--block-cache", action="store_true", default=False,
        help="Start a per-host shared decoded-block cache daemon and "
             "export DMLC_BLOCK_CACHE_SOCK to the workers (local "
             "backend; other backends launch 'tools cached serve' "
             "per host themselves — docs/recordio.md).",
    )
    parser.add_argument(
        "--block-cache-mb", default=0, type=int,
        help="Daemon budget in MB (default $DMLC_BLOCK_CACHE_MB or 1024).",
    )
    # dynamic shard service (tracker/shardsvc.py, docs/sharding.md):
    # the tracker leases micro-shards to whoever is idle; these knobs
    # shape the ledger. Workers opt IN per dataset (&dynamic_shards=1 on
    # the split's URI), so the flags only set policy, they do not switch
    # sharding modes by themselves.
    parser.add_argument(
        "--shard-oversplit", default=0, type=int,
        help="Micro-shards per worker for dynamic sharding (exports "
             "DMLC_SHARD_OVERSPLIT; default 4). Higher = finer-grained "
             "work stealing, more lease round-trips.",
    )
    parser.add_argument(
        "--shard-lease-ttl", default=0.0, type=float,
        help="Seconds a shard lease survives without a renew before "
             "the tracker reclaims it (exports DMLC_SHARD_LEASE_TTL; "
             "default 30). Renewal rides worker pulls and metrics "
             "heartbeats.",
    )
    # disaggregated preprocessing tier (dmlc_core_tpu/dsserve/,
    # docs/dsserve.md): N standalone workers running fetch→decode→
    # parse→pack next to the tracker, leasing micro-shards from the
    # shard service and streaming finished packed slots to trainers
    parser.add_argument(
        "--dsserve", default=0, type=int,
        help="Start N dsserve preprocessing workers beside the tracker "
             "and export DMLC_DSSERVE=host:port,... to the workers, "
             "who read via dsserve://$DMLC_DSSERVE/<dataset-uri> "
             "(local backend; torn down with the job).",
    )
    parser.add_argument(
        "--dsserve-host", default="127.0.0.1", type=str,
        help="Bind/advertise address for the dsserve tier.",
    )
    # closed-loop elastic autoscaling (tracker/autoscale.py,
    # docs/autoscale.md): the tracker's controller thread reads the
    # windowed stall attribution and grows/shrinks the dsserve tier
    parser.add_argument(
        "--autoscale", default="", type=str, metavar="MIN:MAX",
        help="Autoscale the dsserve tier between MIN and MAX workers "
             "(exports DMLC_AUTOSCALE; default off — fixed fleet). The "
             "tracker scales up when the input-stall fraction "
             "(shard_lease_wait + dsserve_recv_wait + fetch_wait) "
             "crosses the up threshold and retires workers gracefully "
             "when the job is accelerator-bound (docs/autoscale.md). "
             "Requires time-series sampling (DMLC_TS, on by default) "
             "and MIN >= 1. --dsserve N inside the bounds sets the "
             "opening fleet.",
    )
    parser.add_argument(
        "--autoscale-cost-ceiling", default=0.0, type=float,
        metavar="WORKER_SECS",
        help="Hard elastic-tier budget in worker x seconds (exports "
             "DMLC_AUTOSCALE_COST_CEILING; 0 = unlimited). Once spent, "
             "scale-ups stop; running workers keep running.",
    )
    parser.add_argument(
        "--autoscale-dwell", default=0.0, type=float, metavar="SECS",
        help="Minimum seconds between scale actions (exports "
             "DMLC_AUTOSCALE_DWELL; default 10) — the flap damper.",
    )
    # flight-recorder tracing (telemetry/tracing.py): one trace file
    # per process of the job — workers, cache daemon, tracker — all
    # landing in one directory for `tools trace merge`
    parser.add_argument(
        "--trace-dir", default=None, type=str,
        help="Export DMLC_TRACE_DIR to every process of the job "
             "(tracker, workers, block-cache daemon): each dumps its "
             "flight-recorder rings there at exit / on SIGUSR2; join "
             "with 'python -m dmlc_core_tpu_torch.tools trace merge'.",
    )
    # durable control plane (tracker/journal.py): tracker state journal
    # + crash supervision (docs/robustness.md)
    parser.add_argument(
        "--tracker-journal", default=None, type=str, metavar="DIR",
        help="Journal tracker control-plane state (shard ledger, rank "
             "assignments, autoscale spend) to DIR and supervise the "
             "tracker as a restartable subprocess: a crashed tracker is "
             "relaunched on the same port, replays the journal, and "
             "reconnecting workers resume exactly-once (exports "
             "DMLC_TRACKER_JOURNAL; local backend only).",
    )
    # tpu-pod backend (TPU-native, no reference analogue)
    parser.add_argument(
        "--tpu-name", default=None, type=str,
        help="TPU pod/VM name for the tpu-pod cluster backend.",
    )
    parser.add_argument(
        "--tpu-zone", default=None, type=str,
        help="GCP zone of the TPU pod.",
    )
    parser.add_argument(
        "--tpu-project", default=None, type=str,
        help="GCP project of the TPU pod.",
    )
    parser.add_argument(
        "--dry-run", action="store_true", default=False,
        help="Print the launch commands instead of executing them.",
    )
    parser.add_argument("command", nargs=argparse.REMAINDER)
    parsed = parser.parse_args(args)
    if not parsed.command:
        parser.error("no command to launch")
    if parsed.command and parsed.command[0] == "--":
        parsed.command = parsed.command[1:]
    if parsed.cluster is None:
        parsed.cluster = os.getenv("DMLC_SUBMIT_CLUSTER", None)
    if parsed.cluster is None:
        raise RuntimeError(
            "--cluster is not specified; set it or $DMLC_SUBMIT_CLUSTER"
        )
    if parsed.autoscale:
        lo, sep, hi = parsed.autoscale.partition(":")
        try:
            a_min, a_max = int(lo), int(hi if sep else lo)
        except ValueError:
            parser.error(
                f"--autoscale {parsed.autoscale!r}: want MIN:MAX (e.g. 1:4)"
            )
        # MIN 0 would let the controller retire the whole tier mid-
        # epoch, ending every client stream with nothing left to dial
        if not 1 <= a_min <= a_max:
            parser.error("--autoscale needs 1 <= MIN <= MAX")
    parsed.worker_memory_mb = get_memory_mb(parsed.worker_memory)
    parsed.server_memory_mb = get_memory_mb(parsed.server_memory)
    return parsed
