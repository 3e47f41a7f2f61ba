"""TPU pod backend (the port of ``dmlc_core_tpu/tracker/backends/tpu_pod.py``,
whole): a ``gcloud compute tpus tpu-vm ssh`` launcher under a Supervisor
relaunch budget. It touches no TPU and imports no JAX: the JAX_* names
below are environment strings for the user's command, kept so that
``submit --dry-run`` prints what the JAX package's does.

Places one process per TPU host via ``gcloud compute tpus tpu-vm ssh``
and exports BOTH contracts:

- the DMLC env contract (DMLC_ROLE/TASK_ID/NUM_WORKER/TRACKER_URI...) so
  reference-style consumers keep working, and
- the jax.distributed contract: coordinator address + process id/count,
  so worker code can just call ``jax.distributed.initialize()``; the
  tracker's tree/ring maps are superseded by the ICI mesh for the data
  plane, while the rendezvous/recover/print loop survives for host-side
  pipeline coordination and log relay.

Worker count must equal the pod's host count (one JAX process per host).
"""

from __future__ import annotations

import logging
import subprocess
from typing import Dict, List

from ..supervisor import Supervisor, default_max_attempt
from . import format_env_exports, run_tracker_submit

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")

COORDINATOR_PORT = 8476  # jax.distributed default


def build_worker_command(
    worker_id: int,
    n_workers: int,
    command: List[str],
    envs: Dict[str, object],
    coordinator: str,
    attempt: int = 0,
) -> str:
    """The remote command string one pod host runs."""
    exports = dict(envs)
    exports.update(
        DMLC_ROLE="worker",
        DMLC_TASK_ID=worker_id,
        DMLC_JOB_CLUSTER="tpu-pod",
        DMLC_NUM_ATTEMPT=attempt,
        # jax.distributed.initialize() picks these up (or the user passes
        # them explicitly); rank == pod host index == InputSplit part.
        JAX_COORDINATOR_ADDRESS=f"{coordinator}:{COORDINATOR_PORT}",
        JAX_NUM_PROCESSES=n_workers,
        JAX_PROCESS_ID=worker_id,
    )
    return format_env_exports(exports) + " ".join(command)


def build_gcloud_ssh(
    tpu_name: str,
    zone: str,
    project: str,
    worker_id: int,
    remote_cmd: str,
) -> List[str]:
    cmd = ["gcloud", "compute", "tpus", "tpu-vm", "ssh", tpu_name]
    if zone:
        cmd += ["--zone", zone]
    if project:
        cmd += ["--project", project]
    cmd += ["--worker", str(worker_id), "--command", remote_cmd]
    return cmd


def submit(args) -> None:
    assert args.tpu_name or args.dry_run, (
        "tpu-pod cluster requires --tpu-name"
    )
    if args.num_servers:
        raise RuntimeError(
            "tpu-pod has no parameter servers; XLA collectives replace the "
            "PS data plane (drop --num-servers)"
        )

    checks: List = []

    def launch_all(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        coordinator = envs.get("DMLC_TRACKER_URI", "localhost")
        if args.dry_run:
            for i in range(nworker):
                remote = build_worker_command(
                    i, nworker, list(args.command), envs, str(coordinator)
                )
                cmd = build_gcloud_ssh(
                    args.tpu_name or "<tpu-name>",
                    args.tpu_zone,
                    args.tpu_project,
                    i,
                    remote,
                )
                print(f"[dry-run] {' '.join(cmd)}")
            return

        def launch(task_id: int, host: str, attempt: int) -> subprocess.Popen:
            remote = build_worker_command(
                task_id, nworker, list(args.command), envs,
                str(coordinator), attempt,
            )
            return subprocess.Popen(
                build_gcloud_ssh(
                    args.tpu_name, args.tpu_zone, args.tpu_project,
                    task_id, remote,
                )
            )

        # fixed placement: JAX process i must run on pod host i, so a
        # blacklisted host aborts instead of re-placing (documented
        # divergence from the YARN AM's free container placement)
        sup = Supervisor(
            launch,
            hosts=[f"pod-host-{i}" for i in range(nworker)],
            max_attempt=default_max_attempt(),
            allow_replacement=False,
        )
        checks.append(sup.run_in_thread(nworker, "tpu-pod-supervisor"))

    run_tracker_submit(
        args, launch_all, pscmd="",
        abort_check=lambda: checks[0]() if checks else None,
    )
