"""Slurm backend (the port of ``dmlc_core_tpu/tracker/backends/slurm.py``;
reference tracker/dmlc_tracker/slurm.py).

One srun for workers and one for servers; node counts from
--slurm-worker-nodes / --slurm-server-nodes (default: one task per node,
slurm.py:38-60). Dispatchable from the CLI (the reference accepted the
option but never dispatched it — SURVEY §2.6 drift, fixed here).
"""

from __future__ import annotations

import subprocess
import threading
from typing import Dict, List

from . import run_tracker_submit


def build_srun(
    ntask: int,
    nnodes: int,
    role: str,
    command: List[str],
    envs: Dict[str, object],
) -> List[str]:
    exports = dict(envs)
    exports["DMLC_ROLE"] = role
    exports["DMLC_JOB_CLUSTER"] = "slurm"
    export_arg = "ALL," + ",".join(f"{k}={v}" for k, v in exports.items())
    return [
        "srun",
        f"--nodes={nnodes}",
        f"--ntasks={ntask}",
        f"--export={export_arg}",
    ] + list(command)


def submit(args) -> None:
    def launch_all(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        cmds = []
        if nworker:
            cmds.append(
                build_srun(
                    nworker,
                    args.slurm_worker_nodes or nworker,
                    "worker",
                    list(args.command),
                    envs,
                )
            )
        if nserver:
            cmds.append(
                build_srun(
                    nserver,
                    args.slurm_server_nodes or nserver,
                    "server",
                    list(args.command),
                    envs,
                )
            )
        for cmd in cmds:
            if args.dry_run:
                print(f"[dry-run] {' '.join(cmd)}")
                continue
            threading.Thread(
                target=subprocess.check_call, args=(cmd,), daemon=True
            ).start()

    run_tracker_submit(args, launch_all)
