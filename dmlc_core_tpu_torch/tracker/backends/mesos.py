"""Mesos backend (the port of ``dmlc_core_tpu/tracker/backends/mesos.py``;
reference tracker/dmlc_tracker/mesos.py).

Per-task launch with cpu/mem resources via ``mesos-execute`` (the
reference also supports pymesos; the CLI fallback is the portable path,
mesos.py:16-45).
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Dict, List

from . import run_tracker_submit


def build_mesos_execute(
    master: str,
    name: str,
    command: List[str],
    envs: Dict[str, object],
    role: str,
    taskid: int,
    cores: int,
    memory_mb: int,
) -> List[str]:
    env_block = {**{str(k): str(v) for k, v in envs.items()},
                 "DMLC_ROLE": role, "DMLC_TASK_ID": str(taskid),
                 "DMLC_JOB_CLUSTER": "mesos"}
    env_str = ";".join(f"{k}={v}" for k, v in sorted(env_block.items()))
    return [
        "mesos-execute",
        f"--master={master}",
        f"--name={name}",
        f"--resources=cpus:{cores};mem:{memory_mb}",
        f"--env={env_str}",
        "--command=" + " ".join(command),
    ]


def submit(args) -> None:
    master = args.mesos_master or os.getenv("MESOS_MASTER")
    if master is None and not args.dry_run:
        raise RuntimeError("mesos backend needs --mesos-master or $MESOS_MASTER")

    def launch_all(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        jobname = args.jobname or "dmlc-tpu"
        for i in range(nworker + nserver):
            role = "worker" if i < nworker else "server"
            cores = args.worker_cores if role == "worker" else args.server_cores
            mem = (
                args.worker_memory_mb
                if role == "worker"
                else args.server_memory_mb
            )
            cmd = build_mesos_execute(
                master or "<master>", f"{jobname}-{i}", list(args.command),
                envs, role, i, cores, mem,
            )
            if args.dry_run:
                print(f"[dry-run] {' '.join(cmd)}")
                continue
            threading.Thread(
                target=subprocess.check_call, args=(cmd,), daemon=True
            ).start()

    run_tracker_submit(args, launch_all)
