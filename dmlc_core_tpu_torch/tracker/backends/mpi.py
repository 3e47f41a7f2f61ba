"""MPI backend (the port of ``dmlc_core_tpu/tracker/backends/mpi.py``;
reference tracker/dmlc_tracker/mpi.py).

mpirun is used ONLY as a process launcher (SURVEY §2.9: never for
collectives): one mpirun for workers, one for servers, with env passed
via -x (OpenMPI) or -env (MPICH), detected from ``mpirun --version``
(mpi.py:12-36,55-77).
"""

from __future__ import annotations

import logging
import subprocess
import threading
from typing import Dict, List, Optional

from . import run_tracker_submit

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")


def detect_mpi_flavor() -> str:
    """'openmpi' | 'mpich' (reference get_mpi_env, mpi.py:12-36)."""
    try:
        out = subprocess.run(
            ["mpirun", "--version"], capture_output=True, text=True, timeout=10
        ).stdout.lower()
    except (OSError, subprocess.TimeoutExpired):
        return "openmpi"
    return "mpich" if ("mpich" in out or "hydra" in out) else "openmpi"


def build_mpirun(
    n: int,
    role: str,
    command: List[str],
    envs: Dict[str, object],
    flavor: str,
    host_file: Optional[str] = None,
) -> List[str]:
    cmd = ["mpirun", "-n", str(n)]
    if host_file:
        cmd += ["--hostfile", host_file]
    full_env = dict(envs)
    full_env["DMLC_ROLE"] = role
    full_env["DMLC_JOB_CLUSTER"] = "mpi"
    for k, v in full_env.items():
        if flavor == "openmpi":
            cmd += ["-x", f"{k}={v}"]
        else:
            cmd += ["-env", str(k), str(v)]
    return cmd + list(command)


def submit(args) -> None:
    flavor = detect_mpi_flavor()

    def launch_all(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        cmds = []
        if nworker:
            cmds.append(
                build_mpirun(
                    nworker, "worker", list(args.command), envs, flavor,
                    args.host_file,
                )
            )
        if nserver:
            cmds.append(
                build_mpirun(
                    nserver, "server", list(args.command), envs, flavor,
                    args.host_file,
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
