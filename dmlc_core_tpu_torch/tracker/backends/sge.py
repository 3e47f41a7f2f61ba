"""Sun Grid Engine backend (the port of
``dmlc_core_tpu/tracker/backends/sge.py``; reference
tracker/dmlc_tracker/sge.py).

Generates a runner script that derives the role from $SGE_TASK_ID, then
submits a ``qsub -t 1-N`` array job (sge.py:22-43).
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, List

from . import run_tracker_submit


def build_runner_script(
    command: List[str], envs: Dict[str, object], nworker: int
) -> str:
    lines = ["#!/bin/bash"]
    for k, v in envs.items():
        lines.append(f"export {k}={v}")
    lines += [
        "export DMLC_TASK_ID=$((SGE_TASK_ID - 1))",
        "export DMLC_JOB_CLUSTER=sge",
        f"if [ $DMLC_TASK_ID -lt {nworker} ]; then",
        "  export DMLC_ROLE=worker",
        "else",
        "  export DMLC_ROLE=server",
        "fi",
        " ".join(command),
    ]
    return "\n".join(lines) + "\n"


def build_qsub(
    script: str, ntask: int, args
) -> List[str]:
    cmd = ["qsub", "-cwd", "-t", f"1-{ntask}", "-S", "/bin/bash"]
    if args.queue != "default":
        cmd += ["-q", args.queue]
    cmd += ["-N", args.jobname or "dmlc_tpu_job"]
    if args.sge_log_dir:
        cmd += ["-o", args.sge_log_dir, "-e", args.sge_log_dir]
    cmd.append(script)
    return cmd


def submit(args) -> None:
    def launch_all(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        script_path = "rundmlc.sh"
        body = build_runner_script(list(args.command), envs, nworker)
        cmd = build_qsub(script_path, nworker + nserver, args)
        if args.dry_run:
            print(f"[dry-run] write {script_path}:\n{body}")
            print(f"[dry-run] {' '.join(cmd)}")
            return
        with open(script_path, "w") as f:
            f.write(body)
        os.chmod(script_path, 0o755)
        subprocess.check_call(cmd)

    run_tracker_submit(args, launch_all)
