"""SSH backend (the port of ``dmlc_core_tpu/tracker/backends/ssh.py``).

Hosts from --host-file (``host[:port]`` per line, '#' comments); optional
rsync of the working dir to --sync-dst-dir; one ssh per task exporting the
DMLC env plus DMLC_NODE_HOST (reference tracker/dmlc_tracker/ssh.py:40-85).
"""

from __future__ import annotations

import logging
import os
import subprocess
import threading
from typing import Dict, List, Tuple

from . import format_env_exports, run_tracker_submit

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")


def read_hosts(host_file: str) -> List[Tuple[str, int]]:
    hosts: List[Tuple[str, int]] = []
    with open(host_file) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            if ":" in line:
                host, port = line.rsplit(":", 1)
                hosts.append((host, int(port)))
            else:
                hosts.append((line, 22))
    if not hosts:
        raise RuntimeError(f"no hosts in {host_file}")
    return hosts


def build_ssh_command(
    host: str,
    port: int,
    command: List[str],
    envs: Dict[str, object],
    role: str,
    taskid: int,
    workdir: str,
) -> List[str]:
    exports = dict(envs)
    exports.update(
        DMLC_ROLE=role,
        DMLC_TASK_ID=taskid,
        DMLC_NODE_HOST=host,
        DMLC_JOB_CLUSTER="ssh",
    )
    remote = f"{format_env_exports(exports)}cd {workdir}; {' '.join(command)}"
    return [
        "ssh", "-o", "StrictHostKeyChecking=no", "-p", str(port), host,
        remote,
    ]


def sync_dir(local_dir: str, host: str, port: int, dst_dir: str) -> None:
    """rsync the working dir to the remote host (reference sync_dir,
    ssh.py:14-22)."""
    cmd = [
        "rsync", "-az", "--rsh", f"ssh -o StrictHostKeyChecking=no -p {port}",
        local_dir + "/", f"{host}:{dst_dir}",
    ]
    subprocess.check_call(cmd)


def submit(args) -> None:
    assert args.host_file, "ssh cluster requires --host-file"
    hosts = read_hosts(args.host_file)

    def launch_all(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        workdir = args.sync_dst_dir or os.getcwd()
        if args.sync_dst_dir and not args.dry_run:
            for host, port in {(h, p) for h, p in hosts}:
                sync_dir(os.getcwd(), host, port, args.sync_dst_dir)
        for i in range(nworker + nserver):
            role = "worker" if i < nworker else "server"
            host, port = hosts[i % len(hosts)]
            cmd = build_ssh_command(
                host, port, list(args.command), envs, role, i, workdir
            )
            if args.dry_run:
                print(f"[dry-run] {' '.join(cmd)}")
                continue
            threading.Thread(
                target=subprocess.check_call, args=(cmd,), daemon=True
            ).start()

    run_tracker_submit(args, launch_all)
