"""Cluster launch backends (the port of
``dmlc_core_tpu/tracker/backends/__init__.py``).

Each module exposes ``submit(args)`` (args from tracker.opts) and pure
``build_*`` helpers that return the command lines to run, so backends are
testable without a cluster (and honor ``--dry-run``): ``local``
(supervised subprocesses on this host), ``ssh``, ``mpi``, ``sge``,
``slurm``, ``yarn`` (with the in-container AM ``tracker/yarn_am.py``),
``mesos``, ``kubernetes`` and ``tpu-pod``.
"""

from typing import Callable, Dict

from ...utils.logging import Error


def run_tracker_submit(args, launch_all, pscmd=None, abort_check=None) -> None:
    """The shared backend trailer: start the tracker (unless dry-run) and
    hand worker envs to ``launch_all``. ``abort_check`` lets a
    Supervisor-backed launcher abort the rendezvous wait (supervisor.py)."""
    from .. import tracker

    tracker.submit(
        args.num_workers,
        args.num_servers,
        fun_submit=launch_all,
        pscmd=pscmd if pscmd is not None else " ".join(args.command),
        host_ip=args.host_ip or "auto",
        dry_run=args.dry_run,
        abort_check=abort_check,
    )


def format_env_exports(envs: Dict[str, object]) -> str:
    """Deterministic ``export K=V; `` prefix used by shell-based backends."""
    return "".join(
        f"export {k}={v}; " for k, v in sorted(envs.items(), key=lambda kv: str(kv[0]))
    )


def get_backend(cluster: str) -> Callable:
    """The submit function of ``cluster``, for every cluster the options
    accept; the modules are imported on demand."""
    from . import (  # local imports keep optional deps lazy
        kubernetes,
        local,
        mesos,
        mpi,
        sge,
        slurm,
        ssh,
        tpu_pod,
        yarn,
    )

    table: Dict[str, Callable] = {
        "local": local.submit,
        "ssh": ssh.submit,
        "mpi": mpi.submit,
        "sge": sge.submit,
        "slurm": slurm.submit,
        "yarn": yarn.submit,
        "mesos": mesos.submit,
        "kubernetes": kubernetes.submit,
        "tpu-pod": tpu_pod.submit,
    }
    if cluster not in table:
        raise Error(f"Unknown submission cluster type {cluster!r}")
    return table[cluster]
