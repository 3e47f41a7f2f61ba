"""Local backend: supervised subprocesses with retry + relaunch (the port
of ``dmlc_core_tpu/tracker/backends/local.py``).

Reference: tracker/dmlc_tracker/local.py (roles by index — first
num_workers are workers, rest servers, local.py:66-73; attempt count
exported as DMLC_NUM_ATTEMPT, local.py:26-49). All tasks run under the
shared Supervisor (supervisor.py): per-task attempt budgets
(DMLC_MAX_ATTEMPT / --local-num-attempt), job abort past the budget, and
relaunched workers recovering their rank via the tracker's ``recover``
path. A task failure is pushed to the collective engines' death watch
(``collective.notify_task_failure``) before the relaunch.

Left out, each refused by ``refuse_unported`` with the ``ROADMAP.md``
item that brings it: the block-cache daemon (``--block-cache``, §1 item
8), the dsserve tier (``--dsserve``, §1 item 7), and the shard service,
the journal and the supervised tracker, and autoscale (``--shard-oversplit``,
``--shard-lease-ttl``, ``--tracker-journal``, ``--autoscale*``, §1 item
4b). The failure observers hold no shard-lease reclaim for the same
reason. ``--trace-dir`` (exported by ``submit``) reaches every task
through the inherited environment; a task the supervisor SIGKILLs leaves
no trace file, since no exit hook runs.
"""

from __future__ import annotations

import logging
import os
import subprocess
from typing import Dict, List

from ...utils.logging import Error
from .. import collective
from ..supervisor import Supervisor, default_max_attempt
from . import run_tracker_submit

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")

#: (option attribute, flag, ROADMAP.md item) of every unported feature
_UNPORTED = (
    ("block_cache", "--block-cache", "§1 item 8"),
    ("block_cache_mb", "--block-cache-mb", "§1 item 8"),
    ("dsserve", "--dsserve", "§1 item 7"),
    ("shard_oversplit", "--shard-oversplit", "§1 item 4b"),
    ("shard_lease_ttl", "--shard-lease-ttl", "§1 item 4b"),
    ("tracker_journal", "--tracker-journal", "§1 item 4b"),
    ("autoscale", "--autoscale", "§1 item 4b"),
    ("autoscale_cost_ceiling", "--autoscale-cost-ceiling", "§1 item 4b"),
    ("autoscale_dwell", "--autoscale-dwell", "§1 item 4b"),
)


def refuse_unported(args) -> None:
    """Raise on a flag whose feature the port lacks (set to anything but
    its default), naming the ``ROADMAP.md`` item that brings it."""
    for attr, flag, item in _UNPORTED:
        if getattr(args, attr, None):
            raise Error(f"{flag} is not ported (ROADMAP.md {item})")


def make_launcher(
    cmd: List[str],
    nworker: int,
    pass_env: Dict[str, object],
    cluster: str = "local",
):
    """Popen factory for the Supervisor: role from task index, DMLC env
    contract exported per attempt. The command runs through
    ``/bin/bash``, so a URI with ``&`` in it must be quoted."""
    if "/" not in cmd[0] and os.path.exists(cmd[0]):
        cmd = ["./" + cmd[0]] + cmd[1:]

    def launch(task_id: int, host: str, attempt: int) -> subprocess.Popen:
        env = os.environ.copy()
        for k, v in pass_env.items():
            env[str(k)] = str(v)
        env["DMLC_TASK_ID"] = str(task_id)
        env["DMLC_ROLE"] = "worker" if task_id < nworker else "server"
        env["DMLC_JOB_CLUSTER"] = cluster
        env["DMLC_NUM_ATTEMPT"] = str(attempt)
        return subprocess.Popen(
            " ".join(cmd), shell=True, executable="/bin/bash", env=env
        )

    return launch


def submit(args) -> None:
    refuse_unported(args)
    checks: List = []

    def launch_all(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        if args.dry_run:
            for i in range(nworker + nserver):
                role = "worker" if i < nworker else "server"
                print(f"[dry-run] local task {i} role={role}: "
                      f"{' '.join(args.command)}")
            return
        # --local-num-attempt retries == max_attempt total runs - 1
        # (reference local.py retry budget); DMLC_MAX_ATTEMPT wins if set.
        # localhost is one shared host, not a failure domain — per-task
        # budgets apply but blacklisting is disabled.
        sup = Supervisor(
            make_launcher(list(args.command), nworker, envs),
            hosts=["localhost"],
            max_attempt=default_max_attempt(args.local_num_attempt + 1),
            host_fail_limit=float("inf"),
            # a dead worker's collective peers learn of the death NOW
            # (a no-op when the job never opened a watch)
            on_task_failure=[collective.notify_task_failure],
        )
        if nserver:
            # the PS tracker waits on its scheduler alone, which may exit
            # before the tasks have run: run them to their end here, so
            # the job ends when both have
            sup.run(nworker + nserver)
            return
        checks.append(sup.run_in_thread(nworker, "local-supervisor"))

    run_tracker_submit(
        args, launch_all,
        abort_check=lambda: checks[0]() if checks else None,
    )
