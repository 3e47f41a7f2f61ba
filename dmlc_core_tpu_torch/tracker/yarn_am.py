"""In-container YARN application master (Python, JVM-free; the port of
``dmlc_core_tpu/tracker/yarn_am.py``).

Reference: tracker/yarn/src/org/apache/hadoop/yarn/dmlc/
ApplicationMaster.java — the Java AM registers with the
ResourceManager over the AM-RM protobuf protocol, allocates one
container per task, and relaunches failures up to ``DMLC_MAX_ATTEMPT``
with per-node blacklisting (ApplicationMaster.java:537-569, :76, :212).

TPU-native divergence: this AM runs the job's tasks as *processes
inside its own container*, supervised by ``tracker/supervisor.py`` —
the same relaunch-budget + blacklist semantics, no JVM and no AM-RM
RPC. That fits the TPU deployment shape: the heavy compute lives on
the TPU slice the workers drive, not in YARN containers, so one
container's allocation (sized nworker+nserver tasks wide by the REST
submitter, backends/yarn.py) hosts the whole client side. Jobs that
genuinely need one YARN container per task still go through the stock
Java AM via the jar path.

Each task gets ``DMLC_TASK_ID`` and its attempt number
(``DMLC_NUM_ATTEMPT``, reference local.py contract) and is booted
through ``tracker/launcher.py``, which derives worker/server role from
the task id (reference launcher.py:41-47).
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import List, Optional

from .supervisor import JobAborted, Supervisor

__all__ = ["task_env", "main"]


def task_env(base: dict, task_id: int) -> dict:
    """Per-task env: the container env plus the task id / attempt slots
    launcher.py derives the role from. DMLC_ROLE is dropped so each
    task re-derives its own (the AM container env is role-less)."""
    env = dict(base)
    env.pop("DMLC_ROLE", None)
    env["DMLC_TASK_ID"] = str(task_id)
    return env


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m dmlc_core_tpu_torch.tracker.yarn_am <command...>",
              file=sys.stderr)
        return 2
    base = os.environ.copy()
    nworker = int(base.get("DMLC_NUM_WORKER", 1))
    nserver = int(base.get("DMLC_NUM_SERVER", 0))

    def launch(task_id: int, host: str, attempt: int):
        env = task_env(base, task_id)
        env["DMLC_NUM_ATTEMPT"] = str(attempt)
        return subprocess.Popen(
            [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.launcher"] + argv,
            env=env,
        )

    # one shared container → localhost is not a real failure domain;
    # disable host blacklisting (supervisor.py host_fail_limit note) but
    # keep the per-task DMLC_MAX_ATTEMPT relaunch budget
    sup = Supervisor(
        launch,
        hosts=("localhost",),
        host_fail_limit=float("inf"),
        allow_replacement=False,
    )
    try:
        sup.run(nworker + nserver)
    except JobAborted as exc:
        print(f"yarn_am: job aborted: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
