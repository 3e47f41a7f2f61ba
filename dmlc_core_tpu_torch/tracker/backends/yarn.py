"""YARN backend (the port of ``dmlc_core_tpu/tracker/backends/yarn.py``;
reference tracker/dmlc_tracker/yarn.py + tracker/yarn/). Its one
departure: the REST path's AM container runs
``-m dmlc_core_tpu_torch.tracker.yarn_am`` (the JAX package's names
``dmlc_core_tpu.tracker.yarn_am``).

Two submission paths:

**REST (JVM-free, TPU-native default when ``DMLC_YARN_REST`` is set).**
The reference needs a Hadoop install + dmlc-yarn.jar; a TPU host has
neither. When ``DMLC_YARN_REST`` names the ResourceManager webapp (e.g.
``http://rm:8088``), submission goes through the RM REST API —
new-application → application-submission-context → submit → state poll
— with the same stdlib-HTTP approach as io/cloudfs.py's WebHDFS client.
The AM container runs ``tracker/yarn_am.py``: a Python AM that
supervises all the job's tasks in-container with the Java AM's relaunch
budget + blacklist semantics (DMLC_MAX_ATTEMPT,
ApplicationMaster.java:537-569). The tracker stays on the submit host;
workers in the container rendezvous back over
``DMLC_TRACKER_URI``. A failed/killed application aborts the local
rendezvous via the shared ``abort_check`` contract.

**Jar (stock Java client + AM).** Without ``DMLC_YARN_REST`` the
backend builds the reference-compatible ``yarn jar`` client invocation
(env contract included); executing it requires $HADOOP_HOME, so without
one it fails with a clear message (dry-run always works). Jobs needing
one YARN container per task use this path — container allocation rides
the AM-RM protobuf protocol only the stock AM speaks.
"""

from __future__ import annotations

import json
import logging
import os
import shlex
import subprocess
import threading
import time
from typing import Dict, List, Optional

from ...io import retry as _retry
from ...utils.logging import Error
from ..opts import get_cache_file_set
from . import run_tracker_submit

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")

# YARN application states (RM REST API spec)
_TERMINAL_STATES = frozenset({"FINISHED", "FAILED", "KILLED"})


def build_yarn_env(
    args, envs: Dict[str, object]
) -> Dict[str, str]:
    out = {str(k): str(v) for k, v in envs.items()}
    out.update(
        DMLC_JOB_CLUSTER="yarn",
        DMLC_WORKER_CORES=str(args.worker_cores),
        DMLC_WORKER_MEMORY_MB=str(args.worker_memory_mb),
        DMLC_SERVER_CORES=str(args.server_cores),
        DMLC_SERVER_MEMORY_MB=str(args.server_memory_mb),
        DMLC_MAX_ATTEMPT=os.getenv("DMLC_MAX_ATTEMPT", "3"),
        DMLC_JOB_QUEUE=args.queue,
    )
    if args.jobname:
        out["DMLC_JOB_NAME"] = args.jobname
    return out


def build_client_command(args, envs: Dict[str, object]) -> List[str]:
    # auto-file-cache: ship command-referenced files and rewrite them to
    # local basenames (reference yarn.py:58 + opts.get_cache_file_set)
    fset, command = get_cache_file_set(args)
    cmd = ["yarn", "jar", "dmlc-yarn.jar", "org.apache.hadoop.yarn.dmlc.Client"]
    for f in sorted(fset):
        cmd += ["-file", f]
    cmd += ["-jobname", args.jobname or "dmlc-tpu-job"]
    cmd += command
    return cmd


# -- RM REST API client -------------------------------------------------------
class YarnRestClient:
    """Minimal ResourceManager REST client (Hadoop docs: "Cluster
    Applications API"); stdlib urllib like io/cloudfs.py's WebHDFS."""

    def __init__(self, endpoint: str, timeout: float = 30.0) -> None:
        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout

    def _request(
        self, method: str, path: str, payload: Optional[dict] = None
    ) -> dict:
        url = f"{self.endpoint}{path}"
        data = None if payload is None else json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"} if data else {}
        # the shared transient-failure retry layer (io/retry.py): a
        # restarting RM costs a backoff, not the submission
        try:
            resp = _retry.request(
                url, method, headers, data, timeout=self.timeout
            )
        except _retry.HttpError as exc:
            detail = str(exc).split(": ", 1)[-1][:300]
            raise RuntimeError(
                f"YARN RM {method} {path} failed: HTTP {exc.status} {detail}"
            ) from None
        except Error as exc:
            raise RuntimeError(
                f"YARN RM unreachable at {self.endpoint}: {exc}"
            ) from None
        try:
            body = resp.read()
        finally:
            resp.close()
        return json.loads(body) if body.strip() else {}

    def new_application(self) -> dict:
        """→ {"application-id": ..., "maximum-resource-capability": ...}"""
        return self._request("POST", "/ws/v1/cluster/apps/new-application")

    def submit_application(self, context: dict) -> None:
        self._request("POST", "/ws/v1/cluster/apps", context)

    def state(self, app_id: str) -> str:
        out = self._request("GET", f"/ws/v1/cluster/apps/{app_id}/state")
        return str(out.get("state", "UNKNOWN"))

    def report(self, app_id: str) -> dict:
        return self._request("GET", f"/ws/v1/cluster/apps/{app_id}").get(
            "app", {}
        )

    def kill(self, app_id: str) -> None:
        self._request(
            "PUT", f"/ws/v1/cluster/apps/{app_id}/state", {"state": "KILLED"}
        )


def build_rest_context(
    args,
    app_id: str,
    envs: Dict[str, object],
    max_caps: Optional[dict] = None,
) -> dict:
    """Application-submission-context for the REST path.

    One container hosts the AM plus all tasks (yarn_am.py), so its
    resource ask is the job-wide sum, clamped to the cluster's
    maximum-resource-capability from new-application."""
    env = build_yarn_env(args, envs)
    nworker, nserver = args.num_workers, args.num_servers
    memory = (
        args.worker_memory_mb * nworker + args.server_memory_mb * nserver
    )
    vcores = args.worker_cores * nworker + args.server_cores * nserver
    if max_caps:
        cap_mb = int(max_caps.get("memory", memory))
        cap_vc = int(max_caps.get("vCores", vcores))
        if memory > cap_mb or vcores > cap_vc:
            # the single-container design caps job size at one container's
            # allocation; a silent clamp would surface later as opaque
            # NM kills when tasks exceed the shrunken allocation
            logger.warning(
                "job-wide ask (%d MB / %d vCores) exceeds the cluster's "
                "max container (%d MB / %d vCores); clamping — tasks may "
                "be killed by the NodeManager. Use the jar path (stock "
                "Java AM) for one-container-per-task jobs.",
                memory, vcores, cap_mb, cap_vc,
            )
        memory = min(memory, cap_mb)
        vcores = min(vcores, cap_vc)
    # files the jar path would ship (-file …) are NOT localized over REST
    # (localization needs HDFS local-resources); the command must resolve
    # inside the container (shared FS or baked image) — warn, loudly
    fset, _ = get_cache_file_set(args)
    if fset:
        logger.warning(
            "REST submission does not ship local files %s to the AM "
            "container; ensure the command resolves there (shared "
            "filesystem / image), or use the jar path which ships them",
            sorted(fset),
        )
    python = os.getenv("DMLC_YARN_PYTHON", "python3")
    user_cmd = shlex.join(args.command)
    am_cmd = (
        f"{python} -m dmlc_core_tpu_torch.tracker.yarn_am {user_cmd}"
        " 1><LOG_DIR>/stdout 2><LOG_DIR>/stderr"
    )
    return {
        "application-id": app_id,
        "application-name": args.jobname or "dmlc-tpu-job",
        "application-type": "DMLC-TPU",
        "queue": args.queue,
        "max-app-attempts": int(env["DMLC_MAX_ATTEMPT"]),
        "resource": {"memory": max(memory, 1), "vCores": max(vcores, 1)},
        "am-container-spec": {
            "commands": {"command": am_cmd},
            "environment": {
                "entry": [
                    {"key": k, "value": v} for k, v in sorted(env.items())
                ]
            },
        },
    }


def submit_via_rest(args, endpoint: str, poll_interval: float = 5.0) -> None:
    client = YarnRestClient(endpoint)
    app_holder: List[str] = []
    errors: List[BaseException] = []

    def poll_state(app_id: str) -> None:
        last = None
        misses = 0
        while True:
            try:
                state = client.state(app_id)
                misses = 0
            except RuntimeError as exc:
                # a brief RM blip must not fail an hours-long job; only
                # sustained unreachability aborts
                misses += 1
                if misses >= 5:
                    errors.append(exc)
                    return
                logger.warning(
                    "yarn state poll failed (%d/5): %s", misses, exc
                )
                time.sleep(poll_interval)
                continue
            if state != last:
                logger.info("yarn application %s: %s", app_id, state)
                last = state
            if state in _TERMINAL_STATES:
                if state != "FINISHED":
                    errors.append(
                        RuntimeError(f"yarn application {app_id} {state}")
                    )
                    return
                final = client.report(app_id).get("finalStatus")
                if final not in (None, "SUCCEEDED"):
                    errors.append(
                        RuntimeError(
                            f"yarn application {app_id} finished with {final}"
                        )
                    )
                    return
                # app succeeded: normally the workers completed rendezvous
                # and the join below has already returned (errors is never
                # read again). If the join is STILL waiting after a grace
                # window, the app exited without its workers ever finishing
                # the job — abort instead of wedging forever.
                time.sleep(max(2.0, 4 * poll_interval))
                errors.append(
                    RuntimeError(
                        f"yarn application {app_id} finished but its "
                        "workers never completed the tracker rendezvous"
                    )
                )
                return
            time.sleep(poll_interval)

    def launch_all(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        if args.dry_run:
            ctx = build_rest_context(args, "<application-id>", envs)
            print(f"[dry-run] POST {endpoint}/ws/v1/cluster/apps")
            print(json.dumps(ctx, indent=2))
            return
        fresh = client.new_application()
        app_id = str(fresh["application-id"])
        app_holder.append(app_id)
        ctx = build_rest_context(
            args, app_id, envs, fresh.get("maximum-resource-capability")
        )
        client.submit_application(ctx)
        threading.Thread(
            target=poll_state, args=(app_id,), daemon=True, name="yarn-poll"
        ).start()

    try:
        run_tracker_submit(
            args, launch_all,
            abort_check=lambda: errors[0] if errors else None,
        )
    except BaseException:
        # aborting the local join must not leak a still-running
        # application holding cluster resources; a kill failure (RM down)
        # must not mask the original error either
        if app_holder:
            logger.info("killing yarn application %s", app_holder[0])
            try:
                client.kill(app_holder[0])
            except RuntimeError as exc:
                logger.warning("could not kill %s: %s", app_holder[0], exc)
        raise


def submit(args) -> None:
    endpoint = os.getenv("DMLC_YARN_REST", "")
    if endpoint:
        return submit_via_rest(args, endpoint)

    def launch_all(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        env = build_yarn_env(args, envs)
        cmd = build_client_command(args, envs)
        if args.dry_run:
            exports = " ".join(f"{k}={v}" for k, v in sorted(env.items()))
            print(f"[dry-run] {exports} {' '.join(cmd)}")
            return
        if "HADOOP_HOME" not in os.environ:
            raise RuntimeError(
                "yarn backend requires a Hadoop installation ($HADOOP_HOME)"
                " — or set DMLC_YARN_REST=http://<rm>:8088 for the JVM-free"
                " REST path"
            )
        full = os.environ.copy()
        full.update(env)
        subprocess.check_call(cmd, env=full)

    run_tracker_submit(args, launch_all)
