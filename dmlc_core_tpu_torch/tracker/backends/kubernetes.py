"""Kubernetes backend (the port of
``dmlc_core_tpu/tracker/backends/kubernetes.py``; reference
tracker/dmlc_tracker/kubernetes.py).

Synthesizes Job manifests per role (scheduler Service + worker/server
Jobs, kubernetes.py:29-60) and submits them via the official client when
available. --dry-run prints the manifests, which keeps the backend fully
testable without a cluster.
"""

from __future__ import annotations

import json
from typing import Dict, List

from . import run_tracker_submit


def build_job_manifest(
    name: str,
    image: str,
    command: List[str],
    envs: Dict[str, object],
    role: str,
    taskid: int,
    namespace: str,
    cores: int,
    memory_mb: int,
) -> Dict:
    env_list = [
        {"name": str(k), "value": str(v)} for k, v in sorted(
            {**envs, "DMLC_ROLE": role, "DMLC_TASK_ID": taskid,
             "DMLC_JOB_CLUSTER": "kubernetes"}.items()
        )
    ]
    from ..supervisor import default_max_attempt

    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            # k8s' own controller is the supervisor here; the retry budget
            # follows the same DMLC_MAX_ATTEMPT contract as the YARN AM
            # (retries = total attempts - 1)
            "backoffLimit": default_max_attempt() - 1,
            "template": {
                "spec": {
                    "restartPolicy": "Never",
                    "containers": [
                        {
                            "name": name,
                            "image": image,
                            "command": ["/bin/sh", "-c", " ".join(command)],
                            "env": env_list,
                            "resources": {
                                "requests": {
                                    "cpu": str(cores),
                                    "memory": f"{memory_mb}Mi",
                                }
                            },
                        }
                    ],
                }
            },
        },
    }


def build_all_manifests(args, envs: Dict[str, object]) -> List[Dict]:
    jobname = args.jobname or "dmlc-tpu"
    manifests = []
    for i in range(args.num_workers):
        manifests.append(
            build_job_manifest(
                f"{jobname}-worker-{i}", args.kube_worker_image,
                list(args.command), envs, "worker", i, args.kube_namespace,
                args.worker_cores, args.worker_memory_mb,
            )
        )
    for i in range(args.num_servers):
        manifests.append(
            build_job_manifest(
                f"{jobname}-server-{i}", args.kube_server_image,
                list(args.command), envs, "server",
                args.num_workers + i, args.kube_namespace,
                args.server_cores, args.server_memory_mb,
            )
        )
    return manifests


def _apply_via_kubectl(manifests: List[Dict], namespace: str) -> None:
    """Fallback submission path: ONE ``kubectl apply -f -`` of a v1 List
    wrapping every Job (kubectl accepts JSON). Covers clusters where
    only the CLI is installed — the python client is an optional
    dependency, not a requirement — and keeps submission atomic-ish:
    one process, one auth round trip, no half-submitted window between
    per-manifest calls."""
    import subprocess

    bundle = {"apiVersion": "v1", "kind": "List", "items": manifests}
    proc = subprocess.run(
        ["kubectl", "apply", "-n", namespace, "-f", "-"],
        input=json.dumps(bundle).encode(),
    )
    if proc.returncode != 0:
        names = [m["metadata"]["name"] for m in manifests]
        raise RuntimeError(
            f"kubectl apply failed (rc={proc.returncode}) for {names}"
        )


def submit(args) -> None:
    def launch_all(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        manifests = build_all_manifests(args, envs)
        if args.dry_run:
            for m in manifests:
                print(json.dumps(m, indent=2))
            return
        try:
            from kubernetes import client, config  # type: ignore
        except ImportError:
            import shutil

            if shutil.which("kubectl") is None:
                raise RuntimeError(
                    "kubernetes backend requires the 'kubernetes' python "
                    "client or a kubectl binary on PATH"
                ) from None
            _apply_via_kubectl(manifests, args.kube_namespace)
            return
        config.load_kube_config()
        batch = client.BatchV1Api()
        for m in manifests:
            batch.create_namespaced_job(args.kube_namespace, m)

    run_tracker_submit(args, launch_all)
