"""The port's cluster backends (``dmlc_core_tpu_torch.tracker.backends``:
ssh, mpi, slurm, sge, mesos, kubernetes, tpu-pod and yarn's client
command) against the JAX package's on the CPU: every ``build_*`` helper
gives the same argv, scripts and manifests on the same arguments, the
launchers hand the same commands to the binaries they run, and the
fake-binary jobs of ``tests/test_backend_fakes.py`` (ssh, slurm, sge,
mesos, kubernetes, mpi) run end to end through the port's ``submit``
with the port's ``RabitWorker`` (marked slow, as there)."""

import importlib
import os
import subprocess
import sys

import pytest

from dmlc_core_tpu.tracker import opts as jax_opts
from dmlc_core_tpu.tracker.backends import kubernetes as jax_kubernetes
from dmlc_core_tpu.tracker.backends import mesos as jax_mesos
from dmlc_core_tpu.tracker.backends import mpi as jax_mpi
from dmlc_core_tpu.tracker.backends import sge as jax_sge
from dmlc_core_tpu.tracker.backends import slurm as jax_slurm
from dmlc_core_tpu.tracker.backends import ssh as jax_ssh
from dmlc_core_tpu.tracker.backends import tpu_pod as jax_tpu_pod
from dmlc_core_tpu.tracker.backends import yarn as jax_yarn
from dmlc_core_tpu_torch.tracker import opts
from dmlc_core_tpu_torch.tracker.backends import kubernetes, mesos, mpi, sge, slurm, ssh
from dmlc_core_tpu_torch.tracker.backends import tpu_pod, yarn

from conftest import install_fake_binary
from test_backend_fakes import (FAKE_KUBECTL, FAKE_MESOS_EXECUTE, FAKE_MPIRUN, FAKE_QSUB,
                                FAKE_SRUN, FAKE_SSH)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVS = {"DMLC_NUM_WORKER": 2, "DMLC_NUM_SERVER": 1, "DMLC_TRACKER_URI": "10.0.0.5",
        "DMLC_TRACKER_PORT": 9091}
CMD = ["python", "train.py", "--name", "run 1"]


def both_args(argv):
    """The same argv through both packages' option parsers."""
    return opts.get_opts(list(argv)), jax_opts.get_opts(list(argv))


# -- ssh ---------------------------------------------------------------------------


def test_read_hosts_equals_jax(tmp_path):
    hosts = tmp_path / "hosts"
    hosts.write_text("# a comment\n10.0.0.1\n\n10.0.0.2:2222  # inline\nnode-c:22\n")
    assert ssh.read_hosts(str(hosts)) == jax_ssh.read_hosts(str(hosts)) == [
        ("10.0.0.1", 22), ("10.0.0.2", 2222), ("node-c", 22)]
    empty = tmp_path / "empty"
    empty.write_text("# nothing\n")
    for mod in (ssh, jax_ssh):
        with pytest.raises(RuntimeError, match="no hosts"):
            mod.read_hosts(str(empty))


@pytest.mark.parametrize("role,taskid", [("worker", 0), ("worker", 1), ("server", 2)])
def test_ssh_command_equals_jax(role, taskid):
    args = ("node-a", 2222, CMD, ENVS, role, taskid, "/work dir")
    assert ssh.build_ssh_command(*args) == jax_ssh.build_ssh_command(*args)


def test_sync_dir_runs_the_jax_rsync(monkeypatch):
    calls = []
    for mod in (ssh, jax_ssh):
        monkeypatch.setattr(mod.subprocess, "check_call", calls.append)
        mod.sync_dir("/src", "node-a", 2222, "/dst")
    assert calls[0] == calls[1] and calls[0][0] == "rsync"


# -- mpi ---------------------------------------------------------------------------


@pytest.mark.parametrize("flavor", ["openmpi", "mpich"])
@pytest.mark.parametrize("host_file", [None, "hosts.txt"])
def test_mpirun_equals_jax(flavor, host_file):
    for role, n in (("worker", 2), ("server", 1)):
        args = (n, role, CMD, ENVS, flavor, host_file)
        assert mpi.build_mpirun(*args) == jax_mpi.build_mpirun(*args)


@pytest.mark.parametrize("version,flavor", [
    ("mpirun (Open MPI) 4.1.5", "openmpi"),
    ("HYDRA build details:\n    Version: 4.0", "mpich"),
    (None, "openmpi"),  # no mpirun on PATH
])
def test_mpi_flavor_detection_equals_jax(tmp_path, monkeypatch, version, flavor):
    if version is None:
        monkeypatch.setenv("PATH", str(tmp_path / "empty-bin"))
    else:
        install_fake_binary(tmp_path, monkeypatch, "mpirun",
                            f"#!/bin/sh\ncat <<'EOF'\n{version}\nEOF\n")
    assert mpi.detect_mpi_flavor() == jax_mpi.detect_mpi_flavor() == flavor


# -- slurm, sge, mesos -------------------------------------------------------------


@pytest.mark.parametrize("ntask,nnodes,role", [(2, 2, "worker"), (4, 1, "worker"), (1, 1, "server")])
def test_srun_equals_jax(ntask, nnodes, role):
    args = (ntask, nnodes, role, CMD, ENVS)
    assert slurm.build_srun(*args) == jax_slurm.build_srun(*args)


@pytest.mark.parametrize("extra", [
    [],
    ["--queue", "gpu", "--jobname", "ctr", "--sge-log-dir", "/logs"],
])
def test_sge_script_and_qsub_equal_jax(extra):
    port_args, jax_args = both_args(["--cluster", "sge", "--num-workers", "2", *extra, *CMD])
    assert sge.build_runner_script(CMD, ENVS, 2) == jax_sge.build_runner_script(CMD, ENVS, 2)
    assert sge.build_qsub("rundmlc.sh", 3, port_args) == \
        jax_sge.build_qsub("rundmlc.sh", 3, jax_args)


@pytest.mark.parametrize("role,cores,mem", [("worker", 4, 2048), ("server", 1, 512)])
def test_mesos_execute_equals_jax(role, cores, mem):
    args = ("master:5050", "job-3", CMD, ENVS, role, 3, cores, mem)
    assert mesos.build_mesos_execute(*args) == jax_mesos.build_mesos_execute(*args)


def test_mesos_needs_a_master_like_jax(monkeypatch):
    monkeypatch.delenv("MESOS_MASTER", raising=False)
    for mod, parse in ((mesos, opts), (jax_mesos, jax_opts)):
        args = parse.get_opts(["--cluster", "mesos", "--num-workers", "1", *CMD])
        with pytest.raises(RuntimeError, match="mesos-master"):
            mod.submit(args)


# -- kubernetes --------------------------------------------------------------------


@pytest.mark.parametrize("max_attempt", [None, "5"])
def test_kubernetes_manifests_equal_jax(monkeypatch, max_attempt):
    if max_attempt is None:
        monkeypatch.delenv("DMLC_MAX_ATTEMPT", raising=False)
    else:
        monkeypatch.setenv("DMLC_MAX_ATTEMPT", max_attempt)
    port_args, jax_args = both_args([
        "--cluster", "kubernetes", "--num-workers", "2", "--num-servers", "1",
        "--kube-namespace", "ml", "--kube-worker-image", "trainer:1",
        "--worker-cores", "4", "--worker-memory", "3g", *CMD])
    got = kubernetes.build_all_manifests(port_args, ENVS)
    assert got == jax_kubernetes.build_all_manifests(jax_args, ENVS)
    assert [m["metadata"]["name"] for m in got] == [
        "dmlc-tpu-worker-0", "dmlc-tpu-worker-1", "dmlc-tpu-server-0"]


def test_kubectl_apply_sends_the_jax_bundle(monkeypatch):
    """The kubectl fallback hands ``kubectl apply`` the same argv and the
    same JSON List on stdin as the JAX package's, and raises the same way
    on a failed apply."""
    manifests = kubernetes.build_all_manifests(
        opts.get_opts(["--cluster", "kubernetes", "--num-workers", "2", *CMD]), ENVS)
    seen = []

    def fake_run(argv, input=None):
        seen.append((argv, input))
        return subprocess.CompletedProcess(argv, 0)

    for mod in (kubernetes, jax_kubernetes):
        monkeypatch.setattr(subprocess, "run", fake_run)
        mod._apply_via_kubectl(manifests, "ml")
    assert seen[0] == seen[1] and seen[0][0] == ["kubectl", "apply", "-n", "ml", "-f", "-"]
    for mod in (kubernetes, jax_kubernetes):
        monkeypatch.setattr(subprocess, "run",
                            lambda argv, input=None: subprocess.CompletedProcess(argv, 1))
        with pytest.raises(RuntimeError, match="kubectl apply failed"):
            mod._apply_via_kubectl(manifests, "ml")


# -- tpu-pod -----------------------------------------------------------------------


@pytest.mark.parametrize("worker_id,attempt", [(0, 0), (3, 2)])
def test_tpu_pod_commands_equal_jax(worker_id, attempt):
    args = (worker_id, 4, CMD, ENVS, "10.0.0.5", attempt)
    remote = tpu_pod.build_worker_command(*args)
    assert remote == jax_tpu_pod.build_worker_command(*args)
    for zone, project in (("us-central2-b", "proj"), ("", "")):
        ssh_args = ("pod", zone, project, worker_id, remote)
        assert tpu_pod.build_gcloud_ssh(*ssh_args) == jax_tpu_pod.build_gcloud_ssh(*ssh_args)


def test_tpu_pod_refuses_servers_like_jax():
    for mod, parse in ((tpu_pod, opts), (jax_tpu_pod, jax_opts)):
        args = parse.get_opts(["--cluster", "tpu-pod", "--num-workers", "2",
                               "--num-servers", "1", "--tpu-name", "pod", *CMD])
        with pytest.raises(RuntimeError, match="no parameter servers"):
            mod.submit(args)


# -- yarn's jar client -------------------------------------------------------------


def test_yarn_env_and_client_command_equal_jax(tmp_path, monkeypatch):
    """The jar path's env and ``yarn jar`` command, with a command file
    the auto file cache ships and rewrites to its basename."""
    monkeypatch.setenv("DMLC_MAX_ATTEMPT", "4")
    script = tmp_path / "train.py"
    script.write_text("")
    port_args, jax_args = both_args([
        "--cluster", "yarn", "--num-workers", "2", "--jobname", "ctr", "--queue", "q1",
        "--files", "extra.txt", "python", str(script)])
    assert yarn.build_yarn_env(port_args, ENVS) == jax_yarn.build_yarn_env(jax_args, ENVS)
    cmd = yarn.build_client_command(port_args, ENVS)
    assert cmd == jax_yarn.build_client_command(jax_args, ENVS)
    assert cmd[-2:] == ["python", "./train.py"] and str(script) in cmd


# -- the fake-binary jobs ----------------------------------------------------------

WORKER = """
import os, sys
sys.path.insert(0, {repo!r})
from dmlc_core_tpu_torch.tracker.client import RabitWorker
w = RabitWorker()
rank = w.start()
with open({out!r} + str(rank), "w") as f:
    f.write("%s %s %s" % (rank, os.environ["DMLC_ROLE"],
                          os.environ.get("DMLC_JOB_CLUSTER")))
w.shutdown()
"""


def run_job(tmp_path, cluster, extra=()):
    """Two port workers through the port's submit on ``cluster``; each
    writes its rank, role and cluster."""
    out = str(tmp_path / "rank")
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, out=out))
    importlib.import_module("dmlc_core_tpu_torch.tracker.submit").main([
        "--cluster", cluster, "--num-workers", "2", "--host-ip", "127.0.0.1", *extra,
        sys.executable, str(script)])
    got = set()
    for r in range(2):
        rank, role, job_cluster = open(out + str(r)).read().split()
        got.add(int(rank))
        assert role == "worker" and job_cluster == cluster
    assert got == {0, 1}


@pytest.mark.slow
def test_ssh_submit_end_to_end(tmp_path, monkeypatch):
    install_fake_binary(tmp_path, monkeypatch, "ssh", FAKE_SSH)
    hosts = tmp_path / "hosts"
    hosts.write_text("127.0.0.1\n127.0.0.1:2222  # comment\n")
    run_job(tmp_path, "ssh", ["--host-file", str(hosts)])


@pytest.mark.slow
def test_slurm_submit_end_to_end(tmp_path, monkeypatch):
    install_fake_binary(tmp_path, monkeypatch, "srun", FAKE_SRUN)
    run_job(tmp_path, "slurm")


@pytest.mark.slow
def test_sge_submit_end_to_end(tmp_path, monkeypatch):
    install_fake_binary(tmp_path, monkeypatch, "qsub", FAKE_QSUB)
    monkeypatch.chdir(tmp_path)  # the backend writes rundmlc.sh to cwd
    run_job(tmp_path, "sge")


@pytest.mark.slow
def test_mesos_submit_end_to_end(tmp_path, monkeypatch):
    install_fake_binary(tmp_path, monkeypatch, "mesos-execute", FAKE_MESOS_EXECUTE)
    monkeypatch.setenv("MESOS_MASTER", "fake-master:5050")
    run_job(tmp_path, "mesos")


@pytest.mark.slow
def test_kubernetes_submit_end_to_end(tmp_path, monkeypatch):
    """Without the python kubernetes client, submission falls back to
    ``kubectl apply -f -``, here a fake that runs each container's
    command."""
    install_fake_binary(tmp_path, monkeypatch, "kubectl", FAKE_KUBECTL)
    monkeypatch.setitem(sys.modules, "kubernetes", None)  # never a real cluster
    run_job(tmp_path, "kubernetes")


@pytest.mark.slow
def test_mpi_submit_end_to_end(tmp_path, monkeypatch):
    install_fake_binary(tmp_path, monkeypatch, "mpirun", FAKE_MPIRUN)
    run_job(tmp_path, "mpi")
