"""The port's tpu-pod backend (``dmlc_core_tpu_torch.tracker.backends.tpu_pod``)
end to end on the CPU, as ``tests/test_tpu_pod.py`` drives the JAX
package's: a fake ``gcloud`` on PATH runs each ``--command`` payload
locally, through the port's submit, tracker rendezvous and Supervisor.
Port workers rendezvous with both env contracts exported; a worker that
dies on its first attempt is relaunched with the same task id (pinned
placement); a worker that always dies trips its budget and the job
aborts instead of re-placing it. Marked slow, as there."""

import importlib
import os
import sys

import pytest

from dmlc_core_tpu_torch.tracker.supervisor import JobAborted

from conftest import install_fake_binary
from test_tpu_pod import FAKE_GCLOUD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import os, sys
sys.path.insert(0, {repo!r})
# record every attempt before doing anything that can fail
with open({out!r} + "_attempts", "a") as f:
    f.write("%s:%s\\n" % (os.environ["DMLC_TASK_ID"],
                          os.environ["DMLC_NUM_ATTEMPT"]))
mode = {mode!r}
tid = int(os.environ["DMLC_TASK_ID"])
att = int(os.environ["DMLC_NUM_ATTEMPT"])
if mode == "die_once" and tid == 1 and att == 0:
    os._exit(1)  # before the rendezvous: the Supervisor must relaunch
if mode == "die_always" and tid == 1:
    os._exit(1)
from dmlc_core_tpu_torch.tracker.client import RabitWorker
w = RabitWorker()
rank = w.start()
with open({out!r} + str(rank), "w") as f:
    f.write("%s %s %s %s" % (
        rank,
        os.environ["DMLC_ROLE"],
        os.environ["JAX_COORDINATOR_ADDRESS"],
        os.environ["JAX_PROCESS_ID"],
    ))
w.shutdown()
"""


@pytest.fixture()
def fake_gcloud(tmp_path, monkeypatch):
    return install_fake_binary(tmp_path, monkeypatch, "gcloud", FAKE_GCLOUD)


@pytest.fixture(autouse=True)
def _generous_grace(monkeypatch):
    # a loaded host can stretch a worker's shutdown past the 10 s
    # default grace, which would abort the job as "not a rabit client"
    monkeypatch.setenv("DMLC_RENDEZVOUS_GRACE", "60")


def submit_pod(tmp_path, mode, out):
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, out=out, mode=mode))
    importlib.import_module("dmlc_core_tpu_torch.tracker.submit").main([
        "--cluster", "tpu-pod", "--num-workers", "2",
        "--tpu-name", "fake-pod", "--tpu-zone", "nowhere-1a",
        "--host-ip", "127.0.0.1",
        sys.executable, str(script),
    ])


@pytest.mark.slow
def test_tpu_pod_submit_end_to_end(tmp_path, fake_gcloud, monkeypatch):
    monkeypatch.setenv("DMLC_MAX_ATTEMPT", "3")
    out = str(tmp_path / "rank")
    submit_pod(tmp_path, "ok", out)
    for r in range(2):
        rank, role, coord, pid = open(out + str(r)).read().split()
        assert int(rank) == r and role == "worker"
        assert coord.endswith(":8476")  # the coordinator contract rode the exports
        assert 0 <= int(pid) < 2
    assert sorted(open(out + "_attempts").read().splitlines()) == ["0:0", "1:0"]


@pytest.mark.slow
def test_tpu_pod_relaunch_same_task_id_after_kill(tmp_path, fake_gcloud, monkeypatch):
    """The supervised relaunch keeps the task id (pod host, input part)."""
    monkeypatch.setenv("DMLC_MAX_ATTEMPT", "3")
    out = str(tmp_path / "rank")
    submit_pod(tmp_path, "die_once", out)
    assert {int(open(out + str(r)).read().split()[0]) for r in range(2)} == {0, 1}
    # worker 1 died on attempt 0 and came back as attempt 1, same task id
    assert sorted(open(out + "_attempts").read().splitlines()) == ["0:0", "1:0", "1:1"]


@pytest.mark.slow
def test_tpu_pod_pinned_placement_aborts_past_budget(tmp_path, fake_gcloud, monkeypatch):
    monkeypatch.setenv("DMLC_MAX_ATTEMPT", "2")
    out = str(tmp_path / "rank")
    with pytest.raises(JobAborted):
        submit_pod(tmp_path, "die_always", out)
    attempts = sorted(open(out + "_attempts").read().splitlines())
    # 2 attempts for task 1, then the abort: no replacement host
    assert attempts.count("1:0") == 1 and attempts.count("1:1") == 1
    assert not any(a.startswith("1:2") for a in attempts)
