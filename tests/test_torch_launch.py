"""The port's launcher on the CPU against the JAX package's: the
``Supervisor`` state machine (copies of ``tests/test_supervisor.py``, run
on both packages' supervisors), ``python -m
dmlc_core_tpu_torch.tracker.submit`` end to end (each worker's
``DMLC_*`` env equals what the JAX submit gives for the same argv, ports
aside), the refusals of unported flags, ``Checkpointer(process_index=)``,
and the two example ports under the launcher:

- the Criteo example's collective mode with 2 CPU workers: both ranks'
  final params bit-identical, and equal to a one-process simulation with
  the JAX package (``jax.grad`` of the JAX FM per shard, folded in
  ``reference_allreduce``'s order, ``sgd_update``) within the tolerance
  of ``tests/test_torch_slice.py`` (1e-4 of max |param|: sums in another
  order, carried through the steps); ``pack_state`` gives the JAX
  example's bytes;
- HIGGS with 2 workers: each rank trains its shard and only rank 0
  writes checkpoints.

Every subprocess, thread and tracker is bounded by a timeout."""

import importlib
import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
import pytest
from jax.flatten_util import ravel_pytree

from dmlc_core_tpu.models import FactorizationMachine as JaxFM
from dmlc_core_tpu.models import sgd_update as jax_sgd_update
from dmlc_core_tpu.staging import BatchSpec as JaxSpec
from dmlc_core_tpu.staging import ell_batches as jax_ell_batches
from dmlc_core_tpu.tracker import collective as jax_coll
from dmlc_core_tpu.tracker import launcher as jax_launcher
from dmlc_core_tpu.tracker import supervisor as jax_supervisor
from dmlc_core_tpu_torch.checkpoint import Checkpointer
from dmlc_core_tpu_torch.examples import train_criteo_rec, train_higgs
from dmlc_core_tpu_torch.models import FactorizationMachine
from dmlc_core_tpu_torch.tracker import launcher
from dmlc_core_tpu_torch.tracker import supervisor as port_supervisor
from dmlc_core_tpu_torch.tracker import tracker as port_tracker
from dmlc_core_tpu_torch.tracker.supervisor import JobAborted, RendezvousNeverCompleted
from dmlc_core_tpu_torch.utils.logging import Error

# the module, not the package's re-exported ``submit`` function
submit = importlib.import_module("dmlc_core_tpu_torch.tracker.submit")
REPO = Path(__file__).resolve().parent.parent
RUN_S = 120  # bound of every launched job in this file
SUPERVISORS = {"port": port_supervisor, "jax": jax_supervisor}


@pytest.fixture(autouse=True)
def _bounded_link_waits(monkeypatch):
    """A worker waits at most 60 s for a peer's dial (300 s by default),
    in this process and in the workers it launches; a test may set less."""
    monkeypatch.setenv("DMLC_LINK_WAIT_TIMEOUT", "60")


def jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the supervisor, on both packages -------------------------------------------


class FakeProc:
    """Popen-alike whose exit code is scripted."""

    def __init__(self, returncode):
        self.returncode = returncode
        self.killed = False

    def poll(self):
        return self.returncode

    def kill(self):
        self.killed = True
        self.returncode = -9

    def wait(self):
        return self.returncode


@pytest.fixture(params=["port", "jax"])
def sup_mod(request):
    return SUPERVISORS[request.param]


def test_default_max_attempt(monkeypatch, sup_mod):
    monkeypatch.delenv("DMLC_MAX_ATTEMPT", raising=False)
    assert sup_mod.default_max_attempt() == 3
    monkeypatch.setenv("DMLC_MAX_ATTEMPT", "5")
    assert sup_mod.default_max_attempt() == 5
    monkeypatch.setenv("DMLC_MAX_ATTEMPT", "junk")
    assert sup_mod.default_max_attempt(4) == 4


def test_relaunch_until_success(sup_mod):
    log = []

    def launch(task_id, host, attempt):
        log.append((task_id, host, attempt))
        return FakeProc(1 if task_id == 1 and attempt < 2 else 0)

    sup = sup_mod.Supervisor(launch, hosts=["h0"], max_attempt=3, poll_interval=0,
                             relaunch_backoff=0)
    sup.run(2)
    assert sup.relaunches == 2 and sup.failures == {1: 2}
    assert [(h, a) for (t, h, a) in log if t == 1] == [("h0", 0), ("h0", 1), ("h0", 2)]


def test_multiple_failure_observers_all_fire(sup_mod):
    calls = []

    def first(task_id, host):
        calls.append(("first", task_id, host))

    def bad(task_id, host):
        calls.append(("bad", task_id, host))
        raise RuntimeError("observer bug")

    def last(task_id, host):
        calls.append(("last", task_id, host))

    def launch(task_id, host, attempt):
        return FakeProc(1 if task_id == 0 and attempt == 0 else 0)

    sup = sup_mod.Supervisor(launch, hosts=["h0"], max_attempt=3, poll_interval=0,
                             relaunch_backoff=0, on_task_failure=[first, bad])
    sup.add_on_task_failure(last)
    sup.run(2)
    assert calls == [("first", 0, "h0"), ("bad", 0, "h0"), ("last", 0, "h0")]
    assert sup.relaunches == 1
    assert sup_mod.Supervisor(launch, on_task_failure=first).on_task_failure == [first]


def test_abort_past_budget_kills_survivors(sup_mod):
    hang = FakeProc(None)

    def launch(task_id, host, attempt):
        return FakeProc(1) if task_id == 0 else hang

    sup = sup_mod.Supervisor(launch, hosts=["h0"], max_attempt=2, poll_interval=0,
                             relaunch_backoff=0)
    with pytest.raises(sup_mod.JobAborted, match="task 0 failed 2 times"):
        sup.run(2)
    assert hang.killed and isinstance(sup.error, sup_mod.JobAborted)


def test_blacklisted_host_moves_task(sup_mod):
    log = []

    def launch(task_id, host, attempt):
        log.append((task_id, host, attempt))
        return FakeProc(1 if host == "bad" else 0)

    sup = sup_mod.Supervisor(launch, hosts=["bad", "good"], max_attempt=3,
                             host_fail_limit=1, poll_interval=0, relaunch_backoff=0)
    sup.run(2)
    assert "bad" in sup.blacklist and sup.placement[0] == "good"
    assert log[-1][1] != "bad"


def test_pinned_placement_aborts_on_blacklist(sup_mod):
    def launch(task_id, host, attempt):
        return FakeProc(1 if task_id == 0 else None)

    sup = sup_mod.Supervisor(launch, hosts=["p0", "p1"], max_attempt=5, host_fail_limit=1,
                             allow_replacement=False, poll_interval=0, relaunch_backoff=0)
    with pytest.raises(sup_mod.JobAborted, match="cannot be re-placed"):
        sup.run(2)


def test_all_hosts_blacklisted_aborts(sup_mod):
    sup = sup_mod.Supervisor(lambda t, h, a: FakeProc(1), hosts=["h0"], max_attempt=10,
                             host_fail_limit=1, poll_interval=0, relaunch_backoff=0)
    with pytest.raises(sup_mod.JobAborted, match="every host is blacklisted"):
        sup.run(1)


def test_relaunch_backoff_is_exponential_and_capped(sup_mod):
    def launch(task_id, host, attempt):
        return FakeProc(1 if attempt < 3 else 0)

    sup = sup_mod.Supervisor(launch, hosts=["h0"], max_attempt=4, poll_interval=0,
                             relaunch_backoff=0.05, backoff_cap=10.0, quarantine_secs=0)
    t0 = time.perf_counter()
    sup.run(1)
    assert sup.backoffs == [0.05, 0.1, 0.2]
    assert time.perf_counter() - t0 >= 0.35
    capped = sup_mod.Supervisor(launch, hosts=["h0"], max_attempt=4, poll_interval=0,
                                relaunch_backoff=0.01, backoff_cap=0.015,
                                quarantine_secs=0)
    capped.run(1)
    assert capped.backoffs == [0.01, 0.015, 0.015]


def test_quarantined_host_not_retried_when_alternative_exists(sup_mod):
    log = []

    def launch(task_id, host, attempt):
        log.append((task_id, host, attempt))
        return FakeProc(1 if host == "h0" and attempt == 0 else 0)

    sup = sup_mod.Supervisor(launch, hosts=["h0", "h1"], max_attempt=3, host_fail_limit=10,
                             poll_interval=0, relaunch_backoff=0, quarantine_secs=30.0)
    sup.run(1)
    assert "h0" not in sup.blacklist and sup.quarantined.get("h0", 0) > 0
    assert [(h, a) for (_t, h, a) in log] == [("h0", 0), ("h1", 1)]


def test_quarantine_doubles_and_a_sole_host_is_still_used(sup_mod):
    def launch(task_id, host, attempt):
        return FakeProc(1 if attempt < 2 else 0)

    sup = sup_mod.Supervisor(launch, hosts=["only"], max_attempt=3, poll_interval=0,
                             relaunch_backoff=0, quarantine_secs=100.0)
    releases = []
    orig = sup._quarantine

    def spy(host):
        orig(host)
        releases.append(sup.quarantined[host] - time.monotonic())

    sup._quarantine = spy
    sup.run(1)
    assert len(releases) == 2 and releases[1] > releases[0] * 1.5
    assert sup.placement[0] == "only" and sup.relaunches == 2


@pytest.mark.parametrize("env", [
    {"DMLC_ROLE": "server"}, {"DMLC_TASK_ID": "0", "DMLC_NUM_WORKER": "2"},
    {"DMLC_TASK_ID": "3", "DMLC_NUM_WORKER": "2"}, {"SGE_TASK_ID": "4", "DMLC_NUM_WORKER": "2"},
    {},
])
def test_launcher_derive_role_equals_jax(env):
    assert launcher.derive_role(env) == jax_launcher.derive_role(env)


def test_launcher_runs_the_command_with_its_role(tmp_path, monkeypatch):
    out = tmp_path / "role"
    monkeypatch.setenv("DMLC_TASK_ID", "3")
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.delenv("DMLC_ROLE", raising=False)
    assert launcher.main(["echo", "$DMLC_ROLE", ">", str(out)]) == 0
    assert out.read_text().strip() == "server"


# -- submit end to end -------------------------------------------------------------

ENV_WORKER = """
import json, os, sys
sys.path.insert(0, {repo!r})
from {pkg}.tracker.client import RabitWorker
env = {{k: v for k, v in os.environ.items() if k.startswith("DMLC_")}}
w = RabitWorker()
rank = w.start()
with open({out!r} + os.environ["DMLC_TASK_ID"], "w") as f:
    json.dump({{"rank": rank, "env": env}}, f)
w.shutdown()
"""


def run_job(cmd, env, cwd):
    """``cmd`` in a process group of its own, killed whole (the launcher
    and its workers) past RUN_S."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=cwd, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=RUN_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, stdout, stderr)


def run_submit(pkg, argv):
    """``python -m <pkg>.tracker.submit argv`` in a subprocess."""
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               DMLC_TRACE_ID="5eed")
    return run_job([sys.executable, "-m", f"{pkg}.tracker.submit", *argv], env, str(REPO))


@pytest.mark.parametrize("extra", [[], ["--local-num-attempt", "1"]])
def test_local_submit_gives_the_jax_submits_worker_env(tmp_path, extra):
    views = {}
    for pkg in ("dmlc_core_tpu_torch", "dmlc_core_tpu"):
        out = str(tmp_path / f"{pkg}_task")
        script = tmp_path / f"{pkg}_worker.py"
        script.write_text(ENV_WORKER.format(repo=str(REPO), pkg=pkg, out=out))
        proc = run_submit(pkg, ["--cluster", "local", "--num-workers", "3",
                                "--host-ip", "127.0.0.1", *extra,
                                sys.executable, str(script)])
        assert proc.returncode == 0, proc.stderr[-3000:]
        views[pkg] = [json.load(open(out + str(t))) for t in range(3)]
    for port, ref in zip(views["dmlc_core_tpu_torch"], views["dmlc_core_tpu"]):
        strip = lambda e: {k: v for k, v in e.items() if k != "DMLC_TRACKER_PORT"}  # noqa: E731
        assert strip(port["env"]) == strip(ref["env"])
        assert port["env"]["DMLC_ROLE"] == "worker"
    assert sorted(v["rank"] for v in views["dmlc_core_tpu_torch"]) == [0, 1, 2]


CRASHY_WORKER = """
import os, sys, time
sys.path.insert(0, {repo!r})
from dmlc_core_tpu_torch.tracker.client import RabitWorker

out = {out!r}
task = os.environ["DMLC_TASK_ID"]
attempt = int(os.environ["DMLC_NUM_ATTEMPT"])

def wait_for(path, deadline=30.0):
    end = time.time() + deadline
    while not os.path.exists(path):
        if time.time() > end:
            raise SystemExit("timeout waiting for " + path)
        time.sleep(0.02)

w = RabitWorker()
rank = w.start()
with open(out + "task%s_attempt%d" % (task, attempt), "w") as f:
    f.write(str(rank))
if task == "1" and attempt == 0:
    open(out + "crashed", "w").close()
    os._exit(7)
if task == "0":
    wait_for(out + "crashed")
    w.close()
    w2 = RabitWorker()
    rank = w2.start(recover_rank=rank)
    w2.shutdown()
else:
    w.shutdown()
"""


def test_worker_killed_mid_job_relaunches_with_same_rank(tmp_path):
    out = str(tmp_path / "s_")
    script = tmp_path / "crashy.py"
    script.write_text(CRASHY_WORKER.format(repo=str(REPO), out=out))
    proc = run_submit("dmlc_core_tpu_torch", [
        "--cluster", "local", "--num-workers", "2", "--local-num-attempt", "2",
        "--host-ip", "127.0.0.1", sys.executable, str(script)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert open(out + "task1_attempt0").read() == open(out + "task1_attempt1").read()
    assert os.path.exists(out + "task0_attempt0")


def test_job_abort_propagates_from_submit():
    with pytest.raises(JobAborted):
        submit.main(["--cluster", "local", "--num-workers", "1", "--local-num-attempt", "1",
                     "--host-ip", "127.0.0.1", "false"])


def test_non_rabit_command_aborts_instead_of_wedging(monkeypatch):
    monkeypatch.setenv("DMLC_RENDEZVOUS_GRACE", "0.5")
    with pytest.raises(RendezvousNeverCompleted, match="rendezvous never completed"):
        submit.main(["--cluster", "local", "--num-workers", "2", "--host-ip",
                     "127.0.0.1", "true"])


def test_ps_tracker_runs_the_scheduler_and_every_task(tmp_path):
    """With servers the PSTracker starts the scheduler; workers and
    servers get their roles and the root address."""
    out = tmp_path / "roles"
    out.mkdir()
    cmd = (f"echo $DMLC_PS_ROOT_URI:$DMLC_PS_ROOT_PORT > {out}/$DMLC_ROLE${{DMLC_TASK_ID:-}}")
    submit.main(["--cluster", "local", "--num-workers", "2", "--num-servers", "1",
                 "--host-ip", "127.0.0.1", "bash", "-c", f"'{cmd}'"])
    got = sorted(p.name for p in out.iterdir())
    assert got == ["scheduler", "server2", "worker0", "worker1"]
    roots = {p.read_text().strip() for p in out.iterdir()}
    assert len(roots) == 1 and roots.pop().startswith("127.0.0.1:")


def test_ps_tasks_launch_after_a_scheduler_that_exits_at_once(monkeypatch):
    """The PS path launches every task even when the scheduler has already
    exited (the JAX submit launches them only while it runs, a race the
    port's test above lost under load)."""
    class DoneScheduler:
        def __init__(self, **_):
            pass

        def worker_envs(self):
            return {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": 9}

        def alive(self):
            return False

    monkeypatch.setattr(port_tracker, "PSTracker", DoneScheduler)
    launched = []
    port_tracker.submit(2, 1, lambda nw, ns, envs: launched.append((nw, ns, envs)),
                        host_ip="127.0.0.1", pscmd="true")
    assert [(nw, ns) for nw, ns, _ in launched] == [(2, 1)]
    assert launched[0][2]["DMLC_PS_ROOT_PORT"] == 9


def test_dry_run_does_not_block(capsys):
    submit.main(["--cluster", "local", "--num-workers", "2", "--dry-run", "--host-ip",
                 "127.0.0.1", "python3", "t.py"])
    assert capsys.readouterr().out.count("[dry-run] local task") == 2


@pytest.mark.parametrize("flag,item", [
    (["--block-cache"], "8b"), (["--block-cache-mb", "64"], "8b"),
])
def test_unported_flags_raise_naming_the_roadmap_item(capsys, flag, item):
    """The block-cache flags, refused until ROADMAP.md §1 item 8b was
    ported, plan the JAX submit's dry run: the daemon's line when
    ``--block-cache`` is given (naming the port's tools), then the tasks;
    no process starts."""
    jax_submit = importlib.import_module("dmlc_core_tpu.tracker.submit")
    argv = ["--cluster", "local", "--num-workers", "2", "--host-ip", "127.0.0.1",
            "--dry-run", *flag, "true"]
    outs = []
    for main in (submit.main, jax_submit.main):
        main(argv)
        outs.append([line for line in capsys.readouterr().out.splitlines()
                     if line.startswith("[dry-run]")])
    port, jax = outs
    assert port == [line.replace("dmlc_core_tpu.tools", "dmlc_core_tpu_torch.tools")
                    for line in jax]
    daemon = "[dry-run] block-cache daemon: python -m dmlc_core_tpu_torch.tools cached serve"
    assert port[0] == daemon if "--block-cache" in flag else daemon not in port
    assert sum(line.startswith("[dry-run] local task") for line in port) == 2


CACHE_WORKER = """
import json, os, sys, time
sys.path.insert(0, {repo!r})
from dmlc_core_tpu_torch.io import split as io_split
from dmlc_core_tpu_torch.telemetry import default_registry
from dmlc_core_tpu_torch.tracker.client import RabitWorker

w = RabitWorker()
rank = w.start()
task = os.environ["DMLC_TASK_ID"]
if rank == 1:  # the second reader starts once the first has published
    end = time.monotonic() + 60
    while not os.path.exists({out!r} + "0"):
        assert time.monotonic() < end, "rank 0 never finished"
        time.sleep(0.05)
sp = io_split.IndexedRecordIOSplitter({rec!r}, {idx!r}, 0, 1, shuffle="window", window=200,
                                      seed=5)
n = 0
while (c := sp.next_batch_ex(256)) is not None:
    n += len(c)
sp.close()
reg = default_registry()
out = {{"rank": rank, "bytes": n, "sock": os.environ.get("DMLC_BLOCK_CACHE_SOCK", ""),
       "decodes": reg.histogram("io.codec.decode_seconds").snapshot()["count"],
       "hits": sum(reg.counter_values("io.blockcache.hits").values())}}
with open({out!r} + str(rank) + ".tmp", "w") as f:
    json.dump(out, f)
os.replace({out!r} + str(rank) + ".tmp", {out!r} + str(rank))
w.shutdown()
"""


def test_block_cache_job_decodes_each_block_once(tmp_path):
    """``submit --block-cache`` with 2 CPU workers over one zlib file:
    each task gets the daemon's socket, the second reader decodes
    nothing (every block from the daemon), so the two decode fewer than
    2 x the file's blocks, and the socket directory goes with the job."""
    from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
    from dmlc_core_tpu_torch.io.stream import FileStream

    rec, idx = str(tmp_path / "c.rec"), str(tmp_path / "c.idx")
    with FileStream(rec, "w") as f, FileStream(idx, "w") as fi:
        w = IndexedRecordIOWriter(f, fi, codec="zlib", block_bytes=1 << 12)
        for i in range(2400):
            w.write_record(b"B" + (b"%06d" % i) * 18)
        w.flush_block()
    blocks = len(split_blocks(rec, idx))
    out = str(tmp_path / "rank")
    script = tmp_path / "cache_worker.py"
    script.write_text(CACHE_WORKER.format(repo=str(REPO), rec=rec, idx=idx, out=out))
    proc = run_submit("dmlc_core_tpu_torch", [
        "--cluster", "local", "--num-workers", "2", "--host-ip", "127.0.0.1",
        "--block-cache", "--block-cache-mb", "64", sys.executable, str(script)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    ranks = [json.load(open(out + str(r))) for r in range(2)]
    sock = ranks[0]["sock"]
    assert sock and sock == ranks[1]["sock"]
    assert not os.path.exists(os.path.dirname(sock))  # torn down with the job
    assert ranks[0]["bytes"] == ranks[1]["bytes"] > 0
    assert ranks[0]["decodes"] == blocks and ranks[0]["hits"] == 0
    assert ranks[1]["decodes"] == 0 and ranks[1]["hits"] > 0
    assert ranks[0]["decodes"] + ranks[1]["decodes"] < 2 * blocks


def split_blocks(rec, idx):
    from dmlc_core_tpu_torch.io import split as io_split

    sp = io_split.IndexedRecordIOSplitter(rec, idx)
    sp.before_first()
    try:
        return list(sp._block_offs)
    finally:
        sp.close()


@pytest.mark.parametrize("flag,env", [
    (["--dsserve", "2", "--autoscale", "1:2"], {"DMLC_AUTOSCALE": "1:2"}),
    (["--autoscale", "1:2"], {"DMLC_AUTOSCALE": "1:2"}),
    (["--autoscale", "1:3", "--autoscale-cost-ceiling", "10"],
     {"DMLC_AUTOSCALE": "1:3", "DMLC_AUTOSCALE_COST_CEILING": "10.0"}),
    (["--autoscale", "2:2", "--autoscale-dwell", "3"],
     {"DMLC_AUTOSCALE": "2:2", "DMLC_AUTOSCALE_DWELL": "3.0"}),
])
def test_autoscale_flags_export_env_as_jax(monkeypatch, capsys, flag, env):
    """The autoscale flags, refused until ROADMAP.md §1 item 7b was
    ported, export the env the tracker's controller reads, as the JAX
    submit does (a dry run: no process starts)."""
    jax_submit = importlib.import_module("dmlc_core_tpu.tracker.submit")
    keys = ("DMLC_AUTOSCALE", "DMLC_AUTOSCALE_COST_CEILING", "DMLC_AUTOSCALE_DWELL",
            "DMLC_TRACE_ID")
    argv = ["--cluster", "local", "--num-workers", "1", "--host-ip", "127.0.0.1",
            "--dry-run", *flag, "true"]
    seen = []
    for main in (submit.main, jax_submit.main):
        for k in keys:
            monkeypatch.setenv(k, "")  # recorded, so the exports are undone
            monkeypatch.delenv(k)
        main(argv)
        seen.append({k: os.environ.get(k) for k in keys[:-1]})
    want = {k: env.get(k) for k in keys[:-1]}
    assert seen == [want, want]
    assert capsys.readouterr().out.count("[dry-run] local task 0") == 2


# the flags each cluster's dry run needs beyond the job's
DRY_RUN_FLAGS = {
    "local": [], "ssh": ["--host-file", "HOSTS"], "mpi": [], "sge": [], "slurm": [],
    "mesos": ["--mesos-master", "master:5050"], "kubernetes": [], "yarn": [],
    "yarn-rest": [], "tpu-pod": ["--tpu-name", "pod", "--tpu-zone", "us-central2-b"],
}


@pytest.mark.parametrize("cluster", sorted(DRY_RUN_FLAGS))
def test_submit_dry_run_prints_the_jax_output(tmp_path, monkeypatch, capsys, cluster):
    """``submit --dry-run`` on every cluster prints what the JAX submit
    prints: commands, scripts, manifests and the YARN REST context, which
    differs in the AM module string alone (``yarn-rest``: yarn with
    ``DMLC_YARN_REST`` set)."""
    jax_submit = importlib.import_module("dmlc_core_tpu.tracker.submit")
    hosts = tmp_path / "hosts"
    hosts.write_text("10.0.0.1\n10.0.0.2:2222\n")
    if cluster == "yarn-rest":
        monkeypatch.setenv("DMLC_YARN_REST", "http://rm.invalid:8088")
    else:
        monkeypatch.delenv("DMLC_YARN_REST", raising=False)
    monkeypatch.delenv("MESOS_MASTER", raising=False)
    monkeypatch.setenv("DMLC_TRACE_ID", "")  # recorded, so submit's export is undone
    flags = [str(hosts) if f == "HOSTS" else f for f in DRY_RUN_FLAGS[cluster]]
    argv = ["--cluster", cluster.replace("-rest", ""), "--num-workers", "2",
            "--num-servers", "0" if cluster == "tpu-pod" else "1", "--host-ip", "127.0.0.1",
            "--dry-run", *flags, "python", "train.py", "--name", "run 1"]
    outs = []
    for main in (submit.main, jax_submit.main):
        main(argv)
        outs.append(capsys.readouterr().out)
    port, jax = outs
    assert port and "[dry-run]" in port or cluster == "kubernetes"
    if cluster == "yarn-rest":
        assert "-m dmlc_core_tpu_torch.tracker.yarn_am" in port
        port = port.replace("dmlc_core_tpu_torch.tracker.yarn_am", "dmlc_core_tpu.tracker.yarn_am")
    assert port == jax


@pytest.mark.parametrize("cluster", ["sge", "mesos", "kubernetes", "tpu-pod", "yarn",
                                     "yarn-rest"])
def test_dry_run_golden_is_the_jax_output(cluster):
    """``tests/data/torch_submit_dry_runs.json``, which ``chip_smoke.py``'s
    backends phase holds the port's dry runs to on the card (where the
    JAX package does not run), is what the JAX submit prints now, and
    what the port's prints apart from the AM module string."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    assert cluster in chip_smoke.DRY_RUN_CLUSTERS
    golden = json.loads((REPO / chip_smoke.DRY_RUN_GOLDEN).read_text())[cluster]
    assert chip_smoke.submit_dry_run("dmlc_core_tpu.tracker.submit", cluster) == golden
    port = chip_smoke.submit_dry_run("dmlc_core_tpu_torch.tracker.submit", cluster)
    assert (chip_smoke.PORT_AM in port) == (cluster == "yarn-rest")
    assert port.replace(chip_smoke.PORT_AM, chip_smoke.JAX_AM) == golden


# -- checkpoints under the launcher -----------------------------------------------


def test_only_process_zero_writes(tmp_path):
    tree = {"w": np.arange(4, dtype=np.float32)}
    rank1 = Checkpointer(str(tmp_path / "ck"), process_index=1)
    assert rank1.save(0, tree) is None
    assert rank1.save_async(1, tree).result(30) is None
    rank1.wait()
    assert not (tmp_path / "ck").exists() or not os.listdir(tmp_path / "ck")
    rank0 = Checkpointer(str(tmp_path / "ck"), process_index=0)
    assert rank0.save(2, tree, meta={"epoch": 1}).endswith("ckpt-0000000002.bin")
    step, got = rank1.restore()  # every rank restores
    assert step == 2 and np.array_equal(got["w"], tree["w"])
    assert rank1.restore_meta() == {"epoch": 1}


@pytest.mark.parametrize("kw", [{"sharded": True}, {"process_count": 2},
                                {"process_index": 0, "process_count": 1}])
def test_sharded_checkpoints_still_raise(tmp_path, kw):
    """Sharded checkpoints are ported: each of these Checkpointers saves
    and restores, a numpy tree in the layout ``sharded`` forces or else
    as a ``.bin``. What still raises is an async sharded save over more
    than one process without a process group's store for its barriers."""
    ck = Checkpointer(str(tmp_path / "ck"), **kw)
    tree = {"w": np.arange(4, dtype=np.float32)}
    assert ck.save(0, tree).endswith(".d" if kw.get("sharded") else ".bin")
    assert np.array_equal(ck.restore()[1]["w"], tree["w"])
    if kw.get("process_count", 1) > 1:
        with pytest.raises(Error, match="init_process_group"):
            ck.save_async(1, {"w": torch.arange(4.0)})


# -- the Criteo example's collective mode --------------------------------------------

DRIVER = """
import json, os, sys
import numpy as np
sys.path.insert(0, {repo!r})
from dmlc_core_tpu_torch.examples import {name}
res = {name}.main(sys.argv[1:], device="cpu")
task = os.environ.get("DMLC_TASK_ID", "0")
np.savez({out!r} + task + ".npz", **res["params"])
with open({out!r} + task + ".json", "w") as f:
    json.dump({{k: v for k, v in res.items() if k != "params"}}, f)
"""

CRITEO_ROWS = 4 * train_criteo_rec.B + 300  # 2 full batches and a tail a rank


def run_example_job(tmp_path, name, data, n, env=(), extra=()):
    out = str(tmp_path / f"{name}_res")
    script = tmp_path / f"{name}_driver.py"
    script.write_text(DRIVER.format(repo=str(REPO), name=name, out=out))
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", **dict(env))
    proc = run_job(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit", "--cluster", "local",
         "--num-workers", str(n), "--host-ip", "127.0.0.1", *extra,
         sys.executable, str(script), data], env, str(tmp_path))
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    return [json.load(open(f"{out}{t}.json")) for t in range(n)], proc


def jax_simulation(path, params, world, epochs, sgd_path):
    """The collective job in one process with the JAX package: every
    rank's gradient by ``jax.grad`` of the JAX FM on its part's batches,
    ``[grads, 1]`` folded in ``reference_allreduce``'s order, divided by
    the contributor count, one ``sgd_update``."""
    model = JaxFM(train_criteo_rec.N_FEATURES, embed_dim=train_criteo_rec.EMBED)
    grad_fn = jax.jit(model.loss_and_grads)
    params = {k: jnp.asarray(v) for k, v in params.items()}
    dim = ravel_pytree(params)[0].size
    spec = JaxSpec(batch_size=train_criteo_rec.B, layout="ell", max_nnz=train_criteo_rec.K)
    steps = 0
    for epoch in range(epochs):
        uri = (f"{path}?index={path}.idx&shuffle=batch&batch_size={train_criteo_rec.B}"
               f"&seed=1&epoch={epoch}")
        srcs = [jax_ell_batches(uri, spec, part_index=r, num_parts=world) for r in range(world)]
        its = [iter(s) for s in srcs]
        while True:
            vecs = []
            for it in its:
                batch = next(it, None)
                if batch is None:
                    vecs.append(np.zeros(dim + 1, np.float32))
                    continue
                _, grads = grad_fn(params, batch.as_dict())
                vecs.append(np.concatenate([np.asarray(ravel_pytree(grads)[0], np.float32),
                                            np.ones(1, np.float32)]))
            summed = jax_coll.reference_allreduce(vecs, "sum", sgd_path)
            if float(summed[-1]) == 0:
                break
            unravel = ravel_pytree(params)[1]
            params = jax_sgd_update(params, unravel(jnp.asarray(summed[:-1] / summed[-1])),
                                    train_criteo_rec.LR)
            steps += 1
        for s in srcs:
            s.close()
    return {k: np.asarray(v) for k, v in params.items()}, steps


@pytest.mark.parametrize("sgd_path", ["tree", "ring"])
def test_criteo_collective_mode_matches_the_jax_simulation(tmp_path, sgd_path):
    data = str(tmp_path / "c.rec")
    train_criteo_rec.synth(data, CRITEO_ROWS)
    out = str(tmp_path / "model")
    res, _ = run_example_job(tmp_path, "train_criteo_rec", data, 2, env={
        "DMLC_SGD_EPOCHS": "2", "DMLC_SGD_PATH": sgd_path, "DMLC_SGD_OUT": out})
    models = [np.load(f"{out}.rank{r}.npz") for r in range(2)]
    assert sorted(r["rank"] for r in res) == [0, 1]
    for k in models[0].files:
        assert models[0][k].tobytes() == models[1][k].tobytes(), k
    for r in res:
        assert r["world"] == 2 and r["latest_step"] is None
        assert r["collective"]["rounds"][sgd_path] == r["gstep"] + 2  # + a zero round an epoch
    init = {k: v.detach().numpy() for k, v in FactorizationMachine(
        train_criteo_rec.N_FEATURES, train_criteo_rec.EMBED, device="cpu").params().items()}
    want, steps = jax_simulation(data, init, 2, 2, sgd_path)
    assert int(models[0]["gstep"]) == steps == 6
    for k, v in want.items():
        got = models[0][k]
        tol = 1e-4 * max(float(np.abs(v).max()), 1e-30)
        assert np.abs(got - v).max() <= tol, (k, np.abs(got - v).max(), tol)
        assert not np.array_equal(got, init[k]), f"{k} never moved"


def test_pack_state_gives_the_jax_examples_bytes(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)  # the zip entries' stamps
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=7).astype(np.float32),
              "v": rng.normal(size=(7, 3)).astype(np.float32), "b": np.float32(0.25)}
    port = train_criteo_rec.pack_state(params, 12, 1, 4096)
    assert port == jax_example("train_criteo_rec").pack_state(params, 12, 1, 4096)
    got, gstep, epoch, consumed = train_criteo_rec.unpack_state(port)
    assert (gstep, epoch, consumed) == (12, 1, 4096)
    assert all(np.array_equal(got[k], params[k]) for k in params)


# -- HIGGS under the launcher ---------------------------------------------------------


def test_higgs_trains_each_shard_and_only_rank_zero_writes(tmp_path):
    data = str(tmp_path / "h.libsvm")
    train_higgs.synth(data, rows=3000)
    res, proc = run_example_job(tmp_path, "train_higgs", data, 2, env={"DMLC_SGD_EPOCHS": "2"})
    assert [(r["rank"], r["world"], r["epochs"]) for r in res] == [(0, 2, [0, 1]),
                                                                 (1, 2, [0, 1])]
    assert res[0]["losses"] != res[1]["losses"]  # two shards, two models
    for r in (0, 1):
        assert f"rank {r} epoch 1" in proc.stdout
    ck = Checkpointer(str(tmp_path / "higgs_ckpts_torch"))
    assert ck.steps() == [0, 1]
    # the one writer is task 0: the newest checkpoint holds its model
    _, saved = ck.restore()
    params = [np.load(str(tmp_path / f"train_higgs_res{t}.npz")) for t in (0, 1)]
    for k in params[0].files:
        assert saved[k].tobytes() == params[0][k].tobytes()
        assert not np.array_equal(params[1][k], params[0][k])


# -- a live stream followed by two workers under the launcher -------------------

_STREAM_WORKER = """
import json, os, sys, time, zlib
sys.path.insert(0, {repo!r})
from dmlc_core_tpu_torch.io import split as io_split
from dmlc_core_tpu_torch.tracker.client import RabitWorker
w = RabitWorker()
rank = w.start()
sp = io_split.create(
    {d!r} + "/manifest.json?dynamic_shards=1&shuffle=window&window=64&seed=9",
    threaded=False)
events = []
sp.on_shard_done = lambda gen, shard, status: events.append([gen, shard, status])
by_gen = {{}}
theta = rows = 0
while True:
    rec = sp.next_record()
    if rec is None:
        break
    by_gen.setdefault(str(sp.generation), []).append(zlib.crc32(rec))
    theta += zlib.crc32(rec)  # an order-free integer "gradient"
    rows += 1
    time.sleep(0.002)  # the drain spans a few sample intervals
sp.close()
with open(os.path.join({out!r}, "worker-%d.json" % rank), "w") as f:
    json.dump({{"rank": rank, "rows": rows, "theta": theta, "by_gen": by_gen,
               "events": events}}, f)
w.heartbeat()  # ships the ring's samples, the stream.* gauges among them
w.shutdown()
"""

N_DRILL = 600


def test_submit_run_streaming_rotation_exactly_once(tmp_path):
    """Two port workers under the port's submit follow a stream whose
    writer rotates mid-job (``&dynamic_shards=1``): the records of each
    generation, and their order-free integer sum, equal the sealed
    shards'; every micro-shard is recorded once; the end-of-job report
    carries the stream lag that ``tools top`` renders."""
    import threading
    import zlib  # noqa: L009 (crc32 as an order-free fold, not compression)

    from dmlc_core_tpu_torch.stream import StreamWriter
    from dmlc_core_tpu_torch.stream import manifest as sm
    from dmlc_core_tpu_torch.telemetry import timeseries as ts
    from dmlc_core_tpu_torch.tools import _render_top, _top_model

    def payload(i):
        return (b"rec-%08d|" % i) * (1 + i % 4)

    d = tmp_path / "stream"
    out_dir = tmp_path / "out"
    d.mkdir()
    out_dir.mkdir()
    report_path = tmp_path / "metrics_report.json"
    script = tmp_path / "worker.py"
    script.write_text(_STREAM_WORKER.format(repo=str(REPO), d=str(d), out=str(out_dir)))

    def produce():
        with StreamWriter(str(d), codec=None, rotate_bytes=4096, commit_records=40) as w:
            for i in range(N_DRILL):
                w.append(payload(i))
                time.sleep(0.004)  # the rotations land while the workers drain

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        run = run_job([sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
                       "--cluster", "local", "--num-workers", "2", "--host-ip",
                       "127.0.0.1", sys.executable, str(script)],
                      dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
                           DMLC_TS_INTERVAL="0.1",
                           DMLC_METRICS_REPORT=str(report_path)), str(REPO))
    finally:
        t.join(RUN_S)
    assert not t.is_alive()
    assert run.returncode == 0, run.stderr[-3000:]
    outs = [json.loads(p.read_text()) for p in sorted(out_dir.iterdir())]
    assert len(outs) == 2 and {o["rank"] for o in outs} == {0, 1}
    m = sm.read_manifest(str(d))
    assert m["eos"] is True and len(m["sealed"]) >= 3, "the writer never rotated mid-job"
    sealed_by_gen, nxt = {}, 0
    for ent in m["sealed"]:
        sealed_by_gen[str(ent["gen"])] = sorted(
            zlib.crc32(payload(i)) for i in range(nxt, nxt + ent["records"]))
        nxt += ent["records"]
    assert nxt == N_DRILL
    assert sum(o["rows"] for o in outs) == N_DRILL
    for gen, want in sealed_by_gen.items():
        got = sorted(c for o in outs for c in o["by_gen"].get(gen, []))
        assert got == want, f"generation {gen} content drifted"
    assert sum(o["theta"] for o in outs) == sum(sum(v) for v in sealed_by_gen.values())
    recorded = [tuple(e[:2]) for o in outs for e in o["events"] if e[2] == "recorded"]
    assert len(recorded) == len(set(recorded)) > 0, "a micro-shard double-committed"
    assert {g for g, _ in recorded} == {int(g) for g in sealed_by_gen}
    report = json.loads(report_path.read_text())
    per_rank = report["timeseries"]["per_rank"]
    assert {"0", "1"} <= set(per_rank)
    views = {r: ts.windowed(per_rank[r], 120.0) for r in per_rank}
    assert [r for r in ("0", "1") if "stream_lag_seconds" in views[r]["derived"]], \
        "no rank shipped stream.* gauges"
    model = _top_model({"windowed": {"per_rank": views,
                                     "cluster": ts.merge_windows(views)}}, 120.0)
    assert "stream lag" in _render_top(model, "127.0.0.1:9999")
