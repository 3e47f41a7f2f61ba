"""Local backend: supervised subprocesses with retry + relaunch (the port
of ``dmlc_core_tpu/tracker/backends/local.py``).

Reference: tracker/dmlc_tracker/local.py (roles by index — first
num_workers are workers, rest servers, local.py:66-73; attempt count
exported as DMLC_NUM_ATTEMPT, local.py:26-49). All tasks run under the
shared Supervisor (supervisor.py): per-task attempt budgets
(DMLC_MAX_ATTEMPT / --local-num-attempt), job abort past the budget, and
relaunched workers recovering their rank via the tracker's ``recover``
path. A task failure returns the task's shard leases to the queue
(``shardsvc.reclaim_task``) and is pushed to the collective engines'
death watch (``collective.notify_task_failure``) before the relaunch.

``--tracker-journal DIR`` runs the tracker as a supervised subprocess
(``TrackerSupervisor``): it journals to DIR, and when it dies it is
relaunched on the same port from the same journal while the workers ride
the outage.

``--dsserve N`` starts the job's dsserve tier (``DsServeTier``): N
``python -m dmlc_core_tpu_torch.tools dsserve serve`` processes beside
the tracker, each leasing micro-shards from the job's shard service and
streaming packed slots; their endpoints reach every task as
``DMLC_DSSERVE``.

``--autoscale MIN:MAX`` sizes that tier's first fleet within the bounds,
hands every task the tier's endpoints file (``DMLC_DSSERVE_FILE``) and
registers an ``ElasticActuator`` over it, through which the tracker's
autoscale controller adds and retires servers while the job runs.

``--block-cache`` starts the host's shared decoded-block cache daemon
(``HostBlockCache``: ``python -m dmlc_core_tpu_torch.tools cached serve``
on a job-private socket, ``--block-cache-mb`` its budget) and hands every
task its socket as ``DMLC_BLOCK_CACHE_SOCK``; the daemon and its socket
directory go with the job.

``--trace-dir`` (exported
by ``submit``) reaches every task through the inherited environment; a
task the supervisor SIGKILLs leaves no trace file, since no exit hook
runs.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

from ...utils.logging import Error
from .. import autoscale as _autoscale
from .. import collective, shardsvc
from .. import tracker as _tracker
from ..supervisor import RendezvousNeverCompleted, Supervisor, default_max_attempt
from . import run_tracker_submit

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")

class HostBlockCache:
    """One shared decoded-block cache daemon for this host's tasks
    (``submit --block-cache``): spawns ``tools cached serve`` on a
    job-private socket, waits for the socket to appear, and hands its
    path to every task as ``DMLC_BLOCK_CACHE_SOCK``, so colocated workers
    over one compressed corpus decode each block once
    (``io/blockcache.py``). ``stop()`` ends the daemon (which unlinks its
    shared-memory segments) and removes the socket directory."""

    def __init__(self, budget_mb: int = 0) -> None:
        self._sock_dir = tempfile.mkdtemp(prefix="dmlc-blockcache-")
        self.sock_path = os.path.join(self._sock_dir, "cache.sock")
        cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.tools", "cached",
               "serve", "--socket", self.sock_path]
        if budget_mb:
            cmd += ["--budget-mb", str(budget_mb)]
        self._proc = subprocess.Popen(cmd)
        deadline = time.monotonic() + 30.0
        while not os.path.exists(self.sock_path):
            if self._proc.poll() is not None or time.monotonic() > deadline:
                self.stop()
                raise Error("block-cache daemon failed to start "
                            f"(socket {self.sock_path} never appeared)")
            time.sleep(0.05)
        logger.info("block-cache daemon serving %s", self.sock_path)

    def stop(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait(timeout=5)
        shutil.rmtree(self._sock_dir, ignore_errors=True)


class _DsWorker:
    """One elastic-tier worker process and its identity."""

    __slots__ = ("proc", "task_id", "port_file", "endpoint")

    def __init__(self, proc, task_id: int, port_file: str) -> None:
        self.proc = proc
        self.task_id = task_id
        self.port_file = port_file
        self.endpoint: str = ""


class DsServeTier:
    """The job's disaggregated preprocessing tier (``dmlc-submit
    --dsserve N``): N ``tools dsserve serve`` worker processes next to
    the tracker, each leasing micro-shards from the job's shard service
    (``envs`` carries the tracker address) and streaming packed slots.
    Endpoints are collected from per-server port files and handed to
    every worker as ``DMLC_DSSERVE`` so payloads can open
    ``dsserve://$DMLC_DSSERVE/<dataset-uri>``; ``stop()`` tears the
    tier down with the job. Lease identities start at task id 1000 so
    they can never collide with trainer ranks (a collision would let a
    trainer heartbeat renew a server's leases).

    The tier is elastic: ``add_worker`` spawns one more server,
    ``retire_worker`` SIGTERMs the newest one (the server finishes its
    shard, releases its leases and exits; past the grace window it is
    killed and ``shardsvc.release_task`` frees its leases immediately).
    The live membership is mirrored into ``endpoints_file`` — an
    atomically rewritten JSON the clients poll via ``DMLC_DSSERVE_FILE``
    so a mid-epoch spawn gets dialed without waiting for the next epoch.
    The autoscale controller calls them through ``ElasticActuator``."""

    def __init__(
        self, n: int, envs: Dict[str, object], host: str = "127.0.0.1"
    ) -> None:
        self._dir = tempfile.mkdtemp(prefix="dmlc-dsserve-")
        self._lock = threading.Lock()
        self._envs = {str(k): str(v) for k, v in envs.items()}
        self._host = host
        self._next_id = 1000
        self._workers: List[_DsWorker] = []
        self._retirees: List[_DsWorker] = []
        self.endpoints_file = os.path.join(self._dir, "endpoints.json")
        try:
            spawned = [self._spawn() for _ in range(n)]
            deadline = time.monotonic() + 15.0
            for w in spawned:
                self._await_port(w, deadline)
        except BaseException:
            self.stop()
            raise
        self._write_endpoints()
        logger.info("dsserve tier serving at %s", self.endpoints)

    @property
    def endpoints(self) -> str:
        with self._lock:
            return ",".join(w.endpoint for w in self._workers if w.endpoint)

    def _spawn(self) -> _DsWorker:
        with self._lock:
            task_id = self._next_id
            self._next_id += 1
        pf = os.path.join(self._dir, f"server{task_id}.port")
        env = os.environ.copy()
        env.update(self._envs)
        env["DMLC_TASK_ID"] = str(task_id)
        proc = subprocess.Popen([
            sys.executable, "-m", "dmlc_core_tpu_torch.tools", "dsserve",
            "serve", "--host", self._host, "--port", "0",
            "--port-file", pf,
        ], env=env)
        w = _DsWorker(proc, task_id, pf)
        with self._lock:
            self._workers.append(w)
        return w

    def _await_port(self, w: _DsWorker, deadline: float) -> None:
        while not os.path.exists(w.port_file):
            if (w.proc.poll() is not None
                    or time.monotonic() > deadline):
                raise RuntimeError(
                    f"dsserve worker task {w.task_id} failed to start "
                    f"(port file {w.port_file} never appeared)"
                )
            time.sleep(0.05)
        with open(w.port_file) as f:
            ep = json.load(f)
        w.endpoint = f"{ep['host']}:{ep['port']}"

    def _write_endpoints(self) -> None:
        """Atomic rewrite (tmp + rename, the write_port_file idiom) so
        a client's discovery poll can never read a partial list."""
        with self._lock:
            eps = [w.endpoint for w in self._workers if w.endpoint]
        tmp = self.endpoints_file + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"endpoints": eps}, f)
        os.replace(tmp, self.endpoints_file)

    def n_live(self) -> int:
        with self._lock:
            return sum(
                1 for w in self._workers
                if w.endpoint and w.proc.poll() is None
            )

    def add_worker(self, timeout: float = 15.0) -> str:
        """Scale-up actuation: one more server, blocking until it binds
        (so the controller's actual-fleet gauge is truthful by its next
        tick) and published to the discovery file."""
        w = self._spawn()
        try:
            self._await_port(w, time.monotonic() + timeout)
        except BaseException:
            with self._lock:
                if w in self._workers:
                    self._workers.remove(w)
            if w.proc.poll() is None:
                w.proc.kill()
                w.proc.wait()
            raise
        self._write_endpoints()
        logger.info(
            "dsserve tier scaled up: +%s (task %d)", w.endpoint, w.task_id
        )
        return w.endpoint

    def retire_worker(self, grace: float = 30.0) -> Optional[str]:
        """Scale-down actuation: SIGTERM the newest live worker — the
        server's retire path finishes its current shard, EPOCH_ENDs its
        streams, releases its leases and exits zero. A worker that
        outlives ``grace`` is killed and its leases released through
        ``shardsvc.release_task`` so nothing waits out a TTL. Returns
        the retired endpoint, or None when the tier is empty."""
        with self._lock:
            live = [w for w in self._workers if w.proc.poll() is None]
            if not live:
                return None
            w = live[-1]
            self._workers.remove(w)
            self._retirees.append(w)
        self._write_endpoints()
        try:
            w.proc.send_signal(signal.SIGTERM)
        except OSError:
            pass
        threading.Thread(
            target=self._reap, args=(w, grace), daemon=True,
            name="dsserve-retire",
        ).start()
        logger.info(
            "dsserve tier retiring %s (task %d)", w.endpoint, w.task_id
        )
        return w.endpoint

    def _reap(self, w: _DsWorker, grace: float) -> None:
        try:
            w.proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            logger.warning(
                "dsserve worker task %d ignored retire for %.0fs; killing "
                "and releasing its leases", w.task_id, grace,
            )
            w.proc.kill()
            w.proc.wait()
            shardsvc.release_task(w.task_id, self._host)

    def stop(self) -> None:
        with self._lock:
            procs = [w.proc for w in self._workers + self._retirees]
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        shutil.rmtree(self._dir, ignore_errors=True)


class TrackerSupervisor:
    """The durable control plane (``--tracker-journal DIR``): the tracker
    runs as a ``python -m dmlc_core_tpu_torch.tracker.tracker``
    subprocess journaling every control-plane transition (shard grants
    and dones, rank assignments) to DIR, and this supervisor treats it
    like a task: ``watch()`` is polled from the submit loop, and an
    unexpected death (a crash, an OOM kill, a SIGKILL) relaunches the
    tracker on the SAME port with the SAME journal directory. The new
    tracker replays the snapshot and the WAL, expires every lease
    conservatively and re-answers ``recover``; the workers ride
    ``connect_worker_retry`` through the outage."""

    def __init__(self, host_ip: str, n_workers: int, journal_dir: str,
                 port: int = 9091, port_end: int = 9999) -> None:
        self.host_ip = host_ip
        self.n_workers = n_workers
        self.journal_dir = journal_dir
        self._dir = tempfile.mkdtemp(prefix="dmlc-tracker-")
        self.endpoint_file = os.path.join(self._dir, "tracker.json")
        self._stopping = False
        self.relaunches = 0
        self.proc = self._spawn(port, port_end)
        self.host, self.port = self._await_endpoint()
        logger.info("supervised tracker serving %s:%d (journal %s)",
                    self.host, self.port, self.journal_dir)

    def _spawn(self, port: int, port_end: int) -> subprocess.Popen:
        try:
            os.remove(self.endpoint_file)
        except OSError:
            pass
        return subprocess.Popen([
            sys.executable, "-m", "dmlc_core_tpu_torch.tracker.tracker",
            "--host-ip", self.host_ip,
            "--port", str(port), "--port-end", str(port_end),
            "--num-workers", str(self.n_workers),
            "--journal", self.journal_dir,
            "--endpoint-file", self.endpoint_file,
        ])

    def _await_endpoint(self, timeout: float = 15.0):
        deadline = time.monotonic() + timeout
        while not os.path.exists(self.endpoint_file):
            if self.proc.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError(
                    "supervised tracker failed to start (endpoint file "
                    f"{self.endpoint_file} never appeared)")
            time.sleep(0.05)
        with open(self.endpoint_file) as f:
            ep = json.load(f)
        return str(ep["host"]), int(ep["port"])

    def envs(self) -> Dict[str, object]:
        return {"DMLC_TRACKER_URI": self.host, "DMLC_TRACKER_PORT": self.port}

    def watch(self) -> bool:
        """One supervision poll: True while the tracker serves (after
        relaunching it if it died), False once it exited cleanly (exit
        0: the rendezvous completed and the job is done)."""
        ret = self.proc.poll()
        if ret is None:
            return True
        if self._stopping or ret == 0:
            return False
        self.relaunches += 1
        logger.warning(
            "tracker died (exit %s); relaunching on port %d from "
            "journal %s (relaunch #%d)",
            ret, self.port, self.journal_dir, self.relaunches)
        # pinned range [port, port+1): the workers redial the address
        # they already hold, so the new tracker MUST own it
        self.proc = self._spawn(self.port, self.port + 1)
        self.host, self.port = self._await_endpoint()
        return True

    def stop(self) -> None:
        self._stopping = True
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        shutil.rmtree(self._dir, ignore_errors=True)


class ElasticActuator:
    """The local backend's arm of the autoscale loop: the controller's
    fleet verbs mapped onto the tier (registered through
    ``autoscale.set_actuator``, so the controller needs no backend
    import). The bounds live in the controller; this only actuates."""

    def __init__(self, tier: DsServeTier, retire_grace: float = 30.0) -> None:
        self.tier = tier
        self.retire_grace = retire_grace

    def actual(self) -> int:
        return self.tier.n_live()

    def add_task(self) -> bool:
        return bool(self.tier.add_worker())

    def retire_task(self) -> bool:
        return self.tier.retire_worker(self.retire_grace) is not None


def _supervised_submit(args, launch_all, checks: List) -> None:
    """The ``--tracker-journal`` form of the submit wait loop: the
    tracker in a supervised subprocess instead of in this process, so a
    control-plane crash is a recoverable event, not the job's end."""
    ip = _tracker.get_host_ip(args.host_ip or "auto")
    sup = TrackerSupervisor(ip, args.num_workers, args.tracker_journal)
    envs = _tracker.worker_env(args.num_workers, 0)
    envs.update(sup.envs())
    try:
        launch_all(args.num_workers, 0, envs)
        while sup.watch():
            time.sleep(0.1)
            err = checks[0]() if checks else None
            if err is not None:
                if isinstance(err, RendezvousNeverCompleted):
                    # every task exited 0 and a shard-only job has no
                    # rendezvous to complete; across the process boundary
                    # the exit codes are the verdict
                    logger.info("job finished without a rabit rendezvous "
                                "(supervised tracker, all tasks exited 0)")
                    break
                raise err
    finally:
        sup.stop()


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
    checks: List = []
    cache: Optional[HostBlockCache] = None
    dsserve: Optional[DsServeTier] = None

    def launch_all(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        nonlocal cache, dsserve
        n_ds = int(getattr(args, "dsserve", 0) or 0)
        if args.dry_run:
            if getattr(args, "block_cache", False):
                print("[dry-run] block-cache daemon: "
                      "python -m dmlc_core_tpu_torch.tools cached serve")
            for i in range(n_ds):
                print(f"[dry-run] dsserve worker {i}: "
                      "python -m dmlc_core_tpu_torch.tools dsserve serve")
            for i in range(nworker + nserver):
                role = "worker" if i < nworker else "server"
                print(f"[dry-run] local task {i} role={role}: "
                      f"{' '.join(args.command)}")
            return
        if getattr(args, "block_cache", False):
            cache = HostBlockCache(getattr(args, "block_cache_mb", 0))
            envs = dict(envs)
            envs["DMLC_BLOCK_CACHE_SOCK"] = cache.sock_path
        # --autoscale min:max sizes the first fleet here and registers
        # the actuator; the tracker's controller reads the same bounds
        # from DMLC_AUTOSCALE, which submit exported before the tracker
        # started
        as_bounds = None
        if getattr(args, "autoscale", ""):
            lo, sep, hi = str(args.autoscale).partition(":")
            as_bounds = (int(lo), int(hi if sep else lo))
            n_ds = max(as_bounds[0], min(as_bounds[1], n_ds or as_bounds[0]))
        if n_ds > 0:
            dsserve = DsServeTier(n_ds, envs,
                                  host=getattr(args, "dsserve_host", "127.0.0.1"))
            envs = dict(envs)
            envs["DMLC_DSSERVE"] = dsserve.endpoints
            if as_bounds is not None:
                envs["DMLC_DSSERVE_FILE"] = dsserve.endpoints_file
                _autoscale.set_actuator(ElasticActuator(dsserve))
        # --local-num-attempt retries == max_attempt total runs - 1
        # (reference local.py retry budget); DMLC_MAX_ATTEMPT wins if set.
        # localhost is one shared host, not a failure domain — per-task
        # budgets apply but blacklisting is disabled.
        sup = Supervisor(
            make_launcher(list(args.command), nworker, envs),
            hosts=["localhost"],
            max_attempt=default_max_attempt(args.local_num_attempt + 1),
            host_fail_limit=float("inf"),
            # a dead worker's shard leases go back to the queue NOW and
            # its collective peers learn of the death NOW (each a no-op
            # when the job never leased or never opened a watch)
            on_task_failure=[shardsvc.reclaim_task,
                             collective.notify_task_failure],
        )
        if nserver:
            # the PS tracker waits on its scheduler alone, which may exit
            # before the tasks have run: run them to their end here, so
            # the job ends when both have
            sup.run(nworker + nserver)
            return
        checks.append(sup.run_in_thread(nworker, "local-supervisor"))

    try:
        if (getattr(args, "tracker_journal", None)
                and int(getattr(args, "num_servers", 0) or 0) == 0
                and not args.dry_run):
            _supervised_submit(args, launch_all, checks)
        else:
            run_tracker_submit(
                args, launch_all,
                abort_check=lambda: checks[0]() if checks else None,
            )
    finally:
        _autoscale.set_actuator(None)
        if dsserve is not None:
            dsserve.stop()
        if cache is not None:
            cache.stop()
