"""The dynamic shard service: a tracker-leased work queue over
micro-shards (the port of ``dmlc_core_tpu/tracker/shardsvc.py``, whole:
the same wire form, ledger rules, journal records and metric names, so a
port tracker serves JAX lease clients and the reverse).

Static sharding fixes ``part_index/num_parts`` at open, so a multi-worker
epoch waits for its slowest worker. Here the tracker hands out shard
*placement* as leases, while shard *content* stays the static planner's:

- the data set is cut into ``K x num_workers`` micro-shards
  (``DMLC_SHARD_OVERSPLIT``, default 4). Micro-shard ``i`` of ``M`` is
  ``(part_index=i, num_parts=M)`` of the static splitter, so its bytes
  and its ``(seed, epoch)`` order are those of a static run over ``M``
  parts; only which worker drains it changes;
- ``ShardLedger`` grants leases with a time to live over the rendezvous
  framing (``cmd=shard_lease|shard_renew|shard_done|shard_release``,
  ``protocol.py``), renews them on an explicit renew and on the
  ``cmd=metrics`` heartbeat, and takes them back on expiry, on a task
  failure the supervisor reports (``reclaim_task``) or on a voluntary
  ``shard_release`` (a heartbeat would otherwise renew an abandoned
  lease for ever). The FIRST ``shard_done`` of a shard is recorded, a
  later one answers ``duplicate``;
- a worker that dies mid-lease costs the epoch one lease TTL: the shard
  goes back to the queue front and the next idle worker steals it.

Committed work is exactly-once (commit on the ``recorded`` answer); a
record may be emitted twice only when a live holder outlives its TTL
without renewing (renewal rides every pull and every heartbeat).

Telemetry (the tracker's registry, under the JAX names):
``tracker.shards.queue_depth`` gauge,
``tracker.shards.leases_granted|renewed|reclaimed|stolen`` and
``tracker.shards.completions|duplicates`` counters and the
``tracker.shards.shard_seconds`` grant→done histogram.

Numpy-free and torch-free: sockets, JSON and the telemetry registry.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..io.retry import is_transient as _is_transient
from ..telemetry import default_registry as _default_registry
from ..telemetry import tracing as _tracing
from . import journal as _jn
from .protocol import (
    CMD_SHARD_DONE,
    CMD_SHARD_LEASE,
    CMD_SHARD_RELEASE,
    CMD_SHARD_RENEW,
    connect_worker_retry,
    default_tracker_retry_secs,
)

__all__ = [
    "ShardLedger",
    "ShardService",
    "ShardLeaseClient",
    "default_oversplit",
    "default_lease_ttl",
    "active_service",
    "reclaim_task",
]


def default_oversplit() -> int:
    """``DMLC_SHARD_OVERSPLIT`` (micro-shards per worker, default 4):
    higher = finer-grained stealing (a straggler strands at most one
    micro-shard of work) at the cost of more lease round-trips and more
    window restarts; 1 degenerates to static-sized shards that can
    still move between workers."""
    try:
        return max(1, int(os.environ.get("DMLC_SHARD_OVERSPLIT", "4")))
    except ValueError:
        return 4


def default_lease_ttl() -> float:
    """``DMLC_SHARD_LEASE_TTL`` seconds (default 30): how long a granted
    lease survives without a renew before the ledger reclaims it. Renewal
    rides every driver pull and every ``cmd=metrics`` heartbeat, so the
    TTL only has to outlive a *stall*, not a shard drain."""
    try:
        return max(0.1, float(os.environ.get("DMLC_SHARD_LEASE_TTL", "30")))
    except ValueError:
        return 30.0


class _Lease:
    __slots__ = ("shard", "rank", "lease_id", "granted", "expires", "stolen")

    def __init__(
        self, shard: int, rank: int, lease_id: int, granted: float, ttl: float
    ) -> None:
        self.shard = shard
        self.rank = rank
        self.lease_id = lease_id
        self.granted = granted
        self.expires = granted + ttl
        self.stolen = False


class ShardLedger:
    """One epoch's exactly-once micro-shard ledger (caller locks).

    States per shard: queued (in ``self.queue``) → leased
    (``self.leases``) → done (``self.done``). A reclaimed shard goes
    BACK to the queue front (it has been waiting longest); its next
    grant to a different rank counts as stolen. Completions are
    recorded exactly once — ``record_done`` answers ``recorded`` for
    the first finisher regardless of current lease ownership (the
    holder may legitimately finish after its lease expired and was
    re-granted; first finisher wins, the other's later done is a
    ``duplicate``)."""

    def __init__(self, epoch: int, n_shards: int) -> None:
        self.epoch = epoch
        self.n_shards = n_shards
        self.queue: deque = deque(range(n_shards))
        self.leases: Dict[int, _Lease] = {}  # shard -> live lease
        self.done: Dict[int, int] = {}  # shard -> completing rank
        self.reclaimed_from: Dict[int, int] = {}  # shard -> last holder
        self.granted = 0
        self.reclaimed = 0
        self.stolen = 0
        self.duplicates = 0
        self._next_lease_id = 0

    # -- queries -------------------------------------------------------------
    def complete(self) -> bool:
        return len(self.done) == self.n_shards

    def queue_depth(self) -> int:
        return len(self.queue)

    # -- transitions (caller holds the service lock) -------------------------
    def reclaim_expired(self, now: float) -> List[int]:
        """Return every expired lease's shard to the queue front."""
        expired = [l for l in self.leases.values() if l.expires <= now]
        for lease in expired:
            del self.leases[lease.shard]
            self.reclaimed_from[lease.shard] = lease.rank
            self.queue.appendleft(lease.shard)
            self.reclaimed += 1
        return [l.shard for l in expired]

    def reclaim_rank(self, rank: int) -> List[int]:
        """Immediately reclaim every lease held by ``rank`` (supervisor
        failure/quarantine hook — don't wait out the TTL)."""
        held = [l for l in self.leases.values() if l.rank == rank]
        for lease in held:
            del self.leases[lease.shard]
            self.reclaimed_from[lease.shard] = lease.rank
            self.queue.appendleft(lease.shard)
            self.reclaimed += 1
        return [l.shard for l in held]

    def grant(self, rank: int, now: float, ttl: float) -> Optional[_Lease]:
        """Pop the next queued shard into a lease for ``rank``; None
        when nothing is grantable right now. Callers must run
        ``reclaim_expired(now)`` first — reclaim stays single-sited so
        the service's leases_reclaimed counter can't diverge from the
        ledger's accounting."""
        # skip (discard) shards that completed while queued: a reclaimed
        # holder may finish late — record_done marks it done but the
        # queue entry survives, and re-granting it would re-emit every
        # record of an already-committed shard
        shard = None
        while self.queue:
            cand = self.queue.popleft()
            if cand not in self.done:
                shard = cand
                break
        if shard is None:
            return None
        self._next_lease_id += 1
        lease = _Lease(shard, rank, self._next_lease_id, now, ttl)
        self.leases[shard] = lease
        self.granted += 1
        prev = self.reclaimed_from.get(shard)
        if prev is not None and prev != rank:
            self.stolen += 1
            lease.stolen = True
        return lease

    def renew_rank(self, rank: int, now: float, ttl: float) -> int:
        """Extend every lease ``rank`` still holds; returns the count
        (0 = all lost to expiry — the holder must re-lease)."""
        n = 0
        for lease in self.leases.values():
            if lease.rank == rank and lease.expires > now:
                lease.expires = now + ttl
                n += 1
        return n

    def release(self, shard: int, rank: int) -> bool:
        """Voluntary hand-back of an UNFINISHED lease (driver close /
        mid-epoch restart): back to the queue front like a reclaim —
        the shard was partially drained, so it must be re-served in
        full — but only if ``rank`` still holds it (a thief's live
        lease is not voided by the loser's late release)."""
        lease = self.leases.get(shard)
        if lease is None or lease.rank != rank or shard in self.done:
            return False
        del self.leases[shard]
        self.reclaimed_from[shard] = rank
        self.queue.appendleft(shard)
        self.reclaimed += 1
        return True

    def record_done(self, shard: int, rank: int, now: float):
        """Exactly-once completion; returns ("recorded", secs) for the
        first finisher (secs = grant→done of the finisher's lease when
        it still holds one, else None) or ("duplicate", None)."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range [0,{self.n_shards})")
        if shard in self.done:
            self.duplicates += 1
            return "duplicate", None
        if shard not in self.leases and shard not in self.reclaimed_from:
            # every legitimate finisher leaves a trace: a live lease, or
            # a reclaim/steal record. A done with no grant history is a
            # client bug — accepting it would mark undrained data
            # complete and the epoch would finish with a silent hole.
            raise ValueError(
                f"shard {shard} was never granted; refusing to mark it done"
            )
        self.done[shard] = rank
        lease = self.leases.pop(shard, None)
        secs = None
        if lease is not None and lease.rank == rank:
            secs = max(0.0, now - lease.granted)
        return "recorded", secs

    def wait_hint(self, now: float) -> float:
        """Suggested client backoff while everything is leased: half the
        soonest expiry (bounded) — sooner is pointless, later wastes the
        reclaim."""
        if not self.leases:
            return 0.05
        soonest = min(l.expires for l in self.leases.values())
        return min(1.0, max(0.05, (soonest - now) / 2.0))


class ShardService:
    """Thread-safe shard lease service riding the tracker.

    ``handle(cmd, rank, payload)`` maps one JSON request frame to one
    JSON response frame (see ShardLeaseClient for the client half) and
    never raises — malformed input costs that request an ``error``
    response, not the tracker a thread. Epochs are created on first
    request and capped at ``keep_epochs`` live ledgers (a completed
    epoch's ``done`` answer survives until it ages out)."""

    #: ledgers kept live; laggard requests for older epochs get "done"
    #: if the epoch completed, else an error (a 9-epochs-stale worker
    #: has left the job in every practical sense)
    keep_epochs = 8

    def __init__(
        self,
        n_workers: int,
        oversplit: Optional[int] = None,
        ttl: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        journal=None,
    ) -> None:
        self.n_workers = n_workers
        self.oversplit = oversplit if oversplit else default_oversplit()
        self.ttl = ttl if ttl is not None else default_lease_ttl()
        self._clock = clock
        #: optional tracker/journal.py Journal: ledger transitions that
        #: matter for exactly-once are appended BEFORE the response is
        #: sent, so a tracker relaunch replays to a state every client
        #: ack is consistent with
        self._journal = journal
        self._lock = threading.Lock()
        self._epochs: Dict[int, ShardLedger] = {}
        self._completed: Dict[int, bool] = {}  # aged-out epochs
        #: micro-shard count, pinned at the first ledger so a mid-job
        #: n_workers resize can't change shard geometry under live
        #: leases (shard content must stay deterministic for the epoch)
        self.n_shards: Optional[int] = None
        #: dataset signature pinned by the first lease request that
        #: carries one: mismatched workers fail loudly instead of
        #: draining differently-sharded bytes
        self._fileset: Optional[str] = None
        #: launcher task id (the jobid workers send at rendezvous) →
        #: rendezvous rank; fed by the tracker at rank assignment so
        #: the supervisor's task-keyed reclaim hook lands on the rank
        #: the leases were actually granted to (ranks are connect-order)
        self._task_rank: Dict[str, int] = {}
        #: counters folded out of evicted ledgers so summary() stays
        #: whole-job truthful past keep_epochs epochs
        self._retired = {
            "epochs": 0, "granted": 0, "reclaimed": 0,
            "stolen": 0, "completed": 0, "duplicates": 0,
        }
        reg = _default_registry()
        self._c_granted = reg.counter(
            "tracker.shards.leases_granted",
            help="micro-shard leases granted",
        )
        self._c_renewed = reg.counter(
            "tracker.shards.leases_renewed",
            help="lease extensions (explicit renew + metrics heartbeat)",
        )
        self._c_reclaimed = reg.counter(
            "tracker.shards.leases_reclaimed",
            help="leases reclaimed on expiry or supervisor failure",
        )
        self._c_stolen = reg.counter(
            "tracker.shards.leases_stolen",
            help="reclaimed micro-shards re-granted to a different worker",
        )
        self._c_completed = reg.counter(
            "tracker.shards.completions",
            help="micro-shards recorded done (exactly-once)",
        )
        self._c_duplicate = reg.counter(
            "tracker.shards.duplicates",
            help="shard_done for an already-completed micro-shard",
        )
        self._g_queue = reg.gauge(
            "tracker.shards.queue_depth",
            help="unleased micro-shards in the newest epoch's queue",
        )
        self._h_shard_secs = reg.histogram(
            "tracker.shards.shard_seconds",
            help="per-micro-shard grant→done seconds",
        )

    # -- ledger plumbing (lock held) -----------------------------------------
    def _ledger(self, epoch: int) -> Optional[ShardLedger]:
        led = self._epochs.get(epoch)
        if led is not None:
            return led
        if epoch in self._completed:
            return None  # aged out; _completed remembers the outcome
        # an epoch BEHIND the live window has aged out: creating it
        # would immediately evict it below and grant() would hand out
        # leases from an orphaned ledger whose dones can never land
        if self._epochs and epoch < max(self._epochs) - self.keep_epochs + 1:
            return None
        if self.n_shards is None:
            self.n_shards = self.oversplit * max(1, self.n_workers)
        led = ShardLedger(epoch, self.n_shards)
        self._epochs[epoch] = led
        while len(self._epochs) > self.keep_epochs:
            oldest = min(self._epochs)
            dropped = self._epochs[oldest]
            now = self._clock()
            if not dropped.complete() and any(
                l.expires > now for l in dropped.leases.values()
            ):
                # evicting would strand live leaseholders (their renews
                # and dones would hit a vanished ledger). A worker 8+
                # epochs ahead of a live-leased laggard has left the job
                # in practice — refuse ITS epoch instead
                del self._epochs[epoch]
                return None
            self._epochs.pop(oldest)
            self._completed[oldest] = dropped.complete()
            self._fold_retired(dropped)
            if len(self._completed) > 64:
                self._completed.pop(min(self._completed))
        return led

    def _fold_retired(self, led: ShardLedger) -> None:
        r = self._retired
        r["epochs"] += 1
        r["granted"] += led.granted
        r["reclaimed"] += led.reclaimed
        r["stolen"] += led.stolen
        r["completed"] += len(led.done)
        r["duplicates"] += led.duplicates

    def _fold_retired_all(self) -> None:
        for led in self._epochs.values():
            self._fold_retired(led)

    def _update_queue_gauge(self) -> None:
        if self._epochs:
            self._g_queue.set(self._epochs[max(self._epochs)].queue_depth())

    # -- operations ----------------------------------------------------------
    def lease(self, rank: int, epoch: int, fileset: Optional[str]) -> Dict:
        with self._lock:
            if fileset:
                if self._fileset is None:
                    self._fileset = fileset
                elif fileset != self._fileset:
                    # sequential dataset switch (train → validation):
                    # once every live ledger fully drained, a new
                    # signature starts fresh — epochs AND geometry reset
                    # (the old epochs' "done" answers belong to the old
                    # dataset and must not empty the new one's drain).
                    # An incomplete ledger means workers are draining
                    # DIFFERENT datasets concurrently — that stays loud.
                    if all(l.complete() for l in self._epochs.values()):
                        self._fold_retired_all()
                        self._epochs.clear()
                        self._completed.clear()
                        self.n_shards = None
                        self._fileset = fileset
                        if self._journal is not None:
                            self._journal.append(
                                _jn.K_DATASET_SWITCH, fileset=fileset
                            )
                    else:
                        return {
                            "status": "error",
                            "error": f"fileset signature {fileset!r} does "
                            f"not match the job's {self._fileset!r} — "
                            "workers are not reading the same dataset",
                        }
            led = self._ledger(epoch)
            if led is None:
                done = self._completed.get(epoch, False)
                return {"status": "done"} if done else {
                    "status": "error",
                    "error": f"epoch {epoch} aged out of the ledger",
                }
            now = self._clock()
            reclaimed = led.reclaim_expired(now)
            if reclaimed:
                self._c_reclaimed.inc(len(reclaimed))
            lease = led.grant(rank, now, self.ttl)
            if lease is None:
                self._update_queue_gauge()
                if led.complete():
                    return {"status": "done"}
                return {"status": "wait", "backoff": round(led.wait_hint(now), 3)}
            self._c_granted.inc()
            if lease.stolen:
                self._c_stolen.inc()
            if self._journal is not None:
                self._journal.append(
                    _jn.K_SHARD_GRANT, epoch=epoch, shard=lease.shard,
                    rank=rank, fileset=self._fileset,
                    n_shards=led.n_shards,
                )
            self._update_queue_gauge()
            return {
                "status": "lease",
                "shard": lease.shard,
                "num_shards": led.n_shards,
                "lease_id": lease.lease_id,
                "ttl": self.ttl,
                "epoch": epoch,
            }

    def renew(self, rank: int, epoch: int) -> Dict:
        with self._lock:
            led = self._epochs.get(epoch)
            if led is None:
                return {"status": "lost", "renewed": 0}
            n = led.renew_rank(rank, self._clock(), self.ttl)
            if n:
                self._c_renewed.inc(n)
            return {"status": "ok" if n else "lost", "renewed": n}

    def _stale_fileset(self, fileset: Optional[str]) -> Optional[Dict]:
        """A state-mutating request carrying a signature that is not the
        job's CURRENT dataset is a straggler from before a dataset
        switch — epoch numbers restart at the switch, so without this
        check its shard numbers land on the new ledger and mark
        undrained validation data complete (caller holds the lock)."""
        if fileset and self._fileset is not None and fileset != self._fileset:
            return {
                "status": "error",
                "error": f"fileset signature {fileset!r} is not the job's "
                f"current dataset {self._fileset!r} — stale request from "
                "before a dataset switch",
            }
        return None

    def done(self, rank: int, epoch: int, shard: int,
             fileset: Optional[str] = None) -> Dict:
        with self._lock:
            stale = self._stale_fileset(fileset)
            if stale is not None:
                return stale
            led = self._epochs.get(epoch)
            if led is None:
                done = self._completed.get(epoch, False)
                return {"status": "duplicate" if done else "error",
                        **({} if done else {"error": f"epoch {epoch} aged out"})}
            try:
                status, secs = led.record_done(shard, rank, self._clock())
            except ValueError as e:
                return {"status": "error", "error": str(e)}
            if status == "recorded":
                self._c_completed.inc()
                if secs is not None:
                    self._h_shard_secs.observe(secs)
                if self._journal is not None:
                    # journaled before the ack: once a worker hears
                    # "recorded", no tracker relaunch un-records it
                    self._journal.append(
                        _jn.K_SHARD_DONE, epoch=epoch, shard=shard,
                        rank=rank,
                    )
            else:
                self._c_duplicate.inc()
            self._update_queue_gauge()
            return {"status": status, "epoch_complete": led.complete()}

    def release(self, rank: int, epoch: int, shard: int,
                fileset: Optional[str] = None) -> Dict:
        """Driver abandonment (close / mid-epoch restart): return the
        unfinished shard to the queue NOW. Without this, the TTL
        fallback alone is not enough — a process whose rabit heartbeat
        keeps running after its source closed would renew the abandoned
        lease forever and livelock its peers on ``wait``."""
        with self._lock:
            stale = self._stale_fileset(fileset)
            if stale is not None:
                return stale
            led = self._epochs.get(epoch)
            if led is None:
                return {"status": "ok", "released": 0}
            released = led.release(int(shard), rank)
            if released:
                self._c_reclaimed.inc()
                if self._journal is not None:
                    self._journal.append(
                        _jn.K_SHARD_RELEASE, epoch=epoch,
                        shard=int(shard), rank=rank,
                    )
            self._update_queue_gauge()
            return {"status": "ok", "released": int(released)}

    def renew_all(self, rank: int) -> None:
        """Heartbeat-path renewal: extend ``rank``'s leases in every
        live epoch (cmd=metrics arrives without an epoch number)."""
        with self._lock:
            now = self._clock()
            n = 0
            for led in self._epochs.values():
                n += led.renew_rank(rank, now, self.ttl)
            if n:
                self._c_renewed.inc(n)

    def reclaim_rank(self, rank: int) -> int:
        """Supervisor hook: a task just failed/was quarantined — return
        its leases to the queue NOW instead of waiting out the TTL."""
        with self._lock:
            n = 0
            for led in self._epochs.values():
                shards = led.reclaim_rank(rank)
                n += len(shards)
            if n:
                self._c_reclaimed.inc(n)
            self._update_queue_gauge()
            return n

    def release_rank(self, rank: int) -> int:
        """Voluntary rank-wide hand-back — the retire path's cooperative
        twin of ``reclaim_rank``: a departing
        leaseholder (autoscale scale-down, operator drain) returns every
        lease it still holds across all live epochs. Shards it already
        streamed stay committed, and a ``record_done`` that lands after
        the release is still honored through ``reclaimed_from`` — the
        exactly-once contract survives the retire."""
        return self.reclaim_rank(rank)

    def note_task_rank(self, jobid: str, rank: int) -> None:
        """Tracker feed at rank assignment: launcher task id (the jobid
        of the rendezvous preamble) → rendezvous rank, so task-keyed
        supervisor reclaim can translate into the lease identity space
        (leases are held by rendezvous rank once RabitWorker.start()
        exported DMLC_SHARD_RANK)."""
        if jobid and jobid != "NULL":
            with self._lock:
                self._task_rank[str(jobid)] = rank

    def resolve_task(self, task_id: int) -> int:
        """Launcher task id → lease-holder rank; identity when no
        rendezvous mapping was recorded (shard-only payloads lease
        under DMLC_TASK_ID, so task id IS the rank there)."""
        with self._lock:
            return self._task_rank.get(str(task_id), task_id)

    # -- crash recovery (tracker/journal.py) ----------------------------------
    def restore(self, state: Dict) -> Dict:
        """Rebuild the ledgers from a journal fold (tracker restart with
        ``--tracker-journal``). Completions are restored verbatim —
        exactly-once survives the crash. Every granted-but-not-done
        shard is **conservatively expired**: no lease is recreated (the
        holder may be gone, and its connection certainly is), the shard
        re-enters the queue FRONT, and its grant history lands in
        ``reclaimed_from`` so the old holder's late ``record_done`` is
        still honored instead of rejected as never-granted. Returns a
        summary for the end-of-job report's ``recovery`` section."""
        sh = (state or {}).get("shards") or {}
        with self._lock:
            self._fileset = sh.get("fileset")
            if sh.get("n_shards"):
                self.n_shards = int(sh["n_shards"])
            restored_done = 0
            expired = 0
            for estr, ep in sorted(
                (sh.get("epochs") or {}).items(), key=lambda kv: int(kv[0])
            ):
                epoch = int(estr)
                n = int(self.n_shards or 0)
                if n <= 0:
                    continue  # grants imply a pinned geometry; skip noise
                led = ShardLedger(epoch, n)
                done = {
                    int(s): int(r) for s, r in (ep.get("done") or {}).items()
                }
                outstanding = {
                    int(s): int(r)
                    for s, r in (ep.get("outstanding") or {}).items()
                    if int(s) not in done
                }
                led.done = done
                led.reclaimed_from.update(outstanding)
                # queue: expired grants first (they have been waiting
                # longest), then never-granted shards — no duplicates,
                # or a shard could be double-leased after recovery
                led.queue = deque(
                    sorted(outstanding)
                    + [
                        s for s in range(n)
                        if s not in done and s not in outstanding
                    ]
                )
                led.granted = len(done) + len(outstanding)
                led.reclaimed = len(outstanding)
                self._epochs[epoch] = led
                restored_done += len(done)
                expired += len(outstanding)
            self._update_queue_gauge()
            return {
                "epochs": len(self._epochs),
                "completions_restored": restored_done,
                "leases_expired": expired,
                "fileset": self._fileset,
                "n_shards": self.n_shards,
            }

    # -- wire adapter ---------------------------------------------------------
    def handle(self, cmd: str, rank: int, payload: str) -> str:
        """One request frame → one response frame; never raises."""
        try:
            if rank < 0:
                # negatives are protocol placeholders (print/NULL
                # clients), never lease holders. Ranks ABOVE n_workers
                # are legal: shard geometry was pinned at the first
                # lease, so an extra worker joining mid-epoch just
                # drains the queue faster (the elastic-join contract)
                return json.dumps({
                    "status": "error",
                    "error": f"shard request from invalid rank {rank}",
                })
            req = json.loads(payload) if payload else {}
            if not isinstance(req, dict):
                raise ValueError("payload must be a JSON object")
            epoch = int(req.get("epoch", 0))
            if cmd == CMD_SHARD_LEASE:
                out = self.lease(rank, epoch, req.get("fileset"))
            elif cmd == CMD_SHARD_RENEW:
                out = self.renew(rank, epoch)
            elif cmd == CMD_SHARD_DONE:
                out = self.done(rank, epoch, int(req["shard"]),
                                req.get("fileset"))
            elif cmd == CMD_SHARD_RELEASE:
                out = self.release(rank, epoch, int(req["shard"]),
                                   req.get("fileset"))
            else:
                out = {"status": "error", "error": f"unknown shard cmd {cmd!r}"}
        except (ValueError, KeyError, TypeError) as e:
            out = {"status": "error", "error": f"bad shard request: {e}"}
        return json.dumps(out, separators=(",", ":"))

    def all_complete(self) -> bool:
        """True when shard work actually happened AND every live ledger
        is fully accounted. This gates submit's downgrade of
        RendezvousNeverCompleted to a clean finish: shard chatter alone
        must not pass a partial epoch (workers that exited 0 mid-epoch
        on a swallowed error) off as a completed job."""
        with self._lock:
            if self.n_shards is None or not self._epochs:
                return False
            return all(l.complete() for l in self._epochs.values())

    def summary(self) -> Dict[str, object]:
        """End-of-job shape for the tracker report / diag tools."""
        with self._lock:
            newest = self._epochs[max(self._epochs)] if self._epochs else None
            r = self._retired  # evicted ledgers still count (long jobs)
            return {
                "n_shards": self.n_shards,
                "oversplit": self.oversplit,
                "ttl": self.ttl,
                "epochs": sorted(self._epochs),
                "epochs_retired": r["epochs"],
                "granted": r["granted"]
                + sum(l.granted for l in self._epochs.values()),
                "reclaimed": r["reclaimed"]
                + sum(l.reclaimed for l in self._epochs.values()),
                "stolen": r["stolen"]
                + sum(l.stolen for l in self._epochs.values()),
                "completed": r["completed"]
                + sum(len(l.done) for l in self._epochs.values()),
                "duplicates": r["duplicates"]
                + sum(l.duplicates for l in self._epochs.values()),
                "queue_depth": newest.queue_depth() if newest else 0,
            }


# -- process-global active service (supervisor hook) --------------------------

_active_lock = threading.Lock()
_active: Optional[ShardService] = None


def set_active(service: Optional[ShardService]) -> None:
    """Register the submit process's live shard service (RabitTracker
    start/close). The supervisor's failure hook resolves it lazily so
    supervisor.py stays free of tracker wiring."""
    global _active
    with _active_lock:
        _active = service


def active_service() -> Optional[ShardService]:
    with _active_lock:
        return _active


def reclaim_task(task_id: int, host: str) -> None:
    """Supervisor ``on_task_failure`` hook: reclaim the failed task's
    leases immediately. The task id is translated into the lease-holder
    rank through the tracker-fed mapping (rendezvous ranks are assigned
    in connect order, so they need not equal DMLC_TASK_ID); without a
    mapping the task id is the rank (shard-only payloads lease under
    DMLC_TASK_ID). No-op when no shard service is live."""
    service = active_service()
    if service is not None:
        service.reclaim_rank(service.resolve_task(task_id))


def release_task(task_id: int, host: str = "") -> None:
    """Elastic-retire escalation hook: a retiring worker that had to be
    killed gets its leases released NOW instead of waiting out the TTL
    (``DsServeTier.retire_worker``'s kill branch). Same task→rank translation as
    ``reclaim_task``; no-op when no shard service is live."""
    service = active_service()
    if service is not None:
        service.release_rank(service.resolve_task(task_id))


# -- worker-side client --------------------------------------------------------


class ShardLeaseClient:
    """Worker half of the lease protocol: one short-lived connection per
    call, exactly the ``cmd=print``/``cmd=metrics`` connection shape
    (client.py), plus ONE JSON response frame.

    ``rank`` defaults to ``DMLC_SHARD_RANK`` — set by
    ``RabitWorker.start()`` to the rendezvous-assigned rank, so lease
    ownership and the ``cmd=metrics`` heartbeat (which renews leases BY
    rendezvous rank) live in the same identity space — else
    ``DMLC_TASK_ID`` (shard-only payloads never heartbeat, and the
    launcher's task id is what the supervisor reclaim hook uses). A
    defaulted rank is re-read from the environment at every ``lease()``
    — a lease is an identity pinning point — so a client constructed
    BEFORE ``start()`` still leases under the rendezvous rank once the
    drain begins, instead of freezing the pre-rendezvous task id and
    losing every heartbeat renewal. Tracker address defaults to
    ``DMLC_TRACKER_URI``/``DMLC_TRACKER_PORT``."""

    def __init__(
        self,
        tracker_uri: Optional[str] = None,
        tracker_port: Optional[int] = None,
        rank: Optional[int] = None,
        timeout: float = 30.0,
    ) -> None:
        self.tracker_uri = tracker_uri or os.environ["DMLC_TRACKER_URI"]
        self.tracker_port = int(
            tracker_port
            if tracker_port is not None
            else os.environ["DMLC_TRACKER_PORT"]
        )
        self._explicit_rank = rank is not None
        self.rank = rank if rank is not None else self._env_rank()
        self.timeout = timeout

    @staticmethod
    def _env_rank() -> int:
        try:
            return int(
                os.environ.get("DMLC_SHARD_RANK")
                or os.environ.get("DMLC_TASK_ID", "0")
            )
        except ValueError:
            return 0

    def _call(self, cmd: str, payload: Dict,
              retry_secs: Optional[float] = None) -> Dict:
        # the piggybacked trace context binds the tracker's handler
        # span to whatever wait span encloses this call (the
        # shard_lease_wait stall gets its causal arrow on a merged
        # timeline). The retrying dial rides out
        # a tracker crash+relaunch window (DMLC_TRACKER_RETRY_SECS):
        # lease/renew/done are all safe to redial — the request frame
        # is only sent on a COMPLETED handshake, and record_done is
        # exactly-once on the tracker side either way
        budget = (
            default_tracker_retry_secs()
            if retry_secs is None else float(retry_secs)
        )
        deadline = time.monotonic() + budget
        delay = 0.05
        while True:
            remaining = max(0.0, deadline - time.monotonic())
            fs = connect_worker_retry(
                self.tracker_uri, self.tracker_port, self.rank, -1,
                "NULL", cmd, self.timeout,
                trace_ctx=_tracing.rpc_context(), retry_secs=remaining,
            )
            try:
                fs.send_str(json.dumps(payload, separators=(",", ":")))
                resp = json.loads(fs.recv_str())
                if not isinstance(resp, dict):
                    raise ConnectionError(
                        "malformed shard service response"
                    )
                return resp
            except (ConnectionError, OSError) as e:
                # the dial is retried above, but the tracker can also
                # die BETWEEN the completed handshake and the response
                # (chaos SIGKILL mid-RPC): redial the WHOLE call within
                # the same budget — safe because every shard RPC is
                # idempotent tracker-side (record_done is exactly-once,
                # a replayed lease/renew/release just re-answers)
                if not _is_transient(e) or time.monotonic() >= deadline:
                    raise
                _tracing.instant(
                    "dmlc:tracker_reconnect", cmd=cmd, rank=self.rank,
                    attempt=-1, error=type(e).__name__,
                )
                time.sleep(
                    min(delay, max(0.0, deadline - time.monotonic()))
                )
                delay = min(2.0, delay * 2)
            finally:
                fs.close()

    def lease(self, epoch: int, fileset: Optional[str] = None) -> Dict:
        if not self._explicit_rank:
            # renew/done/release keep the rank the live lease was
            # granted under; a NEW lease is the safe re-pin point
            self.rank = self._env_rank()
        req: Dict = {"epoch": epoch}
        if fileset:
            req["fileset"] = fileset
        return self._call(CMD_SHARD_LEASE, req)

    def renew(self, epoch: int,
              retry_secs: Optional[float] = None) -> Dict:
        return self._call(
            CMD_SHARD_RENEW, {"epoch": epoch}, retry_secs=retry_secs
        )

    def done(self, epoch: int, shard: int,
             fileset: Optional[str] = None) -> Dict:
        req: Dict = {"epoch": epoch, "shard": shard}
        if fileset:
            req["fileset"] = fileset
        return self._call(CMD_SHARD_DONE, req)

    def release(self, epoch: int, shard: int,
                fileset: Optional[str] = None,
                retry_secs: Optional[float] = None) -> Dict:
        """``retry_secs`` bounds the reconnect budget: teardown paths
        pass a SHORT one — a release is worth a few redials (a dropped
        release leaves the shard to the lease TTL), but a closing
        process must not hang out the full crash-recovery window."""
        req: Dict = {"epoch": epoch, "shard": shard}
        if fileset:
            req["fileset"] = fileset
        return self._call(CMD_SHARD_RELEASE, req, retry_secs=retry_secs)
