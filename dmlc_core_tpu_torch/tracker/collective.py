"""Worker-side fault-tolerant collective engine over the tracker topology
(the port of ``dmlc_core_tpu/tracker/collective.py``; its frames are the
JAX package's byte for byte, so a port engine and a JAX engine can share
a round).

The tracker assigns ranks and computes the binomial-tree + shared-edge
ring maps (topology.py) and ``RabitWorker`` wires real TCP links along
them — this module is the missing worker half that made dmlc-core the
foundation of rabit/XGBoost: ``allreduce`` / ``broadcast`` over those
links, with rabit-parity fault tolerance (version-numbered rounds,
bootstrap-from-peer recovery, instant peer-death notification).

Data plane
----------
- **Tree path** (default for small payloads): contributions flow up the
  binomial tree (each node folds its own buffer with its children's
  partials in ascending-rank order), the root holds the result, and the
  result floods back down the tree. The flood is source-exclusive over
  an acyclic graph, so the same rule implements ``broadcast`` from any
  root: the root seeds the result and every rank forwards it to all
  tree links except the one it arrived on.
- **Ring path** (large payloads, ``DMLC_ALLREDUCE_RING_BYTES``):
  classic bandwidth-optimal reduce-scatter + allgather over the shared-
  edge ring (``get_link_map`` relabels ranks so ring-next is rank+1).
- Reducers are NumPy ufuncs (sum/max/min — the "native kernels" here:
  one vectorized C call per fold, no per-element Python) or any
  elementwise ``f(acc, contrib) -> array`` callable.
- Reduction order is DETERMINISTIC given (world, path) and is simulated
  exactly by :func:`reference_allreduce`, so tests pin bit-identity.
  Tree and ring fold in different orders — float sums may differ across
  paths by rounding (min/max and integer sums never do).

Fault tolerance
---------------
Every collective call is a **round** tagged with a sequence number that
doubles as the model version (``seq`` = completed rounds). Per round:

- Peer links carry framed messages with IO timeouts; link errors are
  classified by the transient classifier (``io/retry.is_transient``
  shapes: resets, EOF, timeouts → recoverable peer death; anything else
  re-raises).
- On a dead link the survivor closes it, floods ``RESET(seq, attempt)``
  over its remaining tree links (attempt-numbered so floods cannot
  loop), re-enters the tracker rendezvous
  (``RabitWorker.start(recover_rank=rank)``) so the relaunched peer —
  or the surviving peer after a link blip — is re-brokered, and retries
  the round from its saved input. Ring rounds that fault retry over the
  tree (the ring's partial reductions are unrecoverable mid-flight).
- Completed rounds are cached (last ``DMLC_COLLECTIVE_CACHE``, default
  8): a rank that already finished round *r* answers any late
  ``DATA``/``RESET`` for *r* with the cached ``RESULT``, which is what
  lets ranks that completed a round serve ranks that lost it — no rank
  can be more than one allreduce round ahead (the round is a barrier),
  and replay after ``checkpoint`` every K steps needs a cache ≥ K.
- Peer death is discovered INSTANTLY via the supervisor's
  ``on_task_failure`` observer → tracker push: the engine keeps one
  persistent ``cmd=watch`` connection; the tracker-side
  :class:`DeathWatch` (registered process-globally like the shard
  service) fans each failure notice out to every live watcher, whose
  watch thread half-closes the dead peer's link so the blocked round
  recv fails NOW instead of at the timeout backstop.
- ``checkpoint(state)`` keeps the latest model bytes in memory (rabit's
  ``lazy_checkpoint``: serialize-on-demand, no disk); a relaunched
  worker calls ``load_checkpoint()`` which asks its tree neighbors for
  their newest (seq, version, state) and adopts the best — bootstrap-
  from-peer, then deterministic replay through the result cache until
  it rejoins the live round.

Chaos injection (the JAX package's ``io/faults.py`` grammar applied to
peer links):
``DMLC_COLLECTIVE_FAULTS="resets=N,delay_ms=M,spikes=K,seed=S"`` injects
seeded mid-round link resets and slow-peer delays;
``kill_seq=Q,kill_rank=R,kill_phase=start|sent[,kill_attempt=A]``
SIGKILLs rank R at an exact point inside round Q — the chaos drill's
mid-round worker death (the spec is one env var shared by every worker,
so the kill names its victim). Fired faults tick the global
``faults_injected`` counter.

Counters: the engine's own (``io_stats()``: rounds by path, recoveries,
payload bytes, seconds waiting on peer links) and, under the JAX
package's names, the registry series ``tracker.collective.rounds{path}``,
``tracker.collective.recoveries``, ``tracker.collective.bytes`` and the
``tracker.collective.link_wait_seconds`` histogram. Each round runs
under a ``dmlc:allreduce_wait`` span; every frame header carries the
sender's flight-recorder flow id, which the receiver lands as the
arrow's finish (0 when the recorder is off).

Env knobs: DMLC_COLLECTIVE_TIMEOUT (300 s zero-progress backstop),
DMLC_ALLREDUCE_RING_BYTES (65536), DMLC_COLLECTIVE_CACHE (8),
DMLC_COLLECTIVE_LINGER (0.5 s close-time stale-serve window),
DMLC_COLLECTIVE_WATCH (1).
"""

from __future__ import annotations

import json
import os
import select
import signal
import socket
import struct
import threading
import time
import weakref
from collections import OrderedDict
from random import Random
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from ..io.retry import _env_float, count_fault_injected, is_transient
from ..telemetry import default_registry as _default_registry
from ..telemetry import tracing as _tracing
from ..utils.logging import Error
from . import topology
from .client import RabitWorker
from .protocol import CMD_WATCH, FramedSocket, connect_worker_retry

__all__ = [
    "Collective",
    "DeathWatch",
    "reference_allreduce",
    "set_active_watch",
    "active_watch",
    "notify_task_failure",
]

#: the round paths the engine counts (``Collective.rounds``)
_PATHS = ("tree", "ring", "bcast", "local")

_registry = _default_registry()
_ROUNDS = {
    path: _registry.counter(
        "tracker.collective.rounds",
        help="collective rounds completed",
        labels={"path": path},
    )
    for path in _PATHS
}
_RECOVERIES = _registry.counter(
    "tracker.collective.recoveries",
    help="dead-link recoveries (reset flood + re-rendezvous)",
)
_BYTES = _registry.counter(
    "tracker.collective.bytes", help="payload bytes reduced/broadcast"
)
_LINK_WAIT = _registry.histogram(
    "tracker.collective.link_wait_seconds",
    help="blocking peer-link wait per collective round",
)

# -- peer-link wire framing ----------------------------------------------------
# One fixed header per message; payloads are raw ndarray bytes (dtype
# and shape are call-site contract — every rank passes the same). The
# seq field tags the round; aux carries the ring step / reset attempt /
# checkpoint version; flow is the sender's flight-recorder flow id
# (0 = recorder off), landed by the receiver inside its wait span.
_FRAME_MAGIC = 0x44434C31  # "DCL1"
_HDR = struct.Struct("<IBIIqQ")  # magic u32, kind u8, seq u32, aux u32, nbytes i64, flow u64
_MAX_PAYLOAD = 1 << 31

K_DATA = 1  # child -> parent reduce contribution (tree)
K_RESULT = 2  # the round's result, flooding the tree (also = broadcast)
K_RESET = 3  # abandon the round's partial state and retry (aux=attempt)
K_RS = 4  # ring reduce-scatter step (aux=step)
K_AG = 5  # ring allgather step (aux=step)
K_CKREQ = 6  # bootstrap: send me your newest checkpoint
K_CK = 7  # bootstrap reply (seq=stored seq, aux=version, payload=state)
K_ERR = 8  # unrecoverable protocol reply (e.g. round result aged out)


class _LinkDied(Exception):
    """A peer link failed a send/recv with a transient-shaped error."""

    def __init__(self, rank: int, cause: Optional[BaseException] = None):
        super().__init__(f"link to rank {rank} died: {cause!r}")
        self.rank = rank
        self.cause = cause


class _RingAborted(Exception):
    """Ring round faulted/reset mid-flight; retry over the tree."""


_OPS: Dict[str, Callable] = {
    "sum": np.add,
    "max": np.maximum,
    "min": np.minimum,
}


def _resolve_op(op: Union[str, Callable]) -> Callable:
    if callable(op):
        return op
    try:
        return _OPS[op]
    except KeyError:
        raise Error(
            f"unknown reducer {op!r} (sum/max/min or an elementwise "
            "f(acc, contrib) callable)"
        ) from None


def _segment_bounds(size: int, world: int) -> List[Tuple[int, int]]:
    """np.array_split boundaries: first ``size % world`` segments one
    element larger (shared with reference_allreduce so the ring fold
    order is pinned in one place)."""
    base, rem = divmod(size, world)
    bounds = []
    lo = 0
    for i in range(world):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def reference_allreduce(
    arrays: List[np.ndarray], op: Union[str, Callable] = "sum",
    path: str = "tree",
) -> np.ndarray:
    """Single-process NumPy simulator of the engine's EXACT reduction
    order — the bit-identity oracle the tests pin allreduce against.

    ``tree``: partial(v) = left-fold of [own] + children partials in
    ascending child-rank order over ``topology.get_link_map``'s tree;
    the result is partial(root). ``ring``: the reduce-scatter /
    allgather loops below mirror ``Collective._run_ring`` step for
    step (segment j folds ranks j, j+1, ... mod n in that order)."""
    n = len(arrays)
    reducer = _resolve_op(op)
    flats = [np.ascontiguousarray(a).reshape(-1) for a in arrays]
    shape = np.asarray(arrays[0]).shape
    if n == 1:
        return flats[0].copy().reshape(shape)
    if path == "tree":
        tree, parent, _ring = topology.get_link_map(n)

        def partial(v: int) -> np.ndarray:
            acc = flats[v]
            for c in sorted(x for x in tree[v] if x != parent[v]):
                acc = reducer(acc, partial(c))
            return acc

        out = np.array(partial(0), copy=True)
        return out.reshape(shape)
    if path != "ring":
        raise Error(f"unknown path {path!r} (tree|ring)")
    bufs = [f.copy() for f in flats]
    bounds = _segment_bounds(flats[0].size, n)
    for step in range(n - 1):
        outgoing = {
            r: bufs[r][slice(*bounds[(r - step) % n])].copy() for r in range(n)
        }
        for r in range(n):
            prev = (r - 1) % n
            lo, hi = bounds[(r - step - 1) % n]
            bufs[r][lo:hi] = reducer(outgoing[prev], bufs[r][lo:hi])
    for step in range(n - 1):
        outgoing = {
            r: bufs[r][slice(*bounds[(r + 1 - step) % n])].copy()
            for r in range(n)
        }
        for r in range(n):
            prev = (r - 1) % n
            lo, hi = bounds[(r - step) % n]
            bufs[r][lo:hi] = outgoing[prev]
    return bufs[0].reshape(shape)


# -- tracker-side death watch --------------------------------------------------


class DeathWatch:
    """Tracker half of instant peer-death notification: holds every
    worker's persistent ``cmd=watch`` connection and fans supervisor
    failure reports out to them as one JSON string frame each.

    Lives on the RabitTracker and is registered process-globally
    (``set_active_watch``) exactly like the shard service, so the
    supervisor's ``on_task_failure`` observer list can name
    :func:`notify_task_failure` without tracker wiring."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._watchers: Dict[int, FramedSocket] = {}
        self._task_rank: Dict[str, int] = {}
        self.notices = 0

    def add(self, rank: int, fs: FramedSocket) -> None:
        with self._lock:
            old = self._watchers.pop(rank, None)
            self._watchers[rank] = fs
        if old is not None:
            old.close()

    def note_task_rank(self, jobid: str, rank: int) -> None:
        """Failure reports are task-keyed; watch pushes are rank-keyed
        (same translation the shard service records)."""
        with self._lock:
            self._task_rank[str(jobid)] = rank

    def notify(self, task_id: int, host: str = "") -> None:
        """Push a peer-death notice to every live watcher except the
        dead rank's own (possibly stale) connection. Broken watcher
        connections are dropped — a dead watcher must not block the
        fan-out to live ones."""
        with self._lock:
            rank = self._task_rank.get(str(task_id))
            items = list(self._watchers.items())
        if rank is None:
            try:
                rank = int(task_id)
            except (TypeError, ValueError):
                rank = -1  # unknown task: fan out to everyone
        msg = json.dumps(
            {"dead_rank": rank, "task_id": task_id, "host": host},
            separators=(",", ":"),
        )
        dead = []
        for r, fs in items:
            if r == rank:
                continue
            try:
                fs.send_str(msg)
            except (OSError, ConnectionError):
                dead.append((r, fs))
        if dead:
            with self._lock:
                for r, fs in dead:
                    if self._watchers.get(r) is fs:
                        del self._watchers[r]
            for _r, fs in dead:
                fs.close()
        self.notices += 1

    def close(self) -> None:
        with self._lock:
            items = list(self._watchers.values())
            self._watchers.clear()
        for fs in items:
            fs.close()


_active_lock = threading.Lock()
_active: Optional[DeathWatch] = None


def set_active_watch(watch: Optional[DeathWatch]) -> None:
    """Register the submit process's live death watch (RabitTracker
    start/close)."""
    global _active
    with _active_lock:
        _active = watch


def active_watch() -> Optional[DeathWatch]:
    with _active_lock:
        return _active


def notify_task_failure(task_id: int, host: str = "") -> None:
    """Supervisor ``on_task_failure`` observer: push the death notice
    to every watching worker NOW. No-op when no tracker (and therefore
    no death watch) is live in this process."""
    watch = active_watch()
    if watch is not None:
        watch.notify(task_id, host)


# -- peer-link chaos injection -------------------------------------------------


class _PeerChaos:
    """Seeded fault schedule for peer links (the JAX ``io/faults.py``
    grammar applied to the collective's wire): ``resets=N`` half-closes
    a seeded link at seeded round ordinals (both sides then exercise
    the full reset-flood + re-rendezvous recovery), ``delay_ms=M`` /
    ``spikes=K`` injects slow-peer stalls, and ``kill_seq=Q,
    kill_rank=R,kill_phase=start|sent[,kill_attempt=A]`` SIGKILLs rank
    R at an exact point inside round Q — mid-round worker death on
    demand.
    Schedules fold the rank into the seed so each worker draws its own
    deterministic sequence. Every fired fault counts into the global
    ``faults_injected`` counter next to the healed recoveries."""

    def __init__(self, spec: str, rank: int) -> None:
        args: Dict[str, str] = {}
        for kv in spec.split(","):
            if not kv:
                continue
            k, _, v = kv.partition("=")
            args[k.strip()] = v.strip()
        known = {
            "resets", "delay_ms", "spikes", "seed", "kill_seq",
            "kill_phase", "kill_attempt", "kill_rank",
        }
        unknown = sorted(set(args) - known)
        if unknown:
            raise Error(f"unknown DMLC_COLLECTIVE_FAULTS option(s) {unknown}")

        def num(key: str, default: int) -> int:
            raw = args.get(key)
            if raw is None:
                return default
            try:
                return int(raw)
            except ValueError:
                raise Error(
                    f"DMLC_COLLECTIVE_FAULTS {key}={raw!r} is not an integer"
                ) from None

        self.rank = rank
        self.delay_ms = num("delay_ms", 0)
        self.kill_seq = num("kill_seq", -1)
        # the fault spec is one env var exported to EVERY worker; the
        # drill wants exactly one mid-round death, so the kill targets
        # one rank (-1 = whichever rank hits kill_seq first = all)
        self.kill_rank = num("kill_rank", -1)
        self.kill_phase = args.get("kill_phase", "sent")
        if self.kill_phase not in ("start", "sent"):
            raise Error(
                f"kill_phase={self.kill_phase!r} must be start|sent"
            )
        self.kill_attempt = num("kill_attempt", 0)
        resets = num("resets", 0)
        spikes = num("spikes", 2 if self.delay_ms else 0)
        rng = Random((num("seed", 0), rank).__repr__())
        kinds = ["reset"] * resets + ["delay"] * spikes
        rng.shuffle(kinds)
        self.events: Dict[int, str] = {}
        ordinal = 0
        for kind in kinds:
            ordinal += 1 + rng.randint(1, 2)  # every 2-3 rounds
            self.events[ordinal] = kind
        self._rng = rng
        self._rounds = 0

    @classmethod
    def from_env(cls, rank: int) -> Optional["_PeerChaos"]:
        spec = os.environ.get("DMLC_COLLECTIVE_FAULTS", "")
        return cls(spec, rank) if spec else None

    def _attempt(self) -> int:
        try:
            return int(os.environ.get("DMLC_NUM_ATTEMPT", "0"))
        except ValueError:
            return 0

    def _maybe_kill(self, seq: int, phase: str) -> None:
        if (
            seq == self.kill_seq
            and phase == self.kill_phase
            and self._attempt() == self.kill_attempt
            and self.kill_rank in (-1, self.rank)
        ):
            count_fault_injected()
            os.kill(os.getpid(), signal.SIGKILL)

    def on_round_start(self, eng: "Collective", seq: int) -> None:
        self._maybe_kill(seq, "start")
        self._rounds += 1
        kind = self.events.pop(self._rounds, None)
        if kind is None:
            return
        count_fault_injected()
        if kind == "delay":
            time.sleep(self.delay_ms / 1000.0)
            return
        live = sorted(eng.worker.links)
        if not live:
            return
        target = live[self._rng.randrange(len(live))]
        try:
            eng.worker.links[target].shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def on_sent_parent(self, seq: int) -> None:
        self._maybe_kill(seq, "sent")


# -- the engine ----------------------------------------------------------------


class _Round:
    """Per-round mutable state (one collective call's attempt loop)."""

    def __init__(
        self,
        seq: int,
        flat: Optional[np.ndarray],
        reducer: Optional[Callable],
        template: np.ndarray,
    ) -> None:
        self.seq = seq
        self.flat = flat  # this rank's contribution (None for broadcast)
        self.reducer = reducer
        self.dtype = template.dtype
        self.shape = template.shape
        self.nbytes = template.nbytes
        self.attempt = 0
        self.contrib: Dict[int, np.ndarray] = {}
        self.sent_parent = False
        self.result: Optional[bytes] = None
        self.result_src: Optional[int] = None
        self.ring_in: Dict[Tuple[int, int], bytes] = {}
        self.reset_abort = False

    def clear_partial(self) -> None:
        self.contrib.clear()
        self.sent_parent = False
        self.ring_in.clear()


class _Send(threading.Thread):
    """One frame sent on a helper thread (a ring segment) while the engine
    receives; ``wait`` re-raises the send's error."""

    def __init__(self, eng: "Collective", rank: int, kind: int, seq: int,
                 aux: int, payload: bytes) -> None:
        super().__init__(daemon=True, name=f"collective-send-{eng.rank}")
        self._eng = eng
        self._frame = (rank, kind, seq, aux, payload)
        self._sock = eng.worker.links.get(rank)
        self.error: Optional[BaseException] = None
        self.start()

    def run(self) -> None:
        try:
            self._eng._send_frame(*self._frame)
        except BaseException as e:  # re-raised on the engine's thread
            self.error = e

    def wait(self) -> None:
        self.join()
        if self.error is not None:
            raise self.error

    def abandon(self) -> None:
        """The round is over without this send's result: give the peer
        ``io_timeout`` to drain it, else shut the link down under it."""
        self.join(self._eng.io_timeout)
        if self.is_alive() and self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self.join(5.0)


class Collective:
    """One worker's collective engine over an already-rendezvoused
    :class:`RabitWorker` (construct after ``worker.start()``). One app
    thread drives rounds; a daemon watch thread only ever half-closes a
    link the tracker reports dead. See the module docstring for the
    protocol."""

    def __init__(
        self,
        worker: RabitWorker,
        io_timeout: Optional[float] = None,
        ring_bytes: Optional[int] = None,
    ) -> None:
        if worker.rank < 0:
            raise Error("Collective requires a completed worker.start()")
        self.worker = worker
        self.rank = worker.rank
        self.world = worker.world_size
        self.io_timeout = (
            io_timeout
            if io_timeout is not None
            else _env_float("DMLC_COLLECTIVE_TIMEOUT", 300.0)
        )
        self.ring_bytes = (
            ring_bytes
            if ring_bytes is not None
            else int(_env_float("DMLC_ALLREDUCE_RING_BYTES", 1 << 16))
        )
        #: completed rounds == the engine's version clock
        self.seq = 0
        #: counters (``io_stats()``): dead-link recoveries, completed
        #: rounds by path, payload bytes reduced or broadcast, and the
        #: seconds spent inside collective calls waiting on peer links
        self.recoveries = 0
        self.rounds: Dict[str, int] = dict.fromkeys(_PATHS, 0)
        self.bytes = 0
        self.link_wait_secs = 0.0
        cache = int(_env_float("DMLC_COLLECTIVE_CACHE", 8))
        self._cache_cap = max(1, cache)
        self._results: "OrderedDict[int, bytes]" = OrderedDict()
        # lazy_checkpoint store: (seq at checkpoint, app version, state)
        self._state: Tuple[int, int, Optional[bytes]] = (0, 0, None)
        # frames for rounds ahead of us: (seq, kind, peer, aux) -> bytes
        self._early: Dict[Tuple[int, int, int, int], bytes] = {}
        self._ck_replies: Dict[int, Tuple[int, int, bytes]] = {}
        self._chaos = _PeerChaos.from_env(self.rank)
        self._send_locks: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._locks_guard = threading.Lock()
        self._closed = False
        self._watch_fs: Optional[FramedSocket] = None
        self._start_watch()

    def io_stats(self) -> Dict[str, object]:
        """The engine's counters: ``rounds`` by path, ``recoveries``,
        ``bytes`` and ``link_wait_secs``."""
        return {"rounds": dict(self.rounds), "recoveries": self.recoveries,
                "bytes": self.bytes, "link_wait_secs": self.link_wait_secs}

    # -- topology views (stable for a fixed world size) -----------------------
    @property
    def _children(self) -> List[int]:
        return sorted(
            r for r in self.worker.tree_neighbors if r != self.worker.parent
        )

    @property
    def _tree_links(self) -> List[int]:
        return sorted(set(self.worker.tree_neighbors))

    # -- public API -----------------------------------------------------------
    def allreduce(
        self,
        arr: np.ndarray,
        op: Union[str, Callable] = "sum",
        path: Optional[str] = None,
    ) -> np.ndarray:
        """Elementwise allreduce of ``arr`` across all ranks; every rank
        passes the same shape/dtype and receives the identical result.
        ``path``: tree (default for small payloads), ring (bandwidth-
        optimal for payloads >= DMLC_ALLREDUCE_RING_BYTES), or None for
        the size-based choice. Fault-tolerant per the module docstring;
        faulted ring rounds retry over the tree."""
        a = np.ascontiguousarray(arr)
        reducer = _resolve_op(op)
        if self.world == 1:
            out = a.copy()
            self._finish_round(out.tobytes(), "local")
            return out
        if path is None:
            path = "ring" if a.nbytes >= self.ring_bytes else "tree"
        if path not in ("tree", "ring"):
            raise Error(f"unknown path {path!r} (tree|ring)")
        seq = self.seq
        ctx = _Round(seq, a.reshape(-1), reducer, a)
        self.bytes += a.nbytes
        _BYTES.inc(a.nbytes)
        t0 = time.perf_counter()
        with _tracing.span("dmlc:allreduce_wait", seq=seq, path=path):
            self._round_prologue(ctx)
            # a round whose attempt already advanced (a link died during
            # the prologue, or a peer's RESET flood arrived early) is a
            # FAULTED round: every peer that heard the reset falls back
            # to the tree, so this rank must too — re-entering the ring
            # against tree-mode peers deadlocks until the timeout
            if path == "ring" and ctx.attempt == 0:
                try:
                    result = self._run_ring(ctx)
                except _RingAborted:
                    ctx.clear_partial()
                    result = self._run_tree(ctx)
            else:
                result = self._run_tree(ctx)
        dt = time.perf_counter() - t0
        self.link_wait_secs += dt
        _LINK_WAIT.observe(dt)
        self._finish_round(result, path)
        return (
            np.frombuffer(result, dtype=ctx.dtype).reshape(ctx.shape).copy()
        )

    def broadcast(self, arr: np.ndarray, root: int = 0) -> np.ndarray:
        """Broadcast ``root``'s buffer to every rank (non-root ``arr``
        is the shape/dtype prototype). Implemented as the tree result
        flood seeded at ``root`` — works from any root because the
        flood is source-exclusive over an acyclic graph."""
        a = np.ascontiguousarray(arr)
        if not 0 <= root < self.world:
            raise Error(f"broadcast root {root} out of range")
        if self.world == 1:
            out = a.copy()
            self._finish_round(out.tobytes(), "local")
            return out
        seq = self.seq
        ctx = _Round(seq, None, None, a)
        self.bytes += a.nbytes
        _BYTES.inc(a.nbytes)
        t0 = time.perf_counter()
        with _tracing.span("dmlc:allreduce_wait", seq=seq, path="bcast"):
            self._round_prologue(ctx)
            if self.rank == root:
                ctx.result = a.tobytes()
            result = self._run_tree(ctx)
        dt = time.perf_counter() - t0
        self.link_wait_secs += dt
        _LINK_WAIT.observe(dt)
        self._finish_round(result, "bcast")
        return (
            np.frombuffer(result, dtype=ctx.dtype).reshape(ctx.shape).copy()
        )

    def barrier(self) -> None:
        """All ranks reach this point before any rank passes it (one
        tiny tree round)."""
        self.allreduce(np.zeros(1, np.int8), "max", path="tree")

    def checkpoint(self, state: bytes, version: Optional[int] = None) -> None:
        """rabit ``lazy_checkpoint``: keep the newest model bytes in
        memory, served to bootstrapping peers on demand — no disk, no
        serialization until someone asks. ``version`` defaults to the
        engine's round clock; record it every K steps and keep
        DMLC_COLLECTIVE_CACHE >= K so a recovering peer can replay the
        rounds since."""
        self._state = (
            self.seq,
            self.seq if version is None else int(version),
            bytes(state),
        )

    def load_checkpoint(
        self, timeout: Optional[float] = None, settle: float = 0.5
    ) -> Tuple[int, Optional[bytes]]:
        """Bootstrap-from-peer: ask every tree neighbor for its newest
        (seq, version, state), adopt the best, and fast-forward this
        engine's round clock to it. Returns ``(version, state)`` —
        ``(0, None)`` on a fresh job. Call once right after
        ``worker.start()``; a relaunched worker resumes its training
        loop at the returned version and replays into the live round
        through the survivors' result caches."""
        if self.world == 1 or not self._tree_links:
            return self._state[1], self._state[2]
        deadline = time.monotonic() + (
            timeout if timeout is not None else self.io_timeout
        )
        self._ck_replies = {}
        want = set(self._tree_links)
        for r in sorted(want & set(self.worker.links)):
            try:
                self._send_frame(r, K_CKREQ, 0, 0)
            except _LinkDied as e:
                self._drop_link(e.rank)
        first_reply_at: Optional[float] = None
        while time.monotonic() < deadline:
            got = set(self._ck_replies)
            if got >= (want & set(self.worker.links)) and got:
                break
            if first_reply_at is not None and (
                time.monotonic() - first_reply_at > settle
            ):
                break
            try:
                self._pump(None, slice_secs=0.1)
            except _LinkDied as e:
                self._drop_link(e.rank)
                if not self.worker.links:
                    # every neighbor died under us: re-broker and re-ask
                    self._rewire()
                    for r in sorted(want & set(self.worker.links)):
                        try:
                            self._send_frame(r, K_CKREQ, 0, 0)
                        except _LinkDied:
                            pass
            if self._ck_replies and first_reply_at is None:
                first_reply_at = time.monotonic()
        if not self._ck_replies:
            return self._state[1], self._state[2]
        best_seq, best_version, best_state = max(
            self._ck_replies.values(), key=lambda t: (t[0], t[1])
        )
        mine = self._state
        if (best_seq, best_version) > (mine[0], mine[1]):
            self._state = (best_seq, best_version, best_state or None)
        self.seq = max(self.seq, best_seq)
        self._ck_replies = {}
        return self._state[1], self._state[2]

    def close(self, linger: Optional[float] = None) -> None:
        """Serve late peers for a short linger window (a rank replaying
        the final rounds still needs the cached results), then close
        the watch connection. Idempotent; peer links stay owned by the
        RabitWorker (``worker.close()``/``shutdown()``)."""
        if self._closed:
            return
        self._closed = True
        linger = (
            linger
            if linger is not None
            else _env_float("DMLC_COLLECTIVE_LINGER", 0.5)
        )
        deadline = time.monotonic() + max(0.0, linger)
        while time.monotonic() < deadline:
            if not self.worker.links:
                break  # nobody to serve; _pump would spin, not wait
            try:
                self._pump(None, slice_secs=0.1, idle_ok=True)
            except _LinkDied as e:
                self._drop_link(e.rank)
            except (Error, OSError):
                break
        if self._watch_fs is not None:
            self._watch_fs.close()
            self._watch_fs = None

    # -- tree path ------------------------------------------------------------
    def _round_prologue(self, ctx: _Round) -> None:
        if self._chaos is not None:
            self._chaos.on_round_start(self, ctx.seq)
        try:
            # draining may SEND (forward a buffered RESET, serve a
            # cached RESULT) — a link dying under it must start the
            # in-place recovery, not leak out of allreduce()
            self._drain_early(ctx)
        except _LinkDied as e:
            self._recover(ctx, e.rank)
        # solicit nudge, EVERY round (one header-only frame per tree
        # link): peers that already completed this round — i.e. we are
        # a relaunched worker replaying through their result caches —
        # answer with the cached RESULT; live same-round peers ignore
        # attempt 0. Per-round (not once after restart) because a
        # replaying root/interior rank never receives fresh K_DATA from
        # live children for an old round — this nudge is the only pull
        # path, and replay spans as many rounds as the checkpoint is
        # behind. It also surfaces a link a chaos reset half-closed
        # BETWEEN rounds at the next round's start instead of mid-fold.
        for r in list(self._tree_links):
            if r in self.worker.links:
                try:
                    self._send_frame(r, K_RESET, ctx.seq, 0)
                except _LinkDied as e:
                    self._recover(ctx, e.rank)

    def _run_tree(self, ctx: _Round) -> bytes:
        while True:
            try:
                self._drain_early(ctx)
                while ctx.result is None:
                    self._maybe_send_parent(ctx)
                    if ctx.result is not None:
                        break
                    self._pump(ctx)
                self._flood_result(ctx)
                return ctx.result
            except _LinkDied as e:
                self._recover(ctx, e.rank)

    def _maybe_send_parent(self, ctx: _Round) -> None:
        if ctx.flat is None or ctx.sent_parent:
            return  # broadcast round, or contribution already up
        missing = [c for c in self._children if c not in ctx.contrib]
        if missing:
            return
        acc = ctx.flat
        for c in self._children:
            acc = ctx.reducer(acc, ctx.contrib[c])
        acc = np.ascontiguousarray(acc, dtype=ctx.dtype)
        if self.worker.parent == -1:
            ctx.result = acc.tobytes()
            ctx.result_src = None
        else:
            self._send_frame(
                self.worker.parent, K_DATA, ctx.seq, 0, acc.tobytes()
            )
            ctx.sent_parent = True
            if self._chaos is not None:
                self._chaos.on_sent_parent(ctx.seq)

    def _flood_result(self, ctx: _Round) -> None:
        for r in self._tree_links:
            if r == ctx.result_src or r not in self.worker.links:
                continue
            self._send_frame(r, K_RESULT, ctx.seq, 0, ctx.result)

    # -- ring path ------------------------------------------------------------
    def _run_ring(self, ctx: _Round) -> bytes:
        """Every rank sends a segment to ring-next and then receives one
        from ring-prev. Each send runs on a helper thread (``_Send``)
        while this thread receives: the JAX engine sends with a blocking
        ``sendall`` first, so a segment larger than the sockets' buffers
        (a few MB on loopback) leaves every rank blocked in its send until
        ``io_timeout``, and the round then retries over the tree."""
        n = self.world
        nxt = self.worker.ring_next
        flat = ctx.flat.copy()
        bounds = _segment_bounds(flat.size, n)
        sender: Optional[_Send] = None
        try:
            for step in range(n - 1):
                lo, hi = bounds[(self.rank - step) % n]
                sender = _Send(self, nxt, K_RS, ctx.seq, step, flat[lo:hi].tobytes())
                payload = self._await_ring(ctx, K_RS, step)
                sender.wait()
                sender = None
                lo, hi = bounds[(self.rank - step - 1) % n]
                incoming = np.frombuffer(payload, dtype=ctx.dtype)
                if incoming.size != hi - lo:
                    raise Error(
                        f"ring segment size mismatch in round {ctx.seq}: "
                        f"got {incoming.size}, want {hi - lo}"
                    )
                flat[lo:hi] = ctx.reducer(incoming, flat[lo:hi])
            for step in range(n - 1):
                lo, hi = bounds[(self.rank + 1 - step) % n]
                sender = _Send(self, nxt, K_AG, ctx.seq, step, flat[lo:hi].tobytes())
                payload = self._await_ring(ctx, K_AG, step)
                sender.wait()
                sender = None
                lo, hi = bounds[(self.rank - step) % n]
                incoming = np.frombuffer(payload, dtype=ctx.dtype)
                if incoming.size != hi - lo:
                    raise Error(
                        f"ring segment size mismatch in round {ctx.seq}: "
                        f"got {incoming.size}, want {hi - lo}"
                    )
                flat[lo:hi] = incoming
        except _LinkDied as e:
            self._recover(ctx, e.rank)
            raise _RingAborted() from None
        finally:
            if sender is not None:
                sender.abandon()
        return flat.tobytes()

    def _await_ring(self, ctx: _Round, kind: int, step: int) -> bytes:
        while True:
            if ctx.reset_abort:
                raise _RingAborted()
            payload = ctx.ring_in.pop((kind, step), None)
            if payload is not None:
                return payload
            self._pump(ctx)

    # -- frame plumbing -------------------------------------------------------
    def _prepared(self, rank: int) -> socket.socket:
        sock = self.worker.links.get(rank)
        if sock is None:
            raise _LinkDied(rank)
        sock.settimeout(self.io_timeout)
        return sock

    def _send_frame(
        self, rank: int, kind: int, seq: int, aux: int, payload: bytes = b""
    ) -> None:
        if len(payload) > _MAX_PAYLOAD:
            # fail LOUDLY at the sender: the receiver would reject the
            # frame as corrupt and both sides would spin through
            # recovery retrying the identical oversized send forever
            raise Error(
                f"collective payload is {len(payload)} bytes, over the "
                f"{_MAX_PAYLOAD}-byte frame limit — chunk the buffer "
                "into smaller allreduce calls"
            )
        sock = self._prepared(rank)
        try:
            # one frame at a time on a link: a ring segment may be going
            # out on a helper thread (_Send) while this thread replies
            with self._send_lock(sock):
                sock.sendall(
                    _HDR.pack(
                        _FRAME_MAGIC, kind, seq, aux, len(payload),
                        _tracing.flow_send_id(),
                    )
                )
                if payload:
                    sock.sendall(payload)
        except Exception as exc:
            if isinstance(exc, OSError) or is_transient(exc):
                raise _LinkDied(rank, exc) from None
            raise

    def _send_lock(self, sock: socket.socket) -> threading.Lock:
        with self._locks_guard:
            lock = self._send_locks.get(sock)
            if lock is None:
                lock = self._send_locks[sock] = threading.Lock()
            return lock

    def _recv_exact(self, rank: int, sock: socket.socket, n: int) -> bytes:
        chunks = []
        nread = 0
        try:
            while nread < n:
                chunk = sock.recv(min(n - nread, 1 << 16))
                if not chunk:
                    raise _LinkDied(rank, ConnectionError("peer closed"))
                chunks.append(chunk)
                nread += len(chunk)
        except _LinkDied:
            raise
        except Exception as exc:
            if isinstance(exc, OSError) or is_transient(exc):
                raise _LinkDied(rank, exc) from None
            raise
        return b"".join(chunks)

    def _recv_frame(
        self, rank: int, sock: socket.socket
    ) -> Tuple[int, int, int, bytes]:
        sock.settimeout(self.io_timeout)
        hdr = self._recv_exact(rank, sock, _HDR.size)
        magic, kind, seq, aux, nbytes, flow = _HDR.unpack(hdr)
        if magic != _FRAME_MAGIC or not 0 <= nbytes <= _MAX_PAYLOAD:
            raise _LinkDied(
                rank, ConnectionError(f"bad frame (magic={magic:#x})")
            )
        payload = self._recv_exact(rank, sock, nbytes) if nbytes else b""
        # land the sender's flow arrow inside the wait span this recv
        # runs under (allreduce_wait): cause → effect on the timeline
        _tracing.flow_recv(flow)
        return kind, seq, aux, payload

    def _pump(
        self,
        ctx: Optional[_Round],
        slice_secs: float = 1.0,
        idle_ok: bool = False,
    ) -> None:
        """Wait for at least one frame on any live link and dispatch
        the batch select() reported. Raises a checked Error after
        ``io_timeout`` of zero progress (the backstop behind the
        instant-notification paths); with ``idle_ok`` a silent slice
        just returns (close-time lingering)."""
        deadline = time.monotonic() + self.io_timeout
        while True:
            by_sock = {s: r for r, s in self.worker.links.items()}
            if not by_sock:
                raise _LinkDied(-1, ConnectionError("no live peer links"))
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise Error(
                    f"rank {self.rank}: collective timed out after "
                    f"{self.io_timeout:.0f}s with no peer traffic "
                    f"(round {self.seq}; raise $DMLC_COLLECTIVE_TIMEOUT "
                    "for slow clusters)"
                )
            try:
                ready, _, _ = select.select(
                    list(by_sock), [], [], min(slice_secs, remaining)
                )
            except (OSError, ValueError):
                # a link closed under select: find it via fileno
                for s, r in by_sock.items():
                    if s.fileno() < 0:
                        raise _LinkDied(
                            r, ConnectionError("link closed")
                        ) from None
                continue
            if not ready:
                if idle_ok:
                    return
                continue
            for s in ready:
                r = by_sock[s]
                if self.worker.links.get(r) is not s:
                    continue  # replaced by a concurrent recovery
                kind, fseq, aux, payload = self._recv_frame(r, s)
                self._dispatch(r, kind, fseq, aux, payload, ctx)
            return

    def _dispatch(
        self,
        peer: int,
        kind: int,
        fseq: int,
        aux: int,
        payload: bytes,
        ctx: Optional[_Round],
    ) -> None:
        if kind == K_CKREQ:
            seq_ck, version, state = self._state
            self._send_frame(peer, K_CK, seq_ck, version, state or b"")
            return
        if kind == K_CK:
            self._ck_replies[peer] = (fseq, aux, payload)
            return
        if kind == K_ERR:
            raise Error(
                f"rank {self.rank}: peer {peer} reports an unrecoverable "
                f"round: {payload.decode(errors='replace')}"
            )
        if fseq < self.seq:
            # a peer replaying a round we completed: serve the cached
            # result (the whole recovery story rides this)
            if kind in (K_DATA, K_RESET):
                cached = self._results.get(fseq)
                if cached is None:
                    self._send_frame(
                        peer,
                        K_ERR,
                        fseq,
                        0,
                        (
                            f"round {fseq} result aged out of the cache "
                            f"(cap {self._cache_cap}; checkpoint at least "
                            "every DMLC_COLLECTIVE_CACHE rounds)"
                        ).encode(),
                    )
                else:
                    self._send_frame(peer, K_RESULT, fseq, 0, cached)
            return
        if fseq > self.seq or ctx is None:
            self._early[(fseq, kind, peer, aux)] = payload
            return
        # fseq == self.seq == ctx.seq: the live round
        if kind == K_DATA:
            if peer in self._children:
                if len(payload) != ctx.nbytes:
                    raise Error(
                        f"round {fseq}: contribution from rank {peer} is "
                        f"{len(payload)} bytes, want {ctx.nbytes} — "
                        "mismatched collective shapes/dtypes across ranks"
                    )
                ctx.contrib[peer] = np.frombuffer(payload, dtype=ctx.dtype)
            return
        if kind == K_RESULT:
            if len(payload) != ctx.nbytes:
                raise Error(
                    f"round {fseq}: result is {len(payload)} bytes, want "
                    f"{ctx.nbytes} — mismatched collective shapes/dtypes"
                )
            ctx.result = payload
            ctx.result_src = peer
            return
        if kind == K_RESET:
            if ctx.result is not None:
                self._send_frame(peer, K_RESULT, fseq, 0, ctx.result)
                return
            if aux > ctx.attempt:
                ctx.attempt = aux
                ctx.clear_partial()
                ctx.reset_abort = True  # ring loops unwind to the tree
                for r in self._tree_links:
                    if r != peer and r in self.worker.links:
                        self._send_frame(r, K_RESET, fseq, aux)
            return
        if kind in (K_RS, K_AG):
            if peer == self.worker.ring_prev:
                ctx.ring_in[(kind, aux)] = payload
            return
        # unknown kind: a corrupt or hostile frame — treat the link as
        # poisoned rather than guessing at framing
        raise _LinkDied(
            peer, ConnectionError(f"unknown frame kind {kind}")
        )

    def _drain_early(self, ctx: _Round) -> None:
        stale = [k for k in self._early if k[0] < self.seq]
        for k in stale:
            del self._early[k]
        mine = sorted(k for k in self._early if k[0] == ctx.seq)
        for key in mine:
            fseq, kind, peer, aux = key
            payload = self._early.pop(key)
            self._dispatch(peer, kind, fseq, aux, payload, ctx)

    # -- recovery -------------------------------------------------------------
    def _drop_link(self, rank: int) -> None:
        sock = self.worker.links.pop(rank, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _rewire(self) -> None:
        """Re-enter the tracker rendezvous with our existing rank: the
        tracker re-brokers the missing links, blocking until the
        relaunched peer (supervisor relaunch → ``cmd=recover``/jobid
        memo) — or the surviving peer after an injected link reset —
        dials back in."""
        self.worker.start(recover_rank=self.rank)

    def _recover(self, ctx: Optional[_Round], dead_rank: int) -> None:
        self.recoveries += 1
        _RECOVERIES.inc()
        if dead_rank >= 0:
            self._drop_link(dead_rank)
        if ctx is not None and ctx.result is None:
            ctx.attempt += 1
            ctx.clear_partial()
            ctx.reset_abort = True
            for r in list(self._tree_links):
                if r == dead_rank or r not in self.worker.links:
                    continue
                try:
                    self._send_frame(r, K_RESET, ctx.seq, ctx.attempt)
                except _LinkDied as e:
                    self._drop_link(e.rank)
        self._rewire()
        if ctx is not None:
            ctx.reset_abort = False

    def _finish_round(self, result: bytes, path: str) -> None:
        self._results[self.seq] = result
        while len(self._results) > self._cache_cap:
            self._results.popitem(last=False)
        self.seq += 1
        path = path if path in self.rounds else "tree"
        self.rounds[path] += 1
        _ROUNDS[path].inc()
        for k in [k for k in self._early if k[0] < self.seq]:
            # frames for finished rounds that arrived early (dup floods)
            del self._early[k]

    # -- death watch (worker side) --------------------------------------------
    def _dial_watch(self, retry_secs: Optional[float] = None) -> bool:
        """(Re-)establish the persistent push connection; True on
        success. ``retry_secs=0`` is the constructor's fail-fast probe
        (no watch service → timeouts remain the backstop); the watch
        loop re-dials with the full ``DMLC_TRACKER_RETRY_SECS`` budget
        so a tracker relaunch gets its push channel back instead of
        silently degrading every surviving worker to timeout discovery."""
        try:
            fs = connect_worker_retry(
                self.worker.tracker_uri,
                self.worker.tracker_port,
                self.rank,
                -1,
                self.worker.jobid,
                CMD_WATCH,
                retry_secs=retry_secs,
            )
            fs.sock.settimeout(None)
        except (OSError, ConnectionError):
            return False
        old, self._watch_fs = self._watch_fs, fs
        if old is not None:
            old.close()
        return True

    def _start_watch(self) -> None:
        if os.environ.get("DMLC_COLLECTIVE_WATCH", "1") in ("0", "false"):
            return
        if not self._dial_watch(retry_secs=0):
            return  # no watch service: timeouts remain the backstop
        threading.Thread(
            target=self._watch_loop,
            daemon=True,
            name=f"collective-watch-{self.rank}",
        ).start()

    def _watch_loop(self) -> None:
        while True:
            fs = self._watch_fs
            if fs is None:
                return
            try:
                msg = fs.recv_str()
                dead = int(json.loads(msg).get("dead_rank", -1))
            except (OSError, ConnectionError, ValueError):
                # tracker gone (crash/relaunch) or engine closed: try
                # to re-establish the push channel once the tracker is
                # back; give up only when the reconnect budget is spent
                if self._closed:
                    return
                try:
                    if not self._dial_watch():
                        return
                except (Error, OSError, ConnectionError):
                    return
                continue
            sock = self.worker.links.get(dead)
            if sock is not None:
                # half-close only: the app thread's blocked recv fails
                # immediately and owns the actual teardown + recovery
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
