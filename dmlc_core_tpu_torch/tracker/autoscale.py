"""Closed-loop elastic autoscaling: stall attribution → capacity
decisions (the port of ``dmlc_core_tpu/tracker/autoscale.py``, whole).

A controller thread in the tracker reads the windowed cluster view
(``ClusterAggregator.windowed()``) every ``interval`` seconds,
classifies the job **input-bound** (trainers starved by the data path:
``shard_lease_wait`` / ``dsserve_recv_wait`` / ``fetch_wait``) or
**accelerator-bound** (``dispatch_slot_wait`` / ``transfer_wait``
dominate, input stalls negligible), and spawns dsserve workers when
input-bound or retires them gracefully when compute-bound.

The control law is pure:

    ``decide(view, state, cfg, now) -> Action``

takes only a windowed snapshot plus explicit state and clock, so it
unit-tests on canned series and powers the offline ``tools autoscale
replay`` over a recorded end-of-job report (``replay()``). Guard rails,
in evaluation order:

- **hysteresis**: separate up/down thresholds on the summed input-stall
  fraction, with a band between them where the controller holds;
- **dwell**: a minimum quiet time after any scale action;
- **cost ceiling**: a hard worker×seconds budget for the elastic tier;
  once spent, scale-ups stop (existing workers keep running);
- **flap bound**: after ``max_flaps`` direction changes the controller
  refuses further reversals.

Actuation goes through a process-global actuator that the launch backend
registers (``set_actuator``; the local backend registers
``ElasticActuator`` over its ``DsServeTier``). Every decision is a
``dmlc:autoscale_decision`` trace instant and ticks the
``tracker.autoscale.*`` series. The decisions are the JAX package's for
the same views, states and clock.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..telemetry import default_registry as _default_registry
from ..telemetry import tracing as _tracing
from ..telemetry.timeseries import merge_windows, windowed

__all__ = [
    "Action",
    "AutoscaleConfig",
    "AutoscaleController",
    "ControllerState",
    "accrue_cost",
    "active_actuator",
    "apply_action",
    "decide",
    "replay",
    "set_actuator",
    "signals",
]

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")

_REG = _default_registry()
_G_TARGET = _REG.gauge(
    "tracker.autoscale.target_workers",
    help="controller's current target elastic fleet size",
)
_G_ACTUAL = _REG.gauge(
    "tracker.autoscale.actual_workers",
    help="live elastic workers reported by the actuator",
)
_G_COST = _REG.gauge(
    "tracker.autoscale.cost_spent",
    help="elastic-tier worker-seconds accrued so far",
)

#: stall stages that mean the TRAINERS are starved by the input path —
#: more preprocessing/drain capacity can shrink them
INPUT_STAGES = ("shard_lease_wait", "dsserve_recv_wait", "fetch_wait")
#: stall stages that mean the accelerator side is the bottleneck —
#: extra input workers would idle
COMPUTE_STAGES = ("dispatch_slot_wait", "transfer_wait")

SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"
HOLD = "hold"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass
class AutoscaleConfig:
    """Control-law knobs."""

    min_workers: int
    max_workers: int
    #: input-stall fraction at/above which the job is input-bound
    up_threshold: float = 0.40
    #: input-stall fraction at/below which the job is compute-bound
    down_threshold: float = 0.10
    #: minimum seconds between scale actions
    dwell_secs: float = 10.0
    #: hard elastic-tier budget in worker×seconds; 0 = unlimited
    cost_ceiling: float = 0.0
    #: controller tick / replay step
    interval: float = 2.0
    #: windowed-view width the decision reads
    window: float = 10.0
    #: direction changes allowed before reversals are refused
    max_flaps: int = 4
    #: samples a worker rank must have reported before its window counts
    min_samples: int = 2

    def __post_init__(self) -> None:
        if self.min_workers < 0 or self.max_workers < max(1, self.min_workers):
            raise ValueError(
                f"autoscale bounds {self.min_workers}:{self.max_workers} "
                "need 0 <= min <= max and max >= 1"
            )
        if not self.down_threshold < self.up_threshold:
            raise ValueError(
                f"hysteresis needs down < up ({self.down_threshold} vs "
                f"{self.up_threshold})"
            )

    @classmethod
    def from_env(cls) -> Optional["AutoscaleConfig"]:
        """``DMLC_AUTOSCALE=min:max`` (unset/empty = controller off)
        plus the knob envs the submit flags export."""
        raw = (os.environ.get("DMLC_AUTOSCALE") or "").strip()
        if not raw:
            return None
        lo, sep, hi = raw.partition(":")
        try:
            min_w, max_w = int(lo), int(hi if sep else lo)
        except ValueError:
            raise ValueError(
                f"DMLC_AUTOSCALE={raw!r}: want min:max (e.g. 1:4)"
            ) from None
        return cls(
            min_workers=min_w,
            max_workers=max_w,
            up_threshold=_env_float("DMLC_AUTOSCALE_UP", 0.40),
            down_threshold=_env_float("DMLC_AUTOSCALE_DOWN", 0.10),
            dwell_secs=_env_float("DMLC_AUTOSCALE_DWELL", 10.0),
            cost_ceiling=_env_float("DMLC_AUTOSCALE_COST_CEILING", 0.0),
            interval=max(0.1, _env_float("DMLC_AUTOSCALE_INTERVAL", 2.0)),
            window=max(0.5, _env_float("DMLC_AUTOSCALE_WINDOW", 10.0)),
            max_flaps=int(_env_float("DMLC_AUTOSCALE_MAX_FLAPS", 4)),
        )


@dataclass
class ControllerState:
    """Everything a decision depends on besides the windowed view.
    Mutated only by ``apply_action``/``accrue_cost`` so ``decide`` stays
    a pure function of (view, state, cfg, now)."""

    target: int
    last_action_t: Optional[float] = None
    last_direction: int = 0  # +1 up, -1 down, 0 never scaled
    direction_changes: int = 0
    cost_spent: float = 0.0
    last_cost_t: Optional[float] = None
    decisions: Dict[str, int] = field(default_factory=dict)


@dataclass(frozen=True)
class Action:
    kind: str  # scale_up | scale_down | hold
    reason: str
    target: int  # fleet target AFTER this action
    signals: Dict[str, Any] = field(default_factory=dict)


def signals(view: Dict[str, Any], min_samples: int = 2) -> Dict[str, Any]:
    """Classification inputs from one ``ClusterTimeSeries.window()``
    view: summed input/compute stall fractions (cluster average over
    reporting worker ranks), shard queue depth (tracker pseudo-rank
    gauge), and how many worker ranks had a usable window."""
    per_rank = view.get("per_rank") or {}
    reporting = 0
    for key, v in per_rank.items():
        if key == "tracker":
            continue
        if v.get("samples", 0) >= min_samples and v.get("span_secs", 0) > 0:
            reporting += 1
    derived = (view.get("cluster") or {}).get("derived") or {}
    stall = derived.get("stall_fraction") or {}
    qd = (
        (per_rank.get("tracker") or {})
        .get("gauges", {})
        .get("tracker.shards.queue_depth")
    ) or {}
    return {
        "input_stall": round(
            sum(float(stall.get(s, 0.0)) for s in INPUT_STAGES), 4
        ),
        "compute_stall": round(
            sum(float(stall.get(s, 0.0)) for s in COMPUTE_STAGES), 4
        ),
        "queue_depth": float(qd.get("last", 0.0) or 0.0),
        "reporting_ranks": reporting,
    }


def decide(
    view: Dict[str, Any],
    state: ControllerState,
    cfg: AutoscaleConfig,
    now: float,
) -> Action:
    """The pure control law. Evaluation order is part of the contract
    (tests pin the reasons): signal presence → hysteresis band →
    min/max bounds → cost ceiling (ups only) → flap budget → dwell →
    action."""
    sig = signals(view, cfg.min_samples)

    def hold(reason: str) -> Action:
        return Action(HOLD, reason, state.target, sig)

    if sig["reporting_ranks"] == 0:
        return hold("no_signal")
    input_stall = sig["input_stall"]
    if input_stall >= cfg.up_threshold:
        direction = 1
    elif input_stall <= cfg.down_threshold:
        direction = -1
    else:
        return hold("in_band")
    if direction > 0:
        if state.target >= cfg.max_workers:
            return hold("at_max")
        if cfg.cost_ceiling > 0 and state.cost_spent >= cfg.cost_ceiling:
            return hold("cost_ceiling")
    else:
        if state.target <= cfg.min_workers:
            return hold("at_min")
    if (
        state.last_direction != 0
        and direction != state.last_direction
        and state.direction_changes >= cfg.max_flaps
    ):
        return hold("flap_budget")
    if (
        state.last_action_t is not None
        and now - state.last_action_t < cfg.dwell_secs
    ):
        return hold("dwell")
    if direction > 0:
        return Action(SCALE_UP, "input_bound", state.target + 1, sig)
    return Action(SCALE_DOWN, "compute_bound", state.target - 1, sig)


def apply_action(state: ControllerState, action: Action, now: float) -> None:
    """Fold one decision into the state (the controller's and the
    replayer's single mutation site)."""
    state.decisions[action.kind] = state.decisions.get(action.kind, 0) + 1
    if action.kind == HOLD:
        return
    direction = 1 if action.kind == SCALE_UP else -1
    if state.last_direction != 0 and direction != state.last_direction:
        state.direction_changes += 1
    state.last_direction = direction
    state.last_action_t = now
    state.target = action.target


def accrue_cost(state: ControllerState, actual: int, now: float) -> None:
    """Integrate elastic-tier worker-seconds between ticks — the spend
    the cost ceiling caps."""
    if state.last_cost_t is not None and now > state.last_cost_t:
        state.cost_spent += max(0, int(actual)) * (now - state.last_cost_t)
    state.last_cost_t = now


def replay(
    ts_report: Dict[str, Any],
    cfg: AutoscaleConfig,
    include_holds: bool = True,
) -> List[Dict[str, Any]]:
    """Run the pure decision function over a RECORDED end-of-job time
    series (the ``timeseries`` section of a ``DMLC_METRICS_REPORT``
    file) and return the decisions it would have made — deterministic
    and offline, so thresholds can be tuned against yesterday's job
    (``tools autoscale replay``). The simulated fleet tracks the
    decisions (actual == target), so cost accrual is the plan's cost."""
    per_rank = ts_report.get("per_rank") or {}
    times = sorted(
        {s["t"] for series in per_rank.values() for s in series
         if isinstance(s, dict) and isinstance(s.get("t"), (int, float))}
    )
    out: List[Dict[str, Any]] = []
    if not times:
        return out
    t0, t_end = times[0], times[-1]
    state = ControllerState(target=cfg.min_workers)
    t = t0 + cfg.interval
    while t <= t_end + 1e-9:
        views = {
            key: windowed(
                [s for s in series if s.get("t", float("inf")) <= t],
                cfg.window,
                now=t,
            )
            for key, series in per_rank.items()
        }
        view = {
            "window_secs": cfg.window,
            "per_rank": views,
            "cluster": merge_windows(
                {k: v for k, v in views.items() if k != "tracker"}
            ),
        }
        accrue_cost(state, state.target, t)
        action = decide(view, state, cfg, t)
        apply_action(state, action, t)
        if include_holds or action.kind != HOLD:
            out.append({
                "t": round(t - t0, 3),
                "kind": action.kind,
                "reason": action.reason,
                "target": action.target,
                "cost_spent": round(state.cost_spent, 3),
                **action.signals,
            })
        t += cfg.interval
    return out


class AutoscaleController:
    """The tracker-resident closed loop: tick every ``cfg.interval``
    seconds, read the windowed cluster view, run ``decide``, actuate
    through the registered actuator, and publish the decision as a
    trace instant + ``tracker.autoscale.*`` telemetry. ``status()`` is
    the JSON section the metrics endpoint / end-of-job report / tools
    top surface (aggregate.py ``extra_sections``)."""

    def __init__(
        self,
        aggregator,
        cfg: AutoscaleConfig,
        actuator=None,
        clock=None,
        journal=None,
        recovered=None,
    ) -> None:
        import time as _time

        self.cfg = cfg
        self.aggregator = aggregator
        self.state = ControllerState(target=cfg.min_workers)
        self._actuator = actuator
        self._clock = clock or _time.monotonic
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._synced = False
        self.last: Optional[Dict[str, Any]] = None
        self.last_actual = cfg.min_workers
        self._journal = journal
        self._last_journaled: Optional[Dict[str, Any]] = None
        if recovered:
            self._restore(recovered)

    def _restore(self, rec: Dict[str, Any]) -> None:
        """Seed the control law's memory from a journaled ``autoscale``
        record so a relaunched tracker neither double-spends the cost
        ceiling (``cost_spent`` resumes where the dead tracker left it)
        nor flaps (the dwell clock resumes mid-countdown instead of
        resetting — a scale-up decided 20s before the crash still waits
        only the REMAINING dwell, and never re-fires instantly)."""
        now = self._clock()
        st = self.state
        st.target = max(
            self.cfg.min_workers,
            min(self.cfg.max_workers, int(rec.get("target", st.target))),
        )
        st.cost_spent = float(rec.get("cost_spent", 0.0))
        st.last_direction = int(rec.get("last_direction", 0))
        st.direction_changes = int(rec.get("direction_changes", 0))
        # monotonic clocks do not survive a process restart: rebuild
        # last_action_t from the journaled dwell-elapsed offset
        dwell = rec.get("dwell_elapsed")
        if dwell is not None:
            st.last_action_t = now - max(0.0, float(dwell))
        st.last_cost_t = now  # no cost accrues for the outage window
        logger.info(
            "autoscale state recovered: target=%d cost=%.1fws "
            "dwell_elapsed=%s", st.target, st.cost_spent, dwell,
        )

    def _journal_state(self, now: float) -> None:
        """Append an ``autoscale`` record when the recoverable slice of
        controller state changed (every action; cost drift throttled by
        the caller). Written inside the tick lock, BEFORE actuation —
        a crash between journal and actuation recovers to the decided
        target and the next tick re-converges the fleet."""
        if self._journal is None:
            return
        st = self.state
        rec = {
            "target": st.target,
            "cost_spent": round(st.cost_spent, 3),
            "dwell_elapsed": (
                round(now - st.last_action_t, 3)
                if st.last_action_t is not None else None
            ),
            "last_direction": st.last_direction,
            "direction_changes": st.direction_changes,
        }
        from . import journal as _jn  # local: avoid import cycle at module load
        self._journal.append(_jn.K_AUTOSCALE, **rec)
        self._last_journaled = rec

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "AutoscaleController":
        t = threading.Thread(
            target=self._run, daemon=True, name="autoscale-controller"
        )
        self._thread = t
        t.start()
        logger.info(
            "autoscale controller on: fleet %d:%d up>=%.2f down<=%.2f "
            "dwell=%.1fs ceiling=%s interval=%.1fs window=%.1fs",
            self.cfg.min_workers, self.cfg.max_workers,
            self.cfg.up_threshold, self.cfg.down_threshold,
            self.cfg.dwell_secs,
            self.cfg.cost_ceiling or "unlimited",
            self.cfg.interval, self.cfg.window,
        )
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.interval):
            try:
                self.tick()
            except Exception:
                # a controller bug must never take the tracker down:
                # the job runs on at the current fleet size
                logger.exception("autoscale tick failed")

    # -- one tick ------------------------------------------------------------
    def _resolve_actuator(self):
        return self._actuator if self._actuator is not None else (
            active_actuator()
        )

    def tick(self) -> Action:
        """One control cycle (public, so a test steps it
        deterministically without the thread)."""
        with self._lock:
            now = self._clock()
            actuator = self._resolve_actuator()
            actual = self.state.target
            if actuator is not None:
                actual = int(actuator.actual())
                if not self._synced:
                    # adopt the launched fleet (a --dsserve N above min
                    # is the operator's opening bid, not a deviation)
                    self.state.target = max(
                        self.cfg.min_workers,
                        min(self.cfg.max_workers, actual),
                    )
                    self._synced = True
            self.last_actual = actual
            accrue_cost(self.state, actual, now)
            view = self.aggregator.windowed(self.cfg.window)
            action = decide(view, self.state, self.cfg, now)
            apply_action(self.state, action, now)
            # journal every action; journal pure cost drift only past a
            # coarse threshold so a long HOLD steady-state costs ~one
            # record a minute, not one per tick
            prev_cost = (
                self._last_journaled["cost_spent"]
                if self._last_journaled else 0.0
            )
            if action.kind != HOLD or self._last_journaled is None or (
                self.state.cost_spent - prev_cost >= 60.0
            ):
                self._journal_state(now)
            _G_TARGET.set(self.state.target)
            _G_ACTUAL.set(actual)
            _G_COST.set(round(self.state.cost_spent, 3))
            _decision_counter(action.kind).inc()
            _tracing.instant(
                "dmlc:autoscale_decision",
                kind=action.kind,
                reason=action.reason,
                target=action.target,
                actual=actual,
                **action.signals,
            )
            self.last = {
                "kind": action.kind,
                "reason": action.reason,
                "target": action.target,
                "actual": actual,
                **action.signals,
            }
            if action.kind != HOLD:
                logger.info(
                    "autoscale %s (%s): fleet %d -> %d (input_stall=%.2f "
                    "compute_stall=%.2f cost=%.1fws)",
                    action.kind, action.reason, actual, action.target,
                    action.signals.get("input_stall", 0.0),
                    action.signals.get("compute_stall", 0.0),
                    self.state.cost_spent,
                )
        # actuate OUTSIDE the lock: spawning a worker blocks on its
        # port file and status() must stay readable meanwhile
        if actuator is not None:
            try:
                if action.kind == SCALE_UP:
                    actuator.add_task()
                elif action.kind == SCALE_DOWN:
                    actuator.retire_task()
            except Exception:
                logger.exception("autoscale actuation failed")
        return action

    # -- introspection -------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "min_workers": self.cfg.min_workers,
                "max_workers": self.cfg.max_workers,
                "target": self.state.target,
                "actual": self.last_actual,
                "cost_spent": round(self.state.cost_spent, 3),
                "cost_ceiling": self.cfg.cost_ceiling,
                "direction_changes": self.state.direction_changes,
                "decisions": dict(self.state.decisions),
                "window_secs": self.cfg.window,
                "interval_secs": self.cfg.interval,
                "last": dict(self.last) if self.last else None,
            }


def _decision_counter(kind: str):
    return _REG.counter(
        "tracker.autoscale.decisions",
        help="controller decisions by kind",
        labels={"kind": kind},
    )


# -- the process-global actuator (the shardsvc.set_active idiom) ---------------

_actuator_lock = threading.Lock()
_actuator = None


def set_actuator(actuator) -> None:
    """Register the launch backend's elastic actuator (an object with
    ``actual() -> int``, ``add_task() -> bool``, ``retire_task() ->
    bool``). The controller resolves it lazily per tick, so the tracker
    needs no backend wiring — and a backend without one leaves the
    controller in shadow mode (decisions recorded, nothing actuated)."""
    global _actuator
    with _actuator_lock:
        _actuator = actuator


def active_actuator():
    with _actuator_lock:
        return _actuator
