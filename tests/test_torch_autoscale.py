"""The port's autoscale loop (dmlc_core_tpu_torch/tracker/autoscale.py,
``ElasticActuator``, ``submit --autoscale``, ``tools autoscale``) against
the JAX package's: the cases of tests/test_autoscale.py on the port (the
pure control law on canned windowed views, the offline replay and its
CLI, the controller tick against a fake aggregator, actuator and clock,
the report's extra sections, ``tools top``'s autoscale line, and the
submit drill as a CPU subprocess job), then both packages on the same
inputs: ``decide`` gives equal actions for the same views and states,
``replay`` an equal timeline for one report, and a journal's
``autoscale`` budget restores across the packages both ways.
"""

import json
import os
import subprocess
import sys

import pytest

from dmlc_core_tpu.tracker import autoscale as jax_asc
from dmlc_core_tpu.tracker import journal as jax_journal
from dmlc_core_tpu_torch.telemetry import timeseries as ts
from dmlc_core_tpu_torch.tracker import autoscale as asc
from dmlc_core_tpu_torch.tracker import journal as port_journal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a CPU job ends well inside this; every subprocess is bounded by it
DRILL_S = 240


def _cfg(mod=asc, **kw):
    base = dict(min_workers=1, max_workers=4, up_threshold=0.40, down_threshold=0.10,
                dwell_secs=10.0, cost_ceiling=0.0, interval=2.0, window=10.0, max_flaps=4)
    base.update(kw)
    return mod.AutoscaleConfig(**base)


def _view(input_stall=0.0, compute_stall=0.0, ranks=1, queue=0.0, samples=5):
    """A canned ``ClusterTimeSeries.window()`` shape: per-rank windows of
    ``ranks`` reporting workers, the tracker pseudo-rank with the shard
    queue-depth gauge, and the merged cluster stall view."""
    per_rank = {
        str(r): {"samples": samples, "span_secs": 4.0, "counters": {},
                 "gauges": {}, "histograms": {}, "derived": {}}
        for r in range(ranks)
    }
    per_rank["tracker"] = {
        "samples": samples, "span_secs": 4.0, "counters": {},
        "gauges": {"tracker.shards.queue_depth": {"last": queue, "min": 0.0, "max": queue}},
        "histograms": {}, "derived": {},
    }
    stall = {}
    if input_stall:
        # split across two input stages: decide() must SUM the family
        stall["shard_lease_wait"] = input_stall / 2
        stall["dsserve_recv_wait"] = input_stall / 2
    if compute_stall:
        stall["dispatch_slot_wait"] = compute_stall
    return {"window_secs": 10.0, "per_rank": per_rank,
            "cluster": {"n_ranks": ranks, "derived": {"stall_fraction": stall}}}


# -- signals ---------------------------------------------------------------------


def test_signals_sums_stage_families_and_counts_ranks():
    sig = asc.signals(_view(input_stall=0.5, compute_stall=0.2, ranks=3, queue=7.0))
    assert sig["input_stall"] == pytest.approx(0.5)
    assert sig["compute_stall"] == pytest.approx(0.2)
    assert sig["queue_depth"] == 7.0
    assert sig["reporting_ranks"] == 3


def test_signals_ignores_thin_windows_and_tracker_rank():
    # one sample is not a window; the tracker pseudo-rank never counts
    assert asc.signals(_view(samples=1))["reporting_ranks"] == 0
    assert asc.signals({"per_rank": {}, "cluster": {}})["reporting_ranks"] == 0


# -- the pure control law ----------------------------------------------------------


def test_scale_up_on_sustained_input_stall():
    st = asc.ControllerState(target=1)
    a = asc.decide(_view(input_stall=0.6), st, _cfg(), now=100.0)
    assert a.kind == asc.SCALE_UP and a.reason == "input_bound"
    assert a.target == 2
    asc.apply_action(st, a, 100.0)
    assert st.target == 2 and st.last_direction == 1


def test_hold_inside_hysteresis_band():
    st = asc.ControllerState(target=2)
    a = asc.decide(_view(input_stall=0.25), st, _cfg(), now=100.0)
    assert a.kind == asc.HOLD and a.reason == "in_band"
    assert a.target == 2  # a hold never moves the target


def test_no_signal_without_reporting_ranks():
    """An empty window must HOLD: never actuate blind."""
    st = asc.ControllerState(target=1)
    a = asc.decide(_view(input_stall=0.9, samples=1), st, _cfg(), 100.0)
    assert a.kind == asc.HOLD and a.reason == "no_signal"


def test_compute_bound_triggers_scale_down():
    st = asc.ControllerState(target=3)
    a = asc.decide(_view(input_stall=0.05, compute_stall=0.7), st, _cfg(), 100.0)
    assert a.kind == asc.SCALE_DOWN and a.reason == "compute_bound"
    assert a.target == 2


def test_bounds_at_min_and_at_max():
    cfg = _cfg(min_workers=1, max_workers=3)
    assert asc.decide(_view(input_stall=0.9), asc.ControllerState(target=3), cfg,
                      0.0).reason == "at_max"
    assert asc.decide(_view(input_stall=0.0), asc.ControllerState(target=1), cfg,
                      0.0).reason == "at_min"


def test_dwell_suppresses_flapping():
    """Within dwell_secs of the last action the controller holds even on
    a strong opposite signal; past the dwell it acts."""
    cfg = _cfg(dwell_secs=10.0)
    st = asc.ControllerState(target=1)
    asc.apply_action(st, asc.decide(_view(input_stall=0.8), st, cfg, 100.0), 100.0)
    assert st.target == 2
    a = asc.decide(_view(input_stall=0.0), st, cfg, 104.0)
    assert a.kind == asc.HOLD and a.reason == "dwell"
    assert asc.decide(_view(input_stall=0.0), st, cfg, 111.0).kind == asc.SCALE_DOWN


def test_cost_ceiling_stops_ups_but_not_downs():
    cfg = _cfg(cost_ceiling=100.0, dwell_secs=0.0)
    st = asc.ControllerState(target=2)
    st.cost_spent = 100.0  # the budget is gone
    a = asc.decide(_view(input_stall=0.9), st, cfg, 100.0)
    assert a.kind == asc.HOLD and a.reason == "cost_ceiling"
    # retiring still works: the ceiling caps spend, not shrink
    assert asc.decide(_view(input_stall=0.0), st, cfg, 100.0).kind == asc.SCALE_DOWN


def test_flap_budget_refuses_reversals_not_continuations():
    cfg = _cfg(dwell_secs=0.0, max_flaps=2)
    st = asc.ControllerState(target=2, last_direction=-1, direction_changes=2)
    a = asc.decide(_view(input_stall=0.9), st, cfg, 100.0)
    assert a.kind == asc.HOLD and a.reason == "flap_budget"
    # continuing the current direction is always allowed
    assert asc.decide(_view(input_stall=0.0), st, cfg, 100.0).kind == asc.SCALE_DOWN


def test_apply_action_counts_direction_changes():
    st = asc.ControllerState(target=1)
    asc.apply_action(st, asc.Action(asc.SCALE_UP, "input_bound", 2), 1.0)
    asc.apply_action(st, asc.Action(asc.SCALE_UP, "input_bound", 3), 2.0)
    assert st.direction_changes == 0  # the same direction is not a flap
    asc.apply_action(st, asc.Action(asc.SCALE_DOWN, "compute_bound", 2), 3.0)
    assert st.direction_changes == 1
    assert st.decisions == {"scale_up": 2, "scale_down": 1}


def test_accrue_cost_integrates_worker_seconds():
    st = asc.ControllerState(target=2)
    asc.accrue_cost(st, 2, 100.0)  # the first tick only arms the clock
    assert st.cost_spent == 0.0
    asc.accrue_cost(st, 2, 110.0)
    assert st.cost_spent == pytest.approx(20.0)
    asc.accrue_cost(st, 3, 112.0)
    assert st.cost_spent == pytest.approx(26.0)


def test_config_validation():
    with pytest.raises(ValueError, match="bounds"):
        _cfg(min_workers=3, max_workers=2)
    with pytest.raises(ValueError, match="hysteresis"):
        _cfg(up_threshold=0.1, down_threshold=0.4)


def test_config_from_env(monkeypatch):
    monkeypatch.delenv("DMLC_AUTOSCALE", raising=False)
    assert asc.AutoscaleConfig.from_env() is None
    monkeypatch.setenv("DMLC_AUTOSCALE", "1:4")
    monkeypatch.setenv("DMLC_AUTOSCALE_DWELL", "3.5")
    monkeypatch.setenv("DMLC_AUTOSCALE_COST_CEILING", "120")
    cfg = asc.AutoscaleConfig.from_env()
    assert (cfg.min_workers, cfg.max_workers) == (1, 4)
    assert cfg.dwell_secs == 3.5 and cfg.cost_ceiling == 120.0
    assert vars(cfg) == vars(jax_asc.AutoscaleConfig.from_env())
    monkeypatch.setenv("DMLC_AUTOSCALE", "banana")
    with pytest.raises(ValueError, match="min:max"):
        asc.AutoscaleConfig.from_env()


# -- offline replay ------------------------------------------------------------------


def _recorded_report(phases, dt=1.0):
    """A canned end-of-job ``timeseries`` section: one worker rank whose
    ``trace.stall_seconds{stage="shard_lease_wait"}`` counter grows at the
    per-phase rate (the stall fraction the windowed view derives)."""
    samples, t, stall, seq = [], 1000.0, 0.0, 0
    for dur, rate in phases:
        for _ in range(int(dur / dt)):
            t += dt
            stall += rate * dt
            seq += 1
            samples.append({
                "t": t, "seq": seq,
                "counters": {'trace.stall_seconds{stage="shard_lease_wait"}': round(stall, 6),
                             "io.split.records": 100.0 * seq},
                "gauges": {}, "histograms": {},
            })
    return {"per_rank": {"0": samples}}


def test_replay_scales_up_in_the_stall_phase_and_is_deterministic():
    report = _recorded_report([(10, 0.0), (12, 0.9)])
    cfg = _cfg(max_workers=3, interval=2.0, window=4.0, dwell_secs=4.0)
    first = asc.replay(report, cfg)
    assert first == asc.replay(report, cfg)  # repeatable
    ups = [d for d in first if d["kind"] == asc.SCALE_UP]
    assert ups and all(d["t"] > 10.0 for d in ups)
    assert ups[0]["input_stall"] >= cfg.up_threshold
    assert all(d["kind"] == asc.HOLD for d in first if d["t"] <= 10.0)
    costs = [d["cost_spent"] for d in first]
    assert costs == sorted(costs)
    acts = asc.replay(report, cfg, include_holds=False)
    assert [d["kind"] for d in acts] == [asc.SCALE_UP] * len(ups)


def test_replay_empty_series_is_empty():
    assert asc.replay({"per_rank": {}}, _cfg()) == []


def test_tools_autoscale_replay_cli(tmp_path, capsys):
    from dmlc_core_tpu_torch import tools

    report = {"timeseries": _recorded_report([(10, 0.0), (12, 0.9)])}
    path = tmp_path / "report.json"
    path.write_text(json.dumps(report))
    args = ["autoscale", "replay", str(path), "--fleet", "1:3", "--interval", "2",
            "--window", "4", "--dwell", "4"]
    assert tools.main(args + ["--json"]) == 0
    decisions = json.loads(capsys.readouterr().out)
    assert any(d["kind"] == "scale_up" for d in decisions)
    # the human rendering sums up the kinds and the plan's cost
    assert tools.main(args) == 0
    out = capsys.readouterr().out
    assert "scale_up" in out and "worker-seconds" in out
    # a report without a retained series is a loud error, not a crash
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"cluster": {}}))
    assert tools.main(["autoscale", "replay", str(bare)]) == 1
    assert tools.main(["autoscale", "replay", str(path), "--fleet", "3:1"]) == 1
    # the JAX CLI prints the same timeline for the same report
    from dmlc_core_tpu import tools as jax_tools

    capsys.readouterr()
    assert jax_tools.main(args + ["--json"]) == 0
    assert json.loads(capsys.readouterr().out) == decisions


# -- the controller tick -------------------------------------------------------------


class _FakeAgg:
    def __init__(self, view):
        self.view = view

    def windowed(self, seconds):
        return self.view


class _FakeActuator:
    def __init__(self, actual=1):
        self.n = actual
        self.adds = 0
        self.retires = 0

    def actual(self):
        return self.n

    def add_task(self):
        self.n += 1
        self.adds += 1
        return True

    def retire_task(self):
        self.n -= 1
        self.retires += 1
        return True


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def test_controller_tick_actuates_and_reports():
    agg = _FakeAgg(_view(input_stall=0.7))
    act = _FakeActuator(actual=1)
    clk = _Clock()
    ctl = asc.AutoscaleController(agg, _cfg(max_workers=3, dwell_secs=2.0), actuator=act,
                                  clock=clk)
    a = ctl.tick()
    assert a.kind == asc.SCALE_UP and act.adds == 1 and act.n == 2
    clk.t += 0.5
    assert ctl.tick().reason == "dwell" and act.adds == 1
    clk.t += 3.0
    assert ctl.tick().kind == asc.SCALE_UP and act.n == 3
    st = ctl.status()
    # "actual" is the fleet read at the last tick's start
    assert st["target"] == 3 and st["actual"] == 2
    assert st["decisions"]["scale_up"] == 2
    assert st["last"]["kind"] == "scale_up"
    assert st["cost_spent"] > 0
    agg.view = _view(input_stall=0.02, compute_stall=0.6)
    clk.t += 3.0
    assert ctl.tick().kind == asc.SCALE_DOWN and act.retires == 1


def test_controller_first_tick_adopts_launched_fleet():
    """--dsserve N above min is the opening bid: the first tick syncs the
    target to the actual fleet instead of retiring it."""
    ctl = asc.AutoscaleController(_FakeAgg(_view(input_stall=0.25)),
                                  _cfg(min_workers=1, max_workers=4),
                                  actuator=_FakeActuator(actual=3), clock=_Clock())
    ctl.tick()
    assert ctl.status()["target"] == 3


def test_controller_shadow_mode_without_actuator():
    """No registered actuator: decisions are still recorded."""
    asc.set_actuator(None)
    ctl = asc.AutoscaleController(_FakeAgg(_view(input_stall=0.9)), _cfg(dwell_secs=0.0),
                                  clock=_Clock())
    assert ctl.tick().kind == asc.SCALE_UP
    assert ctl.status()["target"] == 2


def test_actuator_registry_roundtrip():
    probe = _FakeActuator()
    asc.set_actuator(probe)
    try:
        assert asc.active_actuator() is probe
    finally:
        asc.set_actuator(None)
    assert asc.active_actuator() is None


# -- report plumbing -------------------------------------------------------------------


def test_aggregator_extra_sections_in_report():
    from dmlc_core_tpu_torch.telemetry.aggregate import ClusterAggregator

    agg = ClusterAggregator()
    agg.extra_sections["autoscale"] = lambda: {"target": 2}

    def boom():
        raise RuntimeError("status bug")

    agg.extra_sections["broken"] = boom
    rep = agg.report()
    assert rep["autoscale"] == {"target": 2}
    assert "broken" not in rep  # a failing section is dropped, not fatal
    assert "cluster" in rep


def test_top_model_and_render_carry_autoscale():
    from dmlc_core_tpu_torch.tools import _render_top, _top_model

    status = {"min_workers": 1, "max_workers": 4, "target": 3, "actual": 2,
              "cost_spent": 37.2, "cost_ceiling": 120.0, "direction_changes": 1,
              "decisions": {"hold": 9, "scale_up": 2},
              "last": {"kind": "scale_up", "reason": "input_bound"}}
    report = {"windowed": {"per_rank": {}, "cluster": {"n_ranks": 0, "derived": {}}},
              "autoscale": status}
    model = _top_model(report, 30.0)
    assert model["autoscale"] == status
    frame = _render_top(model, "http://t:1")
    assert "autoscale fleet 2→3 (bounds 1:4)" in frame
    assert "last scale_up (input_bound)" in frame
    assert "cost 37/120 ws" in frame
    assert "flaps 1" in frame
    assert "autoscale" not in _render_top(_top_model({"windowed": report["windowed"]}, 30.0),
                                          "http://t:1")


# -- both packages on the same inputs ------------------------------------------------------

_VIEWS = [
    dict(input_stall=0.6), dict(input_stall=0.25), dict(input_stall=0.9, samples=1),
    dict(input_stall=0.05, compute_stall=0.7), dict(input_stall=0.0),
    dict(input_stall=0.41, ranks=3, queue=5.0), dict(input_stall=0.1),
]
_STATES = [
    dict(target=1), dict(target=4), dict(target=2, last_action_t=95.0, last_direction=1),
    dict(target=2, last_direction=-1, direction_changes=4), dict(target=3, cost_spent=150.0),
]
_CFGS = [dict(), dict(dwell_secs=0.0, cost_ceiling=100.0), dict(max_flaps=2, dwell_secs=3.0)]


@pytest.mark.parametrize("cfg_kw", _CFGS, ids=["default", "ceiling", "flaps"])
def test_decide_equals_jax_on_canned_views(cfg_kw):
    """The same windowed views, states, configs and clock give equal
    actions, and fold into equal states, in both packages."""
    for view_kw in _VIEWS:
        for st_kw in _STATES:
            view = _view(**view_kw)
            st, jst = asc.ControllerState(**st_kw), jax_asc.ControllerState(**st_kw)
            a = asc.decide(view, st, _cfg(**cfg_kw), 100.0)
            ja = jax_asc.decide(view, jst, _cfg(jax_asc, **cfg_kw), 100.0)
            assert (a.kind, a.reason, a.target, a.signals) == \
                (ja.kind, ja.reason, ja.target, ja.signals), (view_kw, st_kw)
            asc.apply_action(st, a, 100.0)
            jax_asc.apply_action(jst, ja, 100.0)
            assert vars(st) == vars(jst)


@pytest.mark.parametrize("phases", [
    [(10, 0.0), (12, 0.9)], [(6, 0.8), (8, 0.02), (10, 0.5)], [(20, 0.3)],
])
def test_replay_equals_jax(phases):
    report = _recorded_report(phases)
    for kw in (dict(max_workers=3, interval=2.0, window=4.0, dwell_secs=4.0),
               dict(max_workers=2, interval=1.0, window=3.0, dwell_secs=0.0, cost_ceiling=6.0)):
        assert asc.replay(report, _cfg(**kw)) == jax_asc.replay(report, _cfg(jax_asc, **kw))


def _controller_fields(ctl):
    st = ctl.state
    return (st.target, round(st.cost_spent, 3), st.last_direction, st.direction_changes,
            None if st.last_action_t is None else round(ctl._clock() - st.last_action_t, 3))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_autoscale_budget_restores_across_packages(tmp_path, writer):
    """A controller journals its budget; a tracker of the other package
    replays that journal and seeds its controller with it: the same
    target, spend, direction, flaps and remaining dwell."""
    mods = {"jax": (jax_asc, jax_journal), "port": (asc, port_journal)}
    w_asc, w_jn = mods[writer]
    r_asc, r_jn = mods["port" if writer == "jax" else "jax"]
    clk = _Clock()
    j = w_jn.Journal(str(tmp_path / "j"))
    ctl = w_asc.AutoscaleController(_FakeAgg(_view(input_stall=0.8)),
                                    _cfg(w_asc, max_workers=3, dwell_secs=30.0),
                                    actuator=_FakeActuator(actual=1), clock=clk, journal=j)
    ctl.tick()
    clk.t += 5.0
    ctl.tick()  # a dwell hold: cost drifts, no record
    assert ctl.state.target == 2
    j.close()
    rj = r_jn.Journal(str(tmp_path / "j"))
    rec = rj.state["autoscale"]
    rj.close()
    rclk = _Clock(t=5000.0)
    restored = r_asc.AutoscaleController(_FakeAgg(_view()), _cfg(r_asc, max_workers=3,
                                                                 dwell_secs=30.0),
                                         clock=rclk, recovered=rec)
    # the journaled record is the one of the scale-up, 0 s into its dwell
    assert _controller_fields(restored) == (2, 0.0, 1, 0, 0.0)
    rclk.t += 10.0
    a = restored.tick()
    assert a.reason == "dwell"  # the dwell resumes, it does not restart


def test_tracker_hands_the_journaled_budget_to_its_controller(tmp_path, monkeypatch):
    """A port tracker on a JAX journal with an ``autoscale`` record and
    ``DMLC_AUTOSCALE`` set starts its controller from that budget and
    reports it as the ``autoscale`` section."""
    from dmlc_core_tpu_torch.tracker.tracker import RabitTracker

    j = jax_journal.Journal(str(tmp_path / "j"))
    j.append(jax_journal.K_AUTOSCALE, target=2, cost_spent=42.5, dwell_elapsed=3.0,
             last_direction=1, direction_changes=1)
    j.close()
    monkeypatch.setenv("DMLC_AUTOSCALE", "1:3")
    monkeypatch.setenv("DMLC_AUTOSCALE_INTERVAL", "60")
    tr = RabitTracker("127.0.0.1", 1, journal_dir=str(tmp_path / "j"))
    try:
        tr.start(1)
        assert tr.autoscaler is not None
        status = tr.metrics.report()["autoscale"]
        assert status["target"] == 2 and status["cost_spent"] == 42.5
        assert status["direction_changes"] == 1
    finally:
        tr.close()
        assert tr.join(timeout=10)
    assert tr.autoscaler is None


# -- the submit drill --------------------------------------------------------------------

_DRILL_WORKER = """
import os, sys, time
sys.path.insert(0, {repo!r})
from dmlc_core_tpu_torch.dsserve import DsServeBatches
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.tracker.client import RabitWorker

w = RabitWorker()
w.start()
spec = BatchSpec(batch_size=64, layout="ell", max_nnz=8)
last_hb = 0.0
for epoch in range({epochs}):
    src = DsServeBatches("dsserve://" + os.environ["DMLC_DSSERVE"] + "/" + {uri!r}, spec,
                         mode="lease", epoch=epoch)
    rows = 0
    for b in src:
        rows += b.n_valid
        now = time.monotonic()
        if now - last_hb > 0.25:
            # heartbeats ship the ring's samples mid-drain: the
            # controller's only view of the trainer's stalls
            w.heartbeat()
            last_hb = now
    src.close()
    print("epoch", epoch, "rows", rows, flush=True)
w.heartbeat()
w.shutdown()
"""


def test_submit_autoscale_drill_scales_up_and_stall_shrinks(tmp_path):
    """``submit --autoscale 1:2`` over a corpus whose reads are
    fault://-latency-injected (a sustained input-bound phase), as a CPU
    subprocess job of the port: the controller sees the trainer's recv
    wait, scales the dsserve tier up at least once, and the input-stall
    fraction shrinks after the fleet grows. Every epoch drains exactly
    N_ROWS (the elastic join mid-job loses nothing)."""
    import numpy as np

    from dmlc_core_tpu.data.rowrec import encode_row
    from dmlc_core_tpu.io.recordio import IndexedRecordIOWriter
    from dmlc_core_tpu.io.stream import FileStream

    n_rows, k = 2000, 8
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    with FileStream(rec, "w") as f, FileStream(idx, "w") as fi:
        wtr = IndexedRecordIOWriter(f, fi)
        rng = np.random.default_rng(7)
        for i in range(n_rows):
            wtr.write_record(encode_row(float(i % 2), rng.integers(0, 500, k, dtype=np.int64),
                                        rng.normal(size=k).astype(np.float32)), i)
        wtr.flush_block()
    # every data read eats ~25 ms: the spikes outnumber the reads of an
    # open, and a small cap multiplies the reads
    uri = f"fault://latency_ms=25,spikes=400,cap=2048,seed=5{rec}?index={idx}&shuffle=record&seed=3"
    epochs = 4
    report_path = tmp_path / "report.json"
    script = tmp_path / "worker.py"
    script.write_text(_DRILL_WORKER.format(repo=REPO, uri=uri, epochs=epochs))
    env = os.environ.copy()
    env.update({
        "PYTHONPATH": REPO, "DMLC_RENDEZVOUS_GRACE": "1", "DMLC_TS_INTERVAL": "0.1",
        "DMLC_AUTOSCALE_INTERVAL": "0.3", "DMLC_AUTOSCALE_WINDOW": "2",
        "DMLC_METRICS_REPORT": str(report_path),
    })
    for key in ("DMLC_TRACKER_URI", "DMLC_TRACKER_PORT", "DMLC_SHARD_RANK", "DMLC_DSSERVE",
                "DMLC_DSSERVE_FILE", "DMLC_AUTOSCALE"):
        env.pop(key, None)
    proc = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit", "--cluster", "local",
         "--num-workers", "1", "--host-ip", "127.0.0.1", "--autoscale", "1:2",
         "--autoscale-dwell", "0.5", "--shard-oversplit", "6", sys.executable, str(script)],
        capture_output=True, text=True, timeout=DRILL_S, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [int(line.split()[-1]) for line in proc.stdout.splitlines()
            if line.startswith("epoch")]
    assert rows == [n_rows] * epochs, rows

    report = json.loads(report_path.read_text())
    status = report["autoscale"]
    assert status["decisions"].get("scale_up", 0) >= 1, status
    assert status["target"] == 2, status
    assert status["cost_spent"] > 0
    assert report["shards"]["duplicates"] == 0
    # the stall shrank once the second worker joined: windows around
    # the first and the last thirds of the recorded series
    series = report["timeseries"]["per_rank"]["0"]
    assert len(series) >= 9, len(series)
    third = len(series) // 3
    t_early, t_late = series[third]["t"], series[-1]["t"]

    def input_stall(upto, width):
        win = ts.windowed([s for s in series if s["t"] <= upto], width, now=upto)
        frac = win["derived"].get("stall_fraction", {})
        return sum(frac.get(stage, 0.0) for stage in asc.INPUT_STAGES)

    width = max(2.0, (t_late - series[0]["t"]) / 3.0)
    early, late = input_stall(t_early, width), input_stall(t_late, width)
    assert early > 0.3, (early, late)  # the phase really was input-bound
    assert late < early, (early, late)
    # the offline replay of the same report reaches a scale-up too
    replayed = asc.replay(report["timeseries"], _cfg(max_workers=2, interval=0.3, window=2.0,
                                                     dwell_secs=0.5), include_holds=False)
    assert any(d["kind"] == asc.SCALE_UP for d in replayed)
