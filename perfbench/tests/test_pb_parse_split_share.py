"""The ``parse_split_share`` reader: the share of emitted rows that split
native calls parsed, from the program's registry, and nothing where the
program keeps no split counter."""

from dmlc_core_tpu_torch.telemetry.registry import MetricRegistry

from perfbench import run


def test_reads_the_share_from_the_registry(monkeypatch):
    metric = run.load_metric("parse_split_share")
    reg = MetricRegistry()
    monkeypatch.setattr(metric, "default_registry", lambda: reg)
    assert metric.read(None) is None
    reg.counter("staging.rows_out").inc(400)
    assert metric.read(None) is None  # a program without the split counter
    reg.counter("staging.parse_split_rows").inc(300)
    assert metric.read(None) == 75.0


def test_no_rows_out_reads_nothing(monkeypatch):
    metric = run.load_metric("parse_split_share")
    reg = MetricRegistry()
    reg.counter("staging.rows_out")
    reg.counter("staging.parse_split_rows")
    monkeypatch.setattr(metric, "default_registry", lambda: reg)
    assert metric.read(None) is None
