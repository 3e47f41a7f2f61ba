"""The ``staging_adopt_share`` reader: the share of staged batches copied
to the card with no pack copy, from the program's registry, over every
transfer path, and nothing where the program keeps no adoption counter
or staged nothing."""

from dmlc_core_tpu_torch.telemetry.registry import MetricRegistry

from perfbench import run


def _batches(reg, path, n):
    reg.counter("staging.batches", labels={"path": path}).inc(n)


def test_reads_the_share_over_every_path(monkeypatch):
    metric = run.load_metric("staging_adopt_share")
    reg = MetricRegistry()
    monkeypatch.setattr(metric, "default_registry", lambda: reg)
    assert metric.read(None) is None
    _batches(reg, "packed", 30)
    _batches(reg, "per_array", 10)
    assert metric.read(None) is None  # a program without the adoption counter
    adopted = reg.counter("staging.adopted_slots")
    assert metric.read(None) == 0.0  # the counter is there, nothing adopted
    adopted.inc(30)
    assert metric.read(None) == 75.0


def test_no_staged_batch_reads_nothing(monkeypatch):
    metric = run.load_metric("staging_adopt_share")
    reg = MetricRegistry()
    reg.counter("staging.adopted_slots")
    for path in ("packed", "packed_shard", "per_array"):
        _batches(reg, path, 0)
    monkeypatch.setattr(metric, "default_registry", lambda: reg)
    assert metric.read(None) is None
