"""The port's LOG/CHECK layer and env access against the JAX package's, on
the CPU: the check family's failure texts, the sink's (severity, message)
pairs, ``log_fatal``, the ``DMLC_LOG_DEBUG`` gate, the stderr line,
``format_exception``, ``set_env``/``get_env``, the ``utils`` re-exports,
and the library messages the port routes through the sink (checkpoint
saves, the stream writer's lag warning) equal to the JAX package's."""

import os
import re

import numpy as np
import pytest

import dmlc_core_tpu.utils as jax_utils
from dmlc_core_tpu import checkpoint as jax_checkpoint
from dmlc_core_tpu.stream import StreamWriter as JaxWriter
from dmlc_core_tpu.stream import manifest as jax_sm
from dmlc_core_tpu.utils import env as jax_env
from dmlc_core_tpu.utils import logging as jax_logging
import dmlc_core_tpu_torch.utils as port_utils
from dmlc_core_tpu_torch import checkpoint
from dmlc_core_tpu_torch.stream import StreamWriter
from dmlc_core_tpu_torch.stream import manifest as sm
from dmlc_core_tpu_torch.utils import env
from dmlc_core_tpu_torch.utils import logging

BOTH = (logging, jax_logging)

CHECK_CASES = [
    ("check", (False,)),
    ("check", (False, "boom")),
    ("check", (0, "zero")),
    ("check_eq", (1, 2)),
    ("check_eq", ("a", "b", "strings")),
    ("check_ne", (3, 3)),
    ("check_ne", (3, 3, "same")),
    ("check_lt", (5, 5)),
    ("check_lt", (6, 5, "bigger")),
    ("check_le", (6, 5)),
    ("check_gt", (5, 5)),
    ("check_gt", (4.5, 5.0, "floats")),
    ("check_ge", (4, 5)),
    ("check_ge", (np.int64(4), 5, "numpy")),
    ("check_notnull", (None,)),
    ("check_notnull", (None, "missing")),
]


def failure(mod, name, args):
    with pytest.raises(mod.Error) as info:
        getattr(mod, name)(*args)
    return str(info.value)


@pytest.mark.parametrize("name,args", CHECK_CASES)
def test_check_failure_text_equals_jax(name, args):
    assert failure(logging, name, args) == failure(jax_logging, name, args)


@pytest.mark.parametrize("name,args", [
    ("check", (True,)), ("check_eq", (3, 3)), ("check_ne", (1, 2)), ("check_lt", (1, 2)),
    ("check_le", (2, 2)), ("check_gt", (3, 2)), ("check_ge", (2, 2)),
    ("check_notnull", ("x",)), ("check_notnull", (0, "zero is not null")),
])
def test_check_pass_returns_as_jax(name, args):
    assert getattr(logging, name)(*args) == getattr(jax_logging, name)(*args)


def sink_pairs(mod, calls):
    """The (severity, message) pairs a sink set in ``mod`` receives for
    ``calls`` (name, message); a raising call records its error text."""
    got = []
    mod.set_log_sink(lambda sev, msg: got.append((sev, msg)))
    try:
        for name, msg in calls:
            try:
                getattr(mod, name)(msg)
            except mod.Error as e:
                got.append(("raised", str(e)))
    finally:
        mod.set_log_sink(None)
    return got


def test_sink_sees_the_jax_pairs_for_every_severity(monkeypatch):
    monkeypatch.setenv("DMLC_LOG_DEBUG", "1")
    rng = np.random.default_rng(3)
    calls = [(name, f"message {int(rng.integers(1 << 30))} é\n2nd line")
             for name in ("log_info", "log_warning", "log_error", "log_debug",
                          "log_fatal", "log_info")]
    port, jax = sink_pairs(logging, calls), sink_pairs(jax_logging, calls)
    assert port == jax
    assert [sev for sev, _ in port] == ["INFO", "WARNING", "ERROR", "DEBUG", "FATAL",
                                        "raised", "INFO"]


def test_log_fatal_raises_error_after_the_sink():
    for mod in BOTH:
        assert sink_pairs(mod, [("log_fatal", "die")]) == [("FATAL", "die"),
                                                           ("raised", "die")]


@pytest.mark.parametrize("value", [None, "", "0", "false", "No", " off ", "1", "yes",
                                   "TRUE", "on", "bogus"])
def test_debug_gate_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("DMLC_LOG_DEBUG", raising=False)
    else:
        monkeypatch.setenv("DMLC_LOG_DEBUG", value)
    assert logging.debug_logging_enabled() == jax_logging.debug_logging_enabled()
    calls = [("log_debug", "dbg"), ("log_info", "info")]
    assert sink_pairs(logging, calls) == sink_pairs(jax_logging, calls)


def test_default_sink_writes_the_jax_stderr_line(capsys):
    lines = []
    for mod in BOTH:
        mod.set_log_sink(None)
        mod.log_warning("to stderr")
        lines.append(capsys.readouterr().err)
    pattern = r"\[\d\d:\d\d:\d\d\] WARNING to stderr\n"
    assert all(re.fullmatch(pattern, line) for line in lines), lines


def test_format_exception_equals_jax():
    try:
        try:
            raise ValueError("inner")
        except ValueError as e:
            raise logging.Error("outer") from e
    except logging.Error as exc:
        caught = exc
    assert logging.format_exception(caught) == jax_logging.format_exception(caught)
    assert "ValueError: inner" in logging.format_exception(caught)


@pytest.mark.parametrize("value,default", [
    (42, 0), (True, False), (False, True), (1.5, 0.0), ("text", ""), (7, "z"), (0, 2.5),
])
def test_set_env_then_get_env_as_jax(monkeypatch, value, default):
    monkeypatch.delenv("DMLC_TORCH_TEST_ENV", raising=False)
    env.set_env("DMLC_TORCH_TEST_ENV", value)
    raw = os.environ["DMLC_TORCH_TEST_ENV"]
    port = env.get_env("DMLC_TORCH_TEST_ENV", default)
    jax_env.set_env("DMLC_TORCH_TEST_ENV", value)
    assert os.environ["DMLC_TORCH_TEST_ENV"] == raw
    jax = jax_env.get_env("DMLC_TORCH_TEST_ENV", default)
    assert (type(port), port) == (type(jax), jax)


def test_get_env_bool_strings_as_jax(monkeypatch):
    for raw in ("1", "0", "true", "FALSE", "yes", "no", "On", "off"):
        monkeypatch.setenv("DMLC_TORCH_TEST_ENV", raw)
        assert env.get_env("DMLC_TORCH_TEST_ENV", False) is jax_env.get_env(
            "DMLC_TORCH_TEST_ENV", False)
    monkeypatch.setenv("DMLC_TORCH_TEST_ENV", "maybe")
    with pytest.raises(ValueError) as port:
        env.get_env("DMLC_TORCH_TEST_ENV", True)
    with pytest.raises(ValueError) as jax:
        jax_env.get_env("DMLC_TORCH_TEST_ENV", True)
    assert str(port.value) == str(jax.value)
    monkeypatch.delenv("DMLC_TORCH_TEST_ENV")
    assert env.get_env("DMLC_TORCH_TEST_ENV", 1.5) == 1.5


def test_utils_reexports_the_jax_names():
    names = [n for n in dir(jax_utils) if not n.startswith("_")
             and not isinstance(getattr(jax_utils, n), type(os))]
    assert names
    for name in names:
        assert callable(getattr(port_utils, name)) == callable(getattr(jax_utils, name)), name
    assert port_utils.Error is logging.Error


def test_checkpoint_lines_reach_the_sink_as_jax(tmp_path):
    """A save in each package: the sink's pairs are the JAX package's,
    the checkpoint directory aside."""
    tree = {"w": np.arange(6, dtype=np.float32), "b": np.float32(0.5)}
    got = {}
    for name, mod, make in (
            ("port", logging, lambda p: checkpoint.Checkpointer(str(p), keep=2)),
            ("jax", jax_logging,
             lambda p: jax_checkpoint.Checkpointer(str(p), keep=2, process_index=0))):
        base = tmp_path / name
        lines = []
        mod.set_log_sink(lambda sev, msg: lines.append((sev, msg)))
        try:
            ck = make(base)
            for step in (1, 2, 3):
                ck.save(step, tree)
            ck.save_async(4, tree).result()
        finally:
            mod.set_log_sink(None)
        got[name] = [(sev, msg.replace(str(base), "<dir>")) for sev, msg in lines]
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 4
    assert got["port"][-1][1].startswith("async checkpoint step 4 -> <dir>")


def test_stream_writer_lag_warning_reaches_the_sink_as_jax(tmp_path):
    got = {}
    for name, mod, writer, man in (("port", logging, StreamWriter, sm),
                                   ("jax", jax_logging, JaxWriter, jax_sm)):
        d = str(tmp_path / name)
        os.makedirs(d)
        man.write_ack(d, "r0", 0)
        lines = []
        mod.set_log_sink(lambda sev, msg: lines.append((sev, msg)))
        try:
            with writer(d, codec=None, commit_records=10, max_lag=5,
                        lag_policy="warn") as w:
                for i in range(50):
                    w.append(b"payload %d" % i)
        finally:
            mod.set_log_sink(None)
        got[name] = [(sev, msg.replace(d, "<dir>")) for sev, msg in lines]
    assert got["port"] == got["jax"]
    assert got["port"] and got["port"][0][0] == "WARNING"
