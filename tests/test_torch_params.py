"""The port's ``params/`` (``Parameter``, ``field``, ``ParamError``,
``Registry``, ``Config``) and ``examples/parameter_demo.py`` against the
JAX package's: each of the 13 cases of ``tests/test_params.py`` runs the
same calls through both packages, and the values, errors (type name and
text), dicts, JSON, docs and config dumps they give must be equal; the
JAX test's own expectations are then checked on the port's outcome. The
demo's output equals the JAX example's (``tests/test_examples.py:43``)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import dmlc_core_tpu.params as jax_params
import dmlc_core_tpu_torch.params as port_params

REPO = Path(__file__).resolve().parent.parent


def outcome(fn):
    """("ok", value) or (exception type name, text)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared across the packages
        return (type(e).__name__, str(e))


def learn_param(m):
    class LearnParam(m.Parameter):
        num_hidden = m.field(int, default=64, lower=1, help="number of hidden units")
        lr = m.field(float, default=0.1, lower=0.0, upper=10.0, aliases=("learning_rate",))
        name = m.field(str, default="net")
        act = m.field(str, default="relu", enum={"relu": "relu", "sigmoid": "sigmoid"})
        verbose = m.field(bool, default=False)

    return LearnParam


def defaults_and_init(m):
    p = learn_param(m)()
    before = (p.num_hidden, p.lr, p.act)
    p.init({"num_hidden": "128", "lr": "0.5", "verbose": "true"})
    return [before, (p.num_hidden, p.lr, p.verbose)]


def range_check(m):
    p = learn_param(m)()
    return [outcome(lambda: p.init({"num_hidden": 0})), outcome(lambda: p.init({"lr": 100.0}))]


def enum_and_alias(m):
    p = learn_param(m)(act="sigmoid", learning_rate=0.9)
    return [(p.act, p.lr), outcome(lambda: p.init({"act": "softmax"}))]


def unknown_key_suggestion(m):
    p = learn_param(m)()
    return [outcome(lambda: p.init({"num_hiden": 3})),
            p.init({"totally_new": 1}, allow_unknown=True)]


def dict_json_doc_roundtrip(m):
    cls = learn_param(m)
    p = cls(num_hidden=5)
    q = cls()
    q.load_json(p.save_json())
    return [p.to_dict(), p.save_json(), q == p, cls.doc()]


def bad_type(m):
    p = learn_param(m)()
    return [outcome(lambda: p.init({"num_hidden": "not_an_int"}))]


def registry_basic(m):
    reg = m.Registry("test_kind")
    try:
        @reg.register("alpha")
        def make_alpha(x):
            return ("alpha", x)

        entry = reg.lookup("alpha").describe("the alpha factory")
        out = [entry.description, reg.create("alpha", 3), reg.find("missing"),
               outcome(lambda: reg.add("alpha", make_alpha))]
        reg.add("alpha", lambda x: ("alpha2", x), override=True)
        out += [reg.create("alpha", 1), m.Registry.get("test_kind") is reg, reg.names()]
        return out
    finally:
        m.Registry._instances.pop("test_kind", None)


def config_parse(m):
    cfg = m.Config("""
    # a comment
    lr = 0.1
    name = "hello world" # trailing
    esc = "a\\"b\\nc"
    n = 3
    """)
    return [cfg.get(k) for k in ("lr", "name", "esc", "n")] + ["lr" in cfg, "missing" in cfg,
                                                               list(cfg)]


def config_multi_value_and_order(m):
    cfg = m.Config(multi_value=True)
    cfg.load("k = 1\nk = 2\nj = x\n")
    single = m.Config("k = 1\nk = 2\n")
    return [cfg.get_all("k"), list(cfg), single.get_all("k"), cfg.to_proto_string()]


def config_proto_string(m):
    return [m.Config('a = "x\\ny"\n').to_proto_string()]


def config_errors(m):
    return [outcome(lambda: m.Config(text))
            for text in ("= 1", 'k = "unterminated', "k 1", "a = = \nb = c", "= = x")]


def optional_none_roundtrip(m):
    class OptParam(m.Parameter):
        x = m.field(int, default=None)
        s = m.field(str, default=None)

    p, q = OptParam(), OptParam()
    q.load_json(p.save_json())
    out = [(q.x, q.s), p.save_json()]
    p.init({"x": 3})
    q.load_json(p.save_json())
    return out + [(q.x, q.s)]


def required_enforced_with_nonnull_default(m):
    class ReqParam(m.Parameter):
        path = m.field(str, default="", required=True)

    p = ReqParam()
    first = outcome(lambda: ReqParam().init({}))
    p.init({"path": "x"})
    return [first, p.path]


CASES = {f.__name__: f for f in (
    defaults_and_init, range_check, enum_and_alias, unknown_key_suggestion,
    dict_json_doc_roundtrip, bad_type, registry_basic, config_parse,
    config_multi_value_and_order, config_proto_string, config_errors,
    optional_none_roundtrip, required_enforced_with_nonnull_default)}


def _expect(case, got):
    """The JAX test's expectations (``tests/test_params.py``), on the
    port's outcome."""
    if case == "defaults_and_init":
        assert got == [(64, 0.1, "relu"), (128, 0.5, True)]
    elif case == "range_check":
        assert all(kind == "ParamError" and "out of range" in text for kind, text in got)
    elif case == "enum_and_alias":
        assert got[0] == ("sigmoid", 0.9)
        assert got[1][0] == "ParamError" and "expected one of" in got[1][1]
    elif case == "unknown_key_suggestion":
        assert got[0][0] == "ParamError" and "num_hidden" in got[0][1]
        assert got[1] == {"totally_new": 1}
    elif case == "dict_json_doc_roundtrip":
        assert got[0]["num_hidden"] == "5" and got[2] is True
        assert "num_hidden" in got[3] and "hidden units" in got[3]
    elif case == "bad_type":
        assert got[0][0] == "ParamError" and "Invalid value" in got[0][1]
    elif case == "registry_basic":
        assert got[:3] == ["the alpha factory", ("alpha", 3), None]
        assert "already registered" in got[3][1]
        assert got[4:6] == [("alpha2", 1), True]
    elif case == "config_parse":
        assert got[:6] == ["0.1", "hello world", 'a"b\nc', "3", True, False]
    elif case == "config_multi_value_and_order":
        assert got[0] == ["1", "2"] and got[1] == [("k", "1"), ("k", "2"), ("j", "x")]
        assert got[2] == ["2"]
    elif case == "config_proto_string":
        assert got == ['a : "x\\ny"\n']
    elif case == "config_errors":
        assert all(kind != "ok" for kind, _ in got)
    elif case == "optional_none_roundtrip":
        assert got[0] == (None, None) and got[2] == (3, None)
    elif case == "required_enforced_with_nonnull_default":
        assert got[0][0] == "ParamError" and "Required parameter" in got[0][1]
        assert got[1] == "x"


@pytest.mark.parametrize("case", sorted(CASES))
def test_params_match_jax(case):
    got = CASES[case](port_params)
    assert got == CASES[case](jax_params)
    _expect(case, got)


def test_parameter_demo_prints_what_the_jax_example_prints():
    args = ["learning_rate=0.1", "name=smoke"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    port = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.examples.parameter_demo",
                           *args], capture_output=True, text=True, timeout=120, env=env,
                          cwd=str(REPO))
    jax = subprocess.run([sys.executable, str(REPO / "examples" / "parameter_demo.py"), *args],
                         capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO))
    assert port.returncode == jax.returncode == 0, (port.stderr, jax.stderr)
    assert port.stdout == jax.stdout
    assert "initialized:" in port.stdout and "Step size." in port.stdout
    bad = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.examples.parameter_demo",
                          "learning_rate=0.1"], capture_output=True, text=True, timeout=120,
                         env=env, cwd=str(REPO))
    assert bad.returncode != 0 and "Required parameter" in bad.stderr
