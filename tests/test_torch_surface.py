"""The port's public surface against the JAX package's: every module of
``dmlc_core_tpu`` (``tools/__main__`` aside) has its counterpart module
in ``dmlc_core_tpu_torch``, and every public name of it (``__all__``, or
the names without a leading underscore) and every public attribute of a
public class has a counterpart there, unless it is one of ``DEPARTURES``,
which ``ROADMAP.md`` lists as answered differently by design. A name
imported from outside the JAX package under its own name (``typing.Type``)
is not the package's surface.

Comparing file names alone let the records call the port complete while
most of the library interface (the Parser and InputSplit methods, the
LOG/CHECK layer, the stream adapters) was missing; this file compares
the interfaces."""

import importlib
import inspect
import os
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = "dmlc_core_tpu", "dmlc_core_tpu_torch"

# a JAX name the port leaves out on purpose -> why (ROADMAP.md §3, "Where
# the port answers differently by design", lists each key)
DEPARTURES = {
    "data.native.AVAILABLE": "the port builds its parse core at first use; "
                             "a failed build raises instead of clearing a flag",
    "data.native.HAS_DENSE": "as data.native.AVAILABLE",
    "data.native.HAS_CSV_DENSE": "as data.native.AVAILABLE",
    "data.native.HAS_ELL": "as data.native.AVAILABLE",
    "data.native.HAS_GATHER_ELL": "as data.native.AVAILABLE",
    "data.native.HAS_LIBFM_ELL": "as data.native.AVAILABLE",
    "data.native.HAS_LIBSVM_ELL": "as data.native.AVAILABLE",
    "models.fm.FactorizationMachine.init": "the port's models are nn.Modules "
                                           "that own their parameters",
    "models.linear.LinearRegression.init": "as models.fm.FactorizationMachine.init",
    "models.linear.LogisticRegression.init": "as models.fm.FactorizationMachine.init",
    "staging.pipeline.unpack_cache_stats": "the JAX jitted-unpacker LRU; the "
                                           "port unpacks with Tensor.view",
    "staging.pipeline.StagingStats.tick_puts": "per-device jax.device_put counts; "
                                               "the port counts its own copies",
    "staging.pipeline.StagingStats.tick_raw_puts": "as StagingStats.tick_puts",
}


def modules(package: str):
    """Dotted module names under ``package``, relative to it ('' for the
    package itself)."""
    out = []
    root = REPO / package
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).with_suffix("")
        parts = [p for p in rel.parts if p != "__init__"]
        if any(p.startswith("_") and p != "__main__" for p in parts):
            continue
        out.append(".".join(parts))
    return out


def public_names(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for name in names:
        obj = getattr(mod, name)
        if inspect.ismodule(obj):
            continue
        home = getattr(obj, "__module__", None)
        if (callable(obj) and isinstance(home, str) and not home.startswith(JAX)
                and getattr(obj, "__name__", None) == name):
            continue  # an outside name imported as itself (typing.Type)
        out.append(name)
    return out


def key(mod_name: str, name: str, obj, attr: str = "") -> str:
    """The departure key of ``name`` (and ``attr``) as the JAX package
    defines it: a class or function by its home module."""
    home = getattr(obj, "__module__", "") if inspect.isclass(obj) or inspect.isfunction(
        obj) else ""
    base = home[len(JAX) + 1:] if home.startswith(JAX + ".") else mod_name
    qual = getattr(obj, "__qualname__", name) if home.startswith(JAX) else name
    return ".".join(p for p in (base, qual, attr) if p)


def missing(rel: str):
    """Keys of ``rel``'s JAX surface without a port counterpart."""
    jax = importlib.import_module(f"{JAX}.{rel}" if rel else JAX)
    port = importlib.import_module(f"{PORT}.{rel}" if rel else PORT)
    out = set()
    for name in public_names(jax):
        obj = getattr(jax, name)
        if not hasattr(port, name):
            out.add(key(rel, name, obj))
            continue
        if inspect.isclass(obj):
            mine = getattr(port, name)
            for attr in dir(obj):
                if not attr.startswith("_") and not hasattr(mine, attr):
                    out.add(key(rel, name, obj, attr))
    return out


JAX_MODULES = [m for m in modules(JAX) if m != "tools.__main__"]


def test_every_jax_module_has_a_port_module():
    port = set(modules(PORT))
    assert len(JAX_MODULES) > 80
    assert [m for m in JAX_MODULES if m not in port] == []


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_surface_has_its_counterpart(rel):
    assert sorted(missing(rel) - set(DEPARTURES)) == []


def test_departures_are_still_missing_and_listed_in_the_roadmap():
    """No stale entry: each departure is still absent from the port, and
    each one is named in ROADMAP.md's list of departures by design."""
    seen = set()
    for rel in JAX_MODULES:
        seen |= missing(rel)
    assert sorted(set(DEPARTURES) - seen) == []
    roadmap = (REPO / "ROADMAP.md").read_text()
    section = roadmap[roadmap.index("**Where the port answers differently by design.**"):]
    assert [k for k in DEPARTURES if f"`{k}`" not in section] == []


def test_the_guard_sees_a_missing_method(monkeypatch):
    """A method taken away from a port class is reported by its key."""
    from dmlc_core_tpu_torch.data import parser

    monkeypatch.delattr(parser.Parser, "bytes_read")
    got = missing("data.parser")
    assert "data.parser.Parser.bytes_read" in got
    assert "data.parser.ThreadedParser.bytes_read" not in got  # defined on the subclass
    assert os.path.exists(REPO / PORT / "data" / "parser.py")
