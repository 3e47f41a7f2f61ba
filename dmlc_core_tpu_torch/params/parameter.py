"""Declarative, self-documenting parameter structs.

The port of ``dmlc_core_tpu/params/parameter.py``, itself a rethink of
the reference Parameter module (reference: include/dmlc/parameter.h). The reference does struct reflection without RTTI
via byte offsets (parameter.h:628-650); in Python the natural mechanism is a
metaclass collecting ``field()`` descriptors. Feature parity:

- declare fields with type, default, range, enum values, aliases
  (DMLC_DECLARE_FIELD + set_default/set_range/add_enum/set_lower_bound,
  reference parameter.h:658-704,766-782)
- ``init(kwargs)`` with unknown-arg policies and "did you mean" suggestions
  (reference parameter.h:140-165,395-435,511-545)
- ``to_dict`` / ``update`` (__DICT__, reference parameter.h:181-190)
- JSON save/load (reference parameter.h:190-202)
- docstring generation (__DOC__, reference parameter.h:214-218 and
  doc/parameter.md)
- typed env access lives in utils.env (reference parameter.h:1068-1096)

The port's parsers and launcher options keep their own argument handling,
which the tests hold to the JAX package's; this is the struct user code
declares its own parameters with.
"""

from __future__ import annotations

import difflib
import json
from typing import Any, Dict, List, Optional, Sequence, Type

from ..utils.common import parse_bool
from ..utils.logging import Error

__all__ = ["field", "Parameter", "ParamError"]


class ParamError(Error):
    """Raised on bad parameter values/unknown keys (reference throws dmlc::Error)."""


class field:
    """A declared parameter field (reference FieldEntry, parameter.h:569-800).

    Supported types: bool, int, float, str, and optional variants (allow
    None default, like dmlc::optional fields).
    """

    __slots__ = (
        "type",
        "default",
        "help",
        "lower",
        "upper",
        "enum",
        "aliases",
        "name",
        "required",
    )

    def __init__(
        self,
        type: Type,
        default: Any = None,
        help: str = "",
        lower: Any = None,
        upper: Any = None,
        enum: Optional[Dict[str, Any]] = None,
        aliases: Sequence[str] = (),
        required: bool = False,
    ) -> None:
        self.type = type
        self.default = default
        self.help = help
        self.lower = lower
        self.upper = upper
        # enum maps string name -> stored value (reference add_enum,
        # parameter.h:766-782, stores int; we allow any value type).
        self.enum = dict(enum) if enum else None
        self.aliases = tuple(aliases)
        self.required = required
        self.name = ""  # filled by the metaclass

    # -- value coercion & checking ------------------------------------------
    def coerce(self, value: Any) -> Any:
        """str→typed conversion mirroring the reference's istream-based Set
        (parameter.h:588-607) plus enum lookup."""
        if self.enum is not None:
            if isinstance(value, str) and value in self.enum:
                value = self.enum[value]
            elif value not in self.enum.values():
                raise ParamError(
                    f"Invalid value {value!r} for parameter {self.name}; "
                    f"expected one of {sorted(self.enum)}"
                )
            return value
        if value is None:
            return None
        if isinstance(value, str) and value == "None" and self.default is None:
            # optional fields round-trip None as the string "None", mirroring
            # dmlc::optional's "None" stream parsing (reference optional.h:205).
            return None
        ty = self.type
        try:
            if ty is bool:
                if isinstance(value, str):
                    return parse_bool(value)
                return bool(value)
            if ty is int:
                if isinstance(value, bool):
                    return int(value)
                if isinstance(value, float) and not value.is_integer():
                    raise ValueError(value)
                return int(value)
            if ty is float:
                return float(value)
            if ty is str:
                return str(value)
            return ty(value)
        except (TypeError, ValueError) as e:
            raise ParamError(
                f"Invalid value {value!r} for parameter {self.name} "
                f"(expected {ty.__name__})"
            ) from e

    def check_range(self, value: Any) -> None:
        """Range enforcement (reference FieldEntryNumeric, parameter.h:658-704)."""
        if value is None:
            return
        if self.lower is not None and value < self.lower:
            raise ParamError(
                f"Parameter {self.name}={value!r} out of range: expected >= {self.lower}"
            )
        if self.upper is not None and value > self.upper:
            raise ParamError(
                f"Parameter {self.name}={value!r} out of range: expected <= {self.upper}"
            )

    def describe(self) -> str:
        """One docstring line (reference FieldAccessEntry description fields)."""
        parts = [f"{self.name} : {self.type.__name__}"]
        if self.enum is not None:
            parts[0] = f"{self.name} : {{{', '.join(sorted(self.enum))}}}"
        if self.required:
            parts.append("required")
        else:
            parts.append(f"default={self.default!r}")
        if self.lower is not None or self.upper is not None:
            lo = self.lower if self.lower is not None else "-inf"
            hi = self.upper if self.upper is not None else "+inf"
            parts.append(f"range=[{lo}, {hi}]")
        head = ", ".join(parts)
        return f"{head}\n    {self.help}" if self.help else head


class _ParameterMeta(type):
    def __new__(mcls, name, bases, ns):
        fields: Dict[str, field] = {}
        for base in bases:
            fields.update(getattr(base, "__fields__", {}))
        for key, val in list(ns.items()):
            if isinstance(val, field):
                val.name = key
                fields[key] = val
                ns.pop(key)
        ns["__fields__"] = fields
        alias_map: Dict[str, str] = {}
        for key, f in fields.items():
            for a in f.aliases:
                alias_map[a] = key
        ns["__aliases__"] = alias_map
        return super().__new__(mcls, name, bases, ns)


class Parameter(metaclass=_ParameterMeta):
    """Base class for declarative parameter structs.

    Usage (compare reference example/parameter.cc and doc/parameter.md)::

        class MyParam(Parameter):
            num_hidden = field(int, default=64, lower=1, help="hidden units")
            act = field(str, default="relu", enum={"relu": "relu", "tanh": "tanh"})

        p = MyParam(num_hidden=128)
        leftover = p.init({"num_hidden": "256", "foo": 1}, allow_unknown=True)
    """

    __fields__: Dict[str, field] = {}
    __aliases__: Dict[str, str] = {}

    def __init__(self, **kwargs: Any) -> None:
        object.__setattr__(self, "_set_fields", set())
        for key, f in self.__fields__.items():
            object.__setattr__(self, key, f.default)
        if kwargs:
            self.init(kwargs)

    # -- core init ----------------------------------------------------------
    def init(
        self,
        kwargs: Dict[str, Any],
        allow_unknown: bool = False,
    ) -> Dict[str, Any]:
        """Set fields from kwargs; returns unknown entries.

        Mirrors Parameter::Init / InitAllowUnknown (reference
        parameter.h:140-165). Unknown keys raise with a near-miss suggestion
        (reference FindAlias/suggestion logic, parameter.h:511-545) unless
        ``allow_unknown``.
        """
        unknown: Dict[str, Any] = {}
        seen = set()
        for key, value in kwargs.items():
            canon = self.__aliases__.get(key, key)
            f = self.__fields__.get(canon)
            if f is None:
                if allow_unknown:
                    unknown[key] = value
                    continue
                hint = difflib.get_close_matches(key, list(self.__fields__), n=1)
                suggest = f" Did you mean {hint[0]!r}?" if hint else ""
                raise ParamError(
                    f"Unknown parameter {key!r} for {type(self).__name__}.{suggest}"
                )
            val = f.coerce(value)
            f.check_range(val)
            object.__setattr__(self, canon, val)
            seen.add(canon)
        self._set_fields.update(seen)
        for key, f in self.__fields__.items():
            if f.required and key not in self._set_fields:
                raise ParamError(
                    f"Required parameter {key!r} of {type(self).__name__} not set"
                )
        return unknown

    def __setattr__(self, key: str, value: Any) -> None:
        f = self.__fields__.get(key)
        if f is None:
            raise AttributeError(
                f"{type(self).__name__} has no parameter {key!r}"
            )
        val = f.coerce(value)
        f.check_range(val)
        object.__setattr__(self, key, val)
        self._set_fields.add(key)

    # -- reflection ---------------------------------------------------------
    def to_dict(self) -> Dict[str, str]:
        """__DICT__: everything stringified (reference parameter.h:181-190)."""
        out = {}
        for key, f in self.__fields__.items():
            val = getattr(self, key)
            if f.enum is not None:
                for name, ev in f.enum.items():
                    if ev == val:
                        val = name
                        break
            out[key] = str(val)
        return out

    def update(self, other: Dict[str, Any]) -> None:
        self.init(dict(other), allow_unknown=False)

    def save_json(self) -> str:
        """JSON round-trip (reference Parameter::Save, parameter.h:190-196)."""
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def load_json(self, text: str) -> None:
        """Reference Parameter::Load (parameter.h:197-202)."""
        self.init(json.loads(text))

    @classmethod
    def doc(cls) -> str:
        """__DOC__ docstring generation (reference parameter.h:214-218)."""
        lines = [f"Parameters of {cls.__name__}", "-" * (14 + len(cls.__name__))]
        for key in cls.__fields__:
            lines.append(cls.__fields__[key].describe())
        return "\n".join(lines)

    @classmethod
    def field_names(cls) -> List[str]:
        return list(cls.__fields__)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Parameter):
            return NotImplemented
        return type(self) is type(other) and all(
            getattr(self, k) == getattr(other, k) for k in self.__fields__
        )

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={getattr(self, k)!r}" for k in self.__fields__)
        return f"{type(self).__name__}({inner})"
