"""Typed environment variable access (the port of
``dmlc_core_tpu/utils/env.py``; reference dmlc::GetEnv/SetEnv,
include/dmlc/parameter.h:1068-1096). The env carries the DMLC_* launcher
contract between processes."""

from __future__ import annotations

import os
from typing import Type, TypeVar, Union

from .common import parse_bool

__all__ = ["get_env", "set_env"]

T = TypeVar("T", bound=Union[int, float, str, bool])


def get_env(key: str, default: T) -> T:
    """Env var ``key`` converted to the type of ``default``, or
    ``default`` when it is unset. A bool accepts 0/1/true/false/yes/no/
    on/off in any case and raises on anything else."""
    raw = os.environ.get(key)
    if raw is None:
        return default
    ty: Type = type(default)
    if ty is bool:
        return parse_bool(raw)  # type: ignore[return-value]
    return ty(raw)  # type: ignore[return-value]


def set_env(key: str, value: Union[int, float, str, bool]) -> None:
    """Set env var ``key``; a bool is written as 1 or 0 for the C++ side."""
    os.environ[key] = ("1" if value else "0") if isinstance(value, bool) else str(value)
