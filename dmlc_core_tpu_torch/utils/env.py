"""Typed environment variable access (the port of
``dmlc_core_tpu/utils/env.py``, trimmed to ``get_env`` for numbers and
strings; reference dmlc::GetEnv, include/dmlc/parameter.h:1068-1096)."""

from __future__ import annotations

import os
from typing import TypeVar, Union

__all__ = ["get_env"]

T = TypeVar("T", bound=Union[int, float, str])


def get_env(key: str, default: T) -> T:
    """Env var ``key`` converted to the type of ``default`` (int, float
    or str), or ``default`` when it is unset."""
    raw = os.environ.get(key)
    if raw is None:
        return default
    return type(default)(raw)  # type: ignore[return-value]
