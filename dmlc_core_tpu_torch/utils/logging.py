"""Logging and CHECK machinery (the port of
``dmlc_core_tpu/utils/logging.py``; reference include/dmlc/logging.h).

- ``Error``: the framework exception (logging.h:29-35);
- ``check*``: CHECK/CHECK_EQ/... raising ``Error`` with both operands in
  the message (logging.h:205-218);
- ``log_*``: severity lines, timestamped on stderr (logging.h:315-338),
  or handed to the sink ``set_log_sink`` installs as ``(severity,
  message)`` (DMLC_LOG_CUSTOMIZE, logging.h:341-360); ``log_fatal``
  raises ``Error`` after logging (logging.h:408-435);
- ``log_debug`` only while ``DMLC_LOG_DEBUG`` is set (logging.h:131-146).

The port's library messages (checkpoint saves, stream writer warnings,
the row iterators' progress) go through these functions with the JAX
package's texts, so one sink sees the same pairs in either package.
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from typing import Any, Callable, Optional

__all__ = [
    "Error",
    "check",
    "check_eq",
    "check_ne",
    "check_lt",
    "check_le",
    "check_gt",
    "check_ge",
    "check_notnull",
    "log_info",
    "log_warning",
    "log_error",
    "log_fatal",
    "log_debug",
    "set_log_sink",
    "debug_logging_enabled",
]


class Error(RuntimeError):
    """Framework error type; all CHECK failures raise this."""


_log_sink: Optional[Callable[[str, str], None]] = None


def set_log_sink(sink: Optional[Callable[[str, str], None]]) -> None:
    """Send every log line to ``sink(severity, message)``; None restores
    the stderr default."""
    global _log_sink
    _log_sink = sink


def _emit(severity: str, msg: str) -> None:
    sink = _log_sink
    if sink is not None:
        sink(severity, msg)
        return
    stamp = time.strftime("%H:%M:%S", time.localtime())
    sys.stderr.write(f"[{stamp}] {severity} {msg}\n")


def debug_logging_enabled() -> bool:
    """``DMLC_LOG_DEBUG`` set to anything but empty, 0, false, no or off
    (an unrecognised value enables: logging never raises on its config)."""
    return os.environ.get("DMLC_LOG_DEBUG", "0").strip().lower() not in (
        "", "0", "false", "no", "off")


def log_info(msg: str) -> None:
    _emit("INFO", msg)


def log_warning(msg: str) -> None:
    _emit("WARNING", msg)


def log_error(msg: str) -> None:
    _emit("ERROR", msg)


def log_debug(msg: str) -> None:
    if debug_logging_enabled():
        _emit("DEBUG", msg)


def log_fatal(msg: str) -> None:
    """LOG(FATAL): log, then raise ``Error``."""
    _emit("FATAL", msg)
    raise Error(msg)


def _fail(op: str, x: Any, y: Any, msg: str) -> None:
    detail = f"Check failed: {x!r} {op} {y!r}"
    if msg:
        detail += f": {msg}"
    raise Error(detail)


def check(cond: Any, msg: str = "") -> None:
    """CHECK(cond): raise ``Error`` when ``cond`` is falsy."""
    if not cond:
        raise Error(f"Check failed: {msg}" if msg else "Check failed")


def check_eq(x: Any, y: Any, msg: str = "") -> None:
    if not (x == y):
        _fail("==", x, y, msg)


def check_ne(x: Any, y: Any, msg: str = "") -> None:
    if not (x != y):
        _fail("!=", x, y, msg)


def check_lt(x: Any, y: Any, msg: str = "") -> None:
    if not (x < y):
        _fail("<", x, y, msg)


def check_le(x: Any, y: Any, msg: str = "") -> None:
    if not (x <= y):
        _fail("<=", x, y, msg)


def check_gt(x: Any, y: Any, msg: str = "") -> None:
    if not (x > y):
        _fail(">", x, y, msg)


def check_ge(x: Any, y: Any, msg: str = "") -> None:
    if not (x >= y):
        _fail(">=", x, y, msg)


def check_notnull(x: Any, msg: str = "") -> Any:
    """CHECK_NOTNULL: ``x``, or raise ``Error`` when it is None."""
    if x is None:
        raise Error(f"Check notnull failed: {msg}" if msg else "Check notnull failed")
    return x


def format_exception(exc: BaseException) -> str:
    """``exc`` with its traceback, as one string."""
    return "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
