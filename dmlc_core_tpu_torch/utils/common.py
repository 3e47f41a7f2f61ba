"""Misc shared helpers (the port of ``dmlc_core_tpu/utils/common.py``;
reference: include/dmlc/common.h).

- ``split_string``: common.h:23-34
- ``hash_combine``: common.h:37-47
- ``ThreadException``: the OMPException pattern — capture exceptions raised on
  worker threads and rethrow on the caller thread (common.h:53-87; also
  threadediter.h:490-505). Python threads swallow exceptions by default;
  ``run_parallel`` is the fan-out that rethrows the first one.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

__all__ = ["ThreadException", "hash_combine", "parse_bool", "run_parallel", "split_string"]


def split_string(s: str, delim: str) -> List[str]:
    """Split, dropping one empty trailing field like std::getline-based Split
    (reference common.h:23-34 keeps empty interior tokens; so do we)."""
    if s == "":
        return []
    out = s.split(delim)
    if out and out[-1] == "":
        out.pop()
    return out


_TRUTHY = frozenset(("1", "true", "yes", "on"))
_FALSY = frozenset(("0", "false", "no", "off", ""))


def parse_bool(s: str) -> bool:
    """The one bool-string parser, shared by env access, Parameter fields and
    debug-log gating so the DMLC_* env contract has a single semantics."""
    low = s.strip().lower()
    if low in _TRUTHY:
        return True
    if low in _FALSY:
        return False
    raise ValueError(f"not a boolean string: {s!r}")


def hash_combine(seed: int, value: int) -> int:
    """boost-style hash combine (reference common.h:37-47), mod 2**64."""
    seed ^= (hash(value) + 0x9E3779B9 + ((seed << 6) & 0xFFFFFFFFFFFFFFFF) + (seed >> 2)) & 0xFFFFFFFFFFFFFFFF
    return seed & 0xFFFFFFFFFFFFFFFF


class ThreadException:
    """Capture-first exception holder shared by a group of worker threads.

    Reference OMPException (common.h:53-87): Run() catches and stores the
    first exception; Rethrow() re-raises it on the caller. Usage:

        exc = ThreadException()
        threads = [Thread(target=exc.wrap(fn), args=...) ...]
        ...join...
        exc.rethrow()
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._exc: Optional[BaseException] = None

    def run(self, fn: Callable, *args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — must cross thread boundary
            with self._lock:
                if self._exc is None:
                    self._exc = e
            return None

    def wrap(self, fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            return self.run(fn, *args, **kwargs)

        return wrapped

    @property
    def exception(self) -> Optional[BaseException]:
        return self._exc

    def rethrow(self) -> None:
        if self._exc is not None:
            raise self._exc


def run_parallel(fns: Sequence[Callable[[], None]], daemon: bool = True) -> None:
    """Run callables on threads, join, and rethrow the first exception.

    The fan-out shape used by TextParserBase (reference
    src/data/text_parser.h:110-146).
    """
    if len(fns) == 1:
        fns[0]()
        return
    exc = ThreadException()
    threads = [threading.Thread(target=exc.wrap(fn), daemon=daemon) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    exc.rethrow()
