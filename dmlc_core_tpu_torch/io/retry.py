"""Transient-failure classification, backoff and the retrying read
stream (the port of ``dmlc_core_tpu/io/retry.py``).

- ``is_transient``: would a retry plausibly succeed? HTTP 408/429/5xx,
  socket-caused URLErrors, connection resets, refusals, aborts, timeouts
  and short HTTP bodies yes; anything else no.
- ``RetryPolicy``: exponential backoff with decorrelated jitter
  (``min(cap, uniform(base, 3*prev))``), a per-operation attempt cap and
  a cumulative backoff budget shared by every operation of one policy.
- ``count_fault_injected``: the counter every fired chaos fault ticks.
- ``stats()``/``stats_delta()``/``reset_stats()``: the io_stats() view
  over the registry series ``io.retry.retries``,
  ``io.retry.backoff_seconds`` and ``io.faults.injected`` (a
  ``ScopedView``; the series stay monotonic, ``reset_stats`` rebases
  the view). Each backoff sleep is a ``dmlc:retry_backoff`` span.

- ``request``: one HTTP round trip with that retry, the port's single
  urlopen site (``tools top`` polls the tracker's endpoint through it);
  HTTP errors raise ``HttpError`` with the status and headers.

- ``RetryingReadStream``: reopen-and-seek read wrapper over any seekable
  stream. ``fault://`` wraps its injected streams in one, and the span
  fetcher one per pooled connection, so chaos runs exercise exactly
  this path.

Env knobs (read at policy construction): DMLC_RETRY_ATTEMPTS (4),
DMLC_RETRY_BASE_SECS (0.1), DMLC_RETRY_CAP_SECS (5.0),
DMLC_RETRY_BUDGET_SECS (60.0).
"""

from __future__ import annotations

import http.client
import os
import random
import socket
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional

from ..telemetry import default_registry as _default_registry
from ..telemetry import tracing as _tracing
from ..utils.logging import Error
from .stream import SeekStream

__all__ = [
    "HttpError",
    "RetryPolicy",
    "RetryingReadStream",
    "count_fault_injected",
    "is_transient",
    "request",
    "reset_stats",
    "stats",
    "stats_delta",
]

_registry = _default_registry()
_RETRIES = _registry.counter(
    "io.retry.retries", help="transient-failure retries healed"
)
_BACKOFF = _registry.counter(
    "io.retry.backoff_seconds", help="total retry backoff slept (secs)"
)
_FAULTS = _registry.counter(
    "io.faults.injected", help="faults fired by the fault:// layer"
)

_SERIES = ("io.retry.retries", "io.retry.backoff_seconds", "io.faults.injected")
_VIEW_LOCK = threading.Lock()  # guards the shared view's baseline swap
_VIEW = _registry.scoped(names=_SERIES)


# HTTP statuses worth retrying besides the 5xx band
_TRANSIENT_HTTP = frozenset({408, 429})


class HttpError(Error):
    """HTTP-level failure carrying the status and response headers
    (the message keeps the ``... -> HTTP <code>: <body>`` form).
    ``header()`` looks a name up case-insensitively."""

    def __init__(self, message: str, status: int, headers=None) -> None:
        super().__init__(message)
        self.status = status
        self.headers: Dict[str, str] = dict(headers or {})

    def header(self, name: str, default: Optional[str] = None) -> Optional[str]:
        want = name.lower()
        for k, v in self.headers.items():
            if k.lower() == want:
                return v
        return default


def is_transient(exc: BaseException) -> bool:
    """Would a retry plausibly succeed? HTTP 408/429/5xx, socket-caused
    URLErrors, short bodies, resets, refusals and timeouts: yes;
    everything else (4xx, parse errors): no."""
    if isinstance(exc, HttpError):
        return exc.status in _TRANSIENT_HTTP or 500 <= exc.status <= 599
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code in _TRANSIENT_HTTP or 500 <= exc.code <= 599
    if isinstance(exc, urllib.error.URLError):
        # reason is an exception for socket-level failures and a string
        # for protocol-level ones
        return isinstance(exc.reason, (OSError, TimeoutError))
    return isinstance(
        exc,
        (
            http.client.IncompleteRead,
            http.client.BadStatusLine,
            ConnectionError,
            TimeoutError,
            socket.timeout,
        ),
    )


def _count_retry(backoff: float) -> None:
    _RETRIES.inc()
    _BACKOFF.inc(backoff)


def count_fault_injected(n: int = 1) -> None:
    """Called per fired chaos fault, so injected faults are counted next
    to the healed retries."""
    _FAULTS.inc(n)


def stats() -> Dict[str, float]:
    """The process's counters since the last ``reset_stats()``:
    ``retries``, ``backoff_secs`` and ``faults_injected``. The three
    series are read without a joint lock (each is thread-sharded), so a
    retry completing mid-read can skew one field against another by one
    increment; read after quiescing for exact triples."""
    with _VIEW_LOCK:
        d = _VIEW.delta()
    return {
        "retries": int(d.get("io.retry.retries", 0)),
        "backoff_secs": round(float(d.get("io.retry.backoff_seconds", 0.0)), 6),
        "faults_injected": int(d.get("io.faults.injected", 0)),
    }


def stats_delta(snapshot: Dict[str, float]) -> Dict[str, float]:
    """Counters accumulated since ``snapshot`` (an earlier stats())."""
    now = stats()
    return {
        "retries": int(now["retries"] - snapshot.get("retries", 0)),
        "backoff_secs": round(
            float(now["backoff_secs"] - snapshot.get("backoff_secs", 0.0)), 6
        ),
        "faults_injected": int(
            now["faults_injected"] - snapshot.get("faults_injected", 0)
        ),
    }


def reset_stats() -> None:
    """Zero the stats() view (test isolation). The registry counters
    stay monotonic; only the view's baseline moves."""
    with _VIEW_LOCK:
        _VIEW.rebase()


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class RetryPolicy:
    """Backoff schedule and budgets for one logical operation stream.

    - ``max_attempts``: one operation is tried at most this many times.
    - ``budget_secs``: total backoff sleep across every operation of this
      instance; once spent, the next would-be retry re-raises.
    - backoff: ``min(cap, uniform(base, 3*prev))``, from ``rng`` when
      given (deterministic tests).
    """

    def __init__(
        self,
        max_attempts: Optional[int] = None,
        base_secs: Optional[float] = None,
        cap_secs: Optional[float] = None,
        budget_secs: Optional[float] = None,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.max_attempts = max(
            1,
            int(max_attempts)
            if max_attempts is not None
            else int(_env_float("DMLC_RETRY_ATTEMPTS", 4)),
        )
        self.base_secs = (base_secs if base_secs is not None
                          else _env_float("DMLC_RETRY_BASE_SECS", 0.1))
        self.cap_secs = (cap_secs if cap_secs is not None
                         else _env_float("DMLC_RETRY_CAP_SECS", 5.0))
        self.budget_secs = (budget_secs if budget_secs is not None
                            else _env_float("DMLC_RETRY_BUDGET_SECS", 60.0))
        self._sleep = sleep
        self._rng = rng or random.Random()
        self._prev = self.base_secs
        self.retries = 0
        self.backoff_secs = 0.0

    def next_backoff(self) -> float:
        """Next decorrelated-jitter delay (does not sleep or count)."""
        hi = max(self.base_secs, self._prev * 3.0)
        delay = min(self.cap_secs, self._rng.uniform(self.base_secs, hi))
        self._prev = delay
        return delay

    def pause(self, cause: Optional[BaseException] = None, what: str = "") -> None:
        """One retry pause: sleep within the cumulative budget, or, with
        the budget spent, re-raise ``cause`` (the last error)."""
        delay = self.next_backoff()
        if self.backoff_secs + delay > self.budget_secs:
            err = Error(
                f"retry budget exhausted ({self.backoff_secs:.2f}s of "
                f"{self.budget_secs:.2f}s spent){': ' + what if what else ''}"
            )
            if cause is not None:
                raise cause from err
            raise err
        self.retries += 1
        self.backoff_secs += delay
        _count_retry(delay)
        # the backoff sleep is a stall on the trace timeline
        with _tracing.span(
            "dmlc:retry_backoff",
            what=what or None,
            delay_ms=round(delay * 1000.0, 3),
        ):
            self._sleep(delay)

    def run(self, fn: Callable[[], "object"], what: str = ""):
        """Call ``fn`` with transient-failure retry: other errors and
        exhaustion (attempts or budget) re-raise the last error."""
        attempt = 1
        while True:
            try:
                return fn()
            except Exception as exc:
                if not is_transient(exc) or attempt >= self.max_attempts:
                    raise
                self.pause(cause=exc, what=what)
                attempt += 1


def request(
    url: str,
    method: str = "GET",
    headers: Optional[Dict[str, str]] = None,
    data: Optional[bytes] = None,
    timeout: float = 60.0,
    policy: Optional[RetryPolicy] = None,
):
    """One HTTP round trip with transient-failure retry; returns the
    open response (the caller reads and closes it). Raises ``HttpError``
    on HTTP errors, ``Error`` on connection failures."""
    policy = policy or RetryPolicy()

    def once():
        req = urllib.request.Request(
            url, data=data, headers=headers or {}, method=method
        )
        return urllib.request.urlopen(req, timeout=timeout)

    try:
        return policy.run(once, what=f"{method} {url}")
    except urllib.error.HTTPError as e:
        body = e.read(4096).decode(errors="replace")
        raise HttpError(
            f"{method} {url} -> HTTP {e.code}: {body[:500]}",
            status=e.code,
            headers=e.headers,
        ) from e
    except urllib.error.URLError as e:
        raise Error(f"{method} {url} failed: {e.reason}") from e


class RetryingReadStream(SeekStream):
    """Reopen-and-seek retry wrapper over any seekable read stream.

    ``open_fn`` returns a FRESH inner SeekStream; each call is one open
    attempt, itself retried under the policy, so N consecutive 5xx at
    open before a success are invisible. A transient error mid-read
    drops the inner stream, backs off, reopens and seeks to the exact
    resume offset: the caller never sees the fault. Progress resets the
    consecutive-failure count, so the attempt cap bounds *stuck*
    retries, not the faults healed; the policy's cumulative budget
    bounds the total backoff either way.
    """

    def __init__(
        self,
        open_fn: Callable[[], SeekStream],
        policy: Optional[RetryPolicy] = None,
    ) -> None:
        self._open_fn = open_fn
        self._policy = policy or RetryPolicy()
        self._inner: Optional[SeekStream] = None
        self._pos = 0
        self._stalls = 0

    def _drop(self) -> None:
        if self._inner is not None:
            try:
                self._inner.close()
            except (OSError, Error):
                pass
            self._inner = None

    def _ensure(self) -> SeekStream:
        if self._inner is None:
            self._inner = self._policy.run(self._open_fn, what="open")
            if self._pos:
                self._inner.seek(self._pos)
        return self._inner

    def _read_once(self, n: int) -> Optional[bytes]:
        """One guarded inner read; None means 'faulted, retry'."""
        try:
            out = self._ensure().read(n)
        except Exception as exc:
            if not is_transient(exc):
                raise
            self._drop()
            self._stalls += 1
            if self._stalls >= self._policy.max_attempts:
                raise
            self._policy.pause(cause=exc, what=f"read at {self._pos}")
            return None
        self._stalls = 0
        if out:
            self._pos += len(out)
        return out

    def read(self, n: int = -1) -> bytes:
        if n == 0:
            return b""
        if n < 0:
            # read-to-EOF must not stop short at a healed fault: gather
            # until the inner stream reports a true EOF
            parts = []
            while True:
                out = self._read_once(1 << 20)
                if out is None:
                    continue
                if not out:
                    return b"".join(parts)
                parts.append(out)
        while True:
            out = self._read_once(n)
            if out is not None:
                return out

    def seek(self, pos: int) -> None:
        if pos == self._pos:
            return
        self._pos = pos
        if self._inner is not None:
            try:
                self._inner.seek(pos)
            except Exception as exc:
                if not is_transient(exc):
                    raise
                self._drop()  # reopened at _pos by the next read

    def tell(self) -> int:
        return self._pos

    def write(self, data) -> int:
        raise Error("RetryingReadStream is read-only")

    def close(self) -> None:
        self._drop()
