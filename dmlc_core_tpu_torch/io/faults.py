"""Deterministic fault injection over any registered filesystem: the
``fault://`` scheme (the port of ``dmlc_core_tpu/io/faults.py``, whole).

``FaultInjectingFileSystem`` wraps an inner backend and injects a
*seeded, deterministic* schedule of faults: short reads, mid-read
``ConnectionResetError``, N consecutive HTTP 503 before an open
succeeds, latency spikes and truncated writes. A clean read and a chaos
read of one file must be byte-identical; the retry layer heals the rest.
For one seed the schedule fires the same faults at the same read
ordinals as the JAX package's.

URI grammar (both forms compose; the host form survives the split
factory, which strips query args into dataset options):

  fault://[spec]/<path>[?spec]

``spec`` is comma- (host segment) or &-separated (query) ``k=v`` pairs:

  inner=<proto>   inner backend protocol (default: local file)
  seed=N          schedule seed (default 0)
  resets=N        N mid-read ConnectionResetErrors at seeded points
  short=N         N seeded short reads (a third of the ask returned)
  errors=N        N consecutive HTTP-503 open failures before success
  latency_ms=M    latency spikes of M milliseconds (count: spikes=N)
  spikes=N        number of latency spikes (default 2 when latency_ms)
  wresets=N       N truncated writes: half the payload lands, then reset
  cap=BYTES       max bytes served per read call (default 8192; small
                  caps create many read ordinals for the schedule)

Examples::

  fault://resets=2,errors=3,seed=7/data/train.rec?index=...&shuffle=window
  fault:///tmp/x.rec?resets=1&seed=5
  fault://inner=mem,resets=1/bucket/key.bin

Every fired fault ticks ``io.faults.injected`` (``retry.stats()``'s
``faults_injected``), next to the healed ``retries`` in ``io_stats()``.
Read streams come back wrapped in ``RetryingReadStream``, so injected
faults exercise exactly the retry path a remote read takes.
"""

from __future__ import annotations

import time
from random import Random
from typing import Dict, List, Optional, Tuple

from ..utils.logging import Error, check
from .filesystem import FS_REGISTRY, FileInfo, FileSystem
from .retry import (
    HttpError,
    RetryingReadStream,
    RetryPolicy,
    count_fault_injected,
)
from .stream import SeekStream, Stream
from .uri import URI

__all__ = ["FaultInjectingFileSystem", "FaultSpec", "wrap_uri", "unwrap_uri"]

_SPEC_KEYS = (
    "inner",
    "seed",
    "resets",
    "short",
    "errors",
    "latency_ms",
    "spikes",
    "wresets",
    "cap",
)


class FaultSpec:
    """Parsed fault schedule parameters (see module grammar)."""

    def __init__(self, args: Dict[str, str]) -> None:
        unknown = sorted(set(args) - set(_SPEC_KEYS))
        check(not unknown, f"unknown fault:// option(s) {unknown}")

        def num(key: str, default: int) -> int:
            raw = args.get(key)
            if raw is None:
                return default
            try:
                return int(raw)
            except ValueError:
                raise Error(
                    f"fault:// option {key}={raw!r} is not an integer"
                ) from None

        self.inner = args.get("inner", "file")
        self.seed = num("seed", 0)
        self.resets = num("resets", 0)
        self.short = num("short", 0)
        self.errors = num("errors", 0)
        self.latency_ms = num("latency_ms", 0)
        self.spikes = num("spikes", 2 if self.latency_ms else 0)
        self.wresets = num("wresets", 0)
        self.cap = num("cap", 8192)
        check(self.cap >= 1, f"fault:// cap={self.cap} must be >= 1")


def wrap_uri(uri: str, spec: str) -> str:
    """Prefix a plain local path / file:// URI with a fault:// host-form
    spec (``wrap_uri('/d/x.rec', 'resets=2,seed=7')`` →
    ``fault://resets=2,seed=7/d/x.rec``), so a chaos run is one flag
    away."""
    if not spec:
        return uri
    path = uri[len("file://"):] if uri.startswith("file://") else uri
    check(
        "://" not in path,
        f"wrap_uri only wraps local paths; name the backend in the spec "
        f"(inner=...) for {uri!r}",
    )
    if not path.startswith("/"):
        path = "/" + path
    return f"fault://{spec}{path}"


def unwrap_uri(uri: str) -> str:
    """Inverse of :func:`wrap_uri` for IDENTITY purposes: the inner URI
    a host-form ``fault://`` wrapper points at, unchanged for every
    other scheme. The shard service's fileset signature normalizes
    through this, so one chaos-wrapped worker reads the same data set
    as its clean peers. Query-form specs are not parsed: the split
    factory strips query args into options before a URI is used as an
    identity."""
    if not uri.startswith("fault://"):
        return uri
    rest = uri[len("fault://"):]
    slash = rest.find("/")
    if slash < 0:
        return uri
    spec_seg, path = rest[:slash], rest[slash:]
    args = dict(
        kv.split("=", 1) for kv in spec_seg.split(",") if "=" in kv
    )
    inner = args.get("inner", "file")
    if inner == "file":
        return path
    return f"{inner}://{path.lstrip('/')}"


class _Schedule:
    """Seeded, deterministic event schedule shared by every (re)open of
    one logical stream — consumed faults do not re-fire after the retry
    layer reopens.

    Events key on the READ ORDINAL (the k-th read call over the
    stream's lifetime), spaced every ~3 reads with seeded jitter, so
    they fire regardless of chunk sizes or seek patterns. Kinds:
    ``reset`` raises before serving bytes, ``short`` serves a third of
    the ask, ``latency`` sleeps then serves normally.
    """

    def __init__(self, spec: FaultSpec, key: str, incarnation: int) -> None:
        self.spec = spec
        rng = Random((spec.seed, key, incarnation).__repr__())
        kinds = (
            ["reset"] * spec.resets
            + ["short"] * spec.short
            + ["latency"] * spec.spikes
        )
        rng.shuffle(kinds)
        self.events: Dict[int, str] = {}
        ordinal = 0
        for kind in kinds:
            ordinal += 1 + rng.randint(1, 2)  # every 2-3 reads
            self.events[ordinal] = kind
        self.reads = 0
        self.open_errors_left = spec.errors
        self.write_resets_left = spec.wresets
        self.writes = 0

    def on_open(self) -> None:
        if self.open_errors_left > 0:
            self.open_errors_left -= 1
            count_fault_injected()
            raise HttpError(
                "GET (injected) -> HTTP 503: fault:// open error",
                status=503,
            )

    def on_read(self, n: int) -> Tuple[int, bool]:
        """Returns (bytes to serve, raise_reset_after_truncation)."""
        self.reads += 1
        kind = self.events.pop(self.reads, None)
        if kind is None:
            return n, False
        count_fault_injected()
        if kind == "reset":
            return 0, True
        if kind == "short":
            return max(1, n // 3), False
        time.sleep(self.spec.latency_ms / 1000.0)  # latency spike
        return n, False

    def on_write(self, n: int) -> Tuple[int, bool]:
        """Returns (bytes to land, raise_reset_after)."""
        self.writes += 1
        if self.write_resets_left > 0 and self.writes >= 2:
            # let the first write land so truncation is mid-object
            self.write_resets_left -= 1
            count_fault_injected()
            return max(0, n // 2), True
        return n, False


class _FaultyReadStream(SeekStream):
    """One incarnation of an injected read stream: serves the inner
    stream's bytes capped per call, firing the shared schedule."""

    def __init__(self, inner: SeekStream, sched: _Schedule) -> None:
        self._inner = inner
        self._sched = sched

    def read(self, n: int = -1) -> bytes:
        ask = self._sched.spec.cap if n < 0 else min(n, self._sched.spec.cap)
        serve, reset = self._sched.on_read(ask)
        if reset:
            raise ConnectionResetError("fault://: injected mid-read reset")
        return self._inner.read(serve)

    def seek(self, pos: int) -> None:
        self._inner.seek(pos)

    def tell(self) -> int:
        return self._inner.tell()

    def write(self, data) -> int:
        raise Error("fault:// read stream is read-only")

    def close(self) -> None:
        self._inner.close()


class _FaultyWriteStream(Stream):
    """Write wrapper injecting truncated writes: part of the payload
    lands, then the connection 'resets': the crash shape that
    ``checkpoint._write_atomic``'s verify-then-rename must catch."""

    def __init__(self, inner: Stream, sched: _Schedule) -> None:
        self._inner = inner
        self._sched = sched

    def read(self, n: int = -1) -> bytes:
        raise Error("fault:// write stream is write-only")

    def write(self, data) -> int:
        buf = bytes(data)
        land, reset = self._sched.on_write(len(buf))
        if land:
            self._inner.write(buf[:land])
        if reset:
            self._inner.flush()
            raise ConnectionResetError("fault://: injected truncated write")
        return len(buf)

    def flush(self) -> None:
        self._inner.flush()

    def close(self) -> None:
        self._inner.close()


class FaultInjectingFileSystem(FileSystem):
    """``fault://`` — wrap any inner filesystem with seeded faults."""

    protocol = "fault://"

    def __init__(self) -> None:
        # (uri) -> number of independent open() calls seen, so each
        # logical stream gets its own deterministic schedule incarnation
        self._opens: Dict[str, int] = {}

    # -- uri plumbing --------------------------------------------------------
    def _parse(self, uri: str) -> Tuple[str, FaultSpec, str]:
        """→ (inner_uri, spec, host_token). Host-form args and query-form
        args merge; query wins on collision."""
        base, _, query = uri.partition("?")
        u = URI(base)
        check(u.protocol == self.protocol, f"not a fault:// uri: {uri}")
        args: Dict[str, str] = {}
        host_token = u.host
        if host_token:
            for kv in host_token.split(","):
                if not kv:
                    continue
                k, _, v = kv.partition("=")
                args[k] = v
        for kv in query.split("&"):
            if not kv:
                continue
            k, _, v = kv.partition("=")
            args[k] = v
        spec = FaultSpec(args)
        if spec.inner == "file":
            inner = u.path
        else:
            # first path segment is the inner host (bucket/namenode)
            inner = f"{spec.inner}://{u.path.lstrip('/')}"
        return inner, spec, host_token

    def _inner_fs(self, inner_uri: str) -> FileSystem:
        return FileSystem.get_instance(inner_uri)

    def _refault(self, host_token: str, inner_path: str, spec: FaultSpec) -> str:
        """Re-prefix an inner listing path back into fault:// form."""
        if spec.inner != "file":
            proto = spec.inner + "://"
            check(
                inner_path.startswith(proto),
                f"inner listing returned non-{proto} path {inner_path!r}",
            )
            inner_path = "/" + inner_path[len(proto):]
        return f"{self.protocol}{host_token}{inner_path}"

    # -- FileSystem interface ------------------------------------------------
    def open(self, uri: str, mode: str = "r") -> Stream:
        inner_uri, spec, _host = self._parse(uri)
        fs = self._inner_fs(inner_uri)
        incarnation = self._opens.get(uri, 0)
        self._opens[uri] = incarnation + 1
        sched = _Schedule(spec, inner_uri, incarnation)
        if mode in ("r", "rb"):

            def open_inner() -> SeekStream:
                sched.on_open()
                s = fs.open(inner_uri, "r")
                check(
                    isinstance(s, SeekStream),
                    f"fault:// needs a seekable inner stream for {inner_uri}",
                )
                return _FaultyReadStream(s, sched)  # type: ignore[arg-type]

            return RetryingReadStream(open_inner, policy=RetryPolicy())
        if mode in ("w", "wb", "a"):
            sched.on_open()
            return _FaultyWriteStream(fs.open(inner_uri, mode[0]), sched)
        raise Error(f"invalid fault:// mode {mode!r}")

    def get_path_info(self, uri: str) -> FileInfo:
        inner_uri, spec, host = self._parse(uri)
        info = self._inner_fs(inner_uri).get_path_info(inner_uri)
        return FileInfo(
            self._refault(host, info.path, spec), info.size, info.type,
            info.etag,
        )

    def list_directory(self, uri: str) -> List[FileInfo]:
        inner_uri, spec, host = self._parse(uri)
        return [
            FileInfo(
                self._refault(host, f.path, spec), f.size, f.type, f.etag
            )
            for f in self._inner_fs(inner_uri).list_directory(inner_uri)
        ]

    def delete(self, uri: str, recursive: bool = False) -> None:
        inner_uri, _spec, _host = self._parse(uri)
        self._inner_fs(inner_uri).delete(inner_uri, recursive=recursive)


_SINGLETON: Optional[FaultInjectingFileSystem] = None


def _singleton() -> FaultInjectingFileSystem:
    global _SINGLETON
    if _SINGLETON is None:
        _SINGLETON = FaultInjectingFileSystem()
    return _SINGLETON


FS_REGISTRY.setdefault("fault://", _singleton)
