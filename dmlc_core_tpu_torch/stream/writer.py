"""StreamWriter: append records to a live, rotating RecordIO stream (the
port of ``dmlc_core_tpu/stream/writer.py``, whole).

One writer owns a local stream directory and grows it as::

    shard-00000.rec(+.idx)   sealed
    shard-00001.rec(+.idx)   sealed
    shard-00002.rec(+.idx)   live: readers read its committed prefix
    manifest.json            the commit point (stream/manifest.py)

``append()`` adds a record to the live shard's codec block; ``commit()``
makes everything appended so far durable (seal the pending block, flush
the data and the index, fsync by policy) and publishes the new (bytes,
records) watermark by an atomic manifest rename, so a tail-following
reader never sees a torn frame, index line or manifest. ``rotate()``
seals the live shard and opens the next generation, which readers take
as an epoch boundary. ``close(eos=True)`` seals the last shard and
raises the end-of-stream marker.

Bounded staleness: when readers publish acks (their consumed-record
count) and ``max_lag`` is set, ``append()`` holds back under
``lag_policy='block'`` until the slowest acked reader is within
``max_lag`` records of the watermark; ``'warn'`` logs and writes on.
The defaults come from ``DMLC_STREAM_MAX_LAG`` / ``DMLC_STREAM_LAG_POLICY``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

from ..io.recordio import DEFAULT_BLOCK_BYTES, IndexedRecordIOWriter
from ..io.stream import FileStream
from ..telemetry import default_registry
from ..telemetry import tracing as _tracing
from ..utils.env import get_env
from ..utils.logging import check, log_warning
from . import manifest as _manifest


_FSYNC_POLICIES = ("never", "commit", "rotate")
_LAG_POLICIES = ("block", "warn")


class StreamWriter:
    """A rotating RecordIO stream writer committed through its manifest
    (the live counterpart of ``IndexedRecordIOWriter``)."""

    def __init__(
        self,
        dir_path: str,
        codec: Optional[str] = "zlib",
        level: Optional[int] = None,
        block_bytes: int = DEFAULT_BLOCK_BYTES,
        rotate_bytes: int = 256 << 20,
        rotate_secs: Optional[float] = None,
        commit_records: int = 0,
        commit_secs: Optional[float] = None,
        fsync: str = "commit",
        max_lag: Optional[int] = None,
        lag_policy: Optional[str] = None,
        lag_poll_secs: float = 0.05,
    ) -> None:
        dir_path = _manifest._local_dir(dir_path)
        check("://" not in dir_path,
              f"StreamWriter writes a local directory, not {dir_path!r}")
        check(fsync in _FSYNC_POLICIES, f"fsync={fsync!r}: pick one of {_FSYNC_POLICIES}")
        self.dir_path = dir_path
        self._codec = codec
        self._level = level
        self._block_bytes = block_bytes
        self._rotate_bytes = rotate_bytes
        self._rotate_secs = rotate_secs
        self._commit_records = commit_records
        self._commit_secs = commit_secs
        self._fsync = fsync
        self.max_lag = (int(get_env("DMLC_STREAM_MAX_LAG", 0)) if max_lag is None
                        else int(max_lag))
        self.lag_policy = (get_env("DMLC_STREAM_LAG_POLICY", "block") if lag_policy is None
                           else lag_policy)
        check(self.lag_policy in _LAG_POLICIES,
              f"lag_policy={self.lag_policy!r}: pick one of {_LAG_POLICIES}")
        self._lag_poll = max(0.005, lag_poll_secs)
        reg = default_registry()
        self._c_commits = reg.counter("stream.commits", "manifest watermark publishes")
        self._c_rotations = reg.counter("stream.rotations",
                                        "live shard seals (dataset switches)")
        self._g_watermark = reg.gauge("stream.watermark_records",
                                      "total committed records in stream")
        self._g_lag = reg.gauge(
            "stream.lag_records",
            "committed records not yet consumed by the slowest acked reader")
        self._m = _manifest.new_manifest()
        self._gen = -1
        self._w: Optional[IndexedRecordIOWriter] = None
        self._data: Optional[FileStream] = None
        self._index: Optional[FileStream] = None
        self._opened_mono = 0.0
        self._last_commit_mono = 0.0
        self._uncommitted = 0
        self._warned_lag = False
        self.closed = False
        # counters of stats()
        self.commits = 0
        self.rotations = 0
        self.records_appended = 0
        self.backpressure_waits = 0
        self.backpressure_secs = 0.0
        self._open_next_shard()

    # -- shard lifecycle -----------------------------------------------------
    def _open_next_shard(self) -> None:
        self._gen += 1
        base = _manifest.shard_basename(self._gen)
        path = _manifest.join(self.dir_path, base)
        self._data = FileStream(path, "w")
        self._index = FileStream(path + ".idx", "w")
        self._w = IndexedRecordIOWriter(self._data, self._index, codec=self._codec,
                                        level=self._level, block_bytes=self._block_bytes)
        self._opened_mono = time.monotonic()
        self._last_commit_mono = self._opened_mono
        self._m["live"] = {
            "gen": self._gen,
            "data": base,
            "index": base + ".idx",
            "bytes": 0,
            "records": 0,
            "committed_unix": time.time(),
        }
        _manifest.write_manifest(self.dir_path, self._m)

    def _sealed_records(self) -> int:
        return sum(int(e["records"]) for e in self._m["sealed"])

    # -- bounded staleness ---------------------------------------------------
    def _reader_lag(self) -> Optional[int]:
        """Committed records minus the slowest acked reader's, or None
        when no reader acks (then nothing holds the writer back)."""
        acks = _manifest.read_acks(self.dir_path)
        if not acks:
            return None
        committed = self._sealed_records() + int(self._m["live"]["records"])
        return committed - min(int(a.get("records", 0)) for a in acks.values())

    def _enforce_lag(self) -> None:
        if self.max_lag <= 0:
            return
        lag = self._reader_lag()
        if lag is None:
            return
        self._g_lag.set(float(lag))
        if lag <= self.max_lag:
            self._warned_lag = False
            return
        if self.lag_policy == "warn":
            if not self._warned_lag:
                log_warning(f"stream {self.dir_path}: reader lag {lag} records "
                            f"exceeds DMLC_STREAM_MAX_LAG={self.max_lag} "
                            "(lag_policy=warn: writing on)")
                self._warned_lag = True
            return
        # block: wait until the slowest reader is back inside the bound
        self.backpressure_waits += 1
        t0 = time.monotonic()
        log_warning(f"stream {self.dir_path}: blocking writes — reader lag {lag} "
                    f"records > max_lag {self.max_lag}")
        with _tracing.span("dmlc:stream_backpressure", lag_records=lag):
            while True:
                time.sleep(self._lag_poll)
                lag = self._reader_lag()
                if lag is None or lag <= self.max_lag:
                    break
                self._g_lag.set(float(lag))
        self.backpressure_secs += time.monotonic() - t0

    # -- writing -------------------------------------------------------------
    def append(self, data: bytes, key: Optional[int] = None) -> None:
        check(not self.closed, "StreamWriter is closed")
        self._enforce_lag()
        assert self._w is not None
        self._w.write_record(data, key=key)
        self.records_appended += 1
        self._uncommitted += 1
        if self._commit_records > 0 and self._uncommitted >= self._commit_records:
            self.commit()
        elif (self._commit_secs is not None
              and time.monotonic() - self._last_commit_mono >= self._commit_secs):
            self.commit()

    def commit(self) -> Tuple[int, int]:
        """Durable commit and manifest publish; returns the live shard's
        (bytes, records) watermark, then rotates when the shard crossed
        its size or age budget."""
        check(not self.closed, "StreamWriter is closed")
        assert self._w is not None
        b, r = self._w.commit(fsync=self._fsync == "commit")
        live = self._m["live"]
        live["bytes"], live["records"] = b, r
        live["committed_unix"] = time.time()
        _manifest.write_manifest(self.dir_path, self._m, fsync=self._fsync == "commit")
        self.commits += 1
        self._uncommitted = 0
        self._last_commit_mono = time.monotonic()
        self._c_commits.inc()
        self._g_watermark.set(float(self._sealed_records() + r))
        if b >= self._rotate_bytes or (
                self._rotate_secs is not None
                and time.monotonic() - self._opened_mono >= self._rotate_secs and r > 0):
            self.rotate()
        return b, r

    def _seal_live(self, fsync: bool) -> None:
        assert self._w is not None
        b, r = self._w.commit(fsync=fsync)
        self._data.close()  # type: ignore[union-attr]
        self._index.close()  # type: ignore[union-attr]
        live = self._m["live"]
        self._m["sealed"].append({
            "gen": self._gen,
            "data": live["data"],
            "index": live["index"],
            "bytes": b,
            "records": r,
            "sealed_unix": time.time(),
        })
        self._m["live"] = None
        self._w = self._data = self._index = None

    def _live_empty(self) -> bool:
        assert self._w is not None
        return self._w.records_written == 0 and not self._w._blk_offs

    def rotate(self) -> None:
        """Seal the live shard and open the next generation: the
        readers' dataset-switch boundary. An empty live shard stays."""
        check(not self.closed, "StreamWriter is closed")
        if self._live_empty():
            return
        self._seal_live(fsync=self._fsync in ("commit", "rotate"))
        self.rotations += 1
        self._c_rotations.inc()
        self._open_next_shard()

    def close(self, eos: bool = True) -> None:
        """Seal the live shard (an empty one is deleted) and, with
        ``eos``, raise the end-of-stream marker that ends every follow."""
        if self.closed:
            return
        do_sync = self._fsync != "never"
        if self._w is not None:
            if not self._live_empty():
                self._seal_live(fsync=do_sync)
            else:
                self._data.close()  # type: ignore[union-attr]
                self._index.close()  # type: ignore[union-attr]
                live = self._m["live"]
                for name in (live["data"], live["index"]):
                    try:
                        os.remove(_manifest.join(self.dir_path, name))
                    except OSError:
                        pass
                self._m["live"] = None
                self._w = self._data = self._index = None
        if eos:
            self._m["eos"] = True
        _manifest.write_manifest(self.dir_path, self._m, fsync=do_sync)
        self._g_watermark.set(float(self._sealed_records()))
        self.closed = True

    # -- introspection -------------------------------------------------------
    @property
    def generation(self) -> int:
        return self._gen

    def manifest(self) -> Dict:
        return self._m

    def stats(self) -> Dict[str, float]:
        return {
            "commits": self.commits,
            "rotations": self.rotations,
            "records_appended": self.records_appended,
            "backpressure_waits": self.backpressure_waits,
            "backpressure_secs": round(self.backpressure_secs, 6),
        }

    def __enter__(self) -> "StreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close(eos=True)
