"""StreamSource: a split that follows a live stream (the port of
``dmlc_core_tpu/stream/source.py``, whole).

It follows the manifest (never a growing shard's file size or ``.idx``
tail) and serves the split contract of the port's producers, including
``next_gather_batch`` for the native gather kernel.

One reader (the default): the source reads every shard itself. Each
committed extent is a ranged read on a retrying stream (a big sealed
catch-up fans out through ``io/spanfetch.py``), its blocks are decoded
on the shared decode pool, and its framed records fill windows of
``window`` records. With ``shuffle`` each window is emitted in the
permutation ``_window_perm(seed, epoch, generation, window ordinal)``,
so a live follow emits the records in exactly the order a read of the
sealed stream does. A window never crosses a shard: a seal flushes the
last partial window, and EOS drains it. The time parked on the writer is
the ``dmlc:stream_tail_wait`` stall stage.

Several workers (``dynamic=True``): rotation is an epoch boundary of the
tracker's shard ledger. Generation ``g``'s sealed shard is drained as
ledger epoch ``g`` under one file-set signature, over leased
micro-shards committed exactly once; a worker done with generation ``g``
waits (the same stall stage) until the writer seals ``g+1`` or raises
EOS. The live tail is not read in this mode.

Telemetry: the ``stream.{watermark_records,lag_records,lag_seconds,
commits,rotations}`` metrics as the reader sees them.
"""

from __future__ import annotations

import random
import time
from collections import deque
from typing import Callable, Deque, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..io import retry as _retry
from ..io import split as _split
from ..io.filesystem import FileSystem
from ..io.recordio import RecordIOChunkReader, chunk_has_compressed, decode_chunk
from ..io.spanfetch import SpanFetcher
from ..telemetry import default_registry
from ..utils.env import get_env
from ..utils.logging import Error, check
from ..utils.profiler import annotate
from . import manifest as _manifest


def _window_perm(seed: int, epoch: int, gen: int, widx: int, n: int) -> List[int]:
    """One window's permutation: a plain integer mix (never ``hash()``)
    into ``random.Random``, so a live follow and a read of the sealed
    stream agree across processes, platforms and packages."""
    mix = ((seed * 1_000_003 + epoch) * 1_000_003 + gen) * 1_000_003 + widx
    rnd = random.Random(mix & 0xFFFFFFFFFFFFFFFF)
    perm = list(range(n))
    rnd.shuffle(perm)
    return perm


class StreamSource(_split.InputSplit):
    """Follow a stream directory as a split."""

    def __init__(
        self,
        dir_uri: str,
        shuffle=None,
        seed: int = 0,
        window: int = 8192,
        batch_size: int = 256,
        poll_secs: Optional[float] = None,
        max_extent: int = 8 << 20,
        spanfetch_bytes: int = 4 << 20,
        span_bytes: int = 1 << 20,
        dynamic: bool = False,
        threaded: bool = True,
        ack_id: Optional[str] = None,
        decode_ctx=None,
        max_idle_secs: Optional[float] = None,
    ) -> None:
        self.dir_uri = dir_uri.rstrip("/")
        self._shuffled = bool(_split.normalize_shuffle(shuffle))
        self._seed = int(seed)
        check(window >= 1, f"window={window} must be >= 1")
        self._window = int(window)
        self._batch_size = max(1, int(batch_size))
        self._poll = (float(get_env("DMLC_STREAM_POLL", 0.05)) if poll_secs is None
                      else float(poll_secs))
        self._max_extent = max(1 << 16, int(max_extent))
        self._spanfetch_bytes = int(spanfetch_bytes)
        self._span_bytes = max(1 << 16, int(span_bytes))
        self._dynamic = bool(dynamic)
        self._threaded = bool(threaded)
        self._ack_id = ack_id
        self._decode_ctx = decode_ctx
        self._max_idle = max_idle_secs
        reg = default_registry()
        self._g_watermark = reg.gauge("stream.watermark_records",
                                      "total committed records in stream")
        self._g_lag_records = reg.gauge("stream.lag_records",
                                        "committed records not yet consumed")
        self._g_lag_seconds = reg.gauge("stream.lag_seconds",
                                        "age of the oldest committed-but-unconsumed data")
        self._c_commits = reg.counter("stream.commits", "manifest watermark publishes")
        self._c_rotations = reg.counter("stream.rotations",
                                        "live shard seals (dataset switches)")
        # manifest-follow state
        self._m: Optional[Dict] = None
        self._m_mono = -1e18
        self._m_seq = 0
        self._hist: Deque[Tuple[float, int]] = deque()
        self._total_records = 0
        self._consumed_records = 0
        self._epoch = 0
        self._started = False
        self._closed = False
        self._last_ack_mono = 0.0
        # one reader: the tail state
        self._gen = 0
        self._consumed = 0  # committed bytes of the current shard read
        self._stream = None
        self._stream_gen = -1
        self._fetcher: Optional[SpanFetcher] = None
        self._parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._pending = 0
        self._widx = 0
        self._win_buf: Optional[np.ndarray] = None
        self._win_starts: Optional[np.ndarray] = None
        self._win_sizes: Optional[np.ndarray] = None
        self._win_pos = 0
        self._ended = False
        # several workers: the leased state
        self._dyn = None
        self._dyn_gen = 0
        self.on_lease: Optional[Callable] = None
        self.on_shard_done: Optional[Callable] = None
        # counters of io_stats()
        self.extents = 0
        self.bytes_read = 0
        self.windows = 0
        self.manifest_reads = 0
        self.tail_wait_secs = 0.0
        self.commits_seen = 0
        self.rotations_seen = 0

    # -- manifest follow -----------------------------------------------------
    def _refresh(self, force: bool = False) -> Optional[Dict]:
        now = time.monotonic()
        if not force and self._m is not None and now - self._m_mono < self._poll:
            return self._m
        m = _manifest.read_manifest(self.dir_uri)
        self.manifest_reads += 1
        self._m_mono = now
        if m is None:
            return self._m
        if self._m is not None:
            dseq = int(m["seq"]) - self._m_seq
            if dseq > 0:
                self.commits_seen += dseq
                self._c_commits.inc(dseq)
            drot = len(m["sealed"]) - len(self._m["sealed"])
            if drot > 0:
                self.rotations_seen += drot
                self._c_rotations.inc(drot)
        self._m, self._m_seq = m, int(m["seq"])
        total_r = _manifest.total_committed(m)[1]
        if total_r > self._total_records:
            self._hist.append((now, total_r))
            self._total_records = total_r
        self._g_watermark.set(float(total_r))
        self._note_progress()
        return m

    def _note_progress(self) -> None:
        """The lag gauges from consumed against committed records."""
        lag = self._total_records - self._consumed_records
        self._g_lag_records.set(float(max(0, lag)))
        self._g_lag_seconds.set(self.lag_seconds())

    def lag_seconds(self) -> float:
        """0 when caught up; else how long ago the oldest record not yet
        consumed was seen committed (the reader's own clock)."""
        while self._hist and self._hist[0][1] <= self._consumed_records:
            self._hist.popleft()
        if not self._hist:
            return 0.0
        return max(0.0, time.monotonic() - self._hist[0][0])

    def _maybe_ack(self, force: bool = False) -> None:
        if self._ack_id is None:
            return
        now = time.monotonic()
        if force or now - self._last_ack_mono >= self._poll:
            _manifest.write_ack(self.dir_uri, self._ack_id, self._consumed_records)
            self._last_ack_mono = now

    def _wait_for_writer(self, waited: float) -> float:
        """One parked poll under the ``stream_tail_wait`` stall stage;
        returns the wait so far for the idle limit."""
        if self._max_idle is not None and waited >= self._max_idle:
            raise Error(f"stream {self.dir_uri}: no writer progress in {waited:.1f}s "
                        f"(max_idle_secs={self._max_idle}); the writer died without "
                        "EOS, or the manifest is unreachable")
        t0 = time.monotonic()
        with annotate("dmlc:stream_tail_wait"):
            time.sleep(self._poll)
        dt = time.monotonic() - t0
        self.tail_wait_secs += dt
        self._refresh(force=True)
        self._note_progress()
        # a parked reader is caught up: its ack must stay fresh, or a
        # writer held back by it waits on a stale count for good
        self._maybe_ack()
        return waited + dt

    # -- one reader: the tail ------------------------------------------------
    def _shard_uri(self, ent: Dict) -> str:
        return _manifest.join(self.dir_uri, ent["data"])

    def _open_stream(self, ent: Dict):
        if self._stream is not None and self._stream_gen == int(ent["gen"]):
            return self._stream
        self._close_stream()
        uri = self._shard_uri(ent)
        fs = FileSystem.get_instance(uri)
        self._stream = _retry.RetryingReadStream(lambda: fs.open(uri, "r"),
                                                 policy=_retry.RetryPolicy())
        self._stream_gen = int(ent["gen"])
        return self._stream

    def _close_stream(self) -> None:
        if self._stream is not None:
            try:
                self._stream.close()
            except (OSError, Error):
                pass
            self._stream = None
        if self._fetcher is not None:
            self._fetcher.close()
            self._fetcher = None
        self._stream_gen = -1

    def _read_range(self, ent: Dict, lo: int, hi: int, sealed: bool) -> bytes:
        """Bytes [lo, hi) of the shard: one retrying ranged read, or the
        span fetcher's parallel reads for a big sealed catch-up."""
        nbytes = hi - lo
        uri = self._shard_uri(ent)
        if sealed and nbytes >= self._spanfetch_bytes:
            if self._fetcher is None or self._stream_gen != int(ent["gen"]):
                self._open_stream(ent)  # pins _stream_gen for the test above
                fs = FileSystem.get_instance(uri)
                info = fs.get_path_info(uri)
                self._fetcher = SpanFetcher([info], [0, info.size], fs)
            out = bytearray(nbytes)
            spans, bases = [], []
            at = lo
            while at < hi:
                take = min(self._span_bytes, hi - at)
                spans.append((at, take))
                bases.append(at - lo)
                at += take
            self._fetcher.fetch_into(spans, memoryview(out), bases)
            return bytes(out)
        s = self._open_stream(ent)
        s.seek(lo)
        return s.read_exact(nbytes)

    def _pull_extent(self, ent: Dict, sealed: bool) -> bool:
        """Read the next committed extent of the current shard into the
        pending window parts; False when caught up to the watermark."""
        hi = int(ent["bytes"])
        lo = self._consumed
        if lo >= hi:
            return False
        take = min(hi - lo, self._max_extent)
        raw = self._read_range(ent, lo, lo + take, sealed)
        # an extent cut by the cap ends at its last whole record; the
        # watermark is on a frame boundary, so reading to it never cuts
        cut = _manifest.whole_record_prefix(raw)
        while cut == 0:
            check(lo + take < hi, f"stream shard {ent['data']}: committed watermark "
                  f"{hi} does not land on a record boundary")
            take = min(hi - lo, take * 2)
            raw = self._read_range(ent, lo, lo + take, sealed)
            cut = _manifest.whole_record_prefix(raw)
        raw = raw[:cut]
        self._consumed = lo + cut
        self.extents += 1
        self.bytes_read += cut
        chunk = decode_chunk(raw, ctx=self._decode_ctx)
        buf = np.frombuffer(chunk, dtype=np.uint8)
        starts, sizes = _manifest.walk_frames(chunk)
        if len(starts):
            self._parts.append((buf, starts, sizes))
            self._pending += len(starts)
        return True

    def _build_window(self) -> None:
        take = min(self._window, self._pending)
        check(take > 0, "internal: empty stream window")
        segs: List[np.ndarray] = []
        st_out: List[np.ndarray] = []
        sz_out: List[np.ndarray] = []
        base = 0
        need = take
        while need > 0:
            buf, st, sz = self._parts[0]
            k = min(need, len(st))
            lo = int(st[0])
            hi = int(st[k - 1] + sz[k - 1])
            segs.append(buf[lo:hi])
            st_out.append(st[:k] - lo + base)
            sz_out.append(sz[:k])
            base += hi - lo
            if k == len(st):
                self._parts.pop(0)
            else:
                self._parts[0] = (buf, st[k:], sz[k:])
            need -= k
        self._pending -= take
        self._win_buf = segs[0] if len(segs) == 1 else np.concatenate(segs)
        starts = st_out[0] if len(st_out) == 1 else np.concatenate(st_out)
        sizes = sz_out[0] if len(sz_out) == 1 else np.concatenate(sz_out)
        if self._shuffled:
            perm = np.asarray(_window_perm(self._seed, self._epoch, self._gen,
                                           self._widx, take), dtype=np.int64)
            starts = starts[perm]
            sizes = sizes[perm]
        self._win_starts = starts
        self._win_sizes = sizes
        self._win_pos = 0
        self._widx += 1
        self.windows += 1

    def _advance_single(self) -> bool:
        """Make the emission window hold records; False at a clean EOS."""
        waited = 0.0
        while True:
            if self._win_starts is not None and self._win_pos < len(self._win_starts):
                return True
            if self._ended:
                return False
            m = self._refresh()
            if m is None:
                waited = self._wait_for_writer(waited)
                continue
            ent = _manifest.shard_entry(m, self._gen)
            sealed = _manifest.is_sealed(m, self._gen)
            if ent is not None and self._consumed < int(ent["bytes"]):
                if self._pull_extent(ent, sealed):
                    waited = 0.0
            # a full window always emits; a partial one only when its
            # shard is done or the follow is unshuffled: shuffled windows
            # stay aligned so that the order is reproducible
            if self._pending >= self._window or (self._pending > 0 and not self._shuffled):
                self._build_window()
                continue
            if ent is not None and sealed and self._consumed >= int(ent["bytes"]):
                if self._pending > 0:
                    self._build_window()  # the shard's last partial window
                    continue
                # the rotation boundary: next generation, window ordinals anew
                self._gen += 1
                self._consumed = 0
                self._widx = 0
                self._close_stream()
                waited = 0.0
                continue
            if bool(m.get("eos")) and ent is None:
                if self._pending > 0:
                    self._build_window()  # the last partial window
                    continue
                self._ended = True
                self._maybe_ack(force=True)
                self._note_progress()
                return False
            waited = self._wait_for_writer(waited)

    # -- several workers: tracker-leased generations -------------------------
    def _make_dyn(self):
        sig = _split.fileset_signature(self.dir_uri, None, "stream")

        def _build(pi: int, nparts: int, ep: int, threaded: bool):
            m = self._m
            check(m is not None and ep < len(m["sealed"]),
                  f"stream ledger epoch {ep} leased before generation {ep} sealed — "
                  "manifest/ledger out of sync")
            ent = m["sealed"][ep]
            return _split.create(
                _manifest.join(self.dir_uri, ent["data"]), part_index=pi,
                num_parts=nparts, type="recordio",
                index_uri=_manifest.join(self.dir_uri, ent["index"]),
                shuffle="window" if self._shuffled else None, seed=self._seed,
                window=self._window, batch_size=self._batch_size, threaded=threaded,
                # each generation is read once: epoch 0's permutation, the
                # order a read of the sealed shard takes
                epoch=0)

        dyn = _split.DynamicShardSource(
            lambda pi, nparts, ep: _build(pi, nparts, ep, self._threaded),
            epoch=self._dyn_gen, fileset=sig, windowed_hint=self._shuffled,
            make_probe=lambda pi, nparts, ep: _build(pi, nparts, ep, False))
        dyn.on_lease = lambda shard, nshards: (
            self.on_lease and self.on_lease(self._dyn_gen, shard, nshards))
        dyn.on_shard_done = lambda shard, status: (
            self.on_shard_done and self.on_shard_done(self._dyn_gen, shard, status))
        return dyn

    def _pull_dyn(self, op):
        """``op`` on the leased source of the current generation, moving
        through the rotations (a fresh ledger epoch a sealed shard) until
        data comes or EOS has drained everything."""
        waited = 0.0
        while True:
            m = self._refresh()
            if m is not None and _manifest.is_sealed(m, self._dyn_gen):
                if self._dyn is None:
                    self._dyn = self._make_dyn()
                elif self._dyn.epoch < self._dyn_gen:
                    # a rotation is a dataset switch: the next ledger epoch
                    self._dyn.before_first()
                    check(self._dyn.epoch == self._dyn_gen,
                          "stream ledger epoch drifted from generation")
                out = op(self._dyn)
                if out is not None:
                    return out
                self._dyn_gen += 1  # the generation is drained cluster-wide
                waited = 0.0
                continue
            if m is not None and bool(m.get("eos")):
                if m.get("live") is None and self._dyn_gen >= len(m["sealed"]):
                    self._maybe_ack(force=True)
                    return None
            waited = self._wait_for_writer(waited)

    # -- the split contract --------------------------------------------------
    def supports_gather(self) -> bool:
        return self._shuffled if self._dynamic else True

    def _account(self, n: int) -> None:
        self._consumed_records += n
        self._note_progress()
        self._maybe_ack()

    def _take(self, n_records: int):
        k = min(n_records, len(self._win_starts) - self._win_pos)
        lo = self._win_pos
        self._win_pos += k
        self._account(k)
        return self._win_buf, self._win_starts[lo:lo + k], self._win_sizes[lo:lo + k]

    def next_gather_batch(self, n_records: int):
        """(buf, starts, sizes) views of up to ``n_records`` framed
        records in emission order, never across a window (short returns
        are normal); None at EOS."""
        self._started = True
        check(n_records >= 1, f"n_records={n_records} must be >= 1")
        if self._dynamic:
            out = self._pull_dyn(lambda d: d.next_gather_batch(n_records))
            if out is not None:
                self._account(len(out[1]))
            return out
        if not self._advance_single():
            return None
        return self._take(n_records)

    def next_batch(self, n_records: int) -> Optional[bytes]:
        self._started = True
        if self._dynamic:
            out = self._pull_dyn(lambda d: d.next_batch(n_records))
            if out is not None:
                self._account(_manifest.count_records(out))
            return out
        if not self._advance_single():
            return None
        buf, starts, sizes = self._take(n_records)
        return b"".join(buf[int(s):int(s + z)].tobytes() for s, z in zip(starts, sizes))

    def next_chunk(self) -> Optional[bytes]:
        return self.next_batch(self._batch_size)

    def next_record(self) -> Optional[bytes]:
        self._started = True
        if self._dynamic:
            out = self._pull_dyn(lambda d: d.next_record())
            if out is not None:
                self._account(1)
                return bytes(out)
            return None
        if not self._advance_single():
            return None
        s = int(self._win_starts[self._win_pos])
        z = int(self._win_sizes[self._win_pos])
        self._win_pos += 1
        self._account(1)
        frame = self._win_buf[s:s + z]
        payload = _manifest.frame_payload(frame)
        if payload is not None:
            return payload.tobytes()
        rec = RecordIOChunkReader(frame.tobytes()).next_record()
        check(rec is not None, "stream window: empty multipart record")
        return bytes(rec)

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        if chunk_has_compressed(chunk):
            chunk = decode_chunk(chunk, ctx=self._decode_ctx)
        rd = RecordIOChunkReader(chunk)
        while True:
            rec = rd.next_record()
            if rec is None:
                return
            yield bytes(rec)

    def before_first(self) -> None:
        if not self._started:
            return
        check(not self._dynamic,
              "dynamic streaming is single-pass: the shard ledger retires each "
              "generation exactly once; open a fresh StreamSource to re-read a "
              "drained stream")
        # follow again from generation 0 with the next epoch's window
        # permutations (the static splits' epoch contract)
        self._epoch += 1
        self._gen = 0
        self._consumed = 0
        self._widx = 0
        self._parts, self._pending = [], 0
        self._win_buf = self._win_starts = self._win_sizes = None
        self._win_pos = 0
        self._ended = False
        self._consumed_records = 0
        self._hist.clear()
        self._close_stream()

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        raise Error("StreamSource placement is manifest/ledger-owned: a single "
                    "follower drains everything, multi-worker streaming uses "
                    "dynamic=True leased micro-shards")

    def total_size(self) -> int:
        if self._m is None:
            self._refresh(force=True)
        if self._m is None:
            return 0
        return _manifest.total_committed(self._m)[0]

    def hint_chunk_size(self, nbytes: int) -> None:
        pass  # the watermark sizes the extents

    def io_stats(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "mode": "stream-dynamic" if self._dynamic else "stream",
            "extents": self.extents,
            "bytes_read": self.bytes_read,
            "windows": self.windows,
            "manifest_reads": self.manifest_reads,
            "tail_wait_secs": round(self.tail_wait_secs, 6),
            "commits_seen": self.commits_seen,
            "rotations_seen": self.rotations_seen,
            "records": self._consumed_records,
            "lag_records": max(0, self._total_records - self._consumed_records),
        }
        if self._dyn is not None:
            inner = self._dyn.io_stats()
            out.update({f"dyn_{k}": v for k, v in inner.items() if k != "mode"})
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._maybe_ack(force=True)
        self._close_stream()
        if self._dyn is not None:
            self._dyn.close()
        self._parts, self._pending = [], 0

    @property
    def generation(self) -> int:
        """The generation being read (with ``dynamic``: leased)."""
        return self._dyn_gen if self._dynamic else self._gen
