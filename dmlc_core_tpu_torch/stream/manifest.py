"""The stream manifest: the one commit point between a writer and its
readers (the port of ``dmlc_core_tpu/stream/manifest.py``, whole, with
the same bytes).

A stream is a directory of RecordIO shards and a ``manifest.json`` that
is only ever replaced by an atomic rename::

    {
      "version": 1,
      "seq": 17,                      # bumped on every publish
      "sealed": [                     # whole, immutable shards
        {"gen": 0, "data": "shard-00000.rec", "index": "shard-00000.rec.idx",
         "bytes": 1048576, "records": 4096, "sealed_unix": ...},
        ...
      ],
      "live": {                       # the growing shard (null after EOS)
        "gen": 2, "data": "shard-00002.rec", "index": "shard-00002.rec.idx",
        "bytes": 524288, "records": 2048,    # the committed watermark
        "committed_unix": ...
      },
      "eos": false,                   # true once the writer closed
      "updated_unix": ...
    }

The live shard's ``bytes``/``records`` are what the writer's last
``commit()`` returned; a commit seals the pending codec block first, so
the watermark lands on a frame boundary. A reader never trusts a growing
shard's file size or its ``.idx`` tail, only the manifest. Every
manifest read and write and every walk over a growing shard's frames
lives in this module: the writer, the tail reader and ``tools info``
share one answer to "what prefix is committed".
"""

from __future__ import annotations

import json
import os
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io import retry as _retry
from ..io.filesystem import FileSystem
from ..io.recordio import KMAGIC, decode_flag, decode_length
from ..utils.logging import Error, check

MANIFEST_NAME = "manifest.json"
_ACK_PREFIX = "ack-"
_VERSION = 1


# -- naming -------------------------------------------------------------------
def shard_basename(gen: int) -> str:
    return f"shard-{gen:05d}.rec"


def join(dir_uri: str, name: str) -> str:
    """Path join that keeps a remote URI's scheme and host as they are."""
    return dir_uri.rstrip("/") + "/" + name


def manifest_uri(dir_uri: str) -> str:
    return join(dir_uri, MANIFEST_NAME)


def _local_dir(dir_path: str) -> str:
    return dir_path[len("file://"):] if dir_path.startswith("file://") else dir_path


# -- read/write ---------------------------------------------------------------
def new_manifest() -> Dict:
    return {
        "version": _VERSION,
        "seq": 0,
        "sealed": [],
        "live": None,
        "eos": False,
        "updated_unix": 0.0,
    }


def write_manifest(dir_path: str, m: Dict, fsync: bool = False) -> Dict:
    """Publish ``m`` into the local directory ``dir_path`` (a stream's
    writer is local; readers follow it through any filesystem): bump
    ``seq``, stamp ``updated_unix``, write a temporary file and rename it
    over ``manifest.json``, so a reader sees the old manifest or the new
    one, never a mix."""
    dir_path = _local_dir(dir_path)
    check("://" not in dir_path,
          f"write_manifest needs a local directory, not {dir_path!r} (the "
          "writer side of a stream is local)")
    m["seq"] = int(m.get("seq", 0)) + 1
    m["updated_unix"] = time.time()
    tmp = os.path.join(dir_path, f".{MANIFEST_NAME}.tmp.{os.getpid()}")
    data = json.dumps(m, indent=1, sort_keys=True).encode()
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dir_path, MANIFEST_NAME))
    return m


def read_manifest(dir_uri: str,
                  policy: Optional[_retry.RetryPolicy] = None) -> Optional[Dict]:
    """The manifest through any filesystem, or None when the directory
    has none yet. Transient faults retry under ``policy``; JSON that does
    not parse retries twice (a remote overwrite that is not atomic
    heals), then raises."""
    uri = manifest_uri(dir_uri)
    fs = FileSystem.get_instance(uri)
    policy = policy or _retry.RetryPolicy()
    garbage = 0
    while True:
        try:
            if not fs.exists(uri):
                return None
            with fs.open(uri, "r") as s:
                raw = s.read()
            m = json.loads(raw.decode("utf-8"))
            check(isinstance(m, dict) and int(m.get("version", -1)) == _VERSION,
                  f"unsupported stream manifest at {uri}: version="
                  f"{m.get('version') if isinstance(m, dict) else '?'}")
            check(isinstance(m.get("sealed"), list),
                  f"malformed stream manifest at {uri}: no sealed list")
            return m
        except (OSError, Error) as e:
            if isinstance(e, Error) and "manifest" in str(e):
                raise
            if not _retry.is_transient(e):
                raise
            policy.pause(e, what=f"read {uri}")
        except ValueError as e:  # a publish that was not atomic, mid-write
            garbage += 1
            if garbage >= 3:
                raise Error(f"corrupt stream manifest at {uri}: {e}") from e
            policy.pause(e, what=f"decode {uri}")


# -- watermark queries --------------------------------------------------------
def shard_entry(m: Dict, gen: int) -> Optional[Dict]:
    """The entry of generation ``gen`` (sealed or live), or None when it
    does not exist (yet)."""
    sealed = m["sealed"]
    if gen < len(sealed):
        return sealed[gen]
    live = m.get("live")
    if live is not None and int(live["gen"]) == gen:
        return live
    return None


def is_sealed(m: Dict, gen: int) -> bool:
    return gen < len(m["sealed"])


def total_committed(m: Dict) -> Tuple[int, int]:
    """The committed (bytes, records) of the whole stream."""
    b = sum(int(e["bytes"]) for e in m["sealed"])
    r = sum(int(e["records"]) for e in m["sealed"])
    live = m.get("live")
    if live is not None:
        b += int(live["bytes"])
        r += int(live["records"])
    return b, r


# -- reader acks (bounded staleness) ------------------------------------------
def write_ack(dir_path: str, reader_id: str, records: int) -> None:
    """Publish a reader's consumed-record count (an atomic rename, as the
    manifest). Local directories only: acks hold back the writer, which
    is local; a remote follower has no ack channel."""
    dir_path = _local_dir(dir_path)
    if "://" in dir_path:
        return
    name = f"{_ACK_PREFIX}{reader_id}.json"
    tmp = os.path.join(dir_path, f".{name}.tmp.{os.getpid()}")
    payload = {"records": int(records), "updated_unix": time.time()}
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    os.replace(tmp, os.path.join(dir_path, name))


def read_acks(dir_path: str) -> Dict[str, Dict]:
    """reader_id -> {records, updated_unix} of every published ack."""
    dir_path = _local_dir(dir_path)
    out: Dict[str, Dict] = {}
    if "://" in dir_path or not os.path.isdir(dir_path):
        return out
    for name in os.listdir(dir_path):
        if not (name.startswith(_ACK_PREFIX) and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(dir_path, name), encoding="utf-8") as f:
                out[name[len(_ACK_PREFIX):-5]] = json.load(f)
        except (OSError, ValueError):
            continue  # a torn ack: the next publish heals it
    return out


# -- frame accounting of a committed tail -------------------------------------
def whole_record_prefix(buf) -> int:
    """The largest prefix of a raw extent (compressed blocks still
    framed) that ends on a whole top-level record or block: where an
    extent read up to a cap is cut so that only whole frames are decoded.
    The buffer begins on a frame head."""
    view = memoryview(buf)
    n = len(view)
    pos = committed = 0
    while pos + 8 <= n:
        magic, lrec = struct.unpack_from("<II", view, pos)
        check(magic == KMAGIC, f"stream extent: bad magic at byte {pos}")
        end = pos + 8 + ((decode_length(lrec) + 3) & ~3)
        if end > n:
            break
        if (decode_flag(lrec) & 3) in (0, 3):
            committed = end
        pos = end
    return committed


def walk_frames(buf) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, sizes) int64 of the whole framed records of a v1 buffer
    that begins on a frame head and holds whole frames only (a committed
    extent after its blocks are decoded). A multipart chain is one span;
    a malformed head raises."""
    view = memoryview(buf)
    n = len(view)
    starts: List[int] = []
    sizes: List[int] = []
    pos = 0
    open_start = -1  # start of a multipart chain in flight
    while pos < n:
        check(pos + 8 <= n, "stream extent: truncated frame header")
        magic, lrec = struct.unpack_from("<II", view, pos)
        check(magic == KMAGIC, f"stream extent: bad magic at byte {pos}")
        cflag = decode_flag(lrec)
        check(cflag < 4, f"stream extent: compressed frame (cflag {cflag}) survived "
              "decode — decode_chunk the extent first")
        end = pos + 8 + ((decode_length(lrec) + 3) & ~3)
        check(end <= n, "stream extent: frame overruns committed bytes")
        part = cflag & 3
        if part in (0, 1):
            check(open_start < 0, "stream extent: nested record head")
            open_start = pos
        else:
            check(open_start >= 0, "stream extent: continuation without head")
        if part in (0, 3):
            starts.append(open_start)
            sizes.append(end - open_start)
            open_start = -1
        pos = end
    check(open_start < 0, "stream extent: unterminated multipart record")
    return np.asarray(starts, dtype=np.int64), np.asarray(sizes, dtype=np.int64)


def frame_payload(frame) -> Optional[memoryview]:
    """The payload of one framed record when it is a single whole frame,
    else None (the caller reads a multipart chain with a chunk reader).
    A bad head raises."""
    magic, lrec = struct.unpack_from("<II", frame, 0)
    check(magic == KMAGIC, "stream window: bad frame head")
    if decode_flag(lrec) != 0:
        return None
    return memoryview(frame)[8:8 + decode_length(lrec)]


def count_records(chunk) -> int:
    """The records of a framed chunk, walking its frame heads once (a
    compressed block counts as one; foreign bytes end the walk)."""
    view = memoryview(chunk)
    n = len(view)
    pos = count = 0
    while pos + 8 <= n:
        magic, lrec = struct.unpack_from("<II", view, pos)
        if magic != KMAGIC:
            break
        if (decode_flag(lrec) & 3) in (0, 3):
            count += 1
        pos += 8 + ((decode_length(lrec) + 3) & ~3)
    return count


def scan_committed_prefix(uri: str, size: Optional[int] = None) -> Dict:
    """Walk a shard, possibly still growing, from byte 0: ``{
    "committed_bytes", "tail_bytes", "frames", "blocks", "records",
    "open_chain"}``. Bytes past the last whole record are the writer's
    tail in flight, uncommitted, not corruption. ``records`` counts v1
    records; compressed blocks count under ``blocks``."""
    fs = FileSystem.get_instance(uri)
    if size is None:
        size = fs.get_path_info(uri).size
    frames = blocks = records = committed = 0
    open_chain = False
    with fs.open(uri, "r") as s:
        pos = 0
        while pos + 8 <= size:
            s.seek(pos)
            head = s.read(8)
            if len(head) < 8:
                break
            magic, lrec = struct.unpack("<II", head)
            if magic != KMAGIC:
                break  # torn or foreign bytes: the tail starts here
            cflag = decode_flag(lrec)
            end = pos + 8 + ((decode_length(lrec) + 3) & ~3)
            if end > size:
                break  # the frame runs past the end: a write in flight
            frames += 1
            part = cflag & 3
            if part in (0, 1):
                open_chain = True
            if part in (0, 3):
                open_chain = False
                if cflag & 4:
                    blocks += 1
                else:
                    records += 1
                committed = end  # whole records commit, not parts
            pos = end
    return {
        "committed_bytes": committed,
        "tail_bytes": int(size) - committed,
        "frames": frames,
        "blocks": blocks,
        "records": records,
        "open_chain": open_chain,
    }
