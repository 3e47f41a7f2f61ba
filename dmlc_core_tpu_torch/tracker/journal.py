"""The tracker's control-plane journal: a write-ahead log and a snapshot
that let a tracker die and come back with its state (the port of
``dmlc_core_tpu/tracker/journal.py``, whole: the same files, frames,
payload bytes and fold).

Files in the journal directory (``--tracker-journal DIR`` /
``DMLC_TRACKER_JOURNAL``)::

    <dir>/wal.log        append-only record stream (framed, see below)
    <dir>/snapshot.json  atomic-rename fold of everything <= its seq

WAL record frame (this module is the only place it is written or parsed,
lint rule L018)::

    | crc32(payload) u32 | payload_len u32 | payload (UTF-8 JSON) |

The payload is ``{"seq": N, "kind": K, ...fields}``, serialised with
sorted keys and no spaces, so the same appends give the same bytes in
both packages. The CRC covers the payload only. Two kinds of damage are
told apart on open:

- **torn tail**: the file ends inside a header or a payload (the tracker
  died mid-append). Opening a ``Journal`` truncates it; the append never
  reached a client, so dropping it is safe.
- **CRC mismatch**: a whole record whose checksum disagrees. That is
  storage damage: a strict replay refuses with ``JournalError``
  (``inspect_journal`` still lists such a file).

Record kinds: ``shard_grant`` / ``shard_done`` / ``shard_release`` /
``dataset_switch`` (the shard ledger's transitions, ``shardsvc.py``; on
recovery a granted-but-not-done shard is expired back to the queue front
with its grant history kept), ``rank_assign`` (jobid → rank, world size
and topology epoch, so a relaunched tracker re-answers ``recover``) and
``autoscale`` (the controller's budget, ``autoscale.py``: target, cost
spent, dwell elapsed, direction and flaps). Unknown kinds are skipped.

``DMLC_TRACKER_JOURNAL_SYNC``: ``always`` (the default: fsync after
every append), ``interval`` (every ``SYNC_INTERVAL_RECORDS`` appends and
at a snapshot) or ``off`` (the page cache only: survives a SIGKILL of
the tracker, not a power loss). Every ``snapshot_every`` appends the
fold is renamed into place and the WAL restarts empty; replay skips WAL
seqs at or below the snapshot's.
"""

from __future__ import annotations

import binascii
import json
import os
import struct
import threading
from typing import Dict, List, Optional, Tuple

from ..utils.logging import Error

__all__ = [
    "Journal",
    "JournalError",
    "empty_state",
    "fold",
    "read_journal",
    "inspect_journal",
    "default_sync_policy",
]

#: WAL frame header: crc32(payload) u32, payload_len u32 (see module
#: docstring — this Struct is the single framing site, lint L018)
_HDR = struct.Struct("<II")

WAL_NAME = "wal.log"
SNAPSHOT_NAME = "snapshot.json"

#: record kinds — journal vocabulary, not wire commands. The two shard
#: kinds intentionally shadow the CMD_* spellings (a journal dump reads
#: like the RPC stream that produced it); this is their single literal
#: site, so writers fold through these constants, never fresh strings.
K_SHARD_GRANT = "shard_grant"
K_SHARD_DONE = "shard_done"  # noqa: L013 — record kind, not a cmd send
K_SHARD_RELEASE = "shard_release"  # noqa: L013 — record kind
K_DATASET_SWITCH = "dataset_switch"
K_RANK_ASSIGN = "rank_assign"
K_AUTOSCALE = "autoscale"

#: ``sync="interval"``: fsync once per this many appends
SYNC_INTERVAL_RECORDS = 64

_SYNC_POLICIES = ("always", "interval", "off")


class JournalError(Error):
    """Journal corruption (CRC mismatch on a fully-present record) or
    an unusable journal directory."""


def default_sync_policy() -> str:
    """``DMLC_TRACKER_JOURNAL_SYNC``: always | interval | off."""
    pol = os.environ.get("DMLC_TRACKER_JOURNAL_SYNC", "always").lower()
    return pol if pol in _SYNC_POLICIES else "always"


# -- the folded control-plane state -------------------------------------------


def empty_state() -> Dict:
    """The fold's zero value (pure JSON: string keys throughout)."""
    return {
        "shards": {"fileset": None, "n_shards": None, "epochs": {}},
        "ranks": {},  # jobid -> {"rank", "world", "topo_epoch"}
        "autoscale": None,
    }


def fold(state: Dict, rec: Dict) -> Dict:
    """Fold one WAL record into the state (mutates and returns it).

    ``epochs[e]`` keeps ``done`` (shard → finishing rank, the
    exactly-once facts) and ``outstanding`` (shard → last granted
    rank: grant history without a completion). A release keeps the
    shard in ``outstanding`` — the live ledger keeps its
    ``reclaimed_from`` entry too, so a late ``record_done`` after
    recovery is honored instead of rejected as never-granted."""
    kind = rec.get("kind")
    sh = state["shards"]
    if kind == K_SHARD_GRANT:
        if rec.get("fileset"):
            sh["fileset"] = rec["fileset"]
        if rec.get("n_shards"):
            sh["n_shards"] = int(rec["n_shards"])
        ep = sh["epochs"].setdefault(
            str(int(rec["epoch"])), {"done": {}, "outstanding": {}}
        )
        shard = str(int(rec["shard"]))
        if shard not in ep["done"]:
            ep["outstanding"][shard] = int(rec["rank"])
    elif kind == K_SHARD_DONE:
        ep = sh["epochs"].setdefault(
            str(int(rec["epoch"])), {"done": {}, "outstanding": {}}
        )
        shard = str(int(rec["shard"]))
        ep["done"][shard] = int(rec["rank"])
        ep["outstanding"].pop(shard, None)
    elif kind == K_SHARD_RELEASE:
        # outstanding survives: grant history must outlive the release
        pass
    elif kind == K_DATASET_SWITCH:
        state["shards"] = {
            "fileset": rec.get("fileset"),
            "n_shards": None,
            "epochs": {},
        }
    elif kind == K_RANK_ASSIGN:
        state["ranks"][str(rec["jobid"])] = {
            "rank": int(rec["rank"]),
            "world": int(rec.get("world", -1)),
            "topo_epoch": int(rec.get("topo_epoch", 0)),
        }
    elif kind == K_AUTOSCALE:
        state["autoscale"] = {
            k: rec[k]
            for k in (
                "target", "cost_spent", "dwell_elapsed",
                "last_direction", "direction_changes",
            )
            if k in rec
        }
    # unknown kinds are skipped: a newer tracker's journal replayed by
    # an older build degrades to what it understands
    return state


# -- low-level WAL scan --------------------------------------------------------


def _scan_wal(path: str, strict: bool):
    """Yield ``(offset, rec_or_None, crc_ok)`` per frame; returns via
    StopIteration value the torn-tail offset (None = clean EOF)."""
    records: List[Tuple[int, Optional[Dict], bool]] = []
    torn_at: Optional[int] = None
    try:
        f = open(path, "rb")
    except FileNotFoundError:
        return records, torn_at
    with f:
        off = 0
        while True:
            hdr = f.read(_HDR.size)
            if not hdr:
                break  # clean EOF
            if len(hdr) < _HDR.size:
                torn_at = off
                break
            crc, length = _HDR.unpack(hdr)
            payload = f.read(length)
            if len(payload) < length:
                torn_at = off
                break
            crc_ok = (binascii.crc32(payload) & 0xFFFFFFFF) == crc
            if not crc_ok and strict:
                raise JournalError(
                    f"journal CRC mismatch at {path}:{off} — storage "
                    "corruption, refusing to replay past committed state"
                )
            rec: Optional[Dict] = None
            if crc_ok:
                try:
                    rec = json.loads(payload.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    if strict:
                        raise JournalError(
                            f"journal record at {path}:{off} passed CRC "
                            "but is not JSON — refusing to replay"
                        )
            records.append((off, rec, crc_ok))
            off += _HDR.size + length
    return records, torn_at


def _load_snapshot(dirpath: str) -> Tuple[Optional[Dict], int]:
    path = os.path.join(dirpath, SNAPSHOT_NAME)
    try:
        with open(path, "r", encoding="utf-8") as f:
            snap = json.load(f)
    except FileNotFoundError:
        return None, 0
    except (ValueError, OSError) as e:
        # snapshots are atomic-rename: a torn one means storage damage
        raise JournalError(f"unreadable journal snapshot {path}: {e}")
    if not isinstance(snap, dict) or "state" not in snap:
        raise JournalError(f"malformed journal snapshot {path}")
    return snap["state"], int(snap.get("seq", 0))


def read_journal(dirpath: str) -> Tuple[Dict, int, Dict]:
    """Replay snapshot + WAL into ``(state, last_seq, info)``.

    Strict: a CRC-corrupt record raises :class:`JournalError`; a torn
    tail is tolerated (reported in ``info["torn_tail_at"]``) but NOT
    truncated here — opening a :class:`Journal` for writing does that.
    Deterministic: replaying the same directory twice yields
    byte-identical state (the unit suite pins this)."""
    state, snap_seq = _load_snapshot(dirpath)
    if state is None:
        state = empty_state()
    last_seq = snap_seq
    replayed = 0
    records, torn_at = _scan_wal(
        os.path.join(dirpath, WAL_NAME), strict=True
    )
    for _off, rec, _ok in records:
        if rec is None:
            continue
        seq = int(rec.get("seq", 0))
        if seq <= snap_seq:
            continue  # pre-snapshot tail left behind by compaction
        fold(state, rec)
        last_seq = max(last_seq, seq)
        replayed += 1
    info = {
        "snapshot_seq": snap_seq,
        "wal_records": replayed,
        "torn_tail_at": torn_at,
        "last_seq": last_seq,
    }
    return state, last_seq, info


def inspect_journal(dirpath: str) -> Dict:
    """Lenient dump for ``tools journal inspect``: never raises on
    damage — CRC-bad records are listed with ``crc_ok: false`` and a
    torn tail is flagged, so operators can look at exactly the journal
    a strict replay refused."""
    out: Dict = {
        "dir": dirpath,
        "snapshot": None,
        "records": [],
        "torn_tail_at": None,
        "crc_failures": 0,
    }
    try:
        state, snap_seq = _load_snapshot(dirpath)
        if state is not None:
            out["snapshot"] = {"seq": snap_seq, "state": state}
    except JournalError as e:
        out["snapshot"] = {"error": str(e)}
    records, torn_at = _scan_wal(
        os.path.join(dirpath, WAL_NAME), strict=False
    )
    for off, rec, crc_ok in records:
        if not crc_ok:
            out["crc_failures"] += 1
        out["records"].append({
            "offset": off,
            "crc_ok": crc_ok,
            "seq": None if rec is None else rec.get("seq"),
            "kind": None if rec is None else rec.get("kind"),
        })
    out["torn_tail_at"] = torn_at
    return out


# -- the writable journal ------------------------------------------------------


class Journal:
    """Append-only journal + snapshot compaction (thread-safe).

    Opening replays whatever the directory holds (truncating a torn
    WAL tail in place) and exposes the folded result as ``state`` /
    ``recovered`` — the tracker seeds its shard service, rank memo and
    autoscale controller from it. Every ``append`` folds the record
    into the live state so snapshots are a rename, not a re-scan."""

    def __init__(
        self,
        dirpath: str,
        sync: Optional[str] = None,
        snapshot_every: int = 256,
    ) -> None:
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self.sync = sync if sync in _SYNC_POLICIES else default_sync_policy()
        self.snapshot_every = max(1, int(snapshot_every))
        self._lock = threading.Lock()
        self.state, self.seq, self.recovery_info = read_journal(dirpath)
        self.recovered = bool(
            self.recovery_info["wal_records"]
            or self.recovery_info["snapshot_seq"]
        )
        wal = os.path.join(dirpath, WAL_NAME)
        torn = self.recovery_info["torn_tail_at"]
        if torn is not None:
            # drop the half-written tail record NOW so this process's
            # appends start on a frame boundary
            with open(wal, "r+b") as f:
                f.truncate(torn)
        self._f = open(wal, "ab")
        self._since_sync = 0
        self._since_snapshot = 0

    # -- append path ----------------------------------------------------------
    def append(self, kind: str, **fields) -> int:
        """Durably record one state transition; returns its seq."""
        with self._lock:
            if self._f is None:
                raise JournalError("journal is closed")
            self.seq += 1
            rec = {"seq": self.seq, "kind": kind, **fields}
            payload = json.dumps(
                rec, separators=(",", ":"), sort_keys=True
            ).encode("utf-8")
            crc = binascii.crc32(payload) & 0xFFFFFFFF
            self._f.write(_HDR.pack(crc, len(payload)))
            self._f.write(payload)
            self._f.flush()
            self._since_sync += 1
            if self.sync == "always" or (
                self.sync == "interval"
                and self._since_sync >= SYNC_INTERVAL_RECORDS
            ):
                os.fsync(self._f.fileno())
                self._since_sync = 0
            fold(self.state, rec)
            self._since_snapshot += 1
            if self._since_snapshot >= self.snapshot_every:
                self._snapshot_locked()
            return self.seq

    # -- snapshot / compaction -------------------------------------------------
    def snapshot(self) -> None:
        """Force a snapshot + WAL compaction now."""
        with self._lock:
            if self._f is None:
                raise JournalError("journal is closed")
            self._snapshot_locked()

    def _snapshot_locked(self) -> None:
        path = os.path.join(self.dir, SNAPSHOT_NAME)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(
                {"seq": self.seq, "state": self.state},
                f, separators=(",", ":"), sort_keys=True,
            )
            f.flush()
            if self.sync != "off":
                os.fsync(f.fileno())
        os.replace(tmp, path)
        # WAL restart: records <= the snapshot seq are now redundant
        # (replay skips them even if this truncate never lands)
        self._f.close()
        self._f = open(os.path.join(self.dir, WAL_NAME), "wb")
        self._since_snapshot = 0
        self._since_sync = 0

    def close(self) -> None:
        with self._lock:
            if self._f is None:
                return
            try:
                self._f.flush()
                if self.sync != "off":
                    os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            self._f.close()
            self._f = None
