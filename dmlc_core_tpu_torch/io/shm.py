"""Named POSIX shared-memory segments: the one place in the port that
touches ``_posixshmem`` (the port of ``dmlc_core_tpu/io/shm.py``).

The dsserve same-host transport (``dsserve/server.py``'s ring, the
client's mapping of each slot) creates, attaches and unlinks segments
here and nowhere else, so one site owns their lifecycle.
"""

from __future__ import annotations

import mmap
import os

try:  # CPython's POSIX shared-memory primitive (what the stdlib's
    # multiprocessing.shared_memory wraps); absent on non-POSIX builds
    import _posixshmem
except ImportError:  # pragma: no cover - non-POSIX platform
    _posixshmem = None

__all__ = ["ShmSegment", "shm_available", "shm_transport_enabled"]


def shm_available() -> bool:
    """True when this interpreter can open POSIX shared memory."""
    return _posixshmem is not None


def shm_transport_enabled() -> bool:
    """``DMLC_DSSERVE_SHM`` gate (default on), read by BOTH ends of the
    dsserve same-host transport. The transport negotiates per
    connection and silently degrades to TCP on any failure, so the knob
    exists for pinning a transport (benches, A/B drills), not for
    safety."""
    return os.environ.get("DMLC_DSSERVE_SHM", "on").strip().lower() not in (
        "off", "0", "false", "no",
    )


class ShmSegment:
    """Named POSIX shared-memory segment with EXPLICIT lifecycle —
    deliberately built on ``_posixshmem`` + ``mmap`` rather than
    ``multiprocessing.shared_memory``: the stdlib's resource tracker
    registers every open (create AND attach, bpo-39959; opt-out only
    lands in 3.13) for unlink-at-process-exit, which would tear
    daemon-owned segments down the moment ONE client exits, its
    set-based bookkeeping double-removes when daemon and client share
    a process, and suppressing it means mutating process-global tracker
    hooks under unrelated threads. Same syscalls, zero tracker
    interaction; lifecycle here is explicit — the owner unlinks on
    close, a losing publisher unlinks its own copy. The cost is that a
    SIGKILL'd owner leaks its segments until a reboot (or a hand
    ``rm /dev/shm/dmlc-dss-*``) — the standard trade for any shm
    service."""

    __slots__ = ("name", "buf", "_mmap")

    def __init__(self, name: str, create: bool = False,
                 size: int = 0) -> None:
        if _posixshmem is None:  # pragma: no cover - non-POSIX
            raise OSError("POSIX shared memory unavailable on this host")
        flags = os.O_RDWR | ((os.O_CREAT | os.O_EXCL) if create else 0)
        fd = _posixshmem.shm_open("/" + name, flags, mode=0o600)
        try:
            if create and size:
                os.ftruncate(fd, size)
            self._mmap = mmap.mmap(fd, os.fstat(fd).st_size)
        finally:
            os.close(fd)
        self.name = name
        self.buf: memoryview = memoryview(self._mmap)

    def close(self) -> None:
        """Unmap; raises BufferError while exported views are alive
        (callers guard — the mapping then lives until those views go)."""
        self.buf.release()
        self._mmap.close()

    def unlink(self) -> None:
        _posixshmem.shm_unlink("/" + self.name)
