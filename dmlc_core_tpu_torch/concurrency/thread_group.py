"""Named-thread lifecycle management (the port of
``dmlc_core_tpu/concurrency/thread_group.py``).

Reference: include/dmlc/thread_group.h (ThreadGroup :101, join_all :408,
request_shutdown_all :441, TimerThread :645, ManualEvent :34) and
concurrency.h's ConcurrentBlockingQueue with SignalForKill (:69-118).

Python's threading/queue primitives already provide the hard parts; this
module adds the lifecycle layer: a registry of named threads with cooperative
shutdown, and a periodic timer thread. (The reference's Spinlock and the
vendored moodycamel lock-free queues are CPU-side micro-optimizations that do
not survive the rebuild — queue.Queue is the contract.)
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Optional

from ..utils.logging import Error

__all__ = ["ManualEvent", "ThreadGroup", "TimerThread", "ConcurrentBlockingQueue"]

ManualEvent = threading.Event  # reference thread_group.h:34


class ConcurrentBlockingQueue(queue.Queue):
    """Blocking queue with a kill signal (reference concurrency.h:69-118).

    After signal_for_kill(), blocked and future pops return None.
    """

    _KILL = object()

    def __init__(self, maxsize: int = 0) -> None:
        super().__init__(maxsize)
        self._killed = False

    def signal_for_kill(self) -> None:
        self._killed = True
        try:
            self.put_nowait(self._KILL)
        except queue.Full:
            pass

    def pop(self, timeout: Optional[float] = None):
        if self._killed:
            return None
        try:
            item = self.get(timeout=timeout)
        except queue.Empty:
            return None
        if item is self._KILL:
            try:  # let other blocked consumers see the kill too
                self.put_nowait(self._KILL)
            except queue.Full:
                pass
            return None
        return item


class ThreadGroup:
    """Registry of named worker threads with cooperative shutdown
    (reference thread_group.h:101-520)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._threads: Dict[str, threading.Thread] = {}
        self._shutdown = threading.Event()

    @property
    def shutdown_requested(self) -> threading.Event:
        """Workers poll (or wait on) this to exit cooperatively."""
        return self._shutdown

    def launch(self, name: str, fn: Callable, *args, daemon: bool = True) -> threading.Thread:
        """Create and start a named thread (reference create_thread)."""
        with self._lock:
            if name in self._threads and self._threads[name].is_alive():
                raise Error(f"thread {name!r} already running in group")
            t = threading.Thread(target=fn, args=args, name=name, daemon=daemon)
            self._threads[name] = t
        t.start()
        return t

    def count(self) -> int:
        with self._lock:
            return sum(1 for t in self._threads.values() if t.is_alive())

    def request_shutdown_all(self) -> None:
        """Reference thread_group.h:441."""
        self._shutdown.set()

    def join_all(self, timeout: Optional[float] = None) -> bool:
        """Join every thread; True if all exited (reference :408)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads.values())
        for t in threads:
            remain = None if deadline is None else max(0.0, deadline - time.monotonic())
            t.join(remain)
        return all(not t.is_alive() for t in threads)


class TimerThread:
    """Periodic callback thread (reference TimerThread, thread_group.h:645).

    Calls ``fn()`` every ``interval`` seconds until stop(); first call after
    one interval.
    """

    def __init__(self, interval: float, fn: Callable[[], None], name: str = "timer") -> None:
        self._interval = interval
        self._fn = fn
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self._fn()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def __enter__(self) -> "TimerThread":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
