"""A daemon thread that drains an iterator into a bounded queue (the
port's counterpart of ``concurrency/threaded_iter.py``'s ThreadedIter)."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

__all__ = ["Prefetcher"]


class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc: Exception) -> None:
        self.exc = exc


_END = object()


class Prefetcher:
    """A daemon thread draining ``make_iter()`` into a bounded queue. A
    producer exception is re-raised by ``next()``; ``destroy()`` stops the
    thread with a bounded join."""

    def __init__(self, make_iter: Callable[[], Iterator], capacity: int,
                 name: str) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=max(1, capacity))
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(
            target=self._run, args=(make_iter,), name=name, daemon=True
        )
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, make_iter) -> None:
        try:
            for item in make_iter():
                if not self._put(item):
                    return
        except Exception as e:  # relayed to the consumer by next()
            self._put(_Failure(e))
            return
        self._put(_END)

    def next(self):
        """The next item, or None at the end or after ``destroy()``."""
        while not self._done:
            if self._stop.is_set():
                self._done = True
                break
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is _END:
                self._done = True
            elif isinstance(item, _Failure):
                self._done = True
                raise item.exc
            else:
                return item
        return None

    def destroy(self, timeout: float) -> bool:
        """Stop the thread; True when it exited within ``timeout``."""
        self._stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)
        return not self._thread.is_alive()
