"""ThreadedIter: bounded producer-consumer prefetch (the port of
``dmlc_core_tpu/concurrency/threaded_iter.py``; the dsserve server runs
its production ahead of the socket send on one, ``data.ThreadedParser``
its parse and ``DiskRowIter`` its page reads).

Reference: include/dmlc/threadediter.h. The port's staging stages use the
lighter, one-pass ``utils/prefetch.Prefetcher``; this class keeps the JAX
package's restartable contract for the code that rewinds.

Python rethink: the reference's cell-recycling protocol
(threadediter.h:443-488) exists to avoid malloc/free churn of C++ buffers;
in Python, buffers are numpy arrays owned by the GC and the double-buffer
staging layer recycles device buffers instead (staging/pipeline.py). What we
keep is the contract that matters for correctness:

- bounded queue (default capacity 2 = double buffering,
  threaded_input_split.h:33)
- producer-thread exceptions are captured and re-raised on the consumer
  thread, including during before_first (threadediter.h:406-435,490-505 and
  test unittest_threaditer_exc_handling.cc)
- restartable: before_first() tears down the producer and restarts it
  (threadediter.h:330-440 Init/BeforeFirst signals)
"""

from __future__ import annotations

import queue
import threading
import time as _time
from typing import Callable, Generic, Iterable, Iterator, Optional, Tuple, TypeVar

T = TypeVar("T")

_ITEM, _END, _EXC = 0, 1, 2

__all__ = ["ThreadedIter"]


class ThreadedIter(Generic[T]):
    """Prefetch items from ``producer_fn()`` on a background thread.

    ``producer_fn`` must return a fresh iterator each call (each epoch).
    """

    def __init__(
        self,
        producer_fn: Callable[[], Iterable[T]],
        max_capacity: int = 2,
        name: str = "threadediter",
    ) -> None:
        self._producer_fn = producer_fn
        self._cap = max_capacity
        self._name = name
        self._queue: "queue.Queue" = queue.Queue()
        self._kill = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._exhausted = False
        self._destroyed = False
        self._start()

    # -- producer side -------------------------------------------------------
    def _start(self) -> None:
        self._queue = queue.Queue(maxsize=self._cap)
        self._kill = threading.Event()
        self._exhausted = False
        t = threading.Thread(
            target=self._run,
            args=(self._queue, self._kill),
            daemon=True,
            name=self._name,
        )
        self._thread = t
        t.start()

    def _put(self, q: "queue.Queue", kill: threading.Event, item) -> bool:
        while not kill.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, q: "queue.Queue", kill: threading.Event) -> None:
        try:
            for item in self._producer_fn():
                if not self._put(q, kill, (_ITEM, item)):
                    return
                if kill.is_set():
                    return
            self._put(q, kill, (_END, None))
        except BaseException as e:  # noqa: BLE001 — crosses thread boundary
            self._put(q, kill, (_EXC, e))

    def _stop(
        self, timeout: Optional[float] = None
    ) -> Tuple[Optional[BaseException], bool]:
        """Tear down the producer; returns ``(pending, joined)`` — any
        pending producer exception found while draining (must not be
        silently lost — reference rethrows in BeforeFirst,
        threadediter.h:406-435) and whether the producer thread actually
        exited.

        With ``timeout``, a producer thread that stays alive past the
        deadline — blocked in user code (slow upstream IO) that Python
        cannot interrupt — is orphaned instead of joined (``joined``
        False): the kill flag is set, so the daemon thread exits at its
        next queue put, and the caller's teardown doesn't wedge for the
        stall's duration."""
        t = self._thread
        if t is None:
            return None, True
        pending: Optional[BaseException] = None
        self._kill.set()
        deadline = None if timeout is None else _time.monotonic() + timeout
        while t.is_alive():
            if deadline is not None and _time.monotonic() > deadline:
                break
            try:  # drain so a blocked put() notices the kill flag
                tag, val = self._queue.get_nowait()
                if tag == _EXC:
                    pending = val
            except queue.Empty:
                pass
            t.join(timeout=0.05)
        while True:  # the thread may have queued items right before exiting
            try:
                tag, val = self._queue.get_nowait()
                if tag == _EXC:
                    pending = val
            except queue.Empty:
                break
        joined = not t.is_alive()
        self._thread = None
        return pending, joined

    # -- consumer side -------------------------------------------------------
    def next(self) -> Optional[T]:
        """Next item or None at end of stream; re-raises producer errors
        (reference ThrowExceptionIfSet, threadediter.h:490-505)."""
        if self._exhausted or self._destroyed:
            return None
        tag, val = self._queue.get()
        if tag == _ITEM:
            return val
        self._exhausted = True
        if tag == _EXC:
            raise val
        return None

    def __iter__(self) -> Iterator[T]:
        while True:
            item = self.next()
            if item is None and self._exhausted:
                return
            yield item  # type: ignore[misc]

    def before_first(self) -> None:
        """Restart the producer from the beginning; re-raises a pending
        producer exception instead of discarding it (reference
        threadediter.h kBeforeFirst signal + ThrowExceptionIfSet)."""
        pending, _joined = self._stop()
        if pending is not None and not self._exhausted:
            self._exhausted = True
            raise pending
        self._start()

    def destroy(self, timeout: Optional[float] = None) -> bool:
        """Tear down the producer thread (reference ~ThreadedIter).
        Pending exceptions are intentionally dropped here — destruction
        must not raise. Returns whether the producer thread actually
        exited (always True without a timeout).

        The default joins the producer to completion — callers that
        reuse a shared resource afterwards (CachedInputSplit's
        before_first reopening the cache file, ShardedFusedBatches
        closing mmaps) depend on that exclusivity. Pass a ``timeout``
        only when an indefinite wedge behind a producer stalled in
        uninterruptible IO is worse than orphaning the daemon thread
        (it exits at its next queue put; StagingPipeline.close does
        this, accepting that the caller must not tear down the
        producer's underlying resources while a stall is suspected —
        the False return is the signal to defer that teardown)."""
        self._destroyed = True
        _pending, joined = self._stop(timeout=timeout)
        # wake any consumer blocked in next()'s queue.get() — without
        # this, a downstream stage's thread blocked on THIS iterator
        # (StagingPipeline's transfer thread pulling the parse queue)
        # would never observe the teardown and its own destroy() would
        # spin on join forever
        try:
            self._queue.put_nowait((_END, None))
        except queue.Full:
            pass  # consumer has items to drain; it isn't blocked
        return joined

    def __del__(self) -> None:
        try:
            self.destroy()
        except Exception:
            pass
