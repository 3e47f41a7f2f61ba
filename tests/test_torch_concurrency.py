"""The port's ``ThreadedIter`` (``dmlc_core_tpu_torch/concurrency``): the
ThreadedIter cases of ``tests/test_concurrency.py``, each run on both
packages' classes (the ``ThreadedIter`` fixture), so the port's bounded
prefetch keeps the JAX package's contract: restart, producer errors
re-raised on the consumer, a destroy that wakes a blocked consumer, and
a bounded destroy that orphans a stalled producer. Every thread is
joined with a timeout."""

import threading
import time

import pytest

from dmlc_core_tpu.concurrency import ThreadedIter as JaxThreadedIter
from dmlc_core_tpu_torch.concurrency import ThreadedIter as PortThreadedIter
from dmlc_core_tpu_torch.utils.logging import Error


@pytest.fixture(params=["port", "jax"])
def ThreadedIter(request):
    return PortThreadedIter if request.param == "port" else JaxThreadedIter


def test_threaded_iter_basic_and_restart(ThreadedIter):
    epochs = []

    def produce():
        epochs.append(1)
        yield from range(10)

    it = ThreadedIter(produce, max_capacity=2)
    assert list(it) == list(range(10))
    assert it.next() is None  # stays exhausted
    it.before_first()
    assert list(it) == list(range(10))
    assert len(epochs) == 2
    it.destroy()


def test_threaded_iter_producer_exception_propagates(ThreadedIter):
    # reference IntProducerNextExc pattern: throw on the last element
    def produce():
        yield 1
        yield 2
        raise Error("produce failed")

    it = ThreadedIter(produce)
    assert it.next() == 1
    assert it.next() == 2
    with pytest.raises(Error, match="produce failed"):
        it.next()
    it.destroy()


def test_threaded_iter_exception_in_first_item(ThreadedIter):
    def produce():
        raise ValueError("immediate")
        yield  # pragma: no cover

    it = ThreadedIter(produce)
    with pytest.raises(ValueError, match="immediate"):
        it.next()
    # restart after exception works (reference exc-handling test does this)
    ok = [False]

    def produce_ok():
        if ok[0]:
            yield 42
        else:
            ok[0] = True
            raise ValueError("first time fails")

    it2 = ThreadedIter(produce_ok)
    with pytest.raises(ValueError):
        it2.next()
    it2.before_first()
    assert it2.next() == 42
    it2.destroy()


def test_threaded_iter_destroy_with_blocked_producer(ThreadedIter):
    # producer blocks on the bounded queue; destroy must not hang
    def produce():
        yield from range(100000)

    it = ThreadedIter(produce, max_capacity=2)
    assert it.next() == 0
    it.destroy()  # would deadlock without kill-signal draining


def test_threaded_iter_destroy_wakes_blocked_consumer(ThreadedIter):
    """A consumer blocked in next() (empty queue, stalled producer) must
    observe destroy() promptly — a downstream pipeline stage's thread
    pulls this iterator and its own teardown would otherwise spin on
    join forever (the StagingPipeline close path)."""
    release = threading.Event()

    def produce():
        yield 1
        release.wait(30)  # stalled upstream

    it = ThreadedIter(produce, max_capacity=1)
    assert it.next() == 1
    got = {}

    def consume():
        got["item"] = it.next()  # blocks: queue empty, producer stalled

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.2)
    assert t.is_alive()  # really blocked
    it.destroy(timeout=1.0)
    t.join(timeout=5)
    assert not t.is_alive()
    assert got["item"] is None  # clean end-of-stream, not an exception
    release.set()


def test_threaded_iter_destroy_bounded_join_orphans_stalled_producer(ThreadedIter):
    """destroy(timeout=...) must return within the bound even when the
    producer thread is stuck in uninterruptible user code; the orphaned
    daemon exits at its next queue put (kill flag)."""
    release = threading.Event()

    def produce():
        yield 1
        release.wait(30)  # emulates a blocking read Python can't interrupt
        yield 2  # pragma: no cover — kill flag drops it at the put

    it = ThreadedIter(produce, max_capacity=1)
    assert it.next() == 1
    time.sleep(0.1)  # let the producer enter the stall
    t0 = time.monotonic()
    joined = it.destroy(timeout=0.5)
    assert time.monotonic() - t0 < 5.0
    assert joined is False  # orphaned, not joined — callers must defer
    #                         tearing down resources the thread may touch
    release.set()  # orphan wakes, sees kill, exits without producing


def test_threaded_iter_default_destroy_still_joins_fully(ThreadedIter):
    """Without a timeout, destroy() keeps the join-to-completion
    exclusivity restart sites rely on (CachedInputSplit.before_first
    reopens shared resources right after)."""
    done = []

    def produce():
        try:
            yield 1
            yield 2
        finally:
            time.sleep(0.3)  # slow cleanup in the producer
            done.append(True)

    it = ThreadedIter(produce, max_capacity=1)
    assert it.next() == 1
    assert it.destroy() is True  # no timeout: waits for the finally
    assert done == [True]
