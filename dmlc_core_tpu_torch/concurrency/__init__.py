"""Prefetch pipelines and thread lifecycles (reference:
include/dmlc/threadediter.h, thread_group.h, concurrency.h):
``ThreadedIter``, and ``thread_group.py``'s ``ThreadGroup``,
``TimerThread`` and ``ConcurrentBlockingQueue``."""

from .thread_group import (  # noqa: F401
    ConcurrentBlockingQueue,
    ManualEvent,
    ThreadGroup,
    TimerThread,
)
from .threaded_iter import ThreadedIter  # noqa: F401
