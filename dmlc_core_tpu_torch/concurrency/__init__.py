"""Prefetch pipelines (reference: include/dmlc/threadediter.h).

The port holds ``ThreadedIter``; ``thread_group.py`` (``ThreadGroup``,
``TimerThread``, ``ConcurrentBlockingQueue``) comes with ``ROADMAP.md``
§1 item 9b."""

from .threaded_iter import ThreadedIter  # noqa: F401
