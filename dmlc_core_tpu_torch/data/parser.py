"""Parser interface and the parse-ahead wrapper (the port of
``dmlc_core_tpu/data/parser.py``; reference include/dmlc/data.h:280-361
and src/data/parser.h).

A Parser is a pull iterator of RowBlock batches, restartable with
``before_first`` and counting the source bytes behind what it returned
(``bytes_read``). ``ThreadedParser`` runs its base parser on a background
thread with a bounded queue of 8 batches (reference parser.h:75), so
batching overlaps the parse. ``PARSER_REGISTRY`` maps a format to its
factory (reference data.h:341-356; the formats register in
``data/__init__.py``).
"""

from __future__ import annotations

from typing import List, Optional

from ..concurrency.threaded_iter import ThreadedIter
from ..params.registry import Registry
from ..utils.logging import check
from .row_block import RowBlock

__all__ = ["PARSER_REGISTRY", "Parser", "ThreadedParser"]

PARSER_REGISTRY: Registry = Registry("parser")

# seconds close() waits for the parse thread before it raises
_JOIN_TIMEOUT = 5.0


class Parser:
    """Pull interface producing lists of RowBlocks (reference
    data.h:293-320, parser.h:24-68)."""

    def parse_next(self) -> Optional[List[RowBlock]]:
        """Parse the next batch of blocks; None at end of data."""
        raise NotImplementedError

    def before_first(self) -> None:
        """Rewind to the start of the input."""
        raise NotImplementedError

    def bytes_read(self) -> int:
        """Source bytes consumed this epoch (reference data.h:310-312)."""
        raise NotImplementedError

    def __iter__(self):
        """Iterate single non-empty RowBlocks (flattened batches)."""
        while True:
            blocks = self.parse_next()
            if blocks is None:
                return
            for b in blocks:
                if b.size:
                    yield b

    def close(self) -> None:
        pass


class ThreadedParser(Parser):
    """Parse-ahead wrapper: the base parser runs on a producer thread and
    its batches reach the consumer through a bounded queue (reference
    ThreadedParser, src/data/parser.h:71-126, capacity 8).

    ``before_first`` stops the thread and starts a new one, which rewinds
    the base first; the first epoch does not rewind, so a source that
    cannot rewind (stdin) reads once. ``bytes_read`` is the base's count
    taken on the producer thread right after the batch was parsed and
    handed over with it: the bytes behind the batches the consumer has
    received, never those still queued."""

    def __init__(self, base: Parser, max_capacity: int = 8) -> None:
        self._base = base
        self._first_epoch = True
        self._bytes_delivered = 0
        self._iter: ThreadedIter = ThreadedIter(self._produce, max_capacity=max_capacity,
                                                name="threaded-parser")

    def _produce(self):
        if self._first_epoch:
            self._first_epoch = False
        else:
            self._base.before_first()
        while True:
            blocks = self._base.parse_next()
            if blocks is None:
                return
            yield blocks, self._base.bytes_read()

    def parse_next(self) -> Optional[List[RowBlock]]:
        item = self._iter.next()
        if item is None:
            return None
        blocks, self._bytes_delivered = item
        return blocks

    def before_first(self) -> None:
        self._iter.before_first()
        self._bytes_delivered = 0

    def bytes_read(self) -> int:
        return self._bytes_delivered

    def close(self) -> None:
        """Stop the thread (within ``_JOIN_TIMEOUT`` seconds, or raise:
        the base must not close under a parse), then close the base."""
        check(self._iter.destroy(timeout=_JOIN_TIMEOUT),
              f"threaded-parser thread did not stop within {_JOIN_TIMEOUT:.0f} s")
        self._base.close()
