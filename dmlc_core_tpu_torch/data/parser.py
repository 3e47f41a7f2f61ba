"""Parser interface and the parse-ahead wrapper (the port of
``dmlc_core_tpu/data/parser.py``; reference include/dmlc/data.h:280-361
and src/data/parser.h).

A Parser is a pull iterator of RowBlock batches. ``ThreadedParser`` runs
its base parser on a background thread with a bounded queue of 8 batches
(reference parser.h:75), so batching overlaps the parse.
"""

from __future__ import annotations

from typing import List, Optional

from ..utils.prefetch import Prefetcher
from .row_block import RowBlock

__all__ = ["Parser", "ThreadedParser"]


class Parser:
    """Pull interface producing lists of RowBlocks (reference
    data.h:293-320, parser.h:24-68)."""

    def parse_next(self) -> Optional[List[RowBlock]]:
        """Parse the next batch of blocks; None at end of data."""
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
    ThreadedParser, src/data/parser.h:71-126, capacity 8)."""

    def __init__(self, base: Parser, max_capacity: int = 8) -> None:
        self._base = base
        self._iter = Prefetcher(lambda: iter(base.parse_next, None), max_capacity,
                                "threaded-parser")

    def parse_next(self) -> Optional[List[RowBlock]]:
        return self._iter.next()

    def close(self) -> None:
        self._iter.destroy(timeout=5.0)
        self._base.close()
