"""Row-block iterators: eager in-memory and disk-cached epochs (the port of
``dmlc_core_tpu/data/row_iter.py``).

Reference: src/data/basic_row_iter.h (BasicRowIter: eager full load) and
src/data/disk_row_iter.h (DiskRowIter: parse once into 64MB serialized
pages, replay epochs through a ThreadedIter). Public interface mirrors
RowBlockIter (include/dmlc/data.h:254-274): before_first / next() →
RowBlock / num_col. The cache file holds the JAX package's bytes, and
the progress lines (``log_info``: every 10 MB read, each cache page, the
end) count ``parser.bytes_read()``, the source bytes, with the JAX
package's texts.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional, Union

from ..concurrency.threaded_iter import ThreadedIter
from ..io.stream import FileStream
from ..utils.logging import check, log_info
from ..utils.timer import get_time
from .parser import Parser
from .row_block import RowBlock, RowBlockContainer

__all__ = ["RowBlockIter", "BasicRowIter", "DiskRowIter", "PAGE_SIZE"]

PAGE_SIZE = 64 << 20  # reference disk_row_iter.h:32


class RowBlockIter:
    """Reference RowBlockIter interface (data.h:254-274)."""

    def before_first(self) -> None:
        raise NotImplementedError

    def next(self) -> Optional[RowBlock]:
        raise NotImplementedError

    def num_col(self) -> int:
        """Maximum feature dimension (max index + 1, data.h:272-274)."""
        raise NotImplementedError

    def __iter__(self) -> Iterator[RowBlock]:
        while True:
            blk = self.next()
            if blk is None:
                return
            yield blk

    def close(self) -> None:
        pass


def _log_throughput(bytes_read: int, tstart: float, final: bool = False) -> None:
    tdiff = max(get_time() - tstart, 1e-9)
    mb = bytes_read >> 20
    if final:
        log_info(f"finish reading at {mb / tdiff:.2f} MB/sec")
    else:
        log_info(f"{mb}MB read, {mb / tdiff:.2f} MB/sec")


class BasicRowIter(RowBlockIter):
    """Eager full in-memory load (reference basic_row_iter.h), logging
    every 10 MB of source read."""

    def __init__(self, parser: Parser) -> None:
        container = RowBlockContainer()
        tstart = get_time()
        log_at = 10 << 20
        while True:
            blocks = parser.parse_next()
            if blocks is None:
                break
            for b in blocks:
                if b.size:
                    container.push_block(b)
            if parser.bytes_read() >= log_at:
                _log_throughput(parser.bytes_read(), tstart)
                log_at += 10 << 20
        _log_throughput(parser.bytes_read(), tstart, final=True)
        self._block = container.to_block()
        self._num_col = container.max_index + 1 if self._block.nnz else 0
        self._served = False
        parser.close()

    def before_first(self) -> None:
        self._served = False

    def next(self) -> Optional[RowBlock]:
        if self._served:
            return None
        self._served = True
        return self._block

    def value(self) -> RowBlock:
        return self._block

    def num_col(self) -> int:
        return self._num_col


class DiskRowIter(RowBlockIter):
    """Parse once → serialized 64MB pages on disk; epochs replay the cache
    via a prefetch thread (reference disk_row_iter.h)."""

    def __init__(
        self,
        parser: Union[Parser, Callable[[], Parser]],
        cache_file: str,
        reuse_cache: bool = True,
    ) -> None:
        """``parser`` may be a factory so the warm-cache path never opens
        (or starts prefetching from) the raw data source at all."""
        self.cache_file = cache_file
        self._num_col = 0
        meta = cache_file + ".meta"
        if not (reuse_cache and self._try_load_meta(meta)):
            p = parser() if callable(parser) else parser
            self._build_cache(p, meta)
            p.close()
            check(os.path.exists(cache_file), f"failed to build cache file {cache_file}")
        elif not callable(parser):
            parser.close()
        self._iter: ThreadedIter[RowBlock] = ThreadedIter(
            self._read_pages, max_capacity=2, name="disk-row-iter")

    def _try_load_meta(self, meta: str) -> bool:
        if not (os.path.exists(self.cache_file) and os.path.exists(meta)):
            return False
        try:
            with open(meta, "r") as f:
                self._num_col = int(f.read().strip())
        except (ValueError, OSError):
            return False  # a truncated or corrupt meta: rebuild the cache
        return True

    def _build_cache(self, parser: Parser, meta: str) -> None:
        tstart = get_time()
        with FileStream(self.cache_file, "w") as fo:
            container = RowBlockContainer()
            while True:
                blocks = parser.parse_next()
                if blocks is None:
                    break
                for b in blocks:
                    if b.size:
                        container.push_block(b)
                if container.mem_cost_bytes() >= PAGE_SIZE:
                    _log_throughput(parser.bytes_read(), tstart)
                    self._num_col = max(self._num_col, container.max_index + 1)
                    container.save(fo)
                    container.clear()
            if container.size:
                self._num_col = max(self._num_col, container.max_index + 1)
                container.save(fo)
        with open(meta, "w") as f:
            f.write(str(self._num_col))
        _log_throughput(parser.bytes_read(), tstart, final=True)

    def _read_pages(self) -> Iterator[RowBlock]:
        with FileStream(self.cache_file, "r") as fi:
            while True:
                blk = RowBlock.load(fi)
                if blk is None:
                    return
                yield blk

    def before_first(self) -> None:
        self._iter.before_first()

    def next(self) -> Optional[RowBlock]:
        return self._iter.next()

    def num_col(self) -> int:
        return self._num_col

    def close(self) -> None:
        self._iter.destroy()
