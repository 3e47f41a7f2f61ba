"""Text parser base: chunked, multi-threaded line parsing (the port of
``dmlc_core_tpu/data/text_parser.py``; reference src/data/text_parser.h).

``fill_data`` pulls one chunk of whole lines from the split, skips a
UTF-8 BOM at the start of the input (of each epoch), cuts the chunk at
line ends into up to ``nthread`` slices and parses them in parallel into
RowBlocks. The native parse releases the GIL, so the slices really run in
parallel. Worker exceptions reach the caller through ``Future.result()``.
``bytes_read`` counts the chunks' bytes as the split gave them, BOM
included.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from ..utils.cpus import parse_threads
from .parser import Parser
from .row_block import RowBlock

__all__ = ["TextParserBase", "default_parser_threads"]

_BOM = b"\xef\xbb\xbf"


def default_parser_threads(nthread: Optional[int]) -> int:
    """Parser fan-out width: every usable CPU (affinity and cgroup quota
    counted, ``utils/cpus.py``), a request capped at that, and
    ``DMLC_PARSE_THREADS`` over both."""
    return parse_threads(nthread)


class TextParserBase(Parser):
    """Chunk → line-aligned slices → parallel ``parse_block``
    (reference text_parser.h:110-146), ``default_parser_threads(nthread)``
    wide."""

    def __init__(self, source, nthread: Optional[int] = None) -> None:
        self.source = source
        self.nthread = default_parser_threads(nthread)
        self._bytes_read = 0
        self._pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=self.nthread, thread_name_prefix="parse")
            if self.nthread > 1
            else None
        )

    def parse_block(self, data: bytes) -> RowBlock:
        """Parse a byte slice of whole lines into one RowBlock."""
        raise NotImplementedError

    def bytes_read(self) -> int:
        return self._bytes_read

    def before_first(self) -> None:
        self.source.before_first()
        self._bytes_read = 0

    def parse_next(self) -> Optional[List[RowBlock]]:
        return self.fill_data()

    def fill_data(self) -> Optional[List[RowBlock]]:
        """One chunk, fanned out across parser threads (reference
        FillData, text_parser.h:110-146)."""
        chunk = self.source.next_chunk()
        if chunk is None:
            return None
        first_chunk = self._bytes_read == 0
        self._bytes_read += len(chunk)
        if first_chunk and chunk.startswith(_BOM):
            # beginning of input only (text_parser.h:81-95); later chunks
            # may start with these bytes legitimately
            chunk = chunk[len(_BOM):]
        slices = split_slices(chunk, self.nthread)
        if self._pool is None or len(slices) == 1:
            return [self.parse_block(s) for s in slices]
        futures = [self._pool.submit(self.parse_block, s) for s in slices]
        return [f.result() for f in futures]

    def close(self) -> None:
        if self._pool is not None:
            # wait for started slices: they still read the chunk
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        self.source.close()


def split_slices(chunk: bytes, nslice: int) -> List[bytes]:
    """Cut a chunk into at most ``nslice`` pieces that end at line ends
    (reference BackFindEndLine, text_parser.h:120-133)."""
    n = len(chunk)
    if nslice <= 1 or n < 4096:
        return [chunk] if n else []
    step = (n + nslice - 1) // nslice
    out: List[bytes] = []
    begin = 0
    while begin < n:
        end = min(begin + step, n)
        if end < n:
            nl = chunk.rfind(b"\n", begin, end)
            if nl < 0:
                # no newline inside the slice: extend to the next one
                nl = chunk.find(b"\n", end)
                end = n if nl < 0 else nl + 1
            else:
                end = nl + 1
        piece = chunk[begin:end]
        if piece:
            out.append(piece)
        begin = end
    return out
