"""Sparse rows and their parsers: the CSR ``RowBlock``, the binary
``rowrec`` format, the libsvm/libfm/csv text parsers, the native parse
core they run on (``native.py``), the parser factory and the row-block
iterators (``row_iter.py``: eager, or replayed from a ``#cachefile``)."""

from __future__ import annotations

from typing import Dict, Mapping, Optional

from ..io import split as io_split
from ..io.uri import URISpec, rejoin_query, uri_int
from ..utils.logging import Error, check
from .csv_parser import CSVParser
from .libfm_parser import LibFMParser
from .libsvm_parser import LibSVMParser
from .parser import Parser, ThreadedParser
from .row_block import INDEX_T, RowBlock
from .row_iter import BasicRowIter, DiskRowIter, RowBlockIter
from .rowrec import RowRecParser

__all__ = [
    "BasicRowIter",
    "CSVParser",
    "DiskRowIter",
    "LibFMParser",
    "LibSVMParser",
    "Parser",
    "RowBlock",
    "RowBlockIter",
    "RowRecParser",
    "ThreadedParser",
    "create_parser",
    "create_row_block_iter",
    "parser_options",
]

# URI options each format takes; any other option raises. rowrec's are
# the split's (the indexed, shuffled reads), kept as strings for
# ``io.split.create``.
_OPTIONS = {
    "libsvm": ("indexing_mode",),
    "libfm": ("indexing_mode",),
    "csv": ("label_column", "weight_column", "delimiter", "dtype"),
    "rowrec": io_split.SPLIT_OPTIONS,
}
_STRINGS = ("delimiter", "dtype", *io_split.SPLIT_OPTIONS)


def parser_options(fmt: str, args: Mapping[str, str]) -> Dict[str, object]:
    """The URI ``args`` of a ``fmt`` source as parser keyword arguments;
    raises ``Error`` on a format the port lacks, on ``format=`` naming
    another format and on an option it does not take."""
    check(fmt in _OPTIONS, f"Unknown data type {fmt!r}")
    check(args.get("format", fmt) == fmt,
          f"format mismatch: URI says {args.get('format')!r}, asked for {fmt!r}")
    unknown = sorted(set(args) - {"format", *_OPTIONS[fmt]})
    if unknown:
        raise Error(f"URI options {unknown} are not supported for {fmt} "
                    "sources in dmlc_core_tpu_torch")
    out: Dict[str, object] = {}
    for key in _OPTIONS[fmt]:
        if key in args:
            out[key] = args[key] if key in _STRINGS else uri_int(args, key, 0)
    return out


def create_parser(
    uri: str,
    part_index: int = 0,
    num_parts: int = 1,
    type: str = "auto",
    nthread: Optional[int] = None,
    index_dtype=INDEX_T,
    threaded: bool = True,
) -> Parser:
    """Parser factory (reference CreateParser_, src/data.cc:62-85) over
    the local files of ``uri`` (one file, a ``;`` list, a directory or a
    regex). 'auto' takes ``?format=`` from the URI, defaulting to
    libsvm; parser options ride the URI, and ``#cachefile`` gives the
    split a ``CachedInputSplit``. The parser runs on a parse-ahead
    thread unless ``threaded=False``."""
    spec = URISpec(uri, part_index, num_parts)
    fmt = spec.args.get("format", "libsvm") if type == "auto" else type
    kwargs = parser_options(fmt, spec.args)
    fragment = uri.partition("#")[2]
    cache = "#" + fragment if fragment else ""
    if fmt == "rowrec":
        base: Parser = RowRecParser(io_split.create(
            spec.uri + rejoin_query(kwargs) + cache, part_index, num_parts,
            type="recordio"), index_dtype=index_dtype)
    else:
        cls = {"libsvm": LibSVMParser, "libfm": LibFMParser, "csv": CSVParser}[fmt]
        base = cls(io_split.create(spec.uri + cache, part_index, num_parts, type="text"),
                   nthread, index_dtype, **kwargs)
    return ThreadedParser(base) if threaded else base


def create_row_block_iter(
    uri: str,
    part_index: int = 0,
    num_parts: int = 1,
    type: str = "auto",
    nthread: Optional[int] = None,
    index_dtype=INDEX_T,
) -> RowBlockIter:
    """RowBlockIter factory (reference CreateIter_, src/data.cc:87-107):
    ``uri#cachefile`` gives a ``DiskRowIter`` over that cache file, any
    other URI an eager ``BasicRowIter``. An epoch shuffle with a
    ``#cachefile`` raises, as in the JAX package: the cache would freeze
    the first epoch's order."""
    spec = URISpec(uri, part_index, num_parts)

    def make_parser() -> Parser:
        return create_parser(spec.uri + rejoin_query(spec.args), part_index, num_parts,
                             type, nthread, index_dtype)

    if spec.cache_file:
        if uri_int(spec.args, "shuffle_parts", 0) or (
                "index" in spec.args
                and io_split.normalize_shuffle(spec.args.get("shuffle", "0"))):
            raise Error("epoch shuffling with a #cachefile would freeze the first "
                        "epoch's shuffle order into the cache; pick one")
        return DiskRowIter(make_parser, spec.cache_file, reuse_cache=True)
    return BasicRowIter(make_parser())
