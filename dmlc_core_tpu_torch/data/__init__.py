"""Sparse rows and their parsers: the CSR ``RowBlock`` and its ``Row``
views, the binary ``rowrec`` format, the libsvm/libfm/csv text parsers
and their ``*ParserParam`` options, the native parse core they run on
(``native.py``), the parser factory over ``PARSER_REGISTRY`` and the
row-block iterators (``row_iter.py``: eager, or replayed from a
``#cachefile``)."""

from __future__ import annotations

from typing import Dict, Mapping, Optional

from ..io import split as io_split
from ..io.uri import URISpec, rejoin_query, uri_int
from ..utils.logging import Error, check
from .csv_parser import CSVParser, CSVParserParam
from .libfm_parser import LibFMParser, LibFMParserParam
from .libsvm_parser import LibSVMParser, LibSVMParserParam
from .parser import PARSER_REGISTRY, Parser, ThreadedParser
from .row_block import INDEX_T, REAL_T, Row, RowBlock, RowBlockContainer
from .row_iter import BasicRowIter, DiskRowIter, RowBlockIter
from .rowrec import RowRecParser, write_rowrec
from .text_parser import TextParserBase

__all__ = [
    "BasicRowIter",
    "CSVParser",
    "CSVParserParam",
    "DiskRowIter",
    "INDEX_T",
    "LibFMParser",
    "LibFMParserParam",
    "LibSVMParser",
    "LibSVMParserParam",
    "PARSER_REGISTRY",
    "Parser",
    "REAL_T",
    "Row",
    "RowBlock",
    "RowBlockContainer",
    "RowBlockIter",
    "RowRecParser",
    "TextParserBase",
    "ThreadedParser",
    "create_parser",
    "create_row_block_iter",
    "parser_options",
    "write_rowrec",
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


# -- parser registry (reference data.cc:223-256): entry(uri, args,
# part_index, num_parts, nthread, index_dtype), ``uri`` with its
# ``#cachefile`` and without its query, ``args`` from parser_options
def _text_source(uri: str, part_index: int, num_parts: int):
    return io_split.create(uri, part_index, num_parts, type="text")


@PARSER_REGISTRY.register("libsvm")
def _create_libsvm(uri, args, part_index, num_parts, nthread=None, index_dtype=INDEX_T):
    return LibSVMParser(_text_source(uri, part_index, num_parts), args, nthread,
                        index_dtype)


@PARSER_REGISTRY.register("csv")
def _create_csv(uri, args, part_index, num_parts, nthread=None, index_dtype=INDEX_T):
    return CSVParser(_text_source(uri, part_index, num_parts), args, nthread, index_dtype)


@PARSER_REGISTRY.register("libfm")
def _create_libfm(uri, args, part_index, num_parts, nthread=None, index_dtype=INDEX_T):
    return LibFMParser(_text_source(uri, part_index, num_parts), args, nthread,
                       index_dtype)


@PARSER_REGISTRY.register("rowrec")
def _create_rowrec(uri, args, part_index, num_parts, nthread=None, index_dtype=INDEX_T):
    # the split options go back on the URI: io.split.create resolves them
    path, hash_, cache = uri.partition("#")
    return RowRecParser(io_split.create(path + rejoin_query(args) + hash_ + cache,
                                        part_index, num_parts, type="recordio"),
                        index_dtype=index_dtype)


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
    split a ``CachedInputSplit``. The format names a ``PARSER_REGISTRY``
    entry, a caller's own too. The parser runs on a parse-ahead
    thread unless ``threaded=False``."""
    spec = URISpec(uri, part_index, num_parts)
    fmt = spec.args.get("format", "libsvm") if type == "auto" else type
    entry = PARSER_REGISTRY.find(fmt)
    if entry is None:
        raise Error(f"Unknown data type {fmt!r}")
    # the built-in formats' options are checked; a registered format of
    # the caller's gets the URI's as they are
    args = parser_options(fmt, spec.args) if fmt in _OPTIONS else dict(spec.args)
    fragment = uri.partition("#")[2]
    base = entry(spec.uri + ("#" + fragment if fragment else ""), args, part_index,
                 num_parts, nthread, index_dtype)
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
