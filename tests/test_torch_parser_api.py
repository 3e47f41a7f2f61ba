"""The port's Parser interface and row containers against the JAX
package's, on the CPU: two epochs of every parser (libsvm, libfm, csv,
rowrec), threaded and not, through ``before_first``, with a BOM file and a
``#cachefile``; the sequence of ``bytes_read()`` values; the parse-ahead
thread's delivery watermark, first-epoch rewind skip and error relay;
``default_parser_threads``; the ``*ParserParam`` defaults and error texts;
``PARSER_REGISTRY``; ``Row``, ``RowBlock`` row access,
``RowBlockContainer.push_row``/``load`` and ``encode_row`` (bytes equal);
the row iterators' progress lines through a sink. RowBlocks are compared
byte for byte."""

import re
import threading

import numpy as np
import pytest

from dmlc_core_tpu import data as jax_data
from dmlc_core_tpu.data import csv_parser as jax_csv
from dmlc_core_tpu.data import libfm_parser as jax_libfm
from dmlc_core_tpu.data import libsvm_parser as jax_libsvm
from dmlc_core_tpu.data import parser as jax_parser
from dmlc_core_tpu.data import row_block as jax_row_block
from dmlc_core_tpu.data import rowrec as jax_rowrec
from dmlc_core_tpu.data import text_parser as jax_text_parser
from dmlc_core_tpu.io import split as jax_split
from dmlc_core_tpu.io.stream import MemoryStream as JaxMemoryStream
from dmlc_core_tpu.utils import cpus as jax_cpus
from dmlc_core_tpu.utils import logging as jax_logging
from dmlc_core_tpu_torch import data
from dmlc_core_tpu_torch.data import csv_parser, libfm_parser, libsvm_parser, parser
from dmlc_core_tpu_torch.data import row_block, rowrec, text_parser
from dmlc_core_tpu_torch.io import split
from dmlc_core_tpu_torch.io.stream import MemoryStream
from dmlc_core_tpu_torch.utils import cpus
from dmlc_core_tpu_torch.utils import logging

from test_torch_text import assert_blocks_equal

BOM = b"\xef\xbb\xbf"
FORMATS = ("libsvm", "libfm", "csv", "rowrec")
ROWS = 3000


def rows(seed: int, n: int = ROWS):
    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, 12, n)
    idx = [np.sort(rng.choice(5000, k, replace=False)) for k in nnz]
    val = [rng.normal(size=k).astype(np.float32) for k in nnz]
    labels = rng.integers(0, 2, n).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return idx, val, labels, weights


def text_bytes(fmt: str, seed: int, n: int = ROWS) -> bytes:
    idx, val, labels, weights = rows(seed, n)
    lines = []
    for i in range(n):
        if fmt == "libsvm":
            feats = " ".join(f"{j}:{v:.6g}" for j, v in zip(idx[i], val[i]))
            lines.append(f"{labels[i]:g}:{weights[i]:.4g} {feats}".rstrip())
        elif fmt == "libfm":
            feats = " ".join(f"{j % 7}:{j}:{v:.6g}" for j, v in zip(idx[i], val[i]))
            lines.append(f"{labels[i]:g} {feats}".rstrip())
        else:
            dense = np.zeros(6, np.float32)
            dense[: min(6, len(val[i]))] = val[i][:6]
            lines.append(",".join([f"{labels[i]:g}"] + [f"{x:.6g}" for x in dense]))
    return ("\n".join(lines) + "\n").encode()


def write_data(tmp_path, fmt: str, seed: int = 1, bom: bool = False) -> str:
    if fmt == "rowrec":
        idx, val, labels, weights = rows(seed)
        offset = np.r_[0, np.cumsum([len(x) for x in idx])]
        blk = row_block.RowBlock(offset=offset, label=labels,
                                 index=np.concatenate(idx).astype(np.uint32),
                                 value=np.concatenate(val), weight=weights)
        path = tmp_path / "data.rec"
        with open(path, "wb") as f:
            rowrec.write_rowrec(f, [blk])
        return str(path)
    path = tmp_path / f"data{'_bom' if bom else ''}.{fmt}"
    path.write_bytes((BOM if bom else b"") + text_bytes(fmt, seed))
    return str(path)


ARGS = {"libsvm": {}, "libfm": {"indexing_mode": 0}, "csv": {"label_column": 0}, "rowrec": {}}


def direct(pkg: str, fmt: str, path: str, chunk: int, threaded: bool):
    """The parser built by hand over a split whose chunks are ``chunk``
    bytes, so an epoch takes many ``parse_next`` calls."""
    if pkg == "port":
        spl, mods = split, {"libsvm": libsvm_parser.LibSVMParser,
                            "libfm": libfm_parser.LibFMParser,
                            "csv": csv_parser.CSVParser}
        threaded_cls = parser.ThreadedParser
    else:
        spl, mods = jax_split, {"libsvm": jax_libsvm.LibSVMParser,
                                "libfm": jax_libfm.LibFMParser, "csv": jax_csv.CSVParser}
        threaded_cls = jax_parser.ThreadedParser
    if fmt == "rowrec":
        source = spl.RecordIOSplitter(path, 0, 1)
        source.hint_chunk_size(chunk)
        base = (rowrec.RowRecParser(source, index_dtype=np.uint64) if pkg == "port"
                else jax_rowrec.RowRecParser(source, index_dtype=np.uint64))
    else:
        source = spl.LineSplitter(path, 0, 1)
        source.hint_chunk_size(chunk)
        base = mods[fmt](source, dict(ARGS[fmt]), 2)
    return threaded_cls(base) if threaded else base


def epoch(p):
    """One epoch: its blocks, and ``bytes_read()`` after each parse_next."""
    blocks, seq = [], []
    while True:
        got = p.parse_next()
        if got is None:
            return blocks, seq
        blocks.extend(b for b in got if b.size)
        seq.append(p.bytes_read())


def two_epochs(p):
    first = epoch(p)
    p.before_first()
    assert p.bytes_read() == 0
    second = epoch(p)
    p.close()
    return first, second


def assert_same_blocks(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert_blocks_equal(g, w)


@pytest.mark.parametrize("threaded", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_two_epochs_and_bytes_read_equal_jax(tmp_path, fmt, threaded):
    path = write_data(tmp_path, fmt)
    size = len(open(path, "rb").read())
    port = two_epochs(direct("port", fmt, path, 4096, threaded))
    jax = two_epochs(direct("jax", fmt, path, 4096, threaded))
    for (pb, pseq), (jb, jseq) in zip(port, jax):
        assert_same_blocks(pb, jb)
        assert pseq == jseq
        assert pseq == sorted(pseq) and pseq[-1] == size and len(pseq) > 5
    assert_same_blocks(port[1][0], port[0][0])
    assert port[1][1] == port[0][1]


@pytest.mark.parametrize("threaded", [False, True])
@pytest.mark.parametrize("fmt,variant", [
    (fmt, variant) for fmt in FORMATS for variant in ("plain", "bom", "cache")
    if not (fmt == "rowrec" and variant == "bom")])  # a BOM is a text file's
def test_create_parser_two_epochs_equal_jax(tmp_path, fmt, variant, threaded):
    """Through the factories: a BOM is skipped again on the second epoch;
    a ``#cachefile``'s second epoch is replayed from the cache (the JAX
    parser reads the file again) and gives the same blocks and counts."""
    path = write_data(tmp_path, fmt, seed=2, bom=variant == "bom")
    uri = path + ("" if fmt in ("libsvm", "rowrec") else f"?format={fmt}")
    uri += "&label_column=0" if fmt == "csv" else ""
    cache = str(tmp_path / "cache") if variant == "cache" else ""
    port_parser = data.create_parser(uri + (f"#{cache}" if cache else ""), type=fmt,
                                     nthread=2, threaded=threaded)
    port = two_epochs(port_parser)
    jax = two_epochs(jax_data.create_parser(uri, type=fmt, nthread=2, threaded=threaded))
    size = len(open(path, "rb").read())
    for (pb, pseq), (jb, jseq) in zip(port, jax):
        assert_same_blocks(pb, jb)
        assert pseq == jseq and pseq[-1] == size
    if variant == "cache":
        base = port_parser._base if threaded else port_parser
        source = getattr(base, "source", None) or base._source
        assert isinstance(source, split.CachedInputSplit)
        assert source.epochs_replayed == 1


def test_bom_rows_equal_the_plain_file_in_both_epochs(tmp_path):
    plain = two_epochs(data.create_parser(write_data(tmp_path, "libsvm", 3), threaded=False))
    bom = two_epochs(data.create_parser(write_data(tmp_path, "libsvm", 3, bom=True),
                                        threaded=False))
    for (pb, _), (bb, bseq) in zip(plain, bom):
        assert_same_blocks(bb, pb)
        assert bseq[-1] == plain[0][1][-1] + len(BOM)


def test_before_first_mid_epoch_restarts_as_jax(tmp_path):
    path = write_data(tmp_path, "libsvm")
    out = []
    for pkg in ("port", "jax"):
        p = direct(pkg, "libsvm", path, 4096, True)
        head = [p.parse_next() for _ in range(3)]
        seen = p.bytes_read()
        p.before_first()
        blocks, seq = epoch(p)
        p.close()
        out.append((sum(len(h) for h in head), seen, blocks, seq))
    assert out[0][:2] == out[1][:2]
    assert_same_blocks(out[0][2], out[1][2])
    assert out[0][3] == out[1][3]


def step_parser_cls(base_cls, block):
    produced = threading.Semaphore(0)

    class StepParser(base_cls):
        """Each parse_next consumes 100 bytes and gives one block."""

        def __init__(self):
            self.n = 0
            self.rewinds = 0

        def parse_next(self):
            if self.n >= 5:
                return None
            self.n += 1
            produced.release()
            return [block]

        def before_first(self):
            self.rewinds += 1
            self.n = 0

        def bytes_read(self):
            return self.n * 100

    return StepParser, produced


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_bytes_read_is_the_delivery_watermark(pkg):
    """The JAX package's watermark test on each package: the producer runs
    ahead, but ``bytes_read()`` counts only the batches delivered; the
    first epoch never rewinds the base, a later one does once."""
    mod = parser if pkg == "port" else jax_parser
    blk = row_block.RowBlock(offset=np.array([0, 1]), label=np.ones(1, np.float32),
                             index=np.array([3], np.uint64))
    cls, produced = step_parser_cls(mod.Parser, blk)
    base = cls()
    tp = mod.ThreadedParser(base, max_capacity=8)
    for _ in range(5):
        assert produced.acquire(timeout=5)
    assert tp.bytes_read() == 0
    seen = []
    while tp.parse_next() is not None:
        seen.append(tp.bytes_read())
    assert seen == [100, 200, 300, 400, 500] and base.rewinds == 0
    tp.before_first()
    assert tp.bytes_read() == 0
    assert tp.parse_next() is not None and tp.bytes_read() == 100
    assert base.rewinds == 1
    tp.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_threaded_parser_relays_the_base_error(pkg):
    mod = parser if pkg == "port" else jax_parser

    class Broken(mod.Parser):
        calls = 0

        def parse_next(self):
            Broken.calls += 1
            if Broken.calls > 2:
                raise ValueError("bad chunk")
            return []

        def bytes_read(self):
            return 0

    tp = mod.ThreadedParser(Broken())
    assert tp.parse_next() == [] and tp.parse_next() == []
    with pytest.raises(ValueError, match="bad chunk"):
        tp.parse_next()
    tp.close()


def test_close_while_the_producer_waits_on_a_full_queue(tmp_path):
    p = direct("port", "libsvm", write_data(tmp_path, "libsvm"), 1024, True)
    assert p.parse_next() is not None
    p.close()
    assert not any(t.name == "threaded-parser" and t.is_alive()
                   for t in threading.enumerate())


def test_default_parser_threads_as_jax(monkeypatch):
    monkeypatch.setattr(cpus, "available_cpus", lambda: 8)
    monkeypatch.setattr(jax_cpus, "available_cpus", lambda: 8)
    for env in ({}, {"DMLC_TPU_PARSER_THREADS": "5"},
                {"DMLC_TPU_PARSER_THREADS": "5", "DMLC_PARSE_THREADS": "7"}):
        monkeypatch.delenv("DMLC_PARSE_THREADS", raising=False)
        monkeypatch.delenv("DMLC_TPU_PARSER_THREADS", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for req in (None, 1, 3, 8, 16):
            assert (text_parser.default_parser_threads(req)
                    == jax_text_parser.default_parser_threads(req)), (env, req)


PARAMS = [(libsvm_parser.LibSVMParserParam, jax_libsvm.LibSVMParserParam),
          (libfm_parser.LibFMParserParam, jax_libfm.LibFMParserParam),
          (csv_parser.CSVParserParam, jax_csv.CSVParserParam)]


@pytest.mark.parametrize("port_cls,jax_cls", PARAMS)
def test_parser_params_defaults_and_doc_equal_jax(port_cls, jax_cls):
    p, j = port_cls(), jax_cls()
    p.init({})
    j.init({})
    assert p.to_dict() == j.to_dict()
    assert port_cls.doc() == jax_cls.doc()
    assert port_cls.field_names() == jax_cls.field_names()
    assert p.init({"format": p.format, "extra": "1"}, allow_unknown=True) == j.init(
        {"format": j.format, "extra": "1"}, allow_unknown=True)


def construct_error(pkg: str, fmt: str, tmp_path, args):
    path = tmp_path / "e.txt"
    path.write_bytes(b"1 0:1\n")
    spl = split if pkg == "port" else jax_split
    cls = {("port", "libsvm"): libsvm_parser.LibSVMParser,
           ("port", "libfm"): libfm_parser.LibFMParser,
           ("port", "csv"): csv_parser.CSVParser,
           ("jax", "libsvm"): jax_libsvm.LibSVMParser,
           ("jax", "libfm"): jax_libfm.LibFMParser,
           ("jax", "csv"): jax_csv.CSVParser}[pkg, fmt]
    source = spl.LineSplitter(str(path), 0, 1)
    try:
        cls(source, args, 1).close()
    except Exception as e:  # the texts are compared across the packages
        source.close()
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("fmt,args", [
    ("libsvm", {"indexing_mode": "one"}),
    ("libsvm", {"format": "csv"}),
    ("libfm", {"indexing_mode": "1.5"}),
    ("libfm", {"format": "libsvm"}),
    ("csv", {"dtype": "float16"}),
    ("csv", {"label_column": "x"}),
    ("csv", {"delimiter": "::"}),
    ("csv", {"label_column": 2, "weight_column": 2}),
    ("csv", {"format": "libfm"}),
])
def test_bad_parser_arguments_raise_the_jax_text(tmp_path, fmt, args):
    got = construct_error("port", fmt, tmp_path, args)
    want = construct_error("jax", fmt, tmp_path, args)
    assert got is not None and got[1] == want[1]
    assert got[0] in ("Error", "ParamError") and got[0] == want[0]


def test_registry_holds_the_formats_and_takes_a_new_one(tmp_path):
    assert sorted(data.PARSER_REGISTRY.names()) == sorted(jax_data.PARSER_REGISTRY.names())
    path = write_data(tmp_path, "libsvm")
    for reg, make in ((data.PARSER_REGISTRY, data.create_parser),
                      (jax_data.PARSER_REGISTRY, jax_data.create_parser)):
        libsvm = reg.find("libsvm")
        reg.add("svm_alias", lambda *a, _e=libsvm: _e(*a))
        try:
            blocks = list(make(path, type="svm_alias", threaded=False))
        finally:
            reg.remove("svm_alias")
        assert sum(b.size for b in blocks) == ROWS
    with pytest.raises(logging.Error, match="Unknown data type"):
        data.create_parser(path, type="nope")


def block_pair(seed: int):
    rng = np.random.default_rng(seed)
    n = 40
    nnz = rng.integers(0, 6, n)
    total = int(nnz.sum())
    arrays = dict(offset=np.r_[0, np.cumsum(nnz)], label=rng.normal(size=n).astype(np.float32),
                  index=rng.integers(0, 900, total).astype(np.uint64),
                  value=rng.normal(size=total).astype(np.float32),
                  weight=rng.uniform(0.5, 2, n).astype(np.float32),
                  qid=rng.integers(0, 5, n).astype(np.int64),
                  field=rng.integers(0, 4, total).astype(np.int64))
    return row_block.RowBlock(**arrays), jax_row_block.RowBlock(**arrays)


@pytest.mark.parametrize("drop", [(), ("value", "weight", "qid", "field")])
def test_rows_of_a_block_equal_jax(drop):
    port, jax = block_pair(4)
    for name in drop:
        setattr(port, name, None)
        setattr(jax, name, None)
    dense = np.random.default_rng(5).normal(size=1000).astype(np.float32)
    assert len(list(port)) == len(list(jax)) == port.size
    for i in range(port.size):
        p, j = port[i], jax[i]
        for name in ("label", "weight", "qid", "field", "index", "value"):
            a, b = getattr(p, name), getattr(j, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a, b)
                assert np.asarray(a).dtype == np.asarray(b).dtype
        assert len(p) == len(j) and repr(p) == repr(j)
        assert p.sdot(dense) == j.sdot(dense)
        assert port.get_weight(i) == jax.get_weight(i)
        if len(p):
            assert p.get_value(0) == j.get_value(0)
    texts = []
    for blk in (port, jax):
        with pytest.raises(Exception) as info:
            blk[port.size]
        texts.append(str(info.value))
    assert texts[0] == texts[1]


def fill_container(c, rng):
    for i in range(30):
        k = int(rng.integers(0, 5))
        idx = rng.integers(0, 500, k)
        kind = i % 4
        c.push_row(float(rng.normal()), idx,
                   value=None if kind == 0 else rng.normal(size=k).astype(np.float32),
                   weight=1.0 if kind < 2 else float(rng.uniform(0.5, 2)),
                   qid=0 if kind < 3 else int(rng.integers(1, 9)),
                   field=None if kind != 1 else rng.integers(0, 7, k))
        if i % 10 == 9:
            c.push_block(block_pair(i)[0])


def test_container_push_row_equals_jax():
    port, jax = row_block.RowBlockContainer(), jax_row_block.RowBlockContainer()
    fill_container(port, np.random.default_rng(6))
    fill_container(jax, np.random.default_rng(6))
    assert (port.size, port.max_index, port.max_field, port.mem_cost_bytes()) == (
        jax.size, jax.max_index, jax.max_field, jax.mem_cost_bytes())
    assert_blocks_equal(port.to_block(), jax.to_block())
    ps, js = MemoryStream(), JaxMemoryStream()
    port.save(ps)
    jax.save(js)
    assert ps.getvalue() == js.getvalue()
    back, jback = row_block.RowBlockContainer(), jax_row_block.RowBlockContainer()
    ps.seek(0)
    js.seek(0)
    assert back.load(ps) and jback.load(js)
    assert_blocks_equal(back.to_block(), port.to_block())
    assert (back.max_index, back.max_field) == (jback.max_index, jback.max_field)
    assert not back.load(ps) and not jback.load(js)
    texts = []
    for c in (row_block.RowBlockContainer(), jax_row_block.RowBlockContainer()):
        with pytest.raises(Exception) as info:
            c.push_row(1.0, [1, 2], value=[0.5])
        texts.append(str(info.value))
    assert texts[0] == texts[1]


def test_encode_row_bytes_equal_jax():
    idx, val, labels, weights = rows(7, 200)
    for i in range(200):
        for v, w in ((val[i], float(weights[i])), (None, 1.0)):
            assert rowrec.encode_row(float(labels[i]), idx[i], v, w) == jax_rowrec.encode_row(
                float(labels[i]), idx[i], v, w)
    texts = []
    for mod in (rowrec, jax_rowrec):
        with pytest.raises(Exception) as info:
            mod.encode_row(1.0, [1, 2], [0.5])
        texts.append(str(info.value))
    assert texts[0] == texts[1]
    blk = rowrec.decode_records([rowrec.encode_row(
        1.0, np.array([4, 9]), np.array([0.5, -2.0], np.float32), 0.25)])
    assert blk.index.tolist() == [4, 9] and blk.weight.tolist() == [0.25]


RATE = re.compile(r"\d+\.\d\d MB/sec")


def progress_lines(mod, make):
    lines = []
    mod.set_log_sink(lambda sev, msg: lines.append((sev, RATE.sub("<rate>", msg))))
    try:
        it = make()
        blocks = []
        for _ in range(2):
            it.before_first()
            blocks.append(list(it))
        it.close()
    finally:
        mod.set_log_sink(None)
    return lines, blocks


@pytest.mark.parametrize("cached", [False, True])
def test_row_iter_progress_lines_count_source_bytes_as_jax(tmp_path, cached):
    """A 12 MB libsvm file through both packages' row iterators read for
    two epochs: the sink's lines are the JAX package's (rates aside), and
    their megabytes are the source's, not the parsed blocks'."""
    path = tmp_path / "big.libsvm"
    block = text_bytes("libsvm", 9, 20000)
    reps = (12 << 20) // len(block) + 1
    path.write_bytes(block * reps)
    size = path.stat().st_size
    uri = str(path) + (f"#{tmp_path / 'rowcache'}" if cached else "")
    port, pblocks = progress_lines(logging, lambda: data.create_row_block_iter(uri))
    jax_uri = uri.replace("rowcache", "jaxcache")
    jax, jblocks = progress_lines(jax_logging, lambda: jax_data.create_row_block_iter(jax_uri))
    assert port == jax
    assert port[-1] == ("INFO", "finish reading at <rate>")
    mbs = [int(m.group(1)) for _, msg in port if (m := re.match(r"(\d+)MB read", msg))]
    if not cached:  # the cache build logs at 64 MB pages only
        assert mbs and mbs[-1] == size >> 20 and all(mb >= 10 for mb in mbs)
    for p, j in zip(pblocks, jblocks):
        assert_same_blocks(p, j)
    assert_same_blocks(pblocks[1], pblocks[0])
