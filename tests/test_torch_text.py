"""The port's text layer against the JAX package's, on the CPU: URI
options, CPU counts, token rules, line-aligned splits, the libsvm/libfm/csv
parsers (native CSR parse and plain parse), the parser factory and the
dense FixedShapeBatcher. RowBlocks and batches must be equal byte for
byte; inputs include malformed tokens, comments, blank lines, a BOM, CRLF
and indexing_mode in {-1, 0, 1}."""

import numpy as np
import pytest

from dmlc_core_tpu.data import create_parser as jax_create_parser
from dmlc_core_tpu.data.csv_parser import CSVParser as JaxCSV
from dmlc_core_tpu.data.libfm_parser import LibFMParser as JaxLibFM
from dmlc_core_tpu.data.libsvm_parser import LibSVMParser as JaxLibSVM
from dmlc_core_tpu.data.row_block import RowBlock as JaxRowBlock
from dmlc_core_tpu.data.strtonum import parse_pair as jax_parse_pair
from dmlc_core_tpu.data.strtonum import parse_triple as jax_parse_triple
from dmlc_core_tpu.io import split as jax_split
from dmlc_core_tpu.io.uri import URISpec as JaxURISpec
from dmlc_core_tpu.io.uri import rejoin_query as jax_rejoin
from dmlc_core_tpu.staging import BatchSpec as JaxSpec
from dmlc_core_tpu.staging import FixedShapeBatcher as JaxBatcher
from dmlc_core_tpu.utils import cpus as jax_cpus
from dmlc_core_tpu_torch.data import create_parser
from dmlc_core_tpu_torch.data.csv_parser import CSVParser
from dmlc_core_tpu_torch.data.libfm_parser import LibFMParser
from dmlc_core_tpu_torch.data.libsvm_parser import LibSVMParser
from dmlc_core_tpu_torch.data.row_block import RowBlock
from dmlc_core_tpu_torch.data.strtonum import parse_pair, parse_triple
from dmlc_core_tpu_torch.io import split
from dmlc_core_tpu_torch.io.uri import URISpec, rejoin_query, uri_int
from dmlc_core_tpu_torch.staging.batcher import BatchSpec, FixedShapeBatcher
from dmlc_core_tpu_torch.utils import cpus
from dmlc_core_tpu_torch.utils.logging import Error

from test_torch_native import CSV_CASES, LIBFM_CASES, LIBSVM_CASES

FIELDS = ("offset", "label", "index", "value", "weight", "qid", "field")


def assert_blocks_equal(got, want):
    for name in FIELDS:
        g, w = getattr(got, name, None), getattr(want, name, None)
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), err_msg=name)


def stub_source(tmp_path, cls):
    p = tmp_path / "stub.txt"
    p.write_bytes(b"0\n")
    return cls(str(p), 0, 1)


def parser_pair(tmp_path, fmt, **kw):
    port_cls, jax_cls = {"libsvm": (LibSVMParser, JaxLibSVM),
                         "libfm": (LibFMParser, JaxLibFM),
                         "csv": (CSVParser, JaxCSV)}[fmt]
    port = port_cls(stub_source(tmp_path, split.LineSplitter), nthread=1, **kw)
    jax = jax_cls(stub_source(tmp_path, jax_split.LineSplitter), dict(kw), nthread=1)
    return port, jax


@pytest.mark.parametrize("mode", [0, 1, -1])
@pytest.mark.parametrize("case", range(len(LIBSVM_CASES)))
def test_libsvm_blocks_match_jax(tmp_path, case, mode):
    port, jax = parser_pair(tmp_path, "libsvm", indexing_mode=mode)
    data = LIBSVM_CASES[case]
    assert_blocks_equal(port.parse_block(data), jax.parse_block(data))
    assert_blocks_equal(port.parse_block_plain(data), jax._parse_block_py(data))
    port.close()
    jax.close()


@pytest.mark.parametrize("mode", [0, 1, -1])
@pytest.mark.parametrize("case", range(len(LIBFM_CASES)))
def test_libfm_blocks_match_jax(tmp_path, case, mode):
    port, jax = parser_pair(tmp_path, "libfm", indexing_mode=mode)
    data = LIBFM_CASES[case]
    assert_blocks_equal(port.parse_block(data), jax.parse_block(data))
    assert_blocks_equal(port.parse_block_plain(data), jax._parse_block_py(data))
    port.close()
    jax.close()


@pytest.mark.parametrize("kw", [
    {}, {"label_column": 0}, {"label_column": 0, "weight_column": 2},
    {"dtype": "int32"}, {"dtype": "int64", "label_column": 1},
])
@pytest.mark.parametrize("case", range(len(CSV_CASES)))
def test_csv_blocks_match_jax(tmp_path, case, kw):
    port, jax = parser_pair(tmp_path, "csv", **kw)
    data = CSV_CASES[case]
    assert_blocks_equal(port.parse_block(data), jax.parse_block(data))
    assert_blocks_equal(port.parse_block_plain(data), jax._parse_block_py(data))
    port.close()
    jax.close()


def test_csv_line_without_a_feature_raises_like_jax(tmp_path):
    port, jax = parser_pair(tmp_path, "csv", label_column=0)
    for parse in (port.parse_block, port.parse_block_plain):
        with pytest.raises(Error, match="Delimiter"):
            parse(b"1\n")
    with pytest.raises(Exception, match="Delimiter"):
        jax._parse_block_py(b"1\n")
    with pytest.raises(Error, match="distinct columns"):
        parser_pair(tmp_path, "csv", label_column=1, weight_column=1)


def random_text(fmt, n, seed):
    """Lines of ``fmt`` with the cases the parsers must agree on."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        label = f"{int(rng.integers(0, 2))}"
        if fmt == "csv":
            cells = [label] + [f"{rng.normal():.6g}" for _ in range(5)]
            if i % 9 == 0:
                cells[3] = "junk"
            line = ",".join(cells)
        else:
            toks = [label]
            for _ in range(int(rng.integers(0, 8))):
                j = int(rng.integers(0, 40))
                f = int(rng.integers(0, 5))
                toks.append(f"{f}:{j}:{rng.normal():.5g}" if fmt == "libfm"
                            else f"{j}:{rng.normal():.5g}")
            if i % 10 == 0:
                toks.append("bad:tok")
            if fmt == "libsvm" and i % 7 == 0:
                toks.insert(1, f"qid:{i}")
            line = " ".join(toks)
            if fmt == "libsvm" and i % 6 == 0:
                line += " # trailing comment"
        lines.append(line + ("\r\n" if i % 5 == 0 else "\n"))
        if fmt != "csv" and i % 13 == 0:
            lines.append("\n")
    return b"\xef\xbb\xbf" + "".join(lines).encode()


@pytest.mark.parametrize("nthread", [1, 3])
@pytest.mark.parametrize("num_parts", [1, 3])
@pytest.mark.parametrize("fmt,query", [
    ("libsvm", ""), ("libsvm", "?indexing_mode=1"), ("libsvm", "?indexing_mode=-1"),
    ("libfm", "?indexing_mode=-1"), ("libfm", ""),
    ("csv", "?label_column=0"), ("csv", "?label_column=0&weight_column=2"),
])
def test_create_parser_blocks_match_jax(tmp_path, fmt, query, num_parts, nthread):
    path = tmp_path / f"data.{fmt}"
    path.write_bytes(random_text(fmt, 3000, seed=len(query) + num_parts))
    for part in range(num_parts):
        port = create_parser(str(path) + query, part, num_parts, type=fmt, nthread=nthread)
        jax = jax_create_parser(str(path) + query, part, num_parts, type=fmt,
                                nthread=nthread, threaded=False)
        got, want = list(port), list(jax)
        port.close()
        jax.close()
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert_blocks_equal(g, w)


def test_create_parser_takes_the_format_from_the_uri(tmp_path):
    path = tmp_path / "data.txt"
    path.write_bytes(b"1.0,2.0\n3,4\n")
    blk = next(iter(create_parser(f"{path}?format=csv&label_column=0")))
    np.testing.assert_array_equal(blk.label, [1.0, 3.0])
    np.testing.assert_array_equal(blk.value, [2.0, 4.0])


@pytest.mark.parametrize("uri,match", [
    ("{p}?format=libsvm&shuffle_parts=2", "not supported"),
    ("{p}?format=csv", "format mismatch"),
    ("{p}#cache", "cachefile"),
    ("{p};{p}", "multi-file"),
    ("s3://bucket/x", "remote"),
    ("{p}.missing", "Cannot find"),
    ("{p}?indexing_mode=one", "not an integer"),
])
def test_create_parser_refuses_what_the_port_lacks(tmp_path, uri, match):
    """What the port lacks raises. A ``#cachefile`` and a file set, once
    refused, read since slice 7: the blocks equal the JAX package's (its
    parser drops the fragment; the port's caches the chunks in it)."""
    p = tmp_path / "a.libsvm"
    p.write_bytes(b"1 0:1\n")
    uri = uri.format(p=p).replace("#cache", f"#{tmp_path / 'cache'}")
    if match in ("cachefile", "multi-file"):
        port, jax = create_parser(uri, type="libsvm"), jax_create_parser(uri, type="libsvm")
        got, want = list(port), list(jax)
        port.close()
        jax.close()
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert_blocks_equal(g, w)
        assert (tmp_path / "cache").exists() == (match == "cachefile")
        return
    with pytest.raises(Error, match=match):
        create_parser(uri, type="libsvm")


@pytest.mark.parametrize("num_parts", [1, 2, 3, 7])
def test_line_splitter_chunks_match_jax(tmp_path, num_parts):
    path = tmp_path / "lines.txt"
    text = random_text("libsvm", 400, seed=1) + b"1 0:1\r\r\n\n2 1:2"  # no last newline
    path.write_bytes(text)
    cover = b""
    for part in range(num_parts):
        port = split.create(str(path), part, num_parts, type="text", threaded=False)
        jax = jax_split.LineSplitter(str(path), part, num_parts)
        port.buffer_size = jax.buffer_size = 256
        got = list(iter(port.next_chunk, None))
        want = list(iter(jax.next_chunk, None))
        assert got == want
        assert (port.offset_begin, port.offset_end) == (jax.offset_begin, jax.offset_end)
        cover += b"".join(got)
        port.close()
        jax.close()
    assert cover.replace(b"\r", b"\n").split() == (text + b"\n").replace(b"\r", b"\n").split()


def dense_blocks(seed):
    rng = np.random.default_rng(seed)
    n, d = 50, 12
    uni_idx = np.tile(np.arange(0, 2 * d, 2, dtype=np.uint64)[:6], n)
    uni = dict(offset=np.arange(n + 1) * 6, label=rng.normal(size=n).astype(np.float32),
               index=uni_idx, value=rng.normal(size=n * 6).astype(np.float32))
    nnz = rng.integers(0, 9, n)
    total = int(nnz.sum())
    idx = rng.integers(0, d + 4, total).astype(np.uint64)
    idx[::17] = np.uint64(2**64 - 3)  # a wrapped negative id
    rag = dict(offset=np.r_[0, np.cumsum(nnz)], label=rng.normal(size=n).astype(np.float32),
               index=idx, value=rng.normal(size=total).astype(np.float32) * 5e4,
               weight=rng.uniform(0.5, 2, n).astype(np.float32))
    dup = dict(offset=np.array([0, 3, 4]), label=np.ones(2, np.float32),
               index=np.array([2, 2, 5, 1], np.uint64))
    return [uni, rag, dup]


@pytest.mark.parametrize("overflow", ["truncate", "error"])
@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_dense_batcher_matches_jax(which, vdtype, overflow):
    arrays = dense_blocks(5)[which]
    cuts = [(0, 7), (7, 30), (30, len(arrays["offset"]) - 1)] if which < 2 else [(0, 2)]
    spec = BatchSpec(batch_size=16, layout="dense", num_features=12,
                     value_dtype=vdtype, overflow=overflow)
    jspec = JaxSpec(batch_size=16, layout="dense", num_features=12,
                    value_dtype=np.dtype(vdtype), overflow=overflow)
    port, jax = FixedShapeBatcher(spec), JaxBatcher(jspec)
    blocks = [RowBlock(**arrays).slice(a, b) for a, b in cuts]
    jblocks = [JaxRowBlock(**arrays).slice(a, b) for a, b in cuts]
    if overflow == "error" and which == 1:
        with pytest.raises(Error, match="num_features"):
            list(port.batches(blocks))
        return
    got, want = list(port.batches(blocks)), list(jax.batches(jblocks))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.n_valid == w.n_valid
        assert list(g.as_dict()) == list(w.as_dict())
        np.testing.assert_array_equal(g.packed, w.packed)
    assert port.truncated_nnz == jax.truncated_nnz


def test_dense_spec_checks():
    with pytest.raises(Error, match="num_features"):
        BatchSpec(batch_size=4, layout="dense")
    with pytest.raises(Error, match="bad layout"):
        BatchSpec(batch_size=4, layout="coo", max_nnz=3)


@pytest.mark.parametrize("uri", [
    "/d/x.libsvm", "/d/x.csv?format=csv&label_column=0&delimiter=;",
    "/d/x.rec?a=1&&b=#cache", "file:///d/x?k", "/d/x#c?not_a_query",
])
@pytest.mark.parametrize("parts", [(0, 1), (2, 4)])
def test_uri_spec_matches_jax(uri, parts):
    got, want = URISpec(uri, *parts), JaxURISpec(uri, *parts)
    assert (got.uri, got.args, got.cache_file) == (want.uri, want.args, want.cache_file)
    assert rejoin_query(got.args) == jax_rejoin(want.args)


def test_uri_int():
    assert uri_int({"n": "3"}, "n", 0) == 3 and uri_int({}, "n", 7) == 7
    with pytest.raises(Error, match="not an integer"):
        uri_int({"n": "x"}, "n", 0)
    with pytest.raises(Error, match=">= 1"):
        uri_int({"n": "0"}, "n", 0, minimum=1)


@pytest.mark.parametrize("env,requested", [
    (None, None), (None, 1), (None, 10_000), ("3", None), ("2", 99),
])
def test_parse_threads_match_jax(monkeypatch, env, requested):
    monkeypatch.delenv("DMLC_TPU_PARSER_THREADS", raising=False)
    if env is None:
        monkeypatch.delenv("DMLC_PARSE_THREADS", raising=False)
    else:
        monkeypatch.setenv("DMLC_PARSE_THREADS", env)
    assert cpus.parse_threads(requested) == jax_cpus.parse_threads(requested)
    assert cpus.available_cpus() == jax_cpus.available_cpus()


@pytest.mark.parametrize("primary,alias,requested", [
    (None, "3", None), (None, "2", 99), ("5", "2", None), (None, None, 1),
])
def test_parse_threads_honour_the_legacy_alias_like_jax(monkeypatch, primary,
                                                        alias, requested):
    """``DMLC_TPU_PARSER_THREADS`` counts when ``DMLC_PARSE_THREADS`` is
    unset, in both packages."""
    for name, value in (("DMLC_PARSE_THREADS", primary),
                        ("DMLC_TPU_PARSER_THREADS", alias)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    got = cpus.parse_threads(requested)
    assert got == jax_cpus.parse_threads(requested)
    if primary or alias:
        assert got == int(primary or alias)


@pytest.mark.parametrize("tok", [
    b"1", b"1:2", b"-1.5e3:0.25", b"1_0", b"a:1", b"1:", b":1", b"inf:nan",
    b"1:2:3", b"1:2:x", b"99999999999999999999:1:1", b"0:-4", b"1e999",
])
def test_token_rules_match_jax(tok):
    assert repr(parse_pair(tok)) == repr(jax_parse_pair(tok))  # nan != nan
    assert repr(parse_triple(tok)) == repr(jax_parse_triple(tok))
