"""The generator and the frozen encoders."""

import struct

import numpy as np
import pytest

from perfbench import encode, gen, reference
from perfbench.tests import cells

CELLS = ("criteo_fm.rec_seq", "criteo_fm.libsvm", "higgs_lr.csv")


def small(cell):
    c = cells.load(cell)
    return c.config, dict(c.traffic, file_rows=4 * 4096, block_rows=4096)


@pytest.mark.parametrize("cell", CELLS)
def test_rows_and_bytes_follow_the_seed(cell):
    cfg, traffic = small(cell)
    a = gen.encode_rows(gen.make_rows(2**31 + 7, 4096, cfg), traffic)
    b = gen.encode_rows(gen.make_rows(2**31 + 7, 4096, cfg), traffic)
    c = gen.encode_rows(gen.make_rows(2**31 + 8, 4096, cfg), traffic)
    assert a[0] == b[0] and np.array_equal(a[1], b[1])
    assert a[0] != c[0]
    assert int(a[1].sum()) == len(a[0])


def test_criteo_field_ids():
    cfg, _ = small("criteo_fm.rec_seq")
    rows = gen.make_rows(3, 50000, cfg)
    r = cfg["rows"]
    ni, d, cards = r["integer_fields"], cfg["num_features"], r["cardinalities"]
    assert rows.idx.shape == (50000, ni + len(cards))
    assert rows.idx.min() >= 0 and rows.idx.max() < d
    assert np.all(rows.val == 1.0)
    # an integer field holds at most the buckets of [0, integer_max)
    top = int(np.floor(np.log(r["integer_max"] - 1) ** 2))
    for f in range(ni):
        assert len(np.unique(rows.idx[:, f])) <= top + 1
    cat = rows.idx[:, ni:]
    # a field of 3 values: ranks 1, 2, 3 with falling frequency
    f = cards.index(3)
    vals, counts = np.unique(cat[:, f], return_counts=True)
    assert len(vals) == 3 and counts.max() > 0.4 * 50000
    # the 10M-value field's rare value takes the ranks past the last one
    # the published rows hold 10 times: about an eighth of its draws
    big = int(np.argmax(cards))
    _, counts = np.unique(cat[:, big], return_counts=True)
    assert 0.10 < counts.max() / 50000 < 0.15
    assert 0.2 < rows.labels.mean() < 0.3


def test_rare_rank_and_log_buckets():
    # rows * P(rank) >= 10 up to the rare rank, not past it
    card, s, n = 10131227, 1.1, 45840617
    r = gen.rare_rank(card, s, n, 10)
    span = (card + 1.0) ** (1 - s) - 1.0

    def count(k):
        return n * ((k + 1.0) ** (1 - s) - k ** (1 - s)) / span

    assert count(r) >= 10 > count(r + 1)
    assert gen.rare_rank(3, s, n, 10) == 3
    assert gen.log_bucket(np.array([0, 1, 2, 3, 10, 1000])).tolist() == [0, 1, 2, 1, 5, 47]


def test_zipf_ranks_follow_the_power_law():
    r = gen.zipf_ranks(np.random.default_rng(0), 400000, 1000, 1.1)
    assert r.min() == 1 and r.max() <= 1000
    c = np.bincount(r, minlength=1001)
    # P(1) / P(2) = 2^1.1 for the continuous law's first two unit cells,
    # roughly
    assert 1.6 < c[1] / c[2] < 2.6
    assert c[1] > c[10] > c[100]


def test_sci18_matches_c_printf():
    k = np.random.default_rng(1).integers(-(1 << 20) + 1, 1 << 20, 3000)
    k[:3] = [0, 1 << 16, -(1 << 16)]
    text, lengths = encode.lines([encode.sci18_field(k, 16), encode.const(len(k), b"\n")])
    want = "".join("%.18e\n" % (v / 65536.0) for v in k.tolist()).encode()
    assert text == want
    assert lengths.sum() == len(want)


def test_uint_field_and_lines():
    x = np.array([0, 7, 10, 123456789, 10 ** 18])
    text, lengths = encode.lines([encode.uint_field(x), encode.const(5, b","),
                                  encode.uint_field(x % 1000), encode.const(5, b"\n")])
    want = "".join(f"{v},{v % 1000}\n" for v in x.tolist()).encode()
    assert text == want and lengths.tolist() == [len(s) + 1 for s in want.decode().splitlines()]


def read_rowrec(buf: bytes):
    """A plain reader of rowrec RecordIO (escaped parts joined by the
    magic they stood for): [(label, weight, idx, val, frame start)]."""
    out, pos = [], 0
    while pos < len(buf):
        start, parts = pos, []
        while True:
            magic, lrec = struct.unpack_from("<II", buf, pos)
            assert magic == encode.KMAGIC
            cflag, n = lrec >> 29, lrec & ((1 << 29) - 1)
            parts.append(buf[pos + 8:pos + 8 + n])
            pos += 8 + n + (-n) % 4
            if cflag in (0, 3):
                break
        payload = struct.pack("<I", encode.KMAGIC).join(parts)
        label, weight, nnz = struct.unpack_from("<ffI", payload, 0)
        idx = np.frombuffer(payload, "<u4", nnz, 12)
        val = np.frombuffer(payload, "<f4", nnz, 12 + 4 * nnz)
        out.append((label, weight, idx, val, start))
    return out


def test_rowrec_read_back_with_escapes():
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 1 << 20, (50, 39))
    val = rng.random((50, 39)).astype(np.float32)
    # two payload words equal to the magic: one row takes the escaped frame
    val[7, 3] = np.array([encode.KMAGIC], dtype=np.uint32).view(np.float32)[0]
    val[7, 9] = val[7, 3]
    labels = (rng.random(50) > 0.5).astype(np.float32)
    blob, lengths = encode.rowrec_block(labels, idx, val)
    got = read_rowrec(blob)
    assert len(got) == 50 and lengths[7] > lengths[0] and int(lengths.sum()) == len(blob)
    for i, (lab, w, gi, gv, start) in enumerate(got):
        assert lab == labels[i] and w == 1.0
        assert np.array_equal(gi, idx[i]) and np.array_equal(gv.view(np.uint32),
                                                            val[i].view(np.uint32))
        assert start == int(lengths[:i].sum())


def test_file_layout_and_index(tmp_path):
    cfg, traffic = small("criteo_fm.rec_seq")
    traffic = dict(traffic, index=True, rotate_rows=1000)
    rows, layout, path = gen.make_input(11, cfg, traffic, str(tmp_path))
    data = open(path, "rb").read()
    assert len(data) == layout.starts[-1] and layout.rows == 4 * 4096
    got = read_rowrec(data)
    j = np.array([1, 4095, 4096, 4097, 9000, 16383])
    order = layout.order(j)
    for jj, o in zip(j.tolist(), order.tolist()):
        assert got[jj][4] == layout.starts[jj]
        assert np.array_equal(got[jj][2], rows.idx[o])
    lines = open(path + ".idx").read().splitlines()
    assert [int(x.split("\t")[1]) for x in lines] == layout.starts[:-1].tolist()


def test_text_file_rows_follow_the_layout(tmp_path):
    cfg, traffic = small("higgs_lr.csv")
    rows, layout, path = gen.make_input(12, cfg, traffic, str(tmp_path))
    data = open(path, "rb").read()
    for j in (0, 5, 4096, 10000, 16383):
        a, b = layout.starts[j], layout.starts[j + 1]
        cells = data[a:b].decode().rstrip("\n").split(",")
        o = layout.order(np.array([j]))[0]
        assert float(cells[0]) == rows.labels[o]
        assert np.array_equal(np.array(cells[1:], dtype=np.float64).astype(np.float32), rows.x[o])


def test_part_rows_follow_the_split_rule():
    # rows of 10 bytes; 3 parts of ceil(100/3) = 34 bytes
    starts = np.arange(0, 101, 10)
    # text: a bound moves past the next newline (a line starting on it
    # belongs to the part before); RecordIO: to the next record start,
    # the bound rounded up to 4 bytes (36)
    assert reference.part_rows(starts, 3, text=True) == [(0, 4), (4, 7), (7, 10)]
    assert reference.part_rows(starts, 3, text=False) == [(0, 4), (4, 8), (8, 10)]
    assert reference.part_rows(np.arange(0, 81, 10), 2, text=True) == [(0, 5), (5, 8)]
    assert reference.part_rows(np.arange(0, 81, 20), 2, text=False) == [(0, 2), (2, 4)]


def test_batch_plan_interleaves_parts():
    plan = reference.batch_plan([(0, 10), (10, 15)], 4)
    assert plan == [(0, 4), (10, 4), (4, 4), (14, 1), (8, 2)]


def test_libsvm_lines_hold_one_based_ids(tmp_path):
    cfg, traffic = small("criteo_fm.libsvm")
    rows, layout, path = gen.make_input(13, cfg, traffic, str(tmp_path))
    data = open(path, "rb").read()
    assert len(data) == layout.starts[-1]
    for j in (0, 7, 4096, 9999, 16383):
        line = data[layout.starts[j]:layout.starts[j + 1]].decode()
        assert line.endswith("\n")
        toks = line.split()
        o = layout.order(np.array([j]))[0]
        assert float(toks[0]) == rows.labels[o]
        assert [t.split(":") for t in toks[1:]] == [[str(i + 1), "1"] for i in rows.idx[o]]
