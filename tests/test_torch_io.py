"""The port's local streams, filesystem, serializer and index writers
against the JAX package's, on the CPU: the same numpy inputs from a
seed give the same bytes (bit for bit, no tolerance), and each package
reads what the other wrote."""

import os

import numpy as np
import pytest

from dmlc_core_tpu.data.row_block import RowBlock as JaxRowBlock
from dmlc_core_tpu.data.rowrec import write_rowrec as jax_write_rowrec
from dmlc_core_tpu.io import serializer as jax_serializer
from dmlc_core_tpu.io.filesystem import FileSystem as JaxFileSystem
from dmlc_core_tpu.io.recordio import IndexedRecordIOWriter as JaxIndexedWriter
from dmlc_core_tpu.io.stream import MemoryStream as JaxMemoryStream
from dmlc_core_tpu.io.stream import Stream as JaxStream
from dmlc_core_tpu_torch.data.row_block import RowBlock
from dmlc_core_tpu_torch.data.rowrec import write_rowrec
from dmlc_core_tpu_torch.io import serializer
from dmlc_core_tpu_torch.io.filesystem import FileInfo, FileSystem, LocalFileSystem
from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
from dmlc_core_tpu_torch.io.stream import FileStream, MemoryStream, SeekStream, Stream
from dmlc_core_tpu_torch.utils.logging import Error


def values(seed=0):
    """Every kind of value the serializer takes."""
    rng = np.random.default_rng(seed)
    arrays = {str(dt): rng.normal(size=(3, 4)).astype(dt)
              for dt in ("float32", "float64", "float16")}
    arrays["int32"] = rng.integers(-9, 9, (5,)).astype(np.int32)
    arrays["uint8"] = rng.integers(0, 255, (2, 2, 2)).astype(np.uint8)
    arrays["bool"] = rng.random(6) > 0.5
    arrays["scalar"] = np.asarray(np.float32(2.5))  # 0-d stays 0-d
    arrays["empty"] = np.zeros((0, 3), np.float32)
    arrays["strided"] = rng.normal(size=(6, 6)).astype(np.float32)[::2, ::3]
    return [None, True, False, 0, -7, 1 << 62, 1.5, float("inf"), "", "héllo",
            b"", b"\x00\x01", [], (1, "a"), {"k": [1, 2.0]}, np.int64(4),
            np.float32(0.25), arrays, {"nested": {"t": (arrays["int32"], [None])}}]


@pytest.mark.parametrize("case", range(len(values())))
def test_serializer_bytes_match_jax_and_read_back_across(case):
    obj = values()[case]
    port, jax = MemoryStream(), JaxMemoryStream()
    serializer.save(port, obj)
    jax_serializer.save(jax, obj)
    assert port.getvalue() == jax.getvalue()
    want = repr(jax_serializer.load(JaxMemoryStream(jax.getvalue())))
    assert repr(serializer.load(MemoryStream(jax.getvalue()))) == want
    assert repr(jax_serializer.load(JaxMemoryStream(port.getvalue()))) == want


def test_serializer_scalars_and_errors_match_jax():
    for ctype, v in (("int8", -3), ("uint32", 7), ("float64", 0.1), ("bool", True)):
        port, jax = MemoryStream(), JaxMemoryStream()
        serializer.write_scalar(port, v, ctype)
        jax_serializer.write_scalar(jax, v, ctype)
        assert port.getvalue() == jax.getvalue()
        port.seek(0)
        assert serializer.read_scalar(port, ctype) == v
    assert serializer.try_read_scalar(MemoryStream(b""), "uint32") is None
    for bad in (1 << 64, object()):
        with pytest.raises(Error, match="cannot serialize"):
            serializer.save(MemoryStream(), bad)
    with pytest.raises(Error, match="unknown tag"):
        serializer.load(MemoryStream(b"\x63"))
    with pytest.raises(Error, match="expected 8 bytes"):
        serializer.load(MemoryStream(b"\x02\x01"))


def test_file_and_memory_streams_round_trip(tmp_path):
    path = str(tmp_path / "f.bin")
    payload = np.random.default_rng(1).integers(0, 256, 5000, dtype=np.uint8).tobytes()
    with Stream.create(f"file://{path}", "w") as s:
        assert isinstance(s, FileStream)
        s.write(payload)
    with Stream.create(path, "a") as s:
        s.write(b"tail")
    s = SeekStream.create_for_read(path)
    s.seek(4000)
    assert s.tell() == 4000
    assert s.read_exact(1000) == payload[4000:]
    assert s.read() == b"tail"
    with pytest.raises(Error, match="expected 4 bytes"):
        s.read_exact(4)
    s.close()
    with JaxStream.create(path, "r") as j:
        assert j.read() == payload + b"tail"
    m = MemoryStream(b"abc")
    m.seek(1)
    m.write(b"X")
    assert m.getvalue() == b"aXc"
    assert Stream.create(str(tmp_path / "missing"), "r", allow_null=True) is None
    with pytest.raises(OSError):
        Stream.create(str(tmp_path / "missing"), "r")
    with pytest.raises(Error, match="invalid stream mode"):
        Stream.create(path, "rw")
    for uri in ("s3://bucket/key", "mem://x", "gs://b/k"):
        with pytest.raises(Error, match="ROADMAP.md §1 item 8"):
            Stream.create(uri, "r", allow_null=True)


def test_local_filesystem_matches_jax(tmp_path):
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "b.txt").write_bytes(b"12345")
    (tmp_path / "d" / "a.bin").write_bytes(b"")
    (tmp_path / "d" / "sub").mkdir()
    os.symlink(tmp_path / "nowhere", tmp_path / "d" / "dangling")
    fs = FileSystem.get_instance(str(tmp_path))
    assert fs is FileSystem.get_instance("file://" + str(tmp_path))
    assert isinstance(fs, LocalFileSystem)
    jfs = JaxFileSystem.get_instance(str(tmp_path))
    for uri in (str(tmp_path / "d"), "file://" + str(tmp_path / "d")):
        assert [tuple(i) for i in fs.list_directory(uri)] == \
            [tuple(i) for i in jfs.list_directory(uri)]
        assert tuple(fs.get_path_info(uri)) == tuple(jfs.get_path_info(uri))
    info = fs.get_path_info(str(tmp_path / "d" / "b.txt"))
    assert info == FileInfo(str(tmp_path / "d" / "b.txt"), 5, "file")
    assert fs.exists(str(tmp_path / "d")) and not fs.exists(str(tmp_path / "no"))
    fs.copy(str(tmp_path / "d" / "b.txt"), str(tmp_path / "c.txt"))
    fs.rename(str(tmp_path / "c.txt"), str(tmp_path / "e.txt"))
    assert (tmp_path / "e.txt").read_bytes() == b"12345"
    assert not (tmp_path / "c.txt").exists()
    fs.delete(str(tmp_path / "e.txt"))
    fs.delete(str(tmp_path / "d"), recursive=True)
    assert not (tmp_path / "d").exists()
    with pytest.raises(Error, match="ROADMAP.md §1 item 8"):
        FileSystem.get_instance("hdfs://nn/x")


def rows(seed):
    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, 9, 300)
    offset = np.r_[0, np.cumsum(nnz)].astype(np.int64)
    value = rng.normal(size=int(offset[-1])).astype(np.float32)
    value[::13] = np.frombuffer(np.uint32(0xCED7230A).tobytes(), np.float32)[0]
    kw = dict(offset=offset, label=rng.integers(0, 2, 300).astype(np.float32),
              index=rng.integers(0, 1 << 20, int(offset[-1])).astype(np.uint32),
              value=value, weight=rng.uniform(0.5, 2, 300).astype(np.float32))
    return RowBlock(**kw), JaxRowBlock(**kw)


def test_write_rowrec_with_an_index_matches_jax():
    blk, jblk = rows(3)
    data, idx, jdata, jidx = MemoryStream(), MemoryStream(), JaxMemoryStream(), JaxMemoryStream()
    assert write_rowrec(data, [blk, blk], index_stream=idx) == 600
    jax_write_rowrec(jdata, [jblk, jblk], index_stream=jidx)
    assert data.getvalue() == jdata.getvalue()
    assert idx.getvalue() == jidx.getvalue()
    plain = MemoryStream()
    write_rowrec(plain, [blk, blk])
    assert plain.getvalue() == data.getvalue()


def test_indexed_writer_matches_jax_and_refuses_what_it_cannot_index():
    recs = [bytes([i]) * (i % 9) for i in range(40)]
    recs[5] = np.uint32(0xCED7230A).tobytes() * 3  # a multipart chain
    out = []
    for Writer, Mem in ((IndexedRecordIOWriter, MemoryStream),
                        (JaxIndexedWriter, JaxMemoryStream)):
        data, idx = Mem(), Mem()
        w = Writer(data, idx)
        for i, r in enumerate(recs):
            w.write_record(r, key=None if i % 3 else 1000 + i)
        out.append((data.getvalue(), idx.getvalue()))
    assert out[0] == out[1]
    with pytest.raises(Error, match="unknown codec"):
        IndexedRecordIOWriter(MemoryStream(), MemoryStream(), codec="snappy")
    zipped = []
    for Writer, Mem in ((IndexedRecordIOWriter, MemoryStream),
                        (JaxIndexedWriter, JaxMemoryStream)):
        data, idx = Mem(), Mem()
        w = Writer(data, idx, codec="zlib", block_bytes=64)
        for r in recs:
            w.write_record(r)
        w.flush()
        zipped.append((data.getvalue(), idx.getvalue()))
    assert zipped[0] == zipped[1] and b":" in zipped[0][1]
    started = MemoryStream(b"xx")
    started.seek(2)
    with pytest.raises(Error, match="byte 0"):
        IndexedRecordIOWriter(started, MemoryStream())
