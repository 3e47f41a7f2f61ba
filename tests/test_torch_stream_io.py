"""The port's stream adapters and the rest of its ``io`` surface against the
JAX package's, on the CPU: ``StreamIO`` (reads, writes, seeks and the io
protocol's errors), ``wrap_text`` over ``mem://``, ``Serializable``,
``TemporaryDirectory``, ``tell()`` on both RecordIO writers,
``DecodeContext.decode_block`` and the ``io`` package's re-exports. Bytes
are compared exactly."""

import csv
import io as pyio
import os

import numpy as np
import pytest

import dmlc_core_tpu.io as jax_io
from dmlc_core_tpu.io import codec as jax_codec
from dmlc_core_tpu.io import recordio as jax_recordio
import dmlc_core_tpu_torch.io as port_io
from dmlc_core_tpu_torch.io import codec, recordio
from dmlc_core_tpu_torch.io.stream import MemoryStream, Stream
from dmlc_core_tpu_torch.utils.logging import Error

BOTH = (port_io, jax_io)


def payload(seed: int, n: int = 5000) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("chunk", [1, 7, 64, 4096])
def test_buffered_reads_through_streamio_equal_jax(chunk):
    data = payload(1)
    got = []
    for mod in BOTH:
        raw = mod.StreamIO(mod.MemoryStream(data), mode="r")
        assert (raw.readable(), raw.writable(), raw.seekable()) == (True, False, True)
        reader = pyio.BufferedReader(raw, buffer_size=max(chunk, 8))
        parts = list(iter(lambda: reader.read(chunk), b""))
        got.append(parts)
    assert got[0] == got[1]
    assert b"".join(got[0]) == data


def test_readinto_and_readline_as_jax():
    for mod in BOTH:
        raw = mod.StreamIO(mod.MemoryStream(b"hello world, " * 10))
        buf = bytearray(5)
        assert raw.readinto(buf) == 5 and bytes(buf) == b"hello"
        reader = pyio.BufferedReader(mod.StreamIO(mod.MemoryStream(b"abc\ndef\n")))
        assert reader.readline() == b"abc\n"
        assert reader.read() == b"def\n"


def test_writes_and_seeks_as_jax():
    data = payload(2, 3000)
    out = []
    for mod in BOTH:
        s = mod.MemoryStream()
        with pyio.BufferedWriter(mod.StreamIO(s, mode="w"), buffer_size=256) as w:
            for i in range(0, len(data), 97):
                w.write(data[i:i + 97])
        out.append(s.getvalue())
        rw = mod.StreamIO(mod.MemoryStream(b"0123456789"), mode="rw")
        assert rw.seek(4) == 4 and rw.read(2) == b"45"
        assert rw.seek(-2, 1) == 4 and rw.tell() == 4
    assert out[0] == out[1] == data


def errors(mod):
    """(exception type, text) of every refused operation, in order."""
    out = []
    cases = [
        lambda: mod.StreamIO(mod.MemoryStream(b"x"), mode="r").write(b"y"),
        lambda: mod.StreamIO(mod.MemoryStream(b"x"), mode="w").readinto(bytearray(1)),
        lambda: mod.StreamIO(mod.MemoryStream(b"0123"), mode="rw").seek(0, 2),
        lambda: mod.StreamIO(Unseekable(), mode="r").seek(0),
        lambda: mod.StreamIO(Unseekable(), mode="r").tell(),
        lambda: mod.StreamIO(mod.MemoryStream(b""), mode="a"),
    ]
    for case in cases:
        try:
            case()
        except Exception as e:  # compared across the packages below
            out.append((type(e).__name__, str(e), isinstance(e, OSError)))
        else:
            out.append(None)
    return out


class Unseekable:
    """A Stream that is not a SeekStream (both packages' Stream duck type)."""

    def read(self, n=-1):
        return b""

    def write(self, data):
        return len(data)

    def flush(self):
        pass

    def close(self):
        pass


def test_refusals_raise_the_jax_io_errors():
    port, jax = errors(port_io), errors(jax_io)
    assert port == jax
    assert [e[2] for e in port[:5]] == [True] * 5  # io.UnsupportedOperation / OSError
    assert port[5][0] == "Error"


def test_close_stream_ownership_as_jax():
    for mod in BOTH:
        closed = []

        class Tracked(mod.MemoryStream):
            def close(self):
                closed.append(1)
                super().close()

        s = Tracked(b"x")
        mod.StreamIO(s).close()
        assert closed == []
        mod.StreamIO(s, close_stream=True).close()
        assert closed == [1]


def test_wrap_text_csv_over_mem_uri_across_packages():
    """Rows written through the port's ``wrap_text`` read back through the
    JAX package's, and the other way round, over each one's ``mem://``."""
    rng = np.random.default_rng(4)
    rows = [[f"r{i}", str(int(rng.integers(1000))), f"{rng.normal():.6g}"]
            for i in range(200)]
    for writer, reader in ((port_io, jax_io), (jax_io, port_io)):
        writer.MemoryFileSystem.reset()
        reader.MemoryFileSystem.reset()
        with writer.wrap_text(writer.Stream.create("mem://t/rows.csv", "w"), "w",
                              newline="") as f:
            csv.writer(f).writerows(rows)
        blob = writer.Stream.create("mem://t/rows.csv", "r").read()
        with reader.Stream.create("mem://t/rows.csv", "w") as s:
            s.write(blob)
        with reader.wrap_text(reader.Stream.create("mem://t/rows.csv", "r"),
                              newline="") as f:
            assert list(csv.reader(f)) == rows
    port_io.MemoryFileSystem.reset()
    jax_io.MemoryFileSystem.reset()


def test_wrap_text_rw_and_numpy_through_streamio():
    arr = np.random.default_rng(5).normal(size=(7, 3)).astype(np.float32)
    blobs = []
    for mod in BOTH:
        s = mod.MemoryStream()
        with pyio.BufferedWriter(mod.StreamIO(s, mode="w")) as w:
            np.save(w, arr)
        blobs.append(s.getvalue())
        back = np.load(pyio.BufferedReader(mod.StreamIO(mod.MemoryStream(blobs[-1]))))
        np.testing.assert_array_equal(back, arr)
        t = mod.wrap_text(mod.MemoryStream(b"line one\nline two\n"), "rw")
        assert t.readline() == "line one\n"
        t.close()
    assert blobs[0] == blobs[1]


def test_serializable_round_trip_across_packages():
    class Pair(port_io.Serializable):
        def __init__(self, a=0, b=b""):
            self.a, self.b = a, b

        def save(self, stream):
            port_io.serializer.write_scalar(stream, self.a, "int64")
            port_io.serializer.write_bytes(stream, self.b)

        def load(self, stream):
            self.a = port_io.serializer.read_scalar(stream, "int64")
            self.b = port_io.serializer.read_bytes(stream)

    s = MemoryStream()
    Pair(-7, payload(6, 33)).save(s)
    s.seek(0)
    back = Pair()
    back.load(s)
    assert (back.a, back.b) == (-7, payload(6, 33))
    j = jax_io.MemoryStream(s.getvalue())
    assert jax_io.serializer.read_scalar(j, "int64") == -7
    assert jax_io.serializer.read_bytes(j) == payload(6, 33)
    for mod in BOTH:
        with pytest.raises(NotImplementedError):
            mod.Serializable().save(mod.MemoryStream())


def test_temporary_directory_as_jax():
    for mod in BOTH:
        with mod.TemporaryDirectory(prefix="dmlctest") as tmp:
            path = tmp.path
            assert os.path.basename(path).startswith("dmlctest")
            os.makedirs(os.path.join(path, "a", "b"))
            with open(os.path.join(path, "a", "b", "f"), "wb") as f:
                f.write(b"x")
        assert not os.path.exists(path) and tmp.path == ""
        tmp.cleanup()  # a second cleanup is a no-op
        kept = mod.TemporaryDirectory()
        path = kept.path
        del kept
        assert not os.path.exists(path)


@pytest.mark.parametrize("codec_name", [None, "zlib"])
@pytest.mark.parametrize("indexed", [False, True])
def test_writer_tell_equals_jax(tmp_path, codec_name, indexed):
    rng = np.random.default_rng(7)
    records = [payload(int(rng.integers(1 << 20)), int(rng.integers(1, 300)))
               for _ in range(60)]
    records.append(np.uint32(0xCED7230A).tobytes() * 5)  # magic in the payload
    tells = []
    for mod in (recordio, jax_recordio):
        stream_mod = port_io if mod is recordio else jax_io
        out = stream_mod.MemoryStream()
        idx = stream_mod.MemoryStream()
        w = (mod.IndexedRecordIOWriter(out, idx, codec=codec_name, block_bytes=1024)
             if indexed else mod.RecordIOWriter(out, codec=codec_name, block_bytes=1024))
        seq = []
        for rec in records:
            w.write_record(rec)
            seq.append(w.tell())
        w.flush_block()
        seq.append(w.tell())
        tells.append((seq, out.getvalue(), idx.getvalue()))
    assert tells[0] == tells[1]
    assert tells[0][0][-1] == len(tells[0][1])


def test_writer_tell_refuses_a_stream_without_seek_as_jax():
    texts = []
    for mod in (recordio, jax_recordio):
        w = mod.RecordIOWriter(Unseekable())
        w.write_record(b"abc")
        with pytest.raises(Exception) as info:
            w.tell()
        texts.append(str(info.value))
    assert texts[0] == texts[1]
    with pytest.raises(Error):
        recordio.RecordIOWriter(Unseekable()).tell()


@pytest.mark.parametrize("name", ["zlib", "gzip", "raw"])
def test_decode_context_decode_block_equals_jax(name):
    raw = b"".join(payload(i, 700) for i in range(20))
    blob = codec.encode_block(raw, 20, name)
    assert blob == jax_codec.encode_block(raw, 20, name)
    got = codec.default_decode_context().decode_block(blob)
    assert got == codec.decode_block(blob) == (raw, 20)
    assert got == jax_codec.default_decode_context().decode_block(blob)


def test_io_package_reexports_the_jax_names():
    names = [n for n in dir(jax_io) if not n.startswith("_")]
    missing = [n for n in names if not hasattr(port_io, n)]
    assert missing == []
    assert (port_io.KMAGIC, port_io.CFLAG_COMPRESSED) == (jax_io.KMAGIC,
                                                          jax_io.CFLAG_COMPRESSED)
    assert port_io.create_input_split is port_io.split.create
    assert issubclass(port_io.FileStream, Stream)
