"""The port's compressed-block RecordIO against the JAX package's, on the
CPU: the codec registry, the block header and crc, the writers' bytes,
every read path over every codec this host has, the compressed index in
every shuffle mode at 1 and 3 parts, the decoded-block cache, and the
golden artifact ``tests/data/golden_zlib.rec``. The cases of
tests/test_codec.py (without the ``fault://`` and telemetry ones, which
wait for the remote filesystems and the telemetry port) and
tests/test_golden_codec.py run on both packages; files, records and
errors must be identical (bit for bit, no tolerance).
"""

import os
import struct
import threading

import numpy as np
import pytest

from dmlc_core_tpu.data.row_block import RowBlock as JaxRowBlock
from dmlc_core_tpu.data.rowrec import write_rowrec as jax_write_rowrec
from dmlc_core_tpu.io import codec as jax_codec
from dmlc_core_tpu.io import recordio as jax_recordio
from dmlc_core_tpu.io import split as jax_split
from dmlc_core_tpu.io.stream import FileStream as JaxFileStream
from dmlc_core_tpu.utils.logging import Error as JaxError
from dmlc_core_tpu_torch.data import create_parser
from dmlc_core_tpu_torch.data.row_block import RowBlock
from dmlc_core_tpu_torch.data.rowrec import write_rowrec
from dmlc_core_tpu_torch.io import codec
from dmlc_core_tpu_torch.io import split as io_split
from dmlc_core_tpu_torch.io.codec import (
    BLOCK_HEADER,
    DecodeContext,
    DecodedBlockCache,
    available_codecs,
    crc32,
    decode_block,
    encode_block,
    get_codec,
)
from dmlc_core_tpu_torch.io.recordio import (
    CFLAG_COMPRESSED,
    KMAGIC,
    IndexedRecordIOWriter,
    RecordIOChunkReader,
    RecordIOReader,
    RecordIOWriter,
    chunk_has_compressed,
    decode_chunk,
    decode_flag,
    decode_length,
    scan_compressed_blob,
)
from dmlc_core_tpu_torch.io.stream import FileStream, MemoryStream
from dmlc_core_tpu_torch.utils.logging import Error

MAGIC = struct.pack("<I", KMAGIC)
# every codec this host decodes: raw, zlib and gzip always, zstd and lz4
# when their packages are installed
CODECS = available_codecs()
SHUFFLES = ("0", "record", "batch", "window", "legacy")
GOLDEN_REC = os.path.join(os.path.dirname(__file__), "data", "golden_zlib.rec")
GOLDEN_IDX = GOLDEN_REC + ".idx"
# the threads this slice starts; none may outlive a test
THREADS = ("codec-decode", "split-prefetch", "split-cache", "split-window-readahead",
           "fused-shard")


@pytest.fixture(autouse=True)
def no_thread_left_behind():
    yield
    codec.shutdown_decode_pool()
    if jax_codec._POOL is not None:  # the reference's pool shares the name
        jax_codec._POOL.shutdown(wait=True)
        jax_codec._POOL = None
    left = [t for t in threading.enumerate() if t.name.startswith(THREADS)]
    for t in left:
        t.join(timeout=5.0)
    assert not [t.name for t in left if t.is_alive()]


def records_of(n=300, seed=0):
    """Mixed-size records, about one in 9 holding an aligned magic word
    (a multipart chain inside a block), one with it at offset 0, one
    empty (tests/test_codec.py's set)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        body = bytearray(rng.bytes(16 + (i * 7) % 53))
        if i % 9 == 0:
            body[4:8] = MAGIC
        if i % 31 == 0:
            body[0:4] = MAGIC
        out.append(bytes(body) + str(i).encode())
    out[0] = b""
    return out


RECORDS = records_of()


def write(tmp_path, codec_name, records=RECORDS, block_bytes=768, name=None, jax=False):
    """An indexed RecordIO file (and its index) written by the port's
    writer, or by the JAX package's with ``jax``; returns the paths."""
    rec = str(tmp_path / (name or f"{'j' if jax else 'p'}_{codec_name or 'v1'}.rec"))
    idx = rec + ".idx"
    Stream, Writer = ((JaxFileStream, jax_recordio.IndexedRecordIOWriter) if jax
                      else (FileStream, IndexedRecordIOWriter))
    with Stream(rec, "w") as f, Stream(idx, "w") as fi:
        w = Writer(f, fi, codec=codec_name, block_bytes=block_bytes)
        for r in records:
            w.write_record(r)
        w.flush()
    return rec, idx


def drain(s, epochs=1):
    out = []
    try:
        for e in range(epochs):
            if e:
                s.before_first()
            while (rec := s.next_record()) is not None:
                out.append(bytes(rec))
    finally:
        s.close()
    return out


def both(uri, part=0, parts=1, epochs=1, kind="recordio"):
    """(port records, JAX records) of one part of ``uri``."""
    return (drain(io_split.create(uri, part, parts, type=kind), epochs),
            drain(jax_split.create(uri, part, parts, type=kind, threaded=False), epochs))


# -- registry ----------------------------------------------------------------
def test_registry_stdlib_codecs_always_available():
    assert CODECS == jax_codec.available_codecs()
    assert {"raw", "zlib", "gzip"} <= set(CODECS)
    for name in CODECS:
        c = get_codec(name)
        assert get_codec(c.codec_id) is c and get_codec(c) is c
        assert (c.codec_id, c.default_level) == (jax_codec.get_codec(name).codec_id,
                                                 jax_codec.get_codec(name).default_level)


def test_registry_unknown_and_unavailable_fail_loudly():
    for bad in ("snappy", 250):
        with pytest.raises(Error) as e:
            get_codec(bad)
        with pytest.raises(JaxError) as je:
            jax_codec.get_codec(bad)
        assert str(e.value) == str(je.value)
    for name in ("zstd", "lz4"):
        if name not in CODECS:
            with pytest.raises(Error, match="unavailable") as e:
                get_codec(name)
            with pytest.raises(JaxError) as je:
                jax_codec.get_codec(name)
            assert str(e.value) == str(je.value)


@pytest.mark.parametrize("name", CODECS)
def test_codec_compress_roundtrip_and_levels(name):
    c, jc = get_codec(name), jax_codec.get_codec(name)
    data = b"abc" * 5000 + np.random.default_rng(1).bytes(256)
    assert c.compress(data) == jc.compress(data)
    assert c.decompress(jc.compress(data), len(data)) == data
    if c.default_level is not None:
        for level in {c.default_level, 1}:
            small = c.compress(data, level)
            assert small == jc.compress(data, level)
            assert jc.decompress(small, len(data)) == data


@pytest.mark.parametrize("name", CODECS)
def test_codec_streaming_matches_whole_buffer(name):
    c, jc = get_codec(name), jax_codec.get_codec(name)
    chunks = [np.random.default_rng(2).bytes(100), b"x" * 4096, b"", b"tail"]
    whole = b"".join(chunks)
    streamed = b"".join(c.compress_stream(iter(chunks)))
    assert streamed == b"".join(jc.compress_stream(iter(chunks)))
    assert b"".join(c.decompress_stream([streamed])) == whole
    halves = [streamed[: len(streamed) // 2], streamed[len(streamed) // 2:]]
    assert b"".join(c.decompress_stream(halves)) == whole


# -- block header / crc ------------------------------------------------------
def test_block_header_roundtrip_and_corruption():
    raw = b"payload" * 100
    blob = encode_block(raw, 7, "zlib")
    assert blob == jax_codec.encode_block(raw, 7, "zlib")
    assert decode_block(blob) == (raw, 7)
    bad_payload = bytearray(blob)
    bad_payload[-3] ^= 0xFF
    bad_crc = bytearray(blob)
    bad_crc[12] ^= 0xFF  # the crc32 field of the 16-byte header
    for bad, match in ((bytes(bad_payload), None), (bytes(bad_crc), "crc"),
                       (blob[:10], "shorter"), (bytes([blob[0], 99]) + blob[2:], "version")):
        with pytest.raises(Error, match=match) as e:
            decode_block(bad)
        with pytest.raises(JaxError) as je:
            jax_codec.decode_block(bad)
        assert str(e.value) == str(je.value)


def test_truncated_block_detected():
    raw = np.random.default_rng(3).bytes(4096)
    blob = encode_block(raw, 1, "raw")
    with pytest.raises(Error, match="truncated or corrupt"):
        decode_block(blob[:-100])


# -- writers and every read path ----------------------------------------------
@pytest.mark.parametrize("name", CODECS)
def test_plain_container_all_read_paths(name, tmp_path):
    rec, idx = write(tmp_path, name)
    jrec, jidx = write(tmp_path, name, jax=True)
    data = open(rec, "rb").read()
    assert data == open(jrec, "rb").read()
    assert open(idx, "rb").read() == open(jidx, "rb").read()
    with FileStream(jrec, "r") as f:
        assert list(RecordIOReader(f)) == RECORDS
    with JaxFileStream(rec, "r") as f:
        assert list(jax_recordio.RecordIOReader(f)) == RECORDS
    assert chunk_has_compressed(data)
    dec = decode_chunk(data)
    assert dec == jax_recordio.decode_chunk(data)
    for nparts in (1, 2, 3, 7):
        got = []
        for p in range(nparts):
            got.extend(bytes(r) for r in RecordIOChunkReader(dec, p, nparts))
        assert got == RECORDS, nparts
    for nparts in (1, 3):
        got, want = [], []
        for p in range(nparts):
            sp = io_split.create(rec, p, nparts, type="recordio", threaded=False)
            jsp = jax_split.create(rec, p, nparts, type="recordio", threaded=False)
            sp.hint_chunk_size(512)  # many small chunks
            jsp.hint_chunk_size(512)
            got += drain(sp)
            want += drain(jsp)
        assert got == want and sorted(got) == sorted(RECORDS), nparts


def test_rowrec_writer_and_parser_over_codec(tmp_path):
    rng = np.random.default_rng(1)
    n, k = 64, 3
    fields = dict(offset=np.arange(n + 1, dtype=np.int64) * k,
                  label=rng.integers(0, 2, n).astype(np.float32),
                  index=rng.integers(0, 100, n * k).astype(np.uint32),
                  value=rng.normal(size=n * k).astype(np.float32))
    for name in ("zlib", "gzip"):
        port, jax = MemoryStream(), MemoryStream()
        assert write_rowrec(port, [RowBlock(**fields)], codec=name) == n
        jax_write_rowrec(jax, [JaxRowBlock(**fields)], codec=name)
        assert port.getvalue() == jax.getvalue()
        rec = tmp_path / f"rows_{name}.rec"
        rec.write_bytes(port.getvalue())
        blocks = list(create_parser(f"{rec}?format=rowrec"))
        assert np.concatenate([b.label for b in blocks]).tolist() == fields["label"].tolist()
        np.testing.assert_array_equal(np.concatenate([b.value for b in blocks]),
                                      fields["value"])


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("shuffle", SHUFFLES)
def test_indexed_container_all_modes_sharded(name, shuffle, tmp_path):
    """Record order in every shuffle mode over a compressed index equals
    the JAX package's at 1 and 3 parts, and the uncompressed file's (an
    indexed read shards by record count), over two epochs."""
    rec, idx = write(tmp_path, name)
    v1, v1idx = write(tmp_path, None)
    q = {"legacy": "&shuffle=record&legacy_shuffle=1"}.get(shuffle, f"&shuffle={shuffle}")
    q += "&seed=5&window=64&merge_gap=96&batch_size=32"
    for nparts in (1, 3):
        seen = []
        for p in range(nparts):
            got, want = both(f"{rec}?index={idx}{q}", p, nparts, epochs=2)
            plain, _ = both(f"{v1}?index={v1idx}{q}", p, nparts, epochs=2)
            assert got == want == plain
            seen += got
        assert sorted(seen) == sorted(RECORDS * 2)


def test_window_order_identical_to_uncompressed_record_shuffle(tmp_path):
    v1, v1idx = write(tmp_path, None)
    rec, idx = write(tmp_path, "zlib")
    want, _ = both(f"{v1}?index={v1idx}&shuffle=record&seed=11&window=64")
    for mode in ("window", "record"):
        got, jgot = both(f"{rec}?index={idx}&shuffle={mode}&seed=11&window=64")
        assert got == jgot == want


def test_uncompressed_files_read_bit_identically(tmp_path):
    rec, idx = write(tmp_path, None)
    data = open(rec, "rb").read()
    assert not chunk_has_compressed(data)
    assert decode_chunk(data) is data
    assert ":" not in open(idx).read()
    with FileStream(rec, "r") as f:
        assert list(RecordIOReader(f, allow_compressed=False)) == RECORDS


def test_gather_views_over_compressed_windows_frame_the_records(tmp_path):
    """``next_gather_batch`` over decoded blocks hands the records the
    JAX package's copies out, with no copy counted."""
    rec, idx = write(tmp_path, "zlib")
    uri = f"{rec}?index={idx}&shuffle=batch&batch_size=16&window=48&seed=2"
    s = io_split.create(uri, type="recordio")
    got = []
    try:
        while (g := s.next_gather_batch(20)) is not None:
            buf, starts, sizes = g
            got += [bytes(buf[a:a + n]) for a, n in zip(starts, sizes)]
        stats = s.io_stats()
    finally:
        s.close()
    want = drain(jax_split.create(uri, type="recordio", threaded=False))
    assert [bytes(r) for r in RecordIOChunkReader(b"".join(got))] == want
    assert stats["gather_batches"] > 0 and stats["gather_fallback_batches"] == 0
    assert stats["decode_cache_misses"] + stats["decode_cache_hits"] > 0


# -- loud failures ------------------------------------------------------------
def test_v1_only_readers_reject_compressed_blocks(tmp_path):
    rec, idx = write(tmp_path, "zlib")
    data = open(rec, "rb").read()
    with FileStream(rec, "r") as f:
        with pytest.raises(Error, match="v1-only"):
            RecordIOReader(f, allow_compressed=False).next_record()
    with pytest.raises(Error, match="decode_chunk"):
        RecordIOChunkReader(data).next_record()
    with pytest.raises(ValueError):
        [int(tok) for tok in open(idx).read().split()]


def test_compressed_index_requires_consistency(tmp_path):
    rec, idx = write(tmp_path, "zlib")
    broken = str(tmp_path / "mixed.idx")
    lines = open(idx).read().splitlines()
    lines[1] = "1\t64"  # a v1 offset amid block:in pairs
    open(broken, "w").write("\n".join(lines) + "\n")
    with pytest.raises(Error, match="mixes") as e:
        io_split.create(f"{rec}?index={broken}", type="recordio")
    with pytest.raises(JaxError) as je:
        jax_split.create(f"{rec}?index={broken}", type="recordio", threaded=False)
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_corrupt_block_surfaces_checked_error(tmp_path, damage):
    rec, idx = write(tmp_path, "zlib")
    blob = bytearray(open(rec, "rb").read())
    if damage == "flip":
        blob[len(blob) // 2] ^= 0xFF  # inside some block's compressed bytes
    else:
        blob = blob[:len(blob) // 2 + 2]
    bad = str(tmp_path / "bad.rec")
    open(bad, "wb").write(bytes(blob))
    for uri in (bad, f"{bad}?index={idx}", f"{bad}?index={idx}&shuffle=window&window=64"):
        if damage == "truncate" and "index" in uri:
            continue  # the index names bytes past the end: the block read fails
        with pytest.raises(Error):
            drain(io_split.create(uri, type="recordio"))
        with pytest.raises(JaxError):
            drain(jax_split.create(uri, type="recordio", threaded=False))


def test_decode_context_has_no_shared_tier():
    with pytest.raises(Error, match="not ported"):
        DecodeContext(shared=object())
    ctx = DecodeContext(cache=DecodedBlockCache(1 << 20))
    blob = encode_block(b"r" * 100, 1, "gzip")
    assert ctx.decode_blocks([blob, blob]) == [(b"r" * 100, 1)] * 2
    assert ctx.submit_decode(blob).result(timeout=30) == (b"r" * 100, 1)


# -- the decoded-block cache ----------------------------------------------------
def test_decoded_block_cache_lru_bounds():
    for Cache in (DecodedBlockCache, jax_codec.DecodedBlockCache):
        c = Cache(100)
        c.put("a", b"x" * 40)
        c.put("b", b"y" * 40)
        assert c.get("a") == b"x" * 40
        c.put("c", b"z" * 40)  # evicts the least recent, "b"
        assert c.get("b") is None and c.get("a") is not None
        assert c.nbytes <= 100
        c.put("big", b"q" * 101)  # larger than the budget: not kept
        assert c.get("big") is None
        assert (c.hits, c.misses) == (2, 2)
        c.clear()
        assert len(c) == 0 and c.nbytes == 0


def test_second_epoch_serves_from_cache(tmp_path):
    rec, idx = write(tmp_path, "zlib")
    codec.default_decode_cache().clear()
    sp = io_split.create(f"{rec}?index={idx}&shuffle=window&seed=4&window=64",
                         type="recordio")
    try:
        e1 = []
        while (r := sp.next_record()) is not None:
            e1.append(r)
        h1, m1 = sp.decode_cache_hits, sp.decode_cache_misses
        assert m1 > 0
        sp.before_first()
        e2 = []
        while (r := sp.next_record()) is not None:
            e2.append(r)
        h2, m2 = sp.decode_cache_hits - h1, sp.decode_cache_misses - m1
        st = sp.io_stats()
    finally:
        sp.close()
    assert sorted(e1) == sorted(e2) == sorted(RECORDS)
    assert h2 / max(h2 + m2, 1) > 0.9
    assert (st["decode_cache_hits"], st["decode_cache_misses"]) == (
        sp.decode_cache_hits, sp.decode_cache_misses)


def test_rewritten_file_is_not_served_from_stale_blocks(tmp_path):
    """A file rewritten in place with the same block layout (the raw
    codec, records of the same lengths) reads its new records: the cache
    key holds the file's mtime."""
    old = [bytes([i % 251]) * 24 for i in range(200)]
    new = [bytes([(i + 7) % 251]) * 24 for i in range(200)]
    rec, idx = write(tmp_path, "raw", old, name="same.rec")
    uri = f"{rec}?index={idx}&shuffle=window&window=50&seed=1"
    first = drain(io_split.create(uri, type="recordio"))
    layout = open(idx).read()
    st = os.stat(rec)
    write(tmp_path, "raw", new, name="same.rec")
    os.utime(rec, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert open(idx).read() == layout
    second = drain(io_split.create(uri, type="recordio"))
    assert sorted(first) == sorted(old) and sorted(second) == sorted(new)


def test_skip_records_window_boundary_compressed(tmp_path):
    rec, idx = write(tmp_path, "zlib")
    base = f"{rec}?index={idx}&shuffle=window&seed=6&window=50"
    want, _ = both(base)
    got, jgot = both(f"{base}&skip_records=100")
    assert got == jgot == want[100:]
    with pytest.raises(Error, match="window boundaries"):
        io_split.create(f"{base}&skip_records=101", type="recordio")


# -- the golden artifact ------------------------------------------------------
def golden_records():
    """The records the artifact was built from (seed 20260803; magic
    collisions every 7th record, one empty): tests/test_golden_codec.py."""
    rng = np.random.default_rng(20260803)
    out = []
    for i in range(40):
        body = bytearray(rng.bytes(24 + (i * 5) % 41))
        if i % 7 == 0:
            body[8:12] = MAGIC
        out.append(bytes(body) + b"#%d" % i)
    out[3] = b""
    return out


def test_golden_artifact_present_and_nonempty():
    assert os.path.getsize(GOLDEN_REC) > 0 and os.path.getsize(GOLDEN_IDX) > 0


def test_golden_decode_byte_exact():
    with FileStream(GOLDEN_REC, "r") as f:
        assert list(RecordIOReader(f)) == golden_records()


def test_golden_frame_and_block_header_layout():
    raw = open(GOLDEN_REC, "rb").read()
    magic, lrec = struct.unpack("<II", raw[:8])
    assert magic == KMAGIC
    cflag = decode_flag(lrec)
    assert cflag & CFLAG_COMPRESSED and (cflag & 3) <= 1
    assert decode_length(lrec) <= len(raw) - 8
    blob, end = scan_compressed_blob(memoryview(raw), 0)
    assert (blob, end) == jax_recordio.scan_compressed_blob(memoryview(raw), 0)
    codec_id, version, reserved, n_records, raw_len, want_crc = BLOCK_HEADER.unpack_from(blob)
    assert (codec_id, version, reserved) == (1, 1, 0)
    decoded, n = decode_block(blob)
    assert n == n_records > 0 and len(decoded) == raw_len > 0
    assert crc32(decoded) == want_crc


def test_golden_index_sidecar_block_semantics():
    lines = open(GOLDEN_IDX).read().splitlines()
    assert len(lines) == 40
    raw = open(GOLDEN_REC, "rb").read()
    for i, line in enumerate(lines):
        key, _, off = line.partition("\t")
        assert int(key) == i
        b, o = (int(x) for x in off.split(":"))
        assert 0 <= b < len(raw) and o >= 0
        fmagic, flrec = struct.unpack("<II", raw[b:b + 8])
        assert fmagic == KMAGIC and decode_flag(flrec) & CFLAG_COMPRESSED


@pytest.mark.parametrize("shuffle", ("0", "record", "window"))
def test_golden_reads_through_indexed_splitter(shuffle):
    got, want = both(f"{GOLDEN_REC}?index={GOLDEN_IDX}&shuffle={shuffle}&seed=1&window=16")
    assert got == want and sorted(got) == sorted(golden_records())


def test_golden_records_rewrite_to_the_same_bytes(tmp_path):
    """The port's writer, given the golden records, writes a file that
    both packages read back as those records (the encode side is not
    pinned to the artifact: deflate output may differ across zlib
    builds)."""
    recs = golden_records()
    out = MemoryStream()
    w = RecordIOWriter(out, codec="zlib", block_bytes=512)
    for r in recs:
        w.write_record(r)
    w.close()
    path = tmp_path / "again.rec"
    path.write_bytes(out.getvalue())
    with JaxFileStream(str(path), "r") as f:
        assert list(jax_recordio.RecordIOReader(f)) == recs
