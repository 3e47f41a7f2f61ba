"""The port's remote filesystems (dmlc_core_tpu_torch/io/cloudfs.py)
against the JAX package's, on the CPU, over the fake servers of
tests/test_cloudfs.py on the loopback: a Range-serving HTTP server, an S3
that checks every SigV4 signature with the JAX package's signer, a GCS
that takes bearer tokens only, a GCE metadata server, an OAuth token
endpoint and a WebHDFS namenode.

The first half holds a port case for each case of tests/test_cloudfs.py;
the second half puts both packages on the same store: equal signatures,
objects (multipart included) and checkpoints written by one package and
read by the other, equal split records per part over ``http://`` and
``s3://``, equal ``reopens`` for one seek pattern, and the FM trained from
``s3://`` against the JAX FM on the local file.

Every server is stopped and its thread joined with a timeout, and an
autouse fixture points every endpoint at a closed loopback port, so that
no request can leave the host.
"""

import json
import os
import time
import urllib.parse
from datetime import datetime, timezone

import numpy as np
import pytest
import torch

from dmlc_core_tpu import checkpoint as jax_ckpt
from dmlc_core_tpu.io import cloudfs as jax_cloudfs
from dmlc_core_tpu.io import split as jax_split
from dmlc_core_tpu.io.filesystem import FileSystem as JaxFileSystem
from dmlc_core_tpu.io.stream import Stream as JaxStream
from dmlc_core_tpu_torch import checkpoint
from dmlc_core_tpu_torch.io import cloudfs, retry, spanfetch
from dmlc_core_tpu_torch.io import split as io_split
from dmlc_core_tpu_torch.io.cloudfs import (
    GCSFileSystem,
    HttpReadStream,
    MetadataServerToken,
    SigV4Signer,
    WebHdfsFileSystem,
)
from dmlc_core_tpu_torch.io.filesystem import FileSystem
from dmlc_core_tpu_torch.io.retry import HttpError
from dmlc_core_tpu_torch.io.stream import Stream
from test_cloudfs import (
    FakeGcsBearerHandler,
    FakeMetadataHandler,
    FakeS3Handler,
    FakeTokenEndpointHandler,
    FakeWebHdfsHandler,
    RangeFileHandler,
    _Server,
)
from test_split_gather import make_indexed_rec, records_of

# an endpoint nobody listens on: a request a test forgot to point at a
# fake is refused on the loopback instead of leaving the host
_DEAD = "127.0.0.1:9"
_CRED_VARS = ("GS_ACCESS_KEY_ID", "GS_SECRET_ACCESS_KEY", "AWS_ACCESS_KEY_ID",
              "AWS_SECRET_ACCESS_KEY", "S3_ACCESS_KEY", "S3_SECRET_KEY",
              "AWS_SESSION_TOKEN", "GOOGLE_APPLICATION_CREDENTIALS")


def reset_both():
    cloudfs.reset_singletons()
    jax_cloudfs.reset_singletons()


@pytest.fixture(autouse=True)
def _loopback_only(monkeypatch):
    for var in _CRED_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("S3_ENDPOINT", f"http://{_DEAD}")
    monkeypatch.setenv("GCS_ENDPOINT", f"http://{_DEAD}")
    monkeypatch.setenv("GCE_METADATA_HOST", _DEAD)
    monkeypatch.setenv("AZURE_ENDPOINT", f"http://{_DEAD}")
    monkeypatch.setenv("DMLC_WEBHDFS_PORT", "9")
    # retry backoff at test speed (policies read the env when built)
    monkeypatch.setenv("DMLC_RETRY_BASE_SECS", "0.001")
    monkeypatch.setenv("DMLC_RETRY_CAP_SECS", "0.01")
    reset_both()
    yield
    reset_both()


class Served:
    """One fake server of tests/test_cloudfs.py on the loopback."""

    def __init__(self, handler) -> None:
        self._srv = _Server(handler)
        self.port = self._srv.port
        self.url = self._srv.url

    def stop(self) -> None:
        self._srv.stop()
        self._srv.thread.join(10)
        assert not self._srv.thread.is_alive(), "fake server thread did not stop"


def start_s3(monkeypatch) -> Served:
    """The fake S3 with its store emptied, both packages pointed at it."""
    FakeS3Handler.STORE = {}
    FakeS3Handler.UPLOADS = {}
    FakeS3Handler.SAW_AUTH = []
    FakeS3Handler.FAIL_GET = 0
    FakeS3Handler.FAIL_PART_PUT = 0
    FakeS3Handler.BATCH_DELETES = 0
    srv = Served(FakeS3Handler)
    monkeypatch.setenv("S3_ENDPOINT", srv.url)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", FakeS3Handler.ACCESS)
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", FakeS3Handler.SECRET)
    monkeypatch.setenv("AWS_REGION", FakeS3Handler.REGION)
    reset_both()
    return srv


@pytest.fixture
def s3(monkeypatch):
    srv = start_s3(monkeypatch)
    yield srv
    reset_both()
    srv.stop()


@pytest.fixture
def http_server():
    RangeFileHandler.FILES = {
        "/f.txt": b"0123456789" * 100,
        "/data.libsvm": b"".join(b"%d 0:1 1:2\n" % (i,) for i in range(50)),
    }
    srv = Served(RangeFileHandler)
    yield srv
    srv.stop()


@pytest.fixture
def gcs_adc(monkeypatch):
    """Fake metadata server + bearer-only GCS endpoint; no HMAC keys."""
    FakeMetadataHandler.CALLS = 0
    FakeMetadataHandler.EXPIRES_IN = 3600
    FakeGcsBearerHandler.STORE = {}
    FakeGcsBearerHandler.SAW_AUTH = []
    FakeGcsBearerHandler.ALLOW_ANON = False
    meta, gcs = Served(FakeMetadataHandler), Served(FakeGcsBearerHandler)
    monkeypatch.setenv("GCE_METADATA_HOST", f"127.0.0.1:{meta.port}")
    monkeypatch.setenv("GCS_ENDPOINT", gcs.url)
    reset_both()
    yield meta, gcs
    reset_both()
    meta.stop()
    gcs.stop()


@pytest.fixture
def webhdfs(monkeypatch):
    FakeWebHdfsHandler.FILES = {"/data/a.txt": b"alpha\nbeta\ngamma\n"}
    srv = Served(FakeWebHdfsHandler)
    monkeypatch.setenv("DMLC_WEBHDFS_PORT", str(srv.port))
    reset_both()
    yield srv
    reset_both()
    srv.stop()


def drain_records(split):
    out = []
    while (rec := split.next_record()) is not None:
        out.append(bytes(rec))
    split.close()
    return out


# -- the cases of tests/test_cloudfs.py on the port ------------------------------


def test_http_read_and_seek(http_server):
    s = Stream.create(f"{http_server.url}/f.txt", "r")
    assert isinstance(s, HttpReadStream)
    assert s.read(10) == b"0123456789"
    s.seek(995)
    assert s.read(10) == b"56789"  # across the end
    s.seek(0)
    assert len(s.read()) == 1000
    s.close()


def test_http_sharded_split(http_server):
    """A text split over http://: remote byte-range sharding end to end."""
    uri = f"{http_server.url}/data.libsvm"
    labels = []
    for rank in range(2):
        labels += [int(rec.split()[0]) for rec in
                   drain_records(io_split.create(uri, rank, 2, type="text"))]
    assert sorted(labels) == list(range(50))


def test_sigv4_stable_signature():
    """A pinned clock gives one signature, with the canonical header set."""
    signer = SigV4Signer("AKIDEXAMPLE", "SECRET", "us-east-1", "s3")
    now = datetime(2026, 1, 2, 3, 4, 5, tzinfo=timezone.utc)
    url = "https://bucket.s3.us-east-1.amazonaws.com/key.txt"
    h = signer.sign("GET", url, {}, now=now)
    assert h["x-amz-date"] == "20260102T030405Z"
    assert h["Authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20260102/us-east-1/s3/"
        "aws4_request, SignedHeaders=host;x-amz-content-sha256;x-amz-date,")
    sig = h["Authorization"].rsplit("Signature=", 1)[1]
    assert len(sig) == 64 and int(sig, 16) >= 0
    assert signer.sign("GET", url, {}, now=now)["Authorization"] == h["Authorization"]


def test_s3_write_read_roundtrip(s3):
    fs = FileSystem.get_instance("s3://bkt/dir/a.bin")
    payload = bytes(range(256)) * 10
    with fs.open("s3://bkt/dir/a.bin", "w") as w:
        w.write(payload)
    assert FakeS3Handler.STORE["bkt/dir/a.bin"] == payload
    r = fs.open("s3://bkt/dir/a.bin", "r")
    assert r.read() == payload
    r.seek(100)
    assert r.read(5) == payload[100:105]
    r.close()
    assert FakeS3Handler.SAW_AUTH
    assert all(a.startswith("AWS4-HMAC-SHA256") for a in FakeS3Handler.SAW_AUTH)


def test_s3_delete_object_and_prefix(s3):
    FakeS3Handler.STORE.update({"bkt/ck/a.bin": b"a", "bkt/ck/sub/b.bin": b"b",
                                "bkt/ck/sub/c d+e.bin": b"c", "bkt/keep.txt": b"k"})
    fs = FileSystem.get_instance("s3://bkt/ck")
    fs.delete("s3://bkt/ck/a.bin")
    assert "bkt/ck/a.bin" not in FakeS3Handler.STORE
    # a prefix sweep is ONE DeleteObjects POST, not a request a key
    fs.delete("s3://bkt/ck", recursive=True)
    assert [k for k in FakeS3Handler.STORE if k.startswith("bkt/ck")] == []
    assert "bkt/keep.txt" in FakeS3Handler.STORE
    assert FakeS3Handler.BATCH_DELETES == 1


def test_s3_multipart_upload(s3, monkeypatch):
    monkeypatch.setenv("DMLC_S3_WRITE_BUFFER_BYTES", "1024")
    fs = FileSystem.get_instance("s3://bkt/big.bin")
    payload = os.urandom(5000)
    with fs.open("s3://bkt/big.bin", "w") as w:
        w.write(payload)
    assert FakeS3Handler.STORE["bkt/big.bin"] == payload


def test_s3_list_and_stat(s3):
    FakeS3Handler.STORE.update({"bkt/d/x.txt": b"xx", "bkt/d/y.txt": b"yyy",
                                "bkt/d/sub/z.txt": b"z", "bkt/other.txt": b"o"})
    fs = FileSystem.get_instance("s3://bkt/d")
    listing = {f.path: (f.size, f.type) for f in fs.list_directory("s3://bkt/d")}
    assert listing == {"s3://bkt/d/x.txt": (2, "file"), "s3://bkt/d/y.txt": (3, "file"),
                       "s3://bkt/d/sub/": (0, "directory")}
    info = fs.get_path_info("s3://bkt/d/x.txt")
    assert info.size == 2 and info.type == "file"
    assert fs.get_path_info("s3://bkt/d").type == "directory"
    assert [i.path for i in fs.list_directory_recursive("s3://bkt/d")] == [
        "s3://bkt/d/x.txt", "s3://bkt/d/y.txt", "s3://bkt/d/sub/z.txt"]


def test_s3_sharded_parse(s3):
    """The reference's distributed-shard test pattern over the fake S3."""
    from dmlc_core_tpu_torch.data import create_parser

    FakeS3Handler.STORE["bkt/train.libsvm"] = b"".join(
        b"%d 0:1 2:2\n" % (i,) for i in range(40))
    labels = []
    for rank in range(2):
        parser = create_parser("s3://bkt/train.libsvm", rank, 2, type="libsvm")
        for blk in parser:
            labels += blk.label.astype(int).tolist()
        parser.close()
    assert sorted(labels) == list(range(40))


def test_gcs_uses_same_wire(s3, monkeypatch):
    monkeypatch.setenv("GCS_ENDPOINT", s3.url)
    monkeypatch.setenv("GS_ACCESS_KEY_ID", "GOOGTEST")
    monkeypatch.setenv("GS_SECRET_ACCESS_KEY", "gsekrit")
    monkeypatch.setattr(FakeS3Handler, "ACCESS", "GOOGTEST")
    monkeypatch.setattr(FakeS3Handler, "SECRET", "gsekrit")
    reset_both()
    FakeS3Handler.STORE["gbkt/obj.txt"] = b"gcs-data"
    fs = FileSystem.get_instance("gs://gbkt/obj.txt")
    assert isinstance(fs, GCSFileSystem)
    with fs.open("gs://gbkt/obj.txt", "r") as r:
        assert r.read() == b"gcs-data"


def test_gcs_metadata_server_token(gcs_adc):
    FakeGcsBearerHandler.STORE["bkt/data.txt"] = b"adc-bytes"
    fs = FileSystem.get_instance("gs://bkt/data.txt")
    assert isinstance(fs, GCSFileSystem) and fs.signer is None
    with fs.open("gs://bkt/data.txt", "r") as r:
        assert r.read() == b"adc-bytes"
    assert all(a == "Bearer meta-token-1" for a in FakeGcsBearerHandler.SAW_AUTH)
    fs.get_path_info("gs://bkt/data.txt")
    assert FakeMetadataHandler.CALLS == 1  # one token, many requests


def test_gcs_metadata_token_refresh_deadlines(gcs_adc):
    """A short-lived token is reused for half its life, then refetched."""
    FakeMetadataHandler.EXPIRES_IN = 1
    tok = MetadataServerToken()
    assert tok.token() == tok.token() == "meta-token-1"
    assert FakeMetadataHandler.CALLS == 1
    time.sleep(0.6)  # past the soft deadline (ttl/2)
    assert tok.token() == "meta-token-1"
    assert FakeMetadataHandler.CALLS == 2


def test_gcs_stale_token_survives_refresh_hiccup(gcs_adc):
    """A metadata server gone mid-run serves the still-valid token."""
    meta, _ = gcs_adc
    tok = MetadataServerToken()
    assert tok.token() == "meta-token-1"
    meta.stop()
    tok._refresh_at = 0.0  # force a refresh attempt
    assert tok.token() == "meta-token-1"


def test_gcs_falls_back_anonymous_off_gce(monkeypatch):
    """No credentials and no metadata server: anonymous requests, with
    the failed probe cached."""
    FakeGcsBearerHandler.STORE = {"pub/obj": b"public"}
    FakeGcsBearerHandler.SAW_AUTH = []
    FakeGcsBearerHandler.ALLOW_ANON = True
    gcs = Served(FakeGcsBearerHandler)
    monkeypatch.setenv("GCS_ENDPOINT", gcs.url)
    reset_both()
    try:
        fs = FileSystem.get_instance("gs://pub/obj")
        with fs.open("gs://pub/obj", "r") as r:
            assert r.read() == b"public"
        assert fs._oauth_failed
        assert FakeGcsBearerHandler.SAW_AUTH[-1] == ""
    finally:
        FakeGcsBearerHandler.ALLOW_ANON = False
        gcs.stop()


def _gcs_checkpoint_surface(monkeypatch):
    """Enough of the GCS XML API on the bearer fake for checkpoints:
    PUT (plain and server-side copy), DELETE and ListObjectsV2."""
    store = FakeGcsBearerHandler.STORE

    def reply(self, code, body=b""):
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def do_PUT(self):
        if not self._authed():
            return
        src = self.headers.get("x-goog-copy-source")
        if src:
            store[self._key()] = store[urllib.parse.unquote(src).lstrip("/")]
            reply(self, 200, b"<CopyObjectResult/>")
            return
        store[self._key()] = self.rfile.read(int(self.headers.get("Content-Length", "0")))
        reply(self, 200)

    def do_DELETE(self):
        if not self._authed():
            return
        store.pop(self._key(), None)
        reply(self, 204)

    def do_GET(self):
        if "list-type" not in self.path:
            return type(self)._plain_get(self)
        if not self._authed():
            return
        q = urllib.parse.parse_qs(self.path.split("?", 1)[1])
        prefix, delim = q.get("prefix", [""])[0], q.get("delimiter", [""])[0]
        bucket = self.path.lstrip("/").split("?", 1)[0].rstrip("/")
        contents, prefixes = [], set()
        for k in [k[len(bucket) + 1:] for k in store if k.startswith(f"{bucket}/{prefix}")]:
            rest = k[len(prefix):]
            if delim and delim in rest:
                prefixes.add(prefix + rest.split(delim, 1)[0] + delim)
            else:
                contents.append(k)
        body = ("<ListBucketResult>" + "".join(
            f"<Contents><Key>{k}</Key><Size>{len(store[f'{bucket}/{k}'])}</Size></Contents>"
            for k in contents) + "".join(
            f"<CommonPrefixes><Prefix>{p}</Prefix></CommonPrefixes>" for p in sorted(prefixes))
            + "<IsTruncated>false</IsTruncated></ListBucketResult>").encode()
        reply(self, 200, body)

    monkeypatch.setattr(FakeGcsBearerHandler, "_plain_get", FakeGcsBearerHandler.do_GET,
                        raising=False)
    monkeypatch.setattr(FakeGcsBearerHandler, "do_GET", do_GET)
    monkeypatch.setattr(FakeGcsBearerHandler, "do_PUT", do_PUT, raising=False)
    monkeypatch.setattr(FakeGcsBearerHandler, "do_DELETE", do_DELETE, raising=False)


def test_gcs_adc_checkpoint_lifecycle(gcs_adc, monkeypatch):
    """The port's Checkpointer over gs:// with metadata-server
    credentials: save, list, restore and retention, every request with
    the bearer token."""
    _gcs_checkpoint_surface(monkeypatch)
    ck = checkpoint.Checkpointer("gs://bkt/run", keep=2, process_index=0)
    for s in (1, 2, 3):
        ck.save(s, {"w": np.full(4, s, np.float32)})
    assert ck.steps() == [2, 3]  # retention deleted step 1
    step, tree = ck.restore()
    assert step == 3
    np.testing.assert_array_equal(tree["w"], np.full(4, 3.0))
    assert FakeGcsBearerHandler.SAW_AUTH
    assert all(a == "Bearer meta-token-1" for a in FakeGcsBearerHandler.SAW_AUTH)


def test_gcs_service_account_jwt(tmp_path, monkeypatch):
    """A service-account key: an RS256 JWT (the optional ``cryptography``
    package, imported at the mint) exchanged for a bearer token."""
    pytest.importorskip("cryptography", reason="cryptography not installed")
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import rsa

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    pem = key.private_bytes(serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
                            serialization.NoEncryption()).decode()
    sa_path = tmp_path / "sa.json"
    sa_path.write_text(json.dumps({
        "type": "service_account", "client_email": "svc@proj.iam.gserviceaccount.com",
        "private_key": pem, "token_uri": "http://unused.invalid/token"}))
    FakeTokenEndpointHandler.PUBLIC_KEY = key.public_key()
    FakeTokenEndpointHandler.LAST_CLAIMS = None
    FakeGcsBearerHandler.STORE = {"b/k": b"sa-bytes"}
    FakeGcsBearerHandler.SAW_AUTH = []
    FakeGcsBearerHandler.EXPECT_TOKEN = "sa-token-9"
    tok_srv, gcs = Served(FakeTokenEndpointHandler), Served(FakeGcsBearerHandler)
    monkeypatch.setenv("GOOGLE_APPLICATION_CREDENTIALS", str(sa_path))
    monkeypatch.setenv("GCS_TOKEN_URI", f"{tok_srv.url}/token")
    monkeypatch.setenv("GCS_ENDPOINT", gcs.url)
    reset_both()
    try:
        fs = FileSystem.get_instance("gs://b/k")
        with fs.open("gs://b/k", "r") as r:
            assert r.read() == b"sa-bytes"
        claims = FakeTokenEndpointHandler.LAST_CLAIMS
        assert claims["iss"] == "svc@proj.iam.gserviceaccount.com"
        assert claims["aud"] == f"{tok_srv.url}/token"
        assert claims["exp"] - claims["iat"] == 3600
        assert "devstorage" in claims["scope"]
    finally:
        FakeGcsBearerHandler.EXPECT_TOKEN = "meta-token-1"
        tok_srv.stop()
        gcs.stop()


def test_webhdfs_stat_list_read(webhdfs):
    uri = "hdfs://127.0.0.1:8020/data/a.txt"
    fs = FileSystem.get_instance(uri)
    assert isinstance(fs, WebHdfsFileSystem)
    assert FileSystem.get_instance("viewfs://127.0.0.1:8020/data") is not None
    info = fs.get_path_info(uri)
    assert info.size == len(b"alpha\nbeta\ngamma\n") and info.type == "file"
    assert [f.path for f in fs.list_directory("hdfs://127.0.0.1:8020/data")] == [uri]
    r = fs.open(uri, "r")
    assert r.read(5) == b"alpha"
    r.seek(6)
    assert r.read(4) == b"beta"
    r.close()


def test_s3_key_with_special_chars(s3):
    """A key that needs percent-encoding signs correctly (the fake
    verifies the signature from the wire form)."""
    fs = FileSystem.get_instance("s3://bkt/x")
    key_uri = "s3://bkt/dir/my file+v2.txt"
    with fs.open(key_uri, "w") as w:
        w.write(b"special")
    with fs.open(key_uri, "r") as r:
        assert r.read() == b"special"


def test_s3_get_heals_consecutive_5xx(s3):
    payload = bytes(range(256)) * 8
    FakeS3Handler.STORE["bkt/flaky.bin"] = payload
    fs = FileSystem.get_instance("s3://bkt/flaky.bin")
    before = retry.stats()
    FakeS3Handler.FAIL_GET = 3
    with fs.open("s3://bkt/flaky.bin", "r") as r:
        assert r.read() == payload
    delta = retry.stats_delta(before)
    assert delta["retries"] >= 3 and delta["backoff_secs"] > 0


def test_s3_retry_exhaustion_reraises_last_error(s3, monkeypatch):
    monkeypatch.setenv("DMLC_RETRY_ATTEMPTS", "3")
    FakeS3Handler.STORE["bkt/dead.bin"] = b"x"
    fs = FileSystem.get_instance("s3://bkt/dead.bin")
    FakeS3Handler.FAIL_GET = 50  # more than any budget
    with pytest.raises(HttpError, match="HTTP 500") as ei:
        fs.open("s3://bkt/dead.bin", "r").read()
    assert ei.value.status == 500
    assert FakeS3Handler.FAIL_GET >= 40, "the attempt cap did not bound the retries"


def test_s3_multipart_failed_part_retries_that_part(s3, monkeypatch):
    monkeypatch.setenv("DMLC_S3_WRITE_BUFFER_BYTES", "1024")
    fs = FileSystem.get_instance("s3://bkt/big2.bin")
    payload = os.urandom(5000)
    before = retry.stats()
    FakeS3Handler.FAIL_PART_PUT = 2
    with fs.open("s3://bkt/big2.bin", "w") as w:
        w.write(payload)
    assert FakeS3Handler.STORE["bkt/big2.bin"] == payload
    assert retry.stats_delta(before)["retries"] >= 2


def test_s3_server_side_copy(s3):
    FakeS3Handler.STORE["bkt/src key.bin"] = b"copy-me"
    FileSystem.get_instance("s3://bkt/x").copy("s3://bkt/src key.bin", "s3://bkt/dst.bin")
    assert FakeS3Handler.STORE["bkt/dst.bin"] == b"copy-me"


def test_s3_atomic_checkpoint_write(s3):
    """``_write_atomic`` on s3://: a tmp key, the length checked, a
    server-side rename; no ``.tmp`` left after a clean commit."""
    tree = {"w": np.arange(16, dtype=np.float32)}
    checkpoint._write_atomic("s3://bkt/ck/model.bin", tree)
    assert "bkt/ck/model.bin" in FakeS3Handler.STORE
    assert "bkt/ck/model.bin.tmp" not in FakeS3Handler.STORE
    np.testing.assert_array_equal(checkpoint.load_pytree("s3://bkt/ck/model.bin")["w"],
                                  tree["w"])


def test_webhdfs_write_roundtrip(webhdfs, monkeypatch):
    """CREATE through the namenode's redirect, then APPEND parts."""
    monkeypatch.setenv("DMLC_WEBHDFS_WRITE_BUFFER_BYTES", "1024")
    payload = bytes(range(256)) * 10  # CREATE + 2 APPENDs
    with Stream.create("hdfs://127.0.0.1:8020/data/out.bin", "w") as w:
        w.write(payload)
    assert FakeWebHdfsHandler.FILES["/data/out.bin"] == payload
    with Stream.create("hdfs://127.0.0.1:8020/data/out.bin", "r") as r:
        assert r.read() == payload


def test_webhdfs_write_empty_file_lands(webhdfs):
    Stream.create("hdfs://127.0.0.1:8020/data/empty.bin", "w").close()
    assert FakeWebHdfsHandler.FILES["/data/empty.bin"] == b""


def test_webhdfs_rename_and_atomic_checkpoint(webhdfs):
    fs = FileSystem.get_instance("hdfs://127.0.0.1:8020/x")
    FakeWebHdfsHandler.FILES["/data/a2.txt"] = b"move-me"
    fs.rename("hdfs://127.0.0.1:8020/data/a2.txt", "hdfs://127.0.0.1:8020/data/b2.txt")
    assert "/data/a2.txt" not in FakeWebHdfsHandler.FILES
    assert FakeWebHdfsHandler.FILES["/data/b2.txt"] == b"move-me"
    FakeWebHdfsHandler.FILES["/data/c2.txt"] = b"old"
    FakeWebHdfsHandler.FILES["/data/b3.txt"] = b"new"
    fs.rename("hdfs://127.0.0.1:8020/data/b3.txt", "hdfs://127.0.0.1:8020/data/c2.txt")
    assert FakeWebHdfsHandler.FILES["/data/c2.txt"] == b"new"
    tree = {"w": np.full(8, 3, dtype=np.int64)}
    checkpoint._write_atomic("hdfs://127.0.0.1:8020/ck/model.bin", tree)
    assert "/ck/model.bin" in FakeWebHdfsHandler.FILES
    assert "/ck/model.bin.tmp" not in FakeWebHdfsHandler.FILES
    np.testing.assert_array_equal(
        checkpoint.load_pytree("hdfs://127.0.0.1:8020/ck/model.bin")["w"], tree["w"])


def test_azure_read_list_delete(monkeypatch):
    """azure:// over a Range server standing in for Blob storage: stat
    and ranged reads, with the SAS token on every URL as in the JAX
    package."""
    RangeFileHandler.FILES = {"/cont/dir/blob.bin": b"azure-bytes" * 10}
    srv = Served(RangeFileHandler)
    monkeypatch.setenv("AZURE_ENDPOINT", srv.url)
    monkeypatch.setenv("AZURE_STORAGE_SAS_TOKEN", "?sv=1&sig=x")
    reset_both()
    try:
        fs = FileSystem.get_instance("azure://cont/dir/blob.bin")
        assert type(fs).__name__ == type(JaxFileSystem.get_instance("azure://c/b")).__name__
        assert fs._url("azure://cont/dir/blob.bin") == JaxFileSystem.get_instance(
            "azure://cont/x")._url("azure://cont/dir/blob.bin")
        assert fs.get_path_info("azure://cont/dir/blob.bin").size == 110
        with fs.open("azure://cont/dir/blob.bin", "r") as r:
            r.seek(6)
            assert r.read(5) == b"bytes"
    finally:
        srv.stop()


def test_unknown_scheme_still_raises():
    from dmlc_core_tpu_torch.utils.logging import Error

    with pytest.raises(Error, match="unknown filesystem protocol 'nope://'"):
        FileSystem.get_instance("nope://x/y")


# -- both packages on one store ---------------------------------------------------


@pytest.mark.parametrize("method,url,headers,token", [
    ("GET", "https://bucket.s3.us-east-1.amazonaws.com/key.txt", {}, None),
    ("PUT", "http://127.0.0.1:9000/bkt/dir/my%20file%2Bv2.txt", {"Content-MD5": "abc"}, None),
    ("GET", "http://127.0.0.1:9000/bkt/?continuation-token=a%2Fb&delimiter=%2F&list-type=2"
            "&prefix=d%2F", {}, "tok"),
    ("POST", "http://127.0.0.1:9000/bkt/k?uploads=", {}, None),
    ("PUT", "http://h/bkt/k?partNumber=2&uploadId=upl0", {"x-amz-copy-source": "/b/k"}, "t"),
])
def test_sigv4_signature_equals_jax(method, url, headers, token):
    now = datetime(2026, 10, 17, 8, 9, 10, tzinfo=timezone.utc)
    got = SigV4Signer("AK", "SK", "eu-west-1", "s3", token).sign(
        method, url, headers, payload_hash="ab" * 32, now=now)
    want = jax_cloudfs.SigV4Signer("AK", "SK", "eu-west-1", "s3", token).sign(
        method, url, headers, payload_hash="ab" * 32, now=now)
    assert got == want


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("nbytes", [3000, 5000])
def test_objects_cross_packages(s3, monkeypatch, writer, nbytes):
    """An object written by one package (multipart at 1 KiB parts) is
    read byte for byte by the other, and both stat it alike."""
    monkeypatch.setenv("DMLC_S3_WRITE_BUFFER_BYTES", "1024")
    payload = np.random.default_rng(nbytes).integers(0, 256, nbytes, np.uint8).tobytes()
    make, read = (Stream.create, JaxStream.create)[::1 if writer == "port" else -1]
    with make("s3://bkt/x/obj.bin", "w") as w:
        w.write(payload[:1700])
        w.write(payload[1700:])
    assert FakeS3Handler.STORE["bkt/x/obj.bin"] == payload
    with read("s3://bkt/x/obj.bin", "r") as r:
        assert r.read() == payload
    assert (tuple(FileSystem.get_instance("s3://bkt/x").list_directory("s3://bkt/x"))
            == tuple(tuple(i) for i in JaxFileSystem.get_instance("s3://bkt/x")
                     .list_directory("s3://bkt/x")))
    assert (tuple(FileSystem.get_instance("s3://bkt/x/obj.bin")
                  .get_path_info("s3://bkt/x/obj.bin"))
            == tuple(JaxFileSystem.get_instance("s3://bkt/x/obj.bin")
                     .get_path_info("s3://bkt/x/obj.bin")))


@pytest.mark.parametrize("nparts", [1, 2, 3])
def test_http_text_split_parts_equal_jax(http_server, nparts):
    uri = f"{http_server.url}/data.libsvm"
    for part in range(nparts):
        got = drain_records(io_split.create(uri, part, nparts, type="text"))
        want = drain_records(jax_split.create(uri, part, nparts, type="text"))
        assert got == want


@pytest.mark.parametrize("codec", [None, "zlib"])
@pytest.mark.parametrize("mode", ["0", "record", "batch", "window"])
def test_s3_indexed_split_parts_equal_jax(s3, tmp_path, mode, codec):
    """``s3://`` data with an ``s3://`` index: each part's records, in
    order, equal the JAX split's over the same URI."""
    records = records_of(300, tag="s")
    p, idx = make_indexed_rec(str(tmp_path), records, codec=codec)
    FakeS3Handler.STORE["bkt/d.rec"] = open(p, "rb").read()
    FakeS3Handler.STORE["bkt/d.idx"] = open(idx, "rb").read()
    uri = (f"s3://bkt/d.rec?index=s3://bkt/d.idx&shuffle={mode}&seed=4&window=40"
           "&batch_size=8&merge_gap=0")
    union = []
    for part in range(3):
        got = drain_records(io_split.create(uri, part, 3, type="recordio"))
        want = drain_records(jax_split.create(uri, part, 3, type="recordio", threaded=False))
        assert got == want
        union += got
    assert sorted(union) == sorted(records)


def test_http_seek_counts_reopen():
    """``HttpReadStream.seek()`` to a new offset over a live connection
    tears it down and counts one ``io.fetch.reopens``."""

    class _Resp:
        def close(self):
            pass

    s = HttpReadStream(f"http://{_DEAD}/x", size=100)
    before = spanfetch.reopens_total()
    s._resp = _Resp()
    s.seek(37)  # a live connection and a new offset: one reopen
    assert spanfetch.reopens_total() - before == 1
    s.seek(37)  # the same offset: nothing
    s.seek(55)  # no live connection: repositioning is free
    assert spanfetch.reopens_total() - before == 1
    s.close()


def test_reopens_equal_jax_for_one_seek_pattern(http_server):
    """One seek pattern over a real connection: the same bytes and the
    same reopen count in both packages."""
    from dmlc_core_tpu.io import spanfetch as jax_spanfetch

    def run(create, mod):
        before = mod.reopens_total()
        s = create(f"{http_server.url}/f.txt", "r")
        out = []
        for pos, n in ((0, 7), (500, 3), (503, 4), (20, 10), (990, 20), (3, 1)):
            s.seek(pos)
            out.append(s.read(n))
        s.close()
        return out, mod.reopens_total() - before

    got, want = run(Stream.create, spanfetch), run(JaxStream.create, jax_spanfetch)
    assert got == want
    assert got[1] == 4  # every seek to a new offset over a live connection


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_cross_packages_on_s3(s3, writer):
    """A checkpoint (tree and meta) saved by one package to the fake S3
    is restored by the other, byte for byte the same objects."""
    rng = np.random.default_rng(5)
    tree = {"w": rng.normal(size=33).astype(np.float32), "b": np.float32(0.5),
            "v": rng.normal(size=(7, 4)).astype(np.float32)}
    meta = {"epoch": 1, "records": 4096}
    port = checkpoint.Checkpointer("s3://bkt/ckpt", keep=2, process_index=0)
    jax = jax_ckpt.Checkpointer("s3://bkt/ckpt", keep=2, process_index=0)
    saver, loader = (port, jax) if writer == "port" else (jax, port)
    for step in (3, 6, 9):
        saver.save(step, tree, meta=meta)
    assert loader.steps() == saver.steps() == [6, 9]
    step, got = loader.restore()
    assert step == 9 and loader.restore_meta(9) == meta
    for key in tree:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(tree[key]))
    assert sorted(FakeS3Handler.STORE) == ["bkt/ckpt/ckpt-0000000006.bin",
                                          "bkt/ckpt/ckpt-0000000006.meta.bin",
                                          "bkt/ckpt/ckpt-0000000009.bin",
                                          "bkt/ckpt/ckpt-0000000009.meta.bin"]


def test_fm_from_s3_matches_jax_fm_on_local_file(s3, tmp_path):
    """The FM trained on the CPU from ``s3://`` (``shuffle=batch`` over an
    indexed rowrec object and its index) matches the JAX FM trained from
    the local file: the batches bit for bit, the params within
    test_torch_models.py's tolerance (1e-4 of max |param|)."""
    from dmlc_core_tpu.data.rowrec import encode_row
    from dmlc_core_tpu.io.recordio import IndexedRecordIOWriter
    from dmlc_core_tpu.io.stream import FileStream
    from dmlc_core_tpu.models import FactorizationMachine as JaxFM
    from dmlc_core_tpu.staging import BatchSpec as JaxSpec
    from dmlc_core_tpu.staging import ell_batches as jax_ell_batches
    from dmlc_core_tpu_torch.convert import params_from_jax, params_to_numpy
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    n, k, d, e, b = 384, 6, 97, 4, 32
    rec, idx = str(tmp_path / "fm.rec"), str(tmp_path / "fm.idx")
    rng = np.random.default_rng(11)
    with FileStream(rec, "w") as f, FileStream(idx, "w") as fi:
        w = IndexedRecordIOWriter(f, fi)
        for i in range(n):
            w.write_record(encode_row(float(i % 2), rng.integers(0, d, k, dtype=np.int64),
                                      rng.normal(size=k).astype(np.float32)), i)
    FakeS3Handler.STORE["bkt/fm.rec"] = open(rec, "rb").read()
    FakeS3Handler.STORE["bkt/fm.idx"] = open(idx, "rb").read()
    query = f"shuffle=batch&batch_size={b}&seed=3"
    keys = ("indices", "values", "nnz", "labels", "weights")
    jsrc = jax_ell_batches(f"{rec}?index={idx}&{query}",
                           JaxSpec(batch_size=b, layout="ell", max_nnz=k))
    local = [{key: np.array(getattr(x, key)) for key in keys} for x in jsrc]
    jsrc.close()
    src = ell_batches(f"s3://bkt/fm.rec?index=s3://bkt/fm.idx&{query}",
                      BatchSpec(batch_size=b, layout="ell", max_nnz=k))
    remote = [{key: np.array(getattr(x, key)) for key in keys} for x in src]
    src.close()
    assert len(remote) == len(local) == n // b
    for got, want in zip(remote, local):
        for key in keys:
            np.testing.assert_array_equal(got[key], want[key])

    prng = np.random.default_rng(4)
    params = {"w": prng.normal(size=d).astype(np.float32) * 0.3, "b": np.float32(0.1),
              "v": prng.normal(size=(d, e)).astype(np.float32) * 0.3}
    jmodel, jparams = JaxFM(d, embed_dim=e), params
    for batch in local:
        jparams, _ = jmodel.sgd_step(jparams, batch)
    model = FactorizationMachine(d, e, device="cpu")
    model.load_state_dict(params_from_jax(params, "cpu"))
    for batch in remote:
        model.sgd_step({key: torch.from_numpy(v) for key, v in batch.items()})
    got = params_to_numpy(model.state_dict())
    for key in got:
        want = np.asarray(jparams[key], np.float32)
        tol = 1e-4 * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(np.asarray(got[key], np.float32) - want).max()) <= tol, key


def test_fault_over_s3_heals_and_equals_clean(s3, tmp_path):
    """``fault://inner=s3,...`` wraps the new backend: chaos reads of an
    ``s3://`` object give the clean records, equal to the JAX split's over
    the same URI, with faults fired and healed."""
    records = records_of(200, tag="f")
    p, idx = make_indexed_rec(str(tmp_path), records)
    FakeS3Handler.STORE["bkt/c.rec"] = open(p, "rb").read()
    FakeS3Handler.STORE["bkt/c.idx"] = open(idx, "rb").read()
    uri = ("fault://inner=s3,resets=2,short=2,errors=2,seed=7,cap=512/bkt/c.rec"
           "?index=s3://bkt/c.idx&shuffle=batch&batch_size=16&seed=2")
    before = retry.stats()
    sp = io_split.create(uri, type="recordio")
    got = drain_records(sp)
    delta = retry.stats_delta(before)
    want = drain_records(jax_split.create(uri, type="recordio", threaded=False))
    assert got == want and sorted(got) == sorted(records)
    assert delta["faults_injected"] > 0 and delta["retries"] > 0
