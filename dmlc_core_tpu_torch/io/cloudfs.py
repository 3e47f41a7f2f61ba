"""Remote filesystems over the standard library's HTTP client: http(s)://,
s3://, gs://, hdfs:// (and viewfs://) and azure:// (the port of
``dmlc_core_tpu/io/cloudfs.py``, with the same env knobs, wire forms and
retry behaviour, so one job may mix the two packages over one bucket).

Reference: src/io/s3_filesys.cc (SigV4 signing, ranged-GET seekable
reads, multipart-upload writes, XML listings), src/io/hdfs_filesys.cc
and src/io/azure_filesys.cc.

- ``http(s)://``: ranged GETs that resume at the exact offset after a
  5xx, a reset, ``IncompleteRead`` or a short body;
- ``s3://``: SigV4 over path style when ``S3_ENDPOINT`` is set, else
  virtual-host style; credentials from ``S3_ACCESS_KEY`` /
  ``AWS_ACCESS_KEY_ID``, ``S3_SECRET_KEY`` / ``AWS_SECRET_ACCESS_KEY``,
  ``AWS_SESSION_TOKEN``; region ``S3_REGION`` / ``AWS_REGION``;
  ``S3_VERIFY_SSL``;
- ``gs://``: the GCS XML interop API (the S3 wire) with HMAC keys
  (``GS_ACCESS_KEY_ID``), a service-account key
  (``GOOGLE_APPLICATION_CREDENTIALS``, RS256 through the optional
  ``cryptography`` package, imported only when a token is minted) or the
  GCE metadata server (``GCE_METADATA_HOST``), else anonymous;
  ``GCS_ENDPOINT``;
- ``hdfs://``: WebHDFS REST (``DMLC_WEBHDFS_PORT``, ``DMLC_HDFS_USER``),
  with the two-step create/append and a real rename;
- ``azure://``: SAS-token or public containers (read, list, delete).

Every endpoint is overridable through the env, which is how tests point
these clients at fake servers on the loopback.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import json
import os
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.logging import Error, check
from .filesystem import FS_REGISTRY, FileInfo, FileSystem
from .retry import HttpError, RetryPolicy, is_transient
from .retry import request as _request
from .spanfetch import count_stream_reopen as _count_stream_reopen
from .stream import SeekStream, Stream
from .uri import URI

__all__ = [
    "HttpReadStream",
    "HttpFileSystem",
    "SigV4Signer",
    "S3FileSystem",
    "OAuthTokenProvider",
    "MetadataServerToken",
    "ServiceAccountToken",
    "GCSFileSystem",
    "WebHdfsFileSystem",
    "AzureBlobFileSystem",
]


class HttpReadStream(SeekStream):
    """Seekable read stream over HTTP ranged GETs.

    Seek is a cheap restart: drop the connection, re-issue a ranged request
    at the new offset on the next read (reference CURLReadStreamBase::Seek,
    s3_filesys.cc:550-593). ``prepare`` customizes each restart (signing,
    offset query params).

    Transient failures — a 5xx on the (re)connect, a socket reset or
    IncompleteRead mid-body, a silently short body — reconnect with a
    Range header at the exact resume offset, so the fault is invisible
    to callers. One ``RetryPolicy`` spans the stream's lifetime: its
    cumulative backoff budget bounds a stream limping through repeated
    faults, and the per-operation attempt cap bounds consecutive
    no-progress reconnects.
    """

    def __init__(
        self,
        url: str,
        size: Optional[int] = None,
        prepare: Optional[
            Callable[[int, Dict[str, str]], Tuple[str, Dict[str, str]]]
        ] = None,
        policy: Optional[RetryPolicy] = None,
    ) -> None:
        self.url = url
        self._size = size
        self._prepare = prepare
        self._policy = policy or RetryPolicy()
        self._stalls = 0  # consecutive reconnects without progress
        self._pos = 0
        self._resp = None

    def _restart(self) -> None:
        self._drop()
        headers: Dict[str, str] = {}
        url = self.url
        if self._prepare is not None:
            url, headers = self._prepare(self._pos, headers)
        elif self._pos:
            headers["Range"] = f"bytes={self._pos}-"
        if self._size is not None and self._pos >= self._size:
            self._resp = None
            return
        try:
            self._resp = _request(url, "GET", headers, policy=self._policy)
        except HttpError as e:
            if e.status == 416:  # range beyond EOF
                self._resp = None
                return
            raise
        if self._pos and "Range" in headers:
            # a server/proxy that ignores Range would silently serve byte 0
            # as if it were byte _pos — corrupt shards, no error. Demand
            # proof the range was honored.
            status = getattr(self._resp, "status", 206)
            crange = self._resp.headers.get("Content-Range", "")
            start = None
            if crange.startswith("bytes "):
                try:
                    start = int(crange[6:].split("-")[0])
                except ValueError:
                    start = None
            if status != 206 or start != self._pos:
                self._drop()
                raise Error(
                    f"server ignored Range request at offset {self._pos} "
                    f"for {url} (status {status}, Content-Range {crange!r})"
                )
        if self._size is None:
            total = _total_from_response(self._resp)
            if total is not None:
                self._size = total

    def _drop(self) -> None:
        if self._resp is not None:
            try:
                self._resp.close()
            except OSError:
                pass
            self._resp = None

    def _reconnect_pause(self, cause: Optional[BaseException]) -> None:
        """Account one mid-body reconnect: raise past the no-progress
        attempt cap or the policy's cumulative budget, else backoff."""
        self._stalls += 1
        if self._stalls >= self._policy.max_attempts:
            err = Error(
                f"read of {self.url} failed after {self._stalls} "
                f"reconnects without progress at offset {self._pos}"
            )
            if cause is not None:
                raise err from cause
            raise err
        self._policy.pause(cause=cause, what=f"read {self.url} @{self._pos}")

    def read(self, n: int = -1) -> bytes:
        if n == 0:
            return b""
        while True:
            if self._resp is None:
                if self._size is not None and self._pos >= self._size:
                    return b""
                self._restart()
                if self._resp is None:
                    return b""
            try:
                out = self._resp.read(None if n < 0 else n)
            except Exception as e:
                # socket reset / IncompleteRead mid-body: resume the
                # ranged GET at the exact offset instead of failing
                self._drop()
                if not is_transient(e):
                    raise
                self._reconnect_pause(e)
                continue
            if out:
                self._pos += len(out)
                self._stalls = 0
                return out
            self._drop()
            # empty read with bytes still expected = the server dropped the
            # connection mid-transfer; resume the ranged GET instead of
            # reporting a silently-truncated EOF
            if self._size is not None and self._pos < self._size:
                self._reconnect_pause(None)
                continue
            return b""

    def seek(self, pos: int) -> None:
        if pos != self._pos:
            if self._resp is not None:
                # a live connection torn down by repositioning: the next
                # read pays a full reconnect (ranged GET). Counted as
                # io.fetch.reopens so serial-fallback seek storms are
                # visible in io_stats/bench/`tools trace report`.
                _count_stream_reopen()
            self._drop()
            self._pos = pos

    def tell(self) -> int:
        return self._pos

    def write(self, data) -> int:
        raise Error("HttpReadStream is read-only")

    def close(self) -> None:
        self._drop()


def _total_from_response(resp) -> Optional[int]:
    crange = resp.headers.get("Content-Range")
    if crange and "/" in crange:
        try:
            return int(crange.rsplit("/", 1)[1])
        except ValueError:
            return None
    clen = resp.headers.get("Content-Length")
    return int(clen) if clen else None


class HttpFileSystem(FileSystem):
    """Plain http(s) reads (reference HttpReadStream, s3_filesys.cc:750)."""

    def open(self, uri: str, mode: str = "r") -> Stream:
        check(mode in ("r", "rb"), "http(s) filesystem is read-only")
        return HttpReadStream(uri)

    def get_path_info(self, uri: str) -> FileInfo:
        resp = _request(uri, "HEAD")
        size = int(resp.headers.get("Content-Length") or 0)
        # change token for the decoded-block cache identity: the ETag
        # when the origin sends one, else Last-Modified, else none
        etag = (
            resp.headers.get("ETag")
            or resp.headers.get("Last-Modified")
            or ""
        )
        resp.close()
        return FileInfo(uri, size, "file", etag)

    def list_directory(self, uri: str) -> List[FileInfo]:
        raise Error("http(s) filesystem cannot list directories")


# -- AWS Signature Version 4 -------------------------------------------------


class SigV4Signer:
    """AWS SigV4 request signing (public spec; reference implements the
    same scheme in C++, s3_filesys.cc:72-200)."""

    def __init__(
        self,
        access_key: str,
        secret_key: str,
        region: str,
        service: str = "s3",
        session_token: Optional[str] = None,
    ) -> None:
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.service = service
        self.session_token = session_token

    @staticmethod
    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    def sign(
        self,
        method: str,
        url: str,
        headers: Dict[str, str],
        payload_hash: Optional[str] = None,
        now: Optional[datetime.datetime] = None,
    ) -> Dict[str, str]:
        """Returns headers with Authorization/x-amz-* added."""
        parsed = urllib.parse.urlsplit(url)
        now = now or datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        payload_hash = payload_hash or hashlib.sha256(b"").hexdigest()
        out = dict(headers)
        out["host"] = parsed.netloc
        out["x-amz-date"] = amz_date
        out["x-amz-content-sha256"] = payload_hash
        if self.session_token:
            out["x-amz-security-token"] = self.session_token
        signed_names = sorted(k.lower() for k in out)
        canonical_headers = "".join(
            f"{k}:{out[_orig_key(out, k)].strip()}\n" for k in signed_names
        )
        signed_headers = ";".join(signed_names)
        # canonical URI/query must match the wire form byte-for-byte: the
        # path and query are already percent-encoded by the caller, so use
        # them as sent (re-quoting would double-encode, and decoding the
        # query loses the original escapes -> SignatureDoesNotMatch)
        query = (
            "&".join(
                sorted(
                    p if "=" in p else p + "="
                    for p in parsed.query.split("&")
                )
            )
            if parsed.query
            else ""
        )
        canonical = "\n".join(
            [
                method,
                parsed.path or "/",
                query,
                canonical_headers,
                signed_headers,
                payload_hash,
            ]
        )
        scope = f"{datestamp}/{self.region}/{self.service}/aws4_request"
        to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical.encode()).hexdigest(),
            ]
        )
        key = self._hmac(
            self._hmac(
                self._hmac(
                    self._hmac(
                        ("AWS4" + self.secret_key).encode(), datestamp
                    ),
                    self.region,
                ),
                self.service,
            ),
            "aws4_request",
        )
        signature = hmac.new(key, to_sign.encode(), hashlib.sha256).hexdigest()
        out["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        )
        return out


def _orig_key(d: Dict[str, str], lower: str) -> str:
    for k in d:
        if k.lower() == lower:
            return k
    raise KeyError(lower)


# -- S3 ----------------------------------------------------------------------


class S3WriteStream(Stream):
    """Buffered multipart-upload writer (reference WriteStream,
    s3_filesys.cc:768-1016). Small objects go up as one PUT; larger ones
    initiate a multipart upload per ``part_bytes``
    (DMLC_S3_WRITE_BUFFER_MB, min 5MB per the S3 API)."""

    def __init__(self, fs: "S3FileSystem", bucket: str, key: str) -> None:
        self.fs = fs
        self.bucket = bucket
        self.key = key
        if "DMLC_S3_WRITE_BUFFER_BYTES" in os.environ:  # test hook
            self.part_bytes = int(os.environ["DMLC_S3_WRITE_BUFFER_BYTES"])
        else:
            mb = int(os.environ.get("DMLC_S3_WRITE_BUFFER_MB", "16"))
            self.part_bytes = max(mb, 5) << 20  # S3 minimum part size 5MB
        self._buf = bytearray()
        self._upload_id: Optional[str] = None
        self._etags: List[str] = []
        self._closed = False

    def write(self, data) -> int:
        self._buf.extend(data)
        while len(self._buf) >= self.part_bytes:
            self._flush_part(bytes(self._buf[: self.part_bytes]))
            del self._buf[: self.part_bytes]
        return len(data)

    def _flush_part(self, payload: bytes) -> None:
        if self._upload_id is None:
            url = self.fs.object_url(self.bucket, self.key) + "?uploads="
            resp = self.fs.request("POST", url, b"")
            root = ET.fromstring(resp)
            self._upload_id = _xml_find(root, "UploadId")
        n = len(self._etags) + 1
        url = (
            self.fs.object_url(self.bucket, self.key)
            + f"?partNumber={n}&uploadId={self._upload_id}"
        )
        headers = self.fs.request("PUT", url, payload, want_headers=True)
        self._etags.append(headers.get("ETag", f'"part{n}"'))

    def flush(self) -> None:
        pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._upload_id is None:
            # single-shot PUT
            url = self.fs.object_url(self.bucket, self.key)
            self.fs.request("PUT", url, bytes(self._buf))
            return
        if self._buf:
            self._flush_part(bytes(self._buf))
            self._buf.clear()
        parts = "".join(
            f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{etag}</ETag></Part>"
            for i, etag in enumerate(self._etags)
        )
        body = (
            "<CompleteMultipartUpload>" + parts + "</CompleteMultipartUpload>"
        ).encode()
        url = (
            self.fs.object_url(self.bucket, self.key)
            + f"?uploadId={self._upload_id}"
        )
        self.fs.request("POST", url, body)


def _xml_find(root, tag: str) -> str:
    for el in root.iter():
        if el.tag.endswith(tag):
            return el.text or ""
    raise Error(f"missing <{tag}> in response")


class S3FileSystem(FileSystem):
    """Self-contained S3 client (reference S3FileSystem,
    src/io/s3_filesys.cc). Credentials/region/endpoint from env:
    AWS_ACCESS_KEY_ID / S3_ACCESS_KEY, AWS_SECRET_ACCESS_KEY /
    S3_SECRET_KEY, AWS_REGION / S3_REGION, S3_ENDPOINT (path-style;
    also the hermetic-test hook), AWS_SESSION_TOKEN
    (reference env handling, s3_filesys.cc:1151-1169)."""

    protocol = "s3://"

    def __init__(self) -> None:
        self.access_key = os.environ.get(
            "S3_ACCESS_KEY", os.environ.get("AWS_ACCESS_KEY_ID", "")
        )
        self.secret_key = os.environ.get(
            "S3_SECRET_KEY", os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        )
        self.region = os.environ.get(
            "S3_REGION", os.environ.get("AWS_REGION", "us-east-1")
        )
        self.session_token = os.environ.get("AWS_SESSION_TOKEN")
        self.endpoint = os.environ.get("S3_ENDPOINT")  # implies path-style
        self.verify_ssl = os.environ.get("S3_VERIFY_SSL", "1") != "0"
        self.signer = (
            SigV4Signer(
                self.access_key,
                self.secret_key,
                self.region,
                "s3",
                self.session_token,
            )
            if self.access_key
            else None
        )

    # -- plumbing ------------------------------------------------------------
    def split_uri(self, uri: str) -> Tuple[str, str]:
        u = URI(uri)
        check(u.protocol == self.protocol, f"not a {self.protocol} uri: {uri}")
        return u.host, u.path.lstrip("/")

    def object_url(self, bucket: str, key: str) -> str:
        key_q = urllib.parse.quote(key, safe="/-_.~")
        if self.endpoint:
            return f"{self.endpoint}/{bucket}/{key_q}"
        return f"https://{bucket}.s3.{self.region}.amazonaws.com/{key_q}"

    def _signed_headers(
        self, method: str, url: str, headers: Dict[str, str], payload: bytes
    ) -> Dict[str, str]:
        if self.signer is None:
            return headers
        payload_hash = hashlib.sha256(payload).hexdigest()
        return self.signer.sign(method, url, headers, payload_hash)

    def request(
        self, method: str, url: str, payload: bytes = b"", want_headers=False
    ):
        headers = self._signed_headers(method, url, {}, payload)
        resp = _request(url, method, headers, payload or None)
        try:
            if want_headers:
                return dict(resp.headers)
            return resp.read()
        finally:
            resp.close()

    # -- FileSystem interface ------------------------------------------------
    def open(self, uri: str, mode: str = "r") -> Stream:
        bucket, key = self.split_uri(uri)
        if mode in ("r", "rb"):
            url = self.object_url(bucket, key)

            def prepare(pos: int, headers: Dict[str, str]):
                h = dict(headers)
                if pos:
                    h["Range"] = f"bytes={pos}-"
                return url, self._signed_headers("GET", url, h, b"")

            info = self.get_path_info(uri)
            return HttpReadStream(url, size=info.size, prepare=prepare)
        if mode in ("w", "wb"):
            return S3WriteStream(self, bucket, key)
        raise Error(f"unsupported mode {mode!r} for s3")

    def get_path_info(self, uri: str) -> FileInfo:
        bucket, key = self.split_uri(uri)
        url = self.object_url(bucket, key)
        headers = self._signed_headers("HEAD", url, {}, b"")
        try:
            resp = _request(url, "HEAD", headers)
        except HttpError as e:
            if e.status == 404:
                # maybe a "directory" (key prefix)
                if self.list_directory(uri):
                    return FileInfo(uri.rstrip("/") + "/", 0, "directory")
            raise
        size = int(resp.headers.get("Content-Length") or 0)
        # the object's ETag (S3 and the GCS XML API both send one on
        # HEAD): an in-place rewrite changes it even at identical size
        etag = resp.headers.get("ETag") or ""
        resp.close()
        return FileInfo(uri, size, "file", etag)

    def delete(self, uri: str, recursive: bool = False) -> None:
        """DELETE object; with ``recursive``, every object under the
        prefix (object stores have no directories — a 'directory' delete
        is a listed prefix sweep). Powers remote checkpoint retention.

        Prefix sweeps use the batch DeleteObjects POST (up to 1000 keys
        per request): pruning one sharded pod checkpoint is one LIST +
        one POST instead of nprocs+1 sequential round trips."""
        if recursive:
            infos = self.list_directory_recursive(uri)
            if infos:
                bucket = self.split_uri(uri)[0]
                keys = [self.split_uri(i.path)[1] for i in infos]
                for i in range(0, len(keys), 1000):
                    self._delete_batch(bucket, keys[i:i + 1000])
                return
        bucket, key = self.split_uri(uri)
        self.request("DELETE", self.object_url(bucket, key))

    def _delete_batch(self, bucket: str, keys: List[str]) -> None:
        """POST /?delete (DeleteObjects). Content-MD5 is mandatory."""
        from xml.sax.saxutils import escape

        body = (
            "<Delete><Quiet>true</Quiet>"
            + "".join(f"<Object><Key>{escape(k)}</Key></Object>" for k in keys)
            + "</Delete>"
        ).encode()
        base = (
            f"{self.endpoint}/{bucket}"
            if self.endpoint
            else f"https://{bucket}.s3.{self.region}.amazonaws.com"
        )
        url = base + "/?delete"
        headers = {
            "Content-MD5": base64.b64encode(
                hashlib.md5(body).digest()
            ).decode(),
        }
        headers = self._signed_headers("POST", url, headers, body)
        resp = _request(url, "POST", headers, body)
        try:
            out = resp.read()
        finally:
            resp.close()
        # Quiet mode returns only failures; any <Error> means keys remain
        if b"<Error>" in out:
            raise Error(
                f"DeleteObjects reported failures: {out[:500].decode(errors='replace')}"
            )

    # header name differs per store (GCS XML interop: x-goog-copy-source)
    _COPY_SOURCE_HEADER = "x-amz-copy-source"

    def copy(self, src_uri: str, dst_uri: str) -> None:
        """Server-side object copy (PUT + copy-source header): no bytes
        transit this process — the checkpoint tmp-key → final-key rename
        costs one metadata round trip, not a re-upload."""
        sbucket, skey = self.split_uri(src_uri)
        dbucket, dkey = self.split_uri(dst_uri)
        url = self.object_url(dbucket, dkey)
        headers = {
            self._COPY_SOURCE_HEADER: (
                f"/{sbucket}/{urllib.parse.quote(skey, safe='/-_.~')}"
            )
        }
        headers = self._signed_headers("PUT", url, headers, b"")
        resp = _request(url, "PUT", headers)
        try:
            body = resp.read()
        finally:
            resp.close()
        # S3 copy reports some failures inside a 200 body (API quirk)
        if b"<Error>" in body:
            raise Error(
                f"copy {src_uri} -> {dst_uri} failed: "
                f"{body[:300].decode(errors='replace')}"
            )

    def list_directory(self, uri: str) -> List[FileInfo]:
        """ListObjectsV2 with '/' delimiter (reference ListObjects,
        s3_filesys.cc:1018)."""
        bucket, key = self.split_uri(uri)
        prefix = key.rstrip("/")
        if prefix:
            prefix += "/"
        base = (
            f"{self.endpoint}/{bucket}"
            if self.endpoint
            else f"https://{bucket}.s3.{self.region}.amazonaws.com"
        )
        out: List[FileInfo] = []
        token = None
        while True:
            q = {
                "list-type": "2",
                "prefix": prefix,
                "delimiter": "/",
            }
            if token:
                q["continuation-token"] = token
            # quote_via=quote: S3 canonicalizes spaces as %20, and '+' in
            # the wire query would be decoded as a space server-side
            url = base + "/?" + urllib.parse.urlencode(
                sorted(q.items()), quote_via=urllib.parse.quote
            )
            body = self.request("GET", url)
            root = ET.fromstring(body)
            for el in root.iter():
                tag = el.tag.rsplit("}", 1)[-1]
                if tag == "Contents":
                    k = s = None
                    etag = ""
                    for child in el:
                        ctag = child.tag.rsplit("}", 1)[-1]
                        if ctag == "Key":
                            k = child.text
                        elif ctag == "Size":
                            s = int(child.text or 0)
                        elif ctag == "ETag":
                            etag = child.text or ""
                    if k and k != prefix:
                        out.append(
                            FileInfo(
                                f"{self.protocol}{bucket}/{k}",
                                s or 0,
                                "file",
                                etag,
                            )
                        )
                elif tag == "CommonPrefixes":
                    for child in el:
                        if child.tag.endswith("Prefix") and child.text:
                            out.append(
                                FileInfo(
                                    f"{self.protocol}{bucket}/{child.text}",
                                    0,
                                    "directory",
                                )
                            )
            nxt = [
                el.text
                for el in root.iter()
                if el.tag.endswith("NextContinuationToken")
            ]
            truncated = [
                el.text
                for el in root.iter()
                if el.tag.endswith("IsTruncated")
            ]
            if truncated and truncated[0] == "true" and nxt and nxt[0]:
                token = nxt[0]
            else:
                return out


# -- GCS OAuth (Application Default Credentials) -----------------------------


class OAuthTokenProvider:
    """Cached OAuth2 access token, refreshed ahead of expiry.

    Thread-safe: fused producers fan out over threads and all share the
    singleton filesystem instance."""

    _MARGIN = 120.0  # refresh this many seconds before expiry

    def __init__(self) -> None:
        self._token: Optional[str] = None
        self._refresh_at = 0.0  # soft deadline: refresh past this
        self._expiry = 0.0      # hard deadline: token invalid past this
        self._lock = threading.Lock()

    def token(self) -> str:
        with self._lock:
            now = time.time()  # noqa: L008 (token refresh/expiry deadlines are wall-clock)
            if self._token is not None and now < self._refresh_at:
                return self._token
            # the fetch runs under the lock, stalling every signing
            # thread: with a still-valid cached token to fall back on,
            # take ONE attempt (the early refresh retries on the next
            # request anyway); only a token-less fetch earns the full
            # retry schedule
            have_fallback = self._token is not None and now < self._expiry
            try:
                tok, ttl = self._fetch(
                    RetryPolicy(max_attempts=1) if have_fallback else None
                )
            except (OSError, Error, KeyError, ValueError):
                # transient fetch failure: a still-valid token (we refresh
                # _MARGIN early) must keep the job alive rather than
                # downgrading a mid-run refresh hiccup into hard failure
                if have_fallback:
                    return self._token
                raise
            ttl = max(float(ttl), 0.0)
            self._token = tok
            now = time.time()  # noqa: L008 (token refresh/expiry deadlines are wall-clock)
            # short-lived answers (metadata servers count expires_in
            # down) are still reused for half their life instead of
            # refetching per request once ttl < margin
            soft = ttl - self._MARGIN if ttl > 2 * self._MARGIN else ttl / 2
            self._refresh_at = now + soft
            self._expiry = now + ttl
            return self._token

    def _fetch(
        self, policy: Optional[RetryPolicy] = None
    ) -> Tuple[str, float]:
        raise NotImplementedError


class MetadataServerToken(OAuthTokenProvider):
    """GCE instance token from the metadata server, the default
    credential on a Google Cloud VM (HMAC interop keys are a legacy
    opt-in). Host overridable via GCE_METADATA_HOST (also the hermetic
    test hook)."""

    def __init__(self) -> None:
        super().__init__()
        host = os.environ.get("GCE_METADATA_HOST", "metadata.google.internal")
        self.url = (
            f"http://{host}/computeMetadata/v1/instance/"
            "service-accounts/default/token"
        )

    def _fetch(
        self, policy: Optional[RetryPolicy] = None
    ) -> Tuple[str, float]:
        resp = _request(
            self.url, headers={"Metadata-Flavor": "Google"}, timeout=2.0,
            policy=policy,
        )
        try:
            body = json.loads(resp.read())
        finally:
            resp.close()
        return body["access_token"], float(body.get("expires_in", 300))


class ServiceAccountToken(OAuthTokenProvider):
    """GOOGLE_APPLICATION_CREDENTIALS service-account key → RS256 JWT →
    access token (the OAuth2 jwt-bearer grant). Token endpoint
    overridable for tests via GCS_TOKEN_URI."""

    SCOPE = "https://www.googleapis.com/auth/devstorage.read_write"

    def __init__(self, path: str) -> None:
        super().__init__()
        try:
            with open(path) as f:
                info = json.load(f)
        except (OSError, ValueError) as e:
            raise Error(
                f"bad GOOGLE_APPLICATION_CREDENTIALS file {path!r}: {e}"
            ) from e
        check(
            info.get("type") == "service_account",
            f"{path}: not a service_account key (type={info.get('type')!r})",
        )
        check(
            "client_email" in info and "private_key" in info,
            f"{path}: service_account key missing client_email/private_key",
        )
        self.email = info["client_email"]
        self.private_key_pem = info["private_key"].encode()
        self.token_uri = os.environ.get(
            "GCS_TOKEN_URI", info.get("token_uri",
                                      "https://oauth2.googleapis.com/token")
        )

    @staticmethod
    def _b64(data: bytes) -> bytes:
        return base64.urlsafe_b64encode(data).rstrip(b"=")

    def _jwt(self, now: float) -> bytes:
        try:
            from cryptography.hazmat.primitives import hashes, serialization
            from cryptography.hazmat.primitives.asymmetric import padding
        except ImportError as e:  # an optional package, absent on some hosts
            raise Error(
                "service-account gs:// auth needs the 'cryptography' "
                "package for RS256 signing; use HMAC interop keys "
                "(GS_ACCESS_KEY_ID) or metadata-server credentials instead"
            ) from e
        header = self._b64(json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
        claims = self._b64(json.dumps({
            "iss": self.email,
            "scope": self.SCOPE,
            "aud": self.token_uri,
            "iat": int(now),
            "exp": int(now) + 3600,
        }).encode())
        signing_input = header + b"." + claims
        key = serialization.load_pem_private_key(
            self.private_key_pem, password=None
        )
        sig = key.sign(signing_input, padding.PKCS1v15(), hashes.SHA256())
        return signing_input + b"." + self._b64(sig)

    def _fetch(
        self, policy: Optional[RetryPolicy] = None
    ) -> Tuple[str, float]:
        payload = urllib.parse.urlencode({
            "grant_type": "urn:ietf:params:oauth:grant-type:jwt-bearer",
            "assertion": self._jwt(time.time()).decode(),  # noqa: L008 (JWT iat/exp claims are wall-clock by spec)
        }).encode()
        resp = _request(
            self.token_uri, "POST", {
                "Content-Type": "application/x-www-form-urlencoded",
            }, payload, policy=policy,
        )
        try:
            body = json.loads(resp.read())
        finally:
            resp.close()
        return body["access_token"], float(body.get("expires_in", 3600))


class GCSFileSystem(S3FileSystem):
    """gs:// via the GCS XML API with Application Default Credentials.

    Credential resolution (the ADC order, on the stdlib HTTP client):

    1. HMAC interop keys (GS_ACCESS_KEY_ID / GS_SECRET_ACCESS_KEY) →
       SigV4, the S3-compatible legacy path — explicit override;
    2. GOOGLE_APPLICATION_CREDENTIALS service-account JSON → RS256 JWT
       exchanged for an OAuth token;
    3. GCE metadata server → instance OAuth token (the default on a
       Google Cloud VM); probed lazily, failure cached, so
       non-GCE hosts fall through to
    4. anonymous (public buckets).

    Endpoint override GCS_ENDPOINT (also the hermetic-test hook).
    NO_GCE_CHECK=1 skips the metadata probe (google-auth convention).
    """

    protocol = "gs://"

    _PROBE_RETRY = 60.0  # seconds between metadata probes after a failure

    def __init__(self) -> None:
        super().__init__()
        # GS_* ONLY — inheriting the AWS/S3 env creds here would SigV4-
        # sign gs:// requests with AWS keys on any host that also talks
        # to s3://, shadowing working ADC credentials with guaranteed
        # 403s
        self.access_key = os.environ.get("GS_ACCESS_KEY_ID", "")
        self.secret_key = os.environ.get("GS_SECRET_ACCESS_KEY", "")
        # GCS_ENDPOINT only — falling back to S3_ENDPOINT would silently
        # route gs:// traffic to an S3-targeting override
        self.endpoint = os.environ.get(
            "GCS_ENDPOINT", "https://storage.googleapis.com"
        )
        self.signer = (
            SigV4Signer(
                self.access_key, self.secret_key, self.region, "s3",
                self.session_token,
            )
            if self.access_key
            else None
        )
        self._oauth: Optional[OAuthTokenProvider] = None
        self._probe_fail_until = 0.0
        if self.signer is None:
            sa_path = os.environ.get("GOOGLE_APPLICATION_CREDENTIALS")
            if sa_path:
                self._oauth = ServiceAccountToken(sa_path)
            elif os.environ.get("NO_GCE_CHECK", "0") != "1":
                self._oauth = MetadataServerToken()

    @property
    def _oauth_failed(self) -> bool:
        """True while inside the post-failure probe backoff window."""
        return time.time() < self._probe_fail_until  # noqa: L008 (probe backoff window is wall-clock)

    _COPY_SOURCE_HEADER = "x-goog-copy-source"  # GCS XML interop spelling

    def _delete_batch(self, bucket: str, keys: List[str]) -> None:
        """GCS's XML interop API has no DeleteObjects POST — per-object
        DELETEs (the JSON batch API is a different protocol stack)."""
        for k in keys:
            self.request("DELETE", self.object_url(bucket, k))

    def _signed_headers(
        self, method: str, url: str, headers: Dict[str, str], payload: bytes
    ) -> Dict[str, str]:
        if self.signer is not None:
            return super()._signed_headers(method, url, headers, payload)
        if self._oauth is not None and not self._oauth_failed:
            try:
                token = self._oauth.token()
            except (OSError, Error, KeyError, ValueError):
                if isinstance(self._oauth, MetadataServerToken):
                    # no reachable metadata server: back off to anonymous
                    # for a window, then re-probe — NOT latched forever,
                    # or one transient timeout on a real cloud VM would
                    # silently downgrade a private-bucket job to 401s
                    self._probe_fail_until = time.time() + self._PROBE_RETRY  # noqa: L008 (probe backoff window is wall-clock)
                    return headers
                raise  # explicit service-account config must fail loudly
            out = dict(headers)
            out["Authorization"] = f"Bearer {token}"
            return out
        return headers


# -- WebHDFS -----------------------------------------------------------------


class WebHdfsWriteStream(Stream):
    """Buffered WebHDFS writer.

    WebHDFS writes are a two-step dance: the namenode answers the
    ``CREATE``/``APPEND`` operation with a 307 redirect naming the
    datanode, and the payload goes to that Location (urllib refuses to
    auto-follow redirects for PUT/POST, which is exactly right here —
    the first request must carry no body). The first flushed part runs
    ``CREATE`` (PUT), later parts ``APPEND`` (POST), so large files
    stream in bounded memory. Part size via DMLC_WEBHDFS_WRITE_BUFFER_MB
    (default 16; DMLC_WEBHDFS_WRITE_BUFFER_BYTES is the test hook).
    """

    def __init__(
        self, fs: "WebHdfsFileSystem", uri: str, append: bool = False
    ) -> None:
        self.fs = fs
        self.uri = uri
        if "DMLC_WEBHDFS_WRITE_BUFFER_BYTES" in os.environ:  # test hook
            self.part_bytes = int(os.environ["DMLC_WEBHDFS_WRITE_BUFFER_BYTES"])
        else:
            mb = int(os.environ.get("DMLC_WEBHDFS_WRITE_BUFFER_MB", "16"))
            self.part_bytes = max(1, mb) << 20
        self._buf = bytearray()
        # append mode continues an existing file; a missing one is created
        self._created = append and fs.exists(uri)
        self._closed = False

    def read(self, n: int = -1) -> bytes:
        raise Error("WebHdfsWriteStream is write-only")

    def write(self, data) -> int:
        self._buf.extend(data)
        while len(self._buf) >= self.part_bytes:
            self._flush_part(bytes(self._buf[: self.part_bytes]))
            del self._buf[: self.part_bytes]
        return len(data)

    def _flush_part(self, payload: bytes) -> None:
        if not self._created:
            # CREATE with overwrite=true is idempotent: a retried upload
            # rewrites the same first part
            url = self.fs._url(self.uri, "CREATE", overwrite="true")
            self.fs._two_step(url, "PUT", payload)
            self._created = True
            return
        # APPEND is NOT idempotent (a lost response after the commit
        # would duplicate the part on retry) — fail loudly instead
        url = self.fs._url(self.uri, "APPEND")
        self.fs._two_step(url, "POST", payload, idempotent=False)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # an empty buffer still CREATEs in 'w' mode (empty file lands)
        if self._buf or not self._created:
            self._flush_part(bytes(self._buf))
            self._buf.clear()


class WebHdfsFileSystem(FileSystem):
    """hdfs:// via the WebHDFS REST API (op=OPEN/GETFILESTATUS/LISTSTATUS/
    CREATE/APPEND/RENAME/DELETE).

    The reference wraps libhdfs over JNI (src/io/hdfs_filesys.cc); REST
    needs no JVM on the host. Namenode HTTP port from
    DMLC_WEBHDFS_PORT (default 9870); user from DMLC_HDFS_USER/$USER.
    """

    protocol = "hdfs://"

    def __init__(self) -> None:
        self.http_port = int(os.environ.get("DMLC_WEBHDFS_PORT", "9870"))
        self.user = os.environ.get(
            "DMLC_HDFS_USER", os.environ.get("USER", "root")
        )
        self.scheme = os.environ.get("DMLC_WEBHDFS_SCHEME", "http")

    def _base(self, uri: str) -> Tuple[str, str]:
        u = URI(uri)
        host = u.host
        port = self.http_port
        if ":" in host:
            host, hdfs_port = host.rsplit(":", 1)
            # hdfs:// rpc port in the URI; WebHDFS port still applies
            _ = hdfs_port
        path = u.path if u.path.startswith("/") else "/" + u.path
        return f"{self.scheme}://{host}:{port}/webhdfs/v1", path

    def _url(self, uri: str, op: str, **params) -> str:
        base, path = self._base(uri)
        q = {"op": op, "user.name": self.user, **params}
        return base + urllib.parse.quote(path) + "?" + urllib.parse.urlencode(q)

    def _two_step(
        self,
        op_url: str,
        method: str,
        payload: bytes,
        idempotent: bool = True,
    ) -> None:
        """Namenode op → 307 Location → datanode payload upload. Also
        accepts ``noredirect``-style servers that answer 200 with a JSON
        ``Location`` instead of redirecting.

        ``idempotent=False`` disables retry on the DATANODE leg (the
        namenode leg carries no body and always retries): APPEND is not
        idempotent — a response lost after the server committed the
        bytes would duplicate the part on re-POST, silently corrupting
        the file. Better the loud failure."""
        location: Optional[str] = None
        try:
            resp = _request(op_url, method)
        except HttpError as e:
            if e.status not in (301, 302, 307):
                raise
            location = e.header("Location")
            check(
                bool(location),
                f"webhdfs {method} redirect for {op_url} carries no Location",
            )
        else:
            try:
                body = resp.read()
            finally:
                resp.close()
            if body:
                try:
                    location = json.loads(body).get("Location")
                except ValueError:
                    location = None
            check(
                bool(location),
                f"webhdfs {method} {op_url}: expected a datanode redirect "
                "or a JSON Location",
            )
        resp = _request(
            location,  # type: ignore[arg-type]
            method,
            {"Content-Type": "application/octet-stream"},
            payload,
            policy=None if idempotent else RetryPolicy(max_attempts=1),
        )
        resp.close()

    def open(self, uri: str, mode: str = "r") -> Stream:
        if mode in ("w", "wb", "a"):
            return WebHdfsWriteStream(self, uri, append=(mode == "a"))
        check(mode in ("r", "rb"), f"invalid webhdfs mode {mode!r}")
        info = self.get_path_info(uri)

        def prepare(pos: int, headers: Dict[str, str]):
            params = {"offset": pos} if pos else {}
            return self._url(uri, "OPEN", **params), headers

        return HttpReadStream(
            self._url(uri, "OPEN"), size=info.size, prepare=prepare
        )

    def rename(self, src_uri: str, dst_uri: str) -> None:
        """op=RENAME — atomic within HDFS (the namenode metadata swap),
        which makes hdfs:// checkpoints genuinely atomic-rename like
        local files. HDFS refuses to rename over an existing file, so a
        present destination is deleted first (re-save into the same
        step)."""
        _, dst_path = self._base(dst_uri)
        for attempt in range(2):
            url = self._url(src_uri, "RENAME", destination=dst_path)
            resp = _request(url, "PUT")
            try:
                ok = json.loads(resp.read() or b"{}").get("boolean", False)
            finally:
                resp.close()
            if ok:
                return
            if attempt == 0 and self.exists(dst_uri):
                self.delete(dst_uri)
                continue
            raise Error(f"webhdfs rename {src_uri} -> {dst_uri} refused")

    def get_path_info(self, uri: str) -> FileInfo:
        body = _read_all(self._url(uri, "GETFILESTATUS"))
        st = json.loads(body)["FileStatus"]
        ftype = "directory" if st["type"] == "DIRECTORY" else "file"
        # HDFS has no ETag; modificationTime (epoch millis) is the
        # namenode's change token and serves the same cache-identity job
        mtime = st.get("modificationTime")
        return FileInfo(
            uri, int(st.get("length", 0)), ftype,
            str(mtime) if mtime else "",
        )

    def delete(self, uri: str, recursive: bool = False) -> None:
        url = self._url(
            uri, "DELETE", recursive="true" if recursive else "false"
        )
        resp = _request(url, "DELETE")
        try:
            ok = json.loads(resp.read() or b"{}").get("boolean", False)
        finally:
            resp.close()
        check(ok, f"webhdfs delete refused for {uri}")

    def list_directory(self, uri: str) -> List[FileInfo]:
        body = _read_all(self._url(uri, "LISTSTATUS"))
        statuses = json.loads(body)["FileStatuses"]["FileStatus"]
        out = []
        base = uri.rstrip("/")
        for st in statuses:
            ftype = "directory" if st["type"] == "DIRECTORY" else "file"
            mtime = st.get("modificationTime")
            out.append(
                FileInfo(
                    f"{base}/{st['pathSuffix']}",
                    int(st.get("length", 0)),
                    ftype,
                    str(mtime) if mtime else "",
                )
            )
        return out


def _read_all(url: str) -> bytes:
    resp = _request(url)
    try:
        return resp.read()
    finally:
        resp.close()


# -- Azure Blob --------------------------------------------------------------


class AzureBlobFileSystem(FileSystem):
    """azure://container/blob for SAS-token or public containers.

    Account from AZURE_STORAGE_ACCOUNT, optional SAS from
    AZURE_STORAGE_SAS_TOKEN, endpoint override AZURE_ENDPOINT. Read +
    list; the reference's Azure backend is itself partial (list-only,
    open stubbed — azure_filesys.h:22-32), so this is a superset.
    """

    protocol = "azure://"

    def __init__(self) -> None:
        self.account = os.environ.get("AZURE_STORAGE_ACCOUNT", "")
        self.sas = os.environ.get("AZURE_STORAGE_SAS_TOKEN", "").lstrip("?")
        self.endpoint = os.environ.get(
            "AZURE_ENDPOINT",
            f"https://{self.account}.blob.core.windows.net",
        )

    def _url(self, uri: str, **params) -> str:
        u = URI(uri)
        path = f"{u.host}{u.path}"
        url = f"{self.endpoint}/{urllib.parse.quote(path)}"
        q = urllib.parse.urlencode(params)
        extras = "&".join(x for x in (q, self.sas) if x)
        return url + ("?" + extras if extras else "")

    def open(self, uri: str, mode: str = "r") -> Stream:
        check(mode in ("r", "rb"), "azure backend is read-only")
        info = self.get_path_info(uri)

        def prepare(pos: int, headers: Dict[str, str]):
            h = dict(headers)
            if pos:
                h["Range"] = f"bytes={pos}-"
            return self._url(uri), h

        return HttpReadStream(self._url(uri), size=info.size, prepare=prepare)

    def get_path_info(self, uri: str) -> FileInfo:
        resp = _request(self._url(uri), "HEAD")
        size = int(resp.headers.get("Content-Length") or 0)
        etag = resp.headers.get("ETag") or ""
        resp.close()
        return FileInfo(uri, size, "file", etag)

    def delete(self, uri: str, recursive: bool = False) -> None:
        if recursive:
            infos = self.list_directory(uri)
            if infos:
                for info in infos:
                    _request(self._url(info.path), "DELETE").close()
                return
        _request(self._url(uri), "DELETE").close()

    def list_directory(self, uri: str) -> List[FileInfo]:
        u = URI(uri)
        container = u.host
        prefix = u.path.lstrip("/")
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        out: List[FileInfo] = []
        marker = ""
        while True:  # List Blobs pages at 5000 entries via NextMarker
            url = (
                f"{self.endpoint}/{container}?restype=container&comp=list"
                + (f"&prefix={urllib.parse.quote(prefix)}" if prefix else "")
                + (f"&marker={urllib.parse.quote(marker)}" if marker else "")
                + (f"&{self.sas}" if self.sas else "")
            )
            root = ET.fromstring(_read_all(url))
            for blob in root.iter("Blob"):
                name = blob.findtext("Name") or ""
                size = int(blob.findtext("Properties/Content-Length") or 0)
                etag = blob.findtext("Properties/Etag") or ""
                out.append(
                    FileInfo(
                        f"{self.protocol}{container}/{name}", size, "file",
                        etag,
                    )
                )
            marker = root.findtext("NextMarker") or ""
            if not marker:
                return out


# -- registration ------------------------------------------------------------

_SINGLETONS: Dict[str, FileSystem] = {}


def _singleton(cls):
    def make() -> FileSystem:
        inst = _SINGLETONS.get(cls.__name__)
        if inst is None:
            inst = cls()
            _SINGLETONS[cls.__name__] = inst
        return inst

    return make


def reset_singletons() -> None:
    """Drop cached instances (tests change env between cases)."""
    _SINGLETONS.clear()


for _proto, _cls in [
    ("http://", HttpFileSystem),
    ("https://", HttpFileSystem),
    ("s3://", S3FileSystem),
    ("gs://", GCSFileSystem),
    ("hdfs://", WebHdfsFileSystem),
    ("viewfs://", WebHdfsFileSystem),
    ("azure://", AzureBlobFileSystem),
]:
    FS_REGISTRY.setdefault(_proto, _singleton(_cls))
