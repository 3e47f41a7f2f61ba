"""Dataset URIs: a path with ``?k=v&...`` options and an optional
``#cachefile`` hint, and the protocol/host/path split of a URI (the port
of ``dmlc_core_tpu/io/uri.py``; reference src/io/uri_spec.h:21-75)::

    /data/train.csv?format=csv&label_column=0
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

from ..utils.logging import Error

__all__ = ["URI", "URISpec", "rejoin_query", "uri_int"]


def uri_int(
    args: Mapping[str, str],
    key: str,
    default: int,
    minimum: Optional[int] = None,
) -> int:
    """Integer URI option with an error that names the bad parameter;
    ``minimum`` rejects values below it the same way."""
    raw = args.get(key)
    if raw is None:
        return default
    try:
        value = int(raw)
    except (TypeError, ValueError):
        raise Error(f"URI option {key}={raw!r} is not an integer") from None
    if minimum is not None and value < minimum:
        raise Error(f"URI option {key}={value} must be >= {minimum}")
    return value


def rejoin_query(args: Mapping[str, str]) -> str:
    """``?k=v&...`` of parsed URI args ('' when empty), the inverse of
    URISpec's query parse."""
    if not args:
        return ""
    return "?" + "&".join(f"{k}={v}" for k, v in args.items())


class URISpec:
    """URI + ``?k=v&k2=v2`` args + ``#cachefile`` hint; the cache file of
    part ``i`` of ``n`` > 1 gets a ``.splitN.partI`` suffix."""

    __slots__ = ("uri", "args", "cache_file")

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1) -> None:
        self.args: Dict[str, str] = {}
        self.cache_file = ""
        base = uri
        if "#" in base:
            base, _, cache = base.partition("#")
            if num_parts != 1:
                cache = f"{cache}.split{num_parts}.part{part_index}"
            self.cache_file = cache
        if "?" in base:
            base, _, query = base.partition("?")
            for kv in query.split("&"):
                if not kv:
                    continue
                k, _, v = kv.partition("=")
                self.args[k] = v
        self.uri = base

    def __repr__(self) -> str:
        return f"URISpec(uri={self.uri!r}, args={self.args}, cache={self.cache_file!r})"


class URI:
    """protocol/host/path decomposition (reference io.h:525-559).

    ``file:///a/b`` → protocol='file://', host='', path='/a/b'
    ``/a/b``        → protocol='', host='', path='/a/b'
    ``gs://b/k``    → protocol='gs://', host='b', path='/k'
    """

    __slots__ = ("protocol", "host", "path")

    def __init__(self, uri: str) -> None:
        pos = uri.find("://")
        if pos < 0:
            self.protocol, rest = "", uri
        else:
            self.protocol, rest = uri[:pos + 3], uri[pos + 3:]
        if self.protocol in ("", "file://"):
            # a local path keeps everything as its path
            self.host, self.path = "", rest
        else:
            slash = rest.find("/")
            if slash < 0:
                self.host, self.path = rest, ""
            else:
                self.host, self.path = rest[:slash], rest[slash:]

    @property
    def name(self) -> str:
        """Canonical string form (reference URI::name)."""
        return f"{self.protocol}{self.host}{self.path}"

    def __repr__(self) -> str:
        return f"URI({self.name!r})"
