"""Binary serialization over Streams (the port of
``dmlc_core_tpu/io/serializer.py``, with the same wire format byte for
byte; reference include/dmlc/serializer.h and Stream::Write<T>/Read<T>,
include/dmlc/io.h:450-472):

- arithmetic scalars: the little-endian bytes of the C type
  (serializer.h:83-100);
- string/bytes: uint64 length + raw bytes (serializer.h:176-190);
- vector<T>: uint64 size + elements (serializer.h:130-170);
- pair/map/set/list: composed from the above (serializer.h:300-380).

numpy arrays serialize as dtype-tagged, shape-prefixed vectors, and the
generic ``save``/``load`` prefix each value with a one-byte type tag.
"""

from __future__ import annotations

import struct
from typing import Any, Union

import numpy as np

from ..utils.logging import Error
from .stream import Stream

__all__ = [
    "write_scalar",
    "read_scalar",
    "try_read_scalar",
    "write_bytes",
    "read_bytes",
    "write_str",
    "read_str",
    "write_ndarray",
    "read_ndarray",
    "save",
    "load",
]

_FMT = {
    "int8": "<b",
    "uint8": "<B",
    "int32": "<i",
    "uint32": "<I",
    "int64": "<q",
    "uint64": "<Q",
    "float32": "<f",
    "float64": "<d",
    "bool": "<B",
}


def write_scalar(stream: Stream, value: Union[int, float, bool], ctype: str) -> None:
    """Write one scalar as its little-endian C representation."""
    fmt = _FMT.get(ctype)
    if fmt is None:
        raise Error(f"unknown scalar ctype {ctype!r}")
    stream.write(struct.pack(fmt, value))


def read_scalar(stream: Stream, ctype: str):
    fmt = _FMT.get(ctype)
    if fmt is None:
        raise Error(f"unknown scalar ctype {ctype!r}")
    size = struct.calcsize(fmt)
    data = stream.read_exact(size)
    return struct.unpack(fmt, data)[0]


def try_read_scalar(stream: Stream, ctype: str):
    """Read-or-None at EOF (reference Read<T> returns bool)."""
    fmt = _FMT[ctype]
    size = struct.calcsize(fmt)
    data = stream.read(size)
    if len(data) == 0:
        return None
    if len(data) != size:
        raise Error("Serializer: truncated scalar")
    return struct.unpack(fmt, data)[0]


def write_bytes(stream: Stream, data: bytes) -> None:
    """uint64 length + raw (reference serializer.h:176-190)."""
    stream.write(struct.pack("<Q", len(data)))
    if data:
        stream.write(data)


def read_bytes(stream: Stream) -> bytes:
    n = read_scalar(stream, "uint64")
    return stream.read_exact(n) if n else b""


def write_str(stream: Stream, s: str) -> None:
    write_bytes(stream, s.encode("utf-8"))


def read_str(stream: Stream) -> str:
    return read_bytes(stream).decode("utf-8")


# numpy dtype tag ↔ dtype; the on-wire tag is the dtype's string name.
def write_ndarray(stream: Stream, arr: np.ndarray) -> None:
    """dtype-tagged, shape-prefixed contiguous array.

    Layout: str(dtype) | uint32 ndim | uint64 shape[ndim] | raw LE data;
    the reference's vector<T> (serializer.h:130-147) is its 1-D case.
    """
    # NOT ascontiguousarray: it promotes 0-d arrays to 1-d, silently
    # changing the shape on the wire (scalars in checkpoint pytrees)
    arr = np.asarray(arr, order="C")
    write_str(stream, str(arr.dtype))
    write_scalar(stream, arr.ndim, "uint32")
    for d in arr.shape:
        write_scalar(stream, d, "uint64")
    data = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    stream.write(data.tobytes())


def read_ndarray(stream: Stream) -> np.ndarray:
    dtype = np.dtype(read_str(stream))
    ndim = read_scalar(stream, "uint32")
    shape = tuple(read_scalar(stream, "uint64") for _ in range(ndim))
    count = int(np.prod(shape)) if shape else 1
    raw = stream.read_exact(count * dtype.itemsize)
    arr = np.frombuffer(raw, dtype=dtype.newbyteorder("<"), count=count)
    arr = arr.astype(dtype, copy=False).reshape(shape)
    if not arr.flags.writeable:
        arr = arr.copy()  # frombuffer views are read-only; consumers mutate
    return arr


# -- generic typed save/load -------------------------------------------------
# Type tags of the dynamic save/load path (the reference has static C++
# types; Python needs a tag byte). They are on the wire: never renumber.
_TAG_NONE = 0
_TAG_BOOL = 1
_TAG_INT = 2
_TAG_FLOAT = 3
_TAG_STR = 4
_TAG_BYTES = 5
_TAG_LIST = 6
_TAG_DICT = 7
_TAG_TUPLE = 8
_TAG_NDARRAY = 9


def save(stream: Stream, obj: Any) -> None:
    """Serialize a composite of scalars/str/bytes/list/dict/tuple/ndarray.

    The Python analogue of Stream::Write<T> over arbitrary STL graphs
    (reference io.h:60-106, serializer.h:300-380).
    """
    if obj is None:
        write_scalar(stream, _TAG_NONE, "uint8")
    elif isinstance(obj, bool):
        write_scalar(stream, _TAG_BOOL, "uint8")
        write_scalar(stream, obj, "bool")
    elif isinstance(obj, int):
        if not (-(1 << 63) <= obj < (1 << 63)):
            raise Error(f"cannot serialize int outside int64 range: {obj}")
        write_scalar(stream, _TAG_INT, "uint8")
        write_scalar(stream, obj, "int64")
    elif isinstance(obj, float):
        write_scalar(stream, _TAG_FLOAT, "uint8")
        write_scalar(stream, obj, "float64")
    elif isinstance(obj, str):
        write_scalar(stream, _TAG_STR, "uint8")
        write_str(stream, obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        write_scalar(stream, _TAG_BYTES, "uint8")
        write_bytes(stream, bytes(obj))
    elif isinstance(obj, list):
        write_scalar(stream, _TAG_LIST, "uint8")
        write_scalar(stream, len(obj), "uint64")
        for item in obj:
            save(stream, item)
    elif isinstance(obj, tuple):
        write_scalar(stream, _TAG_TUPLE, "uint8")
        write_scalar(stream, len(obj), "uint64")
        for item in obj:
            save(stream, item)
    elif isinstance(obj, dict):
        write_scalar(stream, _TAG_DICT, "uint8")
        write_scalar(stream, len(obj), "uint64")
        for k, v in obj.items():
            save(stream, k)
            save(stream, v)
    elif isinstance(obj, np.ndarray):
        write_scalar(stream, _TAG_NDARRAY, "uint8")
        write_ndarray(stream, obj)
    elif isinstance(obj, (np.integer,)):
        save(stream, int(obj))
    elif isinstance(obj, (np.floating,)):
        save(stream, float(obj))
    else:
        raise Error(f"cannot serialize object of type {type(obj).__name__}")


def load(stream: Stream) -> Any:
    tag = read_scalar(stream, "uint8")
    if tag == _TAG_NONE:
        return None
    if tag == _TAG_BOOL:
        return bool(read_scalar(stream, "bool"))
    if tag == _TAG_INT:
        return read_scalar(stream, "int64")
    if tag == _TAG_FLOAT:
        return read_scalar(stream, "float64")
    if tag == _TAG_STR:
        return read_str(stream)
    if tag == _TAG_BYTES:
        return read_bytes(stream)
    if tag in (_TAG_LIST, _TAG_TUPLE):
        n = read_scalar(stream, "uint64")
        items = [load(stream) for _ in range(n)]
        return tuple(items) if tag == _TAG_TUPLE else items
    if tag == _TAG_DICT:
        n = read_scalar(stream, "uint64")
        out = {}
        for _ in range(n):
            k = load(stream)
            out[k] = load(stream)
        return out
    if tag == _TAG_NDARRAY:
        return read_ndarray(stream)
    raise Error(f"Serializer: unknown tag {tag}")
