"""Token parsing helpers for text formats.

Reference: include/dmlc/strtonum.h — locale-independent ParseFloat/ParsePair
(:656-681) / ParseTriple (:697-737), the hot inner loop of all text parsers.

The hot loop lives in the native core (``native/fastparse.cc``); these
helpers define the exact semantics of the plain parsers. Python's
float() is already locale-independent, matching the reference's motivation
for hand-rolled strtof.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = [
    "parse_pair",
    "parse_triple",
    "parse_float_token",
    "parse_int_token",
    "I64_MIN",
    "I64_MAX",
]

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def parse_float_token(tok: bytes) -> Optional[float]:
    """Full-token float with C-compatible grammar: PEP-515 underscores are
    rejected (the native core's from_chars never accepts them); overflow
    gives ±inf like strtod."""
    if b"_" in tok:
        return None
    try:
        return float(tok)
    except ValueError:
        return None


def parse_int_token(tok: bytes) -> Optional[int]:
    """Full-token base-10 int, C-compatible: no underscores, and values
    outside int64 are rejected (they cannot land in the CSR arrays; the
    native core's from_chars errors the same way)."""
    if b"_" in tok:
        return None
    try:
        v = int(tok)
    except ValueError:
        return None
    if not (I64_MIN <= v <= I64_MAX):
        return None
    return v


def parse_pair(token: bytes) -> Optional[Tuple[float, Optional[float]]]:
    """Parse ``a`` or ``a:b`` (reference ParsePair, strtonum.h:656-681).

    Returns (a, None) / (a, b), or None when the token is not numeric
    (the reference's r<1 'empty' result)."""
    c = token.find(b":")
    if c < 0:
        a = parse_float_token(token)
        return None if a is None else (a, None)
    a = parse_float_token(token[:c])
    b = parse_float_token(token[c + 1:])
    if a is None or b is None:
        return None
    return a, b


def parse_triple(
    token: bytes,
) -> Optional[Tuple[int, int, Optional[float]]]:
    """Parse ``a:b`` or ``a:b:c`` (reference ParseTriple, strtonum.h:697-737).

    Returns (a, b, None) / (a, b, c); None when fewer than two numbers parse
    (the reference's r<=1 skip)."""
    c1 = token.find(b":")
    if c1 < 0:
        return None
    c2 = token.find(b":", c1 + 1)
    a = parse_int_token(token[:c1])
    if a is None:
        return None
    if c2 < 0:
        b = parse_int_token(token[c1 + 1:])
        return None if b is None else (a, b, None)
    b = parse_int_token(token[c1 + 1: c2])
    v = parse_float_token(token[c2 + 1:])
    if b is None or v is None:
        return None
    return a, b, v
