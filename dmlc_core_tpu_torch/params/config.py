"""``key = value`` config-file parser (the port of
``dmlc_core_tpu/params/config.py``).

Reference: include/dmlc/config.h (Config, config.h:40-175) + src/config.cc
tokenizer FSM (config.cc:30-128). Feature parity:

- ``#`` comments to end of line
- quoted string values with escape handling ("\\"", "\\n", "\\\\")
- multi-value mode: repeated keys accumulate instead of overwrite
  (config.h:57-60)
- proto-style string output (config.h:102; ToProtoString)
- iteration in insertion order
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from ..utils.logging import Error

__all__ = ["Config"]


def _tokenize(text: str) -> List[str]:
    """FSM tokenizer over k = v pairs (reference config.cc:30-128)."""
    tokens: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c.isspace():
            i += 1
        elif c == "=":
            tokens.append("=")
            i += 1
        elif c == '"':
            i += 1
            buf = []
            closed = False
            while i < n:
                ch = text[i]
                if ch == "\\" and i + 1 < n:
                    nxt = text[i + 1]
                    buf.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(nxt, nxt))
                    i += 2
                elif ch == '"':
                    i += 1
                    closed = True
                    break
                else:
                    buf.append(ch)
                    i += 1
            if not closed:
                raise Error("Config: unterminated quoted string")
            tokens.append('"' + "".join(buf))  # marker prefix, stripped later
        else:
            j = i
            while j < n and not text[j].isspace() and text[j] not in "=#":
                j += 1
            tokens.append(text[i:j])
            i = j
    return tokens


class Config:
    """Ordered key=value config with optional multi-value semantics."""

    def __init__(self, text: str = "", multi_value: bool = False) -> None:
        self.multi_value = multi_value
        self._order: List[Tuple[str, str]] = []
        self._map: Dict[str, List[str]] = {}
        if text:
            self.load(text)

    def load(self, text: str) -> None:
        tokens = _tokenize(text)
        for i in range(0, len(tokens), 3):
            key = tokens[i]
            if key == "=" or key.startswith('"'):
                raise Error(f"Config: invalid key {key!r}")
            if i + 2 >= len(tokens) or tokens[i + 1] != "=":
                raise Error(f"Config: expected 'key = value' near {key!r}")
            val = tokens[i + 2]
            if val == "=":
                raise Error(f"Config: invalid value '=' for key {key!r}")
            if val.startswith('"'):
                val = val[1:]
            self.set(key, val)

    def set(self, key: str, value: str) -> None:
        value = str(value)
        if key in self._map and not self.multi_value:
            # overwrite: drop previous from order
            self._order = [(k, v) for (k, v) in self._order if k != key]
            self._map[key] = [value]
        else:
            self._map.setdefault(key, [] if self.multi_value else [])
            if self.multi_value:
                self._map[key].append(value)
            else:
                self._map[key] = [value]
        self._order.append((key, value))

    def get(self, key: str) -> str:
        """Latest value for key (reference GetParam, config.h:70-76)."""
        vals = self._map.get(key)
        if not vals:
            raise Error(f"Config: key {key!r} not found")
        return vals[-1]

    def get_all(self, key: str) -> List[str]:
        return list(self._map.get(key, []))

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        """Iterate (key, value) in insertion order (reference iterator,
        config.h:110-150)."""
        return iter(self._order)

    def to_proto_string(self) -> str:
        """proto-style 'key : "value"' lines (reference ToProtoString,
        config.h:102)."""
        out = []
        for key, val in self._order:
            esc = val.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
            out.append(f'{key} : "{esc}"')
        return "\n".join(out) + ("\n" if out else "")
