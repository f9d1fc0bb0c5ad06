"""A reader for the YAML subset of the pyslowfast configs
(config/slowfast-configs/**/*.yaml), without PyYAML (the card machine has
none).

It reads block mappings nested by indentation, ``#`` comments, and flow
sequences (nested, over several lines, with a trailing comma) of plain
scalars and of quoted ones without escapes. Plain scalars resolve as
PyYAML's ``safe_load`` resolves them (YAML 1.1): booleans (``True``,
``off``, ...), null, ints (decimal, ``0x``, ``0b``, octal ``0...``) and
floats only with a dot, so ``1e-4`` stays the string ``'1e-4'``, as it
does there. Anything else of YAML (flow mappings, escapes, block
sequences, anchors, tags, block scalars, sexagesimal numbers, timestamps)
raises ``ValueError``. tests/test_torch_slowfast_yaml.py
holds it equal to ``yaml.safe_load`` on every file of that tree.
"""
from __future__ import annotations

import re
from typing import Any, List, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|"
                   r"FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# what PyYAML would resolve to a type this reader does not build
_UNSUPPORTED = re.compile(r"^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+"
                          r"(?:\.[0-9_]*)?|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*"
                          r"|<<|=)$")


def resolve_plain(text: str) -> Any:
    """A plain scalar's value under PyYAML's implicit resolvers."""
    if _UNSUPPORTED.match(text):
        raise ValueError(f"unsupported YAML scalar {text!r}")
    if _BOOL.match(text):
        return text in _TRUE
    if _NULL.match(text):
        return None
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if t != "0" and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t[0] == "-" else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        return float(t)
    return text


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (one at the line's start or after
    a blank, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Flow:
    """A recursive-descent reader of one flow sequence."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def _ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def value(self) -> Any:
        self._ws()
        ch = self.s[self.i]
        if ch == "[":
            return self._seq()
        if ch in "\"'":
            end = self.s.index(ch, self.i + 1)
            text = self.s[self.i + 1:end]
            if "\n" in text or (ch == '"' and "\\" in text) or (
                    ch == "'" and self.s[end + 1:end + 2] == "'"):
                raise ValueError(f"unsupported YAML quoted scalar {text!r}")
            self.i = end + 1
            return text
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in ",]":
            self.i += 1
        text = " ".join(self.s[start:self.i].split())
        if text[:1] and text[0] in "{}&*!|>?:":
            raise ValueError(f"unsupported YAML flow scalar {text!r}")
        return resolve_plain(text)

    def _seq(self) -> List[Any]:
        out: List[Any] = []
        self.i += 1
        while True:
            self._ws()
            if self.s[self.i] == "]":
                self.i += 1
                return out
            out.append(self.value())
            self._ws()
            if self.s[self.i] == ",":
                self.i += 1
            elif self.s[self.i] != "]":
                raise ValueError(f"bad YAML flow sequence near "
                                 f"{self.s[self.i:self.i + 20]!r}")


def _depth(text: str) -> int:
    """Open minus closed brackets of a flow text, outside quotes."""
    n, quote = 0, None
    for ch in text:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch == "[":
            n += 1
        elif ch == "]":
            n -= 1
    return n


def _flow_value(text: str) -> Any:
    f = _Flow(text)
    v = f.value()
    f._ws()
    if f.i != len(f.s):
        raise ValueError(f"trailing YAML text {f.s[f.i:]!r}")
    return v


def loads(text: str) -> Any:
    """The document ``text`` (a block mapping) -> nested dicts."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        body = _strip_comment(raw).rstrip()
        if body.strip():
            if "\t" in body[:len(body) - len(body.lstrip())]:
                raise ValueError("tab indentation in YAML")
            lines.append((len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None
    pos = 0

    def block(indent: int) -> dict:
        nonlocal pos
        out: dict = {}
        while pos < len(lines) and lines[pos][0] == indent:
            _, body = lines[pos]
            if body.startswith("- ") or body == "-":
                raise ValueError("YAML block sequences are not supported")
            key, sep, rest = body.partition(":")
            if not sep or (rest and rest[0] not in " \t"):
                raise ValueError(f"not a YAML mapping entry: {body!r}")
            key, rest = resolve_plain(key.strip()), rest.strip()
            pos += 1
            if not rest:
                if pos < len(lines) and lines[pos][0] > indent:
                    out[key] = block(lines[pos][0])
                else:
                    out[key] = None
            elif rest[0] == "[":
                while _depth(rest) > 0:
                    if pos == len(lines):
                        raise ValueError("unclosed YAML flow collection")
                    rest += "\n" + lines[pos][1]
                    pos += 1
                out[key] = _flow_value(rest)
            elif rest[0] in "\"'":
                out[key] = _flow_value(rest)
            elif rest[0] in "{&*!|>":
                raise ValueError(f"unsupported YAML value {rest!r}")
            else:
                out[key] = resolve_plain(rest)
        if pos < len(lines) and lines[pos][0] > indent:
            raise ValueError(f"bad YAML indentation at {lines[pos][1]!r}")
        return out

    doc = block(lines[0][0])
    if pos != len(lines):
        raise ValueError(f"bad YAML indentation at {lines[pos][1]!r}")
    return doc


def load(path) -> Any:
    with open(path) as f:
        return loads(f.read())
