"""A reader for the YAML subset that configs/*.yaml use, with no PyYAML.

Supported: block mappings (`key: value`, `key:` opening a nested block),
block lists (`- scalar`, `- key: value` opening a mapping item), plain and
quoted scalars, full-line and trailing comments.  Scalars resolve as
PyYAML's `safe_load` resolves them (YAML 1.1): null, booleans (true/false,
yes/no, on/off), decimal integers, floats that have a dot or are .inf/.nan
(so `1e-4` stays a string, as in PyYAML), everything else a string.
Flow collections (`{...}`, `[...]`), anchors, aliases, tags and block
scalars (`|`, `>`) are refused with a ValueError rather than misread.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple


def _cases(*words):
    """A word in the three spellings YAML 1.1 resolves: lower, Title,
    UPPER."""
    return {w2: w for w in words for w2 in (w, w.capitalize(), w.upper())}


_BOOL = {k: v in ("true", "yes", "on") for k, v in _cases(
    "true", "yes", "on", "false", "no", "off").items()}
_NULL = {"", "~", *_cases("null")}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^([-+]?[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)([eE][-+][0-9]+)?$")
_INF = re.compile(r"^([-+]?)\.(inf|Inf|INF)$")
_NAN = re.compile(r"^\.(nan|NaN|NAN)$")


def parse_scalar(text: str) -> Any:
    """One scalar as safe_load reads it."""
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        body = s[1:-1]
        return body.replace("''", "'") if s[0] == "'" else _unescape(body)
    if s and s[0] in "{[&*!|>%@`":
        raise ValueError(f"unsupported YAML construct: {s!r}")
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    m = _INF.match(s)
    if m:
        return float(m.group(1) + "inf")
    if _NAN.match(s):
        return float("nan")
    return s


def parse_value(text: str) -> Any:
    """A scalar, or a one-line flow sequence of scalars (`[215, 178, 3]`),
    as safe_load reads it: what a `--set` override may give."""
    s = text.strip()
    if s[:1] == "[" and s[-1:] == "]":
        body = s[1:-1]
        if any(c in body for c in "[]{}'\""):
            raise ValueError(f"unsupported YAML construct: {s!r}")
        items = [t.strip() for t in body.split(",")]
        if items[-1] == "":  # `[]` and a trailing comma
            items.pop()
        return [parse_scalar(t) for t in items]
    return parse_scalar(s)


def _unescape(body: str) -> str:
    return body.encode("latin-1", "backslashreplace").decode(
        "unicode_escape")


def _strip_comment(line: str) -> str:
    """Drop a `#` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in indentation are not YAML")
        line = _strip_comment(raw).rstrip()
        if line.strip() in ("", "---"):
            continue
        out.append((len(line) - len(line.lstrip(" ")), line.strip()))
    return out


def _split_key(item: str):
    """(key, rest) of `key: rest` / `key:`, or None for a plain scalar."""
    m = re.match(r"^([^'\"#][^#]*?|'[^']*'|\"[^\"]*\"):(?:\s+(.*))?$", item)
    if not m:
        return None
    return parse_scalar(m.group(1)), (m.group(2) or "")


def _block(lines, i: int, indent: int):
    """Parse the block whose items sit at `indent`, from line i."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        return _list(lines, i, indent)
    return _mapping(lines, i, indent)


def _value(lines, i: int, parent_indent: int, rest: str):
    """The value after `key:` or `- `: inline, or a nested block."""
    if rest:
        return parse_scalar(rest), i + 1
    if i + 1 < len(lines) and (
            lines[i + 1][0] > parent_indent
            or (lines[i + 1][0] == parent_indent
                and lines[i + 1][1].startswith("- "))):
        return _block(lines, i + 1, lines[i + 1][0])
    return None, i + 1


def _mapping(lines, i: int, indent: int):
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        item = lines[i][1]
        kv = _split_key(item)
        if kv is None or item.startswith("- "):
            break
        key, rest = kv
        if key in out:
            raise ValueError(f"duplicate key {key!r}")
        value, i = _value(lines, i, indent, rest)
        out[key] = value
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"bad indentation: {lines[i][1]!r}")
    return out, i


def _list(lines, i: int, indent: int):
    out = []
    while i < len(lines) and lines[i][0] == indent and (
            lines[i][1].startswith("- ") or lines[i][1] == "-"):
        item = lines[i][1][2:].strip()
        kv = _split_key(item) if item else None
        if kv is None:
            value, i = _value(lines, i, indent, item)
            out.append(value)
            continue
        # `- key: value` opens a mapping whose keys sit two columns in
        sub = indent + 2
        lines[i] = (sub, item)
        value, i = _mapping(lines, i, sub)
        out.append(value)
    return out, i


def loads(text: str) -> Any:
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unparsed YAML from: {lines[i][1]!r}")
    return value


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())
