"""A reader and writer for the YAML that configurations use, without PyYAML.

The configurations (configs/*.yaml, and the files `save_config` writes on
either package) use a small part of YAML: nested block mappings, block
lists (also at the indentation of their key, as PyYAML writes them), flow
lists, comments, and plain, single-quoted or double-quoted scalars. `loads` reads exactly that part and types each plain
scalar as PyYAML's `safe_load` does (YAML 1.1): so `1.0e-5` is a float but
`1e-5` a string, and `yes`/`on` are booleans. Anything else (anchors,
aliases, tags, block scalars, multi-line scalars, flow mappings, several
documents, complex keys, tabs, duplicate keys, dates, numbers in hex,
octal, binary or base 60) raises ValueError naming the line: the reader
never guesses.

`dump` writes nested mappings of scalars and lists of scalars as block
mappings and flow lists, which both this reader and PyYAML read back to the
same values.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, List, Optional, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py), those this reader types
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF_NAN = {**dict.fromkeys((".inf", ".Inf", ".INF", "+.inf", "+.Inf", "+.INF"), math.inf),
            **dict.fromkeys(("-.inf", "-.Inf", "-.INF"), -math.inf),
            **dict.fromkeys((".nan", ".NaN", ".NAN"), math.nan)}
# the plain scalars PyYAML types otherwise, which this reader refuses:
# binary, octal with a leading zero, hex and base-60 numbers, dates and
# timestamps, the merge key and the value key
_EXOTIC = re.compile(r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
                     r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}|<<$|=$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f", "r": "\r",
            "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Error(ValueError):
    pass


def _fail(line: int, msg: str):
    raise _Error(f"line {line}: {msg}")


def _plain(text: str, line: int = 0) -> Any:
    """A plain (unquoted) scalar typed as PyYAML's safe_load types it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text in _INF_NAN:
        return _INF_NAN[text]
    if _EXOTIC.match(text):
        _fail(line, f"{text!r} is a number, date or key in a form this reader does not read")
    if text[0] in "&*!|>%@`" or text.startswith(("? ", "- ")) or text in ("?", "-"):
        _fail(line, f"{text!r}: anchors, aliases, tags, block scalars and directives are not read")
    if ": " in text or text.endswith(":") or " #" in text:
        _fail(line, f"{text!r} is not a plain scalar")
    return text


def _double_quoted(s: str, line: int) -> str:
    out, i = [], 0
    while i < len(s):
        c = s[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        if i + 1 >= len(s):
            _fail(line, "a double-quoted string ends in a backslash")
        e = s[i + 1]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _HEX_ESCAPES:
            n = _HEX_ESCAPES[e]
            code = s[i + 2: i + 2 + n]
            if len(code) != n or not re.fullmatch(r"[0-9a-fA-F]+", code):
                _fail(line, f"bad escape \\{e}{code}")
            out.append(chr(int(code, 16)))
            i += 2 + n
        else:
            _fail(line, f"unknown escape \\{e}")
    return "".join(out)


class _Flow:
    """A flow list ([...]) or a scalar read from one line's text."""

    def __init__(self, text: str, line: int):
        self.s, self.i, self.line = text, 0, line

    def _ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def node(self, in_flow: bool) -> Any:
        self._ws()
        if self.i >= len(self.s):
            _fail(self.line, "a value is missing")
        c = self.s[self.i]
        if c == "[":
            self.i += 1
            items: List[Any] = []
            self._ws()
            if self.s.startswith("]", self.i):
                self.i += 1
                return items
            while True:
                items.append(self.node(True))
                self._ws()
                if self.s.startswith(",", self.i):
                    self.i += 1
                elif self.s.startswith("]", self.i):
                    self.i += 1
                    return items
                else:
                    _fail(self.line, "a flow list lacks ',' or ']'")
        if c == "{":
            _fail(self.line, "flow mappings ({...}) are not read")
        return self.scalar(in_flow)

    def scalar(self, in_flow: bool, key: bool = False) -> Any:
        s, start = self.s, self.i
        if start < len(s) and s[start] in "'\"":
            q = s[start]
            i = start + 1
            buf = []
            while True:
                if i >= len(s):
                    _fail(self.line, "a quoted string does not end on its line")
                if s[i] == q:
                    if q == "'" and s.startswith("''", i):
                        buf.append("'")
                        i += 2
                        continue
                    break
                if q == '"' and s[i] == "\\":
                    buf.append(s[i: i + 2])
                    i += 2
                    continue
                buf.append(s[i])
                i += 1
            self.i = i + 1
            body = "".join(buf)
            return _double_quoted(body, self.line) if q == '"' else body
        stops = ",[]{}" if in_flow else ""
        i = start
        while i < len(s) and s[i] not in stops:
            if key and s[i] == ":" and (i + 1 == len(s) or s[i + 1] == " "):
                break
            if in_flow and s[i] == ":" and i + 1 < len(s) and s[i + 1] == " ":
                _fail(self.line, "a mapping inside a flow list is not read")
            i += 1
        self.i = i
        text = s[start:i].rstrip()
        if not text:
            _fail(self.line, "an empty flow entry")
        return _plain(text, self.line)

    def end(self) -> None:
        self._ws()
        if self.i != len(self.s):
            _fail(self.line, f"unexpected text {self.s[self.i:]!r}")


def _value(text: str, line: int) -> Any:
    """A value written on its key's line (or after '- ')."""
    if text[:1] in "|>":
        _fail(line, "block scalars (| and >) are not read")
    if text[:1] in "&*!":
        _fail(line, "anchors, aliases and tags are not read")
    p = _Flow(text, line)
    v = p.node(in_flow=False)
    p.end()
    return v


def _strip_comment(text: str, line: int) -> str:
    """The line without its comment: '#' at its start or after a space,
    outside quotes."""
    q: Optional[str] = None
    i = 0
    while i < len(text):
        c = text[i]
        if q:
            if c == "\\" and q == '"':
                i += 2
                continue
            if c == q:
                if q == "'" and text.startswith("''", i):
                    i += 2
                    continue
                q = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " [{,:-"):
            q = c
        elif c == "#" and (i == 0 or text[i - 1] == " "):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _split_key(text: str, line: int) -> Tuple[Any, str]:
    """'key: rest' -> (key, rest); rest is '' when the value follows below."""
    p = _Flow(text, line)
    if text.startswith("? "):
        _fail(line, "complex keys ('? ') are not read")
    key = p.scalar(False, key=True)
    p._ws()
    if not text.startswith(":", p.i):
        _fail(line, f"expected 'key: value', got {text!r}")
    rest = text[p.i + 1:]
    if rest and rest[0] != " ":
        _fail(line, f"expected a space after ':' in {text!r}")
    if isinstance(key, (list, dict)):
        _fail(line, "a key must be a scalar")
    return key, rest.strip()


def loads(text: str) -> Any:
    """The YAML document in `text` (None when it holds none)."""
    lines: List[Tuple[int, int, str]] = []  # (line number, indent, content)
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip(" \t"))]:
            _fail(n, "tabs in indentation are not YAML")
        body = _strip_comment(raw, n)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("%"):
            _fail(n, "directives are not read")
        if stripped in ("---", "...") or stripped.startswith("--- "):
            if lines or stripped != "---":
                _fail(n, "only one document, with at most a '---' before it, is read")
            continue
        lines.append((n, len(body) - len(stripped), stripped))
    if not lines:
        return None
    n, _, content = lines[0]
    if len(lines) == 1 and not (content == "-" or content.startswith("- ")) and not _is_mapping_line(content):
        return _value(content, n)  # a document of one scalar or flow node
    pos = 0

    def block(indent: int) -> Any:
        nonlocal pos
        n, ind, content = lines[pos]
        if content == "-" or content.startswith("- "):
            return seq(ind)
        if ind != indent:
            _fail(n, "bad indentation")
        return mapping(ind)

    def seq(indent: int) -> List[Any]:
        nonlocal pos
        out: List[Any] = []
        while pos < len(lines):
            n, ind, content = lines[pos]
            if ind < indent or not (content == "-" or content.startswith("- ")):
                if ind > indent:
                    _fail(n, "bad indentation")
                break
            if ind > indent:
                _fail(n, "bad indentation in a list")
            rest = content[1:].strip()
            pos += 1
            if not rest:
                if pos < len(lines) and lines[pos][1] > indent:
                    _fail(lines[pos][0], "nested blocks inside a list are not read")
                out.append(None)
                continue
            if rest.startswith("- ") or rest == "-":
                _fail(n, "nested block lists are not read")
            if _is_mapping_line(rest):
                _fail(n, "mappings inside a list are not read")
            out.append(_value(rest, n))
        return out

    def mapping(indent: int) -> Dict[Any, Any]:
        nonlocal pos
        out: Dict[Any, Any] = {}
        while pos < len(lines):
            n, ind, content = lines[pos]
            if ind < indent:
                break
            if ind > indent:
                _fail(n, "bad indentation")
            if content == "-" or content.startswith("- "):
                _fail(n, "a list item where a key was expected")
            key, rest = _split_key(content, n)
            if key in out:
                _fail(n, f"the key {key!r} appears twice")
            pos += 1
            if rest:
                out[key] = _value(rest, n)
                if pos < len(lines) and lines[pos][1] > indent:
                    _fail(lines[pos][0], "multi-line scalars are not read")
                continue
            if pos < len(lines):
                nn, nind, ncontent = lines[pos]
                is_item = ncontent == "-" or ncontent.startswith("- ")
                if nind > indent or (nind == indent and is_item):
                    out[key] = block(nind)
                    continue
            out[key] = None
        return out

    root = block(lines[0][1])
    if pos != len(lines):
        _fail(lines[pos][0], "text after the document's end")
    return root


def _is_mapping_line(text: str) -> bool:
    if text[:1] in "[{'\"":
        return False
    return bool(re.match(r"[^#]*?:(?: |$)", text))


def load(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        try:
            return loads(f.read())
        except _Error as e:
            raise ValueError(f"{path}: {e}") from None


# ---- writer -----------------------------------------------------------------------
def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:  # 1e-05 is a string to YAML 1.1: write 1.0e-05, as PyYAML does
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        try:
            plain = _plain(v) if v and v == v.strip() and re.fullmatch(r"[A-Za-z0-9_./+-][\w./+ -]*", v) else None
        except _Error:
            plain = None
        if plain == v and isinstance(plain, str):
            return v
        return json.dumps(v)  # a JSON string is a YAML double-quoted scalar
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as a YAML scalar")


def dump(data: Dict[str, Any], path: str) -> None:
    """Write nested mappings (dicts, in their order) whose leaves are
    scalars or lists of scalars to `path`, as block mappings with flow lists."""
    out: List[str] = []

    def emit(d: Dict[str, Any], indent: int) -> None:
        for k, v in d.items():
            key = _scalar_text(k)
            if isinstance(v, dict):
                if not v:
                    raise ValueError(f"{key}: an empty mapping has no block form")
                out.append(" " * indent + f"{key}:")
                emit(v, indent + 2)
            elif isinstance(v, (list, tuple)):
                out.append(" " * indent + f"{key}: [" + ", ".join(_scalar_text(x) for x in v) + "]")
            else:
                out.append(" " * indent + f"{key}: {_scalar_text(v)}")

    emit(data, 0)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(out) + "\n")
