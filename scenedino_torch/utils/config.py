"""Reader and writer of the YAML that `configs/` uses, without PyYAML
(counterpart of `scenedino_tpu/utils/jax_setup.py:78-104` and the
reading half of `scenedino_tpu/cli/train.py:245-249`).

The subset: block mappings and block sequences (a sequence item may open
a mapping on its own line: `- type: depth`), flow sequences `[...]` and
mappings `{...}` (nested, and spanning lines), comments, and plain or
quoted scalars. Plain scalars resolve as PyYAML's `safe_load` resolves
them (YAML 1.1): `null`/`~`/empty, the booleans (true/false, yes/no,
on/off), decimal, octal and hexadecimal ints, floats with a dot such as
`1.0e-4` (`1e-4` stays a string there, and here), `.inf`, `.nan`.
Anything else (anchors, aliases, tags, block scalars, several documents,
complex keys, directives) raises a `ValueError` naming the line.
"""
from __future__ import annotations

import json
import math
import os
import re
from typing import Any, List, Optional, Tuple

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_OCT = re.compile(r"[-+]?0[0-7_]+$")
_HEX = re.compile(r"[-+]?0x[0-9a-fA-F_]+$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_UNSUPPORTED = "&*!|>%@`?"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}


def resolve_plain(text: str) -> Any:
    """A plain scalar's value under PyYAML's safe resolver."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _HEX.match(text):
        sign = -1 if text[0] == "-" else 1
        return sign * int(text.lstrip("+-")[2:].replace("_", ""), 16)
    if _OCT.match(text):
        sign = -1 if text[0] == "-" else 1
        return sign * int(text.lstrip("+-").replace("_", ""), 8)
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return -math.inf if text[0] == "-" else math.inf
    if _NAN.match(text):
        return math.nan
    return text


class _Line:
    __slots__ = ("indent", "text", "no")

    def __init__(self, indent: int, text: str, no: int):
        self.indent, self.text, self.no = indent, text, no


class _Parser:
    def __init__(self, text: str, name: str):
        self.name = name
        self.lines: List[_Line] = []
        for no, raw in enumerate(text.splitlines(), 1):
            body = self._strip_comment(raw, no)
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped.startswith("\t") or "\t" in body[: len(body) - len(stripped)]:
                self.fail(no, "a tab in the indentation")
            if stripped.startswith(("---", "...")) and stripped[3:4] in ("", " "):
                self.fail(no, "document markers (one document per file)")
            if stripped.startswith("%"):
                self.fail(no, "directives")
            self.lines.append(_Line(len(body) - len(stripped), stripped.rstrip(), no))

    def fail(self, no: int, what: str):
        raise ValueError(f"{self.name}:{no}: unsupported YAML: {what}")

    def _strip_comment(self, raw: str, no: int) -> str:
        quote = None
        i = 0
        while i < len(raw):
            ch = raw[i]
            if quote == '"':
                if ch == "\\":
                    i += 1
                elif ch == '"':
                    quote = None
            elif quote == "'":
                if ch == "'":
                    if raw[i + 1:i + 2] == "'":
                        i += 1
                    else:
                        quote = None
            elif ch in "\"'" and (i == 0 or raw[i - 1] in " \t[{,:-"):
                quote = ch
            elif ch == "#" and (i == 0 or raw[i - 1] in " \t"):
                return raw[:i]
            i += 1
        if quote is not None:
            self.fail(no, "a quoted scalar that spans lines")
        return raw

    def parse(self) -> Any:
        if not self.lines:
            return None
        value, i = self.block(0, self.lines[0].indent)
        if i < len(self.lines):
            self.fail(self.lines[i].no, "content after the top-level node (check the indentation)")
        return value

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        line = self.lines[i]
        if line.text == "-" or line.text.startswith("- "):
            return self.sequence(i, indent)
        if self._split_key(line) is None:
            value, i = self.inline(i, line.text)
            return value, i
        return self.mapping(i, indent)

    def _split_key(self, line: _Line) -> Optional[Tuple[Any, str]]:
        """(key, the text after "key:") or None when the line is no mapping entry."""
        text = line.text
        if text[0] in "[{":
            return None
        if text[0] in "\"'":
            end = self._quoted_end(text, 0, line.no)
            rest = text[end:].lstrip(" ")
            if not rest.startswith(":") or rest[1:2] not in ("", " "):
                return None
            return self._quoted(text[:end], line.no), rest[1:].strip()
        m = re.search(r":(?: |$)", text)
        if m is None:
            return None
        key = text[:m.start()].rstrip()
        if key[:1] in _UNSUPPORTED:
            self.fail(line.no, f"the key {key!r}")
        return resolve_plain(key), text[m.end():].strip()

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out: dict = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            if line.text == "-" or line.text.startswith("- "):
                self.fail(line.no, "a sequence item where a mapping key was expected")
            kv = self._split_key(line)
            if kv is None:
                self.fail(line.no, f"a line that is no 'key: value' entry: {line.text!r}")
            key, rest = kv
            if key in out:
                self.fail(line.no, f"the duplicate key {key!r}")
            i += 1
            if rest:
                out[key], i = self.inline(i - 1, rest)
            elif i < len(self.lines) and self.lines[i].indent > indent:
                out[key], i = self.block(i, self.lines[i].indent)
            elif i < len(self.lines) and self.lines[i].indent == indent and (
                    self.lines[i].text == "-" or self.lines[i].text.startswith("- ")):
                out[key], i = self.sequence(i, indent)
            else:
                out[key] = None
        if i < len(self.lines) and self.lines[i].indent > indent:
            self.fail(self.lines[i].no, "unexpected indentation")
        return out, i

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out: list = []
        while i < len(self.lines) and self.lines[i].indent == indent and (
                self.lines[i].text == "-" or self.lines[i].text.startswith("- ")):
            line = self.lines[i]
            rest = line.text[1:].lstrip(" ")
            if not rest:
                if i + 1 < len(self.lines) and self.lines[i + 1].indent > indent:
                    value, i = self.block(i + 1, self.lines[i + 1].indent)
                else:
                    value, i = None, i + 1
            else:
                inner = indent + len(line.text) - len(rest)
                self.lines[i] = _Line(inner, rest, line.no)
                value, i = self.block(i, inner)
            out.append(value)
        if i < len(self.lines) and self.lines[i].indent > indent:
            self.fail(self.lines[i].no, "unexpected indentation")
        return out, i

    def inline(self, i: int, text: str) -> Tuple[Any, int]:
        """The value `text` on line i (a scalar, or a flow collection that may
        continue on the following lines); returns it and the next line."""
        no = self.lines[i].no
        if text[0] in _UNSUPPORTED:
            self.fail(no, f"the node {text!r} (anchors, aliases, tags and block scalars)")
        if text[0] in "[{":
            parts = [text]
            while True:
                try:
                    value, end = self._flow(" ".join(parts), 0, no)
                except _Incomplete:
                    i += 1
                    if i >= len(self.lines):
                        self.fail(no, "an unterminated flow collection")
                    parts.append(self.lines[i].text)
                    continue
                if " ".join(parts)[end:].strip():
                    self.fail(no, "text after a flow collection")
                return value, i + 1
        if text[0] in "\"'":
            end = self._quoted_end(text, 0, no)
            if text[end:].strip():
                self.fail(no, "text after a quoted scalar")
            return self._quoted(text, no), i + 1
        if ": " in text or text.endswith(":"):
            self.fail(no, f"a mapping inside a plain value: {text!r}")
        return resolve_plain(text), i + 1

    def _quoted_end(self, text: str, pos: int, no: int) -> int:
        q = text[pos]
        i = pos + 1
        while i < len(text):
            if q == '"' and text[i] == "\\":
                i += 2
                continue
            if text[i] == q:
                if q == "'" and text[i + 1:i + 2] == "'":
                    i += 2
                    continue
                return i + 1
            i += 1
        self.fail(no, "an unterminated quoted scalar")

    def _quoted(self, token: str, no: int) -> str:
        body = token[1:-1]
        if token[0] == "'":
            return body.replace("''", "'")
        out, i = [], 0
        while i < len(body):
            ch = body[i]
            if ch != "\\":
                out.append(ch)
                i += 1
                continue
            esc = body[i + 1:i + 2]
            width = {"x": 2, "u": 4, "U": 8}.get(esc)
            if width:
                out.append(chr(int(body[i + 2:i + 2 + width], 16)))
                i += 2 + width
            elif esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
            else:
                self.fail(no, f"the escape \\{esc}")
        return "".join(out)

    def _flow(self, text: str, pos: int, no: int) -> Tuple[Any, int]:
        """A flow node at text[pos:] -> (value, end)."""
        pos = _skip(text, pos)
        if pos >= len(text):
            raise _Incomplete
        ch = text[pos]
        if ch in "[{":
            close = "]" if ch == "[" else "}"
            items: Any = [] if ch == "[" else {}
            pos += 1
            while True:
                pos = _skip(text, pos)
                if pos >= len(text):
                    raise _Incomplete
                if text[pos] == close:
                    return items, pos + 1
                if ch == "[":
                    value, pos = self._flow(text, pos, no)
                    items.append(value)
                else:
                    key, pos = self._flow_scalar(text, pos, no)
                    pos = _skip(text, pos)
                    if pos >= len(text):
                        raise _Incomplete
                    if text[pos] != ":":
                        self.fail(no, "a flow mapping entry without ':'")
                    value, pos = self._flow(text, pos + 1, no)
                    if key in items:
                        self.fail(no, f"the duplicate key {key!r}")
                    items[key] = value
                pos = _skip(text, pos)
                if pos >= len(text):
                    raise _Incomplete
                if text[pos] == ",":
                    pos += 1
                elif text[pos] != close:
                    self.fail(no, f"{text[pos]!r} inside a flow collection")
        return self._flow_scalar(text, pos, no)

    def _flow_scalar(self, text: str, pos: int, no: int) -> Tuple[Any, int]:
        if text[pos] in "\"'":
            end = self._quoted_end(text, pos, no)
            return self._quoted(text[pos:end], no), end
        if text[pos] in _UNSUPPORTED:
            self.fail(no, f"the node {text[pos:]!r} (anchors, aliases and tags)")
        end = pos
        while end < len(text) and text[end] not in ",[]{}":
            if text[end] == ":" and (end + 1 == len(text) or text[end + 1] in " ,]}"):
                break
            end += 1
        return resolve_plain(text[pos:end].strip()), end


class _Incomplete(Exception):
    """A flow collection continues on the next line."""


def _skip(text: str, pos: int) -> int:
    while pos < len(text) and text[pos] == " ":
        pos += 1
    return pos


def loads(text: str, name: str = "<string>") -> Any:
    """The value of a YAML document in the supported subset."""
    return _Parser(text, name).parse()


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read(), str(path))


# ------------------------------------------------------------------ writer
def _scalar(v: Any) -> str:
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
        text = repr(v)
        if "e" in text and "." not in text.split("e")[0]:
            text = text.replace("e", ".0e", 1)
        elif "e" not in text and "." not in text:
            text += ".0"
        return text
    if isinstance(v, str):
        plain_ok = (v and v == v.strip() and resolve_plain(v) == v and v[0] not in "\"'[]{},#-" + _UNSUPPORTED
                    and not any(s in v for s in (": ", " #", "\n")) and not v.endswith(":")
                    and not any(c in v for c in ",[]{}"))
        return v if plain_ok else json.dumps(v)
    raise ValueError(f"cannot write a {type(v).__name__} as YAML: {v!r}")


def _is_scalar(v: Any) -> bool:
    return v is None or isinstance(v, (bool, int, float, str))


def dumps(value: Any) -> str:
    """`value` (dicts, lists or tuples, scalars) as block YAML that `loads`
    and PyYAML read back equal (tuples as lists); lists of scalars in flow
    style."""
    lines: List[str] = []

    def emit(v: Any, indent: int, prefix: str) -> None:
        pad = " " * indent
        if isinstance(v, dict) and v:
            first = True
            for k, item in v.items():
                if not isinstance(k, (str, int)) or isinstance(k, bool):
                    raise ValueError(f"cannot write the key {k!r}")
                head = (prefix if first else pad) + _scalar(k) + ":"
                first = False
                if _is_scalar(item) or not item or (
                        isinstance(item, (list, tuple)) and all(_is_scalar(x) for x in item)):
                    lines.append(head + " " + _inline(item))
                else:
                    lines.append(head)
                    emit(item, indent + 2, " " * (indent + 2))
        elif isinstance(v, (list, tuple)) and v and not all(_is_scalar(x) for x in v):
            for item in v:
                if isinstance(item, dict) and item:
                    emit(item, indent + 2, pad + "- ")
                elif _is_scalar(item) or not item or all(_is_scalar(x) for x in item):
                    lines.append(pad + "- " + _inline(item))
                else:
                    lines.append(pad + "-")
                    emit(item, indent + 2, " " * (indent + 2))
        else:
            lines.append(prefix + _inline(v))

    emit(value, 0, "")
    return "\n".join(lines) + "\n"


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        if v:
            raise ValueError("a non-empty mapping is written in block style")
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_scalar(x) for x in v) + "]"
    return _scalar(v)


def save_run_config(output_path: str, config: dict) -> str:
    """Write `config` to <output_path>/training_config.yaml (the run's
    record, read back by `load_run_config`); returns the file's path."""
    os.makedirs(output_path, exist_ok=True)
    path = os.path.join(output_path, "training_config.yaml")
    with open(path, "w") as f:
        f.write(dumps(config))
    return path


def load_run_config(path: str) -> Any:
    """A config from a YAML file or from a run directory holding
    training_config.yaml."""
    if os.path.isdir(path):
        path = os.path.join(path, "training_config.yaml")
    return load(path)
