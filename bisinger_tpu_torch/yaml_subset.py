"""A reader of the YAML subset that the repo's configs (`configs/**/*.yaml`)
are written in, for machines without PyYAML.

It parses block mappings (nested too), block sequences of scalars or of
nested blocks, flow sequences and flow mappings (nested too, on one
line), plain, single-quoted and double-quoted scalars, and comments. Each
plain scalar gets the type PyYAML's `safe_load` gives it under YAML 1.1:
null (`~`, `null`, empty), bool (`true`, `yes`, `on`, ... in their three
spellings), decimal int (`_` ignored), float (a dot required: `1e-6`
stays the string "1e-6"; an exponent needs its sign; `.inf`, `.nan`),
else str. Quoted scalars are strings. Duplicate keys keep the last
value, as PyYAML's.

Anything else raises `YAMLSubsetError` naming the file and the line:
anchors and aliases, tags, block scalars (`|`, `>`), directives and more
than one document, tabs in the indentation, complex keys, timestamps,
octal, binary, hex and base-60 numbers, backslash escapes, merge keys,
scalars or flow collections over several lines, and a mapping inside a
block sequence item.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                 "OFF")})
# PyYAML's implicit resolvers (resolver.py), each applied only to scalars
# starting with one of its characters, in PyYAML's order: bool, float, int.
# The configs write decimal numbers only: the other forms PyYAML would
# type (octal, binary, hex and base-60 numbers) are refused, not read.
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_OTHER_NUMBER = re.compile(r"""^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                           |[-+]?0b[0-1_]+
                           |[-+]?0[0-7_]+
                           |[-+]?0x[0-9a-fA-F_]+
                           |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9]
                        (?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
_REFUSED_START = {"&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar",
                  ">": "a block scalar", "%": "a directive", "@": "a reserved indicator",
                  "`": "a reserved indicator", "?": "a complex key"}


class YAMLSubsetError(ValueError):
    def __init__(self, filename: str, line: int, msg: str):
        super().__init__(f"{filename}:{line}: {msg}")
        self.filename, self.line = filename, line


def resolve_plain(text: str, filename: str = "<string>", line: int = 0) -> Any:
    """A plain scalar's value, typed as PyYAML's safe_load types it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    first = text[0]
    if first in "-+0123456789." and _FLOAT.match(text):
        value = text.replace("_", "").lower()
        if value.endswith(".nan"):
            return math.nan
        return float(value.replace(".inf", "inf"))
    if first in "-+0123456789" and _INT.match(text):
        return int(text.replace("_", ""))
    if first in "-+0123456789" and _OTHER_NUMBER.match(text):
        raise YAMLSubsetError(filename, line, f"number {text!r} (octal, binary, hex or base 60) "
                              "is outside the subset")
    if first in "0123456789" and _TIMESTAMP.match(text):
        raise YAMLSubsetError(filename, line, f"timestamp {text!r} is outside the subset")
    if text in ("<<", "="):
        raise YAMLSubsetError(filename, line, f"{text!r} (a merge or value key) is outside "
                              "the subset")
    return text


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


class _Reader:
    def __init__(self, text: str, filename: str):
        self.filename = filename
        self.lines: List[_Line] = []
        started = False
        for no, raw in enumerate(text.splitlines(), start=1):
            stripped = raw.lstrip(" \t")
            if not stripped.strip():
                continue
            if "\t" in raw[:len(raw) - len(stripped)]:
                raise self.error(no, "a tab in the indentation")
            body = stripped.rstrip()
            if body.startswith("#"):
                continue
            if raw.startswith("%"):
                raise self.error(no, "a directive is outside the subset")
            if raw.startswith("---") and (len(body) == 3 or body[3] in " \t"):
                if started or body[3:].strip() and not body[3:].strip().startswith("#"):
                    raise self.error(no, "more than one document (or content after '---')")
                started = True
                continue
            if raw.startswith("...") and (len(body) == 3 or body[3] in " \t"):
                raise self.error(no, "a document end marker is outside the subset")
            started = True
            self.lines.append(_Line(no, len(raw) - len(stripped), body))
        self.i = 0

    def error(self, line: int, msg: str) -> YAMLSubsetError:
        return YAMLSubsetError(self.filename, line, msg)

    # ---- blocks ----------------------------------------------------------
    def document(self) -> Any:
        if not self.lines:
            return None
        first = self.lines[0]
        out = self.block(first.indent)
        if self.i < len(self.lines):
            ln = self.lines[self.i]
            raise self.error(ln.no, "bad indentation")
        return out

    def block(self, indent: int) -> Any:
        ln = self.lines[self.i]
        if _is_seq_item(ln.text):
            return self.sequence(indent)
        key_end = self._key_end(ln)
        if key_end is None:  # a lone scalar or flow collection
            self.i += 1
            value = self.inline(ln, ln.text)
            if self.i < len(self.lines) and self.lines[self.i].indent > indent:
                raise self.error(self.lines[self.i].no, "a scalar over several lines is "
                                 "outside the subset")
            return value
        return self.mapping(indent)

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            ln = self.lines[self.i]
            if ln.indent < indent:
                break
            if ln.indent > indent:
                raise self.error(ln.no, "bad indentation")
            if _is_seq_item(ln.text):
                raise self.error(ln.no, "a sequence item where a mapping key was expected")
            key_end = self._key_end(ln)
            if key_end is None:
                if ln.text[0] in _REFUSED_START:
                    self.inline(ln, ln.text)  # raises, naming the construct
                raise self.error(ln.no, "expected 'key: value' (a scalar over several lines "
                                 "is outside the subset)")
            key = self.inline(ln, ln.text[:key_end].rstrip(), key=True)
            rest = ln.text[key_end + 1:].strip()
            self.i += 1
            nxt = self.lines[self.i] if self.i < len(self.lines) else None
            if rest and not rest.startswith("#"):
                out[key] = self.inline(ln, rest)
                if nxt is not None and nxt.indent > indent:
                    raise self.error(nxt.no, "a value over several lines is outside the subset")
                continue
            if nxt is not None and (nxt.indent > indent or (
                    nxt.indent == indent and _is_seq_item(nxt.text))):
                out[key] = self.block(nxt.indent)
            else:
                out[key] = None
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ln = self.lines[self.i]
            if ln.indent < indent or (ln.indent == indent and not _is_seq_item(ln.text)):
                break
            if ln.indent > indent:
                raise self.error(ln.no, "bad indentation")
            rest = ln.text[1:].strip()
            self.i += 1
            if rest and not rest.startswith("#"):
                if _is_seq_item(rest) or self._key_end(_Line(ln.no, 0, rest)) is not None:
                    raise self.error(ln.no, "a mapping or sequence inside a block sequence "
                                     "item is outside the subset")
                out.append(self.inline(ln, rest))
                continue
            nxt = self.lines[self.i] if self.i < len(self.lines) else None
            out.append(self.block(nxt.indent) if nxt is not None and nxt.indent > indent
                       else None)
        return out

    def _key_end(self, ln: _Line) -> Optional[int]:
        """The index of the ':' that ends the line's mapping key, or None."""
        text = ln.text
        if text[0] in "'\"":
            _, end = self.quoted(ln, text, 0)
            j = end
            while j < len(text) and text[j] == " ":
                j += 1
            return j if j < len(text) and text[j] == ":" and (
                j + 1 == len(text) or text[j + 1] == " ") else None
        if text[0] in "[{":
            return None
        for j, c in enumerate(text):
            if c == "#" and j > 0 and text[j - 1] in " \t":
                return None
            if c == ":" and (j + 1 == len(text) or text[j + 1] == " "):
                return j
        return None

    # ---- one line's values -------------------------------------------------
    def inline(self, ln: _Line, text: str, key: bool = False) -> Any:
        """A complete value on one line: a flow collection, a quoted scalar
        or a plain one, then only a comment."""
        c = text[0]
        if c in _REFUSED_START and not (c == "?" and len(text) > 1 and text[1] != " "):
            raise self.error(ln.no, f"{_REFUSED_START[c]} ({text[:12]!r}) is outside the "
                             "subset")
        if c in "[{":
            if key:
                raise self.error(ln.no, "a flow collection as a key is outside the subset")
            value, end = self.flow(ln, text, 0)
        elif c in "'\"":
            value, end = self.quoted(ln, text, 0)
        else:
            if _is_seq_item(text):
                raise self.error(ln.no, "a sequence item is not allowed here")
            end = len(text)
            for j, ch in enumerate(text):
                if ch == "#" and j > 0 and text[j - 1] in " \t":
                    end = j
                    break
            plain = text[:end].rstrip()
            if ": " in plain or plain.endswith(":"):
                raise self.error(ln.no, "a mapping value is not allowed here")
            return resolve_plain(plain, self.filename, ln.no)
        tail = text[end:].strip()
        if tail and not (tail.startswith("#") and (end == len(text) or text[end] == " ")):
            raise self.error(ln.no, f"unexpected {tail[:12]!r} after a value (a flow collection "
                             "or quoted scalar over several lines is outside the subset)")
        return value

    def quoted(self, ln: _Line, text: str, i: int) -> Tuple[str, int]:
        q = text[i]
        out, j = [], i + 1
        while j < len(text):
            c = text[j]
            if q == "'" and c == "'":
                if j + 1 < len(text) and text[j + 1] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            if q == '"' and c == '"':
                return "".join(out), j + 1
            if q == '"' and c == "\\":
                raise self.error(ln.no, "a backslash escape is outside the subset")
            out.append(c)
            j += 1
        raise self.error(ln.no, "a quoted scalar over several lines is outside the subset")

    def flow(self, ln: _Line, text: str, i: int) -> Tuple[Any, int]:
        """A flow sequence or mapping starting at text[i]: (value, end)."""
        close = "]" if text[i] == "[" else "}"
        is_map = close == "}"
        out: Any = {} if is_map else []
        j = self._skip(text, i + 1)
        while True:
            if j >= len(text) or text[j] == "#":
                raise self.error(ln.no, "a flow collection over several lines is outside "
                                 "the subset")
            if text[j] == close:
                return out, j + 1
            if is_map:
                key, j = self.flow_node(ln, text, j, close, key=True)
                j = self._skip(text, j)
                if j < len(text) and text[j] == ":":
                    value, j = self.flow_node(ln, text, self._skip(text, j + 1), close)
                else:
                    value = None
                out[key] = value
            else:
                value, j = self.flow_node(ln, text, j, close)
                if self._skip(text, j) < len(text) and text[self._skip(text, j)] == ":":
                    raise self.error(ln.no, "a mapping inside a flow sequence is outside the "
                                     "subset")
                out.append(value)
            j = self._skip(text, j)
            if j < len(text) and text[j] == ",":
                j = self._skip(text, j + 1)
            elif j < len(text) and text[j] != close:
                raise self.error(ln.no, f"expected ',' or {close!r} in a flow collection, "
                                 f"got {text[j:j + 12]!r}")

    def flow_node(self, ln: _Line, text: str, j: int, close: str, key: bool = False):
        if j >= len(text):
            raise self.error(ln.no, "a flow collection over several lines is outside the subset")
        c = text[j]
        if c in "[{":
            if key:
                raise self.error(ln.no, "a flow collection as a key is outside the subset")
            return self.flow(ln, text, j)
        if c in "'\"":
            return self.quoted(ln, text, j)
        if c in _REFUSED_START and not (c == "?" and j + 1 < len(text) and text[j + 1] != " "):
            raise self.error(ln.no, f"{_REFUSED_START[c]} is outside the subset")
        end = j
        while end < len(text):
            ch = text[end]
            if ch in ",[]{}":
                break
            if ch == ":" and (end + 1 == len(text) or text[end + 1] in " ,[]{}"):
                break
            if ch == "#" and text[end - 1] in " \t":
                break
            end += 1
        return resolve_plain(text[j:end].rstrip(), self.filename, ln.no), end

    @staticmethod
    def _skip(text: str, j: int) -> int:
        while j < len(text) and text[j] == " ":
            j += 1
        return j


def _is_seq_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def loads(text: str, filename: str = "<string>") -> Any:
    """The value of one YAML document in the subset (None when empty)."""
    return _Reader(text, filename).document()


def load_file(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return loads(f.read(), path)
