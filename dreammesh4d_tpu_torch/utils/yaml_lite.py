"""A YAML reader and writer for the subset the configurations use, so that
the port needs no PyYAML (the machine with the card may not have it).

``safe_load(text)`` reads what ``configs/*.yaml`` and the launcher's dotlist
values use, and gives what PyYAML's ``yaml.safe_load`` gives:

- block mappings and block sequences (a sequence may sit at its key's
  indentation), flow sequences ``[...]`` and flow mappings ``{...}``, which
  may run over several lines;
- ``#`` comments, plain scalars and single- or double-quoted scalars;
- plain scalars resolved as YAML 1.1 does (PyYAML's ``SafeLoader``):
  ``yes/no/on/off/true/false`` in their three spellings are booleans; ``~``,
  ``null`` and an empty value are None; integers take underscores, ``0b``,
  ``0x``, a leading ``0`` (octal) and base 60; a float needs a dot (``1.e-15``,
  ``5000.``, ``.5``), an exponent with a sign, or is ``.inf`` / ``.nan`` —
  ``1e-15`` stays a string; ``???`` is a string.

Anything outside the subset raises :class:`YAMLError` rather than being read
differently: anchors, aliases, tags, block scalars (``|``, ``>``), complex
keys, document markers and directives, plain scalars over several lines,
timestamps, merge keys, tabs in indentation.

``safe_dump(data)`` writes dicts, lists, tuples, strings, numbers, booleans
and None in a form that both this reader and PyYAML read back to the same
value (``configs/parsed.yaml`` of a trial).
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Tuple


class YAMLError(ValueError):
    """The text is not YAML, or uses YAML outside the subset this module reads."""


# ---------------------------------------------------------------------------
# Plain scalars (PyYAML's implicit resolvers, yaml/resolver.py)
# ---------------------------------------------------------------------------

_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")}}
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)


def _sexagesimal(digits: str, cast):
    value, base = 0, 1
    for part in reversed(digits.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _resolve_plain(s: str) -> Any:
    """The value of a plain (unquoted) scalar, as YAML 1.1 resolves it."""
    try:
        return _resolve_plain_value(s)
    except YAMLError:
        raise
    except ValueError as e:  # e.g. "0b_": PyYAML's constructor fails on it too
        raise YAMLError(f"cannot read {s!r} as the number its form says: {e}") from e


def _resolve_plain_value(s: str) -> Any:
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if s[0] in "-+0123456789" and _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if s[0] in "-+0123456789." and _FLOAT.match(s):
        v = s.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if s[0] in "0123456789" and _TIMESTAMP.match(s):
        raise YAMLError(f"timestamps are outside the supported YAML subset: {s!r}")
    if s in ("=", "<<"):
        raise YAMLError(f"value and merge keys are outside the supported YAML subset: {s!r}")
    return s


# ---------------------------------------------------------------------------
# Scanning within one logical line
# ---------------------------------------------------------------------------

_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_LEN = {"x": 2, "u": 4, "U": 8}


def _scan_quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``s[i]`` and the index after its close."""
    q = s[i]
    out: List[str] = []
    i += 1
    while i < len(s):
        ch = s[i]
        if q == "'" and ch == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and ch == '"':
            return "".join(out), i + 1
        if q == '"' and ch == "\\":
            esc = s[i + 1:i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
                continue
            if esc in _HEX_LEN:
                n = _HEX_LEN[esc]
                code = s[i + 2:i + 2 + n]
                if len(code) != n or not all(c in "0123456789abcdefABCDEF" for c in code):
                    raise YAMLError(f"bad escape in {s!r}")
                out.append(chr(int(code, 16)))
                i += 2 + n
                continue
            raise YAMLError(f"unknown escape \\{esc} in {s!r}")
        out.append(ch)
        i += 1
    raise YAMLError(f"unterminated quoted scalar (quoted scalars over several lines are "
                    f"outside the supported subset): {s!r}")


def _scan_line(line: str) -> Tuple[str, int]:
    """(``line`` without its comment, the flow collections it leaves open).
    Quoted scalars are skipped over; a quote starts one, and a bracket opens
    a flow collection, only where a node starts (or, for brackets, inside a
    flow collection); ``#`` starts a comment at the line's start or after
    white space."""
    depth, i, at_node = 0, 0, True
    while i < len(line):
        ch = line[i]
        if ch in "'\"" and at_node:
            _, i = _scan_quoted(line, i)
            at_node = False
            continue
        if ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip(), depth
        if ch in "[{" and (at_node or depth > 0):
            depth += 1
            at_node = True
        elif ch in "]}" and depth > 0:
            depth -= 1
            at_node = False
        elif ch == "," and depth > 0:
            at_node = True
        elif ch in ":-?" and line[i + 1:i + 2] in ("", " ", "\t"):
            at_node = True
        elif ch not in " \t":
            at_node = False
        i += 1
    return line.rstrip(), depth


def _find_mapping_colon(s: str) -> int:
    """Index of the ``:`` that makes ``s`` a ``key: value`` line, or -1."""
    if not s or s[0] in "[{":
        return -1
    i = 0
    if s[0] in "'\"":
        _, i = _scan_quoted(s, 0)
        while i < len(s) and s[i] == " ":
            i += 1
        return i if s[i:i + 1] == ":" and s[i + 1:i + 2] in ("", " ") else -1
    while i < len(s):
        if s[i] == ":" and s[i + 1:i + 2] in ("", " "):
            return i
        i += 1
    return -1


_BAD_START = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
              ">": "block scalars", "%": "directives", "@": "reserved indicators",
              "`": "reserved indicators", "?": "complex keys", ",": "flow indicators",
              "]": "flow indicators", "}": "flow indicators", "#": "comments without a space",
              ":": "scalars starting with ':'"}


def _check_start(s: str, flow: bool = False) -> None:
    """Raise on a node that starts with an indicator the subset does not read
    (plain scalars cannot start with one; outside flow collections ``?`` and
    ``:`` followed by a non-space can)."""
    if not s or s[0] not in _BAD_START:
        return
    if s[0] in "?:" and not flow and s[1:2] not in ("", " "):
        return
    raise YAMLError(f"{_BAD_START[s[0]]} are outside the supported YAML subset: {s!r}")


# ---------------------------------------------------------------------------
# Flow collections and inline values
# ---------------------------------------------------------------------------


class _Flow:
    def __init__(self, s: str):
        self.s, self.i = s, 0

    def _skip(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def node(self):
        self._skip()
        s = self.s
        if self.i >= len(s):
            raise YAMLError(f"unexpected end of a flow collection: {s!r}")
        ch = s[self.i]
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        if ch in "'\"":
            v, self.i = _scan_quoted(s, self.i)
            return v
        _check_start(s[self.i:], flow=True)
        start = self.i
        while self.i < len(s):
            c = s[self.i]
            if c == "?":
                raise YAMLError(f"complex keys are outside the supported YAML subset: {s!r}")
            if c in ",[]{}" or (c == ":" and s[self.i + 1:self.i + 2] in ("", " ", ",", "[", "]",
                                                                          "{", "}")):
                break
            self.i += 1
        text = s[start:self.i].strip()
        if not text:
            raise YAMLError(f"empty entry in a flow collection: {s!r}")
        return _resolve_plain(text)

    def _seq(self):
        self.i += 1
        out = []
        while True:
            self._skip()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.node())
            self._skip()
            c = self.s[self.i:self.i + 1]
            if c == ":":
                raise YAMLError(f"mappings inside a flow sequence are outside the supported "
                                f"subset: {self.s!r}")
            if c == ",":
                self.i += 1
            elif c != "]":
                raise YAMLError(f"expected ',' or ']' in {self.s!r}")

    def _map(self):
        self.i += 1
        out = {}
        while True:
            self._skip()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = self.node()
            self._skip()
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                self._skip()
                value = None if self.s[self.i:self.i + 1] in (",", "}") else self.node()
            else:
                value = None
            out[_hashable(key)] = value
            self._skip()
            c = self.s[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != "}":
                raise YAMLError(f"expected ',' or '}}' in {self.s!r}")


def _hashable(key):
    if isinstance(key, (list, dict)):
        raise YAMLError(f"collection keys are outside the supported YAML subset: {key!r}")
    return key


def _inline(s: str) -> Any:
    """A value written on one (logical) line: a flow collection or a scalar."""
    if s[0] in "[{":
        f = _Flow(s)
        v = f.node()
        f._skip()
        if f.i != len(s):
            raise YAMLError(f"unexpected text after a flow collection: {s!r}")
        return v
    if s[0] in "'\"":
        v, end = _scan_quoted(s, 0)
        if s[end:].strip():
            raise YAMLError(f"unexpected text after a quoted scalar: {s!r}")
        return v
    _check_start(s)
    if s == "-" or s.startswith("- "):
        raise YAMLError(f"a block sequence cannot start inside a line: {s!r}")
    if ": " in s or s.endswith(":"):
        raise YAMLError(f"mapping values are not allowed here: {s!r}")
    return _resolve_plain(s)


# ---------------------------------------------------------------------------
# Block structure
# ---------------------------------------------------------------------------


class _Line:
    __slots__ = ("indent", "text")

    def __init__(self, indent: int, text: str):
        self.indent, self.text = indent, text


def _logical_lines(text: str) -> List[_Line]:
    out: List[_Line] = []
    pending = None  # an open flow collection continues on the next lines
    for raw in text.splitlines():
        body = raw.lstrip(" ")
        if body.startswith("\t") and body.strip():
            raise YAMLError("tabs in indentation are not YAML")
        if pending is not None:
            nxt = _scan_line(body)[0].strip()
            if nxt and pending.text[-1] not in "[{,:" and nxt[0] not in "]},":
                raise YAMLError("a scalar or key over several lines is outside the supported "
                                f"subset: {pending.text!r}")
            if nxt:
                pending.text += " " + nxt
            if _scan_line(pending.text)[1] <= 0:
                pending = None
            continue
        stripped, depth = _scan_line(body)
        if not stripped.strip():
            continue
        if stripped in ("---", "...") or stripped.startswith(("--- ", "... ")):
            raise YAMLError("document markers are outside the supported YAML subset")
        if stripped.startswith("%"):
            raise YAMLError("directives are outside the supported YAML subset")
        line = _Line(len(raw) - len(body), stripped)
        out.append(line)
        if depth > 0:
            pending = line
    if pending is not None:
        raise YAMLError("unterminated flow collection")
    return out


def _is_seq_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Block:
    def __init__(self, lines: List[_Line]):
        self.lines = lines

    def node(self, i: int, indent: int) -> Tuple[Any, int]:
        line = self.lines[i]
        if _is_seq_item(line.text):
            return self.sequence(i, line.indent)
        if _find_mapping_colon(line.text) >= 0:
            return self.mapping(i, line.indent)
        if i + 1 < len(self.lines) and self.lines[i + 1].indent >= indent:
            raise YAMLError(f"plain scalars over several lines are outside the supported "
                            f"subset: {line.text!r}")
        return _inline(line.text), i + 1

    def _value(self, rest: str, i: int, indent: int, seq_at_same_indent: bool) -> Tuple[Any, int]:
        """The value after ``key:`` or ``-`` on line ``i - 1``; ``rest`` is the
        text that followed on that line."""
        if rest:
            return _inline(rest), i
        if i < len(self.lines):
            nxt = self.lines[i]
            if nxt.indent > indent or (seq_at_same_indent and nxt.indent == indent
                                       and _is_seq_item(nxt.text)):
                return self.node(i, nxt.indent)
        return None, i

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out: dict = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            text = self.lines[i].text
            if _is_seq_item(text):
                raise YAMLError(f"a sequence item where a mapping key was expected: {text!r}")
            _check_start(text)
            colon = _find_mapping_colon(text)
            if colon < 0:
                raise YAMLError(f"expected 'key: value', got {text!r}")
            key_text = text[:colon].strip()
            if not key_text:
                raise YAMLError(f"empty mapping keys are outside the supported subset: {text!r}")
            _check_start(key_text)
            key = (_scan_quoted(key_text, 0)[0] if key_text[0] in ("'", '"')
                   else _resolve_plain(key_text))
            value, i = self._value(text[colon + 1:].strip(), i + 1, indent, True)
            out[_hashable(key)] = value
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise YAMLError(f"bad indentation: {self.lines[i].text!r}")
        return out, i

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out: list = []
        while i < len(self.lines) and self.lines[i].indent == indent \
                and _is_seq_item(self.lines[i].text):
            text = self.lines[i].text
            rest = text[1:].lstrip(" ")
            if rest and (_is_seq_item(rest) or _find_mapping_colon(rest) >= 0):
                # "- key: value" / "- - item": a nested block whose first line
                # starts after the dash
                self.lines[i] = _Line(indent + len(text) - len(rest), rest)
                value, i = self.node(i, self.lines[i].indent)
            else:
                value, i = self._value(rest, i + 1, indent, False)
            out.append(value)
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise YAMLError(f"bad indentation: {self.lines[i].text!r}")
        return out, i


def safe_load(text) -> Any:
    """Parse one YAML document of the supported subset (``text`` a string or
    a file object); an empty document is None."""
    if hasattr(text, "read"):
        text = text.read()
    if text.startswith("\ufeff"):
        text = text[1:]
    lines = _logical_lines(text)
    if not lines:
        return None
    value, i = _Block(lines).node(0, lines[0].indent)
    if i != len(lines):
        raise YAMLError(f"unexpected text: {lines[i].text!r}")
    return value


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _scalar(v) -> str:
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
        r = repr(v)
        if "e" in r:  # YAML 1.1 needs a dot in the mantissa and a signed exponent
            mant, exp = r.split("e")
            mant = mant if "." in mant else mant + ".0"
            exp = exp if exp[0] in "+-" else "+" + exp
            r = f"{mant}e{exp}"
        return r
    if isinstance(v, str):
        return json.dumps(v, ensure_ascii=False)
    raise TypeError(f"cannot write {type(v).__name__} as YAML: {v!r}")


def _is_scalar(v) -> bool:
    return not isinstance(v, (dict, list, tuple))


def _emit(v, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            key = _scalar(k)
            if _is_scalar(x) or not x or (isinstance(x, (list, tuple)) and all(map(_is_scalar, x))):
                out.append(f"{pad}{key}: {_flow(x)}")
            else:
                out.append(f"{pad}{key}:")
                _emit(x, indent + 2, out)
    else:
        for x in v:
            if _is_scalar(x) or not x or (isinstance(x, (list, tuple)) and all(map(_is_scalar, x))):
                out.append(f"{pad}- {_flow(x)}")
            else:
                out.append(f"{pad}-")
                _emit(x, indent + 2, out)


def _flow(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_scalar(x) for x in v) + "]"
    return _scalar(v)


def safe_dump(data, stream=None) -> str:
    """Write ``data`` as YAML (block style; scalar lists in flow style;
    strings double-quoted).  Returns the text, and writes it to ``stream``
    when one is given."""
    if _is_scalar(data) or not data:
        text = _flow(data) + "\n"
    else:
        out: List[str] = []
        _emit(data, 0, out)
        text = "\n".join(out) + "\n"
    if stream is not None:
        stream.write(text)
    return text
