"""A standard-library reader and writer for the YAML of the experiment
configs, for hosts without PyYAML.

`load(text)` reads the subset that `configs/*.yaml` and config snapshots
use, and gives the same Python objects as PyYAML's `yaml.safe_load`:

- block mappings and block sequences (also a sequence at its key's
  indent, and compact `- key: value` items), comments;
- flow sequences `[128, 256]` and flow mappings `{a: 1, b: [2]}` on one
  line, nested;
- anchors `&name`, aliases `*name` (the same object, as PyYAML gives) and
  `<<:` merge keys, of one mapping or a sequence of mappings;
- plain scalars resolved by YAML 1.1 as PyYAML resolves them (null, bool,
  int with `_`, 0x, 0b and 0-octal forms, floats only with a dot or as
  .inf / .nan: `1e-5` stays a string, `2.0e-5` is a float), single- and
  double-quoted strings.

Anything else raises `YAMLError` with its line: tags, block scalars
(`|`, `>`), multi-line plain or quoted scalars and flow collections,
documents markers and directives, complex keys, timestamps and
sexagesimal numbers. The reader never guesses at a construct it does not
know.

`dump(obj)` writes a dict of dicts, lists and scalars as block mappings
with flow lists, in the forms `load` and `yaml.safe_load` read back to an
equal object.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any

__all__ = ["YAMLError", "dump", "load"]


class YAMLError(ValueError):
    """A document outside the subset this reader knows."""


# PyYAML's implicit resolvers of YAML 1.1 (yaml/resolver.py)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
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
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                    (?:[Tt]|[ \t]+)[0-9][0-9]?
                    :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_BOOLS = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ",
            "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# a plain scalar may not start with these (nor with "-", "?", ":" before a space)
_INDICATORS = set(",[]{}#&*!|>'\"%@`")


def resolve_plain(text: str, line: int = 0) -> Any:
    """The value of a plain scalar as PyYAML's SafeLoader resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return _BOOLS[text.lower()]
    if _INT.match(text) or _FLOAT.match(text) or _TIMESTAMP.match(text):
        if ":" in text or _TIMESTAMP.match(text):
            raise YAMLError(f"line {line}: sexagesimal numbers and timestamps are "
                            f"not supported: {text!r}")
        if _INT.match(text):
            v, sign = text.replace("_", ""), 1
            if v[0] in "+-":
                sign, v = (-1 if v[0] == "-" else 1), v[1:]
            if v == "0":
                return 0
            if v.startswith("0b"):
                return sign * int(v[2:], 2)
            if v.startswith("0x"):
                return sign * int(v[2:], 16)
            if v[0] == "0":
                return sign * int(v, 8)
            return sign * int(v)
        v, sign = text.replace("_", "").lower(), 1
        if v[0] in "+-":
            sign, v = (-1 if v[0] == "-" else 1), v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * float(v)
    if text == "=":
        raise YAMLError(f"line {line}: the value key '=' is not supported")
    return text


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no, indent, text):
        self.no, self.indent, self.text = no, indent, text


def _strip_comment(s: str, no: int) -> str:
    """`s` without its comment: a '#' at the start or after a space, outside
    quoted scalars (a quote opens one only where a scalar may start)."""
    quote = None
    i = 0
    while i < len(s):
        c = s[i]
        if quote == "'":
            if c == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i].rstrip()
        elif c in "'\"":
            before = s[:i].rstrip()
            # a scalar starts after an indicator or an anchor / tag
            if not before or before[-1] in ":-[{,?" or before.split()[-1][0] in "&!":
                quote = c
        i += 1
    if quote is not None:
        raise YAMLError(f"line {no}: a quoted scalar that does not end on its line")
    return s.rstrip()


def _lines(text: str) -> list[_Line]:
    out = []
    for no, raw in enumerate(text.lstrip("﻿").splitlines(), 1):
        body = raw.lstrip(" ")
        content = _strip_comment(body, no)
        if not content.strip():
            continue
        if body.startswith("\t"):
            raise YAMLError(f"line {no}: tabs in indentation")
        if content.startswith("%") or content in ("---", "...") or \
                content.startswith(("--- ", "... ")):
            raise YAMLError(f"line {no}: document markers and directives are not supported")
        out.append(_Line(no, len(raw) - len(body), content))
    return out


def _is_seq_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _key_split(text: str) -> int:
    """Index of the ':' that ends a block mapping key in `text`, or -1:
    the first ':' followed by a space or the end, outside quotes and flow
    brackets."""
    quote, depth, i = None, 0, 0
    if text[:1] in "'\"":
        quote = text[0]
        i = 1
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if i + 1 < len(text) and text[i + 1] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth <= 0 and (i + 1 == len(text) or text[i + 1] == " "):
            return i
        i += 1
    return -1


class _Parser:
    def __init__(self, lines: list[_Line]):
        self.lines = lines
        self.i = 0
        self.anchors: dict[str, Any] = {}

    def fail(self, msg, no=None):
        if no is None:
            no = self.lines[min(self.i, len(self.lines) - 1)].no if self.lines else 0
        raise YAMLError(f"line {no}: {msg}")

    # ----- block context -------------------------------------------------

    def document(self):
        if not self.lines:
            return None
        first = self.lines[0]
        if first.indent:
            self.fail("the document is indented")
        if _is_seq_item(first.text) or _key_split(first.text) >= 0:
            value = self.block(0)
        else:
            self.i = 1
            value = self.inline(first.text, first.no)
            if len(self.lines) > 1:
                self.fail("text after a scalar document", self.lines[1].no)
        if self.i != len(self.lines):
            self.fail("a line outside the document's structure (check its indent)",
                      self.lines[self.i].no)
        return value

    def block(self, indent):
        line = self.lines[self.i]
        if line.indent != indent:
            self.fail("bad indentation")
        return self.sequence(indent) if _is_seq_item(line.text) else self.mapping(indent)

    def mapping(self, indent):
        pairs, merges = [], []
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent < indent:
                break
            if line.indent > indent:
                self.fail("bad indentation")
            if _is_seq_item(line.text):
                self.fail("a sequence item inside a mapping")
            cut = _key_split(line.text)
            if cut < 0:
                self.fail("expected 'key: value'")
            key_text, rest = line.text[:cut].rstrip(), line.text[cut + 1:].strip()
            self.i += 1
            is_merge = key_text == "<<"
            key = None if is_merge else self.key(key_text, line.no)
            value = self.value(rest, indent, line.no, mapping_value=True)
            if is_merge:
                merges.append((value, line.no))
            else:
                pairs.append((key, value))
        return self.build_mapping(pairs, merges)

    def sequence(self, indent):
        items = []
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent < indent:
                break
            if line.indent > indent:
                self.fail("bad indentation in a sequence")
            if not _is_seq_item(line.text):
                break
            rest = line.text[1:]
            inner = rest.lstrip(" ")
            if inner and (_is_seq_item(inner) or (_key_split(inner) >= 0
                                                  and inner[0] not in "[{&*")):
                # a compact collection: its first line starts after the dash
                self.lines[self.i] = _Line(line.no, indent + 1 + len(rest) - len(inner), inner)
                items.append(self.block(self.lines[self.i].indent))
            else:
                self.i += 1
                items.append(self.value(inner, indent, line.no, mapping_value=False))
        return items

    def value(self, rest, indent, no, mapping_value):
        """The value after 'key:' or '-' on line `no`: inline, or the block
        on the lines below."""
        anchor = None
        if rest.startswith("&"):
            name, _, rest = rest[1:].partition(" ")
            if not name:
                self.fail("an empty anchor name", no)
            anchor, rest = name, rest.strip()
        if rest:
            value = self.inline(rest, no)
            if self.i < len(self.lines) and self.lines[self.i].indent > indent:
                self.fail("a scalar continued on the next line is not supported",
                          self.lines[self.i].no)
        elif self.i < len(self.lines) and (
                self.lines[self.i].indent > indent
                or (mapping_value and self.lines[self.i].indent == indent
                    and _is_seq_item(self.lines[self.i].text))):
            value = self.block(self.lines[self.i].indent)
        else:
            value = None
        if anchor is not None:
            self.anchors[anchor] = value
        return value

    def inline(self, text, no):
        """A value written on one line: alias, flow collection, quoted or
        plain scalar."""
        c = text[0]
        if c == "*":
            return self.alias(text[1:], no)
        if c in "[{\"'":
            value, end = self.flow(text, 0, no)
            if text[end:].strip():
                self.fail(f"text after a value: {text[end:]!r}", no)
            return value
        self.check_plain(text, no)
        if _key_split(text) >= 0:
            self.fail("a mapping inside a plain scalar", no)
        return resolve_plain(text, no)

    def check_plain(self, text, no):
        if text[0] in _INDICATORS or (text[0] in "-?:" and text[1:2] in ("", " ")):
            self.fail(f"unsupported construct {text!r} (tags, block scalars, complex "
                      f"keys and reserved indicators are not read)", no)

    def key(self, text, no):
        if text[:1] in "'\"":
            value, end = self.quoted(text, 0, no)
            if text[end:].strip():
                self.fail(f"text after a quoted key: {text!r}", no)
            return value
        if not text:
            self.fail("an empty key", no)
        self.check_plain(text, no)
        if text[0] in "[{":
            self.fail("flow collections as keys are not supported", no)
        return resolve_plain(text, no)

    def alias(self, name, no):
        name = name.strip()
        if not name or " " in name:
            self.fail(f"bad alias {name!r}", no)
        if name not in self.anchors:
            self.fail(f"alias *{name} before its anchor", no)
        return self.anchors[name]

    def build_mapping(self, pairs, merges):
        """PyYAML's merge: the merged mappings' keys first (of a sequence of
        mappings, the earlier ones win), then the mapping's own keys."""
        merged = []
        for value, no in merges:
            sources = value if isinstance(value, list) else [value]
            if not all(isinstance(s, dict) for s in sources):
                self.fail("a merge key needs a mapping or a sequence of mappings", no)
            for src in reversed(sources):
                merged.extend(src.items())
        out = {}
        for k, v in merged + pairs:
            try:
                out[k] = v
            except TypeError:
                self.fail(f"an unhashable key {k!r}")
        return out

    # ----- flow context --------------------------------------------------

    def flow(self, s, i, no):
        """(value, end index) of the flow node at s[i]."""
        i = _skip(s, i)
        if i >= len(s):
            self.fail("a flow collection that does not end on its line", no)
        c = s[i]
        if c == "[":
            items, i = [], i + 1
            while True:
                i = _skip(s, i)
                if i >= len(s):
                    self.fail("a flow sequence that does not end on its line", no)
                if s[i] == "]":
                    return items, i + 1
                item, i = self.flow(s, i, no)
                i = _skip(s, i)
                if i < len(s) and s[i] == ":":
                    self.fail("single-pair mappings in a flow sequence are not supported", no)
                items.append(item)
                i = self.flow_sep(s, i, "]", no)
        if c == "{":
            pairs, merges, i = [], [], i + 1
            while True:
                i = _skip(s, i)
                if i >= len(s):
                    self.fail("a flow mapping that does not end on its line", no)
                if s[i] == "}":
                    return self.build_mapping(pairs, merges), i + 1
                is_merge = False
                if s[i] in "'\"":
                    key, i = self.quoted(s, i, no)
                else:
                    text, i = self.flow_plain(s, i, no)
                    is_merge = text == "<<"
                    key = None if is_merge else self.key(text, no)
                i = _skip(s, i)
                value = None
                if i < len(s) and s[i] == ":":
                    i = _skip(s, i + 1)
                    if i < len(s) and s[i] not in ",}":
                        value, i = self.flow(s, i, no)
                if is_merge:
                    merges.append((value, no))
                else:
                    pairs.append((key, value))
                i = self.flow_sep(s, i, "}", no)
        if c in "'\"":
            return self.quoted(s, i, no)
        if c == "*":
            j = i + 1
            while j < len(s) and s[j] not in " ,[]{}":
                j += 1
            return self.alias(s[i + 1:j], no), j
        text, j = self.flow_plain(s, i, no)
        return resolve_plain(text, no), j

    def flow_sep(self, s, i, close, no):
        i = _skip(s, i)
        if i < len(s) and s[i] == ",":
            return i + 1
        if i < len(s) and s[i] == close:
            return i
        self.fail(f"expected ',' or {close!r} in a flow collection", no)

    def flow_plain(self, s, i, no):
        """A plain scalar in a flow collection: up to a flow indicator or a
        ':' before a space, an indicator or the end."""
        j = i
        while j < len(s):
            c = s[j]
            if c in ",[]{}":
                break
            if c == ":" and (j + 1 == len(s) or s[j + 1] in " ,[]{}"):
                break
            j += 1
        text = s[i:j].strip()
        if not text:
            self.fail("an empty value in a flow collection", no)
        self.check_plain(text, no)
        return text, j

    def quoted(self, s, i, no):
        """(string, end index) of the quoted scalar at s[i]."""
        q, j, out = s[i], i + 1, []
        while j < len(s):
            c = s[j]
            if q == "'" and c == "'":
                if j + 1 < len(s) and s[j + 1] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            if q == '"' and c == '"':
                return "".join(out), j + 1
            if q == '"' and c == "\\":
                e = s[j + 1:j + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    j += 2
                    continue
                if e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = s[j + 2:j + 2 + n]
                    if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                        self.fail(f"a bad escape \\{e}{digits}", no)
                    out.append(chr(int(digits, 16)))
                    j += 2 + n
                    continue
                self.fail(f"an unknown escape \\{e}", no)
            out.append(c)
            j += 1
        self.fail("a quoted scalar that does not end on its line", no)


def _skip(s, i):
    while i < len(s) and s[i] == " ":
        i += 1
    return i


def load(text: str) -> Any:
    """The object of a YAML document in this module's subset (see the
    module docstring); raises YAMLError on anything else."""
    return _Parser(_lines(text)).document()


# ----- writer ---------------------------------------------------------------

_PLAIN_OK = re.compile(r"^[A-Za-z_][A-Za-z0-9_.\-/]*$")


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
        r = repr(v).lower()
        # PyYAML's representer: a float must show a dot to resolve as one
        if "." not in r and "e" in r:
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, str):
        if _PLAIN_OK.match(v) and resolve_plain(v) == v and v != "<<":
            return v
        return json.dumps(v, ensure_ascii=False)
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as YAML")


def _flow(v) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_scalar(k)}: {_flow(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    return _scalar(v)


def dump(obj: dict) -> str:
    """`obj` (a dict) as block mappings with flow lists."""
    if not isinstance(obj, dict):
        raise TypeError("dump writes a mapping")
    out = []

    def write(d, indent):
        for k, v in d.items():
            head = " " * indent + _scalar(k) + ":"
            if isinstance(v, dict) and v:
                out.append(head)
                write(v, indent + 2)
            else:
                out.append(head + " " + _flow(v))

    write(obj, 0)
    return "\n".join(out) + "\n"
