"""A reader for the subset of YAML that the experiment configs use.

The configs (`examples/configs/*.yaml`) and the ``key=value`` overrides of
the entry points need: block mappings by indentation; one-line flow
sequences and mappings (``[128, 128]``, ``{list_logger: null}``); plain
scalars; single- and double-quoted strings; ``#`` comments.  Plain scalars
resolve as PyYAML's ``safe_load`` resolves them (YAML 1.1): ``null``/``~``/
empty, the eleven spellings each of true and false (``yes``, ``on``, ...),
ints with ``_`` and in binary, octal, hex or base 60, floats only with a
dot (so ``1e-4`` stays the *string* ``'1e-4'``), ``.inf`` and ``.nan``;
anything else is a string.  What the subset does not cover (block
sequences, anchors, tags, multi-line scalars or flow collections,
timestamps, documents markers) is refused with its line number, never
guessed at.
"""
import math
import re
from typing import Any, List, Optional, Tuple

__all__ = ["YAMLSubsetError", "safe_load"]


class YAMLSubsetError(ValueError):
    """Text outside the subset, or malformed; the message names the line."""


_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
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
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_INDICATORS = "&*!|>%@`"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(sign: int, text: str, cast) -> Any:
    value = cast(0)
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _resolve_plain(text: str, line: int) -> Any:
    """A plain scalar as PyYAML's YAML 1.1 resolver reads it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if ":" in v:
            return _sexagesimal(sign, v, int)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return _sexagesimal(sign, v, float)
        return sign * float(v)
    if _TIMESTAMP.match(text) or text in ("<<", "="):
        raise YAMLSubsetError(f"line {line}: {text!r} (a timestamp, merge key or value key) "
                              "is outside the subset")
    if text[0] in _INDICATORS or text[:2] in ("- ", "? ") or text in ("-", "?"):
        raise YAMLSubsetError(f"line {line}: {text!r} starts with an indicator outside the subset")
    return text


def _strip_comment(text: str, line: int) -> str:
    """The line without its comment (a ``#`` at the start or after a blank,
    outside quotes)."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if text[i + 1 : i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    if quote is not None:
        raise YAMLSubsetError(f"line {line}: unterminated quoted string (multi-line scalars are "
                              "outside the subset)")
    return text.rstrip()


class _Cursor:
    """A position in one line of text, for the flow and scalar parsers."""

    def __init__(self, text: str, line: int, pos: int = 0):
        self.text, self.line, self.pos = text, line, pos

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def skip_blanks(self) -> None:
        while self.peek() in (" ", "\t"):
            self.pos += 1

    def error(self, what: str) -> YAMLSubsetError:
        return YAMLSubsetError(f"line {self.line}, column {self.pos + 1}: {what}")

    def quoted(self) -> str:
        q = self.text[self.pos]
        self.pos += 1
        out: List[str] = []
        while True:
            c = self.peek()
            if not c:
                raise self.error("unterminated quoted string")
            self.pos += 1
            if q == "'":
                if c == "'":
                    if self.peek() == "'":
                        out.append("'")
                        self.pos += 1
                        continue
                    return "".join(out)
                out.append(c)
            elif c == '"':
                return "".join(out)
            elif c == "\\":
                e = self.peek()
                self.pos += 1
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                elif e in _HEX_ESCAPES:
                    digits = self.text[self.pos : self.pos + _HEX_ESCAPES[e]]
                    if len(digits) != _HEX_ESCAPES[e] or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                        raise self.error(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.pos += len(digits)
                else:
                    raise self.error(f"escape \\{e} is outside the subset")
            else:
                out.append(c)

    def plain(self, flow: bool) -> str:
        """A plain scalar up to a ``: `` (or ``:`` at a flow indicator or the
        end) and, in flow context, up to ``,[]{}``."""
        start = self.pos
        while self.pos < len(self.text):
            c = self.text[self.pos]
            nxt = self.text[self.pos + 1 : self.pos + 2]
            if c == ":" and (nxt in ("", " ", "\t") or (flow and nxt in ",[]{}")):
                break
            if flow and c in ",[]{}":
                break
            self.pos += 1
        return self.text[start : self.pos].rstrip()

    def scalar(self, flow: bool) -> Tuple[Any, bool]:
        """``(value, was_quoted)``."""
        if self.peek() in ("'", '"'):
            return self.quoted(), True
        text = self.plain(flow)
        return _resolve_plain(text, self.line), False

    def node(self) -> Any:
        """A flow collection or a scalar, in flow context."""
        self.skip_blanks()
        c = self.peek()
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        return self.scalar(flow=True)[0]

    def sequence(self) -> list:
        self.pos += 1
        out = []
        while True:
            self.skip_blanks()
            if self.peek() == "]":
                self.pos += 1
                return out
            out.append(self.node())
            self.skip_blanks()
            c = self.peek()
            if c == ",":
                self.pos += 1
            elif c != "]":
                raise self.error("expected ',' or ']' (multi-line flow sequences are outside the subset)")

    def mapping(self) -> dict:
        self.pos += 1
        out = {}
        while True:
            self.skip_blanks()
            if self.peek() == "}":
                self.pos += 1
                return out
            if self.peek() in ("[", "{"):
                raise self.error("complex mapping keys are outside the subset")
            key = self.scalar(flow=True)[0]
            self.skip_blanks()
            if self.peek() != ":":
                raise self.error("expected ':' after a flow mapping key")
            self.pos += 1
            self.skip_blanks()
            out[key] = None if self.peek() in (",", "}") else self.node()
            self.skip_blanks()
            c = self.peek()
            if c == ",":
                self.pos += 1
            elif c != "}":
                raise self.error("expected ',' or '}' (multi-line flow mappings are outside the subset)")

    def end(self) -> None:
        self.skip_blanks()
        if self.pos != len(self.text):
            raise self.error(f"unexpected {self.text[self.pos:]!r}")


def _value(text: str, line: int, pos: int) -> Any:
    """A whole value on one line: a flow collection or a scalar."""
    cur = _Cursor(text, line, pos)
    cur.skip_blanks()
    if cur.peek() in ("[", "{"):
        value = cur.node()
    else:
        value, quoted = cur.scalar(flow=False)
        if not quoted and cur.pos != len(text):
            raise cur.error("mapping values are not allowed here")
    cur.end()
    return value


def _key(text: str, line: int) -> Optional[Tuple[Any, int]]:
    """``(key, position after its ':')`` if the line starts a block mapping
    entry, else None."""
    cur = _Cursor(text, line)
    if cur.peek() in ("[", "{"):
        return None
    key, _ = cur.scalar(flow=False)
    if cur.peek() != ":" or cur.text[cur.pos + 1 : cur.pos + 2] not in ("", " ", "\t"):
        return None
    return key, cur.pos + 1


def _mapping(lines: List[Tuple[int, int, str]], i: int, indent: int) -> Tuple[dict, int]:
    """The block mapping whose entries sit at ``indent``, from ``lines[i]``."""
    out = {}
    while i < len(lines):
        ind, line, text = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise YAMLSubsetError(f"line {line}: unexpected indentation")
        if text.startswith("- ") or text == "-":
            raise YAMLSubsetError(f"line {line}: block sequences are outside the subset")
        entry = _key(text, line)
        if entry is None:
            raise YAMLSubsetError(f"line {line}: expected 'key: value' in a block mapping")
        key, pos = entry
        i += 1
        if text[pos:].strip():
            out[key] = _value(text, line, pos)
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _mapping(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def safe_load(text: str) -> Any:
    """Parse one document of the subset, as ``yaml.safe_load`` would."""
    lines = []
    for n, raw in enumerate(text.splitlines(), start=1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise YAMLSubsetError(f"line {n}: tab indentation")
        body = _strip_comment(body, n)
        if not body:
            continue
        if body in ("---", "...") or body.startswith(("--- ", "%")):
            raise YAMLSubsetError(f"line {n}: document markers and directives are outside the subset")
        lines.append((len(raw) - len(raw.lstrip(" ")), n, body))
    if not lines:
        return None
    indent, line, body = lines[0]
    if _key(body, line) is not None or body.startswith("- ") or body == "-":
        out, i = _mapping(lines, 0, indent)
        if i != len(lines):
            raise YAMLSubsetError(f"line {lines[i][1]}: unexpected dedent below the document's indentation")
        return out
    if len(lines) > 1:
        raise YAMLSubsetError(f"line {lines[1][1]}: multi-line scalars are outside the subset")
    return _value(body, line, 0)
