"""The YAML the spec-test files use, read and written without PyYAML.

The runners read `meta.yaml`, `slots.yaml` and `mapping.yaml` (the JAX
package's `spec_test/` loads them with `yaml.safe_load` and writes them
with `yaml.safe_dump`). The card's machine has no PyYAML, so the port
carries the subset those files need:

- block sequences (also the indentless form `key:\\n- 1`) and flow
  sequences `[1, 2]`;
- block mappings, flat and nested, and flow mappings `{a: 1}` (the
  official `mapping.yaml` is one line of flow);
- integers (decimal, and YAML 1.1's `0x`, `0b` and `0` octal forms, with
  `_` separators), booleans (YAML 1.1's true/false/yes/no/on/off), null
  (`~`, `null`, empty), plain, single- and double-quoted strings;
- comments, a leading `---` and a trailing `...`.

Scalars resolve as PyYAML's `safe_load` resolves them. Anything else
(floats, timestamps, anchors and aliases, tags, block scalars, multi-line
plain scalars, complex keys, several documents, duplicate keys, tabs in
indentation) raises `YamlSubsetError` rather than being guessed at.
`dump` writes what `load` and PyYAML's `safe_load` read back equal: keys
sorted, lists indentless under a key, a top-level scalar ended by `...`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass


class YamlSubsetError(ValueError):
    pass


_BOOLS = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOLS.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                  "OFF")})
_NULLS = ("", "~", "null", "Null", "NULL")
_INT_FORMS = (
    (re.compile(r"[-+]?0b[0-1_]+"), 2, "0b"),
    (re.compile(r"[-+]?0x[0-9a-fA-F_]+"), 16, "0x"),
    (re.compile(r"[-+]?0[0-7_]+"), 8, "0"),
    (re.compile(r"[-+]?(?:0|[1-9][0-9_]*)"), 10, ""),
)
_UNSUPPORTED = (
    (re.compile(r"[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"), "a sexagesimal integer"),
    (re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"), "a float"),
    (re.compile(r"[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                r"(?:(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9]"
                r"(?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)?"), "a timestamp"),
    (re.compile(r"<<|="), "a merge key or value indicator"),
)
_PLAIN_START_BANNED = set("[]{}#&*!|>%@`,")
_SAFE_PLAIN = re.compile(r"[A-Za-z_][A-Za-z0-9_./-]*")


def _resolve(text: str, where: str):
    """A plain scalar's value, as PyYAML's safe_load resolves it."""
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    for pattern, base, prefix in _INT_FORMS:
        if pattern.fullmatch(text):
            digits = text.replace("_", "")
            sign = -1 if digits.startswith("-") else 1
            digits = digits.lstrip("+-")
            if prefix:
                digits = digits[len(prefix):] if base != 8 else digits[1:]
            return sign * int(digits or "0", base)
    for pattern, what in _UNSUPPORTED:
        if pattern.fullmatch(text):
            raise YamlSubsetError(f"{where}: {what} ({text!r}) is not supported")
    if text[0] in _PLAIN_START_BANNED or text[0] in "-?:" and (len(text) == 1 or text[1] == " "):
        raise YamlSubsetError(f"{where}: unsupported plain scalar {text!r}")
    if ": " in text or text.endswith(":") or " #" in text:
        raise YamlSubsetError(f"{where}: ambiguous plain scalar {text!r}")
    return text


@dataclass
class _Line:
    number: int
    indent: int
    text: str


def _strip_comment(text: str) -> str:
    """`text` without its comment (a `#` at the start or after blank,
    outside quotes)."""
    quote = None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                if quote == "'" and i + 1 < len(text) and text[i + 1] == "'":
                    continue
                quote = None
            elif quote == '"' and c == "\\":
                continue
        elif c in "'\"" and (i == 0 or text[i - 1] in " [{,:-"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _lines(source: str) -> list[_Line]:
    out: list[_Line] = []
    ended = False
    for number, raw in enumerate(source.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t") or ("\t" in raw[: len(raw) - len(body)]):
            raise YamlSubsetError(f"line {number}: a tab in the indentation")
        text = _strip_comment(body)
        if not text:
            continue
        indent = len(raw) - len(body)
        if ended:
            raise YamlSubsetError(f"line {number}: content after the document's end")
        if indent == 0 and text == "---":
            if out:
                raise YamlSubsetError(f"line {number}: a second document")
            continue
        if indent == 0 and text == "...":
            ended = True
            continue
        if indent == 0 and (text.startswith("--- ") or text.startswith("%")):
            raise YamlSubsetError(f"line {number}: unsupported directive or marker")
        out.append(_Line(number, indent, text))
    return out


def _quoted(text: str, i: int, where: str) -> tuple[str, int]:
    """The quoted string starting at text[i]; (value, index past it)."""
    quote, j, out = text[i], i + 1, []
    while j < len(text):
        c = text[j]
        if c == quote:
            if quote == "'" and j + 1 < len(text) and text[j + 1] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if quote == '"' and c == "\\":
            esc = text[j + 1: j + 2]
            simple = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/", "0": "\0",
                      "r": "\r", " ": " "}
            if esc in simple:
                out.append(simple[esc])
                j += 2
                continue
            width = {"x": 2, "u": 4, "U": 8}.get(esc)
            digits = text[j + 2: j + 2 + (width or 0)]
            if not width or len(digits) != width or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                raise YamlSubsetError(f"{where}: unsupported escape \\{esc}")
            out.append(chr(int(digits, 16)))
            j += 2 + width
            continue
        out.append(c)
        j += 1
    raise YamlSubsetError(f"{where}: unterminated quoted string")


class _Flow:
    """A flow collection or scalar on one line: `[1, 'a', {b: 2}]`."""

    def __init__(self, text: str, where: str):
        self.text, self.i, self.where = text, 0, where

    def _blank(self):
        while self.i < len(self.text) and self.text[self.i] == " ":
            self.i += 1

    def _peek(self) -> str:
        self._blank()
        return self.text[self.i: self.i + 1]

    def _expect(self, c: str):
        if self._peek() != c:
            raise YamlSubsetError(f"{self.where}: expected {c!r} in {self.text!r}")
        self.i += 1

    def value(self, in_map: bool = False):
        c = self._peek()
        if c == "[":
            self.i += 1
            items = []
            if self._peek() == "]":
                self.i += 1
                return items
            while True:
                items.append(self.value())
                if self._peek() == ",":
                    self.i += 1
                    continue
                self._expect("]")
                return items
        if c == "{":
            self.i += 1
            out = {}
            if self._peek() == "}":
                self.i += 1
                return out
            while True:
                key = self.value(in_map=True)
                if isinstance(key, (list, dict)):
                    raise YamlSubsetError(f"{self.where}: a complex key")
                self._expect(":")
                if key in out:
                    raise YamlSubsetError(f"{self.where}: duplicate key {key!r}")
                out[key] = self.value()
                if self._peek() == ",":
                    self.i += 1
                    continue
                self._expect("}")
                return out
        if c in ("'", '"'):
            value, self.i = _quoted(self.text, self.i, self.where)
            return value
        start = self.i
        while self.i < len(self.text):
            ch = self.text[self.i]
            if ch in ",[]{}" or ch == ":" and (in_map and (
                    self.i + 1 == len(self.text) or self.text[self.i + 1] in " ,}")):
                break
            self.i += 1
        return _resolve(self.text[start: self.i].strip(), self.where)

    def done(self):
        self._blank()
        if self.i != len(self.text):
            raise YamlSubsetError(f"{self.where}: trailing text {self.text[self.i:]!r}")


def _open_brackets(text: str) -> int:
    """`[`/`{` opened minus closed in `text`, outside quotes."""
    depth, i = 0, 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " [{,:"):
            _, i = _quoted(text, i, "flow")
            continue
        depth += (c in "[{") - (c in "]}")
        i += 1
    return depth


def _inline(text: str, where: str):
    if text[0] in "&*!|>":
        raise YamlSubsetError(f"{where}: anchors, aliases, tags and block scalars are not "
                              f"supported ({text!r})")
    if text[0] in "[{'\"":
        flow = _Flow(text, where)
        value = flow.value()
        flow.done()
        return value
    return _resolve(text, where)


def _key_split(text: str, where: str):
    """(key, rest) of a `key: value` line, or None when it is no mapping entry."""
    if text[0] == "?":
        raise YamlSubsetError(f"{where}: a complex key")
    if text[0] in "[{":
        flow = _Flow(text, where)
        flow.value()
        if flow._peek() == ":":
            raise YamlSubsetError(f"{where}: a complex key")
        return None
    if text[0] in "'\"":
        key, j = _quoted(text, 0, where)
        rest = text[j:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    j = _find_colon(text, 0)
    if j is None:
        return None
    return _resolve(text[:j].strip(), where), text[j + 1:].strip()


def _find_colon(text: str, start: int):
    for j in range(start, len(text)):
        if text[j] == ":" and (j + 1 == len(text) or text[j + 1] == " "):
            return j
    return None


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Block:
    def __init__(self, lines: list[_Line]):
        self.lines = lines

    def where(self, i: int) -> str:
        return f"line {self.lines[min(i, len(self.lines) - 1)].number}"

    def _value(self, i: int, text: str, indent: int):
        """(index past it, value) of the inline `text` on line i: a flow
        collection may go on over the next lines, each indented deeper
        than `indent`; a plain or quoted scalar may not."""
        if text[0] in "[{":
            while _open_brackets(text) > 0 and i + 1 < len(self.lines) \
                    and self.lines[i + 1].indent > indent:
                i += 1
                text = f"{text} {self.lines[i].text}"
        value = _inline(text, self.where(i))
        if i + 1 < len(self.lines) and self.lines[i + 1].indent > indent:
            raise YamlSubsetError(f"{self.where(i + 1)}: a multi-line scalar")
        return i + 1, value

    def node(self, i: int, indent: int):
        line = self.lines[i]
        if _is_item(line.text):
            return self.sequence(i, indent)
        if line.text[0] in "[{":  # a flow collection, maybe over several lines
            return self._value(i, line.text, indent - 1)
        if _key_split(line.text, self.where(i)) is not None:
            return self.mapping(i, indent)
        return self._value(i, line.text, indent)

    def _nested(self, i: int, rest: str, col: int):
        """The node written after `- ` on line i, at column `col`."""
        self.lines[i] = _Line(self.lines[i].number, col, rest)
        return self.node(i, col)

    def sequence(self, i: int, indent: int):
        items = []
        while i < len(self.lines) and self.lines[i].indent == indent \
                and _is_item(self.lines[i].text):
            line = self.lines[i]
            rest = line.text[1:].lstrip(" ")
            if rest:
                i, value = self._nested(i, rest, indent + len(line.text) - len(rest))
            elif i + 1 < len(self.lines) and self.lines[i + 1].indent > indent:
                i, value = self.node(i + 1, self.lines[i + 1].indent)
            else:
                i, value = i + 1, None
            items.append(value)
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise YamlSubsetError(f"{self.where(i)}: bad indentation")
        return i, items

    def mapping(self, i: int, indent: int):
        out = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            split = _key_split(line.text, self.where(i))
            if split is None:
                raise YamlSubsetError(f"{self.where(i)}: expected a `key: value` entry")
            key, rest = split
            if key in out:
                raise YamlSubsetError(f"{self.where(i)}: duplicate key {key!r}")
            if rest:
                i, value = self._value(i, rest, indent)
            elif i + 1 < len(self.lines) and self.lines[i + 1].indent > indent:
                i, value = self.node(i + 1, self.lines[i + 1].indent)
            elif i + 1 < len(self.lines) and self.lines[i + 1].indent == indent \
                    and _is_item(self.lines[i + 1].text):
                i, value = self.sequence(i + 1, indent)
            else:
                i, value = i + 1, None
            out[key] = value
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise YamlSubsetError(f"{self.where(i)}: bad indentation")
        return i, out


def load(source):
    """The value of one YAML document in the subset (bytes are UTF-8)."""
    if isinstance(source, (bytes, bytearray)):
        source = bytes(source).decode("utf-8")
    lines = _lines(source)
    if not lines:
        return None
    block = _Block(lines)
    i, value = block.node(0, lines[0].indent)
    if i != len(lines):
        raise YamlSubsetError(f"{block.where(i)}: unexpected content")
    return value


def _scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, str):
        if "\n" in value or "\r" in value:
            raise YamlSubsetError("multi-line strings are not supported")
        try:
            plain = _SAFE_PLAIN.fullmatch(value) and _resolve(value, "dump") == value
        except YamlSubsetError:
            plain = False
        return value if plain else "'" + value.replace("'", "''") + "'"
    raise YamlSubsetError(f"cannot write a {type(value).__name__}")


def _inline_text(value) -> str:
    if isinstance(value, dict) and not value:
        return "{}"
    if isinstance(value, (list, tuple)) and not value:
        return "[]"
    return _scalar(value)


def _dump(value, indent: int) -> list[str]:
    pad = " " * indent
    if isinstance(value, dict):
        out = []
        try:
            keys = sorted(value)
        except TypeError:  # keys of mixed types: as given
            keys = list(value)
        for key in keys:
            v = value[key]
            if isinstance(v, dict) and v:
                out.append(f"{pad}{_scalar(key)}:")
                out += _dump(v, indent + 2)
            elif isinstance(v, (list, tuple)) and v:
                out.append(f"{pad}{_scalar(key)}:")
                out += _dump(v, indent)
            else:
                out.append(f"{pad}{_scalar(key)}: {_inline_text(v)}")
        return out
    out = []
    for item in value:
        if isinstance(item, (dict, list, tuple)) and item:
            inner = _dump(item, indent + 2)
            out.append(f"{pad}- {inner[0][indent + 2:]}")
            out += inner[1:]
        else:
            out.append(f"{pad}- {_inline_text(item)}")
    return out


def dump(value) -> str:
    """One YAML document of `value` (dicts, lists, ints, bools, None and
    one-line strings)."""
    if isinstance(value, (dict, list, tuple)):
        if not value:
            return _inline_text(value) + "\n"
        return "\n".join(_dump(value, 0)) + "\n"
    return _scalar(value) + "\n...\n"
