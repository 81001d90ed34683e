"""yacs-style YAML configs for the CAD detector CLI (port of
``detector/config_yaml.py``).

``_BASE_`` inheritance and dotted CLI ``opts`` overrides, so that the
reference's configs and run recipes work unchanged. Unknown keys are kept.

PyYAML may be missing where the port runs, so :func:`parse_yaml` reads the
subset of YAML the CAD configs use: block mappings by indentation, one-line
flow sequences and mappings, single- and double-quoted and plain scalars,
and ``#`` comments. Plain scalars resolve as
``yaml.safe_load`` resolves them (YAML 1.1 booleans, nulls, ints and
floats; ``1e-5`` without a dot stays a string). :func:`dump_yaml` writes a
config as JSON text with PyYAML's float spelling, which ``yaml.safe_load``
reads back to the same dict.
"""

from __future__ import annotations

import json
import math
import os
import re

_BOOLS = {v: b for b, words in ((True, ("yes", "true", "on")), (False, ("no", "false", "off")))
          for w in words for v in (w, w.capitalize(), w.upper())}
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)([eE][-+][0-9]+)?")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)")
_NAN = re.compile(r"\.(nan|NaN|NAN)")


class YamlSubsetError(ValueError):
    pass


def _plain(s: str):
    """A plain scalar resolved as PyYAML's implicit resolvers do."""
    if s in _BOOLS:
        return _BOOLS[s]
    if s in _NULLS:
        return None
    if _INT.fullmatch(s):
        t = s.replace("_", "")
        sign, t = (-1, t[1:]) if t[0] == "-" else (1, t.lstrip("+"))
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.fullmatch(s):
        return float(s.replace("_", ""))
    if _INF.fullmatch(s):
        return -math.inf if s[0] == "-" else math.inf
    if _NAN.fullmatch(s):
        return math.nan
    return s


class _Flow:
    """Recursive descent over one flow value: ``[...]``, ``{...}``, quoted
    or plain scalars."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, in_flow: bool):
        self._ws()
        c = self.s[self.i] if self.i < len(self.s) else ""
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in "\"'":
            return self._quoted()
        stop = ",]}" if in_flow else ""
        j = self.i
        while j < len(self.s) and self.s[j] not in stop and not (in_flow and self.s.startswith(": ", j)):
            j += 1
        text, self.i = self.s[self.i:j].strip(), j
        return _plain(text)

    def _quoted(self):
        q = self.s[self.i]
        j = self.i + 1
        while j < len(self.s):
            if self.s[j] == "\\" and q == '"':
                j += 2
                continue
            if self.s[j] == q:
                if q == "'" and self.s.startswith("''", j):
                    j += 2
                    continue
                break
            j += 1
        if j >= len(self.s):
            raise YamlSubsetError(f"unterminated string in {self.s!r}")
        raw = self.s[self.i:j + 1]
        self.i = j + 1
        return json.loads(raw) if q == '"' else raw[1:-1].replace("''", "'")

    def _items(self, close: str, item):
        self.i += 1
        out = []
        while True:
            self._ws()
            if self.i >= len(self.s):
                raise YamlSubsetError(f"unterminated flow collection in {self.s!r}")
            if self.s[self.i] == close:
                self.i += 1
                return out
            out.append(item())
            self._ws()
            if self.i < len(self.s) and self.s[self.i] == ",":
                self.i += 1
            elif self.i < len(self.s) and self.s[self.i] != close:
                raise YamlSubsetError(f"expected ',' or {close!r} in {self.s!r}")

    def _seq(self):
        return self._items("]", lambda: self.value(True))

    def _map(self):
        def pair():
            key = self.value(True)
            self._ws()
            if not self.s.startswith(":", self.i):
                raise YamlSubsetError(f"expected ':' in {self.s!r}")
            self.i += 1
            return key, self.value(True)

        return dict(self._items("}", pair))

    def done(self):
        self._ws()
        if self.i != len(self.s):
            raise YamlSubsetError(f"trailing text in {self.s!r}")


def _flow_value(text: str):
    f = _Flow(text)
    v = f.value(False)
    f.done()
    return v


def _strip_comment(line: str) -> str:
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        # a quote inside a plain scalar is part of it
    return line.rstrip()


def _split_key(content: str):
    """``key: value`` -> (key, value text); None when the line is no pair."""
    f = _Flow(content)
    if content[:1] in ("[", "{"):
        return None
    if content[:1] in ("'", '"'):
        key = f._quoted()
        rest = content[f.i:]
        if not rest.lstrip().startswith(":"):
            return None
        rest = rest.lstrip()[1:]
        return key, rest.strip()
    m = re.match(r"([^:#]*?):(\s+|$)", content)
    if m is None:
        return None
    return _plain(m.group(1).strip()), content[m.end():].strip()


def _lines(text: str):
    out = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError("tabs in indentation")
        line = _strip_comment(raw)
        if line.strip() in ("", "---"):
            continue
        out.append((len(line) - len(line.lstrip(" ")), line.strip()))
    return out


def _block(lines, i: int, indent: int):
    """The block mapping whose lines start at ``i`` with ``indent``; returns
    (dict, next line index)."""
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        pair = _split_key(lines[i][1])
        if pair is None:
            raise YamlSubsetError(f"not a 'key: value' line: {lines[i][1]!r}")
        key, rest = pair
        i += 1
        if rest:
            out[key] = _flow_value(rest)
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def parse_yaml(text: str):
    """The YAML subset of the CAD configs -> Python values (None when empty)."""
    lines = _lines(text)
    if not lines:
        return None
    if len(lines) == 1 and _split_key(lines[0][1]) is None:
        return _flow_value(lines[0][1])
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YamlSubsetError(f"unexpected indentation at {lines[i][1]!r}")
    return value


def _yaml_float(v: float) -> str:
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v).lower()
    return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text


def dump_yaml(value) -> str:
    """JSON text of ``value`` that ``yaml.safe_load`` (and :func:`parse_yaml`)
    read back equal: floats in PyYAML's spelling (``5.0e-05``, not ``5e-05``)."""
    if isinstance(value, dict):
        return "{" + ", ".join(f"{json.dumps(str(k))}: {dump_yaml(v)}" for k, v in value.items()) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(dump_yaml(v) for v in value) + "]"
    if isinstance(value, float):
        return _yaml_float(value)
    return json.dumps(value)


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yacs_config(path: str) -> dict:
    with open(path) as f:
        cfg = parse_yaml(f.read()) or {}
    base_rel = cfg.pop("_BASE_", None)
    if base_rel:
        base = load_yacs_config(os.path.join(os.path.dirname(path), base_rel))
        cfg = _deep_merge(base, cfg)
    return cfg


def _parse_value(s: str):
    try:
        return parse_yaml(s)
    except YamlSubsetError:
        return s


def apply_opts(cfg: dict, opts: list[str]) -> dict:
    """Apply ["MODEL.WEIGHTS", "x.pth", ...] dotted overrides."""
    assert len(opts) % 2 == 0, "opts must be KEY VALUE pairs"
    for key, value in zip(opts[0::2], opts[1::2]):
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(value)
    return cfg


def get(cfg: dict, dotted: str, default=None):
    node = cfg
    for p in dotted.split("."):
        if not isinstance(node, dict) or p not in node:
            return default
        node = node[p]
    return node
