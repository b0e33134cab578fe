"""Tolerant OpenFOAM dictionary parser (port of
``sedifoam_tpu/io/foamdict.py``; pure Python, a copy).

Parses the subset of the OpenFOAM file format the reference cases use:
nested dictionaries, lists, `key value;` entries, dimensioned scalars
(`nub nub [0 2 -1 0 0 0 0] 1e-6;`), `uniform` fields, and vertex/block
lists in blockMeshDict. Comments (// and /* */) and the FoamFile header
are handled. Not a validator — unknown syntax degrades to raw token
strings rather than failing.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple, Union


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return text


_TOKEN_RE = re.compile(r"""
    "[^"]*"           |   # quoted strings
    [{}();\[\]]       |   # structural
    [^\s{}();\[\]]+       # words / numbers
""", re.X)


def _tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(_strip_comments(text))


def _to_value(tok: str) -> Any:
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok.strip('"')


class _Parser:
    def __init__(self, tokens: List[str]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def parse_dict_body(self, stop_at_brace: bool) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        while True:
            tok = self.peek()
            if tok is None:
                return out
            if tok == "}":
                if stop_at_brace:
                    self.next()
                return out
            key = self.next()
            if self.peek() == "{":
                self.next()
                out[key] = self.parse_dict_body(True)
                continue
            # entry: collect tokens until ';'
            vals: List[Any] = []
            while True:
                t = self.peek()
                if t is None or t == ";":
                    if t == ";":
                        self.next()
                    break
                if t == "(":
                    self.next()
                    vals.append(self.parse_list())
                elif t == "[":
                    self.next()
                    vals.append(self.parse_dims())
                elif t == "{":
                    # e.g. `key word { ... }` (rare); treat as subdict
                    self.next()
                    vals.append(self.parse_dict_body(True))
                    break
                else:
                    vals.append(_to_value(self.next()))
            if len(vals) == 1:
                out[key] = vals[0]
            else:
                out[key] = vals
        return out

    def parse_list(self) -> List[Any]:
        out: List[Any] = []
        while True:
            t = self.peek()
            if t is None:
                return out
            if t == ")":
                self.next()
                return out
            if t == "(":
                self.next()
                out.append(self.parse_list())
            elif t == "[":
                self.next()
                out.append(self.parse_dims())
            elif t == "{":
                self.next()
                out.append(self.parse_dict_body(True))
            else:
                out.append(_to_value(self.next()))

    def parse_dims(self) -> Tuple:
        dims = []
        while self.peek() not in ("]", None):
            dims.append(_to_value(self.next()))
        if self.peek() == "]":
            self.next()
        return ("__dims__", tuple(dims))


def parse_string(text: str) -> Dict[str, Any]:
    d = _Parser(_tokenize(text)).parse_dict_body(False)
    d.pop("FoamFile", None)
    return d


def parse_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return parse_string(f.read())


def dimensioned_value(entry) -> float:
    """`nub [0 2 -1 ...] 1e-6` -> 1e-6; bare numbers pass through."""
    if isinstance(entry, (int, float)):
        return float(entry)
    if isinstance(entry, list):
        # drop the name token and the dims tuple; last number is the value
        vals = [e for e in entry if isinstance(e, (int, float))]
        if vals:
            return float(vals[-1])
        # vector value: last element is a list
        for e in reversed(entry):
            if isinstance(e, list):
                return [float(x) for x in e]
    raise ValueError(f"cannot extract value from {entry!r}")


def dimensioned_vector(entry) -> List[float]:
    if isinstance(entry, list):
        for e in reversed(entry):
            if isinstance(e, list):
                return [float(x) for x in e]
    raise ValueError(f"cannot extract vector from {entry!r}")


def uniform_value(entry) -> Union[float, List[float]]:
    """`uniform 0.05` or `uniform (0 0.05 0)` entries."""
    if isinstance(entry, list):
        items = [e for e in entry if e != "uniform"]
        if len(items) == 1:
            return items[0]
        return items
    return entry


def lookup_or_default(d: Dict, key: str, default):
    if key not in d:
        return default
    v = d[key]
    if isinstance(v, str):
        if v in ("true", "on", "yes"):
            return True
        if v in ("false", "off", "no"):
            return False
    return v
