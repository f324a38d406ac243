"""ParmParse-compatible inputs parser (the port's copy of
iamr_tpu/config/parmparse.py, so the port imports nothing of iamr_tpu).

Reads the same ``key = value`` inputs files the reference consumes (AMReX
ParmParse format; Docs/sphinx_documentation/source/RunningProblems.rst), so
reference Tutorials and regression-test inputs run unchanged.

Format rules honored:
  * ``prefix.key = v1 v2 ...`` — whitespace-separated value lists
  * ``#`` comments (full-line and trailing)
  * later definitions override earlier ones (AMReX last-one-wins for scalars;
    we keep the last definition)
  * command-line style overrides: extra ``key=value`` tokens
  * values parse as int if possible, then float, else string; quoted strings
    are kept verbatim
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence


def _parse_token(tok: str) -> Any:
    if len(tok) >= 2 and tok[0] == '"' and tok[-1] == '"':
        return tok[1:-1]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


def _strip_comment(line: str) -> str:
    # '#' starts a comment unless inside quotes
    out = []
    in_q = False
    for ch in line:
        if ch == '"':
            in_q = not in_q
        if ch == "#" and not in_q:
            break
        out.append(ch)
    return "".join(out)


_KV_RE = re.compile(r"^\s*([\w.\-\[\]]+)\s*=\s*(.*)$")


class ParmParse:
    """A parsed inputs table with namespaced queries, mirroring amrex::ParmParse.

    ``ParmParse.from_file(path, overrides=[...])`` builds the table;
    ``pp = table.scoped("ns")`` gives a view with prefix ``ns.``;
    ``pp.get("cfl")`` aborts if missing (reference `pp.get` semantics),
    ``pp.query("init_shrink", default)`` returns default if missing.
    """

    def __init__(self, table: Optional[Dict[str, List[Any]]] = None, prefix: str = ""):
        self._table: Dict[str, List[Any]] = table if table is not None else {}
        self._prefix = prefix

    # -- construction -----------------------------------------------------
    @classmethod
    def from_string(cls, text: str, overrides: Sequence[str] = ()) -> "ParmParse":
        table: Dict[str, List[Any]] = {}
        for raw in text.splitlines():
            line = _strip_comment(raw).strip()
            if not line:
                continue
            m = _KV_RE.match(line)
            if not m:
                continue
            key, rhs = m.group(1), m.group(2).strip()
            toks = rhs.split()
            table[key] = [_parse_token(t) for t in toks] if toks else []
        for ov in overrides:
            m = _KV_RE.match(ov)
            if not m:
                raise ValueError(f"bad override: {ov!r}")
            key, rhs = m.group(1), m.group(2).strip()
            table[key] = [_parse_token(t) for t in rhs.split()]
        return cls(table)

    @classmethod
    def from_file(cls, path: str, overrides: Sequence[str] = ()) -> "ParmParse":
        with open(path) as f:
            return cls.from_string(f.read(), overrides)

    # -- queries ----------------------------------------------------------
    def scoped(self, prefix: str) -> "ParmParse":
        return ParmParse(self._table, prefix + "." if prefix else "")

    def _key(self, name: str) -> str:
        return self._prefix + name

    def contains(self, name: str) -> bool:
        return self._key(name) in self._table

    def raw(self, name: str) -> List[Any]:
        return self._table[self._key(name)]

    def get(self, name: str, n: Optional[int] = None) -> Any:
        """Required lookup; scalar when n is None, else list of length >= n."""
        key = self._key(name)
        if key not in self._table:
            raise KeyError(f"ParmParse: required key '{key}' not found in inputs")
        vals = self._table[key]
        if n is None:
            if len(vals) != 1:
                raise ValueError(f"ParmParse: '{key}' has {len(vals)} values, expected 1")
            return vals[0]
        if len(vals) < n:
            raise ValueError(f"ParmParse: '{key}' has {len(vals)} values, expected {n}")
        return vals[:n]

    def query(self, name: str, default: Any = None, n: Optional[int] = None) -> Any:
        key = self._key(name)
        if key not in self._table:
            return default
        return self.get(name, n)

    def query_bool(self, name: str, default: bool = False) -> bool:
        """Boolean lookup accepting the reference ParmParse forms: integer
        (0/1) or the strings true/false (amrex::ParmParse::query(bool&);
        e.g. `godunov.use_forces_in_trans = true`,
        Exec/run2d/regtest.2d.poiseuille:24)."""
        v = self.query(name, None)
        if v is None:
            return bool(default)
        if isinstance(v, str):
            s = v.strip().lower()
            if s in ("true", "t", "yes", "on"):
                return True
            if s in ("false", "f", "no", "off"):
                return False
            return bool(int(s))
        return bool(int(v))

    def queryarr(self, name: str, default: Any = None) -> Any:
        key = self._key(name)
        if key not in self._table:
            return default
        return list(self._table[key])

    def getarr(self, name: str) -> List[Any]:
        key = self._key(name)
        if key not in self._table:
            raise KeyError(f"ParmParse: required key '{key}' not found in inputs")
        return list(self._table[key])

    def keys(self) -> List[str]:
        if not self._prefix:
            return list(self._table.keys())
        return [k[len(self._prefix):] for k in self._table if k.startswith(self._prefix)]

    def dump(self) -> str:
        """Full table dump (job_info-style provenance)."""
        lines = []
        for k in sorted(self._table):
            lines.append(f"{k} = {' '.join(str(v) for v in self._table[k])}")
        return "\n".join(lines)
