"""Lint findings, inline waivers, and result formatting (the port's copy of
``repro/analysis/findings.py``, line for line).

A finding is (path, line, rule id, message). Waivers are explicit inline
comments on the offending line::

    y = risky_thing()  # lint: waive=rule-id

Waived findings are not dropped — they move to ``LintResult.waived`` so
callers can assert "clean with zero waivers" (the two rules that take no
waiver, ``autograd-function-outside-site`` and ``jax-import-in-port``) or
"clean modulo reviewed waivers" (the CLI default).
"""
from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from typing import Dict, List, Set, Tuple

__all__ = ["Finding", "LintResult", "collect_waivers", "format_findings"]

_WAIVE_RE = re.compile(r"#\s*lint:\s*waive=([\w?*-]+(?:\s*,\s*[\w?*-]+)*)")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One structured lint finding (sortable: path, line, rule)."""

    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class LintResult:
    """Findings that stand plus findings suppressed by inline waivers."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    waived: List[Finding] = dataclasses.field(default_factory=list)

    def extend(self, other: "LintResult") -> None:
        self.findings.extend(other.findings)
        self.waived.extend(other.waived)

    def select(self, rules) -> "LintResult":
        rules = set(rules)
        return LintResult(
            findings=[f for f in self.findings if f.rule in rules],
            waived=[f for f in self.waived if f.rule in rules])

    @property
    def ok(self) -> bool:
        return not self.findings


def collect_waivers(source: str) -> Dict[int, Set[str]]:
    """line -> set of waived rule ids, from ``# lint: waive=...`` comments.

    Tokenize-based so a waiver only counts inside a real comment — the
    string ``"# lint: waive=x"`` in a docstring or literal does nothing.
    Unparsable files yield no waivers (the lint runner reports the syntax
    error separately).
    """
    out: Dict[int, Set[str]] = {}
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in toks:
            if tok.type != tokenize.COMMENT:
                continue
            m = _WAIVE_RE.search(tok.string)
            if m:
                ids = {r.strip() for r in m.group(1).split(",")}
                out.setdefault(tok.start[0], set()).update(ids)
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


def apply_waivers(findings: List[Finding], waivers: Dict[int, Set[str]]) -> LintResult:
    res = LintResult()
    for f in sorted(findings):
        if f.rule in waivers.get(f.line, ()):
            res.waived.append(f)
        else:
            res.findings.append(f)
    return res


def format_findings(findings, header: str = "") -> str:
    lines = [header] if header else []
    lines += [str(f) for f in findings]
    return "\n".join(lines)
