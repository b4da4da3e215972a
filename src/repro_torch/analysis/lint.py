"""Lint runner + CLI: ``python -m repro_torch.analysis.lint src/repro_torch``.

The port of ``repro/analysis/lint.py``. Pure stdlib (``ast`` + ``tokenize``):
linting the whole package takes about a second, so it runs as a fail-fast
gate before any test that imports torch. Exit status is nonzero iff
un-waived findings exist.
"""
from __future__ import annotations

import argparse
import ast
import os
import sys
from typing import Iterable, List, Optional, Sequence

from repro_torch.analysis.findings import (Finding, LintResult, apply_waivers,
                                           collect_waivers, format_findings)
from repro_torch.analysis.rules import DEFAULT_RULES, Rule

__all__ = ["run_lint", "lint_file", "iter_py_files", "main", "waiver_key",
           "REVIEWED_WAIVERS"]

DEFAULT_PATH = "src/repro_torch"

# The inline waivers a review accepted in src/repro_torch, as (rule, file
# relative to the package, code of the waived line): the gate holds the
# tree's waived findings to exactly these. Each is one deliberate host read
# per engine wave, engine step or train step (docs/port.md, "Analysis").
REVIEWED_WAIVERS = frozenset({
    ("host-sync-in-step", "serve/engine.py", "first_np = first.cpu().numpy()"),
    ("host-sync-in-step", "serve/engine.py", "nxt_np = nxt.cpu().numpy()"),
    ("host-sync-in-step", "serve/legacy.py", "first_np = first.cpu().numpy()"),
    ("host-sync-in-step", "serve/legacy.py", "step_tok = nxt.cpu().numpy()"),
    ("host-sync-in-step", "train/train_step.py", "ok = bool(ok_t)"),
})


def package_relpath(path: str) -> str:
    """Path relative to the ``repro_torch`` package root, posix separators.

    Rule allowlists (``rng.py``, ``core/site.py``, ``nn/*``) are written
    against the package layout, not the invocation directory, so
    ``src/repro_torch/rng.py``, ``./repro_torch/rng.py`` and a bare fixture
    file all normalize consistently. Files outside a ``repro_torch``
    directory (test fixtures) keep their basename — never accidentally
    allowlisted.
    """
    parts = os.path.normpath(path).replace(os.sep, "/").split("/")
    if "repro_torch" in parts:
        i = len(parts) - 1 - parts[::-1].index("repro_torch")
        rel = "/".join(parts[i + 1:])
        if rel:
            return rel
    return parts[-1]


def waiver_key(finding: Finding) -> tuple:
    """(rule, package-relative file, code of the line before its comment):
    a waived finding as :data:`REVIEWED_WAIVERS` spells it."""
    with open(finding.path, encoding="utf-8") as f:
        line = f.read().splitlines()[finding.line - 1]
    return finding.rule, package_relpath(finding.path), line.split("#", 1)[0].strip()


def iter_py_files(paths: Iterable[str]) -> List[str]:
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        else:
            for dirpath, dirnames, files in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                out.extend(os.path.join(dirpath, f)
                           for f in sorted(files) if f.endswith(".py"))
    return sorted(out)


def lint_file(path: str, rules: Sequence[Rule] = DEFAULT_RULES) -> LintResult:
    from repro_torch.analysis.rules import FileContext

    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return LintResult(findings=[Finding(
            path, e.lineno or 0, "parse-error", f"syntax error: {e.msg}")])
    ctx = FileContext(path=path, relpath=package_relpath(path),
                      source=source, tree=tree)
    findings: List[Finding] = []
    for rule in rules:
        findings.extend(rule.check(ctx))
    return apply_waivers(findings, collect_waivers(source))


def run_lint(paths: Iterable[str],
             rules: Optional[Sequence[Rule]] = None,
             select: Optional[Sequence[str]] = None) -> LintResult:
    """Lint ``paths`` (files or directories, recursively).

    ``select`` keeps only the named rule ids. Returns a
    :class:`LintResult`; ``result.findings`` are the violations that stand,
    ``result.waived`` the ones suppressed by ``# lint: waive=`` comments.
    """
    chosen: Sequence[Rule] = DEFAULT_RULES if rules is None else rules
    if select is not None:
        want = set(select)
        unknown = want - {r.id for r in chosen}
        if unknown:
            raise ValueError(f"unknown rule ids: {sorted(unknown)}")
        chosen = [r for r in chosen if r.id in want]
    result = LintResult()
    for path in iter_py_files(paths):
        result.extend(lint_file(path, chosen))
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="AST lint for the PyTorch port of the sketched-backprop repo")
    ap.add_argument("paths", nargs="*", default=[DEFAULT_PATH],
                    help=f"files or directories (default: {DEFAULT_PATH})")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--show-waived", action="store_true",
                    help="also print findings suppressed by inline waivers")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in DEFAULT_RULES:
            print(f"{r.id}: {r.description}")
        return 0

    select = args.select.split(",") if args.select else None
    result = run_lint(args.paths or [DEFAULT_PATH], select=select)
    if result.findings:
        print(format_findings(result.findings))
    if args.show_waived and result.waived:
        print(format_findings(result.waived, header="-- waived --"))
    n, w = len(result.findings), len(result.waived)
    print(f"lint: {n} finding(s), {w} waived")
    return 1 if result.findings else 0


if __name__ == "__main__":
    sys.exit(main())
