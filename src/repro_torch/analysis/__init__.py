"""Static analysis for the port: the AST lint and the sketch-coverage gate
(the port of ``repro/analysis``).

* :mod:`repro_torch.analysis.lint` — an AST lint engine (``python -m
  repro_torch.analysis.lint src/repro_torch``) with nine rules: JAX's four
  framework-neutral ones and five retargeted to the port's idioms (no import
  of JAX or of the JAX package, no autograd Function outside the spine, no
  global RNG draw or reused seed, no host read or tensor branch inside a
  step), with inline ``# lint: waive=`` waivers.
* :mod:`repro_torch.analysis.coverage` — a gate over the autograd graph: one
  forward of a train cell's loss under anomaly mode, and for every weight
  the nodes that consume it, attributed to the sketched-site spine
  (``core/site.py``) or flagged as an escaped dense matmul, gated against
  the checked-in ``baseline.json`` waivers.
* :mod:`repro_torch.analysis.invariants` — the G-reader ceilings per
  estimator.

The lint layer imports the standard library only; the coverage layer
imports torch lazily inside its functions.
"""
# Lazy exports (PEP 562): `python -m repro_torch.analysis.lint` must not
# trigger an eager sibling import of the submodule runpy is about to execute,
# and importing the package stays as light as its lightest member.
_EXPORTS = {
    "Finding": "findings", "LintResult": "findings",
    "format_findings": "findings",
    "run_lint": "lint",
    "Rule": "rules", "DEFAULT_RULES": "rules", "rule_ids": "rules",
    "BaselineResult": "coverage", "CoverageReport": "coverage",
    "SiteCoverage": "coverage", "analyze_loss": "coverage",
    "analyze_runtime": "coverage", "check_baseline": "coverage",
    "load_baseline": "coverage", "role_hint": "coverage",
    "g_reader_ceiling": "invariants", "G_READER_CEILINGS": "invariants",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(f"repro_torch.analysis.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module 'repro_torch.analysis' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = [
    "Finding",
    "LintResult",
    "Rule",
    "DEFAULT_RULES",
    "rule_ids",
    "format_findings",
    "run_lint",
    "CoverageReport",
    "SiteCoverage",
    "BaselineResult",
    "analyze_loss",
    "analyze_runtime",
    "role_hint",
    "load_baseline",
    "check_baseline",
    "g_reader_ceiling",
    "G_READER_CEILINGS",
]
