"""The port's AST lint engine (`repro_torch.analysis.lint`) against its
fixtures, against the JAX package's engine, and as the gate on the port.

Every rule gets a bad fixture (exact rule id + lines pinned) and a good
fixture (idiomatic spellings of the same territory, zero findings), under
``tests/data/lint_torch/``. On JAX's own fixtures (``tests/data/lint/``) the
four framework-neutral rules give the JAX engine's (rule, line) pairs. The
gate: ``src/repro_torch`` lints clean, its waived findings are exactly the
reviewed list, and the two rules that take no waiver have none.
"""
import os
import subprocess
import sys

import pytest

from repro.analysis import run_lint as jax_run_lint
from repro_torch.analysis import rule_ids, run_lint
from repro_torch.analysis.lint import REVIEWED_WAIVERS, main, package_relpath, waiver_key
from repro_torch.analysis.rules import STEP_ROOTS, FileContext

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data", "lint_torch")
JAX_DATA = os.path.join(HERE, "data", "lint")
ROOT = os.path.join(HERE, "..")
SRC = os.path.join(ROOT, "src", "repro_torch")

NEUTRAL = ("ctx-outside-api-nn", "swallowed-exception", "thread-uncaptured-target",
           "wall-clock-outside-obs")
NO_WAIVER = ("autograd-function-outside-site", "jax-import-in-port")


def _fixture(name):
    return os.path.join(DATA, name)


# (bad fixture, rule id, expected finding lines)
_BAD = [
    ("bad_jax_import.py", "jax-import-in-port", {2, 3, 4, 5}),
    ("bad_autograd_function.py", "autograd-function-outside-site", {3, 6, 12}),
    ("bad_ctx.py", "ctx-outside-api-nn", {7, 8}),
    ("bad_seed_reuse.py", "seed-reuse", {8, 9, 10, 11, 13, 14, 15}),
    ("bad_host_sync.py", "host-sync-in-step", {10, 11, 13, 21}),
    ("bad_tensor_branch.py", "tensor-branch", {6, 8}),
    ("bad_swallowed.py", "swallowed-exception", {8, 16}),
    ("bad_thread.py", "thread-uncaptured-target", {10, 16}),
    ("bad_wall_clock.py", "wall-clock-outside-obs", {2, 7, 9, 10}),
]

_GOOD = [
    "good_jax_import.py",
    "good_autograd_function.py",
    "good_ctx.py",
    "good_seed_reuse.py",
    "good_host_sync.py",
    "good_tensor_branch.py",
    "good_swallowed.py",
    "good_thread.py",
    "good_wall_clock.py",
]


def test_nine_rules_one_bad_and_one_good_fixture_each():
    assert len(rule_ids()) == 9
    assert {rule for _, rule, _ in _BAD} == set(rule_ids())
    assert len(_GOOD) == 9


@pytest.mark.parametrize("fname,rule,lines", _BAD, ids=[b[0] for b in _BAD])
def test_bad_fixture_trips_exactly(fname, rule, lines):
    result = run_lint([_fixture(fname)])
    assert not result.waived
    assert {f.rule for f in result.findings} == {rule}
    assert {f.line for f in result.findings} == lines
    # findings render as clickable path:line with the rule id
    for f in result.findings:
        assert str(f).startswith(f"{f.path}:{f.line}: [{rule}]")


@pytest.mark.parametrize("fname", _GOOD)
def test_good_fixture_is_clean_under_all_rules(fname):
    result = run_lint([_fixture(fname)])
    assert not result.findings, [str(f) for f in result.findings]
    assert not result.waived


def test_host_sync_names_each_read_once():
    """A chained read (``.cpu().numpy()``) is one finding; two reads on one
    line are two."""
    msgs = sorted(f.message.split(" inside")[0]
                  for f in run_lint([_fixture("bad_host_sync.py")]).findings)
    assert msgs == [".cpu().numpy()", ".item()", ".tolist()", "bool() of a tensor",
                    "float() of a tensor"]


def test_inline_waiver_suppresses_but_records():
    result = run_lint([_fixture("waived.py")])
    assert not result.findings
    assert [(f.line, f.rule) for f in result.waived] == [(6, "wall-clock-outside-obs")]
    assert result.ok


def test_waiver_for_other_rule_does_not_suppress(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text("import jax  # lint: waive=tensor-branch\n")
    result = run_lint([str(p)])
    assert [f.rule for f in result.findings] == ["jax-import-in-port"]
    assert not result.waived


def test_waiver_in_a_string_is_not_a_waiver(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text('import time\n\nT = time.time(), "# lint: waive=wall-clock-outside-obs"\n')
    result = run_lint([str(p)])
    assert [(f.rule, f.line) for f in result.findings] == [("wall-clock-outside-obs", 3)]


def test_syntax_error_becomes_parse_error_finding(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n    pass\n")
    result = run_lint([str(p)])
    assert [f.rule for f in result.findings] == ["parse-error"]


def test_select_unknown_rule_raises():
    with pytest.raises(ValueError, match="no-such-rule"):
        run_lint([DATA], select=["no-such-rule"])


def test_select_restricts_to_named_rule():
    result = run_lint([_fixture("bad_jax_import.py")], select=["ctx-outside-api-nn"])
    assert not result.findings
    result = run_lint([DATA], select=["tensor-branch"])
    assert {f.rule for f in result.findings} == {"tensor-branch"}


def test_package_relpath_normalizes_to_package_root():
    assert package_relpath("src/repro_torch/rng.py") == "rng.py"
    assert package_relpath("./src/repro_torch/core/site.py") == "core/site.py"
    # the JAX package's tree is not the port's
    assert package_relpath("src/repro/core/site.py") == "site.py"
    # fixtures outside a repro_torch/ dir keep their basename — never allowlisted
    assert package_relpath("tests/data/lint_torch/bad_ctx.py") == "bad_ctx.py"


def test_cli_exit_codes(capsys):
    assert main([_fixture("good_ctx.py")]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    assert main([_fixture("bad_ctx.py")]) == 1
    out = capsys.readouterr().out
    assert "[ctx-outside-api-nn]" in out and "2 finding(s)" in out
    assert main(["--select", "swallowed-exception", _fixture("bad_ctx.py")]) == 0
    capsys.readouterr()
    assert main(["--show-waived", _fixture("waived.py")]) == 0
    out = capsys.readouterr().out
    assert "-- waived --" in out and "0 finding(s), 1 waived" in out
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rid in rule_ids():
        assert rid in listed


def test_cli_gates_the_port_without_importing_torch():
    """``python -m repro_torch.analysis.lint`` (default path src/repro_torch)
    exits 0 from the repo root; the engine imports the standard library
    only, not torch."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "lint: 0 finding(s), 5 waived" in out.stdout
    probe = ("import sys\nfrom repro_torch.analysis import run_lint\n"
             "run_lint(['src/repro_torch'])\nprint(sorted(m for m in ('torch', 'numpy', "
             "'jax') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("fname", sorted(f for f in os.listdir(JAX_DATA) if f.endswith(".py")))
def test_neutral_rules_match_jax_on_its_fixtures(fname):
    """The four framework-neutral rules give the JAX engine's (rule, line)
    pairs on every one of JAX's fixtures (its bad and good ctx, swallowed,
    thread and wall-clock files among them)."""
    path = os.path.join(JAX_DATA, fname)
    got = {(f.rule, f.line) for f in run_lint([path], select=NEUTRAL).findings}
    want = {(f.rule, f.line) for f in jax_run_lint([path], select=list(NEUTRAL)).findings}
    assert got == want


def test_neutral_rules_fire_on_jax_bad_fixtures():
    """The parity above is not vacuous: each neutral rule fires on JAX's bad
    fixture at JAX's pinned lines."""
    pinned = {"bad_ctx.py": {7, 8}, "bad_swallowed.py": {8, 16}, "bad_thread.py": {10, 16},
              "bad_wall_clock.py": {2, 7, 9, 10}}
    for fname, lines in pinned.items():
        result = run_lint([os.path.join(JAX_DATA, fname)], select=NEUTRAL)
        assert {f.line for f in result.findings} == lines, fname


def test_every_step_root_names_a_function_of_the_port():
    """The written step roots do not rot: each matches a def in src/repro_torch."""
    import ast

    matched = set()
    for dirpath, _, files in os.walk(SRC):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path, encoding="utf-8") as f:
                src = f.read()
            ctx = FileContext(path=path, relpath=package_relpath(path), source=src,
                              tree=ast.parse(src))
            for root in STEP_ROOTS:
                if ctx.step_functions((root,)):
                    matched.add(root)
    assert matched == set(STEP_ROOTS)


def test_src_tree_lints_clean_with_the_reviewed_waivers():
    """The repo gate: zero findings across src/repro_torch, and the waived
    findings exactly the reviewed host reads (one per engine wave, engine
    step or train step)."""
    result = run_lint([SRC])
    assert not result.findings, "\n".join(str(f) for f in result.findings)
    assert len(result.waived) == len(REVIEWED_WAIVERS)
    assert {waiver_key(f) for f in result.waived} == REVIEWED_WAIVERS


@pytest.mark.parametrize("rule", NO_WAIVER)
def test_no_waiver_under_the_spine_and_import_rules(rule):
    """A second spine or an import of JAX cannot be self-waived at the call
    site: these rules' waived list is empty, findings included."""
    result = run_lint([SRC], select=[rule])
    offenders = [str(f) for f in result.findings + result.waived]
    assert not offenders, "\n".join(offenders)
