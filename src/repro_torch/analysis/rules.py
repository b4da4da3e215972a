"""AST lint rules (stdlib ``ast`` only — no torch import at lint time).

The port of ``repro/analysis/rules.py``. Every rule sees a parsed module plus
a :class:`FileContext` that owns the import-alias table, so detection is
*name-resolving*: ``from torch.autograd import Function as F`` trips the
autograd-Function rule at the import and at ``class X(F)``, while prose
mentions in docstrings and comments are not findings (strings are not names).

Four rules are framework-neutral and keep JAX's ids and logic
(``ctx-outside-api-nn``, ``swallowed-exception``,
``thread-uncaptured-target``, ``wall-clock-outside-obs``). Five are
retargeted from JAX's idioms to the port's and carry new ids:
``jax-import-in-port`` (JAX's ``jax-version-gated``),
``autograd-function-outside-site`` (``custom-vjp-outside-site``),
``seed-reuse`` (``prng-key-reuse``), ``host-sync-in-step``
(``host-sync-in-jit``) and ``tensor-branch`` (``tracer-branch``).

Rule ids are stable kebab-case strings; waive one occurrence with an inline
``# lint: waive=<rule-id>`` comment (see findings.py). Per-rule ``allow``
patterns are fnmatch'ed against the file's path relative to the
``repro_torch`` package root (so ``core/site.py`` means
``src/repro_torch/core/site.py`` wherever the tree is checked out).
"""
from __future__ import annotations

import ast
import dataclasses
from fnmatch import fnmatch
from typing import Dict, List, Optional, Protocol, Set, Tuple

from repro_torch.analysis.findings import Finding

__all__ = ["Rule", "FileContext", "DEFAULT_RULES", "STEP_ROOTS", "rule_ids"]


# ---------------------------------------------------------------------------
# Import resolution
# ---------------------------------------------------------------------------


def _import_table(tree: ast.Module) -> Tuple[Dict[str, str], List[Tuple[int, str]]]:
    """(local name -> dotted path, [(line, imported dotted path)]).

    The second list replays every import as a "virtual use" so rules can
    flag the import line itself (``from torch.autograd import Function`` is
    already the violation outside the allowlist, whether or not the name is
    ever subclassed).
    """
    table: Dict[str, str] = {}
    imported: List[Tuple[int, str]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                table[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
                imported.append((node.lineno, a.name))
        elif isinstance(node, ast.ImportFrom):
            base = ("." * node.level) + (node.module or "")
            for a in node.names:
                if a.name == "*":
                    continue
                full = f"{base}.{a.name}" if base else a.name
                table[a.asname or a.name] = full
                imported.append((node.lineno, full))
    return table, imported


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)

# Step roots: the functions whose bodies run once per training step or per
# engine wave, written down because torch has no ``jit`` to mark them.
# (file pattern against the package-relative path, qualified-name pattern);
# a qualified name joins the enclosing class and def names with dots. Every
# def nested in a root is a root too.
STEP_ROOTS: Tuple[Tuple[str, str], ...] = (
    # the closures make_train_step returns: the step and its helpers
    ("*", "make_train_step.*"),
    # the spine's forward and backward run inside every step
    ("core/site.py", "*.forward"),
    ("core/site.py", "*.backward"),
    # the engines' per-wave and per-decode-step bodies
    ("*", "Engine._prefill_wave"),
    ("*", "Engine._decode_one_step"),
    ("*", "RunToCompletionEngine._run_batch"),
)


@dataclasses.dataclass
class FileContext:
    """Everything a rule needs about one parsed file."""

    path: str        # display path (as passed to the linter)
    relpath: str     # path relative to the repro_torch package root (allow match)
    source: str
    tree: ast.Module
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)
    imported_names: List[Tuple[int, str]] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.imports, self.imported_names = _import_table(self.tree)

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Alias-expanded dotted path of a Name/Attribute chain."""
        d = _dotted(node)
        if d is None:
            return None
        head, _, rest = d.partition(".")
        head = self.imports.get(head, head)
        return f"{head}.{rest}" if rest else head

    def qualified_defs(self) -> List[Tuple[str, ast.AST]]:
        """(qualified name, def) of every function in the file."""
        out: List[Tuple[str, ast.AST]] = []

        def visit(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.ClassDef,) + _DEFS):
                    name = f"{prefix}{child.name}"
                    if isinstance(child, _DEFS):
                        out.append((name, child))
                    visit(child, name + ".")
                else:
                    visit(child, prefix)

        visit(self.tree, "")
        return out

    def step_functions(self, roots=STEP_ROOTS) -> List[ast.AST]:
        """Defs matching ``roots`` in this file, and every def nested in one."""
        out: List[ast.AST] = []
        seen = set()
        for qname, fn in self.qualified_defs():
            if not any(fnmatch(self.relpath, f) and fnmatch(qname, q) for f, q in roots):
                continue
            for node in ast.walk(fn):
                if isinstance(node, _DEFS) and id(node) not in seen:
                    seen.add(id(node))
                    out.append(node)
        return out


class Rule(Protocol):
    """One pluggable lint rule."""

    id: str
    description: str
    allow: Tuple[str, ...]

    def check(self, ctx: FileContext) -> List[Finding]: ...


def _allowed(rule, ctx: FileContext) -> bool:
    return any(fnmatch(ctx.relpath, pat) for pat in rule.allow)


# ---------------------------------------------------------------------------
# Rule 1: the JAX package or JAX itself imported by the port
# ---------------------------------------------------------------------------

_FOREIGN = frozenset({"jax", "jaxlib", "repro"})


@dataclasses.dataclass(frozen=True)
class JaxImportRule:
    id: str = "jax-import-in-port"
    description: str = ("import of jax, jaxlib or the JAX package repro inside the "
                        "port (it keeps its own copy of what it needs)")
    allow: Tuple[str, ...] = ()

    def check(self, ctx: FileContext) -> List[Finding]:
        if _allowed(self, ctx):
            return []
        out = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            else:
                continue
            for name in names:
                if name.split(".")[0] in _FOREIGN:
                    out.add(Finding(ctx.path, node.lineno, self.id,
                                    f"import of {name} — the port imports torch, never "
                                    "jax, jaxlib or repro"))
        return sorted(out)


# ---------------------------------------------------------------------------
# Rule 2: autograd Functions outside the one spine
# ---------------------------------------------------------------------------

_AUTOGRAD_FUNCTION = frozenset({"torch.autograd.Function",
                                "torch.autograd.function.Function"})


@dataclasses.dataclass(frozen=True)
class AutogradFunctionRule:
    id: str = "autograd-function-outside-site"
    description: str = ("a torch.autograd.Function subclass outside core/site.py — "
                        "a second sketched-site spine in the making")
    # core/site.py: THE spine (the sketched site and the TP plans, with its
    # gather/sum layout Functions). launch/pipeline.py: the pipeline stage
    # boundary (JAX allowlists its vjp). launch/mesh.py: the replicated
    # gather/slice layout Functions, which sketch nothing.
    # kernels/flash_attention.py: the forward-only kernel's own gradient,
    # which raises. Anything else extends this tuple explicitly, with a comment.
    allow: Tuple[str, ...] = ("core/site.py", "launch/pipeline.py", "launch/mesh.py",
                              "kernels/flash_attention.py")

    def check(self, ctx: FileContext) -> List[Finding]:
        if _allowed(self, ctx):
            return []
        out = set()
        hint = ("route the site through the one spine (core/site.py) or extend the "
                "allowlist explicitly")
        for line, dotted in ctx.imported_names:
            if dotted in _AUTOGRAD_FUNCTION:
                out.add(Finding(ctx.path, line, self.id, f"import of {dotted}: {hint}"))
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef) and any(
                    ctx.resolve(b) in _AUTOGRAD_FUNCTION for b in node.bases):
                out.add(Finding(ctx.path, node.lineno, self.id,
                                f"class {node.name} subclasses torch.autograd.Function: "
                                f"{hint}"))
        return sorted(out)


# ---------------------------------------------------------------------------
# Rule 3: Ctx construction outside api/ + nn/
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CtxConstructionRule:
    id: str = "ctx-outside-api-nn"
    description: str = ("direct Ctx(...) construction outside repro_torch/api + "
                        "repro_torch/nn")
    allow: Tuple[str, ...] = ("nn/*", "api/*")

    def check(self, ctx: FileContext) -> List[Finding]:
        if _allowed(self, ctx):
            return []
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else None)
            if name == "Ctx":
                out.append(Finding(
                    ctx.path, node.lineno, self.id,
                    "direct Ctx(...) construction (route through "
                    "ExecutionConfig.make_ctx / Runtime.ctx)"))
        return sorted(out)


# ---------------------------------------------------------------------------
# Rule 4: global RNG draws, and one seed feeding two generators
# ---------------------------------------------------------------------------

# torch functions that draw from a generator (the global one without
# ``generator=``): every torch.rand* plus these
_TORCH_DRAWS = frozenset({"multinomial", "bernoulli", "normal", "poisson"})
# tensor methods that draw in place, or from the tensor's probabilities
_METHOD_DRAWS = frozenset({"uniform_", "normal_", "exponential_", "random_", "bernoulli_",
                           "cauchy_", "geometric_", "log_normal_", "bernoulli",
                           "multinomial"})
_GLOBAL_SEEDING = frozenset({"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                             "torch.random.seed", "torch.cuda.manual_seed",
                             "torch.cuda.manual_seed_all", "torch.cuda.seed",
                             "torch.cuda.seed_all"})


def _global_draw(call: ast.Call, ctx: FileContext) -> Optional[str]:
    """What a call draws from the global generator, or None."""
    r = ctx.resolve(call.func)
    if r in _GLOBAL_SEEDING:
        return f"{r}() reseeds the global generator"
    if any(kw.arg == "generator" for kw in call.keywords):
        return None
    if r is not None and r.startswith("torch.") and r.count(".") == 1:
        op = r.split(".")[1]
        if op.startswith("rand") or op in _TORCH_DRAWS:
            return f"{r}() without generator= draws from the global generator"
    if r is not None and r.startswith("torch.nn.init.") and r.endswith("_"):
        return f"{r}() without generator= draws from the global generator"
    if isinstance(call.func, ast.Attribute) and call.func.attr in _METHOD_DRAWS:
        recv = ctx.resolve(call.func.value)  # a module's function is not a method
        if recv is None or recv.split(".")[0] not in ("torch", "numpy"):
            return (f".{call.func.attr}() without generator= draws from the global "
                    "generator")
    return None


def _generator_seed(call: ast.Call, ctx: FileContext) -> Optional[str]:
    """The seed name given to ``rng.generator(seed, device)``, or None."""
    r = ctx.resolve(call.func)
    if r is None or r.split(".")[-2:] != ["rng", "generator"]:
        return None
    if call.args and isinstance(call.args[0], ast.Name):
        return call.args[0].id
    for kw in call.keywords:
        if kw.arg == "seed" and isinstance(kw.value, ast.Name):
            return kw.value.id
    return None


@dataclasses.dataclass(frozen=True)
class SeedReuseRule:
    id: str = "seed-reuse"
    description: str = ("a torch random op without generator= (or a global reseed) "
                        "outside rng.py, or one seed given to two rng.generator() "
                        "calls without a fold_in between them")
    # rng.py owns the seed derivation
    allow: Tuple[str, ...] = ("rng.py",)

    def check(self, ctx: FileContext) -> List[Finding]:
        if _allowed(self, ctx):
            return []
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                why = _global_draw(node, ctx)
                if why:
                    out.append(Finding(ctx.path, node.lineno, self.id,
                                       f"{why}: pass a generator from rng.generator()"))
            if isinstance(node, _DEFS):
                self._scan_function(node, ctx, out)
        return sorted(set(out))

    def _scan_function(self, fn, ctx: FileContext, out: List[Finding]) -> None:
        def bound_names(target) -> List[str]:
            return [n.id for n in ast.walk(target) if isinstance(n, ast.Name)]

        def scan_expr(node, consumed: Dict[str, int]) -> None:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    name = _generator_seed(sub, ctx)
                    if name is None:
                        continue
                    if name in consumed:
                        out.append(Finding(
                            ctx.path, sub.lineno, self.id,
                            f"seed '{name}' already made a generator at line "
                            f"{consumed[name]} — the two draw the same numbers; "
                            "fold_in first"))
                    else:
                        consumed[name] = sub.lineno

        def scan_block(stmts, consumed: Dict[str, int]) -> None:
            for st in stmts:
                if isinstance(st, _DEFS + (ast.ClassDef,)):
                    continue  # separate scope, scanned on its own
                if isinstance(st, ast.If):
                    scan_expr(st.test, consumed)
                    # exclusive branches don't see each other's draws;
                    # afterwards either may have happened (union)
                    a, b = dict(consumed), dict(consumed)
                    scan_block(st.body, a)
                    scan_block(st.orelse, b)
                    consumed.update(a)
                    consumed.update(b)
                    continue
                if isinstance(st, (ast.For, ast.AsyncFor)):
                    scan_expr(st.iter, consumed)
                    for n in bound_names(st.target):
                        consumed.pop(n, None)
                    scan_block(st.body, consumed)
                    scan_block(st.orelse, consumed)
                    continue
                if isinstance(st, ast.While):
                    scan_expr(st.test, consumed)
                    scan_block(st.body, consumed)
                    scan_block(st.orelse, consumed)
                    continue
                if isinstance(st, (ast.With, ast.AsyncWith)):
                    for item in st.items:
                        scan_expr(item.context_expr, consumed)
                    scan_block(st.body, consumed)
                    continue
                if isinstance(st, ast.Try):
                    scan_block(st.body, consumed)
                    for h in st.handlers:
                        scan_block(h.body, consumed)
                    scan_block(st.orelse, consumed)
                    scan_block(st.finalbody, consumed)
                    continue
                scan_expr(st, consumed)
                if isinstance(st, ast.Assign):
                    for t in st.targets:
                        for n in bound_names(t):
                            consumed.pop(n, None)
                elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
                    for n in bound_names(st.target):
                        consumed.pop(n, None)

        scan_block(fn.body, {})


# ---------------------------------------------------------------------------
# Shared static-expression analysis (rules 5 and 6)
# ---------------------------------------------------------------------------

# metadata reads that never read a tensor's values (JAX's list, with the
# torch spellings of the same reads)
_STATIC_ATTRS = frozenset({"ndim", "shape", "dtype", "size", "sharding",
                           "aval", "itemsize", "nbytes", "device", "is_cuda",
                           "requires_grad"})
_STATIC_CALLS = frozenset({"isinstance", "len", "getattr", "hasattr",
                           "callable", "type", "issubclass", "dim", "numel",
                           "data_ptr"})


def _dynamic_value_use(node: ast.AST, names: frozenset) -> bool:
    """True if the expression reads the *value* of one of ``names`` (rather
    than static metadata like ``x.ndim`` / ``x.shape[0]``). JAX's heuristic."""
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return False
        return _dynamic_value_use(node.value, names)
    if isinstance(node, ast.Subscript):
        return _dynamic_value_use(node.value, names)
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False
        return any(_dynamic_value_use(c, names)
                   for c in [node.left] + node.comparators)
    if isinstance(node, ast.Call):
        fname = node.func.attr if isinstance(node.func, ast.Attribute) else (
            node.func.id if isinstance(node.func, ast.Name) else None)
        if fname in _STATIC_CALLS:
            return False
        if isinstance(node.func, ast.Attribute) \
                and _dynamic_value_use(node.func.value, names):
            return True  # method call on a tensor receiver, e.g. x.sum()
        return any(_dynamic_value_use(a, names) for a in node.args)
    if isinstance(node, (ast.BoolOp, ast.BinOp, ast.UnaryOp, ast.IfExp)):
        return any(_dynamic_value_use(c, names) for c in ast.iter_child_nodes(node))
    return False


# a method's receiver and an autograd Function's context are host objects
_RECEIVERS = frozenset({"self", "cls", "ctx"})
# annotations of arguments that hold host values
_HOST_ANNOTATIONS = frozenset({"int", "float", "bool", "str", "bytes", "List", "list",
                               "Tuple", "tuple", "Dict", "dict", "Sequence", "Iterable"})


def _host_annotation(ann) -> bool:
    if ann is None:
        return False
    head = ann.value if isinstance(ann, ast.Subscript) else ann
    name = _dotted(head)
    return name is not None and name.split(".")[-1] in _HOST_ANNOTATIONS


def _param_names(fn) -> frozenset:
    """The arguments of ``fn`` that may hold tensors: all but the receiver
    and those annotated with a host type (``key: int``)."""
    a = fn.args
    params = a.posonlyargs + a.args + a.kwonlyargs
    names = [p.arg for p in params
             if p.arg not in _RECEIVERS and not _host_annotation(p.annotation)]
    for p in (a.vararg, a.kwarg):
        if p is not None:
            names.append(p.arg)
    return frozenset(names)


# host reads: the result is a Python or numpy value (rule 5 flags the read)
_HOST_READS = frozenset({"item", "tolist", "cpu", "numpy"})
# builtins whose result is a host value whatever they are given
_HOST_BUILTINS = frozenset({"len", "int", "float", "bool", "str", "range", "repr",
                            "isinstance", "hasattr", "getattr", "callable", "type",
                            "issubclass", "id", "hash"})


def _own_nodes(fn):
    """The nodes of ``fn``'s body outside nested defs, lambdas and classes."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _DEFS + (ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def _operands(e):
    """The sub-expressions an expression's value is computed from."""
    for c in ast.iter_child_nodes(e):
        if isinstance(c, ast.expr):
            yield c
        elif isinstance(c, ast.keyword):
            yield c.value
        elif isinstance(c, ast.comprehension):
            yield c.iter


def _tensor_names(fn, ctx: FileContext) -> frozenset:
    """Names bound in ``fn`` that may hold a tensor: its tensor arguments
    (:func:`_param_names`) and every name bound from an expression that
    reads one, to a fixpoint. A host read's result (``.item()``,
    ``.tolist()``, ``.numpy()``), numpy's results and the host builtins'
    are host values; so are the names ``fn`` only closes over (a step's
    closure holds what was fixed when the step was built)."""
    bindings: Dict[str, List[ast.AST]] = {}

    def bind(target, value):
        for n in ast.walk(target):
            if isinstance(n, ast.Name):
                bindings.setdefault(n.id, []).append(value)

    for node in _own_nodes(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                bind(t, node.value)
        elif isinstance(node, ast.AugAssign):
            bind(node.target, node.value)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            bind(node.target, node.value)
        elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
            bind(node.target, node.iter)
        elif isinstance(node, ast.withitem) and node.optional_vars is not None:
            bind(node.optional_vars, node.context_expr)
        elif isinstance(node, ast.NamedExpr):
            bind(node.target, node.value)
    tensors: Set[str] = set(_param_names(fn))

    def is_tensor(e) -> bool:
        if isinstance(e, ast.Name):
            return e.id in tensors
        if isinstance(e, ast.Call):
            func = e.func
            if isinstance(func, ast.Attribute) and func.attr in _HOST_READS - {"cpu"}:
                return False
            if isinstance(func, ast.Name) and func.id in _HOST_BUILTINS:
                return False
            r = ctx.resolve(func)
            if r is not None and r.startswith("numpy."):
                return False
            if r is not None and r.startswith("torch."):
                return True
        if isinstance(e, ast.Attribute) and e.attr in _STATIC_ATTRS:
            return False
        return any(is_tensor(c) for c in _operands(e))

    changed = True
    while changed:
        changed = False
        for name, values in bindings.items():
            if name not in tensors and any(is_tensor(v) for v in values):
                tensors.add(name)
                changed = True
    return frozenset(tensors)


# ---------------------------------------------------------------------------
# Rule 5: host reads inside a step
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HostSyncInStepRule:
    id: str = "host-sync-in-step"
    description: str = (".item()/.tolist()/.cpu()/.numpy(), or float()/int()/bool() "
                        "of a tensor, inside a step root (rules.STEP_ROOTS): each "
                        "waits for the device and copies to the host")
    allow: Tuple[str, ...] = ()

    def check(self, ctx: FileContext) -> List[Finding]:
        if _allowed(self, ctx):
            return []
        out = set()
        for fn in ctx.step_functions():
            tensors = _tensor_names(fn, ctx)
            inner = set()  # a read whose result another read takes: one finding
            reads = []
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _HOST_READS:
                    reads.append(node)
                    if isinstance(node.func.value, ast.Call):
                        inner.add(id(node.func.value))
                elif isinstance(node, ast.Call) and ctx.resolve(node.func) in (
                        "float", "int", "bool") and node.args \
                        and not isinstance(node.args[0], ast.Constant) \
                        and _dynamic_value_use(node.args[0], tensors):
                    out.add(Finding(
                        ctx.path, node.lineno, self.id,
                        f"{ctx.resolve(node.func)}() of a tensor inside a step waits "
                        "for the device"))
            for node in reads:
                if id(node) in inner:
                    continue
                chain, n = [], node
                while isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                        and n.func.attr in _HOST_READS:
                    chain.append(f".{n.func.attr}()")
                    n = n.func.value
                out.add(Finding(ctx.path, node.lineno, self.id,
                                f"{''.join(reversed(chain))} inside a step waits for "
                                "the device and copies to the host"))
        return sorted(out)


# ---------------------------------------------------------------------------
# Rule 6: Python branches on tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TensorBranchRule:
    id: str = "tensor-branch"
    description: str = ("Python if/while on the value of a step root's tensor "
                        "argument (a host sync per branch; use torch.where)")
    allow: Tuple[str, ...] = ()

    def check(self, ctx: FileContext) -> List[Finding]:
        if _allowed(self, ctx):
            return []
        out = set()
        for fn in ctx.step_functions():
            params = _param_names(fn)
            for node in ast.walk(fn):
                if isinstance(node, (ast.If, ast.While)) \
                        and _dynamic_value_use(node.test, params):
                    kind = "if" if isinstance(node, ast.If) else "while"
                    out.add(Finding(
                        ctx.path, node.lineno, self.id,
                        f"Python `{kind}` on the value of a tensor argument "
                        "(static checks like .ndim/.shape/`is None` are fine; "
                        "data-dependent control flow needs torch.where)"))
        return sorted(out)


# ---------------------------------------------------------------------------
# Rule 7: swallowed exceptions
# ---------------------------------------------------------------------------

_BROAD_EXC = frozenset({"Exception", "BaseException"})


def _broad_handler(handler: ast.ExceptHandler, ctx: FileContext) -> bool:
    """Bare ``except:``, or a handler naming Exception/BaseException
    (directly or inside a tuple). Narrow handlers (``except TypeError``)
    are the caller saying exactly what it expects — never flagged."""
    t = handler.type
    if t is None:
        return True
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in elts:
        r = ctx.resolve(e)
        if r is not None and r.split(".")[-1] in _BROAD_EXC:
            return True
    return False


def _handles_or_records(handler: ast.ExceptHandler) -> bool:
    """Does the handler body *do* anything with the failure? Re-raising,
    returning/yielding a fallback, assigning (recording) or calling
    (logging, forwarding through a queue) all count; ``pass``/docstrings/
    ``continue``/``break`` alone do not."""
    for node in ast.walk(handler):
        if isinstance(node, (ast.Raise, ast.Return, ast.Yield, ast.YieldFrom,
                             ast.Call, ast.Assign, ast.AugAssign,
                             ast.AnnAssign, ast.Delete)):
            return True
    return False


@dataclasses.dataclass(frozen=True)
class SwallowedExceptionRule:
    id: str = "swallowed-exception"
    description: str = ("broad except (bare / Exception / BaseException) that "
                        "neither re-raises nor records — failures vanish "
                        "silently")
    allow: Tuple[str, ...] = ()

    def check(self, ctx: FileContext) -> List[Finding]:
        if _allowed(self, ctx):
            return []
        out = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ExceptHandler) \
                    and _broad_handler(node, ctx) \
                    and not _handles_or_records(node):
                out.append(Finding(
                    ctx.path, node.lineno, self.id,
                    "broad exception handler swallows the failure — "
                    "re-raise, narrow the type, or record it (log / store / "
                    "forward), with a `# lint: waive=swallowed-exception` "
                    "comment only for a justified sink"))
        return sorted(out)


# ---------------------------------------------------------------------------
# Rule 8: threading.Thread targets that lose their exceptions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ThreadUncapturedTargetRule:
    id: str = "thread-uncaptured-target"
    description: str = ("threading.Thread(target=...) whose target cannot "
                        "surface an exception — a failing worker dies "
                        "silently on the daemon thread")
    allow: Tuple[str, ...] = ()

    def check(self, ctx: FileContext) -> List[Finding]:
        if _allowed(self, ctx):
            return []
        defs = {node.name: node for node in ast.walk(ctx.tree)
                if isinstance(node, _DEFS)}
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            r = ctx.resolve(node.func)
            if r is None or r.split(".")[-1] != "Thread" \
                    or not (r == "Thread" or r.startswith("threading.")):
                continue
            target = None
            for kw in node.keywords:
                if kw.arg == "target":
                    target = kw.value
            if target is None:
                continue  # subclass style (run() overridden) — its job
            captured = False
            if isinstance(target, ast.Name) and target.id in defs:
                captured = any(isinstance(n, ast.ExceptHandler)
                               for n in ast.walk(defs[target.id]))
            if not captured:
                out.append(Finding(
                    ctx.path, node.lineno, self.id,
                    "Thread target has no exception capture — wrap the "
                    "worker body in try/except and store or forward the "
                    "failure (re-raised on join/wait), or subclass Thread "
                    "with an error-capturing run()"))
        return sorted(out)


# ---------------------------------------------------------------------------
# Rule 9: wall-clock reads outside repro_torch/obs
# ---------------------------------------------------------------------------

# the sanctioned clock lives in repro_torch/obs/clock.py; every timing read in
# the package goes through it so spans / metrics / ad-hoc timers share one
# timebase. _ns/monotonic variants are the same violation in disguise.
_WALL_CLOCK = frozenset({"time.perf_counter", "time.perf_counter_ns",
                         "time.time", "time.time_ns",
                         "time.monotonic", "time.monotonic_ns"})


@dataclasses.dataclass(frozen=True)
class WallClockOutsideObsRule:
    id: str = "wall-clock-outside-obs"
    description: str = ("time.perf_counter/time.time read outside repro_torch/obs — "
                        "use repro_torch.obs.clock.now()/wall() so every timer "
                        "shares the span/metrics timebase")
    allow: Tuple[str, ...] = ("obs/*",)

    def check(self, ctx: FileContext) -> List[Finding]:
        if _allowed(self, ctx):
            return []
        out = set()

        def add(line, what):
            out.add(Finding(
                ctx.path, line, self.id,
                f"{what} — use repro_torch.obs.clock.now() (perf_counter) or "
                "repro_torch.obs.clock.wall() (time.time) instead"))

        for line, dotted in ctx.imported_names:
            if dotted in _WALL_CLOCK:
                add(line, f"import of {dotted}")
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.Attribute, ast.Name)):
                r = ctx.resolve(node)
                if r in _WALL_CLOCK:
                    add(node.lineno, r)
        return sorted(out)


DEFAULT_RULES: Tuple[Rule, ...] = (
    JaxImportRule(),
    AutogradFunctionRule(),
    CtxConstructionRule(),
    SeedReuseRule(),
    HostSyncInStepRule(),
    TensorBranchRule(),
    SwallowedExceptionRule(),
    ThreadUncapturedTargetRule(),
    WallClockOutsideObsRule(),
)


def rule_ids() -> List[str]:
    return [r.id for r in DEFAULT_RULES]
