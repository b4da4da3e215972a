"""Sketch coverage on the autograd graph: prove every parameter matmul is on
the spine (the port of ``repro/analysis/coverage.py``).

The paper's savings only accrue at sites that route through the one
sketched-site spine (``core/site.py``). This analyzer runs a train cell's
forward once, under anomaly mode, and never its backward: the graph that
autograd records IS the backward, node for node. Per weight leaf it answers
*which nodes produce this gradient, and do they run through the spine?*

Mechanics:

* **The reverse graph** — from the loss's ``grad_fn`` every node is reached
  through ``next_functions``; inverting those edges gives each node's
  consumers in the forward. A leaf's ``AccumulateGrad`` node is where its
  gradient lands.
* **Provenance** — under ``torch.autograd.set_detect_anomaly(True)`` every
  node keeps the forward's stack (``node.metadata["traceback_"]``, formatted
  frames, outermost first). A node's key is its innermost frame outside
  torch's own package, ``file:line``: the line of the model that ran the op.
* **Gradient attribution** — from a leaf's ``AccumulateGrad`` the walk goes
  to the nodes that consume it, through *gradient-transparent* nodes
  (transposes, views, reshapes, expands, unbinds, selects, slices,
  permutes, squeezes, cats and stacks, copies and dtype casts, and the layout
  Functions of ``core/site.py`` and ``launch/mesh.py``), to opaque
  terminals. A terminal matmul or autograd Function with a frame under
  ``repro_torch/core/`` in its stack is spine evidence (JAX decides the same
  by provenance, not by the Function: an exact site runs ``core/site.py``'s
  plain matmul under autograd and is still the spine); a terminal matmul
  with no such frame is an **escaped dense matmul**, named by its
  ``file:line``. Elementwise ops, indexing and reductions are opaque and no
  matmul: an embedding's lookup, a norm gain, a depthwise conv.

Per-site categories (JAX's):

* ``resolved`` — ``core.site.resolve_tree_site`` yields a SiteSpec (the
  slot builders, telemetry and TP planning all see this site).
* ``exact`` — on the spine but deliberately exact: the role is
  policy-excluded (``lm_head``, ``router``, ``ssm_small``, a tied
  ``embed``) or the multi-use ``shared`` subtree.
* ``unresolved`` — runs through the spine (role hints via ``Ctx.cfg_for``)
  but is invisible to path-based spec resolution: no gslots, no probes, no
  TP plan. The MoE experts and the SSM projections.
* ``escaped`` — at least one gradient-producing dense matmul bypasses the
  spine (the MoE router, RWKV's decay LoRA ``w1``/``w2``).
* ``no_matmul`` — a gradient without any matmul.

FLOPs are modelled: 6·T·d_out·d_in per matmul-carrying leaf (stacked leading
dims included), escaped ones summed once per provenance line. The kernels
launch through ctypes, outside torch's dispatcher, so no traced total of the
backward's matmuls is to be had (``docs/port.md``).

``escaped``/``unresolved`` sites must be waived by ``baseline.json`` or
:func:`check_baseline` fails, naming the site and its file:line — the gate
starts green on the known gap and *ratchets*.

The analysis is read-only: it runs the loss on detached aliases of the
parameters (their ``.grad`` and ``requires_grad`` stay as they were), makes
no backward call and no slot, and draws no random number (a site's
generator is consumed in its backward only).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from fnmatch import fnmatch
from typing import Dict, List, Optional, Tuple

__all__ = ["SiteCoverage", "CoverageReport", "BaselineResult", "analyze_loss",
           "analyze_runtime", "role_hint", "load_baseline", "check_baseline",
           "BASELINE_PATH"]

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")

# Node names (autograd's, the trailing version digit dropped) the walk sees
# through: layout and copies, and the layout Functions of core/site.py and
# launch/mesh.py. NOT elementwise ops, indexing or reductions: those would
# let the walk leave the weight and reach the activations' matmuls.
_TRANSPARENT = frozenset({
    "TBackward", "TransposeBackward", "PermuteBackward", "ViewBackward",
    "UnsafeViewBackward", "ReshapeAliasBackward", "AliasBackward", "ExpandBackward",
    "UnbindBackward", "SelectBackward", "SliceBackward", "SplitBackward",
    "SplitWithSizesBackward", "SqueezeBackward", "UnsqueezeBackward", "CatBackward",
    "StackBackward", "ToCopyBackward", "CloneBackward",
    "_GatherParamBackward", "_SumOverDataBackward",  # core/site.py
    "_GatherReplicatedBackward", "_SliceReplicatedBackward",  # launch/mesh.py
})

_MATMULS = frozenset({"MmBackward", "AddmmBackward", "BmmBackward", "BaddbmmBackward",
                      "AddbmmBackward", "MvBackward", "AddmvBackward", "DotBackward",
                      "VdotBackward", "LinearBackward", "MatmulBackward"})

# Anything under repro_torch/core is the spine's own machinery (site.py's
# Functions and exact matmul, sketched_linear's entry point).
_SPINE_DIR = "/repro_torch/core/"

_FRAME = re.compile(r'File "(.+)", line (\d+), in ')


# ---------------------------------------------------------------------------
# Role hints: the analyzer's *extended* path->role map
# ---------------------------------------------------------------------------

# Read-only superset of core.site.site_role (JAX's _PARENT_ROLES). The
# runtime map must NOT learn these entries (a gslot emitted for a site whose
# `linear` call never consumes it silently zeroes that gradient); the
# analyzer only needs them to say which policy role a path *would* carry.
_PARENT_ROLES = {
    "moe": {"wi": "expert_in", "wg": "expert_gate", "wo": "expert_out",
            "router": "router"},
    "mamba": {"in_z": "ssm_in", "in_x": "ssm_in", "out": "ssm_out",
              "in_B": "ssm_small", "in_C": "ssm_small", "in_dt": "ssm_small"},
    "rwkv": {"r": "attn_q", "k": "attn_k", "v": "attn_v", "g": "mlp_gate",
             "out": "attn_o", "cm_k": "mlp_in", "cm_v": "mlp_out",
             "cm_r": "mlp_gate", "w1": "ssm_small", "w2": "ssm_small"},
}


def role_hint(path: Tuple) -> Optional[str]:
    """Policy role a params-tree path would carry at runtime (via explicit
    ``Ctx.cfg_for`` role arguments), including the paths that
    ``core.site.site_role`` is deliberately blind to."""
    from repro_torch.core.site import site_role

    role = site_role(path)
    if role is not None:
        return role
    if not path:
        return None
    if path[-1] == "embed":
        return "embed"
    if len(path) >= 2 and path[-2] == "lm_head":
        return "lm_head"
    if len(path) >= 2:
        parent, leaf = path[-2], path[-1]
        if leaf == "w" and len(path) >= 3:
            parent, leaf = path[-3], path[-2]
        sub = _PARENT_ROLES.get(parent)
        if sub:
            return sub.get(leaf)
    return None


# ---------------------------------------------------------------------------
# The autograd graph
# ---------------------------------------------------------------------------


def _kind(node) -> str:
    return re.sub(r"\d+$", "", node.name())


def _frames(node) -> List[Tuple[str, int]]:
    """(file, line) of the forward's stack when ``node`` was made, outermost
    first (empty outside anomaly mode)."""
    tb = node.metadata.get("traceback_") or []
    return [(m.group(1), int(m.group(2))) for m in (_FRAME.search(f) for f in tb) if m]


class _Graph:
    """The nodes reachable from the loss, their forward consumers and the
    leaves' ``AccumulateGrad`` nodes."""

    def __init__(self, loss):
        import torch

        self._torch_dir = os.path.dirname(torch.__file__)
        self.consumers: Dict[object, List[object]] = {}
        self.accumulate: Dict[int, object] = {}  # id(leaf tensor) -> node
        seen = set()
        stack = [loss.grad_fn] if loss.grad_fn is not None else []
        while stack:
            node = stack.pop()
            if node in seen:
                continue
            seen.add(node)
            var = getattr(node, "variable", None)
            if var is not None:
                self.accumulate[id(var)] = node
            for nxt, _ in node.next_functions:
                if nxt is not None:
                    self.consumers.setdefault(nxt, []).append(node)
                    stack.append(nxt)

    def terminals(self, leaf) -> List[object]:
        """Opaque nodes consuming ``leaf`` through transparent ones."""
        start = self.accumulate.get(id(leaf))
        if start is None:
            return []  # the loss does not depend on it
        seen, terms = set(), []
        frontier = list(self.consumers.get(start, []))
        while frontier:
            node = frontier.pop()
            if node in seen:
                continue
            seen.add(node)
            if _kind(node) in _TRANSPARENT:
                frontier.extend(self.consumers.get(node, []))
            else:
                terms.append(node)
        return terms

    def prov_key(self, node) -> str:
        """The innermost frame outside torch's package, ``file:line``."""
        for f, line in reversed(_frames(node)):
            if not f.startswith(self._torch_dir):
                return f"{f}:{line}"
        return "?"


def _is_spine(node) -> bool:
    return any(_SPINE_DIR in f.replace(os.sep, "/") for f, _ in _frames(node))


def _is_function(node) -> bool:
    """A node of a user-defined ``torch.autograd.Function``."""
    import torch

    return isinstance(node, torch.autograd.function.BackwardCFunction)


def _sketched_application(node) -> bool:
    """One sketched application of a site Function (core/site.py): an exact
    site runs plain autograd, so every SketchedLinearFn node carries a
    config; a TP site does when its spec has one."""
    from repro_torch.core.site import SketchedLinearFn, TPSiteFn

    if type(node) is SketchedLinearFn._backward_cls:
        return True
    return type(node) is TPSiteFn._backward_cls and node.spec.cfg is not None


def _modelled_site_flops(shape, n_tokens: float) -> float:
    """Dense-equivalent fwd+dX+dW FLOPs of one weight site: 6·T·d_out·d_in
    (× stacked leading dims for the experts' weights)."""
    lead = 1.0
    for d in shape[:-2]:
        lead *= d
    return 6.0 * lead * n_tokens * shape[-2] * shape[-1]


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SiteCoverage:
    """Coverage verdict for one parameter leaf."""

    param: str                       # "layers/0/moe/router/w"
    role: Optional[str]              # policy role hint (extended map)
    category: str                    # resolved|exact|unresolved|escaped|no_matmul
    provenance: List[str]            # file:line keys of gradient terminals
    flops: float                     # modelled FLOPs sharing that provenance
    detail: str = ""
    applications: int = 0            # sketched site Function nodes on this leaf


@dataclasses.dataclass
class CoverageReport:
    sites: List[SiteCoverage]
    total_dot_flops: float
    escaped_flops: float
    unresolved_flops: float

    @property
    def escaped_flop_frac(self) -> float:
        """Modelled escaped FLOPs over the modelled FLOPs of every
        matmul-carrying leaf."""
        return self.escaped_flops / self.total_dot_flops \
            if self.total_dot_flops else 0.0

    @property
    def unresolved_flop_frac(self) -> float:
        """Modelled FLOPs of unresolved sites over the same total."""
        return self.unresolved_flops / self.total_dot_flops \
            if self.total_dot_flops else 0.0

    @property
    def applications(self) -> int:
        """Sketched site applications in the forward graph: each site
        Function node carrying a config, counted once (a shared weight
        applied twice counts twice)."""
        return sum(s.applications for s in self.sites)

    def by_category(self) -> Dict[str, List[SiteCoverage]]:
        out: Dict[str, List[SiteCoverage]] = {}
        for s in self.sites:
            out.setdefault(s.category, []).append(s)
        return out

    def escapes(self) -> List[SiteCoverage]:
        return [s for s in self.sites if s.category in ("escaped", "unresolved")]

    def escaped_frac_vs_hlo(self, hlo_flops: float) -> Optional[float]:
        """Escaped modelled FLOPs over a counted total (the dry run's FLOPs,
        where JAX passes its HLO cost summary's)."""
        return self.escaped_flops / hlo_flops if hlo_flops else None

    def summary(self) -> dict:
        """JAX's summary record (``launch/dryrun.py``'s ``coverage``)."""
        cats = {k: len(v) for k, v in self.by_category().items()}
        return {
            "n_sites": len(self.sites),
            "categories": cats,
            "total_dot_flops": self.total_dot_flops,
            "escaped_flops": self.escaped_flops,
            "escaped_flop_frac": self.escaped_flop_frac,
            "unresolved_flop_frac": self.unresolved_flop_frac,
            "escapes": [{"param": s.param, "provenance": s.provenance,
                         "category": s.category, "flops": s.flops}
                        for s in self.escapes()],
        }


def _leaves_with_path(tree, path=()):
    """(path tuple, leaf) of every tensor, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in _leaves_with_path(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def _tree_node(tree, path):
    """Parent dict of the leaf at ``path`` (for resolve_tree_site)."""
    node = tree
    for k in path[:-1]:
        try:
            node = node[k]
        except (KeyError, IndexError, TypeError):
            return None
    return node


def analyze_loss(loss_fn, params, *args, policy=None, n_layers=1,
                 n_tokens: float = 1.0) -> CoverageReport:
    """Coverage of ``loss_fn(params, *args)``'s backward graph.

    ``loss_fn(params, *args)`` returns a scalar tensor, or a tuple whose
    first item is one. ``params`` is a nested dict/list of tensors; the loss
    runs once, on detached aliases of them, under anomaly mode (nothing is
    differentiated, nothing of the caller's is touched). ``policy`` drives
    ``resolve_tree_site``; pass the one the Runtime trains with.
    ``n_tokens`` scales the per-site FLOP model.
    """
    import torch

    from repro_torch.core.site import resolve_tree_site
    from repro_torch.tree import tree_map

    alias = tree_map(lambda t: t.detach().requires_grad_(t.is_floating_point())
                     if isinstance(t, torch.Tensor) else t, params)
    with torch.enable_grad(), torch.autograd.set_detect_anomaly(True, check_nan=False):
        out = loss_fn(alias, *args)
    loss = out[0] if isinstance(out, (tuple, list)) else out
    graph = _Graph(loss)

    rows = []  # (SiteCoverage, modelled flops)
    for raw_path, leaf in _leaves_with_path(alias):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() < 2:
            continue
        pstr = "/".join(str(k) for k in raw_path)
        terms = graph.terminals(leaf)
        role = role_hint(raw_path)
        matmuls = [n for n in terms if _kind(n) in _MATMULS]
        off = [n for n in matmuls if not _is_spine(n)]
        spine = [n for n in terms if (n in matmuls or _is_function(n)) and _is_spine(n)]
        n_apps = sum(1 for n in spine if _sketched_application(n))
        model = _modelled_site_flops(tuple(leaf.shape), n_tokens)
        if off:
            category = "escaped"
            prov = sorted({graph.prov_key(n) for n in off})
            detail = "gradient produced by a dense matmul off the spine"
        elif spine:
            prov = sorted({graph.prov_key(n) for n in spine})
            spec = None
            if policy is not None and "shared" not in raw_path:
                node = _tree_node(alias, raw_path)
                if isinstance(node, dict):
                    spec = resolve_tree_site(raw_path[:-1] if raw_path[-1] == "w"
                                             else raw_path, node, policy, n_layers=n_layers)
            if spec is not None:
                category, detail = "resolved", f"plan={spec.plan.kind}"
            elif "shared" in raw_path:
                category = "exact"
                detail = "multi-use shared subtree — deliberately slot-free"
            elif role is not None and (policy is None or
                                       policy.config_for(role, 0, n_layers) is None):
                category, detail = "exact", f"role {role!r} is policy-excluded"
            else:
                category = "unresolved"
                detail = ("on the spine at runtime (role hint) but invisible "
                          "to path-based spec resolution — no gslots/probes/"
                          "TP plan")
        else:
            category, prov, model = "no_matmul", [], 0.0
            detail = "gradient carries no matmul"
        rows.append((SiteCoverage(param=pstr, role=role, category=category,
                                  provenance=prov, flops=model, detail=detail,
                                  applications=n_apps), model))

    # an escaped leaf's FLOPs are its provenance lines' FLOPs, and the total
    # counts each line once (two params of one fused off-spine line — RWKV's
    # w1/w2 decay LoRA — count once), as JAX groups its traced dots
    flops_by_prov: Dict[str, float] = {}
    for s, model in rows:
        if s.category == "escaped":
            for p in s.provenance:
                flops_by_prov[p] = flops_by_prov.get(p, 0.0) + model / len(s.provenance)
    for s, _ in rows:
        if s.category == "escaped":
            s.flops = sum(flops_by_prov[p] for p in s.provenance)
    sites = [s for s, _ in rows]
    return CoverageReport(
        sites=sites, total_dot_flops=sum(model for _, model in rows),
        escaped_flops=sum(flops_by_prov.values()),
        unresolved_flops=sum(s.flops for s in sites if s.category == "unresolved"))


def analyze_runtime(runtime, cfg, *, batch_size: int = 2, seq_len: int = 16,
                    device="cuda", params=None) -> CoverageReport:
    """Coverage of one Runtime train cell's backward.

    Builds the ``lm.lm_loss`` the train step differentiates, under
    ``runtime.ctx`` (a step seed, so every sketched site is a site Function),
    on ``params`` (default: ``lm.init_params(0, cfg)`` on ``device``) and a
    deterministic batch of ``batch_size`` x ``seq_len`` with the inputs the
    family reads: tokens, or the VLM's embeds and ``[3, B, S]`` positions;
    an encoder-decoder's ``src_embeds``. Read-only (:func:`analyze_loss`).
    """
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models import lm

    dev = resolve_device(device)
    if params is None:
        params = lm.init_params(0, cfg, device=dev)
    B, S = batch_size, seq_len
    ids = torch.arange(B * S + 1, device=dev) % cfg.vocab
    batch = {"labels": ids[1:].reshape(B, S)}
    pdt = getattr(torch, cfg.param_dtype)
    if cfg.frontend == "vision":
        batch["embeds"] = torch.linspace(-0.02, 0.02, B * S * cfg.d_model, device=dev,
                                         dtype=pdt).reshape(B, S, cfg.d_model)
        batch["positions"] = torch.arange(S, device=dev).expand(3, B, S)
    else:
        batch["tokens"] = ids[:-1].reshape(B, S)
    if cfg.is_encdec:
        batch["src_embeds"] = torch.linspace(-0.02, 0.02, B * S * cfg.d_model, device=dev,
                                             dtype=pdt).reshape(B, S, cfg.d_model)
    ctx = runtime.ctx(key=0, n_layers=cfg.n_layers)

    def loss(p, b):
        return lm.lm_loss(p, b, ctx, cfg, 0)[0]

    return analyze_loss(loss, params, batch, policy=runtime.policy,
                        n_layers=cfg.n_layers, n_tokens=float(B * S))


# ---------------------------------------------------------------------------
# Baseline gate
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BaselineResult:
    ok: bool
    unwaived: List[SiteCoverage]
    used: List[str]      # waiver ids that matched at least one site
    unused: List[str]    # waiver ids that matched nothing (stale)

    def message(self) -> str:
        if self.ok:
            return (f"coverage gate: ok ({len(self.used)} baseline waiver(s) "
                    "in use)")
        lines = ["coverage gate: un-waived escapes — every parameter matmul "
                 "must route through core/site.py or be waived in "
                 "src/repro_torch/analysis/baseline.json:"]
        for s in self.unwaived:
            lines.append(f"  {s.param} [{s.category}] at "
                         f"{', '.join(s.provenance) or '?'} — {s.detail}")
        return "\n".join(lines)


def load_baseline(path: Optional[str] = None) -> dict:
    with open(path or BASELINE_PATH) as f:
        return json.load(f)


def _waiver_matches(w: dict, site: SiteCoverage) -> bool:
    if w.get("category") and w["category"] != site.category:
        return False
    if not fnmatch(site.param, w.get("param", "*")):
        return False
    prov_pat = w.get("provenance")
    if prov_pat:
        files = [p.rsplit(":", 1)[0] for p in site.provenance]
        if not any(fnmatch(f, prov_pat) or fnmatch(os.path.basename(f),
                                                   prov_pat) or prov_pat in f
                   for f in files):
            return False
    return True


def check_baseline(report: CoverageReport,
                   baseline: Optional[dict] = None) -> BaselineResult:
    """Gate: every escaped/unresolved site must match a baseline waiver."""
    baseline = baseline if baseline is not None else load_baseline()
    waivers = baseline.get("waivers", [])
    used = set()
    unwaived = []
    for site in report.escapes():
        hit = False
        for w in waivers:
            if _waiver_matches(w, site):
                used.add(w["id"])
                hit = True
        if not hit:
            unwaived.append(site)
    unused = [w["id"] for w in waivers if w["id"] not in used]
    return BaselineResult(ok=not unwaived, unwaived=unwaived,
                          used=sorted(used), unused=unused)
