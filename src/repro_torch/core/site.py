"""The sketched-site spine: one ``torch.autograd.Function`` per linear site.

Port of the local plan of ``repro/core/site.py`` (``SiteSpec``,
``resolve_site``, ``resolve_tree_site``, ``_fwd``, ``_bwd``, ``_local_bwd``,
``_pack``). The forward is a plain matmul; the backward flattens the output
gradient to ``G2d [N, n]`` and dispatches through the estimator registry. A
compact backward's rows leave in one of two ways:

* dense (the default): scattered into a freshly zeroed dense weight gradient
  (compact ``db`` into the dense bias gradient);
* compact gradients: when the site has a gradient slot (``gslot``,
  ``core/compact_grad.py``), the kept rows and their int64 indices go into
  the slot and the weight gets NO gradient from the Function (``None``): no
  dense dW is allocated or filled. ``db`` stays dense ``[n]``, as in JAX.

The site's generator is consumed only in the backward, so a forward alone
draws no random numbers.

:func:`resolve_site` is the one dispatch decision per site, memoized: the
slot builders (``with_grad_slots``, ``with_plan_state``) emit slots from the
same resolved :class:`SiteSpec` (``compact_rows``, ``carry_rows``) that the
site checks its slot against, so slot emission and the backward's dispatch
cannot drift apart.

Plan carry, as in JAX: a plan-carry site (``onepass``, ``stale``) takes its
carry leaf (``sslot``, the previous step's column scores) as one more input.
The backward samples the plan from it and returns the REFRESHED scores as
that input's gradient, so ``torch.autograd.grad`` hands them to the train
step beside the weight gradients. The forward never writes the carry; the
train step takes the refreshed scores out of the gradients and writes them
over the carry after the optimizer update (``core/plan_state.py``).

Telemetry probes, as in JAX: a probed site takes its probe slot (``pslot``, a
zero ``[PROBE_WIDTH]`` float32 tensor made per step by
``telemetry.probes.with_probe_slots``) as one more autograd input. The
forward ignores it; the backward runs the estimator's probe spelling
(``apply_with_probe``, or ``apply_with_state(..., want_probe=True)`` for a
plan-carry estimator, so the probe comes from the same sweep) and returns the
probe vector as the slot's gradient, or zeros (``ok = 0``) when the
estimator emitted none. A site can hold a ``gslot``, a ``pslot`` and an
``sslot`` at once.

The tensor-parallel plans of the JAX spine are not ported yet.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional

import torch

from repro_torch.core import estimators
from repro_torch.core.sketching import SketchConfig

__all__ = ["SiteSpec", "resolve_site", "resolve_tree_site", "site_role", "sketched_site"]


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """One resolved sketched-linear site (local plan; static, hashable).

    ``compact_rows``: the number of compact dW rows the backward emits (the
    gslot rank), or None when the weight gradient stays dense.
    ``carry_rows``: the size of the site's plan-carry leaf (sslot) for a
    plan-carry estimator, or None.
    ``probe_capable``: the backward can emit the telemetry probe (the pslot
    builder reads it).
    """

    role: str
    cfg: Optional[SketchConfig]
    has_bias: bool = False
    d_out: int = 0
    d_in: int = 0
    compact_rows: Optional[int] = None
    carry_rows: Optional[int] = None
    probe_capable: bool = False


@lru_cache(maxsize=4096)
def _resolve(role, cfg, d_out, d_in, has_bias) -> SiteSpec:
    from repro_torch.telemetry.probes import probe_capable

    rows = carry = None
    if cfg is not None and not cfg.is_noop:
        try:
            est = estimators.get_estimator(cfg.backend)
        except KeyError:
            est = None
        if est is not None and est.supports_compact_grad:
            rows = est.compact_rank(cfg, d_out)
        if est is not None and getattr(est, "plan_carry", False):
            carry = est.carry_size(cfg, d_out)
    return SiteSpec(role=role, cfg=cfg, has_bias=has_bias, d_out=d_out, d_in=d_in,
                    compact_rows=rows, carry_rows=carry, probe_capable=probe_capable(cfg))


def resolve_site(role: str, cfg: Optional[SketchConfig], *, d_out: int, d_in: int,
                 has_bias: bool = False) -> SiteSpec:
    """Resolve one linear site to its :class:`SiteSpec` (memoized)."""
    return _resolve(role, cfg, int(d_out), int(d_in), bool(has_bias))


def site_role(path) -> Optional[str]:
    """The role of the linear site at ``path`` in a parameter tree (attn/cross
    q|k|v|o, mlp in|gate|out), or None."""
    if len(path) < 2:
        return None
    parent, leaf = path[-2], path[-1]
    if parent in ("attn", "cross") and leaf in ("q", "k", "v", "o"):
        return f"{parent}_{leaf}"
    if parent == "mlp" and leaf in ("in", "gate", "out"):
        return f"mlp_{leaf}"
    return None


def resolve_tree_site(path, node, policy, *, n_layers: int = 1) -> Optional[SiteSpec]:
    """Spec for one parameter-tree node, or None if the node is not a
    sketched site. Sites are matched by path with the layer-0 config, as in
    JAX; the multi-use ``"shared"`` subtree is excluded (a weight applied more
    than once per step gets no slot). The gslot, pslot and sslot builders all
    read it."""
    role = None if "shared" in path else site_role(path)
    if role is None or not isinstance(node, dict):
        return None
    w = node.get("w")
    if not isinstance(w, torch.Tensor) or w.dim() != 2:
        return None
    cfg = policy.config_for(role, 0, n_layers)
    if cfg is None or cfg.is_noop:
        return None
    return resolve_site(role, cfg, d_out=w.shape[0], d_in=w.shape[1], has_bias="b" in node)


def _matmul(x, w, b):
    y = torch.matmul(x, w.t())
    return y + b if b is not None else y


class SketchedLinearFn(torch.autograd.Function):
    """``y = x @ w.T (+ b)`` with the estimator backward of ``cfg``; the
    gradient of ``sslot`` (when given) is the refreshed plan carry, that of
    ``pslot`` the probe vector; with a ``gslot`` the compact rows go into the
    slot and ``w`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, w, b, sslot, pslot, cfg, gen, gslot):
        ctx.save_for_backward(x, w, sslot)
        ctx.cfg = cfg
        ctx.gen = gen
        ctx.gslot = gslot
        ctx.has_b = b is not None
        ctx.want_probe = pslot is not None
        return _matmul(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w, sslot = ctx.saved_tensors
        cfg = ctx.cfg
        n = w.shape[0]
        G2d = g.reshape(-1, n)
        X2d = x.reshape(-1, x.shape[-1])
        est = estimators.get_estimator(cfg.backend)
        want_probe = ctx.want_probe
        if getattr(est, "plan_carry", False):
            # the plan comes from the carried scores (None: uniform prior);
            # the refreshed scores come back in out.state, the probe from the
            # same sweep
            out = est.apply_with_state(cfg, G2d, X2d, w, ctx.gen, sslot, has_b=ctx.has_b,
                                       want_probe=want_probe)
        elif want_probe:
            out = est.apply_with_probe(cfg, G2d, X2d, w, ctx.gen, has_b=ctx.has_b)
        else:
            out = est.apply(cfg, G2d, X2d, w, ctx.gen, has_b=ctx.has_b)
        state_ct = None
        if sslot is not None:
            # zeros when the estimator emitted no refresh, as in JAX
            state_ct = (out.state.to(sslot.dtype) if out.state is not None
                        else torch.zeros_like(sslot))
        probe_ct = None
        if want_probe:
            from repro_torch.telemetry.probes import PROBE_WIDTH

            probe_ct = (out.probe if out.probe is not None
                        else torch.zeros(PROBE_WIDTH, dtype=torch.float32, device=g.device))
        dX = out.dx.reshape(x.shape)
        if not out.is_compact:
            if ctx.gslot is not None:
                raise RuntimeError(f"estimator {cfg.backend!r} returned a dense dW for a site "
                                   "with a gradient slot")
            db = out.db if ctx.has_b else None
            return dX, out.dw.to(w.dtype), db, state_ct, probe_ct, None, None, None
        db = None
        if ctx.has_b:
            db = torch.zeros(n, dtype=g.dtype, device=g.device).index_add_(
                0, out.cols, out.db_c.to(g.dtype))
        if ctx.gslot is not None:
            # compact gradients: the rows leave through the slot; no dense dW
            ctx.gslot.put(out.rows, out.cols)
            return dX, None, db, state_ct, probe_ct, None, None, None
        # kept rows are distinct, so the scatter-add writes each row once
        dW = torch.zeros_like(w).index_add_(0, out.cols, out.rows.to(w.dtype))
        return dX, dW, db, state_ct, probe_ct, None, None, None


def sketched_site(cfg: Optional[SketchConfig], x, w, b=None,
                  gen: Optional[torch.Generator] = None,
                  sslot: Optional[torch.Tensor] = None, gslot=None,
                  pslot: Optional[torch.Tensor] = None):
    """Run one site. No config, a no-op config or no generator give the exact
    linear under plain autograd. ``sslot``: the site's plan-carry leaf;
    ``gslot``: its :class:`~repro_torch.core.compact_grad.GradSlot`, checked
    against the site's resolved ``compact_rows``; ``pslot``: its probe slot."""
    if cfg is None or cfg.is_noop or gen is None:
        return _matmul(x, w, b)
    if gslot is not None:
        spec = resolve_site("linear", cfg, d_out=w.shape[0], d_in=w.shape[1],
                            has_bias=b is not None)
        if spec.compact_rows != gslot.r:
            raise ValueError(f"gradient slot of {gslot.r} rows on a site that resolves to "
                             f"{spec.compact_rows} compact rows ({cfg.backend!r})")
    return SketchedLinearFn.apply(x, w, b, sslot, pslot, cfg, gen, gslot)
