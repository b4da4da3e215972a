"""Plan-carry state: the previous step's column scores, carried through the step.

Port of ``repro/core/plan_state.py``. The plan-carry estimators (``onepass``,
``stale``, ``core/sketched_linear.py``) sample the step-t sketch from scores
computed at step t-1, so the backward's only read of G is the estimator's
kernel. The carry is a permanent parameter leaf, as in JAX:

* :func:`with_plan_state` adds an ``"sslot"`` leaf (``[n]`` float32 ones,
  the uniform prior) to every carry-capable site's dict at ``init_state``.
* ``nn.common.dense`` passes the leaf to the site; the site's backward
  returns the REFRESHED scores as the leaf's gradient (``core/site.py``).
* :func:`collect_plan_state` takes the refreshed scores out of the gradient
  tree and zeroes those leaves there, so the carry never enters the gradient
  norm, the clipping or the optimizer's moments.
* :func:`write_plan_state` writes the refreshed scores over the carry leaves
  after the optimizer update.

The JAX model stacks its layers, so its leaf is ``[n_layers, n]``; the port
keeps one dict per layer (``params["layers"]``) and one ``[n]`` leaf in each.

Unbiasedness does not depend on the carry's freshness: the solver floors
every keep probability strictly above zero, so given ANY carry
``E[dW | carry] = GᵀX`` exactly; staleness moves only the variance.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import estimators

__all__ = ["PLAN_SLOT", "plan_carry_capable", "policy_uses_carry", "with_plan_state",
           "collect_plan_state", "write_plan_state"]

PLAN_SLOT = "sslot"


def _estimator(cfg):
    if cfg is None or cfg.is_noop:
        return None
    try:
        est = estimators.get_estimator(cfg.backend)
    except KeyError:
        return None
    return est if getattr(est, "plan_carry", False) else None


def plan_carry_capable(cfg) -> bool:
    """Does this site's estimator carry a plan?"""
    return _estimator(cfg) is not None


def policy_uses_carry(policy) -> bool:
    """True when any config the policy can hand out (base or a role override)
    is a plan-carry estimator."""
    if policy is None:
        return False
    return plan_carry_capable(policy.base) or any(
        plan_carry_capable(cfg) for _, cfg in policy.overrides)


def with_plan_state(params, policy, *, n_layers: int = 1, mesh=None, data_axes=("data",),
                    model_axes=("model",), tp_sketch: bool = False):
    """``params`` with a uniform-prior carry leaf in every site whose config
    carries a plan (``SiteSpec.carry_rows``, from ``core.site.
    resolve_tree_site``, the resolution the site runs). Ones, not zeros:
    equal scores are the uniform sampling prior for step 0.

    Only ``location="all"`` policies get leaves, as in JAX (whose stacked
    layers cannot tell layers apart). The result is a new tree of dicts
    holding the same tensors."""
    if policy is None or policy.location != "all":
        return params
    from repro_torch.core.site import resolve_tree_site

    def walk(node, path):
        if isinstance(node, dict):
            out = {k: walk(v, path + (k,)) for k, v in node.items()}
            spec = resolve_tree_site(path, node, policy, n_layers=n_layers, mesh=mesh,
                                     data_axes=data_axes, model_axes=model_axes,
                                     tp_sketch=tp_sketch)
            if spec is not None and spec.carry_rows is not None:
                out[PLAN_SLOT] = torch.ones(spec.carry_rows, dtype=torch.float32,
                                            device=node["w"].device)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path) for v in node)
        return node

    return walk(params, ())


def collect_plan_state(grads) -> Tuple[object, Dict[str, torch.Tensor]]:
    """Take the refreshed scores out of a gradient tree.

    Returns ``(clean_grads, fresh)``: ``clean_grads`` has every ``"sslot"``
    gradient replaced by zeros (same structure as the parameters, invisible
    to the gradient norm and the optimizer), and ``fresh`` maps the
    ``/``-joined path of each carry leaf to its refreshed scores."""
    fresh: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == PLAN_SLOT:
                    fresh["/".join(map(str, path + (k,)))] = v
                    out[k] = torch.zeros_like(v)
                else:
                    out[k] = walk(v, path + (k,))
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,)) for i, v in enumerate(node))
        return node

    return walk(grads, ()), fresh


@torch.no_grad()
def write_plan_state(params, fresh: Dict[str, torch.Tensor]):
    """Write ``fresh`` (from :func:`collect_plan_state`) over the carry leaves
    of ``params``, in place, and return ``params``. Leaves absent from
    ``fresh`` keep their carry."""
    if not fresh:
        return params

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                p = path + (k,)
                key = "/".join(map(str, p))
                if k == PLAN_SLOT and key in fresh:
                    v.copy_(fresh[key])
                else:
                    walk(v, p)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))

    walk(params, ())
    return params
