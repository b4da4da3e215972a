"""Per-site telemetry probes: unbiased estimates of each sketched site's VJP
variance (port of ``repro/telemetry/probes.py``).

Probe math (column-family estimators). A column sketch keeps column ``j`` of
the output gradient ``G`` with marginal probability ``p_j`` and rescales it by
``1/p_j``. With ``u_j = g_jᵀ X`` (row ``j`` of the exact ``dW = Gᵀ X``), the
backward materialises the kept rows ``rows_j = u_j / p_j`` (compact backends)
or the dense sketched dW whose dropped rows are zero (mask backend):

* ``g_sq    = Σ_kept p_j ‖rows_j‖²`` — unbiased estimate of ``‖dW‖²_F``;
* ``var     = Σ_kept (1 − p_j) ‖rows_j‖²`` — unbiased estimate of the
  site's VJP variance ``Σ_j ((1 − p_j)/p_j) ‖u_j‖²`` under independent
  gates; under correlated exact-r sampling it estimates the diagonal term;
* ``ghat_sq = Σ_kept ‖rows_j‖²`` — the realised ``‖dŴ‖²_F``.

The step statistics are ``snr = g_sq / var`` (the adaptive controller's
signal) and ``align = sqrt(g_sq / ghat_sq)``.

Transport out of ``torch.autograd.grad``: every probed site gets a probe
slot, a zero ``[PROBE_WIDTH]`` float32 tensor under key ``"pslot"`` that
requires grad, made per step (:func:`with_probe_slots`). The site passes it
to its autograd Function as one more input; the forward ignores it and the
backward returns the probe vector as its gradient (zeros, ``ok = 0``, when
the estimator emitted none). :func:`collect_probes` strips the slots' grads
out of the gradient tree and :func:`summarize` reduces them.

Keys. JAX stacks its layers, so one JAX site path (``segments/0/0/attn/q``)
holds a ``[n_layers, PROBE_WIDTH]`` probe that ``summarize`` sums over its
leading dimension; the port keeps one dict per layer (``layers/<i>/attn/q``).
:func:`site_key` maps a port path to its JAX path (a model of several
segments, gemma3's, passes ``layer_paths``: ``lm.jax_layer_paths``; an
encoder-decoder also passes ``encoder_paths``: ``lm.jax_layer_paths(cfg,
encoder=True)``), and
:func:`summarize` sums the per-layer vectors under it, so ``probe_sites``
(and a JSONL record) has JAX's keys and values. The per-site cost table
(``telemetry/sinks.py``) uses the dense stack's mapping.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import estimators
from repro_torch.core.sketching import COLUMN_METHODS

__all__ = ["PROBE_WIDTH", "PROBE_FIELDS", "PROBE_SLOT", "probe_from_rows", "probe_capable",
           "with_probe_slots", "mlp_probe_slots", "collect_probes", "summarize", "site_key"]

# ok is 1.0 when the estimator produced a probe, so a zero vector is
# distinguishable from a perfectly quiet site
PROBE_FIELDS = ("g_sq", "var", "ghat_sq", "ok")
PROBE_WIDTH = len(PROBE_FIELDS)
PROBE_SLOT = "pslot"


def probe_from_rows(rows: torch.Tensor, probs: torch.Tensor, *, row_sum=None,
                    col_sum=None) -> torch.Tensor:
    """The probe vector from materialised dW rows and their keep marginals.

    rows: ``[r, d_in]`` kept (rescaled) dW rows, or the dense ``[n, d_in]``
    sketched dW whose dropped rows are zero. probs: the matching ``[r]`` (or
    ``[n]``) keep marginals ``p_j``. A site split over model
    (``core/site.py``) completes its partial sums: ``row_sum`` the squared
    row norms over the ranks holding the rest of d_in, ``col_sum`` the three
    statistics over the ranks holding the other rows.
    """
    r32 = rows.to(torch.float32)
    rs = (r32 * r32).sum(-1)  # ‖rows_j‖²
    if row_sum is not None:
        rs = row_sum(rs)
    p = probs.to(torch.float32)
    # one small product gives all three statistics: rs · [p, 1 − p, 1]
    w3 = torch.stack([p, 1.0 - p, torch.ones_like(p)], dim=-1)
    v3 = rs @ w3
    if col_sum is not None:
        v3 = col_sum(v3)
    return torch.cat([v3, torch.ones(1, dtype=torch.float32, device=rs.device)])


def probe_capable(cfg) -> bool:
    """Can this site's estimator produce a probe? (a column-family method and
    an estimator that overrides ``apply_with_probe``)"""
    if cfg is None or cfg.is_noop or cfg.method not in COLUMN_METHODS:
        return False
    try:
        est = estimators.get_estimator(cfg.backend)
    except KeyError:
        return False
    return type(est).apply_with_probe is not estimators.Estimator.apply_with_probe


def _slot(device) -> torch.Tensor:
    return torch.zeros(PROBE_WIDTH, dtype=torch.float32, device=device, requires_grad=True)


def with_probe_slots(params, policy, *, n_layers: int = 1, mesh=None, data_axes=("data",),
                     model_axes=("model",), tp_sketch: bool = False):
    """``params`` with a fresh probe slot under ``"pslot"`` at every site whose
    resolved :class:`~repro_torch.core.site.SiteSpec` is ``probe_capable`` —
    the resolution the gslot and sslot builders and ``nn.common.dense`` read.
    Only ``location="all"`` policies get slots, as in JAX; the result is then
    a new tree of dicts holding the same tensors, else ``params`` itself."""
    if policy is None or policy.location != "all":
        return params
    from repro_torch.core.site import resolve_tree_site

    def walk(node, path):
        if isinstance(node, dict):
            out = {k: walk(v, path + (k,)) for k, v in node.items()}
            spec = resolve_tree_site(path, node, policy, n_layers=n_layers, mesh=mesh,
                                     data_axes=data_axes, model_axes=model_axes,
                                     tp_sketch=tp_sketch)
            if spec is not None and spec.probe_capable:
                out[PROBE_SLOT] = _slot(node["w"].device)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,)) for i, v in enumerate(node))
        return node

    return walk(params, ())


def mlp_probe_slots(params, policy):
    """Probe slots for the §5 MLP (a list of ``{"w", "b"}`` dicts; role
    ``mlp_in`` per hidden layer, ``lm_head`` for the output, as
    ``models/mlp.py`` runs them). Static layer indices, so location
    policies apply here."""
    if policy is None:
        return params
    L = len(params)
    out = []
    for i, site in enumerate(params):
        cfg = policy.config_for("lm_head" if i == L - 1 else "mlp_in", i, L)
        site = dict(site)
        if probe_capable(cfg):
            site[PROBE_SLOT] = _slot(site["w"].device)
        out.append(site)
    return out


def collect_probes(grads) -> Tuple[object, Dict[str, torch.Tensor]]:
    """Strip the ``"pslot"`` gradients out of a gradient tree.

    Returns ``(clean_grads, probes)``: ``clean_grads`` has the slot-free
    parameters' structure and ``probes`` maps the ``/``-joined port path of
    each probed site to its ``[PROBE_WIDTH]`` vector."""
    probes: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == PROBE_SLOT:
                    probes["/".join(map(str, path))] = v
                else:
                    out[k] = walk(v, path + (k,))
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,)) for i, v in enumerate(node))
        return node

    return walk(grads, ()), probes


def site_key(path: str, layer_paths=None, encoder_paths=None) -> str:
    """The JAX site path of a port site path: layer ``i`` (``layers/<i>/...``)
    is ``layer_paths[i]`` (``segments/<segment>/<sub-block>``), by default
    the dense stack's one segment (``segments/0/0``); encoder layer ``i``
    (``encoder/layers/<i>/...``) is ``encoder_paths[i]``
    (``lm.jax_layer_paths(cfg, encoder=True)``); every other path is the
    same in both packages."""
    parts = path.split("/")
    if len(parts) > 3 and parts[:2] == ["encoder", "layers"] and parts[2].isdigit():
        if encoder_paths is None:
            raise ValueError(f"{path}: an encoder site needs encoder_paths")
        return "/".join([encoder_paths[int(parts[2])]] + parts[3:])
    if len(parts) > 2 and parts[0] == "layers" and parts[1].isdigit():
        head = "segments/0/0" if layer_paths is None else layer_paths[int(parts[1])]
        return "/".join([head] + parts[2:])
    return path


def summarize(probes: Dict[str, torch.Tensor], *, per_site: bool = True,
              layer_paths=None, encoder_paths=None) -> dict:
    """Step-level probe metrics: ``probe_gsq``, ``probe_var``, ``probe_snr``
    and ``probe_align`` (0-d tensors), and, with ``per_site``, ``probe_sites``:
    JAX site path -> summed ``[PROBE_WIDTH]`` vector (the layers of a stacked
    JAX site summed, as JAX sums its leading dimension)."""
    if not probes:
        return {}
    site_tot: Dict[str, torch.Tensor] = {}
    for path, v in probes.items():
        key = site_key(path, layer_paths, encoder_paths)
        v = v.reshape(-1, PROBE_WIDTH).sum(0)
        site_tot[key] = v if key not in site_tot else site_tot[key] + v
    tot = sum(site_tot.values())
    g_sq, var, ghat_sq = tot[0], tot[1], tot[2]
    out = {"probe_gsq": g_sq,
           "probe_var": var,
           "probe_snr": g_sq / var.clamp_min(1e-20),
           "probe_align": torch.sqrt(g_sq / ghat_sq.clamp_min(1e-20))}
    if per_site:
        out["probe_sites"] = site_tot
    return out
