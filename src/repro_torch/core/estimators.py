"""Estimator registry: pluggable unbiased-VJP backends for sketched linears.

Port of ``repro/core/estimators.py``. An estimator owns the backward math of
one linear site; the autograd plumbing and the scatter of compact rows into
the dense weight gradient live in ``core/site.py`` and are shared by every
entry. ``SketchConfig.backend`` is the registry key.

Contract (unbiasedness): ``E[dX] = G·W``, ``E[dW] = Gᵀ·X``, ``E[db] = Σ G``.

The builtin ``mask``, ``compact``, ``pallas``, ``onepass`` and ``stale``
backends are registered by ``core/sketched_linear.py`` when
``repro_torch.core`` is imported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

__all__ = ["Estimator", "EstimatorVJP", "register_estimator", "get_estimator",
           "registered_backends"]


@dataclasses.dataclass
class EstimatorVJP:
    """Result of one estimator backward, dense or compact.

    Dense form (``rows is None``): ``dw`` is the full ``[n, d_in]`` weight
    gradient and ``db`` the full ``[n]`` bias gradient.

    Compact form: ``rows [r, d_in]`` are the kept dW rows, ``cols [r]`` their
    int64 row indices into the dense weight, and ``db_c [r]`` the bias
    gradient restricted to the same columns; the site scatters them.

    ``state`` (plan carry): the refreshed per-site plan state (fresh column
    scores, ``[n]`` f32) emitted by :meth:`Estimator.apply_with_state`. The
    site returns it as the gradient of its carry input; the train step writes
    it back into the parameters for the next step (``core/plan_state.py``).

    ``probe`` (telemetry): the site's ``[PROBE_WIDTH]`` f32 probe vector
    (``telemetry/probes.py``), emitted by :meth:`Estimator.apply_with_probe`
    or by ``apply_with_state(..., want_probe=True)``; the site returns it as
    the gradient of its probe slot. ``probe_p``: the keep marginals of the
    rows it read (``[r]``, or ``[n]`` for a dense dW): a site whose rows are
    summed over data ranks afterwards recomputes the probe from the sum.
    """

    dx: torch.Tensor  # [N, d_in] flattened-input gradient
    dw: Optional[torch.Tensor] = None
    db: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None
    cols: Optional[torch.Tensor] = None
    db_c: Optional[torch.Tensor] = None
    state: Optional[torch.Tensor] = None
    probe: Optional[torch.Tensor] = None
    probe_p: Optional[torch.Tensor] = None  # the keep marginals the probe read

    @property
    def is_compact(self) -> bool:
        return self.rows is not None


class Estimator:
    """Protocol for one registered VJP estimator (duck typing is enough).

    Attributes:
      name: registry key, referenced by ``SketchConfig.backend``.
      supports_compact_grad: ``apply`` emits the compact (rows/cols/db_c) form.

    Methods:
      validate(cfg): raise ValueError for unsupported configs; called from
        ``SketchConfig.__post_init__`` for non-builtin backends.
      apply(cfg, G2d, X2d, w, gen, *, has_b): the backward; returns an
        :class:`EstimatorVJP`. ``gen`` is the site's ``torch.Generator``.
      apply_with_probe(cfg, G2d, X2d, w, gen, *, has_b): the telemetry
        spelling of ``apply``: the same backward (same draws, same
        gradients), with ``EstimatorVJP.probe`` filled from the kept rows and
        the plan's keep marginals. The default delegates to ``apply`` and
        emits no probe; only estimators that override it get probe slots.
      compact_rank(cfg, n): number of compact rows ``apply`` emits.
      carry_size(cfg, n): size of the per-site plan-carry state of a site of
        width ``n`` (required when ``plan_carry``; read by
        ``core/plan_state.py`` to build the carry leaf).
      apply_with_state(cfg, G2d, X2d, w, gen, state, *, has_b, want_probe):
        the plan-carry spelling of ``apply``: sample from the CARRIED
        ``state`` (previous step's scores; ``None`` means no carry yet, the
        uniform prior), run the one-pass backward, and return the
        :class:`EstimatorVJP` with ``state`` set to the refreshed carry. The
        site calls it instead of ``apply`` when ``plan_carry``;
        ``want_probe`` folds the probe into the same sweep. The default
        ignores ``state`` and delegates to ``apply_with_probe`` or ``apply``
        (no refresh).

    ``plan_carry``: the estimator samples the step-t sketch from state
    carried over from step t-1 instead of a score pass over G, so the
    backward's only read of G is the estimator's kernel.

    ``tp_shardable``: opt-in to the tensor-parallel plans (``core/site.py``,
    ``tp_column``/``tp_row``): the estimator's :meth:`plan` returns a
    compact ``ColumnPlan`` (indices, scales, keep marginals) valid on one
    model shard of G, and the site runs the matmuls and collectives around
    it. :func:`repro_torch.core.site.tp_estimator` consults the flag and
    calls :meth:`validate`; an estimator without it resolves to the local
    plan (the dense mask backend on a compact-form estimator).
      plan(cfg, G2d, w, gen, *, want_compact, score_psum_axes): the sampled
        sketch; inside the TP backward ``want_compact=True`` and
        ``score_psum_axes`` names the data axes whose ranks pool their
        scores. The default returns None.

    The builtin backends also take ``score_psum_axes`` in ``apply``,
    ``apply_with_probe`` and ``apply_with_state``: a local-plan site under a
    data-sharded mesh passes its data axes, so every replica draws the plan
    of the whole batch (``core/sketching.py``).
    """

    name: str = "?"
    supports_compact_grad: bool = False
    plan_carry: bool = False
    tp_shardable: bool = False

    def validate(self, cfg) -> None:  # noqa: B027 — optional hook
        pass

    def apply(self, cfg, G2d, X2d, w, gen, *, has_b) -> EstimatorVJP:
        raise NotImplementedError

    def apply_with_probe(self, cfg, G2d, X2d, w, gen, *, has_b) -> EstimatorVJP:
        return self.apply(cfg, G2d, X2d, w, gen, has_b=has_b)

    def plan(self, cfg, G2d, w, gen, *, want_compact=True, score_psum_axes=None):
        return None

    def compact_rank(self, cfg, n: int) -> int:
        raise NotImplementedError(f"estimator {self.name!r} is not compact")

    def carry_size(self, cfg, n: int) -> int:
        raise NotImplementedError(f"estimator {self.name!r} carries no plan")

    def apply_with_state(self, cfg, G2d, X2d, w, gen, state, *, has_b,
                         want_probe: bool = False) -> EstimatorVJP:
        if want_probe:
            return self.apply_with_probe(cfg, G2d, X2d, w, gen, has_b=has_b)
        return self.apply(cfg, G2d, X2d, w, gen, has_b=has_b)


_REGISTRY: Dict[str, Estimator] = {}


def register_estimator(est: Estimator, *, name: Optional[str] = None,
                       overwrite: bool = False) -> Estimator:
    """Register ``est`` under ``name`` (default ``est.name``) and return it.
    Existing names are replaced only with ``overwrite=True``."""
    key = name or getattr(est, "name", None)
    if not key or not isinstance(key, str):
        raise ValueError("estimator needs a non-empty string name")
    if key in _REGISTRY and not overwrite:
        raise ValueError(f"estimator {key!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[key] = est
    return est


def get_estimator(backend: str) -> Estimator:
    try:
        return _REGISTRY[backend]
    except KeyError:
        raise KeyError(
            f"unknown estimator backend {backend!r}; registered: "
            f"{sorted(_REGISTRY)} — register it first via "
            "repro_torch.core.estimators.register_estimator") from None


def registered_backends() -> tuple:
    return tuple(sorted(_REGISTRY))
