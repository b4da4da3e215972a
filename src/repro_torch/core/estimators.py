"""Estimator registry: pluggable unbiased-VJP backends for sketched linears.

Port of ``repro/core/estimators.py``. An estimator owns the backward math of
one linear site; the autograd plumbing and the scatter of compact rows into
the dense weight gradient live in ``core/site.py`` and are shared by every
entry. ``SketchConfig.backend`` is the registry key.

Contract (unbiasedness): ``E[dX] = G·W``, ``E[dW] = Gᵀ·X``, ``E[db] = Σ G``.

The builtin ``mask``, ``compact`` and ``pallas`` backends are registered by
``core/sketched_linear.py`` when ``repro_torch.core`` is imported.
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
    """

    dx: torch.Tensor  # [N, d_in] flattened-input gradient
    dw: Optional[torch.Tensor] = None
    db: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None
    cols: Optional[torch.Tensor] = None
    db_c: Optional[torch.Tensor] = None

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
      compact_rank(cfg, n): number of compact rows ``apply`` emits.
    """

    name: str = "?"
    supports_compact_grad: bool = False

    def validate(self, cfg) -> None:  # noqa: B027 — optional hook
        pass

    def apply(self, cfg, G2d, X2d, w, gen, *, has_b) -> EstimatorVJP:
        raise NotImplementedError

    def compact_rank(self, cfg, n: int) -> int:
        raise NotImplementedError(f"estimator {self.name!r} is not compact")


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
