"""Sketch placement policy — which VJP sites get which budget.

Port of ``repro/core/policy.py``. The paper approximates all linear layers
except the output classifier (§5); App. B.1 studies location (first / last /
all).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

from repro_torch.core.sketching import SketchConfig

__all__ = ["SketchPolicy", "POLICY_PRESETS", "ROLES"]

# Roles attached by the nn substrate to each linear site; the index of a role
# is its id in the per-site seed derivation (nn/common.py).
ROLES = (
    "attn_q", "attn_k", "attn_v", "attn_o",
    "mlp_in", "mlp_gate", "mlp_out",
    "expert_in", "expert_gate", "expert_out", "router",
    "ssm_in", "ssm_out", "ssm_small",
    "embed", "lm_head", "input_proj", "cross_q", "cross_k", "cross_v", "cross_o",
)

_DEFAULT_EXCLUDE = ("lm_head", "router", "embed", "input_proj", "ssm_small")


@dataclasses.dataclass(frozen=True)
class SketchPolicy:
    """Maps a linear site (role, layer_index, n_layers) -> Optional[SketchConfig].

    Attributes:
      base: the sketch applied to included sites (None = exact everywhere).
      exclude_roles: roles that always backprop exactly.
      location: "all" | "first" | "last" (paper App. B.1).
      overrides: role -> SketchConfig overriding ``base``.
    """

    base: Optional[SketchConfig] = None
    exclude_roles: Sequence[str] = _DEFAULT_EXCLUDE
    location: str = "all"
    overrides: Mapping[str, SketchConfig] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.location not in ("all", "first", "last"):
            raise ValueError(f"bad location {self.location!r}")
        object.__setattr__(self, "overrides", tuple(sorted(dict(self.overrides).items())))

    def config_for(self, role: str, layer_index: int = 0, n_layers: int = 1) -> Optional[SketchConfig]:
        if role in self.exclude_roles:
            return None
        if self.location == "first" and layer_index != 0:
            return None
        if self.location == "last" and layer_index != n_layers - 1:
            return None
        for k, v in self.overrides:
            if k == role:
                return v
        return self.base

    def with_budget(self, budget: float) -> "SketchPolicy":
        """Same policy at a different budget."""
        if self.base is None:
            return self
        return dataclasses.replace(
            self,
            base=dataclasses.replace(self.base, budget=budget),
            overrides={k: dataclasses.replace(v, budget=budget) for k, v in self.overrides},
        )


def _mk(method, budget, backend="mask", **kw):
    return SketchPolicy(base=SketchConfig(method=method, budget=budget, backend=backend, **kw))


POLICY_PRESETS = {
    "exact": SketchPolicy(base=None),
    "l1": lambda p: _mk("l1", p),
    "ds": lambda p: _mk("ds", p),
    "gsv": lambda p: _mk("gsv", p),
    "rcs": lambda p: _mk("rcs", p),
    "per_column": lambda p: _mk("per_column", p),
    "per_sample": lambda p: _mk("per_sample", p),
    "per_element": lambda p: _mk("per_element", p),
    "l1_compact": lambda p: _mk("l1", p, backend="compact", round_to=128),
    "ds_compact": lambda p: _mk("ds", p, backend="compact", round_to=128),
}
