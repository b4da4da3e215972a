"""Core estimator math of the port: solver, scores, sketches, registry, site,
plan carry, compact gradients."""
from repro_torch.core import sketched_linear as _builtin_estimators  # noqa: F401  (registers the builtin backends)
from repro_torch.core.compact_grad import CompactGrad
from repro_torch.core.estimators import (Estimator, EstimatorVJP, get_estimator,
                                         register_estimator, registered_backends)
from repro_torch.core.policy import POLICY_PRESETS, ROLES, SketchPolicy
from repro_torch.core.sketched_linear import linear, sketched_linear
from repro_torch.core.sketching import (ColumnPlan, SketchConfig, column_plan,
                                        column_plan_from_scores, sketch_dense,
                                        static_block_rank, static_rank)

__all__ = ["CompactGrad", "Estimator", "EstimatorVJP", "get_estimator", "register_estimator",
           "registered_backends", "POLICY_PRESETS", "ROLES", "SketchPolicy",
           "linear", "sketched_linear", "ColumnPlan", "SketchConfig",
           "column_plan", "column_plan_from_scores", "sketch_dense", "static_block_rank",
           "static_rank"]
