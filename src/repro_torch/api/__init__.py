"""Front door of the port: Runtime, ExecutionConfig, budget schedules,
telemetry, resilience, observability, the serving config, the policy types,
the site spine's plan and spec types, and the estimator registry (as JAX's
``repro.api`` exports them)."""
from repro_torch.api.execution import ExecutionConfig
from repro_torch.api.runtime import Runtime
from repro_torch.api.schedule import BudgetSchedule, Controller, StragglerController
from repro_torch.core import (POLICY_PRESETS, Estimator, EstimatorVJP, SketchConfig,
                              SketchPolicy, get_estimator, register_estimator,
                              registered_backends)
from repro_torch.core.site import ExecutionPlan, SiteSpec, resolve_site
from repro_torch.obs import Observability, ObsConfig
from repro_torch.resilience import (FaultPlan, FaultSpec, GradSentinel, ResilienceConfig,
                                    Supervisor)
from repro_torch.serve.config import ServeConfig
from repro_torch.telemetry import TelemetryConfig
from repro_torch.telemetry.controller import AdaptiveBudgetController

__all__ = ["AdaptiveBudgetController", "BudgetSchedule", "Controller", "Estimator",
           "EstimatorVJP", "ExecutionConfig", "ExecutionPlan", "FaultPlan", "FaultSpec",
           "GradSentinel", "Observability", "ObsConfig", "POLICY_PRESETS", "ResilienceConfig",
           "Runtime", "ServeConfig", "SiteSpec", "SketchConfig", "SketchPolicy",
           "StragglerController", "Supervisor", "TelemetryConfig", "get_estimator",
           "register_estimator", "registered_backends", "resolve_site"]
