"""Front door of the port: Runtime, ExecutionConfig, budget schedules,
telemetry, observability, the serving config and the policy types."""
from repro_torch.api.execution import ExecutionConfig
from repro_torch.api.runtime import Runtime
from repro_torch.api.schedule import BudgetSchedule, Controller, StragglerController
from repro_torch.core import POLICY_PRESETS, SketchConfig, SketchPolicy
from repro_torch.obs import Observability, ObsConfig
from repro_torch.serve.config import ServeConfig
from repro_torch.telemetry import TelemetryConfig
from repro_torch.telemetry.controller import AdaptiveBudgetController

__all__ = ["AdaptiveBudgetController", "BudgetSchedule", "Controller", "ExecutionConfig",
           "Observability", "ObsConfig", "POLICY_PRESETS", "Runtime", "ServeConfig",
           "SketchConfig", "SketchPolicy", "StragglerController", "TelemetryConfig"]
