"""Front door of the port: Runtime, ExecutionConfig and the policy types."""
from repro_torch.api.execution import ExecutionConfig
from repro_torch.api.runtime import Runtime
from repro_torch.core import POLICY_PRESETS, SketchConfig, SketchPolicy

__all__ = ["ExecutionConfig", "Runtime", "POLICY_PRESETS", "SketchConfig", "SketchPolicy"]
