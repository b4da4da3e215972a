"""Shared harness of the port's benchmarks (port of the parts of
``benchmarks/common.py`` they use): the sketch policy of the paper's
figures, and the results file under ``results/torch/``."""
from __future__ import annotations

import json
import os

from repro_torch.api import SketchConfig, SketchPolicy

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "results", "torch")


def save_result(name: str, payload: dict) -> str:
    """Write ``payload`` to ``results/torch/<name>.json``; returns the path."""
    os.makedirs(RESULTS, exist_ok=True)
    path = os.path.join(RESULTS, name + ".json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=float)
    return path


def make_policy(method: str, budget: float) -> SketchPolicy:
    """``method`` at ``budget`` on every site but the classifier head."""
    return SketchPolicy(base=SketchConfig(method=method, budget=budget),
                        exclude_roles=("lm_head",))
