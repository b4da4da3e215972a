"""Public-API snapshot of the port: the exported ``repro_torch.api`` names
and signatures against ``tests/torch_api_surface.txt`` (after JAX's
``tests/test_api_surface.py``), so an accidental change of the front door
fails loudly and an intended one shows up as a reviewed snapshot diff.

Regenerate after an intended change:

    PYTHONPATH=src REPRO_UPDATE_API_SNAPSHOT=1 python -m pytest \\
        tests/test_torch_api_surface.py
"""
import os

from test_api_surface import _describe_module

SNAPSHOT = os.path.join(os.path.dirname(__file__), "torch_api_surface.txt")


def describe_api() -> str:
    from repro_torch import api

    return "\n".join(["== repro_torch.api =="] + _describe_module(api)) + "\n"


def test_torch_api_surface_matches_snapshot():
    got = describe_api()
    if os.environ.get("REPRO_UPDATE_API_SNAPSHOT") == "1":
        with open(SNAPSHOT, "w") as f:
            f.write(got)
    assert os.path.exists(SNAPSHOT), ("missing tests/torch_api_surface.txt: generate it "
                                      "with REPRO_UPDATE_API_SNAPSHOT=1")
    with open(SNAPSHOT) as f:
        want = f.read()
    assert got == want, ("repro_torch.api surface changed. If intended, regenerate the "
                         "snapshot (REPRO_UPDATE_API_SNAPSHOT=1) and review the diff.\n"
                         "--- snapshot ---\n" + want + "\n--- current ---\n" + got)


def test_torch_api_exports_the_jax_spine_and_registry():
    """JAX's ``repro.api`` exports the site spine's types and the estimator
    registry (``src/repro/api/__init__.py:53-55``); so does the port's."""
    from repro import api as japi
    from repro_torch import api

    names = ("ExecutionPlan", "SiteSpec", "resolve_site", "Estimator", "EstimatorVJP",
             "get_estimator", "register_estimator", "registered_backends")
    for name in names:
        assert name in japi.__all__ and name in api.__all__, name
