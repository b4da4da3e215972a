"""The pipeline stage boundary (``launch/pipeline.py``): JAX's four
``tests/test_pipeline.py`` tests on the port, and the wire accounting
against JAX's numbers."""
import numpy as np
import pytest
import torch

from repro_torch.core.sketching import SketchConfig
from repro_torch.launch.pipeline import boundary_wire_bytes, stage_boundary


def _loss(x, key, cfg):
    h = stage_boundary(torch.tanh(x @ torch.ones(8, 12) / 8), key=key, cfg=cfg)
    return torch.sin(h).sum()


def _x(rows):
    return torch.as_tensor(np.random.RandomState(0).standard_normal((rows, 8)).astype(np.float32))


def test_forward_identity():
    x = _x(4)
    y = stage_boundary(x, key=1, cfg=SketchConfig(method="l1", budget=0.3))
    assert torch.equal(y, x)


def test_backward_unbiased():
    """1,500 seeds: the mean t-statistic of the sketched cotangent's mean
    against the exact gradient below 2.2 (JAX's threshold)."""
    x = _x(6).requires_grad_(True)
    cfg = SketchConfig(method="l1", budget=0.5)
    exact = torch.autograd.grad(_loss(x, None, None), x)[0].numpy()
    gs = np.stack([torch.autograd.grad(_loss(x, k, cfg), x)[0].numpy() for k in range(1500)])
    se = gs.std(0) / np.sqrt(len(gs)) + 1e-3 * np.abs(exact).max()
    t = np.abs(gs.mean(0) - exact) / se
    assert np.mean(t) < 2.2, np.mean(t)


def test_budget_one_is_exact():
    x = _x(6).requires_grad_(True)
    g0 = torch.autograd.grad(_loss(x, None, None), x)[0]
    g1 = torch.autograd.grad(_loss(x, 5, SketchConfig(method="l1", budget=1.0)), x)[0]
    np.testing.assert_allclose(g0.numpy(), g1.numpy(), rtol=1e-6)


def test_wire_accounting():
    cfg = SketchConfig(method="l1", budget=0.1, block=128)
    out = boundary_wire_bytes(cfg, (16, 4096, 8192))
    assert 0.08 < out["ratio"] < 0.15  # about budget + index overhead
    assert out["dense_bytes"] / 1e9 > 1.0  # a real inter-stage tensor


@pytest.mark.parametrize("kw,shape", [
    (dict(method="l1", budget=0.1, block=128), (16, 4096, 8192)),
    (dict(method="l1", budget=0.25), (4, 128, 768)),
    (dict(method="l2", budget=0.5, block=64), (2, 256, 1024)),
    (dict(method="per_column", budget=0.3, round_to=8), (3, 5, 100)),
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wire_bytes_equal_jax(kw, shape, dtype):
    """Dense and compact bytes and their ratio equal JAX's
    ``boundary_wire_bytes`` exactly."""
    import jax.numpy as jnp

    from repro.core.sketching import SketchConfig as JConfig
    from repro.launch.pipeline import boundary_wire_bytes as jax_bytes

    want = jax_bytes(JConfig(**kw), shape, getattr(jnp, dtype))
    got = boundary_wire_bytes(SketchConfig(**kw), shape, getattr(torch, dtype))
    assert got == {k: (float(v) if k == "ratio" else int(v)) for k, v in want.items()}
