"""Layer remat (``ArchConfig.remat``, ``models/lm.py``): ``"full"``,
``"dots"`` and ``"none"`` give the same training, bit for bit, on one CPU
thread: the loss and every metric, the updated parameters, moments and plan
carry, the probes, and the kernels' launch counts, under every backend
(exact, ``mask``, ``pallas``, ``compact`` with compact gradients,
``onepass`` and ``stale``, with probes and the plan carry where the backend
has them). The recompute runs each layer's forward again, and each site's
backward once. The fake tracker's peaks (``test_torch_dryrun.py``) show
``"full"`` keeping less than ``"none"``."""
import pytest
import torch

from repro_torch.api import ExecutionConfig, Runtime, SketchConfig, SketchPolicy
from repro_torch.configs.registry import smoke_config
from repro_torch.kernels import ops
from repro_torch.optim import adamw, constant
from repro_torch.telemetry import TelemetryConfig
from repro_torch.tree import tree_leaves

REMATS = ("none", "full", "dots")


def _policy(backend):
    if backend == "exact":
        return None
    block = 4 if backend in ("pallas", "compact", "onepass", "stale") else 0
    return SketchPolicy(base=SketchConfig(method="l1", budget=0.3, backend=backend, block=block))


def _batch(cfg, B=2, S=16):
    g = torch.Generator().manual_seed(0)
    out = {"labels": torch.randint(0, cfg.vocab, (B, S), generator=g)}
    if cfg.frontend == "vision":
        out["embeds"] = torch.randn(B, S, cfg.d_model, generator=g)
    else:
        out["tokens"] = torch.randint(0, cfg.vocab, (B, S), generator=g)
    if cfg.is_encdec:
        out["src_embeds"] = torch.randn(B, S, cfg.d_model, generator=g)
    return out


def _train(arch, backend, remat, *, compact=False, probes=True, steps=2):
    torch.set_num_threads(1)
    cfg = smoke_config(arch).replace(remat=remat)
    ex = ExecutionConfig(compact_grads=compact,
                         telemetry=TelemetryConfig(probes=True) if probes else None)
    rt = Runtime(policy=_policy(backend), execution=ex, device="cpu")
    opt = adamw(constant(1e-3), lazy=compact)
    state = rt.init_state(0, cfg, opt)
    step = rt.train_step(cfg, opt)
    ops.reset_launch_counts()
    metrics = []
    batch = _batch(cfg)
    for k in range(steps):
        state, m = step(state, batch, 11 + k)
        metrics.append({n: v for n, v in m.items() if isinstance(v, torch.Tensor)})
    return (tree_leaves(state.params), tree_leaves(state.opt_state), metrics,
            ops.launch_counts())


def _same(a, b):
    pa, oa, ma, la = a
    pb, ob, mb, lb = b
    assert len(pa) == len(pb) and all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert len(oa) == len(ob) and all(torch.equal(x, y) for x, y in zip(oa, ob))
    for x, y in zip(ma, mb):
        assert x.keys() == y.keys()
        assert all(torch.equal(x[k], y[k]) for k in x), [k for k in x if not torch.equal(x[k],
                                                                                           y[k])]
    assert la == lb


@pytest.mark.parametrize("backend,compact", [("exact", False), ("mask", False),
                                             ("pallas", False), ("compact", True),
                                             ("pallas", True), ("onepass", False),
                                             ("stale", False)])
def test_remat_is_bit_for_bit(backend, compact):
    runs = {r: _train("yi_6b", backend, r, compact=compact) for r in REMATS}
    for r in ("full", "dots"):
        _same(runs["none"], runs[r])


@pytest.mark.parametrize("arch,backend", [("olmoe_1b_7b", "pallas"), ("zamba2_7b", "stale"),
                                          ("seamless_m4t_large_v2", "mask"),
                                          ("rwkv6_3b", "onepass")])
def test_remat_is_bit_for_bit_across_families(arch, backend):
    base = _train(arch, backend, "none", steps=1)
    _same(base, _train(arch, backend, "full", steps=1))


def test_remat_reruns_the_forward_once_per_layer(monkeypatch):
    """``"full"`` runs each layer's forward twice in a training step (the
    recompute), ``"none"`` once; serving never rematerialises."""
    from repro_torch.models import lm

    calls = []
    real = lm._layer
    monkeypatch.setattr(lm, "_layer", lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = smoke_config("yi_6b")
    for remat, want in (("none", 1), ("full", 2)):
        calls.clear()
        rt = Runtime(device="cpu")
        c = cfg.replace(remat=remat)
        opt = adamw(constant(1e-3))
        rt.train_step(c, opt)(rt.init_state(0, c, opt), _batch(c), 1)
        assert len(calls) == want * c.n_layers
    calls.clear()
    params = lm.init_params(0, cfg, device="cpu")
    lm.prefill(params, {"tokens": _batch(cfg)["tokens"]}, rt.ctx(), cfg.replace(remat="full"),
               32)
    assert len(calls) == cfg.n_layers


def test_unknown_remat_raises():
    cfg = smoke_config("yi_6b").replace(remat="everything")
    rt = Runtime(device="cpu")
    opt = adamw(constant(1e-3))
    with pytest.raises(ValueError, match="remat"):
        rt.train_step(cfg, opt)(rt.init_state(0, cfg, opt), _batch(cfg), 1)
