"""The port's sketch-coverage analyzer and baseline gate
(`repro_torch.analysis.coverage`), on the CPU at smoke size.

JAX's own analyzer cannot be the reference here: on this box's jax 0.9 its
``_Graph`` reads the removed ``jax.core.Literal``, and with that patched it
calls every smoke site ``no_matmul`` (ROADMAP). So the port is held to the
expectations JAX's ``tests/test_coverage.py`` writes down, to JAX's
``baseline.json`` waivers (the port's copy), to JAX's ``role_hint`` on the
same paths, and to mutations:

1. **Known escapes are found, costed, and waived**: the MoE router and the
   RWKV decay LoRA are the dense matmuls off the spine; the expert and SSM
   projections are sketched at runtime but invisible to
   ``resolve_tree_site``. The port keeps one weight per layer where JAX
   stacks them, so its counts are JAX's per layer.
2. **Dense configs are fully covered**: every weight matmul resolves, the
   head is ``exact``, the gate is green with no waiver used.
3. **A fresh escape fails the gate** naming the offending file and site: a
   matmul written in this file, and the mlp ``in`` site rerouted around
   ``nn/common.dense``.
4. **The analysis is read-only**: training is bit for bit the same with and
   without it between steps; no generator advances, no ``.grad`` or
   ``requires_grad`` changes.
"""
import jax
import numpy as np
import pytest
import torch

from repro import compat
from repro.analysis.coverage import role_hint as jax_role_hint
from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import lm as jax_lm
from repro_torch.analysis import (analyze_loss, analyze_runtime, check_baseline,
                                  load_baseline, role_hint)
from repro_torch.api import ExecutionConfig, Runtime, SketchConfig, SketchPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCH_IDS, smoke_config
from repro_torch.data.synthetic import LMStream
from repro_torch.optim import sgd
from repro_torch.tree import tree_leaves

THIS_FILE = "test_torch_coverage.py"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runtime():
    """JAX's test policy: l1 at budget 0.4, the compact backend, block 4."""
    pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.4, backend="compact", block=4))
    return Runtime(policy=pol, execution=ExecutionConfig(), device="cpu")


def _analyze(name):
    return analyze_runtime(_runtime(), smoke_config(name), device="cpu")


def test_moe_escapes_reported_and_waived():
    cfg = smoke_config("olmoe_1b_7b")
    rep = _analyze("olmoe_1b_7b")
    cats = rep.by_category()
    escaped = {s.param: s for s in cats.get("escaped", [])}
    assert set(escaped) == {f"layers/{i}/moe/router/w" for i in range(cfg.n_layers)}
    for router in escaped.values():
        assert router.flops > 0
        assert [p.replace("\\", "/").rsplit(":", 1)[0].endswith("repro_torch/nn/moe.py")
                for p in router.provenance] == [True]
    unresolved = [s.param.rsplit("/", 1)[-1] for s in cats.get("unresolved", [])]
    assert set(unresolved) == {"wi", "wg", "wo"} and len(unresolved) == 3 * cfg.n_layers
    # the attention projections DO resolve even in the MoE family
    assert any(s.param.endswith("attn/q/w") for s in cats.get("resolved", []))
    assert 0 < rep.escaped_flop_frac < 0.05
    br = check_baseline(rep)
    assert br.ok, br.message()
    assert not br.unwaived
    assert {"moe-router-dense", "moe-expert-unresolved"} <= set(br.used)
    # every expert of every layer is one sketched application of its site
    assert rep.applications == cfg.n_layers * (4 + 3 * cfg.n_experts)


def test_ssm_escapes_reported_and_waived():
    cfg = smoke_config("rwkv6_3b")
    rep = _analyze("rwkv6_3b")
    cats = rep.by_category()
    escaped = {s.param.rsplit("/", 2)[-2] for s in cats.get("escaped", [])}
    assert escaped == {"w1", "w2"}
    for s in cats["escaped"]:
        assert s.flops > 0
        assert any("repro_torch/nn/ssm.py" in p.replace("\\", "/") for p in s.provenance)
    # r/k/v/g/out + cm_k/cm_v/cm_r in every layer
    unresolved = [s.param.split("/")[-2] for s in cats.get("unresolved", [])]
    assert sorted(set(unresolved)) == ["cm_k", "cm_r", "cm_v", "g", "k", "out", "r", "v"]
    assert len(unresolved) == 8 * cfg.n_layers
    # the fused w1/w2 pair shares one provenance line — counted once
    assert rep.escaped_flops == max(s.flops for s in cats["escaped"])
    assert len({p for s in cats["escaped"] for p in s.provenance}) == 1
    br = check_baseline(rep)
    assert br.ok, br.message()
    assert {"rwkv-decay-lora-dense", "rwkv-projection-unresolved"} <= set(br.used)


def test_dense_arch_fully_covered():
    cfg = smoke_config("llama3_405b")
    rep = _analyze("llama3_405b")
    cats = rep.by_category()
    assert not rep.escapes()
    assert rep.escaped_flops == 0 and rep.unresolved_flops == 0
    # q/k/v/o + mlp in/gate/out in every layer
    assert len(cats["resolved"]) == 7 * cfg.n_layers
    assert {s.param.split("/", 2)[-1] for s in cats["resolved"]} == {
        "attn/q/w", "attn/k/w", "attn/v/w", "attn/o/w", "mlp/in/w", "mlp/gate/w", "mlp/out/w"}
    for s in cats["resolved"]:
        assert s.flops > 0 and s.detail.startswith("plan=")
        assert s.applications == 1
    # the head runs core/site.py's exact matmul: on the spine, policy-excluded
    head = [s for s in rep.sites if s.param == "lm_head/w"]
    assert [(s.category, s.role, s.applications) for s in head] == [("exact", "lm_head", 0)]
    assert any("repro_torch/core/site.py" in p.replace("\\", "/") for p in head[0].provenance)
    br = check_baseline(rep)
    assert br.ok and not br.used


def test_zamba_shared_block_is_exact_and_applied_twice():
    """The multi-use ``shared`` subtree is ``exact`` (slot-free) as in JAX,
    but its sites run sketched once per application: 7 Mamba layers x 3
    projections + 7 shared sites x 2 applications."""
    rep = _analyze("zamba2_7b")
    shared = [s for s in rep.sites if s.param.startswith("shared/")]
    assert len(shared) == 7
    assert {(s.category, s.applications) for s in shared} == {("exact", 2)}
    assert rep.applications == 7 * 3 + 7 * 2
    br = check_baseline(rep)
    assert br.ok, br.message()
    assert br.used == ["mamba-projection-unresolved"]


@pytest.mark.parametrize("name", ARCH_IDS)
def test_every_smoke_config_passes_the_gate(name):
    """Every named config's smoke version: the gate is green, every sketched
    application sits on a resolved or unresolved leaf (or the shared block's
    exact one), and only the MoE and SSM families use waivers."""
    rep = _analyze(name)
    br = check_baseline(rep)
    assert br.ok, br.message()
    for s in rep.sites:
        if s.applications:
            assert s.category in ("resolved", "unresolved") or (
                s.category == "exact" and s.param.startswith("shared/")), s
    cfg = smoke_config(name)
    assert bool(br.used) == (cfg.n_experts > 0 or cfg.block_kind in ("rwkv", "zamba"))


def test_fresh_unwaived_escape_fails_gate():
    """Inject a dense matmul off the spine: the gate must go red and the
    report must name this file as the provenance."""
    d, vocab, T = 16, 32, 8
    g = torch.Generator().manual_seed(0)
    params = {"w_rogue": torch.randn(d, d, generator=g),
              "head": torch.randn(vocab, d, generator=g)}
    x = torch.randn(2, T, d, generator=g)

    def loss(p, xx):
        h = xx @ p["w_rogue"].t()  # the escape under test
        return (h @ p["head"].t()).sum() / T

    rep = analyze_loss(loss, params, x)
    escaped = {s.param: s for s in rep.by_category().get("escaped", [])}
    assert set(escaped) == {"w_rogue", "head"}
    assert escaped["w_rogue"].flops > 0
    assert all(p.rsplit(":", 1)[0].endswith(THIS_FILE) for p in escaped["w_rogue"].provenance)
    br = check_baseline(rep)
    assert not br.ok
    assert any(s.param == "w_rogue" for s in br.unwaived)
    assert "w_rogue" in br.message() and "escaped" in br.message()
    assert THIS_FILE in br.message()


def test_mlp_site_rerouted_around_dense_fails_gate(monkeypatch):
    """A model whose mlp ``in`` site bypasses ``nn/common.dense`` (a raw
    matmul here): that weight reads ``escaped`` with this file as
    provenance, and the gate names it."""
    import repro_torch.nn.mlp as mlp_mod

    dense = mlp_mod.dense

    def rerouted(params, x, ctx, role):
        if role == "mlp_in":
            return x @ params["w"].t()  # off the spine
        return dense(params, x, ctx, role)

    monkeypatch.setattr(mlp_mod, "dense", rerouted)
    cfg = smoke_config("llama3_405b")
    rep = _analyze("llama3_405b")
    escaped = {s.param: s for s in rep.by_category().get("escaped", [])}
    assert set(escaped) == {f"layers/{i}/mlp/in/w" for i in range(cfg.n_layers)}
    for s in escaped.values():
        assert all(p.rsplit(":", 1)[0].endswith(THIS_FILE) for p in s.provenance)
    br = check_baseline(rep)
    assert not br.ok
    assert {s.param for s in br.unwaived} == set(escaped)
    assert "layers/0/mlp/in/w [escaped]" in br.message() and THIS_FILE in br.message()
    assert rep.applications == 6 * cfg.n_layers  # the rerouted site is no application


def test_baseline_unused_waivers_are_reported_not_fatal():
    rep = _analyze("llama3_405b")
    br = check_baseline(rep, baseline=load_baseline())
    assert br.ok
    # every waiver is stale for a dense arch — reported, never fatal
    assert "moe-router-dense" in set(br.unused)


def test_baseline_keeps_jax_waivers():
    """The port's baseline: JAX's five waivers with the same ids, categories
    and param patterns, the provenance naming the port's files."""
    from repro.analysis.coverage import load_baseline as jax_load_baseline

    ours = {w["id"]: w for w in load_baseline()["waivers"]}
    theirs = {w["id"]: w for w in jax_load_baseline()["waivers"]}
    assert set(ours) == set(theirs)
    for wid, w in theirs.items():
        assert (ours[wid]["category"], ours[wid]["param"]) == (w["category"], w["param"])
        assert ours[wid]["provenance"] == w["provenance"]
        assert "ROADMAP" in ours[wid]["reason"]


ARCH = ArchConfig(name="cov-tiny", family="dense", n_layers=1, d_model=32, n_heads=4, n_kv=2,
                  d_ff=64, vocab=64, q_chunk=16, kv_chunk=16)


def test_analysis_is_read_only():
    """Train 2 steps; analyze; train 2 fresh steps — losses and params must
    be bit-identical with and without the analyzer in between."""
    def run(analyze):
        rt = _runtime()
        opt = sgd(0.1)
        state = rt.init_state(0, ARCH, opt)
        batch = next(iter(LMStream(vocab=ARCH.vocab, seed=0).batches(4, 16)))
        step = rt.train_step(ARCH, opt)
        losses = []
        for i in range(2):
            if analyze:
                rep = analyze_runtime(rt, ARCH, device="cpu")
                assert not rep.escapes()
            state, m = step(state, batch, i + 1)
            losses.append(float(m["loss"]))
        flat = torch.cat([p.detach().reshape(-1) for p in tree_leaves(state.params)])
        return np.asarray(losses, np.float32), flat

    base_losses, base_params = run(analyze=False)
    cov_losses, cov_params = run(analyze=True)
    np.testing.assert_array_equal(base_losses, cov_losses)
    assert torch.equal(base_params, cov_params)


def test_analysis_touches_no_grad_flag_or_generator():
    """On the caller's own parameters: every ``.grad`` and ``requires_grad``
    as it was, every value unchanged, the global generator not advanced."""
    from repro_torch.models import lm

    rt = _runtime()
    params = lm.init_params(0, ARCH, device="cpu")
    leaves = tree_leaves(params)
    before = [p.clone() for p in leaves]
    leaves[0].requires_grad_(True)
    leaves[0].grad = torch.full_like(leaves[0], 3.0)
    rng_state = torch.random.get_rng_state()
    rep = analyze_runtime(rt, ARCH, device="cpu", params=params)
    assert rep.applications == 7
    assert torch.equal(torch.random.get_rng_state(), rng_state)
    assert [p.requires_grad for p in leaves] == [True] + [False] * (len(leaves) - 1)
    assert torch.equal(leaves[0].grad, torch.full_like(leaves[0], 3.0))
    assert all(p.grad is None for p in leaves[1:])
    assert all(torch.equal(a, b) for a, b in zip(leaves, before))


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_role_hint_matches_jax_on_every_smoke_leaf(arch):
    """The port's role_hint is JAX's on every leaf path of each named
    config's smoke parameters (JAX's stacked tree, ``jax.eval_shape``)."""
    cfg = jax_smoke_config(arch)
    shapes = jax.eval_shape(lambda k: jax_lm.init_params(k, cfg), compat.prng_key(0))
    paths = [tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)
             for path, _ in compat.tree_flatten_with_path(shapes)[0]]
    assert len(paths) > 5
    hints = [role_hint(p) for p in paths]
    assert hints == [jax_role_hint(p) for p in paths]
    assert any(h is not None for h in hints)


def test_g_reader_ceilings_are_jax_s():
    from repro.analysis.invariants import G_READER_CEILINGS as JAX_CEILINGS
    from repro_torch.analysis import G_READER_CEILINGS, g_reader_ceiling

    assert G_READER_CEILINGS == JAX_CEILINGS
    assert g_reader_ceiling("stale") == 1 and g_reader_ceiling("third-party") == 2
