"""The port's dry run (``repro_torch.launch.dryrun``) on smoke configs over
fake process groups of 4 and 8 ranks.

Each fake group lives in a subprocess (``python tests/test_torch_dryrun.py
<scenario>``), so no default process group leaks into a pytest worker; the
subprocesses import no JAX. They run once per module (one fixture) and the
tests read their JSON:

* the parameter and optimizer shards per rank against the shard shapes of
  JAX's ``param_shardings`` on its 8 CPU devices, leaf for leaf;
* the fake step's FLOPs, payload and wire bytes against the same step on
  real tensors over the same fake group;
* the depth model's prediction against a full-depth run: FLOPs, bytes and
  payload exactly, the peak within ``PEAK_RTOL``;
* prefill and decode cells, a refused cell recorded with the port's
  ``NotImplementedError``, the record's keys against JAX's;
* the kernels' fake branch both ways, and the gather a fake weight lost
  before ``core/site.py``'s ``_GatherParam`` decided from the mesh.
"""
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

# the depth model's peak-memory prediction against the full-depth run:
# parameters, moments, gradients and each layer's kept input grow linearly
# with depth, but where in the backward the peak falls, and which transient
# tensors are live there, shifts a little with depth; on the smoke configs
# (tensors of kilobytes, each rounded to the allocator's 512-byte block) the
# prediction is off by up to 2%, and 5% bounds it
PEAK_RTOL = 0.05

# JAX's record keys (repro/launch/dryrun.py run_cell) that have no
# counterpart in the port (the module docstring says why)
NO_COUNTERPART = {"rolled_cost"}
JAX_KEYS = {"arch", "cell", "mesh", "chips", "kind", "policy", "status", "sp", "compile_s",
            "memory", "rolled_cost", "rolled_collectives", "cost_points", "cost_full_depth",
            "roofline", "model_flops", "n_params", "n_active_params", "model_flops_ratio",
            "cost_attribution", "coverage"}


def _run(scenario: str) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, os.path.abspath(__file__), scenario], env=env,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"scenario {scenario} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def results():
    return _run("all")


# -- the scenarios (run in the subprocess) -------------------------------------


def _smoke(arch, **kw):
    from repro_torch.configs.registry import smoke_config

    cfg = smoke_config(arch)
    return cfg.replace(**kw) if kw else cfg


def _cell(kind, S=32, B=8):
    from repro_torch.configs.base import ShapeCell

    return ShapeCell(f"{kind}_t", S, B, kind)


def _by_path(tree, path=()):
    import torch

    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _by_path(sub, path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _by_path(sub, path + (i,)).items()}
    return {"/".join(map(str, path)): list(tree.shape)} if isinstance(tree, torch.Tensor) else {}


def _shards(arch, shape):
    """Parameter and moment shard shapes of rank 0 under ``init_state`` on a
    fake group, fake tensors."""
    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.launch import dryrun, input_specs
    from repro_torch.launch import mesh as meshlib
    from repro_torch.optim import adamw, constant

    cfg = _smoke(arch)
    with dryrun.fake_group(shape[0] * shape[1]):
        mesh = meshlib.make_mesh(shape, ("data", "model"), device="cpu")
        mode = input_specs.fake_mode()
        rt = Runtime(device="cpu", execution=ExecutionConfig(mesh=mesh))
        with mode:
            st = rt.init_state(0, cfg, adamw(constant(1e-3)),
                               params=input_specs.params_struct(cfg, mode=mode, device="cpu"))
        return {"params": _by_path(st.params),
                "opt": {k: _by_path(v) for k, v in st.opt_state.items()}}


def _fake_vs_real(arch, shape, policy):
    """One train step's counts on fake tensors and on real CPU tensors over
    the same fake group."""
    import torch

    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import dryrun, input_specs
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import lm

    cfg, cell = _smoke(arch), _cell("train")
    out = {}
    with dryrun.fake_group(shape[0] * shape[1]):
        mesh = meshlib.make_mesh(shape, ("data", "model"), device="cpu")
        for sp in (False, True):
            ent = dryrun._POLICIES[policy]
            fake, _, _ = dryrun._run(cfg, cell, mesh, ent, sp, 1, "cpu")
            rt = dryrun._runtime(mesh, ent, batch_div=True, seq_len=cell.seq_len, sp=sp,
                                 accum=1, device="cpu")
            from repro_torch.optim import adamw, cosine_warmup

            opt = adamw(cosine_warmup(3e-4, 2000, 100_000), weight_decay=0.1, clip=1.0)
            st = rt.init_state(0, cfg, opt, params=lm.init_params(0, cfg, device="cpu"))
            g = torch.Generator().manual_seed(0)
            batch = {"labels": torch.randint(0, cfg.vocab, (8, 32), generator=g,
                                             dtype=torch.int32),
                     "tokens": torch.randint(0, cfg.vocab, (8, 32), generator=g,
                                             dtype=torch.int32)}
            batch = shard_batch(batch, mesh=mesh)
            step = rt.train_step(cfg, opt)
            _, real = dryrun.count_run(lambda: step(st, batch, 0), (st.params, batch))
            keep = ("flops", "flops_aten", "payload", "coll_bytes", "bytes")
            out["sp" if sp else "fixed"] = {"fake": {k: fake[k] for k in keep},
                                            "real": {k: real[k] for k in keep}}
            # FlopCounterMode itself on one more real step
            from torch.utils.flop_counter import FlopCounterMode

            st = rt.init_state(0, cfg, opt, params=lm.init_params(0, cfg, device="cpu"))
            with FlopCounterMode(display=False) as fc:
                step(st, batch, 0)
            out["sp" if sp else "fixed"]["flop_counter_mode"] = fc.get_total_flops()
    return out


def _record(arch, shape, kind, policy="mask", **kw):
    from repro_torch.launch import dryrun

    cfg = kw.pop("cfg", None) or _smoke(arch)
    return dryrun.record_or_error(arch, _cell(kind).name, cfg=cfg, cell=_cell(kind),
                                  mesh_shape=shape, policy_name=policy, **kw)


def _fake_gather():
    """``core.site.gather_param`` of a weight sharded over both axes of a
    (2, 2) fake group, on a fake tensor: the whole weight."""
    import torch

    from repro_torch.core.site import gather_param
    from repro_torch.launch import dryrun, input_specs, sharding
    from repro_torch.launch import mesh as meshlib

    with dryrun.fake_group(4):
        mesh = meshlib.make_mesh((2, 2), ("data", "model"), device="cpu")
        mode = input_specs.fake_mode()
        with mode:
            w = sharding.shard_tensor(torch.empty(64, 32), ("model", ("data",)), mesh)
            full = gather_param(w, mesh, ("data",))
        return {"shard": list(w.shape), "gathered": list(full.shape)}


def _kernels():
    """The kernels' fake branch, and a real CPU tensor's plain version."""
    import torch

    from repro_torch.kernels import ops, sketch_matmul
    from repro_torch.launch import input_specs

    def boom(*a, **k):
        raise AssertionError("a fake tensor reached the kernel's launch")

    sketch_matmul.block_gather_matmul_fused = boom
    ops.reset_launch_counts()
    ops.reset_fake_costs()
    mode = input_specs.fake_mode()
    N, n, d, block = 64, 32, 16, 8
    with mode:
        G, W, X = torch.empty(N, n), torch.empty(n, d), torch.empty(N, d)
        idx, sc = torch.zeros(2, dtype=torch.int32), torch.ones(2)
        s = ops.col_l1_scores(G)
        outs = ops.block_gather_matmul_fused(G, idx, sc, W, X, block=block, with_scores=True)
        q = torch.empty(2, 16, 4, 8)
        kv = torch.empty(2, 16, 2, 8)
        o = ops.flash_attention(q, kv, kv, causal=True)
    costs = ops.fake_costs()
    fake = {"shapes": [list(t.shape) for t in (s, *outs, o)],
            "dtypes": [str(t.dtype) for t in (s, *outs, o)],
            "launches": costs.pop("launches"), "costs": costs,
            "real_launches": ops.launch_counts()}
    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    Gr = torch.randn(N, n, generator=g)
    plain = ops.col_l1_scores(Gr)
    return {"fake": fake, "real_launches": ops.launch_counts(),
            "real_equal": bool(torch.equal(plain, Gr.abs().sum(0))),
            "attended": ops.attended_pairs(16, 16, True, None)}


def _remat_peaks():
    """The fake tracker's peak of one exact step at remat full and none."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib

    out = {}
    with dryrun.fake_group(1):
        mesh = meshlib.make_mesh((1, 1), ("data", "model"), device="cpu")
        for remat in ("none", "full", "dots"):
            c, _, _ = dryrun._run(_smoke("yi_6b", n_layers=2, remat=remat), _cell("train"),
                                  mesh, dryrun._POLICIES["mask"], False, 1, "cpu")
            out[remat] = {k: c[k] for k in ("peak_bytes", "flops", "payload")}
    return out


def _sp_one_rank():
    """On a real one-rank gloo group: the sequence-parallel mesh step and
    the single-device step, bit for bit (every mover is the identity)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding
    from repro_torch.models import lm
    from repro_torch.optim import sgd
    from repro_torch.tree import tree_leaves, tree_map

    out = {}
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=0, world_size=1)
        try:
            mesh = meshlib.make_mesh((1, 1), ("data", "model"), device="cpu")
            for arch in ("yi_6b", "olmoe_1b_7b", "seamless_m4t_large_v2", "zamba2_7b"):
                cfg = _smoke(arch)
                g = torch.Generator().manual_seed(0)
                batch = {"labels": torch.randint(0, cfg.vocab, (2, 16), generator=g)}
                batch["tokens"] = torch.randint(0, cfg.vocab, (2, 16), generator=g)
                if cfg.is_encdec:
                    batch["src_embeds"] = torch.randn(2, 16, cfg.d_model, generator=g)
                params = lm.init_params(0, cfg, device="cpu")
                res = []
                for ex, b in ((None, batch), (ExecutionConfig(
                        mesh=mesh, act_sharding=(("data",), "model", None)),
                        shard_batch(batch, mesh=mesh))):
                    rt = Runtime(policy=dryrun._POLICIES["mask"][0], device="cpu",
                                 execution=ex or ExecutionConfig())
                    opt = sgd(0.1)
                    st = rt.init_state(0, cfg, opt, params=tree_map(
                        lambda t: t.detach().clone(), params))
                    st, m = rt.train_step(cfg, opt)(st, b, 3)
                    leaves = tree_leaves(st.params if ex is None
                                         else sharding.gather_tree(st.params, mesh))
                    res.append((m["loss"], leaves))
                out[arch] = bool(torch.equal(res[0][0], res[1][0]) and all(
                    torch.equal(x, y) for x, y in zip(res[0][1], res[1][1])))
        finally:
            dist.destroy_process_group()
    return out


def _all() -> dict:
    import torch

    torch.set_num_threads(1)
    res = {"shards": {"2x2": _shards("yi_6b", (2, 2)), "2x4": _shards("olmoe_1b_7b", (2, 4)),
                      "1x4": _shards("yi_6b", (1, 4))},
           "fake_vs_real": {"yi_2x2_mask": _fake_vs_real("yi_6b", (2, 2), "mask"),
                            "yi_1x4_exact": _fake_vs_real("yi_6b", (1, 4), "exact")},
           "gather": _fake_gather(), "kernels": _kernels(), "remat": _remat_peaks(),
           "sp_one_rank": _sp_one_rank()}
    recs = {
        "train_depth_yi": _record("yi_6b", (2, 2), "train", cfg=_smoke("yi_6b", n_layers=4),
                                  coverage=False),
        # a period of 2 (one local, one global layer): the three-point model
        "train_depth_gemma": _record("gemma3_1b", (1, 4), "train", coverage=False,
                                     cfg=_smoke("gemma3_1b", n_layers=5, local_global=1)),
        "train_olmoe_2x4": _record("olmoe_1b_7b", (2, 4), "train"),
        "train_seamless": _record("seamless_m4t_large_v2", (2, 2), "train", coverage=False),
        "prefill_zamba": _record("zamba2_7b", (2, 2), "prefill", skip_cost=True),
        "decode_seamless": _record("seamless_m4t_large_v2", (2, 2), "decode"),
        "decode_rwkv": _record("rwkv6_3b", (1, 4), "decode", skip_cost=True),
        "refused": _record("yi_6b", (1, 4), "train", policy="compact", skip_cost=True),
    }
    res["records"] = recs
    return res


if __name__ == "__main__":
    import warnings

    warnings.filterwarnings("ignore")
    print(json.dumps({"all": _all}[sys.argv[1]](), default=str))
    sys.exit(0)


# -- the tests -----------------------------------------------------------------


@pytest.mark.parametrize("shape,arch", [("2x2", "yi_6b"), ("2x4", "olmoe_1b_7b"),
                                        ("1x4", "yi_6b")])
def test_state_shards_equal_jax_param_shardings(results, shape, arch):
    """Every parameter and moment shard of rank 0 has the shape JAX's
    ``param_shardings`` gives the leaf on its 8 CPU devices (the port's
    per-layer paths mapped onto JAX's stacked ones)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs.registry import smoke_config as jax_smoke
    from repro.launch import input_specs as jspec
    from repro.launch import sharding as jshard
    from repro_torch.configs.registry import smoke_config
    from repro_torch.interop import _unstack
    from repro_torch.tree import tree_map

    dims = tuple(int(x) for x in shape.split("x"))
    mesh = Mesh(np.array(jax.devices()[:dims[0] * dims[1]]).reshape(dims), ("data", "model"))
    tree = jspec.params_struct(jax_smoke(arch))
    specs = jshard.param_shardings(tree, mesh)

    class Shard:
        def __init__(self, shape):
            self.shape = shape

    def shard_of(s, ns):
        return np.lib.stride_tricks.as_strided(
            np.zeros((), np.float32), shape=ns.shard_shape(s.shape),
            strides=(0,) * len(s.shape))

    local = jax.tree_util.tree_map(shard_of, tree, specs)
    cfg = smoke_config(arch)
    port = {"embed": Shard(local["embed"].shape),
            "final_norm": tree_map(lambda a: Shard(a.shape), local["final_norm"]),
            "layers": _unstack(local["segments"], cfg, lambda a: Shard(a.shape))}
    if "lm_head" in local:
        port["lm_head"] = tree_map(lambda a: Shard(a.shape), local["lm_head"])
    want = {}

    def walk(n, p):
        if isinstance(n, dict):
            for k, v in n.items():
                walk(v, p + (k,))
        elif isinstance(n, list):
            for i, v in enumerate(n):
                walk(v, p + (i,))
        else:
            want["/".join(map(str, p))] = list(n.shape)

    walk(port, ())
    got = results["shards"][shape]
    assert got["params"] == want
    for moments in got["opt"].values():
        assert set(moments) <= set(want)
        assert all(moments[k] == want[k] for k in moments)


@pytest.mark.parametrize("case", ["yi_2x2_mask", "yi_1x4_exact"])
@pytest.mark.parametrize("layout", ["fixed", "sp"])
def test_fake_counts_equal_real_counts(results, case, layout):
    """FLOPs (FlopCounterMode and in all), payload, wire and bytes accessed
    of the fake step equal those of the same step on real CPU tensors over
    the same fake group."""
    r = results["fake_vs_real"][case][layout]
    assert r["fake"] == r["real"]
    assert r["fake"]["flops"] > 0 and r["fake"]["payload"] > 0
    assert r["fake"]["flops_aten"] == r["flop_counter_mode"]


@pytest.mark.parametrize("name", ["train_depth_yi", "train_depth_gemma"])
def test_depth_model_equals_full_depth(results, name):
    rec = results["records"][name]
    assert rec["status"] == "ok", rec.get("error")
    chk = rec["depth_check"]
    for k in ("flops", "bytes", "payload"):
        assert chk[k]["exact"], (k, chk[k])
    assert chk["coll_bytes"]["rel_err"] <= 1e-12
    assert chk["peak_bytes"]["rel_err"] <= PEAK_RTOL


def test_prefill_and_decode_cells_run(results):
    for name in ("prefill_zamba", "decode_seamless", "decode_rwkv"):
        rec = results["records"][name]
        assert rec["status"] == "ok", rec.get("error")
        assert rec["memory"]["peak_GB_per_dev"] > 0
        assert rec["cost_measured"]["flops"] > 0 and rec["policy"] == "n/a"
    assert "roofline" in results["records"]["decode_seamless"]
    assert results["records"]["prefill_zamba"]["sp"] is True


def test_refused_cell_is_recorded(results):
    """The ``compact`` policy on local plans with a model axis of 4: the
    port's own NotImplementedError, naming the ROADMAP item."""
    rec = results["records"]["refused"]
    assert rec["status"] == "error"
    assert rec["error"].startswith("NotImplementedError") and "Queue 1 item 2b" in rec["error"]


def test_record_has_jax_keys(results):
    rec = results["records"]["train_olmoe_2x4"]
    assert rec["status"] == "ok", rec.get("error")
    assert JAX_KEYS - NO_COUNTERPART <= set(rec)
    assert not NO_COUNTERPART & set(rec)
    assert rec["n_active_params"] < rec["n_params"]
    assert rec["coverage"].get("baseline_ok") is True, rec["coverage"]
    assert rec["memory"]["fits_hbm"] is True and rec["roofline"]["dominant"] in (
        "compute", "memory", "collective")


def test_encoder_decoder_record_attributes_encoder_sites(results):
    """The cost attribution keys the encoder's sites by JAX's
    ``encoder/segments`` paths, the decoder's by ``segments``."""
    rec = results["records"]["train_seamless"]
    assert rec["status"] == "ok", rec.get("error")
    keys = set(rec["cost_attribution"]["sites"])
    assert any(k.startswith("encoder/segments/0/0/") for k in keys)
    assert any(k.startswith("segments/0/0/cross/") for k in keys)


def test_fake_weight_is_gathered(results):
    """Before the gather decided from the mesh, a fake shard came back as
    itself (its data pointer, 0, equalled the gathered tensor's)."""
    assert results["gather"] == {"shard": [32, 16], "gathered": [64, 32]}


def test_kernels_fake_branch_and_plain_version(results):
    k = results["kernels"]
    f = k["fake"]
    assert f["shapes"] == [[32], [64, 16], [2, 8, 16], [2, 8], [2, 8], [2, 16, 4, 8]]
    assert f["dtypes"][0] == "torch.float32"
    assert f["launches"]["col_l1_scores"] == 1
    assert f["launches"]["block_gather_matmul_fused"] == 1
    assert f["launches"]["flash_attention"] == 1
    # the fake branch counts its own calls: the real launch counts stay 0
    assert not any(f["real_launches"].values()), f["real_launches"]
    N, n, d, kept = 64, 32, 16, 16
    flash_ops = 4 * 8 * 2 * 4 * k["attended"]
    assert f["costs"]["flops"] == 2 * N * n + 4 * N * kept * d + 4 * N * kept + flash_ops
    # a real CPU tensor: the plain version, no launch
    assert k["real_launches"]["col_l1_scores"] == 0 and k["real_equal"]
    assert k["attended"] == 16 * 17 // 2


def test_remat_full_keeps_less_than_none(results):
    r = results["remat"]
    assert r["full"]["peak_bytes"] < r["dots"]["peak_bytes"] <= r["none"]["peak_bytes"]
    assert r["full"]["flops"] > r["none"]["flops"]  # the recomputed forward
    assert r["full"]["payload"] >= r["none"]["payload"]


def test_sequence_parallel_one_rank_mesh_is_bit_for_bit(results):
    """On a one-rank mesh the sequence-parallel step is the single-device
    step bit for bit (the dense decoder, an MoE, the encoder-decoder, the
    hybrid)."""
    assert results["sp_one_rank"] == {a: True for a in ("yi_6b", "olmoe_1b_7b",
                                                         "seamless_m4t_large_v2", "zamba2_7b")}
