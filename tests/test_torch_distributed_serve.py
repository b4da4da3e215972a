"""Serving under a mesh, on CPU gloo ranks, against JAX's mesh Runtime and
the port's single device.

One module fixture spawns 4 ranks once through the gloo files' shared
harness (``test_torch_distributed_families.spawn_ranks``); every rank runs
on the meshes (2, 2) and (1, 4) ``("data", "model")``, and rank 0 saves what
they produced. The steps: ``Runtime(execution=ExecutionConfig(mesh=...))``'s
``prefill_step`` and three ``decode_step`` calls (one position per row,
rows at two different positions, a ring that wraps) on the smoke config of
every decoder family and the encoder-decoder, with ``tp_sketch`` off and
on; their logits (all-gathered over data) and caches (gathered) are held
here against JAX's mesh Runtime on 4 fake devices (``jax.devices()[:4]``)
on the same weights (``interop.params_from_jax``) and inputs: logits rtol
1e-4 / atol 1e-5, caches through ``interop.caches_from_jax`` at the same
tolerance. The engines: both port engines (paged, paged with 16 pages over
data, contiguous; run-to-completion) under the mesh against the port's
single-device engines, token for token on every rank; JAX's
``test_mesh_runtime_equivalence`` (continuous against legacy on the mesh
Runtime). Each rank's cache and pool leaves have the shapes
``cache_specs`` / ``paged_cache_specs`` give, and a decode step moves the
payload the shapes predict (:func:`decode_payload`).

"lm" is ``test_distributed``'s arch (4 heads, 2 kv): with ``tp_sketch`` on
(TP plans) or off (local plans split over model) its attention runs on local
heads on (2, 2); on (1, 4), where the 2 kv heads do not divide the model
axis, a decode step gathers every head.
"""
from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from test_torch_distributed_families import (finish, flat, gather_whole, init_group, jax_mesh,
                                             lead_rank, np32, progress, spawn_ranks)

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
ALONE_S = 40  # the rank group's time alone (spawning included; see SLOWDOWN)
B, S, MAX_LEN, S_ENC, STEPS = 4, 14, 24, 8, 3
CONFIGS = ("lm", "yi_6b", "gemma3_1b", "olmoe_1b_7b", "mixtral_8x22b", "rwkv6_3b",
           "zamba2_7b", "qwen2_vl_2b", "seamless_m4t_large_v2")
RTOL, ATOL = 1e-4, 1e-5
# zamba's logits: test_torch_ssm.py's DEEP_TOL. JAX takes each SSD decay as
# the difference of two cumulative sums, whose rounding the port's
# per-segment sums avoid (ROADMAP.md Queue 3 item 8): on one device as under
# a mesh, JAX's zamba logits near zero sit ~3e-5 from the port's; and the
# decays compound a last-bit difference through its 7 layer uids, so the TP
# plans' other summation order moves the port's own logits near zero by
# ~1e-5 from its single device's. Every other config: RTOL / ATOL.
DEEP_TOL = {"zamba2_7b": 5e-5}
# (config, mesh, tp_sketch, engine kinds) of the engine runs; the families'
# runs take the layout their caches allow (paged for olmoe, contiguous for
# rings and recurrent states) and rwkv6's the run-to-completion engine's
# unpadded path too
ENGINE_RUNS = (("serve", "2x2", False, ("paged", "paged16", "contig", "legacy")),
               ("serve", "1x4", False, ("paged", "legacy")),
               ("serve", "2x2", True, ("paged",)),
               ("serve", "1x4", True, ("paged",)),
               ("gemma3_1b", "2x2", False, ("contig",)),
               ("olmoe_1b_7b", "2x2", False, ("paged",)),
               ("rwkv6_3b", "2x2", False, ("contig", "legacy")),
               ("zamba2_7b", "1x4", False, ("contig",)),
               ("qwen2_vl_2b", "2x2", False, ("contig",)))


def _arch(pkg):
    """``test_distributed._arch()`` in ``pkg``'s ArchConfig."""
    if pkg == "jax":
        from repro.configs.base import ArchConfig
    else:
        from repro_torch.configs.base import ArchConfig
    return ArchConfig(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv=2,
                      d_ff=64, vocab=64, q_chunk=16, kv_chunk=16)


def _serve_cfg(pkg):
    """``tests/test_serve.py``'s CFG in ``pkg``'s ArchConfig."""
    if pkg == "jax":
        from repro.configs.base import ArchConfig
    else:
        from repro_torch.configs.base import ArchConfig
    return ArchConfig(name="serve-test", family="dense", n_layers=2, d_model=64, n_heads=4,
                      n_kv=2, d_ff=128, vocab=256, q_chunk=32, kv_chunk=32)


def config(name, pkg="torch"):
    if name == "lm":
        return _arch(pkg)
    if name == "serve":
        return _serve_cfg(pkg)
    if pkg == "jax":
        from repro.configs import registry
    else:
        from repro_torch.configs import registry
    return registry.smoke_config(name)


def serve_inputs(cfg, seed=0) -> dict:
    """The prefill batch (tokens, or the VLM's embeds and [3, B, S]
    positions whose streams differ; an encoder-decoder's source frames),
    the decode steps' inputs and their per-row positions (odd rows one
    behind), as numpy arrays."""
    rs = np.random.RandomState(seed)
    vision = cfg.frontend == "vision"
    if vision:
        batch = {"embeds": (rs.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)}
        t = np.arange(S)
        batch["positions"] = np.stack([np.broadcast_to(s, (B, S)) for s in (t, t // 4, t % 4)]
                                      ).astype(np.int32)
        steps = [(rs.standard_normal((B, 1, cfg.d_model)) * 0.5).astype(np.float32)
                 for _ in range(STEPS)]
    else:
        batch = {"tokens": rs.randint(0, cfg.vocab, (B, S)).astype(np.int32)}
        steps = [rs.randint(0, cfg.vocab, (B, 1)).astype(np.int32) for _ in range(STEPS)]
    if cfg.is_encdec:
        batch["src_embeds"] = (rs.standard_normal((B, S_ENC, cfg.d_model)) * 0.5
                               ).astype(np.float32)
    pos = [S + t - (np.arange(B) % 2) for t in range(STEPS)]
    return {"batch": batch, "steps": steps, "pos": [p.astype(np.int32) for p in pos]}


def decode_payload(cfg, mesh_shape) -> int:
    """The collective payload of one decode step of ``cfg`` (a dense
    decoder) at ``tp_sketch`` off on a (data, model) mesh, from the shapes.
    Each linear site computes on its model shard (``core.site.split_kind``:
    ``launch.sharding``'s rules cut q/k/v/mlp-in/gate and the head
    (model, data), o and mlp-out (data, model)) and all-gathers only its
    shard's FSDP dimension over data; the embedded rows are all-gathered
    over model; q, k and v are all-gathered over model onto every head (a
    decode step keeps q's heads with their kv heads); o's and mlp-out's
    partial outputs are all-reduced over model; where the cache's positions
    split over model each attention layer combines (``pmax`` of [rows,
    heads] and one ``psum`` of [rows, heads, d_head + 1]); the head's
    vocabulary chunks of the logits are all-gathered over model; float32."""
    D, M = mesh_shape
    d, dh, H, Kv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv
    rows = B // D if B % D == 0 else B
    gates = 2 if cfg.mlp_type in ("swiglu", "geglu") else 1
    shards = (2 * H * dh + 2 * Kv * dh + (gates + 1) * cfg.d_ff) * d // (M * D)
    heads = rows * (H + 2 * Kv) * dh // M
    combine = rows * H + rows * H * (dh + 1) if M > 1 and MAX_LEN % M == 0 else 0
    layer = shards + heads + 2 * rows * d + combine
    head = cfg.vocab * d // (M * D) + rows * cfg.vocab // M
    return 4 * (cfg.n_layers * layer + head + rows * d // M)


# ---------------------------------------------------------------------------
# The ranks' side
# ---------------------------------------------------------------------------


def _local_shapes_ok(tree, specs, mesh, global_tree) -> bool:
    """Whether every leaf of ``tree`` (this rank's shards) has the shape
    ``specs`` cut from its whole counterpart in ``global_tree``."""
    from repro_torch.launch.sharding import _walk, dim_axes

    spec_at = {}
    _walk(specs, lambda path, sp: spec_at.__setitem__("/" + "/".join(map(str, path)), sp))
    got, want = flat_shapes(tree), flat_shapes(global_tree)
    for path, shape in want.items():
        spec = spec_at[path] or (None,) * len(shape)
        if got.get(path) != tuple(n // mesh.axis_size(dim_axes(e)) for n, e in zip(shape, spec)):
            return False
    return len(got) == len(want)


def _rebuild(tree, whole: dict):
    """``tree``'s structure with each leaf replaced by its whole array from
    ``whole`` (:func:`gather_whole`'s paths), as a tensor."""
    def walk(t, path=""):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(t)]
        return torch.from_numpy(whole[path]).to(t.dtype)

    return walk(tree)


def flat_shapes(tree, path="") -> dict:
    """A tree's tensor leaves' shapes by path (``/0/k``)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat_shapes(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in flat_shapes(sub, f"{path}/{i}").items()}
    return {path: tuple(tree.shape)} if isinstance(tree, torch.Tensor) else {}


def _steps(name, inp, out, meshes):
    """Prefill and the decode steps of ``name`` on each mesh, tp_sketch off
    and on: logits (whole rows), caches (gathered), the decode payload, the
    attention's head layout, and whether every rank's cache leaves have
    ``cache_specs``' shapes."""
    import torch.distributed as dist

    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding
    from repro_torch.models import lm
    from repro_torch.nn.common import MODEL_SHARDED_OUT
    from repro_torch.serve.serve_step import whole_rows
    from repro_torch.tree import tree_leaves

    cfg = config(name)
    data = inp[f"{name}/inputs"]
    if lead_rank():
        rt = Runtime(device="cpu")
        logits, caches = rt.prefill_step(cfg, MAX_LEN)(inp[f"{name}/params"], data["batch"])
        outs = [np32(logits)]
        for tok, pos in zip(data["steps"], data["pos"]):
            logits, caches = rt.decode_step(cfg)(inp[f"{name}/params"], caches, tok,
                                                 torch.as_tensor(pos))
            outs.append(np32(logits))
        out[f"{name}/single/logits"] = outs
    for tag, mesh in meshes.items():
        for tp in (False, True):
            ex = ExecutionConfig(mesh=mesh, tp_sketch=tp)
            rt = Runtime(device="cpu", execution=ex)
            params = sharding.shard_params(inp[f"{name}/params"], mesh)
            meshlib.reset_collective_bytes()
            logits, caches = rt.prefill_step(cfg, MAX_LEN)(params, data["batch"])
            prefill_bytes = meshlib.collective_bytes()["total"]
            key = f"{name}/{tag}/{'tp' if tp else 'exact'}"
            outs, dec_bytes = [whole_rows(logits, mesh, B)], []
            shapes = [lm.layer_cache(cfg, kind, B, MAX_LEN, enc_len=S_ENC,
                                     device=torch.device("meta")) for kind in lm.layer_kinds(cfg)]
            ok = _local_shapes_ok(caches, sharding.cache_specs(cfg, shapes, mesh, B), mesh,
                                  shapes)
            dec = rt.decode_step(cfg)
            for tok, pos in zip(data["steps"], data["pos"]):
                meshlib.reset_collective_bytes()
                logits, caches = dec(params, caches, tok, torch.as_tensor(pos))
                dec_bytes.append(meshlib.collective_bytes()["total"])
                outs.append(whole_rows(logits, mesh, B))
            whole = gather_whole(caches, mesh)
            # the round trip: cut from the whole by cache_specs, each rank's
            # shard is what its steps left
            cut = sharding.shard_caches(_rebuild(caches, whole), mesh, B)
            ok = ok and all(torch.equal(a, b) for a, b in zip(tree_leaves(cut),
                                                               tree_leaves(caches)))
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, ok)
            out[key + "/shapes_ok"] = every
            out[key + "/logits"] = [np32(t) for t in outs]
            out[key + "/caches"] = whole
            out[key + "/bytes"] = (prefill_bytes, dec_bytes)
            if name == "lm":
                ctx = ex.make_ctx()
                w = params["layers"][0]["attn"]
                out[key + "/local_heads"] = (
                    all(ctx.plan_kind(f"attn_{n}", w[n]) in MODEL_SHARDED_OUT
                        for n in "qkv") and ctx.heads_local(cfg.n_heads, cfg.n_kv))


def _requests(cfg, seed, lens, news):
    from repro_torch.serve.scheduler import Request

    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(1, cfg.vocab, size=n).astype(np.int32), max_new=m)
            for n, m in zip(lens, news)]


ENGINE_REQS = dict(seed=9, lens=(11, 5, 17, 8), news=(5, 8, 3, 6))  # JAX's test's


def _engine_runs(cfg, params, rt, kinds) -> dict:
    """Each engine kind's output tokens for :data:`ENGINE_REQS`."""
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.legacy import RunToCompletionEngine

    svs = {"paged": ServeConfig(n_slots=4, max_len=64, page_size=16),
           "paged16": ServeConfig(n_slots=4, max_len=64, page_size=16, n_pages=16),
           "contig": ServeConfig(n_slots=4, max_len=64, page_size=None)}
    got = {}
    for kind in kinds:
        reqs = _requests(cfg, **ENGINE_REQS)
        if kind == "legacy":
            RunToCompletionEngine(params, cfg, batch=4, max_len=64, runtime=rt).run(reqs)
        else:
            rt.serve(params, cfg, serve=svs[kind]).run(reqs)
        got[kind] = [r.out.tolist() for r in reqs]
    return got


def _engines(name, tag, tp, kinds, inp, out, meshes):
    """The engines of ``kinds`` on mesh ``tag`` against the single device
    (rank 0's); every rank's tokens."""
    import torch.distributed as dist

    from repro_torch.api import ExecutionConfig, Runtime

    cfg = config(name)
    params = inp[f"{name}/params"]
    key = f"engines/{name}/{tag}/{'tp' if tp else 'exact'}"
    if lead_rank():
        out[key + "/single"] = _engine_runs(cfg, params, Runtime(device="cpu"), kinds)
    rt = Runtime(device="cpu", execution=ExecutionConfig(mesh=meshes[tag], tp_sketch=tp))
    got = _engine_runs(cfg, params, rt, kinds)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, got)
    out[key] = every


def _pools(inp, out, meshes):
    """Each rank's pool leaves against ``paged_cache_specs``: the default
    pool (17 pages, replicated) and 16 pages (over data)."""
    import torch.distributed as dist

    from repro_torch.launch import sharding
    from repro_torch.serve import kv_cache
    from repro_torch.serve.config import ServeConfig

    cfg = config("serve")
    for n_pages in (None, 16):
        sv = ServeConfig(n_slots=4, max_len=64, page_size=16, n_pages=n_pages)
        whole = kv_cache.init_pools(cfg, sv, device="cpu")
        for tag, mesh in meshes.items():
            pools = kv_cache.init_pools(cfg, sv, device="cpu", mesh=mesh)
            specs = sharding.paged_cache_specs(whole, mesh, sv.pool_pages)
            cut = sharding.shard_pools(whole, mesh, sv.pool_pages)
            ok = (_local_shapes_ok(pools, specs, mesh, whole)
                  and _local_shapes_ok(cut, specs, mesh, whole))
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, (ok, tuple(pools[0]["k"].shape)))
            out[f"pools/{n_pages}/{tag}"] = every


def _worker(rank, world, store, work):
    init_group(rank, world, store)
    out = {}
    try:
        from test_torch_distributed_families import make_meshes

        inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        meshes = make_meshes(MESHES)
        for name in CONFIGS:
            progress(work, rank, f"steps/{name}")
            t0 = time.perf_counter()
            _steps(name, inp, out, meshes)
            out[f"time/steps/{name}"] = time.perf_counter() - t0
        for name, tag, tp, kinds in ENGINE_RUNS:
            progress(work, rank, f"engines/{name}/{tag}/{tp}")
            t0 = time.perf_counter()
            _engines(name, tag, tp, kinds, inp, out, meshes)
            out[f"time/engines/{name}/{tag}/{tp}"] = time.perf_counter() - t0
        progress(work, rank, "pools")
        _pools(inp, out, meshes)
    finally:
        finish(rank, out, work)


# ---------------------------------------------------------------------------
# The test process's side
# ---------------------------------------------------------------------------


def _jax_params(name):
    import jax

    from repro.models import lm as jlm

    return jax.device_get(jlm.init_params(jax.random.key(1), config(name, "jax")))


@pytest.fixture(scope="module")
def jax_params():
    return {name: _jax_params(name) for name in CONFIGS + ("serve",)}


@pytest.fixture(scope="module")
def inputs(jax_params):
    from repro_torch import interop

    inp = {}
    for name, jp in jax_params.items():
        cfg = config(name)
        inp[f"{name}/params"] = interop.params_from_jax(jp, cfg, device="cpu")
        data = serve_inputs(cfg)
        inp[f"{name}/inputs"] = data
    return inp


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return spawn_ranks(_worker, inputs, tmp_path_factory, alone_s=ALONE_S)


def _jax_run(name, tag, jax_params):
    """JAX's mesh Runtime: prefill and the decode steps; (logits, caches as
    the port's flat leaves)."""
    import jax.numpy as jnp

    from repro.api.execution import ExecutionConfig as JExecutionConfig
    from repro.api.runtime import Runtime as JRuntime
    from repro_torch import interop

    jcfg, cfg = config(name, "jax"), config(name)
    data = serve_inputs(cfg)
    rt = JRuntime(execution=JExecutionConfig(mesh=jax_mesh(tag)))
    batch = {k: jnp.asarray(v) for k, v in data["batch"].items()}
    logits, caches = rt.prefill_step(jcfg, MAX_LEN)(jax_params[name], batch)
    outs = [np.asarray(logits)]
    dec = rt.decode_step(jcfg)
    for tok, pos in zip(data["steps"], data["pos"]):
        logits, caches = dec(jax_params[name], caches, jnp.asarray(tok), jnp.asarray(pos))
        outs.append(np.asarray(logits))
    return outs, flat(interop.caches_from_jax(caches, cfg, device="cpu"))


_JAX_RUNS = {}


def _jax_cached(name, tag, jax_params):
    if (name, tag) not in _JAX_RUNS:
        _JAX_RUNS[(name, tag)] = _jax_run(name, tag, jax_params)
    return _JAX_RUNS[(name, tag)]


@pytest.mark.parametrize("tp", [False, True], ids=["exact", "tp"])
@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_mesh_prefill_and_decode_match_jax(ranks, jax_params, name, tag, tp):
    """The port's mesh Runtime's prefill and decode logits (rows gathered)
    and caches against JAX's mesh Runtime on the same mesh shape (rtol 1e-4,
    atol 1e-5; zamba :data:`DEEP_TOL`), and the logits against the port's
    single device (the same tolerances)."""
    want_logits, want_caches = _jax_cached(name, tag, jax_params)
    key = f"{name}/{tag}/{'tp' if tp else 'exact'}"
    got = ranks[key + "/logits"]
    tol = DEEP_TOL.get(name)
    rtol, atol = (tol, tol) if tol else (RTOL, ATOL)
    assert len(got) == len(want_logits) == STEPS + 1
    for a, b, c in zip(got, want_logits, ranks[f"{name}/single/logits"]):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
        np.testing.assert_allclose(a, c, rtol=rtol, atol=atol)
    caches = ranks[key + "/caches"]
    assert set(caches) == set(want_caches)
    for path, b in want_caches.items():
        np.testing.assert_allclose(caches[path], b, rtol=rtol, atol=atol, err_msg=path)


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_each_rank_holds_cache_specs_shards(ranks, name, tag):
    """Every rank's cache leaves after prefill have the shapes
    ``cache_specs`` cuts from the whole caches, and after the decode steps
    they are what ``shard_caches`` cuts from the gathered whole."""
    for tp in ("exact", "tp"):
        assert ranks[f"{name}/{tag}/{tp}/shapes_ok"] == [True] * 4


@pytest.mark.parametrize("tag", list(MESHES))
def test_decode_payload_equals_the_shape_formula(ranks, tag):
    """Each decode step of the dense arch (tp_sketch off) moves
    :func:`decode_payload`'s bytes, every step alike."""
    _, dec = ranks[f"lm/{tag}/exact/bytes"]
    assert dec == [decode_payload(config("lm"), MESHES[tag])] * STEPS


@pytest.mark.parametrize("tag,local", [("2x2", True), ("1x4", False)])
def test_lm_arch_takes_local_heads_on_2x2_and_gathered_on_1x4(ranks, tag, local):
    """With ``tp_sketch`` on (TP plans) and off (the local plans split over
    model) the 4 query and 2 kv heads divide a model axis of 2 (local
    heads) but not of 4 (a decode step's heads gathered; a prefill keeps
    its queries' heads, ``nn.attention._mesh_heads``' "flat" layout); both
    layouts' steps match JAX (``test_mesh_prefill_and_decode_match_jax``)."""
    assert ranks[f"lm/{tag}/tp/local_heads"] is local
    assert ranks[f"lm/{tag}/exact/local_heads"] is local


@pytest.mark.parametrize("name,tag,tp,kinds", ENGINE_RUNS,
                         ids=[f"{n}-{t}-{'tp' if tp else 'exact'}" for n, t, tp, _ in ENGINE_RUNS])
def test_engines_under_a_mesh_equal_the_single_device_engines(ranks, name, tag, tp, kinds):
    """Every engine under the mesh emits the single-device engine's tokens,
    on every rank."""
    key = f"engines/{name}/{tag}/{'tp' if tp else 'exact'}"
    want, every = ranks[key + "/single"], ranks[key]
    assert len(every) == 4 and set(want) == set(kinds)
    for rank, got in enumerate(every):
        assert got == want, f"rank {rank}"


@pytest.mark.parametrize("tag", list(MESHES))
def test_mesh_runtime_equivalence(ranks, tag):
    """JAX's ``test_mesh_runtime_equivalence`` on the port: under a
    mesh-bearing Runtime the continuous and the run-to-completion engines
    agree token for token (on every rank), on JAX's requests."""
    for got in ranks[f"engines/serve/{tag}/exact"]:
        assert got["paged"] == got["legacy"]


@pytest.mark.parametrize("n_pages", [None, 16])
@pytest.mark.parametrize("tag", list(MESHES))
def test_each_rank_holds_paged_cache_specs_shards(ranks, tag, n_pages):
    """Pool leaves by ``paged_cache_specs`` (``init_pools(mesh=)``'s and
    ``shard_pools``' alike): the default pool's 17 pages (4 slots) do not
    divide 2 data ranks and stay whole; 16 pages split over data on (2, 2)
    (``tests/test_serve.py::test_paged_cache_specs``)."""
    from repro_torch.serve.config import ServeConfig

    every = ranks[f"pools/{n_pages}/{tag}"]
    assert [ok for ok, _ in every] == [True] * 4
    pages = {shape[0] for _, shape in every}
    whole = ServeConfig(n_slots=4, max_len=64, page_size=16, n_pages=n_pages).pool_pages
    split = n_pages == 16 and MESHES[tag][0] == 2
    assert pages == {8 if split else whole}


def test_flash_prefill_under_a_one_rank_mesh_is_the_single_device_prefill():
    """The flash path under a mesh: ``attn_impl="pallas"`` sends a prefill
    without segments to ``multi_head_attention``'s kernel call on this
    rank's heads; off the card the kernel's plain version runs, and on a
    one-rank gloo group the mesh step is the single device's bit for bit
    (the card's check is chip_smoke's phase 20)."""
    import torch.distributed as dist

    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import shard_params
    from repro_torch.models import lm

    cfg = config("lm").replace(attn_impl="pallas")
    params = lm.init_params(0, cfg, device="cpu")
    data = serve_inputs(cfg)
    store = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"one_rank_{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        runs = []
        for ex, p in ((ExecutionConfig(), params),
                      (ExecutionConfig(mesh=mesh), shard_params(params, mesh))):
            rt = Runtime(device="cpu", execution=ex)
            logits, caches = rt.prefill_step(cfg, MAX_LEN)(p, data["batch"])
            outs = [logits]
            for tok, pos in zip(data["steps"], data["pos"]):
                logits, caches = rt.decode_step(cfg)(p, caches, tok, torch.as_tensor(pos))
                outs.append(logits)
            runs.append(outs)
    finally:
        dist.destroy_process_group()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
