"""The port's sharding rules against JAX's, leaf for leaf.

Specs come from the mesh's shape and axis names alone, so no process group
is needed: the port reads a ``launch.mesh.layout`` and JAX's rules read an
object with its mesh's ``shape`` and ``axis_names`` (they build no
``NamedSharding``), which lets the production meshes (16, 16) and (2, 16,
16) be checked on this box. JAX's shapes come from ``jax.eval_shape`` of its
``init_params``; the port's from ``lm.param_shapes`` (meta tensors). A JAX
leaf stacked over its layers carries one more leading (replicated)
dimension, which the comparison drops. Exact equality throughout.
"""
import types

import numpy as np
import pytest

MESHES = [((2, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]
CONFIGS = ["arch", "lm-100m", "llama3_405b", "nemotron_4_340b"]


def _cfgs(name):
    from repro.configs.base import ArchConfig as JArch
    from repro.configs.registry import get_config as jget

    from repro_torch.configs.base import ArchConfig
    from repro_torch.configs.registry import get_config

    if name == "arch":
        kw = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv=2,
                  d_ff=64, vocab=64, q_chunk=16, kv_chunk=16)
        return JArch(**kw), ArchConfig(**kw)
    if name == "lm-100m":
        kw = dict(name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
                  n_kv=12, d_ff=2048, vocab=32000, q_chunk=128, kv_chunk=256)
        return JArch(**kw), ArchConfig(**kw)
    return jget(name), get_config(name)


def _meshes(shape, axes):
    from repro_torch.launch.mesh import layout

    jmesh = types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=tuple(axes))
    return jmesh, layout(shape, axes)


def _norm(spec, ndim):
    """A spec as a tuple of ``ndim`` entries, a one-axis tuple as its name."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else (e if e else None)
        out.append(e)
    return tuple(out)


def _jax_flat(tree):
    from repro import compat

    flat = {}
    compat.tree_map_with_path(
        lambda path, leaf: flat.__setitem__("/".join(str(getattr(p, "key", getattr(
            p, "idx", p))) for p in path), leaf), tree)
    return flat


def _port_flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, prefix + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_flat(v, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tree}


def _jax_path(path: str, layer_paths) -> str:
    parts = path.split("/")
    if parts[0] == "layers":
        return "/".join([layer_paths[int(parts[1])]] + parts[2:])
    return path


@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_equal_jax(name, mesh_i):
    import jax

    from repro import compat
    from repro.launch import sharding as jshard
    from repro.models import lm as jlm

    from repro_torch.launch import sharding
    from repro_torch.models import lm

    jcfg, cfg = _cfgs(name)
    jmesh, mesh = _meshes(*MESHES[mesh_i])
    jshapes = jax.eval_shape(lambda: jlm.init_params(compat.prng_key(0), jcfg))
    jspecs = _jax_flat(jshard.param_specs(jshapes, jmesh))
    jleaves = _jax_flat(jshapes)
    shapes = lm.param_shapes(cfg)
    specs = _port_flat(sharding.param_specs(shapes, mesh))
    leaves = _port_flat(shapes)
    layer_paths = lm.jax_layer_paths(cfg)
    assert len(specs) == sum(1 for _ in leaves)
    seen = set()
    for path, spec in specs.items():
        jp = _jax_path(path, layer_paths)
        seen.add(jp)
        jl = jleaves[jp]
        lead = len(jl.shape) - leaves[path].dim()
        assert tuple(jl.shape[lead:]) == tuple(leaves[path].shape), path
        want = _norm(jspecs[jp], len(jl.shape))
        assert all(e is None for e in want[:lead]), (path, want)
        assert _norm(spec, leaves[path].dim()) == want[lead:], (path, spec, want)
    assert seen == set(jleaves), set(jleaves) - seen


@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=MESH_IDS)
def test_batch_specs_and_logical_rules_equal_jax(mesh_i):
    from repro.configs.base import SHAPE_CELLS as JCELLS
    from repro.launch import sharding as jshard

    from repro_torch.configs.base import SHAPE_CELLS
    from repro_torch.launch import sharding

    jmesh, mesh = _meshes(*MESHES[mesh_i])
    for name in ("arch", "llama3_405b"):
        jcfg, cfg = _cfgs(name)
        for cell in SHAPE_CELLS:
            got = sharding.batch_specs(cfg, SHAPE_CELLS[cell], mesh)
            want = jshard.batch_specs(jcfg, JCELLS[cell], jmesh)
            assert set(got) == set(want)
            for k in want:
                assert _norm(got[k], len(got[k])) == _norm(want[k], len(got[k])), (cell, k)
    got, want = sharding.logical_rules(mesh), jshard.logical_rules(jmesh)
    assert {k: _norm(v, 3) for k, v in got.items()} == {k: _norm(v, 3) for k, v in want.items()}


@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("batch,max_len", [(8, 64), (3, 48)])
def test_cache_specs_equal_jax(mesh_i, batch, max_len):
    import jax
    import torch

    from repro.launch import sharding as jshard
    from repro.models import lm as jlm

    from repro_torch.launch import sharding
    from repro_torch.models import lm

    jcfg, cfg = _cfgs("arch")
    jmesh, mesh = _meshes(*MESHES[mesh_i])
    jc = jax.eval_shape(lambda: jlm.init_cache(jcfg, batch, max_len))
    jspecs, jleaves = _jax_flat(jshard.cache_specs(jcfg, jc, jmesh, batch)), _jax_flat(jc)
    caches = [lm.layer_cache(cfg, kind, batch, max_len, device=torch.device("meta"))
              for kind in lm.layer_kinds(cfg)]
    specs = _port_flat(sharding.cache_specs(cfg, caches, mesh, batch))
    leaves = _port_flat(caches)
    layer_paths = lm.jax_layer_paths(cfg)
    for path, spec in specs.items():
        i, rest = path.split("/", 1)
        # JAX: one list per segment, one entry per sub-block, k/v under "kv"
        jp = "/".join([layer_paths[int(i)].replace("segments/", ""), "kv", rest])
        want = _norm(jspecs[jp], len(jleaves[jp].shape))
        lead = len(jleaves[jp].shape) - leaves[path].dim()
        assert _norm(spec, leaves[path].dim()) == want[lead:], (path, spec, want)


@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=MESH_IDS)
def test_paged_cache_specs_equal_jax(mesh_i):
    import jax.numpy as jnp
    import torch

    from repro.launch import sharding as jshard

    from repro_torch.launch import sharding

    jmesh, mesh = _meshes(*MESHES[mesh_i])
    for n_pages in (64, 33):
        jpool = {"k": jnp.zeros((2, n_pages, 16, 2, 8)), "map": jnp.zeros((4, 8), jnp.int32)}
        pool = {"k": torch.empty((n_pages, 16, 2, 8), device="meta"),
                "map": torch.empty((4, 8), device="meta")}
        want = jshard.paged_cache_specs(jpool, jmesh, n_pages)
        got = sharding.paged_cache_specs(pool, mesh, n_pages)
        assert _norm(got["k"], 4) == _norm(want["k"], 5)[1:]
        assert _norm(got["map"], 2) == _norm(want["map"], 2)


def test_shard_tensor_chunks_and_marks():
    """``shard_tensor`` cuts this rank's chunk along each sharded dimension
    (rank 0 of a layout mesh: the first chunk) and marks it with its spec;
    ``global_shape`` recovers the whole shape."""
    import torch

    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import layout

    mesh = layout((2, 4), ("data", "model"))
    full = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    spec = sharding.spec_for_path("/layers/0/attn/q/w", full.shape, mesh)
    assert _norm(spec, 2) == ("model", "data")
    t = sharding.shard_tensor(full, spec, mesh)
    assert tuple(t.shape) == (16, 16) and sharding.spec_of(t) == spec
    np.testing.assert_array_equal(t.numpy(), full[:16, :16].numpy())
    assert sharding.global_shape(t, mesh) == (64, 32)
    r = sharding.shard_tensor(torch.ones(5), (None,), mesh)
    assert sharding.spec_of(r) is None


@pytest.mark.parametrize("shape,axes", [((2, 4), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model"))])
def test_shard_slices_tile_the_array_on_every_rank(shape, axes):
    """The host-side cut that checkpoint restores use (``shard_slices`` on a
    numpy array) is ``shard_tensor``'s cut on every rank, and the ranks'
    shards tile the whole array: each element in exactly as many shards as
    the spec leaves axes unused."""
    import math

    import torch

    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import Mesh

    full = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    hits = np.zeros(full.shape, dtype=np.int64)
    for rank in range(math.prod(shape)):
        mesh = Mesh(shape, axes, rank=rank)
        spec = sharding.spec_for_path("/layers/0/attn/q/w", full.shape, mesh)
        idx = sharding.shard_slices(full.shape, spec, mesh)
        t = sharding.shard_tensor(torch.from_numpy(full), spec, mesh)
        np.testing.assert_array_equal(full[idx], t.numpy())
        hits[idx] += 1
    used = math.prod(mesh.shape[a] for a in sharding.spec_axes(spec))
    assert (hits == math.prod(shape) // used).all()


def test_act_sharding_takes_only_the_fixed_layout():
    """The port's residual stream is batch over the data axes and replicated
    over model (the fixed layout), or JAX's sequence-parallel layout with
    the sequence over model; either may hold the batch replicated. So
    ``act_sharding`` takes None or one of those specs (in either spelling)
    and refuses any other layout, or a spec without a mesh, instead of
    ignoring it."""
    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.launch.mesh import layout

    mesh = layout((2, 2), ("data", "model"))
    for act in (None, ("data", None, None), (("data",), None, None), (None, None, None)):
        assert not ExecutionConfig(mesh=mesh, act_sharding=act).seq_parallel
    for act in (("data", "model", None), (("data",), "model", None), (None, "model", None)):
        assert ExecutionConfig(mesh=mesh, act_sharding=act).seq_parallel
    for act in ((None, None, "model"), ("model", None, None), ("data", None),
                ("data", "data", None)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ExecutionConfig(mesh=mesh, act_sharding=act)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            Runtime.from_legacy_kwargs(mesh=mesh, act_sharding=act, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        ExecutionConfig(act_sharding=("data", None, None))
