"""``repro_torch.launch.input_specs`` against JAX's ``repro.launch.input_specs``
for all ten named configs at full size: every parameter, cache and input
leaf has JAX's shape and dtype (the port's per-layer trees mapped onto JAX's
stacked ones by ``interop``'s leaf mapping), nothing is allocated (the
leaves are fake tensors), and the dry run's parameter counts equal JAX's
``_active_params``. JAX's side is ``jax.eval_shape``: no arrays either."""
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jax_config
from repro.launch import input_specs as jspec
from repro_torch.configs.base import SHAPE_CELLS
from repro_torch.configs.registry import cells_for, get_config
from repro_torch.interop import _unstack
from repro_torch.launch import input_specs as tspec
from repro_torch.tree import tree_leaves, tree_map


class _Leaf:
    """A JAX leaf's shape and dtype, as the port names its dtype."""

    def __init__(self, a):
        self.shape = tuple(a.shape)
        self.dtype = str(np.dtype(a.dtype))

    def __repr__(self):
        return f"{self.dtype}{list(self.shape)}"


def _view(s):
    """A zero-stride array of the struct's shape and dtype: indexable by
    ``interop._unstack`` at no memory cost."""
    return np.lib.stride_tricks.as_strided(np.zeros((), np.dtype(s.dtype)), shape=s.shape,
                                           strides=(0,) * len(s.shape))


def _jax_like_port(tree, cfg):
    """JAX's parameter struct in the port's layout (``interop.params_from_jax``'s
    mapping, on shapes)."""
    import jax

    t = jax.tree_util.tree_map(_view, tree)
    out = {"embed": _Leaf(t["embed"]), "final_norm": tree_map(_Leaf, t["final_norm"]),
           "layers": _unstack(t["segments"], cfg, _Leaf)}
    for name in ("shared", "lm_head"):
        if name in t:
            out[name] = tree_map(_Leaf, t[name])
    if "encoder" in t:
        out["encoder"] = {"layers": _unstack(t["encoder"]["segments"], cfg, _Leaf, encoder=True),
                          "final_norm": tree_map(_Leaf, t["encoder"]["final_norm"])}
    return out


def _by_path(tree, path=()):
    """{path: leaf}: JAX's trees sort their dict keys, the port's keep their
    insertion order, so leaves are compared by path."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _by_path(sub, path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _by_path(sub, path + (i,)).items()}
    return {path: tree}


def _same(port_tree, jax_tree):
    got = {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for k, x in _by_path(port_tree).items()}
    want = {k: (x.shape, x.dtype) for k, x in _by_path(jax_tree).items()}
    assert got == want


def _fake(tree):
    from torch._subclasses.fake_tensor import FakeTensor

    return all(isinstance(t, FakeTensor) for t in tree_leaves(tree))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_struct_equals_jax(arch):
    cfg = get_config(arch)
    got = tspec.params_struct(cfg, device="cpu")
    assert _fake(got)
    _same(got, _jax_like_port(jspec.params_struct(jax_config(arch)), cfg))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_jax_active_params(arch):
    from repro.launch.dryrun import _active_params as jax_active
    from repro_torch.launch.dryrun import _active_params
    from repro_torch.models import lm

    jtree = jspec.params_struct(jax_config(arch))
    shapes = lm.param_shapes(get_config(arch))
    n_jax = sum(int(np.prod(x.shape)) for x in __import__("jax").tree_util.tree_leaves(jtree))
    assert sum(t.numel() for t in tree_leaves(shapes)) == n_jax
    assert _active_params(shapes, get_config(arch)) == jax_active(jtree, jax_config(arch))


def _cells(kind):
    return [(a, c.name) for a in ARCH_IDS for c in cells_for(get_config(a)) if c.kind == kind]


@pytest.mark.parametrize("arch,cell", _cells("train") + _cells("prefill"))
def test_train_inputs_equal_jax(arch, cell):
    cfg, c = get_config(arch), SHAPE_CELLS[cell]
    got = tspec.train_inputs(cfg, c, device="cpu")
    want = jspec.train_inputs(jax_config(arch), c)
    assert sorted(got) == sorted(want) and _fake(got)
    for k in want:
        assert (tuple(got[k].shape), str(got[k].dtype).replace("torch.", "")) == (
            tuple(want[k].shape), str(np.dtype(want[k].dtype))), k


@pytest.mark.parametrize("arch,cell", _cells("decode"))
def test_decode_inputs_and_caches_equal_jax(arch, cell):
    import jax

    cfg, c = get_config(arch), SHAPE_CELLS[cell]
    got = tspec.decode_inputs(cfg, c, device="cpu")
    want = jspec.decode_inputs(jax_config(arch), c)
    tok = got["tokens"]
    assert (tuple(tok.shape), str(tok.dtype).replace("torch.", "")) == (
        tuple(want["tokens"].shape), str(np.dtype(want["tokens"].dtype)))
    assert _fake(got["caches"])

    def layer(sub):  # interop.caches_from_jax's merge of a layer's entries
        if "kv" not in sub:
            return sub
        return dict(sub["kv"], cross=sub["cross"]) if "cross" in sub else sub["kv"]

    caches = jax.tree_util.tree_map(_view, want["caches"])
    per_sub = [[layer(sub) for sub in seg] for seg in caches]
    _same(got["caches"], _unstack(per_sub, cfg, _Leaf))


def test_nothing_is_allocated():
    """The 405B parameter tree and a 32k-position cache of 128 rows as fake
    tensors: no storage behind any of them."""
    cfg = get_config("llama3_405b")
    params = tspec.params_struct(cfg, device="cpu")
    assert sum(t.numel() for t in tree_leaves(params)) > 4e11
    assert _fake(params)
    caches = tspec.cache_struct(cfg, 128, 32768, device="cpu")
    assert _fake(caches) and isinstance(tree_leaves(caches)[0], torch.Tensor)
