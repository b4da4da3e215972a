"""Checkpoints of repro_torch (``train/checkpoint.py``): ports of the JAX
package's tests/test_checkpoint.py (atomicity, gc, async, CRC verification
and fallback, the async writer's error), the snapshot's independence from
in-place updates, and the on-disk format against the JAX package's: a
checkpoint JAX writes restores in the port to the same arrays and passes the
port's ``verify``, and one the port writes passes JAX's ``verify`` and
restores in JAX. Every comparison is exact."""
import json
import os

import numpy as np
import pytest
import torch

from repro.train import checkpoint as jck
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ck
from repro_torch.train.train_step import TrainState


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: with several, the CPU's reductions (the embedding
    gradient among them) need not give the same bits on every call, which
    the bit-for-bit comparisons need; and the test processes share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _np_tree(seed=0):
    r = np.random.default_rng(seed)
    return {"a": r.standard_normal((4, 3)).astype(np.float32),
            "nested": {"b": np.arange(5, dtype=np.int32)},
            "lst": [np.ones(2, np.float32), np.zeros((2, 2), np.float32)]}


def _tree(seed=0):
    return {"a": torch.tensor(_np_tree(seed)["a"]),
            "nested": {"b": torch.arange(5, dtype=torch.int32)},
            "lst": [torch.ones(2), torch.zeros((2, 2))]}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def _leaves(tree):
    if isinstance(tree, dict):  # by sorted key: JAX's trees come back sorted
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_same(a_tree, b_tree):
    la, lb = _leaves(a_tree), _leaves(b_tree)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 7, t)
    out, step = ck.restore(str(tmp_path), _zeros_like(t))
    assert step == 7
    _assert_same(t, out)


def test_latest_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, t, keep=2)
    assert ck.latest_step(str(tmp_path)) == 5
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [4, 5]


def test_async_save(tmp_path):
    th = ck.save_async(str(tmp_path), 3, _tree())
    th.join()
    assert ck.latest_step(str(tmp_path)) == 3


def test_partial_tmp_dir_ignored(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 1, t)
    # a crash mid-save: a stale tmp dir without a manifest
    os.makedirs(tmp_path / "step_000000000009.tmp")
    assert ck.latest_step(str(tmp_path)) == 1
    _, step = ck.restore(str(tmp_path), _zeros_like(t))
    assert step == 1


def test_manager_cadence(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), every=5, keep=2)
    t = _tree()
    saved = [s for s in range(1, 21) if mgr.maybe_save(s, t)]
    mgr.wait()
    assert saved == [5, 10, 15, 20]
    assert ck.latest_step(str(tmp_path)) == 20


def test_restore_respects_structure(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 2, t)
    out, _ = ck.restore(str(tmp_path), _zeros_like(t))
    assert set(out) == set(t) and set(out["nested"]) == {"b"}
    assert isinstance(out["lst"], list) and len(out["lst"]) == 2
    assert all(isinstance(x, torch.Tensor) for x in _leaves(out))


def _corrupt_leaf(ckpt_dir, step, *, truncate=False):
    d = os.path.join(str(ckpt_dir), f"step_{step:012d}")
    npys = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
    path = os.path.join(d, npys[0])
    if truncate:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
    else:
        with open(path, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([last[0] ^ 0xFF]))


def test_manifest_has_per_leaf_crc(tmp_path):
    ck.save(str(tmp_path), 1, _tree())
    with open(tmp_path / "step_000000000001" / "manifest.json") as f:
        m = json.load(f)
    assert m["version"] == 2
    assert sorted(m["crc"]) == m["keys"]
    assert all(isinstance(v, int) for v in m["crc"].values())
    assert ck.verify(str(tmp_path), 1)


@pytest.mark.parametrize("truncate", [False, True], ids=["bitflip", "truncated"])
def test_corrupt_leaf_fails_verification(tmp_path, truncate):
    t = _tree()
    ck.save(str(tmp_path), 1, t)
    _corrupt_leaf(tmp_path, 1, truncate=truncate)
    assert not ck.verify(str(tmp_path), 1)
    assert ck.latest_verified_step(str(tmp_path)) is None
    # an explicit step: the caller asked for that exact state
    with pytest.raises(ck.CheckpointError, match="CRC"):
        ck.restore(str(tmp_path), _zeros_like(t), step=1)


def test_restore_falls_back_to_newest_verified(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 1, t)
    t2 = {"a": t["a"] + 1, "nested": {"b": t["nested"]["b"] + 1},
          "lst": [x + 1 for x in t["lst"]]}
    ck.save(str(tmp_path), 2, t2)
    _corrupt_leaf(tmp_path, 2, truncate=True)
    assert ck.latest_step(str(tmp_path)) == 2
    assert ck.latest_verified_step(str(tmp_path)) == 1
    with pytest.warns(UserWarning, match="falling back"):
        out, step = ck.restore(str(tmp_path), _zeros_like(t))
    assert step == 1
    _assert_same(t, out)


def test_missing_leaf_fails_verification(tmp_path):
    ck.save(str(tmp_path), 3, _tree())
    d = tmp_path / "step_000000000003"
    npys = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
    os.remove(d / npys[0])
    assert not ck.verify(str(tmp_path), 3)


def test_async_write_error_surfaces_on_wait(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), every=1)
    ck.inject_fault_once()
    assert mgr.maybe_save(1, _tree())  # the writer fails in the background
    with pytest.raises(ck.CheckpointError, match="injected"):
        mgr.wait()
    # the manager recovers: the failure is not raised twice, the next save
    # goes through
    mgr.wait()
    mgr.maybe_save(2, _tree())
    mgr.wait()
    assert ck.latest_verified_step(str(tmp_path)) == 2


def test_async_error_rides_the_writer_thread(tmp_path):
    ck.inject_fault_once()
    th = ck.save_async(str(tmp_path), 1, _tree())
    th.join()
    assert isinstance(th.error, ck.CheckpointError)
    assert ck.latest_step(str(tmp_path)) is None


def test_async_snapshot_taken_before_an_inplace_update(tmp_path):
    """The port's optimizers update in place, and ``tensor.cpu()`` of a CPU
    tensor is the tensor itself: an async save taken before an in-place
    AdamW update restores the values from before the update."""
    params = {"w": torch.randn(64, 32, generator=torch.Generator().manual_seed(0)),
              "b": torch.zeros(32)}
    opt = adamw(1e-1, weight_decay=0.1)
    state = TrainState(params=params, opt_state=opt.init(params), step=4)
    before = {k: v.clone() for k, v in params.items()}
    mgr = ck.CheckpointManager(str(tmp_path), every=1)
    mgr.maybe_save(5, state)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    opt.update(grads, state.opt_state, state.params, state.step)  # in place
    assert not torch.equal(params["w"], before["w"])
    mgr.wait()
    like = TrainState(params={k: torch.empty_like(v) for k, v in params.items()},
                      opt_state=opt.init(params), step=0)
    out, step = ck.restore(str(tmp_path), like)
    assert step == 5 and out.step == 4 and isinstance(out.step, int)
    for k in params:
        assert torch.equal(out.params[k], before[k])
    assert all(torch.equal(m, torch.zeros_like(m)) for m in out.opt_state["m"].values())


def test_trainstate_keys_are_jaxs(tmp_path):
    """A TrainState's leaves are named as JAX names its TrainState's
    (``x:.params__k:...``, ``x:.step``)."""
    state = TrainState(params={"embed": torch.ones(3), "layers": [{"g": torch.ones(2)}]},
                       opt_state={}, step=2)
    ck.save(str(tmp_path), 2, state)
    with open(tmp_path / "step_000000000002" / "manifest.json") as f:
        keys = json.load(f)["keys"]
    assert keys == ["x:.params__k:embed", "x:.params__k:layers__i:0__k:g", "x:.step"]


def test_jax_written_checkpoint_restores_in_the_port(tmp_path):
    """JAX's ``save`` of a numpy tree: the port's ``verify`` passes and its
    ``restore`` gives the same arrays, as tensors or numpy like the target."""
    t = _np_tree(3)
    jck.save(str(tmp_path), 4, t)
    assert ck.verify(str(tmp_path), 4) and ck.latest_verified_step(str(tmp_path)) == 4
    out, step = ck.restore(str(tmp_path), _zeros_like(_tree()))
    assert step == 4
    _assert_same(t, out)
    out_np, _ = ck.restore(str(tmp_path), _np_tree(9))
    _assert_same(t, out_np)
    _corrupt_leaf(tmp_path, 4)
    assert not ck.verify(str(tmp_path), 4)


def test_port_written_checkpoint_passes_jaxs_verify(tmp_path):
    """The port's ``save`` (sync and async): JAX's ``verify`` passes and its
    ``restore`` gives the same arrays; a corrupted leaf fails JAX's verify."""
    t = _tree(5)
    ck.save(str(tmp_path), 6, t)
    ck.save_async(str(tmp_path), 7, t).join()
    for step in (6, 7):
        assert jck.verify(str(tmp_path), step)
        out, got = jck.restore(str(tmp_path), _np_tree(0), step=step)
        assert got == step
        _assert_same(t, out)
    _corrupt_leaf(tmp_path, 7, truncate=True)
    assert not jck.verify(str(tmp_path), 7) and jck.latest_verified_step(str(tmp_path)) == 6
