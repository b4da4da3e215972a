"""The rank's part of a compact backward on a site split over model
(``core.sketched_linear.split_backward``), on the CPU, over emulated shards.

A column-parallel site's rank holds the columns ``[lo, lo + n_loc)`` of
G and the same rows of W, and runs its part of the whole width's plan; a
row-parallel site's rank holds the whole G and its chunk of d_in. Held to
the whole width's backward on the same plan (``apply_plan``: the plain
versions of the kernels here):

* row split: dX's chunk, the rows' chunk and db bit for bit;
* column split: each shard's rows of dWc and db_c bit for bit, zero rows
  where another shard's columns lie, and the shards' dX summed within
  float32 tolerance (each straddling block's product is summed in two
  parts); a stale sweep's kept scores bit for bit, a one-pass sweep's
  scores within float32 tolerance (the score pass sums a narrower G).

The plans cover straddling blocks (d_ff 96 over 4 shards at block 16),
shards with no kept block, per-column plans, and no shape depends on the
data: the function runs under ``FakeTensorMode``. One intra-op thread.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

N, N_COLS, D_IN = 32, 96, 24
BACKENDS = ("compact", "pallas", "onepass", "stale")
# (block, kept block ids of the whole width's plan): the middle shards of
# [0, 5] keep nothing; a shard of 48 columns keeps every block of [0, 1, 2]
# and one of 16 every column of 16-31 (as many kept blocks as it has
# slots); block 0 is a per-column plan
PLANS = {"blocks": (16, [0, 2, 5]), "ends": (16, [0, 5]), "one": (16, [3]),
         "full": (16, [0, 1, 2]), "columns": (0, [3, 17, 40, 41, 90]),
         "column_run": (0, list(range(16, 32)) + [50])}
SHARDS = (2, 3, 4, 6)  # 48, 32, 24 (straddling blocks of 16), 16 columns each


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    G, X, W = (torch.from_numpy(rs.standard_normal(s).astype(np.float32))
               for s in ((N, N_COLS), (N, D_IN), (N_COLS, D_IN)))
    return G, X, W


def _case(backend, plan):
    from repro_torch.core import estimators
    from repro_torch.core.sketching import SketchConfig

    block, idx = PLANS[plan]
    cfg = SketchConfig(method="l1", budget=0.5, backend=backend, block=block)
    idx = torch.tensor(idx, dtype=torch.int64)
    scales = torch.linspace(1.5, 3.0, idx.shape[0])
    return estimators.get_estimator(backend), cfg, idx, scales


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("backend", BACKENDS)
def test_row_split_is_the_whole_backward_bit_for_bit(backend, plan):
    """A row shard (whole G, a chunk of d_in): dX's chunk, the rows' chunk
    and db exactly the whole width's."""
    est, cfg, idx, sc = _case(backend, plan)
    G, X, W = _inputs()
    whole = est._kernel(cfg, G, idx, sc, W, X)
    for c in (slice(0, 8), slice(8, 16), slice(16, 24)):
        part = est._kernel(cfg, G, idx, sc, W[:, c], X[:, c])
        assert torch.equal(part[0], whole[0][:, c])
        assert torch.equal(part[1], whole[1][:, c])
        assert torch.equal(part[2], whole[2])


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("backend", BACKENDS)
def test_column_split_parts_make_the_whole_backward(backend, plan, shards):
    """Each column shard's part of the whole width's plan: its rows of dWc
    and db_c bit for bit, zeros for the other shards' rows, the plan's
    global column indices; the parts' dX summed within float32 tolerance;
    the carry's refresh of its columns."""
    from repro_torch.core.sketched_linear import split_backward

    est, cfg, idx, sc = _case(backend, plan)
    G, X, W = _inputs()
    dX, rows, db_c, red = est._kernel(cfg, G, idx, sc, W, X)
    block = max(cfg.block, 1)
    cols = (idx[:, None] * block + torch.arange(block)[None, :]).reshape(-1)
    n_loc = N_COLS // shards
    dx_sum = torch.zeros_like(dX)
    kept_cols = torch.zeros(N_COLS, dtype=torch.bool)
    kept_cols[cols] = True
    for k in range(shards):
        lo = k * n_loc
        out, part_red = split_backward(est, cfg, G[:, lo:lo + n_loc], X, W[lo:lo + n_loc], idx,
                                       sc, lo=lo, n=N_COLS)
        assert torch.equal(out.cols, cols)
        mine = (cols >= lo) & (cols < lo + n_loc)
        assert torch.equal(out.rows[mine], rows[mine])
        assert not out.rows[~mine].any()
        assert torch.equal(out.db_c[mine], db_c[mine])
        assert not out.db_c[~mine].any()
        dx_sum += out.dx
        if est.refresh == "all":
            np.testing.assert_allclose(part_red.numpy(), red[lo:lo + n_loc].numpy(),
                                       rtol=1e-6, atol=0)
        elif est.refresh == "kept":
            full = torch.zeros(N_COLS)
            full[cols] = red
            assert torch.equal(part_red, full[lo:lo + n_loc])
            assert not part_red[~kept_cols[lo:lo + n_loc]].any()
        else:
            assert part_red is None
    scale = dX.abs().max().item()
    np.testing.assert_allclose(dx_sum.numpy(), dX.numpy(), rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("backend", BACKENDS)
def test_whole_width_sets_the_block_granularity(backend):
    """``apply_plan`` on a column shard narrower than a block (24 of 96
    columns at block 16) keeps the whole width's block plan: the shard's
    rows are its columns of the kept blocks, not a per-column fallback."""
    est, cfg, idx, sc = _case(backend, "blocks")
    G, X, W = _inputs()
    whole = est.apply_plan(cfg, G, X, W, idx, sc)
    part = est.apply_plan(cfg, G[:, 24:48], X, W[24:48], idx, sc, lo=24, n=N_COLS)
    assert torch.equal(part.cols, whole.cols) and part.rows.shape == whole.rows.shape
    mine = (whole.cols >= 24) & (whole.cols < 48)
    assert mine.any() and torch.equal(part.rows[mine], whole.rows[mine])


@pytest.mark.parametrize("backend", BACKENDS)
def test_split_backward_shapes_depend_on_no_data(backend):
    """Under ``FakeTensorMode`` (the dry run's tensors: no storage, no
    ``.item()``) the rank's part runs, with static shapes: dX ``[N,
    d_in]``, the whole plan's ``[r * block]`` rows, and ``[n_loc]``
    refreshed reductions."""
    from repro_torch.core.sketched_linear import split_backward
    from repro_torch.kernels import ops
    from repro_torch.launch import input_specs

    est, cfg, _, _ = _case(backend, "blocks")
    ops.reset_fake_costs()
    with input_specs.fake_mode():
        G, X, W = torch.empty(N, 24), torch.empty(N, D_IN), torch.empty(24, D_IN)
        idx, sc = torch.empty(3, dtype=torch.int64), torch.empty(3)
        out, red = split_backward(est, cfg, G, X, W, idx, sc, lo=24, n=N_COLS)
    assert tuple(out.dx.shape) == (N, D_IN)
    assert tuple(out.rows.shape) == (48, D_IN) and tuple(out.db_c.shape) == (48,)
    assert (red is None) == (est.refresh is None)
    if red is not None:
        assert tuple(red.shape) == (24,)
    launches = ops.fake_costs()["launches"]
    kernel = {"pallas": "block_gather_matmul_fused", "stale": "block_gather_matmul_fused",
              "onepass": "block_stream_matmul_fused"}.get(backend)
    assert sum(launches.values()) == (kernel is not None)
    if kernel is not None:
        assert launches[kernel] == 1
