"""The dry run at production meshes: every (arch x shape-cell x mesh), run
once on fake tensors over a fake process group.

Port of ``repro/launch/dryrun.py``. JAX lowers and compiles each cell for
512 fake host devices and reads the compiled program: its memory analysis,
its HLO FLOPs and bytes, its collectives. Eager PyTorch has no program to
read, so the port runs the cell's REAL step once, as rank 0 of a ``fake``
process group of the mesh's world size (``torch.distributed``'s backend
whose collectives move nothing), under ``FakeTensorMode`` (tensors with a
shape, a dtype and a device and no storage): every module of the port runs
as it would on the card, on this rank's shards, and nothing is computed or
allocated. The fake tensors are always CPU tensors, the path that
``chip_smoke.py`` phase 21 holds against the card's step (the kernels take
their fake branch on any device). The run counts:

* peak live bytes on the rank (a finalizer on every storage an op makes,
  each rounded up to the CUDA allocator's 512-byte block; the state and the
  batch included), as the port's ``obs.ledgers.memory_summary`` with
  ``fits_hbm`` against the card's usable bytes (``HW.hbm_bytes``);
* FLOPs: ``torch.utils.flop_counter``'s registry (what ``FlopCounterMode``
  counts) over the aten ops, plus each kernel launch's modelled operations
  (``kernels/ops.py``'s fake branch: the formulas behind ``PERF.md``'s
  Bound column);
* bytes accessed: each aten op's input and output bytes (XLA's definition;
  views, fresh empties and collectives move nothing and are skipped), plus
  each kernel's modelled bytes;
* collective payload and wire bytes (``launch.mesh.collective_bytes()``:
  JAX's ring weights at each call's group size, ``launch.hlo_analysis``);
* kernel launches (``kernels.ops.fake_costs()["launches"]``: the fake
  branch's own count; ``launch_counts()`` counts real launches only).

A cell runs at full depth once (the memory record, and the full-depth
counts), then at the two or three depths of :func:`_depth_points`; the
linear depth model (JAX's, solved exactly from the points' differences:
:func:`depth_prediction`) predicts the full depth, and the record
holds the prediction (``cost_full_depth``, as JAX's), the full-depth counts
(``cost_measured``) and their comparison (``depth_check``). Records go to
``results/torch/dryrun/<arch>.<cell>.<mesh>.<policy>[.nosp].json``.

Usage (CPU, no card needed)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b --cell train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --policy mask

What has no counterpart, and why:

* ``cost_mode`` (JAX's python-unrolled loops for the HLO cost artifacts):
  eager runs every loop, so there is nothing to unroll and
  ``ExecutionConfig`` does not change;
* ``rolled_cost`` (the rolled program's undercounted cost): the full-depth
  run counts every layer. ``rolled_collectives`` keeps its key and holds the
  full-depth run's collectives, which count every layer too;
* ``compile_s`` is the wall seconds of the fake runs (there is no
  compile).

A cell too slow to run at full depth within a time budget (llama3-405b's
126 layers at 8 microbatches take ~14 min on a host CPU; rwkv6's per-token
recurrence far longer) takes ``--depth-model``: the memory record is then
the depth model's prediction from the depth points run at the cell's
accumulation count, and ``depth_used`` says so.

Data-dependent shapes have static forms on every path a cell runs (the row
plan's rows of a shard, ``core/site.py``; the MoE's expert counts,
``nn/moe.py``), so no tensor's size depends on data and none is counted as
0 bytes. The kernels never launch on a fake tensor (``kernels/ops.py``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import traceback
import weakref

import torch
import torch.distributed as dist

from repro_torch.api import ExecutionConfig, Runtime, SketchConfig, SketchPolicy
from repro_torch.configs.base import SHAPE_CELLS, ArchConfig, ShapeCell
from repro_torch.configs.registry import ARCH_IDS, cells_for, get_config
from repro_torch.kernels import ops
from repro_torch.launch import input_specs as ispec
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding
from repro_torch.launch.hlo_analysis import HW, collective_totals, cost_summary, roofline_terms
from repro_torch.launch.mesh import dp_axes, mp_axes
from repro_torch.models import lm
from repro_torch.obs import clock
from repro_torch.obs.ledgers import AllocatorAnalysis, memory_summary
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.tree import tree_leaves

__all__ = ["run_cell", "record_or_error", "fake_group", "count_run", "depth_prediction",
           "TRAIN_ACCUM", "RESULTS_DIR"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "torch",
                           "dryrun")

# JAX's: the paper's l1 default at p=0.1 in the compact realisation, and the
# baselines; each entry is (policy, tp_sketch)
_BLOCK_L1 = SketchPolicy(base=SketchConfig(method="l1", budget=0.1, backend="compact",
                                           block=128))
_POLICIES = {
    "exact": (None, False),
    "mask": (SketchPolicy(base=SketchConfig(method="l1", budget=0.1, backend="mask")), False),
    "compact": (_BLOCK_L1, False),
    "compact_sharded": (_BLOCK_L1, True),
}

# JAX's gradient-accumulation microbatching for cells whose activations
# exceed HBM at the full global batch; the cost points run accum=1 (the same
# FLOPs in another order)
TRAIN_ACCUM = {"llama3_405b": 8, "nemotron_4_340b": 8, "olmoe_1b_7b": 2}


def _adjust_for_depth(cfg: ArchConfig, L: int) -> ArchConfig:
    kw = {"n_layers": L}
    if cfg.is_encdec:
        kw["enc_layers"] = L
    return cfg.replace(**kw)


def _depth_points(cfg: ArchConfig):
    """Cost-point depths: (L, n_full, rem) for the depth model."""
    if cfg.block_kind == "zamba":
        p = cfg.shared_attn_every
        return [(1, 0, 1), (p, 1, 0), (2 * p, 2, 0)]
    if cfg.local_global > 0:
        p = cfg.local_global + 1
        return [(1, 0, 1), (p, 1, 0), (2 * p, 2, 0)]
    return [(1, 1, 0), (2, 2, 0)]


def _depth_target(cfg: ArchConfig):
    if cfg.block_kind == "zamba":
        p = cfg.shared_attn_every
        return cfg.n_layers // p, cfg.n_layers % p
    if cfg.local_global > 0:
        p = cfg.local_global + 1
        return cfg.n_layers // p, cfg.n_layers % p
    return cfg.n_layers, 0


def _act_sharding(mesh, batch_div: bool, seq_len: int = 0, sp: bool = True) -> tuple:
    """JAX's residual-stream layout: ``(dp, model, None)`` with sequence
    parallelism where the sequence divides the model axis, else ``(dp,
    None, None)``; the batch replicated where it does not divide the data
    axes."""
    dp, mp = dp_axes(mesh), mp_axes(mesh)
    seq_ax = mp[0] if (sp and mp and seq_len and seq_len % mesh.shape[mp[0]] == 0) else None
    return (dp if batch_div else None, seq_ax, None)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks, this
    process rank 0, destroyed on exit. Raises if a default group exists: a
    real group is never reused."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised; the dry run starts "
                           "its own fake group and never reuses another")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=world_size, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


_BLOCK = 512  # the CUDA caching allocator rounds every block up to 512 bytes


class _Counts(torch.utils._python_dispatch.TorchDispatchMode):
    """One dispatch mode for three counts: FLOPs (``FlopCounterMode``'s
    registry, ``torch.utils.flop_counter.flop_registry``, applied to each
    op as that mode applies it; one mode instead of two, whose overhead per
    op dominates a fake run), bytes accessed (every aten op's input and
    output tensor bytes) and the live bytes of every storage an op makes or
    ``track`` is given, each rounded up to the allocator's 512-byte block
    and freed when its last tensor goes (a finalizer on the storage): the
    peak is the most live at once."""

    _SKIP = {"empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided",
             "detach", "alias", "lift_fresh", "set_"}

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_fns = flop_registry
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._ids = set()

    def track(self, t) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._ids:
            return
        n = -(-st.nbytes() // _BLOCK) * _BLOCK
        self._ids.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._ids.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        fn = self._flop_fns.get(func.overloadpacket)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        if func.namespace in ("aten", "prims"):
            for t in _tensors(out):
                self.track(t)
            if not func.is_view and func._schema.name.split("::")[-1] not in self._SKIP:
                self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0


def count_run(fn, resident) -> tuple:
    """Run ``fn()`` once under the counters; ``resident``: the tensors live
    before it (the state, the batch) whose bytes count toward the peak.
    Returns (fn's result, counts): ``flops`` (aten + kernels), ``flops_aten``
    (the aten ops alone: what ``FlopCounterMode`` counts), ``bytes``,
    ``peak_bytes``, ``resident_bytes``,
    ``after_bytes`` (live after the call), ``payload`` / ``coll_bytes``
    (the collectives' payload and wire bytes, ``launch.mesh``),
    ``collectives``, ``launches`` (the kernels' fake launches)."""
    leaves = [t for t in tree_leaves(resident) if isinstance(t, torch.Tensor)]
    meshlib.reset_collective_bytes()
    ops.reset_fake_costs()
    counts = _Counts()
    for t in leaves:
        counts.track(t)
    resident_bytes = counts.live
    with counts:
        out = fn()
    coll = meshlib.collective_bytes()
    kern = ops.fake_costs()
    return out, {"flops": counts.flops + kern["flops"], "flops_aten": counts.flops,
                 "bytes": counts.bytes + kern["bytes"],
                 "peak_bytes": counts.peak, "resident_bytes": resident_bytes,
                 "after_bytes": counts.live, "payload": coll["total"],
                 "coll_bytes": coll["wire"]["total"], "collectives": coll,
                 "launches": kern["launches"]}


def _memory_record(counts, hbm_bytes) -> dict:
    arg = int(counts["resident_bytes"])
    out = max(0, int(counts["after_bytes"]) - arg)
    temp = max(0, int(counts["peak_bytes"]) - arg - out)
    return memory_summary(AllocatorAnalysis(arg, out, temp), hbm_bytes=hbm_bytes)


def _mesh_name(mesh) -> str:
    return "x".join(map(str, mesh.devices_shape))


def _runtime(mesh, policy_entry, *, batch_div, seq_len, sp, accum, device) -> Runtime:
    dp, mp = dp_axes(mesh), mp_axes(mesh)
    policy, tp_sketch = policy_entry if policy_entry is not None else (None, False)
    return Runtime(policy=policy, device=device, execution=ExecutionConfig(
        mesh=mesh, act_sharding=_act_sharding(mesh, batch_div, seq_len, sp),
        data_axes=dp, model_axes=mp, tp_sketch=tp_sketch, accum=accum))


def _n_dp(mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def _run_train(cfg, cell, mesh, policy_entry, sp, accum, mode, device):
    runtime = _runtime(mesh, policy_entry, batch_div=cell.global_batch % _n_dp(mesh) == 0,
                       seq_len=cell.seq_len, sp=sp, accum=accum, device=device)
    opt = adamw(cosine_warmup(3e-4, 2000, 100_000), weight_decay=0.1, clip=1.0)
    with mode:
        state = runtime.init_state(0, cfg, opt, params=ispec.params_struct(cfg, mode=mode,
                                                                           device=device))
        from repro_torch.data.pipeline import shard_batch

        batch = shard_batch(ispec.train_inputs(cfg, cell, mode=mode, device=device), mesh=mesh)
        step = runtime.train_step(cfg, opt)
        _, counts = count_run(lambda: step(state, batch, 0),
                              (state.params, state.opt_state, batch))
    return counts, runtime, state.params


def _run_prefill(cfg, cell, mesh, sp, mode, device):
    runtime = _runtime(mesh, None, batch_div=cell.global_batch % _n_dp(mesh) == 0,
                       seq_len=cell.seq_len, sp=sp, accum=1, device=device)
    with mode:
        params = sharding.shard_params(ispec.params_struct(cfg, mode=mode, device=device), mesh)
        batch = ispec.train_inputs(cfg, cell, mode=mode, device=device)
        batch.pop("labels")
        fn = runtime.prefill_step(cfg, cell.seq_len)
        with torch.no_grad():
            _, counts = count_run(lambda: fn(params, batch), (params, batch))
    return counts, runtime, params


def _run_decode(cfg, cell, mesh, mode, device):
    # decode keeps the fixed layout (JAX passes seq_len=0: no sequence axis)
    runtime = _runtime(mesh, None, batch_div=cell.global_batch % _n_dp(mesh) == 0,
                       seq_len=0, sp=False, accum=1, device=device)
    with mode:
        params = sharding.shard_params(ispec.params_struct(cfg, mode=mode, device=device), mesh)
        dec = ispec.decode_inputs(cfg, cell, mode=mode, device=device)
        caches = sharding.shard_caches(dec["caches"], mesh, cell.global_batch)
        fn = runtime.decode_step(cfg)
        with torch.no_grad():
            _, counts = count_run(lambda: fn(params, caches, dec["tokens"], dec["pos"]),
                                  (params, caches, dec["tokens"]))
    return counts, runtime, params


def _run(cfg, cell, mesh, policy_entry, sp, accum, device):
    mode = ispec.fake_mode()
    if cell.kind == "train":
        return _run_train(cfg, cell, mesh, policy_entry, sp, accum, mode, device)
    if cell.kind == "prefill":
        return _run_prefill(cfg, cell, mesh, sp, mode, device)
    return _run_decode(cfg, cell, mesh, mode, device)


def depth_prediction(points, n_full: int, rem: int) -> dict:
    """JAX's depth model ``cost = a + b·n_full + c·rem`` at (``n_full``,
    ``rem``), for every key of the points' counts. :func:`_depth_points`
    gives two points (1, 0) and (2, 0), or three (0, 1), (1, 0) and (2, 0):
    the model goes through each, so its coefficients are the points'
    differences (``c`` is 0 where no point has a remainder, as JAX's
    least-squares fit gives). Integer counts stay integers: FLOPs and bytes
    of a production cell pass 2^53, where a float64 fit rounds."""
    by = {(nf, rm): c for nf, rm, c in points}
    out = {}
    for k in points[0][2]:
        b = by[(2, 0)][k] - by[(1, 0)][k]
        a = by[(1, 0)][k] - b
        c = by[(0, 1)][k] - a if (0, 1) in by else 0
        out[k] = a + b * n_full + c * rem
    return out


def _active_params(params, cfg) -> int:
    """JAX's ``_active_params``: every parameter, the stacked expert weights
    counted at ``top_k / n_experts``."""
    total = sum(t.numel() for t in tree_leaves(params) if isinstance(t, torch.Tensor))
    if cfg.n_experts == 0:
        return total
    e = sum(layer["moe"][k].numel() for layer in params["layers"] if "moe" in layer
            for k in ("wi", "wo", "wg") if k in layer["moe"])
    return total - e + int(e * cfg.top_k / cfg.n_experts)


_COST_KEYS = ("flops", "bytes", "coll_bytes", "payload", "peak_bytes")


def _costs(counts) -> dict:
    """The depth model's metrics of one run: ``cost_summary``'s FLOPs and
    bytes, the wire and payload bytes, the peak."""
    return dict(cost_summary(counts), coll_bytes=counts["coll_bytes"],
                payload=counts["payload"], peak_bytes=counts["peak_bytes"])


def run_cell(arch: str, cell_name: str, *, multi_pod: bool = False, policy_name: str = "mask",
             skip_cost: bool = False, sp: bool = True, hw: HW = HW(), cfg=None,
             cell: ShapeCell = None, mesh_shape=None, coverage: bool = True,
             full_depth: bool = True) -> dict:
    """One dry-run record (JAX's keys; module docstring). ``cfg``, ``cell``
    and ``mesh_shape`` override the named config, the shape cell and the
    production mesh (the tests' smoke configs and small worlds).
    ``full_depth=False``: no full-depth run; the memory record too comes
    from the depth model, fitted to the depth points run at the cell's
    accumulation count (``depth_used`` says which)."""
    if skip_cost and not full_depth:
        raise ValueError("full_depth=False predicts from the cost points: skip_cost needs the "
                         "full-depth run")
    cfg = cfg or get_config(arch)
    cell = cell or SHAPE_CELLS[cell_name]
    device = "cpu"  # the fake tensors' (module docstring)
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if len(mesh_shape) == 3 else ("data", "model")
    world = math.prod(mesh_shape)
    with fake_group(world):
        mesh = meshlib.make_mesh(mesh_shape, axes, device="cpu")
        return _record(arch, cfg, cell, mesh, policy_name, skip_cost, sp, hw, device,
                       coverage, full_depth)


_MEM_KEYS = ("peak_bytes", "resident_bytes", "after_bytes")


def _record(arch, cfg, cell, mesh, policy_name, skip_cost, sp, hw, device, coverage,
            full_depth=True):
    chips = mesh.size
    policy = _POLICIES[policy_name] if cell.kind == "train" else None
    rec = {"arch": arch, "cell": cell.name, "mesh": _mesh_name(mesh), "chips": chips,
           "kind": cell.kind, "policy": policy_name if cell.kind == "train" else "n/a",
           "status": "ok", "sp": sp, "device": device,
           "depth_used": "full" if full_depth else "depth_model"}
    accum = TRAIN_ACCUM.get(cfg.name.replace("-", "_"), 1) if cell.kind == "train" else 1
    rec["accum"] = accum
    t0 = clock.now()
    measured = None
    if full_depth:
        # the memory record, and the counts the depth model predicts
        full, _, _ = _run(cfg, cell, mesh, policy, sp, accum, device)
        rec["memory"] = _memory_record(full, hw.hbm_bytes)
        rec["launches"] = full["launches"]
        rec["rolled_collectives"] = collective_totals(full["collectives"])
        if accum > 1:
            # the cost points and their prediction run accum=1
            full, _, _ = _run(cfg, cell, mesh, policy, sp, 1, device)
        measured = _costs(full)
        rec["cost_measured"] = dict(measured, flops_aten=full["flops_aten"])
    if not skip_cost:
        pts, mem_pts = [], []
        for L, n_full, rem in _depth_points(cfg):
            cfg_L = _adjust_for_depth(cfg, L)
            c, _, _ = _run(cfg_L, cell, mesh, policy, sp, 1, device)
            pts.append((n_full, rem, _costs(c)))
            if not full_depth:
                if accum > 1:
                    c, _, _ = _run(cfg_L, cell, mesh, policy, sp, accum, device)
                mem_pts.append((n_full, rem, {k: c[k] for k in _MEM_KEYS}))
        n_full_t, rem_t = _depth_target(cfg)
        pred = depth_prediction(pts, n_full_t, rem_t)
        rec["cost_points"] = [{"n_full": nf, "rem": rm, **c} for nf, rm, c in pts]
        rec["cost_full_depth"] = pred
        if full_depth:
            rec["depth_check"] = _depth_check(pred, measured)
        else:
            mem = depth_prediction(mem_pts, n_full_t, rem_t)
            rec["memory"] = _memory_record(mem, hw.hbm_bytes)
            rec["rolled_collectives"] = {"total": pred["coll_bytes"], "predicted": True}
        mp = mp_axes(mesh)
        rec["roofline"] = roofline_terms(pred["flops"], pred["bytes"], pred["coll_bytes"],
                                         chips, hw, dtype=cfg.dtype,
                                         group_size=max(mesh.axis_size(mp), 2))
        shapes = lm.param_shapes(cfg)
        n_total = sum(t.numel() for t in tree_leaves(shapes))
        n_active = _active_params(shapes, cfg)
        tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
        mf = (6 if cell.kind == "train" else 2) * n_active * tokens
        rec["model_flops"] = mf
        rec["n_params"] = n_total
        rec["n_active_params"] = n_active
        glob = pred["flops"] * chips
        rec["model_flops_ratio"] = mf / glob if glob else None
        if cell.kind == "train" and policy is not None and policy[0] is not None:
            from repro_torch.telemetry.sinks import join_hlo_cost, site_cost_table, table_totals

            table = site_cost_table(shapes, policy[0], tokens, n_layers=cfg.n_layers,
                                    layer_paths=lm.jax_layer_paths(cfg),
                                    encoder_paths=lm.jax_layer_paths(cfg, encoder=True))
            rec["cost_attribution"] = {"sites": join_hlo_cost(table, pred),
                                       "totals": table_totals(table)}
    rec["compile_s"] = round(clock.now() - t0, 2)
    if coverage and cell.kind == "train" and policy is not None and policy[0] is not None:
        rec["coverage"] = _coverage(cfg, cell, policy[0], rec, chips, device)
    return rec


def _depth_check(pred, measured) -> dict:
    """The depth model's prediction against the full-depth run: FLOPs, bytes
    and payload exactly, wire bytes and peak memory relatively."""
    out = {}
    for k in _COST_KEYS:
        pred_k, m = pred[k], measured[k]
        out[k] = {"predicted": pred_k, "measured": m,
                  "exact": pred_k == m, "rel_err": abs(pred_k - m) / m if m else 0.0}
    return out


def _coverage(cfg, cell, policy, rec, chips, device) -> dict:
    # an analyzer failure must not sink the sweep: it is recorded in the cell
    try:
        from repro_torch.analysis.coverage import analyze_runtime, check_baseline

        mode = ispec.fake_mode()
        with mode:
            rep = analyze_runtime(Runtime(policy=policy, device=device), cfg,
                                  batch_size=cell.global_batch, seq_len=cell.seq_len,
                                  device=device,
                                  params=ispec.params_struct(cfg, mode=mode, device=device))
        gate = check_baseline(rep)
        flops = (rec.get("cost_full_depth") or rec["cost_measured"])["flops"]
        return {**rep.summary(), "escaped_frac_vs_hlo": rep.escaped_frac_vs_hlo(flops * chips),
                "baseline_ok": gate.ok, "baseline_used": gate.used,
                "baseline_message": gate.message()}
    except Exception:  # lint: waive=swallowed-exception — an analyzer fault is the record's
        return {"error": traceback.format_exc(limit=3)}


def record_or_error(arch: str, cell_name: str, **kw) -> dict:
    """:func:`run_cell`, or the record of its failure: JAX's sweep records a
    failing cell and keeps sweeping (a cell the port refuses names its
    ROADMAP item in its error)."""
    try:
        return run_cell(arch, cell_name, **kw)
    except Exception as e:  # lint: waive=swallowed-exception — a failing cell is the record
        return {"arch": arch, "cell": cell_name, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--policy", default="mask", choices=list(_POLICIES))
    ap.add_argument("--skip-cost", action="store_true")
    ap.add_argument("--no-sp", action="store_true", help="disable sequence-parallel activations")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--depth-model", action="store_true",
                    help="no full-depth run: the memory record from the depth model")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    jobs = []
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    for a in archs:
        cells = [c.name for c in cells_for(get_config(a))]
        if args.cell:
            cells = [args.cell] if args.cell in cells else []
        jobs += [(a, c) for c in cells]
    for a, c in jobs:
        tag = f"{a}.{c}.{'2x16x16' if args.multipod else '16x16'}.{args.policy}"
        if args.no_sp:
            tag += ".nosp"
        out_path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(out_path):
            try:
                with open(out_path) as f:
                    cached = json.load(f)
            except (OSError, ValueError):
                cached = None  # unreadable: recompute the cell
            if isinstance(cached, dict) and cached.get("status") == "ok":
                print(f"=== {tag} === (cached)", flush=True)
                continue
        print(f"=== {tag} ===", flush=True)
        rec = record_or_error(a, c, multi_pod=args.multipod, policy_name=args.policy,
                              skip_cost=args.skip_cost, sp=not args.no_sp,
                              full_depth=not args.depth_model)
        if rec["status"] == "ok":
            mem = rec["memory"]
            print(f"  peak/dev: {mem['peak_GB_per_dev']:.2f} GB (fits={mem['fits_hbm']}) "
                  f"run: {rec['compile_s']}s", flush=True)
            if "roofline" in rec:
                r = rec["roofline"]
                print(f"  roofline: compute {r['compute_s']:.4f}s | memory {r['memory_s']:.4f}s"
                      f" | collective {r['collective_s']:.4f}s -> {r['dominant']}-bound",
                      flush=True)
        else:
            print(f"  FAILED: {rec['error']}", flush=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1, default=str)


if __name__ == "__main__":
    main()
