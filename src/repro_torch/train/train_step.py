"""Training step factory (port of the local path of ``repro/train/train_step.py``).

A step takes ``(state, batch, key)``: the batch as numpy or tensors, and the
step's integer seed, from which every sketched site derives its own
generator (step → layer → role). Gradients come from one backward through
the sketched sites' autograd Function; the optimizer updates in place.

Compact gradients (``ExecutionConfig(compact_grads=True)``): before the loss,
every compact site gets a gradient slot (``core/compact_grad.py``), whose
backward fills it with the kept dW rows and their indices instead of a dense
dW. The step differentiates every leaf but the slotted weights and folds the
slots back into the gradient tree as ``CompactGrad`` leaves, which the
gradient norm, the clipping and the optimizer take as they are. Slots are
made per step and never reach ``opt.init`` or the optimizer's moments.

Plan carry (``onepass``, ``stale``): the carry leaves are parameters, so the
backward returns their refreshed scores among the gradients. The step takes
them out (zeroing those gradients) before the gradient norm, the clipping and
the optimizer, and writes them over the carry after the update
(``core/plan_state.py``). A site can hold both a gradient slot and a carry
leaf.

Telemetry probes (``ExecutionConfig(telemetry=TelemetryConfig())`` with a
policy and ``accum == 1``): every probe-capable site gets a fresh probe slot
(``telemetry/probes.py``) before the loss; the step takes the slots'
gradients, the probe vectors, out of the gradient tree and merges their
summary into the metrics. Probes change no gradient: a step with them equals
the step without them bit for bit.

Gradient accumulation (``accum = k > 1``): the batch splits on its batch
axis into k microbatches (axis 0; axis 1 of M-RoPE's ``[3, B, S]``
positions); microbatch ``m`` runs under the seed :func:`micro_seed` ``(key,
m)`` = ``rng.fold_in(key, m)``, so no two microbatches share randomness. The
loss and every gradient are averaged over the microbatches (``acc + g / k``
from zeros, the order of JAX's scan), the refreshed plan carries with them,
and every microbatch samples from the same carry, the state's. The metrics
besides ``loss`` and ``grad_norm`` are the last microbatch's, as in JAX.

Resilience (``ExecutionConfig(resilience=ResilienceConfig())``): the step
takes a fourth argument, ``fault_scale``, a Python float that multiplies the
loss (of every microbatch) before the backward: 1.0 in normal operation, a
bitwise identity; NaN or a large value under fault injection. With
``sentinel=True`` the step computes ``ok`` from the loss and the gradient
norm (``resilience.sentinel.trip_flag``), reads it once on the host and,
when it is false, skips the optimizer update and the plan-carry write: the
parameters, the moments and the carry stay bit for bit as they were, the
step counter advances, and ``metrics["sentinel_trip"]`` is 1.0. JAX computes
the new state and selects old or new leaf by leaf; the port's optimizers
update in place, so there is no old state left to select, and a copy to
select from would add the parameters' and moments' footprint to the step's
peak (docs/port.md, "Resilience").

Under a mesh (``ExecutionConfig(mesh=...)``; the dense decoder family): the
state holds this rank's shards (:func:`init_state` cuts them by
``launch.sharding.param_specs``) and the step takes this rank's rows of the
batch (``data.pipeline.shard_batch``). Every rank runs the same step. Each
rank's loss is its rows' mean over the number of data ranks, so the ranks'
partial gradients sum to the gradient of the global mean; the sites'
backwards (``core/site.py``) reduce their weights' and biases' gradients
over the data axes themselves (the compact block, reduce-scattered to the
shard), and the step sums every other leaf's (the embedding, the norms)
over them, as GSPMD does implicitly in JAX. A compact gradient keeps the
rows of this rank's shard (``compact_grad.localize_compact``), and the
gradient norm sums the sharded leaves over their axes. On a one-rank mesh
the step is the single-device step, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import rng
from repro_torch.api.execution import ExecutionConfig
from repro_torch.configs.base import ArchConfig
from repro_torch.core import SketchPolicy
from repro_torch.core import compact_grad as cgrad
from repro_torch.core import plan_state as pstate
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import psum
from repro_torch.models import lm
from repro_torch.optim import Optimizer, global_grad_norm
from repro_torch.resilience.sentinel import trip_flag
from repro_torch.telemetry import probes as tprobes
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["TrainState", "init_state", "make_train_step", "batch_to_device", "micro_seed"]


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int = 0


def _trainable(params) -> None:
    for p in tree_leaves(params):
        if p.is_floating_point() and not p.requires_grad:
            p.requires_grad_(True)


def init_state(seed: int, cfg: ArchConfig, opt: Optimizer, *, params=None,
               device="cuda", policy: Optional[SketchPolicy] = None,
               execution: Optional[ExecutionConfig] = None) -> TrainState:
    """Fresh train state: random parameters from ``seed`` (or the given
    ``params``, whole), the optimizer's initial state, step 0. With a
    plan-carry ``policy`` every carry-capable site gets its carry leaf (the
    uniform prior); without it a carry policy still runs, but every step
    samples from the uniform prior. Under ``execution.mesh`` the state holds
    this rank's shards of the parameters and moments."""
    ex = execution or ExecutionConfig()
    if params is None:
        params = lm.init_params(seed, cfg, device=device)
    if ex.mesh is not None:
        from repro_torch.launch import sharding

        lm.check_mesh(cfg)
        params = sharding.shard_tree(params, sharding.param_specs(params, ex.mesh), ex.mesh)
    if pstate.policy_uses_carry(policy):
        params = pstate.with_plan_state(params, policy, n_layers=cfg.n_layers,
                                        **ex.slot_kwargs())
    _trainable(params)
    opt_state = opt.init(params)
    if ex.mesh is not None:
        for k in opt_state:
            sharding.mark_like(opt_state[k], params)
    return TrainState(params=params, opt_state=opt_state, step=0)


def batch_to_device(batch, device) -> dict:
    """Tensors on ``device``; token ids and labels (``y`` for the MLP) as
    int64. A host array bound for a CUDA device is pinned first, so its
    ``non_blocking`` copy does not make the host wait."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if k in ("tokens", "labels", "y"):
            t = t.long()
        if dev.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(dev, non_blocking=True)
    return out


def micro_seed(key: int, m: int) -> int:
    """The seed of microbatch ``m`` of an accumulated step whose seed is ``key``."""
    return rng.fold_in(key, m)


def _split_batch(batch: dict, accum: int) -> list:
    """``accum`` microbatches of ``batch``: microbatch ``m`` holds rows
    ``[m B/accum, (m+1) B/accum)`` of every entry, on axis 0, except M-RoPE's
    ``positions`` [3, B, S], on axis 1 (as JAX's ``to_micro``). B comes from
    an entry that is batch-major."""
    def axis(k, v):
        return 1 if k == "positions" and v.dim() == 3 else 0

    B = next(v.shape[0] for k, v in batch.items() if axis(k, v) == 0)
    if B % accum:
        raise ValueError(f"a batch of {B} rows does not split into {accum} microbatches")
    b = B // accum
    return [{k: v.narrow(axis(k, v), m * b, b) for k, v in batch.items()}
            for m in range(accum)]


def _site_leaf(path) -> bool:
    """A linear site's weight or bias (their backwards reduce over data)."""
    from repro_torch.core.site import site_role

    if len(path) < 2 or path[-1] not in ("w", "b"):
        return False
    return path[-2] == "lm_head" or site_role(path[:-1]) is not None


def _sum_over_data(grads, mesh, dp):
    """Sum over the data axes every gradient leaf that no site reduced (the
    embedding, the norms): one all-reduce of their concatenation. The slots'
    gradients (probes, refreshed carries) come out of their sites whole."""
    picked = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                if k not in (cgrad.GRAD_SLOT, tprobes.PROBE_SLOT, pstate.PLAN_SLOT):
                    walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        elif isinstance(node, torch.Tensor) and not _site_leaf(path):
            picked.append(node)

    walk(grads, ())
    if picked:
        flat = psum(torch.cat([t.reshape(-1).to(torch.float32) for t in picked]), dp, mesh)
        off = 0
        for t in picked:
            t.copy_(flat[off:off + t.numel()].view_as(t).to(t.dtype))
            off += t.numel()
    return grads


def make_train_step(cfg: ArchConfig, opt: Optimizer, policy: Optional[SketchPolicy] = None,
                    *, execution: Optional[ExecutionConfig] = None, device="cuda"):
    """Returns ``step_fn(state, batch, key) -> (state, metrics)``, or with
    ``execution.resilience`` set ``step_fn(state, batch, key, fault_scale)``;
    ``metrics`` holds tensors that the caller may fetch: the loss's metrics
    (``acc`` for the MLP), ``loss``, ``grad_norm``, with probes on the probe
    summary (``probe_gsq``, ``probe_var``, ``probe_snr``, ``probe_align``
    and, with ``per_site``, the dict ``probe_sites``) and with the sentinel
    on ``sentinel_trip``."""
    ex = execution or ExecutionConfig()
    dev = resolve_device(device)
    lm.check_supported(cfg)
    mesh = ex.mesh
    dp = ex.axes_in_mesh()[0]
    n_dp = 1 if mesh is None else mesh.axis_size(dp)
    if mesh is not None:
        lm.check_mesh(cfg)
    slot_kw = ex.slot_kwargs()
    carry_on = pstate.policy_uses_carry(policy)
    tel = ex.telemetry
    probes_on = tel is not None and tel.probes and policy is not None and ex.accum == 1
    rcfg = ex.resilience
    layer_paths = lm.jax_layer_paths(cfg) if cfg.family != "mlp" else None
    encoder_paths = lm.jax_layer_paths(cfg, encoder=True) if cfg.family != "mlp" else None

    def grads_of(params_in, batch, key, fault_scale):
        ctx = ex.make_ctx(policy=policy, key=key, n_layers=cfg.n_layers)
        loss, metrics = lm.lm_loss(params_in, batch, ctx, cfg, key)
        if fault_scale is not None:
            loss = loss * fault_scale  # 1.0: a bitwise identity
        # a slotted weight's gradient leaves through its slot: it is not
        # differentiated (its Function returns None for it)
        targets = cgrad.grad_targets(params_in)
        leaves = [t for t in tree_leaves(targets) if isinstance(t, torch.Tensor)]
        # a leaf no site read (a carry leaf under an exact bucket) gets zeros,
        # as JAX's gradient of an unused input
        flat = iter(g if g is not None else torch.zeros_like(t) for g, t in
                    zip(torch.autograd.grad(loss, leaves, allow_unused=True), leaves))
        grads = tree_map(lambda t: next(flat) if isinstance(t, torch.Tensor) else t, targets)
        loss = loss.detach()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if n_dp > 1:
            grads = _sum_over_data(grads, mesh, dp)
            loss = psum(loss, dp, mesh)
            metrics = {k: psum(v, dp, mesh) if v.dim() == 0 else v for k, v in metrics.items()}
        return loss, metrics, grads

    def accumulated(params, batch, key, fault_scale):
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params)
        for m, mb in enumerate(_split_batch(batch, ex.accum)):
            mloss, metrics, grads = grads_of(params, mb, micro_seed(key, m), fault_scale)
            loss = loss + mloss / ex.accum
            for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                a.add_(g / ex.accum)
        return loss, metrics, acc

    def base_step(state: TrainState, batch, key: int, fault_scale):
        lm.check_recurrent_segments(cfg, batch.get("segments"))  # on the host, before the copy
        batch = batch_to_device(batch, dev)
        _trainable(state.params)
        probe_metrics = {}
        if ex.accum == 1:
            params_in = state.params
            if ex.compact_grads:
                # fresh slots for this step: host objects, nothing on the card
                params_in = cgrad.with_grad_slots(params_in, policy, n_layers=cfg.n_layers,
                                                  **slot_kw)
            if probes_on:
                params_in = tprobes.with_probe_slots(params_in, policy, n_layers=cfg.n_layers,
                                                     **slot_kw)
            loss, metrics, grads = grads_of(params_in, batch, key, fault_scale)
            if probes_on:
                grads, vecs = tprobes.collect_probes(grads)
                probe_metrics = tprobes.summarize(vecs, per_site=tel.per_site,
                                                  layer_paths=layer_paths,
                                                  encoder_paths=encoder_paths)
            grads = cgrad.fold_slot_grads(grads)
            if mesh is not None and ex.compact_grads:
                grads = cgrad.localize_compact(grads, state.params)
        else:
            loss, metrics, grads = accumulated(state.params, batch, key, fault_scale)
        fresh = {}
        if carry_on:
            # the carry leaves' gradients ARE the refreshed scores (averaged
            # over the microbatches): take them out before the norm, the
            # clipping and the moments see them
            grads, fresh = pstate.collect_plan_state(grads)
        gn = global_grad_norm(grads, state.params if mesh is not None else None)
        ok = True
        if rcfg is not None and rcfg.sentinel:
            ok_t, tripped = trip_flag(loss, gn, rcfg.max_grad_norm)
            probe_metrics = dict(probe_metrics, sentinel_trip=tripped)
            # the one host read of the gate: the loop fetches the step's
            # scalars right after it anyway
            ok = bool(ok_t)  # lint: waive=host-sync-in-step — the gate's one read
        if ok:
            params, opt_state = opt.update(grads, state.opt_state, state.params, state.step)
            # after the update: the optimizer saw zero gradients on the carry
            params = pstate.write_plan_state(params, fresh)
        else:
            # tripped: the moments must not take in a poisoned gradient, nor
            # the carry its scores; the step counter still advances
            params, opt_state = state.params, state.opt_state
        new_state = TrainState(params=params, opt_state=opt_state, step=state.step + 1)
        return new_state, dict(metrics, loss=loss, grad_norm=gn, **probe_metrics)

    if rcfg is None:
        def step_fn(state: TrainState, batch, key: int):
            return base_step(state, batch, key, None)
    else:
        def step_fn(state: TrainState, batch, key: int, fault_scale: float):
            return base_step(state, batch, key, fault_scale)

    return step_fn
