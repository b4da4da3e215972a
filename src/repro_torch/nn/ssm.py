"""State-space sequence mixers: Mamba2 (SSD) and RWKV6 (Finch).

Port of ``repro/nn/ssm.py``. Both keep the recurrence core exact (the paper
sketches linear VJPs; the in/out projections, which dominate the FLOPs, are
sketched sites). Training and prefill run the chunked forms: the outer loop
over chunks is a Python loop whose every chunk is recomputed in the backward
(``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` around the chunk), so
the backward holds one state per chunk, not one per token. Decode is a
single-step state update.

Three departures from the reference in ``_ssd_chunk``, all for the same
function (see the comments there):

* it masks the decay's exponent before the ``exp`` (JAX masks its result):
  the same forward values, and a finite gradient at the full configs' chunk
  of 256, where JAX's dt gradient is NaN;
* it sums each intra-chunk decay's exponent over its own segment instead of
  differencing two cumulative sums: at a chunk of 256 JAX's output keeps
  ~1e-5 of relative accuracy, the port's ~1e-7 (against a float64
  recurrence);
* its four-operand einsums are contracted pairwise in a stated order, so no
  ``[B, Q, Q, H, P]`` intermediate is built.

JAX's ``cost_mode`` (python-unrolled loops for HLO cost artifacts) has no
counterpart: the port's chunk loop is always a Python loop.

Under a mesh (training) the blocks' linears run through ``dense`` with JAX's
roles, so Mamba2's ``in_x``/``in_z`` (``ssm_in``) and RWKV6's
``r``/``k``/``v``/``g`` take column plans (``tp_column`` under
``tp_sketch``, else the local plan split by columns) and their out
projections row plans; ``in_B``/``in_C``/``in_dt`` (``ssm_small``),
``w1``/``w2`` and the small leaves stay whole. The recurrence runs on this rank's heads where
every projection feeding it ran column-parallel and the heads divide the
model axis (the conv leaf, stored as its model chunk of channels by the
sharding rules, is then used as it is, the per-head leaves are cut to this
rank's heads, and the RMS norm over the channels sums its squares over
model); otherwise each model-sharded projection is all-gathered over model
and the recurrence runs on every head, as ``nn.attention._mesh_heads``
does. Mamba2's part between the projections and the norm is
:func:`mamba_heads`, a function of the heads it is given
(:func:`head_leaves` cuts them by offset and count), and the norm of a
shard takes the channels' sum of squares from outside
(:func:`shard_rmsnorm`): the mesh sums it over model, one device emulating
the shards sums it itself. Serving under a mesh (prefill with a cached state, and decode) always
runs it on every head: the cached states hold every head, batch over data
only (``launch.sharding.cache_specs``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.nn.common import (MODEL_SHARDED_OUT, Ctx, dense, dense_init, rmsnorm,
                                   rmsnorm_init)

__all__ = ["MambaCfg", "mamba_init", "mamba_block", "mamba_prefill", "mamba_decode",
           "mamba_state_init", "mamba_heads", "head_leaves", "shard_rmsnorm", "sum_squares",
           "RWKVCfg", "rwkv_init", "rwkv_time_mix", "rwkv_channel_mix", "rwkv_state_init"]


def _remat(fn, *args):
    """``fn(*args)``, recomputed in the backward when autograd records it.
    The chunk functions draw no random numbers, so no RNG state is kept."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _pad_steps(t, n: int, value: float = 0.0):
    """``t`` [B, S, ...] with ``n`` more steps of ``value`` on axis 1."""
    if n == 0:
        return t
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, n), value=value)


# ---------------------------------------------------------------------------
# Mamba2 (SSD) — arXiv:2405.21060, scalar-decay-per-head chunked form.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_model: int
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    d_conv: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def mamba_init(gen, cfg: MambaCfg, dtype=torch.float32, device="cpu"):
    """Split projections (z/x/B/C/dt), as in JAX; the short causal conv runs
    on x only."""
    di, N, H = cfg.d_inner, cfg.d_state, cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_z": dense_init(gen, cfg.d_model, di, dtype, device=device),
        "in_x": dense_init(gen, cfg.d_model, di, dtype, device=device),
        "in_B": dense_init(gen, cfg.d_model, N, dtype, device=device),
        "in_C": dense_init(gen, cfg.d_model, N, dtype, device=device),
        "in_dt": dense_init(gen, cfg.d_model, H, dtype, device=device),
        "conv": (torch.randn((cfg.d_conv, di), generator=gen, **f32) * 0.1).to(dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones(H, **f32),
        "dt_bias": torch.full((H,), -2.0, **f32),
        "norm": rmsnorm_init(di, dtype, device),
        "out": dense_init(gen, di, cfg.d_model, dtype, device=device, scale=di ** -0.5),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x: [B, S, C], w: [K, C], state: [B, K-1, C] or
    None. Returns (silu(conv), the last K-1 inputs as the new state)."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        pad = x.new_zeros(x.shape[:1] + (K - 1,) + x.shape[2:])
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(K - 1):].clone() if K > 1 else None
    return F.silu(out.to(torch.float32)).to(x.dtype), new_state


def _ssd_chunk(state, xc, dtc, dAc, Bc, Cc):
    """One SSD chunk. state: [B, H, P, N]; xc: [B, Q, H, P]; dtc, dAc: [B, Q,
    H]; Bc, Cc: [B, Q, N]. Returns (new_state, yc [B, Q, H, P])."""
    a = torch.log(torch.clamp_min(dAc, 1e-30))  # per-step log decay, [B,Q,H]
    la = torch.cumsum(a, dim=1)  # cumulative within the chunk
    # inter-chunk: y_i += exp(la_i) C_i · state
    y_inter = torch.einsum("bqn,bhpn->bqhp", Cc, state) * torch.exp(la)[..., None]
    # intra-chunk: y_i += Σ_{j<=i} exp(seg_ij) dt_j (C_i·B_j) x_j, where
    # seg_ij = Σ_{j<k<=i} a_k is JAX's la_i - la_j. Two departures, the same
    # function:
    # * each seg_ij is summed over its own segment (a cumsum down column j of
    #   the a_k below the diagonal), not taken as a difference of two
    #   cumulative sums: |la| reaches ~500-5,000 at a chunk of 256, and the
    #   difference of two such float32 sums near the diagonal carries an
    #   absolute error of eps·|la|, a relative error of up to ~3e-4 in the
    #   decay;
    # * the exponent is masked to -inf above the diagonal before the exp,
    #   where JAX masks the exp's result: there la_i - la_j > 0 reaches
    #   hundreds, exp overflows to inf, and the backward's 0 · inf is a NaN
    #   in the dt gradient. exp(-inf) = 0 gives the same forward values and
    #   a zero gradient there.
    Q = xc.shape[1]
    ones = torch.ones((Q, Q), dtype=torch.bool, device=xc.device)
    below = a[:, :, None, :].masked_fill(~ones.tril(-1)[None, :, :, None], 0.0)  # [B,k,j,H]
    seg = torch.cumsum(below, dim=1)  # [B,i,j,H]: Σ_{j<k<=i} a_k on and below the diagonal
    decay = torch.exp(seg.masked_fill(~ones.tril()[None, :, :, None], float("-inf")))
    CB = torch.einsum("bqn,bkn->bqk", Cc, Bc)  # [B,Q,Q] (q = query, k = key step)
    # contracted pairwise, (dt x) first: the four operands at once could build
    # a [B,Q,Q,H,P] intermediate
    y_intra = torch.einsum("bqkh,bkhp->bqhp", CB[..., None] * decay, dtc[..., None] * xc)
    # state' = exp(la_Q) state + Σ_j exp(seg_Qj) dt_j x_j B_jᵀ
    inject = (torch.exp(seg[:, -1]) * dtc)[..., None] * xc  # [B,Q,H,P]
    state_new = state * torch.exp(la[:, -1])[..., None, None] + torch.einsum(
        "bqhp,bqn->bhpn", inject, Bc)
    return state_new, y_inter + y_intra


def _ssd(x, dt, A, B, C, cfg: MambaCfg, state0):
    """x: [B, S, H, P], dt: [B, S, H], A: [H], B, C: [B, S, N] -> (y, state).
    A ragged S is padded with inert steps: dt = 0 gives a decay of 1 and no
    state injection."""
    S_in = x.shape[1]
    Q = min(cfg.chunk, S_in)
    pad = -S_in % Q
    x, dt, B, C = (_pad_steps(t, pad) for t in (x, dt, B, C))
    dA = torch.exp(-A[None, None, :] * dt)  # [B,S,H] decay per step
    state, ys = state0, []
    for xc, dtc, dAc, Bc, Cc in zip(*(torch.split(t, Q, dim=1) for t in (x, dt, dA, B, C))):
        state, yc = _remat(_ssd_chunk, state, xc, dtc, dAc, Bc, Cc)
        ys.append(yc)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    return y[:, :S_in], state


# -- under a mesh ------------------------------------------------------------

def _sharded_out(ctx: Ctx, p, role: str) -> bool:
    """Whether the plan of ``p``'s site gives an output sharded over model."""
    return ctx.plan_kind(role, p) in MODEL_SHARDED_OUT


def _heads_local(ctx: Ctx, params, roles: dict, n_heads: int) -> bool:
    """Whether a block runs its recurrence on this rank's heads: every
    projection in ``roles`` (name -> role) ran column-parallel and the heads
    divide the model axis."""
    return (ctx.mesh is not None and n_heads % ctx.n_mp == 0
            and all(_sharded_out(ctx, params[n], r) for n, r in roles.items()))


def _whole(t, ctx: Ctx, p, role: str):
    """A projection's output whole: all-gathered over model where its plan
    sharded it."""
    if ctx.mesh is None or not _sharded_out(ctx, p, role):
        return t
    from repro_torch.launch.mesh import gather_replicated

    return gather_replicated(t, ctx.model_axes, ctx.mesh, -1)


def _mine(t, ctx: Ctx, dim: int = -1):
    """This rank's model chunk of a tensor replicated over model (a per-head
    leaf, the whole decay); backward: the chunks' cotangents gathered."""
    from repro_torch.launch.mesh import slice_replicated

    return slice_replicated(t, ctx.model_axes, ctx.mesh, dim)


def _model_whole(w, ctx: Ctx, dim: int):
    """A leaf the rules shard over model along ``dim``, gathered whole
    (backward: this rank's chunk)."""
    from repro_torch.launch.mesh import gather_replicated
    from repro_torch.launch.sharding import dim_axes, spec_of

    spec = spec_of(w)
    if ctx.mesh is None or spec is None or not dim_axes(spec[dim]):
        return w
    return gather_replicated(w, dim_axes(spec[dim]), ctx.mesh, dim)


def sum_squares(x):
    """The sum of squares over the last axis in float32 (keepdim): what a
    shard of the channels contributes to their RMS norm."""
    return x.to(torch.float32).square().sum(-1, keepdim=True)


def shard_rmsnorm(x, g, ss, d: int, eps: float = 1e-6):
    """``rmsnorm`` of a chunk ``x`` of ``d`` channels whose sum of squares
    over all of them, ``ss`` [..., 1], is given (summed over the shards
    outside); ``g`` is the chunk's gain."""
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(ss / d + eps)
    return (y * g.to(torch.float32)).to(x.dtype)


def _norm(p, x, ctx: Ctx, local: bool, eps: float = 1e-6):
    """``rmsnorm`` over the channels; with ``local``, ``x`` holds this rank's
    chunk of them and the mean square is summed over model."""
    from repro_torch.launch.mesh import psum_partial

    if not local:
        return rmsnorm(p, x, eps)
    ss = psum_partial(sum_squares(x), ctx.model_axes, ctx.mesh)
    return shard_rmsnorm(x, _mine(p["g"], ctx, 0), ss, x.shape[-1] * ctx.n_mp, eps)


def _out_input(p, ctx: Ctx, role: str, h, local: bool):
    if ctx.mesh is None:
        return h
    from repro_torch.nn.attention import _mesh_out_input

    return _mesh_out_input(p, ctx, role, h, local)


_MAMBA_IN = {"in_z": "ssm_in", "in_x": "ssm_in"}


def _mamba_proj(params, x, ctx: Ctx, local=False):
    """The five projections; under a mesh with ``local``, dt cut to this
    rank's heads and B, C entering this rank's part (their cotangents are
    partial over model), else z and x whole."""
    z = dense(params["in_z"], x, ctx, "ssm_in")
    xs = dense(params["in_x"], x, ctx, "ssm_in")
    Bc = dense(params["in_B"], x, ctx, "ssm_small")
    Cc = dense(params["in_C"], x, ctx, "ssm_small")
    dt = dense(params["in_dt"], x, ctx, "ssm_small")
    if ctx.mesh is not None:
        if local:
            from repro_torch.launch.mesh import copy_to

            dt = _mine(dt, ctx)
            # B and C are shared by every head: this rank's heads give
            # partial cotangents
            Bc, Cc = (copy_to(t, ctx.model_axes, ctx.mesh) for t in (Bc, Cc))
        else:
            z, xs = _whole(z, ctx, params["in_z"], "ssm_in"), _whole(xs, ctx, params["in_x"],
                                                                     "ssm_in")
    return z, xs, Bc, Cc, dt


def head_leaves(params, lo: int, n: int, head_dim: int) -> dict:
    """The per-head leaves of heads ``[lo, lo + n)`` of a whole block's
    ``params``: the conv's channels of those heads, ``A_log``, ``D`` and
    ``dt_bias`` (what :func:`mamba_heads` reads), and the norm gain's
    channels (``g``, for :func:`shard_rmsnorm`)."""
    c0, c1 = lo * head_dim, (lo + n) * head_dim
    return {"conv": params["conv"][:, c0:c1], "g": params["norm"]["g"][c0:c1],
            **{k: params[k][lo:lo + n] for k in ("A_log", "D", "dt_bias")}}


def _mesh_leaves(params, ctx: Ctx, local: bool) -> dict:
    """The leaves :func:`mamba_heads` reads, of this rank: under a mesh with
    ``local`` its heads (the conv as the rules store it, the model chunk of
    its channels; the per-head leaves sliced, their cotangents gathered),
    else every head (the conv gathered where the rules shard it)."""
    p = {k: params[k] for k in ("conv", "A_log", "D", "dt_bias")}
    if ctx.mesh is None:
        return p
    if not local:
        return dict(p, conv=_model_whole(p["conv"], ctx, 1))
    return dict(p, **{k: _mine(p[k], ctx, 0) for k in ("A_log", "D", "dt_bias")})


def mamba_heads(leaves, z, xs, Bc, Cc, dt, cfg: MambaCfg, dtype, conv_state=None):
    """The Mamba2 block between its projections and its norm, on the heads
    that ``leaves`` (:func:`head_leaves`) and the inputs hold: one shard's
    part under a model split, every head otherwise. ``z``, ``xs`` [B, S, n
    P] (those heads' columns of the ``ssm_in`` projections), ``dt`` [B, S,
    n] before its bias and softplus, ``Bc``, ``Cc`` [B, S, N] (shared by
    every head). Returns (y [B, S, n P] in ``dtype``, gated by silu(z),
    before the norm; the final SSM state; the conv state)."""
    xs, new_conv = _causal_conv(xs, leaves["conv"], conv_state)
    dt = F.softplus(dt.to(torch.float32) + leaves["dt_bias"])
    Bsz, S = xs.shape[:2]
    H, P = leaves["A_log"].shape[0], cfg.head_dim
    xh = xs.reshape(Bsz, S, H, P).to(torch.float32)
    A = torch.exp(leaves["A_log"])
    state0 = xs.new_zeros((Bsz, H, P, cfg.d_state), dtype=torch.float32)
    y, state = _ssd(xh, dt, A, Bc.to(torch.float32), Cc.to(torch.float32), cfg, state0)
    y = (y + leaves["D"][None, None, :, None] * xh).reshape(Bsz, S, H * P)
    return y.to(dtype) * F.silu(z.to(torch.float32)).to(dtype), state, new_conv


def mamba_prefill(params, x, ctx: Ctx, cfg: MambaCfg, *, whole_heads: bool = False):
    """Training/prefill path. x: [B, S, d_model] -> (out [B, S, d_model],
    the final ``{"ssm", "conv"}`` state; JAX's ``lm._mamba_prefill``).
    ``whole_heads`` (a prefill that caches the state, which holds every
    head under a mesh): the recurrence runs on every head. On this rank's
    heads (``_heads_local``) the norm's sum of squares is summed over
    model: each rank runs :func:`mamba_heads` on its heads, as one device
    does on each of its emulated shards."""
    local = not whole_heads and _heads_local(ctx, params, _MAMBA_IN, cfg.n_heads)
    z, xs, Bc, Cc, dt = _mamba_proj(params, x, ctx, local)
    y, state, conv = mamba_heads(_mesh_leaves(params, ctx, local), z, xs, Bc, Cc, dt, cfg,
                                 x.dtype)
    y = _out_input(params["out"], ctx, "ssm_out", _norm(params["norm"], y, ctx, local), local)
    return dense(params["out"], y, ctx, "ssm_out"), {"ssm": state, "conv": conv}


def mamba_block(params, x, ctx: Ctx, cfg: MambaCfg):
    """Training path. x: [B, S, d_model] -> [B, S, d_model]."""
    return mamba_prefill(params, x, ctx, cfg)[0]


def mamba_state_init(batch: int, cfg: MambaCfg, dtype, device="cpu"):
    return {
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype, device=device),
    }


def mamba_decode(params, x, ctx: Ctx, cfg: MambaCfg, state):
    """Single-token step. x: [B, 1, d_model]; state: see mamba_state_init.
    Returns (out [B, 1, d_model], new state)."""
    Bsz = x.shape[0]
    H, P = cfg.n_heads, cfg.head_dim
    z, xs, Bc, Cc, dt = _mamba_proj(params, x, ctx)
    leaves = _mesh_leaves(params, ctx, False)
    xs, new_conv = _causal_conv(xs, leaves["conv"], state["conv"])
    dt = F.softplus(dt.to(torch.float32) + leaves["dt_bias"])
    xh = xs.reshape(Bsz, H, P).to(torch.float32)
    A = torch.exp(params["A_log"])
    dt1 = dt[:, 0]  # [B,H]
    dA = torch.exp(-A[None, :] * dt1)  # [B,H]
    inject = (dt1[..., None] * xh)[..., None] * Bc[:, 0].to(torch.float32)[:, None, None, :]
    s = state["ssm"] * dA[..., None, None] + inject
    y = torch.einsum("bhpn,bn->bhp", s, Cc[:, 0].to(torch.float32))
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(Bsz, 1, cfg.d_inner).to(x.dtype) * F.silu(z.to(torch.float32)).to(x.dtype)
    y = _out_input(params["out"], ctx, "ssm_out", rmsnorm(params["norm"], y), False)
    return dense(params["out"], y, ctx, "ssm_out"), {"ssm": s, "conv": new_conv}


# ---------------------------------------------------------------------------
# RWKV6 (Finch) — arXiv:2404.05892. Data-dependent per-channel decay.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RWKVCfg:
    d_model: int
    head_dim: int = 64
    d_ff: int = 0  # channel-mix hidden
    chunk: int = 64
    decay_lora: int = 64

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


def rwkv_init(gen, cfg: RWKVCfg, dtype=torch.float32, device="cpu"):
    d = cfg.d_model
    d_ff = cfg.d_ff or (7 * d // 2)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mu": torch.full((5, d), 0.5, **f32),  # shift mixes for r, k, v, g, w
        "r": dense_init(gen, d, d, dtype, device=device),
        "k": dense_init(gen, d, d, dtype, device=device),
        "v": dense_init(gen, d, d, dtype, device=device),
        "g": dense_init(gen, d, d, dtype, device=device),
        # data-dependent decay via a low-rank projection (Finch's LoRA form)
        "w1": dense_init(gen, d, cfg.decay_lora, torch.float32, device=device),
        "w2": dense_init(gen, cfg.decay_lora, d, torch.float32, device=device),
        "w_bias": torch.full((d,), -6.0, **f32),
        "u": torch.randn(d, generator=gen, **f32) * 0.1,
        "out": dense_init(gen, d, d, dtype, device=device, scale=d ** -0.5),
        "cm_k": dense_init(gen, d, d_ff, dtype, device=device),
        "cm_v": dense_init(gen, d_ff, d, dtype, device=device, scale=d ** -0.5),
        "cm_r": dense_init(gen, d, d, dtype, device=device),
        "cm_mu": torch.full((2, d), 0.5, **f32),
        "ln_x": rmsnorm_init(d, dtype, device),
    }


def _shift(x, prev=None):
    """Token shift: x_{t-1} (zeros, or ``prev`` [B, 1, d], at t = 0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _wkv_chunk(state, r, k, v, w, u):
    """WKV over one chunk. state: [B, H, P, P] (key dim × value dim); r, k,
    v, w: [B, Q, H, P]; u: [H, P]. Returns (new_state, out [B, Q, H, P]).

    JAX's step is out_t = r_t · (s + u k_t v_tᵀ), s = w_t s + k_t v_tᵀ. The
    same function in fewer device ops per token: the sequential loop holds
    only the state update (one ``addcmul``); the rank-1 terms k_t v_tᵀ are
    formed for the whole chunk before it, and the read-out r_t · s_{t-1}
    and the bonus (r_t · (u k_t)) v_t after it, each in one batched op."""
    kv = k[..., :, None] * v[..., None, :]  # [B,Q,H,P,P]
    before = []
    for kvt, wt in zip(kv.unbind(1), w.unbind(1)):
        before.append(state)
        state = torch.addcmul(kvt, wt[..., None], state)
    out = torch.einsum("bqhi,bqhij->bqhj", r, torch.stack(before, dim=1))
    return state, out + (r * u * k).sum(-1, keepdim=True) * v


_RWKV_IN = {"r": "attn_q", "k": "attn_k", "v": "attn_v", "g": "mlp_gate"}


def rwkv_time_mix(params, x, ctx: Ctx, cfg: RWKVCfg, state=None):
    """x: [B, S, d] -> (y, new_state); state = {"wkv": [B, H, P, P], "shift":
    [B, 1, d]} or None (zeros)."""
    Bsz, S, d = x.shape
    H, P = cfg.n_heads, cfg.head_dim
    xp = _shift(x, state["shift"] if state is not None else None)
    mu = params["mu"]

    def mix(i):
        return x + mu[i].to(x.dtype) * (xp - x)

    r = dense(params["r"], mix(0), ctx, "attn_q")
    k = dense(params["k"], mix(1), ctx, "attn_k")
    v = dense(params["v"], mix(2), ctx, "attn_v")
    g = dense(params["g"], mix(3), ctx, "mlp_gate")
    # data-dependent decay w in (0, 1): exp(-exp(lora(x))); a raw matmul, not a site
    wlog = (mix(4).to(torch.float32) @ params["w1"]["w"].t()) @ params["w2"]["w"].t()
    w = torch.exp(-torch.exp(wlog + params["w_bias"]))
    u = params["u"]
    # a carried state holds every head (cache_specs: batch over data only)
    local = state is None and _heads_local(ctx, params, _RWKV_IN, H)
    if local:
        H, d = H // ctx.n_mp, d // ctx.n_mp
        w, u = _mine(w, ctx), _mine(u, ctx, 0)
    elif ctx.mesh is not None:
        r, k, v, g = (_whole(t, ctx, params[n], role)
                      for t, (n, role) in zip((r, k, v, g), _RWKV_IN.items()))

    shp = (Bsz, S, H, P)
    rh, kh, vh = (t.to(torch.float32).reshape(shp) for t in (r, k, v))
    wh = w.reshape(shp)
    u = u.reshape(H, P)
    s = (state["wkv"] if state is not None
         else x.new_zeros((Bsz, H, P, P), dtype=torch.float32))
    Q = min(cfg.chunk, S)
    pad = -S % Q
    # inert padding: w = 1 (no decay), r = k = v = 0 (no state change, zero output)
    rh, kh, vh = (_pad_steps(t, pad) for t in (rh, kh, vh))
    wh = _pad_steps(wh, pad, 1.0)
    ys = []
    for rc, kc, vc, wc in zip(*(torch.split(t, Q, dim=1) for t in (rh, kh, vh, wh))):
        s, o = _remat(_wkv_chunk, s, rc, kc, vc, wc, u)
        ys.append(o)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y[:, :S].reshape(Bsz, S, d).to(x.dtype)
    y = _norm(params["ln_x"], y, ctx, local)
    y = y * F.silu(g.to(torch.float32)).to(x.dtype)
    y = dense(params["out"], _out_input(params["out"], ctx, "attn_o", y, local), ctx, "attn_o")
    return y, {"wkv": s, "shift": x[:, -1:]}


def rwkv_channel_mix(params, x, ctx: Ctx, cfg: RWKVCfg, state=None):
    """RWKV channel mix (squared-ReLU MLP with token shift). ``state``: the
    previous token [B, 1, d] or None. Returns (y, new state)."""
    xp = _shift(x, state)
    mu = params["cm_mu"]
    xk = x + mu[0].to(x.dtype) * (xp - x)
    xr = x + mu[1].to(x.dtype) * (xp - x)
    kk = dense(params["cm_k"], xk, ctx, "mlp_in")
    kk = torch.square(F.relu(kk.to(torch.float32))).to(x.dtype)
    rr = _whole(dense(params["cm_r"], xr, ctx, "mlp_gate"), ctx, params["cm_r"], "mlp_gate")
    rr = torch.sigmoid(rr.to(torch.float32)).to(x.dtype)
    if ctx.mesh is not None:  # the hidden layer on this rank's chunk where cm_k gave one
        kk = _out_input(params["cm_v"], ctx, "mlp_out", kk,
                        _sharded_out(ctx, params["cm_k"], "mlp_in"))
    return rr * dense(params["cm_v"], kk, ctx, "mlp_out"), x[:, -1:]


def rwkv_state_init(batch: int, cfg: RWKVCfg, dtype, device="cpu"):
    return {
        "wkv": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                           dtype=torch.float32, device=device),
        "shift_tm": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
        "shift_cm": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
    }
