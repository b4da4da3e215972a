"""Execution configuration (port of ``repro/api/execution.py``).

Where a Runtime runs (a mesh, its axis names, the TP plans), compact
gradients, the accumulation count, telemetry, resilience and observability;
the one factory for :class:`~repro_torch.nn.common.Ctx` outside the nn
substrate.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

__all__ = ["ExecutionConfig"]


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Static execution environment of one Runtime.

    Attributes:
      mesh: a :class:`repro_torch.launch.mesh.Mesh` (``make_mesh``, over an
        initialised process group) for distributed runs; None = one device.
        Under a mesh every rank holds its shards of the state and its rows
        of the batch (docs/port.md, "Distributed"), and its shards of the
        serving caches (docs/port.md, "Serving under a mesh").
      act_sharding: where the residual stream lives between the layers
        (JAX's ``act_sharding``, which ``Ctx.constrain`` pins at the
        embedding and at each layer boundary): a ``(batch, seq, d)`` spec,
        each entry None, a mesh axis or a tuple of mesh axes (in either
        spelling, or a JAX-style sharding with a ``.spec``), no axis used
        twice (``launch.mesh.stream_layout``; another spec raises
        ``ValueError`` naming the rule). None is the fixed layout (batch
        over the data axes, replicated over model:
        ``launch.sharding.logical_rules(mesh)["activations"]``). A layer
        computes in the fixed layout, or in JAX's sequence-parallel one
        where the spec's sequence is over exactly the model axes
        (``launch/dryrun.py``'s ``_act_sharding(..., sp=True)``: gathered
        at each block's entry and reduce-scattered at its exit, docs/port.md
        "Dry run"); any other layout is moved into that compute layout at
        each layer's entry and back at its exit (``models/lm.py``; values
        only move, docs/port.md "Residual-stream layouts"). A call's batch
        or sequence that does not divide its axes stays whole for that call
        (JAX's ``_act_sharding`` rule); a model width that does not divide
        raises ``ValueError``.
      data_axes / model_axes: the mesh axes carrying data parallelism and
        tensor parallelism (axes the mesh lacks are dropped).
      tp_sketch: sites that can take the TP plans run them (``tp_column``,
        ``tp_row``, ``tp_exact`` for the head), with the compressed DP
        gradient collective (``core/site.py``).
      compact_grads: keep sketched dW compact (rows + indices) from the
        backward through clipping into row-sparse optimizer updates
        (``core/compact_grad.py``; requires ``accum == 1``).
      accum: gradient-accumulation microbatch count: the step splits its
        batch on axis 0 and averages the microbatches' losses, gradients and
        refreshed plan carries (``train/train_step.py``).
      telemetry: a :class:`repro_torch.telemetry.TelemetryConfig` turning on
        the per-site probes and naming optional sinks; ``None`` (the
        default) turns telemetry off. Probes require ``accum == 1``.
      resilience: a :class:`repro_torch.resilience.ResilienceConfig`
        turning on the fault-handling plumbing: the step takes a
        ``fault_scale`` argument (fault injection without another step
        build) and, with ``sentinel=True``, skips the optimizer update when
        the loss or the gradient norm is non-finite or the norm explodes; a
        run where the sentinel never trips is bit for bit a resilience-off
        run. ``None`` (the default) builds the three-argument step.
      obs: a :class:`repro_torch.obs.ObsConfig` turning on spans, the
        metrics registry, the compile and memory ledgers and the flight
        recorder (``Runtime.observability()``); ``None`` (the default)
        turns them off.
    """

    mesh: Optional[Any] = None
    act_sharding: Optional[Any] = None
    data_axes: Tuple[str, ...] = ("data",)
    model_axes: Tuple[str, ...] = ("model",)
    tp_sketch: bool = False
    compact_grads: bool = False
    accum: int = 1
    telemetry: Optional[Any] = None  # repro_torch.telemetry.TelemetryConfig
    resilience: Optional[Any] = None  # repro_torch.resilience.ResilienceConfig
    obs: Optional[Any] = None  # repro_torch.obs.ObsConfig

    def __post_init__(self):
        object.__setattr__(self, "data_axes", tuple(self.data_axes))
        object.__setattr__(self, "model_axes", tuple(self.model_axes))
        if self.mesh is not None and not hasattr(self.mesh, "axis_names"):
            raise ValueError(f"mesh must be a repro_torch.launch.mesh.Mesh, got {self.mesh!r}")
        if self.act_sharding is not None:
            self._check_act_sharding()
        if self.accum < 1:
            raise ValueError(f"accum must be >= 1, got {self.accum}")
        if self.compact_grads and self.accum != 1:
            raise ValueError("compact_grads requires accum == 1 (compact index "
                             "sets differ per microbatch; accumulate densely)")
        if self.telemetry is not None and self.telemetry.probes and self.accum != 1:
            raise ValueError("telemetry probes require accum == 1 (probe vectors would "
                             "average across microbatch plans); use TelemetryConfig("
                             "probes=False) with accumulation")
        if self.resilience is not None and not hasattr(self.resilience, "sentinel"):
            raise ValueError("resilience must be a repro_torch.resilience.ResilienceConfig, "
                             f"got {self.resilience!r}")
        if self.obs is not None and not hasattr(self.obs, "trace_capacity"):
            raise ValueError(f"obs must be a repro_torch.obs.ObsConfig, got {self.obs!r}")

    def _check_act_sharding(self):
        if self.mesh is None:
            raise ValueError("act_sharding needs a mesh")
        from repro_torch.launch.mesh import stream_layout

        stream_layout(self.act_sharding, self.mesh)

    def stream_layout(self):
        """``act_sharding`` as one tuple of mesh axes per dimension (mesh
        order), or None (the fixed layout, or no mesh)."""
        if self.act_sharding is None or self.mesh is None:
            return None
        from repro_torch.launch.mesh import stream_layout

        return stream_layout(self.act_sharding, self.mesh)

    @property
    def seq_parallel(self) -> bool:
        """The layers compute in the sequence-parallel layout: the
        ``act_sharding`` sequence is over exactly the model axes."""
        layout = self.stream_layout()
        mp = self.axes_in_mesh()[1]
        return layout is not None and bool(mp) and layout[1] == self.mesh.axes(mp)

    def replace(self, **kw) -> "ExecutionConfig":
        return dataclasses.replace(self, **kw)

    def axes_in_mesh(self) -> tuple:
        """(data axes, model axes) that the mesh has."""
        if self.mesh is None:
            return self.data_axes, self.model_axes
        have = self.mesh.axis_names
        return (tuple(a for a in self.data_axes if a in have),
                tuple(a for a in self.model_axes if a in have))

    def site_spec(self, role: str, cfg, *, d_out: int, d_in: int, has_bias: bool = False,
                  x_ndim: int = 3):
        """The :class:`~repro_torch.core.site.SiteSpec` a site resolves to in
        this environment (plan, slot ranks, probe capability)."""
        from repro_torch.core.site import resolve_site

        dp, mp = self.axes_in_mesh()
        return resolve_site(role, cfg, d_out=d_out, d_in=d_in, has_bias=has_bias,
                            x_ndim=x_ndim, mesh=self.mesh, data_axes=dp, model_axes=mp,
                            tp_sketch=self.tp_sketch)

    def slot_kwargs(self) -> dict:
        """The mesh arguments of the slot builders (``with_grad_slots``,
        ``with_probe_slots``, ``with_plan_state``)."""
        dp, mp = self.axes_in_mesh()
        return dict(mesh=self.mesh, data_axes=dp, model_axes=mp, tp_sketch=self.tp_sketch)

    def make_ctx(self, *, policy=None, key=None, layer_index: int = 0, n_layers: int = 1,
                 rows_sharded: bool = True):
        """The per-call :class:`~repro_torch.nn.common.Ctx` (``key``: the
        integer seed sketched sites derive their generators from;
        ``rows_sharded``: under a mesh, whether the batch holds this rank's
        rows or the whole batch on every data rank)."""
        from repro_torch.nn.common import Ctx

        dp, mp = self.axes_in_mesh()
        return Ctx(policy=policy, key=key, layer_index=layer_index, n_layers=n_layers,
                   mesh=self.mesh, data_axes=dp, model_axes=mp, tp_sketch=self.tp_sketch,
                   rows_sharded=rows_sharded, seq_parallel=self.seq_parallel,
                   act_layout=self.stream_layout())
