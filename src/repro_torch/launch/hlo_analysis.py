"""Cost analysis of a dry-run step: the depth model, roofline terms, the
collective wire weights.

Port of ``repro/launch/hlo_analysis.py``. JAX reads FLOPs and bytes from a
compiled program's ``cost_analysis()`` and parses collectives out of its HLO
text. Eager PyTorch has neither: the dry run (``launch/dryrun.py``) runs the
step once on fake tensors and counts what it does, so :func:`cost_summary`
takes those counts, and the collectives' wire bytes come from
``launch.mesh.collective_bytes()["wire"]``, which weighs every call with
:func:`wire_bytes` (JAX's ring model) at the group size it ran on.

:func:`fit_depth_model`, :func:`predict_depth_model` and
:func:`roofline_terms` are JAX's, unchanged: the linear model
``cost(L) = intercept + n_full_periods(L)·per_period + rem_layers(L)·per_layer``
and the three roofline terms in seconds. The dry run solves the same model
in integers from its depth points (``dryrun.depth_prediction``): a float64
least-squares fit rounds the FLOPs and bytes of a production cell.

:class:`HW` is one NVIDIA H100 80GB HBM3 (SXM). Every rate in it is a
datasheet figure (NVIDIA's H100 data sheet, dense rates at the 700 W power
limit; the inter-host rate is one 400 Gb/s NDR InfiniBand port per GPU), not
a measurement: the dry run predicts, the card measures.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["HW", "wire_bytes", "collective_totals", "cost_summary", "roofline_terms",
           "fit_depth_model", "predict_depth_model"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One NVIDIA H100 80GB HBM3 SXM: datasheet rates, not measurements, and
    the card's measured usable bytes.

    ``peak_flops_bf16``: dense tensor-core bf16 (989 TFLOP/s);
    ``peak_flops_f32``: float32 FFMA outside the tensor cores (67 TFLOP/s),
    the rate ``PERF.md``'s float32 kernel bounds use; ``hbm_bw``: 3.35 TB/s;
    ``hbm_bytes``: 85,017,493,504 B, the usable bytes that
    ``torch.cuda.get_device_properties(0).total_memory`` reads on an H100
    80GB HBM3 at 700 W (measured, unlike the rates: ``chip_smoke.py`` phase
    21 prints it; the "80GB" is 80 GiB less what the driver keeps;
    :meth:`from_device` reads it on a card), with no margin taken off for
    the CUDA context or NCCL's buffers; ``nvlink_bw``: 450 GB/s each way to the other
    cards of a host of ``host_size`` (8); ``inter_host_bw``: 50 GB/s each way,
    one 400 Gb/s NDR InfiniBand port per GPU, for a group that spans hosts."""

    peak_flops_bf16: float = 989e12
    peak_flops_f32: float = 67e12
    hbm_bw: float = 3.35e12
    hbm_bytes: float = 85_017_493_504.0
    nvlink_bw: float = 450e9
    inter_host_bw: float = 50e9
    host_size: int = 8

    def peak_flops(self, dtype: str = "bfloat16") -> float:
        """The peak for a cell computing in ``dtype`` (``"bfloat16"`` or
        ``"float16"``: the tensor cores; anything else: float32 FFMA)."""
        return self.peak_flops_bf16 if str(dtype) in ("bfloat16", "float16") else \
            self.peak_flops_f32

    def link_bw(self, group_size: int) -> float:
        """Each-way rate of a collective over ``group_size`` ranks laid out
        host by host: NVLink within one host, the inter-host rate beyond."""
        return self.nvlink_bw if group_size <= self.host_size else self.inter_host_bw

    @classmethod
    def from_device(cls, device=0) -> "HW":
        """The datasheet rates with the card's own usable bytes."""
        import torch

        return cls(hbm_bytes=float(torch.cuda.get_device_properties(device).total_memory))


def wire_bytes(kind: str, size: float, n: int) -> float:
    """Bytes one rank puts on the wire for one collective, JAX's ring model
    (``repro/launch/hlo_analysis.py``): ``size`` is the collective's RESULT
    (an all-reduce's buffer, the gathered output of an all-gather, the
    scattered output of a reduce-scatter) over a group of ``n`` ranks
    (counted as 2 where it is 1, as JAX counts an HLO collective).
    all-reduce 2(n-1)/n·size, all-gather (n-1)/n·size, reduce-scatter
    (n-1)·size, all-to-all (n-1)/n·size, collective-permute size."""
    n = max(2, int(n))
    if kind == "all-reduce":
        return 2.0 * size * (n - 1) / n
    if kind in ("all-gather", "all-to-all"):
        return size * (n - 1) / n
    if kind == "reduce-scatter":
        return size * (n - 1)
    if kind == "collective-permute":
        return float(size)
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_totals(counts: dict) -> dict:
    """JAX's ``collective_bytes`` record from ``launch.mesh.collective_bytes()``:
    wire bytes per HLO kind, their ``total`` and the call ``counts``."""
    wire = counts["wire"]
    out = {k: float(wire.get(k, 0.0)) for k in ("all-reduce", "all-gather", "reduce-scatter",
                                                "all-to-all", "collective-permute")}
    out["total"] = sum(out.values())
    out["counts"] = dict(counts.get("calls", {}))
    return out


def cost_summary(counts: dict) -> dict:
    """``{"flops", "bytes"}`` of one step from the dry run's counts, as
    counted (integers; JAX reads floats from ``compiled.cost_analysis()``)."""
    return {"flops": counts.get("flops", 0), "bytes": counts.get("bytes", 0)}


def fit_depth_model(points):
    """points: [(n_full, rem, cost_dict)] -> coefficient dict per metric.

    Linear model: cost = I + n_full·PPC + rem·M (least squares; exact when the
    design matrix has full column rank).
    """
    keys = set()
    for _, _, c in points:
        keys |= set(k for k, v in c.items() if isinstance(v, (int, float)))
    A = np.array([[1.0, nf, rem] for nf, rem, _ in points])
    coefs = {}
    for k in keys:
        y = np.array([c.get(k, 0.0) for _, _, c in points])
        sol, *_ = np.linalg.lstsq(A, y, rcond=None)
        coefs[k] = sol  # [I, PPC, M]
    return coefs


def predict_depth_model(coefs, n_full: int, rem: int) -> dict:
    return {k: float(max(0.0, c[0] + c[1] * n_full + c[2] * rem))
            for k, c in coefs.items()}


def roofline_terms(flops: float, bytes_hbm: float, coll_bytes: float,
                   chips: int, hw: HW = HW(), *, per_device: bool = True,
                   dtype: str = "bfloat16", group_size: int = 2) -> dict:
    """Three roofline terms in seconds. Inputs are per-device unless noted.
    The compute peak follows the cell's ``dtype``; the collective rate is
    that of a group of ``group_size`` ranks (:meth:`HW.link_bw`)."""
    if not per_device:
        flops, bytes_hbm, coll_bytes = (x / chips for x in (flops, bytes_hbm, coll_bytes))
    t_c = flops / hw.peak_flops(dtype)
    t_m = bytes_hbm / hw.hbm_bw
    t_x = coll_bytes / hw.link_bw(group_size)
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "dominant": dom, "bound_s": max(t_c, t_m, t_x)}
