"""The port's cost analysis (``repro_torch.launch.hlo_analysis``) against
JAX's ``repro.launch.hlo_analysis`` on the same inputs: the depth model's
fit and prediction, the roofline terms given the same rates, and the wire
weight of each collective kind and group size against JAX's parser on a
one-line HLO of that kind. The counters in ``launch/mesh.py`` are checked
on a layout mesh of the group size being weighed, with no-op collectives."""
import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis as jh
from repro_torch.launch import hlo_analysis as th

# (n_full, rem, costs) points of the three depth layouts the dry run fits
POINTS = {
    "homogeneous": [(1, 0, {"flops": 7.0e12, "bytes": 3.25e9, "coll_bytes": 1.5e8}),
                    (2, 0, {"flops": 1.3e13, "bytes": 5.5e9, "coll_bytes": 2.75e8})],
    "periodic": [(0, 1, {"flops": 4.0e11, "bytes": 2.0e8}),
                 (1, 0, {"flops": 1.9e12, "bytes": 9.0e8}),
                 (2, 0, {"flops": 3.7e12, "bytes": 1.7e9})],
    "three_homogeneous": [(1, 0, {"bytes": 10.0}), (2, 0, {"bytes": 16.0}),
                          (4, 0, {"bytes": 28.0})],
}


@pytest.mark.parametrize("name", sorted(POINTS))
@pytest.mark.parametrize("target", [(126, 0), (4, 2), (13, 3)])
def test_depth_model_equals_jax(name, target):
    pts = POINTS[name]
    mine = th.fit_depth_model(pts)
    theirs = jh.fit_depth_model(pts)
    assert set(mine) == set(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
    assert th.predict_depth_model(mine, *target) == jh.predict_depth_model(theirs, *target)


@pytest.mark.parametrize("name", ["homogeneous", "periodic"])
@pytest.mark.parametrize("target", [(126, 0), (4, 2), (13, 3)])
def test_dry_run_depth_prediction_is_jax_model(name, target):
    """The dry run's depth model from its points' differences is JAX's
    least-squares model on the two layouts ``_depth_points`` gives (to
    float64's rounding, 1e-12), and exact on integers past 2^53."""
    from repro_torch.launch.dryrun import depth_prediction

    pts = POINTS[name]
    want = jh.predict_depth_model(jh.fit_depth_model(pts), *target)
    got = depth_prediction(pts, *target)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12)
    small = depth_prediction([(nf, rm, {k: int(v) for k, v in c.items()}) for nf, rm, c in pts],
                             *target)
    # every point scaled by 2^40 and shifted by 1: the prediction, scaled and shifted
    big = depth_prediction([(nf, rm, {k: int(v) * 2**40 + 1 for k, v in c.items()})
                            for nf, rm, c in pts], *target)
    for k in want:
        assert small[k] == pytest.approx(want[k], rel=1e-12)
        assert big[k] == small[k] * 2**40 + 1 and big[k] > 2**53


@pytest.mark.parametrize("flops,nbytes,coll,chips", [
    (197e12, 819e9 * 0.5, 0.0, 1), (1e9, 819e9 * 2, 0.0, 1), (1e9, 1e6, 3e11, 256),
    (4.2e15, 2.1e12, 7.7e10, 256)])
@pytest.mark.parametrize("per_device", [True, False])
def test_roofline_terms_equal_jax_at_the_same_rates(flops, nbytes, coll, chips, per_device):
    """The port's terms with JAX's TPU v5e rates in the port's HW fields
    (bf16 peak, HBM rate, a group within one host at JAX's ICI rate) are
    JAX's, to the float."""
    jhw = jh.HW()
    # a group of 2 ranks runs at the NVLink rate, one of 16 spans two hosts
    # of 8 and runs at the inter-host rate: JAX's ICI rate in either
    group = 16 if chips > 1 else 2
    link = {"inter_host_bw" if group > 8 else "nvlink_bw": jhw.ici_bw}
    thw = th.HW(peak_flops_bf16=jhw.peak_flops_bf16, hbm_bw=jhw.hbm_bw,
                hbm_bytes=jhw.hbm_bytes, **link)
    want = jh.roofline_terms(flops, nbytes, coll, chips, jhw, per_device=per_device)
    got = th.roofline_terms(flops, nbytes, coll, chips, thw, per_device=per_device,
                            dtype="bfloat16", group_size=group)
    assert got == want


def test_h100_rates_and_dtype_peak():
    hw = th.HW()
    assert (hw.peak_flops_bf16, hw.peak_flops_f32, hw.hbm_bw, hw.hbm_bytes) == (
        989e12, 67e12, 3.35e12, 85_017_493_504.0)
    assert hw.peak_flops("bfloat16") == 989e12 and hw.peak_flops("float32") == 67e12
    assert hw.link_bw(8) == 450e9 and hw.link_bw(16) == hw.inter_host_bw
    r = th.roofline_terms(67e12, 0.0, 0.0, 1, hw, dtype="float32")
    assert r["compute_s"] == pytest.approx(1.0)


_HLO = {
    "all-reduce": "%x = f32[{r}]{{0}} all-reduce(f32[{r}] %a), replica_groups=[{g},{n}]<=[{t}]",
    "all-gather": ("%x = f32[{r}]{{0}} all-gather(f32[{s}] %a), replica_groups=[{g},{n}]<=[{t}], "
                   "dimensions={{0}}"),
    "reduce-scatter": ("%x = f32[{r}]{{0}} reduce-scatter(f32[{s}] %a), "
                       "replica_groups=[{g},{n}]<=[{t}], to_apply=%add"),
}


@pytest.mark.parametrize("kind", sorted(_HLO))
@pytest.mark.parametrize("n", [2, 4, 8, 16, 32])
def test_wire_weight_equals_jax_parser(kind, n):
    size = 4 * 1024  # the collective's result, in f32 elements
    line = _HLO[kind].format(r=size, s=size * n if kind == "reduce-scatter" else size // n,
                             g=512 // n, n=n, t=512)
    want = jh.collective_bytes(line)[kind]
    assert th.wire_bytes(kind, 4 * size, n) == want


@pytest.mark.parametrize("n", [1, 2, 4, 16])
def test_mesh_counters_weigh_each_call_as_jax(n, monkeypatch):
    """``collective_bytes()`` keeps the payload per op (phases 17, 19 and 20
    assert it to the byte) and adds the wire bytes per HLO kind at the
    call's group size; a one-rank group puts nothing on the wire."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as meshlib

    # a mesh of n ranks on one axis with a stub group and no-op collectives:
    # the counters read each call's group size from the mesh
    mesh = meshlib.layout((n,), ("model",))
    mesh._groups[("model",)] = object()
    mesh.device_mesh = object()
    for op in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"):
        monkeypatch.setattr(dist, op, lambda *a, **k: None)
    x = torch.ones(64, 8)
    meshlib.reset_collective_bytes()
    meshlib.psum(x, "model", mesh)
    meshlib.pmax(x, "model", mesh)
    meshlib.psum_scatter(x, "model", mesh)
    meshlib.all_gather(x, "model", mesh)
    got = meshlib.collective_bytes()
    b = x.numel() * 4
    assert (got["psum"], got["pmax"], got["psum_scatter"], got["all_gather"]) == (b, b, b, b)
    assert got["total"] == 4 * b
    wire = got["wire"]
    if n == 1:
        assert wire["total"] == 0 and sum(got["calls"].values()) == 0
        return
    assert wire["all-reduce"] == 2 * th.wire_bytes("all-reduce", b, n)
    assert wire["reduce-scatter"] == th.wire_bytes("reduce-scatter", b // n, n)
    assert wire["all-gather"] == th.wire_bytes("all-gather", b * n, n)
    assert got["calls"] == {"all-reduce": 2, "reduce-scatter": 1, "all-gather": 1}
    rec = th.collective_totals(got)
    assert rec["total"] == pytest.approx(wire["total"])
    meshlib.reset_collective_bytes()
    assert meshlib.collective_bytes()["wire"]["total"] == 0
