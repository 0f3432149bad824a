"""The land segment-VJP kernel's column code (``land::segment_vjp_column``
in ``csrc/land_adjoint.cuh``: the forward with stored carries, the
recompute, ``land::step_adjoint`` and ``land::implicit_step_adjoint`` with
each solver, the parameter cotangents), compiled for the host by the C++
compiler, against torch autograd through the plain version
(``ops/land_vjp.py::land_column_segment_vjp_plain``) at float64.

Every composition the kernel's templates take is held: bare ground or
vegetated, over heat only (``NoFlow``) or Richards flow with Van Genuchten
and Mualem conductivity, Van Genuchten and linear, or Brooks-Corey and
linear; with constant and Monin-Obukhov drag, both ground-flux forms and
both ground-resistance factors. The states are
``torch_parity.land_random_state``'s, which reach every clamp and branch of
the step, with every input static (the VJP takes no series). The bound is
the soil adjoint's (`test_torch_step_adjoint.py`): 1e-12 of each cotangent,
with a floor of 1e-12 of its largest magnitude.

Where the photosynthesis is gated off with a zero co-limitation
discriminant (no shortwave, or air outside the stress window), torch's
autograd of the plain version multiplies a masked-out 0 by the infinite
derivative of sqrt(0) and gives NaN (ROADMAP Queue C); the kernel
differentiates the taken branch only. Those columns are held to a central
difference of the forward instead, and the rest to the plain version run
on them alone.
"""
import ctypes
import dataclasses
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import terrarium_tpu_torch as tp
from terrarium_tpu_torch.ops import land_step as ls
from terrarium_tpu_torch.ops import land_vjp as lv

from torch_parity import land_model, land_random_state

HERE = pathlib.Path(__file__).parent
CSRC = HERE.parent / "terrarium_tpu_torch" / "csrc"
CELLS, NZ, STEPS, DT = 48, 8, 6, 600.0
CURVES, CONDS = {"vg": 0, "bc": 1}, {"mualem": 0, "linear": 1}
STEPPERS, SOLVERS = {"euler": 0, "implicit": 2}, {"thomas": 0, "pcr": 1}


@pytest.fixture(scope="module")
def host_vjp(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    so = tmp_path_factory.mktemp("land_adjoint_host") / "land_adjoint_host.so"
    subprocess.run([cxx, "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(HERE / "land_adjoint_host.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.host_land_segment_vjp.restype = ctypes.c_int
    return lib


def _vg_mualem(m):
    return m.ConstantSoilHydraulics(swrc=m.VanGenuchten(alpha=2.0, n=2.0),
                                    unsat_hydraulic_cond=m.UnsatKVanGenuchten())


def composition_model(grid, name):
    """The LandModel of one composition: ``torch_parity.land_model``'s
    ``bare`` (heat only), ``bare_richards`` (Van Genuchten, linear),
    ``coupled`` (Brooks-Corey, linear, constant drag, the reference ground
    flux and a constant ground resistance) and ``consistent`` (the same soil,
    Monin-Obukhov drag, the consistent ground flux, the soil-moisture ground
    resistance); ``veg_noflow`` (``coupled``'s vegetation over its loam
    with the default heat-only hydrology); ``vg_mualem`` and ``bare_vg_mualem`` (Van Genuchten and
    Mualem under ``coupled``'s vegetation and under bare ground);
    ``bare_bc_mo`` (bare ground over Brooks-Corey and linear with
    ``consistent``'s atmosphere, SEB and ground resistance)."""
    if name in ("bare", "bare_richards", "coupled", "consistent"):
        return land_model(tp, grid, name)
    coupled = land_model(tp, grid, "coupled")
    if name == "veg_noflow":
        return dataclasses.replace(coupled, soil=tp.SoilEnergyWaterCarbon(strat=coupled.soil.strat))
    if name in ("vg_mualem", "bare_vg_mualem"):
        soil = tp.SoilEnergyWaterCarbon(
            strat=coupled.soil.strat,
            hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq(),
                                       hydraulic_properties=_vg_mualem(tp)))
        if name == "vg_mualem":
            return dataclasses.replace(coupled, soil=soil)
        return tp.LandModel(grid=grid, soil=soil)
    assert name == "bare_bc_mo", name
    consistent = land_model(tp, grid, "consistent")
    return tp.LandModel(
        grid=grid, soil=consistent.soil, atmosphere=consistent.atmosphere,
        surface_energy_balance=consistent.surface_energy_balance,
        surface_hydrology=tp.SurfaceHydrology(
            canopy_interception=tp.NoCanopyInterception(),
            evapotranspiration=tp.BareGroundEvaporation(
                ground_resistance=tp.SoilMoistureResistanceFactor())))


COMPOSITIONS = ["bare", "veg_noflow", "bare_vg_mualem", "vg_mualem", "bare_richards",
                "bare_bc_mo", "coupled", "consistent"]


def vjp_case(name, seed, cells=CELLS):
    """The carry, static inputs, root fraction, coordinates, parameters and
    output cotangents of one random case."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=NZ),
                            dtype=torch.float64, device="cpu")
    model = composition_model(grid, name)
    params = ls.LandParams.of(model, torch.float64)
    fields = {k: torch.as_tensor(v)
              for k, v in land_random_state(seed, cells, NZ, extremes=False).items()}
    carry = {n: fields[n].contiguous() for n in ls.carry_names(params)}
    if params.tags[1] == "noflow":
        carry["saturation_water_ice"] = carry["saturation_water_ice"].clamp(0.0, 1.0)
    inputs = {n: ls.LandInput(fields[n][None, :].contiguous()) for n in ls.LAND_INPUTS
              if n in model.collated_variables().inputs}
    root = None
    if params.tags[0] == "veg":
        prof = model.vegetation.root_distribution.profile(grid.vertical)
        root = torch.as_tensor(prof)[:, None].expand(NZ, cells)
    coords = tuple(getattr(grid, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    rng = np.random.default_rng(seed + 100)
    gout = {n: torch.as_tensor(rng.normal(size=tuple(carry[n].shape)))
            for n in model.live_carry}
    return carry, inputs, root, coords, params, gout


def host_vjp_run(lib, carry, inputs, root, coords, params, gout, steps, stepper="euler",
                 solver="thomas"):
    """The host build's ``(gcarry0, gK_sat, gsk_mineral)``, the parameter
    cotangents summed over the columns."""
    gin = {n: torch.full_like(t, np.nan) for n, t in carry.items()}
    args, keep = ls.launch_args(carry, gin, inputs, root, coords, params)
    c_gout = ls._CLandCarry(**{ls._CARRY_OF[n]: t.data_ptr() for n, t in gout.items()})
    cells = carry["internal_energy"].shape[1]
    gparams = torch.zeros(2, cells, dtype=torch.float64)
    tags = params.tags
    richards = tags[1] == "richards"
    rc = lib.host_land_segment_vjp(
        args[0], ctypes.byref(c_gout), args[1], args[2], ctypes.c_void_p(args[3]),
        ctypes.c_longlong(args[4]), ctypes.c_longlong(args[5]),
        *(ctypes.c_void_p(a) for a in args[6:10]), args[10], ctypes.c_void_p(gparams.data_ptr()),
        ctypes.c_int(NZ), ctypes.c_int(tags[0] == "veg"), ctypes.c_int(richards),
        ctypes.c_int(CURVES[tags[2]] if richards else 0),
        ctypes.c_int(CONDS[tags[3]] if richards else 0), ctypes.c_int(STEPPERS[stepper]),
        ctypes.c_int(SOLVERS[solver]), ctypes.c_int(steps), ctypes.c_double(DT),
        ctypes.c_longlong(cells))
    del keep
    assert rc == 0
    return gin, gparams[0], gparams[1]


def columns_of(carry, cols):
    return {n: (t[:, cols] if t.dim() == 2 else t[cols]).contiguous() for n, t in carry.items()}


def zero_discriminant(inputs, params):
    """The columns whose photosynthesis is gated off with a zero
    co-limitation discriminant under their static inputs: no shortwave, or
    air at or outside the stress window."""
    v = params.values
    SW = inputs["surface_shortwave_down"].values[0]
    Ta = inputs["air_temperature"].values[0]
    return (SW <= 0) | (Ta <= v["T_CO2_low"]) | (Ta >= v["T_CO2_high"])


def assert_cotangents_close(got, ref, names):
    for name in names:
        a, b = got[name], ref[name]
        assert bool(torch.isfinite(a).all()), name
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * scale, msg=name)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("stepper", ["euler", "implicit-thomas", "implicit-pcr"])
@pytest.mark.parametrize("composition", COMPOSITIONS)
def test_host_land_adjoint_matches_autograd(host_vjp, composition, stepper, seed):
    """The host build's cotangents of the carry within 1e-12 of the plain
    version's autograd (with a floor of 1e-12 of each field's magnitude),
    over 6 steps of 600 s; the parameter cotangents as sums over the
    columns. Columns where the plain version's autograd is not finite are
    held to the plain version run without them only where they are the
    zero-discriminant columns (``test_host_land_adjoint_gated_photosynthesis``
    holds them)."""
    name, _, solver = stepper.partition("-")
    carry, inputs, root, coords, params, gout = vjp_case(composition, seed)
    got, gK, gskm = host_vjp_run(host_vjp, carry, inputs, root, coords, params, gout, STEPS,
                                 name, solver or "thomas")
    ref, rK, rskm = lv.land_column_segment_vjp_plain(carry, inputs, root, *coords, params, DT,
                                                     0.0, STEPS, gout, stepper=name,
                                                     solver=solver or None)
    bad = torch.zeros(CELLS, dtype=torch.bool)
    for t in ref.values():
        bad |= ~torch.isfinite(t).all(0) if t.dim() == 2 else ~torch.isfinite(t)
    assert not bool((bad & ~zero_discriminant(inputs, params)).any())
    if bool(bad.any()):
        keep = (~bad).nonzero().flatten()
        ref, rK, rskm = lv.land_column_segment_vjp_plain(
            columns_of(carry, keep), {n: ls.LandInput(i.values[:, keep].contiguous())
                                      for n, i in inputs.items()},
            None if root is None else root[:, keep], *coords, params, DT, 0.0, STEPS,
            columns_of(gout, keep), stepper=name, solver=solver or None)
        got, gK, gskm = columns_of(got, keep), gK[keep], gskm[keep]
    assert_cotangents_close(got, ref, ref)
    assert float(rskm) != 0.0
    torch.testing.assert_close(gskm.sum(), rskm, rtol=1e-12, atol=0.0)
    if params.tags[1] == "richards":
        assert float(rK) != 0.0
        torch.testing.assert_close(gK.sum(), rK, rtol=1e-12, atol=1e-12 * float(
            gK.abs().sum()))
    else:
        assert float(gK.abs().max()) == 0.0 and float(rK) == 0.0


@pytest.mark.parametrize("stepper", ["euler", "implicit-pcr"])
def test_host_land_adjoint_gated_photosynthesis(host_vjp, stepper):
    """Where the photosynthesis is gated off with a zero discriminant, the
    plain version's autograd gives NaN for the carbon's cotangent (0 * inf)
    and the kernel the derivative of the branch it takes: its cotangent of
    the carbon equals a central difference of the forward over 2 steps
    (the carbon of every column moved by 1e-3 of itself at once, as the
    columns are independent; each field's difference taken before the
    contraction with its cotangent) within 1e-4, the resolution that the
    same difference reaches on the other columns, where the kernel equals
    the plain version's autograd."""
    name, _, solver = stepper.partition("-")
    carry, inputs, root, coords, params, gout = vjp_case("consistent", 0)
    gated = zero_discriminant(inputs, params)
    assert 8 <= int(gated.sum()) <= CELLS - 8
    steps = 2
    ref, *_ = lv.land_column_segment_vjp_plain(carry, inputs, root, *coords, params, DT, 0.0,
                                               steps, gout, stepper=name, solver=solver or None)
    finite = torch.isfinite(ref["carbon_vegetation"])
    assert not bool(finite[gated].any()) and bool(finite[~gated].all())
    got, _, _ = host_vjp_run(host_vjp, carry, inputs, root, coords, params, gout, steps, name,
                             solver or "thomas")
    C0 = carry["carbon_vegetation"]
    h = 1e-3 * C0

    def out(C):
        return ls.land_column_rollout_plain({**carry, "carbon_vegetation": C}, inputs, root,
                                            *coords, params, DT, 0.0, steps, stepper=name,
                                            solver=solver or None)

    hi, lo = out(C0 + h), out(C0 - h)
    fd = sum(((hi[n] - lo[n]) * gout[n]).sum(0) if hi[n].dim() == 2
             else (hi[n] - lo[n]) * gout[n] for n in hi) / (2 * h)
    a = got["carbon_vegetation"]
    assert bool(torch.isfinite(a).all())
    torch.testing.assert_close(a[~gated], ref["carbon_vegetation"][~gated], rtol=1e-12,
                               atol=0.0)
    for cols in (~gated, gated):
        torch.testing.assert_close(a[cols], fd[cols], rtol=1e-4, atol=0.0)


def test_land_vjp_refusals():
    """Heun, a snowpack and series inputs are refused by type, each naming
    its ROADMAP item; the CPU wrapper is the plain version."""
    carry, inputs, root, coords, params, gout = vjp_case("consistent", 0, cells=8)
    with pytest.raises(ValueError, match="Queue B #1"):
        lv.land_column_segment_vjp(carry, inputs, root, *coords, params, DT, 0.0, 2, gout,
                                   stepper="heun")
    series = dict(inputs, air_temperature=ls.LandInput(torch.zeros(3, 8, dtype=torch.float64),
                                                       0.0, 3600.0))
    with pytest.raises(ValueError, match="Queue B #1"):
        lv.land_column_segment_vjp(carry, series, root, *coords, params, DT, 0.0, 2, gout)
    snow = ls.LandParams.of(dataclasses.replace(params.model, snow=tp.Snowpack()),
                            torch.float64)
    with pytest.raises(ValueError, match="Queue B #1"):
        lv.land_column_segment_vjp(carry, inputs, root, *coords, snow, DT, 0.0, 2, gout)
    a = lv.land_column_segment_vjp(carry, inputs, root, *coords, params, DT, 0.0, 2, gout,
                                   stepper="implicit", solver="pcr")
    b = lv.land_column_segment_vjp_plain(carry, inputs, root, *coords, params, DT, 0.0, 2, gout,
                                         stepper="implicit", solver="pcr")
    for x, y in [*((a[0][n], b[0][n]) for n in carry), (a[1], b[1]), (a[2], b[2])]:
        torch.testing.assert_close(x, y, rtol=0.0, atol=0.0, equal_nan=True)


@pytest.mark.parametrize("consistent", [False, True])
def test_pool_term_derivative_at_an_empty_pool(consistent):
    """The land pool term ``sign * min(max(S, 0) / tau_r, S)``
    (``hydrology.pool_drainage`` with a runoff scheme) keeps its values and
    takes derivative 0 at S == 0: an empty pool neither drains nor grows
    (ROADMAP Queue C). torch.minimum would split the tie 0.5/0.5, which
    makes each explicit step multiply the pool's cotangent by
    |1 - dt (1 + 1/tau_r) / 2| (29 at dt 60 s under the consistent sign).
    Above and below the kink: sign / tau_r and sign."""
    from terrarium_tpu_torch.processes.soil.hydrology import pool_drainage

    runoff = tp.DirectSurfaceRunoff(consistent_drainage=consistent)
    sign = -1.0 if consistent else 1.0
    S = torch.tensor([0.0, 2e-3, -1e-3], dtype=torch.float64, requires_grad=True)
    out = pool_drainage(S, runoff)
    (g,) = torch.autograd.grad(out.sum(), S)
    ref = sign * torch.minimum(torch.clamp(S.detach(), min=0.0) / runoff.tau_r, S.detach())
    assert torch.equal(out.detach(), ref)
    torch.testing.assert_close(g, torch.tensor([0.0, sign / runoff.tau_r, sign],
                                               dtype=torch.float64), rtol=0.0, atol=0.0)
