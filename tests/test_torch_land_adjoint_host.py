"""The land segment-VJP kernel's column code (``land::segment_vjp_column``
in ``csrc/land_adjoint.cuh``: the forward with stored carries, the
recompute, ``land::step_adjoint``, ``land::heun_step_adjoint`` and
``land::implicit_step_adjoint`` with each solver,
``land::picard_step_adjoint`` with two and three Picard iterations, the
parameter cotangents), compiled for the host by the C++ compiler, against
torch autograd through the plain version
(``ops/land_vjp.py::land_column_segment_vjp_plain``) at float64.

Every composition the kernel's templates take is held: bare ground or
vegetated, over heat only (``NoFlow``) or Richards flow with Van Genuchten
and Mualem conductivity, Van Genuchten and linear, or Brooks-Corey and
linear; with constant and Monin-Obukhov drag, both ground-flux forms and
both ground-resistance factors; and with a ``Snowpack`` over bare ground
(heat only; Brooks-Corey and linear) and under vegetation (Van Genuchten
and Mualem; Brooks-Corey and linear). The states are
``torch_parity.land_random_state``'s, which reach every clamp and branch of
the step (negative, empty and deep snowpacks among them), with every input
static (the VJP takes no series); packs that are empty at the start or
empty within the steps have a test of their own. The bound is
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
import contextlib
import ctypes
import dataclasses
import pathlib
import shutil
import subprocess
from unittest import mock

import numpy as np
import pytest
import torch

import terrarium_tpu_torch as tp
from terrarium_tpu_torch.ops import land_step as ls
from terrarium_tpu_torch.ops import land_vjp as lv
from terrarium_tpu_torch.processes.vegetation.vegetation import PALADYNAutotrophicRespiration

from torch_parity import land_model, land_random_state

HERE = pathlib.Path(__file__).parent
CSRC = HERE.parent / "terrarium_tpu_torch" / "csrc"
CELLS, NZ, STEPS, DT = 48, 8, 6, 600.0
# Heun's step: at DT its stage leaves the physical range on these states
# (ROADMAP Queue C: the land's Heun is unstable at 600 s)
HEUN_DT = 60.0


@contextlib.contextmanager
def respiration_taken_branch():
    """The plain version's autotrophic respiration with the argument of
    its f_temp held at or above -40 degC. No value the step uses changes:
    the soil's factor torch.where(T > 7, f_temp(T), 0) takes f_temp above 7
    degC, and the air's temperature here is above -10 degC. Where a dry
    column's ground passes f_temp's pole at -46.02 degC, torch's autograd of
    the untaken branch gives 0 * inf = NaN, and with the argument held it
    gives the taken branch's derivative, land_adjoint.cuh's convention for
    torch.where. The random states' Heun trajectories reach the pole
    (ROADMAP Queue C)."""
    f_temp = PALADYNAutotrophicRespiration.f_temp
    with mock.patch.object(PALADYNAutotrophicRespiration, "f_temp",
                           staticmethod(lambda T: f_temp(torch.clamp(T, min=-40.0)))):
        yield
CURVES, CONDS = {"vg": 0, "bc": 1}, {"mualem": 0, "linear": 1}
STEPPERS, SOLVERS = {"euler": 0, "heun": 1, "implicit": 2}, {"thomas": 0, "pcr": 1}


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
    """The LandModel of one composition (``<name>_snow``: that of ``name``
    with a ``Snowpack``): ``torch_parity.land_model``'s
    ``bare`` (heat only), ``bare_richards`` (Van Genuchten, linear),
    ``coupled`` (Brooks-Corey, linear, constant drag, the reference ground
    flux and a constant ground resistance) and ``consistent`` (the same soil,
    Monin-Obukhov drag, the consistent ground flux, the soil-moisture ground
    resistance); ``veg_noflow`` (``coupled``'s vegetation over its loam
    with the default heat-only hydrology); ``vg_mualem`` and ``bare_vg_mualem`` (Van Genuchten and
    Mualem under ``coupled``'s vegetation and under bare ground);
    ``bare_bc_mo`` (bare ground over Brooks-Corey and linear with
    ``consistent``'s atmosphere, SEB and ground resistance)."""
    if name.endswith("_snow"):
        return dataclasses.replace(composition_model(grid, name[:-len("_snow")]),
                                   snow=tp.Snowpack())
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
#: the snowpack over each of the kernel's snow instantiations' soils
SNOW_COMPOSITIONS = ["bare_snow", "bare_bc_mo_snow", "vg_mualem_snow", "consistent_snow"]


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
                 solver="thomas", picard=0, dt=DT):
    """The host build's ``(gcarry0, gK_sat, gsk_mineral)``, the parameter
    cotangents summed over the columns; ``picard`` > 0 runs
    ``land::picard_step_adjoint`` with that many iterations."""
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
        ctypes.c_int(CONDS[tags[3]] if richards else 0), ctypes.c_int("snow" in tags),
        ctypes.c_int(STEPPERS[stepper]),
        ctypes.c_int(SOLVERS[solver]), ctypes.c_int(picard), ctypes.c_int(steps),
        ctypes.c_double(dt),
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


def assert_cotangents_close(got, ref, names, spread=None):
    """Each cotangent within 1e-12 of its value plus 1e-12 of the field's
    largest magnitude; with ``spread`` (``{name: tensor}``) also plus twice
    that."""
    for name in names:
        a, b = got[name], ref[name]
        assert bool(torch.isfinite(a).all()), name
        scale = float(b.abs().max())
        if spread is None:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * scale, msg=name)
        else:
            err = (a - b).abs() - 2.0 * spread[name]
            assert bool((err <= 1e-12 * b.abs() + 1e-12 * scale).all()), (name, float(err.max()))


def _held_to_autograd(host_vjp, composition, seed, name, solver, picard, case=None,
                      conditioned=False):
    """The host build against the plain version's autograd over STEPS steps
    (``test_host_land_adjoint_matches_autograd``) on ``vjp_case``'s case or
    on ``case``; with Picard iterations the K_sat cotangent's sum leaves out
    the columns whose share of it is ill-conditioned
    (``ill_conditioned_K_shares``). ``conditioned``: each cotangent may
    also part by twice the plain version's own move under a 1e-15 nudge of
    the initial state (``nudged_spread``)."""
    iters = max(picard, 1)
    dt = HEUN_DT if name == "heun" else DT
    carry, inputs, root, coords, params, gout = case or vjp_case(composition, seed)
    got, gK, gskm = host_vjp_run(host_vjp, carry, inputs, root, coords, params, gout, STEPS,
                                 name, solver or "thomas", picard=picard, dt=dt)
    kw = {"stepper": name, "solver": solver or None, "picard_iters": iters}
    with respiration_taken_branch() if name == "heun" else contextlib.nullcontext():
        ref, rK, rskm = lv.land_column_segment_vjp_plain(carry, inputs, root, *coords, params,
                                                         dt, 0.0, STEPS, gout, **kw)
    bad = torch.zeros(CELLS, dtype=torch.bool)
    for t in ref.values():
        bad |= ~torch.isfinite(t).all(0) if t.dim() == 2 else ~torch.isfinite(t)
    assert not bool((bad & ~zero_discriminant(inputs, params)).any())
    if bool(bad.any()):
        keep = (~bad).nonzero().flatten()
        carry, gout = columns_of(carry, keep), columns_of(gout, keep)
        inputs = {n: ls.LandInput(i.values[:, keep].contiguous()) for n, i in inputs.items()}
        root = None if root is None else root[:, keep]
        with respiration_taken_branch() if name == "heun" else contextlib.nullcontext():
            ref, rK, rskm = lv.land_column_segment_vjp_plain(carry, inputs, root, *coords,
                                                             params, dt, 0.0, STEPS, gout, **kw)
        got, gK, gskm = columns_of(got, keep), gK[keep], gskm[keep]
    spread = None
    if conditioned:
        spread = nudged_spread(carry, inputs, root, coords, params, gout, kw, ref)
    assert_cotangents_close(got, ref, ref, spread)
    assert float(rskm) != 0.0
    torch.testing.assert_close(gskm.sum(), rskm, rtol=1e-12, atol=0.0)
    if params.tags[1] != "richards":
        assert float(gK.abs().max()) == 0.0 and float(rK) == 0.0
        return
    assert float(rK) != 0.0
    if picard:
        left_out = ill_conditioned_K_shares(carry, inputs, root, coords, params, gout, kw)
        assert int(left_out.sum()) <= 2
        gK, rK = gK[~left_out], ref_K_shares(carry, inputs, root, coords, params, gout,
                                              kw)[~left_out].sum()
    torch.testing.assert_close(gK.sum(), rK, rtol=1e-12, atol=1e-12 * float(gK.abs().sum()))


def ref_K_shares(carry, inputs, root, coords, params, gout, kw):
    """Each column's share of the plain version's K_sat cotangent."""
    return lv.land_column_segment_vjp_plain(carry, inputs, root, *coords, params, DT, 0.0,
                                            STEPS, gout, per_column=True, **kw)[1]


def nudged_spread(carry, inputs, root, coords, params, gout, kw, ref):
    """How far the plain version's carry cotangents move from ``ref`` when
    the initial internal energy or saturation moves by 1e-15 of itself, up
    or down (``ill_conditioned_K_shares``'s nudge, both ways and in both
    fields): the largest move of each, ``{name: tensor}``."""
    spread = {n: torch.zeros_like(t) for n, t in ref.items()}
    for field in ("internal_energy", "saturation_water_ice"):
        for eps in (1e-15, -1e-15):
            nudged = {**carry, field: carry[field] * (1 + eps)}
            moved = lv.land_column_segment_vjp_plain(nudged, inputs, root, *coords, params, DT,
                                                     0.0, STEPS, gout, **kw)[0]
            for n in spread:
                spread[n] = torch.maximum(spread[n], (moved[n] - ref[n]).abs())
    return spread


def ill_conditioned_K_shares(carry, inputs, root, coords, params, gout, kw):
    """The columns whose share of the plain version's K_sat cotangent moves
    by more than 1e-13 of the shares' magnitudes summed over the columns
    when the column's initial internal energy moves by 1e-15 of itself:
    there a rounding of the forward apart from torch's (the host build's)
    moves the share by more than the sum's 1e-12. Under Picard iterations
    these are at most two of the 48 columns of a case."""
    shares = ref_K_shares(carry, inputs, root, coords, params, gout, kw)
    nudged = ref_K_shares({**carry, "internal_energy": carry["internal_energy"] * (1 + 1e-15)},
                          inputs, root, coords, params, gout, kw)
    return (nudged - shares).abs() > 1e-13 * float(shares.abs().sum())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("stepper", ["euler", "heun", "implicit-thomas", "implicit-pcr"])
@pytest.mark.parametrize("composition", COMPOSITIONS + SNOW_COMPOSITIONS)
def test_host_land_adjoint_matches_autograd(host_vjp, composition, stepper, seed):
    """The host build's cotangents of the carry within 1e-12 of the plain
    version's autograd (with a floor of 1e-12 of each field's magnitude),
    over 6 steps of 600 s (Heun's of 60 s, HEUN_DT, against the plain
    version with ``respiration_taken_branch``); the parameter cotangents as
    sums over the
    columns. Columns where the plain version's autograd is not finite are
    held to the plain version run without them only where they are the
    zero-discriminant columns (``test_host_land_adjoint_gated_photosynthesis``
    holds them)."""
    name, _, solver = stepper.partition("-")
    _held_to_autograd(host_vjp, composition, seed, name, solver, 0)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("iters", [2, 3])
@pytest.mark.parametrize("solver", ["thomas", "pcr"])
@pytest.mark.parametrize("composition", COMPOSITIONS)
def test_host_land_picard_adjoint_matches_autograd(host_vjp, composition, solver, iters, seed):
    """ImplicitEuler with ``iters`` Picard iterations
    (``land::picard_step_adjoint``, the count and the solver at run time),
    as ``test_host_land_adjoint_matches_autograd``: the carry's and
    sk_mineral's cotangents at 1e-12, and the K_sat cotangent's sum over the
    columns at 1e-12 without the columns whose own share of it is
    ill-conditioned (``ill_conditioned_K_shares``: at most two a case)."""
    _held_to_autograd(host_vjp, composition, seed, "implicit", solver, iters)


@pytest.mark.parametrize("iters", [2, 3])
@pytest.mark.parametrize("solver", ["thomas", "pcr"])
@pytest.mark.parametrize("composition", SNOW_COMPOSITIONS)
def test_host_land_snow_picard_adjoint_matches_autograd(host_vjp, composition, solver, iters):
    """ImplicitEuler's Picard iterations under a snowpack, as
    ``test_host_land_picard_adjoint_matches_autograd`` (one seed): the later
    iterations read iteration 0's SWE unclipped, the step clips it once at
    its end."""
    _held_to_autograd(host_vjp, composition, 0, "implicit", solver, iters)


def empty_pack_case(composition):
    """``vjp_case``'s case with the packs set to empty and emptying ones:
    a third of the columns start with SWE exactly 0, a third with a thin
    pack (1e-5 to 1e-4 m) under air of 15 to 30 degC with no snowfall, which
    the degree-day melt (at least 3.1e-4 m in 6 steps of 60 s) empties
    within the steps, and the rest with a negative SWE; snowfall off in
    every even column besides."""
    carry, inputs, root, coords, params, gout = vjp_case(composition, 3)
    rng = np.random.default_rng(7)
    third = np.arange(CELLS) % 3
    swe = np.where(third == 0, 0.0, np.where(third == 1, rng.uniform(1e-5, 1e-4, CELLS),
                                             -rng.uniform(1e-5, 1e-3, CELLS)))
    snowfall = inputs["snowfall"].values[0].numpy().copy()
    snowfall[(third == 1) | (np.arange(CELLS) % 2 == 0)] = 0.0
    Ta = inputs["air_temperature"].values[0].numpy().copy()
    Ta[third == 1] = rng.uniform(15.0, 30.0, int((third == 1).sum()))
    carry = dict(carry, snow_water_equivalent=torch.as_tensor(swe))
    inputs = dict(inputs, snowfall=ls.LandInput(torch.as_tensor(snowfall)[None, :]),
                  air_temperature=ls.LandInput(torch.as_tensor(Ta)[None, :]))
    return carry, inputs, root, coords, params, gout


@pytest.mark.parametrize("stepper", ["euler", "heun", "implicit-pcr", "implicit-thomas-2"])
@pytest.mark.parametrize("composition", ["bare_snow", "consistent_snow"])
def test_host_land_adjoint_empty_and_emptying_packs(host_vjp, composition, stepper):
    """Packs empty at the start (SWE exactly 0, where the cover's clamp and
    the clip SWE >= 0 pass the cotangent, torch.clamp's rule at its bound)
    and packs that the melt empties within the steps (the clip takes the
    cotangent where it cuts), held as
    ``test_host_land_adjoint_matches_autograd``; the plain forward shows
    both kinds of column. Under Picard iterations a cotangent may also part
    by twice the plain version's own move under a 1e-15 nudge of the
    initial energy or saturation (``nudged_spread``): in the vegetated case
    with Thomas and two iterations, column 46, whose pack empties in the
    first step, moves its net assimilation's cotangent, -944, by up to
    2.1e-5 under the nudges, and the host build parts from it by 1.2e-5,
    through the saturation, whose forward parts from the plain version's by
    1.7e-13 in the first step (ROADMAP Queue C)."""
    name, _, rest = stepper.partition("-")
    solver, _, picard = rest.partition("-")
    case = empty_pack_case(composition)
    carry, inputs, root, coords, params, _ = case
    swe0 = carry["snow_water_equivalent"]
    dt = HEUN_DT if name == "heun" else DT
    out = ls.land_column_rollout_plain(carry, inputs, root, *coords, params, dt, 0.0, STEPS,
                                       stepper=name, solver=solver or None,
                                       picard_iters=int(picard or 1))
    swe = out["snow_water_equivalent"]
    assert int(((swe0 > 0) & (swe == 0)).sum()) >= 8
    assert int(((swe0 == 0) & (swe == 0)).sum()) >= 4
    _held_to_autograd(host_vjp, composition, 3, name, solver, int(picard or 0), case=case,
                      conditioned=bool(picard))


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


@pytest.mark.parametrize("composition", ["bare", "coupled"])
def test_plain_vjp_per_column_shares(composition):
    """``per_column`` gives each column's share of the plain version's
    parameter cotangents: they sum to the 0-d cotangents within 1e-12 of
    the shares' magnitudes, and a column's share is that of the column run
    alone (the heat-only soil's K_sat share is 0)."""
    carry, inputs, root, coords, params, gout = vjp_case(composition, 0, cells=8)
    kw = {"stepper": "implicit", "solver": "pcr", "picard_iters": 2}
    _, rK, rskm = lv.land_column_segment_vjp_plain(carry, inputs, root, *coords, params, DT,
                                                   0.0, 2, gout, **kw)
    _, sK, sskm = lv.land_column_segment_vjp_plain(carry, inputs, root, *coords, params, DT,
                                                   0.0, 2, gout, per_column=True, **kw)
    assert sK.shape == sskm.shape == (8,)
    for total, shares in ((rK, sK), (rskm, sskm)):
        torch.testing.assert_close(shares.sum(), total, rtol=0.0,
                                   atol=1e-12 * float(shares.abs().sum()))
    col = [3]
    _, aK, askm = lv.land_column_segment_vjp_plain(
        columns_of(carry, col), {n: ls.LandInput(i.values[:, col].contiguous())
                                 for n, i in inputs.items()},
        None if root is None else root[:, col].contiguous(), *coords, params, DT, 0.0, 2,
        columns_of(gout, col), **kw)
    torch.testing.assert_close(askm, sskm[3], rtol=1e-12, atol=0.0)
    if composition == "bare":
        assert float(sK.abs().max()) == 0.0
    else:
        torch.testing.assert_close(aK, sK[3], rtol=1e-12, atol=0.0)


def test_land_vjp_refusals(monkeypatch):
    """Series inputs are refused, naming the ROADMAP item (JAX's fused
    gradient refuses them too); Heun and a snowpack, refused until the VJP
    kernel took them, now run: on the CPU the wrapper is the plain version,
    which each of them reaches."""
    carry, inputs, root, coords, params, gout = vjp_case("consistent", 0, cells=8)
    series = dict(inputs, air_temperature=ls.LandInput(torch.zeros(3, 8, dtype=torch.float64),
                                                       0.0, 3600.0))
    with pytest.raises(ValueError, match="Queue B #1"):
        lv.land_column_segment_vjp(carry, series, root, *coords, params, DT, 0.0, 2, gout)
    with pytest.raises(ValueError, match="Queue B #1"):
        lv.land_column_segment_vjp(carry, series, root, *coords, params, DT, 0.0, 2, gout,
                                   stepper="heun")
    calls = []
    plain = lv.land_column_segment_vjp_plain

    def spy(*a, **kw):
        calls.append((kw["stepper"], "snow" in a[7].tags))
        return plain(*a, **kw)

    monkeypatch.setattr(lv, "land_column_segment_vjp_plain", spy)
    snow_case = vjp_case("consistent_snow", 0, cells=8)
    for (c, i, r, x, p, g), kw in (((carry, inputs, root, coords, params, gout),
                                    {"stepper": "implicit", "solver": "pcr"}),
                                   ((carry, inputs, root, coords, params, gout),
                                    {"stepper": "heun"}),
                                   (snow_case, {"stepper": "euler"}),
                                   (snow_case, {"stepper": "heun"})):
        a = lv.land_column_segment_vjp(c, i, r, *x, p, DT, 0.0, 2, g, **kw)
        b = plain(c, i, r, *x, p, DT, 0.0, 2, g, **kw)
        for u, v in [*((a[0][n], b[0][n]) for n in c), (a[1], b[1]), (a[2], b[2])]:
            torch.testing.assert_close(u, v, rtol=0.0, atol=0.0, equal_nan=True)
    assert calls == [("implicit", False), ("heun", False), ("euler", True), ("heun", True)]
    assert "snow_water_equivalent" in snow_case[0]


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
