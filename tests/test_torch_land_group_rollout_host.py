"""The land group rollout kernel's column code
(``land::GroupColumn::rollout`` in ``csrc/land_group_step.cuh``: the
LandModel's ImplicitEuler rollout over Richards flow, with or without a
snowpack, any Picard count, either solver, and its Heun rollout, each column on a
group of lanes, the step ``GroupColumn::picard_step`` or
``GroupColumn::heun_step`` that the land group segment VJP recomputes
with), compiled for the host by the C++ compiler with each group's lanes
emulated in lockstep (``soil::HostLanes``; the builds of
``tests/land_group_vjp_host.cpp`` that `test_torch_land_group_vjp_host.py`
makes, ``-DLAND_GROUP_G=<G>`` once for each G and without for the one-thread
column, shared between the two files), against

* the one-thread land rollout that it replaces on the card
  (``land::rollout_column`` of ``land::implicit_step`` at one Picard
  iteration, of ``land::picard_step`` at two and three): every field of the
  output carry bit for bit (both builds contract no multiply-adds, and the
  group code forms each value by the one-thread code's operations in its
  order), at G 4, 8, 16 and 32, at Nz 20 over the vegetated bench
  composition (Brooks-Corey and linear conductivity; constant drag and the
  reference ground flux, or Monin-Obukhov drag, the consistent ground flux
  and the soil-moisture ground resistance) and bare ground over Van
  Genuchten and Mualem, the bench composition with a snowpack, and at the
  ragged Nz 7 (slots above the column on
  the top lanes), each solver, on ``torch_parity.land_random_state``'s
  states of 24 columns over 8 steps of 600 s from the clock time 1,800 s,
  the shortwave and the air temperature two uniform series of their own
  origins (-5,400 s and -3,000 s), the other inputs static; Heun likewise
  against ``land::rollout_column`` of ``land::heun_step`` (each step's
  stage reading the series at t + dt) over 8 steps of 60 s;
* the plain version (``land_column_rollout_plain``, the process modules)
  at float64, rtol 1e-12 with a floor of 1e-12 of each field's largest
  magnitude, at Nz 20 and the kernel's G, each solver, and Heun; with a
  snowpack on the random states with their series and on
  `test_torch_land_adjoint_host.py`'s empty and emptying packs;
* JAX's ``make_fused_lean_rollout(..., interpret=True)`` (the Pallas kernel
  through its interpreter) at Nz 8, PCR with two Picard iterations, through
  the port's ``integrator.advance`` with the host build in place of the
  kernel, as `test_torch_land_steppers.py` holds the plain version to it,
  without and with a snowpack.
"""
import ctypes

import jax
import numpy as np
import pytest
import torch

from terrarium_tpu.ops.fused_step import make_fused_lean_rollout
import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu_torch.ops import land_step as ls
from terrarium_tpu_torch.timesteppers import integrator

from test_torch_land_adjoint_host import HEUN_DT
from test_torch_land_group_vjp_host import (CASES, CONDS, CURVES, GROUPS, PACK_SCHEMES,
                                            SOLVERS, STEPPERS, host_libs, land_case, pack_case)
from test_torch_land_steppers import _assert_prognostics_close, _forced

STEPS, DT, TIME0 = 8, 600.0, 1800.0
#: the series inputs: (name, origin, spacing)
SERIES = (("surface_shortwave_down", -5400.0, 3600.0), ("air_temperature", -3000.0, 1800.0))
SERIES_ROWS = 8


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The host builds of `test_torch_land_group_vjp_host.py` (``host_libs``)."""
    return host_libs(tmp_path_factory)


def rollout_case(nz, composition):
    """The carry, inputs (two series of their own origins, the rest
    static), root fraction, coordinates and parameters of one random case:
    `test_torch_land_group_vjp_host.py`'s ``land_case`` with the shortwave
    and the air temperature made series about their static values."""
    carry, inputs, root, coords, params, _ = land_case(composition, nz, 3 * nz + len(composition))
    cells = carry["internal_energy"].shape[1]
    rng = np.random.default_rng(nz + 7 * len(composition))
    inputs = dict(inputs)
    for name, t0, dts in SERIES:
        base = inputs[name].values[0].numpy()
        rows = (base[None, :] * rng.uniform(0.6, 1.4, (SERIES_ROWS, cells))
                + rng.normal(0.0, 2.0, (SERIES_ROWS, cells)))
        if name == "surface_shortwave_down":
            rows = np.maximum(rows, 0.0)
        inputs[name] = ls.LandInput(torch.as_tensor(rows).contiguous(), t0, dts)
    return carry, inputs, root, coords, params


def host_rollout(lib, case, solver, iters, steps=STEPS, dt=DT, time0=TIME0,
                 stepper="implicit"):
    """The output carry of the host build ``lib`` (a group one or the
    one-thread one) over ``steps`` steps of ``stepper`` (``"implicit"``
    with ``solver`` and ``iters`` Picard iterations, or ``"heun"``)."""
    carry, inputs, root, coords, params = case
    nz, cells = carry["internal_energy"].shape
    out = {n: torch.full_like(carry[n], np.nan) for n in params.model.live_carry}
    args, keep = ls.launch_args(carry, out, inputs, root, coords, params)
    tags = params.tags
    assert tags[1] == "richards"
    rc = lib.host_land_rollout(
        args[0], args[1], args[2], ctypes.c_void_p(args[3]), ctypes.c_longlong(args[4]),
        ctypes.c_longlong(args[5]), *(ctypes.c_void_p(a) for a in args[6:10]), args[10],
        ctypes.c_int(steps), ctypes.c_double(time0), ctypes.c_double(dt),
        ctypes.c_longlong(cells), ctypes.c_int(iters), ctypes.c_int(nz),
        ctypes.c_int(tags[0] == "veg"), ctypes.c_int(CURVES[tags[2]]),
        ctypes.c_int(CONDS[tags[3]]), ctypes.c_int("snow" in tags),
        ctypes.c_int(SOLVERS.get(solver, 1)), ctypes.c_int(STEPPERS[stepper]))
    del keep
    assert rc == 0
    return out


_cases, _thread_runs = {}, {}


def case_of(nz, composition):
    if (nz, composition) not in _cases:
        _cases[nz, composition] = rollout_case(nz, composition)
    return _cases[nz, composition]


def heun_kw(solver):
    """host_rollout's keywords of a scheme: Heun's (``solver`` None) at
    HEUN_DT."""
    return {"stepper": "heun", "dt": HEUN_DT} if solver is None else {}


def thread_run(libs, nz, composition, solver, iters):
    """The one-thread build's rollout of a case, computed once for every G
    (``solver`` None: Heun's)."""
    key = (nz, composition, solver, iters)
    if key not in _thread_runs:
        _thread_runs[key] = host_rollout(libs[None], case_of(nz, composition), solver, iters,
                                         **heun_kw(solver))
    return _thread_runs[key]


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("nz,composition", CASES)
def test_land_group_rollout_equals_the_thread_rollout_bitwise(libs, nz, composition, group,
                                                              solver, iters):
    """``land::GroupColumn::rollout`` at G ``group`` against
    ``land::rollout_column`` (implicit_step at one iteration, picard_step at
    more) over 8 steps of 600 s with two series inputs on every column:
    every field of the output carry bit for bit, finite, and moved."""
    assert_rollout_bitwise(libs, nz, composition, group, solver, iters)


def assert_rollout_bitwise(libs, nz, composition, group, solver, iters):
    """The group build's rollout at G ``group`` against the one-thread
    build's on a case (``solver`` None: Heun's): every field of the output
    carry bit for bit, finite, and moved."""
    want = thread_run(libs, nz, composition, solver, iters)
    got = host_rollout(libs[group], case_of(nz, composition), solver, iters, **heun_kw(solver))
    carry = case_of(nz, composition)[0]
    for name, b in want.items():
        a = got[name]
        assert bool(torch.isfinite(b).all()), name
        assert torch.equal(a, b), (name, (a != b).nonzero()[:5].tolist())
    assert not torch.equal(want["internal_energy"], carry["internal_energy"])
    assert not torch.equal(want["skin_temperature"], carry["skin_temperature"])


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_land_group_rollout_matches_the_plain_version(libs, solver, iters):
    """The group rollout at Nz 20 over the bench composition at the
    kernel's G (``land::rollout_group_lanes``) against the plain version
    (the process modules stepped by ImplicitEuler's ``pre_closure_step``,
    the series read at each clock time) over 8 steps of 600 s: every field
    within rtol 1e-12 with a floor of 1e-12 of its largest magnitude."""
    nz = 20
    g = libs[None].host_land_rollout_group_lanes(nz, SOLVERS[solver], STEPPERS["implicit"])
    case = case_of(nz, "consistent")
    got = host_rollout(libs[g], case, solver, iters)
    carry, inputs, root, coords, params = case
    want = ls.land_column_rollout_plain(carry, inputs, root, *coords, params, DT, TIME0, STEPS,
                                        stepper="implicit", solver=solver, picard_iters=iters)
    for name, b in want.items():
        scale = float(b.abs().max())
        torch.testing.assert_close(got[name], b, rtol=1e-12, atol=1e-12 * scale, msg=name)


def test_land_group_rollout_matches_jax_fused_interpret(libs, monkeypatch):
    """8 steps of `test_torch_land_steppers.py`'s forced configuration (8
    columns, Nz 8, hourly shortwave and air-temperature series, ImplicitEuler
    PCR with two Picard iterations at dt 600 s) through the port's
    ``advance`` on the host build of the group rollout at the kernel's G,
    against JAX's ``make_fused_lean_rollout(..., interpret=True)`` (two
    launches of 4 inner steps): every prognostic as that file holds the
    plain version."""
    nz, solver, iters = 8, "pcr", 2
    g = libs[None].host_land_rollout_group_lanes(nz, SOLVERS[solver], STEPPERS["implicit"])
    calls = []

    def rollout(carry, inputs, root, dz, dz_faces, z_centers, z_faces, params, dt, time, steps,
                solver, picard_iters):
        calls.append((solver, picard_iters, steps))
        return host_rollout(libs[g], ({n: t.contiguous() for n, t in carry.items()}, inputs,
                                      root, (dz, dz_faces, z_centers, z_faces), params),
                            solver, picard_iters, steps=steps, dt=dt, time0=time)

    monkeypatch.setitem(ls.ROLLOUTS, "implicit", rollout)
    jsim, psim = _forced(tt, "consistent", "implicit-pcr-2"), _forced(tp, "consistent",
                                                                      "implicit-pcr-2")
    assert psim.state["internal_energy"].shape[0] == nz
    dt = psim.timestepper.default_dt()
    fused = make_fused_lean_rollout(jsim.model, jsim.timestepper, jsim.ctx, jsim.input_sources,
                                    dt=dt, inner_steps=4, block_cells=128, interpret=True)
    jstate = jax.jit(lambda s: fused(s, 8))(jsim.state)
    integrator.advance(psim.model, psim.state, psim.ctx, 8, dt, timestepper=psim.timestepper,
                       input_sources=psim.input_sources)
    assert calls == [(solver, iters, 8)]
    _assert_prognostics_close(psim.state, jstate, sorted(psim.state.prognostic))


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("nz,composition", CASES)
def test_land_group_heun_rollout_equals_the_thread_rollout_bitwise(libs, nz, composition,
                                                                   group):
    """``land::GroupColumn::rollout`` of Heun at G ``group`` against
    ``land::rollout_column`` of ``land::heun_step`` over 8 steps of 60 s
    with two series inputs (read at t and, for the stage, t + dt) on every
    column: every field of the output carry bit for bit, finite, and
    moved."""
    assert_rollout_bitwise(libs, nz, composition, group, None, 1)


def test_land_group_heun_rollout_matches_the_plain_version(libs):
    """The group Heun rollout at Nz 20 over the bench composition at the
    kernel's G (``land::heun_rollout_group_lanes``) against the plain
    version (the process modules stepped by Heun's ``pre_closure_step``,
    the series read at each clock time, the stage's at t + dt) over 8 steps
    of 60 s: every field within rtol 1e-12 with a floor of 1e-12 of its
    largest magnitude."""
    nz = 20
    g = libs[None].host_land_rollout_group_lanes(nz, 1, STEPPERS["heun"])
    case = case_of(nz, "consistent")
    got = host_rollout(libs[g], case, None, 1, **heun_kw(None))
    carry, inputs, root, coords, params = case
    want = ls.land_column_rollout_plain(carry, inputs, root, *coords, params, HEUN_DT, TIME0,
                                        STEPS, stepper="heun")
    for name, b in want.items():
        scale = float(b.abs().max())
        torch.testing.assert_close(got[name], b, rtol=1e-12, atol=1e-12 * scale, msg=name)


@pytest.mark.parametrize("scheme", list(PACK_SCHEMES))
@pytest.mark.parametrize("packs", ["random", "empty_and_emptying"])
def test_land_group_snow_rollout_matches_the_plain_version(libs, packs, scheme):
    """The group rollout with a snowpack over the bench composition at the
    kernel's G against the plain version: on the random states at Nz 20
    with their two series over 8 steps from 1,800 s, and on
    `test_torch_land_adjoint_host.py`'s empty and emptying packs (Nz 8, 48
    columns, static inputs) over 6 steps from 0 s; Heun's steps of 60 s, the
    implicit ones' of 600 s (PCR, and Thomas with two Picard iterations).
    Every field within rtol 1e-12 with a floor of 1e-12 of its largest
    magnitude; the SWE moves, and on the packs some empty."""
    stepper, solver, iters = PACK_SCHEMES[scheme]
    dt = HEUN_DT if stepper == "heun" else DT
    if packs == "random":
        case, steps, time0 = case_of(20, "consistent_snow"), STEPS, TIME0
    else:
        case, steps, time0 = pack_case()[:5], 6, 0.0
    nz = case[0]["internal_energy"].shape[0]
    g = libs[None].host_land_rollout_group_lanes(nz, SOLVERS.get(solver, 1), STEPPERS[stepper])
    got = host_rollout(libs[g], case, solver, iters, steps=steps, dt=dt, time0=time0,
                       stepper=stepper)
    carry, inputs, root, coords, params = case
    want = ls.land_column_rollout_plain(carry, inputs, root, *coords, params, dt, time0, steps,
                                        stepper=stepper, solver=solver, picard_iters=iters)
    for name, b in want.items():
        scale = float(b.abs().max())
        torch.testing.assert_close(got[name], b, rtol=1e-12, atol=1e-12 * scale, msg=name)
    swe0, swe = carry["snow_water_equivalent"], got["snow_water_equivalent"]
    assert not torch.equal(swe, swe0)
    if packs != "random":
        assert int(((swe0 > 0) & (swe == 0)).sum()) >= 8


def test_land_group_snow_rollout_matches_jax_fused_interpret(libs, monkeypatch):
    """`test_land_group_rollout_matches_jax_fused_interpret` with a
    snowpack: the forced configuration over the bench composition with a
    ``Snowpack`` (an initial SWE of 0.01 m under a snowfall of 2e-8 m/s),
    ImplicitEuler PCR with two Picard iterations at dt 600 s, 8 steps
    through the port's ``advance`` on the host build of the group rollout
    at the kernel's G, against JAX's ``make_fused_lean_rollout(...,
    interpret=True)``: every prognostic, the SWE among them, as
    `test_torch_land_steppers.py` holds the plain version."""
    nz, solver, iters = 8, "pcr", 2
    g = libs[None].host_land_rollout_group_lanes(nz, SOLVERS[solver], STEPPERS["implicit"])
    calls = []

    def rollout(carry, inputs, root, dz, dz_faces, z_centers, z_faces, params, dt, time, steps,
                solver, picard_iters):
        calls.append((solver, picard_iters, steps, "snow" in params.tags))
        return host_rollout(libs[g], ({n: t.contiguous() for n, t in carry.items()}, inputs,
                                      root, (dz, dz_faces, z_centers, z_faces), params),
                            solver, picard_iters, steps=steps, dt=dt, time0=time)

    monkeypatch.setitem(ls.ROLLOUTS, "implicit", rollout)
    jsim = _forced(tt, "consistent_snow", "implicit-pcr-2")
    psim = _forced(tp, "consistent_snow", "implicit-pcr-2")
    assert psim.state["internal_energy"].shape[0] == nz
    dt = psim.timestepper.default_dt()
    fused = make_fused_lean_rollout(jsim.model, jsim.timestepper, jsim.ctx, jsim.input_sources,
                                    dt=dt, inner_steps=4, block_cells=128, interpret=True)
    jstate = jax.jit(lambda s: fused(s, 8))(jsim.state)
    integrator.advance(psim.model, psim.state, psim.ctx, 8, dt, timestepper=psim.timestepper,
                       input_sources=psim.input_sources)
    assert calls == [(solver, iters, 8, True)]
    names = sorted(psim.state.prognostic)
    assert "snow_water_equivalent" in names
    _assert_prognostics_close(psim.state, jstate, names)
