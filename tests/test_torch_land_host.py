"""The land kernel's column loop (``land::rollout_column`` in
``csrc/land_step.cuh``), compiled for the host by the C++ compiler, against
the plain version (the port's process modules stepped by the same stepper)
at float64: ForwardEuler over every composition the kernel takes, and Heun
and ImplicitEuler (each solver; one Picard iteration, and two and three
through ``land::picard_step`` with the solver at run time) over bare
ground, bare Richards flow and the vegetated composition with and without a
snowpack.

The host build does not contract multiply-adds, as torch on the CPU does
not; the two differ where libm and torch round a transcendental apart (an
ulp). The states are ``torch_parity.land_random_state``'s, which reach every
clamp and branch of the step; two inputs are series that start after the
first clock time and end before the last, so both flat ends and the
interpolation between rows are read. The steps are few: from such states
the explicit coupling diverges in some columns within a simulated day.
"""
import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import terrarium_tpu_torch as tp
from terrarium_tpu_torch.ops import land_step as ls

from torch_parity import land_model, land_random_state

HERE = pathlib.Path(__file__).parent
CSRC = HERE.parent / "terrarium_tpu_torch" / "csrc"
CELLS, NZ, STEPS, DT = 64, 8, 8, 600.0
SERIES = ("air_temperature", "surface_shortwave_down")
CURVES, CONDS = {"vg": 0, "bc": 1}, {"mualem": 0, "linear": 1}
STEPPERS, SOLVERS = {"euler": 0, "heun": 1, "implicit": 2}, {"thomas": 0, "pcr": 1}


@pytest.fixture(scope="module")
def host_land(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    so = tmp_path_factory.mktemp("land_step_host") / "land_step_host.so"
    subprocess.run([cxx, "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(HERE / "land_step_host.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.host_land_rollout.restype = ctypes.c_int
    return lib


def land_case(composition, seed, nz=NZ, cells=CELLS, steps=STEPS):
    """The model, carry, inputs, root fraction, coordinates and parameters of
    one random case: the fields of ``land_random_state``, the first two
    inputs as series of rows 2 dt apart from the second clock time to
    before the last."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz),
                            dtype=torch.float64, device="cpu")
    model = land_model(tp, grid, composition)
    params = ls.LandParams.of(model, torch.float64)
    fields = {k: torch.as_tensor(v)
              for k, v in land_random_state(seed, cells, nz, extremes=False).items()}
    carry = {n: fields[n].contiguous() for n in ls.carry_names(params)}
    if params.tags[1] == "noflow":
        carry["saturation_water_ice"] = carry["saturation_water_ice"].clamp(0.0, 1.0)
    rng = np.random.default_rng(seed + 50)
    inputs = {}
    for name in ls.LAND_INPUTS:
        if name in SERIES:
            lo, hi = (-10.0, 45.0) if name == "air_temperature" else (0.0, 1000.0)
            rows = steps // 2 - 1
            inputs[name] = ls.LandInput(torch.as_tensor(rng.uniform(lo, hi, (rows, cells))),
                                        DT, 2 * DT)
        elif name in model.collated_variables().inputs:
            inputs[name] = ls.LandInput(fields[name][None, :].contiguous())
    root = None
    if params.tags[0] == "veg":
        prof = model.vegetation.root_distribution.profile(grid.vertical)
        root = torch.as_tensor(prof)[:, None].expand(nz, cells)
    coords = tuple(getattr(grid, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    return model, carry, inputs, root, coords, params


def host_rollout(lib, carry, inputs, root, coords, params, steps, dt=DT, time=0.0,
                 stepper="euler", solver="thomas", picard=0):
    """The host build's carry after ``steps`` steps; ``picard`` > 0 runs
    ``land::picard_step`` with that many iterations."""
    out = {n: torch.empty_like(carry[n]) for n in params.model.live_carry}
    args, keep = ls.launch_args(carry, out, inputs, root, coords, params)
    tags = params.tags
    richards = tags[1] == "richards"
    rc = lib.host_land_rollout(
        *args[:3], ctypes.c_void_p(args[3]), ctypes.c_longlong(args[4]),
        ctypes.c_longlong(args[5]), *(ctypes.c_void_p(a) for a in args[6:10]), args[10],
        ctypes.c_int(carry["internal_energy"].shape[0]), ctypes.c_int(tags[0] == "veg"),
        ctypes.c_int(richards), ctypes.c_int(CURVES[tags[2]] if richards else 0),
        ctypes.c_int(CONDS[tags[3]] if richards else 0), ctypes.c_int("snow" in tags),
        ctypes.c_int(STEPPERS[stepper]), ctypes.c_int(SOLVERS[solver]), ctypes.c_int(picard),
        ctypes.c_int(steps),
        ctypes.c_double(time), ctypes.c_double(dt), ctypes.c_longlong(out["internal_energy"]
                                                                      .shape[1]))
    del keep
    assert rc == 0
    return out


def assert_carry_close(out, ref, names):
    """Every field within 1e-12 of the plain version (relative, with a floor
    of 1e-12 of the field's magnitude)."""
    for name in names:
        a, b = out[name], ref[name]
        assert bool(torch.isfinite(b).all()), name
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("composition", ["bare", "bare_richards", "coupled", "consistent",
                                         "parity"])
def test_host_land_column_matches_plain(host_land, composition, seed):
    """8 steps of 600 s from the random states: every field of the carry
    within 1e-12 of the plain version (relative, with a floor of 1e-12 of
    the field's magnitude); the parity composition over 3 steps, before its
    raw yearly rates take columns of these states non-finite (at 4)."""
    steps = 3 if composition == "parity" else STEPS
    model, carry, inputs, root, coords, params = land_case(composition, seed)
    out = host_rollout(host_land, carry, inputs, root, coords, params, steps)
    ref = ls.land_column_rollout_plain(carry, inputs, root, *coords, params, DT, 0.0, steps)
    assert_carry_close(out, ref, params.model.live_carry)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("stepper", ["heun", "implicit-thomas", "implicit-pcr"])
@pytest.mark.parametrize("composition", ["bare", "bare_richards", "consistent",
                                         "consistent_snow"])
def test_host_land_steppers_match_plain(host_land, composition, stepper, seed):
    """Heun and ImplicitEuler (``land::heun_step``, ``land::implicit_step``
    with each solver): 8 steps of 600 s from the random states, every field
    of the carry within 1e-12 of the plain version stepped by the same
    stepper (relative, with a floor of 1e-12 of the field's magnitude)."""
    name, _, solver = stepper.partition("-")
    model, carry, inputs, root, coords, params = land_case(composition, seed)
    out = host_rollout(host_land, carry, inputs, root, coords, params, STEPS, stepper=name,
                       solver=solver or "thomas")
    ref = ls.land_column_rollout_plain(carry, inputs, root, *coords, params, DT, 0.0, STEPS,
                                       stepper=name, solver=solver or None)
    assert_carry_close(out, ref, params.model.live_carry)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("composition", ["snow", "consistent_snow"])
def test_host_land_snow_matches_plain(host_land, composition, seed):
    """ForwardEuler with a snowpack (its cover, melt, albedo blend and clip):
    8 steps of 600 s from the random states, every field within 1e-12 of the
    plain version; the random packs melt out in some columns and grow in
    others."""
    model, carry, inputs, root, coords, params = land_case(composition, seed)
    assert params.tags[-1] == "snow"
    out = host_rollout(host_land, carry, inputs, root, coords, params, STEPS)
    ref = ls.land_column_rollout_plain(carry, inputs, root, *coords, params, DT, 0.0, STEPS)
    assert_carry_close(out, ref, params.model.live_carry)
    swe0, swe = carry["snow_water_equivalent"], ref["snow_water_equivalent"]
    assert bool((swe > swe0.clamp(min=0.0)).any()) and bool((swe < swe0).any())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("solver", ["thomas", "pcr"])
@pytest.mark.parametrize("composition", ["bare", "bare_richards", "consistent",
                                         "consistent_snow"])
def test_host_land_picard_step_matches_plain(host_land, composition, solver, iters, seed):
    """ImplicitEuler's Picard iterations (``land::picard_step``, the count
    and the solver at run time): 8 steps of 600 s from the random states,
    every field of the carry within 1e-12 of the plain version stepped by
    ``ImplicitEuler(picard_iters=iters)`` (relative, with a floor of 1e-12
    of the field's magnitude); one iteration equals ``land::implicit_step``
    bit for bit, and each further one moves the soil. From these states the
    plain version's iterations take up to three columns in 64 of the bare
    compositions non-finite from step 4 on, as the parity composition's
    rates do in ``test_host_land_column_matches_plain``: the host build's
    non-finite columns are those, and the others are held."""
    model, carry, inputs, root, coords, params = land_case(composition, seed)
    names = params.model.live_carry
    out = host_rollout(host_land, carry, inputs, root, coords, params, STEPS,
                       stepper="implicit", solver=solver, picard=iters)
    ref = ls.land_column_rollout_plain(carry, inputs, root, *coords, params, DT, 0.0, STEPS,
                                       stepper="implicit", solver=solver, picard_iters=iters)

    def nonfinite(c):
        bad = torch.zeros(CELLS, dtype=torch.bool)
        for n in names:
            bad |= ~torch.isfinite(c[n]).all(0) if c[n].dim() == 2 else ~torch.isfinite(c[n])
        return bad

    bad = nonfinite(ref)
    assert torch.equal(nonfinite(out), bad) and int(bad.sum()) <= 3
    if composition not in ("bare", "bare_richards"):
        assert not bool(bad.any())
    keep = (~bad).nonzero().flatten()
    assert_carry_close({n: t[..., keep] for n, t in out.items()},
                       {n: t[..., keep] for n, t in ref.items()}, names)
    one = host_rollout(host_land, carry, inputs, root, coords, params, STEPS,
                       stepper="implicit", solver=solver)
    if iters == 1:
        assert all(torch.equal(out[n][..., keep], one[n][..., keep]) for n in names)
    else:
        assert not torch.equal(out["internal_energy"][:, keep], one["internal_energy"][:, keep])
