"""The rollout kernel's column loop (``soil::rollout_column`` in
``csrc/soil_step.cuh``: ForwardEuler and Heun, heat + Richards and heat only,
ImplicitEuler with its Thomas or PCR solves, and ``soil::picard_step``, its
Picard iterations over either physics, the top temperature from a table or
interpolated from a series), compiled for the host by the C++ compiler,
against the plain PyTorch version at float64.

The host build does not contract multiply-adds, as torch on the CPU does
not, so the two differ only where ``cbrt`` and torch's ``pow(x, 1/3)`` round
apart. The states are `test_torch_soil_physics.py`'s random legal states,
which take every branch of the step; the series starts after the first clock
time and ends before the last, so both flat ends and the interpolation
between rows are read.
"""
import ctypes

import numpy as np
import pytest
import torch

import terrarium_tpu_torch as tp
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.processes.soil.hydrology import saturation_sweeps

from test_torch_soil_physics import CELLS, NZ, random_state
from test_torch_step_adjoint import host_lib  # noqa: F401  (the compiled header)
from torch_parity import hold_until_saturation_flip, port_sim

STEPS, DT, IMPLICIT_DT = 30, 60.0, 300.0
SERIES_ROWS, SERIES_T0, SERIES_DTS = 6, 100.0, 250.0

SCHEMES = [("heun", "richards", "table"), ("heun", "richards", "series"),
           ("heun", "richards", "scalar series"), ("euler", "richards", "series"),
           ("euler", "heat", "table"), ("euler", "heat", "series"),
           ("heun", "heat", "scalar series")]


@pytest.fixture(scope="module")
def lib(host_lib):  # noqa: F811
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    host_lib.host_rollout_scheme.argtypes = (
        [ptr] * 4 + [ll, ll, ctypes.c_int] + [ctypes.c_double] * 3 + [ptr] * 5
        + [ctypes.c_int] * 5 + [ctypes.c_double, ll])
    return host_lib


def _case(stepper, physics, top_kind, seed):
    heat = physics == "heat"
    sim = port_sim("golden", CELLS, NZ)
    model = sim.model
    if heat:
        model = tp.SoilModel(grid=model.grid)
    U, sat, S = (torch.as_tensor(a).contiguous() for a in random_state(seed))
    if heat:
        sat = sat.clamp(0.0, 1.0)
    g = model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    rng = np.random.default_rng(seed + 100)
    if top_kind == "table":
        top = torch.as_tensor(rng.uniform(-6.0, 8.0, (STEPS + 1, CELLS)))
        if stepper == "euler":
            top = top[:-1]
    else:
        shape = (SERIES_ROWS, CELLS) if top_kind == "series" else (SERIES_ROWS,)
        top = fs.SeriesBC(torch.as_tensor(rng.uniform(-6.0, 8.0, shape)), SERIES_T0,
                          SERIES_DTS, 0.0, STEPS)
    return (U, sat, S), top, coords, fs.ColumnParams.of(model, torch.float64)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("stepper,physics,top_kind", SCHEMES)
def test_host_rollout_column_matches_plain(lib, stepper, physics, top_kind, seed):
    carry, top, coords, params = _case(stepper, physics, top_kind, seed)
    out = tuple(t.clone() for t in carry)
    if isinstance(top, fs.SeriesBC):
        data, rows, series = top.values, SERIES_ROWS, (top.t0, top.dts, top.time)
    else:
        data, rows, series = top, 0, (0.0, 0.0, 0.0)
    cp = fs._CParams.of(params)
    rc = lib.host_rollout_scheme(
        *(t.data_ptr() for t in (*out, data)), data.stride(0),
        data.stride(1) if data.dim() == 2 else 0, rows, *series,
        *(c.data_ptr() for c in coords), ctypes.addressof(cp), NZ, int(stepper == "heun"), 0,
        int(physics == "heat"), STEPS, DT, CELLS)
    assert rc == 0
    ref = fs.soil_column_rollout_plain(*carry, top, *coords, params, DT, stepper=stepper,
                                       physics=physics)
    for name, a, b in zip(("U", "sat", "S"), out, ref):
        assert bool(torch.isfinite(b).all()), name
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()),
                                   msg=name)
    if physics == "heat":  # the saturation is read, never written
        assert torch.equal(ref[1], carry[1]) and torch.equal(out[1], carry[1])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("top_kind", ["table", "series"])
@pytest.mark.parametrize("solver", ["thomas", "pcr"])
def test_host_implicit_column_matches_plain(lib, solver, top_kind, seed):
    """``soil::implicit_step`` (the closure, both systems' rows and their
    solves in registers) over 30 steps of 300 s from the random legal
    states, against ``soil_column_rollout_plain(..., stepper="implicit")``
    at 1e-12: the same operations in the same order, with FMAs off on both
    sides, apart from ``cbrt`` and the powers, an ulp apart. At 900 s a few
    columns of these states close a layer within an ulp of saturation,
    where the two sides part (`test_host_implicit_column_at_900_parts_only_
    at_saturation_flips`)."""
    carry, top, coords, params = _case("euler", "richards", top_kind, seed)
    out = tuple(t.clone() for t in carry)
    if isinstance(top, fs.SeriesBC):
        data, rows, series = top.values, SERIES_ROWS, (top.t0, top.dts, top.time)
    else:
        data, rows, series = top, 0, (0.0, 0.0, 0.0)
    cp = fs._CParams.of(params)
    rc = lib.host_rollout_scheme(
        *(t.data_ptr() for t in (*out, data)), data.stride(0),
        data.stride(1) if data.dim() == 2 else 0, rows, *series,
        *(c.data_ptr() for c in coords), ctypes.addressof(cp), NZ, 2,
        int(solver == "pcr"), 0, STEPS, IMPLICIT_DT, CELLS)
    assert rc == 0
    ref = fs.soil_column_rollout_plain(*carry, top, *coords, params, IMPLICIT_DT,
                                       stepper="implicit", solver=solver)
    for name, a, b in zip(("U", "sat", "S"), out, ref):
        assert bool(torch.isfinite(b).all()), name
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()),
                                   msg=name)
    assert not torch.equal(ref[1], carry[1])


def saturated(closed, params):
    """The ``se >= 1`` mask (where d(Psi)/d(sat) is 0) of the closed
    saturation ``closed``."""
    return (closed * params.por - params.theta_res) / params.vg_span >= 1.0


def closed_saturated(sat, dz, params):
    """:func:`saturated` of ``sat`` closed by the port's saturation
    adjustment, the sweeps of the header and of the plain version."""
    return saturated(saturation_sweeps(sat, dz[:, None])[0], params)


def plain_implicit_steps(carry, top, coords, params, dt, solver):
    """The plain implicit rollout, one step at a time, for
    :func:`torch_parity.hold_until_saturation_flip`."""
    for i in range(top.shape[0]):
        mask = closed_saturated(carry[1], coords[0], params)
        carry = fs.soil_column_rollout_plain(*carry, top[i:i + 1], *coords, params, dt,
                                             stepper="implicit", solver=solver)
        yield mask, carry


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("solver", ["thomas", "pcr"])
def test_host_implicit_column_at_900_parts_only_at_saturation_flips(lib, solver, seed):
    """At the configuration's 900 s the header and the plain version take
    30 steps from the random legal states: every column is held at 1e-12
    of each field's magnitude until a step starts with one of its levels
    closed at saturation on one side and an ulp below it on the other (one
    to three of the over-saturated and spilling columns, 8 to 19, from the
    third or the seventh step). There d(Psi)/d(sat) is 0 on one side and
    about 1e4 on the other, and the column parts by 0.37 in sat; the other
    columns are held through all 30 steps. JAX parts from the plain version
    at the same kind of step (`test_torch_implicit.py::test_jax_parts_from_
    the_plain_version_at_900_only_at_saturation_flips`)."""
    carry, top, coords, params = _case("euler", "richards", "table", seed)
    top = top[:STEPS]
    cp = fs._CParams.of(params)

    def host_steps(carry):
        for i in range(STEPS):
            mask = closed_saturated(carry[1], coords[0], params)
            carry = tuple(t.clone() for t in carry)
            row = top[i:i + 1]
            assert lib.host_rollout_scheme(
                *(t.data_ptr() for t in (*carry, row)), row.stride(0), row.stride(1), 0,
                0.0, 0.0, 0.0, *(c.data_ptr() for c in coords), ctypes.addressof(cp), NZ, 2,
                int(solver == "pcr"), 0, 1, 900.0, CELLS) == 0
            yield mask, carry

    flipped, gap = hold_until_saturation_flip(
        host_steps(carry), plain_implicit_steps(carry, top, coords, params, 900.0, solver),
        1e-12)
    cols = flipped.nonzero().flatten().tolist()
    near = (carry[1] >= 1.0 - 1e-9).any(0)  # a layer at or within 1e-9 of saturation
    assert cols and bool(near[flipped].all()) and gap > 0.3, f"columns {cols}, gap {gap}"


def test_host_implicit_refuses_the_heat_only_model(lib):
    carry, top, coords, params = _case("euler", "heat", "table", 0)
    out = tuple(t.clone() for t in carry)
    rc = lib.host_rollout_scheme(
        *(t.data_ptr() for t in (*out, top)), top.stride(0), top.stride(1), 0, 0.0, 0.0, 0.0,
        *(c.data_ptr() for c in coords), ctypes.addressof(fs._CParams.of(params)), NZ, 2, 0, 1,
        STEPS, IMPLICIT_DT, CELLS)
    assert rc == -1


@pytest.fixture(scope="module")
def picard_lib(lib):
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.host_rollout_picard.argtypes = (
        [ptr] * 4 + [ll, ll, ctypes.c_int] + [ctypes.c_double] * 3 + [ptr] * 5
        + [ctypes.c_int] * 5 + [ctypes.c_double, ll])
    return lib


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("top_kind", ["table", "series"])
@pytest.mark.parametrize("solver", ["thomas", "pcr"])
@pytest.mark.parametrize("physics", ["heat", "richards"])
def test_host_picard_column_matches_plain(picard_lib, physics, solver, top_kind, iters):
    """``soil::picard_step`` (ImplicitEuler with ``iters`` Picard
    iterations) in the rollout loop, 30 steps of 300 s from the random legal
    states with a per-column table or series, against
    ``soil_column_rollout_plain(..., stepper="implicit", picard_iters=)`` at
    1e-12 of each field's magnitude. Heat only: every column, the saturation
    never written. Heat + Richards: every column but at most four, each of
    which starts with a layer at or within 1e-9 of saturation, where an
    iterate may close an ulp either side of it on the two sides
    (`test_host_implicit_column_at_900_parts_only_at_saturation_flips`)."""
    carry, top, coords, params = _case("euler", physics, top_kind, 0)
    out = tuple(t.clone() for t in carry)
    if isinstance(top, fs.SeriesBC):
        data, rows, series = top.values, SERIES_ROWS, (top.t0, top.dts, top.time)
    else:
        data, rows, series = top[:STEPS], 0, (0.0, 0.0, 0.0)
    cp = fs._CParams.of(params)
    rc = picard_lib.host_rollout_picard(
        *(t.data_ptr() for t in (*out, data)), data.stride(0),
        data.stride(1) if data.dim() == 2 else 0, rows, *series,
        *(c.data_ptr() for c in coords), ctypes.addressof(cp), NZ, int(solver == "pcr"),
        int(physics == "heat"), iters, STEPS, IMPLICIT_DT, CELLS)
    assert rc == 0
    ref = fs.soil_column_rollout_plain(*carry, top if rows else data, *coords, params,
                                       IMPLICIT_DT, stepper="implicit", physics=physics,
                                       solver=solver, picard_iters=iters)
    parted = torch.zeros(CELLS, dtype=torch.bool)
    for name, a, b in zip(("U", "sat", "S"), out, ref):
        assert bool(torch.isfinite(b).all()), name
        d = (a - b).abs()
        parted |= (d.amax(0) if d.dim() == 2 else d) > 1e-12 * float(b.abs().max())
    if physics == "heat":
        assert not bool(parted.any()), parted.nonzero().flatten().tolist()
        assert torch.equal(ref[1], carry[1]) and torch.equal(out[1], carry[1])
    else:
        near = (carry[1] >= 1.0 - 1e-9).any(0)
        assert int(parted.sum()) <= 4 and bool(near[parted].all()), (
            parted.nonzero().flatten().tolist())
        assert not torch.equal(ref[1], carry[1])
