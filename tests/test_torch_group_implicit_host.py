"""The group rollout kernel's ImplicitEuler column code
(``soil::GroupColumn::picard_step`` in ``csrc/soil_group_step.cuh``: heat +
Richards, any number of Picard iterations, the rows across the group's
lanes, PCR across them and Thomas handed from lane to lane), compiled for
the host by the C++ compiler with each group's lanes emulated in lockstep
(``soil::HostLanes``, ``tests/soil_group_step_host.cpp``), against

* the one-thread-a-column loop that it replaces on the card
  (``soil::rollout_column`` of ``soil::picard_step``), bit for bit: both
  builds contract no multiply-adds and the group step forms each value by
  the same operations in the same order, so they are equal at every depth,
  group size, solver and Picard count, on `test_torch_soil_physics.py`'s
  random legal states and the sweeps' crossing columns
  (`test_torch_group_step_host.py`);
* the JAX package at float64, 1e-12: the ``implicit_freeze`` golden, and
  JAX's ``ImplicitEuler.pre_closure_step`` one step at a time along JAX's
  own trajectory. JAX takes ``cbrt`` as the kernels do, so the two round
  apart only where JAX's closed-form saturation adjustment and the port's
  sweeps close a level on opposite sides of saturation, where
  d(Psi)/d(sat) jumps (`test_torch_step_host.py::
  test_host_implicit_column_at_900_parts_only_at_saturation_flips`).
"""
import ctypes

import jax
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.processes.soil.hydrology import saturation_sweeps

from test_torch_group_step_host import _case, lib  # noqa: F401  (the compiled header)
from test_torch_soil_physics import CELLS, NZ as RANDOM_NZ, random_state
from torch_parity import CONFIGS, implicit_freeze, jax_soil, port_sim

DT, STEPS = 900.0, 12
SOLVERS = {"thomas": 0, "pcr": 1}
#: the group sizes held at each depth: the kernel's (None) at Nz 10 and 16,
#: every size at Nz 30
GROUPS = [(10, None), (16, None), (30, 4), (30, 8), (30, 16), (30, 32)]
GOLDEN = "implicit_freeze.npz"


@pytest.fixture(scope="module")
def ilib(lib):  # noqa: F811
    ptr, ll, i32, f64 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
    head = [ptr] * 4 + [ll, ll, i32] + [f64] * 3 + [ptr] * 5
    lib.host_thread_picard.argtypes = head + [i32] * 4 + [f64, ll]
    lib.host_group_picard.argtypes = head + [i32] * 5 + [f64, ll]
    lib.host_implicit_group_lanes.argtypes = [i32, i32]
    return lib


def run_picard(ilib, carry, top, coords, params, nz, solver, iters, g=None, steps=STEPS,
               dt=DT):
    """``steps`` implicit steps with ``iters`` Picard iterations, one thread
    a column (``g`` None) or on groups of ``g`` lanes; the new carry."""
    out = tuple(t.clone() for t in carry)
    if isinstance(top, fs.SeriesBC):
        data, rows, series = top.values, top.values.shape[0], (top.t0, top.dts, top.time)
    else:
        data, rows, series = top[:steps], 0, (0.0, 0.0, 0.0)
    cp = fs._CParams.of(params)  # held until the call returns
    cells = out[0].shape[1]
    head = (*(t.data_ptr() for t in (*out, data)), data.stride(0),
            data.stride(1) if data.dim() == 2 else 0, rows, *series,
            *(c.data_ptr() for c in coords), ctypes.addressof(cp), nz)
    if g is None:
        rc = ilib.host_thread_picard(*head, SOLVERS[solver], iters, steps, dt, cells)
    else:
        rc = ilib.host_group_picard(*head, g, SOLVERS[solver], iters, steps, dt, cells)
    assert rc == 0
    return out


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("top_kind", ["table", "series"])
@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("nz,group", GROUPS)
def test_group_picard_equals_the_thread_step_bitwise(ilib, nz, group, solver, top_kind, iters):
    """``GroupColumn::picard_step`` at the kernel's group size for ``nz``
    (``soil::implicit_group_lanes``) and, at Nz 30, at every G equals
    ``soil::picard_step`` in the one-thread loop bit for bit over 12 steps
    of 900 s on every column, the Picard count and the solver as given."""
    g = ilib.host_implicit_group_lanes(nz, SOLVERS[solver]) if group is None else group
    carry, top, coords, params = _case(ilib, nz, top_kind, g)
    want = run_picard(ilib, carry, top, coords, params, nz, solver, iters)
    got = run_picard(ilib, carry, top, coords, params, nz, solver, iters, g)
    for name, a, b in zip(("U", "sat", "S"), got, want):
        assert bool(torch.isfinite(b).all()), name
        assert torch.equal(a, b), (name, (a != b).nonzero()[:5].tolist())
    assert not torch.equal(want[1], carry[1])


def test_group_sizes_of_the_rule(ilib):
    """The implicit group size: PCR's is the explicit steps' (32 lanes above
    20 levels, 4 at 20 and below), Thomas' 8 above 20 levels and 4 at 20
    and below."""
    for nz in (10, 16, 20, 30, 40):
        assert ilib.host_implicit_group_lanes(nz, SOLVERS["pcr"]) == (32 if nz > 20 else 4)
        assert ilib.host_implicit_group_lanes(nz, SOLVERS["thomas"]) == (8 if nz > 20 else 4)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_implicit_freeze_golden_through_the_group_step(ilib, solver):
    """`tests/goldens/implicit_freeze.npz` (JAX's ImplicitEuler, PCR; 6
    cells, Nz 16, 48 steps of 3,600 s) through the host build of the group
    step at its group size, either solver, then the trailing ``closure`` and
    ``compute_auxiliary`` as ``Simulation.run`` takes them: every field at
    rtol = atol = 1e-12."""
    import pathlib

    sim = implicit_freeze("port", solver)
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    carry = tuple(sim.state.prognostic[n].contiguous() for n in sim.model.live_carry)
    top = torch.full((48, g.cells), -8.0, dtype=torch.float64)
    params = fs.ColumnParams.of(sim.model, torch.float64)
    nz = g.nz
    out = run_picard(ilib, carry, top, coords, params, nz, solver, 1,
                     ilib.host_implicit_group_lanes(nz, SOLVERS[solver]), steps=48, dt=3600.0)
    for name, x in zip(sim.model.live_carry, out):
        sim.state.prognostic[name] = x
    sim.model.closure(sim.state, sim.ctx)
    sim.compute_auxiliary()
    golden = np.load(pathlib.Path(__file__).parent / "goldens" / GOLDEN)
    for f in golden.files:
        np.testing.assert_allclose(sim.state[f].numpy(), golden[f], rtol=1e-12, atol=1e-12,
                                   err_msg=f)


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_group_step_matches_jax_along_its_trajectory(ilib, solver, iters):
    """JAX's ``ImplicitEuler.pre_closure_step`` (``picard_iters`` 1 and 2)
    and the host build of the group step at Nz 30 and its group size, one
    step of 900 s at a time from JAX's own carry over 12 steps, from the
    random legal states (resampled to Nz 30) with a per-column top
    temperature table: U and S at 1e-12 of the field's magnitude, sat at
    1e-12 of its magnitude plus the step's closure gap, the largest
    difference between JAX's closed-form saturation adjustment of the start
    and the port's sweeps (at most 1.2e-12 here; it rounds the column's
    cumulative water apart, ROADMAP Queue C), in every column but those that
    start the step with a layer at or within 1e-9 of saturation, as the rule
    of `test_torch_step_host.py::test_host_implicit_column_at_900_parts_
    only_at_saturation_flips` lets them go: there an ulp either side of a
    threshold of the closure (d(Psi)/d(sat) 0 at saturation, Mualem's
    1 / (1 - se^(1/m)) near it) parts the column, in JAX's iterate too."""
    nz = 30
    U, sat, S = random_state(0)
    rows = np.round(np.linspace(0, RANDOM_NZ - 1, nz)).astype(int)
    U, sat = U[rows], sat[rows]
    psim = port_sim("golden", CELLS, nz)
    pg = psim.model.grid
    coords = tuple(getattr(pg, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    params = fs.ColumnParams.of(psim.model, torch.float64)
    top = np.random.default_rng(100).uniform(-6.0, 8.0, (STEPS + 1, CELLS))
    times = np.arange(STEPS + 1) * DT
    jsim = tt.initialize(
        tt.SoilModel(grid=tt.ColumnGrid.of(cells=CELLS, spacing=tt.ExponentialSpacing(N=nz),
                                           nf=np.float64), soil=jax_soil()),
        tt.ImplicitEuler(dt=DT, solver=solver, picard_iters=iters),
        initializers=CONFIGS["golden"]["inits"],
        boundary_conditions=tt.PrescribedSurfaceTemperature("top"),
        input_sources=(tt.TimeSeriesInputSource(times=times, series={"top": top}),))
    model, ctx, sources = jsim.model, jsim.ctx, jsim.input_sources
    step = jax.jit(lambda s: jsim.timestepper.pre_closure_step(model, s, ctx, sources, DT))
    close = jax.jit(lambda s: model.closure(s, ctx)["saturation_water_ice"])
    g = ilib.host_implicit_group_lanes(nz, SOLVERS[solver])
    state = jsim.state.update(internal_energy=U, saturation_water_ice=sat,
                              surface_excess_water=S)
    names = ("internal_energy", "saturation_water_ice", "surface_excess_water")
    let_go, held = torch.zeros(CELLS, dtype=torch.bool), 0
    for i in range(STEPS):
        start = tuple(torch.as_tensor(np.array(state[n])) for n in names)
        gap = float((torch.as_tensor(np.array(close(state)))
                     - saturation_sweeps(start[1], coords[0][:, None])[0]).abs().max())
        assert gap < 1e-11, gap
        near = (start[1] >= 1.0 - 1e-9).any(0)
        got = run_picard(ilib, start, torch.as_tensor(top[i:i + 1]), coords, params, nz,
                         solver, iters, g, steps=1)
        state = step(state)
        parted = torch.zeros(CELLS, dtype=torch.bool)
        for name, a, b in zip(("U", "sat", "S"), got, (torch.as_tensor(np.array(state[n]))
                                                      for n in names)):
            assert bool(torch.isfinite(b).all()), name
            d = (a - b).abs()
            tol = 1e-12 * float(b.abs().max()) + (gap if name == "sat" else 0.0)
            parted |= (d.amax(0) if d.dim() == 2 else d) > tol
        bad = parted & ~near
        assert not bool(bad.any()), (i + 1, bad.nonzero().flatten().tolist())
        let_go |= parted
        held += int((~near).sum())
    # the rule lets go only a few of the columns that start near saturation
    assert int(let_go.sum()) <= CELLS // 4 and held >= STEPS * CELLS // 2, (
        let_go.nonzero().flatten().tolist(), held)
