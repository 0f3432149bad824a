"""The soil column CUDA kernels (the ForwardEuler, Heun, heat-only and
ImplicitEuler rollouts, the Picard and heat-only ImplicitEuler and Heun
entries among them, the segment VJP and the full step) and the LandModel
column kernel against their plain PyTorch versions, and ``run`` through the
process modules, on a CUDA device. Every test skips where
``torch.cuda.is_available()`` is False.

This file imports no JAX, so it also runs on a machine with a card and no
JAX (the repository's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py
"""
import dataclasses
import functools
import pathlib

import numpy as np
import pytest
import torch

import terrarium_tpu_torch as tp
from terrarium_tpu_torch.convert import with_differentiable_params
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.ops import fused_vjp as fv
from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout
from terrarium_tpu_torch.timesteppers.integrator import clock_times, top_temperature_table

GOLDEN = pathlib.Path(__file__).parent / "goldens" / "soil_heat_richards.npz"
HEUN_GOLDEN = GOLDEN.parent / "heun_forced.npz"
DT = 60.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bench_soil():
    props = tp.ConstantSoilHydraulics(swrc=tp.VanGenuchten(alpha=2.0, n=2.0),
                                      unsat_hydraulic_cond=tp.UnsatKVanGenuchten())
    return tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq(),
                                                               hydraulic_properties=props))


def _sim(cells, nz, dtype, device, dt=DT, golden=False):
    soil = _bench_soil()
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=dtype,
                            device=device)
    if golden:  # tests/test_goldens.py:20-36
        inits = {"temperature": lambda x, z: 2.0 * np.sin(2 * np.pi * x) - 0.05 * z,
                 "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.6 - 0.05 * z)}
        bc = lambda t: -5.0 + 0.0 * t  # noqa: E731
    else:  # bench.py:43-64
        inits = {"temperature": lambda x, z: 1.0 + 0.0 * z,
                 "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.5 - 0.05 * z)}
        bc = lambda t: 5.0 * torch.sin(2 * torch.pi * t / 86400.0)  # noqa: E731
    return tp.initialize(tp.SoilModel(grid=grid, soil=soil), tp.ForwardEuler(dt=dt),
                         initializers=inits,
                         boundary_conditions=tp.PrescribedSurfaceTemperature(bc))


def _operands(sim, steps, dt=DT):
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    carry = tuple(sim.state.prognostic[n] for n in sim.model.live_carry)
    table = top_temperature_table(sim.bcs["temperature"]["top"].value,
                                  clock_times(sim.state.clock.time, dt, steps)[:-1], g)
    return carry, table, coords, fs.ColumnParams.of(sim.model, g.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nz", [(torch.float64, 20), (torch.float64, 30),
                                      (torch.float32, 20), (torch.float32, 30)])
def test_kernel_matches_plain(cuda, dtype, nz):
    """float64: the kernel contracts a*b + c into FMAs and takes cbrt where
    the plain version takes pow(x, 1/3), a few ulps per step: 1e-12.
    float32: the same differences at float32 resolution over 48 steps: 1e-4
    of each field's largest magnitude."""
    sim = _sim(300, nz, dtype, cuda)
    carry, table, coords, params = _operands(sim, 48)
    before = fs.soil_column_rollout.launches
    out = fs.soil_column_rollout(*carry, table, *coords, params, DT)
    ref = fs.soil_column_rollout_plain(*carry, table, *coords, params, DT)
    torch.cuda.synchronize()
    assert fs.soil_column_rollout.launches == before + 1
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * float(b.abs().max()))


@pytest.mark.cuda
def test_kernel_takes_per_cell_top_temperature(cuda):
    """A ``(n, cells)`` table, here an expanded view with a zero step stride."""
    sim = _sim(130, 30, torch.float64, cuda)
    carry, _, coords, params = _operands(sim, 10)
    table = torch.linspace(-4.0, 6.0, 130, dtype=torch.float64, device=cuda)[None].expand(10, 130)
    out = fs.soil_column_rollout(*carry, table, *coords, params, DT)
    ref = fs.soil_column_rollout_plain(*carry, table, *coords, params, DT)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))


@pytest.mark.cuda
def test_kernel_rejects_unbuilt_nz(cuda):
    """An Nz that no prebuilt instantiation holds (12) is compiled at its
    first launch (``cuda_build.entry``), and the kernel matches the plain version at float32 (1e-4 of each
    field's largest magnitude). A dtype other than float32 and float64 is
    what still raises (``test_torch_cuda_build.py::test_other_dtypes_raise``)."""
    from terrarium_tpu_torch.ops import cuda_build

    sim = _sim(64, 12, torch.float32, cuda)
    carry, table, coords, params = _operands(sim, 2)
    assert all(nz != 12 for _, _, nz in cuda_build.INSTANTIATIONS["soil_column_group_rollout"])
    before = fs.soil_column_rollout.launches
    out = fs.soil_column_rollout(*carry, table, *coords, params, DT)
    ref = fs.soil_column_rollout_plain(*carry, table, *coords, params, DT)
    torch.cuda.synchronize()
    assert fs.soil_column_rollout.launches == before + 1
    _close(out, ref, 1e-4)


@pytest.mark.cuda
def test_simulation_run_goes_through_the_kernel_and_matches_golden(cuda):
    sim = _sim(8, 20, torch.float64, cuda, dt=300.0, golden=True)
    before = fs.soil_column_rollout.launches
    sim.run(steps=120, dt=300.0)
    assert fs.soil_column_rollout.launches > before
    golden = np.load(GOLDEN)
    for f in golden.files:
        np.testing.assert_allclose(sim.state[f].cpu().numpy(), golden[f], rtol=1e-12,
                                   atol=1e-12, err_msg=f)


# ---------------------------------------------------------------------------
# the group rollout (ForwardEuler and Heun over heat + Richards, a column on a
# group of lanes): states whose sweeps cross lanes, depths built at first use
# ---------------------------------------------------------------------------
def _crossing_sat(dz, lanes):
    """Six columns of saturations on the layers ``dz`` whose sweeps hand a
    carry across lanes of ``lanes`` levels (`test_torch_group_step_host.py
    ::crossing_columns`): an over-saturated run across a lane boundary and
    a wet lower half (up sweep), a negative level at a lane's bottom and a
    deficit at the top worth half the water below (down sweep), every level
    saturated, every level over-saturated (a spill)."""
    nz = dz.shape[0]
    sat = np.full((nz, 6), 0.6)
    sat[max(lanes - 2, 0):min(lanes + 2, nz - 1), 0] = 1.3
    sat[:nz // 2, 1] = 1.05
    sat[min(lanes, nz - 2), 2] = -0.4
    sat[:, 3] = 0.2
    sat[-1, 3] = -0.1 * dz[:-1].sum() / dz[-1]
    sat[:, 4] = 1.0
    sat[:, 5] = 1.02
    return sat


def _crossing_operands(device, dtype, nz, stepper, steps, reps=11):
    """The bench model on the six crossing columns, each ``reps`` times
    with energies from -2e8 (frozen) to 4e7 J/m^3, and a per-cell top
    temperature table of ``steps`` clock times (Heun: one more)."""
    cells = 6 * reps
    sim = _sim(cells, nz, dtype, device)
    dz = sim.model.grid.dz[:, 0]
    group = fs.group_occupancy(stepper, dtype, nz, False)[1]
    sat = np.tile(_crossing_sat(dz.cpu().numpy(), -(-nz // group)), reps)
    U = np.repeat(np.linspace(-2e8, 4e7, reps), 6)[None, :].repeat(nz, 0)
    S = np.full(cells, 0.01)
    carry = tuple(torch.as_tensor(a, dtype=dtype, device=device).contiguous()
                  for a in (U, sat, S))
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    rows = steps + (1 if stepper == "heun" else 0)
    table = (torch.linspace(-6.0, 8.0, cells, dtype=dtype, device=device)[None]
             + torch.arange(rows, dtype=dtype, device=device)[:, None] * 0.1).contiguous()
    return carry, table, coords, fs.ColumnParams.of(sim.model, dtype)


def _heun_stage_at_saturation(carry, table, coords, params):
    """The columns whose Heun stage, as the plain version forms it, closes a
    level within 1e-12 below saturation: there the stage's water table and
    head fall on either side of an ulp on the two sides."""
    from terrarium_tpu_torch.processes.soil.hydrology import saturation_sweeps

    sat, _, _, fsat, *_ = fs._plain_rhs(*carry, table[0], *(c[:, None] for c in coords),
                                        params, False)
    stage = saturation_sweeps(sat + fsat * DT, coords[0][:, None])[0]
    return ((stage < 1.0) & (stage > 1.0 - 1e-12)).any(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("stepper", ["euler", "heun"])
@pytest.mark.parametrize("nz", [20, 30])
def test_group_kernel_matches_plain_on_crossing_states(cuda, nz, stepper, dtype):
    """The group kernel on the crossing columns (Nz 30: 32 lanes of one
    level; Nz 20: 4 lanes of five, eight columns a warp), one step at a time
    along the plain version's trajectory over 12 steps: float64 at 1e-12 of
    each field's magnitude (Heun: but at a step whose stage closes a level
    within 1e-12 below saturation), float32 at 1e-4 of it. The first step's
    sweeps handed carries both up and down between lanes."""
    steps = 12
    carry, table, coords, params = _crossing_operands(cuda, dtype, nz, stepper, steps)
    wrapper = fs.ROLLOUTS[(stepper, "richards")]
    width = 2 if stepper == "heun" else 1
    _, (up, down) = fs.soil_column_group_handoffs(stepper, *carry, table[:width], *coords,
                                                  params, DT)
    assert up > 0 and down > 0, (up, down)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    for i in range(steps):
        top = table[i:i + width].contiguous()
        held = torch.ones(carry[0].shape[1], dtype=torch.bool, device=cuda)
        if stepper == "heun" and dtype == torch.float64:
            held = ~_heun_stage_at_saturation(carry, top, coords, params)
        before = wrapper.launches
        got = wrapper(*carry, top, *coords, params, DT)
        assert wrapper.launches == before + 1
        carry = fs.soil_column_rollout_plain(*carry, top, *coords, params, DT, stepper=stepper)
        for a, b in zip(got, carry):
            assert bool(torch.isfinite(a).all())
            torch.testing.assert_close(a[..., held], b[..., held], rtol=tol,
                                       atol=tol * float(b.abs().max()), msg=f"step {i + 1}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nz", [10, 40])
def test_group_kernel_built_on_demand_matches_plain(cuda, nz, dtype):
    """Depths no prebuilt group instantiation holds (10: 4 lanes of three
    levels; 40: 32 lanes of two), built at their first launch, ForwardEuler
    and Heun over 48 steps of the bench state against the plain version:
    1e-12 at float64, 1e-4 of each field's largest magnitude at float32."""
    from terrarium_tpu_torch.ops import cuda_build

    assert all(n != nz for _, _, n in cuda_build.INSTANTIATIONS["soil_column_group_rollout"])
    sim = _sim(300, nz, dtype, cuda)
    carry, table, coords, params = _operands(sim, 49)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    _close(fs.soil_column_rollout(*carry, table[:48], *coords, params, DT),
           fs.soil_column_rollout_plain(*carry, table[:48], *coords, params, DT), tol)
    _close(fs.soil_column_heun_rollout(*carry, table, *coords, params, DT),
           fs.soil_column_rollout_plain(*carry, table, *coords, params, DT, stepper="heun"),
           tol)


@pytest.mark.cuda
@pytest.mark.parametrize("stepper", ["euler", "heun"])
def test_simulation_run_launches_the_group_kernel_once_a_block(cuda, stepper):
    """A ``Simulation.run`` block of the bench composition (ForwardEuler,
    or Heun over an hourly series) is one launch of the group kernel; the
    state is finite and the saturation within [0, 1]."""
    if stepper == "euler":
        sim = _sim(500, 30, torch.float32, cuda)
    else:
        hours = np.arange(0.0, 25 * 3600.0, 3600.0)
        series = torch.as_tensor(5.0 * np.sin(2 * np.pi * hours / 86400.0)[:, None]
                                 + np.zeros((1, 500)), dtype=torch.float32, device=cuda)
        sim = _sim(500, 30, torch.float32, cuda)
        sim = tp.initialize(sim.model, tp.Heun(dt=DT),
                            initializers={"temperature": 1.0, "saturation_water_ice": lambda x, z:
                                          np.minimum(1.0, 0.5 - 0.05 * z)},
                            boundary_conditions=tp.PrescribedSurfaceTemperature(
                                "surface_temperature"),
                            input_sources=(tp.TimeSeriesInputSource(
                                times=hours,
                                series={"surface_temperature": series.contiguous()}),))
    wrapper = fs.ROLLOUTS[(stepper, "richards")]
    for block in range(2):
        before = wrapper.launches
        sim.run(steps=720)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, block
    sat = sim.state.saturation_water_ice
    assert bool(torch.isfinite(sim.state.internal_energy).all())
    assert float(sat.min()) >= 0.0 and float(sat.max()) <= 1.0
    assert sim.iteration == 1440


# ---------------------------------------------------------------------------
# Heun and the heat-only model, the top temperature from a series
# ---------------------------------------------------------------------------
def _close(out, ref, tol):
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * float(b.abs().max()))


def _forced(cells, nz, dtype, device, heat=False, scalar=False):
    """Operands of a forced run: an hourly series over a day, 5 sin(2 pi t /
    86400) plus an offset per cell (or the same for every cell, ``scalar``),
    read from t0 = 1800 s so that the first steps read its flat start."""
    sim = _sim(cells, nz, dtype, device)
    model = tp.SoilModel(grid=sim.model.grid) if heat else sim.model
    hours = np.arange(0.0, 25 * 3600.0, 3600.0)
    offset = 0.0 if scalar else np.linspace(-4.0, 8.0, cells)[None, :]
    series = torch.as_tensor(5.0 * np.sin(2 * np.pi * hours / 86400.0)[:, None] + offset,
                             device=device).to(dtype)
    values = series[:, 0].contiguous() if scalar else series.contiguous()
    g = model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    carry = (sim.state.prognostic["internal_energy"], sim.state.saturation_water_ice,
             None if heat else sim.state.prognostic["surface_excess_water"])
    return carry, values, coords, fs.ColumnParams.of(model, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nz", [(torch.float64, 15), (torch.float32, 30)])
def test_heun_series_kernel_matches_plain(cuda, dtype, nz):
    """The Heun kernel reading a (T, cells) series: 1e-12 at float64, 1e-4
    of each field's largest magnitude at float32 (as the Euler kernel)."""
    carry, values, coords, params = _forced(300, nz, dtype, cuda)
    bc = fs.SeriesBC(values, 1800.0, 3600.0, 0.0, 96)
    before = fs.soil_column_heun_rollout.launches
    out = fs.soil_column_heun_rollout(*carry, bc, *coords, params, DT)
    ref = fs.soil_column_rollout_plain(*carry, bc, *coords, params, DT, stepper="heun")
    torch.cuda.synchronize()
    assert fs.soil_column_heun_rollout.launches == before + 1
    _close(out, ref, 1e-12 if dtype == torch.float64 else 1e-4)


@pytest.mark.cuda
def test_heun_kernel_takes_a_scalar_series_and_a_table(cuda):
    """A (T,) series (one value for every cell, T != cells) and a per-cell
    table of steps + 1 rows, through the Heun kernel at float64."""
    carry, values, coords, params = _forced(130, 15, torch.float64, cuda, scalar=True)
    bc = fs.SeriesBC(values, 1800.0, 3600.0, 0.0, 40)
    _close(fs.soil_column_heun_rollout(*carry, bc, *coords, params, DT),
           fs.soil_column_rollout_plain(*carry, bc, *coords, params, DT, stepper="heun"),
           1e-12)
    table = torch.linspace(-4.0, 6.0, 130, dtype=torch.float64, device=cuda)[None] \
        + torch.arange(11, dtype=torch.float64, device=cuda)[:, None]
    _close(fs.soil_column_heun_rollout(*carry, table, *coords, params, DT),
           fs.soil_column_rollout_plain(*carry, table, *coords, params, DT, stepper="heun"),
           1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_heat_kernel_matches_plain(cuda, dtype):
    """The heat-only kernel, Nz 30, from a (T, cells) series and from a
    table; the saturation comes back as it went in."""
    carry, values, coords, params = _forced(300, 30, dtype, cuda, heat=True)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    bc = fs.SeriesBC(values, 1800.0, 3600.0, 0.0, 96)
    before = fs.soil_column_heat_rollout.launches
    out = fs.soil_column_heat_rollout(*carry, bc, *coords, params, DT)
    ref = fs.soil_column_rollout_plain(*carry, bc, *coords, params, DT, physics="heat")
    torch.cuda.synchronize()
    assert fs.soil_column_heat_rollout.launches == before + 1
    assert out[1] is carry[1] and out[2] is None
    _close(out[:1], ref[:1], tol)
    table = values[:48]
    _close(fs.soil_column_heat_rollout(*carry, table, *coords, params, DT)[:1],
           fs.soil_column_rollout_plain(*carry, table, *coords, params, DT,
                                        physics="heat")[:1], tol)


def _heun_forced_sim(device):
    """`tests/test_goldens.py:67-89`: 4 cells, Nz 15, float64, Heun at dt
    300, a 2-hourly (T, cells) air temperature."""
    props = tp.ConstantSoilHydraulics(swrc=tp.VanGenuchten(alpha=2.0, n=2.0),
                                      unsat_hydraulic_cond=tp.UnsatKVanGenuchten())
    soil = tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq(),
                                                               hydraulic_properties=props))
    grid = tp.ColumnGrid.of(cells=4, spacing=tp.ExponentialSpacing(N=15), dtype=torch.float64,
                            device=device)
    times = np.arange(0.0, 86401.0, 7200.0)
    series = (np.linspace(-4.0, 8.0, 4)[None, :]
              + 6.0 * np.sin(2 * np.pi * times / 86400.0)[:, None])
    return tp.initialize(
        tp.SoilModel(grid=grid, soil=soil), tp.Heun(),
        initializers={"temperature": 1.0,
                      "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.7 - 0.04 * z)},
        boundary_conditions=tp.PrescribedSurfaceTemperature("air_temperature"),
        input_sources=(tp.TimeSeriesInputSource(times=times,
                                                series={"air_temperature": series}),))


def _water(state, dz):
    return (state.saturation_water_ice * dz[:, None]).sum(0) + state.surface_excess_water


@pytest.mark.cuda
def test_heun_forced_golden_through_the_kernel(cuda):
    """Simulation.run, one launch of the Heun kernel for the 96 steps,
    against `heun_forced.npz` at 1e-12, and the water W = sum(sat dz) + S of
    every column kept to 1e-12."""
    sim = _heun_forced_sim(cuda)
    dz = sim.model.grid.dz[:, 0]
    w0 = _water(sim.state, dz)
    before = fs.soil_column_heun_rollout.launches
    sim.run(steps=96, dt=300.0)
    assert fs.soil_column_heun_rollout.launches == before + 1
    golden = np.load(HEUN_GOLDEN)
    for f in golden.files:
        np.testing.assert_allclose(sim.state[f].cpu().numpy(), golden[f], rtol=1e-12,
                                   atol=1e-12, err_msg=f)
    assert float(((_water(sim.state, dz) - w0).abs() / w0.abs()).max()) <= 1e-12


def _heat_only(device, ts):
    grid = tp.ColumnGrid.of(cells=70, spacing=tp.ExponentialSpacing(N=30),
                            dtype=torch.float32, device=device)
    return tp.initialize(tp.SoilModel(grid=grid), ts,
                         initializers={"temperature": 1.0, "saturation_water_ice": 0.8},
                         boundary_conditions=tp.PrescribedSurfaceTemperature(-3.0))


@pytest.mark.cuda
def test_default_model_runs_through_the_heat_kernel(cuda):
    """``SoilModel(grid=g)`` is the heat-only model; ForwardEuler runs it
    through the heat kernel, Heun through the heat-only Heun kernel (one
    launch each), matching the CPU's run (the plain version) at 1e-4 of
    each field; with a forcing, which no kernel takes, through the process
    modules on the card, as on the CPU."""
    for ts, wrapper in ((tp.ForwardEuler(dt=300.0), fs.soil_column_heat_rollout),
                        (tp.Heun(dt=300.0), fs.soil_column_heat_heun_rollout)):
        sim, cpu = _heat_only(cuda, ts), _heat_only("cpu", ts)
        before = wrapper.launches
        sim.run(steps=48)
        cpu.run(steps=48)
        assert wrapper.launches == before + 1
        assert bool(torch.isfinite(sim.state.temperature).all())
        assert float(sim.state.temperature[-1].max()) < 1.0
        ref = cpu.state.temperature
        torch.testing.assert_close(sim.state.temperature.cpu(), ref, rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()))

    def forced(device):
        sim = _heat_only(device, tp.Heun(dt=300.0))
        return tp.Simulation(sim.model, sim.timestepper, sim.state, bcs=sim.bcs,
                             forcings={"internal_energy": lambda state, grid: 2.0})

    _runs_through_the_modules(forced, 4)


def _launch_counts():
    return [f.launches for f in (fs.soil_column_rollout, fs.soil_column_heun_rollout,
                                 fs.soil_column_heat_rollout, fs.soil_column_implicit_rollout,
                                 fs.soil_column_heat_heun_rollout,
                                 fs.soil_column_heat_implicit_rollout,
                                 fs.soil_column_full_step, fv.soil_column_segment_vjp)]


def _runs_through_the_modules(make, steps):
    """``run`` of ``make("cuda")`` launches no kernel, stays on the card and
    equals the same run of ``make("cpu")`` (float32: 1e-4 of each field's
    largest magnitude; float64: 1e-12)."""
    sim, cpu = make(torch.device("cuda")), make("cpu")
    before = _launch_counts()
    sim.run(steps=steps)
    cpu.run(steps=steps)
    torch.cuda.synchronize()
    assert _launch_counts() == before
    tol = 1e-12 if sim.model.grid.dtype == torch.float64 else 1e-4
    for name in sim.model.live_carry + ("temperature",):
        v, ref = sim.state[name], cpu.state[name]
        assert v.device.type == "cuda", name
        torch.testing.assert_close(v.cpu(), ref, rtol=tol, atol=tol * float(ref.abs().max()))


# ---------------------------------------------------------------------------
# ImplicitEuler: Thomas and PCR
# ---------------------------------------------------------------------------
IMPLICIT_GOLDEN = GOLDEN.parent / "implicit_freeze.npz"


def _implicit_freeze_sim(device, solver):
    """`tests/test_goldens.py:92-113`: 6 cells, Nz 16, float64, ImplicitEuler
    at dt 3600, top temperature -8 degC as f(t)."""
    props = tp.ConstantSoilHydraulics(swrc=tp.VanGenuchten(alpha=2.0, n=2.0),
                                      unsat_hydraulic_cond=tp.UnsatKVanGenuchten())
    soil = tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq(),
                                                               hydraulic_properties=props))
    grid = tp.ColumnGrid.of(cells=6, spacing=tp.ExponentialSpacing(N=16), dtype=torch.float64,
                            device=device)
    return tp.initialize(
        tp.SoilModel(grid=grid, soil=soil), tp.ImplicitEuler(dt=3600.0, solver=solver),
        initializers={"temperature": lambda x, z: 3.0 * np.cos(2 * np.pi * x) + 0.1 * z,
                      "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.65 - 0.04 * z)},
        boundary_conditions=tp.PrescribedSurfaceTemperature(lambda t: -8.0 + 0.0 * t))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["pcr", "thomas"])
@pytest.mark.parametrize("dtype,nz", [(torch.float64, 16), (torch.float32, 30)])
def test_implicit_kernel_matches_plain(cuda, solver, dtype, nz):
    """The bench configuration at dt 900 for 48 steps (300 columns, a ragged
    last block): 1e-12 at float64 (FMA contraction and cbrt against pow(x,
    1/3), ulps a step); at float32 1e-4 of each field's largest magnitude,
    as the explicit kernels, which also covers a cell whose dT/dU switches
    on an ulp at the edge of the freeze plateau."""
    sim = _sim(300, nz, dtype, cuda, dt=900.0)
    carry, table, coords, params = _operands(sim, 48, dt=900.0)
    before = fs.soil_column_implicit_rollout.launches
    out = fs.soil_column_implicit_rollout(*carry, table, *coords, params, 900.0, solver=solver)
    ref = fs.soil_column_rollout_plain(*carry, table, *coords, params, 900.0,
                                       stepper="implicit", solver=solver)
    torch.cuda.synchronize()
    assert fs.soil_column_implicit_rollout.launches == before + 1
    _close(out, ref, 1e-12 if dtype == torch.float64 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["pcr", "thomas"])
def test_implicit_kernel_reads_a_series(cuda, solver):
    """A (T, cells) series read in the kernel, float64, Nz 16."""
    carry, values, coords, params = _forced(130, 16, torch.float64, cuda)
    bc = fs.SeriesBC(values, 1800.0, 3600.0, 0.0, 40)
    _close(fs.soil_column_implicit_rollout(*carry, bc, *coords, params, 900.0, solver=solver),
           fs.soil_column_rollout_plain(*carry, bc, *coords, params, 900.0, stepper="implicit",
                                        solver=solver), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["pcr", "thomas"])
def test_implicit_freeze_golden_through_the_kernel(cuda, solver):
    """Simulation.run, one launch of the implicit kernel for the 48 steps,
    against `implicit_freeze.npz` (PCR) at 1e-12, with either solver."""
    sim = _implicit_freeze_sim(cuda, solver)
    before = fs.soil_column_implicit_rollout.launches
    sim.run(steps=48, dt=3600.0)
    assert fs.soil_column_implicit_rollout.launches == before + 1
    golden = np.load(IMPLICIT_GOLDEN)
    for f in golden.files:
        np.testing.assert_allclose(sim.state[f].cpu().numpy(), golden[f], rtol=1e-12,
                                   atol=1e-12, err_msg=f)


@pytest.mark.cuda
def test_implicit_heat_only_has_no_kernel(cuda):
    """ImplicitEuler on the heat-only model now has its kernel
    (``soil_column_heat_implicit_rollout``): ``run`` launches it once, with
    one and with two Picard iterations, and matches the CPU's run (its
    plain version) at 1e-4 of each field."""
    for picard in (1, 2):
        ts = tp.ImplicitEuler(dt=3600.0, picard_iters=picard)
        sim, cpu = _heat_only(cuda, ts), _heat_only("cpu", ts)
        before = _launch_counts()
        sim.run(steps=12)
        cpu.run(steps=12)
        torch.cuda.synchronize()
        assert fs.soil_column_heat_implicit_rollout.launches == before[5] + 1
        assert sum(_launch_counts()) == sum(before) + 1
        ref = cpu.state.temperature
        torch.testing.assert_close(sim.state.temperature.cpu(), ref, rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nz", [(torch.float64, 16), (torch.float32, 30)])
def test_heat_heun_kernel_matches_plain(cuda, dtype, nz):
    """The heat-only Heun kernel from a (T, cells) series and from a table
    of steps + 1 rows: 1e-12 at float64, 1e-4 of each field's largest
    magnitude at float32; the saturation comes back as it went in."""
    carry, values, coords, params = _forced(300, nz, dtype, cuda, heat=True)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    bc = fs.SeriesBC(values, 1800.0, 3600.0, 0.0, 96)
    before = fs.soil_column_heat_heun_rollout.launches
    out = fs.soil_column_heat_heun_rollout(*carry, bc, *coords, params, 300.0)
    ref = fs.soil_column_rollout_plain(*carry, bc, *coords, params, 300.0, stepper="heun",
                                       physics="heat")
    torch.cuda.synchronize()
    assert fs.soil_column_heat_heun_rollout.launches == before + 1
    assert out[1] is carry[1] and out[2] is None
    _close(out[:1], ref[:1], tol)
    table = values[:49]
    _close(fs.soil_column_heat_heun_rollout(*carry, table, *coords, params, 300.0)[:1],
           fs.soil_column_rollout_plain(*carry, table, *coords, params, 300.0, stepper="heun",
                                        physics="heat")[:1], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("picard", [1, 2, 3])
@pytest.mark.parametrize("solver", ["pcr", "thomas"])
@pytest.mark.parametrize("dtype,nz", [(torch.float64, 16), (torch.float32, 30)])
def test_heat_implicit_kernel_matches_plain(cuda, dtype, nz, solver, picard):
    """The heat-only ImplicitEuler kernel with ``picard`` Picard iterations
    at dt 3600, 48 steps of a (T, cells) series that freezes and thaws the
    top: 1e-12 at float64, 1e-4 at float32."""
    carry, values, coords, params = _forced(300, nz, dtype, cuda, heat=True)
    bc = fs.SeriesBC(values, 1800.0, 3600.0, 0.0, 48)
    before = fs.soil_column_heat_implicit_rollout.launches
    out = fs.soil_column_heat_implicit_rollout(*carry, bc, *coords, params, 3600.0,
                                               solver=solver, picard_iters=picard)
    ref = fs.soil_column_rollout_plain(*carry, bc, *coords, params, 3600.0, stepper="implicit",
                                       physics="heat", solver=solver, picard_iters=picard)
    torch.cuda.synchronize()
    assert fs.soil_column_heat_implicit_rollout.launches == before + 1
    assert out[1] is carry[1] and out[2] is None
    _close(out[:1], ref[:1], 1e-12 if dtype == torch.float64 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("picard", [2, 3])
@pytest.mark.parametrize("solver", ["pcr", "thomas"])
@pytest.mark.parametrize("dtype,nz", [(torch.float64, 16), (torch.float32, 30)])
def test_picard_kernel_matches_plain(cuda, dtype, nz, solver, picard):
    """ImplicitEuler with ``picard`` Picard iterations over heat + Richards:
    the bench configuration at dt 900 for 48 steps (300 columns), as
    ``test_implicit_kernel_matches_plain`` holds one iteration; and
    ``implicit_freeze`` through ``run`` (one launch of the implicit
    wrapper) against the CPU's run at float64."""
    sim = _sim(300, nz, dtype, cuda, dt=900.0)
    carry, table, coords, params = _operands(sim, 48, dt=900.0)
    before = fs.soil_column_implicit_rollout.launches
    out = fs.soil_column_implicit_rollout(*carry, table, *coords, params, 900.0, solver=solver,
                                          picard_iters=picard)
    ref = fs.soil_column_rollout_plain(*carry, table, *coords, params, 900.0,
                                       stepper="implicit", solver=solver, picard_iters=picard)
    torch.cuda.synchronize()
    assert fs.soil_column_implicit_rollout.launches == before + 1
    _close(out, ref, 1e-12 if dtype == torch.float64 else 1e-4)
    if dtype == torch.float64:
        runs = []
        for device in (cuda, "cpu"):
            s = _implicit_freeze_sim(device, solver)
            s.timestepper = tp.ImplicitEuler(dt=3600.0, solver=solver, picard_iters=picard)
            runs.append(s.run(steps=24, dt=3600.0))
        assert fs.soil_column_implicit_rollout.launches == before + 2
        for name in ("internal_energy", "saturation_water_ice", "surface_excess_water"):
            b = runs[1].state[name]
            torch.testing.assert_close(runs[0].state[name].cpu(), b, rtol=1e-12,
                                       atol=1e-12 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# segment VJP: the gradient configuration of tests/test_torch_grad.py
# ---------------------------------------------------------------------------
GRAD_DT, LOG_KSAT = 300.0, float(np.log(1e-5))


def _grad_model(grid, log_ksat=LOG_KSAT):
    props = tp.ConstantSoilHydraulics(swrc=tp.VanGenuchten(alpha=2.0, n=2.0),
                                      unsat_hydraulic_cond=tp.UnsatKVanGenuchten())
    soil = tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq(),
                                                               hydraulic_properties=props))
    return tp.SoilModel(grid=grid, soil=with_differentiable_params(
        soil, log_sat_hydraulic_cond=log_ksat))


def _grad_sim(cells, nz, dtype, device):
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=dtype,
                            device=device)
    return tp.initialize(
        _grad_model(grid), tp.ForwardEuler(dt=GRAD_DT),
        initializers={"temperature": -1.0,
                      "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.6 - 0.04 * z)},
        boundary_conditions=tp.PrescribedSurfaceTemperature(4.0))


def _vjp_operands(sim, steps, seed):
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    carry = tuple(sim.state.prognostic[n].contiguous() for n in sim.model.live_carry)
    table = torch.full((steps,), 4.0, dtype=g.dtype, device=g.device)
    rng = np.random.default_rng(seed)
    cts = tuple(torch.as_tensor(rng.normal(size=tuple(t.shape)), device=g.device).to(g.dtype)
                for t in carry)
    return carry, table, coords, fs.ColumnParams.of(sim.model, g.dtype), cts


@pytest.mark.cuda
@pytest.mark.parametrize("nz", [20, 30])
def test_segment_vjp_kernel_matches_plain(cuda, nz):
    """float64, 300 columns (a ragged last block of 44), 24 steps: every
    cotangent within rtol 1e-9, with a floor of 1e-12 of its largest
    magnitude (the kernel contracts into FMAs, the plain version does not)."""
    sim = _grad_sim(300, nz, torch.float64, cuda)
    carry, table, coords, params, cts = _vjp_operands(sim, 24, nz)
    before = fv.soil_column_segment_vjp.launches
    out = fv.soil_column_segment_vjp(*carry, table, *coords, params, GRAD_DT, *cts)
    ref = fv.soil_column_segment_vjp_plain(*carry, table, *coords, params, GRAD_DT, *cts)
    torch.cuda.synchronize()
    assert fv.soil_column_segment_vjp.launches == before + 1
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12 * float(b.abs().max()))


@pytest.mark.cuda
def test_segment_vjp_kernel_keeps_the_water_identity(cuda):
    """The cotangents (gU, gsat, gS) = (0, dz, 1) are those of the total
    water W = sum(sat*dz) + S, which every step conserves: the kernel must
    return dz and 1 at every cell, the saturated ones included."""
    sim = _grad_sim(300, 20, torch.float64, cuda)
    carry, table, coords, params, _ = _vjp_operands(sim, 48, 0)
    dz = coords[0][:, None].expand(20, 300).contiguous()
    cts = (torch.zeros_like(carry[0]), dz, torch.ones_like(carry[2]))
    gU, gsat, gS, _, _ = fv.soil_column_segment_vjp(*carry, table, *coords, params, GRAD_DT,
                                                    *cts)
    assert bool((carry[1] == 1.0).any())
    torch.testing.assert_close(gsat, dz, rtol=1e-12, atol=0)
    torch.testing.assert_close(gS, torch.ones_like(gS), rtol=1e-12, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cells", [64, 130, 1000])
def test_segment_vjp_parameter_reduction(cuda, cells):
    """The per-block partials and their fixed-order sum: the parameter
    cotangents equal the plain version's sum over every column for a whole
    block, a ragged last block and many blocks, and a second launch gives
    the same bits."""
    sim = _grad_sim(cells, 20, torch.float64, cuda)
    carry, table, coords, params, cts = _vjp_operands(sim, 8, cells)
    a = fv.soil_column_segment_vjp(*carry, table, *coords, params, GRAD_DT, *cts)
    b = fv.soil_column_segment_vjp(*carry, table, *coords, params, GRAD_DT, *cts)
    ref = fv.soil_column_segment_vjp_plain(*carry, table, *coords, params, GRAD_DT, *cts)
    for i in (3, 4):
        assert torch.equal(a[i], b[i])
        torch.testing.assert_close(a[i], ref[i], rtol=1e-9, atol=0)


@pytest.mark.cuda
def test_fused_grad_rollout_launches_each_kernel_once_a_segment(cuda):
    sim = _grad_sim(200, 20, torch.float32, cuda)
    grid = sim.model.grid
    steps, inner = 24, 8
    roll = make_fused_grad_rollout(lambda x: _grad_model(grid, x), sim.timestepper, sim.ctx,
                                   steps=steps, dt=GRAD_DT, inner_steps=inner)
    x = torch.tensor(LOG_KSAT, dtype=torch.float64, device=cuda, requires_grad=True)
    f0, b0 = fs.soil_column_rollout.launches, fv.soil_column_segment_vjp.launches
    out = roll(sim.state, x)
    loss = out.temperature.mean() + out.saturation_water_ice.mean()
    (g,) = torch.autograd.grad(loss, x)
    torch.cuda.synchronize()
    assert fs.soil_column_rollout.launches - f0 == steps // inner
    assert fv.soil_column_segment_vjp.launches - b0 == steps // inner
    assert bool(torch.isfinite(g)) and float(g) != 0.0


# the segment VJP's other schemes: (stepper, physics, solver, dt, the Nz of
# its float64 instantiation, Picard iterations), each also built at float32
# Nz 30
VJP_SCHEMES = {"heun": ("heun", "richards", "pcr", 60.0, 15, 1),
               "implicit-thomas": ("implicit", "richards", "thomas", 900.0, 16, 1),
               "implicit-pcr": ("implicit", "richards", "pcr", 900.0, 16, 1),
               "heat": ("euler", "heat", "pcr", 300.0, 30, 1),
               "heat-heun": ("heun", "heat", "pcr", 300.0, 16, 1),
               "heat-implicit-pcr": ("implicit", "heat", "pcr", 3600.0, 16, 1),
               "heat-picard2-thomas": ("implicit", "heat", "thomas", 3600.0, 16, 2),
               "picard2-pcr": ("implicit", "richards", "pcr", 900.0, 16, 2),
               "picard3-thomas": ("implicit", "richards", "thomas", 900.0, 16, 3)}


def _scheme_sim(scheme, cells, nz, dtype, device):
    """The gradient configuration (T = -1 degC, sat = min(1, 0.6 - 0.04 z),
    top 4 degC) stepped by the scheme; heat only: the default model."""
    stepper, physics, solver, dt, _, picard = VJP_SCHEMES[scheme]
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=dtype,
                            device=device)
    model = _grad_model(grid) if physics == "richards" else tp.SoilModel(grid=grid)
    ts = {"heun": tp.Heun(dt=dt), "euler": tp.ForwardEuler(dt=dt),
          "implicit": tp.ImplicitEuler(dt=dt, solver=solver, picard_iters=picard)}[stepper]
    return tp.initialize(model, ts, initializers={
        "temperature": -1.0,
        "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.6 - 0.04 * z)},
        boundary_conditions=tp.PrescribedSurfaceTemperature(4.0))


def _scheme_operands(scheme, sim, steps, seed):
    stepper, physics, solver, dt, _, picard = VJP_SCHEMES[scheme]
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    carry = (sim.state.prognostic["internal_energy"].contiguous(),
             sim.state["saturation_water_ice"].contiguous(),
             None if physics == "heat" else sim.state.prognostic["surface_excess_water"])
    table = torch.linspace(2.0, 5.0, steps + (stepper == "heun"), dtype=g.dtype,
                           device=g.device)
    rng = np.random.default_rng(seed)
    cts = tuple(None if t is None else
                torch.as_tensor(rng.normal(size=tuple(t.shape)), device=g.device).to(g.dtype)
                for t in carry)
    kw = dict(stepper=stepper, physics=physics, solver=solver, picard_iters=picard)
    return carry, table, coords, fs.ColumnParams.of(sim.model, g.dtype), dt, cts, kw


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", VJP_SCHEMES)
def test_segment_vjp_scheme_kernel_matches_plain(cuda, scheme):
    """Each scheme's VJP kernel at float64 on 300 columns (a ragged last
    block), 24 steps, against torch autograd through the plain rollout:
    every cotangent within rtol 1e-9 with a floor of 1e-12 of its largest
    magnitude; one launch; heat only: no pool cotangent, K_sat's 0."""
    nz = VJP_SCHEMES[scheme][4]
    sim = _scheme_sim(scheme, 300, nz, torch.float64, cuda)
    carry, table, coords, params, dt, cts, kw = _scheme_operands(scheme, sim, 24, nz)
    before = fv.soil_column_segment_vjp.launches
    out = fv.soil_column_segment_vjp(*carry, table, *coords, params, dt, *cts, **kw)
    ref = fv.soil_column_segment_vjp_plain(*carry, table, *coords, params, dt, *cts, **kw)
    torch.cuda.synchronize()
    assert fv.soil_column_segment_vjp.launches == before + 1
    for a, b in zip(out, ref):
        if b is None:
            assert a is None
            continue
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12 * float(b.abs().max()))
    if kw["physics"] == "heat":
        assert float(out[3]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["heun", "implicit-thomas", "implicit-pcr", "picard2-pcr",
                                    "picard3-thomas"])
def test_segment_vjp_scheme_kernel_keeps_the_water_identity(cuda, scheme):
    """The cotangents (0, dz, 1) of the total water, which every Heun and
    implicit step conserves, through the kernel: dz and 1 at every cell
    (rtol 1e-12 for Heun, 1e-10 for the implicit solves)."""
    nz = VJP_SCHEMES[scheme][4]
    sim = _scheme_sim(scheme, 300, nz, torch.float64, cuda)
    carry, table, coords, params, dt, _, kw = _scheme_operands(scheme, sim, 24, 0)
    dz = coords[0][:, None].expand(nz, 300).contiguous()
    _, gsat, gS, _, _ = fv.soil_column_segment_vjp(
        *carry, table, *coords, params, dt, torch.zeros_like(carry[0]), dz,
        torch.ones_like(carry[2]), **kw)
    rtol = 1e-12 if scheme == "heun" else 1e-10
    assert bool((carry[1] == 1.0).any())
    torch.testing.assert_close(gsat, dz, rtol=rtol, atol=0)
    torch.testing.assert_close(gS, torch.ones_like(gS), rtol=rtol, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", VJP_SCHEMES)
def test_fused_grad_rollout_launches_each_scheme_once_a_segment(cuda, scheme):
    """make_fused_grad_rollout of each scheme at float32, Nz 30: one forward
    launch of the scheme's rollout kernel and one VJP launch a segment, and
    a finite, non-zero gradient in k_mineral."""
    stepper, physics, solver, dt, _, _ = VJP_SCHEMES[scheme]
    sim = _scheme_sim(scheme, 200, 30, torch.float32, cuda)
    grid = sim.model.grid
    steps, inner = 24, 8

    def model_fn(k):
        base = _grad_model(grid) if physics == "richards" else tp.SoilModel(grid=grid)
        return tp.SoilModel(grid=grid, soil=with_differentiable_params(
            base.soil, mineral_conductivity=k))

    roll = make_fused_grad_rollout(model_fn, sim.timestepper, sim.ctx, steps=steps, dt=dt,
                                   inner_steps=inner)
    k = torch.tensor(3.8, dtype=torch.float64, device=cuda, requires_grad=True)
    fwd = fs.ROLLOUTS[stepper, physics]
    f0, b0 = fwd.launches, fv.soil_column_segment_vjp.launches
    out = roll(sim.state, k)
    (g,) = torch.autograd.grad(out.temperature.mean(), k)
    torch.cuda.synchronize()
    assert fwd.launches - f0 == steps // inner
    assert fv.soil_column_segment_vjp.launches - b0 == steps // inner
    assert bool(torch.isfinite(g)) and float(g) != 0.0


# ---------------------------------------------------------------------------
# the LandModel column kernel
# ---------------------------------------------------------------------------
LAND_GOLDEN = GOLDEN.parent / "land_model.npz"


def _land_sim(cells, dtype, device, vegetated=True, nz=20, stepper=None, snow=False,
              static=False):
    """The vegetated composition of `examples/land_global.py` with
    ``DirectSurfaceRunoff.consistent()`` over loam Richards flow (Brooks-
    Corey, linear conductivity), or the default bare-ground model (heat only,
    Nz 15, the golden's); hourly series of shortwave and air temperature
    over latitudes from -60 to 80 degrees (``static``: their daytime values
    as static fields); ForwardEuler at dt 600 or ``stepper``; with ``snow``
    a ``Snowpack()``, a snowfall of 2e-8 m/s and an initial SWE of 0.02 m."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=dtype,
                            device=device)
    if not vegetated:
        return tp.initialize(
            tp.LandModel(grid=grid), stepper or tp.ForwardEuler(),
            initializers={"temperature": 5.0, "saturation_water_ice": 0.8},
            input_sources=(tp.FieldInputSource(fields={
                "surface_shortwave_down": 400.0, "air_temperature": 12.0,
                "rainfall": 1.0e-7}),))
    soil = tp.SoilEnergyWaterCarbon(
        strat=tp.HomogeneousStratigraphy(texture=tp.SoilTexture.preset("loam")),
        hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq()))
    model = tp.LandModel(
        grid=grid, vegetation=tp.VegetationCarbon.consistent_units(), soil=soil,
        atmosphere=tp.PrescribedAtmosphere(aerodynamics=tp.MoninObukhovAerodynamics()),
        surface_energy_balance=tp.SurfaceEnergyBalance.consistent(),
        surface_hydrology=tp.SurfaceHydrology(
            evapotranspiration=tp.PALADYNCanopyEvapotranspiration.consistent_units(
                ground_resistance=tp.SoilMoistureResistanceFactor()),
            surface_runoff=tp.DirectSurfaceRunoff.consistent()))
    lat = np.linspace(-60.0, 80.0, cells)
    coslat = np.maximum(np.cos(np.deg2rad(lat)), 0.05)
    hours = np.arange(0.0, 3 * 86400.0, 3600.0)
    day = hours[:, None] / 86400.0
    sw = 900.0 * coslat[None, :] * np.maximum(0.0, np.sin(2 * np.pi * (day - 0.25)))
    ta = (28.0 * coslat - 8.0)[None, :] + 6.0 * np.sin(2 * np.pi * (day - 0.3))
    fields = {"surface_longwave_down": 330.0, "rainfall": 4.0e-8, "windspeed": 3.0}
    inits = {"temperature": lambda x, z: (28.0 * coslat - 8.0)[None, :] + 0.0 * z,
             "saturation_water_ice": 0.6, "carbon_vegetation": 2.0,
             "vegetation_area_fraction": 0.5}
    if snow:
        model = dataclasses.replace(model, snow=tp.Snowpack())
        fields["snowfall"] = 2.0e-8
        inits["snow_water_equivalent"] = 0.02
    if static:
        fields.update(surface_shortwave_down=600.0 * coslat, air_temperature=28.0 * coslat - 5.0)
        return tp.initialize(model, stepper or tp.ForwardEuler(dt=600.0),
                             (tp.FieldInputSource(fields=fields),), initializers=inits)
    return tp.initialize(
        model, stepper or tp.ForwardEuler(dt=600.0),
        (tp.TimeSeriesInputSource(times=hours, series={"surface_shortwave_down": sw,
                                                       "air_temperature": ta}),
         tp.FieldInputSource(fields=fields)), initializers=inits)


@pytest.mark.cuda
def test_land_golden_through_the_kernel(cuda):
    """`tests/test_goldens.py:40-49` (bare ground over heat only, Nz 15,
    float64, 48 steps at dt 300) through the land kernel, one launch, at
    1e-12."""
    from terrarium_tpu_torch.ops import land_step as ls

    sim = _land_sim(4, torch.float64, cuda, vegetated=False, nz=15)
    before = ls.land_column_rollout.launches
    sim.run(steps=48, dt=300.0)
    torch.cuda.synchronize()
    assert ls.land_column_rollout.launches == before + 1
    golden = np.load(LAND_GOLDEN)
    for f in golden.files:
        np.testing.assert_allclose(sim.state[f].cpu().numpy(), golden[f], rtol=1e-12,
                                   atol=1e-12, err_msg=f)


def _land_f32_tolerance(name, plain, start, outside):
    """Per cell, what the float32 land step may part from its plain version
    by after one step from the carry ``start``: 1e-4 of the field's largest
    change in the step plus 16 units of 2^-23 of the value for the soil's
    energy and saturation (a difference of face fluxes over thin layers) or
    2 for a surface field (the two round a like change apart); the net
    assimilation, written afresh each step, 1e-4 of its largest magnitude;
    the saturation and the pool of the columns ``outside`` (a start-of-step
    layer outside [0, 1], whose adjustment is of the state's size), 1e-4 of
    the field's largest magnitude as well."""
    value = plain.abs()
    if name == "net_assimilation":
        return torch.full_like(plain, 1e-4 * float(value.max()))
    units = 16 if plain.dim() == 2 else 2
    tol = 1e-4 * float((plain - start).abs().max()) + units * 2.0 ** -23 * value
    if name in ("saturation_water_ice", "surface_excess_water"):
        tol = torch.where(outside, torch.clamp(tol, min=1e-4 * float(value.max())), tol)
    return tol


def _land_teacher(sim, dtype, kernel, plain, steps=48, dt=600.0):
    """The land kernel ``kernel`` against its plain version ``plain`` along
    the plain version's trajectory (see ``test_land_kernel_matches_plain``):
    ``steps`` steps of ``dt``, one launch against the chain of one-step
    launches. Returns the wrapper's launches of the one-launch rollout."""
    from terrarium_tpu_torch.ops import land_step as ls
    from terrarium_tpu_torch.timesteppers.integrator import land_inputs

    model, st = sim.model, sim.state
    params = ls.LandParams.of(model, dtype)
    carry = {n: st[n].contiguous() for n in ls.carry_names(params)}
    coords = tuple(getattr(model.grid, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    inputs = land_inputs(model, st, sim.input_sources)
    root = st.auxiliary["root_fraction"]
    wrapper = getattr(kernel, "func", kernel)
    before = wrapper.launches
    whole = kernel(carry, inputs, root, *coords, params, dt, 0.0, steps)
    launches = wrapper.launches - before
    cp, chain = dict(carry), dict(carry)
    t = (np.float32 if dtype == torch.float32 else np.float64)(0.0)
    for _ in range(steps):
        k1 = kernel(cp, inputs, root, *coords, params, dt, float(t), 1)
        p1 = plain(cp, inputs, root, *coords, params, dt, float(t), 1)
        chain = {**chain, **kernel(chain, inputs, root, *coords, params, dt, float(t), 1)}
        s0 = cp["saturation_water_ice"]
        outside = ((s0 > 1.0) | (s0 < 0.0)).any(0)
        for name in model.live_carry:
            a, b = k1[name], p1[name]
            assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()), name
            if dtype == torch.float64:
                torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()),
                                           msg=name)
            else:
                a, b = a.double(), b.double()
                tol = _land_f32_tolerance(name, b, cp[name].double(), outside)
                assert bool(((a - b).abs() <= tol).all()), name
        cp = {**cp, **p1}
        t = t + t.dtype.type(dt)
    torch.cuda.synchronize()
    for name in model.live_carry:
        assert torch.equal(whole[name], chain[name]), name
    return launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_land_kernel_matches_plain(cuda, dtype):
    """The vegetated consistent composition on 300 columns over 48 steps of
    600 s along the plain version's trajectory: at each step one kernel step
    and one plain step from the same carry, float64 within 1e-12 (relative,
    with a floor of 1e-12 of the field's magnitude: libdevice's
    transcendentals against torch's), float32 by each field's change in the
    step (``_land_f32_tolerance``: FMA contraction), so that a zeroed,
    doubled or reversed tendency fails even where it moves the state by
    less than 1e-4 of its magnitude; every value finite. The composition's
    explicit Richards flow is unstable at dt 600 (PERF.md), so two free
    rollouts part by amplified rounding; one step from a shared carry does
    not amplify. The one-launch rollout equals the kernel's chain of
    one-step launches bit for bit."""
    from terrarium_tpu_torch.ops import land_step as ls

    assert _land_teacher(_land_sim(300, dtype, cuda), dtype, ls.land_column_rollout,
                         ls.land_column_rollout_plain) == 1


LAND_VARIANTS = ["heun", "implicit-thomas", "implicit-pcr", "implicit-pcr-snow",
                 "implicit-pcr-picard2", "implicit-thomas-picard2", "implicit-pcr-picard3-snow"]


def _land_variant(name):
    """(stepper, kernel wrapper, plain version) of a land variant:
    ``<stepper>[-<solver>][-picard<k>][-snow]``."""
    from terrarium_tpu_torch.ops import land_step as ls

    key, *rest = name.split("-")
    kw = {"solver": rest[0]} if rest and rest[0] in ("pcr", "thomas") else {}
    for part in rest:
        if part.startswith("picard"):
            kw["picard_iters"] = int(part[len("picard"):])
    stepper = tp.Heun(dt=600.0) if key == "heun" else tp.ImplicitEuler(dt=600.0, **kw)
    return (stepper, functools.partial(ls.ROLLOUTS[key], **kw),
            functools.partial(ls.land_column_rollout_plain, stepper=key, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("variant", LAND_VARIANTS)
def test_land_variant_kernel_matches_plain(cuda, variant, dtype):
    """Heun, ImplicitEuler (Thomas, PCR; one Picard iteration, two, and
    three under a snowpack, whose instantiation is built at its first
    launch) and ImplicitEuler under a snowpack
    over the composition of ``test_land_kernel_matches_plain``, held to the
    plain version of the same stepper by its rule. Heun's float32 check
    steps at dt 60: at dt 600 its stage, the explicit Richards step, leaves
    [0, 1] and its float32 rounding moves the corrector beyond a field's
    change in a step (``chip_smoke.LAND_HEUN_F32_DT``)."""
    stepper, kernel, plain = _land_variant(variant)
    sim = _land_sim(300, dtype, cuda, stepper=stepper, snow=variant.endswith("snow"))
    dt = 60.0 if variant == "heun" and dtype == torch.float32 else 600.0
    assert _land_teacher(sim, dtype, kernel, plain, dt=dt) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("variant", LAND_VARIANTS)
def test_land_run_takes_each_stepper_kernel(cuda, variant):
    """``Simulation.run`` of each land variant at float32 goes through its
    kernel: one launch of that wrapper for the block and none of another."""
    from terrarium_tpu_torch.ops import land_step as ls

    stepper, kernel, _ = _land_variant(variant)
    sim = _land_sim(300, torch.float32, cuda, stepper=stepper, snow=variant.endswith("snow"))
    before = {k: f.launches for k, f in ls.ROLLOUTS.items()}
    sim.run(steps=24)
    torch.cuda.synchronize()
    after = {k: f.launches - before[k] for k, f in ls.ROLLOUTS.items()}
    assert after == {k: int(k == variant.partition("-")[0]) for k in ls.ROLLOUTS}
    assert all(bool(torch.isfinite(sim.state[n]).all()) for n in sim.model.live_carry)


@pytest.mark.cuda
def test_land_snow_golden_through_the_kernel(cuda):
    """`tests/test_goldens.py:52-64` (bare ground, Richards over the default
    hydraulics, ``Snowpack()``, Nz 12, float64, 48 steps at dt 300) through
    the land kernel, one launch: the snowpack's fields at 1e-12 of the
    golden, every field at 1e-12 of the plain version's run (the soil's
    energy and saturation part from the golden: its explicit Richards step
    is unstable at dt 300, ROADMAP Queue C)."""
    from terrarium_tpu_torch.ops import land_step as ls
    from terrarium_tpu_torch.timesteppers.integrator import advance

    def make():
        grid = tp.ColumnGrid.of(cells=4, spacing=tp.ExponentialSpacing(N=12),
                                dtype=torch.float64, device=cuda)
        model = tp.LandModel(grid=grid, snow=tp.Snowpack(), soil=tp.SoilEnergyWaterCarbon(
            hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq())))
        return tp.initialize(model, tp.ForwardEuler(),
                             initializers={"temperature": 1.0, "saturation_water_ice": 0.6,
                                           "snow_water_equivalent": 0.02},
                             input_sources=(tp.FieldInputSource(fields={
                                 "air_temperature": 4.0, "snowfall": 5.0e-8,
                                 "surface_shortwave_down": 250.0}),))

    sim, ref = make(), make()
    before = ls.land_column_rollout.launches
    sim.run(steps=48, dt=300.0)
    torch.cuda.synchronize()
    assert ls.land_column_rollout.launches == before + 1
    advance(ref.model, ref.state, ref.ctx, 48, 300.0, input_sources=ref.input_sources,
            plain=True)
    ref.compute_auxiliary()
    golden = np.load(GOLDEN.parent / "land_snow.npz")
    for f in ("snow_water_equivalent", "snow_cover_fraction", "surface_shortwave_up"):
        np.testing.assert_allclose(sim.state[f].cpu().numpy(), golden[f], rtol=1e-12,
                                   atol=1e-12, err_msg=f)
    for f in (*golden.files, *sim.model.live_carry):
        a, b = sim.state[f], ref.state[f]
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()), msg=f)


# ---------------------------------------------------------------------------
# one full step (make_fused_step)
# ---------------------------------------------------------------------------
def _full_sim(cells, nz, dtype, device, stepper="euler", physics="richards", forcings=None):
    """The bench top temperature 5 sin(2 pi t / 86400) as f(t) over the
    bench soil or the default heat-only model, from varied columns, dt 60."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=dtype,
                            device=device)
    model = (tp.SoilModel(grid=grid, soil=_bench_soil()) if physics == "richards"
             else tp.SoilModel(grid=grid))
    ts = tp.Heun(dt=DT) if stepper == "heun" else tp.ForwardEuler(dt=DT)
    return tp.initialize(
        model, ts, initializers={
            "temperature": lambda x, z: 2.0 * np.sin(2 * np.pi * x) - 0.05 * z,
            "saturation_water_ice": (lambda x, z: np.minimum(1.0, 0.6 - 0.05 * z))
            if physics == "richards" else 0.8},
        boundary_conditions=tp.PrescribedSurfaceTemperature(
            lambda t: 5.0 * torch.sin(2 * torch.pi * t / 86400.0)), forcings=forcings)


def _assert_full_close(k_state, p_state, rtol, dt=DT):
    """Every prognostic, tendency and auxiliary and the clock (the rule of
    ``chip_smoke.check_full_step``): float64 each element within ``rtol``
    with a floor of ``rtol`` times the scale, float32 the largest error
    within ``rtol`` of the scale; the scale is the leaf's largest magnitude,
    a tendency's at least its prognostic's over ``dt``."""
    for g in ("prognostic", "tendencies", "auxiliary"):
        assert sorted(getattr(k_state, g)) == sorted(getattr(p_state, g)), g
        for key, b in getattr(p_state, g).items():
            a = getattr(k_state, g)[key]
            assert a.shape == b.shape and bool(torch.isfinite(a).all()), (g, key)
            scale = float(b.abs().max())
            if g == "tendencies":
                scale = max(scale, float(p_state.prognostic[key].abs().max()) / dt)
            d = (a - b).abs()
            if rtol <= 1e-9:
                assert not bool((d > rtol * b.abs() + rtol * scale).any()), (g, key, d.max())
            else:
                assert float(d.max()) <= rtol * scale, (g, key, float(d.max()), scale)
    assert float(k_state.clock.time) == float(p_state.clock.time)
    assert int(k_state.clock.iteration) == int(p_state.clock.iteration)


def _fused(sim):
    return fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources, dt=DT)


@pytest.mark.cuda
@pytest.mark.parametrize("stepper,nz", [("euler", 20), ("heun", 15)])
def test_full_step_kernel_matches_plain_f64(cuda, stepper, nz):
    """float64, 300 columns, one kernel step and one plain step from each
    state of 3 steps of the plain trajectory: every leaf at 1e-12."""
    sim = _full_sim(300, nz, torch.float64, cuda, stepper)
    fused = _fused(sim)
    state = sim.state
    for _ in range(3):
        before = fs.soil_column_full_step.launches
        out = fused(state)
        assert fs.soil_column_full_step.launches == before + 1
        plain = fs.soil_column_full_step_plain(sim.model, sim.timestepper, sim.ctx, (), state,
                                               DT)
        torch.cuda.synchronize()
        _assert_full_close(out, plain, 1e-12)
        state = plain


@pytest.mark.cuda
@pytest.mark.parametrize("stepper,physics", [("euler", "richards"), ("heun", "richards"),
                                             ("euler", "heat"), ("heun", "heat")])
def test_full_step_kernel_matches_plain_f32(cuda, stepper, physics):
    """float32 at Nz 30 on 2,000 columns: every leaf within 1e-4 of its
    scale."""
    sim = _full_sim(2000, 30, torch.float32, cuda, stepper, physics)
    out = _fused(sim)(sim.state)
    plain = fs.soil_column_full_step_plain(sim.model, sim.timestepper, sim.ctx, (), sim.state,
                                           DT)
    torch.cuda.synchronize()
    _assert_full_close(out, plain, 1e-4)


@pytest.mark.cuda
def test_full_step_kernel_reads_an_input_variable_and_refuses_other_nz(cuda):
    """The heat-only model with the top temperature an input variable of a
    static source, per cell; a grid of an Nz that no prebuilt instantiation
    holds (12) has its full step compiled at the first call, and it matches
    the plain version."""
    grid = tp.ColumnGrid.of(cells=130, spacing=tp.ExponentialSpacing(N=30), dtype=torch.float32,
                            device=cuda)
    sim = tp.initialize(tp.SoilModel(grid=grid), tp.ForwardEuler(dt=DT),
                        (tp.FieldInputSource(fields={"surface_temperature":
                                                     np.linspace(-8.0, 6.0, 130)}),),
                        initializers={"temperature": 1.0, "saturation_water_ice": 0.8},
                        boundary_conditions=tp.PrescribedSurfaceTemperature("surface_temperature"))
    out = _fused(sim)(sim.state)
    plain = fs.soil_column_full_step_plain(sim.model, sim.timestepper, sim.ctx,
                                           sim.input_sources, sim.state, DT)
    _assert_full_close(out, plain, 1e-4)
    small = _full_sim(64, 12, torch.float32, cuda)
    _assert_full_close(_fused(small)(small.state),
                       fs.soil_column_full_step_plain(small.model, small.timestepper, small.ctx,
                                                      small.input_sources, small.state, DT),
                       1e-4)


#: ImplicitEuler full steps of the soil: (physics, solver, Picard iterations)
FULL_IMPLICIT = [("richards", "pcr", 1), ("richards", "thomas", 2), ("heat", "pcr", 2),
                 ("heat", "thomas", 1)]


def _full_implicit_sim(cells, dtype, device, physics, solver, picard):
    """The full-step composition by ImplicitEuler at dt 900 s, at Nz 16
    (float64) or 30 (float32), the prebuilt sizes."""
    sim = _full_sim(cells, 16 if dtype == torch.float64 else 30, dtype, device, "euler",
                    physics)
    sim.timestepper = tp.ImplicitEuler(dt=900.0, solver=solver, picard_iters=picard)
    return sim


@pytest.mark.cuda
@pytest.mark.parametrize("physics,solver,picard", FULL_IMPLICIT)
def test_full_step_implicit_kernel_matches_plain_f64(cuda, physics, solver, picard):
    """ImplicitEuler at dt 900 s, float64 at Nz 16 on 300 columns (the heat-
    only instantiation built at its first launch): one kernel step and one
    plain step from each state of 3 steps of the plain trajectory, every
    leaf at 1e-12, one launch a call."""
    sim = _full_implicit_sim(300, torch.float64, cuda, physics, solver, picard)
    fused = fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources, dt=900.0)
    state = sim.state
    for _ in range(3):
        before = fs.soil_column_full_step.launches
        out = fused(state)
        assert fs.soil_column_full_step.launches == before + 1
        plain = fs.soil_column_full_step_plain(sim.model, sim.timestepper, sim.ctx, (), state,
                                               900.0)
        torch.cuda.synchronize()
        _assert_full_close(out, plain, 1e-12, 900.0)
        state = plain


@pytest.mark.cuda
@pytest.mark.parametrize("physics,solver,picard", FULL_IMPLICIT)
def test_full_step_implicit_kernel_matches_plain_f32(cuda, physics, solver, picard):
    """The same at float32 on 2,000 columns: every leaf within 1e-4 of its
    scale."""
    sim = _full_implicit_sim(2000, torch.float32, cuda, physics, solver, picard)
    out = fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources,
                             dt=900.0)(sim.state)
    plain = fs.soil_column_full_step_plain(sim.model, sim.timestepper, sim.ctx, (), sim.state,
                                           900.0)
    torch.cuda.synchronize()
    _assert_full_close(out, plain, 1e-4, 900.0)


#: the land's full steps: (stepper, solver, Picard iterations, dt, snowpack,
#: vegetated)
LAND_FULL = {"euler": ("euler", None, 1, 60.0, False, True),
             "heun": ("heun", None, 1, 60.0, False, True),
             "implicit-pcr": ("implicit", "pcr", 1, 600.0, False, True),
             "implicit-thomas-2": ("implicit", "thomas", 2, 600.0, False, True),
             "implicit-pcr-2-snow": ("implicit", "pcr", 2, 600.0, True, True),
             "heun-snow": ("heun", None, 1, 60.0, True, True),
             "bare-euler": ("euler", None, 1, 300.0, False, False)}


def _land_full_sim(cells, dtype, device, case):
    """``_land_sim``'s compositions with static inputs and the case's
    stepper (the bare-ground one at Nz 15)."""
    stepper, solver, picard, dt, snow, vegetated = LAND_FULL[case]
    ts = {"euler": tp.ForwardEuler(dt=dt), "heun": tp.Heun(dt=dt),
          "implicit": tp.ImplicitEuler(dt=dt, solver=solver or "pcr", picard_iters=picard)}
    return _land_sim(cells, dtype, device, vegetated=vegetated, nz=20 if vegetated else 15,
                     snow=snow, stepper=ts[stepper], static=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", LAND_FULL)
def test_land_full_step_kernel_matches_plain_f64(cuda, case):
    """float64 on 256 columns at Nz 20 (the bare-ground case at Nz 15, and
    the snowpack under Heun, built at their first launch): one kernel step
    and one plain step from each state of 3 steps of the plain trajectory,
    every leaf at 1e-12, one launch a call."""
    from terrarium_tpu_torch.ops import land_step as ls

    dt = LAND_FULL[case][3]
    sim = _land_full_sim(256, torch.float64, cuda, case)
    fused = fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources, dt=dt)
    state = sim.state
    for _ in range(3):
        before = ls.land_column_full_step.launches
        out = fused(state)
        assert ls.land_column_full_step.launches == before + 1
        plain = ls.land_column_full_step_plain(sim.model, sim.timestepper, sim.ctx,
                                               sim.input_sources, state, dt)
        torch.cuda.synchronize()
        _assert_full_close(out, plain, 1e-12, dt)
        state = plain


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["euler", "heun", "implicit-pcr", "implicit-pcr-2-snow"])
def test_land_full_step_kernel_matches_plain_f32(cuda, case):
    """float32 on 4,096 columns at Nz 20: every leaf within 1e-4 of its
    scale."""
    from terrarium_tpu_torch.ops import land_step as ls

    dt = LAND_FULL[case][3]
    sim = _land_full_sim(4096, torch.float32, cuda, case)
    out = fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources,
                             dt=dt)(sim.state)
    plain = ls.land_column_full_step_plain(sim.model, sim.timestepper, sim.ctx,
                                           sim.input_sources, sim.state, dt)
    torch.cuda.synchronize()
    _assert_full_close(out, plain, 1e-4, dt)


@pytest.mark.cuda
def test_run_with_forcings_runs_through_the_modules_on_the_card(cuda):
    """A forcing takes ``run`` through the process modules, on the card."""
    _runs_through_the_modules(lambda device: _full_sim(
        96, 20, torch.float64, device,
        forcings={"internal_energy": lambda state, grid: 2.0}), 6)


#: the land segment VJP's schemes: (stepper, solver, dt)
LAND_VJP_SCHEMES = {"euler": ("euler", None, 60.0), "implicit-pcr": ("implicit", "pcr", 600.0),
                    "implicit-thomas": ("implicit", "thomas", 600.0),
                    "implicit-pcr-picard2": ("implicit", "pcr", 600.0),
                    "implicit-thomas-picard3": ("implicit", "thomas", 600.0),
                    "heun": ("heun", None, 60.0),
                    "implicit-pcr-snow": ("implicit", "pcr", 600.0)}
#: the Picard count of a scheme (1 where not given)
LAND_VJP_PICARD = {"implicit-pcr-picard2": 2, "implicit-thomas-picard3": 3}
#: the schemes with a snowpack (``_land_sim``'s snowfall and initial pack);
#: "heun-snow" is built at its first launch (no prebuilt instantiation)
LAND_VJP_SNOW = ("implicit-pcr-snow", "heun-snow")


def _land_grad_sim(cells, dtype, device, scheme):
    """``_land_sim``'s vegetated composition with its forcing's daily means
    as static per-column inputs (the fused gradient takes static inputs):
    shortwave 900 cos(lat) / pi, air temperature 28 max(cos lat, 0.05) - 8;
    the scheme's stepper; under LAND_VJP_SNOW its snowpack, snowfall and
    initial pack."""
    key, solver, dt = LAND_VJP_SCHEMES["heun" if scheme == "heun-snow" else scheme]
    stepper = (tp.ImplicitEuler(dt=dt, solver=solver,
                                picard_iters=LAND_VJP_PICARD.get(scheme, 1))
               if key == "implicit" else tp.Heun(dt=dt) if key == "heun"
               else tp.ForwardEuler(dt=dt))
    snow = scheme in LAND_VJP_SNOW
    base = _land_sim(cells, dtype, device, stepper=stepper, snow=snow)
    lat = np.linspace(-60.0, 80.0, cells)
    coslat = np.maximum(np.cos(np.deg2rad(lat)), 0.05)
    fields = {"surface_longwave_down": 330.0, "rainfall": 4.0e-8, "windspeed": 3.0,
              "surface_shortwave_down": 900.0 * coslat / np.pi,
              "air_temperature": 28.0 * coslat - 8.0}
    inits = {"temperature": lambda x, z: (28.0 * coslat - 8.0)[None, :] + 0.0 * z,
             "saturation_water_ice": 0.6, "carbon_vegetation": 2.0,
             "vegetation_area_fraction": 0.5}
    if snow:
        fields["snowfall"] = 2.0e-8
        inits["snow_water_equivalent"] = 0.02
    return tp.initialize(base.model, stepper, (tp.FieldInputSource(fields=fields),),
                         initializers=inits)


def _land_vjp_operands(sim, device, seed):
    """A land gradient simulation's VJP operands: the carry, static inputs,
    root fraction, coordinates, parameters and seeded output cotangents."""
    from terrarium_tpu_torch.ops import land_step as ls
    from terrarium_tpu_torch.timesteppers.integrator import land_inputs

    model, st = sim.model, sim.state
    params = ls.LandParams.of(model, model.grid.dtype)
    carry = {n: st[n].contiguous() for n in ls.carry_names(params)}
    coords = tuple(getattr(model.grid, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    rng = np.random.default_rng(seed)
    gout = {n: torch.as_tensor(rng.normal(size=tuple(carry[n].shape)), device=device).to(
        model.grid.dtype) for n in model.live_carry}
    return (carry, land_inputs(model, st, sim.input_sources), st.auxiliary["root_fraction"],
            coords, params, gout)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", LAND_VJP_SCHEMES)
def test_land_segment_vjp_kernel_matches_plain(cuda, scheme):
    """The land segment-VJP kernel of the scheme (``land_vjp.vjp_source``:
    ImplicitEuler and Heun without a snowpack
    csrc/land_column_group_segment_vjp.cu, the others
    csrc/land_column_segment_vjp.cu) at
    float64 on 256 columns over 12 steps from seeded output cotangents:
    every cotangent within 1e-9 of the plain version's autograd (with a
    floor of 1e-9 of its largest magnitude), the parameter cotangents within
    1e-9; one launch. The Picard schemes' Thomas entry with three
    iterations is the prebuilt Picard entry, whose count and solver are
    taken at run time; Heun and the snowpack (ImplicitEuler PCR) are the
    prebuilt entries of this slice's chip_smoke.py phases."""
    from terrarium_tpu_torch.ops import land_vjp as lv

    key, solver, dt = LAND_VJP_SCHEMES[scheme]
    sim = _land_grad_sim(256, torch.float64, cuda, scheme)
    carry, inputs, root, coords, params, gout = _land_vjp_operands(sim, cuda, 3)
    before = lv.land_column_segment_vjp.launches
    kw = {"stepper": key, "solver": solver, "picard_iters": LAND_VJP_PICARD.get(scheme, 1)}
    got, gK, gskm = lv.land_column_segment_vjp(carry, inputs, root, *coords, params, dt, 0.0,
                                               12, gout, **kw)
    assert lv.land_column_segment_vjp.launches == before + 1
    ref, rK, rskm = lv.land_column_segment_vjp_plain(carry, inputs, root, *coords, params, dt,
                                                     0.0, 12, gout, **kw)
    for n in carry:
        a, b = got[n], ref[n]
        assert bool(torch.isfinite(a).all()), n
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9 * float(b.abs().max()), msg=n)
    for a, b in ((gK, rK), (gskm, rskm)):
        assert float(b) != 0.0
        torch.testing.assert_close(a, b, rtol=1e-9, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", LAND_VJP_SCHEMES)
def test_land_fused_grad_runs_the_land_kernels(cuda, scheme):
    """``make_fused_grad_rollout`` over the LandModel at float64 on 256
    columns, 8 steps in segments of 4: two launches of the land forward
    kernel and two of the segment-VJP kernel, and the gradient in (log
    K_sat, k_mineral) within 1e-8 of ``make_rollout_fn``'s autograd through
    the process modules."""
    _fused_grad_runs_the_land_kernels(cuda, scheme)


@pytest.mark.cuda
def test_land_fused_grad_builds_heun_with_a_snowpack_at_first_launch(cuda):
    """Heun with a snowpack, which no prebuilt instantiation covers (the
    land VJP's nor the land rollout's), through ``make_fused_grad_rollout``
    as ``test_land_fused_grad_runs_the_land_kernels``: both kernels built
    at their first launch, and the gradient held to the modules'
    autograd."""
    from terrarium_tpu_torch.ops import cuda_build
    from terrarium_tpu_torch.ops import land_step as ls

    sim = _land_grad_sim(8, torch.float64, cuda, "heun-snow")
    tags = ls.land_composition(sim.model)
    assert tags[-1] == "snow"
    assert (("heun",) + tags, torch.float64, 20) not in (
        cuda_build.INSTANTIATIONS["land_column_segment_vjp"]
        + cuda_build.INSTANTIATIONS["land_column_rollout"])
    _fused_grad_runs_the_land_kernels(cuda, "heun-snow")


def _fused_grad_runs_the_land_kernels(cuda, scheme):
    from terrarium_tpu_torch.ops import land_step as ls
    from terrarium_tpu_torch.ops import land_vjp as lv
    from terrarium_tpu_torch.timesteppers.autodiff import make_rollout_fn

    key, _, dt = LAND_VJP_SCHEMES["heun" if scheme == "heun-snow" else scheme]
    sim = _land_grad_sim(256, torch.float64, cuda, scheme)
    base = sim.model

    def model_fn(p):
        return dataclasses.replace(base, soil=with_differentiable_params(
            base.soil, log_sat_hydraulic_cond=p[0], mineral_conductivity=p[1]))

    def grads(fused):
        p = tuple(torch.tensor(v, dtype=torch.float64, device=cuda, requires_grad=True)
                  for v in (np.log(1e-5), 2.0))
        if fused:
            out = make_fused_grad_rollout(model_fn, sim.timestepper, sim.ctx, sim.input_sources,
                                          steps=8, dt=dt, inner_steps=4)(sim.state, p)
        else:
            out = make_rollout_fn(model_fn(p), sim.timestepper, sim.ctx, sim.input_sources,
                                  steps=8, remat=True)(sim.state, dt)
        loss = out.temperature.mean() + out.prognostic["carbon_vegetation"].mean()
        return [float(g) for g in torch.autograd.grad(loss, p)]

    fwd = ls.ROLLOUTS[key]
    before = (fwd.launches, lv.land_column_segment_vjp.launches)
    got = grads(True)
    assert (fwd.launches - before[0], lv.land_column_segment_vjp.launches - before[1]) == (2, 2)
    ref = grads(False)
    np.testing.assert_allclose(got, ref, rtol=1e-8)
    assert all(g != 0.0 for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["heun", "implicit-pcr-snow"])
def test_land_segment_vjp_f32_kernel_matches_plain(cuda, scheme):
    """The float32 land segment-VJP entries of Heun and of the snowpack
    (ImplicitEuler PCR) on 1,024 columns over 12 steps: each cotangent and
    parameter cotangent of the kernel within twice the float32 plain
    version's own error plus 1e-3 of the field's largest magnitude (the
    parameters': of their value) of the float64 plain version on the same
    float32 operands; one launch."""
    from terrarium_tpu_torch.ops import land_step as ls
    from terrarium_tpu_torch.ops import land_vjp as lv

    key, solver, dt = LAND_VJP_SCHEMES[scheme]
    sim = _land_grad_sim(1024, torch.float32, cuda, scheme)
    carry, inputs, root, coords, params, gout = _land_vjp_operands(sim, cuda, 5)
    kw = {"stepper": key, "solver": solver}
    before = lv.land_column_segment_vjp.launches
    got = lv.land_column_segment_vjp(carry, inputs, root, *coords, params, dt, 0.0, 12, gout,
                                     **kw)
    assert lv.land_column_segment_vjp.launches == before + 1
    plain = lv.land_column_segment_vjp_plain(carry, inputs, root, *coords, params, dt, 0.0, 12,
                                             gout, **kw)
    f64 = torch.float64

    def wide(t):
        return t.to(f64)

    truth = lv.land_column_segment_vjp_plain(
        {n: wide(t) for n, t in carry.items()},
        {n: ls.LandInput(wide(i.values), i.t0, i.dts) for n, i in inputs.items()}, wide(root),
        *(wide(c) for c in coords), ls.LandParams.of(params.model, f64), dt, 0.0, 12,
        {n: wide(t) for n, t in gout.items()}, **kw)
    for n in carry:
        a, b, ref = wide(got[0][n]), wide(plain[0][n]), truth[0][n]
        assert bool(torch.isfinite(a).all()), n
        bound = 2.0 * (b - ref).abs() + 1e-3 * float(ref.abs().max())
        assert bool(((a - ref).abs() <= bound).all()), n
    for a, b, ref in zip(got[1:], plain[1:], truth[1:]):
        assert float(ref) != 0.0
        assert abs(float(a) - float(ref)) <= 2.0 * abs(float(b) - float(ref)) \
            + 1e-3 * abs(float(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["soil_heat_column", "bare_vg_mualem_land"])
def test_run_builds_unlisted_compositions_at_first_launch(cuda, case):
    """Compositions that the port's type checks send to a kernel but whose
    size is not prebuilt (``cuda_build.INSTANTIATIONS``) run on the card
    all the same, their instantiation compiled at its first launch:
    `examples/soil_heat_column.py`'s heat-only column (BASELINE #1: Nz 10,
    float32, ForwardEuler at dt 300 s, 144 steps) and a bare-ground Van
    Genuchten/Mualem land column (Nz 20, float32, 64 columns, ImplicitEuler
    PCR at dt 600 s, 48 steps; the composition of
    ``test_land_steppers.py::test_implicit_land_model_reproduced``). Each
    ``run`` is one launch of its wrapper and holds every prognostic within
    1e-4 of its magnitude of the plain version's ``advance(plain=True)``
    followed by ``compute_auxiliary``, as ``run`` ends."""
    from terrarium_tpu_torch.ops import cuda_build
    from terrarium_tpu_torch.ops import land_step as ls
    from terrarium_tpu_torch.timesteppers.integrator import advance

    def make():
        if case == "soil_heat_column":
            grid = tp.ColumnGrid.of(cells=1, spacing=tp.ExponentialSpacing(N=10),
                                    dtype=torch.float32, device=cuda)
            model = tp.SoilModel(grid=grid, initializer=tp.SoilInitializer(
                energy=tp.QuasiThermalSteadyState(T0=-1.0),
                hydrology=tp.ConstantSaturation(sat=1.0)))
            return tp.initialize(model, tp.ForwardEuler(),
                                 boundary_conditions=tp.PrescribedSurfaceTemperature(1.0))
        grid = tp.ColumnGrid.of(cells=64, spacing=tp.ExponentialSpacing(N=20),
                                dtype=torch.float32, device=cuda)
        props = tp.ConstantSoilHydraulics(swrc=tp.VanGenuchten(alpha=2.0, n=2.0),
                                          unsat_hydraulic_cond=tp.UnsatKVanGenuchten(),
                                          sat_hydraulic_cond=1e-6)
        soil = tp.SoilEnergyWaterCarbon(
            strat=tp.HomogeneousStratigraphy(texture=tp.SoilTexture.preset("loam")),
            hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq(), hydraulic_properties=props))
        model = tp.LandModel(grid=grid, soil=soil,
                             surface_energy_balance=tp.SurfaceEnergyBalance.consistent(),
                             surface_hydrology=tp.SurfaceHydrology(
                                 canopy_interception=tp.NoCanopyInterception(),
                                 evapotranspiration=tp.BareGroundEvaporation.consistent_units()))
        return tp.initialize(model, tp.ImplicitEuler(dt=600.0),
                             initializers={"temperature": 8.0, "saturation_water_ice": 0.7},
                             input_sources=(tp.FieldInputSource(fields={
                                 "surface_shortwave_down": 400.0, "air_temperature": 12.0,
                                 "rainfall": 5.0e-8, "windspeed": 1.0}),))

    sim, ref = make(), make()
    steps = 144 if case == "soil_heat_column" else 48
    wrapper = fs.soil_column_heat_rollout if case == "soil_heat_column" \
        else ls.land_column_implicit_rollout
    nz = sim.model.grid.nz
    tags = (("euler", "heat") if case == "soil_heat_column"
            else ("implicit", "pcr") + ls.land_composition(sim.model))
    source = "soil_column_rollout" if case == "soil_heat_column" else "land_column_rollout"
    assert (tags, torch.float32, nz) not in cuda_build.INSTANTIATIONS[source]
    before = wrapper.launches
    sim.run(steps=steps)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    advance(ref.model, ref.state, ref.ctx, steps, ref.timestepper.default_dt(),
            timestepper=ref.timestepper, input_sources=ref.input_sources, plain=True)
    ref.compute_auxiliary()  # as run ends: the SEB writes the skin temperature afresh
    for name in sim.model.live_carry:
        a, b = sim.state[name].double(), ref.state[name].double()
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-4 * float(b.abs().max()), msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_probe_kernels_match_plain(cuda, dtype):
    """The probe kernels (``csrc/probes.cu``) against their plain versions
    at small shapes: float64 (built with -fmad=false) within 1e-12; float32
    within 1e-5 relative for row 4's chains (one FMA against a multiply and
    an add, at most an ulp a step, over the 64-step chains) and 1e-6 of
    each output's magnitude for rows 5 and 6 (their products are not
    contracted; the exponentials may differ by an ulp)."""
    from terrarium_tpu_torch.experiments import mosaic_bisect as mb
    from terrarium_tpu_torch.experiments import mosaic_min_repro as mr
    from terrarium_tpu_torch.experiments import roofline_census as rc

    f64 = dtype == torch.float64
    gen = torch.Generator(device="cpu").manual_seed(8)
    x = (0.5 + torch.rand(64, 1000, generator=gen, dtype=torch.float64)).to(cuda, dtype)
    for kind, (_, (r1, _)) in rc.KINDS.items():
        got, want = rc.micro_chain(x, kind, r1), rc.micro_chain_plain(x, kind, r1)
        torch.testing.assert_close(got, want, rtol=1e-12 if f64 else 1e-5, atol=0.0, msg=kind)
    xb, dz = mb.inputs(dtype, cuda)
    xb = xb[:, :3000].contiguous()
    for case in mb.CASES:
        got, want = mb.bisect_case(case, xb, dz), mb.bisect_case_plain(case, xb, dz)
        tol = (1e-12 if f64 else 1e-6) * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0.0, atol=tol, msg=case)
    T = (torch.rand(mr.NZ, 300, generator=gen, dtype=torch.float64) * 5 - 2).to(cuda, dtype)
    s = torch.rand(300, generator=gen, dtype=torch.float64).to(cuda, dtype)
    for variant in mr.VARIANTS:
        for got, want in zip(mr.repro_variant(variant, T, s),
                             mr.repro_variant_plain(variant, T, s)):
            tol = (1e-12 if f64 else 1e-6) * float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=0.0, atol=tol, msg=variant)


@pytest.mark.cuda
def test_probe_launch_counts_count_graph_replays(cuda):
    """``run_case`` and ``run_variant`` count the launches the card ran: the
    check, the CUDA graph's warm-up and each of its 5 replays of ``reps``
    calls (the capture launches nothing), and ``reps + 1`` calls timed
    alone."""
    from terrarium_tpu_torch.experiments import mosaic_bisect as mb
    from terrarium_tpu_torch.experiments import mosaic_min_repro as mr

    reps = 3
    for fn, run, arg in ((mb.bisect_case, mb.run_case, "cummin"),
                         (mr.repro_variant, mr.run_variant, "row_to_xy_stencil")):
        before = fn.launches
        run(arg, reps=reps)
        assert fn.launches - before == 1 + (1 + 5 * reps) + (1 + reps)


@pytest.mark.cuda
def test_run_fused_stages_windows_on_a_side_stream(cuda):
    """``ChunkedForcingPipeline.run_fused`` over a float64 heat-only soil on
    the card: one launch a chunk, each window copied on the stager's side
    stream and waited for by an event; the result within 1e-12 of
    ``Simulation.run`` on the whole series on the card, and ``run`` within
    1e-12 of both."""
    hours = 200 * 86400.0 + np.arange(0.0, 30 * 3600.0, 3600.0)
    cells = 500
    vals = 2.0 + np.sin(2 * np.pi * hours[:, None] / 86400.0) * np.linspace(1, 3, cells)

    def make(src):
        grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=16),
                                dtype=torch.float64, device=cuda)
        sim = tp.initialize(tp.SoilModel(grid=grid), tp.ForwardEuler(dt=300.0),
                            initializers={"temperature": 1.0, "saturation_water_ice": 0.5},
                            boundary_conditions=tp.PrescribedSurfaceTemperature(
                                "surface_temperature"),
                            input_sources=(src,))
        sim.state.clock = tp.Clock(torch.tensor(hours[1], dtype=torch.float64, device=cuda),
                                   sim.state.clock.iteration)
        sim.fused_inner_steps = 12
        return sim

    whole = make(tp.TimeSeriesInputSource(times=hours, series={"surface_temperature": vals}))
    whole.run(steps=240)
    results = {}
    for route in ("run_fused", "run"):
        pipe = tp.ChunkedForcingPipeline(hours, {"surface_temperature": vals}, window=8)
        sim = make(pipe)
        before = fs.soil_column_heat_rollout.launches
        getattr(pipe, route)(sim, steps=240, dt=300.0)
        torch.cuda.synchronize()
        assert fs.soil_column_heat_rollout.launches - before == len(pipe.chunks) > 2
        for chunk in pipe.chunks:
            assert chunk.copy_end.query()
            assert chunk.copy_start.elapsed_time(chunk.copy_end) >= 0.0
        results[route] = sim.state.internal_energy
        torch.testing.assert_close(sim.state.internal_energy, whole.state.internal_energy,
                                   rtol=1e-12, atol=0.0, msg=route)
    torch.testing.assert_close(results["run"], results["run_fused"], rtol=1e-12, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["run_fused", "run"])
def test_streamed_run_holds_two_windows_on_the_card(cuda, route):
    """A streamed run holds two windows on the card whatever its length:
    the peak memory of 60 windows above the run's start is that of 4
    windows (within a quarter of a window), and 4 windows' is
    ``Simulation.run``'s on the whole series plus two windows (within a
    quarter of a window)."""
    cells, window = 4096, 8
    hours = 200 * 86400.0 + np.arange(0.0, 400 * 3600.0, 3600.0)
    vals = 2.0 + np.sin(2 * np.pi * hours[:, None] / 86400.0) * np.linspace(1, 3, cells)
    window_bytes = window * cells * 8

    def make(src):
        grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=16),
                                dtype=torch.float64, device=cuda)
        sim = tp.initialize(tp.SoilModel(grid=grid), tp.ForwardEuler(dt=600.0),
                            initializers={"temperature": 1.0, "saturation_water_ice": 0.5},
                            boundary_conditions=tp.PrescribedSurfaceTemperature(
                                "surface_temperature"),
                            input_sources=(src,))
        sim.state.clock = tp.Clock(torch.tensor(hours[0], dtype=torch.float64, device=cuda),
                                   sim.state.clock.iteration)
        sim.fused_inner_steps = 6
        return sim

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - start

    # run_fused: chunks of 36 steps at dt 600 (6 hours), 4 and 60 windows
    short, long = 4 * 36, 60 * 36
    whole = make(tp.TimeSeriesInputSource(times=torch.as_tensor(hours, device=cuda),
                                          series={"surface_temperature": torch.as_tensor(
                                              vals, device=cuda)}))
    whole_peak = peak(lambda: whole.run(steps=short, dt=600.0))
    peaks = {}
    for steps in (short, long):
        pipe = tp.ChunkedForcingPipeline(hours, {"surface_temperature": vals}, window=window)
        sim = make(pipe)
        peaks[steps] = peak(lambda: getattr(pipe, route)(sim, steps=steps, dt=600.0))
        assert len(pipe.chunks) >= steps // 42  # run: chunks of at most 7 hours
    assert peaks[long] <= peaks[short] + window_bytes / 4, (peaks, window_bytes)
    assert peaks[short] <= whole_peak + 2.25 * window_bytes, (peaks, whole_peak, window_bytes)
