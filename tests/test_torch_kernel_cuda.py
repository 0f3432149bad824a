"""The soil column CUDA kernels (the ForwardEuler, Heun, heat-only and
ImplicitEuler rollouts and the segment VJP) and the LandModel column kernel
against their plain PyTorch versions, on a CUDA device. Every test skips where
``torch.cuda.is_available()`` is False.

This file imports no JAX, so it also runs on a machine with a card and no
JAX (the repository's conftest imports JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py
"""
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


def _sim(cells, nz, dtype, device, dt=DT, golden=False):
    props = tp.ConstantSoilHydraulics(swrc=tp.VanGenuchten(alpha=2.0, n=2.0),
                                      unsat_hydraulic_cond=tp.UnsatKVanGenuchten())
    soil = tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq(),
                                                               hydraulic_properties=props))
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
    sim = _sim(64, 12, torch.float32, cuda)
    carry, table, coords, params = _operands(sim, 2)
    with pytest.raises(ValueError, match="Nz"):
        fs.soil_column_rollout(*carry, table, *coords, params, DT)


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


@pytest.mark.cuda
def test_default_model_runs_through_the_heat_kernel(cuda):
    """``SoilModel(grid=g)`` is the heat-only model; ForwardEuler runs it
    through the heat kernel, Heun has no heat-only kernel and raises."""
    grid = tp.ColumnGrid.of(cells=70, spacing=tp.ExponentialSpacing(N=30),
                            dtype=torch.float32, device=cuda)
    for ts in (tp.ForwardEuler(dt=300.0), tp.Heun(dt=300.0)):
        sim = tp.initialize(tp.SoilModel(grid=grid), ts,
                            initializers={"temperature": 1.0, "saturation_water_ice": 0.8},
                            boundary_conditions=tp.PrescribedSurfaceTemperature(-3.0))
        if isinstance(ts, tp.Heun):
            with pytest.raises(ValueError, match="kernel"):
                sim.run(steps=4)
            continue
        before = fs.soil_column_heat_rollout.launches
        sim.run(steps=48)
        assert fs.soil_column_heat_rollout.launches == before + 1
        assert bool(torch.isfinite(sim.state.temperature).all())
        assert float(sim.state.temperature[-1].max()) < 1.0


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
    grid = tp.ColumnGrid.of(cells=70, spacing=tp.ExponentialSpacing(N=30),
                            dtype=torch.float32, device=cuda)
    sim = tp.initialize(tp.SoilModel(grid=grid), tp.ImplicitEuler(),
                        initializers={"temperature": 1.0, "saturation_water_ice": 0.8},
                        boundary_conditions=tp.PrescribedSurfaceTemperature(-3.0))
    with pytest.raises(ValueError, match="kernel"):
        sim.run(steps=4)


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


# ---------------------------------------------------------------------------
# the LandModel column kernel
# ---------------------------------------------------------------------------
LAND_GOLDEN = GOLDEN.parent / "land_model.npz"


def _land_sim(cells, dtype, device, vegetated=True, nz=20):
    """The vegetated composition of `examples/land_global.py` with
    ``DirectSurfaceRunoff.consistent()`` over loam Richards flow (Brooks-
    Corey, linear conductivity), or the default bare-ground model (heat only,
    Nz 15, the golden's); hourly series of shortwave and air temperature
    over latitudes from -60 to 80 degrees."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=dtype,
                            device=device)
    if not vegetated:
        return tp.initialize(
            tp.LandModel(grid=grid), tp.ForwardEuler(),
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
    return tp.initialize(
        model, tp.ForwardEuler(dt=600.0),
        (tp.TimeSeriesInputSource(times=hours, series={"surface_shortwave_down": sw,
                                                       "air_temperature": ta}),
         tp.FieldInputSource(fields={"surface_longwave_down": 330.0, "rainfall": 4.0e-8,
                                     "windspeed": 3.0})),
        initializers={"temperature": lambda x, z: (28.0 * coslat - 8.0)[None, :] + 0.0 * z,
                      "saturation_water_ice": 0.6, "carbon_vegetation": 2.0,
                      "vegetation_area_fraction": 0.5})


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
    from terrarium_tpu_torch.timesteppers.integrator import land_inputs

    sim = _land_sim(300, dtype, cuda)
    model, st = sim.model, sim.state
    params = ls.LandParams.of(model, dtype)
    carry = {n: st[n].contiguous() for n in ls.carry_names(params)}
    coords = tuple(getattr(model.grid, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    inputs = land_inputs(model, st, sim.input_sources)
    root = st.auxiliary["root_fraction"]
    before = ls.land_column_rollout.launches
    whole = ls.land_column_rollout(carry, inputs, root, *coords, params, 600.0, 0.0, 48)
    assert ls.land_column_rollout.launches == before + 1
    cp, chain = dict(carry), dict(carry)
    t = (np.float32 if dtype == torch.float32 else np.float64)(0.0)
    for _ in range(48):
        k1 = ls.land_column_rollout(cp, inputs, root, *coords, params, 600.0, float(t), 1)
        p1 = ls.land_column_rollout_plain(cp, inputs, root, *coords, params, 600.0, float(t), 1)
        chain = {**chain, **ls.land_column_rollout(chain, inputs, root, *coords, params, 600.0,
                                                   float(t), 1)}
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
        t = t + t.dtype.type(600.0)
    torch.cuda.synchronize()
    for name in model.live_carry:
        assert torch.equal(whole[name], chain[name]), name
