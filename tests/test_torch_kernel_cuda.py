"""The soil column CUDA kernels (the rollout and its segment VJP) against
their plain PyTorch versions, on a CUDA device. Every test skips where
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
DT = 60.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sim(cells, nz, dtype, device, dt=DT, golden=False):
    props = tp.ConstantSoilHydraulics(swrc=tp.VanGenuchten(alpha=2.0, n=2.0),
                                      unsat_hydraulic_cond=tp.UnsatKVanGenuchten())
    soil = tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(hydraulic_properties=props))
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


def _operands(sim, steps):
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    carry = tuple(sim.state.prognostic[n] for n in sim.model.live_carry)
    table = top_temperature_table(sim.bcs["temperature"]["top"].value,
                                  clock_times(sim.state.clock.time, DT, steps)[:-1], g)
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
    sim = _sim(64, 15, torch.float32, cuda)
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
# segment VJP: the gradient configuration of tests/test_torch_grad.py
# ---------------------------------------------------------------------------
GRAD_DT, LOG_KSAT = 300.0, float(np.log(1e-5))


def _grad_model(grid, log_ksat=LOG_KSAT):
    props = tp.ConstantSoilHydraulics(swrc=tp.VanGenuchten(alpha=2.0, n=2.0),
                                      unsat_hydraulic_cond=tp.UnsatKVanGenuchten())
    soil = tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(hydraulic_properties=props))
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
