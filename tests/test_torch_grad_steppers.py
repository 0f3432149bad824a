"""The fused gradient of every scheme the segment VJP takes, against JAX, at
float64 on the CPU.

The configuration is `tests/test_fused_grad.py`'s: 48 columns, Nz 10, top
temperature 4 degC, initial T = -1 degC and sat = min(1, 0.6 - 0.04 z),
which leaves the bottom layers exactly saturated, 8 steps in segments of 4,
loss mean(T) + mean(sat) after the trailing closure. The schemes: Heun at dt
300 s and ImplicitEuler at dt 1800 s with each solver over heat + Richards
(gradients in log K_sat, k_mineral, U0 and sat0), and ForwardEuler at dt
300 s over the heat-only default model (in k_mineral, U0 and the
saturation it reads). The same numbers go through the port's
`make_fused_grad_rollout` (the plain versions of the kernels on the CPU),
JAX's `make_fused_grad_rollout(bwd="pallas", interpret=True)` (its Pallas
segment VJP) and JAX's `make_rollout_fn(remat=True, lean=True)`.

At an exactly saturated layer the port's derivative of the saturation
sweeps follows its own tie convention (ROADMAP Queue C), so d/d sat0 is
compared with JAX at the unsaturated cells and held to the conservation of
water at all of them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.timesteppers.autodiff import make_rollout_fn as jax_rollout_fn
from terrarium_tpu.timesteppers.fused_grad import make_fused_grad_rollout as jax_fused_grad
from terrarium_tpu_torch.convert import with_differentiable_params
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.ops import fused_vjp as fv
from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout

from torch_parity import port_soil

CELLS, NZ, STEPS, INNER = 48, 10, 8, 4
X0, K0 = float(np.log(1e-5)), 3.8
INITS = {"temperature": -1.0,
         "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.6 - 0.04 * z)}
#: case -> (stepper, dt, solver, physics)
CASES = {"heun": ("heun", 300.0, "pcr", "richards"),
         "implicit-pcr": ("implicit", 1800.0, "pcr", "richards"),
         "implicit-thomas": ("implicit", 1800.0, "thomas", "richards"),
         "heat": ("euler", 300.0, "pcr", "heat")}


def _jax_stepper(case):
    stepper, dt, solver, _ = CASES[case]
    if stepper == "heun":
        return tt.Heun(dt=dt)
    if stepper == "implicit":
        return tt.ImplicitEuler(dt=dt, solver=solver)
    return tt.ForwardEuler(dt=dt)


def _port_stepper(case, **kw):
    stepper, dt, solver, _ = CASES[case]
    if stepper == "heun":
        return tp.Heun(dt=dt)
    if stepper == "implicit":
        return tp.ImplicitEuler(dt=dt, solver=solver, **kw)
    return tp.ForwardEuler(dt=dt)


def _jax_model(grid, physics, log_ksat, k_mineral):
    thermal = tt.SoilThermalProperties(
        conductivities=tt.SoilThermalConductivities(mineral=k_mineral))
    if physics == "heat":
        return tt.SoilModel(grid=grid, soil=tt.SoilEnergyWaterCarbon(
            energy=tt.SoilEnergyBalance(thermal_properties=thermal)))
    props = tt.ConstantSoilHydraulics(sat_hydraulic_cond=jnp.exp(log_ksat),
                                      swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
                                      unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
    soil = tt.SoilEnergyWaterCarbon(
        energy=tt.SoilEnergyBalance(thermal_properties=thermal),
        hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq(), hydraulic_properties=props))
    return tt.SoilModel(grid=grid, soil=soil)


def _port_model(grid, physics, log_ksat, k_mineral):
    if physics == "heat":
        soil = with_differentiable_params(tp.SoilEnergyWaterCarbon(),
                                          mineral_conductivity=k_mineral)
    else:
        soil = with_differentiable_params(port_soil(), log_sat_hydraulic_cond=log_ksat,
                                          mineral_conductivity=k_mineral)
    return tp.SoilModel(grid=grid, soil=soil)


def _port_sim(case, **kw):
    physics = CASES[case][3]
    grid = tp.ColumnGrid.of(cells=CELLS, spacing=tp.ExponentialSpacing(N=NZ),
                            dtype=torch.float64, device="cpu")
    return tp.initialize(_port_model(grid, physics, X0, K0), _port_stepper(case, **kw),
                         initializers=INITS,
                         boundary_conditions=tp.PrescribedSurfaceTemperature(4.0))


def _port_grads(case):
    """Loss and its gradients in (log K_sat, k_mineral, U0, sat0) through
    the port's fused gradient rollout; log K_sat's is 0 for heat only."""
    _, dt, _, physics = CASES[case]
    sim = _port_sim(case)
    grid = sim.model.grid
    x = torch.tensor(X0, dtype=torch.float64, requires_grad=True)
    k = torch.tensor(K0, dtype=torch.float64, requires_grad=True)
    state = sim.state.copy()
    U0 = state.prognostic["internal_energy"].clone().requires_grad_()
    sat0 = state["saturation_water_ice"].clone().requires_grad_()
    state.set(internal_energy=U0, saturation_water_ice=sat0)
    roll = make_fused_grad_rollout(lambda p: _port_model(grid, physics, *p), sim.timestepper,
                                   sim.ctx, steps=STEPS, dt=dt, inner_steps=INNER)
    out = roll(state, (x, k))
    loss = out.temperature.mean() + out.saturation_water_ice.mean()
    gs = torch.autograd.grad(loss, (x, k, U0, sat0), allow_unused=True)
    gs = [torch.zeros(()) if g is None else g for g in gs]
    return (float(loss.detach()), *(g.numpy() for g in gs))


@pytest.fixture(scope="module")
def jax_ref():
    """``jax.value_and_grad`` in (log K_sat, k_mineral, U0, sat0) of JAX's
    Pallas-VJP fused rollout and of its remat rollout, per case, computed
    when a test first asks."""
    cache = {}

    def ref(case, route):
        if (case, route) in cache:
            return cache[case, route]
        _, dt, _, physics = CASES[case]
        grid = tt.ColumnGrid.of(cells=CELLS, spacing=tt.ExponentialSpacing(N=NZ),
                                nf=np.float64)
        ts = _jax_stepper(case)
        sim = tt.initialize(_jax_model(grid, physics, X0, K0), ts, initializers=INITS,
                            boundary_conditions=tt.PrescribedSurfaceTemperature(4.0))

        def loss(x, k, u0, s0):
            st = sim.state.update(internal_energy=u0, saturation_water_ice=s0)
            if route == "pallas":
                roll = jax_fused_grad(lambda p: _jax_model(grid, physics, *p), ts, sim.ctx, (),
                                      steps=STEPS, dt=dt, inner_steps=INNER, block_cells=CELLS,
                                      interpret=True, bwd="pallas")
                out = roll(st, (x, k))
            else:
                roll = jax_rollout_fn(_jax_model(grid, physics, x, k), ts, sim.ctx, (),
                                      steps=STEPS, remat=True, lean=True)
                out = roll(st, dt)
            return jnp.mean(out.temperature) + jnp.mean(out.saturation_water_ice)

        s0 = sim.state.saturation_water_ice
        v, g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3)))(
            X0, K0, sim.state.prognostic["internal_energy"], s0)
        cache[case, route] = (float(v), *(np.asarray(a) for a in g), np.asarray(s0) < 1.0)
        return cache[case, route]

    return ref


@pytest.fixture(scope="module")
def port_ref():
    cache = {}

    def ref(case):
        if case not in cache:
            cache[case] = _port_grads(case)
        return cache[case]

    return ref


@pytest.mark.parametrize("route", ["pallas", "remat"])
@pytest.mark.parametrize("case", CASES)
def test_fused_grad_matches_jax(jax_ref, port_ref, case, route):
    """The value within rtol 1e-10 and d/d log K_sat, d/d k_mineral and
    d/dU0 within rtol 1e-8 of JAX's Pallas segment VJP (interpret mode) and
    of its remat rollout; d/dU0 with a floor of 1e-8 of its largest
    magnitude. Heat only: no d/d log K_sat (the kernels read no K_sat)."""
    v, gx, gk, gU, _ = port_ref(case)
    jv, jgx, jgk, jgU, *_ = jax_ref(case, route)
    np.testing.assert_allclose(v, jv, rtol=1e-10)
    if CASES[case][3] == "richards":
        np.testing.assert_allclose(gx, jgx, rtol=1e-8)
        assert abs(float(gx)) > 0.0
    else:
        assert float(gx) == 0.0 and float(jgx) == 0.0
    np.testing.assert_allclose(gk, jgk, rtol=1e-8)
    np.testing.assert_allclose(gU, jgU, rtol=1e-8, atol=1e-8 * np.max(np.abs(jgU)))
    assert abs(float(gk)) > 0.0


@pytest.mark.parametrize("route", ["pallas", "remat"])
@pytest.mark.parametrize("case", CASES)
def test_sat0_grad_matches_jax_at_unsaturated_cells(jax_ref, port_ref, case, route):
    """d/d sat0 within rtol 1e-8 of JAX at the unsaturated cells (with a
    floor of 1e-8 of its largest magnitude there); heat only, where nothing
    ties, at every cell."""
    got = port_ref(case)[4]
    *_, ref, unsat = jax_ref(case, route)
    assert unsat.any() and not unsat.all()
    if CASES[case][3] == "heat":
        unsat = np.ones_like(unsat)
    np.testing.assert_allclose(got[unsat], ref[unsat], rtol=1e-8,
                               atol=1e-8 * np.max(np.abs(ref[unsat])))


@pytest.mark.parametrize("case", ["heun", "implicit-pcr", "implicit-thomas"])
def test_water_identity_holds_at_every_cell(case):
    """Every step of these schemes conserves W = sum(sat*dz) + S, so
    dW/d sat0[k] = dz[k] and dW/dS0 = 1 at every cell, the exactly saturated
    ones included: rtol 1e-12 through Heun, 1e-10 through ImplicitEuler,
    whose solves round the column's sum of dz * du."""
    _, dt, _, physics = CASES[case]
    sim = _port_sim(case)
    grid = sim.model.grid
    state = sim.state.copy()
    sat0 = state.prognostic["saturation_water_ice"].clone().requires_grad_()
    S0 = state.prognostic["surface_excess_water"].clone().requires_grad_()
    state.prognostic.update(saturation_water_ice=sat0, surface_excess_water=S0)
    out = make_fused_grad_rollout(lambda p: _port_model(grid, physics, *p), sim.timestepper,
                                  sim.ctx, steps=STEPS, dt=dt, inner_steps=INNER)(state, (X0, K0))
    W = (out.saturation_water_ice * grid.dz).sum(0) + out.surface_excess_water
    g_sat, g_S = torch.autograd.grad(W.sum(), (sat0, S0))
    rtol = 1e-12 if case == "heun" else 1e-10
    assert bool((sat0 == 1.0).any())
    np.testing.assert_allclose(g_sat.numpy(), grid.dz.expand(NZ, CELLS).numpy(), rtol=rtol,
                               atol=0)
    np.testing.assert_allclose(g_S.numpy(), np.ones(CELLS), rtol=rtol, atol=0)


def _vjp_operands(case, steps=4):
    stepper, dt, solver, physics = CASES[case]
    sim = _port_sim(case)
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    carry = (sim.state.prognostic["internal_energy"], sim.state["saturation_water_ice"],
             None if physics == "heat" else sim.state.prognostic["surface_excess_water"])
    table = torch.linspace(2.0, 5.0, steps + (stepper == "heun"), dtype=torch.float64)
    rng = np.random.default_rng(len(case))
    cts = tuple(None if t is None else torch.as_tensor(rng.normal(size=tuple(t.shape)))
                for t in carry)
    kw = dict(stepper=stepper, physics=physics, solver=solver)
    return carry, table, coords, fs.ColumnParams.of(sim.model, torch.float64), dt, cts, kw


@pytest.mark.parametrize("case", CASES)
def test_segment_vjp_wrapper_on_cpu_is_the_plain_version(case):
    """On CPU tensors the wrapper of each new scheme is its plain version,
    with no launch; the heat-only one returns no pool cotangent and a zero
    K_sat one."""
    carry, table, coords, params, dt, cts, kw = _vjp_operands(case)
    before = fv.soil_column_segment_vjp.launches
    out = fv.soil_column_segment_vjp(*carry, table, *coords, params, dt, *cts, **kw)
    ref = fv.soil_column_segment_vjp_plain(*carry, table, *coords, params, dt, *cts, **kw)
    assert fv.soil_column_segment_vjp.launches == before
    for a, b in zip(out, ref):
        if b is None:
            assert a is None
            continue
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert out[3].dim() == 0 and out[4].dim() == 0
    if kw["physics"] == "heat":
        assert out[2] is None and float(out[3]) == 0.0
    with pytest.raises(ValueError, match="cotangent"):
        fv.soil_column_segment_vjp(*carry, table, *coords, params, dt, cts[0][:-1], *cts[1:],
                                   **kw)


def test_segment_vjp_refuses_the_schemes_it_does_not_run():
    carry, table, coords, params, dt, cts, _ = _vjp_operands("heat")
    for stepper in ("heun", "implicit"):
        with pytest.raises(ValueError, match="Queue B #2"):
            fv.soil_column_segment_vjp(*carry, table, *coords, params, dt, *cts,
                                       stepper=stepper, physics="heat")
    with pytest.raises(ValueError, match="solver"):
        fv.soil_column_segment_vjp(*carry, table, *coords, params, dt, *cts,
                                   stepper="implicit", physics="richards", solver="lu")


def test_fused_grad_refuses_what_it_does_not_differentiate():
    """Heun or ImplicitEuler over the heat-only model and picard_iters=2
    (ROADMAP Queue B #2), Heun over a LandModel (Queue B #1): each a
    ValueError naming its queue item; a LandModel under a soil's context, a
    ValueError naming the coupling context."""
    for case in ("heun", "implicit-pcr"):
        sim = _port_sim("heat")
        grid = sim.model.grid
        roll = make_fused_grad_rollout(lambda p: _port_model(grid, "heat", *p),
                                       _port_stepper(case), sim.ctx, steps=4, dt=300.0,
                                       inner_steps=2)
        with pytest.raises(ValueError, match="Queue B #2"):
            roll(sim.state, (X0, K0))
    sim = _port_sim("implicit-pcr", picard_iters=2)
    with pytest.raises(ValueError, match="Queue B #2"):
        make_fused_grad_rollout(lambda p: sim.model, sim.timestepper, sim.ctx, steps=4,
                                dt=1800.0, inner_steps=2)
    grid = sim.model.grid
    land = tp.initialize(tp.LandModel(grid=grid), tp.Heun(),
                         initializers={"temperature": 5.0, "saturation_water_ice": 0.8},
                         input_sources=(tp.FieldInputSource(fields={
                             "surface_shortwave_down": 400.0, "air_temperature": 12.0}),))
    roll = make_fused_grad_rollout(lambda p: land.model, land.timestepper, land.ctx, steps=4,
                                   dt=300.0, inner_steps=2)
    with pytest.raises(ValueError, match="Queue B #1"):
        roll(land.state, None)
    soil_ctx = _port_sim("heun").ctx  # a LandModel from model_fn under a soil context
    roll = make_fused_grad_rollout(lambda p: land.model, tp.ForwardEuler(), soil_ctx, steps=4,
                                   dt=300.0, inner_steps=2)
    with pytest.raises(ValueError, match="coupling context"):
        roll(land.state, None)


def test_fused_grad_refuses_a_parameter_it_would_not_differentiate():
    """A Van Genuchten alpha that requires grad: the kernels take it as a
    number, so the fused rollout refuses it, naming the two parameters it
    differentiates and make_rollout_fn, which differentiates it."""
    sim = _port_sim("heun")
    grid = sim.model.grid
    alpha = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)

    def model_fn(a):
        props = tp.ConstantSoilHydraulics(swrc=tp.VanGenuchten(alpha=a, n=2.0),
                                          unsat_hydraulic_cond=tp.UnsatKVanGenuchten())
        return tp.SoilModel(grid=grid, soil=tp.SoilEnergyWaterCarbon(
            hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq(),
                                       hydraulic_properties=props)))

    roll = make_fused_grad_rollout(model_fn, tp.ForwardEuler(), sim.ctx, steps=4, dt=300.0,
                                   inner_steps=2)
    with pytest.raises(ValueError, match=r"sat_hydraulic_cond and mineral conductivity.*"
                                         r"alpha.*make_rollout_fn"):
        roll(sim.state, alpha)
    roll(sim.state, 2.0)  # a number is taken as it is
