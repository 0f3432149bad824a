"""The port's gradient paths against ``jax.grad`` at float64 on the CPU.

The configuration is `tests/test_fused_grad.py`'s: 48 columns, Nz 10, dt
300 s, top temperature 4 degC, initial T = -1 degC and sat = min(1, 0.6 -
0.04 z), which leaves the bottom layers exactly saturated. The loss is
mean(T) + mean(sat) after the trailing closure. Both packages are built from
the same numbers; the port takes the parameters as 0-d tensors
(`terrarium_tpu_torch.convert.with_differentiable_params`).

At an exactly saturated layer the saturation sweeps tie, and the port's
derivative there follows its own convention (one predicate per level,
`processes/soil/hydrology.py::_SaturationSweeps`), not JAX's 0.5/0.5 tie
splits; it is held to the conservation of water instead, and compared with
JAX at the unsaturated cells.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.timesteppers.autodiff import make_rollout_fn as jax_rollout_fn
from terrarium_tpu.timesteppers.autodiff import make_step_fn as jax_step_fn
from terrarium_tpu.timesteppers.fused_grad import make_fused_grad_rollout as jax_fused_grad
from terrarium_tpu_torch.convert import with_differentiable_params
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.ops import fused_vjp as fv
from terrarium_tpu_torch.processes.soil import hydrology
from terrarium_tpu_torch.timesteppers.autodiff import make_rollout_fn, make_step_fn
from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout

from torch_parity import port_soil

CELLS, NZ, DT, STEPS, INNER = 48, 10, 300.0, 12, 4
X0, K0 = float(np.log(1e-5)), 3.8
INITS = {"temperature": -1.0,
         "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.6 - 0.04 * z)}
# the port's routes: the fused rollout, make_rollout_fn with each (remat,
# lean), and make_step_fn's step applied STEPS times; each is held to JAX's
# counterpart
MODULE_ROUTES = {"module-remat-lean": (True, True), "module-remat": (True, False),
                 "module-lean": (False, True), "module": (False, False)}
ROUTES = ["fused", *MODULE_ROUTES, "step"]


def _jax_model(grid, log_ksat, k_mineral):
    props = tt.ConstantSoilHydraulics(sat_hydraulic_cond=jnp.exp(log_ksat),
                                      swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
                                      unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
    thermal = tt.SoilThermalProperties(
        conductivities=tt.SoilThermalConductivities(mineral=k_mineral))
    soil = tt.SoilEnergyWaterCarbon(
        energy=tt.SoilEnergyBalance(thermal_properties=thermal),
        hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq(), hydraulic_properties=props))
    return tt.SoilModel(grid=grid, soil=soil)


def _port_model(grid, log_ksat, k_mineral):
    soil = with_differentiable_params(port_soil(), log_sat_hydraulic_cond=log_ksat,
                                      mineral_conductivity=k_mineral)
    return tp.SoilModel(grid=grid, soil=soil)


def _port_sim():
    grid = tp.ColumnGrid.of(cells=CELLS, spacing=tp.ExponentialSpacing(N=NZ),
                            dtype=torch.float64, device="cpu")
    return tp.initialize(_port_model(grid, X0, K0), tp.ForwardEuler(), initializers=INITS,
                         boundary_conditions=tp.PrescribedSurfaceTemperature(4.0))


def _loss(out):
    return out.temperature.mean() + out.saturation_water_ice.mean()


def _port_grads(route, steps=STEPS, inner=INNER, log_ksat=X0, k_mineral=K0, grads=True):
    """Loss and its gradients in (log K_sat, k_mineral, U0, sat0) through one
    of the port's ``ROUTES``."""
    sim = _port_sim()
    grid = sim.model.grid
    x = torch.tensor(log_ksat, dtype=torch.float64, requires_grad=True)
    k = torch.tensor(k_mineral, dtype=torch.float64, requires_grad=True)
    state = sim.state.copy()
    U0 = state.prognostic["internal_energy"].clone().requires_grad_()
    sat0 = state.prognostic["saturation_water_ice"].clone().requires_grad_()
    state.prognostic.update(internal_energy=U0, saturation_water_ice=sat0)
    if route == "fused":
        roll = make_fused_grad_rollout(lambda p: _port_model(grid, *p), sim.timestepper,
                                       sim.ctx, steps=steps, dt=DT, inner_steps=inner)
        out = roll(state, (x, k))
    elif route == "step":
        step, out = make_step_fn(_port_model(grid, x, k), sim.timestepper, sim.ctx), state
        for _ in range(steps):
            out = step(out, DT)
    else:
        remat, lean = MODULE_ROUTES[route]
        roll = make_rollout_fn(_port_model(grid, x, k), sim.timestepper, sim.ctx,
                               steps=steps, remat=remat, lean=lean)
        out = roll(state, DT)
    loss = _loss(out)
    if not grads:
        return float(loss.detach())
    gs = torch.autograd.grad(loss, (x, k, U0, sat0))
    return (float(loss.detach()), *(g.numpy() for g in gs))


@pytest.fixture(scope="module")
def jax_ref():
    """``jax.grad`` in (log K_sat, k_mineral, U0, sat0) of JAX's
    ``make_rollout_fn`` with each (remat, lean) and of its ``make_step_fn``
    applied STEPS times (computed when a test first asks for them), and of
    the fused rollout with the Pallas segment-VJP kernel (interpret mode)."""
    grid = tt.ColumnGrid.of(cells=CELLS, spacing=tt.ExponentialSpacing(N=NZ), nf=np.float64)
    sim = tt.initialize(_jax_model(grid, X0, K0), tt.ForwardEuler(), initializers=INITS,
                        boundary_conditions=tt.PrescribedSurfaceTemperature(4.0))

    def objective(out):
        return jnp.mean(out.temperature) + jnp.mean(out.saturation_water_ice)

    def loss_xla(x, k, u0, s0, remat, lean):
        st = sim.state.update(internal_energy=u0, saturation_water_ice=s0)
        roll = jax_rollout_fn(_jax_model(grid, x, k), sim.timestepper, sim.ctx, (),
                              steps=STEPS, remat=remat, lean=lean)
        return objective(roll(st, DT))

    def loss_step(x, k, u0, s0):
        st = sim.state.update(internal_energy=u0, saturation_water_ice=s0)
        step = jax_step_fn(_jax_model(grid, x, k), sim.timestepper, sim.ctx, ())
        st, _ = jax.lax.scan(lambda c, _: (step(c, DT), None), st, None, length=STEPS)
        return objective(st)

    def loss_pallas(x, u0, s0):
        st = sim.state.update(internal_energy=u0, saturation_water_ice=s0)
        roll = jax_fused_grad(lambda p: _jax_model(grid, p, K0), sim.timestepper, sim.ctx, (),
                              steps=STEPS, dt=DT, inner_steps=INNER, block_cells=CELLS,
                              interpret=True, bwd="pallas")
        return objective(roll(st, x))

    u0 = sim.state.prognostic["internal_energy"]
    s0 = sim.state.prognostic["saturation_water_ice"]
    cache = {}

    def ref(route):
        """The JAX gradients a port route is held to: the lean remat
        rollout for the fused one, the same (remat, lean) for make_rollout_fn,
        make_step_fn for make_step_fn."""
        key = "step" if route == "step" else MODULE_ROUTES.get(route, (True, True))
        if key not in cache:
            if key == "step":
                fn, args = loss_step, ()
            else:
                fn, args = (lambda x, k, u, s: loss_xla(x, k, u, s, *key)), ()
            v, g = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2, 3)))(X0, K0, u0, s0, *args)
            cache[key] = (float(v), *(np.asarray(a) for a in g))
        return cache[key]

    vp, gp = jax.jit(jax.value_and_grad(loss_pallas, argnums=(0, 1, 2)))(X0, u0, s0)
    return {"xla": ref, "pallas": (float(vp), *(np.asarray(a) for a in gp)),
            "unsat": np.asarray(s0) < 1.0}


@pytest.fixture(scope="module")
def port_ref():
    cache = {}

    def ref(route):
        if route not in cache:
            cache[route] = _port_grads(route)
        return cache[route]

    return ref


@pytest.mark.parametrize("route", ROUTES)
def test_grads_match_jax(jax_ref, port_ref, route):
    """d/d log K_sat, d/d k_mineral and d/dU0 within rtol 1e-9 of
    ``jax.grad`` of JAX's ``make_rollout_fn`` (the fused route against its
    ``lean=True, remat=True``) or of its ``make_step_fn``."""
    v, gx, gk, gU, _ = port_ref(route)
    jv, jgx, jgk, jgU, _ = jax_ref["xla"](route)
    np.testing.assert_allclose(v, jv, rtol=1e-10)
    np.testing.assert_allclose(gx, jgx, rtol=1e-9)
    np.testing.assert_allclose(gk, jgk, rtol=1e-9)
    np.testing.assert_allclose(gU, jgU, rtol=1e-9, atol=1e-9 * np.max(np.abs(jgU)))
    assert abs(float(gx)) > 0.0 and abs(float(gk)) > 0.0


@pytest.mark.parametrize("route", ROUTES)
def test_sat0_grad_matches_jax_at_unsaturated_cells(jax_ref, port_ref, route):
    got, ref, unsat = port_ref(route)[4], jax_ref["xla"](route)[4], jax_ref["unsat"]
    assert unsat.any() and not unsat.all()
    np.testing.assert_allclose(got[unsat], ref[unsat], rtol=1e-9,
                               atol=1e-9 * np.max(np.abs(ref[unsat])))


def test_fused_grad_matches_jax_pallas_segment_vjp(jax_ref, port_ref):
    """The port's segment VJP (plain on the CPU) against JAX's
    ``make_segment_vjp`` in interpret mode: d/d log K_sat within 1e-10, the
    state cotangents at the unsaturated cells within 1e-9."""
    v, gx, _, gU, gsat = port_ref("fused")
    jv, jgx, jgU, jgsat = jax_ref["pallas"]
    unsat = jax_ref["unsat"]
    np.testing.assert_allclose(v, jv, rtol=1e-10)
    np.testing.assert_allclose(gx, jgx, rtol=1e-10)
    for got, ref in ((gU, jgU), (gsat, jgsat)):
        np.testing.assert_allclose(got[unsat], ref[unsat], rtol=1e-9,
                                   atol=1e-9 * np.max(np.abs(ref[unsat])))


def _water_identity(route, steps=8, inner=4):
    """d W / d sat0 and d W / d S0 of the total water W = sum(sat*dz) + S
    after the rollout, per cell."""
    sim = _port_sim()
    grid = sim.model.grid
    state = sim.state.copy()
    sat0 = state.prognostic["saturation_water_ice"].clone().requires_grad_()
    S0 = state.prognostic["surface_excess_water"].clone().requires_grad_()
    state.prognostic.update(saturation_water_ice=sat0, surface_excess_water=S0)
    if route == "fused":
        out = make_fused_grad_rollout(lambda p: _port_model(grid, *p), sim.timestepper,
                                      sim.ctx, steps=steps, dt=DT,
                                      inner_steps=inner)(state, (X0, K0))
    else:
        out = make_rollout_fn(sim.model, sim.timestepper, sim.ctx, steps=steps, remat=True,
                              lean=True)(state, DT)
    W = (out.saturation_water_ice * grid.dz).sum(0) + out.surface_excess_water
    g_sat, g_S = torch.autograd.grad(W.sum(), (sat0, S0))
    return g_sat, g_S, grid.dz.expand(NZ, CELLS), sat0.detach()


@pytest.mark.parametrize("route", ["fused", "module"])
def test_water_identity_holds_at_every_cell(route):
    """Every step conserves W, so dW/d sat0[k] = dz[k] and dW/dS0 = 1 at
    every cell, the exactly saturated ones included."""
    g_sat, g_S, dz, sat0 = _water_identity(route)
    assert bool((sat0 == 1.0).any())
    np.testing.assert_allclose(g_sat.numpy(), dz.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(g_S.numpy(), np.ones(CELLS), rtol=1e-12, atol=0)


def _clamp_sweeps(sat, dz):
    """The sweeps as plain ``torch.clamp`` recurrences, whose autograd
    passes the cotangent to both the layer and the carry at a tie."""
    rows, dzr = sat.unbind(0), dz.unbind(0)
    c, up = torch.zeros_like(rows[0]), []
    for k in range(len(rows)):
        up.append(torch.clamp(rows[k] + c / dzr[k], max=1.0))
        c = torch.clamp((rows[k] - 1.0) * dzr[k] + c, min=0.0)
    c2, new = torch.zeros_like(c), [None] * len(rows)
    for k in reversed(range(len(rows))):
        new[k] = torch.clamp(up[k] - c2 / dzr[k], min=0.0)
        c2 = torch.clamp(-up[k] * dzr[k] + c2, min=0.0)
    return torch.stack(new), c


@pytest.mark.parametrize("route", ["fused", "module"])
def test_water_identity_fails_with_clamp_sweeps(monkeypatch, route):
    """The same forward values through clamp's derivative count the water of
    every saturated layer twice: the identity breaks at the saturated cells
    and holds at the others."""
    monkeypatch.setattr(hydrology, "saturation_sweeps", _clamp_sweeps)
    monkeypatch.setattr(fs, "saturation_sweeps", _clamp_sweeps)
    g_sat, _, dz, sat0 = _water_identity(route)
    rel = (g_sat - dz).abs() / dz
    assert float(rel[sat0 == 1.0].max()) > 1.0
    assert float(rel[sat0 < 1.0].max()) < 1e-12


def test_fused_grad_finite_difference():
    """A central difference in log K_sat (h = 0.02) within 5e-4, as
    `tests/test_fused_grad.py:164` holds the JAX fused path."""
    h = 0.02
    _, g_ad, *_ = _port_grads("fused", steps=8)
    f_p = _port_grads("fused", steps=8, log_ksat=X0 + h, grads=False)
    f_m = _port_grads("fused", steps=8, log_ksat=X0 - h, grads=False)
    np.testing.assert_allclose(float(g_ad), (f_p - f_m) / (2 * h), rtol=5e-4)


def test_segment_vjp_wrapper_on_cpu_is_the_plain_version():
    sim = _port_sim()
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    carry = tuple(sim.state.prognostic[n] for n in sim.model.live_carry)
    table = torch.full((4,), 4.0, dtype=torch.float64)
    params = fs.ColumnParams.of(sim.model, torch.float64)
    rng = np.random.default_rng(3)
    cts = tuple(torch.as_tensor(rng.normal(size=tuple(t.shape))) for t in carry)
    before = fv.soil_column_segment_vjp.launches
    out = fv.soil_column_segment_vjp(*carry, table, *coords, params, DT, *cts)
    ref = fv.soil_column_segment_vjp_plain(*carry, table, *coords, params, DT, *cts)
    assert fv.soil_column_segment_vjp.launches == before
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert out[3].dim() == 0 and out[4].dim() == 0
    with pytest.raises(ValueError, match="cotangent"):
        fv.soil_column_segment_vjp(*carry, table, *coords, params, DT, cts[0][:-1], *cts[1:])


def test_fused_grad_rejects_bad_config():
    sim = _port_sim()
    grid = sim.model.grid

    def model_fn(p):
        return _port_model(grid, *p)

    with pytest.raises(ValueError, match="multiple"):
        make_fused_grad_rollout(model_fn, sim.timestepper, sim.ctx, steps=10, dt=DT,
                                inner_steps=4)
    with pytest.raises(ValueError, match="ForwardEuler"):
        make_fused_grad_rollout(model_fn, object(), sim.ctx, steps=8, dt=DT, inner_steps=4)
    for bcs, match in (
            ({"temperature": {"top": tp.Neumann(0.1)}}, "Dirichlet"),
            ({"temperature": {"top": tp.Dirichlet(4.0), "bottom": tp.Neumann(0.0)}},
             "other BCs"),
            ({"temperature": {"top": tp.Dirichlet(lambda t, state: 4.0 + 0.0 * t)}}, "f\\(t\\)"),
            ({"temperature": {"top": tp.Dirichlet("surface_excess_water")}}, "f\\(t\\)")):
        with pytest.raises(ValueError, match=match):
            make_fused_grad_rollout(model_fn, sim.timestepper, sim.model.make_context(bcs),
                                    steps=8, dt=DT, inner_steps=4)
