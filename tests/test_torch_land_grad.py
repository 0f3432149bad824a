"""The LandModel's fused gradient against JAX at float64 on the CPU
(`tests/torch_land_grad.py` has the composition, the cases and the checks):
ForwardEuler at dt 600 s, JAX's case; and the rollout's segments through the
land wrappers, and the fused gradient's refusals."""
import dataclasses

import numpy as np
import pytest
import torch

import terrarium_tpu_torch as tp
from terrarium_tpu_torch.ops import land_vjp as lv
from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout
from torch_land_grad import (CELLS, DT, INITS, INNER, K0, STEPS, X0, _objective,  # noqa: F401
                             _port_model, _port_sim, check_fused_grad, check_sat0_grad, jax_ref,
                             port_ref)


@pytest.mark.parametrize("route", ["pallas", "remat"])
@pytest.mark.parametrize("case", ["euler"])
def test_land_fused_grad_matches_jax(jax_ref, port_ref, case, route):
    """`torch_land_grad.check_fused_grad`: the value, d/d log K_sat,
    d/d k_mineral, d/dU0 and d/dC0 against JAX's Pallas segment VJP
    (interpret mode) and its remat rollout."""
    check_fused_grad(jax_ref, port_ref, case, route)


@pytest.mark.parametrize("case", ["euler"])
def test_land_sat0_grad_matches_jax_sequential_adjustment(jax_ref, port_ref, case):
    """`torch_land_grad.check_sat0_grad`: d/d sat0 against JAX's remat
    rollout under its sequential saturation adjustment."""
    check_sat0_grad(jax_ref, port_ref, case)


def test_land_fused_grad_runs_the_land_segments(monkeypatch):
    """The rollout's segments go through the land rollout and the land
    segment-VJP wrappers (here their plain versions): 2 segments, 2 VJP
    calls, with the scheme's stepper and solver."""
    calls = []
    real = lv.land_column_segment_vjp

    def spy(*a, **kw):
        calls.append((kw["stepper"], kw["solver"], a[10]))
        return real(*a, **kw)

    import terrarium_tpu_torch.timesteppers.fused_grad as fg
    monkeypatch.setattr(fg, "land_column_segment_vjp", spy)
    sim = _port_sim("implicit-pcr")
    grid = sim.model.grid
    k = torch.tensor(K0, dtype=torch.float64, requires_grad=True)
    roll = make_fused_grad_rollout(lambda p: _port_model(grid, "implicit-pcr", X0, p),
                                   sim.timestepper, sim.ctx, sim.input_sources, steps=STEPS,
                                   dt=DT, inner_steps=INNER)
    out = roll(sim.state, k)
    assert out.clock.iteration == STEPS
    _objective(out, torch).backward()
    assert calls == [("implicit", "pcr", INNER)] * 2
    assert k.grad is not None and float(k.grad) != 0.0


def test_land_fused_grad_refusals(monkeypatch):
    """Series sources are refused, naming their ROADMAP item (JAX's fused
    gradient refuses them too). picard_iters > 1, Heun over the LandModel
    and a snowpack, each refused until the land segment VJP took it, now run
    the land segments: each segment's VJP with its scheme, and a finite
    non-zero gradient (`tests/test_torch_land_grad_snow_heun.py` holds Heun
    and the snowpack to JAX)."""
    sim = _port_sim("euler")
    grid = sim.model.grid
    series = tp.TimeSeriesInputSource(times=np.array([0.0, 3600.0]), series={
        "air_temperature": np.array([5.0, 6.0])})
    with pytest.raises(ValueError, match="Queue B #1"):
        make_fused_grad_rollout(lambda p: sim.model, sim.timestepper, sim.ctx, (series,),
                                steps=4, dt=DT, inner_steps=2)
    calls = []
    real = lv.land_column_segment_vjp

    def spy(*a, **kw):
        calls.append((kw["stepper"], kw["solver"], kw["picard_iters"], "snow" in a[7].tags,
                      a[10]))
        return real(*a, **kw)

    import terrarium_tpu_torch.timesteppers.fused_grad as fg
    monkeypatch.setattr(fg, "land_column_segment_vjp", spy)
    k = torch.tensor(K0, dtype=torch.float64, requires_grad=True)
    roll = make_fused_grad_rollout(lambda p: _port_model(grid, "euler", X0, p),
                                   tp.ImplicitEuler(dt=DT, picard_iters=2), sim.ctx,
                                   sim.input_sources, steps=4, dt=DT, inner_steps=2)
    _objective(roll(sim.state, k), torch).backward()
    assert calls == [("implicit", "pcr", 2, False, 2)] * 2
    assert k.grad is not None and float(k.grad) != 0.0
    snow = dataclasses.replace(sim.model, snow=tp.Snowpack())
    snow_sim = tp.initialize(snow, sim.timestepper, initializers=INITS,
                             input_sources=sim.input_sources)
    for model, ts, state, ctx in ((sim.model, tp.Heun(dt=60.0), sim.state, sim.ctx),
                                  (snow, sim.timestepper, snow_sim.state, snow_sim.ctx)):
        roll = make_fused_grad_rollout(lambda p: model, ts, ctx, sim.input_sources, steps=4,
                                       dt=ts.dt, inner_steps=2)
        state = state.copy()
        U0 = state.internal_energy.clone().requires_grad_()
        state.set(internal_energy=U0)
        (g,) = torch.autograd.grad(_objective(roll(state, None), torch), U0)
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0
    assert calls[2:] == [("heun", None, 1, False, 2)] * 2 + [("euler", None, 1, True, 2)] * 2
    assert grid.cells == CELLS
