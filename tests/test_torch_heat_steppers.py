"""Heun and ImplicitEuler over the default heat-only SoilModel, and
ImplicitEuler's Picard iterations over either physics, through the port's
column rollouts, against the JAX package at float64 on the CPU.

The JAX references: ``make_fused_lean_rollout`` in interpret mode (its
Pallas kernel traces the stepper's ``pre_closure_step``, Picard iterations
included, as `tests/test_torch_noflow.py` runs it) and ``Simulation.run``.
The port's rollout on the CPU is the plain version of its CUDA kernels
(``soil_column_heat_heun_rollout``, ``soil_column_heat_implicit_rollout``,
``soil_column_implicit_rollout(..., picard_iters=)``), whose column code the
host build holds to it (`test_torch_step_host.py`). The heat-only
configuration is ``global_heat_n72_forcing`` (`torch_parity.heat_forcing`:
an hourly (T, cells) series, T_mean = 25 max(cos lat, 0.05) - 5 from -60 to
80 degrees), whose cool columns cross the freeze plateau; heat + Richards is
``implicit_freeze``. Saturations that went through the adjustment are held
at an absolute 1e-12 (the closed form against the sweeps, ROADMAP Queue C).
"""
import jax
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.ops.fused_step import make_fused_lean_rollout
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.timesteppers.integrator import advance

from torch_parity import assert_fields_close, heat_forcing, implicit_freeze

CELLS, NZ, STEPS = 16, 12, 24
HEAT_FIELDS = ("internal_energy", "temperature", "liquid_water_fraction",
               "saturation_water_ice", "ground_temperature")
RICHARDS_FIELDS = ("internal_energy", "surface_excess_water", "temperature",
                   "pressure_head", "liquid_water_fraction", "water_table")
#: name -> (stepper, dt, solver, picard_iters) of the heat-only cases
HEAT_CASES = {"heun": ("heun", 300.0, "pcr", 1),
              **{f"implicit-{s}-{k}": ("implicit", 3600.0, s, k) for s in ("pcr", "thomas")
                 for k in (1, 2, 3)}}


def _stepper(m, case):
    stepper, dt, solver, picard = HEAT_CASES[case]
    if stepper == "heun":
        return m.Heun(dt=dt)
    return m.ImplicitEuler(dt=dt, solver=solver, picard_iters=picard)


def _heat_sims(case):
    """The JAX and port simulations of ``global_heat_n72_forcing`` on
    CELLS columns, Nz NZ, stepped by the case's stepper."""
    sims = []
    for pkg, m in (("jax", tt), ("port", tp)):
        base = heat_forcing(pkg, CELLS, nz=NZ, dtype=torch.float64, days=2)
        sims.append(m.Simulation(base.model, _stepper(m, case), base.state, base.input_sources,
                                 bcs=base.bcs))
    return sims


@pytest.mark.parametrize("ref", ["pallas", "run"])
@pytest.mark.parametrize("case", HEAT_CASES)
def test_heat_rollout_matches_jax(case, ref):
    """The plain heat-only rollout (``advance(..., plain=True)``, the
    kernel's arithmetic) against JAX's Pallas kernel in interpret mode, and
    the port's ``run`` against JAX's ``run``, 24 steps: every field at
    1e-12, the saturation never written; some columns end on the freeze
    plateau."""
    jsim, psim = _heat_sims(case)
    dt = HEAT_CASES[case][1]
    if ref == "pallas":
        fused = make_fused_lean_rollout(jsim.model, jsim.timestepper, jsim.ctx,
                                        jsim.input_sources, dt=dt, inner_steps=8,
                                        block_cells=128, interpret=True)
        jstate = jax.jit(lambda s: fused(s, STEPS))(jsim.state)
        advance(psim.model, psim.state, psim.ctx, STEPS, dt, timestepper=psim.timestepper,
                input_sources=psim.input_sources, plain=True)
        names = HEAT_FIELDS[:4]
    else:
        jsim.run(steps=STEPS, dt=dt)
        psim.run(steps=STEPS, dt=dt)
        jstate, names = jsim.state, HEAT_FIELDS + ("surface_temperature",)
    assert_fields_close(psim.state, jstate, names)
    assert torch.equal(psim.state.saturation_water_ice,
                       torch.full_like(psim.state.saturation_water_ice, 0.8))
    liq = psim.state.liquid_water_fraction
    assert bool(((liq > 0.0) & (liq < 1.0)).any())


@pytest.mark.parametrize("case", ["heun", "implicit-pcr-2", "implicit-thomas-3"])
def test_plain_heat_rollout_equals_module_steps(case):
    """The plain heat-only rollout and ``closure`` after ``pre_closure_step``
    repeated, composed from the modules: the rollout reads the series as
    the kernel does, ``(t - t0) / dts``, where the source interpolates
    between its own rows, an ulp of the top temperature apart, so 1e-12."""
    _, sim = _heat_sims(case)
    _, ref = _heat_sims(case)
    dt = HEAT_CASES[case][1]
    advance(sim.model, sim.state, sim.ctx, STEPS, dt, timestepper=sim.timestepper,
            input_sources=sim.input_sources, plain=True)
    for _ in range(STEPS):
        ref.timestepper.pre_closure_step(ref.model, ref.state, ref.ctx, ref.input_sources, dt)
    ref.model.closure(ref.state, ref.ctx)
    for name in HEAT_FIELDS[:3]:
        b = ref.state[name]
        torch.testing.assert_close(sim.state[name], b, rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()), msg=name)


@pytest.mark.parametrize("case", ["heun", "implicit-pcr-1", "implicit-thomas-2"])
def test_run_takes_the_heat_rollout(case, monkeypatch):
    """``run`` takes the column rollout for the heat-only model with Heun and
    with ImplicitEuler (the wrapper of ``ROLLOUTS``, whose plain version
    runs on the CPU, once for the uniform series, with the stepper's solver
    and Picard count), never a process-module step; the wrappers count no
    launch on the CPU."""
    stepper, dt, solver, picard = HEAT_CASES[case]
    wrapper = fs.ROLLOUTS[stepper, "heat"]
    assert wrapper is {"heun": fs.soil_column_heat_heun_rollout,
                       "implicit": fs.soil_column_heat_implicit_rollout}[stepper]
    calls = []
    plain = fs.soil_column_rollout_plain

    def counted(*args, **kwargs):
        calls.append(kwargs)
        return plain(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("a process-module step ran")

    _, sim = _heat_sims(case)
    monkeypatch.setattr(fs, "soil_column_rollout_plain", counted)
    monkeypatch.setattr(type(sim.timestepper), "pre_closure_step", refused)
    before = wrapper.launches
    sim.run(steps=STEPS, dt=dt)
    want = {"stepper": stepper, "physics": "heat", "solver": solver if stepper == "implicit"
            else "pcr", "picard_iters": picard}
    assert calls == [want] and wrapper.launches == before
    assert sim.iteration == STEPS


@pytest.mark.parametrize("picard", [2, 3])
@pytest.mark.parametrize("solver", ["pcr", "thomas"])
def test_picard_richards_rollout_matches_jax(solver, picard):
    """``implicit_freeze`` (heat + Richards, dt 3600 s) with ``picard``
    Picard iterations: the plain rollout against JAX's Pallas kernel in
    interpret mode, and ``run`` against JAX's ``run``, 24 steps; the
    saturation at an absolute 1e-12, the rest at rtol 1e-12."""
    jsim = implicit_freeze("jax", solver, picard_iters=picard)
    psim = implicit_freeze("port", solver, picard_iters=picard)
    fused = make_fused_lean_rollout(jsim.model, jsim.timestepper, jsim.ctx, (), dt=3600.0,
                                    inner_steps=8, block_cells=128, interpret=True)
    jstate = jax.jit(lambda s: fused(s, STEPS))(jsim.state)
    advance(psim.model, psim.state, psim.ctx, STEPS, 3600.0, timestepper=psim.timestepper,
            plain=True)
    jsim.run(steps=STEPS, dt=3600.0)
    run = implicit_freeze("port", solver, picard_iters=picard).run(steps=STEPS, dt=3600.0)
    for got, want, names in ((psim, jstate, RICHARDS_FIELDS[:4]),
                             (run, jsim.state, RICHARDS_FIELDS + ("hydraulic_conductivity",))):
        np.testing.assert_allclose(got.state.saturation_water_ice.numpy(),
                                   np.asarray(want["saturation_water_ice"]), rtol=0, atol=1e-12)
        assert_fields_close(got.state, want, names)
    assert bool((psim.state.liquid_water_fraction < 1.0).any())


@pytest.mark.parametrize("picard", [2, 3])
@pytest.mark.parametrize("solver", ["pcr", "thomas"])
def test_picard_keeps_the_water_identity(solver, picard):
    """W = sum(sat dz) + S of every column through the Picard rollout, to
    1e-12 of W, with an hourly series that freezes and thaws the top. The
    later iterations drop the spill of their iterate's closure, but their
    right side -(sat_k - sat^n) / dt brings the column's sum of dz * sat
    back to the closed start's, so the identity of the one-iteration step
    (`test_torch_implicit.py::test_water_identity`) holds."""
    base = implicit_freeze("port", solver)
    hours = np.arange(0.0, 30 * 3600.0, 3600.0)
    series = (np.linspace(-9.0, 4.0, 6)[None, :]
              + 5.0 * np.sin(2 * np.pi * hours / 86400.0)[:, None])
    sim = tp.initialize(base.model, tp.ImplicitEuler(dt=3600.0, solver=solver,
                                                     picard_iters=picard),
                        (tp.TimeSeriesInputSource(times=hours,
                                                  series={"air_temperature": series}),),
                        initializers={"temperature": lambda x, z: 1.0 + 0.0 * z,
                                      "saturation_water_ice": lambda x, z: np.minimum(
                                          1.0, 0.65 - 0.04 * z)},
                        boundary_conditions=tp.PrescribedSurfaceTemperature("air_temperature"))
    dz = sim.model.grid.dz

    def water():
        return (sim.state.saturation_water_ice * dz).sum(0) + sim.state.surface_excess_water

    w0 = water()
    sim.run(steps=STEPS, dt=3600.0)
    torch.testing.assert_close(water(), w0, rtol=1e-12, atol=0)
    assert bool((sim.state.liquid_water_fraction < 1.0).any())


# ---------------------------------------------------------------------------
# stiff accuracy (`tests/test_implicit_stiff.py`) through the rollout
# ---------------------------------------------------------------------------
def _freeze_sim(stepper):
    grid = tp.ColumnGrid.of(cells=1, spacing=tp.UniformSpacing(dz=0.05, N=40),
                            dtype=torch.float64, device="cpu")
    return tp.initialize(tp.SoilModel(grid=grid), stepper,
                         initializers={"temperature": 1.0, "saturation_water_ice": 1.0},
                         boundary_conditions=tp.PrescribedSurfaceTemperature(-10.0))


def _freeze_T(stepper, dt, hours=24.0):
    sim = _freeze_sim(stepper)
    sim.run(steps=int(hours * 3600 / dt), dt=dt)
    return sim.state.temperature[:, 0].numpy()


@pytest.mark.parametrize("picard", [1, 2])
@pytest.mark.parametrize("solver", ["pcr", "thomas"])
def test_freeze_front_through_the_rollout(solver, picard, monkeypatch):
    """The bounds of `tests/test_implicit_stiff.py:48-66` with ``run``
    through the heat-only implicit rollout (no process-module step) against
    a 10 s ForwardEuler trajectory (the heat-only ForwardEuler rollout):
    within 0.05 K at dt 900 and 0.35 K at dt 3600, the error shrinking with
    dt, and the 0 degC crossing within one layer at dt 900."""
    T_ref = _freeze_T(tp.ForwardEuler(), dt=10.0)

    def refused(*args, **kwargs):
        raise AssertionError("a process-module step ran")

    monkeypatch.setattr(tp.ImplicitEuler, "pre_closure_step", refused)
    T900, T3600 = (_freeze_T(tp.ImplicitEuler(solver=solver, picard_iters=picard), dt)
                   for dt in (900.0, 3600.0))
    errs = [float(np.max(np.abs(T - T_ref))) for T in (T900, T3600)]
    assert errs[0] < 0.05 and errs[1] < 0.35 and errs[0] < errs[1], errs
    assert abs(int(np.argmax(T_ref < 0.0)) - int(np.argmax(T900 < 0.0))) <= 1


@pytest.mark.parametrize("picard", [1, 2])
def test_freeze_energy_conservation(picard):
    """`tests/test_implicit_stiff.py:69-84` on the port: with zero-flux ends
    ``run`` (the process modules: a column rollout needs a Dirichlet top)
    keeps sum(U dz) to 1e-12, with one and two Picard iterations."""
    grid = tp.ColumnGrid.of(cells=1, spacing=tp.UniformSpacing(dz=0.1, N=20),
                            dtype=torch.float64, device="cpu")
    sim = tp.initialize(tp.SoilModel(grid=grid), tp.ImplicitEuler(dt=3600.0,
                                                                  picard_iters=picard),
                        initializers={"temperature": lambda x, z: 1.0 + 0.4 * z,
                                      "saturation_water_ice": 1.0})
    U0 = float((sim.state.internal_energy * grid.dz).sum())
    sim.run(steps=24)
    np.testing.assert_allclose(float((sim.state.internal_energy * grid.dz).sum()), U0,
                               rtol=1e-12)
