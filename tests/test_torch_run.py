"""``Simulation.run`` for every composition the process modules step, with
``forcings=``, ``callbacks=`` and ``reinitialize``, against the JAX package
at float64; the JAX argument forms of the steppers, ``make_rollout_fn`` and
``make_fused_grad_rollout``; and the steppers' post-step hook.

``run`` takes a column kernel (its plain version here, on the CPU) for the
compositions the kernels take, chosen by type, and the modules' closure-
rotated loop for every other, as JAX's default ``run`` takes its lean scan
for all (`terrarium_tpu/timesteppers/integrator.py:150-201`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.timesteppers.autodiff import make_rollout_fn as jax_make_rollout_fn
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.ops import land_step as ls
from terrarium_tpu_torch.timesteppers import integrator
from terrarium_tpu_torch.timesteppers.autodiff import make_rollout_fn
from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout

from torch_parity import CONFIGS, assert_fields_close, jax_soil, port_soil

SOIL_FIELDS = ("internal_energy", "saturation_water_ice", "surface_excess_water",
               "temperature", "liquid_water_fraction", "pressure_head", "water_table",
               "hydraulic_conductivity", "ground_temperature")


def _grid(m, cells=6, nz=12, dtype=torch.float64):
    if m is tt:
        return tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=nz),
                                nf=np.float64 if dtype == torch.float64 else np.float32)
    return tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=dtype,
                            device="cpu")


def _bench(m, ts, bcs, forcings=None):
    """The bench soil (heat + Richards over Van Genuchten and Mualem) on 6
    columns at Nz 12 from the bench initial state."""
    return m.initialize(m.SoilModel(grid=_grid(m), soil=jax_soil() if m is tt else port_soil()),
                        ts, initializers=CONFIGS["bench"]["inits"], boundary_conditions=bcs,
                        forcings=forcings)


def _heat(m, ts, bottom=None):
    """The default heat-only model under a -3 degC top (and ``bottom``'s
    BCs)."""
    bcs = m.PrescribedSurfaceTemperature(-3.0)
    return m.initialize(m.SoilModel(grid=_grid(m)), ts,
                        initializers={"temperature": lambda x, z: 1.5 + 0.2 * z + 0.0 * x,
                                      "saturation_water_ice": 0.8},
                        boundary_conditions=bcs if bottom is None else {**bcs, **bottom})


def _land(m, ts, bcs=None):
    """The bare-ground LandModel with static inputs."""
    return m.initialize(m.LandModel(grid=_grid(m, 4, 8)), ts,
                        (m.FieldInputSource(fields={"surface_shortwave_down": 400.0,
                                                    "air_temperature": 12.0,
                                                    "rainfall": 1.0e-7}),),
                        initializers={"temperature": 6.0, "saturation_water_ice": 0.6},
                        boundary_conditions=bcs)


def _top(m):
    return m.PrescribedSurfaceTemperature(5.0)


#: each composition no kernel takes: (its constructor in package m, steps, dt)
MODULE_CASES = {
    "no BC": (lambda m: _bench(m, m.ForwardEuler(dt=60.0), None), 10, 60.0),
    "top f(t, state)": (lambda m: _bench(m, m.ForwardEuler(dt=60.0),
                                         m.PrescribedSurfaceTemperature(
                                             lambda t, state: 2.0 + 0.5 * state.temperature[-1])),
                        10, 60.0),
    "GeothermalHeatFlux": (lambda m: _bench(m, m.ForwardEuler(dt=60.0),
                                            {**_top(m), **m.GeothermalHeatFlux(0.08)}), 10, 60.0),
    "PrescribedBottomTemperature": (lambda m: _bench(m, m.Heun(dt=60.0), m.merge_boundary_conditions(
        _top(m), m.PrescribedBottomTemperature(2.0))), 10, 60.0),
    "ImpermeableBoundary": (lambda m: _bench(m, m.ForwardEuler(dt=60.0),
                                             {**_top(m), **m.ImpermeableBoundary()}), 10, 60.0),
    "FreeDrainage": (lambda m: _bench(m, m.ForwardEuler(dt=60.0),
                                      {**_top(m), **m.FreeDrainage()}), 10, 60.0),
    # heat-only Heun and ImplicitEuler and two Picard iterations take the
    # soil rollouts (test_kernel_compositions_still_take_their_rollout); with
    # a geothermal flux at the bottom, the modules
    "heat-only Heun": (lambda m: _heat(m, m.Heun(dt=300.0), m.GeothermalHeatFlux(0.08)), 12,
                       300.0),
    "heat-only ImplicitEuler": (lambda m: _heat(m, m.ImplicitEuler(dt=900.0),
                                                m.GeothermalHeatFlux(0.08)), 12, 900.0),
    "picard_iters=2": (lambda m: _bench(m, m.ImplicitEuler(dt=900.0, picard_iters=2),
                                        {**_top(m), **m.GeothermalHeatFlux(0.08)}), 8, 900.0),
    # the land rollouts take Heun and ImplicitEuler (any Picard count) with
    # the coupling BCs (test_kernel_compositions_still_take_their_rollout);
    # with a geothermal flux at the bottom, the modules
    "LandModel Heun": (lambda m: _land(m, m.Heun(dt=300.0), m.GeothermalHeatFlux(0.08)), 6,
                       300.0),
    "LandModel ImplicitEuler": (lambda m: _land(m, m.ImplicitEuler(dt=300.0, picard_iters=2),
                                                m.GeothermalHeatFlux(0.08)), 6, 300.0),
}


@pytest.fixture
def no_kernel(monkeypatch):
    """Make every column rollout, kernel or plain version, fail."""
    def refused(*args, **kwargs):
        raise AssertionError("a column rollout ran")

    for mod, name in ((fs, "soil_column_rollout_plain"), (integrator, "soil_column_rollout_plain"),
                      (ls, "land_column_rollout"), (ls, "land_column_rollout_plain")):
        monkeypatch.setattr(mod, name, refused)


def _module_steps(sim, steps, dt):
    """The process modules stepped ``steps`` times as ``run`` steps a
    composition no kernel takes: ``pre_closure_step`` on the whole state,
    ``closure``, then ``compute_auxiliary``."""
    for _ in range(steps):
        sim.timestepper.pre_closure_step(sim.model, sim.state, sim.ctx, sim.input_sources, dt)
    sim.model.closure(sim.state, sim.ctx)
    return sim.compute_auxiliary()


def _assert_states_close(pstate, jstate, rtol=1e-12):
    """Every field of every group and the clock: at ``rtol`` with a floor of
    ``rtol`` times the field's largest magnitude; the tendencies, each a
    difference of nearly equal fluxes whose rounding is that of the fluxes,
    with a floor of 10 ``rtol`` (measured: up to 2.9e-12 of the saturation
    tendency's largest magnitude near equilibrium)."""
    for g in ("prognostic", "tendencies", "auxiliary", "inputs"):
        assert sorted(getattr(pstate, g)) == sorted(getattr(jstate, g)), g
        floor = 10.0 * rtol if g == "tendencies" else rtol
        for k, v in getattr(jstate, g).items():
            ref = np.asarray(v)
            np.testing.assert_allclose(getattr(pstate, g)[k].numpy(), ref, rtol=rtol,
                                       atol=floor * max(float(np.abs(ref).max()), 1e-300),
                                       err_msg=f"{g}/{k}")
    assert float(pstate.clock.time) == float(jstate.clock.time)
    assert int(pstate.clock.iteration) == int(jstate.clock.iteration)


@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_run_steps_the_modules_where_no_kernel_takes(case, no_kernel):
    """``run(n)`` of a composition no kernel takes goes through the process
    modules, on the state's device: it equals the port's modules stepped
    ``n`` times bitwise, and JAX's ``run`` (its lean scan of the modules)
    at 1e-12 in every field, the tendencies the last step leaves
    included."""
    make, steps, dt = MODULE_CASES[case]
    psim, ref, jsim = make(tp), make(tp), make(tt)
    assert integrator.column_scheme(psim.model, psim.timestepper, psim.ctx,
                                    psim.input_sources) is None
    psim.run(steps=steps, dt=dt)
    _module_steps(ref, steps, dt)
    for g in ("prognostic", "tendencies", "auxiliary"):
        for k, v in getattr(ref.state, g).items():
            assert torch.equal(getattr(psim.state, g)[k], v), (g, k)
    jsim.run(steps=steps, dt=dt)
    _assert_states_close(psim.state, jsim.state)
    assert any(float(v.abs().max()) > 0.0 for v in psim.state.tendencies.values())


def test_soil_module_run_equals_timesteps():
    """On the soil, ``run(n)`` equals ``timestep()`` ``n`` times after a
    ``closure`` (``run``'s rotated steps close first) at 1e-12: a top BC
    ``f(t, state)`` and a geothermal flux at the bottom."""
    for make, steps, dt in (MODULE_CASES["GeothermalHeatFlux"],
                            MODULE_CASES["top f(t, state)"]):
        a, b = make(tp), make(tp)
        a.run(steps=steps, dt=dt)
        b.model.closure(b.state, b.ctx)
        for _ in range(steps):
            b.timestep(dt)
        assert_fields_close(a.state, {k: b.state[k].numpy() for k in SOIL_FIELDS}, SOIL_FIELDS)


@pytest.mark.parametrize("case", ["euler", "heun series", "heat", "implicit", "land",
                                  "land heun", "land implicit", "heat heun", "heat implicit",
                                  "picard", "land picard"])
def test_kernel_compositions_still_take_their_rollout(case, monkeypatch):
    """The compositions a kernel takes still go through the column rollout
    (here, on the CPU, its plain version), never the module loop."""
    calls = []

    def spy(fn):
        def wrapped(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    def modules(*args, **kwargs):
        raise AssertionError("the module loop ran")

    monkeypatch.setattr(integrator, "_advance_modules", modules)
    monkeypatch.setattr(fs, "soil_column_rollout_plain", spy(fs.soil_column_rollout_plain))
    monkeypatch.setattr(ls, "land_column_rollout_plain", spy(ls.land_column_rollout_plain))
    if case == "euler":
        sim = _bench(tp, tp.ForwardEuler(dt=60.0), _top(tp))
    elif case == "heun series":
        sim = tp.initialize(tp.SoilModel(grid=_grid(tp), soil=port_soil()), tp.Heun(dt=60.0),
                            (tp.TimeSeriesInputSource(times=np.array([0.0, 3600.0]), series={
                                "surface_temperature": np.array([1.0, 4.0])}),),
                            initializers=CONFIGS["bench"]["inits"],
                            boundary_conditions=tp.PrescribedSurfaceTemperature(
                                "surface_temperature"))
    elif case == "heat":
        sim = _heat(tp, tp.ForwardEuler(dt=300.0))
    elif case == "heat heun":
        sim = _heat(tp, tp.Heun(dt=300.0))
    elif case == "heat implicit":
        sim = _heat(tp, tp.ImplicitEuler(dt=900.0, picard_iters=2))
    elif case == "picard":
        sim = _bench(tp, tp.ImplicitEuler(dt=900.0, solver="thomas", picard_iters=3), _top(tp))
    elif case == "implicit":
        sim = _bench(tp, tp.ImplicitEuler(dt=900.0, solver="thomas"), _top(tp))
    elif case == "land":
        sim = _land(tp, tp.ForwardEuler(dt=300.0))
    elif case == "land heun":
        sim = _land(tp, tp.Heun(dt=300.0))
    elif case == "land picard":
        sim = _land(tp, tp.ImplicitEuler(dt=300.0, picard_iters=2))
    else:
        sim = _land(tp, tp.ImplicitEuler(dt=300.0, solver="thomas"))
    sim.run(steps=4)
    assert calls == ["land_column_rollout_plain" if case.startswith("land")
                     else "soil_column_rollout_plain"]
    assert all(float(v.abs().max()) == 0.0 for v in sim.state.tendencies.values())


@pytest.mark.parametrize("path", ["kernel", "modules"])
def test_callback_run_matches_jax_chunk_by_chunk(path):
    """``run(10, callbacks=, callback_interval=4)`` runs chunks of 4, 4 and
    2 steps, after each ``compute_auxiliary`` and then every callback with
    the simulation; each chunk's clock and fields equal JAX's at 1e-12,
    through a kernel composition and through the modules (a forcing)."""
    forcings = {"internal_energy": lambda s, g: 40.0} if path == "modules" else None
    seen = {}
    for m in (tt, tp):
        sim = _bench(m, m.ForwardEuler(dt=60.0), _top(m), forcings=forcings)
        chunks = seen.setdefault(m.__name__, [])

        def record(s, chunks=chunks):
            chunks.append((s.iteration, s.current_time,
                           {k: np.asarray(s.state[k]) if m is tt else s.state[k].numpy().copy()
                            for k in SOIL_FIELDS}))

        sim.run(steps=10, dt=60.0, callbacks=(record,), callback_interval=4)
    jax_chunks, port_chunks = seen["terrarium_tpu"], seen["terrarium_tpu_torch"]
    assert [c[:2] for c in port_chunks] == [c[:2] for c in jax_chunks] == [
        (4, 240.0), (8, 480.0), (10, 600.0)]
    for (_, _, p), (_, _, j) in zip(port_chunks, jax_chunks):
        for k in SOIL_FIELDS:
            np.testing.assert_allclose(p[k], j[k], rtol=1e-12,
                                       atol=1e-12 * float(np.abs(j[k]).max()), err_msg=k)


def test_reinitialize_restores_the_initial_state():
    sim = _bench(tp, tp.ForwardEuler(dt=60.0), _top(tp), forcings={
        "surface_excess_water": lambda s, g: 1e-6})
    fresh = _bench(tp, tp.ForwardEuler(dt=60.0), _top(tp))
    sim.run(steps=5)
    assert sim.reinitialize() is sim and sim.iteration == 0 and sim.current_time == 0.0
    for g in ("prognostic", "tendencies", "auxiliary", "inputs"):
        for k, v in getattr(fresh.state, g).items():
            assert torch.equal(getattr(sim.state, g)[k], v), (g, k)
    assert sim.ctx.forcings is sim.forcings


# ---------------------------------------------------------------------------
# forcings: `tests/test_forcings.py`'s cases (its `test_vwc_forcing_
# equivalence` waits for SoilHydrology's vwc_forcing, ROADMAP Queue A #3)
# ---------------------------------------------------------------------------
def _solid_heat_model(cells=3, nz=16, k=2.0, c=1.0e6):
    """Porosity-0 solid medium isolating linear conduction
    (`tests/test_forcings.py:16-29`)."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.UniformSpacing(dz=0.25, N=nz),
                            dtype=torch.float64, device="cpu")
    strat = tp.HomogeneousStratigraphy(porosity=tp.ConstantSoilPorosity(mineral_porosity=0.0))
    thermal = tp.SoilThermalProperties(conductivities=tp.SoilThermalConductivities(mineral=k),
                                       heat_capacities=tp.SoilHeatCapacities(mineral=c))
    soil = tp.SoilEnergyWaterCarbon(strat=strat,
                                    energy=tp.SoilEnergyBalance(thermal_properties=thermal))
    return tp.SoilModel(grid=grid, soil=soil), c


def test_heat_source_uniform_analytic():
    """Uniform heating Q with zero-flux ends: T(t) = T0 + Q t / C to 1e-12."""
    model, c = _solid_heat_model()
    Q = 25.0
    sim = tp.initialize(model, tp.ForwardEuler(dt=600.0),
                        initializers={"temperature": 5.0, "saturation_water_ice": 0.0},
                        forcings={"internal_energy": lambda state, grid: Q})
    sim.run(steps=48)
    np.testing.assert_allclose(sim.state.temperature.numpy(), 5.0 + Q * 48 * 600.0 / c,
                               rtol=1e-12)


def test_heat_source_stacks_with_conduction():
    """A forcing adds to the process tendencies: one step with it minus one
    without is Q dt in every layer."""
    model, _ = _solid_heat_model()
    Q = 100.0
    init = {"temperature": lambda x, z: 2.0 + z, "saturation_water_ice": 0.0}
    sim_f = tp.initialize(model, tp.ForwardEuler(dt=300.0), initializers=init,
                          forcings={"internal_energy": lambda s, g: Q})
    sim_0 = tp.initialize(model, tp.ForwardEuler(dt=300.0), initializers=init)
    sim_f.timestep()
    sim_0.timestep()
    dU = (sim_f.state.internal_energy - sim_0.state.internal_energy).numpy()
    np.testing.assert_allclose(dU, Q * 300.0, rtol=1e-12)


def test_xy_forcing_on_surface_pool():
    """A constant source on the XY surface pool of a saturated Richards
    column grows it by rate dt a step."""
    grid = tp.ColumnGrid.of(cells=4, spacing=tp.ExponentialSpacing(N=10), dtype=torch.float64,
                            device="cpu")
    soil = tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq()))
    rate = 1e-6
    sim = tp.initialize(tp.SoilModel(grid=grid, soil=soil), tp.ForwardEuler(dt=60.0),
                        initializers={"temperature": 1.0, "saturation_water_ice": 1.0},
                        forcings={"surface_excess_water": lambda s, g: rate})
    sim.run(steps=10)
    np.testing.assert_allclose(sim.state.surface_excess_water.numpy(), rate * 60.0 * 10,
                               rtol=1e-12)


def test_forcing_unknown_target_raises():
    model, _ = _solid_heat_model()
    with pytest.raises(KeyError, match="not a prognostic"):
        tp.initialize(model, tp.ForwardEuler(),
                      initializers={"temperature": 0.0, "saturation_water_ice": 0.0},
                      forcings={"temperature": lambda s, g: 0.0})


def test_forcing_heun_stages():
    """A forcing is evaluated again in Heun's stage: a time-dependent source
    on an inert prognostic gives the trapezoidal sum of it, to 1e-10."""
    model, _ = _solid_heat_model()
    w = 2 * np.pi / 3600.0
    dt, n = 300.0, 5
    sim = tp.initialize(model, tp.Heun(dt=dt),
                        initializers={"temperature": 0.0, "saturation_water_ice": 0.0},
                        forcings={"internal_energy":
                                  lambda state, grid: 50.0 * torch.sin(w * state.clock.time)})
    sim.run(steps=n)
    t = np.arange(n) * dt
    expect = np.sum(0.5 * dt * 50.0 * (np.sin(w * t) + np.sin(w * (t + dt))))
    np.testing.assert_allclose(sim.state.internal_energy.numpy(), expect, rtol=1e-10)


# ---------------------------------------------------------------------------
# the JAX argument forms and the post-step hook
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stepper", ["ForwardEuler", "Heun", "ImplicitEuler"])
def test_steppers_take_the_jax_argument_forms(stepper):
    """``step(model, state, ctx, input_sources, dt)`` and ``pre_closure_step``
    with positional arguments as JAX's tests call them, against JAX at
    1e-12."""
    jsim, psim = (_bench(m, getattr(m, stepper)(dt=60.0), _top(m)) for m in (tt, tp))
    jstate = jsim.state
    for method in ("step", "pre_closure_step"):
        jstate = getattr(jsim.timestepper, method)(jsim.model, jstate, jsim.ctx, (), 60.0)
        getattr(psim.timestepper, method)(psim.model, psim.state, psim.ctx, (), 60.0)
    assert_fields_close(psim.state, jstate, SOIL_FIELDS)


def test_make_rollout_fn_takes_the_jax_argument_form():
    """`bench_configs.py:289`'s call: ``make_rollout_fn(model, ts, ctx, (),
    steps=..., remat=True)``, value and gradient in the mineral conductivity
    against JAX's at 1e-9."""
    def build(m, k):
        props = m.SoilThermalProperties(conductivities=m.SoilThermalConductivities(mineral=k))
        soil = m.SoilEnergyWaterCarbon(energy=m.SoilEnergyBalance(thermal_properties=props))
        return m.initialize(m.SoilModel(grid=_grid(m, 4, 10), soil=soil), m.ForwardEuler(),
                            initializers={"temperature": -1.0, "saturation_water_ice": 0.8},
                            boundary_conditions=m.PrescribedSurfaceTemperature(4.0))

    import jax

    def jax_loss(k):
        sim = build(tt, k)
        roll = jax_make_rollout_fn(sim.model, sim.timestepper, sim.ctx, (), steps=6, remat=True)
        return jnp.mean(roll(sim.state, 300.0).temperature)

    jv, jg = jax.value_and_grad(jax_loss)(3.8)
    k = torch.tensor(3.8, dtype=torch.float64, requires_grad=True)
    sim = build(tp, k)
    roll = make_rollout_fn(sim.model, sim.timestepper, sim.ctx, (), steps=6, remat=True)
    loss = roll(sim.state, 300.0).temperature.mean()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-12)
    np.testing.assert_allclose(float(k.grad), float(jg), rtol=1e-9)


def test_make_fused_grad_rollout_takes_static_sources():
    """``make_fused_grad_rollout(model_fn, ts, ctx, input_sources, *, steps,
    dt, inner_steps)``: static sources are taken (and leave the value as
    without them); a time-varying one raises, as JAX's does
    (`fused_grad.py:93-97`); forcings raise."""
    sim = _bench(tp, tp.ForwardEuler(dt=60.0), _top(tp))
    static = (tp.FieldInputSource(fields={"unused_input": 1.0}),)
    outs = [make_fused_grad_rollout(lambda p: sim.model, sim.timestepper, sim.ctx, srcs,
                                    steps=4, dt=60.0, inner_steps=2)(sim.state, None)
            for srcs in ((), static)]
    for k in SOIL_FIELDS[:6]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    series = (tp.TimeSeriesInputSource(times=np.array([0.0, 60.0]),
                                       series={"unused_input": np.zeros(2)}),)
    with pytest.raises(ValueError, match="static input sources"):
        make_fused_grad_rollout(lambda p: sim.model, sim.timestepper, sim.ctx, series, steps=4,
                                dt=60.0, inner_steps=2)
    forced = _bench(tp, tp.ForwardEuler(dt=60.0), _top(tp),
                    forcings={"internal_energy": lambda s, g: 1.0})
    with pytest.raises(ValueError, match="forcings"):
        make_fused_grad_rollout(lambda p: forced.model, forced.timestepper, forced.ctx,
                                steps=4, dt=60.0, inner_steps=2)


class _JaxClipped(tt.SoilModel):
    """A post-step hook that holds the pool at or above -1 mm."""

    def timestep(self, state, ctx, dt):
        return state.update(surface_excess_water=jnp.maximum(state.surface_excess_water, -1e-3))


class _PortClipped(tp.SoilModel):
    def timestep(self, state, ctx, dt):
        state.set(surface_excess_water=torch.clamp(state.surface_excess_water, min=-1e-3))


@pytest.mark.parametrize("stepper", ["ForwardEuler", "Heun"])
def test_post_step_hook_runs_where_jax_runs_it(stepper, no_kernel):
    """``model.timestep`` after each explicit update, in Heun's stage too:
    a clip of a draining pool, three steps and a ``run`` (which a subclass
    of SoilModel takes through the modules), at 1e-12 against JAX; without
    the hook the pool ends below the clip."""
    def build(m, cls):
        sim = m.initialize(cls(grid=_grid(m), soil=jax_soil() if m is tt else port_soil()),
                           getattr(m, stepper)(dt=600.0), initializers=CONFIGS["bench"]["inits"],
                           boundary_conditions=_top(m))
        S0 = np.full(6, -0.02)
        if m is tt:
            sim.state = sim.state.update(surface_excess_water=jnp.asarray(S0))
        else:
            sim.state.set(surface_excess_water=torch.as_tensor(S0))
        return sim

    jsim, psim, free = build(tt, _JaxClipped), build(tp, _PortClipped), build(tp, tp.SoilModel)
    for _ in range(3):
        jsim.timestep(600.0)
        psim.timestep(600.0)
    free.timestep(600.0)
    assert float(free.state.surface_excess_water.min()) < -1e-3
    assert float(psim.state.surface_excess_water.min()) == -1e-3
    assert_fields_close(psim.state, jsim.state, SOIL_FIELDS)
    jsim.run(steps=4, dt=600.0)
    psim.run(steps=4, dt=600.0)
    _assert_states_close(psim.state, jsim.state)
