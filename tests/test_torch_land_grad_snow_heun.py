"""The fused gradient of the LandModel with Heun and with a snowpack against
JAX, at float64 on the CPU.

The composition and objective are `tests/test_torch_land_grad.py`'s
(`tests/test_fused_grad.py:270-330`'s: 32 columns, Nz 8, loam, Richards
flow, ``VegetationCarbon.consistent_units()``, the static
``FieldInputSource``, 8 steps in segments of 4, mean(T) +
mean(carbon_vegetation) after the trailing closure), with a snowfall of
1e-8 m/s among the static fields and, under a ``Snowpack``, an initial SWE
of 0.05 m. The cases: Heun at dt 60 s (at 600 s its stage leaves the
physical range, ROADMAP Queue C), and with a snowpack ForwardEuler and Heun
at dt 60 s and ImplicitEuler at dt 600 s, by PCR with one Picard iteration
and by Thomas with two. The gradients are taken in log K_sat, k_mineral,
U0, C0, sat0 and, under a snowpack, SWE0, through the port's
``make_fused_grad_rollout`` (the plain versions of the land kernel and of
its segment VJP on the CPU), JAX's ``make_fused_grad_rollout(bwd="pallas",
interpret=True)`` and JAX's ``make_rollout_fn(remat=True, lean=True)``.
The remat rollout runs under JAX's sequential saturation adjustment
(``ADJUST_IMPL="twopass"``), to which d/d sat0 is held, as in
`tests/test_torch_land_grad.py` (the uniform column's ties, ROADMAP Queue
C); that file holds the sequential form to JAX's default one at rtol 1e-10
on the value and every other gradient, so one remat rollout a case serves
both tests here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu.processes.soil.hydrology as jax_hydrology
import terrarium_tpu_torch as tp
from terrarium_tpu.timesteppers.autodiff import make_rollout_fn as jax_rollout_fn
from terrarium_tpu.timesteppers.fused_grad import make_fused_grad_rollout as jax_fused_grad
from terrarium_tpu_torch.convert import land_model_from, with_differentiable_params
from terrarium_tpu_torch.ops import land_step as ls
from terrarium_tpu_torch.ops import land_vjp as lv
from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout

CELLS, NZ, STEPS, INNER = 32, 8, 8, 4
X0, K0, SWE0 = float(np.log(1e-5)), 3.8, 0.05
INITS = {"temperature": 8.0, "saturation_water_ice": 0.6, "carbon_vegetation": 2.0,
         "vegetation_area_fraction": 0.5}
FIELDS = {"surface_longwave_down": 330.0, "rainfall": 4.0e-8, "windspeed": 3.0,
          "surface_shortwave_down": 300.0, "air_temperature": 10.0,
          "specific_humidity": 0.006, "snowfall": 1.0e-8}
#: case -> (stepper, solver, Picard iterations, snowpack, dt)
CASES = {"heun": ("heun", None, 1, False, 60.0),
         "euler-snow": ("euler", None, 1, True, 60.0),
         "implicit-pcr-snow": ("implicit", "pcr", 1, True, 600.0),
         "heun-snow": ("heun", None, 1, True, 60.0),
         "implicit-thomas-2-snow": ("implicit", "thomas", 2, True, 600.0)}
#: the initial fields the gradients are taken in, by case
LEAVES = ("internal_energy", "carbon_vegetation", "saturation_water_ice")


def _leaves(case):
    return LEAVES + (("snow_water_equivalent",) if CASES[case][3] else ())


def _stepper(m, case):
    stepper, solver, iters, _, dt = CASES[case]
    if stepper == "implicit":
        return m.ImplicitEuler(dt=dt, solver=solver, picard_iters=iters)
    return m.Heun(dt=dt) if stepper == "heun" else m.ForwardEuler(dt=dt)


def _inits(case):
    return {**INITS, "snow_water_equivalent": SWE0} if CASES[case][3] else INITS


def _jax_model(grid, case, log_ksat, k_mineral):
    thermal = tt.SoilThermalProperties(
        conductivities=tt.SoilThermalConductivities(mineral=k_mineral))
    soil = tt.SoilEnergyWaterCarbon(
        strat=tt.HomogeneousStratigraphy(texture=tt.SoilTexture.preset("loam")),
        energy=tt.SoilEnergyBalance(thermal_properties=thermal),
        hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq(),
                                   hydraulic_properties=tt.SoilHydraulicsSURFEX(
                                       sat_hydraulic_cond=jnp.exp(log_ksat))))
    return tt.LandModel(grid=grid, vegetation=tt.VegetationCarbon.consistent_units(), soil=soil,
                        snow=tt.Snowpack() if CASES[case][3] else None)


def _port_model(grid, case, log_ksat, k_mineral):
    soil = tp.SoilEnergyWaterCarbon(
        strat=tp.HomogeneousStratigraphy(texture=tp.SoilTexture.preset("loam")),
        hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq()))
    soil = with_differentiable_params(soil, log_sat_hydraulic_cond=log_ksat,
                                      mineral_conductivity=k_mineral)
    return tp.LandModel(grid=grid, vegetation=tp.VegetationCarbon.consistent_units(), soil=soil,
                        snow=tp.Snowpack() if CASES[case][3] else None)


def _port_sim(case):
    grid = tp.ColumnGrid.of(cells=CELLS, spacing=tp.ExponentialSpacing(N=NZ),
                            dtype=torch.float64, device="cpu")
    return tp.initialize(_port_model(grid, case, X0, K0), _stepper(tp, case),
                         initializers=_inits(case),
                         input_sources=(tp.FieldInputSource(fields=FIELDS),))


def _objective(out, m):
    return m.mean(out.temperature) + m.mean(out.prognostic["carbon_vegetation"])


def _port_grads(case):
    """The objective and its gradients in (log K_sat, k_mineral, *leaves)
    through the port's fused gradient rollout."""
    sim = _port_sim(case)
    grid = sim.model.grid
    x = torch.tensor(X0, dtype=torch.float64, requires_grad=True)
    k = torch.tensor(K0, dtype=torch.float64, requires_grad=True)
    state = sim.state.copy()
    leaves = {n: state[n].clone().requires_grad_() for n in _leaves(case)}
    state.set(**leaves)
    roll = make_fused_grad_rollout(lambda p: _port_model(grid, case, *p), sim.timestepper,
                                   sim.ctx, sim.input_sources, steps=STEPS,
                                   dt=CASES[case][4], inner_steps=INNER)
    loss = _objective(roll(state, (x, k)), torch)
    gs = torch.autograd.grad(loss, (x, k, *leaves.values()))
    return (float(loss.detach()), *(g.numpy() for g in gs))


def _jax_grads(case, route):
    """``(value, *gradients)`` of JAX's route for a case."""
    grid = tt.ColumnGrid.of(cells=CELLS, spacing=tt.ExponentialSpacing(N=NZ),
                            nf=np.float64)
    ts, dt = _stepper(tt, case), CASES[case][4]
    sim = tt.initialize(_jax_model(grid, case, X0, K0), ts, initializers=_inits(case),
                        input_sources=(tt.FieldInputSource(fields=FIELDS),))
    names = _leaves(case)

    def loss(x, k, *fields):
        st = sim.state.update(**dict(zip(names, fields)))
        if route == "pallas":
            roll = jax_fused_grad(lambda p: _jax_model(grid, case, *p), ts, sim.ctx,
                                  sim.input_sources, steps=STEPS, dt=dt, inner_steps=INNER,
                                  block_cells=CELLS, xy_rank2=True, interpret=True,
                                  bwd="pallas")
            out = roll(st, (x, k))
        else:
            roll = jax_rollout_fn(_jax_model(grid, case, x, k), ts, sim.ctx,
                                  sim.input_sources, steps=STEPS, remat=True, lean=True)
            out = roll(st, dt)
        return _objective(out, jnp)

    fields = [sim.state.saturation_water_ice if n == "saturation_water_ice"
              else sim.state.prognostic[n] for n in names]
    v, g = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(2 + len(names)))))(
        X0, K0, *fields)
    return (float(v), *(np.asarray(a) for a in g))


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's ``(value, *gradients)`` per case and route, computed when a
    test first asks: the Pallas VJP under JAX's default saturation
    adjustment, the remat rollout under its sequential one
    (``"twopass"``)."""
    cache = {}

    def ref(case, route):
        if (case, route) not in cache:
            adjust = "fused" if route == "pallas" else "twopass"
            default, jax_hydrology.ADJUST_IMPL = jax_hydrology.ADJUST_IMPL, adjust
            try:
                cache[case, route] = _jax_grads(case, route)
            finally:
                jax_hydrology.ADJUST_IMPL = default
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


def _held(got, ref, rtol):
    """Each per-cell gradient within ``rtol`` with a floor of ``rtol`` of
    its largest magnitude, which is not 0."""
    assert np.max(np.abs(ref)) > 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.max(np.abs(ref)))


@pytest.mark.parametrize("route", ["pallas", "remat"])
@pytest.mark.parametrize("case", CASES)
def test_land_fused_grad_matches_jax(jax_ref, port_ref, case, route):
    """The value within rtol 1e-10; d/d log K_sat and d/d k_mineral within
    rtol 1e-8 and non-zero; d/dU0, d/dC0 and, under a snowpack, d/dSWE0 per
    cell within rtol 1e-8 with a floor of 1e-8 of each one's largest
    magnitude, of JAX's Pallas segment VJP (interpret mode) and of its remat
    rollout (sequential adjustment)."""
    v, gx, gk, gU, gC, _, *gswe = port_ref(case)
    jv, jgx, jgk, jgU, jgC, _, *jgswe = jax_ref(case, route)
    np.testing.assert_allclose(v, jv, rtol=1e-10)
    for a, b in ((gx, jgx), (gk, jgk)):
        assert abs(float(a)) > 0.0
        np.testing.assert_allclose(a, b, rtol=1e-8)
    for a, b in ((gU, jgU), (gC, jgC), *zip(gswe, jgswe)):
        _held(a, b, 1e-8)
    assert len(gswe) == len(jgswe) == int(CASES[case][3])


@pytest.mark.parametrize("case", CASES)
def test_land_sat0_grad_matches_jax_sequential_adjustment(jax_ref, port_ref, case):
    """d/d sat0 per cell within rtol 1e-8 (with a floor of 1e-8 of its
    largest magnitude) of JAX's remat rollout under its sequential
    saturation adjustment; its value within rtol 1e-10 of the Pallas VJP's
    under the default one."""
    seq = jax_ref(case, "remat")
    np.testing.assert_allclose(seq[0], jax_ref(case, "pallas")[0], rtol=1e-10)
    _held(port_ref(case)[5], seq[5], 1e-8)


def test_land_fused_grad_runs_heun_and_the_snowpack(monkeypatch):
    """Heun with a snowpack runs the land segments: 2 segments, 2 VJP calls
    with the Heun stepper and the snowpack's tags, and a finite non-zero
    gradient in SWE0."""
    calls = []
    real = lv.land_column_segment_vjp

    def spy(*a, **kw):
        calls.append((kw["stepper"], "snow" in a[7].tags, a[10]))
        return real(*a, **kw)

    import terrarium_tpu_torch.timesteppers.fused_grad as fg
    monkeypatch.setattr(fg, "land_column_segment_vjp", spy)
    sim = _port_sim("heun-snow")
    state = sim.state.copy()
    swe0 = state["snow_water_equivalent"].clone().requires_grad_()
    state.set(snow_water_equivalent=swe0)
    roll = make_fused_grad_rollout(lambda p: sim.model, sim.timestepper, sim.ctx,
                                   sim.input_sources, steps=STEPS, dt=60.0, inner_steps=INNER)
    out = roll(state, None)
    assert out.clock.iteration == STEPS
    (g,) = torch.autograd.grad(_objective(out, torch), swe0)
    assert calls == [("heun", True, INNER)] * 2
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0


def test_land_model_from_carries_the_snowpack():
    """``convert.land_model_from`` rebuilds the JAX model of the snowpack
    cases: the same kernel tags and parameters as the port's own model."""
    grid = tp.ColumnGrid.of(cells=CELLS, spacing=tp.ExponentialSpacing(N=NZ),
                            dtype=torch.float64, device="cpu")
    jgrid = tt.ColumnGrid.of(cells=CELLS, spacing=tt.ExponentialSpacing(N=NZ), nf=np.float64)
    jax_model = _jax_model(jgrid, "heun-snow", X0, K0)
    hyd = jax_model.soil.hydrology
    jax_model = dataclasses.replace(jax_model, soil=dataclasses.replace(
        jax_model.soil, hydrology=dataclasses.replace(hyd, hydraulic_properties=(
            dataclasses.replace(hyd.hydraulic_properties, sat_hydraulic_cond=float(np.exp(X0)))))))
    got = ls.LandParams.of(land_model_from(jax_model, grid), torch.float64)
    ref = ls.LandParams.of(_port_model(grid, "heun-snow", X0, K0), torch.float64)
    assert got.tags == ref.tags and got.tags[-1] == "snow"
    assert got.values.keys() == ref.values.keys()
    for n, v in ref.values.items():
        assert np.isclose(float(got.values[n]), float(v), rtol=1e-12, atol=0.0), n
    assert dataclasses.asdict(got.soil) == dataclasses.asdict(ref.soil)
