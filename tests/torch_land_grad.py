"""The fused gradient of the LandModel against JAX, at float64 on the CPU:
the cases, both packages' gradients and the checks that
`tests/test_torch_land_grad*.py` run, one file a stepper so that the
cases spread over the test workers.

The composition is `tests/test_fused_grad.py:270-330`'s
(`test_fused_grad_coupled_land_model_xy_rank2`): 32 columns, Nz 8, loam,
Richards flow, ``VegetationCarbon.consistent_units()``, the static
``FieldInputSource`` with its six values, initial temperature 8 degC,
saturation 0.6, carbon 2 and vegetation fraction 0.5, 8 steps in segments of
4, the objective mean(T) + mean(carbon_vegetation) after the trailing
closure. It runs with ForwardEuler at dt 600 s (JAX's case), with
ImplicitEuler at dt 600 s (PCR, Thomas; one Picard iteration, and PCR
with two and Thomas with three), and with ForwardEuler under Monin-Obukhov
drag. The gradients are taken in log K_sat, k_mineral, U0,
C0 and sat0. The same numbers go through the port's
``make_fused_grad_rollout`` (the plain versions of the land kernel and of
its segment VJP on the CPU), JAX's ``make_fused_grad_rollout(bwd="pallas",
interpret=True)`` (its Pallas segment VJP traced over the LandModel step)
and JAX's ``make_rollout_fn(remat=True, lean=True)``.

Every initial saturation is 0.6, a uniform column. There JAX's default
closed-form saturation adjustment (``ADJUST_IMPL="fused"``, a doubling
prefix sum and minimum) splits ties that the sequential sweeps do not take
as ties, so its d/d sat0 parts from the port's by up to 1e-2 of its
magnitude (ROADMAP Queue C), while JAX's own sequential form
(``ADJUST_IMPL="twopass"``) and the port agree to rounding: d/d sat0 is held
to that form, every other number to JAX's default one.
"""
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
from terrarium_tpu_torch.convert import with_differentiable_params
from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout

CELLS, NZ, STEPS, INNER, DT = 32, 8, 8, 4, 600.0
X0, K0 = float(np.log(1e-5)), 3.8
INITS = {"temperature": 8.0, "saturation_water_ice": 0.6, "carbon_vegetation": 2.0,
         "vegetation_area_fraction": 0.5}
FIELDS = {"surface_longwave_down": 330.0, "rainfall": 4.0e-8, "windspeed": 3.0,
          "surface_shortwave_down": 300.0, "air_temperature": 10.0,
          "specific_humidity": 0.006}
#: case -> (stepper, solver, Monin-Obukhov drag)
CASES = {"euler": ("euler", None, False), "implicit-pcr": ("implicit", "pcr", False),
         "implicit-thomas": ("implicit", "thomas", False), "euler-mo": ("euler", None, True),
         "implicit-pcr-2": ("implicit", "pcr", False),
         "implicit-thomas-3": ("implicit", "thomas", False)}
#: the Picard count of each ImplicitEuler case (1 where not given)
PICARD = {"implicit-pcr-2": 2, "implicit-thomas-3": 3}


def _stepper(m, case, **kw):
    stepper, solver, _ = CASES[case]
    if stepper == "implicit":
        return m.ImplicitEuler(dt=DT, solver=solver, picard_iters=PICARD.get(case, 1), **kw)
    return m.ForwardEuler(dt=DT)


def _jax_model(grid, case, log_ksat, k_mineral):
    thermal = tt.SoilThermalProperties(
        conductivities=tt.SoilThermalConductivities(mineral=k_mineral))
    soil = tt.SoilEnergyWaterCarbon(
        strat=tt.HomogeneousStratigraphy(texture=tt.SoilTexture.preset("loam")),
        energy=tt.SoilEnergyBalance(thermal_properties=thermal),
        hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq(),
                                   hydraulic_properties=tt.SoilHydraulicsSURFEX(
                                       sat_hydraulic_cond=jnp.exp(log_ksat))))
    kw = {}
    if CASES[case][2]:
        kw["atmosphere"] = tt.PrescribedAtmosphere(aerodynamics=tt.MoninObukhovAerodynamics())
    return tt.LandModel(grid=grid, vegetation=tt.VegetationCarbon.consistent_units(), soil=soil,
                        **kw)


def _port_model(grid, case, log_ksat, k_mineral):
    soil = tp.SoilEnergyWaterCarbon(
        strat=tp.HomogeneousStratigraphy(texture=tp.SoilTexture.preset("loam")),
        hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq()))
    soil = with_differentiable_params(soil, log_sat_hydraulic_cond=log_ksat,
                                      mineral_conductivity=k_mineral)
    kw = {}
    if CASES[case][2]:
        kw["atmosphere"] = tp.PrescribedAtmosphere(aerodynamics=tp.MoninObukhovAerodynamics())
    return tp.LandModel(grid=grid, vegetation=tp.VegetationCarbon.consistent_units(), soil=soil,
                        **kw)


def _port_sim(case, **kw):
    grid = tp.ColumnGrid.of(cells=CELLS, spacing=tp.ExponentialSpacing(N=NZ),
                            dtype=torch.float64, device="cpu")
    return tp.initialize(_port_model(grid, case, X0, K0), _stepper(tp, case, **kw),
                         initializers=INITS, input_sources=(tp.FieldInputSource(fields=FIELDS),))


def _objective(out, m):
    return m.mean(out.temperature) + m.mean(out.prognostic["carbon_vegetation"])


def _port_grads(case):
    """The objective and its gradients in (log K_sat, k_mineral, U0, C0,
    sat0) through the port's fused gradient rollout."""
    sim = _port_sim(case)
    grid = sim.model.grid
    x = torch.tensor(X0, dtype=torch.float64, requires_grad=True)
    k = torch.tensor(K0, dtype=torch.float64, requires_grad=True)
    state = sim.state.copy()
    leaves = {n: state[n].clone().requires_grad_()
              for n in ("internal_energy", "carbon_vegetation", "saturation_water_ice")}
    state.set(**leaves)
    roll = make_fused_grad_rollout(lambda p: _port_model(grid, case, *p), sim.timestepper,
                                   sim.ctx, sim.input_sources, steps=STEPS, dt=DT,
                                   inner_steps=INNER)
    loss = _objective(roll(state, (x, k)), torch)
    gs = torch.autograd.grad(loss, (x, k, *leaves.values()))
    return (float(loss.detach()), *(g.numpy() for g in gs))


@pytest.fixture(scope="module")
def jax_ref():
    """``jax.value_and_grad`` in (log K_sat, k_mineral, U0, C0, sat0) of
    JAX's Pallas-VJP fused rollout and of its remat rollout, per case, with
    JAX's saturation adjustment ``adjust`` (its default ``"fused"`` closed
    form or the sequential ``"twopass"``), computed when a test first
    asks."""
    cache = {}

    def ref(case, route, adjust="fused"):
        if (case, route, adjust) in cache:
            return cache[case, route, adjust]
        default, jax_hydrology.ADJUST_IMPL = jax_hydrology.ADJUST_IMPL, adjust
        try:
            cache[case, route, adjust] = _jax_grads(case, route)
        finally:
            jax_hydrology.ADJUST_IMPL = default
        return cache[case, route, adjust]

    return ref


def _jax_grads(case, route):
    """``(value, *gradients)`` of JAX's route for a case."""
    grid = tt.ColumnGrid.of(cells=CELLS, spacing=tt.ExponentialSpacing(N=NZ),
                            nf=np.float64)
    ts = _stepper(tt, case)
    sim = tt.initialize(_jax_model(grid, case, X0, K0), ts, initializers=INITS,
                        input_sources=(tt.FieldInputSource(fields=FIELDS),))

    def loss(x, k, u0, c0, s0):
        st = sim.state.update(internal_energy=u0, carbon_vegetation=c0,
                              saturation_water_ice=s0)
        if route == "pallas":
            roll = jax_fused_grad(lambda p: _jax_model(grid, case, *p), ts, sim.ctx,
                                  sim.input_sources, steps=STEPS, dt=DT, inner_steps=INNER,
                                  block_cells=CELLS, xy_rank2=True, interpret=True,
                                  bwd="pallas")
            out = roll(st, (x, k))
        else:
            roll = jax_rollout_fn(_jax_model(grid, case, x, k), ts, sim.ctx,
                                  sim.input_sources, steps=STEPS, remat=True, lean=True)
            out = roll(st, DT)
        return _objective(out, jnp)

    st = sim.state
    v, g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4)))(
        X0, K0, st.prognostic["internal_energy"], st.prognostic["carbon_vegetation"],
        st.saturation_water_ice)
    return (float(v), *(np.asarray(a) for a in g))


@pytest.fixture(scope="module")
def port_ref():
    cache = {}

    def ref(case):
        if case not in cache:
            cache[case] = _port_grads(case)
        return cache[case]

    return ref


def check_fused_grad(jax_ref, port_ref, case, route):
    """The value within rtol 1e-10; d/d log K_sat and d/d k_mineral within
    rtol 1e-8 and non-zero; d/dU0 and d/dC0 per cell within rtol 1e-8, with
    a floor of 1e-8 of each one's largest magnitude, of JAX's Pallas segment
    VJP (interpret mode) and of its remat rollout."""
    v, gx, gk, gU, gC, _ = port_ref(case)
    jv, jgx, jgk, jgU, jgC, _ = jax_ref(case, route)
    np.testing.assert_allclose(v, jv, rtol=1e-10)
    for a, b in ((gx, jgx), (gk, jgk)):
        assert abs(float(a)) > 0.0
        np.testing.assert_allclose(a, b, rtol=1e-8)
    for a, b in ((gU, jgU), (gC, jgC)):
        assert np.max(np.abs(b)) > 0.0
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8 * np.max(np.abs(b)))


def check_sat0_grad(jax_ref, port_ref, case):
    """d/d sat0 per cell within rtol 1e-8 (with a floor of 1e-8 of its
    largest magnitude) of JAX's remat rollout under its sequential
    saturation adjustment, whose value and other gradients equal its
    default closed form's to rtol 1e-10; the default form's d/d sat0 parts
    from both at the uniform column's ties (ROADMAP Queue C)."""
    got = port_ref(case)[5]
    seq, fused = jax_ref(case, "remat", "twopass"), jax_ref(case, "remat")
    np.testing.assert_allclose(seq[0], fused[0], rtol=1e-10)
    for a, b in zip(seq[1:5], fused[1:5]):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10 * np.max(np.abs(b)))
    ref = seq[5]
    scale = np.max(np.abs(ref))
    assert scale > 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-8 * scale)
    assert 1e-6 * scale < np.max(np.abs(fused[5] - ref)) < 2e-2 * scale
