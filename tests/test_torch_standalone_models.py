"""The port's standalone ``VegetationModel`` and ``SurfaceEnergyModel``
against the JAX package's (`terrarium_tpu/models/vegetation_model.py`):
`tests/test_vegetation.py:67-90` and `tests/test_surface_energy.py:24-118`
reproduced through the port, each held to JAX's own run of the same
configuration at float64 1e-12 (relative, with a floor of 1e-12 of the
field's magnitude). Neither model has a column kernel: ``run`` steps both
through the process modules, as JAX's ``run`` does.
"""
import math

import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu_torch.timesteppers import integrator

from torch_parity import assert_fields_close


def _grid(m, cells, nz):
    if m is tt:
        return tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=nz), nf=np.float64)
    return tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz),
                            dtype=torch.float64, device="cpu")


VEG_FIELDS = ("carbon_vegetation", "vegetation_area_fraction", "net_assimilation",
              "gross_primary_production", "net_primary_production", "canopy_water_conductance",
              "leaf_area_index")


def test_vegetation_model_run_matches_jax():
    """`tests/test_vegetation.py:67-90`: 48 steps of 1800 s under warm, sunny
    air integrate the carbon and the vegetation fraction finitely and the
    carbon grows; every field equals JAX's run."""
    def make(m):
        return m.initialize(m.VegetationModel(grid=_grid(m, 3, 8)), m.ForwardEuler(),
                            initializers={"carbon_vegetation": 2.0,
                                          "vegetation_area_fraction": 0.5},
                            input_sources=(m.FieldInputSource(fields={
                                "air_temperature": 22.0, "surface_shortwave_down": 500.0}),))

    jsim, psim = make(tt), make(tp)
    assert integrator.column_scheme(psim.model, psim.timestepper, psim.ctx,
                                    psim.input_sources) is None
    assert [v.name for v in psim.model.variables()] == [v.name for v in jsim.model.variables()]
    C0 = float(psim.state.carbon_vegetation[0])
    jsim.run(steps=48, dt=1800.0)
    psim.run(steps=48, dt=1800.0)
    st = psim.state
    for name in VEG_FIELDS:
        assert bool(torch.isfinite(st[name]).all()), name
    assert float(st.gross_primary_production[0]) > 0
    assert float(st.carbon_vegetation[0]) > C0
    assert bool((st.leaf_area_index > 0).all())
    assert float(st.soil_moisture_limiting_factor[0]) == 1.0
    assert_fields_close(st, jsim.state, VEG_FIELDS)


def test_surface_energy_model_atmosphere_accessors():
    """`tests/test_surface_energy.py:24-38`: the default atmosphere's
    inputs, r_a = 1 / (C_h V) and the clamped VPD."""
    model = tp.SurfaceEnergyModel(grid=_grid(tp, 2, 5))
    sim = tp.initialize(model, tp.ForwardEuler())
    atmos, st = model.atmosphere, sim.state
    np.testing.assert_allclose(atmos.air_temperature(st).numpy(), 10.0)
    np.testing.assert_allclose(atmos.air_pressure(st).numpy(), 101325.0)
    np.testing.assert_allclose(atmos.windspeed(st).numpy(), 0.1)
    np.testing.assert_allclose(atmos.aerodynamic_resistance(st, model.constants).numpy(),
                               1.0 / (1.2e-3 * 0.1))
    assert bool((atmos.compute_vpd(st, model.constants) >= 0.1).all())


SEB_FIELDS = ("skin_temperature", "ground_heat_flux", "surface_net_radiation",
              "surface_shortwave_up", "surface_longwave_up", "sensible_heat_flux",
              "latent_heat_flux")


def test_surface_energy_model_diagnosed_fluxes():
    """`tests/test_surface_energy.py:41-61`: one step; SW_up = alpha SW,
    LW_up = eps sigma T^4 + (1 - eps) LW, and the reference form's residual
    R_net - H_s - H_l - G closes; every SEB field equals JAX's."""
    def make(m):
        return m.initialize(m.SurfaceEnergyModel(grid=_grid(m, 2, 5)), m.ForwardEuler(),
                            initializers={"ground_temperature": 12.0, "skin_temperature": 12.0},
                            input_sources=(m.FieldInputSource(fields={
                                "surface_shortwave_down": 500.0,
                                "surface_longwave_down": 300.0}),))

    jsim, psim = make(tt), make(tp)
    jsim.timestep(300.0)
    psim.timestep(300.0)
    st = psim.state
    np.testing.assert_allclose(st.surface_shortwave_up.numpy(), 0.3 * 500.0)
    Ts = st.skin_temperature.numpy()
    np.testing.assert_allclose(st.surface_longwave_up.numpy(),
                               0.97 * 5.6704e-8 * (Ts + 273.15) ** 4 + 0.03 * 300.0, rtol=1e-10)
    resid = (st.surface_net_radiation - st.sensible_heat_flux - st.latent_heat_flux
             - st.ground_heat_flux).numpy()
    np.testing.assert_allclose(resid, 0.0, atol=1e-9)
    assert_fields_close(st, jsim.state, SEB_FIELDS)


def test_surface_energy_model_monin_obukhov_drag():
    """`tests/test_surface_energy.py:64-88`: the Monin-Obukhov drag exceeds
    the neutral log drag in unstable air and falls below it in stable air;
    each equals JAX's."""
    def drags(m):
        mo = m.MoninObukhovAerodynamics()
        atmos = m.PrescribedAtmosphere(aerodynamics=mo)
        model = m.SurfaceEnergyModel(grid=_grid(m, 1, 5), atmosphere=atmos)
        sim = m.initialize(model, m.ForwardEuler(),
                           input_sources=(m.FieldInputSource(fields={"windspeed": 2.0}),))
        out = []
        for Ts in (30.0, -10.0):
            if m is tt:
                import jax.numpy as jnp
                st = sim.state.update(skin_temperature=jnp.full(1, Ts),
                                      air_temperature=jnp.full(1, 10.0))
            else:
                st = sim.state.copy()
                st.set(skin_temperature=torch.full((1,), Ts, dtype=torch.float64),
                       air_temperature=torch.full((1,), 10.0, dtype=torch.float64))
            out.append(float(np.asarray(mo.drag_coefficient(st, atmos, model.constants))
                             .ravel()[0]))
        return mo, model.constants, out

    mo, c, (Ch_u, Ch_s) = drags(tp)
    _, _, (jCh_u, jCh_s) = drags(tt)
    neutral = c.kappa ** 2 / (math.log(mo.z / mo.z0m) * math.log(mo.z / mo.z0h))
    assert Ch_u > neutral > Ch_s > 0 and math.isfinite(Ch_u)
    np.testing.assert_allclose([Ch_u, Ch_s], [jCh_u, jCh_s], rtol=1e-12)


@pytest.mark.parametrize("form", ["consistent", "reference"])
def test_surface_energy_model_ground_flux_form_sign(form):
    """`tests/test_surface_energy.py:91-118`: under the consistent form
    drier air (more evaporation) lets less energy into the ground, under
    the reference form more; each G equals JAX's."""
    def ground_flux(m, q_air):
        model = m.SurfaceEnergyModel(grid=_grid(m, 1, 5),
                                     surface_energy_balance=m.SurfaceEnergyBalance(
                                         ground_flux_form=form))
        sim = m.initialize(model, m.ForwardEuler(),
                           initializers={"ground_temperature": 15.0, "skin_temperature": 15.0},
                           input_sources=(m.FieldInputSource(fields={
                               "surface_shortwave_down": 600.0, "windspeed": 3.0,
                               "specific_humidity": q_air}),))
        sim.timestep(300.0)
        return float(np.asarray(sim.state.ground_heat_flux)[0])

    G_moist, G_dry = ground_flux(tp, 8.0e-3), ground_flux(tp, 1.0e-4)
    assert ((-G_dry) < (-G_moist)) == (form == "consistent")
    np.testing.assert_allclose([G_moist, G_dry], [ground_flux(tt, 8.0e-3), ground_flux(tt, 1.0e-4)],
                               rtol=1e-12)
