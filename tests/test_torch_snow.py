"""The port's snowpack against the JAX package's (`terrarium_tpu/processes/
snow.py`): ``Snowpack``, ``SnowCoverAlbedo`` and the snow-aware runoff on
identical numbers at float64, the LandModel's conditional albedo default,
the converter, `tests/test_snow.py`'s four cases, `test_snow_ddm_pins`
(`tests/test_parity_pins_veg.py:209`) and the ``land_snow`` golden.

Module tests start both packages from one state, as `test_torch_land.py`
does: the JAX model's state with ``torch_parity.land_random_state``'s
fields (SWE negative, empty and deep; snowfall on and off), closed and its
auxiliaries computed by JAX, then carried over leaf for leaf. rtol 1e-12
with a floor of 1e-12 of the field's magnitude unless a test states
otherwise.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu_torch.convert import land_model_from, state_from_numpy
from terrarium_tpu_torch.ops import land_step as ls
from terrarium_tpu_torch.timesteppers import integrator

from torch_parity import assert_fields_close, jax_state_arrays, land_model, land_random_state

CELLS, NZ = 48, 8
SNOW_FIELDS = ("snow_cover_fraction", "snow_melt")


def _grids(cells=CELLS, nz=NZ):
    return (tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=nz), nf=np.float64),
            tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz),
                             dtype=torch.float64, device="cpu"))


def _both(composition, seed):
    """(jax model, jax state, port model, port state, jax ctx, port ctx) on
    identical numbers (`test_torch_land.py::_both`)."""
    jg, pg = _grids()
    jm, pm = land_model(tt, jg, composition), land_model(tp, pg, composition)
    jsim = tt.initialize(jm, tt.ForwardEuler(dt=600.0),
                         initializers={"temperature": 5.0, "saturation_water_ice": 0.6})
    js = jsim.state
    fields = land_random_state(seed, CELLS, NZ)
    js = js.update({k: jnp.asarray(v) for k, v in fields.items() if k in js})
    js = jm.closure(js, jsim.ctx)
    js = jm.compute_auxiliary(js, jsim.ctx)
    ps = state_from_numpy(jax_state_arrays(js), 0.0, 0, pm.grid)
    return jm, js, pm, ps, jsim.ctx, pm.make_context()


def _same(pstate, jstate, names):
    assert_fields_close(pstate, jstate, [n for n in names if n in jstate])


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("composition", ["snow", "consistent_snow"])
def test_snowpack_module_matches_jax(composition, seed):
    """``Snowpack.compute_auxiliary`` (cover fraction, melt gated on SWE >
    0), ``compute_tendencies`` (snowfall - melt) and ``timestep`` (the clip
    SWE >= 0) from the random states, whose packs are negative, empty and
    deep under cold and warm air."""
    jm, js, pm, ps, jctx, pctx = _both(composition, seed)
    js = jm.snow.compute_auxiliary(js, jm.grid, jm.atmosphere, jctx)
    pm.snow.compute_auxiliary(ps, pm.grid, pm.atmosphere, pctx)
    _same(ps, js, SNOW_FIELDS)
    js = jm.snow.compute_tendencies(js, jm.grid, jm.atmosphere, jctx)
    pm.snow.compute_tendencies(ps, pm.grid, pm.atmosphere, pctx)
    np.testing.assert_allclose(ps.tendencies["snow_water_equivalent"].numpy(),
                               np.asarray(js.tendencies["snow_water_equivalent"]), rtol=1e-12)
    js = jm.snow.timestep(js, jm.grid, jm.atmosphere, jctx, 600.0)
    pm.snow.timestep(ps, pm.grid, pm.atmosphere, pctx, 600.0)
    _same(ps, js, ["snow_water_equivalent"])
    swe0 = land_random_state(seed, CELLS, NZ)["snow_water_equivalent"]
    melt = np.asarray(js.snow_melt)
    assert (swe0 < 0).any() and (swe0 == 0).any() and (melt > 0).any() and (melt == 0).any()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("composition", ["snow", "consistent_snow"])
def test_snow_cover_albedo_and_seb_match_jax(composition, seed):
    """``SnowCoverAlbedo`` blends albedo and emissivity by the cover, and
    the SEB's fused flux update reads them through it, in both ground-flux
    forms."""
    jm, js, pm, ps, _, _ = _both(composition, seed)
    ja, pa = jm.surface_energy_balance.albedo, pm.surface_energy_balance.albedo
    assert type(ja) is tt.SnowCoverAlbedo and type(pa) is tp.SnowCoverAlbedo
    for fn in ("albedo", "emissivity"):
        np.testing.assert_allclose(getattr(pa, fn)(ps).numpy(), np.asarray(getattr(ja, fn)(js)),
                                   rtol=1e-12, err_msg=fn)
    js = jm.surface_energy_balance.compute_surface_energy_fluxes(
        js, jm.grid, jm.constants, jm.atmosphere, jm.surface_hydrology.evapotranspiration)
    pm.surface_energy_balance.compute_surface_energy_fluxes(
        ps, pm.grid, pm.constants, pm.atmosphere, pm.surface_hydrology.evapotranspiration)
    _same(ps, js, ["skin_temperature", "ground_heat_flux", "surface_net_radiation",
                   "surface_shortwave_up", "surface_longwave_up", "sensible_heat_flux",
                   "latent_heat_flux"])
    f = np.asarray(js.snow_cover_fraction)
    assert (f == 0).any() and (f > 0.8).any()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("composition", ["snow", "consistent_snow"])
def test_runoff_takes_the_melt_as_jax_does(composition, seed):
    """``DirectSurfaceRunoff`` partitions the ground rain plus the melt into
    infiltration and runoff; the melt enters where the pool is empty."""
    jm, js, pm, ps, jctx, pctx = _both(composition, seed)
    sh_j, sh_p = jm.surface_hydrology, pm.surface_hydrology
    js = sh_j.surface_runoff.compute_auxiliary(js, jm.grid, sh_j.canopy_interception, jm.soil,
                                               jctx)
    sh_p.surface_runoff.compute_auxiliary(ps, pm.grid, sh_p.canopy_interception, pm.soil, pctx)
    _same(ps, js, ["infiltration", "surface_runoff"])
    rain = np.asarray(js.rainfall_ground) + np.asarray(js.snow_melt)
    S = np.asarray(js.surface_excess_water)
    drained = np.where(S > 0, np.maximum(S, 0) / sh_j.surface_runoff.tau_r, 0.0)
    np.testing.assert_allclose(rain + drained, np.asarray(js.infiltration)
                               + np.asarray(js.surface_runoff), rtol=1e-12, atol=1e-20)
    assert (np.asarray(js.snow_melt)[S <= 0] > 0).any()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("composition", ["snow", "consistent_snow"])
def test_land_model_with_snow_matches_jax(composition, seed):
    """The whole model's auxiliaries, in JAX's order (the snowpack after the
    atmosphere, before the soil), and its tendencies (the snowpack last)."""
    jm, js, pm, ps, jctx, pctx = _both(composition, seed)
    assert [v.name for v in pm.variables()] == [v.name for v in jm.variables()]
    js = jm.compute_auxiliary(js, jctx)
    pm.compute_auxiliary(ps, pctx)
    js = jm.compute_tendencies(js, jctx)
    pm.compute_tendencies(ps, pctx)
    _same(ps, js, sorted(ps.auxiliary))
    for name in ps.tendencies:
        a, b = np.asarray(js.tendencies[name]), ps.tendencies[name].numpy()
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * max(np.max(np.abs(a)), 1e-300),
                                   err_msg=name)
    assert "snow_water_equivalent" in pm.live_carry


def test_conditional_albedo_default_and_custom_albedo():
    """A snowpack over the default ``ConstantAlbedo`` installs
    ``SnowCoverAlbedo`` over it (`land_model.py:69-83`); a custom base is
    kept, and a model without snow keeps ``ConstantAlbedo``."""
    _, pg = _grids(4, 8)
    m = tp.LandModel(grid=pg, snow=tp.Snowpack())
    assert m.surface_energy_balance.albedo == tp.SnowCoverAlbedo(base=tp.ConstantAlbedo())
    base = tp.ConstantAlbedo(albedo_value=0.2)
    m = tp.LandModel(grid=pg, snow=tp.Snowpack(),
                     surface_energy_balance=tp.SurfaceEnergyBalance(albedo=base))
    assert m.surface_energy_balance.albedo == tp.SnowCoverAlbedo(base=base)
    seb = tp.SurfaceEnergyBalance(albedo=tp.PrescribedAlbedo())
    assert tp.LandModel(grid=pg, snow=tp.Snowpack(),
                        surface_energy_balance=seb).surface_energy_balance.albedo is seb.albedo
    assert type(tp.LandModel(grid=pg).surface_energy_balance.albedo) is tp.ConstantAlbedo


@pytest.mark.parametrize("composition", ["snow", "consistent_snow"])
def test_land_model_from_jax_carries_the_snowpack(composition):
    jg, pg = _grids(4, 8)
    jm = land_model(tt, jg, composition)
    assert land_model_from(jm, pg) == land_model(tp, pg, composition)


# ---------------------------------------------------------------------------
# tests/test_snow.py, reproduced through the port's run
# ---------------------------------------------------------------------------
def _land_sim(air_T, snowfall=2.0e-7, swe0=0.0, rainfall=0.0, **model_kw):
    """`tests/test_snow.py::_land_sim`."""
    grid = tp.ColumnGrid.of(cells=2, spacing=tp.ExponentialSpacing(N=10),
                            dtype=torch.float64, device="cpu")
    soil = tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(
        vertical_flow=tp.RichardsEq(),
        hydraulic_properties=tp.ConstantSoilHydraulics(
            swrc=tp.VanGenuchten(alpha=2.0, n=2.0),
            unsat_hydraulic_cond=tp.UnsatKVanGenuchten())))
    model = tp.LandModel(grid=grid, soil=soil, snow=tp.Snowpack(), **model_kw)
    return tp.initialize(
        model, tp.ForwardEuler(),
        initializers={"temperature": 1.0, "saturation_water_ice": 0.6,
                      "snow_water_equivalent": swe0},
        input_sources=(tp.FieldInputSource(fields={
            "air_temperature": air_T, "snowfall": snowfall, "rainfall": rainfall,
            "surface_shortwave_down": 200.0}),))


def test_snow_accumulates_when_cold():
    sim = _land_sim(air_T=-10.0, snowfall=2.0e-7)
    assert integrator.column_scheme(sim.model, sim.timestepper, sim.ctx,
                                    sim.input_sources) == ("land", "euler")
    sim.run(steps=48, dt=300.0)
    swe = sim.state.snow_water_equivalent.numpy()
    np.testing.assert_allclose(swe, 2.0e-7 * 48 * 300.0, rtol=1e-12)
    f = sim.state.snow_cover_fraction.numpy()
    assert np.all((0 < f) & (f < 1))


def test_snow_melt_budget_closes():
    """Warm, no precipitation: the pack drains at the degree-day rate, and
    the melt flux partitions into infiltration + runoff every step."""
    sim = _land_sim(air_T=5.0, snowfall=0.0, swe0=0.02)
    dt, steps = 300.0, 24
    swe0 = sim.state.snow_water_equivalent.numpy().copy()
    fluxes = []

    def record(s):
        fluxes.append({k: s.state.auxiliary[k].numpy().copy()
                       for k in ("snow_melt", "infiltration", "surface_runoff",
                                 "rainfall_ground")})

    sim.run(steps=steps, dt=dt, callbacks=[record], callback_interval=1)
    swe = sim.state.snow_water_equivalent.numpy()
    melt_expected = tp.Snowpack().degree_day_factor * 5.0 * dt * steps
    np.testing.assert_allclose(swe0 - swe, melt_expected, rtol=1e-9)
    assert len(fluxes) == steps
    for f in fluxes:
        np.testing.assert_allclose(f["snow_melt"] + f["rainfall_ground"],
                                   f["infiltration"] + f["surface_runoff"],
                                   rtol=1e-12, atol=1e-18)
        assert np.all(f["snow_melt"] > 0)


def test_snow_albedo_feedback_raises_shortwave_up():
    sim_bare = _land_sim(air_T=-5.0, snowfall=0.0, swe0=0.0)
    sim_snow = _land_sim(air_T=-5.0, snowfall=0.0, swe0=0.5)
    assert isinstance(sim_snow.model.surface_energy_balance.albedo, tp.SnowCoverAlbedo)
    sim_bare.timestep(300.0)
    sim_snow.timestep(300.0)
    up_bare = float(sim_bare.state.surface_shortwave_up[0])
    up_snow = float(sim_snow.state.surface_shortwave_up[0])
    assert up_snow > up_bare
    assert float(sim_snow.state.snow_cover_fraction[0]) > 0.97
    assert up_snow > 0.75 * 200.0


def test_snow_custom_albedo_not_overridden():
    """A user-supplied albedo is left alone, and the land rollout refuses it
    by type: ``run`` steps it through the process modules."""
    seb = tp.SurfaceEnergyBalance(albedo=tp.PrescribedAlbedo())
    sim = _land_sim(air_T=0.0, surface_energy_balance=seb)
    assert isinstance(sim.model.surface_energy_balance.albedo, tp.PrescribedAlbedo)
    assert integrator.column_scheme(sim.model, sim.timestepper, sim.ctx,
                                    sim.input_sources) is None


# ---------------------------------------------------------------------------
# test_snow_ddm_pins (tests/test_parity_pins_veg.py:209), reproduced
# ---------------------------------------------------------------------------
def test_snow_ddm_pins():
    """cover = swe / (swe + swe_half); melt = k_dd max(Ta - T_melt, 0) gated
    SWE > 0; dSWE/dt = snowfall - melt, transcribed by hand."""
    k_dd, swe_half = 5.0e-3 / 86400.0, 0.01
    pts = [(0.05, 3.0, 0.0), (0.0, 5.0, 2.0e-8), (0.002, -4.0, 1.0e-7)]  # (swe, Ta, snowfall)
    expect = []
    for swe, Ta, sf in pts:
        cover = max(swe, 0.0) / (max(swe, 0.0) + swe_half)
        melt = k_dd * max(Ta - 0.0, 0.0) if swe > 0.0 else 0.0
        expect.append((cover, melt, sf - melt))
    expect = np.array(expect).T
    _, pg = _grids(3, 5)
    model = tp.LandModel(grid=pg, snow=tp.Snowpack())
    sim = tp.initialize(model, tp.ForwardEuler())
    arr = torch.as_tensor(np.array(pts).T)
    state = sim.state
    state.set(snow_water_equivalent=arr[0], air_temperature=arr[1], snowfall=arr[2])
    model.snow.compute_auxiliary(state, pg, model.atmosphere, sim.ctx)
    np.testing.assert_allclose(state.snow_cover_fraction.numpy(), expect[0], rtol=1e-12)
    np.testing.assert_allclose(state.snow_melt.numpy(), expect[1], rtol=1e-12)
    state.tendencies["snow_water_equivalent"] = torch.zeros(3, dtype=torch.float64)
    model.snow.compute_tendencies(state, pg, model.atmosphere, sim.ctx)
    np.testing.assert_allclose(state.tendencies["snow_water_equivalent"].numpy(), expect[2],
                               rtol=1e-12)
    assert math.isclose(expect[1][0], k_dd * 3.0)


# ---------------------------------------------------------------------------
# the land_snow golden
# ---------------------------------------------------------------------------
def _golden_sim(m):
    """`tests/test_goldens.py:52-64` in package ``m``."""
    _, pg = _grids(4, 12)
    jg, _ = _grids(4, 12)
    grid = jg if m is tt else pg
    return m.initialize(
        land_model(m, grid, "snow"), m.ForwardEuler(),
        initializers={"temperature": 1.0, "saturation_water_ice": 0.6,
                      "snow_water_equivalent": 0.02},
        input_sources=(m.FieldInputSource(fields={
            "air_temperature": 4.0, "snowfall": 5.0e-8, "surface_shortwave_down": 250.0}),))


def test_land_snow_golden_snow_fields_through_run():
    """`tests/goldens/land_snow.npz` through ``Simulation.run`` (the plain
    land rollout): 48 steps at dt 300. The snowpack's fields, which no soil
    field feeds (the melt reads the air temperature, the cover the SWE, the
    upward shortwave the cover and the downward shortwave), at 1e-12. The
    soil's energy and saturation are not held to the golden: its explicit
    Richards step over the default sand is unstable at dt 300 (ROADMAP
    Queue C), so JAX's own run of 48 single steps parts from the golden by
    0.77 in saturation; `test_land_snow_golden_step_by_step` holds them."""
    sim = _golden_sim(tp)
    sim.run(steps=48, dt=300.0)
    golden = np.load("tests/goldens/land_snow.npz")
    for f in ("snow_water_equivalent", "snow_cover_fraction", "surface_shortwave_up"):
        np.testing.assert_allclose(sim.state[f].numpy(), golden[f], rtol=1e-12, atol=1e-12,
                                   err_msg=f)
    assert sim.iteration == 48 and sim.current_time == 14400.0
    assert bool(torch.isfinite(sim.state.internal_energy).all())


def test_land_snow_golden_step_by_step():
    """The golden's composition along JAX's trajectory: at each of the 48
    steps the port's run of one step from JAX's state (the plain land
    rollout with the snowpack) against JAX's run of the same step, within
    1e-12 of the value with a floor of 1e-12 of the field's magnitude; no
    step's difference feeds the next, so the instability that parts free
    runs (Queue C) does not amplify it. The snowpack, the energy and the
    skin temperature are held at every step; the saturation and the pool
    through step 14. From step 15 the top layer reaches saturation, where
    JAX's closed-form adjustment and the port's sweeps leave it an ulp
    apart either side of 1 and switch the infiltration (steps 15, 30 and
    32 part by 3e-3), and layers drained to about 0 round apart by up to
    4e-10 (Queue C); the reference's parity pool term meanwhile grows the
    pool by its own drainage to 47 m."""
    jsim = _golden_sim(tt)
    _, pg = _grids(4, 12)
    psim = _golden_sim(tp)
    names = sorted(psim.state.prognostic)
    for step in range(1, 49):
        psim.state = state_from_numpy(jax_state_arrays(jsim.state), float(jsim.state.clock.time),
                                      int(jsim.state.clock.iteration), pg)
        jsim.run(steps=1, dt=300.0)
        psim.run(steps=1, dt=300.0)
        for n in names:
            if step > 14 and n in ("saturation_water_ice", "surface_excess_water"):
                continue
            a, b = psim.state[n].numpy(), np.asarray(jsim.state[n])
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.max(np.abs(b)),
                                       err_msg=f"step {step}: {n}")
    assert float(np.max(np.asarray(jsim.state.surface_excess_water))) > 40.0
