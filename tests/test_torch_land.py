"""The port's LandModel against the JAX package's: each new process module
on identical inputs at float64, the whole model's auxiliaries and
tendencies, the ``land_model`` golden through ``Simulation.run``, the
hand-derived composed step, the coupled configuration of the JAX fused-kernel
test, the live carry against JAX's dead-input mask, the parity composition's
divergence, the consistent composition's saturation overshoot, the converter
and the compositions the land rollout refuses.

Module tests start both packages from one state: the JAX model's state with
``torch_parity.land_random_state``'s fields, closed and its auxiliaries
computed by JAX, then carried over leaf for leaf; each module then runs in
both packages on those same numbers. rtol 1e-12 with a floor of 1e-12 of the
field's magnitude (``assert_fields_close``) unless a test states otherwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.utils.scan_dce import _dead_input_mask
from terrarium_tpu_torch.convert import land_model_from, state_from_numpy
from terrarium_tpu_torch.ops import land_step as ls
from terrarium_tpu_torch.processes.soil.hydrology import saturation_sweeps
from terrarium_tpu_torch.timesteppers.integrator import advance, land_inputs

from torch_parity import (assert_fields_close, jax_state_arrays, land_model,
                          land_random_state)

CELLS, NZ = 48, 8
GOLDEN = "tests/goldens/land_model.npz"


def _grids(cells=CELLS, nz=NZ, dtype=torch.float64):
    nf = np.float64 if dtype == torch.float64 else np.float32
    return (tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=nz), nf=nf),
            tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=dtype,
                             device="cpu"))


def _models(composition, **overrides):
    """The same model in both packages: ``composition`` of
    ``torch_parity.land_model``, with process fields replaced by
    ``overrides`` (a function of the package)."""
    jg, pg = _grids()
    out = []
    for m, g in ((tt, jg), (tp, pg)):
        model = land_model(m, g, composition)
        if overrides:
            model = dataclasses.replace(model, **{k: f(m) for k, f in overrides.items()})
        out.append(model)
    return out


def _both(composition, seed, **overrides):
    """(jax model, jax state, port model, port state, jax ctx, port ctx) on
    identical numbers: the random fields set in JAX, JAX's closure and
    compute_auxiliary, the state carried over."""
    jm, pm = _models(composition, **overrides)
    jsim = tt.initialize(jm, tt.ForwardEuler(dt=600.0),
                         initializers={"temperature": 5.0, "saturation_water_ice": 0.6})
    fields = land_random_state(seed, CELLS, NZ)
    js = jsim.state
    upd = {k: jnp.asarray(v) for k, v in fields.items() if k in js}
    if "saturation_water_ice" not in js.prognostic:
        upd["saturation_water_ice"] = jnp.clip(upd["saturation_water_ice"], 0.0, 1.0)
    js = js.update(upd)
    js = jm.closure(js, jsim.ctx)
    js = jm.compute_auxiliary(js, jsim.ctx)
    ps = state_from_numpy(jax_state_arrays(js), 0.0, 0, pm.grid)
    return jm, js, pm, ps, jsim.ctx, pm.make_context()


def _same(pstate, jstate, names, rtol=1e-12):
    assert_fields_close(pstate, jstate, [n for n in names if n in jstate], rtol=rtol,
                        rel_atol=rtol)


def _consts():
    return tt.PhysicalConstants(), tp.PhysicalConstants()


# ---------------------------------------------------------------------------
# atmosphere
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("drag", ["constant", "monin_obukhov"])
def test_atmosphere_accessors(drag, seed):
    comp = "coupled" if drag == "constant" else "consistent"
    jm, js, pm, ps, _, _ = _both(comp, seed)
    jc, pc = _consts()
    ja, pa = jm.atmosphere, pm.atmosphere
    pairs = {
        "windspeed": (ja.windspeed(js), pa.windspeed(ps)),
        "drag": (ja.aerodynamics.drag_coefficient(js, ja, jc),
                 pa.aerodynamics.drag_coefficient(ps, pa, pc)),
        "r_a": (ja.aerodynamic_resistance(js, jc), pa.aerodynamic_resistance(ps, pc)),
        "vpd_air": (ja.compute_vpd(js, jc), pa.compute_vpd(ps, pc)),
        "dq_skin": (ja.humidity_vpd(js, jc, js.skin_temperature),
                    pa.humidity_vpd(ps, pc, ps.skin_temperature)),
        "dq_ground": (ja.humidity_vpd(js, jc, js.ground_temperature),
                      pa.humidity_vpd(ps, pc, ps.ground_temperature)),
    }
    for name, (a, b) in pairs.items():
        a = np.broadcast_to(np.asarray(a), (CELLS,))
        b = torch.broadcast_to(torch.as_tensor(b, dtype=torch.float64), (CELLS,)).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * np.max(np.abs(a)),
                                   err_msg=name)
    if drag == "monin_obukhov":  # both stability branches are reached
        ts, ta = np.asarray(js.skin_temperature), np.asarray(js.inputs["air_temperature"])
        assert (ts > ta).any() and (ts < ta).any()


def test_constants_helpers():
    rng = np.random.default_rng(3)
    T = rng.uniform(-200.0, 200.0, 64)
    p, q = rng.uniform(8e4, 1.05e5, 64), rng.uniform(0.0, 0.03, 64)
    jc, pc = _consts()
    cases = {
        "e_sat": (tt.constants.saturation_vapor_pressure(jnp.asarray(T)),
                  tp.saturation_vapor_pressure(torch.as_tensor(T))),
        "vpd": (tt.constants.compute_vpd(jc, jnp.asarray(p), jnp.asarray(q), jnp.asarray(T)),
                tp.compute_vpd(pc, torch.as_tensor(p), torch.as_tensor(q), torch.as_tensor(T))),
        "q": (tt.constants.vapor_pressure_to_specific_humidity(jnp.asarray(T), jnp.asarray(p)),
              tp.vapor_pressure_to_specific_humidity(torch.as_tensor(T), torch.as_tensor(p))),
        "M": (tt.constants.stefan_boltzmann(jc, jnp.asarray(T + 273.15), 0.97),
              tp.stefan_boltzmann(pc, torch.as_tensor(T + 273.15), 0.97)),
        "O2": (tt.constants.partial_pressure_O2(jnp.asarray(p)),
               tp.partial_pressure_O2(torch.as_tensor(p))),
        "CO2": (tt.constants.partial_pressure_CO2(jnp.asarray(p), 380.0),
                tp.partial_pressure_CO2(torch.as_tensor(p), 380.0)),
    }
    for name, (a, b) in cases.items():
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, err_msg=name)
    f64 = torch.float64
    assert float(tp.compute_vpd(pc, torch.tensor(1e5, dtype=f64), torch.tensor(0.05, dtype=f64),
                                torch.tensor(-20.0, dtype=f64))) == 0.1


# ---------------------------------------------------------------------------
# surface energy balance
# ---------------------------------------------------------------------------
SEB_FIELDS = ("skin_temperature", "ground_heat_flux", "surface_net_radiation",
              "surface_shortwave_up", "surface_longwave_up", "sensible_heat_flux",
              "latent_heat_flux")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("form", ["reference", "consistent"])
def test_surface_energy_balance(form, seed):
    """Both ground-flux forms, Monin-Obukhov drag and the PALADYN humidity
    flux (consistent) or constant drag and the bare-ground one (reference);
    skin temperatures far from the ground's reach the max_delta clamp."""
    comp = "consistent" if form == "consistent" else "bare_richards"
    jm, js, pm, ps, _, _ = _both(comp, seed)
    jc, pc = _consts()
    js = jm.surface_energy_balance.compute_surface_energy_fluxes(
        js, jm.grid, jc, jm.atmosphere, jm.surface_hydrology.evapotranspiration)
    pm.surface_energy_balance.compute_surface_energy_fluxes(
        ps, pm.grid, pc, pm.atmosphere, pm.surface_hydrology.evapotranspiration)
    _same(ps, js, SEB_FIELDS)
    delta = np.abs(np.asarray(js.skin_temperature) - np.asarray(js.ground_temperature))
    assert np.isclose(delta, 50.0).any() and (delta < 50.0).any()


def test_seb_rejects_an_unknown_form():
    with pytest.raises(ValueError, match="ground_flux_form"):
        tp.SurfaceEnergyBalance(ground_flux_form="other")


# ---------------------------------------------------------------------------
# surface hydrology
# ---------------------------------------------------------------------------
def _hydrology(interception, et, runoff):
    def make(m):
        et_ = getattr(m, et[0])(ground_resistance=getattr(m, et[1])(), water_flux_scale=et[2])
        return m.SurfaceHydrology(canopy_interception=getattr(m, interception)(),
                                  evapotranspiration=et_,
                                  surface_runoff=m.DirectSurfaceRunoff(
                                      consistent_drainage=runoff))
    return make


HYDROLOGY = {
    "bare_constant_parity": ("bare_richards",
                             ("NoCanopyInterception",
                              ("BareGroundEvaporation", "ConstantEvaporationResistanceFactor",
                               1.0), False)),
    "bare_soil_consistent": ("bare_richards",
                             ("NoCanopyInterception",
                              ("BareGroundEvaporation", "SoilMoistureResistanceFactor",
                               1.293e-3), True)),
    "paladyn_constant_parity": ("coupled",
                                ("PALADYNCanopyInterception",
                                 ("PALADYNCanopyEvapotranspiration",
                                  "ConstantEvaporationResistanceFactor", 1.0), False)),
    "paladyn_soil_consistent": ("coupled",
                                ("PALADYNCanopyInterception",
                                 ("PALADYNCanopyEvapotranspiration",
                                  "SoilMoistureResistanceFactor", 1.293e-3), True)),
}
HYD_FIELDS = ("rainfall_ground", "canopy_water_interception", "canopy_water_removal",
              "saturation_canopy_water", "evaporation_ground", "evaporation_canopy",
              "transpiration", "infiltration", "surface_runoff")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(HYDROLOGY))
def test_surface_hydrology_and_soil_siblings(case, seed):
    """Both interceptions, both ET schemes with both ground-resistance
    factors, both runoff modes: the auxiliaries, the canopy-water tendency,
    and the soil's tendencies with the ET sink and the pool drainage."""
    comp, spec = HYDROLOGY[case]
    jm, js, pm, ps, jctx, pctx = _both(comp, seed, surface_hydrology=_hydrology(*spec))
    jc, pc = _consts()
    js = jm.surface_hydrology.compute_auxiliary(js, jm.grid, jc, jm.atmosphere, jm.soil,
                                                jm.vegetation, jctx)
    pm.surface_hydrology.compute_auxiliary(ps, pm.grid, pc, pm.atmosphere, pm.soil,
                                           pm.vegetation, pctx)
    _same(ps, js, HYD_FIELDS)
    js = jm.surface_hydrology.compute_tendencies(js, jm.grid, jctx)
    js = jm.soil.compute_tendencies(js, jm.grid, jctx)
    pm.surface_hydrology.compute_tendencies(ps, pm.grid, pctx)
    pm.soil.compute_tendencies(ps, pm.grid, pctx)
    for name in ps.tendencies:
        a, b = np.asarray(js.tendencies[name]), ps.tendencies[name].numpy()
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * max(np.max(np.abs(a)), 1e-300),
                                   err_msg=name)
    S = np.asarray(js.surface_excess_water)
    assert (S > 0).any() and (S <= 0).any()
    assert (np.asarray(js.saturation_water_ice)[-1] >= 1.0).any()


def test_soil_without_siblings_is_unchanged():
    """A SoilModel's Richards tendencies (no ET, no runoff sibling) stay
    the parity pool term min(0, S) and the Darcy divergence alone."""
    from terrarium_tpu_torch.processes.soil.hydrology import pool_drainage

    S = torch.tensor([-1.0, 0.0, 2.0])
    assert torch.equal(pool_drainage(S), torch.tensor([-1.0, 0.0, 0.0]))
    runoff = tp.DirectSurfaceRunoff(tau_r=2.0)
    assert torch.equal(pool_drainage(S, runoff), torch.tensor([-1.0, 0.0, 1.0]))
    assert torch.equal(pool_drainage(S, tp.DirectSurfaceRunoff.consistent(tau_r=2.0)),
                       torch.tensor([1.0, -0.0, -1.0]))


# ---------------------------------------------------------------------------
# vegetation
# ---------------------------------------------------------------------------
VEG_STEPS = ("plant_available_water", "carbon_dynamics", "phenology", "stomatal_conductance",
             "photosynthesis", "autotrophic_respiration")
VEG_FIELDS = {"plant_available_water": ("plant_available_water",
                                        "soil_moisture_limiting_factor"),
              "carbon_dynamics": ("balanced_leaf_area_index",),
              "phenology": ("phenology_factor", "leaf_area_index"),
              "stomatal_conductance": ("canopy_water_conductance", "leaf_to_air_co2_ratio"),
              "photosynthesis": ("net_assimilation", "leaf_respiration",
                                 "gross_primary_production"),
              "autotrophic_respiration": ("autotrophic_respiration", "net_primary_production")}


def _veg_call(model, state, step, m):
    veg, c, atm, soil = model.vegetation, model.constants, model.atmosphere, model.soil
    g = model.grid
    if step == "plant_available_water":
        out = veg.plant_available_water.compute_auxiliary(state, g, soil)
    elif step in ("carbon_dynamics", "phenology"):
        out = getattr(veg, step).compute_auxiliary(state, g)
    elif step == "stomatal_conductance":
        out = veg.stomatal_conductance.compute_auxiliary(state, g, veg.photosynthesis, c, atm)
    elif step == "photosynthesis":
        out = veg.photosynthesis.compute_auxiliary(state, g, veg.stomatal_conductance, c, atm)
    else:
        out = veg.autotrophic_respiration.compute_auxiliary(state, g, veg.carbon_dynamics, atm)
    return out if m is tt else state


@pytest.mark.parametrize("rates", ["coupled", "parity"])
@pytest.mark.parametrize("step", VEG_STEPS)
def test_vegetation_process(step, rates):
    """Each vegetation process, on identical inputs, with the consistent and
    the reference rate scales; the inputs cross every threshold of the
    photosynthesis (night, T < -4, -3, 42 degC), the respiration (7 degC),
    the LAI ramp and the PAW clip."""
    jm, js, pm, ps, _, _ = _both(rates, 0)
    js = _veg_call(jm, js, step, tt)
    _veg_call(pm, ps, step, tp)
    _same(ps, js, VEG_FIELDS[step])
    if step == "plant_available_water":
        W = np.asarray(js.plant_available_water)
        assert (W == 0).any() and (W == 1).any() and ((W > 0) & (W < 1)).any()


@pytest.mark.parametrize("rates", ["coupled", "parity"])
def test_vegetation_tendencies_and_root_fraction(rates):
    jm, js, pm, ps, jctx, pctx = _both(rates, 1)
    js = jm.vegetation.compute_tendencies(js, jm.grid, jm.constants, jctx)
    pm.vegetation.compute_tendencies(ps, pm.grid, pm.constants, pctx)
    for name in ("carbon_vegetation", "vegetation_area_fraction"):
        a, b = np.asarray(js.tendencies[name]), ps.tendencies[name].numpy()
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * np.max(np.abs(a)),
                                   err_msg=name)
    rf = np.asarray(js.root_fraction)
    np.testing.assert_allclose(pm.vegetation.root_distribution.profile(pm.grid.vertical),
                               rf[:, 0], rtol=1e-14)
    lai = np.asarray(js.balanced_leaf_area_index)
    assert (lai < 1.0).any() and (lai > 6.0).any()


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("composition", ["bare", "bare_richards", "coupled", "consistent",
                                         "parity"])
def test_land_model_auxiliary_and_tendencies(composition, seed):
    """LandModel.closure, compute_auxiliary and compute_tendencies from the
    same random state: every auxiliary and tendency at 1e-12."""
    jm, pm = _models(composition)
    jsim = tt.initialize(jm, tt.ForwardEuler(dt=600.0),
                         initializers={"temperature": 5.0, "saturation_water_ice": 0.6})
    fields = land_random_state(seed, CELLS, NZ)
    js = jsim.state
    upd = {k: jnp.asarray(v) for k, v in fields.items() if k in js}
    if "saturation_water_ice" not in js.prognostic:
        upd["saturation_water_ice"] = jnp.clip(upd["saturation_water_ice"], 0.0, 1.0)
    js = js.update(upd)
    # the closure is compared on its own (its sweeps round as Queue C
    # says); the auxiliaries and tendencies from JAX's closed state
    ps = state_from_numpy(jax_state_arrays(js), 0.0, 0, pm.grid)
    js = jm.closure(js, jsim.ctx)
    pm.closure(ps, pm.make_context())
    for name in ("temperature", "liquid_water_fraction", "ground_temperature"):
        a, b = np.asarray(js[name]), ps[name].numpy()
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * np.max(np.abs(a)),
                                   err_msg=name)
    ps = state_from_numpy(jax_state_arrays(js), 0.0, 0, pm.grid)
    ctx = pm.make_context()
    js = jm.compute_auxiliary(js, jsim.ctx)
    js = jm.compute_tendencies(js, jsim.ctx)
    pm.compute_auxiliary(ps, ctx)
    pm.compute_tendencies(ps, ctx)
    _same(ps, js, list(ps.auxiliary))
    for name in ps.tendencies:
        a, b = np.asarray(js.tendencies[name]), ps.tendencies[name].numpy()
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * max(np.max(np.abs(a)), 1e-300),
                                   err_msg=name)


def test_land_golden_through_run():
    """`tests/test_goldens.py:40-49` through ``Simulation.run`` (the plain
    land rollout on the CPU), with the skin temperature and the ground heat
    flux, at 1e-12."""
    _, pg = _grids(4, 15)
    sim = tp.initialize(tp.LandModel(grid=pg), tp.ForwardEuler(),
                        initializers={"temperature": 5.0, "saturation_water_ice": 0.8},
                        input_sources=(tp.FieldInputSource(fields={
                            "surface_shortwave_down": 400.0, "air_temperature": 12.0,
                            "rainfall": 1.0e-7}),))
    sim.run(steps=48, dt=300.0)
    golden = np.load(GOLDEN)
    assert set(golden.files) >= {"skin_temperature", "ground_heat_flux"}
    for f in golden.files:
        np.testing.assert_allclose(sim.state[f].numpy(), golden[f], rtol=1e-12, atol=1e-12,
                                   err_msg=f)
    assert sim.iteration == 48 and sim.current_time == 14400.0


def test_land_step_pin_reproduced():
    """`tests/test_parity_pins_land_step.py`'s hand-derived composed step
    (Richards over Van Genuchten and linear conductivity, bare ground, the
    SEB's two fused updates, the flux-BC coupling) through the port's
    ``Simulation.timestep`` at its rtol 1e-10, and the prognostics through
    the plain land rollout."""
    import test_parity_pins_land_step as pin

    grid = tp.ColumnGrid.of(cells=2, spacing=tp.UniformSpacing(dz=pin.DZ, N=pin.NZ),
                            dtype=torch.float64, device="cpu")
    soil = tp.SoilEnergyWaterCarbon(
        strat=tp.HomogeneousStratigraphy(texture=tp.SoilTexture.preset("loam")),
        hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq(),
                                   hydraulic_properties=tp.ConstantSoilHydraulics(
                                       sat_hydraulic_cond=pin.KSAT,
                                       swrc=tp.VanGenuchten(alpha=pin.ALPHA_VG, n=pin.N_VG),
                                       unsat_hydraulic_cond=tp.UnsatKLinear())))
    static = tp.FieldInputSource(fields={
        "surface_shortwave_down": pin.SW, "surface_longwave_down": pin.LW,
        "air_temperature": pin.TA, "specific_humidity": pin.QA, "air_pressure": pin.PA,
        "windspeed": pin.V, "rainfall": pin.RAIN})

    def start():
        sim = tp.initialize(tp.LandModel(grid=grid, soil=soil), tp.ForwardEuler(dt=pin.DT),
                            initializers={"temperature": 5.0, "saturation_water_ice": 0.5},
                            input_sources=(static,))
        col = lambda v: torch.as_tensor(np.array(v)[:, None] * np.ones((1, 2)))  # noqa: E731
        xy = lambda v: torch.full((2,), v, dtype=torch.float64)  # noqa: E731
        U0 = [pin.T0[k] * pin.heat_capacity(pin.SAT0[k]) for k in range(pin.NZ)]
        psi0 = [pin.psi_m(pin.SAT0[k]) + pin.ZC[k] for k in range(pin.NZ)]
        sim.state.set(internal_energy=col(U0), temperature=col(pin.T0),
                      liquid_water_fraction=torch.ones((pin.NZ, 2), dtype=torch.float64),
                      saturation_water_ice=col(pin.SAT0), pressure_head=col(psi0),
                      water_table=xy(pin.ZF[0]), surface_excess_water=xy(pin.POOL0),
                      skin_temperature=xy(pin.TS0), ground_temperature=xy(pin.T0[-1]))
        return sim

    exp = pin.expected_step()
    sim = start()
    sim.timestep(pin.DT, finalize=False)
    get = lambda name: sim.state[name].numpy()[..., 0]  # noqa: E731
    for name, key in (("internal_energy", "U"), ("saturation_water_ice", "sat"),
                      ("surface_excess_water", "pool"), ("skin_temperature", "skin"),
                      ("temperature", "T"), ("pressure_head", "psi"), ("water_table", "wt"),
                      ("infiltration", "infil"), ("surface_runoff", "runoff"),
                      ("ground_heat_flux", "G"), ("evaporation_ground", "E")):
        np.testing.assert_allclose(get(name), exp[key], rtol=1e-10, err_msg=name)
    assert sim.current_time == pin.DT
    sim = start()
    advance(sim.model, sim.state, sim.ctx, 1, pin.DT, input_sources=sim.input_sources)
    for name, key in (("internal_energy", "U"), ("saturation_water_ice", "sat"),
                      ("surface_excess_water", "pool"), ("skin_temperature", "skin"),
                      ("temperature", "T")):
        np.testing.assert_allclose(get(name), exp[key], rtol=1e-10, err_msg=name)


def _coupled(pkg, grid, dtype):
    """`tests/test_fused_step.py:201-253`'s configuration (64 cells, Nz 8,
    uniform columns, 48 hourly rows of forcing)."""
    m = pkg
    cells = 64
    hours = np.arange(0.0, 48 * 3600.0, 3600.0)
    day = hours / 86400.0
    sw = (800.0 * np.maximum(0.0, np.sin(2 * np.pi * (day[:, None] - 0.25)))
          * np.ones((1, cells))).astype(dtype)
    ta = ((12.0 + 6.0 * np.sin(2 * np.pi * (day[:, None] - 0.3)))
          * np.ones((1, cells))).astype(dtype)
    return m.initialize(
        land_model(m, grid, "coupled"), m.ForwardEuler(dt=600.0),
        input_sources=(m.TimeSeriesInputSource(times=hours, series={
            "surface_shortwave_down": sw, "air_temperature": ta}),
            m.FieldInputSource(fields={"surface_longwave_down": 330.0, "rainfall": 4.0e-8,
                                       "windspeed": 3.0, "specific_humidity": 0.006})),
        initializers={"temperature": 8.0, "saturation_water_ice": 0.6,
                      "carbon_vegetation": 2.0, "vegetation_area_fraction": 0.5})


def test_coupled_configuration_matches_jax_f64():
    """12 steps of the coupled configuration at float64: JAX's
    ``Simulation.run`` against the port's (the plain land rollout). Every
    prognostic within 1e-12 (relative, with a floor of 1e-12 of the
    magnitude), the saturation within 1e-10 (it parts by 2.4e-11 at most):
    JAX's closed-form saturation adjustment rounds apart from the sequential
    sweeps (ROADMAP Queue C), by about 6e-13 of the field's magnitude more
    each step here, where the reference's unscaled ET sink
    (``water_flux_scale`` 1) drains the thin top layer hard."""
    jg, pg = _grids(64, 8, torch.float64)
    jsim, psim = _coupled(tt, jg, np.float64), _coupled(tp, pg, np.float64)
    jsim.run(steps=12, dt=600.0)
    psim.run(steps=12)
    names = sorted(jsim.state.prognostic)
    assert_fields_close(psim.state, jsim.state, [n for n in names if n != "saturation_water_ice"])
    assert_fields_close(psim.state, jsim.state, ["saturation_water_ice"], rtol=1e-10,
                        rel_atol=1e-10)


def test_coupled_configuration_f32_within_jax_f32_error():
    """The coupled configuration at float32 (`tests/test_fused_step.py:
    201-253`), 8 steps: both packages' float32 runs sit about 1e-3 from the
    float64 result in the saturation after one step (the unscaled ET sink
    drains the thin top layer, and float32 cancels there), and round apart
    by up to 1.6e-4 from each other, beyond `test_fused_step.py`'s rtol 2e-5,
    which holds only between JAX's two paths of the same arithmetic. So each
    prognostic of the port's float32 run is held, step by step, within twice
    the largest float32 error JAX's run has shown so far against JAX's
    float64 run, plus 2e-5 of the field's magnitude (the two float32 errors
    grow together, to 0.22 K in the skin temperature by step 7). From step 9
    on JAX's float32 run loses the column (its closed-form adjustment,
    ROADMAP Queue C) while the port's stays within 6e-2 of float64."""
    jg64, _ = _grids(64, 8, torch.float64)
    jg32, pg32 = _grids(64, 8, torch.float32)
    ref, j32, p32 = (_coupled(tt, jg64, np.float64), _coupled(tt, jg32, np.float32),
                     _coupled(tp, pg32, np.float32))
    e_jax = {}
    for _ in range(8):
        ref.run(steps=1, dt=600.0)
        j32.run(steps=1, dt=600.0)
        p32.run(steps=1)
        for name in sorted(ref.state.prognostic):
            r = np.asarray(ref.state[name], dtype=np.float64)
            e_jax[name] = max(e_jax.get(name, 0.0), np.max(np.abs(
                np.asarray(j32.state[name], dtype=np.float64) - r)))
            e_port = np.max(np.abs(p32.state[name].numpy().astype(np.float64) - r))
            assert e_port <= 2.0 * e_jax[name] + 2e-5 * np.max(np.abs(r)), name
    assert all(bool(torch.isfinite(v).all()) for v in p32.state.prognostic.values())


def _dead_mask_live(jsim):
    state = jsim.state
    leaves, treedef = jax.tree.flatten(state)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]]

    def flat_step(lv, d):
        out = jsim.timestepper.pre_closure_step(jsim.model, jax.tree.unflatten(treedef, lv),
                                                jsim.ctx, jsim.input_sources, d)
        return jax.tree.leaves(out)

    used = _dead_input_mask(flat_step, leaves, 600.0)[:len(leaves)]
    return {p for p, u in zip(paths, used) if u}


@pytest.mark.parametrize("composition", ["bare", "consistent"])
def test_live_carry_matches_jax_dead_input_mask(composition):
    """A traced JAX ``pre_closure_step`` consumes the port's live carry (the
    prognostics and, under vegetation, the net assimilation), its static
    auxiliaries, the clock and every input that no time series writes (the
    step reads them, or passes them through), and nothing else."""
    jg, pg = _grids(8, 8)
    hours = np.arange(0.0, 7200.0 * 4, 3600.0)
    rows = np.full((hours.size, 8), 300.0)
    inits = {"temperature": 5.0, "saturation_water_ice": 0.6, "carbon_vegetation": 2.0,
             "vegetation_area_fraction": 0.5}
    sims = []
    for m, g in ((tt, jg), (tp, pg)):
        model = land_model(m, g, composition)
        names = model.collated_variables().prognostic
        sims.append(m.initialize(
            model, m.ForwardEuler(dt=600.0),
            (m.TimeSeriesInputSource(times=hours, series={"surface_shortwave_down": rows}),),
            initializers={k: v for k, v in inits.items() if k in names
                          or k in ("temperature", "saturation_water_ice")}))
    jsim, psim = sims
    live = _dead_mask_live(jsim)
    groups = {n: ("prognostic" if n in psim.state.prognostic else "auxiliary")
              for n in psim.model.live_carry}
    expected = {f".{g}['{n}']" for n, g in groups.items()}
    expected |= {f".auxiliary['{n}']" for n in psim.model.static_auxiliaries}
    expected |= {f".inputs['{n}']" for n in psim.state.inputs if n != "surface_shortwave_down"}
    assert live == expected | {".clock.time", ".clock.iteration"}
    if composition == "consistent":
        assert ".auxiliary['net_assimilation']" in live


def _latitude_sims(composition, dtype, cells=64):
    """`bench_configs.py:228-267`'s forcing and initial state in both
    packages on ``cells`` columns at latitudes from -60 to 80 degrees, Nz 20,
    dt 600 s, two days of hourly shortwave and air temperature, the model of
    ``composition`` (``torch_parity.land_model``)."""
    jg, pg = _grids(cells, 20, dtype)
    nf = np.float64 if dtype == torch.float64 else np.float32
    lat = np.linspace(-60.0, 80.0, cells)
    coslat = np.maximum(np.cos(np.deg2rad(lat)), 0.05)
    T_mean = 28.0 * coslat - 8.0
    hours = np.arange(0.0, 2 * 86400.0, 3600.0)
    day = hours[:, None] / 86400.0
    sw = (900.0 * coslat[None, :] * np.maximum(0.0, np.sin(2 * np.pi * (day - 0.25))))
    ta = T_mean[None, :] + 6.0 * np.sin(2 * np.pi * (day - 0.3))
    return tuple(m.initialize(
        land_model(m, g, composition), m.ForwardEuler(dt=600.0),
        (m.TimeSeriesInputSource(times=hours, series={
            "surface_shortwave_down": sw.astype(nf), "air_temperature": ta.astype(nf)}),
         m.FieldInputSource(fields={"surface_longwave_down": 330.0, "rainfall": 4.0e-8,
                                    "windspeed": 3.0})),
        initializers={"temperature": lambda x, z: T_mean[None, :] + 0.0 * z,
                      "saturation_water_ice": 0.6, "carbon_vegetation": 2.0,
                      "vegetation_area_fraction": 0.5}) for m, g in ((tt, jg), (tp, pg)))


def test_parity_composition_diverges_where_jax_does():
    """`bench_configs.py:228-267`'s parity composition on 64 columns at
    latitudes from -60 to 80 degrees, float32, dt 600 s: after 72 steps the
    port's plain rollout leaves the canopy water non-finite in exactly the
    columns where JAX's does (all of them: the raw yearly rates and the
    reference ground-flux form diverge, `test_parity_robustness.py`)."""
    masks = []
    for sim in _latitude_sims("parity", torch.float32):
        sim.run(steps=72, dt=600.0)
        masks.append(~np.isfinite(np.asarray(sim.state.canopy_water)))
    assert masks[0].any()
    np.testing.assert_array_equal(masks[1], masks[0])


def test_consistent_composition_overshoots_where_jax_does():
    """The consistent composition (the port's land main path) on the same
    columns, float64, three closure-rotated steps: JAX's
    ``ForwardEuler.pre_closure_step`` against the port's plain land rollout
    (the kernel's reference). After two steps the carries agree within
    1e-10 and more than 90% of the columns have a saturation layer outside
    [0, 1] in both, the same columns: the explicit Richards flow at dt 600
    over the 5 cm top layer overshoots in the reference as in the port. The
    third step's closure adjusts those layers into a pool and the pool
    drains back into the top layer, to saturations in the thousands in
    both; there each column agrees within 1e-9 of its largest magnitude
    except where the two closures leave the top layer on opposite sides of
    saturation, an ulp apart (JAX's closed-form adjustment against the
    sweeps, ROADMAP Queue C), so that one infiltrates and the other not."""
    jsim, psim = _latitude_sims("consistent", torch.float64)
    model, st = psim.model, psim.state
    params = ls.LandParams.of(model, torch.float64)
    carry = {n: st[n].contiguous() for n in ls.carry_names(params)}
    inputs = land_inputs(model, st, psim.input_sources)
    coords = tuple(getattr(model.grid, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    js, jclosed = jsim.state, None
    for i in range(3):
        jclosed = jsim.model.closure(js, jsim.ctx)
        pclosed = saturation_sweeps(carry["saturation_water_ice"], coords[0][:, None])[0]
        js = jsim.timestepper.pre_closure_step(jsim.model, js, jsim.ctx, jsim.input_sources,
                                               600.0)
        carry = ls.land_column_rollout_plain(carry, inputs, st.auxiliary["root_fraction"],
                                             *coords, params, 600.0, 600.0 * i, 1)
        if i == 1:
            for n in model.live_carry:
                a, b = carry[n].numpy(), np.asarray(js[n])
                np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10 * np.abs(b).max(),
                                           err_msg=n)
            outside = [((s > 1.0) | (s < 0.0)).any(0) for s in (
                carry["saturation_water_ice"].numpy(), np.asarray(js["saturation_water_ice"]))]
            np.testing.assert_array_equal(*outside)
            assert outside[1].mean() > 0.9
    flip = ((pclosed[-1].numpy() >= 1.0)
            != (np.asarray(jclosed["saturation_water_ice"])[-1] >= 1.0))
    assert flip.sum() <= 4
    np.testing.assert_allclose(pclosed[-1].numpy()[flip],
                               np.asarray(jclosed["saturation_water_ice"])[-1][flip], rtol=1e-12)
    held = ~flip
    for n in model.live_carry:
        a, b = carry[n].numpy(), np.asarray(js[n])
        scale = np.abs(b).max(0) if b.ndim == 2 else np.abs(b).max()
        assert np.all((np.abs(a - b) <= 1e-9 * scale)[..., held]), n
    sat_j = np.asarray(js["saturation_water_ice"])
    assert np.abs(sat_j).max() > 100.0 and np.abs(carry["saturation_water_ice"].numpy()).max() > 100.0


# ---------------------------------------------------------------------------
# converter and refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("composition", ["bare", "bare_richards", "coupled", "consistent",
                                         "parity"])
def test_land_model_from_jax(composition):
    jm, pm = _models(composition)
    assert land_model_from(jm, pm.grid) == pm


def _bare_sim(**model_kw):
    _, pg = _grids(4, 8)
    return tp.initialize(tp.LandModel(grid=pg, **model_kw), tp.ForwardEuler(dt=300.0),
                         initializers={"temperature": 5.0, "saturation_water_ice": 0.8})


REFUSED = {
    "PrescribedAlbedo": dict(surface_energy_balance=tp.SurfaceEnergyBalance(
        albedo=tp.PrescribedAlbedo())),
    "PrescribedRadiativeFluxes": dict(surface_energy_balance=tp.SurfaceEnergyBalance(
        radiative_fluxes=tp.PrescribedRadiativeFluxes())),
    "PrescribedTurbulentFluxes": dict(surface_energy_balance=tp.SurfaceEnergyBalance(
        turbulent_fluxes=tp.PrescribedTurbulentFluxes())),
    "PrescribedSkinTemperature": dict(surface_energy_balance=tp.SurfaceEnergyBalance(
        skin_temperature=tp.PrescribedSkinTemperature())),
    "BareGroundEvaporation": dict(surface_hydrology=tp.SurfaceHydrology(
        evapotranspiration=tp.BareGroundEvaporation())),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_land_rollout_refuses_by_type(name):
    """``run`` raises ``ValueError`` naming the class the kernel does not
    run; ``Simulation.timestep`` steps the modules all the same."""
    sim = _bare_sim(**REFUSED[name])
    with pytest.raises(ValueError, match=name):
        sim.run(steps=2)
    assert sim.iteration == 0
    sim.timestep()
    assert bool(torch.isfinite(sim.state.internal_energy).all())


@pytest.mark.parametrize("stepper", ["Heun", "ImplicitEuler"])
def test_land_rollout_refuses_other_steppers(stepper):
    sim = _bare_sim()
    sim.timestepper = getattr(tp, stepper)(dt=300.0)
    with pytest.raises(ValueError, match=stepper):
        sim.run(steps=2)


def test_land_rollout_refuses_user_bcs_series_and_snow():
    _, pg = _grids(4, 8)
    sim = tp.initialize(tp.LandModel(grid=pg), tp.ForwardEuler(dt=300.0),
                        initializers={"temperature": 5.0, "saturation_water_ice": 0.8},
                        boundary_conditions=tp.PrescribedSurfaceTemperature(3.0))
    with pytest.raises(ValueError, match="coupling BCs"):
        sim.run(steps=1)
    sim = tp.initialize(tp.LandModel(grid=pg), tp.ForwardEuler(dt=300.0),
                        (tp.TimeSeriesInputSource(times=np.array([0.0, 10.0, 30.0]), series={
                            "air_temperature": np.array([1.0, 2.0, 3.0])}),),
                        initializers={"temperature": 5.0, "saturation_water_ice": 0.8})
    with pytest.raises(ValueError, match="uniformly spaced"):
        sim.run(steps=1)
    with pytest.raises(ValueError, match="snowpack"):
        tp.LandModel(grid=pg, snow=object())
    with pytest.raises(ValueError, match="SoilModel|LandModel"):
        ls.LandParams.of(tp.SoilModel(grid=pg), torch.float64)


def test_explicit_step_routes_flux_bcs_by_declared_rank():
    """``explicit_step`` adds a top Flux BC to an XY prognostic as it is and
    to an XYZ one over dz_top, resolving ``InputRef`` values (scale times the
    named field), as the JAX package's does (`stepping.py:62-83`)."""
    from terrarium_tpu.timesteppers.stepping import explicit_step as jstep, prog_xy_map
    from terrarium_tpu_torch.timesteppers.stepping import explicit_step as pstep

    jm, js, pm, ps, _, _ = _both("bare_richards", 0)
    bcs = {"skin_temperature": {"top": tt.Flux(tt.ops.bcs.InputRef("infiltration", -2.0))},
           "internal_energy": {"top": tt.Flux("ground_heat_flux")},
           "saturation_water_ice": {"top": tt.Flux(tt.ops.bcs.InputRef("infiltration", -1.0))}}
    pbcs = {"skin_temperature": {"top": tp.Flux(tp.InputRef("infiltration", -2.0))},
            "internal_energy": {"top": tp.Flux("ground_heat_flux")},
            "saturation_water_ice": {"top": tp.Flux(tp.InputRef("infiltration", -1.0))}}
    rng = np.random.default_rng(5)
    tend = {k: rng.normal(size=np.shape(v)) for k, v in js.tendencies.items()}
    js = dataclasses.replace(js, tendencies={k: jnp.asarray(v) for k, v in tend.items()})
    ps.tendencies = {k: torch.as_tensor(v) for k, v in tend.items()}
    js = jstep(js, jm.grid, bcs, 600.0, xy=prog_xy_map(jm))
    pstep(pm, ps, pbcs, 600.0)
    _same(ps, js, list(ps.prognostic))
    infil = np.asarray(js.infiltration)
    assert np.abs(infil).max() > 0.0


@pytest.mark.parametrize("composition", ["bare", "coupled"])
def test_heun_land_model_through_the_modules(composition):
    """Heun with a LandModel, which the land rollout refuses, steps through
    the process modules (``Simulation.timestep``) as JAX's does: 4 steps of
    300 s at 1e-12."""
    jg, pg = _grids(6, 8)
    inits = {"temperature": 6.0, "saturation_water_ice": 0.6}
    if composition == "coupled":
        inits.update(carbon_vegetation=2.0, vegetation_area_fraction=0.5)
    sims = [m.initialize(land_model(m, g, composition), m.Heun(dt=300.0), initializers=inits,
                         input_sources=(m.FieldInputSource(fields={
                             "surface_shortwave_down": 400.0, "air_temperature": 12.0,
                             "rainfall": 1.0e-7}),))
            for m, g in ((tt, jg), (tp, pg))]
    for _ in range(4):
        for sim in sims:
            sim.timestep()
    assert_fields_close(sims[1].state, sims[0].state, sorted(sims[1].state.prognostic))
