"""The hand-derived reference-parity pins of `tests/test_parity_pins.py:77-287`
(the SEB's fused sweep with the implicit skin temperature, PALADYN canopy
interception and evapotranspiration, LUE photosynthesis, Medlyn stomatal
conductance, direct surface runoff) and `tests/test_parity_pins_veg.py:41-165`
(PALADYN autotrophic respiration, carbon dynamics, vegetation dynamics,
phenology, the root distribution with the plant-available water),
reproduced on the port's modules: the same state points and the same
expectations, transcribed by hand from the reference's formulas in plain
``math`` (the JAX tests' own helpers, imported), at rtol 1e-12.
"""
import math

import numpy as np
import torch

import terrarium_tpu_torch as tp

from test_parity_pins import C_H, _photo_expected, _seb_expected, humidity_vpd
from test_parity_pins_veg import f_temp

F64 = torch.float64


def _grid(cells=3, nz=5):
    return tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=F64,
                            device="cpu")


def _set(state, names, pts):
    """Set each named XY field to its column of ``pts`` (one row per state
    point)."""
    arr = np.array(pts, dtype=np.float64).T
    state.set(**{n: torch.as_tensor(arr[i]) for i, n in enumerate(names)})


def _close(got, expect, rtol=1e-12):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(), expect, rtol=rtol, atol=1e-300)


def test_seb_implicit_skin_pins():
    pts = [(8.0, 6.0, 12.0, 4.0e-3, 101325.0, 3.0, 600.0, 320.0),
           (-5.0, -8.0, -2.0, 1.5e-3, 98000.0, 7.0, 150.0, 250.0),
           (25.0, 22.0, 20.0, 1.0e-2, 95000.0, 1.0, 900.0, 400.0)]
    grid = _grid()
    model = tp.SurfaceEnergyModel(grid=grid)
    sim = tp.initialize(model, tp.ForwardEuler())
    dz1 = float(grid.vertical.dz[-1])
    state = sim.state
    _set(state, ("skin_temperature", "ground_temperature", "air_temperature",
                 "specific_humidity", "air_pressure", "windspeed", "surface_shortwave_down",
                 "surface_longwave_down"), pts)
    model.compute_auxiliary(state, sim.ctx)
    expect = np.array([_seb_expected(*p, dz1=dz1) for p in pts]).T
    for i, name in enumerate(("skin_temperature", "surface_shortwave_up", "surface_longwave_up",
                              "surface_net_radiation", "sensible_heat_flux",
                              "latent_heat_flux", "ground_heat_flux")):
        _close(state[name], expect[i])


def test_canopy_interception_pins():
    alpha_int, k_ext, w_max_p, tau = 0.2, 0.5, 2.0e-4, 86400.0
    pts = [(2.0e-7, 4.0, 1.0, 3.0e-4), (5.0e-8, 0.5, 0.1, 1.0e-5), (1.0e-6, 8.0, 2.0, 0.0)]
    expect = []
    for rain, LAI, SAI, w in pts:
        I = alpha_int * rain * (1.0 - math.exp(-k_ext * (LAI + SAI)))
        R = max(w, 0.0) / tau
        expect.append((I, R, w / (w_max_p * (LAI + SAI)), rain - I + R))
    expect = np.array(expect).T
    grid = _grid()
    model = tp.LandModel(grid=grid, vegetation=tp.VegetationCarbon())
    sim = tp.initialize(model, tp.ForwardEuler())
    state = sim.state
    _set(state, ("rainfall", "leaf_area_index", "SAI", "canopy_water"), pts)
    model.surface_hydrology.canopy_interception.compute_auxiliary(state, grid, model.atmosphere,
                                                                  sim.ctx)
    for i, name in enumerate(("canopy_water_interception", "canopy_water_removal",
                              "saturation_canopy_water", "rainfall_ground")):
        _close(state[name], expect[i])


def test_canopy_evapotranspiration_pins():
    C_can, beta = 0.006, 0.65
    pts = [(15.0, 12.0, 18.0, 6.0e-3, 101325.0, 2.5, 4.0, 1.0, 8.0e-3, 0.3),
           (2.0, 1.0, 5.0, 3.0e-3, 99000.0, 6.0, 1.0, 0.2, 2.0e-3, 0.05),
           (28.0, 25.0, 24.0, 1.2e-2, 96000.0, 0.8, 6.0, 1.5, 1.5e-2, 0.9)]
    expect = []
    for Ts, Tg, Ta, q, p, V, LAI, SAI, gw, f_can in pts:
        ra = 1.0 / (C_H * max(V, 1e-6))
        re = (1.0 - math.exp(-LAI - SAI)) / (C_can * V)
        dq_s, dq_g = humidity_vpd(Ts, q, p), humidity_vpd(Tg, q, p)
        expect.append((dq_s / (ra + 1.0 / gw), beta * dq_g / (ra + re), f_can * dq_s / ra))
    expect = np.array(expect).T
    grid = _grid()
    evtr = tp.PALADYNCanopyEvapotranspiration(
        ground_resistance=tp.ConstantEvaporationResistanceFactor(beta))
    sh = tp.SurfaceHydrology(evapotranspiration=evtr)
    model = tp.LandModel(grid=grid, vegetation=tp.VegetationCarbon(), surface_hydrology=sh)
    sim = tp.initialize(model, tp.ForwardEuler())
    state = sim.state
    _set(state, ("skin_temperature", "ground_temperature", "air_temperature",
                 "specific_humidity", "air_pressure", "windspeed", "leaf_area_index", "SAI",
                 "canopy_water_conductance", "saturation_canopy_water"), pts)
    evtr.compute_auxiliary(state, grid, sh.canopy_interception, model.constants,
                           model.atmosphere, None, model.vegetation, sim.ctx)
    for i, name in enumerate(("transpiration", "evaporation_ground", "evaporation_canopy")):
        _close(state[name], expect[i])


def test_photosynthesis_pins():
    pts = [(20.0, 600.0, 101325.0, 380.0, 4.0, 0.8, 0.9),
           (5.0, 200.0, 98000.0, 420.0, 1.5, 0.7, 0.5),
           (35.0, 900.0, 95000.0, 380.0, 6.0, 0.85, 1.0),
           (-5.0, 500.0, 101325.0, 380.0, 4.0, 0.8, 1.0),   # cold gate
           (20.0, 600.0, 101325.0, 380.0, 0.0, 0.8, 1.0)]   # no leaves
    photo, c = tp.LUEPhotosynthesis(), tp.PhysicalConstants()
    for p in pts:
        got = photo.compute(c, *[torch.tensor(v, dtype=F64) for v in p])
        for g, e in zip(got, _photo_expected(*p)):
            np.testing.assert_allclose(float(g), e, rtol=1e-12, atol=1e-300)


def test_medlyn_stomatal_pins():
    g1, g_min, k_ext = 2.3, 0.5, 0.5
    sc, photo = tp.MedlynStomatalConductance(), tp.LUEPhotosynthesis()
    for vpd, An, co2, LAI, beta in [(800.0, 2.0e-4, 380.0, 4.0, 0.9),
                                    (150.0, 5.0e-5, 420.0, 1.0, 0.4),
                                    (2500.0, 8.0e-4, 380.0, 7.0, 1.0)]:
        g0 = g_min / 1000.0 * (1.0 - math.exp(-k_ext * LAI)) * beta
        e_gw = g0 + 1.6 * (1.0 + g1 / math.sqrt(vpd)) * An / co2 * 1.0e6
        e_lc = 1.0 - 1.0 / (1.0 + g1 / math.sqrt(vpd * 1.0e-3))
        t = [torch.tensor(v, dtype=F64) for v in (vpd, An, co2, LAI, beta)]
        np.testing.assert_allclose(float(sc.gw_can(photo, *t)), e_gw, rtol=1e-12)
        np.testing.assert_allclose(float(sc.lambda_c(t[0])), e_lc, rtol=1e-12)


def test_direct_surface_runoff_pins():
    tau = 3600.0
    pts = [(2.0e-7, 5.0e-3, 1.0e-6, 0.8), (5.0e-7, 0.0, 1.0e-7, 0.6),
           (3.0e-7, 1.0e-3, 1.0e-6, 1.0)]  # (rain, S, K_top, sat_top)
    expect = []
    for rain, S, K, sat in pts:
        drainage = (max(S, 0.0) / tau) if S > 0.0 else 0.0
        influx = drainage if S > 0.0 else rain
        infil = min(influx, K) * (1.0 if sat < 1.0 else 0.0)
        expect.append((infil, rain + drainage - infil))
    expect = np.array(expect).T
    grid = _grid()
    soil = tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq()))
    model = tp.LandModel(grid=grid, soil=soil)
    sim = tp.initialize(model, tp.ForwardEuler(),
                        initializers={"temperature": 1.0, "saturation_water_ice": 0.5})
    arr = np.array(pts).T
    state = sim.state
    state.set(rainfall_ground=torch.as_tensor(arr[0]),
              surface_excess_water=torch.as_tensor(arr[1]),
              hydraulic_conductivity=torch.as_tensor(np.broadcast_to(arr[2], (grid.nz + 1, 3))
                                                     .copy()),
              saturation_water_ice=torch.as_tensor(np.broadcast_to(arr[3], (grid.nz, 3)).copy()))
    sh = model.surface_hydrology
    sh.surface_runoff.compute_auxiliary(state, grid, sh.canopy_interception, soil, sim.ctx)
    _close(state.infiltration, expect[0])
    _close(state.surface_runoff, expect[1])


# ---------------------------------------------------------------------------
# tests/test_parity_pins_veg.py:41-165
# ---------------------------------------------------------------------------
def _veg_sim():
    grid = _grid()
    model = tp.LandModel(grid=grid, vegetation=tp.VegetationCarbon())
    return tp.initialize(model, tp.ForwardEuler()), model, grid


def test_autotrophic_respiration_pins():
    SLA, awl, aws, cn_sap, cn_root, resp10 = 10.0, 2.0, 10.0, 330.0, 29.0, 0.066
    pts = [(15.0, 10.0, 0.4, 1.0, 2.0, 5.0e-8), (5.0, 5.0, 0.1, 0.7, 0.5, 1.0e-8),
           (25.0, 12.0, 1.2, 1.0, 6.0, 2.0e-7)]  # (T_air, T_soil, Rd, phen, C_veg, GPP)
    expect = []
    for Ta, Tg, Rd, phen, C, GPP in pts:
        f_soil = f_temp(Tg) if Tg > 7.0 else 0.0
        R_stem = resp10 * f_temp(Ta) * (awl * ((2.0 / SLA) + awl)) / (C * aws * cn_sap)
        R_root = resp10 * f_soil * phen * (2.0 / SLA) / (SLA * C * cn_root)
        Rm = Rd / 1000.0 + R_stem + R_root
        Ra = Rm + 0.25 * (GPP - Rm)
        expect.append((Ra, GPP - Ra))
    expect = np.array(expect).T
    sim, model, grid = _veg_sim()
    state = sim.state
    _set(state, ("air_temperature", "ground_temperature", "daily_leaf_respiration",
                 "phenology_factor", "carbon_vegetation", "gross_primary_production"), pts)
    veg = model.vegetation
    veg.autotrophic_respiration.compute_auxiliary(state, grid, veg.carbon_dynamics,
                                                  model.atmosphere, sim.ctx)
    _close(state.autotrophic_respiration, expect[0])
    _close(state.net_primary_production, expect[1])


def test_carbon_dynamics_pins():
    SLA, awl, gL, gR, gS, LAI_min, LAI_max = 10.0, 2.0, 0.3, 0.3, 0.05, 1.0, 6.0
    pts = [(1.1, 3.0e-8), (6.6, 5.0e-8), (15.4, 8.0e-8)]  # (C_veg, NPP)
    expect = []
    for C, NPP in pts:
        LAI_b = C / ((2.0 / SLA) + awl)
        if LAI_b < LAI_min:
            lam = 0.0
        elif LAI_b <= LAI_max:
            lam = (LAI_b - LAI_min) / (LAI_max - LAI_min)
        else:
            lam = 1.0
        expect.append((LAI_b, (1.0 - lam) * NPP - (gL / SLA + gR / SLA + gS * awl) * LAI_b))
    expect = np.array(expect).T
    sim, model, grid = _veg_sim()
    state = sim.state
    _set(state, ("carbon_vegetation", "net_primary_production"), pts)
    cd = model.vegetation.carbon_dynamics
    cd.compute_auxiliary(state, grid, sim.ctx)
    _close(state.balanced_leaf_area_index, expect[0])
    state.tendencies["carbon_vegetation"] = torch.zeros(3, dtype=F64)
    cd.compute_tendencies(state, grid, sim.ctx)
    _close(state.tendencies["carbon_vegetation"], expect[1])


def test_vegetation_dynamics_pins():
    nu_seed, gamma_v, LAI_min, LAI_max = 0.001, 0.002, 1.0, 6.0
    pts = [(6.6, 5.0e-8, 0.5), (6.6, 5.0e-8, 0.0005), (2.2, -2.0e-8, 0.9)]  # (C, NPP, nu)
    expect = []
    for C, NPP, nu in pts:
        lam = min(max((C / 2.2 - LAI_min) / (LAI_max - LAI_min), 0.0), 1.0)
        nu_star = max(nu, nu_seed)
        expect.append((lam * NPP / C) * nu_star * (1.0 - nu) - gamma_v * nu_star)
    sim, model, grid = _veg_sim()
    state = sim.state
    _set(state, ("carbon_vegetation", "net_primary_production", "vegetation_area_fraction"), pts)
    cd = model.vegetation.carbon_dynamics
    cd.compute_auxiliary(state, grid, sim.ctx)
    state.tendencies["vegetation_area_fraction"] = torch.zeros(3, dtype=F64)
    model.vegetation.vegetation_dynamics.compute_tendencies(state, grid, cd, sim.ctx)
    _close(state.tendencies["vegetation_area_fraction"], np.array(expect))


def test_phenology_pins():
    sim, model, grid = _veg_sim()
    state = sim.state
    LAI_b = torch.tensor([0.5, 3.0, 7.0], dtype=F64)
    state.set(balanced_leaf_area_index=LAI_b)
    model.vegetation.phenology.compute_auxiliary(state, grid, sim.ctx)
    np.testing.assert_allclose(state.phenology_factor.numpy(), 1.0)
    _close(state.leaf_area_index, LAI_b.numpy(), rtol=1e-15)


def test_root_distribution_paw_pins():
    a, b, N, dz = 7.0, 2.0, 4, 0.25
    zc = [-(N - k - 0.5) * dz for k in range(N)]  # centres, k = 0 the bottom
    R = [0.5 * (a * math.exp(a * z) + b * math.exp(b * z)) * dz for z in zc]
    R = [r / sum(R) for r in R]
    fc, wp, por = 0.25, 0.05, 0.49
    sats = [0.1, 0.3, 0.5, 0.8]
    W = [min(max((s * por - wp) / (fc - wp), 0.0), 1.0) for s in sats]
    beta = sum(w * r for w, r in zip(W, R))
    grid = tp.ColumnGrid.of(cells=2, spacing=tp.UniformSpacing(dz=dz, N=N), dtype=F64,
                            device="cpu")
    props = tp.ConstantSoilHydraulics(field_capacity_value=fc, wilting_point_value=wp)
    soil = tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(hydraulic_properties=props))
    model = tp.LandModel(grid=grid, vegetation=tp.VegetationCarbon(), soil=soil)
    sim = tp.initialize(model, tp.ForwardEuler(), initializers={"temperature": 5.0})
    _close(sim.state.root_fraction[:, 0], np.array(R))
    state = sim.state
    state.set(saturation_water_ice=torch.as_tensor(np.array(sats)[:, None] * np.ones((1, 2))),
              liquid_water_fraction=torch.ones((N, 2), dtype=F64))
    model.vegetation.plant_available_water.compute_auxiliary(state, grid, soil, sim.ctx)
    _close(state.plant_available_water[:, 0], np.array(W))
    _close(state.soil_moisture_limiting_factor, np.full(2, beta))
