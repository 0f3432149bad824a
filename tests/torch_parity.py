"""Builders shared by the ``test_torch_*`` files: one soil configuration set
up in the JAX package and in the PyTorch port from the same numbers."""
import dataclasses

import numpy as np
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp

#: the configurations of `tests/test_goldens.py:20-36` ("golden") and
#: `bench.py:43-64` ("bench"): field initializers (numpy, shared by both
#: packages) and the top temperature BC as (jax form, torch form)
CONFIGS = {
    "golden": dict(
        inits={"temperature": lambda x, z: 2.0 * np.sin(2 * np.pi * x) - 0.05 * z,
               "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.6 - 0.05 * z)},
        bc_jax=lambda t: -5.0 + 0.0 * t,
        bc_torch=lambda t: -5.0 + 0.0 * t),
    "bench": dict(
        inits={"temperature": lambda x, z: 1.0 + 0.0 * z,
               "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.5 - 0.05 * z)},
        bc_jax=lambda t: 5.0 * tt_sin(2 * np.pi * t / 86400.0),
        bc_torch=lambda t: 5.0 * torch.sin(2 * torch.pi * t / 86400.0)),
}


def tt_sin(x):
    import jax.numpy as jnp

    return jnp.sin(x)


def jax_soil():
    props = tt.ConstantSoilHydraulics(swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
                                      unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
    return tt.SoilEnergyWaterCarbon(hydrology=tt.SoilHydrology(
        vertical_flow=tt.RichardsEq(), hydraulic_properties=props))


def port_soil():
    props = tp.ConstantSoilHydraulics(swrc=tp.VanGenuchten(alpha=2.0, n=2.0),
                                      unsat_hydraulic_cond=tp.UnsatKVanGenuchten())
    return tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(
        vertical_flow=tp.RichardsEq(), hydraulic_properties=props))


def jax_sim(config, cells, nz, dt=300.0, nf=np.float64):
    grid = tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=nz), nf=nf)
    cfg = CONFIGS[config]
    return tt.initialize(tt.SoilModel(grid=grid, soil=jax_soil()), tt.ForwardEuler(dt=dt),
                         initializers=cfg["inits"],
                         boundary_conditions=tt.PrescribedSurfaceTemperature(cfg["bc_jax"]))


def port_sim(config, cells, nz, dt=300.0, dtype=torch.float64, device="cpu"):
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz),
                            dtype=dtype, device=device)
    cfg = CONFIGS[config]
    return tp.initialize(tp.SoilModel(grid=grid, soil=port_soil()), tp.ForwardEuler(dt=dt),
                         initializers=cfg["inits"],
                         boundary_conditions=tp.PrescribedSurfaceTemperature(cfg["bc_torch"]))


def jax_state_arrays(state):
    """A JAX state's fields as ``{"<group>/<name>": ndarray}`` (the input
    of `terrarium_tpu_torch.convert.state_from_numpy`)."""
    return {f"{g}/{k}": np.asarray(v)
            for g in ("prognostic", "tendencies", "auxiliary", "inputs")
            for k, v in getattr(state, g).items()}


def assert_fields_close(port_state, jax_state, names, rtol=1e-12, rel_atol=1e-12):
    """Each named field agrees to ``rtol``, with an absolute floor of
    ``rel_atol`` times the field's largest magnitude (differences of nearly
    equal fluxes lose relative precision near zero)."""
    for name in names:
        ref = np.asarray(jax_state[name])
        got = port_state[name].detach().cpu().numpy()
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=rtol,
                                   atol=rel_atol * max(float(np.max(np.abs(ref))), 1e-300),
                                   err_msg=name)


def hold_until_saturation_flip(a, b, tol):
    """Hold two implicit rollouts of the same columns, step by step, until
    each column meets the saturation threshold.

    ``a`` and ``b`` yield, step by step, ``(saturated, (U, sat, S))``: the
    ``se >= 1`` mask of the closed column at the start of the step and the
    carry after it. A column is held (``|x_a - x_b| <= tol * max|x_b|`` in
    each field) until the first step at whose start the two sides put one of
    its levels on opposite sides of saturation, where d(Psi)/d(sat) jumps
    from about 1e4 to 0 and the two sides solve different Richards rows;
    from then on it is let go. Returns the let-go columns and the largest
    saturation gap they reached."""
    flipped, gap = None, 0.0
    for i, ((sat_a, xa), (sat_b, xb)) in enumerate(zip(a, b)):
        flip = (sat_a != sat_b).any(0)
        flipped = flip if flipped is None else flipped | flip
        for name, u, v in zip(("U", "sat", "S"), xa, xb):
            d = (u - v).abs()
            part = (d.amax(0) if d.dim() == 2 else d) > tol * float(v.abs().max())
            bad = part & ~flipped
            assert not bool(bad.any()), (
                f"step {i + 1}: {name} of columns {bad.nonzero().flatten().tolist()} parts "
                f"without a saturation flip")
        if bool(flipped.any()):
            gap = max(gap, float((xa[1] - xb[1]).abs()[:, flipped].max()))
    return flipped, gap


# ---------------------------------------------------------------------------
# forced configurations: the same numpy arrays into both packages
# ---------------------------------------------------------------------------
def _both(pkg):
    """(package, grid factory) of ``"jax"`` or ``"port"``."""
    if pkg == "jax":
        return tt, lambda cells, nz, dtype, device: tt.ColumnGrid.of(
            cells=cells, spacing=tt.ExponentialSpacing(N=nz),
            nf=np.float32 if dtype == torch.float32 else np.float64)
    return tp, lambda cells, nz, dtype, device: tp.ColumnGrid.of(
        cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=dtype, device=device)


def heun_forced(pkg, device="cpu"):
    """The ``heun_forced`` golden (`tests/test_goldens.py:67-89`): 4 cells,
    Nz 15, float64, Heun at dt 300, heat + Richards, a 2-hourly ``(T,
    cells)`` air temperature over one day."""
    m, grid_of = _both(pkg)
    soil = jax_soil() if pkg == "jax" else port_soil()
    times = np.arange(0.0, 86401.0, 7200.0)
    series = (np.linspace(-4.0, 8.0, 4)[None, :]
              + 6.0 * np.sin(2 * np.pi * times / 86400.0)[:, None])
    return m.initialize(
        m.SoilModel(grid=grid_of(4, 15, torch.float64, device), soil=soil), m.Heun(),
        initializers={"temperature": 1.0,
                      "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.7 - 0.04 * z)},
        boundary_conditions=m.PrescribedSurfaceTemperature("air_temperature"),
        input_sources=(m.TimeSeriesInputSource(times=times,
                                               series={"air_temperature": series}),))


def heun_n145_forcing(pkg, cells, nz=30, dtype=torch.float32, device="cpu", days=31):
    """``heun_n145_heat_richards_forcing`` (`bench_configs.py:414-449`) on
    ``cells`` columns: heat + Richards, Heun at dt 60, an hourly ``(T,
    cells)`` series 5 sin(2 pi t / 86400) over ``days`` days."""
    m, grid_of = _both(pkg)
    soil = jax_soil() if pkg == "jax" else port_soil()
    hours = np.arange(0.0, days * 86400.0, 3600.0)
    ts = (5.0 * np.sin(2 * np.pi * hours[:, None] / 86400.0)
          * np.ones((1, cells))).astype(np.float32)
    return m.initialize(
        m.SoilModel(grid=grid_of(cells, nz, dtype, device), soil=soil), m.Heun(dt=60.0),
        initializers=CONFIGS["bench"]["inits"],
        boundary_conditions=m.PrescribedSurfaceTemperature("surface_temperature"),
        input_sources=(m.TimeSeriesInputSource(times=hours,
                                               series={"surface_temperature": ts}),))


def heat_forcing(pkg, cells, nz=30, dtype=torch.float32, device="cpu", days=31):
    """``global_heat_n72_forcing`` (`bench_configs.py:202-225`) on ``cells``
    synthetic columns at latitudes evenly spaced from -60 to 80 degrees: the
    heat-only default model, ForwardEuler at dt 300, an hourly ``(T,
    cells)`` series T_mean + 8 sin(2 pi t / 86400), T_mean = 25 max(cos lat,
    0.05) - 5, also the initial temperature; saturation 0.8."""
    m, grid_of = _both(pkg)
    lat = np.linspace(-60.0, 80.0, cells)
    T_mean = 25.0 * np.maximum(np.cos(np.deg2rad(lat)), 0.05) - 5.0
    hours = np.arange(0.0, days * 86400.0, 3600.0)
    ts = (T_mean[None, :]
          + 8.0 * np.sin(2 * np.pi * hours[:, None] / 86400.0)).astype(np.float32)
    return m.initialize(
        m.SoilModel(grid=grid_of(cells, nz, dtype, device)), m.ForwardEuler(dt=300.0),
        initializers={"temperature": lambda x, z: T_mean[None, :] + 0.0 * z,
                      "saturation_water_ice": 0.8},
        boundary_conditions=m.PrescribedSurfaceTemperature("surface_temperature"),
        input_sources=(m.TimeSeriesInputSource(times=hours,
                                               series={"surface_temperature": ts}),))


def implicit_freeze(pkg, solver="pcr", device="cpu", picard_iters=1):
    """The ``implicit_freeze`` golden (`tests/test_goldens.py:92-113`): 6
    cells, Nz 16, float64, heat + Richards, ImplicitEuler at dt 3600 with
    ``solver``, top temperature -8 degC as ``f(t)``."""
    m, grid_of = _both(pkg)
    soil = jax_soil() if pkg == "jax" else port_soil()
    return m.initialize(
        m.SoilModel(grid=grid_of(6, 16, torch.float64, device), soil=soil),
        m.ImplicitEuler(dt=3600.0, solver=solver, picard_iters=picard_iters),
        initializers={"temperature": lambda x, z: 3.0 * np.cos(2 * np.pi * x) + 0.1 * z,
                      "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.65 - 0.04 * z)},
        boundary_conditions=m.PrescribedSurfaceTemperature(lambda t: -8.0 + 0.0 * t))


def column_implicit_tridiag(pkg, cells, solver="pcr", nz=30, dtype=torch.float32,
                            device="cpu"):
    """``column_implicit_tridiag`` (`bench_configs.py:141-199`) on ``cells``
    columns: the bench model, T = 1 degC, sat = min(1, 0.5 - 0.05 z),
    ImplicitEuler at dt 900 with ``solver``, top temperature 5 sin(2 pi t /
    86400) as ``f(t)``."""
    m, grid_of = _both(pkg)
    soil = jax_soil() if pkg == "jax" else port_soil()
    cfg = CONFIGS["bench"]
    return m.initialize(
        m.SoilModel(grid=grid_of(cells, nz, dtype, device), soil=soil),
        m.ImplicitEuler(dt=900.0, solver=solver), initializers=cfg["inits"],
        boundary_conditions=m.PrescribedSurfaceTemperature(
            cfg["bc_jax"] if pkg == "jax" else cfg["bc_torch"]))


# ---------------------------------------------------------------------------
# LandModel configurations: the same numbers into both packages
# ---------------------------------------------------------------------------
def land_model(pkg, grid, composition):
    """A LandModel of ``composition`` on ``grid`` in package ``pkg`` (``tt``
    or ``tp``): ``"bare"``, the default without vegetation (the golden's);
    ``"coupled"``, `tests/test_fused_step.py:201-253`'s (loam, Richards,
    ``VegetationCarbon.consistent_units()``, the rest default);
    ``"consistent"``, `examples/land_global.py`'s composition with
    ``DirectSurfaceRunoff.consistent()`` (`test_parity_robustness.py:105-117`);
    ``"parity"``, `bench_configs.py:228-267`'s (``VegetationCarbon()``, the
    rest default); ``"bare_richards"``, the land-step pin's
    (`test_parity_pins_land_step.py:173-189`); ``"snow"``, the
    ``land_snow`` golden's (`tests/test_goldens.py:52-64`: bare ground,
    Richards flow over the default hydraulics, ``Snowpack()``);
    ``"consistent_snow"``, ``"consistent"`` with ``Snowpack()``."""
    m = pkg
    if composition == "bare":
        return m.LandModel(grid=grid)
    if composition == "snow":
        return m.LandModel(grid=grid, snow=m.Snowpack(), soil=m.SoilEnergyWaterCarbon(
            hydrology=m.SoilHydrology(vertical_flow=m.RichardsEq())))
    if composition == "consistent_snow":
        return dataclasses.replace(land_model(pkg, grid, "consistent"), snow=m.Snowpack())
    loam = m.HomogeneousStratigraphy(texture=m.SoilTexture.preset("loam"))
    if composition == "bare_richards":
        return m.LandModel(grid=grid, soil=m.SoilEnergyWaterCarbon(
            strat=loam, hydrology=m.SoilHydrology(
                vertical_flow=m.RichardsEq(), hydraulic_properties=m.ConstantSoilHydraulics(
                    sat_hydraulic_cond=1.0e-6, swrc=m.VanGenuchten(alpha=2.0, n=2.0),
                    unsat_hydraulic_cond=m.UnsatKLinear()))))
    soil = m.SoilEnergyWaterCarbon(strat=loam,
                                   hydrology=m.SoilHydrology(vertical_flow=m.RichardsEq()))
    if composition == "coupled":
        return m.LandModel(grid=grid, vegetation=m.VegetationCarbon.consistent_units(), soil=soil)
    if composition == "parity":
        return m.LandModel(grid=grid, vegetation=m.VegetationCarbon(), soil=soil)
    assert composition == "consistent", composition
    return m.LandModel(
        grid=grid, vegetation=m.VegetationCarbon.consistent_units(), soil=soil,
        atmosphere=m.PrescribedAtmosphere(aerodynamics=m.MoninObukhovAerodynamics()),
        surface_energy_balance=m.SurfaceEnergyBalance.consistent(),
        surface_hydrology=m.SurfaceHydrology(
            evapotranspiration=m.PALADYNCanopyEvapotranspiration.consistent_units(
                ground_resistance=m.SoilMoistureResistanceFactor()),
            surface_runoff=m.DirectSurfaceRunoff.consistent()))


def land_random_state(seed, cells, nz, extremes=True):
    """Random legal LandModel fields, ``{name: ndarray}``, that reach every
    clamp and branch of the land step: drained, saturated, over-saturated
    and spilling soil columns, frozen, thawing and thawed energies, negative,
    empty and full pools, skin temperatures far from the ground's, empty,
    partly and over-full canopies, vegetation carbon across both ends of the
    LAI ramp, fractions below the seed, snowpacks negative, empty and deep,
    and inputs across every threshold (cold and hot air, night, calm wind,
    saturated air, snowfall on and off). ``extremes``: the
    last four columns' skin temperatures 120-250 K off in a 12 m/s wind,
    which reach the skin clamp and the saturation-pressure clip in one step
    and take the explicit coupling non-finite within a few."""
    rng = np.random.default_rng(seed)
    sat = rng.uniform(0.05, 0.95, (nz, cells))
    q = cells // 8
    sat[:, 0:q] = 0.0
    sat[: nz // 2, q:2 * q] = 1.0
    sat[nz // 2: nz // 2 + 2, 2 * q:3 * q] = rng.uniform(1.0, 1.3, (2, q))
    sat[-1, 3 * q:4 * q] = 1.2
    sat[-1, 4 * q:5 * q] = rng.uniform(0.4, 0.65, q)  # about field capacity
    L_theta = 3.34e8 * np.clip(sat, 0.0, None) * 0.49
    U = rng.uniform(-1.5e8, 4e7, (nz, cells))
    U[:, 5 * q:6 * q] = -L_theta[:, 5 * q:6 * q] - rng.uniform(1e6, 1e7, (nz, q))
    U[:, 6 * q:7 * q] = -0.5 * L_theta[:, 6 * q:7 * q]
    skin = rng.uniform(-30.0, 60.0, cells)
    wind = rng.uniform(0.0, 12.0, cells) * rng.choice([1e-3, 1.0], cells)
    if extremes:
        skin[-4:] = (250.0, -200.0, 180.0, -120.0)
        wind[-4:] = 12.0
    return dict(
        internal_energy=U, saturation_water_ice=sat,
        surface_excess_water=rng.choice([-1e-3, 0.0, 2e-3], cells) * rng.uniform(0, 1, cells),
        skin_temperature=skin,
        canopy_water=rng.uniform(-1e-4, 2e-3, cells),
        carbon_vegetation=rng.uniform(0.5, 15.0, cells),
        vegetation_area_fraction=rng.uniform(0.0, 1.0, cells) * rng.choice([1e-3, 1.0], cells),
        net_assimilation=rng.uniform(-1e-4, 1e-3, cells),
        air_temperature=rng.uniform(-10.0, 45.0, cells),
        surface_shortwave_down=rng.uniform(0.0, 1000.0, cells) * rng.choice([0.0, 1.0], cells),
        surface_longwave_down=rng.uniform(200.0, 420.0, cells),
        rainfall=rng.uniform(0.0, 2e-6, cells),
        windspeed=wind,
        air_pressure=rng.uniform(8.0e4, 1.05e5, cells),
        specific_humidity=rng.uniform(0.0, 0.03, cells),
        CO2=rng.uniform(300.0, 500.0, cells),
        SAI=rng.uniform(0.0, 2.0, cells),
        daily_leaf_respiration=rng.uniform(0.0, 0.1, cells),
        snowfall=rng.uniform(0.0, 1e-6, cells) * rng.choice([0.0, 1.0], cells),
        snow_water_equivalent=np.where(np.arange(cells) % 9 == 4, -5e-4, rng.uniform(
            0.0, 5e-2, cells) * rng.choice([0.0, 1.0], cells)))
