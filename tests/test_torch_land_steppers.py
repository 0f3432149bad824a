"""The land rollouts of Heun and ImplicitEuler (Thomas, PCR; one Picard
iteration, and two or three), with and without a snowpack, against the JAX package at
float64: the port's ``Simulation.run`` (on the CPU the plain version, the
process modules stepped by the same stepper's ``pre_closure_step``)
against JAX's ``run`` (its lean scan of the modules) and against JAX's
``make_fused_lean_rollout(..., interpret=True)`` (the Pallas kernel through
its interpreter), `test_implicit_land_model`'s composition, and the
refusals by type.

The forced configuration is `tests/test_fused_step.py:201-253`'s on 8
columns at latitudes from -60 to 80 degrees, Nz 8: hourly shortwave and
air-temperature series over two days, static longwave, rain, snowfall, wind
and humidity. Heun runs at dt 60 s: at 600 s its explicit Richards step over
the 5 cm top layer is unstable (ROADMAP Queue C, the LandModel's
instability), where rounding differences grow to O(1). ImplicitEuler runs
at 600 s, where it is stable.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.ops.fused_step import make_fused_lean_rollout
from terrarium_tpu_torch.ops import land_step as ls
from terrarium_tpu_torch.timesteppers import integrator

from torch_parity import assert_fields_close, land_model

CELLS, NZ = 8, 8
STEPPERS = {"heun": (lambda m: m.Heun(dt=60.0)),
            "implicit-pcr": (lambda m: m.ImplicitEuler(dt=600.0, solver="pcr")),
            "implicit-thomas": (lambda m: m.ImplicitEuler(dt=600.0, solver="thomas")),
            "implicit-pcr-2": (lambda m: m.ImplicitEuler(dt=600.0, solver="pcr",
                                                         picard_iters=2)),
            "implicit-thomas-2": (lambda m: m.ImplicitEuler(dt=600.0, solver="thomas",
                                                            picard_iters=2)),
            "implicit-pcr-3": (lambda m: m.ImplicitEuler(dt=600.0, solver="pcr",
                                                         picard_iters=3)),
            "euler": (lambda m: m.ForwardEuler(dt=300.0))}


def _grid(m, cells=CELLS, nz=NZ):
    if m is tt:
        return tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=nz), nf=np.float64)
    return tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz),
                            dtype=torch.float64, device="cpu")


def _forced(m, composition, stepper):
    """The forced configuration (module docstring) in package ``m``."""
    grid = _grid(m)
    hours = np.arange(0.0, 48 * 3600.0, 3600.0)
    day = hours / 86400.0
    coslat = np.cos(np.deg2rad(np.linspace(-60.0, 80.0, CELLS)))
    sw = 800.0 * np.maximum(0.0, np.sin(2 * np.pi * (day[:, None] - 0.25))) * coslat[None, :]
    ta = (2.0 + 8.0 * np.sin(2 * np.pi * (day[:, None] - 0.3))) * np.ones((1, CELLS))
    model = land_model(m, grid, composition)
    names = {v.name for v in model.variables()}
    inits = {"temperature": 4.0, "saturation_water_ice": 0.6}
    inits.update({k: v for k, v in (("carbon_vegetation", 2.0), ("vegetation_area_fraction", 0.5),
                                    ("snow_water_equivalent", 0.01)) if k in names})
    return m.initialize(
        model, STEPPERS[stepper](m),
        (m.TimeSeriesInputSource(times=hours, series={"surface_shortwave_down": sw,
                                                      "air_temperature": ta}),
         m.FieldInputSource(fields={"surface_longwave_down": 330.0, "rainfall": 4.0e-8,
                                    "snowfall": 2.0e-8, "windspeed": 3.0,
                                    "specific_humidity": 0.006})),
        initializers=inits)


def _spy_plain(monkeypatch):
    """Record the stepper, solver and Picard count (None where the call
    names none) of each call of the plain land rollout."""
    calls = []
    plain = ls.land_column_rollout_plain

    def spy(*args, stepper="euler", solver=None, **kw):
        calls.append((stepper, solver, kw.get("picard_iters")))
        return plain(*args, stepper=stepper, solver=solver, **kw)

    monkeypatch.setattr(ls, "land_column_rollout_plain", spy)
    return calls


def _assert_prognostics_close(psim_state, jstate, names):
    """Every prognostic at 1e-12 (relative, with a floor of 1e-12 of the
    field's magnitude), the saturation at 1e-10: JAX's closed-form
    saturation adjustment rounds apart from the port's sweeps (ROADMAP
    Queue C; `test_torch_land.py::test_coupled_configuration_matches_jax_f64`)."""
    assert_fields_close(psim_state, jstate, [n for n in names if n != "saturation_water_ice"])
    assert_fields_close(psim_state, jstate, ["saturation_water_ice"], rtol=1e-10,
                        rel_atol=1e-10)


CASES = [("heun", "consistent"), ("heun", "snow"), ("heun", "consistent_snow"),
         ("implicit-pcr", "consistent"), ("implicit-thomas", "consistent"),
         ("implicit-pcr", "snow"), ("implicit-thomas", "consistent_snow"),
         ("euler", "consistent_snow"), ("implicit-pcr-2", "consistent"),
         ("implicit-thomas-2", "consistent"), ("implicit-pcr-3", "consistent"),
         ("implicit-pcr-2", "consistent_snow"), ("implicit-thomas-2", "snow")]


@pytest.mark.parametrize("stepper,composition", CASES)
def test_land_rollout_matches_jax_run(stepper, composition, monkeypatch):
    """12 steps through the land rollout (``column_scheme`` gives the land
    scheme of the stepper, and ``run`` calls the plain version with it, its
    solver and its Picard count) against JAX's ``run``: every prognostic,
    and the snowpack's auxiliaries after the trailing
    ``compute_auxiliary``."""
    jsim, psim = _forced(tt, composition, stepper), _forced(tp, composition, stepper)
    name = stepper.partition("-")[0]
    assert integrator.column_scheme(psim.model, psim.timestepper, psim.ctx,
                                    psim.input_sources) == ("land", name)
    calls = _spy_plain(monkeypatch)
    dt = psim.timestepper.default_dt()
    jsim.run(steps=12, dt=dt)
    psim.run(steps=12, dt=dt)
    assert calls == [(name, getattr(psim.timestepper, "solver", None),
                      getattr(psim.timestepper, "picard_iters", 1))]
    _assert_prognostics_close(psim.state, jsim.state, sorted(psim.state.prognostic))
    if psim.model.snow is not None:
        assert_fields_close(psim.state, jsim.state, ["snow_cover_fraction", "snow_melt",
                                                     "surface_shortwave_up"])
    assert psim.iteration == 12


FUSED_CASES = [("heun", "consistent"), ("implicit-thomas", "consistent"),
               ("implicit-pcr", "snow"), ("euler", "snow"), ("implicit-pcr-2", "consistent"),
               ("implicit-thomas-2", "consistent"), ("implicit-pcr-3", "consistent_snow")]


@pytest.mark.parametrize("stepper,composition", FUSED_CASES)
def test_land_rollout_matches_jax_fused_interpret(stepper, composition):
    """8 steps of the port's land rollout (``advance``: the plain version,
    no trailing ``compute_auxiliary``) against JAX's
    ``make_fused_lean_rollout(..., interpret=True)`` traced over the same
    LandModel step (two launches of 4 inner steps), every prognostic."""
    jsim, psim = _forced(tt, composition, stepper), _forced(tp, composition, stepper)
    dt = psim.timestepper.default_dt()
    fused = make_fused_lean_rollout(jsim.model, jsim.timestepper, jsim.ctx, jsim.input_sources,
                                    dt=dt, inner_steps=4, block_cells=128, interpret=True)
    jstate = jax.jit(lambda s: fused(s, 8))(jsim.state)
    integrator.advance(psim.model, psim.state, psim.ctx, 8, dt, timestepper=psim.timestepper,
                       input_sources=psim.input_sources)
    _assert_prognostics_close(psim.state, jstate, sorted(psim.state.prognostic))


@pytest.mark.parametrize("interception", ["PALADYNCanopyInterception", "NoCanopyInterception"])
def test_implicit_land_model_reproduced(interception):
    """`tests/test_implicit.py:141-172`: ImplicitEuler drives the bare-ground
    LandModel (VG, Mualem, K_sat 1e-6, loam, the consistent SEB, consistent
    evaporation) stably at dt 900 for a day: finite, saturation in [0, 1],
    and JAX's run at 1e-12 (the saturation at 1e-10). The test's own
    composition keeps the default PALADYN interception without vegetation,
    which the land rollout refuses by type, so ``run`` steps the modules;
    with ``NoCanopyInterception`` the same model goes through the land
    rollout."""
    def make(m):
        props = m.ConstantSoilHydraulics(swrc=m.VanGenuchten(alpha=2.0, n=2.0),
                                         unsat_hydraulic_cond=m.UnsatKVanGenuchten(),
                                         sat_hydraulic_cond=1e-6)
        soil = m.SoilEnergyWaterCarbon(
            strat=m.HomogeneousStratigraphy(texture=m.SoilTexture.preset("loam")),
            hydrology=m.SoilHydrology(vertical_flow=m.RichardsEq(), hydraulic_properties=props))
        model = m.LandModel(
            grid=_grid(m, 2, 15), soil=soil,
            surface_energy_balance=m.SurfaceEnergyBalance.consistent(),
            surface_hydrology=m.SurfaceHydrology(
                canopy_interception=getattr(m, interception)(),
                evapotranspiration=m.BareGroundEvaporation.consistent_units()))
        return m.initialize(model, m.ImplicitEuler(),
                            initializers={"temperature": 8.0, "saturation_water_ice": 0.7},
                            input_sources=(m.FieldInputSource(fields={
                                "surface_shortwave_down": 400.0, "air_temperature": 12.0,
                                "rainfall": 5.0e-8, "windspeed": 1.0}),))

    jsim, psim = make(tt), make(tp)
    assert integrator.column_scheme(psim.model, psim.timestepper, psim.ctx,
                                    psim.input_sources) == (
        None if interception == "PALADYNCanopyInterception" else ("land", "implicit"))
    jsim.run(steps=96, dt=900.0)
    psim.run(steps=96, dt=900.0)
    st = psim.state
    for name in ("temperature", "saturation_water_ice", "skin_temperature", "ground_heat_flux"):
        assert bool(torch.isfinite(st[name]).all()), name
    sat = st.saturation_water_ice
    assert bool(((sat >= 0.0) & (sat <= 1.0)).all())
    _assert_prognostics_close(st, jsim.state, sorted(st.prognostic))


@pytest.mark.parametrize("case", ["picard_iters=2", "PrescribedAlbedo"])
def test_land_steppers_refused_by_type_take_the_modules(case, monkeypatch):
    """A snowpack under a custom albedo (which the LandModel keeps) goes
    through the process modules of ``run``, never the land rollout, and
    matches JAX's ``run``. ImplicitEuler with two Picard iterations, which
    took the modules until the land kernel ran the iterations, now goes
    through the land rollout (``column_scheme`` sends it there, and ``run``
    calls the plain version once with the count) and matches JAX's
    ``run`` all the same."""
    def make(m):
        if case == "picard_iters=2":
            sim = _forced(m, "consistent", "implicit-pcr")
            sim.timestepper = m.ImplicitEuler(dt=600.0, picard_iters=2)
            return sim
        model = dataclasses.replace(land_model(m, _grid(m), "snow"),
                                    surface_energy_balance=m.SurfaceEnergyBalance(
                                        albedo=m.PrescribedAlbedo()))
        assert type(model.surface_energy_balance.albedo) is m.PrescribedAlbedo
        return m.initialize(model, m.ImplicitEuler(dt=600.0),
                            (m.FieldInputSource(fields={"albedo": 0.4, "emissivity": 0.95,
                                                        "snowfall": 2.0e-8,
                                                        "air_temperature": 3.0}),),
                            initializers={"temperature": 4.0, "saturation_water_ice": 0.6,
                                          "snow_water_equivalent": 0.01})

    jsim, psim = make(tt), make(tp)
    scheme = integrator.column_scheme(psim.model, psim.timestepper, psim.ctx,
                                      psim.input_sources)
    if case == "picard_iters=2":
        assert scheme == ("land", "implicit")
        calls = _spy_plain(monkeypatch)
    else:
        assert scheme is None

        def refused(*args, **kwargs):
            raise AssertionError("the land rollout ran")

        monkeypatch.setattr(ls, "land_column_rollout_plain", refused)
    jsim.run(steps=4, dt=600.0)
    psim.run(steps=4, dt=600.0)
    if case == "picard_iters=2":
        assert calls == [("implicit", "pcr", 2)]
    _assert_prognostics_close(psim.state, jsim.state, sorted(psim.state.prognostic))


def test_land_wrappers_take_cpu_tensors_and_check_their_solver():
    """On CPU tensors each wrapper runs the plain version of its stepper
    and counts no launch; the implicit wrapper takes only PCR and Thomas."""
    psim = _forced(tp, "consistent_snow", "implicit-pcr")
    model, st = psim.model, psim.state
    params = ls.LandParams.of(model, torch.float64)
    assert params.tags == ("veg", "richards", "bc", "linear", "snow")
    carry = {n: st[n].contiguous() for n in ls.carry_names(params)}
    inputs = integrator.land_inputs(model, st, psim.input_sources)
    root = st.auxiliary["root_fraction"]
    coords = tuple(getattr(model.grid, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    before = {k: f.launches for k, f in ls.ROLLOUTS.items()}
    for stepper, fn in ls.ROLLOUTS.items():
        kw = {"solver": "thomas"} if stepper == "implicit" else {}
        out = fn(carry, inputs, root, *coords, params, 600.0, 0.0, 2, **kw)
        ref = ls.land_column_rollout_plain(carry, inputs, root, *coords, params, 600.0, 0.0, 2,
                                           stepper=stepper, **kw)
        assert all(torch.equal(out[n], ref[n]) for n in model.live_carry)
    assert {k: f.launches for k, f in ls.ROLLOUTS.items()} == before
    with pytest.raises(ValueError, match="pcr"):
        ls.land_column_implicit_rollout(carry, inputs, root, *coords, params, 600.0, 0.0, 1,
                                        solver="cyclic")
