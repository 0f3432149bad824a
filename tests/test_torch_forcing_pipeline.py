"""The streamed forcing pipeline (``terrarium_tpu_torch/io/forcing_pipeline.py``)
against the JAX package's, at float64 on the CPU.

Each of `tests/test_forcing_pipeline.py`'s six cases runs through both
packages from the same numpy inputs: ``run`` against JAX's ``run`` at rtol
1e-12 (a floor of 1e-12 of each field's magnitude), ``run_fused`` (here the
plain versions of the rollout kernels, one call a chunk) against JAX's
``run_fused`` (its Pallas kernel in interpret mode, as its own tests run
it) at `tests/test_torch_fused_rollout.py`'s bound for the soil, the same
rtol 1e-12, and at the land's Queue C bounds for the LandModel (every
prognostic at 1e-12, the saturation at 1e-10: JAX's closed-form saturation
adjustment rounds apart from the sequential sweeps). The port's windows
start where JAX's do, so both interpolate each window from its own origin.

The LandModel cases run `examples/land_global.py`'s composition
(``torch_parity.land_model(..., "consistent")``) by ImplicitEuler: JAX's
own case (loam, ``VegetationCarbon.consistent_units()``, the rest default)
leaves the physical range at float64 on its forcing, by ForwardEuler (the
energy NaN by step 32) and by ImplicitEuler at dt 1800 alike, and its
float32 test compares NaN with NaN. JAX's fused rollout leaves the skin
temperature, a prognostic that each full step rewrites from the surface
energy balance, elsewhere than its full steps do (24% apart here); the
port's ``run_fused`` leaves it where its ``run`` and JAX's ``run`` do, so
there it is held to the port's ``run``.
Also: the padded tail window of ``run`` (a soil table, a land chunk on the
modules), a run across the end of the series, a clock late in a year, the
window tensor handed to the rollout without a copy, ``sim.run()``
raising, and windows of another spacing or length raising, where the
reference does not check them."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.io.forcing_pipeline import ChunkedForcingPipeline as JaxPipeline
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.timesteppers import integrator

from torch_parity import assert_fields_close, land_model

F64 = torch.float64
LAND_INITS = {"temperature": 8.0, "saturation_water_ice": 0.6, "carbon_vegetation": 2.0,
              "vegetation_area_fraction": 0.5}
LAND_STATIC = {"surface_longwave_down": 330.0, "rainfall": 4.0e-8, "windspeed": 3.0,
               "specific_humidity": 0.006}


def _grid(m, cells, nz):
    if m is tt:
        return tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=nz), nf=np.float64)
    return tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=F64,
                            device="cpu")


def _soil_sim(m, sources, cells, nz, stepper=None, inits=None, bcs=None, start=0.0):
    """A SoilModel (heat only, the default) with a top temperature from the
    input ``surface_temperature`` (or ``bcs``), started at clock ``start``."""
    sim = m.initialize(
        m.SoilModel(grid=_grid(m, cells, nz)), stepper or m.ForwardEuler(),
        initializers=inits or {"temperature": 1.0, "saturation_water_ice": 0.5},
        boundary_conditions=bcs or m.PrescribedSurfaceTemperature("surface_temperature"),
        input_sources=sources)
    return _at(m, sim, start)


def _at(m, sim, start):
    if start:
        if m is tt:
            clock = tt.Clock(jnp.asarray(start, jnp.float64), sim.state.clock.iteration)
            sim.state = dataclasses.replace(sim.state, clock=clock)
        else:
            sim.state.clock = tp.Clock(torch.tensor(start, dtype=F64), sim.state.clock.iteration)
    return sim


def _land_sim(m, sources, cells, nz, stepper=None, start=0.0):
    """`examples/land_global.py`'s LandModel, ImplicitEuler (PCR) at dt 900
    unless ``stepper`` is given."""
    model = land_model(m, _grid(m, cells, nz), "consistent")
    sim = m.initialize(model, stepper or m.ImplicitEuler(dt=900.0), initializers=LAND_INITS,
                       input_sources=sources)
    return _at(m, sim, start)


def _both(build, times, series, window, start=0.0, inner=None, static=None, **kw):
    """``(jax sim, jax pipeline, port sim, port pipeline)`` over the same
    numpy series."""
    out = []
    for m, pipe in ((tt, JaxPipeline), (tp, tp.ChunkedForcingPipeline)):
        p = pipe(times, series, window=window)
        sources = (p,) if static is None else (p, m.FieldInputSource(fields=static))
        sim = build(m, sources, start=start, **kw)
        sim.fused_inner_steps = inner
        out += [sim, p]
    return out


def _same(psim, jsim, land=False):
    """The prognostics at the bounds of the module's docstring, the clock
    exactly; ``land="fused"`` leaves out the skin temperature."""
    names = sorted(jsim.state.prognostic)
    left_out = {"saturation_water_ice"} | ({"skin_temperature"} if land == "fused" else set())
    assert_fields_close(psim.state, jsim.state,
                        [n for n in names if not (land and n in left_out)])
    if land:
        assert_fields_close(psim.state, jsim.state, ["saturation_water_ice"], rtol=1e-10,
                            rel_atol=1e-10)
    assert psim.current_time == float(jsim.state.clock.time)
    assert psim.iteration == int(jsim.state.clock.iteration)


def _hourly(hours, cells, seed, amp=4.0):
    rng = np.random.default_rng(seed)
    return (amp * np.sin(2 * np.pi * hours[:, None] / 86400.0)
            + rng.normal(0, 0.5, (hours.size, cells)))


def test_run_matches_jax_and_the_whole_series():
    """`test_chunked_pipeline_matches_monolithic`: half-hourly series, a
    window of 8, 96 steps at dt 300 through ``run``, then 144 more into the
    padded last window (its chunk's top temperature a table) and past the
    series' end; against JAX's ``run`` and the port's ``Simulation.run`` on
    the whole series (rtol 1e-12) after each."""
    times = np.arange(40) * 1800.0
    temp = 5.0 * np.sin(2 * np.pi * times / 86400.0)[:, None] \
        + np.random.default_rng(42).normal(0, 0.5, (40, 4))
    jsim, jpipe, psim, ppipe = _both(
        lambda m, s, start: _soil_sim(m, s, 4, 10, start=start), times,
        {"surface_temperature": temp}, 8)
    whole = _soil_sim(tp, (tp.TimeSeriesInputSource(times=times, series={
        "surface_temperature": temp}),), 4, 10)
    for steps in (96, 144):
        jpipe.run(jsim, steps=steps, dt=300.0)
        ppipe.run(psim, steps=steps, dt=300.0)
        _same(psim, jsim)
        whole.run(steps=steps, dt=300.0)
        assert_fields_close(psim.state, whole.state, sorted(psim.state.prognostic))
    assert psim.current_time > times[-1]
    tail = ppipe.chunks[-1].times
    assert tail[-1] == tail[-2] and fs.uniform_ts_meta(tail) is None
    assert len(ppipe.chunks) > 2


def test_run_past_the_series_end_matches_jax():
    """`test_pipeline_single_compilation`: a window of 8 over 64 ten-minute
    slices, 60 steps at dt 600, and 60 more that run past the series' end
    (flat extrapolation); JAX's ``run`` at rtol 1e-12."""
    times = np.arange(64) * 600.0
    vals = np.random.default_rng(42).normal(0, 1, (64, 4))
    jsim, jpipe, psim, ppipe = _both(
        lambda m, s, start: _soil_sim(m, s, 4, 10, start=start), times,
        {"surface_temperature": vals}, 8)
    for _ in range(2):
        jpipe.run(jsim, steps=60, dt=600.0)
        ppipe.run(psim, steps=60, dt=600.0)
        _same(psim, jsim)
    assert psim.current_time == 120 * 600.0 > times[-1]
    assert bool(torch.isfinite(psim.state.temperature).all())


def test_run_fused_matches_jax_across_the_series_end():
    """`test_run_fused_streamed_matches_full_series`: hourly (T, cells)
    series over 40 h, a window of 8, 176 steps at dt 900 (its 144 and 32
    more, past the series' end) in chunks of 24 (``fused_inner_steps`` 4)
    that cross window boundaries; JAX's ``run_fused`` and the whole series'
    ``Simulation.run`` at rtol 1e-12, one rollout call a chunk."""
    cells, nz = 24, 6
    hours = np.arange(0.0, 40 * 3600.0, 3600.0)
    series = {"surface_temperature": _hourly(hours, cells, 11)}
    build = lambda m, s, start: _soil_sim(m, s, cells, nz, m.ForwardEuler(dt=900.0),  # noqa: E731
                                          start=start)
    jsim, jpipe, psim, ppipe = _both(build, hours, series, 8, inner=4)
    calls = []
    real = fs.soil_column_heat_rollout

    def spy(U, sat, S, top, *a):
        calls.append((top.values.numpy().copy(), top.t0, top.steps))
        return real(U, sat, S, top, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(fs.ROLLOUTS, ("euler", "heat"), spy)
        ppipe.run_fused(psim, steps=176, dt=900.0)
    jpipe.run_fused(jsim, steps=176, dt=900.0)
    _same(psim, jsim)
    whole = build(tp, (tp.TimeSeriesInputSource(times=hours, series=series),), 0.0)
    whole.run(steps=176, dt=900.0)
    assert_fields_close(psim.state, whole.state, sorted(psim.state.prognostic))
    # one call a chunk, on the window's rows of the series, from the window's origin
    assert [(float(c.times[0]), c.steps) for c in ppipe.chunks] == [c[1:] for c in calls]
    for values, t0, _ in calls:
        i0 = int(t0 // 3600.0)
        np.testing.assert_array_equal(values, series["surface_temperature"][i0:i0 + 8])
    assert [n for *_, n in calls] == [24] * 7 + [8]
    # the windows from the chunks' clock times, the last two held at T - 8
    assert [t0 / 3600.0 for _, t0, _ in calls] == [0, 6, 12, 18, 24, 30, 32, 32]
    assert [c.new_window for c in ppipe.chunks] == [True] * 7 + [False]


def test_run_fused_lazy_provider_matches_arrays_and_jax():
    """`test_run_fused_lazy_series_provider`: a lazy provider ``v(i0, i1)``
    gives bitwise what the array gives; both within rtol 1e-12 of JAX."""
    cells, nz = 16, 5
    hours = np.arange(0.0, 24 * 3600.0, 3600.0)
    base = 3.0 * np.cos(2 * np.pi * hours[:, None] / 86400.0) * np.ones((1, cells))
    build = lambda m, s, start: _soil_sim(m, s, cells, nz, m.ForwardEuler(dt=1800.0),  # noqa: E731
                                          inits={"temperature": 0.5,
                                                 "saturation_water_ice": 0.5}, start=start)
    out = {}
    for key, series in (("lazy", {"surface_temperature": lambda i0, i1: base[i0:i1]}),
                        ("array", {"surface_temperature": base})):
        jsim, jpipe, psim, ppipe = _both(build, hours, series, 6, inner=2)
        ppipe.run_fused(psim, steps=32, dt=1800.0)
        out[key] = psim.state.internal_energy
    jpipe.run_fused(jsim, steps=32, dt=1800.0)
    torch.testing.assert_close(out["lazy"], out["array"], rtol=0, atol=0)
    _same(psim, jsim)


def test_run_fused_several_variables_and_static_sources():
    """`test_run_fused_multi_variable_and_static_sources`. Its bottom
    temperature BC is one no rollout kernel takes: the port's ``run_fused``
    raises naming the composition, and its ``run`` (the process modules a
    chunk) matches JAX's ``run_fused`` at rtol 1e-12. With the top
    temperature alone, two streamed series and a static source go through
    ``run_fused`` on the kernel, against JAX's ``run_fused`` at rtol 1e-12."""
    cells, nz = 16, 6
    hours = np.arange(0.0, 30 * 3600.0, 3600.0)
    rng = np.random.default_rng(23)
    ta = 5.0 + 3.0 * np.sin(2 * np.pi * hours[:, None] / 86400.0) \
        + rng.normal(0, 0.3, (hours.size, cells))
    tb = 2.0 + 0.5 * np.sin(2 * np.pi * hours[:, None] / (5 * 86400.0)) \
        + rng.normal(0, 0.1, (hours.size, cells))
    series = {"surface_temperature": ta, "bottom_temperature": tb}

    def build(m, s, start, bottom=True):
        bcs = m.PrescribedSurfaceTemperature("surface_temperature")
        if bottom:
            bcs = m.merge_boundary_conditions(bcs, m.PrescribedBottomTemperature(
                "bottom_temperature"))
        return _soil_sim(m, s, cells, nz, m.ForwardEuler(dt=1800.0), bcs=bcs, start=start)

    jsim, jpipe, psim, ppipe = _both(build, hours, series, 8, inner=4)
    with pytest.raises(ValueError, match="column rollout kernels"):
        ppipe.run_fused(psim, steps=48, dt=1800.0)
    assert psim.iteration == 0
    jpipe.run_fused(jsim, steps=48, dt=1800.0)
    ppipe.run(psim, steps=48, dt=1800.0)
    _same(psim, jsim)

    jsim, jpipe, psim, ppipe = _both(lambda m, s, start: build(m, s, start, bottom=False),
                                     hours, series, 8, inner=4, static={"air_temperature": 3.0})
    jpipe.run_fused(jsim, steps=48, dt=1800.0)
    ppipe.run_fused(psim, steps=48, dt=1800.0)
    _same(psim, jsim)
    # the inputs at the last step's start (JAX's fused path leaves zeros:
    # ROADMAP Queue C, "Inputs after run")
    t_last = psim.current_time - 1800.0
    want = [np.interp(t_last, hours, tb[:, c]) for c in range(cells)]
    np.testing.assert_allclose(psim.state.inputs["bottom_temperature"].numpy(), want,
                               rtol=1e-12)
    assert bool((psim.state.inputs["air_temperature"] == 3.0).all())


@pytest.mark.parametrize("route", ["run_fused", "run"])
def test_coupled_land_model_matches_jax(route):
    """`test_run_fused_coupled_land_model`: shortwave and air temperature
    streamed beside a static ``FieldInputSource``, a window of 8, 64 steps
    at dt 900 (``run``: into the padded last window, whose chunk steps
    through the modules, and past the series' end); against JAX's same
    route at the land's Queue C bounds, ``run_fused`` also against the
    port's ``run`` at rtol 1e-12, the skin temperature included."""
    cells, nz = 24, 6
    hours = np.arange(0.0, 30 * 3600.0, 3600.0)
    day = hours / 86400.0
    series = {"surface_shortwave_down": 600.0 * np.maximum(
        0.0, np.sin(2 * np.pi * (day[:, None] - 0.25))) * np.ones((1, cells)),
        "air_temperature": (10.0 + 5.0 * np.sin(2 * np.pi * (day[:, None] - 0.3)))
        * np.ones((1, cells))}
    build = lambda m, s, start: _land_sim(m, s, cells, nz, start=start)  # noqa: E731
    jsim, jpipe, psim, ppipe = _both(build, hours, series, 8, inner=4, static=LAND_STATIC)
    steps = 64 if route == "run_fused" else 136
    getattr(jpipe, route)(jsim, steps=steps, dt=900.0)
    getattr(ppipe, route)(psim, steps=steps, dt=900.0)
    _same(psim, jsim, land="fused" if route == "run_fused" else True)
    if route == "run":
        assert fs.uniform_ts_meta(ppipe.chunks[-1].times) is None
        assert psim.current_time > hours[-1]
        return
    ref, rpipe = _both(build, hours, series, 8, static=LAND_STATIC)[2:]
    rpipe.run(ref, steps=steps, dt=900.0)
    assert_fields_close(psim.state, ref.state, sorted(psim.state.prognostic))


@pytest.mark.parametrize("model", ["soil", "land"])
def test_run_fused_late_in_a_year(model):
    """A clock from day 300 of a year (2.592e7 s, where a float32 clock's
    ulp is 2 s) and a series from day 299: each window interpolated from its
    own origin, as JAX's, at the same bounds (the land's skin temperature
    against the port's ``run``)."""
    cells, nz = 8, 6
    hours = 299 * 86400.0 + np.arange(0.0, 60 * 3600.0, 3600.0)
    start = 300 * 86400.0
    if model == "soil":
        series = {"surface_temperature": _hourly(hours, cells, 5)}
        build = lambda m, s, start: _soil_sim(m, s, cells, nz,  # noqa: E731
                                              m.Heun(dt=900.0), start=start)
        steps = 96
    else:
        series = {"air_temperature": 8.0 + _hourly(hours, cells, 6),
                  "surface_shortwave_down": 300.0 + 50.0 * _hourly(hours, cells, 7)}
        build = lambda m, s, start: _land_sim(m, s, cells, nz, start=start)  # noqa: E731
        steps = 96
    jsim, jpipe, psim, ppipe = _both(build, hours, series, 16, start=start, inner=8,
                                     static=None if model == "soil" else LAND_STATIC)
    jpipe.run_fused(jsim, steps=steps, dt=900.0)
    ppipe.run_fused(psim, steps=steps, dt=900.0)
    _same(psim, jsim, land=model == "land" and "fused")
    assert len(ppipe.chunks) > 1 and ppipe.chunks[0].times[0] == 300 * 86400.0
    if model == "land":
        ref, rpipe = _both(build, hours, series, 16, start=start, static=LAND_STATIC)[2:]
        rpipe.run(ref, steps=steps, dt=900.0)
        assert_fields_close(psim.state, ref.state, ["skin_temperature"])


def test_sim_run_raises_with_the_pipeline():
    """``Simulation.run`` with the pipeline as a source raises JAX's error,
    and the pipeline seeds the inputs at initialization from its first two
    slices, as JAX's does."""
    times = np.arange(8) * 3600.0
    vals = np.linspace(-2.0, 5.0, 8)[:, None] * np.ones((1, 4))
    jsim, jpipe, psim, ppipe = _both(lambda m, s, start: _soil_sim(m, s, 4, 6, start=start),
                                     times, {"surface_temperature": vals}, 4)
    np.testing.assert_allclose(psim.state.inputs["surface_temperature"].numpy(),
                               np.asarray(jsim.state.inputs["surface_temperature"]), rtol=1e-15)
    with pytest.raises(RuntimeError, match="not sim.run"):
        jsim.run(steps=2, dt=300.0)
    with pytest.raises(RuntimeError, match="not sim.run"):
        psim.run(steps=2, dt=300.0)


def test_windows_of_another_length_or_spacing_raise():
    """A window that ``run_fused`` would hand to a kernel with another
    length (a provider that gives a row short) or spacing raises
    ``ValueError`` naming both, for the soil's ``SeriesBC`` and the land's
    series reader; nothing is resampled and no step is taken."""
    hours = np.arange(0.0, 24 * 3600.0, 3600.0)
    vals = np.ones((24, 4))
    pipe = tp.ChunkedForcingPipeline(hours, {
        "surface_temperature": lambda i0, i1: vals[i0:max(i0 + 1, i1 - (i0 > 0))]}, window=6)
    sim = _soil_sim(tp, (pipe,), 4, 6, tp.ForwardEuler(dt=1800.0))
    sim.fused_inner_steps = 2
    with pytest.raises(ValueError, match=r"5 rows .* first window's 6 rows at spacing 3600"):
        pipe.run_fused(sim, steps=16, dt=1800.0)
    assert 0 < sim.iteration < 16  # the first window was whole, the second a row short

    uneven = np.array([0.0, 3600.0, 7200.0, 9000.0, 12600.0, 16200.0])
    src = tp.TimeSeriesInputSource(times=uneven, series={"surface_temperature": vals[:6]})
    sim = _soil_sim(tp, (src,), 4, 6)
    with pytest.raises(ValueError, match=r"uneven spacing; .* 6 rows at spacing 3600"):
        integrator.advance(sim.model, sim.state, sim.ctx, 2, 300.0,
                           timestepper=sim.timestepper, input_sources=(src,),
                           window=(6, 3600.0))
    spaced = tp.TimeSeriesInputSource(times=np.arange(6) * 1800.0,
                                      series={"surface_temperature": vals[:6]})
    with pytest.raises(ValueError, match=r"spacing 1800.0 s; .* spacing 3600"):
        integrator.advance(sim.model, sim.state, sim.ctx, 2, 300.0,
                           timestepper=sim.timestepper, input_sources=(spaced,),
                           window=(6, 3600.0))
    assert sim.iteration == 0

    land = _land_sim(tp, (tp.TimeSeriesInputSource(times=np.arange(6) * 1800.0, series={
        "air_temperature": vals[:6]}), tp.FieldInputSource(fields=LAND_STATIC)), 4, 6)
    with pytest.raises(ValueError, match=r"spacing 1800.0 s; .* spacing 3600"):
        integrator.land_inputs(land.model, land.state, land.input_sources, window=(6, 3600.0))
    with pytest.raises(ValueError, match=r"7 rows"):
        integrator.land_inputs(land.model, land.state, land.input_sources, window=(7, 1800.0))
    assert set(integrator.land_inputs(land.model, land.state, land.input_sources,
                                      window=(6, 1800.0))) >= {"air_temperature"}


def test_other_time_varying_sources_keep_their_place():
    """JAX's pipeline keeps its window and the static sources and drops
    every other time-varying source (ROADMAP, reference defects); the
    port's keeps each in its place: an air-temperature series beside the
    streamed top temperature is read at the last step's start by ``run``
    and ``run_fused`` (rtol 1e-12), where JAX's leaves the value it was
    seeded with, and the prognostics equal the whole series' run."""
    hours = np.arange(0.0, 24 * 3600.0, 3600.0)
    top = _hourly(hours, 4, 9)
    air = 10.0 + _hourly(hours, 4, 10)
    other = {"air_temperature": air}
    for route in ("run", "run_fused"):
        jsim, jpipe, psim, ppipe = _both(
            lambda m, s, start: _soil_sim(m, s + (m.TimeSeriesInputSource(times=hours,
                                                                          series=other),),
                                          4, 6, m.ForwardEuler(dt=1800.0), start=start),
            hours, {"surface_temperature": top}, 6, inner=2)
        getattr(jpipe, route)(jsim, steps=20, dt=1800.0)
        getattr(ppipe, route)(psim, steps=20, dt=1800.0)
        _same(psim, jsim)
        t_last = psim.current_time - 1800.0
        want = [np.interp(t_last, hours, air[:, c]) for c in range(4)]
        np.testing.assert_allclose(psim.state.inputs["air_temperature"].numpy(), want,
                                   rtol=1e-12)
        assert not np.allclose(np.asarray(jsim.state.inputs["air_temperature"]), want)
