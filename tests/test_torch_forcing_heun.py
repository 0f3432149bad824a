"""Input sources, Heun and the forced fused rollout of the port against the
JAX package, at float64 on the CPU unless a test says otherwise.

The JAX references: ``TimeSeriesInputSource._interp``, ``Heun.step`` and
``pre_closure_step``, ``make_fused_lean_rollout`` in interpret mode (its
Heun body and ``_WindowSource``, as `tests/test_fused_step.py` runs it), the
XLA lean rollout and ``Simulation.run``. Both packages take the same numpy
arrays (`torch_parity.py`). The port's fused rollout reads a uniform series
as the CUDA kernel does, ``(t - t0) / dts`` from the series' start, where
JAX's fused path interpolates from each window's start and its XLA path
searches the times: they round apart by an ulp of the top temperature, so
the rollouts are held at 1e-12 and the module steps bitwise only where both
sides read the series the same way.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.ops.fused_step import make_fused_lean_rollout
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.timesteppers.autodiff import make_rollout_fn
from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout
from terrarium_tpu_torch.timesteppers.integrator import advance

from torch_parity import CONFIGS, assert_fields_close, heun_forced, heun_n145_forcing, port_soil

FIELDS = ("internal_energy", "saturation_water_ice", "surface_excess_water", "temperature",
          "pressure_head", "liquid_water_fraction", "water_table", "hydraulic_conductivity",
          "ground_temperature")
HOURS = np.arange(0.0, 6 * 3600.0, 3600.0)


# ---------------------------------------------------------------------------
# input sources
# ---------------------------------------------------------------------------
def _series_case(case, rng):
    """``(times, values, cells)``: uniform or not, ``(T, cells)`` or ``(T,)``
    (with T == cells, where a wrong broadcast would go unnoticed)."""
    if case.startswith("uniform"):
        times = np.arange(6) * 3600.0 + 900.0
    else:
        times = np.array([900.0, 1000.0, 4600.0, 4700.0, 9000.0, 20000.0])
    if case.endswith("scalar"):
        return times, rng.normal(3.0, 4.0, 6), 6
    return times, rng.normal(3.0, 4.0, (6, 10)), 10


@pytest.mark.parametrize("case", ["uniform", "nonuniform", "uniform-scalar",
                                  "nonuniform-scalar"])
def test_series_interpolation_matches_jax(case):
    """Before the first time, on and between the rows, after the last: the
    port's ``values_at`` against JAX's ``_interp`` at rtol 1e-14, and its
    vectorised form over all times equal to the per-time values bitwise."""
    times, values, cells = _series_case(case, np.random.default_rng(3))
    jsrc = tt.TimeSeriesInputSource(times=times, series={"v": values})
    psrc = tp.TimeSeriesInputSource(times=times, series={"v": values})
    ts = np.array([0.0, 900.0, 950.0, 1000.0, 2345.6, 4600.0, 9000.0, 19999.0, 20000.0,
                   21600.0, 30000.0, 1e6])
    like = torch.zeros(cells, dtype=torch.float64)
    many = psrc.values_at("v", torch.as_tensor(ts), like)
    assert tuple(many.shape) == (ts.size, cells)
    for i, t in enumerate(ts):
        ref = np.asarray(jsrc._interp("v", jnp.asarray(t), jnp.zeros(cells)))
        got = psrc.values_at("v", torch.tensor(t, dtype=torch.float64), like)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-14, atol=1e-14, err_msg=str(t))
        assert torch.equal(many[i], got)


def _order_sims(order, pkg):
    """The heat-only model on 16 columns with a (T, cells) series of 2 degC
    and a static 7 degC field for the same input, in ``order``
    (`tests/test_fused_step.py:294-329`)."""
    m = tt if pkg == "jax" else tp
    kw = dict(nf=np.float64) if pkg == "jax" else dict(dtype=torch.float64, device="cpu")
    grid = m.ColumnGrid.of(cells=16, spacing=m.ExponentialSpacing(N=8), **kw)
    ts = m.TimeSeriesInputSource(times=HOURS, series={"surface_temperature": np.full(
        (HOURS.size, 16), 2.0)})
    static = m.FieldInputSource(fields={"surface_temperature": 7.0})
    sources = (ts, static) if order == "series-static" else (static, ts)
    return m.initialize(m.SoilModel(grid=grid), m.ForwardEuler(dt=900.0), sources,
                        initializers={"temperature": 1.0, "saturation_water_ice": 0.5},
                        boundary_conditions=m.PrescribedSurfaceTemperature(
                            "surface_temperature"))


@pytest.mark.parametrize("order", ["series-static", "static-series"])
def test_source_order_follows_the_modules(order):
    """Sources update in the user's order, a static one only at
    initialization: its value is the input before the first step, and the
    series' from then on, in either order, as JAX's run leaves it."""
    jsim, psim = _order_sims(order, "jax"), _order_sims(order, "port")
    first = 7.0 if order == "series-static" else 2.0
    assert float(psim.state.inputs["surface_temperature"][0]) == first
    np.testing.assert_array_equal(psim.state.inputs["surface_temperature"].numpy(),
                                  np.asarray(jsim.state.inputs["surface_temperature"]))
    jsim.run(steps=8, dt=900.0)
    psim.run(steps=8, dt=900.0)
    assert_fields_close(psim.state, jsim.state, ("internal_energy", "temperature",
                                                 "surface_temperature"))


@pytest.mark.parametrize("stepper", ["euler", "heun"])
def test_inputs_after_run_match_jax(stepper):
    """JAX's default run leaves each time-varying input at the start time of
    the last step: 0.75 for the series t / 3600 after 4 steps of 900 s."""
    sims = []
    for m, kw in ((tt, dict(nf=np.float64)), (tp, dict(dtype=torch.float64, device="cpu"))):
        grid = m.ColumnGrid.of(cells=3, spacing=m.ExponentialSpacing(N=6), **kw)
        ts = m.TimeSeriesInputSource(times=HOURS, series={"air_temperature": HOURS / 3600.0})
        sims.append(m.initialize(
            m.SoilModel(grid=grid), m.Heun() if stepper == "heun" else m.ForwardEuler(),
            (ts,), initializers={"temperature": 1.0, "saturation_water_ice": 0.5},
            boundary_conditions=m.PrescribedSurfaceTemperature("air_temperature")))
    for sim in sims:
        sim.run(steps=4, dt=900.0)
    jsim, psim = sims
    np.testing.assert_array_equal(psim.state.inputs["air_temperature"].numpy(),
                                  np.asarray(jsim.state.inputs["air_temperature"]))
    assert float(psim.state.inputs["air_temperature"][0]) == 0.75
    assert_fields_close(psim.state, jsim.state, ("internal_energy", "temperature"))


# ---------------------------------------------------------------------------
# Heun through the modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["step", "pre_closure_step"])
def test_heun_steps_match_jax(method):
    """Three Heun steps of the ``heun_forced`` configuration, the series read
    at t and t + dt: every field at rtol 1e-12, the saturation (adjusted by
    the sweeps) at an absolute 1e-12."""
    jsim, psim = heun_forced("jax"), heun_forced("port")
    jstate = jsim.state
    for _ in range(3):
        jstate = getattr(jsim.timestepper, method)(jsim.model, jstate, jsim.ctx,
                                                  jsim.input_sources, 300.0)
        getattr(psim.timestepper, method)(psim.model, psim.state, psim.ctx,
                                          psim.input_sources, 300.0)
    sat = [s.saturation_water_ice for s in (psim.state, jstate)]
    np.testing.assert_allclose(sat[0].numpy(), np.asarray(sat[1]), rtol=0, atol=1e-12)
    names = [f for f in FIELDS if f != "saturation_water_ice"] + ["air_temperature"]
    assert_fields_close(psim.state, jstate, names)
    for g in ("prognostic", "tendencies"):
        for k, v in getattr(jstate, g).items():
            np.testing.assert_allclose(getattr(psim.state, g)[k].numpy(), np.asarray(v),
                                       rtol=1e-12, atol=1e-12 * float(np.abs(v).max()),
                                       err_msg=f"{g}/{k}")
    assert psim.current_time == float(jstate.clock.time) == 900.0


# ---------------------------------------------------------------------------
# the fused rollout with Heun and a series
# ---------------------------------------------------------------------------
def _plain(sim, steps, dt):
    advance(sim.model, sim.state, sim.ctx, steps, dt, timestepper=sim.timestepper,
            input_sources=sim.input_sources, plain=True)
    return sim


@pytest.mark.parametrize("ref", ["pallas", "xla", "run"])
def test_plain_heun_series_rollout_matches_jax(ref):
    """``heun_forced`` for 24 steps: the plain version (the kernel's
    arithmetic) against JAX's Pallas kernel in interpret mode and its XLA
    lean rollout, and ``Simulation.run`` on both sides (with the
    auxiliaries and the inputs), at 1e-12."""
    jsim, psim = heun_forced("jax"), heun_forced("port")
    names = FIELDS[:7]
    if ref == "pallas":
        fused = make_fused_lean_rollout(jsim.model, jsim.timestepper, jsim.ctx,
                                        jsim.input_sources, dt=300.0, inner_steps=8,
                                        block_cells=128, interpret=True)
        jstate = jax.jit(lambda s: fused(s, 24))(jsim.state)
    elif ref == "xla":
        jstate = jsim._rollout_fn(24)(jsim.state, 300.0)
    else:
        jstate = jsim.run(steps=24, dt=300.0).state
        names = FIELDS + ("air_temperature",)
    if ref == "run":
        psim.run(steps=24, dt=300.0)
    else:
        _plain(psim, 24, 300.0)
    assert_fields_close(psim.state, jstate, names)
    assert psim.current_time == float(jstate.clock.time)


def test_plain_heun_series_rollout_matches_jax_f32():
    """``heun_n145_heat_richards_forcing`` on 64 columns at float32: 12
    steps against the Pallas kernel in interpret mode at the bound of
    `tests/test_fused_step.py:134-137` (rtol 2e-5, atol 1e-6), and 24 steps
    against the port's own float64 run at 2e-6 of each field. JAX's float32
    adjustment, a closed form over prefix sums of (sat - 1) * dz, loses
    eps * (column depth / dz) in the thin top layers: it drifts 2.5e-5 from
    the float64 result in 24 steps, where the port's sequential sweeps
    drift 5e-7 (ROADMAP Queue C), so the JAX comparison stops at 12."""
    jsim = heun_n145_forcing("jax", 64, nz=20, dtype=torch.float32, days=2)
    psim = heun_n145_forcing("port", 64, nz=20, dtype=torch.float32, days=2)
    fused = make_fused_lean_rollout(jsim.model, jsim.timestepper, jsim.ctx,
                                    jsim.input_sources, dt=60.0, inner_steps=4,
                                    block_cells=128, interpret=True)
    jstate = jax.jit(lambda s: fused(s, 12))(jsim.state)
    _plain(psim, 12, 60.0)
    for name in ("internal_energy", "saturation_water_ice", "surface_excess_water"):
        np.testing.assert_allclose(psim.state[name].numpy(), np.asarray(jstate.prognostic[name]),
                                   rtol=2e-5, atol=1e-6, err_msg=name)
    ref = heun_n145_forcing("port", 64, nz=20, dtype=torch.float64, days=2)
    _plain(psim, 12, 60.0)
    _plain(ref, 24, 60.0)
    for name in ("internal_energy", "saturation_water_ice", "surface_excess_water"):
        b = ref.state[name]
        torch.testing.assert_close(psim.state[name].double(), b, rtol=2e-6,
                                   atol=2e-6 * float(b.abs().max()), msg=name)


def _heun_sim(bc, sources=()):
    grid = tp.ColumnGrid.of(cells=16, spacing=tp.ExponentialSpacing(N=30),
                            dtype=torch.float64, device="cpu")
    return tp.initialize(tp.SoilModel(grid=grid, soil=port_soil()), tp.Heun(dt=60.0), sources,
                         initializers=CONFIGS["bench"]["inits"],
                         boundary_conditions=tp.PrescribedSurfaceTemperature(bc))


@pytest.mark.parametrize("bc", ["callable", "nonuniform series"])
def test_plain_heun_rollout_equals_module_steps(bc):
    """The plain Heun rollout and ``closure`` after ``Heun.pre_closure_step``
    repeated are the same arithmetic, bitwise: with ``f(t)`` and with a
    series of uneven spacing, which the rollout takes as a table of the
    source's own values."""
    def build():
        if bc == "callable":
            return _heun_sim(CONFIGS["bench"]["bc_torch"])
        times = np.array([0.0, 500.0, 1800.0, 2000.0, 3600.0])
        src = tp.TimeSeriesInputSource(times=times, series={"air_temperature": np.linspace(
            -3.0, 6.0, 5)[:, None] + np.linspace(0.0, 1.0, 16)[None, :]})
        return _heun_sim("air_temperature", (src,))

    sim, ref = _plain(build(), 30, 60.0), build()
    for _ in range(30):
        ref.timestepper.pre_closure_step(ref.model, ref.state, ref.ctx, ref.input_sources, 60.0)
    ref.model.closure(ref.state, ref.ctx)
    for name in FIELDS[:7]:
        torch.testing.assert_close(sim.state[name], ref.state[name], rtol=0, atol=0)


def test_module_rollout_takes_heun_and_sources():
    """``make_rollout_fn`` runs the module steps of any stepper with its
    sources: Heun with a series, checkpointed and lean, equals ``closure``
    after ``pre_closure_step`` repeated bitwise, and differentiates in the
    initial energy."""
    sim = heun_forced("port")
    roll = make_rollout_fn(sim.model, sim.timestepper, sim.ctx, sim.input_sources, steps=6,
                           remat=True, lean=True)
    state = sim.state.copy()
    U0 = state.prognostic["internal_energy"].clone().requires_grad_()
    state.prognostic["internal_energy"] = U0
    out = roll(state, 300.0)
    ref = heun_forced("port")
    for _ in range(6):
        ref.timestepper.pre_closure_step(ref.model, ref.state, ref.ctx, ref.input_sources, 300.0)
    ref.model.closure(ref.state, ref.ctx)
    for name in FIELDS[:7]:
        torch.testing.assert_close(out[name].detach(), ref.state[name], rtol=0, atol=0)
    (g,) = torch.autograd.grad(out.temperature.mean(), U0)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0.0


def test_heun_forced_golden():
    """`tests/goldens/heun_forced.npz` (JAX's own check is marked slow; the
    port's runs in a fraction of a second): ``Simulation.run`` through the
    plain version at rtol 1e-12, atol 1e-12."""
    sim = heun_forced("port").run(steps=96, dt=300.0)
    golden = np.load(pathlib.Path(__file__).parent / "goldens" / "heun_forced.npz")
    for f in golden.files:
        np.testing.assert_allclose(sim.state[f].numpy(), golden[f], rtol=1e-12, atol=1e-12,
                                   err_msg=f)


def test_timestep_matches_run():
    """Twelve ``Simulation.timestep`` calls (the modules, the series read by
    its own interpolation) against one ``run(12)`` (the fused rollout)."""
    a, b = heun_forced("port"), heun_forced("port")
    a.run(steps=12, dt=300.0)
    for _ in range(12):
        b.timestep(300.0, finalize=False)
    b.compute_auxiliary()
    assert_fields_close(a.state, b.state, FIELDS + ("air_temperature",))
    assert a.current_time == b.current_time and a.iteration == b.iteration == 12


@pytest.mark.parametrize("stepper", ["euler", "heun"])
def test_water_identity(stepper):
    """W = sum(sat dz) + S of every column is kept through the fused
    rollout to 1e-12 (Heun averages two tendencies that each keep it)."""
    sim = heun_forced("port")
    if stepper == "euler":
        sim.timestepper = tp.ForwardEuler(dt=300.0)
    dz = sim.model.grid.dz[:, 0]

    def water():
        return (sim.state.saturation_water_ice * dz[:, None]).sum(0) + \
            sim.state.surface_excess_water

    w0 = water()
    sim.run(steps=96, dt=300.0)
    assert float(((water() - w0).abs() / w0.abs()).max()) <= 1e-12


# ---------------------------------------------------------------------------
# what the fused entry points refuse
# ---------------------------------------------------------------------------
class _Implicit:
    dt = 300.0

    def default_dt(self):
        return self.dt


class _OwnSource:
    def variables(self):
        return (tp.input("air_temperature", tp.XY()),)

    def initialize_inputs(self, state):
        state.inputs["air_temperature"] = torch.full_like(state.inputs["air_temperature"], 3.0)

    def update_inputs(self, state):
        pass


def test_run_refuses_what_the_kernels_do_not_take(monkeypatch):
    """What the soil kernels do not take by type (a source of another class,
    another BC) ``run`` steps through the process modules, which equal
    ``timestep`` after a ``closure``; a stepper without ``step`` fails there
    as in JAX; a top temperature naming no input, or a series of the wrong
    shape, still raises on the kernel path."""
    sim = heun_forced("port")
    with pytest.raises(AttributeError, match="step"):
        advance(sim.model, sim.state, sim.ctx, 2, 300.0, timestepper=_Implicit())
    with pytest.raises(AttributeError, match="step"):
        tp.Simulation(sim.model, _Implicit(), sim.state, sim.input_sources,
                      bcs=sim.bcs).run(steps=2)

    def own():
        return tp.initialize(sim.model, tp.Heun(), (_OwnSource(),),
                             initializers={"temperature": 1.0},
                             boundary_conditions=tp.PrescribedSurfaceTemperature(
                                 "air_temperature"))

    def other_bcs():
        s = heun_forced("port")
        return tp.Simulation(s.model, s.timestepper, s.state, s.input_sources,
                             bcs={**s.bcs, "pressure_head": {"bottom": tp.Neumann(0.0)}})

    def refused(*args, **kwargs):
        raise AssertionError("a soil column rollout ran")

    for make in (own, other_bcs):
        with monkeypatch.context() as mp:
            mp.setattr(fs, "soil_column_rollout_plain", refused)
            a = make().run(steps=2)
        b = make()
        b.model.closure(b.state, b.ctx)
        b.timestep(300.0).timestep(300.0)
        assert_fields_close(a.state, {k: b.state[k].numpy() for k in FIELDS}, FIELDS)
    with pytest.raises(ValueError, match="input variable"):
        tp.Simulation(sim.model, sim.timestepper, sim.state, sim.input_sources,
                      bcs=tp.PrescribedSurfaceTemperature("no_such_input")).run(steps=2)
    cube = tp.TimeSeriesInputSource(times=HOURS, series={"air_temperature": np.zeros(
        (HOURS.size, 1, 4))})
    with pytest.raises(ValueError, match=r"\(T,\) or \(T, cells\)"):
        tp.Simulation(sim.model, sim.timestepper, sim.state, (cube,), bcs=sim.bcs).run(steps=2)


def test_fused_grad_refuses_heun_series_and_heat_only(monkeypatch):
    """A series top temperature with either stepper is refused; Heun over
    heat + Richards and over the heat-only model is taken
    (`tests/test_torch_grad_steppers.py`), and so are Heun and the snowpack
    over a LandModel, refused until the land segment VJP took them: their
    rollouts run the land segment VJP (its plain version here) with the
    scheme and give a finite gradient in the initial energy."""
    sim = heun_forced("port")
    grid = sim.model.grid
    for ts in (tp.Heun(), tp.ForwardEuler()):
        with pytest.raises(ValueError, match="value or as f"):
            make_fused_grad_rollout(lambda p: sim.model, ts, sim.ctx, steps=4, dt=300.0,
                                    inner_steps=2)
    ctx = sim.model.make_context(bcs=tp.PrescribedSurfaceTemperature(4.0))
    heat = tp.SoilModel(grid=grid)
    state = tp.initialize(heat, tp.Heun(), initializers={"temperature": -1.0,
                                                         "saturation_water_ice": 0.8},
                          boundary_conditions=tp.PrescribedSurfaceTemperature(4.0)).state
    out = make_fused_grad_rollout(lambda p: heat, tp.Heun(), ctx, steps=4, dt=300.0,
                                  inner_steps=2)(state, None)
    assert bool(torch.isfinite(out.temperature).all())
    sources = (tp.FieldInputSource(fields={"surface_shortwave_down": 400.0,
                                           "air_temperature": 12.0}),)
    from terrarium_tpu_torch.ops import land_vjp as lv
    import terrarium_tpu_torch.timesteppers.fused_grad as fg

    calls = []
    real = lv.land_column_segment_vjp

    def spy(*a, **kw):
        calls.append((kw["stepper"], "snow" in a[7].tags))
        return real(*a, **kw)

    monkeypatch.setattr(fg, "land_column_segment_vjp", spy)
    for stepper, snow in ((tp.Heun(), None), (tp.ForwardEuler(), tp.Snowpack())):
        land = tp.initialize(tp.LandModel(grid=grid, snow=snow), stepper,
                             initializers={"temperature": 5.0, "saturation_water_ice": 0.8},
                             input_sources=sources)
        roll = make_fused_grad_rollout(lambda p: land.model, land.timestepper, land.ctx,
                                       steps=4, dt=300.0, inner_steps=2)
        state = land.state.copy()
        U0 = state.internal_energy.clone().requires_grad_()
        state.set(internal_energy=U0)
        (g,) = torch.autograd.grad(roll(state, None).temperature.mean(), U0)
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0
    assert calls == [("heun", False)] * 2 + [("euler", True)] * 2


def test_series_wrappers_check_their_operands():
    """The wrappers refuse a series of the wrong shape or dtype, and the
    segment VJP a series at all; on CPU tensors they run the plain version
    and count no launch."""
    sim = heun_forced("port")
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    carry = tuple(sim.state.prognostic[n] for n in sim.model.live_carry)
    params = fs.ColumnParams.of(sim.model, torch.float64)
    values = torch.as_tensor(sim.input_sources[0].series["air_temperature"])
    bc = fs.SeriesBC(values, 0.0, 7200.0, 0.0, 6)
    before = fs.soil_column_heun_rollout.launches
    out = fs.soil_column_heun_rollout(*carry, bc, *coords, params, 300.0)
    ref = fs.soil_column_rollout_plain(*carry, bc, *coords, params, 300.0, stepper="heun")
    assert fs.soil_column_heun_rollout.launches == before
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"\(rows,\) or \(rows, 4\)"):
        fs.soil_column_heun_rollout(*carry, fs.SeriesBC(values[:, :3], 0.0, 7200.0, 0.0, 6),
                                    *coords, params, 300.0)
    with pytest.raises(TypeError, match="dtype"):
        fs.soil_column_heun_rollout(*carry, fs.SeriesBC(values.float(), 0.0, 7200.0, 0.0, 6),
                                    *coords, params, 300.0)
    from terrarium_tpu_torch.ops import fused_vjp as fv
    with pytest.raises(ValueError, match="table"):
        fv.soil_column_segment_vjp(*carry, bc, *coords, params, 300.0, *carry)
