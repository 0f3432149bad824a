"""ImplicitEuler and its tridiagonal solves in the port against the JAX
package, at float64 on the CPU unless a test says otherwise.

The JAX references: ``ops/tridiag.py`` (Thomas and PCR), the retention
curves' ``inverse_deriv``, the processes' ``implicit_diffusion_terms`` and
``_assemble_implicit``, ``ImplicitEuler.step`` and ``pre_closure_step``, the
XLA lean rollout, ``Simulation.run``, ``jax.grad`` through the module
rollout, and the ``implicit_freeze`` golden. Both packages take the same
numpy arrays (`torch_parity.py`). The port's fused rollout on the CPU is
the CUDA kernel's plain version (``soil_column_rollout_plain(...,
stepper="implicit")``); the kernel's own column code, compiled for the host,
is held to it in `test_torch_step_host.py`.

The port's saturation adjustment is the reference's sequential sweeps where
JAX runs a closed form over prefix sums; the two round apart by about eps
times a column's water over dz, so saturations that went through an
adjustment are compared at an absolute 1e-12 (ROADMAP Queue C).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.ops.tridiag import tridiag_solve as jax_thomas
from terrarium_tpu.ops.tridiag import tridiag_solve_pcr as jax_pcr
from terrarium_tpu.timesteppers.autodiff import make_rollout_fn as jax_rollout_fn
from terrarium_tpu.timesteppers.implicit import _assemble_implicit
from terrarium_tpu.timesteppers.stepping import update_state as jax_update_state
from terrarium_tpu.utils.scan_dce import _dead_input_mask
from terrarium_tpu_torch.convert import with_differentiable_params
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.ops.tridiag import tridiag_solve, tridiag_solve_pcr
from terrarium_tpu_torch.timesteppers.autodiff import make_rollout_fn
from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout
from terrarium_tpu_torch.timesteppers.implicit import assemble_implicit
from terrarium_tpu_torch.timesteppers.integrator import advance
from terrarium_tpu_torch.timesteppers.stepping import update_state

from test_torch_soil_physics import CELLS, NZ, both_states, _port
from test_torch_step_host import _case as _step_host_case
from test_torch_step_host import plain_implicit_steps, saturated
from torch_parity import (CONFIGS, assert_fields_close, column_implicit_tridiag,
                          hold_until_saturation_flip, implicit_freeze, jax_soil, port_soil)

SOLVERS = ["pcr", "thomas"]
FIELDS = ("internal_energy", "saturation_water_ice", "surface_excess_water", "temperature",
          "pressure_head", "liquid_water_fraction", "water_table", "hydraulic_conductivity")
GOLDEN = pathlib.Path(__file__).parent / "goldens" / "implicit_freeze.npz"


def _assert_state_close(port_state, jax_state, names=FIELDS):
    """Every named field at rtol 1e-12 (floor 1e-12 of its magnitude), the
    saturation at an absolute 1e-12 (the adjustment's rounding)."""
    sat = [s["saturation_water_ice"] for s in (port_state, jax_state)]
    np.testing.assert_allclose(sat[0].detach().numpy(), np.asarray(sat[1]), rtol=0, atol=1e-12)
    assert_fields_close(port_state, jax_state, [n for n in names if n != "saturation_water_ice"])


# ---------------------------------------------------------------------------
# the tridiagonal solves
# ---------------------------------------------------------------------------
def _system(seed, nz, cells=24):
    """A random diagonally dominant system ``(a, b, c, d)``, ``a[0]`` and
    ``c[-1]`` nonzero (both solvers must ignore them)."""
    rng = np.random.default_rng(seed)
    a, c = rng.uniform(-1.0, 0.0, (2, nz, cells))
    b = np.abs(a) + np.abs(c) + rng.uniform(0.1, 2.0, (nz, cells))
    d = rng.normal(size=(nz, cells))
    return a, b, c, d


def _dense_solve(a, b, c, d):
    nz, cells = b.shape
    out = np.empty_like(d)
    for j in range(cells):
        m = np.diag(b[:, j]) + np.diag(a[1:, j], -1) + np.diag(c[:-1, j], 1)
        out[:, j] = np.linalg.solve(m, d[:, j])
    return out


@pytest.mark.parametrize("nz", [1, 2, 16, 30])
@pytest.mark.parametrize("solver", SOLVERS)
def test_solvers_match_jax_and_a_dense_solve(solver, nz):
    """Against JAX's solver of the same name at rtol 1e-14 (the same
    operations in the same order; XLA may reassociate nothing here but its
    division is the same IEEE one), and against numpy's dense LU solve at
    rtol 1e-12 (another algorithm; these systems are well conditioned)."""
    a, b, c, d = _system(nz, nz)
    port = {"pcr": tridiag_solve_pcr, "thomas": tridiag_solve}[solver]
    ref = {"pcr": jax_pcr, "thomas": jax_thomas}[solver]
    got = port(*(torch.as_tensor(x) for x in (a, b, c, d))).numpy()
    want = np.asarray(ref(*(jnp.asarray(x) for x in (a, b, c, d))))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14 * np.abs(want).max())
    np.testing.assert_allclose(got, _dense_solve(a, b, c, d), rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_solvers_differentiate_like_jax():
    """Autograd through either solver equals ``jax.grad`` of JAX's at 1e-12."""
    a, b, c, d = _system(3, 12, cells=5)
    w = np.random.default_rng(4).normal(size=b.shape)
    for port, ref in ((tridiag_solve, jax_thomas), (tridiag_solve_pcr, jax_pcr)):
        ts = [torch.as_tensor(x).requires_grad_() for x in (a, b, c, d)]
        got = torch.autograd.grad((port(*ts) * torch.as_tensor(w)).sum(), ts)
        want = jax.grad(lambda *xs: jnp.sum(ref(*xs) * w), argnums=(0, 1, 2, 3))(
            *(jnp.asarray(x) for x in (a, b, c, d)))
        for g, h in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(h), rtol=1e-12,
                                       atol=1e-12 * float(np.abs(h).max()))


# ---------------------------------------------------------------------------
# the implicit terms
# ---------------------------------------------------------------------------
def _swrcs():
    return {"VanGenuchten": (tt.VanGenuchten(alpha=2.0, n=2.0), tp.VanGenuchten(alpha=2.0, n=2.0)),
            "VanGenuchten n=1.6": (tt.VanGenuchten(alpha=3.5, n=1.6, theta_res=0.05),
                                   tp.VanGenuchten(alpha=3.5, n=1.6, theta_res=0.05)),
            "BrooksCorey": (tt.BrooksCorey(psi_s=0.2, lam=0.4, theta_res=0.03),
                            tp.BrooksCorey(psi_s=0.2, lam=0.4, theta_res=0.03))}


@pytest.mark.parametrize("name", list(_swrcs()))
def test_inverse_deriv_matches_jax(name):
    """d(psi_m)/d(theta) at rtol 1e-13 on saturated and over-saturated
    cells (0), cells a hair below saturation (inside the upper clip),
    near-residual cells (inside the lower clip) and dry cells whose
    derivative the clamp at 1e6 cuts."""
    jax_curve, port_curve = _swrcs()[name]
    por = 0.49
    rng = np.random.default_rng(1)
    theta_res = port_curve.theta_res
    theta = np.concatenate([
        rng.uniform(theta_res, por, 200),                   # unsaturated
        [por, por * 1.2, por - 1e-13, por - 1e-10],         # saturated, inside the upper clip
        theta_res + (por - theta_res) * np.array([0.0, 1e-9, 1e-7, 1e-6, 2e-6]),  # residual
        [theta_res - 0.01]])                                # below residual
    want = np.asarray(jax_curve.inverse_deriv(jnp.asarray(theta), por))
    got = port_curve.inverse_deriv(torch.as_tensor(theta), por).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    assert (want == 0.0).any() and (want == 1e6).any() and ((want > 0) & (want < 1e6)).any()


def _closed_states(seed):
    """The random legal states of `test_torch_soil_physics.py`, closed by
    JAX, through ``update_state`` in both packages."""
    jsim, jstate, psim, _ = both_states(seed)
    closed = jsim.model.closure(jstate, jsim.ctx)
    pstate = _port(closed, psim)
    jstate = jax_update_state(jsim.model, closed, jsim.ctx, ())
    update_state(psim.model, pstate, psim.ctx)
    return jsim, jstate, psim, pstate


@pytest.mark.parametrize("seed", [0, 1])
def test_implicit_terms_and_rows_match_jax(seed):
    """Richards then heat, each term's face conductivities, chain factor
    and scale, and its assembled rows and right-hand side, at rtol 1e-12
    with a floor of 1e-12 of each array's magnitude; the states take
    frozen, plateau, thawed, saturated and drained cells."""
    jsim, jstate, psim, pstate = _closed_states(seed)
    jterms = jsim.model.implicit_terms(jstate, jsim.ctx)
    pterms = psim.model.implicit_terms(pstate, psim.ctx)
    assert [t.var for t in pterms] == [t.var for t in jterms] == [
        "saturation_water_ice", "internal_energy"]
    dt = 900.0
    for jt, pt in zip(jterms, pterms):
        assert pt.phi_var == jt.phi_var
        rows = zip(assemble_implicit(pt, pstate, psim.model.grid, psim.ctx.bcs, dt),
                   _assemble_implicit(jt, jstate, jsim.model.grid, jsim.ctx.bcs, dt))
        for what, got, want in [("K_faces", pt.K_faces, jt.K_faces), ("D", pt.D, jt.D),
                                ("scale", pt.scale, jt.scale),
                                *((f"row {i}", g, w) for i, (g, w) in enumerate(rows))]:
            want = np.broadcast_to(np.asarray(want), tuple(got.shape))
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                       atol=1e-12 * float(np.abs(want).max()),
                                       err_msg=f"{pt.var} {what}")
    plateau = pterms[1].D == 0.0
    assert bool(plateau.any()) and not bool(plateau.all())
    assert bool((pterms[0].D == 0.0).any()) and bool((pterms[0].D > 0.0).any())


def test_noflow_has_heat_terms_only():
    sim = tp.initialize(tp.SoilModel(grid=tp.ColumnGrid.of(
        cells=3, spacing=tp.ExponentialSpacing(N=6), dtype=torch.float64, device="cpu")),
        tp.ImplicitEuler(), initializers={"temperature": 1.0, "saturation_water_ice": 0.5})
    update_state(sim.model, sim.state, sim.ctx)
    assert [t.var for t in sim.model.implicit_terms(sim.state, sim.ctx)] == ["internal_energy"]


# ---------------------------------------------------------------------------
# the module steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("picard", [1, 2])
@pytest.mark.parametrize("method", ["step", "pre_closure_step"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_implicit_steps_match_jax(solver, method, picard):
    """Three steps of ``implicit_freeze``: prognostics, closure and
    auxiliary fields, tendencies and the clock."""
    jsim = implicit_freeze("jax", solver, picard_iters=picard)
    psim = implicit_freeze("port", solver, picard_iters=picard)
    jstate = jsim.state
    for _ in range(3):
        jstate = getattr(jsim.timestepper, method)(jsim.model, jstate, jsim.ctx, (), 3600.0)
        getattr(psim.timestepper, method)(psim.model, psim.state, psim.ctx, (), 3600.0)
    _assert_state_close(psim.state, jstate)
    for k, v in jstate.tendencies.items():
        np.testing.assert_allclose(psim.state.tendencies[k].numpy(), np.asarray(v),
                                   rtol=1e-12, atol=1e-12 * float(np.abs(v).max()), err_msg=k)
    assert psim.current_time == float(jstate.clock.time) == 3 * 3600.0


def test_picard_iterations_change_the_step():
    a, b = implicit_freeze("port"), implicit_freeze("port", picard_iters=2)
    for sim in (a, b):
        sim.timestepper.step(sim.model, sim.state, sim.ctx, (), 3600.0)
    assert not torch.equal(a.state.internal_energy, b.state.internal_energy)


# ---------------------------------------------------------------------------
# the fused rollout (the kernel's plain version on the CPU)
# ---------------------------------------------------------------------------
def _series_sim(solver):
    """``implicit_freeze`` with an hourly (T, cells) series for the top
    temperature, read by the rollout as the kernel reads it."""
    sim = implicit_freeze("port", solver)
    hours = np.arange(0.0, 30 * 3600.0, 3600.0)
    series = (np.linspace(-9.0, 4.0, 6)[None, :]
              + 5.0 * np.sin(2 * np.pi * hours / 86400.0)[:, None])
    src = tp.TimeSeriesInputSource(times=hours, series={"air_temperature": series})
    return tp.initialize(sim.model, sim.timestepper, (src,),
                         initializers={"temperature": lambda x, z: 1.0 + 0.0 * z,
                                       "saturation_water_ice": lambda x, z: np.minimum(
                                           1.0, 0.65 - 0.04 * z)},
                         boundary_conditions=tp.PrescribedSurfaceTemperature("air_temperature"))


@pytest.mark.parametrize("top", ["f(t)", "series"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_plain_rollout_equals_module_steps(solver, top):
    """The plain implicit rollout and ``closure`` after ``pre_closure_step``
    repeated, composed from the modules, are the same arithmetic: bitwise
    with ``f(t)``; with a series, the rollout reads the kernel's ``(t - t0)
    / dts`` form where the source interpolates between its own rows, an ulp
    of the top temperature apart, so 1e-12."""
    build = (lambda: implicit_freeze("port", solver)) if top == "f(t)" else (
        lambda: _series_sim(solver))
    sim, ref = build(), build()
    advance(sim.model, sim.state, sim.ctx, 24, 3600.0, timestepper=sim.timestepper,
            input_sources=sim.input_sources, plain=True)
    for _ in range(24):
        ref.timestepper.pre_closure_step(ref.model, ref.state, ref.ctx, ref.input_sources,
                                         3600.0)
    ref.model.closure(ref.state, ref.ctx)
    tol = 0.0 if top == "f(t)" else 1e-12
    for name in FIELDS[:-1]:  # the modules' K is the last step's start's
        b = ref.state[name]
        torch.testing.assert_close(sim.state[name], b, rtol=tol,
                                   atol=tol * float(b.abs().max()), msg=name)
    if top == "series":
        assert bool((sim.state.liquid_water_fraction < 1.0).any())


@pytest.mark.parametrize("solver", SOLVERS)
def test_run_matches_jax(solver):
    """``Simulation.run`` (the plain version on the CPU) against JAX's XLA
    lean rollout and its ``Simulation.run`` with the same solver, 24 steps
    of ``implicit_freeze``. The XLA rollout's state keeps the hydraulic
    conductivity of its last step's start, which ``run`` recomputes, so it
    is held to the other fields."""
    jsim, psim = implicit_freeze("jax", solver), implicit_freeze("port", solver)
    xla = jsim._rollout_fn(24)(jsim.state, 3600.0)
    jsim.run(steps=24, dt=3600.0)
    psim.run(steps=24, dt=3600.0)
    _assert_state_close(psim.state, xla, FIELDS[:-1])
    _assert_state_close(psim.state, jsim.state)
    assert psim.current_time == jsim.current_time and psim.iteration == jsim.iteration == 24


@pytest.mark.parametrize("route", ["run", "timestep"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_implicit_freeze_golden(solver, route):
    """`tests/goldens/implicit_freeze.npz` (made with PCR) at rtol = atol =
    1e-12 with either solver, through ``Simulation.run`` (the plain version
    of the kernel) and through 48 ``Simulation.timestep`` calls (the
    modules). Thomas and PCR round apart by far less than the tolerance on
    this run (4.7e-6 J/m3 of energies of 1e8, 1.6e-12 degC)."""
    sim = implicit_freeze("port", solver)
    if route == "run":
        sim.run(steps=48, dt=3600.0)
    else:
        for _ in range(48):
            sim.timestep(3600.0, finalize=False)
        sim.compute_auxiliary()
    golden = np.load(GOLDEN)
    for f in golden.files:
        np.testing.assert_allclose(sim.state[f].numpy(), golden[f], rtol=1e-12, atol=1e-12,
                                   err_msg=f)
    assert bool((sim.state.liquid_water_fraction < 1.0).any())


@pytest.mark.parametrize("solver", SOLVERS)
def test_water_identity(solver):
    """W = sum(sat dz) + S of every column is kept through the fused
    rollout to 1e-12: the Richards rows conserve the column sum of dz * du,
    the pool takes what the top spills."""
    sim = _series_sim(solver)
    dz = sim.model.grid.dz

    def water():
        return (sim.state.saturation_water_ice * dz).sum(0) + sim.state.surface_excess_water

    w0 = water()
    sim.run(steps=24, dt=3600.0)
    torch.testing.assert_close(water(), w0, rtol=1e-12, atol=0)


@pytest.mark.parametrize("solver", SOLVERS)
def test_f32_rollout_matches_jax(solver):
    """``column_implicit_tridiag`` on 64 columns at float32, 4 steps of
    900 s, against JAX's float32 XLA rollout at rtol 2e-5, atol 1e-6 (the
    float32 bound of `tests/test_fused_step.py:134-137`); JAX's float32
    adjustment drifts from the float64 result faster than the port's
    sweeps (ROADMAP Queue C), so the comparison stays short. And 24 steps
    against the port's own float64 run at 2e-6 of each field."""
    jsim = column_implicit_tridiag("jax", 64, solver, nz=20)
    psim = column_implicit_tridiag("port", 64, solver, nz=20)
    jstate = jsim._rollout_fn(4)(jsim.state, 900.0)
    psim.run(steps=4)
    for name in ("internal_energy", "saturation_water_ice", "surface_excess_water"):
        np.testing.assert_allclose(psim.state[name].numpy(), np.asarray(jstate[name]),
                                   rtol=2e-5, atol=1e-6, err_msg=name)
    ref = column_implicit_tridiag("port", 64, solver, nz=20, dtype=torch.float64)
    psim.run(steps=20)
    ref.run(steps=24)
    for name in ("internal_energy", "saturation_water_ice", "surface_excess_water"):
        b = ref.state[name]
        torch.testing.assert_close(psim.state[name].double(), b, rtol=2e-6,
                                   atol=2e-6 * float(b.abs().max()), msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_jax_parts_from_the_plain_version_at_900_only_at_saturation_flips(seed):
    """JAX's ``ImplicitEuler.pre_closure_step`` (PCR, the JAX default) and
    the kernel's plain version take 30 steps of 900 s from the random legal
    states of `test_torch_step_host.py`, with its top temperature table
    (to JAX a per-column series at the clock times). Every column is held
    at 3e-11 of each field's magnitude until a step starts with one of its
    levels closed at saturation on one side and below it on the other: the
    closed-form adjustment rounds apart from the sweeps by up to about
    3.4e-13 in sat a step (ROADMAP Queue C), which adds up to 1.0e-11 after
    30 steps in a held column. The flips fall only in columns that start
    with a layer at or within 1e-9 of saturation, from the first step on,
    and part them by up to 0.51 in sat, as the header parts from the plain
    version at the same threshold."""
    carry, top, coords, params = _step_host_case("euler", "richards", "table", seed)
    steps, dt = 30, 900.0
    top = top[:steps]
    times = np.arange(steps + 1) * dt
    series = np.concatenate([top.numpy(), top.numpy()[-1:]])
    jsim = tt.initialize(
        tt.SoilModel(grid=tt.ColumnGrid.of(cells=CELLS, spacing=tt.ExponentialSpacing(N=NZ),
                                           nf=np.float64), soil=jax_soil()),
        tt.ImplicitEuler(dt=dt), initializers=CONFIGS["golden"]["inits"],
        boundary_conditions=tt.PrescribedSurfaceTemperature("top"),
        input_sources=(tt.TimeSeriesInputSource(times=times, series={"top": series}),))
    model, ctx, sources = jsim.model, jsim.ctx, jsim.input_sources
    step = jax.jit(lambda s: jsim.timestepper.pre_closure_step(model, s, ctx, sources, dt))
    close = jax.jit(lambda s: model.closure(s, ctx)["saturation_water_ice"])

    def jax_steps():
        U, sat, S = (x.numpy() for x in carry)
        state = jsim.state.update(internal_energy=U, saturation_water_ice=sat,
                                  surface_excess_water=S)
        for _ in range(steps):
            mask = saturated(torch.as_tensor(np.array(close(state))), params)
            state = step(state)
            yield mask, tuple(torch.as_tensor(np.array(state[n])) for n in (
                "internal_energy", "saturation_water_ice", "surface_excess_water"))

    flipped, gap = hold_until_saturation_flip(
        jax_steps(), plain_implicit_steps(carry, top, coords, params, dt, "pcr"), 3e-11)
    cols = flipped.nonzero().flatten().tolist()
    near = (carry[1] >= 1.0 - 1e-9).any(0)  # a layer at or within 1e-9 of saturation
    assert cols and bool(near[flipped].all()) and gap > 0.3, f"columns {cols}, gap {gap}"


def test_live_carry_matches_jax_dead_input_mask():
    """A traced JAX ``ImplicitEuler.pre_closure_step`` consumes the
    prognostics the port carries and the clock, nothing else."""
    jsim, psim = implicit_freeze("jax"), implicit_freeze("port")
    state = jsim.state
    leaves, treedef = jax.tree.flatten(state)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]]

    def flat_step(lv, d):
        out = jsim.timestepper.pre_closure_step(jsim.model, jax.tree.unflatten(treedef, lv),
                                                jsim.ctx, (), d)
        return jax.tree.leaves(out)

    used = _dead_input_mask(flat_step, leaves, 3600.0)[:len(leaves)]
    live = {p for p, u in zip(paths, used) if u}
    assert live == ({f".prognostic['{n}']" for n in psim.model.live_carry}
                    | {".clock.time", ".clock.iteration"})


def test_heat_only_model_runs_its_plain_version_on_the_cpu():
    """The default (NoFlow) model with ImplicitEuler: on the CPU ``run``
    takes the plain version of its kernel (``soil_column_heat_implicit_
    rollout``), which matches JAX's run."""
    runs = []
    for m, kw in ((tt, dict(nf=np.float64)), (tp, dict(dtype=torch.float64, device="cpu"))):
        grid = m.ColumnGrid.of(cells=5, spacing=m.ExponentialSpacing(N=12), **kw)
        sim = m.initialize(m.SoilModel(grid=grid), m.ImplicitEuler(dt=3600.0, solver="thomas"),
                           initializers={"temperature": lambda x, z: 2.0 - 0.1 * z + 0.0 * x,
                                         "saturation_water_ice": 0.7},
                           boundary_conditions=m.PrescribedSurfaceTemperature(-6.0))
        runs.append(sim.run(steps=24, dt=3600.0))
    assert_fields_close(runs[1].state, runs[0].state,
                        ("internal_energy", "temperature", "liquid_water_fraction"))
    assert bool((runs[1].state.liquid_water_fraction < 1.0).any())


def test_wrapper_on_cpu_runs_the_plain_version():
    sim = column_implicit_tridiag("port", 16, "thomas", dtype=torch.float64)
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    carry = tuple(sim.state.prognostic[n] for n in sim.model.live_carry)
    table = torch.linspace(-3.0, 4.0, 6, dtype=torch.float64)
    params = fs.ColumnParams.of(sim.model, torch.float64)
    before = fs.soil_column_implicit_rollout.launches
    for solver in SOLVERS:
        out = fs.soil_column_implicit_rollout(*carry, table, *coords, params, 900.0,
                                              solver=solver)
        ref = fs.soil_column_rollout_plain(*carry, table, *coords, params, 900.0,
                                           stepper="implicit", solver=solver)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    assert fs.soil_column_implicit_rollout.launches == before
    assert fs.ROLLOUTS[("implicit", "richards")] is fs.soil_column_implicit_rollout
    with pytest.raises(ValueError, match="solver"):
        fs.soil_column_implicit_rollout(*carry, table, *coords, params, 900.0, solver="lu")


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("solver", ["diag_attribution_only", "lu"])
def test_unknown_solver_raises(solver):
    with pytest.raises(ValueError, match="solver"):
        tp.ImplicitEuler(solver=solver)


def test_fused_rollout_refuses_picard_iterations(monkeypatch):
    """The fused rollout takes ImplicitEuler with two Picard iterations,
    with either solver: ``run`` goes through the implicit wrapper with
    ``picard_iters=2`` (its plain version on the CPU, no process-module
    step), equals ``advance(..., plain=True)`` bitwise and matches JAX's
    ``run`` at 1e-12 (the saturation at an absolute 1e-12, the adjustment's
    rounding), 24 steps of ``implicit_freeze``."""
    calls = []
    plain = fs.soil_column_rollout_plain

    def counted(*args, **kwargs):
        calls.append(kwargs.get("picard_iters"))
        return plain(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("a process-module step ran")

    monkeypatch.setattr(fs, "soil_column_rollout_plain", counted)
    monkeypatch.setattr(type(implicit_freeze("port").timestepper), "pre_closure_step", refused)
    for solver in SOLVERS:
        calls.clear()
        sim, ref = (implicit_freeze("port", solver, picard_iters=2) for _ in range(2))
        jsim = implicit_freeze("jax", solver, picard_iters=2)
        sim.run(steps=24, dt=3600.0)
        jsim.run(steps=24, dt=3600.0)
        assert calls == [2], solver
        advance(ref.model, ref.state, ref.ctx, 24, 3600.0, timestepper=ref.timestepper,
                plain=True)
        ref.compute_auxiliary()
        _assert_state_close(sim.state, jsim.state)
        for name in FIELDS:
            torch.testing.assert_close(ref.state[name], sim.state[name], rtol=0, atol=0)
        assert bool((sim.state.liquid_water_fraction < 1.0).any())


def test_fused_grad_refuses_implicit_euler():
    """ImplicitEuler with more than one Picard iteration is taken over the
    SoilModel, with either physics (`tests/test_torch_grad_steppers.py`),
    and over the LandModel, which refused it until the land segment VJP ran
    the iterations: the land rollout's gradient in the initial energy is
    finite and not zero."""
    sim = implicit_freeze("port", picard_iters=2)
    grid = sim.model.grid
    make_fused_grad_rollout(lambda p: tp.SoilModel(grid=grid, soil=port_soil()),
                            sim.timestepper, sim.ctx, steps=4, dt=3600.0, inner_steps=2)
    land = tp.initialize(tp.LandModel(grid=grid), sim.timestepper,
                         initializers={"temperature": 5.0, "saturation_water_ice": 0.8},
                         input_sources=(tp.FieldInputSource(fields={
                             "surface_shortwave_down": 400.0, "air_temperature": 12.0}),))
    roll = make_fused_grad_rollout(lambda p: land.model, land.timestepper, land.ctx, steps=4,
                                   dt=3600.0, inner_steps=2)
    state = land.state.copy()
    U0 = state.internal_energy.clone().requires_grad_()
    state.set(internal_energy=U0)
    (g,) = torch.autograd.grad(roll(state, None).temperature.mean(), U0)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0


# ---------------------------------------------------------------------------
# the module-path gradient
# ---------------------------------------------------------------------------
GRAD_CELLS, GRAD_NZ, GRAD_DT, GRAD_STEPS = 24, 10, 1800.0, 6
X0, K0 = float(np.log(1e-5)), 3.8
GRAD_INITS = {"temperature": lambda x, z: 1.5 * np.cos(2 * np.pi * x) - 0.2 + 0.0 * z,
              "saturation_water_ice": lambda x, z: np.minimum(0.95, 0.6 - 0.04 * z)}


def _jax_grads(solver):
    grid = tt.ColumnGrid.of(cells=GRAD_CELLS, spacing=tt.ExponentialSpacing(N=GRAD_NZ),
                            nf=np.float64)

    def model(x, k):
        props = tt.ConstantSoilHydraulics(sat_hydraulic_cond=jnp.exp(x),
                                          swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
                                          unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
        thermal = tt.SoilThermalProperties(
            conductivities=tt.SoilThermalConductivities(mineral=k))
        return tt.SoilModel(grid=grid, soil=tt.SoilEnergyWaterCarbon(
            energy=tt.SoilEnergyBalance(thermal_properties=thermal),
            hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq(),
                                       hydraulic_properties=props)))

    sim = tt.initialize(model(X0, K0), tt.ImplicitEuler(dt=GRAD_DT, solver=solver),
                        initializers=GRAD_INITS,
                        boundary_conditions=tt.PrescribedSurfaceTemperature(-4.0))

    def loss(x, k):
        roll = jax_rollout_fn(model(x, k), sim.timestepper, sim.ctx, (), steps=GRAD_STEPS)
        out = roll(sim.state, GRAD_DT)
        return jnp.mean(out.temperature) + jnp.mean(out.saturation_water_ice)

    v, g = jax.value_and_grad(loss, argnums=(0, 1))(X0, K0)
    return float(v), float(g[0]), float(g[1])


@pytest.mark.parametrize("solver", SOLVERS)
def test_module_gradient_matches_jax(solver):
    """``make_rollout_fn`` with ImplicitEuler (autograd through the torch
    solver) against ``jax.grad`` of JAX's ``make_rollout_fn``, full steps,
    checkpointed, in log K_sat and the mineral conductivity at rtol 1e-9;
    no layer is exactly saturated, so the sweeps' tie convention does not
    enter. Six 1,800 s steps across the freeze plateau."""
    grid = tp.ColumnGrid.of(cells=GRAD_CELLS, spacing=tp.ExponentialSpacing(N=GRAD_NZ),
                            dtype=torch.float64, device="cpu")
    x = torch.tensor(X0, dtype=torch.float64, requires_grad=True)
    k = torch.tensor(K0, dtype=torch.float64, requires_grad=True)
    model = tp.SoilModel(grid=grid, soil=with_differentiable_params(
        port_soil(), log_sat_hydraulic_cond=x, mineral_conductivity=k))
    sim = tp.initialize(model, tp.ImplicitEuler(dt=GRAD_DT, solver=solver),
                        initializers=GRAD_INITS,
                        boundary_conditions=tp.PrescribedSurfaceTemperature(-4.0))
    roll = make_rollout_fn(model, sim.timestepper, sim.ctx, steps=GRAD_STEPS)
    out = roll(sim.state, GRAD_DT)
    loss = out.temperature.mean() + out.saturation_water_ice.mean()
    gx, gk = torch.autograd.grad(loss, (x, k))
    v, jgx, jgk = _jax_grads(solver)
    np.testing.assert_allclose(float(loss.detach()), v, rtol=1e-10)
    np.testing.assert_allclose(float(gx), jgx, rtol=1e-9)
    np.testing.assert_allclose(float(gk), jgk, rtol=1e-9)
    assert abs(jgx) > 0.0 and abs(jgk) > 0.0
    assert bool((out.liquid_water_fraction < 1.0).any())


# ---------------------------------------------------------------------------
# stiff accuracy (`tests/test_implicit_stiff.py`): the freeze front
# ---------------------------------------------------------------------------
def _freeze_T(stepper, dt, hours=24.0):
    """A saturated heat-only column of 40 layers of 5 cm at 1 degC under a
    -10 degC top, ``hours`` of ``run``."""
    grid = tp.ColumnGrid.of(cells=1, spacing=tp.UniformSpacing(dz=0.05, N=40),
                            dtype=torch.float64, device="cpu")
    sim = tp.initialize(tp.SoilModel(grid=grid), stepper,
                        initializers={"temperature": 1.0, "saturation_water_ice": 1.0},
                        boundary_conditions=tp.PrescribedSurfaceTemperature(-10.0))
    sim.run(steps=int(hours * 3600 / dt), dt=dt)
    return sim.state.temperature[:, 0].numpy()


def test_implicit_freeze_front_accuracy():
    """The bounds of `tests/test_implicit_stiff.py:48-66` against a 10 s
    ForwardEuler trajectory: within 0.05 K at dt 900 and 0.35 K at dt 3600,
    the error shrinking with dt, and the 0 degC crossing within one layer
    at dt 900; with both solvers."""
    T_ref = _freeze_T(tp.ForwardEuler(), dt=10.0)
    for solver in SOLVERS:
        T900, T3600 = (_freeze_T(tp.ImplicitEuler(solver=solver), dt) for dt in (900.0, 3600.0))
        errs = [float(np.max(np.abs(T - T_ref))) for T in (T900, T3600)]
        assert errs[0] < 0.05 and errs[1] < 0.35 and errs[0] < errs[1], (solver, errs)
        assert abs(int(np.argmax(T_ref < 0.0)) - int(np.argmax(T900 < 0.0))) <= 1


def test_implicit_freeze_energy_conservation():
    """With zero-flux ends, ``Simulation.timestep`` keeps sum(U dz) to
    1e-12 (`tests/test_implicit_stiff.py:69-84`)."""
    grid = tp.ColumnGrid.of(cells=1, spacing=tp.UniformSpacing(dz=0.1, N=20),
                            dtype=torch.float64, device="cpu")
    sim = tp.initialize(tp.SoilModel(grid=grid), tp.ImplicitEuler(dt=3600.0),
                        initializers={"temperature": lambda x, z: 1.0 + 0.4 * z,
                                      "saturation_water_ice": 1.0})
    U0 = float((sim.state.internal_energy * grid.dz).sum())
    for _ in range(24):
        sim.timestep(3600.0)
    np.testing.assert_allclose(float((sim.state.internal_energy * grid.dz).sum()), U0,
                               rtol=1e-12)
