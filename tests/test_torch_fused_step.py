"""One full soil step (``terrarium_tpu_torch/ops/fused_step.py::
make_fused_step``): its plain version against the JAX package's
``make_fused_step`` (Pallas interpret mode, as `tests/test_fused_step.py:33-49`
runs it) and against JAX's XLA step, steps against ``run``, the types it
refuses, and the full-step column code of the CUDA kernel
(``csrc/soil_full_step.cuh``) compiled for the host against the plain version.
The kernel itself is held to the plain version on the card in
`test_torch_kernel_cuda.py`."""
import ctypes

import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.ops.fused_step import make_fused_step as jax_make_fused_step
from terrarium_tpu_torch.convert import state_from_numpy
from terrarium_tpu_torch.ops import fused_step as fs

from test_torch_soil_physics import CELLS, NZ, random_state
from test_torch_step_adjoint import host_lib  # noqa: F401  (the compiled headers)
from torch_parity import (CONFIGS, assert_fields_close, jax_soil, jax_state_arrays,
                          port_soil)

RICHARDS_LEAVES = {
    "prognostic": ("internal_energy", "saturation_water_ice", "surface_excess_water"),
    "tendencies": ("internal_energy", "saturation_water_ice", "surface_excess_water"),
    "auxiliary": ("temperature", "liquid_water_fraction", "pressure_head",
                  "hydraulic_conductivity", "ground_temperature", "water_table")}
HEAT_LEAVES = {
    "prognostic": ("internal_energy",), "tendencies": ("internal_energy",),
    "auxiliary": ("temperature", "liquid_water_fraction", "hydraulic_conductivity",
                  "ground_temperature", "saturation_water_ice", "water_table")}


def _sim(m, physics, stepper, cells, nz, dtype=torch.float64):
    """The bench composition (heat + Richards, top temperature 5 sin(2 pi t /
    86400) as ``f(t)``) or the default heat-only model with the top
    temperature an input variable of a static source, in package ``m``."""
    if m is tt:
        grid = tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=nz),
                                nf=np.float32 if dtype == torch.float32 else np.float64)
    else:
        grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=dtype,
                                device="cpu")
    ts = m.Heun(dt=60.0) if stepper == "heun" else m.ForwardEuler(dt=60.0)
    if physics == "richards":
        cfg = CONFIGS["bench"]
        return m.initialize(
            m.SoilModel(grid=grid, soil=jax_soil() if m is tt else port_soil()), ts,
            initializers=cfg["inits"], boundary_conditions=m.PrescribedSurfaceTemperature(
                cfg["bc_jax"] if m is tt else cfg["bc_torch"]))
    top = np.linspace(-8.0, 6.0, cells)
    return m.initialize(
        m.SoilModel(grid=grid), ts,
        (m.FieldInputSource(fields={"surface_temperature": top}),),
        initializers={"temperature": lambda x, z: 0.5 + 0.1 * z + 0.0 * x,
                      "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.7 - 0.03 * z)},
        boundary_conditions=m.PrescribedSurfaceTemperature("surface_temperature"))


def _fused(sim):
    return fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources,
                              dt=60.0, block_cells=64)


def _assert_every_leaf(pstate, jstate, leaves, rtol, atol=None):
    """Every leaf of ``leaves`` (and no other of the group), and the clock."""
    for group, names in leaves.items():
        assert sorted(getattr(pstate, group)) == sorted(names), group
        for name in names:
            got = getattr(pstate, group)[name].numpy()
            ref = np.asarray(getattr(jstate, group)[name])
            floor = atol if atol is not None else rtol * max(float(np.abs(ref).max()), 1e-300)
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=floor,
                                       err_msg=f"{group}/{name}")
    assert float(pstate.clock.time) == float(jstate.clock.time)
    assert int(pstate.clock.iteration) == int(jstate.clock.iteration)


def _pallas_pair(nf, dtype):
    """`tests/test_fused_step.py:16-30`'s bench soil (96 cells, Nz 12, top
    temperature 5 degC) in both packages at one precision, JAX's
    ``make_fused_step`` in interpret mode (``block_cells=64``) and the
    port's, from JAX's initialized state carried over with
    ``state_from_numpy``."""
    sims = []
    for m in (tt, tp):
        grid = (tt.ColumnGrid.of(cells=96, spacing=tt.ExponentialSpacing(N=12), nf=nf)
                if m is tt else tp.ColumnGrid.of(cells=96, spacing=tp.ExponentialSpacing(N=12),
                                                 dtype=dtype, device="cpu"))
        sims.append(m.initialize(
            m.SoilModel(grid=grid, soil=jax_soil() if m is tt else port_soil()),
            m.ForwardEuler(dt=60.0), initializers=CONFIGS["bench"]["inits"],
            boundary_conditions=m.PrescribedSurfaceTemperature(5.0)))
    jsim, psim = sims
    jfused = jax_make_fused_step(jsim.model, jsim.timestepper, jsim.ctx, jsim.input_sources,
                                 dt=60.0, block_cells=64, interpret=True)
    return jsim, jfused, psim, _fused(psim)


def _steps(fused, state, n=3):
    for _ in range(n):
        state = fused(state)
    return state


def test_plain_matches_jax_pallas_fused_step():
    """`tests/test_fused_step.py:33-49`'s configuration, 3 steps from the
    initialized state, against JAX's ``make_fused_step`` in interpret mode:
    every prognostic, tendency and auxiliary, and the clock.

    float64: at rtol 1e-12. float32: at JAX's rtol 2e-6 / atol 1e-6, the
    absolute floor of each leaf raised to JAX's own float32 departure from
    its float64 step from the same start, where that is larger, and the
    port's own float32 departure held within twice JAX's. Two leaves need
    the raised floor: JAX's closed-form saturation adjustment leaves the
    saturation 2.3e-6 from float64 in 3 steps where the port's sweeps leave
    3.5e-7 (ROADMAP Queue C), which the pressure head carries; the energy
    tendency, a difference of nearly equal fluxes, rounds 6e-4 J/m^3/s
    from float64 in JAX and 8.7e-4 in the port. Both start from JAX's
    initialized state, since JAX's float32 initialization closes the
    saturation by that closed form too."""
    jsim64, jfused64, psim64, pfused64 = _pallas_pair(np.float64, torch.float64)
    j64 = _steps(jfused64, jsim64.state)
    p64 = _steps(pfused64, psim64.state)
    _assert_every_leaf(p64, j64, RICHARDS_LEAVES, rtol=1e-12)

    jsim, jfused, psim, pfused = _pallas_pair(np.float32, torch.float32)
    arrays = jax_state_arrays(jsim.state)
    j32 = _steps(jfused, jsim.state)
    p32 = _steps(pfused, state_from_numpy(arrays, 0.0, 0, psim.model.grid))
    exact = _steps(pfused64, state_from_numpy(arrays, 0.0, 0, psim64.model.grid))
    for group, names in RICHARDS_LEAVES.items():
        assert sorted(getattr(p32, group)) == sorted(names), group
        for name in names:
            ref = np.asarray(getattr(j32, group)[name], dtype=np.float64)
            got = getattr(p32, group)[name].numpy().astype(np.float64)
            f64 = getattr(exact, group)[name].numpy()
            jax_err, port_err = np.abs(ref - f64).max(), np.abs(got - f64).max()
            np.testing.assert_allclose(got, ref, rtol=2e-6, atol=max(1e-6, jax_err),
                                       err_msg=f"{group}/{name}")
            assert port_err <= max(2.0 * jax_err, 1e-6), (group, name, port_err, jax_err)
    assert float(p32.clock.time) == float(j32.clock.time)
    assert int(p32.clock.iteration) == int(j32.clock.iteration)


@pytest.mark.parametrize("stepper", ["euler", "heun"])
@pytest.mark.parametrize("physics", ["richards", "heat"])
def test_plain_matches_jax_step_f64(physics, stepper):
    """Three full steps at float64 against JAX's ``sim.step_fn``: every
    leaf at rtol 1e-12 (with a floor of 1e-12 of each field's largest
    magnitude), and the clock."""
    jsim, psim = (_sim(m, physics, stepper, 24, 15) for m in (tt, tp))
    fused = _fused(psim)
    jstate, pstate = jsim.state, psim.state
    for _ in range(3):
        jstate, pstate = jsim.step_fn(jstate, 60.0), fused(pstate)
    _assert_every_leaf(pstate, jstate,
                       RICHARDS_LEAVES if physics == "richards" else HEAT_LEAVES, rtol=1e-12)


@pytest.mark.parametrize("stepper", ["euler", "heun"])
@pytest.mark.parametrize("physics", ["richards", "heat"])
def test_fused_steps_then_closure_equal_run(physics, stepper):
    """``n`` full steps, then ``closure``, equal ``run(n)`` (the closure-
    rotated rollout) on the prognostics and the closure variables at 1e-12,
    the pairing of JAX's `test_fused_lean_rollout_matches_lean_rollout`; the
    state handed to ``fused`` is left as it was."""
    a, b = (_sim(tp, physics, stepper, 24, 15) for _ in range(2))
    fused = _fused(a)
    state = a.state
    before = {k: v.clone() for k, v in state.prognostic.items()}
    for _ in range(12):
        state = fused(state)
    assert all(torch.equal(a.state.prognostic[k], v) for k, v in before.items())
    a.model.closure(state, a.ctx)
    b.run(steps=12)
    names = (list(state.prognostic) + ["temperature", "liquid_water_fraction"]
             + (["pressure_head", "water_table"] if physics == "richards" else []))
    assert_fields_close(state, {k: b.state[k].numpy() for k in names}, names)
    assert float(state.clock.time) == b.current_time and int(state.clock.iteration) == 12


def test_wrapper_on_cpu_runs_the_plain_version():
    sim = _sim(tp, "richards", "euler", 8, 15)
    before = fs.soil_column_full_step.launches
    out = fs.soil_column_full_step(sim.model, sim.timestepper, sim.ctx, (), sim.state, 60.0)
    ref = fs.soil_column_full_step_plain(sim.model, sim.timestepper, sim.ctx, (), sim.state,
                                         60.0)
    assert fs.soil_column_full_step.launches == before
    for group in ("prognostic", "tendencies", "auxiliary"):
        for k, v in getattr(ref, group).items():
            assert torch.equal(getattr(out, group)[k], v), (group, k)


def _refused(name):
    """A composition of the bench soil that the full-step kernel refuses,
    and what the error names."""
    grid = tp.ColumnGrid.of(cells=4, spacing=tp.ExponentialSpacing(N=12), dtype=torch.float64,
                            device="cpu")
    model, ts = tp.SoilModel(grid=grid, soil=port_soil()), tp.ForwardEuler(dt=60.0)
    bcs, sources, forcings = tp.PrescribedSurfaceTemperature(5.0), (), None
    if name == "time-varying source":
        sources = (tp.TimeSeriesInputSource(times=np.array([0.0, 3600.0]),
                                            series={"surface_temperature": np.zeros(2)}),)
    elif name == "forcings":
        forcings = {"internal_energy": lambda s, g: 1.0}
    elif name == "GeothermalHeatFlux":
        bcs = {**bcs, **tp.GeothermalHeatFlux(0.05)}
    elif name == "f(t, state)":
        bcs = tp.PrescribedSurfaceTemperature(lambda t, state: 5.0 + 0.0 * t)
    elif name == "ImplicitEuler":
        ts = tp.ImplicitEuler(dt=60.0)
    elif name == "LandModel":
        model, bcs = tp.LandModel(grid=grid), None
    elif name == "UnsatKVanGenuchten":
        model = tp.SoilModel(grid=grid, soil=tp.SoilEnergyWaterCarbon(
            hydrology=tp.SoilHydrology(hydraulic_properties=port_soil().hydrology
                                       .hydraulic_properties)))
    sim = tp.initialize(model, ts, sources, initializers={"temperature": 1.0},
                        boundary_conditions=bcs, forcings=forcings)
    return sim


@pytest.mark.parametrize("name", ["time-varying source", "forcings", "GeothermalHeatFlux",
                                  "f(t, state)", "ImplicitEuler", "LandModel",
                                  "UnsatKVanGenuchten"])
def test_refuses_by_type(name):
    """Each refusal is a ``ValueError`` at ``make_fused_step`` naming
    ``Simulation.timestep``, which steps the composition."""
    sim = _refused(name)
    with pytest.raises(ValueError, match="Simulation.timestep"):
        fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources, dt=60.0)
    sim.timestep(60.0)
    assert bool(torch.isfinite(sim.state.internal_energy).all())


# ---------------------------------------------------------------------------
# the kernel's column code, compiled for the host
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lib(host_lib):  # noqa: F811
    ptr = ctypes.c_void_p
    host_lib.host_full_step.argtypes = ([ptr] * 6 + [ctypes.c_int] * 3
                                        + [ctypes.c_double, ctypes.c_longlong])
    return host_lib


def _random_full_state(physics, seed):
    """A bench-soil (or heat-only) state on ``CELLS`` columns at Nz 20 with
    `test_torch_soil_physics.py`'s random legal carry, which reaches every
    branch of the step, and stored temperature, liquid fraction and pressure
    head drawn apart from it, so that the step shows it reads them as
    stored."""
    grid = tp.ColumnGrid.of(cells=CELLS, spacing=tp.ExponentialSpacing(N=NZ),
                            dtype=torch.float64, device="cpu")
    soil = port_soil() if physics == "richards" else tp.SoilEnergyWaterCarbon()
    sim = tp.initialize(tp.SoilModel(grid=grid, soil=soil), tp.ForwardEuler(dt=60.0),
                        initializers={"temperature": 1.0},
                        boundary_conditions=tp.PrescribedSurfaceTemperature(
                            lambda t: -3.0 + 4.0 * torch.sin(2 * torch.pi * t / 7200.0)))
    U, sat, S = (torch.as_tensor(a) for a in random_state(seed))
    rng = np.random.default_rng(seed + 50)
    stored = dict(internal_energy=U, temperature=rng.uniform(-12.0, 9.0, (NZ, CELLS)),
                  liquid_water_fraction=rng.choice([0.0, 1.0], (NZ, CELLS))
                  * rng.uniform(0.2, 1.0, (NZ, CELLS)))
    if physics == "richards":
        stored.update(saturation_water_ice=sat, surface_excess_water=S,
                      pressure_head=rng.uniform(-6.0, 1.0, (NZ, CELLS)))
    else:
        stored.update(saturation_water_ice=sat.clamp(0.0, 1.0))
    sim.state.set(**{k: torch.as_tensor(v).contiguous() for k, v in stored.items()})
    sim.state.clock.time = torch.tensor(1800.0, dtype=torch.float64)
    return sim


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("stepper", ["euler", "heun"])
@pytest.mark.parametrize("physics", ["richards", "heat"])
def test_host_full_step_column_matches_plain(lib, physics, stepper, seed):
    """``soil::full_step_column`` over every column, the top temperature at
    t and t + dt from the BC, against the module step at 1e-12 on every
    leaf (with a floor of 1e-12 of each field's largest magnitude): the same
    operations in the same order, FMAs off on both sides."""
    sim = _random_full_state(physics, seed)
    if stepper == "heun":
        sim.timestepper = tp.Heun(dt=60.0)
    heat = physics == "heat"
    st = sim.state
    fields = {"U": st.internal_energy, "sat": st.saturation_water_ice, "T": st.temperature,
              "liq": st.liquid_water_fraction}
    if not heat:
        fields.update(S=st.surface_excess_water, psi=st.pressure_head)
    top = fs._full_top(sim.model, sim.ctx, st, 60.0)
    out = {k: torch.full((NZ, CELLS), np.nan, dtype=torch.float64)
           for k in ("U_out", "dU", "T_out", "liq_out", "sat_out", "dsat", "psi_out")}
    out["K_face"] = torch.full((NZ + 1, CELLS), np.nan, dtype=torch.float64)
    out.update({k: torch.full((CELLS,), np.nan, dtype=torch.float64)
                for k in ("ground_T", "S_out", "dS", "water_table")})
    io = fs._CFullStepIO(**{k: v.data_ptr() for k, v in {**fields, **out}.items()},
                         top=top.data_ptr(), top_row_stride=top.stride(0),
                         top_cell_stride=top.stride(1) if top.dim() == 2 else 0)
    params = fs.ColumnParams.of(sim.model, torch.float64)
    if heat:
        params = fs.dataclasses.replace(params, K_sat=1.0e-5)
    cp = fs._CParams.of(params)
    g = sim.model.grid
    coords = [getattr(g, n)[:, 0].contiguous() for n in ("dz", "dz_faces", "z_centers",
                                                         "z_faces")]
    rc = lib.host_full_step(ctypes.addressof(io), *(c.data_ptr() for c in coords),
                            ctypes.addressof(cp), NZ, int(stepper == "heun"), int(heat), 60.0,
                            CELLS)
    assert rc == 0
    ref = fs.soil_column_full_step_plain(sim.model, sim.timestepper, sim.ctx, (), st, 60.0)
    pairs = [("U_out", ref.internal_energy), ("dU", ref.tendencies["internal_energy"]),
             ("T_out", ref.temperature), ("liq_out", ref.liquid_water_fraction),
             ("K_face", ref.hydraulic_conductivity), ("ground_T", ref.ground_temperature)]
    if not heat:
        pairs += [("sat_out", ref.saturation_water_ice), ("S_out", ref.surface_excess_water),
                  ("psi_out", ref.pressure_head), ("water_table", ref.water_table),
                  ("dsat", ref.tendencies["saturation_water_ice"]),
                  ("dS", ref.tendencies["surface_excess_water"])]
    for name, want in pairs:
        assert bool(torch.isfinite(want).all()), name
        torch.testing.assert_close(out[name], want, rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()), msg=name)
