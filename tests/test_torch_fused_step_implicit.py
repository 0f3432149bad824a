"""One full ImplicitEuler soil step (``terrarium_tpu_torch/ops/fused_step.py::
make_fused_step``, heat + Richards and the heat-only model, Thomas and PCR,
one Picard iteration and more): its plain version against the JAX package's
XLA ``timestepper.step`` and its ``make_fused_step`` (Pallas interpret mode,
as `tests/test_fused_step.py:33-49` runs it), the stored auxiliaries the step
reads, steps against ``run``'s rollout, and the kernel's column code
(``soil::full_step_column`` in ``csrc/soil_full_step.cuh``) compiled for
the host against the plain version. The kernel itself is held to the plain
version on the card in `test_torch_kernel_cuda.py`."""
import ctypes
import pathlib
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.ops.fused_step import make_fused_step as jax_make_fused_step
from terrarium_tpu_torch.convert import state_from_numpy
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.timesteppers.integrator import advance

from test_torch_fused_step import _random_full_state
from test_torch_soil_physics import CELLS, NZ
from torch_parity import CONFIGS, jax_soil, jax_state_arrays, port_soil

HERE = pathlib.Path(__file__).parent
CSRC = HERE.parent / "terrarium_tpu_torch" / "csrc"
DT = 900.0
GROUPS = ("prognostic", "tendencies", "auxiliary")
#: (physics, solver, Picard iterations)
CASES = [("richards", "pcr", 1), ("richards", "thomas", 1), ("richards", "pcr", 2),
         ("richards", "thomas", 2), ("heat", "pcr", 1), ("heat", "thomas", 2)]


def _sim(m, physics, solver, picard, cells=128, nz=10):
    """The bench soil (heat + Richards, ``CONFIGS["bench"]``) or the default
    heat-only model under the bench top temperature, ImplicitEuler at dt
    900 s, float64, in package ``m``."""
    if m is tt:
        grid = tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=nz), nf=np.float64)
    else:
        grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz),
                                dtype=torch.float64, device="cpu")
    cfg = CONFIGS["bench"]
    soil = (jax_soil() if m is tt else port_soil()) if physics == "richards" else None
    model = m.SoilModel(grid=grid, soil=soil) if soil is not None else m.SoilModel(grid=grid)
    inits = cfg["inits"] if physics == "richards" else {
        "temperature": lambda x, z: 1.0 - 0.4 * z + 0.0 * x, "saturation_water_ice": 0.8}
    return m.initialize(model, m.ImplicitEuler(dt=DT, solver=solver, picard_iters=picard),
                        initializers=inits, boundary_conditions=m.PrescribedSurfaceTemperature(
                            cfg["bc_jax"] if m is tt else cfg["bc_torch"]))


def _fused(sim):
    return fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources, dt=DT)


def _leaves(state):
    return {(g, k): v for g in GROUPS for k, v in getattr(state, g).items()}


def _scale(arr):
    return max(float(np.abs(arr).max()), 1e-300)


def assert_step_matches_jax(jsim, jfused, grid, pfused, dt, steps=3):
    """``steps`` full steps along JAX's XLA trajectory from ``jsim``'s
    state: at each, the port's ``pfused`` from JAX's state carried over with
    ``state_from_numpy`` onto ``grid`` against JAX's XLA
    ``timestepper.step`` (``jsim.step_fn``) and JAX's ``jfused`` (its
    ``make_fused_step(interpret=True)``, jitted, so that the interpreter is
    traced once) from the same state: every
    prognostic, tendency and auxiliary within 1e-12 of the leaf's scale of
    the XLA step (a tendency within twice JAX's own Pallas-XLA departure
    where that is larger), and of the Pallas step within twice that
    departure plus 1e-12; the clock exactly. Each step starts from JAX's
    state, so that no step's rounding grows in the next. The scale is the
    leaf's largest magnitude; a tendency's is at least its prognostic's over
    dt (`chip_smoke.check_full_step`'s rule): a tendency is a difference of
    nearly equal fluxes, whose rounding is that of the fluxes, and reaches
    the prognostic times dt (the land's Heun saturation tendency rounds
    1.7e-12 of its own magnitude from JAX's, some 1e-14 of its prognostic's
    over dt)."""
    js = jsim.state
    for step in range(steps):
        pp = pfused(state_from_numpy(jax_state_arrays(js), float(js.clock.time),
                                     int(js.clock.iteration), grid))
        jx, jp = jsim.step_fn(js, dt), jfused(js)
        got, ref_x, ref_p = _leaves(pp), _leaves(jx), _leaves(jp)
        assert sorted(got) == sorted(ref_x), sorted(set(got) ^ set(ref_x))
        for key, t in got.items():
            a, x, p = t.numpy(), np.asarray(ref_x[key]), np.asarray(ref_p[key])
            scale = _scale(x)
            if key[0] == "tendencies":
                scale = max(scale, _scale(np.asarray(js.prognostic[key[1]])) / dt)
            dep = float(np.abs(p - x).max()) / scale
            tol = max(1e-12, 2.0 * dep) if key[0] == "tendencies" else 1e-12
            assert float(np.abs(a - x).max()) <= tol * scale, (step, key, dep)
            assert float(np.abs(a - p).max()) <= (2.0 * dep + 1e-12) * scale, (step, key, dep)
        assert float(pp.clock.time) == float(jx.clock.time) == float(jp.clock.time)
        assert int(pp.clock.iteration) == int(jx.clock.iteration) == step + 1
        js = jx


@pytest.mark.parametrize("physics,solver,picard", CASES)
def test_plain_matches_jax_step_and_pallas(physics, solver, picard):
    """Three full steps along JAX's XLA trajectory from its initialized
    state, each from JAX's state carried over with ``state_from_numpy``:
    every prognostic, tendency and auxiliary and the clock of the port's
    ``make_fused_step`` (the plain version on the CPU) against JAX's XLA
    ``timestepper.step`` and JAX's ``make_fused_step(interpret=True)``
    (:func:`assert_step_matches_jax`)."""
    jsim, psim = _sim(tt, physics, solver, picard), _sim(tp, physics, solver, picard)
    jfused = jax.jit(jax_make_fused_step(jsim.model, jsim.timestepper, jsim.ctx, jsim.input_sources,
                                 dt=DT, block_cells=128, interpret=True))
    assert_step_matches_jax(jsim, jfused, psim.model.grid, _fused(psim), DT)


#: what a full step reads of the stored auxiliaries (JAX's and the port's)
SOIL_STORED_READS = {("auxiliary", "temperature"), ("auxiliary", "liquid_water_fraction"),
                     ("auxiliary", "pressure_head")}


def _perturbed(leaf, rng):
    """``leaf`` moved well beyond rounding: by 5% of its scale and a
    relative 5%, in a random direction per element."""
    x = np.asarray(leaf, dtype=np.float64)
    return x + 0.05 * (np.abs(x) + _scale(x)) * rng.choice([-1.0, 1.0], x.shape)


def _census(step, arrays, make_state):
    """The stored auxiliaries and tendencies whose perturbation moves a leaf
    of ``step(make_state(arrays))`` other than itself."""
    base = {k: np.asarray(v) for k, v in _leaves(step(make_state(arrays))).items()}
    rng = np.random.default_rng(3)
    moves = set()
    for key in arrays:
        group, _, name = key.partition("/")
        if group not in ("auxiliary", "tendencies"):
            continue
        out = _leaves(step(make_state({**arrays, key: _perturbed(arrays[key], rng)})))
        if any(not np.array_equal(np.asarray(v), base[k]) for k, v in out.items()
               if k != (group, name)):
            moves.add((group, name))
    return moves


@pytest.mark.parametrize("solver,picard", [("pcr", 2)])
def test_stored_reads_census(solver, picard):
    """A state stepped twice, each stored auxiliary and tendency perturbed in
    turn, stepped once more: the set that moves any other leaf is {the
    temperature, the liquid fraction, the pressure head}, in JAX's XLA step
    and in the port's plain version alike (the host build's reads are
    pinned in `test_host_full_step_implicit_census`)."""
    jsim, psim = _sim(tt, "richards", solver, picard, 32), _sim(tp, "richards", solver, picard,
                                                               32)
    state = jsim.step_fn(jsim.step_fn(jsim.state, DT), DT)
    arrays = jax_state_arrays(state)
    time, it = float(state.clock.time), int(state.clock.iteration)

    def jax_state(a):
        return jax_state_from(jsim, a, time, it)

    assert _census(lambda s: jsim.step_fn(s, DT), arrays, jax_state) == SOIL_STORED_READS
    pfused = _fused(psim)
    assert _census(pfused, arrays, lambda a: state_from_numpy(
        a, time, it, psim.model.grid)) == SOIL_STORED_READS


def jax_state_from(jsim, arrays, time, iteration):
    """JAX's state of ``jsim`` with its leaves replaced by ``arrays``
    (``"<group>/<name>"``) at the clock ``(time, iteration)``."""
    import dataclasses

    import jax.numpy as jnp

    st = jsim.state
    groups = {g: {k: jnp.asarray(arrays[f"{g}/{k}"]) for k in getattr(st, g)}
              for g in (*GROUPS, "inputs")}
    clock = dataclasses.replace(st.clock, time=jnp.asarray(time, st.clock.time.dtype),
                                iteration=jnp.asarray(iteration, st.clock.iteration.dtype))
    return dataclasses.replace(st, clock=clock, **groups)


@pytest.mark.parametrize("physics,solver,picard", [("richards", "pcr", 2), ("heat", "thomas", 1)])
def test_fused_steps_then_closure_equal_run(physics, solver, picard):
    """12 full steps, then ``closure``, equal ``run``'s rollout (``advance``,
    the closure-rotated steps and the trailing closure) on the prognostics
    and the closure variables at 1e-12; the state handed to ``fused`` is left
    as it was."""
    a, b = (_sim(tp, physics, solver, picard, 24, 12) for _ in range(2))
    fused = _fused(a)
    state = a.state
    before = {k: v.clone() for k, v in state.prognostic.items()}
    for _ in range(12):
        state = fused(state)
    assert all(torch.equal(a.state.prognostic[k], v) for k, v in before.items())
    a.model.closure(state, a.ctx)
    advance(b.model, b.state, b.ctx, 12, DT, timestepper=b.timestepper)
    names = (list(state.prognostic) + ["temperature", "liquid_water_fraction"]
             + (["pressure_head", "water_table"] if physics == "richards" else []))
    for name in names:
        want = b.state[name]
        torch.testing.assert_close(state[name], want, rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()), msg=name)
    assert float(state.clock.time) == float(b.state.clock.time)
    assert int(state.clock.iteration) == 12


# ---------------------------------------------------------------------------
# the kernel's column code, compiled for the host
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def host():
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = pathlib.Path(__import__("tempfile").mkdtemp()) / "full_step_host.so"
    subprocess.run([cxx, "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(out), str(HERE / "full_step_host.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    ptr = ctypes.c_void_p
    lib.host_soil_full_step_implicit.argtypes = ([ptr] * 6 + [ctypes.c_int] * 4
                                                 + [ctypes.c_double, ctypes.c_longlong])
    return lib


_OUT = {"U_out": "prognostic/internal_energy", "dU": "tendencies/internal_energy",
        "T_out": "auxiliary/temperature", "liq_out": "auxiliary/liquid_water_fraction",
        "K_face": "auxiliary/hydraulic_conductivity", "ground_T": "auxiliary/ground_temperature",
        "sat_out": "prognostic/saturation_water_ice", "S_out": "prognostic/surface_excess_water",
        "psi_out": "auxiliary/pressure_head", "water_table": "auxiliary/water_table",
        "dsat": "tendencies/saturation_water_ice", "dS": "tendencies/surface_excess_water"}


def host_full_step(lib, sim, state, solver, picard):
    """``soil::full_step_column`` (ImplicitEuler) over every column of
    ``state``: its outputs keyed as ``_OUT``'s values."""
    heat = "surface_excess_water" not in state.prognostic
    fields = {"U": state.internal_energy, "sat": state.saturation_water_ice,
              "T": state.temperature, "liq": state.liquid_water_fraction}
    if not heat:
        fields.update(S=state.surface_excess_water, psi=state.pressure_head)
    fields = {k: v.contiguous() for k, v in fields.items()}
    top = fs._full_top(sim.model, sim.ctx, state, DT)
    nz, cells = state.internal_energy.shape
    out = {k: torch.full(((nz + 1) if k == "K_face" else nz, cells), np.nan,
                         dtype=torch.float64)
           for k in ("U_out", "dU", "T_out", "liq_out", "sat_out", "dsat", "psi_out", "K_face")}
    out.update({k: torch.full((cells,), np.nan, dtype=torch.float64)
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
    rc = lib.host_soil_full_step_implicit(ctypes.addressof(io), *(c.data_ptr() for c in coords),
                                          ctypes.addressof(cp), nz, int(heat), picard,
                                          fs.SOLVER_CODES[solver], DT, cells)
    assert rc == 0
    keep = set(_OUT) if not heat else {"U_out", "dU", "T_out", "liq_out", "K_face", "ground_T"}
    return {_OUT[k]: v for k, v in out.items() if k in keep}


def _random_implicit(physics, seed, solver, picard):
    sim = _random_full_state(physics, seed)
    sim.timestepper = tp.ImplicitEuler(dt=DT, solver=solver, picard_iters=picard)
    return sim


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("solver,picard", [("pcr", 1), ("thomas", 2), ("pcr", 3)])
@pytest.mark.parametrize("physics", ["richards", "heat"])
def test_host_full_step_implicit_matches_plain(host, physics, solver, picard, seed):
    """``soil::full_step_column``'s ImplicitEuler over `test_torch_fused_step.py`'s
    random full states (Nz 20; stored temperature, liquid fraction and
    pressure head drawn apart from the prognostics) at dt 900 s, against the
    module step at 1e-12 on every leaf (with a floor of 1e-12 of each leaf's
    largest magnitude): the same operations in the same order, FMAs off on
    both sides."""
    sim = _random_implicit(physics, seed, solver, picard)
    got = host_full_step(host, sim, sim.state, solver, picard)
    ref = fs.soil_column_full_step_plain(sim.model, sim.timestepper, sim.ctx, (), sim.state, DT)
    for key, a in got.items():
        group, _, name = key.partition("/")
        want = getattr(ref, group)[name]
        assert bool(torch.isfinite(want).all()), key
        torch.testing.assert_close(a, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()),
                                   msg=key)


def test_host_full_step_implicit_census(host):
    """The host build's reads of the stored auxiliaries, as
    `test_stored_reads_census` pins JAX's and the port's: perturbing the
    stored temperature, liquid fraction or pressure head moves its outputs,
    and the face conductivity, ground temperature, water table and
    tendencies it does not read."""
    sim = _random_implicit("richards", 0, "pcr", 2)
    base = host_full_step(host, sim, sim.state, "pcr", 2)
    rng = np.random.default_rng(4)
    moves = set()
    for group in ("auxiliary", "tendencies"):
        for name, leaf in getattr(sim.state, group).items():
            st = sim.state.copy()
            getattr(st, group)[name] = torch.as_tensor(_perturbed(leaf.numpy(), rng))
            out = host_full_step(host, sim, st, "pcr", 2)
            if any(not torch.equal(v, base[k]) for k, v in out.items()):
                moves.add((group, name))
    assert moves == SOIL_STORED_READS
