"""The group rollout kernel's column code (``soil::GroupColumn`` in
``csrc/soil_group_step.cuh``: a column spread over a group of G lanes,
ForwardEuler and Heun over heat + Richards), compiled for the host by the
C++ compiler with each group's lanes emulated in lockstep
(``soil::HostLanes``), against the one-thread-a-column rollout loop that it
replaces on the card (``soil::rollout_column`` of ``csrc/soil_step.cuh``,
the loop ``host_rollout_scheme`` runs) bit for bit, and against the plain
PyTorch version at float64.

Both builds contract no multiply-adds, so the group step, which forms each
value by the operations of the one-thread step in the same order, equals
it bitwise at every depth and group size; the plain version differs only
where ``cbrt`` and torch's ``pow(x, 1/3)`` round apart. Where that parts a
Heun stage at saturation, the step is held to JAX's XLA step, which takes
``cbrt`` as the kernels do. The states are
`test_torch_soil_physics.py`'s random legal states (resampled to the depth)
and columns built so that the sweeps hand a carry from lane to lane: a run
of over-saturated levels across a lane boundary and a long wet run (the up
sweep), a negative saturation at a lane's bottom level and a deep deficit
at the top (the down sweep), and fully saturated columns (the water table
at the surface). The emulation counts each column's hand-offs; the test
holds that the crossing columns took them.
"""
import ctypes
import functools
import pathlib
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.processes.soil.hydrology import saturation_sweeps

from test_torch_soil_physics import NZ as RANDOM_NZ, random_state
from torch_parity import CONFIGS, jax_soil, port_sim

HERE = pathlib.Path(__file__).parent
CSRC = HERE.parent / "terrarium_tpu_torch" / "csrc"
NZS = (10, 15, 20, 30, 40)
STEPS, DT = 30, 60.0
SERIES_ROWS, SERIES_T0, SERIES_DTS = 6, 100.0, 250.0
STEPPERS = {"euler": 0, "heun": 1}
# the crossing columns, appended to the random state's 48
UP, DOWN, SATURATED = ("up_run", "up_long"), ("down_bottom", "down_deep"), ("all_one",
                                                                           "all_spill")
CROSSING = UP + DOWN + SATURATED


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    so = tmp_path_factory.mktemp("soil_group_step_host") / "soil_group_step_host.so"
    subprocess.run([cxx, "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(HERE / "soil_group_step_host.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    ptr, ll, i32, f64 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
    head = [ptr] * 4 + [ll, ll, i32] + [f64] * 3 + [ptr] * 5
    lib.host_thread_rollout.argtypes = head + [i32] * 3 + [f64, ll]
    lib.host_group_rollout.argtypes = head + [i32] * 4 + [f64, ll, ptr]
    lib.host_group_lanes.argtypes = [i32]
    return lib


def crossing_columns(dz, lanes):
    """Saturations ``(nz, len(CROSSING))`` on the layers ``dz`` whose sweeps
    cross lanes of ``lanes`` levels (L): the up sweep's carry leaves lane 0
    in ``up_run`` and climbs through half the column in ``up_long``; the
    down sweep's leaves lane 1 in ``down_bottom`` and, in ``down_deep``,
    sinks from the top level, whose deficit is half the water of the levels
    below, to the bottom; every level saturated in ``all_one``, and with a
    spill into the pool in ``all_spill``."""
    dz = np.asarray(dz, dtype=np.float64)
    nz = dz.shape[0]
    sat = np.full((nz, len(CROSSING)), 0.6)
    run = slice(max(lanes - 2, 0), min(lanes + 2, nz - 1))
    sat[run, 0] = 1.3
    sat[: nz // 2, 1] = 1.05
    sat[min(lanes, nz - 2), 2] = -0.4
    sat[:, 3] = 0.2
    sat[-1, 3] = -0.1 * dz[:-1].sum() / dz[-1]
    sat[:, 4] = 1.0
    sat[:, 5] = 1.02
    return sat


def _case(lib, nz, top_kind, lanes_for, seed=0):
    """Carry (the random state resampled to ``nz`` levels, then the
    crossing columns of the group size ``lanes_for``), top temperature,
    coordinates and float64 parameters."""
    U, sat, S = random_state(seed)
    rows = np.round(np.linspace(0, RANDOM_NZ - 1, nz)).astype(int)
    U, sat = U[rows], sat[rows]
    lanes = -(-nz // lanes_for)
    extra = crossing_columns(port_sim("golden", 1, nz).model.grid.dz[:, 0], lanes)
    U = np.concatenate([U, U[:, 36:36 + extra.shape[1]]], axis=1)  # on the freeze plateau
    sat = np.concatenate([sat, extra], axis=1)
    S = np.concatenate([S, np.full(extra.shape[1], 0.01)])
    cells = sat.shape[1]
    sim = port_sim("golden", cells, nz)
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    rng = np.random.default_rng(seed + 100)
    if top_kind == "table":
        top = torch.as_tensor(rng.uniform(-6.0, 8.0, (STEPS + 1, cells)))
    else:
        top = fs.SeriesBC(torch.as_tensor(rng.uniform(-6.0, 8.0, (SERIES_ROWS, cells))),
                          SERIES_T0, SERIES_DTS, 0.0, STEPS)
    carry = tuple(torch.as_tensor(a).contiguous() for a in (U, sat, S))
    return carry, top, coords, fs.ColumnParams.of(sim.model, torch.float64)


def _top_args(top, stepper):
    if isinstance(top, fs.SeriesBC):
        return top.values, SERIES_ROWS, (top.t0, top.dts, top.time)
    return (top if stepper == "heun" else top[:STEPS]), 0, (0.0, 0.0, 0.0)


def run_host(lib, carry, top, coords, params, nz, stepper, g=None, steps=STEPS):
    """``steps`` steps of the host rollout, one thread a column (``g``
    None) or on groups of ``g`` lanes; the new carry and, on groups, each
    column's up and down hand-offs."""
    out = tuple(t.clone() for t in carry)
    data, rows, series = _top_args(top, stepper)
    cells = out[0].shape[1]
    cp = fs._CParams.of(params)  # held until the call returns
    head = (*(t.data_ptr() for t in (*out, data)), data.stride(0), data.stride(1), rows,
            *series, *(c.data_ptr() for c in coords), ctypes.addressof(cp), nz)
    if g is None:
        assert lib.host_thread_rollout(*head, STEPPERS[stepper], steps, DT, cells) == 0
        return out, None
    handoffs = torch.zeros(2, cells, dtype=torch.int64)
    assert lib.host_group_rollout(*head, g, STEPPERS[stepper], steps, DT, cells,
                                  handoffs.data_ptr()) == 0
    return out, handoffs


@pytest.mark.parametrize("group", ["kernel", 4, 32])
@pytest.mark.parametrize("top_kind", ["table", "series"])
@pytest.mark.parametrize("stepper", list(STEPPERS))
@pytest.mark.parametrize("nz", NZS)
def test_group_step_equals_the_thread_step_bitwise(lib, nz, stepper, top_kind, group):
    """The group step at the kernel's group size for ``nz`` and at G 4
    equals ``soil::rollout_column`` bit for bit over 30 steps on every
    column, and the crossing columns took the sweeps' hand-offs."""
    g = lib.host_group_lanes(nz) if group == "kernel" else group
    carry, top, coords, params = _case(lib, nz, top_kind, g)
    want, _ = run_host(lib, carry, top, coords, params, nz, stepper)
    got, handoffs = run_host(lib, carry, top, coords, params, nz, stepper, g)
    for name, a, b in zip(("U", "sat", "S"), got, want):
        assert bool(torch.isfinite(b).all()), name
        assert torch.equal(a, b), (name, (a != b).nonzero()[:5].tolist())
    crossing = handoffs[:, -len(CROSSING):]
    up, down = crossing[0], crossing[1]
    assert bool((up[:len(UP)] > 0).all()), up.tolist()
    assert bool((down[len(UP):len(UP) + len(DOWN)] > 0).all()), down.tolist()


def _step_top(top, stepper, i, time):
    """The top temperature of step ``i`` alone, from clock time ``time``."""
    if isinstance(top, fs.SeriesBC):
        return fs.SeriesBC(top.values, top.t0, top.dts, time, 1)
    return top[i:i + 2] if stepper == "heun" else top[i:i + 1]


def stage_at_saturation(carry, top_i, coords, params):
    """The columns whose Heun stage, as the plain version forms it from
    ``carry``, closes a level below saturation by less than 1e-12: there
    the stage's ``sat < 1`` (the water table) and ``se >= 1`` (the head)
    fall on either side of an ulp, and so does the second closure's flux."""
    v0 = fs._top_reader(top_i, 1, DT, torch.float64, "cpu")(0)
    sat, _, _, fsat, *_ = fs._plain_rhs(*carry, v0, *(c[:, None] for c in coords), params,
                                        False)
    stage = saturation_sweeps(sat + fsat * DT, coords[0][:, None])[0]
    return ((stage < 1.0) & (stage > 1.0 - 1e-12)).any(0)


@functools.lru_cache(maxsize=None)
def jax_heun_step(nz, cells):
    """JAX's Heun ``pre_closure_step`` (XLA, float64) on ``cells`` columns
    of the golden soil at ``nz`` levels, jitted: ``step(state, top)`` with
    the top temperature ``top[0]`` at the step's start and ``top[1]`` at
    its end (a two-row series from clock time 0); and the initial state."""
    times = np.array([0.0, DT])
    jsim = tt.initialize(
        tt.SoilModel(grid=tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=nz),
                                           nf=np.float64), soil=jax_soil()),
        tt.Heun(dt=DT), initializers=CONFIGS["golden"]["inits"],
        boundary_conditions=tt.PrescribedSurfaceTemperature("top"),
        input_sources=(tt.TimeSeriesInputSource(times=times,
                                                series={"top": np.zeros((2, cells))}),))

    def step(state, top):
        sources = (tt.TimeSeriesInputSource(times=times, series={"top": top}),)
        return jsim.timestepper.pre_closure_step(jsim.model, state, jsim.ctx, sources, DT)
    return jsim.state, jax.jit(step)


def jax_heun(carry, top_i, nz):
    """JAX's Heun step from ``carry`` with the top temperatures of
    ``top_i`` as the port reads them at the step's two clock times."""
    cells = carry[0].shape[1]
    state, step = jax_heun_step(nz, cells)
    read = fs._top_reader(top_i, 1, DT, torch.float64, "cpu")
    top = np.stack([np.broadcast_to(read(j).numpy(), (cells,)) for j in (0, 1)])
    out = step(state.update(internal_energy=carry[0].numpy(),
                            saturation_water_ice=carry[1].numpy(),
                            surface_excess_water=carry[2].numpy()), top)
    return tuple(torch.as_tensor(np.array(out[n])) for n in (
        "internal_energy", "saturation_water_ice", "surface_excess_water"))


@pytest.mark.parametrize("group", ["kernel", 4, 32])
@pytest.mark.parametrize("top_kind", ["table", "series"])
@pytest.mark.parametrize("stepper", list(STEPPERS))
@pytest.mark.parametrize("nz", NZS)
def test_group_step_matches_plain(lib, nz, stepper, top_kind, group):
    """The group step at the kernel's group size for ``nz`` and at G 4
    against ``soil_column_rollout_plain``, one step at a time along the
    plain version's trajectory over 30 steps (the clock and, for a series,
    its read at each step's time): U and sat at 1e-12 of the field's
    magnitude, the surface pool at 1e-12 of its own, every column at every
    ForwardEuler step and every Heun step but one whose stage closes a
    level within 1e-12 below saturation (`stage_at_saturation`; the
    one-thread host build, bitwise the group step, parts from the plain
    version there the same way, by up to about 1e-7 in sat, as the two
    take ``cbrt`` and ``pow(x, 1/3)``). Rolled freely instead, the two also
    part where a level closes within about 1e-10 of saturation: Mualem's 1
    - (1 - se^(2/3))^(1/2) magnifies that ulp by 1 / (1 - se^(2/3)).

    Those Heun column-steps (7.4-20.1% of a case's, 16.3% of all 48,600;
    each case's share printed) are held, at the kernel's group size (the
    others equal it bitwise), to JAX's XLA step from the same carry: each field within 1e-12 of its magnitude of the plain version's,
    or no farther from JAX's than twice the plain version's distance from it
    plus 1e-12 of the magnitude (JAX's closed-form saturation adjustment
    rounds the stage apart from both, by up to 7.5e-7 in sat). At most 1%
    of them (and one), each within 5e-7 of sat's magnitude, may miss that: the
    stage's first tendency an ulp apart puts a level on the other side of
    saturation in the host build alone (ROADMAP Queue C)."""
    g = lib.host_group_lanes(nz) if group == "kernel" else group
    carry, top, coords, params = _case(lib, nz, top_kind, g)
    time, let_go, parts = 0.0, 0, 0
    for i in range(STEPS):
        top_i = _step_top(top, stepper, i, time)
        got, _ = run_host(lib, carry, top_i, coords, params, nz, stepper, g, steps=1)
        held = torch.ones(carry[0].shape[1], dtype=torch.bool)
        if stepper == "heun":
            held = ~stage_at_saturation(carry, top_i, coords, params)
            let_go += int((~held).sum())
        start = carry
        carry = fs.soil_column_rollout_plain(*carry, top_i, *coords, params, DT,
                                             stepper=stepper)
        if group == "kernel" and not bool(held.all()):  # the let-go ones against JAX
            xla, out = jax_heun(start, top_i, nz), torch.zeros_like(held)
            for a, b, c in zip(got, carry, xla):
                scale = 1e-12 * float(c.abs().max())
                far = ((a - c).abs() > 2.0 * (b - c).abs() + scale) & ((a - b).abs() > scale)
                far = (far.any(0) if far.dim() == 2 else far) & ~held
                gap = (a - c).abs()
                gap = gap.amax(0) if gap.dim() == 2 else gap
                assert float((gap * far).max()) <= 5e-7 * float(c.abs().max())
                out |= far
            parts += int(out.sum())
        for name, a, b in zip(("U", "sat"), got, carry):
            assert bool(torch.isfinite(b).all()), name
            torch.testing.assert_close(a[:, held], b[:, held], rtol=1e-12,
                                       atol=1e-12 * float(b.abs().max()),
                                       msg=f"step {i + 1}: {name}")
        torch.testing.assert_close(got[2][held], carry[2][held], rtol=1e-12, atol=0.0,
                                   msg=f"step {i + 1}: S")
        time = time + DT
    # the rule lets a small share of the column-steps go, and JAX holds them
    print(f"let-go column-steps {let_go} of {STEPS * carry[0].shape[1]}; the host parts from "
          f"JAX and the plain version at {parts}")
    assert let_go <= 0.25 * STEPS * carry[0].shape[1], let_go
    assert parts <= 0.01 * let_go + 1, (parts, let_go)


@pytest.mark.parametrize("nz", NZS)
def test_crossing_columns_take_the_branches(lib, nz):
    """The saturation adjustment of the crossing columns as built: the
    fully saturated ones close with every level at 1 (the water table at
    the surface), ``all_spill`` spills into the pool, and the down-sweep
    columns end with no negative level."""
    lanes = -(-nz // lib.host_group_lanes(nz))
    dz = port_sim("golden", 1, nz).model.grid.dz[:, :1]
    sat = torch.as_tensor(crossing_columns(dz[:, 0], lanes))
    closed, spill = saturation_sweeps(sat, dz)
    full = [CROSSING.index(n) for n in SATURATED]
    assert bool((closed[:, full] == 1.0).all())
    assert float(spill[CROSSING.index("all_spill")]) > 0.0
    assert bool((closed >= 0.0).all())
