"""The land group segment-VJP kernel's column code
(``land::GroupColumn::segment_vjp`` in ``csrc/land_group_step.cuh``:
ImplicitEuler, any Picard count, or Heun over a LandModel with Richards
flow, with or without a snowpack, each step undone on the column's group of
lanes, the
surface block's forward-mode passes split across the lanes), compiled for the host
by the C++ compiler with each group's lanes emulated in lockstep
(``soil::HostLanes``; ``tests/land_group_vjp_host.cpp`` built with
``-DLAND_GROUP_G=<G>`` once for each G, and without for the one-thread
column), against

* the one-thread land segment VJP that it replaces on the card
  (``land::segment_vjp_column`` of ``land::implicit_step`` at one Picard
  iteration, of ``land::picard_step`` at two and three): the input
  cotangents and each step's stored carry (the forward's) bit for bit (both
  builds contract no multiply-adds, and the group code forms each value by
  the one-thread code's operations in its order), each column's parameter
  cotangents, which the lanes sum apart, within rtol 1e-12; Heun likewise
  against ``land::heun_step`` and ``land::heun_step_adjoint`` at dt 60 s
  (``HEUN_DT``: at 600 s its stage leaves the physical range); at G 4, 8, 16
  and 32, at Nz 20 over the vegetated bench composition (Brooks-Corey and
  linear conductivity; constant drag and the reference ground flux, or
  Monin-Obukhov drag, the consistent ground flux and the soil-moisture
  ground resistance) and bare ground over Van Genuchten and Mualem, each
  with a snowpack too (``consistent_snow``, ``bare_vg_mualem_snow``), and at the
  ragged Nz 7 (slots above the column on the top lanes), each solver, on
  ``torch_parity.land_random_state``'s states of 24 columns over 8 steps of
  600 s (their packs negative, empty and deep); and with a snowpack on
  `test_torch_land_adjoint_host.py`'s empty and emptying packs
  (``empty_pack_case``: 48 columns at Nz 8 over 6 steps) at the kernel's G;
* torch autograd through the plain version
  (``land_column_segment_vjp_plain``) at float64, rtol 1e-9 with a floor of
  1e-9 of each field's largest magnitude, at Nz 20 and the kernel's G. The
  exclusions are those of `test_torch_land_adjoint_host.py` (ROADMAP Queue
  C): the columns whose photosynthesis is gated off with a zero
  discriminant, where the plain version's autograd gives NaN, are held to
  the plain version run without them; no ill-conditioned K_sat share is
  left out at 1e-9; Heun's plain version with its respiration held on the
  taken branch (``respiration_taken_branch``); on the empty and emptying
  packs at the kernel's G, by `test_torch_land_adjoint_host.py`'s own check
  of the one-thread build (1e-12 of each cotangent);
* JAX's Pallas segment VJP in interpret mode, through each package's
  ``make_fused_grad_rollout``, as ``torch_land_grad.check_fused_grad`` runs
  it (PCR, one Picard iteration; Nz 8 at the kernel's G), and Heun and
  ImplicitEuler PCR with a snowpack as `test_torch_land_grad_snow_heun.py`
  holds its ``"heun"`` and ``"implicit-pcr-snow"`` cases.
"""
import contextlib
import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import terrarium_tpu_torch as tp
from terrarium_tpu_torch.ops import land_step as ls
from terrarium_tpu_torch.ops import land_vjp as lv
from terrarium_tpu_torch.timesteppers import fused_grad

import test_torch_land_adjoint_host as ah
from test_torch_land_adjoint_host import (HEUN_DT, composition_model, empty_pack_case,
                                          respiration_taken_branch, zero_discriminant)
from torch_land_grad import check_fused_grad, jax_ref, port_ref  # noqa: F401
from torch_parity import land_random_state

HERE = pathlib.Path(__file__).parent
CSRC = HERE.parent / "terrarium_tpu_torch" / "csrc"
SOLVERS = {"thomas": 0, "pcr": 1}
#: the stepper codes of the host builds (soil::STEPPER_HEUN, _IMPLICIT)
STEPPERS = {"heun": 1, "implicit": 2}
CURVES, CONDS = {"vg": 0, "bc": 1}, {"mualem": 0, "linear": 1}
GROUPS = (4, 8, 16, 32)
CELLS, STEPS, DT = 24, 8, 600.0
#: (Nz, composition) of the bitwise cases: the vegetated bench composition
#: (``coupled``, ``consistent``) and bare ground over Van Genuchten and
#: Mualem at Nz 20, the bench composition at the ragged Nz 7, the bench
#: composition and bare ground with a snowpack at Nz 20 (the bare one's
#: tangent directions skip the vegetation's before the SWE's)
CASES = [(20, "coupled"), (20, "consistent"), (20, "bare_vg_mualem"), (7, "coupled"),
         (20, "consistent_snow"), (20, "bare_vg_mualem_snow")]


def host_libs(tmp_path_factory):
    """``{G: library, None: the one-thread library}``, the five builds of
    ``land_group_vjp_host.cpp`` compiled in parallel, once for every test
    file that asks for them: into a directory keyed by a hash of the
    sources, shared by the test run's workers, under a lock."""
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    h = hashlib.sha256((HERE / "land_group_vjp_host.cpp").read_bytes() + cxx.encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # the run's, beside each worker's own
    tmp = base / f"land_group_vjp_host-{h.hexdigest()[:12]}"
    tmp.mkdir(parents=True, exist_ok=True)
    sos = {g: tmp / f"land_group_vjp_host_{g or 'thread'}.so" for g in (None, *GROUPS)}
    with open(tmp / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (tmp / "built").exists():
            jobs = {}
            for g, so in sos.items():
                cmd = [cxx, "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                       *([f"-DLAND_GROUP_G={g}"] if g else []), f"-I{CSRC}", "-o", str(so),
                       str(HERE / "land_group_vjp_host.cpp")]
                jobs[g] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
            for p in jobs.values():
                log = p.communicate()[0]
                assert p.returncode == 0, log
            (tmp / "built").write_text("")
    out = {}
    for g, so in sos.items():
        out[g] = ctypes.CDLL(str(so))
        out[g].host_land_vjp.restype = ctypes.c_int
        out[g].host_land_rollout.restype = ctypes.c_int
    return out


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The host builds (``host_libs``)."""
    return host_libs(tmp_path_factory)


def land_case(composition, nz, seed, cells=CELLS):
    """The carry, static inputs, root fraction, coordinates, parameters and
    seeded output cotangents of one random case (as
    `test_torch_land_adjoint_host.py`'s ``vjp_case`` at depth ``nz``)."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz),
                            dtype=torch.float64, device="cpu")
    model = composition_model(grid, composition)
    params = ls.LandParams.of(model, torch.float64)
    fields = {k: torch.as_tensor(v)
              for k, v in land_random_state(seed, cells, nz, extremes=False).items()}
    carry = {n: fields[n].contiguous() for n in ls.carry_names(params)}
    inputs = {n: ls.LandInput(fields[n][None, :].contiguous()) for n in ls.LAND_INPUTS
              if n in model.collated_variables().inputs}
    root = None
    if params.tags[0] == "veg":
        prof = model.vegetation.root_distribution.profile(grid.vertical)
        root = torch.as_tensor(prof)[:, None].expand(nz, cells)
    coords = tuple(getattr(grid, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    rng = np.random.default_rng(seed + 100)
    gout = {n: torch.as_tensor(rng.normal(size=tuple(carry[n].shape)))
            for n in model.live_carry}
    return carry, inputs, root, coords, params, gout


def host_run(lib, case, solver, iters, steps=STEPS, dt=DT, stepper="implicit"):
    """``(gcarry0, gparams (2, cells), scratch (steps, 2 nz + 6 + snow,
    cells))`` of the host build ``lib`` (a group one or the one-thread one) over
    ``steps`` steps of ``stepper`` (``"implicit"`` with ``solver`` and
    ``iters`` Picard iterations, or ``"heun"``)."""
    carry, inputs, root, coords, params, gout = case
    nz, cells = carry["internal_energy"].shape
    gin = {n: torch.full_like(t, np.nan) for n, t in carry.items()}
    args, keep = ls.launch_args(carry, gin, inputs, root, coords, params)
    c_gout = ls._CLandCarry(**{ls._CARRY_OF[n]: t.data_ptr() for n, t in gout.items()})
    gparams = torch.full((2, cells), np.nan, dtype=torch.float64)
    tags = params.tags
    snow = "snow" in tags
    scratch = torch.full((steps, 2 * nz + 6 + snow, cells), np.nan, dtype=torch.float64)
    assert tags[1] == "richards"
    rc = lib.host_land_vjp(
        args[0], ctypes.byref(c_gout), args[1], args[2], ctypes.c_void_p(args[3]),
        ctypes.c_longlong(args[4]), ctypes.c_longlong(args[5]),
        *(ctypes.c_void_p(a) for a in args[6:10]), args[10],
        ctypes.c_void_p(gparams.data_ptr()), ctypes.c_void_p(scratch.data_ptr()),
        ctypes.c_int(steps), ctypes.c_double(dt), ctypes.c_longlong(cells), ctypes.c_int(iters),
        ctypes.c_int(nz), ctypes.c_int(tags[0] == "veg"), ctypes.c_int(CURVES[tags[2]]),
        ctypes.c_int(CONDS[tags[3]]), ctypes.c_int(snow), ctypes.c_int(SOLVERS.get(solver, 1)),
        ctypes.c_int(STEPPERS[stepper]))
    del keep
    assert rc == 0
    return gin, gparams, scratch


_cases, _thread_runs = {}, {}


def case_of(nz, composition):
    if (nz, composition) not in _cases:
        _cases[nz, composition] = land_case(composition, nz, 3 * nz + len(composition))
    return _cases[nz, composition]


def thread_run(libs, nz, composition, solver, iters):
    """The one-thread build's run of a case, computed once for every G
    (``solver`` None: Heun's, at HEUN_DT)."""
    key = (nz, composition, solver, iters)
    if key not in _thread_runs:
        _thread_runs[key] = host_run(libs[None], case_of(nz, composition), solver, iters,
                                     **heun_kw(solver))
    return _thread_runs[key]


def heun_kw(solver):
    """host_run's keywords of a scheme: Heun's (``solver`` None) at
    HEUN_DT."""
    return {"stepper": "heun", "dt": HEUN_DT} if solver is None else {}


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("nz,composition", CASES)
def test_land_group_vjp_equals_the_thread_vjp_bitwise(libs, nz, composition, group, solver,
                                                      iters):
    """``land::GroupColumn::segment_vjp`` at G ``group`` against
    ``land::segment_vjp_column`` (implicit_step at one iteration,
    picard_step at more) over 8 steps of 600 s on every column: the input
    cotangents bit for bit, each column's parameter cotangents (the group's
    tree sum of its lanes' running sums) within rtol 1e-12 of the one
    thread's running sum, with a floor of 1e-12 of the largest."""
    assert_vjp_bitwise(libs, nz, composition, group, solver, iters)


def assert_vjp_bitwise(libs, nz, composition, group, solver, iters):
    """The group build at G ``group`` against the one-thread build on a
    case (``solver`` None: Heun's): the input cotangents bit for bit, each
    column's parameter cotangents within rtol 1e-12 of the one thread's
    running sum with a floor of 1e-12 of the largest; the cotangents moved
    through the steps."""
    want, want_p, _ = thread_run(libs, nz, composition, solver, iters)
    got, got_p, _ = host_run(libs[group], case_of(nz, composition), solver, iters,
                             **heun_kw(solver))
    gout = case_of(nz, composition)[5]
    for name, b in want.items():
        a = got[name]
        assert bool(torch.isfinite(b).all()), name
        assert torch.equal(a, b), (name, (a != b).nonzero()[:5].tolist())
    assert bool(torch.isfinite(want_p).all())
    for a, b in zip(got_p, want_p):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))
    assert not torch.equal(want["internal_energy"], gout["internal_energy"])
    assert float(want_p[1].abs().max()) > 0.0 and float(want_p[0].abs().max()) > 0.0


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("nz,composition", CASES)
def test_land_group_forward_equals_the_thread_step_bitwise(libs, nz, composition, group,
                                                           solver, iters):
    """The group forward (``GroupColumn::picard_step``) against the
    one-thread step (``land::implicit_step`` at one iteration,
    ``land::picard_step`` at more): each step's input carry that the two
    segment VJPs store, steps 1 to 7 the forward's, bit for bit; the
    carries move."""
    assert_forward_bitwise(libs, nz, composition, group, solver, iters)


def assert_forward_bitwise(libs, nz, composition, group, solver, iters):
    """Each step's input carry that the group and the one-thread builds
    store on a case (``solver`` None: Heun's) bit for bit; the carries
    move."""
    _, _, want = thread_run(libs, nz, composition, solver, iters)
    _, _, got = host_run(libs[group], case_of(nz, composition), solver, iters,
                         **heun_kw(solver))
    assert bool(torch.isfinite(want).all())
    assert torch.equal(got, want), (got != want).nonzero()[:5].tolist()
    assert not torch.equal(want[-1], want[0])


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("composition", ["coupled", "bare_vg_mualem"])
def test_land_group_vjp_matches_autograd(libs, composition, solver, iters):
    """The group segment VJP at Nz 20 and the kernel's G
    (``land::implicit_group_lanes``) against torch autograd through the
    plain version over 8 steps of 600 s: every carry cotangent within rtol
    1e-9 with a floor of 1e-9 of its field's largest magnitude, the
    parameter cotangents summed over the columns within rtol 1e-9. Columns
    where the plain version's autograd is not finite must be the
    zero-discriminant ones (`test_torch_land_adjoint_host.py`), and the
    rest are held to the plain version run without them."""
    assert_matches_autograd(libs, composition, solver, iters)


def assert_matches_autograd(libs, composition, solver, iters):
    """The group build at Nz 20 and the kernel's G against torch autograd
    through the plain version on a case (``solver`` None: Heun's at
    HEUN_DT, its respiration held on the taken branch): every carry
    cotangent within rtol 1e-9 with a floor of 1e-9 of its field's largest
    magnitude, the parameter cotangents summed over the columns within rtol
    1e-9; the columns where the plain version's autograd is not finite must
    be zero-discriminant ones, and the rest are held to the plain version
    run without them."""
    nz, stepper = 20, "implicit" if solver else "heun"
    g = libs[None].host_land_group_lanes(nz, SOLVERS.get(solver, 1), STEPPERS[stepper])
    case = case_of(nz, composition)
    carry, inputs, root, coords, params, gout = case
    got, gp, _ = host_run(libs[g], case, solver, iters, **heun_kw(solver))
    dt = DT if solver else HEUN_DT
    kw = {"stepper": stepper, "solver": solver, "picard_iters": iters}

    def plain(*a):
        with contextlib.nullcontext() if solver else respiration_taken_branch():
            return lv.land_column_segment_vjp_plain(*a, **kw)

    ref, rK, rskm = plain(carry, inputs, root, *coords, params, dt, 0.0, STEPS, gout)
    bad = torch.zeros(CELLS, dtype=torch.bool)
    for t in ref.values():
        bad |= ~torch.isfinite(t).all(0) if t.dim() == 2 else ~torch.isfinite(t)
    assert not bool((bad & ~zero_discriminant(inputs, params)).any())
    keep = (~bad).nonzero().flatten()
    if bool(bad.any()):
        def cols(d):
            return {n: (t[:, keep] if t.dim() == 2 else t[keep]).contiguous()
                    for n, t in d.items()}
        sub_in = {n: ls.LandInput(i.values[:, keep].contiguous()) for n, i in inputs.items()}
        sub_root = None if root is None else root[:, keep]
        ref, rK, rskm = plain(cols(carry), sub_in, sub_root, *coords, params, dt, 0.0, STEPS,
                              cols(gout))
        got = cols(got)
    for name, b in ref.items():
        a = got[name]
        assert bool(torch.isfinite(a).all()), name
        scale = float(b.abs().max())
        assert scale > 0.0, name
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9 * scale, msg=name)
    for name, a, b in (("K_sat", gp[0][keep].sum(), rK), ("sk_mineral", gp[1][keep].sum(),
                                                          rskm)):
        assert float(b) != 0.0, name
        torch.testing.assert_close(a, b, rtol=1e-9, atol=0.0, msg=name)


def _host_group_segment_vjp(libs):
    """A stand-in for ``land_column_segment_vjp`` on CPU tensors that runs
    the host build of the group segment VJP at the kernel's G."""
    def vjp(carry, inputs, root, dz, dz_faces, z_centers, z_faces, params, dt, time, steps,
            gcarry, *, stepper, solver, picard_iters):
        assert stepper in STEPPERS
        nz = carry["internal_energy"].shape[0]
        g = libs[None].host_land_group_lanes(nz, SOLVERS.get(solver, 1), STEPPERS[stepper])
        case = ({n: t.contiguous() for n, t in carry.items()}, inputs, root,
                (dz, dz_faces, z_centers, z_faces), params,
                {n: t.contiguous() for n, t in gcarry.items()})
        gin, gp, _ = host_run(libs[g], case, solver, picard_iters, steps=steps, dt=dt,
                              stepper=stepper)
        return gin, gp[0].sum(), gp[1].sum()
    return vjp


def test_land_group_vjp_matches_jax_pallas(libs, monkeypatch, jax_ref, port_ref):
    """The port's fused gradient with the host build of the group segment
    VJP in place of the kernel (`torch_land_grad.py`'s case: 32 columns, Nz
    8, 8 steps of 600 s in segments of 4, ImplicitEuler with PCR) against
    JAX's Pallas segment VJP in interpret mode, by
    ``torch_land_grad.check_fused_grad``: the value within rtol 1e-10,
    d/d log K_sat and d/d k_mineral within rtol 1e-8, d/dU0 and d/dC0 per
    cell within rtol 1e-8 with a floor of 1e-8 of each one's largest
    magnitude."""
    monkeypatch.setattr(fused_grad, "land_column_segment_vjp", _host_group_segment_vjp(libs))
    check_fused_grad(jax_ref, port_ref, "implicit-pcr", "pallas")


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("nz,composition", CASES)
def test_land_group_heun_vjp_equals_the_thread_vjp_bitwise(libs, nz, composition, group):
    """``land::GroupColumn::segment_vjp`` of Heun at G ``group`` against
    ``land::segment_vjp_column`` of ``land::heun_step`` (the stage
    recomputed by ``heun_stage_call``) over 8 steps of 60 s on every column:
    the input cotangents bit for bit, each column's parameter cotangents
    within rtol 1e-12 of the one thread's running sum, with a floor of
    1e-12 of the largest."""
    assert_vjp_bitwise(libs, nz, composition, group, None, 1)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("nz,composition", CASES)
def test_land_group_heun_forward_equals_the_thread_step_bitwise(libs, nz, composition, group):
    """The group forward of Heun (``GroupColumn::heun_step``, its top
    level's Flux BCs kept apart from the mean of the two stages'
    tendencies) against ``land::heun_step``: each step's input carry that
    the two segment VJPs store bit for bit over 8 steps of 60 s; the
    carries move."""
    assert_forward_bitwise(libs, nz, composition, group, None, 1)


@pytest.mark.parametrize("composition", ["coupled", "bare_vg_mualem"])
def test_land_group_heun_vjp_matches_autograd(libs, composition):
    """The group segment VJP of Heun at Nz 20 and the kernel's G
    (``land::heun_group_lanes``) against torch autograd through the plain
    version over 8 steps of 60 s (its respiration held on the taken
    branch): every carry cotangent within rtol 1e-9 with a floor of 1e-9 of
    its field's largest magnitude, the parameter cotangents summed over the
    columns within rtol 1e-9. Columns where the plain version's autograd is
    not finite must be the zero-discriminant ones."""
    assert_matches_autograd(libs, composition, None, 1)


def test_land_group_heun_vjp_matches_jax_pallas(libs, monkeypatch):
    """The port's fused gradient of `test_torch_land_grad_snow_heun.py`'s
    ``"heun"`` case (32 columns, Nz 8, 8 steps of 60 s in segments of 4)
    with the host build of the group segment VJP at the kernel's G in place
    of the kernel, against JAX's Pallas segment VJP in interpret mode (under
    JAX's default saturation adjustment): the value within rtol 1e-10, d/d
    log K_sat and d/d k_mineral within rtol 1e-8 and non-zero, d/dU0 and
    d/dC0 per cell within rtol 1e-8 with a floor of 1e-8 of each one's
    largest magnitude, as that file holds the plain version."""
    import terrarium_tpu.processes.soil.hydrology as jax_hydrology
    import test_torch_land_grad_snow_heun as sh

    calls = []
    host = _host_group_segment_vjp(libs)

    def vjp(*a, **kw):
        calls.append(kw["stepper"])
        return host(*a, **kw)

    monkeypatch.setattr(fused_grad, "land_column_segment_vjp", vjp)
    v, gx, gk, gU, gC, _ = sh._port_grads("heun")
    assert calls == ["heun"] * (sh.STEPS // sh.INNER)
    monkeypatch.setattr(jax_hydrology, "ADJUST_IMPL", "fused")
    jv, jgx, jgk, jgU, jgC, _ = sh._jax_grads("heun", "pallas")
    np.testing.assert_allclose(v, jv, rtol=1e-10)
    for a, b in ((gx, jgx), (gk, jgk)):
        assert abs(float(a)) > 0.0
        np.testing.assert_allclose(a, b, rtol=1e-8)
    for a, b in ((gU, jgU), (gC, jgC)):
        sh._held(a, b, 1e-8)


#: the steppers of the empty-pack cases: (stepper, solver, Picard count)
PACK_SCHEMES = {"heun": ("heun", None, 1), "implicit-pcr": ("implicit", "pcr", 1),
                "implicit-thomas-2": ("implicit", "thomas", 2)}


def pack_case():
    """`test_torch_land_adjoint_host.py`'s empty and emptying packs over
    the bench composition with a snowpack (``empty_pack_case``: 48 columns,
    Nz 8)."""
    return empty_pack_case("consistent_snow")


@pytest.mark.parametrize("scheme", list(PACK_SCHEMES))
def test_land_group_vjp_empty_and_emptying_packs(libs, monkeypatch, scheme):
    """Packs empty at the start (SWE exactly 0: the cover's clamp and the
    clip SWE >= 0 pass the cotangent at their bound) and packs that the
    melt empties within the steps, over 6 steps (Heun's of 60 s, the
    implicit ones' of 600 s): the group segment VJP at the kernel's G
    against the one-thread build, the input cotangents and the stored
    carries bit for bit, and against torch autograd through the plain
    version by `test_torch_land_adjoint_host.py`'s check of the one-thread
    build (``_held_to_autograd``: 1e-12 of each cotangent with a floor of
    1e-12 of its field's largest magnitude; under Picard iterations its
    nudged spread and its ill-conditioned K_sat shares), the group build in
    its place; the plain forward shows both kinds of column."""
    stepper, solver, iters = PACK_SCHEMES[scheme]
    case = pack_case()
    carry, inputs, root, coords, params, gout = case
    dt = ah.HEUN_DT if stepper == "heun" else DT
    g = libs[None].host_land_group_lanes(ah.NZ, SOLVERS.get(solver, 1), STEPPERS[stepper])
    want, want_p, want_s = host_run(libs[None], case, solver, iters, steps=ah.STEPS, dt=dt,
                                    stepper=stepper)
    got, got_p, got_s = host_run(libs[g], case, solver, iters, steps=ah.STEPS, dt=dt,
                                 stepper=stepper)
    assert torch.equal(got_s, want_s)
    for name, b in want.items():
        assert bool(torch.isfinite(b).all()), name
        assert torch.equal(got[name], b), (name, (got[name] != b).nonzero()[:5].tolist())
    for a, b in zip(got_p, want_p):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))
    swe0 = carry["snow_water_equivalent"]
    swe = ls.land_column_rollout_plain(carry, inputs, root, *coords, params, dt, 0.0, ah.STEPS,
                                       stepper=stepper, solver=solver,
                                       picard_iters=iters)["snow_water_equivalent"]
    assert int(((swe0 > 0) & (swe == 0)).sum()) >= 8
    assert int(((swe0 == 0) & (swe == 0)).sum()) >= 4

    def group_run(_, carry, inputs, root, coords, params, gout, steps, stepper="euler",
                  solver="thomas", picard=0, dt=DT):
        gin, gp, _ = host_run(libs[g], (carry, inputs, root, coords, params, gout),
                              solver if stepper == "implicit" else None, max(picard, 1),
                              steps=steps, dt=dt, stepper=stepper)
        return gin, gp[0], gp[1]

    monkeypatch.setattr(ah, "host_vjp_run", group_run)
    ah._held_to_autograd(None, "consistent_snow", 3, stepper, solver,
                         iters if stepper == "implicit" and iters > 1 else 0, case=case,
                         conditioned=iters > 1)


def test_land_group_snow_vjp_matches_jax_pallas(libs, monkeypatch):
    """The port's fused gradient of `test_torch_land_grad_snow_heun.py`'s
    ``"implicit-pcr-snow"`` case (32 columns, Nz 8, a snowpack of 0.05 m
    under a snowfall of 1e-8 m/s, 8 steps of 600 s in segments of 4,
    ImplicitEuler PCR) with the host build of the group segment VJP at the
    kernel's G in place of the kernel, against JAX's Pallas segment VJP in
    interpret mode: the value within rtol 1e-10, d/d log K_sat and d/d
    k_mineral within rtol 1e-8 and non-zero, d/dU0, d/dC0 and d/dSWE0 per
    cell within rtol 1e-8 with a floor of 1e-8 of each one's largest
    magnitude, as that file holds the plain version."""
    import terrarium_tpu.processes.soil.hydrology as jax_hydrology
    import test_torch_land_grad_snow_heun as sh

    case, calls = "implicit-pcr-snow", []
    host = _host_group_segment_vjp(libs)

    def vjp(*a, **kw):
        calls.append((kw["stepper"], "snow" in a[7].tags))
        return host(*a, **kw)

    monkeypatch.setattr(fused_grad, "land_column_segment_vjp", vjp)
    v, gx, gk, gU, gC, _, gswe = sh._port_grads(case)
    assert calls == [("implicit", True)] * (sh.STEPS // sh.INNER)
    monkeypatch.setattr(jax_hydrology, "ADJUST_IMPL", "fused")
    jv, jgx, jgk, jgU, jgC, _, jgswe = sh._jax_grads(case, "pallas")
    np.testing.assert_allclose(v, jv, rtol=1e-10)
    for a, b in ((gx, jgx), (gk, jgk)):
        assert abs(float(a)) > 0.0
        np.testing.assert_allclose(a, b, rtol=1e-8)
    for a, b in ((gU, jgU), (gC, jgC), (gswe, jgswe)):
        sh._held(a, b, 1e-8)
