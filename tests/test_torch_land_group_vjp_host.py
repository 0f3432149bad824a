"""The land group segment-VJP kernel's column code
(``land::GroupColumn::segment_vjp`` in ``csrc/land_group_step.cuh``:
ImplicitEuler over a LandModel with Richards flow and no snowpack, any
Picard count, each step undone on the column's group of lanes, the surface
block's forward-mode passes split across the lanes), compiled for the host
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
  cotangents, which the lanes sum apart, within rtol 1e-12; at G 4, 8, 16
  and 32, at Nz 20 over the vegetated bench composition (Brooks-Corey and
  linear conductivity; constant drag and the reference ground flux, or
  Monin-Obukhov drag, the consistent ground flux and the soil-moisture
  ground resistance) and bare ground over Van Genuchten and Mualem, and at
  the ragged Nz 7 (slots above the column on the top lanes), each solver,
  on ``torch_parity.land_random_state``'s states of 24 columns over 8 steps
  of 600 s;
* torch autograd through the plain version
  (``land_column_segment_vjp_plain``) at float64, rtol 1e-9 with a floor of
  1e-9 of each field's largest magnitude, at Nz 20 and the kernel's G. The
  exclusions are those of `test_torch_land_adjoint_host.py` (ROADMAP Queue
  C): the columns whose photosynthesis is gated off with a zero
  discriminant, where the plain version's autograd gives NaN, are held to
  the plain version run without them; no ill-conditioned K_sat share is
  left out at 1e-9;
* JAX's Pallas segment VJP in interpret mode, through each package's
  ``make_fused_grad_rollout``, as ``torch_land_grad.check_fused_grad`` runs
  it (PCR, one Picard iteration; Nz 8 at the kernel's G).
"""
import ctypes
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

from test_torch_land_adjoint_host import composition_model, zero_discriminant
from torch_land_grad import check_fused_grad, jax_ref, port_ref  # noqa: F401
from torch_parity import land_random_state

HERE = pathlib.Path(__file__).parent
CSRC = HERE.parent / "terrarium_tpu_torch" / "csrc"
SOLVERS = {"thomas": 0, "pcr": 1}
CURVES, CONDS = {"vg": 0, "bc": 1}, {"mualem": 0, "linear": 1}
GROUPS = (4, 8, 16, 32)
CELLS, STEPS, DT = 24, 8, 600.0
#: (Nz, composition) of the bitwise cases: the vegetated bench composition
#: (``coupled``, ``consistent``) and bare ground over Van Genuchten and
#: Mualem at Nz 20, the bench composition at the ragged Nz 7
CASES = [(20, "coupled"), (20, "consistent"), (20, "bare_vg_mualem"), (7, "coupled")]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """``{G: library, None: the one-thread library}``, the five builds of
    ``land_group_vjp_host.cpp`` compiled in parallel."""
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    tmp = tmp_path_factory.mktemp("land_group_vjp_host")
    jobs = {}
    for g in (None, *GROUPS):
        so = tmp / f"land_group_vjp_host_{g or 'thread'}.so"
        cmd = [cxx, "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
               *([f"-DLAND_GROUP_G={g}"] if g else []), f"-I{CSRC}", "-o", str(so),
               str(HERE / "land_group_vjp_host.cpp")]
        jobs[g] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True))
    out = {}
    for g, (so, p) in jobs.items():
        log = p.communicate()[0]
        assert p.returncode == 0, log
        out[g] = ctypes.CDLL(str(so))
        out[g].host_land_vjp.restype = ctypes.c_int
    return out


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


def host_run(lib, case, solver, iters, steps=STEPS, dt=DT):
    """``(gcarry0, gparams (2, cells), scratch (steps, 2 nz + 6, cells))``
    of the host build ``lib`` (a group one or the one-thread one)."""
    carry, inputs, root, coords, params, gout = case
    nz, cells = carry["internal_energy"].shape
    gin = {n: torch.full_like(t, np.nan) for n, t in carry.items()}
    args, keep = ls.launch_args(carry, gin, inputs, root, coords, params)
    c_gout = ls._CLandCarry(**{ls._CARRY_OF[n]: t.data_ptr() for n, t in gout.items()})
    gparams = torch.full((2, cells), np.nan, dtype=torch.float64)
    scratch = torch.full((steps, 2 * nz + 6, cells), np.nan, dtype=torch.float64)
    tags = params.tags
    assert tags[1] == "richards" and "snow" not in tags
    rc = lib.host_land_vjp(
        args[0], ctypes.byref(c_gout), args[1], args[2], ctypes.c_void_p(args[3]),
        ctypes.c_longlong(args[4]), ctypes.c_longlong(args[5]),
        *(ctypes.c_void_p(a) for a in args[6:10]), args[10],
        ctypes.c_void_p(gparams.data_ptr()), ctypes.c_void_p(scratch.data_ptr()),
        ctypes.c_int(steps), ctypes.c_double(dt), ctypes.c_longlong(cells), ctypes.c_int(iters),
        ctypes.c_int(nz), ctypes.c_int(tags[0] == "veg"), ctypes.c_int(CURVES[tags[2]]),
        ctypes.c_int(CONDS[tags[3]]), ctypes.c_int(SOLVERS[solver]))
    del keep
    assert rc == 0
    return gin, gparams, scratch


_cases, _thread_runs = {}, {}


def case_of(nz, composition):
    if (nz, composition) not in _cases:
        _cases[nz, composition] = land_case(composition, nz, 3 * nz + len(composition))
    return _cases[nz, composition]


def thread_run(libs, nz, composition, solver, iters):
    """The one-thread build's run of a case, computed once for every G."""
    key = (nz, composition, solver, iters)
    if key not in _thread_runs:
        _thread_runs[key] = host_run(libs[None], case_of(nz, composition), solver, iters)
    return _thread_runs[key]


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
    want, want_p, _ = thread_run(libs, nz, composition, solver, iters)
    got, got_p, _ = host_run(libs[group], case_of(nz, composition), solver, iters)
    gout = case_of(nz, composition)[5]
    for name, b in want.items():
        a = got[name]
        assert bool(torch.isfinite(b).all()), name
        assert torch.equal(a, b), (name, (a != b).nonzero()[:5].tolist())
    assert bool(torch.isfinite(want_p).all())
    for a, b in zip(got_p, want_p):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))
    # the cotangents moved through the steps
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
    _, _, want = thread_run(libs, nz, composition, solver, iters)
    _, _, got = host_run(libs[group], case_of(nz, composition), solver, iters)
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
    nz = 20
    g = libs[None].host_land_group_lanes(nz, SOLVERS[solver])
    case = case_of(nz, composition)
    carry, inputs, root, coords, params, gout = case
    got, gp, _ = host_run(libs[g], case, solver, iters)
    kw = {"stepper": "implicit", "solver": solver, "picard_iters": iters}
    ref, rK, rskm = lv.land_column_segment_vjp_plain(carry, inputs, root, *coords, params, DT,
                                                     0.0, STEPS, gout, **kw)
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
        ref, rK, rskm = lv.land_column_segment_vjp_plain(cols(carry), sub_in, sub_root,
                                                         *coords, params, DT, 0.0, STEPS,
                                                         cols(gout), **kw)
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
        assert stepper == "implicit"
        nz = carry["internal_energy"].shape[0]
        g = libs[None].host_land_group_lanes(nz, SOLVERS[solver])
        case = ({n: t.contiguous() for n, t in carry.items()}, inputs, root,
                (dz, dz_faces, z_centers, z_faces), params,
                {n: t.contiguous() for n, t in gcarry.items()})
        gin, gp, _ = host_run(libs[g], case, solver, picard_iters, steps=steps, dt=dt)
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
