"""The CUDA kernels' step and hand-derived adjoint (``csrc/soil_step.cuh``),
compiled for the host by the C++ compiler, against the plain PyTorch version
and its torch autograd at float64.

The header is plain C++ apart from its function qualifiers, so the
segment-VJP kernel's per-column arithmetic (forward with stored carries,
recompute, adjoint, parameter cotangents) runs here without a card. The host
build does not contract multiply-adds (``-ffp-contract=off``), as torch on
the CPU does not; the forward then differs from the plain version only where
``cbrt`` and torch's ``pow(x, 1/3)`` round apart (an ulp), and the adjoint to
rounding.
The states are `test_torch_soil_physics.py`'s random legal states, which take
every branch of the step, and the gradient test's exactly saturated column.
Each scheme of the segment VJP is held there: ForwardEuler, Heun and
ImplicitEuler (Thomas, PCR) over heat + Richards, ForwardEuler and Heun over
the heat-only model, whose parameters are those of the default (NoFlow)
`SoilModel` on the same grid, and ``soil::picard_step_adjoint``
(ImplicitEuler with one to three Picard iterations, each solver, either
physics).
"""
import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.ops import fused_vjp as fv
from terrarium_tpu_torch.processes.soil.hydrology import saturation_sweeps

import terrarium_tpu_torch as tp

from test_torch_soil_physics import CELLS, NZ, random_state
from torch_parity import port_sim

HERE = pathlib.Path(__file__).parent
CSRC = HERE.parent / "terrarium_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    so = tmp_path_factory.mktemp("soil_step_host") / "soil_step_host.so"
    subprocess.run([cxx, "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(HERE / "soil_step_host.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.host_segment_vjp.argtypes = ([ptr] * 11 + [ll] + [ptr] * 5
                                     + [ctypes.c_int, ctypes.c_int, ctypes.c_double, ll])
    lib.host_rollout.argtypes = ([ptr] * 4 + [ll] + [ptr] * 5
                                 + [ctypes.c_int, ctypes.c_int, ctypes.c_double, ll])
    lib.host_segment_vjp_scheme.argtypes = ([ptr] * 11 + [ll] + [ptr] * 5
                                            + [ctypes.c_int] * 5 + [ctypes.c_double, ll])
    lib.host_segment_vjp_picard.argtypes = ([ptr] * 11 + [ll] + [ptr] * 5
                                            + [ctypes.c_int] * 5 + [ctypes.c_double, ll])
    lib.host_rollout_picard.argtypes = ([ptr] * 4 + [ll, ll, ctypes.c_int]
                                        + [ctypes.c_double] * 3 + [ptr] * 5
                                        + [ctypes.c_int] * 5 + [ctypes.c_double, ll])
    return lib


def _case(name, physics="richards", random_dt=60.0):
    """Carry, top-temperature table, coordinates and parameters of a case;
    ``physics="heat"`` takes the default heat-only model's parameters and
    the carry (U, sat)."""
    if name.startswith("random"):
        sim = port_sim("golden", CELLS, NZ)
        carry = tuple(torch.as_tensor(a).contiguous() for a in random_state(int(name[-1])))
        table, dt = torch.linspace(-3.0, 6.0, 6, dtype=torch.float64), random_dt
    else:  # the gradient tests' column, bottom layers exactly saturated
        sim = port_sim("golden", 16, 10)
        sim.state.set(saturation_water_ice=torch.minimum(
            torch.ones(()), 0.6 - 0.04 * sim.model.grid.z_centers).expand(10, 16).contiguous())
        carry = tuple(sim.state.prognostic[n].contiguous() for n in sim.model.live_carry)
        table, dt = torch.full((12,), 4.0, dtype=torch.float64), 300.0
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    model = sim.model if physics == "richards" else tp.SoilModel(grid=g)
    if physics == "heat":
        carry = carry[:2]
    return carry, table, coords, fs.ColumnParams.of(model, torch.float64), dt


CASES = ["random0", "random1", "saturated"]
#: the segment VJP's schemes besides ForwardEuler over heat + Richards:
#: (stepper, physics, solver), with the host build's codes
SCHEMES = {"heun": ("heun", "richards", "pcr"), "implicit-thomas": ("implicit", "richards",
                                                                    "thomas"),
           "implicit-pcr": ("implicit", "richards", "pcr"), "heat": ("euler", "heat", "pcr"),
           "heat-heun": ("heun", "heat", "pcr")}
_CODES = {"euler": 0, "heun": 1, "implicit": 2, "thomas": 0, "pcr": 1}


@pytest.mark.parametrize("case", CASES)
def test_host_step_matches_plain_rollout(host_lib, case):
    carry, table, coords, params, dt = _case(case)
    nz, cells = carry[0].shape
    out = tuple(t.clone() for t in carry)
    cp = fs._CParams.of(params)
    rc = host_lib.host_rollout(*(t.data_ptr() for t in (*out, table)), table.stride(0),
                               *(c.data_ptr() for c in coords), ctypes.addressof(cp), nz,
                               table.shape[0], dt, cells)
    assert rc == 0
    ref = fs.soil_column_rollout_plain(*carry, table, *coords, params, dt)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-14, atol=1e-14 * float(b.abs().max()))


@pytest.mark.parametrize("case", CASES)
def test_host_adjoint_matches_autograd(host_lib, case):
    """Every cotangent within 1e-12 of its largest magnitude; the parameter
    cotangents are the host's per-column sums in a fixed order."""
    carry, table, coords, params, dt = _case(case)
    nz, cells = carry[0].shape
    rng = np.random.default_rng(sum(map(ord, case)))
    cts = tuple(torch.as_tensor(rng.normal(size=tuple(t.shape))) for t in carry)
    out = tuple(torch.empty_like(t) for t in carry)
    gparams = torch.zeros(2, cells, dtype=torch.float64)
    cp = fs._CParams.of(params)
    rc = host_lib.host_segment_vjp(*(t.data_ptr() for t in (*carry, *cts, *out, gparams, table)),
                                   table.stride(0), *(c.data_ptr() for c in coords),
                                   ctypes.addressof(cp), nz, table.shape[0], dt, cells)
    assert rc == 0
    ref = fv.soil_column_segment_vjp_plain(*carry, table, *coords, params, dt, *cts)
    got = (*out, gparams[0].sum(), gparams[1].sum())
    for name, a, b in zip(("U", "sat", "S", "K_sat", "sk_mineral"), got, ref):
        assert bool(torch.isfinite(a).all()), name
        scale = float(b.abs().max())
        assert scale > 0.0, name
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * scale, msg=name)


def _scheme_case(case, scheme):
    stepper, physics, solver = SCHEMES[scheme]
    carry, table, coords, params, dt = _case(case, physics)
    if stepper == "heun":  # the stage of the last step reads one more row
        table = torch.cat([table, table[-1:] + 1.5])
    return (stepper, physics, solver), carry, table, coords, params, dt


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", CASES)
def test_host_scheme_adjoint_matches_autograd(host_lib, case, scheme):
    """Each scheme's hand adjoint (`soil::heun_step_adjoint`,
    `soil::implicit_step_adjoint`, the heat-only `soil::step_adjoint`)
    against torch autograd through the plain rollout: every cotangent within
    1e-12 of its largest magnitude; heat only: no pool, and K_sat's exactly
    0."""
    (stepper, physics, solver), carry, table, coords, params, dt = _scheme_case(case, scheme)
    nz, cells = carry[0].shape
    heat = physics == "heat"
    rng = np.random.default_rng(sum(map(ord, case + scheme)))
    cts = tuple(torch.as_tensor(rng.normal(size=tuple(t.shape))) for t in carry)
    if heat:
        carry, cts = carry + (torch.zeros(cells, dtype=torch.float64),), cts + (None,)
    out = tuple(torch.full_like(carry[0 if i < 2 else 2], np.nan) for i in range(3))
    gparams = torch.zeros(2, cells, dtype=torch.float64)
    cp = fs._CParams.of(params)
    steps = table.shape[0] - (1 if stepper == "heun" else 0)
    rc = host_lib.host_segment_vjp_scheme(
        *(0 if t is None else t.data_ptr() for t in (*carry, *cts, *out, gparams, table)),
        table.stride(0), *(c.data_ptr() for c in coords), ctypes.addressof(cp), nz,
        _CODES[stepper], _CODES[solver], int(heat), steps, dt, cells)
    assert rc == 0
    ref = fv.soil_column_segment_vjp_plain(*carry[:2], None if heat else carry[2], table,
                                           *coords, params, dt, *cts, stepper=stepper,
                                           physics=physics, solver=solver)
    got = (*out, gparams[0].sum(), gparams[1].sum())
    for name, a, b in zip(("U", "sat", "S", "K_sat", "sk_mineral"), got, ref):
        if heat and name == "S":
            assert b is None and bool(torch.isnan(a).all()), "the heat-only VJP wrote a pool"
            continue
        if heat and name == "K_sat":
            assert float(a) == 0.0 and float(b) == 0.0
            continue
        assert bool(torch.isfinite(a).all()), name
        scale = float(b.abs().max())
        assert scale > 0.0, name
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * scale, msg=name)


def _picard_parted(host_lib, carry, table, coords, params, dt, heat, solver, iters):
    """The columns where ``soil::picard_step`` (host) and the plain version,
    each along its own trajectory one step at a time, part beyond 1e-12 of
    a field's magnitude, and whether each of them closes a layer at or
    within 1e-9 of saturation on the plain trajectory before it parts: the
    sweeps and ``d(Psi)/d(sat)`` switch there, and the header's ``cbrt`` and
    torch's ``pow(x, 1/3)``, an ulp apart, may put an iterate either side
    (`test_torch_step_host.py`'s implicit columns part the same way)."""
    nz, cells = carry[0].shape
    kw = dict(stepper="implicit", physics="heat" if heat else "richards", solver=solver,
              picard_iters=iters)
    cp = fs._CParams.of(params)
    a = b = carry
    parted = torch.zeros(cells, dtype=torch.bool)
    near = torch.zeros(cells, dtype=torch.bool)
    for i in range(table.shape[0]):
        row = table[i:i + 1]
        if not heat:
            near |= ~parted & (saturation_sweeps(b[1], coords[0][:, None])[0]
                               >= 1.0 - 1e-9).any(0)
        a = tuple(t.clone() for t in a)
        assert host_lib.host_rollout_picard(
            *(t.data_ptr() for t in (*a, row)), 1, 0, 0, 0.0, 0.0, 0.0,
            *(c.data_ptr() for c in coords), ctypes.addressof(cp), nz, _CODES[solver],
            int(heat), iters, 1, dt, cells) == 0
        out = fs.soil_column_rollout_plain(b[0], b[1], None if heat else b[2], row, *coords,
                                           params, dt, **kw)
        b = out if not heat else (out[0], out[1], b[2])
        for u, v in zip(a, b):
            d = (u - v).abs()
            parted |= (d.amax(0) if d.dim() == 2 else d) > 1e-12 * float(v.abs().max())
    return parted, near


#: the random cases' dt of the Picard checks, the implicit kernels' check dt
#: of `test_torch_step_host.py`
PICARD_DT = 300.0


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("solver", ["thomas", "pcr"])
@pytest.mark.parametrize("physics", ["richards", "heat"])
@pytest.mark.parametrize("case", CASES)
def test_host_picard_adjoint_matches_autograd(host_lib, case, physics, solver, iters):
    """``soil::picard_step_adjoint`` (each iteration's iterate recomputed
    from the step's start, its closure's spill dropped, its right side's
    -(u_k - u^n) / dt) against torch autograd through the plain rollout
    with ``picard_iters``: every cotangent within 1e-12 of its largest
    magnitude; heat only: no pool, and K_sat's exactly 0. First the forward,
    ``soil::picard_step`` one step at a time: every column is held at 1e-12
    but where a layer closes at saturation (:func:`_picard_parted`: at most
    two columns of a case, all with a layer there, none of the heat-only
    model's); the cotangents are compared on the held columns, each column
    being independent of the others (the parameter cotangents summed over
    them)."""
    carry, table, coords, params, dt = _case(case, physics, random_dt=PICARD_DT)
    nz, cells = carry[0].shape
    heat = physics == "heat"
    if heat:
        carry = carry + (torch.zeros(cells, dtype=torch.float64),)
    parted, near = _picard_parted(host_lib, carry, table, coords, params, dt, heat, solver,
                                  iters)
    assert int(parted.sum()) <= 2 and bool(near[parted].all()), parted.nonzero().tolist()
    keep = ~parted
    rng = np.random.default_rng(sum(map(ord, case + physics + solver)) + iters)
    cts = tuple(torch.as_tensor(rng.normal(size=tuple(t.shape))) for t in carry)
    if heat:
        cts = cts[:2] + (None,)
    grads = tuple(torch.full_like(carry[0 if i < 2 else 2], np.nan) for i in range(3))
    gparams = torch.zeros(2, cells, dtype=torch.float64)
    cp = fs._CParams.of(params)
    rc = host_lib.host_segment_vjp_picard(
        *(0 if t is None else t.data_ptr() for t in (*carry, *cts, *grads, gparams, table)),
        table.stride(0), *(c.data_ptr() for c in coords), ctypes.addressof(cp), nz,
        _CODES[solver], int(heat), iters, table.shape[0], dt, cells)
    assert rc == 0

    def held(t):
        return None if t is None else t[..., keep].contiguous()

    want = fv.soil_column_segment_vjp_plain(
        held(carry[0]), held(carry[1]), None if heat else held(carry[2]), table, *coords,
        params, dt, *(held(t) for t in cts), stepper="implicit", physics=physics,
        solver=solver, picard_iters=iters)
    got = (*(held(t) for t in grads), gparams[0][keep].sum(), gparams[1][keep].sum())
    for name, a, b in zip(("U", "sat", "S", "K_sat", "sk_mineral"), got, want):
        if heat and name == "S":
            assert b is None and bool(torch.isnan(a).all()), "the heat-only VJP wrote a pool"
            continue
        if heat and name == "K_sat":
            assert float(a) == 0.0 and float(b) == 0.0
            continue
        assert bool(torch.isfinite(a).all()), name
        scale = float(b.abs().max())
        assert scale > 0.0, name
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * scale, msg=name)
