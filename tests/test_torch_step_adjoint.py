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
    return lib


def _case(name):
    """Carry, top-temperature table, coordinates and parameters of a case."""
    if name.startswith("random"):
        sim = port_sim("golden", CELLS, NZ)
        carry = tuple(torch.as_tensor(a).contiguous() for a in random_state(int(name[-1])))
        table, dt = torch.linspace(-3.0, 6.0, 6, dtype=torch.float64), 60.0
    else:  # the gradient tests' column, bottom layers exactly saturated
        sim = port_sim("golden", 16, 10)
        sim.state.set(saturation_water_ice=torch.minimum(
            torch.ones(()), 0.6 - 0.04 * sim.model.grid.z_centers).expand(10, 16).contiguous())
        carry = tuple(sim.state.prognostic[n].contiguous() for n in sim.model.live_carry)
        table, dt = torch.full((12,), 4.0, dtype=torch.float64), 300.0
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    return carry, table, coords, fs.ColumnParams.of(sim.model, torch.float64), dt


CASES = ["random0", "random1", "saturated"]


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
