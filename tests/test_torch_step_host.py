"""The rollout kernel's column loop (``soil::rollout_column`` in
``csrc/soil_step.cuh``: ForwardEuler and Heun, heat + Richards and heat only,
the top temperature from a table or interpolated from a series), compiled for
the host by the C++ compiler, against the plain PyTorch version at float64.

The host build does not contract multiply-adds, as torch on the CPU does
not, so the two differ only where ``cbrt`` and torch's ``pow(x, 1/3)`` round
apart. The states are `test_torch_soil_physics.py`'s random legal states,
which take every branch of the step; the series starts after the first clock
time and ends before the last, so both flat ends and the interpolation
between rows are read.
"""
import ctypes

import numpy as np
import pytest
import torch

import terrarium_tpu_torch as tp
from terrarium_tpu_torch.ops import fused_step as fs

from test_torch_soil_physics import CELLS, NZ, random_state
from test_torch_step_adjoint import host_lib  # noqa: F401  (the compiled header)
from torch_parity import port_sim

STEPS, DT = 30, 60.0
SERIES_ROWS, SERIES_T0, SERIES_DTS = 6, 100.0, 250.0

SCHEMES = [("heun", "richards", "table"), ("heun", "richards", "series"),
           ("heun", "richards", "scalar series"), ("euler", "richards", "series"),
           ("euler", "heat", "table"), ("euler", "heat", "series"),
           ("heun", "heat", "scalar series")]


@pytest.fixture(scope="module")
def lib(host_lib):  # noqa: F811
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    host_lib.host_rollout_scheme.argtypes = (
        [ptr] * 4 + [ll, ll, ctypes.c_int] + [ctypes.c_double] * 3 + [ptr] * 5
        + [ctypes.c_int] * 4 + [ctypes.c_double, ll])
    return host_lib


def _case(stepper, physics, top_kind, seed):
    heat = physics == "heat"
    sim = port_sim("golden", CELLS, NZ)
    model = sim.model
    if heat:
        model = tp.SoilModel(grid=model.grid)
    U, sat, S = (torch.as_tensor(a).contiguous() for a in random_state(seed))
    if heat:
        sat = sat.clamp(0.0, 1.0)
    g = model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    rng = np.random.default_rng(seed + 100)
    if top_kind == "table":
        top = torch.as_tensor(rng.uniform(-6.0, 8.0, (STEPS + 1, CELLS)))
        if stepper == "euler":
            top = top[:-1]
    else:
        shape = (SERIES_ROWS, CELLS) if top_kind == "series" else (SERIES_ROWS,)
        top = fs.SeriesBC(torch.as_tensor(rng.uniform(-6.0, 8.0, shape)), SERIES_T0,
                          SERIES_DTS, 0.0, STEPS)
    return (U, sat, S), top, coords, fs.ColumnParams.of(model, torch.float64)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("stepper,physics,top_kind", SCHEMES)
def test_host_rollout_column_matches_plain(lib, stepper, physics, top_kind, seed):
    carry, top, coords, params = _case(stepper, physics, top_kind, seed)
    out = tuple(t.clone() for t in carry)
    if isinstance(top, fs.SeriesBC):
        data, rows, series = top.values, SERIES_ROWS, (top.t0, top.dts, top.time)
    else:
        data, rows, series = top, 0, (0.0, 0.0, 0.0)
    cp = fs._CParams.of(params)
    rc = lib.host_rollout_scheme(
        *(t.data_ptr() for t in (*out, data)), data.stride(0),
        data.stride(1) if data.dim() == 2 else 0, rows, *series,
        *(c.data_ptr() for c in coords), ctypes.addressof(cp), NZ, int(stepper == "heun"),
        int(physics == "heat"), STEPS, DT, CELLS)
    assert rc == 0
    ref = fs.soil_column_rollout_plain(*carry, top, *coords, params, DT, stepper=stepper,
                                       physics=physics)
    for name, a, b in zip(("U", "sat", "S"), out, ref):
        assert bool(torch.isfinite(b).all()), name
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()),
                                   msg=name)
    if physics == "heat":  # the saturation is read, never written
        assert torch.equal(ref[1], carry[1]) and torch.equal(out[1], carry[1])
