"""The z-column probes of the Mosaic bisect on the card (counterpart of
``experiments/mosaic_bisect.py::run_case``, the Pallas calls at `:115` and
`:128`).

:func:`bisect_case` computes one case over an ``(NZ, cells)`` array: a
hand-written CUDA kernel (``csrc/probes.cu``, ``PROBE_ROW`` 5; one thread a
cell, the levels in registers) on the card, its plain PyTorch version
:func:`bisect_case_plain` on the CPU; each launch adds one to
``bisect_case.launches`` (``probe.count``: a graph's replays count, its
capture does not). The cases are `:40-107`'s: ``elementwise`` (2x +
1), ``stencil`` (the edge-replicated up - 2x + dn), ``cummin`` (the prefix
minimum over the levels from k = 0) and ``closure`` (the probe's own
telescoped saturation adjustment: S = cumsum((x - 1) dz), M =
min(cummin(S), 0), sat_up = 1 + (M - M_in) / dz, S2 = ZM_in - ZM_top with
ZM = cumsum(dz) + M, c2 = S2 - min(reverse cummin(S2), 0), the output
max(sat_up - c2_in / dz, 0)), each evaluated level by level, not by the
TPU's doubling scans.

:func:`run_case` builds the probe's input (`:33-37`: 56,951 cells padded to
blocks of 512, 57,344 columns, Nz 30, x uniform in [-0.5, 1.8) from seed 0,
dz geomspace(5, 0.05), float32), runs the case, holds it to the plain
version and on the card times it (100 launches), printing one JSON line.

    python -m terrarium_tpu_torch.experiments.mosaic_bisect [case]

On the TPU the probe bisected which kernel granularity Mosaic failed to
compile; every case here is a plain per-column loop.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import sys

import numpy as np
import torch

from . import probe

__all__ = ["CASES", "NZ", "CELLS", "inputs", "rotating", "bisect_case", "bisect_case_plain",
           "run_case"]

CASES = ["elementwise", "stencil", "cummin", "closure"]
NZ, CELLS, BLK = 30, 56951, 512
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int]


def inputs(dtype=torch.float32, device="cuda"):
    """``(x, dz)``: the probe's ``(NZ, 57,344)`` input and its ``(NZ,)``
    layer thicknesses (`:33-37`), made in float64 with numpy and cast."""
    ncell = (CELLS + BLK - 1) // BLK * BLK
    x = np.random.default_rng(0).uniform(-0.5, 1.8, (NZ, ncell)).astype(np.float32)
    dz = np.geomspace(5.0, 0.05, NZ).astype(np.float32)
    return (torch.as_tensor(x, device=device).to(dtype).contiguous(),
            torch.as_tensor(dz, device=device).to(dtype).contiguous())


def rotating(x: torch.Tensor, copies: int = 8):
    """An endless cycle over ``x`` and ``copies - 1`` copies of it, so that
    timed launches read their input from device memory: 8 x 6.9 MB at the
    probe's shape is more than the card's 50 MB L2 cache."""
    return itertools.cycle([x] + [x.clone() for _ in range(copies - 1)])


def bisect_case_plain(case: str, x: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``case`` over ``x`` ``(nz,
    cells)`` with the layer thicknesses ``dz`` ``(nz,)``, level by level in
    the kernel's order."""
    nz = x.shape[0]
    if case == "elementwise":
        return x * 2.0 + 1.0
    if case == "stencil":
        up = torch.cat([x[1:], x[-1:]])
        dn = torch.cat([x[:1], x[:-1]])
        return (up - 2.0 * x) + dn
    if case == "cummin":
        rows, m = [], x[0]
        for k in range(nz):
            m = torch.minimum(m, x[k])
            rows.append(m)
        return torch.stack(rows)
    if case != "closure":
        raise ValueError(f"case must be one of {CASES}, not {case!r}")
    zero = torch.zeros_like(x[0])
    S, m, M = zero, None, []
    for k in range(nz):
        S = S + (x[k] - 1.0) * dz[k]
        m = S if k == 0 else torch.minimum(m, S)
        M.append(torch.minimum(m, zero))
    Z, ZM = torch.zeros_like(dz[0]), []
    for k in range(nz):
        Z = Z + dz[k]
        ZM.append(Z + M[k])
    out, c2_up, rmin = [None] * nz, zero, None
    for k in reversed(range(nz)):
        sat_up = 1.0 + (M[k] - (M[k - 1] if k > 0 else zero)) / dz[k]
        out[k] = torch.clamp_min(sat_up - c2_up / dz[k], 0.0)
        S2 = (ZM[k - 1] if k > 0 else zero) - ZM[nz - 1]
        rmin = S2 if k == nz - 1 else torch.minimum(rmin, S2)
        c2_up = S2 - torch.clamp_max(rmin, 0.0)
    return torch.stack(out)


def bisect_case(case: str, x: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """``case`` over ``x`` ``(nz, cells)`` (float32 or float64, contiguous)
    with the layer thicknesses ``dz`` ``(nz,)``: the CUDA kernel on CUDA
    tensors, the plain version on CPU ones."""
    if case not in CASES:
        raise ValueError(f"case must be one of {CASES}, not {case!r}")
    if x.dim() != 2 or tuple(dz.shape) != (x.shape[0],):
        raise ValueError(f"x must be (nz, cells) and dz (nz,), got {tuple(x.shape)} and "
                         f"{tuple(dz.shape)}")
    if probe.check({"x": x, "dz": dz}, x) == "cpu":
        return bisect_case_plain(case, x, dz)
    out = torch.empty_like(x)
    fn = probe.entry("bisect", x.dtype, x.shape[0], _ARGTYPES)
    probe.launch(fn, x.data_ptr(), dz.data_ptr(), out.data_ptr(), x.shape[1],
                 CASES.index(case), device=x.device)
    probe.count(bisect_case)
    return out


bisect_case.launches = bisect_case.captured = 0


def run_case(case: str, device: str = "cuda", reps: int = 100) -> dict:
    """The case on the probe's float32 input: ``{"case", "status",
    "max_abs_err"}`` against the plain version and, on the card, ``"ms"``,
    a launch's device time (``reps`` launches in a CUDA graph, the median of
    5 replays; the input cycling over :func:`rotating`'s copies) and
    ``"call_ms"``, the median of ``reps`` calls each timed alone (the
    wrapper's host work included); printed as one JSON line."""
    x, dz = inputs(torch.float32, device)
    out = bisect_case(case, x, dz)
    err = float((out - bisect_case_plain(case, x, dz)).abs().max())
    res = {"case": case, "status": "ok", "max_abs_err": err}
    if x.device.type == "cuda":
        xs = rotating(x)
        res["ms"] = probe.graph_ms(lambda: bisect_case(case, next(xs), dz), reps,
                                   counted=(bisect_case,))
        res["call_ms"] = probe.median_ms(lambda: bisect_case(case, x, dz), reps)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    for c in sys.argv[1:] or CASES:
        run_case(c)
