"""The segment VJP of the soil column rollout: a hand-written CUDA kernel, its
plain PyTorch version and the wrapper that picks between them by device
(counterpart of ``terrarium_tpu/ops/fused_vjp.py``).

``soil_column_segment_vjp`` is the vector-Jacobian product of
:func:`~terrarium_tpu_torch.ops.fused_step.soil_column_rollout` over one
segment of ``len(top_T)`` steps: from the segment's input carry ``(U, sat,
S)`` and the cotangents of its output carry, it returns the cotangents of the
input carry and of the two differentiated parameters, ``K_sat`` and
``sk_mineral`` (``sqrt`` of the mineral conductivity times the mineral
fraction, as :class:`ColumnParams` holds it). It replaces
``terrarium_tpu/ops/fused_vjp.py::make_segment_vjp`` for the main-path step.
The clock is not differentiated.

The CUDA source is ``csrc/soil_column_segment_vjp.cu``, with the step and its
hand-derived adjoint in ``csrc/soil_step.cuh``. On CPU tensors the wrapper
runs :func:`soil_column_segment_vjp_plain`, torch autograd through the plain
rollout; on CUDA tensors it launches the kernel or raises. Each launch adds
one to ``soil_column_segment_vjp.launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import cuda_build
from .fused_step import ColumnParams, SeriesBC, _check_inputs, _CParams, \
    soil_column_rollout_plain

__all__ = ["soil_column_segment_vjp", "soil_column_segment_vjp_plain"]

_NAME = "soil_column_segment_vjp"  # csrc/soil_column_segment_vjp.cu
_THREADS = 64  # threads a block; the kernel writes one partial a block


def soil_column_segment_vjp_plain(U, sat, S, top_T, dz, dz_faces, z_centers, z_faces,
                                  params: ColumnParams, dt: float, gU, gsat, gS):
    """``(gU0, gsat0, gS0, gK_sat, gsk_mineral)`` by torch autograd through
    :func:`soil_column_rollout_plain`; the parameter cotangents are 0-d
    tensors in the fields' dtype."""
    with torch.enable_grad():
        U0, sat0, S0 = (t.detach().requires_grad_() for t in (U, sat, S))
        K = torch.tensor(params.K_sat, dtype=U.dtype, device=U.device, requires_grad=True)
        skm = torch.tensor(params.sk_mineral, dtype=U.dtype, device=U.device,
                           requires_grad=True)
        p = dataclasses.replace(params, K_sat=K, sk_mineral=skm)
        out = soil_column_rollout_plain(U0, sat0, S0, top_T, dz, dz_faces, z_centers,
                                        z_faces, p, dt)
        return torch.autograd.grad(out, (U0, sat0, S0, K, skm), (gU, gsat, gS))


_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 4
             + [ctypes.POINTER(_CParams), ctypes.c_int, ctypes.c_double, ctypes.c_longlong,
                ctypes.c_void_p])


def soil_column_segment_vjp(U, sat, S, top_T, dz, dz_faces, z_centers, z_faces,
                            params: ColumnParams, dt: float, gU, gsat, gS):
    """The VJP of ``len(top_T)`` fused soil steps from the carry ``(U, sat,
    S)``, applied to the output cotangents ``(gU, gsat, gS)``; returns
    ``(gU0, gsat0, gS0, gK_sat, gsk_mineral)``. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    coords = (dz, dz_faces, z_centers, z_faces)
    if isinstance(top_T, SeriesBC):
        raise ValueError("the segment VJP takes the top temperature as a table, not a series")
    _check_inputs(U, sat, S, top_T, coords)
    for name, g, t in (("energy", gU, U), ("saturation", gsat, sat), ("surface pool", gS, S)):
        if g.shape != t.shape or g.dtype != t.dtype or g.device != t.device:
            raise ValueError(f"{name} cotangent must match its field: {tuple(g.shape)} "
                             f"{g.dtype} {g.device}")
    if U.device.type == "cpu":
        return soil_column_segment_vjp_plain(U, sat, S, top_T, *coords, params, dt, gU, gsat,
                                             gS)
    if U.device.type != "cuda":
        raise ValueError(f"soil column segment VJP runs on cpu or cuda, not {U.device}")
    nz, cells = U.shape
    fn = cuda_build.entry(_NAME, U.dtype, nz, _ARGTYPES)
    for t in (U, sat, S, gU, gsat, gS, *coords):
        if not t.is_contiguous():
            raise ValueError("the segment VJP kernel takes contiguous tensors")
    steps = top_T.shape[0]
    blocks = -(-cells // _THREADS)
    gU0, gsat0, gS0 = torch.empty_like(U), torch.empty_like(sat), torch.empty_like(S)
    partials = torch.empty(2, blocks, dtype=U.dtype, device=U.device)
    gparams = torch.empty(2, dtype=U.dtype, device=U.device)
    scratch = torch.empty(steps, 2 * nz + 1, cells, dtype=U.dtype, device=U.device)
    step_stride = top_T.stride(0)
    cell_stride = top_T.stride(1) if top_T.dim() == 2 else 0
    cparams = _CParams.of(params)
    err = fn(*(t.data_ptr() for t in (U, sat, S, gU, gsat, gS, gU0, gsat0, gS0, partials,
                                      gparams, scratch, top_T)),
             step_stride, cell_stride, *(c.data_ptr() for c in coords), ctypes.byref(cparams),
             steps, float(dt), cells, torch.cuda.current_stream(U.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"soil column segment VJP kernel launch failed: cudaError {err}")
    soil_column_segment_vjp.launches += 1
    return gU0, gsat0, gS0, gparams[0], gparams[1]


soil_column_segment_vjp.launches = 0
