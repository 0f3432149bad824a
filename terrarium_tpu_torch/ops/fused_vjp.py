"""The segment VJP of the soil column rollouts: a hand-written CUDA kernel, its
plain PyTorch version and the wrapper that picks between them by device
(counterpart of ``terrarium_tpu/ops/fused_vjp.py``).

``soil_column_segment_vjp`` is the vector-Jacobian product of one segment
of a column rollout (:func:`~terrarium_tpu_torch.ops.fused_step.
soil_column_rollout` and its siblings), for each scheme in ``VJP_SCHEMES``:
ForwardEuler, Heun or ImplicitEuler (Thomas or PCR, any number of Picard
iterations) over heat + Richards flow or over the heat-only model. From
the segment's input carry ``(U, sat, S)`` and the cotangents of its output
carry, it returns the cotangents of the input carry and of the two
differentiated parameters, ``K_sat`` and ``sk_mineral`` (``sqrt`` of the
mineral conductivity times the mineral fraction, as :class:`ColumnParams`
holds it). For the heat-only model the carry is ``U`` and the saturation it
reads: the saturation's cotangent gathers every step's, the pool has none
(``S`` and ``gS`` may be ``None``) and ``K_sat``'s is 0. It replaces
``terrarium_tpu/ops/fused_vjp.py::make_segment_vjp``, which is generic over
the stepper. The clock is not differentiated.

The CUDA sources: ForwardEuler, Heun and ImplicitEuler (either solver,
any Picard count) over heat + Richards (``GROUP_SCHEMES``) run each column
on a group of lanes, ``csrc/soil_column_group_segment_vjp.cu``
(``soil::GroupColumn::segment_vjp`` in ``csrc/soil_group_step.cuh``, the
forward and its recompute the group rollout's own ``step``, ``heun_step``
or ``picard_step``); the heat-only schemes one thread a column,
``csrc/soil_column_segment_vjp.cu``, with the steps and their hand-derived
adjoints in ``csrc/soil_step.cuh``. On CPU tensors the
wrapper runs :func:`soil_column_segment_vjp_plain`, torch autograd through
the plain rollout; on CUDA tensors it launches the scheme's kernel or
raises. Each launch adds one to ``soil_column_segment_vjp.launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import cuda_build
from .fused_step import SOLVER_CODES, ColumnParams, SeriesBC, _check_inputs, _CParams, \
    kernel_tags, soil_column_rollout_plain
from .tridiag import SOLVERS

__all__ = ["soil_column_segment_vjp", "soil_column_segment_vjp_plain", "VJP_SCHEMES",
           "GROUP_SCHEMES", "vjp_tags", "vjp_source", "vjp_group"]

_NAME = "soil_column_segment_vjp"  # csrc/soil_column_segment_vjp.cu
_THREADS = 64  # threads a block; the kernel writes one partial a block
_GROUP_NAME = "soil_column_group_segment_vjp"  # csrc/soil_column_group_segment_vjp.cu
_GROUP_THREADS = 256  # threads a block of the group kernel: 256 / G columns
#: the (stepper, physics) that have a segment VJP; ImplicitEuler with any
#: number of Picard iterations
VJP_SCHEMES = (("euler", "richards"), ("heun", "richards"), ("implicit", "richards"),
               ("euler", "heat"), ("heun", "heat"), ("implicit", "heat"))
#: the (stepper, physics) whose segment VJP runs each column on a group of
#: lanes (ImplicitEuler: every Picard count, either solver)
GROUP_SCHEMES = (("euler", "richards"), ("heun", "richards"), ("implicit", "richards"))


def _check_scheme(stepper: str, physics: str, solver: str, picard_iters: int = 1) -> None:
    """``ValueError`` for a scheme without a segment VJP."""
    if (stepper, physics) not in VJP_SCHEMES or solver not in SOLVERS:
        raise ValueError(f"the segment VJP runs {list(VJP_SCHEMES)} with a solver of "
                         f"{sorted(SOLVERS)}, not {(stepper, physics)} with {solver!r}")
    if int(picard_iters) != picard_iters or picard_iters < 1:
        raise ValueError(f"picard_iters must be a positive integer, got {picard_iters!r}")
    if stepper != "implicit" and picard_iters != 1:
        raise ValueError(f"Picard iterations are ImplicitEuler's; {stepper} takes 1, "
                         f"not {picard_iters!r}")


def vjp_tags(stepper: str, physics: str, solver: str, picard_iters: int) -> tuple:
    """The build tags of the segment-VJP instantiation of a scheme
    (:func:`~terrarium_tpu_torch.ops.fused_step.kernel_tags`; every entry
    names its stepper, ForwardEuler's ``("euler", "richards")`` too)."""
    _check_scheme(stepper, physics, solver, picard_iters)
    return kernel_tags(stepper, physics, int(picard_iters), plain_euler=(), solver=solver)


def vjp_source(stepper: str, physics: str) -> str:
    """The CUDA source whose kernel runs the segment VJP of a scheme: the
    group source for ``GROUP_SCHEMES``, the one-thread source for the
    heat-only model."""
    return _GROUP_NAME if (stepper, physics) in GROUP_SCHEMES else _NAME


def soil_column_segment_vjp_plain(U, sat, S, top_T, dz, dz_faces, z_centers, z_faces,
                                  params: ColumnParams, dt: float, gU, gsat, gS, *,
                                  stepper: str = "euler", physics: str = "richards",
                                  solver: str = "pcr", picard_iters: int = 1):
    """``(gU0, gsat0, gS0, gK_sat, gsk_mineral)`` by torch autograd through
    :func:`soil_column_rollout_plain` of the scheme; the parameter cotangents
    are 0-d tensors in the fields' dtype. Heat only: ``gS0`` is ``None`` and
    ``gK_sat`` is 0."""
    _check_scheme(stepper, physics, solver, picard_iters)
    heat = physics == "heat"
    with torch.enable_grad():
        U0, sat0 = (t.detach().requires_grad_() for t in (U, sat))
        S0 = None if heat else S.detach().requires_grad_()
        K = torch.tensor(params.K_sat, dtype=U.dtype, device=U.device, requires_grad=True)
        skm = torch.tensor(params.sk_mineral, dtype=U.dtype, device=U.device,
                           requires_grad=True)
        p = dataclasses.replace(params, K_sat=K, sk_mineral=skm)
        out = soil_column_rollout_plain(U0, sat0, S0, top_T, dz, dz_faces, z_centers,
                                        z_faces, p, dt, stepper=stepper, physics=physics,
                                        solver=solver, picard_iters=picard_iters)
        if heat:
            gU0, gsat0, gK, gskm = torch.autograd.grad(
                out[0], (U0, sat0, K, skm), gU, allow_unused=True)
            # the saturation is passed on unchanged: its output cotangent
            # joins the steps'
            gsat0 = gsat + gsat0
            return gU0, gsat0, None, torch.zeros_like(K), gskm
        return torch.autograd.grad(out, (U0, sat0, S0, K, skm), (gU, gsat, gS))


_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 4
             + [ctypes.POINTER(_CParams), ctypes.c_int, ctypes.c_double, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def vjp_group(dtype: torch.dtype, nz: int, solver: str = "pcr", picard_iters: int = 1,
              stepper: str = "implicit") -> tuple:
    """``(resident warps an SM, G)`` of the group segment-VJP kernel of
    ``stepper`` over heat + Richards (ImplicitEuler: with ``solver`` in the
    entry of ``picard_iters``) at ``dtype`` and depth ``nz``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; built at first
    use)."""
    fn = cuda_build.entry(_GROUP_NAME, dtype, nz, [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                          tags=vjp_tags(stepper, "richards", solver, picard_iters),
                          suffix="_warps")
    group = ctypes.c_int(0)
    warps = fn(SOLVER_CODES[solver], ctypes.byref(group))
    if warps < 0:
        raise RuntimeError("the occupancy query of the group segment-VJP kernel failed")
    return warps, group.value


def soil_column_segment_vjp(U, sat, S, top_T, dz, dz_faces, z_centers, z_faces,
                            params: ColumnParams, dt: float, gU, gsat, gS, *,
                            stepper: str = "euler", physics: str = "richards",
                            solver: str = "pcr", picard_iters: int = 1):
    """The VJP of one segment of ``stepper`` (``"euler"``, ``"heun"`` or
    ``"implicit"`` with ``solver`` and ``picard_iters`` Picard iterations)
    steps of ``physics`` (``"richards"`` or ``"heat"``) from the carry ``(U,
    sat, S)``, applied to the output cotangents ``(gU, gsat, gS)``:
    ``len(top_T)`` steps, Heun one less; returns ``(gU0, gsat0, gS0, gK_sat,
    gsk_mineral)`` (heat only: ``gS0`` is ``None``). CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    _check_scheme(stepper, physics, solver, picard_iters)
    heat = physics == "heat"
    coords = (dz, dz_faces, z_centers, z_faces)
    if isinstance(top_T, SeriesBC):
        raise ValueError("the segment VJP takes the top temperature as a table, not a series")
    _check_inputs(U, sat, S, top_T, coords, heat)
    pairs = (("energy", gU, U), ("saturation", gsat, sat))
    if not heat:
        pairs += (("surface pool", gS, S),)
    for name, g, t in pairs:
        if g.shape != t.shape or g.dtype != t.dtype or g.device != t.device:
            raise ValueError(f"{name} cotangent must match its field: {tuple(g.shape)} "
                             f"{g.dtype} {g.device}")
    steps = top_T.shape[0] - (1 if stepper == "heun" else 0)
    if steps < 0:
        raise ValueError("a Heun table needs steps + 1 rows")
    if U.device.type == "cpu":
        return soil_column_segment_vjp_plain(U, sat, S, top_T, *coords, params, dt, gU, gsat,
                                             gS, stepper=stepper, physics=physics,
                                             solver=solver, picard_iters=picard_iters)
    if U.device.type != "cuda":
        raise ValueError(f"soil column segment VJP runs on cpu or cuda, not {U.device}")
    nz, cells = U.shape
    if not all(t.is_contiguous() for _, g, u in pairs for t in (g, u)) or not all(
            c.is_contiguous() for c in coords):
        raise ValueError("the segment VJP kernel takes contiguous tensors")
    tags = vjp_tags(stepper, physics, solver, picard_iters)
    rows = nz if heat else 2 * nz + 1
    source = vjp_source(stepper, physics)
    fn = cuda_build.entry(source, U.dtype, nz, _ARGTYPES, tags=tags)
    if source == _GROUP_NAME:
        group = vjp_group(U.dtype, nz, solver, picard_iters, stepper)[1]
        blocks = -(-cells // (_GROUP_THREADS // group))
        scratch = torch.empty(steps, cells, rows, dtype=U.dtype, device=U.device)
    else:
        blocks = -(-cells // _THREADS)
        scratch = torch.empty(steps, rows, cells, dtype=U.dtype, device=U.device)
    gU0, gsat0 = torch.empty_like(U), torch.empty_like(sat)
    gS0 = None if heat else torch.empty_like(S)
    partials = torch.empty(2, blocks, dtype=U.dtype, device=U.device)
    gparams = torch.empty(2, dtype=U.dtype, device=U.device)
    step_stride = top_T.stride(0)
    cell_stride = top_T.stride(1) if top_T.dim() == 2 else 0
    cparams = _CParams.of(params)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    err = fn(*(ptr(t) for t in (U, sat, None if heat else S, gU, gsat, None if heat else gS,
                                gU0, gsat0, gS0, partials, gparams, scratch, top_T)),
             step_stride, cell_stride, *(c.data_ptr() for c in coords), ctypes.byref(cparams),
             steps, float(dt), cells, SOLVER_CODES[solver], int(picard_iters),
             torch.cuda.current_stream(U.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"soil column segment VJP kernel launch failed: cudaError {err}")
    soil_column_segment_vjp.launches += 1
    return gU0, gsat0, gS0, gparams[0], gparams[1]


soil_column_segment_vjp.launches = 0
