"""The segment VJP of the LandModel column rollouts: a hand-written CUDA
kernel, its plain PyTorch version and the wrapper that picks between them by
device (the land counterpart of :mod:`~terrarium_tpu_torch.ops.fused_vjp`).

``land_column_segment_vjp`` is the vector-Jacobian product of one segment
of :func:`~terrarium_tpu_torch.ops.land_step.land_column_rollout`,
:func:`~terrarium_tpu_torch.ops.land_step.land_column_heun_rollout` or
:func:`~terrarium_tpu_torch.ops.land_step.land_column_implicit_rollout`
(Thomas or PCR solves, any number of Picard iterations), for each scheme in
``LAND_VJP_SCHEMES``, over a LandModel with or without a snowpack and with
static inputs: every composition the land rollout kernel takes with static
inputs. From the segment's input carry (the model's live carry, the SWE
under a snowpack; under ``NoFlow`` also the saturation, which the steps
read) and the cotangents of
its output carry, it returns the cotangents of the input carry and of the
two differentiated parameters, ``K_sat`` and ``sk_mineral`` (``sqrt`` of
the mineral conductivity times the mineral fraction, as the soil's
:class:`~terrarium_tpu_torch.ops.fused_step.ColumnParams` holds it). It
replaces ``terrarium_tpu/ops/fused_vjp.py::make_segment_vjp`` traced over a
LandModel step. The clock is not differentiated.

The CUDA sources: ImplicitEuler (either solver, any Picard count) over
Richards flow without a snowpack (``vjp_source``) runs each column on a
group of lanes, ``csrc/land_column_group_segment_vjp.cu``
(``land::GroupColumn::segment_vjp`` in ``csrc/land_group_step.cuh``);
every other scheme and composition (ForwardEuler, Heun, a snowpack,
``NoFlow``) one thread a column, ``csrc/land_column_segment_vjp.cu``, with
the step's adjoint in ``csrc/land_adjoint.cuh``. On CPU tensors the
wrapper runs :func:`land_column_segment_vjp_plain`, torch autograd through
the plain rollout (the process modules); on CUDA tensors it launches the
kernel of the composition's type or raises. Each launch adds one to
``land_column_segment_vjp.launches``.
Where the plain version's autograd gives NaN (0 * inf in a gated-off
photosynthesis, see ``land_adjoint.cuh``) the kernel gives the taken
branch's derivative.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional

import torch

from . import cuda_build
from .fused_step import SOLVER_CODES, _number
from .land_step import (_CARRY_OF, _CLAND, LandInput, LandParams, _check, _CLandCarry,
                        _CLandInputs, carry_names, implicit_tags, land_column_rollout_plain,
                        launch_args)

__all__ = ["land_column_segment_vjp", "land_column_segment_vjp_plain", "LAND_VJP_SCHEMES",
           "mineral_fraction", "vjp_source", "vjp_group"]

_NAME = "land_column_segment_vjp"  # csrc/land_column_segment_vjp.cu
_THREADS = 64  # threads a block; the kernel writes one partial a block
_GROUP_NAME = "land_column_group_segment_vjp"  # csrc/land_column_group_segment_vjp.cu
_GROUP_THREADS = 256  # threads a block of the group kernel: 256 / G columns
#: the (stepper, solver) that have a land segment VJP, ImplicitEuler's with
#: any number of Picard iterations
LAND_VJP_SCHEMES = (("euler", None), ("heun", None), ("implicit", "thomas"),
                    ("implicit", "pcr"))


def mineral_fraction(soil) -> float:
    """The mineral share of a soil's volume, ``(1 - porosity) (1 -
    organic fraction)``: ``sk_mineral = sqrt(k_mineral)`` times it."""
    por = soil.strat.bulk_porosity(soil.biogeochem)
    return (1.0 - por) * (1.0 - soil.strat.organic_fraction(soil.biogeochem))


def check_scheme(params: LandParams, stepper: str, solver: Optional[str],
                 picard_iters: int = 1) -> tuple:
    """The kernel's stepper tags of a scheme (``("heun",)`` for Heun,
    ImplicitEuler's with ``picard_iters`` Picard iterations);
    ``ValueError`` for one without a land segment VJP."""
    if (stepper, solver if stepper == "implicit" else None) not in LAND_VJP_SCHEMES:
        raise ValueError(f"the land segment VJP runs {list(LAND_VJP_SCHEMES)}, not "
                         f"{(stepper, solver)}")
    if stepper != "implicit":
        if picard_iters != 1:
            raise ValueError(f"Picard iterations are ImplicitEuler's, not {stepper!r}'s")
        return ("heun",) if stepper == "heun" else ()
    return implicit_tags(solver, picard_iters)


def vjp_source(params: LandParams, stepper: str) -> str:
    """The CUDA source of the land segment VJP of ``stepper`` over the
    composition of ``params``: the group kernel's for ImplicitEuler (either
    solver, any Picard count) over Richards flow without a snowpack, the
    one-thread kernel's for any other."""
    tags = params.tags
    if stepper == "implicit" and tags[1] == "richards" and "snow" not in tags:
        return _GROUP_NAME
    return _NAME


def vjp_group(dtype: torch.dtype, nz: int, tags: tuple, solver: str) -> tuple:
    """``(resident warps an SM, G)`` of the group segment-VJP kernel of
    ``solver`` in the entry of ``tags`` (the stepper's and the
    composition's) at ``dtype`` and depth ``nz``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; built at first
    use)."""
    fn = cuda_build.entry(_GROUP_NAME, dtype, nz, [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                          tags=tags, suffix="_warps")
    group = ctypes.c_int(0)
    warps = fn(SOLVER_CODES[solver], ctypes.byref(group))
    if warps < 0:
        raise RuntimeError("the occupancy query of the land group segment-VJP kernel failed")
    return warps, group.value


def _check_static(inputs: Dict[str, LandInput]) -> None:
    series = sorted(n for n, inp in inputs.items() if inp.rows != 1)
    if series:
        raise ValueError(f"the land segment VJP takes static inputs; {series} are series, "
                         f"which the fused gradient does not take, in JAX as here (ROADMAP "
                         f"Queue B #1: not to port)")


def land_column_segment_vjp_plain(carry, inputs, root_fraction, dz, dz_faces, z_centers,
                                  z_faces, params: LandParams, dt: float, time: float,
                                  steps: int, gcarry, *, stepper: str = "euler",
                                  solver: Optional[str] = None, picard_iters: int = 1,
                                  per_column: bool = False):
    """``(gcarry0, gK_sat, gsk_mineral)`` by torch autograd through
    :func:`land_column_rollout_plain` of the scheme, with the model's
    saturated hydraulic conductivity and mineral conductivity as leaves;
    ``gcarry0`` has the keys of ``carry`` (zeros where the output does not
    depend on a field) and the parameter cotangents are 0-d tensors in the
    fields' dtype, or, ``per_column``, each column's share of them (one
    leaf a column, shape ``(cells,)``)."""
    check_scheme(params, stepper, solver, picard_iters)
    U = carry["internal_energy"]
    model = params.model
    soil = model.soil
    hp, thermal = soil.hydrology.hydraulic_properties, soil.energy.thermal_properties
    with torch.enable_grad():
        c0 = {n: t.detach().requires_grad_() for n, t in carry.items()}
        shape = U.shape[1:] if per_column else ()
        K, kmin = (torch.full(shape, _number(v), dtype=U.dtype, device=U.device,
                              requires_grad=True)
                   for v in (hp.sat_hydraulic_cond, thermal.conductivities.mineral))
        soil = dataclasses.replace(
            soil,
            hydrology=dataclasses.replace(soil.hydrology, hydraulic_properties=dataclasses.replace(
                hp, sat_hydraulic_cond=K)),
            energy=dataclasses.replace(soil.energy, thermal_properties=dataclasses.replace(
                thermal, conductivities=dataclasses.replace(thermal.conductivities,
                                                            mineral=kmin))))
        p = dataclasses.replace(params, model=dataclasses.replace(model, soil=soil))
        out = land_column_rollout_plain(c0, inputs, root_fraction, dz, dz_faces, z_centers,
                                        z_faces, p, dt, time, steps, stepper=stepper,
                                        solver=solver, picard_iters=picard_iters)
        names = list(out)
        leaves = list(c0.values()) + [K, kmin]
        grads = torch.autograd.grad([out[n] for n in names], leaves,
                                    [gcarry[n] for n in names], allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    gK, gk = grads[-2:]
    # sk_mineral = sqrt(k_mineral) * mineral_fraction
    gskm = gk * (2.0 * torch.sqrt(kmin.detach()) / mineral_fraction(model.soil))
    return dict(zip(c0, grads[:-2])), gK, gskm


def _argtypes(dtype) -> list:
    """The entry point's: the carry, the output cotangents, the input
    cotangents, the inputs, the root fraction and its strides, the
    coordinates, the parameters, the scratch, the per-block partials and the
    parameter cotangents, steps, dt, cells, the solver code, the Picard
    count, the stream."""
    return ([ctypes.POINTER(_CLandCarry)] * 3
            + [ctypes.POINTER(_CLandInputs), ctypes.c_void_p, ctypes.c_longlong,
               ctypes.c_longlong] + [ctypes.c_void_p] * 4
            + [ctypes.POINTER(_CLAND[dtype])] + [ctypes.c_void_p] * 3
            + [ctypes.c_int, ctypes.c_double, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p])


def land_column_segment_vjp(carry: Dict[str, torch.Tensor], inputs: Dict[str, LandInput],
                            root_fraction: Optional[torch.Tensor], dz, dz_faces, z_centers,
                            z_faces, params: LandParams, dt: float, time: float, steps: int,
                            gcarry: Dict[str, torch.Tensor], *, stepper: str = "euler",
                            solver: Optional[str] = None, picard_iters: int = 1):
    """The VJP of ``steps`` land steps of ``stepper`` (``"euler"``,
    ``"heun"``, or ``"implicit"`` with ``solver`` ``"pcr"`` or ``"thomas"``
    and ``picard_iters`` Picard iterations) from
    ``carry`` with the static ``inputs``, as the land rollout wrappers take
    them, applied to ``gcarry``, the cotangents of the output carry (the
    model's live carry); returns ``(gcarry0, gK_sat, gsk_mineral)``. CPU
    tensors take :func:`land_column_segment_vjp_plain`; CUDA tensors launch
    the kernel of ``params.tags`` from the source ``vjp_source`` names.
    Raises ``ValueError`` for series
    inputs, which the fused gradient does not take."""
    stepper_tags = check_scheme(params, stepper, solver, picard_iters)
    coords = (dz, dz_faces, z_centers, z_faces)
    _check(carry, inputs, root_fraction, coords, params)
    _check_static(inputs)
    live = params.model.live_carry
    if set(gcarry) != set(live):
        raise ValueError(f"the land segment VJP takes the cotangents of {live}, got "
                         f"{tuple(gcarry)}")
    for n in live:
        g, t = gcarry[n], carry[n]
        if g.shape != t.shape or g.dtype != t.dtype or g.device != t.device:
            raise ValueError(f"{n} cotangent must match its field: {tuple(g.shape)} "
                             f"{g.dtype} {g.device}")
    if steps < 0:
        raise ValueError("steps must be >= 0")
    U = carry["internal_energy"]
    if U.device.type == "cpu":
        return land_column_segment_vjp_plain(carry, inputs, root_fraction, *coords, params, dt,
                                             time, steps, gcarry, stepper=stepper,
                                             solver=solver, picard_iters=picard_iters)
    if U.device.type != "cuda":
        raise ValueError(f"land column segment VJP runs on cpu or cuda, not {U.device}")
    for t in (*carry.values(), *gcarry.values(), *coords):
        if not t.is_contiguous():
            raise ValueError("the land segment VJP kernel takes contiguous tensors")
    nz, cells = U.shape
    tags = tuple(stepper_tags) + params.tags
    source = vjp_source(params, stepper)
    fn = cuda_build.entry(source, U.dtype, nz, _argtypes(U.dtype), tags=tags)
    gin = {n: torch.empty_like(carry[n]) for n in carry_names(params)}
    if source == _GROUP_NAME:
        group = vjp_group(U.dtype, nz, tags, solver)[1]
        blocks = -(-cells // (_GROUP_THREADS // group))
    else:
        blocks = -(-cells // _THREADS)
    # a step's carry: U and sat, the pool, skin, canopy water, carbon,
    # fraction and An, and the SWE under a snowpack (land::ScratchRows)
    rows = 2 * nz + 6 + ("snow" in params.tags)
    scratch = torch.empty(steps, rows, cells, dtype=U.dtype, device=U.device)
    partials = torch.empty(2, blocks, dtype=U.dtype, device=U.device)
    gparams = torch.empty(2, dtype=U.dtype, device=U.device)
    args, keep = launch_args(carry, gin, inputs, root_fraction, coords, params)
    c_gout = _CLandCarry(**{_CARRY_OF[n]: t.data_ptr() for n, t in gcarry.items()})
    err = fn(args[0], ctypes.byref(c_gout), *args[1:], scratch.data_ptr(), partials.data_ptr(),
             gparams.data_ptr(), steps, float(dt), cells, SOLVER_CODES.get(solver, 0),
             int(picard_iters), torch.cuda.current_stream(U.device).cuda_stream)
    del keep
    if err != 0:
        raise RuntimeError(f"land column segment VJP kernel launch failed: cudaError {err}")
    land_column_segment_vjp.launches += 1
    return gin, gparams[0], gparams[1]


land_column_segment_vjp.launches = 0
