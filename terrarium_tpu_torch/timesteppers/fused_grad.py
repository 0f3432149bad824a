"""Gradients through the fused column rollout (counterpart of
``terrarium_tpu/timesteppers/fused_grad.py``).

``make_fused_grad_rollout`` builds ``rollout(state, params)``: ``steps``
closure-rotated steps in segments of ``inner_steps``, then one trailing
``closure``, differentiable with torch autograd in the initial state and in
``params``. The schemes it takes, chosen by type the same way on the CPU
and on the card: for a :class:`SoilModel`, ForwardEuler, Heun or
ImplicitEuler (Thomas or PCR, any number of Picard iterations) over heat +
Richards flow or over the heat-only model; for a :class:`LandModel` with
or without a snowpack (any composition the land kernel runs, with static
inputs), ForwardEuler, Heun or ImplicitEuler (Thomas or PCR, any number of
Picard iterations). Each segment is a :class:`torch.autograd.Function`:

* forward: the scheme's rollout wrapper, soil
  (:data:`~terrarium_tpu_torch.ops.fused_step.ROLLOUTS`) or land
  (:data:`~terrarium_tpu_torch.ops.land_step.ROLLOUTS`; the land group
  rollout at the group segment VJP's G): the CUDA column kernel on the
  card, its plain version on the CPU; the segment's input carry is saved,
  which is the whole checkpoint;
* backward: :func:`~terrarium_tpu_torch.ops.fused_vjp.soil_column_segment_vjp`
  or :func:`~terrarium_tpu_torch.ops.land_vjp.land_column_segment_vjp` of
  the same scheme (the CUDA segment-VJP kernels on the card), which
  recompute the segment's steps from that carry and sweep back through
  them.

The parameters that reach the kernels as numbers, ``K_sat`` and the mineral
conductivity (as ``sk_mineral``), enter each segment as 0-d tensors, and
their cotangents from the VJP are chained to the caller's tensors by torch;
a model whose other soil parameters require grad is refused. The clock is
not differentiated. For the heat-only soil the carry is the internal
energy; the saturation it reads enters every segment, which returns its
cotangent. For the LandModel the carry is the model's live carry (the
snow water equivalent under a snowpack; under ``NoFlow`` with the
saturation it reads) and the inputs are the static values the state
holds.

The JAX package's ``bwd="xla"``, ``bwd_chunk`` and ``bwd_remat`` options are
memory schedules of its XLA backward and have no counterpart here; the XLA
gradient path itself is :mod:`terrarium_tpu_torch.timesteppers.autodiff`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.land_model import LandModel, coupling_bcs
from ..ops import land_step
from ..ops.bcs import InputRef, bc_call_arity
from ..ops.fused_step import (ROLLOUTS, STEPPERS, ColumnParams, clock_times, kernel_physics,
                              top_temperature_table, top_temperature_value)
from ..ops.fused_vjp import soil_column_segment_vjp
from ..ops.land_vjp import check_scheme, land_column_segment_vjp, mineral_fraction, vjp_group
from ..state import reset_tendencies
from .integrator import _coords, land_inputs

__all__ = ["make_fused_grad_rollout"]

_AUTODIFF = "timesteppers/autodiff.make_rollout_fn differentiates it"


class _Segment(torch.autograd.Function):
    """One segment of fused steps of ``scheme`` ``(stepper, physics,
    solver, picard_iters)``: ``len(table)`` steps (Heun one less) of the
    carry ``(U, sat, S)``, returned whole, or of ``U`` alone for the
    heat-only model, which reads ``sat``; differentiable in the carry,
    ``K_sat`` and ``sk_mineral`` (0-d tensors whose values ``params``
    holds)."""

    @staticmethod
    def forward(ctx, U, sat, S, K_sat, sk_mineral, table, coords, params, dt, scheme):
        stepper, physics, solver, picard_iters = scheme
        ctx.save_for_backward(U, sat, S, table, *coords)
        ctx.params, ctx.dt, ctx.scheme = params, dt, scheme
        kw = ({"solver": solver, "picard_iters": picard_iters} if stepper == "implicit"
              else {})
        out = ROLLOUTS[stepper, physics](U, sat, S, table, *coords, params, dt, **kw)
        return out[0] if physics == "heat" else out

    @staticmethod
    def backward(ctx, gU, gsat=None, gS=None):
        U, sat, S, table, *coords = ctx.saved_tensors
        stepper, physics, solver, picard_iters = ctx.scheme
        if physics == "heat":  # the saturation is read: its cotangent is the steps'
            gsat = torch.zeros_like(sat)
        gU0, gsat0, gS0, gK, gskm = soil_column_segment_vjp(
            U, sat, S, table, *coords, ctx.params, ctx.dt, gU.contiguous(), gsat.contiguous(),
            None if gS is None else gS.contiguous(), stepper=stepper, physics=physics,
            solver=solver, picard_iters=picard_iters)
        f64 = torch.float64
        return gU0, gsat0, gS0, gK.to(f64), gskm.to(f64), None, None, None, None, None


class _LandSegment(torch.autograd.Function):
    """One segment of fused LandModel steps: ``spec.steps`` steps of
    ``spec.stepper`` (``spec.solver``, ``spec.picard_iters``) of the carry (the tensors of
    ``spec.names``, :func:`~terrarium_tpu_torch.ops.land_step.carry_names`),
    returning the model's live carry; differentiable in the carry,
    ``K_sat`` and ``sk_mineral`` (0-d tensors whose values ``spec.params``
    holds). The inputs and the root fraction are static and not
    differentiated."""

    @staticmethod
    def forward(ctx, K_sat, sk_mineral, spec, *carry):
        ctx.save_for_backward(*carry)
        ctx.spec = spec
        kw = ({"solver": spec.solver, "picard_iters": spec.picard_iters}
              if spec.stepper == "implicit" else {})
        U = carry[spec.names.index("internal_energy")]
        if U.is_cuda and land_step.group_scheme(spec.params, spec.stepper):
            # the group rollout at the group segment VJP's G: the carries the
            # VJP stores are then this segment's bit for bit
            kw["group"] = vjp_group(U.dtype, U.shape[0], check_scheme(
                spec.params, spec.stepper, spec.solver, spec.picard_iters) + spec.params.tags,
                spec.solver)[1]
        out = land_step.ROLLOUTS[spec.stepper](dict(zip(spec.names, carry)), spec.inputs,
                                               spec.root, *spec.coords, spec.params, spec.dt,
                                               spec.time, spec.steps, **kw)
        return tuple(out[n] for n in spec.params.model.live_carry)

    @staticmethod
    def backward(ctx, *gout):
        carry, spec = ctx.saved_tensors, ctx.spec
        g = {n: torch.zeros_like(c) if gi is None else gi.contiguous()
             for n, gi, c in zip(spec.params.model.live_carry, gout, carry)}
        gin, gK, gskm = land_column_segment_vjp(
            dict(zip(spec.names, carry)), spec.inputs, spec.root, *spec.coords, spec.params,
            spec.dt, spec.time, spec.steps, g, stepper=spec.stepper, solver=spec.solver,
            picard_iters=spec.picard_iters)
        f64 = torch.float64
        return (gK.to(f64), gskm.to(f64), None, *(gin[n] for n in spec.names))


@dataclasses.dataclass(frozen=True)
class _LandSpec:
    """What a land segment runs besides its carry and parameters."""

    names: tuple
    inputs: dict
    root: object
    coords: tuple
    params: object
    dt: float
    time: float
    steps: int
    stepper: str
    solver: object
    picard_iters: int


def _grad_leaves(obj, path):
    """``(path, tensor)`` of each tensor that requires grad in a tree of
    dataclasses, tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        if obj.requires_grad:
            yield path, obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _grad_leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from _grad_leaves(v, f"{path}[{i}]")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _grad_leaves(v, f"{path}[{k!r}]")


def _param_tensors(model, device):
    """``K_sat`` and ``sk_mineral`` of ``model`` as float64 0-d tensors, on
    the graph of the model's tensor parameters where it has them. Raises
    ``ValueError`` for any other soil parameter that requires grad: the
    kernels take it as a number, so its gradient would be lost."""
    soil = model.soil
    hp, thermal = soil.hydrology.hydraulic_properties, soil.energy.thermal_properties
    K, k_min = hp.sat_hydraulic_cond, thermal.conductivities.mineral
    other = [p for p, t in _grad_leaves(soil, "soil") if t is not K and t is not k_min]
    if other:
        raise ValueError(f"the fused gradient rollout differentiates the soil's "
                         f"sat_hydraulic_cond and mineral conductivity only, not {other}; "
                         f"timesteppers/autodiff.make_rollout_fn differentiates every "
                         f"parameter")
    K, k_min = (x.to(device=device, dtype=torch.float64) if isinstance(x, torch.Tensor)
                else torch.tensor(float(x), dtype=torch.float64, device=device)
                for x in (K, k_min))
    return K, torch.sqrt(k_min) * mineral_fraction(soil)


def make_fused_grad_rollout(model_fn: Callable, timestepper, ctx, input_sources=(), *,
                            steps: int, dt: float, inner_steps: int) -> Callable:
    """Build ``rollout(state, params) -> state`` differentiable in both
    arguments, with the forward on the column kernels and the backward on
    the segment-VJP kernel.

    Args:
        model_fn: ``params -> model``, a :class:`SoilModel` that the rollout
            kernels run (heat + Richards, or heat only) or a
            :class:`LandModel` that the land kernel runs (with or without a
            snowpack), whose soil's ``sat_hydraulic_cond`` and mineral
            conductivity may be 0-d tensors built from ``params``; no other
            soil parameter may require grad.
        timestepper: :class:`ForwardEuler`, :class:`Heun` or
            :class:`ImplicitEuler` (Thomas or PCR, any ``picard_iters``).
        ctx: the simulation's context: for a SoilModel its only BC is a
            Dirichlet top temperature given as a value or as ``f(t)``; for
            a LandModel it is the model's coupling context (``sim.ctx``).
        input_sources: static sources only (``FieldInputSource``); a
            LandModel reads its inputs as the state holds them.
        steps: total rollout length, a multiple of ``inner_steps``.
        inner_steps: steps of one segment (the checkpoint interval).

    Raises ``ValueError`` for anything else: another stepper, time-varying
    sources (JAX's refuses them too) or forcings, an input variable as the
    top temperature.
    """
    if steps % inner_steps != 0:
        raise ValueError(f"steps={steps} not a multiple of inner_steps={inner_steps}")
    stepper = STEPPERS.get(type(timestepper))
    if stepper is None:
        raise ValueError(f"the fused gradient rollout runs ForwardEuler, Heun or ImplicitEuler, "
                         f"not {type(timestepper).__name__}; {_AUTODIFF}")
    solver = getattr(timestepper, "solver", "pcr")
    picard_iters = int(timestepper.picard_iters) if stepper == "implicit" else 1
    for src in input_sources:
        if hasattr(src, "times"):
            raise ValueError("make_fused_grad_rollout supports static input sources only, as "
                             "JAX's does (a series variant: ROADMAP Queue B #1, not to port)")
    if getattr(ctx, "forcings", None):
        raise ValueError("the fused gradient rollout takes no forcings; "
                         "timesteppers/autodiff.make_rollout_fn differentiates them")
    land = getattr(ctx, "extras", None) is not None  # the LandModel's coupling context
    value = None  # the soil's top temperature
    if land:
        if (ctx.bcs or {}) != coupling_bcs():
            raise ValueError("the fused gradient rollout of the LandModel takes its coupling "
                             f"BCs only; {_AUTODIFF}")
    else:
        value = top_temperature_value(ctx.bcs)
        if isinstance(value, (str, InputRef)) or (callable(value)
                                                  and bc_call_arity(value) >= 2):
            raise ValueError("the fused gradient rollout takes a top temperature given as a "
                             "value or as f(t)")
    heun = stepper == "heun"

    def land_carry(model, state, times):
        """The live carry after the land segments, as a dict."""
        grid = model.grid
        params = land_step.LandParams.of(model, grid.dtype)
        check_scheme(params, stepper, solver, picard_iters)
        K, skm = _param_tensors(model, grid.device)
        names = land_step.carry_names(params)
        live = model.live_carry
        root = state.auxiliary["root_fraction"] if model.vegetation is not None else None
        inputs = land_inputs(model, state, input_sources)
        carry = tuple(state[n].contiguous() for n in names)
        for i in range(0, steps, inner_steps):
            spec = _LandSpec(names, inputs, root, _coords(grid), params, dt, float(times[i]),
                             inner_steps, stepper, solver if stepper == "implicit" else None,
                             picard_iters)
            carry = _LandSegment.apply(K, skm, spec, *carry) + carry[len(live):]
        return dict(zip(live, carry))

    def soil_carry(model, state, times, scheme):
        """The live carry after the soil segments, as a dict."""
        heat = scheme[1] == "heat"
        grid = model.grid
        cparams = ColumnParams.of(model, grid.dtype)
        K, skm = _param_tensors(model, grid.device)
        coords = tuple(torch.as_tensor(a, device=grid.device).to(grid.dtype) for a in (
            grid.vertical.dz, grid.vertical.dz_faces, grid.vertical.z_centers,
            grid.vertical.z_faces))
        if heat:
            U, sat, S = state.prognostic["internal_energy"], state["saturation_water_ice"], None
        else:
            U, sat, S = (state.prognostic[n] for n in model.live_carry)
        for i in range(0, steps, inner_steps):
            # Heun's stage of the segment's last step reads one more row
            table = top_temperature_table(value, times[i:i + inner_steps + heun], grid)
            out = _Segment.apply(U, sat, S, K, skm, table, coords, cparams, dt, scheme)
            if heat:
                U = out
            else:
                U, sat, S = out
        if heat:
            return {"internal_energy": U}
        return {"internal_energy": U, "saturation_water_ice": sat, "surface_excess_water": S}

    def rollout(state, params):
        model = model_fn(params)
        physics = "land" if isinstance(model, LandModel) else kernel_physics(model)
        scheme = (stepper, physics, solver, picard_iters)
        if (scheme[1] == "land") != land:
            raise ValueError("the context is the LandModel's coupling context only for a "
                             "LandModel")
        times = clock_times(state.clock.time, dt, steps)
        fields = (land_carry(model, state, times) if land
                  else soil_carry(model, state, times, scheme))
        out = state.copy()
        out.set(**fields)
        out.clock.time = torch.as_tensor(times[-1], device=model.grid.device)
        out.clock.iteration = out.clock.iteration + steps
        reset_tendencies(out)
        # trailing closure: rebuilds the closure variables from the carry
        model.closure(out, ctx)
        return out

    return rollout
