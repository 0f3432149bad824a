"""Gradients through the fused column rollout (counterpart of
``terrarium_tpu/timesteppers/fused_grad.py``).

``make_fused_grad_rollout`` builds ``rollout(state, params)``: ``steps``
closure-rotated Forward Euler steps in segments of ``inner_steps``, then one
trailing ``closure``, differentiable with torch autograd in the initial state
and in ``params``. Each segment is a :class:`torch.autograd.Function`:

* forward: :func:`~terrarium_tpu_torch.ops.fused_step.soil_column_rollout`
  (the CUDA column kernel on the card, its plain version on the CPU); the
  segment's input carry is saved, which is the whole checkpoint;
* backward: :func:`~terrarium_tpu_torch.ops.fused_vjp.soil_column_segment_vjp`
  (the CUDA segment-VJP kernel on the card), which recomputes the segment's
  steps from that carry and sweeps back through them.

The parameters that reach the kernels as numbers, ``K_sat`` and the mineral
conductivity (as ``sk_mineral``), enter each segment as 0-d tensors, and
their cotangents from the VJP are chained to the caller's tensors by torch.
The clock is not differentiated.

The JAX package's ``bwd="xla"``, ``bwd_chunk`` and ``bwd_remat`` options are
memory schedules of its XLA backward and have no counterpart here; the XLA
gradient path itself is :mod:`terrarium_tpu_torch.timesteppers.autodiff`.
"""
from __future__ import annotations

from typing import Callable

import torch

from .stepping import ForwardEuler
from ..ops.bcs import InputRef, bc_call_arity
from ..ops.fused_step import (ColumnParams, clock_times, kernel_physics, soil_column_rollout,
                              top_temperature_table, top_temperature_value)
from ..ops.fused_vjp import soil_column_segment_vjp
from ..state import reset_tendencies

__all__ = ["make_fused_grad_rollout"]


class _Segment(torch.autograd.Function):
    """``len(table)`` fused steps of the carry; differentiable in the carry,
    ``K_sat`` and ``sk_mineral`` (0-d tensors whose values ``params`` holds)."""

    @staticmethod
    def forward(ctx, U, sat, S, K_sat, sk_mineral, table, coords, params, dt):
        ctx.save_for_backward(U, sat, S, table, *coords)
        ctx.params, ctx.dt = params, dt
        return soil_column_rollout(U, sat, S, table, *coords, params, dt)

    @staticmethod
    def backward(ctx, gU, gsat, gS):
        U, sat, S, table, *coords = ctx.saved_tensors
        gU0, gsat0, gS0, gK, gskm = soil_column_segment_vjp(
            U, sat, S, table, *coords, ctx.params, ctx.dt,
            gU.contiguous(), gsat.contiguous(), gS.contiguous())
        f64 = torch.float64
        return gU0, gsat0, gS0, gK.to(f64), gskm.to(f64), None, None, None, None


def _param_tensors(model, device):
    """``K_sat`` and ``sk_mineral`` of ``model`` as float64 0-d tensors, on
    the graph of the model's tensor parameters where it has them."""
    soil = model.soil
    por = soil.strat.bulk_porosity(soil.biogeochem)
    mineral_frac = (1.0 - por) * (1.0 - soil.strat.organic_fraction(soil.biogeochem))
    K, k_min = (x.to(device=device, dtype=torch.float64) if isinstance(x, torch.Tensor)
                else torch.tensor(float(x), dtype=torch.float64, device=device)
                for x in (soil.hydrology.hydraulic_properties.sat_hydraulic_cond,
                          soil.energy.thermal_properties.conductivities.mineral))
    return K, torch.sqrt(k_min) * mineral_frac


def make_fused_grad_rollout(model_fn: Callable, timestepper, ctx, input_sources=(), *,
                            steps: int, dt: float, inner_steps: int) -> Callable:
    """Build ``rollout(state, params) -> state`` differentiable in both
    arguments, with the forward on the column kernel and the backward on
    the segment-VJP kernel.

    Args:
        model_fn: ``params -> model``, a :class:`SoilModel` with Richards
            flow that the rollout kernel runs, whose ``sat_hydraulic_cond``
            and mineral conductivity may be 0-d tensors built from
            ``params``.
        timestepper: :class:`ForwardEuler`.
        ctx: the simulation's context; its only BC is a Dirichlet top
            temperature given as a value or as ``f(t)``.

    Raises ``ValueError`` for anything else: another stepper (Heun), the
    heat-only model (NoFlow), an input variable as the top temperature.
        steps: total rollout length, a multiple of ``inner_steps``.
        inner_steps: steps of one segment (the checkpoint interval).
    """
    if steps % inner_steps != 0:
        raise ValueError(f"steps={steps} not a multiple of inner_steps={inner_steps}")
    if not isinstance(timestepper, ForwardEuler):
        raise ValueError(f"the fused gradient rollout runs ForwardEuler, not "
                         f"{type(timestepper).__name__}: the segment VJP of Heun and "
                         f"ImplicitEuler is still to port (ROADMAP Queue B #5); "
                         f"timesteppers/autodiff.make_rollout_fn differentiates any stepper")
    for src in input_sources:
        if hasattr(src, "times"):
            raise ValueError("make_fused_grad_rollout supports static input sources only")
    if getattr(ctx, "forcings", None):
        raise ValueError("the fused gradient rollout takes no forcings; "
                         "timesteppers/autodiff.make_rollout_fn differentiates them")
    value = top_temperature_value(ctx.bcs)
    if isinstance(value, (str, InputRef)) or (callable(value) and bc_call_arity(value) >= 2):
        raise ValueError("the fused gradient rollout takes a top temperature given as a "
                         "value or as f(t)")

    def rollout(state, params):
        model = model_fn(params)
        if kernel_physics(model) != "richards":
            raise ValueError("the fused gradient rollout runs the heat + Richards model "
                             "(RichardsEq), not the heat-only model (NoFlow)")
        grid = model.grid
        cparams = ColumnParams.of(model, grid.dtype)
        K, skm = _param_tensors(model, grid.device)
        coords = tuple(torch.as_tensor(a, device=grid.device).to(grid.dtype) for a in (
            grid.vertical.dz, grid.vertical.dz_faces, grid.vertical.z_centers,
            grid.vertical.z_faces))
        U, sat, S = (state.prognostic[n] for n in model.live_carry)
        times = clock_times(state.clock.time, dt, steps)
        for i in range(0, steps, inner_steps):
            table = top_temperature_table(value, times[i:i + inner_steps], grid)
            U, sat, S = _Segment.apply(U, sat, S, K, skm, table, coords, cparams, dt)
        out = state.copy()
        out.set(internal_energy=U, saturation_water_ice=sat, surface_excess_water=S)
        out.clock.time = torch.as_tensor(times[-1], device=grid.device)
        out.clock.iteration = out.clock.iteration + steps
        reset_tendencies(out)
        # trailing closure: rebuilds the closure variables from the carry
        model.closure(out, ctx)
        return out

    return rollout
