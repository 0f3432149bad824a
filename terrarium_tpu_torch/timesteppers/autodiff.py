"""Differentiable stepping and rollouts through the module steps (counterpart
of ``terrarium_tpu/timesteppers/autodiff.py``).

This is the port of the JAX package's XLA gradient path: torch autograd
through the eager process modules, on the grid's device, with
``torch.utils.checkpoint`` where JAX uses ``jax.checkpoint``. The fused
gradient path, a CUDA segment-VJP kernel behind the column kernel, is
:mod:`terrarium_tpu_torch.timesteppers.fused_grad`.

* ``remat=False`` keeps every step's autograd graph: fastest backward,
  memory linear in the steps.
* ``remat=True`` checkpoints each step: only its input carry is kept and
  the step is recomputed in the backward pass.
* ``lean=True`` runs the closure-rotated ``pre_closure_step``, whose carry
  is the model's declared ``live_carry``, and ends with one ``closure``; the
  per-step checkpoint then keeps only the live prognostics.

The JAX package's ``segment=`` and ``policy=`` schedules are not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..state import Clock, State

__all__ = ["make_step_fn", "make_rollout_fn"]


def make_step_fn(model, timestepper, ctx) -> Callable:
    """``step(state, dt) -> state``: one full step on a copy of ``state``."""

    def step(state: State, dt) -> State:
        out = state.copy()
        timestepper.step(model, out, ctx, dt)
        return out

    return step


def _carry_names(state: State, model, lean: bool):
    """``(group, name)`` of the tensors a step reads: the live prognostics
    (``lean``) or every floating field of the state."""
    if lean:
        return [("prognostic", n) for n in model.live_carry]
    return [(g, n) for g in ("prognostic", "tendencies", "auxiliary", "inputs")
            for n, v in getattr(state, g).items() if v.is_floating_point()]


def make_rollout_fn(model, timestepper, ctx, *, steps: int, remat: bool = False,
                    lean: bool = False) -> Callable:
    """``rollout(state, dt) -> state`` over ``steps`` steps, differentiable
    with torch autograd in the initial state and in any tensor parameter of
    ``model``. ``state`` itself is left as it is."""
    if lean and not hasattr(timestepper, "pre_closure_step"):
        raise ValueError(f"lean=True requires a timestepper with pre_closure_step; "
                         f"{type(timestepper).__name__} has none")
    advance = timestepper.pre_closure_step if lean else timestepper.step

    def rollout(state: State, dt) -> State:
        out = state.copy()
        if steps <= 0:
            return out
        names = _carry_names(out, model, lean)
        template = out.copy()  # the fields outside the carry, as the backward recompute sees them

        def step_carry(time, iteration, *carry):
            st = template.copy()
            for (g, n), v in zip(names, carry):
                getattr(st, g)[n] = v
            st.clock = Clock(time, iteration)
            advance(model, st, ctx, dt)
            return (st.clock.time, st.clock.iteration,
                    *(getattr(st, g)[n] for g, n in names))

        if remat:
            # the first steps - 1 steps keep only their input carry; the last
            # one runs on the full state, so its auxiliaries are kept (as
            # JAX's lean_rollout runs its last step outside the scan)
            carry = (out.clock.time, out.clock.iteration,
                     *(getattr(out, g)[n] for g, n in names))
            for _ in range(steps - 1):
                carry = checkpoint(step_carry, *carry, use_reentrant=False)
            out.clock = Clock(carry[0], carry[1])
            for (g, n), v in zip(names, carry[2:]):
                getattr(out, g)[n] = v
            advance(model, out, ctx, dt)
        else:
            for _ in range(steps):
                advance(model, out, ctx, dt)
        if lean:
            model.closure(out, ctx)
        return out

    return rollout
