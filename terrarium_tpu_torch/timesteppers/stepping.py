"""Forward Euler (counterpart of ``terrarium_tpu/timesteppers/stepping.py``).

These are the module-by-module steps: the reference composition of the
process hooks, used at initialization, by tests and for single steps. Long
rollouts go through the fused column kernel
(:mod:`terrarium_tpu_torch.ops.fused_step`), which computes
``pre_closure_step`` repeated ``n`` times in one launch.
"""
from __future__ import annotations

import dataclasses

from ..ops.vertical_ops import apply_flux_bcs
from ..state import State, reset_tendencies
from ..variables import XY

__all__ = ["ForwardEuler", "explicit_step", "update_state"]


def explicit_step(model, state: State, bcs, dt) -> None:
    """``u += du/dt * dt`` for every prognostic variable, after adding its
    Flux-BC contributions to the tendency (reference
    `abstract_timestepper.jl:65-141`)."""
    specs = model.collated_variables().prognostic
    for name in list(state.prognostic):
        var_bcs = (bcs or {}).get(name)
        if var_bcs:
            state.tendencies[name] = apply_flux_bcs(
                state.tendencies[name], var_bcs, state, model.grid.dz,
                xy=isinstance(specs[name].dims, XY))
        state.prognostic[name] = state.prognostic[name] + state.tendencies[name] * dt


def update_state(model, state: State, ctx) -> None:
    """Reset tendencies, compute auxiliaries, compute tendencies (reference
    `state_variables.jl:72-80`)."""
    reset_tendencies(state)
    model.compute_auxiliary(state, ctx)
    model.compute_tendencies(state, ctx)


@dataclasses.dataclass(frozen=True)
class ForwardEuler:
    """First-order explicit Euler (reference `forward_euler.jl:6-31`)."""

    dt: float = 300.0

    def default_dt(self):
        return self.dt

    def step(self, model, state: State, ctx, dt) -> None:
        update_state(model, state, ctx)
        explicit_step(model, state, ctx.bcs, dt)
        model.closure(state, ctx)
        state.tick(dt)

    def pre_closure_step(self, model, state: State, ctx, dt) -> None:
        """The step with its closure moved to the front, so that closure
        variables are rebuilt from the prognostics; ``closure`` after ``n``
        of these equals ``n`` calls of :meth:`step`."""
        model.closure(state, ctx)
        update_state(model, state, ctx)
        explicit_step(model, state, ctx.bcs, dt)
        state.tick(dt)
