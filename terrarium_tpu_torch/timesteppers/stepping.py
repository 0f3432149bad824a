"""Forward Euler and Heun (counterpart of
``terrarium_tpu/timesteppers/stepping.py``).

These are the module-by-module steps: the reference composition of the
process hooks, used by ``Simulation.timestep``, by tests and by the module
gradient path. Long rollouts go through the fused column kernel
(:mod:`terrarium_tpu_torch.ops.fused_step`), which computes
``pre_closure_step`` repeated ``n`` times in one launch.

Every step takes the input sources last, ``step(model, state, ctx, dt,
input_sources=())``, so that a call without sources reads as before; the
JAX package passes them before ``dt``.
"""
from __future__ import annotations

import dataclasses

from ..ops.vertical_ops import apply_flux_bcs
from ..state import State, reset_tendencies
from ..variables import XY

__all__ = ["ForwardEuler", "Heun", "explicit_step", "update_state"]


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


def update_state(model, state: State, ctx, input_sources=()) -> None:
    """Reset tendencies, update the inputs (each source in the order given),
    compute auxiliaries, compute tendencies (reference
    `state_variables.jl:72-80`)."""
    reset_tendencies(state)
    for src in input_sources:
        src.update_inputs(state)
    model.compute_auxiliary(state, ctx)
    model.compute_tendencies(state, ctx)


@dataclasses.dataclass(frozen=True)
class ForwardEuler:
    """First-order explicit Euler (reference `forward_euler.jl:6-31`)."""

    dt: float = 300.0

    def default_dt(self):
        return self.dt

    def step(self, model, state: State, ctx, dt, input_sources=()) -> None:
        update_state(model, state, ctx, input_sources)
        explicit_step(model, state, ctx.bcs, dt)
        model.closure(state, ctx)
        state.tick(dt)

    def pre_closure_step(self, model, state: State, ctx, dt, input_sources=()) -> None:
        """The step with its closure moved to the front, so that closure
        variables are rebuilt from the prognostics; ``closure`` after ``n``
        of these equals ``n`` calls of :meth:`step`."""
        model.closure(state, ctx)
        update_state(model, state, ctx, input_sources)
        explicit_step(model, state, ctx.bcs, dt)
        state.tick(dt)


@dataclasses.dataclass(frozen=True)
class Heun:
    """Second-order Heun / improved Euler (reference `heun.jl:37-71`):
    predictor, the tendencies again at the predicted state and time, their
    mean, corrector."""

    dt: float = 300.0

    def default_dt(self):
        return self.dt

    def _predict_correct(self, model, state: State, ctx, dt, input_sources) -> None:
        """From the tendencies at ``state``: the predictor stage (a copy of
        the state, stepped, closed, ticked, its tendencies recomputed at
        t + dt), then ``state += 0.5 * (f_n + f*) * dt`` and the tick."""
        stage = state.copy()
        explicit_step(model, stage, ctx.bcs, dt)
        model.closure(stage, ctx)
        stage.tick(dt)
        update_state(model, stage, ctx, input_sources)
        state.tendencies = {k: 0.5 * (state.tendencies[k] + stage.tendencies[k])
                            for k in state.tendencies}
        explicit_step(model, state, ctx.bcs, dt)

    def step(self, model, state: State, ctx, dt, input_sources=()) -> None:
        update_state(model, state, ctx, input_sources)
        self._predict_correct(model, state, ctx, dt, input_sources)
        model.closure(state, ctx)
        state.tick(dt)

    def pre_closure_step(self, model, state: State, ctx, dt, input_sources=()) -> None:
        """Closure-rotated Heun step (see :meth:`ForwardEuler.pre_closure_step`):
        the trailing closure moves to the front; the predictor stage's own
        closure stays in place."""
        model.closure(state, ctx)
        update_state(model, state, ctx, input_sources)
        self._predict_correct(model, state, ctx, dt, input_sources)
        state.tick(dt)
