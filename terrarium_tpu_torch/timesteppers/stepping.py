"""Forward Euler and Heun (counterpart of
``terrarium_tpu/timesteppers/stepping.py``).

These are the module-by-module steps: the reference composition of the
process hooks, used by ``Simulation.timestep``, by ``Simulation.run`` for
the compositions no column kernel takes, by tests and by the module
gradient path. Long rollouts of the compositions the kernels take go
through the fused column kernels (:mod:`terrarium_tpu_torch.ops.fused_step`),
which compute ``pre_closure_step`` repeated ``n`` times in one launch.

Every step takes the JAX package's arguments, ``step(model, state, ctx,
input_sources, dt)``, and updates ``state`` in place. After each explicit
update the model's post-step hook ``model.timestep(state, ctx, dt)`` runs,
in the predictor stage of Heun too, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

from ..ops.vertical_ops import apply_flux_bcs
from ..state import State, reset_tendencies
from ..variables import XY

__all__ = ["ForwardEuler", "Heun", "apply_forcings", "explicit_step", "update_state"]


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


def apply_forcings(state: State, grid, forcings) -> None:
    """Add the user's source and sink terms to the prognostic tendencies
    (reference `src/forcings.jl:13-19`): for each ``name -> fn(state,
    grid)`` the value, in the prognostic's units per second and shaped like
    it (or broadcasting to it), is added to its tendency, so forcings stack
    with the process tendencies. Runs in :func:`update_state`, so each Heun
    stage evaluates it again."""
    for name, fn in (forcings or {}).items():
        state.add_tendencies(**{name: fn(state, grid)})


def update_state(model, state: State, ctx, input_sources=()) -> None:
    """Reset tendencies, update the inputs (each source in the order given),
    compute auxiliaries, compute tendencies, add the forcings (reference
    `state_variables.jl:72-80`)."""
    reset_tendencies(state)
    for src in input_sources:
        src.update_inputs(state)
    model.compute_auxiliary(state, ctx)
    model.compute_tendencies(state, ctx)
    apply_forcings(state, model.grid, getattr(ctx, "forcings", None))


@dataclasses.dataclass(frozen=True)
class ForwardEuler:
    """First-order explicit Euler (reference `forward_euler.jl:6-31`)."""

    dt: float = 300.0

    def default_dt(self):
        return self.dt

    def step(self, model, state: State, ctx, input_sources, dt) -> None:
        update_state(model, state, ctx, input_sources)
        explicit_step(model, state, ctx.bcs, dt)
        model.timestep(state, ctx, dt)
        model.closure(state, ctx)
        state.tick(dt)

    def pre_closure_step(self, model, state: State, ctx, input_sources, dt) -> None:
        """The step with its closure moved to the front, so that closure
        variables are rebuilt from the prognostics; ``closure`` after ``n``
        of these equals ``n`` calls of :meth:`step`."""
        model.closure(state, ctx)
        update_state(model, state, ctx, input_sources)
        explicit_step(model, state, ctx.bcs, dt)
        model.timestep(state, ctx, dt)
        state.tick(dt)


@dataclasses.dataclass(frozen=True)
class Heun:
    """Second-order Heun / improved Euler (reference `heun.jl:37-71`):
    predictor, the tendencies again at the predicted state and time, their
    mean, corrector."""

    dt: float = 300.0

    def default_dt(self):
        return self.dt

    def _predict_correct(self, model, state: State, ctx, input_sources, dt) -> None:
        """From the tendencies at ``state``: the predictor stage (a copy of
        the state, stepped, post-stepped, closed, ticked, its tendencies
        recomputed at t + dt), then ``state += 0.5 * (f_n + f*) * dt`` and
        the post-step hook."""
        stage = state.copy()
        explicit_step(model, stage, ctx.bcs, dt)
        model.timestep(stage, ctx, dt)
        model.closure(stage, ctx)
        stage.tick(dt)
        update_state(model, stage, ctx, input_sources)
        state.tendencies = {k: 0.5 * (state.tendencies[k] + stage.tendencies[k])
                            for k in state.tendencies}
        explicit_step(model, state, ctx.bcs, dt)
        model.timestep(state, ctx, dt)

    def step(self, model, state: State, ctx, input_sources, dt) -> None:
        update_state(model, state, ctx, input_sources)
        self._predict_correct(model, state, ctx, input_sources, dt)
        model.closure(state, ctx)
        state.tick(dt)

    def pre_closure_step(self, model, state: State, ctx, input_sources, dt) -> None:
        """Closure-rotated Heun step (see :meth:`ForwardEuler.pre_closure_step`):
        the trailing closure moves to the front; the predictor stage's own
        closure stays in place."""
        model.closure(state, ctx)
        update_state(model, state, ctx, input_sources)
        self._predict_correct(model, state, ctx, input_sources, dt)
        state.tick(dt)
