"""State container (counterpart of ``terrarium_tpu/state.py``).

The JAX package keeps an immutable pytree and every hook returns a new one.
Here the state is a small mutable object: process hooks *assign* new tensors
into its group dictionaries in place (``state.set``, ``add_tendencies``,
``tick``). Tensors themselves are never written in place, so a tensor taken
from a state keeps its values after the state moves on.

Attribute access forwards across groups: ``state.temperature`` finds the
tensor whichever group holds it.
"""
from __future__ import annotations

from typing import Dict

import torch

from .utils.utils import resolve_device
from .variables import Variables

__all__ = ["Clock", "State", "build_state", "reset_tendencies"]

_FIELD_GROUPS = ("prognostic", "auxiliary", "inputs")


class Clock:
    """Simulation clock: ``time`` is a 0-dim tensor in the grid dtype and
    advances by repeated ``time + dt`` in that dtype, as the JAX `Clock`
    does; ``iteration`` is int32 (f32 grids) or int64 (f64 grids)."""

    def __init__(self, time: torch.Tensor, iteration: torch.Tensor):
        self.time = time
        self.iteration = iteration

    @staticmethod
    def zero(dtype=torch.float64, device="cuda") -> "Clock":
        """A clock at 0 on ``device`` (the CUDA card unless ``"cpu"``)."""
        device = resolve_device(device)
        it = torch.int64 if dtype == torch.float64 else torch.int32
        return Clock(torch.zeros((), dtype=dtype, device=device),
                     torch.zeros((), dtype=it, device=device))

    def tick(self, dt) -> None:
        self.time = self.time + dt
        self.iteration = self.iteration + 1


class State:
    """Prognostic, tendency, auxiliary and input fields plus the clock."""

    def __init__(self, prognostic: Dict[str, torch.Tensor],
                 tendencies: Dict[str, torch.Tensor],
                 auxiliary: Dict[str, torch.Tensor],
                 inputs: Dict[str, torch.Tensor], clock: Clock):
        self.prognostic = prognostic
        self.tendencies = tendencies
        self.auxiliary = auxiliary
        self.inputs = inputs
        self.clock = clock

    def __getattr__(self, name):
        # only reached when normal attribute lookup fails
        for g in _FIELD_GROUPS:
            d = self.__dict__.get(g, {})
            if name in d:
                return d[name]
        raise AttributeError(f"state has no variable {name!r}")

    def __getitem__(self, name):
        return self.__getattr__(name)

    def __contains__(self, name):
        return any(name in getattr(self, g) for g in _FIELD_GROUPS)

    def set(self, **updates: torch.Tensor) -> None:
        """Replace the named fields, each in the group it was declared in."""
        for name, val in updates.items():
            for g in _FIELD_GROUPS:
                d = getattr(self, g)
                if name in d:
                    d[name] = val
                    break
            else:
                raise KeyError(f"unknown state variable {name!r}")

    def add_tendencies(self, **incs: torch.Tensor) -> None:
        """``tendency += increment`` for each name (several processes may
        feed one prognostic variable)."""
        for name, inc in incs.items():
            self.tendencies[name] = self.tendencies[name] + inc

    def tick(self, dt) -> None:
        self.clock.tick(dt)

    def copy(self) -> "State":
        """A state over the same tensors in new group dictionaries and a new
        clock, so that stepping the copy leaves this state as it is."""
        return State(dict(self.prognostic), dict(self.tendencies), dict(self.auxiliary),
                     dict(self.inputs), Clock(self.clock.time, self.clock.iteration))

    def __repr__(self):
        return (f"State(prognostic={list(self.prognostic)}, "
                f"auxiliary={list(self.auxiliary)}, inputs={list(self.inputs)}, "
                f"t={self.clock.time})")


def build_state(variables: Variables, grid, clock: Clock = None) -> State:
    """Allocate a :class:`State` for ``variables`` in the order inputs,
    tendencies, prognostic, auxiliary (reference `state_variables.jl:303-381`),
    so that an auxiliary's ``ctor`` may read fields allocated before it."""
    clock = clock if clock is not None else Clock.zero(grid.dtype, grid.device)
    arrays: Dict[str, torch.Tensor] = {}

    inputs = {}
    for v in variables.inputs.values():
        inputs[v.name] = arrays[v.name] = grid.allocate(v.dims, v.default)
    tendencies = {v.name: grid.allocate(v.dims, 0.0)
                  for v in variables.tendencies.values()}
    prognostic = {}
    for v in variables.prognostic.values():
        prognostic[v.name] = arrays[v.name] = grid.allocate(v.dims, v.default)
    auxiliary = {}
    for v in variables.auxiliary.values():
        if v.ctor is not None:
            val = v.ctor(grid, arrays).to(grid.dtype)
        else:
            val = grid.allocate(v.dims, v.default)
        auxiliary[v.name] = arrays[v.name] = val
    return State(prognostic, tendencies, auxiliary, inputs, clock)


def reset_tendencies(state: State) -> None:
    """Zero every tendency (reference `state_variables.jl:127-136`)."""
    for k, v in state.tendencies.items():
        state.tendencies[k] = torch.zeros_like(v)
