"""Vertical boundary conditions (counterpart of ``terrarium_tpu/ops/bcs.py``).

Boundary conditions act inside the vertical operators:

* :class:`Dirichlet` gives the ghost value ``2*value - c_boundary``;
* :class:`Neumann` gives a prescribed gradient at the boundary face;
* :class:`Flux` is added to the boundary cell's tendency in the explicit
  step (fluxes positive in +z);
* no BC means a zero-gradient ghost.

A BC value may be a Python scalar, a ``(cells,)`` tensor, the name of a state
variable, an :class:`InputRef` (a state variable times a constant), or a
callable ``f(t)`` / ``f(t, state)`` that receives the clock time as a torch
tensor.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, Optional

import torch

from ..utils.utils import merge_recursive

__all__ = ["InputRef", "Dirichlet", "Neumann", "Flux", "NoFlux", "get_bc", "resolve_bc_value",
           "merge_boundary_conditions", "bc_call_arity"]


@dataclasses.dataclass(frozen=True)
class InputRef:
    """A state variable times ``scale`` as a BC value: the reference's
    placeholder BCs with a sign flip (the LandModel's ``-infiltration``,
    `land_model.jl:46-66`)."""

    name: str
    scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class Dirichlet:
    """Value boundary condition."""

    value: Any


@dataclasses.dataclass(frozen=True)
class Neumann:
    """Gradient boundary condition."""

    gradient: Any


@dataclasses.dataclass(frozen=True)
class Flux:
    """Flux boundary condition, positive in +z."""

    value: Any


def NoFlux() -> Flux:
    """Zero-flux BC (`ops/bcs.py:73`)."""
    return Flux(0.0)


FieldBCs = Dict[str, Dict[str, Any]]  # {var_name: {"top": bc, "bottom": bc}}


def merge_boundary_conditions(*bcs: FieldBCs) -> FieldBCs:
    """Recursively merge BC dicts; later arguments take precedence."""
    return merge_recursive(*bcs)


def get_bc(bcs: Optional[FieldBCs], var: str, side: str):
    """The BC for ``var`` on ``side`` ('top' or 'bottom'), or None."""
    if not bcs:
        return None
    return bcs.get(var, {}).get(side, None)


def bc_call_arity(fn) -> int:
    """Number of required positional parameters of a BC callable: 1 means
    ``f(t)``, 2 or more ``f(t, state)``. Defaulted, keyword-only and
    ``**kwargs`` parameters do not count."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):  # builtins without a signature
        return 1
    return sum(1 for p in params
               if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
               and p.default is p.empty)


def resolve_bc_value(value, state):
    """Evaluate a BC value against the current state and clock. Returns a
    Python scalar or a tensor that broadcasts against ``(cells,)``."""
    if isinstance(value, str):
        return state[value]
    if isinstance(value, InputRef):
        return value.scale * state[value.name]
    if callable(value):
        if bc_call_arity(value) >= 2:
            return value(state.clock.time, state)
        return value(state.clock.time)
    if isinstance(value, torch.Tensor):
        return value
    return float(value)
