"""Symbolic state-variable declarations (counterpart of
``terrarium_tpu/variables.py``).

Processes declare their state as :class:`Variable` specs; :class:`Variables`
collates them, adds a tendency slot per prognostic variable, attaches closure
variables, and :func:`~terrarium_tpu_torch.state.build_state` allocates them.

Layout: ``XYZ`` centre variables are ``(Nz, cells)``, ``XYZ(face=True)``
variables ``(Nz + 1, cells)`` and ``XY`` variables ``(cells,)``; ``k = 0`` is
the bottom layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

from .utils.utils import deduplicate

__all__ = ["XY", "XYZ", "Variable", "Variables", "prognostic", "auxiliary",
           "input", "variables_of"]


@dataclasses.dataclass(frozen=True)
class XYZ:
    """Cell-centred (or z-face) 3D variable."""

    face: bool = False


@dataclasses.dataclass(frozen=True)
class XY:
    """Lateral-only variable (one value per column)."""


@dataclasses.dataclass(frozen=True)
class Variable:
    """Declaration of a state variable (reference `abstract_variables.jl:137-218`).

    ``kind`` is ``"prognostic"``, ``"auxiliary"``, ``"input"`` or
    ``"tendency"``; ``closure`` is the closure relation attached to a
    prognostic variable; ``ctor(grid, arrays)`` builds a derived auxiliary
    from previously allocated fields."""

    name: str
    dims: Any
    kind: str
    units: str = ""
    desc: str = ""
    default: float = 0.0
    domain: Optional[Tuple[float, float]] = None
    closure: Any = None
    ctor: Optional[Callable] = None

    def key(self):
        return (self.name, self.dims, self.units)


def prognostic(name, dims, *, units="", desc="", default=0.0, domain=None, closure=None):
    return Variable(name, dims, "prognostic", units=units, desc=desc, default=default,
                    domain=domain, closure=closure)


def auxiliary(name, dims, ctor=None, *, units="", desc="", default=0.0, domain=None):
    return Variable(name, dims, "auxiliary", units=units, desc=desc, default=default,
                    domain=domain, ctor=ctor)


def input(name, dims, *, units="", desc="", default=0.0, domain=None):
    return Variable(name, dims, "input", units=units, desc=desc, default=default,
                    domain=domain)


class Variables:
    """Collated, deduplicated variable groups with the merge rules of the
    reference `Variables` constructor (`abstract_variables.jl:253-288`):

    * duplicates within a group merge, first occurrence wins;
    * every prognostic variable gets a tendency slot;
    * closure variables of prognostic variables are prepended to the
      auxiliaries;
    * inputs whose names are taken by a prognostic or auxiliary are dropped
      (so ``liquid_water_fraction``, declared as a hydrology input and as an
      energy-closure auxiliary, ends up auxiliary);
    * any other cross-group duplicate is an error.
    """

    def __init__(self, vars: Sequence[Variable]):
        prog, aux, inp = [], [], []
        for v in vars:
            if v.kind == "prognostic":
                prog.append(v)
            elif v.kind == "auxiliary":
                aux.append(v)
            elif v.kind == "input":
                inp.append(v)
            else:
                raise ValueError(f"unexpected variable kind {v.kind!r} for {v.name!r}")

        prog = deduplicate(prog, key=lambda v: v.name)
        aux = deduplicate(aux, key=lambda v: v.name)
        inp = deduplicate(inp, key=lambda v: v.name)

        closure_vars = []
        for v in prog:
            if v.closure is not None:
                closure_vars.extend(variables_of(v.closure))
        aux = deduplicate(closure_vars + aux, key=Variable.key)

        taken = {v.name for v in prog} | {v.name for v in aux}
        inp = [v for v in inp if v.name not in taken]

        names = [v.name for v in prog + aux + inp]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate variable declarations: {sorted(dupes)}")

        self.prognostic = {v.name: v for v in prog}
        self.auxiliary = {v.name: v for v in aux}
        self.inputs = {v.name: v for v in inp}
        self.tendencies = {
            v.name: Variable(v.name, v.dims, "tendency", units=v.units + "/s")
            for v in prog
        }

    @staticmethod
    def of(*objs) -> "Variables":
        flat: list = []
        for obj in objs:
            flat.extend(variables_of(obj))
        return Variables(flat)

    def __repr__(self):
        return (f"Variables(prognostic={list(self.prognostic)}, "
                f"auxiliary={list(self.auxiliary)}, inputs={list(self.inputs)})")


def variables_of(obj) -> Tuple[Variable, ...]:
    """The declarations of a Variable, a sequence, or any object with a
    ``variables()`` method."""
    if obj is None:
        return ()
    if isinstance(obj, Variable):
        return (obj,)
    if isinstance(obj, (tuple, list)):
        out: list = []
        for o in obj:
            out.extend(variables_of(o))
        return tuple(out)
    if hasattr(obj, "variables"):
        return tuple(variables_of(obj.variables()))
    raise TypeError(f"cannot extract variables from {obj!r}")
