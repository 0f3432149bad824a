"""Process context (counterpart of ``terrarium_tpu/processes/base.py``).

A process is a frozen dataclass of parameters with hooks ``initialize``,
``compute_auxiliary``, ``compute_tendencies``, ``closure`` and
``invclosure``. Each hook takes ``(state, grid, ...)`` and updates the state
in place (see :mod:`terrarium_tpu_torch.state`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..constants import PhysicalConstants

__all__ = ["Context"]


@dataclasses.dataclass(frozen=True)
class Context:
    """Dependencies shared by the process hooks: constants, the BCs, a
    model's sibling processes (``extras``: the LandModel hands the soil its
    evapotranspiration and runoff schemes) and the user's ``forcings``
    (reference `src/forcings.jl:13-19`): ``{prognostic name: fn(state,
    grid)}``, each value added to that tendency in every ``update_state``
    (``timesteppers/stepping.apply_forcings``)."""

    constants: PhysicalConstants = PhysicalConstants()
    bcs: Any = None  # {var_name: {"top": bc, "bottom": bc}}
    extras: Any = None
    forcings: Any = None

    def with_bcs(self, bcs) -> "Context":
        return dataclasses.replace(self, bcs=bcs)

    def with_forcings(self, forcings) -> "Context":
        return dataclasses.replace(self, forcings=forcings)
