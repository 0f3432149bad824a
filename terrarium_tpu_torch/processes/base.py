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
    """Dependencies shared by the process hooks: constants and the BCs."""

    constants: PhysicalConstants = PhysicalConstants()
    bcs: Any = None  # {var_name: {"top": bc, "bottom": bc}}
