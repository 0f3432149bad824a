"""Field initializers (counterpart of ``terrarium_tpu/models/initializers.py``)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["DefaultInitializer", "apply_field_initializers"]


def _eval_field_init(spec, grid, shape):
    """A scalar, an array, or a callable ``f(x, z)`` (XYZ fields) / ``f(x)``
    (XY fields) evaluated with numpy in float64, where ``x`` is the column
    coordinate in [0, 1) and ``z`` the cell-centre elevation; the result is
    cast to the grid dtype and broadcast to ``shape``."""
    if callable(spec):
        x = (np.arange(grid.cells) + 0.5) / grid.cells
        if len(shape) == 2:
            spec = spec(x[None, :], grid.vertical.z_centers[:, None])
        else:
            spec = spec(x)
    val = torch.as_tensor(np.asarray(spec, dtype=np.float64), device=grid.device)
    return torch.broadcast_to(val.to(grid.dtype), shape).clone()


def apply_field_initializers(state, grid, inits: dict) -> None:
    """Set each named field from its spec (reference `initializers.jl:23-27`)."""
    for name, spec in (inits or {}).items():
        cur = state[name]
        state.set(**{name: _eval_field_init(spec, grid, tuple(cur.shape)).to(cur.dtype)})


@dataclasses.dataclass(frozen=True)
class DefaultInitializer:
    """No-op model initializer (reference `initializers.jl:36-40`)."""

    def initialize(self, state, model) -> None:
        pass
