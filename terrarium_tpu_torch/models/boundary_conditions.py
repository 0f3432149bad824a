"""Named boundary-condition builders for soil models (counterpart of
``terrarium_tpu/models/boundary_conditions.py``; the main path's builder)."""
from __future__ import annotations

from ..ops.bcs import Dirichlet

__all__ = ["PrescribedSurfaceTemperature"]


def PrescribedSurfaceTemperature(value):
    """Value BC on top `temperature` [degC] (reference `soil_model_bcs.jl:17`):
    a scalar, a ``(cells,)`` tensor, the name of an input variable (fed by
    an input source) or a callable ``f(t)`` on a torch time tensor."""
    return {"temperature": {"top": Dirichlet(value)}}
