"""Named boundary-condition builders (counterpart of
``terrarium_tpu/models/boundary_conditions.py``): the soil model's top
temperature and the LandModel's surface coupling."""
from __future__ import annotations

from ..ops.bcs import Dirichlet, Flux

__all__ = ["PrescribedSurfaceTemperature", "GroundHeatFlux", "InfiltrationFlux"]


def PrescribedSurfaceTemperature(value):
    """Value BC on top `temperature` [degC] (reference `soil_model_bcs.jl:17`):
    a scalar, a ``(cells,)`` tensor, the name of an input variable (fed by
    an input source) or a callable ``f(t)`` on a torch time tensor."""
    return {"temperature": {"top": Dirichlet(value)}}


def GroundHeatFlux(value="ground_heat_flux"):
    """Flux BC on top `internal_energy` (reference `soil_model_bcs.jl:6`)."""
    return {"internal_energy": {"top": Flux(value)}}


def InfiltrationFlux(value="infiltration"):
    """Flux BC on top `saturation_water_ice` (reference `soil_model_bcs.jl:29`)."""
    return {"saturation_water_ice": {"top": Flux(value)}}
