"""Named boundary-condition builders (counterpart of
``terrarium_tpu/models/boundary_conditions.py``): the soil model's top and
bottom conditions and the LandModel's surface coupling. Each returns a BC
dict that ``merge_boundary_conditions`` combines. ``Simulation.run`` steps
every BC but a lone ``PrescribedSurfaceTemperature`` through the process
modules, not the column kernels."""
from __future__ import annotations

from ..ops.bcs import Dirichlet, Flux, Neumann, NoFlux

__all__ = ["PrescribedSurfaceTemperature", "PrescribedBottomTemperature", "GroundHeatFlux",
           "GeothermalHeatFlux", "InfiltrationFlux", "ImpermeableBoundary", "FreeDrainage"]


def PrescribedSurfaceTemperature(value):
    """Value BC on top `temperature` [degC] (reference `soil_model_bcs.jl:17`):
    a scalar, a ``(cells,)`` tensor, the name of an input variable (fed by
    an input source) or a callable ``f(t)`` on a torch time tensor."""
    return {"temperature": {"top": Dirichlet(value)}}


def PrescribedBottomTemperature(value):
    """Value BC on bottom `temperature` [degC] (reference `soil_model_bcs.jl:22`)."""
    return {"temperature": {"bottom": Dirichlet(value)}}


def GroundHeatFlux(value="ground_heat_flux"):
    """Flux BC on top `internal_energy` (reference `soil_model_bcs.jl:6`)."""
    return {"internal_energy": {"top": Flux(value)}}


def GeothermalHeatFlux(value="geothermal_heat_flux"):
    """Flux BC on bottom `internal_energy` [W/m^2, positive up] (reference
    `soil_model_bcs.jl:12`)."""
    return {"internal_energy": {"bottom": Flux(value)}}


def InfiltrationFlux(value="infiltration"):
    """Flux BC on top `saturation_water_ice` (reference `soil_model_bcs.jl:29`)."""
    return {"saturation_water_ice": {"top": Flux(value)}}


def ImpermeableBoundary():
    """No-flux bottom BC for water (reference `soil_model_bcs.jl:34`)."""
    return {"saturation_water_ice": {"bottom": NoFlux()}}


def FreeDrainage():
    """Zero pressure-head gradient at the bottom (reference `soil_model_bcs.jl:40`)."""
    return {"pressure_head": {"bottom": Neumann(0.0)}}
