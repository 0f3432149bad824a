"""Degree-day snowpack with its albedo feedback (counterpart of
``terrarium_tpu/processes/snow.py``).

The JAX package's extension beyond the reference, which has snow only in
its degree-day tutorial (`examples/extending/simple_snow_ddm.jl`):

* the prognostic ``snow_water_equivalent`` (SWE, m) gathers the
  ``snowfall`` input and loses the degree-day melt ``k_dd * max(T_air -
  T_melt, 0)`` while SWE > 0, and is clipped at 0 after each explicit
  update (the ``timestep`` hook);
* the melt flux ``snow_melt`` joins the ground rain in
  ``DirectSurfaceRunoff``'s partition into infiltration and runoff;
* ``snow_cover_fraction`` = SWE / (SWE + swe_half) blends the SEB's albedo
  and emissivity through :class:`SnowCoverAlbedo`, which the LandModel
  installs over a default ``ConstantAlbedo`` when it has a snowpack.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .surface_energy.seb import ConstantAlbedo
from ..variables import XY, auxiliary, prognostic

__all__ = ["Snowpack", "SnowCoverAlbedo"]


@dataclasses.dataclass(frozen=True)
class SnowCoverAlbedo:
    """Albedo and emissivity blended by the snow cover fraction f:
    ``f * albedo_snow + (1 - f) * base`` (`snow.py:46-63`)."""

    base: Any = ConstantAlbedo()
    albedo_snow: float = 0.8
    emissivity_snow: float = 0.99

    def variables(self):
        return tuple(self.base.variables())

    def albedo(self, state):
        f = state.snow_cover_fraction
        return f * self.albedo_snow + (1.0 - f) * self.base.albedo(state)

    def emissivity(self, state):
        f = state.snow_cover_fraction
        return f * self.emissivity_snow + (1.0 - f) * self.base.emissivity(state)


@dataclasses.dataclass(frozen=True)
class Snowpack:
    """Degree-day snowpack (`snow.py:66-110`; see the module docstring)."""

    #: degree-day melt factor [m/(K s)] (0.005 m/K/day)
    degree_day_factor: float = 5.0e-3 / 86400.0
    #: melt threshold air temperature [degC]
    T_melt: float = 0.0
    #: SWE at 50% snow cover [m]
    swe_half: float = 0.01

    def variables(self):
        return (
            prognostic("snow_water_equivalent", XY(), units="m", domain=(0.0, float("inf")),
                       desc="Snow water equivalent of the snowpack"),
            auxiliary("snow_cover_fraction", XY(), domain=(0.0, 1.0),
                      desc="Fractional snow cover of the surface"),
            auxiliary("snow_melt", XY(), units="m/s",
                      desc="Melt water flux released by the snowpack"),
        )

    def compute_auxiliary(self, state, grid, atmos, ctx) -> None:
        """The cover fraction and the melt flux from the current SWE, before
        the surface hydrology and the SEB read them."""
        swe = torch.clamp(state.snow_water_equivalent, min=0.0)
        f = swe / (swe + self.swe_half)
        Ta = atmos.air_temperature(state)
        melt = torch.where(swe > 0.0,
                           self.degree_day_factor * torch.clamp(Ta - self.T_melt, min=0.0),
                           0.0)
        state.set(snow_cover_fraction=f, snow_melt=melt)

    def compute_tendencies(self, state, grid, atmos, ctx) -> None:
        """dSWE/dt += snowfall - melt."""
        state.add_tendencies(snow_water_equivalent=atmos.snowfall(state) - state.snow_melt)

    def timestep(self, state, grid, atmos, ctx, dt) -> None:
        """The post-step clip SWE >= 0."""
        state.set(snow_water_equivalent=torch.clamp(state.snow_water_equivalent, min=0.0))
