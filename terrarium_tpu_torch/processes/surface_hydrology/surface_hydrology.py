"""Surface hydrology: canopy interception, evapotranspiration and runoff
(counterpart of ``terrarium_tpu/processes/surface_hydrology/surface_hydrology.py``),
on ``(cells,)`` tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..soil.stratigraphy import volumetric_fractions
from ...variables import XY, auxiliary, input as input_var, prognostic

__all__ = ["NoCanopyInterception", "PALADYNCanopyInterception",
           "ConstantEvaporationResistanceFactor", "SoilMoistureResistanceFactor",
           "BareGroundEvaporation", "PALADYNCanopyEvapotranspiration", "DirectSurfaceRunoff",
           "SurfaceHydrology", "CONSISTENT_WATER_FLUX_SCALE"]

#: rho_a / rho_w: the specific-humidity flux [kg/kg m/s] as a water flux [m/s]
CONSISTENT_WATER_FLUX_SCALE = 1.293e-3


@dataclasses.dataclass(frozen=True)
class NoCanopyInterception:
    """All rainfall reaches the ground (reference `canopy_interception.jl:7-23`)."""

    def variables(self):
        return (auxiliary("rainfall_ground", XY(), units="m/s",
                          desc="Rainfall rate reaching the ground"),)

    def compute_auxiliary(self, state, grid, atmos, ctx) -> None:
        state.set(rainfall_ground=atmos.rainfall(state))

    def compute_tendencies(self, state, grid, evtr, ctx) -> None:
        pass

    def saturation_canopy_water(self, state):
        return 0.0


@dataclasses.dataclass(frozen=True)
class PALADYNCanopyInterception:
    """PALADYN canopy interception and storage, liquid only (Willeit &
    Ganopolski 2016 Eq. 41-44; reference `canopy_interception.jl:40-221`).
    The saturated fraction is clamped to [0, 1] as in the JAX package
    (`surface_hydrology.py:95-100`)."""

    alpha_int: float = 0.2  # interception factor
    k_ext: float = 0.5  # radiation extinction coefficient
    w_can_max: float = 2.0e-4  # interception capacity parameter [m]
    tau_w: float = 86400.0  # removal timescale [s]

    def variables(self):
        return (
            prognostic("canopy_water", XY(), units="m", desc="Canopy liquid water"),
            auxiliary("canopy_water_interception", XY(), units="m/s",
                      desc="Canopy rain interception rate"),
            auxiliary("canopy_water_removal", XY(), units="m/s",
                      desc="Canopy water removal rate"),
            auxiliary("saturation_canopy_water", XY(),
                      desc="Fraction of the canopy saturated with water"),
            auxiliary("rainfall_ground", XY(), units="m/s",
                      desc="Rainfall rate reaching the ground"),
            input_var("leaf_area_index", XY(), units="m^2/m^2", desc="Leaf Area Index"),
            input_var("SAI", XY(), units="m^2/m^2", desc="Stem Area Index"),
        )

    def saturation_canopy_water(self, state):
        return state.saturation_canopy_water

    def compute_auxiliary(self, state, grid, atmos, ctx) -> None:
        """I = alpha P (1 - e^(-k (LAI + SAI))); R = max(w, 0) / tau_w;
        f = clamp(w / (w_max (LAI + SAI)), 0, 1); ground rain P - I + R
        (reference `canopy_interception.jl:105-170, 262-300`)."""
        rain = atmos.rainfall(state)
        LAI, SAI, w = state.leaf_area_index, state.SAI, state.canopy_water
        w_max = self.w_can_max * (LAI + SAI)
        f_can = torch.where(w_max > 0.0,
                            torch.clamp(w / torch.clamp(w_max, min=1e-30), 0.0, 1.0), 0.0)
        I_can = self.alpha_int * rain * (1.0 - torch.exp(-self.k_ext * (LAI + SAI)))
        R_can = torch.clamp(w, min=0.0) / self.tau_w
        state.set(canopy_water_interception=I_can, canopy_water_removal=R_can,
                  saturation_canopy_water=f_can, rainfall_ground=rain - I_can + R_can)

    def compute_tendencies(self, state, grid, evtr, ctx) -> None:
        """dw/dt = I - E_can * scale - R (reference
        `canopy_interception.jl:176-186, 303-320`)."""
        E_can = state.evaporation_canopy if "evaporation_canopy" in state \
            else torch.zeros_like(state.canopy_water)
        scale = getattr(evtr, "water_flux_scale", 1.0)
        state.add_tendencies(canopy_water=state.canopy_water_interception - E_can * scale
                             - state.canopy_water_removal)


@dataclasses.dataclass(frozen=True)
class ConstantEvaporationResistanceFactor:
    """Constant beta (reference `ground_resistance_factor.jl:8-17`)."""

    factor: float = 1.0

    def __call__(self, state, grid, soil):
        return self.factor


@dataclasses.dataclass(frozen=True)
class SoilMoistureResistanceFactor:
    """Lee & Pielke (1992): beta = (1 - cos(pi theta_1 / theta_fc))^2 / 4 below
    field capacity, else 1, on the top layer's water (reference
    `ground_resistance_factor.jl:26-57`)."""

    def __call__(self, state, grid, soil):
        if soil is None:
            return 1.0
        theta_w = volumetric_fractions(soil.strat.soil_volume(soil.biogeochem, state))["water"][-1]
        fc = soil.hydrology.hydraulic_properties.field_capacity(soil.strat.texture)
        c = 1.0 - torch.cos(math.pi * theta_w / fc)
        return torch.where(theta_w < fc, c * c / 4.0, 1.0)


@dataclasses.dataclass(frozen=True)
class BareGroundEvaporation:
    """E = beta dq / r_a (reference `bare_ground_evaporation.jl:1-62`).

    ``water_flux_scale`` multiplies the humidity flux where it leaves the
    soil as water: 1 is the reference, which takes the specific-humidity
    flux as a water volume flux; ``consistent_units()`` takes rho_a / rho_w,
    so that the water sink matches the latent heat flux."""

    ground_resistance: Any = ConstantEvaporationResistanceFactor()
    water_flux_scale: float = 1.0

    @staticmethod
    def consistent_units(**kw) -> "BareGroundEvaporation":
        return BareGroundEvaporation(water_flux_scale=CONSISTENT_WATER_FLUX_SCALE, **kw)

    def variables(self):
        return (auxiliary("evaporation_ground", XY(), units="m/s",
                          desc="Ground evaporation contribution to humidity flux"),
                input_var("skin_temperature", XY(), units="degC",
                          desc="Skin temperature of the surface"))

    def surface_humidity_flux(self, state):
        return state.evaporation_ground

    def compute_auxiliary(self, state, grid, canopy, constants, atmos, soil, vegetation,
                          ctx) -> None:
        r_a = atmos.aerodynamic_resistance(state, constants)
        beta = self.ground_resistance(state, grid, soil)
        dq = atmos.humidity_vpd(state, constants, state.skin_temperature)
        state.set(evaporation_ground=beta * dq / r_a)

    def soil_moisture_sink(self, state, grid, constants):
        """-Q_h * scale, the top layer's water sink before the division by
        dz (reference `evapotranspiration_base.jl:9-15`)."""
        return -self.surface_humidity_flux(state) * self.water_flux_scale


@dataclasses.dataclass(frozen=True)
class PALADYNCanopyEvapotranspiration:
    """PALADYN evapotranspiration (Willeit & Ganopolski 2016 Eq. 5; reference
    `canopy_evapotranspiration.jl:51-177`): transpiration dq_s / (r_a +
    1/g_can), ground evaporation beta dq_g / (r_a + r_e) with r_e = (1 -
    e^(-LAI - SAI)) / (C_can V), canopy evaporation f_can dq_s / r_a; g_can
    floored at the dtype's sqrt(eps). ``water_flux_scale`` as in
    :class:`BareGroundEvaporation`."""

    C_can: float = 0.006
    ground_resistance: Any = ConstantEvaporationResistanceFactor()
    water_flux_scale: float = 1.0

    @staticmethod
    def consistent_units(**kw) -> "PALADYNCanopyEvapotranspiration":
        return PALADYNCanopyEvapotranspiration(water_flux_scale=CONSISTENT_WATER_FLUX_SCALE,
                                               **kw)

    def variables(self):
        return (
            auxiliary("evaporation_canopy", XY(), units="m/s",
                      desc="Canopy evaporation contribution to humidity flux"),
            auxiliary("evaporation_ground", XY(), units="m/s",
                      desc="Ground evaporation contribution to humidity flux"),
            auxiliary("transpiration", XY(), units="m/s",
                      desc="Transpiration contribution to humidity flux"),
            input_var("skin_temperature", XY(), units="degC", desc="Skin temperature"),
            input_var("ground_temperature", XY(), default=1.0, units="degC",
                      desc="Ground surface temperature"),
        )

    def surface_humidity_flux(self, state):
        return state.evaporation_ground + state.evaporation_canopy + state.transpiration

    def canopy_ground_resistance(self, state, atmos):
        """r_e = (1 - e^(-LAI - SAI)) / (C_can V) (reference
        `canopy_evapotranspiration.jl:159-177`)."""
        return (1.0 - torch.exp(-state.leaf_area_index - state.SAI)) \
            / (self.C_can * atmos.windspeed(state))

    def compute_auxiliary(self, state, grid, canopy, constants, atmos, soil, vegetation,
                          ctx) -> None:
        dq_s = atmos.humidity_vpd(state, constants, state.skin_temperature)
        dq_g = atmos.humidity_vpd(state, constants, state.ground_temperature)
        r_a = atmos.aerodynamic_resistance(state, constants)
        r_e = self.canopy_ground_resistance(state, atmos)
        f_can = canopy.saturation_canopy_water(state)
        beta = self.ground_resistance(state, grid, soil)
        eps_nf = math.sqrt(torch.finfo(dq_s.dtype).eps)
        r_s = 1.0 / torch.clamp(state.canopy_water_conductance, min=eps_nf)
        state.set(transpiration=dq_s / (r_a + r_s),
                  evaporation_ground=beta * dq_g / (r_a + r_e),
                  evaporation_canopy=f_can * dq_s / r_a)

    def soil_moisture_sink(self, state, grid, constants):
        """The total humidity flux as the top layer's water sink, times the
        scale (reference `evapotranspiration_base.jl:9-15`)."""
        return -self.surface_humidity_flux(state) * self.water_flux_scale


@dataclasses.dataclass(frozen=True)
class DirectSurfaceRunoff:
    """Runoff = P + drainage - infiltration (reference
    `direct_surface_runoff.jl:14-117`).

    ``consistent_drainage``: the reference's pool tendency is ``+min(S/tau,
    S)`` (`soil_hydrology.jl:274-283`), so the pool grows by its own
    drainage while the infiltration adds it to the soil again; the
    consistent mode applies it with the removal sign."""

    tau_r: float = 3600.0  # surface water removal timescale [s]
    consistent_drainage: bool = False

    @staticmethod
    def consistent(**kw) -> "DirectSurfaceRunoff":
        return DirectSurfaceRunoff(consistent_drainage=True, **kw)

    def variables(self):
        return (auxiliary("surface_runoff", XY(), units="m/s", desc="Total surface runoff"),
                auxiliary("infiltration", XY(), units="m/s", desc="Infiltration flux"))

    def surface_drainage(self, S):
        """max(S, 0) / tau_r (reference `direct_surface_runoff.jl:27-37`)."""
        return torch.clamp(S, min=0.0) / self.tau_r

    def compute_auxiliary(self, state, grid, canopy, soil, ctx) -> None:
        rain = state.rainfall_ground
        S = state.surface_excess_water if "surface_excess_water" in state \
            else torch.zeros_like(rain)
        k_unsat = state.hydraulic_conductivity[-1]  # the top face
        sat_top = state.saturation_water_ice[-1]
        has_excess = S > 0.0
        drainage = torch.where(has_excess, self.surface_drainage(S), 0.0)
        influx = torch.where(has_excess, drainage, rain)
        infil = torch.where(sat_top < 1.0, torch.minimum(influx, k_unsat), 0.0)
        state.set(infiltration=infil, surface_runoff=rain + drainage - infil)


@dataclasses.dataclass(frozen=True)
class SurfaceHydrology:
    """{interception, evapotranspiration, runoff}, auxiliaries in that order
    (reference `surface_hydrology.jl:10-60`)."""

    canopy_interception: Any = dataclasses.field(default_factory=PALADYNCanopyInterception)
    evapotranspiration: Any = dataclasses.field(default_factory=PALADYNCanopyEvapotranspiration)
    surface_runoff: Any = dataclasses.field(default_factory=DirectSurfaceRunoff)

    @staticmethod
    def bare_ground() -> "SurfaceHydrology":
        """No canopy and bare-ground evaporation, the LandModel's default
        without vegetation (reference `land_model.jl:119-125`)."""
        return SurfaceHydrology(canopy_interception=NoCanopyInterception(),
                                evapotranspiration=BareGroundEvaporation())

    def variables(self):
        return (tuple(self.canopy_interception.variables())
                + tuple(self.evapotranspiration.variables())
                + tuple(self.surface_runoff.variables()))

    def compute_auxiliary(self, state, grid, constants, atmos, soil=None, vegetation=None,
                          ctx=None) -> None:
        self.canopy_interception.compute_auxiliary(state, grid, atmos, ctx)
        self.evapotranspiration.compute_auxiliary(state, grid, self.canopy_interception,
                                                  constants, atmos, soil, vegetation, ctx)
        self.surface_runoff.compute_auxiliary(state, grid, self.canopy_interception, soil, ctx)

    def compute_tendencies(self, state, grid, ctx=None) -> None:
        self.canopy_interception.compute_tendencies(state, grid, self.evapotranspiration, ctx)
