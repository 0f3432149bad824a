"""Soil stratigraphy: texture, porosity, carbon, elementary soil volume
(counterpart of ``terrarium_tpu/processes/soil/stratigraphy.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

__all__ = ["SoilTexture", "ConstantSoilPorosity", "ConstantSoilCarbonDensity",
           "SoilVolume", "volumetric_fractions", "HomogeneousStratigraphy"]


#: (sand, silt, clay) of the named textures (reference `soil_texture.jl:43-54`)
_TEXTURE_PRESETS = {
    "sand": (1.0, 0.0, 0.0), "silt": (0.0, 1.0, 0.0), "clay": (0.0, 0.0, 1.0),
    "sandyclay": (0.5, 0.0, 0.5), "siltyclay": (0.0, 0.5, 0.5), "loam": (0.4, 0.4, 0.2),
    "sandyloam": (0.8, 0.1, 0.1), "siltyloam": (0.1, 0.8, 0.1), "clayloam": (0.3, 0.3, 0.4),
}


@dataclasses.dataclass(frozen=True)
class SoilTexture:
    """Sand/silt/clay mass fractions (reference `soil_texture.jl:6-28`)."""

    sand: float = 1.0
    clay: float = 0.0
    silt: Optional[float] = None  # default: 1 - sand - clay

    def __post_init__(self):
        if self.silt is None:
            object.__setattr__(self, "silt", 1.0 - self.sand - self.clay)
        if abs(self.sand + self.silt + self.clay - 1.0) > 1e-8:
            raise ValueError("sand, silt, and clay fractions must sum to unity")

    @staticmethod
    def preset(name: str) -> "SoilTexture":
        sand, silt, clay = _TEXTURE_PRESETS[name]
        return SoilTexture(sand=sand, clay=clay, silt=silt)


@dataclasses.dataclass(frozen=True)
class ConstantSoilPorosity:
    """Constant mineral and organic porosity (reference `soil_porosity.jl:7-20`)."""

    mineral_porosity: float = 0.49
    organic_porosity: float = 0.9


@dataclasses.dataclass(frozen=True)
class ConstantSoilCarbonDensity:
    """Constant soil-organic-carbon density
    (reference `biogeochem/constant_soil_carbon.jl:10-34`)."""

    rho_soc: float = 0.0  # SOC density [kg/m^3]
    rho_org: float = 1300.0  # pure organic matter density [kg/m^3]


class SoilVolume(NamedTuple):
    """Composition of an elementary soil volume (reference `soil_volume.jl:11-31`);
    fields are Python floats or tensors that broadcast together."""

    porosity: Any = 0.5
    saturation: Any = 1.0
    liquid: Any = 1.0
    organic: Any = 0.0


def volumetric_fractions(soil: SoilVolume) -> dict:
    """Volumetric fractions of water, ice, air, organic and mineral matter
    (reference `soil_volume.jl:52-67`, `:103-107`)."""
    por, sat, liq = soil.porosity, soil.saturation, soil.liquid
    water_ice = sat * por
    solid = 1.0 - por
    return dict(water=water_ice * liq, ice=water_ice * (1.0 - liq),
                air=(1.0 - sat) * por, organic=solid * soil.organic,
                mineral=solid * (1.0 - soil.organic))


@dataclasses.dataclass(frozen=True)
class HomogeneousStratigraphy:
    """Well-mixed stratigraphy (reference `homogeneous_strat.jl`). With
    constant porosity and carbon density its porosity and organic fraction
    are Python floats."""

    texture: SoilTexture = SoilTexture()
    porosity: ConstantSoilPorosity = ConstantSoilPorosity()

    def organic_fraction(self, bgc: ConstantSoilCarbonDensity) -> float:
        """rho_soc / ((1 - por_o) * rho_org) (reference `homogeneous_strat.jl:34-44`)."""
        return bgc.rho_soc / ((1.0 - self.porosity.organic_porosity) * bgc.rho_org)

    def bulk_porosity(self, bgc: ConstantSoilCarbonDensity) -> float:
        """(1 - organic) * por_mineral + organic * por_organic
        (reference `homogeneous_strat.jl:51-61`)."""
        organic = self.organic_fraction(bgc)
        return ((1.0 - organic) * self.porosity.mineral_porosity
                + organic * self.porosity.organic_porosity)

    def soil_volume(self, bgc, state, saturation=None, liquid=None) -> SoilVolume:
        """The :class:`SoilVolume` of the current state (reference
        `homogeneous_strat.jl:69-98`)."""
        sat = saturation if saturation is not None else state.saturation_water_ice
        liq = liquid if liquid is not None else state.liquid_water_fraction
        return SoilVolume(porosity=self.bulk_porosity(bgc), saturation=sat,
                          liquid=liq, organic=self.organic_fraction(bgc))
