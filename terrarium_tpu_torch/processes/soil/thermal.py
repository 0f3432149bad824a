"""Soil thermal properties and the free-water freeze curve (counterpart of
``terrarium_tpu/processes/soil/thermal.py``)."""
from __future__ import annotations

import dataclasses
import math

import torch

from .stratigraphy import SoilVolume, volumetric_fractions
from ...utils.utils import safediv

__all__ = ["SoilThermalConductivities", "SoilHeatCapacities", "InverseQuadratic",
           "SoilThermalProperties", "FreeWater"]

#: constituent order of the conductivity and heat-capacity mixtures
CONSTITUENTS = ("water", "ice", "air", "mineral", "organic")


@dataclasses.dataclass(frozen=True)
class SoilThermalConductivities:
    """Constituent thermal conductivities [W/m/K] (reference
    `soil_thermal_properties.jl:14-25`)."""

    water: float = 0.57
    ice: float = 2.2
    air: float = 0.025
    mineral: float = 3.8
    organic: float = 0.25


@dataclasses.dataclass(frozen=True)
class SoilHeatCapacities:
    """Constituent volumetric heat capacities [J/m^3/K] (reference
    `soil_thermal_properties.jl:35-46`)."""

    water: float = 4.2e6
    ice: float = 1.9e6
    air: float = 0.00125e6
    mineral: float = 2.0e6
    organic: float = 2.5e6


@dataclasses.dataclass(frozen=True)
class InverseQuadratic:
    """Bulk conductivity ``(sum_i theta_i sqrt(k_i))^2`` (reference
    `soil_thermal_properties.jl:110-123`)."""

    def __call__(self, ks: dict, fracs: dict):
        acc = 0.0
        for name in CONSTITUENTS:
            acc = acc + math.sqrt(ks[name]) * fracs[name]
        return acc * acc


@dataclasses.dataclass(frozen=True)
class FreeWater:
    """Free-water freeze curve: all phase change at 0 degC (reference
    `soil_energy_closures.jl:131-159`). Branches are selected with
    `torch.where`, since IEEE gives ``0 * inf = nan`` where Julia's Bool
    product gives 0."""

    def liquid_water_fraction(self, U, L_theta):
        """1 for U >= 0; 1 - U / (-L_theta) on the plateau; 0 below it."""
        phase = torch.where(U >= -L_theta, 1.0 - safediv(U, -L_theta), 0.0)
        return torch.where(U >= 0.0, 1.0, phase)

    def temperature(self, U, L_theta, C):
        """(U + L_theta)/C below the plateau, U/C above it, 0 on it."""
        frozen = (U + L_theta) / C
        thawed = U / C
        return torch.where(U < -L_theta, frozen, torch.where(U >= 0.0, thawed, 0.0))


@dataclasses.dataclass(frozen=True)
class SoilThermalProperties:
    """Constituent properties, bulk weighting and freeze curve (reference
    `soil_thermal_properties.jl:58-78`)."""

    conductivities: SoilThermalConductivities = SoilThermalConductivities()
    bulk_conductivity: InverseQuadratic = InverseQuadratic()
    heat_capacities: SoilHeatCapacities = SoilHeatCapacities()
    freezecurve: FreeWater = FreeWater()

    def thermal_conductivity(self, soil: SoilVolume):
        return self.bulk_conductivity(dataclasses.asdict(self.conductivities),
                                      volumetric_fractions(soil))

    def heat_capacity(self, soil: SoilVolume):
        """Linear mixture of the constituent heat capacities."""
        fracs = volumetric_fractions(soil)
        cs = dataclasses.asdict(self.heat_capacities)
        acc = 0.0
        for name in CONSTITUENTS:
            acc = acc + cs[name] * fracs[name]
        return acc
