"""Standalone vegetation and surface-energy models (counterpart of
``terrarium_tpu/models/vegetation_model.py``; reference
`src/models/vegetation/vegetation_model.jl` and
`src/models/surface/surface_energy_model.jl`).

Neither has a column kernel: ``Simulation.run`` steps both through the
process modules, as the JAX package's ``run`` does without
``fused_inner_steps``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from .initializers import DefaultInitializer
from ..constants import PhysicalConstants
from ..processes.atmosphere import PrescribedAtmosphere
from ..processes.base import Context
from ..processes.surface_energy.seb import SurfaceEnergyBalance
from ..processes.vegetation.vegetation import VegetationCarbon
from ..variables import Variables, variables_of

__all__ = ["VegetationModel", "SurfaceEnergyModel"]


@dataclasses.dataclass(frozen=True)
class VegetationModel:
    """Single-PFT vegetation under a prescribed atmosphere (reference
    `vegetation_model.jl:11-50`). Without a soil the plant-available water
    and the roots are off, and the ``soil_moisture_limiting_factor`` input
    keeps its default of 1 (reference `plant_available_water.jl:64-66`)."""

    grid: Any
    atmosphere: PrescribedAtmosphere = PrescribedAtmosphere()
    vegetation: VegetationCarbon = dataclasses.field(
        default_factory=lambda: VegetationCarbon(plant_available_water=None,
                                                 root_distribution=None))
    constants: PhysicalConstants = PhysicalConstants()
    initializer: Any = DefaultInitializer()

    def variables(self) -> tuple:
        return variables_of(self.atmosphere) + variables_of(self.vegetation)

    def collated_variables(self) -> Variables:
        return Variables.of(self)

    def make_context(self, bcs=None) -> Context:
        return Context(constants=self.constants, bcs=bcs)

    def initialize(self, state, ctx) -> None:
        self.initializer.initialize(state, self)
        self.vegetation.initialize(state, self.grid, self.constants, self.atmosphere, ctx)
        self.compute_auxiliary(state, ctx)

    def compute_auxiliary(self, state, ctx) -> None:
        self.vegetation.compute_auxiliary(state, self.grid, self.constants, self.atmosphere,
                                          None, ctx)

    def compute_tendencies(self, state, ctx) -> None:
        self.vegetation.compute_tendencies(state, self.grid, self.constants, ctx)

    def closure(self, state, ctx) -> None:
        pass

    def invclosure(self, state, ctx) -> None:
        pass

    def timestep(self, state, ctx, dt) -> None:
        pass


@dataclasses.dataclass(frozen=True)
class SurfaceEnergyModel:
    """The SEB under a prescribed atmosphere, mainly for tests (reference
    `surface_energy_model.jl:10-53`)."""

    grid: Any
    atmosphere: PrescribedAtmosphere = PrescribedAtmosphere()
    surface_energy_balance: SurfaceEnergyBalance = SurfaceEnergyBalance()
    constants: PhysicalConstants = PhysicalConstants()
    initializer: Any = DefaultInitializer()

    def variables(self) -> tuple:
        return variables_of(self.atmosphere) + variables_of(self.surface_energy_balance)

    def collated_variables(self) -> Variables:
        return Variables.of(self)

    def make_context(self, bcs=None) -> Context:
        return Context(constants=self.constants, bcs=bcs)

    def initialize(self, state, ctx) -> None:
        self.initializer.initialize(state, self)
        self.compute_auxiliary(state, ctx)

    def compute_auxiliary(self, state, ctx) -> None:
        self.surface_energy_balance.compute_auxiliary(state, self.grid, self.constants,
                                                      self.atmosphere, None, ctx)

    def compute_tendencies(self, state, ctx) -> None:
        pass

    def closure(self, state, ctx) -> None:
        pass

    def invclosure(self, state, ctx) -> None:
        pass

    def timestep(self, state, ctx, dt) -> None:
        pass
