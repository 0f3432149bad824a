"""Coupled soil energy-water-carbon container (counterpart of
``terrarium_tpu/processes/soil/soil_coupled.py``). Hooks run hydrology first,
then energy, in the reference's order (`soil_coupled.jl:45-130`)."""
from __future__ import annotations

import dataclasses

from .energy import SoilEnergyBalance
from .hydrology import SoilHydrology
from .stratigraphy import ConstantSoilCarbonDensity, HomogeneousStratigraphy
from ...variables import variables_of

__all__ = ["SoilEnergyWaterCarbon"]


@dataclasses.dataclass(frozen=True)
class SoilEnergyWaterCarbon:
    """{stratigraphy, energy, hydrology, biogeochem} (reference `soil_coupled.jl:7-35`)."""

    strat: HomogeneousStratigraphy = HomogeneousStratigraphy()
    energy: SoilEnergyBalance = SoilEnergyBalance()
    hydrology: SoilHydrology = SoilHydrology()
    biogeochem: ConstantSoilCarbonDensity = ConstantSoilCarbonDensity()

    def variables(self):
        return variables_of(self.energy) + variables_of(self.hydrology)

    def initialize(self, state, grid, ctx):
        self.hydrology.initialize(state, grid, self, ctx.constants, ctx)
        self.energy.initialize(state, grid, self, ctx.constants, ctx)

    def compute_auxiliary(self, state, grid, ctx):
        self.hydrology.compute_auxiliary(state, grid, self, ctx.constants, ctx)

    def compute_tendencies(self, state, grid, ctx):
        self.hydrology.compute_tendencies(state, grid, self, ctx.constants, ctx)
        self.energy.compute_tendencies(state, grid, self, ctx.constants, ctx)

    def closure(self, state, grid, ctx):
        self.hydrology.closure(state, grid, self, ctx.constants, ctx)
        self.energy.closure(state, grid, self, ctx.constants, ctx)

    def implicit_terms(self, state, grid, ctx):
        """The implicit-diffusion terms of the ImplicitEuler stepper, Richards
        flow (none under NoFlow) first, then heat (`soil_coupled.py:62-72`)."""
        c = ctx.constants
        water = self.hydrology.implicit_diffusion_terms(state, grid, self, c, ctx)
        heat = self.energy.implicit_diffusion_terms(state, grid, self, c, ctx)
        return (heat,) if water is None else (water, heat)

    def invclosure(self, state, grid, ctx):
        self.hydrology.invclosure(state, grid, self, ctx.constants, ctx)
        self.energy.closure_rel.invclosure(state, self.energy, self, ctx.constants)
