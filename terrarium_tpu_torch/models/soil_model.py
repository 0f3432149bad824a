"""SoilModel: columns of soil energy, water and carbon (counterpart of
``terrarium_tpu/models/soil_model.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any

from .initializers import DefaultInitializer
from ..constants import PhysicalConstants
from ..processes.base import Context
from ..processes.soil.soil_coupled import SoilEnergyWaterCarbon
from ..variables import Variables, variables_of

__all__ = ["SoilModel"]


@dataclasses.dataclass(frozen=True)
class SoilModel:
    """Soil column model (reference `soil_model.jl:9-27`)."""

    grid: Any
    soil: SoilEnergyWaterCarbon = SoilEnergyWaterCarbon()
    constants: PhysicalConstants = PhysicalConstants()
    initializer: Any = DefaultInitializer()

    @property
    def live_carry(self) -> tuple:
        """The prognostic fields a closure-rotated step reads and writes,
        besides the clock. Everything else is rebuilt inside the step from
        them (the JAX package finds the same set by dead-code elimination of
        the traced step, `utils/scan_dce.py`; torch has no such pass, so it
        is declared). Under ``NoFlow`` the step also reads the saturation,
        an auxiliary that it never writes."""
        if self.soil.hydrology.richards:
            return ("internal_energy", "saturation_water_ice", "surface_excess_water")
        return ("internal_energy",)

    def variables(self) -> tuple:
        return variables_of(self.soil)

    def collated_variables(self) -> Variables:
        return Variables.of(self)

    def make_context(self, bcs=None) -> Context:
        return Context(constants=self.constants, bcs=bcs)

    def initialize(self, state, ctx) -> None:
        self.initializer.initialize(state, self)
        self.soil.initialize(state, self.grid, ctx)

    def compute_auxiliary(self, state, ctx) -> None:
        self.soil.compute_auxiliary(state, self.grid, ctx)

    def compute_tendencies(self, state, ctx) -> None:
        self.soil.compute_tendencies(state, self.grid, ctx)

    def closure(self, state, ctx) -> None:
        self.soil.closure(state, self.grid, ctx)

    def invclosure(self, state, ctx) -> None:
        self.soil.invclosure(state, self.grid, ctx)

    def implicit_terms(self, state, ctx) -> tuple:
        return self.soil.implicit_terms(state, self.grid, ctx)

    def timestep(self, state, ctx, dt) -> None:
        """Post-step hook of the implicit stepper; a no-op (reference
        `abstract_timestepper.jl:47`)."""
