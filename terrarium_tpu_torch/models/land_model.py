"""LandModel: the coupled land surface model (counterpart of
``terrarium_tpu/models/land_model.py``): atmosphere, soil, surface energy
balance, surface hydrology and optional PALADYN vegetation. The surface
couples to the soil through two top Flux BCs (reference
`land_model.jl:46-66`): the SEB's ``ground_heat_flux`` on
``internal_energy`` and ``-infiltration`` on ``saturation_water_ice``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .boundary_conditions import GroundHeatFlux
from .initializers import DefaultInitializer
from ..constants import PhysicalConstants
from ..ops.bcs import Flux, InputRef, merge_boundary_conditions
from ..processes.atmosphere import PrescribedAtmosphere
from ..processes.base import Context
from ..processes.soil.hydrology import RichardsEq, SoilHydrology
from ..processes.soil.soil_coupled import SoilEnergyWaterCarbon
from ..processes.surface_energy.seb import SurfaceEnergyBalance
from ..processes.surface_hydrology.surface_hydrology import SurfaceHydrology
from ..variables import Variables, variables_of

__all__ = ["LandModel", "coupling_bcs"]


def default_soil(vegetation) -> SoilEnergyWaterCarbon:
    """Richards flow when vegetation is present, else heat only (reference
    `land_model.jl:111-114`)."""
    if vegetation is None:
        return SoilEnergyWaterCarbon()
    return SoilEnergyWaterCarbon(hydrology=SoilHydrology(vertical_flow=RichardsEq()))


def default_surface_hydrology(vegetation) -> SurfaceHydrology:
    """Bare-ground schemes when vegetation is absent (reference `land_model.jl:119-125`)."""
    return SurfaceHydrology.bare_ground() if vegetation is None else SurfaceHydrology()


def coupling_bcs() -> dict:
    """The surface-to-soil BCs: ground heat flux on the energy, -infiltration
    on the saturation (reference `land_model.jl:46-66`)."""
    return merge_boundary_conditions(
        GroundHeatFlux("ground_heat_flux"),
        {"saturation_water_ice": {"top": Flux(InputRef("infiltration", -1.0))}})


@dataclasses.dataclass(frozen=True)
class _LandExtras:
    """The sibling processes the soil reads through ``Context.extras``."""

    evapotranspiration: Any = None
    runoff: Any = None


@dataclasses.dataclass(frozen=True)
class LandModel:
    """Coupled land model (reference `land_model.jl:9-44`). ``soil`` and
    ``surface_hydrology`` default by the presence of vegetation, as in the
    reference. The JAX package's optional snowpack is not ported yet."""

    grid: Any
    vegetation: Optional[Any] = None
    soil: Optional[SoilEnergyWaterCarbon] = None
    surface_energy_balance: SurfaceEnergyBalance = SurfaceEnergyBalance()
    surface_hydrology: Optional[SurfaceHydrology] = None
    atmosphere: PrescribedAtmosphere = PrescribedAtmosphere()
    constants: PhysicalConstants = PhysicalConstants()
    initializer: Any = DefaultInitializer()
    snow: Optional[Any] = None

    def __post_init__(self):
        if self.snow is not None:
            raise ValueError(f"the port's LandModel has no snowpack yet, got "
                             f"{type(self.snow).__name__}")
        if self.soil is None:
            object.__setattr__(self, "soil", default_soil(self.vegetation))
        if self.surface_hydrology is None:
            object.__setattr__(self, "surface_hydrology",
                               default_surface_hydrology(self.vegetation))

    @property
    def live_carry(self) -> tuple:
        """The fields a closure-rotated step reads before it writes them,
        besides the clock and the inputs: the prognostics, and under
        vegetation the net assimilation, which the stomatal conductance reads
        from the step before (the photosynthesis runs after it in the
        reference's order). The JAX package finds the same set by dead-code
        elimination of the traced step (`utils/scan_dce.py`)."""
        out = ("internal_energy",)
        if self.soil.hydrology.richards:
            out += ("saturation_water_ice", "surface_excess_water")
        out += ("skin_temperature",)
        if self.vegetation is not None:
            out += ("canopy_water", "carbon_vegetation", "vegetation_area_fraction",
                    "net_assimilation")
        return out

    @property
    def static_auxiliaries(self) -> tuple:
        """Auxiliaries the step reads and never writes: the root fraction,
        and under ``NoFlow`` the saturation and the water table."""
        out = () if self.soil.hydrology.richards else ("saturation_water_ice", "water_table")
        return out + (("root_fraction",) if self.vegetation is not None else ())

    def variables(self) -> tuple:
        out = variables_of(self.atmosphere) + variables_of(self.soil)
        if self.vegetation is not None:
            out += variables_of(self.vegetation)
        return (out + variables_of(self.surface_hydrology)
                + variables_of(self.surface_energy_balance))

    def collated_variables(self) -> Variables:
        return Variables.of(self)

    def make_context(self, bcs=None) -> Context:
        """The user BCs merged with the coupling BCs, and the ET and runoff
        schemes as the soil's siblings."""
        extras = _LandExtras(evapotranspiration=self.surface_hydrology.evapotranspiration,
                             runoff=self.surface_hydrology.surface_runoff)
        return Context(constants=self.constants,
                       bcs=merge_boundary_conditions(bcs or {}, coupling_bcs()), extras=extras)

    def initialize(self, state, ctx) -> None:
        self.initializer.initialize(state, self)
        if self.vegetation is not None:
            self.vegetation.initialize(state, self.grid, self.constants, self.atmosphere, ctx)
        self.soil.initialize(state, self.grid, ctx)
        self.compute_auxiliary(state, ctx)  # seeds the SEB for the first step's BCs

    def compute_auxiliary(self, state, ctx) -> None:
        """Atmosphere, soil, vegetation, surface hydrology, SEB, and the SEB's
        fused flux update a second time (reference `land_model.jl:79-88`)."""
        c, grid = self.constants, self.grid
        self.atmosphere.compute_auxiliary(state, grid, ctx)
        self.soil.compute_auxiliary(state, grid, ctx)
        if self.vegetation is not None:
            self.vegetation.compute_auxiliary(state, grid, c, self.atmosphere, self.soil, ctx)
        self.surface_hydrology.compute_auxiliary(state, grid, c, self.atmosphere, self.soil,
                                                 self.vegetation, ctx)
        evtr = self.surface_hydrology.evapotranspiration
        seb = self.surface_energy_balance
        seb.compute_auxiliary(state, grid, c, self.atmosphere, evtr, ctx)
        seb.compute_surface_energy_fluxes(state, grid, c, self.atmosphere, evtr)

    def compute_tendencies(self, state, ctx) -> None:
        """Surface hydrology, soil, vegetation (reference `land_model.jl:90-96`)."""
        self.surface_hydrology.compute_tendencies(state, self.grid, ctx)
        self.soil.compute_tendencies(state, self.grid, ctx)
        if self.vegetation is not None:
            self.vegetation.compute_tendencies(state, self.grid, self.constants, ctx)

    def closure(self, state, ctx) -> None:
        self.soil.closure(state, self.grid, ctx)

    def invclosure(self, state, ctx) -> None:
        self.soil.invclosure(state, self.grid, ctx)

    def implicit_terms(self, state, ctx) -> tuple:
        return self.soil.implicit_terms(state, self.grid, ctx)

    def timestep(self, state, ctx, dt) -> None:
        """Post-step hook; a no-op without a snowpack."""
