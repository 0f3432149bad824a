"""Richards-equation soil hydrology (counterpart of
``terrarium_tpu/processes/soil/hydrology.py``).

Only Richards flow in the reference's parity mode is ported (no
``deficit_pool``, no ``vwc_forcing``, no evapotranspiration or runoff
siblings). The saturation adjustment runs the reference's two sequential
sweeps literally, one row at a time, in the order the CUDA column kernel
uses.
"""
from __future__ import annotations

import dataclasses

import torch

from .hydraulics import ConstantSoilHydraulics
from ...ops.bcs import get_bc
from ...ops.vertical_ops import div_faces, ghosts, grad_faces
from ...variables import XY, XYZ, auxiliary, input, prognostic

__all__ = ["RichardsEq", "SoilSaturationPressureClosure", "SoilHydrology"]


@dataclasses.dataclass(frozen=True)
class RichardsEq:
    """Mixed saturation-pressure Richards flow (reference `soil_hydrology_rre.jl:18`)."""


@dataclasses.dataclass(frozen=True)
class SoilSaturationPressureClosure:
    """Saturation <-> total head Psi = psi_m + psi_z + psi_h (reference
    `soil_hydraulic_closures.jl:12`); driven by :class:`SoilHydrology`."""

    def variables(self):
        return (auxiliary("pressure_head", XYZ(), units="m",
                          desc="Total hydraulic pressure head in m"),)


def _shift_up(x, fill):
    """Row ``f`` of the result is ``x[f - 1]``; row 0 is ``fill``."""
    return torch.cat([torch.full_like(x[:1], fill), x[:-1]], dim=0)


def _shift_down(x, fill):
    """Row ``f`` of the result is ``x[f + 1]``; the top row is ``fill``."""
    return torch.cat([x[1:], torch.full_like(x[:1], fill)], dim=0)


@dataclasses.dataclass(frozen=True)
class SoilHydrology:
    """Soil water balance with Richards flow (reference `soil_hydrology.jl:21-53`).
    The defaults are the main-path parameterization
    ``ConstantSoilHydraulics(VanGenuchten(), UnsatKVanGenuchten())``."""

    vertical_flow: RichardsEq = RichardsEq()
    closure_rel: SoilSaturationPressureClosure = SoilSaturationPressureClosure()
    hydraulic_properties: ConstantSoilHydraulics = dataclasses.field(
        default_factory=ConstantSoilHydraulics)

    def variables(self):
        # reference `soil_hydrology_rre.jl:20-26`
        return (
            prognostic("saturation_water_ice", XYZ(), closure=self.closure_rel,
                       domain=(0.0, 1.0),
                       desc="Saturation level of water+ice in the pore space"),
            prognostic("surface_excess_water", XY(), units="m",
                       desc="Excess water at the soil surface in m^3/m^2"),
            auxiliary("hydraulic_conductivity", XYZ(face=True), units="m/s",
                      desc="Hydraulic conductivity at cell faces"),
            auxiliary("water_table", XY(), units="m", desc="Elevation of the water table"),
            input("liquid_water_fraction", XYZ(), default=1.0, domain=(0.0, 1.0),
                  desc="Fraction of unfrozen water in the pore space"),
        )

    def center_hydraulic_conductivity(self, state, soil):
        vol = soil.strat.soil_volume(soil.biogeochem, state)
        return self.hydraulic_properties.hydraulic_conductivity(vol)

    def compute_hydraulics(self, state, grid, soil):
        """Face K as the reference kernel fills it (`soil_hydrology.jl:145-163`):
        bottom face = bottom-centre K, interior faces = min of the two
        neighbours, and both top faces = top-centre K."""
        Kc = torch.broadcast_to(self.center_hydraulic_conductivity(state, soil),
                                (grid.nz, grid.cells))
        K_face = torch.cat([Kc[:1], torch.minimum(Kc[:-2], Kc[1:-1]),
                            Kc[-1:], Kc[-1:]], dim=0)
        state.set(hydraulic_conductivity=K_face)

    def compute_water_table(self, state, grid):
        """Elevation of the face below the lowest cell with sat < 1; the
        surface if every cell is saturated (reference `soil_hydrology.jl:170-175`)."""
        zf = grid.z_faces
        masked = torch.where(state.saturation_water_ice < 1.0, zf[:-1], zf[-1])
        state.set(water_table=masked.amin(dim=0))

    def adjust_saturation_profile(self, state, grid):
        """Mass-conserving redistribution (reference `soil_hydrology.jl:185-218`).

        Up sweep, bottom to top: ``c[k] = max(0, (sat[k] - 1)*dz[k] + c[k-1])``
        and ``sat_up[k] = min(sat[k] + c[k-1]/dz[k], 1)``; the spill ``c[top]``
        goes unscaled to ``surface_excess_water``. Down sweep, top to bottom,
        on ``-sat_up[k]*dz[k]`` with the same recurrence; every layer ends as
        ``max(sat_up - c2_in/dz, 0)``, which also clips a residual bottom
        deficit (the reference's acknowledged mass-balance violation)."""
        rows = state.saturation_water_ice.unbind(0)
        dz = grid.dz.unbind(0)
        c = torch.zeros_like(rows[0])
        sat_up = []
        for k in range(len(rows)):
            sat_up.append(torch.clamp(rows[k] + c / dz[k], max=1.0))
            c = torch.clamp((rows[k] - 1.0) * dz[k] + c, min=0.0)
        surf = state.surface_excess_water + c
        c2 = torch.zeros_like(c)
        new = [None] * len(rows)
        for k in reversed(range(len(rows))):
            new[k] = torch.clamp(sat_up[k] - c2 / dz[k], min=0.0)
            c2 = torch.clamp(-sat_up[k] * dz[k] + c2, min=0.0)
        state.set(saturation_water_ice=torch.stack(new), surface_excess_water=surf)

    def initialize(self, state, grid, soil, constants, ctx):
        """Closure from the initial saturation, then the face K (reference
        `soil_hydrology_rre.jl:33-47`)."""
        self.closure(state, grid, soil, constants, ctx)
        self.compute_hydraulics(state, grid, soil)

    def compute_auxiliary(self, state, grid, soil, constants, ctx):
        self.compute_hydraulics(state, grid, soil)

    def compute_tendencies(self, state, grid, soil, constants, ctx):
        """Darcy flux divergence over porosity (reference
        `soil_hydrology_rre.jl:95-131`, `soil_hydrology.jl:222-237`) and the
        parity surface-pool term ``+min(0, S)`` (`soil_hydrology.jl:260-283`)."""
        psi = state.pressure_head
        g_bot, g_top = ghosts(psi, get_bc(ctx.bcs, "pressure_head", "bottom"),
                              get_bc(ctx.bcs, "pressure_head", "top"), state,
                              grid.dz_faces)
        grad = grad_faces(psi, grid.dz_faces, g_bot, g_top)
        K = state.hydraulic_conductivity
        # min of the conductivities in the direction of flow; +inf fill at
        # the ends leaves the boundary face's own K
        K_eff = torch.where(grad < 0.0,
                            torch.minimum(_shift_up(K, torch.inf), K),
                            torch.minimum(K, _shift_down(K, torch.inf)))
        q = -K_eff * grad
        dtheta_dt = -div_faces(q, grid.dz)
        por = soil.strat.bulk_porosity(soil.biogeochem)
        state.add_tendencies(saturation_water_ice=dtheta_dt / por)
        S = state.surface_excess_water
        state.add_tendencies(surface_excess_water=torch.minimum(torch.zeros_like(S), S))

    def _psi_components(self, state, grid):
        z = grid.z_centers
        psi_z = z - float(grid.vertical.z_faces[-1])
        psi_h = torch.clamp(state.water_table[None, :] - z, min=0.0)
        return psi_z, psi_h

    def closure(self, state, grid, soil, constants, ctx=None):
        """Saturation to pressure head (reference `soil_hydraulic_closures.jl:23-44`):
        adjust the profile, update the water table, then
        Psi = psi_h + psi_m + psi_z."""
        self.adjust_saturation_profile(state, grid)
        self.compute_water_table(state, grid)
        self.compute_pressure_head(state, grid, soil)

    def compute_pressure_head(self, state, grid, soil):
        """Psi = psi_h + psi_m + psi_z from the (adjusted) saturation and the
        water table."""
        por = soil.strat.bulk_porosity(soil.biogeochem)
        psi_m = self.hydraulic_properties.swrc.inverse(
            state.saturation_water_ice * por, por)
        psi_z, psi_h = self._psi_components(state, grid)
        state.set(pressure_head=psi_h + psi_m + psi_z)

    def invclosure(self, state, grid, soil, constants, ctx=None):
        """Pressure head to saturation (reference `soil_hydraulic_closures.jl:51-100`),
        then the adjustment and the water table."""
        psi_z, psi_h = self._psi_components(state, grid)
        psi_m = state.pressure_head - psi_h - psi_z
        por = soil.strat.bulk_porosity(soil.biogeochem)
        theta = self.hydraulic_properties.swrc(psi_m, por)
        state.set(saturation_water_ice=theta / por)
        self.adjust_saturation_profile(state, grid)
        self.compute_water_table(state, grid)
