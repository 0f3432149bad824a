"""Soil energy balance: two-phase heat conduction and the energy-temperature
closure (counterpart of ``terrarium_tpu/processes/soil/energy.py``)."""
from __future__ import annotations

import dataclasses

import torch

from .thermal import SoilThermalProperties
from ...ops.bcs import get_bc
from ...ops.vertical_ops import div_faces, ghosts, grad_faces, interp_faces_mid
from ...variables import XY, XYZ, auxiliary, prognostic

__all__ = ["SoilEnergyTemperatureClosure", "SoilEnergyBalance"]


@dataclasses.dataclass(frozen=True)
class SoilEnergyTemperatureClosure:
    """U(T) = T*C(T) - L*theta_wi*(1 - liq) (reference
    `soil_energy_closures.jl:1-17`)."""

    def variables(self):
        return (
            auxiliary("temperature", XYZ(), units="degC",
                      desc="Temperature of the soil volume"),
            auxiliary("liquid_water_fraction", XYZ(), domain=(0.0, 1.0),
                      desc="Fraction of unfrozen water in the pore space"),
        )

    def closure(self, state, energy, soil, constants):
        """Energy to temperature (reference `soil_energy_closures.jl:99-126`)."""
        U = state.internal_energy
        L = constants.rho_w * constants.L_sl
        por = soil.strat.bulk_porosity(soil.biogeochem)
        sat = state.saturation_water_ice
        L_theta = L * sat * por
        fc = energy.thermal_properties.freezecurve
        liq = fc.liquid_water_fraction(U, L_theta)
        vol = soil.strat.soil_volume(soil.biogeochem, state, saturation=sat, liquid=liq)
        C = energy.thermal_properties.heat_capacity(vol)
        T = fc.temperature(U, L_theta, C)
        state.set(temperature=T, liquid_water_fraction=liq, ground_temperature=T[-1])

    def invclosure(self, state, energy, soil, constants):
        """Temperature to energy (reference `soil_energy_closures.jl:64-97`);
        liq = 1 where T >= 0, else 0 (initialization only)."""
        T = state.temperature
        L = constants.rho_w * constants.L_sl
        por = soil.strat.bulk_porosity(soil.biogeochem)
        sat = state.saturation_water_ice
        liq = torch.where(T >= 0.0, torch.ones_like(T), torch.zeros_like(T))
        vol = soil.strat.soil_volume(soil.biogeochem, state, saturation=sat, liquid=liq)
        C = energy.thermal_properties.heat_capacity(vol)
        U = T * C - L * sat * por * (1.0 - liq)
        state.set(internal_energy=U, liquid_water_fraction=liq, ground_temperature=T[-1])


@dataclasses.dataclass(frozen=True)
class SoilEnergyBalance:
    """Soil energy balance with freeze/thaw (reference `soil_energy.jl:23-44`),
    explicit two-phase heat conduction."""

    closure_rel: SoilEnergyTemperatureClosure = SoilEnergyTemperatureClosure()
    thermal_properties: SoilThermalProperties = SoilThermalProperties()

    def variables(self):
        return (
            prognostic("internal_energy", XYZ(), units="J/m^3", closure=self.closure_rel,
                       desc="Internal energy incl. latent and sensible components"),
            auxiliary("ground_temperature", XY(),
                      ctor=lambda grid, arrays: arrays["temperature"][-1].clone(),
                      units="degC", desc="Temperature of the uppermost soil cell"),
        )

    def initialize(self, state, grid, soil, constants, ctx):
        self.closure_rel.invclosure(state, self, soil, constants)

    def compute_tendencies(self, state, grid, soil, constants, ctx):
        """dU/dt += -d/dz(-kappa_f dT/dz) with kappa averaged to faces
        (reference `soil_energy.jl:102-149`)."""
        T = state.temperature
        kappa = self.thermal_conductivity(state, soil)
        g_bot, g_top = ghosts(T, get_bc(ctx.bcs, "temperature", "bottom"),
                              get_bc(ctx.bcs, "temperature", "top"), state,
                              grid.dz_faces)
        kappa_f = interp_faces_mid(kappa)
        q = -kappa_f * grad_faces(T, grid.dz_faces, g_bot, g_top)
        state.add_tendencies(internal_energy=-div_faces(q, grid.dz))

    def thermal_conductivity(self, state, soil):
        """Bulk kappa at cell centres (reference `soil_energy.jl:128-137`)."""
        vol = soil.strat.soil_volume(soil.biogeochem, state)
        return self.thermal_properties.thermal_conductivity(vol)

    def implicit_diffusion_terms(self, state, grid, soil, constants, ctx):
        """The implicit heat solve's Jacobian ingredients (`energy.py:142-163`):
        face kappa and D = dT/dU, 0 on the phase-change plateau
        ``-L_theta <= U < 0`` and 1/C elsewhere; scale 1."""
        from ...timesteppers.implicit import ImplicitDiffusionTerms

        shape = (grid.nz, grid.cells)
        kappa_f = interp_faces_mid(torch.broadcast_to(self.thermal_conductivity(state, soil),
                                                      shape))
        U = state.internal_energy
        L = constants.rho_w * constants.L_sl
        L_theta = L * state.saturation_water_ice * soil.strat.bulk_porosity(soil.biogeochem)
        C = self.thermal_properties.heat_capacity(soil.strat.soil_volume(soil.biogeochem, state))
        D = torch.where((U >= -L_theta) & (U < 0.0), 0.0, 1.0 / C)
        return ImplicitDiffusionTerms(
            var="internal_energy", K_faces=kappa_f, D=torch.broadcast_to(D, shape),
            scale=torch.ones((), dtype=grid.dtype, device=grid.device), phi_var="temperature")

    def closure(self, state, grid, soil, constants, ctx):
        self.closure_rel.closure(state, self, soil, constants)
