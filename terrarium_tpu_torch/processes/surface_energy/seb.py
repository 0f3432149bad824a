"""Surface energy balance: albedo, radiative and turbulent fluxes, skin
temperature and ground heat flux (counterpart of
``terrarium_tpu/processes/surface_energy/seb.py``).

All fluxes are positive upward: R_net = SW_up - SW_down + LW_up - LW_down.
The fused update is a flux sweep, then, with an implicit skin temperature,
the skin update and a second flux sweep (`surface_energy_balance.jl:95-110`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..base import Context
from ...constants import stefan_boltzmann
from ...variables import XY, auxiliary, input as input_var, prognostic

__all__ = ["PrescribedAlbedo", "ConstantAlbedo", "PrescribedRadiativeFluxes",
           "DiagnosedRadiativeFluxes", "PrescribedTurbulentFluxes", "DiagnosedTurbulentFluxes",
           "PrescribedSkinTemperature", "ImplicitSkinTemperature", "SurfaceEnergyBalance",
           "net_radiation"]


@dataclasses.dataclass(frozen=True)
class PrescribedAlbedo:
    """Albedo and emissivity from input fields (reference `albedo.jl:1-13`)."""

    def variables(self):
        return (input_var("albedo", XY(), domain=(0.0, 1.0), desc="Surface albedo"),
                input_var("emissivity", XY(), domain=(0.0, 1.0), desc="Surface emissivity"))

    def albedo(self, state):
        return state.inputs["albedo"]

    def emissivity(self, state):
        return state.inputs["emissivity"]


@dataclasses.dataclass(frozen=True)
class ConstantAlbedo:
    """Constant albedo 0.3 and emissivity 0.97 (reference `albedo.jl:21-45`)."""

    albedo_value: float = 0.3
    emissivity_value: float = 0.97

    def variables(self):
        return ()

    def albedo(self, state):
        return self.albedo_value

    def emissivity(self, state):
        return self.emissivity_value


@dataclasses.dataclass(frozen=True)
class PrescribedRadiativeFluxes:
    """Upwelling shortwave and longwave from inputs (reference
    `radiative_fluxes.jl:1-60`)."""

    def variables(self):
        return (
            input_var("surface_shortwave_up", XY(), units="W/m^2",
                      desc="Outgoing (upwelling) shortwave radiation"),
            input_var("surface_longwave_up", XY(), units="W/m^2",
                      desc="Outgoing (upwelling) longwave radiation"),
            auxiliary("surface_net_radiation", XY(), units="W/m^2",
                      desc="Net (positive up) radiation"),
        )

    def upwelling(self, state, seb, constants, atmos, Ts):
        return state.inputs["surface_shortwave_up"], state.inputs["surface_longwave_up"]


@dataclasses.dataclass(frozen=True)
class DiagnosedRadiativeFluxes:
    """SW_up = alpha SW_down; LW_up = eps sigma T^4 + (1 - eps) LW_down
    (reference `radiative_fluxes.jl:70-105`)."""

    def variables(self):
        return (
            auxiliary("surface_shortwave_up", XY(), units="W/m^2",
                      desc="Outgoing (upwelling) shortwave radiation"),
            auxiliary("surface_longwave_up", XY(), units="W/m^2",
                      desc="Outgoing (upwelling) longwave radiation"),
            auxiliary("surface_net_radiation", XY(), units="W/m^2",
                      desc="Net radiation budget"),
        )

    def upwelling(self, state, seb, constants, atmos, Ts):
        eps = seb.albedo.emissivity(state)
        SW_up = seb.albedo.albedo(state) * atmos.shortwave_down(state)
        T = constants.celsius_to_kelvin(Ts)
        LW_up = stefan_boltzmann(constants, T, eps) + (1.0 - eps) * atmos.longwave_down(state)
        return SW_up, LW_up


def net_radiation(SW_up, SW_down, LW_up, LW_down):
    """R_net = SW_up - SW_down + LW_up - LW_down, positive up
    (reference `radiative_fluxes.jl:199-209`)."""
    return SW_up - SW_down + LW_up - LW_down


@dataclasses.dataclass(frozen=True)
class PrescribedTurbulentFluxes:
    """Sensible and latent heat fluxes from inputs (reference
    `turbulent_fluxes.jl:1-21`)."""

    def variables(self):
        return (input_var("sensible_heat_flux", XY(), units="W/m^2",
                          desc="Sensible heat flux at the surface"),
                input_var("latent_heat_flux", XY(), units="W/m^2",
                          desc="Latent heat flux at the surface"))

    def sensible(self, state, seb, constants, atmos, Ts):
        return state.inputs["sensible_heat_flux"]

    def latent(self, state, seb, constants, atmos, Ts, evtr=None):
        return state.inputs["latent_heat_flux"]


@dataclasses.dataclass(frozen=True)
class DiagnosedTurbulentFluxes:
    """H_s = c_a rho_a (Ts - Ta) / r_a; H_l = L rho_a Q_h with Q_h the ET
    scheme's surface humidity flux, or dq / r_a without one (reference
    `turbulent_fluxes.jl:30-182`)."""

    def variables(self):
        return (auxiliary("sensible_heat_flux", XY(), units="W/m^2",
                          desc="Sensible heat flux at the surface"),
                auxiliary("latent_heat_flux", XY(), units="W/m^2",
                          desc="Latent heat flux at the surface"))

    def sensible(self, state, seb, constants, atmos, Ts):
        r_a = atmos.aerodynamic_resistance(state, constants)
        Q_T = (Ts - atmos.air_temperature(state)) / r_a
        return constants.c_a * constants.rho_a * Q_T

    def latent(self, state, seb, constants, atmos, Ts, evtr=None):
        if evtr is not None:
            Q_h = evtr.surface_humidity_flux(state)
        else:
            Q_h = atmos.humidity_vpd(state, constants, Ts) \
                / atmos.aerodynamic_resistance(state, constants)
        return constants.L_lg * constants.rho_a * Q_h


@dataclasses.dataclass(frozen=True)
class PrescribedSkinTemperature:
    """Skin temperature as an input field (reference `skin_temperature.jl:10-41`)."""

    kappa_s: float = 2.0

    def variables(self):
        return (auxiliary("ground_heat_flux", XY(), units="W/m^2", desc="Ground heat flux"),
                input_var("skin_temperature", XY(), units="degC",
                          desc="Longwave emission temperature of the land surface"))

    def skin_temperature(self, state):
        return state.skin_temperature


@dataclasses.dataclass(frozen=True)
class ImplicitSkinTemperature:
    """Ts = Tg - G dz1 / (2 kappa_s), the half-cell flux balance (reference
    `skin_temperature.jl:44-110`), with |Ts - Tg| bounded by ``max_delta``:
    the explicit fixed-point update can oscillate divergently under strong
    coupling, which the JAX package guards (`seb.py:209-237`)."""

    kappa_s: float = 2.0
    max_delta: float = 50.0

    def variables(self):
        return (
            prognostic("skin_temperature", XY(), units="degC",
                       desc="Longwave emission temperature of the land surface"),
            auxiliary("ground_heat_flux", XY(), units="W/m^2", desc="Ground heat flux"),
            input_var("ground_temperature", XY(), units="degC",
                      desc="Temperature of the uppermost ground or soil cell"),
        )

    def skin_temperature(self, state):
        return state.skin_temperature

    def compute_skin_temperature(self, state, grid):
        delta = torch.clamp(-state.ground_heat_flux * grid.dz[-1] / (2.0 * self.kappa_s),
                            -self.max_delta, self.max_delta)
        return state.ground_temperature + delta


@dataclasses.dataclass(frozen=True)
class SurfaceEnergyBalance:
    """The coupled SEB (reference `surface_energy_balance.jl:9-44`).

    ``ground_flux_form``: ``"reference"`` (the default) takes G = R_net -
    H_s - H_l as the reference does (`skin_temperature.jl:76-80`), which
    with every flux positive up makes turbulent losses heat the ground;
    ``"consistent"`` takes G = R_net + H_s + H_l, the energy-conserving
    balance of the JAX package's production configurations."""

    skin_temperature: Any = ImplicitSkinTemperature()
    radiative_fluxes: Any = DiagnosedRadiativeFluxes()
    turbulent_fluxes: Any = DiagnosedTurbulentFluxes()
    albedo: Any = ConstantAlbedo()
    ground_flux_form: str = "reference"

    def __post_init__(self):
        if self.ground_flux_form not in ("reference", "consistent"):
            raise ValueError(f"ground_flux_form is 'reference' or 'consistent', got "
                             f"{self.ground_flux_form!r}")

    @staticmethod
    def consistent(**kw) -> "SurfaceEnergyBalance":
        return SurfaceEnergyBalance(ground_flux_form="consistent", **kw)

    def variables(self):
        return (tuple(self.albedo.variables()) + tuple(self.skin_temperature.variables())
                + tuple(self.radiative_fluxes.variables())
                + tuple(self.turbulent_fluxes.variables()))

    def _fluxes(self, state, grid, constants, atmos, evtr) -> None:
        Ts = self.skin_temperature.skin_temperature(state)
        SW_up, LW_up = self.radiative_fluxes.upwelling(state, self, constants, atmos, Ts)
        R_net = net_radiation(SW_up, atmos.shortwave_down(state), LW_up,
                              atmos.longwave_down(state))
        H_s = self.turbulent_fluxes.sensible(state, self, constants, atmos, Ts)
        H_l = self.turbulent_fluxes.latent(state, self, constants, atmos, Ts, evtr)
        if self.ground_flux_form == "consistent":
            G = R_net + H_s + H_l
        else:
            G = R_net - H_s - H_l
        updates = dict(surface_net_radiation=R_net, ground_heat_flux=G)
        if isinstance(self.radiative_fluxes, DiagnosedRadiativeFluxes):
            updates.update(surface_shortwave_up=SW_up, surface_longwave_up=LW_up)
        if isinstance(self.turbulent_fluxes, DiagnosedTurbulentFluxes):
            updates.update(sensible_heat_flux=H_s, latent_heat_flux=H_l)
        like = state.ground_heat_flux
        state.set(**{k: torch.broadcast_to(torch.as_tensor(v, device=like.device), like.shape)
                     .to(like.dtype) for k, v in updates.items()})

    def compute_surface_energy_fluxes(self, state, grid, constants, atmos, evtr=None) -> None:
        """The fused update: fluxes, and with an implicit skin temperature
        the skin update and the fluxes again."""
        self._fluxes(state, grid, constants, atmos, evtr)
        if isinstance(self.skin_temperature, ImplicitSkinTemperature):
            state.set(skin_temperature=self.skin_temperature.compute_skin_temperature(state,
                                                                                     grid))
            self._fluxes(state, grid, constants, atmos, evtr)

    def compute_auxiliary(self, state, grid, constants, atmos, evtr=None,
                          ctx: Optional[Context] = None) -> None:
        self.compute_surface_energy_fluxes(state, grid, constants, atmos, evtr)

    def compute_tendencies(self, state, grid, ctx: Context = None) -> None:
        """The skin temperature is updated diagnostically: no tendency."""
