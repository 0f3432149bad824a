"""Physical constants and the vapour-pressure helpers (counterpart of
``terrarium_tpu/constants.py``).

Constants are plain Python floats; combined with a tensor they take the
tensor's dtype, as the reference's number-format policy asks.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["PhysicalConstants", "stefan_boltzmann", "saturation_vapor_pressure",
           "compute_vpd", "vapor_pressure_to_specific_humidity", "partial_pressure_O2",
           "partial_pressure_CO2"]


@dataclasses.dataclass(frozen=True)
class PhysicalConstants:
    """General physical constants (reference `physical_constants.jl:9-53`)."""

    rho_w: float = 1000.0  # density of water [kg/m^3]
    rho_i: float = 916.2  # density of ice [kg/m^3]
    rho_a: float = 1.293  # density of air at STP [kg/m^3]
    c_a: float = 1005.7  # specific heat capacity of dry air [J/(kg*K)]
    L_sl: float = 3.34e5  # latent heat of fusion [J/kg]
    L_lg: float = 2.257e6  # latent heat of vaporization [J/kg]
    L_sg: float = 2.834e6  # latent heat of sublimation [J/kg]
    g: float = 9.80665  # gravitational acceleration [m/s^2]
    T_ref: float = 273.15  # 0 degC in Kelvin
    sigma: float = 5.6704e-8  # Stefan-Boltzmann constant [W/(m^2 K^4)]
    kappa: float = 0.4  # von Karman constant
    eps: float = 0.622  # molecular weight ratio water vapor / dry air
    R_a: float = 287.058  # specific gas constant of air [J/(kg*K)]
    C_mass: float = 12.0  # atomic mass of carbon [gC/mol]

    def celsius_to_kelvin(self, T):
        return T + self.T_ref


def stefan_boltzmann(c: PhysicalConstants, T, emissivity):
    """M = eps * sigma * T^4 with T in Kelvin (reference `physical_constants.jl:68`);
    ``eps * sigma`` is formed in Python, T^4 as ``(T * T) * (T * T)``."""
    return emissivity * c.sigma * ((T * T) * (T * T))


def saturation_vapor_pressure(T):
    """August-Roche-Magnus saturation vapour pressure [Pa] at ``T`` [degC],
    frozen coefficients at and below 0 (reference `physics_utils.jl:54-73`).
    ``T`` is clipped to [-150, 150] first, as in the JAX package, so that a
    diverging skin temperature cannot divide by zero."""
    T = torch.clamp(T, -150.0, 150.0)
    e_frozen = 611.0 * torch.exp(22.46 * T / (T + 272.62))
    e_liquid = 611.0 * torch.exp(17.62 * T / (T + 243.12))
    return torch.where(T <= 0.0, e_frozen, e_liquid)


def compute_vpd(c: PhysicalConstants, pres, q_air, T):
    """Vapour pressure deficit [Pa] over a surface at ``T`` [degC], at least
    0.1 Pa (reference `physical_constants.jl:83-97`)."""
    e_sat = saturation_vapor_pressure(T)
    e_air = q_air * pres / (c.eps + (1.0 - c.eps) * q_air)
    return torch.clamp(e_sat - e_air, min=0.1)


def vapor_pressure_to_specific_humidity(e, p, eps=0.622):
    """q = eps * e / p (reference `physics_utils.jl:40`)."""
    return eps * e / p


def partial_pressure_O2(pres):
    """0.209 * p (reference `physics_utils.jl:18-22`)."""
    return 0.209 * pres


def partial_pressure_CO2(pres, conc_co2_ppm):
    """ppm * 1e-6 * p (reference `physics_utils.jl:29-33`)."""
    return conc_co2_ppm * 1.0e-6 * pres
