"""Physical constants (counterpart of ``terrarium_tpu/constants.py``).

Constants are plain Python floats; combined with a tensor they take the
tensor's dtype, as the reference's number-format policy asks.
"""
from __future__ import annotations

import dataclasses

__all__ = ["PhysicalConstants"]


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
