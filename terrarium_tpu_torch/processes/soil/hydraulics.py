"""Soil hydraulic properties (counterpart of
``terrarium_tpu/processes/soil/hydraulics.py``)."""
from __future__ import annotations

import dataclasses

import torch

from .stratigraphy import SoilVolume, volumetric_fractions
from .swrc import VanGenuchten, one_minus_eps
from ...ops.fastpow import fast_pow

__all__ = ["UnsatKVanGenuchten", "ConstantSoilHydraulics"]


@dataclasses.dataclass(frozen=True)
class UnsatKVanGenuchten:
    """Mualem-van Genuchten unsaturated conductivity with ice impedance
    ``10^(-Omega*(1 - liq))`` (reference `soil_hydraulic_properties.jl:196-221`).

    Effective saturation is clipped to [0, 1]; the unsaturated branch runs on
    ``se`` held strictly below 1, and cells with ``se <= eps`` (no liquid
    water) get an exact 0."""

    impedance: float = 7.0

    def __call__(self, hydraulics, soil: SoilVolume):
        n = hydraulics.swrc.n
        theta_w = volumetric_fractions(soil)["water"]
        theta_sat = soil.porosity
        I_ice = 10.0 ** (-self.impedance * (1.0 - soil.liquid))
        K_sat = hydraulics.sat_hydraulic_cond
        se = torch.clamp(theta_w / max(theta_sat, 1e-12), 0.0, 1.0)
        se_safe = torch.clamp(se, max=one_minus_eps(theta_w.dtype, 1e-9))
        eps_lo = float(torch.finfo(theta_w.dtype).eps)
        frozen = se <= eps_lo
        se_safe = torch.where(frozen, eps_lo, se_safe)
        inner = 1.0 - fast_pow(1.0 - fast_pow(se_safe, n / (n + 1.0)), (n - 1.0) / n)
        K_unsat = K_sat * I_ice * torch.sqrt(se_safe) * (inner * inner)
        K_unsat = torch.where(frozen, 0.0, K_unsat)
        return torch.where(se >= 1.0, K_sat * I_ice, K_unsat)


@dataclasses.dataclass(frozen=True)
class ConstantSoilHydraulics:
    """Prescribed hydraulic properties (reference
    `soil_hydraulic_properties.jl:66-97`). ``sat_hydraulic_cond`` may be a 0-d
    tensor, to differentiate with respect to it."""

    swrc: VanGenuchten = dataclasses.field(default_factory=VanGenuchten)
    unsat_hydraulic_cond: UnsatKVanGenuchten = dataclasses.field(
        default_factory=UnsatKVanGenuchten)
    sat_hydraulic_cond: float = 1.0e-5
    field_capacity_value: float = 0.25
    wilting_point_value: float = 0.05

    def hydraulic_conductivity(self, soil: SoilVolume):
        return self.unsat_hydraulic_cond(self, soil)
