"""PALADYN vegetation carbon processes, one PFT with needleleaf defaults
(counterpart of ``terrarium_tpu/processes/vegetation/vegetation.py``;
Willeit & Ganopolski 2016): LUE photosynthesis, Medlyn stomatal conductance,
autotrophic respiration, phenology (evergreen stub), carbon dynamics,
Lotka-Volterra vegetation dynamics, the static exponential root
distribution and field-capacity-limited plant-available water.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..soil.stratigraphy import volumetric_fractions
from ...constants import PhysicalConstants, partial_pressure_CO2, partial_pressure_O2
from ...variables import XY, XYZ, auxiliary, input as input_var, prognostic

__all__ = ["LUEPhotosynthesis", "MedlynStomatalConductance", "PALADYNAutotrophicRespiration",
           "PALADYNPhenology", "PALADYNCarbonDynamics", "PALADYNVegetationDynamics",
           "StaticExponentialRootDistribution", "FieldCapacityLimitedPAW", "VegetationCarbon"]

SECONDS_PER_DAY, SECONDS_PER_YEAR = 86400.0, 365.0 * 86400.0


@dataclasses.dataclass(frozen=True)
class LUEPhotosynthesis:
    """PALADYN/BIOME3 C3 light-use-efficiency photosynthesis (reference
    `photosynthesis.jl:18-430`)."""

    tau25: float = 2600.0
    Kc25: float = 30.0
    Ko25: float = 3.0e4
    q10_tau: float = 0.57
    q10_Kc: float = 2.1
    q10_Ko: float = 1.2
    alpha_leaf: float = 0.17
    alpha_a: float = 0.5
    alpha_C3: float = 0.08
    cq: float = 4.6e-6
    k_ext: float = 0.5
    T_CO2_high: float = 42.0
    T_CO2_low: float = -4.0
    T_photos_high: float = 30.0
    T_photos_low: float = 15.0
    theta_r: float = 0.7

    def variables(self):
        return (
            auxiliary("net_assimilation", XY(), units="g/m^2/s"),
            auxiliary("leaf_respiration", XY(), units="g/m^2/s"),
            auxiliary("gross_primary_production", XY(), units="kg/m^2/s"),
            input_var("soil_moisture_limiting_factor", XY(), default=1.0),
            input_var("leaf_area_index", XY()),
        )

    def kinetic_parameters(self, T_air):
        x = (T_air - 25.0) * 0.1
        return (self.tau25 * torch.pow(self.q10_tau, x), self.Kc25 * torch.pow(self.q10_Kc, x),
                self.Ko25 * torch.pow(self.q10_Ko, x))

    def PAR(self, swdown):
        return 0.5 * swdown * (1.0 - self.alpha_leaf) * self.cq

    def APAR(self, swdown, LAI):
        return self.alpha_a * self.PAR(swdown) * (1.0 - torch.exp(-self.k_ext * LAI))

    def stress_constants(self):
        """k1, k2, k3 of :meth:`temperature_stress`, in Python double."""
        k1 = 2.0 * float(np.log(1.0 / 0.99 - 1.0)) / (self.T_CO2_low - self.T_photos_low)
        k2 = 0.5 * (self.T_CO2_low + self.T_photos_low)
        k3 = float(np.log(0.99 / 0.01)) / (self.T_CO2_high - self.T_photos_high)
        return k1, k2, k3

    def temperature_stress(self, T_air):
        """Double-sigmoid temperature response (reference `photosynthesis.jl:155-186`)."""
        k1, k2, k3 = self.stress_constants()
        low = 1.0 / (1.0 + torch.exp(k1 * (k2 - T_air)))
        high = 1.0 - 0.01 * torch.exp(k3 * (T_air - self.T_photos_high))
        in_range = (T_air > self.T_CO2_low) & (T_air < self.T_CO2_high)
        return torch.where(in_range, low * high, 0.0)

    def compute(self, constants: PhysicalConstants, T_air, swdown, pres, co2, LAI, lam_c, beta):
        """Rd, An, GPP (reference `photosynthesis.jl:253-341`), 0 unless
        swdown > 0, T > -3 degC and LAI > 0."""
        pres_O2 = partial_pressure_O2(pres)
        pres_a = partial_pressure_CO2(pres, co2)
        tau, Kc, Ko = self.kinetic_parameters(T_air)
        g_star = pres_O2 / (2.0 * tau)
        APAR = self.APAR(swdown, LAI)
        PAR = self.PAR(swdown)
        pres_i = lam_c * pres_a
        T_stress = self.temperature_stress(T_air)
        c1 = self.alpha_C3 * T_stress * constants.C_mass * (pres_i - g_star) \
            / (pres_i + 2.0 * g_star)
        Kterm = pres_i + Kc * (1.0 + pres_O2 / Ko)
        c2 = (pres_i - g_star) / Kterm
        Vc_max = c1 * PAR * Kterm / (pres_i - g_star)
        Rd = self.alpha_C3 * Vc_max * beta
        JE, JC = c1 * APAR, c2 * Vc_max
        s = JE + JC
        disc = torch.clamp(s * s - 4.0 * self.theta_r * JE * JC, min=0.0)
        Ag = (s - torch.sqrt(disc)) / (2.0 * self.theta_r) * beta
        An = Ag - Rd
        active = (swdown > 0.0) & (T_air > -3.0) & (LAI > 0.0)
        Rd = torch.where(active, Rd, 0.0)
        An = torch.where(active, An, 0.0)
        return Rd, An, An * 1.0e-3

    def compute_auxiliary(self, state, grid, stomcond, constants, atmos, ctx=None) -> None:
        Rd, An, GPP = self.compute(
            constants, atmos.air_temperature(state), atmos.shortwave_down(state),
            atmos.air_pressure(state), state.inputs["CO2"], state.leaf_area_index,
            state.leaf_to_air_co2_ratio, state.soil_moisture_limiting_factor)
        state.set(leaf_respiration=Rd, net_assimilation=An, gross_primary_production=GPP)


@dataclasses.dataclass(frozen=True)
class MedlynStomatalConductance:
    """Medlyn et al. (2011) optimal stomatal conductance (reference
    `stomatal_conductance.jl:17-143`). Runs before the photosynthesis in the
    reference's order, so it reads the previous step's net assimilation."""

    g1: float = 2.3
    g_min: float = 0.5  # [mm/s]

    def variables(self):
        return (auxiliary("canopy_water_conductance", XY(), units="m/s"),
                auxiliary("leaf_to_air_co2_ratio", XY()))

    def gw_can(self, photo, vpd, An, co2, LAI, beta):
        """g0 + 1.6 (1 + g1 / sqrt(vpd)) An / co2 * 1e6 (reference
        `stomatal_conductance.jl:48-68`)."""
        g0 = (self.g_min / 1000.0) * (1.0 - torch.exp(-photo.k_ext * LAI)) * beta
        return g0 + 1.6 * (1.0 + self.g1 / torch.sqrt(vpd)) * An / co2 * 1.0e6

    def lambda_c(self, vpd):
        """1 - 1 / (1 + g1 / sqrt(vpd * 1e-3)) (reference `stomatal_conductance.jl:80-86`)."""
        return 1.0 - 1.0 / (1.0 + self.g1 / torch.sqrt(vpd * 1.0e-3))

    def compute_auxiliary(self, state, grid, photo, constants, atmos, ctx=None) -> None:
        vpd = atmos.compute_vpd(state, constants)
        state.set(canopy_water_conductance=self.gw_can(
            photo, vpd, state.net_assimilation, state.inputs["CO2"], state.leaf_area_index,
            state.soil_moisture_limiting_factor), leaf_to_air_co2_ratio=self.lambda_c(vpd))


@dataclasses.dataclass(frozen=True)
class PALADYNAutotrophicRespiration:
    """PALADYN maintenance and growth respiration (reference
    `autotrophic_respiration.jl:17-224`). ``rate_scale`` multiplies the
    resp10 terms: 1 is the reference (per-day rates in a per-second
    tendency); ``consistent_units()`` takes 1/86400."""

    cn_sapwood: float = 330.0
    cn_root: float = 29.0
    aws: float = 10.0
    resp10: float = 0.066
    rate_scale: float = 1.0

    @staticmethod
    def consistent_units(**kw) -> "PALADYNAutotrophicRespiration":
        return PALADYNAutotrophicRespiration(rate_scale=1.0 / SECONDS_PER_DAY, **kw)

    def variables(self):
        return (
            auxiliary("autotrophic_respiration", XY(), units="kg/m^2/s"),
            auxiliary("net_primary_production", XY(), units="kg/m^2/s"),
            input_var("gross_primary_production", XY(), units="kg/m^2/s"),
            input_var("daily_leaf_respiration", XY(), units="g/m^2/s"),
            input_var("phenology_factor", XY()),
            input_var("ground_temperature", XY(), default=10.0, units="degC"),
        )

    @staticmethod
    def f_temp(T):
        """exp(308.56 (1/56.02 - 1/(46.02 + T))) (reference `autotrophic_respiration.jl:54-60`)."""
        return torch.exp(308.56 * (1.0 / 56.02 - 1.0 / (46.02 + T)))

    def Rm(self, cd, T_air, T_soil, Rd, phen, C_veg):
        """R_leaf + (R_stem + R_root) * rate_scale (reference
        `autotrophic_respiration.jl:89-126`)."""
        f_air = self.f_temp(T_air)
        f_soil = torch.where(T_soil > 7.0, self.f_temp(T_soil), 0.0)
        R_stem = self.resp10 * f_air * (cd.awl * ((2.0 / cd.SLA) + cd.awl)) \
            / (C_veg * self.aws * self.cn_sapwood)
        R_root = self.resp10 * f_soil * phen * (2.0 / cd.SLA) / (cd.SLA * C_veg * self.cn_root)
        return Rd / 1000.0 + (R_stem + R_root) * self.rate_scale

    def compute_auxiliary(self, state, grid, carbon_dynamics, atmos, ctx=None) -> None:
        GPP = state.gross_primary_production
        Rm = self.Rm(carbon_dynamics, atmos.air_temperature(state), state.ground_temperature,
                     state.daily_leaf_respiration, state.phenology_factor,
                     state.carbon_vegetation)
        Ra = Rm + 0.25 * (GPP - Rm)
        state.set(autotrophic_respiration=Ra, net_primary_production=GPP - Ra)


@dataclasses.dataclass(frozen=True)
class PALADYNPhenology:
    """Evergreen phenology stub: phen = 1, f_deciduous = 0, LAI = LAI_b
    (reference `phenology.jl:16-119`)."""

    def variables(self):
        return (auxiliary("phenology_factor", XY()), auxiliary("leaf_area_index", XY()),
                input_var("balanced_leaf_area_index", XY()))

    def compute_auxiliary(self, state, grid, ctx=None) -> None:
        LAI_b = state.balanced_leaf_area_index
        phen = torch.ones_like(LAI_b)
        f_dec = 0.0
        state.set(phenology_factor=phen, leaf_area_index=(f_dec * phen + (1.0 - f_dec)) * LAI_b)


@dataclasses.dataclass(frozen=True)
class PALADYNCarbonDynamics:
    """Vegetation carbon pool (reference `carbon_dynamics.jl:19-198`).
    ``rate_scale`` multiplies the turnover rates: 1 is the reference (its
    per-year rates in a per-second tendency); ``consistent_units()`` takes
    1 / (365 * 86400)."""

    SLA: float = 10.0
    awl: float = 2.0
    LAI_min: float = 1.0
    LAI_max: float = 6.0
    gammaL: float = 0.3
    gammaR: float = 0.3
    gammaS: float = 0.05
    rate_scale: float = 1.0

    @staticmethod
    def consistent_units(**kw) -> "PALADYNCarbonDynamics":
        return PALADYNCarbonDynamics(rate_scale=1.0 / SECONDS_PER_YEAR, **kw)

    def variables(self):
        return (prognostic("carbon_vegetation", XY(), units="kg/m^2"),
                auxiliary("balanced_leaf_area_index", XY()),
                input_var("net_primary_production", XY(), units="kg/m^2/s"))

    def LAI_b(self, C_veg):
        """C_veg / (2/SLA + awl) (reference `carbon_dynamics.jl:96-99`)."""
        return C_veg / ((2.0 / self.SLA) + self.awl)

    def lambda_NPP(self, LAI_b):
        """The ramp between LAI_min and LAI_max (reference `carbon_dynamics.jl:64-74`)."""
        return torch.clamp((LAI_b - self.LAI_min) / (self.LAI_max - self.LAI_min), 0.0, 1.0)

    def litter_rate(self) -> float:
        """gL/SLA + gR/SLA + gS awl, the litterfall per unit LAI_b."""
        return self.gammaL / self.SLA + self.gammaR / self.SLA + self.gammaS * self.awl

    def litterfall(self, LAI_b):
        """(gL/SLA + gR/SLA + gS awl) LAI_b * rate_scale (reference
        `carbon_dynamics.jl:109-116`)."""
        return self.litter_rate() * LAI_b * self.rate_scale

    def compute_auxiliary(self, state, grid, ctx=None) -> None:
        state.set(balanced_leaf_area_index=self.LAI_b(state.carbon_vegetation))

    def compute_tendencies(self, state, grid, ctx=None) -> None:
        """dC/dt = (1 - lambda) NPP - litterfall (reference `carbon_dynamics.jl:126-138`)."""
        LAI_b = state.balanced_leaf_area_index
        state.add_tendencies(carbon_vegetation=(1.0 - self.lambda_NPP(LAI_b))
                             * state.net_primary_production - self.litterfall(LAI_b))


@dataclasses.dataclass(frozen=True)
class PALADYNVegetationDynamics:
    """Lotka-Volterra vegetation fraction (reference `vegetation_dynamics.jl:16-159`);
    ``rate_scale`` as in :class:`PALADYNCarbonDynamics`."""

    nu_seed: float = 0.001
    gammav_min: float = 0.002
    rate_scale: float = 1.0

    @staticmethod
    def consistent_units(**kw) -> "PALADYNVegetationDynamics":
        return PALADYNVegetationDynamics(rate_scale=1.0 / SECONDS_PER_YEAR, **kw)

    def variables(self):
        return (prognostic("vegetation_area_fraction", XY()),
                input_var("balanced_leaf_area_index", XY()),
                input_var("carbon_vegetation", XY(), units="kg/m^2"),
                input_var("net_primary_production", XY(), units="kg/m^2/s"))

    def compute_tendencies(self, state, grid, carbon_dynamics, ctx=None) -> None:
        """dnu/dt = (lambda NPP / C_veg) nu* (1 - nu) - gamma_v nu*, nu* =
        max(nu, nu_seed) (reference `vegetation_dynamics.jl:90-110`)."""
        nu = state.vegetation_area_fraction
        lam = carbon_dynamics.lambda_NPP(state.balanced_leaf_area_index)
        nu_star = torch.clamp(nu, min=self.nu_seed)
        state.add_tendencies(vegetation_area_fraction=(
            lam * state.net_primary_production / state.carbon_vegetation) * nu_star
            * (1.0 - nu) - self.gammav_min * self.rate_scale * nu_star)


@dataclasses.dataclass(frozen=True)
class StaticExponentialRootDistribution:
    """Root fraction per layer from the average of two exponentials (Zeng
    2001; reference `root_distribution.jl:16-63`): density * dz normalised
    over the column, a static auxiliary."""

    a: float = 7.0
    b: float = 2.0

    def variables(self):
        return (auxiliary("root_fraction", XYZ(), ctor=self._make_field),)

    def profile(self, vertical) -> np.ndarray:
        """The ``(Nz,)`` root fractions of a vertical grid, in float64."""
        z = vertical.z_centers
        R = 0.5 * (self.a * np.exp(self.a * z) + self.b * np.exp(self.b * z)) * vertical.dz
        return R / R.sum()

    def _make_field(self, grid, arrays):
        R = torch.as_tensor(self.profile(grid.vertical), device=grid.device)
        return R[:, None].expand(grid.nz, grid.cells)


@dataclasses.dataclass(frozen=True)
class FieldCapacityLimitedPAW:
    """Plant-available water W = clip((theta_w - wp) / (fc - wp), 0, 1) per
    layer and beta = sum_k W_k r_k (reference `plant_available_water.jl:34-62`)."""

    def variables(self):
        return (auxiliary("plant_available_water", XYZ(),
                          desc="Fraction of soil water available for root uptake"),
                auxiliary("soil_moisture_limiting_factor", XY()),
                input_var("root_fraction", XYZ(), desc="Fraction of roots in each soil layer"))

    def compute_auxiliary(self, state, grid, soil, ctx=None) -> None:
        if soil is None:
            return
        hyd, texture = soil.hydrology.hydraulic_properties, soil.strat.texture
        theta_w = volumetric_fractions(soil.strat.soil_volume(soil.biogeochem, state))["water"]
        fc, wp = hyd.field_capacity(texture), hyd.wilting_point(texture)
        W = torch.broadcast_to(torch.clamp((theta_w - wp) / (fc - wp), 0.0, 1.0),
                               (grid.nz, grid.cells))
        state.set(plant_available_water=W,
                  soil_moisture_limiting_factor=(W * state.root_fraction).sum(0))


@dataclasses.dataclass(frozen=True)
class VegetationCarbon:
    """The vegetation carbon processes, auxiliaries in the reference's
    order (`vegetation_carbon.jl:72-119`): PAW, carbon dynamics (LAI_b of the
    current carbon), phenology, stomatal conductance, photosynthesis,
    autotrophic respiration."""

    photosynthesis: LUEPhotosynthesis = LUEPhotosynthesis()
    stomatal_conductance: MedlynStomatalConductance = MedlynStomatalConductance()
    autotrophic_respiration: PALADYNAutotrophicRespiration = PALADYNAutotrophicRespiration()
    phenology: PALADYNPhenology = PALADYNPhenology()
    carbon_dynamics: PALADYNCarbonDynamics = PALADYNCarbonDynamics()
    vegetation_dynamics: Optional[PALADYNVegetationDynamics] = PALADYNVegetationDynamics()
    root_distribution: Optional[StaticExponentialRootDistribution] = \
        StaticExponentialRootDistribution()
    plant_available_water: Optional[FieldCapacityLimitedPAW] = FieldCapacityLimitedPAW()

    @staticmethod
    def consistent_units(**kw) -> "VegetationCarbon":
        """Turnover and respiration rates per second, stable over long
        sub-daily runs (an extension beyond the reference, whose raw rates
        diverge)."""
        return VegetationCarbon(
            autotrophic_respiration=PALADYNAutotrophicRespiration.consistent_units(),
            carbon_dynamics=PALADYNCarbonDynamics.consistent_units(),
            vegetation_dynamics=PALADYNVegetationDynamics.consistent_units(), **kw)

    def variables(self):
        out = ()
        for p in (self.photosynthesis, self.stomatal_conductance,
                  self.autotrophic_respiration, self.phenology, self.carbon_dynamics,
                  self.vegetation_dynamics, self.root_distribution,
                  self.plant_available_water):
            if p is not None:
                out += tuple(p.variables())
        return out

    def initialize(self, state, grid, constants, atmos, ctx=None) -> None:
        pass

    def compute_auxiliary(self, state, grid, constants, atmos, soil=None, ctx=None) -> None:
        if self.plant_available_water is not None:
            self.plant_available_water.compute_auxiliary(state, grid, soil, ctx)
        self.carbon_dynamics.compute_auxiliary(state, grid, ctx)
        self.phenology.compute_auxiliary(state, grid, ctx)
        self.stomatal_conductance.compute_auxiliary(state, grid, self.photosynthesis,
                                                    constants, atmos, ctx)
        self.photosynthesis.compute_auxiliary(state, grid, self.stomatal_conductance,
                                              constants, atmos, ctx)
        self.autotrophic_respiration.compute_auxiliary(state, grid, self.carbon_dynamics,
                                                       atmos, ctx)

    def compute_tendencies(self, state, grid, constants=None, ctx=None) -> None:
        self.carbon_dynamics.compute_tendencies(state, grid, ctx)
        if self.vegetation_dynamics is not None:
            self.vegetation_dynamics.compute_tendencies(state, grid, self.carbon_dynamics, ctx)

