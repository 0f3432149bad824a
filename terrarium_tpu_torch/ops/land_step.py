"""The LandModel column rollouts: a hand-written CUDA kernel, its plain
PyTorch version and the wrappers that pick between them by device.

:func:`land_column_rollout` applies ``ForwardEuler.pre_closure_step`` of a
:class:`LandModel` ``n`` times to the model's live carry
(``LandModel.live_carry``) and returns the new carry;
:func:`land_column_heun_rollout` does the same with ``Heun`` and
:func:`land_column_implicit_rollout` with ``ImplicitEuler`` (Thomas or PCR
solves, any number of Picard iterations). They replace
``terrarium_tpu/ops/fused_step.py::make_fused_lean_rollout`` traced over a
LandModel step of that stepper. The compositions they take
(:func:`land_composition`): bare ground (``NoCanopyInterception``,
``BareGroundEvaporation``, no vegetation) or vegetated
(``PALADYNCanopyInterception``, ``PALADYNCanopyEvapotranspiration``,
``VegetationCarbon``), over a soil of heat only (``NoFlow``) or Richards
flow with a Van Genuchten or Brooks-Corey curve and a Mualem or linear
conductivity, with or without a ``Snowpack`` (whose ``SnowCoverAlbedo``
blends a ``ConstantAlbedo``); constant or Monin-Obukhov drag, either SEB
ground-flux form, either ground-resistance factor, any water-flux scale,
drainage sign and vegetation rate scales.

The inputs the step reads (``LAND_INPUTS``) are each a :class:`LandInput`:
a static row, or a uniformly spaced series that the kernel interpolates at
each clock time from its first time (as the soil kernels do). The CUDA
sources, built by ``nvcc`` at first use, are chosen by type
(:func:`rollout_source`): ImplicitEuler (either solver, any Picard count)
and Heun over Richards flow, with or without a snowpack, run each column on
a group of lanes, ``csrc/land_column_group_rollout.cu``
(``land::GroupColumn::rollout`` in ``csrc/land_group_step.cuh``, the step
that the land group segment VJP recomputes with); every other stepper and
composition (ForwardEuler, ``NoFlow``) one thread a column,
``csrc/land_column_rollout.cu`` (the step in ``csrc/land_step.cuh``).

The plain version (:func:`land_column_rollout_plain`) is the composition of
the port's process modules: a state over the carry and the inputs, stepped
by the same stepper's ``pre_closure_step``. On CPU tensors a wrapper runs
it; on CUDA tensors it launches the kernel or raises. Each launch adds one
to the wrapper's ``launches``.

:func:`land_column_full_step` is ``make_fused_step``'s LandModel: one full
``timestepper.step`` (any of the three steppers) of a composition the
kernels take, with static inputs, every leaf of the state in and out, a
launch of ``csrc/land_column_full_step.cu`` (column code
``csrc/land_full_step.cuh``); its plain version
:func:`land_column_full_step_plain` is the port's own module step on a copy
of the state.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from . import cuda_build
from .fastpow import pow_code
from .fused_step import (SOLVER_CODES, ColumnParams, _CParams, full_step_scheme, series_value,
                         soil_flow)
from ..grids.column import ColumnGrid
from ..models.land_model import LandModel
from ..processes.atmosphere import (ConstantAerodynamics, LongShortWaveRadiation,
                                    MoninObukhovAerodynamics, PrescribedAtmosphere, RainSnow,
                                    SpecificHumidity)
from ..processes.snow import SnowCoverAlbedo, Snowpack
from ..processes.soil.hydraulics import (ConstantSoilHydraulics, SoilHydraulicsSURFEX,
                                         UnsatKLinear, UnsatKVanGenuchten)
from ..processes.soil.swrc import BrooksCorey, VanGenuchten
from ..processes.surface_energy.seb import (ConstantAlbedo, DiagnosedRadiativeFluxes,
                                            DiagnosedTurbulentFluxes, ImplicitSkinTemperature)
from ..processes.surface_hydrology.surface_hydrology import (
    BareGroundEvaporation, ConstantEvaporationResistanceFactor, DirectSurfaceRunoff,
    NoCanopyInterception, PALADYNCanopyEvapotranspiration, PALADYNCanopyInterception,
    SoilMoistureResistanceFactor)
from ..processes.vegetation.vegetation import (
    FieldCapacityLimitedPAW, LUEPhotosynthesis, MedlynStomatalConductance,
    PALADYNAutotrophicRespiration, PALADYNCarbonDynamics, PALADYNPhenology,
    PALADYNVegetationDynamics, StaticExponentialRootDistribution, VegetationCarbon)
from ..state import Clock, State, build_state
from ..timesteppers.implicit import ImplicitEuler
from ..timesteppers.stepping import ForwardEuler, Heun

__all__ = ["LAND_INPUTS", "LandInput", "LandParams", "land_composition", "carry_names",
           "land_column_rollout", "land_column_heun_rollout", "land_column_implicit_rollout",
           "land_column_rollout_plain", "launch_args", "implicit_tags", "ROLLOUTS",
           "group_scheme", "rollout_source", "rollout_group", "group_occupancy",
           "LAND_FULL_AUX", "land_full_composition", "land_full_step_buffers",
           "land_full_step_operands",
           "land_column_full_step", "land_column_full_step_plain"]

_NAME = "land_column_rollout"  # csrc/land_column_rollout.cu
_GROUP_NAME = "land_column_group_rollout"  # csrc/land_column_group_rollout.cu

#: the inputs the land step reads, in the kernel's order (land_step.cuh IN_*)
LAND_INPUTS = ("air_temperature", "surface_shortwave_down", "surface_longwave_down",
               "rainfall", "windspeed", "air_pressure", "specific_humidity", "CO2", "SAI",
               "daily_leaf_respiration", "snowfall")

_VEGETATION = {"photosynthesis": LUEPhotosynthesis,
               "stomatal_conductance": MedlynStomatalConductance,
               "autotrophic_respiration": PALADYNAutotrophicRespiration,
               "phenology": PALADYNPhenology, "carbon_dynamics": PALADYNCarbonDynamics,
               "vegetation_dynamics": PALADYNVegetationDynamics,
               "root_distribution": StaticExponentialRootDistribution,
               "plant_available_water": FieldCapacityLimitedPAW}


def _require(ok: bool, what: str, got) -> None:
    if not ok:
        raise ValueError(f"the land column kernel runs {what}; got {got}")


def _name(x) -> str:
    return type(x).__name__


def land_composition(model) -> tuple:
    """The kernel instantiation's tags of ``model``: ``("bare" | "veg",
    "noflow")`` or ``(..., "richards", "vg" | "bc", "mualem" | "linear")``,
    with ``"snow"`` appended under a ``Snowpack``. Raises ``ValueError``
    naming what the kernel runs for anything else; each attribute is read
    only after its owner's class is checked."""
    _require(isinstance(model, LandModel), "a LandModel", _name(model))
    flow = soil_flow(model.soil)
    atm = model.atmosphere
    _require(type(atm) is PrescribedAtmosphere and type(atm.precip) is RainSnow
             and type(atm.radiation) is LongShortWaveRadiation
             and type(atm.humidity) is SpecificHumidity
             and isinstance(atm.aerodynamics, (ConstantAerodynamics, MoninObukhovAerodynamics)),
             "PrescribedAtmosphere with ConstantAerodynamics or MoninObukhovAerodynamics", atm)
    seb = model.surface_energy_balance
    for part, cls in (("skin_temperature", ImplicitSkinTemperature),
                      ("radiative_fluxes", DiagnosedRadiativeFluxes),
                      ("turbulent_fluxes", DiagnosedTurbulentFluxes)):
        _require(type(getattr(seb, part)) is cls, f"SurfaceEnergyBalance with {cls.__name__}",
                 f"{part}={_name(getattr(seb, part))}")
    snow = model.snow
    _require(snow is None or type(snow) is Snowpack, "no snowpack or a Snowpack", _name(snow))
    alb = seb.albedo
    if snow is None:
        _require(type(alb) is ConstantAlbedo, "ConstantAlbedo without a snowpack", _name(alb))
    else:
        base = alb.base if type(alb) is SnowCoverAlbedo else None
        _require(type(base) is ConstantAlbedo,
                 "SnowCoverAlbedo over ConstantAlbedo under a snowpack", _name(alb))
    sh = model.surface_hydrology
    _require(type(sh.surface_runoff) is DirectSurfaceRunoff, "DirectSurfaceRunoff",
             _name(sh.surface_runoff))
    veg = model.vegetation
    if veg is None:
        _require(type(sh.canopy_interception) is NoCanopyInterception
                 and type(sh.evapotranspiration) is BareGroundEvaporation,
                 "NoCanopyInterception with BareGroundEvaporation without vegetation",
                 f"{_name(sh.canopy_interception)} with {_name(sh.evapotranspiration)}")
    else:
        _require(type(veg) is VegetationCarbon, "VegetationCarbon", _name(veg))
        for part, cls in _VEGETATION.items():
            _require(type(getattr(veg, part)) is cls, f"VegetationCarbon with {cls.__name__}",
                     f"{part}={_name(getattr(veg, part))}")
        _require(type(sh.canopy_interception) is PALADYNCanopyInterception
                 and type(sh.evapotranspiration) is PALADYNCanopyEvapotranspiration,
                 "PALADYNCanopyInterception with PALADYNCanopyEvapotranspiration under "
                 "vegetation",
                 f"{_name(sh.canopy_interception)} with {_name(sh.evapotranspiration)}")
    gr = sh.evapotranspiration.ground_resistance
    _require(type(gr) in (ConstantEvaporationResistanceFactor, SoilMoistureResistanceFactor),
             "ConstantEvaporationResistanceFactor or SoilMoistureResistanceFactor", _name(gr))
    tags = ("bare" if veg is None else "veg",)
    snow_tag = () if snow is None else ("snow",)
    if flow == "heat":
        return tags + ("noflow",) + snow_tag
    hp = model.soil.hydrology.hydraulic_properties
    swrc, cond = hp.swrc, hp.unsat_hydraulic_cond
    _require(type(swrc) in (VanGenuchten, BrooksCorey)
             and (type(cond) is UnsatKLinear
                  or (type(cond) is UnsatKVanGenuchten and type(swrc) is VanGenuchten)),
             "Richards flow with VanGenuchten and UnsatKVanGenuchten or UnsatKLinear, or "
             "BrooksCorey and UnsatKLinear", f"{_name(swrc)} and {_name(cond)}")
    return tags + ("richards", "vg" if type(swrc) is VanGenuchten else "bc",
                   "mualem" if type(cond) is UnsatKVanGenuchten else "linear") + snow_tag


_LAND_FLOATS = (
    "min_windspeed", "C_h", "mo_z", "mo_ln_m", "mo_ln_h", "kappa", "kappa_g", "kappa2", "T_ref",
    "eps_mol", "one_minus_eps_mol",
    "albedo", "eps_sigma", "one_minus_emis", "c_a_rho_a", "L_rho_a", "two_kappa_s",
    "max_delta",
    "alpha_int", "neg_k_ext_int", "w_can_max", "tau_w", "C_can", "water_flux_scale", "eps_nf",
    "beta_factor", "field_capacity", "pi", "tau_r", "drain_sign",
    "wilting_point", "fc_minus_wp", "lai_den", "LAI_min", "LAI_span", "litter_rate",
    "carbon_rate_scale", "nu_seed", "gv_rate", "resp10", "stem_const", "aws", "cn_sapwood",
    "two_over_SLA", "SLA", "cn_root", "resp_rate_scale", "inv_56_02", "g0_coef",
    "neg_k_ext_ph", "g1", "tau25", "Kc25", "Ko25", "q10_tau", "q10_Kc", "q10_Ko",
    "one_minus_alpha_leaf", "cq", "alpha_a", "alpha_C3", "C_mass", "k1", "k2", "k3",
    "T_photos_high", "T_CO2_low", "T_CO2_high", "four_theta_r", "two_theta_r",
    "bc_theta_res", "bc_span", "bc_neg_psi_s", "bc_psi_min", "p_bc", "bc_id_coef", "p_bc_id",
    "ddf", "T_melt", "swe_half", "albedo_snow", "emissivity_snow", "emissivity_base", "sigma")
_LAND_INTS = ("num_bc", "den_bc", "num_bc_id", "den_bc_id", "mo_drag", "mo_iterations",
              "consistent_G", "beta_soil")


@dataclasses.dataclass(frozen=True)
class LandParams:
    """What the land kernel takes of a model: the instantiation's ``tags``,
    the soil's :class:`ColumnParams`, and ``values``, the land step's
    numbers (``_LAND_FLOATS``, ``_LAND_INTS``), each formed in Python
    double as the modules form it and rounded to the working type once in
    the kernel (the products of two parameters, ``log(z / z0)``, the
    temperature-stress constants). ``model`` is the model itself, whose
    modules the plain version steps; it is not passed to the kernel."""

    model: Any
    tags: tuple
    soil: ColumnParams
    values: Dict[str, float]

    @staticmethod
    def of(model, dtype: torch.dtype) -> "LandParams":
        """Raises ``ValueError`` for a composition the kernel does not run
        (:func:`land_composition`)."""
        tags = land_composition(model)
        veg, richards = tags[0] == "veg", tags[1] == "richards"
        c, soil = model.constants, model.soil
        v: Dict[str, float] = dict.fromkeys(_LAND_FLOATS, 0.0)
        v.update(dict.fromkeys(_LAND_INTS, 0))
        atm, seb = model.atmosphere, model.surface_energy_balance
        aero, alb, skin = atm.aerodynamics, seb.albedo, seb.skin_temperature
        if model.snow is not None:
            sp, snow_alb, alb = model.snow, alb, alb.base
            v.update(ddf=sp.degree_day_factor, T_melt=sp.T_melt, swe_half=sp.swe_half,
                     albedo_snow=snow_alb.albedo_snow, emissivity_snow=snow_alb.emissivity_snow,
                     emissivity_base=alb.emissivity_value, sigma=c.sigma)
        et, ro = model.surface_hydrology.evapotranspiration, model.surface_hydrology.surface_runoff
        v.update(min_windspeed=atm.min_windspeed, kappa=c.kappa, kappa_g=c.kappa * c.g,
                 kappa2=c.kappa ** 2, T_ref=c.T_ref, eps_mol=c.eps, one_minus_eps_mol=1.0 - c.eps,
                 albedo=alb.albedo_value, eps_sigma=alb.emissivity_value * c.sigma,
                 one_minus_emis=1.0 - alb.emissivity_value, c_a_rho_a=c.c_a * c.rho_a,
                 L_rho_a=c.L_lg * c.rho_a, two_kappa_s=2.0 * skin.kappa_s,
                 max_delta=skin.max_delta, water_flux_scale=et.water_flux_scale,
                 eps_nf=math.sqrt(torch.finfo(dtype).eps), pi=math.pi, tau_r=ro.tau_r,
                 drain_sign=-1.0 if ro.consistent_drainage else 1.0,
                 consistent_G=int(seb.ground_flux_form == "consistent"))
        if isinstance(aero, MoninObukhovAerodynamics):
            v.update(mo_drag=1, mo_iterations=aero.iterations, mo_z=aero.z,
                     mo_ln_m=math.log(aero.z / aero.z0m), mo_ln_h=math.log(aero.z / aero.z0h))
        else:
            v.update(C_h=aero.C_h)
        hp, texture = soil.hydrology.hydraulic_properties, soil.strat.texture
        if isinstance(et.ground_resistance, SoilMoistureResistanceFactor):
            v.update(beta_soil=1, field_capacity=hp.field_capacity(texture))
        else:
            v.update(beta_factor=et.ground_resistance.factor)
        if veg:
            ci, vc = model.surface_hydrology.canopy_interception, model.vegetation
            ph, sc, ar = vc.photosynthesis, vc.stomatal_conductance, vc.autotrophic_respiration
            cd, vd = vc.carbon_dynamics, vc.vegetation_dynamics
            fc, wp = hp.field_capacity(texture), hp.wilting_point(texture)
            k1, k2, k3 = ph.stress_constants()
            v.update(
                alpha_int=ci.alpha_int, neg_k_ext_int=-ci.k_ext, w_can_max=ci.w_can_max,
                tau_w=ci.tau_w, C_can=et.C_can, wilting_point=wp, fc_minus_wp=fc - wp,
                lai_den=(2.0 / cd.SLA) + cd.awl, LAI_min=cd.LAI_min,
                LAI_span=cd.LAI_max - cd.LAI_min, litter_rate=cd.litter_rate(),
                carbon_rate_scale=cd.rate_scale, nu_seed=vd.nu_seed,
                gv_rate=vd.gammav_min * vd.rate_scale, resp10=ar.resp10,
                stem_const=cd.awl * ((2.0 / cd.SLA) + cd.awl), aws=ar.aws,
                cn_sapwood=ar.cn_sapwood, two_over_SLA=2.0 / cd.SLA, SLA=cd.SLA,
                cn_root=ar.cn_root, resp_rate_scale=ar.rate_scale, inv_56_02=1.0 / 56.02,
                g0_coef=sc.g_min / 1000.0, neg_k_ext_ph=-ph.k_ext, g1=sc.g1, tau25=ph.tau25,
                Kc25=ph.Kc25, Ko25=ph.Ko25, q10_tau=ph.q10_tau, q10_Kc=ph.q10_Kc,
                q10_Ko=ph.q10_Ko, one_minus_alpha_leaf=1.0 - ph.alpha_leaf, cq=ph.cq,
                alpha_a=ph.alpha_a, alpha_C3=ph.alpha_C3, C_mass=c.C_mass, k1=k1, k2=k2, k3=k3,
                T_photos_high=ph.T_photos_high, T_CO2_low=ph.T_CO2_low,
                T_CO2_high=ph.T_CO2_high, four_theta_r=4.0 * ph.theta_r,
                two_theta_r=2.0 * ph.theta_r)
        if richards and isinstance(hp.swrc, BrooksCorey):
            swrc, por = hp.swrc, soil.strat.bulk_porosity(soil.biogeochem)
            v.update(bc_theta_res=swrc.theta_res, bc_span=por - swrc.theta_res,
                     bc_neg_psi_s=-swrc.psi_s, bc_psi_min=swrc.psi_min, p_bc=-1.0 / swrc.lam,
                     bc_id_coef=swrc.psi_s / swrc.lam, p_bc_id=-1.0 / swrc.lam - 1.0)
            v["num_bc"], v["den_bc"] = pow_code(v["p_bc"])
            v["num_bc_id"], v["den_bc_id"] = pow_code(v["p_bc_id"])
        return LandParams(model=model, tags=tags,
                          soil=ColumnParams.of_soil(soil, c, model.grid, dtype, richards),
                          values=v)


def _c_land_params(ftype):
    class _CLandParams(ctypes.Structure):
        """C layout of ``LandColumnParams<T>`` in ``csrc/land_step.cuh``: the
        soil's parameters, the land step's numbers in the working type, the
        integer knobs."""

        _fields_ = ([("soil", _CParams)] + [(n, ftype) for n in _LAND_FLOATS]
                    + [(n, ctypes.c_int) for n in _LAND_INTS])

    return _CLandParams


_CLAND = {torch.float32: _c_land_params(ctypes.c_float),
          torch.float64: _c_land_params(ctypes.c_double)}


class _CLandInputs(ctypes.Structure):
    """C layout of ``LandInputs``."""

    _fields_ = [("ptr", ctypes.c_void_p * len(LAND_INPUTS)),
                ("row_stride", ctypes.c_longlong * len(LAND_INPUTS)),
                ("cell_stride", ctypes.c_longlong * len(LAND_INPUTS)),
                ("rows", ctypes.c_int * len(LAND_INPUTS)),
                ("t0", ctypes.c_double * len(LAND_INPUTS)),
                ("dts", ctypes.c_double * len(LAND_INPUTS))]


_CARRY = ("U", "sat", "S", "Ts", "w", "C", "nu", "An", "swe")
_CARRY_OF = {"internal_energy": "U", "saturation_water_ice": "sat",
             "surface_excess_water": "S", "skin_temperature": "Ts", "canopy_water": "w",
             "carbon_vegetation": "C", "vegetation_area_fraction": "nu",
             "net_assimilation": "An", "snow_water_equivalent": "swe"}


class _CLandCarry(ctypes.Structure):
    """C layout of ``LandCarry``."""

    _fields_ = [(n, ctypes.c_void_p) for n in _CARRY]


@dataclasses.dataclass(frozen=True)
class LandInput:
    """One input as the land step reads it: ``values`` ``(rows,)`` (one
    value for every cell) or ``(rows, cells)``; with one row a static value,
    with more a uniform series at the times ``t0 + r * dts``, read at each
    clock time as :class:`~terrarium_tpu_torch.ops.fused_step.SeriesBC` is."""

    values: torch.Tensor
    t0: float = 0.0
    dts: float = 1.0

    @property
    def rows(self) -> int:
        return self.values.shape[0]


def carry_names(params: LandParams) -> tuple:
    """The carry the rollout takes: the model's live carry, and under
    ``NoFlow`` the saturation, read and never written."""
    names = params.model.live_carry
    if params.tags[1] == "noflow":
        names = names + ("saturation_water_ice",)
    return names


def _check(carry, inputs, root_fraction, coords, params):
    names = carry_names(params)
    if set(carry) != set(names):
        raise ValueError(f"the land rollout takes the carry {names}, got {tuple(carry)}")
    U = carry["internal_energy"]
    nz, cells = U.shape
    if U.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"land column rollout takes float32 or float64, got {U.dtype}")
    for name, t in carry.items():
        shape = (nz, cells) if name in ("internal_energy", "saturation_water_ice") else (cells,)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    for name, t, shape in (("dz", coords[0], (nz,)), ("dz_faces", coords[1], (nz + 1,)),
                           ("z_centers", coords[2], (nz,)), ("z_faces", coords[3], (nz + 1,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    extra = set(inputs) - set(LAND_INPUTS)
    if extra:
        raise ValueError(f"the land step reads the inputs {LAND_INPUTS}; got {sorted(extra)}")
    for name, inp in inputs.items():
        v = inp.values
        if v.dim() not in (1, 2) or v.shape[0] < 1 or (v.dim() == 2 and v.shape[1] != cells):
            raise ValueError(f"input {name} must be (rows,) or (rows, {cells}), got "
                             f"{tuple(v.shape)}")
    veg = params.tags[0] == "veg"
    if veg and (root_fraction is None or tuple(root_fraction.shape) != (nz, cells)):
        raise ValueError(f"the vegetated land rollout takes a ({nz}, {cells}) root fraction")
    tensors = [*carry.values(), *coords, *(i.values for i in inputs.values())]
    if veg:
        tensors.append(root_fraction)
    for t in tensors:
        if t.dtype != U.dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs {U.dtype}")
        if t.device != U.device:
            raise ValueError(f"device mismatch: {t.device} vs {U.device}")


class _Series:
    """The series inputs as an input source: ``update_inputs`` sets each at
    the state's clock time, so that every ``update_state`` of a step, Heun's
    stage at t + dt among them, reads its own time."""

    def __init__(self, series):
        self.series = series

    def update_inputs(self, state) -> None:
        for name, values, t0, dts in self.series:
            state.inputs[name] = torch.broadcast_to(
                series_value(values, state.clock.time, t0, dts), state.inputs[name].shape)


def _stepper(stepper: str, solver: Optional[str], picard_iters: int = 1):
    if stepper == "euler":
        return ForwardEuler()
    if stepper == "heun":
        return Heun()
    if stepper == "implicit":
        return ImplicitEuler(solver=solver, picard_iters=picard_iters)
    raise ValueError(f"the land rollout steps with 'euler', 'heun' or 'implicit', not "
                     f"{stepper!r}")


def land_column_rollout_plain(carry: Dict[str, torch.Tensor], inputs: Dict[str, LandInput],
                              root_fraction: Optional[torch.Tensor], dz, dz_faces, z_centers,
                              z_faces, params: LandParams, dt: float, time: float, steps: int,
                              stepper: str = "euler", solver: Optional[str] = None,
                              picard_iters: int = 1):
    """Plain PyTorch version of the kernels: the model's process modules on
    a state over ``carry`` (``{name: tensor}``, the live carry and under
    ``NoFlow`` the saturation), the static inputs and the root fraction,
    stepped ``steps`` times from the clock time ``time`` by the
    ``pre_closure_step`` of ``stepper`` (``"euler"``, ``"heun"`` or
    ``"implicit"`` with ``solver`` and ``picard_iters`` Picard
    iterations), the series
    inputs set at each clock time by each ``update_state``. Inputs not given
    keep their declared defaults. The coordinates are the model's (the
    grid's); they are taken for the wrappers' signature. Returns the new
    live carry as a dict."""
    U = carry["internal_energy"]
    base = params.model
    grid = ColumnGrid(U.shape[1], base.grid.vertical, U.dtype, U.device)
    model = dataclasses.replace(base, grid=grid)
    state = build_state(model.collated_variables(), grid, Clock(
        torch.tensor(time, dtype=U.dtype, device=U.device),
        torch.zeros((), dtype=torch.int64 if U.dtype == torch.float64 else torch.int32,
                    device=U.device)))
    state.set(**carry)
    if root_fraction is not None:
        state.set(root_fraction=root_fraction)
    series = []
    for name, inp in inputs.items():
        if name not in state.inputs:
            continue
        if inp.rows == 1:
            state.inputs[name] = torch.broadcast_to(inp.values[0], (grid.cells,)).clone()
        else:
            series.append((name, inp.values, torch.tensor(inp.t0, dtype=U.dtype, device=U.device),
                           torch.tensor(inp.dts, dtype=U.dtype, device=U.device)))
    ctx = model.make_context()
    step, sources = _stepper(stepper, solver, picard_iters), (_Series(series),)
    for _ in range(steps):
        step.pre_closure_step(model, state, ctx, sources, dt)
    return {n: state[n] for n in model.live_carry}


def _argtypes(dtype) -> list:
    return ([ctypes.POINTER(_CLandCarry)] * 2
            + [ctypes.POINTER(_CLandInputs), ctypes.c_void_p, ctypes.c_longlong,
               ctypes.c_longlong] + [ctypes.c_void_p] * 4
            + [ctypes.POINTER(_CLAND[dtype]), ctypes.c_int, ctypes.c_double, ctypes.c_double,
               ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def group_scheme(params: LandParams, stepper: str) -> bool:
    """Whether the land kernels of ``stepper`` over the composition of
    ``params`` run each column on a group of lanes: ImplicitEuler (either
    solver, any Picard count) or Heun over Richards flow, with or without a
    snowpack."""
    return stepper in ("implicit", "heun") and params.tags[1] == "richards"


def rollout_source(params: LandParams, stepper: str) -> str:
    """The CUDA source of the land rollout of ``stepper`` over the
    composition of ``params``: the group kernel's where
    :func:`group_scheme`, the one-thread kernel's for any other."""
    return _GROUP_NAME if group_scheme(params, stepper) else _NAME


def group_occupancy(source: str, dtype: torch.dtype, nz: int, tags: tuple,
                    solver: Optional[str]) -> tuple:
    """``(resident warps an SM, G)`` of the kernel of ``solver`` (None for
    Heun's, which solves nothing) in the entry of ``tags`` (the stepper's
    and the composition's) of the land group source ``source`` at ``dtype``
    and depth ``nz`` (its ``_warps`` function,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; built at first
    use)."""
    fn = cuda_build.entry(source, dtype, nz, [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                          tags=tags, suffix="_warps")
    group = ctypes.c_int(0)
    warps = fn(SOLVER_CODES.get(solver, 0), ctypes.byref(group))
    if warps < 0:
        raise RuntimeError(f"the occupancy query of {source} failed")
    return warps, group.value


def rollout_group(dtype: torch.dtype, nz: int, tags: tuple, solver: Optional[str]) -> tuple:
    """``(resident warps an SM, G)`` of the group rollout kernel
    (:func:`group_occupancy`)."""
    return group_occupancy(_GROUP_NAME, dtype, nz, tags, solver)


def _rollout(wrapper, stepper_tags, carry, inputs, root_fraction, coords, params, dt, time,
             steps, stepper, solver, picard_iters=1, group=None):
    """Check the operands; run the plain version on CPU tensors, else launch
    the instantiation ``stepper_tags + params.tags`` of the source
    :func:`rollout_source` names (the group kernel's at G ``group`` where
    given: its ``g<G>`` build where the kernel's own G is another) and
    count the launch on ``wrapper``; return the new carry."""
    if group is not None and not group_scheme(params, stepper):
        raise ValueError(f"a group size is the group rollout's (ImplicitEuler or Heun over "
                         f"Richards flow), not {stepper!r} over {params.tags}")
    _check(carry, inputs, root_fraction, coords, params)
    if steps < 0:
        raise ValueError("steps must be >= 0")
    U = carry["internal_energy"]
    if U.device.type == "cpu":
        return land_column_rollout_plain(carry, inputs, root_fraction, *coords, params, dt,
                                         time, steps, stepper=stepper, solver=solver,
                                         picard_iters=picard_iters)
    if U.device.type != "cuda":
        raise ValueError(f"land column rollout runs on cpu or cuda, not {U.device}")
    for t in (*carry.values(), *coords):
        if not t.is_contiguous():
            raise ValueError("the land column kernel takes contiguous carry and coordinates")
    tags = tuple(stepper_tags) + params.tags
    if group is not None and group != rollout_group(U.dtype, U.shape[0], tags, solver)[1]:
        tags += (f"g{group}",)
    fn = cuda_build.entry(rollout_source(params, stepper), U.dtype, U.shape[0],
                          _argtypes(U.dtype), tags=tags)
    out = {n: torch.empty_like(carry[n]) for n in params.model.live_carry}
    args, keep = launch_args(carry, out, inputs, root_fraction, coords, params)
    err = fn(*args, steps, float(time), float(dt), U.shape[1], SOLVER_CODES.get(solver, 0),
             int(picard_iters), torch.cuda.current_stream(U.device).cuda_stream)
    del keep
    if err != 0:
        raise RuntimeError(f"land column kernel launch failed: cudaError {err}")
    wrapper.launches += 1
    return out


def land_column_rollout(carry: Dict[str, torch.Tensor], inputs: Dict[str, LandInput],
                        root_fraction: Optional[torch.Tensor], dz, dz_faces, z_centers, z_faces,
                        params: LandParams, dt: float, time: float, steps: int):
    """ForwardEuler over a LandModel: ``steps`` fused steps on ``carry`` from
    the clock time ``time``; returns the new live carry (a dict). CPU
    tensors take :func:`land_column_rollout_plain`; CUDA tensors launch the
    kernel of ``params.tags``. ``root_fraction`` is the ``(Nz, cells)``
    field of the vegetated model (``None`` for bare ground); an input left
    out of ``inputs`` reads 0."""
    return _rollout(land_column_rollout, (), carry, inputs, root_fraction,
                    (dz, dz_faces, z_centers, z_faces), params, dt, time, steps, "euler", None)


def land_column_heun_rollout(carry: Dict[str, torch.Tensor], inputs: Dict[str, LandInput],
                             root_fraction: Optional[torch.Tensor], dz, dz_faces, z_centers,
                             z_faces, params: LandParams, dt: float, time: float, steps: int,
                             group: Optional[int] = None):
    """Heun over a LandModel, as :func:`land_column_rollout` (the kernel's
    ``heun`` instantiation; each step reads the inputs at t and t + dt).
    ``group``: the group rollout at that G, as
    :func:`land_column_implicit_rollout` takes it."""
    return _rollout(land_column_heun_rollout, ("heun",), carry, inputs, root_fraction,
                    (dz, dz_faces, z_centers, z_faces), params, dt, time, steps, "heun", None,
                    1, group)


def implicit_tags(solver: str, picard_iters: int) -> tuple:
    """The stepper tags of the land kernels' ImplicitEuler instantiation:
    ``("implicit", solver)`` for one Picard iteration, ``("implicit",
    "picard")`` for more (``land::picard_step``, which takes the count and
    the solver at run time). Raises ``ValueError`` for another solver or a
    count that is not a positive integer."""
    if solver not in ("pcr", "thomas"):
        raise ValueError(f"the implicit land step solves by 'pcr' or 'thomas', not {solver!r}")
    if int(picard_iters) != picard_iters or picard_iters < 1:
        raise ValueError(f"picard_iters must be a positive integer, got {picard_iters!r}")
    return ("implicit", solver) if picard_iters == 1 else ("implicit", "picard")


def land_column_implicit_rollout(carry: Dict[str, torch.Tensor], inputs: Dict[str, LandInput],
                                 root_fraction: Optional[torch.Tensor], dz, dz_faces, z_centers,
                                 z_faces, params: LandParams, dt: float, time: float, steps: int,
                                 solver: str = "pcr", picard_iters: int = 1,
                                 group: Optional[int] = None):
    """ImplicitEuler with ``picard_iters`` Picard iterations over a
    LandModel, as :func:`land_column_rollout` (``solver`` ``"pcr"`` or
    ``"thomas"``; the kernel's instantiation of :func:`implicit_tags`).
    ``group``: the group rollout at that G (the land gradient's forward
    segments take the segment VJP's, so that the carries the VJP stores
    are theirs bit for bit); read on CUDA tensors only."""
    tags = implicit_tags(solver, picard_iters)
    return _rollout(land_column_implicit_rollout, tags, carry, inputs, root_fraction,
                    (dz, dz_faces, z_centers, z_faces), params, dt, time, steps, "implicit",
                    solver, int(picard_iters), group)


#: the wrapper of each stepper
ROLLOUTS = {"euler": land_column_rollout, "heun": land_column_heun_rollout,
            "implicit": land_column_implicit_rollout}


def launch_args(carry, out, inputs, root_fraction, coords, params: LandParams):
    """The entry point's arguments up to the parameters (the carry in and
    out, the inputs, the root fraction and its strides, the coordinates,
    the parameters), and the tensors and structs they point into, to be
    kept alive over the call. An input left out reads 0."""
    U = carry["internal_energy"]
    c_in = _CLandCarry(**{_CARRY_OF[n]: t.data_ptr() for n, t in carry.items()})
    c_out = _CLandCarry(**{_CARRY_OF[n]: t.data_ptr() for n, t in out.items()})
    zero = torch.zeros(1, dtype=U.dtype, device=U.device)
    c_inputs = _CLandInputs()
    for i, name in enumerate(LAND_INPUTS):
        inp = inputs.get(name, LandInput(zero))
        v = inp.values
        c_inputs.ptr[i] = v.data_ptr()
        c_inputs.row_stride[i] = v.stride(0)
        c_inputs.cell_stride[i] = v.stride(1) if v.dim() == 2 else 0
        c_inputs.rows[i] = v.shape[0]
        c_inputs.t0[i], c_inputs.dts[i] = inp.t0, inp.dts
    root = root_fraction if root_fraction is not None else zero[None, :]
    strides = (root.stride(0), root.stride(1)) if root_fraction is not None else (0, 0)
    params_c = _CLAND[U.dtype](soil=_CParams.of(params.soil), **params.values)
    args = (ctypes.byref(c_in), ctypes.byref(c_out), ctypes.byref(c_inputs), root.data_ptr(),
            *strides, *(c.data_ptr() for c in coords), ctypes.byref(params_c))
    return args, (c_in, c_out, c_inputs, zero, params_c)


for _fn in ROLLOUTS.values():
    _fn.launches = 0


# ---------------------------------------------------------------------------
# one full step (make_fused_step)
# ---------------------------------------------------------------------------
_FULL_NAME = "land_column_full_step"  # csrc/land_column_full_step.cu

#: the auxiliaries the land full step writes besides the net assimilation,
#: in the order of ``AUX_*`` in ``csrc/land_full_step.cuh``
LAND_FULL_AUX = (
    "temperature", "liquid_water_fraction", "pressure_head", "ground_temperature",
    "hydraulic_conductivity", "water_table", "plant_available_water",
    "soil_moisture_limiting_factor", "leaf_respiration", "gross_primary_production",
    "canopy_water_conductance", "leaf_to_air_co2_ratio", "autotrophic_respiration",
    "net_primary_production", "phenology_factor", "leaf_area_index",
    "balanced_leaf_area_index", "snow_cover_fraction", "snow_melt",
    "canopy_water_interception", "canopy_water_removal", "saturation_canopy_water",
    "rainfall_ground", "evaporation_canopy", "evaporation_ground", "transpiration",
    "surface_runoff", "infiltration", "ground_heat_flux", "surface_shortwave_up",
    "surface_longwave_up", "surface_net_radiation", "sensible_heat_flux", "latent_heat_flux")
_FULL_RICHARDS_AUX = ("pressure_head", "water_table")
_FULL_VEG_AUX = ("plant_available_water", "soil_moisture_limiting_factor", "leaf_respiration",
                 "gross_primary_production", "canopy_water_conductance",
                 "leaf_to_air_co2_ratio", "autotrophic_respiration", "net_primary_production",
                 "phenology_factor", "leaf_area_index", "balanced_leaf_area_index",
                 "canopy_water_interception", "canopy_water_removal",
                 "saturation_canopy_water", "evaporation_canopy", "transpiration")
_FULL_SNOW_AUX = ("snow_cover_fraction", "snow_melt")


class _CLandFullStepIO(ctypes.Structure):
    """C layout of ``LandFullStepIO`` (``csrc/land_full_step.cuh``)."""

    _fields_ = ([("in_", _CLandCarry), ("out", _CLandCarry), ("tend", _CLandCarry)]
                + [(n, ctypes.c_void_p) for n in ("T", "liq", "psi", "ground_T")]
                + [("aux", ctypes.c_void_p * len(LAND_FULL_AUX))])


def land_full_composition(model) -> tuple:
    """The full-step kernel's composition tags of ``model``:
    :func:`land_composition`'s, with, under ``NoFlow``, the conductivity of
    the face K that the state holds inserted after ``"noflow"``
    (``"linear"``, or ``"mualem"`` over ``VanGenuchten``). Raises
    ``ValueError`` for anything else."""
    tags = land_composition(model)
    if tags[1] != "noflow":
        return tags
    hp = model.soil.hydrology.hydraulic_properties
    _require(isinstance(hp, (ConstantSoilHydraulics, SoilHydraulicsSURFEX))
             and (type(hp.unsat_hydraulic_cond) is UnsatKLinear
                  or (type(hp.unsat_hydraulic_cond) is UnsatKVanGenuchten
                      and type(hp.swrc) is VanGenuchten)),
             "NoFlow over ConstantSoilHydraulics or SoilHydraulicsSURFEX with UnsatKLinear, or "
             "UnsatKVanGenuchten and VanGenuchten, in a full step", _name(hp))
    cond = "linear" if type(hp.unsat_hydraulic_cond) is UnsatKLinear else "mualem"
    return tags[:2] + (cond,) + tags[2:]


def _full_aux_written(tags) -> tuple:
    """The auxiliaries the full-step kernel of ``tags`` writes, besides the
    net assimilation."""
    skip = (() if tags[1] == "richards" else _FULL_RICHARDS_AUX) + (
        () if tags[0] == "veg" else _FULL_VEG_AUX) + (() if "snow" in tags else _FULL_SNOW_AUX)
    return tuple(n for n in LAND_FULL_AUX if n not in skip)


def _full_argtypes(dtype) -> list:
    return ([ctypes.POINTER(_CLandFullStepIO), ctypes.POINTER(_CLandInputs), ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_void_p] * 4
            + [ctypes.POINTER(_CLAND[dtype]), ctypes.c_double, ctypes.c_longlong, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p])


#: the stepper tags of the full-step kernel's instantiations
_FULL_STEPPER_TAGS = {"euler": (), "heun": ("heun",), "implicit": ("implicit",)}


def land_full_step_buffers(model, state: State):
    """The full-step kernel's operands for ``state`` up to the parameters,
    on the state's device: ``(tags, args, keep, out)``, the instantiation's
    composition tags, the arguments of the entry point from the IO struct to
    the parameters (IO, inputs, root fraction and its strides, coordinates,
    parameters), what they point into (to be kept alive over the call), and
    the tensors the kernel fills: ``out["prognostic"]``, ``["tendencies"]``
    and ``["auxiliary"]``, each keyed by the state's names (the net
    assimilation among the auxiliaries). The inputs are the state's,
    static. Raises ``ValueError`` for a state that misses a leaf the kernel
    reads or holds one it neither writes nor passes through."""
    tags = land_full_composition(model)
    U = state.prognostic["internal_energy"]
    nz, cells = U.shape
    dtype, device = U.dtype, U.device
    params = LandParams.of(model, dtype)
    if tags[1] == "noflow":  # the face K of the state's conductivity
        params = dataclasses.replace(params, soil=ColumnParams.of_soil(
            model.soil, model.constants, model.grid, dtype, True))
    richards, veg = tags[1] == "richards", tags[0] == "veg"
    carry = {n: state[n].contiguous() for n in carry_names(params)}
    stored = {k: state[n].contiguous() for k, n in (
        ("T", "temperature"), ("liq", "liquid_water_fraction"),
        ("ground_T", "ground_temperature"), *((("psi", "pressure_head"),) if richards else ()))}
    written = _full_aux_written(tags)
    passed = ("root_fraction",) * veg + (() if richards else ("saturation_water_ice",
                                                             "water_table"))
    extra = set(state.auxiliary) - set(written) - set(passed) - {"net_assimilation"}
    missing = set(written) - set(state.auxiliary)
    if extra or missing or set(state.tendencies) != set(state.prognostic):
        raise ValueError(f"the land full step writes {written}; the state holds "
                         f"{sorted(state.auxiliary)} (extra {sorted(extra)}, missing "
                         f"{sorted(missing)})")
    out = {"prognostic": {n: torch.empty_like(v) for n, v in state.prognostic.items()},
           "tendencies": {n: torch.empty_like(v) for n, v in state.prognostic.items()},
           "auxiliary": {n: torch.empty_like(state.auxiliary[n]) for n in written}}
    if veg:
        out["auxiliary"]["net_assimilation"] = torch.empty_like(state["net_assimilation"])
    for t in (*carry.values(), *stored.values()):
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"the land full step's fields take one dtype and device; got "
                             f"{t.dtype} on {t.device}")
    c_out = {_CARRY_OF[n]: v.data_ptr() for n, v in out["prognostic"].items()}
    if veg:
        c_out["An"] = out["auxiliary"]["net_assimilation"].data_ptr()
    io = _CLandFullStepIO(
        in_=_CLandCarry(**{_CARRY_OF[n]: t.data_ptr() for n, t in carry.items()}),
        out=_CLandCarry(**c_out),
        tend=_CLandCarry(**{_CARRY_OF[n]: v.data_ptr() for n, v in out["tendencies"].items()}),
        **{k: v.data_ptr() for k, v in stored.items()})
    for i, n in enumerate(LAND_FULL_AUX):
        io.aux[i] = out["auxiliary"][n].data_ptr() if n in written else None
    inputs = {n: LandInput(state.inputs[n][None, :]) for n in LAND_INPUTS if n in state.inputs}
    zero = torch.zeros(1, dtype=dtype, device=device)
    c_inputs = _CLandInputs()
    for i, name in enumerate(LAND_INPUTS):
        v = inputs.get(name, LandInput(zero)).values
        if v.dtype != dtype or v.device != device or v.dim() != 2 and v.numel() != 1:
            raise ValueError(f"input {name} must be a ({cells},) {dtype} field on {device}")
        c_inputs.ptr[i] = v.data_ptr()
        c_inputs.cell_stride[i] = v.stride(1) if v.dim() == 2 else 0
        c_inputs.rows[i], c_inputs.dts[i] = 1, 1.0
    root = state.auxiliary["root_fraction"] if veg else zero[None, :]
    strides = (root.stride(0), root.stride(1)) if veg else (0, 0)
    coords = tuple(torch.as_tensor(a, device=device).to(dtype) for a in (
        model.grid.vertical.dz, model.grid.vertical.dz_faces, model.grid.vertical.z_centers,
        model.grid.vertical.z_faces))
    params_c = _CLAND[dtype](soil=_CParams.of(params.soil), **params.values)
    args = (ctypes.byref(io), ctypes.byref(c_inputs), root.data_ptr(), *strides,
            *(c.data_ptr() for c in coords), ctypes.byref(params_c))
    keep = (carry, stored, inputs, zero, root, coords, io, c_inputs, params_c)
    return tags, args, keep, out


def land_full_step_operands(model, stepper: str, state: State, dt: float,
                            solver: Optional[str] = None, picard_iters: int = 1):
    """What one launch of the land full-step kernel takes for ``state`` on
    the card: ``(fn, (args, keep), out)``, the entry point, its arguments,
    what they point into and the tensors it fills
    (:func:`land_full_step_buffers`); ImplicitEuler's ``solver`` and Picard
    count are run-time arguments."""
    tags, args, keep, out = land_full_step_buffers(model, state)
    U = state.prognostic["internal_energy"]
    fn = cuda_build.entry(_FULL_NAME, U.dtype, U.shape[0], _full_argtypes(U.dtype),
                          tags=_FULL_STEPPER_TAGS[stepper] + tags)
    args = (*args, float(dt), U.shape[1], SOLVER_CODES.get(solver, 0), int(picard_iters),
            torch.cuda.current_stream(U.device).cuda_stream)
    return fn, (args, keep), out


def land_column_full_step_plain(model, timestepper, ctx, input_sources, state: State,
                                dt: float) -> State:
    """The plain version of the land full step: the port's own
    ``timestepper.step`` through the process modules, on a copy of
    ``state``."""
    out = state.copy()
    timestepper.step(model, out, ctx, input_sources, dt)
    return out


def land_column_full_step(model, timestepper, ctx, input_sources, state: State,
                          dt: float) -> State:
    """One full step of ``state`` (``make_fused_step`` over a LandModel) as a
    new :class:`State`, every prognostic, tendency and auxiliary of the step
    and the clock advanced: on CPU tensors
    :func:`land_column_full_step_plain`, on CUDA tensors one launch of the
    full-step kernel (or an error). Raises ``ValueError`` for a composition
    the kernel does not run (``fused_step.full_step_scheme``)."""
    column, stepper, solver, picard = full_step_scheme(model, timestepper, ctx, input_sources)
    if column != "land":
        raise ValueError("land_column_full_step runs a LandModel; the SoilModel's full step is "
                         "ops/fused_step.py::soil_column_full_step")
    U = state.prognostic["internal_energy"]
    if U.device.type == "cpu":
        return land_column_full_step_plain(model, timestepper, ctx, input_sources, state, dt)
    if U.device.type != "cuda":
        raise ValueError(f"the land full step runs on cpu or cuda, not {U.device}")
    fn, (args, keep), out = land_full_step_operands(model, stepper, state, dt, solver, picard)
    err = fn(*args)
    del keep
    if err != 0:
        raise RuntimeError(f"land full step kernel launch failed: cudaError {err}")
    land_column_full_step.launches += 1
    new = state.copy()
    new.prognostic.update(out["prognostic"])
    new.tendencies.update(out["tendencies"])
    new.auxiliary.update(out["auxiliary"])
    new.clock = Clock(state.clock.time + dt, state.clock.iteration + 1)
    return new


land_column_full_step.launches = 0
