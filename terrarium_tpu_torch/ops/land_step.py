"""The LandModel column rollout: a hand-written CUDA kernel, its plain
PyTorch version and the wrapper that picks between them by device.

:func:`land_column_rollout` applies ``ForwardEuler.pre_closure_step`` of a
:class:`LandModel` ``n`` times to the model's live carry
(``LandModel.live_carry``) and returns the new carry. It replaces
``terrarium_tpu/ops/fused_step.py::make_fused_lean_rollout`` traced over a
LandModel step. The compositions it takes (:func:`land_composition`):
bare ground (``NoCanopyInterception``, ``BareGroundEvaporation``, no
vegetation) or vegetated (``PALADYNCanopyInterception``,
``PALADYNCanopyEvapotranspiration``, ``VegetationCarbon``), over a soil of
heat only (``NoFlow``) or Richards flow with a Van Genuchten or Brooks-Corey
curve and a Mualem or linear conductivity; constant or Monin-Obukhov drag,
either SEB ground-flux form, either ground-resistance factor, any water-flux
scale, drainage sign and vegetation rate scales.

The inputs the step reads (``LAND_INPUTS``) are each a :class:`LandInput`:
a static row, or a uniformly spaced series that the kernel interpolates at
each clock time from its first time (as the soil kernels do). The CUDA
source is ``csrc/land_column_rollout.cu`` (the step in
``csrc/land_step.cuh``), built by ``nvcc`` at first use.

The plain version (:func:`land_column_rollout_plain`) is the composition of
the port's process modules: a state over the carry and the inputs, stepped
by ``ForwardEuler.pre_closure_step``. On CPU tensors the wrapper runs it; on
CUDA tensors it launches the kernel or raises. Each launch adds one to
``land_column_rollout.launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from . import cuda_build
from .fastpow import pow_code
from .fused_step import ColumnParams, _CParams, series_value, soil_flow
from ..grids.column import ColumnGrid
from ..models.land_model import LandModel
from ..processes.atmosphere import (ConstantAerodynamics, LongShortWaveRadiation,
                                    MoninObukhovAerodynamics, PrescribedAtmosphere, RainSnow,
                                    SpecificHumidity)
from ..processes.soil.hydraulics import UnsatKLinear, UnsatKVanGenuchten
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
from ..state import Clock, build_state
from ..timesteppers.stepping import ForwardEuler

__all__ = ["LAND_INPUTS", "LandInput", "LandParams", "land_composition", "carry_names",
           "land_column_rollout", "land_column_rollout_plain", "launch_args"]

_NAME = "land_column_rollout"  # csrc/land_column_rollout.cu

#: the inputs the land step reads, in the kernel's order (land_step.cuh IN_*)
LAND_INPUTS = ("air_temperature", "surface_shortwave_down", "surface_longwave_down",
               "rainfall", "windspeed", "air_pressure", "specific_humidity", "CO2", "SAI",
               "daily_leaf_respiration")

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
    "noflow")`` or ``(..., "richards", "vg" | "bc", "mualem" | "linear")``.
    Raises ``ValueError`` naming what the kernel runs for anything else; each
    attribute is read only after its owner's class is checked."""
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
                      ("turbulent_fluxes", DiagnosedTurbulentFluxes),
                      ("albedo", ConstantAlbedo)):
        _require(type(getattr(seb, part)) is cls, f"SurfaceEnergyBalance with {cls.__name__}",
                 f"{part}={_name(getattr(seb, part))}")
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
    if flow == "heat":
        return tags + ("noflow",)
    hp = model.soil.hydrology.hydraulic_properties
    swrc, cond = hp.swrc, hp.unsat_hydraulic_cond
    _require(type(swrc) in (VanGenuchten, BrooksCorey)
             and (type(cond) is UnsatKLinear
                  or (type(cond) is UnsatKVanGenuchten and type(swrc) is VanGenuchten)),
             "Richards flow with VanGenuchten and UnsatKVanGenuchten or UnsatKLinear, or "
             "BrooksCorey and UnsatKLinear", f"{_name(swrc)} and {_name(cond)}")
    return tags + ("richards", "vg" if type(swrc) is VanGenuchten else "bc",
                   "mualem" if type(cond) is UnsatKVanGenuchten else "linear")


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
    "bc_theta_res", "bc_span", "bc_neg_psi_s", "bc_psi_min", "p_bc")
_LAND_INTS = ("num_bc", "den_bc", "mo_drag", "mo_iterations", "consistent_G", "beta_soil")


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
                     bc_neg_psi_s=-swrc.psi_s, bc_psi_min=swrc.psi_min, p_bc=-1.0 / swrc.lam)
            v["num_bc"], v["den_bc"] = pow_code(v["p_bc"])
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


_CARRY = ("U", "sat", "S", "Ts", "w", "C", "nu", "An")
_CARRY_OF = {"internal_energy": "U", "saturation_water_ice": "sat",
             "surface_excess_water": "S", "skin_temperature": "Ts", "canopy_water": "w",
             "carbon_vegetation": "C", "vegetation_area_fraction": "nu",
             "net_assimilation": "An"}


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


def land_column_rollout_plain(carry: Dict[str, torch.Tensor], inputs: Dict[str, LandInput],
                              root_fraction: Optional[torch.Tensor], dz, dz_faces, z_centers,
                              z_faces, params: LandParams, dt: float, time: float, steps: int):
    """Plain PyTorch version of the kernel: the model's process modules on a
    state over ``carry`` (``{name: tensor}``, the live carry and under
    ``NoFlow`` the saturation), the static inputs and the root fraction,
    stepped ``steps`` times by ``ForwardEuler.pre_closure_step`` from the
    clock time ``time``, each series input set at each clock time first.
    Inputs not given keep their declared defaults. The coordinates are the
    model's (the grid's); they are taken for the wrapper's signature.
    Returns the new live carry as a dict."""
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
    stepper = ForwardEuler()
    for _ in range(steps):
        for name, values, t0, dts in series:
            state.inputs[name] = torch.broadcast_to(
                series_value(values, state.clock.time, t0, dts), (grid.cells,))
        stepper.pre_closure_step(model, state, ctx, dt)
    return {n: state[n] for n in model.live_carry}


def _argtypes(dtype) -> list:
    return ([ctypes.POINTER(_CLandCarry)] * 2
            + [ctypes.POINTER(_CLandInputs), ctypes.c_void_p, ctypes.c_longlong,
               ctypes.c_longlong] + [ctypes.c_void_p] * 4
            + [ctypes.POINTER(_CLAND[dtype]), ctypes.c_int, ctypes.c_double, ctypes.c_double,
               ctypes.c_longlong, ctypes.c_void_p])


def land_column_rollout(carry: Dict[str, torch.Tensor], inputs: Dict[str, LandInput],
                        root_fraction: Optional[torch.Tensor], dz, dz_faces, z_centers, z_faces,
                        params: LandParams, dt: float, time: float, steps: int):
    """ForwardEuler over a LandModel: ``steps`` fused steps on ``carry`` from
    the clock time ``time``; returns the new live carry (a dict). CPU
    tensors take :func:`land_column_rollout_plain`; CUDA tensors launch the
    kernel of ``params.tags``. ``root_fraction`` is the ``(Nz, cells)``
    field of the vegetated model (``None`` for bare ground); an input left
    out of ``inputs`` reads 0."""
    coords = (dz, dz_faces, z_centers, z_faces)
    _check(carry, inputs, root_fraction, coords, params)
    if steps < 0:
        raise ValueError("steps must be >= 0")
    U = carry["internal_energy"]
    if U.device.type == "cpu":
        return land_column_rollout_plain(carry, inputs, root_fraction, *coords, params, dt,
                                         time, steps)
    if U.device.type != "cuda":
        raise ValueError(f"land column rollout runs on cpu or cuda, not {U.device}")
    for t in (*carry.values(), *coords):
        if not t.is_contiguous():
            raise ValueError("the land column kernel takes contiguous carry and coordinates")
    fn = cuda_build.entry(_NAME, U.dtype, U.shape[0], _argtypes(U.dtype), tags=params.tags)
    out = {n: torch.empty_like(carry[n]) for n in params.model.live_carry}
    args, keep = launch_args(carry, out, inputs, root_fraction, coords, params)
    err = fn(*args, steps, float(time), float(dt), U.shape[1],
             torch.cuda.current_stream(U.device).cuda_stream)
    del keep
    if err != 0:
        raise RuntimeError(f"land column kernel launch failed: cudaError {err}")
    land_column_rollout.launches += 1
    return out


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


land_column_rollout.launches = 0
