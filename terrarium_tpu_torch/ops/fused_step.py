"""The soil column rollout and the full soil step: hand-written CUDA
kernels, their plain PyTorch versions and the wrappers that pick between them
by device.

A rollout applies ``pre_closure_step`` ``n`` times to the live carry of a
:class:`SoilModel` and returns the new carry. It replaces
``terrarium_tpu/ops/fused_step.py::make_fused_lean_rollout`` for the
configurations below, one kernel family (and one wrapper) each:

* :func:`soil_column_rollout`: ForwardEuler, heat + Richards flow; carry
  internal energy, saturation and surface pool;
* :func:`soil_column_heun_rollout`: Heun, heat + Richards flow, the same
  carry;
* :func:`soil_column_heat_rollout`: ForwardEuler, heat only (``NoFlow``);
  carry the internal energy, the saturation read and never written;
* :func:`soil_column_implicit_rollout`: ImplicitEuler, heat + Richards
  flow, each step two tridiagonal solves (heat and Richards) by Thomas or
  PCR, and each further Picard iteration (``picard_iters``) two more at the
  iterate; the Euler carry;
* :func:`soil_column_heat_heun_rollout` and
  :func:`soil_column_heat_implicit_rollout`: Heun and ImplicitEuler (any
  number of Picard iterations; the energy's solve alone) over the heat-only
  model, the heat-only carry.

ImplicitEuler over the heat-only model or with more than one Picard
iteration runs ``soil::picard_step``, whose instantiations take the Picard
count and the solver at run time (:func:`kernel_tags`).

The top temperature is either a table, one row per clock time (``(rows,)``
or ``(rows, cells)``, strides may be 0; Heun reads ``n + 1`` rows, the
stage of step ``i`` reading row ``i + 1``), or a :class:`SeriesBC`, a
uniformly spaced series that the kernel interpolates at each clock time
itself (the counterpart of ``_WindowSource``, `fused_step.py:92-122`,
without its window). The CUDA sources, compiled by ``nvcc`` at first use
into ``_build/`` beside this package and loaded with ctypes: for
ForwardEuler, Heun and ImplicitEuler over heat + Richards
(:func:`soil_column_rollout`, :func:`soil_column_heun_rollout`,
:func:`soil_column_implicit_rollout`), ``csrc/soil_column_group_rollout.cu``,
a column spread over a group of lanes (the step in
``csrc/soil_group_step.cuh``); for the heat-only model
``csrc/soil_column_rollout.cu``, a column a thread (the step in
``csrc/soil_step.cuh``).

On CPU tensors a wrapper runs :func:`soil_column_rollout_plain`; on CUDA
tensors it launches its kernel or raises. Each launch adds one to the
wrapper's ``launches``.

:func:`make_fused_step` replaces ``terrarium_tpu/ops/fused_step.py::
make_fused_step``: one full ``timestepper.step``, every leaf of the state in
and out. A :class:`SoilModel` (ForwardEuler, Heun or ImplicitEuler with
either solver and any Picard count, heat + Richards or heat only) is a
launch of ``csrc/soil_column_full_step.cu`` (column code
``csrc/soil_full_step.cuh``) through :func:`soil_column_full_step`, whose
plain version :func:`soil_column_full_step_plain` is the port's own module
step on a copy of the state; a LandModel is a launch of
``csrc/land_column_full_step.cu`` through
``ops/land_step.py::land_column_full_step``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from . import cuda_build
from .bcs import Dirichlet, InputRef, bc_call_arity
from .fastpow import fast_pow, pow_code
from .tridiag import SOLVERS, diffusion_rows
from ..io.input_sources import FieldInputSource
from ..models.land_model import LandModel, coupling_bcs
from ..models.soil_model import SoilModel
from ..processes.soil.energy import SoilEnergyBalance
from ..processes.soil.hydraulics import (ConstantSoilHydraulics, SoilHydraulicsSURFEX,
                                         UnsatKLinear, UnsatKVanGenuchten)
from ..processes.soil.hydrology import (NoFlow, RichardsEq, SoilHydrology, pool_drainage,
                                        saturation_sweeps)
from ..processes.soil.soil_coupled import SoilEnergyWaterCarbon
from ..processes.soil.stratigraphy import ConstantSoilCarbonDensity, HomogeneousStratigraphy
from ..processes.soil.swrc import VanGenuchten, one_minus_eps
from ..processes.soil.thermal import FreeWater, InverseQuadratic, SoilThermalProperties
from ..state import Clock, State
from ..timesteppers.implicit import ImplicitEuler
from ..timesteppers.stepping import ForwardEuler, Heun
from ..utils.utils import safediv

__all__ = ["ColumnParams", "SeriesBC", "uniform_ts_meta", "window_meta", "kernel_physics",
           "soil_flow", "clock_times", "top_temperature_value", "top_temperature_table",
           "STEPPERS", "kernel_tags",
           "soil_column_rollout", "soil_column_heun_rollout", "soil_column_heat_rollout",
           "soil_column_implicit_rollout", "soil_column_heat_heun_rollout",
           "soil_column_heat_implicit_rollout", "soil_column_rollout_plain", "ROLLOUTS",
           "GROUP_SCHEMES", "soil_column_group_handoffs", "group_occupancy",
           "make_fused_step", "full_step_scheme", "full_step_operands", "soil_column_full_step",
           "soil_column_full_step_plain"]

_NAME = "soil_column_rollout"  # csrc/soil_column_rollout.cu
_GROUP_NAME = "soil_column_group_rollout"  # csrc/soil_column_group_rollout.cu
#: the (stepper, physics) whose rollouts run on groups of lanes
GROUP_SCHEMES = (("euler", "richards"), ("heun", "richards"), ("implicit", "richards"))


def _number(x) -> float:
    """A parameter as a float; a tensor is read detached."""
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


def _require(ok: bool, what: str, got) -> None:
    if not ok:
        raise ValueError(f"the soil column kernels run {what}; got {got}")


def soil_flow(soil) -> str:
    """``"richards"`` or ``"heat"``: the flow of a soil the column code
    runs (the soil of a SoilModel or a LandModel), without the choice of
    retention curve and conductivity. Raises ``ValueError`` naming what the
    column code runs for any other; each attribute is read only after its
    owner's class is checked."""
    _require(isinstance(soil, SoilEnergyWaterCarbon)
             and isinstance(soil.strat, HomogeneousStratigraphy)
             and isinstance(soil.biogeochem, ConstantSoilCarbonDensity)
             and isinstance(soil.energy, SoilEnergyBalance)
             and isinstance(soil.hydrology, SoilHydrology),
             "SoilEnergyWaterCarbon of HomogeneousStratigraphy, ConstantSoilCarbonDensity, "
             "SoilEnergyBalance and SoilHydrology", soil)
    props = soil.energy.thermal_properties
    _require(isinstance(props, SoilThermalProperties)
             and isinstance(props.freezecurve, FreeWater)
             and isinstance(props.bulk_conductivity, InverseQuadratic),
             "SoilThermalProperties with FreeWater and InverseQuadratic", props)
    flow = soil.hydrology.vertical_flow
    if isinstance(flow, NoFlow):
        return "heat"
    _require(isinstance(flow, RichardsEq), "SoilHydrology with NoFlow or RichardsEq",
             type(flow).__name__)
    hp = soil.hydrology.hydraulic_properties
    _require(isinstance(hp, (ConstantSoilHydraulics, SoilHydraulicsSURFEX)),
             "RichardsEq over ConstantSoilHydraulics or SoilHydraulicsSURFEX",
             type(hp).__name__)
    return "richards"


def kernel_physics(model) -> str:
    """``"richards"`` or ``"heat"``: the physics of the soil kernel that runs
    ``model``. Raises ``ValueError`` naming what the kernels run for any other
    model (:func:`soil_flow`; Richards flow with ``VanGenuchten`` and
    ``UnsatKVanGenuchten`` only)."""
    _require(isinstance(model, SoilModel), "a SoilModel", type(model).__name__)
    if soil_flow(model.soil) == "heat":
        return "heat"
    hp = model.soil.hydrology.hydraulic_properties
    _require(isinstance(hp.swrc, VanGenuchten)
             and isinstance(hp.unsat_hydraulic_cond, UnsatKVanGenuchten),
             "RichardsEq with VanGenuchten and UnsatKVanGenuchten",
             f"{type(hp.swrc).__name__} and {type(hp.unsat_hydraulic_cond).__name__}")
    return "richards"


@dataclasses.dataclass(frozen=True)
class ColumnParams:
    """Scalar parameters of the fused soil step, as Python floats, and the
    retention curve of the plain implicit step.

    Products of two parameters that the JAX package forms in Python (a
    constituent property times a solid-matrix fraction) are formed here the
    same way, so the kernel and the plain version see the same numbers. The
    hydraulic fields are 0 for the heat-only model, which reads none."""

    por: float
    L: float
    c_water: float
    c_ice: float
    c_air: float
    c_mineral: float
    c_organic: float
    sk_water: float
    sk_ice: float
    sk_air: float
    sk_mineral: float
    sk_organic: float
    theta_res: float
    vg_span: float
    neg_inv_alpha: float
    psi_min: float
    vg_se_lo: float
    vg_se_hi: float
    K_sat: float
    neg_impedance: float
    k_theta_sat: float
    k_se_hi: float
    eps_lo: float
    z_top: float
    p_inv_m: float
    p_inv_n: float
    p_k1: float
    p_k2: float
    # the implicit stepper's (appended, so that the struct's earlier layout
    # stays): 1/por, the tendency scale of the Richards rows, and the
    # constants of VanGenuchten.inverse_deriv (`swrc.py:77-90`): the clip of
    # se, 1/(alpha n m), the clamp of the derivative, the exponents -1/m,
    # (1 - n)/n and -(1 + m)/m
    inv_por: float
    id_se_lo: float
    id_se_hi: float
    id_coef: float
    id_clamp: float
    p_id_core: float
    p_id_a: float
    p_id_b: float
    #: the retention curve whose ``inverse_deriv`` the plain implicit step
    #: calls (``None`` for the heat-only model); not passed to the kernels
    swrc: object = None

    @staticmethod
    def of(model, dtype: torch.dtype) -> "ColumnParams":
        """The parameters of ``model`` as floats; raises ``ValueError`` for a
        model the kernels do not run (:func:`kernel_physics`). A parameter
        given as a 0-d tensor (``sat_hydraulic_cond``, the mineral
        conductivity) is read detached: the kernels take numbers, and the
        gradient path chains their cotangents back to the tensors itself
        (``timesteppers/fused_grad.py``)."""
        physics = kernel_physics(model)
        return ColumnParams.of_soil(model.soil, model.constants, model.grid, dtype,
                                    physics == "richards")

    @staticmethod
    def of_soil(soil, c, grid, dtype: torch.dtype, richards: bool) -> "ColumnParams":
        """The parameters of a soil that :func:`soil_flow` takes, with the
        constants ``c`` on ``grid``: the Van Genuchten fields where the
        curve is ``VanGenuchten``, the Mualem fields where the conductivity
        is ``UnsatKVanGenuchten``, 0 where not (and all hydraulic fields 0
        without Richards flow)."""
        strat, bgc = soil.strat, soil.biogeochem
        props = soil.energy.thermal_properties
        por = strat.bulk_porosity(bgc)
        organic = strat.organic_fraction(bgc)
        solid = 1.0 - por
        mineral_frac, organic_frac = solid * (1.0 - organic), solid * organic
        cs, ks = props.heat_capacities, props.conductivities
        hydraulic = dict.fromkeys(
            ("theta_res", "vg_span", "neg_inv_alpha", "psi_min", "vg_se_lo", "vg_se_hi",
             "K_sat", "neg_impedance", "k_theta_sat", "k_se_hi", "p_inv_m", "p_inv_n",
             "p_k1", "p_k2", "inv_por", "id_se_lo", "id_se_hi", "id_coef", "id_clamp",
             "p_id_core", "p_id_a", "p_id_b"), 0.0)
        if richards:
            hyd = soil.hydrology.hydraulic_properties
            swrc, unsat = hyd.swrc, hyd.unsat_hydraulic_cond
            hydraulic.update(swrc=swrc, K_sat=_number(hyd.sat_hydraulic_cond), inv_por=1.0 / por)
            if isinstance(swrc, VanGenuchten):
                n = swrc.n
                m = 1.0 - 1.0 / n
                hydraulic.update(
                    theta_res=swrc.theta_res, vg_span=por - swrc.theta_res,
                    neg_inv_alpha=-(1.0 / swrc.alpha), psi_min=swrc.psi_min,
                    vg_se_lo=1e-8, vg_se_hi=one_minus_eps(dtype, 1e-12),
                    p_inv_m=-1.0 / m, p_inv_n=1.0 / n, id_se_lo=1e-6,
                    id_se_hi=one_minus_eps(dtype, 1e-9), id_coef=1.0 / (swrc.alpha * n * m),
                    id_clamp=1.0e6, p_id_core=-1.0 / m, p_id_a=(1.0 - n) / n,
                    p_id_b=-(1.0 + m) / m)
            if isinstance(unsat, UnsatKVanGenuchten):
                n = swrc.n
                hydraulic.update(neg_impedance=-unsat.impedance, k_theta_sat=max(por, 1e-12),
                                 k_se_hi=one_minus_eps(dtype, 1e-9), p_k1=n / (n + 1.0),
                                 p_k2=(n - 1.0) / n)
        return ColumnParams(
            por=por, L=c.rho_w * c.L_sl,
            c_water=cs.water, c_ice=cs.ice, c_air=cs.air,
            c_mineral=cs.mineral * mineral_frac, c_organic=cs.organic * organic_frac,
            sk_water=math.sqrt(ks.water), sk_ice=math.sqrt(ks.ice),
            sk_air=math.sqrt(ks.air),
            sk_mineral=math.sqrt(_number(ks.mineral)) * mineral_frac,
            sk_organic=math.sqrt(ks.organic) * organic_frac,
            eps_lo=float(torch.finfo(dtype).eps),
            z_top=float(grid.vertical.z_faces[-1]), **hydraulic)


_DOUBLES = [f.name for f in dataclasses.fields(ColumnParams) if f.name != "swrc"]
_IMPLICIT = _DOUBLES.index("inv_por")
_POWS, _IMPLICIT_POWS = ("inv_m", "inv_n", "k1", "k2"), ("id_core", "id_a", "id_b")


def _codes(keys):
    return [(f"{part}_{key}", ctypes.c_int) for key in keys for part in ("num", "den")]


class _CParams(ctypes.Structure):
    """C layout of ``SoilColumnParams`` in the CUDA source: the explicit
    steps' numbers and the ``(num, den)`` codes of their exponents, then the
    implicit stepper's numbers and codes."""

    _fields_ = ([(name, ctypes.c_double) for name in _DOUBLES[:_IMPLICIT]] + _codes(_POWS)
                + [(name, ctypes.c_double) for name in _DOUBLES[_IMPLICIT:]]
                + _codes(_IMPLICIT_POWS))

    @staticmethod
    def of(p: ColumnParams) -> "_CParams":
        codes = {}
        for key in _POWS + _IMPLICIT_POWS:
            codes["num_" + key], codes["den_" + key] = pow_code(getattr(p, "p_" + key))
        return _CParams(**{name: getattr(p, name) for name in _DOUBLES}, **codes)


@dataclasses.dataclass(frozen=True)
class SeriesBC:
    """A top temperature that the kernel reads from a uniformly spaced
    series: ``values`` ``(rows,)`` (one value for every cell) or ``(rows,
    cells)`` at the times ``t0 + r * dts``, and the ``steps`` steps of the
    rollout from the clock time ``time`` (a value of the fields' dtype). At
    clock time ``t``: ``u = clamp((t - t0) / dts, 0, rows - 1)``, ``r =
    floor(u)``, ``w = u - r``, value ``(1 - w) * v[r] + w * v[min(r + 1,
    rows - 1)]``, which is flat beyond the ends."""

    values: torch.Tensor
    t0: float
    dts: float
    time: float
    steps: int


def uniform_ts_meta(times):
    """``(t0, dts)`` of uniformly spaced ``times`` (``(T,)``, T >= 2;
    spacing equal within rtol 1e-6, the check of `fused_step.py:81-89`),
    else None."""
    times = np.asarray(torch.as_tensor(times).cpu(), dtype=np.float64)
    if times.ndim != 1 or times.size < 2:
        return None
    d = np.diff(times)
    if not np.allclose(d, d[0], rtol=1e-6, atol=0.0):
        return None
    return float(times[0]), float(d[0])


def window_meta(times, rows: int, window: tuple) -> tuple:
    """``(t0, dts)`` of one window of a streamed series (``times``, and
    ``rows`` rows of values), which must have the length and the uniform
    spacing of the run's first window, ``window`` ``(rows, dts)`` (rtol
    1e-6, as the reference's check of its runtime sources,
    `fused_step.py:420-425`, where it can check them). A window that does
    not raises ``ValueError`` naming both; it is never resampled."""
    want_rows, want_dts = window
    n = int(np.shape(times)[0])
    meta = uniform_ts_meta(times)
    if (n != want_rows or rows != want_rows or meta is None
            or not math.isclose(meta[1], want_dts, rel_tol=1e-6, abs_tol=0.0)):
        got = "uneven spacing" if meta is None else f"spacing {meta[1]!r} s"
        raise ValueError(f"a streamed window has {n} times and {rows} rows at {got}; every "
                         f"window of the run must have the first window's {want_rows} rows at "
                         f"spacing {want_dts!r} s")
    return meta


def clock_times(t0: torch.Tensor, dt: float, n: int) -> np.ndarray:
    """The ``n + 1`` clock times ``t0, t0 + dt, (t0 + dt) + dt, ...`` by
    repeated addition in ``t0``'s dtype, as ``Clock.tick`` produces them
    (``t0 + k*dt`` differs once the sum outgrows the mantissa)."""
    np_dtype = np.float32 if t0.dtype == torch.float32 else np.float64
    t = np_dtype(t0.item())
    step = np_dtype(dt)
    out = np.empty(n + 1, dtype=np_dtype)
    for i in range(n + 1):
        out[i] = t
        t = t + step
    return out


def top_temperature_table(value, times: np.ndarray, grid) -> torch.Tensor:
    """The top-temperature BC evaluated at each of ``times``: ``(n,)`` when
    the value is the same for every cell, else ``(n, cells)`` (an expanded
    view when the value does not change in time)."""
    n = times.shape[0]
    if isinstance(value, str):
        raise ValueError("an input variable as the top temperature is read from the state "
                         "and its sources (advance), not tabulated from a value")
    if callable(value):
        if bc_call_arity(value) >= 2:
            raise ValueError("the fused rollout evaluates BCs as f(t); f(t, state) "
                             "needs the state inside the kernel")
        t = torch.as_tensor(times, device=grid.device)[:, None]
        v = torch.as_tensor(value(t), dtype=grid.dtype, device=grid.device)
        if v.dim() == 2 and v.shape[1] == 1:
            v = v[:, 0]
        if v.dim() == 2 or (v.dim() == 1 and v.shape[0] != n):
            return torch.broadcast_to(v, (n, grid.cells)).contiguous()
        return torch.broadcast_to(v, (n,)).contiguous()
    v = torch.as_tensor(value, dtype=grid.dtype, device=grid.device)
    if v.dim() == 0:
        return v.expand(n).contiguous()
    if tuple(v.shape) != (grid.cells,):
        raise ValueError(f"top temperature BC of shape {tuple(v.shape)}; "
                         f"expected a scalar or ({grid.cells},)")
    return v[None, :].expand(n, grid.cells)


def top_temperature_value(bcs):
    """The value of the Dirichlet top temperature, the only BC the soil
    column kernels take; ``ValueError`` for any other BC."""
    top = (bcs or {}).get("temperature", {}).get("top")
    if not isinstance(top, Dirichlet):
        raise ValueError("the fused soil rollout needs a Dirichlet top temperature "
                         "(PrescribedSurfaceTemperature)")
    extra = {(v, s) for v, sides in (bcs or {}).items() for s in sides} - {("temperature", "top")}
    if extra:
        raise ValueError(f"the fused soil rollout supports no other BCs, got {sorted(extra)}")
    return top.value



# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def _plain_rhs(U, sat, S, vtop, dz, dzf, zc, zf, p: ColumnParams, heat: bool):
    """The closure and tendencies of one closure-rotated step, in the
    kernel's order of operations (``soil::closure_rhs``): the sweeps row by
    row, everything else elementwise over ``(Nz, cells)``. Returns the closed
    ``(sat, S)``, the tendencies ``(dU, dsat, dS)`` and what the implicit
    rows need of the closed column: the centre thermal conductivity, dT/dU
    (0 on the freeze plateau, else 1/C) and the Darcy face conductivity. The
    heat-only model closes nothing and has no water tendencies and no Darcy
    faces (``None``)."""
    nz = U.shape[0]
    if not heat:
        # closure: saturation adjustment (up sweep then down sweep), water table
        sat, spill = saturation_sweeps(sat, dz)
        S = S + spill
        wt = torch.broadcast_to(zf[nz], S.shape)
        for k in reversed(range(nz)):
            wt = torch.where(sat[k] < 1.0, zf[k], wt)

    # energy closure, heat capacity and bulk conductivity
    L_theta = p.L * sat * p.por
    negL = -L_theta
    liq = torch.where(U >= 0.0, 1.0,
                      torch.where(U >= negL, 1.0 - safediv(U, negL), 0.0))
    wi = sat * p.por
    water, ice, air = wi * liq, wi * (1.0 - liq), (1.0 - sat) * p.por
    C = p.c_water * water + p.c_ice * ice + p.c_air * air + p.c_mineral + p.c_organic
    T = torch.where(U < negL, (U + L_theta) / C, torch.where(U >= 0.0, U / C, 0.0))
    acc = p.sk_water * water + p.sk_ice * ice + p.sk_air * air + p.sk_mineral + p.sk_organic
    kap = acc * acc

    # heat flux: zero gradient at the bottom, Dirichlet ghost at the top
    T_lo = torch.cat([T[:1], T])
    T_hi = torch.cat([T, 2.0 * vtop - T[-1:]])
    k_lo = torch.cat([kap[:1], kap])
    k_hi = torch.cat([kap, kap[-1:]])
    qh = -(0.5 * (k_hi + k_lo)) * ((T_hi - T_lo) / dzf)
    dU = -((qh[1:] - qh[:-1]) / dz)
    dTdU = torch.where((U >= negL) & (U < 0.0), 0.0, 1.0 / C)
    if heat:
        return sat, S, dU, None, None, kap, dTdU, None

    # centre hydraulic conductivity
    I_ice = 10.0 ** (p.neg_impedance * (1.0 - liq))
    se = torch.clamp(water / p.k_theta_sat, 0.0, 1.0)
    frozen = se <= p.eps_lo
    se_s = torch.where(frozen, p.eps_lo, torch.clamp(se, max=p.k_se_hi))
    inner = 1.0 - fast_pow(1.0 - fast_pow(se_s, p.p_k1), p.p_k2)
    K_unsat = torch.where(frozen, 0.0, p.K_sat * I_ice * torch.sqrt(se_s) * (inner * inner))
    Kc = torch.where(se >= 1.0, p.K_sat * I_ice, K_unsat)

    # pressure head and Darcy flux with upwind-min face conductivity
    se_v = (sat * p.por - p.theta_res) / p.vg_span
    ss = torch.clamp(se_v, p.vg_se_lo, p.vg_se_hi)
    psi = p.neg_inv_alpha * fast_pow(fast_pow(ss, p.p_inv_m) - 1.0, p.p_inv_n)
    psi_m = torch.where(se_v >= 1.0, 0.0, torch.clamp(psi, min=p.psi_min))
    psi = torch.clamp(wt - zc, min=0.0) + psi_m + (zc - p.z_top)
    grad = (torch.cat([psi, psi[-1:]]) - torch.cat([psi[:1], psi])) / dzf
    Kf = torch.cat([Kc[:1], torch.minimum(Kc[:-2], Kc[1:-1]), Kc[-1:], Kc[-1:]])
    inf = torch.full_like(Kf[:1], torch.inf)
    K_eff = torch.where(grad < 0.0, torch.minimum(torch.cat([inf, Kf[:-1]]), Kf),
                        torch.minimum(Kf, torch.cat([Kf[1:], inf])))
    qw = -K_eff * grad
    dsat = (-((qw[1:] - qw[:-1]) / dz)) / p.por
    return sat, S, dU, dsat, pool_drainage(S), kap, dTdU, K_eff


def _plain_euler(U, sat, S, vtop, coords, p, dt, heat):
    """``ForwardEuler.pre_closure_step``: ``x + f * dt``."""
    sat, S, dU, dsat, dS, *_ = _plain_rhs(U, sat, S, vtop, *coords, p, heat)
    if heat:
        return U + dU * dt, sat, S
    return U + dU * dt, sat + dsat * dt, S + dS * dt


def _plain_heun(U, sat, S, v0, v1, coords, p, dt, heat):
    """``Heun.pre_closure_step``: close ``x_n`` and take ``f_n`` at ``v0``;
    the stage ``y = x_n + f_n * dt``, closed, gives ``f*`` at ``v1`` (the
    top temperature at t + dt); ``x_n + (0.5 * (f_n + f*)) * dt``."""
    sat, S, fU, fs, fS, *_ = _plain_rhs(U, sat, S, v0, *coords, p, heat)
    if heat:
        gU = _plain_rhs(U + fU * dt, sat, S, v1, *coords, p, heat)[2]
        return U + (0.5 * (fU + gU)) * dt, sat, S
    _, _, gU, gs, gS, *_ = _plain_rhs(U + fU * dt, sat + fs * dt, S + fS * dt, v1, *coords, p,
                                      heat)
    return (U + (0.5 * (fU + gU)) * dt, sat + (0.5 * (fs + gs)) * dt,
            S + (0.5 * (fS + gS)) * dt)


def _plain_implicit(U, sat, S, vtop, coords, p, dt, heat, solver, picard_iters=1):
    """``ImplicitEuler.pre_closure_step`` (`implicit.py:173-264`): close the
    column and take its tendencies; the heat rows (face kappa, dT/dU, scale
    1, the Dirichlet top) and their solve, ``U + du``; the Richards rows
    (Darcy face K, d(Psi)/d(sat) = ``inverse_deriv(sat * por, por) * por``
    at the closed saturation, scale 1/por) and their solve, ``sat + du``;
    ``S + dS dt``. Each further Picard iteration (`implicit.py:234-254`)
    closes the iterate (its spill is dropped: the pool keeps the first
    iteration's value), takes its tendencies and rows at the step's top
    temperature, and sets each implicit variable to the closed iterate plus
    the solve of ``tend(u_k) - (u_k - u^n) / dt``, ``u^n`` the closed start.
    The heat-only model has the heat rows alone."""
    dz, dzf = coords[0], coords[1]
    solve = SOLVERS[solver]
    one = torch.ones((), dtype=U.dtype, device=U.device)

    def heat_rows(kap, Dh):
        Kf = 0.5 * (torch.cat([kap, kap[-1:]]) + torch.cat([kap[:1], kap]))
        return diffusion_rows(Kf, Dh, one, dz, dzf, dt, dirichlet_top=True)

    def water_rows(K_eff, closed):
        inv_por = torch.tensor(p.inv_por, dtype=U.dtype, device=U.device)
        D = p.swrc.inverse_deriv(closed * p.por, p.por) * p.por
        return diffusion_rows(K_eff, D, inv_por, dz, dzf, dt)

    sat, S, dU, dsat, dS, kap, Dh, K_eff = _plain_rhs(U, sat, S, vtop, *coords, p, heat)
    U_n, sat_n = U, sat
    U = U + solve(*heat_rows(kap, Dh), dU)
    if not heat:
        sat = sat + solve(*water_rows(K_eff, sat), dsat)
        S = S + dS * dt
    for _ in range(max(1, int(picard_iters)) - 1):
        closed, _, fU, fs, _, kap, Dh, K_eff = _plain_rhs(U, sat, S, vtop, *coords, p, heat)
        U = U + solve(*heat_rows(kap, Dh), fU - (U - U_n) / dt)
        if not heat:
            sat = closed + solve(*water_rows(K_eff, closed), fs - (closed - sat_n) / dt)
    return U, sat, S


def series_value(values: torch.Tensor, t: torch.Tensor, t0: torch.Tensor,
                 dts: torch.Tensor) -> torch.Tensor:
    """The series at clock time ``t`` as :class:`SeriesBC` reads it: a 0-d
    tensor for a ``(rows,)`` series, ``(cells,)`` for ``(rows, cells)``;
    ``t``, ``t0`` and ``dts`` are 0-d tensors of the values' dtype."""
    rows = values.shape[0]
    u = torch.clamp((t - t0) / dts, 0.0, float(rows - 1))
    r = torch.floor(u)
    w = u - r
    i = int(r)
    return (1.0 - w) * values[i] + w * values[min(i + 1, rows - 1)]


def _scheme(stepper: str, physics: str, solver: str = "pcr", picard_iters: int = 1):
    if (stepper not in ("euler", "heun", "implicit") or physics not in ("richards", "heat")
            or solver not in SOLVERS):
        raise ValueError(f"stepper 'euler', 'heun' or 'implicit', physics 'richards' or "
                         f"'heat' and solver one of {sorted(SOLVERS)}, got {stepper!r}, "
                         f"{physics!r} and {solver!r}")
    if int(picard_iters) != picard_iters or picard_iters < 1:
        raise ValueError(f"picard_iters must be a positive integer, got {picard_iters!r}")
    return stepper == "heun", physics == "heat"


def kernel_tags(stepper: str, physics: str, picard_iters: int,
                plain_euler: tuple = ("euler", "richards"), solver: str = "pcr") -> tuple:
    """The build tags of the instantiation that runs a scheme
    (``cuda_build.INSTANTIATIONS``): ``(stepper, physics)``, none for
    ``plain_euler``; ImplicitEuler with one Picard iteration over heat +
    Richards ``("implicit", solver, "richards")``; ImplicitEuler over the
    heat-only model or with more Picard iterations ``("implicit", "picard",
    physics)``, the entries that take the count and the solver at run time
    (``soil::picard_step``)."""
    if stepper != "implicit":
        return () if (stepper, physics) == plain_euler else (stepper, physics)
    if physics == "richards" and picard_iters == 1:
        return stepper, solver, physics
    return stepper, "picard", physics


def _steps(top, heun: bool) -> int:
    if isinstance(top, SeriesBC):
        return top.steps
    return top.shape[0] - (1 if heun else 0)


def _top_reader(top, steps: int, dt: float, dtype, device):
    """``v(i)``: the top temperature at clock time ``i`` of the rollout."""
    if not isinstance(top, SeriesBC):
        return lambda i: top[i]
    times = torch.as_tensor(clock_times(torch.tensor(top.time, dtype=dtype), dt, steps),
                            device=device)
    t0, dts = (torch.tensor(x, dtype=dtype, device=device) for x in (top.t0, top.dts))
    return lambda i: series_value(top.values, times[i], t0, dts)


def soil_column_rollout_plain(U, sat, S, top, dz, dz_faces, z_centers, z_faces,
                              params: ColumnParams, dt: float, *, stepper: str = "euler",
                              physics: str = "richards", solver: str = "pcr",
                              picard_iters: int = 1):
    """Plain PyTorch version of the kernels: ``n`` closure-rotated steps of
    ``stepper`` (``"euler"``, ``"heun"`` or ``"implicit"``, the last with
    the tridiagonal ``solver``, ``"pcr"`` or ``"thomas"``, and
    ``picard_iters`` Picard iterations) for ``physics`` (``"richards"`` or
    ``"heat"``, where ``sat`` is read and returned as it is and ``S`` may be
    ``None``), the top temperature from the table or :class:`SeriesBC`
    ``top``. Coordinates are 1-D tensors in the fields' dtype."""
    heun, heat = _scheme(stepper, physics, solver, picard_iters)
    coords = (dz[:, None], dz_faces[:, None], z_centers[:, None], z_faces[:, None])
    steps = _steps(top, heun)
    v = _top_reader(top, steps, dt, U.dtype, U.device)
    for i in range(steps):
        if heun:
            U, sat, S = _plain_heun(U, sat, S, v(i), v(i + 1), coords, params, dt, heat)
        elif stepper == "implicit":
            U, sat, S = _plain_implicit(U, sat, S, v(i), coords, params, dt, heat, solver,
                                        picard_iters)
        else:
            U, sat, S = _plain_euler(U, sat, S, v(i), coords, params, dt, heat)
    return U, sat, S


# ---------------------------------------------------------------------------
# kernel build and launch
# ---------------------------------------------------------------------------
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_int]
             + [ctypes.c_double] * 3 + [ctypes.c_void_p] * 4
             + [ctypes.POINTER(_CParams), ctypes.c_int, ctypes.c_double, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
#: the group rollout's entry: the column rollout's arguments (the solver
#: and the Picard count too, which the explicit steppers' entries check and
#: ignore) with the hand-off counter (or 0) before the stream
_GROUP_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_void_p, ctypes.c_void_p]
#: the solver codes of the kernels' ``solver`` argument (``soil::SOLVER_*``)
SOLVER_CODES = {"thomas": 0, "pcr": 1}


def _check_inputs(U, sat, S, top, coords, heat=False):
    nz, cells = U.shape
    if U.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"soil column rollout takes float32 or float64, got {U.dtype}")
    fields = [("saturation", sat, (nz, cells))]
    if not heat:
        fields.append(("surface pool", S, (cells,)))
    for name, t, shape in (*fields, ("dz", coords[0], (nz,)),
                           ("dz_faces", coords[1], (nz + 1,)),
                           ("z_centers", coords[2], (nz,)), ("z_faces", coords[3], (nz + 1,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    values = top.values if isinstance(top, SeriesBC) else top
    for t in (U, values, *(t for _, t, _ in fields), *coords):
        if t.dtype != U.dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs {U.dtype}")
        if t.device != U.device:
            raise ValueError(f"device mismatch: {t.device} vs {U.device}")
    if values.dim() not in (1, 2) or (values.dim() == 2 and values.shape[1] != cells):
        raise ValueError(f"top temperature table or series must be (rows,) or "
                         f"(rows, {cells}), got {tuple(values.shape)}")
    if isinstance(top, SeriesBC) and (values.shape[0] < 1 or top.steps < 0):
        raise ValueError("a series needs at least one row and steps >= 0")


def _rollout(wrapper, stepper, physics, U, sat, S, top, coords, params, dt, solver="pcr",
             picard_iters=1, handoffs=None):
    """Check, then run the plain version (CPU) or launch the kernel of
    ``(stepper, physics)`` (and ``solver`` and ``picard_iters``, implicit)
    (CUDA); returns the new ``(U, sat, S)``. A group rollout adds its
    sweeps' hand-offs, up and down, to ``handoffs`` (an int64 tensor of 2
    on the card) where given."""
    heun, heat = _scheme(stepper, physics, solver, picard_iters)
    _check_inputs(U, sat, S, top, coords, heat)
    steps = _steps(top, heun)
    if steps < 0:
        raise ValueError("a Heun table needs steps + 1 rows")
    if U.device.type == "cpu":
        return soil_column_rollout_plain(U, sat, S, top, *coords, params, dt, stepper=stepper,
                                         physics=physics, solver=solver,
                                         picard_iters=picard_iters)
    if U.device.type != "cuda":
        raise ValueError(f"soil column rollout runs on cpu or cuda, not {U.device}")
    nz = U.shape[0]
    carry = (U, sat) if heat else (U, sat, S)
    for t in (*carry, *coords):
        if not t.is_contiguous():
            raise ValueError("the soil column kernels take contiguous fields and coordinates")
    tags = kernel_tags(stepper, physics, int(picard_iters), plain_euler=(), solver=solver)
    tail = (SOLVER_CODES[solver], int(picard_iters))
    if (stepper, physics) in GROUP_SCHEMES:
        fn = cuda_build.entry(_GROUP_NAME, U.dtype, nz, _GROUP_ARGTYPES, tags=tags)
        tail += (0 if handoffs is None else handoffs.data_ptr(),)
    else:
        fn = cuda_build.entry(_NAME, U.dtype, nz, _ARGTYPES, tags=tags)
    out = launch_entry(fn, tail, heat, U, sat, S, top, coords, params, dt, steps)
    wrapper.launches += 1
    return out


def launch_entry(fn, tail, heat, U, sat, S, top, coords, params, dt, steps):
    """Launch the rollout entry point ``fn`` (``_ARGTYPES``, ``tail`` its
    solver and Picard count, or ``_GROUP_ARGTYPES``, ``tail`` those and its
    hand-off counter) on checked CUDA operands; the new ``(U, sat, S)``."""
    U_out = torch.empty_like(U)
    sat_out, S_out = (sat, S) if heat else (torch.empty_like(sat), torch.empty_like(S))
    if isinstance(top, SeriesBC):
        data, rows, series = top.values, top.values.shape[0], (top.t0, top.dts, top.time)
    else:
        data, rows, series = top, 0, (0.0, 0.0, 0.0)
    cell_stride = data.stride(1) if data.dim() == 2 else 0
    ptr = (lambda t: 0) if heat else (lambda t: t.data_ptr())
    cparams = _CParams.of(params)
    err = fn(U.data_ptr(), sat.data_ptr(), ptr(S), U_out.data_ptr(), ptr(sat_out), ptr(S_out),
             data.data_ptr(), data.stride(0), cell_stride, rows, *series,
             *(c.data_ptr() for c in coords), ctypes.byref(cparams), steps, float(dt),
             U.shape[1], *tail, torch.cuda.current_stream(U.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"soil column kernel launch failed: cudaError {err}")
    return U_out, sat_out, S_out


def soil_column_rollout(U, sat, S, top, dz, dz_faces, z_centers, z_faces,
                        params: ColumnParams, dt: float):
    """ForwardEuler, heat + Richards: ``n`` fused steps on ``(U, sat, S)``,
    ``n`` the table's rows or the series' steps; returns the new carry. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    return _rollout(soil_column_rollout, "euler", "richards", U, sat, S, top,
                    (dz, dz_faces, z_centers, z_faces), params, dt)


def soil_column_heun_rollout(U, sat, S, top, dz, dz_faces, z_centers, z_faces,
                             params: ColumnParams, dt: float):
    """Heun, heat + Richards: ``n`` fused steps on ``(U, sat, S)``, ``n`` the
    table's rows less one or the series' steps; returns the new carry."""
    return _rollout(soil_column_heun_rollout, "heun", "richards", U, sat, S, top,
                    (dz, dz_faces, z_centers, z_faces), params, dt)


def soil_column_heat_rollout(U, sat, S, top, dz, dz_faces, z_centers, z_faces,
                             params: ColumnParams, dt: float):
    """ForwardEuler, heat only: ``n`` fused steps on ``U``, the saturation
    read and returned as it is (``S`` is passed through, and may be
    ``None``); ``n`` the table's rows or the series' steps."""
    return _rollout(soil_column_heat_rollout, "euler", "heat", U, sat, S, top,
                    (dz, dz_faces, z_centers, z_faces), params, dt)


def soil_column_implicit_rollout(U, sat, S, top, dz, dz_faces, z_centers, z_faces,
                                 params: ColumnParams, dt: float, solver: str = "pcr",
                                 picard_iters: int = 1):
    """ImplicitEuler, heat + Richards: ``n`` fused steps on ``(U, sat, S)``,
    each solving the heat and the Richards rows with ``solver`` (``"pcr"``
    or ``"thomas"``) ``picard_iters`` times; ``n`` the table's rows or the
    series' steps."""
    return _rollout(soil_column_implicit_rollout, "implicit", "richards", U, sat, S, top,
                    (dz, dz_faces, z_centers, z_faces), params, dt, solver, picard_iters)


def soil_column_heat_heun_rollout(U, sat, S, top, dz, dz_faces, z_centers, z_faces,
                                  params: ColumnParams, dt: float):
    """Heun, heat only: ``n`` fused steps on ``U``, the saturation read and
    returned as it is; ``n`` the table's rows less one or the series'
    steps."""
    return _rollout(soil_column_heat_heun_rollout, "heun", "heat", U, sat, S, top,
                    (dz, dz_faces, z_centers, z_faces), params, dt)


def soil_column_heat_implicit_rollout(U, sat, S, top, dz, dz_faces, z_centers, z_faces,
                                      params: ColumnParams, dt: float, solver: str = "pcr",
                                      picard_iters: int = 1):
    """ImplicitEuler, heat only: ``n`` fused steps on ``U``, each solving
    the heat rows with ``solver`` ``picard_iters`` times, the saturation
    read and returned as it is; ``n`` the table's rows or the series'
    steps."""
    return _rollout(soil_column_heat_implicit_rollout, "implicit", "heat", U, sat, S, top,
                    (dz, dz_faces, z_centers, z_faces), params, dt, solver, picard_iters)


for _fn in (soil_column_rollout, soil_column_heun_rollout, soil_column_heat_rollout,
            soil_column_implicit_rollout, soil_column_heat_heun_rollout,
            soil_column_heat_implicit_rollout):
    _fn.launches = 0


def soil_column_group_handoffs(stepper, U, sat, S, top, dz, dz_faces, z_centers, z_faces,
                               params: ColumnParams, dt: float, solver: str = "pcr",
                               picard_iters: int = 1):
    """The rollout of ``stepper`` (``"euler"``, ``"heun"`` or
    ``"implicit"`` with ``solver`` and ``picard_iters``, heat + Richards)
    on CUDA tensors, as its wrapper launches it (a launch of that wrapper),
    and the serial hand-offs of its saturation sweeps: ``((U, sat, S), (up,
    down))``, the number of times a carry went from one lane of a column's
    group to the next, summed over the columns, steps and closures."""
    if U.device.type != "cuda":
        raise ValueError("the hand-offs are counted by the group kernel, on CUDA tensors")
    count = torch.zeros(2, dtype=torch.int64, device=U.device)
    wrapper = ROLLOUTS[(stepper, "richards")]
    out = _rollout(wrapper, stepper, "richards", U, sat, S, top,
                   (dz, dz_faces, z_centers, z_faces), params, dt, solver=solver,
                   picard_iters=picard_iters, handoffs=count)
    return out, tuple(int(x) for x in count.tolist())


def group_occupancy(stepper: str, dtype: torch.dtype, nz: int, series: bool,
                    solver: str = "pcr", picard_iters: int = 1) -> tuple:
    """``(resident warps an SM, G)`` of the group rollout kernel of
    ``stepper`` (heat + Richards; ImplicitEuler: that of ``solver`` in the
    entry of ``picard_iters``) at ``dtype`` and depth ``nz``, with the top
    temperature from a series or a table
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    _scheme(stepper, "richards", solver, picard_iters)
    tags = kernel_tags(stepper, "richards", int(picard_iters), plain_euler=(), solver=solver)
    fn = cuda_build.entry(_GROUP_NAME, dtype, nz,
                          [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)], tags=tags,
                          suffix="_warps")
    group = ctypes.c_int(0)
    warps = fn(int(series), SOLVER_CODES[solver], ctypes.byref(group))
    if warps < 0:
        raise RuntimeError("the occupancy query of the group rollout kernel failed")
    return warps, group.value


#: the kernel wrapper of each (stepper, physics); the implicit ones take the
#: solver as ``solver=`` and the Picard count as ``picard_iters=``
ROLLOUTS = {("euler", "richards"): soil_column_rollout,
            ("heun", "richards"): soil_column_heun_rollout,
            ("euler", "heat"): soil_column_heat_rollout,
            ("implicit", "richards"): soil_column_implicit_rollout,
            ("heun", "heat"): soil_column_heat_heun_rollout,
            ("implicit", "heat"): soil_column_heat_implicit_rollout}


# ---------------------------------------------------------------------------
# one full step (make_fused_step)
# ---------------------------------------------------------------------------
_FULL_NAME = "soil_column_full_step"  # csrc/soil_column_full_step.cu
_FULL_IN = ("U", "sat", "S", "T", "liq", "psi", "top")
_FULL_OUT = ("U_out", "sat_out", "S_out", "dU", "dsat", "dS", "T_out", "liq_out", "psi_out",
             "K_face", "ground_T", "water_table")


class _CFullStepIO(ctypes.Structure):
    """C layout of ``SoilFullStepIO`` (``csrc/soil_full_step.cuh``)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _FULL_IN]
                + [("top_row_stride", ctypes.c_longlong), ("top_cell_stride", ctypes.c_longlong)]
                + [(n, ctypes.c_void_p) for n in _FULL_OUT])


_FULL_ARGTYPES = ([ctypes.POINTER(_CFullStepIO)] + [ctypes.c_void_p] * 4
                  + [ctypes.POINTER(_CParams), ctypes.c_double, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
#: the name of each stepper class the column code runs
STEPPERS = {ForwardEuler: "euler", Heun: "heun", ImplicitEuler: "implicit"}


def full_step_scheme(model, timestepper, ctx, input_sources=()) -> tuple:
    """``(column, stepper, solver, picard_iters)`` of the full-step kernel
    that runs this composition, stepped by ``ForwardEuler``, ``Heun`` or
    ``ImplicitEuler`` (its solver and Picard count; ``None`` and 1 for the
    explicit steppers), with static ``FieldInputSource`` sources and no
    forcings. ``column`` is the physics of a :class:`SoilModel` with heat +
    Richards flow (Van Genuchten, Mualem), ``"richards"``, or heat only
    (linear conductivity), ``"heat"``, whose only BC is a Dirichlet top
    temperature given as a value, a ``(cells,)`` tensor, ``f(t)`` or an
    input variable; or ``"land"``, a LandModel that the land kernel runs
    (``ops/land_step.py::land_full_composition``) with the coupling BCs
    alone. Raises ``ValueError`` for any other, by type;
    ``Simulation.timestep`` steps all of them."""
    where = "; Simulation.timestep steps it through the process modules"
    for src in input_sources:
        if hasattr(src, "times"):
            raise ValueError("make_fused_step supports only static input sources" + where)
        if type(src) is not FieldInputSource:
            raise ValueError(f"make_fused_step takes FieldInputSource, not "
                             f"{type(src).__name__}" + where)
    if getattr(ctx, "forcings", None):
        raise ValueError("make_fused_step takes no forcings" + where)
    stepper = STEPPERS.get(type(timestepper))
    if stepper is None:
        raise ValueError(f"make_fused_step runs ForwardEuler, Heun or ImplicitEuler, not "
                         f"{type(timestepper).__name__}" + where)
    solver, picard = ((timestepper.solver, int(timestepper.picard_iters))
                      if stepper == "implicit" else (None, 1))
    if stepper == "implicit" and (picard != timestepper.picard_iters or picard < 1):
        raise ValueError(f"picard_iters must be a positive integer, got "
                         f"{timestepper.picard_iters!r}" + where)
    if type(model) is LandModel:
        from .land_step import land_full_composition

        if (ctx.bcs or {}) != coupling_bcs():
            raise ValueError("make_fused_step runs a LandModel with its coupling BCs alone"
                             + where)
        try:
            land_full_composition(model)
        except ValueError as e:
            raise ValueError(f"make_fused_step: {e}" + where) from e
        return "land", stepper, solver, picard
    if type(model) is not SoilModel:
        raise ValueError(f"make_fused_step runs a SoilModel or a LandModel, not "
                         f"{type(model).__name__}" + where)
    try:
        value = top_temperature_value(ctx.bcs)
        physics = kernel_physics(model)
    except ValueError as e:
        raise ValueError(f"make_fused_step: {e}" + where) from e
    if isinstance(value, InputRef) or (callable(value) and not isinstance(value, str)
                                       and bc_call_arity(value) >= 2):
        raise ValueError("make_fused_step takes the top temperature as a value, f(t) or an "
                         "input variable" + where)
    if physics == "heat" and type(
            model.soil.hydrology.hydraulic_properties.unsat_hydraulic_cond) is not UnsatKLinear:
        raise ValueError("make_fused_step runs the heat-only model with UnsatKLinear "
                         "conductivity" + where)
    return physics, stepper, solver, picard


def make_fused_step(model, timestepper, ctx, input_sources=(), *, dt: float,
                    block_cells: int = 2048):
    """``fused(state) -> state``: one full ``timestepper.step`` of ``model``
    with the sources given (as ``ForwardEuler.step``, ``Heun.step`` or
    ``ImplicitEuler.step``, without ``Simulation.timestep``'s extra
    ``compute_auxiliary``), returned as a new :class:`State` with every
    prognostic, tendency and auxiliary of the step and the clock advanced;
    ``state`` is left as it is. On CUDA tensors one launch of the full-step
    kernel, on CPU tensors its plain version: a SoilModel through
    :func:`soil_column_full_step`, a LandModel through
    ``ops/land_step.py::land_column_full_step``. ``block_cells`` is taken
    for the JAX package's signature and is unused: the kernels run one
    column a thread, 64 threads a block. Raises ``ValueError`` at once for a
    composition no kernel runs (:func:`full_step_scheme`)."""
    if full_step_scheme(model, timestepper, ctx, input_sources)[0] == "land":
        from .land_step import land_column_full_step as full_step
    else:
        full_step = soil_column_full_step

    def fused(state: State) -> State:
        return full_step(model, timestepper, ctx, input_sources, state, dt)

    return fused


def soil_column_full_step_plain(model, timestepper, ctx, input_sources, state: State,
                                dt: float) -> State:
    """The plain version of the full step: the port's own
    ``timestepper.step`` through the process modules, on a copy of
    ``state``."""
    out = state.copy()
    timestepper.step(model, out, ctx, input_sources, dt)
    return out


def _full_top(model, ctx, state: State, dt: float) -> torch.Tensor:
    """The top temperature at the state's clock time and one step later,
    ``(2,)`` or ``(2, cells)`` (rows may have stride 0)."""
    value = top_temperature_value(ctx.bcs)
    grid = model.grid
    if isinstance(value, str):  # an input variable, which static sources do not change
        v = state.inputs.get(value)
        if v is None or tuple(v.shape) != (grid.cells,):
            raise ValueError(f"the top temperature {value!r} must be an XY input variable "
                             f"of the state")
        return v[None, :].expand(2, grid.cells)
    return top_temperature_table(value, clock_times(state.clock.time, dt, 1), grid)


def full_step_operands(model, stepper: str, physics: str, ctx, state: State, dt: float,
                       solver: str = "pcr", picard_iters: int = 1):
    """What one launch of the full-step kernel takes for ``state`` on the
    card: ``(fn, args, out)``, the entry point, its arguments and the
    output tensors it fills (keyed as ``SoilFullStepIO``'s fields);
    ImplicitEuler's ``solver`` and Picard count are run-time arguments."""
    U = state.prognostic["internal_energy"]
    heat = physics == "heat"
    grid = model.grid
    nz, cells = U.shape
    names = {"U": "internal_energy", "sat": "saturation_water_ice", "T": "temperature",
             "liq": "liquid_water_fraction"}
    if not heat:
        names.update(S="surface_excess_water", psi="pressure_head")
    fields = {k: state[n].contiguous() for k, n in names.items()}
    top = _full_top(model, ctx, state, dt).to(U.dtype)
    coords = tuple(torch.as_tensor(a, device=U.device).to(U.dtype) for a in (
        grid.vertical.dz, grid.vertical.dz_faces, grid.vertical.z_centers,
        grid.vertical.z_faces))
    for t in (*fields.values(), top, *coords):
        if t.dtype != U.dtype or t.device != U.device:
            raise ValueError(f"the full step's fields, top temperature and coordinates take "
                             f"one dtype and device; got {t.dtype} on {t.device}")
    out = {k: torch.empty_like(U) for k in ("U_out", "dU", "T_out", "liq_out")}
    out["K_face"] = torch.empty((nz + 1, cells), dtype=U.dtype, device=U.device)
    out["ground_T"] = torch.empty(cells, dtype=U.dtype, device=U.device)
    if not heat:
        out.update({k: torch.empty_like(U) for k in ("sat_out", "dsat", "psi_out")})
        out.update({k: torch.empty(cells, dtype=U.dtype, device=U.device)
                    for k in ("S_out", "dS", "water_table")})
    params = ColumnParams.of(model, U.dtype)
    if heat:  # the linear conductivity of the face K that compute_auxiliary writes
        params = dataclasses.replace(params, K_sat=_number(
            model.soil.hydrology.hydraulic_properties.sat_hydraulic_cond))
    io = _CFullStepIO(**{k: v.data_ptr() for k, v in {**fields, **out}.items()},
                      top=top.data_ptr(), top_row_stride=top.stride(0),
                      top_cell_stride=top.stride(1) if top.dim() == 2 else 0)
    fn = cuda_build.entry(_FULL_NAME, U.dtype, nz, _FULL_ARGTYPES, tags=(stepper, physics))
    # the inputs ride along in args, so that they outlive every launch of it
    args = (ctypes.byref(io), *(c.data_ptr() for c in coords), ctypes.byref(_CParams.of(params)),
            float(dt), cells, SOLVER_CODES[solver], int(picard_iters),
            torch.cuda.current_stream(U.device).cuda_stream)
    return fn, (args, (fields, top, coords, io)), out


def soil_column_full_step(model, timestepper, ctx, input_sources, state: State,
                          dt: float) -> State:
    """One full step of ``state`` (see :func:`make_fused_step`) as a new
    :class:`State`: on CPU tensors :func:`soil_column_full_step_plain`, on
    CUDA tensors one launch of the full-step kernel (or an error)."""
    physics, stepper, solver, picard = full_step_scheme(model, timestepper, ctx, input_sources)
    if physics == "land":
        raise ValueError("soil_column_full_step runs a SoilModel; the LandModel's full step is "
                         "ops/land_step.py::land_column_full_step")
    U = state.prognostic["internal_energy"]
    if U.device.type == "cpu":
        return soil_column_full_step_plain(model, timestepper, ctx, input_sources, state, dt)
    if U.device.type != "cuda":
        raise ValueError(f"the full soil step runs on cpu or cuda, not {U.device}")
    fn, (args, _keep), out = full_step_operands(model, stepper, physics, ctx, state, dt,
                                                solver or "pcr", picard)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"full soil step kernel launch failed: cudaError {err}")
    soil_column_full_step.launches += 1
    new = state.copy()
    new.prognostic["internal_energy"] = out["U_out"]
    new.tendencies["internal_energy"] = out["dU"]
    new.set(temperature=out["T_out"], liquid_water_fraction=out["liq_out"],
            ground_temperature=out["ground_T"], hydraulic_conductivity=out["K_face"])
    if physics == "richards":
        new.set(saturation_water_ice=out["sat_out"], surface_excess_water=out["S_out"],
                pressure_head=out["psi_out"], water_table=out["water_table"])
        new.tendencies["saturation_water_ice"] = out["dsat"]
        new.tendencies["surface_excess_water"] = out["dS"]
    new.clock = Clock(state.clock.time + dt, state.clock.iteration + 1)
    return new


soil_column_full_step.launches = 0
