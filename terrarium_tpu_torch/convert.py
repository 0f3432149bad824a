"""Carry states and parameters over from the JAX package.

Both converters take plain numbers only (numpy arrays, Python floats and
dicts), so this module needs nothing of JAX:

* :func:`state_from_numpy` builds a port :class:`State` from a JAX state's
  leaves after ``np.asarray``;
* :func:`params_from_dict` rebuilds the soil process parameters from
  ``dataclasses.asdict`` of a JAX ``SoilEnergyWaterCarbon``;
* :func:`with_differentiable_params` sets the parameters the gradient paths
  differentiate (the log of the saturated hydraulic conductivity, the
  mineral conductivity) from numbers or 0-d tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

from .processes.soil.energy import SoilEnergyBalance
from .processes.soil.hydraulics import ConstantSoilHydraulics, UnsatKVanGenuchten
from .processes.soil.hydrology import RichardsEq, SoilHydrology
from .processes.soil.soil_coupled import SoilEnergyWaterCarbon
from .processes.soil.stratigraphy import (ConstantSoilCarbonDensity, ConstantSoilPorosity,
                                          HomogeneousStratigraphy, SoilTexture)
from .processes.soil.swrc import VanGenuchten
from .processes.soil.thermal import (SoilHeatCapacities, SoilThermalConductivities,
                                     SoilThermalProperties)
from .state import Clock, State

__all__ = ["state_from_numpy", "params_from_dict", "with_differentiable_params"]


_GROUPS = ("prognostic", "tendencies", "auxiliary", "inputs")


def state_from_numpy(arrays: Mapping[str, np.ndarray], time, iteration, grid) -> State:
    """A :class:`State` on ``grid`` from arrays keyed ``"<group>/<name>"``,
    the group being one of the JAX `State` groups (``prognostic``,
    ``tendencies``, ``auxiliary``, ``inputs``), e.g.
    ``{"prognostic/internal_energy": np.asarray(s.prognostic["internal_energy"])}``."""
    out = {g: {} for g in _GROUPS}
    for key, arr in arrays.items():
        group, _, name = key.partition("/")
        if group not in out or not name:
            raise KeyError(f"{key!r} is not '<group>/<name>' with a group in {_GROUPS}")
        t = torch.as_tensor(np.asarray(arr), device=grid.device).to(grid.dtype)
        if t.shape[-1:] != (grid.cells,) or t.dim() > 2:
            raise ValueError(f"{key!r} has shape {tuple(t.shape)}, not a field of {grid!r}")
        out[group][name] = t
    it_dtype = torch.int64 if grid.dtype == torch.float64 else torch.int32
    clock = Clock(torch.tensor(float(time), dtype=grid.dtype, device=grid.device),
                  torch.tensor(int(iteration), dtype=it_dtype, device=grid.device))
    return State(out["prognostic"], out["tendencies"], out["auxiliary"], out["inputs"], clock)


def _only(d: Mapping, allowed, what):
    extra = {k for k, v in d.items() if k not in allowed and v not in ({}, None, False)}
    if extra:
        raise NotImplementedError(f"{what}: {sorted(extra)} is not ported")


def params_from_dict(d: Mapping) -> SoilEnergyWaterCarbon:
    """Rebuild :class:`SoilEnergyWaterCarbon` from ``dataclasses.asdict`` of
    the JAX one. The port has the main-path parameterization only: constant
    porosity and carbon, the free-water curve with inverse-quadratic
    conductivity, and Richards flow with ``ConstantSoilHydraulics`` of
    ``VanGenuchten`` and ``UnsatKVanGenuchten``. Marker processes (empty
    dicts, such as the flow operator) carry no numbers and are implied:
    the hydrology is always ``RichardsEq``. ``asdict`` loses the class of
    each member, so a dict of another parameterization with the same keys
    cannot be told apart: pass only main-path configurations."""
    strat, energy, hyd, bgc = d["strat"], d["energy"], d["hydrology"], d["biogeochem"]
    _only(hyd, ("hydraulic_properties",), "SoilHydrology option")
    tp = energy["thermal_properties"]
    hp = hyd["hydraulic_properties"]
    return SoilEnergyWaterCarbon(
        strat=HomogeneousStratigraphy(texture=SoilTexture(**strat["texture"]),
                                      porosity=ConstantSoilPorosity(**strat["porosity"])),
        energy=SoilEnergyBalance(thermal_properties=SoilThermalProperties(
            conductivities=SoilThermalConductivities(**tp["conductivities"]),
            heat_capacities=SoilHeatCapacities(**tp["heat_capacities"]))),
        hydrology=SoilHydrology(vertical_flow=RichardsEq(),
                                hydraulic_properties=ConstantSoilHydraulics(
            swrc=VanGenuchten(**hp["swrc"]),
            unsat_hydraulic_cond=UnsatKVanGenuchten(**hp["unsat_hydraulic_cond"]),
            sat_hydraulic_cond=hp["sat_hydraulic_cond"],
            field_capacity_value=hp["field_capacity_value"],
            wilting_point_value=hp["wilting_point_value"])),
        biogeochem=ConstantSoilCarbonDensity(**bgc))


def _value(x):
    """A 0-d tensor as it is (keeping its graph); a Python or numpy scalar as
    a float."""
    return x if isinstance(x, torch.Tensor) else float(np.asarray(x))


def with_differentiable_params(soil: SoilEnergyWaterCarbon, *, log_sat_hydraulic_cond=None,
                               mineral_conductivity=None) -> SoilEnergyWaterCarbon:
    """``soil`` with the parameters the gradient paths differentiate set:
    the saturated hydraulic conductivity, given as its log (``exp`` is taken
    in torch, as the JAX tests take ``jnp.exp``), and the mineral thermal
    conductivity. Each is a number, a numpy scalar (as taken from a JAX
    model) or a 0-d tensor; a tensor is used as it is, so a leaf that
    requires grad gets the gradient."""
    hyd, energy = soil.hydrology, soil.energy
    if log_sat_hydraulic_cond is not None:
        x = _value(log_sat_hydraulic_cond)
        hyd = dataclasses.replace(hyd, hydraulic_properties=dataclasses.replace(
            hyd.hydraulic_properties,
            sat_hydraulic_cond=torch.exp(x) if isinstance(x, torch.Tensor) else math.exp(x)))
    if mineral_conductivity is not None:
        tp = energy.thermal_properties
        energy = dataclasses.replace(energy, thermal_properties=dataclasses.replace(
            tp, conductivities=dataclasses.replace(
                tp.conductivities, mineral=_value(mineral_conductivity))))
    return dataclasses.replace(soil, hydrology=hyd, energy=energy)
