"""Carry states and parameters over from the JAX package.

Both converters take plain numbers only (numpy arrays, Python floats and
dicts), so this module needs nothing of JAX:

* :func:`state_from_numpy` builds a port :class:`State` from a JAX state's
  leaves after ``np.asarray``;
* :func:`params_from_dict` rebuilds the soil process parameters from
  ``dataclasses.asdict`` of a JAX ``SoilEnergyWaterCarbon``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .processes.soil.energy import SoilEnergyBalance
from .processes.soil.hydraulics import ConstantSoilHydraulics, UnsatKVanGenuchten
from .processes.soil.hydrology import SoilHydrology
from .processes.soil.soil_coupled import SoilEnergyWaterCarbon
from .processes.soil.stratigraphy import (ConstantSoilCarbonDensity, ConstantSoilPorosity,
                                          HomogeneousStratigraphy, SoilTexture)
from .processes.soil.swrc import VanGenuchten
from .processes.soil.thermal import (SoilHeatCapacities, SoilThermalConductivities,
                                     SoilThermalProperties)
from .state import Clock, State

__all__ = ["state_from_numpy", "params_from_dict"]


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
    dicts) carry no numbers and are implied. ``asdict`` loses the class of
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
        hydrology=SoilHydrology(hydraulic_properties=ConstantSoilHydraulics(
            swrc=VanGenuchten(**hp["swrc"]),
            unsat_hydraulic_cond=UnsatKVanGenuchten(**hp["unsat_hydraulic_cond"]),
            sat_hydraulic_cond=hp["sat_hydraulic_cond"],
            field_capacity_value=hp["field_capacity_value"],
            wilting_point_value=hp["wilting_point_value"])),
        biogeochem=ConstantSoilCarbonDensity(**bgc))
