"""Field initializers (counterpart of ``terrarium_tpu/models/initializers.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ..utils.utils import piecewise_linear

__all__ = ["DefaultInitializer", "SoilInitializer", "ConstantSoilTemperature",
           "QuasiThermalSteadyState", "PiecewiseLinearInitialSoilTemperature",
           "ConstantSaturation", "SaturationWaterTable", "apply_field_initializers"]


def _eval_field_init(spec, grid, shape):
    """A scalar, an array, or a callable ``f(x, z)`` (XYZ fields) / ``f(x)``
    (XY fields) evaluated with numpy in float64, where ``x`` is the column
    coordinate in [0, 1) and ``z`` the cell-centre elevation; the result is
    cast to the grid dtype and broadcast to ``shape``."""
    if callable(spec):
        x = (np.arange(grid.cells) + 0.5) / grid.cells
        if len(shape) == 2:
            spec = spec(x[None, :], grid.vertical.z_centers[:, None])
        else:
            spec = spec(x)
    val = torch.as_tensor(np.asarray(spec, dtype=np.float64), device=grid.device)
    return torch.broadcast_to(val.to(grid.dtype), shape).clone()


def apply_field_initializers(state, grid, inits: dict) -> None:
    """Set each named field from its spec (reference `initializers.jl:23-27`)."""
    for name, spec in (inits or {}).items():
        cur = state[name]
        state.set(**{name: _eval_field_init(spec, grid, tuple(cur.shape)).to(cur.dtype)})


@dataclasses.dataclass(frozen=True)
class DefaultInitializer:
    """No-op model initializer (reference `initializers.jl:36-40`)."""

    def initialize(self, state, model) -> None:
        pass


def _set_profile(state, name: str, profile: torch.Tensor) -> None:
    """Set ``name`` to ``profile`` (``(Nz, 1)`` or a scalar) broadcast to the
    field's shape, in the field's dtype."""
    cur = state[name]
    state.set(**{name: torch.broadcast_to(profile.to(cur.dtype), cur.shape).clone()})


@dataclasses.dataclass(frozen=True)
class ConstantSoilTemperature:
    """T(z) = T0 (reference `soil_model_init.jl:42-57`)."""

    T0: float = 0.0

    def initialize(self, state, model) -> None:
        state.set(temperature=torch.full_like(state.temperature, self.T0))


@dataclasses.dataclass(frozen=True)
class QuasiThermalSteadyState:
    """T(z) = T0 - Qgeo/k_eff * z (reference `soil_model_init.jl:67-86`),
    formed in the grid's dtype."""

    T0: float = 0.0
    Qgeo: float = 0.02
    k_eff: float = 1.0

    def initialize(self, state, model) -> None:
        z = model.grid.z_centers  # (Nz, 1), negative below the surface
        _set_profile(state, "temperature", self.T0 - self.Qgeo / self.k_eff * z)


@dataclasses.dataclass(frozen=True)
class PiecewiseLinearInitialSoilTemperature:
    """Piecewise-linear T from (depth, value) knots, flat extrapolation
    (reference `soil_model_init.jl:96-120`). Depths are positive-down [m]."""

    knots: Tuple[Tuple[float, float], ...] = ((0.0, 0.0),)

    def initialize(self, state, model) -> None:
        f = piecewise_linear(*self.knots)
        _set_profile(state, "temperature", f(-model.grid.z_centers))


@dataclasses.dataclass(frozen=True)
class ConstantSaturation:
    """sat(z) = const (reference `soil_model_init.jl:128-136`)."""

    sat: float = 1.0

    def initialize(self, state, model) -> None:
        state.set(saturation_water_ice=torch.full_like(state.saturation_water_ice, self.sat))


@dataclasses.dataclass(frozen=True)
class SaturationWaterTable:
    """Saturated below the water table depth, constant vadose saturation
    above (reference `soil_model_init.jl:144-161`). As in the JAX package,
    ``water_table_depth`` is a positive-down depth: the reference compares
    ``z <= water_table_depth`` with z negative-up, which saturates nothing
    below the surface unless the depth is negated."""

    vadose_zone_saturation: float = 0.5
    water_table_depth: float = 5.0

    def initialize(self, state, model) -> None:
        z = model.grid.z_centers  # negative below the surface
        sat = torch.where(z <= -self.water_table_depth, torch.ones_like(z),
                          torch.full_like(z, self.vadose_zone_saturation))
        _set_profile(state, "saturation_water_ice", sat)


@dataclasses.dataclass(frozen=True)
class SoilInitializer:
    """Coupled soil initializer; order hydrology -> biogeochem -> energy
    (reference `soil_model_init.jl:6-40`)."""

    energy: Any = dataclasses.field(default_factory=QuasiThermalSteadyState)
    hydrology: Any = dataclasses.field(default_factory=SaturationWaterTable)
    biogeochem: Any = dataclasses.field(default_factory=DefaultInitializer)

    def initialize(self, state, model) -> None:
        self.hydrology.initialize(state, model)
        self.biogeochem.initialize(state, model)
        self.energy.initialize(state, model)
