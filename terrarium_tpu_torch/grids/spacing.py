"""Vertical discretizations (counterpart of ``terrarium_tpu/grids/spacing.py``).

Each spacing yields layer thicknesses listed top-down (index 0 is the surface
layer); :class:`~terrarium_tpu_torch.grids.vertical.VerticalGrid` turns them
into face and centre coordinates.
"""
from __future__ import annotations

import dataclasses
from math import floor, log10
from typing import Optional

import numpy as np

__all__ = ["UniformSpacing", "ExponentialSpacing"]


def _round_sig(x: float, sig: int) -> float:
    if x == 0.0:
        return 0.0
    return round(x, -int(floor(log10(abs(x)))) + (sig - 1))


@dataclasses.dataclass(frozen=True)
class UniformSpacing:
    """N layers of constant thickness dz (reference `vertical_discretization.jl:30-35`)."""

    dz: float = 0.1
    N: int = 100

    def thicknesses(self) -> np.ndarray:
        return np.full(self.N, self.dz, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class ExponentialSpacing:
    """Quasi-exponential spacing from ``dz_min`` (surface) to ``dz_max``
    (bottom): layer thicknesses are log2-interpolated and rounded to ``sig``
    significant digits (reference `vertical_discretization.jl:47-76`)."""

    dz_min: float = 0.05
    dz_max: float = 100.0
    N: int = 50
    sig: Optional[int] = 3

    def __post_init__(self):
        if self.N <= 1:
            raise ValueError("number of grid points for exponential spacing must be > 1")

    def thicknesses(self) -> np.ndarray:
        log_min = np.log2(self.dz_min)
        log_max = np.log2(self.dz_max)
        i = np.arange(self.N, dtype=np.float64)
        dz = np.exp2(log_min + i * (log_max - log_min) / (self.N - 1))
        if self.sig is not None:
            dz = np.array([_round_sig(v, self.sig) for v in dz])
        return dz
