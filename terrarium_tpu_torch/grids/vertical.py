"""Vertical finite-volume grid (counterpart of ``terrarium_tpu/grids/vertical.py``).

Positive-up coordinates: the surface is at ``z = 0`` and the soil extends to
negative ``z``. Arrays are stored bottom-up: index 0 is the deepest layer.
Boundary face spacings equal the adjacent cell thickness (Oceananigans halo
convention on a bounded stretched axis).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["VerticalGrid"]


@dataclasses.dataclass(frozen=True, eq=False)
class VerticalGrid:
    """Vertical coordinates as float64 numpy arrays, bottom-up.

    Attributes:
        z_faces: ``(Nz + 1,)`` face elevations, ``z_faces[-1] == 0``.
        z_centers: ``(Nz,)`` cell-centre elevations.
        dz: ``(Nz,)`` cell thicknesses.
        dz_faces: ``(Nz + 1,)`` centre-to-centre spacings at faces.
    """

    z_faces: np.ndarray
    z_centers: np.ndarray
    dz: np.ndarray
    dz_faces: np.ndarray

    @staticmethod
    def from_spacing(spacing) -> "VerticalGrid":
        dz = np.asarray(spacing.thicknesses(), dtype=np.float64)[::-1].copy()
        nz = dz.shape[0]
        z_faces = np.zeros(nz + 1, dtype=np.float64)
        z_faces[:-1] = -np.cumsum(dz[::-1])[::-1]
        z_centers = 0.5 * (z_faces[:-1] + z_faces[1:])
        dz_faces = np.empty(nz + 1, dtype=np.float64)
        dz_faces[1:-1] = z_centers[1:] - z_centers[:-1]
        dz_faces[0] = dz[0]
        dz_faces[-1] = dz[-1]
        return VerticalGrid(z_faces, z_centers, dz, dz_faces)

    @property
    def nz(self) -> int:
        return self.dz.shape[0]
