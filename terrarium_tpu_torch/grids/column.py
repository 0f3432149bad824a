"""Column grids: batches of laterally independent soil columns (counterpart
of ``terrarium_tpu/grids/column.py``).

The grid carries the dtype and the device of every tensor it allocates; no
global torch default is read or changed.
"""
from __future__ import annotations

import dataclasses

import torch

from .spacing import ExponentialSpacing
from .vertical import VerticalGrid
from ..variables import XY, XYZ

__all__ = ["ColumnGrid"]


@dataclasses.dataclass(frozen=True, eq=False)
class ColumnGrid:
    """``cells`` independent columns over one vertical grid.

    Fields are ``(Nz, cells)`` at centres, ``(Nz + 1, cells)`` at faces and
    ``(cells,)`` for lateral-only variables. Coordinate properties are
    ``(Nz, 1)`` / ``(Nz + 1, 1)`` tensors that broadcast against fields."""

    cells: int
    vertical: VerticalGrid
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")

    @staticmethod
    def of(cells: int = 1, spacing=None, dtype: torch.dtype = torch.float32,
           device="cpu") -> "ColumnGrid":
        spacing = spacing if spacing is not None else ExponentialSpacing()
        return ColumnGrid(cells, VerticalGrid.from_spacing(spacing), dtype,
                          torch.device(device))

    @property
    def nz(self) -> int:
        return self.vertical.nz

    def shape(self, dims) -> tuple:
        if isinstance(dims, XY):
            return (self.cells,)
        if isinstance(dims, XYZ):
            return (self.nz + 1 if dims.face else self.nz, self.cells)
        raise TypeError(f"unknown dims {dims!r}")

    def allocate(self, dims, fill=0.0) -> torch.Tensor:
        return torch.full(self.shape(dims), fill, dtype=self.dtype, device=self.device)

    def _coord(self, values) -> torch.Tensor:
        return torch.as_tensor(values, device=self.device).to(self.dtype)[:, None]

    @property
    def z_centers(self) -> torch.Tensor:
        return self._coord(self.vertical.z_centers)

    @property
    def z_faces(self) -> torch.Tensor:
        return self._coord(self.vertical.z_faces)

    @property
    def dz(self) -> torch.Tensor:
        return self._coord(self.vertical.dz)

    @property
    def dz_faces(self) -> torch.Tensor:
        return self._coord(self.vertical.dz_faces)

    def __repr__(self):
        return (f"ColumnGrid(cells={self.cells}, nz={self.nz}, dtype={self.dtype}, "
                f"device={self.device})")
