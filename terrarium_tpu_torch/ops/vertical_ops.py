"""Vertical finite-volume operators on ``(Nz, cells)`` tensors (counterpart of
``terrarium_tpu/ops/vertical_ops.py``).

Row ``k = 0`` is the bottom layer. Face arrays have ``Nz + 1`` rows; face
``f`` lies between cells ``f - 1`` and ``f``. Divisions by coordinate arrays
are plain divisions (the JAX default ``RECIP_COORD_DIV = False``).
"""
from __future__ import annotations

import torch

from .bcs import Dirichlet, Flux, Neumann, resolve_bc_value

__all__ = ["ghosts", "grad_faces", "interp_faces_mid", "div_faces", "apply_flux_bcs"]


def ghosts(c, bc_bottom, bc_top, state, dz_faces):
    """Ghost values below and above the column for ``c``, each ``(1, cells)``
    (Oceananigans halo fill, reference `state_variables.jl:85-100`):
    Dirichlet ``2*value - c_boundary``; Neumann ``c_boundary -/+ g*dz_face``;
    Flux or no BC the boundary value itself (zero gradient)."""
    c_bot, c_top = c[:1], c[-1:]

    def one(bc, c_bnd, sign, dzf):
        if isinstance(bc, Dirichlet):
            return 2.0 * resolve_bc_value(bc.value, state) - c_bnd
        if isinstance(bc, Neumann):
            return c_bnd + sign * resolve_bc_value(bc.gradient, state) * dzf
        return c_bnd

    return (one(bc_bottom, c_bot, -1.0, dz_faces[:1]),
            one(bc_top, c_top, +1.0, dz_faces[-1:]))


def _face_operands(c, ghost_bottom, ghost_top):
    """``upper[f] = ce[f]`` and ``lower[f] = ce[f - 1]`` over the padded
    column ``ce = [ghost_bottom, c, ghost_top]``."""
    if ghost_bottom is None:
        ghost_bottom = c[:1]
    if ghost_top is None:
        ghost_top = c[-1:]
    shape = (1,) + tuple(c.shape[1:])
    upper = torch.cat([c, torch.broadcast_to(ghost_top, shape)], dim=0)
    lower = torch.cat([torch.broadcast_to(ghost_bottom, shape), c], dim=0)
    return upper, lower


def grad_faces(c, dz_faces, ghost_bottom=None, ghost_top=None):
    """``dc/dz`` at every face: ``(c[f] - c[f-1]) / dz_faces[f]``."""
    upper, lower = _face_operands(c, ghost_bottom, ghost_top)
    return (upper - lower) / dz_faces


def interp_faces_mid(c, ghost_bottom=None, ghost_top=None):
    """Arithmetic mean of a centre field at every face."""
    upper, lower = _face_operands(c, ghost_bottom, ghost_top)
    return 0.5 * (upper + lower)


def div_faces(q, dz):
    """Centre divergence of a face flux: ``(q[k+1] - q[k]) / dz[k]``."""
    return (q[1:] - q[:-1]) / dz


def apply_flux_bcs(tend, var_bcs, state, dz, xy: bool):
    """Add Flux-BC contributions to a tendency (reference
    `abstract_timestepper.jl:70-72`): for an XYZ tendency
    ``tend[top] -= q_top / dz[top]`` and ``tend[bottom] += q_bot / dz[bottom]``;
    for an XY tendency (``xy=True``) the flux is added as it is."""
    if not var_bcs:
        return tend
    top, bot = var_bcs.get("top"), var_bcs.get("bottom")
    if xy:
        if isinstance(top, Flux):
            tend = tend - resolve_bc_value(top.value, state)
        if isinstance(bot, Flux):
            tend = tend + resolve_bc_value(bot.value, state)
        return tend
    rows = list(tend.unbind(0))
    if isinstance(top, Flux):
        rows[-1] = rows[-1] - resolve_bc_value(top.value, state) / dz[-1]
    if isinstance(bot, Flux):
        rows[0] = rows[0] + resolve_bc_value(bot.value, state) / dz[0]
    return torch.stack(rows)
