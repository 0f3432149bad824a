"""Soil hydrology: immobile water (NoFlow) and Richards-equation flow
(counterpart of ``terrarium_tpu/processes/soil/hydrology.py``).

The default, as in the JAX package, is ``NoFlow`` over
``SoilHydraulicsSURFEX``: the saturation is an auxiliary that no process
changes, and the soil model is heat conduction only. Richards flow is ported
in the reference's parity mode (no ``deficit_pool``, no ``vwc_forcing``, no
evapotranspiration or runoff siblings). The saturation adjustment runs the
reference's two sequential sweeps literally, one row at a time, in the order
the CUDA column kernel uses.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .hydraulics import SoilHydraulicsSURFEX
from ...ops.bcs import get_bc
from ...ops.vertical_ops import div_faces, ghosts, grad_faces
from ...variables import XY, XYZ, auxiliary, input, prognostic

__all__ = ["NoFlow", "RichardsEq", "SoilSaturationPressureClosure", "SoilHydrology",
           "saturation_sweeps", "pool_drainage"]


class _SaturationSweeps(torch.autograd.Function):
    """The two sweeps of the saturation adjustment, with their derivative
    defined by one predicate per level.

    Forward, on rows ``k = 0`` (bottom) up: ``sat_up[k] = min(sat[k] +
    c/dz[k], 1)`` and ``c = max((sat[k] - 1)*dz[k] + c, 0)``; then from the
    top down: ``new[k] = max(sat_up[k] - c2/dz[k], 0)`` and ``c2 =
    max(-sat_up[k]*dz[k] + c2, 0)``. Returns ``new`` and the spill ``c``
    past the top layer.

    Derivative convention. A level *spills* iff ``sat[k] + c/dz[k] >= 1``:
    then it is ``(1, (sat[k] - 1)*dz[k] + c)``, else ``(sat[k] + c/dz[k],
    0)``. A level is *clipped* iff ``sat_up[k] - c2/dz[k] <= 0``: then it is
    ``(0, c2 - sat_up[k]*dz[k])``, else ``(sat_up[k] - c2/dz[k], 0)``. Each
    level is differentiated as the branch its predicate picks, so at a tie
    (an exactly saturated or exactly empty layer) the water goes either to
    the layer or to the carry, never to both. That keeps the derivative of
    the conserved total ``sum(sat*dz) + spill`` exact: ``dz[k]`` with respect
    to ``sat[k]`` at every level. ``torch.clamp`` would pass the cotangent to
    both sides at such a tie and count the water twice; the JAX package's
    closed form splits it 0.5/0.5 inside its radix-4 prefix scan. The CUDA
    adjoint kernel (``csrc/soil_step.cuh``) uses the same predicates."""

    @staticmethod
    def forward(ctx, sat, dz):
        rows, dzr = sat.unbind(0), dz.unbind(0)
        nz = len(rows)
        c = torch.zeros_like(rows[0])
        up, spill = [], []
        for k in range(nz):
            x = rows[k] + c / dzr[k]
            spill.append(x >= 1.0)
            up.append(torch.clamp(x, max=1.0))
            c = torch.clamp((rows[k] - 1.0) * dzr[k] + c, min=0.0)
        c2 = torch.zeros_like(c)
        new, clip = [None] * nz, [None] * nz
        for k in reversed(range(nz)):
            y = up[k] - c2 / dzr[k]
            clip[k] = y <= 0.0
            new[k] = torch.clamp(y, min=0.0)
            c2 = torch.clamp(-up[k] * dzr[k] + c2, min=0.0)
        ctx.save_for_backward(dz, torch.stack(spill), torch.stack(clip))
        return torch.stack(new), c

    @staticmethod
    def backward(ctx, g_new, g_c):
        dz, spill, clip = ctx.saved_tensors
        dzr = dz.unbind(0)
        nz = spill.shape[0]
        # down sweep in reverse: bottom level first; the deficit leaving
        # the bottom is dropped, so its cotangent is 0
        g2 = torch.zeros_like(g_c)
        g_up = [None] * nz
        for k in range(nz):
            g_up[k] = torch.where(clip[k], -g2 * dzr[k], g_new[k])
            g2 = torch.where(clip[k], g2, -g_new[k] / dzr[k])
        # up sweep in reverse: the spill's cotangent enters at the top
        g = g_c
        g_sat = [None] * nz
        for k in reversed(range(nz)):
            g_sat[k] = torch.where(spill[k], g * dzr[k], g_up[k])
            g = torch.where(spill[k], g, g_up[k] / dzr[k])
        return torch.stack(g_sat), None


def saturation_sweeps(sat, dz):
    """``(adjusted saturation, spill past the top)`` of the saturation
    adjustment for ``sat`` ``(Nz, cells)`` and ``dz`` ``(Nz, 1)``; see
    :class:`_SaturationSweeps` for the derivative convention."""
    return _SaturationSweeps.apply(sat, dz)


def pool_drainage(S):
    """The parity surface-pool term ``min(0, S)`` (reference
    `soil_hydrology.jl:260-283`). Its derivative is 0 at ``S == 0``: an
    empty pool neither drains nor grows, so the pool carries its cotangent
    unchanged (the JAX package's ``jnp.minimum`` splits it 0.5/0.5 there)."""
    return torch.where(S < 0.0, S, 0.0)


@dataclasses.dataclass(frozen=True)
class NoFlow:
    """Immobile soil water (reference `soil_hydrology.jl:13`)."""


@dataclasses.dataclass(frozen=True)
class RichardsEq:
    """Mixed saturation-pressure Richards flow (reference `soil_hydrology_rre.jl:18`)."""


@dataclasses.dataclass(frozen=True)
class SoilSaturationPressureClosure:
    """Saturation <-> total head Psi = psi_m + psi_z + psi_h (reference
    `soil_hydraulic_closures.jl:12`); driven by :class:`SoilHydrology`."""

    def variables(self):
        return (auxiliary("pressure_head", XYZ(), units="m",
                          desc="Total hydraulic pressure head in m"),)


def _shift_up(x, fill):
    """Row ``f`` of the result is ``x[f - 1]``; row 0 is ``fill``."""
    return torch.cat([torch.full_like(x[:1], fill), x[:-1]], dim=0)


def _shift_down(x, fill):
    """Row ``f`` of the result is ``x[f + 1]``; the top row is ``fill``."""
    return torch.cat([x[1:], torch.full_like(x[:1], fill)], dim=0)


@dataclasses.dataclass(frozen=True)
class SoilHydrology:
    """Soil water balance (reference `soil_hydrology.jl:21-53`). The
    defaults are the JAX package's: ``NoFlow`` over ``SoilHydraulicsSURFEX``
    (Brooks-Corey curve, linear conductivity). Richards flow is
    ``vertical_flow=RichardsEq()``."""

    vertical_flow: Any = NoFlow()
    closure_rel: SoilSaturationPressureClosure = SoilSaturationPressureClosure()
    hydraulic_properties: Any = dataclasses.field(default_factory=SoilHydraulicsSURFEX)

    @property
    def richards(self) -> bool:
        return isinstance(self.vertical_flow, RichardsEq)

    def variables(self):
        if self.richards:  # reference `soil_hydrology_rre.jl:20-26`
            return (
                prognostic("saturation_water_ice", XYZ(), closure=self.closure_rel,
                           domain=(0.0, 1.0),
                           desc="Saturation level of water+ice in the pore space"),
                prognostic("surface_excess_water", XY(), units="m",
                           desc="Excess water at the soil surface in m^3/m^2"),
                auxiliary("hydraulic_conductivity", XYZ(face=True), units="m/s",
                          desc="Hydraulic conductivity at cell faces"),
                auxiliary("water_table", XY(), units="m", desc="Elevation of the water table"),
                input("liquid_water_fraction", XYZ(), default=1.0, domain=(0.0, 1.0),
                      desc="Fraction of unfrozen water in the pore space"),
            )
        return (  # NoFlow, reference `soil_hydrology.jl:78-83`
            auxiliary("saturation_water_ice", XYZ(), domain=(0.0, 1.0),
                      desc="Saturation level of water+ice in the pore space"),
            auxiliary("water_table", XY(), units="m", desc="Elevation of the water table"),
            auxiliary("hydraulic_conductivity", XYZ(face=True), units="m/s",
                      desc="Hydraulic conductivity at cell faces"),
            input("liquid_water_fraction", XYZ(), default=1.0, domain=(0.0, 1.0),
                  desc="Fraction of unfrozen water in the pore space"),
        )

    def center_hydraulic_conductivity(self, state, soil):
        vol = soil.strat.soil_volume(soil.biogeochem, state)
        return self.hydraulic_properties.hydraulic_conductivity(vol)

    def compute_hydraulics(self, state, grid, soil):
        """Face K as the reference kernel fills it (`soil_hydrology.jl:145-163`):
        bottom face = bottom-centre K, interior faces = min of the two
        neighbours, and both top faces = top-centre K."""
        Kc = torch.broadcast_to(self.center_hydraulic_conductivity(state, soil),
                                (grid.nz, grid.cells))
        K_face = torch.cat([Kc[:1], torch.minimum(Kc[:-2], Kc[1:-1]),
                            Kc[-1:], Kc[-1:]], dim=0)
        state.set(hydraulic_conductivity=K_face)

    def compute_water_table(self, state, grid):
        """Elevation of the face below the lowest cell with sat < 1; the
        surface if every cell is saturated (reference `soil_hydrology.jl:170-175`)."""
        zf = grid.z_faces
        masked = torch.where(state.saturation_water_ice < 1.0, zf[:-1], zf[-1])
        state.set(water_table=masked.amin(dim=0))

    def adjust_saturation_profile(self, state, grid):
        """Mass-conserving redistribution (reference `soil_hydrology.jl:185-218`).

        Up sweep, bottom to top: ``c[k] = max(0, (sat[k] - 1)*dz[k] + c[k-1])``
        and ``sat_up[k] = min(sat[k] + c[k-1]/dz[k], 1)``; the spill ``c[top]``
        goes unscaled to ``surface_excess_water``. Down sweep, top to bottom,
        on ``-sat_up[k]*dz[k]`` with the same recurrence; every layer ends as
        ``max(sat_up - c2_in/dz, 0)``, which also clips a residual bottom
        deficit (the reference's acknowledged mass-balance violation)."""
        new, spill = saturation_sweeps(state.saturation_water_ice, grid.dz)
        state.set(saturation_water_ice=new,
                  surface_excess_water=state.surface_excess_water + spill)

    def initialize(self, state, grid, soil, constants, ctx):
        """Richards: closure from the initial saturation, then the face K
        (reference `soil_hydrology_rre.jl:33-47`). NoFlow: the face K and
        the water table (reference `soil_hydrology.jl:113-117`)."""
        if self.richards:
            self.closure(state, grid, soil, constants, ctx)
            self.compute_hydraulics(state, grid, soil)
        else:
            self.compute_hydraulics(state, grid, soil)
            self.compute_water_table(state, grid)

    def compute_auxiliary(self, state, grid, soil, constants, ctx):
        self.compute_hydraulics(state, grid, soil)

    def compute_tendencies(self, state, grid, soil, constants, ctx):
        """Darcy flux divergence over porosity (reference
        `soil_hydrology_rre.jl:95-131`, `soil_hydrology.jl:222-237`) and the
        parity surface-pool term ``+min(0, S)`` (`soil_hydrology.jl:260-283`).
        NoFlow has none (reference `soil_hydrology.jl:126`)."""
        if not self.richards:
            return
        grad, K_eff = self._darcy_faces(state, grid, ctx)
        q = -K_eff * grad
        dtheta_dt = -div_faces(q, grid.dz)
        por = soil.strat.bulk_porosity(soil.biogeochem)
        state.add_tendencies(saturation_water_ice=dtheta_dt / por)
        state.add_tendencies(surface_excess_water=pool_drainage(state.surface_excess_water))

    def _darcy_faces(self, state, grid, ctx):
        """The pressure-head gradient at every face (with the BC ghosts) and
        the face conductivity of the Darcy flux: the min of the face's K and
        its neighbour's in the direction of flow, the +inf fill at the ends
        leaving the boundary face's own K."""
        psi = state.pressure_head
        g_bot, g_top = ghosts(psi, get_bc(ctx.bcs, "pressure_head", "bottom"),
                              get_bc(ctx.bcs, "pressure_head", "top"), state,
                              grid.dz_faces)
        grad = grad_faces(psi, grid.dz_faces, g_bot, g_top)
        K = state.hydraulic_conductivity
        K_eff = torch.where(grad < 0.0,
                            torch.minimum(_shift_up(K, torch.inf), K),
                            torch.minimum(K, _shift_down(K, torch.inf)))
        return grad, K_eff

    def implicit_diffusion_terms(self, state, grid, soil, constants, ctx):
        """The implicit Richards solve's Jacobian ingredients
        (`hydrology.py:368-396`): the Darcy face conductivities at t^n, D =
        d(Psi)/d(sat) = psi_m'(theta) * por, scale 1/por; None for NoFlow."""
        if not self.richards:
            return None
        from ...timesteppers.implicit import ImplicitDiffusionTerms

        _, K_eff = self._darcy_faces(state, grid, ctx)
        por = soil.strat.bulk_porosity(soil.biogeochem)
        theta = state.saturation_water_ice * por
        shape = (grid.nz, grid.cells)
        D = self.hydraulic_properties.swrc.inverse_deriv(theta, por) * por
        scale = torch.full(shape, 1.0 / por, dtype=grid.dtype, device=grid.device)
        return ImplicitDiffusionTerms(
            var="saturation_water_ice", K_faces=K_eff, D=torch.broadcast_to(D, shape),
            scale=scale, phi_var="pressure_head")

    def _psi_components(self, state, grid):
        z = grid.z_centers
        psi_z = z - float(grid.vertical.z_faces[-1])
        psi_h = torch.clamp(state.water_table[None, :] - z, min=0.0)
        return psi_z, psi_h

    def closure(self, state, grid, soil, constants, ctx=None):
        """Saturation to pressure head (reference `soil_hydraulic_closures.jl:23-44`):
        adjust the profile, update the water table, then
        Psi = psi_h + psi_m + psi_z. NoFlow has no closure."""
        if not self.richards:
            return
        self.adjust_saturation_profile(state, grid)
        self.compute_water_table(state, grid)
        self.compute_pressure_head(state, grid, soil)

    def compute_pressure_head(self, state, grid, soil):
        """Psi = psi_h + psi_m + psi_z from the (adjusted) saturation and the
        water table."""
        por = soil.strat.bulk_porosity(soil.biogeochem)
        psi_m = self.hydraulic_properties.swrc.inverse(
            state.saturation_water_ice * por, por)
        psi_z, psi_h = self._psi_components(state, grid)
        state.set(pressure_head=psi_h + psi_m + psi_z)

    def invclosure(self, state, grid, soil, constants, ctx=None):
        """Pressure head to saturation (reference `soil_hydraulic_closures.jl:51-100`),
        then the adjustment and the water table. NoFlow has none."""
        if not self.richards:
            return
        psi_z, psi_h = self._psi_components(state, grid)
        psi_m = state.pressure_head - psi_h - psi_z
        por = soil.strat.bulk_porosity(soil.biogeochem)
        theta = self.hydraulic_properties.swrc(psi_m, por)
        state.set(saturation_water_ice=theta / por)
        self.adjust_saturation_profile(state, grid)
        self.compute_water_table(state, grid)
