"""Linearized backward Euler (counterpart of
``terrarium_tpu/timesteppers/implicit.py``).

The diffusion operators (heat conduction and Richards flow) step implicitly
per column,

    (I/dt - J) du = tend(u^n),   u^{n+1} = u^n + du,

where ``tend`` is the whole explicit tendency at t^n (Flux BCs included) and
``J`` the tridiagonal Jacobian of the diffusive flux divergence, linearized
through the chain factor ``D = d(phi)/d(u)`` of each process's
:class:`ImplicitDiffusionTerms`. A Dirichlet BC on ``phi`` adds ``2 K D /
(dzf dz)`` to its boundary row. Variables without implicit terms take the
explicit Euler update.

These are the module steps (``Simulation.timestep``, ``Simulation.run`` for
the compositions no kernel takes, tests, the module gradient path); they
take the JAX package's arguments, ``step(model, state, ctx, input_sources,
dt)``. ``Simulation.run`` takes the SoilModel, heat + Richards or heat only,
and the LandModel with any number of Picard iterations through the fused
column rollouts (``ops/fused_step.py``, ``ops/land_step.py``): the CUDA
kernels on the card, their plain versions on the CPU. JAX's ``stack_solves`` lays the solves out for the TPU and is not
ported; its ``"diag_attribution_only"`` solver gives wrong results by design
and is refused.
"""
from __future__ import annotations

import dataclasses

import torch

from .stepping import update_state
from ..ops.bcs import Dirichlet, get_bc
from ..ops.tridiag import SOLVERS, diffusion_rows
from ..ops.vertical_ops import apply_flux_bcs
from ..state import State
from ..variables import XY

__all__ = ["ImplicitEuler", "ImplicitDiffusionTerms", "assemble_implicit"]


@dataclasses.dataclass(frozen=True)
class ImplicitDiffusionTerms:
    """The Jacobian ingredients of one prognostic variable's diffusion:
    ``K_faces`` ``(Nz+1, cells)`` of the flux ``q = -K d(phi)/dz``, ``D``
    ``(Nz, cells)`` = d(phi)/d(u) at the centres, the tendency ``scale``
    (0-d or ``(Nz, cells)``) and the name of ``phi`` (for its BCs)."""

    var: str
    K_faces: torch.Tensor
    D: torch.Tensor
    scale: torch.Tensor
    phi_var: str


def assemble_implicit(terms: ImplicitDiffusionTerms, state: State, grid, bcs, dt):
    """The rows ``(a, b, c, rhs)`` of ``(I/dt - J) du = tend(u^n)``
    (`implicit.py:69-117`), each ``(Nz, cells)``: ``ops/tridiag.diffusion_rows``
    with the Dirichlet BCs of ``phi``, and the variable's tendency."""
    a, b, c = diffusion_rows(
        terms.K_faces, terms.D, terms.scale, grid.dz, grid.dz_faces, dt,
        dirichlet_bottom=isinstance(get_bc(bcs, terms.phi_var, "bottom"), Dirichlet),
        dirichlet_top=isinstance(get_bc(bcs, terms.phi_var, "top"), Dirichlet))
    return a, b, c, state.tendencies[terms.var]


def _with_flux_bcs(model, state: State, ctx) -> None:
    """Flux BCs into the tendencies, as the explicit update adds them."""
    specs = model.collated_variables().prognostic
    for name in state.prognostic:
        var_bcs = (ctx.bcs or {}).get(name)
        if var_bcs:
            state.tendencies[name] = apply_flux_bcs(
                state.tendencies[name], var_bcs, state, model.grid.dz,
                xy=isinstance(specs[name].dims, XY))


@dataclasses.dataclass(frozen=True)
class ImplicitEuler:
    """Linearized backward Euler (see the module docstring), with the JAX
    package's defaults.

    ``solver``: ``"pcr"`` (parallel cyclic reduction) or ``"thomas"``; the
    two agree to rounding on these diagonally dominant systems and are kept
    apart, since a threshold (the freeze plateau) may fall either side of a
    rounding. ``picard_iters``: fixed-point iterations of the linearization;
    1 freezes the face conductivities and ``D`` at t^n, each further one
    re-solves the implicit variables around the updated state,
    ``(I/dt - J(u_k)) du = tend(u_k) - (u_k - u^n)/dt``. The SoilModel's
    and the LandModel's fused rollouts run any number."""

    dt: float = 900.0
    solver: str = "pcr"
    picard_iters: int = 1

    def __post_init__(self):
        if self.solver not in SOLVERS:
            raise ValueError(f"ImplicitEuler solver must be one of {sorted(SOLVERS)}, "
                             f"got {self.solver!r}")

    def default_dt(self):
        return self.dt

    def step(self, model, state: State, ctx, input_sources, dt) -> None:
        self._body(model, state, ctx, input_sources, dt)
        model.closure(state, ctx)
        state.tick(dt)

    def pre_closure_step(self, model, state: State, ctx, input_sources, dt) -> None:
        """The step with its closure moved to the front (see
        ``ForwardEuler.pre_closure_step``)."""
        model.closure(state, ctx)
        self._body(model, state, ctx, input_sources, dt)
        state.tick(dt)

    def _body(self, model, state: State, ctx, input_sources, dt) -> None:
        solve = SOLVERS[self.solver]
        grid = model.grid
        update_state(model, state, ctx, input_sources)
        terms = model.implicit_terms(state, ctx) if hasattr(model, "implicit_terms") else ()
        implicit_vars = {t.var for t in terms}
        _with_flux_bcs(model, state, ctx)
        prog = dict(state.prognostic)
        systems = [(t, assemble_implicit(t, state, grid, ctx.bcs, dt)) for t in terms]
        for t, (a, b, c, rhs) in systems:
            prog[t.var] = prog[t.var] + solve(a, b, c, rhs)
        for name in prog:
            if name not in implicit_vars:
                prog[name] = prog[name] + state.tendencies[name] * dt

        # further Picard sweeps re-centre the linearization on the update
        prog_n = {v: state.prognostic[v] for v in implicit_vars}
        for _ in range(max(1, int(self.picard_iters)) - 1):
            st = state.copy()
            st.prognostic = dict(prog)
            model.closure(st, ctx)
            update_state(model, st, ctx, input_sources)
            _with_flux_bcs(model, st, ctx)
            for t in model.implicit_terms(st, ctx):
                a, b, c, _ = assemble_implicit(t, st, grid, ctx.bcs, dt)
                rhs = st.tendencies[t.var] - (st.prognostic[t.var] - prog_n[t.var]) / dt
                prog[t.var] = st.prognostic[t.var] + solve(a, b, c, rhs)
        state.prognostic = prog
        model.timestep(state, ctx, dt)
