"""Simulation driver (counterpart of ``terrarium_tpu/timesteppers/integrator.py``).

``Simulation.run`` advances the main-path :class:`SoilModel` through the
fused soil column rollout (``ops/fused_step.py``): on a CUDA device the
hand-written kernel, on the CPU its plain version. As in the JAX package's
fused path (`fused_step.py:620`, `integrator.py:305-306`), the rollout
carries only the live state, then one trailing ``closure`` and
``compute_auxiliary`` rebuild the closure variables and auxiliaries from it;
tendencies are zero afterwards.
"""
from __future__ import annotations

import numpy as np
import torch

from .stepping import ForwardEuler
from ..models.initializers import apply_field_initializers
from ..ops.bcs import Dirichlet, bc_call_arity
from ..ops.fused_step import ColumnParams, soil_column_rollout
from ..state import State, build_state, reset_tendencies
from ..utils.utils import convert_dt
from ..variables import Variables

__all__ = ["Simulation", "initialize", "advance", "clock_times", "top_temperature_table"]

#: Launch chunking. A BC that is one value per step runs all ``n`` steps in
#: one launch: the kernel keeps the carry in registers across steps, and
#: each extra launch would only add a read and write of the carry plus the
#: launch latency. A BC that varies per cell needs a ``(steps, cells)``
#: table, so its launches are cut to at most this many table entries.
_MAX_TABLE_ENTRIES = 1 << 24


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
        raise ValueError("the fused rollout takes no input variables as BC values")
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


def _top_temperature_value(bcs):
    """The top temperature value of the only BC the fused rollout takes."""
    top = (bcs or {}).get("temperature", {}).get("top")
    if not isinstance(top, Dirichlet):
        raise ValueError("the fused soil rollout needs a Dirichlet top temperature "
                         "(PrescribedSurfaceTemperature)")
    extra = {(v, s) for v, sides in (bcs or {}).items() for s in sides} - {("temperature", "top")}
    if extra:
        raise ValueError(f"the fused soil rollout supports no other BCs, got {sorted(extra)}")
    return top.value


def advance(model, state: State, ctx, steps: int, dt: float,
            rollout=soil_column_rollout) -> None:
    """``steps`` closure-rotated Forward Euler steps on the live carry with
    ``rollout`` (the kernel wrapper, or its plain version), then the
    trailing ``closure``. Tendencies are zeroed, as the dead leaves of the
    lean carry are. Updates ``state`` in place."""
    value = _top_temperature_value(ctx.bcs)
    grid = model.grid
    params = ColumnParams.of(model, grid.dtype)
    coords = tuple(torch.as_tensor(a, device=grid.device).to(grid.dtype) for a in (
        grid.vertical.dz, grid.vertical.dz_faces, grid.vertical.z_centers,
        grid.vertical.z_faces))
    U, sat, S = (state.prognostic[name].contiguous() for name in model.live_carry)
    times = clock_times(state.clock.time, dt, steps)
    probe = top_temperature_table(value, times[:1], grid)
    chunk = steps if probe.dim() == 1 else max(1, _MAX_TABLE_ENTRIES // grid.cells)
    done = 0
    while done < steps:
        m = min(chunk, steps - done)
        table = top_temperature_table(value, times[done:done + m], grid)
        U, sat, S = rollout(U, sat, S, table, *coords, params, dt)
        done += m
    state.set(internal_energy=U, saturation_water_ice=sat, surface_excess_water=S)
    state.clock.time = torch.as_tensor(times[-1], device=grid.device)
    state.clock.iteration = state.clock.iteration + steps
    reset_tendencies(state)
    model.closure(state, ctx)


class Simulation:
    """Model, state, timestepper and boundary conditions of one run."""

    def __init__(self, model, timestepper, state: State, bcs=None, initializers=None):
        self.model = model
        self.timestepper = timestepper
        self.state = state
        self.bcs = bcs or {}
        self.initializers = initializers or {}
        self.ctx = model.make_context(bcs=self.bcs)

    @property
    def current_time(self) -> float:
        return float(self.state.clock.time)

    @property
    def iteration(self) -> int:
        return int(self.state.clock.iteration)

    def compute_auxiliary(self) -> "Simulation":
        self.model.compute_auxiliary(self.state, self.ctx)
        return self

    def run(self, steps=None, period=None, dt=None) -> "Simulation":
        """Run ``steps`` steps, or a time ``period``, of size ``dt``
        (reference `run!`, `model_integrator.jl:72-88`)."""
        if not isinstance(self.timestepper, ForwardEuler):
            raise NotImplementedError("the port runs ForwardEuler only")
        dt = convert_dt(dt) if dt is not None else self.timestepper.default_dt()
        if steps is None:
            if period is None:
                raise ValueError("either `steps` or `period` must be specified")
            steps = int(convert_dt(period) // dt)
        advance(self.model, self.state, self.ctx, int(steps), dt)
        return self.compute_auxiliary()

    def __repr__(self):
        return (f"Simulation({type(self.model).__name__} on {self.model.grid!r}, "
                f"{type(self.timestepper).__name__}, t={self.current_time:g}s, "
                f"iter={self.iteration})")


def initial_state(model, initializers, ctx) -> State:
    """Allocate, apply the field initializers, then the model initializers
    (reference `model_integrator.jl:96-109`)."""
    state = build_state(Variables.of(model), model.grid)
    apply_field_initializers(state, model.grid, initializers)
    model.initialize(state, ctx)
    return state


def initialize(model, timestepper=None, *, initializers=None,
               boundary_conditions=None) -> Simulation:
    """Create and initialize a :class:`Simulation` (reference `initialize`,
    `model_integrator.jl:145-161`)."""
    timestepper = timestepper if timestepper is not None else ForwardEuler()
    sim = Simulation(model, timestepper, state=None, bcs=boundary_conditions,
                     initializers=initializers)
    sim.state = initial_state(model, sim.initializers, sim.ctx)
    return sim
