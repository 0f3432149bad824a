"""Simulation driver (counterpart of ``terrarium_tpu/timesteppers/integrator.py``).

``Simulation.run`` advances a :class:`SoilModel` with ForwardEuler, Heun or
ImplicitEuler through the fused soil column rollout (``ops/fused_step.py``): on a CUDA
device the hand-written kernels, on the CPU their plain version. As in the
JAX package's fused path (`fused_step.py:620`, `integrator.py:305-306`), the
rollout carries only the live state, then one trailing ``closure`` and
``compute_auxiliary`` rebuild the closure variables and auxiliaries from it;
tendencies are zero afterwards. The inputs are left as the JAX package's
default ``run`` leaves them: as the sources set them at the start of the last
step.

The top temperature reaches the kernels in one of two forms. A uniformly
spaced ``TimeSeriesInputSource`` is handed over whole and interpolated in
the kernel, so such a run is one launch. Anything else (a constant, a
``(cells,)`` value, a callable ``f(t)``, a static input, a series with other
spacing) is evaluated here at each clock time into a table.
``Simulation.timestep`` steps through the process modules instead.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .implicit import ImplicitEuler
from .stepping import ForwardEuler, Heun
from ..io.input_sources import FieldInputSource, TimeSeriesInputSource, collect_input_variables
from ..models.initializers import apply_field_initializers
from ..ops.bcs import Dirichlet, bc_call_arity
from ..ops.fused_step import (ROLLOUTS, ColumnParams, SeriesBC, clock_times, kernel_physics,
                              soil_column_rollout_plain)
from ..state import Clock, State, build_state, reset_tendencies
from ..utils.utils import convert_dt
from ..variables import Variables

__all__ = ["Simulation", "initialize", "advance", "clock_times", "top_temperature_table"]

#: Launch chunking. A top temperature that is one value per step, a static
#: row or a uniform series runs all ``n`` steps in one launch: the kernel
#: keeps the carry in registers across steps, and each extra launch would
#: only add a read and write of the carry plus the launch latency. A table
#: that varies per cell and in time is ``(steps, cells)``, so its launches
#: are cut to at most this many table entries.
_MAX_TABLE_ENTRIES = 1 << 24


def top_temperature_table(value, times: np.ndarray, grid) -> torch.Tensor:
    """The top-temperature BC evaluated at each of ``times``: ``(n,)`` when
    the value is the same for every cell, else ``(n, cells)`` (an expanded
    view when the value does not change in time)."""
    n = times.shape[0]
    if isinstance(value, str):
        raise ValueError("an input variable as the top temperature is read from the state "
                         "and its sources (advance), not tabulated from a value")
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


def _uniform_ts_meta(src):
    """``(t0, dts)`` of a uniformly spaced time series, else None (the
    check of `fused_step.py:81-89`)."""
    times = np.asarray(torch.as_tensor(src.times).cpu(), dtype=np.float64)
    if times.ndim != 1 or times.size < 2:
        return None
    d = np.diff(times)
    if not np.allclose(d, d[0], rtol=1e-6, atol=0.0):
        return None
    return float(times[0]), float(d[0])


class _TopTemperature:
    """Where the rollout takes the top temperature from: ``series``, a
    ``(values, t0, dts)`` that the kernel interpolates, or ``table(times)``,
    its values at the clock times ``times``. An input variable is read from
    the last time series in ``sources`` that provides it, in the user's
    order, as each step's ``update_inputs`` leaves it (a static source
    writes only at initialization); without one, from ``state.inputs``."""

    def __init__(self, value, sources, state: State, grid):
        self.series, self.table = None, None
        if not isinstance(value, str):
            self.table = functools.partial(top_temperature_table, value, grid=grid)
            return
        for src in sources:
            if not isinstance(src, (FieldInputSource, TimeSeriesInputSource)):
                raise ValueError(f"the fused rollout takes FieldInputSource and "
                                 f"TimeSeriesInputSource, not {type(src).__name__}")
        like = state.inputs.get(value)
        if like is None or tuple(like.shape) != (grid.cells,):
            raise ValueError(f"the top temperature {value!r} must be an XY input variable "
                             f"of the state")
        series = [s for s in sources if isinstance(s, TimeSeriesInputSource)
                  and value in s.series]
        if not series:
            self.table = lambda times: like[None, :].expand(len(times), grid.cells)
            return
        src = series[-1]
        vals = src.series[value]
        if getattr(vals, "ndim", np.ndim(vals)) not in (1, 2):
            raise ValueError("the fused rollout takes (T,) or (T, cells) series")
        meta = _uniform_ts_meta(src)
        if meta is None:  # any spacing: the source's own interpolation
            self.table = lambda times: src.values_at(value, torch.as_tensor(times), like)
        else:
            v = torch.as_tensor(vals, device=grid.device).to(grid.dtype).contiguous()
            self.series = (v, *meta)


def _stepper_name(timestepper) -> str:
    if isinstance(timestepper, ForwardEuler):
        return "euler"
    if isinstance(timestepper, Heun):
        return "heun"
    if isinstance(timestepper, ImplicitEuler):
        if timestepper.picard_iters != 1:
            raise ValueError(f"the fused soil rollout runs ImplicitEuler with one Picard "
                             f"iteration, got picard_iters={timestepper.picard_iters}; "
                             f"Simulation.timestep runs any")
        return "implicit"
    raise ValueError(f"the fused soil rollout runs ImplicitEuler, ForwardEuler or Heun, "
                     f"not {type(timestepper).__name__}")


def _rollout_fn(stepper: str, physics: str, device: torch.device, plain: bool, solver: str):
    """The rollout of ``(stepper, physics)``: its kernel wrapper, or the
    plain version where asked or where the CPU runs a scheme that has no
    kernel; the implicit ones with ``solver``."""
    kw = {"solver": solver} if stepper == "implicit" else {}
    if plain or (device.type == "cpu" and (stepper, physics) not in ROLLOUTS):
        return functools.partial(soil_column_rollout_plain, stepper=stepper, physics=physics,
                                 **kw)
    if (stepper, physics) not in ROLLOUTS:
        raise ValueError(f"no soil column kernel for {stepper} with the {physics} model; "
                         f"the kernels run {sorted(ROLLOUTS)}")
    return functools.partial(ROLLOUTS[(stepper, physics)], **kw)


def advance(model, state: State, ctx, steps: int, dt: float, *, timestepper=None,
            input_sources=(), plain: bool = False) -> None:
    """``steps`` closure-rotated steps of ``timestepper`` (ForwardEuler by
    default, Heun or ImplicitEuler with one Picard iteration) on the live
    carry, through the kernel of the model and
    stepper (or their plain version, ``plain=True``), then the trailing
    ``closure``. Tendencies are zeroed, as the dead leaves of the lean carry
    are; the inputs are the sources' values at the start of the last step.
    Updates ``state`` in place. Raises ``ValueError`` for a model, stepper,
    boundary condition or source the kernels do not take."""
    timestepper = timestepper if timestepper is not None else ForwardEuler()
    stepper = _stepper_name(timestepper)
    physics = kernel_physics(model)
    grid = model.grid
    params = ColumnParams.of(model, grid.dtype)
    top = _TopTemperature(_top_temperature_value(ctx.bcs), input_sources, state, grid)
    rollout = _rollout_fn(stepper, physics, grid.device, plain,
                          getattr(timestepper, "solver", None))
    coords = tuple(torch.as_tensor(a, device=grid.device).to(grid.dtype) for a in (
        grid.vertical.dz, grid.vertical.dz_faces, grid.vertical.z_centers,
        grid.vertical.z_faces))
    heat, extra = physics == "heat", int(stepper == "heun")
    U = state.prognostic["internal_energy"].contiguous()
    sat = state["saturation_water_ice"].contiguous()
    S = None if heat else state.prognostic["surface_excess_water"].contiguous()
    times = clock_times(state.clock.time, dt, steps)
    if top.series is not None:
        bc = SeriesBC(*top.series, time=float(times[0]), steps=steps)
        U, sat, S = rollout(U, sat, S, bc, *coords, params, dt)
    else:
        probe = top.table(times[:1])
        whole = probe.dim() == 1 or probe.stride(0) == 0
        chunk = steps if whole else max(1, _MAX_TABLE_ENTRIES // grid.cells - extra)
        done = 0
        while done < steps:
            m = min(chunk, steps - done)
            table = top.table(times[done:done + m + extra])
            U, sat, S = rollout(U, sat, S, table, *coords, params, dt)
            done += m
    state.set(internal_energy=U)
    if not heat:
        state.set(saturation_water_ice=sat, surface_excess_water=S)
    clock = Clock(torch.as_tensor(times[-1], device=grid.device),
                  state.clock.iteration + steps)
    if steps > 0:  # the inputs of the last step, as its update_state set them
        state.clock = Clock(torch.as_tensor(times[-2], device=grid.device), clock.iteration)
        for src in input_sources:
            src.update_inputs(state)
    state.clock = clock
    reset_tendencies(state)
    model.closure(state, ctx)


def _on_device(src, device: torch.device):
    """``src`` with its arrays as tensors on ``device``, each in its own
    dtype, so that a run does not copy a series to the card again (the JAX
    package keeps its sources' leaves on the device the same way,
    `integrator.py:57-66`). Sources of other classes are kept as they are."""
    def move(x):
        return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x),
                               device=device)

    if isinstance(src, TimeSeriesInputSource):
        return dataclasses.replace(src, times=move(src.times),
                                   series={k: move(v) for k, v in src.series.items()})
    if isinstance(src, FieldInputSource):
        return dataclasses.replace(src, fields={k: move(v) for k, v in src.fields.items()})
    return src


class Simulation:
    """Model, state, timestepper, input sources and boundary conditions of
    one run."""

    def __init__(self, model, timestepper, state: State, input_sources=(), bcs=None,
                 initializers=None):
        self.model = model
        self.timestepper = timestepper
        self.state = state
        self.input_sources = tuple(_on_device(src, model.grid.device) for src in input_sources)
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

    def timestep(self, dt=None, finalize: bool = True) -> "Simulation":
        """One full step through the process modules (reference
        `timestep!`, `model_integrator.jl:125-131`)."""
        dt = convert_dt(dt) if dt is not None else self.timestepper.default_dt()
        self.timestepper.step(self.model, self.state, self.ctx, dt, self.input_sources)
        if finalize:
            self.compute_auxiliary()
        return self

    def run(self, steps=None, period=None, dt=None) -> "Simulation":
        """Run ``steps`` steps, or a time ``period``, of size ``dt`` through
        the fused rollout (reference `run!`, `model_integrator.jl:72-88`)."""
        dt = convert_dt(dt) if dt is not None else self.timestepper.default_dt()
        if steps is None:
            if period is None:
                raise ValueError("either `steps` or `period` must be specified")
            steps = int(convert_dt(period) // dt)
        advance(self.model, self.state, self.ctx, int(steps), dt,
                timestepper=self.timestepper, input_sources=self.input_sources)
        return self.compute_auxiliary()

    def __repr__(self):
        return (f"Simulation({type(self.model).__name__} on {self.model.grid!r}, "
                f"{type(self.timestepper).__name__}, t={self.current_time:g}s, "
                f"iter={self.iteration})")


def initial_state(model, input_sources, initializers, ctx) -> State:
    """Allocate the model's and the sources' variables, seed the inputs,
    apply the field initializers, then the model initializers (reference
    `model_integrator.jl:96-109`)."""
    state = build_state(Variables.of(model, collect_input_variables(input_sources)),
                        model.grid)
    for src in input_sources:
        src.initialize_inputs(state)
    apply_field_initializers(state, model.grid, initializers)
    model.initialize(state, ctx)
    return state


def initialize(model, timestepper=None, input_sources=(), *, initializers=None,
               boundary_conditions=None) -> Simulation:
    """Create and initialize a :class:`Simulation` (reference `initialize`,
    `model_integrator.jl:145-161`)."""
    timestepper = timestepper if timestepper is not None else ForwardEuler()
    sim = Simulation(model, timestepper, state=None, input_sources=input_sources,
                     bcs=boundary_conditions, initializers=initializers)
    sim.state = initial_state(model, sim.input_sources, sim.initializers, sim.ctx)
    return sim
