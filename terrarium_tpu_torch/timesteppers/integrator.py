"""Simulation driver (counterpart of ``terrarium_tpu/timesteppers/integrator.py``).

``Simulation.run`` (through :func:`advance`) takes one of two paths, chosen
by the types of the model, stepper, boundary conditions, input sources and
forcings before anything launches:

* **a column kernel**, for the compositions the kernels take: a
  :class:`SoilModel` with heat + Richards flow or heat only, stepped by
  ForwardEuler, Heun or ImplicitEuler (any number of Picard iterations),
  with a Dirichlet top temperature (a value, ``f(t)`` or an input variable)
  as its only BC (``ops/fused_step.py``); a
  :class:`LandModel` of the kernel's classes, with or without a snowpack,
  stepped by ForwardEuler, Heun or ImplicitEuler (any number of Picard
  iterations), with its coupling BCs only (``ops/land_step.py``); either with
  ``FieldInputSource`` / ``TimeSeriesInputSource`` sources and no
  forcings. On a CUDA device the hand-written kernel runs (its
  instantiation for the composition's classes, dtype and depth, compiled at
  its first launch where it is not prebuilt: ``ops/cuda_build.py``), on the
  CPU its plain version; a kernel that fails to build or launch raises. As in the
  JAX package's fused path (`fused_step.py:620`, `integrator.py:305-306`),
  the rollout carries only the live state, then one trailing ``closure``
  and ``compute_auxiliary`` rebuild the closure variables and auxiliaries
  from it; tendencies are zero afterwards.
* **the process modules**, for every other composition: ``n`` calls of the
  stepper's ``pre_closure_step`` on the whole state, then ``closure``
  (JAX's default lean scan, `integrator.py:150-201`, which
  ``autodiff.make_rollout_fn(lean=True)`` runs with autograd), on the
  state's device. The tendencies are left as the last step left them (its
  Flux-BC contributions and forcings included, Heun's the mean of its two
  stages), as JAX's lean scan, whose last step runs on the whole state
  (`utils/scan_dce.py:125-177`), leaves them.

On both paths the inputs are left as the JAX package's default ``run``
leaves them: as the sources set them at the start of the last step.

The top temperature reaches the kernels in one of two forms. A uniformly
spaced ``TimeSeriesInputSource`` is handed over whole and interpolated in
the kernel, so such a run is one launch. Anything else (a constant, a
``(cells,)`` value, a callable ``f(t)``, a static input, a series with other
spacing) is evaluated here at each clock time into a table.
The land rollout reads its inputs the same way: a uniform series in the
kernel, anything else as the state holds it (static).
``Simulation.timestep`` always steps the process modules.

``advance(..., window=(rows, dts))`` is a chunk of a streamed run
(``io/forcing_pipeline.py``'s ``run_fused``): its series are one window of
a longer one, already on the state's device, each of which must have
``rows`` rows at the uniform spacing ``dts`` (``fused_step.window_meta``
raises naming both where the kernels take a series: the top temperature's
``SeriesBC`` and :func:`land_inputs`); it runs on a column kernel or
raises, never on the process modules.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .stepping import ForwardEuler
from ..io.input_sources import FieldInputSource, TimeSeriesInputSource, collect_input_variables
from ..models.initializers import apply_field_initializers
from ..models.land_model import LandModel, coupling_bcs
from ..models.soil_model import SoilModel
from ..ops import land_step
from ..ops.bcs import InputRef, bc_call_arity
from ..ops.fused_step import (ROLLOUTS, STEPPERS, ColumnParams, SeriesBC, clock_times,
                              kernel_physics, soil_column_rollout_plain, top_temperature_table,
                              top_temperature_value, uniform_ts_meta, window_meta)
from ..state import Clock, State, build_state, reset_tendencies
from ..utils.utils import convert_dt
from ..variables import Variables

__all__ = ["Simulation", "initialize", "advance", "column_scheme", "clock_times",
           "top_temperature_table"]

#: Launch chunking. A top temperature that is one value per step, a static
#: row or a uniform series runs all ``n`` steps in one launch: the kernel
#: keeps the carry in registers across steps, and each extra launch would
#: only add a read and write of the carry plus the launch latency. A table
#: that varies per cell and in time is ``(steps, cells)``, so its launches
#: are cut to at most this many table entries.
_MAX_TABLE_ENTRIES = 1 << 24


_SOURCES = (FieldInputSource, TimeSeriesInputSource)


def column_scheme(model, timestepper, ctx, input_sources=()):
    """The column rollout that runs this composition, decided by type alone:
    ``("land", stepper)`` (``ops/land_step.py``), a soil ``(stepper,
    physics)`` (``ops/fused_step.py``; every key of ``ROLLOUTS``), the
    ImplicitEuler ones with any number of Picard iterations, or ``None``,
    where only the process modules step it: a forcing, a source of another
    class, any other model, stepper, boundary condition or top-temperature
    form. The grid's dtype and depth play no part: the kernel of any size is
    built at its first launch."""
    if getattr(ctx, "forcings", None) or any(type(s) not in _SOURCES for s in input_sources):
        return None
    stepper = STEPPERS.get(type(timestepper))
    if stepper is None:
        return None
    if type(model) is LandModel:
        if (ctx.bcs or {}) != coupling_bcs():
            return None
        try:
            land_step.land_composition(model)
        except ValueError:  # a class the land kernel does not run
            return None
        for src in input_sources:
            if isinstance(src, TimeSeriesInputSource) and any(
                    n in land_step.LAND_INPUTS for n in src.series) and (
                    uniform_ts_meta(src.times) is None
                    or any(np.ndim(v) not in (1, 2) for v in src.series.values())):
                return None  # the land kernel reads uniformly spaced (T,) / (T, cells) series
        return "land", stepper
    if type(model) is not SoilModel:
        return None
    try:
        value = top_temperature_value(ctx.bcs)
        physics = kernel_physics(model)
    except ValueError:  # another BC, or a soil the column code does not run
        return None
    if isinstance(value, InputRef) or (callable(value) and bc_call_arity(value) >= 2):
        return None  # the column code reads the top temperature without the state
    return stepper, physics


class _TopTemperature:
    """Where the rollout takes the top temperature from: ``series``, a
    ``(values, t0, dts)`` that the kernel interpolates, or ``table(times)``,
    its values at the clock times ``times``. An input variable is read from
    the last time series in ``sources`` that provides it, in the user's
    order, as each step's ``update_inputs`` leaves it (a static source
    writes only at initialization); without one, from ``state.inputs``.
    With ``window`` ``(rows, dts)`` the series is a streamed window, held to
    that length and spacing (``fused_step.window_meta``)."""

    def __init__(self, value, sources, state: State, grid, window=None):
        self.series, self.table = None, None
        if not isinstance(value, str):
            self.table = functools.partial(top_temperature_table, value, grid=grid)
            return
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
        meta = (uniform_ts_meta(src.times) if window is None
                else window_meta(src.times, vals.shape[0], window))
        if meta is None:  # any spacing: the source's own interpolation
            self.table = lambda times: src.values_at(value, torch.as_tensor(times), like)
        else:
            v = torch.as_tensor(vals, device=grid.device).to(grid.dtype).contiguous()
            self.series = (v, *meta)


def _rollout_fn(stepper: str, physics: str, plain: bool, timestepper):
    """The rollout of ``(stepper, physics)``: its kernel wrapper (which runs
    the plain version on CPU tensors), or the plain version where asked; the
    implicit ones with the timestepper's solver and Picard count."""
    kw = ({"solver": timestepper.solver, "picard_iters": int(timestepper.picard_iters)}
          if stepper == "implicit" else {})
    if plain:
        return functools.partial(soil_column_rollout_plain, stepper=stepper, physics=physics,
                                 **kw)
    return functools.partial(ROLLOUTS[(stepper, physics)], **kw)


def _coords(grid) -> tuple:
    return tuple(torch.as_tensor(a, device=grid.device).to(grid.dtype) for a in (
        grid.vertical.dz, grid.vertical.dz_faces, grid.vertical.z_centers,
        grid.vertical.z_faces))


def land_inputs(model, state: State, sources, window=None) -> dict:
    """The :class:`~terrarium_tpu_torch.ops.land_step.LandInput` of each input
    the land step reads that the model has: from the last uniformly spaced
    ``TimeSeriesInputSource`` in ``sources`` that provides it, else as the
    state holds it (a static ``FieldInputSource`` value or the default).
    Raises ``ValueError`` for a source of another class or a series of
    uneven spacing, and, with ``window`` ``(rows, dts)`` (a streamed
    window), for a series of another length or spacing
    (``fused_step.window_meta``)."""
    grid = model.grid
    for src in sources:
        if not isinstance(src, (FieldInputSource, TimeSeriesInputSource)):
            raise ValueError(f"the land rollout takes FieldInputSource and "
                             f"TimeSeriesInputSource, not {type(src).__name__}")
    out = {}
    for name in land_step.LAND_INPUTS:
        if name not in state.inputs:
            continue
        series = [s for s in sources if isinstance(s, TimeSeriesInputSource) and name in s.series]
        if not series:
            out[name] = land_step.LandInput(state.inputs[name][None, :].contiguous())
            continue
        src = series[-1]
        vals = torch.as_tensor(src.series[name], device=grid.device).to(grid.dtype).contiguous()
        meta = (uniform_ts_meta(src.times) if window is None
                else window_meta(src.times, vals.shape[0], window))
        if meta is None or vals.dim() not in (1, 2):
            raise ValueError(f"the land rollout reads uniformly spaced (T,) or (T, cells) "
                             f"series; {name!r} is not one")
        out[name] = land_step.LandInput(vals, *meta)
    return out


def _advance_land(model, state: State, ctx, steps: int, dt: float, timestepper, input_sources,
                  plain: bool, times, stepper: str, window) -> None:
    """The land column rollout of ``advance``, of ``stepper`` (and the
    timestepper's solver and Picard count)."""
    grid = model.grid
    params = land_step.LandParams.of(model, grid.dtype)
    inputs = land_inputs(model, state, input_sources, window)
    carry = {n: state[n].contiguous() for n in land_step.carry_names(params)}
    root = state.auxiliary["root_fraction"] if model.vegetation is not None else None
    kw = ({"solver": timestepper.solver, "picard_iters": int(timestepper.picard_iters)}
          if stepper == "implicit" else {})
    if plain:
        rollout = functools.partial(land_step.land_column_rollout_plain, stepper=stepper, **kw)
    else:
        rollout = functools.partial(land_step.ROLLOUTS[stepper], **kw)
    out = rollout(carry, inputs, root, *_coords(grid), params, dt, float(times[0]), steps)
    state.set(**out)


def _advance_soil(model, state: State, ctx, steps: int, dt: float, timestepper, input_sources,
                  plain: bool, times, scheme, window) -> None:
    """The soil column rollout of ``advance``."""
    stepper, physics = scheme
    grid = model.grid
    params = ColumnParams.of(model, grid.dtype)
    top = _TopTemperature(top_temperature_value(ctx.bcs), input_sources, state, grid, window)
    rollout = _rollout_fn(stepper, physics, plain, timestepper)
    coords = _coords(grid)
    heat, extra = physics == "heat", int(stepper == "heun")
    U = state.prognostic["internal_energy"].contiguous()
    sat = state["saturation_water_ice"].contiguous()
    S = None if heat else state.prognostic["surface_excess_water"].contiguous()
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


def _advance_modules(model, state: State, ctx, steps: int, dt: float, timestepper,
                     input_sources) -> None:
    """The module path of ``advance``: ``steps`` closure-rotated steps on
    the whole state, then ``closure`` (`integrator.py:180-201`); a stepper
    without ``pre_closure_step`` takes ``steps`` full steps."""
    rotated = getattr(timestepper, "pre_closure_step", None)
    for _ in range(steps):
        (rotated or timestepper.step)(model, state, ctx, input_sources, dt)
    if rotated is not None:
        model.closure(state, ctx)


def advance(model, state: State, ctx, steps: int, dt: float, *, timestepper=None,
            input_sources=(), plain: bool = False, window=None) -> None:
    """``steps`` steps of ``timestepper`` (ForwardEuler by default),
    updating ``state`` in place.

    A composition a column rollout takes (:func:`column_scheme`) runs the
    closure-rotated steps on the live carry through that rollout's kernel
    (its plain version on CPU tensors, or on any device with
    ``plain=True``), then the trailing ``closure``; tendencies are zeroed,
    as the dead leaves of the lean carry are, and the inputs are the
    sources' values at the start of the last step. Every other composition
    runs the process modules (``pre_closure_step`` ``steps`` times, then
    ``closure``), which leave the last step's tendencies and inputs.

    ``window`` ``(rows, dts)``: the series are one window of a streamed
    run, each held to that length and spacing; the run takes a column
    rollout or raises ``ValueError``."""
    timestepper = timestepper if timestepper is not None else ForwardEuler()
    scheme = column_scheme(model, timestepper, ctx, input_sources)
    land = scheme is not None and scheme[0] == "land"
    if scheme is None and window is not None:
        raise ValueError(f"a streamed window runs on the column rollout kernels, which take "
                         f"none of {type(model).__name__} with {type(timestepper).__name__}, "
                         f"these boundary conditions, forcings and sources "
                         f"({', '.join(type(s).__name__ for s in input_sources)}); "
                         f"integrator.column_scheme says which do")
    if scheme is None:
        _advance_modules(model, state, ctx, steps, dt, timestepper, input_sources)
        return
    times = clock_times(state.clock.time, dt, steps)
    if land:
        _advance_land(model, state, ctx, steps, dt, timestepper, input_sources, plain, times,
                      scheme[1], window)
    else:
        _advance_soil(model, state, ctx, steps, dt, timestepper, input_sources, plain, times,
                      scheme, window)
    grid = model.grid
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
    `integrator.py:57-66`). Sources of other classes are kept as they are: a
    ``ChunkedForcingPipeline`` keeps its series on the host and stages them
    window by window (``io/forcing_pipeline.py``)."""
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
    """Model, state, timestepper, input sources, boundary conditions and
    forcings of one run."""

    def __init__(self, model, timestepper, state: State, input_sources=(), bcs=None,
                 initializers=None, forcings=None):
        self.model = model
        self.timestepper = timestepper
        self.state = state
        self.input_sources = tuple(_on_device(src, model.grid.device) for src in input_sources)
        self.bcs = bcs or {}
        self.initializers = initializers or {}
        self.forcings = dict(forcings or {})
        self.ctx = model.make_context(bcs=self.bcs)
        if self.forcings:
            self.ctx = self.ctx.with_forcings(self.forcings)
        #: steps a chunk of ``ChunkedForcingPipeline.run_fused`` is a multiple
        #: of (the JAX package's ``inner_steps`` of its fused rollout,
        #: `integrator.py:86`); None until set, which ``run_fused`` refuses
        self.fused_inner_steps = None

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
        self.timestepper.step(self.model, self.state, self.ctx, self.input_sources, dt)
        if finalize:
            self.compute_auxiliary()
        return self

    def _advance(self, steps: int, dt) -> None:
        advance(self.model, self.state, self.ctx, steps, dt, timestepper=self.timestepper,
                input_sources=self.input_sources)

    def run(self, steps=None, period=None, dt=None, callbacks=(),
            callback_interval: int = 0) -> "Simulation":
        """Run ``steps`` steps, or a time ``period``, of size ``dt`` (reference
        `run!`, `model_integrator.jl:72-88`) through :func:`advance`. With
        ``callbacks`` and a positive ``callback_interval`` the run goes in
        chunks of that many steps, each through :func:`advance`, and after
        each chunk ``compute_auxiliary`` and then every callback, called
        with this simulation (`integrator.py:284-307`)."""
        dt = convert_dt(dt) if dt is not None else self.timestepper.default_dt()
        if steps is None:
            if period is None:
                raise ValueError("either `steps` or `period` must be specified")
            steps = int(convert_dt(period) // dt)
        steps = int(steps)
        if callbacks and callback_interval > 0:
            done = 0
            while done < steps:
                n = min(int(callback_interval), steps - done)
                self._advance(n, dt)
                done += n
                self.compute_auxiliary()
                for cb in callbacks:
                    cb(self)
            return self
        self._advance(steps, dt)
        return self.compute_auxiliary()

    def reinitialize(self) -> "Simulation":
        """Reset the state to the initial conditions (reference
        `initialize!`, `model_integrator.jl:96-109`)."""
        self.state = initial_state(self.model, self.input_sources, self.initializers, self.ctx)
        return self

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
               boundary_conditions=None, forcings=None) -> Simulation:
    """Create and initialize a :class:`Simulation` (reference `initialize`,
    `model_integrator.jl:145-161`).

    ``forcings`` adds source and sink terms to prognostic variables
    (reference `src/forcings.jl:13-19`): ``{name: fn(state, grid)}``, each
    value added to that tendency at every step, in the prognostic's units
    per second. A target that is not a prognostic raises ``KeyError``.
    ``Simulation.run`` steps a composition with forcings through the
    process modules."""
    timestepper = timestepper if timestepper is not None else ForwardEuler()
    sim = Simulation(model, timestepper, state=None, input_sources=input_sources,
                     bcs=boundary_conditions, initializers=initializers, forcings=forcings)
    sim.state = initial_state(model, sim.input_sources, sim.initializers, sim.ctx)
    for name in sim.forcings:
        if name not in sim.state.prognostic:
            raise KeyError(f"forcing target {name!r} is not a prognostic variable "
                           f"(prognostics: {sorted(sim.state.prognostic)})")
    return sim
