"""Input (forcing) sources (counterpart of ``terrarium_tpu/io/input_sources.py``).

A source declares input variables, seeds them at initialization and updates
them every step from the state clock; time interpolation is linear with flat
extrapolation at the ends, as in the reference
(`TerrariumRastersExt.jl:96-121`). Sources update the state in place, as the
port's process hooks do. Arrays may be numpy arrays or tensors; they are
taken in the input variable's dtype and device where they are read, so a
large series is best handed over as a tensor on the grid's device.

The fused column rollout reads a uniformly spaced series inside the CUDA
kernel and evaluates any other series here on the host
(``timesteppers/integrator.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..variables import XY, Variable, input as input_var

__all__ = ["FieldInputSource", "TimeSeriesInputSource", "collect_input_variables"]


def _like(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device).to(like.dtype)


@dataclasses.dataclass(frozen=True)
class FieldInputSource:
    """Static input fields copied once at initialization (reference
    `input_sources.jl:81-131`). ``fields`` maps input-variable name to a
    value that broadcasts to the variable's shape; ``dims`` maps name to
    ``XY()`` (the default) or ``XYZ()``."""

    fields: Any
    dims: Any = None

    def variables(self):
        dims = self.dims or {}
        return tuple(input_var(name, dims.get(name, XY())) for name in self.fields)

    def initialize_inputs(self, state) -> None:
        for name, val in self.fields.items():
            like = state.inputs[name]
            state.inputs[name] = torch.broadcast_to(_like(val, like), like.shape).clone()

    def update_inputs(self, state) -> None:
        """Static: nothing changes."""


@dataclasses.dataclass(frozen=True)
class TimeSeriesInputSource:
    """Time-varying inputs, interpolated linearly in time at every update
    (reference `FieldTimeSeriesInputSource`, `input_sources.jl:142-171`).

    ``times``: ``(T,)`` seconds, increasing; ``series``: name to a
    ``(T, ...)`` array whose trailing shape broadcasts to the input
    variable's shape, so a ``(T,)`` series is one value for every cell.
    Flat extrapolation beyond the ends."""

    times: Any
    series: Any
    dims: Any = None

    def variables(self):
        dims = self.dims or {}
        return tuple(input_var(name, dims.get(name, XY())) for name in self.series)

    def values_at(self, name: str, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """The series ``name`` at the time ``t`` (0-d), broadcast to
        ``like``'s shape, or at each of the times ``t`` (1-d, ``(n,)``) as
        ``(n, *like.shape)``, in ``like``'s dtype (reference
        `io/input_sources.py:70-78`: ``searchsorted`` on ``times``, so any
        spacing is taken)."""
        times = _like(self.times, like)
        values = _like(self.series[name], like)
        tt = torch.clamp(_like(t, like), times[0], times[-1]).reshape(-1)
        idx = torch.clamp(torch.searchsorted(times, tt, right=True) - 1, 0, times.shape[0] - 2)
        t0, t1 = times[idx], times[idx + 1]
        w = torch.where(t1 > t0, (tt - t0) / (t1 - t0), 0.0)
        trail = values.dim() - 1
        w = w.reshape(-1, *([1] * trail))
        val = (1.0 - w) * values[idx] + w * values[idx + 1]
        n = val.shape[0]
        val = val.reshape(n, *([1] * (like.dim() - trail)), *values.shape[1:])
        val = torch.broadcast_to(val, (n, *like.shape))
        return val if torch.as_tensor(t).dim() == 1 else val[0]

    def initialize_inputs(self, state) -> None:
        self.update_inputs(state)

    def update_inputs(self, state) -> None:
        for name in self.series:
            state.inputs[name] = self.values_at(name, state.clock.time, state.inputs[name])


def collect_input_variables(sources) -> Tuple[Variable, ...]:
    """The input variable declarations of all sources (reference
    `model_integrator.jl:154-155`)."""
    out: tuple = ()
    for src in sources:
        out = out + tuple(src.variables())
    return out
