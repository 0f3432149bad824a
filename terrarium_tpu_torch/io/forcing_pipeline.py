"""Streaming a long forcing series through the card, window by window
(counterpart of ``terrarium_tpu/io/forcing_pipeline.py``).

An hourly global series does not fit on the card for long (one variable for
one year at 56,951 cells is 8,760 x 56,951 x 4 B = 2.0 GB, and a run reads
several variables over several years). :class:`ChunkedForcingPipeline`
keeps the whole series on the host (arrays, memmaps or lazy providers
``v(i0, i1)``) and runs the simulation in chunks, each on one window of
``window`` consecutive time slices that is staged on the card while the
chunk before it runs.

* :meth:`ChunkedForcingPipeline.run` chunks at window-coverage boundaries
  (`forcing_pipeline.py:83-129`); each chunk goes through
  ``integrator.advance`` with the window as a ``TimeSeriesInputSource``, so
  it takes a column kernel wherever the composition takes one, as
  ``Simulation.run`` does with a whole series. The last window is padded
  with its last time (``mode="edge"``, `:74-75`), so its times are not
  uniform: there the soil's top temperature is evaluated on the host into a
  table that its kernel reads (``TimeSeriesInputSource.values_at``, any
  spacing), and a LandModel steps through the process modules, as for any
  series of uneven spacing.
* :meth:`ChunkedForcingPipeline.run_fused` (`:131-230`) runs every chunk as
  one launch of the soil or land rollout kernel on the window's own series
  tensor with the window's own time origin. Every window must have the
  first one's length and uniform spacing (``fused_step.window_meta``
  raises naming both; the reference checks only the length and spacing of
  times it can read, `ops/fused_step.py:420-425`); a composition that no
  rollout kernel takes raises.

Staging (``_Stager``): a run holds two window buffers on the card and
two pinned host buffers, one pair a slot, used in turn, so that a run of
any length holds two windows on the card. Each window is written into its
slot's host buffer (the copy out of it, two windows before, waited for)
and copied to the slot's device buffer on a side stream, after the chunks
that read that buffer two windows before (an event on the compute stream).
The copy of the next window is issued before the current chunk launches,
so it can run while that chunk runs (the counterpart of JAX's
asynchronous ``device_put`` prefetch, `:118-124`, `:219-229`); the
compute stream waits on the copy's event before the chunk that reads the
window. The device buffers are allocated on the side stream and recorded
on the compute stream, so the caching allocator does not hand their
memory out while a kernel may still read it. On the CPU, staging is a
plain copy. ``chunks`` keeps the last run's chunks: their steps, their
window's times and, on the card, the events around the window's copy,
from which ``chip_smoke.py`` reads the copy time and whether the copy was
hidden; no chunk keeps its window's tensors.

A chunk's sources are the simulation's, the window in the pipeline's place
(first where the simulation does not hold the pipeline). The reference
keeps only its window and the static sources and drops every other
time-varying source silently (`forcing_pipeline.py:90-91`, `:156-157`,
ROADMAP's reference defects); here each keeps its place, so a whole series that
provides a variable after the window wins, as in ``Simulation.run``, and
``run_fused`` then holds it to the window's length and raises.

The JAX package's ``fused_block_cells`` and ``fused_xy_rank2`` are TPU
layout knobs (ROADMAP B6) and have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .input_sources import TimeSeriesInputSource
from ..timesteppers.integrator import advance

__all__ = ["ChunkedForcingPipeline"]


@dataclasses.dataclass
class _Slot:
    """One of the stager's two buffers: a window's series by name in pinned
    host memory and on the card, the event at the end of their last copy
    and the event after the last chunk that read the device buffers."""

    host: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    device: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    copied: Optional[torch.cuda.Event] = None
    read: Optional[torch.cuda.Event] = None


@dataclasses.dataclass
class _Window:
    """One window as the chunks read it: its times (host, float64), its
    series (on the grid's device; on the card, the device buffers of
    ``slot``, which the window after next overwrites) and on the card the
    events around its copy on the side stream."""

    times: np.ndarray
    series: Dict[str, torch.Tensor]
    slot: Optional[_Slot] = None
    copy_start: Optional[torch.cuda.Event] = None
    copy_end: Optional[torch.cuda.Event] = None


@dataclasses.dataclass
class _Chunk:
    """One chunk of a run: its steps, the times of the window it read,
    whether that window was copied for it (not reused from the chunk
    before) and on the card the events around that copy."""

    steps: int
    times: np.ndarray
    new_window: bool
    copy_start: Optional[torch.cuda.Event] = None
    copy_end: Optional[torch.cuda.Event] = None


class _Stager:
    """Stages windows on ``device`` through two slots and a side stream
    (the module's docstring); a plain copy on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.slots = [_Slot(), _Slot()]
        self.turn = 0

    def stage(self, arrays: dict) -> _Window:
        times = arrays.pop("__times__")
        if not self.cuda:
            return _Window(times, {k: torch.from_numpy(np.array(a)) for k, a in arrays.items()})
        slot = self.slots[self.turn]
        self.turn ^= 1
        if slot.copied is not None:
            slot.copied.synchronize()  # the copy out of its host buffers, two windows ago
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            for k, a in arrays.items():
                dtype = torch.from_numpy(a[:0]).dtype
                if k not in slot.host or tuple(slot.host[k].shape) != a.shape or \
                        slot.host[k].dtype != dtype:
                    slot.host[k] = torch.empty(a.shape, dtype=dtype, pin_memory=True)
                    slot.device[k] = torch.empty(a.shape, dtype=dtype, device=self.device)
                    slot.device[k].record_stream(compute)
                slot.host[k].numpy()[...] = a
            if slot.read is not None:
                self.stream.wait_event(slot.read)  # the chunks that read it are done
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for k in arrays:
                slot.device[k].copy_(slot.host[k], non_blocking=True)
            end.record()
        slot.copied = end
        return _Window(times, {k: slot.device[k] for k in arrays}, slot, start, end)

    def use(self, window: _Window) -> None:
        """Order the compute stream after the window's copy, before the
        launch that reads it."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(window.copy_end)

    def used(self, window: _Window) -> None:
        """Mark the end of the work queued so far that reads the window,
        which its slot's next copy waits for."""
        if self.cuda:
            window.slot.read = torch.cuda.Event()
            window.slot.read.record(torch.cuda.current_stream(self.device))


class ChunkedForcingPipeline:
    """Streams a long forcing time series through windows on the card.

    Args:
        times: ``(T,)`` seconds (increasing) on the host.
        series: name -> ``(T, ...)`` host array (numpy, memmap) or a lazy
            provider ``v(i0, i1) -> (i1 - i0, ...)``, so that a multi-GB year
            never lies on the host whole.
        window: the number of consecutive time slices of a window (>= 2).

    Pass it in ``input_sources=`` at ``initialize`` to declare and seed its
    variables, then drive the simulation with :meth:`run` or
    :meth:`run_fused`; ``Simulation.run`` raises on it, as in the JAX
    package.
    """

    def __init__(self, times, series: Dict[str, object], window: int = 64):
        self.times = np.asarray(times, dtype=np.float64)
        self.series = dict(series)
        if window < 2:
            raise ValueError("window must be >= 2")
        self.window = int(window)
        self.chunks: list = []

    def _slice(self, v, i0: int, i1: int):
        return v(i0, i1) if callable(v) else v[i0:i1]

    def _decl_source(self) -> TimeSeriesInputSource:
        return TimeSeriesInputSource(
            times=self.times[:2],
            series={k: np.asarray(self._slice(v, 0, 2)) for k, v in self.series.items()})

    def variables(self):
        return self._decl_source().variables()

    def initialize_inputs(self, state) -> None:
        """Seed the input fields from the first two slices."""
        self._decl_source().initialize_inputs(state)

    def update_inputs(self, state):
        raise RuntimeError(
            "ChunkedForcingPipeline streams from host — drive the "
            "simulation with pipeline.run(sim, ...) or "
            "pipeline.run_fused(sim, ...), not sim.run()")

    def _window_arrays(self, i0: int, dtype) -> dict:
        """The window from slice ``i0``: ``__times__`` (float64) and each
        series in ``dtype`` (numpy), both padded to ``window`` slices with
        the last one (`forcing_pipeline.py:71-81`)."""
        i1 = min(i0 + self.window, self.times.shape[0])
        pad = self.window - (i1 - i0)
        out = {"__times__": np.pad(self.times[i0:i1], (0, pad), mode="edge")}
        for k, v in self.series.items():
            w = np.asarray(self._slice(v, i0, i1))
            if pad:
                w = np.pad(w, ((0, pad),) + ((0, 0),) * (w.ndim - 1), mode="edge")
            out[k] = np.ascontiguousarray(w, dtype=dtype)
        return out

    def _start(self, sim):
        """``(stager, sources, numpy dtype)`` of a run, ``chunks`` emptied:
        the simulation's sources with this pipeline first unless they hold
        it (as the reference's window and static sources); the reference
        drops every other time-varying source silently
        (`forcing_pipeline.py:90-91`, `:156-157`); here each keeps its
        place."""
        self.chunks = []
        grid = sim.model.grid
        sources = tuple(sim.input_sources)
        if not any(s is self for s in sources):
            sources = (self,) + sources
        return _Stager(torch.device(grid.device)), sources, torch.empty(
            (), dtype=grid.dtype).numpy().dtype

    def _chunk(self, sim, stager: _Stager, win: _Window, new: bool, sources: tuple, n: int,
               dt: float, window=None) -> None:
        """``n`` steps of ``sim`` through ``integrator.advance`` on
        ``sources``, the window ``win`` (``new``: copied for this chunk) in
        this pipeline's place, ordered after its copy."""
        stager.use(win)
        src = TimeSeriesInputSource(times=win.times, series=win.series)
        advance(sim.model, sim.state, sim.ctx, n, dt, timestepper=sim.timestepper,
                input_sources=tuple(src if s is self else s for s in sources), window=window)
        stager.used(win)
        self.chunks.append(_Chunk(n, win.times, new, win.copy_start, win.copy_end))

    def run(self, sim, steps: int, dt: float):
        """Advance ``sim`` by ``steps`` steps of ``dt``, streaming the
        forcing: chunks end where a window's coverage ends, the last window
        extrapolating flat (`forcing_pipeline.py:83-129`)."""
        stager, sources, dtype = self._start(sim)
        T = self.times.shape[0]
        done = 0
        i0 = int(np.searchsorted(self.times, sim.current_time, side="right") - 1)
        i0 = max(0, min(i0, T - 2))
        win = stager.stage(self._window_arrays(i0, dtype))
        while done < steps:
            t_now = sim.current_time
            i1 = min(i0 + self.window, T)
            if i1 >= T:
                n = steps - done  # the last window extrapolates flat
            else:
                n = min(steps - done, max(1, int((self.times[i1 - 1] - t_now) // dt)))
            next_i0 = i1 - 1 if i1 < T else i0
            nxt = None
            if done + n < steps and next_i0 != i0:  # staged while this chunk runs
                nxt = stager.stage(self._window_arrays(next_i0, dtype))
            self._chunk(sim, stager, win, True, sources, n, dt)
            done += n
            if nxt is not None:
                i0, win = next_i0, nxt
        sim.compute_auxiliary()
        return sim

    def run_fused(self, sim, steps: int, dt: float):
        """Advance ``sim`` by ``steps`` steps of ``dt`` on the rollout
        kernels, one launch a chunk, each on a window of the series with
        its own time origin (`forcing_pipeline.py:131-230`).

        Requires uniformly spaced times, ``sim.fused_inner_steps`` set and
        ``steps`` a multiple of it; a chunk is ``((window - 2) * dts) //
        dt`` steps, rounded down to a multiple of ``fused_inner_steps``,
        the window starting at the slice at or before the chunk's clock
        time and at most at ``T - window``."""
        d = np.diff(self.times)
        if d.size < 1 or not np.allclose(d, d[0], rtol=1e-6):
            raise ValueError("run_fused requires uniformly spaced times")
        dts = float(d[0])
        inner = int(sim.fused_inner_steps or 0)
        if inner <= 0:
            raise ValueError("set sim.fused_inner_steps for run_fused")
        if steps % inner:
            raise ValueError(f"steps={steps} not a multiple of fused_inner_steps={inner}")
        W, T = self.window, self.times.shape[0]
        # two slices of margin: a chunk may start mid-interval, and the
        # interpolation reads one slice ahead
        chunk_steps = int(((W - 2) * dts) // dt)
        chunk_steps -= chunk_steps % inner
        if chunk_steps <= 0:
            raise ValueError(f"window={W} covers fewer than inner_steps={inner} steps at "
                             f"dt={dt}")

        def aligned_i0(t_now):
            i0 = int(np.floor((t_now - self.times[0]) / dts))
            return max(0, min(i0, T - W))

        stager, sources, dtype = self._start(sim)
        done = 0
        i0 = aligned_i0(sim.current_time)
        win, new = stager.stage(self._window_arrays(i0, dtype)), True
        while done < steps:
            n = min(chunk_steps, steps - done)  # both multiples of inner
            nxt = None
            if done + n < steps:  # staged while this chunk runs
                next_i0 = aligned_i0(sim.current_time + n * dt)
                if next_i0 != i0:
                    nxt = stager.stage(self._window_arrays(next_i0, dtype))
            self._chunk(sim, stager, win, new, sources, n, dt, window=(W, dts))
            done += n
            new = nxt is not None
            if new:
                i0, win = next_i0, nxt
        sim.compute_auxiliary()
        return sim
