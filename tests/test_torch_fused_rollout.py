"""The soil column rollout (``terrarium_tpu_torch/ops/fused_step.py``): its
plain version against the JAX Pallas kernel (interpret mode, as
`tests/test_fused_step.py:52-82` runs it), against the JAX XLA lean rollout
and against the port's own module-by-module steps. The kernel itself is
checked against the plain version in `test_torch_kernel_cuda.py`, which
imports no JAX so that it runs on the machine with the card."""
import jax
import numpy as np
import pytest
import torch

from terrarium_tpu.ops.fused_step import make_fused_lean_rollout
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.timesteppers.integrator import (advance, clock_times,
                                                         top_temperature_table)

from torch_parity import assert_fields_close, jax_sim, port_sim

CELLS, NZ, STEPS, DT = 96, 20, 12, 60.0
FIELDS = ("internal_energy", "saturation_water_ice", "surface_excess_water",
          "temperature", "pressure_head", "liquid_water_fraction", "water_table")


def _plain_rollout(config, cells=CELLS, nz=NZ, steps=STEPS):
    sim = port_sim(config, cells, nz, dt=DT)
    advance(sim.model, sim.state, sim.ctx, steps, DT, plain=True)
    return sim


@pytest.mark.parametrize("config", ["golden", "bench"])
def test_plain_matches_jax_pallas_kernel(config):
    jsim = jax_sim(config, CELLS, NZ, dt=DT)
    fused = make_fused_lean_rollout(jsim.model, jsim.timestepper, jsim.ctx,
                                    jsim.input_sources, dt=DT, inner_steps=4,
                                    block_cells=64, interpret=True)
    ref = jax.jit(lambda s: fused(s, STEPS))(jsim.state)
    sim = _plain_rollout(config)
    assert_fields_close(sim.state, ref, FIELDS)
    assert sim.current_time == float(ref.clock.time)
    assert sim.iteration == int(ref.clock.iteration)


@pytest.mark.parametrize("config", ["golden", "bench"])
def test_plain_matches_jax_xla_lean_rollout(config):
    jsim = jax_sim(config, CELLS, NZ, dt=DT)
    ref = jsim._rollout_fn(STEPS)(jsim.state, DT)
    sim = _plain_rollout(config)
    assert_fields_close(sim.state, ref, FIELDS)


def test_plain_equals_module_steps():
    """The plain version and ``closure`` after ``pre_closure_step`` repeated,
    composed from the process modules, are the same arithmetic."""
    sim = _plain_rollout("bench", cells=16, nz=30, steps=30)
    ref = port_sim("bench", 16, 30, dt=DT)
    for _ in range(30):
        ref.timestepper.pre_closure_step(ref.model, ref.state, ref.ctx, (), DT)
    ref.model.closure(ref.state, ref.ctx)
    for name in FIELDS:
        torch.testing.assert_close(sim.state[name], ref.state[name], rtol=0, atol=0)


def test_wrapper_on_cpu_runs_plain_version_and_checks_inputs():
    sim = port_sim("bench", 8, 30, dt=DT)
    g = sim.model.grid
    params = fs.ColumnParams.of(sim.model, g.dtype)
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    carry = tuple(sim.state.prognostic[n] for n in sim.model.live_carry)
    table = top_temperature_table(sim.bcs["temperature"]["top"].value,
                                  clock_times(sim.state.clock.time, DT, 5)[:-1], g)
    before = fs.soil_column_rollout.launches
    out = fs.soil_column_rollout(*carry, table, *coords, params, DT)
    ref = fs.soil_column_rollout_plain(*carry, table, *coords, params, DT)
    assert fs.soil_column_rollout.launches == before
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape"):
        fs.soil_column_rollout(carry[0], carry[1][:-1], carry[2], table, *coords, params, DT)
    with pytest.raises(TypeError, match="dtype"):
        fs.soil_column_rollout(*carry, table.float(), *coords, params, DT)
