"""The port's main path end to end: ``initialize`` / ``Simulation.run``
against the goldens and against JAX ``Simulation.run``, the converters, and
an import that cannot reach JAX."""
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import terrarium_tpu_torch as tp
from terrarium_tpu_torch.convert import params_from_dict, state_from_numpy

from torch_parity import (assert_fields_close, jax_sim, jax_soil, jax_state_arrays,
                          port_sim, port_soil)

GOLDEN = pathlib.Path(__file__).parent / "goldens" / "soil_heat_richards.npz"
FIELDS = ("internal_energy", "saturation_water_ice", "surface_excess_water", "temperature",
          "liquid_water_fraction", "pressure_head", "water_table", "hydraulic_conductivity",
          "ground_temperature")


def test_golden_soil_heat_richards():
    """`tests/test_goldens.py:20-36`: 8 cells, Nz 20, 120 steps at dt 300."""
    sim = port_sim("golden", 8, 20)
    sim.run(steps=120, dt=300.0)
    golden = np.load(GOLDEN)
    for f in golden.files:
        np.testing.assert_allclose(sim.state[f].numpy(), golden[f], rtol=1e-12, atol=1e-12,
                                   err_msg=f)
    assert sim.iteration == 120 and sim.current_time == 36000.0


def test_bench_config_matches_jax_run():
    """The bench configuration (Nz 30, VanGenuchten(2, 2), dt 60) at 64
    cells in float64, 240 steps. Tendencies are not compared: the fused
    path leaves them zero, as the JAX fused path does."""
    jsim, psim = jax_sim("bench", 64, 30, dt=60.0), port_sim("bench", 64, 30, dt=60.0)
    jsim.run(steps=240, dt=60.0)
    psim.run(steps=240, dt=60.0)
    assert_fields_close(psim.state, jsim.state, FIELDS)
    assert psim.current_time == jsim.current_time and psim.iteration == jsim.iteration
    assert all(float(t.abs().max()) == 0.0 for t in psim.state.tendencies.values())


def test_params_from_dict_round_trip():
    assert params_from_dict(dataclasses.asdict(jax_soil())) == port_soil()
    custom = dataclasses.replace(jax_soil(), hydrology=dataclasses.replace(
        jax_soil().hydrology, deficit_pool=True))
    with pytest.raises(NotImplementedError, match="deficit_pool"):
        params_from_dict(dataclasses.asdict(custom))


def test_state_from_numpy_continues_a_jax_run():
    """A JAX state after 60 steps, carried over with both converters, runs
    on in the port as it runs on in JAX."""
    jsim = jax_sim("bench", 32, 30, dt=60.0)
    jsim.run(steps=60, dt=60.0)
    psim = port_sim("bench", 32, 30, dt=60.0)
    model = tp.SoilModel(grid=psim.model.grid,
                         soil=params_from_dict(dataclasses.asdict(jsim.model.soil)))
    state = state_from_numpy(jax_state_arrays(jsim.state), float(jsim.state.clock.time),
                             int(jsim.state.clock.iteration), model.grid)
    assert sorted(state.auxiliary) == sorted(psim.state.auxiliary)
    assert state.clock.time.dtype == torch.float64 and state.clock.iteration.item() == 60
    sim = tp.Simulation(model, tp.ForwardEuler(dt=60.0), state, bcs=psim.bcs)
    assert_fields_close(sim.state, jsim.state, FIELDS)
    jsim.run(steps=60, dt=60.0)
    sim.run(steps=60, dt=60.0)
    assert_fields_close(sim.state, jsim.state, FIELDS)
    assert sim.current_time == jsim.current_time == 7200.0


def test_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; import terrarium_tpu_torch; "
            "import terrarium_tpu_torch.convert, terrarium_tpu_torch.ops.fused_step; "
            "assert not any(m == 'terrarium_tpu' or m.startswith('terrarium_tpu.') "
            "for m in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
