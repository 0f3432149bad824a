"""Port vs JAX: grids, collated variables, the allocated state, the declared
live carry and the clock."""
import jax
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.utils.scan_dce import _dead_input_mask
from terrarium_tpu_torch.timesteppers.integrator import clock_times

from torch_parity import jax_sim, port_sim


@pytest.mark.parametrize("nz", [15, 20, 30])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_grid_coordinates_bitwise(nz, dtype):
    jg = tt.ColumnGrid.of(cells=3, spacing=tt.ExponentialSpacing(N=nz), nf=getattr(np, dtype))
    pg = tp.ColumnGrid.of(cells=3, spacing=tp.ExponentialSpacing(N=nz),
                          dtype=getattr(torch, dtype), device="cpu")
    for name in ("z_centers", "z_faces", "dz", "dz_faces"):
        a, b = np.asarray(getattr(jg, name)), getattr(pg, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert pg.nz == jg.nz and pg.shape(tp.XYZ(face=True)) == (nz + 1, 3)


def test_build_state_matches_jax_variables():
    jsim, psim = jax_sim("bench", 5, 20), port_sim("bench", 5, 20)
    jv = tt.Variables.of(jsim.model)
    pv = psim.model.collated_variables()
    for group in ("prognostic", "auxiliary", "inputs", "tendencies"):
        assert list(getattr(pv, group)) == list(getattr(jv, group)), group
    # the hydrology input is shadowed by the energy-closure auxiliary
    assert "liquid_water_fraction" in pv.auxiliary and not pv.inputs
    js, ps = jsim.state, psim.state
    for group in ("prognostic", "tendencies", "auxiliary", "inputs"):
        jg, pg = getattr(js, group), getattr(ps, group)
        assert sorted(jg) == sorted(pg), group
        for name in jg:
            assert tuple(pg[name].shape) == tuple(np.shape(jg[name])), (group, name)
            assert pg[name].dtype == torch.float64, (group, name)


def test_live_carry_matches_jax_dead_input_mask():
    """The declared carry equals the leaves a traced JAX pre_closure_step
    consumes (`utils/scan_dce.py:28`)."""
    sim = jax_sim("bench", 4, 20)
    state = sim.state
    leaves, treedef = jax.tree.flatten(state)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]]

    def flat_step(lv, d):
        out = sim.timestepper.pre_closure_step(
            sim.model, jax.tree.unflatten(treedef, lv), sim.ctx, (), d)
        return jax.tree.leaves(out)

    used = _dead_input_mask(flat_step, leaves, 60.0)[:len(leaves)]
    live = {p for p, u in zip(paths, used) if u}
    expected = {f".prognostic['{n}']" for n in port_sim("bench", 4, 20).model.live_carry}
    expected |= {".clock.time", ".clock.iteration"}
    assert live == expected


def test_clock_times_repeat_the_tick_in_float32():
    """The kernel's BC table uses the clock's repeated f32 addition. Once the
    clock's ulp no longer divides dt (8 s past 2**26 s, against dt 60) that
    differs from t0 + k*dt."""
    t0 = torch.tensor(2.0 ** 26, dtype=torch.float32)
    times = clock_times(t0, 60.0, 50)
    clock = tp.Clock(t0, torch.tensor(0, dtype=torch.int32))
    ref = [clock.time.item()]
    for _ in range(50):
        clock.tick(60.0)
        ref.append(clock.time.item())
    np.testing.assert_array_equal(times, np.asarray(ref, dtype=np.float32))
    assert times.dtype == np.float32
    assert not np.array_equal(times, (2.0 ** 26 + 60.0 * np.arange(51)).astype(np.float32))
    assert int(clock.iteration) == 50


def test_entry_points_default_to_the_card():
    """``ColumnGrid.of`` and ``Clock.zero`` target ``cuda`` unless the CPU is
    asked for; on a host without a card the default raises."""
    if torch.cuda.is_available():
        assert tp.ColumnGrid.of(cells=2).device.type == "cuda"
        assert tp.Clock.zero().time.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.ColumnGrid.of(cells=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.Clock.zero()
    assert tp.ColumnGrid.of(cells=2, device="cpu").device.type == "cpu"
    assert tp.Clock.zero(device="cpu").time.device.type == "cpu"
