"""Port vs JAX on random legal states (f64): the saturation adjustment, the
closure, the hydraulics and the tendencies agree at 1e-12, each stage fed the
same inputs in both packages.

The states mix frozen, thawing and thawed energies with saturated, fully
drained, over-saturated and slightly negative layers, plus saturations a
hair below 1, so that every branch of the saturation adjustment (spill and
bottom clip), the effective-saturation clips (``one_minus_eps``), ``safediv``
and the frozen-conductivity guard is taken; ``test_states_hit_every_branch``
checks that they are.
"""
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu.ops.vertical_ops as jv
import terrarium_tpu_torch as tp
import terrarium_tpu_torch.ops.vertical_ops as pv
from terrarium_tpu.state import reset_tendencies as jax_reset_tendencies
from terrarium_tpu_torch.convert import state_from_numpy
from terrarium_tpu_torch.state import reset_tendencies

from torch_parity import assert_fields_close, jax_sim, jax_state_arrays, port_sim

CELLS, NZ = 48, 20
FIELDS = ("internal_energy", "saturation_water_ice", "surface_excess_water", "temperature",
          "liquid_water_fraction", "pressure_head", "water_table", "ground_temperature")


def random_state(seed):
    rng = np.random.default_rng(seed)
    sat = rng.uniform(0.05, 0.95, (NZ, CELLS))
    sat[:, 0:4] = 0.0                                       # fully drained columns
    sat[:8, 4:12] = 1.0                                     # saturated below
    sat[10:14, 8:16] = rng.uniform(1.0, 1.4, (4, 8))        # over-saturated layers
    sat[-1, 16:20] = 1.3                                    # spill into the pool
    sat[:3, 20:24] = -0.05                                  # residual bottom deficit
    sat[5, 24:28] = 1.0 - 5e-13                             # inside the inverse clip
    sat[6, 28:32] = 1.0 - 1e-10                             # inside the conductivity clip
    L_theta = 3.34e8 * np.clip(sat, 0.0, None) * 0.49
    U = rng.uniform(-2.2e8, 4e7, (NZ, CELLS))
    U[:, 32:36] = -L_theta[:, 32:36] - rng.uniform(1e6, 1e7, (NZ, 4))  # frozen
    U[:, 36:40] = -0.5 * L_theta[:, 36:40]                  # on the plateau
    U[:, 40:42] = 0.0
    S = rng.uniform(-0.02, 0.02, CELLS)
    return U, sat, S


def both_states(seed):
    jsim, psim = jax_sim("golden", CELLS, NZ), port_sim("golden", CELLS, NZ)
    U, sat, S = random_state(seed)
    jstate = jsim.state.update(internal_energy=U, saturation_water_ice=sat,
                               surface_excess_water=S)
    return jsim, jstate, psim, _port(jstate, psim)


def _port(jstate, psim):
    return state_from_numpy(jax_state_arrays(jstate), 0.0, 0, psim.model.grid)


@pytest.mark.parametrize("seed", [0, 1])
def test_saturation_adjustment_matches_jax(seed):
    """The port runs the reference's sequential sweeps; JAX runs their
    closed form over prefix sums (`hydrology.py:245-279`, ADJUST_IMPL
    "fused"). Both round differently by about eps times the column's water
    (in m) over dz, so saturation (O(1)) is held to an absolute 1e-12."""
    jsim, jstate, psim, pstate = both_states(seed)
    jh = jsim.model.soil.hydrology
    jstate = jh.adjust_saturation_profile(jstate, jsim.model.grid, por=0.49)
    psim.model.soil.hydrology.adjust_saturation_profile(pstate, psim.model.grid)
    for name in ("saturation_water_ice", "surface_excess_water"):
        np.testing.assert_allclose(pstate[name].numpy(), np.asarray(jstate[name]),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_closure_matches_jax(seed):
    """Water table, pressure head and the energy closure from the same
    adjusted saturation. (Near se = 1 the head is sqrt(1 - se)-sensitive,
    so it is compared from identical inputs, not across the sweeps.)"""
    jsim, jstate, psim, _ = both_states(seed)
    grid, soil = jsim.model.grid, jsim.model.soil
    adjusted = soil.hydrology.adjust_saturation_profile(jstate, grid, por=0.49)
    ref = jsim.model.soil.energy.closure(
        soil.hydrology.closure(jstate, grid, soil, jsim.model.constants),
        grid, soil, jsim.model.constants, jsim.ctx)
    pstate = _port(adjusted, psim)
    psoil, pgrid = psim.model.soil, psim.model.grid
    psoil.hydrology.compute_water_table(pstate, pgrid)
    psoil.hydrology.compute_pressure_head(pstate, pgrid, psoil)
    psoil.energy.closure(pstate, pgrid, psoil, psim.model.constants, psim.ctx)
    np.testing.assert_array_equal(np.asarray(ref.saturation_water_ice),
                                  np.asarray(adjusted.saturation_water_ice))
    assert_fields_close(pstate, ref, FIELDS)


@pytest.mark.parametrize("seed", [0, 1])
def test_hydraulics_match_jax(seed):
    """Centre and face conductivity (with the top-face quirk) from the same
    closed state."""
    jsim, jstate, psim, _ = both_states(seed)
    closed = jsim.model.closure(jstate, jsim.ctx)
    ref = jsim.model.compute_auxiliary(closed, jsim.ctx)
    pstate = _port(closed, psim)
    psim.model.compute_auxiliary(pstate, psim.ctx)
    assert_fields_close(pstate, ref, ("hydraulic_conductivity",))


@pytest.mark.parametrize("seed", [0, 1])
def test_tendencies_match_jax(seed):
    jsim, jstate, psim, _ = both_states(seed)
    closed = jsim.model.compute_auxiliary(jsim.model.closure(jstate, jsim.ctx), jsim.ctx)
    ref = jsim.model.compute_tendencies(jax_reset_tendencies(closed), jsim.ctx)
    pstate = _port(closed, psim)
    reset_tendencies(pstate)
    psim.model.compute_tendencies(pstate, psim.ctx)
    for name, want in ref.tendencies.items():
        want = np.asarray(want)
        np.testing.assert_allclose(pstate.tendencies[name].numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(want)), err_msg=name)


def test_states_hit_every_branch():
    _, jstate, psim, pstate = both_states(0)
    sat0 = pstate.saturation_water_ice.clone()
    S0 = pstate.surface_excess_water.clone()
    psim.model.closure(pstate, psim.ctx)
    psim.model.compute_auxiliary(pstate, psim.ctx)
    liq, sat = pstate.liquid_water_fraction, pstate.saturation_water_ice
    dz = psim.model.grid.dz
    spill = pstate.surface_excess_water - S0
    created = (sat * dz).sum(0) + spill - (sat0 * dz).sum(0)
    K = pstate.hydraulic_conductivity
    assert bool((liq == 0).any()) and bool((liq == 1).any())
    assert bool(((liq > 0) & (liq < 1)).any())               # plateau
    assert bool((sat == 1).any()) and bool((sat == 0).any())
    assert bool((spill > 0).any())                            # top spill
    assert bool((created > 1e-6).any())                       # bottom clip
    assert bool(((sat > 1 - 1e-12) & (sat < 1)).any())        # inverse clip
    assert bool(((sat > 1 - 1e-9) & (sat < 1 - 1e-12)).any())  # conductivity clip
    assert bool((K == 0).any())                               # frozen guard


def _bc(pkg, kind, value):
    return None if kind is None else getattr(pkg, kind)(value)


@pytest.mark.parametrize("bottom,top", [((None, 0), ("Dirichlet", 2.5)),
                                        (("Neumann", 0.3), ("Neumann", -0.1)),
                                        (("Dirichlet", -1.0), (None, 0))])
def test_ghosts_and_face_operators_match_jax(bottom, top):
    grid = port_sim("golden", CELLS, NZ).model.grid
    c = np.random.default_rng(5).normal(size=(NZ, CELLS))
    jg = jv.ghosts(c, _bc(tt, *bottom), _bc(tt, *top), None,
                   np.asarray(grid.vertical.dz_faces)[:, None])
    pg = pv.ghosts(torch.as_tensor(c), _bc(tp, *bottom), _bc(tp, *top), None, grid.dz_faces)
    for a, b in zip(pg, jg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    grad = pv.grad_faces(torch.as_tensor(c), grid.dz_faces, *pg)
    ref = jv.grad_faces(c, np.asarray(grid.vertical.dz_faces)[:, None], *jg)
    np.testing.assert_array_equal(grad.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(pv.interp_faces_mid(torch.as_tensor(c)).numpy(),
                                  np.asarray(jv.interp_faces_mid(c)))
    np.testing.assert_array_equal(pv.div_faces(grad, grid.dz).numpy(),
                                  np.asarray(jv.div_faces(ref, np.asarray(grid.vertical.dz)[:, None])))


@pytest.mark.parametrize("xy", [False, True])
def test_apply_flux_bcs_matches_jax(xy):
    grid = port_sim("golden", CELLS, NZ).model.grid
    tend = np.random.default_rng(6).normal(size=(CELLS,) if xy else (NZ, CELLS))
    ref = jv.apply_flux_bcs(tend, {"top": tt.Flux(0.2), "bottom": tt.Flux(-0.1)}, None,
                            np.asarray(grid.vertical.dz)[:, None], xy=xy)
    got = pv.apply_flux_bcs(torch.as_tensor(tend), {"top": tp.Flux(0.2),
                                                    "bottom": tp.Flux(-0.1)}, None, grid.dz, xy=xy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_hydrology_invclosure_matches_jax():
    """Pressure head to saturation, then the adjustment (absolute 1e-12, as
    in `test_saturation_adjustment_matches_jax`) and the water table."""
    jsim, jstate, psim, _ = both_states(0)
    psi = np.random.default_rng(8).uniform(-3.0, 0.5, (NZ, CELLS))
    jstate = jsim.model.closure(jstate, jsim.ctx).update(pressure_head=psi)
    pstate = _port(jstate, psim)
    jsoil, psoil = jsim.model.soil, psim.model.soil
    ref = jsoil.hydrology.invclosure(jstate, jsim.model.grid, jsoil, jsim.model.constants)
    psoil.hydrology.invclosure(pstate, psim.model.grid, psoil, psim.model.constants)
    for name in ("saturation_water_ice", "surface_excess_water", "water_table"):
        np.testing.assert_allclose(pstate[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


def test_forward_euler_step_matches_jax():
    """One full (not closure-rotated) module step: tendencies, auxiliaries
    and the closure after the update."""
    jsim, psim = jax_sim("golden", CELLS, NZ), port_sim("golden", CELLS, NZ)
    ref = jsim.step_fn(jsim.state, 300.0)
    psim.timestepper.step(psim.model, psim.state, psim.ctx, (), 300.0)
    assert_fields_close(psim.state, ref, FIELDS + ("hydraulic_conductivity",))
    for name, want in ref.tendencies.items():
        want = np.asarray(want)
        np.testing.assert_allclose(psim.state.tendencies[name].numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(want)), err_msg=name)
    assert psim.current_time == float(ref.clock.time) == 300.0
