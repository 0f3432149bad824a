"""The port's default soil model against the JAX package's: ``NoFlow``
hydrology over ``SoilHydraulicsSURFEX`` (Brooks-Corey curve, linear
conductivity), so ``SoilModel(grid=g)`` is heat conduction only, with the
saturation an auxiliary. At float64 on the CPU: the declared variables, the
new parameterizations, the initial state, the heat-only rollout against
JAX's Pallas kernel (interpret mode) and XLA lean rollout, ``run`` end to
end, and the types the kernel entry points refuse.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.ops.fused_step import make_fused_lean_rollout
from terrarium_tpu.utils.scan_dce import _dead_input_mask
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.processes.soil.stratigraphy import SoilVolume
from terrarium_tpu_torch.timesteppers.integrator import advance

from torch_parity import assert_fields_close, heat_forcing, port_soil

FIELDS = ("internal_energy", "temperature", "liquid_water_fraction", "ground_temperature",
          "saturation_water_ice", "water_table", "hydraulic_conductivity")


@pytest.mark.parametrize("nz", [15, 30])
def test_default_model_declares_the_jax_variables(nz):
    """Names, kinds and shapes of every declared variable, in order: one
    prognostic (the internal energy); the saturation is an auxiliary."""
    jg = tt.ColumnGrid.of(cells=3, spacing=tt.ExponentialSpacing(N=nz), nf=np.float64)
    pg = tp.ColumnGrid.of(cells=3, spacing=tp.ExponentialSpacing(N=nz), dtype=torch.float64,
                          device="cpu")
    jv, pv = tt.Variables.of(tt.SoilModel(grid=jg)), tp.Variables.of(tp.SoilModel(grid=pg))
    for group in ("prognostic", "auxiliary", "inputs", "tendencies"):
        j, p = getattr(jv, group), getattr(pv, group)
        assert list(p) == list(j), group
        for name in j:
            assert pg.shape(p[name].dims) == jg.shape(j[name].dims), (group, name)
    assert list(pv.prognostic) == ["internal_energy"]
    assert "saturation_water_ice" in pv.auxiliary
    assert tp.SoilModel(grid=pg).live_carry == ("internal_energy",)


def test_default_parameterizations_match_jax():
    """Brooks-Corey, ``UnsatKLinear`` and the SURFEX water limits on random
    states, at rtol 1e-14."""
    rng = np.random.default_rng(5)
    psi = rng.uniform(-50.0, 0.5, 200)
    theta = rng.uniform(-0.05, 0.6, 200)
    jbc, pbc = tt.BrooksCorey(), tp.BrooksCorey()
    np.testing.assert_allclose(pbc(torch.as_tensor(psi), 0.49).numpy(),
                               np.asarray(jbc(jnp.asarray(psi), 0.49)), rtol=1e-14)
    np.testing.assert_allclose(pbc.inverse(torch.as_tensor(theta), 0.49).numpy(),
                               np.asarray(jbc.inverse(jnp.asarray(theta), 0.49)), rtol=1e-14)
    sat, liq = rng.uniform(0.0, 1.0, (2, 5, 7))
    jvol = tt.SoilVolume(porosity=0.49, saturation=jnp.asarray(sat), liquid=jnp.asarray(liq),
                         organic=0.1, texture=tt.SoilTexture(sand=0.4, clay=0.3))
    pvol = SoilVolume(porosity=0.49, saturation=torch.as_tensor(sat),
                      liquid=torch.as_tensor(liq), organic=0.1)
    for jh, ph in ((tt.SoilHydraulicsSURFEX(), tp.SoilHydraulicsSURFEX()),
                   (tt.ConstantSoilHydraulics(), tp.ConstantSoilHydraulics())):
        np.testing.assert_allclose(ph.hydraulic_conductivity(pvol).numpy(),
                                   np.asarray(jh.hydraulic_conductivity(jvol)), rtol=1e-14)
    tex_j, tex_p = tt.SoilTexture(sand=0.4, clay=0.3), tp.SoilTexture(sand=0.4, clay=0.3)
    surfex_j, surfex_p = tt.SoilHydraulicsSURFEX(), tp.SoilHydraulicsSURFEX()
    assert surfex_p.wilting_point(tex_p) == pytest.approx(float(surfex_j.wilting_point(tex_j)),
                                                          rel=1e-15)
    assert surfex_p.field_capacity(tex_p) == pytest.approx(
        float(surfex_j.field_capacity(tex_j)), rel=1e-15)


def test_default_initial_state_matches_jax():
    """``initialize`` with a series source: inputs seeded first, then the
    field initializers, then NoFlow's hydraulics and water table and the
    energy from the temperature; every field at 1e-12."""
    jsim, psim = heat_forcing("jax", 24, dtype=torch.float64), heat_forcing("port", 24,
                                                                            dtype=torch.float64)
    for g in ("prognostic", "auxiliary", "inputs", "tendencies"):
        assert sorted(getattr(psim.state, g)) == sorted(getattr(jsim.state, g)), g
    assert_fields_close(psim.state, jsim.state, FIELDS + ("surface_temperature",))


@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_heat_rollout_matches_jax(ref):
    """``global_heat_n72_forcing`` on 24 columns, 24 steps: the plain
    heat-only rollout (the kernel's arithmetic) against JAX's Pallas kernel
    in interpret mode and its XLA lean rollout, at 1e-12."""
    jsim, psim = heat_forcing("jax", 24, dtype=torch.float64), heat_forcing("port", 24,
                                                                            dtype=torch.float64)
    if ref == "pallas":
        fused = make_fused_lean_rollout(jsim.model, jsim.timestepper, jsim.ctx,
                                        jsim.input_sources, dt=300.0, inner_steps=8,
                                        block_cells=128, interpret=True)
        jstate = jax.jit(lambda s: fused(s, 24))(jsim.state)
    else:
        jstate = jsim._rollout_fn(24)(jsim.state, 300.0)
    advance(psim.model, psim.state, psim.ctx, 24, 300.0, input_sources=psim.input_sources,
            plain=True)
    assert_fields_close(psim.state, jstate, ("internal_energy", "temperature",
                                             "liquid_water_fraction", "saturation_water_ice"))
    assert torch.equal(psim.state.saturation_water_ice,
                       torch.full_like(psim.state.saturation_water_ice, 0.8))


@pytest.mark.parametrize("stepper", ["euler", "heun"])
def test_heat_run_matches_jax_run(stepper):
    """``Simulation.run`` of the default model end to end, ForwardEuler and
    Heun: prognostic, closure and auxiliary fields and the inputs at 1e-12."""
    jsim, psim = heat_forcing("jax", 16, dtype=torch.float64), heat_forcing("port", 16,
                                                                            dtype=torch.float64)
    if stepper == "heun":
        jsim = tt.Simulation(jsim.model, tt.Heun(dt=300.0), jsim.state, jsim.input_sources,
                             bcs=jsim.bcs)
        psim = tp.Simulation(psim.model, tp.Heun(dt=300.0), psim.state, psim.input_sources,
                             bcs=psim.bcs)
    jsim.run(steps=48, dt=300.0)
    psim.run(steps=48, dt=300.0)
    assert_fields_close(psim.state, jsim.state, FIELDS + ("surface_temperature",))
    assert psim.current_time == jsim.current_time and psim.iteration == jsim.iteration


@pytest.mark.parametrize("stepper", ["euler", "heun"])
def test_plain_heat_rollout_equals_module_steps(stepper):
    """The plain heat-only rollout and ``closure`` after ``pre_closure_step``
    repeated, composed from the modules, are the same arithmetic, bitwise."""
    def build():
        grid = tp.ColumnGrid.of(cells=12, spacing=tp.ExponentialSpacing(N=30),
                                dtype=torch.float64, device="cpu")
        ts = tp.Heun(dt=300.0) if stepper == "heun" else tp.ForwardEuler(dt=300.0)
        return tp.initialize(
            tp.SoilModel(grid=grid), ts,
            initializers={"temperature": lambda x, z: 2.0 * np.sin(2 * np.pi * x) - 0.05 * z,
                          "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.5 - 0.05 * z)},
            boundary_conditions=tp.PrescribedSurfaceTemperature(
                lambda t: -6.0 + 4.0 * torch.sin(2 * torch.pi * t / 86400.0)))

    sim, ref = build(), build()
    advance(sim.model, sim.state, sim.ctx, 40, 300.0, timestepper=sim.timestepper, plain=True)
    for _ in range(40):
        ref.timestepper.pre_closure_step(ref.model, ref.state, ref.ctx, (), 300.0)
    ref.model.closure(ref.state, ref.ctx)
    for name in FIELDS[:5]:
        torch.testing.assert_close(sim.state[name], ref.state[name], rtol=0, atol=0)


def test_live_carry_matches_jax_dead_input_mask():
    """Under NoFlow a traced JAX ``pre_closure_step`` (with its source, which
    writes the input) consumes the internal energy and the clock, and passes
    the saturation and the water table through unchanged, the saturation
    also read: the port carries the energy and reads the saturation, and its
    state keeps both auxiliaries as they are."""
    sim = heat_forcing("jax", 4, nz=15, dtype=torch.float64)
    state = sim.state
    leaves, treedef = jax.tree.flatten(state)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]]

    def flat_step(lv, d):
        out = sim.timestepper.pre_closure_step(sim.model, jax.tree.unflatten(treedef, lv),
                                               sim.ctx, sim.input_sources, d)
        return jax.tree.leaves(out)

    used = _dead_input_mask(flat_step, leaves, 300.0)[:len(leaves)]
    live = {p for p, u in zip(paths, used) if u}
    port = heat_forcing("port", 4, nz=15, dtype=torch.float64)
    expected = {f".prognostic['{n}']" for n in port.model.live_carry}
    assert live == expected | {".auxiliary['saturation_water_ice']",
                               ".auxiliary['water_table']", ".clock.time", ".clock.iteration"}
    before = {k: v.clone() for k, v in port.state.auxiliary.items()
              if k in ("saturation_water_ice", "water_table")}
    port.run(steps=6)
    for k, v in before.items():
        assert torch.equal(port.state.auxiliary[k], v), k


def _richards(props):
    grid = tp.ColumnGrid.of(cells=3, spacing=tp.ExponentialSpacing(N=10),
                            dtype=torch.float64, device="cpu")
    soil = tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq(),
                                                               hydraulic_properties=props))
    return tp.SoilModel(grid=grid, soil=soil)


class _Duck:
    """Not a class the kernels know; reading any attribute of it fails."""

    def __getattr__(self, name):
        raise AssertionError(f"read {name!r} of an unsupported class")


@pytest.mark.parametrize("case", ["richards-brooks-corey", "richards-default-hydraulics",
                                  "richards-unknown-hydraulics", "unknown-flow", "not-a-model"])
def test_kernel_entry_points_refuse_what_they_do_not_run(case):
    """``ColumnParams.of`` (and through it ``advance`` and the fused gradient
    rollout) raises ``ValueError`` naming what the kernels run, checking each
    class before reading its attributes."""
    if case == "richards-brooks-corey":
        model = _richards(tp.ConstantSoilHydraulics(swrc=tp.BrooksCorey(),
                                                    unsat_hydraulic_cond=tp.UnsatKVanGenuchten()))
        match = "VanGenuchten and UnsatKVanGenuchten"
    elif case == "richards-default-hydraulics":
        model, match = _richards(tp.ConstantSoilHydraulics()), "VanGenuchten"
    elif case == "richards-unknown-hydraulics":
        model, match = _richards(_Duck()), "ConstantSoilHydraulics or SoilHydraulicsSURFEX"
    elif case == "unknown-flow":
        base = tp.SoilModel(grid=_richards(tp.ConstantSoilHydraulics()).grid)
        soil = dataclasses.replace(base.soil, hydrology=dataclasses.replace(
            base.soil.hydrology, vertical_flow=_Duck()))
        model, match = dataclasses.replace(base, soil=soil), "NoFlow or RichardsEq"
    else:
        model, match = _Duck(), "SoilModel"
    with pytest.raises(ValueError, match=match):
        fs.ColumnParams.of(model, torch.float64)


def test_kernel_physics_of_the_supported_models():
    surfex = tp.SoilHydraulicsSURFEX(swrc=tp.VanGenuchten(alpha=2.0, n=2.0),
                                     unsat_hydraulic_cond=tp.UnsatKVanGenuchten())
    grid = _richards(surfex).grid
    assert fs.kernel_physics(_richards(surfex)) == "richards"
    assert fs.kernel_physics(tp.SoilModel(grid=grid, soil=port_soil())) == "richards"
    assert fs.kernel_physics(tp.SoilModel(grid=grid)) == "heat"
    p = fs.ColumnParams.of(tp.SoilModel(grid=grid), torch.float64)
    assert p.K_sat == 0.0 and p.por == 0.49
