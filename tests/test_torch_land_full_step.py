"""One full LandModel step (``terrarium_tpu_torch/ops/fused_step.py::
make_fused_step`` over a LandModel, ``ops/land_step.py::land_column_full_step``):
ForwardEuler, Heun and ImplicitEuler (Thomas, PCR; one Picard iteration and
more), with and without a snowpack, over bare ground and the vegetated
composition. Its plain version against the JAX package's XLA
``timestepper.step`` and its ``make_fused_step`` (Pallas interpret mode),
the stored auxiliaries the step reads, steps against ``run``'s rollout, and
the kernel's column code (``land::full_step_column`` in
``csrc/land_full_step.cuh``) compiled for the host against the plain
version on random full states. The kernel itself is held to the plain
version on the card in `test_torch_kernel_cuda.py`.

The configuration is `tests/test_fused_step.py:201-253`'s on 16 columns at
latitudes from -60 to 80 degrees, Nz 8, with static inputs: the shortwave
and air temperature of a day's late morning per latitude, longwave, rain,
snowfall, wind and humidity. The explicit steppers run at dt 60 s, where
the land's explicit Richards step is stable (ROADMAP Queue C), ImplicitEuler
at 600 s.
"""
import ctypes
import pathlib
import shutil
import subprocess
import tempfile

import jax
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.ops.fused_step import make_fused_step as jax_make_fused_step
from terrarium_tpu_torch.convert import state_from_numpy
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.ops import land_step as ls
from terrarium_tpu_torch.timesteppers.integrator import advance

from test_torch_fused_step_implicit import (GROUPS, _leaves, _perturbed, assert_step_matches_jax,
                                            jax_state_from)
from torch_parity import jax_state_arrays, land_model, land_random_state

HERE = pathlib.Path(__file__).parent
CSRC = HERE.parent / "terrarium_tpu_torch" / "csrc"
CELLS, NZ = 16, 8
#: stepper name: (class, solver, Picard iterations, dt)
STEPPERS = {"euler": ("ForwardEuler", None, 1, 60.0), "heun": ("Heun", None, 1, 60.0),
            "implicit-pcr": ("ImplicitEuler", "pcr", 1, 600.0),
            "implicit-thomas": ("ImplicitEuler", "thomas", 1, 600.0),
            "implicit-pcr-2": ("ImplicitEuler", "pcr", 2, 600.0),
            "implicit-thomas-2": ("ImplicitEuler", "thomas", 2, 600.0)}


def _stepper(m, name):
    cls, solver, picard, dt = STEPPERS[name]
    if solver is None:
        return getattr(m, cls)(dt=dt)
    return m.ImplicitEuler(dt=dt, solver=solver, picard_iters=picard)


def _static(m, composition, stepper, cells=CELLS):
    """The static configuration (module docstring) of ``composition``
    (``torch_parity.land_model``'s) in package ``m``, float64."""
    if m is tt:
        grid = tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=NZ), nf=np.float64)
    else:
        grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=NZ),
                                dtype=torch.float64, device="cpu")
    coslat = np.cos(np.deg2rad(np.linspace(-60.0, 80.0, cells)))
    model = land_model(m, grid, composition)
    names = {v.name for v in model.variables()}
    inits = {"temperature": 4.0, "saturation_water_ice": 0.6}
    inits.update({k: v for k, v in (("carbon_vegetation", 2.0), ("vegetation_area_fraction", 0.5),
                                    ("snow_water_equivalent", 0.01)) if k in names})
    return m.initialize(
        model, _stepper(m, stepper),
        (m.FieldInputSource(fields={
            "surface_shortwave_down": 650.0 * coslat, "air_temperature": 9.0 * coslat - 1.0,
            "surface_longwave_down": 330.0, "rainfall": 4.0e-8, "snowfall": 2.0e-8,
            "windspeed": 3.0, "specific_humidity": 0.006}),),
        initializers=inits)


def _fused(sim, dt):
    return fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources, dt=dt)


CASES = [("euler", "consistent_snow"), ("heun", "consistent_snow"), ("heun", "bare"),
         ("implicit-pcr", "consistent"), ("implicit-thomas", "consistent_snow"),
         ("implicit-pcr-2", "consistent_snow"), ("implicit-thomas-2", "consistent"),
         ("euler", "bare")]


@pytest.mark.parametrize("stepper,composition", CASES)
def test_plain_matches_jax_step_and_pallas(stepper, composition):
    """Three full steps along JAX's XLA trajectory from its initialized
    state, each step from JAX's state carried over with ``state_from_numpy``:
    every prognostic, tendency and auxiliary and the clock of the port's
    ``make_fused_step`` (the plain version on the CPU) against JAX's XLA
    ``timestepper.step`` and JAX's ``make_fused_step(interpret=True)`` from
    the same state, by `test_torch_fused_step_implicit.py`'s rule
    (:func:`assert_step_matches_jax`)."""
    dt = STEPPERS[stepper][3]
    jsim, psim = _static(tt, composition, stepper), _static(tp, composition, stepper)
    jfused = jax.jit(jax_make_fused_step(jsim.model, jsim.timestepper, jsim.ctx, jsim.input_sources,
                                 dt=dt, block_cells=128, interpret=True))
    assert_step_matches_jax(jsim, jfused, psim.model.grid, _fused(psim, dt), dt)


#: what a full land step reads of the stored auxiliaries (JAX's and the port's)
LAND_STORED_READS = {("auxiliary", n) for n in (
    "temperature", "liquid_water_fraction", "pressure_head", "ground_temperature",
    "net_assimilation", "root_fraction")}


def _census(step, arrays, make_state):
    """The stored auxiliaries and tendencies whose perturbation moves a leaf
    of ``step(make_state(arrays))`` other than itself."""
    base = {k: np.asarray(v) for k, v in _leaves(step(make_state(arrays))).items()}
    rng = np.random.default_rng(3)
    moves = set()
    for key in arrays:
        group, _, name = key.partition("/")
        if group not in ("auxiliary", "tendencies"):
            continue
        out = _leaves(step(make_state({**arrays, key: _perturbed(arrays[key], rng)})))
        if any(not np.array_equal(np.asarray(v), base[k]) for k, v in out.items()
               if k != (group, name)):
            moves.add((group, name))
    return moves


@pytest.mark.parametrize("stepper", ["euler", "heun", "implicit-pcr-2"])
def test_stored_reads_census(stepper):
    """The vegetated composition with a snowpack, stepped twice, each stored
    auxiliary and tendency perturbed in turn, stepped once more: the set
    that moves any other leaf is {the temperature, the liquid fraction, the
    pressure head, the ground temperature, the net assimilation, the root
    fraction}, in JAX's XLA step and in the port's plain version alike (the
    host build's reads are pinned in `test_host_full_step_census`)."""
    dt = STEPPERS[stepper][3]
    jsim, psim = (_static(m, "consistent_snow", stepper, 8) for m in (tt, tp))
    state = jsim.step_fn(jsim.step_fn(jsim.state, dt), dt)
    arrays = jax_state_arrays(state)
    time, it = float(state.clock.time), int(state.clock.iteration)
    assert _census(lambda s: jsim.step_fn(s, dt), arrays,
                   lambda a: jax_state_from(jsim, a, time, it)) == LAND_STORED_READS
    assert _census(_fused(psim, dt), arrays, lambda a: state_from_numpy(
        a, time, it, psim.model.grid)) == LAND_STORED_READS


@pytest.mark.parametrize("stepper,composition", [
    ("euler", "consistent_snow"), ("heun", "consistent"), ("implicit-pcr-2", "consistent_snow"),
    ("implicit-thomas", "bare")])
def test_fused_steps_then_closure_equal_run(stepper, composition):
    """12 full steps, then ``closure``, equal ``run``'s rollout (``advance``:
    the land rollout's plain version, the closure-rotated steps, and the
    trailing closure) on the live carry and the closure variables at 1e-12;
    the state handed to ``fused`` is left as it was."""
    dt = STEPPERS[stepper][3]
    a, b = (_static(tp, composition, stepper) for _ in range(2))
    fused = _fused(a, dt)
    state = a.state
    before = {k: v.clone() for k, v in state.prognostic.items()}
    for _ in range(12):
        state = fused(state)
    assert all(torch.equal(a.state.prognostic[k], v) for k, v in before.items())
    a.model.closure(state, a.ctx)
    advance(b.model, b.state, b.ctx, 12, dt, timestepper=b.timestepper,
            input_sources=b.input_sources)
    names = list(a.model.live_carry) + ["temperature", "liquid_water_fraction",
                                        "ground_temperature"]
    if "pressure_head" in state.auxiliary:
        names += ["pressure_head", "water_table"]
    for name in names:
        want = b.state[name]
        torch.testing.assert_close(state[name], want, rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()), msg=name)
    assert float(state.clock.time) == float(b.state.clock.time)
    assert int(state.clock.iteration) == 12


def test_wrapper_on_cpu_runs_the_plain_version():
    sim = _static(tp, "consistent_snow", "implicit-pcr-2")
    before = ls.land_column_full_step.launches
    out = ls.land_column_full_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources,
                                   sim.state, 600.0)
    ref = ls.land_column_full_step_plain(sim.model, sim.timestepper, sim.ctx, sim.input_sources,
                                         sim.state, 600.0)
    assert ls.land_column_full_step.launches == before
    for group in GROUPS:
        for k, v in getattr(ref, group).items():
            assert torch.equal(getattr(out, group)[k], v), (group, k)
    with pytest.raises(ValueError, match="land_column_full_step runs a LandModel"):
        soil = _static_soil()
        ls.land_column_full_step(soil.model, soil.timestepper, soil.ctx, (), soil.state, 60.0)


def _static_soil():
    grid = tp.ColumnGrid.of(cells=4, spacing=tp.ExponentialSpacing(N=8), dtype=torch.float64,
                            device="cpu")
    return tp.initialize(tp.SoilModel(grid=grid), tp.ForwardEuler(dt=60.0),
                         initializers={"temperature": 1.0, "saturation_water_ice": 0.8},
                         boundary_conditions=tp.PrescribedSurfaceTemperature(2.0))


# ---------------------------------------------------------------------------
# the kernel's column code, compiled for the host
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def host():
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = pathlib.Path(tempfile.mkdtemp()) / "full_step_host.so"
    subprocess.run([cxx, "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(out), str(HERE / "full_step_host.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.host_land_full_step.restype = ctypes.c_int
    return lib


def _vg_mualem(m, grid):
    """Bare ground over Richards flow with Van Genuchten and Mualem K
    (`test_torch_land_steppers.py::test_implicit_land_model_reproduced`'s
    composition with ``NoCanopyInterception``)."""
    props = m.ConstantSoilHydraulics(swrc=m.VanGenuchten(alpha=2.0, n=2.0),
                                     unsat_hydraulic_cond=m.UnsatKVanGenuchten(),
                                     sat_hydraulic_cond=1e-6)
    soil = m.SoilEnergyWaterCarbon(
        strat=m.HomogeneousStratigraphy(texture=m.SoilTexture.preset("loam")),
        hydrology=m.SoilHydrology(vertical_flow=m.RichardsEq(), hydraulic_properties=props))
    return m.LandModel(grid=grid, soil=soil,
                       surface_energy_balance=m.SurfaceEnergyBalance.consistent(),
                       surface_hydrology=m.SurfaceHydrology(
                           canopy_interception=m.NoCanopyInterception(),
                           evapotranspiration=m.BareGroundEvaporation.consistent_units()))


def random_full_state(composition, stepper, seed, cells=64):
    """A port simulation of ``composition`` (``"vg_mualem"``, or
    ``torch_parity.land_model``'s) at Nz 8 whose state holds
    ``land_random_state``'s carry and static inputs, which reach every clamp
    and branch of the step, and a stored temperature, liquid fraction,
    pressure head, ground temperature and net assimilation drawn apart from
    the prognostics, so that a step shows it reads them as stored."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=NZ),
                            dtype=torch.float64, device="cpu")
    model = (_vg_mualem(tp, grid) if composition == "vg_mualem"
             else land_model(tp, grid, composition))
    f = land_random_state(seed, cells, NZ, extremes=False)
    names = model.collated_variables()
    static = {n: f[n] for n in ls.LAND_INPUTS if n in names.inputs}
    sim = tp.initialize(model, _stepper(tp, stepper), (tp.FieldInputSource(fields=static),),
                        initializers={"temperature": 1.0})
    st = sim.state
    for n in st.prognostic:
        st.prognostic[n] = torch.as_tensor(f[n]).clone()
    if "saturation_water_ice" not in st.prognostic:
        st.set(saturation_water_ice=torch.as_tensor(f["saturation_water_ice"]).clamp(0.0, 1.0))
    rng = np.random.default_rng(seed + 77)
    st.set(temperature=torch.as_tensor(rng.uniform(-12.0, 9.0, (NZ, cells))),
           liquid_water_fraction=torch.as_tensor(rng.choice([0.0, 1.0], (NZ, cells))
                                                 * rng.uniform(0.2, 1.0, (NZ, cells))),
           ground_temperature=torch.as_tensor(rng.uniform(-15.0, 25.0, cells)))
    if "pressure_head" in st.auxiliary:
        st.set(pressure_head=torch.as_tensor(rng.uniform(-6.0, 1.0, (NZ, cells))))
    if "net_assimilation" in st.auxiliary:
        st.set(net_assimilation=torch.as_tensor(rng.uniform(-1e-3, 5e-3, cells)))
    return sim


def host_full_step(lib, sim, state, stepper):
    """``land::full_step_column`` over every column of ``state``: the
    tensors it fills, ``{(group, name): tensor}``."""
    tags, args, keep, out = ls.land_full_step_buffers(sim.model, state)
    for group in out.values():
        for t in group.values():
            t.fill_(float("nan"))
    _, solver, picard, dt = STEPPERS[stepper]
    richards = tags[1] == "richards"
    curve = {"vg": 0, "bc": 1}[tags[2]] if richards else 0
    cond = {"mualem": 0, "linear": 1}[tags[3] if richards else tags[2]]
    code = {"euler": 0, "heun": 1}.get(stepper, 2)
    rc = lib.host_land_full_step(
        args[0], args[1], ctypes.c_void_p(args[2]), ctypes.c_longlong(args[3]),
        ctypes.c_longlong(args[4]), *(ctypes.c_void_p(a) for a in args[5:9]), args[9],
        ctypes.c_int(NZ), ctypes.c_int(tags[0] == "veg"), ctypes.c_int(richards),
        ctypes.c_int(curve), ctypes.c_int(cond), ctypes.c_int("snow" in tags), ctypes.c_int(code),
        ctypes.c_int(picard), ctypes.c_int(fs.SOLVER_CODES.get(solver, 0)), ctypes.c_double(dt),
        ctypes.c_longlong(state.internal_energy.shape[1]))
    del keep
    assert rc == 0
    return {(g, n): t for g, d in out.items() for n, t in d.items()}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("stepper", ["euler", "heun", "implicit-pcr", "implicit-thomas-2"])
@pytest.mark.parametrize("composition", ["bare", "vg_mualem", "consistent", "consistent_snow"])
def test_host_full_step_matches_plain(host, composition, stepper, seed):
    """``land::full_step_column`` over 64 random full states (bare ground
    over heat only, bare ground over Van Genuchten/Mualem Richards flow, the
    vegetated composition with and without a snowpack) against the module
    step at 1e-12 on every leaf the step writes (with a floor of 1e-12 of
    each leaf's largest magnitude; the others, the root fraction and under
    NoFlow the saturation and water table, pass through): the same
    operations in the same order, FMAs off on both sides."""
    sim = random_full_state(composition, stepper, seed)
    dt = STEPPERS[stepper][3]
    got = host_full_step(host, sim, sim.state, stepper)
    ref = ls.land_column_full_step_plain(sim.model, sim.timestepper, sim.ctx, sim.input_sources,
                                         sim.state, dt)
    passed = {("auxiliary", "root_fraction"), ("auxiliary", "saturation_water_ice"),
              ("auxiliary", "water_table")}
    assert set(_leaves(ref)) - set(got) <= passed
    for key, a in got.items():
        want = getattr(ref, key[0])[key[1]]
        assert bool(torch.isfinite(want).all()), key
        torch.testing.assert_close(a, want, rtol=1e-12, atol=1e-12 * float(want.abs().max()),
                                   msg=str(key))


@pytest.mark.parametrize("stepper", ["euler", "implicit-pcr-2"])
def test_host_full_step_census(host, stepper):
    """The host build's reads of the stored auxiliaries, as
    `test_stored_reads_census` pins JAX's and the port's: perturbing each
    of the stored temperature, liquid fraction, pressure head, ground
    temperature, net assimilation and root fraction moves a leaf it writes,
    and no other auxiliary or tendency does."""
    sim = random_full_state("consistent_snow", stepper, 0, cells=16)
    base = host_full_step(host, sim, sim.state, stepper)
    rng = np.random.default_rng(4)
    moves = set()
    for group in ("auxiliary", "tendencies"):
        for name, leaf in getattr(sim.state, group).items():
            st = sim.state.copy()
            getattr(st, group)[name] = torch.as_tensor(_perturbed(leaf.numpy(), rng))
            out = host_full_step(host, sim, st, stepper)
            if any(not torch.equal(v, base[k]) for k, v in out.items() if k != (group, name)):
                moves.add((group, name))
    assert moves == LAND_STORED_READS
