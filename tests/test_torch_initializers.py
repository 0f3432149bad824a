"""The port's soil initializers against the JAX package's, and the
composition of `examples/soil_heat_column.py` (BASELINE config #1) that
needs them, at float64 (and float32 for the example) on the CPU.

Each initializer sets its field on a ``SoilModel`` through ``initialize``
(the model initializer runs after the field initializers, then the soil's
own initialization derives the energy from the temperature); both packages
take the same numbers. ``SaturationWaterTable`` reads ``water_table_depth``
as a positive-down depth, as the JAX package does (its docstring's NOTE).
"""
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.utils.utils import piecewise_linear as jax_piecewise_linear
from terrarium_tpu_torch.utils.utils import piecewise_linear

from torch_parity import assert_fields_close

FIELDS = ("temperature", "saturation_water_ice", "internal_energy", "liquid_water_fraction")
#: name -> initializer arguments, the same for both packages
INITIALIZERS = {
    "ConstantSoilTemperature": lambda m: m.ConstantSoilTemperature(T0=-2.5),
    "QuasiThermalSteadyState": lambda m: m.QuasiThermalSteadyState(T0=-1.0, Qgeo=0.05,
                                                                    k_eff=1.7),
    "PiecewiseLinearInitialSoilTemperature": lambda m: m.PiecewiseLinearInitialSoilTemperature(
        knots=((2.0, 1.5), (0.0, -3.0), (0.5, 4.0), (6.0, -0.5))),
    "ConstantSaturation": lambda m: m.ConstantSaturation(sat=0.62),
    "SaturationWaterTable": lambda m: m.SaturationWaterTable(vadose_zone_saturation=0.35,
                                                             water_table_depth=1.2),
    "SoilInitializer": lambda m: m.SoilInitializer(),
    "SoilInitializer(custom)": lambda m: m.SoilInitializer(
        energy=m.PiecewiseLinearInitialSoilTemperature(knots=((0.0, 2.0), (3.0, -1.0))),
        hydrology=m.SaturationWaterTable(vadose_zone_saturation=0.4, water_table_depth=0.8)),
}


def _initialized(m, initializer, nz=16, dtype=torch.float64):
    kw = (dict(nf=np.float32 if dtype == torch.float32 else np.float64) if m is tt
          else dict(dtype=dtype, device="cpu"))
    grid = m.ColumnGrid.of(cells=3, spacing=m.ExponentialSpacing(N=nz), **kw)
    model = m.SoilModel(grid=grid, initializer=initializer)
    return m.initialize(model, m.ForwardEuler(),
                        initializers={"temperature": 7.0, "saturation_water_ice": 0.9},
                        boundary_conditions=m.PrescribedSurfaceTemperature(1.0))


@pytest.mark.parametrize("name", INITIALIZERS)
def test_initializer_matches_jax(name):
    """The initialized state's temperature, saturation, energy and liquid
    fraction at 1e-12; each initializer overrides the field initializer
    it sets (the model initializer runs after them)."""
    jsim = _initialized(tt, INITIALIZERS[name](tt))
    psim = _initialized(tp, INITIALIZERS[name](tp))
    assert_fields_close(psim.state, jsim.state, FIELDS)
    changed = {n for n in ("temperature", "saturation_water_ice")
               if not bool((psim.state[n] == (7.0 if n == "temperature" else 0.9)).all())}
    assert changed, name


def test_initializers_order_and_exports():
    """``SoilInitializer`` runs hydrology, biogeochemistry, energy in that
    order, and the package exports the JAX package's initializer names."""
    order = []

    class Record:
        def __init__(self, tag):
            self.tag = tag

        def initialize(self, state, model):
            order.append(self.tag)

    sim = _initialized(tp, tp.SoilInitializer(energy=Record("energy"),
                                              hydrology=Record("hydrology"),
                                              biogeochem=Record("biogeochem")))
    assert order == ["hydrology", "biogeochem", "energy"]
    assert bool((sim.state.temperature == 7.0).all())
    for name in ("SoilInitializer", "ConstantSoilTemperature", "QuasiThermalSteadyState",
                 "PiecewiseLinearInitialSoilTemperature", "ConstantSaturation",
                 "SaturationWaterTable", "DefaultInitializer"):
        assert hasattr(tp, name) and hasattr(tt, name), name


def test_water_table_reads_a_positive_down_depth():
    """Saturated exactly at and below the water table depth (z <= -depth),
    the vadose saturation above it."""
    sim = _initialized(tp, tp.SaturationWaterTable(vadose_zone_saturation=0.3,
                                                   water_table_depth=1.2))
    z = sim.model.grid.z_centers[:, 0]
    sat = sim.state.saturation_water_ice[:, 0]
    assert bool((sat[z <= -1.2] == 1.0).all()) and bool((sat[z > -1.2] == 0.3).all())
    assert bool((z <= -1.2).any()) and bool((z > -1.2).any())


@pytest.mark.parametrize("knots", [((0.0, 0.0),), ((1.0, 2.0), (1.0, 5.0), (3.0, -1.0)),
                                   ((0.5, 1.0), (0.1, -2.0), (2.5, 3.0))])
def test_piecewise_linear_matches_jax(knots):
    """Between, on and beyond the knots (a single knot, a repeated depth,
    unsorted knots), at 1e-14, as ``jnp.interp`` evaluates it."""
    z = np.linspace(-1.0, 4.0, 101)
    got = piecewise_linear(*knots)(torch.as_tensor(z)).numpy()
    want = np.asarray(jax_piecewise_linear(*knots)(z))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)


def _example(m, dtype):
    """`examples/soil_heat_column.py`: one column, Nz 10, the default
    (heat-only) SoilModel with SoilInitializer(QuasiThermalSteadyState(T0=
    -1), ConstantSaturation(1)), a constant 1 degC top, ForwardEuler; one
    timestep, then three days of run."""
    kw = (dict(nf=np.float32 if dtype == torch.float32 else np.float64) if m is tt
          else dict(dtype=dtype, device="cpu"))
    grid = m.ColumnGrid.of(cells=1, spacing=m.ExponentialSpacing(N=10), **kw)
    initializer = m.SoilInitializer(energy=m.QuasiThermalSteadyState(T0=-1.0),
                                    hydrology=m.ConstantSaturation(sat=1.0))
    sim = m.initialize(m.SoilModel(grid=grid, initializer=initializer), m.ForwardEuler(),
                       boundary_conditions=m.PrescribedSurfaceTemperature(1.0))
    sim.timestep()
    sim.run(period=3 * 86400.0)
    return sim


def test_soil_heat_column_example_matches_jax():
    """The example's composition through the port's ``run`` (the heat-only
    ForwardEuler rollout) against JAX's: at float64 every field at 1e-12;
    at float32 the port's distance from JAX's float64 run within twice JAX's
    own float32 distance (each field's largest error, relative to its
    largest magnitude, with a floor of 1e-6). The front of the thaw lies
    inside the column."""
    ref = _example(tt, torch.float64)
    port = _example(tp, torch.float64)
    assert_fields_close(port.state, ref.state, FIELDS + ("ground_temperature",))
    assert port.iteration == int(ref.iteration) == 1 + 3 * 86400 // 300
    jax32, port32 = _example(tt, torch.float32), _example(tp, torch.float32)
    for name in FIELDS:
        want = np.asarray(ref.state[name])
        scale = float(np.max(np.abs(want)))
        e_jax = float(np.max(np.abs(np.asarray(jax32.state[name], dtype=np.float64) - want)))
        e_port = float(np.max(np.abs(port32.state[name].double().numpy() - want)))
        assert e_port <= 2.0 * max(e_jax, 1e-6 * scale), (name, e_port, e_jax)
    liq = port.state.liquid_water_fraction[:, 0]
    assert bool((liq == 1.0).any()) and bool((liq < 1.0).any())
