"""Builders shared by the ``test_torch_*`` files: one soil configuration set
up in the JAX package and in the PyTorch port from the same numbers."""
import numpy as np
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp

#: the configurations of `tests/test_goldens.py:20-36` ("golden") and
#: `bench.py:43-64` ("bench"): field initializers (numpy, shared by both
#: packages) and the top temperature BC as (jax form, torch form)
CONFIGS = {
    "golden": dict(
        inits={"temperature": lambda x, z: 2.0 * np.sin(2 * np.pi * x) - 0.05 * z,
               "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.6 - 0.05 * z)},
        bc_jax=lambda t: -5.0 + 0.0 * t,
        bc_torch=lambda t: -5.0 + 0.0 * t),
    "bench": dict(
        inits={"temperature": lambda x, z: 1.0 + 0.0 * z,
               "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.5 - 0.05 * z)},
        bc_jax=lambda t: 5.0 * tt_sin(2 * np.pi * t / 86400.0),
        bc_torch=lambda t: 5.0 * torch.sin(2 * torch.pi * t / 86400.0)),
}


def tt_sin(x):
    import jax.numpy as jnp

    return jnp.sin(x)


def jax_soil():
    props = tt.ConstantSoilHydraulics(swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
                                      unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
    return tt.SoilEnergyWaterCarbon(hydrology=tt.SoilHydrology(
        vertical_flow=tt.RichardsEq(), hydraulic_properties=props))


def port_soil():
    props = tp.ConstantSoilHydraulics(swrc=tp.VanGenuchten(alpha=2.0, n=2.0),
                                      unsat_hydraulic_cond=tp.UnsatKVanGenuchten())
    return tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(
        vertical_flow=tp.RichardsEq(), hydraulic_properties=props))


def jax_sim(config, cells, nz, dt=300.0, nf=np.float64):
    grid = tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=nz), nf=nf)
    cfg = CONFIGS[config]
    return tt.initialize(tt.SoilModel(grid=grid, soil=jax_soil()), tt.ForwardEuler(dt=dt),
                         initializers=cfg["inits"],
                         boundary_conditions=tt.PrescribedSurfaceTemperature(cfg["bc_jax"]))


def port_sim(config, cells, nz, dt=300.0, dtype=torch.float64, device="cpu"):
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz),
                            dtype=dtype, device=device)
    cfg = CONFIGS[config]
    return tp.initialize(tp.SoilModel(grid=grid, soil=port_soil()), tp.ForwardEuler(dt=dt),
                         initializers=cfg["inits"],
                         boundary_conditions=tp.PrescribedSurfaceTemperature(cfg["bc_torch"]))


def jax_state_arrays(state):
    """A JAX state's fields as ``{"<group>/<name>": ndarray}`` (the input
    of `terrarium_tpu_torch.convert.state_from_numpy`)."""
    return {f"{g}/{k}": np.asarray(v)
            for g in ("prognostic", "tendencies", "auxiliary", "inputs")
            for k, v in getattr(state, g).items()}


def assert_fields_close(port_state, jax_state, names, rtol=1e-12, rel_atol=1e-12):
    """Each named field agrees to ``rtol``, with an absolute floor of
    ``rel_atol`` times the field's largest magnitude (differences of nearly
    equal fluxes lose relative precision near zero)."""
    for name in names:
        ref = np.asarray(jax_state[name])
        got = port_state[name].detach().cpu().numpy()
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=rtol,
                                   atol=rel_atol * max(float(np.max(np.abs(ref))), 1e-300),
                                   err_msg=name)
