"""The LandModel's fused gradient against JAX at float64 on the CPU,
ImplicitEuler (Thomas) with three Picard iterations
(`tests/torch_land_grad.py` has the composition, the cases and the checks)."""
import pytest

from torch_land_grad import check_fused_grad, check_sat0_grad, jax_ref, port_ref  # noqa: F401


@pytest.mark.parametrize("route", ["pallas", "remat"])
@pytest.mark.parametrize("case", ["implicit-thomas-3"])
def test_land_fused_grad_matches_jax(jax_ref, port_ref, case, route):
    """`torch_land_grad.check_fused_grad`: the value, d/d log K_sat,
    d/d k_mineral, d/dU0 and d/dC0 against JAX's Pallas segment VJP
    (interpret mode) and its remat rollout."""
    check_fused_grad(jax_ref, port_ref, case, route)


@pytest.mark.parametrize("case", ["implicit-thomas-3"])
def test_land_sat0_grad_matches_jax_sequential_adjustment(jax_ref, port_ref, case):
    """`torch_land_grad.check_sat0_grad`: d/d sat0 against JAX's remat
    rollout under its sequential saturation adjustment."""
    check_sat0_grad(jax_ref, port_ref, case)
