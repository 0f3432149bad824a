"""The probes' plain versions (``terrarium_tpu_torch/experiments/``) against
the JAX probes they port, at float32 and float64 on the CPU; the kernels
themselves are held to the plain versions on the card (`chip_smoke.py`'s
``probes``, `tests/test_torch_kernel_cuda.py`).

Row 6 goes through JAX's own ``experiments/mosaic_min_repro.py::
_kernel_factory(variant)`` under a ``jax.lax.fori_loop``, as its Pallas
kernel loops it. Rows 4 and 5 define their bodies as closures inside
functions that also time and print (``run_micro.make``, ``run_case``), so
the port is held to a ``jnp`` transcription of the cited lines, marked as
such below.

Bounds: the elementwise, stencil and cummin cases take the same
operations in the same order in both packages (or products that are
exact, 2x), so they are equal; row 6 too, but for its exponentials, whose
implementations differ by an ulp or so: rtol 1e-12 at float64, 1e-6 at
float32 (each with an absolute floor of the same size). Row 4's chains at
rtol 1e-12 (float64) and 1e-5 (float32: at most one rounding, one ulp,
apart a step, and the fma chain's map has derivative ~1, so 64 steps from
values in [0.5, 2) stay within 64 x 2^-23 = 7.6e-6; the other maps
contract). The closure's sums are taken in another order (JAX's doubling
scans, the port's level-by-level loop), so it is held within twice the
worst-case rounding of a sum of Nz terms, 2 (Nz - 1) eps (sum |a| + sum
dz) / min dz, at either dtype."""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrarium_tpu_torch.experiments import mosaic_bisect as mb
from terrarium_tpu_torch.experiments import mosaic_min_repro as mr
from terrarium_tpu_torch.experiments import roofline_census as rc

ROOT = pathlib.Path(__file__).resolve().parent.parent
DTYPES = {"f32": (torch.float32, jnp.float32, np.float32),
          "f64": (torch.float64, jnp.float64, np.float64)}


def _jax_experiment(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- row 4: a jnp transcription of experiments/roofline_census.py:264-285 --
def _jax_micro(kind, R, x, nf):
    def body(_, v):
        if kind == "fma":
            return v * nf(1.0000001) + nf(1e-7)
        if kind == "exp":
            return jnp.exp(v * nf(1e-3))
        if kind == "div":
            return nf(1.00001) / (v + nf(1.5))
        return (v + nf(1.5)) ** nf(0.7071)

    if kind == "fma4":
        def body4(_, vs):
            return tuple(v * nf(1.0000001 + 1e-9 * i) + nf(1e-7) for i, v in enumerate(vs))

        vs = jax.lax.fori_loop(0, R, body4, (x, x + 1.0, x + 2.0, x + 3.0))
        return vs[0] + vs[1] + vs[2] + vs[3]
    return jax.lax.fori_loop(0, R, body, x)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("kind", list(rc.KINDS))
def test_micro_chain_matches_jax(kind, dtype):
    """Each kind's chain at its shorter length (64 steps; pow 16) from
    values in [0.5, 1.5), the wrapper on the CPU (the plain version) against
    the transcription, at the module docstring's bounds."""
    tdt, jdt, nf = DTYPES[dtype]
    x = np.random.default_rng(4).uniform(0.5, 1.5, (8, 256)).astype(nf)
    R = rc.KINDS[kind][1][0]
    got = rc.micro_chain(torch.as_tensor(x), kind, R).numpy()
    want = np.asarray(jax.jit(lambda v: _jax_micro(kind, R, v, nf))(jnp.asarray(x, jdt)))
    np.testing.assert_allclose(got, want, rtol=1e-5 if dtype == "f32" else 1e-12)
    assert not np.array_equal(got, x)


# -- row 5: a jnp transcription of experiments/mosaic_bisect.py:40-107 --
def _jax_case(case, x, dz):
    def shift(v, d, fill):
        if d > 0:
            pad = jnp.full((d,) + v.shape[1:], fill, v.dtype)
            return jnp.concatenate([pad, v[:-d]], axis=0)
        pad = jnp.full((-d,) + v.shape[1:], fill, v.dtype)
        return jnp.concatenate([v[-d:], pad], axis=0)

    def cummin(v, reverse=False):
        d = 1
        while d < v.shape[0]:
            v = jnp.minimum(v, shift(v, -d if reverse else d, jnp.inf))
            d *= 2
        return v

    if case == "elementwise":
        return x * 2.0 + 1.0
    if case == "stencil":
        up = jnp.concatenate([x[1:], x[-1:]], axis=0)
        dn = jnp.concatenate([x[:1], x[:-1]], axis=0)
        return up - 2.0 * x + dn
    if case == "cummin":
        return cummin(x)
    dzc = jnp.broadcast_to(dz[:, None], x.shape)
    a = (x - 1.0) * dzc
    s = m = a
    d = 1
    while d < x.shape[0]:
        sL, mL = shift(s, d, 0.0), shift(m, d, jnp.inf)
        m = jnp.minimum(mL, sL + m)
        s = sL + s
        d *= 2
    M = jnp.minimum(m, 0.0)
    sat_up = 1.0 + (M - shift(M, 1, 0.0)) / dzc
    ZM = jnp.cumsum(dzc[:, :1], axis=0) + M
    S2 = shift(ZM, 1, 0.0) - ZM[-1:]
    c2 = S2 - jnp.minimum(cummin(S2, reverse=True), 0.0)
    return jnp.maximum(sat_up - shift(c2, -1, 0.0) / dzc, 0.0)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case", mb.CASES)
def test_bisect_case_matches_jax(case, dtype):
    """Each case on the probe's input (seed 0, uniform in [-0.5, 1.8),
    dz geomspace(5, 0.05), Nz 30) cut to 1,024 columns: the wrapper on the
    CPU against the transcription; equal but the closure, held within the
    summation bound of the module docstring."""
    tdt, jdt, nf = DTYPES[dtype]
    x, dz = mb.inputs(tdt, "cpu")
    x = x[:, :1024].contiguous()
    got = mb.bisect_case(case, x, dz).numpy()
    want = np.asarray(jax.jit(lambda a, b: _jax_case(case, a, b))(
        jnp.asarray(x.numpy(), jdt), jnp.asarray(dz.numpy(), jdt)))
    if case != "closure":
        np.testing.assert_array_equal(got, want)
        return
    a = np.abs((x.numpy().astype(np.float64) - 1.0) * dz.numpy()[:, None]).sum(axis=0)
    eps = np.finfo(nf).eps
    bound = 2 * (mb.NZ - 1) * eps * (a + float(dz.sum())) / float(dz.min())
    assert np.all(np.abs(got - want) <= bound), np.max(np.abs(got - want) / bound)
    assert (got > 0).any() and (got == 0).any()


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("variant", mr.VARIANTS)
def test_repro_variant_matches_jax_kernel_body(variant, dtype):
    """Each variant's 4 iterations from T uniform in [-2, 3) (both branches
    of the Magnus exponential) and s in [0, 1), the wrapper on the CPU
    against JAX's own ``_kernel_factory(variant)`` body under
    ``jax.lax.fori_loop``: float64 at rtol 1e-12, float32 at rtol 1e-6."""
    tdt, jdt, nf = DTYPES[dtype]
    rng = np.random.default_rng(6)
    T = rng.uniform(-2.0, 3.0, (mr.NZ, mr.BLOCK)).astype(nf)
    s = rng.uniform(0.0, 1.0, mr.BLOCK).astype(nf)
    body = _jax_experiment("mosaic_min_repro")._kernel_factory(variant)
    jT, js = jax.jit(lambda a, b: jax.lax.fori_loop(
        0, mr.INNER, lambda _, c: tuple(body(*c)), (a, b)))(jnp.asarray(T, jdt),
                                                             jnp.asarray(s, jdt))
    pT, ps = mr.repro_variant(variant, torch.as_tensor(T), torch.as_tensor(s))
    rtol = 1e-6 if dtype == "f32" else 1e-12
    np.testing.assert_allclose(pT.numpy(), np.asarray(jT), rtol=rtol, atol=rtol)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=rtol)


def test_probe_entry_points_run_on_the_cpu_when_asked(capsys):
    """``run_case`` and ``run_variant`` with ``device="cpu"`` take the plain
    versions (no launch, no time) and print their JSON line; the wrappers
    refuse what the kernels do not take."""
    before = (mb.bisect_case.launches, mr.repro_variant.launches, rc.micro_chain.launches)
    res = mb.run_case("cummin", device="cpu")
    assert res["max_abs_err"] == 0.0 and "ms" not in res
    res = mr.run_variant("row_to_xy_stencil", device="cpu")
    assert res["max_abs_err"] == 0.0 and res["finite"]
    assert '"case": "cummin"' in capsys.readouterr().out
    assert (mb.bisect_case.launches, mr.repro_variant.launches,
            rc.micro_chain.launches) == before
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="kind"):
        rc.micro_chain(x, "sqrt", 4)
    with pytest.raises(TypeError, match="float32 or float64"):
        rc.micro_chain(x.half(), "fma", 4)
    with pytest.raises(ValueError, match="case"):
        mb.bisect_case("scan", x, torch.ones(4))
    with pytest.raises(ValueError, match=r"dz \(nz,\)"):
        mb.bisect_case("cummin", x, torch.ones(5))
    with pytest.raises(ValueError, match="variant"):
        mr.repro_variant("crash", x, torch.ones(8))
    with pytest.raises(ValueError, match="contiguous"):
        mr.repro_variant("xy_only", x.t().contiguous().t(), torch.ones(8))
