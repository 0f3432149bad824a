"""The group segment-VJP kernel's column code (``soil::GroupColumn::
segment_vjp`` in ``csrc/soil_group_step.cuh``: ForwardEuler, Heun and
ImplicitEuler over heat + Richards, any Picard count, each step undone on
the column's group of lanes and recomputed by the group rollout's own
``step``, ``heun_step`` or ``picard_step``), compiled for the host by the
C++ compiler with each group's lanes emulated in lockstep
(``soil::HostLanes``, ``tests/soil_group_step_host.cpp`` built with
``-DSOIL_GROUP_VJP_HOST``), against

* the one-thread segment VJP that it replaces on the card
  (``soil::segment_vjp_column`` of ``soil::picard_step``): the input
  cotangents bit for bit (both builds contract no multiply-adds, and the
  group adjoint forms each value by the one-thread adjoint's operations in
  its order, each level gathering the faces' shares that the one-thread
  loop scatters), the two parameter cotangents, which the lanes sum apart,
  at float64 rtol 1e-12; at Nz 10, 16 and 30 at the kernel's group size and
  at every G at Nz 30, each solver, Picard counts 1-3, on
  `test_torch_soil_physics.py`'s random legal states and the sweeps'
  crossing columns of `test_torch_group_step_host.py` (spilled and clipped
  levels across the lanes' boundaries), 6 steps of 900 s;
* torch autograd through the plain rollout at float64, rtol 1e-12, on the
  columns whose forward the plain version holds at 1e-12 (as
  `test_torch_step_adjoint.py::test_host_picard_adjoint_matches_autograd`);
* JAX's Pallas segment VJP in interpret mode, through each package's
  ``make_fused_grad_rollout`` on a few columns, at
  `test_torch_grad_steppers.py`'s rtol 1e-8.

ForwardEuler and Heun (``step_adjoint`` and ``heun_step_adjoint`` on the
group) are held to ``soil::segment_vjp_column`` of the same stepper the same
way, bit for bit, at every G at Nz 30 and at the kernel's G
(``soil::vjp_group_lanes``) at Nz 10, 16 and 20, 6 steps (ForwardEuler at
dt 300 s, Heun at dt 60 s from a table of 7 rows); Heun also against JAX's
Pallas segment VJP at Nz 8.
"""
import ctypes
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import terrarium_tpu as tt
import terrarium_tpu_torch as tp
from terrarium_tpu.timesteppers.fused_grad import make_fused_grad_rollout as jax_fused_grad
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.ops import fused_vjp as fv
from terrarium_tpu_torch.processes.soil.hydrology import saturation_sweeps
from terrarium_tpu_torch.timesteppers import fused_grad
from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout

from test_torch_grad_steppers import INITS, K0, X0, _jax_model, _port_model
from test_torch_group_step_host import _case

HERE = pathlib.Path(__file__).parent
CSRC = HERE.parent / "terrarium_tpu_torch" / "csrc"
SOLVERS = {"thomas": 0, "pcr": 1}
#: the group sizes held at each depth: the kernel's (None) at Nz 10 and 16,
#: every size at Nz 30
GROUPS = [(10, None), (16, None), (30, 4), (30, 8), (30, 16), (30, 32)]
STEPS, DT = 6, 900.0
#: ForwardEuler and Heun: (stepper code, dt) and the group sizes held, the
#: kernel's (None) at Nz 10, 16 and 20, every size at Nz 30
EXPLICIT = {"euler": (0, 300.0), "heun": (1, 60.0)}
EXPLICIT_GROUPS = [(10, None), (16, None), (20, None), (30, 4), (30, 8), (30, 16), (30, 32)]


@pytest.fixture(scope="module")
def vlib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    so = tmp_path_factory.mktemp("soil_group_vjp_host") / "soil_group_vjp_host.so"
    subprocess.run([cxx, "-O1", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                    "-DSOIL_GROUP_VJP_HOST", f"-I{CSRC}", "-o", str(so),
                    str(HERE / "soil_group_step_host.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    ptr, ll, i32, f64 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
    head = [ptr] * 11 + [ll, ll] + [ptr] * 5
    lib.host_thread_vjp.argtypes = head + [i32] * 4 + [f64, ll]
    lib.host_group_vjp.argtypes = head + [i32] * 5 + [f64, ll]
    lib.host_thread_explicit_vjp.argtypes = head + [i32] * 3 + [f64, ll]
    lib.host_group_explicit_vjp.argtypes = head + [i32] * 4 + [f64, ll]
    lib.host_vjp_group_lanes.argtypes = [i32, i32, i32]
    lib.host_implicit_group_lanes.argtypes = [i32, i32]
    lib.host_group_picard.argtypes = ([ptr] * 4 + [ll, ll, i32] + [f64] * 3 + [ptr] * 5
                                      + [i32] * 5 + [f64, ll])
    return lib


def run_vjp(vlib, carry, top, coords, params, solver, iters, cts, g=None, steps=STEPS, dt=DT,
            stepper="implicit"):
    """The segment VJP of ``steps`` steps of ``stepper`` (``"implicit"``
    with ``solver`` and ``iters`` Picard iterations, ``"euler"`` or
    ``"heun"``) applied to the output cotangents ``cts``, one thread a
    column (``g`` None) or on groups of ``g`` lanes: the input cotangents
    ``(gU0, gsat0, gS0)`` and each column's parameter cotangents (2,
    cells)."""
    nz, cells = carry[0].shape
    outs = [torch.full_like(t, np.nan) for t in carry]
    gparams = torch.full((2, cells), np.nan, dtype=torch.float64)
    cp = fs._CParams.of(params)  # held until the call returns
    head = (*(t.data_ptr() for t in (*carry, *cts, *outs, gparams, top)), top.stride(0),
            top.stride(1) if top.dim() == 2 else 0, *(c.data_ptr() for c in coords),
            ctypes.addressof(cp), nz)
    if stepper != "implicit":
        code = EXPLICIT[stepper][0]
        rc = (vlib.host_thread_explicit_vjp(*head, code, steps, dt, cells) if g is None
              else vlib.host_group_explicit_vjp(*head, g, code, steps, dt, cells))
    elif g is None:
        rc = vlib.host_thread_vjp(*head, SOLVERS[solver], iters, steps, dt, cells)
    else:
        rc = vlib.host_group_vjp(*head, g, SOLVERS[solver], iters, steps, dt, cells)
    assert rc == 0
    return outs, gparams


def _cotangents(carry, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=tuple(t.shape))) for t in carry)


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("nz,group", GROUPS)
def test_group_vjp_equals_the_thread_vjp_bitwise(vlib, nz, group, solver, iters):
    """``GroupColumn::segment_vjp`` at the kernel's group size for ``nz``
    (``soil::implicit_group_lanes``) and, at Nz 30, at every G, against
    ``soil::segment_vjp_column`` of ``picard_step`` over 6 steps of 900 s on
    every column: the input cotangents equal bit for bit, each column's
    parameter cotangents (the group's tree sum of its lanes' running sums)
    within rtol 1e-12 of the one thread's running sum, with a floor of
    1e-12 of the largest."""
    g = vlib.host_implicit_group_lanes(nz, SOLVERS[solver]) if group is None else group
    carry, top, coords, params = _case(vlib, nz, "table", g)
    cts = _cotangents(carry, 10 * nz + g + iters + SOLVERS[solver])
    want, want_p = run_vjp(vlib, carry, top, coords, params, solver, iters, cts)
    got, got_p = run_vjp(vlib, carry, top, coords, params, solver, iters, cts, g)
    for name, a, b in zip(("U", "sat", "S"), got, want):
        assert bool(torch.isfinite(b).all()), name
        assert torch.equal(a, b), (name, (a != b).nonzero()[:5].tolist())
    assert bool(torch.isfinite(want_p).all())
    for a, b in zip(got_p, want_p):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))
    # the cotangents moved through the steps
    assert not torch.equal(want[1], cts[1]) and float(want_p[0].abs().max()) > 0.0


@pytest.mark.parametrize("stepper", list(EXPLICIT))
@pytest.mark.parametrize("nz,group", EXPLICIT_GROUPS)
def test_explicit_group_vjp_equals_the_thread_vjp_bitwise(vlib, nz, group, stepper):
    """``GroupColumn::segment_vjp`` of ForwardEuler and Heun (its
    ``step_adjoint`` and ``heun_step_adjoint``) at the kernel's group size
    for ``nz`` (``soil::vjp_group_lanes``) and, at Nz 30, at every G,
    against ``soil::segment_vjp_column`` of the same stepper over 6 steps
    (ForwardEuler at dt 300 s, Heun at dt 60 s, its stage reading a table of
    7 rows) on every column: the input cotangents equal bit for bit, each
    column's parameter cotangents within rtol 1e-12 of the one thread's with
    a floor of 1e-12 of the largest."""
    code, dt = EXPLICIT[stepper]
    g = vlib.host_vjp_group_lanes(nz, code, 1) if group is None else group
    carry, top, coords, params = _case(vlib, nz, "table", g)
    top = top[:STEPS + (stepper == "heun")].contiguous()
    cts = _cotangents(carry, 10 * nz + g + code)
    kw = dict(dt=dt, stepper=stepper)
    want, want_p = run_vjp(vlib, carry, top, coords, params, "pcr", 1, cts, **kw)
    got, got_p = run_vjp(vlib, carry, top, coords, params, "pcr", 1, cts, g, **kw)
    for name, a, b in zip(("U", "sat", "S"), got, want):
        assert bool(torch.isfinite(b).all()), name
        assert torch.equal(a, b), (name, (a != b).nonzero()[:5].tolist())
    assert bool(torch.isfinite(want_p).all())
    for a, b in zip(got_p, want_p):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))
    assert not torch.equal(want[1], cts[1]) and float(want_p[0].abs().max()) > 0.0


#: the autograd and JAX checks' dt and steps; at dt 300 the host build's
#: forward and the plain version's part at far fewer columns (a layer that
#: closes within an ulp of saturation, `_parted`) than at 900
AUTOGRAD_DT, AUTOGRAD_STEPS = 300.0, 4


def _parted(vlib, carry, top, coords, params, solver, iters, g):
    """The columns where the group step (host) and the plain version, each
    along its own trajectory one step at a time, part beyond 1e-12 of a
    field's magnitude, and whether each of them closes a layer at or within
    1e-9 of saturation on the plain trajectory before it parts (the rule of
    `test_torch_step_adjoint.py::_picard_parted`)."""
    nz, cells = carry[0].shape
    cp = fs._CParams.of(params)
    a = b = carry
    parted = torch.zeros(cells, dtype=torch.bool)
    near = torch.zeros(cells, dtype=torch.bool)
    for i in range(AUTOGRAD_STEPS):
        row = top[i:i + 1]
        near |= ~parted & (saturation_sweeps(b[1], coords[0][:, None])[0] >= 1.0 - 1e-9).any(0)
        a = tuple(t.clone() for t in a)
        assert vlib.host_group_picard(
            *(t.data_ptr() for t in (*a, row)), row.stride(0), row.stride(1), 0, 0.0, 0.0, 0.0,
            *(c.data_ptr() for c in coords), ctypes.addressof(cp), nz, g, SOLVERS[solver],
            iters, 1, AUTOGRAD_DT, cells) == 0
        b = fs.soil_column_rollout_plain(*b, row, *coords, params, AUTOGRAD_DT,
                                         stepper="implicit", solver=solver, picard_iters=iters)
        for u, v in zip(a, b):
            d = (u - v).abs()
            parted |= (d.amax(0) if d.dim() == 2 else d) > 1e-12 * float(v.abs().max())
    return parted, near


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_group_vjp_matches_autograd(vlib, solver, iters):
    """The group segment VJP at Nz 30 and the kernel's group size against
    torch autograd through the plain rollout (``soil_column_segment_vjp_plain``)
    over 4 steps of 300 s from the random legal states with a per-column top
    temperature: every cotangent within rtol 1e-12 with a floor of 1e-12 of
    its largest magnitude, on the columns whose forward the plain version
    holds (at most two let go, each closing a layer at saturation), the
    parameter cotangents summed over them."""
    nz = 30
    g = vlib.host_implicit_group_lanes(nz, SOLVERS[solver])
    carry, top, coords, params = _case(vlib, nz, "table", g)
    carry = tuple(t[..., :48].contiguous() for t in carry)  # the random states
    top = top[:AUTOGRAD_STEPS, :48].contiguous()
    parted, near = _parted(vlib, carry, top, coords, params, solver, iters, g)
    assert int(parted.sum()) <= 2 and bool(near[parted].all()), parted.nonzero().tolist()
    keep = ~parted
    cts = _cotangents(carry, 7 + iters + SOLVERS[solver])
    got, gp = run_vjp(vlib, carry, top, coords, params, solver, iters, cts, g,
                      steps=AUTOGRAD_STEPS, dt=AUTOGRAD_DT)

    def held(t):
        return t[..., keep].contiguous()

    want = fv.soil_column_segment_vjp_plain(
        *(held(t) for t in carry), held(top), *coords, params, AUTOGRAD_DT,
        *(held(t) for t in cts), stepper="implicit", solver=solver, picard_iters=iters)
    for name, a, b in zip(("U", "sat", "S", "K_sat", "sk_mineral"),
                          (*(held(t) for t in got), gp[0][keep].sum(), gp[1][keep].sum()), want):
        assert bool(torch.isfinite(a).all()), name
        scale = float(b.abs().max())
        assert scale > 0.0, name
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * scale, msg=name)


#: the JAX check: `test_torch_grad_steppers.py`'s configuration on a few
#: columns and steps (Nz 10, where the kernel's G is 4), PCR, JAX's default
#: solver, one Picard iteration (JAX's interpret-mode kernel takes some 15 s
#: to trace and compile a scheme; the Picard counts and Thomas are held to
#: autograd and to the one-thread VJP above, and that to JAX in
#: `test_torch_grad_steppers.py`)
JAX_CELLS, JAX_NZ, JAX_STEPS, JAX_INNER, JAX_DT = 8, 10, 4, 2, 1800.0


def _host_group_segment_vjp(vlib):
    """A stand-in for ``soil_column_segment_vjp`` on CPU tensors that runs
    the host build of the group segment VJP (ImplicitEuler, ForwardEuler or
    Heun over heat + Richards) at the kernel's group size."""
    def vjp(U, sat, S, top_T, dz, dz_faces, z_centers, z_faces, params, dt, gU, gsat, gS, *,
            stepper, physics, solver, picard_iters):
        assert physics == "richards"
        nz = U.shape[0]
        code = {"euler": 0, "heun": 1, "implicit": 2}[stepper]
        g = vlib.host_vjp_group_lanes(nz, code, SOLVERS[solver])
        carry = (U.contiguous(), sat.contiguous(), S.contiguous())
        outs, gp = run_vjp(vlib, carry, top_T.contiguous(), (dz, dz_faces, z_centers, z_faces),
                           params, solver, picard_iters, (gU, gsat, gS), g,
                           steps=top_T.shape[0] - (stepper == "heun"), dt=dt, stepper=stepper)
        return (*outs, gp[0].sum(), gp[1].sum())
    return vjp


#: the Heun check against JAX: Heun at `test_torch_grad_steppers.py`'s dt
#: 300 s on Nz 8 (the kernel's G 4: two levels a lane)
JAX_HEUN_NZ, JAX_HEUN_DT = 8, 300.0


def _stepper(pkg, solver, iters):
    """ImplicitEuler with ``solver`` and ``iters`` Picard iterations at
    JAX_DT, or (``solver`` ``"heun"``) Heun at JAX_HEUN_DT, of the package
    ``pkg`` (``tt`` or ``tp``); its dt and Nz."""
    if solver == "heun":
        return pkg.Heun(dt=JAX_HEUN_DT), JAX_HEUN_DT, JAX_HEUN_NZ
    return pkg.ImplicitEuler(dt=JAX_DT, solver=solver, picard_iters=iters), JAX_DT, JAX_NZ


def _jax_grads(solver, iters):
    """Loss and its gradients in (log K_sat, k_mineral, U0) through JAX's
    ``make_fused_grad_rollout(bwd="pallas", interpret=True)``."""
    ts, dt, nz = _stepper(tt, solver, iters)
    grid = tt.ColumnGrid.of(cells=JAX_CELLS, spacing=tt.ExponentialSpacing(N=nz),
                            nf=np.float64)
    sim = tt.initialize(_jax_model(grid, "richards", X0, K0), ts, initializers=INITS,
                        boundary_conditions=tt.PrescribedSurfaceTemperature(4.0))

    def loss(x, k, u0):
        roll = jax_fused_grad(lambda p: _jax_model(grid, "richards", *p), ts, sim.ctx, (),
                              steps=JAX_STEPS, dt=dt, inner_steps=JAX_INNER,
                              block_cells=JAX_CELLS, interpret=True, bwd="pallas")
        out = roll(sim.state.update(internal_energy=u0), (x, k))
        return jnp.mean(out.temperature) + jnp.mean(out.saturation_water_ice)

    v, g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
        X0, K0, sim.state.prognostic["internal_energy"])
    return float(v), *(np.asarray(a) for a in g)


def _port_grads(solver, iters):
    ts, dt, nz = _stepper(tp, solver, iters)
    grid = tp.ColumnGrid.of(cells=JAX_CELLS, spacing=tp.ExponentialSpacing(N=nz),
                            dtype=torch.float64, device="cpu")
    sim = tp.initialize(_port_model(grid, "richards", X0, K0), ts, initializers=INITS,
                        boundary_conditions=tp.PrescribedSurfaceTemperature(4.0))
    x = torch.tensor(X0, dtype=torch.float64, requires_grad=True)
    k = torch.tensor(K0, dtype=torch.float64, requires_grad=True)
    state = sim.state.copy()
    U0 = state.prognostic["internal_energy"].clone().requires_grad_()
    state.set(internal_energy=U0)
    roll = make_fused_grad_rollout(lambda p: _port_model(grid, "richards", *p), ts, sim.ctx,
                                   steps=JAX_STEPS, dt=dt, inner_steps=JAX_INNER)
    out = roll(state, (x, k))
    loss = out.temperature.mean() + out.saturation_water_ice.mean()
    gs = torch.autograd.grad(loss, (x, k, U0))
    return float(loss.detach()), *(g.numpy() for g in gs)


@pytest.mark.parametrize("solver,iters", [("pcr", 1), ("heun", 1)])
def test_group_vjp_matches_jax_pallas(vlib, monkeypatch, solver, iters):
    """The port's fused gradient with the host build of the group segment
    VJP in place of the kernel (8 columns, 4 steps in segments of 2, loss
    mean(T) + mean(sat); ImplicitEuler with PCR at Nz 10 and dt 1,800 s,
    Heun at Nz 8 and dt 300 s) against JAX's Pallas segment VJP in
    interpret mode: the value within rtol 1e-10, d/d log K_sat, d/d
    k_mineral and d/dU0 within rtol 1e-8 (d/dU0 with a floor of 1e-8 of its
    largest magnitude)."""
    monkeypatch.setattr(fused_grad, "soil_column_segment_vjp", _host_group_segment_vjp(vlib))
    v, gx, gk, gU = _port_grads(solver, iters)
    jv, jgx, jgk, jgU = _jax_grads(solver, iters)
    np.testing.assert_allclose(v, jv, rtol=1e-10)
    np.testing.assert_allclose(gx, jgx, rtol=1e-8)
    np.testing.assert_allclose(gk, jgk, rtol=1e-8)
    np.testing.assert_allclose(gU, jgU, rtol=1e-8, atol=1e-8 * np.max(np.abs(jgU)))
    assert abs(float(gx)) > 0.0 and abs(float(gk)) > 0.0
