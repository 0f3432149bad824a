"""Smoke test of the PyTorch port on one CUDA card.

Builds the port's CUDA kernels from ``terrarium_tpu_torch/csrc`` (the soil
column rollout and its segment VJP, one ``nvcc`` each, in parallel) and
drives the port's two paths:

* the forward main path (``initialize`` / ``Simulation.run``) at the bench
  size, 56,951 columns, Nz 30, float32, dt 60 s, after checking the rollout
  kernel against the goldens and against its plain PyTorch version;
* the gradient path (``make_fused_grad_rollout``) of the configuration
  ``grad_n145_heat_richards`` (`bench_configs.py:311-411`): 56,951 columns,
  Nz 20, float32, dt 300 s, 288 steps in segments of 48, value and gradient
  of mean(T) + mean(sat) in log K_sat, after checking the segment-VJP kernel
  against its plain version (torch autograd) on 1,024 columns at float64
  and float32, at full width at float32 (the plain version in chunks of
  1,024 columns), and against the conservation of water.

Run from the repository root:

    python3 chip_smoke.py

Every phase prints one line; the line before the last is the kernel report
and the last line is ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero, and so does a machine without a CUDA device.
"""
from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "goldens" / "soil_heat_richards.npz"
BENCH_CELLS, BENCH_NZ, BENCH_DT = 56951, 30, 60.0
COMPARE_STEPS, BLOCK_STEPS = 144, 5760
# float32 kernel vs plain after COMPARE_STEPS steps, relative to each field's
# largest magnitude: the kernel contracts a*b + c into FMAs and takes cbrt
# where the plain version takes pow(x, 1/3), so the two differ by ulps per
# step; a freeze-plateau or saturation branch that flips on such a
# difference moves a cell by more, which this bound still allows for a few
# cells' worth of drift but not for a wrong stencil or sweep
F32_REL_TOL = 1e-4

# gradient path: grad_n145_heat_richards (bench_configs.py:311-411)
GRAD_CELLS, GRAD_NZ, GRAD_DT, GRAD_STEPS, GRAD_INNER = 56951, 20, 300.0, 288, 48
GRAD_COMPARE_CELLS, GRAD_REF_CELLS, FD_H = 1024, 64, 0.02
LOG_KSAT = float(np.log(1e-5))
# float32 segment-VJP kernel vs the plain version's autograd over one
# 48-step segment, relative to each cotangent's largest magnitude. The
# forward carries differ by ulps (FMA contraction, cbrt vs pow) and the
# adjoint is evaluated at them; near se -> 1 the pressure head goes as
# sqrt(1 - se), whose derivative magnifies a carry's ulp by up to about
# 1/sqrt(1 - se_hi) ~ 360 at float32's clip, and the parameter cotangents
# are float32 sums over the columns in another order (per thread, a block
# tree and a sum of block partials in the kernel; autograd's per chunk).
# That is far inside 1e-3; a wrong branch or a dropped term moves a
# cotangent by order 1.
F32_VJP_REL_TOL = 1e-3
# the float32 full-width gradient against the float64 plain-autograd one
GRAD_F32_REL_TOL = 1e-2
# Operations per level and step behind the bounds, counted from
# csrc/soil_step.cuh: each add, multiply, divide, compare, compare-select,
# root, power and log is one operation; a negation folds into its neighbour,
# and an expression the compiler can share (the same operands) counts once.
# The forward step (soil::step) evaluates both sides of its selects, as the
# rollout kernel does.
FWD_OPS = {
    "sweeps: up 7, down 7 (incl. the water table)": 14,
    "Level: freeze curve, heat capacity, temperature, conductivity, centre K": 54,
    "heat flux and energy update": 9,
    "Head: pressure head": 17,
    "Darcy flux, upwind-min face K, water update": 12,
}
# The segment VJP needs one forward step and one adjoint per level and step:
# soil::step_adjoint without its recompute (the sweeps, Level and Head that
# it evaluates again), taking the forward's intermediates as given. At a
# data-dependent branch the cheaper side is counted (frozen level, no head
# derivative, freeze plateau, no min tie), so the sum is at most what any
# run's data needs and the bound never flatters the kernel.
ADJ_OPS = {
    "Darcy flux and water update": 13,
    "face K from centre K (min_adjoint)": 3,
    "heat flux and energy update": 11,
    "pressure head (its four branch compares)": 4,
    "level_adjoint: conductivity, temperature, heat capacity, fractions": 34,
    "sweeps: down 2, up 2": 4,
}
FWD_OPS_PER_LEVEL_STEP = sum(FWD_OPS.values())
VJP_OPS_PER_LEVEL_STEP = FWD_OPS_PER_LEVEL_STEP + sum(ADJ_OPS.values())
H100_FP32_OPS, H100_HBM_BYTES = 67e12, 3.35e12  # published peaks, SXM, 700 W


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def soil(tp):
    props = tp.ConstantSoilHydraulics(swrc=tp.VanGenuchten(alpha=2.0, n=2.0),
                                      unsat_hydraulic_cond=tp.UnsatKVanGenuchten())
    return tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(
        vertical_flow=tp.RichardsEq(), hydraulic_properties=props))


def golden_sim(tp):
    """`tests/test_goldens.py:20-36`: 8 cells, Nz 20, float64."""
    grid = tp.ColumnGrid.of(cells=8, spacing=tp.ExponentialSpacing(N=20),
                            dtype=torch.float64, device="cuda")
    return tp.initialize(
        tp.SoilModel(grid=grid, soil=soil(tp)), tp.ForwardEuler(),
        initializers={
            "temperature": lambda x, z: 2.0 * np.sin(2 * np.pi * x) - 0.05 * z,
            "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.6 - 0.05 * z)},
        boundary_conditions=tp.PrescribedSurfaceTemperature(lambda t: -5.0 + 0.0 * t))


def bench_sim(tp):
    """`bench.py:43-64`: N145 land cells, Nz 30, float32, dt 60 s."""
    grid = tp.ColumnGrid.of(cells=BENCH_CELLS, spacing=tp.ExponentialSpacing(N=BENCH_NZ),
                            dtype=torch.float32, device="cuda")
    return tp.initialize(
        tp.SoilModel(grid=grid, soil=soil(tp)), tp.ForwardEuler(dt=BENCH_DT),
        initializers={
            "temperature": lambda x, z: 1.0 + 0.0 * z,
            "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.5 - 0.05 * z)},
        boundary_conditions=tp.PrescribedSurfaceTemperature(
            lambda t: 5.0 * torch.sin(2 * torch.pi * t / 86400.0)))


def ptxas_summary(report: str) -> dict:
    """``{"f32/NZ30": "253 registers, 0 bytes spill stores", ...}`` from
    ptxas's ``-v`` output (one entry per instantiation of a kernel templated
    on the type and NZ)."""
    out, key = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '.*kernelI([fd])Li(\d+)E", ln)
        if m:
            key = f"{'f32' if m.group(1) == 'f' else 'f64'}/NZ{m.group(2)}"
            out[key] = ""
        elif key and "spill stores" in ln and not out[key]:
            out[key] = ln.split(":")[-1].strip().split(",")[1].strip()
        elif key and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out[key] = f"{regs} registers, {out[key]}"
            key = None
    return out


def grad_model(tp, grid, log_ksat):
    """`bench_configs.py:318-327`: VanGenuchten(2, 2) Mualem conductivity,
    K_sat = exp(log_ksat)."""
    from terrarium_tpu_torch.convert import with_differentiable_params

    return tp.SoilModel(grid=grid, soil=with_differentiable_params(
        soil(tp), log_sat_hydraulic_cond=log_ksat))


def grad_sim(tp, cells, dtype):
    """`bench_configs.py:329-336`: T = -1 degC, sat = min(1, 0.6 - 0.04 z),
    top temperature 4 degC."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=GRAD_NZ),
                            dtype=dtype, device="cuda")
    return tp.initialize(
        grad_model(tp, grid, LOG_KSAT), tp.ForwardEuler(dt=GRAD_DT),
        initializers={"temperature": -1.0,
                      "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.6 - 0.04 * z)},
        boundary_conditions=tp.PrescribedSurfaceTemperature(4.0))


def grad_value(tp, sim, log_ksat, fused=True):
    """mean(T) + mean(sat) after GRAD_STEPS steps and its gradient in
    log K_sat: the fused rollout (kernels) or the module rollout (torch
    autograd through the plain modules, per-step checkpoints)."""
    from terrarium_tpu_torch.timesteppers.autodiff import make_rollout_fn
    from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout

    grid = sim.model.grid
    x = torch.tensor(log_ksat, dtype=torch.float64, device="cuda", requires_grad=True)
    if fused:
        roll = make_fused_grad_rollout(lambda p: grad_model(tp, grid, p), sim.timestepper,
                                       sim.ctx, steps=GRAD_STEPS, dt=GRAD_DT,
                                       inner_steps=GRAD_INNER)
        out = roll(sim.state, x)
    else:
        roll = make_rollout_fn(grad_model(tp, grid, x), sim.timestepper, sim.ctx,
                               steps=GRAD_STEPS, remat=True, lean=True)
        out = roll(sim.state, GRAD_DT)
    loss = out.temperature.mean() + out.saturation_water_ice.mean()
    (g,) = torch.autograd.grad(loss, x)
    return float(loss.detach()), float(g)


def loss_only(tp, sim, log_ksat):
    from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout

    grid = sim.model.grid
    roll = make_fused_grad_rollout(lambda p: grad_model(tp, grid, p), sim.timestepper,
                                   sim.ctx, steps=GRAD_STEPS, dt=GRAD_DT,
                                   inner_steps=GRAD_INNER)
    with torch.no_grad():
        out = roll(sim.state, torch.tensor(log_ksat, dtype=torch.float64, device="cuda"))
    return float(out.temperature.mean() + out.saturation_water_ice.mean())


def vjp_operands(tp, fs, sim, seed):
    """Carry, one segment's BC table, coordinates, parameters and seeded
    output cotangents of a gradient-configuration simulation."""
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    carry = tuple(sim.state.prognostic[n].contiguous() for n in sim.model.live_carry)
    table = torch.full((GRAD_INNER,), 4.0, dtype=g.dtype, device="cuda")
    rng = np.random.default_rng(seed)
    cts = tuple(torch.as_tensor(rng.normal(size=tuple(t.shape)), device="cuda").to(g.dtype)
                for t in carry)
    return carry, table, coords, fs.ColumnParams.of(sim.model, g.dtype), cts


def bound_ms(ops, nbytes):
    """The least time the card could take: the larger of ops over the FP32
    peak and bytes over the HBM rate, and which of the two it is."""
    t_ops, t_bytes = ops / H100_FP32_OPS * 1e3, nbytes / H100_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_ms(fn, reps=1, warmup=False):
    """Mean device time of ``fn()`` in ms over ``reps`` calls (CUDA events),
    after one untimed call if ``warmup`` (clocks up, scratch allocated)."""
    if warmup:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()} limit)"

    import terrarium_tpu_torch as tp
    from terrarium_tpu_torch.ops import cuda_build
    from terrarium_tpu_torch.ops import fused_step as fs
    from terrarium_tpu_torch.ops import fused_vjp as fv
    from terrarium_tpu_torch.timesteppers.integrator import (advance, clock_times,
                                                             top_temperature_table)

    # ---- build: one nvcc per source, in parallel
    t0 = time.perf_counter()
    names = ("soil_column_rollout", "soil_column_segment_vjp")
    cuda_build.build(*names)
    phase("build", seconds=time.perf_counter() - t0,
          ptxas={n: ptxas_summary(cuda_build.ptxas_report(n)) for n in names})

    # ---- golden configuration, through the kernel and through the plain version
    golden = np.load(GOLDEN)
    errs = {}
    for route in ("kernel", "plain"):
        sim = golden_sim(tp)
        if route == "kernel":
            sim.run(steps=120, dt=300.0)
        else:
            advance(sim.model, sim.state, sim.ctx, 120, 300.0,
                    rollout=fs.soil_column_rollout_plain)
            sim.compute_auxiliary()
        for f in golden.files:
            got = sim.state[f].cpu().numpy()
            np.testing.assert_allclose(got, golden[f], rtol=1e-12, atol=1e-12,
                                       err_msg=f"golden {route}: {f}")
            errs[f"{route}:{f}"] = float(np.max(np.abs(got - golden[f])))
    phase("golden", rtol=1e-12, atol=1e-12, max_abs_err=errs)

    # ---- bench configuration: kernel against plain on the card
    sim = bench_sim(tp)
    model = sim.model
    params = fs.ColumnParams.of(model, torch.float32)
    g = model.grid
    coords = tuple(torch.as_tensor(a, device="cuda").to(torch.float32) for a in (
        g.vertical.dz, g.vertical.dz_faces, g.vertical.z_centers, g.vertical.z_faces))
    carry = tuple(sim.state.prognostic[n].contiguous() for n in model.live_carry)
    times = clock_times(sim.state.clock.time, BENCH_DT, COMPARE_STEPS)[:-1]
    table = top_temperature_table(sim.bcs["temperature"]["top"].value, times, g)
    out_k = fs.soil_column_rollout(*carry, table, *coords, params, BENCH_DT)
    out_p = fs.soil_column_rollout_plain(*carry, table, *coords, params, BENCH_DT)
    torch.cuda.synchronize()
    cmp = {}
    for name, a, b in zip(model.live_carry, out_k, out_p):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"kernel produced non-finite {name}")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        cmp[name] = err
        if err > F32_REL_TOL * max(scale, 1e-30):
            raise AssertionError(f"kernel vs plain {name}: max abs err {err} "
                                 f"> {F32_REL_TOL} * {scale}")
    ms = cuda_ms(lambda: fs.soil_column_rollout(*carry, table, *coords, params, BENCH_DT),
                 reps=3)
    plain_ms = cuda_ms(lambda: fs.soil_column_rollout_plain(*carry, table, *coords,
                                                            params, BENCH_DT))
    cell_steps = BENCH_CELLS * COMPARE_STEPS
    phase("bench_compare", steps=COMPARE_STEPS, rel_tol=F32_REL_TOL, max_abs_err=cmp,
          kernel_ms=ms, plain_ms=plain_ms,
          kernel_cells_steps_per_s=cell_steps / (ms / 1e3),
          plain_cells_steps_per_s=cell_steps / (plain_ms / 1e3), card=card)

    # ---- main path: Simulation.run, one warm-up block then one timed block
    sim.run(steps=COMPARE_STEPS)
    torch.cuda.synchronize()
    fs.soil_column_rollout.launches = 0
    t0 = time.perf_counter()
    sim.run(steps=BLOCK_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fs.soil_column_rollout.launches
    if launches < 1:
        raise AssertionError("Simulation.run did not launch the soil column kernel")
    st = sim.state
    for name, shape in (("internal_energy", (BENCH_NZ, BENCH_CELLS)),
                        ("saturation_water_ice", (BENCH_NZ, BENCH_CELLS)),
                        ("temperature", (BENCH_NZ, BENCH_CELLS)),
                        ("pressure_head", (BENCH_NZ, BENCH_CELLS)),
                        ("hydraulic_conductivity", (BENCH_NZ + 1, BENCH_CELLS)),
                        ("surface_excess_water", (BENCH_CELLS,))):
        v = st[name]
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{name}: shape {tuple(v.shape)} or non-finite values")
    sat = st.saturation_water_ice
    if not (float(sat.min()) >= 0.0 and float(sat.max()) <= 1.0):
        raise AssertionError("saturation left [0, 1]")
    if sim.iteration != COMPARE_STEPS + BLOCK_STEPS:
        raise AssertionError(f"clock iteration {sim.iteration}")
    phase("main_path", steps=BLOCK_STEPS, seconds=run_s, launches=launches,
          cells_steps_per_s=BENCH_CELLS * BLOCK_STEPS / run_s, card=card,
          T_top_range=[float(st.temperature[-1].min()), float(st.temperature[-1].max())])
    del sim, st, carry, out_k, out_p

    # ---- segment-VJP kernel against its plain version, one 48-step segment
    # of the gradient configuration on GRAD_COMPARE_CELLS columns
    vjp_names = ("U", "sat", "S", "K_sat", "sk_mineral")
    vjp_err, vjp_rel = {}, {}
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, F32_VJP_REL_TOL)):
        gsim = grad_sim(tp, GRAD_COMPARE_CELLS, dtype)
        ops = vjp_operands(tp, fs, gsim, seed=7)
        out_k = fv.soil_column_segment_vjp(*ops[0], ops[1], *ops[2], ops[3], GRAD_DT, *ops[4])
        out_p = fv.soil_column_segment_vjp_plain(*ops[0], ops[1], *ops[2], ops[3], GRAD_DT,
                                                 *ops[4])
        torch.cuda.synchronize()
        key = "f64" if dtype == torch.float64 else "f32"
        for name, a, b in zip(vjp_names, out_k, out_p):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"segment VJP kernel produced non-finite {name} ({key})")
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            vjp_err[f"{key}:{name}"] = err
            vjp_rel[f"{key}:{name}"] = err / scale if scale > 0.0 else err
            if dtype == torch.float64:  # rtol 1e-9 with a floor of 1e-12 of the magnitude
                bad = bool(((a - b).abs() > 1e-9 * b.abs() + 1e-12 * scale).any())
            else:
                bad = err > tol * scale
            if bad:
                raise AssertionError(f"segment VJP kernel vs plain {name} ({key}): max abs err "
                                     f"{err}, largest magnitude {scale}")
        if dtype == torch.float64:
            # the water identity: cotangents (0, dz, 1) are those of
            # W = sum(sat*dz) + S, which every step conserves
            carry, table, coords, params, _ = ops
            dz = coords[0][:, None].expand_as(carry[1]).contiguous()
            _, gsat, gS, _, _ = fv.soil_column_segment_vjp(
                *carry, table, *coords, params, GRAD_DT, torch.zeros_like(carry[0]), dz,
                torch.ones_like(carry[2]))
            ident = max(float(((gsat - dz).abs() / dz).max()), float((gS - 1.0).abs().max()))
            if ident > 1e-12 or not bool((carry[1] == 1.0).any()):
                raise AssertionError(f"water identity through the VJP kernel: {ident}")
        else:
            vjp_cmp_ms = cuda_ms(lambda: fv.soil_column_segment_vjp(
                *ops[0], ops[1], *ops[2], ops[3], GRAD_DT, *ops[4]), reps=3, warmup=True)
            vjp_plain_ms = cuda_ms(lambda: fv.soil_column_segment_vjp_plain(
                *ops[0], ops[1], *ops[2], ops[3], GRAD_DT, *ops[4]))
        del gsim, ops, out_k, out_p
    phase("grad_compare", cells=GRAD_COMPARE_CELLS, steps=GRAD_INNER, f64_rtol=1e-9,
          f32_rel_tol=F32_VJP_REL_TOL, max_abs_err=vjp_err, max_err_over_magnitude=vjp_rel,
          water_identity_rel_err=ident,
          kernel_ms_f32=vjp_cmp_ms, plain_ms_f32=vjp_plain_ms, card=card)

    # ---- the segment-VJP kernel at full width (890 blocks, so the reduce
    # kernel's strided loop runs) against its plain version: the columns are
    # independent, so the plain VJP runs in chunks of GRAD_COMPARE_CELLS
    # columns and the parameter cotangents are the sums of the chunks'
    gsim = grad_sim(tp, GRAD_CELLS, torch.float32)
    ops = vjp_operands(tp, fs, gsim, seed=11)
    carry, table, coords, params, cts = ops
    out_k = fv.soil_column_segment_vjp(*carry, table, *coords, params, GRAD_DT, *cts)
    ref = [torch.empty_like(t) for t in carry] + [0.0, 0.0]
    for lo in range(0, GRAD_CELLS, GRAD_COMPARE_CELLS):
        cols = slice(lo, lo + GRAD_COMPARE_CELLS)
        part = fv.soil_column_segment_vjp_plain(
            *(t[..., cols].contiguous() for t in carry), table, *coords, params, GRAD_DT,
            *(t[..., cols].contiguous() for t in cts))
        for i in range(3):
            ref[i][..., cols] = part[i]
        ref[3] += float(part[3])
        ref[4] += float(part[4])
    full_err, full_rel = {}, {}
    for name, a, b in zip(vjp_names, out_k, ref):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"segment VJP kernel produced non-finite {name} (full width)")
        if isinstance(b, float):
            err, scale = abs(float(a) - b), abs(b)
        else:
            err, scale = float((a - b).abs().max()), float(b.abs().max())
        full_err[name], full_rel[name] = err, err / scale if scale > 0.0 else err
        if err > F32_VJP_REL_TOL * scale:
            raise AssertionError(f"segment VJP kernel vs plain {name} (full width): max abs "
                                 f"err {err}, largest magnitude {scale}")
    phase("grad_compare_full_width", cells=GRAD_CELLS, steps=GRAD_INNER,
          chunk_cells=GRAD_COMPARE_CELLS, f32_rel_tol=F32_VJP_REL_TOL, max_abs_err=full_err,
          max_err_over_magnitude=full_rel, card=card)
    del out_k, ref, part

    # ---- gradient main path: value and gradient in log K_sat, 288 steps in
    # 6 segments of 48, at full width; one warm-up, then the median of 5
    seg_ms = cuda_ms(lambda: fv.soil_column_segment_vjp(*ops[0], ops[1], *ops[2], ops[3],
                                                        GRAD_DT, *ops[4]), reps=3, warmup=True)
    fwd_seg_ms = cuda_ms(lambda: fs.soil_column_rollout(*ops[0], ops[1], *ops[2], ops[3],
                                                        GRAD_DT), reps=3, warmup=True)
    del ops
    grad_value(tp, gsim, LOG_KSAT)
    torch.cuda.synchronize()
    times, launches = [], {}
    for i in range(5):
        fs.soil_column_rollout.launches = fv.soil_column_segment_vjp.launches = 0
        t0 = time.perf_counter()
        value, grad = grad_value(tp, gsim, LOG_KSAT)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            launches = {"soil_column_rollout": fs.soil_column_rollout.launches,
                        "soil_column_segment_vjp": fv.soil_column_segment_vjp.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"the gradient path did not launch both kernels: {launches}")
    if not (np.isfinite(value) and np.isfinite(grad) and grad != 0.0):
        raise AssertionError(f"gradient path: value {value}, gradient {grad}")
    grad_s = float(np.median(times))
    del gsim
    # the columns are identical, so the full-width means equal those of a
    # narrow run: float64 references on GRAD_REF_CELLS columns
    ref_sim = grad_sim(tp, GRAD_REF_CELLS, torch.float64)
    _, g_ref = grad_value(tp, ref_sim, LOG_KSAT, fused=False)
    _, g64 = grad_value(tp, ref_sim, LOG_KSAT)
    g_fd = (loss_only(tp, ref_sim, LOG_KSAT + FD_H)
            - loss_only(tp, ref_sim, LOG_KSAT - FD_H)) / (2 * FD_H)
    rel_ref = abs(grad - g_ref) / abs(g_ref)
    rel_64 = abs(g64 - g_ref) / abs(g_ref)
    rel_fd = abs(g64 - g_fd) / abs(g_fd)
    if rel_ref > GRAD_F32_REL_TOL:
        raise AssertionError(f"f32 full-width gradient {grad} vs f64 plain {g_ref}: {rel_ref}")
    if rel_64 > 1e-9:
        raise AssertionError(f"f64 kernel gradient {g64} vs f64 plain {g_ref}: {rel_64}")
    if rel_fd > 5e-4:
        raise AssertionError(f"f64 kernel gradient {g64} vs central difference {g_fd}: {rel_fd}")
    phase("grad_main_path", cells=GRAD_CELLS, nz=GRAD_NZ, steps=GRAD_STEPS,
          inner_steps=GRAD_INNER, seconds_median=grad_s, seconds=times, launches=launches,
          cells_steps_per_s=GRAD_CELLS * GRAD_STEPS / grad_s, loss=value, dloss_dlogksat=grad,
          f64_plain_dloss_dlogksat=g_ref, rel_err_vs_f64_plain=rel_ref,
          f64_kernel_dloss_dlogksat=g64, f64_kernel_rel_err_vs_f64_plain=rel_64,
          central_difference=g_fd, rel_err_vs_fd=rel_fd,
          vjp_segment_ms=seg_ms, fwd_segment_ms=fwd_seg_ms, card=card)

    # bounds: the bytes each function must move (the rollout reads its carry
    # and BC table and writes its carry; the VJP reads the carry, the BC
    # table and the output cotangents and writes the input and parameter
    # cotangents), against the operations of its steps
    fwd_b = bound_ms(FWD_OPS_PER_LEVEL_STEP * BENCH_NZ * BENCH_CELLS * COMPARE_STEPS,
                     2 * (2 * BENCH_NZ + 1) * BENCH_CELLS * 4 + COMPARE_STEPS * 4)
    vjp_b = bound_ms(VJP_OPS_PER_LEVEL_STEP * GRAD_NZ * GRAD_CELLS * GRAD_INNER,
                     3 * (2 * GRAD_NZ + 1) * GRAD_CELLS * 4 + GRAD_INNER * 4 + 2 * 4)
    print(json.dumps({"kernels": [{
        "name": "soil_column_rollout", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/soil_column_rollout.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:283",
        "launches": launches["soil_column_rollout"], "max_abs_err": max(cmp.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": fwd_b[0], "bound_by": fwd_b[1],
        "library_ms": None,
        "shape": f"{BENCH_CELLS} x {BENCH_NZ} f32, {COMPARE_STEPS} steps"}, {
        "name": "soil_column_segment_vjp", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/soil_column_segment_vjp.cu",
        "replaces": "terrarium_tpu/ops/fused_vjp.py:68",
        "launches": launches["soil_column_segment_vjp"],
        "max_abs_err": max(full_err.values()),
        "ms": seg_ms, "plain_ms": vjp_plain_ms, "bound_ms": vjp_b[0], "bound_by": vjp_b[1],
        "library_ms": None,
        "shape": f"{GRAD_CELLS} x {GRAD_NZ} f32, {GRAD_INNER} steps; plain_ms at "
                 f"{GRAD_COMPARE_CELLS} columns"}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
