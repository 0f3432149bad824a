"""Smoke test of the PyTorch port on one CUDA card.

Builds the soil column kernel from ``terrarium_tpu_torch/csrc``, checks it
against the goldens and against its plain PyTorch version, and drives the
main path (``initialize`` / ``Simulation.run``) at the bench size: 56,951
columns, Nz 30, float32, dt 60 s. Run from the repository root:

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
    ptxas's ``-v`` output (one entry per kernel instantiation)."""
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


def cuda_ms(fn, reps=1):
    """Mean device time of ``fn()`` in ms over ``reps`` calls (CUDA events)."""
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
    from terrarium_tpu_torch.ops import fused_step as fs
    from terrarium_tpu_torch.timesteppers.integrator import (advance, clock_times,
                                                             top_temperature_table)

    # ---- build
    t0 = time.perf_counter()
    fs.build_kernel()
    phase("build", seconds=time.perf_counter() - t0, ptxas=ptxas_summary(fs.ptxas_report()))

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

    print(json.dumps({"kernels": [{
        "name": "soil_column_rollout", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/soil_column_rollout.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:283",
        "launches": launches, "max_abs_err": max(cmp.values()),
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
