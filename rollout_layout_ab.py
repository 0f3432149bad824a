"""The soil rollout's two layouts on one CUDA card: ForwardEuler and Heun over
heat + Richards (PERF.md's kernel rows 1 and 1'a), one thread a column
(``csrc/soil_column_rollout.cu``, the layout the wrappers launched before
the group kernel, built at its first launch from that unchanged source)
against a column on a group of lanes (``csrc/soil_column_group_rollout.cu``,
which ``soil_column_rollout`` and ``soil_column_heun_rollout`` launch).

    python3 rollout_layout_ab.py check
    python3 rollout_layout_ab.py time

``check`` builds both, prints each kernel's registers and spill stores
(ptxas), SASS instructions (``cuobjdump -sass``) and resident warps an SM,
holds both to the plain version (float64 at 1e-12 on 1,024 columns and the
goldens, float32 at full width by ``chip_smoke.F32_REL_TOL``), counts the
group kernel's sweep hand-offs on the main-path operands, and times
nothing. ``time`` times both in turns (one thread, group, group, one
thread; CUDA events, the median of each turn's launches) at the main-path
shapes: row 1 at 56,951 x 30 float32 over 144 steps (a table) and at 56,951
x 20 over a 48-step gradient segment, row 1'a at 56,951 x 30 over 144 Heun
steps (an hourly series); then the group kernel at each group size G 4, 8,
16 and 32 at Nz 20 and 15. Every line is one JSON object; the first is the
card's name and power limit. Run from the repository root.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs

TURN_REPS = 5
GROUP_SIZES = (4, 8, 16, 32)


def out(**fields):
    print(json.dumps(fields), flush=True)


def thread_entry(cuda_build, fs, stepper, dtype, nz):
    """The one-thread-a-column entry point of ``stepper`` over heat +
    Richards, built at its first use."""
    return cuda_build.entry("soil_column_rollout", dtype, nz, fs._ARGTYPES,
                            tags=(stepper, "richards"))


def group_entry(cuda_build, fs, stepper, dtype, nz, group=None):
    """The group entry point; ``group``: a group size other than the depth's."""
    tags = (stepper, "richards") + ((f"g{group}",) if group else ())
    return cuda_build.entry("soil_column_group_rollout", dtype, nz, fs._GROUP_ARGTYPES,
                            tags=tags)


def launcher(fs, fn, group, operands, dt):
    """``() -> (U, sat, S)``: one launch of ``fn`` on ``operands`` (the
    Heun row's top temperature is a series, the others' a table)."""
    carry, top, coords, params = operands
    steps = top.steps if isinstance(top, fs.SeriesBC) else top.shape[0]
    tail = (0,) if group else (fs.SOLVER_CODES["pcr"], 1)
    return lambda: fs.launch_entry(fn, tail, False, *carry, top, coords, params, dt, steps)


def operands(tp, fs, row, dtype=torch.float32, cells=cs.BENCH_CELLS, nz=cs.BENCH_NZ):
    """The operands of a row at its main-path shape: ``"euler"`` the bench
    (a table, 144 steps), ``"segment"`` the gradient's forward segment
    (Nz 20, 48 steps, dt 300 s), ``"heun"`` the Heun + series
    configuration (144 steps)."""
    from terrarium_tpu_torch.timesteppers.integrator import clock_times, top_temperature_table

    if row == "heun":
        sim = cs.heun_sim(tp, cells)
        if dtype != torch.float32:
            raise ValueError("the Heun row is float32")
        return cs.series_operands(fs, sim, cs.COMPARE_STEPS), cs.BENCH_DT
    if row == "segment":
        sim, steps, dt = cs.grad_sim(tp, cells, dtype), cs.GRAD_INNER, cs.GRAD_DT
    else:
        sim = (cs.bench_sim(tp, cells, dtype) if nz == cs.BENCH_NZ
               else sized_bench_sim(tp, cells, nz, dtype))
        steps, dt = cs.COMPARE_STEPS, cs.BENCH_DT
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    carry = tuple(sim.state.prognostic[n].contiguous() for n in sim.model.live_carry)
    table = top_temperature_table(sim.bcs["temperature"]["top"].value,
                                  clock_times(sim.state.clock.time, dt, steps)[:-1], g)
    return (carry, table, coords, fs.ColumnParams.of(sim.model, g.dtype)), dt


def sized_bench_sim(tp, cells, nz, dtype):
    """`bench.py:43-64`'s model and state at another depth."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=dtype,
                            device="cuda")
    return tp.initialize(
        tp.SoilModel(grid=grid, soil=cs.soil(tp)), tp.ForwardEuler(dt=cs.BENCH_DT),
        initializers={"temperature": lambda x, z: 1.0 + 0.0 * z,
                      "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.5 - 0.05 * z)},
        boundary_conditions=tp.PrescribedSurfaceTemperature(
            lambda t: 5.0 * torch.sin(2 * torch.pi * t / 86400.0)))


def thread_warps(registers: int, threads: int = 64) -> int:
    """Resident warps an SM of a kernel of ``registers`` a thread in blocks
    of ``threads`` (65,536 registers an SM, allocated 256 a warp; at most 32
    blocks and 64 warps)."""
    per_warp = math.ceil(registers * 32 / 256) * 256
    warps_per_block = threads // 32
    blocks = min(32, (65536 // per_warp) // warps_per_block, 64 // warps_per_block)
    return blocks * warps_per_block


def kernel_stats(cuda_build, fs, source, entry, kind):
    """ptxas's registers and spill stores and the SASS instructions of the
    ``kind`` ("table" or "series") kernel of ``entry`` of ``source``."""
    ptxas = cs.ptxas_summary(cuda_build.ptxas_report(source)).get(entry, {}).get(kind, "")
    regs = int(ptxas.split()[0]) if ptxas else None
    spills = int(ptxas.split(",")[1].split()[0]) if "," in ptxas else None
    sass = cs.sass_instructions(cuda_build, source, entry, kind == "series")
    return {"ptxas": ptxas, "registers": regs, "spill_stores": spills, "sass": sass}


def check(tp, fs, cuda_build, card):
    """Build, describe and check both layouts; no timing."""
    for stepper, kind in (("euler", "table"), ("heun", "series")):
        for dtype, nz in ((torch.float32, 30), (torch.float64, 30), (torch.float32, 20)):
            thread_entry(cuda_build, fs, stepper, dtype, nz)
            group_entry(cuda_build, fs, stepper, dtype, nz)
            suffix = f"{stepper}_richards_{'f32' if dtype == torch.float32 else 'f64'}_nz{nz}"
            t = kernel_stats(cuda_build, fs, "soil_column_rollout",
                             f"soil_column_rollout_{suffix}", kind)
            g = kernel_stats(cuda_build, fs, "soil_column_group_rollout",
                             f"soil_column_group_rollout_{suffix}", kind)
            g["resident_warps"], g["group"] = fs.group_occupancy(stepper, dtype, nz,
                                                                 kind == "series")
            t["resident_warps"] = thread_warps(t["registers"]) if t["registers"] else None
            out(check="build", kernel=kind, stepper=stepper, dtype=str(dtype), nz=nz,
                one_thread=t, group=g, card=card)
    # float64 against the plain version: the bench model on 1,024 columns
    # (both kernels, 144 steps) and the goldens through Simulation.run
    for row in ("euler", "segment"):
        nz = cs.BENCH_NZ if row == "euler" else cs.GRAD_NZ
        ops, dt = operands(tp, fs, row, torch.float64, cells=1024, nz=nz)
        ref = fs.soil_column_rollout_plain(*ops[0], ops[1], *ops[2], ops[3], dt)
        errs = {}
        for name, fn, group in (("one_thread", thread_entry(cuda_build, fs, "euler",
                                                            torch.float64, nz), False),
                                ("group", group_entry(cuda_build, fs, "euler", torch.float64,
                                                      nz), True)):
            got = launcher(fs, fn, group, ops, dt)()
            errs[name] = cs.check_f64_close(f"{row} {name}", got, ref, 1e-12)
        out(check="f64_vs_plain", row=row, cells=1024, nz=nz, rtol=1e-12, max_abs_err=errs)
    for route in ("golden", "heun_forced"):
        sim = cs.golden_sim(tp) if route == "golden" else cs.heun_forced_sim(tp)
        gold = np.load(cs.GOLDEN if route == "golden" else cs.HEUN_GOLDEN)
        sim.run(steps=120 if route == "golden" else 96, dt=300.0)
        err = {}
        for f in gold.files:
            got = sim.state[f].cpu().numpy()
            np.testing.assert_allclose(got, gold[f], rtol=1e-12, atol=1e-12, err_msg=route)
            err[f] = float(np.max(np.abs(got - gold[f])))
        out(check="golden", route=route, rtol=1e-12, max_abs_err=err)
    # float32 at full width, both kernels, and the group kernel's hand-offs
    for row, stepper in (("euler", "euler"), ("segment", "euler"), ("heun", "heun")):
        nz = cs.GRAD_NZ if row == "segment" else cs.BENCH_NZ
        cells = cs.GRAD_CELLS if row == "segment" else cs.BENCH_CELLS
        ops, dt = operands(tp, fs, row, cells=cells, nz=nz)
        ref = fs.soil_column_rollout_plain(*ops[0], ops[1], *ops[2], ops[3], dt,
                                           stepper=stepper)
        errs = {}
        for name, fn, group in (
                ("one_thread", thread_entry(cuda_build, fs, stepper, torch.float32, nz), False),
                ("group", group_entry(cuda_build, fs, stepper, torch.float32, nz), True)):
            errs[name] = cs.check_close(f"{row} {name}", launcher(fs, fn, group, ops, dt)(),
                                        ref, cs.F32_REL_TOL)
        _, handoffs = fs.soil_column_group_handoffs(stepper, *ops[0], ops[1], *ops[2], ops[3],
                                                    dt)
        steps = ops[1].steps if isinstance(ops[1], fs.SeriesBC) else ops[1].shape[0]
        out(check="f32_vs_plain", row=row, cells=cells, nz=nz, rel_tol=cs.F32_REL_TOL,
            max_abs_err=errs, handoffs_up_down=handoffs,
            handoffs_per_column_step=[h / (cells * steps) for h in handoffs])
        del ops, ref


def turns(fs, fns, ops, dt):
    """``{name: [ms, ...]}``: each of ``fns`` (``{name: (fn, group)}``) timed
    in the turns a, b, b, a (every name in order, then in reverse), each
    turn the times of TURN_REPS launches after a warm-up."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        fn, group = fns[n]
        times[n] += cs.cuda_ms_each(launcher(fs, fn, group, ops, dt), TURN_REPS)
    return times


def timing(tp, fs, cuda_build, card):
    for row, stepper in (("euler", "euler"), ("segment", "euler"), ("heun", "heun")):
        nz = cs.GRAD_NZ if row == "segment" else cs.BENCH_NZ
        cells = cs.GRAD_CELLS if row == "segment" else cs.BENCH_CELLS
        ops, dt = operands(tp, fs, row, cells=cells, nz=nz)
        fns = {"one_thread": (thread_entry(cuda_build, fs, stepper, torch.float32, nz), False),
               "group": (group_entry(cuda_build, fs, stepper, torch.float32, nz), True)}
        t = turns(fs, fns, ops, dt)
        kind = "series" if row == "heun" else "table"
        suffix = f"{stepper}_richards_f32_nz{nz}"
        stats = {"one_thread": kernel_stats(cuda_build, fs, "soil_column_rollout",
                                            f"soil_column_rollout_{suffix}", kind),
                 "group": kernel_stats(cuda_build, fs, "soil_column_group_rollout",
                                       f"soil_column_group_rollout_{suffix}", kind)}
        out(time=row, cells=cells, nz=nz, steps=ops[1].steps if row == "heun"
            else ops[1].shape[0], ms=t, median_ms={n: float(np.median(v)) for n, v in t.items()},
            kernels=stats, card=card)
        del ops
    # the group size at Nz 20 (the gradient's segments) and 15, ForwardEuler
    for nz, row in ((20, "segment"), (15, "euler")):
        ops, dt = operands(tp, fs, row, cells=cs.BENCH_CELLS, nz=nz)
        fns = {f"g{g}": (group_entry(cuda_build, fs, "euler", torch.float32, nz, g), True)
               for g in GROUP_SIZES}
        ref = fs.soil_column_rollout_plain(*ops[0], ops[1], *ops[2], ops[3], dt)
        errs = {n: cs.check_close(f"nz {nz} {n}", launcher(fs, fn, True, ops, dt)(), ref,
                                  cs.F32_REL_TOL) for n, (fn, _) in fns.items()}
        stats = {f"g{g}": kernel_stats(cuda_build, fs, "soil_column_group_rollout",
                                       f"soil_column_group_rollout_euler_richards_g{g}_f32_nz{nz}",
                                       "table") for g in GROUP_SIZES}
        t = turns(fs, fns, ops, dt)
        out(time="group_size", nz=nz, cells=cs.BENCH_CELLS, steps=ops[1].shape[0],
            default_group=fs.group_occupancy("euler", torch.float32, nz, False)[1],
            max_abs_err=errs, kernels=stats, ms=t,
            median_ms={n: float(np.median(v)) for n, v in t.items()}, card=card)
        del ops, ref


def main():
    if not torch.cuda.is_available():
        raise SystemExit("rollout_layout_ab: no CUDA device")
    mode = sys.argv[1] if len(sys.argv) > 1 else "check"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()} limit)"
    import terrarium_tpu_torch as tp
    from terrarium_tpu_torch.ops import cuda_build
    from terrarium_tpu_torch.ops import fused_step as fs

    {"check": check, "time": timing}[mode](tp, fs, cuda_build, card)


if __name__ == "__main__":
    main()
