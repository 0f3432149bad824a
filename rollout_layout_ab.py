"""The soil rollout's and the land segment VJP's two layouts on one CUDA
card: ForwardEuler and Heun over heat + Richards (PERF.md's kernel rows 1
and 1'a) and ImplicitEuler with one and two Picard iterations, each
solver (rows 1'c and 1'j), one thread a column (``csrc/soil_column_rollout.cu``, the layout the wrappers launched
before the group kernel, built at its first launch from that source)
against a column on a group of lanes (``csrc/soil_column_group_rollout.cu``,
which ``soil_column_rollout``, ``soil_column_heun_rollout`` and
``soil_column_implicit_rollout`` launch).

    python3 rollout_layout_ab.py check
    python3 rollout_layout_ab.py time
    python3 rollout_layout_ab.py implicit_check
    python3 rollout_layout_ab.py implicit_time
    python3 rollout_layout_ab.py vjp_check
    python3 rollout_layout_ab.py vjp_time
    python3 rollout_layout_ab.py land_vjp_check
    python3 rollout_layout_ab.py land_vjp_time

``check`` builds both, prints each kernel's registers and spill stores
(ptxas), SASS instructions (``cuobjdump -sass``) and resident warps an SM,
holds both to the plain version (float64 at 1e-12 on 1,024 columns and the
goldens, float32 at full width by ``chip_smoke.F32_REL_TOL``; rows 1'c and
1'j: float64 on 1,024 columns at Nz 16 one step at a time along the plain
trajectory, ``chip_smoke.soil_teacher``, float32 at full width with its
float64 referee), counts the group kernel's sweep hand-offs on the
main-path operands, and times nothing. ``time`` times both in turns (one
thread, group, group, one thread; CUDA events, the median of each turn's
launches) at the main-path shapes: row 1 at 56,951 x 30 float32 over 144
steps (a table) and at 56,951 x 20 over a 48-step gradient segment, row 1'a
at 56,951 x 30 over 144 Heun steps (an hourly series), rows 1'c and 1'j at
56,951 x 30 over 144 ImplicitEuler steps of 900 s (a table), each solver;
then the group kernel at each group size G 4, 8, 16 and 32: ForwardEuler at
Nz 20 and 15, ImplicitEuler (one iteration, each solver) at Nz 30. Every
line is one JSON object; the first is the card's name and power limit.
``implicit_check`` and ``implicit_time`` run the ImplicitEuler parts alone.

``vjp_check`` and ``vjp_time`` do the same for the segment VJP of
ImplicitEuler over heat + Richards (rows 3'b and 3'h: one and two Picard
iterations, each solver), one thread a column (``csrc/
soil_column_segment_vjp.cu``, built at its first launch) against a column on
a group of lanes (``csrc/soil_column_group_segment_vjp.cu``, which
``soil_column_segment_vjp`` launches), at the gradient's shape: 56,951 x 30
float32, one 48-step segment of 900 s (``chip_smoke.GRAD_SCHEMES``'
``grad_implicit_*`` operands). ``vjp_check`` prints both layouts' registers,
spill stores, SASS instructions, resident warps an SM and G, holds the
group kernel to the plain version (torch autograd) at float64 on 1,024
columns at Nz 16 (rtol 1e-9, as ``chip_smoke.py``) and its stored carries
to the group rollout's bit for bit (``chip_smoke.vjp_recompute_check``),
and times nothing. ``vjp_time`` times both layouts in turns, then the group
kernel at each G (4, 8, 16, 32; the recompute check at each, against the
rollout at its own G) and at each launch bound (1 to 4 resident blocks of
256 threads an SM), each solver, one and two iterations.

``land_vjp_check`` and ``land_vjp_time`` do the same for the land segment
VJP of ImplicitEuler (rows 3'e and 3'i: one and two Picard iterations, each
solver) over ``land_consistent``'s composition with static inputs, one
thread a column (``csrc/land_column_segment_vjp.cu``, built at its first
launch) against a column on a group of lanes
(``csrc/land_column_group_segment_vjp.cu``, which
``land_column_segment_vjp`` launches), at the land gradient's shape:
56,951 x 20 float32, one 48-step segment of 600 s (``chip_smoke.py``'s
``land_grad_implicit_*`` operands). The recompute check holds the group
VJP's stored carries to the one-thread land rollout's: at float64 bit for
bit (1,024 columns), at float32 the largest gap is printed.
Run from the repository root.
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
#: rows 1'c and 1'j: (solver, Picard iterations)
IMPLICIT_ROWS = {f"{row}_{solver}": (solver, iters) for row, iters in (("1'c", 1), ("1'j", 2))
                 for solver in cs.SOLVERS}
IMPLICIT_F64_NZ, IMPLICIT_F64_CELLS, IMPLICIT_F64_STEPS = 16, 1024, 48
#: rows 3'b and 3'h, the segment VJP: (solver, Picard iterations)
VJP_ROWS = {f"{row}_{solver}": (solver, iters) for row, iters in (("3'b", 1), ("3'h", 2))
            for solver in cs.SOLVERS}
VJP_F64_NZ, VJP_F64_CELLS = 16, 1024
#: the group VJP's launch bounds measured: resident blocks of 256 threads an SM
MIN_BLOCKS = (1, 2, 3, 4)


def out(**fields):
    print(json.dumps(fields), flush=True)


def tags_of(fs, stepper, solver="pcr", iters=1):
    """The build tags of ``stepper`` over heat + Richards (ImplicitEuler:
    with ``solver`` and ``iters`` Picard iterations)."""
    return fs.kernel_tags(stepper, "richards", iters, plain_euler=(), solver=solver)


def thread_entry(cuda_build, fs, stepper, dtype, nz, solver="pcr", iters=1):
    """The one-thread-a-column entry point of ``stepper`` over heat +
    Richards, built at its first use."""
    return cuda_build.entry("soil_column_rollout", dtype, nz, fs._ARGTYPES,
                            tags=tags_of(fs, stepper, solver, iters))


def group_entry(cuda_build, fs, stepper, dtype, nz, group=None, solver="pcr", iters=1):
    """The group entry point; ``group``: a group size other than the depth's."""
    tags = tags_of(fs, stepper, solver, iters) + ((f"g{group}",) if group else ())
    return cuda_build.entry("soil_column_group_rollout", dtype, nz, fs._GROUP_ARGTYPES,
                            tags=tags)


def launcher(fs, fn, group, operands, dt, solver="pcr", iters=1):
    """``() -> (U, sat, S)``: one launch of ``fn`` on ``operands`` (the
    Heun row's top temperature is a series, the others' a table)."""
    carry, top, coords, params = operands
    steps = top.steps if isinstance(top, fs.SeriesBC) else top.shape[0]
    tail = (fs.SOLVER_CODES[solver], iters) + ((0,) if group else ())
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
    elif row == "implicit":
        sim = cs.implicit_sim(tp, "pcr", cells=cells, dtype=dtype, nz=nz)
        steps, dt = cs.COMPARE_STEPS, cs.IMPLICIT_DT
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


def kernel_stats(cuda_build, fs, source, entry, kind, solver="pcr"):
    """ptxas's registers and spill stores and the SASS instructions of the
    ``kind`` ("table" or "series") kernel of ``entry`` of ``source`` (a
    group ImplicitEuler entry: its kernel of ``solver``)."""
    key = kind + (f"_{solver}" if source == cs.GROUP_SOURCE and "_implicit_" in entry else "")
    ptxas = cs.ptxas_summary(cuda_build.ptxas_report(source)).get(entry, {}).get(key, "")
    regs = int(ptxas.split()[0]) if ptxas else None
    spills = int(ptxas.split(",")[1].split()[0]) if "," in ptxas else None
    sass = cs.sass_instructions(cuda_build, source, entry, kind == "series", solver)
    return {"ptxas": ptxas, "registers": regs, "spill_stores": spills, "sass": sass}


def implicit_stats(cuda_build, fs, solver, iters, dtype, nz):
    """Both layouts' build description of row 1'c or 1'j (``iters``)."""
    tags = tags_of(fs, "implicit", solver, iters)
    thread_entry(cuda_build, fs, "implicit", dtype, nz, solver, iters)
    group_entry(cuda_build, fs, "implicit", dtype, nz, solver=solver, iters=iters)
    t = kernel_stats(cuda_build, fs, "soil_column_rollout",
                     cuda_build._entry_name("soil_column_rollout", tags, dtype, nz), "table")
    g = kernel_stats(cuda_build, fs, cs.GROUP_SOURCE,
                     cuda_build._entry_name(cs.GROUP_SOURCE, tags, dtype, nz), "table", solver)
    g["resident_warps"], g["group"] = fs.group_occupancy("implicit", dtype, nz, False,
                                                         solver=solver, picard_iters=iters)
    t["resident_warps"] = thread_warps(t["registers"]) if t["registers"] else None
    return t, g


def implicit_check(tp, fs, cuda_build, card):
    """Rows 1'c and 1'j, each solver: both layouts' builds, float64 on
    1,024 columns at Nz 16 and float32 at full width against the plain
    version one step at a time along its trajectory (chip_smoke.soil_teacher,
    float32 with the float64 referee), the group kernel's hand-offs on the
    full-width operands."""
    for name, (solver, iters) in IMPLICIT_ROWS.items():
        for dtype, nz in ((torch.float32, cs.BENCH_NZ), (torch.float64, IMPLICIT_F64_NZ)):
            t, g = implicit_stats(cuda_build, fs, solver, iters, dtype, nz)
            out(check="build", row=name, solver=solver, picard_iters=iters, kernel="table",
                dtype=str(dtype), nz=nz, one_thread=t, group=g, card=card)
        errs = {}
        for dtype, cells, nz, steps in (
                (torch.float64, IMPLICIT_F64_CELLS, IMPLICIT_F64_NZ, IMPLICIT_F64_STEPS),
                (torch.float32, cs.BENCH_CELLS, cs.BENCH_NZ, cs.COMPARE_STEPS)):
            ops, dt = operands(tp, fs, "implicit", dtype, cells=cells, nz=nz)
            (carry, table, coords, params) = ops
            params64 = fs.ColumnParams.of(cs.implicit_sim(tp, solver, cells=1,
                                                          dtype=torch.float64, nz=nz).model,
                                          torch.float64)
            coords64 = tuple(c.double() for c in coords)
            pkw = dict(stepper="implicit", solver=solver, picard_iters=iters)

            def plain(U, sat, S, top):
                return fs.soil_column_rollout_plain(U, sat, S, top, *coords, params, dt, **pkw)

            def referee(U, sat, S, top):
                return fs.soil_column_rollout_plain(U.double(), sat.double(), S.double(),
                                                    top.double(), *coords64, params64, dt,
                                                    **pkw)
            for layout, fn, group in (
                    ("one_thread", thread_entry(cuda_build, fs, "implicit", dtype, nz, solver,
                                                iters), False),
                    ("group", group_entry(cuda_build, fs, "implicit", dtype, nz, solver=solver,
                                          iters=iters), True)):
                def kernel(U, sat, S, top, fn=fn, group=group):
                    return launcher(fs, fn, group, ((U, sat, S), top, coords, params), dt,
                                    solver, iters)()
                errs[f"{layout}_{str(dtype)[6:]}"] = cs.soil_teacher(
                    kernel, plain, carry, lambda i: table[i:i + 1], steps,
                    referee=None if dtype == torch.float64 else referee)
        _, handoffs = fs.soil_column_group_handoffs("implicit", *ops[0], ops[1], *ops[2],
                                                    ops[3], dt, solver=solver,
                                                    picard_iters=iters)
        out(check="teacher", row=name, solver=solver, picard_iters=iters,
            f64=[IMPLICIT_F64_CELLS, IMPLICIT_F64_NZ, IMPLICIT_F64_STEPS],
            f32=[cs.BENCH_CELLS, cs.BENCH_NZ, cs.COMPARE_STEPS],
            max_abs_err_over_magnitude_flips={k: [v[0], v[1], v[2]] for k, v in errs.items()},
            handoffs_up_down=handoffs,
            handoffs_per_column_step=[h / (cs.BENCH_CELLS * cs.COMPARE_STEPS)
                                      for h in handoffs], card=card)
        del ops


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
    implicit_check(tp, fs, cuda_build, card)


def turns(fs, fns, ops, dt, solver="pcr", iters=1):
    """``{name: [ms, ...]}``: each of ``fns`` (``{name: (fn, group)}``) timed
    in the turns a, b, b, a (every name in order, then in reverse), each
    turn the times of TURN_REPS launches after a warm-up."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        fn, group = fns[n]
        times[n] += cs.cuda_ms_each(launcher(fs, fn, group, ops, dt, solver, iters), TURN_REPS)
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
    implicit_timing(tp, fs, cuda_build, card)


def implicit_timing(tp, fs, cuda_build, card):
    """Rows 1'c and 1'j, each solver, both layouts in turns at 56,951 x 30
    float32, 144 steps of 900 s; then ImplicitEuler (one iteration) at each
    group size G, each solver, against the plain version at full width."""
    ops, dt = operands(tp, fs, "implicit", cells=cs.BENCH_CELLS, nz=cs.BENCH_NZ)
    f32 = torch.float32
    for name, (solver, iters) in IMPLICIT_ROWS.items():
        fns = {"one_thread": (thread_entry(cuda_build, fs, "implicit", f32, cs.BENCH_NZ, solver,
                                           iters), False),
               "group": (group_entry(cuda_build, fs, "implicit", f32, cs.BENCH_NZ,
                                     solver=solver, iters=iters), True)}
        t = turns(fs, fns, ops, dt, solver, iters)
        _, g = implicit_stats(cuda_build, fs, solver, iters, f32, cs.BENCH_NZ)
        out(time=name, solver=solver, picard_iters=iters, cells=cs.BENCH_CELLS,
            nz=cs.BENCH_NZ, dt=dt, steps=ops[1].shape[0], ms=t,
            median_ms={n: float(np.median(v)) for n, v in t.items()}, group=g, card=card)
    for solver in cs.SOLVERS:
        fns = {f"g{g}": (group_entry(cuda_build, fs, "implicit", f32, cs.BENCH_NZ, g,
                                     solver=solver), True) for g in GROUP_SIZES}
        ref = fs.soil_column_rollout_plain(*ops[0], ops[1], *ops[2], ops[3], dt,
                                           stepper="implicit", solver=solver)
        errs = {n: cs.check_close(f"implicit {solver} {n}",
                                  launcher(fs, fn, True, ops, dt, solver)(), ref,
                                  cs.F32_REL_TOL) for n, (fn, _) in fns.items()}
        stats = {f"g{g}": kernel_stats(
            cuda_build, fs, cs.GROUP_SOURCE,
            f"soil_column_group_rollout_implicit_{solver}_richards_g{g}_f32_nz{cs.BENCH_NZ}",
            "table", solver) for g in GROUP_SIZES}
        t = turns(fs, fns, ops, dt, solver)
        out(time="implicit_group_size", solver=solver, nz=cs.BENCH_NZ, cells=cs.BENCH_CELLS,
            steps=ops[1].shape[0],
            default_group=fs.group_occupancy("implicit", f32, cs.BENCH_NZ, False,
                                             solver=solver)[1],
            max_abs_err=errs, kernels=stats, ms=t,
            median_ms={n: float(np.median(v)) for n, v in t.items()}, card=card)
        del ref


def vjp_scheme(solver, iters):
    """The ``chip_smoke.GRAD_SCHEMES`` configuration of row 3'b or 3'h."""
    return (f"grad_implicit_n145_{solver}" if iters == 1
            else f"grad_implicit_picard{iters}_{solver}")


def vjp_operands(tp, fs, solver, iters, dtype=torch.float32, cells=cs.GRAD_CELLS,
                 nz=cs.BENCH_NZ):
    """Carry, one segment's table, coordinates, parameters and seeded output
    cotangents of row 3'b or 3'h, and its dt."""
    name = vjp_scheme(solver, iters)
    sim = cs.scheme_sim(tp, name, cells, nz, dtype)
    carry, table, coords, params, cts, _ = cs.scheme_operands(fs, name, sim, seed=11)
    return (carry, table, coords, params, cts), cs.GRAD_SCHEMES[name]["dt"]


def vjp_key(fv, layout, solver, iters, extra=()):
    """``(source, tags)`` of the segment-VJP entry of ``layout``
    (``"one_thread"`` or ``"group"``, with ``extra`` tags: another G or
    launch bound)."""
    tags = fv.vjp_tags("implicit", "richards", solver, iters) + tuple(extra)
    return ("soil_column_segment_vjp" if layout == "one_thread" else fv._GROUP_NAME), tags


def prebuild(cuda_build, argtypes, keys, dtype=torch.float32, nz=cs.BENCH_NZ):
    """Build the entries ``keys`` (``(source, tags)``, typed ``argtypes``) at
    once, one thread (and so one nvcc slot) each; raises the first build's
    error."""
    import threading

    errors = []

    def one(source, tags):
        try:
            cuda_build.entry(source, dtype, nz, argtypes, tags=tags)
        except Exception as e:  # noqa: BLE001 -- raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=k) for k in keys]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def vjp_stats(fs, cuda_build, fv, source, tags, solver, dtype=torch.float32, nz=cs.BENCH_NZ):
    """ptxas's registers and spill stores, the SASS instructions, resident
    warps an SM and G of the segment-VJP kernel of ``solver`` in the entry of
    ``source`` and ``tags``."""
    import pathlib
    import re

    entry = cuda_build._entry_name(source, tags, dtype, nz)
    one_thread = source != fv._GROUP_NAME
    ptxas = cs.ptxas_summary(cuda_build.ptxas_report(source)).get(entry, {}).get(
        "vjp" if one_thread else f"vjp_{solver}", "")
    regs = int(ptxas.split()[0]) if ptxas else None
    spills = int(ptxas.split(",")[1].split()[0]) if "," in ptxas else None
    if one_thread:
        stem = cuda_build._stem(source)
        lib = cuda_build._BUILD_DIR / f"{stem}-{entry}.so"
        if not lib.exists():
            lib = cuda_build._BUILD_DIR / f"{stem}.so"
        cuobjdump = pathlib.Path(cuda_build._nvcc()).with_name("cuobjdump")
        t = "f" if dtype == torch.float32 else "d"
        want = re.compile(rf"soil_column_segment_vjp_kernelI{t}Li{nz}ELi2ELi\d+E")
        sass = next((n for name, n in cs.sass_counts(str(cuobjdump), str(lib))
                     if want.search(name)), 0)
        warps, group = (thread_warps(regs) if regs else None), 1
    else:
        sass = cs.sass_instructions(cuda_build, source, entry, False, solver)
        warps, group = cs.vjp_group_of(fs, fv, cuda_build, tags, solver, dtype, nz)
    return {"entry": entry, "ptxas": ptxas, "registers": regs, "spill_stores": spills,
            "sass": sass, "resident_warps": warps, "group": group}


def vjp_check(tp, fs, cuda_build, card):
    """Rows 3'b and 3'h, each solver: both layouts' builds; the group kernel
    against the plain version at float64 on 1,024 columns at Nz 16 and its
    stored carries against the group rollout's at full width."""
    from terrarium_tpu_torch.ops import fused_vjp as fv

    prebuild(cuda_build, fv._ARGTYPES, [vjp_key(fv, layout, solver, iters)
                                        for layout in ("group", "one_thread")
                                        for solver, iters in VJP_ROWS.values()])
    for name, (solver, iters) in VJP_ROWS.items():
        stats = {layout: vjp_stats(fs, cuda_build, fv, *vjp_key(fv, layout, solver, iters),
                                   solver) for layout in ("one_thread", "group")}
        out(check="vjp_build", row=name, solver=solver, picard_iters=iters, **stats, card=card)
        ops, dt = vjp_operands(tp, fs, solver, iters, torch.float64, VJP_F64_CELLS,
                               VJP_F64_NZ)
        kw = dict(stepper="implicit", physics="richards", solver=solver, picard_iters=iters)
        got = fv.soil_column_segment_vjp(*ops[0], ops[1], *ops[2], ops[3], dt, *ops[4], **kw)
        want = fv.soil_column_segment_vjp_plain(*ops[0], ops[1], *ops[2], ops[3], dt, *ops[4],
                                                **kw)
        errs = {}
        for vname, a, b in zip(("U", "sat", "S", "K_sat", "sk_mineral"), got, want):
            scale = float(b.abs().max())
            errs[vname] = float((a - b).abs().max())
            if not bool(torch.isfinite(a).all()) or bool(
                    ((a - b).abs() > 1e-9 * b.abs() + 1e-12 * scale).any()):
                raise AssertionError(f"{name} group VJP vs plain {vname} (f64): {errs[vname]}")
        del ops, got, want
        ops, dt = vjp_operands(tp, fs, solver, iters)
        steps, parted = cs.vjp_recompute_check(fs, fv, cuda_build, ops, dt, solver, iters)
        if parted:
            raise AssertionError(f"{name}: {parted} columns' stored carries part")
        out(check="vjp_teacher", row=name, solver=solver, picard_iters=iters,
            f64=[VJP_F64_CELLS, VJP_F64_NZ, ops[1].shape[0]], f64_rtol=1e-9,
            f64_max_abs_err=errs, recompute_steps=steps, recompute_columns_parted=parted,
            card=card)
        del ops


def vjp_timing(tp, fs, cuda_build, card):
    """Rows 3'b and 3'h, each solver, both layouts in turns at 56,951 x 30
    float32, one 48-step segment of 900 s; then the group kernel (the Picard
    entry, which holds a kernel of each solver) at each G and at each launch
    bound, each solver, one and two iterations, in turns."""
    from terrarium_tpu_torch.ops import fused_vjp as fv

    variants = {**{f"g{g}": (f"g{g}",) for g in GROUP_SIZES},
                **{f"mb{b}": (f"mb{b}",) for b in MIN_BLOCKS}}
    prebuild(cuda_build, fv._ARGTYPES, [vjp_key(fv, layout, solver, iters)
                                        for layout in ("group", "one_thread")
                                        for solver, iters in VJP_ROWS.values()]
             + [vjp_key(fv, "group", "pcr", 2, extra) for extra in variants.values()])
    f32 = torch.float32
    for name, (solver, iters) in VJP_ROWS.items():
        ops, dt = vjp_operands(tp, fs, solver, iters)
        fns, stats = {}, {}
        for layout in ("one_thread", "group"):
            source, tags = vjp_key(fv, layout, solver, iters)
            fn = cuda_build.entry(source, f32, cs.BENCH_NZ, fv._ARGTYPES, tags=tags)
            stats[layout] = vjp_stats(fs, cuda_build, fv, source, tags, solver)
            fns[layout] = cs.vjp_launcher(fs, fv, fn, None if layout == "one_thread"
                                          else stats[layout]["group"], ops, dt, solver,
                                          iters)[0]
        t = vjp_turns(fns)
        out(time=name, solver=solver, picard_iters=iters, cells=cs.GRAD_CELLS, nz=cs.BENCH_NZ,
            dt=dt, steps=ops[1].shape[0], ms=t,
            median_ms={n: float(np.median(v)) for n, v in t.items()}, kernels=stats, card=card)
        del ops
    for solver in cs.SOLVERS:
        for iters in (1, 2):
            ops, dt = vjp_operands(tp, fs, solver, iters)
            fns, stats, parted = {}, {}, {}
            for vname, extra in variants.items():
                source, tags = vjp_key(fv, "group", "pcr", 2, extra)
                fn = cuda_build.entry(source, f32, cs.BENCH_NZ, fv._ARGTYPES, tags=tags)
                stats[vname] = vjp_stats(fs, cuda_build, fv, source, tags, solver)
                fns[vname] = cs.vjp_launcher(fs, fv, fn, stats[vname]["group"], ops, dt,
                                             solver, iters)[0]
                parted[vname] = cs.vjp_recompute_check(fs, fv, cuda_build, ops, dt, solver,
                                                       iters, tags=tags)[1]
            t = vjp_turns(fns)
            out(time="vjp_variants", solver=solver, picard_iters=iters, cells=cs.GRAD_CELLS,
                nz=cs.BENCH_NZ, dt=dt, steps=ops[1].shape[0],
                default_group=fv.vjp_group(f32, cs.BENCH_NZ, solver, iters)[1],
                recompute_columns_parted=parted, kernels=stats, ms=t,
                median_ms={n: float(np.median(v)) for n, v in t.items()}, card=card)
            del ops


#: rows 3'e and 3'i, the land ImplicitEuler segment VJP: (solver, Picard
#: iterations)
LAND_VJP_ROWS = {f"{row}_{solver}": (solver, iters) for row, iters in (("3'e", 1), ("3'i", 2))
                 for solver in cs.SOLVERS}
LAND_VJP_F64_CELLS = 1024


def land_vjp_operands(tp, solver, iters, dtype=torch.float32, cells=cs.LAND_CELLS):
    """Carry, static inputs, root fraction, coordinates, parameters and
    seeded output cotangents of row 3'e or 3'i (``chip_smoke.py``'s
    ``land_grad_implicit_<solver>`` or ``_picard2_<solver>`` operands, the
    pool's output cotangent 0 as there), and its dt."""
    from terrarium_tpu_torch.ops import land_step as ls
    from terrarium_tpu_torch.timesteppers.integrator import land_inputs

    name = (f"land_grad_implicit_{solver}" if iters == 1
            else f"land_grad_implicit_picard{iters}_{solver}")
    sim = cs.land_grad_sim(tp, cells, dtype, name)
    ops = cs.land_grad_operands(ls, land_inputs, sim, seed=11)
    ops[5]["surface_excess_water"] = torch.zeros_like(ops[5]["surface_excess_water"])
    return ops, cs.LAND_GRAD_SCHEMES[name][2]


def land_vjp_key(lv, params, layout, solver, iters, extra=()):
    """``(source, tags)`` of the land segment-VJP entry of ``layout``
    (``"one_thread"`` or ``"group"``, with ``extra`` tags: another G or
    launch bound) over the composition of ``params``."""
    tags = lv.check_scheme(params, "implicit", solver, iters) + params.tags + tuple(extra)
    return (lv._NAME if layout == "one_thread" else lv._GROUP_NAME), tags


def land_vjp_stats(fs, cuda_build, lv, source, tags, solver, dtype=torch.float32,
                   nz=cs.LAND_NZ):
    """ptxas's registers and spill stores, the SASS instructions, resident
    warps an SM and G of the land segment-VJP kernel of ``solver`` in the
    entry of ``source`` and ``tags``."""
    import ctypes
    import pathlib
    import re

    entry = cuda_build._entry_name(source, tags, dtype, nz)
    one_thread = source == lv._NAME
    ptxas = cs.ptxas_summary(cuda_build.ptxas_report(source)).get(entry, {}).get(
        "vjp" if one_thread else f"vjp_{solver}", "")
    regs = int(ptxas.split()[0]) if ptxas else None
    spills = int(ptxas.split(",")[1].split()[0]) if "," in ptxas else None
    if one_thread:
        stem = cuda_build._stem(source)
        lib = cuda_build._BUILD_DIR / f"{stem}-{entry}.so"
        if not lib.exists():
            lib = cuda_build._BUILD_DIR / f"{stem}.so"
        cuobjdump = pathlib.Path(cuda_build._nvcc()).with_name("cuobjdump")
        t = "f" if dtype == torch.float32 else "d"
        want = re.compile(rf"land_column_segment_vjp_kernelI{t}Li{nz}E")
        sass = next((n for name, n in cs.sass_counts(str(cuobjdump), str(lib))
                     if want.search(name)), 0)
        warps, group = (thread_warps(regs) if regs else None), 1
    else:
        sass = cs.sass_instructions(cuda_build, source, entry, False, solver)
        fn = cuda_build.entry(source, dtype, nz, [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                              tags=tags, suffix="_warps")
        g = ctypes.c_int(0)
        warps, group = fn(fs.SOLVER_CODES[solver], ctypes.byref(g)), g.value
    return {"entry": entry, "ptxas": ptxas, "registers": regs, "spill_stores": spills,
            "sass": sass, "resident_warps": warps, "group": group}


def land_vjp_check(tp, fs, cuda_build, card):
    """Rows 3'e and 3'i, each solver: both layouts' builds; the group kernel
    against the plain version at float64 on 1,024 columns (rtol 1e-9, as
    ``chip_smoke.py``), its stored carries against the one-thread land
    rollout's at float64 (bit for bit) and float32 (the largest gap), and
    times nothing."""
    from terrarium_tpu_torch.ops import land_step as ls
    from terrarium_tpu_torch.ops import land_vjp as lv

    ops, _ = land_vjp_operands(tp, "pcr", 1, cells=8)
    params = ops[4]
    prebuild(cuda_build, lv._argtypes(torch.float32),
             [land_vjp_key(lv, params, layout, solver, iters)
              for layout in ("group", "one_thread") for solver, iters in LAND_VJP_ROWS.values()],
             nz=cs.LAND_NZ)
    for name, (solver, iters) in LAND_VJP_ROWS.items():
        stats = {layout: land_vjp_stats(fs, cuda_build, lv,
                                        *land_vjp_key(lv, params, layout, solver, iters), solver)
                 for layout in ("one_thread", "group")}
        out(check="land_vjp_build", row=name, solver=solver, picard_iters=iters, **stats,
            card=card)
        ops, dt = land_vjp_operands(tp, solver, iters, torch.float64, LAND_VJP_F64_CELLS)
        kw = {"stepper": "implicit", "solver": solver, "picard_iters": iters}
        errs, rel, left_out = cs.land_vjp_compare(lv, ls, *ops[:5], dt, cs.GRAD_INNER, ops[5],
                                                  kw, 1e-9, LAND_VJP_F64_CELLS)
        steps, parted64, gap64 = cs.land_vjp_recompute_check(fs, lv, ls, cuda_build, ops, dt,
                                                             cs.GRAD_INNER, solver, iters)
        if parted64:
            raise AssertionError(f"{name}: {parted64} columns' f64 stored carries part")
        del ops
        ops, dt = land_vjp_operands(tp, solver, iters)
        _, parted32, gap32 = cs.land_vjp_recompute_check(fs, lv, ls, cuda_build, ops, dt,
                                                         cs.GRAD_INNER, solver, iters)
        out(check="land_vjp_teacher", row=name, solver=solver, picard_iters=iters,
            f64=[LAND_VJP_F64_CELLS, cs.LAND_NZ, cs.GRAD_INNER], f64_rtol=1e-9,
            f64_max_abs_err=errs, f64_max_err_over_magnitude=rel, f64_columns_left_out=left_out,
            recompute_steps=steps, recompute_f64_columns_parted=parted64,
            recompute_f64_max_gap=gap64, recompute_f32_columns_parted=parted32,
            recompute_f32_max_gap_over_magnitude=gap32, card=card)
        del ops


def land_vjp_timing(tp, fs, cuda_build, card):
    """Rows 3'e and 3'i, each solver, both layouts in turns at 56,951 x 20
    float32, one 48-step segment of 600 s; then the group kernel (the Picard
    entry, which holds a kernel of each solver) at each G and at each launch
    bound, each solver, one and two iterations, in turns, with the float32
    recompute check at each."""
    from terrarium_tpu_torch.ops import land_step as ls
    from terrarium_tpu_torch.ops import land_vjp as lv

    f32 = torch.float32
    variants = {**{f"g{g}": (f"g{g}",) for g in GROUP_SIZES},
                **{f"mb{b}": (f"mb{b}",) for b in MIN_BLOCKS}}
    params = land_vjp_operands(tp, "pcr", 1, cells=8)[0][4]
    prebuild(cuda_build, lv._argtypes(f32),
             [land_vjp_key(lv, params, layout, solver, iters)
              for layout in ("group", "one_thread") for solver, iters in LAND_VJP_ROWS.values()]
             + [land_vjp_key(lv, params, "group", "pcr", 2, extra)
                for extra in variants.values()], nz=cs.LAND_NZ)
    for name, (solver, iters) in LAND_VJP_ROWS.items():
        ops, dt = land_vjp_operands(tp, solver, iters)
        fns, stats = {}, {}
        for layout in ("one_thread", "group"):
            source, tags = land_vjp_key(lv, params, layout, solver, iters)
            fn = cuda_build.entry(source, f32, cs.LAND_NZ, lv._argtypes(f32), tags=tags)
            stats[layout] = land_vjp_stats(fs, cuda_build, lv, source, tags, solver)
            fns[layout] = cs.land_vjp_launcher(
                fs, lv, ls, fn, None if layout == "one_thread" else stats[layout]["group"], ops,
                dt, cs.GRAD_INNER, solver, iters)[0]
        t = vjp_turns(fns)
        out(time=name, solver=solver, picard_iters=iters, cells=cs.LAND_CELLS, nz=cs.LAND_NZ,
            dt=dt, steps=cs.GRAD_INNER, ms=t,
            median_ms={n: float(np.median(v)) for n, v in t.items()}, kernels=stats, card=card)
        del ops
    for solver in cs.SOLVERS:
        for iters in (1, 2):
            ops, dt = land_vjp_operands(tp, solver, iters)
            fns, stats, parted = {}, {}, {}
            for vname, extra in variants.items():
                source, tags = land_vjp_key(lv, params, "group", "pcr", 2, extra)
                fn = cuda_build.entry(source, f32, cs.LAND_NZ, lv._argtypes(f32), tags=tags)
                stats[vname] = land_vjp_stats(fs, cuda_build, lv, source, tags, solver)
                fns[vname] = cs.land_vjp_launcher(fs, lv, ls, fn, stats[vname]["group"], ops,
                                                  dt, cs.GRAD_INNER, solver, iters)[0]
                parted[vname] = cs.land_vjp_recompute_check(fs, lv, ls, cuda_build, ops, dt,
                                                            cs.GRAD_INNER, solver, iters,
                                                            tags=tags)[1]
            t = vjp_turns(fns)
            out(time="land_vjp_variants", solver=solver, picard_iters=iters,
                cells=cs.LAND_CELLS, nz=cs.LAND_NZ, dt=dt, steps=cs.GRAD_INNER,
                default_group=lv.vjp_group(f32, cs.LAND_NZ, land_vjp_key(
                    lv, params, "group", solver, iters)[1], solver)[1],
                recompute_f32_columns_parted=parted, kernels=stats, ms=t,
                median_ms={n: float(np.median(v)) for n, v in t.items()}, card=card)
            del ops


def vjp_turns(fns):
    """``{name: [ms, ...]}``: each launcher of ``fns`` timed in the turns a,
    b, ..., ..., b, a, each turn the times of TURN_REPS launches after a
    warm-up."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n] += cs.cuda_ms_each(fns[n], TURN_REPS)
    return times


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

    {"check": check, "time": timing, "implicit_check": implicit_check,
     "implicit_time": implicit_timing, "vjp_check": vjp_check,
     "vjp_time": vjp_timing, "land_vjp_check": land_vjp_check,
     "land_vjp_time": land_vjp_timing}[mode](tp, fs, cuda_build, card)


if __name__ == "__main__":
    main()
