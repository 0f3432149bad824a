"""Smoke test of the PyTorch port on one CUDA card.

Builds the port's CUDA kernels from ``terrarium_tpu_torch/csrc`` (the soil
column rollouts, ForwardEuler and Heun, heat + Richards and heat only,
ImplicitEuler with Thomas or PCR solves, and the segment VJP; one ``nvcc``
per instantiation, all in parallel) and drives the port's paths, each with
the kernel launch counts set to 0 just before it and read just after:

* the forward main path (``initialize`` / ``Simulation.run``) at the bench
  size, 56,951 columns, Nz 30, float32, dt 60 s, after checking the rollout
  kernel against the goldens and against its plain PyTorch version;
* the Heun path with a forcing series, ``heun_n145_heat_richards_forcing``
  (`bench_configs.py:414-449`): 56,951 columns, Nz 30, float32, Heun at dt
  60 s, an hourly ``(744, cells)`` series interpolated in the kernel, one
  2,880-step block, after the ``heun_forced`` golden (float64, through the
  kernel, with the water identity) and the Heun kernel against its plain
  version at full width;
* the heat-only default model with forcing, ``global_heat_n72_forcing``
  (`bench_configs.py:202-225`) on 14,024 synthetic columns, Nz 30, float32,
  ForwardEuler at dt 300 s, one 5,760-step block, after the heat-only
  kernel against its plain version (float64 on 1,024 columns, float32 at
  full width);
* the ImplicitEuler path, ``column_implicit_tridiag``
  (`bench_configs.py:141-199`): 56,951 columns, Nz 30, float32,
  ImplicitEuler at dt 900 s, the bench initial state and top temperature,
  one 1,920-step block with each solver (PCR, the JAX default, and Thomas),
  after the ``implicit_freeze`` golden (float64, Nz 16, through the kernel
  with either solver, with the water identity) and the implicit kernel
  against its plain version at full width;
* the LandModel path (``initialize`` / ``Simulation.run`` through the land
  column kernel): the ``land_model`` golden (float64, Nz 15, bare ground
  over heat only, through the kernel), the kernel against its plain version
  (the process modules) one step at a time along the plain version's
  trajectory (float64 on 1,024 columns and float32 at full width, 144
  steps), then ``land_coupled_n145`` (`bench_configs.py:228-267`) at
  full width, 56,951 columns, Nz 20, float32, dt 600 s, two hourly (744,
  cells) series made on the card, in two compositions: ``land_consistent``
  (`examples/land_global.py` with ``DirectSurfaceRunoff.consistent()``, the
  production one) and the bench's own parity composition, each one timed
  1,440-step block, the latter with its non-finite share;
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

``python3 chip_smoke.py --euler-digest [--package-root DIR]`` instead prints
the SHA-256 of the ForwardEuler heat + Richards kernel's outputs on the
golden, bench and gradient configurations and of the Heun kernel's on
``heun_forced`` and the Heun + series configuration, and the bench
``main_path`` rate, for the package in ``DIR`` (default: this checkout).
Run it on two checkouts in one call to compare their kernels bit for bit.
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
HEUN_GOLDEN = ROOT / "tests" / "goldens" / "heun_forced.npz"
IMPLICIT_GOLDEN = ROOT / "tests" / "goldens" / "implicit_freeze.npz"
BENCH_CELLS, BENCH_NZ, BENCH_DT = 56951, 30, 60.0
COMPARE_STEPS, BLOCK_STEPS = 144, 5760
# heun_n145_heat_richards_forcing (bench_configs.py:414-449) and
# global_heat_n72_forcing (bench_configs.py:202-225; 14,024 cells, as
# BENCH_CONFIGS_r05.jsonl records, at synthetic latitudes); both series
# are hourly over 31 days
HEUN_BLOCK_STEPS, HEAT_CELLS, HEAT_DT, HEAT_BLOCK_STEPS = 2880, 14024, 300.0, 5760
HEAT_F64_CELLS, SERIES_ROWS, SERIES_DTS = 1024, 744, 3600.0
# column_implicit_tridiag (bench_configs.py:141-199): 20 simulated days a block
IMPLICIT_DT, IMPLICIT_BLOCK_STEPS, SOLVERS = 900.0, 1920, ("pcr", "thomas")
# the water W = sum(sat * dz) + S of a column after COMPARE_STEPS float32
# implicit steps, relative: each step's solve and update round the column's
# sum of dz * du at float32 (about 6e-8 of W), so 144 steps may drift up to
# about 1e-5 if every rounding went one way; a dropped flux term or a wrong
# boundary row moves W by orders more
IMPLICIT_F32_WATER_TOL = 1e-5
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
# Heun (soil::heun_step): two closure_rhs per step, each FWD_OPS less the
# Euler update's multiply and add for U and sat in the first (the tendencies
# are kept) and with the corrector x + (0.5 * (f_n + f*)) * dt, four
# operations, in place of them in the second; the stage y = x + f * dt, two
# operations, for U and sat
HEUN_OPS_PER_LEVEL_STEP = 2 * FWD_OPS_PER_LEVEL_STEP + 2 * (-2 + 2 + 2)
# heat only (NoFlow): Level's energy closure, heat capacity and
# conductivity without the centre K (37: L_theta 2, liquid fraction 8,
# water/ice/air 6, C 7, temperature 6, conductivity 8), and the heat flux
# and energy update (9)
HEAT_OPS_PER_LEVEL_STEP = 37 + 9
# a series read (soil::series_value), per column and clock time: sub, div,
# max, min, floor, sub, 1 - w, two products, the sum; and the clock's add
SERIES_OPS_PER_READ = 11
# ImplicitEuler (soil::implicit_step), per level and step: closure_rhs with
# its tendencies kept (FWD_OPS less the Euler update's multiply and add, for
# U and sat); dT/dU (the and, the reciprocal, the select: the plateau
# compares are Level's); d(Psi)/d(sat) (soil::water_chain: clip 2, se^-2 2,
# minus one, (core)^-1/2 2, se^-3 2 (se * se is se^-2's), two products, the
# quotient, clamp 2, select, times por: 16; its se and saturated compare
# are Head's); the updates U += du and sat += du. The face kappa is
# closure_rhs's. IMPLICIT_OPS_PER_FACE counts soil::diffusion_rows by
# interior face f (the boundary faces take no row terms, but the Dirichlet
# top's, counted per column): dzf[f] dz[f] and dzf[f] dz[f - 1], once for
# both systems, 2; per system the products s K[f] D[f - 1] and s K[f] D[f]
# (each shared by two entries), their four quotients (a[f] and b[f]'s term
# over the first spacing, c[f - 1] and b[f - 1]'s over the second) and the
# two adds into b, 8; s K[f] for the Richards rows, 1 (the heat rows' scale
# is 1, which the compiler drops). Per column: the Dirichlet top row (2 K,
# times D, dzf dz, the quotient, the add: 5) and the pool's S + min(0, S)
# dt (3); the solves by implicit_solver_ops.
IMPLICIT_OPS = {
    "closure_rhs, tendencies kept": FWD_OPS_PER_LEVEL_STEP - 4,
    "dT/dU": 3,
    "d(Psi)/d(sat)": 16,
    "U += du, sat += du": 2,
}
IMPLICIT_OPS_PER_LEVEL_STEP = sum(IMPLICIT_OPS.values())
IMPLICIT_OPS_PER_FACE = 2 + 8 + 8 + 1
IMPLICIT_OPS_PER_COLUMN = 5 + 3


def implicit_solver_ops(solver, nz):
    """Operations of one tridiagonal solve of a column (soil::thomas,
    soil::pcr) that the rows need: a[0] and c[nz - 1] are 0. Thomas, a row
    above row 0: the denominator (multiply, subtract) and d' (multiply,
    subtract, divide), c' (divide) but in the top row, whose c is 0, and
    the back substitution (multiply, subtract) but in the top row, where
    x = d'; row 0: c' and d', a divide each. PCR, a round of stride s: a row
    with a row s below takes alpha (divide) and its two terms in b and d
    (multiply, add each), 5, and its new a (multiply) where that is not 0,
    in a row with a row 2 s below and not in the last round; the same with a
    row s above; then x = d / b."""
    if solver == "thomas":
        return 8 * nz - 7
    rounds = []
    s = 1
    while s < nz:
        rounds.append(s)
        s *= 2
    new_ac = sum(2 * max(0, nz - 2 * s) for s in rounds[:-1])
    return 10 * sum(nz - s for s in rounds) + new_ac + nz


def implicit_ops(solver, nz):
    """Operations of one implicit step of one column."""
    return (IMPLICIT_OPS_PER_LEVEL_STEP * nz + IMPLICIT_OPS_PER_FACE * (nz - 1)
            + IMPLICIT_OPS_PER_COLUMN + 2 * implicit_solver_ops(solver, nz))
H100_FP32_OPS, H100_HBM_BYTES = 67e12, 3.35e12  # published peaks, SXM, 700 W

# the LandModel: land_coupled_n145 (bench_configs.py:228-267) at synthetic
# latitudes from -60 to 80 degrees (the N145 mask is absent), 10 simulated
# days a block; the float64 comparison on 1,024 of those columns
LAND_CELLS, LAND_NZ, LAND_DT, LAND_BLOCK_STEPS, LAND_F64_CELLS = 56951, 20, 600.0, 1440, 1024
LAND_GOLDEN = ROOT / "tests" / "goldens" / "land_model.npz"
# Operations of one land step (land::step in csrc/land_step.cuh), counted by
# FWD_OPS's rules, for the vegetated Richards composition over Brooks-Corey
# and linear conductivity. Per level: the sweeps 14; the energy closure,
# heat capacity and conductivity 37 and the linear centre K 4 (times, two
# adds, divide); the PAW 7 (sub, div, clamp 2, multiply, add, the root
# fraction read); the heat flux and energy update 9; the Brooks-Corey head
# (se 4, clamp 2, the power x^-5 by 4 multiplies and a reciprocal, times,
# max, select, psi_h 2, the sum 3: 19) and the Darcy flux and update 12.
LAND_OPS_PER_LEVEL = {"sweeps": 14, "energy closure": 37, "linear K": 4, "PAW": 7,
                      "heat flux and update": 9, "Brooks-Corey head": 19,
                      "Darcy flux and update": 12}
# Per column, what every step runs: three Monin-Obukhov drags (at the
# start-of-step skin temperature and after each skin update), each 77
# without its five Businger-Dyer psi (Tbar and the difference 4; per
# iteration the clip 3 and u*, theta*, 1/L 13, four times; the last clip
# and the quotient 9) and 5 for each psi at least (the branch, clamp 3,
# product: the stable branch); a flux sweep without its drag 20 and a skin
# update 5, three and two; the vapour pressures (e_air 4, three e_sat with the vpd 8 each) 28; the
# vegetation without its branches (LAI 1, Medlyn 16, the photosynthesis's
# three compares, the respiration without the soil's f_temp 25) 45;
# interception 12, evapotranspiration 22, runoff 6, ground resistance 7;
# the top level's energy 7, the ET sink, infiltration and pool 14, the
# surface updates 21; two series reads 22 and the clock 1.
LAND_OPS_PER_COLUMN = {"Monin-Obukhov drags x3, psi aside": 3 * 77,
                       "Businger-Dyer psi x15, stable branch": 15 * 5,
                       "SEB sweeps and skin": 3 * 20 + 2 * 5, "vapour pressures": 28,
                       "vegetation, branches aside": 45,
                       "surface hydrology": 12 + 22 + 6 + 7,
                       "top energy, sink, infiltration, pool": 7 + 14,
                       "surface updates": 21, "series reads and clock": 23}
# The branches, counted where this run's data takes them (land_branches):
# the photosynthesis (pressures, the three q10 powers, PAR, c1, c2, Vc, the
# co-limitation: 51) where the shortwave is positive, the air above -3
# degC and the LAI positive, its temperature stress (two exps: 11) where
# the air is also inside (T_CO2_low, T_CO2_high); a psi's unstable branch
# (pow, two logs, atan and their arithmetic: 20, 15 more than the stable
# one) where its zeta < 0, that is where the air is colder than the skin,
# in the last four psi of the drags at the start-of-step and at the
# end-of-step skin temperature (the middle drag's skin temperature is not
# observed: counted stable).
# The soil's f_temp (5) where the ground is above 7 degC is not observed
# and counted nowhere, so the count is a lower bound.
LAND_OPS_BRANCH = {"photosynthesis": 51, "temperature stress": 11, "unstable psi": 15}


def land_ops(nz, branches):
    """Operations of one land step of one column, ``branches`` the mean
    number of times each of ``LAND_OPS_BRANCH`` runs a column and step."""
    return (sum(LAND_OPS_PER_LEVEL.values()) * nz + sum(LAND_OPS_PER_COLUMN.values())
            + sum(LAND_OPS_BRANCH[k] * n for k, n in branches.items()))


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


def implicit_freeze_sim(tp, solver):
    """`tests/test_goldens.py:92-113`: 6 cells, Nz 16, float64,
    ImplicitEuler at dt 3600 s, top temperature -8 degC."""
    grid = tp.ColumnGrid.of(cells=6, spacing=tp.ExponentialSpacing(N=16),
                            dtype=torch.float64, device="cuda")
    return tp.initialize(
        tp.SoilModel(grid=grid, soil=soil(tp)), tp.ImplicitEuler(dt=3600.0, solver=solver),
        initializers={
            "temperature": lambda x, z: 3.0 * np.cos(2 * np.pi * x) + 0.1 * z,
            "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.65 - 0.04 * z)},
        boundary_conditions=tp.PrescribedSurfaceTemperature(lambda t: -8.0 + 0.0 * t))


def implicit_sim(tp, solver):
    """`bench_configs.py:141-199` (column_implicit_tridiag): the bench model,
    initial state and top temperature, ImplicitEuler at dt 900 s."""
    grid = tp.ColumnGrid.of(cells=BENCH_CELLS, spacing=tp.ExponentialSpacing(N=BENCH_NZ),
                            dtype=torch.float32, device="cuda")
    return tp.initialize(
        tp.SoilModel(grid=grid, soil=soil(tp)), tp.ImplicitEuler(dt=IMPLICIT_DT, solver=solver),
        initializers={
            "temperature": lambda x, z: 1.0 + 0.0 * z,
            "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.5 - 0.05 * z)},
        boundary_conditions=tp.PrescribedSurfaceTemperature(
            lambda t: 5.0 * torch.sin(2 * torch.pi * t / 86400.0)))


def hourly_times():
    return np.arange(SERIES_ROWS, dtype=np.float64) * SERIES_DTS


def heun_forced_sim(tp):
    """`tests/test_goldens.py:67-89`: 4 cells, Nz 15, float64, Heun at dt
    300 s, a 2-hourly (13, 4) air temperature over one day."""
    grid = tp.ColumnGrid.of(cells=4, spacing=tp.ExponentialSpacing(N=15),
                            dtype=torch.float64, device="cuda")
    times = np.arange(0.0, 86401.0, 7200.0)
    series = (np.linspace(-4.0, 8.0, 4)[None, :]
              + 6.0 * np.sin(2 * np.pi * times / 86400.0)[:, None])
    return tp.initialize(
        tp.SoilModel(grid=grid, soil=soil(tp)), tp.Heun(),
        initializers={"temperature": 1.0,
                      "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.7 - 0.04 * z)},
        boundary_conditions=tp.PrescribedSurfaceTemperature("air_temperature"),
        input_sources=(tp.TimeSeriesInputSource(times=times,
                                                series={"air_temperature": series}),))


def heun_sim(tp, cells):
    """`bench_configs.py:414-449`: heat + Richards as bench, Heun at dt 60 s,
    the top temperature from an hourly (744, cells) float32 series
    5 sin(2 pi t / 86400), made on the card (169 MB at full width)."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=BENCH_NZ),
                            dtype=torch.float32, device="cuda")
    hours = torch.as_tensor(hourly_times(), device="cuda")
    ts = (5.0 * torch.sin(2 * np.pi * hours / 86400.0))[:, None].expand(SERIES_ROWS, cells)
    return tp.initialize(
        tp.SoilModel(grid=grid, soil=soil(tp)), tp.Heun(dt=BENCH_DT),
        initializers={
            "temperature": lambda x, z: 1.0 + 0.0 * z,
            "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.5 - 0.05 * z)},
        boundary_conditions=tp.PrescribedSurfaceTemperature("surface_temperature"),
        input_sources=(tp.TimeSeriesInputSource(
            times=hourly_times(),
            series={"surface_temperature": ts.to(torch.float32).contiguous()}),))


def heat_sim(tp, cells, dtype):
    """`bench_configs.py:202-225` on ``cells`` synthetic columns at
    latitudes evenly spaced from -60 to 80 degrees: the default (heat-only)
    SoilModel, ForwardEuler at dt 300 s, an hourly (744, cells) float32
    series T_mean + 8 sin(2 pi t / 86400), T_mean = 25 max(cos lat, 0.05) -
    5, also the initial temperature; saturation 0.8."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=BENCH_NZ),
                            dtype=dtype, device="cuda")
    lat = np.linspace(-60.0, 80.0, cells)
    T_mean = 25.0 * np.maximum(np.cos(np.deg2rad(lat)), 0.05) - 5.0
    hours = hourly_times()
    ts = (T_mean[None, :] + 8.0 * np.sin(2 * np.pi * hours[:, None] / 86400.0))
    return tp.initialize(
        tp.SoilModel(grid=grid), tp.ForwardEuler(dt=HEAT_DT),
        initializers={"temperature": lambda x, z: T_mean[None, :] + 0.0 * z,
                      "saturation_water_ice": 0.8},
        boundary_conditions=tp.PrescribedSurfaceTemperature("surface_temperature"),
        input_sources=(tp.TimeSeriesInputSource(
            times=hours, series={"surface_temperature": ts.astype(np.float32)}),))


def series_operands(fs, sim, steps):
    """Carry, the top temperature as the kernel reads it from the sim's
    series, coordinates and parameters."""
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    st = sim.state
    heat = "surface_excess_water" not in st.prognostic
    carry = (st.prognostic["internal_energy"], st.saturation_water_ice,
             None if heat else st.prognostic["surface_excess_water"])
    src = sim.input_sources[0]
    values = torch.as_tensor(src.series["surface_temperature"], device="cuda").to(g.dtype)
    bc = fs.SeriesBC(values.contiguous(), 0.0, SERIES_DTS, float(st.clock.time), steps)
    return carry, bc, coords, fs.ColumnParams.of(sim.model, g.dtype)


def series_rows_read(bc, dt, stages=1):
    """Rows of a series that a rollout reads: those around the clock times
    from the first to the last (stage) time."""
    t_last = bc.time + (bc.steps - 2 + stages) * dt
    lo = int(np.clip(np.floor((bc.time - bc.t0) / bc.dts), 0, bc.values.shape[0] - 1))
    hi = int(np.clip(np.ceil((t_last - bc.t0) / bc.dts), 0, bc.values.shape[0] - 1))
    return hi - lo + 1


def water(sim):
    """W = sum(sat * dz) + S of every column."""
    dz = sim.model.grid.dz[:, 0]
    st = sim.state
    return (st.saturation_water_ice * dz[:, None]).sum(0) + st.surface_excess_water


def check_close(name, out_k, out_p, rel_tol):
    """Max abs difference of each field and fail beyond ``rel_tol`` of its
    largest magnitude."""
    errs = {}
    for field, a, b in zip(("U", "sat", "S"), out_k, out_p):
        if a is None:
            continue
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: kernel produced non-finite {field}")
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        errs[field] = err
        if err > rel_tol * max(scale, 1e-30):
            raise AssertionError(f"{name} kernel vs plain {field}: max abs err {err} "
                                 f"> {rel_tol} * {scale}")
    return errs


def check_f64_close(name, out_k, out_p, rtol):
    """Each element within ``rtol`` of the plain version, with a floor of
    ``rtol`` times the field's largest magnitude."""
    errs = {}
    for field, a, b in zip(("U", "sat", "S"), out_k, out_p):
        if a is None:
            continue
        scale = float(b.abs().max())
        errs[field] = float((a - b).abs().max())
        if bool(((a - b).abs() > rtol * b.abs() + rtol * scale).any()):
            raise AssertionError(f"{name} kernel vs plain {field} (f64): max abs err "
                                 f"{errs[field]}, largest magnitude {scale}")
    return errs


def ptxas_summary(report: str) -> dict:
    """``{"<entry point>": {"table": "230 registers, 0 bytes spill stores",
    "series": ...}, ...}`` from the build's ptxas ``-v`` report, whose part
    of each instantiation is headed ``== <entry point>``; a rollout entry
    holds a table and a series kernel, the VJP's its kernel and the
    reduction, the land entry its one kernel."""
    out, entry, key = {}, None, None
    for ln in report.splitlines():
        if ln.startswith("== "):
            entry = ln[3:].strip()
            out[entry] = {}
            continue
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m and entry:
            name = m.group(1)
            flags = re.search(r"rollout_kernelI[fd]Li\d+ELi\d+ELi\d+ELb[01]ELb([01])E", name)
            if flags:
                key = "series" if flags.group(1) == "1" else "table"
            elif "land_column_rollout_kernel" in name:
                key = "land"
            else:
                key = "reduce" if "reduce" in name else "vjp"
            out[entry][key] = ""
        elif key and "spill stores" in ln and not out[entry][key]:
            out[entry][key] = ln.split(":")[-1].strip().split(",")[1].strip()
        elif key and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out[entry][key] = f"{regs} registers, {out[entry][key]}"
            key = None
    return out


def land_model(tp, grid, composition):
    """``"consistent"``: `examples/land_global.py`'s composition with
    ``DirectSurfaceRunoff.consistent()``; ``"parity"``: `bench_configs.py:
    228-267`'s (``VegetationCarbon()`` and the rest default); ``"bare"``:
    the default LandModel without vegetation (the golden's)."""
    if composition == "bare":
        return tp.LandModel(grid=grid)
    soil_ = tp.SoilEnergyWaterCarbon(
        strat=tp.HomogeneousStratigraphy(texture=tp.SoilTexture.preset("loam")),
        hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq()))
    if composition == "parity":
        return tp.LandModel(grid=grid, vegetation=tp.VegetationCarbon(), soil=soil_)
    return tp.LandModel(
        grid=grid, vegetation=tp.VegetationCarbon.consistent_units(), soil=soil_,
        atmosphere=tp.PrescribedAtmosphere(aerodynamics=tp.MoninObukhovAerodynamics()),
        surface_energy_balance=tp.SurfaceEnergyBalance.consistent(),
        surface_hydrology=tp.SurfaceHydrology(
            evapotranspiration=tp.PALADYNCanopyEvapotranspiration.consistent_units(
                ground_resistance=tp.SoilMoistureResistanceFactor()),
            surface_runoff=tp.DirectSurfaceRunoff.consistent()))


def land_golden_sim(tp):
    """`tests/test_goldens.py:40-49`: 4 cells, Nz 15, float64, bare ground."""
    grid = tp.ColumnGrid.of(cells=4, spacing=tp.ExponentialSpacing(N=15),
                            dtype=torch.float64, device="cuda")
    return tp.initialize(
        land_model(tp, grid, "bare"), tp.ForwardEuler(),
        initializers={"temperature": 5.0, "saturation_water_ice": 0.8},
        input_sources=(tp.FieldInputSource(fields={
            "surface_shortwave_down": 400.0, "air_temperature": 12.0, "rainfall": 1.0e-7}),))


def land_sim(tp, cells, dtype, composition, device="cuda"):
    """`bench_configs.py:228-267` on ``cells`` columns at latitudes evenly
    spaced from -60 to 80 degrees: loam, Richards flow, Nz 20, ForwardEuler at
    dt 600 s; hourly (744, cells) series of shortwave 900 cos(lat) max(0,
    sin(2 pi (t/day - 0.25))) and air temperature T_mean + 6 sin(2 pi (t/day
    - 0.3)), T_mean = 28 max(cos lat, 0.05) - 8, made on the card in float64
    and rounded once; static longwave 330, rain 4e-8, wind 3; initial
    temperature T_mean, saturation 0.6, carbon 2, vegetation fraction 0.5."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=LAND_NZ),
                            dtype=dtype, device=device)
    lat = np.linspace(-60.0, 80.0, cells)
    coslat = np.maximum(np.cos(np.deg2rad(lat)), 0.05)
    T_mean = 28.0 * coslat - 8.0
    day = torch.as_tensor(hourly_times() / 86400.0, device=device)[:, None]
    cos_t = torch.as_tensor(coslat, device=device)[None, :]
    sw = 900.0 * cos_t * torch.clamp(torch.sin(2 * np.pi * (day - 0.25)), min=0.0)
    ta = (28.0 * cos_t - 8.0) + 6.0 * torch.sin(2 * np.pi * (day - 0.3))
    forcing = tp.TimeSeriesInputSource(times=hourly_times(), series={
        "surface_shortwave_down": sw.to(dtype).contiguous(),
        "air_temperature": ta.to(dtype).contiguous()})
    del sw, ta
    static = tp.FieldInputSource(fields={"surface_longwave_down": 330.0, "rainfall": 4.0e-8,
                                         "windspeed": 3.0})
    return tp.initialize(
        land_model(tp, grid, composition), tp.ForwardEuler(dt=LAND_DT), (forcing, static),
        initializers={"temperature": lambda x, z: T_mean[None, :] + 0.0 * z,
                      "saturation_water_ice": 0.6, "carbon_vegetation": 2.0,
                      "vegetation_area_fraction": 0.5})


def land_operands(ls, land_inputs, sim):
    """Carry, inputs, root fraction, coordinates and parameters of a land
    simulation as ``advance`` hands them to the rollout."""
    model, st = sim.model, sim.state
    params = ls.LandParams.of(model, model.grid.dtype)
    carry = {n: st[n].contiguous() for n in ls.carry_names(params)}
    root = st.auxiliary["root_fraction"] if model.vegetation is not None else None
    coords = tuple(getattr(model.grid, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    return carry, land_inputs(model, st, sim.input_sources), root, coords, params


def land_input_at(fs, inp, t):
    """A land input's value at clock time ``t`` as the step reads it."""
    v = inp.values
    if inp.rows == 1:
        return v[0]
    def scalar(x):
        return torch.tensor(x, dtype=v.dtype, device=v.device)
    return fs.series_value(v, scalar(t), scalar(inp.t0), scalar(inp.dts))


def land_branches(fs, params, inputs, start, end, t):
    """The branches of ``LAND_OPS_BRANCH`` that one step from the carry
    ``start`` to ``end`` at clock time ``t`` takes, summed over the
    columns."""
    v = params.values
    Ta = land_input_at(fs, inputs["air_temperature"], t)
    SW = land_input_at(fs, inputs["surface_shortwave_down"], t)
    photo = (SW > 0) & (Ta > -3) & (start["carbon_vegetation"] > 0)
    stress = photo & (Ta > v["T_CO2_low"]) & (Ta < v["T_CO2_high"])
    unstable = 0
    if v["mo_drag"]:
        unstable = 4 * ((Ta < start["skin_temperature"]).sum() + (Ta < end["skin_temperature"]).sum())
    return {"photosynthesis": int(photo.sum()), "temperature stress": int(stress.sum()),
            "unstable psi": int(unstable)}


def outside_unit(carry):
    """The columns of a carry with a saturation layer outside [0, 1], which
    the next step's closure moves water out of or into."""
    sat = carry["saturation_water_ice"]
    return ((sat > 1.0) | (sat < 0.0)).any(0)


def land_teacher(ls, fs, carry, inputs, root, coords, params, t_start, steps, tolerance):
    """The land kernel against its plain version along the plain version's
    trajectory: at each of ``steps`` steps, one kernel step and one plain
    step from the same carry, the plain one carried on; no step's error can
    grow in the next, so the model's own instabilities (PERF.md §6) do not
    amplify rounding here. ``tolerance(name, plain, start, outside)`` is the
    per-cell tolerance of a field (float64), ``outside`` the columns of
    ``outside_unit`` at the step's start. Returns per field the largest
    absolute error, the largest over its magnitude, the largest in units of
    2^-23 of the value in the columns inside [0, 1], and the steps at which
    a kernel that left the field unchanged would fail; the (step, column,
    field) triples beyond the tolerance; the kernel's own chain of one-step
    launches; the mean number of runs of each branch a column and step; and
    per step the share of columns outside [0, 1]."""
    dtype = carry["internal_energy"].dtype
    t = (np.float32 if dtype == torch.float32 else np.float64)(t_start)
    cp, chain = dict(carry), dict(carry)
    worst_abs, worst, ulps, seen, beyond, outside_share = {}, {}, {}, {}, [], []
    branches = dict.fromkeys(LAND_OPS_BRANCH, 0)
    for i in range(steps):
        k1 = ls.land_column_rollout(cp, inputs, root, *coords, params, LAND_DT, float(t), 1)
        p1 = ls.land_column_rollout_plain(cp, inputs, root, *coords, params, LAND_DT,
                                          float(t), 1)
        chain = {**chain, **ls.land_column_rollout(chain, inputs, root, *coords, params,
                                                   LAND_DT, float(t), 1)}
        outside = outside_unit(cp)
        outside_share.append(float(outside.float().mean()))
        for k, n in land_branches(fs, params, inputs, cp, p1, float(t)).items():
            branches[k] += n
        for n in params.model.live_carry:
            a, b, c = k1[n].double(), p1[n].double(), cp[n].double()
            if not bool(torch.isfinite(a).all()):
                beyond.append((i + 1, -1, n))
            tol = tolerance(n, b, c, outside)
            err = (a - b).abs()
            worst_abs[n] = max(worst_abs.get(n, 0.0), float(err.max()))
            worst[n] = max(worst.get(n, 0.0), float(err.max()) / max(float(b.abs().max()), 1e-300))
            inside = (err / (2.0 ** -23 * b.abs()).clamp(min=1e-300))[..., ~outside]
            ulps[n] = max(ulps.get(n, 0.0), float(inside.max()) if inside.numel() else 0.0)
            seen[n] = seen.get(n, 0) + int(bool(((b - c).abs() > tol).any()))
            bad = err > tol
            if bad.dim() == 2:
                bad = bad.any(0)
            beyond += [(i + 1, int(col), n) for col in bad.nonzero().flatten()[:4].tolist()]
        cp = {**cp, **p1}
        t = t + t.dtype.type(LAND_DT)
    cells = carry["internal_energy"].shape[1]
    runs = {k: n / (cells * steps) for k, n in branches.items()}
    return worst_abs, worst, ulps, seen, beyond, chain, runs, outside_share


def land_f64_tolerance(name, plain, start, outside):
    """Float64 kernel against plain after one step: 1e-12 of the value, with
    a floor of 1e-12 of the field's largest magnitude (libdevice's
    transcendentals against torch's)."""
    return 1e-12 * plain.abs() + 1e-12 * float(plain.abs().max())


def land_f32_tolerance(name, plain, start, outside):
    """Float32 kernel against plain after one step, on each field's change
    in the step: F32_REL_TOL of the field's largest change, plus a few ulps
    of the value, where the two round a like change apart: 16 units of
    2^-23 of the value for the soil's energy and saturation, whose change is
    a difference of face fluxes over layers as thin as 5 cm (the two part
    by up to 3.5 such units in the top two layers), 2 for the surface's.
    The net assimilation is written afresh each step, not changed:
    F32_REL_TOL of its largest magnitude (its co-limitation s - sqrt(disc)
    cancels). The saturation and the pool of the columns ``outside`` (a
    start-of-step layer outside [0, 1]) go through an adjustment of the size
    of the state: there F32_REL_TOL of the field's largest magnitude as
    well."""
    value = plain.abs()
    if name == "net_assimilation":
        return torch.full_like(plain, F32_REL_TOL * float(value.max()))
    units = 16 if plain.dim() == 2 else 2
    tol = F32_REL_TOL * float((plain - start).abs().max()) + units * 2.0 ** -23 * value
    if name in ("saturation_water_ice", "surface_excess_water"):
        tol = torch.where(outside, torch.clamp(tol, min=F32_REL_TOL * float(value.max())), tol)
    return tol


def land_nonfinite(sim):
    """The share of columns with a non-finite value in any carried field,
    and in the canopy water alone."""
    st = sim.state
    bad = torch.zeros(sim.model.grid.cells, dtype=torch.bool, device="cuda")
    for n in sim.model.live_carry:
        v = st[n]
        bad |= ~torch.isfinite(v).all(0) if v.dim() == 2 else ~torch.isfinite(v)
    return (float(bad.float().mean()),
            float((~torch.isfinite(st.canopy_water)).float().mean()))


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
    from terrarium_tpu_torch.ops import land_step as ls
    from terrarium_tpu_torch.timesteppers.integrator import (advance, clock_times, land_inputs,
                                                             top_temperature_table)

    def reset_counts():
        for fn in (fs.soil_column_rollout, fs.soil_column_heun_rollout,
                   fs.soil_column_heat_rollout, fs.soil_column_implicit_rollout,
                   fv.soil_column_segment_vjp, ls.land_column_rollout):
            fn.launches = 0

    # ---- build: one nvcc per source, in parallel
    t0 = time.perf_counter()
    names = tuple(cuda_build.INSTANTIATIONS)
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
            advance(sim.model, sim.state, sim.ctx, 120, 300.0, plain=True)
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
    cmp = check_close("ForwardEuler", out_k, out_p, F32_REL_TOL)
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
    reset_counts()
    t0 = time.perf_counter()
    sim.run(steps=BLOCK_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = fs.soil_column_rollout.launches
    if launches < 1:
        raise AssertionError("Simulation.run did not launch the soil column kernel")
    main_launches = launches
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

    # ---- heun_forced golden, through the Heun kernel (Simulation.run, one
    # launch) and through the plain version, and the water identity
    hgold = np.load(HEUN_GOLDEN)
    errs, ident = {}, None
    for route in ("kernel", "plain"):
        sim = heun_forced_sim(tp)
        w0 = water(sim)
        if route == "kernel":
            reset_counts()
            sim.run(steps=96, dt=300.0)
            torch.cuda.synchronize()
            if fs.soil_column_heun_rollout.launches != 1:
                raise AssertionError(f"heun_forced: {fs.soil_column_heun_rollout.launches} "
                                     "Heun kernel launches, expected 1")
            ident = float(((water(sim) - w0).abs() / w0.abs()).max())
            if ident > 1e-12:
                raise AssertionError(f"heun_forced: water identity through the kernel {ident}")
        else:
            advance(sim.model, sim.state, sim.ctx, 96, 300.0, timestepper=sim.timestepper,
                    input_sources=sim.input_sources, plain=True)
            sim.compute_auxiliary()
        for f in hgold.files:
            got = sim.state[f].cpu().numpy()
            np.testing.assert_allclose(got, hgold[f], rtol=1e-12, atol=1e-12,
                                       err_msg=f"heun_forced {route}: {f}")
            errs[f"{route}:{f}"] = float(np.max(np.abs(got - hgold[f])))
    phase("golden_heun_forced", rtol=1e-12, atol=1e-12, max_abs_err=errs,
          water_identity_rel_err=ident)
    del sim

    # ---- Heun + series kernel against its plain version at full width
    sim = heun_sim(tp, BENCH_CELLS)
    carry, bc, coords, params = series_operands(fs, sim, COMPARE_STEPS)
    out_k = fs.soil_column_heun_rollout(*carry, bc, *coords, params, BENCH_DT)
    out_p = fs.soil_column_rollout_plain(*carry, bc, *coords, params, BENCH_DT, stepper="heun")
    torch.cuda.synchronize()
    heun_cmp = check_close("Heun", out_k, out_p, F32_REL_TOL)
    heun_ms = cuda_ms(lambda: fs.soil_column_heun_rollout(*carry, bc, *coords, params,
                                                          BENCH_DT), reps=3, warmup=True)
    heun_plain_ms = cuda_ms(lambda: fs.soil_column_rollout_plain(
        *carry, bc, *coords, params, BENCH_DT, stepper="heun"))
    heun_rows = series_rows_read(bc, BENCH_DT, stages=2)
    heun_b = bound_ms(HEUN_OPS_PER_LEVEL_STEP * BENCH_NZ * BENCH_CELLS * COMPARE_STEPS
                      + 2 * SERIES_OPS_PER_READ * BENCH_CELLS * COMPARE_STEPS,
                      2 * (2 * BENCH_NZ + 1) * BENCH_CELLS * 4 + heun_rows * BENCH_CELLS * 4)
    phase("heun_compare", steps=COMPARE_STEPS, rel_tol=F32_REL_TOL, max_abs_err=heun_cmp,
          kernel_ms=heun_ms, plain_ms=heun_plain_ms, bound_ms=heun_b[0], bound_by=heun_b[1],
          series_rows_read=heun_rows, card=card)
    del carry, bc, out_k, out_p

    # ---- Heun main path: one warm-up run, then one timed 2,880-step block
    sim.run(steps=COMPARE_STEPS)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sim.run(steps=HEUN_BLOCK_STEPS)
    torch.cuda.synchronize()
    heun_s = time.perf_counter() - t0
    heun_launches = fs.soil_column_heun_rollout.launches
    if heun_launches != 1:
        raise AssertionError(f"the Heun block took {heun_launches} Heun kernel launches")
    st = sim.state
    for name in ("internal_energy", "saturation_water_ice", "temperature", "pressure_head",
                 "hydraulic_conductivity", "surface_excess_water"):
        if not bool(torch.isfinite(st[name]).all()):
            raise AssertionError(f"Heun main path: non-finite {name}")
    sat = st.saturation_water_ice
    if not (float(sat.min()) >= 0.0 and float(sat.max()) <= 1.0):
        raise AssertionError("Heun main path: saturation left [0, 1]")
    if sim.iteration != COMPARE_STEPS + HEUN_BLOCK_STEPS:
        raise AssertionError(f"Heun main path: clock iteration {sim.iteration}")
    phase("heun_main_path", cells=BENCH_CELLS, nz=BENCH_NZ, steps=HEUN_BLOCK_STEPS,
          seconds=heun_s, launches=heun_launches,
          cells_steps_per_s=BENCH_CELLS * HEUN_BLOCK_STEPS / heun_s, card=card,
          T_top_range=[float(st.temperature[-1].min()), float(st.temperature[-1].max())],
          input_at_last_step=float(st.inputs["surface_temperature"][0]))
    del sim, st, sat

    # ---- heat-only default model: kernel against plain (float64 on 1,024
    # columns, float32 at full width), then one timed 5,760-step block
    sim = heat_sim(tp, HEAT_F64_CELLS, torch.float64)
    carry, bc, coords, params = series_operands(fs, sim, COMPARE_STEPS)
    heat_f64 = check_f64_close("heat-only", fs.soil_column_heat_rollout(
        *carry, bc, *coords, params, HEAT_DT), fs.soil_column_rollout_plain(
        *carry, bc, *coords, params, HEAT_DT, physics="heat"), 1e-12)
    sim = heat_sim(tp, HEAT_CELLS, torch.float32)
    carry, bc, coords, params = series_operands(fs, sim, COMPARE_STEPS)
    out_k = fs.soil_column_heat_rollout(*carry, bc, *coords, params, HEAT_DT)
    out_p = fs.soil_column_rollout_plain(*carry, bc, *coords, params, HEAT_DT, physics="heat")
    torch.cuda.synchronize()
    heat_cmp = check_close("heat-only", out_k, out_p, F32_REL_TOL)
    heat_ms = cuda_ms(lambda: fs.soil_column_heat_rollout(*carry, bc, *coords, params,
                                                          HEAT_DT), reps=3, warmup=True)
    heat_plain_ms = cuda_ms(lambda: fs.soil_column_rollout_plain(
        *carry, bc, *coords, params, HEAT_DT, physics="heat"))
    heat_rows = series_rows_read(bc, HEAT_DT)
    heat_b = bound_ms(HEAT_OPS_PER_LEVEL_STEP * BENCH_NZ * HEAT_CELLS * COMPARE_STEPS
                      + SERIES_OPS_PER_READ * HEAT_CELLS * COMPARE_STEPS,
                      3 * BENCH_NZ * HEAT_CELLS * 4 + heat_rows * HEAT_CELLS * 4)
    del carry, bc, out_k, out_p
    sim.run(steps=COMPARE_STEPS)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sim.run(steps=HEAT_BLOCK_STEPS)
    torch.cuda.synchronize()
    heat_s = time.perf_counter() - t0
    heat_launches = fs.soil_column_heat_rollout.launches
    if heat_launches != 1:
        raise AssertionError(f"the heat-only block took {heat_launches} heat kernel launches")
    st = sim.state
    for name in ("internal_energy", "temperature", "liquid_water_fraction",
                 "hydraulic_conductivity"):
        if not bool(torch.isfinite(st[name]).all()):
            raise AssertionError(f"heat-only path: non-finite {name}")
    if sim.iteration != COMPARE_STEPS + HEAT_BLOCK_STEPS:
        raise AssertionError(f"heat-only path: clock iteration {sim.iteration}")
    if not bool((st.saturation_water_ice == 0.8).all()):
        raise AssertionError("heat-only path: the saturation changed")
    phase("heat_only_forcing", cells=HEAT_CELLS, nz=BENCH_NZ, steps=HEAT_BLOCK_STEPS,
          seconds=heat_s, launches=heat_launches,
          cells_steps_per_s=HEAT_CELLS * HEAT_BLOCK_STEPS / heat_s,
          compare_steps=COMPARE_STEPS, f64_cells=HEAT_F64_CELLS, f64_rtol=1e-12,
          f64_max_abs_err=heat_f64, rel_tol=F32_REL_TOL, max_abs_err=heat_cmp,
          kernel_ms=heat_ms, plain_ms=heat_plain_ms, bound_ms=heat_b[0],
          bound_by=heat_b[1], card=card,
          T_top_range=[float(st.temperature[-1].min()), float(st.temperature[-1].max())])
    del sim, st

    # ---- implicit_freeze golden through the implicit kernel (Simulation.run,
    # one launch) and through the plain version, both solvers, and the water
    # identity
    igold = np.load(IMPLICIT_GOLDEN)
    errs, idents = {}, {}
    for solver in SOLVERS:
        for route in ("kernel", "plain"):
            sim = implicit_freeze_sim(tp, solver)
            w0 = water(sim)
            if route == "kernel":
                reset_counts()
                sim.run(steps=48, dt=3600.0)
                torch.cuda.synchronize()
                if fs.soil_column_implicit_rollout.launches != 1:
                    raise AssertionError(f"implicit_freeze ({solver}): "
                                         f"{fs.soil_column_implicit_rollout.launches} implicit "
                                         "kernel launches, expected 1")
                idents[solver] = float(((water(sim) - w0).abs() / w0.abs()).max())
                if idents[solver] > 1e-12:
                    raise AssertionError(f"implicit_freeze ({solver}): water identity through "
                                         f"the kernel {idents[solver]}")
            else:
                advance(sim.model, sim.state, sim.ctx, 48, 3600.0, timestepper=sim.timestepper,
                        plain=True)
                sim.compute_auxiliary()
            for f in igold.files:
                got = sim.state[f].cpu().numpy()
                np.testing.assert_allclose(got, igold[f], rtol=1e-12, atol=1e-12,
                                           err_msg=f"implicit_freeze {solver} {route}: {f}")
                errs[f"{solver}:{route}:{f}"] = float(np.max(np.abs(got - igold[f])))
    phase("implicit_golden", rtol=1e-12, atol=1e-12, max_abs_err=errs,
          water_identity_rel_err=idents)
    del sim

    # ---- the implicit kernel against its plain version at full width, each
    # solver, 144 steps, with the water identity; then column_implicit_tridiag
    # through Simulation.run: one warm-up run, then one timed 1,920-step block
    imp = {}
    for solver in SOLVERS:
        sim = implicit_sim(tp, solver)
        g = sim.model.grid
        coords = tuple(getattr(g, n)[:, 0].contiguous()
                       for n in ("dz", "dz_faces", "z_centers", "z_faces"))
        carry = tuple(sim.state.prognostic[n].contiguous() for n in sim.model.live_carry)
        params = fs.ColumnParams.of(sim.model, g.dtype)
        times = clock_times(sim.state.clock.time, IMPLICIT_DT, COMPARE_STEPS)[:-1]
        table = top_temperature_table(sim.bcs["temperature"]["top"].value, times, g)
        w0 = water(sim)
        out_k = fs.soil_column_implicit_rollout(*carry, table, *coords, params, IMPLICIT_DT,
                                                solver=solver)
        out_p = fs.soil_column_rollout_plain(*carry, table, *coords, params, IMPLICIT_DT,
                                             stepper="implicit", solver=solver)
        torch.cuda.synchronize()
        cmp_ = check_close(f"ImplicitEuler {solver}", out_k, out_p, F32_REL_TOL)
        dz = g.dz[:, 0]
        w_k = (out_k[1] * dz[:, None]).sum(0) + out_k[2]
        ident = float(((w_k.double() - w0.double()).abs() / w0.double().abs()).max())
        if ident > IMPLICIT_F32_WATER_TOL:
            raise AssertionError(f"ImplicitEuler {solver}: water identity through the kernel "
                                 f"{ident} > {IMPLICIT_F32_WATER_TOL}")
        k_ms = cuda_ms(lambda: fs.soil_column_implicit_rollout(
            *carry, table, *coords, params, IMPLICIT_DT, solver=solver), reps=3, warmup=True)
        p_ms = cuda_ms(lambda: fs.soil_column_rollout_plain(
            *carry, table, *coords, params, IMPLICIT_DT, stepper="implicit", solver=solver))
        b = bound_ms(implicit_ops(solver, BENCH_NZ) * BENCH_CELLS * COMPARE_STEPS,
                     2 * (2 * BENCH_NZ + 1) * BENCH_CELLS * 4 + COMPARE_STEPS * 4)
        del carry, table, out_k, out_p
        sim.run(steps=COMPARE_STEPS)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        sim.run(steps=IMPLICIT_BLOCK_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = fs.soil_column_implicit_rollout.launches
        if launches != 1:
            raise AssertionError(f"the implicit block ({solver}) took {launches} launches")
        st = sim.state
        for name in ("internal_energy", "saturation_water_ice", "temperature", "pressure_head",
                     "hydraulic_conductivity", "surface_excess_water",
                     "liquid_water_fraction"):
            if not bool(torch.isfinite(st[name]).all()):
                raise AssertionError(f"implicit main path ({solver}): non-finite {name}")
        sat = st.saturation_water_ice
        if not (float(sat.min()) >= 0.0 and float(sat.max()) <= 1.0):
            raise AssertionError(f"implicit main path ({solver}): saturation left [0, 1]")
        if sim.iteration != COMPARE_STEPS + IMPLICIT_BLOCK_STEPS:
            raise AssertionError(f"implicit main path ({solver}): clock iteration "
                                 f"{sim.iteration}")
        imp[solver] = dict(max_abs_err=cmp_, water_identity_rel_err=ident, kernel_ms=k_ms,
                           plain_ms=p_ms, bound_ms=b[0], bound_by=b[1], seconds=run_s,
                           launches=launches,
                           cells_steps_per_s=BENCH_CELLS * IMPLICIT_BLOCK_STEPS / run_s)
        phase("implicit_compare", solver=solver, steps=COMPARE_STEPS, rel_tol=F32_REL_TOL,
              water_tol=IMPLICIT_F32_WATER_TOL, max_abs_err=cmp_, water_identity_rel_err=ident,
              kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b[0], bound_by=b[1], card=card)
        phase("implicit_main_path", solver=solver, cells=BENCH_CELLS, nz=BENCH_NZ,
              dt=IMPLICIT_DT, steps=IMPLICIT_BLOCK_STEPS, seconds=run_s, launches=launches,
              cells_steps_per_s=BENCH_CELLS * IMPLICIT_BLOCK_STEPS / run_s, card=card,
              T_top_range=[float(st.temperature[-1].min()), float(st.temperature[-1].max())],
              frozen_fraction_top=float((st.liquid_water_fraction[-1] < 1.0).float().mean()))
        del sim, st, sat

    # ---- land_model golden through the land kernel (Simulation.run, one
    # launch) and through the plain version (the process modules)
    lgold = np.load(LAND_GOLDEN)
    errs = {}
    for route in ("kernel", "plain"):
        sim = land_golden_sim(tp)
        if route == "kernel":
            reset_counts()
            sim.run(steps=48, dt=300.0)
            torch.cuda.synchronize()
            if ls.land_column_rollout.launches != 1:
                raise AssertionError(f"land golden: {ls.land_column_rollout.launches} land "
                                     "kernel launches, expected 1")
        else:
            advance(sim.model, sim.state, sim.ctx, 48, 300.0, input_sources=sim.input_sources,
                    plain=True)
            sim.compute_auxiliary()
        for f in lgold.files:
            got = sim.state[f].cpu().numpy()
            np.testing.assert_allclose(got, lgold[f], rtol=1e-12, atol=1e-12,
                                       err_msg=f"land golden {route}: {f}")
            errs[f"{route}:{f}"] = float(np.max(np.abs(got - lgold[f])))
    phase("land_golden", rtol=1e-12, atol=1e-12, max_abs_err=errs)
    del sim

    # ---- the land kernel against its plain version: float64 on 1,024
    # columns, float32 at full width, 144 steps of the consistent composition
    sim = land_sim(tp, LAND_F64_CELLS, torch.float64, "consistent")
    carry, linputs, root, coords, params = land_operands(ls, land_inputs, sim)
    f64_abs, land_f64, _, seen_f64, beyond_f64, *_ = land_teacher(
        ls, fs, carry, linputs, root, coords, params, float(sim.state.clock.time),
        COMPARE_STEPS, land_f64_tolerance)
    del sim, carry, linputs, root
    sim = land_sim(tp, LAND_CELLS, torch.float32, "consistent")
    carry, linputs, root, coords, params = land_operands(ls, land_inputs, sim)
    t_start = float(sim.state.clock.time)
    land_abs, land_cmp, land_ulps, seen_f32, beyond_f32, chain, runs, outside = land_teacher(
        ls, fs, carry, linputs, root, coords, params, t_start, COMPARE_STEPS, land_f32_tolerance)
    out_k = ls.land_column_rollout(carry, linputs, root, *coords, params, LAND_DT, t_start,
                                   COMPARE_STEPS)
    out_p = ls.land_column_rollout_plain(carry, linputs, root, *coords, params, LAND_DT,
                                         t_start, COMPARE_STEPS)
    torch.cuda.synchronize()
    names = sim.model.live_carry
    chain_equal = all(torch.equal(out_k[n], chain[n]) for n in names)
    whole = {n: float((out_k[n] - out_p[n]).abs().max()) for n in names}
    finite = all(bool(torch.isfinite(out_k[n]).all()) for n in names)
    land_ms = cuda_ms(lambda: ls.land_column_rollout(carry, linputs, root, *coords, params,
                                                     LAND_DT, t_start, COMPARE_STEPS),
                      reps=3, warmup=True)
    land_plain_ms = cuda_ms(lambda: ls.land_column_rollout_plain(
        carry, linputs, root, *coords, params, LAND_DT, t_start, COMPARE_STEPS))
    land_rows = series_rows_read(fs.SeriesBC(linputs["air_temperature"].values, 0.0, SERIES_DTS,
                                             t_start, COMPARE_STEPS), LAND_DT)
    carry_bytes = sum(t.numel() for t in carry.values()) * 4
    land_op_count = land_ops(LAND_NZ, runs)
    land_b = bound_ms(land_op_count * LAND_CELLS * COMPARE_STEPS,
                      2 * carry_bytes + 2 * land_rows * LAND_CELLS * 4)
    phase("land_compare", cells=LAND_CELLS, nz=LAND_NZ, steps=COMPARE_STEPS,
          f64_cells=LAND_F64_CELLS, f64_rtol=1e-12, f64_max_abs_err=f64_abs,
          f64_max_err_over_magnitude=land_f64, f64_beyond=beyond_f64[:12],
          f64_steps_a_zeroed_change_fails=seen_f64, rel_tol=F32_REL_TOL, max_abs_err=land_abs,
          max_err_over_magnitude=land_cmp, max_err_in_ulps_inside_unit=land_ulps,
          f32_beyond=beyond_f32[:12],
          f32_steps_a_zeroed_change_fails=seen_f32, one_launch_equals_step_chain=chain_equal,
          one_launch_vs_plain_rollout_max_abs_err=whole, one_launch_finite=finite,
          kernel_ms=land_ms, plain_ms=land_plain_ms, bound_ms=land_b[0], bound_by=land_b[1],
          ops_per_column_step=land_op_count, branch_runs_per_column_step=runs,
          outside_unit_share_at_step={i: outside[i - 1] for i in (1, 2, 3, 4, 12, 48, 144)},
          series_rows_read=land_rows, card=card)
    if beyond_f64 or beyond_f32 or not chain_equal or not finite:
        raise AssertionError(f"land kernel vs plain: f64 {beyond_f64[:4]}, f32 {beyond_f32[:4]}, "
                             f"one launch equals the step chain: {chain_equal}, finite: {finite}")
    del carry, linputs, root, out_k, out_p

    # ---- land_consistent main path: Simulation.run, one warm-up run, then
    # one timed 1,440-step block
    sim.run(steps=COMPARE_STEPS)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sim.run(steps=LAND_BLOCK_STEPS)
    torch.cuda.synchronize()
    land_s = time.perf_counter() - t0
    land_launches = ls.land_column_rollout.launches
    if land_launches != 1:
        raise AssertionError(f"the land block took {land_launches} land kernel launches")
    st = sim.state
    for name, shape in (("internal_energy", (LAND_NZ, LAND_CELLS)),
                        ("saturation_water_ice", (LAND_NZ, LAND_CELLS)),
                        ("temperature", (LAND_NZ, LAND_CELLS)),
                        ("skin_temperature", (LAND_CELLS,)), ("ground_heat_flux", (LAND_CELLS,)),
                        ("canopy_water", (LAND_CELLS,)), ("carbon_vegetation", (LAND_CELLS,)),
                        ("vegetation_area_fraction", (LAND_CELLS,)),
                        ("surface_excess_water", (LAND_CELLS,)),
                        ("net_primary_production", (LAND_CELLS,))):
        v = st[name]
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"land main path: {name} of shape {tuple(v.shape)} or "
                                 "non-finite values")
    if sim.iteration != COMPARE_STEPS + LAND_BLOCK_STEPS:
        raise AssertionError(f"land main path: clock iteration {sim.iteration}")
    # the state the block's steps run on: one more kernel step from its end
    # (after the counts were read), the share of columns it leaves with a
    # layer outside [0, 1] for the next closure to adjust
    carry, linputs, root, coords, params = land_operands(ls, land_inputs, sim)
    after = ls.land_column_rollout(carry, linputs, root, *coords, params, LAND_DT,
                                   float(st.clock.time), 1)
    phase("land_main_path", composition="consistent", cells=LAND_CELLS, nz=LAND_NZ,
          dt=LAND_DT, steps=LAND_BLOCK_STEPS, seconds=land_s, launches=land_launches,
          cells_steps_per_s=LAND_CELLS * LAND_BLOCK_STEPS / land_s, card=card,
          skin_range=[float(st.skin_temperature.min()), float(st.skin_temperature.max())],
          T_top_range=[float(st.temperature[-1].min()), float(st.temperature[-1].max())],
          nonfinite_share=land_nonfinite(sim)[0],
          outside_unit_share_next_step=float(outside_unit(after).float().mean()),
          saturation_range_next_step=[float(after["saturation_water_ice"].min()),
                                      float(after["saturation_water_ice"].max())],
          pool_max_m=float(st.surface_excess_water.max()))
    del sim, st, carry, linputs, root, after

    # ---- land_coupled_n145 as bench_configs.py writes it (the parity
    # composition): its kernel time per 144 steps and one timed 1,440-step
    # block, with the share of columns left non-finite
    sim = land_sim(tp, LAND_CELLS, torch.float32, "parity")
    carry, linputs, root, coords, params = land_operands(ls, land_inputs, sim)
    t_start = float(sim.state.clock.time)
    parity_ms = cuda_ms(lambda: ls.land_column_rollout(carry, linputs, root, *coords, params,
                                                       LAND_DT, t_start, COMPARE_STEPS),
                        reps=3, warmup=True)
    del carry, linputs, root
    sim.run(steps=COMPARE_STEPS)
    torch.cuda.synchronize()
    share_144 = land_nonfinite(sim)
    reset_counts()
    t0 = time.perf_counter()
    sim.run(steps=LAND_BLOCK_STEPS)
    torch.cuda.synchronize()
    parity_s = time.perf_counter() - t0
    if ls.land_column_rollout.launches != 1:
        raise AssertionError(f"the parity land block took {ls.land_column_rollout.launches} "
                             "launches")
    share = land_nonfinite(sim)
    phase("land_bench_parity", composition="parity", cells=LAND_CELLS, nz=LAND_NZ, dt=LAND_DT,
          steps=LAND_BLOCK_STEPS, seconds=parity_s, launches=ls.land_column_rollout.launches,
          cells_steps_per_s=LAND_CELLS * LAND_BLOCK_STEPS / parity_s, kernel_ms=parity_ms,
          compare_steps=COMPARE_STEPS, nonfinite_share_after_144=share_144[0],
          canopy_water_nonfinite_share_after_144=share_144[1],
          nonfinite_share_after_block=share[0], canopy_water_nonfinite_share_after_block=share[1],
          card=card)
    del sim

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
        reset_counts()
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
    series_at = "; the series read at terrarium_tpu/ops/fused_step.py:92"
    print(json.dumps({"kernels": [{
        "name": "soil_column_rollout", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/soil_column_rollout.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:283",
        "launches": main_launches, "max_abs_err": max(cmp.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": fwd_b[0], "bound_by": fwd_b[1],
        "library_ms": None,
        "shape": f"{BENCH_CELLS} x {BENCH_NZ} f32, {COMPARE_STEPS} steps"}, {
        "name": "soil_column_heun_rollout", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/soil_column_rollout.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:283" + series_at,
        "launches": heun_launches, "max_abs_err": max(heun_cmp.values()),
        "ms": heun_ms, "plain_ms": heun_plain_ms, "bound_ms": heun_b[0],
        "bound_by": heun_b[1], "library_ms": None,
        "shape": f"{BENCH_CELLS} x {BENCH_NZ} f32, Heun, series, {COMPARE_STEPS} steps"}, {
        "name": "soil_column_heat_rollout", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/soil_column_rollout.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:283" + series_at,
        "launches": heat_launches, "max_abs_err": max(heat_cmp.values()),
        "ms": heat_ms, "plain_ms": heat_plain_ms, "bound_ms": heat_b[0],
        "bound_by": heat_b[1], "library_ms": None,
        "shape": f"{HEAT_CELLS} x {BENCH_NZ} f32, heat only, series, {COMPARE_STEPS} steps"}, {
        "name": "soil_column_implicit_rollout", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/soil_column_rollout.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:283 with terrarium_tpu/timesteppers/"
                    "implicit.py:173 (tridiag.py:109 PCR, :30 Thomas)",
        "launches": imp["pcr"]["launches"], "max_abs_err": max(imp["pcr"]["max_abs_err"].values()),
        "ms": imp["pcr"]["kernel_ms"], "plain_ms": imp["pcr"]["plain_ms"],
        "bound_ms": imp["pcr"]["bound_ms"], "bound_by": imp["pcr"]["bound_by"],
        "library_ms": None,
        "shape": f"{BENCH_CELLS} x {BENCH_NZ} f32, ImplicitEuler dt {IMPLICIT_DT:g}, PCR, "
                 f"{COMPARE_STEPS} steps",
        "thomas": {k: imp["thomas"][k] for k in ("launches", "kernel_ms", "plain_ms",
                                                  "bound_ms", "bound_by")}
        | {"max_abs_err": max(imp["thomas"]["max_abs_err"].values())}}, {
        "name": "soil_column_segment_vjp", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/soil_column_segment_vjp.cu",
        "replaces": "terrarium_tpu/ops/fused_vjp.py:68",
        "launches": launches["soil_column_segment_vjp"],
        "max_abs_err": max(full_err.values()),
        "ms": seg_ms, "plain_ms": vjp_plain_ms, "bound_ms": vjp_b[0], "bound_by": vjp_b[1],
        "library_ms": None,
        "shape": f"{GRAD_CELLS} x {GRAD_NZ} f32, {GRAD_INNER} steps; plain_ms at "
                 f"{GRAD_COMPARE_CELLS} columns"}, {
        "name": "land_column_rollout", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/land_column_rollout.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:283 traced over a LandModel step "
                    "(terrarium_tpu/models/land_model.py:55)",
        "launches": land_launches, "max_abs_err": max(land_abs.values()),
        "ms": land_ms, "plain_ms": land_plain_ms, "bound_ms": land_b[0],
        "bound_by": land_b[1], "library_ms": None,
        "shape": f"{LAND_CELLS} x {LAND_NZ} f32, land_consistent, series, "
                 f"{COMPARE_STEPS} steps"}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def euler_digest(root: pathlib.Path):
    """SHA-256 of the ForwardEuler heat + Richards kernel's outputs (golden
    f64 Nz 20, 120 steps; bench f32 Nz 30, 144 steps at full width; gradient
    configuration f32 Nz 20, 48 steps at full width) and of the Heun
    kernel's (heun_forced f64 Nz 15, 96 steps; the Heun + series
    configuration f32 Nz 30, 144 steps at full width), the rollout's ptxas
    lines and the bench main-path rate, for the package under ``root``."""
    import hashlib

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(root))
    import terrarium_tpu_torch as tp
    from terrarium_tpu_torch.ops import cuda_build
    from terrarium_tpu_torch.ops import fused_step as fs
    from terrarium_tpu_torch.timesteppers.integrator import clock_times, top_temperature_table

    t0 = time.perf_counter()
    cuda_build.build("soil_column_rollout")
    build_s = time.perf_counter() - t0
    digests = {}
    for case, sim, steps in (("golden_f64_nz20", golden_sim(tp), 120),
                             ("bench_f32_nz30", bench_sim(tp), COMPARE_STEPS),
                             ("grad_f32_nz20", grad_sim(tp, GRAD_CELLS, torch.float32),
                              GRAD_INNER)):
        g = sim.model.grid
        coords = tuple(getattr(g, n)[:, 0].contiguous()
                       for n in ("dz", "dz_faces", "z_centers", "z_faces"))
        carry = tuple(sim.state.prognostic[n].contiguous() for n in sim.model.live_carry)
        dt = sim.timestepper.default_dt()
        table = top_temperature_table(sim.bcs["temperature"]["top"].value,
                                      clock_times(sim.state.clock.time, dt, steps)[:-1], g)
        out = fs.soil_column_rollout(*carry, table, *coords, fs.ColumnParams.of(
            sim.model, g.dtype), dt)
        digests[case] = hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                                for t in out)).hexdigest()
        del sim, carry, out
    # the Heun kernel: heun_forced f64 Nz 15 through Simulation.run, and the
    # Heun + series configuration f32 Nz 30 at full width
    sim = heun_forced_sim(tp)
    sim.run(steps=96, dt=300.0)
    digests["heun_forced_f64_nz15"] = hashlib.sha256(b"".join(
        sim.state.prognostic[n].cpu().numpy().tobytes()
        for n in sim.model.live_carry)).hexdigest()
    sim = heun_sim(tp, BENCH_CELLS)
    carry, bc, coords, params = series_operands(fs, sim, COMPARE_STEPS)
    out = fs.soil_column_heun_rollout(*carry, bc, *coords, params, BENCH_DT)
    digests["heun_series_f32_nz30"] = hashlib.sha256(b"".join(
        t.cpu().numpy().tobytes() for t in out)).hexdigest()
    del sim, carry, bc, out
    sim = bench_sim(tp)
    sim.run(steps=COMPARE_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(steps=BLOCK_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in cuda_build.ptxas_report("soil_column_rollout").splitlines()
             if ln.startswith("==") or "Compiling entry" in ln or "Used" in ln
             or "spill stores" in ln]
    print(json.dumps({"ptxas": ptxas}), flush=True)
    print(json.dumps({"package": tp.__file__, "build_s": build_s, "digests": digests,
                      "main_path_cells_steps_per_s": BENCH_CELLS * BLOCK_STEPS / run_s}),
          flush=True)


if __name__ == "__main__":
    if "--euler-digest" in sys.argv:
        args = sys.argv[1:]
        root = (pathlib.Path(args[args.index("--package-root") + 1])
                if "--package-root" in args else ROOT)
        euler_digest(root.resolve())
    else:
        main()
