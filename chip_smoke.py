"""Smoke test of the PyTorch port on one CUDA card.

Builds the port's CUDA kernels from ``terrarium_tpu_torch/csrc`` (the soil
column rollouts, ForwardEuler and Heun, heat + Richards and heat only,
ImplicitEuler with Thomas or PCR solves, the segment VJP of each of these
but Heun over heat only, the land rollout and the full step; one ``nvcc``
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
  1,440-step block, the latter with its non-finite share; the
  ``land_snow`` golden (float64, Nz 12, 48 steps through the kernel: the
  snowpack's fields against the golden, every field against the plain
  version); the land kernel's Heun, ImplicitEuler (PCR, Thomas) and
  snowpack (ImplicitEuler PCR) variants, each against its plain version one
  step at a time (float64 on 1,024 columns, float32 at full width, 48
  steps) and then through ``Simulation.run`` on ``land_consistent``'s
  composition and forcing at dt 600 s (``land_heun``, ``land_implicit_pcr``,
  ``land_implicit_thomas``, ``land_snow_n145`` with a snowfall and an initial
  pack), one timed 1,440-step block each, with the share of columns with a
  saturation layer outside [0, 1] at steps 3 and 1,440;
* the gradient path (``make_fused_grad_rollout``) of the configuration
  ``grad_n145_heat_richards`` (`bench_configs.py:311-411`): 56,951 columns,
  Nz 20, float32, dt 300 s, 288 steps in segments of 48, value and gradient
  of mean(T) + mean(sat) in log K_sat, after checking the segment-VJP kernel
  against its plain version (torch autograd) on 1,024 columns at float64
  and float32, at full width at float32 (the plain version in chunks of
  1,024 columns), and against the conservation of water;
* the LandModel's gradient path (``make_fused_grad_rollout`` over the land
  kernel and the land segment VJP): ``land_consistent``'s composition at
  56,951 columns, Nz 20, float32, with its forcing's daily means as static
  inputs, 288 steps in segments of 48, value and gradient of mean(T) +
  mean(carbon) in log K_sat and k_mineral, ForwardEuler at dt 60 s
  (``land_grad_euler``) and ImplicitEuler at dt 600 s with each solver
  (``land_grad_implicit_pcr``, ``_thomas``), after the land segment-VJP
  kernel against its plain version (float64 on 1,024 columns at rtol 1e-9,
  float32 at full width with the plain version in chunks) and the float64
  gradient against central differences of the loss;
* the gradient path of the segment VJP's other schemes, each at 56,951
  columns, Nz 30, float32, 288 steps in segments of 48, after its kernel
  against its plain version (float64 on 1,024 columns at the scheme's
  float64 Nz, float32 at full width in chunks of 4,096 columns) and, with
  Richards flow, the water identity through it: ``grad_heun_n145`` (Heun at
  dt 60 s), ``grad_implicit_n145_pcr`` and ``_thomas`` (ImplicitEuler at dt
  900 s), all in log K_sat as above, and ``grad_n145_heat``
  (`bench_configs.py:270-308`: the heat-only model, d mean(T) / d
  k_mineral, ForwardEuler at dt 300 s), also timed through the port's
  ``make_rollout_fn(remat=True)``.

Run from the repository root:

    python3 chip_smoke.py

Every phase prints one line; the line before the last is the kernel report
and the last line is ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero, and so does a machine without a CUDA device.

``python3 chip_smoke.py --euler-digest [--package-root DIR]`` instead prints
the SHA-256 of the ForwardEuler heat + Richards kernel's outputs on the
golden, bench and gradient configurations, of the Heun kernel's on
``heun_forced`` and the Heun + series configuration, of the heat-only,
implicit (each solver), segment-VJP (each scheme the package has), land
kernels' (each stepper and the snowpack the package has) and land
segment-VJP kernel's (each scheme, where the package has it) on their
full-width comparison operands, and the bench
``main_path`` rate, for the package in
``DIR`` (default: this checkout). Run it on two checkouts in one call to
compare their kernels bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
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

# the segment VJP of the other schemes, each timed as a value and gradient
# over 288 steps in 6 segments of 48 at full width, Nz 30 (the float32
# instantiations; the float64 checks at each scheme's float64 Nz):
# grad_heun_n145 and grad_implicit_n145 are grad_n145_heat_richards
# (bench_configs.py:318-336: mean(T) + mean(sat) in log K_sat) stepped by
# Heun at dt 60 s (the Heun bench dt) and by ImplicitEuler at dt 900 s
# (column_implicit_tridiag's; three simulated days) with each solver;
# grad_n145_heat is bench_configs.py:270-308 (the heat-only default model, T
# = -1 degC, sat 0.8, top 4 degC, d mean(T) / d k_mineral) at dt 300 s and Nz
# 30 (the heat kernel's instantiation) instead of 20
GRAD_SCHEMES = {
    "grad_heun_n145": dict(stepper="heun", solver="pcr", physics="richards", dt=60.0, f64_nz=15),
    "grad_implicit_n145_pcr": dict(stepper="implicit", solver="pcr", physics="richards",
                                   dt=900.0, f64_nz=16),
    "grad_implicit_n145_thomas": dict(stepper="implicit", solver="thomas", physics="richards",
                                      dt=900.0, f64_nz=16),
    "grad_n145_heat": dict(stepper="euler", solver="pcr", physics="heat", dt=300.0, f64_nz=30),
}
K_MINERAL = 3.8
# the float32 full-width comparisons of these schemes run the plain version
# in chunks of GRAD_SCHEME_CHUNK columns, 4 a scheme: torch autograd through
# the plain steps is thousands of small launches a chunk, so fewer, wider
# chunks keep the script inside its time limit; each column is compared all
# the same
GRAD_SCHEME_CHUNK = 16384
# Operations behind these VJPs' bounds, counted as ADJ_OPS (the adjoint
# without its recompute, the forward's intermediates taken as given, the
# cheaper side of each data-dependent branch):
# * Heun, per level and step: the Heun step (HEUN_OPS_PER_LEVEL_STEP); the
#   adjoint of closure_rhs at the stage and at x_n (each ADJ_OPS); the
#   corrector's 0.5 (g dt) for U and sat (2 each) and the stage's way back,
#   gx += gy and gf_n += gy dt for U and sat (6): 10;
# * ImplicitEuler, per level and step: the implicit step's operations
#   (implicit_ops); the adjoint of closure_rhs (ADJ_OPS); for each system
#   the rows' cotangents (3 products), then d(Psi)/d(sat)'s derivative
#   (clip 2 compares, the powers' three values and derivatives 9, the
#   clamp 2, the products of the chain 8, times the cotangent and the add
#   2: 23), dT/dU's -(g Dh) Dh (3) and the face kappa's mean (3); per
#   interior face and system, diffusion_rows' adjoint (for each of its two
#   rows: two quotients, the face K's s (qa D + qb D) 5 and the two chain
#   factors' products and adds 4: 22); per column and system one solve of
#   the transposed rows (implicit_solver_ops) and the Dirichlet top row's
#   adjoint (5);
# * heat only, per level and step: the heat-only step
#   (HEAT_OPS_PER_LEVEL_STEP) and its adjoint: the heat flux and energy
#   update (11) and level_adjoint without the centre K (34).
HEUN_VJP_OPS_PER_LEVEL_STEP = HEUN_OPS_PER_LEVEL_STEP + 2 * sum(ADJ_OPS.values()) + 10
IMPLICIT_VJP_OPS_PER_LEVEL = sum(ADJ_OPS.values()) + 2 * 3 + 23 + 3 + 3
IMPLICIT_VJP_OPS_PER_FACE = 2 * 22
HEAT_VJP_OPS_PER_LEVEL_STEP = HEAT_OPS_PER_LEVEL_STEP + 11 + 34


def scheme_vjp_ops(name, nz):
    """Operations of one step of one column of a scheme's segment VJP."""
    cfg = GRAD_SCHEMES[name]
    if cfg["stepper"] == "heun":
        return HEUN_VJP_OPS_PER_LEVEL_STEP * nz
    if cfg["stepper"] == "implicit":
        return (implicit_ops(cfg["solver"], nz) + IMPLICIT_VJP_OPS_PER_LEVEL * nz
                + IMPLICIT_VJP_OPS_PER_FACE * (nz - 1)
                + 2 * (implicit_solver_ops(cfg["solver"], nz) + 5))
    return HEAT_VJP_OPS_PER_LEVEL_STEP * nz


def scheme_vjp_bytes(name, nz, cells, itemsize, table_rows):
    """Bytes a scheme's segment VJP must move: it reads the input carry, the
    output cotangents and the table, and writes the input cotangents and the
    two parameter cotangents (heat only: U and sat, their cotangents)."""
    values = 6 * nz if GRAD_SCHEMES[name]["physics"] == "heat" else 3 * (2 * nz + 1)
    return (values * cells + table_rows + 2) * itemsize

# one full step (make_fused_step) in experiments/ab_fused_step.py's setup:
# the bench composition at full width, 56,951 x 30 float32, dt 60 s; the
# float64 checks on FULL_F64_CELLS columns (Nz 20 ForwardEuler, Nz 15 Heun)
# along FULL_F64_STEPS steps of the plain trajectory; the main path a loop
# of FULL_STEPS calls; each call timed FULL_TIMED times
FULL_F64_CELLS, FULL_F64_STEPS, FULL_STEPS, FULL_TIMED = 300, 3, 20, 30
# run through the process modules: the bench soil with a forcing, which no
# kernel takes, at full width
RUN_MODULE_STEPS = 200
# Operations per level of one full step (csrc/soil_full_step.cuh), counted
# as FWD_OPS: stored_rhs's conductivities from the stored saturation and
# liquid fraction (fractions 6, thermal conductivity 8, and Level's centre
# K 17, or the linear K_sat theta_w / (theta_w + theta_i + theta_a), 4);
# the heat flux and energy update 9 and the Darcy flux and water update 12
# (FWD_OPS's); the face K stored, 1; the trailing closure: sweeps 14,
# Level without the centre K 37, Head 17. Heun: stored_rhs with its
# tendencies kept (the Euler update's multiply and add for U and sat off),
# the stage y = x + f dt (a multiply and an add for U and sat), closure_rhs
# at the stage (FWD_OPS, HEAT_OPS for heat only) with the corrector's mean
# (two more for U and sat), then the trailing closure.
STORED_OPS = {"richards": 6 + 8 + 17, "heat": 6 + 8 + 4}
FULL_CLOSURE_OPS = {"richards": 14 + 37 + 17, "heat": 37}
FULL_RHS_OPS = {"richards": 9 + 12 + 1, "heat": 9 + 1}
FULL_STAGE_OPS = {"richards": FWD_OPS_PER_LEVEL_STEP, "heat": HEAT_OPS_PER_LEVEL_STEP}


def full_step_ops(stepper, physics, nz):
    """Operations of one full step of one column."""
    per_level = STORED_OPS[physics] + FULL_RHS_OPS[physics] + FULL_CLOSURE_OPS[physics]
    if stepper == "heun":  # the stage's closure_rhs and the corrector's mean
        per_level += FULL_STAGE_OPS[physics] + 2 * (2 if physics == "richards" else 1)
    return per_level * nz


def full_step_bytes(physics, nz, cells, itemsize, top_values):
    """Bytes one full step must move: it reads U, sat, T, liq (and psi, S)
    and the top temperatures once, and writes U, dU, T, liq, K_face, the
    ground temperature (and sat, dsat, psi, S, dS, the water table) once."""
    if physics == "richards":
        values = (5 * nz + 1) + (7 * nz + (nz + 1) + 4)
    else:
        values = 4 * nz + (4 * nz + (nz + 1) + 1)
    return (values * cells + top_values) * itemsize

# the LandModel: land_coupled_n145 (bench_configs.py:228-267) at synthetic
# latitudes from -60 to 80 degrees (the N145 mask is absent), 10 simulated
# days a block; the float64 comparison on 1,024 of those columns
LAND_CELLS, LAND_NZ, LAND_DT, LAND_BLOCK_STEPS, LAND_F64_CELLS = 56951, 20, 600.0, 1440, 1024
LAND_GOLDEN = ROOT / "tests" / "goldens" / "land_model.npz"
LAND_SNOW_GOLDEN = ROOT / "tests" / "goldens" / "land_snow.npz"
# land_snow_n145: the snowfall beside the rain and the initial pack
SNOWFALL, SWE0 = 2.0e-8, 0.02
# the land kernel's other steppers, each against its plain version along
# the plain trajectory for LAND_VARIANT_STEPS steps (float64 on
# LAND_F64_CELLS columns, float32 at full width) and timed over as many:
# (wrapper key, solver, snowpack)
LAND_VARIANTS = {"land_heun": ("heun", None, False),
                 "land_implicit_pcr": ("implicit", "pcr", False),
                 "land_implicit_thomas": ("implicit", "thomas", False),
                 "land_snow_implicit_pcr": ("implicit", "pcr", True)}
LAND_VARIANT_STEPS = 48
# Heun's float32 check steps at dt 60 s. At dt 600 its stage, the explicit
# Richards step, leaves [0, 1] in 95% of the columns from step 3 and its
# tendencies grow far beyond the state, so the float32 rounding of the
# stage moves the corrector by more than a field's change in a step
# (measured 8e-4 of the energy's magnitude, 1e-2 of the saturation's);
# at dt 60 the stage stays inside [0, 1] over the 48 steps (and the float64
# check holds every column at dt 600)
LAND_HEUN_F32_DT = 60.0
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


# The other land steps, counted from land_ops by the same rules (the
# branches of the x_n state taken for every closure_rhs of the step):
# * Heun (land::heun_step): two closure_rhs; the stage's update is an Euler
#   update and the corrector's x + (0.5 (f + g)) dt two operations more a
#   field (U and sat a level, pool, skin, canopy water, carbon, fraction,
#   SWE a column: 4 a level, 12 a column); the inputs read again at t + dt
#   (two series reads and the clock's add, 23).
# * ImplicitEuler (land::implicit_step): closure_rhs with its tendencies
#   kept (the Euler update's multiply and add for U and sat off, -4 a
#   level); a level: dT/dU 3, d(Psi)/d(sat) of the Brooks-Corey curve
#   (land::bc_chain: se 3, clip 2, se^-6 by three multiplies and a
#   reciprocal 4, the product and quotient 2, clamp 2, the compare and
#   select 2, times por 1: 16), the face kappa again 2, U += du and sat +=
#   du 2; IMPLICIT_OPS_PER_FACE a face (the rows of both systems); a
#   column: the two Flux BCs into the top rows' right-hand sides 5, and
#   two solves (implicit_solver_ops).
# * Snowpack: cover 3, melt 5, the albedo and emissivity blends 7, eps
#   sigma and 1 - eps 2, the melt into the ground rain 1, dSWE/dt 1, the
#   SWE update with its clip 3: 22 a column and step.
LAND_HEUN_OPS_PER_LEVEL, LAND_HEUN_OPS_PER_COLUMN = 4, 12 + 23
LAND_IMPLICIT_OPS_PER_LEVEL, LAND_IMPLICIT_OPS_PER_COLUMN = -4 + 3 + 16 + 2 + 2, 5
LAND_SNOW_OPS_PER_COLUMN = 22


def land_variant_ops(stepper, solver, snow, nz, branches):
    """Operations of one land step of one column of ``stepper`` (the kernel
    wrapper's key), with a snowpack where ``snow``."""
    ops = land_ops(nz, branches) + (LAND_SNOW_OPS_PER_COLUMN if snow else 0)
    if stepper == "heun":
        return 2 * ops + LAND_HEUN_OPS_PER_LEVEL * nz + LAND_HEUN_OPS_PER_COLUMN
    if stepper == "implicit":
        return (ops + LAND_IMPLICIT_OPS_PER_LEVEL * nz + IMPLICIT_OPS_PER_FACE * (nz - 1)
                + LAND_IMPLICIT_OPS_PER_COLUMN + 2 * implicit_solver_ops(solver, nz))
    return ops


# The LandModel's gradient path (make_fused_grad_rollout over the land
# kernel and its segment VJP, csrc/land_column_segment_vjp.cu):
# land_consistent's composition (land_model "consistent") at full width with
# its forcing's daily means as static per-column inputs, since the fused
# gradient takes static inputs only (in JAX as here): shortwave
# 900 cos(lat) / pi, air temperature T_mean; the rest of land_sim's. The
# objective is test_fused_grad.py:270-330's, mean(T) + mean(carbon), in
# log K_sat and k_mineral; 288 steps in segments of 48: ForwardEuler at dt
# 60 s (ROADMAP B1's stable composition) and ImplicitEuler with each solver
# at dt 600 s, the land's production step. (scheme key, solver, dt)
LAND_GRAD_SCHEMES = {"land_grad_euler": ("euler", None, 60.0),
                     "land_grad_implicit_pcr": ("implicit", "pcr", 600.0),
                     "land_grad_implicit_thomas": ("implicit", "thomas", 600.0)}
# the float32 full-width comparison runs the plain version (torch autograd
# through the process modules) in chunks of this many columns; the float64
# one on LAND_F64_CELLS columns over one segment; the central differences
# of the loss in log K_sat and k_mineral step by these
LAND_GRAD_CHUNK = 16384
LAND_FD_H, LAND_FD_RTOL = {"log_K_sat": 1e-4, "k_mineral": 1e-4}, 1e-5
# ForwardEuler's land state at dt 60 s leaves saturation [0, 1] within the
# gradient's 288 steps and its loss is not smooth there (the phase prints
# central differences at 288 steps and three h beside the adjoint, not
# held): its central differences are held over 96 steps, ImplicitEuler's
# over the gradient's 288
LAND_FD_STEPS = {"euler": 96, "implicit": GRAD_STEPS}
LAND_FD_REPORT_H = (1e-2, 1e-3, 1e-4)
# Operations of the land segment VJP behind its bound, counted as ADJ_OPS
# (the adjoint without its recompute, the forward's intermediates taken as
# given, the cheaper side of each data-dependent branch) beside one forward
# step (land_variant_ops): per level the soil's adjoint (ADJ_OPS: the
# Darcy flux, face K, heat flux, head compares, level_adjoint, sweeps), the
# linear centre K's (a quotient's two cotangents into K_sat, water, ice and
# air: 6) and the plant-available water's (compare 2, product, quotient,
# add: 5); per column the surface block reversed, one adjoint operation for
# each of its forward ones (LAND_OPS_PER_COLUMN without the series reads
# and the surface updates), and the surface updates' cotangents (dt times
# the pool, canopy water, carbon and fraction cotangents: 4). ImplicitEuler
# adds IMPLICIT_VJP_OPS_PER_LEVEL, _PER_FACE and the two transposed solves
# with their top rows, as the soil's (Brooks-Corey's chain derivative in
# place of Van Genuchten's, counted the same).
LAND_VJP_OPS_PER_LEVEL = sum(ADJ_OPS.values()) + 6 + 5
LAND_VJP_OPS_PER_COLUMN = (sum(LAND_OPS_PER_COLUMN.values())
                           - LAND_OPS_PER_COLUMN["series reads and clock"]
                           - LAND_OPS_PER_COLUMN["surface updates"] + 4)


def land_vjp_ops(stepper, solver, nz, branches):
    """Operations of one step of one column of the land segment VJP."""
    ops = (land_variant_ops(stepper, solver, False, nz, branches)
           + LAND_VJP_OPS_PER_LEVEL * nz + LAND_VJP_OPS_PER_COLUMN
           + sum(LAND_OPS_BRANCH[k] * n for k, n in branches.items()))
    if stepper == "implicit":
        ops += (IMPLICIT_VJP_OPS_PER_LEVEL - sum(ADJ_OPS.values())) * nz \
            + IMPLICIT_VJP_OPS_PER_FACE * (nz - 1) + 2 * (implicit_solver_ops(solver, nz) + 5)
    return ops


def land_vjp_bytes(nz, cells, itemsize):
    """Bytes the land segment VJP must move: it reads the input carry (2 Nz
    + 6 values a column), the output cotangents (as many), the static inputs
    (11) and the root fractions (Nz), and writes the input cotangents and
    the two parameter cotangents."""
    return ((3 * (2 * nz + 6) + 11 + nz) * cells + 2) * itemsize


def land_grad_model_fn(tp, grid):
    """``(log K_sat, k_mineral) -> model``: land_model "consistent" with its
    soil's saturated hydraulic conductivity exp(log K_sat) and mineral
    conductivity k_mineral."""
    from terrarium_tpu_torch.convert import with_differentiable_params

    base = land_model(tp, grid, "consistent")
    return lambda p: dataclasses.replace(base, soil=with_differentiable_params(
        base.soil, log_sat_hydraulic_cond=p[0], mineral_conductivity=p[1]))


def land_grad_params(tp):
    """The consistent composition's own log K_sat and k_mineral."""
    grid = tp.ColumnGrid.of(cells=1, spacing=tp.ExponentialSpacing(N=LAND_NZ), device="cpu")
    soil_ = land_model(tp, grid, "consistent").soil
    return (float(np.log(soil_.hydrology.hydraulic_properties.sat_hydraulic_cond)),
            float(soil_.energy.thermal_properties.conductivities.mineral))


def land_grad_sim(tp, cells, dtype, name):
    """LAND_GRAD_SCHEMES[name] on ``cells`` columns at latitudes evenly
    spaced from -60 to 80 degrees: static shortwave 900 cos(lat) / pi and
    air temperature T_mean = 28 max(cos lat, 0.05) - 8, longwave 330, rain
    4e-8, wind 3; initial temperature T_mean, saturation 0.6, carbon 2,
    vegetation fraction 0.5."""
    key, solver, dt = LAND_GRAD_SCHEMES[name]
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=LAND_NZ),
                            dtype=dtype, device="cuda")
    lat = np.linspace(-60.0, 80.0, cells)
    coslat = np.maximum(np.cos(np.deg2rad(lat)), 0.05)
    T_mean = 28.0 * coslat - 8.0
    fields = {"surface_longwave_down": 330.0, "rainfall": 4.0e-8, "windspeed": 3.0,
              "surface_shortwave_down": 900.0 * coslat / np.pi, "air_temperature": T_mean}
    stepper = (tp.ImplicitEuler(dt=dt, solver=solver) if key == "implicit"
               else tp.ForwardEuler(dt=dt))
    return tp.initialize(
        land_grad_model_fn(tp, grid)(land_grad_params(tp)), stepper,
        (tp.FieldInputSource(fields=fields),),
        initializers={"temperature": lambda x, z: T_mean[None, :] + 0.0 * z,
                      "saturation_water_ice": 0.6, "carbon_vegetation": 2.0,
                      "vegetation_area_fraction": 0.5})


def land_grad_value(tp, sim, name, params=None, grad=True, steps=GRAD_STEPS):
    """The loss mean(T) + mean(carbon) after ``steps`` steps of
    make_fused_grad_rollout (segments of GRAD_INNER) and, ``grad``, its
    gradient in (log K_sat, k_mineral) (float64 0-d leaves)."""
    from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout

    dt = LAND_GRAD_SCHEMES[name][2]
    p = tuple(torch.tensor(v, dtype=torch.float64, device="cuda", requires_grad=grad)
              for v in (params or land_grad_params(tp)))
    roll = make_fused_grad_rollout(land_grad_model_fn(tp, sim.model.grid), sim.timestepper,
                                   sim.ctx, sim.input_sources, steps=steps, dt=dt,
                                   inner_steps=GRAD_INNER)
    with torch.set_grad_enabled(grad):
        out = roll(sim.state, p)
        loss = out.temperature.mean() + out.prognostic["carbon_vegetation"].mean()
    if not grad:
        return float(loss)
    return (float(loss.detach()), *(float(g) for g in torch.autograd.grad(loss, p)))


def land_grad_operands(ls, land_inputs, sim, seed):
    """Carry, static inputs, root fraction, coordinates, parameters and
    seeded output cotangents (the live carry's) of a land gradient
    simulation."""
    carry, inputs, root, coords, params = land_operands(ls, land_inputs, sim)
    rng = np.random.default_rng(seed)
    dtype = sim.model.grid.dtype
    gout = {n: torch.as_tensor(rng.normal(size=tuple(carry[n].shape)), device="cuda").to(dtype)
            for n in sim.model.live_carry}
    return carry, inputs, root, coords, params, gout


def land_zero_discriminant(inputs, params):
    """The columns whose photosynthesis is gated off with a zero
    co-limitation discriminant under their static inputs (no shortwave, or
    air at or outside the stress window): there torch's autograd of the
    plain version gives NaN (ROADMAP Queue C) and the kernel the taken
    branch's derivative."""
    v = params.values
    SW = inputs["surface_shortwave_down"].values[0]
    Ta = inputs["air_temperature"].values[0]
    return (SW <= 0) | (Ta <= v["T_CO2_low"]) | (Ta >= v["T_CO2_high"])


def land_columns(ls, cols, carry, inputs, root, gout, dtype=None):
    """The columns ``cols`` of a land VJP's carry, static inputs, root
    fraction and output cotangents, contiguous (in ``dtype`` if given)."""
    def take(t):
        t = t[..., cols].contiguous()
        return t if dtype is None else t.to(dtype)

    return ({n: take(t) for n, t in carry.items()},
            {n: ls.LandInput(take(i.values), i.t0, i.dts) for n, i in inputs.items()},
            None if root is None else take(root), {n: take(t) for n, t in gout.items()})


def land_vjp_plain_chunks(lv, ls, carry, inputs, root, coords, params, dt, steps, gout, kw,
                          chunk):
    """The plain land VJP at full width, run in chunks of ``chunk``
    columns: the cotangents and the parameter cotangents' sums."""
    cells = carry["internal_energy"].shape[1]
    ref = {n: torch.empty_like(t) for n, t in carry.items()}
    pK = pskm = 0.0
    for lo in range(0, cells, chunk):
        cols = torch.arange(lo, min(lo + chunk, cells), device="cuda")
        c, i, r, g = land_columns(ls, cols, carry, inputs, root, gout)
        part, a, b = lv.land_column_segment_vjp_plain(c, i, r, *coords, params, dt, 0.0, steps,
                                                      g, **kw)
        for n in ref:
            ref[n][..., cols] = part[n]
        pK, pskm = pK + float(a), pskm + float(b)
    return ref, pK, pskm


def nonfinite_columns(fields):
    cells = next(iter(fields.values())).shape[-1]
    bad = torch.zeros(cells, dtype=torch.bool, device="cuda")
    for t in fields.values():
        bad |= ~torch.isfinite(t).all(0) if t.dim() == 2 else ~torch.isfinite(t)
    return bad


def land_vjp_compare(lv, ls, carry, inputs, root, coords, params, dt, steps, gout, kw,
                     rtol, chunk):
    """The land segment-VJP kernel against its plain version over ``steps``
    steps: the plain one in chunks of ``chunk`` columns. Columns where the
    plain version's cotangents are not finite must be zero-discriminant ones
    (land_zero_discriminant), where the kernel must be finite; the others
    are compared: each cotangent within ``rtol`` of its value plus ``rtol``
    of the field's largest magnitude, the parameter cotangents (without the
    columns left out) within ``rtol``. Returns the largest absolute errors,
    the largest over the magnitudes and the number of columns left out."""
    out_k, gK, gskm = lv.land_column_segment_vjp(carry, inputs, root, *coords, params, dt, 0.0,
                                                 steps, gout, **kw)
    ref, pK, pskm = land_vjp_plain_chunks(lv, ls, carry, inputs, root, coords, params, dt,
                                          steps, gout, kw, chunk)
    if bool(nonfinite_columns(out_k).any()):
        raise AssertionError("land VJP kernel produced a non-finite cotangent")
    bad = nonfinite_columns(ref)
    if bool((bad & ~land_zero_discriminant(inputs, params)).any()):
        raise AssertionError("the plain land VJP is non-finite outside the zero-discriminant "
                             "columns")
    keep = (~bad).nonzero().flatten()
    errs, rel = {}, {}
    for n in ref:
        a, b = (t[..., keep] for t in (out_k[n], ref[n]))
        scale = float(b.abs().max())
        errs[n] = float((a - b).abs().max())
        rel[n] = errs[n] / scale if scale > 0.0 else errs[n]
        if bool(((a - b).abs() > rtol * b.abs() + rtol * scale).any()):
            raise AssertionError(f"land VJP kernel vs plain {n}: max abs err {errs[n]}, "
                                 f"largest magnitude {scale}")
    kK, kskm = float(gK), float(gskm)
    if bool(bad.any()):  # the parameter cotangents without the columns left out
        c, i, r, g = land_columns(ls, bad.nonzero().flatten(), carry, inputs, root, gout)
        _, a, b = lv.land_column_segment_vjp(c, i, r, *coords, params, dt, 0.0, steps, g, **kw)
        kK, kskm = kK - float(a), kskm - float(b)
        c, i, r, g = land_columns(ls, keep, carry, inputs, root, gout)
        _, a, b = lv.land_column_segment_vjp_plain(c, i, r, *coords, params, dt, 0.0, steps, g,
                                                   **kw)
        pK, pskm = float(a), float(b)
    for n, a, b in (("K_sat", kK, pK), ("sk_mineral", kskm, pskm)):
        errs[n], rel[n] = abs(a - b), abs(a - b) / abs(b) if b != 0.0 else abs(a - b)
        if not b != 0.0 or abs(a - b) > rtol * abs(b):
            raise AssertionError(f"land VJP kernel vs plain {n}: {a} vs {b}")
    return errs, rel, int(bad.sum())


def land_vjp_compare_f32(lv, ls, tp, name, carry, inputs, root, coords, params, dt, steps,
                         gout, kw):
    """The float32 land segment-VJP kernel at full width against its plain
    version (in chunks of LAND_GRAD_CHUNK columns): each cotangent within
    F32_VJP_REL_TOL of its field's largest magnitude, and the parameter
    cotangents within F32_VJP_REL_TOL. A column where the two part by more
    (a branch that flips between two float32 roundings: the freeze plateau's
    edge in dT/dU, saturation in d(Psi)/d(sat)) is held to a float64 plain
    referee from the same float32 operands instead: the kernel within twice
    the plain version's own float32 error plus the tolerance; such columns
    leave the parameter sums of both. Returns the errors, the errors over
    the magnitudes, and the flip columns' count with the plain version's
    largest float32 error there over each field's magnitude."""
    out_k, gK, gskm = lv.land_column_segment_vjp(carry, inputs, root, *coords, params, dt, 0.0,
                                                 steps, gout, **kw)
    ref, pK, pskm = land_vjp_plain_chunks(lv, ls, carry, inputs, root, coords, params, dt,
                                          steps, gout, kw, LAND_GRAD_CHUNK)
    if bool(nonfinite_columns(out_k).any()) or bool(nonfinite_columns(ref).any()):
        raise AssertionError(f"{name}: a non-finite float32 cotangent")
    cells = carry["internal_energy"].shape[1]
    flip = torch.zeros(cells, dtype=torch.bool, device="cuda")
    scales = {n: float(ref[n].abs().max()) for n in ref}
    for n in ref:
        beyond = (out_k[n] - ref[n]).abs() > F32_VJP_REL_TOL * scales[n]
        flip |= beyond.any(0) if beyond.dim() == 2 else beyond
    keep = (~flip).nonzero().flatten()
    errs, rel = {}, {}
    for n in ref:
        errs[n] = float((out_k[n][..., keep] - ref[n][..., keep]).abs().max())
        rel[n] = errs[n] / scales[n] if scales[n] > 0.0 else errs[n]
    flips = {"columns": int(flip.sum())}
    kK, kskm = float(gK), float(gskm)
    if bool(flip.any()):
        cols = flip.nonzero().flatten()
        f64 = torch.float64
        c, i, r, g = land_columns(ls, cols, carry, inputs, root, gout, dtype=f64)
        p64 = ls.LandParams.of(params.model, f64)
        c64 = tuple(t.to(f64) for t in coords)
        truth, _, _ = lv.land_column_segment_vjp_plain(c, i, r, *c64, p64, dt, 0.0, steps, g,
                                                       **kw)
        for n in ref:
            k_err = (out_k[n][..., cols].double() - truth[n]).abs()
            p_err = (ref[n][..., cols].double() - truth[n]).abs()
            if bool((k_err > 2.0 * p_err + F32_VJP_REL_TOL * scales[n]).any()):
                raise AssertionError(f"{name}: float32 kernel vs the float64 referee {n} at "
                                     f"the flip columns: {float(k_err.max())} against the "
                                     f"plain version's {float(p_err.max())}")
            flips[n] = float(p_err.max()) / scales[n] if scales[n] > 0.0 else 0.0
        c, i, r, g = land_columns(ls, cols, carry, inputs, root, gout)
        _, a, b = lv.land_column_segment_vjp(c, i, r, *coords, params, dt, 0.0, steps, g, **kw)
        kK, kskm = kK - float(a), kskm - float(b)
        _, a, b = lv.land_column_segment_vjp_plain(c, i, r, *coords, params, dt, 0.0, steps, g,
                                                   **kw)
        pK, pskm = pK - float(a), pskm - float(b)
    for n, a, b in (("K_sat", kK, pK), ("sk_mineral", kskm, pskm)):
        errs[n], rel[n] = abs(a - b), abs(a - b) / abs(b) if b != 0.0 else abs(a - b)
        if not b != 0.0 or abs(a - b) > F32_VJP_REL_TOL * abs(b):
            raise AssertionError(f"{name}: float32 kernel vs plain {n}: {a} vs {b}")
    return errs, rel, flips


_T0 = time.perf_counter()


def phase(name, **fields):
    """One phase's line, with the seconds since the script started."""
    print(json.dumps({"phase": name, "t_s": time.perf_counter() - _T0, **fields}), flush=True)


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
    reduction, the land and full-step entries their one kernel."""
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
            elif "full_step_kernel" in name:
                key = "full_step"
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


def land_variant(tp, ls, name):
    """The stepper, the kernel wrapper and the plain version of
    ``LAND_VARIANTS[name]``, the last two as partials taking
    ``land_column_rollout``'s arguments."""
    key, solver, _ = LAND_VARIANTS[name]
    kw = {"solver": solver} if solver else {}
    stepper = tp.Heun(dt=LAND_DT) if key == "heun" else tp.ImplicitEuler(dt=LAND_DT, **kw)
    return (stepper, functools.partial(ls.ROLLOUTS[key], **kw),
            functools.partial(ls.land_column_rollout_plain, stepper=key, **kw))


def land_snow_golden_sim(tp):
    """`tests/test_goldens.py:52-64`: 4 cells, Nz 12, float64, bare ground,
    Richards flow over the default hydraulics, ``Snowpack()``."""
    grid = tp.ColumnGrid.of(cells=4, spacing=tp.ExponentialSpacing(N=12),
                            dtype=torch.float64, device="cuda")
    model = tp.LandModel(grid=grid, snow=tp.Snowpack(), soil=tp.SoilEnergyWaterCarbon(
        hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq())))
    return tp.initialize(
        model, tp.ForwardEuler(),
        initializers={"temperature": 1.0, "saturation_water_ice": 0.6,
                      "snow_water_equivalent": 0.02},
        input_sources=(tp.FieldInputSource(fields={
            "air_temperature": 4.0, "snowfall": 5.0e-8, "surface_shortwave_down": 250.0}),))


def land_golden_sim(tp):
    """`tests/test_goldens.py:40-49`: 4 cells, Nz 15, float64, bare ground."""
    grid = tp.ColumnGrid.of(cells=4, spacing=tp.ExponentialSpacing(N=15),
                            dtype=torch.float64, device="cuda")
    return tp.initialize(
        land_model(tp, grid, "bare"), tp.ForwardEuler(),
        initializers={"temperature": 5.0, "saturation_water_ice": 0.8},
        input_sources=(tp.FieldInputSource(fields={
            "surface_shortwave_down": 400.0, "air_temperature": 12.0, "rainfall": 1.0e-7}),))


def land_sim(tp, cells, dtype, composition, device="cuda", stepper=None, snow=False):
    """`bench_configs.py:228-267` on ``cells`` columns at latitudes evenly
    spaced from -60 to 80 degrees: loam, Richards flow, Nz 20, ForwardEuler at
    dt 600 s (or ``stepper``); hourly (744, cells) series of shortwave 900
    cos(lat) max(0, sin(2 pi (t/day - 0.25))) and air temperature T_mean + 6
    sin(2 pi (t/day - 0.3)), T_mean = 28 max(cos lat, 0.05) - 8, made on the
    card in float64 and rounded once; static longwave 330, rain 4e-8, wind 3;
    initial temperature T_mean, saturation 0.6, carbon 2, vegetation fraction
    0.5. ``snow``: with ``Snowpack()``, a static snowfall of 2e-8 m/s beside
    the rain and an initial SWE of 0.02 m (``land_snow_n145``)."""
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
    fields = {"surface_longwave_down": 330.0, "rainfall": 4.0e-8, "windspeed": 3.0}
    inits = {"temperature": lambda x, z: T_mean[None, :] + 0.0 * z,
             "saturation_water_ice": 0.6, "carbon_vegetation": 2.0,
             "vegetation_area_fraction": 0.5}
    model = land_model(tp, grid, composition)
    if snow:
        model = dataclasses.replace(model, snow=tp.Snowpack())
        fields["snowfall"] = SNOWFALL
        inits["snow_water_equivalent"] = SWE0
    return tp.initialize(
        model, stepper if stepper is not None else tp.ForwardEuler(dt=LAND_DT),
        (forcing, tp.FieldInputSource(fields=fields)), initializers=inits)


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


def land_teacher(ls, fs, carry, inputs, root, coords, params, t_start, steps, tolerance,
                 kernel=None, plain=None, dt=LAND_DT):
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
    per step the share of columns outside [0, 1]. ``kernel`` and ``plain``
    are the wrapper and plain version of the stepper (ForwardEuler's by
    default), called as ``land_column_rollout`` is, with steps of ``dt``."""
    kernel = kernel or ls.land_column_rollout
    plain = plain or ls.land_column_rollout_plain
    dtype = carry["internal_energy"].dtype
    t = (np.float32 if dtype == torch.float32 else np.float64)(t_start)
    cp, chain = dict(carry), dict(carry)
    worst_abs, worst, ulps, seen, beyond, outside_share = {}, {}, {}, {}, [], []
    branches = dict.fromkeys(LAND_OPS_BRANCH, 0)
    for i in range(steps):
        k1 = kernel(cp, inputs, root, *coords, params, dt, float(t), 1)
        p1 = plain(cp, inputs, root, *coords, params, dt, float(t), 1)
        chain = {**chain, **kernel(chain, inputs, root, *coords, params, dt, float(t), 1)}
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
        t = t + t.dtype.type(dt)
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


def land_variant_compare(tp, ls, fs, land_inputs, vname, ptxas_all, card):
    """``LAND_VARIANTS[vname]``'s kernel against its plain version one step
    at a time along the plain trajectory (float64 on LAND_F64_CELLS columns
    at 1e-12 and float32 at full width by land_f32_tolerance, Heun's at
    LAND_HEUN_F32_DT), one launch against the chain of one-step launches,
    and timed; prints the phase and returns what the kernel report reads."""
    vkey, vsolver, vsnow = LAND_VARIANTS[vname]
    stepper, kernel, plain = land_variant(tp, ls, vname)
    res = {}
    for dtype, cells, tol in ((torch.float64, LAND_F64_CELLS, land_f64_tolerance),
                              (torch.float32, LAND_CELLS, land_f32_tolerance)):
        dt = LAND_HEUN_F32_DT if vkey == "heun" and dtype == torch.float32 else LAND_DT
        sim = land_sim(tp, cells, dtype, "consistent", stepper=stepper, snow=vsnow)
        carry, linputs, root, coords, params = land_operands(ls, land_inputs, sim)
        t_start = float(sim.state.clock.time)
        res[dtype] = land_teacher(ls, fs, carry, linputs, root, coords, params, t_start,
                                  LAND_VARIANT_STEPS, tol, kernel=kernel, plain=plain, dt=dt)
    v_abs, v_rel, v_ulps, v_seen, v_beyond, chain, v_runs, v_out = res[torch.float32]
    f64_abs, f64_rel, _, _, f64_beyond, *_ = res[torch.float64]
    out_k = kernel(carry, linputs, root, *coords, params, dt, t_start, LAND_VARIANT_STEPS)
    torch.cuda.synchronize()
    chain_equal = all(torch.equal(out_k[n], chain[n]) for n in sim.model.live_carry)
    finite = all(bool(torch.isfinite(out_k[n]).all()) for n in sim.model.live_carry)
    v_ms = cuda_ms(lambda: kernel(carry, linputs, root, *coords, params, LAND_DT, t_start,
                                  LAND_VARIANT_STEPS), reps=3, warmup=True)
    v_ms_144 = cuda_ms(lambda: kernel(carry, linputs, root, *coords, params, LAND_DT, t_start,
                                      COMPARE_STEPS), reps=3)
    v_plain_ms = cuda_ms(lambda: plain(carry, linputs, root, *coords, params, LAND_DT, t_start,
                                       LAND_VARIANT_STEPS))
    v_rows = series_rows_read(fs.SeriesBC(linputs["air_temperature"].values, 0.0, SERIES_DTS,
                                          t_start, LAND_VARIANT_STEPS), LAND_DT,
                              stages=2 if vkey == "heun" else 1)
    v_ops = land_variant_ops(vkey, vsolver, vsnow, LAND_NZ, v_runs)
    v_b = bound_ms(v_ops * LAND_CELLS * LAND_VARIANT_STEPS,
                   2 * sum(t.numel() for t in carry.values()) * 4 + 2 * v_rows * LAND_CELLS * 4)
    entry = "_".join(("land_column_rollout", *((vkey, vsolver) if vsolver else (vkey,)),
                      *params.tags, "f32", f"nz{LAND_NZ}"))
    ptxas = ptxas_all["land_column_rollout"].get(entry, {}).get("land")
    phase(f"{vname}_compare", cells=LAND_CELLS, nz=LAND_NZ, dt=LAND_DT, f32_check_dt=dt,
          steps=LAND_VARIANT_STEPS, f64_cells=LAND_F64_CELLS, f64_rtol=1e-12,
          f64_max_abs_err=f64_abs, f64_max_err_over_magnitude=f64_rel,
          f64_beyond=f64_beyond[:12], rel_tol=F32_REL_TOL, max_abs_err=v_abs,
          max_err_over_magnitude=v_rel, max_err_in_ulps_inside_unit=v_ulps,
          f32_beyond=v_beyond[:12], f32_steps_a_zeroed_change_fails=v_seen,
          one_launch_equals_step_chain=chain_equal, one_launch_finite=finite,
          kernel_ms=v_ms, kernel_ms_144_steps=v_ms_144, plain_ms=v_plain_ms,
          bound_ms=v_b[0], bound_by=v_b[1], ops_per_column_step=v_ops,
          branch_runs_per_column_step=v_runs, series_rows_read=v_rows, ptxas=ptxas,
          outside_unit_share_at_step={i: v_out[i - 1] for i in (1, 2, 3, 4, 12, 48)
                                      if i <= len(v_out)},
          card=card)
    if f64_beyond or v_beyond or not chain_equal or not finite:
        raise AssertionError(f"{vname} kernel vs plain: f64 {f64_beyond[:4]}, f32 "
                             f"{v_beyond[:4]}, one launch equals the step chain: "
                             f"{chain_equal}, finite: {finite}")
    return dict(key=vkey, solver=vsolver, snow=vsnow, max_abs_err=v_abs, ms=v_ms,
                ms_144=v_ms_144, plain_ms=v_plain_ms, bound_ms=v_b[0], bound_by=v_b[1],
                ops=v_ops, ptxas=ptxas)


def land_stepper_main_path(tp, ls, land_inputs, mname, vname, var, reset_counts, launched,
                           card):
    """``LAND_VARIANTS[vname]`` on land_consistent's composition and forcing
    through ``Simulation.run``: one timed 1,440-step block from the initial
    state after a 3-step launch from the same state (the warm-up), whose
    carry gives the share of columns with a saturation layer outside [0, 1]
    at step 3; the block's own carry, launched again after the counts were
    read, gives it at step 1,440. Prints the phase ``mname`` and returns
    the block's launches of the stepper's kernel."""
    vkey, vsolver, vsnow = LAND_VARIANTS[vname]
    stepper, kernel, _ = land_variant(tp, ls, vname)
    wrapper = ls.ROLLOUTS[vkey]
    sim = land_sim(tp, LAND_CELLS, torch.float32, "consistent", stepper=stepper, snow=vsnow)
    carry, linputs, root, coords, params = land_operands(ls, land_inputs, sim)
    t_start = float(sim.state.clock.time)
    share_3 = float(outside_unit(kernel(carry, linputs, root, *coords, params, LAND_DT,
                                        t_start, 3)).float().mean())
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sim.run(steps=LAND_BLOCK_STEPS)
    torch.cuda.synchronize()
    m_s = time.perf_counter() - t0
    m_launches = wrapper.launches
    if launched() != {wrapper.__name__: 1}:
        raise AssertionError(f"{mname}: the block launched {launched()}, expected one "
                             f"{wrapper.__name__}")
    st = sim.state
    for name in sim.model.live_carry + ("temperature",):
        if not bool(torch.isfinite(st[name]).all()):
            raise AssertionError(f"{mname}: {name} non-finite")
    if sim.iteration != LAND_BLOCK_STEPS:
        raise AssertionError(f"{mname}: clock iteration {sim.iteration}")
    end = kernel(carry, linputs, root, *coords, params, LAND_DT, t_start, LAND_BLOCK_STEPS)
    snow_fields = {}
    if vsnow:
        swe = st.snow_water_equivalent
        snow_fields = dict(snow_covered_share=float((swe > 0).float().mean()),
                           swe_range_m=[float(swe.min()), float(swe.max())])
    phase(mname, composition="consistent", stepper=type(stepper).__name__,
          solver=vsolver, snow=vsnow, cells=LAND_CELLS, nz=LAND_NZ, dt=LAND_DT,
          steps=LAND_BLOCK_STEPS, seconds=m_s, launches=m_launches,
          cells_steps_per_s=LAND_CELLS * LAND_BLOCK_STEPS / m_s,
          kernel_ms_144_steps=var["ms_144"], ptxas=var["ptxas"],
          outside_unit_share_at_step={3: share_3,
                                      LAND_BLOCK_STEPS: float(outside_unit(end).float().mean())},
          land_consistent_outside_unit_share={3: 0.9528, "after its block": 0.9189},
          saturation_range_at_end=[float(end["saturation_water_ice"].min()),
                                   float(end["saturation_water_ice"].max())],
          skin_range=[float(st.skin_temperature.min()), float(st.skin_temperature.max())],
          **snow_fields, card=card)
    return m_launches


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


def scheme_model_fn(tp, name, grid):
    """``param -> model`` of a GRAD_SCHEMES configuration: log K_sat for
    heat + Richards (grad_model), k_mineral for the heat-only default
    model."""
    from terrarium_tpu_torch.convert import with_differentiable_params

    if GRAD_SCHEMES[name]["physics"] == "heat":
        return lambda k: tp.SoilModel(grid=grid, soil=with_differentiable_params(
            tp.SoilEnergyWaterCarbon(), mineral_conductivity=k))
    return lambda x: grad_model(tp, grid, x)


def scheme_sim(tp, name, cells, nz, dtype):
    cfg = GRAD_SCHEMES[name]
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=dtype,
                            device="cuda")
    heat = cfg["physics"] == "heat"
    ts = {"heun": tp.Heun(dt=cfg["dt"]), "euler": tp.ForwardEuler(dt=cfg["dt"]),
          "implicit": tp.ImplicitEuler(dt=cfg["dt"], solver=cfg["solver"])}[cfg["stepper"]]
    return tp.initialize(
        scheme_model_fn(tp, name, grid)(K_MINERAL if heat else LOG_KSAT), ts,
        initializers={"temperature": -1.0, "saturation_water_ice": 0.8 if heat else (
            lambda x, z: np.minimum(1.0, 0.6 - 0.04 * z))},
        boundary_conditions=tp.PrescribedSurfaceTemperature(4.0))


def scheme_value(tp, name, sim, fused=True, remat_fn=False):
    """The loss after GRAD_STEPS steps and its gradient in the parameter:
    through make_fused_grad_rollout (kernels), or, ``remat_fn``, the port's
    make_rollout_fn(remat=True) (torch autograd through the modules)."""
    from terrarium_tpu_torch.timesteppers.autodiff import make_rollout_fn
    from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout

    cfg = GRAD_SCHEMES[name]
    heat = cfg["physics"] == "heat"
    grid = sim.model.grid
    p = torch.tensor(K_MINERAL if heat else LOG_KSAT, dtype=torch.float64, device="cuda",
                     requires_grad=True)
    model_fn = scheme_model_fn(tp, name, grid)
    if remat_fn:
        out = make_rollout_fn(model_fn(p), sim.timestepper, sim.ctx, steps=GRAD_STEPS,
                              remat=True)(sim.state, cfg["dt"])
    else:
        out = make_fused_grad_rollout(model_fn, sim.timestepper, sim.ctx, steps=GRAD_STEPS,
                                      dt=cfg["dt"], inner_steps=GRAD_INNER)(sim.state, p)
    loss = out.temperature.mean()
    if not heat:
        loss = loss + out.saturation_water_ice.mean()
    (g,) = torch.autograd.grad(loss, p)
    return float(loss.detach()), float(g)


def scheme_operands(fs, name, sim, seed):
    """Carry, one segment's BC table (Heun: one row more), coordinates,
    parameters, seeded output cotangents and the scheme's keywords of a
    GRAD_SCHEMES simulation."""
    cfg = GRAD_SCHEMES[name]
    heat = cfg["physics"] == "heat"
    g = sim.model.grid
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    st = sim.state
    carry = (st.prognostic["internal_energy"].contiguous(), st["saturation_water_ice"].contiguous(),
             None if heat else st.prognostic["surface_excess_water"].contiguous())
    table = torch.full((GRAD_INNER + (cfg["stepper"] == "heun"),), 4.0, dtype=g.dtype,
                       device="cuda")
    rng = np.random.default_rng(seed)
    cts = tuple(None if t is None else
                torch.as_tensor(rng.normal(size=tuple(t.shape)), device="cuda").to(g.dtype)
                for t in carry)
    kw = dict(stepper=cfg["stepper"], physics=cfg["physics"], solver=cfg["solver"])
    return carry, table, coords, fs.ColumnParams.of(sim.model, g.dtype), cts, kw


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


def full_sim(tp, cells, nz, dtype, stepper, physics, forcings=None):
    """The bench top temperature 5 sin(2 pi t / 86400) as f(t) over the
    bench soil (``physics="richards"``) or the default heat-only model, from
    varied columns (`tests/test_goldens.py:20-36`'s initial temperature,
    saturation min(1, 0.6 - 0.05 z), and 0.8 for heat only), dt 60 s."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=dtype,
                            device="cuda")
    model = (tp.SoilModel(grid=grid, soil=soil(tp)) if physics == "richards"
             else tp.SoilModel(grid=grid))
    ts = tp.Heun(dt=BENCH_DT) if stepper == "heun" else tp.ForwardEuler(dt=BENCH_DT)
    return tp.initialize(
        model, ts, initializers={
            "temperature": lambda x, z: 2.0 * np.sin(2 * np.pi * x) - 0.05 * z,
            "saturation_water_ice": (lambda x, z: np.minimum(1.0, 0.6 - 0.05 * z))
            if physics == "richards" else 0.8},
        boundary_conditions=tp.PrescribedSurfaceTemperature(
            lambda t: 5.0 * torch.sin(2 * torch.pi * t / 86400.0)), forcings=forcings)


def check_full_step(name, k_state, p_state, rtol, dt):
    """Every prognostic, tendency and auxiliary of the kernel's step against
    the plain version's, and the clock. float64 (``rtol`` <= 1e-9): each
    element within ``rtol`` of it with a floor of ``rtol`` times the leaf's
    scale; float32: the largest error within ``rtol`` of the scale. The
    scale is the leaf's largest magnitude; a tendency's is at least its
    prognostic's over dt, the precision the step gives the prognostic (a
    tendency is a difference of nearly equal fluxes, whose rounding is that
    of the fluxes)."""
    errs = {}
    groups = ("prognostic", "tendencies", "auxiliary")
    for g in groups:
        if sorted(getattr(k_state, g)) != sorted(getattr(p_state, g)):
            raise AssertionError(f"{name}: {g} leaves {sorted(getattr(k_state, g))}")
        for key, b in getattr(p_state, g).items():
            a = getattr(k_state, g)[key]
            if tuple(a.shape) != tuple(b.shape) or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name}: {g}/{key} of shape {tuple(a.shape)} or "
                                     f"non-finite")
            scale = float(b.abs().max())
            if g == "tendencies":
                scale = max(scale, float(p_state.prognostic[key].abs().max()) / dt)
            d = (a - b).abs()
            errs[f"{g}/{key}"] = float(d.max())
            bad = (bool((d > rtol * b.abs() + rtol * scale).any()) if rtol <= 1e-9
                   else float(d.max()) > rtol * scale)
            if bad:
                raise AssertionError(f"{name} kernel vs plain {g}/{key}: max abs err "
                                     f"{float(d.max())}, scale {scale}")
    if (float(k_state.clock.time) != float(p_state.clock.time)
            or int(k_state.clock.iteration) != int(p_state.clock.iteration)):
        raise AssertionError(f"{name}: clock {k_state.clock.time} vs {p_state.clock.time}")
    return errs


def cuda_ms_each(fn, reps):
    """CUDA-event time of each of ``reps`` calls of ``fn()`` after one
    warm-up, in ms."""
    fn()
    out = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


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
    from terrarium_tpu_torch.ops import land_vjp as lv
    from terrarium_tpu_torch.timesteppers.integrator import (advance, clock_times, land_inputs,
                                                             top_temperature_table)

    KERNELS = (fs.soil_column_rollout, fs.soil_column_heun_rollout,
               fs.soil_column_heat_rollout, fs.soil_column_implicit_rollout,
               fv.soil_column_segment_vjp, ls.land_column_rollout, ls.land_column_heun_rollout,
               ls.land_column_implicit_rollout, fs.soil_column_full_step,
               lv.land_column_segment_vjp)

    def reset_counts():
        for fn in KERNELS:
            fn.launches = 0

    def launched():
        return {fn.__name__: fn.launches for fn in KERNELS if fn.launches}

    # ---- build: one nvcc per source, in parallel
    t0 = time.perf_counter()
    names = tuple(cuda_build.INSTANTIATIONS)
    cuda_build.build(*names)
    ptxas_all = {n: ptxas_summary(cuda_build.ptxas_report(n)) for n in names}
    phase("build", seconds=time.perf_counter() - t0, instantiations=sum(
        len(cuda_build.INSTANTIATIONS[n]) for n in names), ptxas=ptxas_all)

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

    # ---- land_snow golden through the land kernel (Simulation.run, one
    # launch) and through the plain version. The snowpack's fields, which no
    # soil field feeds, against the golden at 1e-12; every field of the
    # kernel's run against the plain version's at 1e-12. The soil's energy
    # and saturation are compared with the golden but not held to it: its
    # explicit Richards step is unstable at dt 300 and free runs part from
    # it (JAX's own 48 single steps by 0.77 in saturation; ROADMAP Queue C)
    sgold = np.load(LAND_SNOW_GOLDEN)
    runs_ = {}
    for route in ("kernel", "plain"):
        sim = land_snow_golden_sim(tp)
        if route == "kernel":
            reset_counts()
            sim.run(steps=48, dt=300.0)
            torch.cuda.synchronize()
            if launched() != {"land_column_rollout": 1}:
                raise AssertionError(f"land snow golden: launches {launched()}")
        else:
            advance(sim.model, sim.state, sim.ctx, 48, 300.0, input_sources=sim.input_sources,
                    plain=True)
            sim.compute_auxiliary()
        runs_[route] = {f: sim.state[f].cpu().numpy() for f in (
            *sgold.files, *sim.model.live_carry)}
    to_golden = {f: float(np.max(np.abs(runs_["kernel"][f] - sgold[f]))) for f in sgold.files}
    for f in ("snow_water_equivalent", "snow_cover_fraction", "surface_shortwave_up"):
        np.testing.assert_allclose(runs_["kernel"][f], sgold[f], rtol=1e-12, atol=1e-12,
                                   err_msg=f"land snow golden: {f}")
    to_plain = {}
    for f, a in runs_["kernel"].items():
        b = runs_["plain"][f]
        to_plain[f] = float(np.max(np.abs(a - b)))
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * float(np.max(np.abs(b))),
                                   err_msg=f"land snow golden kernel vs plain: {f}")
    phase("land_snow_golden", steps=48, dt=300.0, launches=1, rtol=1e-12,
          kernel_vs_golden_max_abs_err=to_golden, kernel_vs_plain_max_abs_err=to_plain,
          held_to_golden=["snow_water_equivalent", "snow_cover_fraction",
                          "surface_shortwave_up"])
    del sim, runs_

    # ---- the land kernel's other steppers, each against its plain version
    # one step at a time along the plain trajectory (float64 on 1,024
    # columns at 1e-12, float32 at full width by land_f32_tolerance), one
    # launch against the chain of one-step launches, and timed
    land_var = {vname: land_variant_compare(tp, ls, fs, land_inputs, vname, ptxas_all, card)
                for vname in LAND_VARIANTS}

    # ---- the land main paths of the other steppers: land_consistent's
    # composition and forcing through Simulation.run with Heun, with
    # ImplicitEuler (PCR, Thomas) and, with PCR, under a snowpack
    # (land_snow_n145), each one timed 1,440-step block from the initial
    # state after a 3-step warm-up launch from the same state, whose carry
    # gives the share of columns with a saturation layer outside [0, 1] at
    # step 3; the block's own carry, launched again after the counts were
    # read, gives it at step 1,440
    for mname, vname in (("land_implicit_pcr", "land_implicit_pcr"),
                         ("land_implicit_thomas", "land_implicit_thomas"),
                         ("land_heun", "land_heun"), ("land_snow_n145", "land_snow_implicit_pcr")):
        land_var[vname]["launches"] = land_stepper_main_path(
            tp, ls, land_inputs, mname, vname, land_var[vname], reset_counts, launched, card)

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

    # ---- the segment VJP of the other schemes (Heun, ImplicitEuler with each
    # solver, ForwardEuler over the heat-only model), each: the kernel
    # against its plain version, one 48-step segment, at float64 on
    # GRAD_COMPARE_CELLS columns (the scheme's float64 Nz), with the water
    # identity through the kernel (heat + Richards), and at float32 at full
    # width (the plain version in chunks of GRAD_SCHEME_CHUNK columns); then
    # the scheme's gradient at full width: one warm-up, the median of 5
    schemes = {}
    for name, cfg in GRAD_SCHEMES.items():
        heat, dt = cfg["physics"] == "heat", cfg["dt"]
        sim = scheme_sim(tp, name, GRAD_COMPARE_CELLS, cfg["f64_nz"], torch.float64)
        carry, table, coords, params, cts, kw = scheme_operands(fs, name, sim, seed=7)
        out_k = fv.soil_column_segment_vjp(*carry, table, *coords, params, dt, *cts, **kw)
        out_p = fv.soil_column_segment_vjp_plain(*carry, table, *coords, params, dt, *cts, **kw)
        torch.cuda.synchronize()
        f64_err = {}
        for vname, a, b in zip(vjp_names, out_k, out_p):
            if b is None:
                continue
            scale = float(b.abs().max())
            f64_err[vname] = float((a - b).abs().max())
            if (not bool(torch.isfinite(a).all())
                    or bool(((a - b).abs() > 1e-9 * b.abs() + 1e-12 * scale).any())):
                raise AssertionError(f"{name}: VJP kernel vs plain {vname} (f64): max abs err "
                                     f"{f64_err[vname]}, largest magnitude {scale}")
        if heat and (out_k[2] is not None or float(out_k[3]) != 0.0):
            raise AssertionError(f"{name}: the heat-only VJP gave a pool or K_sat cotangent")
        ident = None
        if not heat:  # the cotangents (0, dz, 1) of the total water
            dz = coords[0][:, None].expand_as(carry[1]).contiguous()
            _, gsat, gS, _, _ = fv.soil_column_segment_vjp(
                *carry, table, *coords, params, dt, torch.zeros_like(carry[0]), dz,
                torch.ones_like(carry[2]), **kw)
            ident = max(float(((gsat - dz).abs() / dz).max()), float((gS - 1.0).abs().max()))
            ident_tol = 1e-12 if cfg["stepper"] == "heun" else 1e-10
            if ident > ident_tol or not bool((carry[1] == 1.0).any()):
                raise AssertionError(f"{name}: water identity through the VJP kernel {ident}")
        del sim, carry, out_k, out_p
        gsim = scheme_sim(tp, name, GRAD_CELLS, BENCH_NZ, torch.float32)
        carry, table, coords, params, cts, kw = scheme_operands(fs, name, gsim, seed=11)
        out_k = fv.soil_column_segment_vjp(*carry, table, *coords, params, dt, *cts, **kw)

        def cols_of(ts, cols):
            return tuple(None if t is None else t[..., cols].contiguous() for t in ts)

        ref = [None if t is None else torch.empty_like(t) for t in carry] + [0.0, 0.0]
        for lo in range(0, GRAD_CELLS, GRAD_SCHEME_CHUNK):
            cols = slice(lo, lo + GRAD_SCHEME_CHUNK)
            part = fv.soil_column_segment_vjp_plain(*cols_of(carry, cols), table, *coords,
                                                    params, dt, *cols_of(cts, cols), **kw)
            for i in range(3):
                if ref[i] is not None:
                    ref[i][..., cols] = part[i]
            ref[3] += float(part[3])
            ref[4] += float(part[4])
        f32_err, f32_rel = {}, {}
        for vname, a, b in zip(vjp_names, out_k, ref):
            if b is None:
                continue
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name}: VJP kernel produced non-finite {vname}")
            if isinstance(b, float):
                err, scale = abs(float(a) - b), abs(b)
            else:
                err, scale = float((a - b).abs().max()), float(b.abs().max())
            f32_err[vname], f32_rel[vname] = err, err / scale if scale > 0.0 else err
            if err > F32_VJP_REL_TOL * scale:
                raise AssertionError(f"{name}: VJP kernel vs plain {vname} (f32 full width): "
                                     f"max abs err {err}, largest magnitude {scale}")
        fwd = fs.ROLLOUTS[cfg["stepper"], cfg["physics"]]
        fkw = {"solver": cfg["solver"]} if cfg["stepper"] == "implicit" else {}
        k_ms = cuda_ms(lambda: fv.soil_column_segment_vjp(*carry, table, *coords, params, dt,
                                                          *cts, **kw), reps=3, warmup=True)
        first = slice(0, GRAD_SCHEME_CHUNK)
        p_ms = cuda_ms(lambda: fv.soil_column_segment_vjp_plain(
            *cols_of(carry, first), table, *coords, params, dt, *cols_of(cts, first), **kw))
        f_ms = cuda_ms(lambda: fwd(*carry, table, *coords, params, dt, **fkw), reps=3,
                       warmup=True)
        b = bound_ms(scheme_vjp_ops(name, BENCH_NZ) * GRAD_CELLS * GRAD_INNER,
                     scheme_vjp_bytes(name, BENCH_NZ, GRAD_CELLS, 4, table.numel()))
        del out_k, ref, part
        # the gradient: 6 forward and 6 VJP launches
        scheme_value(tp, name, gsim)
        torch.cuda.synchronize()
        times, launches = [], {}
        for i in range(5):
            reset_counts()
            t0 = time.perf_counter()
            value, grad = scheme_value(tp, name, gsim)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == 0:
                launches = launched()
        segments = GRAD_STEPS // GRAD_INNER
        if launches != {fwd.__name__: segments, "soil_column_segment_vjp": segments}:
            raise AssertionError(f"{name}: the gradient launched {launches}")
        if not (np.isfinite(value) and np.isfinite(grad) and grad != 0.0):
            raise AssertionError(f"{name}: value {value}, gradient {grad}")
        med = float(np.median(times))
        entry = cuda_build._entry_name("soil_column_segment_vjp", fv._check_scheme(
            cfg["stepper"], cfg["physics"], cfg["solver"]), torch.float32, BENCH_NZ)
        extra = {}
        if heat:  # the route JAX times for grad_n145_heat: make_rollout_fn(remat=True)
            scheme_value(tp, name, gsim, remat_fn=True)
            torch.cuda.synchronize()
            reset_counts()
            remat_s = []
            for _ in range(2):
                t0 = time.perf_counter()
                r_value, r_grad = scheme_value(tp, name, gsim, remat_fn=True)
                torch.cuda.synchronize()
                remat_s.append(time.perf_counter() - t0)
            if launched():
                raise AssertionError(f"{name}: make_rollout_fn launched {launched()}")
            extra = dict(make_rollout_fn_seconds=remat_s, make_rollout_fn_loss=r_value,
                         make_rollout_fn_grad=r_grad,
                         make_rollout_fn_rel_diff=abs(r_grad - grad) / abs(r_grad))
        schemes[name] = dict(launches=launches["soil_column_segment_vjp"],
                             max_abs_err=max(f32_err.values()), ms=k_ms, plain_ms=p_ms,
                             bound_ms=b[0], bound_by=b[1], entry=entry)
        phase(name, cells=GRAD_CELLS, nz=BENCH_NZ, dt=dt, steps=GRAD_STEPS,
              inner_steps=GRAD_INNER, stepper=cfg["stepper"], solver=cfg["solver"],
              physics=cfg["physics"], seconds_median=med, seconds=times, launches=launches,
              cells_steps_per_s=GRAD_CELLS * GRAD_STEPS / med, loss=value,
              dloss_dparam=grad, param="k_mineral" if heat else "log_K_sat",
              vjp_segment_ms=k_ms, fwd_segment_ms=f_ms, plain_vjp_ms=p_ms,
              plain_cells=GRAD_SCHEME_CHUNK, bound_ms=b[0], bound_by=b[1],
              ops_per_column_step=scheme_vjp_ops(name, BENCH_NZ),
              ptxas=ptxas_all["soil_column_segment_vjp"].get(entry, {}).get("vjp"),
              f64_cells=GRAD_COMPARE_CELLS, f64_nz=cfg["f64_nz"], f64_rtol=1e-9,
              f64_max_abs_err=f64_err, water_identity_rel_err=ident,
              f32_rel_tol=F32_VJP_REL_TOL, f32_max_abs_err=f32_err,
              f32_max_err_over_magnitude=f32_rel, card=card, **extra)
        del gsim, carry, table, cts

    # ---- the LandModel's gradient path (LAND_GRAD_SCHEMES): the land
    # segment-VJP kernel against its plain version (float64 on
    # LAND_F64_CELLS columns, one segment; float32 at full width, the plain
    # version in chunks, a column where the two part held to a float64
    # referee), the float64 gradient against central differences of the
    # forward kernel's loss, then the timed 288-step gradient at full width
    land_grads = {}
    x0, k0 = land_grad_params(tp)
    for name, (key, solver, dt) in LAND_GRAD_SCHEMES.items():
        vkw = {"stepper": key, "solver": solver}
        fwd = ls.ROLLOUTS[key]
        fkw = {"solver": solver} if solver else {}
        sim = land_grad_sim(tp, LAND_F64_CELLS, torch.float64, name)
        ops = land_grad_operands(ls, land_inputs, sim, seed=11)
        f64_err, f64_rel, f64_out = land_vjp_compare(lv, ls, *ops[:5], dt, GRAD_INNER, ops[5],
                                                     vkw, 1e-9, LAND_F64_CELLS)
        # central differences of the loss through the forward kernel, over
        # LAND_FD_STEPS[key] steps
        steps_fd = LAND_FD_STEPS[key]
        _, gx, gk = land_grad_value(tp, sim, name, steps=steps_fd)
        fd = []
        for i, h in enumerate((LAND_FD_H["log_K_sat"], LAND_FD_H["k_mineral"])):
            hi, lo_ = ([x0, k0], [x0, k0])
            hi[i] += h
            lo_[i] -= h
            fd.append((land_grad_value(tp, sim, name, params=hi, grad=False, steps=steps_fd)
                       - land_grad_value(tp, sim, name, params=lo_, grad=False,
                                         steps=steps_fd)) / (2 * h))
        fd_rel = [abs(a - b) / abs(b) for a, b in zip((gx, gk), fd)]
        if max(fd_rel) > LAND_FD_RTOL:
            raise AssertionError(f"{name}: f64 kernel gradient {(gx, gk)} against central "
                                 f"differences {fd}")
        fd_report = {}
        if steps_fd != GRAD_STEPS:  # the loss over the gradient's steps, reported
            fd_report["adjoint"] = land_grad_value(tp, sim, name)[1]
            for h in LAND_FD_REPORT_H:
                fd_report[h] = (land_grad_value(tp, sim, name, params=[x0 + h, k0],
                                                grad=False)
                                - land_grad_value(tp, sim, name, params=[x0 - h, k0],
                                                  grad=False)) / (2 * h)
        del sim, ops
        gsim = land_grad_sim(tp, LAND_CELLS, torch.float32, name)
        carry, linputs, root, coords, params, gout = land_grad_operands(ls, land_inputs, gsim,
                                                                        seed=11)
        # the pool's output cotangent 0: at an empty pool a random one grows
        # by |1 - dt / tau_r| a step where a column's pool fills (ROADMAP
        # Queue C), past float32 within a segment; the loss reads no pool
        gout["surface_excess_water"] = torch.zeros_like(gout["surface_excess_water"])
        f32_err, f32_rel, flips = land_vjp_compare_f32(
            lv, ls, tp, name, carry, linputs, root, coords, params, dt, GRAD_INNER, gout, vkw)
        k_ms = cuda_ms(lambda: lv.land_column_segment_vjp(
            carry, linputs, root, *coords, params, dt, 0.0, GRAD_INNER, gout, **vkw), reps=3,
            warmup=True)
        f_ms = cuda_ms(lambda: fwd(carry, linputs, root, *coords, params, dt, 0.0, GRAD_INNER,
                                   **fkw), reps=3, warmup=True)
        first = torch.arange(LAND_GRAD_CHUNK, device="cuda")
        sub = land_columns(ls, first, carry, linputs, root, gout)
        p_ms = cuda_ms(lambda: lv.land_column_segment_vjp_plain(
            sub[0], sub[1], sub[2], *coords, params, dt, 0.0, GRAD_INNER, sub[3], **vkw))
        end = fwd(carry, linputs, root, *coords, params, dt, 0.0, GRAD_INNER, **fkw)
        runs = land_branches(fs, params, linputs, carry, end, 0.0)
        runs = {k: n / LAND_CELLS for k, n in runs.items()}
        v_ops = land_vjp_ops(key, solver, LAND_NZ, runs)
        b = bound_ms(v_ops * LAND_CELLS * GRAD_INNER, land_vjp_bytes(LAND_NZ, LAND_CELLS, 4))
        del sub, end
        # the gradient: 6 forward and 6 VJP launches
        land_grad_value(tp, gsim, name)
        torch.cuda.synchronize()
        times, grad_launches = [], {}
        for i in range(5):
            reset_counts()
            t0 = time.perf_counter()
            value, ggx, ggk = land_grad_value(tp, gsim, name)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == 0:
                grad_launches = launched()
        segments = GRAD_STEPS // GRAD_INNER
        if grad_launches != {fwd.__name__: segments, "land_column_segment_vjp": segments}:
            raise AssertionError(f"{name}: the gradient launched {grad_launches}")
        if not all(np.isfinite(v) for v in (value, ggx, ggk)):
            raise AssertionError(f"{name}: value {value}, gradient {(ggx, ggk)}")
        med = float(np.median(times))
        # the same gradient at float64, full width: how far float32 rounding
        # moves it (reported, not held: the model's own conditioning)
        sim64 = land_grad_sim(tp, LAND_CELLS, torch.float64, name)
        value64, gx64, gk64 = land_grad_value(tp, sim64, name)
        del sim64
        final = fwd(carry, linputs, root, *coords, params, dt, 0.0, GRAD_STEPS, **fkw)
        entry = cuda_build._entry_name("land_column_segment_vjp", lv.check_scheme(
            params, key, solver) + params.tags, torch.float32, LAND_NZ)
        land_grads[name] = dict(launches=grad_launches["land_column_segment_vjp"],
                                max_abs_err=max(f32_err.values()), ms=k_ms, plain_ms=p_ms,
                                bound_ms=b[0], bound_by=b[1], entry=entry)
        phase(name, cells=LAND_CELLS, nz=LAND_NZ, dt=dt, steps=GRAD_STEPS,
              inner_steps=GRAD_INNER, stepper=key, solver=solver, seconds_median=med,
              seconds=times, launches=grad_launches, cells_steps_per_s=LAND_CELLS * GRAD_STEPS / med,
              loss=value, dloss_dlog_K_sat=ggx, dloss_dk_mineral=ggk, f64_loss=value64,
              f64_dloss_dlog_K_sat=gx64, f64_dloss_dk_mineral=gk64, vjp_segment_ms=k_ms,
              fwd_segment_ms=f_ms, plain_vjp_ms=p_ms, plain_cells=LAND_GRAD_CHUNK,
              bound_ms=b[0], bound_by=b[1], ops_per_column_step=v_ops,
              branch_runs_per_column_step=runs,
              ptxas=ptxas_all["land_column_segment_vjp"].get(entry, {}).get("vjp"),
              f64_cells=LAND_F64_CELLS, f64_rtol=1e-9, f64_max_abs_err=f64_err,
              f64_max_err_over_magnitude=f64_rel, f64_columns_left_out=f64_out,
              fd_steps=steps_fd, fd_h=LAND_FD_H, fd_rtol=LAND_FD_RTOL,
              f64_kernel_grad=[gx, gk], central_difference=fd, fd_rel_err=fd_rel,
              dlog_K_sat_at_gradient_steps_adjoint_and_by_h=fd_report,
              f32_rel_tol=F32_VJP_REL_TOL, f32_max_abs_err=f32_err,
              f32_max_err_over_magnitude=f32_rel, f32_flip_columns=flips,
              outside_unit_share_at_end=float(outside_unit(final).float().mean()), card=card)
        del gsim, carry, gout, final

    # ---- one full step (make_fused_step): the kernel against the plain
    # version (the module step) on every leaf, float64 along the plain
    # trajectory and float32 at full width, each stepper and physics
    full64 = {}
    for stepper, nz in (("euler", 20), ("heun", 15)):
        sim = full_sim(tp, FULL_F64_CELLS, nz, torch.float64, stepper, "richards")
        fused = fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources,
                                   dt=BENCH_DT)
        state = sim.state
        for i in range(FULL_F64_STEPS):
            plain = fs.soil_column_full_step_plain(sim.model, sim.timestepper, sim.ctx, (),
                                                   state, BENCH_DT)
            errs = check_full_step(f"full step {stepper} f64", fused(state), plain, 1e-12,
                                   BENCH_DT)
            full64[f"{stepper}:{i}"] = max(errs.values())
            state = plain
    full32 = {}
    for stepper, physics in (("euler", "richards"), ("heun", "richards"), ("euler", "heat"),
                             ("heun", "heat")):
        sim = full_sim(tp, BENCH_CELLS, BENCH_NZ, torch.float32, stepper, physics)
        fused = fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources,
                                   dt=BENCH_DT)
        plain = fs.soil_column_full_step_plain(sim.model, sim.timestepper, sim.ctx, (),
                                               sim.state, BENCH_DT)
        full32[f"{stepper}:{physics}"] = check_full_step(
            f"full step {stepper} {physics} f32", fused(sim.state), plain, F32_REL_TOL,
            BENCH_DT)
        del plain
    # timing, the bench composition at full width (ab_fused_step.py's setup)
    sim = full_sim(tp, BENCH_CELLS, BENCH_NZ, torch.float32, "euler", "richards")
    fused = fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources,
                               dt=BENCH_DT)
    call_ms = cuda_ms_each(lambda: fused(sim.state), FULL_TIMED)
    fn, (fargs, keep), _ = fs.full_step_operands(sim.model, "euler", "richards", sim.ctx,
                                                 sim.state, BENCH_DT)
    full_kernel_ms = cuda_ms_each(lambda: fn(*fargs), FULL_TIMED)
    full_plain_ms = cuda_ms(lambda: fs.soil_column_full_step_plain(
        sim.model, sim.timestepper, sim.ctx, (), sim.state, BENCH_DT), reps=3, warmup=True)
    full_b = bound_ms(full_step_ops("euler", "richards", BENCH_NZ) * BENCH_CELLS,
                      full_step_bytes("richards", BENCH_NZ, BENCH_CELLS, 4, keep[1].numel()))
    del keep
    # the full-step path: FULL_STEPS calls of fused, one launch each
    reset_counts()
    state = sim.state
    for _ in range(FULL_STEPS):
        state = fused(state)
    torch.cuda.synchronize()
    full_launches = fs.soil_column_full_step.launches
    if launched() != {"soil_column_full_step": FULL_STEPS}:
        raise AssertionError(f"{FULL_STEPS} full steps launched {launched()}")
    ref = sim.state
    for _ in range(FULL_STEPS):
        ref = fs.soil_column_full_step_plain(sim.model, sim.timestepper, sim.ctx, (), ref,
                                             BENCH_DT)
    loop_err = check_close("full step loop", [state[n] for n in sim.model.live_carry],
                           [ref[n] for n in sim.model.live_carry], F32_REL_TOL)
    if int(state.clock.iteration) != FULL_STEPS:
        raise AssertionError(f"full-step loop: clock iteration {int(state.clock.iteration)}")
    full_ms = float(np.median(full_kernel_ms))
    phase("full_step", cells=BENCH_CELLS, nz=BENCH_NZ, f64_cells=FULL_F64_CELLS,
          f64_steps=FULL_F64_STEPS, f64_rtol=1e-12, f64_max_abs_err=full64,
          rel_tol=F32_REL_TOL, f32_max_abs_err=full32, loop_steps=FULL_STEPS,
          loop_launches=full_launches, loop_max_abs_err=loop_err,
          fused_call_ms_median=float(np.median(call_ms)), fused_call_ms=call_ms,
          kernel_ms_median=full_ms, kernel_ms=full_kernel_ms, plain_ms=full_plain_ms,
          bound_ms=full_b[0], bound_by=full_b[1],
          rollout_step_share_ms=ms / COMPARE_STEPS, card=card)
    del sim, state, ref, fused

    # ---- run through the process modules: the bench soil with a forcing,
    # which no kernel takes, at full width on the card, held to timestep()
    sim = full_sim(tp, BENCH_CELLS, BENCH_NZ, torch.float32, "euler", "richards",
                   forcings={"internal_energy": lambda state, grid: 2.0})
    other = full_sim(tp, BENCH_CELLS, BENCH_NZ, torch.float32, "euler", "richards",
                     forcings={"internal_energy": lambda state, grid: 2.0})
    reset_counts()
    t0 = time.perf_counter()
    sim.run(steps=RUN_MODULE_STEPS)
    torch.cuda.synchronize()
    modules_s = time.perf_counter() - t0
    if launched():
        raise AssertionError(f"run through the modules launched {launched()}")
    if sim.state.internal_energy.device.type != "cuda":
        raise AssertionError(f"run left the card: {sim.state.internal_energy.device}")
    other.model.closure(other.state, other.ctx)
    for _ in range(RUN_MODULE_STEPS):
        other.timestep(BENCH_DT)
    torch.cuda.synchronize()
    modules_err = check_close("run through the modules vs timestep",
                              [sim.state[n] for n in sim.model.live_carry],
                              [other.state[n] for n in sim.model.live_carry], F32_REL_TOL)
    if sim.iteration != RUN_MODULE_STEPS:
        raise AssertionError(f"run through the modules: clock iteration {sim.iteration}")
    phase("run_modules", cells=BENCH_CELLS, nz=BENCH_NZ, steps=RUN_MODULE_STEPS,
          seconds=modules_s, cells_steps_per_s=BENCH_CELLS * RUN_MODULE_STEPS / modules_s,
          launches=launched(), rel_tol=F32_REL_TOL, max_abs_err=modules_err, card=card)
    del sim, other

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
                 f"{GRAD_COMPARE_CELLS} columns"}, *({
        "name": f"soil_column_segment_vjp[{name}]", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/soil_column_segment_vjp.cu",
        "replaces": "terrarium_tpu/ops/fused_vjp.py:68",
        **{k: v for k, v in sc.items() if k != "entry"}, "library_ms": None,
        "shape": f"{GRAD_CELLS} x {BENCH_NZ} f32, {GRAD_INNER} steps, {sc['entry']}; "
                 f"plain_ms at {GRAD_SCHEME_CHUNK} columns"} for name, sc in schemes.items()), *({
        "name": f"land_column_segment_vjp[{name}]", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/land_column_segment_vjp.cu",
        "replaces": "terrarium_tpu/ops/fused_vjp.py:68 traced over a LandModel step "
                    "(terrarium_tpu/models/land_model.py:55)",
        **{k: v for k, v in lg.items() if k != "entry"}, "library_ms": None,
        "shape": f"{LAND_CELLS} x {LAND_NZ} f32, land_consistent with static inputs, dt "
                 f"{LAND_GRAD_SCHEMES[name][2]:g}, {GRAD_INNER} steps, {lg['entry']}; plain_ms "
                 f"at {LAND_GRAD_CHUNK} columns"} for name, lg in land_grads.items()), {
        "name": "land_column_rollout", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/land_column_rollout.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:283 traced over a LandModel step "
                    "(terrarium_tpu/models/land_model.py:55)",
        "launches": land_launches, "max_abs_err": max(land_abs.values()),
        "ms": land_ms, "plain_ms": land_plain_ms, "bound_ms": land_b[0],
        "bound_by": land_b[1], "library_ms": None,
        "shape": f"{LAND_CELLS} x {LAND_NZ} f32, land_consistent, series, "
                 f"{COMPARE_STEPS} steps"}, *({
        "name": ("land_column_heun_rollout" if v["key"] == "heun"
                 else "land_column_implicit_rollout") + f"[{vname}]", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/land_column_rollout.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:283 traced over a LandModel step with "
                    + ("Heun (terrarium_tpu/timesteppers/stepping.py:167)" if v["key"] == "heun"
                       else f"ImplicitEuler (terrarium_tpu/timesteppers/implicit.py:173, "
                            f"{v['solver']})")
                    + (" and a Snowpack (terrarium_tpu/processes/snow.py:66)"
                       if v["snow"] else ""),
        "launches": v["launches"], "max_abs_err": max(v["max_abs_err"].values()),
        "ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
        "bound_by": v["bound_by"], "library_ms": None,
        "shape": f"{LAND_CELLS} x {LAND_NZ} f32, land_consistent"
                 + (" with snow" if v["snow"] else "") + f", series, {LAND_VARIANT_STEPS} "
                 f"steps (ms_144 {v['ms_144']:.4f})"} for vname, v in land_var.items()), {
        "name": "soil_column_full_step", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/soil_column_full_step.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:152",
        "launches": full_launches, "max_abs_err": max(full32["euler:richards"].values()),
        "ms": full_ms, "plain_ms": full_plain_ms, "bound_ms": full_b[0],
        "bound_by": full_b[1], "library_ms": None,
        "fused_call_ms": float(np.median(call_ms)),
        "shape": f"{BENCH_CELLS} x {BENCH_NZ} f32, ForwardEuler, one full step"}]}),
        flush=True)
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
    from terrarium_tpu_torch.ops import fused_vjp as fv
    from terrarium_tpu_torch.ops import land_step as ls
    from terrarium_tpu_torch.timesteppers.integrator import (clock_times, land_inputs,
                                                             top_temperature_table)

    def digest(tensors):
        return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in tensors)).hexdigest()

    t0 = time.perf_counter()
    land_vjp = "land_column_segment_vjp" in cuda_build.INSTANTIATIONS
    cuda_build.build("soil_column_rollout", "soil_column_segment_vjp", "land_column_rollout",
                     *(("land_column_segment_vjp",) if land_vjp else ()))
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
    # the heat-only, implicit, segment-VJP and land kernels on the operands
    # of their full-width comparisons
    sim = heat_sim(tp, HEAT_CELLS, torch.float32)
    carry, bc, coords, params = series_operands(fs, sim, COMPARE_STEPS)
    digests["heat_series_f32_nz30"] = digest(
        fs.soil_column_heat_rollout(*carry, bc, *coords, params, HEAT_DT)[:1])
    del sim, carry, bc
    for solver in SOLVERS:
        sim = implicit_sim(tp, solver)
        g = sim.model.grid
        coords = tuple(getattr(g, n)[:, 0].contiguous()
                       for n in ("dz", "dz_faces", "z_centers", "z_faces"))
        carry = tuple(sim.state.prognostic[n].contiguous() for n in sim.model.live_carry)
        table = top_temperature_table(sim.bcs["temperature"]["top"].value, clock_times(
            sim.state.clock.time, IMPLICIT_DT, COMPARE_STEPS)[:-1], g)
        digests[f"implicit_{solver}_f32_nz30"] = digest(fs.soil_column_implicit_rollout(
            *carry, table, *coords, fs.ColumnParams.of(sim.model, g.dtype), IMPLICIT_DT,
            solver=solver))
        del sim, carry, table
    gsim = grad_sim(tp, GRAD_CELLS, torch.float32)
    ops = vjp_operands(tp, fs, gsim, seed=11)
    digests["segment_vjp_f32_nz20"] = digest(
        fv.soil_column_segment_vjp(*ops[0], ops[1], *ops[2], ops[3], GRAD_DT, *ops[4]))
    del gsim, ops
    if hasattr(fv, "VJP_SCHEMES"):  # the segment VJP of the other schemes
        for name, cfg in GRAD_SCHEMES.items():
            gsim = scheme_sim(tp, name, GRAD_CELLS, BENCH_NZ, torch.float32)
            carry, table, coords, params, cts, kw = scheme_operands(fs, name, gsim, seed=11)
            out = fv.soil_column_segment_vjp(*carry, table, *coords, params, cfg["dt"], *cts,
                                             **kw)
            digests[f"segment_vjp_{name}_f32_nz30"] = digest([t for t in out if t is not None])
            del gsim, carry, cts, out
    sim = land_sim(tp, LAND_CELLS, torch.float32, "consistent")
    carry, inputs, root, coords, params = land_operands(ls, land_inputs, sim)
    out = ls.land_column_rollout(carry, inputs, root, *coords, params, LAND_DT,
                                 float(sim.state.clock.time), COMPARE_STEPS)
    digests["land_consistent_f32_nz20"] = digest([out[k] for k in sorted(out)])
    del sim, carry, inputs, out
    if hasattr(ls, "ROLLOUTS"):  # the land kernel's Heun, implicit and snow variants
        for vname, (_, _, vsnow) in LAND_VARIANTS.items():
            stepper, kernel, _ = land_variant(tp, ls, vname)
            sim = land_sim(tp, LAND_CELLS, torch.float32, "consistent", stepper=stepper,
                           snow=vsnow)
            carry, inputs, root, coords, params = land_operands(ls, land_inputs, sim)
            out = kernel(carry, inputs, root, *coords, params, LAND_DT,
                         float(sim.state.clock.time), COMPARE_STEPS)
            digests[f"{vname}_f32_nz20"] = digest([out[k] for k in sorted(out)])
            del sim, carry, inputs, out
    if land_vjp:  # the land segment VJP of each scheme
        from terrarium_tpu_torch.ops import land_vjp as lv

        for name, (key, solver, dt) in LAND_GRAD_SCHEMES.items():
            gsim = land_grad_sim(tp, LAND_CELLS, torch.float32, name)
            ops = land_grad_operands(ls, land_inputs, gsim, seed=11)
            gin, gK, gskm = lv.land_column_segment_vjp(*ops[:3], *ops[3], ops[4], dt, 0.0,
                                                       GRAD_INNER, ops[5], stepper=key,
                                                       solver=solver)
            digests[f"land_vjp_{name}_f32_nz20"] = digest([gin[k] for k in sorted(gin)]
                                                          + [gK, gskm])
            del gsim, ops, gin
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
