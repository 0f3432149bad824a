"""Smoke test of the PyTorch port on one CUDA card.

Builds the port's CUDA kernels from ``terrarium_tpu_torch/csrc`` (the soil
column rollouts: ForwardEuler, Heun and ImplicitEuler (Thomas or PCR, any
number of Picard iterations) over heat + Richards on groups of lanes; one
thread a column, the heat-only steppers;
the segment VJP of each of these, the land rollout and its VJP, each with
the Picard iterations, and the soil's and the land's full steps, every
stepper; one ``nvcc`` per instantiation,
in parallel: the rollout source's prebuilt set first, then the others in a
background thread while the forward phases run, beside the two
instantiations of ``on_demand`` that no prebuilt set holds, each built
alone at its first use) and drives the port's paths, each with the kernel
launch counts set to 0 just before it and read just after. Rows 1, 1'a,
1'c and 1'j (the group rollout of ForwardEuler, of Heun, and of
ImplicitEuler with one and two Picard iterations, each solver) are also
described in ``group_check`` lines: the group size, registers, spill
stores, resident warps an SM, SASS instructions, the saturation sweeps'
hand-offs between lanes on the compared operands, the bound with each
operation weighted by its measured cost, and (rows 1 and 1'a) the row at
float64 on 1,024 columns against the plain version at 1e-12; so are rows
3, 3'a, 3'b and 3'h (the group segment VJP of ForwardEuler, of Heun, and of
ImplicitEuler with one and two Picard iterations, each solver), with the
recompute check: every carry the VJP stores, bit for bit the group
rollout's after the same steps (one step a launch); and rows
3'e and 3'i (the land group segment VJP of ImplicitEuler, one and two
Picard iterations, each solver), whose stored carries equal the land group
rollout's (the forward segments' kernel) bit for bit at float64 and at
float32; and rows 1'f and 1'k (the land group rollout of ImplicitEuler,
one and two Picard iterations, each solver), with their group size,
registers, spill stores, resident warps, SASS instructions and weighted
bound:

* ``on_demand``: `examples/soil_heat_column.py`'s composition (BASELINE
  config #1: the heat-only SoilModel, one column, Nz 10, float32,
  ForwardEuler at dt 300 s, 864 steps) and a bare-ground Van
  Genuchten/Mualem LandModel (1,024 columns, Nz 20, float32, ImplicitEuler
  PCR at dt 600 s, 288 steps), each through ``Simulation.run`` on the
  kernel built at its first use, one launch, against its plain version,
  with the seconds its build took;

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
* this slice's forward paths at 56,951 columns, Nz 30, float32, each kernel
  first held to its plain version one step at a time along the plain
  trajectory (float64 on 1,024 columns at Nz 16, float32 at full width with
  a float64 referee for the cells that cross the freeze plateau's edge or
  saturation on one side of an ulp), timed, then one ``Simulation.run``
  block: ``heat_heun_n145`` (``global_heat_n72_forcing``'s heat-only model
  and hourly series, Heun at dt 300 s, 2,880 steps),
  ``heat_implicit_<solver>_n145`` (the same by ImplicitEuler at dt 3,600 s,
  720 steps, with the share of columns on the freeze plateau) and
  ``picard2_implicit_<solver>_n145`` (``column_implicit_tridiag`` by
  ImplicitEuler with two Picard iterations at dt 900 s, 1,920 steps, with
  the water identity);
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
  version); the land kernel's Heun and ImplicitEuler (PCR, Thomas) and
  snowpack (ImplicitEuler PCR) variants, all on groups of lanes, each
  against its plain version one
  step at a time (float64 on 1,024 columns, float32 at full width, 48
  steps) and then through ``Simulation.run`` on ``land_consistent``'s
  composition and forcing at dt 600 s (``land_heun``, ``land_implicit_pcr``,
  ``land_implicit_thomas``, ``land_snow_n145`` with a snowfall and an initial
  pack), one timed 1,440-step block each, with the share of columns with a
  saturation layer outside [0, 1] at steps 3 and 1,440; then the same for
  ImplicitEuler with two Picard iterations, each solver
  (``land_picard_compare``, ``land_picard_main_path``);
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
  (``land_grad_implicit_pcr``, ``_thomas``) and with two Picard iterations
  (``land_grad_implicit_picard2_<solver>``), Heun at dt 60 s
  (``land_grad_heun``) and ``land_snow_n145``'s snowpack by ImplicitEuler
  PCR at dt 600 s (``land_grad_snow_implicit_pcr``), after the land segment-VJP
  kernel (ImplicitEuler and Heun, with or without a snowpack, on groups of
  lanes, their stored carries bitwise the group rollout's; ForwardEuler one
  thread a column, its stored carries bitwise those of the forward
  segments' one-thread rollout, both built without contracted
  multiply-adds, ROADMAP C3) against
  its plain version (float64 on 1,024 columns at rtol 1e-9,
  float32 at full width with the plain version in chunks, the parameter
  cotangents also summed with output cotangents aligned to the sign of each
  column's plain share) and the float64 gradient against central
  differences of the loss; with Picard iterations the float32 gradient's
  gap to the float64 one is held to the one-iteration scheme's; then the
  snowy group entries of Thomas, two Picard iterations and Heun at float64
  on 1,024 columns, each rollout and segment VJP against its plain version
  (``group_check_snow_entries``);
* the gradient path of the segment VJP's other schemes, each at 56,951
  columns, Nz 30, float32, 288 steps in segments of 48, after its kernel
  against its plain version (float64 on 1,024 columns at the scheme's
  float64 Nz, float32 at full width in chunks of 4,096 columns) and, with
  Richards flow, the water identity through it: ``grad_heun_n145`` (Heun at
  dt 60 s), ``grad_implicit_n145_pcr`` and ``_thomas`` (ImplicitEuler at dt
  900 s), all in log K_sat as above, and ``grad_n145_heat``
  (`bench_configs.py:270-308`: the heat-only model, d mean(T) / d
  k_mineral, ForwardEuler at dt 300 s), also timed through the port's
  ``make_rollout_fn(remat=True)``; and this slice's: ``grad_n145_heat_heun``
  (Heun at dt 300 s) and ``grad_n145_heat_implicit_<solver>`` (ImplicitEuler
  at dt 3,600 s) in k_mineral as ``grad_n145_heat``, and
  ``grad_implicit_picard2_<solver>`` (two Picard iterations at dt 900 s) in
  log K_sat, each also held at float64 to central differences of its loss;
* one full step a launch (``make_fused_step``), last, once the full-step
  sources are built: ``full_step`` (ForwardEuler and Heun, the bench soil
  and the heat-only model, `experiments/ab_fused_step.py`'s setup at 56,951
  columns, Nz 30), ``full_step_implicit_<solver>_picard<k>`` (ImplicitEuler
  at dt 900 s, each solver with one and two Picard iterations;
  ``full_step_implicit_heat``: the heat-only model) and
  ``land_full_step_<variant>`` (the LandModel: ``land_consistent``'s
  composition with static inputs at 56,951 columns, Nz 20, ForwardEuler and
  Heun at dt 60 s, ImplicitEuler at dt 600 s with each solver, with two
  Picard iterations and with a snowpack): each kernel against its plain
  version, the module step, on every prognostic, tendency and auxiliary
  (float64 on 1,024 columns along the plain trajectory at 1e-12, float32 at
  full width with a float64 referee), then the launch and the ``fused``
  call timed and a 20-call loop of one launch a call;
* a forcing streamed from the host (``ChunkedForcingPipeline``,
  ``io/forcing_pipeline.py``), the clock from day 300 of a year:
  ``stream_soil`` (the bench soil at full width, its top temperature from
  an hourly ``(T, cells)`` series, Euler at dt 60 s, 2,880 steps, windows
  of 16 slices) and ``stream_land`` (``land_implicit_pcr``'s composition
  and its two hourly series, 1,440 steps at dt 600 s, windows of 32),
  ``run_fused`` and ``run`` against ``Simulation.run`` on the whole series
  on the card (float64 at 1e-12, float32 by the rule above), then
  ``run_fused`` at float32 with one launch a chunk, each chunk's kernel,
  window copy and gap timed and each copy's overlap with the kernel before
  it;
* ``probes``, once ``csrc/probes.cu`` is built (the last ``REST_GROUPS``
  group): the roofline micro-benchmark's chains, the Mosaic bisect's cases
  and the Mosaic repro's variants (``terrarium_tpu_torch/experiments``)
  against their plain versions at float64 and float32, then each entry
  point as a user runs it: ``run_micro``'s rates, ``run_case``'s and
  ``run_variant``'s medians of 100 launches, and ``torch.cummin`` as the
  cummin case's library call.

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
kernels' (each stepper, the snowpack and the Picard iterations the package
has) and land segment-VJP kernel's (each scheme the package has) on their
full-width comparison operands, of the full-step kernel's six ForwardEuler
and Heun instantiations and (where the package has them) its ImplicitEuler
and the LandModel's full steps on one step of their phases' states, and the bench
``main_path`` rate, for the package in
``DIR`` (default: this checkout). Run it on two checkouts in one call to
compare their kernels bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import pathlib
import re
import subprocess
import sys
import threading
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
# this slice's forward paths at full width: global_heat_n72_forcing's model
# and series (heat_sim) by Heun at dt 300 s, one 2,880-step block
# (heat_heun_n145), and by ImplicitEuler at dt 3,600 s with each solver, one
# 720-step block (heat_implicit_<solver>_n145); column_implicit_tridiag
# (implicit_sim) by ImplicitEuler with two Picard iterations at dt 900 s, one
# 1,920-step block (picard2_implicit_<solver>_n145). Each kernel is first held
# to its plain version one step at a time along the plain trajectory
# (soil_teacher) over COMPARE_STEPS steps: float64 on HEAT_F64_CELLS columns
# at Nz NEW_F64_NZ, float32 at full width
HEAT_HEUN_DT, HEAT_HEUN_BLOCK_STEPS = 300.0, 2880
HEAT_IMPLICIT_DT, HEAT_IMPLICIT_BLOCK_STEPS = 3600.0, 720
PICARD_ITERS, PICARD_BLOCK_STEPS = 2, 1920
NEW_F64_NZ = 16
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
# the central differences of this slice's gradient schemes: the steps in
# the parameter (log K_sat, or k_mineral = 3.8 W/m/K), each reported; the
# gradient is held to the closest. The loss has kinks where a layer's
# energy crosses the freeze plateau's edge at some step (the temperature is
# piecewise linear in it), and a difference that spans one errs by O(h):
# over 288 heat-only Heun steps at h 0.02 and 0.005 the differences were
# 0.86% and 0.30% from the adjoint on an H100, shrinking with h
FD_HS = (1e-2, 1e-3, 1e-4)
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
# The same forward step with each operation weighted by its cost on the
# card, in FMA issues, from row 4's measured rates (PERF.md section 6: a
# division 15.6, a powf 70, an exp 9.6; a root, which row 4 did not time,
# at an exp's): of FWD_OPS' 106 operations a level and step, 13 IEEE
# divisions (the sweeps' c / dz x2; safediv, the two Tk quotients and
# water / theta_sat; the heat flux's gradient and divergence; the head's
# se and its se^-2; the Darcy gradient, divergence and / por), one powf (the
# ice impedance 10^x), four roots (the se^(2/3) cube root, the Mualem and
# head square roots, sqrt(se)), the other 88 one issue each. The bound at
# the card's 33.5e12 FMA issues/s
FWD_WEIGHTS = {"division": (13, 15.6), "powf": (1, 70.0), "root": (4, 9.6)}
FWD_FMA_ISSUES_PER_LEVEL_STEP = (
    FWD_OPS_PER_LEVEL_STEP - sum(n for n, _ in FWD_WEIGHTS.values())
    + sum(n * w for n, w in FWD_WEIGHTS.values()))
HEUN_FMA_ISSUES_PER_LEVEL_STEP = (2 * FWD_FMA_ISSUES_PER_LEVEL_STEP
                                  + HEUN_OPS_PER_LEVEL_STEP - 2 * FWD_OPS_PER_LEVEL_STEP)
H100_FMA_ISSUES = 33.5e12
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
#
# This slice's schemes (``fd``: the float64 gradient also held to central
# differences, at GRAD_REF_CELLS columns and the float64 Nz): the heat-only
# model by Heun at dt 300 s (grad_n145_heat_heun) and by ImplicitEuler at dt
# 3,600 s with each solver (grad_n145_heat_implicit_<solver>), d mean(T) /
# d k_mineral as grad_n145_heat; heat + Richards by ImplicitEuler with two
# Picard iterations at dt 900 s (grad_implicit_picard2_<solver>), mean(T) +
# mean(sat) in log K_sat as grad_implicit_n145
GRAD_SCHEMES = {
    "grad_heun_n145": dict(stepper="heun", solver="pcr", physics="richards", dt=60.0, f64_nz=15),
    "grad_implicit_n145_pcr": dict(stepper="implicit", solver="pcr", physics="richards",
                                   dt=900.0, f64_nz=16),
    "grad_implicit_n145_thomas": dict(stepper="implicit", solver="thomas", physics="richards",
                                      dt=900.0, f64_nz=16),
    "grad_n145_heat": dict(stepper="euler", solver="pcr", physics="heat", dt=300.0, f64_nz=30),
    "grad_n145_heat_heun": dict(stepper="heun", solver="pcr", physics="heat", dt=300.0,
                                f64_nz=16, fd=True),
    **{f"grad_n145_heat_implicit_{s}": dict(stepper="implicit", solver=s, physics="heat",
                                            dt=3600.0, f64_nz=16, fd=True) for s in SOLVERS},
    **{f"grad_implicit_picard2_{s}": dict(stepper="implicit", solver=s, physics="richards",
                                          dt=900.0, f64_nz=16, picard=2, fd=True)
       for s in SOLVERS},
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
# This slice's steps, counted the same way:
# * heat-only Heun (soil::heun_step<HEAT>), per level and step: two heat-only
#   closure_rhs (HEAT_OPS_PER_LEVEL_STEP each), the first keeping its
#   tendency (less the update's 2) and the second with the corrector (2
#   more), and the stage y = x + f dt (2): 94; its VJP adds the adjoint of
#   both (11 + 34 each, as the heat-only VJP) and the corrector's and the
#   stage's way back for U (2 + 3);
# * a heat-only implicit iteration (soil::picard_step<HEAT>), per level: the
#   heat-only closure_rhs with its tendency kept (46 - 2), dT/dU (3) and U +=
#   du (1); per interior face the heat rows' share of IMPLICIT_OPS_PER_FACE
#   (2 + 8); per column the Dirichlet top row (5) and one solve; each
#   iteration after the first also forms tend - (u_k - u^n) / dt (3 a level,
#   and 3 more for the saturation over heat + Richards, whose pool update
#   it skips); its VJP, per iteration and without the recompute (as
#   IMPLICIT_VJP_OPS_PER_LEVEL): the heat-only rhs_adjoint (11 + 34), the
#   rows' cotangents (3), dT/dU's (3) and the face kappa's mean (3) a level,
#   diffusion_rows' adjoint (22) a face, the transposed solve and the top
#   row's adjoint (5), and the right side's -lambda / dt, +lambda / dt (2 a
#   level and implicit variable) in each iteration after the first
HEAT_HEUN_OPS_PER_LEVEL_STEP = 2 * HEAT_OPS_PER_LEVEL_STEP + (-2 + 2 + 2)
HEAT_HEUN_VJP_OPS_PER_LEVEL_STEP = HEAT_HEUN_OPS_PER_LEVEL_STEP + 2 * (11 + 34) + 5


def heat_implicit_ops(solver, nz, iters=1):
    """Operations of one heat-only implicit step of one column with
    ``iters`` Picard iterations."""
    one = ((HEAT_OPS_PER_LEVEL_STEP - 2 + 3 + 1) * nz + (2 + 8) * (nz - 1) + 5
           + implicit_solver_ops(solver, nz))
    return iters * one + (iters - 1) * 3 * nz


def picard_ops(solver, nz, iters):
    """Operations of one heat + Richards implicit step of one column with
    ``iters`` Picard iterations."""
    return iters * implicit_ops(solver, nz) + (iters - 1) * (6 * nz - 3)


def implicit_fma_issues(solver, nz, iters, cparams):
    """picard_ops with row 4's weights (FWD_WEIGHTS): FMA issues of one heat
    + Richards implicit step of one column with ``iters`` Picard
    iterations. Per level and iteration closure_rhs' divisions, powf and
    roots (FWD_WEIGHTS' counts), dT/dU's reciprocal, and soil::water_chain's
    two quotients and its three fixed powers as ``cparams``' codes take them
    (``_CParams``: den 0 a powf, 2 or 3 a root, a negative exponent a
    reciprocal); per interior face the rows' four quotients a system, the
    Dirichlet top's one; a solve's divisions (Thomas two a row; PCR two a
    row and round where both neighbours lie in the column, one where one
    does, then d / b); each further iteration's two (u_k - u^n) / dt a
    level. The other operations one issue each."""
    codes = [(getattr(cparams, f"num_id_{n}"), getattr(cparams, f"den_id_{n}"))
             for n in ("core", "a", "b")]
    chain_div = 2 + sum(1 for num, den in codes if den != 0 and num < 0)
    chain_powf = sum(1 for _, den in codes if den == 0)
    chain_root = sum(1 for _, den in codes if den in (2, 3))
    if solver == "thomas":
        solve_div = 2 * nz
    else:
        s, solve_div = 1, nz
        while s < nz:
            solve_div += 2 * (nz - s)
            s *= 2
    div = iters * ((FWD_WEIGHTS["division"][0] + 1 + chain_div) * nz + 8 * (nz - 1) + 1
                   + 2 * solve_div) + (iters - 1) * 2 * nz
    powf = iters * (FWD_WEIGHTS["powf"][0] + chain_powf) * nz
    root = iters * (FWD_WEIGHTS["root"][0] + chain_root) * nz
    weights = {"division": (div, FWD_WEIGHTS["division"][1]),
               "powf": (powf, FWD_WEIGHTS["powf"][1]), "root": (root, FWD_WEIGHTS["root"][1])}
    return picard_ops(solver, nz, iters) + sum(n * (w - 1.0) for n, w in weights.values())


def scheme_vjp_ops(name, nz):
    """Operations of one step of one column of a scheme's segment VJP."""
    cfg = GRAD_SCHEMES[name]
    iters = cfg.get("picard", 1)
    heat = cfg["physics"] == "heat"
    if cfg["stepper"] == "heun":
        return (HEAT_HEUN_VJP_OPS_PER_LEVEL_STEP if heat else HEUN_VJP_OPS_PER_LEVEL_STEP) * nz
    if cfg["stepper"] == "implicit" and heat:
        return (heat_implicit_ops(cfg["solver"], nz, iters)
                + iters * ((11 + 34 + 3 + 3 + 3) * nz + 22 * (nz - 1)
                           + implicit_solver_ops(cfg["solver"], nz) + 5)
                + (iters - 1) * 2 * nz)
    if cfg["stepper"] == "implicit":
        return (picard_ops(cfg["solver"], nz, iters)
                + iters * (IMPLICIT_VJP_OPS_PER_LEVEL * nz + IMPLICIT_VJP_OPS_PER_FACE * (nz - 1)
                           + 2 * (implicit_solver_ops(cfg["solver"], nz) + 5))
                + (iters - 1) * 4 * nz)
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


def full_step_implicit_ops(solver, physics, nz, iters):
    """Operations of one ImplicitEuler full step of one column
    (soil::full_step_column with IMPLICIT): full_step_ops's stored start,
    tendencies and trailing closure without the Euler update's multiply and
    add (a variable a level); the stored heat capacity and L_theta (7 and 2)
    and dT/dU (3) a level; heat + Richards: IMPLICIT_OPS' d(Psi)/d(sat) and
    updates, IMPLICIT_OPS_PER_FACE a face, IMPLICIT_OPS_PER_COLUMN and two
    solves; heat only: heat_implicit_ops' rows, update and one solve; each
    further Picard iteration as the rollout's (picard_ops, heat_implicit_ops
    less their first iteration)."""
    heat = physics == "heat"
    ops = full_step_ops("euler", physics, nz) + (-1 if heat else -2) * nz + (7 + 2 + 3) * nz
    if heat:
        ops += 1 * nz + (2 + 8) * (nz - 1) + 5 + implicit_solver_ops(solver, nz)
        return ops + heat_implicit_ops(solver, nz, iters) - heat_implicit_ops(solver, nz, 1)
    ops += ((IMPLICIT_OPS["d(Psi)/d(sat)"] + IMPLICIT_OPS["U += du, sat += du"]) * nz
            + IMPLICIT_OPS_PER_FACE * (nz - 1) + IMPLICIT_OPS_PER_COLUMN
            + 2 * implicit_solver_ops(solver, nz))
    return ops + picard_ops(solver, nz, iters) - picard_ops(solver, nz, 1)


def distinct_bytes(tensors) -> int:
    """Bytes of the distinct elements of ``tensors`` (a dimension of stride
    0 is read once)."""
    return sum(int(np.prod([n for n, st in zip(t.shape, t.stride()) if st != 0] or [1]))
               * t.element_size() for t in tensors)


def full_step_bytes(physics, nz, cells, itemsize, top_values):
    """Bytes one full step must move: it reads U, sat, T, liq (and psi, S)
    and the top temperatures once, and writes U, dU, T, liq, K_face, the
    ground temperature (and sat, dsat, psi, S, dS, the water table) once."""
    if physics == "richards":
        values = (5 * nz + 1) + (7 * nz + (nz + 1) + 4)
    else:
        values = 4 * nz + (4 * nz + (nz + 1) + 1)
    return (values * cells + top_values) * itemsize

# ImplicitEuler's full step (full_step_implicit): the bench composition at
# full width, 56,951 x 30 float32, dt 900 s (column_implicit_tridiag's), each
# solver with one and two Picard iterations, each timed (a launch and a
# fused call, the median of FULL_NEW_TIMED, and the plain version), the
# heat-only model checked with PCR and one iteration and Thomas and two;
# the float64 checks on FULL_IMPLICIT_F64_CELLS columns at Nz
# FULL_IMPLICIT_F64_NZ (the implicit rollout's float64 Nz, half the compile
# of Nz 30) along FULL_F64_STEPS steps of the plain trajectory
FULL_IMPLICIT_VARIANTS = tuple((solver, iters) for iters in (1, 2) for solver in SOLVERS)
FULL_IMPLICIT_F64_CELLS, FULL_IMPLICIT_F64_NZ, FULL_NEW_TIMED = 1024, 16, 20
# the LandModel: land_coupled_n145 (bench_configs.py:228-267) at synthetic
# latitudes from -60 to 80 degrees (the N145 mask is absent), 10 simulated
# days a block; the float64 comparison on 1,024 of those columns
LAND_CELLS, LAND_NZ, LAND_DT, LAND_BLOCK_STEPS, LAND_F64_CELLS = 56951, 20, 600.0, 1440, 1024
# the LandModel's full step (land_full_step): land_consistent's composition
# at full width, 56,951 x 20 float32, with the land gradient's static
# inputs (land_grad_sim), each stepper (ForwardEuler and Heun at dt 60 s,
# where they are stable; ImplicitEuler at dt 600 s with each solver, PCR
# also with two Picard iterations and with land_snow_n145's snowpack), held
# to the plain version (float64 on LAND_F64_CELLS columns along
# FULL_F64_STEPS steps of the plain trajectory, float32 at full width) and
# timed as the soil's: (stepper, solver, Picard iterations, dt, snowpack)
LAND_FULL_VARIANTS = {"euler": ("euler", None, 1, 60.0, False),
                      "heun": ("heun", None, 1, 60.0, False),
                      "implicit_pcr": ("implicit", "pcr", 1, LAND_DT, False),
                      "implicit_thomas": ("implicit", "thomas", 1, LAND_DT, False),
                      "implicit_pcr_picard2": ("implicit", "pcr", 2, LAND_DT, False),
                      "implicit_pcr_snow": ("implicit", "pcr", 1, LAND_DT, True)}
LAND_GOLDEN = ROOT / "tests" / "goldens" / "land_model.npz"
LAND_SNOW_GOLDEN = ROOT / "tests" / "goldens" / "land_snow.npz"
# land_snow_n145: the snowfall beside the rain and the initial pack
SNOWFALL, SWE0 = 2.0e-8, 0.02
# stream_soil and stream_land: a (T, cells) hourly forcing from the host
# through ChunkedForcingPipeline.run_fused (io/forcing_pipeline.py), the
# clock from day 300 of a year (2.592e7 s: a float32 clock's ulp is 2 s, so
# each window's own time origin matters), the series from a day before:
# the bench soil at full width with its top temperature, Euler at dt 60 s,
# 2,880 steps at window 16 (chunks of 840 steps); land_implicit_pcr
# (land_consistent by ImplicitEuler PCR at dt 600 s) with its shortwave and
# air temperature, 1,440 steps at window 32 (chunks of 180 steps); each at
# float64 and float32 against Simulation.run on the whole series on the card.
# The timed float32 run_fused streams STREAM_DAYS days (52 and 24 windows),
# its peak memory held to the short run's: a run holds two windows on the
# card whatever its length
STREAM_DAY0 = 300 * 86400.0
STREAM_DAYS = 30
STREAM = {"soil": {"dt": BENCH_DT, "steps": 2880, "window": 16, "inner": 120},
          "land": {"dt": LAND_DT, "steps": 1440, "window": 32, "inner": 60}}
# the probes (terrarium_tpu_torch/experiments, csrc/probes.cu): rows 5 and
# 6 and their plain versions timed as PROBE_REPS calls in a CUDA graph (a
# launch of a few microseconds timed alone measures the caller's host work)
PROBE_REPS = 100
# the land kernel's other steppers, each against its plain version along
# the plain trajectory for LAND_VARIANT_STEPS steps (float64 on
# LAND_F64_CELLS columns, float32 at full width) and timed over as many:
# (wrapper key, solver, snowpack)
LAND_VARIANTS = {"land_heun": ("heun", None, False),
                 "land_implicit_pcr": ("implicit", "pcr", False),
                 "land_implicit_thomas": ("implicit", "thomas", False),
                 "land_snow_implicit_pcr": ("implicit", "pcr", True)}
LAND_VARIANT_STEPS = 48
# ImplicitEuler with LAND_PICARD_ITERS Picard iterations over the same
# composition (land::picard_step, the prebuilt entry that takes the count and
# the solver at run time), each solver: held and timed as LAND_VARIANTS, and
# one 1,440-step Simulation.run block each (land_picard_compare,
# land_picard_main_path). Kept apart from LAND_VARIANTS, which
# --euler-digest also runs on a parent package without the iterations
LAND_PICARD_ITERS = 2
LAND_PICARD_VARIANTS = {f"land_picard_{s}": ("implicit", s, False) for s in SOLVERS}


def land_variant_spec(name):
    """``(wrapper key, solver, snowpack, Picard iterations)`` of a land
    variant of LAND_VARIANTS or LAND_PICARD_VARIANTS."""
    if name in LAND_PICARD_VARIANTS:
        return (*LAND_PICARD_VARIANTS[name], LAND_PICARD_ITERS)
    return (*LAND_VARIANTS[name], 1)


# C1's compositions, which no prebuilt instantiation covers and whose
# kernels are built at their first launch (on_demand): BASELINE config #1
# (examples/soil_heat_column.py: the heat-only SoilModel, one column, Nz 10,
# float32, ForwardEuler at dt 300 s, 3 simulated days) and a bare-ground Van
# Genuchten/Mualem land column at Nz 20, float32, ImplicitEuler (PCR) at dt
# 600 s (test_land_steppers.py::test_implicit_land_model_reproduced's
# composition; the land group rollout's source) on 1,024 columns, 2
# simulated days; each run through Simulation.run against its plain version
ON_DEMAND_STEPS = {"soil_heat_column": 864, "bare_vg_mualem_land": 288}
# The sources the first phases launch, built first: the group rollout (rows
# 1 and 1'a, ForwardEuler and Heun over heat + Richards) and the other soil
# rollouts
GROUP_SOURCE = "soil_column_group_rollout"
FIRST_SOURCES = (GROUP_SOURCE, "soil_column_rollout")
# the segment VJP of ForwardEuler, Heun and ImplicitEuler over heat +
# Richards on groups of lanes (rows 3, 3'a, 3'b and 3'h)
VJP_GROUP_SOURCE = "soil_column_group_segment_vjp"
# the land segment VJP of ImplicitEuler and Heun over Richards flow without
# a snowpack on groups of lanes (rows 3'e, 3'i and 3'j)
LAND_VJP_GROUP_SOURCE = "land_column_group_segment_vjp"
# the land rollout of ImplicitEuler and Heun over Richards flow without a
# snowpack on groups of lanes (rows 1'f, 1'k and 1'e)
LAND_GROUP_SOURCE = "land_column_group_rollout"
# The sources built beside the forward phases, in the order the phases need
# them: the land rollouts, one thread a column and on groups of lanes (the
# land phases), then the land segment VJPs, one
# thread a column and on groups of lanes (the land gradients), then the
# soil segment VJPs, one thread a column and on groups of lanes (the soil
# gradients), whose nvcc CPU seconds would otherwise keep the land phases
# waiting, then the soil's and the land's
# full steps (their phases), built while the soil gradient phases run, then
# the probes (the last phase)
REST_GROUPS = (("land_column_rollout", LAND_GROUP_SOURCE),
               ("land_column_segment_vjp", LAND_VJP_GROUP_SOURCE),
               ("soil_column_segment_vjp", VJP_GROUP_SOURCE),
               ("soil_column_full_step", "land_column_full_step"), ("probes",))
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
# * ImplicitEuler with k Picard iterations (land::picard_step): k times the
#   one-iteration step, each iteration after the first without the series
#   reads and the surface updates (it reads the inputs and the surface
#   iteration 0 left) and with the right-hand sides' tend - (u_k - u^n) /
#   dt for U and sat (3 a level and variable: 6).
LAND_HEUN_OPS_PER_LEVEL, LAND_HEUN_OPS_PER_COLUMN = 4, 12 + 23
LAND_IMPLICIT_OPS_PER_LEVEL, LAND_IMPLICIT_OPS_PER_COLUMN = -4 + 3 + 16 + 2 + 2, 5
LAND_SNOW_OPS_PER_COLUMN = 22
LAND_PICARD_OPS_PER_LEVEL = 6


def land_variant_ops(stepper, solver, snow, nz, branches, iters=1):
    """Operations of one land step of one column of ``stepper`` (the kernel
    wrapper's key), with a snowpack where ``snow``, ImplicitEuler's with
    ``iters`` Picard iterations."""
    ops = land_ops(nz, branches) + (LAND_SNOW_OPS_PER_COLUMN if snow else 0)
    if stepper == "heun":
        return 2 * ops + LAND_HEUN_OPS_PER_LEVEL * nz + LAND_HEUN_OPS_PER_COLUMN
    if stepper == "implicit":
        one = (ops + LAND_IMPLICIT_OPS_PER_LEVEL * nz + IMPLICIT_OPS_PER_FACE * (nz - 1)
               + LAND_IMPLICIT_OPS_PER_COLUMN + 2 * implicit_solver_ops(solver, nz))
        return iters * one + (iters - 1) * (LAND_PICARD_OPS_PER_LEVEL * nz
                                            - LAND_OPS_PER_COLUMN["series reads and clock"]
                                            - LAND_OPS_PER_COLUMN["surface updates"])
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
# at dt 600 s, the land's production step; Heun at dt 60 s (its stage is
# unstable at 600 s, ROADMAP Queue C); land_snow_n145's snowy composition
# (a Snowpack, a snowfall of 2e-8 m/s, an initial pack of 0.02 m) by
# ImplicitEuler PCR at dt 600 s. (scheme key, solver, dt)
LAND_GRAD_SCHEMES = {"land_grad_euler": ("euler", None, 60.0),
                     "land_grad_implicit_pcr": ("implicit", "pcr", 600.0),
                     "land_grad_implicit_thomas": ("implicit", "thomas", 600.0),
                     **{f"land_grad_implicit_picard2_{s}": ("implicit", s, 600.0)
                        for s in SOLVERS},
                     "land_grad_heun": ("heun", None, 60.0),
                     "land_grad_snow_implicit_pcr": ("implicit", "pcr", 600.0)}
# the Picard iterations of a scheme (1 where not given)
LAND_GRAD_PICARD = {f"land_grad_implicit_picard2_{s}": 2 for s in SOLVERS}
# the schemes with land_snow_n145's snowpack
LAND_GRAD_SNOW = ("land_grad_snow_implicit_pcr",)
# the float32 full-width comparison runs the plain version (torch autograd
# through the process modules) in chunks of this many columns; the float64
# one on LAND_F64_CELLS columns over one segment; the central differences
# of the loss in log K_sat and k_mineral step by these
LAND_GRAD_CHUNK = 16384
# The float32 288-step gradient with Picard iterations parts from its
# float64 value (loss, d/dlog K_sat, d/dk_mineral) by as much as the
# one-iteration gradient with the same solver does (0.27%, 1.6%, 7.0% at
# full width): the forward's float32 rounding over the model's conditioning.
# Each relative gap is held within this of the one-iteration scheme's
# (measured apart by at most 1.9e-5, H100 80GB HBM3 at 700 W)
LAND_PICARD_F32_GAP_TOL = 1e-3
LAND_FD_H, LAND_FD_RTOL = {"log_K_sat": 1e-4, "k_mineral": 1e-4}, 1e-5
# Under the snowpack the loss in log K_sat is not smooth at the scale of h
# = 1e-4: over the gradient's 288 steps its central difference at 1e-4
# parts from the f64 adjoint by 4.7e-5 on LAND_F64_CELLS columns, where at
# 1e-5 the two agree within LAND_FD_RTOL. So the snowy scheme's log K_sat
# difference steps by 1e-5, and the phase reports the difference at
# LAND_FD_REPORT_H beside the adjoint. The probable branch is the melt
# water in the infiltration's min(influx, K_top), which the soil's
# conductivity moves in warm columns.
LAND_SNOW_FD_H = {"log_K_sat": 1e-5, "k_mineral": 1e-4}
# ForwardEuler's land state at dt 60 s leaves saturation [0, 1] within the
# gradient's 288 steps and its loss is not smooth there (the phase prints
# central differences at 288 steps and three h beside the adjoint, not
# held): its central differences are held over 96 steps, and so are Heun's
# at dt 60 s, whose stage is ForwardEuler's step; ImplicitEuler's over the
# gradient's 288
LAND_FD_STEPS = {"euler": 96, "heun": 96, "implicit": GRAD_STEPS}
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
# place of Van Genuchten's, counted the same). With k Picard iterations:
# the k-iteration forward step, each iteration's adjoint (the soil's, the
# surface block's and the implicit rows'), and in each iteration after the
# first the right-hand sides' -lambda / dt and +lambda / dt for U and sat
# (4 a level); the iterates' recompute is not counted.
# With a snowpack the surface block's adjoint adds one operation for each
# of the snowpack's forward ones (LAND_SNOW_OPS_PER_COLUMN) but the melt's
# (5), its way into the ground rain (1) and the SWE tendency (1), whose
# derivatives in the state are 0 with static inputs: 15 a column. Heun
# (land::heun_step_adjoint) runs the adjoint of closure_rhs twice, at the
# stage and at the start, and between them passes the stage's cotangents
# back through its Euler update and adds the corrector's halves (for U and
# sat a level: the rates' two multiply-adds and the carry's add, 6; a
# column: the surface's seven cotangents, the two flux BCs and the SWE's
# clips, 16); the stage's recompute is not counted.
LAND_VJP_OPS_PER_LEVEL = sum(ADJ_OPS.values()) + 6 + 5
LAND_VJP_OPS_PER_COLUMN = (sum(LAND_OPS_PER_COLUMN.values())
                           - LAND_OPS_PER_COLUMN["series reads and clock"]
                           - LAND_OPS_PER_COLUMN["surface updates"] + 4)
LAND_SNOW_VJP_OPS_PER_COLUMN = LAND_SNOW_OPS_PER_COLUMN - 5 - 1 - 1
LAND_HEUN_VJP_OPS_PER_LEVEL, LAND_HEUN_VJP_OPS_PER_COLUMN = 6, 16


def land_vjp_ops(stepper, solver, nz, branches, iters=1, snow=False):
    """Operations of one step of one column of the land segment VJP
    (ImplicitEuler's with ``iters`` Picard iterations; with a snowpack
    where ``snow``)."""
    adj = (LAND_VJP_OPS_PER_LEVEL * nz + LAND_VJP_OPS_PER_COLUMN
           + sum(LAND_OPS_BRANCH[k] * n for k, n in branches.items())
           + (LAND_SNOW_VJP_OPS_PER_COLUMN if snow else 0))
    if stepper == "implicit":
        adj += (IMPLICIT_VJP_OPS_PER_LEVEL - sum(ADJ_OPS.values())) * nz \
            + IMPLICIT_VJP_OPS_PER_FACE * (nz - 1) + 2 * (implicit_solver_ops(solver, nz) + 5)
    if stepper == "heun":
        adj = 2 * adj + LAND_HEUN_VJP_OPS_PER_LEVEL * nz + LAND_HEUN_VJP_OPS_PER_COLUMN
    return (land_variant_ops(stepper, solver, snow, nz, branches, iters) + iters * adj
            + (iters - 1) * 4 * nz)


def land_vjp_bytes(nz, cells, itemsize, snow=False):
    """Bytes the land segment VJP must move: it reads the input carry (2 Nz
    + 6 values a column, one more with a snowpack), the output cotangents
    (as many), the static inputs (11) and the root fractions (Nz), and
    writes the input cotangents and the two parameter cotangents."""
    return ((3 * (2 * nz + 6 + snow) + 11 + nz) * cells + 2) * itemsize


def land_grad_model_fn(tp, grid, snow=False):
    """``(log K_sat, k_mineral) -> model``: land_model "consistent" (with
    a ``Snowpack`` where ``snow``) with its soil's saturated hydraulic
    conductivity exp(log K_sat) and mineral conductivity k_mineral."""
    from terrarium_tpu_torch.convert import with_differentiable_params

    base = land_model(tp, grid, "consistent")
    if snow:
        base = dataclasses.replace(base, snow=tp.Snowpack())
    return lambda p: dataclasses.replace(base, soil=with_differentiable_params(
        base.soil, log_sat_hydraulic_cond=p[0], mineral_conductivity=p[1]))


def land_grad_params(tp):
    """The consistent composition's own log K_sat and k_mineral."""
    grid = tp.ColumnGrid.of(cells=1, spacing=tp.ExponentialSpacing(N=LAND_NZ), device="cpu")
    soil_ = land_model(tp, grid, "consistent").soil
    return (float(np.log(soil_.hydrology.hydraulic_properties.sat_hydraulic_cond)),
            float(soil_.energy.thermal_properties.conductivities.mineral))


def land_grad_sim(tp, cells, dtype, name, scheme=None):
    """LAND_GRAD_SCHEMES[name] (or ``scheme``, ``(key, solver, dt, Picard
    iterations, snowpack)``) on ``cells`` columns at latitudes evenly
    spaced from -60 to 80 degrees: static shortwave 900 cos(lat) / pi and
    air temperature T_mean = 28 max(cos lat, 0.05) - 8, longwave 330, rain
    4e-8, wind 3; initial temperature T_mean, saturation 0.6, carbon 2,
    vegetation fraction 0.5; under LAND_GRAD_SNOW a snowfall of SNOWFALL and
    an initial pack of SWE0 (land_snow_n145's)."""
    if scheme is None:
        key, solver, dt = LAND_GRAD_SCHEMES[name]
        iters, snow = LAND_GRAD_PICARD.get(name, 1), name in LAND_GRAD_SNOW
    else:
        key, solver, dt, iters, snow = scheme
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=LAND_NZ),
                            dtype=dtype, device="cuda")
    lat = np.linspace(-60.0, 80.0, cells)
    coslat = np.maximum(np.cos(np.deg2rad(lat)), 0.05)
    T_mean = 28.0 * coslat - 8.0
    fields = {"surface_longwave_down": 330.0, "rainfall": 4.0e-8, "windspeed": 3.0,
              "surface_shortwave_down": 900.0 * coslat / np.pi, "air_temperature": T_mean}
    kw = {"picard_iters": iters} if iters != 1 else {}
    stepper = (tp.ImplicitEuler(dt=dt, solver=solver, **kw) if key == "implicit"
               else tp.Heun(dt=dt) if key == "heun" else tp.ForwardEuler(dt=dt))
    inits = {"temperature": lambda x, z: T_mean[None, :] + 0.0 * z,
             "saturation_water_ice": 0.6, "carbon_vegetation": 2.0,
             "vegetation_area_fraction": 0.5}
    if snow:
        fields["snowfall"] = SNOWFALL
        inits["snow_water_equivalent"] = SWE0
    return tp.initialize(land_grad_model_fn(tp, grid, snow)(land_grad_params(tp)), stepper,
                         (tp.FieldInputSource(fields=fields),), initializers=inits)


# the snowy group entries held at float64 besides land_snow_n145's PCR one
# (rows 1'g and 3'k): Thomas, PCR with two Picard iterations and Heun, each
# rollout over LAND_VARIANT_STEPS steps of LAND_DT with land_snow_n145's
# forcing and each segment VJP over a GRAD_INNER-step segment of its dt with
# land_grad_snow_implicit_pcr's static inputs: (wrapper key, solver, Picard
# iterations, the VJP's dt)
LAND_SNOW_ENTRIES = {"thomas": ("implicit", "thomas", 1, 600.0),
                     "picard2_pcr": ("implicit", "pcr", 2, 600.0),
                     "heun": ("heun", None, 1, 60.0)}


def land_snow_entries_check(tp, ls, lv, fs, land_inputs, card):
    """LAND_SNOW_ENTRIES at float64 on LAND_F64_CELLS columns: each group
    rollout against its plain version one step at a time along the plain
    trajectory at 1e-12 (land_teacher), each group segment VJP against
    autograd at rtol 1e-9 (land_vjp_compare); prints the phase
    ``group_check_snow_entries`` and raises where one fails or where a
    wrapper's source is not the group kernel's."""
    res = {}
    for name, (key, solver, iters, vdt) in LAND_SNOW_ENTRIES.items():
        kw = {"solver": solver} if solver else {}
        if iters != 1:
            kw["picard_iters"] = iters
        stepper = tp.Heun(dt=LAND_DT) if key == "heun" else tp.ImplicitEuler(dt=LAND_DT, **kw)
        sim = land_sim(tp, LAND_F64_CELLS, torch.float64, "consistent", stepper=stepper,
                       snow=True)
        carry, linputs, root, coords, params = land_operands(ls, land_inputs, sim)
        sources = (ls.rollout_source(params, key), lv.vjp_source(params, key))
        if sources != (LAND_GROUP_SOURCE, LAND_VJP_GROUP_SOURCE):
            raise AssertionError(f"snowy {name}: the wrappers launch {sources}")
        r_abs, r_rel, _, _, beyond, *_ = land_teacher(
            ls, fs, carry, linputs, root, coords, params, float(sim.state.clock.time),
            LAND_VARIANT_STEPS, land_f64_tolerance,
            kernel=functools.partial(ls.ROLLOUTS[key], **kw),
            plain=functools.partial(ls.land_column_rollout_plain, stepper=key, **kw))
        if beyond:
            raise AssertionError(f"snowy {name} rollout f64 vs plain: {beyond[:4]}")
        del sim, carry, linputs, root
        gsim = land_grad_sim(tp, LAND_F64_CELLS, torch.float64, None,
                             (key, solver, vdt, iters, True))
        ops = land_grad_operands(ls, land_inputs, gsim, seed=11)
        v_abs, v_rel, left_out = land_vjp_compare(
            lv, ls, *ops[:5], vdt, GRAD_INNER, ops[5],
            {"stepper": key, "solver": solver, "picard_iters": iters}, 1e-9, LAND_F64_CELLS)
        res[name] = dict(stepper=key, solver=solver, picard_iters=iters,
                         rollout_dt=LAND_DT, rollout_steps=LAND_VARIANT_STEPS,
                         rollout_f64_max_abs_err=r_abs, rollout_f64_max_err_over_magnitude=r_rel,
                         vjp_dt=vdt, vjp_steps=GRAD_INNER, vjp_f64_max_abs_err=v_abs,
                         vjp_f64_max_err_over_magnitude=v_rel, vjp_f64_columns_left_out=left_out)
        del gsim, ops
    phase("group_check_snow_entries", rows=["1'g", "3'k"], f64_cells=LAND_F64_CELLS,
          rollout_f64_rtol=1e-12, vjp_f64_rtol=1e-9, sources=[LAND_GROUP_SOURCE,
                                                             LAND_VJP_GROUP_SOURCE],
          entries=res, card=card)


def land_grad_value(tp, sim, name, params=None, grad=True, steps=GRAD_STEPS):
    """The loss mean(T) + mean(carbon) after ``steps`` steps of
    make_fused_grad_rollout (segments of GRAD_INNER) and, ``grad``, its
    gradient in (log K_sat, k_mineral) (float64 0-d leaves)."""
    from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout

    dt = LAND_GRAD_SCHEMES[name][2]
    p = tuple(torch.tensor(v, dtype=torch.float64, device="cuda", requires_grad=grad)
              for v in (params or land_grad_params(tp)))
    roll = make_fused_grad_rollout(land_grad_model_fn(tp, sim.model.grid,
                                                      name in LAND_GRAD_SNOW),
                                   sim.timestepper, sim.ctx, sim.input_sources, steps=steps,
                                   dt=dt, inner_steps=GRAD_INNER)
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
    columns: the cotangents and each column's share of the two parameter
    cotangents (``per_column``)."""
    cells = carry["internal_energy"].shape[1]
    ref = {n: torch.empty_like(t) for n, t in carry.items()}
    pK, pskm = (torch.empty(cells, dtype=carry["internal_energy"].dtype, device="cuda")
                for _ in range(2))
    for lo in range(0, cells, chunk):
        cols = torch.arange(lo, min(lo + chunk, cells), device="cuda")
        c, i, r, g = land_columns(ls, cols, carry, inputs, root, gout)
        part, pK[cols], pskm[cols] = lv.land_column_segment_vjp_plain(
            c, i, r, *coords, params, dt, 0.0, steps, g, per_column=True, **kw)
        for n in ref:
            ref[n][..., cols] = part[n]
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
    pK, pskm = (float(t[keep].sum()) for t in (pK, pskm))
    for n, a, b in (("K_sat", kK, pK), ("sk_mineral", kskm, pskm)):
        errs[n], rel[n] = abs(a - b), abs(a - b) / abs(b) if b != 0.0 else abs(a - b)
        if not b != 0.0 or abs(a - b) > rtol * abs(b):
            raise AssertionError(f"land VJP kernel vs plain {n}: {a} vs {b}")
    return errs, rel, int(bad.sum())


def land_vjp_compare_f32(lv, ls, name, carry, inputs, root, coords, params, dt, steps, gout,
                         kw):
    """The float32 land segment-VJP kernel at full width against its plain
    version (in chunks of LAND_GRAD_CHUNK columns): each cotangent within
    F32_VJP_REL_TOL of its field's largest magnitude. A column where the
    two part by more (a branch that flips between two float32 roundings:
    the freeze plateau's edge in dT/dU, saturation in d(Psi)/d(sat)) is held
    to a float64 plain referee from the same float32 operands instead: the
    kernel within twice the plain version's own float32 error plus the
    tolerance; such columns leave the parameter sums.

    The parameter cotangents are sums over the columns of shares of either
    sign. Each is held within F32_VJP_REL_TOL, summed with every column's
    output cotangents multiplied by the sign of the plain version's share
    there (the plain share becomes its magnitude, the sum has no
    cancellation): the kernel's launch on those cotangents against the sum
    of the plain shares' magnitudes. The sums under ``gout`` itself are held
    within F32_VJP_REL_TOL where a single Picard iteration runs; over more,
    where their cancellation makes float32 rounding move them by more than
    themselves, they are reported with their condition (the magnitudes'
    sum over the sum's) and the float64 kernel's sums on the same operands.
    Returns the errors, the errors over the magnitudes, and the flip
    columns' count with the plain version's largest float32 error there
    over each field's magnitude, with the sums' figures."""
    out_k, gK, gskm = lv.land_column_segment_vjp(carry, inputs, root, *coords, params, dt, 0.0,
                                                 steps, gout, **kw)
    ref, pK, pskm = land_vjp_plain_chunks(lv, ls, carry, inputs, root, coords, params, dt,
                                          steps, gout, kw, LAND_GRAD_CHUNK)
    if bool(nonfinite_columns(out_k).any()) or bool(nonfinite_columns(ref).any()):
        raise AssertionError(f"{name}: a non-finite float32 cotangent")
    if not (bool(torch.isfinite(pK).all()) and bool(torch.isfinite(pskm).all())):
        raise AssertionError(f"{name}: a non-finite float32 parameter share")
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
    f64 = torch.float64
    kK, kskm = float(gK), float(gskm)
    if bool(flip.any()):
        cols = flip.nonzero().flatten()
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
    sums = {}
    for idx, (n, a, share) in enumerate((("K_sat", kK, pK), ("sk_mineral", kskm, pskm))):
        share = share[keep].double()
        b, mag = float(share.sum()), float(share.abs().sum())
        if not b != 0.0:
            raise AssertionError(f"{name}: the plain version's {n} cotangent is 0")
        # the same sum with no cancellation: column c's output cotangents
        # times the sign of its plain share
        sign = torch.where(share < 0.0, -1.0, 1.0).to(carry["internal_energy"].dtype)
        c, i, r, g = land_columns(ls, keep, carry, inputs, root, gout)
        g = {m: t * sign for m, t in g.items()}
        aligned = float(lv.land_column_segment_vjp(c, i, r, *coords, params, dt, 0.0, steps, g,
                                                   **kw)[1 + idx])
        errs[n], rel[n] = abs(aligned - mag), abs(aligned - mag) / mag
        if rel[n] > F32_VJP_REL_TOL:
            raise AssertionError(f"{name}: float32 kernel vs plain {n} with sign-aligned "
                                 f"cotangents: {aligned} vs {mag}")
        sums[n] = {"kernel": a, "plain": b, "rel": abs(a - b) / abs(b),
                   "condition": mag / abs(b), "aligned_kernel": aligned, "aligned_plain": mag}
        if kw.get("picard_iters", 1) == 1:
            if abs(a - b) > F32_VJP_REL_TOL * abs(b):
                raise AssertionError(f"{name}: float32 kernel vs plain {n}: {a} vs {b}")
        else:
            if "f64_kernel" not in sums:
                c, i, r, g = land_columns(ls, keep, carry, inputs, root, gout, dtype=f64)
                _, rK, rskm = lv.land_column_segment_vjp(
                    c, i, r, *(t.to(f64) for t in coords), ls.LandParams.of(params.model, f64),
                    dt, 0.0, steps, g, **kw)
                sums["f64_kernel"] = {"K_sat": float(rK), "sk_mineral": float(rskm)}
    flips["parameter_sums"] = sums
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


def bench_sim(tp, cells=BENCH_CELLS, dtype=torch.float32):
    """`bench.py:43-64`: N145 land cells, Nz 30, float32, dt 60 s."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=BENCH_NZ),
                            dtype=dtype, device="cuda")
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


def implicit_sim(tp, solver, cells=BENCH_CELLS, dtype=torch.float32, nz=BENCH_NZ):
    """`bench_configs.py:141-199` (column_implicit_tridiag): the bench model,
    initial state and top temperature, ImplicitEuler at dt 900 s."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz), dtype=dtype,
                            device="cuda")
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


def heun_sim(tp, cells, dtype=torch.float32):
    """`bench_configs.py:414-449`: heat + Richards as bench, Heun at dt 60 s,
    the top temperature from an hourly (744, cells) float32 series
    5 sin(2 pi t / 86400), made on the card (169 MB at full width)."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=BENCH_NZ),
                            dtype=dtype, device="cuda")
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


def heat_sim(tp, cells, dtype, nz=BENCH_NZ):
    """`bench_configs.py:202-225` on ``cells`` synthetic columns at
    latitudes evenly spaced from -60 to 80 degrees: the default (heat-only)
    SoilModel, ForwardEuler at dt 300 s, an hourly (744, cells) float32
    series T_mean + 8 sin(2 pi t / 86400), T_mean = 25 max(cos lat, 0.05) -
    5, also the initial temperature; saturation 0.8."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=nz),
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


def heat_stepper_sim(tp, cells, dtype, nz, stepper):
    """heat_sim's model, state and series stepped by ``stepper``."""
    base = heat_sim(tp, cells, dtype, nz=nz)
    return tp.Simulation(base.model, stepper, base.state, base.input_sources, bcs=base.bcs)


def picard_sim(tp, solver, cells=BENCH_CELLS, dtype=torch.float32, nz=BENCH_NZ):
    """implicit_sim's composition with PICARD_ITERS Picard iterations."""
    base = implicit_sim(tp, solver, cells=cells, dtype=dtype, nz=nz)
    return tp.Simulation(base.model, tp.ImplicitEuler(dt=IMPLICIT_DT, solver=solver,
                                                      picard_iters=PICARD_ITERS),
                         base.state, bcs=base.bcs)


def step_tolerance(plain, start, f64):
    """The per-cell tolerance of one float64 (1e-12 of the value, with a
    floor of 1e-12 of the field's largest magnitude) or float32 step
    (F32_REL_TOL of the field's largest change in the step plus 16 units of
    2^-23 of the value, as land_f32_tolerance holds the soil's fields)."""
    if f64:
        return 1e-12 * plain.abs() + 1e-12 * float(plain.abs().max())
    return F32_REL_TOL * float((plain - start).abs().max()) + 16 * 2.0 ** -23 * plain.abs()


def soil_teacher(kernel, plain, carry, top_at, steps, referee=None):
    """A soil kernel against its plain version along the plain trajectory:
    at each of ``steps`` steps, ``kernel(U, sat, S, top)`` and ``plain(U,
    sat, S, top)``, each one step from the plain version's carry
    (``top_at(i)`` the step's top temperature as the kernel takes it), the
    plain one carried on, so that no step's error grows in the next. Each
    field is held by step_tolerance. A float32 cell beyond it (a layer that
    crosses the freeze plateau's edge or saturation on one side of an ulp
    only) is held to ``referee(U, sat, S, top)``, the plain step at float64
    from the same float32 operands: the kernel within twice the plain
    version's own float32 error plus the tolerance. Returns per field the
    largest error and the largest over its magnitude, and the number of such
    flip cells."""
    f64 = carry[0].dtype == torch.float64
    cp = carry
    worst, worst_abs, flips = {}, {}, 0
    for i in range(steps):
        top = top_at(i)
        k1, p1 = kernel(*cp, top), plain(*cp, top)
        truth = None
        for j, (n, a, b, c) in enumerate(zip(("U", "sat", "S"), k1, p1, cp)):
            if b is None:
                continue
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"soil teacher: non-finite kernel {n} at step {i + 1}")
            err = (a - b).abs()
            worst_abs[n] = max(worst_abs.get(n, 0.0), float(err.max()))
            worst[n] = max(worst.get(n, 0.0),
                           float(err.max()) / max(float(b.abs().max()), 1e-300))
            tol = step_tolerance(b, c, f64)
            bad = err > tol
            if not bool(bad.any()):
                continue
            if f64 or referee is None:
                raise AssertionError(f"soil teacher: kernel {n} beyond the tolerance at step "
                                     f"{i + 1}: max abs err {float(err.max())}")
            if truth is None:
                truth = referee(*cp, top)
            k_err, p_err = (a.double() - truth[j]).abs(), (b.double() - truth[j]).abs()
            if bool((bad & (k_err > 2.0 * p_err + tol.double())).any()):
                raise AssertionError(f"soil teacher: float32 kernel {n} vs the float64 referee "
                                     f"at step {i + 1}: {float(k_err.max())} against the plain "
                                     f"version's {float(p_err.max())}")
            flips += int(bad.sum())
        cp = p1
    return worst_abs, worst, flips


def plateau_share(state):
    """The share of columns with a layer on the freeze plateau (0 < liquid
    fraction < 1)."""
    liq = state.liquid_water_fraction
    return float(((liq > 0.0) & (liq < 1.0)).any(0).float().mean())


#: this slice's forward paths: name -> (kind, solver)
NEW_FORWARD = {"heat_heun_n145": ("heat_heun", None),
               **{f"heat_implicit_{s}_n145": ("heat_implicit", s) for s in SOLVERS},
               **{f"picard2_implicit_{s}_n145": ("picard", s) for s in SOLVERS}}


def new_forward_sim(tp, kind, solver, cells, dtype, nz):
    if kind == "heat_heun":
        return heat_stepper_sim(tp, cells, dtype, nz, tp.Heun(dt=HEAT_HEUN_DT))
    if kind == "heat_implicit":
        return heat_stepper_sim(tp, cells, dtype, nz,
                                tp.ImplicitEuler(dt=HEAT_IMPLICIT_DT, solver=solver))
    return picard_sim(tp, solver, cells=cells, dtype=dtype, nz=nz)


def new_forward_operands(fs, kind, solver, sim):
    """The kernel wrapper, its keywords, the plain version's keywords, dt,
    the carry, ``top(i, steps)`` (the top temperature of ``steps`` steps
    from clock step ``i``, as the kernel takes it), the coordinates and the
    parameters of one of this slice's forward paths."""
    from terrarium_tpu_torch.timesteppers.integrator import clock_times, top_temperature_table

    g = sim.model.grid
    heat = kind != "picard"
    dt = {"heat_heun": HEAT_HEUN_DT, "heat_implicit": HEAT_IMPLICIT_DT,
          "picard": IMPLICIT_DT}[kind]
    stepper = "heun" if kind == "heat_heun" else "implicit"
    kw = {} if kind == "heat_heun" else {"solver": solver}
    if kind == "picard":
        kw["picard_iters"] = PICARD_ITERS
    wrapper = fs.ROLLOUTS[stepper, "heat" if heat else "richards"]
    pkw = dict(kw, stepper=stepper, physics="heat" if heat else "richards")
    coords = tuple(getattr(g, n)[:, 0].contiguous()
                   for n in ("dz", "dz_faces", "z_centers", "z_faces"))
    st = sim.state
    carry = (st.prognostic["internal_energy"].contiguous(), st.saturation_water_ice.contiguous(),
             None if heat else st.prognostic["surface_excess_water"].contiguous())
    times = clock_times(st.clock.time, dt, COMPARE_STEPS + 1)
    if heat:
        values = torch.as_tensor(sim.input_sources[0].series["surface_temperature"],
                                 device="cuda").to(g.dtype).contiguous()

        def top(i, steps):
            return fs.SeriesBC(values, 0.0, SERIES_DTS, float(times[i]), steps)
    else:
        table = top_temperature_table(sim.bcs["temperature"]["top"].value, times, g)

        def top(i, steps):
            return table[i:i + steps]
    return (wrapper, kw, pkw, dt, carry, top, coords, fs.ColumnParams.of(sim.model, g.dtype))


def new_forward_phase(tp, fs, cuda_build, name, reset_counts, launched, card):
    """One of this slice's forward paths (NEW_FORWARD): the kernel against
    its plain version along the plain trajectory (soil_teacher) at float64
    on HEAT_F64_CELLS columns, Nz NEW_F64_NZ, and at float32 at full width,
    with the float64 referee; the kernel and the plain version timed over
    COMPARE_STEPS steps (CUDA events); then Simulation.run: one warm-up run,
    one timed block. Prints the phase; returns what the kernel report
    reads."""
    kind, solver = NEW_FORWARD[name]
    heat = kind != "picard"
    for dtype, cells, nz in ((torch.float64, HEAT_F64_CELLS, NEW_F64_NZ),
                             (torch.float32, BENCH_CELLS, BENCH_NZ)):
        sim = new_forward_sim(tp, kind, solver, cells, dtype, nz)
        wrapper, kw, pkw, dt, carry, top, coords, params = new_forward_operands(fs, kind,
                                                                                solver, sim)

        def kernel(U, sat, S, bc):
            return wrapper(U, sat, S, bc, *coords, params, dt, **kw)

        def plain(U, sat, S, bc):
            return fs.soil_column_rollout_plain(U, sat, S, bc, *coords, params, dt, **pkw)

        f64 = torch.float64
        coords64 = tuple(c.to(f64) for c in coords)
        params64 = fs.ColumnParams.of(sim.model, f64)

        def referee(U, sat, S, bc):
            bc = (dataclasses.replace(bc, values=bc.values.to(f64))
                  if isinstance(bc, fs.SeriesBC) else bc.to(f64))
            return fs.soil_column_rollout_plain(U.to(f64), sat.to(f64),
                                                None if S is None else S.to(f64), bc,
                                                *coords64, params64, dt, **pkw)

        errs = soil_teacher(kernel, plain, carry, lambda i: top(i, 1), COMPARE_STEPS,
                            referee=None if dtype == f64 else referee)
        if dtype == f64:
            f64_errs = errs
            del sim
            continue
        bc = top(0, COMPARE_STEPS)
        out_k = kernel(*carry, bc)
        ident = None
        if not heat:  # W = sum(sat dz) + S after the 144-step launch
            dz = coords[0][:, None]
            w0 = (carry[1].double() * dz.double()).sum(0) + carry[2].double()
            w1 = (out_k[1].double() * dz.double()).sum(0) + out_k[2].double()
            ident = float(((w1 - w0).abs() / w0.abs()).max())
            if ident > IMPLICIT_F32_WATER_TOL:
                raise AssertionError(f"{name}: water identity through the kernel {ident}")
        k_ms = cuda_ms(lambda: kernel(*carry, bc), reps=3, warmup=True)
        p_ms = cuda_ms(lambda: plain(*carry, bc))
        if kind == "heat_heun":
            ops = HEAT_HEUN_OPS_PER_LEVEL_STEP * nz + 2 * SERIES_OPS_PER_READ
        elif kind == "heat_implicit":
            ops = heat_implicit_ops(solver, nz) + SERIES_OPS_PER_READ
        else:
            ops = picard_ops(solver, nz, PICARD_ITERS)
        if heat:
            rows = series_rows_read(bc, dt, stages=2 if kind == "heat_heun" else 1)
            nbytes = 3 * nz * cells * 4 + rows * cells * 4
        else:
            nbytes = 2 * (2 * nz + 1) * cells * 4 + COMPARE_STEPS * 4
        b = bound_ms(ops * cells * COMPARE_STEPS, nbytes)
        del out_k
        tags = fs.kernel_tags("heun" if kind == "heat_heun" else "implicit",
                              "heat" if heat else "richards",
                              PICARD_ITERS if kind == "picard" else 1,
                              plain_euler=(), solver=solver or "pcr")
        source = GROUP_SOURCE if kind == "picard" else "soil_column_rollout"
        entry = cuda_build._entry_name(source, tags, dtype, nz)
        ptxas = ptxas_summary(cuda_build.ptxas_report(source)).get(entry, {})
        group = None
        if kind == "picard":  # row 1'j on the group kernel
            group = group_row(fs, cuda_build, "implicit", (carry, top(0, COMPARE_STEPS), coords,
                                                           params), dt, {source: {entry: ptxas}},
                              implicit_fma_issues(solver, nz, PICARD_ITERS,
                                                  fs._CParams.of(params)) / nz,
                              solver=solver, picard_iters=PICARD_ITERS)
            phase("group_check", row="1'j", solver=solver, picard_iters=PICARD_ITERS,
                  cells=cells, nz=nz, steps=COMPARE_STEPS, **group, card=card)
        # the run block: one warm-up run, then one timed block
        block = {"heat_heun": HEAT_HEUN_BLOCK_STEPS, "heat_implicit": HEAT_IMPLICIT_BLOCK_STEPS,
                 "picard": PICARD_BLOCK_STEPS}[kind]
        sim.run(steps=COMPARE_STEPS)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        sim.run(steps=block)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = launched()
        if launches != {wrapper.__name__: 1}:
            raise AssertionError(f"{name}: the run block launched {launches}")
        st = sim.state
        fields = ("internal_energy", "temperature", "liquid_water_fraction",
                  "hydraulic_conductivity")
        if not heat:
            fields += ("saturation_water_ice", "surface_excess_water", "pressure_head")
        for n in fields:
            if not bool(torch.isfinite(st[n]).all()):
                raise AssertionError(f"{name}: non-finite {n}")
        if heat and not bool((st.saturation_water_ice == 0.8).all()):
            raise AssertionError(f"{name}: the saturation changed")
        sat = st.saturation_water_ice
        if not heat and not (float(sat.min()) >= 0.0 and float(sat.max()) <= 1.0):
            raise AssertionError(f"{name}: saturation left [0, 1]")
        if sim.iteration != COMPARE_STEPS + block:
            raise AssertionError(f"{name}: clock iteration {sim.iteration}")
        phase(name, cells=cells, nz=nz, dt=dt, steps=block, solver=solver,
              picard_iters=PICARD_ITERS if kind == "picard" else 1, seconds=run_s,
              launches=launches, cells_steps_per_s=cells * block / run_s,
              compare_steps=COMPARE_STEPS, f64_cells=HEAT_F64_CELLS, f64_nz=NEW_F64_NZ,
              f64_max_abs_err=f64_errs[0], f64_max_err_over_magnitude=f64_errs[1],
              f32_max_abs_err=errs[0], f32_max_err_over_magnitude=errs[1],
              f32_flip_cells=errs[2], water_identity_rel_err=ident, kernel_ms=k_ms,
              plain_ms=p_ms, bound_ms=b[0], bound_by=b[1], ops_per_column_step=ops,
              plateau_share_end=plateau_share(st),
              T_top_range=[float(st.temperature[-1].min()), float(st.temperature[-1].max())],
              ptxas=ptxas, entry=entry, card=card)
        return dict(wrapper=wrapper.__name__, launches=launches[wrapper.__name__],
                    max_abs_err=max(errs[0].values()), ms=k_ms, plain_ms=p_ms, bound_ms=b[0],
                    bound_by=b[1], entry=entry, kind=kind, solver=solver, source=source,
                    group=group)


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
    "series": ..., "cpu_s": 41.3}, ...}`` from the build's ptxas ``-v``
    report, whose part of each instantiation is headed ``== <entry point>``
    and ``cpu_s <seconds>`` (its nvcc's CPU time, where the build recorded
    it); a rollout entry (the group rollout's too: <T, NZ, G, STEPPER,
    SOLVER, SERIES>) holds a table and a series kernel, the group rollout's
    ImplicitEuler entries one of each a solver, keyed ``"table_pcr"``,
    ``"series_thomas"``, ..., the VJP's its kernel and the reduction (the
    group VJP's ImplicitEuler entries a kernel of each solver, ``"vjp_pcr"``,
    ``"vjp_thomas"``; its ForwardEuler and Heun entries one, ``"vjp"``), the
    land and full-step entries their one kernel."""
    out, entry, key = {}, None, None
    for ln in report.splitlines():
        if ln.startswith("== "):
            entry = ln[3:].strip()
            out[entry] = {}
            continue
        if ln.startswith("cpu_s ") and entry:
            out[entry]["cpu_s"] = float(ln.split()[1])
            continue
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m and entry:
            name = m.group(1)
            # <T, NZ, G, STEPPER, SOLVER, SERIES> (the group rollout);
            # <T, NZ, STEPPER, SOLVER, HEAT, PICARD, SERIES>; before the
            # Picard entries, <T, NZ, STEPPER, SOLVER, HEAT, SERIES>
            group = re.search(r"group_rollout_kernelI[fd]Li\d+ELi\d+ELi(\d)ELi(\d)ELb([01])E",
                              name)
            flags = group or re.search(
                r"rollout_kernelI[fd]Li\d+ELi\d+ELi\d+E(?:Lb[01]E){1,2}Lb([01])E", name)
            if flags:
                key = "series" if flags.group(flags.lastindex) == "1" else "table"
                if group and group.group(1) == "2":
                    key += "_" + ("pcr" if group.group(2) == "1" else "thomas")
            elif "soil_column_group_segment_vjp_kernel" in name:
                # <T, NZ, G, STEPPER, SOLVER>: ImplicitEuler's a kernel of
                # each solver, ForwardEuler's and Heun's one
                stepper, solver = re.search(r"kernelI[fd]Li\d+ELi\d+ELi(\d)ELi(\d)E",
                                            name).groups()
                key = "vjp" if stepper != "2" else "vjp_" + ("pcr" if solver == "1"
                                                             else "thomas")
            elif "group_segment_vjp_kernel" in name or "land_column_group_rollout" in name:
                # <T, NZ, G, STEPPER, SOLVER>: ImplicitEuler's a kernel of
                # each solver, Heun's one
                stepper, solver = re.search(r"kernelI[fd]Li\d+ELi\d+ELi(\d)ELi(\d)E",
                                            name).groups()
                key = ("land_" if "rollout" in name else "vjp_") + (
                    "heun" if stepper == "1" else "pcr" if solver == "1" else "thomas")
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


@functools.lru_cache(maxsize=None)
def sass_counts(cuobjdump: str, lib: str) -> tuple:
    """``((function, SASS instructions, NOPs aside), ...)`` of a library, in
    ``cuobjdump -sass``'s order; read once a run, since every group_check
    line asks the same prebuilt library."""
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out = []
    for ln in text.splitlines():
        f = re.match(r"\s*Function : (\S+)", ln)
        if f:
            out.append([f.group(1), 0])
        elif out and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", ln) and " NOP" not in ln:
            out[-1][1] += 1
    return tuple((name, n) for name, n in out)


def sass_instructions(cuda_build, source, entry, series, solver="pcr"):
    """The SASS instructions, NOPs aside, of the table or (``series``) the
    series kernel of a rollout ``entry`` of ``source`` (a group rollout's
    ImplicitEuler entry: its kernel of ``solver``; the group segment VJP's
    entry, ``series`` unread: its kernel of ``solver``), from ``cuobjdump -sass``
    of the library that holds it (the prebuilt one, or the entry's own where
    it was built alone)."""
    stem = cuda_build._stem(source)
    lib = cuda_build._BUILD_DIR / f"{stem}-{entry}.so"
    if not lib.exists():
        lib = cuda_build._BUILD_DIR / f"{stem}.so"
    cuobjdump = pathlib.Path(cuda_build._nvcc()).with_name("cuobjdump")
    # the entry's kernel, by its mangled template arguments: the group
    # rollout's <T, NZ, G, STEPPER, SOLVER, SERIES> and the group segment
    # VJPs' and the land group rollout's <T, NZ, G, STEPPER, SOLVER> (SOLVER
    # 1 for the explicit steppers), the one-thread rollout's <T, NZ,
    # STEPPER, SOLVER, HEAT, PICARD, SERIES>; the element type and the depth
    # from the entry's name
    m = re.search(r"_(f32|f64)_nz(\d+)$", entry)
    t, nz = {"f32": "f", "f64": "d"}[m.group(1)], m.group(2)
    stepper = {"euler": 0, "heun": 1, "implicit": 2}[
        next(k for k in ("euler", "heun", "implicit") if f"_{k}_" in entry)]
    code = {"thomas": 0, "pcr": 1}[solver] if stepper == 2 else 1
    if source in (VJP_GROUP_SOURCE, LAND_VJP_GROUP_SOURCE, LAND_GROUP_SOURCE):
        # <T, NZ, G, STEPPER, SOLVER>
        want = re.compile(rf"{source}_kernelI{t}Li{nz}ELi\d+ELi{stepper}ELi{code}EE")
    elif source == GROUP_SOURCE:
        want = re.compile(rf"group_rollout_kernelI{t}Li{nz}ELi\d+ELi{stepper}ELi{code}E"
                          rf"Lb{int(series)}EE")
    else:
        want = re.compile(rf"soil_column_rollout_kernelI{t}Li{nz}ELi{stepper}ELi\d+E"
                          rf"(?:Lb[01]E)*Lb{int(series)}EE")
    # the first such kernel: a library of several entries may hold the same
    # instantiation twice (a group ImplicitEuler entry and the Picard one)
    return next((n for name, n in sass_counts(str(cuobjdump), str(lib)) if want.search(name)),
                0)


GROUP_F64_CELLS = 1024


def group_row(fs, cuda_build, stepper, operands, dt, ptxas_all, fma_per_level_step,
              solver="pcr", picard_iters=1):
    """What the kernel line reports of the group rollout of ``stepper``
    (heat + Richards; ForwardEuler and ImplicitEuler, with ``solver`` and
    ``picard_iters``, read a table, Heun a series) at the shape of
    ``operands``: its group size G and levels a lane, ptxas's registers and
    spill stores, resident warps an SM, SASS instructions, the saturation
    sweeps' serial hand-offs in one launch of its wrapper on ``operands``
    (up, down, and their sum per column and step) and the bound with each
    operation weighted by its cost (``fma_per_level_step`` FMA issues a
    level and step at H100_FMA_ISSUES)."""
    carry, top, coords, params = operands
    series = isinstance(top, fs.SeriesBC)
    dtype, (nz, cells) = carry[0].dtype, carry[0].shape
    steps = top.steps if series else top.shape[0] - (1 if stepper == "heun" else 0)
    tags = fs.kernel_tags(stepper, "richards", picard_iters, plain_euler=(), solver=solver)
    entry = cuda_build._entry_name(GROUP_SOURCE, tags, dtype, nz)
    kind = "series" if series else "table"
    ptxas = ptxas_all[GROUP_SOURCE][entry][kind + (f"_{solver}" if stepper == "implicit"
                                                    else "")]
    warps, group = fs.group_occupancy(stepper, dtype, nz, series, solver=solver,
                                      picard_iters=picard_iters)
    _, (up, down) = fs.soil_column_group_handoffs(stepper, *carry, top, *coords, params, dt,
                                                  solver=solver, picard_iters=picard_iters)
    return {"group": group, "levels_a_lane": -(-nz // group),
            "registers": int(ptxas.split()[0]),
            "spill_stores": int(ptxas.split(",")[1].split()[0]),
            "resident_warps_per_sm": warps,
            "sass_instructions": sass_instructions(cuda_build, GROUP_SOURCE, entry, series,
                                                   solver),
            "handoffs_up": up, "handoffs_down": down,
            "handoffs_per_column_step": (up + down) / (cells * steps),
            "bound_weighted_ms": fma_per_level_step * nz * cells * steps / H100_FMA_ISSUES * 1e3}


# The group segment VJP (rows 3'b and 3'h), per column and step, weighted
# by row 4's rates as implicit_fma_issues weights the forward: the forward
# step's FMA issues (implicit_fma_issues) and, per iteration, its adjoint's
# operations (scheme_vjp_ops less the forward), of which per level the
# cheaper sides' IEEE divisions: rhs_adjoint's 12 (the Darcy flux's six, the
# heat flux's four, the liquid fraction's two on the freeze plateau; no head
# derivative, no sweep reset) and d(Psi)/d(sat)'s derivative 1 (its se
# quotient, at or above saturation); per interior face the two systems'
# rows' four quotients each (8); per column a transposed solve's divisions
# a system and the Dirichlet top row's quotient; each further iteration's
# two -lambda / dt a level
VJP_ADJ_DIVISIONS_PER_LEVEL = 12 + 1
VJP_ADJ_DIVISIONS_PER_FACE = 8


def implicit_vjp_fma_issues(solver, nz, iters, cparams):
    """FMA issues of one step of one column of the segment VJP of
    ImplicitEuler over heat + Richards with ``iters`` Picard iterations."""
    if solver == "thomas":
        solve_div = 2 * nz
    else:
        s, solve_div = 1, nz
        while s < nz:
            solve_div += 2 * (nz - s)
            s *= 2
    name = next(n for n, cfg in GRAD_SCHEMES.items() if cfg["stepper"] == "implicit"
                and cfg["physics"] == "richards" and cfg["solver"] == solver
                and cfg.get("picard", 1) == iters)
    adjoint = scheme_vjp_ops(name, nz) - picard_ops(solver, nz, iters)
    div = (iters * (VJP_ADJ_DIVISIONS_PER_LEVEL * nz + VJP_ADJ_DIVISIONS_PER_FACE * (nz - 1)
                    + 2 * solve_div + 1) + (iters - 1) * 2 * nz)
    return (implicit_fma_issues(solver, nz, iters, cparams) + adjoint
            + div * (FWD_WEIGHTS["division"][1] - 1.0))


# The group segment VJP of ForwardEuler and Heun (rows 3 and 3'a) weighted
# the same way: the forward step's FMA issues (FWD_FMA_ISSUES_PER_LEVEL_STEP,
# HEUN_FMA_ISSUES_PER_LEVEL_STEP) and the adjoint's operations (the VJP's
# ops less the forward's: ADJ_OPS once, Heun twice and its 10), of which
# rhs_adjoint's 12 IEEE divisions a level (VJP_ADJ_DIVISIONS_PER_LEVEL less
# d(Psi)/d(sat)'s, which only ImplicitEuler takes), once a step, Heun twice
RHS_ADJ_DIVISIONS_PER_LEVEL = VJP_ADJ_DIVISIONS_PER_LEVEL - 1


def explicit_vjp_fma_issues(stepper, nz):
    """FMA issues of one step of one column of the segment VJP of ForwardEuler
    (``"euler"``) or Heun over heat + Richards."""
    heun = stepper == "heun"
    fwd_ops = (HEUN_OPS_PER_LEVEL_STEP if heun else FWD_OPS_PER_LEVEL_STEP) * nz
    fwd_fma = (HEUN_FMA_ISSUES_PER_LEVEL_STEP if heun else FWD_FMA_ISSUES_PER_LEVEL_STEP) * nz
    ops = (HEUN_VJP_OPS_PER_LEVEL_STEP if heun else VJP_OPS_PER_LEVEL_STEP) * nz
    div = (2 if heun else 1) * RHS_ADJ_DIVISIONS_PER_LEVEL * nz
    return fwd_fma + (ops - fwd_ops) + div * (FWD_WEIGHTS["division"][1] - 1.0)


def vjp_launcher(fs, fv, fn, group, operands, dt, solver, iters, stepper="implicit"):
    """``(launch, scratch)``: ``launch()`` launches the segment-VJP entry
    ``fn`` of ``stepper`` on ``operands`` (carry, table, coordinates,
    parameters, output cotangents; Heun's table one row longer than its
    steps) and returns ``(gU0, gsat0, gS0, gparams)``; its scratch buffer,
    partials and outputs are the caller's, laid out for the group kernel of
    G ``group`` (the scratch [step][column][row]) or, ``group`` None, for
    one thread a column ([step][row][column])."""
    carry, table, coords, params, cts = operands
    U = carry[0]
    nz, cells = U.shape
    steps, rows = table.shape[0] - (stepper == "heun"), 2 * nz + 1
    if group:
        blocks = -(-cells // (fv._GROUP_THREADS // group))
        shape = (steps, cells, rows)
    else:
        blocks = -(-cells // fv._THREADS)
        shape = (steps, rows, cells)
    scratch = torch.full(shape, float("nan"), dtype=U.dtype, device=U.device)
    outs = [torch.empty_like(t) for t in carry]
    partials = torch.empty(2, blocks, dtype=U.dtype, device=U.device)
    gparams = torch.empty(2, dtype=U.dtype, device=U.device)
    cparams = fs._CParams.of(params)

    def launch():
        err = fn(*(t.data_ptr() for t in (*carry, *cts, *outs, partials, gparams, scratch,
                                           table)),
                 table.stride(0), table.stride(1) if table.dim() == 2 else 0,
                 *(c.data_ptr() for c in coords), ctypes.byref(cparams), steps, float(dt),
                 cells, fs.SOLVER_CODES[solver], int(iters),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"segment VJP launch failed: cudaError {err}")
        return (*outs, gparams)
    return launch, scratch


def vjp_group_of(fs, fv, cuda_build, tags, solver, dtype, nz):
    """``(resident warps an SM, G)`` of the kernel of ``solver`` in the group
    segment-VJP entry of ``tags``."""
    fn = cuda_build.entry(fv._GROUP_NAME, dtype, nz, [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                          tags=tags, suffix="_warps")
    group = ctypes.c_int(0)
    return fn(fs.SOLVER_CODES[solver], ctypes.byref(group)), group.value


def vjp_recompute_check(fs, fv, cuda_build, operands, dt, solver, iters, tags=None,
                        stepper="implicit", rollout=None):
    """The group segment VJP's forward against the group rollout: the VJP
    entry of the scheme (``stepper``, heat + Richards; or of ``tags``:
    another group size or launch bound) launched on ``operands`` (carry,
    table, coordinates, parameters, output cotangents) with a scratch
    buffer of the check's own, then each carry it stored (step s's input)
    against the carry that the group rollout (the scheme's wrapper in
    ``fs.ROLLOUTS``, the forward segments' kernel, or ``rollout(carry,
    rows)``) reaches after s steps, one step a launch (Heun from two rows of
    the table, ``table[s:s + 2]``). Returns ``(steps, columns whose stored
    carry differs at some step)``: 0 where every carry is equal bit for
    bit."""
    carry, table, coords, params, _ = operands
    nz, cells = carry[0].shape
    heun = stepper == "heun"
    tags = fv.vjp_tags(stepper, "richards", solver, iters) if tags is None else tuple(tags)
    fn = cuda_build.entry(fv._GROUP_NAME, carry[0].dtype, nz, fv._ARGTYPES, tags=tags)
    group = vjp_group_of(fs, fv, cuda_build, tags, solver, carry[0].dtype, nz)[1]
    launch, scratch = vjp_launcher(fs, fv, fn, group, operands, dt, solver, iters, stepper)
    launch()
    if rollout is None:
        kw = {"solver": solver, "picard_iters": iters} if stepper == "implicit" else {}

        def rollout(state, rows):
            return fs.ROLLOUTS[stepper, "richards"](*state, rows, *coords, params, dt, **kw)
    steps = table.shape[0] - heun
    state, parted = carry, torch.zeros(cells, dtype=torch.bool, device=carry[0].device)
    for i in range(steps):
        rec = scratch[i]
        stored = (rec[:, :nz].t(), rec[:, nz:2 * nz].t(), rec[:, 2 * nz])
        for a, b in zip(stored, state):
            d = a != b
            parted |= d.any(0) if d.dim() == 2 else d
        state = rollout(state, table[i:i + 1 + heun])
    return steps, int(parted.sum())


def vjp_group_row(fs, fv, cuda_build, operands, dt, solver, iters, ptxas_all,
                  stepper="implicit"):
    """What the kernel line reports of the group segment VJP of ``stepper``
    over heat + Richards (ImplicitEuler: ``solver``, ``iters`` Picard
    iterations) at the shape of ``operands``: its group size G and levels a
    lane, ptxas's registers and spill stores, resident warps an SM, SASS
    instructions, the recompute check (vjp_recompute_check: the columns
    whose stored carries part from the group rollout's, which must be none)
    and the bound with each operation weighted by its cost
    (implicit_vjp_fma_issues, explicit_vjp_fma_issues)."""
    carry, table, coords, params, _ = operands
    dtype, (nz, cells) = carry[0].dtype, carry[0].shape
    implicit = stepper == "implicit"
    steps = table.shape[0] - (stepper == "heun")
    entry = cuda_build._entry_name(VJP_GROUP_SOURCE, fv.vjp_tags(stepper, "richards", solver,
                                                                  iters), dtype, nz)
    ptxas = ptxas_all[VJP_GROUP_SOURCE][entry]["vjp_" + solver if implicit else "vjp"]
    warps, group = fv.vjp_group(dtype, nz, solver, iters, stepper)
    checked, parted = vjp_recompute_check(fs, fv, cuda_build, operands, dt, solver, iters,
                                          stepper=stepper)
    if parted:
        raise AssertionError(f"group segment VJP {stepper} {solver} x{iters}: the stored "
                             f"carries of {parted} columns part from the group rollout's")
    fma = (implicit_vjp_fma_issues(solver, nz, iters, fs._CParams.of(params)) if implicit
           else explicit_vjp_fma_issues(stepper, nz))
    return {"group": group, "levels_a_lane": -(-nz // group),
            "registers": int(ptxas.split()[0]),
            "spill_stores": int(ptxas.split(",")[1].split()[0]),
            "resident_warps_per_sm": warps,
            "sass_instructions": sass_instructions(cuda_build, VJP_GROUP_SOURCE, entry, False,
                                                   solver),
            "recompute_steps_checked": checked, "recompute_columns_parted": parted,
            "fma_issues_per_column_step": fma,
            "bound_weighted_ms": fma * cells * steps / H100_FMA_ISSUES * 1e3}

# The land ImplicitEuler segment VJP (rows 3'e and 3'i) weighted by row 4's
# rates as implicit_vjp_fma_issues weights the soil's: land_vjp_ops with
# each IEEE division at 15.6 FMA issues, each exp, cos, log, atan and root
# at an exp's 9.6 and each powf at 70. Counted from csrc/land_step.cuh and
# land_adjoint.cuh for the Brooks-Corey and linear composition. Per level
# and iteration, the forward's divisions: the sweeps' c / dz x2; the energy
# closure's safediv and two Tk quotients; the linear centre K's and the
# plant-available water's quotients; the heat flux's gradient and
# divergence; the Brooks-Corey head's se and its power's reciprocal; the
# Darcy gradient, divergence and / por; dT/dU's reciprocal; bc_chain's se,
# its power's reciprocal and / span (18); the adjoint's: the soil's 13
# (VJP_ADJ_DIVISIONS_PER_LEVEL), the linear centre K's two cotangent
# quotients and the plant-available water's one (16). Per interior face the
# two systems' rows' four quotients each, forward and adjoint (8 and
# VJP_ADJ_DIVISIONS_PER_FACE). Per column and iteration: the two solves
# (Thomas two divisions a row, PCR two a row and round with both neighbours,
# one with one, then d / b), forward and transposed; the top rows' G / dz,
# infiltration / dz and the ET sink's / dz (3), their cotangents (4); the
# surface block: three drags (per Monin-Obukhov iteration u*, theta* and
# 1/L, the last quotient, and the resistance 1 / (C_h V)), e_air, three
# e_sat quotients, dq_s and dq_g, the vegetation's ten (LAI, Medlyn 4,
# f_temp, the respiration's three), the interception's two, the
# evapotranspiration's five, the ground resistance's two, the drainage, the
# SEB's three sensible fluxes and two skin updates, the fraction's and
# carbon rates' two and the pool's (34 beside the drags); three exps a
# vpd, the Beer's-law exp, f_temp's exp, the interception's and r_e's
# exps, the ground resistance's cos and Medlyn's two roots (10); where this
# run's data takes them (land_branches), the photosynthesis' three q10
# powf, six divisions and its root, the temperature stress' two exps and
# one division, an unstable psi's powf and two logs and atan. The surface
# block's reverse: a division for each forward division, powf, log and atan
# (the derivative's quotient), an exp's derivative its value. Each further
# Picard iteration's (u_k - u^n) / dt and -lambda / dt: 2 and 2 a level.
LAND_VJP_DIVISIONS_PER_LEVEL = {"forward": 18, "adjoint": VJP_ADJ_DIVISIONS_PER_LEVEL + 3}
LAND_SURFACE_WEIGHTED = {"division": 34, "exp": 10}
LAND_BRANCH_WEIGHTED = {"photosynthesis": {"powf": 3, "division": 6, "exp": 1},
                        "temperature stress": {"exp": 2, "division": 1},
                        "unstable psi": {"powf": 1, "exp": 3}}
LAND_WEIGHTS = {"division": FWD_WEIGHTS["division"][1], "exp": 9.6,
                "powf": FWD_WEIGHTS["powf"][1]}


def land_weighted_counts(solver, nz, branches, params):
    """``(divisions of one solve, {"division", "exp", "powf": the surface
    block's a column and iteration})`` behind land_fma_issues and
    land_vjp_fma_issues (``branches`` as land_branches' means a column and
    step, ``params`` the LandParams, whose drag knobs count the
    Monin-Obukhov iterations and whose tags the snowpack's cover
    quotient)."""
    if solver == "thomas":
        solve_div = 2 * nz
    else:
        s, solve_div = 1, nz
        while s < nz:
            solve_div += 2 * (nz - s)
            s *= 2
    v = params.values
    drag_div = 3 * ((3 * v["mo_iterations"] + 1 if v["mo_drag"] else 0) + 1)
    fwd = {"division": drag_div + LAND_SURFACE_WEIGHTED["division"]
           + ("snow" in params.tags), "exp": LAND_SURFACE_WEIGHTED["exp"], "powf": 0.0}
    for k, n in branches.items():
        for w, m in LAND_BRANCH_WEIGHTED[k].items():
            fwd[w] += m * n
    return solve_div, fwd


def land_fma_issues(solver, nz, iters, branches, params, stepper="implicit"):
    """FMA issues of one step of one column of the land ImplicitEuler
    rollout with ``iters`` Picard iterations (rows 1'f and 1'k) or of the
    land Heun rollout (``stepper`` ``"heun"``, row 1'e): row 4's weights on
    land_variant_ops, each closure's forward divisions, exps and powf
    counted as land_vjp_fma_issues counts them (per level 18, per interior
    face 8, per column the top rows' 3 and the surface block's, which every
    Picard iteration and each of Heun's two closures runs again;
    ImplicitEuler's two solves, and each further iteration's (u_k - u^n) /
    dt, 2 a level; with a snowpack, where ``params`` has one, row 1'g, its
    operations and its cover's quotient)."""
    solve_div, fwd = land_weighted_counts(solver, nz, branches, params)
    closures, solves = (2, 0) if stepper == "heun" else (iters, 2 * solve_div)
    count = {
        "division": closures * (LAND_VJP_DIVISIONS_PER_LEVEL["forward"] * nz + 8 * (nz - 1)
                                + solves + 3 + fwd["division"]) + (iters - 1) * 2 * nz,
        "exp": closures * fwd["exp"], "powf": closures * fwd["powf"]}
    ops = land_variant_ops(stepper, solver, "snow" in params.tags, nz, branches, iters)
    return ops + sum(n * (LAND_WEIGHTS[w] - 1.0) for w, n in count.items())


def land_vjp_fma_issues(solver, nz, iters, branches, params, stepper="implicit"):
    """FMA issues of one step of one column of the land ImplicitEuler
    segment VJP with ``iters`` Picard iterations, or of the land Heun
    segment VJP (``stepper`` ``"heun"``: the forward step's two closures
    and the closure's adjoint twice, no solve; row 4's weights on
    land_vjp_ops; ``branches`` and ``params`` as land_weighted_counts
    takes them; with a snowpack, where ``params`` has one, row 3'k, its
    operations and its cover's quotient forward and reversed)."""
    solve_div, fwd = land_weighted_counts(solver, nz, branches, params)
    # the surface block's reverse: a quotient for each division, powf, log
    # and atan (an unstable psi's three of its "exp" ones are two logs and
    # the atan)
    rev_div = fwd["division"] + fwd["powf"] + 3 * branches.get("unstable psi", 0.0)
    if stepper == "heun":
        count = {
            "division": 2 * (LAND_VJP_DIVISIONS_PER_LEVEL["forward"] * nz + 8 * (nz - 1) + 3
                             + fwd["division"])
            + 2 * (LAND_VJP_DIVISIONS_PER_LEVEL["adjoint"] * nz
                   + VJP_ADJ_DIVISIONS_PER_FACE * (nz - 1) + 4 + rev_div),
            "exp": 2 * fwd["exp"], "powf": 2 * fwd["powf"]}
    else:
        count = {
            "division": iters * (sum(LAND_VJP_DIVISIONS_PER_LEVEL.values()) * nz
                                 + (8 + VJP_ADJ_DIVISIONS_PER_FACE) * (nz - 1) + 4 * solve_div
                                 + 3 + 4 + fwd["division"] + rev_div) + (iters - 1) * 4 * nz,
            "exp": iters * fwd["exp"], "powf": iters * fwd["powf"]}
    ops = land_vjp_ops(stepper, solver, nz, branches, iters, "snow" in params.tags)
    return ops + sum(n * (LAND_WEIGHTS[w] - 1.0) for w, n in count.items())


def land_vjp_launcher(fs, lv, ls, fn, group, operands, dt, steps, solver, iters):
    """``(launch, scratch)``: ``launch()`` launches the land segment-VJP
    entry ``fn`` on ``operands`` (carry, static inputs, root fraction,
    coordinates, parameters, output cotangents) over ``steps`` steps and
    returns ``(gcarry0, gparams)``; its scratch buffer ([step][row][cell],
    2 Nz + 6 rows, one more with a snowpack), partials and outputs are the
    caller's, the partials laid out for the group kernel of G ``group`` or,
    ``group`` None, for one thread a column."""
    carry, inputs, root, coords, params, gout = operands
    U = carry["internal_energy"]
    nz, cells = U.shape
    blocks = -(-cells // (lv._GROUP_THREADS // group if group else lv._THREADS))
    scratch = torch.full((steps, 2 * nz + 6 + ("snow" in params.tags), cells), float("nan"),
                         dtype=U.dtype, device=U.device)
    gin = {n: torch.empty_like(carry[n]) for n in ls.carry_names(params)}
    partials = torch.empty(2, blocks, dtype=U.dtype, device=U.device)
    gparams = torch.empty(2, dtype=U.dtype, device=U.device)
    args, keep = ls.launch_args(carry, gin, inputs, root, coords, params)
    c_gout = ls._CLandCarry(**{ls._CARRY_OF[n]: t.data_ptr() for n, t in gout.items()})

    def launch():
        err = fn(args[0], ctypes.byref(c_gout), *args[1:], scratch.data_ptr(),
                 partials.data_ptr(), gparams.data_ptr(), steps, float(dt), cells,
                 fs.SOLVER_CODES.get(solver, 0), int(iters),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"land segment VJP launch failed: cudaError {err}")
        return gin, gparams

    launch.keep = (keep, c_gout)
    return launch, scratch


# the scratch rows of each field of the land carry past U and sat (the SWE
# last, under a snowpack)
LAND_SCRATCH_ROWS = ("surface_excess_water", "skin_temperature", "canopy_water",
                     "carbon_vegetation", "vegetation_area_fraction", "net_assimilation",
                     "snow_water_equivalent")


def land_thread_rollout_step(fs, ls, cuda_build, operands, dt, stepper, solver, iters):
    """``step(carry, t) -> carry``: one step of the one-thread land rollout
    (``csrc/land_column_rollout.cu``, the entry of the scheme, built on
    demand where it is not prebuilt) on ``operands``' inputs from clock time
    ``t``, launched directly: the wrappers route the group schemes to the
    group kernel."""
    carry, inputs, root, coords, params = operands[:5]
    U = carry["internal_energy"]
    tags = ((stepper,) if stepper == "heun" else () if stepper == "euler"
            else ls.implicit_tags(solver, iters)) + params.tags
    fn = cuda_build.entry(ls._NAME, U.dtype, U.shape[0], ls._argtypes(U.dtype), tags=tags)

    def step(state, t):
        out = {n: torch.empty_like(state[n]) for n in params.model.live_carry}
        args, keep = ls.launch_args(state, out, inputs, root, coords, params)
        err = fn(*args, 1, float(t), float(dt), U.shape[1], fs.SOLVER_CODES.get(solver, 0),
                 int(iters), torch.cuda.current_stream().cuda_stream)
        del keep
        if err != 0:
            raise RuntimeError(f"one-thread land rollout launch failed: cudaError {err}")
        return {**state, **out}

    return step


def land_vjp_recompute_check(fs, lv, ls, cuda_build, operands, dt, steps, solver, iters,
                             tags=None, stepper="implicit", one_thread=False):
    """The land segment VJP's forward against the land rollout: the VJP
    entry of the scheme (``stepper``, ``solver``, ``iters``; or of
    ``tags``: another G or launch bound), the group kernel's or, where
    ``one_thread``, the one-thread kernel's (``csrc/land_column_segment_vjp
    .cu``), launched on ``operands`` with a scratch buffer of the check's
    own, then each carry it stored (step s's input) against the carry that
    the scheme's land rollout reaches after s steps, one step a launch: the
    group rollout at the VJP's G (the forward segments' kernel), or the
    one-thread rollout (``csrc/land_column_rollout.cu``, the forward
    segments' build: ROADMAP C3's pair). Returns ``(steps, columns whose
    stored carry
    differs at some step, {field: largest difference over the field's
    largest magnitude})``."""
    carry, inputs, root, coords, params, _ = operands
    U = carry["internal_energy"]
    nz, cells = U.shape
    if tags is None:
        tags = lv.check_scheme(params, stepper, solver, iters) + params.tags
    source = lv._NAME if one_thread else LAND_VJP_GROUP_SOURCE
    fn = cuda_build.entry(source, U.dtype, nz, lv._argtypes(U.dtype), tags=tuple(tags))
    group = None if one_thread else lv.vjp_group(U.dtype, nz, tuple(tags), solver)[1]
    launch, scratch = land_vjp_launcher(fs, lv, ls, fn, group, operands, dt, steps, solver,
                                        iters)
    launch()
    if one_thread:
        advance = land_thread_rollout_step(fs, ls, cuda_build, operands, dt, stepper, solver,
                                           iters)
    else:
        kw = {"solver": solver, "picard_iters": iters} if stepper == "implicit" else {}

        def advance(state, t):
            return ls.ROLLOUTS[stepper](state, inputs, root, *coords, params, dt, t, 1,
                                        group=group, **kw)
    rows = LAND_SCRATCH_ROWS[:6 + ("snow" in params.tags)]
    state = carry
    parted = torch.zeros(cells, dtype=torch.bool, device=U.device)
    gap = dict.fromkeys(("internal_energy", "saturation_water_ice", *rows), 0.0)
    for i in range(steps):
        rec = scratch[i]
        stored = {"internal_energy": rec[:nz], "saturation_water_ice": rec[nz:2 * nz],
                  **{n: rec[2 * nz + j] for j, n in enumerate(rows)}}
        for n, a in stored.items():
            b = state[n]
            d = a != b
            parted |= d.any(0) if d.dim() == 2 else d
            scale = float(b.abs().max())
            if scale > 0.0:
                gap[n] = max(gap[n], float((a - b).abs().max()) / scale)
        state = advance(state, i * dt)
    return steps, int(parted.sum()), gap


def land_vjp_group_row(fs, lv, ls, cuda_build, operands, dt, steps, solver, iters, branches,
                       ptxas_all, stepper="implicit"):
    """What the kernel line reports of the land group segment VJP of
    ImplicitEuler (``solver``, ``iters`` Picard iterations) or Heun
    (``stepper`` ``"heun"``) at the shape of ``operands``: its group size G
    and levels a lane, ptxas's registers and spill stores, resident warps
    an SM, SASS instructions, the recompute check (land_vjp_recompute_check
    at float32: the columns whose stored carries part from the group
    rollout's, which must be none, and the largest gap) and the bound with
    each operation weighted by its cost (land_vjp_fma_issues)."""
    carry, _, _, _, params, _ = operands
    U = carry["internal_energy"]
    dtype, (nz, cells) = U.dtype, U.shape
    tags = lv.check_scheme(params, stepper, solver, iters) + params.tags
    entry = cuda_build._entry_name(LAND_VJP_GROUP_SOURCE, tags, dtype, nz)
    ptxas = ptxas_all[LAND_VJP_GROUP_SOURCE][entry]["vjp_" + (solver or stepper)]
    warps, group = lv.vjp_group(dtype, nz, tags, solver)
    checked, parted, gap = land_vjp_recompute_check(fs, lv, ls, cuda_build, operands, dt, steps,
                                                    solver, iters, stepper=stepper)
    if parted:
        raise AssertionError(f"land group segment VJP {stepper} {solver} x{iters}: the f32 "
                             f"stored carries of {parted} columns part from the group "
                             f"rollout's")
    fma = land_vjp_fma_issues(solver, nz, iters, branches, params, stepper)
    return {"group": group, "levels_a_lane": -(-nz // group),
            "registers": int(ptxas.split()[0]),
            "spill_stores": int(ptxas.split(",")[1].split()[0]),
            "resident_warps_per_sm": warps,
            "sass_instructions": sass_instructions(cuda_build, LAND_VJP_GROUP_SOURCE, entry,
                                                   False, solver or "pcr"),
            "recompute_steps_checked": checked, "recompute_columns_parted_f32": parted,
            "recompute_max_gap_over_magnitude_f32": gap,
            "fma_issues_per_column_step": fma,
            "bound_weighted_ms": fma * cells * steps / H100_FMA_ISSUES * 1e3}


def land_group_row(ls, cuda_build, operands, steps, solver, iters, branches, ptxas_all,
                   stepper="implicit"):
    """What the kernel line reports of the land group rollout of
    ImplicitEuler (``solver``, ``iters`` Picard iterations; rows 1'f and
    1'k) or Heun (``stepper`` ``"heun"``, row 1'e) at the shape of
    ``operands`` (carry, inputs, root fraction, coordinates, parameters)
    over ``steps`` steps: its group size G and levels a lane, ptxas's
    registers and spill stores, resident warps an SM, SASS instructions and
    the bound with each operation weighted by its cost (land_fma_issues;
    ``branches`` as land_branches' means a column and step)."""
    carry, _, _, _, params = operands
    U = carry["internal_energy"]
    dtype, (nz, cells) = U.dtype, U.shape
    tags = (ls.implicit_tags(solver, iters) if stepper == "implicit" else (stepper,)) \
        + params.tags
    entry = cuda_build._entry_name(LAND_GROUP_SOURCE, tags, dtype, nz)
    ptxas = ptxas_all[LAND_GROUP_SOURCE][entry]["land_" + (solver or stepper)]
    warps, group = ls.rollout_group(dtype, nz, tags, solver)
    fma = land_fma_issues(solver, nz, iters, branches, params, stepper)
    return {"group": group, "levels_a_lane": -(-nz // group),
            "registers": int(ptxas.split()[0]),
            "spill_stores": int(ptxas.split(",")[1].split()[0]),
            "resident_warps_per_sm": warps,
            "sass_instructions": sass_instructions(cuda_build, LAND_GROUP_SOURCE, entry, False,
                                                   solver or "pcr"),
            "fma_issues_per_column_step": fma,
            "bound_weighted_ms": fma * cells * steps / H100_FMA_ISSUES * 1e3}


def group_f64_check(tp, fs, stepper):
    """Row 1 (``"euler"``: the bench, its table) or 1'a (``"heun"``: the
    Heun + series configuration, its series) at float64 on GROUP_F64_CELLS
    columns over COMPARE_STEPS steps, against the plain version at 1e-12."""
    from terrarium_tpu_torch.timesteppers.integrator import clock_times, top_temperature_table

    if stepper == "heun":
        carry, top, coords, params = series_operands(
            fs, heun_sim(tp, GROUP_F64_CELLS, torch.float64), COMPARE_STEPS)
        wrapper = fs.soil_column_heun_rollout
    else:
        sim = bench_sim(tp, GROUP_F64_CELLS, torch.float64)
        g = sim.model.grid
        coords = tuple(getattr(g, n)[:, 0].contiguous()
                       for n in ("dz", "dz_faces", "z_centers", "z_faces"))
        carry = tuple(sim.state.prognostic[n].contiguous() for n in sim.model.live_carry)
        top = top_temperature_table(sim.bcs["temperature"]["top"].value, clock_times(
            sim.state.clock.time, BENCH_DT, COMPARE_STEPS)[:-1], g)
        params = fs.ColumnParams.of(sim.model, g.dtype)
        wrapper = fs.soil_column_rollout
    return check_f64_close(f"{stepper} f64", wrapper(*carry, top, *coords, params, BENCH_DT),
                           fs.soil_column_rollout_plain(*carry, top, *coords, params,
                                                        BENCH_DT, stepper=stepper), 1e-12)


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
    """The stepper, the kernel wrapper and the plain version of the land
    variant ``name`` (land_variant_spec), the last two as partials taking
    ``land_column_rollout``'s arguments."""
    key, solver, _, iters = land_variant_spec(name)
    kw = {"solver": solver} if solver else {}
    if iters != 1:
        kw["picard_iters"] = iters
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


def land_sim(tp, cells, dtype, composition, device="cuda", stepper=None, snow=False,
             forcing=None):
    """`bench_configs.py:228-267` on ``cells`` columns at latitudes evenly
    spaced from -60 to 80 degrees: loam, Richards flow, Nz 20, ForwardEuler at
    dt 600 s (or ``stepper``); hourly (744, cells) series of shortwave 900
    cos(lat) max(0, sin(2 pi (t/day - 0.25))) and air temperature T_mean + 6
    sin(2 pi (t/day - 0.3)), T_mean = 28 max(cos lat, 0.05) - 8, made on the
    card in float64 and rounded once; static longwave 330, rain 4e-8, wind 3;
    initial temperature T_mean, saturation 0.6, carbon 2, vegetation fraction
    0.5. ``snow``: with ``Snowpack()``, a static snowfall of 2e-8 m/s beside
    the rain and an initial SWE of 0.02 m (``land_snow_n145``). ``forcing``:
    the source of the two series instead (``land_series``' at other
    times)."""
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=LAND_NZ),
                            dtype=dtype, device=device)
    T_mean = 28.0 * land_coslat(cells) - 8.0
    if forcing is None:
        forcing = tp.TimeSeriesInputSource(times=hourly_times(), series={
            k: v.to(dtype).contiguous()
            for k, v in land_series(hourly_times(), cells, device).items()})
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


def land_coslat(cells):
    """max(cos(lat), 0.05) at latitudes evenly spaced from -60 to 80 degrees."""
    return np.maximum(np.cos(np.deg2rad(np.linspace(-60.0, 80.0, cells))), 0.05)


def land_series(times, cells, device):
    """``land_sim``'s shortwave and air temperature at ``times`` (seconds),
    ``(T, cells)`` float64 tensors on ``device``."""
    day = torch.as_tensor(times / 86400.0, device=device)[:, None]
    cos_t = torch.as_tensor(land_coslat(cells), device=device)[None, :]
    return {"surface_shortwave_down":
            900.0 * cos_t * torch.clamp(torch.sin(2 * np.pi * (day - 0.25)), min=0.0),
            "air_temperature": (28.0 * cos_t - 8.0) + 6.0 * torch.sin(2 * np.pi * (day - 0.3))}


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


def land_variant_compare(tp, ls, fs, cuda_build, land_inputs, vname, ptxas_all, card,
                         name=None):
    """The land variant ``vname``'s kernel (land_variant_spec) against its
    plain version one step at a time along the plain trajectory (float64 on
    LAND_F64_CELLS columns at 1e-12 and float32 at full width by
    land_f32_tolerance, Heun's at LAND_HEUN_F32_DT), one launch against the
    chain of one-step launches, and timed; prints the phase (``name``, by
    default ``<vname>_compare``) and returns what the kernel report reads."""
    vkey, vsolver, vsnow, viters = land_variant_spec(vname)
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
    v_ops = land_variant_ops(vkey, vsolver, vsnow, LAND_NZ, v_runs, viters)
    v_b = bound_ms(v_ops * LAND_CELLS * LAND_VARIANT_STEPS,
                   2 * sum(t.numel() for t in carry.values()) * 4 + 2 * v_rows * LAND_CELLS * 4)
    stepper_tags = ((vkey, "picard") if viters != 1
                    else (vkey, vsolver) if vsolver else (vkey,))
    source = ls.rollout_source(params, vkey)
    entry = "_".join((source, *stepper_tags, *params.tags, "f32", f"nz{LAND_NZ}"))
    ptxas = ptxas_all[source].get(entry, {}).get(
        "land" if source == "land_column_rollout" else f"land_{vsolver or vkey}")
    phase(name or f"{vname}_compare", solver=vsolver, picard_iters=viters, cells=LAND_CELLS,
          nz=LAND_NZ, dt=LAND_DT, f32_check_dt=dt,
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
    group = None
    if source == LAND_GROUP_SOURCE:
        # rows 1'e, 1'f and 1'k on the group kernel: its layout and
        # resources and the weighted bound
        group = land_group_row(ls, cuda_build, (carry, linputs, root, coords, params),
                               LAND_VARIANT_STEPS, vsolver, viters, v_runs, ptxas_all, vkey)
        phase("group_check", row="1'e" if vkey == "heun" else "1'g" if vsnow
              else "1'k" if viters > 1 else "1'f",
              stepper=vkey, solver=vsolver,
              picard_iters=viters, cells=LAND_CELLS, nz=LAND_NZ, steps=LAND_VARIANT_STEPS,
              **group, kernel_ms=v_ms, card=card)
    return dict(key=vkey, solver=vsolver, snow=vsnow, iters=viters, max_abs_err=v_abs, ms=v_ms,
                ms_144=v_ms_144, plain_ms=v_plain_ms, bound_ms=v_b[0], bound_by=v_b[1],
                ops=v_ops, ptxas=ptxas, source=source, group=group)


def land_stepper_main_path(tp, ls, land_inputs, mname, vname, var, reset_counts, launched,
                           card):
    """The land variant ``vname`` on land_consistent's composition and forcing
    through ``Simulation.run``: one timed 1,440-step block from the initial
    state after a 3-step launch from the same state (the warm-up), whose
    carry gives the share of columns with a saturation layer outside [0, 1]
    at step 3; the block's own carry, launched again after the counts were
    read, gives it at step 1,440. Prints the phase ``mname`` and returns
    the block's launches of the stepper's kernel."""
    vkey, vsolver, vsnow, viters = land_variant_spec(vname)
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
          solver=vsolver, picard_iters=viters, snow=vsnow, cells=LAND_CELLS, nz=LAND_NZ,
          dt=LAND_DT, steps=LAND_BLOCK_STEPS, seconds=m_s, launches=m_launches,
          cells_steps_per_s=LAND_CELLS * LAND_BLOCK_STEPS / m_s,
          kernel_ms_48_steps=var["ms"], bound_ms_48_steps=var["bound_ms"],
          bound_by=var["bound_by"], ops_per_column_step=var["ops"],
          kernel_ms_144_steps=var["ms_144"], ptxas=var["ptxas"],
          outside_unit_share_at_step={3: share_3,
                                      LAND_BLOCK_STEPS: float(outside_unit(end).float().mean())},
          land_consistent_outside_unit_share={3: 0.9528, "after its block": 0.9189},
          saturation_range_at_end=[float(end["saturation_water_ice"].min()),
                                   float(end["saturation_water_ice"].max())],
          skin_range=[float(st.skin_temperature.min()), float(st.skin_temperature.max())],
          **snow_fields, kernel_source=var["source"], group_check=var["group"], card=card)
    return m_launches


def on_demand_sim(tp, case):
    """C1's composition ``case`` (ON_DEMAND_STEPS) on the card."""
    if case == "soil_heat_column":  # examples/soil_heat_column.py
        grid = tp.ColumnGrid.of(cells=1, spacing=tp.ExponentialSpacing(N=10),
                                dtype=torch.float32, device="cuda")
        model = tp.SoilModel(grid=grid, initializer=tp.SoilInitializer(
            energy=tp.QuasiThermalSteadyState(T0=-1.0), hydrology=tp.ConstantSaturation(sat=1.0)))
        return tp.initialize(model, tp.ForwardEuler(),
                             boundary_conditions=tp.PrescribedSurfaceTemperature(1.0))
    grid = tp.ColumnGrid.of(cells=LAND_F64_CELLS, spacing=tp.ExponentialSpacing(N=LAND_NZ),
                            dtype=torch.float32, device="cuda")
    props = tp.ConstantSoilHydraulics(swrc=tp.VanGenuchten(alpha=2.0, n=2.0),
                                      unsat_hydraulic_cond=tp.UnsatKVanGenuchten(),
                                      sat_hydraulic_cond=1e-6)
    soil_ = tp.SoilEnergyWaterCarbon(
        strat=tp.HomogeneousStratigraphy(texture=tp.SoilTexture.preset("loam")),
        hydrology=tp.SoilHydrology(vertical_flow=tp.RichardsEq(), hydraulic_properties=props))
    model = tp.LandModel(grid=grid, soil=soil_,
                         surface_energy_balance=tp.SurfaceEnergyBalance.consistent(),
                         surface_hydrology=tp.SurfaceHydrology(
                             canopy_interception=tp.NoCanopyInterception(),
                             evapotranspiration=tp.BareGroundEvaporation.consistent_units()))
    return tp.initialize(model, tp.ImplicitEuler(dt=LAND_DT),
                         initializers={"temperature": 8.0, "saturation_water_ice": 0.7},
                         input_sources=(tp.FieldInputSource(fields={
                             "surface_shortwave_down": 400.0, "air_temperature": 12.0,
                             "rainfall": 5.0e-8, "windspeed": 1.0}),))


def on_demand_kernel(fs, ls, case, sim):
    """``(source, dtype, Nz, argtypes, tags, wrapper)`` of the kernel that
    ``Simulation.run`` launches for C1's composition ``case``."""
    grid = sim.model.grid
    if case == "soil_heat_column":
        return ("soil_column_rollout", grid.dtype, grid.nz, fs._ARGTYPES,
                fs.kernel_tags("euler", "heat", 1, plain_euler=()), fs.soil_column_heat_rollout)
    params = ls.LandParams.of(sim.model, grid.dtype)
    return (ls.rollout_source(params, "implicit"), grid.dtype, grid.nz,
            ls._argtypes(grid.dtype), ls.implicit_tags("pcr", 1) + params.tags,
            ls.land_column_implicit_rollout)


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
          "implicit": tp.ImplicitEuler(dt=cfg["dt"], solver=cfg["solver"],
                                       picard_iters=cfg.get("picard", 1))}[cfg["stepper"]]
    return tp.initialize(
        scheme_model_fn(tp, name, grid)(K_MINERAL if heat else LOG_KSAT), ts,
        initializers={"temperature": -1.0, "saturation_water_ice": 0.8 if heat else (
            lambda x, z: np.minimum(1.0, 0.6 - 0.04 * z))},
        boundary_conditions=tp.PrescribedSurfaceTemperature(4.0))


def scheme_value(tp, name, sim, fused=True, remat_fn=False, shift=0.0, grad=True):
    """The loss after GRAD_STEPS steps and its gradient in the parameter
    (``shift`` added to it): through make_fused_grad_rollout (kernels), or,
    ``remat_fn``, the port's make_rollout_fn(remat=True) (torch autograd
    through the modules); the loss alone without ``grad``."""
    from terrarium_tpu_torch.timesteppers.autodiff import make_rollout_fn
    from terrarium_tpu_torch.timesteppers.fused_grad import make_fused_grad_rollout

    cfg = GRAD_SCHEMES[name]
    heat = cfg["physics"] == "heat"
    grid = sim.model.grid
    p = torch.tensor((K_MINERAL if heat else LOG_KSAT) + shift, dtype=torch.float64,
                     device="cuda", requires_grad=grad)
    model_fn = scheme_model_fn(tp, name, grid)
    with torch.set_grad_enabled(grad):
        if remat_fn:
            out = make_rollout_fn(model_fn(p), sim.timestepper, sim.ctx, steps=GRAD_STEPS,
                                  remat=True)(sim.state, cfg["dt"])
        else:
            out = make_fused_grad_rollout(model_fn, sim.timestepper, sim.ctx, steps=GRAD_STEPS,
                                          dt=cfg["dt"], inner_steps=GRAD_INNER)(sim.state, p)
        loss = out.temperature.mean()
        if not heat:
            loss = loss + out.saturation_water_ice.mean()
    if not grad:
        return float(loss)
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
    if cfg.get("picard", 1) != 1:
        kw["picard_iters"] = cfg["picard"]
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


def full_step_structure(name, k_state, p_state):
    """The kernel's step against the plain version's in all but the values:
    the same prognostic, tendency and auxiliary leaves, each of the same
    shape and finite on both sides, and the same clock. Raises on any
    difference."""
    for g in ("prognostic", "tendencies", "auxiliary"):
        if sorted(getattr(k_state, g)) != sorted(getattr(p_state, g)):
            raise AssertionError(f"{name}: {g} leaves {sorted(getattr(k_state, g))}")
        for key, b in getattr(p_state, g).items():
            a = getattr(k_state, g)[key]
            if (tuple(a.shape) != tuple(b.shape) or not bool(torch.isfinite(a).all())
                    or not bool(torch.isfinite(b).all())):
                raise AssertionError(f"{name}: {g}/{key} of shape {tuple(a.shape)} or "
                                     f"non-finite")
    if (float(k_state.clock.time) != float(p_state.clock.time)
            or int(k_state.clock.iteration) != int(p_state.clock.iteration)):
        raise AssertionError(f"{name}: clock {k_state.clock.time} vs {p_state.clock.time}")


def full_step_leaves(k_state, p_state, dt):
    """(group/name, plain leaf, absolute difference, scale) of every leaf:
    the scale is the leaf's largest magnitude; a tendency's is at least its
    prognostic's over dt, the precision the step gives the prognostic (a
    tendency is a difference of nearly equal fluxes, whose rounding is that
    of the fluxes)."""
    for g in ("prognostic", "tendencies", "auxiliary"):
        for key, b in getattr(p_state, g).items():
            scale = float(b.abs().max())
            if g == "tendencies":
                scale = max(scale, float(p_state.prognostic[key].abs().max()) / dt)
            yield f"{g}/{key}", b, (getattr(k_state, g)[key] - b).abs(), scale


def check_full_step(name, k_state, p_state, rtol, dt):
    """Every prognostic, tendency and auxiliary of the kernel's step against
    the plain version's, and the clock (full_step_structure). float64
    (``rtol`` <= 1e-9): each element within ``rtol`` of it with a floor of
    ``rtol`` times the leaf's scale; float32: the largest error within
    ``rtol`` of the scale (full_step_leaves)."""
    full_step_structure(name, k_state, p_state)
    errs = {}
    for leaf, b, d, scale in full_step_leaves(k_state, p_state, dt):
        errs[leaf] = float(d.max())
        bad = (bool((d > rtol * b.abs() + rtol * scale).any()) if rtol <= 1e-9
               else float(d.max()) > rtol * scale)
        if bad:
            raise AssertionError(f"{name} kernel vs plain {leaf}: max abs err "
                                 f"{float(d.max())}, scale {scale}")
    return errs


def flip_columns(k_state, p_state, start):
    """The columns in which the kernel's and the plain version's steps may
    part beyond rounding (ROADMAP Queue C): a level whose saturation, at the
    start or after either step, is within 1e-9 of 1 or above it (the
    implicit Richards rows' d(Psi)/d(sat) jumps to 0 at saturation), or
    whose liquid fraction one step leaves on the freeze plateau (0 < liq <
    1) and the other off it (the heat rows' dT/dU jumps to 0 there)."""
    near = torch.zeros(start.internal_energy.shape[1], dtype=torch.bool,
                       device=start.internal_energy.device)
    for st in (start, k_state, p_state):
        near |= (st.saturation_water_ice >= 1.0 - 1e-9).any(0)
    on_k = (k_state.liquid_water_fraction > 0.0) & (k_state.liquid_water_fraction < 1.0)
    on_p = (p_state.liquid_water_fraction > 0.0) & (p_state.liquid_water_fraction < 1.0)
    return near | (on_k != on_p).any(0)


def check_full_step_f64(name, k_state, p_state, start, dt):
    """check_full_step at float64, 1e-12, with the flip rule: the leaves,
    shapes, finiteness and clock must agree (full_step_structure, which
    raises), and a column in which an element parts beyond 1e-12 must be a
    flip column (flip_columns). Returns the largest errors and the number
    of flip columns that parted."""
    full_step_structure(name, k_state, p_state)
    flips, parted, errs = None, None, {}
    for leaf, b, d, scale in full_step_leaves(k_state, p_state, dt):
        errs[leaf] = float(d.max())
        bad = ~(d <= 1e-12 * b.abs() + 1e-12 * scale)
        if not bool(bad.any()):
            continue
        if flips is None:
            flips = flip_columns(k_state, p_state, start)
            parted = torch.zeros_like(flips)
        bad_cols = bad.any(0) if bad.dim() == 2 else bad
        if bool((bad_cols & ~flips).any()):
            raise AssertionError(f"{name} kernel vs plain {leaf} (f64): max abs err "
                                 f"{float(d.max())}, scale {scale}, outside the flip columns")
        parted |= bad_cols
    return errs, 0 if parted is None else int(parted.sum())


def scrambled_stored(state, seed):
    """A copy of ``state`` whose stored temperature, liquid fraction and,
    where the state holds them, pressure head, ground temperature and net
    assimilation are drawn apart from its prognostics (as the host builds'
    random full states are): a full step reads them as stored, so a kernel
    that closed its start instead parts from the plain version here."""
    rng = np.random.default_rng(seed)
    st = state.copy()
    nz, cells = st.internal_energy.shape
    like = st.internal_energy

    def put(name, arr):
        st.set(**{name: torch.as_tensor(arr, dtype=like.dtype, device=like.device)})

    put("temperature", rng.uniform(-12.0, 9.0, (nz, cells)))
    put("liquid_water_fraction",
        rng.choice([0.0, 1.0], (nz, cells)) * rng.uniform(0.2, 1.0, (nz, cells)))
    if "pressure_head" in st.auxiliary:
        put("pressure_head", rng.uniform(-6.0, 1.0, (nz, cells)))
    if "ground_temperature" in st.auxiliary:
        put("ground_temperature", rng.uniform(-15.0, 25.0, cells))
    if "net_assimilation" in st.auxiliary:
        put("net_assimilation", rng.uniform(-1e-3, 5e-3, cells))
    return st


def state_f64(tp, state):
    """A float64 copy of ``state`` (every leaf, the clock)."""
    from terrarium_tpu_torch.state import Clock, State

    groups = [{k: v.double() for k, v in getattr(state, g).items()}
              for g in ("prognostic", "tendencies", "auxiliary", "inputs")]
    return State(*groups, Clock(state.clock.time.double(), state.clock.iteration.long()))


def model_f64(model):
    """``model`` on its grid at float64."""
    from terrarium_tpu_torch.grids.column import ColumnGrid

    g = model.grid
    return dataclasses.replace(model, grid=ColumnGrid(g.cells, g.vertical, torch.float64,
                                                      g.device))


def check_full_step_f32(name, k_state, p_state, start, dt, referee, land=False):
    """check_full_step at float32 (each leaf's largest error within
    F32_REL_TOL of its scale) and, ``land``, each live carry leaf per cell
    by land_f32_tolerance on its change from ``start``. An element beyond
    either (a layer that crosses the freeze plateau's edge or saturation on
    one side of an ulp only) is held to ``referee()``, the plain step at
    float64 from the same float32 start: the kernel within twice the plain
    version's own float32 error plus the tolerance. Returns the largest
    errors and the number of such flip elements."""
    errs, flips, truth = {}, 0, None
    if sorted(k_state.tendencies) != sorted(p_state.tendencies):
        raise AssertionError(f"{name}: tendencies {sorted(k_state.tendencies)}")
    outside = None
    if land and "saturation_water_ice" in start.prognostic:
        s0 = start.saturation_water_ice
        outside = ((s0 > 1.0) | (s0 < 0.0)).any(0)
    for g in ("prognostic", "tendencies", "auxiliary"):
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
            a, b = a.double(), b.double()
            d = (a - b).abs()
            errs[f"{g}/{key}"] = float(d.max())
            tol = torch.full_like(b, F32_REL_TOL * scale)
            if land and (g == "prognostic" or key == "net_assimilation"):
                lt = land_f32_tolerance(key, b, start[key].double(),
                                        outside if outside is not None else
                                        torch.zeros(b.shape[-1], dtype=torch.bool,
                                                    device=b.device))
                tol = torch.minimum(tol, lt)
            bad = d > tol
            if not bool(bad.any()):
                continue
            if truth is None:
                truth = referee()
            t = getattr(truth, g)[key]
            k_err, p_err = (a - t).abs(), (b - t).abs()
            if bool((bad & (k_err > 2.0 * p_err + tol)).any()):
                raise AssertionError(f"{name} kernel vs the float64 referee {g}/{key}: "
                                     f"{float(k_err.max())} against the plain version's "
                                     f"{float(p_err.max())}")
            flips += int(bad.sum())
    if (float(k_state.clock.time) != float(p_state.clock.time)
            or int(k_state.clock.iteration) != int(p_state.clock.iteration)):
        raise AssertionError(f"{name}: clock {k_state.clock.time} vs {p_state.clock.time}")
    return errs, flips


def land_full_sim(tp, cells, dtype, variant):
    """LAND_FULL_VARIANTS[variant] over land_consistent's composition (with
    land_snow_n145's snowpack where the variant has one) on ``cells``
    columns, Nz 20, with land_grad_sim's static inputs and initial state."""
    key, solver, iters, dt, snow = LAND_FULL_VARIANTS[variant]
    grid = tp.ColumnGrid.of(cells=cells, spacing=tp.ExponentialSpacing(N=LAND_NZ),
                            dtype=dtype, device="cuda")
    lat = np.linspace(-60.0, 80.0, cells)
    coslat = np.maximum(np.cos(np.deg2rad(lat)), 0.05)
    T_mean = 28.0 * coslat - 8.0
    fields = {"surface_longwave_down": 330.0, "rainfall": 4.0e-8, "windspeed": 3.0,
              "surface_shortwave_down": 900.0 * coslat / np.pi, "air_temperature": T_mean}
    inits = {"temperature": lambda x, z: T_mean[None, :] + 0.0 * z,
             "saturation_water_ice": 0.6, "carbon_vegetation": 2.0,
             "vegetation_area_fraction": 0.5}
    model = land_model(tp, grid, "consistent")
    if snow:
        model = dataclasses.replace(model, snow=tp.Snowpack())
        fields["snowfall"] = SNOWFALL
        inits["snow_water_equivalent"] = SWE0
    stepper = (tp.ImplicitEuler(dt=dt, solver=solver, picard_iters=iters) if key == "implicit"
               else tp.Heun(dt=dt) if key == "heun" else tp.ForwardEuler(dt=dt))
    return tp.initialize(model, stepper, (tp.FieldInputSource(fields=fields),),
                         initializers=inits)


def full_step_timings(fused, launch, plain, reps=FULL_NEW_TIMED):
    """CUDA-event ms of each of ``reps`` ``fused`` calls and ``launch``es
    (their medians), and the plain version's mean over 3 after a warm-up."""
    call_ms = cuda_ms_each(fused, reps)
    kernel_ms = cuda_ms_each(launch, reps)
    return (float(np.median(call_ms)), float(np.median(kernel_ms)),
            cuda_ms(plain, reps=3, warmup=True), call_ms, kernel_ms)


def full_step_implicit_phase(tp, fs, cuda_build, reset_counts, launched, ptxas_all, card):
    """The full_step_implicit phases; returns each variant's kernel report."""
    # ---- ImplicitEuler's full step (full_step_implicit): the kernel against
    # its plain version on every leaf, float64 along the plain trajectory
    # (1e-12, the flip rule) and float32 at full width (with the float64
    # referee), each solver with one and two Picard iterations; timings and
    # a FULL_STEPS-call loop of each at full width; the heat-only model
    # checked at full width
    imp_full = {}
    for solver, iters in FULL_IMPLICIT_VARIANTS:
        vname = f"{solver}_picard{iters}"
        ts = tp.ImplicitEuler(dt=IMPLICIT_DT, solver=solver, picard_iters=iters)
        sim = full_sim(tp, FULL_IMPLICIT_F64_CELLS, FULL_IMPLICIT_F64_NZ, torch.float64,
                       "euler", "richards")
        fused = fs.make_fused_step(sim.model, ts, sim.ctx, sim.input_sources, dt=IMPLICIT_DT)
        state, f64_err, f64_flips = sim.state, {}, 0
        for i in range(FULL_F64_STEPS):
            plain = fs.soil_column_full_step_plain(sim.model, ts, sim.ctx, (), state,
                                                   IMPLICIT_DT)
            errs, fl = check_full_step_f64(f"full step implicit {vname} f64", fused(state),
                                           plain, state, IMPLICIT_DT)
            f64_err[str(i)], f64_flips = max(errs.values()), f64_flips + fl
            state = plain
        st_s = scrambled_stored(state, seed=31)
        errs, st_flips = check_full_step_f64(
            f"full step implicit {vname} f64, stored start", fused(st_s),
            fs.soil_column_full_step_plain(sim.model, ts, sim.ctx, (), st_s, IMPLICIT_DT), st_s,
            IMPLICIT_DT)
        f64_err["stored_start"] = max(errs.values())
        del st_s
        sim = full_sim(tp, BENCH_CELLS, BENCH_NZ, torch.float32, "euler", "richards")
        fused = fs.make_fused_step(sim.model, ts, sim.ctx, sim.input_sources, dt=IMPLICIT_DT)
        st = sim.state
        plain = fs.soil_column_full_step_plain(sim.model, ts, sim.ctx, (), st, IMPLICIT_DT)
        model64 = model_f64(sim.model)
        f32_err, f32_flips = check_full_step_f32(
            f"full step implicit {vname} f32", fused(st), plain, st, IMPLICIT_DT,
            lambda: fs.soil_column_full_step_plain(model64, ts, sim.ctx, (), state_f64(tp, st),
                                                   IMPLICIT_DT))
        del plain
        fn, (fargs, keep), _ = fs.full_step_operands(sim.model, "implicit", "richards",
                                                     sim.ctx, st, IMPLICIT_DT, solver, iters)
        call_med, k_med, p_ms, call_ms, k_ms = full_step_timings(
            lambda: fused(st), lambda: fn(*fargs),
            lambda: fs.soil_column_full_step_plain(sim.model, ts, sim.ctx, (), st,
                                                   IMPLICIT_DT))
        b = bound_ms(full_step_implicit_ops(solver, "richards", BENCH_NZ, iters) * BENCH_CELLS,
                     full_step_bytes("richards", BENCH_NZ, BENCH_CELLS, 4, keep[1].numel()))
        del keep
        reset_counts()
        state = st
        for _ in range(FULL_STEPS):
            state = fused(state)
        torch.cuda.synchronize()
        launches = launched()
        if launches != {"soil_column_full_step": FULL_STEPS}:
            raise AssertionError(f"{FULL_STEPS} implicit full steps launched {launches}")
        if int(state.clock.iteration) != FULL_STEPS or not bool(
                torch.isfinite(state.internal_energy).all()):
            raise AssertionError(f"implicit full-step loop {vname}: iteration "
                                 f"{int(state.clock.iteration)} or non-finite energy")
        entry = cuda_build._entry_name("soil_column_full_step", ("implicit", "richards"),
                                       torch.float32, BENCH_NZ)
        imp_full[vname] = dict(solver=solver, iters=iters, launches=launches[
            "soil_column_full_step"], max_abs_err=max(f32_err.values()), ms=k_med,
            plain_ms=p_ms, bound_ms=b[0], bound_by=b[1], call_ms=call_med, entry=entry)
        phase(f"full_step_implicit_{vname}", cells=BENCH_CELLS, nz=BENCH_NZ, dt=IMPLICIT_DT,
              solver=solver, picard_iters=iters, f64_cells=FULL_IMPLICIT_F64_CELLS,
              f64_nz=FULL_IMPLICIT_F64_NZ, f64_steps=FULL_F64_STEPS, f64_rtol=1e-12,
              f64_max_abs_err=f64_err, f64_flip_columns=f64_flips,
              f64_stored_start_flip_columns=st_flips, rel_tol=F32_REL_TOL,
              f32_max_abs_err=f32_err, f32_flip_elements=f32_flips, loop_steps=FULL_STEPS,
              loop_launches=launches, fused_call_ms_median=call_med, fused_call_ms=call_ms,
              kernel_ms_median=k_med, kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b[0],
              bound_by=b[1], ops_per_column=full_step_implicit_ops(solver, "richards", BENCH_NZ, iters),
              ptxas=ptxas_all["soil_column_full_step"].get(entry), card=card)
        del sim, st, state, fused, model64
    heat_imp = {}
    for solver, iters in (("pcr", 1), ("thomas", 2)):
        ts = tp.ImplicitEuler(dt=IMPLICIT_DT, solver=solver, picard_iters=iters)
        # float64 along the plain trajectory and from a stored start drawn
        # apart from the prognostics, at 1e-12 with the flip rule
        sim = full_sim(tp, FULL_IMPLICIT_F64_CELLS, FULL_IMPLICIT_F64_NZ, torch.float64,
                       "euler", "heat")
        fused = fs.make_fused_step(sim.model, ts, sim.ctx, (), dt=IMPLICIT_DT)
        state, f64_err, f64_flips = sim.state, {}, 0
        for i in range(FULL_F64_STEPS):
            plain = fs.soil_column_full_step_plain(sim.model, ts, sim.ctx, (), state,
                                                   IMPLICIT_DT)
            errs, fl = check_full_step_f64(f"full step implicit heat {solver} {iters} f64",
                                           fused(state), plain, state, IMPLICIT_DT)
            f64_err[str(i)], f64_flips = max(errs.values()), f64_flips + fl
            state = plain
        st_s = scrambled_stored(state, seed=32)
        errs, fl = check_full_step_f64(
            f"full step implicit heat {solver} {iters} f64, stored start", fused(st_s),
            fs.soil_column_full_step_plain(sim.model, ts, sim.ctx, (), st_s, IMPLICIT_DT), st_s,
            IMPLICIT_DT)
        f64_err["stored_start"], f64_flips = max(errs.values()), f64_flips + fl
        del sim, state, st_s, fused
        sim = full_sim(tp, BENCH_CELLS, BENCH_NZ, torch.float32, "euler", "heat")
        st = sim.state
        reset_counts()
        out = fs.make_fused_step(sim.model, ts, sim.ctx, (), dt=IMPLICIT_DT)(st)
        torch.cuda.synchronize()
        if launched() != {"soil_column_full_step": 1}:
            raise AssertionError(f"a heat-only implicit full step launched {launched()}")
        plain = fs.soil_column_full_step_plain(sim.model, ts, sim.ctx, (), st, IMPLICIT_DT)
        model64 = model_f64(sim.model)
        errs, flips = check_full_step_f32(
            f"full step implicit heat {solver} {iters} f32", out, plain, st, IMPLICIT_DT,
            lambda: fs.soil_column_full_step_plain(model64, ts, sim.ctx, (), state_f64(tp, st),
                                                   IMPLICIT_DT))
        heat_imp[f"{solver}_picard{iters}"] = dict(
            max_abs_err=errs, flip_elements=flips, f64_max_abs_err=f64_err,
            f64_flip_columns=f64_flips)
        del sim, st, out, plain, model64
    phase("full_step_implicit_heat", cells=BENCH_CELLS, nz=BENCH_NZ, dt=IMPLICIT_DT,
          f64_cells=FULL_IMPLICIT_F64_CELLS, f64_nz=FULL_IMPLICIT_F64_NZ,
          f64_steps=FULL_F64_STEPS, f64_rtol=1e-12, rel_tol=F32_REL_TOL, f32=heat_imp,
          card=card)
    return imp_full


def land_full_step_phase(tp, fs, ls, cuda_build, land_inputs, reset_counts, launched, ptxas_all,
                         card):
    """The land_full_step phases; returns each variant's kernel report."""
    # ---- the LandModel's full step (land_full_step): each variant's kernel
    # against its plain version on every leaf, float64 on LAND_F64_CELLS
    # columns along the plain trajectory (1e-12, the flip rule) and float32
    # at full width (check_full_step_f32 with land_f32_tolerance and the
    # float64 referee), then its timings and a FULL_STEPS-call loop
    land_full = {}
    for vname, (key, solver, iters, dt, snow) in LAND_FULL_VARIANTS.items():
        sim = land_full_sim(tp, LAND_F64_CELLS, torch.float64, vname)
        fused = fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources,
                                   dt=dt)
        state, f64_err, f64_flips = sim.state, {}, 0
        for i in range(FULL_F64_STEPS):
            plain = ls.land_column_full_step_plain(sim.model, sim.timestepper, sim.ctx,
                                                   sim.input_sources, state, dt)
            errs, fl = check_full_step_f64(f"land full step {vname} f64", fused(state), plain,
                                           state, dt)
            f64_err[str(i)], f64_flips = max(errs.values()), f64_flips + fl
            state = plain
        st_s = scrambled_stored(state, seed=33)
        errs, st_flips = check_full_step_f64(
            f"land full step {vname} f64, stored start", fused(st_s),
            ls.land_column_full_step_plain(sim.model, sim.timestepper, sim.ctx,
                                           sim.input_sources, st_s, dt), st_s, dt)
        f64_err["stored_start"] = max(errs.values())
        del sim, state, fused, st_s
        sim = land_full_sim(tp, LAND_CELLS, torch.float32, vname)
        fused = fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources,
                                   dt=dt)
        st = sim.state
        out = fused(st)
        plain = ls.land_column_full_step_plain(sim.model, sim.timestepper, sim.ctx,
                                               sim.input_sources, st, dt)
        model64 = model_f64(sim.model)
        f32_err, f32_flips = check_full_step_f32(
            f"land full step {vname} f32", out, plain, st, dt,
            lambda: ls.land_column_full_step_plain(model64, sim.timestepper, sim.ctx,
                                                   sim.input_sources, state_f64(tp, st), dt),
            land=True)
        params = ls.LandParams.of(sim.model, torch.float32)
        inputs = land_inputs(sim.model, st, sim.input_sources)
        br = land_branches(fs, params, inputs, {n: st[n] for n in sim.model.live_carry},
                           {n: out[n] for n in sim.model.live_carry}, float(st.clock.time))
        branches = {k: v / LAND_CELLS for k, v in br.items()}
        del plain, out
        fn, (fargs, keep), outs = ls.land_full_step_operands(sim.model, key, st, dt, solver,
                                                             iters)
        nbytes = distinct_bytes([*keep[0].values(), *keep[1].values(),
                                 *(i.values for i in keep[2].values()), keep[4]]
                                + [t for grp in outs.values() for t in grp.values()])
        call_med, k_med, p_ms, call_ms, k_ms = full_step_timings(
            lambda: fused(st), lambda: fn(*fargs),
            lambda: ls.land_column_full_step_plain(sim.model, sim.timestepper, sim.ctx,
                                                   sim.input_sources, st, dt))
        ops = land_variant_ops(key, solver, snow, LAND_NZ, branches, iters)
        b = bound_ms(ops * LAND_CELLS, nbytes)
        del keep, outs
        reset_counts()
        state = st
        for _ in range(FULL_STEPS):
            state = fused(state)
        torch.cuda.synchronize()
        launches = launched()
        if launches != {"land_column_full_step": FULL_STEPS}:
            raise AssertionError(f"{FULL_STEPS} land full steps launched {launches}")
        if int(state.clock.iteration) != FULL_STEPS or not bool(
                torch.isfinite(state.internal_energy).all()):
            raise AssertionError(f"land full-step loop {vname}: iteration "
                                 f"{int(state.clock.iteration)} or non-finite energy")
        tags = ({"euler": (), "heun": ("heun",), "implicit": ("implicit",)}[key]
                + ls.land_full_composition(sim.model))
        entry = cuda_build._entry_name("land_column_full_step", tags, torch.float32, LAND_NZ)
        land_full[vname] = dict(key=key, solver=solver, iters=iters, snow=snow, dt=dt,
                                launches=launches["land_column_full_step"],
                                max_abs_err=max(f32_err.values()), ms=k_med, plain_ms=p_ms,
                                bound_ms=b[0], bound_by=b[1], call_ms=call_med, entry=entry)
        phase(f"land_full_step_{vname}", cells=LAND_CELLS, nz=LAND_NZ, dt=dt, stepper=key,
              solver=solver, picard_iters=iters, snow=snow, f64_cells=LAND_F64_CELLS,
              f64_steps=FULL_F64_STEPS, f64_rtol=1e-12, f64_max_abs_err=f64_err,
              f64_flip_columns=f64_flips, f64_stored_start_flip_columns=st_flips,
              rel_tol=F32_REL_TOL, f32_max_abs_err=f32_err,
              f32_flip_elements=f32_flips, loop_steps=FULL_STEPS, loop_launches=launches,
              fused_call_ms_median=call_med, fused_call_ms=call_ms, kernel_ms_median=k_med,
              kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b[0], bound_by=b[1], bytes=nbytes,
              ops_per_column=ops, branches_per_column=branches,
              ptxas=ptxas_all["land_column_full_step"].get(entry), card=card)
        del sim, st, state, fused, model64
    return land_full


def stream_times(kind, steps):
    """The hourly times of a stream phase's series for a run of ``steps``
    steps: from a day before STREAM_DAY0 to a window past the run's end, so
    that no window of ``run`` is padded (the padded tail is held to JAX on
    the CPU, `tests/test_torch_forcing_pipeline.py`)."""
    cfg = STREAM[kind]
    hours = 24 + int(np.ceil(steps * cfg["dt"] / 3600.0)) + cfg["window"] + 1
    return STREAM_DAY0 - 86400.0 + np.arange(hours, dtype=np.float64) * 3600.0


def stream_sim(tp, kind, dtype, source):
    """The stream phase's simulation, its forcing from ``source``, the clock
    at STREAM_DAY0: ``"soil"`` the bench soil (bench_sim's model and initial
    state) with its top temperature from the series ``surface_temperature``;
    ``"land"`` land_implicit_pcr (land_sim's ``"consistent"`` composition by
    ImplicitEuler PCR at dt 600 s) with its shortwave and air temperature
    from ``source``."""
    if kind == "soil":
        grid = tp.ColumnGrid.of(cells=BENCH_CELLS, spacing=tp.ExponentialSpacing(N=BENCH_NZ),
                                dtype=dtype, device="cuda")
        sim = tp.initialize(
            tp.SoilModel(grid=grid, soil=soil(tp)), tp.ForwardEuler(dt=BENCH_DT), (source,),
            initializers={
                "temperature": lambda x, z: 1.0 + 0.0 * z,
                "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.5 - 0.05 * z)},
            boundary_conditions=tp.PrescribedSurfaceTemperature("surface_temperature"))
    else:
        sim = land_sim(tp, LAND_CELLS, dtype, "consistent", forcing=source,
                       stepper=tp.ImplicitEuler(dt=LAND_DT, solver="pcr"))
    sim.state.clock = tp.Clock(torch.tensor(STREAM_DAY0, dtype=dtype, device="cuda"),
                               sim.state.clock.iteration)
    sim.fused_inner_steps = STREAM[kind]["inner"]
    return sim


def stream_series(kind, steps):
    """The stream phase's series on the host for a run of ``steps`` steps,
    float64 ``(T, cells)``: the soil's top temperature 5 sin(2 pi t / 86400)
    + 3 cos(lat) - 1 (the bench top temperature, varied by latitude), the
    land's land_sim series."""
    times = stream_times(kind, steps)
    if kind == "soil":
        lat = np.deg2rad(np.linspace(-60.0, 80.0, BENCH_CELLS))
        return times, {"surface_temperature": 5.0 * np.sin(2 * np.pi * times / 86400.0)[:, None]
                       + (3.0 * np.cos(lat) - 1.0)[None, :]}
    return times, {k: v.cpu().numpy() for k, v in land_series(times, LAND_CELLS, "cpu").items()}


def check_fields(name, got, want, names, f64):
    """Each named field of the states ``got`` and ``want``: float64 within
    1e-12 of each element with a floor of 1e-12 of the field's largest
    magnitude, float32 within F32_REL_TOL of that magnitude; returns each
    field's max abs difference."""
    errs = {}
    for field in names:
        a, b = got[field], want[field]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite {field}")
        scale, diff = float(b.abs().max()), (a - b).abs()
        errs[field] = float(diff.max())
        bad = bool((diff > 1e-12 * b.abs() + 1e-12 * scale).any()) if f64 else \
            errs[field] > F32_REL_TOL * max(scale, 1e-30)
        if bad:
            raise AssertionError(f"{name} {field}: max abs err {errs[field]}, largest "
                                 f"magnitude {scale}")
    return errs


class KernelEvents:
    """Within ``with``, CUDA events around each call of the kernel wrapper
    ``table[key]`` (a ROLLOUTS table, which ``advance`` reads at each run):
    ``spans``, one ``(start, end)`` a launch."""

    def __init__(self, table, key):
        self.table, self.key, self.spans = table, key, []

    def __enter__(self):
        self.real = self.table[self.key]

        def timed(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = self.real(*args, **kw)
            end.record()
            self.spans.append((start, end))
            return out

        self.table[self.key] = timed
        return self

    def __exit__(self, *exc):
        self.table[self.key] = self.real


def stream_timeline(pipe, spans):
    """Per chunk of ``pipe``'s last run: its kernel time (``spans``, the
    launches), the copy time of the window it read where it was copied for
    it, the gap from the kernel before to its kernel (the chunk before's
    trailing closure and this one's host work), whether its window's copy,
    issued before the chunk before launched, overlapped that chunk's kernel
    and was hidden (done before that kernel ended, so that this chunk's
    wait on it cost nothing)."""
    torch.cuda.synchronize()
    rows = []
    for i, (chunk, (ks, ke)) in enumerate(zip(pipe.chunks, spans)):
        row = {"steps": chunk.steps, "kernel_ms": ks.elapsed_time(ke)}
        if chunk.new_window:
            row["copy_ms"] = chunk.copy_start.elapsed_time(chunk.copy_end)
        if i:
            pks, pke = spans[i - 1]
            row["gap_ms"] = pke.elapsed_time(ks)
            if chunk.new_window:
                row["copy_overlaps_kernel"] = bool(
                    chunk.copy_end.elapsed_time(pks) < 0 < chunk.copy_start.elapsed_time(pke))
                row["copy_hidden"] = chunk.copy_end.elapsed_time(pke) >= 0
        rows.append(row)
    return rows


def peak_mb(fn):
    """``fn()``'s peak device memory above the memory allocated when it
    starts, in MB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - start) / 1e6


def stream_phase(tp, fs, ls, kind, reset_counts, launched, card):
    """stream_soil / stream_land: the streamed run against the whole series
    on the card (float64, float32; run_fused and run), then the float32
    run_fused over STREAM_DAYS days timed, one launch a chunk. The float32
    runs' peak memory: the streamed runs' within two windows and a quarter
    of the whole series run's (the device buffers of the stager's two
    slots), the month's within a quarter of a window of the short
    run_fused's."""
    cfg = STREAM[kind]
    times, series = stream_series(kind, cfg["steps"])
    wrapper = fs.soil_column_rollout if kind == "soil" else ls.land_column_implicit_rollout
    table, key = ((fs.ROLLOUTS, ("euler", "richards")) if kind == "soil"
                  else (ls.ROLLOUTS, "implicit"))
    names = (("internal_energy", "saturation_water_ice", "surface_excess_water")
             if kind == "soil" else None)
    window_mb = sum(cfg["window"] * v.shape[1] * 4 for v in series.values()) / 1e6  # float32
    errs, peaks = {}, {}
    for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
        whole = stream_sim(tp, kind, dtype, tp.TimeSeriesInputSource(times=times, series={
            k: torch.as_tensor(v, device="cuda").to(dtype).contiguous()
            for k, v in series.items()}))
        peaks[f"whole:{tag}"] = peak_mb(lambda: whole.run(steps=cfg["steps"], dt=cfg["dt"]))
        names = names or tuple(whole.model.live_carry)
        routes = ("run_fused", "run") if tag == "f32" else ("run_fused",)
        for route in routes:
            pipe = tp.ChunkedForcingPipeline(times, series, window=cfg["window"])
            sim = stream_sim(tp, kind, dtype, pipe)
            peaks[f"{route}:{tag}"] = peak_mb(
                lambda: getattr(pipe, route)(sim, steps=cfg["steps"], dt=cfg["dt"]))
            errs[f"{route}:{tag}"] = check_fields(f"stream_{kind} {route} {tag}", sim.state,
                                                  whole.state, names, f64=tag == "f64")
            if sim.current_time != whole.current_time:
                raise AssertionError(f"stream_{kind} {route} {tag}: clock {sim.current_time}")
        del whole, sim
    # the path: float32 run_fused over STREAM_DAYS days, one launch a chunk,
    # its chunks timed
    steps = int(round(STREAM_DAYS * 86400.0 / cfg["dt"]))
    times, series = stream_series(kind, steps)
    pipe = tp.ChunkedForcingPipeline(times, series, window=cfg["window"])
    sim = stream_sim(tp, kind, torch.float32, pipe)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with KernelEvents(table, key) as kev:
        peaks["run_fused_month:f32"] = peak_mb(
            lambda: pipe.run_fused(sim, steps=steps, dt=cfg["dt"]))
    run_s = time.perf_counter() - t0
    launches = wrapper.launches
    if launched() != {wrapper.__name__: len(pipe.chunks)} or len(kev.spans) != len(pipe.chunks):
        raise AssertionError(f"stream_{kind}: {len(pipe.chunks)} chunks launched {launched()}")
    for field in names:
        if not bool(torch.isfinite(sim.state[field]).all()):
            raise AssertionError(f"stream_{kind} month: non-finite {field}")
    for route in ("run_fused", "run"):
        if peaks[f"{route}:f32"] > peaks["whole:f32"] + 2.25 * window_mb:
            raise AssertionError(f"stream_{kind} {route}: peak {peaks} MB, a window "
                                 f"{window_mb} MB")
    if peaks["run_fused_month:f32"] > peaks["run_fused:f32"] + 0.25 * window_mb:
        raise AssertionError(f"stream_{kind}: the month's peak {peaks} MB grew with its "
                             f"windows ({window_mb} MB each)")
    rows = stream_timeline(pipe, kev.spans)
    later = [r for r in rows[1:] if "copy_ms" in r]
    med = lambda k, rs=rows: float(np.median([r[k] for r in rs if k in r]))  # noqa: E731
    report = {"launches": launches, "chunks": len(pipe.chunks),
              "kernel_ms": med("kernel_ms"), "copy_ms": med("copy_ms"),
              "gap_ms": med("gap_ms", rows[1:]),
              "copies_hidden": all(r["copy_hidden"] for r in later),
              "copies_overlapping_kernel": sum(r["copy_overlaps_kernel"] for r in later),
              "window_mb": window_mb, "peak_mb": peaks}
    phase(f"stream_{kind}", cells=sim.model.grid.cells, nz=sim.model.grid.nz, dt=cfg["dt"],
          steps=cfg["steps"], timed_steps=steps, window=cfg["window"],
          fused_inner_steps=cfg["inner"], clock_start_s=STREAM_DAY0,
          series_rows=len(times), f64_rtol=1e-12, f32_rel_tol=F32_REL_TOL, max_abs_err=errs,
          run_fused_s=run_s, **report, per_chunk=rows, card=card)
    del sim, pipe


def micro_fma_f32(x, kind, R):
    """Row 4's fma or fma4 chain at float32 as the kernel's contracted FMA
    computes it: each step in float64 and rounded once to float32. The
    product of two float32 values is exact in float64, and so is its sum
    with float32 1e-7 while the values lie in [0.5, 5) (50 bits from 2^2 to
    2^-47), so the one rounding is fmaf's and the result is the kernel's
    bit for bit."""
    b = float(torch.tensor(1e-7, dtype=torch.float32))
    starts = range(4) if kind == "fma4" else range(1)
    vs = []
    for i in starts:
        a = float(torch.tensor(1.0000001 + 1e-9 * i, dtype=torch.float32))
        v = (x + float(i)).double()
        for _ in range(R):
            v = (v * a + b).float().double()
        vs.append(v.float())
    return vs[0] if kind == "fma" else ((vs[0] + vs[1]) + vs[2]) + vs[3]


def probes_phase():
    """The probes (rows 4-6): each kernel against its plain version at the
    probe's shapes, float64 (-fmad=false) within 1e-12 and float32 within
    1e-5 relative (row 4's exp, div and pow chains: their maps contract, and
    expf, '/' and powf may differ from torch's by an ulp) or 1e-6 of each
    output's magnitude (rows 5 and 6, whose products are not contracted:
    only the exponentials' last ulp may differ). Row 4's chain length is
    held too: fma and fma4 at R 1, 2, 3 and at both timed lengths, where
    every step moves each value by an ulp or more at float32 and by 1e-7
    relative at float64, float32 bit for bit to micro_fma_f32 (the
    contracted FMA the kernel computes); exp, div and pow at R 1, 2 and 3
    from inputs that each step moves far beyond the tolerance (exp from
    [-1000, 1000), the others from [0, 100)). Returns the checks' errors
    and the plain versions' and torch.cummin's times for the kernels line
    (a call's device time, PROBE_REPS calls in a CUDA graph)."""
    from terrarium_tpu_torch.experiments import mosaic_bisect as mb
    from terrarium_tpu_torch.experiments import mosaic_min_repro as mr
    from terrarium_tpu_torch.experiments import probe
    from terrarium_tpu_torch.experiments import roofline_census as rc

    gen = torch.Generator(device="cpu").manual_seed(14)
    x = (0.5 + torch.rand(rc.SHAPE, generator=gen, dtype=torch.float64)).cuda()
    T = (torch.rand(mr.NZ, mr.BLOCK, generator=gen, dtype=torch.float64) * 5.0 - 2.0).cuda()
    s = torch.rand(mr.BLOCK, generator=gen, dtype=torch.float64).cuda()
    wide = {"exp": torch.rand(rc.SHAPE, generator=gen, dtype=torch.float64).cuda() * 2e3 - 1e3,
            "div": torch.rand(rc.SHAPE, generator=gen, dtype=torch.float64).cuda() * 100.0}
    wide["pow"] = wide["div"]
    errs = {}
    for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
        f64 = tag == "f64"
        xd = x.to(dtype)
        for kind, (_, (r1, r2)) in rc.KINDS.items():
            fma = kind.startswith("fma")
            runs = ([(R, xd) for R in (1, 2, 3, r1, r2)] if fma else
                    [(r1, xd)] + [(R, wide[kind].to(dtype)) for R in (1, 2, 3)])
            for R, xk in runs:
                got = rc.micro_chain(xk, kind, R)
                want = (micro_fma_f32(xk, kind, R) if fma and not f64
                        else rc.micro_chain_plain(xk, kind, R))
                err = float((got - want).abs().max())
                rel = float(((got - want).abs() / want.abs()).max())
                errs[f"micro:{kind}:R{R}:{tag}"] = err
                if not rel <= (1e-12 if f64 else 0.0 if fma else 1e-5):
                    raise AssertionError(f"probe micro {kind} R {R} {tag}: max abs err {err}, "
                                         f"relative {rel}")
                del got, want
        xb, dz = mb.inputs(dtype, "cuda")
        checks = [(f"bisect:{case}", mb.bisect_case(case, xb, dz),
                   mb.bisect_case_plain(case, xb, dz)) for case in mb.CASES]
        for variant in mr.VARIANTS:
            for part, got, want in zip("Ts", mr.repro_variant(variant, T.to(dtype), s.to(dtype)),
                                       mr.repro_variant_plain(variant, T.to(dtype), s.to(dtype))):
                checks.append((f"repro:{variant}:{part}", got, want))
        for name, got, want in checks:
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            errs[f"{name}:{tag}"] = err
            if not err <= (1e-12 if f64 else 1e-6) * scale:
                raise AssertionError(f"probe {name} {tag}: max abs err {err}, magnitude {scale}")
        del xd, xb, checks
    # the plain versions and torch.cummin, for the kernels line
    ones = torch.ones(rc.SHAPE, dtype=torch.float32, device="cuda")
    xb, dz = mb.inputs(torch.float32, "cuda")
    T1, s0 = (torch.ones(mr.NZ, mr.BLOCK, device="cuda"), torch.zeros(mr.BLOCK, device="cuda"))
    xs = mb.rotating(xb)  # as run_case times the kernel: its input from device memory

    def med(fn):
        return probe.graph_ms(fn, PROBE_REPS)

    times = {"micro_plain_ms": cuda_ms(lambda: rc.micro_chain_plain(ones, "fma", 512),
                                       warmup=True),
             "bisect_plain_ms": {case: med(lambda c=case: mb.bisect_case_plain(c, next(xs), dz))
                                 for case in mb.CASES},
             "cummin_library_ms": med(lambda: torch.cummin(next(xs), dim=0)),
             "repro_plain_ms": {v: med(lambda v=v: mr.repro_variant_plain(v, T1, s0))
                                for v in mr.VARIANTS}}
    return errs, times


def probes_main_path(card, errs, times, reset_counts, launched):
    """Each probe's entry point as a user runs it, the counts set to 0
    before; returns the kernels line's three entries: row 4 at the fma
    kind, R 512, one pass (bound: 2 flops an FMA at the FP32 peak), row 5
    at cummin (bound: its bytes, 13.8 MB; the library call torch.cummin),
    row 6 at row_to_xy_stencil (bound: its bytes, 18 kB, far under the
    launch latency that floors it; 4 operations a level and 4 for s an
    iteration)."""
    from terrarium_tpu_torch.experiments import mosaic_bisect as mb
    from terrarium_tpu_torch.experiments import mosaic_min_repro as mr
    from terrarium_tpu_torch.experiments import roofline_census as rc

    torch.cuda.synchronize()
    reset_counts()
    rates = rc.run_micro()
    cases = {case: mb.run_case(case, reps=PROBE_REPS) for case in mb.CASES}
    variants = {v: mr.run_variant(v, reps=PROBE_REPS) for v in mr.VARIANTS}
    torch.cuda.synchronize()
    counts = launched()
    # run_micro: 2 lengths a kind, 1 + 7 dispatches of PASSES launches each;
    # run_case / run_variant: the check, graph_ms's warm-up and 5 replays of
    # PROBE_REPS launches, median_ms's warm-up and PROBE_REPS launches
    per_case = 1 + (1 + 5 * PROBE_REPS) + (1 + PROBE_REPS)
    want = {"micro_chain": len(rc.KINDS) * 2 * (1 + 7) * rc.PASSES,
            "bisect_case": len(mb.CASES) * per_case, "repro_variant": len(mr.VARIANTS) * per_case}
    if counts != want:
        raise AssertionError(f"probes: launches {counts}, expected {want}")
    for kind, r in rates.items():
        r1, r2 = rc.KINDS[kind][1]
        if not r[f"t_R{r2}_s"] > r[f"t_R{r1}_s"] > 0.0:
            raise AssertionError(f"probes: {kind} at R {r2} took no longer than at R {r1}: {r}")
    n, ncell = rc.SHAPE[0] * rc.SHAPE[1], -(-mb.CELLS // mb.BLK) * mb.BLK
    fma_ms = rates["fma"]["t_R512_s"] * 1e3 / rc.PASSES
    rep_bytes = 2 * (mr.NZ + 1) * mr.BLOCK * 4
    phase("probes", rates=rates, cases=cases, variants=variants, launches=counts,
          max_abs_err=errs, f64_rtol=1e-12, f32_micro_rel_tol=1e-5, f32_rel_tol=1e-6,
          **times, card=card)
    f32 = lambda prefix: max(v for k, v in errs.items()  # noqa: E731
                             if k.startswith(prefix) and k.endswith(":f32"))
    entries = [
        ("micro_chain", "experiments/roofline_census.py:260", counts["micro_chain"],
         f32("micro:"), fma_ms, times["micro_plain_ms"],
         bound_ms(2 * 512 * n, 2 * 4 * n), None,
         f"{rc.SHAPE[0]} x {rc.SHAPE[1]} f32, fma, R 512, one pass (rates: "
         + ", ".join(f"{k} {v['gops_per_s']:.1f} Gop/s" for k, v in rates.items()) + ")"),
        ("bisect_case", "experiments/mosaic_bisect.py:29", counts["bisect_case"],
         f32("bisect:"), cases["cummin"]["ms"], times["bisect_plain_ms"]["cummin"],
         bound_ms(mb.NZ * ncell, 2 * mb.NZ * ncell * 4),
         times["cummin_library_ms"],
         f"{mb.NZ} x {ncell} f32, cummin (" + ", ".join(
             f"{c} {v['ms']:.4f} ms" for c, v in cases.items()) + ")"),
        ("repro_variant", "experiments/mosaic_min_repro.py:72", counts["repro_variant"],
         f32("repro:"), variants["row_to_xy_stencil"]["ms"],
         times["repro_plain_ms"]["row_to_xy_stencil"],
         bound_ms(mr.INNER * mr.BLOCK * (mr.NZ * 4 + 4), rep_bytes), None,
         f"{mr.NZ} x {mr.BLOCK} f32, {mr.INNER} iterations, row_to_xy_stencil (" + ", ".join(
             f"{v} {r['ms']:.4f} ms" for v, r in variants.items()) + ")")]
    return [{"name": name, "route": "cuda", "source": "terrarium_tpu_torch/csrc/probes.cu",
             "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
             "plain_ms": plain, "bound_ms": b[0], "bound_by": b[1], "library_ms": lib,
             "shape": shape}
            for name, replaces, launches, err, ms, plain, b, lib, shape in entries]


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
    from terrarium_tpu_torch.experiments import mosaic_bisect as mb
    from terrarium_tpu_torch.experiments import mosaic_min_repro as mr
    from terrarium_tpu_torch.experiments import roofline_census as rc

    KERNELS = (fs.soil_column_rollout, fs.soil_column_heun_rollout,
               fs.soil_column_heat_rollout, fs.soil_column_implicit_rollout,
               fs.soil_column_heat_heun_rollout, fs.soil_column_heat_implicit_rollout,
               fv.soil_column_segment_vjp, ls.land_column_rollout, ls.land_column_heun_rollout,
               ls.land_column_implicit_rollout, fs.soil_column_full_step,
               lv.land_column_segment_vjp, ls.land_column_full_step, rc.micro_chain,
               mb.bisect_case, mr.repro_variant)

    def reset_counts():
        for fn in KERNELS:
            fn.launches = 0

    def launched():
        return {fn.__name__: fn.launches for fn in KERNELS if fn.launches}

    # ---- build: one nvcc per instantiation and core (cuda_build's slots);
    # the rollout source first, then, in threads of their own, queued for
    # the slots behind it, so that they fill the slots its last compiles
    # leave (and build while the forward phases run on the card),
    # on_demand's two instantiations and the other sources in the order the
    # phases need them (REST_GROUPS), each group's nvcc queued for the slots
    # before the next group's
    rest_done = {}  # source -> seconds since the start at which it was built

    def build_group(group):
        try:
            cuda_build.build(*group)
            rest_done.update(dict.fromkeys(group, time.perf_counter() - _T0))
        except Exception:  # noqa: BLE001 -- built() builds again in the main thread and raises
            pass

    t0 = time.perf_counter()
    names = tuple(cuda_build.INSTANTIATIONS)
    first = threading.Thread(target=build_group, args=(FIRST_SOURCES,), daemon=True)
    first.start()
    time.sleep(1.0)  # the rollout sources' nvcc processes queue for the slots first
    rest = tuple(n for group in REST_GROUPS for n in group)
    if sorted(rest) != sorted(set(names) - set(FIRST_SOURCES)):
        raise AssertionError(f"the build's sources are {names}")
    # C1's compositions: their kernels, which no prebuilt instantiation
    # covers, built at first use (cuda_build.entry, as their Simulation.run's
    # first launch builds them), each timed; the on_demand phase runs them
    od_sims = {case: on_demand_sim(tp, case) for case in ON_DEMAND_STEPS}
    od_built, od_errors = {}, []

    def build_on_demand(case):
        src, dtype, nz, argtypes, tags, _ = on_demand_kernel(fs, ls, case, od_sims[case])
        try:
            if (tags, dtype, nz) in cuda_build.INSTANTIATIONS[src]:
                raise AssertionError(f"{case}: {src} {tags} is prebuilt")
            t_b = time.perf_counter()
            cuda_build.entry(src, dtype, nz, argtypes, tags=tags)
            od_built[case] = (cuda_build._entry_name(src, tags, dtype, nz),
                              time.perf_counter() - t_b, time.perf_counter() - _T0)
        except Exception as e:  # noqa: BLE001 -- raised by the on_demand phase
            od_errors.append((case, e))

    od_threads = [threading.Thread(target=build_on_demand, args=(case,), daemon=True)
                  for case in ON_DEMAND_STEPS]
    compiling = {}
    for thread in od_threads:
        thread.start()
    for group in REST_GROUPS:
        thread = threading.Thread(target=build_group, args=(group,), daemon=True)
        thread.start()
        compiling.update(dict.fromkeys(group, thread))
        time.sleep(1.0)  # this group's nvcc processes queue for the slots first
    first.join()
    cuda_build.build(*FIRST_SOURCES)  # raises the first build's error, if any
    first_s = time.perf_counter() - t0
    ptxas_all = {n: ptxas_summary(cuda_build.ptxas_report(n)) for n in FIRST_SOURCES}
    phase("build", sources=list(FIRST_SOURCES), seconds=first_s,
          instantiations=sum(len(cuda_build.INSTANTIATIONS[n]) for n in FIRST_SOURCES),
          ptxas=ptxas_all)

    def built(*group):
        """Wait for the sources of ``group`` (a REST_GROUPS entry); their
        build's phase line, once."""
        if group[0] not in ptxas_all:
            compiling[group[0]].join()
            if any(n not in rest_done for n in group):
                cuda_build.build(*group)  # the thread failed: raise its error here
                rest_done.update(dict.fromkeys(group, time.perf_counter() - _T0))
            ptxas_all.update({n: ptxas_summary(cuda_build.ptxas_report(n)) for n in group})
            phase("build_rest", sources=list(group),
                  built_s_since_start=max(rest_done[n] for n in group),
                  instantiations=sum(len(cuda_build.INSTANTIATIONS[n]) for n in group),
                  cpu_s_total=sum(v.get("cpu_s", 0.0) for n in group
                                  for v in ptxas_all[n].values()),
                  ptxas={n: ptxas_all[n] for n in group})
        return ptxas_all

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
    # ---- the group kernel of row 1: its layout and resources, its sweeps'
    # hand-offs on the bench operands, and row 1 at float64
    row1 = group_row(fs, cuda_build, "euler", (carry, table, coords, params), BENCH_DT,
                     ptxas_all, FWD_FMA_ISSUES_PER_LEVEL_STEP)
    row1_f64 = group_f64_check(tp, fs, "euler")
    phase("group_check", row="1", cells=BENCH_CELLS, nz=BENCH_NZ, steps=COMPARE_STEPS, **row1,
          f64_cells=GROUP_F64_CELLS, f64_rtol=1e-12, f64_max_abs_err=row1_f64, card=card)

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
    row1a = group_row(fs, cuda_build, "heun", (carry, bc, coords, params), BENCH_DT, ptxas_all,
                      HEUN_FMA_ISSUES_PER_LEVEL_STEP)
    row1a_f64 = group_f64_check(tp, fs, "heun")
    phase("group_check", row="1'a", cells=BENCH_CELLS, nz=BENCH_NZ, steps=COMPARE_STEPS,
          **row1a, f64_cells=GROUP_F64_CELLS, f64_rtol=1e-12, f64_max_abs_err=row1a_f64,
          card=card)
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
        # ---- the group kernel of row 1'c: its layout and resources, its
        # sweeps' hand-offs on these operands, the weighted bound
        row1c = group_row(fs, cuda_build, "implicit", (carry, table, coords, params),
                          IMPLICIT_DT, ptxas_all, implicit_fma_issues(
                              solver, BENCH_NZ, 1, fs._CParams.of(params)) / BENCH_NZ,
                          solver=solver)
        phase("group_check", row="1'c", solver=solver, cells=BENCH_CELLS, nz=BENCH_NZ,
              steps=COMPARE_STEPS, **row1c, card=card)
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
                           cells_steps_per_s=BENCH_CELLS * IMPLICIT_BLOCK_STEPS / run_s,
                           group=row1c)
        phase("implicit_compare", solver=solver, steps=COMPARE_STEPS, rel_tol=F32_REL_TOL,
              water_tol=IMPLICIT_F32_WATER_TOL, max_abs_err=cmp_, water_identity_rel_err=ident,
              kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b[0], bound_by=b[1], card=card)
        phase("implicit_main_path", solver=solver, cells=BENCH_CELLS, nz=BENCH_NZ,
              dt=IMPLICIT_DT, steps=IMPLICIT_BLOCK_STEPS, seconds=run_s, launches=launches,
              cells_steps_per_s=BENCH_CELLS * IMPLICIT_BLOCK_STEPS / run_s, card=card,
              T_top_range=[float(st.temperature[-1].min()), float(st.temperature[-1].max())],
              frozen_fraction_top=float((st.liquid_water_fraction[-1] < 1.0).float().mean()))
        del sim, st, sat

    # ---- this slice's forward paths (NEW_FORWARD): the heat-only model by
    # Heun and by ImplicitEuler (each solver), heat + Richards by
    # ImplicitEuler with two Picard iterations (each solver)
    new_fwd = {name: new_forward_phase(tp, fs, cuda_build, name, reset_counts, launched, card)
               for name in NEW_FORWARD}

    # ---- land_model golden through the land kernel (Simulation.run, one
    # launch) and through the plain version (the process modules), once the
    # land rollout is built
    built(*REST_GROUPS[0])
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

    # ---- on_demand: C1's compositions through Simulation.run on the
    # kernels built at their first use, each one launch, against its plain
    # version (advance(plain=True), then compute_auxiliary as run ends) at
    # F32_REL_TOL of each field's magnitude
    for thread in od_threads:
        thread.join()
    if od_errors:
        raise od_errors[0][1]
    od = {}
    for case, sim in od_sims.items():
        src, _, _, _, tags, wrapper = on_demand_kernel(fs, ls, case, sim)
        ref = on_demand_sim(tp, case)
        steps = ON_DEMAND_STEPS[case]
        reset_counts()
        t_run = time.perf_counter()
        sim.run(steps=steps)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        if launched() != {wrapper.__name__: 1}:
            raise AssertionError(f"on_demand {case}: the run launched {launched()}, expected "
                                 f"one {wrapper.__name__}")
        advance(ref.model, ref.state, ref.ctx, steps, ref.timestepper.default_dt(),
                timestepper=ref.timestepper, input_sources=ref.input_sources, plain=True)
        ref.compute_auxiliary()  # as run ends: the SEB writes the skin temperature afresh
        errs = {}
        for n in sim.model.live_carry:
            a, b = sim.state[n], ref.state[n]
            errs[n] = float((a - b).abs().max())
            if not bool(torch.isfinite(a).all()) or errs[n] > F32_REL_TOL * float(b.abs().max()):
                raise AssertionError(f"on_demand {case}: {n} kernel vs plain max abs err "
                                     f"{errs[n]}, largest magnitude {float(b.abs().max())}")
        entry, build_s, done_s = od_built[case]
        od[case] = dict(entry=entry, build_s=build_s, built_s_since_start=done_s,
                        cells=sim.model.grid.cells, nz=sim.model.grid.nz,
                        dt=sim.timestepper.default_dt(), steps=steps, run_seconds=run_s,
                        launches={wrapper.__name__: 1}, rel_tol=F32_REL_TOL, max_abs_err=errs,
                        ptxas=ptxas_summary(cuda_build.ptxas_report(src)).get(entry))
        del sim, ref
    phase("on_demand", cases=od, card=card)
    del od_sims

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
    land_var = {vname: land_variant_compare(tp, ls, fs, cuda_build, land_inputs, vname,
                                            ptxas_all, card) for vname in LAND_VARIANTS}

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

    # ---- ImplicitEuler with LAND_PICARD_ITERS Picard iterations, each
    # solver: the kernel against its plain version as the variants above
    # (land_picard_compare), then one timed 1,440-step Simulation.run block
    # of land_implicit's composition (land_picard_main_path)
    for vname in LAND_PICARD_VARIANTS:
        land_var[vname] = land_variant_compare(tp, ls, fs, cuda_build, land_inputs, vname,
                                               ptxas_all, card, name="land_picard_compare")
        land_var[vname]["launches"] = land_stepper_main_path(
            tp, ls, land_inputs, "land_picard_main_path", vname, land_var[vname], reset_counts,
            launched, card)

    # ---- the LandModel's gradient path (LAND_GRAD_SCHEMES): the land
    # segment-VJP kernel against its plain version (float64 on
    # LAND_F64_CELLS columns, one segment; float32 at full width, the plain
    # version in chunks, a column where the two part held to a float64
    # referee), the float64 gradient against central differences of the
    # forward kernel's loss, then the timed 288-step gradient at full width
    built(*REST_GROUPS[1])
    land_grads, f32_gaps = {}, {}
    x0, k0 = land_grad_params(tp)
    for name, (key, solver, dt) in LAND_GRAD_SCHEMES.items():
        iters = LAND_GRAD_PICARD.get(name, 1)
        vkw = {"stepper": key, "solver": solver, "picard_iters": iters}
        fwd = ls.ROLLOUTS[key]
        fkw = {"solver": solver, "picard_iters": iters} if solver else {}
        sim = land_grad_sim(tp, LAND_F64_CELLS, torch.float64, name)
        ops = land_grad_operands(ls, land_inputs, sim, seed=11)
        f64_err, f64_rel, f64_out = land_vjp_compare(lv, ls, *ops[:5], dt, GRAD_INNER, ops[5],
                                                     vkw, 1e-9, LAND_F64_CELLS)
        source = lv.vjp_source(ops[4], key)
        recompute64 = None
        if source == LAND_VJP_GROUP_SOURCE:
            # the forward segments' rollout: the group rollout at the VJP's G
            fkw["group"] = lv.vjp_group(torch.float32, LAND_NZ, lv.check_scheme(
                ops[4], key, solver, iters) + ops[4].tags, solver)[1]
            # rows 3'e, 3'i and 3'j: the group VJP's stored carries at
            # float64 equal the group land rollout's bit for bit
            recompute64 = land_vjp_recompute_check(fs, lv, ls, cuda_build, ops, dt, GRAD_INNER,
                                                   solver, iters, stepper=key)
            if recompute64[1]:
                raise AssertionError(f"{name}: the f64 group VJP's stored carries of "
                                     f"{recompute64[1]} columns part from the group "
                                     f"rollout's")
        # central differences of the loss through the forward kernel, over
        # LAND_FD_STEPS[key] steps
        steps_fd = LAND_FD_STEPS[key]
        fd_h = LAND_SNOW_FD_H if name in LAND_GRAD_SNOW else LAND_FD_H
        _, gx, gk = land_grad_value(tp, sim, name, steps=steps_fd)
        fd = []
        for i, h in enumerate((fd_h["log_K_sat"], fd_h["k_mineral"])):
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
        if steps_fd != GRAD_STEPS or fd_h is LAND_SNOW_FD_H:
            # the loss over the gradient's steps at the other h, reported
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
            lv, ls, name, carry, linputs, root, coords, params, dt, GRAD_INNER, gout, vkw)
        c3 = None
        if source != LAND_VJP_GROUP_SOURCE:
            # ROADMAP C3: the one-thread VJP's float32 stored carries against
            # the one-thread rollout's (the forward segments' build), which
            # forms the step out of line where the VJP inlines it; neither
            # contracts a multiply-add, and none may part
            c3 = land_vjp_recompute_check(fs, lv, ls, cuda_build,
                                          (carry, linputs, root, coords, params, gout), dt,
                                          GRAD_INNER, solver, iters, stepper=key,
                                          one_thread=True)
            if c3[1]:
                raise AssertionError(f"{name}: the one-thread VJP's f32 stored carries of "
                                     f"{c3[1]} columns part from the forward segments' "
                                     f"(ROADMAP C3), by up to {c3[2]}")
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
        snow = name in LAND_GRAD_SNOW
        v_ops = land_vjp_ops(key, solver, LAND_NZ, runs, iters, snow)
        b = bound_ms(v_ops * LAND_CELLS * GRAD_INNER,
                     land_vjp_bytes(LAND_NZ, LAND_CELLS, 4, snow))
        del sub, end
        group = None
        if source == LAND_VJP_GROUP_SOURCE:
            # rows 3'e, 3'i and 3'j on the group kernel: its layout and
            # resources, its float32 stored carries against the group
            # rollout's (none may part), the weighted bound
            group = land_vjp_group_row(fs, lv, ls, cuda_build,
                                       (carry, linputs, root, coords, params, gout), dt,
                                       GRAD_INNER, solver, iters, runs, ptxas_all, key)
            phase("group_check", row="3'j" if key == "heun" else "3'k" if snow
                  else "3'i" if iters > 1 else "3'e",
                  stepper=key, solver=solver,
                  picard_iters=iters, cells=LAND_CELLS, nz=LAND_NZ, steps=GRAD_INNER,
                  **group, recompute_f64_cells=LAND_F64_CELLS,
                  recompute_f64_columns_parted=recompute64[1],
                  recompute_f64_max_gap_over_magnitude=recompute64[2], card=card)
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
        # moves it (the model's own conditioning: reported for one Picard
        # iteration; with more, held within LAND_PICARD_F32_GAP_TOL of the
        # one-iteration scheme's gap with the same solver, run before it)
        sim64 = land_grad_sim(tp, LAND_CELLS, torch.float64, name)
        value64, gx64, gk64 = land_grad_value(tp, sim64, name)
        del sim64
        f32_vs_f64 = [abs(a - b) / abs(b) for a, b in ((value, value64), (ggx, gx64),
                                                       (ggk, gk64))]
        if iters == 1:
            f32_gaps[(key, solver, snow)] = f32_vs_f64
        else:
            one = f32_gaps[(key, solver, snow)]
            if max(abs(a - b) for a, b in zip(f32_vs_f64, one)) > LAND_PICARD_F32_GAP_TOL:
                raise AssertionError(f"{name}: float32 vs float64 gaps {f32_vs_f64}, one "
                                     f"iteration's {one}")
        final = fwd(carry, linputs, root, *coords, params, dt, 0.0, GRAD_STEPS, **fkw)
        entry = cuda_build._entry_name(source, lv.check_scheme(
            params, key, solver, iters) + params.tags, torch.float32, LAND_NZ)
        land_grads[name] = dict(launches=grad_launches["land_column_segment_vjp"],
                                max_abs_err=max(f32_err.values()), ms=k_ms, plain_ms=p_ms,
                                bound_ms=b[0], bound_by=b[1], entry=entry, snow=snow,
                                source=source, **(group or {}))
        phase(name, cells=LAND_CELLS, nz=LAND_NZ, dt=dt, steps=GRAD_STEPS,
              inner_steps=GRAD_INNER, stepper=key, solver=solver, picard_iters=iters, snow=snow,
              seconds_median=med,
              vjp_share_of_gradient=(GRAD_STEPS // GRAD_INNER) * k_ms / 1e3 / med,
              seconds=times, launches=grad_launches, cells_steps_per_s=LAND_CELLS * GRAD_STEPS / med,
              loss=value, dloss_dlog_K_sat=ggx, dloss_dk_mineral=ggk, f64_loss=value64,
              f64_dloss_dlog_K_sat=gx64, f64_dloss_dk_mineral=gk64,
              f32_vs_f64_rel=f32_vs_f64, vjp_segment_ms=k_ms,
              fwd_segment_ms=f_ms, plain_vjp_ms=p_ms, plain_cells=LAND_GRAD_CHUNK,
              bound_ms=b[0], bound_by=b[1], ops_per_column_step=v_ops,
              branch_runs_per_column_step=runs,
              ptxas=ptxas_all[source].get(entry, {}).get(
                  "vjp_" + (solver or key) if source == LAND_VJP_GROUP_SOURCE else "vjp"),
              c3_one_thread_recompute_f32=c3, group_check=group,
              f64_cells=LAND_F64_CELLS, f64_rtol=1e-9, f64_max_abs_err=f64_err,
              f64_max_err_over_magnitude=f64_rel, f64_columns_left_out=f64_out,
              fd_steps=steps_fd, fd_h=fd_h, fd_rtol=LAND_FD_RTOL,
              f64_kernel_grad=[gx, gk], central_difference=fd, fd_rel_err=fd_rel,
              dlog_K_sat_at_gradient_steps_adjoint_and_by_h=fd_report,
              f32_rel_tol=F32_VJP_REL_TOL, f32_max_abs_err=f32_err,
              f32_max_err_over_magnitude=f32_rel, f32_flip_columns=flips,
              outside_unit_share_at_end=float(outside_unit(final).float().mean()), card=card)
        del gsim, carry, gout, final

    # ---- rows 1'g and 3'k's other snowy entries (Thomas, two Picard
    # iterations, Heun) at float64 against their plain versions
    land_snow_entries_check(tp, ls, lv, fs, land_inputs, card)

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

    # ---- the soil gradients, once the soil segment VJP is built
    built(*REST_GROUPS[2])

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
    # row 3 on the group kernel: its layout and resources, and its stored
    # carries against the group rollout's (the gradient's forward segments)
    row3 = vjp_group_row(fs, fv, cuda_build, ops, GRAD_DT, "pcr", 1, ptxas_all, stepper="euler")
    phase("group_check", row="3", stepper="euler", cells=GRAD_CELLS, nz=GRAD_NZ,
          steps=GRAD_INNER, **row3, card=card)

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
        fkw = ({"solver": cfg["solver"], "picard_iters": cfg.get("picard", 1)}
               if cfg["stepper"] == "implicit" else {})
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
        group, source = None, "soil_column_segment_vjp"
        if (cfg["stepper"], cfg["physics"]) in fv.GROUP_SCHEMES:
            # rows 3'a, 3'b and 3'h on the group kernel: its layout and
            # resources, and its stored carries against the group rollout's
            iters = cfg.get("picard", 1)
            source = VJP_GROUP_SOURCE
            group = vjp_group_row(fs, fv, cuda_build, (carry, table, coords, params, cts), dt,
                                  cfg["solver"], iters, ptxas_all, stepper=cfg["stepper"])
            row = ("3'a" if cfg["stepper"] == "heun" else "3'h" if iters > 1 else "3'b")
            phase("group_check", row=row, stepper=cfg["stepper"], solver=cfg["solver"],
                  picard_iters=iters, cells=GRAD_CELLS, nz=BENCH_NZ, steps=GRAD_INNER, **group,
                  card=card)
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
        entry = cuda_build._entry_name(source, fv.vjp_tags(
            cfg["stepper"], cfg["physics"], cfg["solver"], cfg.get("picard", 1)), torch.float32,
            BENCH_NZ)
        extra = {}
        if cfg.get("fd"):
            # the float64 gradient through the kernels on GRAD_REF_CELLS
            # columns at the float64 Nz against central differences of the
            # loss through the forward kernel
            sim64 = scheme_sim(tp, name, GRAD_REF_CELLS, cfg["f64_nz"], torch.float64)
            v64, g64 = scheme_value(tp, name, sim64)
            fd = {h: (scheme_value(tp, name, sim64, shift=h, grad=False)
                      - scheme_value(tp, name, sim64, shift=-h, grad=False)) / (2 * h)
                  for h in FD_HS}
            fd_rel = {h: abs(g64 - v) / abs(v) for h, v in fd.items()}
            if min(fd_rel.values()) > 5e-4:
                raise AssertionError(f"{name}: f64 kernel gradient {g64} against central "
                                     f"differences {fd}")
            extra = dict(f64_fd_cells=GRAD_REF_CELLS, f64_loss=v64, f64_kernel_grad=g64,
                         central_difference=fd, fd_rel_err=fd_rel, fd_rtol=5e-4)
            del sim64
        if name == "grad_n145_heat":  # the route JAX times: make_rollout_fn(remat=True)
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
                             bound_ms=b[0], bound_by=b[1], entry=entry, source=source,
                             **(group or {}))
        phase(name, cells=GRAD_CELLS, nz=BENCH_NZ, dt=dt, steps=GRAD_STEPS,
              inner_steps=GRAD_INNER, stepper=cfg["stepper"], solver=cfg["solver"],
              physics=cfg["physics"], seconds_median=med, seconds=times, launches=launches,
              cells_steps_per_s=GRAD_CELLS * GRAD_STEPS / med, loss=value,
              dloss_dparam=grad, param="k_mineral" if heat else "log_K_sat",
              vjp_segment_ms=k_ms, fwd_segment_ms=f_ms, plain_vjp_ms=p_ms,
              plain_cells=GRAD_SCHEME_CHUNK, bound_ms=b[0], bound_by=b[1],
              ops_per_column_step=scheme_vjp_ops(name, BENCH_NZ),
              ptxas=ptxas_all[source].get(entry, {}).get(
                  "vjp_" + cfg["solver"] if group and cfg["stepper"] == "implicit" else "vjp"),
              f64_cells=GRAD_COMPARE_CELLS, f64_nz=cfg["f64_nz"], f64_rtol=1e-9,
              f64_max_abs_err=f64_err, water_identity_rel_err=ident,
              f32_rel_tol=F32_VJP_REL_TOL, f32_max_abs_err=f32_err,
              f32_max_err_over_magnitude=f32_rel, card=card, **extra)
        del gsim, carry, table, cts

    # ---- the full steps, once their sources are built: the soil's
    # ForwardEuler and Heun, then ImplicitEuler's and the LandModel's
    built(*REST_GROUPS[3])
    # ---- one full step (make_fused_step): the kernel against the plain
    # version (the module step) on every leaf, float64 along the plain
    # trajectory and float32 at full width, each stepper and physics
    full64, stored_flips = {}, {}
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
        st_s = scrambled_stored(state, seed=30)
        errs, fl = check_full_step_f64(
            f"full step {stepper} f64, stored start", fused(st_s),
            fs.soil_column_full_step_plain(sim.model, sim.timestepper, sim.ctx, (), st_s,
                                           BENCH_DT), st_s, BENCH_DT)
        full64[f"{stepper}:stored_start"] = max(errs.values())
        stored_flips[stepper] = fl
        del st_s
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
          f64_stored_start_flip_columns=stored_flips,
          rel_tol=F32_REL_TOL, f32_max_abs_err=full32, loop_steps=FULL_STEPS,
          loop_launches=full_launches, loop_max_abs_err=loop_err,
          fused_call_ms_median=float(np.median(call_ms)), fused_call_ms=call_ms,
          kernel_ms_median=full_ms, kernel_ms=full_kernel_ms, plain_ms=full_plain_ms,
          bound_ms=full_b[0], bound_by=full_b[1],
          rollout_step_share_ms=ms / COMPARE_STEPS, card=card)
    del sim, state, ref, fused

    # ---- ImplicitEuler's and the LandModel's full steps
    imp_full = full_step_implicit_phase(tp, fs, cuda_build, reset_counts, launched, ptxas_all,
                                        card)
    land_full = land_full_step_phase(tp, fs, ls, cuda_build, land_inputs, reset_counts,
                                     launched, ptxas_all, card)

    # ---- a forcing streamed from the host through ChunkedForcingPipeline
    # (stream_soil, stream_land), then the probes (rows 4-6), once built
    for kind in STREAM:
        stream_phase(tp, fs, ls, kind, reset_counts, launched, card)
    built(*REST_GROUPS[4])
    probe_errs, probe_times = probes_phase()
    probe_entries = probes_main_path(card, probe_errs, probe_times, reset_counts, launched)

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
        "source": "terrarium_tpu_torch/csrc/soil_column_group_rollout.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:283",
        "launches": main_launches, "max_abs_err": max(cmp.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": fwd_b[0], "bound_by": fwd_b[1],
        "library_ms": None, **row1, "f64_max_abs_err": max(row1_f64.values()),
        "shape": f"{BENCH_CELLS} x {BENCH_NZ} f32, {COMPARE_STEPS} steps"}, {
        "name": "soil_column_heun_rollout", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/soil_column_group_rollout.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:283" + series_at,
        "launches": heun_launches, "max_abs_err": max(heun_cmp.values()),
        "ms": heun_ms, "plain_ms": heun_plain_ms, "bound_ms": heun_b[0],
        "bound_by": heun_b[1], "library_ms": None, **row1a,
        "f64_max_abs_err": max(row1a_f64.values()),
        "shape": f"{BENCH_CELLS} x {BENCH_NZ} f32, Heun, series, {COMPARE_STEPS} steps"}, {
        "name": "soil_column_heat_rollout", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/soil_column_rollout.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:283" + series_at,
        "launches": heat_launches, "max_abs_err": max(heat_cmp.values()),
        "ms": heat_ms, "plain_ms": heat_plain_ms, "bound_ms": heat_b[0],
        "bound_by": heat_b[1], "library_ms": None,
        "shape": f"{HEAT_CELLS} x {BENCH_NZ} f32, heat only, series, {COMPARE_STEPS} steps"}, {
        "name": "soil_column_implicit_rollout", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/soil_column_group_rollout.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:283 with terrarium_tpu/timesteppers/"
                    "implicit.py:173 (tridiag.py:109 PCR, :30 Thomas)",
        "launches": imp["pcr"]["launches"], "max_abs_err": max(imp["pcr"]["max_abs_err"].values()),
        "ms": imp["pcr"]["kernel_ms"], "plain_ms": imp["pcr"]["plain_ms"],
        "bound_ms": imp["pcr"]["bound_ms"], "bound_by": imp["pcr"]["bound_by"],
        "library_ms": None, **imp["pcr"]["group"],
        "shape": f"{BENCH_CELLS} x {BENCH_NZ} f32, ImplicitEuler dt {IMPLICIT_DT:g}, PCR, "
                 f"{COMPARE_STEPS} steps",
        "thomas": {k: imp["thomas"][k] for k in ("launches", "kernel_ms", "plain_ms",
                                                  "bound_ms", "bound_by", "group")}
        | {"max_abs_err": max(imp["thomas"]["max_abs_err"].values())}}, *({
        "name": f"{v['wrapper']}[{name}]", "route": "cuda",
        "source": f"terrarium_tpu_torch/csrc/{v['source']}.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:283 with " + {
            "heat_heun": "Heun (terrarium_tpu/timesteppers/stepping.py:167) over the heat-only "
                         "model" + series_at,
            "heat_implicit": "ImplicitEuler (terrarium_tpu/timesteppers/implicit.py:173, "
                             f"{v['solver']}) over the heat-only model" + series_at,
            "picard": f"ImplicitEuler (terrarium_tpu/timesteppers/implicit.py:173, "
                      f"{v['solver']}) with {PICARD_ITERS} Picard iterations (:234-254)"}[
            v["kind"]],
        "launches": v["launches"], "max_abs_err": v["max_abs_err"], "ms": v["ms"],
        "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
        "library_ms": None, **(v["group"] or {}),
        "shape": f"{BENCH_CELLS} x {BENCH_NZ} f32, {COMPARE_STEPS} steps, {v['entry']}"}
        for name, v in new_fwd.items()), {
        "name": "soil_column_segment_vjp", "route": "cuda",
        "source": f"terrarium_tpu_torch/csrc/{VJP_GROUP_SOURCE}.cu",
        "replaces": "terrarium_tpu/ops/fused_vjp.py:68",
        "launches": launches["soil_column_segment_vjp"],
        "max_abs_err": max(full_err.values()),
        "ms": seg_ms, "plain_ms": vjp_plain_ms, "bound_ms": vjp_b[0], "bound_by": vjp_b[1],
        "library_ms": None, **row3,
        "shape": f"{GRAD_CELLS} x {GRAD_NZ} f32, {GRAD_INNER} steps; plain_ms at "
                 f"{GRAD_COMPARE_CELLS} columns"}, *({
        "name": f"soil_column_segment_vjp[{name}]", "route": "cuda",
        "source": f"terrarium_tpu_torch/csrc/{sc['source']}.cu",
        "replaces": "terrarium_tpu/ops/fused_vjp.py:68",
        **{k: v for k, v in sc.items() if k not in ("entry", "source")}, "library_ms": None,
        "shape": f"{GRAD_CELLS} x {BENCH_NZ} f32, {GRAD_INNER} steps, {sc['entry']}; "
                 f"plain_ms at {GRAD_SCHEME_CHUNK} columns"} for name, sc in schemes.items()), *({
        "name": f"land_column_segment_vjp[{name}]", "route": "cuda",
        "source": f"terrarium_tpu_torch/csrc/{lg['source']}.cu",
        "replaces": "terrarium_tpu/ops/fused_vjp.py:68 traced over a LandModel step "
                    "(terrarium_tpu/models/land_model.py:55)"
                    + (" with a Snowpack (terrarium_tpu/processes/snow.py:69)" if lg["snow"]
                       else ""),
        **{k: v for k, v in lg.items() if k not in ("entry", "snow", "source")},
        "library_ms": None,
        "shape": f"{LAND_CELLS} x {LAND_NZ} f32, land_consistent"
                 + (" with snow" if lg["snow"] else "") + " with static inputs, dt "
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
        "source": f"terrarium_tpu_torch/csrc/{v['source']}.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:283 traced over a LandModel step with "
                    + ("Heun (terrarium_tpu/timesteppers/stepping.py:167)" if v["key"] == "heun"
                       else f"ImplicitEuler (terrarium_tpu/timesteppers/implicit.py:173, "
                            f"{v['solver']})")
                    + (f" with {v['iters']} Picard iterations (:234-254)" if v["iters"] != 1
                       else "")
                    + (" and a Snowpack (terrarium_tpu/processes/snow.py:69)"
                       if v["snow"] else ""),
        "launches": v["launches"], "max_abs_err": max(v["max_abs_err"].values()),
        "ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
        "bound_by": v["bound_by"], "library_ms": None, **(v["group"] or {}),
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
        "shape": f"{BENCH_CELLS} x {BENCH_NZ} f32, ForwardEuler, one full step"}, *({
        "name": f"soil_column_full_step[implicit_{vname}]", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/soil_column_full_step.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:152 with ImplicitEuler "
                    f"(terrarium_tpu/timesteppers/implicit.py:168, {v['solver']}"
                    + (f", {v['iters']} Picard iterations" if v["iters"] != 1 else "") + ")",
        **{k: v[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by")}, "library_ms": None, "fused_call_ms": v["call_ms"],
        "shape": f"{BENCH_CELLS} x {BENCH_NZ} f32, ImplicitEuler dt {IMPLICIT_DT:g}, one full "
                 f"step, {v['entry']}"} for vname, v in imp_full.items()), *({
        "name": f"land_column_full_step[{vname}]", "route": "cuda",
        "source": "terrarium_tpu_torch/csrc/land_column_full_step.cu",
        "replaces": "terrarium_tpu/ops/fused_step.py:152 traced over a LandModel step "
                    "(terrarium_tpu/models/land_model.py:55)"
                    + {"euler": "", "heun": " with Heun (terrarium_tpu/timesteppers/"
                                            "stepping.py:144)",
                       "implicit": f" with ImplicitEuler (terrarium_tpu/timesteppers/"
                                   f"implicit.py:168, {v['solver']}"
                                   + (f", {v['iters']} Picard iterations" if v["iters"] != 1
                                      else "") + ")"}[v["key"]]
                    + (" and a Snowpack (terrarium_tpu/processes/snow.py:69)" if v["snow"]
                       else ""),
        **{k: v[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by")}, "library_ms": None, "fused_call_ms": v["call_ms"],
        "shape": f"{LAND_CELLS} x {LAND_NZ} f32, land_consistent" + (" with snow" if v["snow"]
                                                                     else "")
                 + f", static inputs, dt {v['dt']:g}, one full step, {v['entry']}"}
        for vname, v in land_full.items()), *probe_entries]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def euler_digest(root: pathlib.Path):
    """SHA-256 of the ForwardEuler heat + Richards kernel's outputs (golden
    f64 Nz 20, 120 steps; bench f32 Nz 30, 144 steps at full width; gradient
    configuration f32 Nz 20, 48 steps at full width) and of the Heun
    kernel's (heun_forced f64 Nz 15, 96 steps; the Heun + series
    configuration f32 Nz 30, 144 steps at full width), the rollouts' ptxas
    lines (the group rollout's where the package has it) and the bench
    main-path rate, for the package under ``root``."""
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
    group = tuple(n for n in (GROUP_SOURCE, VJP_GROUP_SOURCE, LAND_VJP_GROUP_SOURCE,
                              LAND_GROUP_SOURCE) if n in cuda_build.INSTANTIATIONS)
    cuda_build.build(*group, "soil_column_rollout", "soil_column_segment_vjp",
                     "land_column_rollout", *(("land_column_segment_vjp",) if land_vjp else ()))
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
        digests[f"picard{PICARD_ITERS}_{solver}_f32_nz30"] = digest(
            fs.soil_column_implicit_rollout(*carry, table, *coords,
                                            fs.ColumnParams.of(sim.model, g.dtype),
                                            IMPLICIT_DT, solver=solver,
                                            picard_iters=PICARD_ITERS))
        del sim, carry, table
    gsim = grad_sim(tp, GRAD_CELLS, torch.float32)
    ops = vjp_operands(tp, fs, gsim, seed=11)
    digests["segment_vjp_f32_nz20"] = digest(
        fv.soil_column_segment_vjp(*ops[0], ops[1], *ops[2], ops[3], GRAD_DT, *ops[4]))
    del gsim, ops
    if hasattr(fv, "VJP_SCHEMES"):  # the segment VJP of the other schemes the package has
        for name, cfg in GRAD_SCHEMES.items():
            if (cfg["stepper"], cfg["physics"]) not in fv.VJP_SCHEMES or (
                    cfg.get("picard", 1) != 1 and not hasattr(fv, "vjp_tags")):
                continue
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
    import inspect

    picard = "picard_iters" in inspect.signature(ls.land_column_rollout_plain).parameters
    if hasattr(ls, "ROLLOUTS"):  # the land kernel's Heun, implicit and snow variants,
        # and its Picard iterations where the package has them
        for vname in (*LAND_VARIANTS, *(LAND_PICARD_VARIANTS if picard else ())):
            vsnow = land_variant_spec(vname)[2]
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
            if name in LAND_GRAD_PICARD and not picard:
                continue
            kw = {"picard_iters": LAND_GRAD_PICARD[name]} if name in LAND_GRAD_PICARD else {}
            gsim = land_grad_sim(tp, LAND_CELLS, torch.float32, name)
            ops = land_grad_operands(ls, land_inputs, gsim, seed=11)
            try:  # Heun and the snowpack where the package's land VJP has them
                lv.check_scheme(ops[4], key, solver, kw.get("picard_iters", 1))
            except ValueError:
                del gsim, ops
                continue
            gin, gK, gskm = lv.land_column_segment_vjp(*ops[:3], *ops[3], ops[4], dt, 0.0,
                                                       GRAD_INNER, ops[5], stepper=key,
                                                       solver=solver, **kw)
            digests[f"land_vjp_{name}_f32_nz20"] = digest([gin[k] for k in sorted(gin)]
                                                          + [gK, gskm])
            del gsim, ops, gin
    # the full-step kernels: the six ForwardEuler and Heun instantiations on
    # full_sim's operands, one step, every leaf; ImplicitEuler's and the
    # LandModel's where the package has them
    def state_digest(st):
        return digest([getattr(st, g)[k] for g in ("prognostic", "tendencies", "auxiliary")
                       for k in sorted(getattr(st, g))])

    for stepper, physics, dtype, cells, nz in (
            ("euler", "richards", torch.float32, BENCH_CELLS, BENCH_NZ),
            ("euler", "richards", torch.float64, FULL_F64_CELLS, 20),
            ("euler", "heat", torch.float32, BENCH_CELLS, BENCH_NZ),
            ("heun", "heat", torch.float32, BENCH_CELLS, BENCH_NZ),
            ("heun", "richards", torch.float64, FULL_F64_CELLS, 15),
            ("heun", "richards", torch.float32, BENCH_CELLS, BENCH_NZ)):
        sim = full_sim(tp, cells, nz, dtype, stepper, physics)
        out = fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources,
                                 dt=BENCH_DT)(sim.state)
        f = "f32" if dtype == torch.float32 else "f64"
        digests[f"full_step_{stepper}_{physics}_{f}_nz{nz}"] = state_digest(out)
        del sim, out
    for solver, iters in FULL_IMPLICIT_VARIANTS:
        sim = full_sim(tp, BENCH_CELLS, BENCH_NZ, torch.float32, "euler", "richards")
        ts = tp.ImplicitEuler(dt=IMPLICIT_DT, solver=solver, picard_iters=iters)
        try:
            fused = fs.make_fused_step(sim.model, ts, sim.ctx, (), dt=IMPLICIT_DT)
        except ValueError:  # a package without ImplicitEuler's full step
            break
        digests[f"full_step_implicit_{solver}_picard{iters}_f32_nz30"] = state_digest(
            fused(sim.state))
        del sim, fused
    if hasattr(ls, "land_column_full_step"):
        for vname in LAND_FULL_VARIANTS:
            sim = land_full_sim(tp, LAND_CELLS, torch.float32, vname)
            out = fs.make_fused_step(sim.model, sim.timestepper, sim.ctx, sim.input_sources,
                                     dt=LAND_FULL_VARIANTS[vname][3])(sim.state)
            digests[f"land_full_step_{vname}_f32_nz20"] = state_digest(out)
            del sim, out
    sim = bench_sim(tp)
    sim.run(steps=COMPARE_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(steps=BLOCK_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ptxas = [ln.strip() for n in (*group, "soil_column_rollout")
             for ln in cuda_build.ptxas_report(n).splitlines()
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
