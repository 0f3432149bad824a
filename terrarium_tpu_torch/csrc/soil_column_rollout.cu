// Soil column rollouts for Hopper (sm_90a): ForwardEuler or Heun, heat +
// Richards flow or heat only; ImplicitEuler with Thomas or PCR, heat +
// Richards flow.
//
// Replaces terrarium_tpu/ops/fused_step.py::make_fused_lean_rollout for
// SoilModel with two-phase heat conduction and the free-water freeze curve,
// either with Richards flow over (ConstantSoilHydraulics or
// SoilHydraulicsSURFEX of) VanGenuchten and UnsatKVanGenuchten, or heat only
// (NoFlow: the saturation is read and never written), stepped by
// ForwardEuler or Heun, or, with Richards flow, by ImplicitEuler (one Picard
// iteration; implicit.py:173, with its tridiagonal solves tridiag.py:30 and
// :109 traced into the same Pallas kernel), with a Dirichlet top
// temperature. The top
// temperature is a table, one row per clock time (HEUN: n + 1 rows), or a
// uniformly spaced series interpolated here at each clock time (the
// counterpart of _WindowSource, fused_step.py:92, which reads a (W, block)
// window with one-hot row masks because Mosaic has no gather; a thread
// here reads the two rows it needs).
//
// One thread owns one column and runs `steps` applications of the step on
// it (soil::rollout_column, soil::step, soil::heun_step and
// soil::implicit_step in soil_step.cuh). The live carry (internal energy, and for Richards the
// saturation and the surface pool) is read once and written once per
// launch; the heat-only saturation is read once; everything else lives in
// registers for the whole launch. The clock advances by the same repeated
// addition as Clock.tick.
//
// What bounds it on this card: arithmetic (FP32 or FP64 ALU, with a pow,
// a cube root and four square roots per level and stage for Richards) and
// registers, not HBM bytes: the carry is 61 values per column, read and
// written once per launch, against thousands of operations per column and
// step; a series adds two reads per column and stage. The column is kept in
// fully unrolled per-thread register arrays (template NZ, unrolled z-loops),
// so the two sweeps, the face stencils and the tridiagonal solves are
// register-to-register recurrences with constant indices. ForwardEuler
// holds about 3*NZ values live (energy, saturation, centre conductivity);
// Heun about 7*NZ (the carry, its tendencies, the stage and the
// conductivities) and spills at NZ 30; ImplicitEuler about 7*NZ (the carry,
// both right-hand sides, the heat and Darcy terms, then one system's rows
// and, for Thomas, c'; PCR also holds a round's new rows), the two systems
// solved one after the other; the grid coordinates sit in shared memory.
//
// Memory layout: fields are (NZ, cells) with k = 0 the bottom layer; element
// (k, col) is at k*cells + col, so neighbouring threads touch neighbouring
// addresses. The ragged tail is masked with col < cells.
//
// Plain C interface, loaded with ctypes: one entry point per instantiation
// (SOIL_ENTRY, with SOIL_T, SOIL_NZ, SOIL_STEPPER, SOIL_SOLVER and
// SOIL_HEAT), each launching the table or the series kernel and returning
// cudaGetLastError().

#include <cuda_runtime.h>

#include "soil_step.cuh"

namespace {

using soil::Consts;

template <typename T, int NZ, int STEPPER, int SOLVER, bool HEAT, bool PICARD, bool SERIES>
__global__ void __launch_bounds__(64) soil_column_rollout_kernel(
    const T* __restrict__ U_in, const T* __restrict__ sat_in, const T* __restrict__ S_in,
    T* __restrict__ U_out, T* __restrict__ sat_out, T* __restrict__ S_out,
    const T* __restrict__ top_T, long long top_step_stride, long long top_cell_stride,
    const int series_rows, const T series_t0, const T series_dts, const T time0,
    const T* __restrict__ dz_g, const T* __restrict__ dzf_g,
    const T* __restrict__ zc_g, const T* __restrict__ zf_g,
    const SoilColumnParams P, const int steps, const T dt, const T inv_dt,
    const long long cells, const int iters, const int solver)
{
    __shared__ T dz[NZ], dzf[NZ + 1], zc[NZ], zf[NZ + 1];
    for (int i = threadIdx.x; i < NZ + 1; i += blockDim.x) {
        if (i < NZ) { dz[i] = dz_g[i]; zc[i] = zc_g[i]; }
        dzf[i] = dzf_g[i];
        zf[i] = zf_g[i];
    }
    __syncthreads();
    const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= cells) return;

    const Consts<T> c(P);
    T U[NZ], sat[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        U[k] = U_in[k * cells + col];
        sat[k] = sat_in[k * cells + col];
    }
    T S = HEAT ? T(0) : S_in[col];

    soil::rollout_column<T, NZ, STEPPER, SOLVER, HEAT, SERIES, PICARD>(
        U, sat, S, top_T + col * top_cell_stride, top_step_stride, series_rows, series_t0,
        series_dts, time0, steps, c, P, dz, dzf, zc, zf, dt, inv_dt, iters, solver);

#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        U_out[k * cells + col] = U[k];
        if (!HEAT) sat_out[k * cells + col] = sat[k];
    }
    if (!HEAT) S_out[col] = S;
}

template <typename T, int NZ, int STEPPER, int SOLVER, bool HEAT, bool PICARD>
int launch(const T* U_in, const T* sat_in, const T* S_in, T* U_out, T* sat_out, T* S_out,
           const T* top_T, long long top_step_stride, long long top_cell_stride,
           int series_rows, double series_t0, double series_dts, double time0,
           const T* dz, const T* dzf, const T* zc, const T* zf,
           const SoilColumnParams* P, int steps, double dt, long long cells, int iters,
           int solver, cudaStream_t stream)
{
    const int threads = 64;
    const unsigned blocks = (unsigned)((cells + threads - 1) / threads);
    if (series_rows > 0) {
        soil_column_rollout_kernel<T, NZ, STEPPER, SOLVER, HEAT, PICARD, true>
            <<<blocks, threads, 0, stream>>>(
                U_in, sat_in, S_in, U_out, sat_out, S_out, top_T, top_step_stride,
                top_cell_stride, series_rows, T(series_t0), T(series_dts), T(time0), dz, dzf,
                zc, zf, *P, steps, T(dt), T(1.0 / dt), cells, iters, solver);
    } else {
        soil_column_rollout_kernel<T, NZ, STEPPER, SOLVER, HEAT, PICARD, false>
            <<<blocks, threads, 0, stream>>>(
                U_in, sat_in, S_in, U_out, sat_out, S_out, top_T, top_step_stride,
                top_cell_stride, 0, T(0), T(0), T(time0), dz, dzf, zc, zf, *P, steps, T(dt),
                T(1.0 / dt), cells, iters, solver);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// One entry point per instantiation, named SOIL_ENTRY
// (soil_column_rollout_<euler|heun>_<richards|heat>_<f32|f64>_nz<NZ>,
// soil_column_rollout_implicit_<thomas|pcr>_richards_<f32|f64>_nz<NZ>, and
// soil_column_rollout_implicit_picard_<richards|heat>_<f32|f64>_nz<NZ> for
// picard_step). The build (ops/cuda_build.py) compiles each instantiation
// in its own nvcc, in parallel, with SOIL_ENTRY, SOIL_T, SOIL_NZ,
// SOIL_STEPPER (0 ForwardEuler, 1 Heun, 2 ImplicitEuler), SOIL_HEAT and, for
// ImplicitEuler, SOIL_SOLVER (0 Thomas, 1 PCR, 2 either, chosen at run time
// by the `solver` argument) and SOIL_PICARD (1: picard_step with `picard`
// iterations) defined. An entry returns cudaErrorInvalidValue for a solver
// code other than 0 and 1 or one it was not built for, a Picard count below
// 1, or one other than 1 without SOIL_PICARD.
#if !defined(SOIL_ENTRY) || !defined(SOIL_T) || !defined(SOIL_NZ) || \
    !defined(SOIL_STEPPER) || !defined(SOIL_HEAT)
#error "build with -DSOIL_ENTRY=<name> -DSOIL_T=float|double -DSOIL_NZ=<levels> -DSOIL_STEPPER=0|1|2 -DSOIL_HEAT=0|1 [-DSOIL_SOLVER=0|1|2 -DSOIL_PICARD=0|1]"
#endif
#ifndef SOIL_SOLVER
#define SOIL_SOLVER 0
#endif
#ifndef SOIL_PICARD
#define SOIL_PICARD 0
#endif

extern "C" int SOIL_ENTRY(const SOIL_T* U_in, const SOIL_T* sat_in, const SOIL_T* S_in,
                          SOIL_T* U_out, SOIL_T* sat_out, SOIL_T* S_out, const SOIL_T* top_T,
                          long long top_step_stride, long long top_cell_stride, int series_rows,
                          double series_t0, double series_dts, double time0, const SOIL_T* dz,
                          const SOIL_T* dzf, const SOIL_T* zc, const SOIL_T* zf,
                          const SoilColumnParams* P, int steps, double dt, long long cells,
                          int solver, int picard, void* stream)
{
    if (picard < 1 || (!SOIL_PICARD && picard != 1) || (solver != 0 && solver != 1)
        || (SOIL_STEPPER == 2 && SOIL_SOLVER != 2 && solver != SOIL_SOLVER))
        return (int)cudaErrorInvalidValue;
    return launch<SOIL_T, SOIL_NZ, SOIL_STEPPER, SOIL_SOLVER, SOIL_HEAT != 0, SOIL_PICARD != 0>(
        U_in, sat_in, S_in, U_out, sat_out, S_out, top_T, top_step_stride, top_cell_stride,
        series_rows, series_t0, series_dts, time0, dz, dzf, zc, zf, P, steps, dt, cells, picard,
        solver, (cudaStream_t)stream);
}
