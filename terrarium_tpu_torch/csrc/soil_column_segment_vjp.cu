// Segment VJP of the soil column rollouts for Hopper (sm_90a).
//
// Replaces terrarium_tpu/ops/fused_vjp.py::make_segment_vjp (pallas_call at
// :344), which is generic over the stepper, for the steps of
// csrc/soil_column_rollout.cu: the vector-Jacobian product of `steps`
// closure-rotated steps of the heat + FreeWater + Richards SoilModel by
// ForwardEuler, Heun or ImplicitEuler (one Picard iteration, Thomas or PCR
// solves), or of the heat-only (NoFlow) SoilModel by ForwardEuler, with a
// Dirichlet top temperature. Given the segment's input carry (U, sat, S;
// heat only: U, and the saturation it reads) and the cotangents of its
// output carry, it returns the cotangents of the input carry and of the two
// differentiated parameters, K_sat (0 for the heat-only model) and
// sk_mineral = sqrt(k_mineral) times the mineral fraction. The clock is not
// differentiated: no time cotangent is returned (the JAX kernel replicates
// the scalar one per block, fused_vjp.py:328-341).
//
// One thread owns one column (soil::segment_vjp_column in soil_step.cuh):
// 1. forward: `steps` applications of the stepper's step (soil::step,
//    soil::heun_step, soil::implicit_step), the same code as the rollout
//    kernel, so its carries are the rollout's bit for bit; each step's input
//    carry (2*NZ + 1 values; NZ for heat only) goes to a global scratch
//    buffer laid out [step][row][cell], so a warp's loads and stores are
//    coalesced;
// 2. reverse sweep: for each step from the last, reload its carry, recompute
//    the step's intermediates and apply its hand-derived adjoint
//    (soil::step_adjoint, soil::heun_step_adjoint,
//    soil::implicit_step_adjoint), each built on soil::rhs_adjoint, the
//    adjoint of closure_rhs, in exact reverse order: surface pool, Darcy
//    flux with the upwind-min K, face K, heat flux, pressure head, energy
//    closure and centre K, then the down and up sweeps. Heun recomputes its
//    stage and takes rhs_adjoint at the stage and at x_n; ImplicitEuler
//    undoes each tridiagonal solve by one solve of the transposed rows with
//    the same solver (never differentiating the elimination), then the row
//    assembly, the chain factors and the terms' way into the closure. The
//    branch conventions are written above soil::min_adjoint.
// The parameter cotangents are summed per thread in the working type, then
// per block by a fixed-order tree in shared memory into per-block partials;
// a second kernel sums the partials in a fixed order, so a run is
// reproducible bit for bit (no float atomics).
//
// What bounds it on this card: arithmetic and local memory, not HBM. Per
// column and step the ForwardEuler reverse sweep does about three times a
// forward step's operations (the recompute, the pow/cbrt/sqrt derivatives,
// the adjoint; Heun about twice that, ImplicitEuler the Euler's plus three
// more solves and the rows' adjoints), with about 12*NZ live values a
// thread (the recomputed saturation, temperature, conductivity, centre K
// and head, the two running cotangents and the per-face cotangent arrays;
// ImplicitEuler also a system's rows): far past the 255 registers a thread
// may hold, so ptxas spills to local memory, which L1 and L2 cache. The
// scratch carries are written once and read once per step: at 56,951
// columns, Nz 20 and 48 steps in float32 that is 448 MB each way, a small
// share of the time against the arithmetic. The design keeps the simple one
// thread per column shape of the forward and accepts the spills; splitting
// a column over threads is a later optimisation.
//
// Plain C interface, loaded with ctypes: one entry point per instantiation
// (SOIL_ENTRY, with SOIL_T, SOIL_NZ, SOIL_STEPPER, SOIL_SOLVER and
// SOIL_HEAT), each returning cudaGetLastError() after the launches.

#include <cuda_runtime.h>

#include "soil_step.cuh"

namespace {

using soil::Consts;

constexpr int kThreads = 64;
constexpr int kReduceThreads = 256;

template <typename T, int NZ, int STEPPER, int SOLVER, bool HEAT, bool PICARD>
__global__ void __launch_bounds__(kThreads) soil_column_segment_vjp_kernel(
    const T* __restrict__ U_in, const T* __restrict__ sat_in, const T* __restrict__ S_in,
    const T* __restrict__ gU_out, const T* __restrict__ gsat_out,
    const T* __restrict__ gS_out, T* __restrict__ gU_in, T* __restrict__ gsat_in,
    T* __restrict__ gS_in, T* __restrict__ partials, T* __restrict__ scratch,
    const T* __restrict__ top_T, long long top_step_stride, long long top_cell_stride,
    const T* __restrict__ dz_g, const T* __restrict__ dzf_g,
    const T* __restrict__ zc_g, const T* __restrict__ zf_g,
    const SoilColumnParams P, const int steps, const T dt, const T inv_dt,
    const long long cells, const int iters, const int solver)
{
    __shared__ T dz[NZ], dzf[NZ + 1], zc[NZ], zf[NZ + 1];
    __shared__ T red[2][kThreads];
    for (int i = threadIdx.x; i < NZ + 1; i += blockDim.x) {
        if (i < NZ) { dz[i] = dz_g[i]; zc[i] = zc_g[i]; }
        dzf[i] = dzf_g[i];
        zf[i] = zf_g[i];
    }
    __syncthreads();
    const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;

    // every thread of the block takes part in the reduction below, so the
    // ragged tail is masked here rather than returned from
    T gKsat = T(0), gskm = T(0);
    if (col < cells) {
        const Consts<T> c(P);
        soil::segment_vjp_column<T, NZ, STEPPER, SOLVER, HEAT, PICARD>(
            col, cells, steps, U_in, sat_in, S_in, gU_out, gsat_out, gS_out, gU_in, gsat_in,
            gS_in, scratch, top_T, top_step_stride, top_cell_stride, c, P, dz, dzf, zc, zf, dt,
            inv_dt, gKsat, gskm, iters, solver);
    }

    red[0][threadIdx.x] = gKsat;
    red[1][threadIdx.x] = gskm;
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
        if (threadIdx.x < half) {
            red[0][threadIdx.x] += red[0][threadIdx.x + half];
            red[1][threadIdx.x] += red[1][threadIdx.x + half];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = red[0][0];
        partials[gridDim.x + blockIdx.x] = red[1][0];
    }
}

// out[j] = sum over blocks of partials[j * n + b], j = 0, 1, in a fixed
// order: each thread sums a strided slice, then a tree in shared memory
template <typename T>
__global__ void __launch_bounds__(kReduceThreads) soil_column_segment_vjp_reduce_kernel(
    const T* __restrict__ partials, const int n, T* __restrict__ out)
{
    __shared__ T red[kReduceThreads];
    for (int j = 0; j < 2; ++j) {
        T acc = T(0);
        for (int b = threadIdx.x; b < n; b += kReduceThreads) acc += partials[j * n + b];
        red[threadIdx.x] = acc;
        __syncthreads();
        for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
            if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
            __syncthreads();
        }
        if (threadIdx.x == 0) out[j] = red[0];
        __syncthreads();
    }
}

template <typename T, int NZ, int STEPPER, int SOLVER, bool HEAT, bool PICARD>
int launch(const T* U_in, const T* sat_in, const T* S_in, const T* gU_out, const T* gsat_out,
           const T* gS_out, T* gU_in, T* gsat_in, T* gS_in, T* partials, T* gparams,
           T* scratch, const T* top_T, long long top_step_stride, long long top_cell_stride,
           const T* dz, const T* dzf, const T* zc, const T* zf, const SoilColumnParams* P,
           int steps, double dt, long long cells, int iters, int solver,
           cudaStream_t stream)
{
    const int blocks = (int)((cells + kThreads - 1) / kThreads);
    soil_column_segment_vjp_kernel<T, NZ, STEPPER, SOLVER, HEAT, PICARD>
        <<<blocks, kThreads, 0, stream>>>(
            U_in, sat_in, S_in, gU_out, gsat_out, gS_out, gU_in, gsat_in, gS_in, partials,
            scratch, top_T, top_step_stride, top_cell_stride, dz, dzf, zc, zf, *P, steps, T(dt),
            T(1.0 / dt), cells, iters, solver);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    soil_column_segment_vjp_reduce_kernel<T><<<1, kReduceThreads, 0, stream>>>(
        partials, blocks, gparams);
    return (int)cudaGetLastError();
}

}  // namespace

// One entry point per instantiation, named SOIL_ENTRY
// (soil_column_segment_vjp_<f32|f64>_nz<NZ> for ForwardEuler over heat +
// Richards, soil_column_segment_vjp_<heun_richards|heun_heat|implicit_
// <thomas|pcr>_richards|euler_heat>_<f32|f64>_nz<NZ> and, for picard_step,
// soil_column_segment_vjp_implicit_picard_<richards|heat>_<f32|f64>_nz<NZ>
// for the others). The build (ops/cuda_build.py) compiles each
// instantiation in its own nvcc, in parallel, with SOIL_ENTRY, SOIL_T,
// SOIL_NZ and the tags' SOIL_STEPPER (0 ForwardEuler, the default, 1 Heun, 2
// ImplicitEuler), SOIL_SOLVER (0 Thomas, 1 PCR, 2 either, chosen at run time
// by the `solver` argument), SOIL_HEAT (0, the default, or 1) and
// SOIL_PICARD (1: picard_step with `picard` iterations) defined. The
// heat-only entries read no surface pool: S_in, gS_out and gS_in may be
// null. An entry returns cudaErrorInvalidValue for a solver code other than
// 0 and 1 or one it was not built for, a Picard count below 1, or one other
// than 1 without SOIL_PICARD.
#if !defined(SOIL_ENTRY) || !defined(SOIL_T) || !defined(SOIL_NZ)
#error "build with -DSOIL_ENTRY=<name> -DSOIL_T=float|double -DSOIL_NZ=<levels> [-DSOIL_STEPPER=0|1|2 -DSOIL_SOLVER=0|1|2 -DSOIL_HEAT=0|1 -DSOIL_PICARD=0|1]"
#endif
#ifndef SOIL_STEPPER
#define SOIL_STEPPER 0
#endif
#ifndef SOIL_SOLVER
#define SOIL_SOLVER 0
#endif
#ifndef SOIL_HEAT
#define SOIL_HEAT 0
#endif
#ifndef SOIL_PICARD
#define SOIL_PICARD 0
#endif

extern "C" int SOIL_ENTRY(const SOIL_T* U_in, const SOIL_T* sat_in, const SOIL_T* S_in,
                          const SOIL_T* gU_out, const SOIL_T* gsat_out, const SOIL_T* gS_out,
                          SOIL_T* gU_in, SOIL_T* gsat_in, SOIL_T* gS_in, SOIL_T* partials,
                          SOIL_T* gparams, SOIL_T* scratch, const SOIL_T* top_T,
                          long long top_step_stride, long long top_cell_stride,
                          const SOIL_T* dz, const SOIL_T* dzf, const SOIL_T* zc,
                          const SOIL_T* zf, const SoilColumnParams* P, int steps, double dt,
                          long long cells, int solver, int picard, void* stream)
{
    if (picard < 1 || (!SOIL_PICARD && picard != 1) || (solver != 0 && solver != 1)
        || (SOIL_STEPPER == 2 && SOIL_SOLVER != 2 && solver != SOIL_SOLVER))
        return (int)cudaErrorInvalidValue;
    return launch<SOIL_T, SOIL_NZ, SOIL_STEPPER, SOIL_SOLVER, SOIL_HEAT != 0, SOIL_PICARD != 0>(
        U_in, sat_in, S_in, gU_out, gsat_out, gS_out, gU_in, gsat_in, gS_in, partials, gparams,
        scratch, top_T, top_step_stride, top_cell_stride, dz, dzf, zc, zf, P, steps, dt, cells,
        picard, solver, (cudaStream_t)stream);
}
