// Segment VJP of the soil heat + Richards column rollout for Hopper (sm_90a).
//
// Replaces terrarium_tpu/ops/fused_vjp.py::make_segment_vjp (pallas_call at
// :344) for the main-path step of csrc/soil_column_rollout.cu: the
// vector-Jacobian product of `steps` closure-rotated ForwardEuler steps of
// the heat + FreeWater + Richards SoilModel with a Dirichlet top temperature.
// Given the segment's input carry (U, sat, S) and the cotangents of its
// output carry, it returns the cotangents of the input carry and of the two
// differentiated parameters, K_sat and sk_mineral = sqrt(k_mineral) times the
// mineral fraction. The clock is not differentiated: no time cotangent is
// returned (the JAX kernel replicates the scalar one per block,
// fused_vjp.py:328-341).
//
// One thread owns one column (soil::segment_vjp_column in soil_step.cuh):
// 1. forward: `steps` applications of soil::step, the same code as the
//    rollout kernel, so its carries are the rollout's bit for bit; each
//    step's input carry (2*NZ + 1 values) goes to a global scratch buffer
//    laid out [step][row][cell], so a warp's loads and stores are coalesced;
// 2. reverse sweep: for each step from the last, reload its carry, recompute
//    the step's intermediates (sweep predicates, liquid fraction, heat
//    capacity, temperature, conductivities, pressure head, upwind choice)
//    and apply the hand-derived adjoint (soil::step_adjoint) in exact
//    reverse order: surface pool, water update and Darcy flux with the
//    upwind-min K, face K, heat update and flux, pressure head, energy
//    closure and centre K, then the down and up sweeps. The branch
//    conventions are written above soil::min_adjoint.
// The parameter cotangents are summed per thread in the working type, then
// per block by a fixed-order tree in shared memory into per-block partials;
// a second kernel sums the partials in a fixed order, so a run is
// reproducible bit for bit (no float atomics).
//
// What bounds it on this card: arithmetic and local memory, not HBM. Per
// column and step the reverse sweep does about three times a forward step's
// operations (the recompute, the pow/cbrt/sqrt derivatives, the adjoint),
// with about 12*NZ live values a thread (the recomputed saturation,
// temperature, conductivity, centre K and head, the two running cotangents
// and the per-face cotangent arrays): far past the 255 registers a thread
// may hold, so ptxas spills to local memory, which L1 and L2 cache. The
// scratch carries are written once and read once per step: at 56,951
// columns, Nz 20 and 48 steps in float32 that is 448 MB each way, a small
// share of the time against the arithmetic. The design keeps the simple one
// thread per column shape of the forward and accepts the spills; splitting
// a column over threads is a later optimisation.
//
// Plain C interface, loaded with ctypes: one entry point per type and NZ,
// each returning cudaGetLastError() after the launches.

#include <cuda_runtime.h>

#include "soil_step.cuh"

namespace {

using soil::Consts;

constexpr int kThreads = 64;
constexpr int kReduceThreads = 256;

template <typename T, int NZ>
__global__ void __launch_bounds__(kThreads) soil_column_segment_vjp_kernel(
    const T* __restrict__ U_in, const T* __restrict__ sat_in, const T* __restrict__ S_in,
    const T* __restrict__ gU_out, const T* __restrict__ gsat_out,
    const T* __restrict__ gS_out, T* __restrict__ gU_in, T* __restrict__ gsat_in,
    T* __restrict__ gS_in, T* __restrict__ partials, T* __restrict__ scratch,
    const T* __restrict__ top_T, long long top_step_stride, long long top_cell_stride,
    const T* __restrict__ dz_g, const T* __restrict__ dzf_g,
    const T* __restrict__ zc_g, const T* __restrict__ zf_g,
    const SoilColumnParams P, const int steps, const T dt, const long long cells)
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
        soil::segment_vjp_column<T, NZ>(col, cells, steps, U_in, sat_in, S_in, gU_out,
                                        gsat_out, gS_out, gU_in, gsat_in, gS_in, scratch,
                                        top_T, top_step_stride, top_cell_stride, c, P,
                                        dz, dzf, zc, zf, dt, gKsat, gskm);
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

template <typename T, int NZ>
int launch(const T* U_in, const T* sat_in, const T* S_in, const T* gU_out, const T* gsat_out,
           const T* gS_out, T* gU_in, T* gsat_in, T* gS_in, T* partials, T* gparams,
           T* scratch, const T* top_T, long long top_step_stride, long long top_cell_stride,
           const T* dz, const T* dzf, const T* zc, const T* zf, const SoilColumnParams* P,
           int steps, double dt, long long cells, cudaStream_t stream)
{
    const int blocks = (int)((cells + kThreads - 1) / kThreads);
    soil_column_segment_vjp_kernel<T, NZ><<<blocks, kThreads, 0, stream>>>(
        U_in, sat_in, S_in, gU_out, gsat_out, gS_out, gU_in, gsat_in, gS_in, partials,
        scratch, top_T, top_step_stride, top_cell_stride, dz, dzf, zc, zf, *P, steps, T(dt),
        cells);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    soil_column_segment_vjp_reduce_kernel<T><<<1, kReduceThreads, 0, stream>>>(
        partials, blocks, gparams);
    return (int)cudaGetLastError();
}

}  // namespace

// One entry point per instantiation, soil_column_segment_vjp_<f32|f64>_nz<NZ>.
// The build (ops/cuda_build.py) compiles each instantiation in its own nvcc,
// in parallel, with SOIL_SUFFIX, SOIL_T and SOIL_NZ defined.
#if !defined(SOIL_SUFFIX) || !defined(SOIL_T) || !defined(SOIL_NZ)
#error "build with -DSOIL_SUFFIX=f32|f64 -DSOIL_T=float|double -DSOIL_NZ=<levels>"
#endif
#define SOIL_VJP_ENTRY(SUFFIX, T, NZ)                                                      \
    extern "C" int soil_column_segment_vjp_##SUFFIX##_nz##NZ(                              \
        const T* U_in, const T* sat_in, const T* S_in, const T* gU_out, const T* gsat_out, \
        const T* gS_out, T* gU_in, T* gsat_in, T* gS_in, T* partials, T* gparams,          \
        T* scratch, const T* top_T, long long top_step_stride, long long top_cell_stride,  \
        const T* dz, const T* dzf, const T* zc, const T* zf, const SoilColumnParams* P,    \
        int steps, double dt, long long cells, void* stream)                               \
    {                                                                                      \
        return launch<T, NZ>(U_in, sat_in, S_in, gU_out, gsat_out, gS_out, gU_in, gsat_in, \
                             gS_in, partials, gparams, scratch, top_T, top_step_stride,    \
                             top_cell_stride, dz, dzf, zc, zf, P, steps, dt, cells,        \
                             (cudaStream_t)stream);                                        \
    }
#define SOIL_VJP_ENTRY_OF(SUFFIX, T, NZ) SOIL_VJP_ENTRY(SUFFIX, T, NZ)

SOIL_VJP_ENTRY_OF(SOIL_SUFFIX, SOIL_T, SOIL_NZ)
