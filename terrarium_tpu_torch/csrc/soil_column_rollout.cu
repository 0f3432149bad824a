// Soil heat + Richards column rollout for Hopper (sm_90a).
//
// Replaces terrarium_tpu/ops/fused_step.py::make_fused_lean_rollout for its
// main-path specialisation: SoilModel with two-phase heat conduction and the
// free-water freeze curve, Richards flow with
// ConstantSoilHydraulics(VanGenuchten, UnsatKVanGenuchten), ForwardEuler, a
// Dirichlet top temperature, no input sources.
//
// One thread owns one column and runs `steps` applications of
// ForwardEuler.pre_closure_step on it (soil::step in soil_step.cuh): closure
// (saturation adjustment, water table, pressure head, energy -> temperature),
// centre and face hydraulic conductivity, heat and Darcy fluxes, explicit
// update. The live carry (internal energy, saturation, surface pool) is read
// once and written once per launch; everything else lives in registers for
// the whole launch.
//
// What bounds it on this card: arithmetic (FP32 or FP64 ALU, with a pow,
// a cube root and four square roots per level and step) and registers, not
// HBM bytes: the carry is 61 values per column, read and written once per
// launch, against thousands of operations per column and step. The column
// is kept in fully unrolled per-thread register arrays (template NZ, unrolled
// z-loops), so the two sweeps and the face stencils are register-to-register
// recurrences with constant indices. About 3*NZ values are live per thread
// (energy, saturation, centre conductivity) plus temporaries; the grid
// coordinates sit in shared memory.
//
// Memory layout: fields are (NZ, cells) with k = 0 the bottom layer; element
// (k, col) is at k*cells + col, so neighbouring threads touch neighbouring
// addresses. The ragged tail is masked with col < cells.
//
// Plain C interface, loaded with ctypes: one entry point per type and NZ,
// each returning cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "soil_step.cuh"

namespace {

using soil::Consts;

template <typename T, int NZ>
__global__ void __launch_bounds__(64) soil_column_rollout_kernel(
    const T* __restrict__ U_in, const T* __restrict__ sat_in, const T* __restrict__ S_in,
    T* __restrict__ U_out, T* __restrict__ sat_out, T* __restrict__ S_out,
    const T* __restrict__ top_T, long long top_step_stride, long long top_cell_stride,
    const T* __restrict__ dz_g, const T* __restrict__ dzf_g,
    const T* __restrict__ zc_g, const T* __restrict__ zf_g,
    const SoilColumnParams P, const int steps, const T dt, const long long cells)
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
    T S = S_in[col];

    for (int s = 0; s < steps; ++s) {
        const T vtop = top_T[s * top_step_stride + col * top_cell_stride];
        soil::step<T, NZ>(U, sat, S, vtop, c, P, dz, dzf, zc, zf, dt);
    }

#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        U_out[k * cells + col] = U[k];
        sat_out[k * cells + col] = sat[k];
    }
    S_out[col] = S;
}

template <typename T, int NZ>
int launch(const T* U_in, const T* sat_in, const T* S_in, T* U_out, T* sat_out, T* S_out,
           const T* top_T, long long top_step_stride, long long top_cell_stride,
           const T* dz, const T* dzf, const T* zc, const T* zf,
           const SoilColumnParams* P, int steps, double dt, long long cells,
           cudaStream_t stream)
{
    const int threads = 64;
    const unsigned blocks = (unsigned)((cells + threads - 1) / threads);
    soil_column_rollout_kernel<T, NZ><<<blocks, threads, 0, stream>>>(
        U_in, sat_in, S_in, U_out, sat_out, S_out, top_T, top_step_stride,
        top_cell_stride, dz, dzf, zc, zf, *P, steps, T(dt), cells);
    return (int)cudaGetLastError();
}

}  // namespace

// One entry point per instantiation, soil_column_rollout_<f32|f64>_nz<NZ>.
// The build (ops/cuda_build.py) compiles each instantiation in its own nvcc,
// in parallel, with SOIL_SUFFIX, SOIL_T and SOIL_NZ defined.
#if !defined(SOIL_SUFFIX) || !defined(SOIL_T) || !defined(SOIL_NZ)
#error "build with -DSOIL_SUFFIX=f32|f64 -DSOIL_T=float|double -DSOIL_NZ=<levels>"
#endif
#define SOIL_ROLLOUT_ENTRY(SUFFIX, T, NZ)                                                  \
    extern "C" int soil_column_rollout_##SUFFIX##_nz##NZ(                                  \
        const T* U_in, const T* sat_in, const T* S_in, T* U_out, T* sat_out, T* S_out,     \
        const T* top_T, long long top_step_stride, long long top_cell_stride, const T* dz, \
        const T* dzf, const T* zc, const T* zf, const SoilColumnParams* P, int steps,      \
        double dt, long long cells, void* stream)                                          \
    {                                                                                      \
        return launch<T, NZ>(U_in, sat_in, S_in, U_out, sat_out, S_out, top_T,             \
                             top_step_stride, top_cell_stride, dz, dzf, zc, zf, P, steps,  \
                             dt, cells, (cudaStream_t)stream);                             \
    }
#define SOIL_ROLLOUT_ENTRY_OF(SUFFIX, T, NZ) SOIL_ROLLOUT_ENTRY(SUFFIX, T, NZ)

SOIL_ROLLOUT_ENTRY_OF(SOIL_SUFFIX, SOIL_T, SOIL_NZ)
