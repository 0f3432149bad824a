// One full soil step of every column for Hopper (sm_90a): ForwardEuler or
// Heun, heat + Richards flow or heat only, every leaf of the state in and
// out.
//
// Replaces terrarium_tpu/ops/fused_step.py::make_fused_step (pallas_call
// :259), which traces one timestepper.step into a Pallas kernel over blocks
// of columns and writes the whole state back: prognostics, tendencies and
// auxiliaries. The column code is soil::full_step_column
// (soil_full_step.cuh): update_state from the stored closure variables, the
// explicit update (Heun: its stage through soil_step.cuh's closure_rhs), the
// trailing closure.
//
// One thread owns one column, its levels in fully unrolled per-thread
// arrays (template NZ), as in the rollout kernels; the grid coordinates sit
// in shared memory. What bounds it on this card: bytes, unlike the
// rollouts. A launch is one step, so it reads the column's state (U, sat, T,
// liq, psi, S: 5 NZ + 1 values, and the two top temperatures) and writes
// all of it (U, sat, dU, dsat, T, liq, psi: 7 NZ values, K_face NZ + 1, S,
// dS, the ground temperature and the water table), about 13 NZ values a
// column against one step of arithmetic (~200 operations a level, Heun
// twice that). Neighbouring threads touch neighbouring addresses in every
// field ((NZ, cells) layout, element (k, col) at k * cells + col), so each
// access is coalesced; stores go out as each value is formed, so no field
// but the carry (U, sat and the conductivities; Heun also f_n and the
// stage) is held across the column.
//
// Plain C interface, loaded with ctypes: one entry point per instantiation
// (SOIL_ENTRY, with SOIL_T, SOIL_NZ, SOIL_STEPPER 0 ForwardEuler or 1 Heun
// and SOIL_HEAT), returning cudaGetLastError().

#include <cuda_runtime.h>

#include "soil_full_step.cuh"

namespace {

template <typename T, int NZ, bool HEUN, bool HEAT>
__global__ void __launch_bounds__(64) soil_column_full_step_kernel(
    const SoilFullStepIO io, const T* __restrict__ dz_g, const T* __restrict__ dzf_g,
    const T* __restrict__ zc_g, const T* __restrict__ zf_g, const SoilColumnParams P,
    const T dt, const long long cells)
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
    const soil::Consts<T> c(P);
    soil::full_step_column<T, NZ, HEUN, HEAT>(io, col, cells, c, P, dz, dzf, zc, zf, dt);
}

}  // namespace

#if !defined(SOIL_ENTRY) || !defined(SOIL_T) || !defined(SOIL_NZ) || \
    !defined(SOIL_STEPPER) || !defined(SOIL_HEAT)
#error "build with -DSOIL_ENTRY=<name> -DSOIL_T=float|double -DSOIL_NZ=<levels> -DSOIL_STEPPER=0|1 -DSOIL_HEAT=0|1"
#endif

extern "C" int SOIL_ENTRY(const SoilFullStepIO* io, const SOIL_T* dz, const SOIL_T* dzf,
                          const SOIL_T* zc, const SOIL_T* zf, const SoilColumnParams* P,
                          double dt, long long cells, void* stream)
{
    const int threads = 64;
    const unsigned blocks = (unsigned)((cells + threads - 1) / threads);
    soil_column_full_step_kernel<SOIL_T, SOIL_NZ, SOIL_STEPPER == 1, SOIL_HEAT != 0>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(*io, dz, dzf, zc, zf, *P, SOIL_T(dt),
                                                       cells);
    return (int)cudaGetLastError();
}
