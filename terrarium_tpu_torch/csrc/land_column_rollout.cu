// LandModel column rollout for Hopper (sm_90a): ForwardEuler, Heun or
// ImplicitEuler (Thomas or PCR solves, one Picard iteration or any number)
// over the coupled model (atmosphere, optional snowpack, surface energy balance,
// surface hydrology, PALADYN vegetation, the soil column).
//
// Replaces terrarium_tpu/ops/fused_step.py::make_fused_lean_rollout traced
// over a LandModel step of that stepper (kernel body :507, pallas_call :557;
// the TPU runs it in blocks of 640 cells with the XY leaves as (1, block)
// rows, a Mosaic layout device that has no counterpart here).
//
// One thread owns one column and runs `steps` applications of land::step,
// land::heun_step, land::implicit_step or land::picard_step
// (csrc/land_step.cuh) on it. The
// soil levels sit in fully unrolled per-thread register arrays (template
// NZ), the surface carry (pool, skin temperature, canopy water, carbon,
// vegetation fraction, net assimilation, SWE) in scalars; the carry is read
// once and written once per launch. The inputs are read each step at the
// clock time (Heun's stage also at t + dt): a uniform series from its two
// rows around the time (each thread reads its own, as the soil kernels do),
// a static value once. The clock advances by the same repeated addition as
// Clock.tick.
//
// What bounds it on this card: arithmetic, not HBM bytes. A column and step
// is some 2,500 operations at Nz 20 for ForwardEuler (the soil column, the
// Monin-Obukhov iterations of three drag evaluations with their logs and
// arctans, the vegetation's exps and powers; Heun twice that, ImplicitEuler
// that and two tridiagonal solves, picard_step that times its iterations)
// against two series reads; registers cap the occupancy, as in the soil
// kernels, and Heun's stage and the implicit rows hold several more column
// arrays (picard_step also the step's closed start, across its loop).
//
// Memory layout: fields are (NZ, cells) with k = 0 the bottom layer; element
// (k, col) is at k*cells + col. The ragged tail is masked with col < cells.
//
// Plain C interface, loaded with ctypes: one entry point per instantiation
// (SOIL_ENTRY, with SOIL_T, SOIL_NZ, LAND_VEG, LAND_RICHARDS, LAND_CURVE,
// LAND_COND, LAND_SNOW, SOIL_STEPPER, SOIL_SOLVER and SOIL_PICARD),
// returning cudaGetLastError().

#include <cuda_runtime.h>

#include "land_step.cuh"

namespace {

template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, bool SNOW,
          int STEPPER, int SOLVER, bool PICARD>
__global__ void __launch_bounds__(64) land_column_rollout_kernel(
    const LandCarry in, const LandCarry out, const LandInputs inputs,
    const T* __restrict__ root, const long long root_row_stride,
    const long long root_cell_stride, const T* __restrict__ dz_g,
    const T* __restrict__ dzf_g, const T* __restrict__ zc_g, const T* __restrict__ zf_g,
    const LandColumnParams<T> P, const int steps, const T time0, const T dt, const T inv_dt,
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

    const soil::Consts<T> sc(P.soil);
    land::rollout_column<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW, STEPPER, SOLVER, PICARD>(
        col, cells, in, out, inputs, root, root_row_stride, root_cell_stride, sc, P, dz, dzf,
        zc, zf, steps, time0, dt, inv_dt, iters, solver);
}

}  // namespace

// One entry point per instantiation, named SOIL_ENTRY
// (land_column_rollout_[heun_|implicit_<thomas|pcr|picard>_]<bare|veg>_<noflow|
// richards_<vg|bc>_<mualem|linear>>[_snow]_<f32|f64>_nz<NZ>). The build
// (ops/cuda_build.py) compiles each instantiation in its own nvcc with
// SOIL_ENTRY, SOIL_T, SOIL_NZ, LAND_VEG, LAND_RICHARDS and, with Richards
// flow, LAND_CURVE (0 Van Genuchten, 1 Brooks-Corey) and LAND_COND (0
// Mualem, 1 linear) defined; SOIL_STEPPER (0 ForwardEuler, the default, 1
// Heun, 2 ImplicitEuler), SOIL_SOLVER (0 Thomas, 1 PCR, 2 either, chosen at
// run time by the `solver` argument), SOIL_PICARD (1: picard_step with
// `picard` iterations) and LAND_SNOW (1 with a snowpack) where the tags ask
// for them. An entry returns cudaErrorInvalidValue for a solver code other
// than 0 and 1 or one it was not built for, a Picard count below 1, or one
// other than 1 without SOIL_PICARD.
#if !defined(SOIL_ENTRY) || !defined(SOIL_T) || !defined(SOIL_NZ) || !defined(LAND_VEG) || \
    !defined(LAND_RICHARDS)
#error "build with -DSOIL_ENTRY=<name> -DSOIL_T=float|double -DSOIL_NZ=<levels> -DLAND_VEG=0|1 -DLAND_RICHARDS=0|1 [-DLAND_CURVE=0|1 -DLAND_COND=0|1 -DLAND_SNOW=0|1 -DSOIL_STEPPER=0|1|2 -DSOIL_SOLVER=0|1|2 -DSOIL_PICARD=0|1]"
#endif
#ifndef LAND_CURVE
#define LAND_CURVE 0
#endif
#ifndef LAND_COND
#define LAND_COND 0
#endif
#ifndef LAND_SNOW
#define LAND_SNOW 0
#endif
#ifndef SOIL_STEPPER
#define SOIL_STEPPER 0
#endif
#ifndef SOIL_SOLVER
#define SOIL_SOLVER 0
#endif
#ifndef SOIL_PICARD
#define SOIL_PICARD 0
#endif

extern "C" int SOIL_ENTRY(const LandCarry* in, const LandCarry* out, const LandInputs* inputs,
                          const SOIL_T* root, long long root_row_stride,
                          long long root_cell_stride, const SOIL_T* dz, const SOIL_T* dzf,
                          const SOIL_T* zc, const SOIL_T* zf, const LandColumnParams<SOIL_T>* P,
                          int steps, double time0, double dt, long long cells, int solver,
                          int picard, void* stream)
{
    if (picard < 1 || (!SOIL_PICARD && picard != 1) || (solver != 0 && solver != 1)
        || (SOIL_STEPPER == 2 && SOIL_SOLVER != 2 && solver != SOIL_SOLVER))
        return (int)cudaErrorInvalidValue;
    const int threads = 64;
    const unsigned blocks = (unsigned)((cells + threads - 1) / threads);
    land_column_rollout_kernel<SOIL_T, SOIL_NZ, LAND_VEG != 0, LAND_RICHARDS != 0, LAND_CURVE,
                               LAND_COND, LAND_SNOW != 0, SOIL_STEPPER, SOIL_SOLVER,
                               SOIL_PICARD != 0>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(
            *in, *out, *inputs, root, root_row_stride, root_cell_stride, dz, dzf, zc, zf, *P,
            steps, SOIL_T(time0), SOIL_T(dt), SOIL_T(1.0 / dt), cells, picard, solver);
    return (int)cudaGetLastError();
}
