// One full LandModel step of every column for Hopper (sm_90a): ForwardEuler,
// Heun or ImplicitEuler (Thomas or PCR, any number of Picard iterations)
// over the coupled model (atmosphere, optional snowpack, surface energy
// balance, surface hydrology, PALADYN vegetation, the soil column) with
// static inputs, every leaf of the state in and out.
//
// Replaces terrarium_tpu/ops/fused_step.py::make_fused_step (pallas_call
// :259) traced over a LandModel step, which writes the whole state back:
// prognostics, tendencies and auxiliaries. The column code is
// land::full_step_column (land_full_step.cuh): update_state from the stored
// closure variables, ground temperature and net assimilation, the stepper
// (Heun's stage and the further Picard iterations through land_step.cuh's
// closure_rhs), the snowpack's clip, the trailing closure.
//
// One thread owns one column, its levels in fully unrolled per-thread
// arrays (template NZ), as in the land rollout; the grid coordinates sit in
// shared memory. A launch is one step, so it reads the state (U, sat, T,
// liq, psi: 5 NZ values, the surface carry, the ground temperature and the
// static inputs) and writes all of it (U, sat, their tendencies, T, liq,
// psi and the plant-available water: 7 NZ values, the face K NZ + 1, some
// 45 surface values), against one step of the land column's arithmetic
// (some 2,500 operations a column at Nz 20 for ForwardEuler, Heun twice,
// ImplicitEuler that and two tridiagonal solves an iteration). Every field
// is (NZ, cells) or (cells,), element (k, col) at k * cells + col, so each
// access is coalesced; the auxiliaries are stored as they are formed.
//
// Plain C interface, loaded with ctypes: one entry point per instantiation
// (SOIL_ENTRY, with SOIL_T, SOIL_NZ, LAND_VEG, LAND_RICHARDS, LAND_CURVE,
// LAND_COND, LAND_SNOW and SOIL_STEPPER), returning cudaGetLastError().

#include <cuda_runtime.h>

#include "land_full_step.cuh"

namespace {

template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, bool SNOW,
          int STEPPER>
__global__ void __launch_bounds__(64) land_column_full_step_kernel(
    const LandFullStepIO io, const LandInputs inputs, const T* __restrict__ root,
    const long long root_row_stride, const long long root_cell_stride,
    const T* __restrict__ dz_g, const T* __restrict__ dzf_g, const T* __restrict__ zc_g,
    const T* __restrict__ zf_g, const LandColumnParams<T> P, const T dt, const T inv_dt,
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
    land::full_step_column<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW, STEPPER>(
        io, inputs, root, root_row_stride, root_cell_stride, col, cells, sc, P, dz, dzf, zc, zf,
        dt, inv_dt, iters, solver);
}

}  // namespace

// One entry point per instantiation, named SOIL_ENTRY
// (land_column_full_step_[heun_|implicit_]<bare|veg>_<noflow|richards>_<vg|bc>
// _<mualem|linear>[_snow]_<f32|f64>_nz<NZ>). The build (ops/cuda_build.py)
// compiles each instantiation in its own nvcc with SOIL_ENTRY, SOIL_T,
// SOIL_NZ, LAND_VEG, LAND_RICHARDS, LAND_COND (0 Mualem, 1 linear: the face
// conductivity, which the full step writes under NoFlow too) and, with
// Richards flow, LAND_CURVE (0 Van Genuchten, 1 Brooks-Corey) defined;
// SOIL_STEPPER (0 ForwardEuler, the default, 1 Heun, 2 ImplicitEuler) and
// LAND_SNOW (1 with a snowpack) where the tags ask for them. The
// ImplicitEuler entry takes the solver (0 Thomas, 1 PCR) and the Picard
// count at run time; every entry returns cudaErrorInvalidValue for another
// solver code, a count below 1, or a count other than 1 without
// ImplicitEuler.
#if !defined(SOIL_ENTRY) || !defined(SOIL_T) || !defined(SOIL_NZ) || !defined(LAND_VEG) || \
    !defined(LAND_RICHARDS) || !defined(LAND_COND)
#error "build with -DSOIL_ENTRY=<name> -DSOIL_T=float|double -DSOIL_NZ=<levels> -DLAND_VEG=0|1 -DLAND_RICHARDS=0|1 -DLAND_COND=0|1 [-DLAND_CURVE=0|1 -DLAND_SNOW=0|1 -DSOIL_STEPPER=0|1|2]"
#endif
#ifndef LAND_CURVE
#define LAND_CURVE 0
#endif
#ifndef LAND_SNOW
#define LAND_SNOW 0
#endif
#ifndef SOIL_STEPPER
#define SOIL_STEPPER 0
#endif

extern "C" int SOIL_ENTRY(const LandFullStepIO* io, const LandInputs* inputs,
                          const SOIL_T* root, long long root_row_stride,
                          long long root_cell_stride, const SOIL_T* dz, const SOIL_T* dzf,
                          const SOIL_T* zc, const SOIL_T* zf, const LandColumnParams<SOIL_T>* P,
                          double dt, long long cells, int solver, int picard, void* stream)
{
    if (picard < 1 || (SOIL_STEPPER != 2 && picard != 1) || (solver != 0 && solver != 1))
        return (int)cudaErrorInvalidValue;
    const int threads = 64;
    const unsigned blocks = (unsigned)((cells + threads - 1) / threads);
    land_column_full_step_kernel<SOIL_T, SOIL_NZ, LAND_VEG != 0, LAND_RICHARDS != 0, LAND_CURVE,
                                 LAND_COND, LAND_SNOW != 0, SOIL_STEPPER>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(
            *io, *inputs, root, root_row_stride, root_cell_stride, dz, dzf, zc, zf, *P,
            SOIL_T(dt), SOIL_T(1.0 / dt), cells, picard, solver);
    return (int)cudaGetLastError();
}
