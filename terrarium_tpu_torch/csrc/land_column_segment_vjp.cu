// Segment VJP of the LandModel column rollouts for Hopper (sm_90a).
//
// Replaces terrarium_tpu/ops/fused_vjp.py::make_segment_vjp (kernel :225,
// pallas_call :344), which is generic over the model, for a LandModel step
// (csrc/land_column_rollout.cu's column code): the vector-Jacobian product
// of `steps` closure-rotated steps by ForwardEuler, Heun or ImplicitEuler
// (Thomas or PCR solves, one Picard iteration or any number) of the coupled
// model (atmosphere, optional snowpack, SEB, surface hydrology, PALADYN
// vegetation, the soil column), with static inputs. Given the segment's
// input carry (U and sat; the pool, skin temperature, canopy water, carbon,
// vegetation fraction, net assimilation and SWE) and the cotangents of its
// output carry, it
// returns the cotangents of the input carry and of the two differentiated
// parameters, K_sat and sk_mineral = sqrt(k_mineral) times the mineral
// fraction. The clock is not differentiated: no time cotangent (the JAX
// kernel replicates the scalar one per block, fused_vjp.py:328-341).
//
// One thread owns one column (land::segment_vjp_column in land_adjoint.cuh):
// 1. forward: `steps` applications of land::step, land::heun_step,
//    land::implicit_step or land::picard_step (out of line,
//    land::picard_step_call), the rollout kernel's code; each step's input
//    carry (2*NZ + 6 values, 2*NZ + 7 with a snowpack) goes to a global
//    scratch buffer laid out [step][row][cell], so a warp's loads and
//    stores are coalesced;
// 2. reverse sweep: for each step from the last, reload its carry,
//    recompute the step's closure and apply its hand-derived adjoint
//    (land::step_adjoint, land::heun_step_adjoint, which recomputes the
//    stage out of line from the step's start, land::implicit_step_adjoint,
//    land::picard_step_adjoint, which recomputes each iterate from the
//    step's start), built on
//    land::closure_rhs_adjoint: the soil column in exact reverse order
//    (Richards flow with the ET sink, heat flux, heads, linear centre K,
//    plant-available water, energy closure, sweeps), and the column's
//    surface block (SEB sweeps with three Monin-Obukhov drags, ET,
//    interception, vegetation, runoff; the snow cover's albedo and
//    emissivity blend) by its Jacobian, formed one input direction a pass
//    in forward mode and contracted with the outputs' cotangents. The
//    branch conventions are written at the top of land_adjoint.cuh.
// The parameter cotangents are summed per thread in the working type, then
// per block by a fixed-order tree in shared memory into per-block partials;
// a second kernel sums the partials in a fixed order, so a run is
// reproducible bit for bit (no float atomics).
//
// What bounds it on this card: arithmetic and local memory, not HBM. Per
// column and step the reverse sweep recomputes a forward step and runs the
// soil adjoint (about three times the soil part of a forward step) and ten
// forward-mode passes of the surface block (eleven with a snowpack; each
// about twice the surface part of a forward step: three drags with their
// four Monin-Obukhov iterations, the vegetation's exps and powers), Heun
// all of that twice and the stage once more, and ImplicitEuler three more
// solves a system and the rows' adjoints; with k Picard iterations the
// reverse sweep runs each iteration's adjoint and recomputes the k(k-1)/2
// iterations before them. A thread holds some 12*NZ
// live values in the soil adjoint, far past the 255 registers it may have,
// so ptxas spills to local memory, which L1 and L2 cache. The scratch
// carries are written once and read once a step: at 56,951 columns, Nz 20
// and 48 steps in float32, 503 MB each way, a small share of the time
// against the arithmetic. This is the simple one thread a column shape of
// the forward, spills accepted.
//
// Plain C interface, loaded with ctypes: one entry point per instantiation
// (SOIL_ENTRY, with SOIL_T, SOIL_NZ, LAND_VEG, LAND_RICHARDS, LAND_CURVE,
// LAND_COND, LAND_SNOW, SOIL_STEPPER, SOIL_SOLVER and SOIL_PICARD),
// returning cudaGetLastError() after the launches.

#include <cuda_runtime.h>

#include "land_adjoint.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kReduceThreads = 256;

template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, bool SNOW,
          int STEPPER, int SOLVER, bool PICARD>
__global__ void __launch_bounds__(kThreads) land_column_segment_vjp_kernel(
    const LandCarry in, const LandCarry gout, const LandCarry gin, const LandInputs inputs,
    const T* __restrict__ root, const long long root_row_stride,
    const long long root_cell_stride, const T* __restrict__ dz_g, const T* __restrict__ dzf_g,
    const T* __restrict__ zc_g, const T* __restrict__ zf_g, const LandColumnParams<T> P,
    T* __restrict__ scratch, T* __restrict__ partials, const int steps, const T dt,
    const T inv_dt, const long long cells, const int iters, const int solver)
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
        const soil::Consts<T> sc(P.soil);
        land::segment_vjp_column<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW, STEPPER, SOLVER,
                                 PICARD>(
            col, cells, steps, in, gout, gin, scratch, inputs, root, root_row_stride,
            root_cell_stride, sc, P, dz, dzf, zc, zf, dt, inv_dt, gKsat, gskm, iters, solver);
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
__global__ void __launch_bounds__(kReduceThreads) land_column_segment_vjp_reduce_kernel(
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

}  // namespace

// One entry point per instantiation, named SOIL_ENTRY
// (land_column_segment_vjp_[heun_|implicit_<thomas|pcr|picard>_]<bare|veg>_<noflow|
// richards_<vg|bc>_<mualem|linear>>[_snow]_<f32|f64>_nz<NZ>). The build
// (ops/cuda_build.py) compiles each instantiation in its own nvcc with
// SOIL_ENTRY, SOIL_T, SOIL_NZ, LAND_VEG, LAND_RICHARDS and, with Richards
// flow, LAND_CURVE (0 Van Genuchten, 1 Brooks-Corey) and LAND_COND (0
// Mualem, 1 linear) defined; SOIL_STEPPER (0 ForwardEuler, the default, 1
// Heun, 2 ImplicitEuler), SOIL_SOLVER (0 Thomas, 1 PCR, 2 either, chosen at
// run time by the `solver` argument), SOIL_PICARD (1: picard_step with
// `picard` iterations) and LAND_SNOW (1 with a snowpack) where the tags ask
// for them. An entry returns
// cudaErrorInvalidValue for a solver code other than 0 and 1 or one it was
// not built for, a Picard count below 1, or one other than 1 without
// SOIL_PICARD. `in` and `gin`
// hold the carry's fields (null where the composition has none), `gout`
// the output cotangents (null reads 0); the inputs are static (one row
// each); `scratch` holds steps * (2*NZ + 6 + LAND_SNOW) * cells values, `partials`
// 2 * ceil(cells / 64), `gparams` 2 (K_sat's, then sk_mineral's).
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

extern "C" int SOIL_ENTRY(const LandCarry* in, const LandCarry* gout, const LandCarry* gin,
                          const LandInputs* inputs, const SOIL_T* root,
                          long long root_row_stride, long long root_cell_stride,
                          const SOIL_T* dz, const SOIL_T* dzf, const SOIL_T* zc,
                          const SOIL_T* zf, const LandColumnParams<SOIL_T>* P, SOIL_T* scratch,
                          SOIL_T* partials, SOIL_T* gparams, int steps, double dt,
                          long long cells, int solver, int picard, void* stream)
{
    if (picard < 1 || (!SOIL_PICARD && picard != 1) || (solver != 0 && solver != 1)
        || (SOIL_STEPPER == 2 && SOIL_SOLVER != 2 && solver != SOIL_SOLVER))
        return (int)cudaErrorInvalidValue;
    const int blocks = (int)((cells + kThreads - 1) / kThreads);
    land_column_segment_vjp_kernel<SOIL_T, SOIL_NZ, LAND_VEG != 0, LAND_RICHARDS != 0,
                                   LAND_CURVE, LAND_COND, LAND_SNOW != 0, SOIL_STEPPER,
                                   SOIL_SOLVER, SOIL_PICARD != 0>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            *in, *gout, *gin, *inputs, root, root_row_stride, root_cell_stride, dz, dzf, zc, zf,
            *P, scratch, partials, steps, SOIL_T(dt), SOIL_T(1.0 / dt), cells, picard, solver);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    land_column_segment_vjp_reduce_kernel<SOIL_T><<<1, kReduceThreads, 0, (cudaStream_t)stream>>>(
        partials, blocks, gparams);
    return (int)cudaGetLastError();
}
