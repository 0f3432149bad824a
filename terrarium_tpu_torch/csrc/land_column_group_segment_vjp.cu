// Segment VJP of the LandModel's ImplicitEuler and Heun rollouts for Hopper
// (sm_90a), a column on a group of lanes: ImplicitEuler with Thomas or PCR
// solves and any number of Picard iterations, or Heun; Richards flow, with
// or without vegetation, either retention curve and conductivity, with or
// without a snowpack (LAND_SNOW).
//
// Replaces terrarium_tpu/ops/fused_vjp.py::make_segment_vjp (kernel :225,
// pallas_call :344) traced over a LandModel ImplicitEuler step
// (terrarium_tpu/timesteppers/implicit.py:173, the Picard loop :234-254) or
// Heun step (terrarium_tpu/timesteppers/stepping.py:167-188), with a
// Snowpack (terrarium_tpu/processes/snow.py:69) where LAND_SNOW.
// Given the segment's input carry (U and sat; the pool, skin temperature,
// canopy water, carbon, vegetation fraction, net assimilation and SWE) and the
// cotangents of its output carry, it returns the cotangents of the input
// carry and of the two differentiated parameters, K_sat and sk_mineral.
// csrc/land_column_segment_vjp.cu runs every other land segment VJP
// (NoFlow, ForwardEuler), one thread a column.
//
// A column runs on a group of G lanes of one warp, L = ceil(NZ / G) soil
// levels a lane (land::GroupColumn in land_group_step.cuh, built on
// soil::GroupColumn; G from land::implicit_group_lanes(NZ, SOLVER) or
// land::heun_group_lanes(NZ), or SOIL_GROUP where a build defines it):
// 1. forward: `steps` applications of GroupColumn::picard_step (Heun:
//    GroupColumn::heun_step, the group rollout's own step); each
//    step's input carry (2 NZ + 6 values, one more, the SWE, under
//    LAND_SNOW) goes to a global scratch buffer
//    laid out [step][row][cell], as the one-thread kernel's;
// 2. reverse sweep: for each step from the last, reload its carry and take
//    GroupColumn::picard_step_adjoint: each Picard iteration's iterate
//    recomputed from the step's start by picard_step itself, inline, then
//    the iteration undone: each system by one solve of its transposed rows
//    with the same solver (PCR across the lanes or Thomas handed from lane
//    to lane), the rows' adjoint, the closure's adjoint (the soil's faces'
//    shares gathered across lanes in the one-thread adjoint's order, the
//    reverse sweeps' cotangent carried across lanes by a ballot and a
//    shuffle) and the surface block's, its ten forward-mode passes split
//    across the group's lanes, lane j the input directions j, j + G, ...;
//    Heun: GroupColumn::heun_step_adjoint, the stage recomputed by the
//    rollout's heun_stage, then the closure's adjoint twice, at the stage
//    and at x_n, each with the surface block's passes split so
// The parameter cotangents are summed in a fixed order: each lane's running
// sum, a shuffle tree over the group, a tree over the block's groups in
// shared memory into per-block partials, then a second kernel over the
// partials, so a run is reproducible bit for bit (no float atomics).
//
// What bounds it on this card: the instructions a thread issues. One thread
// a column held the soil adjoint's some 12 NZ live values in 255 registers
// with 5.0-5.6 KB of spill stores (8 resident warps an SM), ran the ten
// surface passes one after another and the iterates' recompute out of line
// through local memory; on a group a lane holds its L levels' values and
// ceil(10 / G) of the surface passes (Nz 20 f32: PCR G 4, Thomas G 8, 128
// registers, 1,900 and 884 bytes of spill stores, 16 warps), and a segment
// runs 2.2-2.8x faster, 17-22x its operation-weighted bound (PERF.md
// section 6). Heun (G 4, 3 blocks: 80 registers, 2,168 bytes of spill
// stores, 24 warps) runs about 2x faster than one thread a column, whose
// 255 registers spilled 4,356 bytes.
//
// Memory layout: fields are (NZ, cells), k = 0 the bottom layer; element
// (k, col) at k * cells + col. The groups of the last block beyond `cells`
// run the last column again from its carry, store nothing, write nothing
// and add nothing to the sums, so that every warp is whole in the
// exchanges.
//
// Plain C interface, loaded with ctypes: one entry point per instantiation
// (SOIL_ENTRY, with SOIL_T, SOIL_NZ, LAND_VEG, LAND_RICHARDS 1, LAND_CURVE,
// LAND_COND, LAND_SNOW, SOIL_STEPPER 1 Heun or 2 ImplicitEuler, the last with
// SOIL_SOLVER 0 Thomas, 1 PCR or 2 both, a kernel each, and SOIL_PICARD),
// with the arguments of
// csrc/land_column_segment_vjp.cu's entries, launching the kernel of the
// solver that its `solver` argument names and the reduction and returning
// cudaGetLastError(); and <SOIL_ENTRY>_warps, the kernel's resident warps
// an SM and its G.

#include <cuda_runtime.h>

#include "land_group_step.cuh"

#if !defined(SOIL_ENTRY) || !defined(SOIL_T) || !defined(SOIL_NZ) || !defined(LAND_VEG) || \
    !defined(LAND_RICHARDS)
#error "build with -DSOIL_ENTRY=<name> -DSOIL_T=float|double -DSOIL_NZ=<levels> -DLAND_VEG=0|1 -DLAND_RICHARDS=1 -DLAND_CURVE=0|1 -DLAND_COND=0|1 [-DLAND_SNOW=1] -DSOIL_STEPPER=1|2 [-DSOIL_SOLVER=0|1|2 -DSOIL_PICARD=1] [-DSOIL_GROUP=<lanes>] [-DSOIL_MIN_BLOCKS=<blocks>]"
#endif
#if !LAND_RICHARDS || !defined(SOIL_STEPPER) || (SOIL_STEPPER != 1 && SOIL_STEPPER != 2)
#error "the land group segment VJP runs ImplicitEuler or Heun over Richards flow"
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
#ifndef SOIL_SOLVER
#define SOIL_SOLVER 0
#endif
#ifndef SOIL_PICARD
#define SOIL_PICARD 0
#endif

namespace {

constexpr int THREADS = 256;  // a block: 256 / G columns
constexpr int kReduceThreads = 256;

// resident blocks an SM that __launch_bounds__ asks of the kernels, or
// SOIL_MIN_BLOCKS where a build defines it. Measured at Nz 20
// f32 (an H100 80GB HBM3 at 700 W, rollout_layout_ab.py land_vjp_time,
// PERF.md section 6; one and two Picard iterations): PCR at G 8, 1 to 4
// blocks 94.98/212.30, 54.56/124.88 (128 registers, 936 bytes of spill
// stores, 16 warps), 64.59/149.01 and 66.34/164.40 ms; Thomas at G 4
// 54.86/121.26, 48.27/108.57 (128 registers, 2,244 bytes), 55.50/137.43 and
// 52.18/131.56 ms: 2 blocks for both. Heun at G 4 (land_heun_time, 48
// steps of 60 s): 76.99 ms (255 registers), 57.03 (128, 1,516 bytes),
// 54.66 (80, 2,168 bytes, 24 warps) and 62.37 ms: 3 blocks. PCR with a
// snowpack at G 4 (land_snow_time, a 48-step segment of 600 s): 67.05 ms
// (255 registers), 56.65 (128, 2,084 bytes), 53.40 (80, 3,460 bytes, 24
// warps) and 55.60 ms: 3 blocks
#ifdef SOIL_MIN_BLOCKS
constexpr int MIN_BLOCKS = SOIL_MIN_BLOCKS;
#else
constexpr int MIN_BLOCKS = SOIL_STEPPER == 1 || LAND_SNOW ? 3 : 2;
#endif

// the group size of a kernel of STEPPER (and SOLVER)
template <int NZ, int STEPPER, int SOLVER>
constexpr int group_of() {
#ifdef SOIL_GROUP
    return SOIL_GROUP;
#else
    return STEPPER == soil::STEPPER_HEUN ? land::heun_group_lanes(NZ)
                                         : land::implicit_group_lanes(NZ, SOLVER);
#endif
}

template <typename T, int NZ, int G, int STEPPER, int SOLVER>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
land_column_group_segment_vjp_kernel(
    const LandCarry in, const LandCarry gout, const LandCarry gin, const LandInputs inputs,
    const T* __restrict__ root, const long long root_row_stride,
    const long long root_cell_stride, const T* __restrict__ dz_g, const T* __restrict__ dzf_g,
    const T* __restrict__ zc_g, const T* __restrict__ zf_g, const LandColumnParams<T> P,
    T* __restrict__ scratch, T* __restrict__ partials, const int steps, const T dt,
    const T inv_dt, const long long cells, const int iters)
{
    constexpr bool VEG = LAND_VEG != 0, SNOW = LAND_SNOW != 0;
    using Lanes = soil::WarpLanes<G>;
    using Column = land::GroupColumn<T, NZ, G, Lanes, VEG, LAND_CURVE, LAND_COND, SNOW>;
    constexpr int L = Column::L;
    constexpr int GROUPS = THREADS / G;
    __shared__ T red[2][GROUPS];
    const long long group = ((long long)blockIdx.x * THREADS + threadIdx.x) / G;
    const bool live = group < cells;
    const long long col = live ? group : cells - 1;

    const Lanes lanes;
    const soil::Consts<T> sc(P.soil);
    Column column(lanes, sc, P, dz_g, dzf_g, zc_g, zf_g,
                  VEG ? root + col * root_cell_stride : nullptr, root_row_stride);
    auto read = [&](const void* p, const long long i) {
        return p ? static_cast<const T*>(p)[i] : T(0);
    };
    T U[1][L], sat[1][L], gU[1][L], gs[1][L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
        const int k = column.level(0, l);
        const bool lv = k < NZ;
        U[0][l] = lv ? static_cast<const T*>(in.U)[k * cells + col] : T(0);
        sat[0][l] = lv ? static_cast<const T*>(in.sat)[k * cells + col] : T(0);
        gU[0][l] = lv ? read(gout.U, k * cells + col) : T(0);
        gs[0][l] = lv ? read(gout.sat, k * cells + col) : T(0);
    }
    land::Surface<T> s{}, gsc{};
    s.S = static_cast<const T*>(in.S)[col];
    s.Ts = static_cast<const T*>(in.Ts)[col];
    if (VEG) {
        s.w = static_cast<const T*>(in.w)[col];
        s.C = static_cast<const T*>(in.C)[col];
        s.nu = static_cast<const T*>(in.nu)[col];
        s.An = static_cast<const T*>(in.An)[col];
    }
    if (SNOW) s.swe = static_cast<const T*>(in.swe)[col];
    gsc.S = read(gout.S, col);
    gsc.Ts = read(gout.Ts, col);
    gsc.w = read(gout.w, col);
    gsc.C = read(gout.C, col);
    gsc.nu = read(gout.nu, col);
    gsc.An = read(gout.An, col);
    if (SNOW) gsc.swe = read(gout.swe, col);
    land::Forcing<T> f;
#pragma unroll
    for (int i = 0; i < LAND_NIN; ++i)
        f.v[i] = static_cast<const T*>(inputs.ptr[i])[col * inputs.cell_stride[i]];
    T gKsat[1] = {T(0)}, gskm[1] = {T(0)};

    column.template segment_vjp<STEPPER, SOLVER>(U, sat, s, gU, gs, gsc, scratch, col, cells,
                                                 live, f, inputs, steps, dt, inv_dt, iters,
                                                 gKsat, gskm);
    if (live) {
#pragma unroll
        for (int l = 0; l < L; ++l) {
            const int k = column.level(0, l);
            if (k < NZ) {
                static_cast<T*>(gin.U)[k * cells + col] = gU[0][l];
                static_cast<T*>(gin.sat)[k * cells + col] = gs[0][l];
            }
        }
        if (lanes.id == 0) {
            static_cast<T*>(gin.Ts)[col] = gsc.Ts;
            static_cast<T*>(gin.S)[col] = gsc.S;
            if (VEG) {
                static_cast<T*>(gin.w)[col] = gsc.w;
                static_cast<T*>(gin.C)[col] = gsc.C;
                static_cast<T*>(gin.nu)[col] = gsc.nu;
                static_cast<T*>(gin.An)[col] = gsc.An;
            }
            if (SNOW) static_cast<T*>(gin.swe)[col] = gsc.swe;
        }
    } else {
        gKsat[0] = gskm[0] = T(0);
    }

    // the parameter cotangents: the group's tree, then the block's groups'
    const T gK = column.group_sum(gKsat), gm = column.group_sum(gskm);
    const int g = threadIdx.x / G;
    if (lanes.id == 0) {
        red[0][g] = gK;
        red[1][g] = gm;
    }
    __syncthreads();
    for (int half = GROUPS / 2; half > 0; half >>= 1) {
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
__global__ void __launch_bounds__(kReduceThreads) land_column_group_segment_vjp_reduce_kernel(
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

template <typename T, int NZ, int STEPPER, int SOLVER>
int launch(const LandCarry* in, const LandCarry* gout, const LandCarry* gin,
           const LandInputs* inputs, const T* root, long long root_row_stride,
           long long root_cell_stride, const T* dz, const T* dzf, const T* zc, const T* zf,
           const LandColumnParams<T>* P, T* scratch, T* partials, T* gparams, int steps,
           double dt, long long cells, int iters, cudaStream_t stream)
{
    constexpr int G = group_of<NZ, STEPPER, SOLVER>();
    const int blocks = (int)((cells * G + THREADS - 1) / THREADS);
    land_column_group_segment_vjp_kernel<T, NZ, G, STEPPER, SOLVER><<<blocks, THREADS, 0, stream>>>(
        *in, *gout, *gin, *inputs, root, root_row_stride, root_cell_stride, dz, dzf, zc, zf, *P,
        scratch, partials, steps, T(dt), T(1.0 / dt), cells, iters);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    land_column_group_segment_vjp_reduce_kernel<T><<<1, kReduceThreads, 0, stream>>>(
        partials, blocks, gparams);
    return (int)cudaGetLastError();
}

// the resident warps an SM of the kernel of SOLVER and its group size
template <int SOLVER>
int warps_of(int* group)
{
    constexpr int G = group_of<SOIL_NZ, SOIL_STEPPER, SOLVER>();
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, land_column_group_segment_vjp_kernel<SOIL_T, SOIL_NZ, G, SOIL_STEPPER, SOLVER>,
        THREADS, 0);
    *group = G;
    return err == cudaSuccess ? blocks * THREADS / 32 : -1;
}

// an ImplicitEuler entry of both solvers (SOIL_SOLVER 2, the Picard
// entries) holds a kernel of each; any other entry one, of ENTRY_SOLVER
// (Heun's solves nothing: its kernel's SOLVER is PCR's code, unread)
#define BOTH_SOLVERS (SOIL_STEPPER == 2 && SOIL_SOLVER == 2)
constexpr int ENTRY_SOLVER = SOIL_STEPPER == 2 && SOIL_SOLVER != 2 ? SOIL_SOLVER
                                                                   : soil::SOLVER_PCR;

}  // namespace

#define SOIL_CAT2(a, b) a##b
#define SOIL_CAT(a, b) SOIL_CAT2(a, b)

// One entry point per instantiation, named SOIL_ENTRY
// (land_column_group_segment_vjp_<heun|implicit_<thomas|pcr|picard>>_
// <bare|veg>_richards_<vg|bc>_<mualem|linear>[_g<G>][_mb<B>]_<f32|f64>_
// nz<NZ>), with the arguments of the one-thread land segment VJP's entries
// (csrc/land_column_segment_vjp.cu): cudaErrorInvalidValue for a solver
// code other than 0 and 1 or, ImplicitEuler's, one the entry was not built
// for, a Picard count below 1, or one other than 1 without SOIL_PICARD. `scratch` holds
// steps * (2 NZ + 6 + LAND_SNOW) * cells values, laid out [step][row][cell];
// `partials` 2 * ceil(cells / (256 / G)).
extern "C" int SOIL_ENTRY(const LandCarry* in, const LandCarry* gout, const LandCarry* gin,
                          const LandInputs* inputs, const SOIL_T* root,
                          long long root_row_stride, long long root_cell_stride,
                          const SOIL_T* dz, const SOIL_T* dzf, const SOIL_T* zc,
                          const SOIL_T* zf, const LandColumnParams<SOIL_T>* P, SOIL_T* scratch,
                          SOIL_T* partials, SOIL_T* gparams, int steps, double dt,
                          long long cells, int solver, int picard, void* stream)
{
    static_assert(SOIL_STEPPER == soil::STEPPER_IMPLICIT || !SOIL_PICARD,
                  "the Picard iterations are ImplicitEuler's");
    if (picard < 1 || (!SOIL_PICARD && picard != 1) || (solver != 0 && solver != 1)
        || (SOIL_STEPPER == soil::STEPPER_IMPLICIT && !BOTH_SOLVERS && solver != ENTRY_SOLVER))
        return (int)cudaErrorInvalidValue;
#define SOIL_LAUNCH(SOLVER)                                                                    \
    launch<SOIL_T, SOIL_NZ, SOIL_STEPPER, SOLVER>(                                            \
        in, gout, gin, inputs, root, root_row_stride, root_cell_stride, dz, dzf, zc, zf, P,    \
        scratch, partials, gparams, steps, dt, cells, picard, (cudaStream_t)stream)
#if BOTH_SOLVERS
    if (solver == soil::SOLVER_THOMAS) return SOIL_LAUNCH(soil::SOLVER_THOMAS);
#endif
    return SOIL_LAUNCH(ENTRY_SOLVER);
#undef SOIL_LAUNCH
}

// The resident warps an SM of the instantiation's kernel (of the solver
// `solver` names where the entry holds both), or -1 where the occupancy
// query fails; `group` receives its G
extern "C" int SOIL_CAT(SOIL_ENTRY, _warps)(int solver, int* group)
{
#if BOTH_SOLVERS
    if (solver == soil::SOLVER_THOMAS) return warps_of<soil::SOLVER_THOMAS>(group);
#else
    (void)solver;
#endif
    return warps_of<ENTRY_SOLVER>(group);
}
