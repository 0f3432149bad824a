// Segment VJP of the soil column's rollout for Hopper (sm_90a), a column
// on a group of lanes: ForwardEuler, Heun, and ImplicitEuler (Thomas or PCR
// solves, any number of Picard iterations), over heat + Richards flow.
//
// Replaces terrarium_tpu/ops/fused_vjp.py::make_segment_vjp (pallas_call at
// :344) for ForwardEuler (terrarium_tpu/timesteppers/stepping.py:99-131),
// Heun (:134-188) and ImplicitEuler (terrarium_tpu/timesteppers/
// implicit.py:173, the Picard loop :234-254) over the heat + FreeWater +
// Richards SoilModel with a Dirichlet top temperature. Given the segment's
// input carry (U, sat, S) and the cotangents of its output carry, it
// returns the cotangents of the input carry and of the two differentiated
// parameters, K_sat and sk_mineral. csrc/soil_column_segment_vjp.cu runs
// the heat-only model's segment VJPs, one thread a column.
//
// A column runs on a group of G lanes of one warp, L = ceil(NZ / G) levels
// a lane (soil::GroupColumn in soil_group_step.cuh; G from
// soil::vjp_group_lanes(NZ, STEPPER, SOLVER), or SOIL_GROUP where a build
// defines it):
// 1. forward: `steps` applications of the group rollout's own step
//    (GroupColumn::step, heun_step or picard_step), so at the rollout's G
//    its carries are the rollout's bit for bit; each step's input carry
//    (2 NZ + 1 values) goes to a global scratch buffer laid out
//    [step][column][row], a column's values contiguous, so that a group's
//    stores and loads are coalesced;
// 2. reverse sweep: for each step from the last, reload its carry and take
//    the step's adjoint on the group: ForwardEuler's step_adjoint (one
//    closure adjoint), Heun's heun_step_adjoint (the stage recomputed by
//    rhs, then the closure's adjoint at the stage and at x_n by one body in
//    a loop that is not unrolled), ImplicitEuler's picard_step_adjoint
//    (each Picard iteration's iterate recomputed from the step's start by
//    picard_step itself, then the iteration undone: each system's solve by
//    one solve of its transposed rows with the same solver, PCR across the
//    lanes or Thomas handed from lane to lane; the rows' adjoint; the
//    closure's adjoint). The closure's adjoint takes the saturation sweeps
//    in reverse with the cotangent carried across lanes by a ballot and a
//    shuffle.
// The parameter cotangents are summed in a fixed order: each lane's running
// sum, a shuffle tree over the group, a tree over the block's groups in
// shared memory into per-block partials, then a second kernel over the
// partials, so a run is reproducible bit for bit (no float atomics).
//
// What bounds it on this card: the instructions a thread issues, as the
// group rollout (csrc/soil_column_group_rollout.cu). One thread a column
// held every level's recompute, cotangents and (ImplicitEuler) a system's
// rows, some 12 NZ values, in 56-255 registers with up to 18 KB of spill
// stores (Heun at Nz 30: 255 registers, 5,476 bytes, 192,927 SASS), ran
// the implicit iterates' recompute out of line through local memory and
// compiled to some 250,000 SASS instructions; on a group a lane holds its
// L levels' (at f32: ImplicitEuler at Nz 30, PCR G 32, 80 registers, 16
// bytes of spill stores, 13,520 SASS; Thomas G 8, 128 registers, 624
// bytes, 49,250 SASS; ForwardEuler at Nz 20, G 4, 64 registers, 1,000
// bytes, 24,295 SASS; Heun at Nz 30, G 32, 64 registers, 16 bytes, 7,948
// SASS), and a segment runs 2.2-4.8x faster (PERF.md section 6).
//
// Memory layout: fields are (NZ, cells), k = 0 the bottom layer; element
// (k, col) at k * cells + col. The groups of the last block beyond `cells`
// run the last column again from its carry, store nothing, write nothing
// and add nothing to the sums, so that every warp is whole in the
// exchanges.
//
// Plain C interface, loaded with ctypes: one entry point per instantiation
// (SOIL_ENTRY, with SOIL_T, SOIL_NZ, SOIL_STEPPER 0 ForwardEuler, 1 Heun or
// 2 ImplicitEuler, the last with SOIL_SOLVER 0 Thomas, 1 PCR or 2 both, a
// kernel each, and SOIL_PICARD), with the arguments of
// csrc/soil_column_segment_vjp.cu's entries, launching the kernel (of the
// solver that its `solver` argument names) and the reduction and returning
// cudaGetLastError(); and <SOIL_ENTRY>_warps, the kernel's resident warps
// an SM and its G.

#include <cuda_runtime.h>

#include "soil_group_step.cuh"

#if !defined(SOIL_ENTRY) || !defined(SOIL_T) || !defined(SOIL_NZ) || !defined(SOIL_STEPPER)
#error "build with -DSOIL_ENTRY=<name> -DSOIL_T=float|double -DSOIL_NZ=<levels> -DSOIL_STEPPER=0|1|2 [-DSOIL_SOLVER=0|1|2 -DSOIL_PICARD=1] [-DSOIL_GROUP=<lanes>] [-DSOIL_MIN_BLOCKS=<blocks>]"
#endif
#if SOIL_STEPPER < 0 || SOIL_STEPPER > 2 || (defined(SOIL_HEAT) && SOIL_HEAT)
#error "the group segment VJP runs ForwardEuler, Heun and ImplicitEuler over heat + Richards"
#endif
#ifndef SOIL_SOLVER
#define SOIL_SOLVER 0
#endif
#ifndef SOIL_PICARD
#define SOIL_PICARD 0
#endif

namespace {

constexpr int THREADS = 256;      // a block: 256 / G columns
constexpr int kReduceThreads = 256;

// resident blocks an SM that __launch_bounds__ asks of the kernel of
// STEPPER (and SOLVER) at L levels a lane, or SOIL_MIN_BLOCKS where a build
// defines it. ImplicitEuler, measured at Nz 30 f32 (an H100 80GB HBM3 at
// 700 W, rollout_layout_ab.py vjp_time, PERF.md section 6): PCR at L 1 3
// blocks (24 warps, at most 80 registers: 16 bytes of spill stores, 1.28x
// faster than 2 blocks' 124 registers and no spills, 1.02x than 4
// blocks'); Thomas at L 4 2 blocks (16 warps, at most 128 registers: 624
// bytes of spill stores, faster than 1 block without spills and, at two
// Picard iterations, than 3 and 4). ForwardEuler (Nz 20, G 4, L 5) and
// Heun (Nz 30, G 32, L 1), measured the same way (rollout_layout_ab.py
// explicit_vjp_time): 4 blocks (32 warps, at most 64 registers), though
// they spill (Euler 1,000 bytes, Heun 16): Euler 9.03 ms a 48-step segment
// against 9.74, 11.18 and 18.79 at 3, 2 and 1 blocks; Heun 24.69 ms
// against 26.52, 32.90 and 32.91
template <int STEPPER, int SOLVER, int L>
constexpr int min_blocks() {
#ifdef SOIL_MIN_BLOCKS
    return SOIL_MIN_BLOCKS;
#else
    if (STEPPER != soil::STEPPER_IMPLICIT) return 4;
    return SOLVER == soil::SOLVER_PCR && L == 1 ? 3 : 2;
#endif
}

// the group size of a kernel of STEPPER (and SOLVER)
template <int NZ, int STEPPER, int SOLVER>
constexpr int group_of() {
#ifdef SOIL_GROUP
    return SOIL_GROUP;
#else
    return soil::vjp_group_lanes(NZ, STEPPER, SOLVER);
#endif
}

template <typename T, int NZ, int G, int STEPPER, int SOLVER>
__global__ void __launch_bounds__(THREADS, (min_blocks<STEPPER, SOLVER, (NZ + G - 1) / G>()))
soil_column_group_segment_vjp_kernel(
    const T* __restrict__ U_in, const T* __restrict__ sat_in, const T* __restrict__ S_in,
    const T* __restrict__ gU_out, const T* __restrict__ gsat_out,
    const T* __restrict__ gS_out, T* __restrict__ gU_in, T* __restrict__ gsat_in,
    T* __restrict__ gS_in, T* __restrict__ partials, T* __restrict__ scratch,
    const T* __restrict__ top_T, long long top_step_stride, long long top_cell_stride,
    const T* __restrict__ dz_g, const T* __restrict__ dzf_g,
    const T* __restrict__ zc_g, const T* __restrict__ zf_g,
    const SoilColumnParams P, const int steps, const T dt, const T inv_dt,
    const long long cells, const int iters)
{
    using Lanes = soil::WarpLanes<G>;
    using Column = soil::GroupColumn<T, NZ, G, Lanes>;
    constexpr int L = Column::L;
    constexpr int GROUPS = THREADS / G;
    __shared__ T red[2][GROUPS];
    const long long group = ((long long)blockIdx.x * THREADS + threadIdx.x) / G;
    const bool live = group < cells;
    const long long col = live ? group : cells - 1;

    const Lanes lanes;
    const soil::Consts<T> c(P);
    Column column(lanes, c, P, dz_g, dzf_g, zc_g, zf_g);
    T U[1][L], sat[1][L], gU[1][L], gs[1][L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
        const int k = column.level(0, l);
        const bool in = k < NZ;
        U[0][l] = in ? U_in[k * cells + col] : T(0);
        sat[0][l] = in ? sat_in[k * cells + col] : T(0);
        gU[0][l] = in ? gU_out[k * cells + col] : T(0);
        gs[0][l] = in ? gsat_out[k * cells + col] : T(0);
    }
    T S = S_in[col], gS = gS_out[col], gKsat[1] = {T(0)}, gskm[1] = {T(0)};

    column.template segment_vjp<STEPPER, SOLVER>(U, sat, S, gU, gs, gS, scratch, col, cells,
                                                 live, top_T + col * top_cell_stride,
                                                 top_step_stride, steps, dt, inv_dt, iters,
                                                 gKsat, gskm);
    if (live) {
#pragma unroll
        for (int l = 0; l < L; ++l) {
            const int k = column.level(0, l);
            if (k < NZ) {
                gU_in[k * cells + col] = gU[0][l];
                gsat_in[k * cells + col] = gs[0][l];
            }
        }
        if (lanes.id == 0) gS_in[col] = gS;
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
__global__ void __launch_bounds__(kReduceThreads) soil_column_group_segment_vjp_reduce_kernel(
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
int launch(const T* U_in, const T* sat_in, const T* S_in, const T* gU_out, const T* gsat_out,
           const T* gS_out, T* gU_in, T* gsat_in, T* gS_in, T* partials, T* gparams,
           T* scratch, const T* top_T, long long top_step_stride, long long top_cell_stride,
           const T* dz, const T* dzf, const T* zc, const T* zf, const SoilColumnParams* P,
           int steps, double dt, long long cells, int iters, cudaStream_t stream)
{
    constexpr int G = group_of<NZ, STEPPER, SOLVER>();
    const int blocks = (int)((cells * G + THREADS - 1) / THREADS);
    soil_column_group_segment_vjp_kernel<T, NZ, G, STEPPER, SOLVER>
        <<<blocks, THREADS, 0, stream>>>(
        U_in, sat_in, S_in, gU_out, gsat_out, gS_out, gU_in, gsat_in, gS_in, partials, scratch,
        top_T, top_step_stride, top_cell_stride, dz, dzf, zc, zf, *P, steps, T(dt), T(1.0 / dt),
        cells, iters);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    soil_column_group_segment_vjp_reduce_kernel<T><<<1, kReduceThreads, 0, stream>>>(
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
        &blocks, soil_column_group_segment_vjp_kernel<SOIL_T, SOIL_NZ, G, SOIL_STEPPER, SOLVER>,
        THREADS, 0);
    *group = G;
    return err == cudaSuccess ? blocks * THREADS / 32 : -1;
}

// an ImplicitEuler entry of both solvers (SOIL_SOLVER 2, the Picard
// entries) holds a kernel of each; any other entry one, of ENTRY_SOLVER
// (the explicit steppers' solve nothing)
#define BOTH_SOLVERS (SOIL_STEPPER == 2 && SOIL_SOLVER == 2)
constexpr int ENTRY_SOLVER = SOIL_STEPPER == 2 && SOIL_SOLVER != 2 ? SOIL_SOLVER
                                                                   : soil::SOLVER_PCR;

}  // namespace

#define SOIL_CAT2(a, b) a##b
#define SOIL_CAT(a, b) SOIL_CAT2(a, b)

// One entry point per instantiation, named SOIL_ENTRY
// (soil_column_group_segment_vjp_<euler|heun>_richards[_g<G>][_mb<B>]_
// <f32|f64>_nz<NZ>, soil_column_group_segment_vjp_implicit_<thomas|pcr|
// picard>_richards[_g<G>][_mb<B>]_<f32|f64>_nz<NZ>), with the arguments of
// the one-thread segment VJP's entries (csrc/soil_column_segment_vjp.cu):
// cudaErrorInvalidValue for a solver code other than 0 and 1 or, for
// ImplicitEuler, one the entry was not built for, a Picard count below 1,
// or one other than 1 without SOIL_PICARD (the explicit steppers' entries
// take a count of 1 and read no solver).
// `partials` holds 2 * ceil(cells / (256 / G)) values; `scratch` steps *
// cells * (2 NZ + 1), laid out [step][column][row].
extern "C" int SOIL_ENTRY(const SOIL_T* U_in, const SOIL_T* sat_in, const SOIL_T* S_in,
                          const SOIL_T* gU_out, const SOIL_T* gsat_out, const SOIL_T* gS_out,
                          SOIL_T* gU_in, SOIL_T* gsat_in, SOIL_T* gS_in, SOIL_T* partials,
                          SOIL_T* gparams, SOIL_T* scratch, const SOIL_T* top_T,
                          long long top_step_stride, long long top_cell_stride,
                          const SOIL_T* dz, const SOIL_T* dzf, const SOIL_T* zc,
                          const SOIL_T* zf, const SoilColumnParams* P, int steps, double dt,
                          long long cells, int solver, int picard, void* stream)
{
    static_assert(SOIL_STEPPER == soil::STEPPER_IMPLICIT || !SOIL_PICARD,
                  "Picard iterations are ImplicitEuler's");
    if (picard < 1 || (!SOIL_PICARD && picard != 1) || (solver != 0 && solver != 1)
        || (SOIL_STEPPER == soil::STEPPER_IMPLICIT && !BOTH_SOLVERS && solver != ENTRY_SOLVER))
        return (int)cudaErrorInvalidValue;
#define SOIL_LAUNCH(SOLVER)                                                                    \
    launch<SOIL_T, SOIL_NZ, SOIL_STEPPER, SOLVER>(                                            \
        U_in, sat_in, S_in, gU_out, gsat_out, gS_out, gU_in, gsat_in, gS_in, partials, gparams, \
        scratch, top_T, top_step_stride, top_cell_stride, dz, dzf, zc, zf, P, steps, dt, cells, \
        picard, (cudaStream_t)stream)
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
