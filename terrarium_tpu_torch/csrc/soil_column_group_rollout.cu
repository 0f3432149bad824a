// Soil column rollouts for Hopper (sm_90a), a column on a group of lanes:
// ForwardEuler, Heun or ImplicitEuler (Thomas or PCR, any number of Picard
// iterations) over heat + Richards flow.
//
// Replaces terrarium_tpu/ops/fused_step.py::make_fused_lean_rollout for
// SoilModel with two-phase heat conduction, the free-water freeze curve and
// Richards flow over Van Genuchten and Mualem conductivity, stepped by
// ForwardEuler, Heun or ImplicitEuler (terrarium_tpu/timesteppers/
// implicit.py:173, the Picard loop :234-254, its tridiagonal solves
// tridiag.py:30 Thomas and :109 PCR), with a Dirichlet top temperature from
// a table (one row per clock time; Heun n + 1 rows) or a uniformly spaced
// series read at each clock time (the counterpart of _WindowSource,
// fused_step.py:92). csrc/soil_column_rollout.cu runs every other soil
// rollout, one thread a column.
//
// A column runs on a group of G lanes of one warp, L = ceil(NZ / G) levels
// a lane (soil::GroupColumn in soil_group_step.cuh; G from
// soil::group_lanes(NZ), for ImplicitEuler soil::implicit_group_lanes(NZ,
// SOLVER), or SOIL_GROUP where a build defines it), and the group applies
// `steps` steps. The live carry (internal energy,
// saturation, surface pool) is read once and written once per launch, a
// lane its own levels; the coordinates of its levels live in its registers.
//
// What bounds it on this card: the instructions a thread issues, not HBM
// bytes. One thread a column left the card latency-bound: 56,951 columns
// are at most 431 threads an SM, 230-255 registers a thread allowed 8
// warps an SM, and a step was some 10^4 instructions of unrolled code a
// thread. A group of lanes gives 56,951 G threads, 48-56 registers a
// thread at L 1 (__launch_bounds__ for at least 32 resident warps an SM:
// at most 64 registers) and one level's code a thread (about 1,600 SASS
// instructions a kernel against 31,000). Measured, a launch then costs
// 32-40 ps per lane-slot (G L) and step whatever G, as if the card issued
// about 1,100 instructions a level and step at its full rate: IEEE
// divisions (about thirteen a level and step), a pow, four roots, the
// exchanges (about ten shuffles and three ballots a step), and the slots
// above NZ, which run with the others (rollout_layout_ab.py; PERF.md
// section 6). ImplicitEuler adds, per iteration, the chain factor's three
// powers and the two systems' rows and solves: a PCR round costs a lane
// two divisions a level, where one thread ran some 238 divisions a solve;
// Thomas is sequential, one lane of a group at a time, so it takes fewer
// lanes of more levels (G 8 at Nz 30: 64 registers, 200 bytes of spill
// stores; PCR G 32: 59 registers, none), and stays faster than one thread
// a column at G 4 to 16 (PERF.md section 6).
//
// Memory layout: fields are (NZ, cells), k = 0 the bottom layer; element
// (k, col) at k * cells + col. A group's lanes read strided rows of one
// column, once a launch. The groups of the last block beyond `cells` run
// the last column again and write nothing, so that every warp is whole in
// the exchanges.
//
// Plain C interface, loaded with ctypes: one entry point per instantiation
// (SOIL_ENTRY, with SOIL_T, SOIL_NZ and SOIL_STEPPER 0 ForwardEuler, 1 Heun
// or 2 ImplicitEuler, the last with SOIL_SOLVER 0 Thomas, 1 PCR or 2 both,
// a kernel each, and SOIL_PICARD), launching the table or the series
// kernel (of the solver that its `solver` argument names) and returning
// cudaGetLastError(); and <SOIL_ENTRY>_warps, the kernel's resident warps
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).

#include <cuda_runtime.h>

#include "soil_group_step.cuh"

#if !defined(SOIL_ENTRY) || !defined(SOIL_T) || !defined(SOIL_NZ) || !defined(SOIL_STEPPER)
#error "build with -DSOIL_ENTRY=<name> -DSOIL_T=float|double -DSOIL_NZ=<levels> -DSOIL_STEPPER=0|1|2 [-DSOIL_SOLVER=0|1|2 -DSOIL_PICARD=0|1] [-DSOIL_GROUP=<lanes>]"
#endif
#if defined(SOIL_HEAT) && SOIL_HEAT
#error "the group rollout runs heat + Richards flow"
#endif
#ifndef SOIL_SOLVER
#define SOIL_SOLVER 0
#endif
#ifndef SOIL_PICARD
#define SOIL_PICARD 0
#endif

namespace {

constexpr int THREADS = 256;      // a block: 256 / G columns
constexpr int MIN_BLOCKS = 4;     // resident blocks an SM: 32 warps, <= 64 registers

// the group size of a kernel of STEPPER (and SOLVER, ImplicitEuler)
template <int NZ, int STEPPER, int SOLVER>
constexpr int group_of() {
#ifdef SOIL_GROUP
    return SOIL_GROUP;
#else
    return STEPPER == soil::STEPPER_IMPLICIT ? soil::implicit_group_lanes(NZ, SOLVER)
                                             : soil::group_lanes(NZ);
#endif
}

template <typename T, int NZ, int G, int STEPPER, int SOLVER, bool SERIES>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) soil_column_group_rollout_kernel(
    const T* __restrict__ U_in, const T* __restrict__ sat_in, const T* __restrict__ S_in,
    T* __restrict__ U_out, T* __restrict__ sat_out, T* __restrict__ S_out,
    const T* __restrict__ top_T, long long top_step_stride, long long top_cell_stride,
    const int series_rows, const T series_t0, const T series_dts, const T time0,
    const T* __restrict__ dz_g, const T* __restrict__ dzf_g,
    const T* __restrict__ zc_g, const T* __restrict__ zf_g,
    const SoilColumnParams P, const int steps, const T dt, const T inv_dt,
    const long long cells, const int iters, unsigned long long* __restrict__ handoffs)
{
    using Lanes = soil::WarpLanes<G>;
    using Column = soil::GroupColumn<T, NZ, G, Lanes>;
    constexpr int L = Column::L;
    const long long group = ((long long)blockIdx.x * THREADS + threadIdx.x) / G;
    const bool live = group < cells;
    const long long col = live ? group : cells - 1;

    const Lanes lanes;
    const soil::Consts<T> c(P);
    Column column(lanes, c, P, dz_g, dzf_g, zc_g, zf_g);
    T U[1][L], sat[1][L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
        const int k = column.level(0, l);
        U[0][l] = k < NZ ? U_in[k * cells + col] : T(0);
        sat[0][l] = k < NZ ? sat_in[k * cells + col] : T(0);
    }
    T S = S_in[col];

    column.template rollout<STEPPER, SERIES, SOLVER>(U, sat, S, top_T + col * top_cell_stride,
                                                     top_step_stride, series_rows, series_t0,
                                                     series_dts, time0, steps, dt, inv_dt, iters);
    if (!live) return;
#pragma unroll
    for (int l = 0; l < L; ++l) {
        const int k = column.level(0, l);
        if (k < NZ) {
            U_out[k * cells + col] = U[0][l];
            sat_out[k * cells + col] = sat[0][l];
        }
    }
    if (lanes.id == 0) {
        S_out[col] = S;
        if (handoffs != nullptr) {  // the sweeps' serial hand-offs, up and down
            atomicAdd(handoffs, (unsigned long long)column.up_handoffs);
            atomicAdd(handoffs + 1, (unsigned long long)column.down_handoffs);
        }
    }
}

template <typename T, int NZ, int STEPPER, int SOLVER>
int launch(const T* U_in, const T* sat_in, const T* S_in, T* U_out, T* sat_out, T* S_out,
           const T* top_T, long long top_step_stride, long long top_cell_stride,
           int series_rows, double series_t0, double series_dts, double time0,
           const T* dz, const T* dzf, const T* zc, const T* zf, const SoilColumnParams* P,
           int steps, double dt, long long cells, int iters, unsigned long long* handoffs,
           cudaStream_t stream)
{
    constexpr int G = group_of<NZ, STEPPER, SOLVER>();
    const unsigned blocks = (unsigned)((cells * G + THREADS - 1) / THREADS);
    if (series_rows > 0)
        soil_column_group_rollout_kernel<T, NZ, G, STEPPER, SOLVER, true>
            <<<blocks, THREADS, 0, stream>>>(
                U_in, sat_in, S_in, U_out, sat_out, S_out, top_T, top_step_stride,
                top_cell_stride, series_rows, T(series_t0), T(series_dts), T(time0), dz, dzf,
                zc, zf, *P, steps, T(dt), T(1.0 / dt), cells, iters, handoffs);
    else
        soil_column_group_rollout_kernel<T, NZ, G, STEPPER, SOLVER, false>
            <<<blocks, THREADS, 0, stream>>>(
                U_in, sat_in, S_in, U_out, sat_out, S_out, top_T, top_step_stride,
                top_cell_stride, 0, T(0), T(0), T(time0), dz, dzf, zc, zf, *P, steps, T(dt),
                T(1.0 / dt), cells, iters, handoffs);
    return (int)cudaGetLastError();
}

// the resident warps an SM of one kernel and its group size
template <int STEPPER, int SOLVER, bool SERIES>
int warps_of(int* group)
{
    constexpr int G = group_of<SOIL_NZ, STEPPER, SOLVER>();
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, soil_column_group_rollout_kernel<SOIL_T, SOIL_NZ, G, STEPPER, SOLVER, SERIES>,
        THREADS, 0);
    *group = G;
    return err == cudaSuccess ? blocks * THREADS / 32 : -1;
}

// an ImplicitEuler entry of both solvers (SOIL_SOLVER 2) holds a kernel of
// each; any other entry one, of ENTRY_SOLVER (the explicit steppers
// ignore it)
#define BOTH_SOLVERS (SOIL_STEPPER == 2 && SOIL_SOLVER == 2)
constexpr int ENTRY_SOLVER = SOIL_STEPPER == 2 && SOIL_SOLVER != 2 ? SOIL_SOLVER
                                                                   : soil::SOLVER_PCR;

}  // namespace

#define SOIL_CAT2(a, b) a##b
#define SOIL_CAT(a, b) SOIL_CAT2(a, b)

// One entry point per instantiation, named SOIL_ENTRY
// (soil_column_group_rollout_<euler|heun>_richards[_g<G>]_<f32|f64>_nz<NZ>,
// soil_column_group_rollout_implicit_<thomas|pcr|picard>_richards[_g<G>]_
// <f32|f64>_nz<NZ>); the solver (0 Thomas, 1 PCR) and the Picard count as
// the one-thread entries take them: cudaErrorInvalidValue for a solver
// code other than 0 and 1 or, ImplicitEuler, one the entry was not built
// for, a count below 1, or one other than 1 without SOIL_PICARD (the
// explicit steppers read neither). `handoffs`, where not null, receives the
// launch's count of the up and the down sweeps' hand-offs (two unsigned
// 64-bit integers, added to)
extern "C" int SOIL_ENTRY(const SOIL_T* U_in, const SOIL_T* sat_in, const SOIL_T* S_in,
                          SOIL_T* U_out, SOIL_T* sat_out, SOIL_T* S_out, const SOIL_T* top_T,
                          long long top_step_stride, long long top_cell_stride, int series_rows,
                          double series_t0, double series_dts, double time0, const SOIL_T* dz,
                          const SOIL_T* dzf, const SOIL_T* zc, const SOIL_T* zf,
                          const SoilColumnParams* P, int steps, double dt, long long cells,
                          int solver, int picard, unsigned long long* handoffs, void* stream)
{
    static_assert(SOIL_STEPPER >= soil::STEPPER_EULER && SOIL_STEPPER <= soil::STEPPER_IMPLICIT,
                  "the group rollout runs ForwardEuler, Heun and ImplicitEuler");
    static_assert(SOIL_STEPPER == soil::STEPPER_IMPLICIT || !SOIL_PICARD,
                  "Picard iterations are ImplicitEuler's");
    if (picard < 1 || (!SOIL_PICARD && picard != 1) || (solver != 0 && solver != 1)
        || (SOIL_STEPPER == soil::STEPPER_IMPLICIT && !BOTH_SOLVERS && solver != ENTRY_SOLVER))
        return (int)cudaErrorInvalidValue;
#define SOIL_LAUNCH(SOLVER)                                                                    \
    launch<SOIL_T, SOIL_NZ, SOIL_STEPPER, SOLVER>(                                            \
        U_in, sat_in, S_in, U_out, sat_out, S_out, top_T, top_step_stride, top_cell_stride,   \
        series_rows, series_t0, series_dts, time0, dz, dzf, zc, zf, P, steps, dt, cells,      \
        picard, handoffs, (cudaStream_t)stream)
#if BOTH_SOLVERS
    if (solver == soil::SOLVER_THOMAS) return SOIL_LAUNCH(soil::SOLVER_THOMAS);
#endif
    return SOIL_LAUNCH(ENTRY_SOLVER);
#undef SOIL_LAUNCH
}

// The resident warps an SM of the instantiation's kernel (table, or
// `series` != 0; of the solver `solver` names where the entry holds both),
// or -1 where the occupancy query fails; `group` receives its G
extern "C" int SOIL_CAT(SOIL_ENTRY, _warps)(int series, int solver, int* group)
{
#if BOTH_SOLVERS
    if (solver == soil::SOLVER_THOMAS)
        return series ? warps_of<SOIL_STEPPER, soil::SOLVER_THOMAS, true>(group)
                      : warps_of<SOIL_STEPPER, soil::SOLVER_THOMAS, false>(group);
#else
    (void)solver;
#endif
    return series ? warps_of<SOIL_STEPPER, ENTRY_SOLVER, true>(group)
                  : warps_of<SOIL_STEPPER, ENTRY_SOLVER, false>(group);
}
