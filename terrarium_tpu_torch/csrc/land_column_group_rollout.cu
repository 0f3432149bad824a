// LandModel ImplicitEuler and Heun rollouts for Hopper (sm_90a), a column
// on a group of lanes: ImplicitEuler with Thomas or PCR solves and any
// number of Picard iterations, or Heun; Richards flow, with or without
// vegetation, either retention curve and conductivity, with or without a
// snowpack (LAND_SNOW); static inputs or uniform series read at each clock
// time (Heun's stage at t + dt too).
//
// Replaces terrarium_tpu/ops/fused_step.py::make_fused_lean_rollout
// (kernel body :507, pallas_call :557) traced over a LandModel
// ImplicitEuler step (terrarium_tpu/timesteppers/implicit.py:173, the
// Picard loop :234-254) or Heun step (terrarium_tpu/timesteppers/
// stepping.py:167-188), with a Snowpack (terrarium_tpu/processes/snow.py:69)
// where LAND_SNOW. csrc/land_column_rollout.cu runs every other land
// rollout (NoFlow, ForwardEuler), one thread a column.
//
// A column runs on a group of G lanes of one warp, L = ceil(NZ / G) soil
// levels a lane (land::GroupColumn in land_group_step.cuh, built on
// soil::GroupColumn; G from land::rollout_group_lanes(NZ, SOLVER) or
// land::heun_rollout_group_lanes(NZ), or SOIL_GROUP where a build defines
// it), and the group applies `steps` steps of GroupColumn::picard_step or
// GroupColumn::heun_step, the step the land group segment VJP
// (csrc/land_column_group_segment_vjp.cu) recomputes with: so at the same G
// the carries that the VJP stores equal this kernel's bit for bit (the land
// gradient's forward segments launch a g<G> build at the VJP's G). The
// carry is read once and written once per launch, a lane its own levels;
// the surface carry (pool, skin temperature, canopy water, carbon,
// vegetation fraction, net assimilation, SWE) and the inputs are one copy a
// thread, the same on every lane of the group. The inputs are read at each
// clock time (land::read_series: a uniform series from its two rows around
// the time, each with its own origin; a static value once), the clock
// advanced by the same repeated addition as Clock.tick.
//
// What bounds it on this card: the instructions a thread issues. One
// thread a column held the 20 soil levels, both tridiagonal systems and
// their solves unrolled in 255 registers with 412-660 bytes of spill
// stores, 8 resident warps an SM, two waves at 56,951 columns; on a group a
// lane holds its L levels' rows and a PCR round or a Thomas hand-off at a
// time (Nz 20 f32, G 4: 128 registers, 284 bytes of spill stores, 16
// warps). The surface block, one value a column, runs on every lane of a
// group, so it costs G times one column's issue slots: a launch gains only
// 1.06-1.16x over one thread a column (PERF.md sections 6 and 7); Heun,
// two surface blocks a step and no solve to spread, about 1.0-1.16x (G 4,
// 3 blocks: 80 registers, 492 bytes of spill stores, 24 warps).
//
// Memory layout: fields are (NZ, cells), k = 0 the bottom layer; element
// (k, col) at k * cells + col. The groups of the last block beyond `cells`
// run the last column again and write nothing, so that every warp is whole
// in the exchanges.
//
// Plain C interface, loaded with ctypes: one entry point per instantiation
// (SOIL_ENTRY, with SOIL_T, SOIL_NZ, LAND_VEG, LAND_RICHARDS 1, LAND_CURVE,
// LAND_COND, LAND_SNOW, SOIL_STEPPER 1 Heun or 2 ImplicitEuler, the last with
// SOIL_SOLVER 0 Thomas, 1 PCR or 2 both, a kernel each, and SOIL_PICARD),
// with the arguments of csrc/land_column_rollout.cu's
// entries, launching the kernel of the solver that its `solver` argument
// names and returning cudaGetLastError(); and <SOIL_ENTRY>_warps, the
// kernel's resident warps an SM and its G.

#include <cuda_runtime.h>

#include "land_group_step.cuh"

#if !defined(SOIL_ENTRY) || !defined(SOIL_T) || !defined(SOIL_NZ) || !defined(LAND_VEG) || \
    !defined(LAND_RICHARDS)
#error "build with -DSOIL_ENTRY=<name> -DSOIL_T=float|double -DSOIL_NZ=<levels> -DLAND_VEG=0|1 -DLAND_RICHARDS=1 -DLAND_CURVE=0|1 -DLAND_COND=0|1 [-DLAND_SNOW=1] -DSOIL_STEPPER=1|2 [-DSOIL_SOLVER=0|1|2 -DSOIL_PICARD=1] [-DSOIL_GROUP=<lanes>] [-DSOIL_MIN_BLOCKS=<blocks>]"
#endif
#if !LAND_RICHARDS || !defined(SOIL_STEPPER) || (SOIL_STEPPER != 1 && SOIL_STEPPER != 2)
#error "the land group rollout runs ImplicitEuler or Heun over Richards flow"
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

// resident blocks an SM that __launch_bounds__ asks of the kernels, or
// SOIL_MIN_BLOCKS where a build defines it. Measured at Nz 20 f32 at G 4
// (an H100 80GB HBM3 at 700 W, rollout_layout_ab.py land_time, PERF.md
// section 6; 48 steps, one and two Picard iterations): PCR 1 to 4 blocks
// 14.39/28.42, 8.95/17.35 (128 registers, 284 bytes of spill stores, 16
// warps), 9.48/17.09 and 9.03/18.62 ms; Thomas 10.72/20.59, 6.69/13.04 (128
// registers, 288 bytes), 6.33/13.87 and 7.17/14.33 ms: 2 for both. Heun
// at G 4 (rollout_layout_ab.py land_heun_time, 48 steps of 600 s, and of
// 60 s at the gradient's static inputs): 13.11/13.68, 7.89/8.25 (128
// registers, 128 bytes), 6.86/6.41 (80 registers, 492 bytes, 24 warps) and
// 7.13/5.81 ms: 3. PCR with a snowpack at G 4 (rollout_layout_ab.py
// land_snow_time, 48 steps of 600 s with two series, and at the gradient's
// static inputs): 14.71/14.84, 9.13/9.17 (128 registers, 316 bytes),
// 8.18/7.86 (80 registers, 756 bytes, 24 warps) and 8.98/8.93 ms: 3
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
    return STEPPER == soil::STEPPER_HEUN ? land::heun_rollout_group_lanes(NZ)
                                         : land::rollout_group_lanes(NZ, SOLVER);
#endif
}

template <typename T, int NZ, int G, int STEPPER, int SOLVER>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) land_column_group_rollout_kernel(
    const LandCarry in, const LandCarry out, const LandInputs inputs,
    const T* __restrict__ root, const long long root_row_stride,
    const long long root_cell_stride, const T* __restrict__ dz_g, const T* __restrict__ dzf_g,
    const T* __restrict__ zc_g, const T* __restrict__ zf_g, const LandColumnParams<T> P,
    const int steps, const T time0, const T dt, const T inv_dt, const long long cells,
    const int iters)
{
    constexpr bool VEG = LAND_VEG != 0, SNOW = LAND_SNOW != 0;
    using Lanes = soil::WarpLanes<G>;
    using Column = land::GroupColumn<T, NZ, G, Lanes, VEG, LAND_CURVE, LAND_COND, SNOW>;
    constexpr int L = Column::L;
    const long long group = ((long long)blockIdx.x * THREADS + threadIdx.x) / G;
    const bool live = group < cells;
    const long long col = live ? group : cells - 1;

    const Lanes lanes;
    const soil::Consts<T> sc(P.soil);
    Column column(lanes, sc, P, dz_g, dzf_g, zc_g, zf_g,
                  VEG ? root + col * root_cell_stride : nullptr, root_row_stride);
    T U[1][L], sat[1][L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
        const int k = column.level(0, l);
        U[0][l] = k < NZ ? static_cast<const T*>(in.U)[k * cells + col] : T(0);
        sat[0][l] = k < NZ ? static_cast<const T*>(in.sat)[k * cells + col] : T(0);
    }
    land::Surface<T> s{};
    s.S = static_cast<const T*>(in.S)[col];
    s.Ts = static_cast<const T*>(in.Ts)[col];
    if (VEG) {
        s.w = static_cast<const T*>(in.w)[col];
        s.C = static_cast<const T*>(in.C)[col];
        s.nu = static_cast<const T*>(in.nu)[col];
        s.An = static_cast<const T*>(in.An)[col];
    }
    if (SNOW) s.swe = static_cast<const T*>(in.swe)[col];
    land::Forcing<T> f;
#pragma unroll
    for (int i = 0; i < LAND_NIN; ++i)
        f.v[i] = static_cast<const T*>(inputs.ptr[i])[col * inputs.cell_stride[i]];

    column.template rollout<STEPPER, SOLVER>(U, sat, s, f, inputs, col, time0, steps, dt, inv_dt,
                                              iters);
    if (!live) return;
#pragma unroll
    for (int l = 0; l < L; ++l) {
        const int k = column.level(0, l);
        if (k < NZ) {
            static_cast<T*>(out.U)[k * cells + col] = U[0][l];
            static_cast<T*>(out.sat)[k * cells + col] = sat[0][l];
        }
    }
    if (lanes.id == 0) {
        static_cast<T*>(out.Ts)[col] = s.Ts;
        static_cast<T*>(out.S)[col] = s.S;
        if (VEG) {
            static_cast<T*>(out.w)[col] = s.w;
            static_cast<T*>(out.C)[col] = s.C;
            static_cast<T*>(out.nu)[col] = s.nu;
            static_cast<T*>(out.An)[col] = s.An;
        }
        if (SNOW) static_cast<T*>(out.swe)[col] = s.swe;
    }
}

template <typename T, int NZ, int STEPPER, int SOLVER>
int launch(const LandCarry* in, const LandCarry* out, const LandInputs* inputs, const T* root,
           long long root_row_stride, long long root_cell_stride, const T* dz, const T* dzf,
           const T* zc, const T* zf, const LandColumnParams<T>* P, int steps, double time0,
           double dt, long long cells, int iters, cudaStream_t stream)
{
    constexpr int G = group_of<NZ, STEPPER, SOLVER>();
    const unsigned blocks = (unsigned)((cells * G + THREADS - 1) / THREADS);
    land_column_group_rollout_kernel<T, NZ, G, STEPPER, SOLVER><<<blocks, THREADS, 0, stream>>>(
        *in, *out, *inputs, root, root_row_stride, root_cell_stride, dz, dzf, zc, zf, *P, steps,
        T(time0), T(dt), T(1.0 / dt), cells, iters);
    return (int)cudaGetLastError();
}

// the resident warps an SM of the kernel of SOLVER and its group size
template <int SOLVER>
int warps_of(int* group)
{
    constexpr int G = group_of<SOIL_NZ, SOIL_STEPPER, SOLVER>();
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, land_column_group_rollout_kernel<SOIL_T, SOIL_NZ, G, SOIL_STEPPER, SOLVER>,
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
// (land_column_group_rollout_<heun|implicit_<thomas|pcr|picard>>_<bare|veg>_
// richards_<vg|bc>_<mualem|linear>[_snow][_g<G>][_mb<B>]_<f32|f64>_nz<NZ>), with the
// arguments of the one-thread land rollout's entries
// (csrc/land_column_rollout.cu): cudaErrorInvalidValue for a solver code
// other than 0 and 1 or, ImplicitEuler's, one the entry was not built for,
// a Picard count below 1, or one other than 1 without SOIL_PICARD.
extern "C" int SOIL_ENTRY(const LandCarry* in, const LandCarry* out, const LandInputs* inputs,
                          const SOIL_T* root, long long root_row_stride,
                          long long root_cell_stride, const SOIL_T* dz, const SOIL_T* dzf,
                          const SOIL_T* zc, const SOIL_T* zf, const LandColumnParams<SOIL_T>* P,
                          int steps, double time0, double dt, long long cells, int solver,
                          int picard, void* stream)
{
    static_assert(SOIL_STEPPER == soil::STEPPER_IMPLICIT || !SOIL_PICARD,
                  "the Picard iterations are ImplicitEuler's");
    if (picard < 1 || (!SOIL_PICARD && picard != 1) || (solver != 0 && solver != 1)
        || (SOIL_STEPPER == soil::STEPPER_IMPLICIT && !BOTH_SOLVERS && solver != ENTRY_SOLVER))
        return (int)cudaErrorInvalidValue;
#define SOIL_LAUNCH(SOLVER)                                                                    \
    launch<SOIL_T, SOIL_NZ, SOIL_STEPPER, SOLVER>(in, out, inputs, root, root_row_stride,      \
                                                  root_cell_stride, dz, dzf, zc, zf, P, steps, \
                                                  time0, dt, cells, picard,                   \
                                                  (cudaStream_t)stream)
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
