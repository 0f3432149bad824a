// Host build of terrarium_tpu_torch/csrc/land_group_step.cuh for the CPU
// tests (tests/test_torch_land_group_vjp_host.py and
// tests/test_torch_land_group_rollout_host.py): the land group kernels'
// column code, the segment VJP (land::GroupColumn::segment_vjp: the forward
// by the group's picard_step, each step undone on the group) and the
// rollout (land::GroupColumn::rollout: the group's picard_step with the
// inputs read at each clock time), each group of G lanes emulated by one
// thread in lockstep (soil::HostLanes), and, beside them, the one-thread
// land segment VJP and rollout they replace on the card
// (land::segment_vjp_column and land::rollout_column of implicit_step at
// one Picard iteration, of picard_step at more, and of heun_step), each run
// over every column at float64 behind a plain C interface, ImplicitEuler
// (either solver) or Heun. Built with -DLAND_GROUP_G=<G> it holds the group
// column at that G; without, the one-thread column. The compositions: the
// vegetated bench composition (Brooks-Corey and linear conductivity) at Nz
// 20, 7 and, at the kernel's G, 8, and with a snowpack at Nz 20 and 8; bare
// ground over Van Genuchten and Mualem at Nz 20, with and without a
// snowpack.
#include <vector>

#include "land_group_step.cuh"

namespace {

using land::COND_LINEAR;
using land::COND_MUALEM;
using land::CURVE_BC;
using land::CURVE_VG;

#define LAND_HOST_ARGS                                                                      \
    const LandCarry *in, const LandCarry *gout, const LandCarry *gin,                       \
        const LandInputs *inputs, const double *root, long long root_row_stride,            \
        long long root_cell_stride, const double *dz, const double *dzf, const double *zc, \
        const double *zf, const LandColumnParams<double> *P, double *gparams,               \
        double *scratch, int steps, double dt, long long cells, int iters
#define LAND_HOST_PASS                                                                    \
    in, gout, gin, inputs, root, root_row_stride, root_cell_stride, dz, dzf, zc, zf, P, \
        gparams, scratch, steps, dt, cells, iters

#define LAND_ROLL_ARGS                                                                      \
    const LandCarry *in, const LandCarry *out, const LandInputs *inputs, const double *root, \
        long long root_row_stride, long long root_cell_stride, const double *dz,           \
        const double *dzf, const double *zc, const double *zf,                              \
        const LandColumnParams<double> *P, int steps, double time0, double dt,             \
        long long cells, int iters
#define LAND_ROLL_PASS                                                                      \
    in, out, inputs, root, root_row_stride, root_cell_stride, dz, dzf, zc, zf, P, steps,    \
        time0, dt, cells, iters

// the composition cases each build holds: (NZ, VEG, CURVE, COND, SNOW);
// the stepper is soil::STEPPER_IMPLICIT with the solver 0 (Thomas) or 1
// (PCR), or soil::STEPPER_HEUN (solver 1, unread)
#define LAND_HOST_CASES(X, STEPPER, SOLVER)                        \
    X(20, true, CURVE_BC, COND_LINEAR, false, STEPPER, SOLVER)     \
    X(20, false, CURVE_VG, COND_MUALEM, false, STEPPER, SOLVER)    \
    X(7, true, CURVE_BC, COND_LINEAR, false, STEPPER, SOLVER)      \
    X(20, true, CURVE_BC, COND_LINEAR, true, STEPPER, SOLVER)      \
    X(20, false, CURVE_VG, COND_MUALEM, true, STEPPER, SOLVER)     \
    X(8, true, CURVE_BC, COND_LINEAR, true, STEPPER, SOLVER)
constexpr int HEUN = soil::STEPPER_HEUN, IMPLICIT = soil::STEPPER_IMPLICIT;

#ifdef LAND_GROUP_G
constexpr int G = LAND_GROUP_G;

// land::GroupColumn::segment_vjp of every column on a group of G emulated
// lanes; gparams (2, cells): each column's group sum of its lanes'
// parameter cotangents
template <int NZ, bool VEG, int CURVE, int COND, bool SNOW, int STEPPER, int SOLVER>
void group_columns(LAND_HOST_ARGS)
{
    using Column = land::GroupColumn<double, NZ, G, soil::HostLanes<G>, VEG, CURVE, COND,
                                     SNOW>;
    constexpr int L = Column::L;
    const soil::HostLanes<G> lanes;
    const soil::Consts<double> sc(P->soil);
    auto read = [&](const void* p, const long long i) {
        return p ? static_cast<const double*>(p)[i] : 0.0;
    };
    for (long long col = 0; col < cells; ++col) {
        Column column(lanes, sc, *P, dz, dzf, zc, zf,
                      VEG ? root + col * root_cell_stride : nullptr, root_row_stride);
        double U[G][L], sat[G][L], gU[G][L], gs[G][L];
        for (int i = 0; i < G; ++i) {
            for (int l = 0; l < L; ++l) {
                const int k = column.level(i, l);
                const bool lv = k < NZ;
                U[i][l] = lv ? static_cast<const double*>(in->U)[k * cells + col] : 0.0;
                sat[i][l] = lv ? static_cast<const double*>(in->sat)[k * cells + col] : 0.0;
                gU[i][l] = lv ? read(gout->U, k * cells + col) : 0.0;
                gs[i][l] = lv ? read(gout->sat, k * cells + col) : 0.0;
            }
        }
        land::Surface<double> s{}, gsc{};
        s.S = static_cast<const double*>(in->S)[col];
        s.Ts = static_cast<const double*>(in->Ts)[col];
        if (VEG) {
            s.w = static_cast<const double*>(in->w)[col];
            s.C = static_cast<const double*>(in->C)[col];
            s.nu = static_cast<const double*>(in->nu)[col];
            s.An = static_cast<const double*>(in->An)[col];
        }
        if (SNOW) s.swe = static_cast<const double*>(in->swe)[col];
        gsc.S = read(gout->S, col);
        gsc.Ts = read(gout->Ts, col);
        gsc.w = read(gout->w, col);
        gsc.C = read(gout->C, col);
        gsc.nu = read(gout->nu, col);
        gsc.An = read(gout->An, col);
        if (SNOW) gsc.swe = read(gout->swe, col);
        land::Forcing<double> f;
        for (int i = 0; i < LAND_NIN; ++i)
            f.v[i] = static_cast<const double*>(inputs->ptr[i])[col * inputs->cell_stride[i]];
        double gK[G] = {}, gm[G] = {};
        column.template segment_vjp<STEPPER, SOLVER>(U, sat, s, gU, gs, gsc, scratch, col,
                                                     cells, true, f, *inputs, steps, dt,
                                                     1.0 / dt, iters, gK, gm);
        for (int i = 0; i < G; ++i) {
            for (int l = 0; l < L; ++l) {
                const int k = column.level(i, l);
                if (k < NZ) {
                    static_cast<double*>(gin->U)[k * cells + col] = gU[i][l];
                    static_cast<double*>(gin->sat)[k * cells + col] = gs[i][l];
                }
            }
        }
        static_cast<double*>(gin->Ts)[col] = gsc.Ts;
        static_cast<double*>(gin->S)[col] = gsc.S;
        if (VEG) {
            static_cast<double*>(gin->w)[col] = gsc.w;
            static_cast<double*>(gin->C)[col] = gsc.C;
            static_cast<double*>(gin->nu)[col] = gsc.nu;
            static_cast<double*>(gin->An)[col] = gsc.An;
        }
        if (SNOW) static_cast<double*>(gin->swe)[col] = gsc.swe;
        gparams[col] = column.group_sum(gK);
        gparams[cells + col] = column.group_sum(gm);
    }
}

#define LAND_RUN(NZ_, VEG_, CURVE_, COND_, SNOW_, STEPPER_, SOLVER_)                            \
    if (nz == NZ_ && veg == VEG_ && curve == CURVE_ && cond == COND_ && snow == SNOW_ \
        && stepper == STEPPER_ \
        && (STEPPER_ == HEUN || solver == SOLVER_)) {                                       \
        group_columns<NZ_, VEG_, CURVE_, COND_, SNOW_, STEPPER_, SOLVER_>(LAND_HOST_PASS);        \
        return 0;                                                                         \
    }

// land::GroupColumn::rollout of every column on a group of G emulated
// lanes, as csrc/land_column_group_rollout.cu runs a group
template <int NZ, bool VEG, int CURVE, int COND, bool SNOW, int STEPPER, int SOLVER>
void group_rollouts(LAND_ROLL_ARGS)
{
    using Column = land::GroupColumn<double, NZ, G, soil::HostLanes<G>, VEG, CURVE, COND,
                                     SNOW>;
    constexpr int L = Column::L;
    const soil::HostLanes<G> lanes;
    const soil::Consts<double> sc(P->soil);
    for (long long col = 0; col < cells; ++col) {
        Column column(lanes, sc, *P, dz, dzf, zc, zf,
                      VEG ? root + col * root_cell_stride : nullptr, root_row_stride);
        double U[G][L], sat[G][L];
        for (int i = 0; i < G; ++i) {
            for (int l = 0; l < L; ++l) {
                const int k = column.level(i, l);
                U[i][l] = k < NZ ? static_cast<const double*>(in->U)[k * cells + col] : 0.0;
                sat[i][l] = k < NZ ? static_cast<const double*>(in->sat)[k * cells + col] : 0.0;
            }
        }
        land::Surface<double> s{};
        s.S = static_cast<const double*>(in->S)[col];
        s.Ts = static_cast<const double*>(in->Ts)[col];
        if (VEG) {
            s.w = static_cast<const double*>(in->w)[col];
            s.C = static_cast<const double*>(in->C)[col];
            s.nu = static_cast<const double*>(in->nu)[col];
            s.An = static_cast<const double*>(in->An)[col];
        }
        if (SNOW) s.swe = static_cast<const double*>(in->swe)[col];
        land::Forcing<double> f;
        for (int i = 0; i < LAND_NIN; ++i)
            f.v[i] = static_cast<const double*>(inputs->ptr[i])[col * inputs->cell_stride[i]];
        column.template rollout<STEPPER, SOLVER>(U, sat, s, f, *inputs, col, time0, steps, dt,
                                                 1.0 / dt, iters);
        for (int i = 0; i < G; ++i) {
            for (int l = 0; l < L; ++l) {
                const int k = column.level(i, l);
                if (k < NZ) {
                    static_cast<double*>(out->U)[k * cells + col] = U[i][l];
                    static_cast<double*>(out->sat)[k * cells + col] = sat[i][l];
                }
            }
        }
        static_cast<double*>(out->Ts)[col] = s.Ts;
        static_cast<double*>(out->S)[col] = s.S;
        if (VEG) {
            static_cast<double*>(out->w)[col] = s.w;
            static_cast<double*>(out->C)[col] = s.C;
            static_cast<double*>(out->nu)[col] = s.nu;
            static_cast<double*>(out->An)[col] = s.An;
        }
        if (SNOW) static_cast<double*>(out->swe)[col] = s.swe;
    }
}

#define LAND_ROLL_RUN(NZ_, VEG_, CURVE_, COND_, SNOW_, STEPPER_, SOLVER_)                       \
    if (nz == NZ_ && veg == VEG_ && curve == CURVE_ && cond == COND_ && snow == SNOW_ \
        && stepper == STEPPER_ \
        && (STEPPER_ == HEUN || solver == SOLVER_)) {                                       \
        group_rollouts<NZ_, VEG_, CURVE_, COND_, SNOW_, STEPPER_, SOLVER_>(LAND_ROLL_PASS);       \
        return 0;                                                                         \
    }
#else
// land::segment_vjp_column over every column, one thread a column:
// heun_step and its adjoint; implicit_step and its adjoint at one Picard
// iteration, picard_step and its adjoint at more; gparams (2, cells): each
// column's running sums
template <int NZ, bool VEG, int CURVE, int COND, bool SNOW, int STEPPER, int SOLVER>
void thread_columns(LAND_HOST_ARGS)
{
    const soil::Consts<double> sc(P->soil);
    for (long long col = 0; col < cells; ++col) {
        double gK = 0.0, gm = 0.0;
        if (STEPPER == HEUN)
            land::segment_vjp_column<double, NZ, VEG, true, CURVE, COND, SNOW, HEUN, SOLVER,
                                     false>(
                col, cells, steps, *in, *gout, *gin, scratch, *inputs, root, root_row_stride,
                root_cell_stride, sc, *P, dz, dzf, zc, zf, dt, 1.0 / dt, gK, gm);
        else if (iters == 1)
            land::segment_vjp_column<double, NZ, VEG, true, CURVE, COND, SNOW,
                                     soil::STEPPER_IMPLICIT, SOLVER, false>(
                col, cells, steps, *in, *gout, *gin, scratch, *inputs, root, root_row_stride,
                root_cell_stride, sc, *P, dz, dzf, zc, zf, dt, 1.0 / dt, gK, gm);
        else
            land::segment_vjp_column<double, NZ, VEG, true, CURVE, COND, SNOW,
                                     soil::STEPPER_IMPLICIT, SOLVER, true>(
                col, cells, steps, *in, *gout, *gin, scratch, *inputs, root, root_row_stride,
                root_cell_stride, sc, *P, dz, dzf, zc, zf, dt, 1.0 / dt, gK, gm, iters);
        gparams[col] = gK;
        gparams[cells + col] = gm;
    }
}

#define LAND_RUN(NZ_, VEG_, CURVE_, COND_, SNOW_, STEPPER_, SOLVER_)                            \
    if (nz == NZ_ && veg == VEG_ && curve == CURVE_ && cond == COND_ && snow == SNOW_ \
        && stepper == STEPPER_ \
        && (STEPPER_ == HEUN || solver == SOLVER_)) {                                       \
        thread_columns<NZ_, VEG_, CURVE_, COND_, SNOW_, STEPPER_, SOLVER_>(LAND_HOST_PASS);       \
        return 0;                                                                         \
    }

// land::rollout_column of ImplicitEuler or Heun over every column, one
// thread a column, as csrc/land_column_rollout.cu runs it: heun_step;
// implicit_step at one Picard iteration, picard_step at more
template <int NZ, bool VEG, int CURVE, int COND, bool SNOW, int STEPPER, int SOLVER>
void thread_rollouts(LAND_ROLL_ARGS)
{
    const soil::Consts<double> sc(P->soil);
    for (long long col = 0; col < cells; ++col) {
        if (STEPPER == HEUN)
            land::rollout_column<double, NZ, VEG, true, CURVE, COND, SNOW, HEUN, SOLVER, false>(
                col, cells, *in, *out, *inputs, root, root_row_stride, root_cell_stride, sc, *P,
                dz, dzf, zc, zf, steps, time0, dt, 1.0 / dt);
        else if (iters == 1)
            land::rollout_column<double, NZ, VEG, true, CURVE, COND, SNOW,
                                 soil::STEPPER_IMPLICIT, SOLVER, false>(
                col, cells, *in, *out, *inputs, root, root_row_stride, root_cell_stride, sc, *P,
                dz, dzf, zc, zf, steps, time0, dt, 1.0 / dt);
        else
            land::rollout_column<double, NZ, VEG, true, CURVE, COND, SNOW,
                                 soil::STEPPER_IMPLICIT, SOLVER, true>(
                col, cells, *in, *out, *inputs, root, root_row_stride, root_cell_stride, sc, *P,
                dz, dzf, zc, zf, steps, time0, dt, 1.0 / dt, iters);
    }
}

#define LAND_ROLL_RUN(NZ_, VEG_, CURVE_, COND_, SNOW_, STEPPER_, SOLVER_)                       \
    if (nz == NZ_ && veg == VEG_ && curve == CURVE_ && cond == COND_ && snow == SNOW_ \
        && stepper == STEPPER_ \
        && (STEPPER_ == HEUN || solver == SOLVER_)) {                                       \
        thread_rollouts<NZ_, VEG_, CURVE_, COND_, SNOW_, STEPPER_, SOLVER_>(LAND_ROLL_PASS);      \
        return 0;                                                                         \
    }
#endif

}  // namespace

// The segment VJP of `steps` steps of `stepper` (soil::STEPPER_HEUN, or
// STEPPER_IMPLICIT with `iters` Picard iterations and the solver `solver`,
// 0 Thomas or 1 PCR) over the land composition (veg, curve 0 Van Genuchten
// or 1 Brooks-Corey, cond 0 Mualem or 1 linear, Richards flow; a snowpack
// where snow) at nz levels, on groups of the build's G lanes or one thread
// a column: the input cotangents to gin, each column's parameter
// cotangents to gparams (2, cells), each step's stored input carry to
// scratch (steps, 2 nz + 6 + snow, cells). Returns -1 for a case the build
// does not hold, else 0.
extern "C" int host_land_vjp(LAND_HOST_ARGS, int nz, int veg, int curve, int cond, int snow,
                             int solver, int stepper)
{
    if (iters < 1 || (stepper == HEUN && iters != 1)) return -1;
    LAND_HOST_CASES(LAND_RUN, IMPLICIT, 0)
    LAND_HOST_CASES(LAND_RUN, IMPLICIT, 1)
    LAND_HOST_CASES(LAND_RUN, HEUN, 1)
#ifdef LAND_GROUP_G
    // the fused-gradient cases against JAX, at the kernel's G of each scheme
    if constexpr (G == land::implicit_group_lanes(8, 0))
        LAND_RUN(8, true, CURVE_BC, COND_LINEAR, false, IMPLICIT, 0)
    if constexpr (G == land::implicit_group_lanes(8, 1))
        LAND_RUN(8, true, CURVE_BC, COND_LINEAR, false, IMPLICIT, 1)
    if constexpr (G == land::heun_group_lanes(8))
        LAND_RUN(8, true, CURVE_BC, COND_LINEAR, false, HEUN, 1)
#endif
    return -1;
}

// The rollout of `steps` steps of `stepper` (as host_land_vjp's) over the
// land composition (as host_land_vjp's) at nz levels from clock time time0,
// the inputs read at each clock time (Heun's stage at t + dt too), on
// groups of the build's G lanes or one thread a column: the output carry to
// out. Returns -1 for a case the build does not hold, else 0.
extern "C" int host_land_rollout(LAND_ROLL_ARGS, int nz, int veg, int curve, int cond,
                                 int snow, int solver, int stepper)
{
    if (iters < 1 || (stepper == HEUN && iters != 1)) return -1;
    LAND_HOST_CASES(LAND_ROLL_RUN, IMPLICIT, 0)
    LAND_HOST_CASES(LAND_ROLL_RUN, IMPLICIT, 1)
    LAND_HOST_CASES(LAND_ROLL_RUN, HEUN, 1)
#ifdef LAND_GROUP_G
    // the case against JAX's interpret-mode kernel, at the kernel's G of PCR
    if constexpr (G == land::rollout_group_lanes(8, 1))
        LAND_ROLL_RUN(8, true, CURVE_BC, COND_LINEAR, false, IMPLICIT, 1)
#endif
    return -1;
}

// the group size of the rollout kernel at nz levels of the stepper (and
// solver)
extern "C" int host_land_rollout_group_lanes(int nz, int solver, int stepper)
{
    return stepper == HEUN ? land::heun_rollout_group_lanes(nz)
                           : land::rollout_group_lanes(nz, solver);
}

// the group size of the segment-VJP kernel at nz levels of the stepper (and
// solver)
extern "C" int host_land_group_lanes(int nz, int solver, int stepper)
{
    return stepper == HEUN ? land::heun_group_lanes(nz) : land::implicit_group_lanes(nz, solver);
}
