// Host build of terrarium_tpu_torch/csrc/land_group_step.cuh for the CPU
// tests (tests/test_torch_land_group_vjp_host.py): the land group
// segment-VJP kernel's column code (land::GroupColumn::segment_vjp: the
// forward by the group's picard_step, each step undone on the group), each
// group of G lanes emulated by one thread in lockstep (soil::HostLanes),
// and, beside it, the one-thread land segment VJP it replaces on the card
// (land::segment_vjp_column of implicit_step at one Picard iteration, of
// picard_step at more), each run over every column at float64 behind a
// plain C interface. Built with -DLAND_GROUP_G=<G> it holds the group
// column at that G; without, the one-thread column. The compositions: the
// vegetated bench composition (Brooks-Corey and linear conductivity) at Nz
// 20, 7 and, at the kernel's G, 8; bare ground over Van Genuchten and
// Mualem at Nz 20.
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

// the composition cases each build holds: (NZ, VEG, CURVE, COND); the
// solver is 0 (Thomas) or 1 (PCR)
#define LAND_HOST_CASES(X, SOLVER)                      \
    X(20, true, CURVE_BC, COND_LINEAR, SOLVER)          \
    X(20, false, CURVE_VG, COND_MUALEM, SOLVER)         \
    X(7, true, CURVE_BC, COND_LINEAR, SOLVER)

#ifdef LAND_GROUP_G
constexpr int G = LAND_GROUP_G;

// land::GroupColumn::segment_vjp of every column on a group of G emulated
// lanes; gparams (2, cells): each column's group sum of its lanes'
// parameter cotangents
template <int NZ, bool VEG, int CURVE, int COND, int SOLVER>
void group_columns(LAND_HOST_ARGS)
{
    using Column = land::GroupColumn<double, NZ, G, soil::HostLanes<G>, VEG, CURVE, COND>;
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
        gsc.S = read(gout->S, col);
        gsc.Ts = read(gout->Ts, col);
        gsc.w = read(gout->w, col);
        gsc.C = read(gout->C, col);
        gsc.nu = read(gout->nu, col);
        gsc.An = read(gout->An, col);
        land::Forcing<double> f;
        for (int i = 0; i < LAND_NIN; ++i)
            f.v[i] = static_cast<const double*>(inputs->ptr[i])[col * inputs->cell_stride[i]];
        double gK[G] = {}, gm[G] = {};
        column.template segment_vjp<SOLVER>(U, sat, s, gU, gs, gsc, scratch, col, cells, true,
                                            f, steps, dt, 1.0 / dt, iters, gK, gm);
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
        gparams[col] = column.group_sum(gK);
        gparams[cells + col] = column.group_sum(gm);
    }
}

#define LAND_RUN(NZ_, VEG_, CURVE_, COND_, SOLVER_)                                     \
    if (nz == NZ_ && veg == VEG_ && curve == CURVE_ && cond == COND_ && solver == SOLVER_) { \
        group_columns<NZ_, VEG_, CURVE_, COND_, SOLVER_>(LAND_HOST_PASS);               \
        return 0;                                                                       \
    }
#else
// land::segment_vjp_column over every column, one thread a column:
// implicit_step and its adjoint at one Picard iteration, picard_step and
// its adjoint at more; gparams (2, cells): each column's running sums
template <int NZ, bool VEG, int CURVE, int COND, int SOLVER>
void thread_columns(LAND_HOST_ARGS)
{
    const soil::Consts<double> sc(P->soil);
    for (long long col = 0; col < cells; ++col) {
        double gK = 0.0, gm = 0.0;
        if (iters == 1)
            land::segment_vjp_column<double, NZ, VEG, true, CURVE, COND, false,
                                     soil::STEPPER_IMPLICIT, SOLVER, false>(
                col, cells, steps, *in, *gout, *gin, scratch, *inputs, root, root_row_stride,
                root_cell_stride, sc, *P, dz, dzf, zc, zf, dt, 1.0 / dt, gK, gm);
        else
            land::segment_vjp_column<double, NZ, VEG, true, CURVE, COND, false,
                                     soil::STEPPER_IMPLICIT, SOLVER, true>(
                col, cells, steps, *in, *gout, *gin, scratch, *inputs, root, root_row_stride,
                root_cell_stride, sc, *P, dz, dzf, zc, zf, dt, 1.0 / dt, gK, gm, iters);
        gparams[col] = gK;
        gparams[cells + col] = gm;
    }
}

#define LAND_RUN(NZ_, VEG_, CURVE_, COND_, SOLVER_)                                     \
    if (nz == NZ_ && veg == VEG_ && curve == CURVE_ && cond == COND_ && solver == SOLVER_) { \
        thread_columns<NZ_, VEG_, CURVE_, COND_, SOLVER_>(LAND_HOST_PASS);              \
        return 0;                                                                       \
    }
#endif

}  // namespace

// The segment VJP of `steps` ImplicitEuler steps with `iters` Picard
// iterations and the solver `solver` (0 Thomas, 1 PCR) over the land
// composition (veg, curve 0 Van Genuchten or 1 Brooks-Corey, cond 0 Mualem
// or 1 linear; Richards flow, no snowpack) at nz levels, on groups of the
// build's G lanes or one thread a column: the input cotangents to gin, each
// column's parameter cotangents to gparams (2, cells), each step's stored
// input carry to scratch (steps, 2 nz + 6, cells). Returns -1 for a case the
// build does not hold, else 0.
extern "C" int host_land_vjp(LAND_HOST_ARGS, int nz, int veg, int curve, int cond, int solver)
{
    if (iters < 1) return -1;
    LAND_HOST_CASES(LAND_RUN, 0)
    LAND_HOST_CASES(LAND_RUN, 1)
#ifdef LAND_GROUP_G
    // the fused-gradient case against JAX, at the kernel's G of each solver
    if constexpr (G == land::implicit_group_lanes(8, 0)) LAND_RUN(8, true, CURVE_BC, COND_LINEAR, 0)
    if constexpr (G == land::implicit_group_lanes(8, 1)) LAND_RUN(8, true, CURVE_BC, COND_LINEAR, 1)
#endif
    return -1;
}

// the group size of the kernel at nz levels with the solver
extern "C" int host_land_group_lanes(int nz, int solver)
{
    return land::implicit_group_lanes(nz, solver);
}
