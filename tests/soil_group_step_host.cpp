// Host build of terrarium_tpu_torch/csrc/soil_group_step.cuh for the CPU
// tests (tests/test_torch_group_step_host.py and, for ImplicitEuler,
// tests/test_torch_group_implicit_host.py): the group rollout kernel's
// column code, each group of G lanes emulated by one thread in lockstep
// (soil::HostLanes), beside the one-thread-a-column rollout loop it
// replaces on the card (soil::rollout_column of soil_step.cuh), each run
// over every column behind a plain C interface. Built with
// -DSOIL_GROUP_VJP_HOST (tests/test_torch_group_vjp_host.py), the group
// segment-VJP kernel's column code (soil::GroupColumn::segment_vjp of
// ForwardEuler, Heun and picard_step) beside the one-thread segment VJP it
// replaces (soil::segment_vjp_column of the same stepper), and the
// implicit group step, instead of the group rollout's explicit steppers and
// the one-thread implicit step.
#include <vector>

#include "soil_group_step.cuh"

namespace {

#define ROLLOUT_ARGS U, sat, S, top, step_stride, cell_stride, rows, t0, dts, time0, dz, dzf, \
                     zc, zf, P, steps, dt, cells

#ifndef SOIL_GROUP_VJP_HOST
// soil::rollout_column over every column: ForwardEuler or Heun, heat +
// Richards, the top temperature from a table or (rows > 0) a series
template <int NZ, int STEPPER, bool SERIES>
void thread_columns(double* U, double* sat, double* S, const double* top,
                    long long step_stride, long long cell_stride, int rows, double t0,
                    double dts, double time0, const double* dz, const double* dzf,
                    const double* zc, const double* zf, const SoilColumnParams* P, int steps,
                    double dt, long long cells)
{
    const soil::Consts<double> c(*P);
    for (long long col = 0; col < cells; ++col) {
        double u[NZ], s[NZ];
        for (int k = 0; k < NZ; ++k) { u[k] = U[k * cells + col]; s[k] = sat[k * cells + col]; }
        double sv = S[col];
        soil::rollout_column<double, NZ, STEPPER, 0, false, SERIES>(
            u, s, sv, top + col * cell_stride, step_stride, rows, t0, dts, time0, steps, c, *P,
            dz, dzf, zc, zf, dt, 1.0 / dt);
        for (int k = 0; k < NZ; ++k) { U[k * cells + col] = u[k]; sat[k * cells + col] = s[k]; }
        S[col] = sv;
    }
}

// soil::GroupColumn::rollout over every column on a group of G emulated
// lanes; each column's hand-offs to handoffs[col] (up sweep) and
// handoffs[cells + col] (down sweep) where handoffs is not null
template <int NZ, int G, int STEPPER, bool SERIES>
void group_columns(double* U, double* sat, double* S, const double* top, long long step_stride,
                   long long cell_stride, int rows, double t0, double dts, double time0,
                   const double* dz, const double* dzf, const double* zc, const double* zf,
                   const SoilColumnParams* P, int steps, double dt, long long cells,
                   unsigned long long* handoffs)
{
    using Column = soil::GroupColumn<double, NZ, G, soil::HostLanes<G>>;
    constexpr int L = Column::L;
    const soil::HostLanes<G> lanes;
    const soil::Consts<double> c(*P);
    for (long long col = 0; col < cells; ++col) {
        Column column(lanes, c, *P, dz, dzf, zc, zf);
        double u[G][L], s[G][L];
        for (int i = 0; i < G; ++i)
            for (int l = 0; l < L; ++l) {
                const int k = column.level(i, l);
                u[i][l] = k < NZ ? U[k * cells + col] : 0.0;
                s[i][l] = k < NZ ? sat[k * cells + col] : 0.0;
            }
        double sv = S[col];
        column.template rollout<STEPPER, SERIES>(u, s, sv, top + col * cell_stride, step_stride,
                                                 rows, t0, dts, time0, steps, dt);
        for (int i = 0; i < G; ++i)
            for (int l = 0; l < L; ++l) {
                const int k = column.level(i, l);
                if (k < NZ) { U[k * cells + col] = u[i][l]; sat[k * cells + col] = s[i][l]; }
            }
        S[col] = sv;
        if (handoffs) {
            handoffs[col] = column.up_handoffs;
            handoffs[cells + col] = column.down_handoffs;
        }
    }
}

template <int NZ>
int thread_scheme(int stepper, double* U, double* sat, double* S, const double* top,
                  long long step_stride, long long cell_stride, int rows, double t0, double dts,
                  double time0, const double* dz, const double* dzf, const double* zc,
                  const double* zf, const SoilColumnParams* P, int steps, double dt,
                  long long cells)
{
    if (stepper == soil::STEPPER_EULER) {
        if (rows > 0) thread_columns<NZ, soil::STEPPER_EULER, true>(ROLLOUT_ARGS);
        else thread_columns<NZ, soil::STEPPER_EULER, false>(ROLLOUT_ARGS);
    } else if (stepper == soil::STEPPER_HEUN) {
        if (rows > 0) thread_columns<NZ, soil::STEPPER_HEUN, true>(ROLLOUT_ARGS);
        else thread_columns<NZ, soil::STEPPER_HEUN, false>(ROLLOUT_ARGS);
    } else {
        return -1;
    }
    return 0;
}

template <int NZ, int G>
int group_scheme(int stepper, double* U, double* sat, double* S, const double* top,
                 long long step_stride, long long cell_stride, int rows, double t0, double dts,
                 double time0, const double* dz, const double* dzf, const double* zc,
                 const double* zf, const SoilColumnParams* P, int steps, double dt,
                 long long cells, unsigned long long* handoffs)
{
    if (stepper == soil::STEPPER_EULER) {
        if (rows > 0) group_columns<NZ, G, soil::STEPPER_EULER, true>(ROLLOUT_ARGS, handoffs);
        else group_columns<NZ, G, soil::STEPPER_EULER, false>(ROLLOUT_ARGS, handoffs);
    } else if (stepper == soil::STEPPER_HEUN) {
        if (rows > 0) group_columns<NZ, G, soil::STEPPER_HEUN, true>(ROLLOUT_ARGS, handoffs);
        else group_columns<NZ, G, soil::STEPPER_HEUN, false>(ROLLOUT_ARGS, handoffs);
    } else {
        return -1;
    }
    return 0;
}

// the kernel's group size at NZ, 4 (carries across many lanes) or 32 (a
// level a lane, the lanes above NZ empty)
template <int NZ>
int group_of(int g, int stepper, double* U, double* sat, double* S, const double* top,
             long long step_stride, long long cell_stride, int rows, double t0, double dts,
             double time0, const double* dz, const double* dzf, const double* zc,
             const double* zf, const SoilColumnParams* P, int steps, double dt, long long cells,
             unsigned long long* handoffs)
{
    constexpr int G = soil::group_lanes(NZ);
    if (g == G) return group_scheme<NZ, G>(stepper, ROLLOUT_ARGS, handoffs);
    if (g == 4) return group_scheme<NZ, 4>(stepper, ROLLOUT_ARGS, handoffs);
    if (g == 32) return group_scheme<NZ, 32>(stepper, ROLLOUT_ARGS, handoffs);
    return -1;
}

// soil::rollout_column of picard_step over every column: ImplicitEuler
// with `iters` Picard iterations and `solver` (0 Thomas, 1 PCR), heat +
// Richards, the top temperature from a table or (SERIES) a series
template <int NZ, bool SERIES>
void thread_picard_columns(double* U, double* sat, double* S, const double* top,
                           long long step_stride, long long cell_stride, int rows, double t0,
                           double dts, double time0, const double* dz, const double* dzf,
                           const double* zc, const double* zf, const SoilColumnParams* P,
                           int steps, double dt, long long cells, int solver, int iters)
{
    const soil::Consts<double> c(*P);
    for (long long col = 0; col < cells; ++col) {
        double u[NZ], s[NZ];
        for (int k = 0; k < NZ; ++k) { u[k] = U[k * cells + col]; s[k] = sat[k * cells + col]; }
        double sv = S[col];
        soil::rollout_column<double, NZ, soil::STEPPER_IMPLICIT, soil::SOLVER_RUNTIME, false,
                             SERIES, true>(u, s, sv, top + col * cell_stride, step_stride, rows,
                                           t0, dts, time0, steps, c, *P, dz, dzf, zc, zf, dt,
                                           1.0 / dt, iters, solver);
        for (int k = 0; k < NZ; ++k) { U[k * cells + col] = u[k]; sat[k * cells + col] = s[k]; }
        S[col] = sv;
    }
}

#endif

// soil::GroupColumn::rollout of ImplicitEuler (picard_step with SOLVER and
// `iters` Picard iterations) over every column on a group of G emulated
// lanes
template <int NZ, int G, int SOLVER, bool SERIES>
void group_picard_columns(double* U, double* sat, double* S, const double* top,
                          long long step_stride, long long cell_stride, int rows, double t0,
                          double dts, double time0, const double* dz, const double* dzf,
                          const double* zc, const double* zf, const SoilColumnParams* P,
                          int steps, double dt, long long cells, int iters)
{
    using Column = soil::GroupColumn<double, NZ, G, soil::HostLanes<G>>;
    constexpr int L = Column::L;
    const soil::HostLanes<G> lanes;
    const soil::Consts<double> c(*P);
    for (long long col = 0; col < cells; ++col) {
        Column column(lanes, c, *P, dz, dzf, zc, zf);
        double u[G][L], s[G][L];
        for (int i = 0; i < G; ++i)
            for (int l = 0; l < L; ++l) {
                const int k = column.level(i, l);
                u[i][l] = k < NZ ? U[k * cells + col] : 0.0;
                s[i][l] = k < NZ ? sat[k * cells + col] : 0.0;
            }
        double sv = S[col];
        column.template rollout<soil::STEPPER_IMPLICIT, SERIES, SOLVER>(
            u, s, sv, top + col * cell_stride, step_stride, rows, t0, dts, time0, steps, dt,
            1.0 / dt, iters);
        for (int i = 0; i < G; ++i)
            for (int l = 0; l < L; ++l) {
                const int k = column.level(i, l);
                if (k < NZ) { U[k * cells + col] = u[i][l]; sat[k * cells + col] = s[i][l]; }
            }
        S[col] = sv;
    }
}

#ifndef SOIL_GROUP_VJP_HOST
template <int NZ>
int thread_picard(double* U, double* sat, double* S, const double* top, long long step_stride,
                  long long cell_stride, int rows, double t0, double dts, double time0,
                  const double* dz, const double* dzf, const double* zc, const double* zf,
                  const SoilColumnParams* P, int steps, double dt, long long cells, int solver,
                  int iters)
{
    if (rows > 0) thread_picard_columns<NZ, true>(ROLLOUT_ARGS, solver, iters);
    else thread_picard_columns<NZ, false>(ROLLOUT_ARGS, solver, iters);
    return 0;
}

#endif

template <int NZ, int G>
int group_picard(int solver, double* U, double* sat, double* S, const double* top,
                 long long step_stride, long long cell_stride, int rows, double t0, double dts,
                 double time0, const double* dz, const double* dzf, const double* zc,
                 const double* zf, const SoilColumnParams* P, int steps, double dt,
                 long long cells, int iters)
{
    if (solver == soil::SOLVER_PCR) {
        if (rows > 0) group_picard_columns<NZ, G, soil::SOLVER_PCR, true>(ROLLOUT_ARGS, iters);
        else group_picard_columns<NZ, G, soil::SOLVER_PCR, false>(ROLLOUT_ARGS, iters);
    } else if (solver == soil::SOLVER_THOMAS) {
        if (rows > 0) group_picard_columns<NZ, G, soil::SOLVER_THOMAS, true>(ROLLOUT_ARGS, iters);
        else group_picard_columns<NZ, G, soil::SOLVER_THOMAS, false>(ROLLOUT_ARGS, iters);
    } else {
        return -1;
    }
    return 0;
}

#ifdef SOIL_GROUP_VJP_HOST
#define VJP_ARGS U, sat, S, gU, gsat, gS, gU0, gsat0, gS0, gparams, top, step_stride, \
                 cell_stride, dz, dzf, zc, zf, P, steps, dt, cells, iters

// soil::segment_vjp_column of picard_step (the one-thread segment VJP's
// column code, `solver` at run time) over every column; each column's
// parameter cotangents to gparams[col] (K_sat) and gparams[cells + col]
// (sk_mineral)
template <int NZ>
void thread_vjp_columns(int solver, const double* U, const double* sat, const double* S,
                        const double* gU, const double* gsat, const double* gS, double* gU0,
                        double* gsat0, double* gS0, double* gparams, const double* top,
                        long long step_stride, long long cell_stride, const double* dz,
                        const double* dzf, const double* zc, const double* zf,
                        const SoilColumnParams* P, int steps, double dt, long long cells,
                        int iters)
{
    std::vector<double> scratch((size_t)steps * (2 * NZ + 1) * cells);
    const soil::Consts<double> c(*P);
    for (long long col = 0; col < cells; ++col) {
        double gK = 0.0, gm = 0.0;
        soil::segment_vjp_column<double, NZ, soil::STEPPER_IMPLICIT, soil::SOLVER_RUNTIME, false,
                                 true>(col, cells, steps, U, sat, S, gU, gsat, gS, gU0, gsat0,
                                       gS0, scratch.data(), top, step_stride, cell_stride, c, *P,
                                       dz, dzf, zc, zf, dt, 1.0 / dt, gK, gm, iters, solver);
        gparams[col] = gK;
        gparams[cells + col] = gm;
    }
}

// soil::segment_vjp_column of ForwardEuler (STEPPER_EULER) or Heun
// (STEPPER_HEUN) over heat + Richards over every column, as thread_vjp_columns
template <int NZ, int STEPPER>
void thread_explicit_vjp_columns(const double* U, const double* sat, const double* S,
                                 const double* gU, const double* gsat, const double* gS,
                                 double* gU0, double* gsat0, double* gS0, double* gparams,
                                 const double* top, long long step_stride,
                                 long long cell_stride, const double* dz, const double* dzf,
                                 const double* zc, const double* zf, const SoilColumnParams* P,
                                 int steps, double dt, long long cells, int)
{
    std::vector<double> scratch((size_t)steps * (2 * NZ + 1) * cells);
    const soil::Consts<double> c(*P);
    for (long long col = 0; col < cells; ++col) {
        double gK = 0.0, gm = 0.0;
        soil::segment_vjp_column<double, NZ, STEPPER>(
            col, cells, steps, U, sat, S, gU, gsat, gS, gU0, gsat0, gS0, scratch.data(), top,
            step_stride, cell_stride, c, *P, dz, dzf, zc, zf, dt, 1.0 / dt, gK, gm);
        gparams[col] = gK;
        gparams[cells + col] = gm;
    }
}

template <int NZ>
int thread_explicit_vjp(int stepper, const double* U, const double* sat, const double* S,
                        const double* gU, const double* gsat, const double* gS, double* gU0,
                        double* gsat0, double* gS0, double* gparams, const double* top,
                        long long step_stride, long long cell_stride, const double* dz,
                        const double* dzf, const double* zc, const double* zf,
                        const SoilColumnParams* P, int steps, double dt, long long cells,
                        int iters)
{
    if (stepper == soil::STEPPER_EULER)
        thread_explicit_vjp_columns<NZ, soil::STEPPER_EULER>(VJP_ARGS);
    else if (stepper == soil::STEPPER_HEUN)
        thread_explicit_vjp_columns<NZ, soil::STEPPER_HEUN>(VJP_ARGS);
    else
        return -1;
    return 0;
}

// soil::GroupColumn::segment_vjp (STEPPER, SOLVER) over every column on a
// group of G emulated lanes, as the group segment-VJP kernel runs it; each
// column's parameter cotangents (the group's tree sum of its lanes') to
// gparams
template <int NZ, int G, int STEPPER, int SOLVER>
void group_vjp_columns(const double* U, const double* sat, const double* S, const double* gU,
                       const double* gsat, const double* gS, double* gU0, double* gsat0,
                       double* gS0, double* gparams, const double* top, long long step_stride,
                       long long cell_stride, const double* dz, const double* dzf,
                       const double* zc, const double* zf, const SoilColumnParams* P, int steps,
                       double dt, long long cells, int iters)
{
    using Column = soil::GroupColumn<double, NZ, G, soil::HostLanes<G>>;
    constexpr int L = Column::L;
    const soil::HostLanes<G> lanes;
    const soil::Consts<double> c(*P);
    std::vector<double> scratch((size_t)steps * (2 * NZ + 1) * cells);
    for (long long col = 0; col < cells; ++col) {
        Column column(lanes, c, *P, dz, dzf, zc, zf);
        double u[G][L], s[G][L], gu[G][L], gs[G][L];
        for (int i = 0; i < G; ++i)
            for (int l = 0; l < L; ++l) {
                const int k = column.level(i, l);
                const bool in = k < NZ;
                u[i][l] = in ? U[k * cells + col] : 0.0;
                s[i][l] = in ? sat[k * cells + col] : 0.0;
                gu[i][l] = in ? gU[k * cells + col] : 0.0;
                gs[i][l] = in ? gsat[k * cells + col] : 0.0;
            }
        double sv = S[col], gsv = gS[col], gK[G] = {}, gm[G] = {};
        column.template segment_vjp<STEPPER, SOLVER>(u, s, sv, gu, gs, gsv, scratch.data(), col,
                                                     cells, true, top + col * cell_stride,
                                                     step_stride, steps, dt, 1.0 / dt, iters, gK,
                                                     gm);
        for (int i = 0; i < G; ++i)
            for (int l = 0; l < L; ++l) {
                const int k = column.level(i, l);
                if (k < NZ) { gU0[k * cells + col] = gu[i][l]; gsat0[k * cells + col] = gs[i][l]; }
            }
        gS0[col] = gsv;
        gparams[col] = column.group_sum(gK);
        gparams[cells + col] = column.group_sum(gm);
    }
}

template <int NZ, int G>
int group_vjp(int solver, const double* U, const double* sat, const double* S,
              const double* gU, const double* gsat, const double* gS, double* gU0,
              double* gsat0, double* gS0, double* gparams, const double* top,
              long long step_stride, long long cell_stride, const double* dz, const double* dzf,
              const double* zc, const double* zf, const SoilColumnParams* P, int steps,
              double dt, long long cells, int iters)
{
    constexpr int I = soil::STEPPER_IMPLICIT;
    if (solver == soil::SOLVER_PCR) group_vjp_columns<NZ, G, I, soil::SOLVER_PCR>(VJP_ARGS);
    else if (solver == soil::SOLVER_THOMAS) group_vjp_columns<NZ, G, I, soil::SOLVER_THOMAS>(VJP_ARGS);
    else return -1;
    return 0;
}

// the group segment VJP of ForwardEuler or Heun at G
template <int NZ, int G>
int group_explicit_vjp(int stepper, const double* U, const double* sat, const double* S,
                       const double* gU, const double* gsat, const double* gS, double* gU0,
                       double* gsat0, double* gS0, double* gparams, const double* top,
                       long long step_stride, long long cell_stride, const double* dz,
                       const double* dzf, const double* zc, const double* zf,
                       const SoilColumnParams* P, int steps, double dt, long long cells,
                       int iters)
{
    if (stepper == soil::STEPPER_EULER)
        group_vjp_columns<NZ, G, soil::STEPPER_EULER, soil::SOLVER_PCR>(VJP_ARGS);
    else if (stepper == soil::STEPPER_HEUN)
        group_vjp_columns<NZ, G, soil::STEPPER_HEUN, soil::SOLVER_PCR>(VJP_ARGS);
    else
        return -1;
    return 0;
}

// the same at the kernel's group size of each stepper at NZ
// (soil::vjp_group_lanes); -1 for another g
template <int NZ>
int kernel_explicit_vjp(int g, int stepper, const double* U, const double* sat,
                        const double* S, const double* gU, const double* gsat,
                        const double* gS, double* gU0, double* gsat0, double* gS0,
                        double* gparams, const double* top, long long step_stride,
                        long long cell_stride, const double* dz, const double* dzf,
                        const double* zc, const double* zf, const SoilColumnParams* P,
                        int steps, double dt, long long cells, int iters)
{
    constexpr int GE = soil::vjp_group_lanes(NZ, soil::STEPPER_EULER, soil::SOLVER_PCR);
    constexpr int GH = soil::vjp_group_lanes(NZ, soil::STEPPER_HEUN, soil::SOLVER_PCR);
    if (stepper == soil::STEPPER_EULER && g == GE)
        group_vjp_columns<NZ, GE, soil::STEPPER_EULER, soil::SOLVER_PCR>(VJP_ARGS);
    else if (stepper == soil::STEPPER_HEUN && g == GH)
        group_vjp_columns<NZ, GH, soil::STEPPER_HEUN, soil::SOLVER_PCR>(VJP_ARGS);
    else
        return -1;
    return 0;
}
#endif

}  // namespace

#ifndef SOIL_GROUP_VJP_HOST
// The kernels' group size at nz (soil::group_lanes)
extern "C" int host_group_lanes(int nz) { return soil::group_lanes(nz); }

// One thread a column: soil::rollout_column of ForwardEuler (stepper 0) or
// Heun (1) over heat + Richards, in place; the top temperature from a table
// (rows 0) or a series of `rows` rows. Returns -1 for an nz or stepper it
// does not run.
extern "C" int host_thread_rollout(double* U, double* sat, double* S, const double* top,
                                   long long step_stride, long long cell_stride, int rows,
                                   double t0, double dts, double time0, const double* dz,
                                   const double* dzf, const double* zc, const double* zf,
                                   const SoilColumnParams* P, int nz, int stepper, int steps,
                                   double dt, long long cells)
{
    switch (nz) {
        case 10: return thread_scheme<10>(stepper, ROLLOUT_ARGS);
        case 15: return thread_scheme<15>(stepper, ROLLOUT_ARGS);
        case 20: return thread_scheme<20>(stepper, ROLLOUT_ARGS);
        case 30: return thread_scheme<30>(stepper, ROLLOUT_ARGS);
        case 40: return thread_scheme<40>(stepper, ROLLOUT_ARGS);
        default: return -1;
    }
}

// The same on groups of g lanes (soil::group_lanes(nz), 4 or 32), the
// hand-offs of each column to handoffs (2 * cells, up then down; may be
// null). Returns -1 for an nz, g or stepper it does not run.
extern "C" int host_group_rollout(double* U, double* sat, double* S, const double* top,
                                  long long step_stride, long long cell_stride, int rows,
                                  double t0, double dts, double time0, const double* dz,
                                  const double* dzf, const double* zc, const double* zf,
                                  const SoilColumnParams* P, int nz, int g, int stepper,
                                  int steps, double dt, long long cells,
                                  unsigned long long* handoffs)
{
    switch (nz) {
        case 10: return group_of<10>(g, stepper, ROLLOUT_ARGS, handoffs);
        case 15: return group_of<15>(g, stepper, ROLLOUT_ARGS, handoffs);
        case 20: return group_of<20>(g, stepper, ROLLOUT_ARGS, handoffs);
        case 30: return group_of<30>(g, stepper, ROLLOUT_ARGS, handoffs);
        case 40: return group_of<40>(g, stepper, ROLLOUT_ARGS, handoffs);
        default: return -1;
    }
}

#endif

// The implicit step's group size at nz for `solver` (0 Thomas, 1 PCR;
// soil::implicit_group_lanes)
extern "C" int host_implicit_group_lanes(int nz, int solver)
{
    return soil::implicit_group_lanes(nz, solver);
}

#ifndef SOIL_GROUP_VJP_HOST
// One thread a column: soil::rollout_column of picard_step, ImplicitEuler
// with `iters` Picard iterations and `solver` (0 Thomas, 1 PCR) over heat +
// Richards, in place; the top temperature from a table (rows 0) or a series
// of `rows` rows. Returns -1 for an nz it does not run.
extern "C" int host_thread_picard(double* U, double* sat, double* S, const double* top,
                                  long long step_stride, long long cell_stride, int rows,
                                  double t0, double dts, double time0, const double* dz,
                                  const double* dzf, const double* zc, const double* zf,
                                  const SoilColumnParams* P, int nz, int solver, int iters,
                                  int steps, double dt, long long cells)
{
    switch (nz) {
        case 10: return thread_picard<10>(ROLLOUT_ARGS, solver, iters);
        case 16: return thread_picard<16>(ROLLOUT_ARGS, solver, iters);
        case 30: return thread_picard<30>(ROLLOUT_ARGS, solver, iters);
        default: return -1;
    }
}

#endif

// The same on groups of g lanes: Nz 10 and 16 at their implicit group size
// (4), Nz 30 at g 4, 8, 16 or 32. Returns -1 for an nz, g or solver it does
// not run.
extern "C" int host_group_picard(double* U, double* sat, double* S, const double* top,
                                 long long step_stride, long long cell_stride, int rows,
                                 double t0, double dts, double time0, const double* dz,
                                 const double* dzf, const double* zc, const double* zf,
                                 const SoilColumnParams* P, int nz, int g, int solver, int iters,
                                 int steps, double dt, long long cells)
{
    static_assert(soil::implicit_group_lanes(10, soil::SOLVER_PCR) == 4 &&
                  soil::implicit_group_lanes(10, soil::SOLVER_THOMAS) == 4 &&
                  soil::implicit_group_lanes(16, soil::SOLVER_PCR) == 4 &&
                  soil::implicit_group_lanes(16, soil::SOLVER_THOMAS) == 4,
                  "the host build holds Nz 10 and 16 at G 4");
    if (nz == 10 && g == 4) return group_picard<10, 4>(solver, ROLLOUT_ARGS, iters);
    if (nz == 16 && g == 4) return group_picard<16, 4>(solver, ROLLOUT_ARGS, iters);
    if (nz != 30) return -1;
    switch (g) {
        case 4: return group_picard<30, 4>(solver, ROLLOUT_ARGS, iters);
        case 8: return group_picard<30, 8>(solver, ROLLOUT_ARGS, iters);
        case 16: return group_picard<30, 16>(solver, ROLLOUT_ARGS, iters);
        case 32: return group_picard<30, 32>(solver, ROLLOUT_ARGS, iters);
        default: return -1;
    }
}

#ifdef SOIL_GROUP_VJP_HOST
// The one-thread segment VJP's column code of picard_step with `iters`
// Picard iterations and `solver` (0 Thomas, 1 PCR), heat + Richards, over
// every column: the input cotangents and each column's parameter
// cotangents (gparams, 2 * cells); the top temperature of step s
// top[s * step_stride + col * cell_stride]. Returns -1 for an nz it does
// not run.
extern "C" int host_thread_vjp(const double* U, const double* sat, const double* S,
                               const double* gU, const double* gsat, const double* gS,
                               double* gU0, double* gsat0, double* gS0, double* gparams,
                               const double* top, long long step_stride, long long cell_stride,
                               const double* dz, const double* dzf, const double* zc,
                               const double* zf, const SoilColumnParams* P, int nz, int solver,
                               int iters, int steps, double dt, long long cells)
{
    switch (nz) {
        case 10: thread_vjp_columns<10>(solver, VJP_ARGS); return 0;
        case 16: thread_vjp_columns<16>(solver, VJP_ARGS); return 0;
        case 30: thread_vjp_columns<30>(solver, VJP_ARGS); return 0;
        default: return -1;
    }
}

// The same on groups of g lanes (the group segment-VJP kernel's column
// code): Nz 10 and 16 at their implicit group size (4), Nz 30 at g 4, 8, 16
// or 32. Returns -1 for an nz, g or solver it does not run.
extern "C" int host_group_vjp(const double* U, const double* sat, const double* S,
                              const double* gU, const double* gsat, const double* gS,
                              double* gU0, double* gsat0, double* gS0, double* gparams,
                              const double* top, long long step_stride, long long cell_stride,
                              const double* dz, const double* dzf, const double* zc,
                              const double* zf, const SoilColumnParams* P, int nz, int g,
                              int solver, int iters, int steps, double dt, long long cells)
{
    if (nz == 10 && g == 4) return group_vjp<10, 4>(solver, VJP_ARGS);
    if (nz == 16 && g == 4) return group_vjp<16, 4>(solver, VJP_ARGS);
    if (nz != 30) return -1;
    switch (g) {
        case 4: return group_vjp<30, 4>(solver, VJP_ARGS);
        case 8: return group_vjp<30, 8>(solver, VJP_ARGS);
        case 16: return group_vjp<30, 16>(solver, VJP_ARGS);
        case 32: return group_vjp<30, 32>(solver, VJP_ARGS);
        default: return -1;
    }
}

// The segment VJP of ForwardEuler (stepper 0) or Heun (1) over heat +
// Richards, one thread a column (soil::segment_vjp_column), as
// host_thread_vjp: Nz 10, 16, 20 and 30. Returns -1 for an nz or stepper it
// does not run.
extern "C" int host_thread_explicit_vjp(const double* U, const double* sat, const double* S,
                                        const double* gU, const double* gsat, const double* gS,
                                        double* gU0, double* gsat0, double* gS0, double* gparams,
                                        const double* top, long long step_stride,
                                        long long cell_stride, const double* dz,
                                        const double* dzf, const double* zc, const double* zf,
                                        const SoilColumnParams* P, int nz, int stepper,
                                        int steps, double dt, long long cells)
{
    const int iters = 1;
    switch (nz) {
        case 10: return thread_explicit_vjp<10>(stepper, VJP_ARGS);
        case 16: return thread_explicit_vjp<16>(stepper, VJP_ARGS);
        case 20: return thread_explicit_vjp<20>(stepper, VJP_ARGS);
        case 30: return thread_explicit_vjp<30>(stepper, VJP_ARGS);
        default: return -1;
    }
}

// The same on groups of g lanes (the group segment-VJP kernel's column
// code): Nz 8, 10, 16 and 20 at the kernel's group size
// (soil::vjp_group_lanes), Nz 30 at g 4, 8, 16 or 32. Returns -1 for an
// nz, g or stepper it does not run.
extern "C" int host_group_explicit_vjp(const double* U, const double* sat, const double* S,
                                       const double* gU, const double* gsat, const double* gS,
                                       double* gU0, double* gsat0, double* gS0, double* gparams,
                                       const double* top, long long step_stride,
                                       long long cell_stride, const double* dz,
                                       const double* dzf, const double* zc, const double* zf,
                                       const SoilColumnParams* P, int nz, int g, int stepper,
                                       int steps, double dt, long long cells)
{
    const int iters = 1;
    switch (nz) {
        case 8: return kernel_explicit_vjp<8>(g, stepper, VJP_ARGS);
        case 10: return kernel_explicit_vjp<10>(g, stepper, VJP_ARGS);
        case 16: return kernel_explicit_vjp<16>(g, stepper, VJP_ARGS);
        case 20: return kernel_explicit_vjp<20>(g, stepper, VJP_ARGS);
        case 30: break;
        default: return -1;
    }
    switch (g) {
        case 4: return group_explicit_vjp<30, 4>(stepper, VJP_ARGS);
        case 8: return group_explicit_vjp<30, 8>(stepper, VJP_ARGS);
        case 16: return group_explicit_vjp<30, 16>(stepper, VJP_ARGS);
        case 32: return group_explicit_vjp<30, 32>(stepper, VJP_ARGS);
        default: return -1;
    }
}

// The segment VJP's group size of `stepper` (0 ForwardEuler, 1 Heun, 2
// ImplicitEuler with `solver`) at nz (soil::vjp_group_lanes)
extern "C" int host_vjp_group_lanes(int nz, int stepper, int solver)
{
    return soil::vjp_group_lanes(nz, stepper, solver);
}
#endif
