// Host build of terrarium_tpu_torch/csrc/soil_step.cuh and soil_full_step.cuh
// for the CPU tests (tests/test_torch_step_adjoint.py,
// tests/test_torch_step_host.py, tests/test_torch_implicit.py,
// tests/test_torch_fused_step.py, tests/test_torch_heat_steppers.py): the
// CUDA kernels' per-column step, rollout loop, segment VJP of each scheme
// (picard_step and its adjoint among them) and full step, run over every
// column in a loop, behind a plain C interface.
#include <vector>

#include "soil_full_step.cuh"

namespace {

// soil::segment_vjp_column of the scheme over every column, as the
// segment-VJP kernel runs it; each column's parameter cotangents go to
// gparams[col] (K_sat) and gparams[cells + col] (sk_mineral)
template <int NZ, int STEPPER, int SOLVER, bool HEAT, bool PICARD = false>
void vjp(const double* U, const double* sat, const double* S, const double* gU,
         const double* gsat, const double* gS, double* gU0, double* gsat0, double* gS0,
         double* gparams, const double* top, long long step_stride, const double* dz,
         const double* dzf, const double* zc, const double* zf, const SoilColumnParams* P,
         int steps, double dt, long long cells, int iters = 1, int solver = SOLVER)
{
    std::vector<double> scratch((size_t)steps * (2 * NZ + 1) * cells);
    const soil::Consts<double> c(*P);
    for (long long col = 0; col < cells; ++col) {
        double gK = 0.0, gm = 0.0;
        soil::segment_vjp_column<double, NZ, STEPPER, SOLVER, HEAT, PICARD>(
            col, cells, steps, U, sat, S, gU, gsat, gS, gU0, gsat0, gS0, scratch.data(), top,
            step_stride, 0, c, *P, dz, dzf, zc, zf, dt, 1.0 / dt, gK, gm, iters, solver);
        gparams[col] = gK;
        gparams[cells + col] = gm;
    }
}

template <int NZ>
int vjp_scheme(int stepper, int solver, int heat, const double* U, const double* sat,
               const double* S, const double* gU, const double* gsat, const double* gS,
               double* gU0, double* gsat0, double* gS0, double* gparams, const double* top,
               long long step_stride, const double* dz, const double* dzf, const double* zc,
               const double* zf, const SoilColumnParams* P, int steps, double dt,
               long long cells)
{
#define SOIL_VJP(STEPPER, SOLVER, HEAT)                                                      \
    vjp<NZ, STEPPER, SOLVER, HEAT>(U, sat, S, gU, gsat, gS, gU0, gsat0, gS0, gparams, top,   \
                                   step_stride, dz, dzf, zc, zf, P, steps, dt, cells)
    if (heat) {
        if (stepper == soil::STEPPER_EULER) SOIL_VJP(soil::STEPPER_EULER, 0, true);
        else if (stepper == soil::STEPPER_HEUN) SOIL_VJP(soil::STEPPER_HEUN, 0, true);
        else return -1;
    } else if (stepper == soil::STEPPER_IMPLICIT) {
        if (solver == soil::SOLVER_PCR) SOIL_VJP(soil::STEPPER_IMPLICIT, soil::SOLVER_PCR, false);
        else SOIL_VJP(soil::STEPPER_IMPLICIT, soil::SOLVER_THOMAS, false);
    } else if (stepper == soil::STEPPER_HEUN) {
        SOIL_VJP(soil::STEPPER_HEUN, 0, false);
    } else {
        SOIL_VJP(soil::STEPPER_EULER, 0, false);
    }
#undef SOIL_VJP
    return 0;
}

template <int NZ>
void rollout(double* U, double* sat, double* S, const double* top, long long step_stride,
             const double* dz, const double* dzf, const double* zc, const double* zf,
             const SoilColumnParams* P, int steps, double dt, long long cells)
{
    const soil::Consts<double> c(*P);
    for (long long col = 0; col < cells; ++col) {
        double u[NZ], s[NZ];
        for (int k = 0; k < NZ; ++k) { u[k] = U[k * cells + col]; s[k] = sat[k * cells + col]; }
        double sv = S[col];
        for (int i = 0; i < steps; ++i)
            soil::step<double, NZ>(u, s, sv, top[i * step_stride], c, *P, dz, dzf, zc, zf, dt);
        for (int k = 0; k < NZ; ++k) { U[k * cells + col] = u[k]; sat[k * cells + col] = s[k]; }
        S[col] = sv;
    }
}

// soil::segment_vjp_column of picard_step with `iters` iterations and the
// solver chosen at run time (`solver` 0 Thomas or 1 PCR), heat + Richards or
// heat only, over every column: the segment-VJP kernel's Picard entries
template <int NZ>
int vjp_picard(int solver, int heat, const double* U, const double* sat, const double* S,
               const double* gU, const double* gsat, const double* gS, double* gU0,
               double* gsat0, double* gS0, double* gparams, const double* top,
               long long step_stride, const double* dz, const double* dzf, const double* zc,
               const double* zf, const SoilColumnParams* P, int steps, double dt,
               long long cells, int iters)
{
#define SOIL_VJP(HEAT)                                                                        \
    vjp<NZ, soil::STEPPER_IMPLICIT, soil::SOLVER_RUNTIME, HEAT, true>(                         \
        U, sat, S, gU, gsat, gS, gU0, gsat0, gS0, gparams, top, step_stride, dz, dzf, zc, zf, \
        P, steps, dt, cells, iters, solver)
    if (heat) SOIL_VJP(true);
    else SOIL_VJP(false);
#undef SOIL_VJP
    return 0;
}

// soil::rollout_column over every column, as the rollout kernel runs it
template <int NZ, int STEPPER, int SOLVER, bool HEAT, bool SERIES, bool PICARD = false>
void columns(double* U, double* sat, double* S, const double* top, long long step_stride,
             long long cell_stride, int rows, double t0, double dts, double time0,
             const double* dz, const double* dzf, const double* zc, const double* zf,
             const SoilColumnParams* P, int steps, double dt, long long cells, int iters = 1,
             int solver = SOLVER)
{
    const soil::Consts<double> c(*P);
    for (long long col = 0; col < cells; ++col) {
        double u[NZ], s[NZ];
        for (int k = 0; k < NZ; ++k) { u[k] = U[k * cells + col]; s[k] = sat[k * cells + col]; }
        double sv = HEAT ? 0.0 : S[col];
        soil::rollout_column<double, NZ, STEPPER, SOLVER, HEAT, SERIES, PICARD>(
            u, s, sv, top + col * cell_stride, step_stride, rows, t0, dts, time0, steps, c, *P,
            dz, dzf, zc, zf, dt, 1.0 / dt, iters, solver);
        for (int k = 0; k < NZ; ++k) {
            U[k * cells + col] = u[k];
            if (!HEAT) sat[k * cells + col] = s[k];
        }
        if (!HEAT) S[col] = sv;
    }
}

template <int NZ, int STEPPER, int SOLVER, bool HEAT, bool PICARD = false>
void columns_of(double* U, double* sat, double* S, const double* top, long long step_stride,
                long long cell_stride, int rows, double t0, double dts, double time0,
                const double* dz, const double* dzf, const double* zc, const double* zf,
                const SoilColumnParams* P, int steps, double dt, long long cells, int iters = 1,
                int solver = SOLVER)
{
    if (rows > 0)
        columns<NZ, STEPPER, SOLVER, HEAT, true, PICARD>(U, sat, S, top, step_stride,
                                                         cell_stride, rows, t0, dts, time0, dz,
                                                         dzf, zc, zf, P, steps, dt, cells,
                                                         iters, solver);
    else
        columns<NZ, STEPPER, SOLVER, HEAT, false, PICARD>(U, sat, S, top, step_stride,
                                                          cell_stride, rows, t0, dts, time0, dz,
                                                          dzf, zc, zf, P, steps, dt, cells,
                                                          iters, solver);
}

// the rollout kernel's column loop of picard_step with `iters` iterations
// and the solver chosen at run time (`solver` 0 Thomas or 1 PCR), heat +
// Richards or heat only: the rollout kernel's Picard entries
template <int NZ>
int picard(int solver, int heat, double* U, double* sat, double* S, const double* top,
           long long step_stride, long long cell_stride, int rows, double t0, double dts,
           double time0, const double* dz, const double* dzf, const double* zc,
           const double* zf, const SoilColumnParams* P, int steps, double dt, long long cells,
           int iters)
{
#define SOIL_COLUMNS(HEAT)                                                                    \
    columns_of<NZ, soil::STEPPER_IMPLICIT, soil::SOLVER_RUNTIME, HEAT, true>(                  \
        U, sat, S, top, step_stride, cell_stride, rows, t0, dts, time0, dz, dzf, zc, zf, P,   \
        steps, dt, cells, iters, solver)
    if (heat) SOIL_COLUMNS(true);
    else SOIL_COLUMNS(false);
#undef SOIL_COLUMNS
    return 0;
}

template <int NZ>
int scheme(int stepper, int solver, int heat, double* U, double* sat, double* S,
           const double* top, long long step_stride, long long cell_stride, int rows,
           double t0, double dts, double time0, const double* dz, const double* dzf,
           const double* zc, const double* zf, const SoilColumnParams* P, int steps, double dt,
           long long cells)
{
#define SOIL_COLUMNS(STEPPER, SOLVER, HEAT)                                                   \
    columns_of<NZ, STEPPER, SOLVER, HEAT>(U, sat, S, top, step_stride, cell_stride, rows, t0, \
                                          dts, time0, dz, dzf, zc, zf, P, steps, dt, cells)
    if (stepper == soil::STEPPER_IMPLICIT) {
        if (heat) return -1;
        if (solver == soil::SOLVER_PCR)
            SOIL_COLUMNS(soil::STEPPER_IMPLICIT, soil::SOLVER_PCR, false);
        else
            SOIL_COLUMNS(soil::STEPPER_IMPLICIT, soil::SOLVER_THOMAS, false);
    } else if (stepper == soil::STEPPER_HEUN) {
        if (heat) SOIL_COLUMNS(soil::STEPPER_HEUN, 0, true);
        else SOIL_COLUMNS(soil::STEPPER_HEUN, 0, false);
    } else {
        if (heat) SOIL_COLUMNS(soil::STEPPER_EULER, 0, true);
        else SOIL_COLUMNS(soil::STEPPER_EULER, 0, false);
    }
#undef SOIL_COLUMNS
    return 0;
}

template <int NZ, bool HEUN, bool HEAT>
void full_steps(const SoilFullStepIO* io, const double* dz, const double* dzf, const double* zc,
                const double* zf, const SoilColumnParams* P, double dt, long long cells)
{
    const soil::Consts<double> c(*P);
    for (long long col = 0; col < cells; ++col)
        soil::full_step_column<double, NZ, HEUN, HEAT>(*io, col, cells, c, *P, dz, dzf, zc, zf,
                                                       dt);
}

}  // namespace

// The full-step kernel's column code over every column: ForwardEuler or Heun
// (`heun`), heat + Richards or heat only (`heat`), at NZ 20. Returns -1 for
// another NZ.
extern "C" int host_full_step(const SoilFullStepIO* io, const double* dz, const double* dzf,
                              const double* zc, const double* zf, const SoilColumnParams* P,
                              int nz, int heun, int heat, double dt, long long cells)
{
    if (nz != 20) return -1;
    if (heun && heat) full_steps<20, true, true>(io, dz, dzf, zc, zf, P, dt, cells);
    else if (heun) full_steps<20, true, false>(io, dz, dzf, zc, zf, P, dt, cells);
    else if (heat) full_steps<20, false, true>(io, dz, dzf, zc, zf, P, dt, cells);
    else full_steps<20, false, false>(io, dz, dzf, zc, zf, P, dt, cells);
    return 0;
}

extern "C" int host_segment_vjp(const double* U, const double* sat, const double* S,
                                const double* gU, const double* gsat, const double* gS,
                                double* gU0, double* gsat0, double* gS0, double* gparams,
                                const double* top, long long step_stride, const double* dz,
                                const double* dzf, const double* zc, const double* zf,
                                const SoilColumnParams* P, int nz, int steps, double dt,
                                long long cells)
{
    if (nz == 10) vjp<10, 0, 0, false>(U, sat, S, gU, gsat, gS, gU0, gsat0, gS0, gparams, top,
                                       step_stride, dz, dzf, zc, zf, P, steps, dt, cells);
    else if (nz == 20) vjp<20, 0, 0, false>(U, sat, S, gU, gsat, gS, gU0, gsat0, gS0, gparams,
                                            top, step_stride, dz, dzf, zc, zf, P, steps, dt,
                                            cells);
    else return -1;
    return 0;
}

// The segment-VJP kernel's column code by scheme: ForwardEuler, Heun or
// ImplicitEuler (`stepper` 0, 1, 2; the implicit one with `solver` 0 Thomas
// or 1 PCR) over heat + Richards, or ForwardEuler over the heat-only model
// (`heat`; S, gS and gS0 unread). Heun's table has steps + 1 rows. Returns
// -1 for a scheme or NZ it does not run.
extern "C" int host_segment_vjp_scheme(const double* U, const double* sat, const double* S,
                                       const double* gU, const double* gsat, const double* gS,
                                       double* gU0, double* gsat0, double* gS0,
                                       double* gparams, const double* top,
                                       long long step_stride, const double* dz,
                                       const double* dzf, const double* zc, const double* zf,
                                       const SoilColumnParams* P, int nz, int stepper,
                                       int solver, int heat, int steps, double dt,
                                       long long cells)
{
    if (nz == 10) return vjp_scheme<10>(stepper, solver, heat, U, sat, S, gU, gsat, gS, gU0,
                                        gsat0, gS0, gparams, top, step_stride, dz, dzf, zc, zf,
                                        P, steps, dt, cells);
    if (nz == 20) return vjp_scheme<20>(stepper, solver, heat, U, sat, S, gU, gsat, gS, gU0,
                                        gsat0, gS0, gparams, top, step_stride, dz, dzf, zc, zf,
                                        P, steps, dt, cells);
    return -1;
}

extern "C" int host_rollout(double* U, double* sat, double* S, const double* top,
                            long long step_stride, const double* dz, const double* dzf,
                            const double* zc, const double* zf, const SoilColumnParams* P,
                            int nz, int steps, double dt, long long cells)
{
    if (nz == 10) rollout<10>(U, sat, S, top, step_stride, dz, dzf, zc, zf, P, steps, dt, cells);
    else if (nz == 20) rollout<20>(U, sat, S, top, step_stride, dz, dzf, zc, zf, P, steps, dt,
                                   cells);
    else return -1;
    return 0;
}

// The rollout kernel's column loop: ForwardEuler, Heun or ImplicitEuler
// (`stepper` 0, 1, 2; the implicit one with `solver` 0 Thomas or 1 PCR),
// heat + Richards or heat only (`heat`; not implicit), the top temperature
// from a table or, with `rows` > 0, from a series of `rows` rows at t0 + r *
// dts; in place. Returns -1 for a scheme or NZ it does not run.
extern "C" int host_rollout_scheme(double* U, double* sat, double* S, const double* top,
                                   long long step_stride, long long cell_stride, int rows,
                                   double t0, double dts, double time0, const double* dz,
                                   const double* dzf, const double* zc, const double* zf,
                                   const SoilColumnParams* P, int nz, int stepper, int solver,
                                   int heat, int steps, double dt, long long cells)
{
    if (nz == 15) return scheme<15>(stepper, solver, heat, U, sat, S, top, step_stride,
                                    cell_stride, rows, t0, dts, time0, dz, dzf, zc, zf, P,
                                    steps, dt, cells);
    if (nz == 16) return scheme<16>(stepper, solver, heat, U, sat, S, top, step_stride,
                                    cell_stride, rows, t0, dts, time0, dz, dzf, zc, zf, P,
                                    steps, dt, cells);
    if (nz == 20) return scheme<20>(stepper, solver, heat, U, sat, S, top, step_stride,
                                    cell_stride, rows, t0, dts, time0, dz, dzf, zc, zf, P,
                                    steps, dt, cells);
    return -1;
}

// The rollout kernel's column loop of picard_step: ImplicitEuler with
// `iters` Picard iterations (`solver` 0 Thomas or 1 PCR), heat + Richards or
// heat only (`heat`; S unread), the top temperature from a table or, with
// `rows` > 0, a series as host_rollout_scheme reads it; in place. Returns -1
// for an NZ it does not run.
extern "C" int host_rollout_picard(double* U, double* sat, double* S, const double* top,
                                   long long step_stride, long long cell_stride, int rows,
                                   double t0, double dts, double time0, const double* dz,
                                   const double* dzf, const double* zc, const double* zf,
                                   const SoilColumnParams* P, int nz, int solver, int heat,
                                   int iters, int steps, double dt, long long cells)
{
    if (nz == 10) return picard<10>(solver, heat, U, sat, S, top, step_stride, cell_stride, rows,
                                    t0, dts, time0, dz, dzf, zc, zf, P, steps, dt, cells, iters);
    if (nz == 16) return picard<16>(solver, heat, U, sat, S, top, step_stride, cell_stride, rows,
                                    t0, dts, time0, dz, dzf, zc, zf, P, steps, dt, cells, iters);
    if (nz == 20) return picard<20>(solver, heat, U, sat, S, top, step_stride, cell_stride, rows,
                                    t0, dts, time0, dz, dzf, zc, zf, P, steps, dt, cells, iters);
    return -1;
}

// The segment-VJP kernel's column code of picard_step with `iters` Picard
// iterations (`solver` 0 Thomas or 1 PCR), heat + Richards or heat only
// (`heat`; S, gS and gS0 unread). Returns -1 for an NZ it does not run.
extern "C" int host_segment_vjp_picard(const double* U, const double* sat, const double* S,
                                       const double* gU, const double* gsat, const double* gS,
                                       double* gU0, double* gsat0, double* gS0,
                                       double* gparams, const double* top,
                                       long long step_stride, const double* dz,
                                       const double* dzf, const double* zc, const double* zf,
                                       const SoilColumnParams* P, int nz, int solver, int heat,
                                       int iters, int steps, double dt, long long cells)
{
    if (nz == 10) return vjp_picard<10>(solver, heat, U, sat, S, gU, gsat, gS, gU0, gsat0, gS0,
                                        gparams, top, step_stride, dz, dzf, zc, zf, P, steps, dt,
                                        cells, iters);
    if (nz == 20) return vjp_picard<20>(solver, heat, U, sat, S, gU, gsat, gS, gU0, gsat0, gS0,
                                        gparams, top, step_stride, dz, dzf, zc, zf, P, steps, dt,
                                        cells, iters);
    return -1;
}
