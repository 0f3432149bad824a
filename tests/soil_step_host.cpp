// Host build of terrarium_tpu_torch/csrc/soil_step.cuh for the CPU tests
// (tests/test_torch_step_adjoint.py, tests/test_torch_step_host.py): the CUDA
// kernels' per-column step, rollout loop and segment VJP, run over every
// column in a loop, behind a plain C interface.
#include <vector>

#include "soil_step.cuh"

namespace {

template <int NZ>
void vjp(const double* U, const double* sat, const double* S, const double* gU,
         const double* gsat, const double* gS, double* gU0, double* gsat0, double* gS0,
         double* gparams, const double* top, long long step_stride, const double* dz,
         const double* dzf, const double* zc, const double* zf, const SoilColumnParams* P,
         int steps, double dt, long long cells)
{
    std::vector<double> scratch((size_t)steps * (2 * NZ + 1) * cells);
    const soil::Consts<double> c(*P);
    for (long long col = 0; col < cells; ++col) {
        double gK = 0.0, gm = 0.0;
        soil::segment_vjp_column<double, NZ>(col, cells, steps, U, sat, S, gU, gsat, gS, gU0,
                                             gsat0, gS0, scratch.data(), top, step_stride, 0,
                                             c, *P, dz, dzf, zc, zf, dt, gK, gm);
        gparams[col] = gK;
        gparams[cells + col] = gm;
    }
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

// soil::rollout_column over every column, as the rollout kernel runs it
template <int NZ, bool HEUN, bool HEAT, bool SERIES>
void columns(double* U, double* sat, double* S, const double* top, long long step_stride,
             long long cell_stride, int rows, double t0, double dts, double time0,
             const double* dz, const double* dzf, const double* zc, const double* zf,
             const SoilColumnParams* P, int steps, double dt, long long cells)
{
    const soil::Consts<double> c(*P);
    for (long long col = 0; col < cells; ++col) {
        double u[NZ], s[NZ];
        for (int k = 0; k < NZ; ++k) { u[k] = U[k * cells + col]; s[k] = sat[k * cells + col]; }
        double sv = HEAT ? 0.0 : S[col];
        soil::rollout_column<double, NZ, HEUN, HEAT, SERIES>(
            u, s, sv, top + col * cell_stride, step_stride, rows, t0, dts, time0, steps, c, *P,
            dz, dzf, zc, zf, dt);
        for (int k = 0; k < NZ; ++k) {
            U[k * cells + col] = u[k];
            if (!HEAT) sat[k * cells + col] = s[k];
        }
        if (!HEAT) S[col] = sv;
    }
}

template <int NZ, bool HEUN, bool HEAT>
void columns_of(double* U, double* sat, double* S, const double* top, long long step_stride,
                long long cell_stride, int rows, double t0, double dts, double time0,
                const double* dz, const double* dzf, const double* zc, const double* zf,
                const SoilColumnParams* P, int steps, double dt, long long cells)
{
    if (rows > 0)
        columns<NZ, HEUN, HEAT, true>(U, sat, S, top, step_stride, cell_stride, rows, t0, dts,
                                      time0, dz, dzf, zc, zf, P, steps, dt, cells);
    else
        columns<NZ, HEUN, HEAT, false>(U, sat, S, top, step_stride, cell_stride, rows, t0, dts,
                                       time0, dz, dzf, zc, zf, P, steps, dt, cells);
}

template <int NZ>
void scheme(int heun, int heat, double* U, double* sat, double* S, const double* top,
            long long step_stride, long long cell_stride, int rows, double t0, double dts,
            double time0, const double* dz, const double* dzf, const double* zc,
            const double* zf, const SoilColumnParams* P, int steps, double dt, long long cells)
{
    if (heun && heat)
        columns_of<NZ, true, true>(U, sat, S, top, step_stride, cell_stride, rows, t0, dts,
                                   time0, dz, dzf, zc, zf, P, steps, dt, cells);
    else if (heun)
        columns_of<NZ, true, false>(U, sat, S, top, step_stride, cell_stride, rows, t0, dts,
                                    time0, dz, dzf, zc, zf, P, steps, dt, cells);
    else if (heat)
        columns_of<NZ, false, true>(U, sat, S, top, step_stride, cell_stride, rows, t0, dts,
                                    time0, dz, dzf, zc, zf, P, steps, dt, cells);
    else
        columns_of<NZ, false, false>(U, sat, S, top, step_stride, cell_stride, rows, t0, dts,
                                     time0, dz, dzf, zc, zf, P, steps, dt, cells);
}

}  // namespace

extern "C" int host_segment_vjp(const double* U, const double* sat, const double* S,
                                const double* gU, const double* gsat, const double* gS,
                                double* gU0, double* gsat0, double* gS0, double* gparams,
                                const double* top, long long step_stride, const double* dz,
                                const double* dzf, const double* zc, const double* zf,
                                const SoilColumnParams* P, int nz, int steps, double dt,
                                long long cells)
{
    if (nz == 10) vjp<10>(U, sat, S, gU, gsat, gS, gU0, gsat0, gS0, gparams, top, step_stride,
                          dz, dzf, zc, zf, P, steps, dt, cells);
    else if (nz == 20) vjp<20>(U, sat, S, gU, gsat, gS, gU0, gsat0, gS0, gparams, top,
                               step_stride, dz, dzf, zc, zf, P, steps, dt, cells);
    else return -1;
    return 0;
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

// The rollout kernel's column loop: ForwardEuler or Heun (`heun`), heat +
// Richards or heat only (`heat`), the top temperature from a table or, with
// `rows` > 0, from a series of `rows` rows at t0 + r * dts; in place.
extern "C" int host_rollout_scheme(double* U, double* sat, double* S, const double* top,
                                   long long step_stride, long long cell_stride, int rows,
                                   double t0, double dts, double time0, const double* dz,
                                   const double* dzf, const double* zc, const double* zf,
                                   const SoilColumnParams* P, int nz, int heun, int heat,
                                   int steps, double dt, long long cells)
{
    if (nz == 15) scheme<15>(heun, heat, U, sat, S, top, step_stride, cell_stride, rows, t0,
                             dts, time0, dz, dzf, zc, zf, P, steps, dt, cells);
    else if (nz == 20) scheme<20>(heun, heat, U, sat, S, top, step_stride, cell_stride, rows,
                                  t0, dts, time0, dz, dzf, zc, zf, P, steps, dt, cells);
    else return -1;
    return 0;
}
