// Host build of terrarium_tpu_torch/csrc/soil_group_step.cuh for the CPU
// tests (tests/test_torch_group_step_host.py): the group rollout kernel's
// column code, each group of G lanes emulated by one thread in lockstep
// (soil::HostLanes), beside the one-thread-a-column rollout loop it
// replaces on the card (soil::rollout_column of soil_step.cuh), each run
// over every column behind a plain C interface.
#include "soil_group_step.cuh"

namespace {

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

#define ROLLOUT_ARGS U, sat, S, top, step_stride, cell_stride, rows, t0, dts, time0, dz, dzf, \
                     zc, zf, P, steps, dt, cells

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

}  // namespace

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
