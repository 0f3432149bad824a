// Host build of terrarium_tpu_torch/csrc/land_step.cuh for the CPU tests
// (tests/test_torch_land_host.py): the land kernel's per-column rollout run
// over every column in a loop, at float64, behind a plain C interface.
#include "land_step.cuh"

namespace {

template <int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, bool SNOW, int STEPPER,
          int SOLVER, bool PICARD = false>
void columns(const LandCarry* in, const LandCarry* out, const LandInputs* inputs,
             const double* root, long long root_row_stride, long long root_cell_stride,
             const double* dz, const double* dzf, const double* zc, const double* zf,
             const LandColumnParams<double>* P, int steps, double time0, double dt,
             long long cells, int iters = 1, int solver = SOLVER)
{
    const soil::Consts<double> sc(P->soil);
    for (long long col = 0; col < cells; ++col)
        land::rollout_column<double, NZ, VEG, RICHARDS, CURVE, COND, SNOW, STEPPER, SOLVER,
                             PICARD>(
            col, cells, *in, *out, *inputs, root, root_row_stride, root_cell_stride, sc, *P,
            dz, dzf, zc, zf, steps, time0, dt, 1.0 / dt, iters, solver);
}

}  // namespace

// The land kernel's column loop for the composition (veg, richards, curve,
// cond, snow) and the stepper (0 ForwardEuler, 1 Heun, 2 ImplicitEuler with
// solver 0 Thomas or 1 PCR): every composition the tests take at NZ 8 with
// ForwardEuler, and bare ground over heat only at NZ 15 (the golden's); at
// NZ 8 with each stepper the compositions bare ground over heat only, bare
// ground over Richards with Van Genuchten and linear conductivity, and the
// vegetated Brooks-Corey and linear one with and without a snowpack; the
// snowpack over bare ground, Brooks-Corey and linear, with ForwardEuler.
// picard > 0 runs land::picard_step with that many iterations and the
// solver at run time (ImplicitEuler's compositions at NZ 8). Returns -1 for
// any other.
extern "C" int host_land_rollout(const LandCarry* in, const LandCarry* out,
                                 const LandInputs* inputs, const double* root,
                                 long long root_row_stride, long long root_cell_stride,
                                 const double* dz, const double* dzf, const double* zc,
                                 const double* zf, const LandColumnParams<double>* P, int nz,
                                 int veg, int richards, int curve, int cond, int snow,
                                 int stepper, int solver, int picard, int steps, double time0,
                                 double dt, long long cells)
{
    using land::COND_LINEAR;
    using land::COND_MUALEM;
    using land::CURVE_BC;
    using land::CURVE_VG;
    const int rc = richards ? curve : CURVE_VG, rk = richards ? cond : COND_MUALEM;
    const int sv = stepper == soil::STEPPER_IMPLICIT ? solver : 0;
    if (picard > 0 && stepper != soil::STEPPER_IMPLICIT) return -1;
#define LAND_PICARD(VEG, RICHARDS, CURVE, COND, SNOW)                                           \
    if (picard > 0 && nz == 8 && veg == VEG && richards == RICHARDS && rc == CURVE &&           \
        rk == COND && snow == SNOW) {                                                           \
        columns<8, VEG, RICHARDS, CURVE, COND, SNOW, 2, soil::SOLVER_RUNTIME, true>(            \
            in, out, inputs, root, root_row_stride, root_cell_stride, dz, dzf, zc, zf, P,       \
            steps, time0, dt, cells, picard, solver);                                           \
        return 0;                                                                               \
    }
    LAND_PICARD(false, false, CURVE_VG, COND_MUALEM, false)
    LAND_PICARD(false, true, CURVE_VG, COND_LINEAR, false)
    LAND_PICARD(true, true, CURVE_BC, COND_LINEAR, false)
    LAND_PICARD(true, true, CURVE_BC, COND_LINEAR, true)
#undef LAND_PICARD
    if (picard > 0) return -1;
#define LAND_CASE(NZ, VEG, RICHARDS, CURVE, COND, SNOW, STEPPER, SOLVER)                        \
    if (nz == NZ && veg == VEG && richards == RICHARDS && rc == CURVE && rk == COND &&          \
        snow == SNOW && stepper == STEPPER && sv == SOLVER) {                                   \
        columns<NZ, VEG, RICHARDS, CURVE, COND, SNOW, STEPPER, SOLVER>(                         \
            in, out, inputs, root, root_row_stride, root_cell_stride, dz, dzf, zc, zf, P,       \
            steps, time0, dt, cells);                                                           \
        return 0;                                                                               \
    }
#define LAND_STEPPERS(VEG, RICHARDS, CURVE, COND, SNOW)                                         \
    LAND_CASE(8, VEG, RICHARDS, CURVE, COND, SNOW, 1, 0)                                        \
    LAND_CASE(8, VEG, RICHARDS, CURVE, COND, SNOW, 2, 0)                                        \
    LAND_CASE(8, VEG, RICHARDS, CURVE, COND, SNOW, 2, 1)
    LAND_CASE(15, false, false, CURVE_VG, COND_MUALEM, false, 0, 0)
    LAND_CASE(8, true, false, CURVE_VG, COND_MUALEM, false, 0, 0)
    LAND_CASE(8, false, false, CURVE_VG, COND_MUALEM, false, 0, 0)
    LAND_CASE(8, true, true, CURVE_BC, COND_LINEAR, false, 0, 0)
    LAND_CASE(8, false, true, CURVE_BC, COND_LINEAR, false, 0, 0)
    LAND_CASE(8, true, true, CURVE_VG, COND_LINEAR, false, 0, 0)
    LAND_CASE(8, false, true, CURVE_VG, COND_LINEAR, false, 0, 0)
    LAND_CASE(8, true, true, CURVE_VG, COND_MUALEM, false, 0, 0)
    LAND_CASE(8, false, true, CURVE_VG, COND_MUALEM, false, 0, 0)
    LAND_CASE(8, false, true, CURVE_BC, COND_LINEAR, true, 0, 0)
    LAND_CASE(8, true, true, CURVE_BC, COND_LINEAR, true, 0, 0)
    LAND_STEPPERS(false, false, CURVE_VG, COND_MUALEM, false)
    LAND_STEPPERS(false, true, CURVE_VG, COND_LINEAR, false)
    LAND_STEPPERS(true, true, CURVE_BC, COND_LINEAR, false)
    LAND_STEPPERS(true, true, CURVE_BC, COND_LINEAR, true)
#undef LAND_STEPPERS
#undef LAND_CASE
    return -1;
}
