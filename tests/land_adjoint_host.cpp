// Host build of terrarium_tpu_torch/csrc/land_adjoint.cuh for the CPU tests
// (tests/test_torch_land_adjoint_host.py): the land segment-VJP kernel's
// per-column code (forward with stored carries, recompute, adjoint,
// parameter cotangents) run over every column in a loop, at float64, behind
// a plain C interface.
#include <vector>

#include "land_adjoint.cuh"

namespace {

template <int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, bool SNOW, int STEPPER,
          int SOLVER, bool PICARD = false>
void columns(const LandCarry* in, const LandCarry* gout, const LandCarry* gin,
             const LandInputs* inputs, const double* root, long long root_row_stride,
             long long root_cell_stride, const double* dz, const double* dzf, const double* zc,
             const double* zf, const LandColumnParams<double>* P, double* gparams, int steps,
             double dt, long long cells, int iters = 1, int solver = SOLVER)
{
    const soil::Consts<double> sc(P->soil);
    std::vector<double> scratch((size_t)steps * land::ScratchRows<NZ, SNOW>::value * cells);
    for (long long col = 0; col < cells; ++col) {
        double gK = 0.0, gskm = 0.0;
        land::segment_vjp_column<double, NZ, VEG, RICHARDS, CURVE, COND, SNOW, STEPPER,
                                 SOLVER, PICARD>(
            col, cells, steps, *in, *gout, *gin, scratch.data(), *inputs, root,
            root_row_stride, root_cell_stride, sc, *P, dz, dzf, zc, zf, dt, 1.0 / dt, gK, gskm,
            iters, solver);
        gparams[col] = gK;
        gparams[cells + col] = gskm;
    }
}

}  // namespace

// The land segment-VJP column code at NZ 8 for the composition (veg,
// richards, curve, cond, snow) and the stepper (0 ForwardEuler, 1 Heun, 2
// ImplicitEuler with solver 0 Thomas or 1 PCR): bare ground or vegetated,
// over heat only or Richards flow with Van Genuchten and Mualem or linear
// conductivity or Brooks-Corey and linear, each without a snowpack; with a
// snowpack bare ground over heat only and over Brooks-Corey and linear,
// and vegetated over Van Genuchten and Mualem and over Brooks-Corey and
// linear. gparams is (2, cells): each column's K_sat and sk_mineral
// cotangents. picard > 0 runs land::picard_step with that many iterations
// and the solver at run time (ImplicitEuler, every composition). Returns -1
// for any other.
extern "C" int host_land_segment_vjp(const LandCarry* in, const LandCarry* gout,
                                     const LandCarry* gin, const LandInputs* inputs,
                                     const double* root, long long root_row_stride,
                                     long long root_cell_stride, const double* dz,
                                     const double* dzf, const double* zc, const double* zf,
                                     const LandColumnParams<double>* P, double* gparams, int nz,
                                     int veg, int richards, int curve, int cond, int snow,
                                     int stepper, int solver, int picard, int steps, double dt,
                                     long long cells)
{
    using land::COND_LINEAR;
    using land::COND_MUALEM;
    using land::CURVE_BC;
    using land::CURVE_VG;
    const int rc = richards ? curve : CURVE_VG, rk = richards ? cond : COND_MUALEM;
    const int sv = stepper == soil::STEPPER_IMPLICIT ? solver : 0;
    if (nz != 8 || (picard > 0 && stepper != soil::STEPPER_IMPLICIT)) return -1;
#define LAND_CASE(VEG, RICHARDS, CURVE, COND, SNOW, STEPPER, SOLVER)                            \
    if (picard == 0 && veg == VEG && richards == RICHARDS && rc == CURVE && rk == COND &&       \
        snow == SNOW && stepper == STEPPER && sv == SOLVER) {                                   \
        columns<8, VEG, RICHARDS, CURVE, COND, SNOW, STEPPER, SOLVER>(                          \
            in, gout, gin, inputs, root, root_row_stride, root_cell_stride, dz, dzf, zc, zf, P, \
            gparams, steps, dt, cells);                                                         \
        return 0;                                                                               \
    }
#define LAND_PICARD(VEG, RICHARDS, CURVE, COND, SNOW)                                           \
    if (picard > 0 && veg == VEG && richards == RICHARDS && rc == CURVE && rk == COND &&        \
        snow == SNOW) {                                                                         \
        columns<8, VEG, RICHARDS, CURVE, COND, SNOW, 2, soil::SOLVER_RUNTIME, true>(            \
            in, gout, gin, inputs, root, root_row_stride, root_cell_stride, dz, dzf, zc, zf, P, \
            gparams, steps, dt, cells, picard, solver);                                         \
        return 0;                                                                               \
    }
#define LAND_STEPPERS(VEG, RICHARDS, CURVE, COND, SNOW)                                         \
    LAND_CASE(VEG, RICHARDS, CURVE, COND, SNOW, 0, 0)                                           \
    LAND_CASE(VEG, RICHARDS, CURVE, COND, SNOW, 1, 0)                                           \
    LAND_CASE(VEG, RICHARDS, CURVE, COND, SNOW, 2, 0)                                           \
    LAND_CASE(VEG, RICHARDS, CURVE, COND, SNOW, 2, 1)                                           \
    LAND_PICARD(VEG, RICHARDS, CURVE, COND, SNOW)
    LAND_STEPPERS(false, false, CURVE_VG, COND_MUALEM, false)
    LAND_STEPPERS(true, false, CURVE_VG, COND_MUALEM, false)
    LAND_STEPPERS(false, true, CURVE_VG, COND_MUALEM, false)
    LAND_STEPPERS(true, true, CURVE_VG, COND_MUALEM, false)
    LAND_STEPPERS(false, true, CURVE_VG, COND_LINEAR, false)
    LAND_STEPPERS(false, true, CURVE_BC, COND_LINEAR, false)
    LAND_STEPPERS(true, true, CURVE_BC, COND_LINEAR, false)
    LAND_STEPPERS(false, false, CURVE_VG, COND_MUALEM, true)
    LAND_STEPPERS(false, true, CURVE_BC, COND_LINEAR, true)
    LAND_STEPPERS(true, true, CURVE_VG, COND_MUALEM, true)
    LAND_STEPPERS(true, true, CURVE_BC, COND_LINEAR, true)
#undef LAND_STEPPERS
#undef LAND_PICARD
#undef LAND_CASE
    return -1;
}
