// Host build of terrarium_tpu_torch/csrc/soil_full_step.cuh's ImplicitEuler
// full step and csrc/land_full_step.cuh for the CPU tests
// (tests/test_torch_fused_step_implicit.py, tests/test_torch_land_full_step.py):
// the full-step kernels' column code run over every column in a loop, at
// float64, behind a plain C interface.
#include "land_full_step.cuh"
#include "soil_full_step.cuh"

namespace {

template <int NZ, bool HEAT>
void soil_columns(const SoilFullStepIO* io, const double* dz, const double* dzf,
                  const double* zc, const double* zf, const SoilColumnParams* P, double dt,
                  long long cells, int iters, int solver)
{
    const soil::Consts<double> c(*P);
    for (long long col = 0; col < cells; ++col)
        soil::full_step_column<double, NZ, false, HEAT, true>(*io, col, cells, c, *P, dz, dzf,
                                                              zc, zf, dt, 1.0 / dt, iters,
                                                              solver);
}

template <int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, bool SNOW, int STEPPER>
void land_columns(const LandFullStepIO* io, const LandInputs* inputs, const double* root,
                  long long root_row_stride, long long root_cell_stride, const double* dz,
                  const double* dzf, const double* zc, const double* zf,
                  const LandColumnParams<double>* P, double dt, long long cells, int iters,
                  int solver)
{
    const soil::Consts<double> sc(P->soil);
    for (long long col = 0; col < cells; ++col)
        land::full_step_column<double, NZ, VEG, RICHARDS, CURVE, COND, SNOW, STEPPER>(
            *io, *inputs, root, root_row_stride, root_cell_stride, col, cells, sc, *P, dz, dzf,
            zc, zf, dt, 1.0 / dt, iters, solver);
}

}  // namespace

// The soil full-step kernel's ImplicitEuler column code over every column,
// heat + Richards or heat only (`heat`), `iters` Picard iterations, solver
// 0 Thomas or 1 PCR, at NZ 20. Returns -1 for another NZ.
extern "C" int host_soil_full_step_implicit(const SoilFullStepIO* io, const double* dz,
                                            const double* dzf, const double* zc,
                                            const double* zf, const SoilColumnParams* P,
                                            int nz, int heat, int iters, int solver, double dt,
                                            long long cells)
{
    if (nz != 20) return -1;
    if (heat) soil_columns<20, true>(io, dz, dzf, zc, zf, P, dt, cells, iters, solver);
    else soil_columns<20, false>(io, dz, dzf, zc, zf, P, dt, cells, iters, solver);
    return 0;
}

// The land full-step kernel's column code over every column at NZ 8 for the
// composition (veg, richards, curve, cond, snow) and the stepper (0
// ForwardEuler, 1 Heun, 2 ImplicitEuler with `iters` Picard iterations and
// solver 0 Thomas or 1 PCR): bare ground over heat only (linear K), bare
// ground over Richards with Van Genuchten and Mualem K, and the vegetated
// Brooks-Corey and linear composition with and without a snowpack, each
// with every stepper. Returns -1 for any other.
extern "C" int host_land_full_step(const LandFullStepIO* io, const LandInputs* inputs,
                                   const double* root, long long root_row_stride,
                                   long long root_cell_stride, const double* dz,
                                   const double* dzf, const double* zc, const double* zf,
                                   const LandColumnParams<double>* P, int nz, int veg,
                                   int richards, int curve, int cond, int snow, int stepper,
                                   int iters, int solver, double dt, long long cells)
{
    using land::COND_LINEAR;
    using land::COND_MUALEM;
    using land::CURVE_BC;
    using land::CURVE_VG;
    const int rc = richards ? curve : CURVE_VG;
#define LAND_CASE(VEG, RICHARDS, CURVE, COND, SNOW, STEPPER)                                     \
    if (nz == 8 && veg == VEG && richards == RICHARDS && rc == CURVE && cond == COND &&         \
        snow == SNOW && stepper == STEPPER) {                                                   \
        land_columns<8, VEG, RICHARDS, CURVE, COND, SNOW, STEPPER>(                             \
            io, inputs, root, root_row_stride, root_cell_stride, dz, dzf, zc, zf, P, dt, cells, \
            iters, solver);                                                                     \
        return 0;                                                                               \
    }
#define LAND_STEPPERS(VEG, RICHARDS, CURVE, COND, SNOW)                                         \
    LAND_CASE(VEG, RICHARDS, CURVE, COND, SNOW, 0)                                              \
    LAND_CASE(VEG, RICHARDS, CURVE, COND, SNOW, 1)                                              \
    LAND_CASE(VEG, RICHARDS, CURVE, COND, SNOW, 2)
    LAND_STEPPERS(false, false, CURVE_VG, COND_LINEAR, false)
    LAND_STEPPERS(false, true, CURVE_VG, COND_MUALEM, false)
    LAND_STEPPERS(true, true, CURVE_BC, COND_LINEAR, false)
    LAND_STEPPERS(true, true, CURVE_BC, COND_LINEAR, true)
#undef LAND_STEPPERS
#undef LAND_CASE
    return -1;
}
