// Host build of terrarium_tpu_torch/csrc/land_step.cuh for the CPU tests
// (tests/test_torch_land_host.py): the land kernel's per-column rollout run
// over every column in a loop, at float64, behind a plain C interface.
#include "land_step.cuh"

namespace {

template <int NZ, bool VEG, bool RICHARDS, int CURVE, int COND>
void columns(const LandCarry* in, const LandCarry* out, const LandInputs* inputs,
             const double* root, long long root_row_stride, long long root_cell_stride,
             const double* dz, const double* dzf, const double* zc, const double* zf,
             const LandColumnParams<double>* P, int steps, double time0, double dt,
             long long cells)
{
    const soil::Consts<double> sc(P->soil);
    for (long long col = 0; col < cells; ++col)
        land::rollout_column<double, NZ, VEG, RICHARDS, CURVE, COND>(
            col, cells, *in, *out, *inputs, root, root_row_stride, root_cell_stride, sc, *P,
            dz, dzf, zc, zf, steps, time0, dt);
}

}  // namespace

// The land kernel's column loop for the composition (veg, richards, curve,
// cond) at NZ 8 (every composition the tests take) or 15 (bare ground over
// heat only, the golden's); returns -1 for any other.
extern "C" int host_land_rollout(const LandCarry* in, const LandCarry* out,
                                 const LandInputs* inputs, const double* root,
                                 long long root_row_stride, long long root_cell_stride,
                                 const double* dz, const double* dzf, const double* zc,
                                 const double* zf, const LandColumnParams<double>* P, int nz,
                                 int veg, int richards, int curve, int cond, int steps,
                                 double time0, double dt, long long cells)
{
#define LAND_COLUMNS(NZ, VEG, RICHARDS, CURVE, COND)                                          \
    columns<NZ, VEG, RICHARDS, CURVE, COND>(in, out, inputs, root, root_row_stride,          \
                                            root_cell_stride, dz, dzf, zc, zf, P, steps, time0, \
                                            dt, cells)
    using land::COND_LINEAR;
    using land::COND_MUALEM;
    using land::CURVE_BC;
    using land::CURVE_VG;
    if (nz == 15 && !veg && !richards) {
        LAND_COLUMNS(15, false, false, CURVE_VG, COND_MUALEM);
        return 0;
    }
    if (nz != 8) return -1;
    if (!richards) {
        if (veg) LAND_COLUMNS(8, true, false, CURVE_VG, COND_MUALEM);
        else LAND_COLUMNS(8, false, false, CURVE_VG, COND_MUALEM);
    } else if (curve == CURVE_BC && cond == COND_LINEAR) {
        if (veg) LAND_COLUMNS(8, true, true, CURVE_BC, COND_LINEAR);
        else LAND_COLUMNS(8, false, true, CURVE_BC, COND_LINEAR);
    } else if (curve == CURVE_VG && cond == COND_LINEAR) {
        if (veg) LAND_COLUMNS(8, true, true, CURVE_VG, COND_LINEAR);
        else LAND_COLUMNS(8, false, true, CURVE_VG, COND_LINEAR);
    } else if (curve == CURVE_VG && cond == COND_MUALEM) {
        if (veg) LAND_COLUMNS(8, true, true, CURVE_VG, COND_MUALEM);
        else LAND_COLUMNS(8, false, true, CURVE_VG, COND_MUALEM);
    } else {
        return -1;
    }
#undef LAND_COLUMNS
    return 0;
}
