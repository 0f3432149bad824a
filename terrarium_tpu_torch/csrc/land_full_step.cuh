// One full (not closure-rotated) LandModel step on one column: every leaf
// of the state in and out.
//
// ForwardEuler.step, Heun.step and ImplicitEuler.step (any number of Picard
// iterations) of a LandModel with static inputs and the coupling BCs alone
// (stepping.py:106-114, :150-165 and implicit.py:168-171 in the JAX
// package; timesteppers/ in the port). Unlike the rollouts'
// pre_closure_step, the step does not start with a closure: update_state
// reads the soil's temperature, liquid fraction and pressure head, the
// ground temperature and the net assimilation as the state holds them, and
// computes the conductivities, the plant-available water and the ground
// evaporation's factor from the stored saturation and liquid fraction
// (land::closure_rhs with FullWriter, whose Wr::stored replaces the closure
// by those reads). The step then writes
//   prognostics   U, the skin temperature, and as the composition has
//                 them sat and S (after the trailing closure), the canopy
//                 water, carbon, vegetation fraction and SWE (clipped >= 0)
//   tendencies    of each prognostic, the top levels' with their Flux BCs
//                 (Heun: the mean of its two stages plus x_n's BCs;
//                 ImplicitEuler: those of its first Picard iteration); the
//                 skin temperature's is 0
//   auxiliaries   those of x_n's update_state (the face hydraulic
//                 conductivity; the vegetation's, the snowpack's, the
//                 surface hydrology's and the SEB's last flux sweep), and
//                 the trailing closure's temperature, liquid fraction and
//                 ground temperature, with Richards flow its pressure head
//                 and water table
// Heun's stage and ImplicitEuler's further Picard iterations start with a
// closure, as their modules do, and run land::closure_rhs (land_step.cuh).
//
// Plain C++ apart from the function qualifiers (soil_step.cuh), so that the
// host build (tests/full_step_host.cpp) holds it to the plain version.

#pragma once

#include "land_step.cuh"
#include "soil_full_step.cuh"

extern "C" {
// Mirror of terrarium_tpu_torch.ops.land_step._CLandFullStepIO (ctypes):
// the carry as stored (`in`, its An the stored net assimilation), the
// stored closure auxiliaries (T, liq, psi: (NZ, cells); the ground
// temperature: (cells,)), the new prognostics and net assimilation
// (`out`), the tendencies (`tend`, its An unused) and the auxiliaries
// (`aux`, AUX_*: (NZ, cells), the face K (NZ + 1, cells), the rest
// (cells,)); null where the composition has none.
struct LandFullStepIO {
    LandCarry in, out, tend;
    const void *T, *liq, *psi, *ground_T;
    void* aux[LAND_NAUX];
};
}

namespace land {

// The full step's writer of land::closure_rhs for one column: the stored
// start it reads (stored), the auxiliaries and tendencies it writes
template <typename T>
struct FullWriter {
    static constexpr bool stored = true;
    const LandFullStepIO& io;
    const long long col, cells;
    SOIL_FN T temperature(int k) const { return static_cast<const T*>(io.T)[k * cells + col]; }
    SOIL_FN T liq(int k) const { return static_cast<const T*>(io.liq)[k * cells + col]; }
    SOIL_FN T pressure_head(int k) const {
        return static_cast<const T*>(io.psi)[k * cells + col];
    }
    SOIL_FN T ground_temperature() const { return static_cast<const T*>(io.ground_T)[col]; }
    SOIL_FN void aux(int i, T v) const { static_cast<T*>(io.aux[i])[col] = v; }
    SOIL_FN void aux(int i, int k, T v) const { static_cast<T*>(io.aux[i])[k * cells + col] = v; }
    SOIL_FN void fluxes(const Fluxes<T>& fl) const {
        aux(AUX_SWUP, fl.SW_up);
        aux(AUX_LWUP, fl.LW_up);
        aux(AUX_RNET, fl.R_net);
        aux(AUX_HS, fl.H_s);
        aux(AUX_HL, fl.H_l);
        aux(AUX_G, fl.G);
    }
    SOIL_FN void tend(void* p, T v) const { static_cast<T*>(p)[col] = v; }
    SOIL_FN void tend(void* p, int k, T v) const { static_cast<T*>(p)[k * cells + col] = v; }
};

// ForwardEuler's update x + f * dt as land::EulerUpdate, each tendency (the
// top levels' with their Flux BCs) also written
template <typename T, int NZ, bool VEG, bool SNOW>
struct EulerFullUpdate : ExplicitSink<T> {
    T (&U)[NZ];
    T (&sat)[NZ];
    Surface<T>& s;
    const FullWriter<T>& w;
    const T dt;
    SOIL_FN EulerFullUpdate(T (&U_)[NZ], T (&sat_)[NZ], Surface<T>& s_, const FullWriter<T>& w_,
                            const T dt_)
        : U(U_), sat(sat_), s(s_), w(w_), dt(dt_) {}
    SOIL_FN void energy(int k, T f) {
        w.tend(w.io.tend.U, k, f);
        U[k] = U[k] + f * dt;
    }
    SOIL_FN void energy_top(T dU, T G, T dz_top) {
        const T m = dU - G / dz_top;
        w.tend(w.io.tend.U, NZ - 1, m);
        U[NZ - 1] = U[NZ - 1] + m * dt;
    }
    SOIL_FN void water(int k, T f) {
        w.tend(w.io.tend.sat, k, f);
        sat[k] = sat[k] + f * dt;
    }
    SOIL_FN void water_top(T A, T infil, T dz_top) {
        const T m = A - (T(-1) * infil) / dz_top;
        w.tend(w.io.tend.sat, NZ - 1, m);
        sat[NZ - 1] = sat[NZ - 1] + m * dt;
    }
    SOIL_FN void pool(T p) {
        w.tend(w.io.tend.S, p);
        s.S = s.S + p * dt;
    }
    SOIL_FN void surface(const SurfaceRates<T>& r) {
        w.tend(w.io.tend.Ts, T(0));
        s.Ts = r.Ts + T(0) * dt;
        if (VEG) {
            w.tend(w.io.tend.w, r.dw);
            w.tend(w.io.tend.C, r.dC);
            w.tend(w.io.tend.nu, r.dnu);
            s.w = s.w + r.dw * dt;
            s.C = s.C + r.dC * dt;
            s.nu = s.nu + r.dnu * dt;
            s.An = r.An;
        }
        if (SNOW) {
            w.tend(w.io.tend.swe, r.dswe);
            s.swe = vmax(s.swe + r.dswe * dt, T(0));
        }
    }
};

// Heun's corrector as land::HeunUpdate, each mean tendency (the top levels'
// with x_n's Flux BCs) also written
template <typename T, int NZ, bool VEG, bool SNOW>
struct HeunFullUpdate : ExplicitSink<T> {
    T (&U)[NZ];
    T (&sat)[NZ];
    Surface<T>& s;
    const Rates<T, NZ>& r;
    const FullWriter<T>& w;
    const T dt;
    SOIL_FN HeunFullUpdate(T (&U_)[NZ], T (&sat_)[NZ], Surface<T>& s_, const Rates<T, NZ>& r_,
                           const FullWriter<T>& w_, const T dt_)
        : U(U_), sat(sat_), s(s_), r(r_), w(w_), dt(dt_) {}
    SOIL_FN void energy(int k, T g) {
        const T m = T(0.5) * (r.U[k] + g);
        w.tend(w.io.tend.U, k, m);
        U[k] = U[k] + m * dt;
    }
    SOIL_FN void energy_top(T dU, T, T dz_top) {
        const T m = T(0.5) * (r.U[NZ - 1] + dU) - r.G / dz_top;
        w.tend(w.io.tend.U, NZ - 1, m);
        U[NZ - 1] = U[NZ - 1] + m * dt;
    }
    SOIL_FN void water(int k, T g) {
        const T m = T(0.5) * (r.sat[k] + g);
        w.tend(w.io.tend.sat, k, m);
        sat[k] = sat[k] + m * dt;
    }
    SOIL_FN void water_top(T A, T, T dz_top) {
        const T m = T(0.5) * (r.sat[NZ - 1] + A) - (T(-1) * r.infil) / dz_top;
        w.tend(w.io.tend.sat, NZ - 1, m);
        sat[NZ - 1] = sat[NZ - 1] + m * dt;
    }
    SOIL_FN void pool(T p) {
        const T m = T(0.5) * (r.dS + p);
        w.tend(w.io.tend.S, m);
        s.S = s.S + m * dt;
    }
    SOIL_FN void surface(const SurfaceRates<T>& q) {
        const T mTs = T(0.5) * (T(0) + T(0));
        w.tend(w.io.tend.Ts, mTs);
        s.Ts = r.surf.Ts + mTs * dt;
        if (VEG) {
            const T mw = T(0.5) * (r.surf.dw + q.dw);
            const T mC = T(0.5) * (r.surf.dC + q.dC);
            const T mnu = T(0.5) * (r.surf.dnu + q.dnu);
            w.tend(w.io.tend.w, mw);
            w.tend(w.io.tend.C, mC);
            w.tend(w.io.tend.nu, mnu);
            s.w = s.w + mw * dt;
            s.C = s.C + mC * dt;
            s.nu = s.nu + mnu * dt;
            s.An = r.surf.An;
        }
        if (SNOW) {
            const T mswe = T(0.5) * (r.surf.dswe + q.dswe);
            w.tend(w.io.tend.swe, mswe);
            s.swe = vmax(s.swe + mswe * dt, T(0));
        }
    }
};

// The full step of column `col` by STEPPER (soil::STEPPER_EULER, _HEUN or
// _IMPLICIT with `iters` Picard iterations, the solves by `solver`,
// soil::SOLVER_THOMAS or _PCR, and inv_dt = 1 / dt as the host rounds it):
// reads the column from io and the static inputs, writes every field of
// io's outputs. The root fractions of level k at root[k * root_row_stride
// + col * root_cell_stride] (VEG).
template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, bool SNOW,
          int STEPPER>
SOIL_FN void full_step_column(const LandFullStepIO& io, const LandInputs& inputs,
                              const T* root, const long long root_row_stride,
                              const long long root_cell_stride, const long long col,
                              const long long cells, const soil::Consts<T>& sc,
                              const LandColumnParams<T>& c, const T* dz, const T* dzf,
                              const T* zc, const T* zf, const T dt, const T inv_dt,
                              const int iters, const int solver)
{
    const FullWriter<T> w{io, col, cells};
    T U[NZ], sat[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        U[k] = static_cast<const T*>(io.in.U)[k * cells + col];
        sat[k] = static_cast<const T*>(io.in.sat)[k * cells + col];
    }
    Surface<T> s{};
    s.Ts = static_cast<const T*>(io.in.Ts)[col];
    if (RICHARDS) s.S = static_cast<const T*>(io.in.S)[col];
    if (VEG) {
        s.w = static_cast<const T*>(io.in.w)[col];
        s.C = static_cast<const T*>(io.in.C)[col];
        s.nu = static_cast<const T*>(io.in.nu)[col];
        s.An = static_cast<const T*>(io.in.An)[col];
    }
    if (SNOW) s.swe = static_cast<const T*>(io.in.swe)[col];
    const T* rf = VEG ? root + col * root_cell_stride : nullptr;
    Forcing<T> f;
#pragma unroll
    for (int i = 0; i < LAND_NIN; ++i)
        f.v[i] = static_cast<const T*>(inputs.ptr[i])[col * inputs.cell_stride[i]];
    const T dz_top = dz[NZ - 1];

    if constexpr (STEPPER == soil::STEPPER_HEUN) {
        Rates<T, NZ> r;
        closure_rhs<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW>(U, sat, s, f, sc, c, dz, dzf, zc, zf,
                                                            rf, root_row_stride, r, w);
        // the stage, as land::heun_step forms it; the inputs are static
        T yU[NZ], ys[NZ];
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            yU[k] = k < NZ - 1 ? U[k] + r.U[k] * dt : U[k] + (r.U[k] - r.G / dz_top) * dt;
            if (!RICHARDS) ys[k] = sat[k];
            else if (k < NZ - 1) ys[k] = sat[k] + r.sat[k] * dt;
            else ys[k] = sat[k] + (r.sat[k] - (T(-1) * r.infil) / dz_top) * dt;
        }
        Surface<T> y = s;
        if (RICHARDS) y.S = s.S + r.dS * dt;
        y.Ts = r.surf.Ts + T(0) * dt;
        if (VEG) {
            y.w = s.w + r.surf.dw * dt;
            y.C = s.C + r.surf.dC * dt;
            y.nu = s.nu + r.surf.dnu * dt;
            y.An = r.surf.An;
        }
        if (SNOW) y.swe = vmax(s.swe + r.surf.dswe * dt, T(0));
        HeunFullUpdate<T, NZ, VEG, SNOW> out{U, sat, s, r, w, dt};
        closure_rhs<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW>(yU, ys, y, f, sc, c, dz, dzf, zc,
                                                            zf, rf, root_row_stride, out);
    } else if constexpr (STEPPER == soil::STEPPER_IMPLICIT) {
        // iteration 0 from the stored start; its tendencies are the step's
        ImplicitRates<T, NZ> r;
        closure_rhs<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW>(U, sat, s, f, sc, c, dz, dzf, zc, zf,
                                                            rf, root_row_stride, r, w);
        r.U[NZ - 1] = r.U[NZ - 1] - r.G / dz_top;
        if (RICHARDS) r.sat[NZ - 1] = r.sat[NZ - 1] - (T(-1) * r.infil) / dz_top;
        T Un[NZ], sn[NZ];
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            w.tend(io.tend.U, k, r.U[k]);
            if (RICHARDS) w.tend(io.tend.sat, k, r.sat[k]);
            Un[k] = U[k];
            sn[k] = sat[k];
        }
        if (RICHARDS) w.tend(io.tend.S, r.dS);
        w.tend(io.tend.Ts, T(0));
        if (VEG) {
            w.tend(io.tend.w, r.surf.dw);
            w.tend(io.tend.C, r.surf.dC);
            w.tend(io.tend.nu, r.surf.dnu);
        }
        if (SNOW) w.tend(io.tend.swe, r.surf.dswe);
        implicit_solves<T, NZ, RICHARDS, CURVE, soil::SOLVER_RUNTIME>(r, U, sat, sc, c, dz,
                                                                   dzf, inv_dt, solver);
        if (RICHARDS) s.S = s.S + r.dS * dt;
        s.Ts = r.surf.Ts + T(0) * dt;
        if (VEG) {
            s.w = s.w + r.surf.dw * dt;
            s.C = s.C + r.surf.dC * dt;
            s.nu = s.nu + r.surf.dnu * dt;
            s.An = r.surf.An;
        }
        if (SNOW) s.swe = s.swe + r.surf.dswe * dt;
        // further iterations at the closed iterate, as land::picard_step's
#pragma unroll 1
        for (int it = 1; it < iters; ++it) {
            ImplicitRates<T, NZ> q;
            Surface<T> y = s;
            closure_rhs<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW>(U, sat, y, f, sc, c, dz, dzf, zc,
                                                                zf, rf, root_row_stride, q);
            q.U[NZ - 1] = q.U[NZ - 1] - q.G / dz_top;
            if (RICHARDS) q.sat[NZ - 1] = q.sat[NZ - 1] - (T(-1) * q.infil) / dz_top;
#pragma unroll
            for (int k = 0; k < NZ; ++k) {
                q.U[k] = q.U[k] - (U[k] - Un[k]) / dt;
                if (RICHARDS) q.sat[k] = q.sat[k] - (sat[k] - sn[k]) / dt;
            }
            implicit_solves<T, NZ, RICHARDS, CURVE, soil::SOLVER_RUNTIME>(q, U, sat, sc, c, dz,
                                                                   dzf, inv_dt, solver);
        }
        if (SNOW) s.swe = vmax(s.swe, T(0));
    } else {
        EulerFullUpdate<T, NZ, VEG, SNOW> out{U, sat, s, w, dt};
        closure_rhs<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW>(U, sat, s, f, sc, c, dz, dzf, zc, zf,
                                                            rf, root_row_stride, out, w);
    }

    // the trailing closure: saturation adjustment and water table, then
    // level by level the energy closure and the pressure head
    T wt = T(0);
    if (RICHARDS) {
        T spill;
        unsigned spilled, clipped;
        soil::sweeps<T, NZ>(sat, spill, wt, spilled, clipped, dz, zf);
        s.S = s.S + spill;
        w.aux(AUX_WT, wt);
    }
    T T_top = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        const soil::Level<T, false> v(sat[k], U[k], sc, c.soil);
        static_cast<T*>(io.out.U)[k * cells + col] = U[k];
        w.aux(AUX_T, k, v.Tk);
        w.aux(AUX_LIQ, k, v.liq);
        T_top = v.Tk;
        if (RICHARDS) {
            static_cast<T*>(io.out.sat)[k * cells + col] = sat[k];
            w.aux(AUX_PSI, k, CURVE == CURVE_BC ? bc_head<T>(sat[k], wt, zc[k], sc, c)
                                                : soil::Head<T>(sat[k], wt, zc[k], sc, c.soil).psi);
        }
    }
    w.aux(AUX_TG, T_top);
    static_cast<T*>(io.out.Ts)[col] = s.Ts;
    if (RICHARDS) static_cast<T*>(io.out.S)[col] = s.S;
    if (VEG) {
        static_cast<T*>(io.out.w)[col] = s.w;
        static_cast<T*>(io.out.C)[col] = s.C;
        static_cast<T*>(io.out.nu)[col] = s.nu;
        static_cast<T*>(io.out.An)[col] = s.An;
    }
    if (SNOW) static_cast<T*>(io.out.swe)[col] = s.swe;
}

}  // namespace land
