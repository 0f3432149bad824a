// One full (not closure-rotated) soil step on one column: every leaf of the
// state in and out.
//
// ForwardEuler.step, Heun.step and ImplicitEuler.step of a SoilModel
// (stepping.py:106-114, :150-165 and implicit.py:168-171 in the JAX package;
// timesteppers/stepping.py and implicit.py in the port) with a
// Dirichlet top temperature as the only BC, heat + Richards flow (Van
// Genuchten, Mualem conductivity) or heat only (NoFlow, linear
// conductivity). Unlike the rollouts' pre_closure_step, the step does not
// start with a closure: update_state reads the temperature, liquid fraction
// and pressure head as the state holds them, and computes the conductivities
// from the stored saturation and liquid fraction (stored_rhs below). The
// step then writes
//   prognostics   U, and for Richards sat and S (after the trailing closure)
//   tendencies    dU, dsat, dS (Heun: the mean of its two stages;
//                 ImplicitEuler: those of its first Picard iteration)
//   auxiliaries   the face hydraulic conductivity of the start state; T,
//                 liq, the ground temperature, and for Richards the pressure
//                 head and the water table, from the trailing closure.
// Heun's stage is a closure-rotated step from y = x + f dt, closure_rhs of
// soil_step.cuh, as the module stage closes y and then updates its state.
// ImplicitEuler's first Picard iteration takes its rows from the stored
// start too (the conductivities and dT/dU from the stored liquid fraction,
// the Darcy face K from the stored pressure head, d(Psi)/d(sat) from the
// stored saturation); each further iteration closes the iterate and
// re-solves as soil::picard_step does.
//
// Plain C++ apart from the function qualifiers (soil_step.cuh), so that the
// host build (tests/soil_step_host.cpp) holds it to the plain version.

#pragma once

#include "soil_step.cuh"

extern "C" {
// Mirror of terrarium_tpu_torch.ops.fused_step._CFullStepIO (ctypes): the
// fields of one full step, each (NZ, cells), (NZ + 1, cells) or (cells,),
// element (k, col) at k * cells + col. The top temperature at the state's
// clock time and at one step later is top[col * top_cell_stride] and
// top[top_row_stride + col * top_cell_stride]. The heat-only model reads
// sat and writes no S, psi, sat_out, dsat, dS or water_table (null).
struct SoilFullStepIO {
    const void *U, *sat, *S, *T, *liq, *psi, *top;
    long long top_row_stride, top_cell_stride;
    void *U_out, *sat_out, *S_out, *dU, *dsat, *dS;
    void *T_out, *liq_out, *psi_out, *K_face, *ground_T, *water_table;
};
}

namespace soil {

// update_state's tendencies at the start of a full step, into `out` as
// closure_rhs emits them, and the face hydraulic conductivity into K_face.
// Reads sat (in registers, before any water update of `out`), S and, from
// global memory, the stored T, liq and psi of column `col`. TERMS (the
// implicit step): also each level's terms, out.level(k, U[k], v), and each
// face's Darcy conductivity, out.darcy_face(f, K_eff), as closure_rhs
// emits them, U the column's energy.
template <typename T, int NZ, bool HEAT, bool TERMS = false, class Out>
SOIL_FN void stored_rhs(const T (&sat)[NZ], const T S, const T* Tg, const T* liqg,
                        const T* psig, const long long col, const long long cells,
                        const T vtop, const Consts<T>& c, const SoilColumnParams& P,
                        const T* dz, const T* dzf, T* K_face, Out& out,
                        const T* U = nullptr)
{
    T Kc[NZ];
    T T_prev = T(0), kap_prev = T(0), qh_prev = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        const Stored<T, HEAT, TERMS> v(sat[k], liqg[k * cells + col], c, P);
        const T Tk = Tg[k * cells + col];
        Kc[k] = v.Kc;
        if constexpr (TERMS) out.level(k, U[k], v);
        const T kf = T(0.5) * (v.kap + (k == 0 ? v.kap : kap_prev));
        const T qh = -kf * ((Tk - (k == 0 ? Tk : T_prev)) / dzf[k]);
        if (k > 0) out.energy(k - 1, -((qh - qh_prev) / dz[k - 1]));
        qh_prev = qh;
        T_prev = Tk;
        kap_prev = v.kap;
    }
    {   // top face: Dirichlet ghost 2*v - T_top
        const T ghost = T(2) * vtop - T_prev;
        const T kf = T(0.5) * (kap_prev + kap_prev);
        const T qh = -kf * ((ghost - T_prev) / dzf[NZ]);
        out.energy(NZ - 1, -((qh - qh_prev) / dz[NZ - 1]));
    }
#pragma unroll
    for (int f = 0; f <= NZ; ++f) K_face[f * cells + col] = face_K<T, NZ>(Kc, f);
    if (HEAT) return;

    T psi_prev = T(0), qw_prev = T(0);
#pragma unroll
    for (int k = 0; k <= NZ; ++k) {
        const T psi_k = k < NZ ? psig[k * cells + col] : psi_prev;
        const T lower = k == 0 ? psi_k : psi_prev;
        const T grad = (psi_k - lower) / dzf[k];
        const T K_lo = k == 0 ? T(INFINITY) : face_K<T, NZ>(Kc, k - 1);
        const T K_hi = k == NZ ? T(INFINITY) : face_K<T, NZ>(Kc, k + 1);
        const T K_k = face_K<T, NZ>(Kc, k);
        const T K_eff = grad < T(0) ? vmin(K_lo, K_k) : vmin(K_k, K_hi);
        const T qw = -K_eff * grad;
        if constexpr (TERMS) out.darcy_face(k, K_eff);
        if (k > 0) out.water(k - 1, (-((qw - qw_prev) / dz[k - 1])) / c.por);
        qw_prev = qw;
        psi_prev = psi_k;
    }
    out.pool(vmin(T(0), S));
}

// ForwardEuler's update x + f * dt, each tendency also stored
template <typename T, int NZ>
struct EulerFullUpdate : ExplicitSink<T> {
    T (&U)[NZ];
    T (&sat)[NZ];
    T& S;
    T *dU, *dsat, *dS;
    const long long col, cells;
    const T dt;
    SOIL_FN EulerFullUpdate(T (&U_)[NZ], T (&sat_)[NZ], T& S_, T* dU_, T* dsat_, T* dS_,
                            long long col_, long long cells_, const T dt_)
        : U(U_), sat(sat_), S(S_), dU(dU_), dsat(dsat_), dS(dS_), col(col_), cells(cells_),
          dt(dt_) {}
    SOIL_FN void energy(int k, T f) { dU[k * cells + col] = f; U[k] = U[k] + f * dt; }
    SOIL_FN void water(int k, T f) { dsat[k * cells + col] = f; sat[k] = sat[k] + f * dt; }
    SOIL_FN void pool(T f) { dS[col] = f; S = S + f * dt; }
};

// Heun's corrector x + m * dt with m = 0.5 * (f_n + f*), each m stored
template <typename T, int NZ>
struct HeunFullUpdate : ExplicitSink<T> {
    T (&U)[NZ];
    T (&sat)[NZ];
    T& S;
    const Tendencies<T, NZ>& f;
    T *dU, *dsat, *dS;
    const long long col, cells;
    const T dt;
    SOIL_FN HeunFullUpdate(T (&U_)[NZ], T (&sat_)[NZ], T& S_, const Tendencies<T, NZ>& f_,
                           T* dU_, T* dsat_, T* dS_, long long col_, long long cells_,
                           const T dt_)
        : U(U_), sat(sat_), S(S_), f(f_), dU(dU_), dsat(dsat_), dS(dS_), col(col_),
          cells(cells_), dt(dt_) {}
    SOIL_FN void energy(int k, T g) {
        const T m = T(0.5) * (f.U[k] + g);
        dU[k * cells + col] = m;
        U[k] = U[k] + m * dt;
    }
    SOIL_FN void water(int k, T g) {
        const T m = T(0.5) * (f.sat[k] + g);
        dsat[k * cells + col] = m;
        sat[k] = sat[k] + m * dt;
    }
    SOIL_FN void pool(T g) {
        const T m = T(0.5) * (f.S + g);
        dS[col] = m;
        S = S + m * dt;
    }
};

// The full step of column `col` (HEUN: Heun; IMPLICIT: ImplicitEuler with
// `iters` Picard iterations, the solves by `solver`, soil::SOLVER_THOMAS or
// _PCR, and inv_dt = 1 / dt as the host rounds it; else ForwardEuler):
// reads the column from io, writes every field of io's outputs.
template <typename T, int NZ, bool HEUN, bool HEAT, bool IMPLICIT = false>
SOIL_FN void full_step_column(const SoilFullStepIO& io, const long long col,
                              const long long cells, const Consts<T>& c,
                              const SoilColumnParams& P, const T* dz, const T* dzf,
                              const T* zc, const T* zf, const T dt, const T inv_dt = T(0),
                              const int iters = 1, const int solver = SOLVER_PCR)
{
    static_assert(!(HEUN && IMPLICIT), "one stepper");
    const T* Ug = static_cast<const T*>(io.U);
    const T* satg = static_cast<const T*>(io.sat);
    const T* top = static_cast<const T*>(io.top) + col * io.top_cell_stride;
    T* dU = static_cast<T*>(io.dU);
    T* dsat = static_cast<T*>(io.dsat);
    T* dS = static_cast<T*>(io.dS);
    T U[NZ], sat[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        U[k] = Ug[k * cells + col];
        sat[k] = satg[k * cells + col];
    }
    T S = HEAT ? T(0) : static_cast<const T*>(io.S)[col];
    const T* Tg = static_cast<const T*>(io.T);
    const T* liqg = static_cast<const T*>(io.liq);
    const T* psig = static_cast<const T*>(io.psi);
    T* K_face = static_cast<T*>(io.K_face);

    if constexpr (HEUN) {
        Tendencies<T, NZ> f;
        stored_rhs<T, NZ, HEAT>(sat, S, Tg, liqg, psig, col, cells, top[0], c, P, dz, dzf,
                                K_face, f);
        T yU[NZ], ys[NZ];
        T yS = HEAT ? T(0) : S + f.S * dt;
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            yU[k] = U[k] + f.U[k] * dt;
            ys[k] = HEAT ? sat[k] : sat[k] + f.sat[k] * dt;
        }
        HeunFullUpdate<T, NZ> out{U, sat, S, f, dU, dsat, dS, col, cells, dt};
        closure_rhs<T, NZ, HEAT>(yU, ys, yS, top[io.top_row_stride], c, P, dz, dzf, zc, zf,
                                 out);
    } else if constexpr (IMPLICIT) {
        // iteration 0 from the stored start; its tendencies are the step's
        ImplicitTerms<T, NZ> f;
        stored_rhs<T, NZ, HEAT, true>(sat, S, Tg, liqg, psig, col, cells, top[0], c, P, dz,
                                      dzf, K_face, f, U);
        const auto chain = [&](int k) { return water_chain<T>(sat[k], c, P); };
        T Un[NZ], sn[NZ];
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            dU[k * cells + col] = f.U[k];
            if (!HEAT) dsat[k * cells + col] = f.sat[k];
            Un[k] = U[k];
            sn[k] = sat[k];
        }
        if (!HEAT) dS[col] = f.S;
        implicit_solves<T, NZ, !HEAT, true, SOLVER_RUNTIME>(f, U, sat, c.inv_por, chain, dz, dzf,
                                                          inv_dt, solver);
        if (!HEAT) S = S + f.S * dt;
        // further iterations at the closed iterate, the top temperature at
        // the step's clock time; the spill of the iterate's closure dropped
#pragma unroll 1
        for (int it = 1; it < iters; ++it) {
            ImplicitTerms<T, NZ> g;
            T Sk = S;
            closure_rhs<T, NZ, HEAT>(U, sat, Sk, top[0], c, P, dz, dzf, zc, zf, g);
#pragma unroll
            for (int k = 0; k < NZ; ++k) {
                g.U[k] = g.U[k] - (U[k] - Un[k]) / dt;
                if (!HEAT) g.sat[k] = g.sat[k] - (sat[k] - sn[k]) / dt;
            }
            implicit_solves<T, NZ, !HEAT, true, SOLVER_RUNTIME>(g, U, sat, c.inv_por, chain, dz,
                                                              dzf, inv_dt, solver);
        }
    } else {
        EulerFullUpdate<T, NZ> out{U, sat, S, dU, dsat, dS, col, cells, dt};
        stored_rhs<T, NZ, HEAT>(sat, S, Tg, liqg, psig, col, cells, top[0], c, P, dz, dzf,
                                K_face, out);
    }

    // the trailing closure: saturation adjustment and water table, then
    // level by level the energy closure and the pressure head
    T wt = T(0);
    if (!HEAT) {
        T spill;
        unsigned spilled, clipped;
        sweeps<T, NZ>(sat, spill, wt, spilled, clipped, dz, zf);
        S = S + spill;
    }
    T* T_out = static_cast<T*>(io.T_out);
    T* liq_out = static_cast<T*>(io.liq_out);
    T* psi_out = static_cast<T*>(io.psi_out);
    T* U_out = static_cast<T*>(io.U_out);
    T* sat_out = static_cast<T*>(io.sat_out);
    T T_top = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        const Level<T, false> v(sat[k], U[k], c, P);
        U_out[k * cells + col] = U[k];
        T_out[k * cells + col] = v.Tk;
        liq_out[k * cells + col] = v.liq;
        T_top = v.Tk;
        if (!HEAT) {
            sat_out[k * cells + col] = sat[k];
            psi_out[k * cells + col] = Head<T>(sat[k], wt, zc[k], c, P).psi;
        }
    }
    static_cast<T*>(io.ground_T)[col] = T_top;
    if (!HEAT) {
        static_cast<T*>(io.S_out)[col] = S;
        static_cast<T*>(io.water_table)[col] = wt;
    }
}

}  // namespace soil
