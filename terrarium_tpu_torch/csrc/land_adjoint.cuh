// The adjoint of one closure-rotated LandModel step on one column
// (csrc/land_step.cuh), and the segment VJP of a column built on it: the
// column code of csrc/land_column_segment_vjp.cu.
//
// land::closure_rhs_adjoint is land::closure_rhs taken in reverse: the
// closure is recomputed from the step's input carry (the saturation sweeps
// with their predicates, each level's closure, centre K and head, the
// plant-available water), then the pieces are undone in reverse order:
// the Richards flow with the ET sink on the top level, the surface block
// (pool, infiltration, SEB sweeps with their drags, evapotranspiration,
// interception, vegetation, ground resistance: everything between the soil
// column and the tendencies that is one value a column), the heat flux,
// and level by level the head, the linear centre K, the plant-available
// water and the energy closure (soil::level_adjoint), then the down and
// up sweeps. land::step_adjoint is ForwardEuler's update on it and
// land::implicit_step_adjoint<SOLVER> ImplicitEuler's with one Picard
// iteration: each tridiagonal solve undone by one solve of the transposed
// rows with the same solver (soil::solve_adjoint, never differentiating
// the elimination), then the rows' assembly and the terms' way back into
// closure_rhs_adjoint through the sink's level and darcy_face outputs.
//
// The surface block maps ten values of a column (the ground temperature,
// the top level's water, the plant-available water's beta, the top centre
// K, the closed pool, and the carried skin temperature, canopy water,
// carbon, vegetation fraction and net assimilation) to nine (the ground
// heat flux, the humidity flux, the infiltration, the pool tendency, the
// skin temperature after the second skin update and the canopy water,
// carbon and vegetation fraction tendencies and the new net assimilation).
// Its Jacobian is formed column by column in forward mode (land::Dual, one
// tangent a pass, ten passes), then contracted with the outputs'
// cotangents: a transposed forward sweep instead of a reverse one, so that
// the Monin-Obukhov drag's fixed iterations, three drags a step, need no
// stored iterates. The derivatives are the same exact ones either way.
//
// Branch conventions, taken from torch autograd of the plain version (the
// process modules), where it differentiates each piece:
// * torch.clamp(x, lo, hi) and its one-sided forms (every vmax / vmin of a
//   value against a bound in the step): the cotangent passes where
//   lo <= x <= hi, bounds included; torch.minimum (the infiltration's
//   min(influx, K_top), the pool's min(max(S, 0) / tau_r, S)) and the face
//   and upwind K (soil::min_adjoint): a tie splits it 0.5/0.5;
// * the pool term at an empty pool (S == 0): derivative 0, as
//   hydrology.py::pool_drainage takes it (an empty pool neither drains nor
//   grows);
// * torch.where (e_sat's two branches, the psi branches, the ground
//   resistance, the drainage, f_soil's Tg > 7, the stress window, the
//   photosynthesis gate): the taken branch only. torch evaluates both and
//   masks the cotangent, so an untaken branch whose own derivative is
//   infinite gives 0 * inf = NaN; here it contributes an exact 0. That
//   happens where the photosynthesis is gated off and its co-limitation's
//   discriminant is 0 (no shortwave, or air outside the stress window):
//   torch gives NaN for the carbon's cotangent there, this adjoint 0;
// * sqrt(disc) at disc == 0 inside the taken photosynthesis branch (the
//   stress window's zero at and above T_CO2_high): torch's 1 / (2 sqrt(0))
//   times the clamp's pass gives NaN; here the root contributes 0;
// * the soil's conventions are soil_step.cuh's (above soil::min_adjoint).
//
// Plain C++ apart from SOIL_FN, so the header also compiles for the host.

#pragma once

#include "land_step.cuh"

namespace land {

SOIL_FN float d_sin(float x) { return sinf(x); }
SOIL_FN double d_sin(double x) { return sin(x); }

// ---------------------------------------------------------------------------
// forward-mode numbers of the surface block
// ---------------------------------------------------------------------------

// a value and its tangent along one input direction
template <typename T>
struct Dual {
    T v, d;
    SOIL_FN Dual() : v(T(0)), d(T(0)) {}
    SOIL_FN explicit Dual(T v_, T d_ = T(0)) : v(v_), d(d_) {}
};

template <typename T> SOIL_FN Dual<T> operator-(Dual<T> a) { return Dual<T>(-a.v, -a.d); }
template <typename T> SOIL_FN Dual<T> operator+(Dual<T> a, Dual<T> b) {
    return Dual<T>(a.v + b.v, a.d + b.d);
}
template <typename T> SOIL_FN Dual<T> operator+(Dual<T> a, T b) { return Dual<T>(a.v + b, a.d); }
template <typename T> SOIL_FN Dual<T> operator+(T a, Dual<T> b) { return Dual<T>(a + b.v, b.d); }
template <typename T> SOIL_FN Dual<T> operator-(Dual<T> a, Dual<T> b) {
    return Dual<T>(a.v - b.v, a.d - b.d);
}
template <typename T> SOIL_FN Dual<T> operator-(Dual<T> a, T b) { return Dual<T>(a.v - b, a.d); }
template <typename T> SOIL_FN Dual<T> operator-(T a, Dual<T> b) { return Dual<T>(a - b.v, -b.d); }
template <typename T> SOIL_FN Dual<T> operator*(Dual<T> a, Dual<T> b) {
    return Dual<T>(a.v * b.v, a.d * b.v + a.v * b.d);
}
template <typename T> SOIL_FN Dual<T> operator*(Dual<T> a, T b) { return Dual<T>(a.v * b, a.d * b); }
template <typename T> SOIL_FN Dual<T> operator*(T a, Dual<T> b) { return Dual<T>(a * b.v, a * b.d); }
template <typename T> SOIL_FN Dual<T> operator/(Dual<T> a, Dual<T> b) {
    const T q = a.v / b.v;
    return Dual<T>(q, (a.d - q * b.d) / b.v);
}
template <typename T> SOIL_FN Dual<T> operator/(Dual<T> a, T b) { return Dual<T>(a.v / b, a.d / b); }
template <typename T> SOIL_FN Dual<T> operator/(T a, Dual<T> b) {
    const T q = a / b.v;
    return Dual<T>(q, -(q * b.d) / b.v);
}

template <typename T> SOIL_FN Dual<T> dexp(Dual<T> x) {
    const T e = d_exp(x.v);
    return Dual<T>(e, x.d * e);
}
template <typename T> SOIL_FN Dual<T> dlog(Dual<T> x) {
    return Dual<T>(soil::d_log(x.v), x.d / x.v);
}
template <typename T> SOIL_FN Dual<T> dcos(Dual<T> x) {
    return Dual<T>(d_cos(x.v), -(x.d * d_sin(x.v)));
}
template <typename T> SOIL_FN Dual<T> datan(Dual<T> x) {
    return Dual<T>(d_atan(x.v), x.d / (T(1) + x.v * x.v));
}
// x ** p for a fixed p: p x^(p - 1), torch.pow's derivative
template <typename T> SOIL_FN Dual<T> dpow(Dual<T> x, T p) {
    return Dual<T>(soil::d_pow(x.v, p), x.d * (p * soil::d_pow(x.v, p - T(1))));
}
// the co-limitation's root: 0 tangent at 0 (see the conventions above)
template <typename T> SOIL_FN Dual<T> dsqrt0(Dual<T> x) {
    const T r = soil::d_sqrt(x.v);
    return Dual<T>(r, r > T(0) ? x.d * (T(0.5) / r) : T(0));
}

// torch.clamp's rule: the tangent passes where lo <= x (x <= hi), bounds
// included; the value is vmax's / vmin's
template <typename T> SOIL_FN Dual<T> clamp_lo(Dual<T> x, T lo) {
    return (x.v != x.v || x.v >= lo) ? x : Dual<T>(lo);
}
template <typename T> SOIL_FN Dual<T> clamp_hi(Dual<T> x, T hi) {
    return (x.v != x.v || x.v <= hi) ? x : Dual<T>(hi);
}
template <typename T> SOIL_FN Dual<T> clamp(Dual<T> x, T lo, T hi) {
    return clamp_hi(clamp_lo(x, lo), hi);
}
// torch.minimum's rule: the smaller side's tangent, the mean at a tie
template <typename T> SOIL_FN Dual<T> minimum(Dual<T> a, Dual<T> b) {
    if (a.v < b.v) return a;
    if (b.v < a.v) return b;
    return Dual<T>(a.v, T(0.5) * (a.d + b.d));
}

// ---------------------------------------------------------------------------
// the surface block in forward mode, operation for operation as closure_rhs
// ---------------------------------------------------------------------------

template <typename T>
SOIL_FN Dual<T> e_sat_d(Dual<T> Tc) {
    Tc = clamp(Tc, T(-150), T(150));
    return Tc.v <= T(0) ? T(611) * dexp((T(22.46) * Tc) / (Tc + T(272.62)))
                        : T(611) * dexp((T(17.62) * Tc) / (Tc + T(243.12)));
}

template <typename T>
SOIL_FN Dual<T> vpd_d(Dual<T> Tc, T e_air) { return clamp_lo(e_sat_d(Tc) - e_air, T(0.1)); }

template <typename T>
SOIL_FN void mo_psi_d(const Dual<T> zeta, Dual<T>& pm, Dual<T>& ph, const LandColumnParams<T>& c) {
    if (zeta.v < T(0)) {
        const Dual<T> zu = clamp_hi(zeta, T(0));
        const Dual<T> x = dpow(T(1) - T(16) * zu, T(0.25));
        const Dual<T> x2 = x * x;
        const Dual<T> l2 = dlog((T(1) + x2) / T(2));
        pm = ((T(2) * dlog((T(1) + x) / T(2)) + l2) - T(2) * datan(x)) + c.pi / T(2);
        ph = T(2) * l2;
    } else {
        pm = ph = T(-5) * clamp(clamp_lo(zeta, T(0)), T(0), T(1));
    }
}

template <typename T>
SOIL_FN Dual<T> drag_d(const T Ta, const Dual<T> Ts, const T Vr, const LandColumnParams<T>& c) {
    if (!c.mo_drag) return Dual<T>(c.C_h);
    const Dual<T> Tbar = T(0.5) * (Ta + Ts) + c.T_ref;
    const Dual<T> dtheta = Ta - Ts;
    Dual<T> inv_L, pm, ph;
    for (int it = 0; it < c.mo_iterations; ++it) {
        mo_psi_d(clamp(c.mo_z * inv_L, T(-10), T(1)), pm, ph, c);
        const Dual<T> u_star = c.kappa * Vr / clamp_lo(c.mo_ln_m - pm, T(0.1));
        const Dual<T> th_star = c.kappa * dtheta / clamp_lo(c.mo_ln_h - ph, T(0.1));
        inv_L = c.kappa_g * th_star / clamp_lo(u_star * u_star * Tbar, T(1e-12));
    }
    mo_psi_d(clamp(c.mo_z * inv_L, T(-10), T(1)), pm, ph, c);
    return c.kappa2 / (clamp_lo(c.mo_ln_m - pm, T(0.1)) * clamp_lo(c.mo_ln_h - ph, T(0.1)));
}

template <typename T>
SOIL_FN Dual<T> resistance_d(const T Ta, const Dual<T> Ts, const T Vr,
                             const LandColumnParams<T>& c) {
    return T(1) / (drag_d(Ta, Ts, Vr, c) * Vr);
}

template <typename T>
SOIL_FN Dual<T> ground_flux_d(const Dual<T> Ts, const Dual<T> r_a, const Forcing<T>& f,
                              const Dual<T> Q_h, const LandColumnParams<T>& c) {
    const T SW = f.v[IN_SW], LW = f.v[IN_LW], Ta = f.v[IN_TA];
    const T SW_up = c.albedo * SW;
    const Dual<T> Tk = Ts + c.T_ref;
    const Dual<T> LW_up = c.eps_sigma * ((Tk * Tk) * (Tk * Tk)) + c.one_minus_emis * LW;
    const Dual<T> R_net = ((SW_up - SW) + LW_up) - LW;
    const Dual<T> H_s = c.c_a_rho_a * ((Ts - Ta) / r_a);
    const Dual<T> H_l = c.L_rho_a * Q_h;
    return c.consistent_G ? (R_net + H_s) + H_l : (R_net - H_s) - H_l;
}

template <typename T>
SOIL_FN Dual<T> skin_d(const Dual<T> Tg, const Dual<T> G, const T dz_top,
                       const LandColumnParams<T>& c) {
    return Tg + clamp(-G * dz_top / c.two_kappa_s, -c.max_delta, c.max_delta);
}

template <typename T>
SOIL_FN Dual<T> f_temp_d(const Dual<T> Tc, const LandColumnParams<T>& c) {
    return dexp(T(308.56) * (c.inv_56_02 - T(1) / (T(46.02) + Tc)));
}

// the surface block's inputs and outputs (see the header comment)
enum { SI_TG = 0, SI_WTOP, SI_BETA, SI_KC, SI_S, SI_TS, SI_W, SI_C, SI_NU, SI_AN, SI_N };
enum { SO_G = 0, SO_QH, SO_INFIL, SO_POOL, SO_TS, SO_DW, SO_DC, SO_DNU, SO_AN, SO_N };

// land::vegetation in forward mode: LAI_b, gw, An and NPP of the carbon,
// the previous net assimilation, beta and the ground temperature
template <typename T>
SOIL_FN void vegetation_d(const Dual<T> Cv, const Dual<T> An0, const Dual<T> beta,
                          const Dual<T> Tg, const T e_air, const Forcing<T>& f,
                          const LandColumnParams<T>& c, Dual<T>& LAI, Dual<T>& gw,
                          Dual<T>& An, Dual<T>& NPP)
{
    const T Ta = f.v[IN_TA], SW = f.v[IN_SW], p = f.v[IN_P], co2 = f.v[IN_CO2];
    LAI = Cv / c.lai_den;
    const T vpd_a = vpd(Ta, e_air);
    const Dual<T> one_m_exp = T(1) - dexp(c.neg_k_ext_ph * LAI);
    const Dual<T> g0 = c.g0_coef * one_m_exp * beta;
    gw = g0 + T(1.6) * (T(1) + c.g1 / soil::d_sqrt(vpd_a)) * An0 / co2 * T(1.0e6);
    const T lam_c = T(1) - T(1) / (T(1) + c.g1 / soil::d_sqrt(vpd_a * T(1.0e-3)));
    An = Dual<T>(T(0));
    if (SW > T(0) && Ta > T(-3) && LAI.v > T(0)) {
        const T pO2 = T(0.209) * p;
        const T pa = co2 * T(1.0e-6) * p;
        const T x = (Ta - T(25)) * T(0.1);
        const T tau = c.tau25 * soil::d_pow(c.q10_tau, x);
        const T Kc = c.Kc25 * soil::d_pow(c.q10_Kc, x);
        const T Ko = c.Ko25 * soil::d_pow(c.q10_Ko, x);
        const T g_star = pO2 / (T(2) * tau);
        const T PAR = T(0.5) * SW * c.one_minus_alpha_leaf * c.cq;
        const Dual<T> APAR = c.alpha_a * PAR * one_m_exp;
        const T p_i = lam_c * pa;
        T T_stress = T(0);
        if (Ta > c.T_CO2_low && Ta < c.T_CO2_high) {
            const T low = T(1) / (T(1) + d_exp(c.k1 * (c.k2 - Ta)));
            const T high = T(1) - T(0.01) * d_exp(c.k3 * (Ta - c.T_photos_high));
            T_stress = low * high;
        }
        const T c1 = c.alpha_C3 * T_stress * c.C_mass * (p_i - g_star) / (p_i + T(2) * g_star);
        const T Kterm = p_i + Kc * (T(1) + pO2 / Ko);
        const T c2 = (p_i - g_star) / Kterm;
        const T Vc = c1 * PAR * Kterm / (p_i - g_star);
        const Dual<T> Rd = c.alpha_C3 * Vc * beta;
        const Dual<T> JE = c1 * APAR;
        const T JC = c2 * Vc;
        const Dual<T> s = JE + JC;
        const Dual<T> disc = clamp_lo(s * s - c.four_theta_r * JE * JC, T(0));
        An = (s - dsqrt0(disc)) / c.two_theta_r * beta - Rd;
    }
    const Dual<T> GPP = An * T(1.0e-3);
    const T f_air = f_temp(Ta, c);
    const Dual<T> f_soil = Tg.v > T(7) ? f_temp_d(Tg, c) : Dual<T>(T(0));
    const Dual<T> R_stem = c.resp10 * f_air * c.stem_const / (Cv * c.aws * c.cn_sapwood);
    const Dual<T> R_root = c.resp10 * f_soil * T(1) * c.two_over_SLA / (c.SLA * Cv * c.cn_root);
    const Dual<T> Rm = f.v[IN_RD] / T(1000) + (R_stem + R_root) * c.resp_rate_scale;
    const Dual<T> Ra = Rm + T(0.25) * (GPP - Rm);
    NPP = GPP - Ra;
}

// The surface block of closure_rhs (no snowpack) in forward mode: from x
// (SI_*) to y (SO_*); sat_top_below_1 is the closed top level's sat < 1
template <typename T, bool VEG, bool RICHARDS>
SOIL_FN void surface_block(const Dual<T> (&x)[SI_N], const bool sat_top_below_1,
                           const Forcing<T>& f, const LandColumnParams<T>& c, const T dz_top,
                           Dual<T> (&y)[SO_N])
{
    using D = Dual<T>;
    const T Ta = f.v[IN_TA], rain = f.v[IN_RAIN], p = f.v[IN_P], q = f.v[IN_Q];
    const T V = vmax(f.v[IN_WIND], c.min_windspeed);
    const T Vr = vmax(V, T(1e-6));
    const T e_air = q * p / (c.eps_mol + c.one_minus_eps_mol * q);
    const D Tg = x[SI_TG], Ts = x[SI_TS];
    const D r_a0 = resistance_d(Ta, Ts, Vr, c);

    D LAI, gw, An, NPP;
    if (VEG) vegetation_d(x[SI_C], x[SI_AN], x[SI_BETA], Tg, e_air, f, c, LAI, gw, An, NPP);

    D rain_g(rain), f_can, I_can, R_can;
    if (VEG) {
        const D LS = LAI + f.v[IN_SAI];
        const D w_max = c.w_can_max * LS;
        f_can = w_max.v > T(0) ? clamp(x[SI_W] / clamp_lo(w_max, T(1e-30)), T(0), T(1)) : D();
        I_can = c.alpha_int * rain * (T(1) - dexp(c.neg_k_ext_int * LS));
        R_can = clamp_lo(x[SI_W], T(0)) / c.tau_w;
        rain_g = (rain - I_can) + R_can;
    }
    D beta_g(c.beta_factor);
    if (c.beta_soil) {
        const D cs = T(1) - dcos(c.pi * x[SI_WTOP] / c.field_capacity);
        beta_g = x[SI_WTOP].v < c.field_capacity ? cs * cs / T(4) : D(T(1));
    }
    const D dq_s = c.eps_mol * vpd_d(Ts, e_air) / p;
    D Q_h, E_c;
    if (VEG) {
        const D dq_g = c.eps_mol * vpd_d(Tg, e_air) / p;
        const D r_e = (T(1) - dexp(-LAI - f.v[IN_SAI])) / (c.C_can * V);
        const D r_s = T(1) / clamp_lo(gw, c.eps_nf);
        const D E_t = dq_s / (r_a0 + r_s);
        const D E_g = beta_g * dq_g / (r_a0 + r_e);
        E_c = f_can * dq_s / r_a0;
        Q_h = (E_g + E_c) + E_t;
    } else {
        Q_h = beta_g * dq_s / r_a0;
    }
    D infil, pool;
    if (RICHARDS) {
        const D S = x[SI_S];
        const D drainage = S.v > T(0) ? clamp_lo(S, T(0)) / c.tau_r : D();
        const D influx = S.v > T(0) ? drainage : rain_g;
        infil = sat_top_below_1 ? minimum(influx, x[SI_KC]) : D();
        pool = c.drain_sign * (S.v == T(0) ? S * T(0) : minimum(clamp_lo(S, T(0)) / c.tau_r, S));
    }

    const D G0 = ground_flux_d(Ts, r_a0, f, Q_h, c);
    const D Ts1 = skin_d(Tg, G0, dz_top, c);
    const D G1 = ground_flux_d(Ts1, resistance_d(Ta, Ts1, Vr, c), f, Q_h, c);
    const D Ts2 = skin_d(Tg, G1, dz_top, c);
    y[SO_G] = ground_flux_d(Ts2, resistance_d(Ta, Ts2, Vr, c), f, Q_h, c);
    y[SO_QH] = Q_h;
    y[SO_INFIL] = infil;
    y[SO_POOL] = pool;
    y[SO_TS] = Ts2;
    if (VEG) {
        const D LAI_b = LAI;
        y[SO_DW] = (I_can - E_c * c.water_flux_scale) - R_can;
        const D lam = clamp((LAI_b - c.LAI_min) / c.LAI_span, T(0), T(1));
        y[SO_DC] = (T(1) - lam) * NPP - c.litter_rate * LAI_b * c.carbon_rate_scale;
        const D nu_star = clamp_lo(x[SI_NU], c.nu_seed);
        y[SO_DNU] = lam * NPP / x[SI_C] * nu_star * (T(1) - x[SI_NU]) - c.gv_rate * nu_star;
        y[SO_AN] = An;
    }
}

// gx = J^T gy for the surface block's Jacobian J at xv, one forward pass a
// used input direction; a term whose cotangent or tangent is 0 is left out
// of the contraction, as torch leaves out an edge its graph does not have
// (so that an infinite cotangent meets no 0 tangent: the pool's, whose
// tie at an empty pool grows it by |1 - dt (1 + 1 / tau_r) / 2| a step)
template <typename T, bool VEG, bool RICHARDS>
SOIL_FN void surface_adjoint(const T (&xv)[SI_N], const T (&gy)[SO_N], const bool sat_top_below_1,
                             const Forcing<T>& f, const LandColumnParams<T>& c, const T dz_top,
                             T (&gx)[SI_N])
{
#pragma unroll 1
    for (int d = 0; d < SI_N; ++d) {
        gx[d] = T(0);
        if (!VEG && (d == SI_BETA || d >= SI_W)) continue;
        if (!RICHARDS && (d == SI_KC || d == SI_S)) continue;
        Dual<T> x[SI_N], y[SO_N];
#pragma unroll
        for (int i = 0; i < SI_N; ++i) x[i] = Dual<T>(xv[i], i == d ? T(1) : T(0));
        surface_block<T, VEG, RICHARDS>(x, sat_top_below_1, f, c, dz_top, y);
        T acc = T(0);
#pragma unroll
        for (int o = 0; o < SO_N; ++o)
            if (gy[o] != T(0) && y[o].d != T(0)) acc += gy[o] * y[o].d;
        gx[d] = acc;
    }
}

// ---------------------------------------------------------------------------
// the soil's pieces that the land adds to soil_step.cuh's
// ---------------------------------------------------------------------------

// cotangent of the saturation from that of bc_head's total head (the
// water table is piecewise constant): psi_m = max(neg_psi_s se^p,
// psi_min) below saturation, se = clamp(se_raw, 1e-8, 1)
template <typename T>
SOIL_FN T bc_head_adjoint(const T sk, const T gpsi, const soil::Consts<T>& sc,
                          const LandColumnParams<T>& c) {
    const T se_raw = (sk * sc.por - c.bc_theta_res) / c.bc_span;
    const T se = vmin(vmax(se_raw, T(1e-8)), T(1));
    const T raw = c.bc_neg_psi_s * soil::fpow(se, c.num_bc, c.den_bc, c.p_bc);
    if (se >= T(1) || !(raw >= c.bc_psi_min) || !(se_raw >= T(1e-8) && se_raw <= T(1)))
        return T(0);
    return ((gpsi * c.bc_neg_psi_s) * soil::dfpow(se, c.num_bc, c.den_bc, c.p_bc) / c.bc_span)
           * sc.por;
}

// d bc_chain / d sat: through the clip of se (where 1e-6 <= se_raw <= 1)
// and the clamp of the derivative (where 0 <= d <= 1e6), 0 at and above
// saturation
template <typename T>
SOIL_FN T bc_chain_deriv(const T sk, const soil::Consts<T>& sc, const LandColumnParams<T>& c) {
    const T se_raw = (sk * sc.por - c.bc_theta_res) / c.bc_span;
    if (se_raw >= T(1) || !(se_raw >= T(1e-6) && se_raw <= T(1))) return T(0);
    const T d = (c.bc_id_coef * soil::fpow(se_raw, c.num_bc_id, c.den_bc_id, c.p_bc_id)) / c.bc_span;
    if (!(d >= T(0) && d <= T(1.0e6))) return T(0);
    const T dd = (c.bc_id_coef * soil::dfpow(se_raw, c.num_bc_id, c.den_bc_id, c.p_bc_id))
                 / c.bc_span;
    return (dd * sc.por) * (sc.por / c.bc_span);
}

// ---------------------------------------------------------------------------
// the adjoint of closure_rhs
// ---------------------------------------------------------------------------

// Cotangents through closure_rhs (no snowpack) of the column (U, sat) and
// the surface carry s, with the inputs f. On entry: gU, gs and gsc hold the
// cotangents of what the stepper reads directly of the closed column (U,
// the adjusted saturation; gsc.S the pool after the spill, gsc.w, .C, .nu
// the carried surface values; gsc.Ts and gsc.An 0 for the steppers here),
// gfU and gfs those of the tendencies (gfs[NZ-1] the top level's before its
// infiltration BC), gy those of the surface block's outputs that the
// stepper reads (all but SO_QH, which the Richards sink adds here), x those
// of the implicit terms (X::on). On return gU, gs and gsc are the
// cotangents of the step's input carry; the parameter cotangents are
// accumulated into gKsat and gskm.
template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, class X>
SOIL_FN void closure_rhs_adjoint(const T (&U)[NZ], const T (&sat)[NZ], const Surface<T>& s,
                                 const Forcing<T>& f, const soil::Consts<T>& sc,
                                 const LandColumnParams<T>& c, const T* dz, const T* dzf,
                                 const T* zc, const T* zf, const T* rf,
                                 const long long rf_stride, T (&gU)[NZ], T (&gs)[NZ],
                                 Surface<T>& gsc, const T (&gfU)[NZ], const T (&gfs)[NZ],
                                 T (&gy)[SO_N], const X& x, T& gKsat, T& gskm)
{
    const SoilColumnParams& SP = c.soil;
    constexpr bool MUALEM = RICHARDS && COND == COND_MUALEM;
    const T dz_top = dz[NZ - 1];

    // ---- recompute: sweeps with their predicates, closure, K, heads, PAW
    T ss[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) ss[k] = sat[k];
    T wt = T(0), S1 = s.S;
    unsigned spilled = 0u, clipped = 0u;
    if constexpr (RICHARDS) {
        T spill;
        soil::sweeps<T, NZ>(ss, spill, wt, spilled, clipped, dz, zf);
        S1 = s.S + spill;
    }
    T Tk[NZ], kap[NZ], water[NZ], Kc[NZ], psi[NZ];
    T beta_paw = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        const soil::Level<T, MUALEM> v(ss[k], U[k], sc, SP);
        Tk[k] = v.Tk;
        kap[k] = v.kap;
        water[k] = v.water;
        if constexpr (RICHARDS) {
            Kc[k] = MUALEM ? v.Kc : sc.K_sat * v.water / (v.water + v.ice + v.air);
            psi[k] = CURVE == CURVE_BC ? bc_head<T>(ss[k], wt, zc[k], sc, c)
                                       : soil::Head<T>(ss[k], wt, zc[k], sc, SP).psi;
        } else {
            Kc[k] = T(0);
            psi[k] = T(0);
        }
        if (VEG) {
            const T W = vmin(vmax((v.water - c.wilting_point) / c.fc_minus_wp, T(0)), T(1));
            beta_paw = beta_paw + W * rf[k * rf_stride];
        }
    }

    // ---- Richards flow: the top level's ET sink, then the interior faces
    // (the boundary faces carry no flux: zero-gradient ghosts)
    T gKf[NZ + 1], gpsi[NZ], gKc[NZ];
#pragma unroll
    for (int f_ = 0; f_ <= NZ; ++f_) gKf[f_] = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) { gpsi[k] = T(0); gKc[k] = T(0); }
    if constexpr (RICHARDS) {
        // A = (dth + sink) / por, sink = -Q_h * water_flux_scale / dz_top
        gy[SO_QH] = gy[SO_QH] - ((gfs[NZ - 1] / sc.por) * c.water_flux_scale) / dz_top;
#pragma unroll
        for (int f_ = 1; f_ < NZ; ++f_) {
            const T glo = -(gfs[f_ - 1] / sc.por) / dz[f_ - 1];
            const T ghi = -(gfs[f_] / sc.por) / dz[f_];
            const T gqw = glo - ghi;
            const T grad = (psi[f_] - psi[f_ - 1]) / dzf[f_];
            const T K_f = soil::face_K<T, NZ>(Kc, f_);
            const T K_lo = soil::face_K<T, NZ>(Kc, f_ - 1);
            const T K_hi = soil::face_K<T, NZ>(Kc, f_ + 1);
            const T K_eff = grad < T(0) ? vmin(K_lo, K_f) : vmin(K_f, K_hi);
            T gK = -gqw * grad;
            if constexpr (X::on) gK = gK + x.Keff(f_);
            const T ggrad = -gqw * K_eff;
            if (grad < T(0)) soil::min_adjoint(K_lo, K_f, gK, gKf[f_ - 1], gKf[f_]);
            else soil::min_adjoint(K_f, K_hi, gK, gKf[f_], gKf[f_ + 1]);
            gpsi[f_] += ggrad / dzf[f_];
            gpsi[f_ - 1] -= ggrad / dzf[f_];
        }
    }

    // ---- the surface block
    T gx[SI_N];
    {
        const T xv[SI_N] = {Tk[NZ - 1], water[NZ - 1], beta_paw, Kc[NZ - 1], S1,
                            s.Ts, s.w, s.C, s.nu, s.An};
        surface_adjoint<T, VEG, RICHARDS>(xv, gy, ss[NZ - 1] < T(1), f, c, dz_top, gx);
    }
    const T gS1 = gsc.S + gx[SI_S];
    gsc.Ts = gsc.Ts + gx[SI_TS];
    gsc.w = gsc.w + gx[SI_W];
    gsc.C = gsc.C + gx[SI_C];
    gsc.nu = gsc.nu + gx[SI_NU];
    gsc.An = gsc.An + gx[SI_AN];
    if constexpr (RICHARDS) {
        // face K from centre K
        gKc[NZ - 1] += gx[SI_KC];
        gKc[0] += gKf[0];
#pragma unroll
        for (int f_ = 1; f_ < NZ - 1; ++f_)
            soil::min_adjoint(Kc[f_ - 1], Kc[f_], gKf[f_], gKc[f_ - 1], gKc[f_]);
        gKc[NZ - 1] += gKf[NZ - 1] + gKf[NZ];
    }

    // ---- heat flux of the interior faces (both boundary faces carry none)
    T gT[NZ], gkap[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) { gT[k] = T(0); gkap[k] = T(0); }
    gT[NZ - 1] = gx[SI_TG];
#pragma unroll
    for (int f_ = 1; f_ < NZ; ++f_) {
        // dU/dt[k] = -((qh[k+1] - qh[k]) / dz[k])
        const T glo = -gfU[f_ - 1] / dz[f_ - 1];
        const T ghi = -gfU[f_] / dz[f_];
        const T gqh = glo - ghi;
        const T D = (Tk[f_] - Tk[f_ - 1]) / dzf[f_];
        const T kf = T(0.5) * (kap[f_] + kap[f_ - 1]);
        const T gkf = -gqh * D;
        const T gD = -gqh * kf;
        gkap[f_] += T(0.5) * gkf;
        gkap[f_ - 1] += T(0.5) * gkf;
        gT[f_] += gD / dzf[f_];
        gT[f_ - 1] -= gD / dzf[f_];
    }
    if constexpr (X::on) {
#pragma unroll
        for (int k = 0; k < NZ; ++k) gkap[k] = gkap[k] + x.kap(k);
    }

    // ---- level by level: head, linear centre K, PAW, top water, closure
    const T gbeta = gx[SI_BETA];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        T gsk = gs[k];  // what the caller reads of the closed saturation
        if constexpr (RICHARDS) {
            if constexpr (CURVE == CURVE_BC) {
                gsk += bc_head_adjoint<T>(ss[k], gpsi[k], sc, c);
            } else {
                const soil::Head<T> h(ss[k], wt, zc[k], sc, SP);
                if (!(h.se >= T(1)) && h.raw >= sc.psi_min && h.se >= sc.vg_se_lo
                    && h.se <= sc.vg_se_hi) {
                    const T gX = gpsi[k] * sc.neg_inv_alpha
                                 * soil::dfpow(h.X, SP.num_inv_n, SP.den_inv_n, sc.p_inv_n);
                    const T gss = gX * soil::dfpow(h.ss, SP.num_inv_m, SP.den_inv_m, sc.p_inv_m);
                    gsk += (gss / sc.vg_span) * sc.por;
                }
            }
        }
        const soil::Level<T, MUALEM> v(ss[k], U[k], sc, SP);
        T gwx = k == NZ - 1 ? gx[SI_WTOP] : T(0), gix = T(0), gax = T(0);
        if (RICHARDS && !MUALEM) {
            // Kc = (K_sat water) / ((water + ice) + air)
            const T den = (v.water + v.ice) + v.air;
            const T gnum = gKc[k] / den;
            gKsat += gnum * v.water;
            gwx += gnum * sc.K_sat;
            const T gden = -(gKc[k] * Kc[k]) / den;
            gwx += gden;
            gix += gden;
            gax += gden;
        }
        if (VEG) {
            const T r = (v.water - c.wilting_point) / c.fc_minus_wp;
            if (r >= T(0) && r <= T(1)) gwx += (gbeta * rf[k * rf_stride]) / c.fc_minus_wp;
        }
        T gUk = gU[k];  // what the caller reads of U
        soil::level_adjoint<T, MUALEM, X::on, true>(v, ss[k], U[k], gT[k], gkap[k],
                                                    MUALEM ? gKc[k] : T(0), x.C(k), sc, SP, gsk,
                                                    gUk, gKsat, gskm, gwx, gix, gax);
        gs[k] = gsk;
        gU[k] = gUk;
    }

    // ---- saturation adjustment: the down sweep in reverse, then the up
    // sweep (the spill's cotangent, the closed pool's, enters at the top)
    gsc.S = gS1;
    if constexpr (!RICHARDS) return;
    T g2 = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        const T gnew = gs[k];
        if (clipped & (1u << k)) {
            gs[k] = -g2 * dz[k];
        } else {
            gs[k] = gnew;
            g2 = -gnew / dz[k];
        }
    }
    T g = gS1;
#pragma unroll
    for (int k = NZ - 1; k >= 0; --k) {
        const T gup = gs[k];
        if (spilled & (1u << k)) {
            gs[k] = g * dz[k];
        } else {
            gs[k] = gup;
            g = gup / dz[k];
        }
    }
}

// the surface's direct cotangents after an update: the output cotangents
// gsc give the surface block's outputs theirs (rates times dt) and keep
// those the update passes on (pool, canopy water, carbon, fraction; the
// skin temperature and the net assimilation are written afresh)
template <typename T, bool VEG, bool RICHARDS>
SOIL_FN void surface_update_adjoint(Surface<T>& gsc, T (&gy)[SO_N], const T dt) {
    gy[SO_POOL] = RICHARDS ? gsc.S * dt : T(0);
    gy[SO_TS] = gsc.Ts;
    gy[SO_DW] = VEG ? gsc.w * dt : T(0);
    gy[SO_DC] = VEG ? gsc.C * dt : T(0);
    gy[SO_DNU] = VEG ? gsc.nu * dt : T(0);
    gy[SO_AN] = VEG ? gsc.An : T(0);
    gsc.Ts = T(0);
    gsc.An = T(0);
}

// Cotangents through one land::step (ForwardEuler, no snowpack): on entry
// (gU, gs, gsc) are those of the step's output, on return those of its
// input; without Richards flow the saturation is read and passed on, so
// that its cotangent gathers each step's. The step is recomputed from its
// input carry.
template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND>
SOIL_FN void step_adjoint(const T (&U)[NZ], const T (&sat)[NZ], const Surface<T>& s,
                          const Forcing<T>& f, const soil::Consts<T>& sc,
                          const LandColumnParams<T>& c, const T* dz, const T* dzf, const T* zc,
                          const T* zf, const T* rf, const long long rf_stride, T (&gU)[NZ],
                          T (&gs)[NZ], Surface<T>& gsc, T& gKsat, T& gskm, const T dt)
{
    const T dz_top = dz[NZ - 1];
    T gfU[NZ], gfs[NZ], gy[SO_N];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        gfU[k] = gU[k] * dt;
        gfs[k] = RICHARDS ? gs[k] * dt : T(0);
    }
    gy[SO_QH] = T(0);
    gy[SO_G] = -(gU[NZ - 1] * dt) / dz_top;                      // (dU - G / dz_top) dt
    gy[SO_INFIL] = RICHARDS ? (gs[NZ - 1] * dt) / dz_top : T(0);  // (A + infil / dz_top) dt
    surface_update_adjoint<T, VEG, RICHARDS>(gsc, gy, dt);
    closure_rhs_adjoint<T, NZ, VEG, RICHARDS, CURVE, COND>(
        U, sat, s, f, sc, c, dz, dzf, zc, zf, rf, rf_stride, gU, gs, gsc, gfU, gfs, gy,
        soil::NoTerms<T>{}, gKsat, gskm);
}

// Cotangents through one land::implicit_step (one Picard iteration, no
// snowpack), as step_adjoint. Recomputed: the closed column, its
// tendencies and ImplicitRates' terms, both systems' rows. Undone in
// reverse, the two systems by one body in a loop that is not unrolled: the
// Richards solve (sat' = sat_c + A_w^-1 r_sat: gr_sat = A_w^-T gsat', the
// rows' cotangents to the Darcy face K and to D = the curve's d(Psi)/d(sat)
// at sat_c, whose derivative joins the closed saturation's cotangent; the
// infiltration BC in the top right-hand side); the heat solve (U' = U +
// A_h^-1 r_U, the rows' cotangents to the face kappa, the arithmetic mean
// of the centre ones, and to dT/dU, which passes -1/C^2 to the heat
// capacity off the freeze plateau; -G/dz_top in the top right-hand side);
// then the Euler updates of the surface and closure_rhs_adjoint with those
// terms' cotangents.
template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, int SOLVER>
SOIL_FN void implicit_step_adjoint(const T (&U)[NZ], const T (&sat)[NZ], const Surface<T>& s,
                                   const Forcing<T>& f, const soil::Consts<T>& sc,
                                   const LandColumnParams<T>& c, const T* dz, const T* dzf,
                                   const T* zc, const T* zf, const T* rf,
                                   const long long rf_stride, T (&gU)[NZ], T (&gs)[NZ],
                                   Surface<T>& gsc, T& gKsat, T& gskm, const T dt,
                                   const T inv_dt)
{
    const T dz_top = dz[NZ - 1];
    T xs[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) xs[k] = sat[k];
    Surface<T> xsurf = s;
    ImplicitRates<T, NZ> r;
    closure_rhs<T, NZ, VEG, RICHARDS, CURVE, COND, false>(U, xs, xsurf, f, sc, c, dz, dzf, zc,
                                                          zf, rf, rf_stride, r);
    r.U[NZ - 1] = r.U[NZ - 1] - r.G / dz_top;
    if (RICHARDS) r.sat[NZ - 1] = r.sat[NZ - 1] - (T(-1) * r.infil) / dz_top;
    soil::TermCotangents<T, NZ> x;
#pragma unroll
    for (int f_ = 0; f_ <= NZ; ++f_) x.gKeff[f_] = T(0);
    T gfU[NZ], gfs[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) gfs[k] = T(0);
#pragma unroll 1
    for (int sys = RICHARDS ? 0 : 1; sys < 2; ++sys) {  // 0: Richards, 1: heat
        const bool heat = sys == 1;
        T Kf[NZ + 1], D[NZ], d[NZ], gx[NZ], gd[NZ], gKf[NZ + 1], gD[NZ];
        T a[NZ], b[NZ], cc[NZ], ga[NZ], gb[NZ], gc[NZ];
        Kf[0] = heat ? T(0.5) * (r.kap[0] + r.kap[0]) : r.Keff[0];
#pragma unroll
        for (int k = 1; k < NZ; ++k) Kf[k] = heat ? T(0.5) * (r.kap[k] + r.kap[k - 1]) : r.Keff[k];
        Kf[NZ] = heat ? T(0.5) * (r.kap[NZ - 1] + r.kap[NZ - 1]) : r.Keff[NZ];
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            D[k] = heat ? r.Dh[k]
                        : (CURVE == CURVE_BC ? bc_chain<T>(xs[k], sc, c)
                                             : soil::water_chain<T>(xs[k], sc, c.soil));
            d[k] = heat ? r.U[k] : r.sat[k];
            gx[k] = heat ? gU[k] : gs[k];
        }
        const T sc_ = heat ? T(1) : sc.inv_por;
        soil::diffusion_rows<T, NZ>(Kf, D, sc_, inv_dt, dz, dzf, false, a, b, cc);
        soil::solve_adjoint<T, NZ, SOLVER>(a, b, cc, d, gx, gd, ga, gb, gc);
        soil::diffusion_rows_adjoint<T, NZ>(Kf, D, sc_, dz, dzf, false, ga, gb, gc, gKf, gD);
        if (heat) {
#pragma unroll
            for (int k = 0; k < NZ; ++k) {
                gfU[k] = gd[k];
                x.gkap[k] = T(0.5) * (gKf[k] + gKf[k + 1]);
                x.gC[k] = -(gD[k] * r.Dh[k]) * r.Dh[k];  // Dh = 1/C, or 0 on the plateau
            }
            x.gkap[0] = x.gkap[0] + T(0.5) * gKf[0];
            x.gkap[NZ - 1] = x.gkap[NZ - 1] + T(0.5) * gKf[NZ];
        } else {
#pragma unroll
            for (int k = 0; k < NZ; ++k) {
                gfs[k] = gd[k];
                gs[k] = gs[k] + gD[k] * (CURVE == CURVE_BC
                                             ? bc_chain_deriv<T>(xs[k], sc, c)
                                             : soil::water_chain_deriv<T>(xs[k], sc, c.soil));
            }
#pragma unroll
            for (int f_ = 0; f_ <= NZ; ++f_) x.gKeff[f_] = gKf[f_];
        }
    }
    T gy[SO_N];
    gy[SO_QH] = T(0);
    gy[SO_G] = -gfU[NZ - 1] / dz_top;
    gy[SO_INFIL] = RICHARDS ? gfs[NZ - 1] / dz_top : T(0);
    surface_update_adjoint<T, VEG, RICHARDS>(gsc, gy, dt);
    closure_rhs_adjoint<T, NZ, VEG, RICHARDS, CURVE, COND>(
        U, sat, s, f, sc, c, dz, dzf, zc, zf, rf, rf_stride, gU, gs, gsc, gfU, gfs, gy, x, gKsat,
        gskm);
}

// rows of a step's carry in the scratch: U and sat (NZ each), then the
// pool, skin temperature, canopy water, carbon, vegetation fraction and net
// assimilation (0 where the composition has none)
template <int NZ>
struct ScratchRows {
    static constexpr long long value = 2 * NZ + 6;
};

// The segment VJP of one column by STEPPER (soil::STEPPER_EULER, or
// _IMPLICIT with SOLVER; no snowpack) with static inputs: `steps` forward
// steps from the segment's input carry `in`, each step's input carry
// stored to `scratch` (laid out [step][row][cell], ScratchRows rows, so
// neighbouring columns touch neighbouring addresses), then the reverse
// sweep of the step's adjoint from the output cotangents `gout` (a null
// field reads 0: under NoFlow the saturation is not an output). Writes the
// input cotangents to `gin` (the fields `in` has) and adds the parameter
// cotangents to gKsat and gskm.
template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, int STEPPER,
          int SOLVER>
SOIL_FN void segment_vjp_column(const long long col, const long long cells, const int steps,
                                const LandCarry& in, const LandCarry& gout, const LandCarry& gin,
                                T* scratch, const LandInputs& inputs, const T* root,
                                const long long root_row_stride,
                                const long long root_cell_stride, const soil::Consts<T>& sc,
                                const LandColumnParams<T>& c, const T* dz, const T* dzf,
                                const T* zc, const T* zf, const T dt, const T inv_dt, T& gKsat,
                                T& gskm)
{
    static_assert(STEPPER == soil::STEPPER_EULER || STEPPER == soil::STEPPER_IMPLICIT,
                  "the land segment VJP runs ForwardEuler and ImplicitEuler");
    constexpr long long rows = ScratchRows<NZ>::value;
    T U[NZ], sat[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        U[k] = static_cast<const T*>(in.U)[k * cells + col];
        sat[k] = static_cast<const T*>(in.sat)[k * cells + col];
    }
    Surface<T> s{};
    s.Ts = static_cast<const T*>(in.Ts)[col];
    if (RICHARDS) s.S = static_cast<const T*>(in.S)[col];
    if (VEG) {
        s.w = static_cast<const T*>(in.w)[col];
        s.C = static_cast<const T*>(in.C)[col];
        s.nu = static_cast<const T*>(in.nu)[col];
        s.An = static_cast<const T*>(in.An)[col];
    }
    const T* rf = VEG ? root + col * root_cell_stride : nullptr;
    Forcing<T> f;
#pragma unroll
    for (int i = 0; i < LAND_NIN; ++i)
        f.v[i] = static_cast<const T*>(inputs.ptr[i])[col * inputs.cell_stride[i]];

    for (int i = 0; i < steps; ++i) {
        T* rec = scratch + (long long)i * rows * cells + col;
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            rec[k * cells] = U[k];
            rec[(NZ + k) * cells] = sat[k];
        }
        rec[(2 * NZ) * cells] = s.S;
        rec[(2 * NZ + 1) * cells] = s.Ts;
        rec[(2 * NZ + 2) * cells] = s.w;
        rec[(2 * NZ + 3) * cells] = s.C;
        rec[(2 * NZ + 4) * cells] = s.nu;
        rec[(2 * NZ + 5) * cells] = s.An;
        if (STEPPER == soil::STEPPER_IMPLICIT)
            implicit_step<T, NZ, VEG, RICHARDS, CURVE, COND, false, SOLVER>(
                U, sat, s, f, sc, c, dz, dzf, zc, zf, rf, root_row_stride, dt, inv_dt);
        else
            step<T, NZ, VEG, RICHARDS, CURVE, COND, false>(U, sat, s, f, sc, c, dz, dzf, zc, zf,
                                                           rf, root_row_stride, dt);
    }

    auto read = [&](const void* p, const long long i) {
        return p ? static_cast<const T*>(p)[i] : T(0);
    };
    T gU[NZ], gs[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        gU[k] = read(gout.U, k * cells + col);
        gs[k] = read(gout.sat, k * cells + col);
    }
    Surface<T> gsc{};
    gsc.S = read(gout.S, col);
    gsc.Ts = read(gout.Ts, col);
    gsc.w = read(gout.w, col);
    gsc.C = read(gout.C, col);
    gsc.nu = read(gout.nu, col);
    gsc.An = read(gout.An, col);
    for (int i = steps - 1; i >= 0; --i) {
        const T* rec = scratch + (long long)i * rows * cells + col;
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            U[k] = rec[k * cells];
            sat[k] = rec[(NZ + k) * cells];
        }
        s.S = rec[(2 * NZ) * cells];
        s.Ts = rec[(2 * NZ + 1) * cells];
        s.w = rec[(2 * NZ + 2) * cells];
        s.C = rec[(2 * NZ + 3) * cells];
        s.nu = rec[(2 * NZ + 4) * cells];
        s.An = rec[(2 * NZ + 5) * cells];
        if (STEPPER == soil::STEPPER_IMPLICIT)
            implicit_step_adjoint<T, NZ, VEG, RICHARDS, CURVE, COND, SOLVER>(
                U, sat, s, f, sc, c, dz, dzf, zc, zf, rf, root_row_stride, gU, gs, gsc, gKsat,
                gskm, dt, inv_dt);
        else
            step_adjoint<T, NZ, VEG, RICHARDS, CURVE, COND>(U, sat, s, f, sc, c, dz, dzf, zc,
                                                            zf, rf, root_row_stride, gU, gs, gsc,
                                                            gKsat, gskm, dt);
    }
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        static_cast<T*>(gin.U)[k * cells + col] = gU[k];
        static_cast<T*>(gin.sat)[k * cells + col] = gs[k];
    }
    static_cast<T*>(gin.Ts)[col] = gsc.Ts;
    if (RICHARDS) static_cast<T*>(gin.S)[col] = gsc.S;
    if (VEG) {
        static_cast<T*>(gin.w)[col] = gsc.w;
        static_cast<T*>(gin.C)[col] = gsc.C;
        static_cast<T*>(gin.nu)[col] = gsc.nu;
        static_cast<T*>(gin.An)[col] = gsc.An;
    }
}

}  // namespace land
