// One closure-rotated LandModel step on one column (ForwardEuler), the
// column code of csrc/land_column_rollout.cu.
//
// land::step is ForwardEuler.pre_closure_step of a LandModel, in the order
// of its modules (models/land_model.py): the soil closure (saturation
// adjustment and water table under Richards flow, energy -> temperature);
// the auxiliaries (soil: centre and face conductivity; vegetation: plant-
// available water, LAI, stomatal conductance from the previous step's net
// assimilation, photosynthesis, autotrophic respiration; surface hydrology:
// interception, evapotranspiration, runoff; the SEB's fused update twice:
// fluxes at the start-of-step skin temperature, skin update, fluxes, skin
// update, fluxes); the tendencies (canopy water, Richards flow with the ET
// sink and the pool drainage, heat conduction, carbon and vegetation
// fraction); the Flux BCs (-G/dz_top on the energy, +infiltration/dz_top on
// the saturation, after the porosity division, as the reference does); the
// Euler update. The plain version is that composition of the port's process
// modules (ops/land_step.py::land_column_rollout_plain), which this code
// follows operation for operation.
//
// Template choices: VEG (PALADYN interception and evapotranspiration with
// VegetationCarbon, else NoCanopyInterception with BareGroundEvaporation),
// RICHARDS (Richards flow, else NoFlow: the saturation is read and never
// written), the retention curve (Van Genuchten or Brooks-Corey) and the
// unsaturated conductivity (Mualem-van Genuchten or linear). The remaining
// knobs are uniform across threads and are fields of LandColumnParams: the
// drag law, the ground-flux form, the ground-resistance factor, the water-
// flux scale, the drainage sign and the vegetation rate scales.
//
// Plain C++ apart from the function qualifiers (soil_step.cuh's SOIL_FN), so
// the header also compiles for the host.

#pragma once

#include "soil_step.cuh"

enum { LAND_NIN = 10 };

// Mirror of terrarium_tpu_torch.ops.land_step._CLandParams (ctypes): the
// land step's numbers in the working type T, so that the kernel reads each
// from the parameter bank where it uses it (no conversion held in a
// register), then the integer knobs.
template <typename T>
struct LandColumnParams {
    SoilColumnParams soil;          // energy closure, conductivity, Van Genuchten
    // atmosphere
    T min_windspeed, C_h, mo_z, mo_ln_m, mo_ln_h, kappa, kappa_g, kappa2, T_ref;
    T eps_mol, one_minus_eps_mol;
    // surface energy balance
    T albedo, eps_sigma, one_minus_emis, c_a_rho_a, L_rho_a, two_kappa_s, max_delta;
    // surface hydrology
    T alpha_int, neg_k_ext_int, w_can_max, tau_w, C_can, water_flux_scale, eps_nf;
    T beta_factor, field_capacity, pi, tau_r, drain_sign;
    // vegetation
    T wilting_point, fc_minus_wp, lai_den, LAI_min, LAI_span, litter_rate;
    T carbon_rate_scale, nu_seed, gv_rate, resp10, stem_const, aws, cn_sapwood;
    T two_over_SLA, SLA, cn_root, resp_rate_scale, inv_56_02, g0_coef, neg_k_ext_ph;
    T g1, tau25, Kc25, Ko25, q10_tau, q10_Kc, q10_Ko, one_minus_alpha_leaf, cq;
    T alpha_a, alpha_C3, C_mass, k1, k2, k3, T_photos_high, T_CO2_low, T_CO2_high;
    T four_theta_r, two_theta_r;
    // Brooks-Corey inverse
    T bc_theta_res, bc_span, bc_neg_psi_s, bc_psi_min, p_bc;
    int num_bc, den_bc;
    int mo_drag, mo_iterations, consistent_G, beta_soil;
};

extern "C" {
// The inputs the step reads, in the order of ops/land_step.py::LAND_INPUTS:
// input i is `rows[i]` rows of the column's value (`ptr[i]` + col *
// cell_stride[i], rows row_stride[i] apart), a uniform series at t0 + r *
// dts with rows > 1, a static value with rows == 1.
struct LandInputs {
    const void* ptr[LAND_NIN];
    long long row_stride[LAND_NIN];
    long long cell_stride[LAND_NIN];
    int rows[LAND_NIN];
    double t0[LAND_NIN];
    double dts[LAND_NIN];
};

// The carry's fields (null where the composition has none): energy and
// saturation (NZ, cells), the rest (cells,).
struct LandCarry {
    void* U;
    void* sat;
    void* S;
    void* Ts;
    void* w;
    void* C;
    void* nu;
    void* An;
};
}

namespace land {

using soil::vmax;
using soil::vmin;

enum { CURVE_VG = 0, CURVE_BC = 1 };
enum { COND_MUALEM = 0, COND_LINEAR = 1 };
enum { IN_TA = 0, IN_SW, IN_LW, IN_RAIN, IN_WIND, IN_P, IN_Q, IN_CO2, IN_SAI, IN_RD };

SOIL_FN float d_exp(float x) { return expf(x); }
SOIL_FN double d_exp(double x) { return exp(x); }
SOIL_FN float d_cos(float x) { return cosf(x); }
SOIL_FN double d_cos(double x) { return cos(x); }
SOIL_FN float d_atan(float x) { return atanf(x); }
SOIL_FN double d_atan(double x) { return atan(x); }

// the step's inputs at one clock time
template <typename T>
struct Forcing {
    T v[LAND_NIN];
};

// the surface carry of one column
template <typename T>
struct Surface {
    T S, Ts, w, C, nu, An;
};

// constants.py::saturation_vapor_pressure, the clip to [-150, 150] first
template <typename T>
SOIL_FN T e_sat(T Tc) {
    Tc = vmin(vmax(Tc, T(-150)), T(150));
    return Tc <= T(0) ? T(611) * d_exp((T(22.46) * Tc) / (Tc + T(272.62)))
                      : T(611) * d_exp((T(17.62) * Tc) / (Tc + T(243.12)));
}

// constants.py::compute_vpd over a surface at Tc, e_air the air's vapour pressure
template <typename T>
SOIL_FN T vpd(T Tc, T e_air) { return vmax(e_sat(Tc) - e_air, T(0.1)); }

// atmosphere.py::MoninObukhovAerodynamics._psi: (psi_m, psi_h)
template <typename T>
SOIL_FN void mo_psi(const T zeta, T& pm, T& ph, const LandColumnParams<T>& c) {
    if (zeta < T(0)) {
        const T zu = vmin(zeta, T(0));
        const T x = soil::d_pow(T(1) - T(16) * zu, T(0.25));
        const T x2 = x * x;
        const T l2 = soil::d_log((T(1) + x2) / T(2));
        pm = ((T(2) * soil::d_log((T(1) + x) / T(2)) + l2) - T(2) * d_atan(x)) + c.pi / T(2);
        ph = T(2) * l2;
    } else {
        pm = ph = T(-5) * vmin(vmax(vmax(zeta, T(0)), T(0)), T(1));
    }
}

// the drag coefficient at skin temperature Ts (atmosphere.py:
// ConstantAerodynamics, or MoninObukhovAerodynamics.drag_coefficient with
// its fixed iterations); Vr is the windspeed clipped below at 1e-6
template <typename T>
SOIL_FN T drag(const T Ta, const T Ts, const T Vr, const LandColumnParams<T>& c) {
    if (!c.mo_drag) return c.C_h;
    const T Tbar = T(0.5) * (Ta + Ts) + c.T_ref;
    const T dtheta = Ta - Ts;
    T inv_L = T(0), pm, ph;
    for (int it = 0; it < c.mo_iterations; ++it) {
        mo_psi(vmin(vmax(c.mo_z * inv_L, T(-10)), T(1)), pm, ph, c);
        const T u_star = c.kappa * Vr / vmax(c.mo_ln_m - pm, T(0.1));
        const T th_star = c.kappa * dtheta / vmax(c.mo_ln_h - ph, T(0.1));
        inv_L = c.kappa_g * th_star / vmax(u_star * u_star * Tbar, T(1e-12));
    }
    mo_psi(vmin(vmax(c.mo_z * inv_L, T(-10)), T(1)), pm, ph, c);
    return c.kappa2 / (vmax(c.mo_ln_m - pm, T(0.1)) * vmax(c.mo_ln_h - ph, T(0.1)));
}

// atmosphere.py::PrescribedAtmosphere.aerodynamic_resistance at skin
// temperature Ts
template <typename T>
SOIL_FN T resistance(const T Ta, const T Ts, const T Vr, const LandColumnParams<T>& c) {
    return T(1) / (drag(Ta, Ts, Vr, c) * Vr);
}

// the ground heat flux of one SEB flux sweep at skin temperature Ts, r_a
// the aerodynamic resistance there (seb.py::SurfaceEnergyBalance._fluxes),
// the humidity flux Q_h fixed
template <typename T>
SOIL_FN T ground_flux(const T Ts, const T r_a, const Forcing<T>& f, const T Q_h,
                      const LandColumnParams<T>& c) {
    const T SW = f.v[IN_SW], LW = f.v[IN_LW], Ta = f.v[IN_TA];
    const T SW_up = c.albedo * SW;
    const T Tk = Ts + c.T_ref;
    const T LW_up = c.eps_sigma * ((Tk * Tk) * (Tk * Tk)) + c.one_minus_emis * LW;
    const T R_net = SW_up - SW + LW_up - LW;
    const T H_s = c.c_a_rho_a * ((Ts - Ta) / r_a);
    const T H_l = c.L_rho_a * Q_h;
    return c.consistent_G ? R_net + H_s + H_l : R_net - H_s - H_l;
}

// seb.py::ImplicitSkinTemperature.compute_skin_temperature
template <typename T>
SOIL_FN T skin(const T Tg, const T G, const T dz_top, const LandColumnParams<T>& c) {
    return Tg + vmin(vmax(-G * dz_top / c.two_kappa_s, -c.max_delta), c.max_delta);
}

// f_temp of the autotrophic respiration
template <typename T>
SOIL_FN T f_temp(const T Tc, const LandColumnParams<T>& c) {
    return d_exp(T(308.56) * (c.inv_56_02 - T(1) / (T(46.02) + Tc)));
}

// What the vegetation hands to the surface hydrology and the tendencies.
template <typename T>
struct Vegetation {
    T LAI_b, LAI, gw, An, NPP;
};

// VegetationCarbon.compute_auxiliary after the PAW (vegetation.py): LAI_b
// and LAI, stomatal conductance from the previous net assimilation An0,
// photosynthesis, autotrophic respiration.
template <typename T>
SOIL_FN Vegetation<T> vegetation(const T Cv, const T An0, const T beta, const T Tg,
                                 const T e_air, const Forcing<T>& f, const LandColumnParams<T>& c) {
    Vegetation<T> v;
    const T Ta = f.v[IN_TA], SW = f.v[IN_SW], p = f.v[IN_P], co2 = f.v[IN_CO2];
    v.LAI_b = Cv / c.lai_den;
    v.LAI = v.LAI_b;  // (f_dec * phen + (1 - f_dec)) * LAI_b with f_dec = 0, phen = 1
    // Medlyn (at the air temperature)
    const T vpd_a = vpd(Ta, e_air);
    const T one_m_exp = T(1) - d_exp(c.neg_k_ext_ph * v.LAI);
    const T g0 = c.g0_coef * one_m_exp * beta;
    v.gw = g0 + T(1.6) * (T(1) + c.g1 / soil::d_sqrt(vpd_a)) * An0 / co2 * T(1.0e6);
    const T lam_c = T(1) - T(1) / (T(1) + c.g1 / soil::d_sqrt(vpd_a * T(1.0e-3)));
    // photosynthesis
    T An = T(0);
    if (SW > T(0) && Ta > T(-3) && v.LAI > T(0)) {
        const T pO2 = T(0.209) * p;
        const T pa = co2 * T(1.0e-6) * p;
        const T x = (Ta - T(25)) * T(0.1);
        const T tau = c.tau25 * soil::d_pow(c.q10_tau, x);
        const T Kc = c.Kc25 * soil::d_pow(c.q10_Kc, x);
        const T Ko = c.Ko25 * soil::d_pow(c.q10_Ko, x);
        const T g_star = pO2 / (T(2) * tau);
        const T PAR = T(0.5) * SW * c.one_minus_alpha_leaf * c.cq;
        const T APAR = c.alpha_a * PAR * one_m_exp;
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
        const T Rd = c.alpha_C3 * Vc * beta;
        const T JE = c1 * APAR, JC = c2 * Vc;
        const T s = JE + JC;
        const T disc = vmax(s * s - c.four_theta_r * JE * JC, T(0));
        An = (s - soil::d_sqrt(disc)) / c.two_theta_r * beta - Rd;
    }
    v.An = An;
    // autotrophic respiration (phen = 1)
    const T GPP = An * T(1.0e-3);
    const T f_air = f_temp(Ta, c);
    const T f_soil = Tg > T(7) ? f_temp(Tg, c) : T(0);
    const T R_stem = c.resp10 * f_air * c.stem_const / (Cv * c.aws * c.cn_sapwood);
    const T R_root = c.resp10 * f_soil * T(1) * c.two_over_SLA / (c.SLA * Cv * c.cn_root);
    const T Rm = f.v[IN_RD] / T(1000) + (R_stem + R_root) * c.resp_rate_scale;
    const T Ra = Rm + T(0.25) * (GPP - Rm);
    v.NPP = GPP - Ra;
    return v;
}

// the total head of one level under the Brooks-Corey curve
// (swrc.py::BrooksCorey.inverse plus psi_h and psi_z)
template <typename T>
SOIL_FN T bc_head(const T sk, const T wt, const T zck, const soil::Consts<T>& sc,
                  const LandColumnParams<T>& c) {
    const T se = vmin(vmax((sk * sc.por - c.bc_theta_res) / c.bc_span, T(1e-8)), T(1));
    const T psi = vmax(c.bc_neg_psi_s * soil::fpow(se, c.num_bc, c.den_bc, c.p_bc),
                       c.bc_psi_min);
    const T psi_m = se >= T(1) ? T(0) : psi;
    return vmax(wt - zck, T(0)) + psi_m + (zck - sc.z_top);
}

// One ForwardEuler.pre_closure_step of the LandModel column in place: the
// soil (U, sat; sat read only without RICHARDS), the surface carry `s`,
// the inputs `f` of this step; `rf` the column's root fractions, level k at
// rf[k * rf_stride] (VEG only). Energy and water updates stream level by
// level as their tendencies are formed, the top level's after the surface
// has given its fluxes.
template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND>
SOIL_FN void step(T (&U)[NZ], T (&sat)[NZ], Surface<T>& s, const Forcing<T>& f,
                  const soil::Consts<T>& sc, const LandColumnParams<T>& c,
                  const T* dz, const T* dzf, const T* zc, const T* zf, const T* rf,
                  const long long rf_stride, const T dt)
{
    const SoilColumnParams& SP = c.soil;
    static_assert(!(CURVE == CURVE_BC && COND == COND_MUALEM),
                  "the Mualem conductivity reads the Van Genuchten curve");
    constexpr bool MUALEM = RICHARDS && COND == COND_MUALEM;
    T Kc[NZ];

    // ---- closure: saturation adjustment and water table
    T wt = T(0);
    if (RICHARDS) {
        T spill;
        unsigned spilled, clipped;
        soil::sweeps<T, NZ>(sat, spill, wt, spilled, clipped, dz, zf);
        s.S = s.S + spill;
    }

    // ---- energy closure, centre K, plant-available water; the heat flux
    // and the energy update of every level below the top
    T T_prev = T(0), kap_prev = T(0), qh_prev = T(0), water_top = T(0), beta_paw = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        const soil::Level<T, MUALEM> v(sat[k], U[k], sc, SP);
        if (RICHARDS) Kc[k] = MUALEM ? v.Kc : sc.K_sat * v.water / (v.water + v.ice + v.air);
        if (VEG) {
            const T W = vmin(vmax((v.water - c.wilting_point) / c.fc_minus_wp, T(0)), T(1));
            beta_paw = beta_paw + W * rf[k * rf_stride];
        }
        const T kf = T(0.5) * (v.kap + (k == 0 ? v.kap : kap_prev));
        const T qh = -kf * ((v.Tk - (k == 0 ? v.Tk : T_prev)) / dzf[k]);
        if (k > 0) U[k - 1] = U[k - 1] + (-((qh - qh_prev) / dz[k - 1])) * dt;
        qh_prev = qh;
        T_prev = v.Tk;
        kap_prev = v.kap;
        if (k == NZ - 1) water_top = v.water;
    }
    const T Tg = T_prev;  // ground_temperature
    const T dz_top = dz[NZ - 1];

    // ---- atmosphere
    const T Ta = f.v[IN_TA], rain = f.v[IN_RAIN], p = f.v[IN_P], q = f.v[IN_Q];
    const T V = vmax(f.v[IN_WIND], c.min_windspeed);
    const T Vr = vmax(V, T(1e-6));
    const T e_air = q * p / (c.eps_mol + c.one_minus_eps_mol * q);
    const T r_a0 = resistance(Ta, s.Ts, Vr, c);

    // ---- vegetation
    Vegetation<T> veg{};
    if (VEG) veg = vegetation<T>(s.C, s.An, beta_paw, Tg, e_air, f, c);

    // ---- surface hydrology: interception, evapotranspiration, runoff
    T rain_g = rain, f_can = T(0), I_can = T(0), R_can = T(0);
    if (VEG) {
        const T LS = veg.LAI + f.v[IN_SAI];
        const T w_max = c.w_can_max * LS;
        f_can = w_max > T(0) ? vmin(vmax(s.w / vmax(w_max, T(1e-30)), T(0)), T(1)) : T(0);
        I_can = c.alpha_int * rain * (T(1) - d_exp(c.neg_k_ext_int * LS));
        R_can = vmax(s.w, T(0)) / c.tau_w;
        rain_g = rain - I_can + R_can;
    }
    T beta_g = c.beta_factor;
    if (c.beta_soil) {
        const T cs = T(1) - d_cos(c.pi * water_top / c.field_capacity);
        beta_g = water_top < c.field_capacity ? cs * cs / T(4) : T(1);
    }
    const T dq_s = c.eps_mol * vpd(s.Ts, e_air) / p;
    T Q_h, E_c = T(0);
    if (VEG) {
        const T dq_g = c.eps_mol * vpd(Tg, e_air) / p;
        const T r_e = (T(1) - d_exp(-veg.LAI - f.v[IN_SAI])) / (c.C_can * V);
        const T r_s = T(1) / vmax(veg.gw, c.eps_nf);
        const T E_t = dq_s / (r_a0 + r_s);
        const T E_g = beta_g * dq_g / (r_a0 + r_e);
        E_c = f_can * dq_s / r_a0;
        Q_h = E_g + E_c + E_t;
    } else {
        Q_h = beta_g * dq_s / r_a0;
    }
    T infil = T(0);
    if (RICHARDS) {
        const T drainage = s.S > T(0) ? vmax(s.S, T(0)) / c.tau_r : T(0);
        const T influx = s.S > T(0) ? drainage : rain_g;
        infil = sat[NZ - 1] < T(1) ? vmin(influx, Kc[NZ - 1]) : T(0);
    }

    // ---- SEB: the fused update twice (fluxes, skin, fluxes), the first
    // sweep at the start-of-step resistance r_a0
    const T G0 = ground_flux(s.Ts, r_a0, f, Q_h, c);
    const T Ts1 = skin(Tg, G0, dz_top, c);
    const T G1 = ground_flux(Ts1, resistance(Ta, Ts1, Vr, c), f, Q_h, c);
    const T Ts2 = skin(Tg, G1, dz_top, c);
    const T G = ground_flux(Ts2, resistance(Ta, Ts2, Vr, c), f, Q_h, c);

    // ---- top level's energy: zero-gradient face above it, then -G/dz
    {
        const T kf = T(0.5) * (kap_prev + kap_prev);
        const T qh = -kf * ((T_prev - T_prev) / dzf[NZ]);
        const T dU = -((qh - qh_prev) / dz_top);
        U[NZ - 1] = U[NZ - 1] + (dU - G / dz_top) * dt;
    }

    // ---- Richards flow with the ET sink and the infiltration, and the pool
    if (RICHARDS) {
        const T sink = -Q_h * c.water_flux_scale / dz_top;
        T psi_prev = T(0), qw_prev = T(0);
#pragma unroll
        for (int k = 0; k <= NZ; ++k) {
            T psi_k = psi_prev;
            if (k < NZ)
                psi_k = CURVE == CURVE_BC ? bc_head<T>(sat[k], wt, zc[k], sc, c)
                                          : soil::Head<T>(sat[k], wt, zc[k], sc, SP).psi;
            const T lower = k == 0 ? psi_k : psi_prev;
            const T grad = (psi_k - lower) / dzf[k];
            const T K_lo = k == 0 ? T(INFINITY) : soil::face_K<T, NZ>(Kc, k - 1);
            const T K_hi = k == NZ ? T(INFINITY) : soil::face_K<T, NZ>(Kc, k + 1);
            const T K_k = soil::face_K<T, NZ>(Kc, k);
            const T K_eff = grad < T(0) ? vmin(K_lo, K_k) : vmin(K_k, K_hi);
            const T qw = -K_eff * grad;
            if (k > 0 && k < NZ) {
                sat[k - 1] = sat[k - 1] + ((-((qw - qw_prev) / dz[k - 1])) / sc.por) * dt;
            } else if (k == NZ) {
                const T dth = -((qw - qw_prev) / dz_top);
                const T tend = (dth + sink) / sc.por - (T(-1) * infil) / dz_top;
                sat[NZ - 1] = sat[NZ - 1] + tend * dt;
            }
            qw_prev = qw;
            psi_prev = psi_k;
        }
        const T pool = c.drain_sign * vmin(vmax(s.S, T(0)) / c.tau_r, s.S);
        s.S = s.S + pool * dt;
    }

    // ---- the surface prognostics
    s.Ts = Ts2 + T(0) * dt;
    if (VEG) {
        const T dw = I_can - E_c * c.water_flux_scale - R_can;
        const T lam = vmin(vmax((veg.LAI_b - c.LAI_min) / c.LAI_span, T(0)), T(1));
        const T dC = (T(1) - lam) * veg.NPP - c.litter_rate * veg.LAI_b * c.carbon_rate_scale;
        const T nu_star = vmax(s.nu, c.nu_seed);
        const T dnu = lam * veg.NPP / s.C * nu_star * (T(1) - s.nu) - c.gv_rate * nu_star;
        s.w = s.w + dw * dt;
        s.C = s.C + dC * dt;
        s.nu = s.nu + dnu * dt;
        s.An = veg.An;
    }
}

// `steps` land steps of column `col` of the carry `in` into `out`, from the
// clock time time0, which advances by t + dt as Clock.tick does: the carry
// read once, each series input read at each clock time (soil::series_value),
// each static input once; the root fractions of level k at root[k *
// root_row_stride + col * root_cell_stride].
template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND>
SOIL_FN void rollout_column(const long long col, const long long cells, const LandCarry& in,
                            const LandCarry& out, const LandInputs& inputs, const T* root,
                            const long long root_row_stride, const long long root_cell_stride,
                            const soil::Consts<T>& sc, const LandColumnParams<T>& c,
                            const T* dz, const T* dzf, const T* zc,
                            const T* zf, const int steps, const T time0, const T dt)
{
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
    T t = time0;
    for (int n = 0; n < steps; ++n) {
#pragma unroll
        for (int i = 0; i < LAND_NIN; ++i)
            if (inputs.rows[i] > 1)
                f.v[i] = soil::series_value(
                    static_cast<const T*>(inputs.ptr[i]) + col * inputs.cell_stride[i],
                    inputs.row_stride[i], inputs.rows[i], T(inputs.t0[i]), T(inputs.dts[i]), t);
        step<T, NZ, VEG, RICHARDS, CURVE, COND>(U, sat, s, f, sc, c, dz, dzf, zc, zf, rf,
                                                root_row_stride, dt);
        t = t + dt;
    }

#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        static_cast<T*>(out.U)[k * cells + col] = U[k];
        if (RICHARDS) static_cast<T*>(out.sat)[k * cells + col] = sat[k];
    }
    static_cast<T*>(out.Ts)[col] = s.Ts;
    if (RICHARDS) static_cast<T*>(out.S)[col] = s.S;
    if (VEG) {
        static_cast<T*>(out.w)[col] = s.w;
        static_cast<T*>(out.C)[col] = s.C;
        static_cast<T*>(out.nu)[col] = s.nu;
        static_cast<T*>(out.An)[col] = s.An;
    }
}

}  // namespace land
