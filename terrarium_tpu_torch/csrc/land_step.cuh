// One closure-rotated LandModel step on one column, the column code of
// csrc/land_column_rollout.cu: ForwardEuler, Heun or ImplicitEuler (Thomas
// or PCR solves; one Picard iteration, or any number by picard_step).
//
// land::closure_rhs is the closure and the tendencies of a LandModel, in the
// order of its modules (models/land_model.py): the soil closure (saturation
// adjustment and water table under Richards flow, energy -> temperature);
// the auxiliaries (atmosphere; snowpack: cover fraction and melt; soil:
// centre and face conductivity; vegetation: plant-available water, LAI,
// stomatal conductance from the previous net assimilation, photosynthesis,
// autotrophic respiration; surface hydrology: interception,
// evapotranspiration, runoff of the ground rain and the melt; the SEB's
// fused update twice: fluxes at the start-of-step skin temperature, skin
// update, fluxes, skin update, fluxes, with the albedo and emissivity
// blended by the snow cover); the tendencies (canopy water, Richards flow
// with the ET sink and the pool drainage, heat conduction, carbon and
// vegetation fraction, snowfall - melt). Each tendency goes to a sink as
// soon as it is formed, as soil::closure_rhs does: the top level's with its
// Flux BC apart (-G/dz_top on the energy, +infiltration/dz_top on the
// saturation after the porosity division, as the reference does), so that
// Heun's corrector can add the x_n BC to the mean of two stages'
// tendencies. land::step is ForwardEuler.pre_closure_step on it (the
// update streamed level by level), land::heun_step Heun.pre_closure_step,
// land::implicit_step ImplicitEuler.pre_closure_step and
// land::picard_step the same with its Picard iterations; each ends with
// the snowpack's clip SWE >= 0 (LandModel.timestep). The plain version is
// that composition of the port's process modules stepped by the same
// stepper (ops/land_step.py::land_column_rollout_plain), which this code
// follows operation for operation.
//
// Template choices: VEG (PALADYN interception and evapotranspiration with
// VegetationCarbon, else NoCanopyInterception with BareGroundEvaporation),
// RICHARDS (Richards flow, else NoFlow: the saturation is read and never
// written), the retention curve (Van Genuchten or Brooks-Corey), the
// unsaturated conductivity (Mualem-van Genuchten or linear) and SNOW (a
// Snowpack with SnowCoverAlbedo over ConstantAlbedo). The remaining knobs
// are uniform across threads and are fields of LandColumnParams: the drag
// law, the ground-flux form, the ground-resistance factor, the water-flux
// scale, the drainage sign, the vegetation rate scales and the snowpack's
// constants.
//
// Plain C++ apart from the function qualifiers (soil_step.cuh's SOIL_FN), so
// the header also compiles for the host.

#pragma once

#include "soil_step.cuh"

enum { LAND_NIN = 11 };

// The auxiliaries the land full step writes besides the net assimilation
// (the carry's An), in the order of ops/land_step.py::LAND_FULL_AUX
// (land_full_step.cuh; closure_rhs writes x_n's through its writer)
enum {
    AUX_T, AUX_LIQ, AUX_PSI, AUX_TG, AUX_KFACE, AUX_WT, AUX_PAW, AUX_BETA, AUX_RD, AUX_GPP,
    AUX_GW, AUX_LAMC, AUX_RA, AUX_NPP, AUX_PHEN, AUX_LAI, AUX_LAIB, AUX_SNOWF, AUX_MELT,
    AUX_ICAN, AUX_RCAN, AUX_FCAN, AUX_RAING, AUX_EC, AUX_EG, AUX_ET, AUX_RUNOFF, AUX_INFIL,
    AUX_G, AUX_SWUP, AUX_LWUP, AUX_RNET, AUX_HS, AUX_HL, LAND_NAUX
};

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
    // Brooks-Corey inverse, and its derivative (the implicit rows): psi_s /
    // lam and the exponent -1/lam - 1
    T bc_theta_res, bc_span, bc_neg_psi_s, bc_psi_min, p_bc, bc_id_coef, p_bc_id;
    // snowpack: degree-day factor, melt threshold, SWE at half cover; the
    // snow-cover albedo's snow albedo and emissivity, its base's emissivity,
    // and sigma
    T ddf, T_melt, swe_half, albedo_snow, emissivity_snow, emissivity_base, sigma;
    int num_bc, den_bc, num_bc_id, den_bc_id;
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
    void* swe;
};
}

namespace land {

using soil::vmax;
using soil::vmin;

enum { CURVE_VG = 0, CURVE_BC = 1 };
enum { COND_MUALEM = 0, COND_LINEAR = 1 };
enum { IN_TA = 0, IN_SW, IN_LW, IN_RAIN, IN_WIND, IN_P, IN_Q, IN_CO2, IN_SAI, IN_RD, IN_SNOW };

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
    T S, Ts, w, C, nu, An, swe;
};

// the surface's albedo, emissivity * sigma and 1 - emissivity under snow
// (SnowCoverAlbedo over ConstantAlbedo)
template <typename T>
struct Radiation {
    T albedo, eps_sigma, one_minus_emis;
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

// One SEB flux sweep at skin temperature Ts, r_a the aerodynamic resistance
// there (seb.py::SurfaceEnergyBalance._fluxes), the humidity flux Q_h
// fixed, under the albedo and emissivity given (the parameters', or
// SnowCoverAlbedo's blend under snow): every flux the SEB writes, and the
// ground heat flux G
template <typename T>
struct Fluxes {
    T SW_up, LW_up, R_net, H_s, H_l, G;
    SOIL_FN Fluxes(const T Ts, const T r_a, const Forcing<T>& f, const T Q_h, const T albedo,
                   const T eps_sigma, const T one_minus_emis, const LandColumnParams<T>& c) {
        const T SW = f.v[IN_SW], LW = f.v[IN_LW], Ta = f.v[IN_TA];
        SW_up = albedo * SW;
        const T Tk = Ts + c.T_ref;
        LW_up = eps_sigma * ((Tk * Tk) * (Tk * Tk)) + one_minus_emis * LW;
        R_net = SW_up - SW + LW_up - LW;
        H_s = c.c_a_rho_a * ((Ts - Ta) / r_a);
        H_l = c.L_rho_a * Q_h;
        G = c.consistent_G ? R_net + H_s + H_l : R_net - H_s - H_l;
    }
};

// the ground heat flux of one sweep without snow
template <typename T>
SOIL_FN T ground_flux(const T Ts, const T r_a, const Forcing<T>& f, const T Q_h,
                      const LandColumnParams<T>& c) {
    return Fluxes<T>(Ts, r_a, f, Q_h, c.albedo, c.eps_sigma, c.one_minus_emis, c).G;
}

// the same under snow, with the albedo and emissivity blended by the cover
template <typename T>
SOIL_FN T ground_flux_snow(const T Ts, const T r_a, const Forcing<T>& f, const T Q_h,
                           const Radiation<T>& rad, const LandColumnParams<T>& c) {
    return Fluxes<T>(Ts, r_a, f, Q_h, rad.albedo, rad.eps_sigma, rad.one_minus_emis, c).G;
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

// What the vegetation hands to the surface hydrology and the tendencies,
// and the auxiliaries the full step writes besides (the leaf respiration,
// the leaf-to-air CO2 ratio, GPP and the autotrophic respiration).
template <typename T>
struct Vegetation {
    T LAI_b, LAI, gw, An, NPP, Rd, lam_c, GPP, Ra;
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
    v.lam_c = lam_c;
    // photosynthesis
    T An = T(0);
    v.Rd = T(0);
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
        v.Rd = Rd;
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
    v.GPP = GPP;
    v.Ra = Ra;
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

// d(Psi)/d(sat) under the Brooks-Corey curve, the Richards rows' chain
// factor: BrooksCorey.inverse_deriv(sat * por, por) * por (swrc.py): se
// clipped to [1e-6, 1], (psi_s / lam) se^(-1/lam - 1) / (por - theta_res)
// clamped to [0, 1e6], 0 at and above saturation
template <typename T>
SOIL_FN T bc_chain(const T sk, const soil::Consts<T>& sc, const LandColumnParams<T>& c) {
    const T se_raw = (sk * sc.por - c.bc_theta_res) / c.bc_span;
    const T se = vmin(vmax(se_raw, T(1e-6)), T(1));
    const T d = (c.bc_id_coef * soil::fpow(se, c.num_bc_id, c.den_bc_id, c.p_bc_id)) / c.bc_span;
    return (se_raw >= T(1) ? T(0) : vmin(vmax(d, T(0)), T(1.0e6))) * sc.por;
}

// the surface's tendencies of one step, and what the SEB writes of it: the
// skin temperature after the second skin update and the net assimilation
template <typename T>
struct SurfaceRates {
    T Ts, dw, dC, dnu, An, dswe;
};

// What closure_rhs writes besides the tendencies: nothing (the rollouts,
// which start each step with a closure). land::FullWriter
// (land_full_step.cuh) is the full step's, whose step starts from the
// stored closure instead and writes every auxiliary of x_n.
template <typename T>
struct NoWrite {
    static constexpr bool stored = false;
    SOIL_FN void aux(int, T) const {}
    SOIL_FN void aux(int, int, T) const {}
    SOIL_FN void fluxes(const Fluxes<T>&) const {}
};

// The closure and tendencies of one closure-rotated step of the LandModel
// column: the soil (U, sat; sat read only without RICHARDS), the surface
// carry `s`, the inputs `f` of this step; `rf` the column's root fractions,
// level k at rf[k * rf_stride] (VEG only). The closure works in place (sat,
// and s.S += spill); U and the rest of `s` are read only. Each tendency
// goes to `out` as soon as it is formed: out.energy(k, dU/dt) and
// out.water(k, dsat/dt) below the top level; out.energy_top(dU/dt, G,
// dz_top) and out.water_top(dsat/dt, infiltration, dz_top), the top level's
// without its Flux BC; out.pool(dS/dt); out.surface(SurfaceRates). The
// implicit stepper's sink also takes each level's closure, out.level(k,
// U[k], Level), and each face's Darcy conductivity, out.darcy_face(f,
// K_eff); the explicit sinks ignore both.
//
// A writer `w` with Wr::stored (the full step's update_state, which does not
// start with a closure) replaces the closure by the stored start: the
// saturation as it is, the temperature, liquid fraction, pressure head and
// ground temperature as w reads them from the state, the conductivities
// (Mualem-van Genuchten or linear, COND, whether or not RICHARDS), the
// plant-available water and the ground evaporation's factor from the stored
// liquid fraction, and out.level's terms from soil::Stored. Each auxiliary
// then goes to `w` as it is formed (w.aux, w.fluxes: the SEB's last sweep),
// the infiltration and runoff also without Richards flow.
template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, bool SNOW, class Out,
          class Wr = NoWrite<T>>
SOIL_FN void closure_rhs(const T (&U)[NZ], T (&sat)[NZ], Surface<T>& s, const Forcing<T>& f,
                         const soil::Consts<T>& sc, const LandColumnParams<T>& c,
                         const T* dz, const T* dzf, const T* zc, const T* zf, const T* rf,
                         const long long rf_stride, Out& out, const Wr& w = Wr{})
{
    const SoilColumnParams& SP = c.soil;
    static_assert(!(CURVE == CURVE_BC && COND == COND_MUALEM),
                  "the Mualem conductivity reads the Van Genuchten curve");
    constexpr bool MUALEM = RICHARDS && COND == COND_MUALEM;
    T Kc[NZ];

    // ---- closure: saturation adjustment and water table
    T wt = T(0);
    if (RICHARDS && !Wr::stored) {
        T spill;
        unsigned spilled, clipped;
        soil::sweeps<T, NZ>(sat, spill, wt, spilled, clipped, dz, zf);
        s.S = s.S + spill;
    }

    // ---- energy closure (or the stored one), centre K, plant-available
    // water; the heat flux and the energy tendency of every level below the
    // top
    T T_prev = T(0), kap_prev = T(0), qh_prev = T(0), water_top = T(0), beta_paw = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        T kap, Tk, water;
        if constexpr (Wr::stored) {
            const T liq = w.liq(k);
            const soil::Stored<T, COND != COND_MUALEM, true> v(sat[k], liq, sc, SP);
            out.level(k, U[k], v);
            Kc[k] = v.Kc;
            kap = v.kap;
            Tk = w.temperature(k);
            water = (sat[k] * sc.por) * liq;
        } else {
            const soil::Level<T, MUALEM> v(sat[k], U[k], sc, SP);
            out.level(k, U[k], v);
            if (RICHARDS) Kc[k] = MUALEM ? v.Kc : sc.K_sat * v.water / (v.water + v.ice + v.air);
            kap = v.kap;
            Tk = v.Tk;
            water = v.water;
        }
        if (VEG) {
            const T W = vmin(vmax((water - c.wilting_point) / c.fc_minus_wp, T(0)), T(1));
            w.aux(AUX_PAW, k, W);
            beta_paw = beta_paw + W * rf[k * rf_stride];
        }
        const T kf = T(0.5) * (kap + (k == 0 ? kap : kap_prev));
        const T qh = -kf * ((Tk - (k == 0 ? Tk : T_prev)) / dzf[k]);
        if (k > 0) out.energy(k - 1, -((qh - qh_prev) / dz[k - 1]));
        qh_prev = qh;
        T_prev = Tk;
        kap_prev = kap;
        if (k == NZ - 1) water_top = water;
    }
    T Tg = T_prev;  // ground_temperature
    if constexpr (Wr::stored) {
#pragma unroll
        for (int fc = 0; fc <= NZ; ++fc) w.aux(AUX_KFACE, fc, soil::face_K<T, NZ>(Kc, fc));
        Tg = w.ground_temperature();
    }
    if (VEG) w.aux(AUX_BETA, beta_paw);
    const T dz_top = dz[NZ - 1];

    // ---- atmosphere
    const T Ta = f.v[IN_TA], rain = f.v[IN_RAIN], p = f.v[IN_P], q = f.v[IN_Q];
    const T V = vmax(f.v[IN_WIND], c.min_windspeed);
    const T Vr = vmax(V, T(1e-6));
    const T e_air = q * p / (c.eps_mol + c.one_minus_eps_mol * q);
    const T r_a0 = resistance(Ta, s.Ts, Vr, c);

    // ---- snowpack: cover fraction and melt from the carried SWE
    T snow_f = T(0), melt = T(0);
    if (SNOW) {
        const T swe = vmax(s.swe, T(0));
        snow_f = swe / (swe + c.swe_half);
        melt = swe > T(0) ? c.ddf * vmax(Ta - c.T_melt, T(0)) : T(0);
        w.aux(AUX_SNOWF, snow_f);
        w.aux(AUX_MELT, melt);
    }

    // ---- vegetation
    Vegetation<T> veg{};
    if (VEG) {
        veg = vegetation<T>(s.C, s.An, beta_paw, Tg, e_air, f, c);
        w.aux(AUX_LAIB, veg.LAI_b);
        w.aux(AUX_PHEN, T(1));
        w.aux(AUX_LAI, veg.LAI);
        w.aux(AUX_GW, veg.gw);
        w.aux(AUX_LAMC, veg.lam_c);
        w.aux(AUX_RD, veg.Rd);
        w.aux(AUX_GPP, veg.GPP);
        w.aux(AUX_RA, veg.Ra);
        w.aux(AUX_NPP, veg.NPP);
    }

    // ---- surface hydrology: interception, evapotranspiration, runoff
    T rain_g = rain, f_can = T(0), I_can = T(0), R_can = T(0);
    if (VEG) {
        const T LS = veg.LAI + f.v[IN_SAI];
        const T w_max = c.w_can_max * LS;
        f_can = w_max > T(0) ? vmin(vmax(s.w / vmax(w_max, T(1e-30)), T(0)), T(1)) : T(0);
        I_can = c.alpha_int * rain * (T(1) - d_exp(c.neg_k_ext_int * LS));
        R_can = vmax(s.w, T(0)) / c.tau_w;
        rain_g = rain - I_can + R_can;
        w.aux(AUX_ICAN, I_can);
        w.aux(AUX_RCAN, R_can);
        w.aux(AUX_FCAN, f_can);
    }
    w.aux(AUX_RAING, rain_g);
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
        w.aux(AUX_ET, E_t);
        w.aux(AUX_EG, E_g);
        w.aux(AUX_EC, E_c);
    } else {
        Q_h = beta_g * dq_s / r_a0;
        w.aux(AUX_EG, Q_h);
    }
    T infil = T(0);
    if (RICHARDS || Wr::stored) {
        const T rain_in = SNOW ? rain_g + melt : rain_g;
        const T drainage = s.S > T(0) ? vmax(s.S, T(0)) / c.tau_r : T(0);
        const T influx = s.S > T(0) ? drainage : rain_in;
        infil = sat[NZ - 1] < T(1) ? vmin(influx, Kc[NZ - 1]) : T(0);
        w.aux(AUX_INFIL, infil);
        w.aux(AUX_RUNOFF, rain_in + drainage - infil);
    }

    // ---- SEB: the fused update twice (fluxes, skin, fluxes), the first
    // sweep at the start-of-step resistance r_a0; under snow the albedo and
    // emissivity blended by the cover. Without snow the sweeps read the
    // constants from the parameters as the ForwardEuler kernel always has:
    // holding them in one struct across the drags lets the compiler contract
    // the last sweep's longwave multiply-adds the other way at float32
    T G, Ts2;
    if constexpr (SNOW) {
        Radiation<T> rad;
        rad.albedo = snow_f * c.albedo_snow + (T(1) - snow_f) * c.albedo;
        const T eps = snow_f * c.emissivity_snow + (T(1) - snow_f) * c.emissivity_base;
        rad.eps_sigma = eps * c.sigma;
        rad.one_minus_emis = T(1) - eps;
        const T G0 = ground_flux_snow(s.Ts, r_a0, f, Q_h, rad, c);
        const T Ts1 = skin(Tg, G0, dz_top, c);
        const T G1 = ground_flux_snow(Ts1, resistance(Ta, Ts1, Vr, c), f, Q_h, rad, c);
        Ts2 = skin(Tg, G1, dz_top, c);
        const Fluxes<T> fl(Ts2, resistance(Ta, Ts2, Vr, c), f, Q_h, rad.albedo, rad.eps_sigma,
                           rad.one_minus_emis, c);
        w.fluxes(fl);
        G = fl.G;
    } else {
        const T G0 = ground_flux(s.Ts, r_a0, f, Q_h, c);
        const T Ts1 = skin(Tg, G0, dz_top, c);
        const T G1 = ground_flux(Ts1, resistance(Ta, Ts1, Vr, c), f, Q_h, c);
        Ts2 = skin(Tg, G1, dz_top, c);
        const Fluxes<T> fl(Ts2, resistance(Ta, Ts2, Vr, c), f, Q_h, c.albedo, c.eps_sigma,
                           c.one_minus_emis, c);
        w.fluxes(fl);
        G = fl.G;
    }

    // ---- top level's energy: zero-gradient face above it; its Flux BC
    // -G/dz is the sink's
    {
        const T kf = T(0.5) * (kap_prev + kap_prev);
        const T qh = -kf * ((T_prev - T_prev) / dzf[NZ]);
        out.energy_top(-((qh - qh_prev) / dz_top), G, dz_top);
    }

    // ---- Richards flow with the ET sink, and the pool; the infiltration
    // BC is the sink's
    if (RICHARDS) {
        const T sink = -Q_h * c.water_flux_scale / dz_top;
        T psi_prev = T(0), qw_prev = T(0);
#pragma unroll
        for (int k = 0; k <= NZ; ++k) {
            T psi_k = psi_prev;
            if constexpr (Wr::stored) {
                if (k < NZ) psi_k = w.pressure_head(k);
            } else if (k < NZ) {
                psi_k = CURVE == CURVE_BC ? bc_head<T>(sat[k], wt, zc[k], sc, c)
                                          : soil::Head<T>(sat[k], wt, zc[k], sc, SP).psi;
            }
            const T lower = k == 0 ? psi_k : psi_prev;
            const T grad = (psi_k - lower) / dzf[k];
            const T K_lo = k == 0 ? T(INFINITY) : soil::face_K<T, NZ>(Kc, k - 1);
            const T K_hi = k == NZ ? T(INFINITY) : soil::face_K<T, NZ>(Kc, k + 1);
            const T K_k = soil::face_K<T, NZ>(Kc, k);
            const T K_eff = grad < T(0) ? vmin(K_lo, K_k) : vmin(K_k, K_hi);
            const T qw = -K_eff * grad;
            out.darcy_face(k, K_eff);
            if (k > 0 && k < NZ) {
                out.water(k - 1, (-((qw - qw_prev) / dz[k - 1])) / sc.por);
            } else if (k == NZ) {
                const T dth = -((qw - qw_prev) / dz_top);
                out.water_top((dth + sink) / sc.por, infil, dz_top);
            }
            qw_prev = qw;
            psi_prev = psi_k;
        }
        out.pool(c.drain_sign * vmin(vmax(s.S, T(0)) / c.tau_r, s.S));
    }

    // ---- the surface: skin, canopy water, carbon, vegetation fraction, SWE
    SurfaceRates<T> r{};
    r.Ts = Ts2;
    if (VEG) {
        r.dw = I_can - E_c * c.water_flux_scale - R_can;
        const T lam = vmin(vmax((veg.LAI_b - c.LAI_min) / c.LAI_span, T(0)), T(1));
        r.dC = (T(1) - lam) * veg.NPP - c.litter_rate * veg.LAI_b * c.carbon_rate_scale;
        const T nu_star = vmax(s.nu, c.nu_seed);
        r.dnu = lam * veg.NPP / s.C * nu_star * (T(1) - s.nu) - c.gv_rate * nu_star;
        r.An = veg.An;
    }
    if (SNOW) r.dswe = f.v[IN_SNOW] - melt;
    out.surface(r);
}

// what an explicit sink ignores of closure_rhs
template <typename T>
struct ExplicitSink {
    template <class L>
    SOIL_FN void level(int, T, const L&) {}
    SOIL_FN void darcy_face(int, T) {}
};

// ForwardEuler's update x + f * dt, level by level as closure_rhs forms f,
// then the snowpack's clip
template <typename T, int NZ, bool VEG, bool SNOW>
struct EulerUpdate : ExplicitSink<T> {
    T (&U)[NZ];
    T (&sat)[NZ];
    Surface<T>& s;
    const T dt;
    SOIL_FN EulerUpdate(T (&U_)[NZ], T (&sat_)[NZ], Surface<T>& s_, const T dt_)
        : U(U_), sat(sat_), s(s_), dt(dt_) {}
    SOIL_FN void energy(int k, T f) { U[k] = U[k] + f * dt; }
    SOIL_FN void energy_top(T dU, T G, T dz_top) {
        U[NZ - 1] = U[NZ - 1] + (dU - G / dz_top) * dt;
    }
    SOIL_FN void water(int k, T f) { sat[k] = sat[k] + f * dt; }
    SOIL_FN void water_top(T A, T infil, T dz_top) {
        sat[NZ - 1] = sat[NZ - 1] + (A - (T(-1) * infil) / dz_top) * dt;
    }
    SOIL_FN void pool(T p) { s.S = s.S + p * dt; }
    SOIL_FN void surface(const SurfaceRates<T>& r) {
        s.Ts = r.Ts + T(0) * dt;
        if (VEG) {
            s.w = s.w + r.dw * dt;
            s.C = s.C + r.dC * dt;
            s.nu = s.nu + r.dnu * dt;
            s.An = r.An;
        }
        if (SNOW) s.swe = vmax(s.swe + r.dswe * dt, T(0));
    }
};

// the tendencies of a step, kept: Heun's first stage, the implicit step's
// right-hand sides
template <typename T, int NZ>
struct Rates : ExplicitSink<T> {
    T U[NZ], sat[NZ], G, infil, dS;
    SurfaceRates<T> surf;
    SOIL_FN void energy(int k, T f) { U[k] = f; }
    SOIL_FN void energy_top(T dU, T G_, T) { U[NZ - 1] = dU; G = G_; }
    SOIL_FN void water(int k, T f) { sat[k] = f; }
    SOIL_FN void water_top(T A, T infil_, T) { sat[NZ - 1] = A; infil = infil_; }
    SOIL_FN void pool(T p) { dS = p; }
    SOIL_FN void surface(const SurfaceRates<T>& r) { surf = r; }
};

// ... and what the implicit rows need of the closed column: the centre
// thermal conductivity, dT/dU (0 on the freeze plateau -L_theta <= U < 0,
// else 1/C) and the Darcy face conductivity
template <typename T, int NZ>
struct ImplicitRates : Rates<T, NZ> {
    T kap[NZ], Dh[NZ], Keff[NZ + 1];
    template <class L>
    SOIL_FN void level(int k, T Uk, const L& v) {
        kap[k] = v.kap;
        Dh[k] = (Uk >= v.negL && Uk < T(0)) ? T(0) : T(1) / v.C;
    }
    SOIL_FN void darcy_face(int f, T K) { Keff[f] = K; }
};

// Heun's corrector x + (0.5 * (f_n + f*)) * dt, level by level as
// closure_rhs forms f* at the stage, the top levels' Flux BCs those of x_n
// (explicit_step adds them to the mean of the two stages' tendencies from
// the state it updates); the skin temperature and the net assimilation
// x_n's as its SEB and vegetation wrote them; then the snowpack's clip
template <typename T, int NZ, bool VEG, bool SNOW>
struct HeunUpdate : ExplicitSink<T> {
    T (&U)[NZ];
    T (&sat)[NZ];
    Surface<T>& s;
    const Rates<T, NZ>& r;
    const T dt;
    SOIL_FN HeunUpdate(T (&U_)[NZ], T (&sat_)[NZ], Surface<T>& s_, const Rates<T, NZ>& r_,
                       const T dt_)
        : U(U_), sat(sat_), s(s_), r(r_), dt(dt_) {}
    SOIL_FN void energy(int k, T g) { U[k] = U[k] + (T(0.5) * (r.U[k] + g)) * dt; }
    SOIL_FN void energy_top(T dU, T, T dz_top) {
        U[NZ - 1] = U[NZ - 1] + (T(0.5) * (r.U[NZ - 1] + dU) - r.G / dz_top) * dt;
    }
    SOIL_FN void water(int k, T g) { sat[k] = sat[k] + (T(0.5) * (r.sat[k] + g)) * dt; }
    SOIL_FN void water_top(T A, T, T dz_top) {
        sat[NZ - 1] = sat[NZ - 1]
                      + (T(0.5) * (r.sat[NZ - 1] + A) - (T(-1) * r.infil) / dz_top) * dt;
    }
    SOIL_FN void pool(T p) { s.S = s.S + (T(0.5) * (r.dS + p)) * dt; }
    SOIL_FN void surface(const SurfaceRates<T>& q) {
        s.Ts = r.surf.Ts + (T(0.5) * (T(0) + T(0))) * dt;
        if (VEG) {
            s.w = s.w + (T(0.5) * (r.surf.dw + q.dw)) * dt;
            s.C = s.C + (T(0.5) * (r.surf.dC + q.dC)) * dt;
            s.nu = s.nu + (T(0.5) * (r.surf.dnu + q.dnu)) * dt;
            s.An = r.surf.An;
        }
        if (SNOW) s.swe = vmax(s.swe + (T(0.5) * (r.surf.dswe + q.dswe)) * dt, T(0));
    }
};

// One ForwardEuler.pre_closure_step of the LandModel column in place: the
// update streams level by level as the tendencies are formed, the top
// level's after the surface has given its fluxes.
template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, bool SNOW>
SOIL_FN void step(T (&U)[NZ], T (&sat)[NZ], Surface<T>& s, const Forcing<T>& f,
                  const soil::Consts<T>& sc, const LandColumnParams<T>& c,
                  const T* dz, const T* dzf, const T* zc, const T* zf, const T* rf,
                  const long long rf_stride, const T dt)
{
    EulerUpdate<T, NZ, VEG, SNOW> out{U, sat, s, dt};
    closure_rhs<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW>(U, sat, s, f, sc, c, dz, dzf, zc, zf,
                                                        rf, rf_stride, out);
}

// One Heun.pre_closure_step of the LandModel column in place
// (stepping.py:167-188): closure(x_n) and f_n with the inputs f0 at t_n;
// the stage y = x_n + f_n * dt with the Flux BCs (the Euler update), the
// snowpack's clip; closure(y) and f* with the inputs f1 at t_n + dt; the
// corrector (HeunUpdate). The stage's skin temperature is x_n's SEB value
// and its previous net assimilation x_n's new one: the stage is a copy of
// the state after update_state. Live across the stage: x_n, f_n, y and Kc,
// about 7 * NZ values.
template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, bool SNOW>
SOIL_FN void heun_step(T (&U)[NZ], T (&sat)[NZ], Surface<T>& s, const Forcing<T>& f0,
                       const Forcing<T>& f1, const soil::Consts<T>& sc,
                       const LandColumnParams<T>& c, const T* dz, const T* dzf, const T* zc,
                       const T* zf, const T* rf, const long long rf_stride, const T dt)
{
    Rates<T, NZ> r;
    closure_rhs<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW>(U, sat, s, f0, sc, c, dz, dzf, zc, zf,
                                                        rf, rf_stride, r);
    const T dz_top = dz[NZ - 1];
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
    HeunUpdate<T, NZ, VEG, SNOW> out{U, sat, s, r, dt};
    closure_rhs<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW>(yU, ys, y, f1, sc, c, dz, dzf, zc, zf,
                                                        rf, rf_stride, out);
}

// The implicit solves of the land column's rates `r` (their top rows with
// the Flux BCs in), soil::implicit_solves: no Dirichlet row (the land's top
// BCs are Flux BCs and its bottom none); under RICHARDS the Richards rows
// with the curve's d(Psi)/d(sat) at sat. SOLVER may be
// soil::SOLVER_RUNTIME, the solves then by `solver`.
template <typename T, int NZ, bool RICHARDS, int CURVE, int SOLVER>
SOIL_FN void implicit_solves(ImplicitRates<T, NZ>& r, T (&U)[NZ], T (&sat)[NZ],
                             const soil::Consts<T>& sc, const LandColumnParams<T>& c,
                             const T* dz, const T* dzf, const T inv_dt, const int solver = SOLVER)
{
    soil::implicit_solves<T, NZ, RICHARDS, false, SOLVER>(
        r, U, sat, sc.inv_por,
        [&](int k) {
            return CURVE == CURVE_BC ? bc_chain<T>(sat[k], sc, c)
                                     : soil::water_chain<T>(sat[k], sc, c.soil);
        },
        dz, dzf, inv_dt, solver);
}

// One ImplicitEuler.pre_closure_step of the LandModel column in place, one
// Picard iteration (implicit.py:183-264): closure_rhs into the implicit
// sink (the closure in place, the tendencies, the terms); the Flux BCs
// into the top rows' right-hand sides (-G/dz on the energy, +infiltration/dz
// on the saturation), as the explicit path adds them; the heat rows (face
// kappa by the arithmetic mean with zero-gradient ends, dT/dU, scale 1) and
// their solve, U += du; under Richards flow the Richards rows (the Darcy
// face K, d(Psi)/d(sat) of the curve at the closed saturation, scale
// 1/por) and their solve, sat += du, the ET sink and the infiltration
// explicit in the right-hand side. The land's top BCs are Flux BCs and its
// bottom none, so no row takes a Dirichlet term. Every other prognostic by
// Euler: the pool, the skin (its SEB value), the canopy water, carbon,
// vegetation fraction and SWE; then the snowpack's clip.
template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, bool SNOW,
          int SOLVER>
SOIL_FN void implicit_step(T (&U)[NZ], T (&sat)[NZ], Surface<T>& s, const Forcing<T>& f,
                           const soil::Consts<T>& sc, const LandColumnParams<T>& c,
                           const T* dz, const T* dzf, const T* zc, const T* zf, const T* rf,
                           const long long rf_stride, const T dt, const T inv_dt)
{
    ImplicitRates<T, NZ> r;
    closure_rhs<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW>(U, sat, s, f, sc, c, dz, dzf, zc, zf,
                                                        rf, rf_stride, r);
    const T dz_top = dz[NZ - 1];
    r.U[NZ - 1] = r.U[NZ - 1] - r.G / dz_top;
    if (RICHARDS) r.sat[NZ - 1] = r.sat[NZ - 1] - (T(-1) * r.infil) / dz_top;
    implicit_solves<T, NZ, RICHARDS, CURVE, SOLVER>(r, U, sat, sc, c, dz, dzf, inv_dt);
    if (RICHARDS) s.S = s.S + r.dS * dt;
    s.Ts = r.surf.Ts + T(0) * dt;
    if (VEG) {
        s.w = s.w + r.surf.dw * dt;
        s.C = s.C + r.surf.dC * dt;
        s.nu = s.nu + r.surf.dnu * dt;
        s.An = r.surf.An;
    }
    if (SNOW) s.swe = vmax(s.swe + r.surf.dswe * dt, T(0));
}

// One ImplicitEuler.pre_closure_step of the LandModel column in place with
// `iters` Picard iterations (implicit.py:234-254). Iteration 0 is
// implicit_step's arithmetic, with the SWE left unclipped. Each further
// iteration runs closure_rhs at the iterate u_k on a copy of the surface
// carry as iteration 0 left it (the pool, skin temperature, canopy water,
// carbon, vegetation fraction, net assimilation and SWE after their
// updates: the explicit variables keep iteration 0's values, and the
// copy's pool takes the saturation adjustment's spill, which is dropped),
// with the inputs at the step's clock time; the Flux BCs of the iterate
// into the top rows' right-hand sides; then solves A(u_k) du = tend(u_k) -
// (u_k - u^n) / dt for U and sat, u_k the closed iterate and u^n the step's
// closed start, with the rows at the iterate (face kappa, dT/dU, the Darcy
// face K and the curve's d(Psi)/d(sat) at the closed iterate), and sets u =
// u_k + du. The snowpack's clip runs once, at the end. The loop is not
// unrolled: one body serves every iteration, and u^n stays live across it.
// SOLVER may be soil::SOLVER_RUNTIME, the solves then by `solver`.
template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, bool SNOW,
          int SOLVER>
SOIL_FN void picard_step(T (&U)[NZ], T (&sat)[NZ], Surface<T>& s, const Forcing<T>& f,
                         const soil::Consts<T>& sc, const LandColumnParams<T>& c,
                         const T* dz, const T* dzf, const T* zc, const T* zf, const T* rf,
                         const long long rf_stride, const T dt, const T inv_dt, const int iters,
                         const int solver = SOLVER)
{
    const T dz_top = dz[NZ - 1];
    T Un[NZ], sn[NZ];
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
        ImplicitRates<T, NZ> r;
        Surface<T> y = s;
        closure_rhs<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW>(U, sat, y, f, sc, c, dz, dzf, zc,
                                                            zf, rf, rf_stride, r);
        r.U[NZ - 1] = r.U[NZ - 1] - r.G / dz_top;
        if (RICHARDS) r.sat[NZ - 1] = r.sat[NZ - 1] - (T(-1) * r.infil) / dz_top;
        if (it == 0) {
            s.S = y.S;
#pragma unroll
            for (int k = 0; k < NZ; ++k) { Un[k] = U[k]; sn[k] = sat[k]; }
        } else {
#pragma unroll
            for (int k = 0; k < NZ; ++k) {
                r.U[k] = r.U[k] - (U[k] - Un[k]) / dt;
                if (RICHARDS) r.sat[k] = r.sat[k] - (sat[k] - sn[k]) / dt;
            }
        }
        implicit_solves<T, NZ, RICHARDS, CURVE, SOLVER>(r, U, sat, sc, c, dz, dzf, inv_dt,
                                                        solver);
        if (it == 0) {
            if (RICHARDS) s.S = s.S + r.dS * dt;
            s.Ts = r.surf.Ts + T(0) * dt;
            if (VEG) {
                s.w = s.w + r.surf.dw * dt;
                s.C = s.C + r.surf.dC * dt;
                s.nu = s.nu + r.surf.dnu * dt;
                s.An = r.surf.An;
            }
            if (SNOW) s.swe = s.swe + r.surf.dswe * dt;
        }
    }
    if (SNOW) s.swe = vmax(s.swe, T(0));
}

// the series inputs at clock time t (soil::series_value) into f, whose
// static inputs are already set
template <typename T>
SOIL_FN void read_series(Forcing<T>& f, const LandInputs& inputs, const long long col, const T t)
{
#pragma unroll
    for (int i = 0; i < LAND_NIN; ++i)
        if (inputs.rows[i] > 1)
            f.v[i] = soil::series_value(
                static_cast<const T*>(inputs.ptr[i]) + col * inputs.cell_stride[i],
                inputs.row_stride[i], inputs.rows[i], T(inputs.t0[i]), T(inputs.dts[i]), t);
}

// `steps` land steps of STEPPER (soil::STEPPER_EULER, _HEUN or _IMPLICIT
// with SOLVER; PICARD: picard_step with `iters` iterations, SOLVER_RUNTIME
// taking `solver`) of column `col` of the carry `in` into `out`, from the
// clock time time0, which advances by t + dt as Clock.tick does: the carry
// read once, each series input read at each clock time (Heun's stage at t +
// dt too), each static input once; the root fractions of level k at root[k
// * root_row_stride + col * root_cell_stride].
template <typename T, int NZ, bool VEG, bool RICHARDS, int CURVE, int COND, bool SNOW,
          int STEPPER, int SOLVER, bool PICARD = false>
SOIL_FN void rollout_column(const long long col, const long long cells, const LandCarry& in,
                            const LandCarry& out, const LandInputs& inputs, const T* root,
                            const long long root_row_stride, const long long root_cell_stride,
                            const soil::Consts<T>& sc, const LandColumnParams<T>& c,
                            const T* dz, const T* dzf, const T* zc,
                            const T* zf, const int steps, const T time0, const T dt,
                            const T inv_dt, const int iters = 1, const int solver = SOLVER)
{
    static_assert(!PICARD || STEPPER == soil::STEPPER_IMPLICIT,
                  "the Picard iterations are ImplicitEuler's");
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
    if (SNOW) s.swe = static_cast<const T*>(in.swe)[col];
    const T* rf = VEG ? root + col * root_cell_stride : nullptr;

    Forcing<T> f;
#pragma unroll
    for (int i = 0; i < LAND_NIN; ++i)
        f.v[i] = static_cast<const T*>(inputs.ptr[i])[col * inputs.cell_stride[i]];
    T t = time0;
    for (int n = 0; n < steps; ++n) {
        read_series(f, inputs, col, t);
        if (STEPPER == soil::STEPPER_HEUN) {
            Forcing<T> f1 = f;
            read_series(f1, inputs, col, t + dt);
            heun_step<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW>(
                U, sat, s, f, f1, sc, c, dz, dzf, zc, zf, rf, root_row_stride, dt);
        } else if (STEPPER == soil::STEPPER_IMPLICIT && PICARD) {
            picard_step<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW, SOLVER>(
                U, sat, s, f, sc, c, dz, dzf, zc, zf, rf, root_row_stride, dt, inv_dt, iters,
                solver);
        } else if (STEPPER == soil::STEPPER_IMPLICIT) {
            implicit_step<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW, SOLVER>(
                U, sat, s, f, sc, c, dz, dzf, zc, zf, rf, root_row_stride, dt, inv_dt);
        } else {
            step<T, NZ, VEG, RICHARDS, CURVE, COND, SNOW>(U, sat, s, f, sc, c, dz, dzf, zc, zf,
                                                          rf, root_row_stride, dt);
        }
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
    if (SNOW) static_cast<T*>(out.swe)[col] = s.swe;
}

}  // namespace land
