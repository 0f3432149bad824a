// One ImplicitEuler step (any number of Picard iterations, either solver)
// and one Heun step of a LandModel column spread over a group of G lanes
// (Richards flow, with or without vegetation, either retention curve and
// conductivity, with or without a snowpack), their rollout, and the segment
// VJP of each on
// the same group: the column code of csrc/land_column_group_rollout.cu and
// csrc/land_column_group_segment_vjp.cu, which run the same picard_step or
// heun_step, so that every carry the VJP stores equals the rollout's bit
// for bit at the same G, and the VJP differentiates the trajectory that the
// rollout returned.
//
// land_step.cuh and land_adjoint.cuh run a column on one thread, its NZ
// levels unrolled in registers. Here the soil levels are spread as
// soil::GroupColumn spreads them (soil_group_step.cuh: L = ceil(NZ / G)
// consecutive levels a lane, bottom first), and land::GroupColumn builds on
// that column: its sweeps with their ballots and SweepBits, its rows, PCR
// rounds and Thomas hand-offs, its implicit solves, its solve and rows
// adjoints, its face-share gathers of the Darcy flux, face K and heat flux
// in reverse, its reverse sweeps and group_sum. What the land adds: the
// Brooks-Corey head (bc_head) or the Van Genuchten one, the linear centre
// K or Mualem's, the plant-available water, the Flux BCs of the top level
// (the ground heat flux on the energy, the ET sink and the infiltration on
// the saturation; no Dirichlet row), the pool term, and the surface block:
//
// * the surface block is one value a column: every lane computes it from
//   the top level's ground temperature, water, centre K and saturation
//   (read from the top level's lane, TOP, by a shuffle each), the
//   plant-available water's beta and the surface carry, which every lane
//   holds; the top level's lane applies its Flux BCs;
// * beta = sum of W k rf k is summed in level order, as the one-thread
//   step sums it: handed from lane to lane, bottom first (level_sum), so
//   that each value is formed by the one-thread step's operations in its
//   order and a host build of this step equals land::implicit_step (one
//   iteration) and land::picard_step bit for bit
//   (tests/test_torch_land_group_vjp_host.py);
// * the adjoint's surface block, whose Jacobian the one-thread adjoint forms
//   in forward mode one input direction a pass, ten passes one after
//   another (land::surface_adjoint; eleven under a snowpack), takes the
//   directions in rounds across the group's lanes: lane j the used
//   directions j, j + G, ..., so the passes take ceil(10 / G) rounds (5
//   directions without vegetation; one more, the SWE, under a snowpack),
//   each lane carrying one pass's Dual state at a time; each direction's
//   cotangent is then read from its lane by one shuffle. Each pass is the
//   one-thread pass's arithmetic (land::surface_block), so the contraction
//   is bitwise the one-thread adjoint's;
// * the snowpack (SNOW, as LAND_SNOW is for the one-thread code) is one
//   more value of the surface carry, the SWE, which every lane holds: its
//   cover of the clamped SWE blends the albedo and emissivity of the SEB
//   sweeps, its degree-day melt joins the ground rain, its rate is snowfall
//   - melt, and each step clips it at 0 where land::implicit_step,
//   picard_step and heun_step do. Every snowpack term is compiled under `if
//   constexpr (SNOW)`, so that the instantiations without one keep their
//   code.
//
// Iteration 0 of picard_step is land::implicit_step's arithmetic (the
// surface copy it closes is written back, which implicit_step does in
// place), so one body serves one iteration and more. heun_step is
// land::heun_step's: its rates keep the top level's Flux BCs apart from the
// tendencies (rhs<false>), as the one-thread corrector forms
// U + (0.5 (f_n + f*) - G_n / dz) dt, and its adjoint recomputes the stage
// by heun_stage, the forward's own code.
//
// The group's exchange is soil::WarpLanes on the card and soil::HostLanes
// (the G lanes of a group held by one host thread in lockstep) in the host
// build; per-lane values are arrays [N][L], N = 1 on the card and G on the
// host; the surface carry, the inputs and the scalars of the surface block
// are one copy a thread, the same on every lane of the group.

#pragma once

#include "land_adjoint.cuh"
#include "soil_group_step.cuh"

namespace land {

// The group size of the land ImplicitEuler segment VJP at nz levels with
// its solver (soil::SOLVER_THOMAS or SOLVER_PCR), measured at Nz 20 f32 on
// an H100 80GB HBM3 at 700 W (rollout_layout_ab.py land_vjp_time, PERF.md
// section 6; a 48-step segment at 56,951 columns, one and two Picard
// iterations, 2 blocks of 256 threads an SM): PCR G 4 (L 5) 51.30 and
// 116.77 ms, G 8 54.57 and 124.04, G 16 69.91 and 157.99, G 32 91.61 and
// 208.42; Thomas G 8 (L 3) 45.32 and 100.67 ms, G 4 47.91 and 108.21, G 16
// 60.22 and 136.02, G 32 95.46 and 216.58. The surface block, one value a
// column, runs on every lane of a group, so few lanes a column win; Thomas'
// hand-offs, one lane of a group at a time, favour 8 over 4. With a
// snowpack (PCR, rollout_layout_ab.py land_snow_time, each G at its best
// of 1 to 4 blocks): G 2 77.31 ms, G 4 53.40, G 8 57.66, the same G. Other
// depths take the same sizes (not measured).
#if defined(__CUDACC__)
__host__ __device__
#endif
constexpr int implicit_group_lanes(int /* nz */, int solver) {
    return solver == soil::SOLVER_THOMAS ? 8 : 4;
}

// The group size of the land ImplicitEuler rollout at nz levels with its
// solver, measured at Nz 20 f32 on an H100 80GB HBM3 at 700 W
// (rollout_layout_ab.py land_time, PERF.md section 6; 48 steps at 56,951
// columns, one and two Picard iterations, 2 blocks of 256 threads an SM):
// PCR G 2 (L 10) 8.63 and 17.83 ms, G 4 8.95 and 17.35, G 8 11.82 and
// 23.44, G 16 17.16 and 33.78, G 32 23.31 and 45.22; Thomas G 2 6.95 and
// 14.61, G 4 6.69 and 13.04, G 8 8.64 and 17.08, G 16 13.54 and 26.52, G 32
// 23.68 and 45.83. Every lane of a group runs the surface block, so the
// fewest lanes that do not spill win; Thomas' hand-offs cost the rollout
// less than the VJP's tangent passes gain from 8 lanes, so the two differ
// there (the land gradient's forward segments run the rollout at the
// VJP's G, implicit_group_lanes, so that the VJP's stored carries are
// theirs). With a snowpack (PCR, land_snow_time, each G at its best launch
// bound): G 2 8.72 ms, G 4 8.18, G 8 10.55, and at the gradient's static
// inputs G 2 8.11, G 4 7.86, G 8 10.39: the same G. Other depths take the
// same sizes (not measured).
#if defined(__CUDACC__)
__host__ __device__
#endif
constexpr int rollout_group_lanes(int /* nz */, int /* solver */) { return 4; }

// The group size of the land Heun segment VJP at nz levels, measured at Nz
// 20 f32 on an H100 80GB HBM3 at 700 W (rollout_layout_ab.py
// land_heun_time, PERF.md section 6; a 48-step segment of 60 s at 56,951
// columns, each G at its best of 1 to 4 blocks of 256 threads an SM): G 2
// (L 10) 67.49 ms, G 4 54.66, G 8 62.33, G 16 67.35, G 32 104.84; with the
// forward segment at the same G, G 4 60.47 ms a segment, the least. Other
// depths take the same size (not measured).
#if defined(__CUDACC__)
__host__ __device__
#endif
constexpr int heun_group_lanes(int /* nz */) { return 4; }

// The group size of the land Heun rollout at nz levels, measured as
// heun_group_lanes (48 steps of 600 s, two hourly series, each G at its
// best launch bound): G 2 7.02 ms, G 4 6.86, G 8 9.41, G 16 14.51, G 32
// 23.41; the VJP's G, so that the gradient's forward segments need no
// other build. Other depths take the same size (not measured).
#if defined(__CUDACC__)
__host__ __device__
#endif
constexpr int heun_rollout_group_lanes(int /* nz */) { return 4; }

// A LandModel column on a group: soil::GroupColumn's levels and exchange,
// the land's parameters and root fractions, the closure, the ImplicitEuler
// and Heun steps and their adjoints (Richards flow; a snowpack where SNOW)
template <typename T, int NZ, int G, class Lanes, bool VEG, int CURVE, int COND,
          bool SNOW = false>
struct GroupColumn : soil::GroupColumn<T, NZ, G, Lanes> {
    using Base = soil::GroupColumn<T, NZ, G, Lanes>;
    using typename Base::SweepBits;
    using typename Base::NoTermCotangents;
    using typename Base::TermCotangents;
    using Base::at;
    using Base::c;
    using Base::dz;
    using Base::dzf;
    using Base::dzf_top;
    using Base::lanes;
    using Base::level;
    using Base::P;
    using Base::zc;
    static constexpr int L = Base::L, N = Base::N, TOP = Base::TOP;
    static constexpr int LT = NZ - 1 - TOP * L;  // the top level's slot on lane TOP
    static constexpr bool MUALEM = COND == COND_MUALEM;
    static_assert(!(CURVE == CURVE_BC && MUALEM), "the Mualem conductivity reads the Van "
                                                  "Genuchten curve");
    const LandColumnParams<T>& lc;
    const T dz_top;
    T rf[N][L];  // the root fraction of each lane's levels (VEG; 0 above NZ)

    SOIL_FN GroupColumn(const Lanes& lanes_, const soil::Consts<T>& c_,
                        const LandColumnParams<T>& lc_, const T* dz_g, const T* dzf_g,
                        const T* zc_g, const T* zf_g, const T* rf_g, const long long rf_stride)
        : Base(lanes_, c_, lc_.soil, dz_g, dzf_g, zc_g, zf_g), lc(lc_), dz_top(dz_g[NZ - 1])
    {
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                rf[i][l] = VEG && k < NZ ? rf_g[k * rf_stride] : T(0);
            }
        }
    }

    // v of the top level, from its lane, on every lane
    SOIL_FN T top_of(const T (&v)[N][L]) const {
        return lanes.from(TOP, [&](int i) { return v[i][LT]; });
    }

    // the sum of v over the levels from 0 in level order, on every lane:
    // lane j adds its levels' to what lane j - 1 handed it, lanes 0 ... TOP
    // in turn
    SOIL_FN T level_sum(const T (&v)[N][L]) const {
        T in[N] = {}, out[N] = {};
#pragma unroll
        for (int j = 0; j <= TOP; ++j) {
#pragma unroll
            for (int i = 0; i < N; ++i) {
                if (lanes.lane(i) != j) continue;
                T acc = in[i];
#pragma unroll
                for (int l = 0; l < L; ++l)
                    if (level(i, l) < NZ) acc = acc + v[i][l];
                out[i] = acc;
            }
            if (j == TOP) break;
#pragma unroll
            for (int i = 0; i < N; ++i) in[i] = lanes.up(i, [&](int m) { return out[m]; });
        }
        return lanes.from(TOP, [&](int i) { return out[i]; });
    }

    // the Richards rows' chain factor, the curve's d(Psi)/d(sat), and its
    // derivative
    SOIL_FN T chain(const T sk) const {
        if constexpr (CURVE == CURVE_BC) return bc_chain<T>(sk, c, lc);
        else return soil::water_chain<T>(sk, c, P);
    }
    SOIL_FN T chain_deriv(const T sk) const {
        if constexpr (CURVE == CURVE_BC) return bc_chain_deriv<T>(sk, c, lc);
        else return soil::water_chain_deriv<T>(sk, c, P);
    }

    // the centre hydraulic conductivity of a level: Mualem's, or the linear
    // K_sat water / (water + ice + air)
    template <class V>
    SOIL_FN T centre_K(const V& v) const {
        if constexpr (MUALEM) return v.Kc;
        else return c.K_sat * v.water / (v.water + v.ice + v.air);
    }

    // the total head of a level
    SOIL_FN T head(const T sk, const T wt, const T zck) const {
        if constexpr (CURVE == CURVE_BC) return bc_head<T>(sk, wt, zck, c, lc);
        else return soil::Head<T>(sk, wt, zck, c, P).psi;
    }

    // the share of the plant-available water's beta of a level,
    // min(max((water - wp) / (fc - wp), 0), 1) times its root fraction
    SOIL_FN T paw_share(const T water, const T rfk) const {
        const T W = vmin(vmax((water - lc.wilting_point) / lc.fc_minus_wp, T(0)), T(1));
        return W * rfk;
    }

    // What the surface block gives the column: the ground heat flux, the
    // humidity flux, the infiltration and the surface's rates
    struct SurfaceOut {
        T Gg, Q_h, infil;  // the ground heat flux, the humidity flux, the infiltration
        SurfaceRates<T> r;
    };

    // The surface block of land::closure_rhs (Richards flow), operation for
    // operation: atmosphere, the snowpack's cover and melt (SNOW),
    // vegetation, interception, evapotranspiration, infiltration (of the
    // ground rain and the melt), the SEB's fused update twice (under SNOW
    // with the albedo and emissivity blended by the cover), the surface's
    // rates; from the closed surface carry s (its pool after the spill), the
    // inputs f and the top level's ground temperature Tg, water, centre K
    // and whether its closed saturation is below 1, and beta.
    // closure_rhs interleaves this block with the soil levels, the full
    // step's writer and the snowpack; drawing it out of there would move the
    // float32 contraction of the one-thread kernels it serves (land_step.cuh,
    // the SEB's note), so the group column holds its own copy
    // (land::surface_block is the same block in forward mode, for the
    // adjoint)
    SOIL_FN SurfaceOut surface(const Surface<T>& s, const Forcing<T>& f, const T Tg,
                               const T water_top, const T beta_paw, const T Kc_top,
                               const bool below1) const {
        const LandColumnParams<T>& cp = lc;
        SurfaceOut o;
        const T Ta = f.v[IN_TA], rain = f.v[IN_RAIN], p = f.v[IN_P], q = f.v[IN_Q];
        const T V = vmax(f.v[IN_WIND], cp.min_windspeed);
        const T Vr = vmax(V, T(1e-6));
        const T e_air = q * p / (cp.eps_mol + cp.one_minus_eps_mol * q);
        const T r_a0 = resistance(Ta, s.Ts, Vr, cp);
        T snow_f = T(0), melt = T(0);
        if constexpr (SNOW) {
            const T swe = vmax(s.swe, T(0));
            snow_f = swe / (swe + cp.swe_half);
            melt = swe > T(0) ? cp.ddf * vmax(Ta - cp.T_melt, T(0)) : T(0);
        }
        Vegetation<T> veg{};
        if (VEG) veg = vegetation<T>(s.C, s.An, beta_paw, Tg, e_air, f, cp);
        T rain_g = rain, f_can = T(0), I_can = T(0), R_can = T(0);
        if (VEG) {
            const T LS = veg.LAI + f.v[IN_SAI];
            const T w_max = cp.w_can_max * LS;
            f_can = w_max > T(0) ? vmin(vmax(s.w / vmax(w_max, T(1e-30)), T(0)), T(1)) : T(0);
            I_can = cp.alpha_int * rain * (T(1) - d_exp(cp.neg_k_ext_int * LS));
            R_can = vmax(s.w, T(0)) / cp.tau_w;
            rain_g = rain - I_can + R_can;
        }
        T beta_g = cp.beta_factor;
        if (cp.beta_soil) {
            const T cs = T(1) - d_cos(cp.pi * water_top / cp.field_capacity);
            beta_g = water_top < cp.field_capacity ? cs * cs / T(4) : T(1);
        }
        const T dq_s = cp.eps_mol * vpd(s.Ts, e_air) / p;
        T Q_h, E_c = T(0);
        if (VEG) {
            const T dq_g = cp.eps_mol * vpd(Tg, e_air) / p;
            const T r_e = (T(1) - d_exp(-veg.LAI - f.v[IN_SAI])) / (cp.C_can * V);
            const T r_s = T(1) / vmax(veg.gw, cp.eps_nf);
            const T E_t = dq_s / (r_a0 + r_s);
            const T E_g = beta_g * dq_g / (r_a0 + r_e);
            E_c = f_can * dq_s / r_a0;
            Q_h = E_g + E_c + E_t;
        } else {
            Q_h = beta_g * dq_s / r_a0;
        }
        {
            T rain_in = rain_g;
            if constexpr (SNOW) rain_in = rain_g + melt;
            const T drainage = s.S > T(0) ? vmax(s.S, T(0)) / cp.tau_r : T(0);
            const T influx = s.S > T(0) ? drainage : rain_in;
            o.infil = below1 ? vmin(influx, Kc_top) : T(0);
        }
        T Ts2;
        if constexpr (SNOW) {
            Radiation<T> rad;
            rad.albedo = snow_f * cp.albedo_snow + (T(1) - snow_f) * cp.albedo;
            const T eps = snow_f * cp.emissivity_snow + (T(1) - snow_f) * cp.emissivity_base;
            rad.eps_sigma = eps * cp.sigma;
            rad.one_minus_emis = T(1) - eps;
            const T G0 = ground_flux_snow(s.Ts, r_a0, f, Q_h, rad, cp);
            const T Ts1 = skin(Tg, G0, dz_top, cp);
            const T G1 = ground_flux_snow(Ts1, resistance(Ta, Ts1, Vr, cp), f, Q_h, rad, cp);
            Ts2 = skin(Tg, G1, dz_top, cp);
            const Fluxes<T> fl(Ts2, resistance(Ta, Ts2, Vr, cp), f, Q_h, rad.albedo,
                               rad.eps_sigma, rad.one_minus_emis, cp);
            o.Gg = fl.G;
        } else {
            const T G0 = ground_flux(s.Ts, r_a0, f, Q_h, cp);
            const T Ts1 = skin(Tg, G0, dz_top, cp);
            const T G1 = ground_flux(Ts1, resistance(Ta, Ts1, Vr, cp), f, Q_h, cp);
            Ts2 = skin(Tg, G1, dz_top, cp);
            const Fluxes<T> fl(Ts2, resistance(Ta, Ts2, Vr, cp), f, Q_h, cp.albedo, cp.eps_sigma,
                               cp.one_minus_emis, cp);
            o.Gg = fl.G;
        }
        o.Q_h = Q_h;
        o.r = SurfaceRates<T>{};
        o.r.Ts = Ts2;
        if (VEG) {
            o.r.dw = I_can - E_c * cp.water_flux_scale - R_can;
            const T lam = vmin(vmax((veg.LAI_b - cp.LAI_min) / cp.LAI_span, T(0)), T(1));
            o.r.dC = (T(1) - lam) * veg.NPP - cp.litter_rate * veg.LAI_b * cp.carbon_rate_scale;
            const T nu_star = vmax(s.nu, cp.nu_seed);
            o.r.dnu = lam * veg.NPP / s.C * nu_star * (T(1) - s.nu) - cp.gv_rate * nu_star;
            o.r.An = veg.An;
        }
        if constexpr (SNOW) o.r.dswe = f.v[IN_SNOW] - melt;
        return o;
    }

    // land::ImplicitRates on the group: the tendencies (0 on the slots above
    // NZ; the top level's with its Flux BCs in where rhs folds them), the
    // centre thermal conductivity, dT/dU (0 on the freeze plateau, else
    // 1/C) and the Darcy conductivity of the face below each level; the
    // ground heat flux, the infiltration, the pool's and the surface's
    // rates, one copy a thread
    struct Rates {
        T U[N][L], sat[N][L], kap[N][L], Dh[N][L], Keff[N][L];
        T Gg, infil, dS;
        SurfaceRates<T> surf;
    };

    // land::closure_rhs on the group into the rates r: the closure in place
    // (sat, and s.S += spill), the tendencies and the implicit terms, the
    // ET sink in the top level's Richards tendency; FOLD (the implicit
    // stepper's right-hand sides) also adds the top level's Flux BCs, -G /
    // dz on the energy and +infiltration / dz on the saturation, which Heun
    // (land::Rates, HeunUpdate) keeps apart, in r.Gg and r.infil
    template <bool FOLD = true>
    SOIL_FN void rhs(const T (&U)[N][L], T (&sat)[N][L], Surface<T>& s, const Forcing<T>& f,
                     Rates& r) {
        T wt;
        this->sweeps(sat, s.S, wt);

        // energy closure, centre K, plant-available water, heat flux
        T Tk[N][L], kap[N][L], Kc[N][L], water[N][L], pw[N][L];
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const soil::Level<T, MUALEM> v(sat[i][l], U[i][l], c, P);
                r.kap[i][l] = v.kap;
                r.Dh[i][l] = (U[i][l] >= v.negL && U[i][l] < T(0)) ? T(0) : T(1) / v.C;
                Kc[i][l] = centre_K(v);
                Tk[i][l] = v.Tk;
                kap[i][l] = v.kap;
                water[i][l] = v.water;
                pw[i][l] = VEG ? paw_share(v.water, rf[i][l]) : T(0);
            }
        }
        const T beta_paw = VEG ? level_sum(pw) : T(0);
        T qh[N][L];
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const T T_below = lanes.up(i, [&](int j) { return Tk[j][L - 1]; });
            const T kap_below = lanes.up(i, [&](int j) { return kap[j][L - 1]; });
#pragma unroll
            for (int l = 0; l < L; ++l) {
                // the face below level k; zero gradient at the bottom
                const bool bottom = level(i, l) == 0;
                const T T_prev = l > 0 ? Tk[i][l - 1] : T_below;
                const T kap_prev = l > 0 ? kap[i][l - 1] : kap_below;
                const T kf = T(0.5) * (kap[i][l] + (bottom ? kap[i][l] : kap_prev));
                qh[i][l] = -kf * ((Tk[i][l] - (bottom ? Tk[i][l] : T_prev)) / dzf[i][l]);
            }
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const T qh_above = lanes.down(i, [&](int j) { return qh[j][0]; });
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                r.U[i][l] = T(0);
                if (k >= NZ) continue;
                T hi;
                if (k == NZ - 1) {  // the zero-gradient face above the top level
                    const T kf = T(0.5) * (kap[i][l] + kap[i][l]);
                    hi = -kf * ((Tk[i][l] - Tk[i][l]) / dzf_top);
                } else {
                    hi = l + 1 < L ? qh[i][l + 1] : qh_above;
                }
                r.U[i][l] = -((hi - qh[i][l]) / dz[i][l]);
            }
        }

        // pressure head, Darcy flux with upwind-min face K
        T psi[N][L], FK[N][L], qw[N][L];
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) psi[i][l] = head(sat[i][l], wt, zc[i][l]);
        }
        this->face_Ks(Kc, FK);
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const T psi_below = lanes.up(i, [&](int j) { return psi[j][L - 1]; });
            const T FK_below = lanes.up(i, [&](int j) { return FK[j][L - 1]; });
            const T FK_above = lanes.down(i, [&](int j) { return FK[j][0]; });
#pragma unroll
            for (int l = 0; l < L; ++l) {
                // face k below level k: zero-gradient ghost at the bottom
                const int k = level(i, l);
                const T psi_k = psi[i][l];
                const T lower = k == 0 ? psi_k : (l > 0 ? psi[i][l - 1] : psi_below);
                const T grad = (psi_k - lower) / dzf[i][l];
                const T K_lo = k == 0 ? T(INFINITY) : (l > 0 ? FK[i][l - 1] : FK_below);
                const T K_hi = k == NZ - 1 ? Kc[i][l] : (l + 1 < L ? FK[i][l + 1] : FK_above);
                const T K_k = FK[i][l];
                const T K_eff = grad < T(0) ? vmin(K_lo, K_k) : vmin(K_k, K_hi);
                r.Keff[i][l] = K_eff;
                qw[i][l] = -K_eff * grad;
            }
        }
        T dth_top = T(0);  // the top level's -(flux difference) / dz, on its lane
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const T qw_above = lanes.down(i, [&](int j) { return qw[j][0]; });
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                r.sat[i][l] = T(0);
                if (k >= NZ) continue;
                if (k == NZ - 1) {  // the top face: zero-gradient ghost
                    const T psi_k = psi[i][l];
                    const T grad = (psi_k - psi_k) / dzf_top;
                    const T K_lo = FK[i][l];
                    const T K_k = Kc[i][l];
                    const T K_eff = grad < T(0) ? vmin(K_lo, K_k) : vmin(K_k, T(INFINITY));
                    const T hi = -K_eff * grad;
                    dth_top = -((hi - qw[i][l]) / dz_top);
                } else {
                    const T hi = l + 1 < L ? qw[i][l + 1] : qw_above;
                    r.sat[i][l] = (-((hi - qw[i][l]) / dz[i][l])) / c.por;
                }
            }
        }
        r.dS = lc.drain_sign * vmin(vmax(s.S, T(0)) / lc.tau_r, s.S);

        // the surface block, one value a column, and the top level's Flux
        // BCs and ET sink
        const SurfaceOut o = surface(s, f, top_of(Tk), top_of(water), beta_paw, top_of(Kc),
                                     top_of(sat) < T(1));
        r.surf = o.r;
        r.Gg = o.Gg;
        r.infil = o.infil;
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                if (level(i, l) != NZ - 1) continue;
                const T sink = -o.Q_h * lc.water_flux_scale / dz_top;
                r.sat[i][l] = (dth_top + sink) / c.por;
                if (FOLD) {
                    r.U[i][l] = r.U[i][l] - o.Gg / dz_top;
                    r.sat[i][l] = r.sat[i][l] - (T(-1) * o.infil) / dz_top;
                }
            }
        }
    }

    // land::picard_step (Richards flow) on the group with `iters` Picard
    // iterations, operation for operation (iteration 0 that of
    // land::implicit_step): iteration 0 closes the column and a copy of the
    // surface carry, keeps the pool's spill and the closed start u^n; each
    // further iteration closes the iterate and a copy of the surface carry
    // as iteration 0 left it (the spill dropped, the SWE unclipped) and
    // solves with the right-hand side tend(u_k) - (u_k - u^n) / dt; the
    // pool, skin, canopy water, carbon, vegetation fraction, net
    // assimilation and SWE take iteration 0's rates, and the SWE is clipped
    // at 0 once, at the end (at one iteration implicit_step's clip). One
    // body serves every iteration (not unrolled).
    template <int SOLVER>
    SOIL_FN void picard_step(T (&U)[N][L], T (&sat)[N][L], Surface<T>& s, const Forcing<T>& f,
                             const T dt, const T inv_dt, const int iters) {
        T Un[N][L], sn[N][L];
#pragma unroll 1
        for (int it = 0; it < iters; ++it) {
            Rates r;
            Surface<T> y = s;
            rhs(U, sat, y, f, r);
            if (it == 0) {
                s.S = y.S;
#pragma unroll
                for (int i = 0; i < N; ++i) {
#pragma unroll
                    for (int l = 0; l < L; ++l) { Un[i][l] = U[i][l]; sn[i][l] = sat[i][l]; }
                }
            } else {
#pragma unroll
                for (int i = 0; i < N; ++i) {
#pragma unroll
                    for (int l = 0; l < L; ++l) {
                        if (level(i, l) >= NZ) continue;
                        r.U[i][l] = r.U[i][l] - (U[i][l] - Un[i][l]) / dt;
                        r.sat[i][l] = r.sat[i][l] - (sat[i][l] - sn[i][l]) / dt;
                    }
                }
            }
            this->template implicit_solves<SOLVER, false>(r, U, sat, inv_dt,
                                                          [&](T sk) { return chain(sk); });
            if (it == 0) {
                s.S = s.S + r.dS * dt;
                s.Ts = r.surf.Ts + T(0) * dt;
                if (VEG) {
                    s.w = s.w + r.surf.dw * dt;
                    s.C = s.C + r.surf.dC * dt;
                    s.nu = s.nu + r.surf.dnu * dt;
                    s.An = r.surf.An;
                }
                if constexpr (SNOW) s.swe = s.swe + r.surf.dswe * dt;
            }
        }
        if constexpr (SNOW) s.swe = vmax(s.swe, T(0));
    }

    // Heun's stage of land::heun_step on the group: the closure of x_n in
    // place (sat, and s.S += spill) and its rates r with the inputs f0 (the
    // top level's Flux BCs kept apart), then the stage y = x_n + f_n dt
    // with x_n's Flux BCs on the top level, the stage's skin temperature
    // and net assimilation x_n's new ones, its SWE clipped at 0 (SNOW).
    // heun_step runs it, and heun_step_adjoint recomputes the stage by it
    // from the step's stored start: one body at the rollout's G. The Heun
    // entries of both group sources (and the snowpack's) are built without
    // contracted multiply-adds at every dtype (ops/cuda_build.py,
    // TAG_FLAGS), so that the two kernels round the step alike: contracted,
    // the compiler fused them differently in each kernel
    SOIL_FN void heun_stage(const T (&U)[N][L], T (&sat)[N][L], Surface<T>& s,
                            const Forcing<T>& f0, const T dt, Rates& r, T (&yU)[N][L],
                            T (&ys)[N][L], Surface<T>& y) {
        rhs<false>(U, sat, s, f0, r);
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                if (level(i, l) == NZ - 1) {
                    yU[i][l] = U[i][l] + (r.U[i][l] - r.Gg / dz_top) * dt;
                    ys[i][l] = sat[i][l] + (r.sat[i][l] - (T(-1) * r.infil) / dz_top) * dt;
                } else {
                    yU[i][l] = U[i][l] + r.U[i][l] * dt;
                    ys[i][l] = sat[i][l] + r.sat[i][l] * dt;
                }
            }
        }
        y = s;
        y.S = s.S + r.dS * dt;
        y.Ts = r.surf.Ts + T(0) * dt;
        if (VEG) {
            y.w = s.w + r.surf.dw * dt;
            y.C = s.C + r.surf.dC * dt;
            y.nu = s.nu + r.surf.dnu * dt;
            y.An = r.surf.An;
        }
        if constexpr (SNOW) y.swe = vmax(s.swe + r.surf.dswe * dt, T(0));
    }

    // land::heun_step (Richards flow) on the group, operation for
    // operation: heun_stage with the inputs f0 at t_n, the closure and rates
    // of the stage with the inputs f1 at t_n + dt, then the corrector
    // (land::HeunUpdate) x_n + (0.5 (f_n + f*) + BC_n) dt, the top level's
    // Flux BCs x_n's, kept apart from the mean as the one-thread step keeps
    // them; the skin temperature and the net assimilation x_n's; the SWE
    // clipped at 0 (SNOW). The stage
    // and both rates are held in each lane (about 9 L values beside the
    // carry)
    SOIL_FN void heun_step(T (&U)[N][L], T (&sat)[N][L], Surface<T>& s, const Forcing<T>& f0,
                           const Forcing<T>& f1, const T dt) {
        Rates r, q;
        T yU[N][L], ys[N][L];
        Surface<T> y;
        heun_stage(U, sat, s, f0, dt, r, yU, ys, y);
        rhs<false>(yU, ys, y, f1, q);
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                if (k >= NZ) continue;
                if (k == NZ - 1) {
                    U[i][l] = U[i][l] + (T(0.5) * (r.U[i][l] + q.U[i][l]) - r.Gg / dz_top) * dt;
                    sat[i][l] = sat[i][l] + (T(0.5) * (r.sat[i][l] + q.sat[i][l])
                                             - (T(-1) * r.infil) / dz_top) * dt;
                } else {
                    U[i][l] = U[i][l] + (T(0.5) * (r.U[i][l] + q.U[i][l])) * dt;
                    sat[i][l] = sat[i][l] + (T(0.5) * (r.sat[i][l] + q.sat[i][l])) * dt;
                }
            }
        }
        s.S = s.S + (T(0.5) * (r.dS + q.dS)) * dt;
        s.Ts = r.surf.Ts + (T(0.5) * (T(0) + T(0))) * dt;
        if (VEG) {
            s.w = s.w + (T(0.5) * (r.surf.dw + q.surf.dw)) * dt;
            s.C = s.C + (T(0.5) * (r.surf.dC + q.surf.dC)) * dt;
            s.nu = s.nu + (T(0.5) * (r.surf.dnu + q.surf.dnu)) * dt;
            s.An = r.surf.An;
        }
        if constexpr (SNOW)
            s.swe = vmax(s.swe + (T(0.5) * (r.surf.dswe + q.surf.dswe)) * dt, T(0));
    }

    // One step of rollout from clock time t: each series input of column
    // `col` read into f at t (land::read_series: every lane of the group
    // reads its column's value), then ImplicitEuler's picard_step
    // (soil::STEPPER_IMPLICIT, SOLVER, `iters` Picard iterations) or Heun's
    // heun_step (soil::STEPPER_HEUN), whose stage reads a copy of f with the
    // series at t + dt
    template <int STEPPER, int SOLVER>
    SOIL_FN void rollout_step(T (&U)[N][L], T (&sat)[N][L], Surface<T>& s, Forcing<T>& f,
                              const LandInputs& inputs, const long long col, const T t,
                              const T dt, const T inv_dt, const int iters) {
        static_assert(STEPPER == soil::STEPPER_HEUN || STEPPER == soil::STEPPER_IMPLICIT,
                      "the land group column steps by Heun or ImplicitEuler");
        read_series(f, inputs, col, t);
        if constexpr (STEPPER == soil::STEPPER_HEUN) {
            Forcing<T> f1 = f;
            read_series(f1, inputs, col, t + dt);
            heun_step(U, sat, s, f, f1, dt);
        } else {
            picard_step<SOLVER>(U, sat, s, f, dt, inv_dt, iters);
        }
    }

    // land::rollout_column on the group of STEPPER (rollout_step; inv_dt
    // 1 / dt as the host rounds it): `steps` steps in place from clock time
    // t, which advances by t + dt as Clock.tick does; f holds the static
    // inputs. The column code of csrc/land_column_group_rollout.cu
    template <int STEPPER, int SOLVER>
    SOIL_FN void rollout(T (&U)[N][L], T (&sat)[N][L], Surface<T>& s, Forcing<T>& f,
                         const LandInputs& inputs, const long long col, T t, const int steps,
                         const T dt, const T inv_dt, const int iters) {
        for (int n = 0; n < steps; ++n) {
            rollout_step<STEPPER, SOLVER>(U, sat, s, f, inputs, col, t, dt, inv_dt, iters);
            t = t + dt;
        }
    }

    // ---------------------------------------------------------------------
    // adjoint
    // ---------------------------------------------------------------------
    //
    // land_adjoint.cuh's (closure_rhs_adjoint, picard_iter_adjoint,
    // picard_step_adjoint) with each value formed by the same operations in
    // the same order; the soil's pieces are soil::GroupColumn's, which gather
    // across lanes, in the one-thread loop's order, the shares that the
    // one-thread adjoint scatters. So a host build equals the one-thread
    // adjoint bit for bit.

    // land::surface_adjoint on the group: gx = J^T gy for the surface
    // block's Jacobian at xv, the used input directions (all ten under
    // vegetation; the ground temperature, top water, top centre K, pool
    // and skin temperature without; and the SWE under SNOW, last) taken in
    // rounds across the lanes (lane j the used directions j, j + G, ...),
    // one forward pass a direction, each direction's cotangent read from
    // its lane
    SOIL_FN void surface_adjoint(const T (&xv)[SI_N + SNOW], const T (&gy)[SO_N + SNOW],
                                 const bool below1, const Forcing<T>& f,
                                 T (&gx)[SI_N + SNOW]) const {
        constexpr int USED = (VEG ? SI_N : SI_N - 5) + SNOW;
        constexpr int R = (USED + G - 1) / G;
        // the m-th used direction: without vegetation TG, WTOP, KC, S, TS
        // (then SWE)
        auto direction = [](int m) {
            return VEG ? m : (m < 2 ? m : (m < SI_N - 5 ? m + 1 : int(SI_SWE)));
        };
        T acc[N][R];
#pragma unroll 1
        for (int r = 0; r < R; ++r) {
            T a[N];
#pragma unroll
            for (int i = 0; i < N; ++i) {
                const int m = r * G + lanes.lane(i);
                T sum = T(0);
                if (m < USED) {
                    const int d = direction(m);
                    Dual<T> x[SI_N + SNOW], y[SO_N + SNOW];
#pragma unroll
                    for (int j = 0; j < SI_N + SNOW; ++j)
                        x[j] = Dual<T>(xv[j], j == d ? T(1) : T(0));
                    surface_block<T, VEG, true, SNOW>(x, below1, f, lc, dz_top, y);
#pragma unroll
                    for (int o = 0; o < SO_N + SNOW; ++o)
                        if (gy[o] != T(0) && y[o].d != T(0)) sum += gy[o] * y[o].d;
                }
                a[i] = sum;
            }
#pragma unroll
            for (int q = 0; q < R; ++q) {
                if (q != r) continue;
#pragma unroll
                for (int i = 0; i < N; ++i) acc[i][q] = a[i];
            }
        }
#pragma unroll
        for (int d = 0; d < SI_N + SNOW; ++d) gx[d] = T(0);
#pragma unroll
        for (int m = 0; m < USED; ++m)
            gx[direction(m)] = lanes.from(m % G, [&](int i) { return acc[i][m / G]; });
    }

    // land::closure_rhs_adjoint (Richards flow; the implicit terms'
    // cotangents x, TermCotangents, or none, NoTermCotangents: Heun reads no
    // term, and adding a zero cotangent would turn a -0 into +0) on the
    // group: on entry gU, gs and gsc hold the cotangents of what the stepper
    // reads directly of the closed column and surface carry (under SNOW
    // gsc.swe the carried SWE's), gfU and gfs those of the tendencies (the
    // top level's before its Flux BCs), gy those of the surface block's
    // outputs (all but SO_QH, which the ET sink adds here); on return gU, gs
    // and gsc are the cotangents of the step's input carry. Each lane's
    // parameter cotangents accumulate into gKsat[i] and gskm[i].
    template <class X>
    SOIL_FN void rhs_adjoint(const T (&U)[N][L], const T (&sat)[N][L], const Surface<T>& s,
                             const Forcing<T>& f, T (&gU)[N][L], T (&gs)[N][L], Surface<T>& gsc,
                             const T (&gfU)[N][L], const T (&gfs)[N][L],
                             T (&gy)[SO_N + SNOW], const X& x, T (&gKsat)[N], T (&gskm)[N]) {
        // ---- recompute: sweeps with their predicates, closure, K, heads, PAW
        T ss[N][L], S1 = s.S, wt;
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) ss[i][l] = sat[i][l];
        }
        SweepBits bits;
        this->template sweeps<true>(ss, S1, wt, bits);
        T Tk[N][L], kap[N][L], water[N][L], Kc[N][L], psi[N][L], pw[N][L], FK[N][L];
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const soil::Level<T, MUALEM> v(ss[i][l], U[i][l], c, P);
                Tk[i][l] = v.Tk;
                kap[i][l] = v.kap;
                water[i][l] = v.water;
                Kc[i][l] = centre_K(v);
                psi[i][l] = head(ss[i][l], wt, zc[i][l]);
                pw[i][l] = VEG ? paw_share(v.water, rf[i][l]) : T(0);
            }
        }
        const T beta_paw = VEG ? level_sum(pw) : T(0);
        this->face_Ks(Kc, FK);

        // ---- Richards flow: the top level's ET sink, then the interior faces
        gy[SO_QH] = gy[SO_QH] - ((top_of(gfs) / c.por) * lc.water_flux_scale) / dz_top;
        T gKf[N][L], gpsi[N][L], gKf_top;
        this->darcy_adjoint(gfs, psi, FK, Kc, x, gKf, gpsi, gKf_top);

        // ---- the surface block
        T gx[SI_N + SNOW];
        {
            T xv[SI_N + SNOW] = {top_of(Tk), top_of(water), beta_paw, top_of(Kc), S1,
                                 s.Ts, s.w, s.C, s.nu, s.An};
            if constexpr (SNOW) xv[SI_SWE] = s.swe;
            surface_adjoint(xv, gy, top_of(ss) < T(1), f, gx);
        }
        const T gS1 = gsc.S + gx[SI_S];
        gsc.Ts = gsc.Ts + gx[SI_TS];
        gsc.w = gsc.w + gx[SI_W];
        gsc.C = gsc.C + gx[SI_C];
        gsc.nu = gsc.nu + gx[SI_NU];
        gsc.An = gsc.An + gx[SI_AN];
        if constexpr (SNOW) gsc.swe = gsc.swe + gx[SI_SWE];

        // ---- face K from centre K; the heat flux of the interior faces
        T gKc[N][L], gT[N][L], gkap[N][L];
        this->centre_K_adjoint(Kc, gKf, gKf_top, gx[SI_KC], gKc);
        this->template heat_flux_adjoint<false>(gfU, Tk, kap, T(0), x, gx[SI_TG], gT, gkap);

        // ---- level by level: head, linear centre K, PAW, top water, closure
        const T gbeta = gx[SI_BETA];
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                if (k >= NZ) continue;
                T gsk = gs[i][l];  // what the caller reads of the closed saturation
                if constexpr (CURVE == CURVE_BC)
                    gsk += bc_head_adjoint<T>(ss[i][l], gpsi[i][l], c, lc);
                else
                    this->vg_head_adjoint(ss[i][l], wt, zc[i][l], gpsi[i][l], gsk);
                const soil::Level<T, MUALEM> v(ss[i][l], U[i][l], c, P);
                T gwx = k == NZ - 1 ? gx[SI_WTOP] : T(0), gix = T(0), gax = T(0);
                if constexpr (!MUALEM) {
                    // Kc = (K_sat water) / ((water + ice) + air)
                    const T den = (v.water + v.ice) + v.air;
                    const T gnum = gKc[i][l] / den;
                    gKsat[i] += gnum * v.water;
                    gwx += gnum * c.K_sat;
                    const T gden = -(gKc[i][l] * Kc[i][l]) / den;
                    gwx += gden;
                    gix += gden;
                    gax += gden;
                }
                if (VEG) {
                    const T q = (v.water - lc.wilting_point) / lc.fc_minus_wp;
                    if (q >= T(0) && q <= T(1)) gwx += (gbeta * rf[i][l]) / lc.fc_minus_wp;
                }
                T gUk = gU[i][l];  // what the caller reads of U
                T gCx = T(0);  // the implicit rows' cotangent of the heat capacity
                if constexpr (X::on) gCx = x.gC[i][l];
                soil::level_adjoint<T, MUALEM, X::on, true>(
                    v, ss[i][l], U[i][l], gT[i][l], gkap[i][l], MUALEM ? gKc[i][l] : T(0), gCx,
                    c, P, gsk, gUk, gKsat[i], gskm[i], gwx, gix, gax);
                gs[i][l] = gsk;
                gU[i][l] = gUk;
            }
        }

        // ---- the saturation adjustment in reverse (the spill's cotangent,
        // the closed pool's, enters at the top)
        gsc.S = gS1;
        this->sweeps_adjoint(bits, gs, gS1);
    }

    // land::picard_iter_adjoint (Richards flow) on the group: cotangents
    // through one iteration of picard_step at its iterate (U, sat) before
    // the iteration's closure, with the surface carry s it reads; the
    // closure, the tendencies, the terms and the rows recomputed there, each
    // system undone by one solve of its transposed rows
    // (soil::GroupColumn::systems_adjoint), then the surface's path (the
    // first iteration: the Euler updates of the surface and, under SNOW,
    // the step's closing clip of the SWE, gsc the cotangents of the surface
    // after the step; a later one: its rows' ground heat flux and
    // infiltration alone, its inputs' cotangents added to gsc) and the
    // closure's adjoint
    template <int SOLVER>
    SOIL_FN void picard_iter_adjoint(const T (&U)[N][L], const T (&sat)[N][L],
                                     const Surface<T>& s, const Forcing<T>& f, const bool later,
                                     const T (&Un)[N][L], const T (&sn)[N][L], T (&gU)[N][L],
                                     T (&gs)[N][L], Surface<T>& gsc, T (&gUn)[N][L],
                                     T (&gsn)[N][L], T (&gKsat)[N], T (&gskm)[N], const T dt,
                                     const T inv_dt) {
        T xs[N][L];
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) xs[i][l] = sat[i][l];
        }
        Surface<T> xsurf = s;
        Rates r;
        rhs(U, xs, xsurf, f, r);
        TermCotangents x;
        T gfU[N][L], gfs[N][L];
        this->template systems_adjoint<SOLVER, false>(
            r, U, xs, later, Un, sn, gU, gs, gUn, gsn, gfU, gfs, x, dt, inv_dt,
            [&](T sk) { return chain(sk); }, [&](T sk) { return chain_deriv(sk); });
        T gy[SO_N + SNOW];
        gy[SO_QH] = T(0);
        gy[SO_G] = -top_of(gfU) / dz_top;
        gy[SO_INFIL] = top_of(gfs) / dz_top;
        Surface<T> gk{};
        if (later) {
#pragma unroll
            for (int o = SO_POOL; o < SO_N + SNOW; ++o) gy[o] = T(0);
        } else {
            T swe_new = T(0);
            if constexpr (SNOW) swe_new = s.swe + r.surf.dswe * dt;
            surface_update_adjoint<T, VEG, true, SNOW>(gsc, gy, dt, swe_new);
            gk = gsc;
        }
        rhs_adjoint(U, sat, s, f, gU, gs, gk, gfU, gfs, gy, x, gKsat, gskm);
        if (later) {
            gsc.S = gsc.S + gk.S;
            gsc.Ts = gsc.Ts + gk.Ts;
            gsc.w = gsc.w + gk.w;
            gsc.C = gsc.C + gk.C;
            gsc.nu = gsc.nu + gk.nu;
            gsc.An = gsc.An + gk.An;
            if constexpr (SNOW) gsc.swe = gsc.swe + gk.swe;
        } else {
            gsc = gk;
        }
    }

    // land::picard_step_adjoint on the group: the iterations undone from
    // the last; for iteration k the iterate u_k and the surface carry after
    // iteration 0 are recomputed from the step's start by picard_step's
    // first k iterations, inline, the forward's own code at the forward's G
    // (nothing is stored per iteration), then picard_iter_adjoint takes them
    // back to the iterate before it. The closed start u^n that the later
    // iterations read is the start's sweeps. Under SNOW the recomputed
    // surface's SWE is set to what the iteration read, which picard_step's
    // closing clip does not keep: the start's for iteration 0, iteration
    // 0's unclipped update for the later ones.
    template <int SOLVER>
    SOIL_FN void picard_step_adjoint(const T (&U)[N][L], const T (&sat)[N][L],
                                     const Surface<T>& s, const Forcing<T>& f, T (&gU)[N][L],
                                     T (&gs)[N][L], Surface<T>& gsc, T (&gKsat)[N],
                                     T (&gskm)[N], const T dt, const T inv_dt,
                                     const int iters) {
        T sn[N][L], gUn[N][L] = {}, gsn[N][L] = {};
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) sn[i][l] = sat[i][l];
        }
        {
            T Sx = s.S, wt;
            this->sweeps(sn, Sx, wt);
        }
#pragma unroll 1
        for (int it = iters - 1; it >= 0; --it) {
            T xU[N][L], xs[N][L];
#pragma unroll
            for (int i = 0; i < N; ++i) {
#pragma unroll
                for (int l = 0; l < L; ++l) { xU[i][l] = U[i][l]; xs[i][l] = sat[i][l]; }
            }
            Surface<T> xsurf = s;
            picard_step<SOLVER>(xU, xs, xsurf, f, dt, inv_dt, it);
            if constexpr (SNOW)
                xsurf.swe = it == 0 ? s.swe : s.swe + swe_rate<T>(s.swe, f, lc) * dt;
            picard_iter_adjoint<SOLVER>(xU, xs, xsurf, f, it > 0, U, sn, gU, gs, gsc, gUn, gsn,
                                        gKsat, gskm, dt, inv_dt);
        }
    }

    // land::heun_step_adjoint (Richards flow) on the group: cotangents
    // through one heun_step from its input (U, sat, s); on entry (gU, gs,
    // gsc) are those of the step's output, on return those of its input.
    // The stage is recomputed by heun_stage, heun_step's own code at the
    // rollout's G; then one body, in a loop that is not unrolled, takes
    // rhs_adjoint without terms twice: at the stage with the inputs f1, from
    // what the corrector reads of it (half of the tendencies and of the
    // pool, canopy water, carbon, fraction and SWE rates), then at x_n with
    // the inputs f0, from the corrector's reads of x_n (the carry, the other
    // half of the rates, the top Flux BCs, the skin temperature and the net
    // assimilation) added to the stage's Euler update's. The two SWE clips
    // (SNOW), the stage's and the corrector's, pass the cotangent where
    // their argument is >= 0. Each value is formed by the one-thread
    // adjoint's operations in its order.
    SOIL_FN void heun_step_adjoint(const T (&U)[N][L], const T (&sat)[N][L], const Surface<T>& s,
                                   const Forcing<T>& f0, const Forcing<T>& f1, T (&gU)[N][L],
                                   T (&gs)[N][L], Surface<T>& gsc, T (&gKsat)[N], T (&gskm)[N],
                                   const T dt) {
        // pass 0 takes the stage (xU, xs, xsurf) with the inputs f1 and no
        // direct cotangents; pass 1 takes x_n with f0 and (gU, gs, gsc)
        T xU[N][L], xs[N][L];
        Surface<T> xsurf;
        {
            T cs[N][L];
#pragma unroll
            for (int i = 0; i < N; ++i) {
#pragma unroll
                for (int l = 0; l < L; ++l) cs[i][l] = sat[i][l];
            }
            Surface<T> cx = s;
            Rates r;
            heun_stage(U, cs, cx, f0, dt, r, xU, xs, xsurf);
        }
        // the corrector's SWE cotangent through its clip, and the stage's clip
        T gswe1 = T(0);
        bool stage_passes = true;
        if constexpr (SNOW) {
            const T dn = swe_rate<T>(s.swe, f0, lc), ds = swe_rate<T>(xsurf.swe, f1, lc);
            stage_passes = s.swe + dn * dt >= T(0);
            gswe1 = s.swe + (T(0.5) * (dn + ds)) * dt >= T(0) ? gsc.swe : T(0);
        }
        T gfU[N][L], gfs[N][L], gxU[N][L], gxs[N][L], gy[SO_N + SNOW];
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                gfU[i][l] = T(0.5) * (gU[i][l] * dt);
                gfs[i][l] = T(0.5) * (gs[i][l] * dt);
                gxU[i][l] = T(0);
                gxs[i][l] = T(0);
            }
        }
        gy[SO_G] = T(0);
        gy[SO_QH] = T(0);
        gy[SO_INFIL] = T(0);
        gy[SO_POOL] = T(0.5) * (gsc.S * dt);
        gy[SO_TS] = T(0);
        gy[SO_DW] = VEG ? T(0.5) * (gsc.w * dt) : T(0);
        gy[SO_DC] = VEG ? T(0.5) * (gsc.C * dt) : T(0);
        gy[SO_DNU] = VEG ? T(0.5) * (gsc.nu * dt) : T(0);
        gy[SO_AN] = T(0);
        if constexpr (SNOW) gy[SO_DSWE] = T(0.5) * (gswe1 * dt);
        Surface<T> gx{};
        const Forcing<T>* f = &f1;
#pragma unroll 1
        for (int pass = 0; pass < 2; ++pass) {
            rhs_adjoint(xU, xs, xsurf, *f, gxU, gxs, gx, gfU, gfs, gy, NoTermCotangents{}, gKsat,
                        gskm);
            if (pass == 0) {  // y = x_n (closed) + (f_n + BC_n) dt
                gy[SO_G] = -(lanes.from(TOP, [&](int i) { return gU[i][LT] + gxU[i][LT]; })
                             * dt) / dz_top;
                gy[SO_INFIL] = (lanes.from(TOP, [&](int i) { return gs[i][LT] + gxs[i][LT]; })
                                * dt) / dz_top;
#pragma unroll
                for (int i = 0; i < N; ++i) {
#pragma unroll
                    for (int l = 0; l < L; ++l) {
                        gfU[i][l] = gfU[i][l] + gxU[i][l] * dt;
                        gfs[i][l] = gfs[i][l] + gxs[i][l] * dt;
                        gxU[i][l] = gU[i][l] + gxU[i][l];
                        gxs[i][l] = gs[i][l] + gxs[i][l];
                        xU[i][l] = U[i][l];
                        xs[i][l] = sat[i][l];
                    }
                }
                gy[SO_QH] = T(0);
                gy[SO_POOL] = gy[SO_POOL] + gx.S * dt;
                gx.S = gsc.S + gx.S;
                gy[SO_TS] = gsc.Ts + gx.Ts;
                gx.Ts = T(0);
                if (VEG) {
                    gy[SO_DW] = gy[SO_DW] + gx.w * dt;
                    gy[SO_DC] = gy[SO_DC] + gx.C * dt;
                    gy[SO_DNU] = gy[SO_DNU] + gx.nu * dt;
                    gy[SO_AN] = gsc.An + gx.An;
                    gx.w = gsc.w + gx.w;
                    gx.C = gsc.C + gx.C;
                    gx.nu = gsc.nu + gx.nu;
                    gx.An = T(0);
                }
                if constexpr (SNOW) {
                    const T gswe0 = stage_passes ? gx.swe : T(0);
                    gy[SO_DSWE] = gy[SO_DSWE] + gswe0 * dt;
                    gx.swe = gswe1 + gswe0;
                }
                xsurf = s;
                f = &f0;
            }
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                gU[i][l] = gxU[i][l];
                gs[i][l] = gxs[i][l];
            }
        }
        gsc = gx;
    }

    // land::segment_vjp_column of STEPPER on the group (soil::STEPPER_HEUN:
    // heun_step, through the rollout's own rollout_step with `inputs`, whose
    // reads leave static inputs as they are: handed the same inputs twice,
    // heun_step let the compiler share work between its two closures, and
    // a segment took 64.69 ms against 54.66-58.67 (Nz 20 f32, an H100 80GB
    // HBM3; PERF.md section 6); soil::STEPPER_IMPLICIT: picard_step with
    // SOLVER and `iters` Picard iterations), with static inputs f: `steps`
    // steps from the
    // carry (U, sat, s), each step's input carry stored to `scratch` where
    // `store` (land::ScratchRows rows a step, laid out [step][row][cell]:
    // U[0 .. NZ), sat[0 .. NZ), then the pool, skin temperature, canopy
    // water, carbon, vegetation fraction, net assimilation and, under SNOW,
    // the SWE, each lane its levels', lane 0 the surface's); then the
    // reverse sweep of
    // the step's adjoint from the output cotangents (gU, gs, gsc), which
    // become the input carry's. The forward is the group rollout's own step,
    // so at the rollout's G its carries are the rollout's bit for bit. A
    // group that does not store (beyond the last column) recomputes from its
    // own carry, and its results are not used.
    template <int STEPPER, int SOLVER>
    SOIL_FN void segment_vjp(T (&U)[N][L], T (&sat)[N][L], Surface<T>& s, T (&gU)[N][L],
                             T (&gs)[N][L], Surface<T>& gsc, T* scratch, const long long col,
                             const long long cells, const bool store, const Forcing<T>& f,
                             const LandInputs& inputs, const int steps, const T dt,
                             const T inv_dt, const int iters, T (&gKsat)[N], T (&gskm)[N]) {
        constexpr long long ROWS = ScratchRows<NZ, SNOW>::value;
        Forcing<T> fr = f;  // Heun's forward inputs, as rollout_step reads them
        T t = T(0);
        for (int n = 0; n < steps; ++n) {
            T* rec = scratch + (long long)n * ROWS * cells + col;
            if (store) {
#pragma unroll
                for (int i = 0; i < N; ++i) {
#pragma unroll
                    for (int l = 0; l < L; ++l) {
                        const int k = level(i, l);
                        if (k < NZ) {
                            rec[k * cells] = U[i][l];
                            rec[(NZ + k) * cells] = sat[i][l];
                        }
                    }
                    if (lanes.lane(i) == 0) {
                        rec[(2 * NZ) * cells] = s.S;
                        rec[(2 * NZ + 1) * cells] = s.Ts;
                        rec[(2 * NZ + 2) * cells] = s.w;
                        rec[(2 * NZ + 3) * cells] = s.C;
                        rec[(2 * NZ + 4) * cells] = s.nu;
                        rec[(2 * NZ + 5) * cells] = s.An;
                        if constexpr (SNOW) rec[(2 * NZ + 6) * cells] = s.swe;
                    }
                }
            }
            if constexpr (STEPPER == soil::STEPPER_HEUN) {
                rollout_step<STEPPER, SOLVER>(U, sat, s, fr, inputs, col, t, dt, inv_dt, iters);
                t = t + dt;
            } else {
                picard_step<SOLVER>(U, sat, s, f, dt, inv_dt, iters);
            }
        }
        for (int n = steps - 1; n >= 0; --n) {
            const T* rec = scratch + (long long)n * ROWS * cells + col;
            if (store) {
#pragma unroll
                for (int i = 0; i < N; ++i) {
#pragma unroll
                    for (int l = 0; l < L; ++l) {
                        const int k = level(i, l);
                        if (k < NZ) {
                            U[i][l] = rec[k * cells];
                            sat[i][l] = rec[(NZ + k) * cells];
                        }
                    }
                }
                s.S = rec[(2 * NZ) * cells];
                s.Ts = rec[(2 * NZ + 1) * cells];
                s.w = rec[(2 * NZ + 2) * cells];
                s.C = rec[(2 * NZ + 3) * cells];
                s.nu = rec[(2 * NZ + 4) * cells];
                s.An = rec[(2 * NZ + 5) * cells];
                if constexpr (SNOW) s.swe = rec[(2 * NZ + 6) * cells];
            }
            if constexpr (STEPPER == soil::STEPPER_HEUN)
                heun_step_adjoint(U, sat, s, f, f, gU, gs, gsc, gKsat, gskm, dt);
            else
                picard_step_adjoint<SOLVER>(U, sat, s, f, gU, gs, gsc, gKsat, gskm, dt, inv_dt,
                                            iters);
        }
    }
};

}  // namespace land
