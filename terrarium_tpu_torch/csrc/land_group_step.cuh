// One ImplicitEuler step of a LandModel column spread over a group of G
// lanes (any number of Picard iterations, either solver, Richards flow, with
// or without vegetation, either retention curve and conductivity, no
// snowpack), and the segment VJP of that step on the same group: the column
// code of csrc/land_column_group_segment_vjp.cu.
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
//   another (land::surface_adjoint), takes the directions in rounds across
//   the group's lanes: lane j the used directions j, j + G, ..., so the
//   passes take ceil(10 / G) rounds (5 directions without vegetation), each
//   lane carrying one pass's Dual state at a time; each direction's
//   cotangent is then read from its lane by one shuffle. Each pass is the
//   one-thread pass's arithmetic (land::surface_block), so the contraction
//   is bitwise the one-thread adjoint's.
//
// Iteration 0 of picard_step is land::implicit_step's arithmetic (the
// surface copy it closes is written back, which implicit_step does in
// place), so one body serves one iteration and more.
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
// hand-offs, one lane of a group at a time, favour 8 over 4. Other depths
// take the same sizes (not measured).
#if defined(__CUDACC__)
__host__ __device__
#endif
constexpr int implicit_group_lanes(int /* nz */, int solver) {
    return solver == soil::SOLVER_THOMAS ? 8 : 4;
}

// A LandModel column on a group: soil::GroupColumn's levels and exchange,
// the land's parameters and root fractions, the closure and the
// ImplicitEuler step and its adjoint (Richards flow, no snowpack)
template <typename T, int NZ, int G, class Lanes, bool VEG, int CURVE, int COND>
struct GroupColumn : soil::GroupColumn<T, NZ, G, Lanes> {
    using Base = soil::GroupColumn<T, NZ, G, Lanes>;
    using typename Base::SweepBits;
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

    // The surface block of land::closure_rhs (Richards flow, no snowpack),
    // operation for operation: atmosphere, vegetation, interception,
    // evapotranspiration, infiltration, the SEB's fused update twice, the
    // surface's rates; from the closed surface carry s (its pool after the
    // spill), the inputs f and the top level's ground temperature Tg, water,
    // centre K and whether its closed saturation is below 1, and beta.
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
            const T rain_in = rain_g;
            const T drainage = s.S > T(0) ? vmax(s.S, T(0)) / cp.tau_r : T(0);
            const T influx = s.S > T(0) ? drainage : rain_in;
            o.infil = below1 ? vmin(influx, Kc_top) : T(0);
        }
        const T G0 = ground_flux(s.Ts, r_a0, f, Q_h, cp);
        const T Ts1 = skin(Tg, G0, dz_top, cp);
        const T G1 = ground_flux(Ts1, resistance(Ta, Ts1, Vr, cp), f, Q_h, cp);
        const T Ts2 = skin(Tg, G1, dz_top, cp);
        const Fluxes<T> fl(Ts2, resistance(Ta, Ts2, Vr, cp), f, Q_h, cp.albedo, cp.eps_sigma,
                           cp.one_minus_emis, cp);
        o.Gg = fl.G;
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
        return o;
    }

    // land::ImplicitRates on the group: the tendencies with the top level's
    // Flux BCs in (0 on the slots above NZ), the centre thermal
    // conductivity, dT/dU (0 on the freeze plateau, else 1/C) and the Darcy
    // conductivity of the face below each level; the pool's and the
    // surface's rates, one copy a thread
    struct Rates {
        T U[N][L], sat[N][L], kap[N][L], Dh[N][L], Keff[N][L];
        T dS;
        SurfaceRates<T> surf;
    };

    // land::closure_rhs on the group into the implicit stepper's rates r:
    // the closure in place (sat, and s.S += spill), the tendencies and the
    // terms, the top level's Flux BCs in its right-hand sides (-G / dz on
    // the energy, +infiltration / dz on the saturation, the ET sink in its
    // Richards tendency)
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
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                if (level(i, l) != NZ - 1) continue;
                r.U[i][l] = r.U[i][l] - o.Gg / dz_top;
                const T sink = -o.Q_h * lc.water_flux_scale / dz_top;
                r.sat[i][l] = (dth_top + sink) / c.por;
                r.sat[i][l] = r.sat[i][l] - (T(-1) * o.infil) / dz_top;
            }
        }
    }

    // land::picard_step (Richards flow, no snowpack) on the group with
    // `iters` Picard iterations, operation for operation (iteration 0 that
    // of land::implicit_step): iteration 0 closes the column and a copy of
    // the surface carry, keeps the pool's spill and the closed start u^n;
    // each further iteration closes the iterate and a copy of the surface
    // carry as iteration 0 left it (the spill dropped) and solves with the
    // right-hand side tend(u_k) - (u_k - u^n) / dt; the pool, skin, canopy
    // water, carbon, vegetation fraction and net assimilation take
    // iteration 0's rates. One body serves every iteration (not unrolled).
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
            }
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
    // and skin temperature without) taken in rounds across the lanes (lane
    // j the used directions j, j + G, ...), one forward pass a direction,
    // each direction's cotangent read from its lane
    SOIL_FN void surface_adjoint(const T (&xv)[SI_N], const T (&gy)[SO_N], const bool below1,
                                 const Forcing<T>& f, T (&gx)[SI_N]) const {
        constexpr int USED = VEG ? SI_N : SI_N - 5;
        constexpr int R = (USED + G - 1) / G;
        // the m-th used direction: without vegetation TG, WTOP, KC, S, TS
        auto direction = [](int m) { return VEG ? m : (m < 2 ? m : m + 1); };
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
                    Dual<T> x[SI_N], y[SO_N];
#pragma unroll
                    for (int j = 0; j < SI_N; ++j) x[j] = Dual<T>(xv[j], j == d ? T(1) : T(0));
                    surface_block<T, VEG, true>(x, below1, f, lc, dz_top, y);
#pragma unroll
                    for (int o = 0; o < SO_N; ++o)
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
        for (int d = 0; d < SI_N; ++d) gx[d] = T(0);
#pragma unroll
        for (int m = 0; m < USED; ++m)
            gx[direction(m)] = lanes.from(m % G, [&](int i) { return acc[i][m / G]; });
    }

    // land::closure_rhs_adjoint (Richards flow, no snowpack, the implicit
    // terms' cotangents x) on the group: on entry gU, gs and gsc hold the
    // cotangents of what the stepper reads directly of the closed column and
    // surface carry, gfU and gfs those of the tendencies (the top level's
    // before its Flux BCs), gy those of the surface block's outputs (all
    // but SO_QH, which the ET sink adds here); on return gU, gs and gsc are
    // the cotangents of the step's input carry. Each lane's parameter
    // cotangents accumulate into gKsat[i] and gskm[i].
    SOIL_FN void rhs_adjoint(const T (&U)[N][L], const T (&sat)[N][L], const Surface<T>& s,
                             const Forcing<T>& f, T (&gU)[N][L], T (&gs)[N][L], Surface<T>& gsc,
                             const T (&gfU)[N][L], const T (&gfs)[N][L], T (&gy)[SO_N],
                             const TermCotangents& x, T (&gKsat)[N], T (&gskm)[N]) {
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
        this->darcy_adjoint(gfs, psi, FK, Kc, x.gKeff, gKf, gpsi, gKf_top);

        // ---- the surface block
        T gx[SI_N];
        {
            const T xv[SI_N] = {top_of(Tk), top_of(water), beta_paw, top_of(Kc), S1,
                                s.Ts, s.w, s.C, s.nu, s.An};
            surface_adjoint(xv, gy, top_of(ss) < T(1), f, gx);
        }
        const T gS1 = gsc.S + gx[SI_S];
        gsc.Ts = gsc.Ts + gx[SI_TS];
        gsc.w = gsc.w + gx[SI_W];
        gsc.C = gsc.C + gx[SI_C];
        gsc.nu = gsc.nu + gx[SI_NU];
        gsc.An = gsc.An + gx[SI_AN];

        // ---- face K from centre K; the heat flux of the interior faces
        T gKc[N][L], gT[N][L], gkap[N][L];
        this->centre_K_adjoint(Kc, gKf, gKf_top, gx[SI_KC], gKc);
        this->template heat_flux_adjoint<false>(gfU, Tk, kap, T(0), x.gkap, gx[SI_TG], gT, gkap);

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
                soil::level_adjoint<T, MUALEM, true, true>(
                    v, ss[i][l], U[i][l], gT[i][l], gkap[i][l], MUALEM ? gKc[i][l] : T(0),
                    x.gC[i][l], c, P, gsk, gUk, gKsat[i], gskm[i], gwx, gix, gax);
                gs[i][l] = gsk;
                gU[i][l] = gUk;
            }
        }

        // ---- the saturation adjustment in reverse (the spill's cotangent,
        // the closed pool's, enters at the top)
        gsc.S = gS1;
        this->sweeps_adjoint(bits, gs, gS1);
    }

    // land::picard_iter_adjoint (Richards flow, no snowpack) on the group:
    // cotangents through one iteration of picard_step at its iterate (U,
    // sat) before the iteration's closure, with the surface carry s it
    // reads; the closure, the tendencies, the terms and the rows recomputed
    // there, each system undone by one solve of its transposed rows
    // (soil::GroupColumn::systems_adjoint), then the surface's path (the
    // first iteration: the Euler updates of the surface, gsc the cotangents
    // of the surface after the step; a later one: its rows' ground heat flux
    // and infiltration alone, its inputs' cotangents added to gsc) and the
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
        T gy[SO_N];
        gy[SO_QH] = T(0);
        gy[SO_G] = -top_of(gfU) / dz_top;
        gy[SO_INFIL] = top_of(gfs) / dz_top;
        Surface<T> gk{};
        if (later) {
#pragma unroll
            for (int o = SO_POOL; o < SO_N; ++o) gy[o] = T(0);
        } else {
            surface_update_adjoint<T, VEG, true>(gsc, gy, dt);
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
    // iterations read is the start's sweeps.
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
            picard_iter_adjoint<SOLVER>(xU, xs, xsurf, f, it > 0, U, sn, gU, gs, gsc, gUn, gsn,
                                        gKsat, gskm, dt, inv_dt);
        }
    }

    // land::segment_vjp_column of picard_step (SOLVER, `iters` Picard
    // iterations) on the group, with static inputs f: `steps` steps from the
    // carry (U, sat, s), each step's input carry stored to `scratch` where
    // `store` (land::ScratchRows rows a step, laid out [step][row][cell]:
    // U[0 .. NZ), sat[0 .. NZ), then the pool, skin temperature, canopy
    // water, carbon, vegetation fraction and net assimilation, each lane its
    // levels', lane 0 the surface's); then the reverse sweep of
    // picard_step_adjoint from the output cotangents (gU, gs, gsc), which
    // become the input carry's. A group that does not store (beyond the last
    // column) recomputes from its own carry, and its results are not used.
    template <int SOLVER>
    SOIL_FN void segment_vjp(T (&U)[N][L], T (&sat)[N][L], Surface<T>& s, T (&gU)[N][L],
                             T (&gs)[N][L], Surface<T>& gsc, T* scratch, const long long col,
                             const long long cells, const bool store, const Forcing<T>& f,
                             const int steps, const T dt, const T inv_dt, const int iters,
                             T (&gKsat)[N], T (&gskm)[N]) {
        constexpr long long ROWS = ScratchRows<NZ>::value;
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
                    }
                }
            }
            picard_step<SOLVER>(U, sat, s, f, dt, inv_dt, iters);
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
            }
            picard_step_adjoint<SOLVER>(U, sat, s, f, gU, gs, gsc, gKsat, gskm, dt, inv_dt,
                                        iters);
        }
    }
};

}  // namespace land
