// One closure-rotated soil step (ForwardEuler, Heun or ImplicitEuler with
// any number of Picard iterations, heat + Richards) of a column spread over
// a group of G lanes.
//
// soil_step.cuh runs a column on one thread with its NZ levels unrolled in
// registers. Here the column's levels are spread over G lanes (a power of
// two, at most 32; template G), L = ceil(NZ / G) consecutive levels a
// lane, bottom first: lane j holds levels jL ... jL + L - 1 (those below
// NZ). Each level's physics is soil_step.cuh's (Level, Head, vmin, vmax)
// and each value is formed by the same operations in the same order as
// closure_rhs forms it, so that a host build of this step equals the
// per-thread step's bit for bit (tests/test_torch_group_step_host.py).
// Neighbours within a lane are read from its registers, neighbours across
// lanes through the group's shuffles:
//
// * saturation adjustment: each lane runs the up sweep over its own levels
//   from a zero carry, which is exactly the sequential sweep wherever the
//   carry entering the lane is 0 (sk + 0 / dz == sk, and the carry is never
//   -0). A ballot finds the lanes whose outgoing carry is not 0; only then
//   is the carry handed to the next lane, which runs its levels again from
//   it, lane by lane in order (a hand-off). The down sweep likewise, from
//   the top. The spill is the carry out of the top lane; the water table
//   a ballot of the lanes with a level below saturation.
// * heat flux: the face below each level takes T and kappa of the level
//   below (shuffle up), the tendency the flux of the face above (shuffle
//   down); the lane of level NZ - 1 applies the Dirichlet ghost.
// * Darcy flux: the head and the face conductivities below each level
//   across lanes the same way; the upwind-min face K of face k reads the
//   face K of faces k - 1, k and k + 1 (centre K of levels k - 2 ... k + 1).
// * implicit rows (soil::diffusion_rows): row k reads the face terms and
//   the chain factor of levels k - 1 and k + 1 across lanes the same way.
// * PCR (soil::pcr): each round of stride s, row k reads rows k - s and
//   k + s from its own registers or from the lane ceil(s / L) or
//   floor(s / L) away, with soil::pcr_rounds' predicates and order, so the
//   slots above NZ take no part; then x = d / b in each lane.
// * Thomas (soil::thomas): the forward sweep hands (c', d') from lane to
//   lane, lowest first, each lane running its L rows from what it
//   receives; the back substitution hands x down the same way. One lane of
//   a group works at a time, so Thomas favours few lanes of many levels.
//
// The group's exchange is a Lanes type: WarpLanes, one thread a lane and
// the warp's shuffles and ballots (device), or HostLanes, the G lanes held
// by one host thread in lockstep, each exchange a loop over them (the host
// emulation the CPU tests build). Per-lane values are arrays [Lanes::N][L]:
// N = 1 on the card, G on the host.

#pragma once

#include "soil_step.cuh"

namespace soil {

// The group size for a column of nz levels. A launch costs about the same
// per lane-slot (G L) and step whatever G is (an H100 80GB HBM3 at 700 W,
// rollout_layout_ab.py, PERF.md section 6), so the fewest slots win:
// above 20 levels 32 lanes (NZ 30: L 1, 30 of 32 slots busy); at 20 and
// below 4 lanes (NZ 20: L 5, every slot busy, 1.40x faster than G 32; NZ
// 15: L 4, 1.02x faster than G 16, as many slots)
#if defined(__CUDACC__)
__host__ __device__
#endif
constexpr int group_lanes(int nz) { return nz > 20 ? 32 : 4; }

// The group size of the implicit step (picard_step) for a column of nz
// levels and its solver (SOLVER_THOMAS or SOLVER_PCR), measured at Nz 30
// on an H100 80GB HBM3 at 700 W (rollout_layout_ab.py implicit_time,
// PERF.md section 6): PCR as the explicit steps (group_lanes; G 32 32.87
// ms per 144 steps, G 16 32.80, G 8 33.72, G 4 39.27), its rounds as
// parallel as the rest of the step; Thomas, whose sweeps run one lane of a
// group at a time, 8 lanes above 20 levels (G 8 25.15 ms, G 4 30.35, G 16
// 33.15, G 32 53.19: fewer lanes wait less, more lanes spill less) and 4
// at 20 and below, as group_lanes
#if defined(__CUDACC__)
__host__ __device__
#endif
constexpr int implicit_group_lanes(int nz, int solver) {
    return solver == SOLVER_THOMAS ? (nz > 20 ? 8 : 4) : group_lanes(nz);
}

#if defined(__CUDACC__)
// G consecutive lanes of a warp, one thread each; every thread of the warp
// takes part in every exchange (full mask)
template <int G>
struct WarpLanes {
    static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0, "G is a power of two <= 32");
    static constexpr int N = 1;
    static constexpr unsigned FULL = 0xffffffffu;
    int id;        // lane within the group
    int shift;     // the group's first lane within the warp
    __device__ WarpLanes() : id(threadIdx.x & (G - 1)), shift((threadIdx.x & 31) & ~(G - 1)) {}
    __device__ int lane(int) const { return id; }
    // f(i): this lane's value; the value of lane id - d (own below lane d)
    template <class F>
    __device__ auto up(int, F f, int d = 1) const { return __shfl_up_sync(FULL, f(0), d, G); }
    // the value of lane id + d (own above lane G - 1 - d)
    template <class F>
    __device__ auto down(int, F f, int d = 1) const {
        return __shfl_down_sync(FULL, f(0), d, G);
    }
    // the value of lane src
    template <class F>
    __device__ auto from(int src, F f) const { return __shfl_sync(FULL, f(0), src, G); }
    // bit j: p of lane j
    template <class F>
    __device__ unsigned ballot(F p) const {
        const unsigned b = __ballot_sync(FULL, p(0));
        return G == 32 ? b : (b >> shift) & ((1u << G) - 1u);
    }
    // whether x holds on any lane of the warp: the groups of a warp leave
    // a loop of exchanges together
    __device__ bool any(bool x) const { return __any_sync(FULL, x); }
    static __device__ int lowest(unsigned m) { return __ffs(m) - 1; }
    static __device__ int highest(unsigned m) { return 31 - __clz(m); }
};
#endif

// The G lanes of a group held by one thread (the host emulation): lane i's
// values at index i of each per-lane array, each exchange a loop over the
// lanes, which therefore run in lockstep between exchanges
template <int G>
struct HostLanes {
    static constexpr int N = G;
    int lane(int i) const { return i; }
    template <class F>
    auto up(int i, F f, int d = 1) const { return f(i - d >= 0 ? i - d : i); }
    template <class F>
    auto down(int i, F f, int d = 1) const { return f(i + d < G ? i + d : i); }
    template <class F>
    auto from(int src, F f) const { return f(src); }
    template <class F>
    unsigned ballot(F p) const {
        unsigned b = 0u;
        for (int i = 0; i < G; ++i)
            if (p(i)) b |= 1u << i;
        return b;
    }
    bool any(bool x) const { return x; }
    static int lowest(unsigned m) { return __builtin_ctz(m); }
    static int highest(unsigned m) { return 31 - __builtin_clz(m); }
};

// A column on a group: its coordinates in each lane's registers, the
// closure and tendencies (rhs) and the three steps
template <typename T, int NZ, int G, class Lanes>
struct GroupColumn {
    static constexpr int L = (NZ + G - 1) / G;  // levels a lane
    static constexpr int N = Lanes::N;          // lanes this thread holds
    static constexpr int TOP = (NZ - 1) / L;    // the lane of level NZ - 1
    const Lanes& lanes;
    const Consts<T>& c;
    const SoilColumnParams& P;
    T dz[N][L], dzf[N][L], zc[N][L], zf[N][L];  // of each lane's levels
    T dzfa[N][L];                               // dzf of the face above each level
    T dzf_top, zf_top;                          // of the surface face
    unsigned up_handoffs = 0u, down_handoffs = 0u;

    SOIL_FN GroupColumn(const Lanes& lanes_, const Consts<T>& c_, const SoilColumnParams& P_,
                        const T* dz_g, const T* dzf_g, const T* zc_g, const T* zf_g)
        : lanes(lanes_), c(c_), P(P_), dzf_top(dzf_g[NZ]), zf_top(zf_g[NZ])
    {
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l) < NZ ? level(i, l) : NZ - 1;
                dz[i][l] = dz_g[k];
                dzf[i][l] = dzf_g[k];
                dzfa[i][l] = dzf_g[k + 1];
                zc[i][l] = zc_g[k];
                zf[i][l] = zf_g[k];
            }
        }
    }

    SOIL_FN int level(int i, int l) const { return lanes.lane(i) * L + l; }

    // v of the level s above slot l of lane i's (s < 0: below), from this
    // lane's registers or from the lane the level lies on (s and l are
    // constants after unrolling); another lane's value is taken by every
    // lane of the warp, and a level beyond the group reads this lane's own
    SOIL_FN T at(int i, int l, int s, const T (&v)[N][L]) const {
        const int m = l + s;
        const int q = m >= 0 ? m / L : -((L - 1 - m) / L);  // floor(m / L)
        const int r = m - q * L;
        if (q == 0) return v[i][r];
        if (q < 0) return lanes.up(i, [&](int j) { return v[j][r]; }, -q);
        return lanes.down(i, [&](int j) { return v[j][r]; }, q);
    }

    // the up sweep over lane i's levels from their saturations s0 and the
    // carry cc entering the lane; returns the carry leaving it
    SOIL_FN T up_levels(int i, T (&sat)[N][L], const T (&s0)[N][L], T cc) const {
#pragma unroll
        for (int l = 0; l < L; ++l) {
            if (level(i, l) < NZ) {
                const T sk = s0[i][l];
                const T x = sk + cc / dz[i][l];
                sat[i][l] = vmin(x, T(1));
                cc = vmax((sk - T(1)) * dz[i][l] + cc, T(0));
            }
        }
        return cc;
    }

    // the down sweep over lane i's levels, from the top
    SOIL_FN T down_levels(int i, T (&sat)[N][L], const T (&s0)[N][L], T c2) const {
#pragma unroll
        for (int l = L - 1; l >= 0; --l) {
            if (level(i, l) < NZ) {
                const T su = s0[i][l];
                const T y = su - c2 / dz[i][l];
                sat[i][l] = vmax(y, T(0));
                c2 = vmax(-su * dz[i][l] + c2, T(0));
            }
        }
        return c2;
    }

    // soil::sweeps on the group: the saturation adjustment in place, the
    // spill added to S, and the water table
    SOIL_FN void sweeps(T (&sat)[N][L], T& S, T& wt) {
        T s0[N][L], cc[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) s0[i][l] = sat[i][l];
            cc[i] = up_levels(i, sat, s0, T(0));
        }
        // hand each non-zero carry to the next lane, lowest first, until no
        // lane below the top one sends a carry that its successor has not
        // run (every lane of the warp takes part in each exchange)
        for (int j = -1;;) {
            const unsigned m = lanes.ballot([&](int i) {
                const int ln = lanes.lane(i);
                return ln > j && ln < TOP && cc[i] != T(0);
            });
            if (!lanes.any(m != 0u)) break;
            if (m) j = Lanes::lowest(m);
            const T cin = lanes.from(m ? j : 0, [&](int i) { return cc[i]; });
            if (!m) continue;
#pragma unroll
            for (int i = 0; i < N; ++i)
                if (lanes.lane(i) == j + 1) cc[i] = up_levels(i, sat, s0, cin);
            ++up_handoffs;
        }
        S = S + lanes.from(TOP, [&](int i) { return cc[i]; });

#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) s0[i][l] = sat[i][l];
            cc[i] = down_levels(i, sat, s0, T(0));
        }
        for (int j = G;;) {
            const unsigned m = lanes.ballot([&](int i) {
                const int ln = lanes.lane(i);
                return ln < j && ln > 0 && ln <= TOP && cc[i] != T(0);
            });
            if (!lanes.any(m != 0u)) break;
            if (m) j = Lanes::highest(m);
            const T cin = lanes.from(m ? j : 0, [&](int i) { return cc[i]; });
            if (!m) continue;
#pragma unroll
            for (int i = 0; i < N; ++i)
                if (lanes.lane(i) == j - 1) cc[i] = down_levels(i, sat, s0, cin);
            ++down_handoffs;
        }

        // the water table: the face below the lowest level with sat < 1
        const unsigned m = lanes.ballot([&](int i) {
            bool any = false;
#pragma unroll
            for (int l = 0; l < L; ++l) any = any || (level(i, l) < NZ && sat[i][l] < T(1));
            return any;
        });
        const T z = lanes.from(m ? Lanes::lowest(m) : 0, [&](int i) {
            T zl = zf_top;
#pragma unroll
            for (int l = L - 1; l >= 0; --l)
                if (level(i, l) < NZ && sat[i][l] < T(1)) zl = zf[i][l];
            return zl;
        });
        wt = m ? z : zf_top;
    }

    // closure_rhs on the group: the closure of (U, sat, S) with top
    // temperature vtop (sat and S adjusted in place), each tendency to
    // out.energy(i, l, f), out.water(i, l, f) and out.pool(f); where
    // Out::TERMS (the implicit sink), also each level's closure,
    // out.level(i, l, U, Level), and the Darcy conductivity of the face
    // below it, out.darcy_face(i, l, K_eff)
    template <class Out>
    SOIL_FN void rhs(const T (&U)[N][L], T (&sat)[N][L], T& S, const T vtop, Out& out) {
        T wt;
        sweeps(sat, S, wt);

        // energy closure, centre conductivities, heat flux
        T Tk[N][L], kap[N][L], Kc[N][L];
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const Level<T, true> v(sat[i][l], U[i][l], c, P);
                if constexpr (Out::TERMS) out.level(i, l, U[i][l], v);
                Tk[i][l] = v.Tk;
                kap[i][l] = v.kap;
                Kc[i][l] = v.Kc;
            }
        }
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
                if (k >= NZ) continue;
                T hi;
                if (k == NZ - 1) {  // top face: Dirichlet ghost 2*v - T_top
                    const T ghost = T(2) * vtop - Tk[i][l];
                    const T kf = T(0.5) * (kap[i][l] + kap[i][l]);
                    hi = -kf * ((ghost - Tk[i][l]) / dzf_top);
                } else {
                    hi = l + 1 < L ? qh[i][l + 1] : qh_above;
                }
                out.energy(i, l, -((hi - qh[i][l]) / dz[i][l]));
            }
        }

        // pressure head, Darcy flux with upwind-min face K
        T psi[N][L], FK[N][L];
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const T Kc_below = lanes.up(i, [&](int j) { return Kc[j][L - 1]; });
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                psi[i][l] = Head<T>(sat[i][l], wt, zc[i][l], c, P).psi;
                // face_K(k): the bottom face and the top two take their
                // level's centre K, the others the min of the two sides
                FK[i][l] = (k == 0 || k >= NZ - 1)
                               ? Kc[i][l] : vmin(l > 0 ? Kc[i][l - 1] : Kc_below, Kc[i][l]);
            }
        }
        T qw[N][L];
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
                if constexpr (Out::TERMS) out.darcy_face(i, l, K_eff);
                qw[i][l] = -K_eff * grad;
            }
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const T qw_above = lanes.down(i, [&](int j) { return qw[j][0]; });
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                if (k >= NZ) continue;
                T hi;
                if (k == NZ - 1) {  // top face: zero-gradient ghost
                    const T psi_k = psi[i][l];
                    const T grad = (psi_k - psi_k) / dzf_top;
                    const T K_lo = FK[i][l];
                    const T K_k = Kc[i][l];
                    const T K_eff = grad < T(0) ? vmin(K_lo, K_k) : vmin(K_k, T(INFINITY));
                    hi = -K_eff * grad;
                } else {
                    hi = l + 1 < L ? qw[i][l + 1] : qw_above;
                }
                out.water(i, l, (-((hi - qw[i][l]) / dz[i][l])) / c.por);
            }
        }
        out.pool(vmin(T(0), S));  // parity surface-pool term +min(0, S)
    }

    // ForwardEuler's update x + f * dt
    struct EulerUpdate {
        static constexpr bool TERMS = false;
        T (&U)[N][L];
        T (&sat)[N][L];
        T& S;
        const T dt;
        SOIL_FN void energy(int i, int l, T f) { U[i][l] = U[i][l] + f * dt; }
        SOIL_FN void water(int i, int l, T f) { sat[i][l] = sat[i][l] + f * dt; }
        SOIL_FN void pool(T f) { S = S + f * dt; }
    };

    // the tendencies of Heun's first stage, kept (0 on the slots above NZ)
    struct Tendencies {
        static constexpr bool TERMS = false;
        T U[N][L] = {}, sat[N][L] = {}, S = T(0);
        SOIL_FN void energy(int i, int l, T f) { U[i][l] = f; }
        SOIL_FN void water(int i, int l, T f) { sat[i][l] = f; }
        SOIL_FN void pool(T f) { S = f; }
    };

    // Heun's corrector x + (0.5 * (f_n + f*)) * dt
    struct HeunUpdate {
        static constexpr bool TERMS = false;
        T (&U)[N][L];
        T (&sat)[N][L];
        T& S;
        const Tendencies& f;
        const T dt;
        SOIL_FN void energy(int i, int l, T g) { U[i][l] = U[i][l] + (T(0.5) * (f.U[i][l] + g)) * dt; }
        SOIL_FN void water(int i, int l, T g) {
            sat[i][l] = sat[i][l] + (T(0.5) * (f.sat[i][l] + g)) * dt;
        }
        SOIL_FN void pool(T g) { S = S + (T(0.5) * (f.S + g)) * dt; }
    };

    // soil::step: one ForwardEuler.pre_closure_step in place
    SOIL_FN void step(T (&U)[N][L], T (&sat)[N][L], T& S, const T vtop, const T dt) {
        EulerUpdate out{U, sat, S, dt};
        rhs(U, sat, S, vtop, out);
    }

    // soil::heun_step: one Heun.pre_closure_step in place, its stage and
    // first tendencies held in each lane (about 7 L values)
    SOIL_FN void heun_step(T (&U)[N][L], T (&sat)[N][L], T& S, const T v0, const T v1,
                           const T dt) {
        Tendencies f;
        rhs(U, sat, S, v0, f);
        T yU[N][L], ys[N][L];
        T yS = S + f.S * dt;
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                yU[i][l] = U[i][l] + f.U[i][l] * dt;
                ys[i][l] = sat[i][l] + f.sat[i][l] * dt;
            }
        }
        HeunUpdate out{U, sat, S, f, dt};
        rhs(yU, ys, yS, v1, out);
    }


    // soil::ImplicitTerms on the group: the tendencies and, per lane slot,
    // the centre thermal conductivity, dT/dU (0 on the freeze plateau, else
    // 1/C) and the Darcy conductivity of the face below the level (0 on the
    // slots above NZ)
    struct ImplicitTerms : Tendencies {
        static constexpr bool TERMS = true;
        T kap[N][L] = {}, Dh[N][L] = {}, Keff[N][L] = {};
        SOIL_FN void level(int i, int l, T Uk, const Level<T, true>& v) {
            kap[i][l] = v.kap;
            Dh[i][l] = (Uk >= v.negL && Uk < T(0)) ? T(0) : T(1) / v.C;
        }
        SOIL_FN void darcy_face(int i, int l, T K) { Keff[i][l] = K; }
    };

    // soil::diffusion_rows on the group: the rows (a, b, c) of face
    // conductivities Kf (the face below each level; Kf_top the surface
    // face's), chain factor D and scale s, the Dirichlet top's term on the
    // lane of level NZ - 1 where `dirichlet`. The slots above NZ take the
    // identity row (b = 1), whose right-hand side is 0.
    SOIL_FN void rows(const T (&Kf)[N][L], const T Kf_top, const T (&D)[N][L], const T s,
                      const T inv_dt, const bool dirichlet, T (&a)[N][L], T (&b)[N][L],
                      T (&c)[N][L]) const {
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                const T D_lo = at(i, l, -1, D), D_hi = at(i, l, 1, D);
                const T Kf_up = at(i, l, 1, Kf);
                const T Kf_hi = k == NZ - 1 ? Kf_top : Kf_up;
                if (k >= NZ) {
                    a[i][l] = T(0);
                    b[i][l] = T(1);
                    c[i][l] = T(0);
                    continue;
                }
                const T sKlo = s * Kf[i][l], sKhi = s * Kf_hi;
                const T lo = dzf[i][l] * dz[i][l], hi = dzfa[i][l] * dz[i][l];
                a[i][l] = k == 0 ? T(0) : -((sKlo * D_lo) / lo);
                c[i][l] = k == NZ - 1 ? T(0) : -((sKhi * D_hi) / hi);
                const T diag_lo = k == 0 ? T(0) : (sKlo * D[i][l]) / lo;
                const T diag_hi = k == NZ - 1 ? T(0) : (sKhi * D[i][l]) / hi;
                b[i][l] = (inv_dt + diag_lo) + diag_hi;
                if (dirichlet && k == NZ - 1)
                    b[i][l] = b[i][l] + ((T(2) * s * Kf_hi) * D[i][l]) / (dzfa[i][l] * dz[i][l]);
            }
        }
    }

    // soil::pcr_rounds on the group: the round of stride S and those after
    template <int S>
    SOIL_FN void pcr_rounds(T (&a)[N][L], T (&b)[N][L], T (&c)[N][L], T (&d)[N][L]) const {
        if constexpr (S < NZ) {
            T an[N][L], bn[N][L], cn[N][L], dn[N][L];
#pragma unroll
            for (int i = 0; i < N; ++i) {
#pragma unroll
                for (int l = 0; l < L; ++l) {
                    const int k = level(i, l);
                    const bool lo = k - S >= 0, hi = k + S < NZ;
                    // rows k - S and k + S (every lane takes part in each exchange)
                    const T a_l = at(i, l, -S, a), b_l = at(i, l, -S, b);
                    const T c_l = at(i, l, -S, c), d_l = at(i, l, -S, d);
                    const T a_h = at(i, l, S, a), b_h = at(i, l, S, b);
                    const T c_h = at(i, l, S, c), d_h = at(i, l, S, d);
                    const T alpha = lo ? -a[i][l] / b_l : -a[i][l];
                    const T gamma = hi ? -c[i][l] / b_h : -c[i][l];
                    T bk = b[i][l], dk = d[i][l];
                    if (lo) { bk = bk + alpha * c_l; dk = dk + alpha * d_l; }
                    if (hi) { bk = bk + gamma * a_h; dk = dk + gamma * d_h; }
                    bn[i][l] = bk;
                    dn[i][l] = dk;
                    an[i][l] = lo ? alpha * a_l : T(0);
                    cn[i][l] = hi ? gamma * c_h : T(0);
                }
            }
#pragma unroll
            for (int i = 0; i < N; ++i) {
#pragma unroll
                for (int l = 0; l < L; ++l) {
                    a[i][l] = an[i][l];
                    b[i][l] = bn[i][l];
                    c[i][l] = cn[i][l];
                    d[i][l] = dn[i][l];
                }
            }
            pcr_rounds<2 * S>(a, b, c, d);
        }
    }

    // soil::thomas on the group, d becoming x: lane j sweeps its rows
    // forward from the (c', d') that lane j - 1 handed it, lanes 0 ... TOP
    // in turn, then back from the x that lane j + 1 handed it, TOP ... 0
    SOIL_FN void thomas(const T (&a)[N][L], const T (&b)[N][L], const T (&c)[N][L],
                        T (&d)[N][L]) const {
        T cp[N][L], c_in[N] = {}, d_in[N] = {}, c_out[N] = {}, d_out[N] = {};
#pragma unroll
        for (int j = 0; j <= TOP; ++j) {
#pragma unroll
            for (int i = 0; i < N; ++i) {
                if (lanes.lane(i) != j) continue;
                T c_prev = c_in[i], d_prev = d_in[i];
#pragma unroll
                for (int l = 0; l < L; ++l) {
                    const int k = level(i, l);
                    if (k >= NZ) continue;
                    const T a_k = k == 0 ? T(0) : a[i][l];
                    const T denom = b[i][l] - a_k * c_prev;
                    c_prev = c[i][l] / denom;
                    d_prev = (d[i][l] - a_k * d_prev) / denom;
                    cp[i][l] = c_prev;
                    d[i][l] = d_prev;
                }
                c_out[i] = c_prev;
                d_out[i] = d_prev;
            }
            if (j == TOP) break;
#pragma unroll
            for (int i = 0; i < N; ++i) {
                c_in[i] = lanes.up(i, [&](int m) { return c_out[m]; });
                d_in[i] = lanes.up(i, [&](int m) { return d_out[m]; });
            }
        }
        T x_in[N] = {}, x_out[N] = {};
#pragma unroll
        for (int j = TOP; j >= 0; --j) {
#pragma unroll
            for (int i = 0; i < N; ++i) {
                if (lanes.lane(i) != j) continue;
                T x = x_in[i];
#pragma unroll
                for (int l = L - 1; l >= 0; --l) {
                    if (level(i, l) >= NZ) continue;
                    x = d[i][l] - cp[i][l] * x;
                    d[i][l] = x;
                }
                x_out[i] = x;
            }
            if (j == 0) break;
#pragma unroll
            for (int i = 0; i < N; ++i) x_in[i] = lanes.down(i, [&](int m) { return x_out[m]; });
        }
    }

    // soil::solve on the group: d becomes x; a, b and c are spent
    template <int SOLVER>
    SOIL_FN void solve(T (&a)[N][L], T (&b)[N][L], T (&c)[N][L], T (&d)[N][L]) const {
        static_assert(SOLVER == SOLVER_PCR || SOLVER == SOLVER_THOMAS,
                      "the group step is built for one solver");
        if constexpr (SOLVER == SOLVER_PCR) {
            pcr_rounds<1>(a, b, c, d);
#pragma unroll
            for (int i = 0; i < N; ++i) {
#pragma unroll
                for (int l = 0; l < L; ++l) d[i][l] = d[i][l] / b[i][l];
            }
        } else {
            thomas(a, b, c, d);
        }
    }

    // soil::implicit_solves on the group (heat + Richards, the Dirichlet
    // top): the heat rows (the face kappa the arithmetic mean with the level
    // below, zero-gradient ends; dT/dU; scale 1) and their solve, U += du;
    // the Richards rows (the Darcy face K, d(Psi)/d(sat) at sat, scale
    // 1/por) and their solve, sat += du; one set of rows live at a time
    template <int SOLVER>
    SOIL_FN void implicit_solves(ImplicitTerms& f, T (&U)[N][L], T (&sat)[N][L],
                                 const T inv_dt) const {
        T a[N][L], b[N][L], cc[N][L];
        {
            T Kf[N][L];
            T Kf_top = T(0);
#pragma unroll
            for (int i = 0; i < N; ++i) {
#pragma unroll
                for (int l = 0; l < L; ++l) {
                    const int k = level(i, l);
                    const T kap_lo = at(i, l, -1, f.kap);
                    Kf[i][l] = T(0.5) * (f.kap[i][l] + (k == 0 ? f.kap[i][l] : kap_lo));
                    if (k == NZ - 1) Kf_top = T(0.5) * (f.kap[i][l] + f.kap[i][l]);
                }
            }
            rows(Kf, Kf_top, f.Dh, T(1), inv_dt, true, a, b, cc);
        }
        solve<SOLVER>(a, b, cc, f.U);
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l)
                if (level(i, l) < NZ) U[i][l] = U[i][l] + f.U[i][l];
        }
        {
            T D[N][L];
#pragma unroll
            for (int i = 0; i < N; ++i) {
#pragma unroll
                for (int l = 0; l < L; ++l) D[i][l] = water_chain<T>(sat[i][l], c, P);
            }
            rows(f.Keff, T(0), D, c.inv_por, inv_dt, false, a, b, cc);
        }
        solve<SOLVER>(a, b, cc, f.sat);
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l)
                if (level(i, l) < NZ) sat[i][l] = sat[i][l] + f.sat[i][l];
        }
    }

    // soil::picard_step (heat + Richards) on the group, operation for
    // operation: iteration 0 closes the column in place, keeps the pool's
    // spill and the closed start u^n; each further iteration closes the
    // iterate into a copy of the pool and solves with the right-hand side
    // tend(u_k) - (u_k - u^n) / dt; S takes iteration 0's min(0, S) dt.
    // One body serves every iteration (not unrolled); u^n stays live
    // across it.
    template <int SOLVER>
    SOIL_FN void picard_step(T (&U)[N][L], T (&sat)[N][L], T& S, const T vtop, const T dt,
                             const T inv_dt, const int iters) {
        T Un[N][L], sn[N][L];
#pragma unroll 1
        for (int it = 0; it < iters; ++it) {
            ImplicitTerms f;
            T Sk = S;
            rhs(U, sat, Sk, vtop, f);
            if (it == 0) {
                S = Sk;
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
                        f.U[i][l] = f.U[i][l] - (U[i][l] - Un[i][l]) / dt;
                        f.sat[i][l] = f.sat[i][l] - (sat[i][l] - sn[i][l]) / dt;
                    }
                }
            }
            implicit_solves<SOLVER>(f, U, sat, inv_dt);
            if (it == 0) S = S + f.S * dt;
        }
    }

    // soil::rollout_column of ForwardEuler (STEPPER_EULER), Heun
    // (STEPPER_HEUN) or ImplicitEuler (STEPPER_IMPLICIT: picard_step with
    // SOLVER, `iters` Picard iterations and inv_dt, 1 / dt as the host
    // rounds it): `steps` steps in place from clock time t, the top
    // temperature of clock time i top[i * step_stride] or, SERIES, the
    // series at `top` read at the clock time
    template <int STEPPER, bool SERIES, int SOLVER = SOLVER_PCR>
    SOIL_FN void rollout(T (&U)[N][L], T (&sat)[N][L], T& S, const T* top,
                         const long long step_stride, const int series_rows, const T t0,
                         const T dts, T t, const int steps, const T dt, const T inv_dt = T(0),
                         const int iters = 1) {
        for (int s = 0; s < steps; ++s) {
            if constexpr (STEPPER == STEPPER_HEUN) {
                const T t1 = t + dt;
                const T v0 = SERIES ? series_value(top, step_stride, series_rows, t0, dts, t)
                                    : top[s * step_stride];
                const T v1 = SERIES ? series_value(top, step_stride, series_rows, t0, dts, t1)
                                    : top[(s + 1) * step_stride];
                heun_step(U, sat, S, v0, v1, dt);
                t = t1;
            } else {
                const T vtop = SERIES ? series_value(top, step_stride, series_rows, t0, dts, t)
                                      : top[s * step_stride];
                if constexpr (STEPPER == STEPPER_IMPLICIT)
                    picard_step<SOLVER>(U, sat, S, vtop, dt, inv_dt, iters);
                else
                    step(U, sat, S, vtop, dt);
                if (SERIES) t = t + dt;
            }
        }
    }
};

}  // namespace soil
