// One closure-rotated soil step (ForwardEuler, Heun or ImplicitEuler with
// any number of Picard iterations, heat + Richards) of a column spread over
// a group of G lanes, and the segment VJP of ImplicitEuler on that group.
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
// The adjoints of the three steps (segment_vjp, the group segment-VJP
// kernel's column code) undo each step on the same group: each level
// gathers, across lanes, the faces' shares of the cotangents that
// soil_step.cuh's one-thread adjoint scatters, in that adjoint's order;
// the reverse sweeps carry their cotangent to the lanes that need it by a
// ballot and a shuffle; each solve's adjoint solves the transposed rows
// with the same solver; ForwardEuler and Heun take the closure's adjoint
// alone, without the implicit terms' cotangents.
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

// The group size of the segment VJP of STEPPER (and SOLVER) for a column
// of nz levels: the rollout's (group_lanes, implicit_group_lanes), so
// that the gradient's forward segments and the VJP's recompute run one
// code at one G. A gradient segment's forward plus VJP, measured at each
// G on an H100 80GB HBM3 at 700 W (rollout_layout_ab.py
// explicit_vjp_time, PERF.md section 6), keeps the rollout's G for
// ForwardEuler at Nz 20 (G 4 11.07 ms, G 8 11.65, G 32 13.08) and Heun at
// Nz 30 (G 32 31.35 ms, G 16 32.14, G 8 36.62)
#if defined(__CUDACC__)
__host__ __device__
#endif
constexpr int vjp_group_lanes(int nz, int stepper, int solver) {
    return stepper == STEPPER_IMPLICIT ? implicit_group_lanes(nz, solver) : group_lanes(nz);
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

    // the predicates of soil::sweeps that the adjoint follows, bit l of
    // lane i's words for its slot l: spilled (sat + c/dz >= 1 in the up
    // sweep) and clipped (sat_up - c2/dz <= 0 in the down sweep)
    struct SweepBits {
        unsigned spilled[N] = {}, clipped[N] = {};
    };

    // the up sweep over lane i's levels from their saturations s0 and the
    // carry cc entering the lane; returns the carry leaving it (BITS: each
    // level's predicate to bits.spilled, as this run of the lane takes it)
    template <bool BITS = false>
    SOIL_FN T up_levels(int i, T (&sat)[N][L], const T (&s0)[N][L], T cc, SweepBits& bits) const {
#pragma unroll
        for (int l = 0; l < L; ++l) {
            if (level(i, l) < NZ) {
                const T sk = s0[i][l];
                const T x = sk + cc / dz[i][l];
                if constexpr (BITS) {
                    if (x >= T(1)) bits.spilled[i] |= 1u << l;
                    else bits.spilled[i] &= ~(1u << l);
                }
                sat[i][l] = vmin(x, T(1));
                cc = vmax((sk - T(1)) * dz[i][l] + cc, T(0));
            }
        }
        return cc;
    }

    // the down sweep over lane i's levels, from the top
    template <bool BITS = false>
    SOIL_FN T down_levels(int i, T (&sat)[N][L], const T (&s0)[N][L], T c2,
                          SweepBits& bits) const {
#pragma unroll
        for (int l = L - 1; l >= 0; --l) {
            if (level(i, l) < NZ) {
                const T su = s0[i][l];
                const T y = su - c2 / dz[i][l];
                if constexpr (BITS) {
                    if (y <= T(0)) bits.clipped[i] |= 1u << l;
                    else bits.clipped[i] &= ~(1u << l);
                }
                sat[i][l] = vmax(y, T(0));
                c2 = vmax(-su * dz[i][l] + c2, T(0));
            }
        }
        return c2;
    }

    // soil::sweeps on the group: the saturation adjustment in place, the
    // spill added to S, and the water table; BITS: the predicates to bits
    template <bool BITS = false>
    SOIL_FN void sweeps(T (&sat)[N][L], T& S, T& wt, SweepBits& bits) {
        T s0[N][L], cc[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) s0[i][l] = sat[i][l];
            cc[i] = up_levels<BITS>(i, sat, s0, T(0), bits);
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
                if (lanes.lane(i) == j + 1) cc[i] = up_levels<BITS>(i, sat, s0, cin, bits);
            ++up_handoffs;
        }
        S = S + lanes.from(TOP, [&](int i) { return cc[i]; });

#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) s0[i][l] = sat[i][l];
            cc[i] = down_levels<BITS>(i, sat, s0, T(0), bits);
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
                if (lanes.lane(i) == j - 1) cc[i] = down_levels<BITS>(i, sat, s0, cin, bits);
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

    SOIL_FN void sweeps(T (&sat)[N][L], T& S, T& wt) {
        SweepBits unused;
        sweeps<false>(sat, S, wt, unused);
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

    // the heat rows' face conductivities: the face below each level the
    // arithmetic mean of kappa with the level below (the bottom face's its
    // level's), Kf_top the surface face's, its top level's
    SOIL_FN void heat_faces(const T (&kap)[N][L], T (&Kf)[N][L], T& Kf_top) const {
        Kf_top = T(0);
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                const T kap_lo = at(i, l, -1, kap);
                Kf[i][l] = T(0.5) * (kap[i][l] + (k == 0 ? kap[i][l] : kap_lo));
                if (k == NZ - 1) Kf_top = T(0.5) * (kap[i][l] + kap[i][l]);
            }
        }
    }

    // soil::implicit_solves on the group from the terms f (ImplicitTerms, or
    // the land column's): the heat rows (the face kappa the arithmetic mean
    // with the level below, zero-gradient ends; dT/dU; scale 1; DIRICHLET:
    // the Dirichlet top's term) and their solve, U += du; the Richards rows
    // (the Darcy face K, the curve's d(Psi)/d(sat) at sat, chain(sat), scale
    // 1/por) and their solve, sat += du; one set of rows live at a time
    template <int SOLVER, bool DIRICHLET, class F, class Chain>
    SOIL_FN void implicit_solves(F& f, T (&U)[N][L], T (&sat)[N][L], const T inv_dt,
                                 const Chain& chain) const {
        T a[N][L], b[N][L], cc[N][L];
        {
            T Kf[N][L], Kf_top;
            heat_faces(f.kap, Kf, Kf_top);
            rows(Kf, Kf_top, f.Dh, T(1), inv_dt, DIRICHLET, a, b, cc);
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
                for (int l = 0; l < L; ++l) D[i][l] = chain(sat[i][l]);
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
            implicit_solves<SOLVER, true>(f, U, sat, inv_dt,
                                          [&](T sk) { return water_chain<T>(sk, c, P); });
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

    // ---------------------------------------------------------------------
    // adjoint: the segment VJP of ForwardEuler, Heun and ImplicitEuler (heat
    // + Richards, the Dirichlet top, any Picard count) on the group
    // ---------------------------------------------------------------------
    //
    // soil_step.cuh's adjoint (rhs_adjoint, step_adjoint, heun_step_adjoint,
    // solve_adjoint, diffusion_rows_adjoint, picard_iter_adjoint,
    // picard_step_adjoint) with
    // each value formed by the same operations in the same order. Where the
    // one-thread loop scatters a face's (or a row's) cotangent onto the
    // levels beside it, each level gathers the faces' shares, across lanes
    // by the shuffles, and adds them from 0 in the loop's order; a share the
    // loop does not add is not added (or is an exact 0, which leaves a sum
    // that is never -0 as it is). So a host build equals the one-thread
    // adjoint bit for bit (tests/test_torch_group_vjp_host.py). Every
    // exchange sits outside the predicates, and the slots above NZ take
    // part in no sum: their rows are identity rows with a zero right side,
    // their cotangents 0.

    // soil::TermCotangents on the group: the cotangents of ImplicitTerms'
    // centre thermal conductivity and heat capacity of each level and of
    // the Darcy conductivity of the face below it
    struct TermCotangents {
        static constexpr bool on = true;
        T gkap[N][L] = {}, gC[N][L] = {}, gKeff[N][L] = {};
    };

    // soil::NoTerms on the group: what ForwardEuler and Heun read of the
    // closure besides the closed column and the tendencies, nothing, so
    // their rhs_adjoint neither holds nor adds a terms' cotangent
    struct NoTermCotangents {
        static constexpr bool on = false;
    };

    // the face K of the face below each level from the centre K (face_K:
    // the bottom face and the top two take their level's centre K, the
    // others the min of the two sides)
    SOIL_FN void face_Ks(const T (&Kc)[N][L], T (&FK)[N][L]) const {
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                const T Kc_lo = at(i, l, -1, Kc);
                FK[i][l] = (k == 0 || k >= NZ - 1) ? Kc[i][l] : vmin(Kc_lo, Kc[i][l]);
            }
        }
    }

    // The Darcy flux of the interior faces f = 1 ... NZ - 1 in reverse,
    // from the water tendencies' cotangents gfs (the tendency of level k
    // (-((qw[k+1] - qw[k]) / dz[k])) / por, the top face carrying no flux)
    // and, where X::on, those of the faces' Darcy conductivities x.gKeff
    // (the implicit rows'): face f, on the slot of level f, forms its shares of the face
    // K's cotangents and of the heads'; each face K then gathers its
    // shares from faces f - 1, f and f + 1 in turn into gKf (the face below
    // each level; gKf_top the surface face's, from face NZ - 1 alone), each
    // head from faces k and k + 1 into gpsi.
    template <class X>
    SOIL_FN void darcy_adjoint(const T (&gfs)[N][L], const T (&psi)[N][L], const T (&FK)[N][L],
                               const T (&Kc)[N][L], const X& x, T (&gKf)[N][L],
                               T (&gpsi)[N][L], T& gKf_top) const {
        // face f's shares of gKf[f - 1], gKf[f], gKf[f + 1] (kl, km, kh)
        // and of the heads (pg, + to psi[f], - to psi[f - 1])
        T kl[N][L], km[N][L], kh[N][L], pg[N][L];
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                const T gfs_lo = at(i, l, -1, gfs), dz_lo = at(i, l, -1, dz);
                const T psi_lo = at(i, l, -1, psi), FK_lo = at(i, l, -1, FK);
                const T FK_hi = at(i, l, 1, FK);
                kl[i][l] = km[i][l] = kh[i][l] = pg[i][l] = T(0);
                if (k < 1 || k >= NZ) continue;
                const T glo = -(gfs_lo / c.por) / dz_lo;
                const T ghi = -(gfs[i][l] / c.por) / dz[i][l];
                const T gqw = glo - ghi;
                const T grad = (psi[i][l] - psi_lo) / dzf[i][l];
                const T K_f = FK[i][l];
                const T K_lo = FK_lo;
                const T K_hi = k == NZ - 1 ? Kc[i][l] : FK_hi;
                const T K_eff = grad < T(0) ? vmin(K_lo, K_f) : vmin(K_f, K_hi);
                T gK = -gqw * grad;
                if constexpr (X::on) gK = gK + x.gKeff[i][l];
                const T ggrad = -gqw * K_eff;
                if (grad < T(0)) min_adjoint(K_lo, K_f, gK, kl[i][l], km[i][l]);
                else min_adjoint(K_f, K_hi, gK, km[i][l], kh[i][l]);
                pg[i][l] = ggrad / dzf[i][l];
            }
        }
        gKf_top = T(0);
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                const T kh_lo = at(i, l, -1, kh), kl_hi = at(i, l, 1, kl);
                const T pg_hi = at(i, l, 1, pg);
                T g = T(0), gp = T(0);
                if (k >= 2 && k <= NZ - 1) g += kh_lo;
                if (k >= 1 && k <= NZ - 1) {
                    g += km[i][l];
                    gp += pg[i][l];
                }
                if (k <= NZ - 2) {
                    g += kl_hi;
                    gp -= pg_hi;
                }
                gKf[i][l] = g;
                gpsi[i][l] = gp;
                if (k == NZ - 1) gKf_top = T(0) + kh[i][l];
            }
        }
    }

    // The face K from the centre K in reverse: gKc[0] gathers gKf[0]; faces
    // 1 ... NZ - 2 split theirs between the levels either side (el below, em
    // at the face's own), each level taking face k's share, then face k +
    // 1's; the top level takes `top` (what reads its centre K besides the
    // faces: the land's infiltration, 0 for the soil), then gKf[NZ - 1] +
    // gKf_top.
    SOIL_FN void centre_K_adjoint(const T (&Kc)[N][L], const T (&gKf)[N][L], const T gKf_top,
                                  const T top, T (&gKc)[N][L]) const {
        T el[N][L], em[N][L];
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                const T Kc_lo = at(i, l, -1, Kc);
                el[i][l] = em[i][l] = T(0);
                if (k >= 1 && k <= NZ - 2) min_adjoint(Kc_lo, Kc[i][l], gKf[i][l], el[i][l],
                                                       em[i][l]);
            }
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                const T el_hi = at(i, l, 1, el);
                T g = T(0);
                if (k == 0) g += gKf[i][l];
                if (k >= 1 && k <= NZ - 2) g += em[i][l];
                if (k <= NZ - 3) g += el_hi;
                if (k == NZ - 1) {
                    g += top;
                    g += gKf[i][l] + gKf_top;
                }
                gKc[i][l] = g;
            }
        }
    }

    // The heat flux in reverse, from the energy tendencies' cotangents gfU
    // (the tendency of level k -((qh[k+1] - qh[k]) / dz[k])): face f = 1 ...
    // NZ - 1 on the slot of level f forms its share 0.5 gkf of each side's
    // kap and gD / dzf of each side's T; DIRICHLET: the top face (the ghost
    // 2 vtop - T) on the slot of NZ - 1, else the top face carries no flux.
    // Each level gathers face k's share, then face k + 1's (then the top
    // face's): gT from `top` on the top level (what reads its temperature
    // besides the flux: the land's ground temperature, 0 for the soil) and 0
    // below it; gkap from 0, then, where X::on, x.gkap (the implicit rows'
    // cotangent of the level's kappa) added.
    template <bool DIRICHLET, class X>
    SOIL_FN void heat_flux_adjoint(const T (&gfU)[N][L], const T (&Tk)[N][L],
                                   const T (&kap)[N][L], const T vtop, const X& x,
                                   const T top, T (&gT)[N][L], T (&gkap)[N][L]) const {
        T hk[N][L], qk[N][L], top_gkap = T(0), top_gT = T(0);
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                const T gfU_lo = at(i, l, -1, gfU), dz_lo = at(i, l, -1, dz);
                const T Tk_lo = at(i, l, -1, Tk), kap_lo = at(i, l, -1, kap);
                hk[i][l] = qk[i][l] = T(0);
                if (k < 1 || k >= NZ) continue;
                const T glo = -gfU_lo / dz_lo;
                const T ghi = -gfU[i][l] / dz[i][l];
                const T gqh = glo - ghi;
                const T D = (Tk[i][l] - Tk_lo) / dzf[i][l];
                const T kf = T(0.5) * (kap[i][l] + kap_lo);
                const T gkf = -gqh * D;
                const T gD = -gqh * kf;
                hk[i][l] = T(0.5) * gkf;
                qk[i][l] = gD / dzf[i][l];
            }
        }
        if constexpr (DIRICHLET) {
#pragma unroll
            for (int i = 0; i < N; ++i) {
#pragma unroll
                for (int l = 0; l < L; ++l) {
                    if (level(i, l) != NZ - 1) continue;
                    const T glo = -gfU[i][l] / dz[i][l];
                    const T ghi = T(0);
                    const T gqh = glo - ghi;
                    const T ghost = T(2) * vtop - Tk[i][l];
                    const T D = (ghost - Tk[i][l]) / dzf_top;
                    const T kf = T(0.5) * (kap[i][l] + kap[i][l]);
                    top_gkap = -gqh * D;
                    const T gD = -gqh * kf;
                    top_gT = (gD / dzf_top) + (gD / dzf_top);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                const T hk_hi = at(i, l, 1, hk), qk_hi = at(i, l, 1, qk);
                T gk = T(0), gt = k == NZ - 1 ? top : T(0);
                if (k >= 1 && k <= NZ - 1) {
                    gk += hk[i][l];
                    gt += qk[i][l];
                }
                if (k <= NZ - 2) {
                    gk += hk_hi;
                    gt -= qk_hi;
                }
                if (DIRICHLET && k == NZ - 1) {
                    gk += top_gkap;
                    gt -= top_gT;
                }
                if constexpr (X::on) gkap[i][l] = gk + x.gkap[i][l];
                else gkap[i][l] = gk;
                gT[i][l] = gt;
            }
        }
    }

    // the Van Genuchten head's share of a level's saturation cotangent gsk
    // from its head's gpsi (psi_m = max(raw, psi_min) below saturation, raw
    // = -(1/alpha) (ss^(-1/m) - 1)^(1/n); the water table piecewise
    // constant)
    SOIL_FN void vg_head_adjoint(const T sk, const T wt, const T zck, const T gpsi, T& gsk) const {
        const Head<T> h(sk, wt, zck, c, P);
        if (!(h.se >= T(1)) && h.raw >= c.psi_min && h.se >= c.vg_se_lo && h.se <= c.vg_se_hi) {
            const T gX = gpsi * c.neg_inv_alpha * dfpow(h.X, P.num_inv_n, P.den_inv_n, c.p_inv_n);
            const T gss = gX * dfpow(h.ss, P.num_inv_m, P.den_inv_m, c.p_inv_m);
            gsk += (gss / c.vg_span) * c.por;
        }
    }

    // The saturation adjustment in reverse, from the closed saturation's
    // cotangents gs and the spill's gS1 (the closed pool's), with the
    // sweeps' predicates `bits`: gs becomes the cotangent of the saturation
    // before the sweeps. The down sweep from the bottom: a clipped level
    // takes -g2 dz of the cotangent g2 carried up, any other sets g2 = -gs /
    // dz; the g2 entering a lane is what the nearest lane below with an
    // unclipped level sends (0 where none has): a ballot finds those lanes
    // and one shuffle hands it. The up sweep from the top: a spilled level
    // takes g dz of the cotangent g carried down (gS1 above the top), any
    // other sets g = gs / dz; the g entering a lane is what the nearest lane
    // above with an unspilled level sends, or gS1.
    SOIL_FN void sweeps_adjoint(const SweepBits& bits, T (&gs)[N][L], const T gS1) const {
        T out[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
            T g2 = T(0);
#pragma unroll
            for (int l = 0; l < L; ++l)
                if (level(i, l) < NZ && !(bits.clipped[i] & (1u << l))) g2 = -gs[i][l] / dz[i][l];
            out[i] = g2;
        }
        unsigned m = lanes.ballot([&](int i) { return reset_in(i, bits.clipped[i]); });
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const int ln = lanes.lane(i);
            const unsigned below = m & ((1u << ln) - 1u);
            const T g_in = lanes.from(below ? Lanes::highest(below) : ln,
                                      [&](int j) { return out[j]; });
            T g2 = below ? g_in : T(0);
#pragma unroll
            for (int l = 0; l < L; ++l) {
                if (level(i, l) >= NZ) continue;
                const T gnew = gs[i][l];
                if (bits.clipped[i] & (1u << l)) {
                    gs[i][l] = -g2 * dz[i][l];
                } else {
                    gs[i][l] = gnew;
                    g2 = -gnew / dz[i][l];
                }
            }
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
            T g = T(0);
#pragma unroll
            for (int l = L - 1; l >= 0; --l)
                if (level(i, l) < NZ && !(bits.spilled[i] & (1u << l))) g = gs[i][l] / dz[i][l];
            out[i] = g;
        }
        m = lanes.ballot([&](int i) { return reset_in(i, bits.spilled[i]); });
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const int ln = lanes.lane(i);
            const unsigned above = ln < 31 ? (m >> (ln + 1)) << (ln + 1) : 0u;
            const T g_in = lanes.from(above ? Lanes::lowest(above) : ln,
                                      [&](int j) { return out[j]; });
            T g = above ? g_in : gS1;
#pragma unroll
            for (int l = L - 1; l >= 0; --l) {
                if (level(i, l) >= NZ) continue;
                const T gup = gs[i][l];
                if (bits.spilled[i] & (1u << l)) {
                    gs[i][l] = g * dz[i][l];
                } else {
                    gs[i][l] = gup;
                    g = gup / dz[i][l];
                }
            }
        }
    }

    // soil::rhs_adjoint (heat + Richards; the implicit terms' cotangents x,
    // TermCotangents, or none, NoTermCotangents) on the group: on entry
    // (gU, gs, gS) are the cotangents of what the
    // caller reads of the closed column, (gfU, gfs, gfS) those of the
    // tendencies; on return (gU, gs, gS) are those of the input column (U,
    // sat, S). Each lane's parameter cotangents accumulate into gKsat[i]
    // and gskm[i]. The closure is recomputed from the input column, the
    // sweeps' predicates as bits a lane, then the pieces are undone in
    // reverse: pool, Darcy flux, face K, heat flux, head and closure, the
    // down and up sweeps.
    template <class X>
    SOIL_FN void rhs_adjoint(const T (&U)[N][L], const T (&sat)[N][L], const T S, const T vtop,
                             T (&gU)[N][L], T (&gs)[N][L], T& gS, const T (&gfU)[N][L],
                             const T (&gfs)[N][L], const T gfS, const X& x,
                             T (&gKsat)[N], T (&gskm)[N])
    {
        // ---- recompute: the sweeps with their predicates, the closure,
        // the centre and face conductivities, the head
        T s[N][L], S1 = S, wt;
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) s[i][l] = sat[i][l];
        }
        SweepBits bits;
        sweeps<true>(s, S1, wt, bits);
        T Tk[N][L], kap[N][L], Kc[N][L], psi[N][L], FK[N][L];
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const Level<T, true> v(s[i][l], U[i][l], c, P);
                Tk[i][l] = v.Tk;
                kap[i][l] = v.kap;
                Kc[i][l] = v.Kc;
                psi[i][l] = Head<T>(s[i][l], wt, zc[i][l], c, P).psi;
            }
        }
        face_Ks(Kc, FK);

        // ---- surface pool: the tendency min(0, S1)
        const T gS1 = S1 < T(0) ? gS + gfS : gS;

        // ---- Darcy flux, face K, heat flux
        T gKf[N][L], gpsi[N][L], gKf_top, gKc[N][L], gT[N][L], gkap[N][L];
        darcy_adjoint(gfs, psi, FK, Kc, x, gKf, gpsi, gKf_top);
        centre_K_adjoint(Kc, gKf, gKf_top, T(0), gKc);
        heat_flux_adjoint<true>(gfU, Tk, kap, vtop, x, T(0), gT, gkap);

        // ---- pressure head and closure, slot by slot
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                if (level(i, l) >= NZ) continue;
                T gsk = gs[i][l];  // what the caller reads of the closed saturation
                vg_head_adjoint(s[i][l], wt, zc[i][l], gpsi[i][l], gsk);
                const Level<T, true> v(s[i][l], U[i][l], c, P);
                T gUk = gU[i][l];  // what the caller reads of U
                T gCx = T(0);  // the implicit rows' cotangent of the heat capacity
                if constexpr (X::on) gCx = x.gC[i][l];
                level_adjoint<T, true, X::on>(v, s[i][l], U[i][l], gT[i][l], gkap[i][l],
                                              gKc[i][l], gCx, c, P, gsk, gUk, gKsat[i],
                                              gskm[i]);
                gs[i][l] = gsk;
                gU[i][l] = gUk;
            }
        }

        // ---- the saturation adjustment in reverse
        sweeps_adjoint(bits, gs, gS1);
        gS = gS1;
    }

    // whether lane i has a level in the column whose bit of `taken` is 0
    // (a level of the reverse sweeps that resets the carried cotangent)
    SOIL_FN bool reset_in(int i, unsigned taken) const {
        bool any = false;
#pragma unroll
        for (int l = 0; l < L; ++l) any = any || (level(i, l) < NZ && !(taken & (1u << l)));
        return any;
    }

    // soil::solve_adjoint on the group: x = A^-1 d solved again, then gd =
    // A^-T gx by the same solver on the transposed rows (sub-diagonal
    // c[k-1], super-diagonal a[k+1], one level across the lane boundary),
    // one solver body for both in a loop that is not unrolled; the rows'
    // cotangents ga = -gd x[k-1], gb = -gd x[k], gc = -gd x[k+1] (0 outside
    // the matrix and on the slots above NZ)
    template <int SOLVER>
    SOIL_FN void solve_adjoint(const T (&a)[N][L], const T (&b)[N][L], const T (&c_)[N][L],
                               const T (&d)[N][L], const T (&gx)[N][L], T (&gd)[N][L],
                               T (&ga)[N][L], T (&gb)[N][L], T (&gc)[N][L]) const {
        T x[N][L];
#pragma unroll 1
        for (int pass = 0; pass < 2; ++pass) {
            const bool t = pass == 1;
            T a2[N][L], b2[N][L], c2[N][L], r[N][L];
#pragma unroll
            for (int i = 0; i < N; ++i) {
#pragma unroll
                for (int l = 0; l < L; ++l) {
                    const int k = level(i, l);
                    const T c_lo = at(i, l, -1, c_), a_hi = at(i, l, 1, a);
                    const bool in = k < NZ;
                    a2[i][l] = !in ? T(0) : (t ? (k == 0 ? T(0) : c_lo) : a[i][l]);
                    b2[i][l] = !in ? T(1) : b[i][l];
                    c2[i][l] = !in ? T(0) : (t ? (k == NZ - 1 ? T(0) : a_hi) : c_[i][l]);
                    r[i][l] = !in ? T(0) : (t ? gx[i][l] : d[i][l]);
                }
            }
            solve<SOLVER>(a2, b2, c2, r);
#pragma unroll
            for (int i = 0; i < N; ++i) {
#pragma unroll
                for (int l = 0; l < L; ++l) {
                    if (t) gd[i][l] = r[i][l];
                    else x[i][l] = r[i][l];
                }
            }
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                const T x_lo = at(i, l, -1, x), x_hi = at(i, l, 1, x);
                if (k >= NZ) {
                    gd[i][l] = ga[i][l] = gb[i][l] = gc[i][l] = T(0);
                    continue;
                }
                ga[i][l] = k == 0 ? T(0) : -gd[i][l] * x_lo;
                gb[i][l] = -gd[i][l] * x[i][l];
                gc[i][l] = k == NZ - 1 ? T(0) : -gd[i][l] * x_hi;
            }
        }
    }

    // soil::diffusion_rows_adjoint on the group: the rows' cotangents back
    // to the face conductivities (gKf of the face below each level, gKf_top
    // of the surface face, which only the Dirichlet top reads) and the
    // chain factors gD. Row k forms its shares on its slot, each level
    // gathers them in the one-thread loop's order: gKf[k] from row k - 1's
    // upper face, then row k's lower; gD[k] from row k - 1, row k's two
    // faces, then row k + 1.
    SOIL_FN void rows_adjoint(const T (&Kf)[N][L], const T Kf_top, const T (&D)[N][L],
                              const T s, const bool dirichlet, const T (&ga)[N][L],
                              const T (&gb)[N][L], const T (&gc)[N][L], T (&gKf)[N][L],
                              T& gKf_top, T (&gD)[N][L]) const {
        // row k's shares: klo (gKf[k]), khi (gKf[k + 1]), dlo (gD[k - 1]),
        // dhi (gD[k + 1]), do_lo and do_hi (gD[k], its lower and upper face)
        T klo[N][L], khi[N][L], dlo[N][L], dhi[N][L], do_lo[N][L], do_hi[N][L];
        T top_K = T(0), top_D = T(0);
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                const T D_lo = at(i, l, -1, D), D_hi = at(i, l, 1, D);
                const T Kf_up = at(i, l, 1, Kf);
                const T Kf_hi = k == NZ - 1 ? Kf_top : Kf_up;
                klo[i][l] = khi[i][l] = dlo[i][l] = dhi[i][l] = do_lo[i][l] = do_hi[i][l] = T(0);
                if (k >= NZ) continue;
                if (k > 0) {  // a[k] = -((s Kf[k] D[k-1]) / lo), b[k] += (s Kf[k] D[k]) / lo
                    const T lo = dzf[i][l] * dz[i][l], sK = s * Kf[i][l];
                    const T qa = -ga[i][l] / lo, qb = gb[i][l] / lo;
                    klo[i][l] = s * (qa * D_lo + qb * D[i][l]);
                    dlo[i][l] = qa * sK;
                    do_lo[i][l] = qb * sK;
                }
                if (k < NZ - 1) {  // c[k] = -((s Kf[k+1] D[k+1]) / hi), b[k] += (s Kf[k+1] D[k]) / hi
                    const T hi = dzfa[i][l] * dz[i][l], sK = s * Kf_hi;
                    const T qc = -gc[i][l] / hi, qb = gb[i][l] / hi;
                    khi[i][l] = s * (qc * D_hi + qb * D[i][l]);
                    dhi[i][l] = qc * sK;
                    do_hi[i][l] = qb * sK;
                }
                if (dirichlet && k == NZ - 1) {  // b[NZ-1] += ((2 s Kf[NZ]) D[NZ-1]) / (dzf[NZ] dz[NZ-1])
                    const T q = gb[i][l] / (dzf_top * dz[i][l]);
                    top_K = (T(2) * s) * (q * D[i][l]);
                    top_D = q * ((T(2) * s) * Kf_top);
                }
            }
        }
        gKf_top = T(0) + top_K;
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int k = level(i, l);
                const T khi_lo = at(i, l, -1, khi), dhi_lo = at(i, l, -1, dhi);
                const T dlo_hi = at(i, l, 1, dlo);
                T gk = T(0), gd = T(0);
                if (k >= 1 && k <= NZ - 1) {
                    gk += khi_lo;
                    gd += dhi_lo;
                }
                if (k >= 1 && k <= NZ - 1) gk += klo[i][l];
                if (k < NZ) {
                    if (k > 0) gd += do_lo[i][l];
                    if (k < NZ - 1) gd += do_hi[i][l];
                }
                if (k <= NZ - 2) gd += dlo_hi;
                if (k == NZ - 1 && dirichlet) gd += top_D;
                gKf[i][l] = gk;
                gD[i][l] = gd;
            }
        }
    }

    // The implicit systems of one Picard iteration in reverse, at the
    // iterate's closed column (U, the closed saturation xs) with its terms
    // f (ImplicitTerms, or the land column's): the rows recomputed and each
    // system undone by one solve of its transposed rows, Richards then
    // heat, by one body in a loop that is not unrolled; `later`: an
    // iteration after the first, whose right side is tend(u_k) - (u_k -
    // u^n) / dt (Un, sn: u^n). DIRICHLET: the heat rows' Dirichlet top;
    // chain and chain_deriv: the curve's d(Psi)/d(sat) and its derivative.
    // On entry (gU, gs) are the cotangents of the iteration's result; on
    // return gU and gs hold those of U and the closed saturation that the
    // rows and (later) the right side read, with (first iteration) gUn and
    // gsn added, gUn and gsn (later) the right side's shares of u^n added,
    // gfU and gfs the tendencies' cotangents and x the terms'.
    template <int SOLVER, bool DIRICHLET, class F, class Chain, class ChainDeriv>
    SOIL_FN void systems_adjoint(const F& f, const T (&U)[N][L], const T (&xs)[N][L],
                                 const bool later, const T (&Un)[N][L], const T (&sn)[N][L],
                                 T (&gU)[N][L], T (&gs)[N][L], T (&gUn)[N][L], T (&gsn)[N][L],
                                 T (&gfU)[N][L], T (&gfs)[N][L], TermCotangents& x, const T dt,
                                 const T inv_dt, const Chain& chain,
                                 const ChainDeriv& chain_deriv) const {
#pragma unroll 1
        for (int sys = 0; sys < 2; ++sys) {  // 0: Richards, 1: heat
            const bool heat = sys == 1;
            T Kf[N][L], D[N][L], d[N][L], gx[N][L], gd[N][L], gKf[N][L], gD[N][L];
            T a[N][L], b[N][L], cc[N][L], ga[N][L], gb[N][L], gc[N][L];
            T Kf_top = T(0), gKf_top;
#pragma unroll
            for (int i = 0; i < N; ++i) {
#pragma unroll
                for (int l = 0; l < L; ++l) {
                    const int k = level(i, l);
                    const T kap_lo = at(i, l, -1, f.kap);
                    Kf[i][l] = heat ? T(0.5) * (f.kap[i][l] + (k == 0 ? f.kap[i][l] : kap_lo))
                                    : f.Keff[i][l];
                    if (heat && k == NZ - 1) Kf_top = T(0.5) * (f.kap[i][l] + f.kap[i][l]);
                    D[i][l] = heat ? f.Dh[i][l] : chain(xs[i][l]);
                    d[i][l] = heat ? f.U[i][l] : f.sat[i][l];
                    if (later && k < NZ)
                        d[i][l] = d[i][l] - ((heat ? U[i][l] : xs[i][l])
                                             - (heat ? Un[i][l] : sn[i][l])) / dt;
                    gx[i][l] = k < NZ ? (heat ? gU[i][l] : gs[i][l]) : T(0);
                }
            }
            const T s = heat ? T(1) : c.inv_por;
            const bool dirichlet = DIRICHLET && heat;
            rows(Kf, Kf_top, D, s, inv_dt, dirichlet, a, b, cc);
            solve_adjoint<SOLVER>(a, b, cc, d, gx, gd, ga, gb, gc);
            rows_adjoint(Kf, Kf_top, D, s, dirichlet, ga, gb, gc, gKf, gKf_top, gD);
            if (heat) {
#pragma unroll
                for (int i = 0; i < N; ++i) {
#pragma unroll
                    for (int l = 0; l < L; ++l) {
                        const int k = level(i, l);
                        const T gKf_up = at(i, l, 1, gKf);
                        const T gKf_hi = k == NZ - 1 ? gKf_top : gKf_up;
                        gfU[i][l] = gd[i][l];
                        x.gkap[i][l] = T(0.5) * (gKf[i][l] + gKf_hi);
                        // Dh = 1/C, or 0 on the plateau
                        x.gC[i][l] = -(gD[i][l] * f.Dh[i][l]) * f.Dh[i][l];
                        if (k == 0) x.gkap[i][l] = x.gkap[i][l] + T(0.5) * gKf[i][l];
                        if (k == NZ - 1) x.gkap[i][l] = x.gkap[i][l] + T(0.5) * gKf_top;
                        if (k >= NZ) x.gkap[i][l] = x.gC[i][l] = T(0);
                    }
                }
            } else {
#pragma unroll
                for (int i = 0; i < N; ++i) {
#pragma unroll
                    for (int l = 0; l < L; ++l) {
                        gfs[i][l] = gd[i][l];
                        if (level(i, l) < NZ)
                            gs[i][l] = gs[i][l] + gD[i][l] * chain_deriv(xs[i][l]);
                        x.gKeff[i][l] = gKf[i][l];
                    }
                }
            }
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                if (level(i, l) >= NZ) continue;
                if (later) {
                    const T qU = gfU[i][l] / dt;
                    gU[i][l] = gU[i][l] - qU;
                    gUn[i][l] = gUn[i][l] + qU;
                    const T qs = gfs[i][l] / dt;
                    gs[i][l] = gs[i][l] - qs;
                    gsn[i][l] = gsn[i][l] + qs;
                } else {
                    gU[i][l] = gU[i][l] + gUn[i][l];
                    gs[i][l] = gs[i][l] + gsn[i][l];
                }
            }
        }
    }

    // soil::picard_iter_adjoint on the group: cotangents through one
    // iteration of picard_step at its iterate (U, sat, S) before the
    // iteration's closure; `later`: an iteration after the first, whose
    // right side is tend(u_k) - (u_k - u^n) / dt (Un, sn: u^n), its pool
    // dropped. The closure, the tendencies, the terms and the rows are
    // recomputed there and each system is undone by one solve of its
    // transposed rows (systems_adjoint), then the closure (rhs_adjoint).
    template <int SOLVER>
    SOIL_FN void picard_iter_adjoint(const T (&U)[N][L], const T (&sat)[N][L], const T S,
                                     const T vtop, const bool later, const T (&Un)[N][L],
                                     const T (&sn)[N][L], T (&gU)[N][L], T (&gs)[N][L], T& gS,
                                     T (&gUn)[N][L], T (&gsn)[N][L], T (&gKsat)[N],
                                     T (&gskm)[N], const T dt, const T inv_dt) {
        T xs[N][L], xS = S;
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) xs[i][l] = sat[i][l];
        }
        ImplicitTerms f;
        rhs(U, xs, xS, vtop, f);
        TermCotangents x;
        T gfU[N][L], gfs[N][L];
        systems_adjoint<SOLVER, true>(
            f, U, xs, later, Un, sn, gU, gs, gUn, gsn, gfU, gfs, x, dt, inv_dt,
            [&](T sk) { return water_chain<T>(sk, c, P); },
            [&](T sk) { return water_chain_deriv<T>(sk, c, P); });
        T gSk = later ? T(0) : gS;
        rhs_adjoint(U, sat, S, vtop, gU, gs, gSk, gfU, gfs, gSk * dt, x, gKsat, gskm);
        if (!later) gS = gSk;
    }

    // soil::picard_step_adjoint on the group: the iterations undone from
    // the last; for iteration k the iterate u_k is recomputed from the
    // step's start by picard_step's first k iterations, the forward's own
    // code at the forward's G (nothing is stored per iteration), then
    // picard_iter_adjoint takes it back to the iterate before it. The
    // closed start u^n that the later iterations read is the start's sweeps.
    template <int SOLVER>
    SOIL_FN void picard_step_adjoint(const T (&U)[N][L], const T (&sat)[N][L], const T S,
                                     const T vtop, T (&gU)[N][L], T (&gs)[N][L], T& gS,
                                     T (&gKsat)[N], T (&gskm)[N], const T dt, const T inv_dt,
                                     const int iters) {
        T sn[N][L], gUn[N][L] = {}, gsn[N][L] = {};
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) sn[i][l] = sat[i][l];
        }
        {
            T Sx = S, wt;
            sweeps(sn, Sx, wt);
        }
#pragma unroll 1
        for (int it = iters - 1; it >= 0; --it) {
            T xU[N][L], xs[N][L], xS = S;
#pragma unroll
            for (int i = 0; i < N; ++i) {
#pragma unroll
                for (int l = 0; l < L; ++l) { xU[i][l] = U[i][l]; xs[i][l] = sat[i][l]; }
            }
            picard_step<SOLVER>(xU, xs, xS, vtop, dt, inv_dt, it);
            picard_iter_adjoint<SOLVER>(xU, xs, xS, vtop, it > 0, U, sn, gU, gs, gS, gUn, gsn,
                                        gKsat, gskm, dt, inv_dt);
        }
    }

    // soil::step_adjoint (heat + Richards) on the group: cotangents through
    // one step (ForwardEuler, x + f dt) from its input (U, sat, S) at top
    // temperature vtop; on entry (gU, gs, gS) are those of the step's
    // output, on return those of its input. The tendencies' cotangents are
    // g dt; one rhs_adjoint without terms recomputes the closure and undoes
    // it.
    SOIL_FN void step_adjoint(const T (&U)[N][L], const T (&sat)[N][L], const T S, const T vtop,
                              T (&gU)[N][L], T (&gs)[N][L], T& gS, T (&gKsat)[N], T (&gskm)[N],
                              const T dt) {
        T gfU[N][L], gfs[N][L];
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                gfU[i][l] = gU[i][l] * dt;
                gfs[i][l] = gs[i][l] * dt;
            }
        }
        const T gfS = gS * dt;
        rhs_adjoint(U, sat, S, vtop, gU, gs, gS, gfU, gfs, gfS, NoTermCotangents{}, gKsat, gskm);
    }

    // soil::heun_step_adjoint (heat + Richards) on the group, as
    // step_adjoint: the closure and f_n of x_n at v0 and the stage y = x_n +
    // f_n dt are recomputed by rhs, heun_step's own code; the corrector's
    // mean gives each tendency 0.5 (g dt); the stage's closure at v1 is
    // read only through its tendencies; y passes its cotangent to the
    // closed x_n and, times dt, to f_n. The two rhs_adjoint passes (the
    // stage at v1, then x_n at v0) run one body in a loop that is not
    // unrolled; each value is formed by the one-thread adjoint's operations
    // in its order.
    SOIL_FN void heun_step_adjoint(const T (&U)[N][L], const T (&sat)[N][L], const T S,
                                   const T v0, const T v1, T (&gU)[N][L], T (&gs)[N][L], T& gS,
                                   T (&gKsat)[N], T (&gskm)[N], const T dt) {
        // pass 0 takes the stage (xU, xs, xS) = y at v1, with no direct
        // cotangents; pass 1 takes x_n at v0 with (gU, gs, gS)
        T xU[N][L], xs[N][L], xS = S;
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int l = 0; l < L; ++l) xs[i][l] = sat[i][l];
        }
        {
            Tendencies f;
            rhs(U, xs, xS, v0, f);
            xS = xS + f.S * dt;
#pragma unroll
            for (int i = 0; i < N; ++i) {
#pragma unroll
                for (int l = 0; l < L; ++l) {
                    xU[i][l] = U[i][l] + f.U[i][l] * dt;
                    xs[i][l] = xs[i][l] + f.sat[i][l] * dt;
                }
            }
        }
        T gfU[N][L], gfs[N][L], gxU[N][L], gxs[N][L];
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
        T gfS = T(0.5) * (gS * dt), gxS = T(0), v = v1;
#pragma unroll 1
        for (int pass = 0; pass < 2; ++pass) {
            rhs_adjoint(xU, xs, xS, v, gxU, gxs, gxS, gfU, gfs, gfS, NoTermCotangents{}, gKsat,
                        gskm);
            if (pass == 0) {  // y = x_n (closed) + f_n dt
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
                gfS = gfS + gxS * dt;
                gxS = gS + gxS;
                xS = S;
                v = v0;
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
        gS = gxS;
    }

    // the sum of v over the group's lanes by a fixed tree (lane j adds lane
    // j + d's, d = G/2, ..., 1), lane 0's, on every lane
    SOIL_FN T group_sum(const T (&v)[N]) const {
        T a[N];
#pragma unroll
        for (int i = 0; i < N; ++i) a[i] = v[i];
#pragma unroll
        for (int d = G / 2; d > 0; d >>= 1) {
            T b[N];
#pragma unroll
            for (int i = 0; i < N; ++i) b[i] = a[i] + lanes.down(i, [&](int j) { return a[j]; }, d);
#pragma unroll
            for (int i = 0; i < N; ++i) a[i] = b[i];
        }
        return lanes.from(0, [&](int j) { return a[j]; });
    }

    // soil::segment_vjp_column of STEPPER (heat + Richards: STEPPER_EULER
    // step, STEPPER_HEUN heun_step, STEPPER_IMPLICIT picard_step with
    // SOLVER and `iters` Picard iterations) on the group: `steps` steps
    // from the carry (U, sat, S), the top temperature of step s top[s *
    // step_stride] (Heun's stage also reads row s + 1), each step's input
    // carry stored to `scratch` where `store` (2 NZ + 1 values a column and
    // step, laid out [step][column][row] with the rows U[0 .. NZ), sat[0 ..
    // NZ), S, so that a group's stores are contiguous); then the reverse
    // sweep of the step's adjoint from the output cotangents (gU, gs, gS),
    // which become the input carry's. The forward is the group rollout's
    // own step, so at the rollout's G its carries are the rollout's bit for
    // bit. A group that does not store (the groups beyond the last column)
    // recomputes from its own carry, and its results are not used. Each
    // lane's parameter cotangents accumulate into gKsat[i] and gskm[i].
    template <int STEPPER, int SOLVER = SOLVER_PCR>
    SOIL_FN void segment_vjp(T (&U)[N][L], T (&sat)[N][L], T& S, T (&gU)[N][L], T (&gs)[N][L],
                             T& gS, T* scratch, const long long col, const long long cells,
                             const bool store, const T* top, const long long step_stride,
                             const int steps, const T dt, const T inv_dt, const int iters,
                             T (&gKsat)[N], T (&gskm)[N]) {
        constexpr long long ROWS = 2 * NZ + 1;
        for (int s = 0; s < steps; ++s) {
            T* rec = scratch + ((long long)s * cells + col) * ROWS;
            if (store) {
#pragma unroll
                for (int i = 0; i < N; ++i) {
#pragma unroll
                    for (int l = 0; l < L; ++l) {
                        const int k = level(i, l);
                        if (k < NZ) {
                            rec[k] = U[i][l];
                            rec[NZ + k] = sat[i][l];
                        }
                    }
                    if (lanes.lane(i) == 0) rec[2 * NZ] = S;
                }
            }
            const T vtop = top[s * step_stride];
            if constexpr (STEPPER == STEPPER_HEUN)
                heun_step(U, sat, S, vtop, top[(s + 1) * step_stride], dt);
            else if constexpr (STEPPER == STEPPER_IMPLICIT)
                picard_step<SOLVER>(U, sat, S, vtop, dt, inv_dt, iters);
            else
                step(U, sat, S, vtop, dt);
        }
        for (int s = steps - 1; s >= 0; --s) {
            const T* rec = scratch + ((long long)s * cells + col) * ROWS;
            if (store) {
#pragma unroll
                for (int i = 0; i < N; ++i) {
#pragma unroll
                    for (int l = 0; l < L; ++l) {
                        const int k = level(i, l);
                        if (k < NZ) {
                            U[i][l] = rec[k];
                            sat[i][l] = rec[NZ + k];
                        }
                    }
                }
                S = rec[2 * NZ];
            }
            const T vtop = top[s * step_stride];
            if constexpr (STEPPER == STEPPER_HEUN)
                heun_step_adjoint(U, sat, S, vtop, top[(s + 1) * step_stride], gU, gs, gS, gKsat,
                                  gskm, dt);
            else if constexpr (STEPPER == STEPPER_IMPLICIT)
                picard_step_adjoint<SOLVER>(U, sat, S, vtop, gU, gs, gS, gKsat, gskm, dt, inv_dt,
                                            iters);
            else
                step_adjoint(U, sat, S, vtop, gU, gs, gS, gKsat, gskm, dt);
        }
    }
};

}  // namespace soil
