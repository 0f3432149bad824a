// One closure-rotated soil step on one column, and its adjoint.
//
// Shared by csrc/soil_column_rollout.cu (the forward rollouts) and
// csrc/soil_column_segment_vjp.cu (the segment VJP), so that the VJP kernel's
// forward reproduces the rollout kernel's carries bit for bit. closure_rhs
// is the closure and the tendencies of a SoilModel: closure (saturation
// adjustment, water table, pressure head, energy -> temperature), centre and
// face hydraulic conductivity, heat and Darcy fluxes; or, for the heat-only
// model (NoFlow), the energy closure and the heat flux alone. step is
// ForwardEuler.pre_closure_step on it, heun_step Heun.pre_closure_step.
// ops/fused_step.py::_plain_rhs, _plain_euler and _plain_heun are their
// plain PyTorch versions, in the same order of operations.
//
// Layout of a column: arrays of NZ levels with k = 0 the bottom layer, held
// in fully unrolled per-thread arrays (template NZ); coordinates are passed
// as pointers (shared memory in the kernels).
//
// Everything here is plain C++ apart from the function qualifiers, so the
// header also compiles for the host.

#pragma once

#include <float.h>
#include <math.h>

#if defined(__CUDACC__)
#define SOIL_FN __device__ __forceinline__
#define SOIL_NOINLINE_FN __device__ __noinline__
#else
#define SOIL_FN inline
#define SOIL_NOINLINE_FN inline
#endif

extern "C" {
// Mirror of terrarium_tpu_torch.ops.fused_step._CParams (ctypes).
struct SoilColumnParams {
    double por;            // bulk porosity
    double L;              // rho_w * L_sl, volumetric latent heat
    double c_water, c_ice, c_air;      // heat capacities
    double c_mineral, c_organic;       // heat capacity * solid fraction
    double sk_water, sk_ice, sk_air;   // sqrt of the conductivities
    double sk_mineral, sk_organic;     // sqrt(conductivity) * solid fraction
    double theta_res;      // Van Genuchten residual water content
    double vg_span;        // porosity - theta_res
    double neg_inv_alpha;  // -(1 / alpha)
    double psi_min;        // lower clamp of the matric head
    double vg_se_lo, vg_se_hi;   // clip of effective saturation (inverse)
    double K_sat;          // saturated hydraulic conductivity
    double neg_impedance;  // -Omega of the ice impedance
    double k_theta_sat;    // max(porosity, 1e-12)
    double k_se_hi;        // upper clip of effective saturation (conductivity)
    double eps_lo;         // machine epsilon of the working type
    double z_top;          // surface face elevation
    double p_inv_m, p_inv_n, p_k1, p_k2;   // exponents -1/m, 1/n, n/(n+1), (n-1)/n
    int num_inv_m, den_inv_m, num_inv_n, den_inv_n;  // their root/power codes
    int num_k1, den_k1, num_k2, den_k2;
    // the implicit stepper's, appended so that the fields above keep their
    // offsets: the Richards rows' scale and VanGenuchten.inverse_deriv
    double inv_por;              // 1 / porosity
    double id_se_lo, id_se_hi;   // clip of effective saturation
    double id_coef;              // 1 / (alpha n m)
    double id_clamp;             // upper clamp of the derivative
    double p_id_core, p_id_a, p_id_b;  // exponents -1/m, (1 - n)/n, -(1 + m)/m
    int num_id_core, den_id_core, num_id_a, den_id_a, num_id_b, den_id_b;
};
}

namespace soil {

template <typename T> struct Eps;
template <> struct Eps<float> { static SOIL_FN float v() { return FLT_EPSILON; } };
template <> struct Eps<double> { static SOIL_FN double v() { return DBL_EPSILON; } };

SOIL_FN float d_sqrt(float x) { return sqrtf(x); }
SOIL_FN double d_sqrt(double x) { return sqrt(x); }
SOIL_FN float d_cbrt(float x) { return cbrtf(x); }
SOIL_FN double d_cbrt(double x) { return cbrt(x); }
SOIL_FN float d_pow(float x, float y) { return powf(x, y); }
SOIL_FN double d_pow(double x, double y) { return pow(x, y); }
SOIL_FN float d_log(float x) { return logf(x); }
SOIL_FN double d_log(double x) { return log(x); }
SOIL_FN float d_floor(float x) { return floorf(x); }
SOIL_FN double d_floor(double x) { return floor(x); }

// max/min that return NaN when either argument is NaN, as torch.maximum,
// torch.minimum and torch.clamp do
template <typename T>
SOIL_FN T vmax(T a, T b) { return (a != a || a > b) ? a : b; }
template <typename T>
SOIL_FN T vmin(T a, T b) { return (a != a || a < b) ? a : b; }

// x**k by binary powering in the order of ops/fastpow.py::_ipow (k != 0)
template <typename T>
SOIL_FN T ipow(T x, int k) {
    const bool neg = k < 0;
    if (neg) k = -k;
    T y = x, base = x;
    bool have = false;
    while (k) {
        if (k & 1) { y = have ? y * base : base; have = true; }
        k >>= 1;
        if (k) base = base * base;
    }
    return neg ? T(1) / y : y;
}

// ops/fastpow.py::fast_pow for the code (num, den) of a fixed exponent p
template <typename T>
SOIL_FN T fpow(T x, int num, int den, T p) {
    if (den == 0) return d_pow(x, p);
    if (num == 0) return T(1);
    const T root = den == 1 ? x : (den == 2 ? d_sqrt(x) : d_cbrt(x));
    return ipow(root, num);
}

// d fpow(x) / dx along the same chain: num * root^(num - 1) * d root / dx
template <typename T>
SOIL_FN T dfpow(T x, int num, int den, T p) {
    if (den == 0) return p * d_pow(x, p - T(1));
    if (num == 0) return T(0);
    const T root = den == 1 ? x : (den == 2 ? d_sqrt(x) : d_cbrt(x));
    const T droot = den == 1 ? T(1) : (den == 2 ? T(0.5) / root : T(1) / (T(3) * (root * root)));
    const T dpow = num == 1 ? T(1) : T(num) * ipow(root, num - 1);
    return dpow * droot;
}

// utils.safediv: x / (y + eps) where y != 0, else +inf
template <typename T>
SOIL_FN T safediv(T x, T y) {
    return y == T(0) ? T(INFINITY) : x / (y + Eps<T>::v());
}

// face conductivity (hydrology.py:128-148): bottom face = bottom centre,
// interior faces = min of the two neighbours, both top faces = top centre.
// Called with compile-time f inside unrolled loops, so Kc stays in registers.
template <typename T, int NZ>
SOIL_FN T face_K(const T (&Kc)[NZ], int f) {
    if (f == 0) return Kc[0];
    if (f >= NZ - 1) return Kc[NZ - 1];
    return vmin(Kc[f - 1], Kc[f]);
}

// the parameters in the working type, read once per thread
template <typename T>
struct Consts {
    T por, L, c_water, c_ice, c_air, c_mineral, c_organic;
    T sk_water, sk_ice, sk_air, sk_mineral, sk_organic;
    T theta_res, vg_span, neg_inv_alpha, psi_min, vg_se_lo, vg_se_hi;
    T K_sat, neg_impedance, k_theta_sat, k_se_hi, eps_lo, z_top;
    T p_inv_m, p_inv_n, p_k1, p_k2;
    T inv_por, id_se_lo, id_se_hi, id_coef, id_clamp, p_id_core, p_id_a, p_id_b;
    SOIL_FN explicit Consts(const SoilColumnParams& P)
        : por(T(P.por)), L(T(P.L)), c_water(T(P.c_water)), c_ice(T(P.c_ice)),
          c_air(T(P.c_air)), c_mineral(T(P.c_mineral)), c_organic(T(P.c_organic)),
          sk_water(T(P.sk_water)), sk_ice(T(P.sk_ice)), sk_air(T(P.sk_air)),
          sk_mineral(T(P.sk_mineral)), sk_organic(T(P.sk_organic)),
          theta_res(T(P.theta_res)), vg_span(T(P.vg_span)),
          neg_inv_alpha(T(P.neg_inv_alpha)), psi_min(T(P.psi_min)),
          vg_se_lo(T(P.vg_se_lo)), vg_se_hi(T(P.vg_se_hi)), K_sat(T(P.K_sat)),
          neg_impedance(T(P.neg_impedance)), k_theta_sat(T(P.k_theta_sat)),
          k_se_hi(T(P.k_se_hi)), eps_lo(T(P.eps_lo)), z_top(T(P.z_top)),
          p_inv_m(T(P.p_inv_m)), p_inv_n(T(P.p_inv_n)), p_k1(T(P.p_k1)), p_k2(T(P.p_k2)),
          inv_por(T(P.inv_por)), id_se_lo(T(P.id_se_lo)), id_se_hi(T(P.id_se_hi)),
          id_coef(T(P.id_coef)), id_clamp(T(P.id_clamp)), p_id_core(T(P.p_id_core)),
          p_id_a(T(P.p_id_a)), p_id_b(T(P.p_id_b)) {}
};

// The closure and conductivities of one level from its adjusted saturation
// and energy: FreeWater liquid fraction and temperature, heat capacity, bulk
// thermal conductivity and, WITH_K, the Mualem-van Genuchten centre
// conductivity (hydraulics.py:50-87).
template <typename T, bool WITH_K = true>
struct Level {
    T L_theta, negL, liq, wi, water, ice, air, C, Tk, acc, kap;
    T I_ice, se, se_s, A, inner, sq, Kc;
    bool frozen;
    SOIL_FN Level(const T sk, const T Uk, const Consts<T>& c, const SoilColumnParams& P) {
        L_theta = c.L * sk * c.por;
        negL = -L_theta;
        liq = Uk >= T(0) ? T(1) : (Uk >= negL ? T(1) - safediv(Uk, negL) : T(0));
        wi = sk * c.por;
        water = wi * liq;
        ice = wi * (T(1) - liq);
        air = (T(1) - sk) * c.por;
        C = c.c_water * water + c.c_ice * ice + c.c_air * air + c.c_mineral + c.c_organic;
        Tk = Uk < negL ? (Uk + L_theta) / C : (Uk >= T(0) ? Uk / C : T(0));
        acc = c.sk_water * water + c.sk_ice * ice + c.sk_air * air + c.sk_mineral + c.sk_organic;
        kap = acc * acc;
        if (!WITH_K) return;
        I_ice = d_pow(T(10), c.neg_impedance * (T(1) - liq));
        se = vmin(vmax(water / c.k_theta_sat, T(0)), T(1));
        frozen = se <= c.eps_lo;
        se_s = frozen ? c.eps_lo : vmin(se, c.k_se_hi);
        A = fpow(se_s, P.num_k1, P.den_k1, c.p_k1);
        inner = T(1) - fpow(T(1) - A, P.num_k2, P.den_k2, c.p_k2);
        sq = d_sqrt(se_s);
        const T K_unsat = frozen ? T(0) : c.K_sat * I_ice * sq * (inner * inner);
        Kc = se >= T(1) ? c.K_sat * I_ice : K_unsat;
    }
};

// The total head of one level, psi_h + psi_m + (z - z_top), and the pieces
// of the Van Genuchten inverse that the adjoint needs.
template <typename T>
struct Head {
    T se, ss, X, raw, psi;
    SOIL_FN Head(const T sk, const T wt, const T zck, const Consts<T>& c,
                 const SoilColumnParams& P) {
        se = (sk * c.por - c.theta_res) / c.vg_span;
        ss = vmin(vmax(se, c.vg_se_lo), c.vg_se_hi);
        X = fpow(ss, P.num_inv_m, P.den_inv_m, c.p_inv_m) - T(1);
        raw = c.neg_inv_alpha * fpow(X, P.num_inv_n, P.den_inv_n, c.p_inv_n);
        const T psi_m = se >= T(1) ? T(0) : vmax(raw, c.psi_min);
        const T psi_h = vmax(wt - zck, T(0));
        psi = psi_h + psi_m + (zck - c.z_top);
    }
};

// The saturation adjustment (hydrology.py:181) in place: the up sweep, the
// spill past the top layer into `spill` (unscaled, parity mode), the down
// sweep, and the water table `wt` (the face below the lowest cell with
// sat < 1, the surface when every cell is saturated). Bit k of `spilled`
// and `clipped` records the predicates of level k that the adjoint
// follows: spill iff sat + c/dz >= 1, clip iff sat_up - c2/dz <= 0.
template <typename T, int NZ>
SOIL_FN void sweeps(T (&sat)[NZ], T& spill, T& wt, unsigned& spilled, unsigned& clipped,
                    const T* dz, const T* zf)
{
    T cc = T(0);
    spilled = 0u;
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        const T sk = sat[k];
        const T x = sk + cc / dz[k];
        if (x >= T(1)) spilled |= 1u << k;
        sat[k] = vmin(x, T(1));
        cc = vmax((sk - T(1)) * dz[k] + cc, T(0));
    }
    spill = cc;
    T c2 = T(0);
    wt = zf[NZ];
    clipped = 0u;
#pragma unroll
    for (int k = NZ - 1; k >= 0; --k) {
        const T su = sat[k];
        const T y = su - c2 / dz[k];
        if (y <= T(0)) clipped |= 1u << k;
        sat[k] = vmax(y, T(0));
        c2 = vmax(-su * dz[k] + c2, T(0));
        if (sat[k] < T(1)) wt = zf[k];
    }
}

// The closure and tendencies of one closure-rotated step of the column
// (U, sat, S) with top temperature vtop, in the modules' order. Richards:
// the saturation adjustment in place (sat, and S += spill) and the water
// table; then level by level the energy closure, the centre conductivity
// and the heat flux; then the pressure head and the Darcy flux. HEAT (the
// heat-only model): the energy closure and the heat flux alone, sat read
// only. Each tendency goes to `out` as soon as it is formed, so that a sink
// may update the level in place (energy of level k once the flux above it
// is known): out.energy(k, dU/dt), out.water(k, dsat/dt), out.pool(dS/dt).
// The implicit stepper's sink also takes each level's closure,
// out.level(k, U[k], Level), and each face's Darcy conductivity,
// out.darcy_face(f, K_eff); the explicit sinks ignore both.
template <typename T, int NZ, bool HEAT, class Out>
SOIL_FN void closure_rhs(const T (&U)[NZ], T (&sat)[NZ], T& S, const T vtop,
                         const Consts<T>& c, const SoilColumnParams& P, const T* dz,
                         const T* dzf, const T* zc, const T* zf, Out& out)
{
    T Kc[NZ];

    // ---- closure: saturation adjustment and water table
    T wt = T(0);
    if (!HEAT) {
        T spill;
        unsigned spilled, clipped;
        sweeps<T, NZ>(sat, spill, wt, spilled, clipped, dz, zf);
        S = S + spill;
    }

    // ---- energy closure, centre conductivities, heat flux
    T T_prev = T(0), kap_prev = T(0), qh_prev = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        const Level<T, !HEAT> v(sat[k], U[k], c, P);
        out.level(k, U[k], v);
        if (!HEAT) Kc[k] = v.Kc;
        // heat flux at the face below cell k; zero gradient at the bottom
        const T kf = T(0.5) * (v.kap + (k == 0 ? v.kap : kap_prev));
        const T qh = -kf * ((v.Tk - (k == 0 ? v.Tk : T_prev)) / dzf[k]);
        if (k > 0) out.energy(k - 1, -((qh - qh_prev) / dz[k - 1]));
        qh_prev = qh;
        T_prev = v.Tk;
        kap_prev = v.kap;
    }
    {   // top face: Dirichlet ghost 2*v - T_top
        const T ghost = T(2) * vtop - T_prev;
        const T kf = T(0.5) * (kap_prev + kap_prev);
        const T qh = -kf * ((ghost - T_prev) / dzf[NZ]);
        out.energy(NZ - 1, -((qh - qh_prev) / dz[NZ - 1]));
    }
    if (HEAT) return;

    // ---- pressure head, Darcy flux with upwind-min face K
    T psi_prev = T(0), qw_prev = T(0);
#pragma unroll
    for (int k = 0; k <= NZ; ++k) {
        const T psi_k = k < NZ ? Head<T>(sat[k], wt, zc[k], c, P).psi : psi_prev;
        // face k: zero-gradient ghosts at both ends
        const T lower = k == 0 ? psi_k : psi_prev;
        const T grad = (psi_k - lower) / dzf[k];
        const T K_lo = k == 0 ? T(INFINITY) : face_K<T, NZ>(Kc, k - 1);
        const T K_hi = k == NZ ? T(INFINITY) : face_K<T, NZ>(Kc, k + 1);
        const T K_k = face_K<T, NZ>(Kc, k);
        const T K_eff = grad < T(0) ? vmin(K_lo, K_k) : vmin(K_k, K_hi);
        const T qw = -K_eff * grad;
        out.darcy_face(k, K_eff);
        if (k > 0) out.water(k - 1, (-((qw - qw_prev) / dz[k - 1])) / c.por);
        qw_prev = qw;
        psi_prev = psi_k;
    }
    out.pool(vmin(T(0), S));  // parity surface-pool term +min(0, S)
}

// what an explicit sink ignores of closure_rhs
template <typename T>
struct ExplicitSink {
    template <class L>
    SOIL_FN void level(int, T, const L&) {}
    SOIL_FN void darcy_face(int, T) {}
};

// ForwardEuler's update x + f * dt, level by level as closure_rhs forms f
template <typename T, int NZ>
struct EulerUpdate : ExplicitSink<T> {
    T (&U)[NZ];
    T (&sat)[NZ];
    T& S;
    const T dt;
    SOIL_FN EulerUpdate(T (&U_)[NZ], T (&sat_)[NZ], T& S_, const T dt_)
        : U(U_), sat(sat_), S(S_), dt(dt_) {}
    SOIL_FN void energy(int k, T f) { U[k] = U[k] + f * dt; }
    SOIL_FN void water(int k, T f) { sat[k] = sat[k] + f * dt; }
    SOIL_FN void pool(T f) { S = S + f * dt; }
};

// the tendencies of Heun's first stage, kept
template <typename T, int NZ>
struct Tendencies : ExplicitSink<T> {
    T U[NZ], sat[NZ], S;
    SOIL_FN void energy(int k, T f) { U[k] = f; }
    SOIL_FN void water(int k, T f) { sat[k] = f; }
    SOIL_FN void pool(T f) { S = f; }
};

// Heun's corrector x + (0.5 * (f_n + f*)) * dt, level by level as
// closure_rhs forms f* at the stage
template <typename T, int NZ>
struct HeunUpdate : ExplicitSink<T> {
    T (&U)[NZ];
    T (&sat)[NZ];
    T& S;
    const Tendencies<T, NZ>& f;
    const T dt;
    SOIL_FN HeunUpdate(T (&U_)[NZ], T (&sat_)[NZ], T& S_, const Tendencies<T, NZ>& f_,
                       const T dt_)
        : U(U_), sat(sat_), S(S_), f(f_), dt(dt_) {}
    SOIL_FN void energy(int k, T g) { U[k] = U[k] + (T(0.5) * (f.U[k] + g)) * dt; }
    SOIL_FN void water(int k, T g) { sat[k] = sat[k] + (T(0.5) * (f.sat[k] + g)) * dt; }
    SOIL_FN void pool(T g) { S = S + (T(0.5) * (f.S + g)) * dt; }
};

// One ForwardEuler.pre_closure_step of the column (U, sat, S) in place;
// vtop is the top temperature of this step. The update streams into the
// column as the tendencies are formed, so no tendency array is held.
template <typename T, int NZ, bool HEAT = false>
SOIL_FN void step(T (&U)[NZ], T (&sat)[NZ], T& S, const T vtop, const Consts<T>& c,
                  const SoilColumnParams& P, const T* dz, const T* dzf, const T* zc,
                  const T* zf, const T dt)
{
    EulerUpdate<T, NZ> out{U, sat, S, dt};
    closure_rhs<T, NZ, HEAT>(U, sat, S, vtop, c, P, dz, dzf, zc, zf, out);
}

// One Heun.pre_closure_step of the column in place (stepping.py:167-188):
// closure(x_n) and f_n at v0 (the top temperature at t_n); the stage
// y = x_n + f_n * dt, closure(y) and f* at v1 (at t_n + dt); then
// x_n + (0.5 * (f_n + f*)) * dt. The surface pool takes part like the
// other prognostics. Live across the stage: x_n, f_n, y and Kc, about
// 7 * NZ values.
template <typename T, int NZ, bool HEAT>
SOIL_FN void heun_step(T (&U)[NZ], T (&sat)[NZ], T& S, const T v0, const T v1,
                       const Consts<T>& c, const SoilColumnParams& P, const T* dz,
                       const T* dzf, const T* zc, const T* zf, const T dt)
{
    Tendencies<T, NZ> f;
    closure_rhs<T, NZ, HEAT>(U, sat, S, v0, c, P, dz, dzf, zc, zf, f);
    T yU[NZ], ys[NZ];
    T yS = HEAT ? T(0) : S + f.S * dt;
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        yU[k] = U[k] + f.U[k] * dt;
        ys[k] = HEAT ? sat[k] : sat[k] + f.sat[k] * dt;
    }
    HeunUpdate<T, NZ> out{U, sat, S, f, dt};
    closure_rhs<T, NZ, HEAT>(yU, ys, yS, v1, c, P, dz, dzf, zc, zf, out);
}

// ---------------------------------------------------------------------------
// implicit step (ImplicitEuler, timesteppers/implicit.py:165-264)
// ---------------------------------------------------------------------------
//
// (I/dt - J) du = tend(u^n) for the heat and the Richards systems of the
// column, each tridiagonal, solved by Thomas or PCR on the column in
// registers (ops/tridiag.py). The order of operations is the JAX package's:
// the assembly of implicit.py:69-117, tridiag.py:44-50 and :85-88 (Thomas),
// tridiag.py:109-129 (PCR).

// SOLVER_RUNTIME: either solver, chosen by a `solver` argument at run time
// (picard_step and its adjoint), so that one instantiation serves both
enum { SOLVER_THOMAS = 0, SOLVER_PCR = 1, SOLVER_RUNTIME = 2 };

// the tendencies (the right-hand sides) and what the rows need of the
// closed column: the centre thermal conductivity, dT/dU (0 on the freeze
// plateau -L_theta <= U < 0, else 1/C; energy.py:142-163) and the Darcy face
// conductivity (hydrology.py:368-396)
template <typename T, int NZ>
struct ImplicitTerms : Tendencies<T, NZ> {
    T kap[NZ], Dh[NZ], Keff[NZ + 1];
    template <class L>
    SOIL_FN void level(int k, T Uk, const L& v) {
        kap[k] = v.kap;
        Dh[k] = (Uk >= v.negL && Uk < T(0)) ? T(0) : T(1) / v.C;
    }
    SOIL_FN void darcy_face(int f, T K) { Keff[f] = K; }
};

// D = d(Psi)/d(sat) = VanGenuchten.inverse_deriv(sat * por, por) * por
// (swrc.py:77-90): the clipped se, the three fixed powers, the clamp, 0 at
// and above saturation
template <typename T>
SOIL_FN T water_chain(const T sk, const Consts<T>& c, const SoilColumnParams& P) {
    const T se_raw = (sk * c.por - c.theta_res) / c.vg_span;
    const T se = vmin(vmax(se_raw, c.id_se_lo), c.id_se_hi);
    const T core = fpow(se, P.num_id_core, P.den_id_core, c.p_id_core) - T(1);
    const T dpsi = (c.id_coef * fpow(core, P.num_id_a, P.den_id_a, c.p_id_a))
                   * fpow(se, P.num_id_b, P.den_id_b, c.p_id_b);
    const T d = dpsi / c.vg_span;
    return (se_raw >= T(1) ? T(0) : vmin(vmax(d, T(0)), c.id_clamp)) * c.por;
}

// The rows (a, b, c) for face conductivities Kf, chain factor D and scale s
// (implicit.py:69-117): each face term (s K D) / (dzf dz); the boundary rows
// take no term of their boundary face (a[0] and c[NZ-1] are 0, which both
// solvers ignore); a Dirichlet phi at the top adds 2 s K D / (dzf dz) to the
// top row.
template <typename T, int NZ>
SOIL_FN void diffusion_rows(const T (&Kf)[NZ + 1], const T (&D)[NZ], const T s,
                            const T inv_dt, const T* dz, const T* dzf, const bool dirichlet_top,
                            T (&a)[NZ], T (&b)[NZ], T (&c)[NZ])
{
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        const T sKlo = s * Kf[k], sKhi = s * Kf[k + 1];
        const T lo = dzf[k] * dz[k], hi = dzf[k + 1] * dz[k];
        a[k] = k == 0 ? T(0) : -((sKlo * D[k > 0 ? k - 1 : 0]) / lo);
        c[k] = k == NZ - 1 ? T(0) : -((sKhi * D[k < NZ - 1 ? k + 1 : k]) / hi);
        const T diag_lo = k == 0 ? T(0) : (sKlo * D[k]) / lo;
        const T diag_hi = k == NZ - 1 ? T(0) : (sKhi * D[k]) / hi;
        b[k] = (inv_dt + diag_lo) + diag_hi;
    }
    if (dirichlet_top)
        b[NZ - 1] = b[NZ - 1] + ((T(2) * s * Kf[NZ]) * D[NZ - 1]) / (dzf[NZ] * dz[NZ - 1]);
}

// Thomas (tridiag.py:30-91): c'[k] = c[k] / (b[k] - a[k] c'[k-1]), d'[k] =
// (d[k] - a[k] d'[k-1]) / (the same), a[0] taken as 0; then x[k] = d'[k] -
// c'[k] x[k+1] from the top down. d becomes x.
template <typename T, int NZ>
SOIL_FN void thomas(const T (&a)[NZ], const T (&b)[NZ], const T (&c)[NZ], T (&d)[NZ]) {
    T cp[NZ];
    T c_prev = T(0), d_prev = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        const T a_k = k == 0 ? T(0) : a[k];
        const T denom = b[k] - a_k * c_prev;
        c_prev = c[k] / denom;
        d_prev = (d[k] - a_k * d_prev) / denom;
        cp[k] = c_prev;
        d[k] = d_prev;
    }
    T x = T(0);
#pragma unroll
    for (int k = NZ - 1; k >= 0; --k) {
        x = d[k] - cp[k] * x;
        d[k] = x;
    }
}

// One PCR round of stride S (tridiag.py:119-128): rows out of range act as
// the identity (b = 1, a = c = d = 0), so their terms drop out; the new a
// and c are built from the old ones.
template <typename T, int NZ, int S>
SOIL_FN void pcr_rounds(T (&a)[NZ], T (&b)[NZ], T (&c)[NZ], T (&d)[NZ]) {
    if constexpr (S < NZ) {
        T an[NZ], bn[NZ], cn[NZ], dn[NZ];
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            const bool lo = k - S >= 0, hi = k + S < NZ;
            const int kl = lo ? k - S : k, kh = hi ? k + S : k;
            const T alpha = lo ? -a[k] / b[kl] : -a[k];
            const T gamma = hi ? -c[k] / b[kh] : -c[k];
            T bk = b[k], dk = d[k];
            if (lo) { bk = bk + alpha * c[kl]; dk = dk + alpha * d[kl]; }
            if (hi) { bk = bk + gamma * a[kh]; dk = dk + gamma * d[kh]; }
            bn[k] = bk;
            dn[k] = dk;
            an[k] = lo ? alpha * a[kl] : T(0);
            cn[k] = hi ? gamma * c[kh] : T(0);
        }
#pragma unroll
        for (int k = 0; k < NZ; ++k) { a[k] = an[k]; b[k] = bn[k]; c[k] = cn[k]; d[k] = dn[k]; }
        pcr_rounds<T, NZ, 2 * S>(a, b, c, d);
    }
}

// PCR (tridiag.py:109-129): a[0] and c[NZ-1] zeroed, the rounds of stride
// 1, 2, 4, ... < NZ, then x = d / b. d becomes x; a, b, c are spent.
template <typename T, int NZ>
SOIL_FN void pcr(T (&a)[NZ], T (&b)[NZ], T (&c)[NZ], T (&d)[NZ]) {
    a[0] = T(0);
    c[NZ - 1] = T(0);
    pcr_rounds<T, NZ, 1>(a, b, c, d);
#pragma unroll
    for (int k = 0; k < NZ; ++k) d[k] = d[k] / b[k];
}

template <typename T, int NZ, int SOLVER>
SOIL_FN void solve(T (&a)[NZ], T (&b)[NZ], T (&c)[NZ], T (&d)[NZ], const int solver = SOLVER) {
    if constexpr (SOLVER == SOLVER_PCR) pcr<T, NZ>(a, b, c, d);
    else if constexpr (SOLVER == SOLVER_THOMAS) thomas<T, NZ>(a, b, c, d);
    else if (solver == SOLVER_PCR) pcr<T, NZ>(a, b, c, d);
    else thomas<T, NZ>(a, b, c, d);
}

// One ImplicitEuler.pre_closure_step of the column (U, sat, S) in place,
// one Picard iteration: closure_rhs into the implicit sink (the closure in
// place, the tendencies, the terms); the heat rows (face kappa by the
// arithmetic mean with zero-gradient ends, dT/dU, scale 1, the Dirichlet
// top at vtop) and their solve, U += du; the Richards rows (the Darcy face
// K, d(Psi)/d(sat) at the closed saturation, scale 1/por; the pressure head
// has no BC) and their solve, sat += du; the surface pool explicitly, S +=
// min(0, S) * dt. The two systems are solved one after the other, each
// solve turning its tendency array into du, so that one set of rows is live
// at a time.
template <typename T, int NZ, int SOLVER>
SOIL_FN void implicit_step(T (&U)[NZ], T (&sat)[NZ], T& S, const T vtop, const Consts<T>& c,
                           const SoilColumnParams& P, const T* dz, const T* dzf, const T* zc,
                           const T* zf, const T dt, const T inv_dt)
{
    ImplicitTerms<T, NZ> f;
    closure_rhs<T, NZ, false>(U, sat, S, vtop, c, P, dz, dzf, zc, zf, f);
    T a[NZ], b[NZ], cc[NZ];
    {
        T Kf[NZ + 1];
        Kf[0] = T(0.5) * (f.kap[0] + f.kap[0]);
#pragma unroll
        for (int k = 1; k < NZ; ++k) Kf[k] = T(0.5) * (f.kap[k] + f.kap[k - 1]);
        Kf[NZ] = T(0.5) * (f.kap[NZ - 1] + f.kap[NZ - 1]);
        diffusion_rows<T, NZ>(Kf, f.Dh, T(1), inv_dt, dz, dzf, true, a, b, cc);
    }
    solve<T, NZ, SOLVER>(a, b, cc, f.U);
#pragma unroll
    for (int k = 0; k < NZ; ++k) U[k] = U[k] + f.U[k];
    {
        T D[NZ];
#pragma unroll
        for (int k = 0; k < NZ; ++k) D[k] = water_chain<T>(sat[k], c, P);
        diffusion_rows<T, NZ>(f.Keff, D, c.inv_por, inv_dt, dz, dzf, false, a, b, cc);
    }
    solve<T, NZ, SOLVER>(a, b, cc, f.sat);
#pragma unroll
    for (int k = 0; k < NZ; ++k) sat[k] = sat[k] + f.sat[k];
    S = S + f.S * dt;
}

// One ImplicitEuler.pre_closure_step of the column with `iters` Picard
// iterations (implicit.py:234-254), over heat + Richards or, HEAT, the
// heat-only model, whose only implicit system is the energy's (its rows and
// solve as implicit_step's; the saturation is read only, and there is no
// pool). Iteration 0 is implicit_step's arithmetic: the closure in place,
// the tendencies, each system's rows and solve. Each further iteration
// closes the iterate in place (the saturation adjustment; its spill goes to
// a copy of the pool and is dropped, since S, an explicit variable, keeps
// iteration 0's value), takes the tendencies and the rows at the iterate
// with the top temperature still at the step's clock time, and solves
// A(u_k) du = tend(u_k) - (u_k - u^n) / dt, u_k the closed iterate and u^n
// the step's closed start, setting u = u_k + du for U and sat. The loop is
// not unrolled: one body serves every iteration, and u^n (U and the closed
// saturation) stays live across it. iters = 0 leaves the column as it is.
// SOLVER may be SOLVER_RUNTIME, the solves then by `solver`.
template <typename T, int NZ, int SOLVER, bool HEAT>
SOIL_FN void picard_step(T (&U)[NZ], T (&sat)[NZ], T& S, const T vtop, const Consts<T>& c,
                         const SoilColumnParams& P, const T* dz, const T* dzf, const T* zc,
                         const T* zf, const T dt, const T inv_dt, const int iters,
                         const int solver = SOLVER)
{
    T Un[NZ], sn[NZ];
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
        ImplicitTerms<T, NZ> f;
        T Sk = S;
        closure_rhs<T, NZ, HEAT>(U, sat, Sk, vtop, c, P, dz, dzf, zc, zf, f);
        if (it == 0) {
            S = Sk;
#pragma unroll
            for (int k = 0; k < NZ; ++k) { Un[k] = U[k]; sn[k] = sat[k]; }
        } else {
#pragma unroll
            for (int k = 0; k < NZ; ++k) {
                f.U[k] = f.U[k] - (U[k] - Un[k]) / dt;
                if (!HEAT) f.sat[k] = f.sat[k] - (sat[k] - sn[k]) / dt;
            }
        }
        T a[NZ], b[NZ], cc[NZ];
        {
            T Kf[NZ + 1];
            Kf[0] = T(0.5) * (f.kap[0] + f.kap[0]);
#pragma unroll
            for (int k = 1; k < NZ; ++k) Kf[k] = T(0.5) * (f.kap[k] + f.kap[k - 1]);
            Kf[NZ] = T(0.5) * (f.kap[NZ - 1] + f.kap[NZ - 1]);
            diffusion_rows<T, NZ>(Kf, f.Dh, T(1), inv_dt, dz, dzf, true, a, b, cc);
        }
        solve<T, NZ, SOLVER>(a, b, cc, f.U, solver);
#pragma unroll
        for (int k = 0; k < NZ; ++k) U[k] = U[k] + f.U[k];
        if constexpr (!HEAT) {
            {
                T D[NZ];
#pragma unroll
                for (int k = 0; k < NZ; ++k) D[k] = water_chain<T>(sat[k], c, P);
                diffusion_rows<T, NZ>(f.Keff, D, c.inv_por, inv_dt, dz, dzf, false, a, b, cc);
            }
            solve<T, NZ, SOLVER>(a, b, cc, f.sat, solver);
#pragma unroll
            for (int k = 0; k < NZ; ++k) sat[k] = sat[k] + f.sat[k];
            if (it == 0) S = S + f.S * dt;
        }
    }
}

// picard_step compiled once, out of line, for the segment VJP, which runs it
// in its forward pass and again to recompute the iterates of each step's
// adjoint (picard_step_adjoint): one copy of the step's code instead of two
// to register-allocate, at the price of the column's arrays in local memory
// across the call
template <typename T, int NZ, int SOLVER, bool HEAT>
SOIL_NOINLINE_FN void picard_step_call(T (&U)[NZ], T (&sat)[NZ], T& S, const T vtop,
                                       const Consts<T>& c, const SoilColumnParams& P,
                                       const T* dz, const T* dzf, const T* zc, const T* zf,
                                       const T dt, const T inv_dt, const int iters,
                                       const int solver)
{
    picard_step<T, NZ, SOLVER, HEAT>(U, sat, S, vtop, c, P, dz, dzf, zc, zf, dt, inv_dt, iters,
                                     solver);
}

// A uniformly spaced series at clock time t (ops/fused_step.py::series_value,
// the counterpart of _WindowSource.update_inputs, fused_step.py:104-122, read
// from the whole series instead of a window): `s` points at the column's
// value of row 0, rows `row_stride` apart, at the times t0 + r * dts.
// u = clamp((t - t0) / dts, 0, rows - 1), r = floor(u), w = u - r, value
// (1 - w) * s[r] + w * s[min(r + 1, rows - 1)], flat beyond the ends.
template <typename T>
SOIL_FN T series_value(const T* s, const long long row_stride, const int rows, const T t0,
                       const T dts, const T t)
{
    const T u = vmin(vmax((t - t0) / dts, T(0)), T(rows - 1));
    const T r = d_floor(u);
    const T w = u - r;
    const int i = (int)r;
    const int j = i + 1 < rows ? i + 1 : rows - 1;
    return (T(1) - w) * s[i * row_stride] + w * s[j * row_stride];
}

enum { STEPPER_EULER = 0, STEPPER_HEUN = 1, STEPPER_IMPLICIT = 2 };

// `steps` closure-rotated steps of one column (U, sat, S) in place, by
// STEPPER (ForwardEuler, Heun or ImplicitEuler with SOLVER: implicit_step,
// or, PICARD, picard_step with `iters` iterations; inv_dt is 1 / dt as the
// host rounds it), from the clock time t, which advances by t + dt as
// Clock.tick does. The top temperature of clock time i is
// top[i * step_stride] (a table; Heun reads steps + 1 rows) or, SERIES,
// the series at `top` read at the clock time; `top` points at the column's
// element of row 0.
template <typename T, int NZ, int STEPPER, int SOLVER, bool HEAT, bool SERIES,
          bool PICARD = false>
SOIL_FN void rollout_column(T (&U)[NZ], T (&sat)[NZ], T& S, const T* top,
                            const long long step_stride, const int rows, const T t0,
                            const T dts, T t, const int steps, const Consts<T>& c,
                            const SoilColumnParams& P, const T* dz, const T* dzf,
                            const T* zc, const T* zf, const T dt, const T inv_dt,
                            const int iters = 1, const int solver = SOLVER)
{
    static_assert(!(STEPPER == STEPPER_IMPLICIT && HEAT && !PICARD),
                  "the heat-only implicit column step is picard_step's");
    for (int s = 0; s < steps; ++s) {
        if constexpr (STEPPER == STEPPER_HEUN) {
            const T t1 = t + dt;
            const T v0 = SERIES ? series_value(top, step_stride, rows, t0, dts, t)
                                : top[s * step_stride];
            const T v1 = SERIES ? series_value(top, step_stride, rows, t0, dts, t1)
                                : top[(s + 1) * step_stride];
            heun_step<T, NZ, HEAT>(U, sat, S, v0, v1, c, P, dz, dzf, zc, zf, dt);
            t = t1;
        } else if constexpr (STEPPER == STEPPER_IMPLICIT) {
            const T vtop = SERIES ? series_value(top, step_stride, rows, t0, dts, t)
                                  : top[s * step_stride];
            if constexpr (PICARD)
                picard_step<T, NZ, SOLVER, HEAT>(U, sat, S, vtop, c, P, dz, dzf, zc, zf, dt,
                                                 inv_dt, iters, solver);
            else
                implicit_step<T, NZ, SOLVER>(U, sat, S, vtop, c, P, dz, dzf, zc, zf, dt, inv_dt);
            if (SERIES) t = t + dt;
        } else {
            const T vtop = SERIES ? series_value(top, step_stride, rows, t0, dts, t)
                                  : top[s * step_stride];
            step<T, NZ, HEAT>(U, sat, S, vtop, c, P, dz, dzf, zc, zf, dt);
            if (SERIES) t = t + dt;
        }
    }
}

// ---------------------------------------------------------------------------
// adjoint
// ---------------------------------------------------------------------------
//
// Branch convention: the adjoint follows the branch the forward took, and
// differentiates each piece as the plain version's torch autograd does.
// * saturation sweeps: one predicate per level (hydrology.py
//   _SaturationSweeps): a level spills iff sat + c/dz >= 1 and is clipped
//   iff sat_up - c2/dz <= 0; the water goes to the layer or to the carry.
// * min of two conductivities (face K, upwind K): torch.minimum's rule, the
//   smaller side takes the cotangent, a tie splits it 0.5/0.5.
// * clamps: torch.clamp's rule, the cotangent passes where lo <= x <= hi.
// * where-selected branches (freeze curve, frozen guard, se >= 1, psi_m):
//   only the taken branch is evaluated, so an unselected safediv or root
//   contributes an exact 0 and never 0 * inf.
// * the surface-pool term min(0, S): derivative 0 at S == 0
//   (hydrology.py pool_drainage).

// cotangents of (a, b) from that of min(a, b), torch.minimum's rule
template <typename T>
SOIL_FN void min_adjoint(T a, T b, T g, T& ga, T& gb) {
    if (a < b) ga += g;
    else if (b < a) gb += g;
    else { ga += T(0.5) * g; gb += T(0.5) * g; }
}

// cotangents of (sat, U) of one level from those of its temperature,
// conductivity and centre hydraulic conductivity (WITH_K) and, WITH_C, of
// its heat capacity beyond the temperature's (the implicit rows' dT/dU) and,
// WITH_X, of its water, ice and air fractions beyond those (gwx, gix, gax:
// what the land step reads of them); the parameter cotangents (K_sat,
// sk_mineral) are accumulated
template <typename T, bool WITH_K = true, bool WITH_C = false, bool WITH_X = false>
SOIL_FN void level_adjoint(const Level<T, WITH_K>& v, const T sk, const T Uk, const T gT,
                           const T gkap, const T gKc, const T gCx, const Consts<T>& c,
                           const SoilColumnParams& P, T& gs, T& gU, T& gKsat, T& gskm,
                           const T gwx = T(0), const T gix = T(0), const T gax = T(0))
{
    // kap = acc * acc; acc = sum of sqrt(k_i) * fractions + sk_mineral + ...
    const T gacc = gkap * v.acc + gkap * v.acc;
    gskm += gacc;
    T gwater = c.sk_water * gacc, gice = c.sk_ice * gacc, gair = c.sk_air * gacc;
    if constexpr (WITH_X) {
        gwater += gwx;
        gice += gix;
        gair += gax;
    }
    T gliq = T(0), gLt = T(0);

    if constexpr (WITH_K) {
        T gI = T(0);
        // centre hydraulic conductivity
        if (v.se >= T(1)) {
            gKsat += gKc * v.I_ice;
            gI += gKc * c.K_sat;
        } else if (!v.frozen) {
            // K_unsat = ((K_sat * I_ice) * sq) * (inner * inner)
            const T inner2 = v.inner * v.inner;
            const T gKI = gKc * inner2 * v.sq;
            gKsat += gKI * v.I_ice;
            gI += gKI * c.K_sat;
            const T KI = c.K_sat * v.I_ice;
            const T ginner = gKc * (KI * v.sq) * (v.inner + v.inner);
            T gses = gKc * inner2 * KI * (T(0.5) / v.sq);
            // inner = 1 - fpow(1 - A, k2), A = fpow(se_s, k1)
            const T gB = -ginner * dfpow(T(1) - v.A, P.num_k2, P.den_k2, c.p_k2);
            gses += -gB * dfpow(v.se_s, P.num_k1, P.den_k1, c.p_k1);
            // se_s = min(se, k_se_hi); se = clamp(water / k_theta_sat, 0, 1)
            const T r = v.water / c.k_theta_sat;
            if (v.se <= c.k_se_hi && r >= T(0) && r <= T(1)) gwater += gses / c.k_theta_sat;
        }
        // I_ice = 10^(neg_impedance * (1 - liq))
        gliq += -(gI * v.I_ice * d_log(T(10))) * c.neg_impedance;
    }

    // temperature
    T gC = T(0);
    if (Uk < v.negL) {
        const T gnum = gT / v.C;
        gU += gnum;
        gLt += gnum;
        gC = -gT * v.Tk / v.C;
    } else if (Uk >= T(0)) {
        gU += gT / v.C;
        gC = -gT * v.Tk / v.C;
    }
    if constexpr (WITH_C) gC = gC + gCx;
    // heat capacity
    gwater += c.c_water * gC;
    gice += c.c_ice * gC;
    gair += c.c_air * gC;
    // water = wi * liq, ice = wi * (1 - liq), air = (1 - sat) * por, wi = sat * por
    const T gwi = gwater * v.liq + gice * (T(1) - v.liq);
    gliq += gwater * v.wi - gice * v.wi;
    gs += -gair * c.por;
    gs += gwi * c.por;
    // liquid fraction on the freeze plateau: 1 - U / (negL + eps)
    if (!(Uk >= T(0)) && Uk >= v.negL) {
        const T d = v.negL + Eps<T>::v();
        gU += -gliq / d;
        gLt += -(gliq * Uk / (d * d));  // negL = -L_theta
    }
    // L_theta = L * sat * por
    gs += gLt * c.por * c.L;
}

// What a stepper reads of closure_rhs besides the closed column and the
// tendencies, as cotangents for rhs_adjoint: nothing (ForwardEuler, Heun) ...
template <typename T>
struct NoTerms {
    static constexpr bool on = false;
    SOIL_FN T kap(int) const { return T(0); }
    SOIL_FN T C(int) const { return T(0); }
    SOIL_FN T Keff(int) const { return T(0); }
};

// ... or ImplicitTerms' (ImplicitEuler): the centre thermal conductivity,
// the heat capacity (through dT/dU = 1/C off the freeze plateau) and the
// Darcy face conductivity
template <typename T, int NZ>
struct TermCotangents {
    static constexpr bool on = true;
    T gkap[NZ], gC[NZ], gKeff[NZ + 1];
    SOIL_FN T kap(int k) const { return gkap[k]; }
    SOIL_FN T C(int k) const { return gC[k]; }
    SOIL_FN T Keff(int f) const { return gKeff[f]; }
};

// Cotangents through closure_rhs of the column (U, sat, S) with top
// temperature vtop. On entry (gU, gs, gS) are the cotangents of what the
// caller reads of the closed column itself (U, the adjusted saturation and
// the pool after the spill; HEAT: U and sat), (gfU, gfs, gfS) those of the
// tendencies and x those of the terms an implicit step reads (X::on); on
// return (gU, gs, gS) are the cotangents of the input column. The parameter
// cotangents are accumulated into gKsat and gskm. The closure is recomputed
// from the input column, then the pieces are undone in exact reverse order:
// surface pool, Darcy flux with the upwind-min K, face K, heat flux,
// pressure head, energy closure and centre K, then the down and up sweeps.
template <typename T, int NZ, bool HEAT, class X>
SOIL_FN void rhs_adjoint(const T (&U)[NZ], const T (&sat)[NZ], const T S, const T vtop,
                         T (&gU)[NZ], T (&gs)[NZ], T& gS, const T (&gfU)[NZ],
                         const T (&gfs)[NZ], const T gfS, const X& x, T& gKsat, T& gskm,
                         const Consts<T>& c, const SoilColumnParams& P, const T* dz,
                         const T* dzf, const T* zc, const T* zf)
{
    // ---- recompute: sweeps with their predicates, closure, conductivities
    T s[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) s[k] = sat[k];
    T spill = T(0), wt = T(0), S1 = S;
    unsigned spilled = 0u, clipped = 0u;
    if constexpr (!HEAT) {
        sweeps<T, NZ>(s, spill, wt, spilled, clipped, dz, zf);
        S1 = S + spill;
    }
    T Tk[NZ], kap[NZ], Kc[NZ], psi[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        const Level<T, !HEAT> v(s[k], U[k], c, P);
        Tk[k] = v.Tk;
        kap[k] = v.kap;
        if constexpr (!HEAT) {
            Kc[k] = v.Kc;
            psi[k] = Head<T>(s[k], wt, zc[k], c, P).psi;
        }
    }

    // ---- surface pool: the tendency min(0, S1)
    const T gS1 = S1 < T(0) ? gS + gfS : gS;

    // ---- Darcy flux; the boundary faces carry no flux (zero-gradient
    // ghosts), so only interior faces f = 1 .. NZ-1 count
    T gKf[NZ + 1], gpsi[NZ], gKc[NZ];
#pragma unroll
    for (int f = 0; f <= NZ; ++f) gKf[f] = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) { gpsi[k] = T(0); gKc[k] = T(0); }
    if constexpr (!HEAT) {
#pragma unroll
        for (int f = 1; f < NZ; ++f) {
            // dsat/dt[k] = (-((qw[k+1] - qw[k]) / dz[k])) / por
            const T glo = -(gfs[f - 1] / c.por) / dz[f - 1];
            const T ghi = -(gfs[f] / c.por) / dz[f];
            const T gqw = glo - ghi;
            const T grad = (psi[f] - psi[f - 1]) / dzf[f];
            const T K_f = face_K<T, NZ>(Kc, f);
            const T K_lo = face_K<T, NZ>(Kc, f - 1);
            const T K_hi = face_K<T, NZ>(Kc, f + 1);
            const T K_eff = grad < T(0) ? vmin(K_lo, K_f) : vmin(K_f, K_hi);
            T gK = -gqw * grad;
            if constexpr (X::on) gK = gK + x.Keff(f);
            const T ggrad = -gqw * K_eff;
            if (grad < T(0)) min_adjoint(K_lo, K_f, gK, gKf[f - 1], gKf[f]);
            else min_adjoint(K_f, K_hi, gK, gKf[f], gKf[f + 1]);
            gpsi[f] += ggrad / dzf[f];
            gpsi[f - 1] -= ggrad / dzf[f];
        }
        // face K from centre K
        gKc[0] += gKf[0];
#pragma unroll
        for (int f = 1; f < NZ - 1; ++f)
            min_adjoint(Kc[f - 1], Kc[f], gKf[f], gKc[f - 1], gKc[f]);
        gKc[NZ - 1] += gKf[NZ - 1] + gKf[NZ];
    }

    // ---- heat flux (face 0 carries no flux)
    T gT[NZ], gkap[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) { gT[k] = T(0); gkap[k] = T(0); }
#pragma unroll
    for (int f = 1; f <= NZ; ++f) {
        // dU/dt[k] = -((qh[k+1] - qh[k]) / dz[k])
        const T glo = -gfU[f - 1] / dz[f - 1];
        const T ghi = f < NZ ? -gfU[f] / dz[f] : T(0);
        const T gqh = glo - ghi;
        if (f < NZ) {
            const T D = (Tk[f] - Tk[f - 1]) / dzf[f];
            const T kf = T(0.5) * (kap[f] + kap[f - 1]);
            const T gkf = -gqh * D;
            const T gD = -gqh * kf;
            gkap[f] += T(0.5) * gkf;
            gkap[f - 1] += T(0.5) * gkf;
            gT[f] += gD / dzf[f];
            gT[f - 1] -= gD / dzf[f];
        } else {  // top face: Dirichlet ghost 2*v - T_top
            const T ghost = T(2) * vtop - Tk[NZ - 1];
            const T D = (ghost - Tk[NZ - 1]) / dzf[NZ];
            const T kf = T(0.5) * (kap[NZ - 1] + kap[NZ - 1]);
            const T gkf = -gqh * D;
            const T gD = -gqh * kf;
            gkap[NZ - 1] += gkf;
            gT[NZ - 1] -= (gD / dzf[NZ]) + (gD / dzf[NZ]);
        }
    }
    if constexpr (X::on) {
#pragma unroll
        for (int k = 0; k < NZ; ++k) gkap[k] = gkap[k] + x.kap(k);
    }

    // ---- pressure head and closure, level by level
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        T gsk = gs[k];  // what the caller reads of the closed saturation
        if constexpr (!HEAT) {
            // psi = psi_h + psi_m + (z - z_top); psi_m = max(raw, psi_min)
            // below saturation, raw = -(1/alpha) * (ss^(-1/m) - 1)^(1/n),
            // ss = clip(se)
            const Head<T> h(s[k], wt, zc[k], c, P);
            if (!(h.se >= T(1)) && h.raw >= c.psi_min && h.se >= c.vg_se_lo
                && h.se <= c.vg_se_hi) {
                const T gX = gpsi[k] * c.neg_inv_alpha * dfpow(h.X, P.num_inv_n, P.den_inv_n,
                                                               c.p_inv_n);
                const T gss = gX * dfpow(h.ss, P.num_inv_m, P.den_inv_m, c.p_inv_m);
                gsk += (gss / c.vg_span) * c.por;
            }
        }
        const Level<T, !HEAT> v(s[k], U[k], c, P);
        T gUk = gU[k];  // what the caller reads of U
        level_adjoint<T, !HEAT, X::on>(v, s[k], U[k], gT[k], gkap[k], gKc[k],
                                       x.C(k), c, P, gsk, gUk, gKsat, gskm);
        gs[k] = gsk;
        gU[k] = gUk;
    }
    if constexpr (HEAT) return;

    // ---- saturation adjustment: down sweep in reverse (bottom level
    // first; the deficit leaving the bottom is dropped), then the up sweep
    // in reverse (the spill's cotangent enters at the top)
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
    gS = gS1;
}

// Cotangents through one step() (ForwardEuler, x + f dt): on entry (gU, gs,
// gS) are those of the step's output, on return those of its input (U,
// sat, S); HEAT: (gU, gs), the saturation read and passed on, so that its
// cotangent gathers each step's. The parameter cotangents are accumulated
// into gKsat and gskm. The step is recomputed from its input carry.
template <typename T, int NZ, bool HEAT = false>
SOIL_FN void step_adjoint(const T (&U)[NZ], const T (&sat)[NZ], const T S, const T vtop,
                          T (&gU)[NZ], T (&gs)[NZ], T& gS, T& gKsat, T& gskm,
                          const Consts<T>& c, const SoilColumnParams& P, const T* dz,
                          const T* dzf, const T* zc, const T* zf, const T dt)
{
    T gfU[NZ], gfs[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        gfU[k] = gU[k] * dt;
        gfs[k] = HEAT ? T(0) : gs[k] * dt;
    }
    const T gfS = gS * dt;
    rhs_adjoint<T, NZ, HEAT>(U, sat, S, vtop, gU, gs, gS, gfU, gfs, gfS, NoTerms<T>{}, gKsat,
                             gskm, c, P, dz, dzf, zc, zf);
}

// Cotangents through one heun_step() (heat + Richards or, HEAT, heat only),
// as step_adjoint: the closure and f_n of x_n at v0 and the stage y = x_n +
// f_n dt are recomputed; the corrector's mean gives each tendency 0.5 (g
// dt); the stage's closure_rhs at v1 is read only through its tendencies;
// y passes its cotangent to the closed x_n and, times dt, to f_n. HEAT: the
// stage reads the saturation as it is, so its cotangent gathers the
// output's, the stage's and x_n's. The two rhs_adjoint passes (the stage,
// then x_n) run one body in a loop that is not unrolled, which halves the
// code the compiler register-allocates.
template <typename T, int NZ, bool HEAT = false>
SOIL_FN void heun_step_adjoint(const T (&U)[NZ], const T (&sat)[NZ], const T S, const T v0,
                               const T v1, T (&gU)[NZ], T (&gs)[NZ], T& gS, T& gKsat, T& gskm,
                               const Consts<T>& c, const SoilColumnParams& P, const T* dz,
                               const T* dzf, const T* zc, const T* zf, const T dt)
{
    // pass 0 takes the stage (xU, xs, xS) = y at v1, with no direct
    // cotangents; pass 1 takes x_n at v0 with (gU, gs, gS)
    T xU[NZ], xs[NZ], xS = S;
#pragma unroll
    for (int k = 0; k < NZ; ++k) { xU[k] = U[k]; xs[k] = sat[k]; }
    {
        Tendencies<T, NZ> f;
        closure_rhs<T, NZ, HEAT>(U, xs, xS, v0, c, P, dz, dzf, zc, zf, f);
        if (!HEAT) xS = xS + f.S * dt;
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            xU[k] = U[k] + f.U[k] * dt;
            if (!HEAT) xs[k] = xs[k] + f.sat[k] * dt;
        }
    }
    T gfU[NZ], gfs[NZ], gxU[NZ], gxs[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        gfU[k] = T(0.5) * (gU[k] * dt);
        gfs[k] = T(0.5) * (gs[k] * dt);
        gxU[k] = T(0);
        gxs[k] = T(0);
    }
    T gfS = T(0.5) * (gS * dt), gxS = T(0), v = v1;
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
        rhs_adjoint<T, NZ, HEAT>(xU, xs, xS, v, gxU, gxs, gxS, gfU, gfs, gfS, NoTerms<T>{},
                                 gKsat, gskm, c, P, dz, dzf, zc, zf);
        if (pass == 0) {  // y = x_n (closed) + f_n dt
#pragma unroll
            for (int k = 0; k < NZ; ++k) {
                gfU[k] = gfU[k] + gxU[k] * dt;
                gfs[k] = gfs[k] + gxs[k] * dt;
                gxU[k] = gU[k] + gxU[k];
                gxs[k] = gs[k] + gxs[k];
                xU[k] = U[k];
                xs[k] = sat[k];
            }
            gfS = gfS + gxS * dt;
            gxS = gS + gxS;
            xS = S;
            v = v0;
        }
    }
#pragma unroll
    for (int k = 0; k < NZ; ++k) { gU[k] = gxU[k]; gs[k] = gxs[k]; }
    gS = gxS;
}

// The rows' cotangents (ga, gb, gc) back to the face conductivities and the
// chain factor of diffusion_rows (scale s and 1/dt are constants); gKf and
// gD are set.
template <typename T, int NZ>
SOIL_FN void diffusion_rows_adjoint(const T (&Kf)[NZ + 1], const T (&D)[NZ], const T s,
                                    const T* dz, const T* dzf, const bool dirichlet_top,
                                    const T (&ga)[NZ], const T (&gb)[NZ], const T (&gc)[NZ],
                                    T (&gKf)[NZ + 1], T (&gD)[NZ])
{
#pragma unroll
    for (int f = 0; f <= NZ; ++f) gKf[f] = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) gD[k] = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        if (k > 0) {  // a[k] = -((s Kf[k] D[k-1]) / lo), b[k] += (s Kf[k] D[k]) / lo
            const T lo = dzf[k] * dz[k], sK = s * Kf[k];
            const T qa = -ga[k] / lo, qb = gb[k] / lo;
            gKf[k] += s * (qa * D[k - 1] + qb * D[k]);
            gD[k - 1] += qa * sK;
            gD[k] += qb * sK;
        }
        if (k < NZ - 1) {  // c[k] = -((s Kf[k+1] D[k+1]) / hi), b[k] += (s Kf[k+1] D[k]) / hi
            const T hi = dzf[k + 1] * dz[k], sK = s * Kf[k + 1];
            const T qc = -gc[k] / hi, qb = gb[k] / hi;
            gKf[k + 1] += s * (qc * D[k + 1] + qb * D[k]);
            gD[k + 1] += qc * sK;
            gD[k] += qb * sK;
        }
    }
    if (dirichlet_top) {  // b[NZ-1] += ((2 s Kf[NZ]) D[NZ-1]) / (dzf[NZ] dz[NZ-1])
        const T q = gb[NZ - 1] / (dzf[NZ] * dz[NZ - 1]);
        gKf[NZ] += (T(2) * s) * (q * D[NZ - 1]);
        gD[NZ - 1] += q * ((T(2) * s) * Kf[NZ]);
    }
}

// The VJP of x = A^-1 d (the rows a, b, c, solved by SOLVER), without
// differentiating the elimination: x is solved again, then gd = A^-T gx by
// the same solver on the transposed rows (sub-diagonal c[k-1],
// super-diagonal a[k+1]), one solver body for both in a loop that is not
// unrolled; the rows' cotangents are ga[k] = -gd[k] x[k-1], gb[k] = -gd[k]
// x[k], gc[k] = -gd[k] x[k+1] (0 outside the matrix). a, b, c and d are
// kept.
template <typename T, int NZ, int SOLVER>
SOIL_FN void solve_adjoint(const T (&a)[NZ], const T (&b)[NZ], const T (&c)[NZ],
                           const T (&d)[NZ], const T (&gx)[NZ], T (&gd)[NZ], T (&ga)[NZ],
                           T (&gb)[NZ], T (&gc)[NZ], const int solver = SOLVER)
{
    T x[NZ], a2[NZ], b2[NZ], c2[NZ], r[NZ];
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
        const bool t = pass == 1;
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            a2[k] = t ? (k == 0 ? T(0) : c[k > 0 ? k - 1 : 0]) : a[k];
            b2[k] = b[k];
            c2[k] = t ? (k == NZ - 1 ? T(0) : a[k < NZ - 1 ? k + 1 : k]) : c[k];
            r[k] = t ? gx[k] : d[k];
        }
        solve<T, NZ, SOLVER>(a2, b2, c2, r, solver);
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            if (t) gd[k] = r[k];
            else x[k] = r[k];
        }
    }
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        ga[k] = k == 0 ? T(0) : -gd[k] * x[k > 0 ? k - 1 : 0];
        gb[k] = -gd[k] * x[k];
        gc[k] = k == NZ - 1 ? T(0) : -gd[k] * x[k < NZ - 1 ? k + 1 : k];
    }
}

// d water_chain / d sat: the second derivative of the Van Genuchten inverse
// through the clip of se (the cotangent passes where id_se_lo <= se_raw <=
// id_se_hi) and the clamp of the derivative (where 0 <= d <= id_clamp), 0
// at and above saturation, as torch.clamp and torch.where differentiate
template <typename T>
SOIL_FN T water_chain_deriv(const T sk, const Consts<T>& c, const SoilColumnParams& P) {
    const T se_raw = (sk * c.por - c.theta_res) / c.vg_span;
    if (se_raw >= T(1) || !(se_raw >= c.id_se_lo && se_raw <= c.id_se_hi)) return T(0);
    const T se = se_raw;
    const T core = fpow(se, P.num_id_core, P.den_id_core, c.p_id_core) - T(1);
    const T A = fpow(core, P.num_id_a, P.den_id_a, c.p_id_a);
    const T B = fpow(se, P.num_id_b, P.den_id_b, c.p_id_b);
    const T d = ((c.id_coef * A) * B) / c.vg_span;
    if (!(d >= T(0) && d <= c.id_clamp)) return T(0);
    // out = d * por, d = ((coef A) B) / span, A = core^a, core = se^e - 1
    const T gdpsi = c.por / c.vg_span;
    const T gA = gdpsi * B * c.id_coef;
    const T gse = gdpsi * (c.id_coef * A) * dfpow(se, P.num_id_b, P.den_id_b, c.p_id_b)
                  + gA * dfpow(core, P.num_id_a, P.den_id_a, c.p_id_a)
                        * dfpow(se, P.num_id_core, P.den_id_core, c.p_id_core);
    // se_raw = (sat * por - theta_res) / span
    return gse * c.por / c.vg_span;
}

// Cotangents through one implicit_step() (heat + Richards, one Picard
// iteration), as step_adjoint. Recomputed: the closed column, its
// tendencies and ImplicitTerms, both systems' rows. Undone in reverse, the
// two systems by one body in a loop that is not unrolled: the Richards
// solve (sat' = sat_c + A_w^-1 f_sat: gf_sat = A_w^-T gsat', the rows'
// cotangents to the Darcy face K and to D = water_chain(sat_c), whose
// derivative joins the closed saturation's cotangent); the heat solve (U' =
// U + A_h^-1 f_U, the same, the rows' cotangents to the face kappa, the
// arithmetic mean of the centre ones, and to dT/dU, which passes -1/C^2 to
// the heat capacity off the freeze plateau); then the pool and
// rhs_adjoint with those terms' cotangents.
template <typename T, int NZ, int SOLVER>
SOIL_FN void implicit_step_adjoint(const T (&U)[NZ], const T (&sat)[NZ], const T S,
                                   const T vtop, T (&gU)[NZ], T (&gs)[NZ], T& gS, T& gKsat,
                                   T& gskm, const Consts<T>& c, const SoilColumnParams& P,
                                   const T* dz, const T* dzf, const T* zc, const T* zf,
                                   const T dt, const T inv_dt)
{
    T xs[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) xs[k] = sat[k];
    T xS = S;
    ImplicitTerms<T, NZ> f;
    closure_rhs<T, NZ, false>(U, xs, xS, vtop, c, P, dz, dzf, zc, zf, f);
    TermCotangents<T, NZ> x;
    T gfU[NZ], gfs[NZ];
#pragma unroll 1
    for (int sys = 0; sys < 2; ++sys) {  // 0: Richards, 1: heat
        const bool heat = sys == 1;
        T Kf[NZ + 1], D[NZ], d[NZ], gx[NZ], gd[NZ], gKf[NZ + 1], gD[NZ];
        T a[NZ], b[NZ], cc[NZ], ga[NZ], gb[NZ], gc[NZ];
        Kf[0] = heat ? T(0.5) * (f.kap[0] + f.kap[0]) : f.Keff[0];
#pragma unroll
        for (int k = 1; k < NZ; ++k) Kf[k] = heat ? T(0.5) * (f.kap[k] + f.kap[k - 1]) : f.Keff[k];
        Kf[NZ] = heat ? T(0.5) * (f.kap[NZ - 1] + f.kap[NZ - 1]) : f.Keff[NZ];
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            D[k] = heat ? f.Dh[k] : water_chain<T>(xs[k], c, P);
            d[k] = heat ? f.U[k] : f.sat[k];
            gx[k] = heat ? gU[k] : gs[k];
        }
        const T s = heat ? T(1) : c.inv_por;
        diffusion_rows<T, NZ>(Kf, D, s, inv_dt, dz, dzf, heat, a, b, cc);
        solve_adjoint<T, NZ, SOLVER>(a, b, cc, d, gx, gd, ga, gb, gc);
        diffusion_rows_adjoint<T, NZ>(Kf, D, s, dz, dzf, heat, ga, gb, gc, gKf, gD);
        if (heat) {
#pragma unroll
            for (int k = 0; k < NZ; ++k) {
                gfU[k] = gd[k];
                x.gkap[k] = T(0.5) * (gKf[k] + gKf[k + 1]);
                x.gC[k] = -(gD[k] * f.Dh[k]) * f.Dh[k];  // Dh = 1/C, or 0 on the plateau
            }
            x.gkap[0] = x.gkap[0] + T(0.5) * gKf[0];
            x.gkap[NZ - 1] = x.gkap[NZ - 1] + T(0.5) * gKf[NZ];
        } else {
#pragma unroll
            for (int k = 0; k < NZ; ++k) {
                gfs[k] = gd[k];
                gs[k] = gs[k] + gD[k] * water_chain_deriv<T>(xs[k], c, P);
            }
#pragma unroll
            for (int f_ = 0; f_ <= NZ; ++f_) x.gKeff[f_] = gKf[f_];
        }
    }
    rhs_adjoint<T, NZ, false>(U, sat, S, vtop, gU, gs, gS, gfU, gfs, gS * dt, x, gKsat, gskm,
                              c, P, dz, dzf, zc, zf);
}

// Cotangents through one iteration of picard_step() at its iterate (U,
// sat, S) before the iteration's closure, as implicit_step_adjoint: the
// closure, the tendencies, the terms and the rows are recomputed there, and
// each system is undone by one solve of its transposed rows. HEAT: the
// energy system alone. The first iteration (`later` false) reads the
// step's start: (gUn, gsn), the cotangents that the later iterations' right
// sides gave u^n (U and the closed saturation), join those of U and of the
// closed saturation before the closure's adjoint, and the pool takes its
// path as in implicit_step_adjoint. A later iteration's right side is
// tend(u_k) - (u_k - u^n) / dt (Un, sn: u^n), so each implicit variable's
// solve cotangent lambda gives -lambda / dt to the closed iterate and
// +lambda / dt to (gUn, gsn); its pool is dropped, so nothing reaches it
// (gS is left as it is).
template <typename T, int NZ, int SOLVER, bool HEAT>
SOIL_FN void picard_iter_adjoint(const T (&U)[NZ], const T (&sat)[NZ], const T S, const T vtop,
                                 const bool later, const T (&Un)[NZ], const T (&sn)[NZ],
                                 T (&gU)[NZ], T (&gs)[NZ], T& gS, T (&gUn)[NZ], T (&gsn)[NZ],
                                 T& gKsat, T& gskm, const Consts<T>& c,
                                 const SoilColumnParams& P, const T* dz, const T* dzf,
                                 const T* zc, const T* zf, const T dt, const T inv_dt,
                                 const int solver = SOLVER)
{
    T xs[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) xs[k] = sat[k];
    T xS = S;
    ImplicitTerms<T, NZ> f;
    closure_rhs<T, NZ, HEAT>(U, xs, xS, vtop, c, P, dz, dzf, zc, zf, f);
    TermCotangents<T, NZ> x;
    T gfU[NZ], gfs[NZ];
#pragma unroll 1
    for (int sys = HEAT ? 1 : 0; sys < 2; ++sys) {  // 0: Richards, 1: heat
        const bool heat = sys == 1;
        T Kf[NZ + 1], D[NZ], d[NZ], gx[NZ], gd[NZ], gKf[NZ + 1], gD[NZ];
        T a[NZ], b[NZ], cc[NZ], ga[NZ], gb[NZ], gc[NZ];
        Kf[0] = heat ? T(0.5) * (f.kap[0] + f.kap[0]) : f.Keff[0];
#pragma unroll
        for (int k = 1; k < NZ; ++k) Kf[k] = heat ? T(0.5) * (f.kap[k] + f.kap[k - 1]) : f.Keff[k];
        Kf[NZ] = heat ? T(0.5) * (f.kap[NZ - 1] + f.kap[NZ - 1]) : f.Keff[NZ];
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            D[k] = heat ? f.Dh[k] : water_chain<T>(xs[k], c, P);
            d[k] = heat ? f.U[k] : f.sat[k];
            if (later) d[k] = d[k] - ((heat ? U[k] : xs[k]) - (heat ? Un[k] : sn[k])) / dt;
            gx[k] = heat ? gU[k] : gs[k];
        }
        const T s = heat ? T(1) : c.inv_por;
        diffusion_rows<T, NZ>(Kf, D, s, inv_dt, dz, dzf, heat, a, b, cc);
        solve_adjoint<T, NZ, SOLVER>(a, b, cc, d, gx, gd, ga, gb, gc, solver);
        diffusion_rows_adjoint<T, NZ>(Kf, D, s, dz, dzf, heat, ga, gb, gc, gKf, gD);
        if (heat) {
#pragma unroll
            for (int k = 0; k < NZ; ++k) {
                gfU[k] = gd[k];
                x.gkap[k] = T(0.5) * (gKf[k] + gKf[k + 1]);
                x.gC[k] = -(gD[k] * f.Dh[k]) * f.Dh[k];  // Dh = 1/C, or 0 on the plateau
            }
            x.gkap[0] = x.gkap[0] + T(0.5) * gKf[0];
            x.gkap[NZ - 1] = x.gkap[NZ - 1] + T(0.5) * gKf[NZ];
        } else {
#pragma unroll
            for (int k = 0; k < NZ; ++k) {
                gfs[k] = gd[k];
                gs[k] = gs[k] + gD[k] * water_chain_deriv<T>(xs[k], c, P);
            }
#pragma unroll
            for (int f_ = 0; f_ <= NZ; ++f_) x.gKeff[f_] = gKf[f_];
        }
    }
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        if (later) {
            const T qU = gfU[k] / dt;
            gU[k] = gU[k] - qU;
            gUn[k] = gUn[k] + qU;
            if (!HEAT) {
                const T qs = gfs[k] / dt;
                gs[k] = gs[k] - qs;
                gsn[k] = gsn[k] + qs;
            }
        } else {
            gU[k] = gU[k] + gUn[k];
            if (!HEAT) gs[k] = gs[k] + gsn[k];
        }
    }
    T gSk = later ? T(0) : gS;
    rhs_adjoint<T, NZ, HEAT>(U, sat, S, vtop, gU, gs, gSk, gfU, gfs, gSk * dt, x, gKsat, gskm,
                             c, P, dz, dzf, zc, zf);
    if (!later) gS = gSk;
}

// Cotangents through one picard_step() with `iters` iterations, as
// step_adjoint. The iterations are undone from the last: for iteration k,
// the iterate u_k is recomputed from the step's stored start by
// picard_step's first k iterations (picard_step_call; nothing is stored per
// iteration), then
// picard_iter_adjoint takes it back to the iterate before it. The closed
// start u^n that the later iterations read is the start's sweeps.
template <typename T, int NZ, int SOLVER, bool HEAT>
SOIL_FN void picard_step_adjoint(const T (&U)[NZ], const T (&sat)[NZ], const T S, const T vtop,
                                 T (&gU)[NZ], T (&gs)[NZ], T& gS, T& gKsat, T& gskm,
                                 const Consts<T>& c, const SoilColumnParams& P, const T* dz,
                                 const T* dzf, const T* zc, const T* zf, const T dt,
                                 const T inv_dt, const int iters, const int solver = SOLVER)
{
    T sn[NZ], gUn[NZ], gsn[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) { sn[k] = sat[k]; gUn[k] = T(0); gsn[k] = T(0); }
    if constexpr (!HEAT) {
        T spill, wt;
        unsigned spilled, clipped;
        sweeps<T, NZ>(sn, spill, wt, spilled, clipped, dz, zf);
    }
#pragma unroll 1
    for (int it = iters - 1; it >= 0; --it) {
        T xU[NZ], xs[NZ], xS = S;
#pragma unroll
        for (int k = 0; k < NZ; ++k) { xU[k] = U[k]; xs[k] = sat[k]; }
        picard_step_call<T, NZ, SOLVER, HEAT>(xU, xs, xS, vtop, c, P, dz, dzf, zc, zf, dt,
                                              inv_dt, it, solver);
        picard_iter_adjoint<T, NZ, SOLVER, HEAT>(xU, xs, xS, vtop, it > 0, U, sn, gU, gs, gS,
                                                 gUn, gsn, gKsat, gskm, c, P, dz, dzf, zc, zf,
                                                 dt, inv_dt, solver);
    }
}

// The segment VJP of one column by STEPPER (SOLVER; PICARD: picard_step
// with `iters` iterations, SOLVER_RUNTIME taking `solver`) over heat +
// Richards or, HEAT, the heat-only
// model (ForwardEuler, Heun or picard_step): `steps` forward steps
// from the segment input carry, each step's input carry stored to `scratch`
// (laid out [step][row][cell], rows U[0..NZ), sat[0..NZ), S, or U alone
// for HEAT, whose saturation the steps never change, so neighbouring
// columns touch neighbouring addresses), then the reverse sweep of the
// step's adjoint from the output cotangents. The top temperature of step i
// is top_T[i * top_step_stride] of the column (Heun also reads row i + 1).
// Writes the input cotangents (HEAT: gU_in and gsat_in, the saturation's
// gathered over the steps); adds the parameter cotangents to gKsat and
// gskm.
template <typename T, int NZ, int STEPPER = STEPPER_EULER, int SOLVER = SOLVER_THOMAS,
          bool HEAT = false, bool PICARD = false>
SOIL_FN void segment_vjp_column(
    const long long col, const long long cells, const int steps,
    const T* U_in, const T* sat_in, const T* S_in,
    const T* gU_out, const T* gsat_out, const T* gS_out,
    T* gU_in, T* gsat_in, T* gS_in, T* scratch,
    const T* top_T, const long long top_step_stride, const long long top_cell_stride,
    const Consts<T>& c, const SoilColumnParams& P,
    const T* dz, const T* dzf, const T* zc, const T* zf, const T dt, const T inv_dt,
    T& gKsat, T& gskm, const int iters = 1, const int solver = SOLVER)
{
    static_assert(!(STEPPER == STEPPER_IMPLICIT && HEAT && !PICARD),
                  "the heat-only implicit segment VJP is picard_step's");
    const long long rows = HEAT ? NZ : 2 * NZ + 1;
    T U[NZ], sat[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        U[k] = U_in[k * cells + col];
        sat[k] = sat_in[k * cells + col];
    }
    T S = HEAT ? T(0) : S_in[col];
    for (int i = 0; i < steps; ++i) {
        T* rec = scratch + (long long)i * rows * cells + col;
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            rec[k * cells] = U[k];
            if (!HEAT) rec[(NZ + k) * cells] = sat[k];
        }
        if (!HEAT) rec[2 * NZ * cells] = S;
        const T vtop = top_T[i * top_step_stride + col * top_cell_stride];
        if constexpr (STEPPER == STEPPER_HEUN) {
            const T v1 = top_T[(i + 1) * top_step_stride + col * top_cell_stride];
            heun_step<T, NZ, HEAT>(U, sat, S, vtop, v1, c, P, dz, dzf, zc, zf, dt);
        } else if constexpr (STEPPER == STEPPER_IMPLICIT && PICARD) {
            picard_step_call<T, NZ, SOLVER, HEAT>(U, sat, S, vtop, c, P, dz, dzf, zc, zf, dt,
                                                  inv_dt, iters, solver);
        } else if constexpr (STEPPER == STEPPER_IMPLICIT) {
            implicit_step<T, NZ, SOLVER>(U, sat, S, vtop, c, P, dz, dzf, zc, zf, dt, inv_dt);
        } else {
            step<T, NZ, HEAT>(U, sat, S, vtop, c, P, dz, dzf, zc, zf, dt);
        }
    }

    T gU[NZ], gs[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        gU[k] = gU_out[k * cells + col];
        gs[k] = gsat_out[k * cells + col];
    }
    T gS = HEAT ? T(0) : gS_out[col];
    for (int i = steps - 1; i >= 0; --i) {
        const T* rec = scratch + (long long)i * rows * cells + col;
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            U[k] = rec[k * cells];
            if (!HEAT) sat[k] = rec[(NZ + k) * cells];
        }
        if (!HEAT) S = rec[2 * NZ * cells];
        const T vtop = top_T[i * top_step_stride + col * top_cell_stride];
        if constexpr (STEPPER == STEPPER_HEUN) {
            const T v1 = top_T[(i + 1) * top_step_stride + col * top_cell_stride];
            heun_step_adjoint<T, NZ, HEAT>(U, sat, S, vtop, v1, gU, gs, gS, gKsat, gskm, c, P, dz,
                                           dzf, zc, zf, dt);
        } else if constexpr (STEPPER == STEPPER_IMPLICIT && PICARD) {
            picard_step_adjoint<T, NZ, SOLVER, HEAT>(U, sat, S, vtop, gU, gs, gS, gKsat, gskm, c,
                                                     P, dz, dzf, zc, zf, dt, inv_dt, iters,
                                                     solver);
        } else if constexpr (STEPPER == STEPPER_IMPLICIT) {
            implicit_step_adjoint<T, NZ, SOLVER>(U, sat, S, vtop, gU, gs, gS, gKsat, gskm, c, P,
                                                 dz, dzf, zc, zf, dt, inv_dt);
        } else {
            step_adjoint<T, NZ, HEAT>(U, sat, S, vtop, gU, gs, gS, gKsat, gskm, c, P, dz, dzf,
                                      zc, zf, dt);
        }
    }
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        gU_in[k * cells + col] = gU[k];
        gsat_in[k * cells + col] = gs[k];
    }
    if (!HEAT) gS_in[col] = gS;
}

}  // namespace soil
