// One closure-rotated soil step on one column, and its adjoint.
//
// Shared by csrc/soil_column_rollout.cu (the forward rollout) and
// csrc/soil_column_segment_vjp.cu (the segment VJP), so that the VJP kernel's
// forward reproduces the rollout kernel's carries bit for bit. The step is
// ForwardEuler.pre_closure_step of the main-path SoilModel: closure
// (saturation adjustment, water table, pressure head, energy -> temperature),
// centre and face hydraulic conductivity, heat and Darcy fluxes, explicit
// update. ops/fused_step.py::_plain_step is its plain PyTorch version, in the
// same order of operations.
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
#else
#define SOIL_FN inline
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
          p_inv_m(T(P.p_inv_m)), p_inv_n(T(P.p_inv_n)), p_k1(T(P.p_k1)), p_k2(T(P.p_k2)) {}
};

// The closure and conductivities of one level from its adjusted saturation
// and energy: FreeWater liquid fraction and temperature, heat capacity, bulk
// thermal conductivity, Mualem-van Genuchten centre conductivity
// (hydraulics.py:50-87).
template <typename T>
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

// One pre_closure_step of the column (U, sat, S) in place; vtop is the top
// temperature of this step.
template <typename T, int NZ>
SOIL_FN void step(T (&U)[NZ], T (&sat)[NZ], T& S, const T vtop, const Consts<T>& c,
                  const SoilColumnParams& P, const T* dz, const T* dzf, const T* zc,
                  const T* zf, const T dt)
{
    T Kc[NZ];

    // ---- closure: saturation adjustment and water table
    T spill, wt;
    unsigned spilled, clipped;
    sweeps<T, NZ>(sat, spill, wt, spilled, clipped, dz, zf);
    S = S + spill;

    // ---- energy closure, centre conductivities, heat flux, energy update
    T T_prev = T(0), kap_prev = T(0), qh_prev = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        const Level<T> v(sat[k], U[k], c, P);
        Kc[k] = v.Kc;
        // heat flux at the face below cell k; zero gradient at the bottom
        const T kf = T(0.5) * (v.kap + (k == 0 ? v.kap : kap_prev));
        const T qh = -kf * ((v.Tk - (k == 0 ? v.Tk : T_prev)) / dzf[k]);
        if (k > 0) U[k - 1] = U[k - 1] + (-((qh - qh_prev) / dz[k - 1])) * dt;
        qh_prev = qh;
        T_prev = v.Tk;
        kap_prev = v.kap;
    }
    {   // top face: Dirichlet ghost 2*v - T_top
        const T ghost = T(2) * vtop - T_prev;
        const T kf = T(0.5) * (kap_prev + kap_prev);
        const T qh = -kf * ((ghost - T_prev) / dzf[NZ]);
        U[NZ - 1] = U[NZ - 1] + (-((qh - qh_prev) / dz[NZ - 1])) * dt;
    }

    // ---- pressure head, Darcy flux with upwind-min face K, water update
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
        if (k > 0) sat[k - 1] = sat[k - 1] + ((-((qw - qw_prev) / dz[k - 1])) / c.por) * dt;
        qw_prev = qw;
        psi_prev = psi_k;
    }
    S = S + vmin(T(0), S) * dt;  // parity surface-pool term +min(0, S)
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
// conductivity and centre hydraulic conductivity; the parameter
// cotangents (K_sat, sk_mineral) are accumulated
template <typename T>
SOIL_FN void level_adjoint(const Level<T>& v, const T sk, const T Uk, const T gT, const T gkap,
                           const T gKc, const Consts<T>& c, const SoilColumnParams& P,
                           T& gs, T& gU, T& gKsat, T& gskm)
{
    // kap = acc * acc; acc = sum of sqrt(k_i) * fractions + sk_mineral + ...
    const T gacc = gkap * v.acc + gkap * v.acc;
    gskm += gacc;
    T gwater = c.sk_water * gacc, gice = c.sk_ice * gacc, gair = c.sk_air * gacc;
    T gliq = T(0), gLt = T(0), gI = T(0);

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

// Cotangents through one step(): on entry (gU, gs, gS) are those of the
// step's output, on return those of its input (U, sat, S); the parameter
// cotangents are accumulated into gKsat and gskm. The step is recomputed
// from its input carry.
template <typename T, int NZ>
SOIL_FN void step_adjoint(const T (&U)[NZ], const T (&sat)[NZ], const T S, const T vtop,
                          T (&gU)[NZ], T (&gs)[NZ], T& gS, T& gKsat, T& gskm,
                          const Consts<T>& c, const SoilColumnParams& P, const T* dz,
                          const T* dzf, const T* zc, const T* zf, const T dt)
{
    // ---- recompute: sweeps with their predicates, closure, conductivities
    T s[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) s[k] = sat[k];
    T spill, wt;
    unsigned spilled, clipped;
    sweeps<T, NZ>(s, spill, wt, spilled, clipped, dz, zf);
    const T S1 = S + spill;
    T Tk[NZ], kap[NZ], Kc[NZ], psi[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        const Level<T> v(s[k], U[k], c, P);
        Tk[k] = v.Tk;
        kap[k] = v.kap;
        Kc[k] = v.Kc;
        psi[k] = Head<T>(s[k], wt, zc[k], c, P).psi;
    }

    // ---- surface pool: S' = S1 + min(0, S1) * dt
    const T gS1 = S1 < T(0) ? gS + gS * dt : gS;

    // ---- water update and Darcy flux; the boundary faces carry no flux
    // (zero-gradient ghosts), so only interior faces f = 1 .. NZ-1 count
    T gKf[NZ + 1], gpsi[NZ];
#pragma unroll
    for (int f = 0; f <= NZ; ++f) gKf[f] = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) gpsi[k] = T(0);
#pragma unroll
    for (int f = 1; f < NZ; ++f) {
        // sat'[k] = sat[k] + ((-((qw[k+1] - qw[k]) / dz[k])) / por) * dt
        const T glo = -((gs[f - 1] * dt) / c.por) / dz[f - 1];
        const T ghi = -((gs[f] * dt) / c.por) / dz[f];
        const T gqw = glo - ghi;
        const T grad = (psi[f] - psi[f - 1]) / dzf[f];
        const T K_f = face_K<T, NZ>(Kc, f);
        const T K_lo = face_K<T, NZ>(Kc, f - 1);
        const T K_hi = face_K<T, NZ>(Kc, f + 1);
        const T K_eff = grad < T(0) ? vmin(K_lo, K_f) : vmin(K_f, K_hi);
        const T gK = -gqw * grad;
        const T ggrad = -gqw * K_eff;
        if (grad < T(0)) min_adjoint(K_lo, K_f, gK, gKf[f - 1], gKf[f]);
        else min_adjoint(K_f, K_hi, gK, gKf[f], gKf[f + 1]);
        gpsi[f] += ggrad / dzf[f];
        gpsi[f - 1] -= ggrad / dzf[f];
    }
    // face K from centre K
    T gKc[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) gKc[k] = T(0);
    gKc[0] += gKf[0];
#pragma unroll
    for (int f = 1; f < NZ - 1; ++f) min_adjoint(Kc[f - 1], Kc[f], gKf[f], gKc[f - 1], gKc[f]);
    gKc[NZ - 1] += gKf[NZ - 1] + gKf[NZ];

    // ---- energy update and heat flux (face 0 carries no flux)
    T gT[NZ], gkap[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) { gT[k] = T(0); gkap[k] = T(0); }
#pragma unroll
    for (int f = 1; f <= NZ; ++f) {
        // U'[k] = U[k] + (-((qh[k+1] - qh[k]) / dz[k])) * dt
        const T glo = -(gU[f - 1] * dt) / dz[f - 1];
        const T ghi = f < NZ ? -(gU[f] * dt) / dz[f] : T(0);
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

    // ---- pressure head and closure, level by level
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        T gsk = gs[k];  // identity of the water update
        // psi = psi_h + psi_m + (z - z_top); psi_m = max(raw, psi_min) below
        // saturation, raw = -(1/alpha) * (ss^(-1/m) - 1)^(1/n), ss = clip(se)
        const Head<T> h(s[k], wt, zc[k], c, P);
        if (!(h.se >= T(1)) && h.raw >= c.psi_min && h.se >= c.vg_se_lo
            && h.se <= c.vg_se_hi) {
            const T gX = gpsi[k] * c.neg_inv_alpha * dfpow(h.X, P.num_inv_n, P.den_inv_n,
                                                           c.p_inv_n);
            const T gss = gX * dfpow(h.ss, P.num_inv_m, P.den_inv_m, c.p_inv_m);
            gsk += (gss / c.vg_span) * c.por;
        }
        const Level<T> v(s[k], U[k], c, P);
        T gUk = gU[k];  // identity of the energy update
        level_adjoint(v, s[k], U[k], gT[k], gkap[k], gKc[k], c, P, gsk, gUk, gKsat, gskm);
        gs[k] = gsk;
        gU[k] = gUk;
    }

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

// The segment VJP of one column: `steps` forward steps from the segment
// input carry, each step's input carry stored to `scratch` (laid out
// [step][row][cell], rows U[0..NZ), sat[0..NZ), S, so neighbouring columns
// touch neighbouring addresses), then the reverse sweep of step_adjoint from
// the output cotangents. Writes the input cotangents; adds the parameter
// cotangents to gKsat and gskm.
template <typename T, int NZ>
SOIL_FN void segment_vjp_column(
    const long long col, const long long cells, const int steps,
    const T* U_in, const T* sat_in, const T* S_in,
    const T* gU_out, const T* gsat_out, const T* gS_out,
    T* gU_in, T* gsat_in, T* gS_in, T* scratch,
    const T* top_T, const long long top_step_stride, const long long top_cell_stride,
    const Consts<T>& c, const SoilColumnParams& P,
    const T* dz, const T* dzf, const T* zc, const T* zf, const T dt,
    T& gKsat, T& gskm)
{
    const long long rows = 2 * NZ + 1;
    T U[NZ], sat[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        U[k] = U_in[k * cells + col];
        sat[k] = sat_in[k * cells + col];
    }
    T S = S_in[col];
    for (int i = 0; i < steps; ++i) {
        T* rec = scratch + (long long)i * rows * cells + col;
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            rec[k * cells] = U[k];
            rec[(NZ + k) * cells] = sat[k];
        }
        rec[2 * NZ * cells] = S;
        const T vtop = top_T[i * top_step_stride + col * top_cell_stride];
        step<T, NZ>(U, sat, S, vtop, c, P, dz, dzf, zc, zf, dt);
    }

    T gU[NZ], gs[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        gU[k] = gU_out[k * cells + col];
        gs[k] = gsat_out[k * cells + col];
    }
    T gS = gS_out[col];
    for (int i = steps - 1; i >= 0; --i) {
        const T* rec = scratch + (long long)i * rows * cells + col;
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            U[k] = rec[k * cells];
            sat[k] = rec[(NZ + k) * cells];
        }
        S = rec[2 * NZ * cells];
        const T vtop = top_T[i * top_step_stride + col * top_cell_stride];
        step_adjoint<T, NZ>(U, sat, S, vtop, gU, gs, gS, gKsat, gskm, c, P, dz, dzf, zc, zf, dt);
    }
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        gU_in[k * cells + col] = gU[k];
        gsat_in[k * cells + col] = gs[k];
    }
    gS_in[col] = gS;
}

}  // namespace soil
