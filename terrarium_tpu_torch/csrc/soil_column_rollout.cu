// Soil heat + Richards column rollout for Hopper (sm_90a).
//
// Replaces terrarium_tpu/ops/fused_step.py::make_fused_lean_rollout for its
// main-path specialisation: SoilModel with two-phase heat conduction and the
// free-water freeze curve, Richards flow with
// ConstantSoilHydraulics(VanGenuchten, UnsatKVanGenuchten), ForwardEuler, a
// Dirichlet top temperature, no input sources.
//
// One thread owns one column and runs `steps` applications of
// ForwardEuler.pre_closure_step on it: closure (saturation adjustment, water
// table, pressure head, energy -> temperature), centre and face hydraulic
// conductivity, heat and Darcy fluxes, explicit update. The live carry
// (internal energy, saturation, surface pool) is read once and written once
// per launch; everything else lives in registers for the whole launch.
//
// What bounds it on this card: arithmetic (FP32 or FP64 ALU, with a pow,
// a cube root and four square roots per level and step) and registers, not
// HBM bytes: the carry is 61 values per column, read and written once per
// launch, against thousands of operations per column and step. The column
// is kept in fully unrolled per-thread register arrays (template NZ, unrolled
// z-loops), so the two sweeps and the face stencils are register-to-register
// recurrences with constant indices. About 3*NZ values are live per thread
// (energy, saturation, centre conductivity) plus temporaries; the grid
// coordinates sit in shared memory.
//
// Memory layout: fields are (NZ, cells) with k = 0 the bottom layer; element
// (k, col) is at k*cells + col, so neighbouring threads touch neighbouring
// addresses. The ragged tail is masked with col < cells.
//
// Plain C interface, loaded with ctypes: each entry point returns
// cudaGetLastError() after the launch (or -1 for an unsupported NZ).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

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

namespace {

template <typename T> struct Eps;
template <> struct Eps<float> { static __device__ __forceinline__ float v() { return FLT_EPSILON; } };
template <> struct Eps<double> { static __device__ __forceinline__ double v() { return DBL_EPSILON; } };

__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_cbrt(float x) { return cbrtf(x); }
__device__ __forceinline__ double d_cbrt(double x) { return cbrt(x); }
__device__ __forceinline__ float d_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double d_pow(double x, double y) { return pow(x, y); }

// max/min that return NaN when either argument is NaN, as torch.maximum,
// torch.minimum and torch.clamp do
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return (a != a || a > b) ? a : b; }
template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return (a != a || a < b) ? a : b; }

// x**k by binary powering in the order of ops/fastpow.py::_ipow (k != 0)
template <typename T>
__device__ __forceinline__ T ipow(T x, int k) {
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
__device__ __forceinline__ T fpow(T x, int num, int den, T p) {
    if (den == 0) return d_pow(x, p);
    if (num == 0) return T(1);
    const T root = den == 1 ? x : (den == 2 ? d_sqrt(x) : d_cbrt(x));
    return ipow(root, num);
}

// utils.safediv: x / (y + eps) where y != 0, else +inf
template <typename T>
__device__ __forceinline__ T safediv(T x, T y) {
    return y == T(0) ? T(INFINITY) : x / (y + Eps<T>::v());
}

// face conductivity (hydrology.py:128-148): bottom face = bottom centre,
// interior faces = min of the two neighbours, both top faces = top centre.
// Called with compile-time f inside unrolled loops, so Kc stays in registers.
template <typename T, int NZ>
__device__ __forceinline__ T face_K(const T (&Kc)[NZ], int f) {
    if (f == 0) return Kc[0];
    if (f >= NZ - 1) return Kc[NZ - 1];
    return vmin(Kc[f - 1], Kc[f]);
}

template <typename T, int NZ>
__global__ void __launch_bounds__(64) soil_column_rollout_kernel(
    const T* __restrict__ U_in, const T* __restrict__ sat_in, const T* __restrict__ S_in,
    T* __restrict__ U_out, T* __restrict__ sat_out, T* __restrict__ S_out,
    const T* __restrict__ top_T, long long top_step_stride, long long top_cell_stride,
    const T* __restrict__ dz_g, const T* __restrict__ dzf_g,
    const T* __restrict__ zc_g, const T* __restrict__ zf_g,
    const SoilColumnParams P, const int steps, const T dt, const long long cells)
{
    __shared__ T dz[NZ], dzf[NZ + 1], zc[NZ], zf[NZ + 1];
    for (int i = threadIdx.x; i < NZ + 1; i += blockDim.x) {
        if (i < NZ) { dz[i] = dz_g[i]; zc[i] = zc_g[i]; }
        dzf[i] = dzf_g[i];
        zf[i] = zf_g[i];
    }
    __syncthreads();
    const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= cells) return;

    const T por = T(P.por), L = T(P.L);
    const T c_water = T(P.c_water), c_ice = T(P.c_ice), c_air = T(P.c_air);
    const T c_mineral = T(P.c_mineral), c_organic = T(P.c_organic);
    const T sk_water = T(P.sk_water), sk_ice = T(P.sk_ice), sk_air = T(P.sk_air);
    const T sk_mineral = T(P.sk_mineral), sk_organic = T(P.sk_organic);
    const T theta_res = T(P.theta_res), vg_span = T(P.vg_span);
    const T neg_inv_alpha = T(P.neg_inv_alpha), psi_min = T(P.psi_min);
    const T vg_se_lo = T(P.vg_se_lo), vg_se_hi = T(P.vg_se_hi);
    const T K_sat = T(P.K_sat), neg_impedance = T(P.neg_impedance);
    const T k_theta_sat = T(P.k_theta_sat), k_se_hi = T(P.k_se_hi), eps_lo = T(P.eps_lo);
    const T z_top = T(P.z_top);
    const T p_inv_m = T(P.p_inv_m), p_inv_n = T(P.p_inv_n);
    const T p_k1 = T(P.p_k1), p_k2 = T(P.p_k2);

    T U[NZ], sat[NZ], Kc[NZ];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        U[k] = U_in[k * cells + col];
        sat[k] = sat_in[k * cells + col];
    }
    T S = S_in[col];

    for (int s = 0; s < steps; ++s) {
        const T vtop = top_T[s * top_step_stride + col * top_cell_stride];

        // ---- closure: saturation adjustment (hydrology.py:181), up sweep
        T c = T(0);
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            const T sk = sat[k];
            sat[k] = vmin(sk + c / dz[k], T(1));
            c = vmax((sk - T(1)) * dz[k] + c, T(0));
        }
        S = S + c;  // spill past the top layer, unscaled (parity mode)

        // down sweep, and the water table: the face below the lowest cell
        // with sat < 1, the surface when every cell is saturated
        T c2 = T(0), wt = zf[NZ];
#pragma unroll
        for (int k = NZ - 1; k >= 0; --k) {
            const T su = sat[k];
            sat[k] = vmax(su - c2 / dz[k], T(0));
            c2 = vmax(-su * dz[k] + c2, T(0));
            if (sat[k] < T(1)) wt = zf[k];
        }

        // ---- energy closure, centre conductivities, heat flux, energy update
        T T_prev = T(0), kap_prev = T(0), qh_prev = T(0);
#pragma unroll
        for (int k = 0; k < NZ; ++k) {
            const T sk = sat[k], Uk = U[k];
            const T L_theta = L * sk * por;
            const T negL = -L_theta;
            const T liq = Uk >= T(0) ? T(1)
                        : (Uk >= negL ? T(1) - safediv(Uk, negL) : T(0));
            const T wi = sk * por;
            const T water = wi * liq, ice = wi * (T(1) - liq), air = (T(1) - sk) * por;
            const T C = c_water * water + c_ice * ice + c_air * air + c_mineral + c_organic;
            const T Tk = Uk < negL ? (Uk + L_theta) / C : (Uk >= T(0) ? Uk / C : T(0));
            const T acc = sk_water * water + sk_ice * ice + sk_air * air + sk_mineral + sk_organic;
            const T kap = acc * acc;

            // Mualem-van Genuchten centre conductivity (hydraulics.py:50-87)
            const T I_ice = d_pow(T(10), neg_impedance * (T(1) - liq));
            const T se = vmin(vmax(water / k_theta_sat, T(0)), T(1));
            const bool frozen = se <= eps_lo;
            const T se_s = frozen ? eps_lo : vmin(se, k_se_hi);
            const T inner = T(1) - fpow(T(1) - fpow(se_s, P.num_k1, P.den_k1, p_k1),
                                        P.num_k2, P.den_k2, p_k2);
            const T K_unsat = frozen ? T(0) : K_sat * I_ice * d_sqrt(se_s) * (inner * inner);
            Kc[k] = se >= T(1) ? K_sat * I_ice : K_unsat;

            // heat flux at the face below cell k; zero gradient at the bottom
            const T kf = T(0.5) * (kap + (k == 0 ? kap : kap_prev));
            const T qh = -kf * ((Tk - (k == 0 ? Tk : T_prev)) / dzf[k]);
            if (k > 0) U[k - 1] = U[k - 1] + (-((qh - qh_prev) / dz[k - 1])) * dt;
            qh_prev = qh;
            T_prev = Tk;
            kap_prev = kap;
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
            T psi_k = psi_prev;
            if (k < NZ) {
                const T se = (sat[k] * por - theta_res) / vg_span;
                const T ss = vmin(vmax(se, vg_se_lo), vg_se_hi);
                T psi = neg_inv_alpha * fpow(fpow(ss, P.num_inv_m, P.den_inv_m, p_inv_m) - T(1),
                                             P.num_inv_n, P.den_inv_n, p_inv_n);
                psi = vmax(psi, psi_min);
                const T psi_m = se >= T(1) ? T(0) : psi;
                const T psi_h = vmax(wt - zc[k], T(0));
                psi_k = psi_h + psi_m + (zc[k] - z_top);
            }
            // face k: zero-gradient ghosts at both ends
            const T lower = k == 0 ? psi_k : psi_prev;
            const T grad = (psi_k - lower) / dzf[k];
            const T K_lo = k == 0 ? T(INFINITY) : face_K<T, NZ>(Kc, k - 1);
            const T K_hi = k == NZ ? T(INFINITY) : face_K<T, NZ>(Kc, k + 1);
            const T K_k = face_K<T, NZ>(Kc, k);
            const T K_eff = grad < T(0) ? vmin(K_lo, K_k) : vmin(K_k, K_hi);
            const T qw = -K_eff * grad;
            if (k > 0) sat[k - 1] = sat[k - 1] + ((-((qw - qw_prev) / dz[k - 1])) / por) * dt;
            qw_prev = qw;
            psi_prev = psi_k;
        }
        S = S + vmin(T(0), S) * dt;  // parity surface-pool term +min(0, S)
    }

#pragma unroll
    for (int k = 0; k < NZ; ++k) {
        U_out[k * cells + col] = U[k];
        sat_out[k * cells + col] = sat[k];
    }
    S_out[col] = S;
}

template <typename T, int NZ>
int launch(const T* U_in, const T* sat_in, const T* S_in, T* U_out, T* sat_out, T* S_out,
           const T* top_T, long long top_step_stride, long long top_cell_stride,
           const T* dz, const T* dzf, const T* zc, const T* zf,
           const SoilColumnParams* P, int steps, double dt, long long cells,
           cudaStream_t stream)
{
    const int threads = 64;
    const unsigned blocks = (unsigned)((cells + threads - 1) / threads);
    soil_column_rollout_kernel<T, NZ><<<blocks, threads, 0, stream>>>(
        U_in, sat_in, S_in, U_out, sat_out, S_out, top_T, top_step_stride,
        top_cell_stride, dz, dzf, zc, zf, *P, steps, T(dt), cells);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* U_in, const T* sat_in, const T* S_in, T* U_out, T* sat_out, T* S_out,
             const T* top_T, long long top_step_stride, long long top_cell_stride,
             const T* dz, const T* dzf, const T* zc, const T* zf,
             const SoilColumnParams* P, int nz, int steps, double dt, long long cells,
             void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    switch (nz) {
    case 20:
        return launch<T, 20>(U_in, sat_in, S_in, U_out, sat_out, S_out, top_T, top_step_stride,
                             top_cell_stride, dz, dzf, zc, zf, P, steps, dt, cells, st);
    case 30:
        return launch<T, 30>(U_in, sat_in, S_in, U_out, sat_out, S_out, top_T, top_step_stride,
                             top_cell_stride, dz, dzf, zc, zf, P, steps, dt, cells, st);
    default:
        return -1;
    }
}

}  // namespace

extern "C" int soil_column_rollout_f32(
    const float* U_in, const float* sat_in, const float* S_in,
    float* U_out, float* sat_out, float* S_out,
    const float* top_T, long long top_step_stride, long long top_cell_stride,
    const float* dz, const float* dzf, const float* zc, const float* zf,
    const SoilColumnParams* P, int nz, int steps, double dt, long long cells, void* stream)
{
    return dispatch<float>(U_in, sat_in, S_in, U_out, sat_out, S_out, top_T, top_step_stride,
                           top_cell_stride, dz, dzf, zc, zf, P, nz, steps, dt, cells, stream);
}

extern "C" int soil_column_rollout_f64(
    const double* U_in, const double* sat_in, const double* S_in,
    double* U_out, double* sat_out, double* S_out,
    const double* top_T, long long top_step_stride, long long top_cell_stride,
    const double* dz, const double* dzf, const double* zc, const double* zf,
    const SoilColumnParams* P, int nz, int steps, double dt, long long cells, void* stream)
{
    return dispatch<double>(U_in, sat_in, S_in, U_out, sat_out, S_out, top_T, top_step_stride,
                            top_cell_stride, dz, dzf, zc, zf, P, nz, steps, dt, cells, stream);
}
