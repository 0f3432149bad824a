// The repository's three probe kernels, written for Hopper: one source,
// one instantiation per probe and dtype (``cuda_build.INSTANTIATIONS``,
// the tag selects the probe through PROBE_ROW).
//
// * PROBE_ROW 4 replaces experiments/roofline_census.py:260
//   ``run_micro.make``: R dependent operations on every element of an
//   (256, 65,536) array, one thread per element, the R-long chain kept in
//   a register and stored at the end (nothing to fold: every step reads the
//   one before). Kinds: 0 fma (v * 1.0000001 + 1e-7), 1 fma4 (four
//   independent fma chains from x, x + 1, x + 2, x + 3, summed at the
//   end), 2 exp (exp(1e-3 v)), 3 div (1.00001 / (v + 1.5)), 4 pow ((v +
//   1.5)^0.7071). It measures what these operations cost as the port's
//   kernels emit them: the same nvcc flags (-O3, no fast-math; the float32
//   build contracts v * a + b into one FMA, the float64 build, which the
//   checks hold to the plain version, is compiled with -fmad=false), the
//   same instruction selection for '/', exp and pow. Bound: operations
//   (R per element, the FP32 peak), far above its 2 x 4 B an element.
// * PROBE_ROW 5 replaces experiments/mosaic_bisect.py:29 ``run_case``:
//   an (NZ, cells) row-major array, one thread per cell so that the reads
//   and writes of a level coalesce across cells, the NZ levels held in
//   registers. Cases: 0 elementwise (2x + 1), 1 stencil (edge-replicated
//   up - 2x + dn), 2 cummin (the prefix minimum over the levels, k = 0
//   first, sequentially), 3 closure (the probe's own telescoped saturation
//   adjustment, `:67-107`: S = cumsum((x - 1) dz), M = min(cummin(S), 0),
//   sat_up = 1 + (M - M_in) / dz, S2 = ZM_in - ZM_top with ZM = cumsum(dz)
//   + M, the reverse cummin of S2, the clip at 0; sequentially, not the
//   TPU's doubling scans). Bound: bytes, one read and one write of the
//   array.
// * PROBE_ROW 6 replaces experiments/mosaic_min_repro.py:72
//   ``run_variant``: INNER iterations of ``_kernel_factory(variant)``'s body
//   over T (NZ, 256) and s (1, 256), one thread per column, T's levels and
//   s in registers. Variants: 0 xy_only, 1 row_to_xy, 2 row_to_xy_masksum
//   (the top row read directly: the masked sum of one row and zeros is
//   that row), 3 row_to_xy_branch (the two-branch Magnus exponential), 4
//   row_to_xy_stencil (the zero-filled z-stencil). On the TPU it
//   reproduced a Mosaic compiler crash (layout.h:320); here it is a tiny
//   correct kernel whose time is the launch latency.
//
// Products whose rounding the plain PyTorch version takes on its own (a
// product added to something) are written __fmul_rn / __dmul_rn, so that
// nvcc does not contract them into an FMA and the kernel rounds as the
// plain version does; row 4's chains keep nvcc's contraction, which is
// what the port's kernels get.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

typedef SOIL_T T;

namespace {

__device__ __forceinline__ float p_exp(float x) { return expf(x); }
__device__ __forceinline__ double p_exp(double x) { return exp(x); }
__device__ __forceinline__ float p_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double p_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float p_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double p_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ T p_min(T a, T b) { return a < b ? a : b; }
__device__ __forceinline__ T p_max(T a, T b) { return a > b ? a : b; }

constexpr int THREADS = 256;

inline unsigned blocks(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

#if PROBE_ROW == 4

template <int KIND>
__global__ void __launch_bounds__(THREADS)
micro_chain(const T* __restrict__ x, T* __restrict__ out, long long n, int R) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const T a = T(1.0000001), b = T(1e-7);
  T v = x[i];
  if (KIND == 1) {
    const T a0 = T(1.0000001 + 1e-9 * 0), a1 = T(1.0000001 + 1e-9 * 1),
            a2 = T(1.0000001 + 1e-9 * 2), a3 = T(1.0000001 + 1e-9 * 3);
    T v0 = v, v1 = v + T(1), v2 = v + T(2), v3 = v + T(3);
#pragma unroll 8
    for (int r = 0; r < R; ++r) {
      v0 = v0 * a0 + b;
      v1 = v1 * a1 + b;
      v2 = v2 * a2 + b;
      v3 = v3 * a3 + b;
    }
    out[i] = ((v0 + v1) + v2) + v3;
    return;
  }
#pragma unroll 8
  for (int r = 0; r < R; ++r) {
    if (KIND == 0) v = v * a + b;
    if (KIND == 2) v = p_exp(v * T(1e-3));
    if (KIND == 3) v = T(1.00001) / (v + T(1.5));
    if (KIND == 4) v = p_pow(v + T(1.5), T(0.7071));
  }
  out[i] = v;
}

}  // namespace

// x, out: n contiguous elements; kind 0-4 as above; R >= 0 chain steps.
extern "C" int SOIL_ENTRY(const T* x, T* out, long long n, int kind, int R,
                          cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (kind) {
    case 0: micro_chain<0><<<blocks(n), THREADS, 0, stream>>>(x, out, n, R); break;
    case 1: micro_chain<1><<<blocks(n), THREADS, 0, stream>>>(x, out, n, R); break;
    case 2: micro_chain<2><<<blocks(n), THREADS, 0, stream>>>(x, out, n, R); break;
    case 3: micro_chain<3><<<blocks(n), THREADS, 0, stream>>>(x, out, n, R); break;
    case 4: micro_chain<4><<<blocks(n), THREADS, 0, stream>>>(x, out, n, R); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#elif PROBE_ROW == 5

constexpr int NZ = SOIL_NZ;

template <int CASE>
__global__ void __launch_bounds__(THREADS)
bisect_case(const T* __restrict__ x, const T* __restrict__ dz, T* __restrict__ out,
            long long cells) {
  const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (c >= cells) return;
  T v[NZ];
#pragma unroll
  for (int k = 0; k < NZ; ++k) v[k] = x[k * cells + c];
  T o[NZ];
  if (CASE == 0) {
#pragma unroll
    for (int k = 0; k < NZ; ++k) o[k] = v[k] * T(2) + T(1);
  } else if (CASE == 1) {
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      const T up = v[k + 1 < NZ ? k + 1 : NZ - 1], dn = v[k > 0 ? k - 1 : 0];
      o[k] = (up - T(2) * v[k]) + dn;
    }
  } else if (CASE == 2) {
    T m = v[0];
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      m = p_min(m, v[k]);
      o[k] = m;
    }
  } else {
    // S = cumsum(a), M = min(cummin(S), 0), with a = (x - 1) dz
    T M[NZ];
    T S = T(0), m = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      S = S + p_mul(v[k] - T(1), dz[k]);
      m = k == 0 ? S : p_min(m, S);
      M[k] = p_min(m, T(0));
    }
    // ZM = cumsum(dz) + M; S2[k] = ZM[k - 1] (0 at k = 0) - ZM[NZ - 1]
    T ZM[NZ];
    T Z = T(0);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      Z = Z + dz[k];
      ZM[k] = Z + M[k];
    }
    // c2 = S2 - min(reverse cummin(S2), 0); the clip reads c2 one level up
    T c2_up = T(0), rmin = T(0);
#pragma unroll
    for (int k = NZ - 1; k >= 0; --k) {
      const T sat_up = T(1) + (M[k] - (k > 0 ? M[k - 1] : T(0))) / dz[k];
      o[k] = p_max(sat_up - c2_up / dz[k], T(0));
      const T S2 = (k > 0 ? ZM[k - 1] : T(0)) - ZM[NZ - 1];
      rmin = k == NZ - 1 ? S2 : p_min(rmin, S2);
      c2_up = S2 - p_min(rmin, T(0));
    }
  }
#pragma unroll
  for (int k = 0; k < NZ; ++k) out[k * cells + c] = o[k];
}

}  // namespace

// x, out: (NZ, cells) row-major; dz: NZ; kase 0-3 as above.
extern "C" int SOIL_ENTRY(const T* x, const T* dz, T* out, long long cells, int kase,
                          cudaStream_t stream) {
  if (cells <= 0) return 0;
  switch (kase) {
    case 0: bisect_case<0><<<blocks(cells), THREADS, 0, stream>>>(x, dz, out, cells); break;
    case 1: bisect_case<1><<<blocks(cells), THREADS, 0, stream>>>(x, dz, out, cells); break;
    case 2: bisect_case<2><<<blocks(cells), THREADS, 0, stream>>>(x, dz, out, cells); break;
    case 3: bisect_case<3><<<blocks(cells), THREADS, 0, stream>>>(x, dz, out, cells); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#elif PROBE_ROW == 6

constexpr int NZ = SOIL_NZ;

template <int VARIANT>
__global__ void __launch_bounds__(THREADS)
repro_variant(const T* __restrict__ t_in, const T* __restrict__ s_in, T* __restrict__ t_out,
              T* __restrict__ s_out, long long cols, int inner) {
  const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (c >= cols) return;
  T t[NZ];
#pragma unroll
  for (int k = 0; k < NZ; ++k) t[k] = t_in[k * cols + c];
  T s = s_in[c];
#pragma unroll 1
  for (int it = 0; it < inner; ++it) {
    const T gt = t[NZ - 1];  // the top row (row_to_xy*; xy_only reads none)
    if (VARIANT == 0) {
      s = T(0.5) * s + p_exp(T(0.01) * s);
    } else if (VARIANT == 3) {
      const T e = gt <= T(0) ? T(611) * p_exp(T(22.46) * gt / (gt + T(272.62)))
                             : T(611) * p_exp(T(17.62) * gt / (gt + T(243.12)));
      s = T(0.5) * s + p_mul(T(1e-4), e);
    } else {
      s = T(0.5) * s + p_exp(T(0.01) * gt);
    }
    if (VARIANT == 4) {
      T n[NZ];
#pragma unroll
      for (int k = 0; k < NZ; ++k) {
        const T up = k + 1 < NZ ? t[k + 1] : T(0), dn = k > 0 ? t[k - 1] : T(0);
        n[k] = t[k] + p_mul(T(0.01), (up + dn) - T(2) * t[k]);
      }
#pragma unroll
      for (int k = 0; k < NZ; ++k) t[k] = n[k];
    } else {
#pragma unroll
      for (int k = 0; k < NZ; ++k) t[k] = t[k] * T(0.999);
    }
  }
#pragma unroll
  for (int k = 0; k < NZ; ++k) t_out[k * cols + c] = t[k];
  s_out[c] = s;
}

}  // namespace

// t_in, t_out: (NZ, cols) row-major; s_in, s_out: cols; variant 0-4 as
// above; inner >= 0 iterations.
extern "C" int SOIL_ENTRY(const T* t_in, const T* s_in, T* t_out, T* s_out, long long cols,
                          int variant, int inner, cudaStream_t stream) {
  if (cols <= 0) return 0;
  const unsigned g = blocks(cols);
#define PROBE_REPRO(V) \
  repro_variant<V><<<g, THREADS, 0, stream>>>(t_in, s_in, t_out, s_out, cols, inner)
  switch (variant) {
    case 0: PROBE_REPRO(0); break;
    case 1: PROBE_REPRO(1); break;
    case 2: PROBE_REPRO(2); break;
    case 3: PROBE_REPRO(3); break;
    case 4: PROBE_REPRO(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PROBE_REPRO
  return (int)cudaGetLastError();
}

#else
#error "PROBE_ROW must be 4, 5 or 6"
#endif
