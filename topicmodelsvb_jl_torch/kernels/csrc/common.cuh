// Helpers shared by the E-step and ELBO kernels: warp and block-wide
// sums, cp.async, the digamma series and the shared-memory opt-in.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tmvb {

// The port's EPSILON (utils/numerics.py), Julia's eps(1e-14) = spacing(1e-14)
// = 2^-99 = 1.5777218104420236e-30 (the reference's utils.jl:3), which the
// plain versions and the tables add: a power of two, so float holds it
// exactly.  Real<R>::eps is this one value in either mode.
constexpr float kEps = 1.5777218104420236e-30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Four doubles, 16-byte aligned: the float64 modes' counterpart of float4
// (two 16-byte loads or stores; CUDA's own double4 changes its alignment
// between toolkits).
struct __align__(16) Double4 {
  double x, y, z, w;
};

// What the kernels' float32 and float64 modes spell differently: the
// four-wide vector, the underflow guard, and the math functions.  float
// keeps the calls the float32 kernels always made (expf, logf, fmaf,
// fmaxf); double has no special-function unit, so its exp, exp2 and log
// are instruction sequences on the FP64 pipe, accurate to an ulp or two.
template <typename R>
struct Real;
template <>
struct Real<float> {
  using V4 = float4;
  static constexpr float eps = kEps;
  static constexpr float log2e = 1.4426950408889634f;
  __device__ static __forceinline__ float exp(float x) { return expf(x); }
  __device__ static __forceinline__ float log(float x) { return logf(x); }
  __device__ static __forceinline__ float fma(float a, float b, float c) { return fmaf(a, b, c); }
  __device__ static __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
  __device__ static __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <>
struct Real<double> {
  using V4 = Double4;
  static constexpr double eps = kEps;   // 2^-99 exactly, as float
  static constexpr double log2e = 1.4426950408889634;
  __device__ static __forceinline__ double exp(double x) { return ::exp(x); }
  __device__ static __forceinline__ double log(double x) { return ::log(x); }
  __device__ static __forceinline__ double fma(double a, double b, double c) { return ::fma(a, b, c); }
  __device__ static __forceinline__ double max(double a, double b) { return fmax(a, b); }
  __device__ static __forceinline__ Double4 zero4() { return Double4{0.0, 0.0, 0.0, 0.0}; }
};

// Sum of v over a block of kN warps, returned to every thread, with ONE
// barrier: the caller gives each call site its own `red` (kN values), so
// no barrier is needed before the write.  Per-warp partials are added in
// warp order, so every thread sees the same bits.  T is float, or double
// for the f64 Elogtheta channel (`red` then 8-byte aligned).
template <int kN, typename T>
__device__ __forceinline__ T block_sum_once(T v, T* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = 0;
#pragma unroll
  for (int w = 0; w < kN; ++w) s += red[w];
  return s;
}

// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80+): 16 bytes (both addresses 16-byte aligned) or 4 bytes.
// cp_async_wait_all() waits for every copy the thread issued.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
// 16 bytes through L1 (.ca): rows that many blocks of an SM read again,
// such as a padding id's, are served there and not by one L2 slice.
__device__ __forceinline__ void cp_async16_ca(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}
// One element: 4 bytes for a float, 8 for a double.
__device__ __forceinline__ void cp_async_elem(float* smem, const float* gmem) {
  cp_async4(smem, gmem);
}
__device__ __forceinline__ void cp_async_elem(double* smem, const double* gmem) {
  cp_async8(smem, gmem);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// psi(x) for x > 0: psi(x) = psi(x + 8) - sum_{i<8} 1/(x + i), then the
// asymptotic series at t = x + 8 (truncation ~2.5e-10 at t = 8).  The
// TPU kernels' digamma_series (topicmodelsvb_jl_tpu/kernels/
// lda_estep.py:58-76), in f32 with IEEE division and logf.
__device__ __forceinline__ float digamma_series(float x) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc += 1.0f / (x + static_cast<float>(i));
  const float t = x + 8.0f;
  const float inv = 1.0f / t;
  const float inv2 = inv * inv;
  const float series = logf(t) - 0.5f * inv -
      inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 * (1.0f / 252.0f)));
  return series - acc;
}

// The same series in double, for the float64 modes: what the plain
// versions compute on a float64 state (lda_estep.digamma_series), whose
// truncation (~2.5e-10 at t = 8) the float64 runs keep, so that the card
// and the CPU take one function.
__device__ __forceinline__ double digamma_series(double x) {
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc += 1.0 / (x + static_cast<double>(i));
  const double t = x + 8.0;
  const double inv = 1.0 / t;
  const double inv2 = inv * inv;
  const double series = log(t) - 0.5 * inv -
      inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 * (1.0 / 252.0)));
  return series - acc;
}

// psi(x) for x > 0 in double, for the f64 Elogtheta channel: the same
// shift by 8, then the asymptotic series at t = x + 8 through the t^-12
// term, ln t - 1/(2t) - 1/(12t^2) + 1/(120t^4) - 1/(252t^6) + 1/(240t^8)
// - 1/(132t^10) + 691/(32760t^12); the first term left out, 1/(12t^14),
// is < 2e-14 at t = 8, so the truncation stays below the f32 series'
// ~2.5e-10 by four orders and below the f32 cast-back's rounding.
__device__ __forceinline__ double digamma_series64(double x) {
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc += 1.0 / (x + static_cast<double>(i));
  const double t = x + 8.0;
  const double inv = 1.0 / t;
  const double inv2 = inv * inv;
  const double series = log(t) - 0.5 * inv -
      inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 * (1.0 / 252.0 - inv2 * (
          1.0 / 240.0 - inv2 * (1.0 / 132.0 - inv2 * (691.0 / 32760.0))))));
  return series - acc;
}

// 2^x in double for the float64 resident designs (flda_estep_res_kernel,
// ctpf_estep_res_kernel): x = n + f with n the nearest integer (the 1.5
// 2^52 shift leaves it in the low word) and f in [-1/2, 1/2], 2^f a
// degree-10 polynomial fitted at the Chebyshev nodes of [-1/2, 1/2]
// (2.9e-16 relative off 2^f, ~2 ulps as evaluated), and n added to the
// exponent as an integer: 3 DADD and 10 DFMA on the FP64 pipe, against
// the library exp2's longer sequence.  Below 2^-1021 it flushes to 0,
// where the library gives a subnormal: < 1e-300 of any sum it enters
// (fLDA: every p of a document's argmax topic is >= eps; CTPF: exp(psi)
// of gimel and zayin, which stay above their priors).
__device__ __forceinline__ double exp2_res(double x) {
  constexpr double kShift = 6755399441055744.0;   // 1.5 * 2^52
  const double xc = fmax(x, -1075.0);
  const double t = xc + kShift;
  const double f = xc - (t - kShift);
  double p = 7.072585949269223e-09;
  p = fma(p, f, 1.0208690299958306e-07);
  p = fma(p, f, 1.321544258792169e-06);
  p = fma(p, f, 1.5252657260200837e-05);
  p = fma(p, f, 0.0001540353044173605);
  p = fma(p, f, 0.0013333558230164974);
  p = fma(p, f, 0.009618129107606888);
  p = fma(p, f, 0.05550410866444772);
  p = fma(p, f, 0.24022650695910097);
  p = fma(p, f, 0.69314718055995);
  p = fma(p, f, 1.0);
  const int n = __double2loint(t);
  const int hi = __double2hiint(p) + static_cast<int>(static_cast<unsigned>(n) << 20);
  const double r = __hiloint2double(hi, __double2loint(p));
  return n < -1021 ? 0.0 : r;
}

// exp(psi(x)) for x > 0 in double without a log, for the float64 resident
// designs (ctpf_estep_res_kernel, lda_estep_res_kernel): psi(x) = ln t -
// 1/(2t) - 1/(12t^2) + 1/(120t^4) - 1/(252t^6) - sum_{i<8} 1/(x + i), t = x + 8
// (digamma_series' shift and truncation), so exp(psi(x)) = t exp(the rest);
// the sum as one fraction S / P (digamma_one_div's pairs), and S / P and
// 1 / t from one division 1 / (P t); past x = 3e4 no shift (t = x).  The
// exp by exp2_res; ~1e-15 relative off exp(digamma_series(x)).
__device__ __forceinline__ double exp_digamma(double x) {
  double S = 0.0, P = 1.0, t = x;
  if (x < 3e4) {
    double p[4], q[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const double a = x + 2.0 * m;
      p[m] = a * (a + 1.0);
      q[m] = 2.0 * a + 1.0;
    }
    const double p01 = p[0] * p[1], p23 = p[2] * p[3];
    const double s01 = q[0] * p[1] + q[1] * p[0], s23 = q[2] * p[3] + q[3] * p[2];
    S = s01 * p23 + s23 * p01;
    P = p01 * p23;
    t = x + 8.0;
  }
  const double d = 1.0 / (P * t);
  const double inv = P * d, acc = S * (t * d);
  const double inv2 = inv * inv;
  const double e = -0.5 * inv -
      inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 * (1.0 / 252.0))) - acc;
  return t * exp2_res(e * Real<double>::log2e);
}

// True when p is 16-byte aligned (16-byte copies and stores).
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Clears a failed setup call's error so the next launch check does not
// report it again.
inline int fail(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

// The device's opt-in shared-memory limit per block, or -1 when it
// cannot be queried.
inline int smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return optin;
}

// The error that left smem_optin() at -1, or cudaErrorUnknown.
inline int query_error() {
  const cudaError_t err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
}

// Dynamic shared memory of `bytes` for `kernel`: above the 48 KB default
// only after opting in, and never past the device's opt-in limit.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const int optin = smem_optin();
  if (optin < 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorUnknown;
  }
  if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace tmvb
