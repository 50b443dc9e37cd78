// LDA ELBO, token-level terms: one partial per document.
//
// Replaces the TPU kernel `lda_elbo_tok` (topicmodelsvb_jl_tpu/kernels/
// lda_elbo.py:119, body `_elbo_kernel` :77).  With bo = (beta_old + eps)^T
// and g2 = bo * (log(beta + eps) - log(beta_old + eps))^T, both [V, K],
// and phi = bo e / s for e = exp(El_old), s_l = sum_k bo[t_l, k] e_k, the
// terms Elogpz + Elogpw - Elogqz of one document (LDA.jl:56-80) are
//
//   sum_k e_k q_k (El_k - El_old_k) + sum_k e_k a2_k + sum_l c_l log s_l
//   q_k = sum_l r_l bo[t_l, k],  a2_k = sum_l r_l g2[t_l, k],  r_l = c_l / s_l
//
// with r_l and c_l log s_l taken as 0 where c_l = 0 (lda_elbo.py:97-98).
// The partial is a scalar, so the two per-topic sums fold into per-slot
// dot products: with d = e * (El - El_old),
//
//   partial = sum_{l: c_l > 0} c_l (u_l / s_l + log s_l),
//   u_l = sum_k bo[t_l, k] d_k + sum_k g2[t_l, k] e_k.
//
// A real token over an all-zero bo row (CTM's raw beta_old) gives s = 0
// and a non-finite partial, as in the plain version: degeneracy is
// surfaced, not masked.
//
// What bounds it on an H100: bytes.  It must read the distinct rows of
// the two tables its kept slots name (2 x ~10 MB at the widest NSF chunk,
// fewer on a Zipf head), the terms and counts and 2 [B, K] states: ~25 MB,
// ~6 us at 3.35 TB/s; ~6 flops per row element is ~0.14 GFLOP, ~2 us at
// 67 TFLOP/s.  Each kept slot reads its two rows once, from L2 (the tables
// stay resident in the 50 MB L2) or L1.
//
// Design (256 threads, one document per block): threads over slots, 8
// threads a slot, their vectors of topics interleaved, so that a warp's
// load touches 4 rows (4 lines of 128 bytes) and not 32, with 16-byte
// loads of both rows where K % 4 == 0 and the tables are aligned (8-byte
// where K % 2 == 0: CTM's K = 50), through L1 (__ldg), e and d broadcast
// from shared memory; the group's sums are added by shuffles, and
// c (u / s + log s) is thread-local.  Padding slots read their count only.
// The block's partials are added in warp order, each document's into
// out[d]; the caller sums them, so there are no float atomics and the
// bound is bitwise reproducible.  Shared memory is 2K + 8 floats.  log is
// logf, not the TPU's bit-level series.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/estep_sweep.py, in turns):
// 24.6 us at the widest NSF chunk, 133 us at L = 1024, 26.8 us on a
// 2048-document K = 50 chunk (the previous design, a thread a topic
// walking every slot, took 58, 454 and 69.5 us).
// Dropped: 1 or 2 threads a slot (32 rows a warp load: 32.2 us and 299 us),
// 4, 16 and 32 threads a slot (26.6, 28.6 and 40.1 us), and the 8 as a
// compile-time constant (27.1-27.8 us): the kernel takes it as an argument.
//
// The float64 mode (R = double; tmvb_lda_elbo_tok_f64): the same kernel in
// double, LDA's and CTM's bound on a float64 state; loads of two doubles
// (16 bytes) where K is even, the double log.  Bound: bytes, doubled
// (~50 MB at the widest NSF chunk, ~15 us).  Shared memory is 2K + 8
// doubles, so K stops at ~14,500 (the f32 mode's ~29,000).

#include "common.cuh"

namespace tmvb {

constexpr int kElboThreads = 256;
constexpr int kElboWarps = kElboThreads / 32;
constexpr int kElboTpsLog2 = 3;   // 8 threads a slot

template <typename R, int kVec>
struct Vec;
template <>
struct Vec<float, 4> {
  using T = float4;
  __device__ static float dot(T a, T b) { return (a.x * b.x + a.y * b.y) + (a.z * b.z + a.w * b.w); }
};
template <>
struct Vec<float, 2> {
  using T = float2;
  __device__ static float dot(T a, T b) { return a.x * b.x + a.y * b.y; }
};
template <>
struct Vec<float, 1> {
  using T = float;
  __device__ static float dot(T a, T b) { return a * b; }
};
template <>
struct Vec<double, 2> {
  using T = double2;
  __device__ static double dot(T a, T b) { return a.x * b.x + a.y * b.y; }
};
template <>
struct Vec<double, 1> {
  using T = double;
  __device__ static double dot(T a, T b) { return a * b; }
};

// R: float, or double for the float64 mode (every input, the sums and
// the partials in double; log is the double log).
template <typename R, int kVec>
__global__ void __launch_bounds__(kElboThreads) lda_elbo_tok_kernel(
    const R* __restrict__ boT,       // [V, K]
    const R* __restrict__ g2T,       // [V, K]
    const int* __restrict__ terms,   // [B, L]
    const R* __restrict__ counts,    // [B, L]
    const R* __restrict__ doc_mask,  // [B]
    const R* __restrict__ el,        // [B, K] current Elogtheta
    const R* __restrict__ elo,       // [B, K] old Elogtheta
    R* __restrict__ out,             // [B] per-document partials
    int L, int K, int tps_log2) {
  using T = typename Vec<R, kVec>::T;
  extern __shared__ __align__(16) unsigned char elbo_smem[];
  R* smem = reinterpret_cast<R*>(elbo_smem);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  R* e = smem;         // [K] exp(El_old)
  R* d = e + K;        // [K] exp(El_old) (El - El_old)
  R* red = d + K;      // [kElboWarps]
  const int* t = terms + static_cast<size_t>(b) * L;
  const R* c = counts + static_cast<size_t>(b) * L;
  const size_t dk = static_cast<size_t>(b) * K;

  for (int k = tid; k < K; k += kElboThreads) {
    const R x = elo[dk + k];
    const R ek = Real<R>::exp(x);
    e[k] = ek;
    d[k] = ek * (el[dk + k] - x);
  }
  __syncthreads();

  const int tps = 1 << tps_log2, sub = tid & (tps - 1), G = K / kVec;
  const T* e4 = reinterpret_cast<const T*>(e);
  const T* d4 = reinterpret_cast<const T*>(d);
  R part = 0;
  for (int base = 0; base < L; base += kElboThreads >> tps_log2) {
    const int l = base + (tid >> tps_log2);
    const R cl = l < L ? c[l] : R(0);
    R s = 0, u = 0;
    if (cl > R(0)) {
      const size_t row = static_cast<size_t>(t[l]) * K;
      const T* bo = reinterpret_cast<const T*>(boT + row);
      const T* g2 = reinterpret_cast<const T*>(g2T + row);
#pragma unroll 4
      for (int g = sub; g < G; g += tps) {
        const T x = __ldg(bo + g), y = __ldg(g2 + g), ev = e4[g];
        s += Vec<R, kVec>::dot(x, ev);
        u += Vec<R, kVec>::dot(x, d4[g]) + Vec<R, kVec>::dot(y, ev);
      }
    }
    for (int o = 1; o < tps; o <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      u += __shfl_xor_sync(0xffffffffu, u, o);
    }
    if (sub == 0 && cl > R(0)) part += cl * (u / s + Real<R>::log(s));
  }
  const R total = block_sum_once<kElboWarps>(part, red);
  if (tid == 0) out[b] = total * doc_mask[b];
}

template <typename R>
int launch_elbo(const R* boT, const R* g2T, const int* terms, const R* counts,
                const R* doc_mask, const R* el, const R* elo, R* out, int64_t B, int64_t L,
                int64_t K, int vec, void* stream) {
  if (B == 0) return 0;
  if (K % vec != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (2 * K + kElboWarps) * sizeof(R);
  auto launch = [&](auto kernel) -> int {
    const cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return fail(err);
    kernel<<<static_cast<unsigned>(B), kElboThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        boT, g2T, terms, counts, doc_mask, el, elo, out, static_cast<int>(L),
        static_cast<int>(K), kElboTpsLog2);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (sizeof(R) == 4) {
    switch (vec) {
      case 4: return launch(lda_elbo_tok_kernel<R, 4>);
      case 2: return launch(lda_elbo_tok_kernel<R, 2>);
      case 1: return launch(lda_elbo_tok_kernel<R, 1>);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (vec) {
      case 2: return launch(lda_elbo_tok_kernel<R, 2>);
      case 1: return launch(lda_elbo_tok_kernel<R, 1>);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

}  // namespace tmvb

// vec: 4 (16-byte loads: K % 4 == 0, both tables 16-byte aligned), 2
// (K % 2 == 0, 8-byte aligned) or 1.
extern "C" int tmvb_lda_elbo_tok(const float* boT, const float* g2T, const int* terms,
                                 const float* counts, const float* doc_mask,
                                 const float* el, const float* elo, float* out, int64_t B,
                                 int64_t L, int64_t K, int vec, void* stream) {
  return tmvb::launch_elbo(boT, g2T, terms, counts, doc_mask, el, elo, out, B, L, K, vec,
                           stream);
}

// The float64 mode: vec 2 (16-byte loads of two doubles: K % 2 == 0,
// both tables 16-byte aligned) or 1.
extern "C" int tmvb_lda_elbo_tok_f64(const double* boT, const double* g2T, const int* terms,
                                     const double* counts, const double* doc_mask,
                                     const double* el, const double* elo, double* out,
                                     int64_t B, int64_t L, int64_t K, int vec, void* stream) {
  return tmvb::launch_elbo(boT, g2T, terms, counts, doc_mask, el, elo, out, B, L, K, vec,
                           stream);
}
