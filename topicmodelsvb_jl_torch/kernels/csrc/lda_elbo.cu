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
//
// What bounds it on an H100: it reads each real token's two K-wide rows
// (bo twice, g2 once) and does ~6 flops per row element, so it is bound by
// those gathered reads.  The rows come straight from the two [V, K]
// tables, which at NSF scale (2 x 10 MB) stay resident in the 50 MB L2;
// no [B, L, 2K] gather is written to device memory, and padding slots are
// never read.  Each block writes its document's partial to out[d]; the
// caller sums the partials, so there are no float atomics and the bound
// is bitwise reproducible.  log is logf, not the TPU's bit-level series.

#include "common.cuh"

namespace tmvb {

// Shared memory: e [K], red [32], then r [L] when it fits.
__host__ __device__ inline size_t elbo_smem(int64_t L, int64_t K, bool r_in_smem) {
  return (K + 32 + (r_in_smem ? L : 0)) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads) lda_elbo_tok_kernel(
    const float* __restrict__ boT,       // [V, K]
    const float* __restrict__ g2T,       // [V, K]
    const int* __restrict__ terms,       // [B, L]
    const float* __restrict__ counts,    // [B, L]
    const float* __restrict__ doc_mask,  // [B]
    const float* __restrict__ el,        // [B, K] current Elogtheta
    const float* __restrict__ elo,       // [B, K] old Elogtheta
    float* __restrict__ out,             // [B] per-document partials
    float* __restrict__ r_scratch,       // [B, L], used when r is not in smem
    int L, int K, int r_in_smem) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* e = smem;
  float* red = e + K;
  float* r = r_in_smem ? red + 32 : r_scratch + static_cast<size_t>(b) * L;
  const int* t = terms + static_cast<size_t>(b) * L;
  const float* c = counts + static_cast<size_t>(b) * L;
  const size_t dk = static_cast<size_t>(b) * K;

  for (int k = tid; k < K; k += kThreads) e[k] = expf(elo[dk + k]);
  __syncthreads();

  float part = 0.f;  // lane 0 of each warp collects sum_l c log s
  for (int l = warp; l < L; l += kWarps) {
    const float cl = c[l];
    float rl = 0.f;
    if (cl > 0.f) {
      const float* br = boT + static_cast<size_t>(t[l]) * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += br[k] * e[k];
      s = warp_sum(s);
      rl = cl / s;
      if (lane == 0) part += cl * logf(s);
    }
    if (lane == 0) r[l] = rl;
  }
  __syncthreads();

  for (int k = tid; k < K; k += kThreads) {
    float q = 0.f, a2 = 0.f;
    for (int l = 0; l < L; ++l) {
      const float rl = r[l];
      if (rl != 0.f) {
        const size_t row = static_cast<size_t>(t[l]) * K + k;
        q += rl * boT[row];
        a2 += rl * g2T[row];
      }
    }
    const float ek = e[k];
    part += (ek * q) * (el[dk + k] - elo[dk + k]) + ek * a2;
  }
  const float total = block_sum(part, red);
  if (tid == 0) out[b] = total * doc_mask[b];
}

}  // namespace tmvb

extern "C" int tmvb_lda_elbo_tok(const float* boT, const float* g2T, const int* terms,
                                 const float* counts, const float* doc_mask,
                                 const float* el, const float* elo, float* out,
                                 float* r_scratch, int64_t B, int64_t L, int64_t K,
                                 void* stream) {
  if (B == 0) return 0;
  const int r_in_smem = tmvb::elbo_smem(L, K, true) <= 48 * 1024;
  const size_t bytes = tmvb::elbo_smem(L, K, r_in_smem);
  const cudaError_t err = tmvb::allow_smem(tmvb::lda_elbo_tok_kernel, bytes);
  if (err != cudaSuccess) return tmvb::fail(err);
  tmvb::lda_elbo_tok_kernel<<<static_cast<unsigned>(B), tmvb::kThreads, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      boT, g2T, terms, counts, doc_mask, el, elo, out, r_scratch,
      static_cast<int>(L), static_cast<int>(K), r_in_smem);
  return static_cast<int>(cudaGetLastError());
}
