// LDA E-step: the per-document variational fixpoint and the M-step rows.
//
// Replaces the TPU kernel `lda_estep` (topicmodelsvb_jl_tpu/kernels/
// lda_estep.py:157, body `_estep_kernel` :79).  For each document d with
// token slots l (term t_l, count c_l) and the table b = (beta + eps)^T:
//
//   repeat up to viter times:
//     e_k   = exp(El_k)
//     s_l   = sum_k b[t_l, k] e_k
//     q_k   = sum_l (c_l / s_l) b[t_l, k]
//     gamma = alpha + e * q + eps
//     El    = psi(gamma) - psi(sum gamma)        (El_old takes the old El)
//     stop once |El - El_old|^2 < vtol^2          (the break at LDA.jl:175)
//   w[l, k] = b[t_l, k] * (exp(El_old_k) * c_l / s_l)   (phi * counts)
//
// What bounds it on an H100: each pass reads the document's L x K rows
// twice (for s and for q) and does ~4 flops per row element, so it is
// bound by how fast the block re-reads those rows.  The design keeps them
// close: one block per document gathers its own rows from the [V, K]
// table once into dynamic shared memory (no [B, L, K] gather in device
// memory), and every pass of the fixpoint reads shared memory only.  A
// document whose rows do not fit the opt-in shared-memory limit re-reads
// them from the table in device memory, which at NSF scale (V x K x 4 =
// 10 MB) stays resident in the 50 MB L2.  Token slots with c_l = 0
// (bucket padding) are never read.  The write of w ([B, L, K], the one
// large output) is coalesced along K.
//
// Work is per document, not per 8-document tile as on the TPU: a block
// leaves its loop as soon as its own document converges, which is the
// reference's per-document break, and it gives the masked tile's result
// because a converged document's state is frozen there.  K is not padded.
// psi is the same shift-by-8 asymptotic series as the TPU kernel
// (digamma_series in common.cuh).

#include "common.cuh"

namespace tmvb {

// Shared memory: gam, el, elo, e [K] each, red [32], then (rows in
// shared memory only) cs [L] and rows [L * K].
__host__ __device__ inline size_t estep_smem_base(int64_t K) {
  return (4 * K + 32) * sizeof(float);
}
__host__ __device__ inline size_t estep_smem_rows(int64_t L, int64_t K) {
  return estep_smem_base(K) + (L + L * K) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads) lda_estep_kernel(
    const float* __restrict__ betaT,     // [V, K] beta^T + eps
    const int* __restrict__ terms,       // [B, L]
    const float* __restrict__ counts,    // [B, L], 0 on padding
    const float* __restrict__ doc_mask,  // [B]
    const float* __restrict__ alpha,     // [K]
    const float* __restrict__ gamma_in,  // [B, K]
    const float* __restrict__ el_in,     // [B, K]
    const float* __restrict__ elo_in,    // [B, K]
    float* __restrict__ gamma_out, float* __restrict__ el_out,
    float* __restrict__ elo_out,
    float* __restrict__ w,               // [B, L, K]
    float* __restrict__ cs_scratch,      // [B, L], used when rows stay global
    int L, int K, int viter, float vtol2, int rows_in_smem) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* gam = smem;
  float* el = gam + K;
  float* elo = el + K;
  float* e = elo + K;
  float* red = e + K;
  float* cs = rows_in_smem ? red + 32 : cs_scratch + static_cast<size_t>(b) * L;
  float* rows = red + 32 + L;
  const int* t = terms + static_cast<size_t>(b) * L;
  const float* c = counts + static_cast<size_t>(b) * L;
  const size_t dk = static_cast<size_t>(b) * K;

  for (int k = tid; k < K; k += kThreads) {
    gam[k] = gamma_in[dk + k];
    el[k] = el_in[dk + k];
    elo[k] = elo_in[dk + k];
  }
  if (rows_in_smem) {
    for (int l = warp; l < L; l += kWarps) {
      if (c[l] == 0.f) continue;
      const float* src = betaT + static_cast<size_t>(t[l]) * K;
      for (int k = lane; k < K; k += 32) rows[static_cast<size_t>(l) * K + k] = src[k];
    }
  }
  __syncthreads();
  auto row = [&](int l) -> const float* {
    return rows_in_smem ? rows + static_cast<size_t>(l) * K
                        : betaT + static_cast<size_t>(t[l]) * K;
  };

  bool active = doc_mask[b] > 0.f;
  for (int it = 0; it < viter && active; ++it) {
    for (int k = tid; k < K; k += kThreads) e[k] = expf(el[k]);
    __syncthreads();
    // s_l = sum_k b e, one warp per token slot; cs_l = c_l / s_l
    for (int l = warp; l < L; l += kWarps) {
      const float cl = c[l];
      float r = 0.f;
      if (cl != 0.f) {
        const float* br = row(l);
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += br[k] * e[k];
        r = cl / warp_sum(s);
      }
      if (lane == 0) cs[l] = r;
    }
    __syncthreads();
    // q_k = sum_l cs_l b[l, k], one thread per topic; e[k] then holds
    // gamma_new[k] (each k is read and written by its own thread only)
    float gpart = 0.f;
    for (int k = tid; k < K; k += kThreads) {
      float q = 0.f;
      for (int l = 0; l < L; ++l) {
        const float r = cs[l];
        if (r != 0.f) q += r * row(l)[k];
      }
      const float g = alpha[k] + e[k] * q + kEps;
      e[k] = g;
      gpart += g;
    }
    const float dg_sum = digamma_series(block_sum(gpart, red));
    float dpart = 0.f;
    for (int k = tid; k < K; k += kThreads) {
      const float el_new = digamma_series(e[k]) - dg_sum;
      const float d = el_new - el[k];
      dpart += d * d;
      gam[k] = e[k];
      elo[k] = el[k];
      el[k] = el_new;
    }
    active = block_sum(dpart, red) >= vtol2;
  }

  // M-step rows from phi(beta, El_old), the value phi held when the
  // document stopped (the warm-start identity of LDA.jl:87)
  for (int k = tid; k < K; k += kThreads) {
    e[k] = expf(elo[k]);
    gamma_out[dk + k] = gam[k];
    el_out[dk + k] = el[k];
    elo_out[dk + k] = elo[k];
  }
  __syncthreads();
  float* wd = w + static_cast<size_t>(b) * L * K;
  for (int l = warp; l < L; l += kWarps) {
    const float cl = c[l];
    float* wl = wd + static_cast<size_t>(l) * K;
    if (cl == 0.f) {
      for (int k = lane; k < K; k += 32) wl[k] = 0.f;
      continue;
    }
    const float* br = row(l);
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s += br[k] * e[k];
    const float r = cl / warp_sum(s);
    for (int k = lane; k < K; k += 32) wl[k] = br[k] * (e[k] * r);
  }
}

}  // namespace tmvb

extern "C" {

const char* tmvb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 1 when a document of L slots keeps its rows in shared memory, 0 when it
// re-reads them from the table, -1 when the device cannot be queried.
int tmvb_lda_estep_rows_in_smem(int64_t L, int64_t K) {
  return tmvb::fits_smem(tmvb::estep_smem_rows(L, K));
}

int tmvb_lda_estep(const float* betaT, const int* terms, const float* counts,
                   const float* doc_mask, const float* alpha, const float* gamma_in,
                   const float* el_in, const float* elo_in, float* gamma_out,
                   float* el_out, float* elo_out, float* w, float* cs_scratch,
                   int64_t B, int64_t L, int64_t K, int viter, float vtol,
                   void* stream) {
  if (B == 0) return 0;
  const int rows_in_smem = tmvb_lda_estep_rows_in_smem(L, K);
  if (rows_in_smem < 0) return tmvb::query_error();
  const size_t bytes =
      rows_in_smem ? tmvb::estep_smem_rows(L, K) : tmvb::estep_smem_base(K);
  cudaError_t err = tmvb::allow_smem(tmvb::lda_estep_kernel, bytes);
  if (err != cudaSuccess) return tmvb::fail(err);
  tmvb::lda_estep_kernel<<<static_cast<unsigned>(B), tmvb::kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      betaT, terms, counts, doc_mask, alpha, gamma_in, el_in, elo_in, gamma_out,
      el_out, elo_out, w, cs_scratch, static_cast<int>(L), static_cast<int>(K), viter,
      vtol * vtol, rows_in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
