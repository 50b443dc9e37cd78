// fLDA E-step: the per-document fixpoint of filtered LDA and its M-step rows.
//
// Replaces the TPU kernel `flda_estep` (topicmodelsvb_jl_tpu/kernels/
// flda_estep.py:112, body `_estep_kernel` :36).  For each document d with
// token slots l (term t_l, count c_l), lb = log(beta + eps)^T [V, K] and the
// background distribution kappa [V]:
//
//   repeat up to viter times:
//     p_lk     = exp(tau_l lb[t_l, k] + El_k - m_l)     (m_l = max over k)
//     s_l      = sum_k p_lk
//     tau_new  = eta / (eta + (1 - eta) kappa[t_l] exp(-sum_k p_lk lb[t_l, k] / s_l) + eps)
//     gamma    = alpha + sum_l p_lk c_l / s_l + eps
//     El       = psi(gamma) - psi(sum gamma)          (El_old takes the old El)
//     tau      = tau_new                               (tau_old takes the old tau)
//     stop once |El - El_old|^2 < vtol^2               (the break at fLDA.jl:206)
//   w[l, :K] = p_l(tau_old, El_old) * (tau_l c_l / s_l)   (beta statistic)
//   w[l, K]  = (1 - tau_l) c_l                            (kappa statistic)
//
// tau is updated on every slot of the document, padding slots included,
// as the TPU kernel does: it is part of the state the two packages compare.
//
// What bounds it on an H100: unlike LDA, phi cannot be formed
// multiplicatively, because tau rescales log beta per token on every
// pass, so each pass costs L x K expf plus a max and two sums over K per
// token.  One warp per token slot with its lanes over K computes those;
// each warp keeps its own gamma partial in shared memory, and the
// partials are added in warp order, so the result is deterministic.  The
// block gathers its L rows of lb from the [V, K] table into dynamic
// shared memory once (L = 128, K = 100: 51 KB) and every pass reads
// shared memory only; a document whose rows do not fit the opt-in limit
// re-reads them from the table, which at NSF scale (10 MB) stays resident
// in the 50 MB L2.  tau and tau_old are updated in place in the output
// arrays, kappa is read from its [V] table, and eta from device memory
// (a host float would cost a sync per chunk).  One block per document,
// which leaves its loop when its own document converges; K is not padded.

#include "common.cuh"

namespace tmvb {

// Shared memory: gam, el, elo [K] each, gacc and pbuf [kWarps * K] each,
// red [32], then (rows in shared memory only) rows [L * K].
__host__ __device__ inline size_t flda_smem_base(int64_t K) {
  return (3 * K + 2 * kWarps * K + 32) * sizeof(float);
}
__host__ __device__ inline size_t flda_smem_rows(int64_t L, int64_t K) {
  return flda_smem_base(K) + L * K * sizeof(float);
}

__global__ void __launch_bounds__(kThreads) flda_estep_kernel(
    const float* __restrict__ logbetaT,  // [V, K] log(beta + eps)^T
    const float* __restrict__ kappa,     // [V]
    const int* __restrict__ terms,       // [B, L]
    const float* __restrict__ counts,    // [B, L], 0 on padding
    const float* __restrict__ doc_mask,  // [B]
    const float* __restrict__ alpha,     // [K]
    const float* __restrict__ eta_p,     // [] eta
    const float* __restrict__ gamma_in,  // [B, K]
    const float* __restrict__ el_in,     // [B, K]
    const float* __restrict__ elo_in,    // [B, K]
    const float* __restrict__ tau_in,    // [B, L]
    const float* __restrict__ tauo_in,   // [B, L]
    float* __restrict__ gamma_out, float* __restrict__ el_out,
    float* __restrict__ elo_out, float* __restrict__ tau,  // [B, L], in place
    float* __restrict__ tauo,            // [B, L], in place
    float* __restrict__ w,               // [B, L, K + 1]
    int L, int K, int viter, float vtol2, int rows_in_smem) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* gam = smem;
  float* el = gam + K;
  float* elo = el + K;
  float* gacc = elo + K;           // [kWarps, K] per-warp gamma partials
  float* pbuf = gacc + kWarps * K; // [kWarps, K] one token's p per warp
  float* red = pbuf + kWarps * K;
  float* rows = red + 32;
  float* ga = gacc + warp * K;
  float* pb = pbuf + warp * K;
  const size_t dl = static_cast<size_t>(b) * L;
  const int* t = terms + dl;
  const float* c = counts + dl;
  const size_t dk = static_cast<size_t>(b) * K;
  const float eta = *eta_p;
  const float one_m_eta = 1.0f - eta;

  for (int k = tid; k < K; k += kThreads) {
    gam[k] = gamma_in[dk + k];
    el[k] = el_in[dk + k];
    elo[k] = elo_in[dk + k];
  }
  for (int l = tid; l < L; l += kThreads) {
    tau[dl + l] = tau_in[dl + l];
    tauo[dl + l] = tauo_in[dl + l];
  }
  if (rows_in_smem) {
    for (int l = warp; l < L; l += kWarps) {
      const float* src = logbetaT + static_cast<size_t>(t[l]) * K;
      for (int k = lane; k < K; k += 32) rows[static_cast<size_t>(l) * K + k] = src[k];
    }
  }
  __syncthreads();
  auto row = [&](int l) -> const float* {
    return rows_in_smem ? rows + static_cast<size_t>(l) * K
                        : logbetaT + static_cast<size_t>(t[l]) * K;
  };
  // p_l(tl, e) into this warp's pbuf; returns s_l to every lane and
  // sum_k p lb (unnormalised) through `pl_sum`
  auto phi_row = [&](const float* lb, float tl, const float* e, float* pl_sum) -> float {
    float m = -INFINITY;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, tl * lb[k] + e[k]);
    m = warp_max(m);
    float s = 0.f, sl = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float p = expf(tl * lb[k] + e[k] - m);
      pb[k] = p;
      s += p;
      sl += p * lb[k];
    }
    *pl_sum = warp_sum(sl);
    return warp_sum(s);
  };

  bool active = doc_mask[b] > 0.f;
  for (int it = 0; it < viter && active; ++it) {
    for (int k = lane; k < K; k += 32) ga[k] = 0.f;
    for (int l = warp; l < L; l += kWarps) {
      const float* lb = row(l);
      const float tl = tau[dl + l];
      float sl;
      const float s = phi_row(lb, tl, el, &sl);
      // update_tau! (fLDA.jl:195-200)
      const float tn = eta / (eta + one_m_eta * kappa[t[l]] * expf(-(sl / s)) + kEps);
      if (lane == 0) {
        tauo[dl + l] = tl;
        tau[dl + l] = tn;
      }
      const float cl = c[l];
      if (cl != 0.f) {
        const float cs = cl / s;
        for (int k = lane; k < K; k += 32) ga[k] += pb[k] * cs;
      }
    }
    __syncthreads();
    // update_gamma! (fLDA.jl:188-191): warp partials in warp order; the
    // new gamma goes to warp 0's row of gacc (each k is its own thread's)
    float gpart = 0.f;
    for (int k = tid; k < K; k += kThreads) {
      float q = 0.f;
      for (int v = 0; v < kWarps; ++v) q += gacc[v * K + k];
      const float g = alpha[k] + q + kEps;
      gacc[k] = g;
      gpart += g;
    }
    // update_Elogtheta! (fLDA.jl:181-184)
    const float dg_sum = digamma_series(block_sum(gpart, red));
    float dpart = 0.f;
    for (int k = tid; k < K; k += kThreads) {
      const float g = gacc[k];
      const float el_new = digamma_series(g) - dg_sum;
      const float d = el_new - el[k];
      dpart += d * d;
      gam[k] = g;
      elo[k] = el[k];
      el[k] = el_new;
    }
    active = block_sum(dpart, red) >= vtol2;
  }

  for (int k = tid; k < K; k += kThreads) {
    gamma_out[dk + k] = gam[k];
    el_out[dk + k] = el[k];
    elo_out[dk + k] = elo[k];
  }
  __syncthreads();
  // statistics: phi from (tau_old, El_old), weights from the current tau
  // (fLDA.jl:160-177)
  const int K1 = K + 1;
  float* wd = w + dl * K1;
  for (int l = warp; l < L; l += kWarps) {
    const float cl = c[l];
    float* wl = wd + static_cast<size_t>(l) * K1;
    if (cl == 0.f) {
      for (int k = lane; k < K1; k += 32) wl[k] = 0.f;
      continue;
    }
    const float tc = tau[dl + l];
    float sl;
    const float s = phi_row(row(l), tauo[dl + l], elo, &sl);
    const float r = (tc * cl) / s;
    for (int k = lane; k < K; k += 32) wl[k] = pb[k] * r;
    if (lane == 0) wl[K] = (1.0f - tc) * cl;
  }
}

}  // namespace tmvb

extern "C" {

// 1 when a document of L slots keeps its rows in shared memory, 0 when it
// re-reads them from the table, -1 when the device cannot be queried.
int tmvb_flda_estep_rows_in_smem(int64_t L, int64_t K) {
  return tmvb::fits_smem(tmvb::flda_smem_rows(L, K));
}

int tmvb_flda_estep(const float* logbetaT, const float* kappa, const int* terms,
                    const float* counts, const float* doc_mask, const float* alpha,
                    const float* eta, const float* gamma_in, const float* el_in,
                    const float* elo_in, const float* tau_in, const float* tauo_in,
                    float* gamma_out, float* el_out, float* elo_out, float* tau_out,
                    float* tauo_out, float* w, int64_t B, int64_t L, int64_t K,
                    int viter, float vtol, void* stream) {
  if (B == 0) return 0;
  const int rows_in_smem = tmvb_flda_estep_rows_in_smem(L, K);
  if (rows_in_smem < 0) return tmvb::query_error();
  const size_t bytes =
      rows_in_smem ? tmvb::flda_smem_rows(L, K) : tmvb::flda_smem_base(K);
  const cudaError_t err = tmvb::allow_smem(tmvb::flda_estep_kernel, bytes);
  if (err != cudaSuccess) return tmvb::fail(err);
  tmvb::flda_estep_kernel<<<static_cast<unsigned>(B), tmvb::kThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      logbetaT, kappa, terms, counts, doc_mask, alpha, eta, gamma_in, el_in, elo_in,
      tau_in, tauo_in, gamma_out, el_out, elo_out, tau_out, tauo_out, w,
      static_cast<int>(L), static_cast<int>(K), viter, vtol * vtol, rows_in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
