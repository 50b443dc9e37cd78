// CTPF E-step: the per-document fixpoint of collaborative topic Poisson
// factorization and its M-step rows.
//
// Replaces the TPU kernel `ctpf_estep` (topicmodelsvb_jl_tpu/kernels/
// ctpf_estep.py:105, body `_estep_kernel` :35).  With the per-step tables
// ea = exp(psi(alef))^T [V, K], eh = exp(psi(he))^T [U, K] and the [K]
// vectors 1/(dalet bet), 1/(dalet vav), 1/(het vav), phi and xi are formed
// multiplicatively.  For each document d with token slots l (term t_l,
// count c_l) and reader slots j (user u_j, rating y_j):
//
//   repeat up to viter times:
//     qp = exp(psi(gimel)) / (dalet bet),  qt = exp(psi(gimel)) / (dalet vav),
//     qb = exp(psi(zayin)) / (het vav)
//     r_l = c_l / (sum_k ea[t_l, k] qp_k + eps)           (phi normaliser)
//     x_j = y_j / (sum_k eh[u_j, k] (qt_k + qb_k) + eps)  (2K xi normaliser)
//     h_k = sum_j x_j eh[u_j, k]
//     gimel = c + qp_k sum_l r_l ea[t_l, k] + qt_k h_k    (gimel_old: the old)
//     zayin = g + qb_k h_k                                (zayin_old: the old)
//     stop once |gimel - gimel_old|^2 < vtol^2            (CTPF.jl:359)
//   wa[l, k] = ea[t_l, k] (qp_k r_l),  wh[j, k] = eh[u_j, k] ((qt_k + qb_k) x_j)
//   with q from (gimel_old, zayin_old)                    (CTPF.jl:259-277)
//
// What bounds it on an H100: as in the LDA E-step, each pass reads the
// document's (L + R) x K rows twice (for the normalisers and for the
// row products) at ~2 flops per element, so it is bound by how fast the
// block re-reads them; the transcendentals are only psi and exp on the
// [K] gimel/zayin vectors.  The block gathers its token and reader rows
// from the two tables into dynamic shared memory once (CiteULike scale,
// (L + R) x K x 4 ~ 40 KB) and every pass reads shared memory only; a
// document whose rows do not fit the opt-in limit re-reads them from the
// tables (V x K x 4 = 3.2 MB and U x K x 4 = 2.2 MB at CiteULike scale,
// resident in the 50 MB L2) and keeps r and x in a global scratch row.
// Slots with c_l = 0 or y_j = 0 (padding) are never read.  One block per
// document, which leaves its loop when its own document converges; each
// gimel/zayin entry is its own thread's, and the one block-wide sum (the
// stop test) adds warp partials in a fixed order.  K is not padded.

#include "common.cuh"

namespace tmvb {

// Shared memory: gi, gio, za, zao, qp, qt, qb [K] each, red [32], then
// (rows in shared memory only) cs [L + R] and rows [(L + R) * K].
__host__ __device__ inline size_t ctpf_smem_base(int64_t K) {
  return (7 * K + 32) * sizeof(float);
}
__host__ __device__ inline size_t ctpf_smem_rows(int64_t L, int64_t R, int64_t K) {
  return ctpf_smem_base(K) + ((L + R) + (L + R) * K) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads) ctpf_estep_kernel(
    const float* __restrict__ ealefT,    // [V, K] exp(psi(alef))^T
    const float* __restrict__ eheT,      // [U, K] exp(psi(he))^T
    const int* __restrict__ terms,       // [B, L]
    const float* __restrict__ counts,    // [B, L], 0 on padding
    const int* __restrict__ readers,     // [B, R]
    const float* __restrict__ ratings,   // [B, R], 0 on padding
    const float* __restrict__ doc_mask,  // [B]
    const float* __restrict__ inv_db,    // [K] 1 / (dalet bet)
    const float* __restrict__ inv_dv,    // [K] 1 / (dalet vav)
    const float* __restrict__ inv_hv,    // [K] 1 / (het vav)
    const float* __restrict__ gi_in, const float* __restrict__ gio_in,
    const float* __restrict__ za_in, const float* __restrict__ zao_in,  // [B, K]
    float* __restrict__ gi_out, float* __restrict__ gio_out,
    float* __restrict__ za_out, float* __restrict__ zao_out,
    float* __restrict__ wa,              // [B, L, K]
    float* __restrict__ wh,              // [B, R, K]
    float* __restrict__ cs_scratch,      // [B, L + R], used when rows stay global
    int L, int R, int K, int viter, float vtol2, float c_hyper, float g_hyper,
    int rows_in_smem) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int LR = L + R;
  float* gi = smem;
  float* gio = gi + K;
  float* za = gio + K;
  float* zao = za + K;
  float* qp = zao + K;
  float* qt = qp + K;
  float* qb = qt + K;
  float* red = qb + K;
  float* cs = rows_in_smem ? red + 32 : cs_scratch + static_cast<size_t>(b) * LR;
  float* rows = red + 32 + LR;
  const int* t = terms + static_cast<size_t>(b) * L;
  const float* c = counts + static_cast<size_t>(b) * L;
  const int* u = readers + static_cast<size_t>(b) * R;
  const float* y = ratings + static_cast<size_t>(b) * R;
  const size_t dk = static_cast<size_t>(b) * K;

  // slot i < L is token i, slot L + j is reader j
  auto weight = [&](int i) -> float { return i < L ? c[i] : y[i - L]; };
  auto table_row = [&](int i) -> const float* {
    return i < L ? ealefT + static_cast<size_t>(t[i]) * K
                 : eheT + static_cast<size_t>(u[i - L]) * K;
  };
  auto row = [&](int i) -> const float* {
    return rows_in_smem ? rows + static_cast<size_t>(i) * K : table_row(i);
  };

  for (int k = tid; k < K; k += kThreads) {
    gi[k] = gi_in[dk + k];
    gio[k] = gio_in[dk + k];
    za[k] = za_in[dk + k];
    zao[k] = zao_in[dk + k];
  }
  if (rows_in_smem) {
    for (int i = warp; i < LR; i += kWarps) {
      if (weight(i) == 0.f) continue;
      const float* src = table_row(i);
      for (int k = lane; k < K; k += 32) rows[static_cast<size_t>(i) * K + k] = src[k];
    }
  }
  __syncthreads();
  // q vectors from (g, z); qt holds qt + qb when `merged`
  auto factors = [&](const float* g, const float* z) {
    for (int k = tid; k < K; k += kThreads) {
      const float eg = expf(digamma_series(g[k]));
      const float ez = expf(digamma_series(z[k]));
      qp[k] = eg * inv_db[k];
      qt[k] = eg * inv_dv[k];
      qb[k] = ez * inv_hv[k];
    }
    __syncthreads();
  };
  // cs_i = weight_i / (row_i . q + eps), q = qp for tokens, qt + qb for
  // readers; 0 on padding slots
  auto normalisers = [&]() {
    for (int i = warp; i < LR; i += kWarps) {
      const float wi = weight(i);
      float r = 0.f;
      if (wi != 0.f) {
        const float* br = row(i);
        float s = 0.f;
        if (i < L) {
          for (int k = lane; k < K; k += 32) s += br[k] * qp[k];
        } else {
          for (int k = lane; k < K; k += 32) s += br[k] * (qt[k] + qb[k]);
        }
        r = wi / (warp_sum(s) + kEps);
      }
      if (lane == 0) cs[i] = r;
    }
    __syncthreads();
  };

  bool active = doc_mask[b] > 0.f;
  for (int it = 0; it < viter && active; ++it) {
    factors(gi, za);
    normalisers();
    // update_gimel!/update_zayin! (CTPF.jl:309-323), one thread per topic
    float dpart = 0.f;
    for (int k = tid; k < K; k += kThreads) {
      float pcs = 0.f, hr = 0.f;
      for (int l = 0; l < L; ++l) {
        const float r = cs[l];
        if (r != 0.f) pcs += r * row(l)[k];
      }
      for (int j = L; j < LR; ++j) {
        const float r = cs[j];
        if (r != 0.f) hr += r * row(j)[k];
      }
      const float gi_new = c_hyper + qp[k] * pcs + qt[k] * hr;
      const float za_new = g_hyper + qb[k] * hr;
      const float d = gi_new - gi[k];
      dpart += d * d;
      gio[k] = gi[k];
      gi[k] = gi_new;
      zao[k] = za[k];
      za[k] = za_new;
    }
    active = block_sum(dpart, red) >= vtol2;
  }

  for (int k = tid; k < K; k += kThreads) {
    gi_out[dk + k] = gi[k];
    gio_out[dk + k] = gio[k];
    za_out[dk + k] = za[k];
    zao_out[dk + k] = zao[k];
  }
  // statistics with phi/xi from (gimel_old, zayin_old)
  factors(gio, zao);
  normalisers();
  for (int i = warp; i < LR; i += kWarps) {
    float* wi = i < L ? wa + (static_cast<size_t>(b) * L + i) * K
                      : wh + (static_cast<size_t>(b) * R + (i - L)) * K;
    const float r = cs[i];
    if (r == 0.f) {
      for (int k = lane; k < K; k += 32) wi[k] = 0.f;
      continue;
    }
    const float* br = row(i);
    if (i < L) {
      for (int k = lane; k < K; k += 32) wi[k] = br[k] * (qp[k] * r);
    } else {
      for (int k = lane; k < K; k += 32) wi[k] = br[k] * ((qt[k] + qb[k]) * r);
    }
  }
}

}  // namespace tmvb

extern "C" {

// 1 when a document of L token and R reader slots keeps its rows in
// shared memory, 0 when it re-reads them from the tables, -1 when the
// device cannot be queried.
int tmvb_ctpf_estep_rows_in_smem(int64_t L, int64_t R, int64_t K) {
  return tmvb::fits_smem(tmvb::ctpf_smem_rows(L, R, K));
}

int tmvb_ctpf_estep(const float* ealefT, const float* eheT, const int* terms,
                    const float* counts, const int* readers, const float* ratings,
                    const float* doc_mask, const float* inv_db, const float* inv_dv,
                    const float* inv_hv, const float* gi_in, const float* gio_in,
                    const float* za_in, const float* zao_in, float* gi_out,
                    float* gio_out, float* za_out, float* zao_out, float* wa, float* wh,
                    float* cs_scratch, int64_t B, int64_t L, int64_t R, int64_t K,
                    int viter, float vtol, float c_hyper, float g_hyper, void* stream) {
  if (B == 0) return 0;
  const int rows_in_smem = tmvb_ctpf_estep_rows_in_smem(L, R, K);
  if (rows_in_smem < 0) return tmvb::query_error();
  const size_t bytes =
      rows_in_smem ? tmvb::ctpf_smem_rows(L, R, K) : tmvb::ctpf_smem_base(K);
  const cudaError_t err = tmvb::allow_smem(tmvb::ctpf_estep_kernel, bytes);
  if (err != cudaSuccess) return tmvb::fail(err);
  tmvb::ctpf_estep_kernel<<<static_cast<unsigned>(B), tmvb::kThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      ealefT, eheT, terms, counts, readers, ratings, doc_mask, inv_db, inv_dv, inv_hv,
      gi_in, gio_in, za_in, zao_in, gi_out, gio_out, za_out, zao_out, wa, wh,
      cs_scratch, static_cast<int>(L), static_cast<int>(R), static_cast<int>(K), viter,
      vtol * vtol, c_hyper, g_hyper, rows_in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
