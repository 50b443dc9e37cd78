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
//     qb = exp(psi(zayin)) / (het vav),    qs = qt + qb
//     r_l = c_l / (sum_k ea[t_l, k] qp_k + eps)           (phi normaliser)
//     x_j = y_j / (sum_k eh[u_j, k] qs_k + eps)           (2K xi normaliser)
//     h_k = sum_j x_j eh[u_j, k]
//     gimel = c + qp_k sum_l r_l ea[t_l, k] + qt_k h_k    (gimel_old: the old)
//     zayin = g + qb_k h_k                                (zayin_old: the old)
//     stop once |gimel - gimel_old|^2 < vtol^2            (CTPF.jl:359)
//   wa[l, k] = ea[t_l, k] (qp_k r_l),  wh[j, k] = eh[u_j, k] (qs_k x_j)
//   with q, r and x from (gimel_old, zayin_old)           (CTPF.jl:259-277)
//
// What bounds it on an H100: bytes, through the writes of wa and wh.  At
// CiteULike's widest chunk (B = 1024, L = 80, R = 24, K = 100) it must read
// the distinct table rows, the slots and the state (~6 MB) and write
// 42.6 MB of rows and 1.6 MB of state: ~15 us at 3.35 TB/s.  A pass is
// two matrix-vector products on the document's own (L + R) x K rows, ~4K
// flops a kept slot, and 2K psi and exp on the [K] vectors.  No tensor
// cores: each product has one right-hand column.
//
// Design (256 threads, one document per block; the layout of
// lda_estep.cu and flda_estep.cu):
// - The slots with a weight (c_l != 0, y_j != 0) are compacted into one
//   list, the document's tokens first and then its readers, each in slot
//   order; per compact slot it holds the weight, its c / s (r or x) and
//   its slot.  Padding slots never enter a pass; their wa/wh rows are
//   zeros, written with 16-byte stores where K % 4 == 0.
// - Rows come by cp.async through L1 (.ca), 16 bytes where K % 4 == 0
//   and both tables are 16-byte aligned, token rows from ea by term and
//   reader rows from eh by user (rows.cuh's load_rows, once per table),
//   into a stride of 2 x an odd number of float4s (104 floats at K = 100)
//   whose padding columns are zeros.
// - The normalisers: 2 threads a slot, float4 loads of the row and of q
//   (qp for tokens, qs for readers; q's padding columns are zeros), one
//   shuffle; r or x is then thread-local and goes to the slot list.
// - The product: threads over (float4 of topics, share of slots), one
//   sum over token slots (pcs) and one over reader slots (h); the shares'
//   partials are added in share order by each topic's thread.
// - The update: each topic's thread forms gimel_new, zayin_new and its
//   d^2, then exp(psi) of both into the other q buffer (qp, qt, qb and qs
//   of the next pass) before the barrier of the stop test.  Three barriers
//   a pass: after the normalisers, after the product, the stop test.  The
//   stop test's partials alternate between two slots, pass by pass: a
//   document with no kept slot passes only that one barrier a pass.
//   Every sum runs in one fixed order: same inputs, same bits.
// - wa/wh are written from the last pass's q and r/x: they were computed
//   from (gimel, zayin) before its update, which is (gimel_old, zayin_old)
//   after it, so they are the values a recomputation would give, bit for
//   bit.  Only a document that ran no pass (viter 0, or doc_mask 0)
//   computes them from its state.
// - A document whose rows do not fit (L = 768, R = 256 at K = 100 is 426
//   KB) goes through shared memory in tiles of compact slots, re-read from
//   the tables (3.2 MB and 2.2 MB at CiteULike scale, resident in the 50
//   MB L2) on every pass, with the same thread mapping.  Its slot list
//   stays in shared memory when it fits there, else in a [B, 3 (L + R)]
//   scratch in device memory.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/kernel_ab.py and
// tools/estep_sweep.py, in turns): 95.5 us at the widest chunk and 1.51 ms
// at L = 768, R = 256 (viter 10; the previous design, a warp a slot and
// 128 threads, took 357.5 us and 5.11 ms).  A pass costs ~6.6 us a chunk,
// nearly the same at L = 40 as at L = 80: ~3.6 us the normalisers and the
// product, ~1.7 us psi and exp, the rest the update and the barriers.  The
// chunk's 1024 documents take two waves at 4 blocks an SM (registers and
// shared memory both cap it), and 5 blocks an SM (48 registers) still
// take two: no faster.  Dropped, each as fast or slower: 1 and 4 threads
// a slot, 6 and 8 shares, the psi of gimel and of zayin on separate warps
// (qs then formed where it is read), 6 blocks an SM (spills), the padding
// rows' zeros stored before the passes, and the slot list in scratch for
// every tiled document (1.89 ms at L = 768, R = 256 against 1.50).
//
// One block per document, which leaves its loop when its own document
// converges: the reference's per-document break, and the masked tile's
// result on the TPU, since a converged document's state is frozen there.
// K is not padded beyond the stride.
//
// The pass mode (ctpf_estep_pass_kernel), for the sequence axis, where a
// document's token and reader slots are split over ranks: one pass of the
// fixpoint without its update, this rank's partials gsum = qp (r @ ea) +
// qt h and zsum = qb h [B, K], from the block, slot list, rows and
// products above.  The caller sums both over the ranks in one collective
// and forms gimel, zayin, the masks and the stop test on the [B, K]
// tiles; the last rows come from this kernel at viter = 0.  It reads the
// same rows as a pass here and writes the two partials in place of the
// state: one launch a pass.

#include <stdint.h>

#include <algorithm>

#include "rows.cuh"

namespace tmvb {

constexpr int kCThreads = 256;
constexpr int kCWarps = kCThreads / 32;
constexpr int kCMaxShares = 4;   // 6 and 8 measured 1-3% slower
constexpr int kCTps = 2;    // threads a slot in the normalisers
constexpr int kCMeta = 3;   // per-slot arrays of the slot list

// Row stride in floats: a number of float4s that is kCTps times an odd
// number, so the 8 threads of a 16-byte shared load (8 / kCTps slots,
// kCTps neighbouring float4s each) hit 32 different banks.
__host__ __device__ inline int ctpf_stride(int K) {
  const int s = ((K + 3) / 4 + kCTps - 1) / kCTps;
  return 4 * kCTps * (s | 1);
}

__host__ __device__ inline int ctpf_shares(int Kp) {
  const int g = Kp / 4;
  return g >= kCThreads ? 1 : (kCThreads / g < kCMaxShares ? kCThreads / g : kCMaxShares);
}

// Shared memory in floats: rows [tile, Kp], two q buffers (qp, qt, qb, qs
// [Kp] each), the token and reader partials [shares, Kp] each, gimel,
// gimel_old, zayin, zayin_old [K rounded to 4] each, 32 for the stop test
// and the compaction, then the slot list [3, L + R] when it is kept there.
__host__ __device__ inline size_t ctpf_smem(int64_t LR, int K, int64_t tile, bool meta) {
  const int Kp = ctpf_stride(K);
  const size_t base =
      (8 + 2 * ctpf_shares(Kp)) * static_cast<size_t>(Kp) + 4 * ((K + 3) / 4 * 4) + 32;
  return (static_cast<size_t>(tile) * Kp + base + (meta ? kCMeta * LR : 0)) * sizeof(float);
}

struct CtpfShape {
  int tile;          // compact slots whose rows are in shared memory at once
  int meta_in_smem;  // the slot list in shared memory (else device scratch)
  int resident;      // every slot fits: rows loaded once, no tiles
  size_t bytes;
};

// 0, or a CUDA error code when the device cannot be queried or K is too
// wide for one row in shared memory.  All rows stay in shared memory when
// that leaves room for 2 blocks an SM; else tiles sized for 4 blocks (an
// SM's 228 KB less 1 KB the device keeps per block), with the slot list
// in shared memory when it fits beside 32 rows, or in device scratch;
// else tiles of what fits.
inline int ctpf_shape(int64_t LR, int64_t K, CtpfShape* s) {
  const int optin = smem_optin();
  if (optin < 0) return query_error();
  const int k = static_cast<int>(K);
  const size_t full = ctpf_smem(LR, k, LR, true);
  if (full <= static_cast<size_t>(optin) / 2) {
    *s = {static_cast<int>(LR), 1, 1, full};
    return 0;
  }
  const size_t row = ctpf_stride(k) * sizeof(float);
  for (size_t budget : {static_cast<size_t>(optin) / 4 - 1024, static_cast<size_t>(optin)}) {
    const bool meta = ctpf_smem(LR, k, 32, true) <= budget;
    const size_t base = ctpf_smem(LR, k, 0, meta);
    if (base + row > budget) continue;
    const int64_t tile = std::min<int64_t>(LR, static_cast<int64_t>((budget - base) / row));
    *s = {static_cast<int>(tile), meta ? 1 : 0, 0, ctpf_smem(LR, k, tile, meta)};
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// q of (g, z) for topic k into the buffer q: qp, qt, qb, qs at 0, Kp,
// 2 Kp, 3 Kp.
__device__ __forceinline__ void ctpf_factors(float* q, int Kp, int k, float g, float z,
                                             const float* __restrict__ inv_db,
                                             const float* __restrict__ inv_dv,
                                             const float* __restrict__ inv_hv) {
  const float eg = expf(digamma_series(g));
  const float ez = expf(digamma_series(z));
  const float qt = eg * inv_dv[k], qb = ez * inv_hv[k];
  q[k] = eg * inv_db[k];
  q[Kp + k] = qt;
  q[2 * Kp + k] = qb;
  q[3 * Kp + k] = qt + qb;
}

// Rows of compact slots j0 .. j0 + m - 1, the first mt of them tokens,
// into rows[0 .. m), asynchronously; the caller waits and syncs.
__device__ __forceinline__ void ctpf_load(float* rows, const float* __restrict__ ealefT,
                                          const float* __restrict__ eheT, const int* t,
                                          const int* u, const int* mslot, int j0, int m, int mt,
                                          int K, int Kp, bool vec) {
  if (mt > 0) load_rows<kCThreads, true>(rows, ealefT, t, mslot, j0, mt, K, Kp, vec);
  if (m > mt)
    load_rows<kCThreads, true>(rows + static_cast<size_t>(mt) * Kp, eheT, u, mslot, j0 + mt,
                               m - mt, K, Kp, vec);
}

// mcs[j] = mw[j] / (rows[j - j0] . q + eps) for the compact slots j0 ..
// j0 + m - 1, q = qp for the first mt (tokens), qs for the rest; kCTps
// threads a slot.
__device__ __forceinline__ void ctpf_normalisers(const float* rows, int m, int mt, int j0,
                                                 const float* q, const float* mw, float* mcs,
                                                 int Kp) {
  const int G = Kp / 4;
  const int sub = threadIdx.x % kCTps;
  const float4* qp4 = reinterpret_cast<const float4*>(q);
  const float4* qs4 = reinterpret_cast<const float4*>(q + 3 * Kp);
  for (int base = 0; base < m; base += kCThreads / kCTps) {
    const int i = base + threadIdx.x / kCTps;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < m) {
      const float4* r4 = reinterpret_cast<const float4*>(rows + static_cast<size_t>(i) * Kp);
      const float4* q4 = i < mt ? qp4 : qs4;
#pragma unroll 4
      for (int g = sub; g < G; g += kCTps) {
        const float4 x = r4[g], y = q4[g];
        a.x = fmaf(x.x, y.x, a.x);
        a.y = fmaf(x.y, y.y, a.y);
        a.z = fmaf(x.z, y.z, a.z);
        a.w = fmaf(x.w, y.w, a.w);
      }
    }
    float s = (a.x + a.y) + (a.z + a.w);
#pragma unroll
    for (int o = 1; o < kCTps; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (i < m && sub == 0) mcs[j0 + i] = mw[j0 + i] / (s + kEps);
  }
}

// Token and reader partials: pp[h, k] (+)= sum over the token rows i = h,
// h + nsh, ... < mt of cs_i rows[i, k], hp[h, k] the same over the reader
// rows mt + h, ... < m; thread (h, g) owns the float4 g of share h.
__device__ __forceinline__ void ctpf_product(const float* rows, int m, int mt, const float* mcs,
                                             float* pp, float* hp, int Kp, int nsh, bool first) {
  const int G = Kp / 4;
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  float4* p4 = reinterpret_cast<float4*>(pp);
  float4* h4 = reinterpret_cast<float4*>(hp);
  for (int o = threadIdx.x; o < nsh * G; o += kCThreads) {
    const int h = o / G, g = o - h * G;
    float4 p = first ? make_float4(0.f, 0.f, 0.f, 0.f) : p4[o];
    float4 q = first ? make_float4(0.f, 0.f, 0.f, 0.f) : h4[o];
#pragma unroll 4
    for (int i = h; i < mt; i += nsh) {
      const float r = mcs[i];
      const float4 x = r4[static_cast<size_t>(i) * G + g];
      p.x = fmaf(r, x.x, p.x);
      p.y = fmaf(r, x.y, p.y);
      p.z = fmaf(r, x.z, p.z);
      p.w = fmaf(r, x.w, p.w);
    }
#pragma unroll 2
    for (int i = mt + h; i < m; i += nsh) {
      const float r = mcs[i];
      const float4 x = r4[static_cast<size_t>(i) * G + g];
      q.x = fmaf(r, x.x, q.x);
      q.y = fmaf(r, x.y, q.y);
      q.z = fmaf(r, x.z, q.z);
      q.w = fmaf(r, x.w, q.w);
    }
    p4[o] = p;
    h4[o] = q;
  }
}

// wa/wh rows of compact slots j0 .. j0 + m - 1 (the first mt tokens):
// rows[i, k] * (q_k * cs), q = qp for tokens, qs for readers.
__device__ __forceinline__ void ctpf_write(float* __restrict__ wad, float* __restrict__ whd,
                                           const float* rows, int m, int mt, int j0,
                                           const float* q, const float* mcs, const int* mslot,
                                           int K, int Kp, bool vec) {
  const float* qs = q + 3 * Kp;
  if (vec) {
    const int G = Kp / 4, Gw = K / 4;
    const float4* r4 = reinterpret_cast<const float4*>(rows);
    for (int idx = threadIdx.x; idx < m * Gw; idx += kCThreads) {
      const int i = idx / Gw, g = idx - i * Gw;
      const int j = j0 + i;
      const bool tok = i < mt;
      const float r = mcs[j];
      const float4 x = r4[static_cast<size_t>(i) * G + g];
      const float4 y = reinterpret_cast<const float4*>(tok ? q : qs)[g];
      float* dst = (tok ? wad : whd) + static_cast<size_t>(mslot[j]) * K;
      reinterpret_cast<float4*>(dst)[g] =
          make_float4(x.x * (y.x * r), x.y * (y.y * r), x.z * (y.z * r), x.w * (y.w * r));
    }
  } else {
    for (int idx = threadIdx.x; idx < m * K; idx += kCThreads) {
      const int i = idx / K, k = idx - i * K;
      const int j = j0 + i;
      const bool tok = i < mt;
      float* dst = (tok ? wad : whd) + static_cast<size_t>(mslot[j]) * K;
      dst[k] = rows[static_cast<size_t>(i) * Kp + k] * ((tok ? q : qs)[k] * mcs[j]);
    }
  }
}

// Zero rows of the n slots of wd [n, K] whose weight is 0 (padding).
__device__ __forceinline__ void ctpf_zero_padding(float* __restrict__ wd,
                                                  const float* __restrict__ wgt, int n, int K,
                                                  bool vec) {
  const int Kq = vec ? K / 4 : K;
  for (int idx = threadIdx.x; idx < n * Kq; idx += kCThreads) {
    if (wgt[idx / Kq] != 0.f) continue;
    if (vec)
      reinterpret_cast<float4*>(wd)[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
    else
      wd[idx] = 0.f;
  }
}

// Compacts a document's slots with a weight (c_l != 0, y_j != 0) into one
// list, its tokens first and then its readers, each in slot order (the
// order of the slots i < L + R with slot L + j reader j): per compact
// slot its weight and its token or reader slot.  Returns their number and
// the tokens' in *nL.  wcount: 16 ints of shared memory.  Every thread of
// the block must call it.
__device__ __forceinline__ int ctpf_compact(const float* c, const float* y, int L, int R,
                                            float* mw, int* mslot, int* wcount, int* nL) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int LR = L + R;
  int n = 0, nl = 0;
  for (int base = 0; base < LR; base += kCThreads) {
    const int i = base + tid;
    const float wi = i < L ? c[i] : (i < LR ? y[i - L] : 0.f);
    const unsigned real = __ballot_sync(0xffffffffu, wi != 0.f);
    const unsigned tok = __ballot_sync(0xffffffffu, wi != 0.f && i < L);
    if (lane == 0) {
      wcount[warp] = __popc(real);
      wcount[kCWarps + warp] = __popc(tok);
    }
    __syncthreads();
    int off = n, total = n, total_l = nl;
#pragma unroll
    for (int v = 0; v < kCWarps; ++v) {
      off += v < warp ? wcount[v] : 0;
      total += wcount[v];
      total_l += wcount[kCWarps + v];
    }
    if (wi != 0.f) {
      const int j = off + __popc(real & ((1u << lane) - 1u));
      mw[j] = wi;
      mslot[j] = i < L ? i : i - L;
    }
    n = total;
    nl = total_l;
    __syncthreads();  // the list is complete; wcount may be rewritten
  }
  *nL = nl;
  return n;
}

__global__ void __launch_bounds__(kCThreads, 4) ctpf_estep_kernel(
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
    float* scratch,                      // [B, 3 (L + R)], the slot lists when not in smem
    int L, int R, int K, int tile, int meta_in_smem, int resident, int viter, float vtol2,
    float c_hyper, float g_hyper, int vec_in, int vec_out) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int LR = L + R;
  const int Kp = ctpf_stride(K), nsh = ctpf_shares(Kp), K4 = (K + 3) / 4 * 4;
  float* rows = smem;
  float* q_cur = rows + static_cast<size_t>(tile) * Kp;  // qp, qt, qb, qs of this pass
  float* q_nxt = q_cur + 4 * Kp;                         // of the next
  float* ppart = q_nxt + 4 * Kp;                         // token partials [nsh, Kp]
  float* hpart = ppart + nsh * Kp;                       // reader partials [nsh, Kp]
  float* gi = hpart + nsh * Kp;
  float* gio = gi + K4;
  float* za = gio + K4;
  float* zao = za + K4;
  float* red = zao + K4;  // [32]: sum d^2 [2 x 8], compaction counts [16]
  float* meta = meta_in_smem ? red + 32 : scratch + static_cast<size_t>(b) * kCMeta * LR;
  float* mw = meta;                                     // weight of compact slot j
  float* mcs = meta + LR;                               // its r or x
  int* mslot = reinterpret_cast<int*>(meta + 2 * LR);   // its token or reader slot
  const int* t = terms + static_cast<size_t>(b) * L;
  const float* c = counts + static_cast<size_t>(b) * L;
  const int* u = readers + static_cast<size_t>(b) * R;
  const float* y = ratings + static_cast<size_t>(b) * R;
  const size_t dk = static_cast<size_t>(b) * K;

  // the slots with a weight, tokens then readers, each in slot order
  int nL;
  const int n = ctpf_compact(c, y, L, R, mw, mslot, reinterpret_cast<int*>(red + 16), &nL);

  const bool vin = vec_in != 0;
  if (resident) ctpf_load(rows, ealefT, eheT, t, u, mslot, 0, n, nL, K, Kp, vin);
  for (int k = tid; k < Kp; k += kCThreads) {
    if (k < K) {
      const float g0 = gi_in[dk + k], z0 = za_in[dk + k];
      gi[k] = g0;
      gio[k] = gio_in[dk + k];
      za[k] = z0;
      zao[k] = zao_in[dk + k];
      ctpf_factors(q_cur, Kp, k, g0, z0, inv_db, inv_dv, inv_hv);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        q_cur[v * Kp + k] = 0.f;
        q_nxt[v * Kp + k] = 0.f;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  bool active = doc_mask[b] > 0.f;
  int it = 0;
  for (; it < viter && active; ++it) {
    for (int j0 = 0; j0 < n; j0 += tile) {
      const int m = min(tile, n - j0), mt = max(0, min(m, nL - j0));
      if (!resident) {
        ctpf_load(rows, ealefT, eheT, t, u, mslot, j0, m, mt, K, Kp, vin);
        cp_async_wait_all();
        __syncthreads();
      }
      ctpf_normalisers(rows, m, mt, j0, q_cur, mw, mcs, Kp);
      __syncthreads();
      ctpf_product(rows, m, mt, mcs + j0, ppart, hpart, Kp, nsh, j0 == 0);
      __syncthreads();
    }
    // update_gimel!/update_zayin! (CTPF.jl:309-323), then the next pass's
    // q from the new state, before the barrier of the stop test
    float dpart = 0.f;
    for (int k = tid; k < K; k += kCThreads) {
      float pc = 0.f, hr = 0.f;
      if (n > 0) {
        for (int h = 0; h < nsh; ++h) {
          pc += ppart[h * Kp + k];
          hr += hpart[h * Kp + k];
        }
      }
      const float gi_new = c_hyper + q_cur[k] * pc + q_cur[Kp + k] * hr;
      const float za_new = g_hyper + q_cur[2 * Kp + k] * hr;
      const float d = gi_new - gi[k];
      dpart += d * d;
      gio[k] = gi[k];
      gi[k] = gi_new;
      zao[k] = za[k];
      za[k] = za_new;
      ctpf_factors(q_nxt, Kp, k, gi_new, za_new, inv_db, inv_dv, inv_hv);
    }
    // consecutive passes sum into different halves of red[0, 16): a pass
    // with no kept slot (n == 0) has no barrier but this one, so a warp
    // may write the next pass's partial while another still reads these
    active = block_sum_once<kCWarps>(dpart, red + kCWarps * (it & 1)) >= vtol2;
    float* q = q_cur;
    q_cur = q_nxt;
    q_nxt = q;
  }

  // statistics with phi/xi from (gimel_old, zayin_old): the last pass's q
  // and r/x, or, when no pass ran, anew from the state as given
  const bool ran = it > 0;
  const float* q_last = q_nxt;
  if (!ran) {
    for (int k = tid; k < K; k += kCThreads)
      ctpf_factors(q_cur, Kp, k, gio[k], zao[k], inv_db, inv_dv, inv_hv);
    q_last = q_cur;
    __syncthreads();
  }
  for (int k = tid; k < K; k += kCThreads) {
    gi_out[dk + k] = gi[k];
    gio_out[dk + k] = gio[k];
    za_out[dk + k] = za[k];
    zao_out[dk + k] = zao[k];
  }
  float* wad = wa + static_cast<size_t>(b) * L * K;
  float* whd = wh + static_cast<size_t>(b) * R * K;
  const bool vout = vec_out != 0;
  ctpf_zero_padding(wad, c, L, K, vout);
  ctpf_zero_padding(whd, y, R, K, vout);
  for (int j0 = 0; j0 < n; j0 += tile) {
    const int m = min(tile, n - j0), mt = max(0, min(m, nL - j0));
    if (!resident) {
      ctpf_load(rows, ealefT, eheT, t, u, mslot, j0, m, mt, K, Kp, vin);
      cp_async_wait_all();
      __syncthreads();
    }
    if (!ran) {
      ctpf_normalisers(rows, m, mt, j0, q_last, mw, mcs, Kp);
      __syncthreads();
    }
    ctpf_write(wad, whd, rows, m, mt, j0, q_last, mcs, mslot, K, Kp, vout);
    if (!resident) __syncthreads();  // before the next tile's rows land
  }
}

// One pass of the fixpoint without its update, for the sequence axis:
// this rank's partials gsum[b, k] = qp_k sum_l r_l ea[t_l, k] + qt_k h_k
// (phi @ counts + xi_top @ ratings) and zsum[b, k] = qb_k h_k (xi_bot @
// ratings) over the document's own token and reader slots, q from
// (gimel, zayin) as above.  The caller sums them over the ranks that hold
// the document's other slots and forms gimel = c + gsum and zayin = g +
// zsum, the masks and the stop test on the [B, K] tiles between passes.
// Same block, shared-memory layout, slot list, rows and products as
// ctpf_estep_kernel; a document with doc_mask 0 gets zeros and reads
// nothing else.  One fixed order for every sum: same inputs, same bits.
__global__ void __launch_bounds__(kCThreads, 4) ctpf_estep_pass_kernel(
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
    const float* __restrict__ gi_in,     // [B, K]
    const float* __restrict__ za_in,     // [B, K]
    float* __restrict__ gsum,            // [B, K]
    float* __restrict__ zsum,            // [B, K]
    float* scratch,                      // [B, 3 (L + R)], the slot lists when not in smem
    int L, int R, int K, int tile, int meta_in_smem, int resident, int vec_in) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t dk = static_cast<size_t>(b) * K;
  if (!(doc_mask[b] > 0.f)) {
    for (int k = tid; k < K; k += kCThreads) {
      gsum[dk + k] = 0.f;
      zsum[dk + k] = 0.f;
    }
    return;
  }
  const int LR = L + R;
  const int Kp = ctpf_stride(K), nsh = ctpf_shares(Kp), K4 = (K + 3) / 4 * 4;
  float* rows = smem;
  float* q = rows + static_cast<size_t>(tile) * Kp;  // qp, qt, qb, qs
  float* ppart = q + 8 * Kp;
  float* hpart = ppart + nsh * Kp;
  float* red = hpart + nsh * Kp + 4 * K4;
  float* meta = meta_in_smem ? red + 32 : scratch + static_cast<size_t>(b) * kCMeta * LR;
  float* mw = meta;
  float* mcs = meta + LR;
  int* mslot = reinterpret_cast<int*>(meta + 2 * LR);
  const int* t = terms + static_cast<size_t>(b) * L;
  const int* u = readers + static_cast<size_t>(b) * R;

  int nL;
  const int n = ctpf_compact(counts + static_cast<size_t>(b) * L,
                             ratings + static_cast<size_t>(b) * R, L, R, mw, mslot,
                             reinterpret_cast<int*>(red + 16), &nL);
  const bool vin = vec_in != 0;
  if (resident) ctpf_load(rows, ealefT, eheT, t, u, mslot, 0, n, nL, K, Kp, vin);
  for (int k = tid; k < Kp; k += kCThreads) {
    if (k < K) {
      ctpf_factors(q, Kp, k, gi_in[dk + k], za_in[dk + k], inv_db, inv_dv, inv_hv);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v) q[v * Kp + k] = 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  for (int j0 = 0; j0 < n; j0 += tile) {
    const int m = min(tile, n - j0), mt = max(0, min(m, nL - j0));
    if (!resident) {
      ctpf_load(rows, ealefT, eheT, t, u, mslot, j0, m, mt, K, Kp, vin);
      cp_async_wait_all();
      __syncthreads();
    }
    ctpf_normalisers(rows, m, mt, j0, q, mw, mcs, Kp);
    __syncthreads();
    ctpf_product(rows, m, mt, mcs + j0, ppart, hpart, Kp, nsh, j0 == 0);
    __syncthreads();
  }
  for (int k = tid; k < K; k += kCThreads) {
    float pc = 0.f, hr = 0.f;
    if (n > 0) {
      for (int h = 0; h < nsh; ++h) {
        pc += ppart[h * Kp + k];
        hr += hpart[h * Kp + k];
      }
    }
    gsum[dk + k] = q[k] * pc + q[Kp + k] * hr;
    zsum[dk + k] = q[2 * Kp + k] * hr;
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace tmvb

extern "C" {

// 1 when every row of a document of L token and R reader slots stays in
// shared memory, 0 when its rows go through in tiles, -1 when the device
// cannot be queried.
int tmvb_ctpf_estep_rows_in_smem(int64_t L, int64_t R, int64_t K) {
  tmvb::CtpfShape s;
  return tmvb::ctpf_shape(L + R, K, &s) != 0 ? -1 : s.resident;
}

// Floats of device scratch a document needs: 3 (L + R) when its slot list
// does not fit shared memory, else 0; -1 on an error.
int64_t tmvb_ctpf_estep_scratch(int64_t L, int64_t R, int64_t K) {
  tmvb::CtpfShape s;
  return tmvb::ctpf_shape(L + R, K, &s) != 0 ? -1
                                             : (s.meta_in_smem ? 0 : tmvb::kCMeta * (L + R));
}

int tmvb_ctpf_estep(const float* ealefT, const float* eheT, const int* terms,
                    const float* counts, const int* readers, const float* ratings,
                    const float* doc_mask, const float* inv_db, const float* inv_dv,
                    const float* inv_hv, const float* gi_in, const float* gio_in,
                    const float* za_in, const float* zao_in, float* gi_out,
                    float* gio_out, float* za_out, float* zao_out, float* wa, float* wh,
                    float* scratch, int64_t B, int64_t L, int64_t R, int64_t K,
                    int viter, float vtol, float c_hyper, float g_hyper, void* stream) {
  if (B == 0) return 0;
  tmvb::CtpfShape s;
  const int rc = tmvb::ctpf_shape(L + R, K, &s);
  if (rc != 0) return tmvb::fail(static_cast<cudaError_t>(rc));
  if (!s.meta_in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = tmvb::allow_smem(tmvb::ctpf_estep_kernel, s.bytes);
  if (err != cudaSuccess) return tmvb::fail(err);
  const bool vec = K % 4 == 0;
  const int vec_in = vec && tmvb::aligned16(ealefT) && tmvb::aligned16(eheT);
  const int vec_out = vec && tmvb::aligned16(wa) && tmvb::aligned16(wh);
  tmvb::ctpf_estep_kernel<<<static_cast<unsigned>(B), tmvb::kCThreads, s.bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      ealefT, eheT, terms, counts, readers, ratings, doc_mask, inv_db, inv_dv, inv_hv,
      gi_in, gio_in, za_in, zao_in, gi_out, gio_out, za_out, zao_out, wa, wh, scratch,
      static_cast<int>(L), static_cast<int>(R), static_cast<int>(K), s.tile, s.meta_in_smem,
      s.resident, viter, vtol * vtol, c_hyper, g_hyper, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// The pass mode: gsum and zsum [B, K] (see ctpf_estep_pass_kernel);
// scratch as for tmvb_ctpf_estep.
int tmvb_ctpf_estep_pass(const float* ealefT, const float* eheT, const int* terms,
                         const float* counts, const int* readers, const float* ratings,
                         const float* doc_mask, const float* inv_db, const float* inv_dv,
                         const float* inv_hv, const float* gi_in, const float* za_in,
                         float* gsum, float* zsum, float* scratch, int64_t B, int64_t L,
                         int64_t R, int64_t K, void* stream) {
  if (B == 0) return 0;
  tmvb::CtpfShape s;
  const int rc = tmvb::ctpf_shape(L + R, K, &s);
  if (rc != 0) return tmvb::fail(static_cast<cudaError_t>(rc));
  if (!s.meta_in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = tmvb::allow_smem(tmvb::ctpf_estep_pass_kernel, s.bytes);
  if (err != cudaSuccess) return tmvb::fail(err);
  const int vec_in = K % 4 == 0 && tmvb::aligned16(ealefT) && tmvb::aligned16(eheT);
  tmvb::ctpf_estep_pass_kernel<<<static_cast<unsigned>(B), tmvb::kCThreads, s.bytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      ealefT, eheT, terms, counts, readers, ratings, doc_mask, inv_db, inv_dv, inv_hv, gi_in,
      za_in, gsum, zsum, scratch, static_cast<int>(L), static_cast<int>(R), static_cast<int>(K),
      s.tile, s.meta_in_smem, s.resident, vec_in);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
