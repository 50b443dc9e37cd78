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
//
// The float64 mode (R = double; tmvb_ctpf_estep_f64, tmvb_ctpf_estep_pass_f64):
// both kernels on a float64 state, every input, output and sum in double,
// psi the same shift-by-8 series in double (what the plain version
// computes on a float64 state), exp the double exp.  The JAX package runs
// its kernel in the state's dtype (its ctpf_estep output specs follow
// gimel's dtype).  What bounds it: bytes again, doubled (~88 MB at
// CiteULike's widest chunk, ~26 us at 3.35 TB/s).  Every size in shared
// memory is in 8-byte elements, so the token and reader rows' shared slab
// holds half the slots: CiteULike's widest documents (L + R = 104 at K =
// 100) still stay resident with 2 blocks an SM (launch bounds 2, not 4);
// wider ones go through tiles of half the f32 width.  Four doubles are a
// Double4 (two 16-byte accesses); the tables' rows are copied 16 bytes
// (two doubles) at a time where K is even.  The float32 instantiations
// make the same calls as before: their bits do not move.

#include <stdint.h>

#include <algorithm>

#include "rows.cuh"

namespace tmvb {

constexpr int kCThreads = 256;
constexpr int kCWarps = kCThreads / 32;
constexpr int kCMaxShares = 4;   // 6 and 8 measured 1-3% slower
constexpr int kCTps = 2;    // threads a slot in the normalisers
constexpr int kCMeta = 3;   // per-slot arrays of the slot list

// Row stride in elements: a number of 4-element groups that is kCTps
// times an odd number, so the 8 threads of a 16-byte shared load (8 /
// kCTps slots, kCTps neighbouring float4s each) hit 32 different banks.
__host__ __device__ inline int ctpf_stride(int K) {
  const int s = ((K + 3) / 4 + kCTps - 1) / kCTps;
  return 4 * kCTps * (s | 1);
}

__host__ __device__ inline int ctpf_shares(int Kp) {
  const int g = Kp / 4;
  return g >= kCThreads ? 1 : (kCThreads / g < kCMaxShares ? kCThreads / g : kCMaxShares);
}

// Shared memory in elements of R (float, or double in the float64 mode):
// rows [tile, Kp], two q buffers (qp, qt, qb, qs [Kp] each), the token and
// reader partials [shares, Kp] each, gimel, gimel_old, zayin, zayin_old [K
// rounded to 4] each, 32 for the stop test and the compaction, then the
// slot list [3, L + R] when it is kept there.
template <typename R>
__host__ __device__ inline size_t ctpf_smem(int64_t LR, int K, int64_t tile, bool meta) {
  const int Kp = ctpf_stride(K);
  const size_t base =
      (8 + 2 * ctpf_shares(Kp)) * static_cast<size_t>(Kp) + 4 * ((K + 3) / 4 * 4) + 32;
  return (static_cast<size_t>(tile) * Kp + base + (meta ? kCMeta * LR : 0)) * sizeof(R);
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
// else tiles of what fits.  In the float64 mode (R = double) every element
// takes 8 bytes, so the resident L + R, the tile and the widest K halve.
template <typename R>
inline int ctpf_shape(int64_t LR, int64_t K, CtpfShape* s) {
  const int optin = smem_optin();
  if (optin < 0) return query_error();
  const int k = static_cast<int>(K);
  const size_t full = ctpf_smem<R>(LR, k, LR, true);
  if (full <= static_cast<size_t>(optin) / 2) {
    *s = {static_cast<int>(LR), 1, 1, full};
    return 0;
  }
  const size_t row = ctpf_stride(k) * sizeof(R);
  for (size_t budget : {static_cast<size_t>(optin) / 4 - 1024, static_cast<size_t>(optin)}) {
    const bool meta = ctpf_smem<R>(LR, k, 32, true) <= budget;
    const size_t base = ctpf_smem<R>(LR, k, 0, meta);
    if (base + row > budget) continue;
    const int64_t tile = std::min<int64_t>(LR, static_cast<int64_t>((budget - base) / row));
    *s = {static_cast<int>(tile), meta ? 1 : 0, 0, ctpf_smem<R>(LR, k, tile, meta)};
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// q of (g, z) for topic k into the buffer q: qp, qt, qb, qs at 0, Kp,
// 2 Kp, 3 Kp.
template <typename R>
__device__ __forceinline__ void ctpf_factors(R* q, int Kp, int k, R g, R z,
                                             const R* __restrict__ inv_db,
                                             const R* __restrict__ inv_dv,
                                             const R* __restrict__ inv_hv) {
  const R eg = Real<R>::exp(digamma_series(g));
  const R ez = Real<R>::exp(digamma_series(z));
  const R qt = eg * inv_dv[k], qb = ez * inv_hv[k];
  q[k] = eg * inv_db[k];
  q[Kp + k] = qt;
  q[2 * Kp + k] = qb;
  q[3 * Kp + k] = qt + qb;
}

// Rows of compact slots j0 .. j0 + m - 1, the first mt of them tokens,
// into rows[0 .. m), asynchronously; the caller waits and syncs.
template <typename R>
__device__ __forceinline__ void ctpf_load(R* rows, const R* __restrict__ ealefT,
                                          const R* __restrict__ eheT, const int* t,
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
template <typename R>
__device__ __forceinline__ void ctpf_normalisers(const R* rows, int m, int mt, int j0,
                                                 const R* q, const R* mw, R* mcs, int Kp) {
  using V4 = typename Real<R>::V4;
  const int G = Kp / 4;
  const int sub = threadIdx.x % kCTps;
  const V4* qp4 = reinterpret_cast<const V4*>(q);
  const V4* qs4 = reinterpret_cast<const V4*>(q + 3 * Kp);
  for (int base = 0; base < m; base += kCThreads / kCTps) {
    const int i = base + threadIdx.x / kCTps;
    V4 a = Real<R>::zero4();
    if (i < m) {
      const V4* r4 = reinterpret_cast<const V4*>(rows + static_cast<size_t>(i) * Kp);
      const V4* q4 = i < mt ? qp4 : qs4;
#pragma unroll 4
      for (int g = sub; g < G; g += kCTps) {
        const V4 x = r4[g], y = q4[g];
        a.x = Real<R>::fma(x.x, y.x, a.x);
        a.y = Real<R>::fma(x.y, y.y, a.y);
        a.z = Real<R>::fma(x.z, y.z, a.z);
        a.w = Real<R>::fma(x.w, y.w, a.w);
      }
    }
    R s = (a.x + a.y) + (a.z + a.w);
#pragma unroll
    for (int o = 1; o < kCTps; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (i < m && sub == 0) mcs[j0 + i] = mw[j0 + i] / (s + Real<R>::eps);
  }
}

// Token and reader partials: pp[h, k] (+)= sum over the token rows i = h,
// h + nsh, ... < mt of cs_i rows[i, k], hp[h, k] the same over the reader
// rows mt + h, ... < m; thread (h, g) owns the 4-group g of share h.
template <typename R>
__device__ __forceinline__ void ctpf_product(const R* rows, int m, int mt, const R* mcs,
                                             R* pp, R* hp, int Kp, int nsh, bool first) {
  using V4 = typename Real<R>::V4;
  const int G = Kp / 4;
  const V4* r4 = reinterpret_cast<const V4*>(rows);
  V4* p4 = reinterpret_cast<V4*>(pp);
  V4* h4 = reinterpret_cast<V4*>(hp);
  for (int o = threadIdx.x; o < nsh * G; o += kCThreads) {
    const int h = o / G, g = o - h * G;
    V4 p = first ? Real<R>::zero4() : p4[o];
    V4 q = first ? Real<R>::zero4() : h4[o];
#pragma unroll 4
    for (int i = h; i < mt; i += nsh) {
      const R r = mcs[i];
      const V4 x = r4[static_cast<size_t>(i) * G + g];
      p.x = Real<R>::fma(r, x.x, p.x);
      p.y = Real<R>::fma(r, x.y, p.y);
      p.z = Real<R>::fma(r, x.z, p.z);
      p.w = Real<R>::fma(r, x.w, p.w);
    }
#pragma unroll 2
    for (int i = mt + h; i < m; i += nsh) {
      const R r = mcs[i];
      const V4 x = r4[static_cast<size_t>(i) * G + g];
      q.x = Real<R>::fma(r, x.x, q.x);
      q.y = Real<R>::fma(r, x.y, q.y);
      q.z = Real<R>::fma(r, x.z, q.z);
      q.w = Real<R>::fma(r, x.w, q.w);
    }
    p4[o] = p;
    h4[o] = q;
  }
}

// wa/wh rows of compact slots j0 .. j0 + m - 1 (the first mt tokens):
// rows[i, k] * (q_k * cs), q = qp for tokens, qs for readers.
template <typename R>
__device__ __forceinline__ void ctpf_write(R* __restrict__ wad, R* __restrict__ whd,
                                           const R* rows, int m, int mt, int j0,
                                           const R* q, const R* mcs, const int* mslot,
                                           int K, int Kp, bool vec) {
  using V4 = typename Real<R>::V4;
  const R* qs = q + 3 * Kp;
  if (vec) {
    const int G = Kp / 4, Gw = K / 4;
    const V4* r4 = reinterpret_cast<const V4*>(rows);
    for (int idx = threadIdx.x; idx < m * Gw; idx += kCThreads) {
      const int i = idx / Gw, g = idx - i * Gw;
      const int j = j0 + i;
      const bool tok = i < mt;
      const R r = mcs[j];
      const V4 x = r4[static_cast<size_t>(i) * G + g];
      const V4 y = reinterpret_cast<const V4*>(tok ? q : qs)[g];
      R* dst = (tok ? wad : whd) + static_cast<size_t>(mslot[j]) * K;
      reinterpret_cast<V4*>(dst)[g] =
          V4{x.x * (y.x * r), x.y * (y.y * r), x.z * (y.z * r), x.w * (y.w * r)};
    }
  } else {
    for (int idx = threadIdx.x; idx < m * K; idx += kCThreads) {
      const int i = idx / K, k = idx - i * K;
      const int j = j0 + i;
      const bool tok = i < mt;
      R* dst = (tok ? wad : whd) + static_cast<size_t>(mslot[j]) * K;
      dst[k] = rows[static_cast<size_t>(i) * Kp + k] * ((tok ? q : qs)[k] * mcs[j]);
    }
  }
}

// Zero rows of the n slots of wd [n, K] whose weight is 0 (padding).
template <typename R>
__device__ __forceinline__ void ctpf_zero_padding(R* __restrict__ wd,
                                                  const R* __restrict__ wgt, int n, int K,
                                                  bool vec) {
  const int Kq = vec ? K / 4 : K;
  for (int idx = threadIdx.x; idx < n * Kq; idx += kCThreads) {
    if (wgt[idx / Kq] != R(0)) continue;
    if (vec)
      reinterpret_cast<typename Real<R>::V4*>(wd)[idx] = Real<R>::zero4();
    else
      wd[idx] = R(0);
  }
}

// Compacts a document's slots with a weight (c_l != 0, y_j != 0) into one
// list, its tokens first and then its readers, each in slot order (the
// order of the slots i < L + R with slot L + j reader j): per compact
// slot its weight and its token or reader slot.  Returns their number and
// the tokens' in *nL.  wcount: 16 ints of shared memory.  Every thread of
// the block must call it.
template <typename R>
__device__ __forceinline__ int ctpf_compact(const R* c, const R* y, int L, int Rn,
                                            R* mw, int* mslot, int* wcount, int* nL) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int LR = L + Rn;
  int n = 0, nl = 0;
  for (int base = 0; base < LR; base += kCThreads) {
    const int i = base + tid;
    const R wi = i < L ? c[i] : (i < LR ? y[i - L] : R(0));
    const unsigned real = __ballot_sync(0xffffffffu, wi != R(0));
    const unsigned tok = __ballot_sync(0xffffffffu, wi != R(0) && i < L);
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
    if (wi != R(0)) {
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

// R = float: the float32 mode; R = double: the float64 mode, every input,
// output and sum in double.  Two blocks an SM for double: a row tile is
// twice the bytes.
template <typename R>
__global__ void __launch_bounds__(kCThreads, sizeof(R) == 4 ? 4 : 2) ctpf_estep_kernel(
    const R* __restrict__ ealefT,    // [V, K] exp(psi(alef))^T
    const R* __restrict__ eheT,      // [U, K] exp(psi(he))^T
    const int* __restrict__ terms,   // [B, L]
    const R* __restrict__ counts,    // [B, L], 0 on padding
    const int* __restrict__ readers, // [B, Rn]
    const R* __restrict__ ratings,   // [B, Rn], 0 on padding
    const R* __restrict__ doc_mask,  // [B]
    const R* __restrict__ inv_db,    // [K] 1 / (dalet bet)
    const R* __restrict__ inv_dv,    // [K] 1 / (dalet vav)
    const R* __restrict__ inv_hv,    // [K] 1 / (het vav)
    const R* __restrict__ gi_in, const R* __restrict__ gio_in,
    const R* __restrict__ za_in, const R* __restrict__ zao_in,  // [B, K]
    R* __restrict__ gi_out, R* __restrict__ gio_out,
    R* __restrict__ za_out, R* __restrict__ zao_out,
    R* __restrict__ wa,              // [B, L, K]
    R* __restrict__ wh,              // [B, Rn, K]
    R* scratch,                      // [B, 3 (L + Rn)], the slot lists when not in smem
    int L, int Rn, int K, int tile, int meta_in_smem, int resident, int viter, R vtol2,
    R c_hyper, R g_hyper, int vec_in, int vec_out) {
  extern __shared__ __align__(16) unsigned char ctpf_smem_raw[];
  R* smem = reinterpret_cast<R*>(ctpf_smem_raw);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int LR = L + Rn;
  const int Kp = ctpf_stride(K), nsh = ctpf_shares(Kp), K4 = (K + 3) / 4 * 4;
  R* rows = smem;
  R* q_cur = rows + static_cast<size_t>(tile) * Kp;  // qp, qt, qb, qs of this pass
  R* q_nxt = q_cur + 4 * Kp;                         // of the next
  R* ppart = q_nxt + 4 * Kp;                         // token partials [nsh, Kp]
  R* hpart = ppart + nsh * Kp;                       // reader partials [nsh, Kp]
  R* gi = hpart + nsh * Kp;
  R* gio = gi + K4;
  R* za = gio + K4;
  R* zao = za + K4;
  R* red = zao + K4;  // [32]: sum d^2 [2 x 8], compaction counts [16 ints]
  R* meta = meta_in_smem ? red + 32 : scratch + static_cast<size_t>(b) * kCMeta * LR;
  R* mw = meta;                                     // weight of compact slot j
  R* mcs = meta + LR;                               // its r or x
  int* mslot = reinterpret_cast<int*>(meta + 2 * LR);   // its token or reader slot
  const int* t = terms + static_cast<size_t>(b) * L;
  const R* c = counts + static_cast<size_t>(b) * L;
  const int* u = readers + static_cast<size_t>(b) * Rn;
  const R* y = ratings + static_cast<size_t>(b) * Rn;
  const size_t dk = static_cast<size_t>(b) * K;

  // the slots with a weight, tokens then readers, each in slot order
  int nL;
  const int n = ctpf_compact(c, y, L, Rn, mw, mslot, reinterpret_cast<int*>(red + 16), &nL);

  const bool vin = vec_in != 0;
  if (resident) ctpf_load(rows, ealefT, eheT, t, u, mslot, 0, n, nL, K, Kp, vin);
  for (int k = tid; k < Kp; k += kCThreads) {
    if (k < K) {
      const R g0 = gi_in[dk + k], z0 = za_in[dk + k];
      gi[k] = g0;
      gio[k] = gio_in[dk + k];
      za[k] = z0;
      zao[k] = zao_in[dk + k];
      ctpf_factors(q_cur, Kp, k, g0, z0, inv_db, inv_dv, inv_hv);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        q_cur[v * Kp + k] = R(0);
        q_nxt[v * Kp + k] = R(0);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  bool active = doc_mask[b] > R(0);
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
    R dpart = R(0);
    for (int k = tid; k < K; k += kCThreads) {
      R pc = R(0), hr = R(0);
      if (n > 0) {
        for (int h = 0; h < nsh; ++h) {
          pc += ppart[h * Kp + k];
          hr += hpart[h * Kp + k];
        }
      }
      const R gi_new = c_hyper + q_cur[k] * pc + q_cur[Kp + k] * hr;
      const R za_new = g_hyper + q_cur[2 * Kp + k] * hr;
      const R d = gi_new - gi[k];
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
    R* q = q_cur;
    q_cur = q_nxt;
    q_nxt = q;
  }

  // statistics with phi/xi from (gimel_old, zayin_old): the last pass's q
  // and r/x, or, when no pass ran, anew from the state as given
  const bool ran = it > 0;
  const R* q_last = q_nxt;
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
  R* wad = wa + static_cast<size_t>(b) * L * K;
  R* whd = wh + static_cast<size_t>(b) * Rn * K;
  const bool vout = vec_out != 0;
  ctpf_zero_padding(wad, c, L, K, vout);
  ctpf_zero_padding(whd, y, Rn, K, vout);
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
template <typename R>
__global__ void __launch_bounds__(kCThreads, sizeof(R) == 4 ? 4 : 2) ctpf_estep_pass_kernel(
    const R* __restrict__ ealefT,    // [V, K] exp(psi(alef))^T
    const R* __restrict__ eheT,      // [U, K] exp(psi(he))^T
    const int* __restrict__ terms,   // [B, L]
    const R* __restrict__ counts,    // [B, L], 0 on padding
    const int* __restrict__ readers, // [B, Rn]
    const R* __restrict__ ratings,   // [B, Rn], 0 on padding
    const R* __restrict__ doc_mask,  // [B]
    const R* __restrict__ inv_db,    // [K] 1 / (dalet bet)
    const R* __restrict__ inv_dv,    // [K] 1 / (dalet vav)
    const R* __restrict__ inv_hv,    // [K] 1 / (het vav)
    const R* __restrict__ gi_in,     // [B, K]
    const R* __restrict__ za_in,     // [B, K]
    R* __restrict__ gsum,            // [B, K]
    R* __restrict__ zsum,            // [B, K]
    R* scratch,                      // [B, 3 (L + Rn)], the slot lists when not in smem
    int L, int Rn, int K, int tile, int meta_in_smem, int resident, int vec_in) {
  extern __shared__ __align__(16) unsigned char ctpf_smem_raw[];
  R* smem = reinterpret_cast<R*>(ctpf_smem_raw);
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t dk = static_cast<size_t>(b) * K;
  if (!(doc_mask[b] > R(0))) {
    for (int k = tid; k < K; k += kCThreads) {
      gsum[dk + k] = R(0);
      zsum[dk + k] = R(0);
    }
    return;
  }
  const int LR = L + Rn;
  const int Kp = ctpf_stride(K), nsh = ctpf_shares(Kp), K4 = (K + 3) / 4 * 4;
  R* rows = smem;
  R* q = rows + static_cast<size_t>(tile) * Kp;  // qp, qt, qb, qs
  R* ppart = q + 8 * Kp;
  R* hpart = ppart + nsh * Kp;
  R* red = hpart + nsh * Kp + 4 * K4;
  R* meta = meta_in_smem ? red + 32 : scratch + static_cast<size_t>(b) * kCMeta * LR;
  R* mw = meta;
  R* mcs = meta + LR;
  int* mslot = reinterpret_cast<int*>(meta + 2 * LR);
  const int* t = terms + static_cast<size_t>(b) * L;
  const int* u = readers + static_cast<size_t>(b) * Rn;

  int nL;
  const int n = ctpf_compact(counts + static_cast<size_t>(b) * L,
                             ratings + static_cast<size_t>(b) * Rn, L, Rn, mw, mslot,
                             reinterpret_cast<int*>(red + 16), &nL);
  const bool vin = vec_in != 0;
  if (resident) ctpf_load(rows, ealefT, eheT, t, u, mslot, 0, n, nL, K, Kp, vin);
  for (int k = tid; k < Kp; k += kCThreads) {
    if (k < K) {
      ctpf_factors(q, Kp, k, gi_in[dk + k], za_in[dk + k], inv_db, inv_dv, inv_hv);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v) q[v * Kp + k] = R(0);
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
    R pc = R(0), hr = R(0);
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

// vec_in: K a multiple of the elements in 16 bytes (4 floats, 2 doubles)
// and both tables 16-byte aligned; vec_out: K % 4 == 0 and both row
// outputs 16-byte aligned.
template <typename R>
int launch_ctpf(const R* ealefT, const R* eheT, const int* terms, const R* counts,
                const int* readers, const R* ratings, const R* doc_mask, const R* inv_db,
                const R* inv_dv, const R* inv_hv, const R* gi_in, const R* gio_in,
                const R* za_in, const R* zao_in, R* gi_out, R* gio_out, R* za_out, R* zao_out,
                R* wa, R* wh, R* scratch, int64_t B, int64_t L, int64_t Rn, int64_t K, int viter,
                R vtol, R c_hyper, R g_hyper, void* stream) {
  if (B == 0) return 0;
  CtpfShape s;
  const int rc = ctpf_shape<R>(L + Rn, K, &s);
  if (rc != 0) return fail(static_cast<cudaError_t>(rc));
  if (!s.meta_in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(ctpf_estep_kernel<R>, s.bytes);
  if (err != cudaSuccess) return fail(err);
  const int vec_in = K % (16 / sizeof(R)) == 0 && aligned16(ealefT) && aligned16(eheT);
  const int vec_out = K % 4 == 0 && aligned16(wa) && aligned16(wh);
  ctpf_estep_kernel<R><<<static_cast<unsigned>(B), kCThreads, s.bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      ealefT, eheT, terms, counts, readers, ratings, doc_mask, inv_db, inv_dv, inv_hv,
      gi_in, gio_in, za_in, zao_in, gi_out, gio_out, za_out, zao_out, wa, wh, scratch,
      static_cast<int>(L), static_cast<int>(Rn), static_cast<int>(K), s.tile, s.meta_in_smem,
      s.resident, viter, vtol * vtol, c_hyper, g_hyper, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int launch_ctpf_pass(const R* ealefT, const R* eheT, const int* terms, const R* counts,
                     const int* readers, const R* ratings, const R* doc_mask, const R* inv_db,
                     const R* inv_dv, const R* inv_hv, const R* gi_in, const R* za_in,
                     R* gsum, R* zsum, R* scratch, int64_t B, int64_t L, int64_t Rn,
                     int64_t K, void* stream) {
  if (B == 0) return 0;
  CtpfShape s;
  const int rc = ctpf_shape<R>(L + Rn, K, &s);
  if (rc != 0) return fail(static_cast<cudaError_t>(rc));
  if (!s.meta_in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(ctpf_estep_pass_kernel<R>, s.bytes);
  if (err != cudaSuccess) return fail(err);
  const int vec_in = K % (16 / sizeof(R)) == 0 && aligned16(ealefT) && aligned16(eheT);
  ctpf_estep_pass_kernel<R><<<static_cast<unsigned>(B), kCThreads, s.bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      ealefT, eheT, terms, counts, readers, ratings, doc_mask, inv_db, inv_dv, inv_hv, gi_in,
      za_in, gsum, zsum, scratch, static_cast<int>(L), static_cast<int>(Rn), static_cast<int>(K),
      s.tile, s.meta_in_smem, s.resident, vec_in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tmvb

extern "C" {

// 1 when every row of a document of L token and R reader slots stays in
// shared memory, 0 when its rows go through in tiles, -1 when the device
// cannot be queried or K is too wide.
int tmvb_ctpf_estep_rows_in_smem(int64_t L, int64_t R, int64_t K) {
  tmvb::CtpfShape s;
  return tmvb::ctpf_shape<float>(L + R, K, &s) != 0 ? -1 : s.resident;
}
int tmvb_ctpf_estep_rows_in_smem_f64(int64_t L, int64_t R, int64_t K) {
  tmvb::CtpfShape s;
  return tmvb::ctpf_shape<double>(L + R, K, &s) != 0 ? -1 : s.resident;
}

// Elements of device scratch a document needs: 3 (L + R) when its slot
// list does not fit shared memory, else 0; -1 on an error.
int64_t tmvb_ctpf_estep_scratch(int64_t L, int64_t R, int64_t K) {
  tmvb::CtpfShape s;
  return tmvb::ctpf_shape<float>(L + R, K, &s) != 0 ? -1
                                                    : (s.meta_in_smem ? 0 : tmvb::kCMeta * (L + R));
}
int64_t tmvb_ctpf_estep_scratch_f64(int64_t L, int64_t R, int64_t K) {
  tmvb::CtpfShape s;
  return tmvb::ctpf_shape<double>(L + R, K, &s) != 0
             ? -1
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
  return tmvb::launch_ctpf(ealefT, eheT, terms, counts, readers, ratings, doc_mask, inv_db,
                           inv_dv, inv_hv, gi_in, gio_in, za_in, zao_in, gi_out, gio_out,
                           za_out, zao_out, wa, wh, scratch, B, L, R, K, viter, vtol, c_hyper,
                           g_hyper, stream);
}

// The float64 mode: every float tensor double, and vtol and the two
// hyperparameters too (the stop test compares the double sum of d^2 with
// vtol^2 in double, as the plain version does).
int tmvb_ctpf_estep_f64(const double* ealefT, const double* eheT, const int* terms,
                        const double* counts, const int* readers, const double* ratings,
                        const double* doc_mask, const double* inv_db, const double* inv_dv,
                        const double* inv_hv, const double* gi_in, const double* gio_in,
                        const double* za_in, const double* zao_in, double* gi_out,
                        double* gio_out, double* za_out, double* zao_out, double* wa,
                        double* wh, double* scratch, int64_t B, int64_t L, int64_t R,
                        int64_t K, int viter, double vtol, double c_hyper, double g_hyper,
                        void* stream) {
  return tmvb::launch_ctpf(ealefT, eheT, terms, counts, readers, ratings, doc_mask, inv_db,
                           inv_dv, inv_hv, gi_in, gio_in, za_in, zao_in, gi_out, gio_out,
                           za_out, zao_out, wa, wh, scratch, B, L, R, K, viter, vtol, c_hyper,
                           g_hyper, stream);
}

// The pass mode: gsum and zsum [B, K] (see ctpf_estep_pass_kernel);
// scratch as for tmvb_ctpf_estep.
int tmvb_ctpf_estep_pass(const float* ealefT, const float* eheT, const int* terms,
                         const float* counts, const int* readers, const float* ratings,
                         const float* doc_mask, const float* inv_db, const float* inv_dv,
                         const float* inv_hv, const float* gi_in, const float* za_in,
                         float* gsum, float* zsum, float* scratch, int64_t B, int64_t L,
                         int64_t R, int64_t K, void* stream) {
  return tmvb::launch_ctpf_pass(ealefT, eheT, terms, counts, readers, ratings, doc_mask, inv_db,
                                inv_dv, inv_hv, gi_in, za_in, gsum, zsum, scratch, B, L, R, K,
                                stream);
}

// The pass mode's float64 mode; scratch as for tmvb_ctpf_estep_f64.
int tmvb_ctpf_estep_pass_f64(const double* ealefT, const double* eheT, const int* terms,
                             const double* counts, const int* readers, const double* ratings,
                             const double* doc_mask, const double* inv_db,
                             const double* inv_dv, const double* inv_hv, const double* gi_in,
                             const double* za_in, double* gsum, double* zsum, double* scratch,
                             int64_t B, int64_t L, int64_t R, int64_t K, void* stream) {
  return tmvb::launch_ctpf_pass(ealefT, eheT, terms, counts, readers, ratings, doc_mask, inv_db,
                                inv_dv, inv_hv, gi_in, za_in, gsum, zsum, scratch, B, L, R, K,
                                stream);
}

}  // extern "C"
