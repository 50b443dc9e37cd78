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
// The pass mode (ctpf_estep_pass), for the sequence axis, where a
// document's token and reader slots are split over ranks: one pass of the
// fixpoint without its update, this rank's partials gsum = qp (r @ ea) +
// qt h and zsum = qb h [B, K].  The caller sums both over the ranks in one
// collective and forms gimel, zayin, the masks and the stop test on the
// [B, K] tiles; the last rows come from this kernel at viter = 0.  It
// replaces no Pallas kernel: the JAX package runs this per-pass body in
// XLA on the sequence axis (topicmodelsvb_jl_tpu/models/ctpf.py:127-140).
// What bounds it on an H100: few HBM bytes (the distinct rows, the slots,
// the state and the partials: 1.7 us on the seq chunk of 1024 CiteULike
// documents, L = 64, R = 12, K = 100), but every kept slot reads its row
// from L2: 52,005 x 400 B = 20.8 MB there (41.6 MB in float64), ~204 MB
// at L = 384, R = 128, the floor of a design that reads a row once per
// kept slot.  Its warp mode (K <= 512, ctpf_estep_pass_warp_kernel) is the
// LDA and fLDA pass modes' (rows.cuh): a document's token and reader
// slots as one stream of 8-slot blocks over w warps (ctpf_pass_shape:
// lda_pass_shape's rule on L + R slots), each kept row read once into
// registers, both accumulators there, the [K] factors once a document
// (psi with one division in place of eight), the warps folded in warp
// order after one barrier.  Past K = 512 the block mode
// (ctpf_estep_pass_kernel: the block, slot list, rows and products above)
// runs.  Measured (NVIDIA H100 80GB HBM3, 700 W; tools/kernel_ab.py and
// tools/estep_sweep.py pass_main, in turns; PERF.md section 6): the seq
// chunk 16.5 -> 11.5 us, L = 384, R = 128 77.0 -> 55.0 us (the rows from
// L2 at ~3.7 TB/s), float64 33.2 -> 18.7 us.  Slower, each measured: the
// token and reader slots as two phases, each dealt afresh (the readers'
// own rounds add a chain of L2 reads: 13.0 and 18.2 us on the seq chunk),
// more warps a document (5: two waves of 1024 documents at 74-80
// registers), deeper row rings (D = 4), 32 lanes of one vector a slot
// (13.4 us), picking q per element, and psi with its eight divisions
// (12.5-12.8 us).
//
// The float64 mode (R = double; tmvb_ctpf_estep_f64, tmvb_ctpf_estep_pass_f64):
// the kernels on a float64 state, every input, output and sum in double,
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
// make the same calls as before: their bits do not move.  At 2 blocks an
// SM the widest CiteULike chunk's 1024 documents take ~4 waves, each pass
// a latency chain: 229 us against the float32 mode's 95 (NVIDIA H100 80GB
// HBM3, 700 W; tools/estep_sweep.py ctpf_double on copies with one part
// cut: of a ~15.9 us pass, psi and exp ~3.4, psi's eight divisions ~1.3 of
// it, the barriers ~0.2; 70 us with no pass).  So where a document's rows
// fit one block's shared memory and K <= 512 the float64 mode runs
// ctpf_estep_res_kernel (below), the design of flda_estep_res_kernel.
// Measured in turns (tools/kernel_ab.py): 227.6-227.8 -> 170.1-170.5 us
// (viter 0: 70 -> 53.5; a pass 15.9 -> ~11.7; 2 blocks an SM of 126
// registers); the variants tried are in PERF.md section 6.
// Wider documents and K > 512 keep ctpf_estep_kernel<double>.

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

// psi(x) for x > 0 as digamma_series, the shift's eight reciprocals
// 1/(x + i) summed as one fraction S / P, P = prod (x + i), from pairs
// (x + 2m)(x + 2m + 1) with sums 2x + 4m + 1: one division in place of
// eight (the warp mode's [K] factors; the rounding moves by a few ulps).
// Past x = 3e4 the shift is dropped (P would pass the float range; the
// series alone is then exact to far below the rounding).
template <typename R>
__device__ __forceinline__ R digamma_one_div(R x) {
  R acc = R(0), t = x;
  if (x < R(3e4)) {
    R p[4], q[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const R a = x + R(2 * m);
      p[m] = a * (a + R(1));
      q[m] = R(2) * a + R(1);
    }
    const R p01 = p[0] * p[1], p23 = p[2] * p[3];
    const R s01 = q[0] * p[1] + q[1] * p[0], s23 = q[2] * p[3] + q[3] * p[2];
    acc = (s01 * p23 + s23 * p01) / (p01 * p23);
    t = x + R(8);
  }
  const R inv = R(1) / t;
  const R inv2 = inv * inv;
  const R series = Real<R>::log(t) - R(0.5) * inv -
      inv2 * (R(1) / R(12) - inv2 * (R(1) / R(120) - inv2 * (R(1) / R(252))));
  return series - acc;
}

// The pass mode's warp mode (K <= 512): gsum and zsum as
// ctpf_estep_pass_kernel computes them, a document's slots over the warps
// of a CTA (w of them, ctpf_pass_shape; with w = 1 a CTA holds
// kPassShortDocs documents, a warp each).  The [K] factors qp, qs, qt, qb
// are formed once per document into shared memory [4, KQ] (KQ = 4 G NVL,
// zeros past K) by its w warps' threads, each topic by one thread
// (psi with one division, digamma_one_div), before one barrier; each lane
// then reads its topics' qp and qs.  The document's token and reader
// slots are one stream of 8-slot blocks, the tokens' then the readers'
// (a block never mixes them), dealt to the warps in turn (round_slot):
// each round's kept slots are compacted into lanes by a ballot and
// shuffles (kept_src), and the S groups of G lanes take S of them at
// once, D rows a group read into registers (row_to_regs: ealefT's row for
// a token, eheT's for a reader) before the first is reduced.  Per row:
// s = row . q (qp for a token, qs for a reader: both products are taken
// and the slot's own kept, cheaper than picking q per element; a
// butterfly over the group), r = w / (s + eps), then a += r row for a
// token and h += r row for a reader (the other takes 0 row, which leaves
// it as it was, bit for bit), all in registers.  The groups' a and h are added by butterflies
// over the warp, then (w > 1) the warps' in warp order through shared
// memory after one barrier (pass_out2); gsum = qp a + qt h and zsum = qb h
// by each topic's thread.  Nothing is staged in shared memory inside the
// pass.  Every sum in one fixed order: same inputs, same bits.
template <typename R, int G, int NVL, int D>
__global__ void __launch_bounds__(256) ctpf_estep_pass_warp_kernel(
    const R* __restrict__ ealefT, const R* __restrict__ eheT, const int* __restrict__ terms,
    const R* __restrict__ counts, const int* __restrict__ readers,
    const R* __restrict__ ratings, const R* __restrict__ doc_mask,
    const R* __restrict__ inv_db, const R* __restrict__ inv_dv, const R* __restrict__ inv_hv,
    const R* __restrict__ gi_in, const R* __restrict__ za_in, R* __restrict__ gsum,
    R* __restrict__ zsum, int B, int L, int Rn, int K, int w, int vec_in) {
  using V4 = typename Real<R>::V4;
  constexpr int S = 32 / G;
  constexpr int KQ = 4 * G * NVL;   // the lane layout's topics, K and past it
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char pass_smem_raw[];
  R* smem = reinterpret_cast<R*>(pass_smem_raw);
  const PassWarp pw = pass_warp(w);
  if (pw.b >= B) return;   // with w > 1 the whole CTA: one document
  const int lane = threadIdx.x & 31, gi = lane / G, sub = lane % G;
  const size_t dk = static_cast<size_t>(pw.b) * K;
  if (!(doc_mask[pw.b] > R(0))) {
    for (int k = pw.wi * 32 + lane; k < K; k += pw.nthr) {
      gsum[dk + k] = R(0);
      zsum[dk + k] = R(0);
    }
    return;
  }
  // qp, qs, qt, qb [4, KQ]: the CTA's with w > 1, else this warp's; then
  // the warps' partials of a and h [w, 2 KQ] (w > 1)
  R* q = smem + (w > 1 ? 0 : (threadIdx.x >> 5) * 4 * KQ);
  for (int k = pw.wi * 32 + lane; k < KQ; k += pw.nthr) {
    R qp = R(0), qs = R(0), qt = R(0), qb = R(0);
    if (k < K) {
      const R eg = Real<R>::exp(digamma_one_div(gi_in[dk + k]));
      const R ez = Real<R>::exp(digamma_one_div(za_in[dk + k]));
      qt = eg * inv_dv[k];
      qb = ez * inv_hv[k];
      qp = eg * inv_db[k];
      qs = qt + qb;
    }
    q[k] = qp;
    q[KQ + k] = qs;
    q[2 * KQ + k] = qt;
    q[3 * KQ + k] = qb;
  }
  if (w > 1)
    __syncthreads();
  else
    __syncwarp();
  V4 qpl[NVL], qsl[NVL], a[NVL], h[NVL];
#pragma unroll
  for (int v = 0; v < NVL; ++v) {
    qpl[v] = *reinterpret_cast<const V4*>(q + 4 * (sub + G * v));
    qsl[v] = *reinterpret_cast<const V4*>(q + KQ + 4 * (sub + G * v));
    a[v] = Real<R>::zero4();
    h[v] = Real<R>::zero4();
  }
  const bool vec = vec_in != 0;
  const int* t = terms + static_cast<size_t>(pw.b) * L;
  const R* c = counts + static_cast<size_t>(pw.b) * L;
  const int* u = readers + static_cast<size_t>(pw.b) * Rn;
  const R* y = ratings + static_cast<size_t>(pw.b) * Rn;
  const int nblk_t = (L + 7) / 8, nblk = nblk_t + (Rn + 7) / 8;
  for (int b0 = pw.wi; b0 < nblk; b0 += 4 * w) {
    // this lane's slot: a token in the first nblk_t blocks, else a reader
    const int i = round_slot(b0, w, lane), blk = i >> 3;
    const bool tok = blk < nblk_t;
    const int j = tok ? i : i - 8 * nblk_t;
    R cl = R(0);
    int tl = 0;
    if (tok) {
      if (j < L) {
        cl = c[j];
        tl = t[j];
      }
    } else if (blk < nblk && j < Rn) {
      cl = y[j];
      tl = u[j];
    }
    const unsigned ball = __ballot_sync(kAll, cl != R(0));
    const int m = __popc(ball);
    const int src = kept_src(ball, m, lane);
    const int tk = __shfl_sync(kAll, tl, src);
    const R ck = __shfl_sync(kAll, cl, src);
    const int okk = __shfl_sync(kAll, static_cast<int>(tok), src);
    for (int r0 = 0; r0 < m; r0 += S * D) {
      V4 x[D][NVL];
      R cd[D];
      bool td[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int jj = r0 + d * S + gi;   // this group's kept slot
        const int tj = __shfl_sync(kAll, tk, jj & 31);
        cd[d] = __shfl_sync(kAll, ck, jj & 31);
        td[d] = __shfl_sync(kAll, okk, jj & 31) != 0;
        if (jj >= m) cd[d] = R(0);
        if (r0 + d * S < m) {
          row_to_regs<R, G, NVL>(x[d], (td[d] ? ealefT : eheT) + static_cast<size_t>(tj) * K, K,
                                 vec, sub);
        } else {
#pragma unroll
          for (int v = 0; v < NVL; ++v) x[d][v] = Real<R>::zero4();
        }
      }
      R sd[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        V4 acc = Real<R>::zero4(), acs = Real<R>::zero4();
#pragma unroll
        for (int v = 0; v < NVL; ++v) {
          acc.x = Real<R>::fma(x[d][v].x, qpl[v].x, acc.x);
          acc.y = Real<R>::fma(x[d][v].y, qpl[v].y, acc.y);
          acc.z = Real<R>::fma(x[d][v].z, qpl[v].z, acc.z);
          acc.w = Real<R>::fma(x[d][v].w, qpl[v].w, acc.w);
          acs.x = Real<R>::fma(x[d][v].x, qsl[v].x, acs.x);
          acs.y = Real<R>::fma(x[d][v].y, qsl[v].y, acs.y);
          acs.z = Real<R>::fma(x[d][v].z, qsl[v].z, acs.z);
          acs.w = Real<R>::fma(x[d][v].w, qsl[v].w, acs.w);
        }
        sd[d] = td[d] ? (acc.x + acc.y) + (acc.z + acc.w) : (acs.x + acs.y) + (acs.z + acs.w);
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
        for (int d = 0; d < D; ++d) sd[d] += __shfl_xor_sync(kAll, sd[d], o);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (r0 + d * S >= m) break;
        // 0 past the last kept slot and for the other accumulator: acc + 0
        // row is acc, bit for bit (acc, row >= 0)
        const R r = cd[d] != R(0) ? cd[d] / (sd[d] + Real<R>::eps) : R(0);
        const R ra = td[d] ? r : R(0), rh = td[d] ? R(0) : r;
#pragma unroll
        for (int v = 0; v < NVL; ++v) {
          a[v].x = Real<R>::fma(ra, x[d][v].x, a[v].x);
          a[v].y = Real<R>::fma(ra, x[d][v].y, a[v].y);
          a[v].z = Real<R>::fma(ra, x[d][v].z, a[v].z);
          a[v].w = Real<R>::fma(ra, x[d][v].w, a[v].w);
          h[v].x = Real<R>::fma(rh, x[d][v].x, h[v].x);
          h[v].y = Real<R>::fma(rh, x[d][v].y, h[v].y);
          h[v].z = Real<R>::fma(rh, x[d][v].z, h[v].z);
          h[v].w = Real<R>::fma(rh, x[d][v].w, h[v].w);
        }
      }
    }
  }
  fold_groups<G, NVL>(a);
  fold_groups<G, NVL>(h);
  pass_out2<R, G, NVL>(a, h, smem + 4 * KQ, w, pw.wi, K, [&](int k, R ak, R hk) {
    gsum[dk + k] = q[k] * ak + q[2 * KQ + k] * hk;
    zsum[dk + k] = q[3 * KQ + k] * hk;
  });
}

// The float64 mode's resident design (ctpf_estep_res_kernel; K <= 512 and
// a document's L + R rows fit one block's shared memory,
// ctpf_double_shape): the function of ctpf_estep_kernel<double>, one CTA
// of 256 threads a document, flda_estep_res_kernel's layout.  The kept
// slots are compacted (ctpf_compact: tokens, then readers; each slot's
// table row is loaded beside the weights) and their rows copied once into
// shared memory (cp.async through L1, ealefT's for a token, eheT's for a
// reader), stride K, and read from there on every pass.  A pass takes the
// tokens, then the readers: a phase's kept slots go 8 S at a time over the
// 8 warps' S groups of G lanes (ctpf_res_lanes; at S = 4 a half-warp's
// groups take slots two apart, so their rows' 64 bytes fall on different
// banks at K = 100), a warp with no slot left skipping its rounds; lane
// (g, sub) holds topics sub + G j, j < NV, a compile-time count, and the
// phase's q (qp for tokens, qs = qt + qb for readers) in registers (a
// lane's topics past K read column K - 1 against q's zeros).  Per slot: s
// = row . q in two chains, a butterfly over the group, r = w / (s + eps)
// (kept in the slot list for the rows of wa/wh), then a += r row; the
// groups' a are added by a butterfly over the warp and the busy warps'
// stored.  After one barrier the CTA's first half forms gimel, its d^2
// and the next qp, qt, the second half zayin and the next qb, the warps'
// sums in warp order, exp(psi) without a log (exp_digamma), before the
// stop test's barrier: two barriers a pass.  The rows of wa/wh come from
// the last pass's q and r/x, as in ctpf_estep_kernel (anew from the state
// as given when no pass ran): the padding slots' zeros are stored while
// the rows come in (a map of compact slots says which), the kept slots'
// rows by the last pass the loop allows, from its registers, or after
// the loop when the stop test ends it sooner.  Every sum in one fixed
// order: same inputs, same bits.

// The factors of every topic from (g, z) [K] into q [3, KQ] (qp, qt, qb):
// g's on the CTA's first half, z's on its second.
__device__ __forceinline__ void ctpf_res_factors(double* q, int KQ, int K, const double* g,
                                                 const double* z,
                                                 const double* __restrict__ inv_db,
                                                 const double* __restrict__ inv_dv,
                                                 const double* __restrict__ inv_hv) {
  const bool zhalf = threadIdx.x >= kCThreads / 2;
  for (int k = threadIdx.x % (kCThreads / 2); k < K; k += kCThreads / 2) {
    if (zhalf) {
      q[2 * KQ + k] = exp_digamma(z[k]) * inv_hv[k];
    } else {
      const double eg = exp_digamma(g[k]);
      q[k] = eg * inv_db[k];
      q[KQ + k] = eg * inv_dv[k];
    }
  }
}

// Shared memory of the resident design in doubles: the kept rows [L + R,
// K], two q buffers [3, KQ] (qp, qt, qb; KQ = G NV, zeros past K), the
// warps' a and h partials [8, K] each, gimel, gimel_old, zayin, zayin_old
// [K] each, the slot list (weight, r or x, then as ints each compact
// slot's slot, each slot's compact slot and its table row) [4, L + R], 32
// for the sums.
__host__ __device__ inline size_t ctpf_res_smem(int64_t LR, int64_t K, int KQ) {
  return (static_cast<size_t>(LR) * K + 6 * static_cast<size_t>(KQ) +
          (2 * kCWarps + 4) * static_cast<size_t>(K) + 4 * static_cast<size_t>(LR) + 32) *
         sizeof(double);
}

// This lane's part of one round over the kept slots [lo, hi): the slot
// j's row (past hi: hi - 1's, its result dropped) into x and s = row . q
// over the group, q the phase's in registers.
template <int G, int NV>
__device__ __forceinline__ double ctpf_res_row(const double* rows, int j, int hi, int K,
                                               int sub, const double (&qv)[NV],
                                               double (&x)[NV]) {
  const double* row = rows + static_cast<size_t>(min(j, hi - 1)) * K;
  double s0 = 0.0, s1 = 0.0;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    x[v] = row[min(sub + G * v, K - 1)];
    if (v & 1)
      s1 = fma(x[v], qv[v], s1);
    else
      s0 = fma(x[v], qv[v], s0);
  }
  double s = s0 + s1;
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// One pass's phases, tokens [0, nL) then readers [nL, n): each kept slot's
// r or x into mcs, with `sums` the busy warps' a (tokens) and h (readers)
// into apart and hpart [8, K], and with `rows_out` each kept slot's row of
// wa (tokens) or wh (readers), row_k (q_k r), from the registers.
template <int G, int NV>
__device__ __forceinline__ void ctpf_res_phases(const double* rows, const double* q,
                                                const double* mw, double* mcs, double* apart,
                                                double* hpart, double* wad, double* whd,
                                                const int* mslot, int n, int nL, int K,
                                                bool sums, bool rows_out) {
  constexpr int S = 32 / G, KQ = G * NV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane / G, sub = lane % G;
  const int gslot = warp * S + (S == 4 ? ((gq & 1) << 1) | (gq >> 1) : gq);
#pragma unroll 1
  for (int ph = 0; ph < 2; ++ph) {
    const int lo = ph == 0 ? 0 : nL, hi = ph == 0 ? nL : n;
    if (lo + warp * S >= hi) continue;   // no slot of this phase on this warp
    double qv[NV], acc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int k = sub + G * v;
      qv[v] = ph == 0 ? q[k] : q[KQ + k] + q[2 * KQ + k];
      acc[v] = 0.0;
    }
    for (int j0 = lo; j0 < hi && j0 + warp * S < hi; j0 += kCWarps * S) {
      const int j = j0 + gslot;
      double x[NV];
      const double s = ctpf_res_row<G, NV>(rows, j, hi, K, sub, qv, x);
      if (j < hi) {
        const double r = mw[j] / (s + Real<double>::eps);
        if (sub == 0) mcs[j] = r;
#pragma unroll
        for (int v = 0; v < NV; ++v) acc[v] = fma(r, x[v], acc[v]);
        if (rows_out) {
          double* dst = (ph == 0 ? wad : whd) + static_cast<size_t>(mslot[j]) * K;
#pragma unroll
          for (int v = 0; v < NV; ++v)
            if (sub + G * v < K) dst[sub + G * v] = x[v] * (qv[v] * r);
        }
      }
    }
    if (!sums) continue;
#pragma unroll
    for (int o = G; o < 32; o <<= 1)
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o);
    double* part = ph == 0 ? apart : hpart;
    if (lane < G) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int k = lane + G * v;
        if (k < K) part[warp * K + k] = acc[v];
      }
    }
  }
}

template <int G, int NV>
__global__ void __launch_bounds__(kCThreads, 2) ctpf_estep_res_kernel(
    const double* __restrict__ ealefT, const double* __restrict__ eheT,
    const int* __restrict__ terms, const double* __restrict__ counts,
    const int* __restrict__ readers, const double* __restrict__ ratings,
    const double* __restrict__ doc_mask, const double* __restrict__ inv_db,
    const double* __restrict__ inv_dv, const double* __restrict__ inv_hv,
    const double* __restrict__ gi_in, const double* __restrict__ gio_in,
    const double* __restrict__ za_in, const double* __restrict__ zao_in,
    double* __restrict__ gi_out, double* __restrict__ gio_out, double* __restrict__ za_out,
    double* __restrict__ zao_out, double* __restrict__ wa, double* __restrict__ wh, int L,
    int Rn, int K, int viter, double vtol2, double c_hyper, double g_hyper, int vec_in,
    int vec_out) {
  using R = double;
  constexpr int S = 32 / G;
  constexpr int KQ = G * NV;
  extern __shared__ __align__(16) unsigned char ctpf_smem_raw[];
  const int LR = L + Rn;
  R* rows = reinterpret_cast<R*>(ctpf_smem_raw);   // [LR, K] the kept slots' rows
  R* q_cur = rows + static_cast<size_t>(LR) * K;    // qp, qt, qb [3, KQ] of this pass
  R* q_nxt = q_cur + 3 * KQ;                        // of the next
  R* apart = q_nxt + 3 * KQ;                        // the warps' a [8, K]
  R* hpart = apart + kCWarps * K;                   // the warps' h [8, K]
  R* gi = hpart + kCWarps * K;
  R* gio = gi + K;
  R* za = gio + K;
  R* zao = za + K;
  R* mw = zao + K;                                  // weight of compact slot j
  R* mcs = mw + LR;                                 // its r or x
  int* mslot = reinterpret_cast<int*>(mcs + LR);    // its token or reader slot
  int* cidx = mslot + LR;                           // slot i's compact slot, -1: padding
  int* sid = cidx + LR;                             // slot i's table row (term or user)
  R* red = mcs + 3 * LR;  // [32]: sum d^2 [2 x 8], compaction counts [16 ints]
  const int b = blockIdx.x, tid = threadIdx.x;
  const int* t = terms + static_cast<size_t>(b) * L;
  const R* c = counts + static_cast<size_t>(b) * L;
  const int* u = readers + static_cast<size_t>(b) * Rn;
  const R* y = ratings + static_cast<size_t>(b) * Rn;
  const size_t dk = static_cast<size_t>(b) * K;

  // the first slot's table row is loaded beside the compaction's weights
  const int id0 = tid < LR ? (tid < L ? t[tid] : u[tid - L]) : 0;
  for (int i = tid; i < LR; i += kCThreads) cidx[i] = -1;
  int nL;
  const int n = ctpf_compact(c, y, L, Rn, mw, mslot, reinterpret_cast<int*>(red + 16), &nL);
  for (int j = tid; j < n; j += kCThreads) cidx[j < nL ? mslot[j] : L + mslot[j]] = j;
  for (int i = tid; i < LR; i += kCThreads) sid[i] = i == tid ? id0 : (i < L ? t[i] : u[i - L]);
  __syncthreads();
  auto row_of = [&](int j) -> const R* {   // compact slot j's table row
    return (j < nL ? ealefT : eheT) +
           static_cast<size_t>(sid[j < nL ? mslot[j] : L + mslot[j]]) * K;
  };
  if (vec_in) {
    const int H = K / 2;
    for (int idx = tid; idx < n * H; idx += kCThreads) {
      const int j = idx / H, h = idx - j * H;
      cp_async16_ca(rows + static_cast<size_t>(j) * K + 2 * h, row_of(j) + 2 * h);
    }
  } else {
    for (int idx = tid; idx < n * K; idx += kCThreads) {
      const int j = idx / K, k = idx - j * K;
      cp_async8(rows + idx, row_of(j) + k);
    }
  }
  // the padding slots' rows of wa/wh: zeros, stored while the rows come in
  R* wad = wa + static_cast<size_t>(b) * L * K;
  R* whd = wh + static_cast<size_t>(b) * Rn * K;
  const int E = vec_out ? 2 : 1;   // doubles a store
  const int H = K / E;
  for (int idx = tid; idx < LR * H; idx += kCThreads) {
    const int i = idx / H, e = E * (idx - i * H);
    if (cidx[i] >= 0) continue;
    R* dst = (i < L ? wad + static_cast<size_t>(i) * K : whd + static_cast<size_t>(i - L) * K) + e;
    if (vec_out)
      *reinterpret_cast<double2*>(dst) = make_double2(0.0, 0.0);
    else
      *dst = R(0);
  }
  for (int k = tid; k < KQ; k += kCThreads) {
    if (k < K) {
      gi[k] = gi_in[dk + k];
      gio[k] = gio_in[dk + k];
      za[k] = za_in[dk + k];
      zao[k] = zao_in[dk + k];
    } else {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        q_cur[v * KQ + k] = R(0);
        q_nxt[v * KQ + k] = R(0);
      }
    }
  }
  __syncthreads();   // the state in shared memory
  bool active = doc_mask[b] > R(0);
  if (viter > 0 && active) ctpf_res_factors(q_cur, KQ, K, gi, za, inv_db, inv_dv, inv_hv);
  cp_async_wait_all();
  __syncthreads();

  // the warps that hold a slot of each phase
  const int wa_n = min(kCWarps, (nL + S - 1) / S), wh_n = min(kCWarps, (n - nL + S - 1) / S);
  int it = 0;
  for (; it < viter && active; ++it) {
    // the last pass the loop allows writes the kept slots' rows as it goes
    ctpf_res_phases<G, NV>(rows, q_cur, mw, mcs, apart, hpart, wad, whd, mslot, n, nL, K, true,
                           it == viter - 1);
    __syncthreads();
    // update_gimel!/update_zayin! (CTPF.jl:309-323) and the next pass's q
    // from the new state, gimel's on the CTA's first half and zayin's on
    // its second, before the barrier of the stop test
    R dpart = R(0);
    const bool zhalf = tid >= kCThreads / 2;
    for (int k = tid % (kCThreads / 2); k < K; k += kCThreads / 2) {
      R hr = R(0);
      for (int v = 0; v < wh_n; ++v) hr += hpart[v * K + k];
      if (zhalf) {
        const R za_new = g_hyper + q_cur[2 * KQ + k] * hr;
        zao[k] = za[k];
        za[k] = za_new;
        q_nxt[2 * KQ + k] = exp_digamma(za_new) * inv_hv[k];
      } else {
        R pc = R(0);
        for (int v = 0; v < wa_n; ++v) pc += apart[v * K + k];
        const R gi_new = c_hyper + q_cur[k] * pc + q_cur[KQ + k] * hr;
        const R d = gi_new - gi[k];
        dpart += d * d;
        gio[k] = gi[k];
        gi[k] = gi_new;
        const R eg = exp_digamma(gi_new);
        q_nxt[k] = eg * inv_db[k];
        q_nxt[KQ + k] = eg * inv_dv[k];
      }
    }
    // consecutive passes sum into different halves of red[0, 16)
    active = block_sum_once<kCWarps>(dpart, red + kCWarps * (it & 1)) >= vtol2;
    R* q = q_cur;
    q_cur = q_nxt;
    q_nxt = q;
  }

  for (int k = tid; k < K; k += kCThreads) {
    gi_out[dk + k] = gi[k];
    gio_out[dk + k] = gio[k];
    za_out[dk + k] = za[k];
    zao_out[dk + k] = zao[k];
  }
  // the kept slots' rows from phi/xi of (gimel_old, zayin_old): written by
  // the last pass the loop allows; when no pass ran, anew from the state
  // as given; when the stop test ended the loop sooner, from its last
  // pass's q and r/x
  if (it == 0) {
    ctpf_res_factors(q_cur, KQ, K, gio, zao, inv_db, inv_dv, inv_hv);
    __syncthreads();
    ctpf_res_phases<G, NV>(rows, q_cur, mw, mcs, apart, hpart, wad, whd, mslot, n, nL, K, false,
                           true);
  } else if (it < viter) {
    const R* q_last = q_nxt;
    __syncthreads();   // every r/x of the slot list
    for (int idx = tid; idx < n * H; idx += kCThreads) {
      const int j = idx / H, e = E * (idx - j * H);
      const bool tk = j < nL;
      const R r = mcs[j];
      const R* x = rows + static_cast<size_t>(j) * K + e;
      R* dst = (tk ? wad : whd) + static_cast<size_t>(mslot[j]) * K + e;
      const R o0 = x[0] * ((tk ? q_last[e] : q_last[KQ + e] + q_last[2 * KQ + e]) * r);
      if (vec_out)
        *reinterpret_cast<double2*>(dst) = make_double2(
            o0, x[1] * ((tk ? q_last[e + 1] : q_last[KQ + e + 1] + q_last[2 * KQ + e + 1]) * r));
      else
        *dst = o0;
    }
  }
}

// The warp mode's shape for CTPF, counted in the document's L + R slots:
// LDA's rule (lda_pass_shape) on them.
inline PassShape ctpf_pass_shape(int64_t L, int64_t Rn, int64_t K, int bytes) {
  const int64_t LR = L + Rn;
  if (K <= 64) return {8, K > 32 ? 2 : 1, pass_warps(LR)};
  if (K <= 128)
    return {16, 2, bytes == 8 ? pass_warps(LR) : warps_per(LR, LR <= 64 ? 16 : 32)};
  return wide_pass_shape(LR, K);
}

// Dynamic shared memory of a warp-mode launch: the factors [4, KQ] of
// each document (kPassShortDocs of them with w = 1), then with w > 1 the
// warps' partials of a and h [w, 2 KQ].
template <typename R>
inline size_t ctpf_pass_smem(int G, int NVL, int w) {
  const size_t kq = 4 * static_cast<size_t>(G) * NVL;
  return (w > 1 ? (4 + 2 * static_cast<size_t>(w)) * kq : kPassShortDocs * 4 * kq) * sizeof(R);
}

// Lanes a slot and topics a lane of CTPF's resident design: 16 lanes of 7
// topics from K = 65 to 112 (CiteULike's K = 100; 8 lanes of 13 measured
// slower, their fold over a warp's four groups costing more than the
// extra rounds), else fLDA's rule (res_lanes).
__host__ __device__ inline ResShape ctpf_res_lanes(int64_t K) {
  return K > 64 && K <= 112 ? ResShape{16, 7} : res_lanes(K);
}

// The float64 mode's choice: the resident design's lanes a slot (G = 0:
// ctpf_estep_kernel<double>) and its shared memory.
struct CtpfDoubleShape {
  int G, NV;
  size_t bytes;
};
inline int ctpf_double_shape(int64_t LR, int64_t K, CtpfDoubleShape* s) {
  const int optin = smem_optin();
  if (optin < 0) return query_error();
  const ResShape r = ctpf_res_lanes(K);
  const size_t bytes = ctpf_res_smem(LR, K, r.G * r.NV);
  *s = {r.G > 0 && bytes <= static_cast<size_t>(optin) ? r.G : 0, r.NV, bytes};
  return 0;
}

// The resident design's kernel for (G, NV), or nullptr.
inline const void* ctpf_res_kernel(int G, int NV) {
  switch (G * 32 + NV) {
    case 8 * 32 + 4:
      return reinterpret_cast<const void*>(ctpf_estep_res_kernel<8, 4>);
    case 8 * 32 + 8:
      return reinterpret_cast<const void*>(ctpf_estep_res_kernel<8, 8>);
    case 8 * 32 + 16:
      return reinterpret_cast<const void*>(ctpf_estep_res_kernel<8, 16>);
    case 16 * 32 + 7:
      return reinterpret_cast<const void*>(ctpf_estep_res_kernel<16, 7>);
    case 16 * 32 + 16:
      return reinterpret_cast<const void*>(ctpf_estep_res_kernel<16, 16>);
    case 32 * 32 + 16:
      return reinterpret_cast<const void*>(ctpf_estep_res_kernel<32, 16>);
    default:
      return nullptr;
  }
}

// vec_in: K even and both tables 16-byte aligned; vec_out: K even and both
// row outputs 16-byte aligned (16-byte copies and stores of two doubles).
int launch_ctpf_res(const double* ealefT, const double* eheT, const int* terms,
                    const double* counts, const int* readers, const double* ratings,
                    const double* doc_mask, const double* inv_db, const double* inv_dv,
                    const double* inv_hv, const double* gi_in, const double* gio_in,
                    const double* za_in, const double* zao_in, double* gi_out, double* gio_out,
                    double* za_out, double* zao_out, double* wa, double* wh, int64_t B, int64_t L,
                    int64_t Rn, int64_t K, int viter, double vtol, double c_hyper,
                    double g_hyper, const CtpfDoubleShape& d, cudaStream_t stream) {
  const void* kernel = ctpf_res_kernel(d.G, d.NV);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(kernel, d.bytes);
  if (err != cudaSuccess) return fail(err);
  int Li = static_cast<int>(L), Ri = static_cast<int>(Rn), Ki = static_cast<int>(K);
  double vtol2 = vtol * vtol;
  int vec_in = K % 2 == 0 && aligned16(ealefT) && aligned16(eheT);
  int vec_out = K % 2 == 0 && aligned16(wa) && aligned16(wh);
  void* args[] = {&ealefT, &eheT,   &terms,  &counts, &readers, &ratings, &doc_mask, &inv_db,
                  &inv_dv, &inv_hv, &gi_in,  &gio_in, &za_in,   &zao_in,  &gi_out,   &gio_out,
                  &za_out, &zao_out, &wa,    &wh,     &Li,      &Ri,      &Ki,       &viter,
                  &vtol2,  &c_hyper, &g_hyper, &vec_in, &vec_out};
  err = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(B)), dim3(kCThreads), args, d.bytes,
                         stream);
  if (err != cudaSuccess) return fail(err);
  return static_cast<int>(cudaGetLastError());
}

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
  if constexpr (sizeof(R) == 8) {
    CtpfDoubleShape d;
    const int rc = ctpf_double_shape(L + Rn, K, &d);
    if (rc != 0) return fail(static_cast<cudaError_t>(rc));
    if (d.G > 0)
      return launch_ctpf_res(ealefT, eheT, terms, counts, readers, ratings, doc_mask, inv_db,
                             inv_dv, inv_hv, gi_in, gio_in, za_in, zao_in, gi_out, gio_out, za_out,
                             zao_out, wa, wh, B, L, Rn, K, viter, vtol, c_hyper, g_hyper, d,
                             static_cast<cudaStream_t>(stream));
  }
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

template <typename R, int G, int NVL, int D>
int launch_ctpf_pass_warp(const R* ealefT, const R* eheT, const int* terms, const R* counts,
                          const int* readers, const R* ratings, const R* doc_mask,
                          const R* inv_db, const R* inv_dv, const R* inv_hv, const R* gi_in,
                          const R* za_in, R* gsum, R* zsum, int64_t B, int64_t L, int64_t Rn,
                          int64_t K, int w, int vec_in, cudaStream_t stream) {
  const PassLaunch pl = pass_launch<R>(B, G, NVL, w);
  const size_t smem = ctpf_pass_smem<R>(G, NVL, w);
  auto kernel = ctpf_estep_pass_warp_kernel<R, G, NVL, D>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return fail(err);
  kernel<<<pl.grid, pl.threads, smem, stream>>>(
      ealefT, eheT, terms, counts, readers, ratings, doc_mask, inv_db, inv_dv, inv_hv, gi_in,
      za_in, gsum, zsum, static_cast<int>(B), static_cast<int>(L), static_cast<int>(Rn),
      static_cast<int>(K), w, vec_in);
  return static_cast<int>(cudaGetLastError());
}

// The pass mode's launch: the warp mode for K <= 512 (ctpf_pass_shape),
// past it the block mode.
template <typename R>
int launch_ctpf_pass(const R* ealefT, const R* eheT, const int* terms, const R* counts,
                     const int* readers, const R* ratings, const R* doc_mask, const R* inv_db,
                     const R* inv_dv, const R* inv_hv, const R* gi_in, const R* za_in,
                     R* gsum, R* zsum, R* scratch, int64_t B, int64_t L, int64_t Rn,
                     int64_t K, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PassShape ps = ctpf_pass_shape(L, Rn, K, sizeof(R));
  const int vec = K % (16 / sizeof(R)) == 0 && aligned16(ealefT) && aligned16(eheT);
#define TMVB_CTPF_PASS_WARP(G, NVL)                                                            \
  return launch_ctpf_pass_warp<R, G, NVL, pass_depth<R, G, NVL>()>(                          \
      ealefT, eheT, terms, counts, readers, ratings, doc_mask, inv_db, inv_dv, inv_hv, gi_in, \
      za_in, gsum, zsum, B, L, Rn, K, ps.w, vec, st)
  switch (ps.G * 8 + ps.NVL) {
    case 8 * 8 + 1:
      TMVB_CTPF_PASS_WARP(8, 1);
    case 8 * 8 + 2:
      TMVB_CTPF_PASS_WARP(8, 2);
    case 16 * 8 + 2:
      TMVB_CTPF_PASS_WARP(16, 2);
    case 32 * 8 + 2:
      TMVB_CTPF_PASS_WARP(32, 2);
    case 32 * 8 + 3:
      TMVB_CTPF_PASS_WARP(32, 3);
    case 32 * 8 + 4:
      TMVB_CTPF_PASS_WARP(32, 4);
    default:
      break;
  }
#undef TMVB_CTPF_PASS_WARP
  CtpfShape s;
  const int rc = ctpf_shape<R>(L + Rn, K, &s);
  if (rc != 0) return fail(static_cast<cudaError_t>(rc));
  if (!s.meta_in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(ctpf_estep_pass_kernel<R>, s.bytes);
  if (err != cudaSuccess) return fail(err);
  ctpf_estep_pass_kernel<R><<<static_cast<unsigned>(B), kCThreads, s.bytes, st>>>(
      ealefT, eheT, terms, counts, readers, ratings, doc_mask, inv_db, inv_dv, inv_hv, gi_in,
      za_in, gsum, zsum, scratch, static_cast<int>(L), static_cast<int>(Rn), static_cast<int>(K),
      s.tile, s.meta_in_smem, s.resident, vec);
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

// The warp mode's shape of ctpf_estep_pass on a document of L token and
// R reader slots at K topics in elements of `bytes` (4 or 8): lanes a
// slot, vectors a lane and warps a document in out[0..2]; lanes 0 past
// the reach (the block mode runs).
void tmvb_ctpf_estep_pass_shape(int64_t L, int64_t R, int64_t K, int bytes, int* out) {
  const tmvb::PassShape s = tmvb::ctpf_pass_shape(L, R, K, bytes);
  out[0] = s.G;
  out[1] = s.NVL;
  out[2] = s.w;
}

// Elements of device scratch a document needs: 3 (L + R) when its slot
// list does not fit shared memory, else 0; -1 on an error.
int64_t tmvb_ctpf_estep_scratch(int64_t L, int64_t R, int64_t K) {
  tmvb::CtpfShape s;
  return tmvb::ctpf_shape<float>(L + R, K, &s) != 0 ? -1
                                                    : (s.meta_in_smem ? 0 : tmvb::kCMeta * (L + R));
}
int64_t tmvb_ctpf_estep_scratch_f64(int64_t L, int64_t R, int64_t K) {
  tmvb::CtpfDoubleShape d;
  if (tmvb::ctpf_double_shape(L + R, K, &d) != 0) return -1;
  if (d.G > 0) return 0;   // the resident design keeps its slot list in shared memory
  tmvb::CtpfShape s;
  return tmvb::ctpf_shape<double>(L + R, K, &s) != 0
             ? -1
             : (s.meta_in_smem ? 0 : tmvb::kCMeta * (L + R));
}

// The float64 mode's launch shape on a document of L token and R reader
// slots at K topics: out[0] 1 for the resident design
// (ctpf_estep_res_kernel), 0 for ctpf_estep_kernel<double> with its rows
// in tiles, 2 for it with every row in shared memory (K > 512); out[1]
// lanes a slot (resident design) or the slots of a tile; out[2] blocks an
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor); out[3] shared memory
// in bytes a block.  Returns 0, or a CUDA error code.
int tmvb_ctpf_estep_double_shape(int64_t L, int64_t R, int64_t K, int* out) {
  tmvb::CtpfDoubleShape d;
  int rc = tmvb::ctpf_double_shape(L + R, K, &d);
  if (rc != 0) return rc;
  int blocks = 0;
  cudaError_t err;
  if (d.G > 0) {
    const void* kernel = tmvb::ctpf_res_kernel(d.G, d.NV);
    err = tmvb::allow_smem(kernel, d.bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, tmvb::kCThreads,
                                                          d.bytes);
    out[0] = 1;
    out[1] = d.G;
    out[3] = static_cast<int>(d.bytes);
  } else {
    tmvb::CtpfShape s;
    rc = tmvb::ctpf_shape<double>(L + R, K, &s);
    if (rc != 0) return rc;
    err = tmvb::allow_smem(tmvb::ctpf_estep_kernel<double>, s.bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tmvb::ctpf_estep_kernel<double>, tmvb::kCThreads, s.bytes);
    out[0] = s.resident ? 2 : 0;
    out[1] = s.tile;
    out[3] = static_cast<int>(s.bytes);
  }
  out[2] = blocks;
  return err == cudaSuccess ? 0 : tmvb::fail(err);
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
