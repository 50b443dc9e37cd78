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
// What bounds it on an H100: bytes, through the write of w.  At the widest
// NSF chunk (B = 1024, L = 128, K = 100, 114,090 kept slots) it must read
// at most 10.1 MB of table rows, ~1 MB of terms and counts and 1.2 MB of
// state, and write 52.4 MB of w and 1.2 MB of state: ~66 MB, ~20 us at
// 3.35 TB/s.  The fixpoint is <= 10 passes x 4K flops per kept slot,
// ~0.46 GFLOP, ~7 us at 67 TFLOP/s in f32.  No tensor cores: each pass is
// two matrix-vector products on one document's own [L, K] rows (one
// right-hand column), and wgmma needs at least 8 columns and would run f32
// as TF32.
//
// Design (256 threads, one document per block):
// - The slots with c_l != 0 are compacted, in slot order, into a list of
//   (count, c / s, slot); padding is never read or computed.
// - Their rows are copied from the table into shared memory with cp.async
//   (16 bytes where K % 4 == 0 and the table is aligned, else 4 bytes),
//   overlapped with the state loads.  The row stride Kp is K rounded up to
//   an odd number of float4s, so the 8 threads of a 16-byte shared load
//   that read 8 different slots' rows hit 32 different banks; the padding
//   columns are zeros (and e is 0 there), so they add exact zeros.
// - s: threads over slots, a loop over K in float4s with e broadcast from
//   shared memory, four independent accumulators, no shuffle.
// - q: threads over (float4 of topics, share of slots): each thread sums
//   its share of slots for 4 topics; the shares' partials are then added
//   in share order by the thread of each topic.
// - Four barriers a pass: after s, after q, and one for each block sum
//   (sum gamma, then the convergence sum), each sum's partials in warp
//   order.  Every sum runs in one fixed order: same inputs, same bits.
//   psi(gamma_k) is taken before the first sum's barrier, and psi(sum
//   gamma) only by the threads that own a topic: with at most 4 documents
//   an SM (shared memory and registers both cap it), the psi and sum chain
//   of a pass costs about as much as the two products.
// - w is written from the last pass's c_l / s_l and exp(El_old) (the e of
//   that pass), with 16-byte stores where K % 4 == 0; s is recomputed only
//   for a document that ran no pass (doc_mask 0, or viter 0).
// - A document whose rows do not fit (L = 1024 at K = 100 is 400 KB) goes
//   through shared memory in tiles of slots, re-read from the table (10 MB
//   at NSF scale, resident in the 50 MB L2) on every pass, with the same
//   thread mapping.  Its slot list stays in shared memory when it fits
//   there, else in a [B, 3 L] scratch in device memory.
//
// Work is per document, not per 8-document tile as on the TPU: a block
// leaves its loop as soon as its own document converges, which is the
// reference's per-document break, and it gives the masked tile's result
// because a converged document's state is frozen there.  psi is the same
// shift-by-8 asymptotic series as the TPU kernel (digamma_series in
// common.cuh).
//
// The f64 Elogtheta channel (template flag kF64; RuntimeConfig.
// elogtheta_f64, as the JAX package's models/lda.py:133-141 computes it on
// its XLA path, which that package takes for this mode): gamma is formed
// in f32 as above, then sum gamma and both psi are taken in double
// (digamma_series64) and El_new is cast back to f32; exp, the products
// and w stay f32.  Its extra cost is the double psi of K + 1 values a
// pass, recomputed after the sum's barrier by each topic's thread, and a
// double block sum in `red`'s first 16 floats (the d^2 sum then uses
// floats 24-31, after the compaction counts).  kF64 = false is the code
// of the f32 mode as it was, bit for bit.
//
// The float64 mode (R = double; tmvb_lda_estep_f64): the same kernel on a
// float64 state, every input, output and sum in double, psi the same
// shift-by-8 series in double (what the plain version computes on a
// float64 state), exp the double exp.  The JAX package runs its kernels in
// the state's dtype (its lda_estep output specs follow beta_d's dtype).
// What bounds it: bytes again, doubled (~132 MB at the widest NSF chunk,
// ~40 us at 3.35 TB/s), against ~0.46 GFLOP at the f64 rate (132 SMs x 64
// FP64 lanes x 2 x 1.98 GHz = 33.5 TFLOP/s, ~14 us).  Every size in
// shared memory is in 8-byte elements: the widest NSF document (L = 128,
// K = 100, 114.5 KB) still stays resident with 2 blocks an SM (launch
// bounds 2, not 4), L = 1024 goes through tiles, and the widest K halves
// (~4,100 at L = 4 against ~8,300): past it the wrapper raises.  Four
// doubles are a Double4 (two 16-byte accesses); the table's rows are
// copied 16 bytes (two doubles) at a time where K is even.  That kernel
// took 285-286 us at the widest NSF chunk (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md section 6): 2 blocks an SM, ~3.9 waves, s with one thread a slot
// (~111 of 256 busy), q on ~150 threads, the float rule's stride (800
// bytes at K = 100, 2-way conflicts on the 16-byte loads), four barriers
// a pass and psi and exp on 100 threads between two of them.  So where a
// document's rows fit one CTA's shared memory and K <= 512 the float64
// mode runs lda_estep_res_kernel (below), ctpf_estep_res_kernel's design:
// measured in turns (tools/kernel_ab.py) 284.4-286.2 -> 207.4-209.0 us
// (viter 0: 84.4 -> 67.2); the variants tried are in PERF.md section 6.
// Wider documents (L = 1024 at K = 100) and K > 512 keep this kernel.
//
// The pass mode (lda_estep_pass; tmvb_lda_estep_pass[_f64]), for the
// modes whose token slots are split over ranks: pc [B, K] = e q, one pass
// without its update.  It replaces no Pallas kernel: the JAX package runs
// this per-pass body in XLA under routing and on the sequence axis
// (topicmodelsvb_jl_tpu/models/lda.py:123-133).  What bounds it on an
// H100: few HBM bytes (the distinct rows, the slots, El and pc: 6.4 MB,
// 1.9 us, on the routed chunk of 1024 documents, Ls = 104, K = 100), but
// every kept slot reads its 4 K-byte row from L2 (69,443 x 400 B = 27.8
// MB there), which is the floor of any design that reads a row once per
// slot; the flops (4 K a kept slot) take ~0.4 us.  Its warp mode (K <=
// 512, lda_estep_pass_warp_kernel):
// - A document's slots over w warps (w = 1 puts 4 documents in a CTA),
//   8-slot blocks dealt to them in turn, so the kept slots, which lead a
//   row, spread evenly.  lda_pass_shape: K <= 64, G = 8 lanes a slot and
//   one warp per 32 slots up to L = 64, then per 64; K = 65-128, G = 16
//   lanes of two vectors, in float32 one warp per 16 slots up to L = 64,
//   then per 32 (4 warps on both NSF chunks at 64 registers: one wave
//   for B = 1024); K = 129-512, G = 32; w <= 8.
// - Each warp compacts its kept slots with a ballot, their terms and
//   counts into its lanes by shuffles, then takes S = 32 / G of them at
//   once, D rows a group read straight into registers with 16-byte
//   ld.global.nc (rows.cuh's warp-mode layout) before the first is
//   reduced.  Per row: s from each lane's products and a butterfly over
//   its group, cs = c / s, q += cs row, all in registers; nothing is
//   staged in shared memory and no barrier is taken before the fold.
// - The fold: a butterfly over the warp's groups, then with w > 1 the
//   warps' q added in warp order in shared memory after one barrier.
// - Register reach: NVL <= 4 vectors a lane at G = 32, so K <= 512 in
//   either dtype; past it the block mode (lda_estep_pass_kernel, the
//   earlier block-per-document design) runs.
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/kernel_ab.py in turns,
// PERF.md section 6): about half the block mode's time on the
// routed and seq chunks, in float32 and float64, the rows coming from L2
// at ~3 TB/s.

#include <algorithm>

#include "rows.cuh"

namespace tmvb {

constexpr int kEstepThreads = 256;
constexpr int kEstepWarps = kEstepThreads / 32;
constexpr int kMaxShares = 6;   // leaves the widest NSF document (L = 128,
                                 // K = 100) in 56 KB: 4 blocks an SM

// Row stride: K rounded up to a multiple of 4 floats that is an odd
// number of float4s.
__host__ __device__ inline int estep_stride(int K) {
  const int g = (K + 3) / 4;
  return 4 * (g | 1);
}

// Shares of the slots in the q product: as many as 256 threads allow
// over the stride's float4s, at most kMaxShares.
__host__ __device__ inline int estep_shares(int Kp) {
  const int g = Kp / 4;
  return g >= kEstepThreads ? 1 : (kEstepThreads / g < kMaxShares ? kEstepThreads / g : kMaxShares);
}

// Shared memory in elements of R (float, or double in the float64 mode):
// rows [tile, Kp], e twice [Kp], q partials [shares, Kp], gamma/El/El_old
// [K rounded to 4] each, 32 for the sums and the compaction, then the slot
// list [3, L] when it is kept there.
template <typename R>
__host__ __device__ inline size_t estep_smem(int64_t L, int K, int64_t tile, bool meta) {
  const int Kp = estep_stride(K);
  const size_t base = (2 + estep_shares(Kp)) * static_cast<size_t>(Kp) + 3 * ((K + 3) / 4 * 4) + 32;
  return (static_cast<size_t>(tile) * Kp + base + (meta ? 3 * L : 0)) * sizeof(R);
}

struct EstepShape {
  int tile;          // slots whose rows are in shared memory at once
  int meta_in_smem;  // the slot list in shared memory (else device scratch)
  int resident;      // every slot fits: rows loaded once, no tiles
  size_t bytes;
};

// 0, or a CUDA error code when the device cannot be queried or K is too
// wide for one row in shared memory.  All rows stay in shared memory when
// that leaves room for 2 blocks an SM; else tiles sized for 4 blocks (an
// SM's 228 KB less 1 KB the device keeps per block).  In the float64 mode
// (R = double) every element takes 8 bytes, so the resident L, the tile
// and the widest K halve.
template <typename R>
inline int estep_shape(int64_t L, int64_t K, EstepShape* s) {
  const int optin = smem_optin();
  if (optin < 0) return query_error();
  const size_t full = estep_smem<R>(L, static_cast<int>(K), L, true);
  if (full <= static_cast<size_t>(optin) / 2) {
    *s = {static_cast<int>(L), 1, 1, full};
    return 0;
  }
  const size_t row = estep_stride(static_cast<int>(K)) * sizeof(R);
  for (size_t budget : {static_cast<size_t>(optin) / 4 - 1024, static_cast<size_t>(optin)}) {
    const bool meta = estep_smem<R>(L, static_cast<int>(K), 32, true) <= budget;
    const size_t base = estep_smem<R>(L, static_cast<int>(K), 0, meta);
    if (base + row > budget) continue;
    const int64_t tile = std::min<int64_t>(L, static_cast<int64_t>((budget - base) / row));
    *s = {static_cast<int>(tile), meta ? 1 : 0, 0,
          estep_smem<R>(L, static_cast<int>(K), tile, meta)};
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// cs_i = c_i / s_i, s_i = sum_k rows[i, k] e_k, for the m rows; threads
// over slots.  R is float, or double in the float64 mode (groups of four
// doubles, Double4).
template <typename R>
__device__ __forceinline__ void s_product(const R* rows, int m, const R* e, const R* mc,
                                          R* mcs, int Kp) {
  using V4 = typename Real<R>::V4;
  const int G = Kp / 4;
  const V4* e4 = reinterpret_cast<const V4*>(e);
  for (int i = threadIdx.x; i < m; i += kEstepThreads) {
    const V4* r4 = reinterpret_cast<const V4*>(rows + static_cast<size_t>(i) * Kp);
    V4 a = Real<R>::zero4();
#pragma unroll 5
    for (int g = 0; g < G; ++g) {
      const V4 x = r4[g], y = e4[g];
      a.x = Real<R>::fma(x.x, y.x, a.x);
      a.y = Real<R>::fma(x.y, y.y, a.y);
      a.z = Real<R>::fma(x.z, y.z, a.z);
      a.w = Real<R>::fma(x.w, y.w, a.w);
    }
    mcs[i] = mc[i] / ((a.x + a.y) + (a.z + a.w));
  }
}

// qpart[h, k] (+)= sum over the rows i = h, h + nsh, ... < m of
// cs_i rows[i, k]; thread (h, g) owns the float4 g of share h.
template <typename R>
__device__ __forceinline__ void q_product(const R* rows, int m, const R* mcs, R* qpart, int Kp,
                                          int nsh, bool first) {
  using V4 = typename Real<R>::V4;
  const int G = Kp / 4;
  const V4* r4 = reinterpret_cast<const V4*>(rows);
  V4* q4 = reinterpret_cast<V4*>(qpart);
  for (int o = threadIdx.x; o < nsh * G; o += kEstepThreads) {
    const int h = o / G, g = o - h * G;
    V4 q = first ? Real<R>::zero4() : q4[o];
#pragma unroll 4
    for (int i = h; i < m; i += nsh) {
      const R r = mcs[i];
      const V4 x = r4[static_cast<size_t>(i) * G + g];
      q.x = Real<R>::fma(r, x.x, q.x);
      q.y = Real<R>::fma(r, x.y, q.y);
      q.z = Real<R>::fma(r, x.z, q.z);
      q.w = Real<R>::fma(r, x.w, q.w);
    }
    q4[o] = q;
  }
}

// w rows of compact slots j0 .. j0 + m - 1: rows[i, k] * (e_k * cs_i).
template <typename R>
__device__ __forceinline__ void write_rows(R* __restrict__ wd, const R* rows, int m, const R* e,
                                           const R* mcs, const int* mslot, int K, int Kp,
                                           bool vec) {
  using V4 = typename Real<R>::V4;
  if (vec) {
    const int G = Kp / 4, Gw = K / 4;
    const V4* r4 = reinterpret_cast<const V4*>(rows);
    const V4* e4 = reinterpret_cast<const V4*>(e);
    V4* w4 = reinterpret_cast<V4*>(wd);
    for (int idx = threadIdx.x; idx < m * Gw; idx += kEstepThreads) {
      const int i = idx / Gw, g = idx - i * Gw;
      const R r = mcs[i];
      const V4 x = r4[static_cast<size_t>(i) * G + g], y = e4[g];
      w4[static_cast<size_t>(mslot[i]) * Gw + g] =
          V4{x.x * (y.x * r), x.y * (y.y * r), x.z * (y.z * r), x.w * (y.w * r)};
    }
  } else {
    for (int idx = threadIdx.x; idx < m * K; idx += kEstepThreads) {
      const int i = idx / K, k = idx - i * K;
      wd[static_cast<size_t>(mslot[i]) * K + k] = rows[static_cast<size_t>(i) * Kp + k] * (e[k] * mcs[i]);
    }
  }
}

// Compacts the slots l < L with c[l] != 0, in slot order, into mc (their
// counts) and mslot (their slots), and with `mterm` their terms t[l] (read
// beside the counts); returns their number.  wcount: 8 ints of shared
// memory.  Every thread of the block must call it.
template <typename R>
__device__ __forceinline__ int compact_slots(const R* c, int L, R* mc, int* mslot,
                                             int* wcount, const int* t = nullptr,
                                             int* mterm = nullptr) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int n = 0;
  for (int base = 0; base < L; base += kEstepThreads) {
    const int l = base + tid;
    const R cl = l < L ? c[l] : R(0);
    const int tl = mterm != nullptr && l < L ? t[l] : 0;
    const unsigned ball = __ballot_sync(0xffffffffu, cl != R(0));
    if (lane == 0) wcount[warp] = __popc(ball);
    __syncthreads();
    int off = n, total = n;
#pragma unroll
    for (int i = 0; i < kEstepWarps; ++i) {
      off += i < warp ? wcount[i] : 0;
      total += wcount[i];
    }
    if (cl != R(0)) {
      const int j = off + __popc(ball & ((1u << lane) - 1u));
      mc[j] = cl;
      mslot[j] = l;
      if (mterm != nullptr) mterm[j] = tl;
    }
    n = total;
    __syncthreads();  // the list is complete; wcount may be rewritten
  }
  return n;
}

// R = float: the float32 mode, and with kF64 its f64 Elogtheta channel.
// R = double: the float64 mode, every input, output and sum in double,
// psi the same series in double (digamma_series(double)); the channel is
// the identity there.  Two blocks an SM: a double row tile is twice the
// bytes.
template <typename R, bool kF64>
__global__ void __launch_bounds__(kEstepThreads, sizeof(R) == 4 ? 4 : 2) lda_estep_kernel(
    const R* __restrict__ betaT,     // [V, K] beta^T + eps
    const int* __restrict__ terms,   // [B, L]
    const R* __restrict__ counts,    // [B, L], 0 on padding
    const R* __restrict__ doc_mask,  // [B]
    const R* __restrict__ alpha,     // [K]
    const R* __restrict__ gamma_in,  // [B, K]
    const R* __restrict__ el_in,     // [B, K]
    const R* __restrict__ elo_in,    // [B, K]
    R* __restrict__ gamma_out, R* __restrict__ el_out,
    R* __restrict__ elo_out,
    R* __restrict__ w,               // [B, L, K]
    R* scratch,                      // [B, 3 L], the slot lists when not in smem
    int L, int K, int tile, int meta_in_smem, int resident, int viter, R vtol2,
    int vec_in, int vec_out) {
  static_assert(!kF64 || sizeof(R) == 4, "the f64 Elogtheta channel is a float32 mode");
  extern __shared__ __align__(16) unsigned char estep_smem_raw[];
  R* smem = reinterpret_cast<R*>(estep_smem_raw);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int Kp = estep_stride(K), nsh = estep_shares(Kp), K4 = (K + 3) / 4 * 4;
  R* rows = smem;
  R* e_cur = rows + static_cast<size_t>(tile) * Kp;
  R* e_nxt = e_cur + Kp;
  R* qpart = e_nxt + Kp;
  R* gam = qpart + nsh * Kp;
  R* el = gam + K4;
  R* elo = el + K4;
  R* red = elo + K4;  // [32]: Σγ [8], Σd² [8], compaction counts [8]
  R* meta = meta_in_smem ? red + 32 : scratch + static_cast<size_t>(b) * 3 * L;
  R* mc = meta;                                    // count of compact slot j
  R* mcs = meta + L;                               // its c / s
  int* mslot = reinterpret_cast<int*>(meta + 2 * L);   // its slot
  const int* t = terms + static_cast<size_t>(b) * L;
  const R* c = counts + static_cast<size_t>(b) * L;
  const size_t dk = static_cast<size_t>(b) * K;

  // the slots with a count, in slot order
  const int n = compact_slots(c, L, mc, mslot, reinterpret_cast<int*>(red + 16));

  const bool vin = vec_in != 0;
  if (resident) load_rows<kEstepThreads>(rows, betaT, t, mslot, 0, n, K, Kp, vin);
  for (int k = tid; k < Kp; k += kEstepThreads) {
    if (k < K) {
      gam[k] = gamma_in[dk + k];
      const R x = el_in[dk + k];
      el[k] = x;
      elo[k] = elo_in[dk + k];
      e_cur[k] = Real<R>::exp(x);
    } else {
      e_cur[k] = R(0);
      e_nxt[k] = R(0);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  bool active = doc_mask[b] > R(0);
  int it = 0;
  R* e_last = e_cur;
  for (; it < viter && active; ++it) {
    for (int j0 = 0; j0 < n; j0 += tile) {
      const int m = min(tile, n - j0);
      if (!resident) {
        load_rows<kEstepThreads>(rows, betaT, t, mslot, j0, m, K, Kp, vin);
        cp_async_wait_all();
        __syncthreads();
      }
      s_product(rows, m, e_cur, mc + j0, mcs + j0, Kp);
      __syncthreads();
      q_product(rows, m, mcs + j0, qpart, Kp, nsh, j0 == 0);
      __syncthreads();
    }
    if constexpr (kF64) {
      // gamma_new in f32 into gam; its sum and both psi in double, after
      // the sum's barrier, by the thread that owns each topic
      double gpart = 0.0;
      for (int k = tid; k < K; k += kEstepThreads) {
        float q = 0.f;
        if (n > 0)
          for (int h = 0; h < nsh; ++h) q += qpart[h * Kp + k];
        const float g = alpha[k] + e_cur[k] * q + kEps;
        gam[k] = g;
        gpart += static_cast<double>(g);
      }
      const double g_sum = block_sum_once<kEstepWarps>(gpart, reinterpret_cast<double*>(red));
      float dpart = 0.f;
      if (tid < K) {
        const double dg_sum = digamma_series64(g_sum);
        for (int k = tid; k < K; k += kEstepThreads) {
          const float el_new =
              static_cast<float>(digamma_series64(static_cast<double>(gam[k])) - dg_sum);
          const float d = el_new - el[k];
          dpart += d * d;
          elo[k] = el[k];
          el[k] = el_new;
          e_nxt[k] = expf(el_new);
        }
      }
      active = block_sum_once<kEstepWarps>(dpart, red + 24) >= vtol2;
    } else {
      // gamma_new into gam and psi(gamma_new) into e_nxt, before the sum's
      // barrier (owner k only; El_new then replaces e_nxt)
      R gpart = 0;
      for (int k = tid; k < K; k += kEstepThreads) {
        R q = 0;
        if (n > 0)
          for (int h = 0; h < nsh; ++h) q += qpart[h * Kp + k];
        const R g = alpha[k] + e_cur[k] * q + Real<R>::eps;
        gam[k] = g;
        e_nxt[k] = digamma_series(g);
        gpart += g;
      }
      const R g_sum = block_sum_once<kEstepWarps>(gpart, red);
      R dpart = 0;
      if (tid < K) {  // the threads that own a topic
        const R dg_sum = digamma_series(g_sum);
        for (int k = tid; k < K; k += kEstepThreads) {
          const R el_new = e_nxt[k] - dg_sum;
          const R d = el_new - el[k];
          dpart += d * d;
          elo[k] = el[k];
          el[k] = el_new;
          e_nxt[k] = Real<R>::exp(el_new);
        }
      }
      active = block_sum_once<kEstepWarps>(dpart, red + 8) >= vtol2;
    }
    e_last = e_cur;
    e_cur = e_nxt;
    e_nxt = e_last;
  }

  // M-step rows from phi(beta, El_old), the value phi held when the
  // document stopped (the warm-start identity of LDA.jl:87): the last
  // pass's e and c / s, or, when no pass ran, e = exp(El_old) and s anew
  const bool ran = it > 0;
  if (!ran) {
    for (int k = tid; k < K; k += kEstepThreads) e_cur[k] = Real<R>::exp(elo[k]);
    e_last = e_cur;
    __syncthreads();
  }
  for (int k = tid; k < K; k += kEstepThreads) {
    gamma_out[dk + k] = gam[k];
    el_out[dk + k] = el[k];
    elo_out[dk + k] = elo[k];
  }
  R* wd = w + static_cast<size_t>(b) * L * K;
  const bool vout = vec_out != 0;
  const int Kq = vout ? K / 4 : K;
  for (int idx = tid; idx < L * Kq; idx += kEstepThreads) {
    const int l = idx / Kq;
    if (c[l] != R(0)) continue;
    if (vout)
      reinterpret_cast<typename Real<R>::V4*>(wd)[idx] = Real<R>::zero4();
    else
      wd[idx] = R(0);
  }
  for (int j0 = 0; j0 < n; j0 += tile) {
    const int m = min(tile, n - j0);
    if (!resident) {
      load_rows<kEstepThreads>(rows, betaT, t, mslot, j0, m, K, Kp, vin);
      cp_async_wait_all();
      __syncthreads();
    }
    if (!ran) {
      s_product(rows, m, e_last, mc + j0, mcs + j0, Kp);
      __syncthreads();
    }
    write_rows(wd, rows, m, e_last, mcs + j0, mslot + j0, K, Kp, vout);
    if (!resident) __syncthreads();  // before the next tile's rows land
  }
}

// The float64 mode's resident design (lda_estep_res_kernel; K <= 512 and
// a document's L rows fit one CTA's shared memory, lda_double_shape): the
// function of lda_estep_kernel<double>, one CTA of 256 threads a
// document, the design of ctpf_estep_res_kernel in its single-phase case.
// - The kept slots are compacted with each slot's term read beside its
//   count (the terms held in the c / s words until the first pass), and
//   their rows copied once into shared memory (cp.async through L1, 16
//   bytes where K is even and the table aligned), stride K, then KQ - K
//   zeros (KQ = G NV, the lanes' topics), read from there on every pass.
//   The padding slots' rows of w are zeros, stored while the rows come in.
// - A pass: the kept slots go 8 W at a time over the 8 warps (W = S D:
//   S = 32 / G groups of G lanes, D slots a group at once; lda_res_lanes,
//   8 lanes of 13 topics and D = 1 at K = 100), a warp with no slot left
//   skipping its rounds; lane (g, sub) holds topics sub + G v, v < NV, a
//   compile-time count, with e and the q partials in registers.  A lane
//   reads its topics at fixed offsets from its row: past K it reads on
//   into the next row or the zeros, finite values against e's zeros.  At
//   S = 4 the groups of a half-warp take slots two apart: at K = 100
//   (stride 800 bytes, 32 mod 128) their rows' 64 bytes then fall 64
//   bytes apart, on different banks, where neighbouring slots would
//   overlap.  Per slot: s = row . e in four chains, a butterfly over the
//   group, r = c / s (kept in the slot list for the rows of w), then q +=
//   r row.
// - The fold: a butterfly over the warp's groups; each busy warp stores
//   its q and its e . q (in four chains), then one barrier.  A warp with
//   no slot holds zeros there (stored once), so every sum over the warps
//   is a fixed tree of all 8.  sum gamma = sum (alpha + eps) + the warps'
//   e . q: no barrier of its own.  gamma_k = alpha_k + e_k q_k + eps; the
//   CTA's first half takes El = psi(gamma) - psi(sum gamma)
//   (digamma_series, the plain version's series), its d^2 and El_old,
//   the second half the next e = exp(psi(gamma)) / exp(psi(sum gamma))
//   without a log (exp_digamma), 31 topics a warp at a time: lane 31
//   takes the sum's term in the same instructions as the other lanes'
//   topics and shuffles it to them.  Then the stop test: the warps' d^2
//   sums after one barrier, as a tree.  Two barriers a pass.
// - The rows of w, row (e r) with the e and r of the last pass (phi of
//   El_old): written by the last pass the loop allows, from its registers;
//   when the stop test ends the loop sooner, after it from the rows in
//   shared memory and the slot list's r (the same products, the same
//   bits); when no pass ran (viter 0, or doc_mask 0), e = exp(El_old) and
//   s anew, as lda_estep_kernel.
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6, PR
// 24): the widest NSF chunk takes 2 CTAs an SM in ~4 waves; with no pass
// ~67 us (the rows from L2 as every CTA of a wave starts, w's 105 MB as
// they end), then ~14 us a pass, each CTA a chain of dependent FP64
// operations (~25 cycles each in tools/estep_trace.py's clock marks):
// four slot rounds, the fold, then gamma, psi and the stop test on the
// first half.
// Every sum in one fixed order: same inputs, same bits.

constexpr int kResWarpsHalf = kEstepWarps / 2;   // the warps of each half of the CTA
constexpr int kResStep = 31 * kResWarpsHalf;      // topics a half takes at a time
constexpr int kResRed = 24;   // the warps' e . q [8], sum d^2 [8], compaction counts [8 ints]

// Shared memory of the resident design in bytes: the kept rows [L, K] and
// KQ - K zeros after the last (a lane's topics past K read on into the
// next row, or into them, at fixed offsets), the warps' q [8, K], e twice,
// gamma, El and El_old [K] each, the sums, the slot list's counts and c /
// s [L] each (doubles), then its slots [L] (ints).  KQ = G NV >= K.
__host__ __device__ inline size_t lda_res_smem(int64_t L, int64_t K, int64_t KQ) {
  return (static_cast<size_t>(L) * K + static_cast<size_t>(KQ - K) +
          (kEstepWarps + 5) * static_cast<size_t>(K) + kResRed + 2 * static_cast<size_t>(L)) *
             sizeof(double) +
         static_cast<size_t>(L) * sizeof(int);
}

// Lanes a slot (G), topics a lane (NV) and slots a group takes at once
// (D) of LDA's resident design; G = 0 past K = 512.  The widest NSF chunk
// (K = 100) takes 8 lanes of 13 topics, one slot a group: its arrays (a
// row, e and q in registers, 78 of a thread's 128) leave no room for a
// second slot (D = 2 spills), and 16 lanes of 7 topics at D = 1, 2 or 4
// ran slower (PERF.md section 6).  Where the registers allow it,
// two slots a group: narrow K, 16 lanes of 8 at K = 105-128 (8 lanes of
// 16 spill), 32 lanes of 8 to K = 256.
struct LdaResShape {
  int G, NV, D;
};
__host__ __device__ inline LdaResShape lda_res_lanes(int64_t K) {
  if (K <= 32) return {8, 4, 2};
  if (K <= 64) return {8, 8, 2};
  if (K <= 104) return {8, 13, 1};
  if (K <= 128) return {16, 8, 2};
  if (K <= 256) return {32, 8, 2};
  return {K <= 512 ? 32 : 0, 16, 1};
}

// The lane's e for its topics, 0 past K.
template <int G, int NV>
__device__ __forceinline__ void lda_res_e(double (&e)[NV], const double* src, int K, int sub) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int k = sub + G * v;
    e[v] = k < K ? src[k] : 0.0;
  }
}

// One pass over the kept slots [0, n), D slots a group at a time (their
// loads, chains, butterflies and divisions interleave): each slot's r =
// c / s into mcs and r row into acc, and with `rows_out` its row of w,
// row (e r), from the registers.
template <int G, int NV, int D>
__device__ __forceinline__ void lda_res_slots(const double* rows, const double (&e)[NV],
                                              double (&acc)[NV], const double* mc, double* mcs,
                                              double* wd, const int* mslot, int n, int K,
                                              bool rows_out) {
  constexpr int S = 32 / G, W = S * D;   // slots a warp takes at once
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane / G, sub = lane % G;
  const int gslot = S == 4 ? ((gq & 1) << 1) | (gq >> 1) : gq;
  for (int j0 = warp * W; j0 < n; j0 += kEstepWarps * W) {
    double x[D][NV], s[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      // past K the lane reads the next row's first topics (or the zeros
      // after the last row): finite, and e is 0 there
      const double* row = rows + static_cast<size_t>(min(j0 + d * S + gslot, n - 1)) * K + sub;
      double c4[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        x[d][v] = row[G * v];
        c4[v % 4] = fma(x[d][v], e[v], c4[v % 4]);
      }
      s[d] = (c4[0] + c4[1]) + (c4[2] + c4[3]);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
      for (int d = 0; d < D; ++d) s[d] += __shfl_xor_sync(0xffffffffu, s[d], o);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int j = j0 + d * S + gslot;
      if (j < n) {
        const double r = mc[j] / s[d];
        if (sub == 0) mcs[j] = r;
#pragma unroll
        for (int v = 0; v < NV; ++v) acc[v] = fma(r, x[d][v], acc[v]);
        if (rows_out) {
          double* dst = wd + static_cast<size_t>(mslot[j]) * K;
#pragma unroll
          for (int v = 0; v < NV; ++v)
            if (sub + G * v < K) dst[sub + G * v] = x[d][v] * (e[v] * r);
        }
      }
    }
  }
}

// The warp's q, its groups' acc added by a butterfly over them, into
// qw [K] and its e . q into *eqw.
template <int G, int NV>
__device__ __forceinline__ void lda_res_fold(double (&acc)[NV], const double (&e)[NV], double* qw,
                                             double* eqw, int K) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o);
  double c4[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int v = 0; v < NV; ++v) c4[v % 4] = fma(e[v], acc[v], c4[v % 4]);
  double eq = (c4[0] + c4[1]) + (c4[2] + c4[3]);
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) eq += __shfl_xor_sync(0xffffffffu, eq, o);
  if (lane < G) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (lane + G * v < K) qw[lane + G * v] = acc[v];
  }
  if (lane == 0) *eqw = eq;
}

// The 8 warps' values p[0], p[stride], ..., p[7 stride] summed as a tree
// (one fixed order, three additions deep; a warp with no slot holds 0).
__device__ __forceinline__ double lda_res_sum8(const double* p, int stride) {
  double a[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) a[v] = p[v * stride];
  return ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
}

// gamma_k of the pass: alpha_k + e_k q_k + eps, q_k the warps' summed.
__device__ __forceinline__ double lda_res_gamma(double alpha_k, const double* qpart,
                                                const double* e, int K, int k) {
  return alpha_k + e[k] * lda_res_sum8(qpart + k, K) + Real<double>::eps;
}

// Topic k's El = el_new, its gamma g and El_old; returns its d^2.
__device__ __forceinline__ double lda_res_el(double* gam, double* el, double* elo, int k,
                                             double g, double el_new) {
  const double d = el_new - el[k];
  gam[k] = g;
  elo[k] = el[k];
  el[k] = el_new;
  return d * d;
}

template <int G, int NV, int D>
__global__ void __launch_bounds__(kEstepThreads, 2) lda_estep_res_kernel(
    const double* __restrict__ betaT, const int* __restrict__ terms,
    const double* __restrict__ counts, const double* __restrict__ doc_mask,
    const double* __restrict__ alpha, const double* __restrict__ gamma_in,
    const double* __restrict__ el_in, const double* __restrict__ elo_in,
    double* __restrict__ gamma_out, double* __restrict__ el_out, double* __restrict__ elo_out,
    double* __restrict__ w, int L, int K, int viter, double vtol2, int vec_in, int vec_out) {
  using R = double;
  constexpr int W = 32 / G * D;   // slots a warp takes at once
  extern __shared__ __align__(16) unsigned char lda_res_smem_raw[];
  R* rows = reinterpret_cast<R*>(lda_res_smem_raw);   // kept slot j's row at j K
  constexpr int KQ = G * NV;                           // the lanes' topics, >= K
  R* qpart = rows + static_cast<size_t>(L) * K + (KQ - K);   // the warps' q [8, K]
  R* e_cur = qpart + kEstepWarps * K;                  // e of this pass
  R* e_nxt = e_cur + K;                                // of the next
  R* gam = e_nxt + K;
  R* el = gam + K;
  R* elo = el + K;
  R* red = elo + K;                                    // [kResRed]
  R* mc = red + kResRed;                               // count of kept slot j
  R* mcs = mc + L;                                     // its c / s
  int* mslot = reinterpret_cast<int*>(mcs + L);        // its slot
  int* mterm = reinterpret_cast<int*>(mcs);            // its term, until the first pass
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* t = terms + static_cast<size_t>(b) * L;
  const R* c = counts + static_cast<size_t>(b) * L;
  const size_t dk = static_cast<size_t>(b) * K;

  // the kept slots, in slot order, each with its term
  const int n = compact_slots(c, L, mc, mslot, reinterpret_cast<int*>(red + 16), t, mterm);
  if (vec_in) {
    const int H = K / 2;
    for (int idx = tid; idx < n * H; idx += kEstepThreads) {
      const int j = idx / H, h = idx - j * H;
      cp_async16_ca(rows + static_cast<size_t>(j) * K + 2 * h,
                    betaT + static_cast<size_t>(mterm[j]) * K + 2 * h);
    }
  } else {
    for (int idx = tid; idx < n * K; idx += kEstepThreads) {
      const int j = idx / K, k = idx - j * K;
      cp_async8(rows + idx, betaT + static_cast<size_t>(mterm[j]) * K + k);
    }
  }
  for (int i = tid; i < KQ - K; i += kEstepThreads) rows[static_cast<size_t>(n) * K + i] = R(0);
  // the padding slots' rows of w: zeros, stored while the rows come in
  R* wd = w + static_cast<size_t>(b) * L * K;
  const int E = vec_out ? 2 : 1;   // doubles a store
  const int H = K / E;
  for (int idx = tid; idx < L * H; idx += kEstepThreads) {
    if (c[idx / H] != R(0)) continue;
    if (vec_out)
      reinterpret_cast<double2*>(wd)[idx] = make_double2(0.0, 0.0);
    else
      wd[idx] = R(0);
  }
  // the state; e = exp(El) for a first pass, exp(El_old) for the rows when
  // no pass runs
  bool active = doc_mask[b] > R(0);
  const bool runs = active && viter > 0;
  for (int k = tid; k < K; k += kEstepThreads) {
    gam[k] = gamma_in[dk + k];
    const R x = el_in[dk + k], xo = elo_in[dk + k];
    el[k] = x;
    elo[k] = xo;
    e_cur[k] = Real<R>::exp(runs ? x : xo);
  }
  // sum (alpha + eps), each warp the same bits
  R asum = R(0);
  for (int k = lane; k < K; k += 32) asum += alpha[k] + Real<R>::eps;
  asum = warp_sum(asum);
  // a warp with no slot adds zeros to every pass's sums
  const int nb = min(kEstepWarps, (n + W - 1) / W);   // the warps that hold a slot
  if (warp >= nb) {
    for (int k = lane; k < K; k += 32) qpart[warp * K + k] = R(0);
    if (lane == 0) red[warp] = R(0);
  }
  cp_async_wait_all();
  __syncthreads();

  const bool ehalf = warp >= kResWarpsHalf;
  // each half's warp takes 31 topics at a time, lane 31 the sum's term
  const int k0 = (warp % kResWarpsHalf) * 31 + lane;
  const bool mine = lane < 31 && k0 < K;
  const R alpha0 = mine ? alpha[k0] : R(0);   // the first topic's, held across the passes
  int it = 0;
  for (; it < viter && active; ++it) {
    R e[NV], acc[NV];
    lda_res_e<G, NV>(e, e_cur, K, lane % G);
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] = R(0);
    // the last pass the loop allows writes the kept slots' rows as it goes
    lda_res_slots<G, NV, D>(rows, e, acc, mc, mcs, wd, mslot, n, K, it == viter - 1);
    if (warp < nb) lda_res_fold<G, NV>(acc, e, qpart + warp * K, red + warp, K);
    __syncthreads();
    // sum gamma from the warps' e . q; then each topic's update, El on the
    // first half and the next e on the second, 31 topics a warp at a time:
    // lane 31 takes the sum's psi (exp psi) in the same instructions as the
    // first topics' and hands it to its warp
    const R gs = asum + lda_res_sum8(red, 1);
    R dpart = R(0);
    if (k0 - lane < K) {
      const R g0 = mine ? lda_res_gamma(alpha0, qpart, e_cur, K, k0) : R(1);
      if (ehalf) {
        const R f = exp_digamma(lane == 31 ? gs : g0);
        const R den = __shfl_sync(0xffffffffu, f, 31);
        if (mine) e_nxt[k0] = f / den;
        for (int k = k0 + kResStep; lane < 31 && k < K; k += kResStep)
          e_nxt[k] = exp_digamma(lda_res_gamma(alpha[k], qpart, e_cur, K, k)) / den;
      } else {
        const R f = digamma_series(lane == 31 ? gs : g0);
        const R dgs = __shfl_sync(0xffffffffu, f, 31);
        if (mine) dpart = lda_res_el(gam, el, elo, k0, g0, f - dgs);
        for (int k = k0 + kResStep; lane < 31 && k < K; k += kResStep) {
          const R g = lda_res_gamma(alpha[k], qpart, e_cur, K, k);
          dpart += lda_res_el(gam, el, elo, k, g, digamma_series(g) - dgs);
        }
      }
    }
    dpart = warp_sum(dpart);
    if (lane == 0) red[kEstepWarps + warp] = dpart;
    __syncthreads();
    active = lda_res_sum8(red + kEstepWarps, 1) >= vtol2;
    R* x = e_cur;
    e_cur = e_nxt;
    e_nxt = x;
  }

  for (int k = tid; k < K; k += kEstepThreads) {
    gamma_out[dk + k] = gam[k];
    el_out[dk + k] = el[k];
    elo_out[dk + k] = elo[k];
  }
  // the kept slots' rows from phi(beta, El_old): written by the last pass
  // the loop allows; when no pass ran, with e = exp(El_old) and s anew;
  // when the stop test ended the loop sooner, from its last pass's e and r
  if (it == 0) {
    R e[NV], acc[NV] = {};
    lda_res_e<G, NV>(e, e_cur, K, lane % G);
    lda_res_slots<G, NV, D>(rows, e, acc, mc, mcs, wd, mslot, n, K, true);
  } else if (it < viter) {
    const R* e_last = e_nxt;
    for (int idx = tid; idx < n * H; idx += kEstepThreads) {
      const int j = idx / H, k = E * (idx - j * H);
      const R r = mcs[j];
      const R* x = rows + static_cast<size_t>(j) * K + k;
      R* dst = wd + static_cast<size_t>(mslot[j]) * K + k;
      const R o0 = x[0] * (e_last[k] * r);
      if (vec_out)
        *reinterpret_cast<double2*>(dst) = make_double2(o0, x[1] * (e_last[k + 1] * r));
      else
        *dst = o0;
    }
  }
}

// The float64 mode's choice: the resident design's lanes a slot, topics
// a lane and slots a group takes at once (G = 0: lda_estep_kernel<double>)
// and its shared memory.
struct LdaDoubleShape {
  int G, NV, D;
  size_t bytes;
};
inline int lda_double_shape(int64_t L, int64_t K, LdaDoubleShape* s) {
  const int optin = smem_optin();
  if (optin < 0) return query_error();
  const LdaResShape r = lda_res_lanes(K);
  const size_t bytes = r.G > 0 ? lda_res_smem(L, K, static_cast<int64_t>(r.G) * r.NV) : 0;
  *s = {r.G > 0 && bytes <= static_cast<size_t>(optin) ? r.G : 0, r.NV, r.D, bytes};
  return 0;
}

// The resident design's kernel for (G, NV, D), or nullptr.
inline const void* lda_res_kernel(int G, int NV, int D) {
#define TMVB_LDA_RES(g, nv, d) \
  if (G == g && NV == nv && D == d) return reinterpret_cast<const void*>(lda_estep_res_kernel<g, nv, d>)
  TMVB_LDA_RES(8, 4, 2);
  TMVB_LDA_RES(8, 8, 2);
  TMVB_LDA_RES(8, 13, 1);
  TMVB_LDA_RES(16, 8, 2);
  TMVB_LDA_RES(32, 8, 2);
  TMVB_LDA_RES(32, 16, 1);
#undef TMVB_LDA_RES
  return nullptr;
}

// The pass mode's block mode (K > 512, past the warp mode's reach; the
// block-per-document design): one pass of the fixpoint without its
// update, this rank's partial document statistic pc[b, k] = e_k * q_k,
// e = exp(El[b]), q as above over the document's own slots (their
// normaliser s_l over this rank's table), for the modes whose token slots
// are split over ranks (routed tensor parallelism, the sequence axis).  The caller sums pc over the
// ranks and runs gamma, psi and the stop test on the [B, K] tiles
// between passes.  Same block, slot list, rows and products as
// lda_estep_kernel; a document with doc_mask 0 gets pc = 0 and reads
// nothing.  One fixed order for every sum: same inputs, same bits.
// R = double is its float64 mode, every input, output and sum in double
// (two blocks an SM, as the full kernel's).
template <typename R>
__global__ void __launch_bounds__(kEstepThreads, sizeof(R) == 4 ? 4 : 2) lda_estep_pass_kernel(
    const R* __restrict__ betaT,     // [V, K] beta^T + eps (this rank's rows)
    const int* __restrict__ terms,   // [B, L]
    const R* __restrict__ counts,    // [B, L], 0 on padding
    const R* __restrict__ doc_mask,  // [B]
    const R* __restrict__ el_in,     // [B, K]
    R* __restrict__ pc,              // [B, K]
    R* scratch,                      // [B, 3 L], the slot lists when not in smem
    int L, int K, int tile, int meta_in_smem, int resident, int vec_in) {
  extern __shared__ __align__(16) unsigned char estep_smem_raw[];
  R* smem = reinterpret_cast<R*>(estep_smem_raw);
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t dk = static_cast<size_t>(b) * K;
  if (!(doc_mask[b] > R(0))) {
    for (int k = tid; k < K; k += kEstepThreads) pc[dk + k] = R(0);
    return;
  }
  const int Kp = estep_stride(K), nsh = estep_shares(Kp), K4 = (K + 3) / 4 * 4;
  R* rows = smem;
  R* e = rows + static_cast<size_t>(tile) * Kp;
  R* qpart = e + 2 * Kp;
  R* red = qpart + nsh * Kp + 3 * K4;
  R* meta = meta_in_smem ? red + 32 : scratch + static_cast<size_t>(b) * 3 * L;
  R* mc = meta;
  R* mcs = meta + L;
  int* mslot = reinterpret_cast<int*>(meta + 2 * L);
  const int* t = terms + static_cast<size_t>(b) * L;

  const int n = compact_slots(counts + static_cast<size_t>(b) * L, L, mc, mslot,
                              reinterpret_cast<int*>(red + 16));
  const bool vin = vec_in != 0;
  if (resident) load_rows<kEstepThreads>(rows, betaT, t, mslot, 0, n, K, Kp, vin);
  for (int k = tid; k < Kp; k += kEstepThreads) e[k] = k < K ? Real<R>::exp(el_in[dk + k]) : R(0);
  cp_async_wait_all();
  __syncthreads();
  for (int j0 = 0; j0 < n; j0 += tile) {
    const int m = min(tile, n - j0);
    if (!resident) {
      load_rows<kEstepThreads>(rows, betaT, t, mslot, j0, m, K, Kp, vin);
      cp_async_wait_all();
      __syncthreads();
    }
    s_product(rows, m, e, mc + j0, mcs + j0, Kp);
    __syncthreads();
    q_product(rows, m, mcs + j0, qpart, Kp, nsh, j0 == 0);
    __syncthreads();
  }
  for (int k = tid; k < K; k += kEstepThreads) {
    R q = R(0);
    if (n > 0)
      for (int h = 0; h < nsh; ++h) q += qpart[h * Kp + k];
    pc[dk + k] = e[k] * q;
  }
}

// The pass mode's warp mode (K <= 512): pc as lda_estep_pass_kernel
// computes it, a document's slots over the warps of a CTA (w of them;
// with w = 1 a CTA holds kPassShortDocs documents, a warp each).  Each
// warp takes 32 of its slots at a time (blocks of 8, every w-th): a
// ballot of c != 0 picks the kept slots and shuffles compact their terms
// and counts into its lanes.  Its S groups of G lanes then take S kept
// slots at once, D rows a group read into registers (row_to_regs) before
// the first is reduced; for each row s_l = sum_k row e_k (each lane's
// products, then a butterfly over the group), cs = c / s and q += cs row,
// all in registers.  The groups' q are added by a butterfly over the
// warp, then (w > 1) the warps' in warp order through shared memory after
// one barrier.  Nothing is staged in shared memory inside the pass.
// Every sum in one fixed order: same inputs, same bits.
template <typename R, int G, int NVL>
__global__ void __launch_bounds__(256) lda_estep_pass_warp_kernel(
    const R* __restrict__ betaT, const int* __restrict__ terms, const R* __restrict__ counts,
    const R* __restrict__ doc_mask, const R* __restrict__ el_in, R* __restrict__ pc, int B,
    int L, int K, int w, int vec_in) {
  using V4 = typename Real<R>::V4;
  constexpr int D = pass_depth<R, G, NVL>(), S = 32 / G;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char pass_smem_raw[];
  R* part = reinterpret_cast<R*>(pass_smem_raw);   // [w, 4 G NVL] when w > 1
  const PassWarp pw = pass_warp(w);
  if (pw.b >= B) return;
  const int lane = threadIdx.x & 31, gi = lane / G, sub = lane % G;
  const size_t dk = static_cast<size_t>(pw.b) * K;
  if (!(doc_mask[pw.b] > R(0))) {
    for (int k = pw.wi * 32 + lane; k < K; k += pw.nthr) pc[dk + k] = R(0);
    return;
  }
  const int* t = terms + static_cast<size_t>(pw.b) * L;
  const R* c = counts + static_cast<size_t>(pw.b) * L;
  // the warp's slots: blocks of 8, the warp's every w-th, 4 blocks a
  // 32-slot round (kept slots lead a document's row, so they spread evenly
  // over its warps; 8 slots are a 32-byte sector of counts and terms)
  const int nblk = (L + 7) / 8;
  V4 e[NVL], q[NVL];
  row_to_regs<R, G, NVL>(e, el_in + dk, K, false, sub);
#pragma unroll
  for (int v = 0; v < NVL; ++v) {
    const int k = 4 * (sub + G * v);
    e[v].x = k < K ? Real<R>::exp(e[v].x) : R(0);
    e[v].y = k + 1 < K ? Real<R>::exp(e[v].y) : R(0);
    e[v].z = k + 2 < K ? Real<R>::exp(e[v].z) : R(0);
    e[v].w = k + 3 < K ? Real<R>::exp(e[v].w) : R(0);
    q[v] = Real<R>::zero4();
  }
  const bool vec = vec_in != 0;
  for (int b0 = pw.wi; b0 < nblk; b0 += 4 * w) {
    const int l = round_slot(b0, w, lane);
    const R cl = l < L ? c[l] : R(0);
    const int tl = l < L ? t[l] : 0;
    const unsigned ball = __ballot_sync(kAll, cl != R(0));
    const int n = __popc(ball);
    // the kept slots' terms and counts into lanes 0 .. n - 1, in slot order
    // (the lanes past them repeat the first: only kept slots' rows are read)
    const int src = kept_src(ball, n, lane);
    const int tk = __shfl_sync(kAll, tl, src);
    const R ck = __shfl_sync(kAll, cl, src);
    for (int r0 = 0; r0 < n; r0 += S * D) {
      V4 x[D][NVL];
      R cd[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int j = r0 + d * S + gi;   // this group's kept slot
        const int tj = __shfl_sync(kAll, tk, j & 31);
        cd[d] = __shfl_sync(kAll, ck, j & 31);
        if (j >= n) cd[d] = R(0);
        if (r0 + d * S < n) {
          row_to_regs<R, G, NVL>(x[d], betaT + static_cast<size_t>(tj) * K, K, vec, sub);
        } else {
#pragma unroll
          for (int v = 0; v < NVL; ++v) x[d][v] = Real<R>::zero4();
        }
      }
      R s[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        V4 a = Real<R>::zero4();
#pragma unroll
        for (int v = 0; v < NVL; ++v) {
          a.x = Real<R>::fma(x[d][v].x, e[v].x, a.x);
          a.y = Real<R>::fma(x[d][v].y, e[v].y, a.y);
          a.z = Real<R>::fma(x[d][v].z, e[v].z, a.z);
          a.w = Real<R>::fma(x[d][v].w, e[v].w, a.w);
        }
        s[d] = (a.x + a.y) + (a.z + a.w);
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
        for (int d = 0; d < D; ++d) s[d] += __shfl_xor_sync(kAll, s[d], o);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (r0 + d * S >= n) break;
        // 0 past the last kept slot: q + 0 row is q, bit for bit (q, row >= 0)
        const R r = cd[d] != R(0) ? cd[d] / s[d] : R(0);
#pragma unroll
        for (int v = 0; v < NVL; ++v) {
          q[v].x = Real<R>::fma(r, x[d][v].x, q[v].x);
          q[v].y = Real<R>::fma(r, x[d][v].y, q[v].y);
          q[v].z = Real<R>::fma(r, x[d][v].z, q[v].z);
          q[v].w = Real<R>::fma(r, x[d][v].w, q[v].w);
        }
      }
    }
  }
  fold_groups<G, NVL>(q);
  pass_out<R, G, NVL>(q, part, w, pw.wi, K,
                      [&](int k, R qk) { pc[dk + k] = Real<R>::exp(el_in[dk + k]) * qk; });
}

// The warp mode's shape for LDA: K <= 64, 8 lanes a slot; K = 65-128, 16
// lanes of two vectors, and in float32 one warp per 16 slots up to L = 64,
// then per 32 (more, lighter warps: 64 registers a thread); past it
// wide_pass_shape.
inline PassShape lda_pass_shape(int64_t L, int64_t K, int bytes) {
  if (K <= 64) return {8, K > 32 ? 2 : 1, pass_warps(L)};
  if (K <= 128)
    return {16, 2, bytes == 8 ? pass_warps(L) : warps_per(L, L <= 64 ? 16 : 32)};
  return wide_pass_shape(L, K);
}

template <typename R, int G, int NVL>
int launch_estep_pass_warp(const R* betaT, const int* terms, const R* counts,
                           const R* doc_mask, const R* el_in, R* pc, int64_t B, int64_t L,
                           int64_t K, int w, int vec_in, cudaStream_t stream) {
  const PassLaunch pl = pass_launch<R>(B, G, NVL, w);
  lda_estep_pass_warp_kernel<R, G, NVL><<<pl.grid, pl.threads, pl.smem, stream>>>(
      betaT, terms, counts, doc_mask, el_in, pc, static_cast<int>(B), static_cast<int>(L),
      static_cast<int>(K), w, vec_in);
  return static_cast<int>(cudaGetLastError());
}

// The pass mode's launch: the warp mode for K <= 512 (lda_pass_shape),
// past it the block mode; vec_in: K a multiple of the elements in 16
// bytes (4 floats, 2 doubles) and betaT 16-byte aligned.
template <typename R>
int launch_estep_pass(const R* betaT, const int* terms, const R* counts, const R* doc_mask,
                      const R* el_in, R* pc, R* scratch, int64_t B, int64_t L, int64_t K,
                      int vec_in, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PassShape ps = lda_pass_shape(L, K, sizeof(R));
#define TMVB_LDA_PASS_WARP(G, NVL)                                                          \
  return launch_estep_pass_warp<R, G, NVL>(betaT, terms, counts, doc_mask, el_in, pc, B, L, \
                                           K, ps.w, vec_in, st)
  switch (ps.G * 8 + ps.NVL) {
    case 8 * 8 + 1:
      TMVB_LDA_PASS_WARP(8, 1);
    case 8 * 8 + 2:
      TMVB_LDA_PASS_WARP(8, 2);
    case 16 * 8 + 2:
      TMVB_LDA_PASS_WARP(16, 2);
    case 32 * 8 + 2:
      TMVB_LDA_PASS_WARP(32, 2);
    case 32 * 8 + 3:
      TMVB_LDA_PASS_WARP(32, 3);
    case 32 * 8 + 4:
      TMVB_LDA_PASS_WARP(32, 4);
    default:
      break;
  }
#undef TMVB_LDA_PASS_WARP
  EstepShape s;
  int rc = estep_shape<R>(L, K, &s);
  if (rc != 0) return fail(static_cast<cudaError_t>(rc));
  if (!s.meta_in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(lda_estep_pass_kernel<R>, s.bytes);
  if (err != cudaSuccess) return fail(err);
  lda_estep_pass_kernel<R><<<static_cast<unsigned>(B), kEstepThreads, s.bytes, st>>>(
      betaT, terms, counts, doc_mask, el_in, pc, scratch, static_cast<int>(L),
      static_cast<int>(K), s.tile, s.meta_in_smem, s.resident, vec_in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tmvb

extern "C" {

const char* tmvb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The warp mode's shape of lda_estep_pass on a document of L slots at K
// topics in elements of `bytes` (4 or 8): lanes a slot, vectors a lane
// and warps a document in out[0..2]; lanes 0 past the reach (the block
// mode runs).
void tmvb_lda_estep_pass_shape(int64_t L, int64_t K, int bytes, int* out) {
  const tmvb::PassShape s = tmvb::lda_pass_shape(L, K, bytes);
  out[0] = s.G;
  out[1] = s.NVL;
  out[2] = s.w;
}

// 1 when every row of a document of L slots stays in shared memory, 0
// when its rows go through in tiles, -1 when the device cannot be queried
// or K is too wide (the float32 mode; the float64 mode's launch shape is
// tmvb_lda_estep_double_shape).
int tmvb_lda_estep_rows_in_smem(int64_t L, int64_t K) {
  tmvb::EstepShape s;
  return tmvb::estep_shape<float>(L, K, &s) != 0 ? -1 : s.resident;
}

// Elements of device scratch a document needs: 3 L when its slot list
// does not fit shared memory, else 0; -1 on an error.
int64_t tmvb_lda_estep_scratch(int64_t L, int64_t K) {
  tmvb::EstepShape s;
  return tmvb::estep_shape<float>(L, K, &s) != 0 ? -1 : (s.meta_in_smem ? 0 : 3 * L);
}
int64_t tmvb_lda_estep_scratch_f64(int64_t L, int64_t K) {
  tmvb::LdaDoubleShape d;
  if (tmvb::lda_double_shape(L, K, &d) != 0) return -1;
  if (d.G > 0) return 0;   // the resident design keeps its slot list in shared memory
  tmvb::EstepShape s;
  return tmvb::estep_shape<double>(L, K, &s) != 0 ? -1 : (s.meta_in_smem ? 0 : 3 * L);
}

// The float64 mode's launch shape on a document of L slots at K topics:
// out[0] 1 for the resident design (lda_estep_res_kernel), 0 for
// lda_estep_kernel<double> with its rows in tiles, 2 for it with every row
// in shared memory (K > 512); out[1] lanes a slot (resident design) or the
// slots of a tile; out[2] blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); out[3] shared memory in
// bytes a block; out[4] topics a lane and out[5] slots a group takes at
// once (resident design), else 0.  Returns 0, or a CUDA error code.
int tmvb_lda_estep_double_shape(int64_t L, int64_t K, int* out) {
  tmvb::LdaDoubleShape d;
  int rc = tmvb::lda_double_shape(L, K, &d);
  if (rc != 0) return rc;
  int blocks = 0;
  cudaError_t err;
  if (d.G > 0) {
    const void* kernel = tmvb::lda_res_kernel(d.G, d.NV, d.D);
    err = tmvb::allow_smem(kernel, d.bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, tmvb::kEstepThreads,
                                                          d.bytes);
    out[0] = 1;
    out[1] = d.G;
    out[3] = static_cast<int>(d.bytes);
    out[4] = d.NV;
    out[5] = d.D;
  } else {
    tmvb::EstepShape s;
    rc = tmvb::estep_shape<double>(L, K, &s);
    if (rc != 0) return rc;
    err = tmvb::allow_smem(tmvb::lda_estep_kernel<double, false>, s.bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tmvb::lda_estep_kernel<double, false>, tmvb::kEstepThreads, s.bytes);
    out[0] = s.resident ? 2 : 0;
    out[1] = s.tile;
    out[3] = static_cast<int>(s.bytes);
    out[4] = 0;
    out[5] = 0;
  }
  out[2] = blocks;
  return err == cudaSuccess ? 0 : tmvb::fail(err);
}

}  // extern "C"

namespace tmvb {

// vec_in: K even and betaT 16-byte aligned (16-byte copies of two
// doubles); w's 16-byte stores where K is even and w aligned.
int launch_lda_res(const double* betaT, const int* terms, const double* counts,
                   const double* doc_mask, const double* alpha, const double* gamma_in,
                   const double* el_in, const double* elo_in, double* gamma_out, double* el_out,
                   double* elo_out, double* w, int64_t B, int64_t L, int64_t K, int viter,
                   double vtol, int vec_in, const LdaDoubleShape& d, cudaStream_t stream) {
  const void* kernel = lda_res_kernel(d.G, d.NV, d.D);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(kernel, d.bytes);
  if (err != cudaSuccess) return fail(err);
  int Li = static_cast<int>(L), Ki = static_cast<int>(K);
  double vtol2 = vtol * vtol;
  int vec_out = K % 2 == 0 && aligned16(w);
  void* args[] = {&betaT,     &terms,  &counts,  &doc_mask, &alpha, &gamma_in, &el_in,
                  &elo_in,    &gamma_out, &el_out, &elo_out, &w,     &Li,       &Ki,
                  &viter,     &vtol2,  &vec_in,  &vec_out};
  err = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(B)), dim3(kEstepThreads), args,
                         d.bytes, stream);
  if (err != cudaSuccess) return fail(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int launch_estep(const R* betaT, const int* terms, const R* counts, const R* doc_mask,
                 const R* alpha, const R* gamma_in, const R* el_in, const R* elo_in,
                 R* gamma_out, R* el_out, R* elo_out, R* w, R* scratch, int64_t B, int64_t L,
                 int64_t K, int viter, R vtol, int vec_in, int vec_out, int elog_f64,
                 void* stream) {
  if (B == 0) return 0;
  if constexpr (sizeof(R) == 8) {
    LdaDoubleShape d;
    const int rc = lda_double_shape(L, K, &d);
    if (rc != 0) return fail(static_cast<cudaError_t>(rc));
    if (d.G > 0)
      return launch_lda_res(betaT, terms, counts, doc_mask, alpha, gamma_in, el_in, elo_in,
                            gamma_out, el_out, elo_out, w, B, L, K, viter, vtol, vec_in, d,
                            static_cast<cudaStream_t>(stream));
  }
  EstepShape s;
  int rc = estep_shape<R>(L, K, &s);
  if (rc != 0) return fail(static_cast<cudaError_t>(rc));
  if (!s.meta_in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lda_estep_kernel<R, false>;
  if constexpr (sizeof(R) == 4)
    if (elog_f64) kernel = lda_estep_kernel<R, true>;
  cudaError_t err = allow_smem(kernel, s.bytes);
  if (err != cudaSuccess) return fail(err);
  kernel<<<static_cast<unsigned>(B), kEstepThreads, s.bytes, static_cast<cudaStream_t>(stream)>>>(
      betaT, terms, counts, doc_mask, alpha, gamma_in, el_in, elo_in, gamma_out, el_out,
      elo_out, w, scratch, static_cast<int>(L), static_cast<int>(K), s.tile, s.meta_in_smem,
      s.resident, viter, vtol * vtol, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tmvb

extern "C" {

int tmvb_lda_estep(const float* betaT, const int* terms, const float* counts,
                   const float* doc_mask, const float* alpha, const float* gamma_in,
                   const float* el_in, const float* elo_in, float* gamma_out,
                   float* el_out, float* elo_out, float* w, float* scratch,
                   int64_t B, int64_t L, int64_t K, int viter, float vtol, int vec_in,
                   int vec_out, int elog_f64, void* stream) {
  return tmvb::launch_estep(betaT, terms, counts, doc_mask, alpha, gamma_in, el_in, elo_in,
                            gamma_out, el_out, elo_out, w, scratch, B, L, K, viter, vtol,
                            vec_in, vec_out, elog_f64, stream);
}

// The float64 mode: every tensor double, vtol too (the stop test compares
// the double sum of d^2 with vtol^2 in double, as the plain version does);
// the f64 channel is the identity on a float64 state, so there is no
// elog_f64.  vec_in: K % 2 == 0 and betaT
// 16-byte aligned (16-byte copies of two doubles); vec_out: K % 4 == 0 and
// w 16-byte aligned (the resident design takes its 16-byte stores of w
// where K is even and w aligned).
int tmvb_lda_estep_f64(const double* betaT, const int* terms, const double* counts,
                       const double* doc_mask, const double* alpha, const double* gamma_in,
                       const double* el_in, const double* elo_in, double* gamma_out,
                       double* el_out, double* elo_out, double* w, double* scratch,
                       int64_t B, int64_t L, int64_t K, int viter, double vtol, int vec_in,
                       int vec_out, void* stream) {
  return tmvb::launch_estep(betaT, terms, counts, doc_mask, alpha, gamma_in, el_in, elo_in,
                            gamma_out, el_out, elo_out, w, scratch, B, L, K, viter, vtol,
                            vec_in, vec_out, 0, stream);
}

// The pass mode: pc [B, K] (see lda_estep_pass_kernel); scratch as for
// tmvb_lda_estep.
int tmvb_lda_estep_pass(const float* betaT, const int* terms, const float* counts,
                        const float* doc_mask, const float* el_in, float* pc, float* scratch,
                        int64_t B, int64_t L, int64_t K, int vec_in, void* stream) {
  return tmvb::launch_estep_pass(betaT, terms, counts, doc_mask, el_in, pc, scratch, B, L, K,
                                 vec_in, stream);
}

// The pass mode's float64 mode; scratch as for tmvb_lda_estep_f64.
int tmvb_lda_estep_pass_f64(const double* betaT, const int* terms, const double* counts,
                            const double* doc_mask, const double* el_in, double* pc,
                            double* scratch, int64_t B, int64_t L, int64_t K, int vec_in,
                            void* stream) {
  return tmvb::launch_estep_pass(betaT, terms, counts, doc_mask, el_in, pc, scratch, B, L, K,
                                 vec_in, stream);
}

}  // extern "C"
