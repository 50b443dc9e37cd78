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
// copied 16 bytes (two doubles) at a time where K is even.

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
// counts) and mslot (their slots); returns their number.  wcount: 8 ints
// of shared memory.  Every thread of the block must call it.
template <typename R>
__device__ __forceinline__ int compact_slots(const R* c, int L, R* mc, int* mslot,
                                             int* wcount) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int n = 0;
  for (int base = 0; base < L; base += kEstepThreads) {
    const int l = base + tid;
    const R cl = l < L ? c[l] : R(0);
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

// One pass of the fixpoint without its update: this rank's partial
// document statistic pc[b, k] = e_k * q_k, e = exp(El[b]), q as above
// over the document's own slots (their normaliser s_l over this rank's
// table), for the modes whose token slots are split over ranks (routed
// tensor parallelism, the sequence axis).  The caller sums pc over the
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

// The pass mode's launch; vec_in: K a multiple of the elements in 16
// bytes (4 floats, 2 doubles) and betaT 16-byte aligned.
template <typename R>
int launch_estep_pass(const R* betaT, const int* terms, const R* counts, const R* doc_mask,
                      const R* el_in, R* pc, R* scratch, int64_t B, int64_t L, int64_t K,
                      int vec_in, void* stream) {
  if (B == 0) return 0;
  EstepShape s;
  int rc = estep_shape<R>(L, K, &s);
  if (rc != 0) return fail(static_cast<cudaError_t>(rc));
  if (!s.meta_in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(lda_estep_pass_kernel<R>, s.bytes);
  if (err != cudaSuccess) return fail(err);
  lda_estep_pass_kernel<R><<<static_cast<unsigned>(B), kEstepThreads, s.bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      betaT, terms, counts, doc_mask, el_in, pc, scratch, static_cast<int>(L),
      static_cast<int>(K), s.tile, s.meta_in_smem, s.resident, vec_in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tmvb

extern "C" {

const char* tmvb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 1 when every row of a document of L slots stays in shared memory, 0
// when its rows go through in tiles, -1 when the device cannot be queried
// or K is too wide.
int tmvb_lda_estep_rows_in_smem(int64_t L, int64_t K) {
  tmvb::EstepShape s;
  return tmvb::estep_shape<float>(L, K, &s) != 0 ? -1 : s.resident;
}
int tmvb_lda_estep_rows_in_smem_f64(int64_t L, int64_t K) {
  tmvb::EstepShape s;
  return tmvb::estep_shape<double>(L, K, &s) != 0 ? -1 : s.resident;
}

// Elements of device scratch a document needs: 3 L when its slot list
// does not fit shared memory, else 0; -1 on an error.
int64_t tmvb_lda_estep_scratch(int64_t L, int64_t K) {
  tmvb::EstepShape s;
  return tmvb::estep_shape<float>(L, K, &s) != 0 ? -1 : (s.meta_in_smem ? 0 : 3 * L);
}
int64_t tmvb_lda_estep_scratch_f64(int64_t L, int64_t K) {
  tmvb::EstepShape s;
  return tmvb::estep_shape<double>(L, K, &s) != 0 ? -1 : (s.meta_in_smem ? 0 : 3 * L);
}

}  // extern "C"

namespace tmvb {

template <typename R>
int launch_estep(const R* betaT, const int* terms, const R* counts, const R* doc_mask,
                 const R* alpha, const R* gamma_in, const R* el_in, const R* elo_in,
                 R* gamma_out, R* el_out, R* elo_out, R* w, R* scratch, int64_t B, int64_t L,
                 int64_t K, int viter, R vtol, int vec_in, int vec_out, int elog_f64,
                 void* stream) {
  if (B == 0) return 0;
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
// w 16-byte aligned.
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
