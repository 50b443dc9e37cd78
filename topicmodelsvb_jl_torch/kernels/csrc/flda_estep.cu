// fLDA E-step: the per-document fixpoint of filtered LDA and its M-step rows.
//
// Replaces the TPU kernel `flda_estep` (topicmodelsvb_jl_tpu/kernels/
// flda_estep.py:112, body `_estep_kernel` :36).  For each document d with
// token slots l (term t_l, count c_l), lb = log(beta + eps)^T [V, K] and the
// background distribution kappa [V]:
//
//   repeat up to viter times:
//     p_lk     = exp(tau_l lb[t_l, k] + El_k - m)       (m: any shift)
//     s_l      = sum_k p_lk
//     tau_new  = eta / (eta + (1 - eta) kappa[t_l] exp(-sum_k p_lk lb[t_l, k] / s_l) + eps)
//     gamma    = alpha + sum_l p_lk c_l / s_l + eps
//     El       = psi(gamma) - psi(sum gamma)          (El_old takes the old El)
//     tau      = tau_new                               (tau_old takes the old tau)
//     stop once |El - El_old|^2 < vtol^2               (the break at fLDA.jl:206)
//   w[l, :K] = p_l(tau_old, El_old) * (tau_l c_l / s_l)   (beta statistic)
//   w[l, K]  = (1 - tau_l) c_l                            (kappa statistic)
//
// tau is updated on every slot of a real document, padding slots included,
// as the TPU kernel does: it is part of the state the two packages compare.
//
// What bounds it on an H100.  Bytes: at the widest NSF chunk (B = 1024,
// L = 128, K = 100) it must read ~10 MB of table rows, ~2.6 MB of terms,
// counts and tau, 1.2 MB of state, and write 53 MB of w and ~2.2 MB of tau
// and state: ~68 MB, ~20 us at 3.35 TB/s.  Exps: unlike LDA, phi cannot be
// formed multiplicatively, because tau rescales log beta per token on
// every pass, so a pass costs one exp per (slot, topic), padding slots
// included: 10 passes x 1024 x 128 x 100 = 1.3e8 ex2 at the widest chunk,
// ~31 us at 16 ex2 a clock per SM (132 SMs, 1.98 GHz).  Beside each ex2 a
// pass spends ~6 more f32 instructions per element (the FFMA of the
// exponent, the sums, the gamma product), so the floor is ~35-45 us.
//
// Design (256 threads, one document per block; the layout of
// lda_estep.cu):
// - The slots are compacted into a list: those with c_l != 0 first, in
//   slot order, then the padding slots, which need tau but add nothing to
//   gamma or w.  Per compact slot the list holds c, c / s, (1 - eta)
//   kappa[t], the slot and three tau buffers (tau_old, tau, the next tau),
//   rotated by pointer each pass; tau and tau_old go back to device
//   memory once, at the end.  Nothing is read from device memory inside a
//   pass when the rows fit.
// - Rows are copied with cp.async through L1 (.ca): the padding slots all
//   name one id, and around L1 (.cg) every block of every SM asked one L2
//   slice for that row on every pass: at L = 1024 a pass took 518 us a
//   chunk that way, 205 us through L1.  The stride is 2 x an odd number
//   of float4s (104 floats at K = 100), so the 2 threads a slot of a
//   16-byte shared load hit 32 different banks.
// - Base-2 exps: the exponent is fma(tau log2(e), lb, e) with
//   e_k = (El_k - m) log2(e), so each element costs one FFMA and one
//   ex2.approx.  The shift m is max_k El_k of the document, not a max per
//   slot: tau lb <= 0 (lb = log(beta + eps) <= 0, tau in (0, 1]), so every
//   exponent is <= 0 (no overflow) and the argmax topic's term is >=
//   e^{log eps} = eps ~ 1.6e-30 > 0 (s > 0); what flushes to zero is below
//   1e-8 of s.  max_k El_new = psi(max gamma) - psi(sum gamma), so the
//   shift comes out of the sum-gamma barrier (a max beside the sum) and
//   costs no barrier of its own.
// - Per slot: threads over slots, 2 threads a slot (their float4s of
//   topics interleaved, two shuffles to add s and sum p lb), e broadcast
//   from shared memory; c / s and tau_new are then thread-local.
// - p of the pass is kept in a second [L, Kp] buffer (2 blocks an SM), so
//   the gamma product reads it instead of taking every exp again, and the
//   statistics are written from the last pass's p and c / s, which are
//   phi(tau_old, El_old); only a document that ran no pass (viter 0, or
//   masked), or whose rows go through in tiles, computes them anew.
// - gamma product: threads over (float4 of topics, share of slots), the
//   shares added in share order by each topic's thread; psi(gamma_k)
//   before the barrier of the sum, psi(sum gamma) after it, by the
//   topics' threads.  Four barriers a pass; every sum in one fixed order:
//   same inputs, same bits.
// - A document whose rows do not fit (L = 1024 at K = 100) goes through
//   shared memory in tiles of compact slots, re-read from the table (10 MB
//   at NSF scale, resident in the 50 MB L2) on every pass.  Its slot list
//   stays in shared memory when it fits there, else in a [B, 7 L] scratch.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/kernel_ab.py and
// tools/estep_sweep.py, in turns):
// 208 us at the widest NSF chunk and 2.44 ms at L = 1024 (viter 10; the
// previous design, a warp a slot and 128 threads, took 1.16 and 6.66 ms).  A pass costs ~14.7 us a chunk at L = 128:
// not the exps (a copy without them was as fast), psi about a sixth of it.
// Dropped, each as fast or slower: 1 or 4 threads a slot, p taken anew in
// the gamma product instead of kept (3 blocks an SM), lda_estep.cu's
// odd-float4 stride (226 us), rows around L1 (235 us; 5.61 ms at L = 1024).
//
// One block per document, which leaves its loop when its own document
// converges; K is not padded beyond the stride, whose columns are zero
// rows and e = -inf (p = 0 there).
//
// The f64 Elogtheta channel (template flag kF64; RuntimeConfig.
// elogtheta_f64, as the JAX package's models/flda.py:106-112 computes it on
// its XLA path): gamma in f32 as above, then sum gamma and both psi in
// double (digamma_series64) and El_new cast back to f32; the exps, tau and
// w stay f32.  The next pass's shift is psi(max gamma) - psi(sum gamma)
// (psi is increasing), so the first loop takes max gamma beside the
// double sum and psi(gamma_k) is taken once, after the barrier, by each
// topic's thread.  The double sum uses `red`'s first 16 floats and the max
// floats 32-39 (the compaction counts, done by then), so the d^2 sum keeps
// floats 16-23.  kF64 = false is the f32 mode's code as it was, bit for bit.
//
// The float64 mode (R = double; tmvb_flda_estep_f64): the same kernel on a
// float64 state, every input, output and sum in double; 2^x is the double
// exp2 (the f64 pipe has no ex2.approx), psi the shift-by-8 series in
// double.  Bound: bytes doubled (~136 MB at the widest NSF chunk, ~41 us)
// against the exps, which now run as instruction sequences on the FP64
// pipe (~20 operations each at 33.5 TFLOP/s: ~80 us for 1.3e8 of them).
// Every shared-memory size is in 8-byte elements: the widest NSF document
// no longer stays resident (rows and p take 213 KB) and goes through
// tiles of 58 slots with 2 blocks an SM, re-reading the 20 MB float64
// table from L2 every pass; the widest K halves (~3,600 at L = 4).
//
// The pass mode (flda_estep_pass_kernel), for the sequence axis, where a
// document's token slots are split over ranks: one pass of the fixpoint
// without its update, this rank's partial gamma statistic pc = sum_l p_l
// c_l / s_l [B, K] and tau_new [B, L], from the block, slot list, rows and
// per-slot pass above.  The caller sums pc over the ranks and updates
// gamma, psi, the masks and tau on the [B, K] and [B, L] tiles; the last
// rows come from this kernel at viter = 0.  It reads the same rows and
// takes the same exps as a pass here, and writes pc and tau_new in place
// of the state: ~B (L + K) floats more than a pass inside the fixpoint,
// and one launch a pass.  Its float64 mode (tmvb_flda_estep_pass_f64) is
// the same pass on a float64 state, as the full kernel's, for the
// sequence axis in float64.

#include <algorithm>

#include "rows.cuh"

namespace tmvb {

constexpr int kFThreads = 256;
constexpr int kFWarps = kFThreads / 32;
constexpr int kFMaxShares = 8;
constexpr int kTps = 2;             // threads a slot in the per-slot pass
constexpr int kFMeta = 7;           // per-slot arrays of the slot list
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// The float64 mode's 2^x: the double exp2 (no approximation).
__device__ __forceinline__ double ex2(double x) { return exp2(x); }

// Max of v over the block with one barrier, as block_sum_once.
template <typename R>
__device__ __forceinline__ R block_max_once(R v, R* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  R m = -INFINITY;
#pragma unroll
  for (int w = 0; w < kFWarps; ++w) m = Real<R>::max(m, red[w]);
  return m;
}

// Row stride in floats: a number of float4s that is kTps times an odd
// number, so the 8 threads of a 16-byte shared load (8 / kTps slots, kTps
// neighbouring float4s each) hit 32 different banks.
__host__ __device__ inline int flda_stride(int K) {
  const int s = ((K + 3) / 4 + kTps - 1) / kTps;
  return 4 * kTps * (s | 1);
}

__host__ __device__ inline int flda_shares(int Kp) {
  const int g = Kp / 4;
  return g >= kFThreads ? 1 : (kFThreads / g < kFMaxShares ? kFThreads / g : kFMaxShares);
}

// Shared memory in elements of R (float, or double in the float64 mode):
// rows and p [tile, Kp] each, e twice [Kp], gamma partials [shares, Kp],
// gamma/El/El_old [K rounded to 4] each, 64 for the sums and the
// compaction, then the slot list [7, L] when it is kept there.
template <typename R>
__host__ __device__ inline size_t flda_smem(int64_t L, int K, int64_t tile, bool meta) {
  const int Kp = flda_stride(K);
  const size_t base = (2 + flda_shares(Kp)) * static_cast<size_t>(Kp) + 3 * ((K + 3) / 4 * 4) + 64;
  return (2 * static_cast<size_t>(tile) * Kp + base + (meta ? kFMeta * L : 0)) * sizeof(R);
}

struct FldaShape {
  int tile;          // compact slots whose rows are in shared memory at once
  int meta_in_smem;  // the slot list in shared memory (else device scratch)
  int resident;      // every slot fits: rows loaded once, no tiles
  size_t bytes;
};

// 0, or a CUDA error code when the device cannot be queried or K is too
// wide for one row in shared memory.  All rows stay in shared memory when
// that leaves room for 2 blocks an SM; else tiles, with the slot list and
// at least 32 rows sized for 4 blocks an SM (an SM's 228 KB less 1 KB the
// device keeps per block), or 2, or 1; else the slot list in device
// scratch and tiles of what fits.  In the float64 mode (R = double) every
// element takes 8 bytes: the widest NSF document (L = 128, K = 100) goes
// through tiles, and the widest K halves.
template <typename R>
inline int flda_shape(int64_t L, int64_t K, FldaShape* s) {
  const int optin = smem_optin();
  if (optin < 0) return query_error();
  const int k = static_cast<int>(K);
  const size_t full = flda_smem<R>(L, k, L, true);
  if (full <= static_cast<size_t>(optin) / 2) {
    *s = {static_cast<int>(L), 1, 1, full};
    return 0;
  }
  const size_t row = 2 * flda_stride(k) * sizeof(R);
  const size_t o = static_cast<size_t>(optin);
  for (size_t budget : {o / 4 - 1024, o / 2 - 1024, o}) {
    if (flda_smem<R>(L, k, std::min<int64_t>(L, 32), true) > budget) continue;
    const int64_t tile = std::min<int64_t>(L, (budget - flda_smem<R>(L, k, 0, true)) / row);
    *s = {static_cast<int>(tile), 1, 0, flda_smem<R>(L, k, tile, true)};
    return 0;
  }
  const size_t base = flda_smem<R>(L, k, 0, false);
  if (base + row > o) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tile = std::min<int64_t>(L, (o - base) / row);
  *s = {static_cast<int>(tile), 0, 0, flda_smem<R>(L, k, tile, false)};
  return 0;
}

// The per-slot pass over compact slots j0 .. j0 + m - 1 (rows[0 .. m)):
// p = 2^(tau log2(e) lb + e), s and sum p lb with kTps threads a slot;
// writes c / s to mcs and, when `tn` is given, tau_new to tn; stores p to
// pb for the slots below `nkeep`.
template <typename R>
__device__ __forceinline__ void slot_pass(const R* rows, R* pb, int m, int j0, int nkeep,
                                          const R* e, const R* tau, R* tn, const R* mc, R* mcs,
                                          const R* mkap, R eta, int Kp) {
  using V4 = typename Real<R>::V4;
  const int G = Kp / 4;
  const int sub = threadIdx.x % kTps;
  const V4* e4 = reinterpret_cast<const V4*>(e);
  for (int base = 0; base < m; base += kFThreads / kTps) {
    const int i = base + threadIdx.x / kTps;
    const int j = j0 + i;
    V4 s4 = Real<R>::zero4(), l4 = s4;
    if (i < m) {
      const R t2 = tau[j] * Real<R>::log2e;
      const V4* r4 = reinterpret_cast<const V4*>(rows + static_cast<size_t>(i) * Kp);
      V4* p4 = j < nkeep ? reinterpret_cast<V4*>(pb + static_cast<size_t>(i) * Kp) : nullptr;
#pragma unroll 4
      for (int g = sub; g < G; g += kTps) {
        const V4 x = r4[g], y = e4[g];
        V4 p;
        p.x = ex2(Real<R>::fma(t2, x.x, y.x));
        p.y = ex2(Real<R>::fma(t2, x.y, y.y));
        p.z = ex2(Real<R>::fma(t2, x.z, y.z));
        p.w = ex2(Real<R>::fma(t2, x.w, y.w));
        s4.x += p.x;
        s4.y += p.y;
        s4.z += p.z;
        s4.w += p.w;
        l4.x = Real<R>::fma(p.x, x.x, l4.x);
        l4.y = Real<R>::fma(p.y, x.y, l4.y);
        l4.z = Real<R>::fma(p.z, x.z, l4.z);
        l4.w = Real<R>::fma(p.w, x.w, l4.w);
        if (p4 != nullptr) p4[g] = p;
      }
    }
    R s = (s4.x + s4.y) + (s4.z + s4.w);
    R sl = (l4.x + l4.y) + (l4.z + l4.w);
#pragma unroll
    for (int o = 1; o < kTps; o <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      sl += __shfl_xor_sync(0xffffffffu, sl, o);
    }
    if (i < m && sub == 0) {
      mcs[j] = mc[j] / s;
      // update_tau! (fLDA.jl:195-200): exp(-sum p lb / s) as a base-2 exp
      if (tn != nullptr) tn[j] = eta / (eta + mkap[j] * ex2(-(sl / s) * Real<R>::log2e) + Real<R>::eps);
    }
  }
}

// gamma partials: qpart[h, k] (+)= sum over compact slots i = h, h + nsh,
// ... < m of (c / s)_i p_ik; thread (h, g) owns the float4 g of share h.
template <typename R>
__device__ __forceinline__ void q_pass(const R* pb, int m, int j0, const R* mcs, R* qpart,
                                       int Kp, int nsh, bool first) {
  using V4 = typename Real<R>::V4;
  const int G = Kp / 4;
  const V4* src = reinterpret_cast<const V4*>(pb);
  V4* q4 = reinterpret_cast<V4*>(qpart);
  for (int o = threadIdx.x; o < nsh * G; o += kFThreads) {
    const int h = o / G, g = o - h * G;
    V4 q = first ? Real<R>::zero4() : q4[o];
#pragma unroll 4
    for (int i = h; i < m; i += nsh) {
      const R r = mcs[j0 + i];
      const V4 x = src[static_cast<size_t>(i) * G + g];
      q.x = Real<R>::fma(r, x.x, q.x);
      q.y = Real<R>::fma(r, x.y, q.y);
      q.z = Real<R>::fma(r, x.z, q.z);
      q.w = Real<R>::fma(r, x.w, q.w);
    }
    q4[o] = q;
  }
}

// w rows of compact slots j0 .. j0 + m - 1: p * (tau c / s) in columns
// 0 .. K - 1 and (1 - tau) c in column K; zeros when `zero`.  Threads over
// the flattened (slot, column) so that neighbours store neighbours.
template <typename R>
__device__ __forceinline__ void write_w(R* __restrict__ wd, const R* pb, int m, int j0,
                                        const R* tcur, const R* mc, const R* mcs,
                                        const int* mslot, int K, int Kp, bool zero) {
  const int K1 = K + 1;
  const int di = kFThreads / K1, dk = kFThreads - di * K1;
  int i = threadIdx.x / K1, k = threadIdx.x - i * K1;
  while (i < m) {
    const int j = j0 + i;
    R v = 0;
    if (!zero) {
      if (k < K)
        v = pb[static_cast<size_t>(i) * Kp + k] * (tcur[j] * mcs[j]);
      else
        v = (R(1) - tcur[j]) * mc[j];
    }
    wd[static_cast<size_t>(mslot[j]) * K1 + k] = v;
    i += di;
    k += dk;
    if (k >= K1) {
      k -= K1;
      ++i;
    }
  }
}

// Compacts a document's L slots into its slot list: those with c_l != 0
// from the front in slot order, the padding slots from the back (their
// order adds to no sum), each with its count, its slot, (1 - eta)
// kappa[t_l] and its tau (with kOld, its tau_old too).  Returns the number
// with a count.  wcount: 16 ints of shared memory.  Every thread of the
// block must call it.
template <bool kOld, typename R>
__device__ __forceinline__ int flda_compact(const R* c, const int* t, int L,
                                            const R* __restrict__ kappa, R one_m_eta,
                                            const R* tau, const R* tauo, R* mc, int* mslot,
                                            R* mkap, R* tcur, R* told, int* wcount) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int n = 0, npad = 0;
  for (int base = 0; base < L; base += kFThreads) {
    const int l = base + tid;
    const bool in = l < L;
    const R cl = in ? c[l] : R(0);
    const unsigned real = __ballot_sync(0xffffffffu, in && cl != R(0));
    const unsigned pad = __ballot_sync(0xffffffffu, in && cl == R(0));
    if (lane == 0) {
      wcount[warp] = __popc(real);
      wcount[kFWarps + warp] = __popc(pad);
    }
    __syncthreads();
    int offr = n, offp = npad, totr = n, totp = npad;
#pragma unroll
    for (int i = 0; i < kFWarps; ++i) {
      offr += i < warp ? wcount[i] : 0;
      offp += i < warp ? wcount[kFWarps + i] : 0;
      totr += wcount[i];
      totp += wcount[kFWarps + i];
    }
    if (in) {
      const unsigned below = (1u << lane) - 1u;
      const int j = cl != R(0) ? offr + __popc(real & below) : L - 1 - (offp + __popc(pad & below));
      mc[j] = cl;
      mslot[j] = l;
      mkap[j] = one_m_eta * kappa[t[l]];
      tcur[j] = tau[l];
      if (kOld) told[j] = tauo[l];
    }
    n = totr;
    npad = totp;
    __syncthreads();  // the list is complete; wcount may be rewritten
  }
  return n;
}

// R = float: the float32 mode, and with kF64 its f64 Elogtheta channel.
// R = double: the float64 mode, every input, output and sum in double,
// 2^x the double exp2, psi the same series in double; the channel is the
// identity there.
template <typename R, bool kF64>
__global__ void __launch_bounds__(kFThreads, 2) flda_estep_kernel(
    const R* __restrict__ logbetaT,  // [V, K] log(beta + eps)^T
    const R* __restrict__ kappa,     // [V]
    const int* __restrict__ terms,   // [B, L]
    const R* __restrict__ counts,    // [B, L], 0 on padding
    const R* __restrict__ doc_mask,  // [B]
    const R* __restrict__ alpha,     // [K]
    const R* __restrict__ eta_p,     // [] eta
    const R* __restrict__ gamma_in,  // [B, K]
    const R* __restrict__ el_in,     // [B, K]
    const R* __restrict__ elo_in,    // [B, K]
    const R* __restrict__ tau_in,    // [B, L]
    const R* __restrict__ tauo_in,   // [B, L]
    R* __restrict__ gamma_out, R* __restrict__ el_out,
    R* __restrict__ elo_out, R* __restrict__ tau_out,  // [B, L]
    R* __restrict__ tauo_out,        // [B, L]
    R* __restrict__ w,               // [B, L, K + 1]
    R* scratch,                      // [B, 7 L], the slot lists when not in smem
    int L, int K, int tile, int meta_in_smem, int resident, int viter, R vtol2,
    int vec_in) {
  static_assert(!kF64 || sizeof(R) == 4, "the f64 Elogtheta channel is a float32 mode");
  extern __shared__ __align__(16) unsigned char flda_smem_raw[];
  R* smem = reinterpret_cast<R*>(flda_smem_raw);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Kp = flda_stride(K), nsh = flda_shares(Kp), K4 = (K + 3) / 4 * 4;
  R* rows = smem;
  R* pbuf = rows + static_cast<size_t>(tile) * Kp;   // p [tile, Kp]
  R* e_cur = pbuf + static_cast<size_t>(tile) * Kp;
  R* e_nxt = e_cur + Kp;
  R* qpart = e_nxt + Kp;
  R* gam = qpart + nsh * Kp;
  R* el = gam + K4;
  R* elo = el + K4;
  // [64]: sum gamma [8], max psi [8], sum d^2 [8], max El [8], compaction [16]
  R* red = elo + K4;
  R* meta = meta_in_smem ? red + 64 : scratch + static_cast<size_t>(b) * kFMeta * L;
  R* mc = meta;                                    // count of compact slot j
  R* mcs = meta + L;                               // its c / s
  R* mkap = meta + 2 * L;                          // its (1 - eta) kappa[t]
  int* mslot = reinterpret_cast<int*>(meta + 3 * L);   // its slot
  R* told = meta + 4 * L;                          // tau_old, tau, the next tau
  R* tcur = meta + 5 * L;
  R* tnxt = meta + 6 * L;
  const size_t dl = static_cast<size_t>(b) * L;
  const int* t = terms + dl;
  const R* c = counts + dl;
  const size_t dk = static_cast<size_t>(b) * K;
  const R eta = *eta_p;
  const R one_m_eta = R(1) - eta;

  // the slots with a count from the front in slot order, the padding slots
  // from the back (their order adds to no sum)
  const int n = flda_compact<true, R>(c, t, L, kappa, one_m_eta, tau_in + dl, tauo_in + dl, mc,
                                      mslot, mkap, tcur, told, reinterpret_cast<int*>(red + 32));

  const bool vin = vec_in != 0;
  if (resident) load_rows<kFThreads, true>(rows, logbetaT, t, mslot, 0, L, K, Kp, vin);
  // e = (El - max El) log2(e), -inf on the stride's padding columns
  R mx = -INFINITY;
  for (int k = tid; k < K; k += kFThreads) {
    gam[k] = gamma_in[dk + k];
    const R x = el_in[dk + k];
    el[k] = x;
    elo[k] = elo_in[dk + k];
    mx = Real<R>::max(mx, x);
  }
  mx = block_max_once(mx, red + 24);
  for (int k = tid; k < Kp; k += kFThreads) {
    e_cur[k] = k < K ? (el[k] - mx) * Real<R>::log2e : R(-INFINITY);
    e_nxt[k] = k < K ? R(0) : R(-INFINITY);
  }
  cp_async_wait_all();
  __syncthreads();

  bool active = doc_mask[b] > R(0);
  int it = 0;
  R* e_last = e_cur;
  for (; it < viter && active; ++it) {
    for (int j0 = 0; j0 < L; j0 += tile) {
      const int m = min(tile, L - j0);
      if (!resident) {
        load_rows<kFThreads, true>(rows, logbetaT, t, mslot, j0, m, K, Kp, vin);
        cp_async_wait_all();
        __syncthreads();
      }
      slot_pass<R>(rows, pbuf, m, j0, n, e_cur, tcur, tnxt, mc, mcs, mkap, eta, Kp);
      __syncthreads();
      if (j0 < n) {
        q_pass<R>(pbuf, min(m, n - j0), j0, mcs, qpart, Kp, nsh, j0 == 0);
        __syncthreads();
      }
    }
    if constexpr (kF64) {
      // update_gamma! in f32 into gam; the double sum of gamma and its max
      double gpart = 0.0;
      float gmax = -INFINITY;
      for (int k = tid; k < K; k += kFThreads) {
        float q = 0.f;
        if (n > 0)
          for (int h = 0; h < nsh; ++h) q += qpart[h * Kp + k];
        const float g = alpha[k] + q + kEps;
        gam[k] = g;
        gpart += static_cast<double>(g);
        gmax = fmaxf(gmax, g);
      }
      double* red64 = reinterpret_cast<double*>(red);
      gpart = warp_sum(gpart);
      gmax = warp_max(gmax);
      if (lane == 0) {
        red64[warp] = gpart;
        red[32 + warp] = gmax;
      }
      __syncthreads();
      double g_sum = 0.0;
      float g_max = -INFINITY;
#pragma unroll
      for (int v = 0; v < kFWarps; ++v) {
        g_sum += red64[v];
        g_max = fmaxf(g_max, red[32 + v]);
      }
      // update_Elogtheta! in double, cast back; the next e shifted by
      // psi(max gamma) - psi(sum gamma) = max El_new
      float dpart = 0.f;
      if (tid < K) {
        const double dg_sum = digamma_series64(g_sum);
        const double p_max = digamma_series64(static_cast<double>(g_max));
        for (int k = tid; k < K; k += kFThreads) {
          const double ps = digamma_series64(static_cast<double>(gam[k]));
          const float el_new = static_cast<float>(ps - dg_sum);
          const float d = el_new - el[k];
          dpart += d * d;
          elo[k] = el[k];
          el[k] = el_new;
          e_nxt[k] = static_cast<float>(ps - p_max) * kLog2e;
        }
      }
      active = block_sum_once<kFWarps>(dpart, red + 16) >= vtol2;
    } else {
      // update_gamma! (fLDA.jl:188-191) into gam, psi(gamma) into e_nxt,
      // before the barrier of the sum and the max
      R gpart = 0, pmax = -INFINITY;
      for (int k = tid; k < K; k += kFThreads) {
        R q = 0;
        if (n > 0)
          for (int h = 0; h < nsh; ++h) q += qpart[h * Kp + k];
        const R g = alpha[k] + q + Real<R>::eps;
        gam[k] = g;
        const R ps = digamma_series(g);
        e_nxt[k] = ps;
        gpart += g;
        pmax = Real<R>::max(pmax, ps);
      }
      R g_sum, p_max;
      {
        gpart = warp_sum(gpart);
        pmax = warp_max(pmax);
        if (lane == 0) {
          red[warp] = gpart;
          red[8 + warp] = pmax;
        }
        __syncthreads();
        g_sum = 0;
        p_max = -INFINITY;
#pragma unroll
        for (int v = 0; v < kFWarps; ++v) {
          g_sum += red[v];
          p_max = Real<R>::max(p_max, red[8 + v]);
        }
      }
      // update_Elogtheta! (fLDA.jl:181-184); the next e shifted by
      // max El_new = psi(max gamma) - psi(sum gamma)
      R dpart = 0;
      if (tid < K) {
        const R dg_sum = digamma_series(g_sum);
        for (int k = tid; k < K; k += kFThreads) {
          const R ps = e_nxt[k];
          const R el_new = ps - dg_sum;
          const R d = el_new - el[k];
          dpart += d * d;
          elo[k] = el[k];
          el[k] = el_new;
          e_nxt[k] = (ps - p_max) * Real<R>::log2e;
        }
      }
      active = block_sum_once<kFWarps>(dpart, red + 16) >= vtol2;
    }
    e_last = e_cur;
    e_cur = e_nxt;
    e_nxt = e_last;
    R* tr = told;
    told = tcur;
    tcur = tnxt;
    tnxt = tr;
  }

  // statistics from phi(tau_old, El_old) (fLDA.jl:160-177): the last
  // pass's p and c / s, or, when no pass ran, anew from the given state
  const bool ran = it > 0;
  if (!ran) {
    R mo = -INFINITY;
    for (int k = tid; k < K; k += kFThreads) mo = Real<R>::max(mo, elo[k]);
    mo = block_max_once(mo, red + 24);
    for (int k = tid; k < K; k += kFThreads) e_cur[k] = (elo[k] - mo) * Real<R>::log2e;
    e_last = e_cur;
    __syncthreads();
  }
  for (int k = tid; k < K; k += kFThreads) {
    gamma_out[dk + k] = gam[k];
    el_out[dk + k] = el[k];
    elo_out[dk + k] = elo[k];
  }
  for (int j = tid; j < L; j += kFThreads) {
    tau_out[dl + mslot[j]] = tcur[j];
    tauo_out[dl + mslot[j]] = told[j];
  }
  R* wd = w + dl * (K + 1);
  // p and c / s anew where the last pass's are not at hand
  const bool again = !ran || !resident;
  for (int j0 = 0; j0 < n; j0 += tile) {
    const int m = min(tile, n - j0);
    if (!resident) {
      load_rows<kFThreads, true>(rows, logbetaT, t, mslot, j0, m, K, Kp, vin);
      cp_async_wait_all();
      __syncthreads();
    }
    if (again) {
      slot_pass<R>(rows, pbuf, m, j0, n, e_last, told, nullptr, mc, mcs, mkap, eta, Kp);
      __syncthreads();
    }
    write_w<R>(wd, pbuf, m, j0, tcur, mc, mcs, mslot, K, Kp, false);
    if (!resident) __syncthreads();  // before the next tile's rows land
  }
  write_w<R>(wd, pbuf, L - n, n, tcur, mc, mcs, mslot, K, Kp, true);
}

// One pass of the fixpoint without its update, for the sequence axis:
// this rank's partial pc[b, k] = sum_l p_lk c_l / s_l over the document's
// own slots, p from (tau, El) as above, and tau_new [B, L] on every slot,
// padding slots included, as flda_estep_kernel updates them.  The caller
// sums pc over the ranks that hold the document's other slots and runs
// gamma, psi, the masks and the stop test on the [B, K] tiles between
// passes.  Same block, shared-memory layout, slot list, rows, shift and
// products as flda_estep_kernel; a document with doc_mask 0 gets pc = 0
// and tau_new = tau and reads nothing else.  One fixed order for every
// sum: same inputs, same bits.  R = double is its float64 mode, every
// input, output and sum in double, 2^x the double exp2.
template <typename R>
__global__ void __launch_bounds__(kFThreads, 2) flda_estep_pass_kernel(
    const R* __restrict__ logbetaT,  // [V, K] log(beta + eps)^T
    const R* __restrict__ kappa,     // [V]
    const int* __restrict__ terms,   // [B, L]
    const R* __restrict__ counts,    // [B, L], 0 on padding
    const R* __restrict__ doc_mask,  // [B]
    const R* __restrict__ eta_p,     // [] eta
    const R* __restrict__ el_in,     // [B, K]
    const R* __restrict__ tau_in,    // [B, L]
    R* __restrict__ pc,              // [B, K]
    R* __restrict__ tau_out,         // [B, L]
    R* scratch,                      // [B, 7 L], the slot lists when not in smem
    int L, int K, int tile, int meta_in_smem, int resident, int vec_in) {
  extern __shared__ __align__(16) unsigned char flda_smem_raw[];
  R* smem = reinterpret_cast<R*>(flda_smem_raw);
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t dl = static_cast<size_t>(b) * L, dk = static_cast<size_t>(b) * K;
  if (!(doc_mask[b] > R(0))) {
    for (int k = tid; k < K; k += kFThreads) pc[dk + k] = R(0);
    for (int l = tid; l < L; l += kFThreads) tau_out[dl + l] = tau_in[dl + l];
    return;
  }
  const int Kp = flda_stride(K), nsh = flda_shares(Kp), K4 = (K + 3) / 4 * 4;
  R* rows = smem;
  R* pbuf = rows + static_cast<size_t>(tile) * Kp;
  R* e = pbuf + static_cast<size_t>(tile) * Kp;
  R* qpart = e + 2 * Kp;
  R* red = qpart + nsh * Kp + 3 * K4;
  R* meta = meta_in_smem ? red + 64 : scratch + static_cast<size_t>(b) * kFMeta * L;
  R* mc = meta;
  R* mcs = meta + L;
  R* mkap = meta + 2 * L;
  int* mslot = reinterpret_cast<int*>(meta + 3 * L);
  R* tcur = meta + 5 * L;
  R* tnxt = meta + 6 * L;
  const int* t = terms + dl;
  const R eta = *eta_p;

  const int n = flda_compact<false, R>(counts + dl, t, L, kappa, R(1) - eta, tau_in + dl,
                                       static_cast<const R*>(nullptr), mc, mslot, mkap, tcur,
                                       static_cast<R*>(nullptr), reinterpret_cast<int*>(red + 32));
  const bool vin = vec_in != 0;
  if (resident) load_rows<kFThreads, true>(rows, logbetaT, t, mslot, 0, L, K, Kp, vin);
  // e = (El - max El) log2(e), -inf on the stride's padding columns
  R mx = -INFINITY;
  for (int k = tid; k < K; k += kFThreads) mx = Real<R>::max(mx, el_in[dk + k]);
  mx = block_max_once(mx, red + 24);
  for (int k = tid; k < Kp; k += kFThreads)
    e[k] = k < K ? (el_in[dk + k] - mx) * Real<R>::log2e : R(-INFINITY);
  cp_async_wait_all();
  __syncthreads();
  for (int j0 = 0; j0 < L; j0 += tile) {
    const int m = min(tile, L - j0);
    if (!resident) {
      load_rows<kFThreads, true>(rows, logbetaT, t, mslot, j0, m, K, Kp, vin);
      cp_async_wait_all();
      __syncthreads();
    }
    slot_pass<R>(rows, pbuf, m, j0, n, e, tcur, tnxt, mc, mcs, mkap, eta, Kp);
    __syncthreads();
    if (j0 < n) {
      q_pass<R>(pbuf, min(m, n - j0), j0, mcs, qpart, Kp, nsh, j0 == 0);
      __syncthreads();
    }
  }
  for (int k = tid; k < K; k += kFThreads) {
    R q = R(0);
    if (n > 0)
      for (int h = 0; h < nsh; ++h) q += qpart[h * Kp + k];
    pc[dk + k] = q;
  }
  for (int j = tid; j < L; j += kFThreads) tau_out[dl + mslot[j]] = tnxt[j];
}

// The pass mode's launch; vec_in: K a multiple of the elements in 16
// bytes (4 floats, 2 doubles) and logbetaT 16-byte aligned.
template <typename R>
int launch_flda_pass(const R* logbetaT, const R* kappa, const int* terms, const R* counts,
                     const R* doc_mask, const R* eta, const R* el_in, const R* tau_in, R* pc,
                     R* tau_out, R* scratch, int64_t B, int64_t L, int64_t K, int vec_in,
                     void* stream) {
  if (B == 0) return 0;
  FldaShape s;
  const int rc = flda_shape<R>(L, K, &s);
  if (rc != 0) return fail(static_cast<cudaError_t>(rc));
  if (!s.meta_in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(flda_estep_pass_kernel<R>, s.bytes);
  if (err != cudaSuccess) return fail(err);
  flda_estep_pass_kernel<R><<<static_cast<unsigned>(B), kFThreads, s.bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      logbetaT, kappa, terms, counts, doc_mask, eta, el_in, tau_in, pc, tau_out, scratch,
      static_cast<int>(L), static_cast<int>(K), s.tile, s.meta_in_smem, s.resident, vec_in);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int launch_flda(const R* logbetaT, const R* kappa, const int* terms, const R* counts,
                const R* doc_mask, const R* alpha, const R* eta, const R* gamma_in,
                const R* el_in, const R* elo_in, const R* tau_in, const R* tauo_in,
                R* gamma_out, R* el_out, R* elo_out, R* tau_out, R* tauo_out, R* w,
                R* scratch, int64_t B, int64_t L, int64_t K, int viter, R vtol, int vec_in,
                int elog_f64, void* stream) {
  if (B == 0) return 0;
  FldaShape s;
  const int rc = flda_shape<R>(L, K, &s);
  if (rc != 0) return fail(static_cast<cudaError_t>(rc));
  if (!s.meta_in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flda_estep_kernel<R, false>;
  if constexpr (sizeof(R) == 4)
    if (elog_f64) kernel = flda_estep_kernel<R, true>;
  const cudaError_t err = allow_smem(kernel, s.bytes);
  if (err != cudaSuccess) return fail(err);
  kernel<<<static_cast<unsigned>(B), kFThreads, s.bytes, static_cast<cudaStream_t>(stream)>>>(
      logbetaT, kappa, terms, counts, doc_mask, alpha, eta, gamma_in, el_in, elo_in, tau_in,
      tauo_in, gamma_out, el_out, elo_out, tau_out, tauo_out, w, scratch,
      static_cast<int>(L), static_cast<int>(K), s.tile, s.meta_in_smem, s.resident, viter,
      vtol * vtol, vec_in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tmvb

extern "C" {

// 1 when every row of a document of L slots stays in shared memory, 0
// when its rows go through in tiles, -1 when the device cannot be queried
// or K is too wide.
int tmvb_flda_estep_rows_in_smem(int64_t L, int64_t K) {
  tmvb::FldaShape s;
  return tmvb::flda_shape<float>(L, K, &s) != 0 ? -1 : s.resident;
}
int tmvb_flda_estep_rows_in_smem_f64(int64_t L, int64_t K) {
  tmvb::FldaShape s;
  return tmvb::flda_shape<double>(L, K, &s) != 0 ? -1 : s.resident;
}

// Elements of device scratch a document needs: 7 L when its slot list
// does not fit shared memory, else 0; -1 on an error.
int64_t tmvb_flda_estep_scratch(int64_t L, int64_t K) {
  tmvb::FldaShape s;
  return tmvb::flda_shape<float>(L, K, &s) != 0 ? -1 : (s.meta_in_smem ? 0 : tmvb::kFMeta * L);
}
int64_t tmvb_flda_estep_scratch_f64(int64_t L, int64_t K) {
  tmvb::FldaShape s;
  return tmvb::flda_shape<double>(L, K, &s) != 0 ? -1 : (s.meta_in_smem ? 0 : tmvb::kFMeta * L);
}

int tmvb_flda_estep(const float* logbetaT, const float* kappa, const int* terms,
                    const float* counts, const float* doc_mask, const float* alpha,
                    const float* eta, const float* gamma_in, const float* el_in,
                    const float* elo_in, const float* tau_in, const float* tauo_in,
                    float* gamma_out, float* el_out, float* elo_out, float* tau_out,
                    float* tauo_out, float* w, float* scratch, int64_t B, int64_t L,
                    int64_t K, int viter, float vtol, int vec_in, int elog_f64,
                    void* stream) {
  return tmvb::launch_flda(logbetaT, kappa, terms, counts, doc_mask, alpha, eta, gamma_in,
                           el_in, elo_in, tau_in, tauo_in, gamma_out, el_out, elo_out, tau_out,
                           tauo_out, w, scratch, B, L, K, viter, vtol, vec_in, elog_f64, stream);
}

// The float64 mode: every tensor double, vtol too; the f64 channel is the
// identity on a float64 state, so there is no elog_f64.  vec_in: K % 2 ==
// 0 and logbetaT 16-byte aligned (16-byte copies of two doubles).
int tmvb_flda_estep_f64(const double* logbetaT, const double* kappa, const int* terms,
                        const double* counts, const double* doc_mask, const double* alpha,
                        const double* eta, const double* gamma_in, const double* el_in,
                        const double* elo_in, const double* tau_in, const double* tauo_in,
                        double* gamma_out, double* el_out, double* elo_out, double* tau_out,
                        double* tauo_out, double* w, double* scratch, int64_t B, int64_t L,
                        int64_t K, int viter, double vtol, int vec_in, void* stream) {
  return tmvb::launch_flda(logbetaT, kappa, terms, counts, doc_mask, alpha, eta, gamma_in,
                           el_in, elo_in, tau_in, tauo_in, gamma_out, el_out, elo_out, tau_out,
                           tauo_out, w, scratch, B, L, K, viter, vtol, vec_in, 0, stream);
}

// The pass mode: pc [B, K] and tau_new [B, L] (see flda_estep_pass_kernel);
// scratch as for tmvb_flda_estep.
int tmvb_flda_estep_pass(const float* logbetaT, const float* kappa, const int* terms,
                         const float* counts, const float* doc_mask, const float* eta,
                         const float* el_in, const float* tau_in, float* pc, float* tau_out,
                         float* scratch, int64_t B, int64_t L, int64_t K, int vec_in,
                         void* stream) {
  return tmvb::launch_flda_pass(logbetaT, kappa, terms, counts, doc_mask, eta, el_in, tau_in,
                                pc, tau_out, scratch, B, L, K, vec_in, stream);
}

// The pass mode's float64 mode; scratch as for tmvb_flda_estep_f64.
int tmvb_flda_estep_pass_f64(const double* logbetaT, const double* kappa, const int* terms,
                             const double* counts, const double* doc_mask, const double* eta,
                             const double* el_in, const double* tau_in, double* pc,
                             double* tau_out, double* scratch, int64_t B, int64_t L, int64_t K,
                             int vec_in, void* stream) {
  return tmvb::launch_flda_pass(logbetaT, kappa, terms, counts, doc_mask, eta, el_in, tau_in,
                                pc, tau_out, scratch, B, L, K, vec_in, stream);
}

}  // extern "C"
