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
// The float64 mode (tmvb_flda_estep_f64): the function on a float64 state,
// every input, output and sum in double, psi the shift-by-8 series in
// double.  Bound: bytes doubled (~136 MB at the widest NSF chunk, ~41 us)
// against the exps, which run as instruction sequences on the FP64 pipe
// (no ex2.approx there): 1.3e8 of them at the widest chunk.  In this
// kernel (R = double, 2^x the library exp2, every shared-memory size in
// 8-byte elements) the widest NSF document does not stay resident (rows
// and p take 213 KB): it went through tiles of 58 slots, 2 blocks an SM,
// re-reading the 20 MB float64 table from L2 every pass, 1.18 ms a chunk
// (a pass ~106 us: ~37 of the FP64 exp2, ~25 of the tiles' re-reads and
// barriers, ~6 of psi and bank conflicts, the rest a slot pass that keeps
// 116 of 256 threads busy; copies of the kernel with one part cut).  So
// where a document's rows fit one block's shared memory and K <= 512 the
// float64 mode runs flda_estep_res_kernel (below; its lanes res_lanes in
// rows.cuh): the rows copied once and kept, the slots over all 256
// threads, p in registers, 2^x by exp2_res (common.cuh; 18 FP64-pipe
// instructions an element in all, as the SASS reads), the rows of w
// written from p taken anew.  Measured (NVIDIA H100 80GB HBM3, 700 W;
// tools/estep_sweep.py flda_double and tools/kernel_ab.py, in turns;
// PERF.md section 6): 1.18 ms -> 462 us at
// the widest NSF chunk (a pass ~38 us; its FP64 floor ~15), 756 -> 288 us
// at L = 64.  Slower, each measured: 16 lanes a slot of 7 topics (572 us), the
// topic count a lane held at run time rather than compiled in (623 us:
// the exps of a slot did not interleave).  Wider documents (L = 1024) and
// K > 512 keep this kernel's tiles; the widest K stays ~3,600 at L = 4.
//
// The pass mode (flda_estep_pass; tmvb_flda_estep_pass[_f64]), for the
// sequence axis, where a document's token slots are split over ranks: one
// pass of the fixpoint without its update, this rank's partial gamma
// statistic pc = sum_l p_l c_l / s_l [B, K] and tau_new [B, L].  The
// caller sums pc over the ranks and updates gamma, psi, the masks and tau
// on the [B, K] and [B, L] tiles; the last rows come from this kernel at
// viter = 0.  It replaces no Pallas kernel: the JAX package runs this
// body in XLA on the sequence axis (topicmodelsvb_jl_tpu/models/
// flda.py:91-105).  What bounds it on an H100: HBM bytes are few (2.9 us
// on the seq chunk of 1024 documents, L = 64, K = 100), the exps 1.6 us
// (one per slot and topic of a real document, padding slots included),
// but every such slot reads its row from L2: 1021 x 64 x 400 B = 26 MB
// there, and 209 MB at L = 512, the floor of a design that reads a row
// once per slot.  Its warp mode (K <= 512, flda_estep_pass_warp_kernel):
// a document's slots over w warps (pass_warps: one per 32 slots up to
// L = 64, then per 64, at most 8; w = 1 puts 4 documents in a CTA), each
// a contiguous range; flda_pass_shape's G lanes a slot (8 up
// to K = 128 in float32, in float64 8 up to K = 64, then 16 of two
// vectors; K = 129-512: 32), D rows a group in flight (one when w > 4 at
// 3-4 vectors a lane, so that more warps stay resident); each row read
// once into registers, p, s, sum p lb, tau_new and q there; the fold as
// lda_estep.cu's warp mode.  Register reach: K <= 512 in either dtype;
// past it the block mode (flda_estep_pass_kernel, the block-per-document
// design) runs.
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/kernel_ab.py in turns,
// PERF.md section 6): about half the block mode's time on the seq
// chunk in float32 and float64, and 0.44 of it at L = 512, where the rows
// (209 MB) come from L2 at ~3.7 TB/s.

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

// Shared memory of the resident design in doubles: the rows [L, K], the
// warps' gamma partials [8, K], e, gamma, El, El_old [K] each, tau and
// (1 - eta) kappa[t] [L] each, 64 for the sums.
__host__ __device__ inline size_t flda_res_smem(int64_t L, int64_t K) {
  return (static_cast<size_t>(L) * K + 12 * static_cast<size_t>(K) + 2 * static_cast<size_t>(L) +
          64) * sizeof(double);
}

// The float64 mode's resident design (flda_estep_res_kernel; K <= 512 and
// a document's rows fit one block's shared memory, flda_double_shape): the
// function of flda_estep_kernel<double>, one CTA of 256 threads a
// document, its L rows copied once into shared memory (cp.async through
// L1) and read from there on every pass: nothing is re-read from L2 and p
// never leaves the registers.  A pass: the slots go 32 at a time over the
// 8 warps' groups of G lanes, one slot a group (within a round the groups
// of a half-warp take slots two apart, so that at G = 8 their rows' 64
// bytes fall on different banks at K = 100); lane (g, sub) holds topics
// sub + G j, j < NV (a compile-time count, so the NV exps of a slot
// interleave; a lane's topics past K read column K - 1 and count 0);
// p = exp2_res(fma(tau log2(e), lb, e)), butterflies over the
// group give s and sum p lb, the group's first lane stores tau_new (tau
// in shared memory; tau_old goes to tauo_out as each slot's tau moves,
// tau to tau_out at the end; the counts are read as a round starts), and
// a slot with a count adds (c / s) p into the lane's q.  The groups' q
// are added by a butterfly over the warp, the warps' in warp order by each
// topic's thread after one barrier; then gamma, psi, the sum's and max's
// barrier, El and the stop test's barrier, as flda_estep_kernel.  The
// rows of w are written after the last pass from p taken anew with
// (tau_old, El_old), a padding slot's without its exps.
// Every sum in one fixed order: same inputs, same bits.
template <int G, int NV>
__global__ void __launch_bounds__(kFThreads, 2) flda_estep_res_kernel(
    const double* __restrict__ logbetaT, const double* __restrict__ kappa,
    const int* __restrict__ terms, const double* __restrict__ counts,
    const double* __restrict__ doc_mask, const double* __restrict__ alpha,
    const double* __restrict__ eta_p, const double* __restrict__ gamma_in,
    const double* __restrict__ el_in, const double* __restrict__ elo_in,
    const double* __restrict__ tau_in, const double* __restrict__ tauo_in,
    double* __restrict__ gamma_out, double* __restrict__ el_out, double* __restrict__ elo_out,
    double* tau_out, double* tauo_out, double* __restrict__ w, int L, int K, int viter,
    double vtol2, int vec_in) {
  using R = double;
  constexpr int S = 32 / G;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char flda_smem_raw[];
  R* rows = reinterpret_cast<R*>(flda_smem_raw);   // [L, K]
  R* qpart = rows + static_cast<size_t>(L) * K;     // [8, K]
  R* e = qpart + kFWarps * K;
  R* gam = e + K;
  R* el = gam + K;
  R* elo = el + K;
  R* ts = elo + K;                                  // [L] tau
  R* mkap = ts + L;                                 // [L] (1 - eta) kappa[t]
  R* red = mkap + L;  // [64]: sum gamma [8], max psi [8], sum d^2 [8], max El [8]
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane / G, sub = lane % G;
  // the group's slot in a round of 32: at S = 4 the half-warp's groups two apart
  const int gslot = warp * S + (S == 4 ? ((gi & 1) << 1) | (gi >> 1) : gi);
  const size_t dl = static_cast<size_t>(b) * L, dk = static_cast<size_t>(b) * K;
  const int* t = terms + dl;
  const R eta = *eta_p, one_m_eta = R(1) - eta;

  // every slot's row, padding too, in slot order
  if (vec_in) {
    const int H = K / 2;
    for (int idx = tid; idx < L * H; idx += kFThreads) {
      const int l = idx / H, h = idx - l * H;
      cp_async16_ca(rows + static_cast<size_t>(l) * K + 2 * h,
                    logbetaT + static_cast<size_t>(t[l]) * K + 2 * h);
    }
  } else {
    for (int idx = tid; idx < L * K; idx += kFThreads) {
      const int l = idx / K, k = idx - l * K;
      cp_async8(rows + idx, logbetaT + static_cast<size_t>(t[l]) * K + k);
    }
  }
  for (int l = tid; l < L; l += kFThreads) {
    ts[l] = tau_in[dl + l];
    mkap[l] = one_m_eta * kappa[t[l]];
    tauo_out[dl + l] = tauo_in[dl + l];
  }
  R mx = -INFINITY;
  for (int k = tid; k < K; k += kFThreads) {
    gam[k] = gamma_in[dk + k];
    const R x = el_in[dk + k];
    el[k] = x;
    elo[k] = elo_in[dk + k];
    mx = fmax(mx, x);
  }
  mx = block_max_once(mx, red + 24);
  for (int k = tid; k < K; k += kFThreads) e[k] = (el[k] - mx) * Real<R>::log2e;
  cp_async_wait_all();
  __syncthreads();

  bool active = doc_mask[b] > R(0);
  int it = 0;
  for (; it < viter && active; ++it) {
    R q[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) q[j] = R(0);
    for (int l0 = 0; l0 < L; l0 += kFWarps * S) {
      const int l = l0 + gslot;
      const int lc = min(l, L - 1);   // past L: the last slot, its results dropped
      const R* row = rows + static_cast<size_t>(lc) * K;
      const R c = __ldg(counts + dl + lc);
      const R tau = ts[lc];
      const R t2 = tau * Real<R>::log2e;
      R p[NV];
      R s = R(0), sl = R(0);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int k = min(sub + G * j, K - 1);
        const R x = row[k];
        const R pj = exp2_res(fma(t2, x, e[k]));
        p[j] = sub + G * j < K ? pj : R(0);
        s += p[j];
        sl = fma(p[j], x, sl);
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
        s += __shfl_xor_sync(kAll, s, o);
        sl += __shfl_xor_sync(kAll, sl, o);
      }
      if (l < L) {
        // update_tau! (fLDA.jl:195-200): exp(-sum p lb / s) as a base-2 exp
        const R tnew = eta / (eta + mkap[l] * ex2(-(sl / s) * Real<R>::log2e) + Real<R>::eps);
        if (sub == 0) {
          tauo_out[dl + l] = tau;
          ts[l] = tnew;
        }
        if (c != R(0)) {
          const R r = c / s;
#pragma unroll
          for (int j = 0; j < NV; ++j) q[j] = fma(r, p[j], q[j]);
        }
      }
    }
#pragma unroll
    for (int o = G; o < 32; o <<= 1)
#pragma unroll
      for (int j = 0; j < NV; ++j) q[j] += __shfl_xor_sync(kAll, q[j], o);
    if (lane < G) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int k = lane + G * j;
        if (k < K) qpart[warp * K + k] = q[j];
      }
    }
    __syncthreads();
    // update_gamma! (fLDA.jl:188-191) into gam, psi(gamma) into e (the pass
    // has read it), before the barrier of the sum and the max
    R gpart = R(0), pmax = -INFINITY;
    for (int k = tid; k < K; k += kFThreads) {
      R qk = qpart[k];
      for (int v = 1; v < kFWarps; ++v) qk += qpart[v * K + k];
      const R g = alpha[k] + qk + Real<R>::eps;
      gam[k] = g;
      const R ps = digamma_series(g);
      e[k] = ps;
      gpart += g;
      pmax = fmax(pmax, ps);
    }
    gpart = warp_sum(gpart);
    pmax = warp_max(pmax);
    if (lane == 0) {
      red[warp] = gpart;
      red[8 + warp] = pmax;
    }
    __syncthreads();
    R g_sum = R(0), p_max = -INFINITY;
#pragma unroll
    for (int v = 0; v < kFWarps; ++v) {
      g_sum += red[v];
      p_max = fmax(p_max, red[8 + v]);
    }
    // update_Elogtheta! (fLDA.jl:181-184); the next e shifted by
    // max El_new = psi(max gamma) - psi(sum gamma)
    R dpart = R(0);
    if (tid < K) {
      const R dg_sum = digamma_series(g_sum);
      for (int k = tid; k < K; k += kFThreads) {
        const R ps = e[k];
        const R el_new = ps - dg_sum;
        const R d = el_new - el[k];
        dpart += d * d;
        elo[k] = el[k];
        el[k] = el_new;
        e[k] = (ps - p_max) * Real<R>::log2e;
      }
    }
    active = block_sum_once<kFWarps>(dpart, red + 16) >= vtol2;
  }

  // statistics from phi(tau_old, El_old) (fLDA.jl:160-177): p anew, e from
  // El_old (the last pass's, or the state's as given when none ran)
  R mo = -INFINITY;
  for (int k = tid; k < K; k += kFThreads) {
    mo = fmax(mo, elo[k]);
    gamma_out[dk + k] = gam[k];
    el_out[dk + k] = el[k];
    elo_out[dk + k] = elo[k];
  }
  mo = block_max_once(mo, red + 24);
  for (int k = tid; k < K; k += kFThreads) e[k] = (elo[k] - mo) * Real<R>::log2e;
  for (int l = tid; l < L; l += kFThreads) tau_out[dl + l] = ts[l];
  __syncthreads();
  R* wd = w + dl * (K + 1);
  for (int l0 = 0; l0 < L; l0 += kFWarps * S) {
    const int l = l0 + gslot;
    const int lc = min(l, L - 1);
    const R* row = rows + static_cast<size_t>(lc) * K;
    const R t2 = tauo_out[dl + lc] * Real<R>::log2e;
    const R c = __ldg(counts + dl + lc);
    R p[NV];
    R s = R(1);   // a padding slot's row is zeros: no exps
    if (l < L && c != R(0)) {
      s = R(0);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int k = min(sub + G * j, K - 1);
        const R pj = exp2_res(fma(t2, row[k], e[k]));
        p[j] = sub + G * j < K ? pj : R(0);
        s += p[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < NV; ++j) p[j] = R(0);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kAll, s, o);
    if (l < L) {
      const R tcur = ts[l];
      const R r = tcur * (c / s);
      R* wl = wd + static_cast<size_t>(l) * (K + 1);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int k = sub + G * j;
        if (k < K) wl[k] = p[j] * r;
      }
      if (sub == 0) wl[K] = (R(1) - tcur) * c;
    }
  }
}

// The pass mode's block mode (K > 512, past the warp mode's reach; the
// block-per-document design): one pass of the fixpoint without its
// update, for the sequence axis: this rank's partial pc[b, k] = sum_l
// p_lk c_l / s_l over the document's own slots, p from (tau, El) as
// above, and tau_new [B, L] on every slot, padding slots included, as
// flda_estep_kernel updates them.  The caller sums pc over the ranks that
// hold the document's other slots and runs gamma, psi, the masks and the
// stop test on the [B, K] tiles between passes.  Same block, shared-memory
// layout, slot list, rows, shift and products as flda_estep_kernel; a
// document with doc_mask 0 gets pc = 0 and tau_new = tau and reads
// nothing else.  One fixed order for every sum: same inputs, same bits.
// R = double is its float64 mode, every input, output and sum in double,
// 2^x the double exp2.
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

// The pass mode's warp mode (K <= 512): pc and tau_new as
// flda_estep_pass_kernel computes them, with a document's slots over the
// warps of a CTA (w of them, pass_warps(L); with w = 1 a CTA holds
// kPassShortDocs documents, a warp each).  Each warp takes its contiguous
// range of slots, every slot of a real document, padding included, 32 at
// a time (term, count, tau and (1 - eta) kappa[t] coalesced, a lane a
// slot, then handed to the groups by shuffles); its S groups of G lanes
// take S slots at once, D rows a group read into registers
// (row_to_regs) before the first is reduced.  Per row p =
// ex2(fma(tau log2(e), lb, e)) with e = (El - max El) log2(e), -inf past
// K; butterflies over the group give s and sum p lb; then tau_new, stored
// by the group's first lane, and for a slot with a count q += (c / s) p.
// p never leaves the registers.  Each warp takes max El for itself (the
// same bits on every warp).  The groups' q are added by a butterfly over
// the warp, then (w > 1) the warps' in warp order through shared memory
// after one barrier.  Every sum in one fixed order: same inputs, same
// bits.
template <typename R, int G, int NVL, int D>
__global__ void __launch_bounds__(256) flda_estep_pass_warp_kernel(
    const R* __restrict__ logbetaT, const R* __restrict__ kappa, const int* __restrict__ terms,
    const R* __restrict__ counts, const R* __restrict__ doc_mask, const R* __restrict__ eta_p,
    const R* __restrict__ el_in, const R* __restrict__ tau_in, R* __restrict__ pc,
    R* __restrict__ tau_out, int B, int L, int K, int w, int vec_in) {
  using V4 = typename Real<R>::V4;
  constexpr int S = 32 / G;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char pass_smem_raw[];
  R* part = reinterpret_cast<R*>(pass_smem_raw);   // [w, 4 G NVL] when w > 1
  const PassWarp pw = pass_warp(w);
  if (pw.b >= B) return;
  const int lane = threadIdx.x & 31, gi = lane / G, sub = lane % G;
  const size_t dl = static_cast<size_t>(pw.b) * L, dk = static_cast<size_t>(pw.b) * K;
  if (!(doc_mask[pw.b] > R(0))) {
    for (int k = pw.wi * 32 + lane; k < K; k += pw.nthr) pc[dk + k] = R(0);
    for (int l = pw.wi * 32 + lane; l < L; l += pw.nthr) tau_out[dl + l] = tau_in[dl + l];
    return;
  }
  const int span = pass_span(L, w), lo = pw.wi * span, hi = min(L, lo + span);
  const int* t = terms + dl;
  // e = (El - max El) log2(e), -inf past K
  V4 e[NVL], q[NVL];
  row_to_regs<R, G, NVL>(e, el_in + dk, K, false, sub, R(-INFINITY));
  R mx = -INFINITY;
#pragma unroll
  for (int v = 0; v < NVL; ++v) {
    mx = Real<R>::max(mx, Real<R>::max(Real<R>::max(e[v].x, e[v].y),
                                       Real<R>::max(e[v].z, e[v].w)));
    q[v] = Real<R>::zero4();
  }
  mx = warp_max(mx);
#pragma unroll
  for (int v = 0; v < NVL; ++v) {
    const int k = 4 * (sub + G * v);
    e[v].x = k < K ? (e[v].x - mx) * Real<R>::log2e : R(-INFINITY);
    e[v].y = k + 1 < K ? (e[v].y - mx) * Real<R>::log2e : R(-INFINITY);
    e[v].z = k + 2 < K ? (e[v].z - mx) * Real<R>::log2e : R(-INFINITY);
    e[v].w = k + 3 < K ? (e[v].w - mx) * Real<R>::log2e : R(-INFINITY);
  }
  const R eta = *eta_p, one_m_eta = R(1) - eta;
  const bool vec = vec_in != 0;
  for (int base = lo; base < hi; base += 32) {
    const int n = min(32, hi - base);
    const bool in = base + lane < hi;
    const int l = base + lane;
    const int tl = in ? t[l] : 0;
    const R cl = in ? counts[dl + l] : R(0);
    const R t2l = in ? tau_in[dl + l] * Real<R>::log2e : R(0);
    const R kl = in ? one_m_eta * kappa[tl] : R(0);
    for (int r0 = 0; r0 < n; r0 += S * D) {
      V4 x[D][NVL];
      R cd[D], t2[D], kd[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int j = min(r0 + d * S + gi, n - 1);   // this group's slot
        const int tj = __shfl_sync(kAll, tl, j);
        cd[d] = __shfl_sync(kAll, cl, j);
        t2[d] = __shfl_sync(kAll, t2l, j);
        kd[d] = __shfl_sync(kAll, kl, j);
        if (r0 + d * S < n) {
          row_to_regs<R, G, NVL>(x[d], logbetaT + static_cast<size_t>(tj) * K, K, vec, sub);
        } else {
#pragma unroll
          for (int v = 0; v < NVL; ++v) x[d][v] = Real<R>::zero4();
        }
      }
      R s[D], sl[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        V4 a = Real<R>::zero4(), g = a;
#pragma unroll
        for (int v = 0; v < NVL; ++v) {
          V4 p;
          p.x = ex2(Real<R>::fma(t2[d], x[d][v].x, e[v].x));
          p.y = ex2(Real<R>::fma(t2[d], x[d][v].y, e[v].y));
          p.z = ex2(Real<R>::fma(t2[d], x[d][v].z, e[v].z));
          p.w = ex2(Real<R>::fma(t2[d], x[d][v].w, e[v].w));
          a.x += p.x;
          a.y += p.y;
          a.z += p.z;
          a.w += p.w;
          g.x = Real<R>::fma(p.x, x[d][v].x, g.x);
          g.y = Real<R>::fma(p.y, x[d][v].y, g.y);
          g.z = Real<R>::fma(p.z, x[d][v].z, g.z);
          g.w = Real<R>::fma(p.w, x[d][v].w, g.w);
          x[d][v] = p;
        }
        s[d] = (a.x + a.y) + (a.z + a.w);
        sl[d] = (g.x + g.y) + (g.z + g.w);
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s[d] += __shfl_xor_sync(kAll, s[d], o);
          sl[d] += __shfl_xor_sync(kAll, sl[d], o);
        }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (r0 + d * S >= n) break;
        const int j = r0 + d * S + gi;
        // update_tau! (fLDA.jl:195-200): exp(-sum p lb / s) as a base-2 exp
        const R tnew = eta / (eta + kd[d] * ex2(-(sl[d] / s[d]) * Real<R>::log2e) + Real<R>::eps);
        if (sub == 0 && j < n) tau_out[dl + base + j] = tnew;
        // 0 past the last slot and on padding: q + 0 p is q, bit for bit (q, p >= 0)
        const R r = j < n && cd[d] != R(0) ? cd[d] / s[d] : R(0);
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
  pass_out<R, G, NVL>(q, part, w, pw.wi, K, [&](int k, R qk) { pc[dk + k] = qk; });
}

// The warp mode's shape for fLDA: K <= 128, 8 lanes a slot in float32;
// in float64 8 up to K = 64, then 16 lanes of two vectors; past it
// wide_pass_shape.  Warps: pass_warps.
inline PassShape flda_pass_shape(int64_t L, int64_t K, int bytes) {
  if (K <= 64 || (K <= 128 && bytes == 4))
    return {8, static_cast<int>((K + 31) / 32 > 0 ? (K + 31) / 32 : 1), pass_warps(L)};
  if (K <= 128) return {16, 2, pass_warps(L)};
  return wide_pass_shape(L, K);
}

template <typename R, int G, int NVL, int D>
int launch_flda_pass_warp(const R* logbetaT, const R* kappa, const int* terms, const R* counts,
                          const R* doc_mask, const R* eta, const R* el_in, const R* tau_in,
                          R* pc, R* tau_out, int64_t B, int64_t L, int64_t K, int w, int vec_in,
                          cudaStream_t stream) {
  const PassLaunch pl = pass_launch<R>(B, G, NVL, w);
  flda_estep_pass_warp_kernel<R, G, NVL, D><<<pl.grid, pl.threads, pl.smem, stream>>>(
      logbetaT, kappa, terms, counts, doc_mask, eta, el_in, tau_in, pc, tau_out,
      static_cast<int>(B), static_cast<int>(L), static_cast<int>(K), w, vec_in);
  return static_cast<int>(cudaGetLastError());
}

// The pass mode's launch: the warp mode for K <= 512 (flda_pass_shape),
// past it the block mode; vec_in: K a multiple of the elements in 16
// bytes (4 floats, 2 doubles) and logbetaT 16-byte aligned.
template <typename R>
int launch_flda_pass(const R* logbetaT, const R* kappa, const int* terms, const R* counts,
                     const R* doc_mask, const R* eta, const R* el_in, const R* tau_in, R* pc,
                     R* tau_out, R* scratch, int64_t B, int64_t L, int64_t K, int vec_in,
                     void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PassShape ps = flda_pass_shape(L, K, sizeof(R));
#define TMVB_FLDA_PASS_WARP_D(G, NVL, D)                                                   \
  return launch_flda_pass_warp<R, G, NVL, D>(logbetaT, kappa, terms, counts, doc_mask, eta, \
                                             el_in, tau_in, pc, tau_out, B, L, K, ps.w,     \
                                             vec_in, st)
#define TMVB_FLDA_PASS_WARP(G, NVL) TMVB_FLDA_PASS_WARP_D(G, NVL, (pass_depth<R, G, NVL>()))
  switch (ps.G * 8 + ps.NVL) {
    case 8 * 8 + 1:
      TMVB_FLDA_PASS_WARP(8, 1);
    case 8 * 8 + 2:
      TMVB_FLDA_PASS_WARP(8, 2);
    case 8 * 8 + 3:   // one row a group when a chunk takes several waves
      if constexpr (sizeof(R) == 4) {
        if (ps.w > 4) TMVB_FLDA_PASS_WARP_D(8, 3, 1);
        TMVB_FLDA_PASS_WARP(8, 3);
      }
      break;
    case 8 * 8 + 4:
      if constexpr (sizeof(R) == 4) {
        if (ps.w > 4) TMVB_FLDA_PASS_WARP_D(8, 4, 1);
        TMVB_FLDA_PASS_WARP(8, 4);
      }
      break;
    case 16 * 8 + 2:
      if constexpr (sizeof(R) == 8) TMVB_FLDA_PASS_WARP(16, 2);
      break;
    case 32 * 8 + 2:
      TMVB_FLDA_PASS_WARP(32, 2);
    case 32 * 8 + 3:
      TMVB_FLDA_PASS_WARP(32, 3);
    case 32 * 8 + 4:
      TMVB_FLDA_PASS_WARP(32, 4);
    default:
      break;
  }
#undef TMVB_FLDA_PASS_WARP
#undef TMVB_FLDA_PASS_WARP_D
  FldaShape s;
  const int rc = flda_shape<R>(L, K, &s);
  if (rc != 0) return fail(static_cast<cudaError_t>(rc));
  if (!s.meta_in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(flda_estep_pass_kernel<R>, s.bytes);
  if (err != cudaSuccess) return fail(err);
  flda_estep_pass_kernel<R><<<static_cast<unsigned>(B), kFThreads, s.bytes, st>>>(
      logbetaT, kappa, terms, counts, doc_mask, eta, el_in, tau_in, pc, tau_out, scratch,
      static_cast<int>(L), static_cast<int>(K), s.tile, s.meta_in_smem, s.resident, vec_in);
  return static_cast<int>(cudaGetLastError());
}

// The float64 mode's choice: the resident design's lanes a slot (0: the
// tiled kernel, flda_estep_kernel<double>) and its shared memory.
struct FldaDoubleShape {
  int G, NV;
  size_t bytes;
};
inline int flda_double_shape(int64_t L, int64_t K, FldaDoubleShape* s) {
  const int optin = smem_optin();
  if (optin < 0) return query_error();
  const ResShape r = res_lanes(K);
  const size_t bytes = flda_res_smem(L, K);
  *s = {r.G > 0 && bytes <= static_cast<size_t>(optin) ? r.G : 0, r.NV, bytes};
  return 0;
}

// The resident design's kernel for (G, NV), or nullptr.
inline const void* flda_res_kernel(int G, int NV) {
  switch (G * 32 + NV) {
    case 8 * 32 + 4:
      return reinterpret_cast<const void*>(flda_estep_res_kernel<8, 4>);
    case 8 * 32 + 8:
      return reinterpret_cast<const void*>(flda_estep_res_kernel<8, 8>);
    case 8 * 32 + 13:
      return reinterpret_cast<const void*>(flda_estep_res_kernel<8, 13>);
    case 8 * 32 + 16:
      return reinterpret_cast<const void*>(flda_estep_res_kernel<8, 16>);
    case 16 * 32 + 16:
      return reinterpret_cast<const void*>(flda_estep_res_kernel<16, 16>);
    case 32 * 32 + 16:
      return reinterpret_cast<const void*>(flda_estep_res_kernel<32, 16>);
    default:
      return nullptr;
  }
}

int launch_flda_res(const double* logbetaT, const double* kappa, const int* terms,
                    const double* counts, const double* doc_mask, const double* alpha,
                    const double* eta, const double* gamma_in, const double* el_in,
                    const double* elo_in, const double* tau_in, const double* tauo_in,
                    double* gamma_out, double* el_out, double* elo_out, double* tau_out,
                    double* tauo_out, double* w, int64_t B, int64_t L, int64_t K, int viter,
                    double vtol, int vec_in, const FldaDoubleShape& d, cudaStream_t stream) {
  const void* kernel = flda_res_kernel(d.G, d.NV);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(kernel, d.bytes);
  if (err != cudaSuccess) return fail(err);
  int Li = static_cast<int>(L), Ki = static_cast<int>(K);
  double vtol2 = vtol * vtol;
  void* args[] = {&logbetaT, &kappa, &terms, &counts, &doc_mask, &alpha, &eta, &gamma_in,
                  &el_in, &elo_in, &tau_in, &tauo_in, &gamma_out, &el_out, &elo_out, &tau_out,
                  &tauo_out, &w, &Li, &Ki, &viter, &vtol2, &vec_in};
  err = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(B)), dim3(kFThreads), args, d.bytes,
                         stream);
  if (err != cudaSuccess) return fail(err);
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
  if constexpr (sizeof(R) == 8) {
    FldaDoubleShape d;
    const int rc = flda_double_shape(L, K, &d);
    if (rc != 0) return fail(static_cast<cudaError_t>(rc));
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d.G > 0)
      return launch_flda_res(logbetaT, kappa, terms, counts, doc_mask, alpha, eta, gamma_in,
                             el_in, elo_in, tau_in, tauo_in, gamma_out, el_out, elo_out,
                             tau_out, tauo_out, w, B, L, K, viter, vtol, vec_in, d, st);
  }
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
// The warp mode's shape of flda_estep_pass, as tmvb_lda_estep_pass_shape.
void tmvb_flda_estep_pass_shape(int64_t L, int64_t K, int bytes, int* out) {
  const tmvb::PassShape s = tmvb::flda_pass_shape(L, K, bytes);
  out[0] = s.G;
  out[1] = s.NVL;
  out[2] = s.w;
}

int64_t tmvb_flda_estep_scratch_f64(int64_t L, int64_t K) {
  tmvb::FldaDoubleShape d;
  if (tmvb::flda_double_shape(L, K, &d) != 0) return -1;
  if (d.G > 0) return 0;   // the resident design keeps its slot data in shared memory
  tmvb::FldaShape s;
  return tmvb::flda_shape<double>(L, K, &s) != 0 ? -1 : (s.meta_in_smem ? 0 : tmvb::kFMeta * L);
}

// The float64 mode's launch shape on a document of L slots at K topics:
// out[0] 1 for the resident design (flda_estep_res_kernel), 0 for the
// block kernel with its rows in tiles, 2 for the block kernel with every
// row in shared memory (K > 512); out[1] lanes a slot (resident design)
// or the slots of a tile; out[2] blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); out[3] shared memory in
// bytes a block.  Returns 0, or a CUDA error code.
int tmvb_flda_estep_double_shape(int64_t L, int64_t K, int* out) {
  tmvb::FldaDoubleShape d;
  int rc = tmvb::flda_double_shape(L, K, &d);
  if (rc != 0) return rc;
  int blocks = 0;
  cudaError_t err;
  if (d.G > 0) {
    const void* kernel = tmvb::flda_res_kernel(d.G, d.NV);
    err = tmvb::allow_smem(kernel, d.bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, tmvb::kFThreads,
                                                          d.bytes);
    out[0] = 1;
    out[1] = d.G;
    out[3] = static_cast<int>(d.bytes);
  } else {
    tmvb::FldaShape s;
    rc = tmvb::flda_shape<double>(L, K, &s);
    if (rc != 0) return rc;
    err = tmvb::allow_smem(tmvb::flda_estep_kernel<double, false>, s.bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tmvb::flda_estep_kernel<double, false>, tmvb::kFThreads, s.bytes);
    out[0] = s.resident ? 2 : 0;
    out[1] = s.tile;
    out[3] = static_cast<int>(s.bytes);
  }
  out[2] = blocks;
  return err == cudaSuccess ? 0 : tmvb::fail(err);
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
