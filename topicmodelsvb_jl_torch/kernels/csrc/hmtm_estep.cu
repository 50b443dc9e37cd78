// HMTM E-step and forward normaliser: the per-document chain fixpoint of
// the hidden Markov topic model by scaled forward-backward.
//
// Replaces no TPU kernel: the JAX package runs these recursions as
// `lax.scan`s over the token axis under `jit` (topicmodelsvb_jl_tpu/models/
// hmtm.py: `_estep_chunk` :218-264 with `_forward` :139-172 and
// `_backward_stats` :175-215; `make_elbo`'s `_forward` :404 for logZ).  In
// PyTorch a scan is a Python loop of ~20 launches a position, so the
// fixpoint gets a kernel.  For each document with chain parameters
// p0 = exp(E[log pi]) and A[i, l] = exp(E[log theta[i, l]]) and emissions
// B_n = (beta + eps)[:, w_n]:
//
//   forward   f_0 = p0 B_0, f_n = B_n (A a_{n-1}); c_n = sum f_n + eps;
//             a_n = f_n / c_n (a padding slot carries a_{n-1}, c = 1;
//             a padding first slot takes f_0 = p0)
//   backward  g_n = B_n be_n / c_n; be_{n-1} = A^T g_n;
//             xi_sum += A o (g_n a_{n-1}^T); r_n = a_n be_n
//             (a padding slot: be carried, r = 0); r_0 = a_0 be_0 m_0
//   update    tau = eta + r_0, gamma = alpha + xi_sum; stop once
//             |gamma_new - gamma|_F < vtol (the break at HMTM.jl:201)
//
// `hmtm_estep` runs up to viter passes of forward, backward and update,
// then one more forward-backward from the final state that writes
// r [B, L, K] = q(z_n) for every row of the chunk.  `hmtm_logz` writes
// logZ = sum_n log c_n, the bound's z and w terms.
//
// What bounds it on an H100: neither bytes nor flops but a sequential
// chain.  A document's passes are L K x K matrix-vector products each,
// every step waiting on the one before: at the widest NSF chunk (B = 1024,
// L = 128, K = 25, viter 10) ~11 passes of 128 slots.  The chunk's flops
// (~6 K^2 a slot a pass) take ~53 us at the f32 rate and its bytes (~13 MB
// of r) ~4 us; the time is the chain's steps times a step's cost.
//
// K <= 32, NSF's path: the split schedule (hmtm_estep_split_kernel,
// hmtm_logz_split_kernel).  A block of two warps a document, lane i topic
// i; the forward warp and the backward warp walk the chain at once and
// meet in the middle, so a pass is L steps on the chain, not 2 L:
//   forward   F_n = (A F_{n-1}) (B_n / C_{n-1}), C = sum F + EPSILON
//             (JAX's f_n and c_n)
//   backward  v_n = B_n bt_n, bt_{n-1} = A^T v_n / (sum v_n + EPSILON),
//             bt = 1 from the last real slot: normalised by its own sums,
//             it needs nothing from the forward
//   combine   (A a_{n-1}) . v_n = c_n (a_n . bt_n): r_n = (A a_{n-1}) o v_n
//             / that, S[i, l] += v_n[i] a_{n-1}[l] / that (the forward's S
//             by rows, the backward's by columns); r and S times s = sum
//             a_last (JAX's a_n . be_n, 1 but for EPSILON / c_last)
// Up to mid = last / 2 the forward stores F_n and the backward v_n (n >
// mid) in one [L, K] store; past it each warp combines its message with
// the other's stored one.  logZ meets the same way: the forward's sum of
// log C to mid, the backward's sum of log N past it and log(a_mid . bt_mid)
// (the backward carries the forward's EPSILON as a sink state, so the sum
// is JAX's, EPSILON included); half the chain.  A step's chain is a
// broadcast of the message (a store to a per-warp shared row read back as
// 16-byte vectors: faster than 32 shuffles, PERF.md), the
// K-term dot and one multiply; the sum that normalises runs beside the dot
// (each lane sums the broadcast values: no butterfly on the chain) with
// the special-function unit's reciprocal in float32.  Each lane keeps its
// row or column of A and of S in registers (a width of 16, 28 or 32 by K;
// <= 128 registers, so 8 documents an SM: the widest NSF chunk in one
// wave, 18.6 KB of shared memory each), the emission entry fetched a slot
// ahead.  Padding carries a message (c = 1, r = 0; a padding first slot
// takes F_0 = p0); a document with no real slot has logZ = 0 exactly.
// What holds a step now is the SM's schedulers and shared-memory pipe under
// 16 warps: ~0.52 us a step at NSF against ~0.39 for the one-warp
// schedule's steps, of which a pass took twice as many (chip_smoke.py's
// phase 9, PERF.md), and ~0.39 us with one document an SM (L = 4,096), of
// which the gather (the term id, then its entry) is up to a fifth.
//
// K > 32 (33 .. 239 in f32): the multi-warp schedule (hmtm_estep_kernel,
// hmtm_logz_kernel), forward then backward as JAX orders them:
// - one block a document, ceil(K/32) warps, thread i owning topic i; A in
//   shared memory, rows padded to an odd stride, so that both the forward
//   (thread i reads row i) and the backward (thread l reads column l) read
//   32 banks at once; a barrier a step;
// - emission rows gathered from the [V, K] table (in L2) with the next
//   slot's term id and row loaded a step ahead, off the chain;
// - xi_sum is accumulated as S[i, l] = sum_n g_n[i] a_{n-1}[l] and
//   multiplied by A once a pass (A is constant within a pass); S, the
//   messages a [L, K] and the scalers c [L] stay in shared memory when all
//   of them fit half the SM's opt-in, else the messages, and past K ~ 168
//   S too, go to a device scratch the wrapper allocates.
// Both are compiled for two blocks an SM (kHmBlocks: up to 128 registers a
// thread; left to itself ptxas kept them to 64 and K = 100 ran 24% slower).
// Either way sums run in fixed orders and no float atomic is used (same
// inputs, same bits), and each document stops on its own test, so the
// E-step reads nothing back to the host.  psi is common.cuh's shift-by-8
// series.
//
// Past the shared-memory modes (past 256 topics, or where A [K, K | 1]
// overflows the device's opt-in shared memory: K = 240 on an H100 in f32,
// 170 in f64) the cluster mode (mode 4; hmtm_estep_cluster_kernel,
// hmtm_logz_cluster_kernel, below) spreads each document's A over the
// shared memory of a thread-block cluster of 2-16 CTAs, one SM each: on an
// H100 to K = 704 in f32 (the kernel's threads) and 637 in f64 for
// hmtm_estep, to 944 and 656 for hmtm_logz.  What bounds it: the chain's
// steps, each a cluster barrier, a gather over distributed shared memory
// and the CTA's share of A read from shared memory.
//
// The wide mode (mode 3; hmtm_estep_wide_kernel, hmtm_logz_wide_kernel)
// takes every K past the cluster's reach.  Each document's
// A [K, K] and A^T, S, the messages, the scalers and the per-topic vectors
// (g twice, be, p0, the column sums) live in the device scratch, formed
// once a pass from gamma as the shared copy is; shared memory holds only
// the 32 slots of the block sums.  A block has min(256, ceil(K/32) 32)
// threads and thread t owns topics t, t + blockDim, ...: the forward's
// (A a)_i reads A^T[l, i] and the backward's (A^T g)_l reads A[i, l], both
// coalesced over the threads, and S[i, l] is updated by the column's
// thread.  Messages of the previous step and g are read back from the
// scratch after the step's barrier (they are L1 hits, and __syncthreads
// orders a block's global writes before its later reads).  Every sum has
// one fixed order, and no float atomic is used.  What bounds it: bytes,
// now, of A^T (forward) and A and S (backward) a step: 4 K^2 elements a
// real slot a pass against 6 K^2 flops; at K = 300 a document's 1 MB
// overflows the 50 MB L2 once ~50 documents are in flight, so the mode
// runs near the HBM rate.  Offsets into the scratch are 64-bit (B K^2 is
// 2.7e8 elements at K = 512, B = 1024).
//
// The float64 mode (R = double; tmvb_hmtm_*_f64): every kernel above on a
// float64 state, every input, output and sum in double.  psi is the double
// series through t^-12 (digamma_series64, truncation < 2e-14), since the
// plain version takes psi from torch.special on a float64 state; exp and
// log are the double ones, and 1 / x the IEEE division.  The split
// kernels keep their rows in up to 255 registers (4 documents an SM).  A in
// 8-byte elements fits shared memory up to K ~ 169; past it the wide mode
// runs.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace tmvb {

constexpr int kHmMaxThreads = 256;   // 8 warps: K <= 256 (the wide mode: any K)
constexpr int kHmWide = 3;           // HmShape::mode of the wide mode
constexpr int kHmBadShape = -2;      // K or L below 1
// Blocks an SM the multi-warp kernels are compiled for: a cap of 128
// registers a thread (without it ptxas kept them to 64, and K = 100 ran
// 24% slower; PERF.md)
constexpr int kHmBlocks = 2;

__host__ __device__ inline int hm_stride(int K) { return K | 1; }
__host__ __device__ inline int hm_threads(int K) {
  const int t = (K + 31) / 32 * 32;
  return t < kHmMaxThreads ? t : kHmMaxThreads;
}

// Shared elements every block of the shared-memory modes needs: A [K, K |
// 1], two vectors [threads] (the backward's g, or hmtm_logz's two message
// rows) and 32 for sums.
inline size_t hm_base_elems(int K) {
  return static_cast<size_t>(K) * hm_stride(K) + 2 * static_cast<size_t>(hm_threads(K)) + 32;
}

constexpr int kHsThreads = 64;   // warp 0 runs the forward, warp 1 the backward

// Registers a lane keeps for a row or column of K entries: the next of
// 16, 28 and 32 (K = 25 reads seven 16-byte vectors a broadcast).
__host__ __device__ inline int hs_width(int K) { return K <= 16 ? 16 : (K <= 28 ? 28 : 32); }

// Shared elements of the split kernels but the messages: two broadcast
// rows a warp [2][2][32], red, p0 and psi(column sums) [32] each, A [K, K
// | 1] and G [K, K] (the forward's S, then the new gamma).
inline size_t hs_base_elems(int K) {
  return 4 * 32 + 3 * 32 + static_cast<size_t>(K) * hm_stride(K) + static_cast<size_t>(K) * K;
}

// The wide mode's scratch a document, in elements: A, A^T and S [K, K],
// the messages [L, K], the scalers [L], g [2, K], be, p0 and the column
// sums [K] (hmtm_estep); A^T, two message rows and p0 (hmtm_logz).
inline int64_t hm_wide_scratch(int64_t L, int64_t K) { return 3 * K * K + L * K + L + 5 * K; }
inline int64_t hm_wide_logz_scratch(int64_t K) { return K * K + 3 * K; }

// The cluster mode (mode 4; hmtm_estep_cluster_kernel,
// hmtm_logz_cluster_kernel): a cluster of c CTAs a document, CTA r holding
// rows [r Kr, r Kr + Kr) of A in its shared memory, Kr = ceil(K / c); c
// the narrowest of 2, 4, 8, 16 whose share fits the opt-in.  One thread a
// topic (hc_threads(K) threads a CTA).
constexpr int kHmCluster = 4;         // HmShape::mode of the cluster mode
constexpr int kHcMaxWidth = 16;       // CTAs a cluster at most (past 8: non-portable)
constexpr int kHcEstepThreads = 704;  // hmtm_estep's launch bound: K <= 704 (88 registers)
constexpr int kHcLogzThreads = 1024;  // hmtm_logz's: K <= 1024 (64 registers)
constexpr int kHcRed = 4 * 32;        // four block sums' warp slots

__host__ __device__ inline int hc_rows(int K, int c) { return (K + c - 1) / c; }
__host__ __device__ inline int hc_threads(int K) { return (K + 31) / 32 * 32; }

// Shared elements of a CTA.  hmtm_estep: a step's g [Kr4] (Kr4 = Kr
// rounded up to 4: 16-byte vectors), A [Kr, K], the last raw
// message fv [K], the forward's ring of row slices [2, Kr], the
// backward's ring of partials [2, K], the emission slice [Kr], the sums'
// slots, two exchange buffers [K + Kr + 2] (column sums, the tau slice,
// |dgamma|^2) and 2 for the entry count.  hmtm_logz: A, fv, the forward's
// ring, the emission slice, the slots, one exchange buffer.
__host__ __device__ inline int64_t hc_xbuf(int64_t K, int64_t Kr) { return K + Kr + 2; }
__host__ __device__ inline int hc_rows4(int Kr) { return (Kr + 3) / 4 * 4; }
inline int64_t hc_estep_elems(int64_t K, int c) {
  const int64_t Kr = hc_rows(static_cast<int>(K), c);
  return hc_rows4(static_cast<int>(Kr)) + Kr * K + K + 2 * Kr + 2 * K + Kr + kHcRed +
         2 * hc_xbuf(K, Kr) + 2;
}
inline int64_t hc_logz_elems(int64_t K, int c) {
  const int64_t Kr = hc_rows(static_cast<int>(K), c);
  return Kr * K + K + 3 * Kr + kHcRed + hc_xbuf(K, Kr) + 2;
}

// The narrowest cluster whose CTAs' shares fit `optin` bytes, 0 if none
// does (or K exceeds the kernel's threads): then the wide mode runs.
template <typename R>
inline int hc_width(int64_t K, int optin, bool estep) {
  if (K > (estep ? kHcEstepThreads : kHcLogzThreads)) return 0;
  for (int c = 2; c <= kHcMaxWidth; c *= 2) {
    const int64_t e = estep ? hc_estep_elems(K, c) : hc_logz_elems(K, c);
    if (e * static_cast<int64_t>(sizeof(R)) <= optin) return c;
  }
  return 0;
}

// Device scratch a document in the cluster mode, in elements: for
// hmtm_estep each CTA's g store [L, Kr4], its copy of the messages [L, K],
// the scalers [L] and the entry lists (slot and term id [L] each, as ints
// in 2 L elements), rounded up to 4 (16-byte aligned g rows); for
// hmtm_logz each CTA's term list [L].
__host__ __device__ inline int64_t hc_estep_cta(int64_t L, int64_t K, int c) {
  return (L * hc_rows4(hc_rows(static_cast<int>(K), c)) + L * K + 3 * L + 3) / 4 * 4;
}
inline int64_t hc_estep_scratch(int64_t L, int64_t K, int c) { return c * hc_estep_cta(L, K, c); }
inline int64_t hc_logz_scratch(int64_t L, int c) { return c * L; }

struct HmShape {
  int mode;         // 0: S and the messages in shared memory; 1: the
                    // messages in scratch; 2: S and the messages in
                    // scratch (K > 32); 3 (wide): A, A^T, S, the messages
                    // and the vectors in scratch; 4 (cluster): A in a
                    // cluster's shared memory, the messages in scratch
  size_t bytes;     // dynamic shared memory (a CTA of the cluster)
  int64_t scratch;  // elements of device scratch a document (hmtm_estep)
  int cluster;      // the cluster's width in mode 4, else 0
};

// 0; kHmBadShape when K or L is below 1; else the CUDA error of the device
// query.  R is float, or double for the float64 mode: sizes in its
// elements.
template <typename R>
inline int hm_shape(int64_t L, int64_t K, HmShape* s) {
  if (K < 1 || L < 1) return kHmBadShape;
  const int optin = smem_optin();
  if (optin < 0) return query_error();
  const int64_t pos = L * K + L;
  if (K <= 32) {   // the split schedule: the messages [L, K] in shared memory or scratch
    const size_t sb = hs_base_elems(static_cast<int>(K)) * sizeof(R);
    const size_t pb = static_cast<size_t>(L * K) * sizeof(R);
    if (sb + pb <= static_cast<size_t>(optin) / 2)
      *s = {0, sb + pb, 0};
    else
      *s = {1, sb, L * K};
    return 0;
  }
  const size_t base = hm_base_elems(static_cast<int>(K)) * sizeof(R);
  if (K > kHmMaxThreads || base > static_cast<size_t>(optin)) {
    const int c = hc_width<R>(K, optin, true);
    if (c > 0)
      *s = {kHmCluster, static_cast<size_t>(hc_estep_elems(K, c)) * sizeof(R),
            hc_estep_scratch(L, K, c), c};
    else
      *s = {kHmWide, 32 * sizeof(R), hm_wide_scratch(L, K), 0};
    return 0;
  }
  const size_t sb = static_cast<size_t>(K * K) * sizeof(R);
  const size_t pb = static_cast<size_t>(pos) * sizeof(R);
  if (base + sb + pb <= static_cast<size_t>(optin) / 2)
    *s = {0, base + sb + pb, 0};
  else if (base + sb <= static_cast<size_t>(optin))
    *s = {1, base + sb, pos};
  else
    *s = {2, base, K * K + pos};
  return 0;
}

// hmtm_logz's layout: its kernels need A only, so where hmtm_estep runs
// the cluster or the wide mode, hmtm_logz takes the narrowest cluster that
// holds A (mode 4, `cluster` its width, `scratch` its term lists) or, past
// it, the wide mode (3); elsewhere the shared-memory kernels (mode 0).
template <typename R>
inline int hm_logz_shape(int64_t L, int64_t K, HmShape* s) {
  const int rc = hm_shape<R>(L, K, s);
  if (rc != 0 || s->mode < kHmWide) {
    if (rc == 0) *s = {0, 0, 0, 0};
    return rc;
  }
  const int c = hc_width<R>(K, smem_optin(), false);
  if (c > 0)
    *s = {kHmCluster, static_cast<size_t>(hc_logz_elems(K, c)) * sizeof(R), hc_logz_scratch(L, c),
          c};
  else
    *s = {kHmWide, 32 * sizeof(R), hm_wide_logz_scratch(K), 0};
  return 0;
}

// psi and sqrt of the mode: the f32 series and sqrtf, or in the float64
// mode the double series through t^-12 and the double sqrt.
__device__ __forceinline__ float hm_psi(float x) { return digamma_series(x); }
__device__ __forceinline__ double hm_psi(double x) { return digamma_series64(x); }
__device__ __forceinline__ float hm_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double hm_sqrt(double x) { return sqrt(x); }

// Sum of v over the block, the same bits in every thread: the xor
// butterfly, then (several warps) the warps' partials in warp order after
// one barrier.  The caller keeps `red` unwritten until every thread has
// passed a barrier after reading it.
template <typename R>
__device__ __forceinline__ R hm_sum(R v, R* red, int nw) {
  v = warp_sum(v);
  if (nw == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  R s = 0;
  for (int w = 0; w < nw; ++w) s += red[w];
  return s;
}

template <typename R>
__device__ __forceinline__ R hm_max(R v, R* red, int nw) {
  v = warp_max(v);
  if (nw == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  R s = red[0];
  for (int w = 1; w < nw; ++w) s = Real<R>::max(s, red[w]);
  return s;
}

// The last real slot of a document, -1 when it has none.
template <typename R>
__device__ __forceinline__ int hm_last(const R* mb, int L, R* red, int nw) {
  int last = -1;
  for (int n = threadIdx.x; n < L; n += blockDim.x)
    if (mb[n] > R(0)) last = n;
  return static_cast<int>(hm_max(static_cast<R>(last), red, nw));
}

// A [i, l] = exp(psi(gamma[i, l]) - psi(sum_i gamma[i, l])): thread l
// builds column l.  `stage` (thread l's column of a [K, K] buffer) holds
// gamma between the two loops; NULL reads gamma twice.
template <typename R>
__device__ __forceinline__ void hm_build_A(const R* gd, R* A, R* stage, int K) {
  const int l = threadIdx.x;
  if (l >= K) return;
  const int Ka = hm_stride(K);
  R cs = 0;
  for (int i = 0; i < K; ++i) {
    const R g = gd[i * K + l];
    if (stage) stage[i * K + l] = g;
    cs += g;
  }
  const R dcs = hm_psi(cs);
  for (int i = 0; i < K; ++i)
    A[i * Ka + l] = Real<R>::exp(hm_psi(stage ? stage[i * K + l] : gd[i * K + l]) - dcs);
}

// p0_i = exp(psi(tau_i) - psi(sum tau)) for the thread's topic.
template <typename R>
__device__ __forceinline__ R hm_p0(R tau, bool own, R* red, int nw) {
  const R ts = hm_sum(own ? tau : R(0), red, nw);
  return own ? Real<R>::exp(hm_psi(tau) - hm_psi(ts)) : R(0);
}

// The forward pass over slots 0 .. last; row n of the messages is
// `a + (ring ? n & 1 : n) * K`, its scaler c[n] (c may be NULL).  Returns
// logZ, the same in every thread.  Thread i reads row i of A and a_{n-1}
// from shared memory and sums (A a)_i over four accumulators; a barrier
// ends each step.
template <bool kRing, typename R>
__device__ __forceinline__ R hm_forward(
    const R* __restrict__ A, const R* __restrict__ betaT, const int* tb,
    const R* mb, R p0, R* a, R* c, R* red, int last, int K, int nw) {
  const int i = threadIdx.x;
  const bool own = i < K;
  const int Ka = hm_stride(K);
  auto row = [&](int n) { return a + static_cast<size_t>(kRing ? (n & 1) : n) * K; };
  const R* Ai = A + i * Ka;
  const R m0 = mb[0];
  const R b0 = (own && m0 > R(0)) ? betaT[static_cast<size_t>(tb[0]) * K + i] : R(0);
  const R f0 = own ? (m0 > R(0) ? p0 * b0 : p0) : R(0);
  const R c0 = hm_sum(f0, red, nw) + Real<R>::eps;
  R a_i = own ? f0 / c0 : R(0);   // this thread's entry of the last message
  if (own) row(0)[i] = a_i;
  if (c != nullptr && i == 0) c[0] = m0 > R(0) ? c0 : R(1);
  R logz = m0 > R(0) ? Real<R>::log(c0) : R(0);
  __syncthreads();
  // slot n + 1's mask and row, and slot n + 2's term id, a step ahead
  R m_nx = last >= 1 ? mb[1] : R(0);
  R b_nx = (own && last >= 1) ? betaT[static_cast<size_t>(tb[1]) * K + i] : R(0);
  int t_nx2 = last >= 2 ? tb[2] : 0;
  for (int n = 1; n <= last; ++n) {
    const R bn = b_nx, mn = m_nx;
    if (n + 1 <= last) {
      m_nx = mb[n + 1];
      b_nx = own ? betaT[static_cast<size_t>(t_nx2) * K + i] : R(0);
    }
    if (n + 2 <= last) t_nx2 = tb[n + 2];
    if (mn > R(0)) {
      R s[4] = {R(0), R(0), R(0), R(0)};
      if (own) {
        const R* ap = row(n - 1);
        int l = 0;
        for (; l + 4 <= K; l += 4) {
          s[0] = Real<R>::fma(Ai[l], ap[l], s[0]);
          s[1] = Real<R>::fma(Ai[l + 1], ap[l + 1], s[1]);
          s[2] = Real<R>::fma(Ai[l + 2], ap[l + 2], s[2]);
          s[3] = Real<R>::fma(Ai[l + 3], ap[l + 3], s[3]);
        }
        for (; l < K; ++l) s[0] = Real<R>::fma(Ai[l], ap[l], s[0]);
      }
      const R f = own ? bn * ((s[0] + s[1]) + (s[2] + s[3])) : R(0);
      const R cn = hm_sum(f, red, nw) + Real<R>::eps;
      if (own) a_i = f / cn;
      if (c != nullptr && i == 0) c[n] = cn;
      logz += Real<R>::log(cn);
    } else if (c != nullptr && i == 0) {
      c[n] = R(1);
    }
    if (own) row(n)[i] = a_i;
    __syncthreads();
  }
  return logz;
}

// The backward pass over slots last .. 1 from the forward's a and c.
// Thread l owns be[l] and column l of S.  kFinal writes r rows 1 .. last
// (`rd`, 0 on padding) and leaves S alone; otherwise
// S[i, l] += g_n[i] a_{n-1}[l] on every real slot.  Returns be_0[l].  A,
// S and g go through shared memory (g double-buffered, one barrier a real
// slot); (A^T g)_l is summed over two accumulators.
template <bool kFinal, typename R>
__device__ __forceinline__ R hm_backward(
    const R* __restrict__ A, const R* __restrict__ betaT, const int* tb,
    const R* mb, const R* a, const R* c, R* S, R* gbuf, R* rd,
    int last, int K) {
  const int l = threadIdx.x;
  const bool own = l < K;
  const int Ka = hm_stride(K), Kv = blockDim.x;
  R be = R(1);
  if (last >= 1) {
    R m_nx = mb[last];
    R b_nx = own ? betaT[static_cast<size_t>(tb[last]) * K + l] : R(0);
    int t_nx2 = last >= 2 ? tb[last - 1] : 0;
    int par = 0;   // g's buffer, flipped on every real slot (each has a barrier)
    for (int n = last; n >= 1; --n) {
      const R bn = b_nx, mn = m_nx;
      if (n - 1 >= 1) {
        m_nx = mb[n - 1];
        b_nx = own ? betaT[static_cast<size_t>(t_nx2) * K + l] : R(0);
      }
      if (n - 2 >= 1) t_nx2 = tb[n - 2];
      if (mn > R(0)) {
        const R gl = own ? (bn * be) / c[n] : R(0);
        if (kFinal && own) rd[static_cast<size_t>(n) * K + l] = a[static_cast<size_t>(n) * K + l] * be;
        const R al = own ? a[static_cast<size_t>(n - 1) * K + l] : R(0);
        R e[2] = {R(0), R(0)};
        R* g = gbuf + par * Kv;
        par ^= 1;
        if (own) g[l] = gl;
        __syncthreads();
        if (own) {
          int k = 0;
          for (; k + 2 <= K; k += 2) {
            const R g0 = g[k], g1 = g[k + 1];
            e[0] = Real<R>::fma(A[k * Ka + l], g0, e[0]);
            e[1] = Real<R>::fma(A[(k + 1) * Ka + l], g1, e[1]);
            if (!kFinal) {
              S[k * K + l] = Real<R>::fma(g0, al, S[k * K + l]);
              S[(k + 1) * K + l] = Real<R>::fma(g1, al, S[(k + 1) * K + l]);
            }
          }
          if (k < K) {
            e[0] = Real<R>::fma(A[k * Ka + l], g[k], e[0]);
            if (!kFinal) S[k * K + l] = Real<R>::fma(g[k], al, S[k * K + l]);
          }
        }
        if (own) be = e[0] + e[1];
      } else if (kFinal && own) {
        rd[static_cast<size_t>(n) * K + l] = R(0);
      }
    }
  }
  return be;
}

// One forward-backward of the fixpoint (kFinal false: S accumulated) or
// the final one (r written): returns be_0 of the thread's topic.
template <bool kFinal, typename R>
__device__ __forceinline__ R hm_pass(const R* A, const R* betaT, const int* tb,
                                     const R* mb, R p0, R* a, R* c,
                                     R* red, R* S, R* gbuf, R* rd, int last,
                                     int K, int nw) {
  hm_forward<false>(A, betaT, tb, mb, p0, a, c, red, last, K, nw);
  return hm_backward<kFinal>(A, betaT, tb, mb, a, c, S, gbuf, rd, last, K);
}

// R = float: the float32 mode; R = double: the float64 mode.
template <typename R>
__global__ void __launch_bounds__(kHmMaxThreads, kHmBlocks) hmtm_estep_kernel(
    const R* __restrict__ betaT,     // [V, K] beta^T + eps
    const int* __restrict__ terms,   // [B, L]
    const R* __restrict__ tmask,     // [B, L] 1 on real tokens
    const R* __restrict__ doc_mask,  // [B]
    const R* __restrict__ eta,       // [K]
    const R* __restrict__ alpha,     // [K, K]
    const R* __restrict__ tau_in,    // [B, K]
    const R* __restrict__ gamma_in,  // [B, K, K]
    R* __restrict__ tau_out, R* __restrict__ gamma_out,
    R* __restrict__ r,               // [B, L, K]
    R* scratch,                      // [B, per_doc] when mode > 0
    int64_t per_doc, int L, int K, int mode, int viter, R vtol) {
  extern __shared__ __align__(16) unsigned char hm_smem_raw[];
  R* smem = reinterpret_cast<R*>(hm_smem_raw);
  const int b = blockIdx.x, tid = threadIdx.x, nw = blockDim.x >> 5;
  const int Ka = hm_stride(K), Kv = blockDim.x;
  const bool own = tid < K;
  R* A = smem;
  R* gbuf = A + static_cast<size_t>(K) * Ka;   // [2, Kv]
  R* red = gbuf + 2 * Kv;                       // [32]: c, |dgamma|^2, sum tau, last
  R* rest = red + 32;
  R* scr = scratch + static_cast<size_t>(b) * per_doc;
  R *S, *a;
  if (mode == 0) {
    S = rest;
    a = S + K * K;
  } else if (mode == 1) {
    S = rest;
    a = scr;
  } else {
    S = scr;
    a = scr + K * K;
  }
  R* c = a + static_cast<size_t>(L) * K;
  const int* tb = terms + static_cast<size_t>(b) * L;
  const R* mb = tmask + static_cast<size_t>(b) * L;
  const size_t dk = static_cast<size_t>(b) * K, dkk = dk * K;
  R* rd = r + static_cast<size_t>(b) * L * K;

  const int last = hm_last(mb, L, red + 24, nw);
  hm_build_A(gamma_in + dkk, A, S, K);
  if (own)
    for (int i = 0; i < K; ++i) {
      gamma_out[dkk + i * K + tid] = gamma_in[dkk + i * K + tid];
      S[i * K + tid] = R(0);
    }
  R tau = own ? tau_in[dk + tid] : R(0);
  if (own) tau_out[dk + tid] = tau;
  R p0 = hm_p0(tau, own, red + 16, nw);
  const R eta_i = own ? eta[tid] : R(0);
  __syncthreads();

  bool active = doc_mask[b] > R(0);
  for (int it = 0; it < viter && active; ++it) {
    const R be0 = hm_pass<false>(A, betaT, tb, mb, p0, a, c, red, S, gbuf,
                                 static_cast<R*>(nullptr), last, K, nw);
    // tau = eta + r_0; gamma = alpha + A o S, column l by thread l, staged
    // in S for the new A
    R d2 = R(0), cs = R(0);
    if (own) {
      tau = eta_i + a[tid] * be0 * mb[0];
      for (int i = 0; i < K; ++i) {
        const size_t o = dkk + i * K + tid;
        const R gn = alpha[i * K + tid] + A[i * Ka + tid] * S[i * K + tid];
        const R d = gn - gamma_out[o];
        d2 = Real<R>::fma(d, d, d2);
        gamma_out[o] = gn;
        S[i * K + tid] = gn;
        cs += gn;
      }
      tau_out[dk + tid] = tau;
    }
    const R delta2 = hm_sum(d2, red + 8, nw);
    if (own) {
      const R dcs = hm_psi(cs);
      for (int i = 0; i < K; ++i) {
        A[i * Ka + tid] = Real<R>::exp(hm_psi(S[i * K + tid]) - dcs);
        S[i * K + tid] = R(0);
      }
    }
    p0 = hm_p0(tau, own, red + 16, nw);
    active = hm_sqrt(delta2) >= vtol;
    __syncthreads();   // the new A complete before the next forward
  }

  // q(z_n) from the final state, on every row
  const R be0 = hm_pass<true>(A, betaT, tb, mb, p0, a, c, red, S, gbuf, rd, last, K, nw);
  if (own) rd[tid] = a[tid] * be0 * mb[0];
  const int tail = last + 1 > 1 ? last + 1 : 1;
  for (size_t idx = tid; idx < static_cast<size_t>(L - tail) * K; idx += blockDim.x)
    rd[static_cast<size_t>(tail) * K + idx] = R(0);
}

template <typename R>
__global__ void __launch_bounds__(kHmMaxThreads, kHmBlocks) hmtm_logz_kernel(
    const R* __restrict__ betaT, const int* __restrict__ terms,
    const R* __restrict__ tmask, const R* __restrict__ tau,
    const R* __restrict__ gamma, R* __restrict__ logz, int L, int K) {
  extern __shared__ __align__(16) unsigned char hm_smem_raw[];
  R* smem = reinterpret_cast<R*>(hm_smem_raw);
  const int b = blockIdx.x, tid = threadIdx.x, nw = blockDim.x >> 5;
  const bool own = tid < K;
  R* A = smem;
  R* ring = A + static_cast<size_t>(K) * hm_stride(K);   // [2, Kv]
  R* red = ring + 2 * blockDim.x;
  const int* tb = terms + static_cast<size_t>(b) * L;
  const R* mb = tmask + static_cast<size_t>(b) * L;
  const int last = hm_last(mb, L, red + 24, nw);
  hm_build_A(gamma + static_cast<size_t>(b) * K * K, A, static_cast<R*>(nullptr), K);
  const R p0 = hm_p0(own ? tau[static_cast<size_t>(b) * K + tid] : R(0), own, red + 16, nw);
  __syncthreads();
  const R z = hm_forward<true>(A, betaT, tb, mb, p0, ring, static_cast<R*>(nullptr), red, last,
                               K, nw);
  if (tid == 0) logz[b] = z;
}

// ---- K <= 32: the split schedule (hmtm_estep_split_kernel,
// hmtm_logz_split_kernel) ----

template <typename R>
struct HsBlocks;   // blocks an SM must hold: the registers' cap (65,536 / (64 x blocks))
template <>
struct HsBlocks<float> { static constexpr int v = 8; };   // <= 128 registers: 8 documents an SM
template <>
struct HsBlocks<double> { static constexpr int v = 4; };

// The two warps meet: a named barrier of the block's 64 threads (the warps
// reach it from different code).
__device__ __forceinline__ void hs_sync() { asm volatile("bar.sync 1, 64;" ::: "memory"); }

// The last real slot of a document, -1 when it has none; the same in both
// warps, each of which computes it.
template <typename R>
__device__ __forceinline__ int hs_last(const R* mb, int L) {
  int last = -1;
  for (int n = threadIdx.x & 31; n < L; n += 32)
    if (mb[n] > R(0)) last = n;
  return __reduce_max_sync(0xffffffffu, last);
}

// x[l] = lane l's `own` for l < W: a store to this warp's row and W / 4
// vector loads of it after __syncwarp (the row alternates between two, so
// a step's store cannot meet the last step's loads).  W shuffles were
// slower (PERF.md).
template <int W, typename R>
__device__ __forceinline__ void hs_bcast(R own, R* rows, int& par, R (&x)[W]) {
  R* row = rows + 32 * par;
  par ^= 1;
  row[threadIdx.x & 31] = own;
  __syncwarp();
  const typename Real<R>::V4* q = reinterpret_cast<const typename Real<R>::V4*>(row);
#pragma unroll
  for (int j = 0; j < W / 4; ++j) {
    const typename Real<R>::V4 v = q[j];
    x[4 * j] = v.x;
    x[4 * j + 1] = v.y;
    x[4 * j + 2] = v.z;
    x[4 * j + 3] = v.w;
  }
}

// sum_l x[l] over four accumulators: every lane adds the same values in
// the same order, so every lane holds the same bits
template <int W, typename R>
__device__ __forceinline__ R hs_sum(const R (&x)[W]) {
  R s0 = R(0), s1 = R(0), s2 = R(0), s3 = R(0);
#pragma unroll
  for (int l = 0; l < W; l += 4) {
    s0 += x[l];
    s1 += x[l + 1];
    s2 += x[l + 2];
    s3 += x[l + 3];
  }
  return (s0 + s1) + (s2 + s3);
}

// 1 / x: the special-function unit's reciprocal in float32 (no branch; a
// normaliser's rounding cancels in r and S and moves logZ by an ulp a
// step), the IEEE division in float64
__device__ __forceinline__ float hs_rcp(float x) { return __fdividef(1.0f, x); }
__device__ __forceinline__ double hs_rcp(double x) { return 1.0 / x; }

// sum_l m[l] x[l] over four accumulators
template <int W, typename R>
__device__ __forceinline__ R hs_dot(const R (&m)[W], const R (&x)[W]) {
  R s0 = R(0), s1 = R(0), s2 = R(0), s3 = R(0);
#pragma unroll
  for (int l = 0; l < W; l += 4) {
    s0 = Real<R>::fma(m[l], x[l], s0);
    s1 = Real<R>::fma(m[l + 1], x[l + 1], s1);
    s2 = Real<R>::fma(m[l + 2], x[l + 2], s2);
    s3 = Real<R>::fma(m[l + 3], x[l + 3], s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// What a step reads of a slot ahead: the lane's emission entry b and the
// mask m.
template <typename R>
struct HsSlot {
  R b, m;
};

// Calls step(n, slot) for the `count` slots first, first + dir, ..., with
// each slot fetched (fetch(n)) one step ahead.  The loop is not unrolled:
// the step's code stays one copy.  Deeper prefetches were slower (PERF.md):
// register rings, unrolled or not, the term id two steps ahead, and a
// cp.async ring of entries in shared memory all cost more instructions or
// registers than the latency they hid.
template <typename Fetch, typename Step>
__device__ __forceinline__ void hs_walk(int first, int count, int dir, Fetch fetch, Step step) {
  if (count <= 0) return;
  auto next = fetch(first);
#pragma unroll 1
  for (int k = 0; k < count; ++k) {
    const auto s = next;
    if (k + 1 < count) next = fetch(first + dir * (k + 1));
    step(first + dir * k, s);
  }
}

// The lane's row (kRow) or column of A, zero past K.
template <bool kRow, int W, typename R>
__device__ __forceinline__ void hs_load_A(const R* A, int K, R (&m)[W]) {
  const int lane = threadIdx.x & 31, Ka = hm_stride(K);
#pragma unroll
  for (int j = 0; j < W; ++j)
    m[j] = (lane < K && j < K) ? (kRow ? A[lane * Ka + j] : A[j * Ka + lane]) : R(0);
}

// A [i, l] = exp(psi(g[i, l]) - dcs[l]) over the block's 64 threads.
template <typename R>
__device__ __forceinline__ void hs_build_A(const R* g, const R* dcs, R* A, int K) {
  const int Ka = hm_stride(K);
  for (int idx = threadIdx.x; idx < K * K; idx += kHsThreads) {
    const int i = idx / K, l = idx - i * K;
    A[i * Ka + l] = Real<R>::exp(hm_psi(g[idx]) - dcs[l]);
  }
}

// Column lane of gamma [K, K]: psi of its sum into dcs[lane] (the sum in
// row order), and the column copied to `copy` when given.
template <typename R>
__device__ __forceinline__ void hs_colsum(const R* g, R* copy, R* dcs, int K) {
  const int l = threadIdx.x & 31;
  if (l >= K) return;
  R cs = R(0);
  for (int i = 0; i < K; ++i) {
    const R v = g[i * K + l];
    if (copy != nullptr) copy[i * K + l] = v;
    cs += v;
  }
  dcs[l] = hm_psi(cs);
}

// p0[lane] = exp(psi(tau) - psi(sum tau)) over one warp.
template <typename R>
__device__ __forceinline__ void hs_p0(R tau, R* p0, int K) {
  const int l = threadIdx.x & 31;
  const R ts = warp_sum(l < K ? tau : R(0));
  if (l < K) p0[l] = Real<R>::exp(hm_psi(tau) - hm_psi(ts));
}

// One document a block of two warps.  Each pass runs the forward chain
// (warp 0, lane i topic i: F_n = B_n (A F_{n-1}) / C_{n-1}, C = sum F +
// eps) and the backward chain normalised by its own sums (warp 1, lane l
// topic l: v_n = B_n bt_n, bt_{n-1} = A^T v_n / (sum v_n + eps)) at once.
// Up to mid = last / 2 the forward stores F_n and the backward v_n for n >
// mid, in the same [L, K] rows; past it each warp combines its message
// with the other's stored one (the second half of the forward meets v_n,
// of the backward F_{n-1}):
//   E = (A F_{n-1}) . v_n,  r_n = (A F_{n-1}) o v_n / E,
//   S[i, l] += v_n[i] F_{n-1}[l] / E
// (the forward's S by rows, the backward's by columns).  JAX's
// a_n . be_n is s = sum a_last, 1 but for eps / C_last: S, r_0 and, in
// the final pass, the r rows are scaled by it at the end.
template <typename R, int W>
__global__ void __launch_bounds__(kHsThreads, HsBlocks<R>::v) hmtm_estep_split_kernel(
    const R* __restrict__ betaT, const int* __restrict__ terms, const R* __restrict__ tmask,
    const R* __restrict__ doc_mask, const R* __restrict__ eta, const R* __restrict__ alpha,
    const R* __restrict__ tau_in, const R* __restrict__ gamma_in, R* __restrict__ tau_out,
    R* __restrict__ gamma_out, R* __restrict__ r, R* scratch, int L, int K, int mode, int viter,
    R vtol) {
  extern __shared__ __align__(16) unsigned char hm_smem_raw[];
  R* sm = reinterpret_cast<R*>(hm_smem_raw);
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Ka = hm_stride(K);
  const bool own = lane < K;
  R* rows = sm + 64 * warp;   // this warp's two broadcast rows
  R* red = sm + 128;          // [0] s, [1] |dgamma|^2
  R* p0 = red + 32;
  R* dcs = p0 + 32;
  R* A = dcs + 32;
  R* G = A + K * Ka;
  R* msg = mode == 0 ? G + K * K : scratch + static_cast<size_t>(b) * L * K;
  const int* tb = terms + static_cast<size_t>(b) * L;
  const R* mb = tmask + static_cast<size_t>(b) * L;
  const size_t dk = static_cast<size_t>(b) * K, dkk = dk * K;
  R* rd = r + static_cast<size_t>(b) * L * K;
  const int last = hs_last(mb, L);
  const int mid = last > 0 ? last >> 1 : 0;

  auto entry = [&](int n) { return own ? betaT[static_cast<size_t>(tb[n]) * K + lane] : R(0); };
  auto plain = [&](int n) { return HsSlot<R>{entry(n), mb[n]}; };

  if (warp == 1) {
    const R tau = own ? tau_in[dk + lane] : R(0);
    hs_colsum(gamma_in + dkk, gamma_out + dkk, dcs, K);
    if (own) tau_out[dk + lane] = tau;
    hs_p0(tau, p0, K);
  }
  hs_sync();
  hs_build_A(gamma_in + dkk, dcs, A, K);
  hs_sync();

  // The fixpoint's passes while the document is active, then the final
  // pass (S accumulated, or the r rows written).  Each warp runs its own
  // loop, so that its arrays live in its code alone, and meets the other
  // at the same barriers: the middle and the end of a pass, and twice in
  // the update between passes.
  bool active = doc_mask[b] > R(0);
  auto next = [&]() {   // both warps: the new A, and whether to go on
    hs_sync();
    hs_build_A(G, dcs, A, K);
    active = hm_sqrt(red[1]) >= vtol;
    hs_sync();   // the new A and p0 complete before the next pass
  };
  int par = 0;
  R x[W];
  if (warp == 0) {
    R arow[W], srow[W];
    for (int it = 0;; ++it) {
      const bool final_pass = !(it < viter && active);
      hs_load_A<true>(A, K, arow);
#pragma unroll
      for (int j = 0; j < W; ++j) srow[j] = R(0);
      const R m0 = mb[0];
      R F = own ? (m0 > R(0) ? p0[lane] * entry(0) : p0[lane]) : R(0);
      if (own) msg[lane] = F;
      hs_walk(1, mid, 1, plain, [&](int n, const HsSlot<R>& s) {
        if (s.m > R(0)) {
          hs_bcast(F, rows, par, x);
          const R rC = hs_rcp(hs_sum(x) + Real<R>::eps);   // beside the product
          F = hs_dot(arow, x) * (s.b * rC);
        }
        if (own) msg[static_cast<size_t>(n) * K + lane] = F;
      });
      hs_sync();   // the middle: the backward's v_n stored for n > mid
      hs_walk(mid + 1, last - mid, 1, plain, [&](int n, const HsSlot<R>& s) {
        if (s.m > R(0)) {
          const R vn = own ? msg[static_cast<size_t>(n) * K + lane] : R(0);
          hs_bcast(F, rows, par, x);
          const R rC = hs_rcp(hs_sum(x) + Real<R>::eps);
          const R p = hs_dot(arow, x);
          F = p * (s.b * rC);
          const R e = (p * rC) * vn;   // (A a_{n-1}) o v_n: no product leaves f32's range
          const R rE = hs_rcp(warp_sum(e));
          if (final_pass) {
            if (own) rd[static_cast<size_t>(n) * K + lane] = e * rE;
          } else {
            const R kap = (vn * rE) * rC;
#pragma unroll
            for (int l = 0; l < W; ++l) srow[l] = Real<R>::fma(kap, x[l], srow[l]);
          }
        } else if (final_pass && own) {
          rd[static_cast<size_t>(n) * K + lane] = R(0);
        }
      });
      const R tot = warp_sum(F);
      if (lane == 0) red[0] = tot / (tot + Real<R>::eps);
      if (!final_pass && own)
#pragma unroll
        for (int l = 0; l < W; ++l)
          if (l < K) G[lane * K + l] = srow[l];
      hs_sync();   // both halves done: s in red[0], the forward's S in G
      if (final_pass) break;
      next();
    }
  } else {
    R acol[W], scol[W];
    R tau = own ? tau_in[dk + lane] : R(0);
    for (int it = 0;; ++it) {
      const bool final_pass = !(it < viter && active);
      hs_load_A<false>(A, K, acol);
#pragma unroll
      for (int j = 0; j < W; ++j) scol[j] = R(0);
      R bt = own ? R(1) : R(0);
      hs_walk(last, last - mid, -1, plain, [&](int n, const HsSlot<R>& s) {
        if (s.m > R(0)) {
          const R v = s.b * bt;
          if (own) msg[static_cast<size_t>(n) * K + lane] = v;
          hs_bcast(v, rows, par, x);
          const R rN = hs_rcp(hs_sum(x) + Real<R>::eps);   // beside the product
          bt = hs_dot(acol, x) * rN;
        }
      });
      hs_sync();   // the middle: the forward's F_n stored for n <= mid
      // slot mid: r_mid = F_mid o bt_mid / (F_mid . bt_mid)
      const R fm = own ? msg[static_cast<size_t>(mid) * K + lane] : R(0);
      R rc = fm * bt / warp_sum(fm * bt) * mb[mid];
      if (final_pass && own) rd[static_cast<size_t>(mid) * K + lane] = rc;
      hs_walk(mid, mid, -1, plain, [&](int n, const HsSlot<R>& s) {
        const R fp = own ? msg[static_cast<size_t>(n - 1) * K + lane] : R(0);   // F_{n-1}
        const R mp = mb[n - 1];
        if (s.m > R(0)) {
          const R v = s.b * bt;
          hs_bcast(v, rows, par, x);
          const R rN = hs_rcp(hs_sum(x) + Real<R>::eps);
          bt = hs_dot(acol, x) * rN;
          const R e = fp * bt;   // F_{n-1} o bt_{n-1}: no product leaves f32's range
          const R rD = hs_rcp(warp_sum(e));
          rc = e * rD * mp;
          if (!final_pass) {
            const R kap = (fp * rD) * rN;
#pragma unroll
            for (int i = 0; i < W; ++i) scol[i] = Real<R>::fma(x[i], kap, scol[i]);
          }
        } else if (final_pass || n == 1) {
          const R e = fp * bt;
          rc = e * hs_rcp(warp_sum(e)) * mp;
        }
        if (final_pass && own) rd[static_cast<size_t>(n - 1) * K + lane] = rc;
      });
      hs_sync();   // both halves done: s in red[0], the forward's S in G
      if (final_pass) break;
      // tau = eta + s r_0, gamma = alpha + A o (s S), column l by lane l,
      // staged in G for the new A
      const R s = red[0];
      R d2 = R(0), cs = R(0);
      if (own) {
        tau = eta[lane] + s * rc;
        tau_out[dk + lane] = tau;
#pragma unroll
        for (int i = 0; i < W; ++i) {
          if (i < K) {
            const size_t o = dkk + i * K + lane;
            const R gn = alpha[i * K + lane] + A[i * Ka + lane] * ((G[i * K + lane] + scol[i]) * s);
            const R d = gn - gamma_out[o];
            d2 = Real<R>::fma(d, d, d2);
            gamma_out[o] = gn;
            G[i * K + lane] = gn;
            cs += gn;
          }
        }
        dcs[lane] = hm_psi(cs);
      }
      hs_p0(tau, p0, K);
      const R delta2 = warp_sum(d2);
      if (lane == 0) red[1] = delta2;
      next();
    }
  }

  // q(z_n) from the final state on every row: the halves' rows scaled by s
  // (when eps moved it off 1), zeros past the last real slot
  const R s = red[0];
  if (s != R(1))
    for (int idx = threadIdx.x; idx < (last + 1) * K; idx += kHsThreads) rd[idx] *= s;
  const int tail = last + 1 > 1 ? last + 1 : 1;
  for (size_t idx = threadIdx.x; idx < static_cast<size_t>(L - tail) * K; idx += kHsThreads)
    rd[static_cast<size_t>(tail) * K + idx] = R(0);
}

// logZ by the two halves: the forward to mid (sum of log C over its real
// slots), the backward from last down to mid + 1 (sum of log N), and
// log(a_mid . bt_mid) where they meet.  The backward carries bs, its
// message of the forward's eps (a sink every message leaks eps / C into),
// so that the product is JAX's sum of log c_n, eps included.
template <typename R, int W>
__global__ void __launch_bounds__(kHsThreads, HsBlocks<R>::v) hmtm_logz_split_kernel(
    const R* __restrict__ betaT, const int* __restrict__ terms, const R* __restrict__ tmask,
    const R* __restrict__ tau, const R* __restrict__ gamma, R* __restrict__ logz, int L,
    int K) {
  extern __shared__ __align__(16) unsigned char hm_smem_raw[];
  R* sm = reinterpret_cast<R*>(hm_smem_raw);
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool own = lane < K;
  R* rows = sm + 64 * warp;
  R* red = sm + 128;   // [0] C_mid, [1] the forward's sum of log C
  R* p0 = red + 32;
  R* dcs = p0 + 32;
  R* A = dcs + 32;
  R* fmid = A + K * hm_stride(K);
  const int* tb = terms + static_cast<size_t>(b) * L;
  const R* mb = tmask + static_cast<size_t>(b) * L;
  const int last = hs_last(mb, L);
  if (last < 0) {   // no real slot: logZ is 0
    if (threadIdx.x == 0) logz[b] = R(0);
    return;
  }
  const int mid = last >> 1;
  auto entry = [&](int n) { return own ? betaT[static_cast<size_t>(tb[n]) * K + lane] : R(0); };
  auto plain = [&](int n) { return HsSlot<R>{entry(n), mb[n]}; };
  const R* gd = gamma + static_cast<size_t>(b) * K * K;
  if (warp == 1)
    hs_colsum(gd, static_cast<R*>(nullptr), dcs, K);
  else
    hs_p0(own ? tau[static_cast<size_t>(b) * K + lane] : R(0), p0, K);
  hs_sync();
  hs_build_A(gd, dcs, A, K);
  hs_sync();

  int par = 0;
  R x[W];
  if (warp == 0) {
    R arow[W];
    hs_load_A<true>(A, K, arow);
    const R m0 = mb[0];
    R F = own ? (m0 > R(0) ? p0[lane] * entry(0) : p0[lane]) : R(0);
    bool logged = m0 > R(0);   // F comes from a real slot: its C is a c_n
    R lz = R(0);
    hs_walk(1, mid, 1, plain, [&](int n, const HsSlot<R>& s) {
      if (s.m > R(0)) {
        hs_bcast(F, rows, par, x);
        const R C = hs_sum(x) + Real<R>::eps;
        if (logged) lz += Real<R>::log(C);
        F = hs_dot(arow, x) * (s.b * hs_rcp(C));
        logged = true;
      }
    });
    const R C = warp_sum(F) + Real<R>::eps;
    if (logged) lz += Real<R>::log(C);
    if (own) fmid[lane] = F;
    if (lane == 0) {
      red[0] = C;
      red[1] = lz;
    }
    hs_sync();
  } else {
    R acol[W];
    hs_load_A<false>(A, K, acol);
    R bt = own ? R(1) : R(0), bs = R(1), lz = R(0);
    hs_walk(last, last - mid, -1, plain, [&](int n, const HsSlot<R>& s) {
      if (s.m > R(0)) {
        const R v = s.b * bt;
        hs_bcast(v, rows, par, x);
        const R N = hs_sum(x) + Real<R>::eps;
        const R rN = hs_rcp(N);
        bt = Real<R>::fma(Real<R>::eps, bs, hs_dot(acol, x)) * rN;
        bs = Real<R>::eps * bs * rN;
        lz += Real<R>::log(N);
      }
    });
    hs_sync();
    const R fm = own ? fmid[lane] : R(0);
    const R z = Real<R>::fma(Real<R>::eps, bs, warp_sum(fm * bt)) / red[0];
    if (lane == 0) logz[b] = red[1] + lz + Real<R>::log(z);
  }
}

// ---- the wide mode: everything per document in the device scratch ----

// A [i, l] and, when AT is given, A^T [l, i] = A [i, l] from gamma of one
// document [K, K]: the thread of column l (l = tid, tid + blockDim, ...)
// reads the column twice, as the shared-memory modes do.  With A NULL only
// A^T is written (hmtm_logz).
template <typename R>
__device__ __forceinline__ void hmw_build(const R* gd, R* A, R* AT, int K) {
  for (int l = threadIdx.x; l < K; l += blockDim.x) {
    R cs = 0;
    for (int i = 0; i < K; ++i) cs += gd[static_cast<size_t>(i) * K + l];
    const R dcs = hm_psi(cs);
    for (int i = 0; i < K; ++i) {
      const R v = Real<R>::exp(hm_psi(gd[static_cast<size_t>(i) * K + l]) - dcs);
      if (A != nullptr) A[static_cast<size_t>(i) * K + l] = v;
      AT[static_cast<size_t>(l) * K + i] = v;
    }
  }
}

// p0[i] = exp(psi(tau_i) - psi(sum tau)) for the thread's topics, the sum
// over the block in the thread's topic order, then warps in order.
template <typename R>
__device__ __forceinline__ void hmw_p0(const R* tau, R* p0, R* red, int K, int nw) {
  R part = 0;
  for (int i = threadIdx.x; i < K; i += blockDim.x) part += tau[i];
  const R dts = hm_psi(hm_sum(part, red, nw));
  for (int i = threadIdx.x; i < K; i += blockDim.x) p0[i] = Real<R>::exp(hm_psi(tau[i]) - dts);
}

// The wide forward pass over slots 0 .. last: row n of the messages at
// `a + (ring ? n & 1 : n) * K`, its scaler c[n] (c may be NULL); (A a)_i
// from A^T's column of topic i over four accumulators, the previous row
// read back after the step's barrier.  Returns logZ, the same in every
// thread; ends with a barrier.
template <bool kRing, typename R>
__device__ __forceinline__ R hmw_forward(const R* AT, const R* __restrict__ betaT,
                                         const int* tb, const R* mb, const R* p0, R* a, R* c,
                                         R* red, int last, int K, int nw) {
  const int tid = threadIdx.x, nt = blockDim.x;
  auto row = [&](int n) { return a + static_cast<size_t>(kRing ? (n & 1) : n) * K; };
  const R m0 = mb[0];
  R part = 0;
  for (int i = tid; i < K; i += nt) {
    const R f = m0 > R(0) ? p0[i] * betaT[static_cast<size_t>(tb[0]) * K + i] : p0[i];
    a[i] = f;
    part += f;
  }
  const R c0 = hm_sum(part, red, nw) + Real<R>::eps;
  for (int i = tid; i < K; i += nt) a[i] = a[i] / c0;
  if (c != nullptr && tid == 0) c[0] = m0 > R(0) ? c0 : R(1);
  R logz = m0 > R(0) ? Real<R>::log(c0) : R(0);
  __syncthreads();
  for (int n = 1; n <= last; ++n) {
    const R* ap = row(n - 1);
    R* an = row(n);
    if (mb[n] > R(0)) {
      const size_t tn = static_cast<size_t>(tb[n]) * K;
      R fpart = 0;
      for (int i = tid; i < K; i += nt) {
        R s[4] = {R(0), R(0), R(0), R(0)};
        const R* col = AT + i;
        int l = 0;
        for (; l + 4 <= K; l += 4) {
          s[0] = Real<R>::fma(col[static_cast<size_t>(l) * K], ap[l], s[0]);
          s[1] = Real<R>::fma(col[static_cast<size_t>(l + 1) * K], ap[l + 1], s[1]);
          s[2] = Real<R>::fma(col[static_cast<size_t>(l + 2) * K], ap[l + 2], s[2]);
          s[3] = Real<R>::fma(col[static_cast<size_t>(l + 3) * K], ap[l + 3], s[3]);
        }
        for (; l < K; ++l) s[0] = Real<R>::fma(col[static_cast<size_t>(l) * K], ap[l], s[0]);
        const R f = betaT[tn + i] * ((s[0] + s[1]) + (s[2] + s[3]));
        an[i] = f;
        fpart += f;
      }
      const R cn = hm_sum(fpart, red, nw) + Real<R>::eps;
      for (int i = tid; i < K; i += nt) an[i] = an[i] / cn;
      if (c != nullptr && tid == 0) c[n] = cn;
      logz += Real<R>::log(cn);
    } else {
      for (int i = tid; i < K; i += nt) an[i] = ap[i];
      if (c != nullptr && tid == 0) c[n] = R(1);
    }
    __syncthreads();
  }
  return logz;
}

// The wide backward pass over slots last .. 1: be [K] ends as be_0.  The
// thread of topic i forms g_n[i] into g (two rows, flipped on every real
// slot: each has a barrier between its write and the reads); the thread of
// column l sums (A^T g)_l from A's column over two accumulators and, unless
// kFinal, adds g_n[i] a_{n-1}[l] to S[i, l]; kFinal writes r rows 1 ..
// last (0 on padding).
template <bool kFinal, typename R>
__device__ __forceinline__ void hmw_backward(const R* A, const R* __restrict__ betaT,
                                             const int* tb, const R* mb, const R* a, const R* c,
                                             R* S, R* g, R* be, R* rd, int last, int K) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int l = tid; l < K; l += nt) be[l] = R(1);
  int par = 0;
  for (int n = last; n >= 1; --n) {
    if (mb[n] > R(0)) {
      const size_t tn = static_cast<size_t>(tb[n]) * K;
      const R cn = c[n];
      R* gp = g + static_cast<size_t>(par) * K;
      par ^= 1;
      for (int i = tid; i < K; i += nt) {
        gp[i] = (betaT[tn + i] * be[i]) / cn;
        if (kFinal) rd[static_cast<size_t>(n) * K + i] = a[static_cast<size_t>(n) * K + i] * be[i];
      }
      __syncthreads();
      for (int l = tid; l < K; l += nt) {
        const R al = a[static_cast<size_t>(n - 1) * K + l];
        R e0 = 0, e1 = 0;
        int k = 0;
        for (; k + 2 <= K; k += 2) {
          const R g0 = gp[k], g1 = gp[k + 1];
          const size_t o0 = static_cast<size_t>(k) * K + l, o1 = o0 + K;
          e0 = Real<R>::fma(A[o0], g0, e0);
          e1 = Real<R>::fma(A[o1], g1, e1);
          if (!kFinal) {
            S[o0] = Real<R>::fma(g0, al, S[o0]);
            S[o1] = Real<R>::fma(g1, al, S[o1]);
          }
        }
        if (k < K) {
          const size_t o0 = static_cast<size_t>(k) * K + l;
          e0 = Real<R>::fma(A[o0], gp[k], e0);
          if (!kFinal) S[o0] = Real<R>::fma(gp[k], al, S[o0]);
        }
        be[l] = e0 + e1;
      }
    } else if (kFinal) {
      for (int l = tid; l < K; l += nt) rd[static_cast<size_t>(n) * K + l] = R(0);
    }
  }
}

template <typename R>
__global__ void __launch_bounds__(kHmMaxThreads) hmtm_estep_wide_kernel(
    const R* __restrict__ betaT,     // [V, K] beta^T + eps
    const int* __restrict__ terms,   // [B, L]
    const R* __restrict__ tmask,     // [B, L] 1 on real tokens
    const R* __restrict__ doc_mask,  // [B]
    const R* __restrict__ eta,       // [K]
    const R* __restrict__ alpha,     // [K, K]
    const R* __restrict__ tau_in,    // [B, K]
    const R* __restrict__ gamma_in,  // [B, K, K]
    R* __restrict__ tau_out, R* __restrict__ gamma_out,
    R* __restrict__ r,               // [B, L, K]
    R* scratch,                      // [B, per_doc]
    int64_t per_doc, int L, int K, int viter, R vtol) {
  extern __shared__ __align__(16) unsigned char hm_smem_raw[];
  R* red = reinterpret_cast<R*>(hm_smem_raw);   // [32]: c, |dgamma|^2, sum tau, last
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, nw = nt >> 5;
  const size_t KK = static_cast<size_t>(K) * K;
  R* A = scratch + static_cast<size_t>(b) * static_cast<size_t>(per_doc);
  R* AT = A + KK;
  R* S = AT + KK;
  R* a = S + KK;                             // [L, K]
  R* c = a + static_cast<size_t>(L) * K;     // [L]
  R* g = c + L;                              // [2, K]
  R* be = g + 2 * static_cast<size_t>(K);    // [K]
  R* p0 = be + K;                            // [K]
  R* cs = p0 + K;                            // [K]
  const int* tb = terms + static_cast<size_t>(b) * L;
  const R* mb = tmask + static_cast<size_t>(b) * L;
  const size_t dk = static_cast<size_t>(b) * K, dkk = static_cast<size_t>(b) * KK;
  R* rd = r + static_cast<size_t>(b) * L * K;
  R* taud = tau_out + dk;
  R* gd = gamma_out + dkk;

  const int last = hm_last(mb, L, red + 24, nw);
  hmw_build(gamma_in + dkk, A, AT, K);
  for (size_t o = tid; o < KK; o += nt) {
    gd[o] = gamma_in[dkk + o];
    S[o] = R(0);
  }
  for (int i = tid; i < K; i += nt) taud[i] = tau_in[dk + i];
  hmw_p0(taud, p0, red + 16, K, nw);
  __syncthreads();

  bool active = doc_mask[b] > R(0);
  for (int it = 0; it < viter && active; ++it) {
    hmw_forward<false>(AT, betaT, tb, mb, p0, a, c, red, last, K, nw);
    hmw_backward<false>(A, betaT, tb, mb, a, c, S, g, be, static_cast<R*>(nullptr), last, K);
    // tau = eta + r_0; gamma = alpha + A o S by the column's thread, staged
    // in S for the new A and A^T
    R d2 = R(0);
    for (int i = tid; i < K; i += nt) taud[i] = eta[i] + a[i] * be[i] * mb[0];
    for (int l = tid; l < K; l += nt) {
      R csl = R(0);
      for (int i = 0; i < K; ++i) {
        const size_t o = static_cast<size_t>(i) * K + l;
        const R gn = alpha[o] + A[o] * S[o];
        const R d = gn - gd[o];
        d2 = Real<R>::fma(d, d, d2);
        gd[o] = gn;
        S[o] = gn;
        csl += gn;
      }
      cs[l] = csl;
    }
    const R delta2 = hm_sum(d2, red + 8, nw);
    for (int l = tid; l < K; l += nt) {
      const R dcs = hm_psi(cs[l]);
      for (int i = 0; i < K; ++i) {
        const size_t o = static_cast<size_t>(i) * K + l;
        const R v = Real<R>::exp(hm_psi(S[o]) - dcs);
        A[o] = v;
        AT[static_cast<size_t>(l) * K + i] = v;
        S[o] = R(0);
      }
    }
    hmw_p0(taud, p0, red + 16, K, nw);
    active = hm_sqrt(delta2) >= vtol;
    __syncthreads();   // the new A, A^T and p0 complete before the next forward
  }

  // q(z_n) from the final state, on every row
  hmw_forward<false>(AT, betaT, tb, mb, p0, a, c, red, last, K, nw);
  hmw_backward<true>(A, betaT, tb, mb, a, c, S, g, be, rd, last, K);
  for (int i = tid; i < K; i += nt) rd[i] = a[i] * be[i] * mb[0];
  const int tail = last + 1 > 1 ? last + 1 : 1;
  for (size_t idx = tid; idx < static_cast<size_t>(L - tail) * K; idx += nt)
    rd[static_cast<size_t>(tail) * K + idx] = R(0);
}

template <typename R>
__global__ void __launch_bounds__(kHmMaxThreads) hmtm_logz_wide_kernel(
    const R* __restrict__ betaT, const int* __restrict__ terms,
    const R* __restrict__ tmask, const R* __restrict__ tau,
    const R* __restrict__ gamma, R* __restrict__ logz, R* scratch, int64_t per_doc, int L,
    int K) {
  extern __shared__ __align__(16) unsigned char hm_smem_raw[];
  R* red = reinterpret_cast<R*>(hm_smem_raw);
  const int b = blockIdx.x, nw = blockDim.x >> 5;
  const size_t KK = static_cast<size_t>(K) * K;
  R* AT = scratch + static_cast<size_t>(b) * static_cast<size_t>(per_doc);
  R* ring = AT + KK;                          // [2, K]
  R* p0 = ring + 2 * static_cast<size_t>(K);  // [K]
  const int* tb = terms + static_cast<size_t>(b) * L;
  const R* mb = tmask + static_cast<size_t>(b) * L;
  const int last = hm_last(mb, L, red + 24, nw);
  hmw_build(gamma + static_cast<size_t>(b) * KK, static_cast<R*>(nullptr), AT, K);
  hmw_p0(tau + static_cast<size_t>(b) * K, p0, red + 16, K, nw);
  __syncthreads();
  const R z = hmw_forward<true>(AT, betaT, tb, mb, p0, ring, static_cast<R*>(nullptr), red, last,
                                K, nw);
  if (threadIdx.x == 0) logz[b] = z;
}

// ---- the cluster mode: A in a thread-block cluster's shared memory ----
//
// A document's chain runs on a cluster of c CTAs, each on its own SM; CTA r
// owns rows i in [r Kr, r Kr + Kr) of A (Kr = ceil(K / c); the last rank
// may hold fewer) and keeps them in its shared memory for the whole
// kernel, so a step reads its share from shared memory and not from device
// memory.  A step of the forward or the backward is one cluster barrier:
// - forward: each CTA forms its rows of f_k = B_k o (A f_{k-1}) / c_{k-1}
//   into a 2-deep ring, then gathers the whole f_k from the c rings
//   (distributed shared memory); c_k = sum f_k + EPSILON is summed by every
//   CTA over the same values in the same order, so all hold the same bits;
// - backward: each CTA forms g_k = B_k o be_k / c_k on its rows (kept in
//   its g store too), its partial (A^T g_k)_l over its rows for every l
//   into a 2-deep ring; then each folds the c partials of its own rows in
//   rank order into be_{k-1}.
// S = sum_k g_k a_{k-1}^T, local to a CTA's rows, is formed once a pass
// after the backward from the g store and the messages (hc_gamma), in the
// backward's order, so it has the bits S would have if updated every step;
// S out of the chain halves the shared memory a document needs (its
// cluster is half as wide: twice the documents in flight) and the bytes a
// backward step reads.  (Keeping S in shared memory, updated every step
// or every second step, was 24% slower at K = 300 on the widest NSF
// chunk: PERF.md.)
// The 2-deep rings let a CTA write step k + 1 while another still reads
// step k: it cannot reach step k + 2's write before every CTA has passed
// the barrier of step k + 1, which each passes after its reads of step k.
// The chain runs over entries, not slots: entry 0 is slot 0 (it always
// makes a message: a padding first slot takes f_0 = p0), entry k >= 1 the
// k-th real slot after it (a padding slot carries the message, c = 1, so
// it is no step).  The update between passes (tau = eta + r_0, gamma =
// alpha + A o S, the stop test) is local to the rows but for the column
// sums of the new gamma, tau's sum and |dgamma|^2, which go through an
// exchange buffer (one barrier) and are folded in rank order: every CTA
// takes the same branch.  The messages and scalers each CTA needs again
// (the backward's c_k and, in the final pass, a_k on its rows; a_{k-1} on
// its columns for S) go to its own copy in the device scratch, L2 hits
// fetched a step ahead.  A last barrier keeps
// every CTA's shared memory alive until no other can read it.  Sums run
// in fixed orders and no float atomic is used: the same inputs give the
// same bits.  The launch (cudaLaunchKernelEx with a cluster dimension)
// fails with the CUDA error where the device cannot place a cluster.

// A document's cluster from one CTA: its width c, rank, rows [i0, i0 + nr)
// and warps.
struct HcCta {
  int c, rank, Kr, i0, nr, K, nw;
};

__device__ __forceinline__ HcCta hc_cta(int K) {
  cg::cluster_group cl = cg::this_cluster();
  HcCta h;
  h.c = static_cast<int>(cl.dim_blocks().x);
  h.rank = static_cast<int>(cl.block_rank());
  h.Kr = hc_rows(K, h.c);
  h.i0 = h.rank * h.Kr;
  h.nr = min(max(K - h.i0, 0), h.Kr);
  h.K = K;
  h.nw = blockDim.x >> 5;
  return h;
}

// `p` (in this CTA's shared memory) in the CTA of rank `r`: a generic
// pointer into distributed shared memory.
template <typename T>
__device__ __forceinline__ T* hc_at(T* p, int r) {
  return cg::this_cluster().map_shared_rank(p, r);
}

// Every thread of the cluster arrives, then waits: a release-acquire
// barrier at cluster scope (writes before it are seen by every CTA after
// it), and a barrier of the CTA's own threads.
__device__ __forceinline__ void hc_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// sum over r = 0 .. c - 1 of hc_at(p, r)[o] in rank order, the loads
// issued before the adds.
template <typename R>
__device__ __forceinline__ R hc_fold(R* p, int o, int c) {
  R v[kHcMaxWidth];
#pragma unroll
  for (int r = 0; r < kHcMaxWidth; ++r)
    if (r < c) v[r] = hc_at(p, r)[o];
  R s = R(0);
#pragma unroll
  for (int r = 0; r < kHcMaxWidth; ++r)
    if (r < c) s += v[r];
  return s;
}

// The document's entries, by warp 0, into this CTA's lists: slot[k] (NULL:
// not kept) and its term id term[k].  Returns the count to every thread
// (one barrier; `count` in shared memory).
template <typename R>
__device__ __forceinline__ int hc_entries(const int* tb, const R* mb, int L, int* slot, int* term,
                                          int* count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n_ent = 1;
    if (lane == 0) {
      if (slot != nullptr) slot[0] = 0;
      term[0] = tb[0];
    }
    for (int base = 1; base < L; base += 32) {
      const int n = base + lane;
      const bool real = n < L && mb[n] > R(0);
      const unsigned m = __ballot_sync(0xffffffffu, real);
      if (real) {
        const int k = n_ent + __popc(m & ((1u << lane) - 1u));
        if (slot != nullptr) slot[k] = n;
        term[k] = tb[n];
      }
      n_ent += __popc(m);
    }
    if (lane == 0) *count = n_ent;
  }
  __syncthreads();
  return *count;
}

// A [j, l] = exp(psi(gamma[i0 + j, l]) - psi(sum_i gamma[i, l])) on the
// CTA's rows, thread l a column (gamma read twice): the column's sum over
// the CTA's rows into xb[l], one cluster barrier, the c partial sums in
// rank order.  `gout` (NULL: none) gets a copy of the rows.
template <typename R>
__device__ __forceinline__ void hc_build(const HcCta& h, const R* gd, R* gout, R* A, R* xb) {
  const int l = threadIdx.x, K = h.K;
  if (l < K) {
    R part = R(0);
    for (int j = 0; j < h.nr; ++j) {
      const size_t o = static_cast<size_t>(h.i0 + j) * K + l;
      const R g = gd[o];
      if (gout != nullptr) gout[o] = g;
      part += g;
    }
    xb[l] = part;
  }
  hc_sync();
  if (l < K) {
    const R dcs = hm_psi(hc_fold(xb, l, h.c));
    for (int j = 0; j < h.nr; ++j)
      A[static_cast<size_t>(j) * K + l] =
          Real<R>::exp(hm_psi(gd[static_cast<size_t>(h.i0 + j) * K + l]) - dcs);
  }
}

// p0 of the thread's topic from the whole tau (every CTA the same bits).
template <typename R>
__device__ __forceinline__ R hc_p0(R tau, bool own, R* red, int nw) {
  const R ts = hm_sum(own ? tau : R(0), red, nw);
  return own ? Real<R>::exp(hm_psi(tau) - hm_psi(ts)) : R(0);
}

// The forward over entries 0 .. ne - 1.  Thread t owns topic t of the
// whole message, in fv raw (f, not f / c).  The CTA's rows of f_k: each
// warp eight rows at a time, the lanes over l, then eight butterflies; the
// emission slice of entry k sits in shared memory (written at step k - 1,
// fetched at step k - 2, its term id at k - 3).  a_k = f_k / c_k and c_k
// go to this CTA's copies msg [ne, K] and cs (NULL: none).  Returns logZ =
// sum of log c_k over the real entries, the same in every thread.
template <typename R>
__device__ __forceinline__ R hc_forward(const HcCta& h, const R* A, const R* __restrict__ betaT,
                                        const int* term, int ne, R m0, R p0, R* fv, R* ringf,
                                        R* bsl, R* red, R* msg, R* cs) {
  const int t = threadIdx.x, K = h.K, lane = t & 31, w = t >> 5;
  const bool own = t < K, mine = t < h.nr;
  const R f0 = own ? (m0 > R(0) ? p0 * betaT[static_cast<size_t>(term[0]) * K + t] : p0) : R(0);
  if (own) fv[t] = f0;
  if (mine && ne > 1) bsl[t] = betaT[static_cast<size_t>(term[1]) * K + h.i0 + t];
  R b_nx = (mine && ne > 2) ? betaT[static_cast<size_t>(term[2]) * K + h.i0 + t] : R(0);
  int t_nx = ne > 3 ? term[3] : 0;
  R cprev = hm_sum(f0, red, h.nw) + Real<R>::eps;   // its barrier: fv and bsl written
  if (msg != nullptr && own) msg[t] = f0 / cprev;
  if (cs != nullptr && t == 0) cs[0] = m0 > R(0) ? cprev : R(1);
  R logz = m0 > R(0) ? Real<R>::log(cprev) : R(0);
  int par = 0;
  for (int k = 1; k < ne; ++k) {
    R* ring = ringf + static_cast<size_t>(par) * h.Kr;
    par ^= 1;
    for (int j0 = 8 * w; j0 < h.nr; j0 += 8 * h.nw) {
      // rows j0 .. j0 + 7; past nr row j0 again, its sums unused
      const R* ap[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) ap[u] = A + static_cast<size_t>(j0 + u < h.nr ? j0 + u : j0) * K;
      R sv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) sv[u] = R(0);
      for (int l = lane; l < K; l += 32) {
        const R x = fv[l];
#pragma unroll
        for (int u = 0; u < 8; ++u) sv[u] = Real<R>::fma(ap[u][l], x, sv[u]);
      }
      R s = R(0);   // lane u < 8: row j0 + u's sum
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const R su = warp_sum(sv[u]);
        if (lane == u) s = su;
      }
      const int j = j0 + lane;
      if (lane < 8 && j < h.nr) ring[j] = bsl[j] * (s / cprev);
    }
    hc_sync();   // every CTA's rows of f_k in its ring; fv and bsl read
    R fk = R(0);
    if (own) {
      const int o = t / h.Kr;
      fk = hc_at(ring, o)[t - o * h.Kr];
      fv[t] = fk;
    }
    if (mine && k + 1 < ne) {
      bsl[t] = b_nx;
      if (k + 2 < ne) b_nx = betaT[static_cast<size_t>(t_nx) * K + h.i0 + t];
      if (k + 3 < ne) t_nx = term[k + 3];
    }
    const R ck = hm_sum(fk, red, h.nw) + Real<R>::eps;   // its barrier: fv and bsl written
    if (msg != nullptr && own) msg[static_cast<size_t>(k) * K + t] = fk / ck;
    if (cs != nullptr && t == 0) cs[k] = ck;
    logz += Real<R>::log(ck);
    cprev = ck;
  }
  return logz;
}

// The backward over entries ne - 1 .. 1 from this CTA's msg and cs.
// Thread j < nr owns row i0 + j: be_k, and g_k into g (read by the step's
// column loop, free again past the step's cluster barrier) and, unless
// kFinal, into the CTA's g store gst [L, Kr4] for the pass's S.  Thread l
// sums column l's partial (A^T g_k)_l over the CTA's rows, g read as
// 16-byte vectors.  Each operand of a step is fetched a step ahead.
// kFinal writes the r row of entry k's slot, a_k o be_k, on the CTA's
// columns.  Returns be_0 of the thread's row.
template <bool kFinal, typename R>
__device__ __forceinline__ R hc_backward(const HcCta& h, const R* A, const R* __restrict__ betaT,
                                         const int* slot, const int* term, int ne, const R* msg,
                                         const R* cs, R* g, R* gst, R* ringb, R* rd) {
  using V4 = typename Real<R>::V4;
  const int t = threadIdx.x, K = h.K, Kr4 = hc_rows4(h.Kr);
  const bool own = t < K, mine = t < h.nr;
  R be = R(1);
  __syncthreads();   // the forward's last scaler and messages, written by other threads
  if (ne < 2) return be;
  auto emis = [&](int k) {
    return mine ? betaT[static_cast<size_t>(term[k]) * K + h.i0 + t] : R(0);
  };
  auto cur = [&](int k) {
    return (kFinal && mine) ? msg[static_cast<size_t>(k) * K + h.i0 + t] : R(0);
  };
  int k = ne - 1;
  R b_cur = emis(k), a_k = cur(k), c_k = cs[k];
  int s_k = kFinal ? slot[k] : 0;
  int par = 0;
  for (; k >= 1; --k) {
    R b_nx = R(0), ak_nx = R(0), c_nx = R(1);
    int s_nx = 0;
    if (k >= 2) {
      b_nx = emis(k - 1);
      ak_nx = cur(k - 1);
      c_nx = cs[k - 1];
      if (kFinal) s_nx = slot[k - 1];
    }
    if (mine) {
      const R gk = (b_cur * be) / c_k;
      g[t] = gk;
      if (kFinal)
        rd[static_cast<size_t>(s_k) * K + h.i0 + t] = a_k * be;
      else
        gst[static_cast<size_t>(k) * Kr4 + t] = gk;
    }
    __syncthreads();   // g complete
    R* ring = ringb + static_cast<size_t>(par) * K;
    if (own) {
      R e0 = R(0), e1 = R(0);
      int j = 0;
      for (; j + 4 <= h.nr; j += 4) {
        const V4 q = *reinterpret_cast<const V4*>(g + j);
        const size_t o = static_cast<size_t>(j) * K + t;
        e0 = Real<R>::fma(A[o], q.x, e0);
        e1 = Real<R>::fma(A[o + K], q.y, e1);
        e0 = Real<R>::fma(A[o + 2 * K], q.z, e0);
        e1 = Real<R>::fma(A[o + 3 * K], q.w, e1);
      }
      for (int i = 0; j < h.nr; ++j, ++i) {
        const size_t o = static_cast<size_t>(j) * K + t;
        if (i & 1)
          e1 = Real<R>::fma(A[o], g[j], e1);
        else
          e0 = Real<R>::fma(A[o], g[j], e0);
      }
      ring[t] = e0 + e1;
    }
    hc_sync();   // every CTA's partials in its ring; g read
    if (mine) be = hc_fold(ring, h.i0 + t, h.c);
    par ^= 1;
    b_cur = b_nx;
    a_k = ak_nx;
    c_k = c_nx;
    s_k = s_nx;
  }
  return be;
}

// Rows of S a thread sums at once in the pass's product (its registers).
template <typename R>
struct HcSRows;
template <>
struct HcSRows<float> { static constexpr int v = 32; };
template <>
struct HcSRows<double> { static constexpr int v = 16; };

// The pass's update on the CTA's rows, thread l column l: S[j, l] = sum
// over entries k = ne - 1 .. 1 of g_k[j] a_{k-1}[l] (the backward's order:
// the bits the chain would give adding it step by step), HcSRows rows at a
// time; gamma_new = alpha + A o S into gamma_out and staged in A; returns
// the thread's |dgamma|^2 and puts its column's sum of gamma_new in *csl.
template <typename R>
__device__ __forceinline__ R hc_gamma(const HcCta& h, R* A, const R* gst, const R* msg, int ne,
                                      const R* __restrict__ alpha, R* gd, R* csl) {
  using V4 = typename Real<R>::V4;
  constexpr int kS = HcSRows<R>::v;
  const int t = threadIdx.x, K = h.K, Kr4 = hc_rows4(h.Kr);
  R d2 = R(0), cs = R(0);
  for (int j0 = 0; j0 < h.nr; j0 += kS) {
    R acc[kS];
#pragma unroll
    for (int u = 0; u < kS; ++u) acc[u] = R(0);
#pragma unroll 2
    for (int k = ne - 1; k >= 1; --k) {
      const R a = msg[static_cast<size_t>(k - 1) * K + t];
      const V4* q = reinterpret_cast<const V4*>(gst + static_cast<size_t>(k) * Kr4 + j0);
#pragma unroll
      for (int u = 0; u < kS / 4; ++u) {
        const V4 v = q[u];
        acc[4 * u] = Real<R>::fma(v.x, a, acc[4 * u]);
        acc[4 * u + 1] = Real<R>::fma(v.y, a, acc[4 * u + 1]);
        acc[4 * u + 2] = Real<R>::fma(v.z, a, acc[4 * u + 2]);
        acc[4 * u + 3] = Real<R>::fma(v.w, a, acc[4 * u + 3]);
      }
    }
#pragma unroll
    for (int u = 0; u < kS; ++u) {
      const int j = j0 + u;
      if (j < h.nr) {
        const size_t o = static_cast<size_t>(h.i0 + j) * K + t;   // in gamma [K, K]
        const size_t so = static_cast<size_t>(j) * K + t;         // in A [Kr, K]
        const R gn = alpha[o] + A[so] * acc[u];
        const R d = gn - gd[o];
        d2 = Real<R>::fma(d, d, d2);
        gd[o] = gn;
        A[so] = gn;
        cs += gn;
      }
    }
  }
  *csl = cs;
  return d2;
}

// One document a cluster; the cluster's width comes with the launch.
template <typename R>
__global__ void __launch_bounds__(kHcEstepThreads) hmtm_estep_cluster_kernel(
    const R* __restrict__ betaT,     // [V, K] beta^T + eps
    const int* __restrict__ terms,   // [B, L]
    const R* __restrict__ tmask,     // [B, L] 1 on real tokens
    const R* __restrict__ doc_mask,  // [B]
    const R* __restrict__ eta,       // [K]
    const R* __restrict__ alpha,     // [K, K]
    const R* __restrict__ tau_in,    // [B, K]
    const R* __restrict__ gamma_in,  // [B, K, K]
    R* __restrict__ tau_out, R* __restrict__ gamma_out,
    R* __restrict__ r,               // [B, L, K]
    R* scratch,                      // [B, c, hc_estep_cta(L, K, c)]
    int L, int K, int viter, R vtol) {
  extern __shared__ __align__(16) unsigned char hm_smem_raw[];
  R* sm = reinterpret_cast<R*>(hm_smem_raw);
  const HcCta h = hc_cta(K);
  const int t = threadIdx.x;
  const bool own = t < K, mine = t < h.nr;
  const int b = blockIdx.x / h.c;
  const size_t KrK = static_cast<size_t>(h.Kr) * K;
  const int xn = static_cast<int>(hc_xbuf(K, h.Kr));
  R* g = sm;                      // [Kr4], 16-byte aligned
  R* A = g + hc_rows4(h.Kr);
  R* fv = A + KrK;                // [K]
  R* ringf = fv + K;              // [2, Kr]
  R* ringb = ringf + 2 * h.Kr;    // [2, K]
  R* bsl = ringb + 2 * K;         // [Kr]
  R* red = bsl + h.Kr;            // [4, 32]: c, |dgamma|^2, sum tau
  R* xbuf = red + kHcRed;         // [2, K + Kr + 2]: column sums, tau, |dgamma|^2
  int* count = reinterpret_cast<int*>(xbuf + 2 * xn);
  // this CTA's scratch: the g store [L, Kr4] (16-byte aligned), the
  // messages [L, K], the scalers [L], the entry lists [2, L] (ints)
  R* gst = scratch + (static_cast<size_t>(b) * h.c + h.rank) * hc_estep_cta(L, K, h.c);
  R* msg = gst + static_cast<size_t>(L) * hc_rows4(h.Kr);
  R* cs = msg + static_cast<size_t>(L) * K;
  int* slot = reinterpret_cast<int*>(cs + L);
  int* term = slot + L;
  const int* tb = terms + static_cast<size_t>(b) * L;
  const R* mb = tmask + static_cast<size_t>(b) * L;
  const size_t dk = static_cast<size_t>(b) * K, dkk = dk * K;
  R* rd = r + static_cast<size_t>(b) * L * K;
  R* gd = gamma_out + dkk;

  const int ne = hc_entries(tb, mb, L, slot, term, count);
  const R m0 = mb[0];
  if (mine) {   // the CTA's columns of r: zeros, the real rows written by the final pass
    for (int n = 0; n < L; ++n) rd[static_cast<size_t>(n) * K + h.i0 + t] = R(0);
    tau_out[dk + h.i0 + t] = tau_in[dk + h.i0 + t];
  }
  hc_build(h, gamma_in + dkk, gd, A, xbuf + xn);
  R p0 = hc_p0(own ? tau_in[dk + t] : R(0), own, red + 64, h.nw);

  bool active = doc_mask[b] > R(0);
  int pp = 0;   // the update's exchange buffer, alternating (the build took buffer 1)
  for (int it = 0; it < viter && active; ++it) {
    hc_forward(h, A, betaT, term, ne, m0, p0, fv, ringf, bsl, red, msg, cs);
    const R be0 = hc_backward<false>(h, A, betaT, slot, term, ne, msg, cs, g, gst, ringb,
                                     static_cast<R*>(nullptr));
    // tau = eta + r_0 and gamma = alpha + A o S on the CTA's rows (gamma
    // staged in A), the column sums, the tau slice and |dgamma|^2 to the
    // exchange buffer; after one cluster barrier every CTA folds them in
    // rank order
    R* xb = xbuf + pp * xn;
    pp ^= 1;
    if (mine) {
      const R tn = eta[h.i0 + t] + msg[h.i0 + t] * be0 * m0;
      tau_out[dk + h.i0 + t] = tn;
      xb[K + t] = tn;
    }
    R d2 = R(0);
    if (own) {
      R csl;
      d2 = hc_gamma(h, A, gst, msg, ne, alpha, gd, &csl);
      xb[t] = csl;
    }
    d2 = hm_sum(d2, red + 32, h.nw);
    if (t == 0) xb[K + h.Kr] = d2;
    hc_sync();   // the exchange buffers written
    R tau = R(0);
    if (own) {
      const int o = t / h.Kr;
      tau = hc_at(xb, o)[K + t - o * h.Kr];
      const R dcs = hm_psi(hc_fold(xb, t, h.c));
      for (int j = 0; j < h.nr; ++j) {
        const size_t so = static_cast<size_t>(j) * K + t;
        A[so] = Real<R>::exp(hm_psi(A[so]) - dcs);
      }
    }
    const R delta2 = hc_fold(xb, K + h.Kr, h.c);
    p0 = hc_p0(tau, own, red + 64, h.nw);   // its barrier: the new A complete
    active = hm_sqrt(delta2) >= vtol;
  }

  // q(z_n) from the final state: the real rows by the final backward, row 0
  hc_forward(h, A, betaT, term, ne, m0, p0, fv, ringf, bsl, red, msg, cs);
  const R be0 = hc_backward<true>(h, A, betaT, slot, term, ne, msg, cs, g,
                                  static_cast<R*>(nullptr), ringb, rd);
  if (mine) rd[h.i0 + t] = msg[h.i0 + t] * be0 * m0;
  hc_sync();   // no CTA leaves while another may still read its shared memory
}

template <typename R>
__global__ void __launch_bounds__(kHcLogzThreads) hmtm_logz_cluster_kernel(
    const R* __restrict__ betaT, const int* __restrict__ terms, const R* __restrict__ tmask,
    const R* __restrict__ tau, const R* __restrict__ gamma, R* __restrict__ logz,
    R* scratch,   // [B, c, L]: each CTA's term list
    int L, int K) {
  extern __shared__ __align__(16) unsigned char hm_smem_raw[];
  R* sm = reinterpret_cast<R*>(hm_smem_raw);
  const HcCta h = hc_cta(K);
  const int t = threadIdx.x;
  const bool own = t < K;
  const int b = blockIdx.x / h.c;
  R* A = sm;                                      // [Kr, K]
  R* fv = A + static_cast<size_t>(h.Kr) * K;      // [K]
  R* ringf = fv + K;                              // [2, Kr]
  R* bsl = ringf + 2 * h.Kr;                      // [Kr]
  R* red = bsl + h.Kr;                            // [4, 32]
  R* xb = red + kHcRed;                           // [K + Kr + 2]
  int* count = reinterpret_cast<int*>(xb + hc_xbuf(K, h.Kr));
  int* term = reinterpret_cast<int*>(scratch + (static_cast<size_t>(b) * h.c + h.rank) * L);
  const int* tb = terms + static_cast<size_t>(b) * L;
  const R* mb = tmask + static_cast<size_t>(b) * L;
  const int ne = hc_entries(tb, mb, L, static_cast<int*>(nullptr), term, count);
  hc_build(h, gamma + static_cast<size_t>(b) * K * K, static_cast<R*>(nullptr), A, xb);
  const R p0 = hc_p0(own ? tau[static_cast<size_t>(b) * K + t] : R(0), own, red + 64, h.nw);
  const R z = hc_forward(h, A, betaT, term, ne, mb[0], p0, fv, ringf, bsl, red,
                         static_cast<R*>(nullptr), static_cast<R*>(nullptr));
  if (h.rank == 0 && t == 0) logz[b] = z;
  hc_sync();   // no CTA leaves while another may still read its shared memory
}

// B clusters of c CTAs of `threads`, `bytes` of shared memory each; fails,
// with the CUDA error, where the device cannot place one such cluster.
template <typename... Params, typename... Args>
int launch_cluster(void (*kern)(Params...), int c, int64_t B, unsigned threads, size_t bytes,
                   cudaStream_t st, Args... args) {
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return fail(err);
  if (c > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return fail(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(c);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * c));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int placed = 0;
  err = cudaOccupancyMaxActiveClusters(&placed, reinterpret_cast<const void*>(kern), &cfg);
  if (err != cudaSuccess) return fail(err);
  if (placed < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return fail(err);
  return static_cast<int>(cudaGetLastError());
}

// The split kernels at the register width W of the block's K.
template <typename R, int W>
int launch_split_estep(const R* betaT, const int* terms, const R* tmask, const R* doc_mask,
                       const R* eta, const R* alpha, const R* tau_in, const R* gamma_in,
                       R* tau_out, R* gamma_out, R* r, R* scratch, int64_t B, int64_t L,
                       int64_t K, int viter, R vtol, const HmShape& s, cudaStream_t st) {
  const cudaError_t err = allow_smem(hmtm_estep_split_kernel<R, W>, s.bytes);
  if (err != cudaSuccess) return fail(err);
  hmtm_estep_split_kernel<R, W><<<static_cast<unsigned>(B), kHsThreads, s.bytes, st>>>(
      betaT, terms, tmask, doc_mask, eta, alpha, tau_in, gamma_in, tau_out, gamma_out, r,
      scratch, static_cast<int>(L), static_cast<int>(K), s.mode, viter, vtol);
  return static_cast<int>(cudaGetLastError());
}

template <typename R, int W>
int launch_split_logz(const R* betaT, const int* terms, const R* tmask, const R* tau,
                      const R* gamma, R* logz, int64_t B, int64_t L, int64_t K,
                      cudaStream_t st) {
  const size_t bytes = hs_base_elems(static_cast<int>(K)) * sizeof(R);
  const cudaError_t err = allow_smem(hmtm_logz_split_kernel<R, W>, bytes);
  if (err != cudaSuccess) return fail(err);
  hmtm_logz_split_kernel<R, W><<<static_cast<unsigned>(B), kHsThreads, bytes, st>>>(
      betaT, terms, tmask, tau, gamma, logz, static_cast<int>(L), static_cast<int>(K));
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int launch_hmtm_estep(const R* betaT, const int* terms, const R* tmask, const R* doc_mask,
                      const R* eta, const R* alpha, const R* tau_in, const R* gamma_in,
                      R* tau_out, R* gamma_out, R* r, R* scratch, int64_t B, int64_t L,
                      int64_t K, int viter, R vtol, void* stream) {
  if (B == 0) return 0;
  HmShape s;
  const int rc = hm_shape<R>(L, K, &s);
  if (rc != 0) return static_cast<int>(rc == kHmBadShape ? cudaErrorInvalidValue : rc);
  if (s.scratch > 0 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned threads = hm_threads(static_cast<int>(K));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 32) {
    switch (hs_width(static_cast<int>(K))) {
      case 16:
        return launch_split_estep<R, 16>(betaT, terms, tmask, doc_mask, eta, alpha, tau_in,
                                         gamma_in, tau_out, gamma_out, r, scratch, B, L, K,
                                         viter, vtol, s, st);
      case 28:
        return launch_split_estep<R, 28>(betaT, terms, tmask, doc_mask, eta, alpha, tau_in,
                                         gamma_in, tau_out, gamma_out, r, scratch, B, L, K,
                                         viter, vtol, s, st);
      default:
        return launch_split_estep<R, 32>(betaT, terms, tmask, doc_mask, eta, alpha, tau_in,
                                         gamma_in, tau_out, gamma_out, r, scratch, B, L, K,
                                         viter, vtol, s, st);
    }
  }
  if (s.mode == kHmCluster)
    return launch_cluster(hmtm_estep_cluster_kernel<R>, s.cluster, B,
                          static_cast<unsigned>(hc_threads(static_cast<int>(K))), s.bytes, st,
                          betaT, terms, tmask, doc_mask, eta, alpha, tau_in, gamma_in, tau_out,
                          gamma_out, r, scratch, static_cast<int>(L), static_cast<int>(K), viter,
                          vtol);
  if (s.mode == kHmWide) {
    hmtm_estep_wide_kernel<R><<<static_cast<unsigned>(B), threads, s.bytes, st>>>(
        betaT, terms, tmask, doc_mask, eta, alpha, tau_in, gamma_in, tau_out, gamma_out, r,
        scratch, s.scratch, static_cast<int>(L), static_cast<int>(K), viter, vtol);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = allow_smem(hmtm_estep_kernel<R>, s.bytes);
  if (err != cudaSuccess) return fail(err);
  hmtm_estep_kernel<R><<<static_cast<unsigned>(B), threads, s.bytes, st>>>(
      betaT, terms, tmask, doc_mask, eta, alpha, tau_in, gamma_in, tau_out, gamma_out, r,
      scratch, s.scratch, static_cast<int>(L), static_cast<int>(K), s.mode, viter, vtol);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int launch_hmtm_logz(const R* betaT, const int* terms, const R* tmask, const R* tau,
                     const R* gamma, R* logz, R* scratch, int64_t B, int64_t L, int64_t K,
                     void* stream) {
  if (B == 0) return 0;
  HmShape s;
  const int rc = hm_logz_shape<R>(L, K, &s);
  if (rc != 0) return static_cast<int>(rc == kHmBadShape ? cudaErrorInvalidValue : rc);
  if (s.scratch > 0 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned threads = hm_threads(static_cast<int>(K));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 32) {
    switch (hs_width(static_cast<int>(K))) {
      case 16:
        return launch_split_logz<R, 16>(betaT, terms, tmask, tau, gamma, logz, B, L, K, st);
      case 28:
        return launch_split_logz<R, 28>(betaT, terms, tmask, tau, gamma, logz, B, L, K, st);
      default:
        return launch_split_logz<R, 32>(betaT, terms, tmask, tau, gamma, logz, B, L, K, st);
    }
  }
  if (s.mode == kHmCluster)
    return launch_cluster(hmtm_logz_cluster_kernel<R>, s.cluster, B,
                          static_cast<unsigned>(hc_threads(static_cast<int>(K))), s.bytes, st,
                          betaT, terms, tmask, tau, gamma, logz, scratch, static_cast<int>(L),
                          static_cast<int>(K));
  if (s.mode == kHmWide) {
    hmtm_logz_wide_kernel<R><<<static_cast<unsigned>(B), threads, s.bytes, st>>>(
        betaT, terms, tmask, tau, gamma, logz, scratch, hm_wide_logz_scratch(K),
        static_cast<int>(L), static_cast<int>(K));
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes = hm_base_elems(static_cast<int>(K)) * sizeof(R);
  const cudaError_t err = allow_smem(hmtm_logz_kernel<R>, bytes);
  if (err != cudaSuccess) return fail(err);
  hmtm_logz_kernel<R><<<static_cast<unsigned>(B), threads, bytes, st>>>(
      betaT, terms, tmask, tau, gamma, logz, static_cast<int>(L), static_cast<int>(K));
  return static_cast<int>(cudaGetLastError());
}

// The shape queries' answers: what 0 hmtm_estep's mode, 1 its scratch
// elements a document, 2 its cluster width (0: not the cluster mode), 3
// hmtm_logz's mode (0 shared memory, 3 wide, 4 cluster), 4 its scratch, 5
// its cluster width; -1 when the device cannot be queried, -2 when K or L
// is below 1.
template <typename R>
int64_t hm_query(int64_t L, int64_t K, int what) {
  HmShape s;
  const int rc = what < 3 ? hm_shape<R>(L, K, &s) : hm_logz_shape<R>(L, K, &s);
  if (rc != 0) return rc == kHmBadShape ? -2 : -1;
  switch (what % 3) {
    case 0:
      return s.mode;
    case 1:
      return s.scratch;
    default:
      return s.cluster;
  }
}

}  // namespace tmvb

extern "C" {

int tmvb_hmtm_estep_mode(int64_t L, int64_t K) {
  return static_cast<int>(tmvb::hm_query<float>(L, K, 0));
}
int tmvb_hmtm_estep_mode_f64(int64_t L, int64_t K) {
  return static_cast<int>(tmvb::hm_query<double>(L, K, 0));
}
int64_t tmvb_hmtm_estep_scratch(int64_t L, int64_t K) { return tmvb::hm_query<float>(L, K, 1); }
int64_t tmvb_hmtm_estep_scratch_f64(int64_t L, int64_t K) {
  return tmvb::hm_query<double>(L, K, 1);
}
int tmvb_hmtm_estep_cluster(int64_t L, int64_t K) {
  return static_cast<int>(tmvb::hm_query<float>(L, K, 2));
}
int tmvb_hmtm_estep_cluster_f64(int64_t L, int64_t K) {
  return static_cast<int>(tmvb::hm_query<double>(L, K, 2));
}
int tmvb_hmtm_logz_mode(int64_t L, int64_t K) {
  return static_cast<int>(tmvb::hm_query<float>(L, K, 3));
}
int tmvb_hmtm_logz_mode_f64(int64_t L, int64_t K) {
  return static_cast<int>(tmvb::hm_query<double>(L, K, 3));
}
int64_t tmvb_hmtm_logz_scratch(int64_t L, int64_t K) { return tmvb::hm_query<float>(L, K, 4); }
int64_t tmvb_hmtm_logz_scratch_f64(int64_t L, int64_t K) {
  return tmvb::hm_query<double>(L, K, 4);
}
int tmvb_hmtm_logz_cluster(int64_t L, int64_t K) {
  return static_cast<int>(tmvb::hm_query<float>(L, K, 5));
}
int tmvb_hmtm_logz_cluster_f64(int64_t L, int64_t K) {
  return static_cast<int>(tmvb::hm_query<double>(L, K, 5));
}

int tmvb_hmtm_estep(const float* betaT, const int* terms, const float* tmask,
                    const float* doc_mask, const float* eta, const float* alpha,
                    const float* tau_in, const float* gamma_in, float* tau_out,
                    float* gamma_out, float* r, float* scratch, int64_t B, int64_t L,
                    int64_t K, int viter, float vtol, void* stream) {
  return tmvb::launch_hmtm_estep(betaT, terms, tmask, doc_mask, eta, alpha, tau_in, gamma_in,
                                 tau_out, gamma_out, r, scratch, B, L, K, viter, vtol, stream);
}

// The float64 mode: every float tensor double, vtol too.
int tmvb_hmtm_estep_f64(const double* betaT, const int* terms, const double* tmask,
                        const double* doc_mask, const double* eta, const double* alpha,
                        const double* tau_in, const double* gamma_in, double* tau_out,
                        double* gamma_out, double* r, double* scratch, int64_t B, int64_t L,
                        int64_t K, int viter, double vtol, void* stream) {
  return tmvb::launch_hmtm_estep(betaT, terms, tmask, doc_mask, eta, alpha, tau_in, gamma_in,
                                 tau_out, gamma_out, r, scratch, B, L, K, viter, vtol, stream);
}

int tmvb_hmtm_logz(const float* betaT, const int* terms, const float* tmask,
                   const float* tau, const float* gamma, float* logz, float* scratch,
                   int64_t B, int64_t L, int64_t K, void* stream) {
  return tmvb::launch_hmtm_logz(betaT, terms, tmask, tau, gamma, logz, scratch, B, L, K,
                                stream);
}

int tmvb_hmtm_logz_f64(const double* betaT, const int* terms, const double* tmask,
                       const double* tau, const double* gamma, double* logz, double* scratch,
                       int64_t B, int64_t L, int64_t K, void* stream) {
  return tmvb::launch_hmtm_logz(betaT, terms, tmask, tau, gamma, logz, scratch, B, L, K,
                                stream);
}

}  // extern "C"
