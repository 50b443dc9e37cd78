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
// r [B, L, K] = q(z_n) for every row of the chunk.  `hmtm_logz` runs the
// forward pass alone and writes logZ = sum_n log c_n, the bound's z and w
// terms.
//
// What bounds it on an H100: neither bytes nor flops but the latency of a
// sequential chain.  A document's 2 (viter + 1) scans are L K x K
// matrix-vector products each, every step waiting on the one before: at
// the widest NSF chunk (B = 1024, L = 128, K = 25, viter 10) ~2,800 steps
// a document, each a dot product of K terms, a sum over K threads and a
// division before the next step can start.  The chunk's flops (~5 K^2 a
// step) take ~70 us at the f32 rate and its bytes (~13 MB of r) ~4 us, so
// the design aims at the chain's latency and at having every document in
// flight at once:
// - one block a document, ceil(K/32) warps, thread i owning topic i;
// - for K <= 32 (one warp, NSF's K = 25) thread i keeps row i of A for the
//   forward and column i of A and of S for the backward in registers and
//   takes the other topics' message entries and g by shuffles: a step has
//   no shared-memory traffic and no barrier.  The shared-memory version
//   below (A, a_{n-1} and g read from shared memory, a barrier a step)
//   takes 2.4 times as long a pass at the widest NSF chunk (0.263 against
//   0.109 ms on an H100 80GB HBM3 at 700 W, tools/estep_sweep.py);
// - wider K: A in shared memory, rows padded to an odd stride, so that
//   both the forward (thread i reads row i) and the backward (thread l
//   reads column l) read 32 banks at once;
// - emission rows gathered from the [V, K] table (in L2) with the next
//   slot's term id and row loaded a step ahead, off the chain;
// - xi_sum is accumulated as S[i, l] = sum_n g_n[i] a_{n-1}[l] and
//   multiplied by A once a pass (A is constant within a pass); S, the
//   messages a [L, K] and the scalers c [L] stay in shared memory when all
//   of them fit half the SM's opt-in (NSF: 19 KB, so 11 documents an SM
//   and the whole chunk in one wave), else the messages, and past K ~ 168
//   S too, go to a device scratch the wrapper allocates;
// - sums run in fixed orders and no float atomic is used: same inputs,
//   same bits;
// - each document stops on its own test, so the E-step reads nothing back
//   to the host.
// psi is common.cuh's shift-by-8 series.
//
// The wide mode (mode 3; hmtm_estep_wide_kernel, hmtm_logz_wide_kernel)
// takes every K that the shared-memory modes cannot: past 256 topics (one
// thread a topic) or where A [K, K | 1] overflows the device's opt-in
// shared memory (K = 240 on an H100 in f32, ~170 in f64).  Each document's
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
// log are the double ones.  The K <= 32 path shuffles doubles.  A in 8-byte
// elements fits shared memory up to K ~ 169; past it the wide mode runs.
// The float32 instantiations make the same calls as before (expf, logf,
// fmaf, sqrtf, the f32 series): their bits do not move.

#include "common.cuh"

namespace tmvb {

constexpr int kHmMaxThreads = 256;   // 8 warps: K <= 256 (the wide mode: any K)
constexpr int kHmWide = 3;           // HmShape::mode of the wide mode
constexpr int kHmBadShape = -2;      // K or L below 1

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

// The wide mode's scratch a document, in elements: A, A^T and S [K, K],
// the messages [L, K], the scalers [L], g [2, K], be, p0 and the column
// sums [K] (hmtm_estep); A^T, two message rows and p0 (hmtm_logz).
inline int64_t hm_wide_scratch(int64_t L, int64_t K) { return 3 * K * K + L * K + L + 5 * K; }
inline int64_t hm_wide_logz_scratch(int64_t K) { return K * K + 3 * K; }

struct HmShape {
  int mode;         // 0: S and the messages in shared memory; 1: the
                    // messages in scratch; 2: S and the messages in
                    // scratch; 3 (wide): A, A^T, S, the messages and the
                    // vectors in scratch
  size_t bytes;     // dynamic shared memory
  int64_t scratch;  // elements of device scratch a document (hmtm_estep)
};

// 0; kHmBadShape when K or L is below 1; else the CUDA error of the device
// query.  R is float, or double for the float64 mode: sizes in its
// elements.
template <typename R>
inline int hm_shape(int64_t L, int64_t K, HmShape* s) {
  if (K < 1 || L < 1) return kHmBadShape;
  const int optin = smem_optin();
  if (optin < 0) return query_error();
  const size_t base = hm_base_elems(static_cast<int>(K)) * sizeof(R);
  if (K > kHmMaxThreads || base > static_cast<size_t>(optin)) {
    *s = {kHmWide, 32 * sizeof(R), hm_wide_scratch(L, K)};
    return 0;
  }
  const size_t sb = static_cast<size_t>(K * K) * sizeof(R);
  const int64_t pos = L * K + L;
  const size_t pb = static_cast<size_t>(pos) * sizeof(R);
  if (base + sb + pb <= static_cast<size_t>(optin) / 2)
    *s = {0, base + sb + pb, 0};
  else if (base + sb <= static_cast<size_t>(optin))
    *s = {1, base + sb, pos};
  else
    *s = {2, base, K * K + pos};
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
// logZ, the same in every thread.  Ends with a barrier.  kWarp (K <= 32,
// one warp): thread i keeps row i of A and its own message in registers
// and takes a_{n-1} from the other lanes by shuffles, so a step has no
// shared-memory traffic and no barrier; else A and a_{n-1} are read from
// shared memory and a barrier ends each step.  Both sum (A a)_i over four
// accumulators.
template <bool kRing, bool kWarp, typename R>
__device__ __forceinline__ R hm_forward(
    const R* __restrict__ A, const R* __restrict__ betaT, const int* tb,
    const R* mb, R p0, R* a, R* c, R* red, int last, int K, int nw) {
  const int i = threadIdx.x;
  const bool own = i < K;
  const int Ka = hm_stride(K);
  auto row = [&](int n) { return a + static_cast<size_t>(kRing ? (n & 1) : n) * K; };
  const R* Ai = A + i * Ka;
  R arow[kWarp ? 32 : 1];
  if constexpr (kWarp) {
#pragma unroll
    for (int l = 0; l < 32; ++l) arow[l] = (own && l < K) ? Ai[l] : R(0);
  }
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
      if constexpr (kWarp) {
#pragma unroll
        for (int l = 0; l < 32; ++l)
          s[l & 3] = Real<R>::fma(arow[l], __shfl_sync(0xffffffffu, a_i, l), s[l & 3]);
      } else if (own) {
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
    if constexpr (!kWarp) __syncthreads();
  }
  if constexpr (kWarp) __syncthreads();
  return logz;
}

// The backward pass over slots last .. 1 from the forward's a and c.
// Thread l owns be[l] and column l of S.  kFinal writes r rows 1 .. last
// (`rd`, 0 on padding) and leaves S alone; otherwise
// S[i, l] += g_n[i] a_{n-1}[l] on every real slot.  Returns be_0[l].
// kWarp (K <= 32): column l of A and of S in registers, g_n[k] by
// shuffles from lane k, no barrier; else A, S and g through shared memory
// (g double-buffered, one barrier a real slot).  Both sum (A^T g)_l over
// two accumulators.
template <bool kFinal, bool kWarp, typename R>
__device__ __forceinline__ R hm_backward(
    const R* __restrict__ A, const R* __restrict__ betaT, const int* tb,
    const R* mb, const R* a, const R* c, R* S, R* gbuf, R* rd,
    int last, int K) {
  const int l = threadIdx.x;
  const bool own = l < K;
  const int Ka = hm_stride(K), Kv = blockDim.x;
  R acol[kWarp ? 32 : 1], scol[kWarp && !kFinal ? 32 : 1];
  if constexpr (kWarp) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      acol[k] = (own && k < K) ? A[k * Ka + l] : R(0);
      if constexpr (!kFinal) scol[k] = R(0);
    }
  }
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
        if constexpr (kWarp) {
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const R gk = __shfl_sync(0xffffffffu, gl, k);
            e[k & 1] = Real<R>::fma(acol[k], gk, e[k & 1]);
            if constexpr (!kFinal) scol[k] = Real<R>::fma(gk, al, scol[k]);
          }
        } else {
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
        }
        if (own) be = e[0] + e[1];
      } else if (kFinal && own) {
        rd[static_cast<size_t>(n) * K + l] = R(0);
      }
    }
  }
  if constexpr (kWarp && !kFinal) {
    if (own)
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (k < K) S[k * K + l] = scol[k];
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
  if (nw == 1) {
    hm_forward<false, true>(A, betaT, tb, mb, p0, a, c, red, last, K, nw);
    return hm_backward<kFinal, true>(A, betaT, tb, mb, a, c, S, gbuf, rd, last, K);
  }
  hm_forward<false, false>(A, betaT, tb, mb, p0, a, c, red, last, K, nw);
  return hm_backward<kFinal, false>(A, betaT, tb, mb, a, c, S, gbuf, rd, last, K);
}

// R = float: the float32 mode; R = double: the float64 mode.
template <typename R>
__global__ void __launch_bounds__(kHmMaxThreads) hmtm_estep_kernel(
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
__global__ void __launch_bounds__(kHmMaxThreads) hmtm_logz_kernel(
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
  const R z = nw == 1
      ? hm_forward<true, true>(A, betaT, tb, mb, p0, ring, static_cast<R*>(nullptr), red, last,
                               K, nw)
      : hm_forward<true, false>(A, betaT, tb, mb, p0, ring, static_cast<R*>(nullptr), red, last,
                                K, nw);
  if (tid == 0) logz[b] = z;
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
  const int rc = hm_shape<R>(L, K, &s);
  if (rc != 0) return static_cast<int>(rc == kHmBadShape ? cudaErrorInvalidValue : rc);
  const unsigned threads = hm_threads(static_cast<int>(K));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s.mode == kHmWide) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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

}  // namespace tmvb

extern "C" {

// Which buffers a document of L slots keeps in shared memory (HmShape's
// mode: 0, 1, 2, or 3 for the wide mode), -1 when the device cannot be
// queried, -2 when K or L is below 1.
int tmvb_hmtm_estep_mode(int64_t L, int64_t K) {
  tmvb::HmShape s;
  const int rc = tmvb::hm_shape<float>(L, K, &s);
  return rc == tmvb::kHmBadShape ? -2 : (rc != 0 ? -1 : s.mode);
}
int tmvb_hmtm_estep_mode_f64(int64_t L, int64_t K) {
  tmvb::HmShape s;
  const int rc = tmvb::hm_shape<double>(L, K, &s);
  return rc == tmvb::kHmBadShape ? -2 : (rc != 0 ? -1 : s.mode);
}

// Elements of device scratch a document needs for hmtm_estep; -1 or -2 as
// above.
int64_t tmvb_hmtm_estep_scratch(int64_t L, int64_t K) {
  tmvb::HmShape s;
  const int rc = tmvb::hm_shape<float>(L, K, &s);
  return rc == tmvb::kHmBadShape ? -2 : (rc != 0 ? -1 : s.scratch);
}
int64_t tmvb_hmtm_estep_scratch_f64(int64_t L, int64_t K) {
  tmvb::HmShape s;
  const int rc = tmvb::hm_shape<double>(L, K, &s);
  return rc == tmvb::kHmBadShape ? -2 : (rc != 0 ? -1 : s.scratch);
}

// Elements of device scratch a document needs for hmtm_logz: 0 in the
// shared-memory modes; -1 or -2 as above.
int64_t tmvb_hmtm_logz_scratch(int64_t L, int64_t K) {
  tmvb::HmShape s;
  const int rc = tmvb::hm_shape<float>(L, K, &s);
  return rc == tmvb::kHmBadShape ? -2
         : (rc != 0 ? -1 : (s.mode == tmvb::kHmWide ? tmvb::hm_wide_logz_scratch(K) : 0));
}
int64_t tmvb_hmtm_logz_scratch_f64(int64_t L, int64_t K) {
  tmvb::HmShape s;
  const int rc = tmvb::hm_shape<double>(L, K, &s);
  return rc == tmvb::kHmBadShape ? -2
         : (rc != 0 ? -1 : (s.mode == tmvb::kHmWide ? tmvb::hm_wide_logz_scratch(K) : 0));
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
