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
// A takes K (K | 1) floats, so K stops where it no longer fits the
// device's opt-in shared memory (239 on an H100); the wrapper raises past
// it.  psi is common.cuh's shift-by-8 series.

#include "common.cuh"

namespace tmvb {

constexpr int kHmMaxThreads = 256;   // 8 warps: K <= 256

__host__ __device__ inline int hm_stride(int K) { return K | 1; }
__host__ __device__ inline int hm_threads(int K) { return (K + 31) / 32 * 32; }

// Shared floats every block needs: A [K, K | 1], two vectors [threads]
// (the backward's g, or hmtm_logz's two message rows) and 32 for sums.
inline size_t hm_base_floats(int K) {
  return static_cast<size_t>(K) * hm_stride(K) + 2 * static_cast<size_t>(hm_threads(K)) + 32;
}

struct HmShape {
  int mode;         // 0: S and the messages in shared memory; 1: the
                    // messages in scratch; 2: S and the messages in scratch
  size_t bytes;     // dynamic shared memory
  int64_t scratch;  // floats of device scratch a document
};

constexpr int kHmTooWide = -2;

// 0; kHmTooWide when A does not fit (or K or L is below 1); else the CUDA
// error of the device query.
inline int hm_shape(int64_t L, int64_t K, HmShape* s) {
  if (K < 1 || K > kHmMaxThreads || L < 1) return kHmTooWide;
  const int optin = smem_optin();
  if (optin < 0) return query_error();
  const size_t base = hm_base_floats(static_cast<int>(K)) * sizeof(float);
  const size_t sb = static_cast<size_t>(K * K) * sizeof(float);
  const int64_t pos = L * K + L;
  const size_t pb = static_cast<size_t>(pos) * sizeof(float);
  if (base > static_cast<size_t>(optin)) return kHmTooWide;
  if (base + sb + pb <= static_cast<size_t>(optin) / 2)
    *s = {0, base + sb + pb, 0};
  else if (base + sb <= static_cast<size_t>(optin))
    *s = {1, base + sb, pos};
  else
    *s = {2, base, K * K + pos};
  return 0;
}

// Sum of v over the block, the same bits in every thread: the xor
// butterfly, then (several warps) the warps' partials in warp order after
// one barrier.  The caller keeps `red` unwritten until every thread has
// passed a barrier after reading it.
__device__ __forceinline__ float hm_sum(float v, float* red, int nw) {
  v = warp_sum(v);
  if (nw == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ float hm_max(float v, float* red, int nw) {
  v = warp_max(v);
  if (nw == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < nw; ++w) s = fmaxf(s, red[w]);
  return s;
}

// The last real slot of a document, -1 when it has none.
__device__ __forceinline__ int hm_last(const float* mb, int L, float* red, int nw) {
  int last = -1;
  for (int n = threadIdx.x; n < L; n += blockDim.x)
    if (mb[n] > 0.f) last = n;
  return static_cast<int>(hm_max(static_cast<float>(last), red, nw));
}

// A [i, l] = exp(psi(gamma[i, l]) - psi(sum_i gamma[i, l])): thread l
// builds column l.  `stage` (thread l's column of a [K, K] buffer) holds
// gamma between the two loops; NULL reads gamma twice.
__device__ __forceinline__ void hm_build_A(const float* gd, float* A, float* stage, int K) {
  const int l = threadIdx.x;
  if (l >= K) return;
  const int Ka = hm_stride(K);
  float cs = 0.f;
  for (int i = 0; i < K; ++i) {
    const float g = gd[i * K + l];
    if (stage) stage[i * K + l] = g;
    cs += g;
  }
  const float dcs = digamma_series(cs);
  for (int i = 0; i < K; ++i)
    A[i * Ka + l] = expf(digamma_series(stage ? stage[i * K + l] : gd[i * K + l]) - dcs);
}

// p0_i = exp(psi(tau_i) - psi(sum tau)) for the thread's topic.
__device__ __forceinline__ float hm_p0(float tau, bool own, float* red, int nw) {
  const float ts = hm_sum(own ? tau : 0.f, red, nw);
  return own ? expf(digamma_series(tau) - digamma_series(ts)) : 0.f;
}

// The forward pass over slots 0 .. last; row n of the messages is
// `a + (ring ? n & 1 : n) * K`, its scaler c[n] (c may be NULL).  Returns
// logZ, the same in every thread.  Ends with a barrier.  kWarp (K <= 32,
// one warp): thread i keeps row i of A and its own message in registers
// and takes a_{n-1} from the other lanes by shuffles, so a step has no
// shared-memory traffic and no barrier; else A and a_{n-1} are read from
// shared memory and a barrier ends each step.  Both sum (A a)_i over four
// accumulators.
template <bool kRing, bool kWarp>
__device__ __forceinline__ float hm_forward(
    const float* __restrict__ A, const float* __restrict__ betaT, const int* tb,
    const float* mb, float p0, float* a, float* c, float* red, int last, int K, int nw) {
  const int i = threadIdx.x;
  const bool own = i < K;
  const int Ka = hm_stride(K);
  auto row = [&](int n) { return a + static_cast<size_t>(kRing ? (n & 1) : n) * K; };
  const float* Ai = A + i * Ka;
  float arow[kWarp ? 32 : 1];
  if constexpr (kWarp) {
#pragma unroll
    for (int l = 0; l < 32; ++l) arow[l] = (own && l < K) ? Ai[l] : 0.f;
  }
  const float m0 = mb[0];
  const float b0 = (own && m0 > 0.f) ? betaT[static_cast<size_t>(tb[0]) * K + i] : 0.f;
  const float f0 = own ? (m0 > 0.f ? p0 * b0 : p0) : 0.f;
  const float c0 = hm_sum(f0, red, nw) + kEps;
  float a_i = own ? f0 / c0 : 0.f;   // this thread's entry of the last message
  if (own) row(0)[i] = a_i;
  if (c != nullptr && i == 0) c[0] = m0 > 0.f ? c0 : 1.f;
  float logz = m0 > 0.f ? logf(c0) : 0.f;
  __syncthreads();
  // slot n + 1's mask and row, and slot n + 2's term id, a step ahead
  float m_nx = last >= 1 ? mb[1] : 0.f;
  float b_nx = (own && last >= 1) ? betaT[static_cast<size_t>(tb[1]) * K + i] : 0.f;
  int t_nx2 = last >= 2 ? tb[2] : 0;
  for (int n = 1; n <= last; ++n) {
    const float bn = b_nx, mn = m_nx;
    if (n + 1 <= last) {
      m_nx = mb[n + 1];
      b_nx = own ? betaT[static_cast<size_t>(t_nx2) * K + i] : 0.f;
    }
    if (n + 2 <= last) t_nx2 = tb[n + 2];
    if (mn > 0.f) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (kWarp) {
#pragma unroll
        for (int l = 0; l < 32; ++l)
          s[l & 3] = fmaf(arow[l], __shfl_sync(0xffffffffu, a_i, l), s[l & 3]);
      } else if (own) {
        const float* ap = row(n - 1);
        int l = 0;
        for (; l + 4 <= K; l += 4) {
          s[0] = fmaf(Ai[l], ap[l], s[0]);
          s[1] = fmaf(Ai[l + 1], ap[l + 1], s[1]);
          s[2] = fmaf(Ai[l + 2], ap[l + 2], s[2]);
          s[3] = fmaf(Ai[l + 3], ap[l + 3], s[3]);
        }
        for (; l < K; ++l) s[0] = fmaf(Ai[l], ap[l], s[0]);
      }
      const float f = own ? bn * ((s[0] + s[1]) + (s[2] + s[3])) : 0.f;
      const float cn = hm_sum(f, red, nw) + kEps;
      if (own) a_i = f / cn;
      if (c != nullptr && i == 0) c[n] = cn;
      logz += logf(cn);
    } else if (c != nullptr && i == 0) {
      c[n] = 1.f;
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
template <bool kFinal, bool kWarp>
__device__ __forceinline__ float hm_backward(
    const float* __restrict__ A, const float* __restrict__ betaT, const int* tb,
    const float* mb, const float* a, const float* c, float* S, float* gbuf, float* rd,
    int last, int K) {
  const int l = threadIdx.x;
  const bool own = l < K;
  const int Ka = hm_stride(K), Kv = blockDim.x;
  float acol[kWarp ? 32 : 1], scol[kWarp && !kFinal ? 32 : 1];
  if constexpr (kWarp) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      acol[k] = (own && k < K) ? A[k * Ka + l] : 0.f;
      if constexpr (!kFinal) scol[k] = 0.f;
    }
  }
  float be = 1.f;
  if (last >= 1) {
    float m_nx = mb[last];
    float b_nx = own ? betaT[static_cast<size_t>(tb[last]) * K + l] : 0.f;
    int t_nx2 = last >= 2 ? tb[last - 1] : 0;
    int par = 0;   // g's buffer, flipped on every real slot (each has a barrier)
    for (int n = last; n >= 1; --n) {
      const float bn = b_nx, mn = m_nx;
      if (n - 1 >= 1) {
        m_nx = mb[n - 1];
        b_nx = own ? betaT[static_cast<size_t>(t_nx2) * K + l] : 0.f;
      }
      if (n - 2 >= 1) t_nx2 = tb[n - 2];
      if (mn > 0.f) {
        const float gl = own ? (bn * be) / c[n] : 0.f;
        if (kFinal && own) rd[static_cast<size_t>(n) * K + l] = a[static_cast<size_t>(n) * K + l] * be;
        const float al = own ? a[static_cast<size_t>(n - 1) * K + l] : 0.f;
        float e[2] = {0.f, 0.f};
        if constexpr (kWarp) {
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const float gk = __shfl_sync(0xffffffffu, gl, k);
            e[k & 1] = fmaf(acol[k], gk, e[k & 1]);
            if constexpr (!kFinal) scol[k] = fmaf(gk, al, scol[k]);
          }
        } else {
          float* g = gbuf + par * Kv;
          par ^= 1;
          if (own) g[l] = gl;
          __syncthreads();
          if (own) {
            int k = 0;
            for (; k + 2 <= K; k += 2) {
              const float g0 = g[k], g1 = g[k + 1];
              e[0] = fmaf(A[k * Ka + l], g0, e[0]);
              e[1] = fmaf(A[(k + 1) * Ka + l], g1, e[1]);
              if (!kFinal) {
                S[k * K + l] = fmaf(g0, al, S[k * K + l]);
                S[(k + 1) * K + l] = fmaf(g1, al, S[(k + 1) * K + l]);
              }
            }
            if (k < K) {
              e[0] = fmaf(A[k * Ka + l], g[k], e[0]);
              if (!kFinal) S[k * K + l] = fmaf(g[k], al, S[k * K + l]);
            }
          }
        }
        if (own) be = e[0] + e[1];
      } else if (kFinal && own) {
        rd[static_cast<size_t>(n) * K + l] = 0.f;
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
template <bool kFinal>
__device__ __forceinline__ float hm_pass(const float* A, const float* betaT, const int* tb,
                                         const float* mb, float p0, float* a, float* c,
                                         float* red, float* S, float* gbuf, float* rd, int last,
                                         int K, int nw) {
  if (nw == 1) {
    hm_forward<false, true>(A, betaT, tb, mb, p0, a, c, red, last, K, nw);
    return hm_backward<kFinal, true>(A, betaT, tb, mb, a, c, S, gbuf, rd, last, K);
  }
  hm_forward<false, false>(A, betaT, tb, mb, p0, a, c, red, last, K, nw);
  return hm_backward<kFinal, false>(A, betaT, tb, mb, a, c, S, gbuf, rd, last, K);
}

__global__ void __launch_bounds__(kHmMaxThreads) hmtm_estep_kernel(
    const float* __restrict__ betaT,     // [V, K] beta^T + eps
    const int* __restrict__ terms,       // [B, L]
    const float* __restrict__ tmask,     // [B, L] 1 on real tokens
    const float* __restrict__ doc_mask,  // [B]
    const float* __restrict__ eta,       // [K]
    const float* __restrict__ alpha,     // [K, K]
    const float* __restrict__ tau_in,    // [B, K]
    const float* __restrict__ gamma_in,  // [B, K, K]
    float* __restrict__ tau_out, float* __restrict__ gamma_out,
    float* __restrict__ r,               // [B, L, K]
    float* scratch,                      // [B, per_doc] when mode > 0
    int64_t per_doc, int L, int K, int mode, int viter, float vtol) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nw = blockDim.x >> 5;
  const int Ka = hm_stride(K), Kv = blockDim.x;
  const bool own = tid < K;
  float* A = smem;
  float* gbuf = A + static_cast<size_t>(K) * Ka;   // [2, Kv]
  float* red = gbuf + 2 * Kv;                       // [32]: c, |dgamma|^2, sum tau, last
  float* rest = red + 32;
  float* scr = scratch + static_cast<size_t>(b) * per_doc;
  float *S, *a;
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
  float* c = a + static_cast<size_t>(L) * K;
  const int* tb = terms + static_cast<size_t>(b) * L;
  const float* mb = tmask + static_cast<size_t>(b) * L;
  const size_t dk = static_cast<size_t>(b) * K, dkk = dk * K;
  float* rd = r + static_cast<size_t>(b) * L * K;

  const int last = hm_last(mb, L, red + 24, nw);
  hm_build_A(gamma_in + dkk, A, S, K);
  if (own)
    for (int i = 0; i < K; ++i) {
      gamma_out[dkk + i * K + tid] = gamma_in[dkk + i * K + tid];
      S[i * K + tid] = 0.f;
    }
  float tau = own ? tau_in[dk + tid] : 0.f;
  if (own) tau_out[dk + tid] = tau;
  float p0 = hm_p0(tau, own, red + 16, nw);
  const float eta_i = own ? eta[tid] : 0.f;
  __syncthreads();

  bool active = doc_mask[b] > 0.f;
  for (int it = 0; it < viter && active; ++it) {
    const float be0 = hm_pass<false>(A, betaT, tb, mb, p0, a, c, red, S, gbuf, nullptr, last,
                                     K, nw);
    // tau = eta + r_0; gamma = alpha + A o S, column l by thread l, staged
    // in S for the new A
    float d2 = 0.f, cs = 0.f;
    if (own) {
      tau = eta_i + a[tid] * be0 * mb[0];
      for (int i = 0; i < K; ++i) {
        const size_t o = dkk + i * K + tid;
        const float gn = alpha[i * K + tid] + A[i * Ka + tid] * S[i * K + tid];
        const float d = gn - gamma_out[o];
        d2 = fmaf(d, d, d2);
        gamma_out[o] = gn;
        S[i * K + tid] = gn;
        cs += gn;
      }
      tau_out[dk + tid] = tau;
    }
    const float delta2 = hm_sum(d2, red + 8, nw);
    if (own) {
      const float dcs = digamma_series(cs);
      for (int i = 0; i < K; ++i) {
        A[i * Ka + tid] = expf(digamma_series(S[i * K + tid]) - dcs);
        S[i * K + tid] = 0.f;
      }
    }
    p0 = hm_p0(tau, own, red + 16, nw);
    active = sqrtf(delta2) >= vtol;
    __syncthreads();   // the new A complete before the next forward
  }

  // q(z_n) from the final state, on every row
  const float be0 = hm_pass<true>(A, betaT, tb, mb, p0, a, c, red, S, gbuf, rd, last, K, nw);
  if (own) rd[tid] = a[tid] * be0 * mb[0];
  const int tail = last + 1 > 1 ? last + 1 : 1;
  for (size_t idx = tid; idx < static_cast<size_t>(L - tail) * K; idx += blockDim.x)
    rd[static_cast<size_t>(tail) * K + idx] = 0.f;
}

__global__ void __launch_bounds__(kHmMaxThreads) hmtm_logz_kernel(
    const float* __restrict__ betaT, const int* __restrict__ terms,
    const float* __restrict__ tmask, const float* __restrict__ tau,
    const float* __restrict__ gamma, float* __restrict__ logz, int L, int K) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nw = blockDim.x >> 5;
  const bool own = tid < K;
  float* A = smem;
  float* ring = A + static_cast<size_t>(K) * hm_stride(K);   // [2, Kv]
  float* red = ring + 2 * blockDim.x;
  const int* tb = terms + static_cast<size_t>(b) * L;
  const float* mb = tmask + static_cast<size_t>(b) * L;
  const int last = hm_last(mb, L, red + 24, nw);
  hm_build_A(gamma + static_cast<size_t>(b) * K * K, A, nullptr, K);
  const float p0 = hm_p0(own ? tau[static_cast<size_t>(b) * K + tid] : 0.f, own, red + 16, nw);
  __syncthreads();
  const float z = nw == 1
      ? hm_forward<true, true>(A, betaT, tb, mb, p0, ring, nullptr, red, last, K, nw)
      : hm_forward<true, false>(A, betaT, tb, mb, p0, ring, nullptr, red, last, K, nw);
  if (tid == 0) logz[b] = z;
}

}  // namespace tmvb

extern "C" {

// Which buffers a document of L slots keeps in shared memory (HmShape's
// mode: 0, 1 or 2), -1 when the device cannot be queried, -2 when K
// topics do not fit.
int tmvb_hmtm_estep_mode(int64_t L, int64_t K) {
  tmvb::HmShape s;
  const int rc = tmvb::hm_shape(L, K, &s);
  return rc == tmvb::kHmTooWide ? -2 : (rc != 0 ? -1 : s.mode);
}

// Floats of device scratch a document needs; -1 or -2 as above.
int64_t tmvb_hmtm_estep_scratch(int64_t L, int64_t K) {
  tmvb::HmShape s;
  const int rc = tmvb::hm_shape(L, K, &s);
  return rc == tmvb::kHmTooWide ? -2 : (rc != 0 ? -1 : s.scratch);
}

int tmvb_hmtm_estep(const float* betaT, const int* terms, const float* tmask,
                    const float* doc_mask, const float* eta, const float* alpha,
                    const float* tau_in, const float* gamma_in, float* tau_out,
                    float* gamma_out, float* r, float* scratch, int64_t B, int64_t L,
                    int64_t K, int viter, float vtol, void* stream) {
  if (B == 0) return 0;
  tmvb::HmShape s;
  const int rc = tmvb::hm_shape(L, K, &s);
  if (rc != 0) return static_cast<int>(rc == tmvb::kHmTooWide ? cudaErrorInvalidValue : rc);
  if (s.scratch > 0 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = tmvb::allow_smem(tmvb::hmtm_estep_kernel, s.bytes);
  if (err != cudaSuccess) return tmvb::fail(err);
  tmvb::hmtm_estep_kernel<<<static_cast<unsigned>(B), tmvb::hm_threads(static_cast<int>(K)),
                            s.bytes, static_cast<cudaStream_t>(stream)>>>(
      betaT, terms, tmask, doc_mask, eta, alpha, tau_in, gamma_in, tau_out, gamma_out, r,
      scratch, s.scratch, static_cast<int>(L), static_cast<int>(K), s.mode, viter, vtol);
  return static_cast<int>(cudaGetLastError());
}

int tmvb_hmtm_logz(const float* betaT, const int* terms, const float* tmask,
                   const float* tau, const float* gamma, float* logz, int64_t B, int64_t L,
                   int64_t K, void* stream) {
  if (B == 0) return 0;
  tmvb::HmShape s;
  const int rc = tmvb::hm_shape(L, K, &s);
  if (rc != 0) return static_cast<int>(rc == tmvb::kHmTooWide ? cudaErrorInvalidValue : rc);
  const size_t bytes = tmvb::hm_base_floats(static_cast<int>(K)) * sizeof(float);
  const cudaError_t err = tmvb::allow_smem(tmvb::hmtm_logz_kernel, bytes);
  if (err != cudaSuccess) return tmvb::fail(err);
  tmvb::hmtm_logz_kernel<<<static_cast<unsigned>(B), tmvb::hm_threads(static_cast<int>(K)),
                           bytes, static_cast<cudaStream_t>(stream)>>>(
      betaT, terms, tmask, tau, gamma, logz, static_cast<int>(L), static_cast<int>(K));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
