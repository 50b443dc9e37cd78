// Table rows of a document's slots into shared memory: the asynchronous
// gather shared by the LDA, fLDA and CTPF E-steps (CTPF calls it once per
// table).
#pragma once

#include "common.cuh"

namespace tmvb {

// Rows of compact slots j0 .. j0 + m - 1 into rows[0 .. m), asynchronously,
// by a block of kN threads (16-byte copies when `vec`: K a multiple of
// the elements in 16 bytes, 4 floats or 2 doubles, and the table 16-byte
// aligned; through L1 when kL1, else around it); the padding columns are
// zeroed.  R is float, or double for the float64 modes.  The caller waits
// (cp_async_wait_all) and syncs.
template <int kN, bool kL1 = false, typename R>
__device__ __forceinline__ void load_rows(R* rows, const R* __restrict__ table,
                                          const int* __restrict__ t, const int* mslot, int j0,
                                          int m, int K, int Kp, bool vec) {
  constexpr int E = 16 / sizeof(R);   // elements in 16 bytes
  if (vec) {
    const int G = Kp / E, Gsrc = K / E;
    for (int idx = threadIdx.x; idx < m * G; idx += kN) {
      const int i = idx / G, g = idx - i * G;
      R* dst = rows + static_cast<size_t>(i) * Kp + E * g;
      if (g < Gsrc) {
        const R* src = table + static_cast<size_t>(t[mslot[j0 + i]]) * K + E * g;
        if (kL1)
          cp_async16_ca(dst, src);
        else
          cp_async16(dst, src);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < m * Kp; idx += kN) {
      const int i = idx / Kp, k = idx - i * Kp;
      R* dst = rows + static_cast<size_t>(i) * Kp + k;
      if (k < K)
        cp_async_elem(dst, table + static_cast<size_t>(t[mslot[j0 + i]]) * K + k);
      else
        *dst = R(0);
    }
  }
}

// The warp modes of the pass kernels (lda_estep_pass, flda_estep_pass,
// ctpf_estep_pass):
// a document's slots over w warps, each row read once, straight into
// registers.  A warp takes S = 32 / G slots at once, G lanes a slot: lane
// (i, g) of group i holds topics 4 (g + G v) .. + 3 of its slot's row for
// v < NVL, so one row takes NVL four-wide vectors a lane and the G lanes'
// loads read it whole.  NVL <= 4 at G = 32: K <= 512 in either dtype is
// the modes' reach.  Each kernel picks (G, NVL, w) from L, K and the
// dtype (lda_pass_shape, flda_pass_shape, ctpf_pass_shape; measured on an
// H100, PERF.md).
constexpr int kPassShortDocs = 4;   // documents of one warp each a CTA

// A warp-mode launch's shape; G = 0 past the reach (K > 512).
struct PassShape {
  int G, NVL, w;
};

// Warps for L slots, one per `per`, 1 to 8.
__host__ __device__ inline int warps_per(int64_t L, int per) {
  const int64_t w = (L + per - 1) / per;
  return w < 1 ? 1 : (w > 8 ? 8 : static_cast<int>(w));
}

// Warps a document of L slots takes by default: one per 32 slots up to
// L = 64, then one per 64, at most 8.
__host__ __device__ inline int pass_warps(int64_t L) {
  return L <= 64 ? warps_per(L, 32) : warps_per(L, 64);
}

// The wide rows' shape (K = 129-512: a whole warp a slot), or 0 past them.
__host__ __device__ inline PassShape wide_pass_shape(int64_t L, int64_t K) {
  if (K > 512) return {0, 0, 0};
  return {32, static_cast<int>((K + 127) / 128), pass_warps(L)};
}

// Lanes a slot and topics a lane of the float64 resident designs
// (flda_estep_res_kernel, ctpf_estep_res_kernel): 8 lanes of 4, 8, 13 or
// 16 topics up to K = 128 (13: K = 100 with 4 of 104 columns past it), 16
// lanes of 16 to 256, 32 of 16 to 512; G = 0 past 512.
struct ResShape {
  int G, NV;
};
__host__ __device__ inline ResShape res_lanes(int64_t K) {
  if (K <= 128) return {8, K <= 32 ? 4 : (K <= 64 ? 8 : (K <= 104 ? 13 : 16))};
  return {K <= 256 ? 16 : (K <= 512 ? 32 : 0), 16};
}

// A warp-mode launch's grid, threads and dynamic shared memory (the
// warps' q partials [w, 4 G NVL] when w > 1).
struct PassLaunch {
  unsigned grid;
  int threads;
  size_t smem;
};
template <typename R>
inline PassLaunch pass_launch(int64_t B, int G, int NVL, int w) {
  if (w == 1)
    return {static_cast<unsigned>((B + kPassShortDocs - 1) / kPassShortDocs),
            32 * kPassShortDocs, 0};
  return {static_cast<unsigned>(B), 32 * w, static_cast<size_t>(w) * 4 * G * NVL * sizeof(R)};
}

// Slots of each warp's range: L over w, rounded up.
__host__ __device__ inline int pass_span(int L, int w) { return (L + w - 1) / w; }

// Rows a group holds at once (a row is NVL * sizeof(R) registers a lane):
// what 32 registers take, 16 at G = 16, 1 to 4 rows; a warp has S times
// as many in flight.
template <typename R, int G, int NVL>
__host__ __device__ constexpr int pass_depth() {
  return (G == 16 ? 16 : 32) / (NVL * static_cast<int>(sizeof(R))) >= 4
             ? 4
             : ((G == 16 ? 16 : 32) / (NVL * static_cast<int>(sizeof(R))) >= 2 ? 2 : 1);
}

// The lane's share of one table row into registers, read-only loads
// (ld.global.nc): 16 bytes at a time when `vec` (K a multiple of the
// elements in 16 bytes and the table 16-byte aligned), else element by
// element; `fill` past K.
template <typename R, int G, int NVL>
__device__ __forceinline__ void row_to_regs(typename Real<R>::V4 (&x)[NVL],
                                            const R* __restrict__ row, int K, bool vec, int sub,
                                            R fill = R(0)) {
#pragma unroll
  for (int v = 0; v < NVL; ++v) {
    const int k = 4 * (sub + G * v);
    x[v] = {fill, fill, fill, fill};
    if (vec) {
      if constexpr (sizeof(R) == 4) {
        if (k < K) x[v] = __ldg(reinterpret_cast<const float4*>(row + k));
      } else {
        if (k < K) {
          const double2 a = __ldg(reinterpret_cast<const double2*>(row + k));
          x[v].x = a.x;
          x[v].y = a.y;
        }
        if (k + 2 < K) {
          const double2 a = __ldg(reinterpret_cast<const double2*>(row + k + 2));
          x[v].z = a.x;
          x[v].w = a.y;
        }
      }
    } else {
      if (k < K) x[v].x = __ldg(row + k);
      if (k + 1 < K) x[v].y = __ldg(row + k + 1);
      if (k + 2 < K) x[v].z = __ldg(row + k + 2);
      if (k + 3 < K) x[v].w = __ldg(row + k + 3);
    }
  }
}

// q summed over the warp's S groups, the same topics in each, onto every
// lane: a butterfly over the groups in one fixed order.
template <int G, int NVL, typename V4>
__device__ __forceinline__ void fold_groups(V4 (&q)[NVL]) {
#pragma unroll
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int v = 0; v < NVL; ++v) {
      q[v].x += __shfl_xor_sync(0xffffffffu, q[v].x, o);
      q[v].y += __shfl_xor_sync(0xffffffffu, q[v].y, o);
      q[v].z += __shfl_xor_sync(0xffffffffu, q[v].z, o);
      q[v].w += __shfl_xor_sync(0xffffffffu, q[v].w, o);
    }
}

// The slot of lane `lane` in one round of a warp's 8-slot blocks: the
// round takes blocks b0, b0 + w, b0 + 2 w and b0 + 3 w (the warp's every
// w-th block, 8 lanes each), so that the kept slots, which lead a
// document's row, spread evenly over its w warps; 8 slots are a 32-byte
// sector of 4-byte ids.
__device__ __forceinline__ int round_slot(int b0, int w, int lane) {
  return (b0 + (lane >> 3) * w) * 8 + (lane & 7);
}

// The lane of the n-th set bit of m (n >= 1, at most popc(m)).
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  int p = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int c = __popc(m & ((1u << s) - 1u));
    if (c < n) {
      n -= c;
      m >>= s;
      p += s;
    }
  }
  return p;
}

// The lane whose slot a round's lane `lane` takes when the n kept slots
// (the set bits of `ball`) are compacted into lanes 0 .. n - 1 in slot
// order; the lanes past them repeat the first (only kept slots' rows are
// read).
__device__ __forceinline__ int kept_src(unsigned ball, int n, int lane) {
  return n > 0 ? nth_set_bit(ball, lane < n ? lane + 1 : 1) : 0;
}

// The document, the warp's index within it and the threads it has, for a
// warp-mode CTA: w warps on one document when w > 1, else kPassShortDocs
// documents of one warp each.
struct PassWarp {
  int b, wi, nthr;
};
__device__ __forceinline__ PassWarp pass_warp(int w) {
  const int warp = threadIdx.x >> 5;
  if (w > 1) return {static_cast<int>(blockIdx.x), warp, 32 * w};
  return {static_cast<int>(blockIdx.x) * kPassShortDocs + warp, 0, 32};
}

// The warp's q (group 0's lanes hold it after fold_groups) out: with w = 1
// straight to f(k, q_k); with w > 1 into part [w, 4 G NVL], then after the
// CTA's one barrier the w warps' partials added in warp order, f(k, sum)
// on every topic k < K by the CTA's threads.
template <typename R, int G, int NVL, typename V4, typename F>
__device__ __forceinline__ void pass_out(const V4 (&q)[NVL], R* part, int w, int wi, int K,
                                         F&& store) {
  const int lane = threadIdx.x & 31;
  if (w == 1) {
    if (lane >= G) return;
#pragma unroll
    for (int v = 0; v < NVL; ++v) {
      const int k = 4 * (lane + G * v);
      if (k < K) store(k, q[v].x);
      if (k + 1 < K) store(k + 1, q[v].y);
      if (k + 2 < K) store(k + 2, q[v].z);
      if (k + 3 < K) store(k + 3, q[v].w);
    }
    return;
  }
  constexpr int S = 4 * G * NVL;
  if (lane < G)
#pragma unroll
    for (int v = 0; v < NVL; ++v)
      *reinterpret_cast<V4*>(part + wi * S + 4 * (lane + G * v)) = q[v];
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    R sum = part[k];
    for (int i = 1; i < w; ++i) sum += part[i * S + k];
    store(k, sum);
  }
}

// pass_out for two accumulators a and h of the same layout (CTPF's): with
// w = 1 straight to f(k, a_k, h_k); with w > 1 into part [w, 2 S] (a,
// then h), then after the CTA's one barrier both summed in warp order,
// f(k, sum a, sum h) on every topic k < K by the CTA's threads.
template <typename R, int G, int NVL, typename V4, typename F>
__device__ __forceinline__ void pass_out2(const V4 (&a)[NVL], const V4 (&h)[NVL], R* part, int w,
                                          int wi, int K, F&& store) {
  const int lane = threadIdx.x & 31;
  if (w == 1) {
    if (lane >= G) return;
#pragma unroll
    for (int v = 0; v < NVL; ++v) {
      const int k = 4 * (lane + G * v);
      if (k < K) store(k, a[v].x, h[v].x);
      if (k + 1 < K) store(k + 1, a[v].y, h[v].y);
      if (k + 2 < K) store(k + 2, a[v].z, h[v].z);
      if (k + 3 < K) store(k + 3, a[v].w, h[v].w);
    }
    return;
  }
  constexpr int S = 4 * G * NVL;
  if (lane < G)
#pragma unroll
    for (int v = 0; v < NVL; ++v) {
      *reinterpret_cast<V4*>(part + wi * 2 * S + 4 * (lane + G * v)) = a[v];
      *reinterpret_cast<V4*>(part + wi * 2 * S + S + 4 * (lane + G * v)) = h[v];
    }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    R sa = part[k], sh = part[S + k];
    for (int i = 1; i < w; ++i) {
      sa += part[i * 2 * S + k];
      sh += part[i * 2 * S + S + k];
    }
    store(k, sa, sh);
  }
}

}  // namespace tmvb
