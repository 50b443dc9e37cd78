// M-step scatter: acc[ids[t], :] += w[t, :] over the kept token slots of
// one chunk, in a fixed order, with no float atomics.
//
// Replaces the TPU kernel `pallas_once` (bench_scatter_pallas.py:40, body
// `kern` :21): the reference's beta_temp[:, terms] += phi .* counts'
// (LDA.jl:129-132) and its kappa/alef/he analogues.  The TPU kernel keeps
// the whole [V, W] table in VMEM and walks the tokens serially; on an H100
// the table does not fit shared memory (NSF: V = 25,319, K = 100 is
// 10 MB) and a serial walk would use one SM of 132.
//
// What bounds it on an H100: bytes.  Every kept row is read once and every
// touched acc row is read and written once: for the widest NSF chunk
// (114,090 kept rows, 23,012 ids, W = 100) that is 45.6 MB + 18.4 MB, about
// 19 us at 3.35 TB/s, against ~0.1 GFLOP of additions (~2 us at 67 TFLOP/s).
// No tensor cores: the work is additions of gathered rows, not a product.
//
// The ids of a chunk never change during a run, so the caller builds a plan
// once (kernels/scatter_rows.py): the slots whose weight factor is nonzero,
// stably sorted by id, cut into runs of one id and each run into pieces of
// at most P rows.  Zero-weight slots (padding, which all point at id 0)
// are left out: adding an exact zero changes no bit.
//
// One warp per piece, kPiecesPerBlock pieces per block, the lanes over the
// W columns: 16-byte loads and stores where W % 4 == 0 and the rows are
// 16-byte aligned (W = 100), else 4-byte ones with four columns a lane (W =
// 101, 50, 51 in one pass over the rows).  A piece averages ~5 rows on the
// main paths, so a whole block per piece (the first design) left most of
// its threads waiting on one short dependent chain; a warp per piece keeps
// 8 pieces' loads in flight per block.  The lanes load the piece's row
// indices together and pass them on by shuffle, and each lane issues the
// loads of 8 rows before it adds them, in slot order (fewer rows in flight
// measured slower: the gather is bound by the latency of its loads).  A piece that is a
// whole run adds its rows into its acc row (one writer per row); a piece of
// a longer run writes its partial to a scratch row.  A second launch, one
// block per split run, adds each run's partials: warp v sums the v-th
// eighth of them in piece order, then the eight sums are added in warp
// order.  (A one-launch design, where the last piece of a run to arrive
// adds the run's partials, was measured too: no faster on the main paths'
// chunks, slower on a long run, whose partials one warp then adds alone.)
// Every sum runs in one fixed order, so the result is bitwise repeatable.
//
// The float64 mode (tmvb_scatter_rows_f64): the same plan and launches on
// double rows, DTM's, CTM's and fCTM's M-step statistic on a float64
// state.  Bound: bytes, doubled.  16-byte lanes hold two doubles (double2,
// two column pairs a lane so W = 100 takes one pass over the rows, 4
// rows' loads in flight: the f32 mode's 128 bytes a lane); else 8-byte
// lanes with four columns each.

#include "common.cuh"

namespace tmvb {

constexpr int kPiecesPerBlock = 8;  // one warp each
constexpr int kScatterThreads = 32 * kPiecesPerBlock;

template <typename T>
__device__ __forceinline__ void add_to(T& s, const T& v);
template <>
__device__ __forceinline__ void add_to<float>(float& s, const float& v) { s += v; }
template <>
__device__ __forceinline__ void add_to<float4>(float4& s, const float4& v) {
  s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
}
template <>
__device__ __forceinline__ void add_to<double>(double& s, const double& v) { s += v; }
template <>
__device__ __forceinline__ void add_to<double2>(double2& s, const double2& v) {
  s.x += v.x; s.y += v.y;
}

// One warp sums rows[lo:hi) of w (rows of n elements of T) into dst, for
// the columns k = lane + 32 c + 32 C j: each lane holds C accumulators, so
// one pass over the rows covers 32 C columns, and it issues the loads of U
// rows (U C loads) before it adds them, in slot order.  `from_dst`: dst's
// own values are the first term.
template <typename T, int C, int U>
__device__ __forceinline__ void warp_sum_rows(const T* __restrict__ w, const int* __restrict__ rows,
                                              int lo, int hi, int n, T* dst, bool from_dst) {
  const int lane = threadIdx.x & 31;
  for (int k0 = lane; k0 - lane < n; k0 += 32 * C) {
    bool on[C];
    T s[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      on[c] = k0 + 32 * c < n;
      s[c] = (from_dst && on[c]) ? dst[k0 + 32 * c] : T{};
    }
    for (int base = lo; base < hi; base += 32) {
      const int m = min(32, hi - base);
      const int mine = lane < m ? rows[base + lane] : 0;
      int i = 0;
      for (; i + U <= m; i += U) {
        int r[U];
#pragma unroll
        for (int u = 0; u < U; ++u) r[u] = __shfl_sync(0xffffffffu, mine, i + u);
        T v[U][C];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (on[c]) v[u][c] = w[static_cast<size_t>(r[u]) * n + k0 + 32 * c];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (on[c]) add_to(s[c], v[u][c]);
      }
      for (; i < m; ++i) {
        const int r = __shfl_sync(0xffffffffu, mine, i);
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (on[c]) add_to(s[c], w[static_cast<size_t>(r) * n + k0 + 32 * c]);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (on[c]) dst[k0 + 32 * c] = s[c];
  }
}

template <typename T, int C, int U>
__global__ void __launch_bounds__(kScatterThreads) scatter_pieces_kernel(
    const T* __restrict__ w,              // [T, n] token rows
    const int* __restrict__ rows,         // [n_kept] kept slots, sorted by id
    const int* __restrict__ piece_start,  // [n_pieces + 1] offsets into rows
    const int* __restrict__ piece_id,     // [n_pieces] the piece's id
    const int* __restrict__ piece_out,    // [n_pieces] -1: into acc, else scratch row
    T* __restrict__ acc,                  // [V, n]
    T* __restrict__ scratch,              // [n_scratch, n]
    int n_pieces, int n) {
  const int p = blockIdx.x * kPiecesPerBlock + (threadIdx.x >> 5);
  if (p >= n_pieces) return;  // a whole warp; no block barrier follows
  const int out = piece_out[p];
  T* dst = out < 0 ? acc + static_cast<size_t>(piece_id[p]) * n
                   : scratch + static_cast<size_t>(out) * n;
  warp_sum_rows<T, C, U>(w, rows, piece_start[p], piece_start[p + 1], n, dst, out < 0);
}

// One block per split run: warp v adds the partials of its share of the
// run's pieces (consecutive, in piece order), then warp 0 adds the warps'
// sums in warp order into the acc row.
template <typename T>
__global__ void __launch_bounds__(kScatterThreads) scatter_runs_kernel(
    const T* __restrict__ scratch,        // [n_scratch, n] piece partials
    const int* __restrict__ run_start,    // [n_runs + 1] offsets into scratch
    const int* __restrict__ run_id,       // [n_runs] the run's id
    T* __restrict__ acc,                  // [V, n]
    int n) {
  __shared__ T part[kPiecesPerBlock][32];
  const int r = blockIdx.x, lane = threadIdx.x & 31, v = threadIdx.x >> 5;
  const int lo = run_start[r], hi = run_start[r + 1];
  const int share = (hi - lo + kPiecesPerBlock - 1) / kPiecesPerBlock;
  const int a = min(hi, lo + v * share), b = min(hi, a + share);
  T* dst = acc + static_cast<size_t>(run_id[r]) * n;
  for (int k0 = 0; k0 < n; k0 += 32) {
    const int k = k0 + lane;
    T s{};
    if (k < n)
      for (int j = a; j < b; ++j) add_to(s, scratch[static_cast<size_t>(j) * n + k]);
    part[v][lane] = s;
    __syncthreads();
    if (v == 0 && k < n) {
      T t = dst[k];
#pragma unroll
      for (int u = 0; u < kPiecesPerBlock; ++u) add_to(t, part[u][lane]);
      dst[k] = t;
    }
    __syncthreads();
  }
}

template <typename T, int C, int U>
int launch_scatter(const void* w, const int* rows, const int* piece_start, const int* piece_id,
                   const int* piece_out, const int* run_start, const int* run_id, void* acc,
                   void* scratch, int64_t n_pieces, int64_t n_runs, int n, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((n_pieces + kPiecesPerBlock - 1) / kPiecesPerBlock);
  scatter_pieces_kernel<T, C, U><<<blocks, kScatterThreads, 0, s>>>(
      static_cast<const T*>(w), rows, piece_start, piece_id, piece_out,
      static_cast<T*>(acc), static_cast<T*>(scratch), static_cast<int>(n_pieces), n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_runs == 0) return static_cast<int>(err);
  scatter_runs_kernel<T><<<static_cast<unsigned>(n_runs), kScatterThreads, 0, s>>>(
      static_cast<const T*>(scratch), run_start, run_id, static_cast<T*>(acc), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tmvb

// vec = 1 when W % 4 == 0 and w, acc and scratch are 16-byte aligned.
extern "C" int tmvb_scatter_rows(const float* w, const int* rows, const int* piece_start,
                                 const int* piece_id, const int* piece_out,
                                 const int* run_start, const int* run_id, float* acc,
                                 float* scratch, int64_t n_pieces, int64_t n_runs, int64_t W,
                                 int vec, void* stream) {
  if (n_pieces == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(vec ? W / 4 : W);
  // 16-byte lanes: one column group a lane, 8 rows' loads in flight;
  // 4-byte lanes: four columns a lane (W = 101 in one pass over the rows),
  // 8 rows' loads in flight
  if (vec)
    return tmvb::launch_scatter<float4, 1, 8>(w, rows, piece_start, piece_id, piece_out, run_start,
                                           run_id, acc, scratch, n_pieces, n_runs, n, s);
  return tmvb::launch_scatter<float, 4, 8>(w, rows, piece_start, piece_id, piece_out, run_start,
                                        run_id, acc, scratch, n_pieces, n_runs, n, s);
}

// The float64 mode: the same plan and launches on double rows.  vec = 1
// when W % 2 == 0 and w, acc and scratch are 16-byte aligned: double2
// lanes, two column pairs a lane (W = 100 in one pass over the rows), 4
// rows' loads in flight (the f32 mode's 128 bytes a lane); else 8-byte
// lanes, four columns a lane, 8 rows' loads in flight.
extern "C" int tmvb_scatter_rows_f64(const double* w, const int* rows, const int* piece_start,
                                     const int* piece_id, const int* piece_out,
                                     const int* run_start, const int* run_id, double* acc,
                                     double* scratch, int64_t n_pieces, int64_t n_runs,
                                     int64_t W, int vec, void* stream) {
  if (n_pieces == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(vec ? W / 2 : W);
  if (vec)
    return tmvb::launch_scatter<double2, 2, 4>(w, rows, piece_start, piece_id, piece_out,
                                              run_start, run_id, acc, scratch, n_pieces, n_runs,
                                              n, s);
  return tmvb::launch_scatter<double, 4, 8>(w, rows, piece_start, piece_id, piece_out, run_start,
                                           run_id, acc, scratch, n_pieces, n_runs, n, s);
}
