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
// The float64 mode (tmvb_scatter_rows_f64): DTM's, CTM's, fCTM's and
// every other family's M-step statistic on a float64 state.  Bound: bytes,
// doubled.  The float32 mode's plan and launches on double rows lost to
// index_add_ on DTM's rows (NVIDIA H100 80GB HBM3, 700 W: A rows, W = 20,
// ~2 rows a piece, 117.9 us against 118.7 and a 22.5 us bound, 22 of a
// warp's 32 lanes without a column; the per-slice rows, W = 41, 12 runs of
// ~85 rows, 8.1 us against 4.1, one warp walking each run 8 rows at a
// time).  Its own design (scatter_groups_kernel): G lanes a row, G the
// least of 2, 4, 8, 16 whose C = 4 vectors a lane (16-byte double2 where
// W is even and the rows 16-byte aligned, else doubles) cover the row, so
// a warp takes 32 / G pieces at once (W = 20: 8 pieces a warp, 64 a CTA).
// Wider rows (fLDA's W = 101) keep the float32 mode's design on double
// rows: there a warp a piece already fills its lanes, and the new kernel
// at G = 32 ran slower (116.5 us against 72.5 at W = 101; 122 registers,
// 2 CTAs an SM).  A piece of more than kLongRows rows takes a whole CTA:
// its rows dealt over the CTA's groups, each group's sum in registers, the
// groups folded by a butterfly over the warp, the warps' in warp order
// through shared memory by the threads of the row's columns, added to the
// acc row (the per-slice rows: 12 CTAs, ~6 rows a group, one round of
// loads).  Measured in turns (tools/kernel_ab.py; PERF.md section 6): A
// rows 119.2 -> 42.1-42.2 us, per-slice rows 8.1-8.2 -> 3.35-3.41
// (index_add_ 4.0-4.1), LDA's W = 100 77.0 -> 71.0-71.2.  The
// plan's pieces come to the kernel as `tasks` (row start, rows, id, out;
// the long pieces first), built once per plan on the host
// (kernels/scatter_rows.py), so a group reads its piece in one round of
// loads.  Each lane holds the ids of its group's rows (up to kLongRows a
// short piece) from one load, and issues the loads of U rows (C U
// vectors) before it adds them.  Split runs (more than PIECE_ROWS rows)
// keep the second launch, scatter_runs_kernel; a plan with none takes one
// launch.  Every sum in one fixed order: same inputs, same bits.

#include "common.cuh"

namespace tmvb {

constexpr int kPiecesPerBlock = 8;  // one warp each
constexpr int kScatterThreads = 32 * kPiecesPerBlock;
// The float64 mode: a piece of more rows takes a CTA (kernels/
// scatter_rows.py's LONG_ROWS, which orders the tasks).
constexpr int kLongRows = 16;

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

// The float64 mode's design (header): one group of G lanes sums rows lo +
// stride i, i < cnt, of w (rows of n elements of T) into s for the
// columns col0 + G c, c < C; cnt_warp is the largest cnt of the warp's
// groups, so every lane runs the same rounds (the shuffles are the
// warp's).  Lane sub of the group loads the ids of rows sub + G q, q < NI,
// at once; then U rows' loads are issued before they are added, in row
// order.
template <typename T, int G, int C, int U, int NI>
__device__ __forceinline__ void group_rows(T (&s)[C], const bool (&on)[C],
                                           const T* __restrict__ w, const int* __restrict__ rows,
                                           int lo, int cnt, int stride, int cnt_warp, int n,
                                           int col0) {
  const int sub = threadIdx.x % G;
  for (int base = 0; base < cnt_warp; base += G * NI) {
    int ids[NI];
#pragma unroll
    for (int q = 0; q < NI; ++q) {
      const int i = base + sub + G * q;
      ids[q] = i < cnt ? rows[lo + i * stride] : 0;
    }
#pragma unroll
    for (int q = 0; q < NI; ++q) {
      const int b0 = base + G * q;
      if (b0 >= cnt_warp) break;
      for (int i0 = 0; i0 < G && b0 + i0 < cnt_warp; i0 += U) {
        int r[U];
        T v[U][C];
#pragma unroll
        for (int u = 0; u < U; ++u) r[u] = __shfl_sync(0xffffffffu, ids[q], (i0 + u) % G, G);
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (on[c] && i0 + u < G && b0 + i0 + u < cnt)
              v[u][c] = w[static_cast<size_t>(r[u]) * n + col0 + G * c];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (on[c] && i0 + u < G && b0 + i0 + u < cnt) add_to(s[c], v[u][c]);
      }
    }
  }
}

__device__ __forceinline__ double shfl_xor_t(double v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ double2 shfl_xor_t(double2 v, int o) {
  return make_double2(__shfl_xor_sync(0xffffffffu, v.x, o), __shfl_xor_sync(0xffffffffu, v.y, o));
}

// A task's four ints, four loads in one round trip (a plan's tasks may be
// a view at any 4-byte offset of a streamed batch's buffer).
__device__ __forceinline__ int4 task_at(const int* __restrict__ tasks, int t) {
  const int* p = tasks + 4 * static_cast<size_t>(t);
  return make_int4(p[0], p[1], p[2], p[3]);
}

// tasks[t] = (row start, rows, id, out) of the plan's pieces, the n_long
// long ones (more than kLongRows rows) first: CTA t < n_long takes long
// piece t with all its groups; the others take NG short pieces each, one a
// group.  out < 0: the piece is a whole run and adds into acc[id]; else it
// writes its partial to scratch row out (a split run's piece).
template <typename T, int G, int C, int U, int NI>
__global__ void __launch_bounds__(kScatterThreads) scatter_groups_kernel(
    const T* __restrict__ w,              // [T, n] token rows
    const int* __restrict__ rows,         // [n_kept] kept slots, sorted by id
    const int* __restrict__ tasks,        // [n_tasks, 4] (start, rows, id, out)
    T* __restrict__ acc,                  // [V, n]
    T* __restrict__ scratch,              // [n_scratch, n]
    int n_tasks, int n_long, int n) {
  constexpr int S = 32 / G;                     // groups a warp
  constexpr int NG = kPiecesPerBlock * S;       // groups a CTA
  __shared__ T part[kPiecesPerBlock][G * C];   // n <= G C: one pass over the rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = lane / G, sub = lane % G, grp = warp * S + gi;
  if (static_cast<int>(blockIdx.x) < n_long) {
    // a long piece over the CTA's NG groups: group g takes rows g, g + NG, ...
    const int4 tk = task_at(tasks, blockIdx.x);
    const int cnt = tk.y > grp ? (tk.y - grp + NG - 1) / NG : 0;
    const int cnt_warp = (tk.y - warp * S + NG - 1) / NG;   // its first group's
    T* dst = tk.w < 0 ? acc + static_cast<size_t>(tk.z) * n : scratch + static_cast<size_t>(tk.w) * n;
    const bool folds = static_cast<int>(threadIdx.x) < n;
    const T pre = (folds && tk.w < 0) ? dst[threadIdx.x] : T{};
    bool on[C];
    T s[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      on[c] = sub + G * c < n;
      s[c] = T{};
    }
    group_rows<T, G, C, U, NI>(s, on, w, rows, tk.x + grp, cnt, NG, cnt_warp, n, sub);
    // the warp's S groups by a butterfly in one fixed order: every lane of
    // the warp ends with the same sums
#pragma unroll
    for (int o = G; o < 32; o <<= 1)
#pragma unroll
      for (int c = 0; c < C; ++c) add_to(s[c], shfl_xor_t(s[c], o));
    if (lane < G)
#pragma unroll
      for (int c = 0; c < C; ++c) part[warp][sub + G * c] = s[c];
    __syncthreads();
    if (folds) {
      T t = pre;
#pragma unroll
      for (int v = 0; v < kPiecesPerBlock; ++v) add_to(t, part[v][threadIdx.x]);
      dst[threadIdx.x] = t;
    }
    return;
  }
  // short pieces, one a group
  const int t = n_long + (static_cast<int>(blockIdx.x) - n_long) * NG + grp;
  const int4 tk = t < n_tasks ? task_at(tasks, t) : make_int4(0, 0, 0, 0);
  const int cnt_warp = __reduce_max_sync(0xffffffffu, tk.y);
  if (cnt_warp == 0) return;   // the whole warp: its groups are past the tasks
  T* dst = tk.w < 0 ? acc + static_cast<size_t>(tk.z) * n : scratch + static_cast<size_t>(tk.w) * n;
  bool on[C];
  T s[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    on[c] = tk.y > 0 && sub + G * c < n;
    s[c] = (on[c] && tk.w < 0) ? dst[sub + G * c] : T{};
  }
  group_rows<T, G, C, U, NI>(s, on, w, rows, tk.x, tk.y, 1, cnt_warp, n, sub);
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (on[c]) dst[sub + G * c] = s[c];
}

template <typename T, int G>
int launch_groups(const void* w, const int* rows, const int* tasks, const int* run_start,
                  const int* run_id, void* acc, void* scratch, int64_t n_tasks, int64_t n_long,
                  int64_t n_runs, int n, cudaStream_t s) {
  constexpr int C = 4;
  constexpr int U = sizeof(T) == 16 ? 4 : 8;   // rows in flight: 256 bytes of loads a lane
  constexpr int NI = G >= kLongRows ? 1 : kLongRows / G;
  constexpr int NG = kPiecesPerBlock * (32 / G);
  const int64_t blocks = n_long + (n_tasks - n_long + NG - 1) / NG;
  scatter_groups_kernel<T, G, C, U, NI><<<static_cast<unsigned>(blocks), kScatterThreads, 0, s>>>(
      static_cast<const T*>(w), rows, tasks, static_cast<T*>(acc),
      static_cast<T*>(scratch), static_cast<int>(n_tasks), static_cast<int>(n_long), n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_runs == 0) return static_cast<int>(err);
  scatter_runs_kernel<T><<<static_cast<unsigned>(n_runs), kScatterThreads, 0, s>>>(
      static_cast<const T*>(scratch), run_start, run_id, static_cast<T*>(acc), n);
  return static_cast<int>(cudaGetLastError());
}

// The float64 mode's lanes a row: the least G whose C = 4 vectors a lane
// cover the row's n vectors; 0 past 64 vectors (W > 128 on double2 lanes,
// W > 64 on doubles: fLDA's 101), where the float32 mode's design runs
// (a warp a piece), as fast there.
inline int groups_lanes(int n) {
  return n <= 8 ? 2 : (n <= 16 ? 4 : (n <= 32 ? 8 : (n <= 64 ? 16 : 0)));
}

template <typename T>
int launch_double(const void* w, const int* rows, const int* tasks, const int* run_start,
                  const int* run_id, void* acc, void* scratch, int64_t n_tasks, int64_t n_long,
                  int64_t n_runs, int n, cudaStream_t s) {
  switch (groups_lanes(n)) {
    case 2:
      return launch_groups<T, 2>(w, rows, tasks, run_start, run_id, acc, scratch, n_tasks, n_long,
                                 n_runs, n, s);
    case 4:
      return launch_groups<T, 4>(w, rows, tasks, run_start, run_id, acc, scratch, n_tasks, n_long,
                                 n_runs, n, s);
    case 8:
      return launch_groups<T, 8>(w, rows, tasks, run_start, run_id, acc, scratch, n_tasks, n_long,
                                 n_runs, n, s);
    default:
      return launch_groups<T, 16>(w, rows, tasks, run_start, run_id, acc, scratch, n_tasks,
                                  n_long, n_runs, n, s);
  }
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

// The float64 mode (header): the plan's pieces, as tasks [n_pieces, 4]
// (n_long long ones first) too, and its split runs.  vec = 1 when W % 2
// == 0 and w, acc and scratch are 16-byte aligned: double2 vectors; else
// doubles.  Rows of more than 64 vectors take the float32 mode's design
// on double rows: a warp a piece, double2 lanes of two column pairs (W =
// 100 in one pass over the rows, 4 rows' loads in flight), or 8-byte
// lanes of four columns (W = 101), 8 rows in flight.
extern "C" int tmvb_scatter_rows_f64(const double* w, const int* rows, const int* piece_start,
                                     const int* piece_id, const int* piece_out, const int* tasks,
                                     const int* run_start, const int* run_id, double* acc,
                                     double* scratch, int64_t n_pieces, int64_t n_long,
                                     int64_t n_runs, int64_t W, int vec, void* stream) {
  if (n_pieces == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(vec ? W / 2 : W);
  if (tmvb::groups_lanes(n) == 0) {
    if (vec)
      return tmvb::launch_scatter<double2, 2, 4>(w, rows, piece_start, piece_id, piece_out,
                                                run_start, run_id, acc, scratch, n_pieces,
                                                n_runs, n, s);
    return tmvb::launch_scatter<double, 4, 8>(w, rows, piece_start, piece_id, piece_out,
                                             run_start, run_id, acc, scratch, n_pieces, n_runs,
                                             n, s);
  }
  if (vec)
    return tmvb::launch_double<double2>(w, rows, tasks, run_start, run_id, acc, scratch,
                                        n_pieces, n_long, n_runs, n, s);
  return tmvb::launch_double<double>(w, rows, tasks, run_start, run_id, acc, scratch, n_pieces,
                                     n_long, n_runs, n, s);
}
