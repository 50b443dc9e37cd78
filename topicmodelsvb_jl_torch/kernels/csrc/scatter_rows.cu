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
// What bounds it on an H100: every kept row is read once (W floats,
// coalesced across the threads of a block) and every touched acc row is
// read and written once, so it is bound by those gathered reads.  The ids
// of a chunk never change during a run, so the caller builds a plan once
// (kernels/scatter_rows.py): the slots whose weight factor is nonzero,
// stably sorted by id, cut into runs of one id and each run into pieces of
// at most P rows.  Zero-weight slots (padding, which all point at id 0)
// are left out: adding an exact zero changes no bit.
//
// Pass 1, one block per piece, threads over the W columns: a piece that is
// a whole run adds its rows in slot order into its acc row (one writer per
// row); a piece of a longer run writes its partial sum to a scratch row.
// Pass 2, one block per split run: adds the run's partials in piece order
// into its acc row.  Every sum runs in one fixed order, so the result is
// bitwise repeatable; long Zipf-head runs are spread over many blocks.

#include "common.cuh"

namespace tmvb {

__global__ void scatter_pieces_kernel(
    const float* __restrict__ w,           // [T, W] token rows
    const int* __restrict__ rows,          // [n] kept slots, sorted by id
    const int* __restrict__ piece_start,   // [n_pieces + 1] offsets into rows
    const int* __restrict__ piece_id,      // [n_pieces] the piece's id
    const int* __restrict__ piece_out,     // [n_pieces] -1: into acc, else scratch row
    float* __restrict__ acc,               // [V, W]
    float* __restrict__ scratch,           // [n_scratch, W]
    int W) {
  const int p = blockIdx.x;
  const int lo = piece_start[p], hi = piece_start[p + 1];
  const int out = piece_out[p];
  float* dst = out < 0 ? acc + static_cast<size_t>(piece_id[p]) * W
                       : scratch + static_cast<size_t>(out) * W;
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    float s = out < 0 ? dst[k] : 0.f;
#pragma unroll 8
    for (int i = lo; i < hi; ++i) s += w[static_cast<size_t>(rows[i]) * W + k];
    dst[k] = s;
  }
}

__global__ void scatter_runs_kernel(
    const float* __restrict__ scratch,     // [n_scratch, W] piece partials
    const int* __restrict__ run_start,     // [n_runs + 1] offsets into scratch
    const int* __restrict__ run_id,        // [n_runs] the run's id
    float* __restrict__ acc,               // [V, W]
    int W) {
  const int r = blockIdx.x;
  const int lo = run_start[r], hi = run_start[r + 1];
  float* dst = acc + static_cast<size_t>(run_id[r]) * W;
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    float s = dst[k];
    for (int j = lo; j < hi; ++j) s += scratch[static_cast<size_t>(j) * W + k];
    dst[k] = s;
  }
}

}  // namespace tmvb

extern "C" int tmvb_scatter_rows(const float* w, const int* rows, const int* piece_start,
                                 const int* piece_id, const int* piece_out,
                                 const int* run_start, const int* run_id, float* acc,
                                 float* scratch, int64_t n_pieces, int64_t n_runs, int64_t W,
                                 void* stream) {
  if (n_pieces == 0) return 0;
  // threads over the columns: one warp for narrow rows, at most 256
  const int threads = static_cast<int>(W >= 256 ? 256 : W <= 32 ? 32 : (W + 31) / 32 * 32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tmvb::scatter_pieces_kernel<<<static_cast<unsigned>(n_pieces), threads, 0, s>>>(
      w, rows, piece_start, piece_id, piece_out, acc, scratch, static_cast<int>(W));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_runs == 0) return static_cast<int>(err);
  tmvb::scatter_runs_kernel<<<static_cast<unsigned>(n_runs), threads, 0, s>>>(
      scratch, run_start, run_id, acc, static_cast<int>(W));
  return static_cast<int>(cudaGetLastError());
}
