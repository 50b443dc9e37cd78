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

}  // namespace tmvb
