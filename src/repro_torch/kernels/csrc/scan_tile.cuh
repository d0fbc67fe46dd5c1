// Device code shared by the chunked recurrent-scan kernels (wkv6.cu, B3,
// and mamba2_ssd.cu, B4).
//
// Both kernels run one CTA of THREADS threads per (batch, head) stream and
// walk its chunks in order, holding the chunk's operands, its score tile and
// the fp32 state in dynamic shared memory.  Every product over shared memory
// is computed in MT x MT register tiles: each thread reads MT values of
// either operand per step of the inner loop and performs MT * MT
// multiply-adds.  Chunks are padded in shared memory to a multiple of MT
// rows; the padding rows are zero, which carries no input and no decay.
#pragma once

#include "goma_tile.cuh"  // goma::to_float, goma::from_float

namespace scan {

constexpr int THREADS = 256;
constexpr int MT = 4;               // register tile edge
constexpr long MAX_SMEM = 232448;   // a CTA's shared memory on sm_90

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The m-th tile (ti, si) of the lower triangle si <= ti, row by row.
__device__ __forceinline__ void tri_index(int m, int& ti, int& si) {
  int t = static_cast<int>((sqrtf(8.f * m + 1.f) - 1.f) * 0.5f);
  while (t * (t + 1) / 2 > m) --t;
  while ((t + 1) * (t + 2) / 2 <= m) ++t;
  ti = t;
  si = m - t * (t + 1) / 2;
}

// Raise the kernel's dynamic shared-memory limit to `bytes` (needed above
// 48 KB) and launch it on B * H CTAs.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int ctas, long bytes, void* stream,
           Args... args) {
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<ctas, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace scan
