// B1: GOMA-planned GEMM for Hopper (sm_90a), C = A @ B on padded shapes.
//
// Replaces the Pallas TPU kernel `goma_matmul` (src/repro/kernels/
// goma_gemm.py: _matmul_kernel, _matmul_kernel_single_k).
//
// One CTA per plan block (bm, bn).  blockIdx.x is rasterised so that the
// plan's walking axis varies fastest (the inner of m and n in the plan's
// grid order).  The k axis, a sequential grid dimension on the TPU, is a
// loop inside the CTA over the plan's bk-deep stages.  A plan block may be
// larger than the registers can hold (the solver bounds it by shared
// memory only), so the CTA walks its block in 64x64 register tiles, each
// with its own full k loop, and writes each tile once, cast to the output
// dtype.  Tiles need not be powers of two; padding has made every block
// whole, so nothing is masked.
//
// What bounds it: at the serving shapes (M <= 64 rows against a
// 4096 x 14336 weight) the weight bytes, i.e. device memory.  This first
// version is deliberately simple: fp32 FMA on the CUDA cores (no tensor
// cores, no TMA, no pipelining), one CTA per plan block.  It is far from
// that bound; PERF.md records by how much.
#include "goma_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(goma::THREADS)
goma_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   T* __restrict__ C, int pm, int pn, int pk, int bm, int bn,
                   int bk, int m_fastest) {
  __shared__ goma::Stage st;
  const int nbm = pm / bm, nbn = pn / bn;
  const int bid = blockIdx.x;
  const int im = m_fastest ? bid % nbm : bid / nbn;
  const int in = m_fastest ? bid / nbm : bid % nbn;
  const int nk = pk / bk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int sm = 0; sm < bm; sm += goma::TILE) {
    for (int sn = 0; sn < bn; sn += goma::TILE) {
      const long row0 = (long)im * bm + sm;
      const long col0 = (long)in * bn + sn;
      float acc[4][4] = {};
      for (int ks = 0; ks < nk; ++ks) {
        const long k0 = (long)ks * bk;
        goma::tile_dot(A + row0 * pk + k0, pk, B + k0 * pn + col0, pn, bk,
                       st, acc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          C[(row0 + ty + 16 * i) * pn + col0 + tx + 16 * j] =
              goma::from_float<T>(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (A, B and C alike).  Returns the
// cudaError_t of the launch; the caller raises if it is not 0.
int goma_matmul_launch(const void* A, const void* B, void* C, int pm, int pn,
                       int pk, int bm, int bn, int bk, int m_fastest,
                       int dtype, void* stream) {
  const int blocks = (pm / bm) * (pn / bn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    goma_matmul_kernel<float><<<blocks, goma::THREADS, 0, s>>>(
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<float*>(C), pm, pn, pk, bm, bn, bk, m_fastest);
  } else {
    goma_matmul_kernel<__nv_bfloat16><<<blocks, goma::THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A),
        static_cast<const __nv_bfloat16*>(B),
        static_cast<__nv_bfloat16*>(C), pm, pn, pk, bm, bn, bk, m_fastest);
  }
  return static_cast<int>(cudaGetLastError());
}

int goma_stage_bytes() { return static_cast<int>(sizeof(goma::Stage)); }

}  // extern "C"
