// B2: GOMA-chain-planned fused gated MLP for Hopper (sm_90a),
// out = act(A @ Wg, A @ Wu) @ Wd on padded shapes.
//
// Replaces the Pallas TPU kernel `goma_fused_matmul` (src/repro/kernels/
// goma_fused.py: _fused_kernel, _fused_kernel_single_k).
//
// One CTA per m-strip of bm rows.  The two (bm, pff) fp32 strips live in
// dynamic shared memory (the launcher raises the CTA's limit with
// cudaFuncSetAttribute) and accumulate over the plan's bk-deep k stages in
// increasing order, walked in 64x64 register tiles.  After the last stage
// the strips are rounded to the I/O dtype, combined, and rounded again, in
// place; then one full-depth dot per 64x64 output tile multiplies the strip
// by Wd.  The intermediate never reaches device memory.
//
// Bit-identity with the composition of B1 kernels under the plan's
// producer/consumer tilings: both run goma::tile_dot (one fmaf chain per
// element in increasing k) and this file's goma::combine, whose entry point
// for the composition is goma_combine_launch below.
//
// What bounds it: the strips must fit one CTA's 227 KB of shared memory,
// which caps bm * pff (the planner records larger chains as unfused), and
// one CTA per strip leaves most SMs idle at serving widths.  Within that,
// the weight bytes.  Like B1 this first version runs fp32 FMA on the CUDA
// cores: simple and right first.
#include "goma_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(goma::THREADS)
goma_fused_kernel(const T* __restrict__ A, const T* __restrict__ Wg,
                  const T* __restrict__ Wu, const T* __restrict__ Wd,
                  T* __restrict__ Out, int pm, int pff, int pk, int pn2,
                  int bm, int bk, int act) {
  extern __shared__ float smem[];
  goma::Stage& st = *reinterpret_cast<goma::Stage*>(smem);
  float* hg = smem + sizeof(goma::Stage) / sizeof(float);
  float* hu = hg + (long)bm * pff;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long strip0 = (long)blockIdx.x * bm;
  const int nk = pk / bk;

  // producers: strips accumulate over the k stages
  for (int ks = 0; ks < nk; ++ks) {
    const long k0 = (long)ks * bk;
    for (int sm = 0; sm < bm; sm += goma::TILE) {
      for (int sn = 0; sn < pff; sn += goma::TILE) {
        float ag[4][4], au[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const long e = (long)(sm + ty + 16 * i) * pff + sn + tx + 16 * j;
            ag[i][j] = ks == 0 ? 0.0f : hg[e];
            au[i][j] = ks == 0 ? 0.0f : hu[e];
          }
        const T* a = A + (strip0 + sm) * pk + k0;
        goma::tile_dot(a, pk, Wg + k0 * pff + sn, pff, bk, st, ag);
        goma::tile_dot(a, pk, Wu + k0 * pff + sn, pff, bk, st, au);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const long e = (long)(sm + ty + 16 * i) * pff + sn + tx + 16 * j;
            hg[e] = ag[i][j];
            hu[e] = au[i][j];
          }
      }
    }
  }
  __syncthreads();

  // epilogue: round to the I/O dtype, combine, round again (in place)
  for (long e = threadIdx.x; e < (long)bm * pff; e += goma::THREADS) {
    const float g = goma::round_to<T>(hg[e]);
    const float u = goma::round_to<T>(hu[e]);
    hg[e] = goma::round_to<T>(goma::combine(g, u, act));
  }
  __syncthreads();  // tile_dot reads the whole strip

  // consumer: one full-depth dot over the strip per 64x64 output tile
  for (int sm = 0; sm < bm; sm += goma::TILE) {
    for (int sn = 0; sn < pn2; sn += goma::TILE) {
      float acc[4][4] = {};
      goma::tile_dot(hg + (long)sm * pff, pff, Wd + sn, pn2, pff, st, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Out[(strip0 + sm + ty + 16 * i) * pn2 + sn + tx + 16 * j] =
              goma::from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void goma_combine_kernel(const T* __restrict__ G,
                                    const T* __restrict__ U,
                                    T* __restrict__ Out, long n, int act) {
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < n;
       e += (long)gridDim.x * blockDim.x) {
    const float g = goma::to_float(G[e]);
    const float u = goma::to_float(U[e]);
    Out[e] = goma::from_float<T>(goma::combine(g, u, act));
  }
}

template <typename T>
int launch_fused(const void* A, const void* Wg, const void* Wu,
                 const void* Wd, void* Out, int pm, int pff, int pk, int pn2,
                 int bm, int bk, int act, cudaStream_t s) {
  const size_t smem = sizeof(goma::Stage) + 2 * sizeof(float) * bm * pff;
  cudaError_t err = cudaFuncSetAttribute(
      goma_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  goma_fused_kernel<T><<<pm / bm, goma::THREADS, smem, s>>>(
      static_cast<const T*>(A), static_cast<const T*>(Wg),
      static_cast<const T*>(Wu), static_cast<const T*>(Wd),
      static_cast<T*>(Out), pm, pff, pk, pn2, bm, bk, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (all operands alike).  act: the
// goma::Activation code.  Return the cudaError_t of the launch.
int goma_fused_launch(const void* A, const void* Wg, const void* Wu,
                      const void* Wd, void* Out, int pm, int pff, int pk,
                      int pn2, int bm, int bk, int act, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fused<float>(A, Wg, Wu, Wd, Out, pm, pff, pk, pn2, bm, bk,
                               act, s);
  return launch_fused<__nv_bfloat16>(A, Wg, Wu, Wd, Out, pm, pff, pk, pn2,
                                     bm, bk, act, s);
}

// The combine of the B1 composition: out = round(act(g, u)) elementwise on
// n values already in the I/O dtype.
int goma_combine_launch(const void* G, const void* U, void* Out, long n,
                        int act, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? (want > 0 ? want : 1)
                                                  : 4096);
  if (dtype == 0) {
    goma_combine_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(G), static_cast<const float*>(U),
        static_cast<float*>(Out), n, act);
  } else {
    goma_combine_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(G),
        static_cast<const __nv_bfloat16*>(U),
        static_cast<__nv_bfloat16*>(Out), n, act);
  }
  return static_cast<int>(cudaGetLastError());
}

int goma_fused_stage_bytes() {
  return static_cast<int>(sizeof(goma::Stage));
}

}  // extern "C"
