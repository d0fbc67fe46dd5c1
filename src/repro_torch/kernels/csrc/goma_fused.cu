// B2: GOMA-chain-planned fused gated MLP for Hopper (sm_90a),
// out = act(A @ Wg, A @ Wu) @ Wd on padded shapes.
//
// Replaces the Pallas TPU kernel `goma_fused_matmul` (src/repro/kernels/
// goma_fused.py: _fused_kernel, _fused_kernel_single_k).
//
// Bit-identity with the composition of B1 kernels under the plan's
// producer/consumer tilings, with goma_combine_launch below between them:
// both kernels take every product through the same dot routine of
// goma_tile.cuh (fp32: goma::tile_dot; bf16: goma::wg::mma_stage) and the
// same goma::combine, and round where the composition rounds.
//
// What bounds it: the strips must fit one CTA's 227 KB of shared memory,
// which caps bm * pff (the planner records larger chains as unfused, so no
// served full-width MLP reaches this kernel); within that, the weight
// bytes.  It runs on the smoke configs only, where its time is launch
// overhead.
//
// fp32 (the smoke configs), on the CUDA cores: one CTA per m-strip of bm
// rows.  The two (bm, pff) fp32 strips live in dynamic shared memory and
// accumulate over the plan's bk-deep k stages in increasing order, walked
// in 64x64 register tiles.  After the last stage the strips are rounded to
// the I/O dtype, combined, and rounded again, in place; then one
// full-depth dot per 64x64 output tile multiplies the strip by Wd.
//
// bf16, on the tensor cores: one CTA per 64-row tile of the plan's strips,
// with B1's ring (one producer warp, TMA) and B1's wgmma stage routine.
// The consumer warpgroup computes the g and u tiles of each 32-column
// slice over the full K, rounds both to bf16, combines, rounds again, and
// stores the slice into a (64, pff) bf16 strip in shared memory, laid out
// (128-byte swizzle) as a wgmma A operand; then it multiplies the strip by
// Wd.  The intermediate never reaches device memory.
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

namespace wg = goma::wg;

// The bf16 ring: each stage holds an A tile and the 64 x 32 slices of Wg
// and Wu (the producers), or one 64 x 32 slice of Wd in the Wg place (the
// consumer).
constexpr int FN = 32;                 // slice width of every bf16 product
constexpr int FSTAGES = 3;
using FB = wg::BTile<FN>;
constexpr int FSTAGE_BYTES = wg::A_BYTES + 2 * FB::BYTES;
// the staging beside the strip: ring, barriers and alignment slack
constexpr int FRING_BYTES = FSTAGES * FSTAGE_BYTES +
                            static_cast<int>(sizeof(wg::Ring<FSTAGES>)) +
                            wg::ALIGN;

__global__ void __launch_bounds__(wg::THREADS)
goma_fused_wgmma(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tg,
                 const __grid_constant__ CUtensorMap tu,
                 const __grid_constant__ CUtensorMap td,
                 __nv_bfloat16* __restrict__ Out, int pff, int pk, int pn2,
                 int act) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring_tiles = wg::aligned_smem(smem_raw);
  uint8_t* strip = ring_tiles + FSTAGES * FSTAGE_BYTES;  // pff / 64 chunks
  auto& ring = *reinterpret_cast<wg::Ring<FSTAGES>*>(strip + pff * 128);
  const int row0 = blockIdx.x * wg::ROWS;
  const int nk = (pk + wg::KS - 1) / wg::KS;
  const int nf = pff / wg::KS;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x >= wg::CONSUMERS) {  // the producer warp
    if (threadIdx.x == wg::CONSUMERS) {
      int i = 0;
      for (int n0 = 0; n0 < pff; n0 += FN) {
        for (int k = 0; k < nk; ++k, ++i) {
          uint64_t* bar = ring.acquire(i, FSTAGE_BYTES);
          uint8_t* st = ring_tiles + (i % FSTAGES) * FSTAGE_BYTES;
          wg::tma_load(st, &ta, bar, k * wg::KS, row0);
          wg::tma_load(st + wg::A_BYTES, &tg, bar, n0, k * wg::KS);
          wg::tma_load(st + wg::A_BYTES + FB::BYTES, &tu, bar, n0,
                       k * wg::KS);
        }
      }
      for (int n0 = 0; n0 < pn2; n0 += FN) {
        for (int f = 0; f < nf; ++f, ++i) {
          uint64_t* bar = ring.acquire(i, FB::BYTES);
          uint8_t* st = ring_tiles + (i % FSTAGES) * FSTAGE_BYTES;
          wg::tma_load(st + wg::A_BYTES, &td, bar, n0, f * wg::KS);
        }
      }
    }
    return;
  }

  int i = 0;
  // producers: g and u of each 32-column slice over the full K
  for (int n0 = 0; n0 < pff; n0 += FN) {
    float ag[FN / 2], au[FN / 2];
#pragma unroll
    for (int e = 0; e < FN / 2; ++e) ag[e] = au[e] = 0.0f;
    for (int k = 0; k < nk; ++k, ++i) {
      const uint32_t st =
          wg::smem_addr(ring_tiles + (i % FSTAGES) * FSTAGE_BYTES);
      ring.wait_full(i);
      wg::mma_stage<FN>(ag, st, st + wg::A_BYTES);
      wg::mma_stage<FN>(au, st, st + wg::A_BYTES + FB::BYTES);
      ring.release(i);
    }
    // round, combine, round; store into the strip as the A operand lays
    // it out: chunk of 64 columns, row r at 128 bytes, 16-byte group g at
    // g ^ (r % 8)
    float hv[FN / 2];
#pragma unroll
    for (int e = 0; e < FN / 2; ++e) {
      const float g = goma::round_to<__nv_bfloat16>(ag[e]);
      const float u = goma::round_to<__nv_bfloat16>(au[e]);
      hv[e] = goma::combine(g, u, act);
    }
    wg::for_pairs<FN>(hv, [&](int r, int c, float v0, float v1) {
      const int col = n0 + c;
      uint8_t* chunk = strip + (col / wg::KS) * wg::A_BYTES;
      const int x = col % wg::KS;
      *reinterpret_cast<__nv_bfloat162*>(
          chunk + r * 128 + (((x / 8) ^ (r % 8)) * 16) + (x % 8) * 2) =
          __floats2bfloat162_rn(v0, v1);
    });
  }
  // the strip's generic-proxy stores become visible to the wgmma's reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(wg::CONSUMERS) : "memory");

  // consumer: the strip times Wd, 32 columns at a time
  for (int n0 = 0; n0 < pn2; n0 += FN) {
    float acc[FN / 2];
#pragma unroll
    for (int e = 0; e < FN / 2; ++e) acc[e] = 0.0f;
    for (int f = 0; f < nf; ++f, ++i) {
      const uint32_t st =
          wg::smem_addr(ring_tiles + (i % FSTAGES) * FSTAGE_BYTES);
      ring.wait_full(i);
      wg::mma_stage<FN>(acc, wg::smem_addr(strip + f * wg::A_BYTES),
                        st + wg::A_BYTES);
      ring.release(i);
    }
    wg::for_pairs<FN>(acc, [&](int r, int c, float v0, float v1) {
      *reinterpret_cast<__nv_bfloat162*>(
          Out + (long)(row0 + r) * pn2 + n0 + c) =
          __floats2bfloat162_rn(v0, v1);
    });
  }
}

int launch_fused_wgmma(const void* A, const void* Wg, const void* Wu,
                       const void* Wd, void* Out, int pm, int pff, int pk,
                       int pn2, int m_valid, int act, cudaStream_t s) {
  CUtensorMap ta, tg, tu, td;
  if (!wg::make_map(&ta, A, m_valid, pk, pk, wg::ROWS, wg::KS) ||
      !wg::make_map(&tg, Wg, pk, pff, pff, wg::KS, FN) ||
      !wg::make_map(&tu, Wu, pk, pff, pff, wg::KS, FN) ||
      !wg::make_map(&td, Wd, pff, pn2, pn2, wg::KS, FN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = FRING_BYTES + pff * 128;
  cudaError_t err = wg::allow_smem(goma_fused_wgmma, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  goma_fused_wgmma<<<pm / wg::ROWS, wg::THREADS, smem, s>>>(
      ta, tg, tu, td, static_cast<__nv_bfloat16*>(Out), pff, pk, pn2, act);
  return static_cast<int>(cudaGetLastError());
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
// goma::Activation code.  bf16 only: m_valid = the rows of A that are read
// (the plan's M; the rest read as zeros).  Return the cudaError_t of the
// launch.
int goma_fused_launch(const void* A, const void* Wg, const void* Wu,
                      const void* Wd, void* Out, int pm, int pff, int pk,
                      int pn2, int bm, int bk, int m_valid, int act,
                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fused<float>(A, Wg, Wu, Wd, Out, pm, pff, pk, pn2, bm, bk,
                               act, s);
  return launch_fused_wgmma(A, Wg, Wu, Wd, Out, pm, pff, pk, pn2, m_valid,
                            act, s);
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

// Shared memory either path needs beside the two fp32 (bm, pff) strips of
// the fp32 path: the larger of the fp32 staging buffers and the bf16 ring
// (the bf16 path's own strip, 64 x pff bf16, is smaller than the fp32
// strips it replaces).  The planner's STAGE_BYTES must equal it.
int goma_fused_stage_bytes() {
  const int fp32 = static_cast<int>(sizeof(goma::Stage));
  return fp32 > FRING_BYTES ? fp32 : FRING_BYTES;
}

}  // extern "C"
