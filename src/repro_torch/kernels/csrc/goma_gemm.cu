// B1: GOMA-planned GEMM for Hopper (sm_90a), C = A @ B on padded shapes.
//
// Replaces the Pallas TPU kernel `goma_matmul` (src/repro/kernels/
// goma_gemm.py: _matmul_kernel, _matmul_kernel_single_k).
//
// What bounds it on the H100 at the served bf16 shapes (PERF.md has each
// one's bound and time): the weight bytes at decode and at 64 rows
// (llama3-8b's 4096 x 14336 weights, 0.035 ms at 3.35 TB/s; zamba2-2.7b's
// 2560 x 10240, 0.016 ms), and the tensor cores' bf16 rate at
// zamba2-2.7b's 800-row prefill (0.042 ms at 989 TFLOP/s).  GOMA's
// energy-optimal plan blocks are wide (bn 512 or 640): one CTA per block
// left 4 to 28 of the 132 SMs at work.
//
// bf16 (every served path), on the tensor cores.  Each plan block (bm, bn)
// is cut into 64-row by slice_n-column tiles, one CTA each, adjacent in
// blockIdx; blocks are rastered in the plan's walk order (the walking axis
// varies fastest), so GOMA's walk still sets the order in which weight
// tiles stream.  The wrapper's `cta_slices` picks slice_n: the widest
// slice that still gives a quarter of the SMs a CTA, since wide TMA rows
// streamed faster than more CTAs did.  In each CTA one producer warp keeps
// a ring of 64-deep k stages in flight by TMA (A: 64 x 64, B: 64 x
// slice_n, both swizzled for wgmma); one consumer warpgroup multiplies
// each stage with wgmma (goma::wg::mma_stage) into fp32 registers, and
// writes its tile once, rounded to bf16.  The k loop stays inside the CTA,
// so no partial sum leaves it.  A's map holds only the plan's M rows: the
// padding rows read as zeros from the map and cost no bytes (they are
// zeros in every caller).  A k tail past pk reads as zeros the same way.
//
// fp32 (the smoke configs and the fp32 path checks), on the CUDA cores as
// before: one CTA per plan block, walked in 64x64 register tiles with
// goma::tile_dot, exact fp32 under -fmad=false.
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

namespace wg = goma::wg;

// Ring depth per slice width: 4 stages of 128 columns (96 KB of shared
// memory) or 8 of 64 (128 KB) keep 64 KB of weight tiles in flight per
// CTA; 8 of 32 columns take 96 KB.
__host__ __device__ constexpr int stages_for(int bn) {
  return bn == 128 ? 4 : 8;
}

template <int BN>
constexpr int smem_for() {
  return stages_for(BN) * (wg::A_BYTES + wg::BTile<BN>::BYTES) +
         static_cast<int>(sizeof(wg::Ring<stages_for(BN)>)) + wg::ALIGN;
}

template <int BN>
__global__ void __launch_bounds__(wg::THREADS)
goma_matmul_wgmma(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  __nv_bfloat16* __restrict__ C, int pm, int pn, int pk,
                  int bm, int bn, int m_fastest) {
  constexpr int STAGES = stages_for(BN);
  using BT = wg::BTile<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_tiles = wg::aligned_smem(smem_raw);
  uint8_t* b_tiles = a_tiles + STAGES * wg::A_BYTES;
  auto& ring = *reinterpret_cast<wg::Ring<STAGES>*>(b_tiles +
                                                    STAGES * BT::BYTES);
  // this CTA's tile: plan block `blk` in walk order, then tile `sub` of
  // the block, slices of one 64-row band adjacent
  const int slices = bn / BN;
  const int per_block = (bm / wg::ROWS) * slices;
  const int blk = blockIdx.x / per_block, sub = blockIdx.x % per_block;
  const int nbm = pm / bm, nbn = pn / bn;
  const int im = m_fastest ? blk % nbm : blk / nbn;
  const int in = m_fastest ? blk / nbm : blk % nbn;
  const int row0 = im * bm + (sub / slices) * wg::ROWS;
  const int col0 = in * bn + (sub % slices) * BN;
  const int nk = (pk + wg::KS - 1) / wg::KS;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x >= wg::CONSUMERS) {  // the producer warp
    if (threadIdx.x == wg::CONSUMERS) {
      for (int i = 0; i < nk; ++i) {
        uint64_t* bar = ring.acquire(i, wg::A_BYTES + BT::BYTES);
        const int s = i % STAGES;
        wg::tma_load(a_tiles + s * wg::A_BYTES, &ta, bar, i * wg::KS, row0);
#pragma unroll
        for (int x = 0; x < BT::BOXES; ++x)
          wg::tma_load(b_tiles + s * BT::BYTES + x * BT::BOX_BYTES, &tb, bar,
                       col0 + x * BT::BOX_N, i * wg::KS);
      }
    }
    return;
  }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    ring.wait_full(i);
    wg::mma_stage<BN>(acc, wg::smem_addr(a_tiles + s * wg::A_BYTES),
                      wg::smem_addr(b_tiles + s * BT::BYTES));
    ring.release(i);
  }
  wg::for_pairs<BN>(acc, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(
        C + (long)(row0 + r) * pn + col0 + c) = __floats2bfloat162_rn(v0, v1);
  });
}

template <int BN>
int launch_wgmma(const void* A, const void* B, void* C, int pm, int pn,
                 int pk, int bm, int bn, int m_fastest, int m_valid,
                 cudaStream_t s) {
  CUtensorMap ta, tb;
  if (!wg::make_map(&ta, A, m_valid, pk, pk, wg::ROWS, wg::KS) ||
      !wg::make_map(&tb, B, pk, pn, pn, wg::KS, wg::BTile<BN>::BOX_N))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = smem_for<BN>();
  static const cudaError_t opted = wg::allow_smem(goma_matmul_wgmma<BN>, smem);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const int blocks = (pm / wg::ROWS) * (pn / BN);
  goma_matmul_wgmma<BN><<<blocks, wg::THREADS, smem, s>>>(
      ta, tb, static_cast<__nv_bfloat16*>(C), pm, pn, pk, bm, bn, m_fastest);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (A, B and C alike).  bf16 only:
// m_valid = the rows of A that are read (the plan's M; the rest read as
// zeros) and slice_n = the CTA tile's columns (32, 64 or 128).
// Returns the cudaError_t of the launch; the caller raises if it is not 0.
int goma_matmul_launch(const void* A, const void* B, void* C, int pm, int pn,
                       int pk, int bm, int bn, int bk, int m_fastest,
                       int m_valid, int slice_n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int blocks = (pm / bm) * (pn / bn);
    goma_matmul_kernel<float><<<blocks, goma::THREADS, 0, s>>>(
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<float*>(C), pm, pn, pk, bm, bn, bk, m_fastest);
    return static_cast<int>(cudaGetLastError());
  }
  switch (slice_n) {
    case 32:
      return launch_wgmma<32>(A, B, C, pm, pn, pk, bm, bn, m_fastest,
                              m_valid, s);
    case 64:
      return launch_wgmma<64>(A, B, C, pm, pn, pk, bm, bn, m_fastest,
                              m_valid, s);
    case 128:
      return launch_wgmma<128>(A, B, C, pm, pn, pk, bm, bn, m_fastest,
                               m_valid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The ring depth the bf16 kernel uses at a slice width.
int goma_matmul_stages(int slice_n) { return stages_for(slice_n); }

}  // extern "C"
