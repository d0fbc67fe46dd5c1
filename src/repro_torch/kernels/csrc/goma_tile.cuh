// Device code shared by the GOMA GEMM kernel (goma_gemm.cu) and the fused
// gated-MLP kernel (goma_fused.cu).
//
// The CTA's compute tile is 64x64 outputs: 256 threads, each holding a 4x4
// block of fp32 accumulators (rows ty + 16*i, columns tx + 16*j).  This is
// the `fixed_spatial = (64, 64, 1)` of the planner's H100_LIKE spec
// (core/hopper_mapping.py); plan blocks are multiples of it.
//
// Bit-identity: every output element is accumulated by `tile_dot` as one
// fmaf chain over k in increasing order, starting from 0.  The result of an
// element therefore does not depend on the tiling (bm, bn, bk) or on which
// kernel ran it, and the fused kernel equals the GEMM-kernel composition bit
// for bit.  The sources are compiled with -fmad=false so that no expression
// is contracted differently in the two kernels; the only fused
// multiply-adds are the explicit fmaf calls below.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace goma {

constexpr int TILE = 64;      // CTA compute tile: rows and columns
constexpr int KC = 32;        // k-chunk staged in shared memory per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

// One k-chunk of both operands, converted to fp32.  The A chunk is stored
// transposed with one column of padding so that the staging writes do not
// collide on a bank.
struct Stage {
  float a[KC][TILE + 1];
  float b[KC][TILE];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an fp32 value to the I/O dtype T and back.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Chunk k0 of both operands (kc <= KC rows of k), read into registers:
// each thread holds PER values of the A chunk and PER of the B chunk.  All
// loads are issued before any shared-memory store, so they are in flight
// together (A and B may be generic pointers the compiler cannot prove
// apart from the staging buffers).
constexpr int PER = TILE * KC / THREADS;

template <typename TA, typename TB>
__device__ __forceinline__ void load_chunk(const TA* A, long lda,
                                           const TB* B, long ldb, int k0,
                                           int kc, float ra[PER],
                                           float rb[PER]) {
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int i = threadIdx.x + t * THREADS;
    const int r = i / KC, k = i % KC;     // A chunk: row r, column k
    ra[t] = k < kc ? to_float(A[r * lda + k0 + k]) : 0.0f;
    const int kb = i / TILE, c = i % TILE;  // B chunk: row kb, column c
    rb[t] = kb < kc ? to_float(B[(long)(k0 + kb) * ldb + c]) : 0.0f;
  }
}

__device__ __forceinline__ void store_chunk(const float ra[PER],
                                            const float rb[PER], Stage& st) {
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int i = threadIdx.x + t * THREADS;
    st.a[i % KC][i / KC] = ra[t];
    st.b[i / TILE][i % TILE] = rb[t];
  }
}

// acc[i][j] += sum_{k < depth} A[r_i, k] * B[k, c_j], one fmaf per k in
// increasing k.  A points at the tile's first row and first k (row stride
// lda); B at its first k and first column (row stride ldb).  Either may
// point into global or shared memory.  Called by all 256 threads.  The
// next chunk is loaded into registers while this one is multiplied.
template <typename TA, typename TB>
__device__ void tile_dot(const TA* A, long lda, const TB* B, long ldb,
                         int depth, Stage& st, float acc[4][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float ra[PER], rb[PER];
  load_chunk(A, lda, B, ldb, 0, min(KC, depth), ra, rb);
  for (int k0 = 0; k0 < depth; k0 += KC) {
    const int kc = min(KC, depth - k0);
    __syncthreads();  // the previous chunk has been consumed
    store_chunk(ra, rb, st);
    __syncthreads();
    if (k0 + KC < depth)
      load_chunk(A, lda, B, ldb, k0 + KC, min(KC, depth - k0 - KC), ra, rb);
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = st.a[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = st.b[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// The gated-MLP combines, in fp32 on values already rounded to the I/O
// dtype.  Codes follow kernels/goma_fused.py ACTIVATION_CODES.
enum Activation { SILU_MUL = 0, GELU_MUL = 1, SQRELU_MUL = 2, IDENTITY = 3 };

__device__ __forceinline__ float combine(float g, float u, int act) {
  switch (act) {
    case SILU_MUL:
      return g / (1.0f + expf(-g)) * u;
    case GELU_MUL: {  // tanh approximation, as jax.nn.gelu's default
      const float inner = 0.7978845608028654f * (g + 0.044715f * (g * g * g));
      return 0.5f * g * (1.0f + tanhf(inner)) * u;
    }
    case SQRELU_MUL: {
      const float r = fmaxf(g, 0.0f);
      return r * r * u;
    }
    default:
      return g * u;
  }
}

}  // namespace goma
