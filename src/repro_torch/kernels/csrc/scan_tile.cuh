// Device code shared by the chunked recurrent-scan kernels (wkv6.cu, B3,
// and mamba2_ssd.cu, B4): products on the tensor cores at fp32 accuracy,
// warp scans, and a two-stage ring of asynchronous row copies.
//
// Both kernels run one CTA of THREADS threads per (batch, head) stream.  It
// walks the sequence in sub-chunks of SUB = 32 tokens, whatever the
// caller's chunk: a chunked scan gives the same function for every chunk
// length, and 32 tokens keep a CTA's shared memory small enough for two
// (B3) or three (B4) CTAs on an SM.  Rows past the sequence's end are zero:
// no input and no decay.
//
// Products: 3xTF32 on `mma.sync.m16n8k8` (sm_80 and later).  Each fp32
// operand x splits into big = tf32(x) and small = tf32(x - big), both
// rounded to nearest (cvt.rna); a product accumulates small*big +
// big*small + big*big in fp32, which keeps about fp32's accuracy (one
// TF32 product keeps about three decimal digits).  A warp computes a
// 16 x 8NT tile; operands are read from shared memory through accessor
// functions, so a decay can be folded in as a fragment is loaded.
//
// Loads: one thread issues a TMA copy of each operand's SUB token rows
// (a 2-D box whose padded rows land at the work pitch) into a ring stage;
// an mbarrier per stage completes when the stage's bytes have landed.
// Sub-chunk n goes to stage n % 2 and is issued while sub-chunk n - 1
// computes.
#pragma once

#include <type_traits>

#include "goma_tile.cuh"  // goma::to_float, goma::from_float, goma::wg mbarriers

namespace scan {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 32;              // tokens per sub-chunk: one per lane
constexpr long MAX_SMEM = 232448;    // a CTA's shared memory on sm_90
constexpr int BARS = 128;            // bytes for the two stage mbarriers

// Row pitch, in elements, of a row of n values: fp32 work rows take n + 4
// floats (16-byte rows whose fragment reads fall on distinct banks); a
// staged row of T is padded to the next 16 bytes.
__host__ __device__ constexpr int ld32(int n) { return n + 4; }
template <typename T> __host__ __device__ constexpr int ldT(int n) {
  return n + 16 / static_cast<int>(sizeof(T));
}
template <typename T> constexpr bool kF32 = std::is_same<T, float>::value;

// exp of an exponent that is <= 0 in exact arithmetic; the clamp keeps a
// rounding of the warp scan's sums from making it positive
__device__ __forceinline__ float exp_le0(float x) {
  return __expf(fminf(x, 0.f));
}

// Inclusive prefix sums over the 32 lanes of a warp (lane = token), of M
// independent values at once.
template <int M> __device__ __forceinline__ void warp_cumsum(float (&v)[M]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float up = __shfl_up_sync(0xffffffffu, v[j], o);
      if (lane >= o) v[j] += up;
    }
}

// The m-th pair (t, s) of a lower triangle s <= t, row by row.
__device__ __forceinline__ void tri_index(int m, int& t, int& s) {
  int r = static_cast<int>((sqrtf(8.f * m + 1.f) - 1.f) * 0.5f);
  while (r * (r + 1) / 2 > m) --r;
  while ((r + 1) * (r + 2) / 2 <= m) ++r;
  t = r;
  s = m - r * (r + 1) / 2;
}

// ------------------------------------------------------------- 3xTF32
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// big's low 13 bits are cleared so that x - big is exact; the MMA reads
// only the top 19 bits of each operand, so small needs no such mask
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x) & 0xffffe000u;
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct FragA { uint32_t big[4], small[4]; };
struct FragB { uint32_t big[2], small[2]; };

// The m16n8k8 fragments: lane = 4g + q holds A (16 x 8) at rows g, g + 8
// and columns q, q + 4; B (8 x 8) at rows (k) q, q + 4 and column g; the
// accumulator at rows g, g + 8 and columns 2q, 2q + 1.
template <typename F> __device__ __forceinline__ void load_a(FragA& f, F a) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  split(a(g, q), f.big[0], f.small[0]);
  split(a(g + 8, q), f.big[1], f.small[1]);
  split(a(g, q + 4), f.big[2], f.small[2]);
  split(a(g + 8, q + 4), f.big[3], f.small[3]);
}
template <typename F> __device__ __forceinline__ void load_b(FragB& f, F b) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  split(b(q, g), f.big[0], f.small[0]);
  split(b(q + 4, g), f.big[1], f.small[1]);
}
// d += a b at fp32 accuracy: the two small cross terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.big, b.small[0], b.small[1]);
  mma_tf32(d, a.small, b.big[0], b.big[1]);
  mma_tf32(d, a.big, b.big[0], b.big[1]);
}

// d (16 x 8NT) += A (16 x K) B (K x 8NT), K a multiple of 8, in k steps of
// 8 in increasing k; a(row, k) and b(k, col) give the operands.  Called by
// the 32 lanes of a warp together.
template <int NT, int K, typename FA, typename FB>
__device__ __forceinline__ void warp_gemm(float (&d)[NT][4], FA a, FB b) {
  static_assert(K % 8 == 0, "k steps of 8");
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    FragA fa;
    load_a(fa, [&](int r, int c) { return a(r, k0 + c); });
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragB fb;
      load_b(fb, [&](int k, int c) { return b(k0 + k, 8 * j + c); });
      mma3(d[j], fa, fb);
    }
  }
}

// f(row, col, value) for each accumulator element this lane holds
template <int NT, typename F>
__device__ __forceinline__ void for_acc(const float (&d)[NT][4], F f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    f(g, 8 * j + 2 * q, d[j][0]);
    f(g, 8 * j + 2 * q + 1, d[j][1]);
    f(g + 8, 8 * j + 2 * q, d[j][2]);
    f(g + 8, 8 * j + 2 * q + 1, d[j][3]);
  }
}

template <int NT> __device__ __forceinline__ void zero(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] = 0.f;
}

// ------------------------------------------------------------ the ring
// Shared memory starts with the two stage mbarriers, 128-byte aligned (a
// TMA destination's alignment); the stages follow.  SLACK covers the
// alignment.
constexpr int SLACK = 128;
__device__ __forceinline__ uint8_t* aligned(uint8_t* raw) {
  return raw + (SLACK - goma::wg::smem_addr(raw) % SLACK) % SLACK;
}

__device__ __forceinline__ void init_ring(uint64_t* full) {
  goma::wg::mbar_init(&full[0], 1);
  goma::wg::mbar_init(&full[1], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(goma::wg::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(goma::wg::smem_addr(bar))
      : "memory");
}

// Order this thread's earlier shared-memory accesses before later copies
// of the async proxy (the ring's TMA copies) into the same bytes.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The token rows of a (rows x cols) row-major tensor of T, read by TMA in
// boxes of SUB rows x box_cols columns with no swizzle: a box lands as
// SUB rows of box_cols values, so box_cols = ldT(width) gives the padded
// pitch.  The padding columns read the next head's values (or zeros past
// the last column) and are never used.  Returns false on failure.
template <typename T>
inline bool make_rows_map(CUtensorMap* map, const void* base, long rows,
                          long cols, int box_cols) {
  goma::wg::EncodeTiled fn = goma::wg::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(SUB)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map,
            kF32<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A landed stage of T rows (pitch ldT) as fp32 work rows (pitch ld32):
// converted into `work` for bf16; for fp32 the stage is the work buffer,
// and only the rows past `rows` are zeroed.  Called by the whole CTA.
template <typename T>
__device__ __forceinline__ float* as_work(T* stage, float* work, int rows,
                                          int width) {
  const int ldt = ldT<T>(width), ld = ld32(width);
  if constexpr (kF32<T>) {
    for (int i = rows * ld + threadIdx.x; i < SUB * ld; i += THREADS)
      stage[i] = 0.f;
    return stage;
  } else {
    for (int i = threadIdx.x; i < SUB * width; i += THREADS) {
      const int t = i / width, c = i % width;
      work[t * ld + c] = t < rows ? goma::to_float(stage[t * ldt + c]) : 0.f;
    }
    return work;
  }
}

// Opt the kernel in to `bytes` of dynamic shared memory with the largest
// shared-memory carveout, so that as many CTAs as fit share an SM.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, long bytes) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// CTAs of the kernel an SM holds at once with `bytes` of shared memory.
template <typename Kernel> int ctas_per_sm(Kernel kernel, long bytes) {
  int n = 0;
  if (prepare(kernel, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, THREADS, static_cast<size_t>(bytes)) != cudaSuccess)
    return -1;
  return n;
}

// Launch Kernel on `ctas` CTAs with Bytes of dynamic shared memory; the
// kernel is prepared once, at its first launch.
template <auto Kernel, long Bytes, typename... Args>
int launch(int ctas, void* stream, Args... args) {
  static const cudaError_t ready = prepare(Kernel, Bytes);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  Kernel<<<ctas, THREADS, Bytes, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace scan
