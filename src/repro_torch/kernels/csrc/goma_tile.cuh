// Device code shared by the GOMA GEMM kernel (goma_gemm.cu) and the fused
// gated-MLP kernel (goma_fused.cu): two dot routines, one per I/O dtype.
//
// fp32, on the CUDA cores (`tile_dot`).  The CTA's compute tile is 64x64
// outputs: 256 threads, each holding a 4x4 block of fp32 accumulators (rows
// ty + 16*i, columns tx + 16*j).  Every output element is accumulated as
// one fmaf chain over k in increasing order, starting from 0.  The sources
// are compiled with -fmad=false so that no expression is contracted
// differently in the two kernels; the only fused multiply-adds are the
// explicit fmaf calls below.
//
// bf16, on the tensor cores (namespace `wg`).  One consumer warpgroup runs
// `wgmma.mma_async` m64nNk16 with bf16 operands read from shared memory and
// fp32 accumulators in registers; one producer warp keeps a ring of
// shared-memory stages full with TMA copies (`cp.async.bulk.tensor`,
// completion on mbarriers).  A stage is 64 deep in k: one 128-byte swizzle
// row of the 64-row A tile.  A is K-major (row-major A), B is MN-major
// (row-major B, N contiguous: the wgmma's transpose-B flag).
//
// The per-element contract, for both dtypes: each output element has one
// fp32 accumulator.  It takes the k steps (a fmaf per k in fp32; a k16
// wgmma step in bf16) in increasing k, starting from 0, with one
// instruction shape per dtype.  Its value therefore does not depend on the
// plan's (bm, bn, bk), on the CTA decomposition, or on which kernel ran it:
// the fused kernel equals the GEMM-kernel composition bit for bit.  That the
// wgmma N width leaves the bits alone is checked on the card
// (chip_smoke.py, phase 3: B1 under several slice widths, and B2, whose
// producers run N = 32, against the composition).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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


// ---------------------------------------------------------------- bf16
namespace wg {

constexpr int ROWS = 64;        // wgmma M: rows of a CTA tile
constexpr int KS = 64;          // k depth of a ring stage
constexpr int CONSUMERS = 128;  // one warpgroup issues the wgmmas
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int A_BYTES = ROWS * KS * 2;   // a 64 x 64 A tile, 128B swizzle
constexpr int ALIGN = 1024;     // a swizzle pattern repeats every 1 KB

// The B operand of one stage: KS rows of BN columns (N contiguous), TMA'd
// as boxes of at most 64 columns.  A box row of BOX_N bf16 is the swizzle
// span (64 or 128 bytes); boxes lie one after another.
template <int BN> struct BTile {
  static_assert(BN == 32 || BN == 64 || BN == 128,
                "slice widths are 32, 64 or 128 columns");
  static constexpr int BOX_N = BN < 64 ? BN : 64;
  static constexpr int SWIZZLE = BOX_N * 2;
  static constexpr int BOX_BYTES = KS * SWIZZLE;
  static constexpr int BOXES = BN / BOX_N;
  static constexpr int BYTES = BOX_BYTES * BOXES;
  // descriptor layout codes: 1 = 128B, 2 = 64B swizzle
  static constexpr uint64_t LAYOUT = SWIZZLE == 128 ? 1 : 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}
// Wait until the phase of the given parity has completed.  A wait that
// never ends is a fault of the kernel: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// A ring of STAGES stages: `full` completes when a stage's TMA bytes have
// landed, `empty` when all consumer threads have released it.  Load i goes
// to stage i % STAGES in round i / STAGES.
template <int STAGES> struct Ring {
  uint64_t full[STAGES];
  uint64_t empty[STAGES];

  __device__ void init() {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // producer: wait for stage i % STAGES to be free, then announce `bytes`
  __device__ uint64_t* acquire(int i, int bytes) {
    const int s = i % STAGES;
    mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[s], bytes);
    return &full[s];
  }
  __device__ void wait_full(int i) {
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
  }
  __device__ void release(int i) { mbar_arrive(&empty[i % STAGES]); }
};

// --- TMA: one 2-D box (inner coordinate first) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// --- wgmma shared-memory descriptors
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}
// A: 64 rows of 128 bytes (64 k), 128B swizzle, K-major; 8-row groups
// 1 KB apart.  Step kk (16 k) starts 32 bytes further along the row.
__device__ __forceinline__ uint64_t a_desc(uint32_t tile, int kk) {
  return desc(tile + kk * 32, 16, 8 * 128, 1);
}
// B: KS rows of SWIZZLE bytes per box, MN-major; 8-row k groups
// 8 * SWIZZLE bytes apart (SBO), boxes of 64 columns BOX_BYTES apart
// (LBO).  Step kk (16 k) starts 16 rows further down.
template <int BN>
__device__ __forceinline__ uint64_t b_desc(uint32_t tile, int kk) {
  using T = BTile<BN>;
  return desc(tile + kk * 16 * T::SWIZZLE, T::BOX_BYTES, 8 * T::SWIZZLE,
              T::LAYOUT);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from touching the accumulators across async wgmmas
template <int R> __device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16) * B (16 x N) for one k16 step: one wgmma m64nNk16,
// bf16 operands from shared memory, fp32 accumulators, B transposed
// (MN-major).  d holds N / 2 values per thread.
template <int N> struct Wgmma;

template <> struct Wgmma<32> {
  __device__ static __forceinline__ void mma(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};


// One ring stage: d += A_tile (64 x 64) * B_tile (64 x BN), four k16 steps
// in increasing k, waited for before returning.  Called by the 128
// consumer threads together.  This is the per-element chain of the
// contract: every bf16 product of both kernels goes through here.
template <int BN>
__device__ __forceinline__ void mma_stage(float (&d)[BN / 2], uint32_t a,
                                          uint32_t b) {
  fence_acc(d);
  mma_fence();
#pragma unroll
  for (int kk = 0; kk < KS / 16; ++kk)
    Wgmma<BN>::mma(d, a_desc(a, kk), b_desc<BN>(b, kk));
  mma_commit();
  mma_wait();
  fence_acc(d);
}

// The accumulator layout of m64nNk16: consumer thread t holds, for each
// 8-column group j, rows r and r + 8 (r = 16 * warp + lane / 4) at columns
// 8j + 2 * (lane % 4) and the next one: d[4j .. 4j + 3] = (r, c), (r, c+1),
// (r+8, c), (r+8, c+1).  f(row, col, v0, v1) receives each pair.
template <int BN, typename F>
__device__ __forceinline__ void for_pairs(const float (&d)[BN / 2], F f) {
  const int lane = threadIdx.x % 32;
  const int r = 16 * (threadIdx.x / 32) + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    f(r, c, d[4 * j], d[4 * j + 1]);
    f(r + 8, c, d[4 * j + 2], d[4 * j + 3]);
  }
}

// --- host: TMA tensor maps, with the encoder looked up at run time so
// that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major bf16 matrix of `rows` x `cols` (row stride `ld` elements)
// read in boxes of box_rows x box_cols (64 or 32), swizzled by box_cols * 2
// bytes.  Reads past `rows` or `cols` fill zeros.  Returns false on
// failure.
inline bool make_map(CUtensorMap* map, const void* base, long rows,
                     long cols, long ld, int box_rows, int box_cols) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle sw = box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                               : CU_TENSOR_MAP_SWIZZLE_64B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opt a kernel in to `bytes` of dynamic shared memory (once per kernel).
template <typename K> inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The first 1 KB-aligned address of dynamic shared memory.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + ((ALIGN - a % ALIGN) % ALIGN);
}

}  // namespace wg

}  // namespace goma
