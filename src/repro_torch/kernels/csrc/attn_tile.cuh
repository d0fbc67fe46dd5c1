// Device code shared by the attention kernels (attention.cu, the fused
// attention of a training step, and mla_attention.cu, latent attention over
// the slot cache): a ring of TMA stages that every consumer thread
// releases, 3-D and 4-D TMA boxes, wgmma descriptors over tiles of
// 128-byte rows (128B swizzle), wgmma m64nNk16 with both operands in shared
// memory or A in registers, and the row reductions over a quad of lanes
// that hold one accumulator row.
#pragma once

#include "goma_tile.cuh"

namespace goma {
namespace attn {

namespace wg = goma::wg;

// --- a ring whose stages all ARRIVALS threads release
template <int STAGES, int ARRIVALS> struct Ring {
  uint64_t full[STAGES];
  uint64_t empty[STAGES];

  __device__ void init() {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], ARRIVALS);
    }
  }
  __device__ uint64_t* acquire(int i, int bytes) {
    const int s = i % STAGES;
    wg::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
    wg::mbar_expect_tx(&full[s], bytes);
    return &full[s];
  }
  __device__ void wait_full(int i) {
    wg::mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
  }
  __device__ void release(int i) { wg::mbar_arrive(&empty[i % STAGES]); }
};

__device__ __forceinline__ void init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// --- TMA: a box of a 3-D or 4-D map (inner coordinate first), and a plain
// copy
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(wg::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(wg::smem_addr(bar)),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          wg::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(wg::smem_addr(bar)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(wg::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(wg::smem_addr(bar))
      : "memory");
}

// --- wgmma descriptors over a tile of R rows stored as boxes of R rows x
// 64 columns (128 bytes, 128B swizzle), one box after another
// K-major: the contraction runs along a row (the head dimension); k16
// step kk of rows [row0, row0 + 64 or N); 8-row groups 1 KB apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int R, int row0,
                                           int kk) {
  return wg::desc(tile + (kk / 4) * R * 128 + row0 * 128 + (kk % 4) * 32,
                  16, 1024, 1);
}
// MN-major: the contraction runs down the rows, N = 64 columns of box
// `box`; k16 step kk starts 16 rows further down.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int R, int box,
                                            int kk) {
  return wg::desc(tile + box * R * 128 + kk * 16 * 128, R * 128, 1024, 1);
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (+)= A (64 x 16, shared memory, K-major) * B (16 x N, K-major)
template <int N> struct SS;
template <> struct SS<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
};
template <> struct SS<32> {
  __device__ static __forceinline__ void mma(float (&d)[16], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
};

// d (+)= A (64 x 16, bf16 in registers) * B (16 x 64, MN-major)
__device__ __forceinline__ void rs_mma(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// Wait until at most N committed groups are pending.
template <int N> __device__ __forceinline__ void wait_groups() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace attn
}  // namespace goma
