// Fused attention for Hopper (sm_90a), with a deterministic backward in
// two kernels.  It replaces no TPU kernel: the reference leaves attention
// to XLA, and the port's walk (models/layers.py, flash_attention) writes
// every key block's fp32 scores to device memory, reads them back in some
// eight elementwise kernels and runs its products in fp32 on the CUDA
// cores.  Here the scores stay in registers and every product runs on the
// bf16 tensor cores (wgmma) with fp32 accumulators.
//
// What bounds it: the tensor cores (a causal layer at B x H x S x hd does
// 4 B H hd S (S + 1) / 2 flops forward, the bytes are far fewer).  The
// design: one CTA holds 128 rows (queries, or keys in dK/dV), two
// warpgroups of 64 rows each, and streams the other operand's 64- or
// BQ-row tiles through a TMA ring that its first thread keeps full
// (goma_tile.cuh's mbarriers, TMA and descriptors, 128-byte swizzle);
// with no producer warps beside them the warpgroups have the SM's
// registers to themselves (up to 255 a thread).  Inside a warpgroup the
// next product is issued before the CUDA cores take the last one's
// result: the forward's next S during the softmax, dP during P, and (at
// head size 64) in dK/dV the dK products while dV's sum is added.  Tiles that no row of
// the CTA sees are never loaded, and only tiles that some rows see in part
// are masked, from the tables the wrapper computes (attention.tile_ranges).
//
// Exactness (kernels/attention.py): Q, K, V and dO are bf16, so S = Q K^T,
// dP = dO V^T and every product with one of them as the other factor is
// exact in fp32.  The fp32 operands P and dS go into their products as
// three bf16 pieces each (hi, mid, lo: hi + mid + lo == x), P carrying
// 2**64 and dS 2**40 so that every value lies where the split is exact;
// each piece is one wgmma with A taken from registers, the smallest first,
// into a fresh accumulator per tile that is then added to the running sum
// on the CUDA cores in fp32.  Nothing runs in TF32.
//
//   attn_fwd   (b, h, 128-query tile): S on the tensor cores, the online
//              softmax in fp32 registers, P V by P's pieces; writes O in
//              bf16, O in fp32 and the log-sum-exp (+inf past S).
//   attn_dq    (b, h, 128-query tile): D = rowsum(dO O32) (written for
//              attn_dkdv, 0 past S), P from the log-sum-exp, dP = dO V^T,
//              dS = P (dP - D), dQ = dS K by dS's pieces.
//   attn_dkdv  (b, KV head, 128-key tile): over the G query heads of the
//              group and the query tiles from the first that sees a key:
//              S^T = K Q^T, dP^T = V dO^T, dV = P^T dO and dK = dS^T Q by
//              the pieces.  Each dK/dV row has one writer: no atomics.
#include <math.h>

#include "attn_tile.cuh"

namespace {

namespace wg = goma::wg;
using bf16 = __nv_bfloat16;

constexpr int BIG = 1 << 30;                  // a position no query reaches
constexpr float P_SCALE = 18446744073709551616.0f;   // 2**64
constexpr float DS_SCALE = 1099511627776.0f;         // 2**40
constexpr int ROWS = 64;                      // rows of a warpgroup
constexpr int NWG = 2;                        // warpgroups a CTA
constexpr int THREADS = 128 * NWG;            // thread 0 also issues copies
constexpr int CTA_ROWS = ROWS * NWG;          // 128 queries or keys a CTA
constexpr int BK = 64;                        // keys of a forward/dQ stage
constexpr int STAGES = 4;

// queries of a dK/dV ring stage: 32 at head size 128 keeps the dK and dV
// sums, the scores and the pieces of one stage within the registers
__host__ __device__ constexpr int bq_for(int hd) { return hd == 64 ? 64 : 32; }

using namespace goma::attn;
using Ring = goma::attn::Ring<STAGES, THREADS>;

// Rows [row0, row0 + rows) of head `head` of batch row `b`, every column,
// as hd / 64 boxes of rows x 128 bytes one after another.  Rows past the
// map's length read as zeros.
template <int HD>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* m,
                                          uint64_t* bar, int rows, int row0,
                                          int head, int b) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c)
    tma_load4(dst + c * rows * 128, m, bar, c * 64, head, row0, b);
}

// x0 and x1 as three pairs of bf16 pieces, hi + mid + lo == x
// (attention.split3), x0 in the low half of each: one conversion a pair
__device__ __forceinline__ uint32_t as_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = as_bits(h);
  mid = as_bits(m);
  lo = as_bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// The pieces of an accumulator of C columns as the A operand of C / 16
// k16 steps.  The accumulator layout of m64nNk16 (thread t: rows
// r = 16 (t / 32) + t % 32 / 4 and r + 8, columns 8j + 2 (t % 4) and the
// next, d[4j .. 4j + 3]) is the register layout of A: k16 step kc takes
// d[8kc .. 8kc + 7] in order.
template <int C>
struct Pieces {
  uint32_t hi[C / 16][4], mid[C / 16][4], lo[C / 16][4];

  __device__ __forceinline__ void from(const float (&d)[C / 2]) {
#pragma unroll
    for (int kc = 0; kc < C / 16; ++kc)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        split3(d[8 * kc + 2 * x], d[8 * kc + 2 * x + 1], hi[kc][x],
               mid[kc][x], lo[kc][x]);
  }
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int kc = 0; kc < C / 16; ++kc) {
      fence_regs(hi[kc]);
      fence_regs(mid[kc]);
      fence_regs(lo[kc]);
    }
  }
};

// Issue tile = pieces (64 x C) @ B (C x 64, MN-major, columns of box
// `box`): the lo pieces first, then mid, then hi, into one fresh fp32 sum;
// committed as one group, not waited for (the pieces and the tile stay
// untouched until a wait covers the group).
template <int C>
__device__ __forceinline__ void issue_pieces(float (&tile)[32],
                                             Pieces<C>& p, uint32_t b,
                                             int R, int box) {
  p.fence();
  wg::fence_acc(tile);
  wg::mma_fence();
#pragma unroll
  for (int kc = 0; kc < C / 16; ++kc)
    rs_mma(tile, p.lo[kc], mnmajor(b, R, box, kc), kc > 0);
#pragma unroll
  for (int kc = 0; kc < C / 16; ++kc)
    rs_mma(tile, p.mid[kc], mnmajor(b, R, box, kc), 1);
#pragma unroll
  for (int kc = 0; kc < C / 16; ++kc)
    rs_mma(tile, p.hi[kc], mnmajor(b, R, box, kc), 1);
  wg::mma_commit();
}

// Issue d = A (64 rows from row0 of an R-row K-major tile) @ B^T (a
// K-major tile of N rows), over the head dimension; one group.
template <int HD, int N>
__device__ __forceinline__ void issue_scores(float (&d)[N / 2], uint32_t a,
                                             int R, int row0, uint32_t b) {
  wg::fence_acc(d);
  wg::mma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    SS<N>::mma(d, kmajor(a, R, row0, kk), kmajor(b, N, 0, kk), kk > 0);
  wg::mma_commit();
}

// the position a query row compares key positions against: its own if
// causal, else one every visible key (< BIG) is at or before
__device__ __forceinline__ int query_limit(const int* qp, long qp_row,
                                           int b, int row, int S,
                                           int causal) {
  return causal && row < S ? qp[b * qp_row + row] : BIG - 1;
}
// a key's effective position (BIG where it is invisible to every query)
__device__ __forceinline__ int key_position(const int* kpe, int col, int T) {
  return col < T ? kpe[col] : BIG;
}

// --- shared memory layouts
template <int HD> struct QLayout {          // attn_fwd and attn_dq
  static constexpr int Q_BYTES = CTA_ROWS * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int TILES = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int BYTES = TILES + CTA_ROWS * 4 + sizeof(Ring) + 16 +
                               wg::ALIGN;
};
template <int HD> struct KVLayout {         // attn_dkdv
  static constexpr int BQ = bq_for(HD);
  static constexpr int KV_BYTES = CTA_ROWS * HD * 2;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int TILES = 2 * KV_BYTES + 2 * STAGES * Q_BYTES;
  static constexpr int BYTES = TILES + 2 * STAGES * BQ * 4 + sizeof(Ring) +
                               16 + wg::ALIGN;
};

struct Shape {
  int S, T, H, G, S_pad, causal;
  long qp_row;
  float scale;
};

// Thread 0 issues the copies: the first STAGES tiles before the loop,
// then, once both warpgroups have released tile n - 1, tile
// n - 1 + STAGES, so a warpgroup one tile behind the other never holds
// it up.  Returns whether tile n - 1 + STAGES is to be issued now.
__device__ __forceinline__ bool refill_now(int n, int tiles) {
  return threadIdx.x == 0 && n >= 1 && n - 1 + STAGES < tiles;
}

// ------------------------------------------------------------- forward
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
attn_fwd(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, const int* __restrict__ qp,
         const int* __restrict__ kpe, const int* __restrict__ k_full,
         const int* __restrict__ k_hi, bf16* __restrict__ O,
         float* __restrict__ O32, float* __restrict__ LSE, Shape sh) {
  using L = QLayout<HD>;
  constexpr int NB = HD / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_tile = wg::aligned_smem(smem_raw);
  uint8_t* k_tiles = q_tile + 2 * L::Q_BYTES;
  uint8_t* v_tiles = k_tiles + STAGES * L::KV_BYTES;
  Ring& ring = *reinterpret_cast<Ring*>(q_tile + L::TILES + CTA_ROWS * 4);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(&ring + 1);

  const int bh = blockIdx.x, b = bh / sh.H, h = bh % sh.H, kvh = h / sh.G;
  const int NQ = gridDim.y, i = NQ - 1 - blockIdx.y;   // late rows first
  // a tile whose rows see no key still walks key tile 0, masked whole:
  // every wgmma is then issued on a path all CTAs take (a wgmma under a
  // branch is serialized)
  const int n_full = k_full[b * NQ + i], n_hi = max(k_hi[b * NQ + i], 1);
  auto issue = [&](int n) {
    uint64_t* bar = ring.acquire(n, 2 * L::KV_BYTES);
    const int s = n % STAGES;
    load_tile<HD>(k_tiles + s * L::KV_BYTES, &tk, bar, BK, n * BK, kvh, b);
    load_tile<HD>(v_tiles + s * L::KV_BYTES, &tv, bar, BK, n * BK, kvh, b);
  };
  if (threadIdx.x == 0) {
    ring.init();
    wg::mbar_init(qbar, 1);
    init_fence();
    wg::mbar_expect_tx(qbar, L::Q_BYTES);
    load_tile<HD>(q_tile, &tq, qbar, CTA_ROWS, i * CTA_ROWS, h, b);
    for (int n = 0; n < n_hi && n < STAGES; ++n) issue(n);
  }
  __syncthreads();
  const int w = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int rl = 16 * (t / 32) + lane / 4, c2 = 2 * (lane % 4);
  int row[2], qlim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = i * CTA_ROWS + w * ROWS + rl + 8 * r;
    qlim[r] = query_limit(qp, sh.qp_row, b, row[r], sh.S, sh.causal);
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[NB][32];
#pragma unroll
  for (int x = 0; x < NB; ++x)
#pragma unroll
    for (int y = 0; y < 32; ++y) o[x][y] = 0.0f;
  const uint32_t qa = wg::smem_addr(q_tile);
  auto k_at = [&](int n) {
    return wg::smem_addr(k_tiles + (n % STAGES) * L::KV_BYTES);
  };
  wg::mbar_wait(qbar, 0);
  // S of tile n + 1 runs on the tensor cores while the CUDA cores take
  // tile n's softmax (the last tile's S once more in the last step)
  float sc[32], nx[32];
  ring.wait_full(0);
  issue_scores<HD, BK>(sc, qa, CTA_ROWS, w * ROWS, k_at(0));
  // a do-while: every path to the end waits for the last group
  int n = 0;
  do {
    const uint32_t va =
        wg::smem_addr(v_tiles + (n % STAGES) * L::KV_BYTES);
    wait_groups<0>();
    wg::fence_acc(sc);
    const int next = min(n + 1, n_hi - 1);
    ring.wait_full(next);
    issue_scores<HD, BK>(nx, qa, CTA_ROWS, w * ROWS, k_at(next));
    const bool masked = n >= n_full;
    // the max of the raw scores, scaled once: rounding is monotonic, so
    // it is the max of the scaled scores
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1;
      if (masked &&
          key_position(kpe, n * BK + 8 * (x >> 2) + c2 + (x & 1), sh.T) >
              qlim[r])
        sc[x] = -INFINITY;
      mx[r] = fmaxf(mx[r], sc[x]);
    }
    float alpha[2], ms[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]) * sh.scale);
      // rows with no visible key yet keep m = -inf; guard the exp
      ms[r] = mn == -INFINITY ? 0.0f : mn;
      alpha[r] = expf(m[r] - ms[r]);
      m[r] = mn;
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1;
      const float p = expf(fmaf(sc[x], sh.scale, -ms[r]));
      sum[r] += p;
      sc[x] = p * P_SCALE;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
    Pieces<BK> pp;
    pp.from(sc);
#pragma unroll
    for (int box = 0; box < NB; ++box) {
      float tile[32];
      issue_pieces(tile, pp, va, BK, box);
      wait_groups<0>();
      wg::fence_acc(tile);
#pragma unroll
      for (int x = 0; x < 32; ++x)
        o[box][x] = fmaf(o[box][x], alpha[(x >> 1) & 1], tile[x]);
    }
    pp.fence();
    ring.release(n);
    if (refill_now(n, n_hi)) issue(n - 1 + STAGES);
    __syncwarp();
    wg::fence_acc(nx);
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = nx[x];
  } while (++n < n_hi);
  // the walk's acc / clamp(total, 1e-20); P's pieces carried 2**64
  float denom[2], lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    denom[r] = fmaxf(l[r], 1e-20f) * P_SCALE;
    const float ms = m[r] == -INFINITY ? 0.0f : m[r];
    lse[r] = l[r] > 0.0f && row[r] < sh.S ? ms + logf(l[r]) : INFINITY;
  }
#pragma unroll
  for (int box = 0; box < NB; ++box)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= sh.S) continue;
        const float v0 = o[box][4 * j + 2 * r] / denom[r];
        const float v1 = o[box][4 * j + 2 * r + 1] / denom[r];
        const long at = ((static_cast<long>(b) * sh.S + row[r]) * sh.H + h) *
                            HD + 64 * box + 8 * j + c2;
        *reinterpret_cast<__nv_bfloat162*>(O + at) =
            __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<float2*>(O32 + at) = make_float2(v0, v1);
      }
  if (lane % 4 == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      LSE[static_cast<long>(bh) * sh.S_pad + row[r]] = lse[r];
}

// ------------------------------------------------------------------ dQ
template <int HD, typename TG>
__global__ void __launch_bounds__(THREADS, 1)
attn_dq(const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tdo,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv, const int* __restrict__ qp,
        const int* __restrict__ kpe, const int* __restrict__ k_full,
        const int* __restrict__ k_hi, const bf16* __restrict__ dO,
        const float* __restrict__ O32, const float* __restrict__ LSE,
        float* __restrict__ DELTA, TG* __restrict__ dQ, Shape sh) {
  using L = QLayout<HD>;
  constexpr int NB = HD / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_tile = wg::aligned_smem(smem_raw);
  uint8_t* do_tile = q_tile + L::Q_BYTES;
  uint8_t* k_tiles = q_tile + 2 * L::Q_BYTES;
  uint8_t* v_tiles = k_tiles + STAGES * L::KV_BYTES;
  float* d_rows = reinterpret_cast<float*>(q_tile + L::TILES);
  Ring& ring = *reinterpret_cast<Ring*>(q_tile + L::TILES + CTA_ROWS * 4);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(&ring + 1);

  const int bh = blockIdx.x, b = bh / sh.H, h = bh % sh.H, kvh = h / sh.G;
  const int NQ = gridDim.y, i = NQ - 1 - blockIdx.y;
  const int n_full = k_full[b * NQ + i], n_hi = k_hi[b * NQ + i];
  auto issue = [&](int n) {
    uint64_t* bar = ring.acquire(n, 2 * L::KV_BYTES);
    const int s = n % STAGES;
    load_tile<HD>(k_tiles + s * L::KV_BYTES, &tk, bar, BK, n * BK, kvh, b);
    load_tile<HD>(v_tiles + s * L::KV_BYTES, &tv, bar, BK, n * BK, kvh, b);
  };
  if (threadIdx.x == 0) {
    ring.init();
    wg::mbar_init(qbar, 1);
    init_fence();
    wg::mbar_expect_tx(qbar, 2 * L::Q_BYTES);
    load_tile<HD>(q_tile, &tq, qbar, CTA_ROWS, i * CTA_ROWS, h, b);
    load_tile<HD>(do_tile, &tdo, qbar, CTA_ROWS, i * CTA_ROWS, h, b);
    for (int n = 0; n < n_hi && n < STAGES; ++n) issue(n);
  }
  const int w = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  // D = rowsum(dO * O) against the fp32 O: two threads a row, each half
  // the columns; 0 past S
  {
    const int lr = w * ROWS + t / 2, grow = i * CTA_ROWS + lr;
    float d = 0.0f;
    if (grow < sh.S) {
      const long at = ((static_cast<long>(b) * sh.S + grow) * sh.H + h) *
                          HD + (t % 2) * (HD / 2);
#pragma unroll 8
      for (int c = 0; c < HD / 2; ++c)
        d += __bfloat162float(dO[at + c]) * O32[at + c];
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (t % 2 == 0) {
      d_rows[lr] = d;
      DELTA[static_cast<long>(bh) * sh.S_pad + grow] = d;
    }
  }
  __syncthreads();
  const int rl = 16 * (t / 32) + lane / 4, c2 = 2 * (lane % 4);
  int row[2], qlim[2];
  float lse[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = i * CTA_ROWS + w * ROWS + rl + 8 * r;
    qlim[r] = query_limit(qp, sh.qp_row, b, row[r], sh.S, sh.causal);
    lse[r] = LSE[static_cast<long>(bh) * sh.S_pad + row[r]];
    dd[r] = d_rows[w * ROWS + rl + 8 * r];
  }
  float dq[NB][32];
#pragma unroll
  for (int x = 0; x < NB; ++x)
#pragma unroll
    for (int y = 0; y < 32; ++y) dq[x][y] = 0.0f;
  const uint32_t qa = wg::smem_addr(q_tile), doa = wg::smem_addr(do_tile);
  wg::mbar_wait(qbar, 0);
  for (int n = 0; n < n_hi; ++n) {
    const int s = n % STAGES;
    const uint32_t ka = wg::smem_addr(k_tiles + s * L::KV_BYTES);
    const uint32_t va = wg::smem_addr(v_tiles + s * L::KV_BYTES);
    ring.wait_full(n);
    float sc[32], dp[32];
    issue_scores<HD, BK>(sc, qa, CTA_ROWS, w * ROWS, ka);
    issue_scores<HD, BK>(dp, doa, CTA_ROWS, w * ROWS, va);
    // P while dP = dO V^T is still on the tensor cores
    wait_groups<1>();
    wg::fence_acc(sc);
    const bool masked = n >= n_full;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1;
      float p = expf(fmaf(sc[x], sh.scale, -lse[r]));
      if (masked &&
          key_position(kpe, n * BK + 8 * (x >> 2) + c2 + (x & 1), sh.T) >
              qlim[r])
        p = 0.0f;
      sc[x] = p;
    }
    wait_groups<0>();
    wg::fence_acc(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x)
      sc[x] = sc[x] * (dp[x] - dd[(x >> 1) & 1]) * DS_SCALE;
    Pieces<BK> pp;
    pp.from(sc);
#pragma unroll
    for (int box = 0; box < NB; ++box) {
      float tile[32];
      issue_pieces(tile, pp, ka, BK, box);
      wait_groups<0>();
      wg::fence_acc(tile);
#pragma unroll
      for (int x = 0; x < 32; ++x) dq[box][x] += tile[x];
    }
    pp.fence();
    ring.release(n);
    if (refill_now(n, n_hi)) issue(n - 1 + STAGES);
    __syncwarp();
  }
  const float unscale = sh.scale / DS_SCALE;
#pragma unroll
  for (int box = 0; box < NB; ++box)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= sh.S) continue;
        const long at = ((static_cast<long>(b) * sh.S + row[r]) * sh.H + h) *
                            HD + 64 * box + 8 * j + c2;
        dQ[at] = goma::from_float<TG>(dq[box][4 * j + 2 * r] * unscale);
        dQ[at + 1] = goma::from_float<TG>(dq[box][4 * j + 2 * r + 1] *
                                          unscale);
      }
}

// --------------------------------------------------------------- dK/dV
template <int HD, typename TG>
__global__ void __launch_bounds__(THREADS, 1)
attn_dkdv(const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tdo, const int* __restrict__ qp,
          const int* __restrict__ kpe, const int* __restrict__ q_lo,
          const int* __restrict__ q_full, const float* __restrict__ LSE,
          const float* __restrict__ DELTA, TG* __restrict__ dK,
          TG* __restrict__ dV, int KV, int NQ, Shape sh) {
  using L = KVLayout<HD>;
  constexpr int NB = HD / 64, BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_tile = wg::aligned_smem(smem_raw);
  uint8_t* v_tile = k_tile + L::KV_BYTES;
  uint8_t* q_tiles = k_tile + 2 * L::KV_BYTES;
  uint8_t* do_tiles = q_tiles + STAGES * L::Q_BYTES;
  float* lse_rows = reinterpret_cast<float*>(k_tile + L::TILES);
  float* d_rows = lse_rows + STAGES * BQ;
  Ring& ring = *reinterpret_cast<Ring*>(d_rows + STAGES * BQ);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(&ring + 1);

  const int bk = blockIdx.x, b = bk / KV, kvh = bk % KV;
  const int NK = gridDim.y, j = blockIdx.y;        // early keys first
  const int i_lo = q_lo[b * NK + j], i_full = q_full[b * NK + j];
  const int per_head = NQ - i_lo, steps = sh.G * per_head;
  // step n: query tile i_lo + n % per_head of the group's head n / per_head
  auto issue = [&](int n) {
    const int h = kvh * sh.G + n / per_head, ii = i_lo + n % per_head;
    uint64_t* bar = ring.acquire(n, 2 * L::Q_BYTES + 2 * BQ * 4);
    const int s = n % STAGES;
    load_tile<HD>(q_tiles + s * L::Q_BYTES, &tq, bar, BQ, ii * BQ, h, b);
    load_tile<HD>(do_tiles + s * L::Q_BYTES, &tdo, bar, BQ, ii * BQ, h, b);
    const long at = (static_cast<long>(b) * sh.H + h) * sh.S_pad + ii * BQ;
    bulk_load(lse_rows + s * BQ, LSE + at, BQ * 4, bar);
    bulk_load(d_rows + s * BQ, DELTA + at, BQ * 4, bar);
  };
  if (threadIdx.x == 0) {
    ring.init();
    wg::mbar_init(kvbar, 1);
    init_fence();
    wg::mbar_expect_tx(kvbar, 2 * L::KV_BYTES);
    load_tile<HD>(k_tile, &tk, kvbar, CTA_ROWS, j * CTA_ROWS, kvh, b);
    load_tile<HD>(v_tile, &tv, kvbar, CTA_ROWS, j * CTA_ROWS, kvh, b);
    for (int n = 0; n < steps && n < STAGES; ++n) issue(n);
  }
  __syncthreads();
  const int w = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int rl = 16 * (t / 32) + lane / 4, c2 = 2 * (lane % 4);
  int key[2], kpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = j * CTA_ROWS + w * ROWS + rl + 8 * r;
    kpos[r] = key_position(kpe, key[r], sh.T);
  }
  float dk[NB][32], dv[NB][32];
#pragma unroll
  for (int x = 0; x < NB; ++x)
#pragma unroll
    for (int y = 0; y < 32; ++y) dk[x][y] = dv[x][y] = 0.0f;
  const uint32_t ka = wg::smem_addr(k_tile), va = wg::smem_addr(v_tile);
  wg::mbar_wait(kvbar, 0);
  for (int n = 0; n < steps; ++n) {
    const int ii = i_lo + n % per_head;
    const int s = n % STAGES;
    const uint32_t qa = wg::smem_addr(q_tiles + s * L::Q_BYTES);
    const uint32_t doa = wg::smem_addr(do_tiles + s * L::Q_BYTES);
    const float* ls = lse_rows + s * BQ;
    const float* ds = d_rows + s * BQ;
    ring.wait_full(n);
    float st[BQ / 2], dpt[BQ / 2];
    issue_scores<HD, BQ>(st, ka, CTA_ROWS, w * ROWS, qa);
    issue_scores<HD, BQ>(dpt, va, CTA_ROWS, w * ROWS, doa);
    // P^T while dP^T = V dO^T is still on the tensor cores
    wait_groups<1>();
    wg::fence_acc(st);
    const bool masked = ii < i_full;
#pragma unroll
    for (int x = 0; x < BQ / 2; ++x) {
      const int r = (x >> 1) & 1, col = 8 * (x >> 2) + c2 + (x & 1);
      float p = expf(fmaf(st[x], sh.scale, -ls[col]));
      if (masked && kpos[r] > query_limit(qp, sh.qp_row, b, ii * BQ + col,
                                          sh.S, sh.causal))
        p = 0.0f;
      st[x] = p;
    }
    wait_groups<0>();
    wg::fence_acc(dpt);
#pragma unroll
    for (int x = 0; x < BQ / 2; ++x) {
      const int col = 8 * (x >> 2) + c2 + (x & 1);
      dpt[x] = st[x] * (dpt[x] - ds[col]) * DS_SCALE;
      st[x] = st[x] * P_SCALE;
    }
    if constexpr (NB == 1) {
      // dV's products run while dS is split, dK's while dV is summed
      float tv_[32], tk_[32];
      Pieces<BQ> pv, pk;
      pv.from(st);
      issue_pieces(tv_, pv, doa, BQ, 0);
      pk.from(dpt);
      issue_pieces(tk_, pk, qa, BQ, 0);
      wait_groups<1>();
      wg::fence_acc(tv_);
#pragma unroll
      for (int x = 0; x < 32; ++x) dv[0][x] += tv_[x];
      wait_groups<0>();
      wg::fence_acc(tk_);
#pragma unroll
      for (int x = 0; x < 32; ++x) dk[0][x] += tk_[x];
      pv.fence();
      pk.fence();
    } else {
      Pieces<BQ> pp;
      pp.from(st);
#pragma unroll
      for (int box = 0; box < NB; ++box) {
        float tile[32];
        issue_pieces(tile, pp, doa, BQ, box);
        wait_groups<0>();
        wg::fence_acc(tile);
#pragma unroll
        for (int x = 0; x < 32; ++x) dv[box][x] += tile[x];
      }
      pp.from(dpt);
#pragma unroll
      for (int box = 0; box < NB; ++box) {
        float tile[32];
        issue_pieces(tile, pp, qa, BQ, box);
        wait_groups<0>();
        wg::fence_acc(tile);
#pragma unroll
        for (int x = 0; x < 32; ++x) dk[box][x] += tile[x];
      }
      pp.fence();
    }
    ring.release(n);
    if (refill_now(n, steps)) issue(n - 1 + STAGES);
    __syncwarp();
  }
  const float k_unscale = sh.scale / DS_SCALE, v_unscale = 1.0f / P_SCALE;
#pragma unroll
  for (int box = 0; box < NB; ++box)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (key[r] >= sh.T) continue;
        const long at = ((static_cast<long>(b) * sh.T + key[r]) * KV + kvh) *
                            HD + 64 * box + 8 * jj + c2;
        const int x = 4 * jj + 2 * r;
        dK[at] = goma::from_float<TG>(dk[box][x] * k_unscale);
        dK[at + 1] = goma::from_float<TG>(dk[box][x + 1] * k_unscale);
        dV[at] = goma::from_float<TG>(dv[box][x] * v_unscale);
        dV[at + 1] = goma::from_float<TG>(dv[box][x + 1] * v_unscale);
      }
}

// --- host
// A contiguous (B, L, NH, HD) bf16 tensor as a 4-D map read in boxes of
// `rows` rows of one head, 64 columns wide (128-byte swizzle).
// Returns the encoder's CUresult, or -1 when it is not found.
int make_map4(CUtensorMap* map, const void* base, int hd, int nh, int len,
              int batch, int rows) {
  wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(nh),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(nh) * hd * 2,
                                 static_cast<cuuint64_t>(len) * nh * hd * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// launcher returns besides a cudaError_t: a tensor map the encoder refused
// (plus 100 x the map's place in the call and the encoder's result, or 99
// when its encoder was not found), and a refused opt-in to the dynamic
// shared memory (plus its error)
constexpr int MAP_FAILED = 10000, SMEM_REFUSED = 20000;

struct MapSpec {
  CUtensorMap* map;
  const void* base;
  int nh, len, rows;
};
// Encode every map in turn; 0, or the failure's code.
template <int HD, int N>
int make_maps(const MapSpec (&specs)[N], int batch) {
  for (int m = 0; m < N; ++m) {
    const int res = make_map4(specs[m].map, specs[m].base, HD, specs[m].nh,
                              specs[m].len, batch, specs[m].rows);
    if (res != 0) return MAP_FAILED + 100 * m + (res < 0 ? 99 : res % 99);
  }
  return 0;
}

// The autograd engine's device thread may reach a launcher before any
// runtime call has made the device's primary context current on it, and
// cuTensorMapEncodeTiled needs one: make it current.  Then clear
// any older error, so that the launcher reports its own launches.
void enter() {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaSetDevice(dev);
  cudaGetLastError();
}

int s_pad(int S) { return (S + CTA_ROWS - 1) / CTA_ROWS * CTA_ROWS; }

template <int HD>
int fwd_launch(const void* q, const void* k, const void* v, const int* qp,
               const int* kpe, const int* k_full, const int* k_hi, void* o,
               void* o32, void* lse, int B, int S, int T, int H, int KV,
               Shape sh, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  const MapSpec specs[] = {{&tq, q, H, S, CTA_ROWS}, {&tk, k, KV, T, BK},
                           {&tv, v, KV, T, BK}};
  if (const int err = make_maps<HD>(specs, B)) return err;
  constexpr int smem = QLayout<HD>::BYTES;
  static const cudaError_t opted = wg::allow_smem(attn_fwd<HD>, smem);
  if (opted != cudaSuccess) return SMEM_REFUSED + static_cast<int>(opted);
  const dim3 grid(B * H, s_pad(S) / CTA_ROWS);
  attn_fwd<HD><<<grid, THREADS, smem, st>>>(
      tq, tk, tv, qp, kpe, k_full, k_hi, static_cast<bf16*>(o),
      static_cast<float*>(o32), static_cast<float*>(lse), sh);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename TG>
int bwd_launch(const void* q, const void* k, const void* v, const void* dO,
               const int* qp, const int* kpe, const int* k_full,
               const int* k_hi, const int* q_lo, const int* q_full,
               const void* o32, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int B, int S, int T, int H, int KV,
               Shape sh, cudaStream_t st) {
  constexpr int BQ = bq_for(HD);
  CUtensorMap tq, tdo, tk, tv, tk2, tv2, tq2, tdo2;
  const MapSpec specs[] = {
      {&tq, q, H, S, CTA_ROWS},   {&tdo, dO, H, S, CTA_ROWS},
      {&tk, k, KV, T, BK},        {&tv, v, KV, T, BK},
      {&tk2, k, KV, T, CTA_ROWS}, {&tv2, v, KV, T, CTA_ROWS},
      {&tq2, q, H, S, BQ},        {&tdo2, dO, H, S, BQ}};
  if (const int err = make_maps<HD>(specs, B)) return err;
  constexpr int smem_q = QLayout<HD>::BYTES, smem_kv = KVLayout<HD>::BYTES;
  static const cudaError_t opted_q = wg::allow_smem(attn_dq<HD, TG>, smem_q);
  static const cudaError_t opted_kv =
      wg::allow_smem(attn_dkdv<HD, TG>, smem_kv);
  if (opted_q != cudaSuccess) return SMEM_REFUSED + static_cast<int>(opted_q);
  if (opted_kv != cudaSuccess)
    return SMEM_REFUSED + static_cast<int>(opted_kv);
  // dQ first: it writes D, which dK/dV reads
  attn_dq<HD, TG><<<dim3(B * H, s_pad(S) / CTA_ROWS), THREADS, smem_q,
                    st>>>(
      tq, tdo, tk, tv, qp, kpe, k_full, k_hi, static_cast<const bf16*>(dO),
      static_cast<const float*>(o32), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<TG*>(dq), sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int NK = (T + CTA_ROWS - 1) / CTA_ROWS, NQ = (S + BQ - 1) / BQ;
  attn_dkdv<HD, TG><<<dim3(B * KV, NK), THREADS, smem_kv, st>>>(
      tk2, tv2, tq2, tdo2, qp, kpe, q_lo, q_full,
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<TG*>(dk), static_cast<TG*>(dv), KV, NQ, sh);
  return static_cast<int>(cudaGetLastError());
}

Shape make_shape(int S, int T, int H, int KV, int qp_row, int causal,
                 float scale) {
  return Shape{S, T, H, H / KV, s_pad(S), causal, qp_row, scale};
}

}  // namespace

extern "C" {

// The tiles the wrapper's tables must be computed for: 0 the queries of
// a forward / dQ CTA, 1 the keys of its ring stage, 2 the keys of a dK/dV
// CTA, 3 the queries of its stage at head size hd, 4 the padded length
// of the log-sum-exp and D rows.
int attn_tile(int what, int hd) {
  switch (what) {
    case 0: return CTA_ROWS;
    case 1: return BK;
    case 2: return CTA_ROWS;
    case 3: return bq_for(hd);
    default: return CTA_ROWS;
  }
}

int attn_fwd_launch(const void* q, const void* k, const void* v,
                    const void* qp, const void* kpe, const void* k_full,
                    const void* k_hi, void* o, void* o32, void* lse, int B,
                    int S, int T, int H, int KV, int hd, int qp_row,
                    int causal, float scale, void* stream) {
  enter();
  const Shape sh = make_shape(S, T, H, KV, qp_row, causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* i32[4] = {static_cast<const int*>(qp),
                       static_cast<const int*>(kpe),
                       static_cast<const int*>(k_full),
                       static_cast<const int*>(k_hi)};
  if (hd == 64)
    return fwd_launch<64>(q, k, v, i32[0], i32[1], i32[2], i32[3], o, o32,
                          lse, B, S, T, H, KV, sh, st);
  if (hd == 128)
    return fwd_launch<128>(q, k, v, i32[0], i32[1], i32[2], i32[3], o, o32,
                           lse, B, S, T, H, KV, sh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int attn_bwd_launch(const void* q, const void* k, const void* v,
                    const void* dO, const void* qp, const void* kpe,
                    const void* k_full, const void* k_hi, const void* q_lo,
                    const void* q_full, const void* o32, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, int B, int S,
                    int T, int H, int KV, int hd, int qp_row, int causal,
                    int grads_f32, float scale, void* stream) {
  enter();
  const Shape sh = make_shape(S, T, H, KV, qp_row, causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p[6] = {static_cast<const int*>(qp),
                     static_cast<const int*>(kpe),
                     static_cast<const int*>(k_full),
                     static_cast<const int*>(k_hi),
                     static_cast<const int*>(q_lo),
                     static_cast<const int*>(q_full)};
#define ATTN_BWD(HD, TG)                                                     \
  return bwd_launch<HD, TG>(q, k, v, dO, p[0], p[1], p[2], p[3], p[4], p[5], \
                            o32, lse, delta, dq, dk, dv, B, S, T, H, KV, sh, \
                            st)
  if (hd == 64) {
    if (grads_f32) ATTN_BWD(64, float);
    ATTN_BWD(64, bf16);
  }
  if (hd == 128) {
    if (grads_f32) ATTN_BWD(128, float);
    ATTN_BWD(128, bf16);
  }
#undef ATTN_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
