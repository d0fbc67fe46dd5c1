// Absorbed latent attention (DeepSeek-V2's MLA) over the latent slot cache,
// for Hopper (sm_90a).  It replaces no TPU kernel: latent attention exists
// only in the port (models/mla.py), whose per-row path multiplied each
// row's queries against all T cached positions with two cuBLAS products,
// wrote fp32 scores of (B, S * H, T), masked the keys past each row's
// position, ran an fp32 softmax over the whole width, cast P to bf16 and
// read the cache a second time for the values.
//
// What bounds it: bytes.  Each query's keys are the 576-wide latent rows
// [c_kv | k_pe] of its own batch row; a decode step has 16 (query, head)
// rows per batch row, far too few to reuse a key tile, so the least time
// is the visible keys x 576 x 2 B, plus q and o, over the memory rate.
// The design reads each visible key once and nothing past the last
// visible key of a CTA:
//
//   mla_attn     (split, 64-row query tile, batch row): one CTA holds 64
//                (query, head) rows of one batch row (4 queries of 16
//                heads; a decode step's 16 rows leave 48 idle, which costs
//                tensor-core time the bytes hide) and walks the keys of one
//                split (a count of positions the wrapper fixes), cut at
//                the tile's last visible key, in BK-key tiles through a
//                TMA ring.  Two warpgroups: each sums half of the 576-deep
//                scores S = Q K^T on the tensor cores (wgmma, fp32), the
//                halves are exchanged through shared memory and added in
//                one order, so both hold the same S and run the same
//                online softmax in fp32; P, rounded to bf16, multiplies
//                the same key tile's first 512 columns (the values) for
//                256 output columns a warpgroup.  The cache is read once:
//                the values reuse the key tile already in shared memory.
//                A split past its rows' positions writes m = -inf, l = 0
//                and returns.  It writes the split's unnormalised output
//                and its (m, l) in fp32.
//   mla_combine  (row): the splits' partials combined by log-sum-exp in
//                split order, divided by the sum, rounded to bf16.
//
// Grid and scratch depend on the shapes alone, and nothing is added by
// atomics, so a captured graph replays the eager call bit for bit.
//
// Numerics: q and the cache are bf16, products are bf16 x bf16 with fp32
// sums, the softmax is fp32 and the output is rounded to bf16 once, as in
// models/mla.py's products.  Two differences: the sums run in another
// order (the scores' two halves of the depth, the online softmax and the
// splits), and P is rounded to bf16 before the normalisation, exp(s - m)
// of the running max, where the products rounded softmax(s).
#include <math.h>

#include "attn_tile.cuh"

namespace {

namespace wg = goma::wg;
using namespace goma::attn;

constexpr int D = 576;                 // latent key width: rank + rope
constexpr int DV = 512;                // latent value width: rank
constexpr int NBOX = D / 64;           // 64-column boxes of a row
constexpr int ROWS = 64;               // (query, head) rows of a CTA
constexpr int NWG = 2;                 // warpgroups a CTA
constexpr int THREADS = 128 * NWG;     // thread 0 also issues the copies
constexpr int BK = 32;                 // keys of a ring stage
constexpr int STAGES = 3;
constexpr int KSTEPS = D / 16;         // k16 steps of the scores
constexpr int HALF = KSTEPS / NWG;     // of them, a warpgroup's
constexpr int VBOXES = DV / 64 / NWG;  // value boxes of a warpgroup
constexpr int BIG = 1 << 30;           // a position no key reaches

constexpr int Q_BOX = ROWS * 128;
constexpr int Q_BYTES = NBOX * Q_BOX;
constexpr int K_BOX = BK * 128;
constexpr int K_BYTES = NBOX * K_BOX;
constexpr int X_FLOATS = ROWS * BK;    // a warpgroup's half of S
constexpr int X_BYTES = 2 * NWG * X_FLOATS * 4;   // two tiles in turn
using Ring = goma::attn::Ring<STAGES, THREADS>;
constexpr int SMEM = Q_BYTES + STAGES * K_BYTES + X_BYTES + sizeof(Ring) +
                     16 + wg::ALIGN;
static_assert(KSTEPS % NWG == 0 && DV % (64 * NWG) == 0, "even halves");

struct Shape {
  int S, T, H, SH, NS, split;   // queries, keys, heads, S * H rows,
                                // splits, keys of a split (whole tiles)
};

// the last key a query at position p sees: min(p, T - 1)
__device__ __forceinline__ int key_limit(const long long* qpos, int b,
                                         int s, const Shape& sh) {
  const long long p = qpos[static_cast<long>(b) * sh.S + s];
  return static_cast<int>(p < sh.T - 1 ? p : sh.T - 1);
}

__device__ __forceinline__ void bar_sync_all() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(THREADS, 1)
mla_attn(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const long long* __restrict__ qpos, float* __restrict__ part,
         float2* __restrict__ ml, Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_tile = wg::aligned_smem(smem_raw);
  uint8_t* k_tiles = q_tile + Q_BYTES;
  float* xbuf = reinterpret_cast<float*>(k_tiles + STAGES * K_BYTES);
  Ring& ring = *reinterpret_cast<Ring*>(
      reinterpret_cast<uint8_t*>(xbuf) + X_BYTES);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(&ring + 1);

  const int split = blockIdx.x, b = blockIdx.z;
  const int r0 = blockIdx.y * ROWS, r1 = min(r0 + ROWS, sh.SH) - 1;
  // the least and greatest last key of the tile's queries
  int plo = BIG, phi = -1;
  for (int s = r0 / sh.H; s <= r1 / sh.H; ++s) {
    const int p = key_limit(qpos, b, s, sh);
    plo = min(plo, p);
    phi = max(phi, p);
  }
  const int k0 = split * sh.split, k1 = min(k0 + sh.split, phi + 1);
  const int tiles = k1 > k0 ? (k1 - k0 + BK - 1) / BK : 0;
  const long row_at = static_cast<long>(b) * sh.SH;
  if (tiles == 0) {            // no key of this split is visible
    const int row = r0 + threadIdx.x;
    if (threadIdx.x < ROWS && row < sh.SH)
      ml[(row_at + row) * sh.NS + split] = make_float2(-INFINITY, 0.0f);
    return;
  }
  auto issue = [&](int n) {
    uint64_t* bar = ring.acquire(n, K_BYTES);
    uint8_t* dst = k_tiles + (n % STAGES) * K_BYTES;
#pragma unroll
    for (int c = 0; c < NBOX; ++c)
      tma_load3(dst + c * K_BOX, &tk, bar, 64 * c, k0 + n * BK, b);
  };
  if (threadIdx.x == 0) {
    ring.init();
    wg::mbar_init(qbar, 1);
    init_fence();
    wg::mbar_expect_tx(qbar, Q_BYTES);
#pragma unroll
    for (int c = 0; c < NBOX; ++c)
      tma_load3(q_tile + c * Q_BOX, &tq, qbar, 64 * c, r0, b);
    for (int n = 0; n < tiles && n < STAGES; ++n) issue(n);
  }
  __syncthreads();
  const int w = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int rl = 16 * (t / 32) + lane / 4, c2 = 2 * (lane % 4);
  // each thread's two rows: their last keys (every key for a padding row,
  // whose query is zeros)
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + rl + 8 * r;
    lim[r] = row < sh.SH ? key_limit(qpos, b, row / sh.H, sh) : BIG;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[VBOXES][32];
#pragma unroll
  for (int x = 0; x < VBOXES; ++x)
#pragma unroll
    for (int y = 0; y < 32; ++y) o[x][y] = 0.0f;
  const uint32_t qa = wg::smem_addr(q_tile);
  wg::mbar_wait(qbar, 0);
  for (int n = 0; n < tiles; ++n) {
    const uint32_t ka = wg::smem_addr(k_tiles + (n % STAGES) * K_BYTES);
    ring.wait_full(n);
    // this warpgroup's half of the depth of S = Q K^T
    float sc[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) sc[x] = 0.0f;
    wg::fence_acc(sc);
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < HALF; ++kk) {
      const int k = w * HALF + kk;
      SS<32>::mma(sc, kmajor(qa, ROWS, 0, k), kmajor(ka, BK, 0, k), kk > 0);
    }
    wg::mma_commit();
    wait_groups<0>();
    wg::fence_acc(sc);
    // the halves exchanged: thread t of each warpgroup holds the same
    // elements, and a + b == b + a, so both warpgroups hold the same S
    float4* mine = reinterpret_cast<float4*>(
        xbuf + ((n & 1) * NWG + w) * X_FLOATS);
    const float4* other = reinterpret_cast<const float4*>(
        xbuf + ((n & 1) * NWG + (1 - w)) * X_FLOATS);
#pragma unroll
    for (int v = 0; v < 4; ++v)
      mine[v * 128 + t] =
          make_float4(sc[4 * v], sc[4 * v + 1], sc[4 * v + 2], sc[4 * v + 3]);
    bar_sync_all();
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float4 y = other[v * 128 + t];
      sc[4 * v] += y.x;
      sc[4 * v + 1] += y.y;
      sc[4 * v + 2] += y.z;
      sc[4 * v + 3] += y.w;
    }
    // keys past a row's position (and past T) masked, where any are
    const int kb = k0 + n * BK;
    const bool masked = kb + BK - 1 > plo;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int r = (x >> 1) & 1;
      if (masked && kb + 8 * (x >> 2) + c2 + (x & 1) > lim[r])
        sc[x] = -INFINITY;
      mx[r] = fmaxf(mx[r], sc[x]);
    }
    float alpha[2], ms[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      // a row that has seen no key yet keeps m = -inf; guard the exp
      ms[r] = mn == -INFINITY ? 0.0f : mn;
      alpha[r] = expf(m[r] - ms[r]);
      m[r] = mn;
    }
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const float p = expf(sc[x] - ms[(x >> 1) & 1]);
      sum[(x >> 1) & 1] += p;
      sc[x] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
    // P in bf16 as the A operand of two k16 steps: the accumulator layout
    // of m64nNk16 is the register layout of A (attention.cu's Pieces)
    uint32_t pa[2][4];
#pragma unroll
    for (int kc = 0; kc < 2; ++kc)
#pragma unroll
      for (int y = 0; y < 4; ++y)
        pa[kc][y] = pack_bf16(sc[8 * kc + 2 * y], sc[8 * kc + 2 * y + 1]);
#pragma unroll
    for (int box = 0; box < VBOXES; ++box)
#pragma unroll
      for (int x = 0; x < 32; ++x) o[box][x] *= alpha[(x >> 1) & 1];
    fence_regs(pa[0]);
    fence_regs(pa[1]);
#pragma unroll
    for (int box = 0; box < VBOXES; ++box) wg::fence_acc(o[box]);
    wg::mma_fence();
#pragma unroll
    for (int box = 0; box < VBOXES; ++box)
#pragma unroll
      for (int kc = 0; kc < 2; ++kc)
        rs_mma(o[box], pa[kc], mnmajor(ka, BK, w * VBOXES + box, kc), 1);
    wg::mma_commit();
    wait_groups<0>();
#pragma unroll
    for (int box = 0; box < VBOXES; ++box) wg::fence_acc(o[box]);
    ring.release(n);
    // once both warpgroups have released tile n - 1, its stage takes
    // tile n - 1 + STAGES
    if (threadIdx.x == 0 && n >= 1 && n - 1 + STAGES < tiles)
      issue(n - 1 + STAGES);
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + rl + 8 * r;
    if (row >= sh.SH) continue;
    const long at = (row_at + row) * sh.NS + split;
    float* dst = part + at * DV + 64 * w * VBOXES + c2;
#pragma unroll
    for (int box = 0; box < VBOXES; ++box)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(dst + 64 * box + 8 * j) =
            make_float2(o[box][4 * j + 2 * r], o[box][4 * j + 2 * r + 1]);
    if (w == 0 && lane % 4 == 0) ml[at] = make_float2(m[r], l[r]);
  }
}

// One row's splits combined in split order: weights exp(m_j - max m),
// skipping the splits that saw no key; 128 threads of 4 columns.
__global__ void __launch_bounds__(128)
mla_combine(const float* __restrict__ part, const float2* __restrict__ ml,
            __nv_bfloat16* __restrict__ out, int NS) {
  const long row = blockIdx.x;
  const int c = 4 * threadIdx.x;
  float mmax = -INFINITY;
  for (int j = 0; j < NS; ++j) mmax = fmaxf(mmax, ml[row * NS + j].x);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float total = 0.0f;
  for (int j = 0; j < NS; ++j) {
    const float2 v = ml[row * NS + j];
    if (v.x == -INFINITY) continue;
    const float wt = expf(v.x - mmax);
    total += wt * v.y;
    const float4 p =
        *reinterpret_cast<const float4*>(part + (row * NS + j) * DV + c);
    acc.x += wt * p.x;
    acc.y += wt * p.y;
    acc.z += wt * p.z;
    acc.w += wt * p.w;
  }
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + row * DV + c);
  dst[0] = __floats2bfloat162_rn(acc.x / total, acc.y / total);
  dst[1] = __floats2bfloat162_rn(acc.z / total, acc.w / total);
}

// A bf16 tensor of `batch` blocks of `rows` rows of D values (row stride
// D, block stride `ld` elements) as a 3-D map read in boxes of 64 columns
// x box_rows rows of one block (128-byte swizzle); rows past `rows` read
// as zeros.  Returns the encoder's CUresult, or -1 when it is not found.
int make_map3(CUtensorMap* map, const void* base, long rows, long batch,
              long ld, int box_rows) {
  wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// launcher returns besides a cudaError_t: a tensor map the encoder refused
// (plus 100 x the map's place and the encoder's result, or 99 when the
// encoder was not found), and a refused opt-in to the shared memory
constexpr int MAP_FAILED = 10000, SMEM_REFUSED = 20000;

}  // namespace

extern "C" {

// The kernel's constants, for the wrapper to check: 0 the rows of a CTA,
// 1 the keys of a ring stage, 2 the key width, 3 the value width, 4 the
// dynamic shared memory of a CTA.
int mla_attn_config(int what) {
  switch (what) {
    case 0: return ROWS;
    case 1: return BK;
    case 2: return D;
    case 3: return DV;
    default: return SMEM;
  }
}

// q (B, S, H, D) bf16 contiguous; ckv (B, T, D) bf16, rows contiguous, row
// b at ckv + b * ckv_ld; qpos (B, S) int64; part (B * S * H, NS, DV) and
// ml (B * S * H, NS, 2) fp32 scratch; out (B, S, H, DV) bf16; NS splits
// of `split` keys (a multiple of BK) cover T.
int mla_attn_launch(const void* q, const void* ckv, const void* qpos,
                    void* part, void* ml, void* out, int B, int S, int H,
                    int T, long ckv_ld, int n_split, int split,
                    void* stream) {
  cudaGetLastError();
  if (split % BK != 0 || static_cast<long>(n_split) * split < T)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{S, T, H, S * H, n_split, split};
  CUtensorMap tq, tk;
  int res = make_map3(&tq, q, sh.SH, B, static_cast<long>(sh.SH) * D, ROWS);
  if (res != 0) return MAP_FAILED + (res < 0 ? 99 : res % 99);
  res = make_map3(&tk, ckv, T, B, ckv_ld, BK);
  if (res != 0) return MAP_FAILED + 100 + (res < 0 ? 99 : res % 99);
  static const cudaError_t opted = wg::allow_smem(mla_attn, SMEM);
  if (opted != cudaSuccess) return SMEM_REFUSED + static_cast<int>(opted);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_split, (sh.SH + ROWS - 1) / ROWS, B);
  mla_attn<<<grid, THREADS, SMEM, st>>>(
      tq, tk, static_cast<const long long*>(qpos), static_cast<float*>(part),
      static_cast<float2*>(ml), sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_combine<<<static_cast<unsigned>(B) * sh.SH, 128, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float2*>(ml),
      static_cast<__nv_bfloat16*>(out), n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
