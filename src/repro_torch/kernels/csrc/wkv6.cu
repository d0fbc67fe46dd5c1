// B3: the RWKV-6 WKV chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `wkv6_pallas` (src/repro/kernels/wkv6.py:
// _wkv6_kernel).  Per (batch b, head h), with per-channel log-decays
// lw_t < 0 and the bonus u:
//     S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
// r, k, v, lw and y are (B, S, H, P) in the input dtype (fp32 or bf16),
// u is (H, P) fp32, the final state (B, H, P, P) fp32.  P is 64, RWKV-6's
// head size.
//
// What bounds it on the H100: at the rwkv6-7b prefill shape (B 4, S 256,
// H 64, P 64, fp32) the bytes: 88 MB of operands, output and state, 0.026
// ms at 3.35 TB/s.  Its work, as this kernel does it, is 1.3 GFLOP of
// products (0.0027 ms at the 495 TFLOP/s TF32 tensor-core rate) and 0.22 G
// exps and other operations (0.0034 ms at 67 TFLOP/s; chip_smoke.py,
// wkv6_work).  An exp per (t, s, p) of every chunk (C(C-1)/2 P of them),
// products on the CUDA cores and one CTA per SM would keep it far above
// that bound.  PERF.md has its time and phase split beside the bound.
//
// The design (scan_tile.cuh has the shared pieces):
// - One CTA of 256 threads per (b, h) walks the sequence in sub-chunks of
//   32 tokens with the P x P fp32 state in shared memory.  107 KB of
//   shared memory at P 64 fp32, so two CTAs share an SM: the 256 streams
//   of the served shape are resident at once on 132 SMs.
// - Sub-chunk n + 1's r, k, v and lw are in flight (four TMA boxes of 32
//   token rows, an mbarrier ring of two stages) while sub-chunk n
//   computes.
// - The cumulative log-decays are warp scans (a lane per token); they are
//   folded into r exp(cum_{t-1}) and k exp(total - cum) four channels a
//   thread at a time.
// - The decays are factored per block of 16 tokens: for the query block
//   t in [16, 32) against the key block s in [0, 16), with ref = 15,
//       r~_t = r_t exp(cum_{t-1} - cum_ref),  k~_s = k_s exp(cum_ref - cum_s)
//   (both exponents <= 0, so both factors <= 1), and those scores are the
//   one product r~ k~^T.  Only the two diagonal 16 x 16 blocks keep the
//   exact exp per (t, s, p), with the bonus u on the diagonal.
// - Every product (those scores, y = scores v + (r exp(cum_{t-1})) S, and
//   the state update (k exp(total - cum))^T v) runs on the tensor cores by
//   3xTF32, at fp32 accuracy.
// Every exponent is <= 0, as in the reference.
#include "scan_tile.cuh"

namespace {

using scan::SUB;
using scan::THREADS;
using scan::WARPS;
using scan::ld32;
using scan::ldT;
constexpr int P = 64;        // RWKV-6's head size, the only one it has
constexpr int BLK = 16;      // the decay-factoring block of tokens
constexpr int OPERANDS = 4;  // r, k, v, lw
constexpr int LD = ld32(P), LDS = ld32(SUB);
constexpr int CH = P / WARPS;  // channels a warp scans

template <typename T> constexpr long smem_bytes() {
  return scan::SLACK + scan::BARS +
         2L * OPERANDS * SUB * ldT<T>(P) * static_cast<long>(sizeof(T)) +
         (scan::kF32<T> ? 0 : OPERANDS * SUB * LD * 4L) +
         4L * (2 * SUB * LD + P * LD + SUB * LDS + 2 * P);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
wkv6_kernel(const __grid_constant__ CUtensorMap mr,
            const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mv,
            const __grid_constant__ CUtensorMap mw,
            const float* __restrict__ U, T* __restrict__ Y,
            float* __restrict__ S_out, int S, int H) {
  constexpr int LDT = ldT<T>(P), STAGE = OPERANDS * SUB * LDT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = scan::aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  T* stages = reinterpret_cast<T*>(smem + scan::BARS);
  float* work = reinterpret_cast<float*>(stages + 2 * STAGE);
  float* rdec = work + (scan::kF32<T> ? 0 : OPERANDS * SUB * LD);  // SUB x LD
  float* khat = rdec + SUB * LD;  // SUB x LD
  float* st = khat + SUB * LD;    // P x LD: the state S[p][q]
  float* sc = st + P * LD;        // SUB x LDS: scores for s <= t
  float* u = sc + SUB * LDS;
  float* etot = u + P;            // exp(total log-decay) per channel
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long tok = static_cast<long>(H) * P;  // stride between tokens
  const long base = static_cast<long>(b) * S * tok + static_cast<long>(h) * P;
  const int nsub = (S + SUB - 1) / SUB;

  auto issue = [&](int n) {  // thread 0: sub-chunk n into stage n % 2
    T* stg = stages + (n & 1) * STAGE;
    uint64_t* bar = &full[n & 1];
    goma::wg::mbar_expect_tx(bar, STAGE * static_cast<int>(sizeof(T)));
    const CUtensorMap* maps[OPERANDS] = {&mr, &mk, &mv, &mw};
#pragma unroll
    for (int m = 0; m < OPERANDS; ++m)
      goma::wg::tma_load(stg + m * SUB * LDT, maps[m], bar, h * P,
                         b * S + n * SUB);
  };

  if (tid == 0) scan::init_ring(full);
  for (int i = tid; i < P * LD; i += THREADS) st[i] = 0.f;
  for (int i = tid; i < P; i += THREADS) u[i] = U[h * P + i];
  __syncthreads();
  if (tid == 0) {
    issue(0);
    if (nsub > 1) issue(1);
  }

  for (int n = 0; n < nsub; ++n) {
    const int t0 = n * SUB, rows = min(SUB, S - t0);
    T* stg = stages + (n & 1) * STAGE;
    // 1. the sub-chunk's rows, as fp32; rows past S are zero
    goma::wg::mbar_wait(&full[n & 1], (n >> 1) & 1);
    float* r = scan::as_work(stg, work, rows, P);
    float* k = scan::as_work(stg + SUB * LDT, work + SUB * LD, rows, P);
    float* v = scan::as_work(stg + 2 * SUB * LDT, work + 2 * SUB * LD, rows, P);
    float* cum =
        scan::as_work(stg + 3 * SUB * LDT, work + 3 * SUB * LD, rows, P);
    __syncthreads();
    // 2. per channel, a warp scan of the log-decays (a lane per token)
    {
      float c[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) c[j] = cum[lane * LD + warp + j * WARPS];
      scan::warp_cumsum(c);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        cum[lane * LD + warp + j * WARPS] = c[j];
        if (lane == SUB - 1) etot[warp + j * WARPS] = scan::exp_le0(c[j]);
      }
    }
    __syncthreads();
    // 3. the decays folded into r and k, four channels a thread at a time:
    //    r exp(cum_{t-1}) and k exp(total - cum); then the scores: warps 0-6
    //    the two diagonal blocks, exactly, warp 7 the block below them as
    //    one factored product
#pragma unroll
    for (int i = tid * 4; i < SUB * P; i += THREADS * 4) {
      const int t = i / P, p = i % P, at = t * LD + p;
      const float4 c = *reinterpret_cast<const float4*>(cum + at);
      const float4 tot =
          *reinterpret_cast<const float4*>(cum + (SUB - 1) * LD + p);
      const float4 prev =
          t ? *reinterpret_cast<const float4*>(cum + at - LD)
            : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 rv = *reinterpret_cast<const float4*>(r + at);
      const float4 kv = *reinterpret_cast<const float4*>(k + at);
      *reinterpret_cast<float4*>(rdec + at) = make_float4(
          rv.x * scan::exp_le0(prev.x), rv.y * scan::exp_le0(prev.y),
          rv.z * scan::exp_le0(prev.z), rv.w * scan::exp_le0(prev.w));
      *reinterpret_cast<float4*>(khat + at) = make_float4(
          kv.x * scan::exp_le0(tot.x - c.x), kv.y * scan::exp_le0(tot.y - c.y),
          kv.z * scan::exp_le0(tot.z - c.z), kv.w * scan::exp_le0(tot.w - c.w));
    }
    if (warp < WARPS - 1) {
      // items (pair, quarter of P): four lanes per pair, reduced by
      // shuffles; quarter q takes the channels 16j + 4q .. 16j + 4q + 3, so
      // that the four lanes of a pair read distinct banks
      constexpr int PAIRS = BLK * (BLK + 1) / 2, ITEMS = 2 * 4 * PAIRS;
      for (int i0 = warp * 32; i0 < ITEMS; i0 += (WARPS - 1) * 32) {
        const int item = i0 + lane, pair = item / 4, q0 = (item % 4) * 4;
        float acc[4] = {};
        int t = 0, s = 0;
        if (item < ITEMS) {
          scan::tri_index(pair % PAIRS, t, s);
          t += (pair / PAIRS) * BLK;
          s += (pair / PAIRS) * BLK;
          const float* rt = r + t * LD + q0;
          const float* ks = k + s * LD + q0;
          // four channels at a time, four independent sums
          if (s < t) {
            const float* ct = cum + (t - 1) * LD + q0;
            const float* cs = cum + s * LD + q0;
#pragma unroll
            for (int p = 0; p < P; p += 16) {
              const float4 a = *reinterpret_cast<const float4*>(rt + p);
              const float4 w = *reinterpret_cast<const float4*>(ks + p);
              const float4 x = *reinterpret_cast<const float4*>(ct + p);
              const float4 y = *reinterpret_cast<const float4*>(cs + p);
              acc[0] = fmaf(a.x * w.x, scan::exp_le0(x.x - y.x), acc[0]);
              acc[1] = fmaf(a.y * w.y, scan::exp_le0(x.y - y.y), acc[1]);
              acc[2] = fmaf(a.z * w.z, scan::exp_le0(x.z - y.z), acc[2]);
              acc[3] = fmaf(a.w * w.w, scan::exp_le0(x.w - y.w), acc[3]);
            }
          } else {
#pragma unroll
            for (int p = 0; p < P; p += 16) {
              const float4 a = *reinterpret_cast<const float4*>(rt + p);
              const float4 w = *reinterpret_cast<const float4*>(ks + p);
              const float4 x = *reinterpret_cast<const float4*>(u + q0 + p);
              acc[0] = fmaf(a.x * x.x, w.x, acc[0]);
              acc[1] = fmaf(a.y * x.y, w.y, acc[1]);
              acc[2] = fmaf(a.z * x.z, w.z, acc[2]);
              acc[3] = fmaf(a.w * x.w, w.w, acc[3]);
            }
          }
        }
        float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (item < ITEMS && lane % 4 == 0) {
          sc[t * LDS + s] = sum;
          if (s < t) sc[s * LDS + t] = 0.f;  // above the diagonal
        }
      }
    } else {
      const float* cref = cum + (BLK - 1) * LD;
      float acc[2][4];
      scan::zero(acc);
      scan::warp_gemm<2, P>(
          acc,
          [&](int i, int p) {
            return r[(BLK + i) * LD + p] *
                   scan::exp_le0(cum[(BLK - 1 + i) * LD + p] - cref[p]);
          },
          [&](int p, int s) {
            return k[s * LD + p] * scan::exp_le0(cref[p] - cum[s * LD + p]);
          });
      scan::for_acc(acc, [&](int i, int s, float x) {
        sc[(BLK + i) * LDS + s] = x;
      });
    }
    __syncthreads();
    // 4. y = scores v + (r exp(cum_{t-1})) S, written in the input dtype;
    //    the state update (k exp(total - cum))^T v into registers
    {
      // y: a 16 x 16 tile a warp
      const int m0 = (warp / 4) * 16, q0 = (warp % 4) * 16;
      auto scores = [&](int i, int s) { return sc[(m0 + i) * LDS + s]; };
      auto vals = [&](int s, int q) { return v[s * LD + q0 + q]; };
      float acc[2][4];
      scan::zero(acc);
      if (m0 == 0)
        scan::warp_gemm<2, BLK>(acc, scores, vals);
      else
        scan::warp_gemm<2, SUB>(acc, scores, vals);
      scan::warp_gemm<2, P>(
          acc, [&](int i, int p) { return rdec[(m0 + i) * LD + p]; },
          [&](int p, int q) { return st[p * LD + q0 + q]; });
      scan::for_acc(acc, [&](int i, int q, float x) {
        if (m0 + i < rows)
          Y[base + (t0 + m0 + i) * tok + q0 + q] = goma::from_float<T>(x);
      });
    }
    // the update: a 16 x 32 block of the state a warp
    const int p0 = (warp / 2) * 16, u0 = (warp % 2) * 32;
    float upd[4][4];
    scan::zero(upd);
    scan::warp_gemm<4, SUB>(
        upd, [&](int i, int s) { return khat[s * LD + p0 + i]; },
        [&](int s, int q) { return v[s * LD + u0 + q]; });
    scan::fence_async();  // this stage's bytes are next written by copies
    __syncthreads();
    // 5. S <- diag(exp(total)) S + k^T v; sub-chunk n + 2 into this stage
    if (tid == 0 && n + 2 < nsub) issue(n + 2);
    scan::for_acc(upd, [&](int i, int q, float x) {
      float& s = st[(p0 + i) * LD + u0 + q];
      s = etot[p0 + i] * s + x;
    });
  }
  __syncthreads();
  float* so = S_out + (static_cast<long>(b) * H + h) * P * P;
  for (int i = tid; i < P * P; i += THREADS) so[i] = st[(i / P) * LD + i % P];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, void* y, void* state, int B, int S, int H,
           void* stream) {
  CUtensorMap maps[OPERANDS];
  const void* src[OPERANDS] = {r, k, v, lw};
  for (int m = 0; m < OPERANDS; ++m)
    if (!scan::make_rows_map<T>(&maps[m], src[m], static_cast<long>(B) * S,
                                static_cast<long>(H) * P, ldT<T>(P)))
      return static_cast<int>(cudaErrorInvalidValue);
  return scan::launch<wkv6_kernel<T>, smem_bytes<T>()>(
      B * H, stream, maps[0], maps[1], maps[2], maps[3],
                      static_cast<const float*>(u), static_cast<T*>(y),
                      static_cast<float*>(state), S, H);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a CTA takes; dtype: 0 = float32, 1 =
// bfloat16.
int wkv6_smem_bytes(int dtype) {
  return static_cast<int>(dtype == 0 ? smem_bytes<float>()
                                     : smem_bytes<__nv_bfloat16>());
}

// CTAs that share one SM (the occupancy calculator), or -1.
int wkv6_ctas_per_sm(int dtype) {
  return dtype == 0
             ? scan::ctas_per_sm(wkv6_kernel<float>, smem_bytes<float>())
             : scan::ctas_per_sm(wkv6_kernel<__nv_bfloat16>,
                                 smem_bytes<__nv_bfloat16>());
}

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, lw and y alike; u and the
// state are float32).  The head size P must be 64 and S a multiple of the
// caller's chunk C (the kernel's own sub-chunks do not depend on C).
// Returns the cudaError_t of the launch; the caller raises if it is not 0.
int wkv6_launch(const void* r, const void* k, const void* v, const void* lw,
                const void* u, void* y, void* state, int B, int S, int H,
                int P_, int C, int dtype, void* stream) {
  if (P_ != P || C <= 0 || S % C)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(r, k, v, lw, u, y, state, B, S, H, stream);
  return launch<__nv_bfloat16>(r, k, v, lw, u, y, state, B, S, H, stream);
}

}  // extern "C"
