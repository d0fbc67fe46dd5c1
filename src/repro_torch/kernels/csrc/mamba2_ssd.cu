// B4: the Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_pallas` (src/repro/kernels/
// mamba2_ssd.py: _ssd_kernel).  Per (batch b, head h), with the scalar
// decay a = -exp(a_log[h]) and the step dt_t:
//     S_t = exp(dt_t a) S_{t-1} + dt_t x_t B_t^T,      y_t = S_t C_t
// without the D x skip term, which the caller adds.  xh and y are
// (B, S, H, P), dt (B, S, H), Bm and Cm (B, S, N), all in one dtype
// (fp32 or bf16); a_log (H,) and the final state (B, H, P, N) are fp32.
// P and N are each 16 or 64 (zamba2-2.7b's 64 x 64, its smoke config's
// 16 x 16).
//
// What bounds it on the H100: at the zamba2-2.7b prefill shape (B 4,
// S 256, H 80, P 64, N 64, fp32) the bytes: 48 MB of operands, output and
// state, 0.014 ms at 3.35 TB/s.  Its products, 1.6 GFLOP, take 0.0032 ms
// at the 495 TFLOP/s TF32 tensor-core rate (chip_smoke.py, ssd_work).
// Products on the CUDA cores, C Bm^T recomputed by every head (a quarter
// of the multiply-adds, H times over) and one CTA per SM would keep it far
// above that bound.  PERF.md has its time and phase split beside the
// bound.
//
// The design (scan_tile.cuh has the shared pieces):
// - C Bm^T once per (batch, sub-chunk of 32 tokens): a prologue kernel,
//   `ssd_cb_kernel`, writes it, with that sub-chunk's Bm and Cm rows in
//   fp32 at the scan's row pitch, to a scratch that the wrapper allocates
//   (672 KB at the served shape: it stays in L2).
// - One CTA of 256 threads per (b, h) walks the sequence in sub-chunks of
//   32 tokens with the P x N fp32 state in shared memory; 73 KB of shared
//   memory at P = N = 64 fp32, so three CTAs share an SM: the 320 streams
//   of the served shape are resident at once on 132 SMs.
// - Sub-chunk n + 1's xh rows (a TMA box) and its Bm and Cm rows (one bulk
//   copy of the prologue's record) are in flight on an mbarrier ring of
//   two stages, and its dt and C Bm^T in registers, while sub-chunk n
//   computes.
// - cum = cumsum(dt a) is a warp scan (a lane per token); the decay mask
//   exp(cum_t - cum_s) stays per head: 528 exps a sub-chunk.
// - y = scores (xh dt) + exp(cum) (C S^T) and the state update
//   (xh dt exp(total - cum))^T Bm run on the tensor cores by 3xTF32, at
//   fp32 accuracy.
// Every exponent is <= 0, as in the reference.
#include "scan_tile.cuh"

namespace {

using scan::SUB;
using scan::THREADS;
using scan::WARPS;
using scan::ld32;
using scan::ldT;
constexpr int VECS = 4;  // dt, exp(cum), dt exp(total - cum), exp(total)
constexpr int LDS = ld32(SUB);

// The prologue's record of one (batch, sub-chunk), in fp32: C Bm^T
// (SUB x SUB), then Bm and Cm (SUB x ld32(N) each, zero rows past S), the
// scan's stage layout, so that one bulk copy brings both.
__host__ __device__ constexpr int record_floats(int N) {
  return SUB * SUB + 2 * SUB * ld32(N);
}

template <typename T, int P, int N> constexpr long smem_bytes() {
  return scan::SLACK + scan::BARS +
         2 * (SUB * ldT<T>(P) * static_cast<long>(sizeof(T)) +
              2L * SUB * ld32(N) * 4) +
         (scan::kF32<T> ? 0 : SUB * ld32(P) * 4L) +
         4L * (P * ld32(N) + SUB * LDS + VECS * SUB);
}

// The prologue, one CTA per (batch, sub-chunk): Bm and Cm as fp32 rows,
// and cb[t][s] = sum_n C[t][n] Bm[s][n], one 16 x 8 tile per warp.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const T* __restrict__ BM, const T* __restrict__ CM,
              float* __restrict__ REC, int S) {
  constexpr int LDN = ld32(N);
  const int nsub = (S + SUB - 1) / SUB;
  const int b = blockIdx.x / nsub, n = blockIdx.x % nsub;
  const int t0 = n * SUB, rows = min(SUB, S - t0);
  float* rec = REC + static_cast<long>(blockIdx.x) * record_floats(N);
  float* bm = rec + SUB * SUB;
  float* cm = bm + SUB * LDN;
  const long g0 = (static_cast<long>(b) * S + t0) * N;
  for (int i = threadIdx.x; i < SUB * LDN; i += THREADS) {
    const int t = i / LDN, c = i % LDN;
    const bool in = t < rows && c < N;
    bm[i] = in ? goma::to_float(BM[g0 + t * N + c]) : 0.f;
    cm[i] = in ? goma::to_float(CM[g0 + t * N + c]) : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, m0 = (warp / 4) * 16, s0 = (warp % 4) * 8;
  float acc[1][4];
  scan::zero(acc);
  scan::warp_gemm<1, N>(
      acc, [&](int i, int c) { return cm[(m0 + i) * LDN + c]; },
      [&](int c, int s) { return bm[(s0 + s) * LDN + c]; });
  scan::for_acc(acc, [&](int i, int s, float x) {
    rec[(m0 + i) * SUB + s0 + s] = x;
  });
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS, 3)
ssd_scan_kernel(const __grid_constant__ CUtensorMap mx,
                const T* __restrict__ DT, const float* __restrict__ ALOG,
                const float* __restrict__ REC, T* __restrict__ Y,
                float* __restrict__ S_out, int S, int H) {
  constexpr int LDXT = ldT<T>(P), LDX = ld32(P), LDN = ld32(N);
  constexpr int REC_FLOATS = record_floats(N), BC_FLOATS = 2 * SUB * LDN;
  // a stage: the xh rows (T), then the record's Bm and Cm rows (fp32)
  constexpr int X_BYTES = SUB * LDXT * static_cast<int>(sizeof(T));
  constexpr int STAGE_BYTES = X_BYTES + BC_FLOATS * 4;
  // y: 16 x 16 tiles, one a warp; the update: 16 x UN blocks of the
  // state, at most one a warp
  constexpr int UN = N < 32 ? N : 32;
  static_assert(2 * (P / 16) <= WARPS && (P / 16) * (N / UN) <= WARPS,
                "one tile a warp");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = scan::aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint8_t* stages = smem + scan::BARS;
  float* work = reinterpret_cast<float*>(stages + 2 * STAGE_BYTES);
  float* st = work + (scan::kF32<T> ? 0 : SUB * LDX);  // P x LDN
  float* sc = st + P * LDN;     // SUB x LDS: decayed scores for s <= t
  float* dts = sc + SUB * LDS;  // dt
  float* ecum = dts + SUB;      // exp(cum)
  float* wsuf = ecum + SUB;     // dt exp(total - cum)
  float* etot = wsuf + SUB;     // exp(total), in [0]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a = -expf(ALOG[h]);
  const long xtok = static_cast<long>(H) * P;
  const long xbase = static_cast<long>(b) * S * xtok + static_cast<long>(h) * P;
  const long dbase = static_cast<long>(b) * S * H + h;
  const int nsub = (S + SUB - 1) / SUB;
  const float* recs = REC + static_cast<long>(b) * nsub * REC_FLOATS;

  auto issue = [&](int n) {  // thread 0: sub-chunk n into stage n % 2
    uint8_t* stg = stages + (n & 1) * STAGE_BYTES;
    uint64_t* bar = &full[n & 1];
    goma::wg::mbar_expect_tx(bar, STAGE_BYTES);
    goma::wg::tma_load(stg, &mx, bar, h * P, b * S + n * SUB);
    scan::bulk_copy(stg + X_BYTES,
                    recs + static_cast<long>(n) * REC_FLOATS + SUB * SUB,
                    BC_FLOATS * 4, bar);
  };
  // sub-chunk n's dt (a lane per token) and C Bm^T (four values a thread:
  // row warp + 8j, column lane), read ahead into registers
  auto read_dt = [&](int n) {
    const int t = n * SUB + lane;
    return n < nsub && t < S
               ? goma::to_float(DT[dbase + static_cast<long>(t) * H])
               : 0.f;
  };
  auto read_cb = [&](int n, float (&v)[SUB * SUB / THREADS]) {
#pragma unroll
    for (int j = 0; j < SUB * SUB / THREADS; ++j)
      v[j] = n < nsub ? recs[static_cast<long>(n) * REC_FLOATS + tid +
                             j * THREADS]
                      : 0.f;
  };

  if (tid == 0) scan::init_ring(full);
  for (int i = tid; i < P * LDN; i += THREADS) st[i] = 0.f;
  __syncthreads();
  if (tid == 0) {
    issue(0);
    if (nsub > 1) issue(1);
  }
  float dt_next = read_dt(0);
  float cb_next[SUB * SUB / THREADS];
  read_cb(0, cb_next);

  for (int n = 0; n < nsub; ++n) {
    const int t0 = n * SUB, rows = min(SUB, S - t0);
    uint8_t* stg = stages + (n & 1) * STAGE_BYTES;
    // 1. cum = cumsum(dt a) by a warp scan in every warp, and from it the
    //    scores[t][s] = (C Bm^T)[t][s] exp(cum_t - cum_s) for s <= t, else
    //    0; the sub-chunk's rows as fp32 (rows past S zero)
    {
      const float dt = dt_next;
      dt_next = read_dt(n + 1);
      float c[1] = {dt * a};
      scan::warp_cumsum(c);
      const float total = __shfl_sync(0xffffffffu, c[0], SUB - 1);
      if (warp == 0) {
        dts[lane] = dt;
        ecum[lane] = scan::exp_le0(c[0]);
        wsuf[lane] = dt * scan::exp_le0(total - c[0]);
        if (lane == 0) etot[0] = scan::exp_le0(total);
      }
#pragma unroll
      for (int j = 0; j < SUB * SUB / THREADS; ++j) {
        const int t = warp + j * WARPS;
        const float ct = __shfl_sync(0xffffffffu, c[0], t);
        sc[t * LDS + lane] =
            lane <= t ? cb_next[j] * scan::exp_le0(ct - c[0]) : 0.f;
      }
      read_cb(n + 1, cb_next);
    }
    goma::wg::mbar_wait(&full[n & 1], (n >> 1) & 1);
    float* x = scan::as_work(reinterpret_cast<T*>(stg), work, rows, P);
    const float* bm = reinterpret_cast<const float*>(stg + X_BYTES);
    const float* cm = bm + SUB * LDN;
    __syncthreads();
    // 2. y = scores (xh dt) + exp(cum) (C S^T), written in the input
    //    dtype; the state update (xh dt exp(total - cum))^T Bm into
    //    registers
    if (warp < 2 * (P / 16)) {
      const int m0 = (warp / (P / 16)) * 16, p0 = (warp % (P / 16)) * 16;
      auto scores = [&](int i, int s) { return sc[(m0 + i) * LDS + s]; };
      auto xdt = [&](int s, int p) { return x[s * LDX + p0 + p] * dts[s]; };
      float intra[2][4], inter[2][4];
      scan::zero(intra);
      scan::zero(inter);
      if (m0 == 0)
        scan::warp_gemm<2, 16>(intra, scores, xdt);
      else
        scan::warp_gemm<2, SUB>(intra, scores, xdt);
      scan::warp_gemm<2, N>(
          inter, [&](int i, int c) { return cm[(m0 + i) * LDN + c]; },
          [&](int c, int p) { return st[(p0 + p) * LDN + c]; });
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          intra[j][e] += ecum[m0 + (e < 2 ? 0 : 8) + (lane >> 2)] * inter[j][e];
      scan::for_acc(intra, [&](int i, int p, float v) {
        if (m0 + i < rows)
          Y[xbase + (t0 + m0 + i) * xtok + p0 + p] = goma::from_float<T>(v);
      });
    }
    const bool updates = warp < (P / 16) * (N / UN);
    const int p0 = (warp / (N / UN)) * 16, c0 = (warp % (N / UN)) * UN;
    float upd[UN / 8][4];
    scan::zero(upd);
    if (updates)
      scan::warp_gemm<UN / 8, SUB>(
          upd, [&](int i, int s) { return x[s * LDX + p0 + i] * wsuf[s]; },
          [&](int s, int c) { return bm[s * LDN + c0 + c]; });
    const float e = etot[0];  // warp 0 rewrites it in the next phase 1
    scan::fence_async();  // this stage's bytes are next written by copies
    __syncthreads();
    // 3. S <- exp(total) S + update; sub-chunk n + 2 into this stage
    if (tid == 0 && n + 2 < nsub) issue(n + 2);
    if (updates)
      scan::for_acc(upd, [&](int i, int c, float v) {
        float& s = st[(p0 + i) * LDN + c0 + c];
        s = e * s + v;
      });
  }
  __syncthreads();
  float* so = S_out + (static_cast<long>(b) * H + h) * P * N;
  for (int i = tid; i < P * N; i += THREADS)
    so[i] = st[(i / N) * LDN + i % N];
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* a_log, const void* bm,
           const void* cm, void* y, void* state, void* rec, int B, int S,
           int H, void* stream) {
  const int nsub = (S + SUB - 1) / SUB;
  int err = scan::launch<ssd_cb_kernel<T, N>, 0>(
      B * nsub, stream, static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<float*>(rec), S);
  if (err) return err;
  CUtensorMap mx;
  if (!scan::make_rows_map<T>(&mx, x, static_cast<long>(B) * S,
                              static_cast<long>(H) * P, ldT<T>(P)))
    return static_cast<int>(cudaErrorInvalidValue);
  return scan::launch<ssd_scan_kernel<T, P, N>, smem_bytes<T, P, N>()>(
      B * H, stream, mx, static_cast<const T*>(dt),
                      static_cast<const float*>(a_log),
                      static_cast<const float*>(rec), static_cast<T*>(y),
                      static_cast<float*>(state), S, H);
}

// The (P, N) the kernel is built for: zamba2-2.7b's 64 x 64 and the
// smoke configs' 16 x 16, and the mixed pairs.
template <typename T, typename F> int dispatch(int P, int N, F f) {
  if (P == 64 && N == 64) return f(launch<T, 64, 64>, smem_bytes<T, 64, 64>(),
                                   ssd_scan_kernel<T, 64, 64>);
  if (P == 64 && N == 16) return f(launch<T, 64, 16>, smem_bytes<T, 64, 16>(),
                                   ssd_scan_kernel<T, 64, 16>);
  if (P == 16 && N == 64) return f(launch<T, 16, 64>, smem_bytes<T, 16, 64>(),
                                   ssd_scan_kernel<T, 16, 64>);
  if (P == 16 && N == 16) return f(launch<T, 16, 16>, smem_bytes<T, 16, 16>(),
                                   ssd_scan_kernel<T, 16, 16>);
  return -1;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a scan CTA takes at head size P and state
// size N (each 16 or 64); dtype: 0 = float32, 1 = bfloat16.  -1 for a
// shape the kernel is not built for.
int ssd_smem_bytes(int P, int N, int dtype) {
  auto bytes = [](auto, long smem, auto) { return static_cast<int>(smem); };
  return dtype == 0 ? dispatch<float>(P, N, bytes)
                    : dispatch<__nv_bfloat16>(P, N, bytes);
}

// CTAs of the scan kernel that share one SM (the occupancy calculator), or
// -1.
int ssd_ctas_per_sm(int P, int N, int dtype) {
  auto ctas = [](auto, long smem, auto kernel) {
    return scan::ctas_per_sm(kernel, smem);
  };
  return dtype == 0 ? dispatch<float>(P, N, ctas)
                    : dispatch<__nv_bfloat16>(P, N, ctas);
}

// Floats of the prologue's scratch (C Bm^T and the fp32 Bm and Cm rows of
// every (batch, sub-chunk)) for batch B, sequence S and state size N.
int ssd_scratch_floats(int B, int S, int N) {
  return B * ((S + SUB - 1) / SUB) * record_floats(N);
}

// dtype: 0 = float32, 1 = bfloat16 (xh, dt, Bm, Cm and y alike; a_log and
// the state are float32); rec is the fp32 scratch of ssd_scratch_floats.
// P and N must each be 16 or 64, and S a multiple of the caller's chunk C
// (the kernel's own sub-chunks do not depend on C).  Launches the C Bm^T
// prologue, then the scan; returns the first non-zero cudaError_t of the
// two launches.
int ssd_launch(const void* x, const void* dt, const void* a_log,
               const void* bm, const void* cm, void* y, void* state,
               void* rec, int B, int S, int H, int P, int N, int C, int dtype,
               void* stream) {
  if (C <= 0 || S % C) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto launcher, long, auto) {
    return launcher(x, dt, a_log, bm, cm, y, state, rec, B, S, H, stream);
  };
  const int err = dtype == 0 ? dispatch<float>(P, N, run)
                             : dispatch<__nv_bfloat16>(P, N, run);
  return err == -1 ? static_cast<int>(cudaErrorInvalidValue) : err;
}

}  // extern "C"
