// B4: the Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_pallas` (src/repro/kernels/
// mamba2_ssd.py: _ssd_kernel).  Per (batch b, head h), with the scalar
// decay a = -exp(a_log[h]) and the step dt_t:
//     S_t = exp(dt_t a) S_{t-1} + dt_t x_t B_t^T,      y_t = S_t C_t
// without the D x skip term, which the caller adds.  xh and y are
// (B, S, H, P), dt (B, S, H), Bm and Cm (B, S, N), all in one dtype
// (fp32 or bf16); a_log (H,) and the final state (B, H, P, N) are fp32;
// S is a multiple of the chunk C (the caller pads).
//
// One CTA per (b, h) stream walks its chunks in order, with the P x N
// fp32 state in shared memory from one chunk to the next.  Per chunk:
//   1. load xh, dt, Bm, Cm into shared memory as fp32;
//   2. cum = cumsum(dt a) by one thread in token order (never increasing),
//      and xdt = xh . dt;
//   3. scores[t,s] = (C_t . B_s) exp(cum[t] - cum[s]) for s <= t, in
//      register tiles;
//   4. y = scores @ xdt + exp(cum[t]) (C_t @ S^T), written in the input
//      dtype;
//   5. S <- exp(total) S + (xdt . exp(total - cum))^T B.
// Every exponent is <= 0, as in the reference.
//
// Shared memory: the C x (P+1) input tile, the two C x (N+1) tiles of Bm
// and Cm, the C x (C+1) score tile, the P x (N+1) state and four vectors
// of C: 184,576 bytes at C = 128, P = N = 64.  The launcher opts the
// kernel in to that much dynamic shared memory (cudaFuncSetAttribute, at
// most 227 KB) rather than streaming the chunk in sub-blocks.
//
// What bounds it on the H100: at the zamba2-2.7b prefill shape (B 4,
// S 256, H 80, P 64, N 64, fp32, C 128) the operations.  Per chunk and head
// the y and state products take C^2 P / 2 + 2 C P N multiply-adds (about
// 1.6 M); C Bm^T is the same for every head of a batch row, so the bound
// counts it once: about 2.0 GFLOP in all, 0.030 ms at the 67 TFLOP/s fp32
// peak, against 48 MB of operands, output and state, 0.014 ms at
// 3.35 TB/s.  This first version recomputes C Bm^T in every head's CTA
// (H times the necessary work, a quarter of the kernel's multiply-adds)
// and runs on the CUDA cores in fp32 with 4 x 4 register tiles: no tensor
// cores, no TMA, B * H CTAs of 256 threads (three waves on 132 SMs at full
// width).  PERF.md has its time beside that bound.
#include "scan_tile.cuh"

namespace {

using scan::MT;
using scan::THREADS;

// Floats of dynamic shared memory for cp (padded) chunk rows, head size P
// and state size N.
long smem_floats(int cp, int P, int N) {
  return static_cast<long>(cp) * (P + 1) + 2L * cp * (N + 1) +
         static_cast<long>(cp) * (cp + 1) + static_cast<long>(P) * (N + 1) +
         4L * cp;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ X, const T* __restrict__ DT,
           const float* __restrict__ ALOG, const T* __restrict__ BM,
           const T* __restrict__ CM, T* __restrict__ Y,
           float* __restrict__ S_out, int S, int H, int P, int N, int C,
           int cp) {
  extern __shared__ float smem[];
  const int ldx = P + 1, ldn = N + 1, lds = cp + 1;
  float* x = smem;             // cp x ldx: xh, then xh . dt
  float* bm = x + cp * ldx;    // cp x ldn
  float* cm = bm + cp * ldn;   // cp x ldn
  float* sc = cm + cp * ldn;   // cp x lds: scores for s <= t
  float* st = sc + cp * lds;   // P x ldn: the state S[p][n]
  float* dt = st + P * ldn;    // cp
  float* cum = dt + cp;        // cp
  float* ecum = cum + cp;      // exp(cum)
  float* suf = ecum + cp;      // exp(total - cum)
  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a = -expf(ALOG[h]);
  const long xtok = static_cast<long>(H) * P;
  const long xbase = static_cast<long>(b) * S * xtok + static_cast<long>(h) * P;
  const long nbase = static_cast<long>(b) * S * N;
  const long dbase = static_cast<long>(b) * S * H + h;
  const int nt = cp / MT, pt = P / MT, mt = N / MT;
  for (int i = tid; i < P * ldn; i += THREADS) st[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();  // the previous chunk is done with every tile
    // 1. operands; rows C..cp-1 are zero: no input and no decay
    for (int i = tid; i < cp * P; i += THREADS) {
      const int t = i / P, p = i % P;
      x[t * ldx + p] =
          t < C ? goma::to_float(X[xbase + (c0 + t) * xtok + p]) : 0.f;
    }
    for (int i = tid; i < cp * N; i += THREADS) {
      const int t = i / N, n = i % N;
      const long g = nbase + static_cast<long>(c0 + t) * N + n;
      bm[t * ldn + n] = t < C ? goma::to_float(BM[g]) : 0.f;
      cm[t * ldn + n] = t < C ? goma::to_float(CM[g]) : 0.f;
    }
    for (int t = tid; t < cp; t += THREADS)
      dt[t] = t < C ? goma::to_float(DT[dbase + static_cast<long>(c0 + t) * H])
                    : 0.f;
    __syncthreads();
    // 2. cum in token order; xdt = xh . dt
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < cp; ++t) {
        acc += dt[t] * a;
        cum[t] = acc;
      }
    }
    for (int i = tid; i < cp * P; i += THREADS) {
      const int t = i / P, p = i % P;
      x[t * ldx + p] *= dt[t];
    }
    __syncthreads();
    for (int t = tid; t < cp; t += THREADS) {
      ecum[t] = expf(cum[t]);
      suf[t] = expf(cum[cp - 1] - cum[t]);
    }
    // 3. scores, one MT x MT tile of the lower triangle at a time
    for (int m = tid; m < nt * (nt + 1) / 2; m += THREADS) {
      int ti, si;
      scan::tri_index(m, ti, si);
      const int t0 = ti * MT, s0 = si * MT;
      float acc[MT][MT] = {};
      for (int n = 0; n < N; ++n) {
        float c[MT], w[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          c[i] = cm[(t0 + i) * ldn + n];
          w[i] = bm[(s0 + i) * ldn + n];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(c[i], w[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const int t = t0 + i, s = s0 + j;
          sc[t * lds + s] = s <= t ? acc[i][j] * expf(cum[t] - cum[s]) : 0.f;
        }
    }
    __syncthreads();
    // 4. y = scores @ xdt + exp(cum[t]) (C_t @ S^T)
    for (int m = tid; m < nt * pt; m += THREADS) {
      const int t0 = (m / pt) * MT, q0 = (m % pt) * MT;
      if (t0 >= C) continue;
      float acc[MT][MT] = {}, inter[MT][MT] = {};
      for (int s = 0; s < t0 + MT; ++s) {
        float c[MT], w[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          c[i] = sc[(t0 + i) * lds + s];
          w[i] = x[s * ldx + q0 + i];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(c[i], w[j], acc[i][j]);
      }
      for (int n = 0; n < N; ++n) {
        float c[MT], w[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          c[i] = cm[(t0 + i) * ldn + n];
          w[i] = st[(q0 + i) * ldn + n];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < MT; ++j)
            inter[i][j] = fmaf(c[i], w[j], inter[i][j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (t0 + i >= C) break;
        T* yrow = Y + xbase + (c0 + t0 + i) * xtok + q0;
#pragma unroll
        for (int j = 0; j < MT; ++j)
          yrow[j] = goma::from_float<T>(acc[i][j] +
                                        ecum[t0 + i] * inter[i][j]);
      }
    }
    __syncthreads();
    // 5. S <- exp(total) S + (xdt . exp(total - cum))^T B
    const float etotal = expf(cum[cp - 1]);
    for (int m = tid; m < pt * mt; m += THREADS) {
      const int p0 = (m / mt) * MT, n0 = (m % mt) * MT;
      float acc[MT][MT];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j)
          acc[i][j] = etotal * st[(p0 + i) * ldn + n0 + j];
      for (int s = 0; s < cp; ++s) {
        float c[MT], w[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          c[i] = x[s * ldx + p0 + i] * suf[s];
          w[i] = bm[s * ldn + n0 + i];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(c[i], w[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) st[(p0 + i) * ldn + n0 + j] = acc[i][j];
    }
  }
  __syncthreads();
  float* so = S_out + (static_cast<long>(b) * H + h) * P * N;
  for (int i = tid; i < P * N; i += THREADS)
    so[i] = st[(i / N) * ldn + i % N];
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_log, const void* bm,
           const void* cm, void* y, void* state, int B, int S, int H, int P,
           int N, int C, void* stream) {
  const int cp = scan::round_up(C, MT);
  return scan::launch(ssd_kernel<T>, B * H, smem_floats(cp, P, N) * 4,
                      stream, static_cast<const T*>(x),
                      static_cast<const T*>(dt),
                      static_cast<const float*>(a_log),
                      static_cast<const T*>(bm), static_cast<const T*>(cm),
                      static_cast<T*>(y), static_cast<float*>(state), S, H, P,
                      N, C, cp);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch with chunk C, head size P and
// state size N needs; the wrapper refuses shapes above a CTA's 227 KB.
int ssd_smem_bytes(int C, int P, int N) {
  return static_cast<int>(smem_floats(scan::round_up(C, MT), P, N) * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (xh, dt, Bm, Cm and y alike; a_log and
// the state are float32).  P and N must be multiples of 4 and S of C.
// Returns the cudaError_t of the launch; the caller raises if it is not 0.
int ssd_launch(const void* x, const void* dt, const void* a_log,
               const void* bm, const void* cm, void* y, void* state, int B,
               int S, int H, int P, int N, int C, int dtype, void* stream) {
  if (P % MT || N % MT || C <= 0 || S % C)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(x, dt, a_log, bm, cm, y, state, B, S, H, P, N, C,
                         stream);
  return launch<__nv_bfloat16>(x, dt, a_log, bm, cm, y, state, B, S, H, P, N,
                               C, stream);
}

}  // extern "C"
