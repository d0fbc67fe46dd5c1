// B3: the RWKV-6 WKV chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `wkv6_pallas` (src/repro/kernels/wkv6.py:
// _wkv6_kernel).  Per (batch b, head h), with per-channel log-decays
// lw_t < 0 and the bonus u:
//     S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
// r, k, v, lw and y are (B, S, H, P) in the input dtype (fp32 or bf16),
// u is (H, P) fp32, the final state (B, H, P, P) fp32; S is a multiple of
// the chunk C (the caller pads).
//
// One CTA per (b, h) stream walks its chunks in order: the loop takes the
// place of the TPU grid's sequential chunk axis, and the P x P fp32 state
// stays in shared memory from one chunk to the next.  Per chunk:
//   1. load r, k, v, lw into shared memory as fp32;
//   2. inclusive cumulative log-decays cum, one thread per channel in
//      token order, so cum never increases along t;
//   3. scores[t,s] = sum_p r[t,p] k[s,p] exp(cum[t-1,p] - cum[s,p]) for
//      s < t, formed on the fly in register tiles (the (C, C, P) decay
//      tensor is never materialised), and on the diagonal the bonus
//      sum_p r[t,p] u[p] k[t,p];
//   4. r <- r . exp(cum[t-1]) and k <- k . exp(total - cum), in place;
//      y = scores @ v + r @ S, written in the input dtype;
//   5. S <- diag(exp(total)) S + k^T v.
// Every exponent is <= 0, as in the reference.
//
// Shared memory: the four C x (P+1) operand tiles (the +1 staggers rows
// over the banks), the C x (C+1) score tile, the P x (P+1) state and u:
// 216,064 bytes at C = 128, P = 64.  That is above the 48 KB of static
// shared memory, so the launcher opts the kernel in to that much dynamic
// shared memory (cudaFuncSetAttribute, at most 227 KB) rather than
// streaming the chunk in sub-blocks; one CTA fits an SM.
//
// What bounds it on the H100: at the rwkv6-7b prefill shape (B 4, S 256,
// H 64, P 64, fp32, C 128) the operations, not the bytes.  The intra-chunk
// scores take C^2 P / 2 exps and multiply-adds per chunk and head (about
// 0.52 M each), the y and state products C^2 P / 2 + 2 C P^2
// multiply-adds more: about 3.0 GFLOP in all (an exp counted as one
// operation), 0.045 ms at the 67 TFLOP/s fp32 peak, against 88 MB of
// operands, output and state, 0.026 ms at 3.35 TB/s.  The design spends
// one full-precision expf per score element and keeps shared-memory reads
// to one per multiply-add through 4 x 4 register tiles.  This first
// version runs on the CUDA cores in fp32: no tensor cores, no TMA, and
// B * H CTAs of 256 threads (two waves on 132 SMs at full width).
// PERF.md has its time beside that bound.
#include "scan_tile.cuh"

namespace {

using scan::MT;
using scan::THREADS;

// Floats of dynamic shared memory for cp (padded) chunk rows, head size P.
long smem_floats(int cp, int P) {
  const long ld = P + 1;
  return 4 * cp * ld + static_cast<long>(cp) * (cp + 1) + P * ld + P;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const T* __restrict__ R, const T* __restrict__ K,
            const T* __restrict__ V, const T* __restrict__ LW,
            const float* __restrict__ U, T* __restrict__ Y,
            float* __restrict__ S_out, int S, int H, int P, int C, int cp) {
  extern __shared__ float smem[];
  const int ld = P + 1, lds = cp + 1;
  float* r = smem;            // cp x ld, then r . exp(cum[t-1])
  float* k = r + cp * ld;     // cp x ld, then k . exp(total - cum)
  float* v = k + cp * ld;     // cp x ld
  float* cum = v + cp * ld;   // cp x ld: log-decays, then their cumsum
  float* sc = cum + cp * ld;  // cp x lds: scores for s <= t
  float* st = sc + cp * lds;  // P x ld: the state S[p][q]
  float* u = st + P * ld;     // P
  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long tok = static_cast<long>(H) * P;  // stride between tokens
  const long base = static_cast<long>(b) * S * tok + static_cast<long>(h) * P;
  const int nt = cp / MT, pt = P / MT;
  for (int i = tid; i < P * ld; i += THREADS) st[i] = 0.f;
  for (int i = tid; i < P; i += THREADS) u[i] = U[h * P + i];

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();  // the previous chunk is done with every tile
    // 1. operands; rows C..cp-1 are zero: no input and no decay
    for (int i = tid; i < cp * P; i += THREADS) {
      const int t = i / P, p = i % P;
      float rv = 0.f, kv = 0.f, vv = 0.f, wv = 0.f;
      if (t < C) {
        const long g = base + (c0 + t) * tok + p;
        rv = goma::to_float(R[g]);
        kv = goma::to_float(K[g]);
        vv = goma::to_float(V[g]);
        wv = goma::to_float(LW[g]);
      }
      r[t * ld + p] = rv;
      k[t * ld + p] = kv;
      v[t * ld + p] = vv;
      cum[t * ld + p] = wv;
    }
    __syncthreads();
    // 2. inclusive cumsum over the chunk, in token order
    for (int p = tid; p < P; p += THREADS) {
      float a = 0.f;
      for (int t = 0; t < cp; ++t) {
        a += cum[t * ld + p];
        cum[t * ld + p] = a;
      }
    }
    __syncthreads();
    // 3. scores, one MT x MT tile of the lower triangle at a time
    for (int m = tid; m < nt * (nt + 1) / 2; m += THREADS) {
      int ti, si;
      scan::tri_index(m, ti, si);
      const int t0 = ti * MT, s0 = si * MT;
      float acc[MT][MT] = {};
      if (si < ti) {  // every s < every t: t0 >= MT, so t0 - 1 >= 0
        for (int p = 0; p < P; ++p) {
          float rt[MT], ct[MT], ks[MT], cs[MT];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            rt[i] = r[(t0 + i) * ld + p];
            ct[i] = cum[(t0 + i - 1) * ld + p];
            ks[i] = k[(s0 + i) * ld + p];
            cs[i] = cum[(s0 + i) * ld + p];
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < MT; ++j)
              acc[i][j] = fmaf(rt[i] * ks[j], expf(ct[i] - cs[j]),
                               acc[i][j]);
        }
      } else {  // a diagonal tile: decays below, the bonus on, 0 above
        for (int p = 0; p < P; ++p) {
          float rt[MT], ct[MT], ks[MT], cs[MT];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const int t = t0 + i;
            rt[i] = r[t * ld + p];
            ct[i] = t ? cum[(t - 1) * ld + p] : 0.f;
            ks[i] = k[t * ld + p];
            cs[i] = cum[t * ld + p];
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
#pragma unroll
            for (int j = 0; j < i; ++j)
              acc[i][j] = fmaf(rt[i] * ks[j], expf(ct[i] - cs[j]),
                               acc[i][j]);
            acc[i][i] = fmaf(rt[i] * u[p], ks[i], acc[i][i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j)
          sc[(t0 + i) * lds + s0 + j] = acc[i][j];
    }
    __syncthreads();
    // 4a. fold the decays into r and k
    for (int i = tid; i < cp * P; i += THREADS) {
      const int t = i / P, p = i % P;
      const float total = cum[(cp - 1) * ld + p];
      const float prev = t ? cum[(t - 1) * ld + p] : 0.f;
      r[t * ld + p] *= expf(prev);
      k[t * ld + p] *= expf(total - cum[t * ld + p]);
    }
    __syncthreads();
    // 4b. y = scores @ v + r @ S
    for (int m = tid; m < nt * pt; m += THREADS) {
      const int t0 = (m / pt) * MT, q0 = (m % pt) * MT;
      if (t0 >= C) continue;
      float acc[MT][MT] = {};
      for (int s = 0; s < t0 + MT; ++s) {
        float a[MT], w[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          a[i] = sc[(t0 + i) * lds + s];
          w[i] = v[s * ld + q0 + i];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      for (int p = 0; p < P; ++p) {
        float a[MT], w[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          a[i] = r[(t0 + i) * ld + p];
          w[i] = st[p * ld + q0 + i];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (t0 + i >= C) break;
        T* yrow = Y + base + (c0 + t0 + i) * tok + q0;
#pragma unroll
        for (int j = 0; j < MT; ++j) yrow[j] = goma::from_float<T>(acc[i][j]);
      }
    }
    __syncthreads();
    // 5. S <- diag(exp(total)) S + k^T v
    for (int m = tid; m < pt * pt; m += THREADS) {
      const int p0 = (m / pt) * MT, q0 = (m % pt) * MT;
      float acc[MT][MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float e = expf(cum[(cp - 1) * ld + p0 + i]);
#pragma unroll
        for (int j = 0; j < MT; ++j) acc[i][j] = e * st[(p0 + i) * ld + q0 + j];
      }
      for (int s = 0; s < cp; ++s) {
        float a[MT], w[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          a[i] = k[s * ld + p0 + i];
          w[i] = v[s * ld + q0 + i];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) st[(p0 + i) * ld + q0 + j] = acc[i][j];
    }
  }
  __syncthreads();
  float* so = S_out + (static_cast<long>(b) * H + h) * P * P;
  for (int i = tid; i < P * P; i += THREADS) so[i] = st[(i / P) * ld + i % P];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, void* y, void* state, int B, int S, int H, int P,
           int C, void* stream) {
  const int cp = scan::round_up(C, MT);
  return scan::launch(wkv6_kernel<T>, B * H, smem_floats(cp, P) * 4, stream,
                      static_cast<const T*>(r), static_cast<const T*>(k),
                      static_cast<const T*>(v), static_cast<const T*>(lw),
                      static_cast<const float*>(u), static_cast<T*>(y),
                      static_cast<float*>(state), S, H, P, C, cp);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch with chunk C and head size P
// needs; the wrapper refuses shapes above a CTA's 227 KB.
int wkv6_smem_bytes(int C, int P) {
  return static_cast<int>(smem_floats(scan::round_up(C, MT), P) * 4);
}

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, lw and y alike; u and the
// state are float32).  P must be a multiple of 4 and S of C.  Returns the
// cudaError_t of the launch; the caller raises if it is not 0.
int wkv6_launch(const void* r, const void* k, const void* v, const void* lw,
                const void* u, void* y, void* state, int B, int S, int H,
                int P, int C, int dtype, void* stream) {
  if (P % MT || C <= 0 || S % C) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(r, k, v, lw, u, y, state, B, S, H, P, C, stream);
  return launch<__nv_bfloat16>(r, k, v, lw, u, y, state, B, S, H, P, C,
                               stream);
}

}  // extern "C"
