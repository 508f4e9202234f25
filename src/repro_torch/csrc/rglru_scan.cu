// RG-LRU scan (RecurrentGemma's gated diagonal linear recurrence),
// hand-written for Hopper (sm_90a).
//
// Replaces: rglru_pallas in src/repro/kernels/rglru_scan.py (the Pallas TPU
// kernel, body _kernel).  Same function, per channel (b, w), with an fp32
// state h carried over the tokens:
//     h_t = exp(a_t) · h_{t−1} + sqrt(max(1 − exp(2·a_t), 1e-12)) · x_t
// x (B, T, W) in the model dtype (float32 or bfloat16), a_log (B, T, W) in
// float32 (every a_t ≤ 0, so every decay is exp of a non-positive number),
// state (B, W) float32; returns h (B, T, W) in x's dtype and the final state
// in float32.  The TPU kernel pads T to a multiple of its chunk with the
// identity step x = 0, a_log = 0; this kernel runs over the T valid tokens.
//
// Numerics, kept equal to the plain version (rglru_scan.py) operation for
// operation: the TPU kernel's expression 1 − exp(2a) clamped at 1e-12 (not
// −expm1(2a), which would not clamp where a lies within ~1e-6 of 0), with
// exp(2a) correctly rounded to fp32 (taken in fp64 and rounded once: in
// that band one unit in the last place of exp moves the gate by ~1e-4
// relative, and fp32 exp implementations differ by that unit); the update
// as a rounded product plus a rounded sum, never contracted into an FMA.
// No --use_fast_math.  chip_smoke.py holds the kernel to the plain version
// (2e-5 fp32, 2e-2 bf16, scaled by 1 + |h|) and, in fp32, to the
// token-by-token oracle ref.rglru_ref at 1e-5.
//
// What bounds it on the H100: memory.  Each token and channel reads x (2 or
// 4 bytes) and a_log (4 bytes) and writes h (2 or 4 bytes) for 8 operations;
// at RecurrentGemma-9B's prefill (B = 4, T = 3072, W = 4096, bf16) that is
// ~403 MB, ~0.12 ms at 3.35 TB/s.  At decode (T = 1) it moves 0.26 MB and is
// bound by the launch.
//
// What the design does about it: one thread per channel walks the tokens
// in order (the TPU grid's sequential chunk axis becomes the thread's loop),
// adjacent threads on adjacent channels so every warp load is one
// contiguous run.  A thread keeps U tokens' loads in flight while it steps
// through the U before them (two register buffers, used in turn), so the
// walk pays a memory latency per U tokens, not per token.
#include "common.cuh"

namespace {

constexpr int NT = 128;  // threads (channels) per block
constexpr int U = 16;    // tokens a thread has in flight

template <typename T>
__device__ __forceinline__ void load_tokens(T (&xs)[U], float (&as)[U], const T* __restrict__ x,
                                            const float* __restrict__ a_log, size_t base,
                                            int t0, int T_len, int W) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    if (t < T_len) {
      xs[u] = x[base + (size_t)t * W];
      as[u] = a_log[base + (size_t)t * W];
    } else {
      xs[u] = from_float<T>(0.f);
      as[u] = 0.f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void step_tokens(float& h, const T (&xs)[U], const float (&as)[U],
                                            T* __restrict__ out, size_t base, int t0,
                                            int T_len, int W) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    if (t < T_len) {
      const float al = as[u];
      const float a = expf(al);
      const float e2 = (float)exp(2.0 * (double)al);  // correctly rounded exp(2a)
      const float gated = __fmul_rn(sqrtf(fmaxf(1.f - e2, 1e-12f)), to_float(xs[u]));
      h = __fadd_rn(__fmul_rn(a, h), gated);
      out[base + (size_t)t * W] = from_float<T>(h);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_kernel(const T* __restrict__ x, const float* __restrict__ a_log,
             const float* __restrict__ h0, T* __restrict__ out, float* __restrict__ hT,
             int T_len, int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const size_t base = (size_t)b * T_len * W + w;
  float h = h0[(size_t)b * W + w];
  T xa[U], xb[U];
  float aa[U], ab[U];
  load_tokens(xa, aa, x, a_log, base, 0, T_len, W);
  for (int t0 = 0; t0 < T_len; t0 += 2 * U) {
    if (t0 + U < T_len) load_tokens(xb, ab, x, a_log, base, t0 + U, T_len, W);
    step_tokens(h, xa, aa, out, base, t0, T_len, W);
    if (t0 + U >= T_len) break;
    if (t0 + 2 * U < T_len) load_tokens(xa, aa, x, a_log, base, t0 + 2 * U, T_len, W);
    step_tokens(h, xb, ab, out, base, t0 + U, T_len, W);
  }
  hT[(size_t)b * W + w] = h;
}

template <typename T>
int launch(const void* x, const float* a_log, const float* h0, void* out, float* hT, int B,
           int T_len, int W, cudaStream_t stream) {
  const dim3 grid((W + NT - 1) / NT, B);
  rglru_kernel<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(x), a_log, h0,
                                           static_cast<T*>(out), hT, T_len, W);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, T, W) of dtype (0 float32, 1 bfloat16); a_log: (B, T, W) float32;
// state: (B, W) float32; out: (B, T, W) of dtype; h_out: (B, W) float32.
// All contiguous.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int repro_rglru_scan(const void* x, const void* a_log, const void* state, void* out,
                                void* h_out, int B, int T_len, int W, int dtype,
                                void* stream) {
  if (B <= 0 || T_len <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const float* al = static_cast<const float*>(a_log);
  const float* h0 = static_cast<const float*>(state);
  float* hT = static_cast<float*>(h_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(x, al, h0, out, hT, B, T_len, W, st);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, al, h0, out, hT, B, T_len, W, st);
  return (int)cudaErrorInvalidValue;
}
