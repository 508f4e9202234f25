// Backward of the RG-LRU scan, hand-written for Hopper (sm_90a).
//
// Replaces: no Pallas kernel.  The JAX package trains through jax.grad of
// _rglru_jnp (src/repro/kernels/ops.py:329), the associative-scan version
// of rglru_pallas (src/repro/kernels/rglru_scan.py:69); the port's forward
// is a CUDA kernel (rglru_scan.cu) that autograd cannot see through.  Per
// channel (b, w), with the forward h_t = a_t·h_{t−1} + g_t·x_t, a_t =
// exp(a_log_t), g_t = sqrt(max(1 − exp(2·a_log_t), 1e-12)), and δ_t the
// gradient reaching h_t from the output and from h_{t+1}:
//     δ_t = ∂h_t + a_{t+1}·δ_{t+1}          (δ past the last token: ∂h_T)
//     ∂x_t = g_t·δ_t
//     ∂a_log_t = δ_t·(a_t·h_{t−1}) + (δ_t·x_t)·∂g_t,  ∂g = −exp(2a)/g, 0 where clamped
//     ∂h_0 = a_0·δ_0 (the given state's gradient)
// x and ∂h (B, T, W) in the model dtype, a_log (B, T, W) and the states
// (B, W) float32; ∂x in the model dtype, ∂a_log and ∂h_0 float32.
//
// Numerics as the forward kernel's: the gates by its own expressions
// (exp(2a) correctly rounded, in fp64, where 2a > −0.5; a·a below), every
// product and sum rounded apart in the plain version's order, never
// contracted into an FMA, and h_{t−1} the fp32 state the forward's own
// steps give (rebuilt here, never the rounded output).  The clamp holds
// exactly where 1 − exp(2a) is 0 in fp32 (its other values are multiples
// of 2^-24), and there ∂g is 0, as jnp.maximum's and clamp_min's
// gradients take it.
//
// What bounds it on the H100: memory.  Each token and channel reads x, ∂h
// (2 or 4 bytes each) and a_log (4) and writes ∂x (2 or 4) and ∂a_log (4);
// at RecurrentGemma-9B's training shape (B = 2, T = 3072, W = 4096, bf16)
// ~360 MB, 0.11 ms at 3.35 TB/s.  This design is a simple serial one: one
// thread a channel, adjacent threads on adjacent channels (every load and
// store of a warp one contiguous run), two sweeps over the tokens:
//  A. forward, from h_0: each token's incoming state is written to an fp32
//     scratch (B, T, W), the state stepped as the forward kernel steps it;
//  B. reverse, from ∂h_T: δ, ∂x, ∂a_log and the carry a_t·δ_t.
// Each sweep issues a group of C tokens' loads before it uses any.  It
// runs B·W threads (8,192 at the training shape), so its time is the
// tokens' serial latency, not the bytes.
#include "common.cuh"

namespace {

constexpr int NT = 128;               // threads (channels) a block
constexpr int C = 16;                 // tokens whose loads are issued together
constexpr float FP64_BAND = -0.5f;    // 2a above this: exp(2a) in fp64, as the forward

struct Gate {
  float a, g, dg;                     // exp(a), the input gate, ∂g/∂a
};

__device__ __forceinline__ Gate gate(float al) {
  const float a = expf(al);
  const float e2 = 2.f * al > FP64_BAND ? (float)exp(2.0 * (double)al)   // correctly rounded
                                        : __fmul_rn(a, a);
  const float one_m = __fsub_rn(1.f, e2);
  const float g = sqrtf(fmaxf(one_m, 1e-12f));
  return {a, g, one_m >= 1e-12f ? -__fdiv_rn(e2, g) : 0.f};
}

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_bwd_kernel(const T* __restrict__ x, const float* __restrict__ a_log,
                 const float* __restrict__ h0, const T* __restrict__ dh,
                 const float* __restrict__ dhT, T* __restrict__ dx, float* __restrict__ da,
                 float* __restrict__ dh0, float* __restrict__ h_in, int B, int T_len, int W) {
  const int n_wb = (W + NT - 1) / NT;
  const int b = blockIdx.x / n_wb, w = (blockIdx.x % n_wb) * NT + threadIdx.x;
  if (w >= W) return;
  const size_t bw = (size_t)b * W + w;
  const size_t base = (size_t)b * T_len * W + w;

  // A. forward: every token's incoming state
  float h = h0 == nullptr ? 0.f : h0[bw];
  for (int t0 = 0; t0 < T_len; t0 += C) {
    const int n = min(C, T_len - t0);
    T xs[C];
    float as[C];
#pragma unroll
    for (int u = 0; u < C; ++u) {
      if (u == n) break;
      xs[u] = x[base + (size_t)(t0 + u) * W];
      as[u] = a_log[base + (size_t)(t0 + u) * W];
    }
#pragma unroll
    for (int u = 0; u < C; ++u) {
      if (u == n) break;
      const Gate gt = gate(as[u]);
      h_in[base + (size_t)(t0 + u) * W] = h;
      h = __fadd_rn(__fmul_rn(gt.a, h), __fmul_rn(gt.g, to_float(xs[u])));
    }
  }

  // B. reverse
  float carry = dhT == nullptr ? 0.f : dhT[bw];
  const int n_groups = (T_len + C - 1) / C;
  for (int grp = n_groups - 1; grp >= 0; --grp) {
    const int t0 = grp * C, n = min(C, T_len - t0);
    T xs[C], ds[C];
    float as[C], hs[C];
#pragma unroll
    for (int u = 0; u < C; ++u) {
      if (u == n) break;
      const size_t o = base + (size_t)(t0 + u) * W;
      xs[u] = x[o];
      ds[u] = dh[o];
      as[u] = a_log[o];
      hs[u] = h_in[o];
    }
#pragma unroll
    for (int u = C - 1; u >= 0; --u) {
      if (u >= n) continue;
      const Gate gt = gate(as[u]);
      const float xf = to_float(xs[u]);
      const float d = __fadd_rn(to_float(ds[u]), carry);
      const size_t o = base + (size_t)(t0 + u) * W;
      dx[o] = from_float<T>(__fmul_rn(gt.g, d));
      da[o] = __fadd_rn(__fmul_rn(d, __fmul_rn(gt.a, hs[u])),
                        __fmul_rn(__fmul_rn(d, xf), gt.dg));
      carry = __fmul_rn(gt.a, d);
    }
  }
  dh0[bw] = carry;
}

template <typename T>
int launch(const void* x, const float* a_log, const float* h0, const void* dh, const float* dhT,
           void* dx, float* da, float* dh0, float* h_in, int B, int T_len, int W,
           cudaStream_t stream) {
  const unsigned grid = (unsigned)B * ((W + NT - 1) / NT);
  rglru_bwd_kernel<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(x), a_log, h0,
                                               static_cast<const T*>(dh), dhT,
                                               static_cast<T*>(dx), da, dh0, h_in, B, T_len, W);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dh, dx: (B, T, W) of dtype (0 float32, 1 bfloat16); a_log, da: (B, T,
// W) float32; state, d_state, d_state0: (B, W) float32 (state and d_state
// may be null: zeros); h_in: (B, T, W) float32 scratch.  All contiguous.
// One launch on `stream`; returns cudaGetLastError() after it (0 on success).
extern "C" int repro_rglru_scan_bwd(const void* x, const void* a_log, const void* state,
                                    const void* dh, const void* d_state, void* dx, void* da,
                                    void* d_state0, void* h_in, int B, int T_len, int W,
                                    int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || W <= 0 || h_in == nullptr) return (int)cudaErrorInvalidValue;
  const float* al = static_cast<const float*>(a_log);
  const float* h0 = static_cast<const float*>(state);
  const float* dhT = static_cast<const float*>(d_state);
  float* daf = static_cast<float*>(da);
  float* d0 = static_cast<float*>(d_state0);
  float* hi = static_cast<float*>(h_in);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(x, al, h0, dh, dhT, dx, daf, d0, hi, B, T_len, W, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, al, h0, dh, dhT, dx, daf, d0, hi, B, T_len, W, st);
  return (int)cudaErrorInvalidValue;
}
