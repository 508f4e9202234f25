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
// ~360 MB, 0.11 ms at 3.35 TB/s.  The design splits the tokens over blocks
// as the forward does (rglru_scan.cu), so that enough loads are in flight
// to fill the card: a block is (row b, NT = 128 channels, a chunk of C = 16
// tokens), one thread a channel, adjacent threads on adjacent channels;
// 12,288 blocks at the training shape.  Two launches, each a chain of its
// chunk blocks in ticket order through tagged 64-bit words
// (rglru_chain.cuh), the scratch left zero:
//  1. rglru_bwd_states_kernel, the forward's chain (chunk-major tickets):
//     each chunk but the last walks its tokens from the state its
//     predecessor's walk ended in and writes where it ends, the state
//     entering the next chunk, to an fp32 (B, n_chunks, W) scratch (6.3 MB
//     at the training shape).
//  2. rglru_bwd_kernel, the reverse chain (reverse chunk-major tickets):
//     each thread loads its chunk, takes its gates (a, g and ∂g, kept in
//     registers), rebuilds h_{t−1} across it by the forward's own walk from
//     the saved start, waits for δ's carry from chunk c + 1, walks δ back
//     (δ = ∂h + carry, carry = a·δ: two operations a token on the chain),
//     publishes the carry for chunk c − 1 (∂h_0 for the first chunk), and
//     only then takes ∂x and ∂a_log from δ.
//  In both, everything that does not need the other block comes before the
//  wait: a gate takes an exp, an fp64 exp in the band, a square root and a
//  division, none of which belongs on the chain, and each is taken once (at
//  path o's shape, taking the gates again for the outputs doubled the
//  reverse chain's time).
// The same steps in the same order as the token-by-token sweeps, so the
// result is bit for bit that of a serial walk.
#include "common.cuh"
#include "rglru_chain.cuh"

namespace {

// Launch 1: the forward's chain over chunks 0 .. n_launched − 1 (all but
// the last), chunk-major tickets.  h_start[(b, c + 1, w)] = the state
// leaving chunk c.  Words: one a (chunk c < n_launched − 1, row, channel).
template <typename T>
__global__ void __launch_bounds__(NT, 8)
rglru_bwd_states_kernel(const T* __restrict__ x, const float* __restrict__ a_log,
                        const float* __restrict__ h0, float* __restrict__ h_start,
                        unsigned long long* scratch, int B, int T_len, int W, int n_launched) {
  chain_body<T, true>(x, a_log, h0, nullptr, h_start, scratch, B, T_len, W, n_launched);
}

// Launch 2: every chunk, reverse chunk-major tickets.  Words: one a (chunk
// c ≥ 1, row, channel), the carry chunk c hands to chunk c − 1, at c − 1.
template <typename T>
__global__ void __launch_bounds__(NT, 4)
rglru_bwd_kernel(const T* __restrict__ x, const float* __restrict__ a_log,
                 const float* __restrict__ h0, const T* __restrict__ dh,
                 const float* __restrict__ dhT, const float* __restrict__ h_start,
                 T* __restrict__ dx, float* __restrict__ da, float* __restrict__ dh0,
                 unsigned long long* scratch, int B, int T_len, int W, int n_chunks) {
  const int n_wb = (W + NT - 1) / NT, n_chain = B * n_wb;
  const int ticket = take_ticket(scratch, n_chunks > 1);
  const int c = n_chunks - 1 - ticket / n_chain, chain = ticket % n_chain;
  const int b = chain / n_wb, w = (chain % n_wb) * NT + threadIdx.x;
  if (w >= W) return;
  const int n = min(C, T_len - c * C);
  const size_t base = ((size_t)b * T_len + (size_t)c * C) * W + w;
  const size_t bw = (size_t)b * W + w;

  // every load of the chunk in flight before the first use
  T xs[C];
  float ds[C], as[C], hs[C];
  Gate gs[C];
#pragma unroll
  for (int u = 0; u < C; ++u) {
    if (u == n) break;
    const size_t o = base + (size_t)u * W;
    xs[u] = x[o];
    ds[u] = to_float(dh[o]);
    as[u] = a_log[o];
  }
  float h = c > 0 ? h_start[((size_t)b * n_chunks + c) * W + w]
                  : h0 == nullptr ? 0.f : h0[bw];
  // before the chain: the gates, and h_{t−1} across the chunk by the
  // forward's own steps
#pragma unroll
  for (int u = 0; u < C; ++u) {
    if (u == n) break;
    gs[u] = gate(as[u]);
    hs[u] = h;
    h = __fadd_rn(__fmul_rn(gs[u].a, h), __fmul_rn(gs[u].g, to_float(xs[u])));
  }
  // the chain: the carry from chunk c + 1, δ walked back across the chunk
  // (kept in ds), the carry handed on to chunk c − 1
  unsigned long long* words = scratch + 1;
  const size_t stride = (size_t)B * W;
  float carry = c + 1 < n_chunks ? take_state(words + (size_t)c * stride + bw)
                                 : dhT == nullptr ? 0.f : dhT[bw];
#pragma unroll
  for (int u = C - 1; u >= 0; --u) {
    if (u >= n) continue;
    ds[u] = __fadd_rn(ds[u], carry);
    carry = __fmul_rn(gs[u].a, ds[u]);
  }
  if (c > 0)
    give_state(words + (size_t)(c - 1) * stride + bw, carry);
  else
    dh0[bw] = carry;
  // the outputs
#pragma unroll
  for (int u = 0; u < C; ++u) {
    if (u == n) break;
    const Gate gt = gs[u];
    const float d = ds[u], xf = to_float(xs[u]);
    const size_t o = base + (size_t)u * W;
    dx[o] = from_float<T>(__fmul_rn(gt.g, d));
    da[o] = __fadd_rn(__fmul_rn(d, __fmul_rn(gt.a, hs[u])), __fmul_rn(__fmul_rn(d, xf), gt.dg));
  }
}

template <typename T>
int launch(const void* x, const float* a_log, const float* h0, const void* dh, const float* dhT,
           void* dx, float* da, float* dh0, float* h_start, unsigned long long* scratch, int B,
           int T_len, int W, cudaStream_t stream) {
  const int n_chunks = (T_len + C - 1) / C, n_wb = (W + NT - 1) / NT;
  const T* xt = static_cast<const T*>(x);
  if (n_chunks > 1) {
    rglru_bwd_states_kernel<T><<<(unsigned)(n_chunks - 1) * B * n_wb, NT, 0, stream>>>(
        xt, a_log, h0, h_start, scratch, B, T_len, W, n_chunks - 1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rglru_bwd_kernel<T><<<(unsigned)n_chunks * B * n_wb, NT, 0, stream>>>(
      xt, a_log, h0, static_cast<const T*>(dh), dhT, h_start, static_cast<T*>(dx), da, dh0,
      scratch, B, T_len, W, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dh, dx: (B, T, W) of dtype (0 float32, 1 bfloat16); a_log, da: (B, T,
// W) float32; state, d_state, d_state0: (B, W) float32 (state and d_state
// may be null: zeros).  h_start: for T > C, B·ceil(T / C)·W floats of
// scratch (the state entering each chunk); scratch: for T > C, 1 +
// (ceil(T / C) − 1)·B·W words of 8 bytes, all zero before the call (the
// kernels leave them zero); both unused, and may be null, at T ≤ C.  All
// contiguous.  Up to two launches on `stream`; returns cudaGetLastError()
// after them (0 on success).
extern "C" int repro_rglru_scan_bwd(const void* x, const void* a_log, const void* state,
                                    const void* dh, const void* d_state, void* dx, void* da,
                                    void* d_state0, void* h_start, void* scratch, int B,
                                    int T_len, int W, int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || W <= 0 ||
      (T_len > C && (h_start == nullptr || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float* al = static_cast<const float*>(a_log);
  const float* h0 = static_cast<const float*>(state);
  const float* dhT = static_cast<const float*>(d_state);
  float* daf = static_cast<float*>(da);
  float* d0 = static_cast<float*>(d_state0);
  float* hs = static_cast<float*>(h_start);
  auto* sc = static_cast<unsigned long long*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(x, al, h0, dh, dhT, dx, daf, d0, hs, sc, B, T_len, W, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, al, h0, dh, dhT, dx, daf, d0, hs, sc, B, T_len, W, st);
  return (int)cudaErrorInvalidValue;
}
