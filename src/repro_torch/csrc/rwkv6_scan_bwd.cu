// Backward of the RWKV6 WKV recurrence, hand-written for Hopper (sm_90a).
//
// Replaces: no Pallas kernel.  The JAX package trains through jax.grad of
// _wkv6_jnp (src/repro/kernels/ops.py:271), the chunked jnp version of
// wkv6_pallas (src/repro/kernels/rwkv6_scan.py:94); the port's forward is
// a CUDA kernel (rwkv6_scan.cu) that autograd cannot see through.  Per
// (row b, head h), with the forward
//     o_t = r_t · (S_t + diag(u) k_tᵀ v_t),   S_{t+1} = diag(w_t) S_t + k_tᵀ v_t
// (S_0 the given state, w clipped to [1e-12, 1]) and G_t = ∂L/∂S_t, G_T the
// final state's gradient:
//     ∂r_t = S_t · do_t + u ⊙ k_t (v_t · do_t)
//     ∂k_t = G_{t+1} · v_t + u ⊙ r_t (v_t · do_t)
//     ∂v_t = G_{t+1}ᵀ · k_t + (Σ_i r_ti u_i k_ti) do_t
//     ∂lw_t = w_t ⊙ Σ_e G_{t+1} ⊙ S_t          (lw = log w, a row sum)
//     G_t = diag(w_t) G_{t+1} + r_tᵀ do_t,     ∂u = Σ_{b,t} r_t ⊙ k_t (v_t · do_t)
// r, k, v, do (B, T, H, D) and u (H, D) in the model dtype (float32 or
// bfloat16), w (B, T, H, D) float32, the states (B, H, D, D) float32.
//
// ∂lw is taken from the state and its gradient of the same token, never as
// a difference of sums over tokens: every term then holds the factor w_t,
// so the result keeps its relative precision where w_t is 1e-12, and the
// wrapper's ∂w = ∂lw / w stays exact there.  No state is recovered by
// dividing by a decay: the reverse sweep needs S_t, and it rebuilds it.
//
// What bounds it on the H100: the work is ~6·D² fp32 operations a token
// and head (RWKV6-3B's training shape, B = 4, T = 512, H = 40, D = 64:
// ~5.0 GFLOP, 0.08 ms at 67 TFLOP/s) against ~9 B·T·H·D·2 bytes; this
// design is serial in the tokens instead, a (row, head) a block.
//
// The design, simple and exact rather than fast: one block of 4·D threads
// a (row, head); thread (i = tid / 4, q = tid % 4) holds row i of S and of
// G at the columns q + 4m (m < D/4) in registers.  Row sums reduce over
// the four threads of a row with two shuffles; the column sums of ∂v over
// the 8 rows of a warp with three, then over the warps through shared
// memory.  Tokens are staged into shared memory BWD_SUB at a time, each
// token's v·do and Σ r u k summed in fp64 and rounded once: each scales a
// whole row alone (∂v of the last token is (Σ r u k)·do when the final
// state has no gradient, ∂r of the first (v·do)·u ⊙ k from a zero state),
// and an fp32 sum that cancels put 1.1e-4 of a row's largest value into
// such a row on the card.
//  A. Forward sweep from S_0: each sub-chunk's first state is saved to the
//     scratch (BWD_SUB tokens apart), ∂r_t written, S stepped.
//  B. Reverse sweep from G_T, sub-chunk by sub-chunk from the last: for
//     token t of a sub-chunk, S_t is rebuilt from the sub-chunk's saved
//     state in registers (at most BWD_SUB − 1 steps), then ∂lw_t, ∂k_t,
//     ∂v_t, this row's share of ∂u, and G stepped back.
// A second launch sums ∂u's shares over the rows in a fixed order, so two
// calls give the same bits (no atomics anywhere).
#include "common.cuh"

namespace {

constexpr int SUB = 8;   // tokens a sub-chunk: a state is saved every SUB tokens

template <typename T, int D>
__global__ void __launch_bounds__(4 * D, 1)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const T* __restrict__ u,
                const float* __restrict__ s0, const T* __restrict__ dout,
                const float* __restrict__ dsT, T* __restrict__ dr, T* __restrict__ dk,
                T* __restrict__ dv, float* __restrict__ dlw, float* __restrict__ du_rows,
                float* __restrict__ ds0, float* __restrict__ saved, int T_len, int H) {
  constexpr int NTH = 4 * D, E = D / 4, NW = NTH / 32;
  __shared__ float sr[SUB][D], sk[SUB][D], sv[SUB][D], sdo[SUB][D], sw[SUB][D];
  __shared__ float su[D], svd[SUB], sruk[SUB], red[NW][D];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, i = tid >> 2, q = tid & 3, warp = tid >> 5, lane = tid & 31;
  const int n_sub = (T_len + SUB - 1) / SUB;
  const size_t mat = (size_t)bh * D * D;
  float* my_saved = saved + (size_t)bh * n_sub * D * D;

  if (tid < D) su[tid] = to_float(u[h * D + tid]);

  // the n tokens from t0 into shared memory, with v·do and Σ r u k of each
  auto stage = [=](int t0, int n) {
    __syncthreads();                       // the previous sub-chunk is read
    for (int idx = tid; idx < n * D; idx += NTH) {
      const int s = idx / D, j = idx % D;
      const size_t g = ((size_t)(b * T_len + t0 + s) * H + h) * D + j;
      sr[s][j] = to_float(r[g]);
      sk[s][j] = to_float(k[g]);
      sv[s][j] = to_float(v[g]);
      sdo[s][j] = to_float(dout[g]);
      sw[s][j] = fminf(fmaxf(w[g], 1e-12f), 1.f);
    }
    __syncthreads();
    for (int s = warp; s < n; s += NW) {
      double vd = 0.0, ruk = 0.0;
      for (int j = lane; j < D; j += 32) {
        vd += (double)sv[s][j] * sdo[s][j];
        ruk += (double)sr[s][j] * su[j] * sk[s][j];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        vd += __shfl_xor_sync(0xffffffffu, vd, off);
        ruk += __shfl_xor_sync(0xffffffffu, ruk, off);
      }
      if (lane == 0) {
        svd[s] = (float)vd;
        sruk[s] = (float)ruk;
      }
    }
    __syncthreads();
  };
  auto quad_sum = [](float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
  };
  auto out_index = [=](int t) { return ((size_t)(b * T_len + t) * H + h) * D + i; };

  // A. forward sweep: save a state every SUB tokens, ∂r, step S
  float S[E];
#pragma unroll
  for (int m = 0; m < E; ++m) S[m] = s0 == nullptr ? 0.f : s0[mat + i * D + q + 4 * m];
  __syncthreads();
  const float ui = su[i];
  for (int c = 0; c < n_sub; ++c) {
    const int t0 = c * SUB, n = min(SUB, T_len - t0);
    stage(t0, n);
#pragma unroll
    for (int m = 0; m < E; ++m) my_saved[(size_t)c * D * D + m * NTH + tid] = S[m];
    for (int s = 0; s < n; ++s) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < E; ++m) acc = fmaf(S[m], sdo[s][q + 4 * m], acc);
      acc = quad_sum(acc);
      if (q == 0) dr[out_index(t0 + s)] = from_float<T>(acc + ui * sk[s][i] * svd[s]);
      const float wi = sw[s][i], ki = sk[s][i];
#pragma unroll
      for (int m = 0; m < E; ++m) S[m] = fmaf(wi, S[m], ki * sv[s][q + 4 * m]);
    }
  }

  // B. reverse sweep from G_T
  float G[E];
#pragma unroll
  for (int m = 0; m < E; ++m) G[m] = dsT == nullptr ? 0.f : dsT[mat + i * D + q + 4 * m];
  float du_acc = 0.f;
  for (int c = n_sub - 1; c >= 0; --c) {
    const int t0 = c * SUB, n = min(SUB, T_len - t0);
    stage(t0, n);
    for (int s = n - 1; s >= 0; --s) {
      // S_{t0+s}: the saved state stepped s times
#pragma unroll
      for (int m = 0; m < E; ++m) S[m] = my_saved[(size_t)c * D * D + m * NTH + tid];
      for (int p = 0; p < s; ++p) {
        const float wi = sw[p][i], ki = sk[p][i];
#pragma unroll
        for (int m = 0; m < E; ++m) S[m] = fmaf(wi, S[m], ki * sv[p][q + 4 * m]);
      }
      const float wi = sw[s][i], ki = sk[s][i], ri = sr[s][i];
      float gs = 0.f, gv = 0.f;
#pragma unroll
      for (int m = 0; m < E; ++m) {
        gs = fmaf(G[m], S[m], gs);
        gv = fmaf(G[m], sv[s][q + 4 * m], gv);
        // ∂v's column sums: k_i G[i][j] over the warp's 8 rows
        float p = ki * G[m];
        p += __shfl_xor_sync(0xffffffffu, p, 4);
        p += __shfl_xor_sync(0xffffffffu, p, 8);
        p += __shfl_xor_sync(0xffffffffu, p, 16);
        if (lane < 4) red[warp][q + 4 * m] = p;
      }
      gs = quad_sum(gs);
      gv = quad_sum(gv);
      const size_t o = out_index(t0 + s);
      if (q == 0) {
        dlw[o] = wi * gs;
        dk[o] = from_float<T>(gv + ui * ri * svd[s]);
        du_acc = fmaf(ri * ki, svd[s], du_acc);
      }
      __syncthreads();
      if (tid < D) {
        float acc = 0.f;
#pragma unroll
        for (int x = 0; x < NW; ++x) acc += red[x][tid];
        dv[o - i + tid] = from_float<T>(fmaf(sruk[s], sdo[s][tid], acc));
      }
#pragma unroll
      for (int m = 0; m < E; ++m) G[m] = fmaf(wi, G[m], ri * sdo[s][q + 4 * m]);
      __syncthreads();                     // red is rewritten by the next token
    }
  }
#pragma unroll
  for (int m = 0; m < E; ++m) ds0[mat + i * D + q + 4 * m] = G[m];
  if (q == 0) du_rows[(size_t)bh * D + i] = du_acc;
}

// ∂u[h][i] = Σ_b du_rows[b][h][i], the rows in order.
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ du_rows, float* __restrict__ du,
                                   int B, int HD) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= HD) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += du_rows[(size_t)b * HD + x];
  du[x] = acc;
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* w, const void* u,
           const float* s0, const void* dout, const float* dsT, void* dr, void* dk, void* dv,
           float* dlw, float* du_rows, float* du, float* ds0, float* saved, int B, int T_len,
           int H, cudaStream_t stream) {
  wkv6_bwd_kernel<T, D><<<B * H, 4 * D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w,
      static_cast<const T*>(u), s0, static_cast<const T*>(dout), dsT, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), dlw, du_rows, ds0, saved, T_len, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int HD = H * D;
  wkv6_bwd_du_kernel<<<(HD + 255) / 256, 256, 0, stream>>>(du_rows, du, B, HD);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* r, const void* k, const void* v, const float* w, const void* u,
             const float* s0, const void* dout, const float* dsT, void* dr, void* dk, void* dv,
             float* dlw, float* du_rows, float* du, float* ds0, float* saved, int B, int T_len,
             int H, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dlw, du_rows, du,
                                  ds0, saved, B, T_len, H, st);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dlw, du_rows, du,
                                  ds0, saved, B, T_len, H, st);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dlw, du_rows, du,
                                  ds0, saved, B, T_len, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Tokens between two saved states: the wrapper sizes the scratch from it.
extern "C" int repro_wkv6_bwd_sub() { return SUB; }

// r, k, v, dout, dr, dk, dv: (B, T, H, D) of dtype (0 float32, 1 bfloat16);
// w, dlw: (B, T, H, D) float32; u: (H, D) of dtype; state, d_state, ds0:
// (B, H, D, D) float32 (state and d_state may be null: zeros); du_rows
// (B, H, D) and du (H, D) float32; saved: B·H·ceil(T / SUB)·D² floats of
// scratch.  All contiguous; D in {16, 32, 64}.  Two launches on `stream`;
// returns cudaGetLastError() after them (0 on success).
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* state, const void* dout,
                              const void* d_state, void* dr, void* dk, void* dv, void* dlw,
                              void* du_rows, void* du, void* ds0, int B, int T_len, int H, int D,
                              int dtype, void* saved, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || saved == nullptr) return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* s0 = static_cast<const float*>(state);
  const float* dsT = static_cast<const float*>(d_state);
  float* dl = static_cast<float*>(dlw);
  float* dur = static_cast<float*>(du_rows);
  float* duf = static_cast<float*>(du);
  float* d0 = static_cast<float*>(ds0);
  float* sv = static_cast<float*>(saved);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_d<float>(r, k, v, wf, u, s0, dout, dsT, dr, dk, dv, dl, dur, duf, d0, sv, B,
                           T_len, H, D, st);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(r, k, v, wf, u, s0, dout, dsT, dr, dk, dv, dl, dur, duf, d0,
                                   sv, B, T_len, H, D, st);
  return (int)cudaErrorInvalidValue;
}
