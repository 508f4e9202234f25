// RWKV6 ("Finch") WKV recurrence, hand-written for Hopper (sm_90a).
//
// Replaces: wkv6_pallas in src/repro/kernels/rwkv6_scan.py (the Pallas TPU
// kernel, body _kernel).  Same function, per (row b, head h), with an fp32
// (D, D) state S carried over the tokens:
//     o_t = r_t · (S + diag(u) k_tᵀ v_t),   S ← diag(w_t) S + k_tᵀ v_t
// r, k, v (B, T, H, D) and u (H, D) in the model dtype (float32 or
// bfloat16), w (B, T, H, D) in float32, state (B, H, D, D) float32; returns
// o (B, T, H, D) in the model dtype and the final state in float32.
//
// Unlike the TPU kernel, no exponent is clamped.  Within a chunk of C
// tokens, with L the inclusive cumulative log-decay per channel, Le its
// exclusive version and LC the chunk's total, every decay is exp of a
// non-positive number:
//     o_t  = Σ_d r_td e^{Le_td} S_de + Σ_{s<t} (Σ_d r_td k_sd e^{Le_td − L_sd}) v_s
//            + (Σ_d r_td u_d k_td) v_t
//     S_de ← e^{LC_d} S_de + Σ_s k_sd e^{LC_d − L_sd} v_se
// so the result is exact to fp32 rounding for any w in (0, 1].  (The TPU
// kernel factors e^{Le_t − L_s} as e^{clip(Le_t)} · e^{clip(−L_s)}, clipped
// at ±30, which is wrong once a chunk's log-decay falls below −30; RWKV6's
// own decay init reaches −19 to −53 over a chunk of 32.)  A chunk cut short
// by the end of the sequence (T = 1 at every decode step) runs over its
// valid tokens only, which is what padding with w = 1 and r = k = v = 0
// gives.
//
// What bounds it on the H100: at prefill (T = 512) the bytes of r, k, v, w
// and the output and the fp32 arithmetic are of one order (about 5·D² FLOPs
// per token and head against 7·D bytes); at decode (T = 1) reading and
// writing the (D, D) state dominates.
//
// What the design does about it:
//  * One block per (row, head); the TPU kernel's sequential chunk axis is a
//    loop inside the block, and the state stays in shared memory across all
//    chunks, read from and written to device memory once per call.
//  * A chunk's r, k, v and log-decays are staged in shared memory with
//    16-byte loads (rows padded by one float, so the pair loop is free of
//    bank conflicts); the pair decays, the decayed r and k, and the
//    products over the chunk are then computed there, one output element
//    per thread in turn.
#include "common.cuh"

namespace {

constexpr int C = 32;     // tokens per chunk
constexpr int NT = 256;   // threads per block
constexpr int NWARP = NT / 32;

template <int D>
constexpr size_t smem_floats() {
  // S (D x D); r, k, v, L, Le, r·e^{Le}, k·e^{LC−L} (C x (D + 1) each);
  // pair scores (C x C); bonus term per token (C); u (D); LC (D)
  return (size_t)D * D + 7 * (size_t)C * (D + 1) + (size_t)C * C + C + 2 * (size_t)D;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const T* __restrict__ u,
            const float* __restrict__ s0, T* __restrict__ o, float* __restrict__ sT, int T_len,
            int H) {
  constexpr int DP = D + 1;
  extern __shared__ __align__(16) float sm[];
  float* S = sm;                  // D x D: S[d][e], d a key channel, e a value channel
  float* rs = S + D * D;          // C x DP
  float* ks = rs + C * DP;
  float* vs = ks + C * DP;
  float* Ls = vs + C * DP;        // inclusive cumulative log-decay
  float* Les = Ls + C * DP;       // log-decay, then the exclusive cumulative one
  float* qd = Les + C * DP;       // r_td e^{Le_td}
  float* kd = qd + C * DP;        // k_sd e^{LC_d − L_sd}
  float* att = kd + C * DP;       // C x C: Σ_d r_td k_sd e^{Le_td − L_sd}, s < t
  float* dg = att + C * C;        // C: Σ_d r_td u_d k_td
  float* us = dg + C;             // D
  float* LC = us + D;             // D

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t s_off = ((size_t)b * H + h) * D * D;

  for (int i = tid; i < D * D; i += NT) S[i] = s0[s_off + i];
  for (int d = tid; d < D; d += NT) us[d] = to_float(u[(size_t)h * D + d]);

  constexpr int VEC = Vec<T>::N;   // elements of T per 16-byte load
  constexpr int VPR = D / VEC;     // vectors per r/k/v row
  constexpr int WPR = D / 4;       // vectors per w row (float32)
  constexpr int DW = (D + 31) / 32;  // warps that run the cumulative sums

  for (int c0 = 0; c0 < T_len; c0 += C) {
    const int n = min(C, T_len - c0);
    __syncthreads();  // the previous chunk is consumed (and S, u are in place)
    // ---- stage r, k, v and log(w) of the chunk's valid tokens ----
    for (int i = tid; i < n * VPR; i += NT) {
      const int t = i / VPR;
      const int col = (i % VPR) * VEC;
      const size_t off = (((size_t)b * T_len + c0 + t) * H + h) * D + col;
      const uint4 rr = load_vec(r + off), kr = load_vec(k + off), vr = load_vec(v + off);
      store_widened(rs + t * DP + col, rr, T());
      store_widened(ks + t * DP + col, kr, T());
      store_widened(vs + t * DP + col, vr, T());
    }
    for (int i = tid; i < n * WPR; i += NT) {
      const int t = i / WPR;
      const int col = (i % WPR) * 4;
      const size_t off = (((size_t)b * T_len + c0 + t) * H + h) * D + col;
      const float4 wv = *reinterpret_cast<const float4*>(w + off);
      const float wf[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) Les[t * DP + col + j] = logf(fminf(fmaxf(wf[j], 1e-12f), 1.f));
    }
    __syncthreads();
    // ---- cumulative log-decays (warps < DW); bonus terms (the other warps) ----
    if (warp < DW) {
      const int d = tid;
      if (d < D) {
        float run = 0.f;
        for (int t = 0; t < n; ++t) {
          const float lw = Les[t * DP + d];
          run += lw;
          Ls[t * DP + d] = run;
          Les[t * DP + d] = run - lw;
        }
        LC[d] = run;
      }
    } else {
      for (int t = warp - DW; t < n; t += NWARP - DW) {
        float a = 0.f;
        for (int d = lane; d < D; d += 32) a += rs[t * DP + d] * (us[d] * ks[t * DP + d]);
        a = warp_sum(a);
        if (lane == 0) dg[t] = a;
      }
    }
    __syncthreads();
    // ---- pair scores, decayed r and decayed k ----
    for (int i = tid; i < C * C; i += NT) {
      const int t = i / C;
      const int s = i - t * C;
      if (t < n && s < t) {
        const float* rt = rs + t * DP;
        const float* le = Les + t * DP;
        const float* kk = ks + s * DP;
        const float* ll = Ls + s * DP;
        float a = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) a += rt[d] * expf(le[d] - ll[d]) * kk[d];
        att[i] = a;
      }
    }
    for (int i = tid; i < n * D; i += NT) {
      const int t = i / D;
      const int d = i - t * D;
      qd[t * DP + d] = rs[t * DP + d] * expf(Les[t * DP + d]);
      kd[t * DP + d] = ks[t * DP + d] * expf(LC[d] - Ls[t * DP + d]);
    }
    __syncthreads();
    // ---- outputs: state term + intra-chunk term + bonus term ----
    for (int i = tid; i < n * D; i += NT) {
      const int t = i / D;
      const int e = i - t * D;
      const float* q = qd + t * DP;
      float o_state = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) o_state += q[d] * S[d * D + e];
      float o_intra = 0.f;
      for (int s = 0; s < t; ++s) o_intra += att[t * C + s] * vs[s * DP + e];
      const float o_diag = dg[t] * vs[t * DP + e];
      o[(((size_t)b * T_len + c0 + t) * H + h) * D + e] = from_float<T>(o_state + o_intra + o_diag);
    }
    __syncthreads();
    // ---- state update ----
    for (int i = tid; i < D * D; i += NT) {
      const int d = i / D;
      const int e = i - d * D;
      float a = 0.f;
      for (int s = 0; s < n; ++s) a += kd[s * DP + d] * vs[s * DP + e];
      S[i] = expf(LC[d]) * S[i] + a;
    }
  }
  __syncthreads();
  for (int i = tid; i < D * D; i += NT) sT[s_off + i] = S[i];
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* w, const void* u,
           const float* s0, void* o, float* sT, int B, int T_len, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(H, B);
  wkv6_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w,
      static_cast<const T*>(u), s0, static_cast<T*>(o), sT, T_len, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* r, const void* k, const void* v, const float* w, const void* u,
             const float* s0, void* o, float* sT, int B, int T_len, int H, int D,
             cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, o, sT, B, T_len, H, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, o, sT, B, T_len, H, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, o, sT, B, T_len, H, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v: (B, T, H, D) of dtype (0 float32, 1 bfloat16); w: (B, T, H, D)
// float32; u: (H, D) of dtype; state: (B, H, D, D) float32; o: (B, T, H, D)
// of dtype; s_out: (B, H, D, D) float32.  All contiguous and 16-byte
// aligned.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* state, void* o, void* s_out, int B,
                          int T_len, int H, int D, int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* s0 = static_cast<const float*>(state);
  float* sT = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_d<float>(r, k, v, wf, u, s0, o, sT, B, T_len, H, D, st);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(r, k, v, wf, u, s0, o, sT, B, T_len, H, D, st);
  return (int)cudaErrorInvalidValue;
}
