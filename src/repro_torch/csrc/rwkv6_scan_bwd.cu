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
// Chunked, as the forward (rwkv6_scan.cu): within a chunk of C = 32 tokens,
// L the inclusive cumulative log-decay, Le = L − lw, LC the chunk's total,
// S_c the state entering chunk c, G_{c+1} the gradient of the state leaving
// it and A[t, s] = do_t · v_s:
//     ∂r_t  = e^{Le_t} ⊙ (S_c do_t) + Σ_{s<t} e^{Le_t − L_s} ⊙ k_s A[t,s] + u ⊙ k_t (v_t·do_t)
//     ∂k_t  = e^{LC − L_t} ⊙ (G_{c+1} v_t) + Σ_{s'>t} e^{Le_s' − L_t} ⊙ r_s' A[s',t] + u ⊙ r_t (v_t·do_t)
//     ∂v_t  = G_{c+1}ᵀ (e^{LC − L_t} ⊙ k_t) + Σ_{s'>t} att[s',t] do_s' + (Σ r_t u k_t) do_t
//     ∂lw_t = e^{LC} ⊙ rowsum(G_{c+1} ⊙ S_c) + Σ_{s<t} e^{LC − L_s} ⊙ k_s ⊙ (G_{c+1} v_s)
//             + Σ_{s'>t} e^{Le_s'} ⊙ r_s' ⊙ (S_c do_s') + γ_t,
//     γ_t   = Σ_{s<t<s'} e^{Le_s' − L_s} ⊙ r_s' ⊙ k_s A[s',s]
//     G_c   = e^{LC} ⊙_rows G_{c+1} + Σ_t (e^{Le_t} ⊙ r_t)ᵀ do_t
// (att the forward's pair scores).  Every exponent is a sum of log-decays of
// one sign, as the forward's (A_t, B_s, P_g, Q_g, G_{g,h} over groups of four
// tokens), never a difference of two fp32 cumulative sums, and each pair
// decay is one ex2 of a non-positive exponent.  Every term of ∂lw_t spans
// token t, so holds w_t inside its exponent: ∂lw keeps its relative
// precision where w_t is 1e-12, and the wrapper's ∂w = ∂lw / w stays exact
// there.  ∂lw is never the usual chunked form's reverse sum of r ⊙ ∂r −
// k ⊙ ∂k, a difference; γ is built from sums that only add, over the 4 × 4
// tiles of the chunk's groups: the tiles strictly around t's group, the row
// sums of the group's rows after t, the column sums of its columns before
// t, and the pairs inside the group.  v·do and Σ r·u·k of each token are
// summed in fp64 and rounded once: each scales a whole row alone (∂v of the
// last token is (Σ r u k)·do when the final state has no gradient, ∂r of
// the first (v·do)·u ⊙ k from a zero state), and an fp32 sum that cancels
// put 1.1e-4 of a row's largest value into such a row on the card.
//
// What bounds it on the H100: ~12·D² fp32 operations a token and head
// (RWKV6-3B's training shape, B = 4, T = 512, H = 40, D = 64: 0.060 ms at
// 67 TFLOP/s) against ~9·B·T·H·D·2 bytes, plus an ex2 per (pair, channel)
// twice.  The design, three launches on one stream:
//  1. wkv6_bwd_states_kernel: the forward's own chain (the prefill's block
//     with no outputs, rwkv6_chunk.cuh) writes the state entering every
//     chunk, B·H·n_chunks·D² floats (42 MB at the training shape).
//  2. wkv6_bwd_kernel: one block per (chunk, head, row), 2,560 at the
//     training shape, taking reverse chunk-major tickets from an atomic
//     counter, so a block waits only on a block that is already running.
//     Before it waits, a block stages its chunk, takes the group sums, v·do
//     and Σ r u k, A = do·vᵀ, then the pair terms in two passes over the
//     lower 4 × 4 tiles, one thread a (channel, pair of row or column
//     groups p and 7 − p): the row owners take ∂r's intra sum, the pair
//     scores (reduced over the channels by a butterfly of shuffles), the
//     tile sums and row sums of γ; the column owners ∂k's intra sum and the
//     column sums of γ.  Then ΔG_c (registers), ∂r (it needs only S_c), the
//     suffix sums of ∂lw and ∂v's intra part.  Then it takes G_{c+1} from
//     its (row, head)'s slot (acquire), writes G_c to the other slot (∂state₀
//     for the first chunk) and publishes it (release): two slots suffice, as
//     in the forward.  Last ∂k, ∂v, ∂lw and the (row, chunk) share of ∂u.
//     The ticket counter and the flags are left zero for the next launch.
//     All products run in fp32 on the CUDA cores, register-tiled (TF32 loses
//     the fp32 check of 1e-4).  A chunk cut short by T runs as if padded
//     with w = 1 and r = k = v = do = 0.
//  3. wkv6_bwd_du_kernel: ∂u, the (row, chunk) shares in a fixed order, with
//     no atomics, so two calls give the same bits.
#include "common.cuh"
#include "rwkv6_chunk.cuh"

namespace {

constexpr int BNT = 256;   // threads a backward block (two blocks an SM)

// Dynamic shared memory of the backward block.  C × D and D × D buffers
// read along rows by threads of different rows are padded to LD = D + 4, so
// eight rows fall on eight bank groups.
template <int D>
struct BwdSmem {
  static constexpr int LD = D + 4;
  float r[C * LD];          // r, then q = r e^{Le}; with do: G_{c+1} (D × LD)
  float dO[C * LD];
  float k[C * LD];          // k, then kd = k e^{LC − L}
  float v[C * LD];
  float A[C * D], B[C * D];   // the group sums, then e^{Le} and e^{LC − L}
  float S[C * D];           // log w; from the decays on, with G..T: S_c (D × LD)
  float G[NGP * D];
  float P[NG * D], Q[NG * D];
  float T[NGP * D];         // γ's tile sums, tile (f, h) at f (f − 1) / 2 + h
  float adm[C * C];         // A[t][s] = do_t · v_s
  float att[C * C];         // att[t][s], s < t, the forward's pair scores
  float drb[C * D];         // ∂r's intra and bonus terms, then β, then ∂v's pre-wait part
  float dkp[C * D];         // ∂k's pre-wait part, then α
  float gam[C * D];         // γ's row and inner parts, then γ, then ∂lw's pre-wait part
  float vd[C], ruk[C], u[D], eLC[D], X[D];
  unsigned ticket;
  static_assert(D * LD <= 2 * C * LD, "G_{c+1} reuses r and dO");
  static_assert(D * LD <= C * D + 2 * NGP * D + 2 * NG * D, "S_c reuses S..T");
};

// One C × D operand into shared memory as fp32, rows ld apart; rows [n, C)
// are zero.  All of a thread's 16-byte loads are issued before its stores.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src, size_t row_stride,
                                           int n) {
  constexpr int VEC = Vec<T>::N, VPR = D / VEC, NV = (C * VPR + BNT - 1) / BNT;
  uint4 x[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = threadIdx.x + j * BNT, t = i / VPR;
    x[j] = make_uint4(0u, 0u, 0u, 0u);
    if (i < C * VPR && t < n) x[j] = load_vec(src + t * row_stride + (i % VPR) * VEC);
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = threadIdx.x + j * BNT;
    if (i < C * VPR) store_widened(dst + (i / VPR) * ld + (i % VPR) * VEC, x[j], T());
  }
}

// The sum over the warp's 32 lanes of each of a lane's 16 values, by a
// butterfly that halves the values at each step: the lane returns the sum
// of value butterfly_index(lane), and lanes 2m and 2m + 1 hold the same one.
__device__ __forceinline__ float butterfly16(float (&x)[16], int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool hi = lane & 16;
    const float send = hi ? x[j] : x[j + 8], keep = hi ? x[j + 8] : x[j];
    x[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool hi = lane & 8;
    const float send = hi ? x[j] : x[j + 4], keep = hi ? x[j + 4] : x[j];
    x[j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool hi = lane & 4;
    const float send = hi ? x[j] : x[j + 2], keep = hi ? x[j + 2] : x[j];
    x[j] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  {
    const bool hi = lane & 2;
    const float send = hi ? x[0] : x[1], keep = hi ? x[1] : x[0];
    x[0] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  }
  return x[0] + __shfl_xor_sync(0xffffffffu, x[0], 1);
}
__device__ __forceinline__ int butterfly_index(int lane) {
  return ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 + ((lane >> 2) & 1) * 2 +
         ((lane >> 1) & 1);
}

// A pair tile's 16 pair scores (a lane's channel's share in q[4a + b]) summed
// over the channels into att; at D = 64 two warps add to each entry, and a
// sum of two values onto zero takes the same bits in either order.
template <int D>
__device__ __forceinline__ void add_scores(BwdSmem<D>& sm, float (&q)[16], int t0, int s0,
                                           int lane) {
  const float x = butterfly16(q, lane);
  if ((lane & 1) == 0) {
    const int idx = butterfly_index(lane);
    atomicAdd(sm.att + (t0 + idx / 4) * C + s0 + idx % 4, x);
  }
}

// The decays of the pairs inside a group of four, from its logs: s = t − 1
// none, t − 2 the log between, t − 3 the two between.
__device__ __forceinline__ float inner_decay(int a, int b, float e1, float e2, float e12) {
  return a - b == 1 ? 1.f : a - b == 2 ? (b == 0 ? e1 : e2) : e12;
}

// The row owners: thread (channel i, p) takes row groups p and 7 − p, every
// tile (f, h ≤ f): ∂r's intra sum plus its bonus term into drb, the pair
// scores into att, the tile sums of γ into T, and γ's part from the rows
// of t's group after t and from the pairs inside the group into gam.
template <int D>
__device__ void pass_rows(BwdSmem<D>& sm, int i, bool valid, int p, int lane) {
  constexpr int LD = BwdSmem<D>::LD;
  const float zero = valid ? 1.f : 0.f;   // an idle lane (D = 16) adds zeros
#pragma unroll 1
  for (int which = 0; which < 2; ++which) {
    const int f = which == 0 ? p : NG - 1 - p;
    float rt[4], At[4], dri[4] = {}, R[4] = {};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      rt[a] = zero * sm.r[(4 * f + a) * LD + i];
      At[a] = sm.A[(4 * f + a) * D + i];
    }
#pragma unroll 1
    for (int h = 0; h < f; ++h) {
      const int gt = f * (f - 1) / 2 + h;
      const float g = sm.G[gt * D + i];
      float ks[4], bs[4], q[16], tsum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        ks[b] = zero * sm.k[(4 * h + b) * LD + i];
        bs[b] = sm.B[(4 * h + b) * D + i];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ea = At[a] + g;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float ek = exp_nonpos(ea + bs[b]) * ks[b];
          const float adm = sm.adm[(4 * f + a) * C + 4 * h + b];
          dri[a] = fmaf(ek, adm, dri[a]);
          q[4 * a + b] = ek * rt[a];
          const float m = q[4 * a + b] * adm;
          R[a] += m;
          tsum += m;
        }
      }
      if (valid) sm.T[gt * D + i] = tsum;
      add_scores(sm, q, 4 * f, 4 * h, lane);
    }
    // the tile on the diagonal
    float inside[4] = {};
    {
      const float l1 = sm.S[(4 * f + 1) * D + i], l2 = sm.S[(4 * f + 2) * D + i];
      const float e1 = exp_nonpos(l1), e2 = exp_nonpos(l2), e12 = exp_nonpos(l1 + l2);
      float ks[4], q[16] = {}, m[4][4] = {};
#pragma unroll
      for (int b = 0; b < 4; ++b) ks[b] = zero * sm.k[(4 * f + b) * LD + i];
#pragma unroll
      for (int a = 1; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < a; ++b) {
          const float ek = inner_decay(a, b, e1, e2, e12) * ks[b];
          const float adm = sm.adm[(4 * f + a) * C + 4 * f + b];
          dri[a] = fmaf(ek, adm, dri[a]);
          q[4 * a + b] = ek * rt[a];
          m[a][b] = q[4 * a + b] * adm;
        }
      add_scores(sm, q, 4 * f, 4 * f, lane);
      inside[1] = m[2][0] + m[3][0];
      inside[2] = m[3][0] + m[3][1];
    }
    if (valid) {
      const float ui = sm.u[i];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = 4 * f + a;
        sm.drb[t * D + i] = dri[a] + (ui * sm.k[t * LD + i]) * sm.vd[t];
        float after = 0.f;
#pragma unroll
        for (int x = a + 1; x < 4; ++x) after += R[x];
        sm.gam[t * D + i] = after + inside[a];
      }
    }
  }
}

// The column owners: thread (channel i, p) takes column groups p and 7 − p,
// every tile (f ≥ h, h): ∂k's intra sum plus its bonus term into dkp, and γ
// completed with the tiles around the group and its columns before t.
template <int D>
__device__ void pass_cols(BwdSmem<D>& sm, int i, bool valid, int p) {
  constexpr int LD = BwdSmem<D>::LD;
  const float zero = valid ? 1.f : 0.f;
#pragma unroll 1
  for (int which = 0; which < 2; ++which) {
    const int h = which == 0 ? p : NG - 1 - p;
    float ks[4], bs[4], dki[4] = {}, Cc[4] = {};
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      ks[b] = zero * sm.k[(4 * h + b) * LD + i];
      bs[b] = sm.B[(4 * h + b) * D + i];
    }
#pragma unroll 1
    for (int f = h + 1; f < NG; ++f) {
      const float g = sm.G[(f * (f - 1) / 2 + h) * D + i];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float rt = zero * sm.r[(4 * f + a) * LD + i];
        const float ea = sm.A[(4 * f + a) * D + i] + g;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float x = exp_nonpos(ea + bs[b]) * rt * sm.adm[(4 * f + a) * C + 4 * h + b];
          dki[b] += x;
          Cc[b] += x * ks[b];
        }
      }
    }
    {
      const float l1 = sm.S[(4 * h + 1) * D + i], l2 = sm.S[(4 * h + 2) * D + i];
      const float e1 = exp_nonpos(l1), e2 = exp_nonpos(l2), e12 = exp_nonpos(l1 + l2);
#pragma unroll
      for (int a = 1; a < 4; ++a) {
        const float rt = zero * sm.r[(4 * h + a) * LD + i];
#pragma unroll
        for (int b = 0; b < a; ++b)
          dki[b] += inner_decay(a, b, e1, e2, e12) * rt * sm.adm[(4 * h + a) * C + 4 * h + b];
      }
    }
    if (valid) {
      float mid = 0.f;                       // the tiles strictly around group h
      for (int hh = 0; hh < h; ++hh)
        for (int f = h + 1; f < NG; ++f) mid += sm.T[(f * (f - 1) / 2 + hh) * D + i];
      const float ui = sm.u[i];
      float before = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int t = 4 * h + b;
        sm.gam[t * D + i] = (mid + before) + sm.gam[t * D + i];
        before += Cc[b];
        sm.dkp[t * D + i] = dki[b] + (ui * sm.r[t * LD + i]) * sm.vd[t];
      }
    }
  }
}

// Register tiles of the C × D products: TT tokens (NTG apart) × 4 columns a
// thread, a warp over 8 token groups × 4 column groups (the forward's output
// tiling).
template <int D>
struct OutTile {
  static constexpr int NEG = D / 4;
  static constexpr int NTG = BNT / NEG < C ? BNT / NEG : C;
  static constexpr int TT = C / NTG;
  static constexpr int THREADS = NTG * NEG;
  static_assert(NTG % 8 == 0 && C % NTG == 0 && THREADS <= BNT, "tiling");
  int tg, e0;
  __device__ OutTile() {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    tg = (warp % (NTG / 8)) * 8 + lane % 8;
    e0 = 4 * ((warp / (NTG / 8)) * 4 + lane / 8);
  }
};

// acc[x][y] = Σ_j a[t_x][j] · b[e0 + y][j], t_x = tg + x·NTG: rows of both
// operands, float4 along j.
template <int D, int TT, int NTG>
__device__ __forceinline__ void rows_by_rows(const float* a, int lda, const float* b, int ldb,
                                             int tg, int e0, float (&acc)[TT][4]) {
#pragma unroll 4
  for (int j = 0; j < D; j += 4) {
    float4 x[TT], y[4];
#pragma unroll
    for (int t = 0; t < TT; ++t) x[t] = ld4(a + (tg + t * NTG) * lda + j);
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = ld4(b + (e0 + e) * ldb + j);
#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[t][e] = fmaf(x[t].x, y[e].x, acc[t][e]);
        acc[t][e] = fmaf(x[t].y, y[e].y, acc[t][e]);
        acc[t][e] = fmaf(x[t].z, y[e].z, acc[t][e]);
        acc[t][e] = fmaf(x[t].w, y[e].w, acc[t][e]);
      }
  }
}

// acc[x][y] = Σ_j a[t_x][j] · b[j][e0 + y], K = D: rows of a, columns of b.
template <int D, int TT, int NTG>
__device__ __forceinline__ void rows_by_cols(const float* a, int lda, const float* b, int ldb,
                                             int tg, int e0, float (&acc)[TT][4]) {
#pragma unroll 4
  for (int j = 0; j < D; j += 4) {
    float4 x[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) x[t] = ld4(a + (tg + t * NTG) * lda + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4 y = ld4(b + (j + jj) * ldb + e0);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const float xs = jj == 0 ? x[t].x : jj == 1 ? x[t].y : jj == 2 ? x[t].z : x[t].w;
        acc[t][0] = fmaf(xs, y.x, acc[t][0]);
        acc[t][1] = fmaf(xs, y.y, acc[t][1]);
        acc[t][2] = fmaf(xs, y.z, acc[t][2]);
        acc[t][3] = fmaf(xs, y.w, acc[t][3]);
      }
    }
  }
}

// Launch 2, the reverse chain: one block per (chunk, head, row).  A wait
// for the next chunk's G past WAIT_LIMIT traps, as the forward's.
template <typename T, int D>
__global__ void __launch_bounds__(BNT, 2)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const T* __restrict__ u,
                const float* __restrict__ s0, const T* __restrict__ dout,
                const float* __restrict__ dsT, const float* __restrict__ states,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dlw, float* __restrict__ du_rows, float* __restrict__ ds0,
                float* slots, unsigned* sync, int T_len, int H, int n_chunks) {
  using Sm = BwdSmem<D>;
  using O = OutTile<D>;
  constexpr int LD = Sm::LD, NEG = D / 4, TT = O::TT, NTG = O::NTG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
  const int BH = gridDim.x / n_chunks;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // reverse chunk-major tickets: a block waits only on the block of the
  // next chunk, whose ticket is smaller, so it is already running
  if (tid == 0) {
    sm.ticket = atomicAdd(sync + BH, 1u);
    if (sm.ticket == gridDim.x - 1) sync[BH] = 0u;   // ready for the next launch
  }
  __syncthreads();
  const int c = n_chunks - 1 - (int)(sm.ticket / BH), bh = sm.ticket % BH;
  const int b = bh / H, h = bh % H;
  const int c0 = c * C;
  const int n = min(C, T_len - c0);
  const size_t stride = (size_t)H * D;
  const size_t base = ((size_t)b * T_len + c0) * stride + (size_t)h * D;

  // ---- stage r, k, v, do and log w; zero the pair scores ----
  stage_rows<T, D>(sm.r, LD, r + base, stride, n);
  stage_rows<T, D>(sm.k, LD, k + base, stride, n);
  stage_rows<T, D>(sm.v, LD, v + base, stride, n);
  stage_rows<T, D>(sm.dO, LD, dout + base, stride, n);
  for (int x = tid; x < C * D; x += BNT) {
    const int t = x / D;
    sm.S[x] = t < n ? logf(fminf(fmaxf(w[base + t * stride + x % D], 1e-12f), 1.f)) : 0.f;
  }
  for (int x = tid; x < C * C; x += BNT) sm.att[x] = 0.f;
  if (tid < D) sm.u[tid] = to_float(u[(size_t)h * D + tid]);
  __syncthreads();

  // ---- the group sums (one thread a channel); v·do and Σ r u k in fp64 (a
  // warp a token); A = do · vᵀ (a thread: 4 tokens t × column s) ----
  if (tid < D) log_decay_sums<D>(tid, sm);
  for (int t = warp; t < C; t += BNT / 32) {
    double vd = 0.0, ruk = 0.0;
    for (int j = lane; j < D; j += 32) {
      vd += (double)sm.v[t * LD + j] * sm.dO[t * LD + j];
      ruk += (double)sm.r[t * LD + j] * sm.u[j] * sm.k[t * LD + j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      vd += __shfl_xor_sync(0xffffffffu, vd, off);
      ruk += __shfl_xor_sync(0xffffffffu, ruk, off);
    }
    if (lane == 0) {
      sm.vd[t] = (float)vd;
      sm.ruk[t] = (float)ruk;
    }
  }
  {
    const int s = tid % 32, t0 = 4 * (tid / 32);
    float acc[4] = {};
#pragma unroll 4
    for (int j = 0; j < D; j += 4) {
      const float4 y = ld4(sm.v + s * LD + j);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 d4 = ld4(sm.dO + (t0 + x) * LD + j);
        acc[x] = fmaf(d4.x, y.x, acc[x]);
        acc[x] = fmaf(d4.y, y.y, acc[x]);
        acc[x] = fmaf(d4.z, y.z, acc[x]);
        acc[x] = fmaf(d4.w, y.w, acc[x]);
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) sm.adm[(t0 + x) * C + s] = acc[x];
  }
  __syncthreads();

  // ---- the pair terms: row owners, then column owners ----
  constexpr int NCW = D < 32 ? 1 : D / 32;          // warps across the channels
  const int pi = 32 * (warp % NCW) + lane, pp = warp / NCW;
  const bool pair_thread = pp < 4;
  if (pair_thread) pass_rows<D>(sm, pi < D ? pi : D - 1, pi < D, pp, lane);
  __syncthreads();
  if (pair_thread) pass_cols<D>(sm, pi < D ? pi : D - 1, pi < D, pp);
  // this (row, chunk)'s share of ∂u, the tokens in order
  if (tid < D) {
    float acc = 0.f;
    for (int t = 0; t < C; ++t)
      acc = fmaf(sm.r[t * LD + tid] * sm.k[t * LD + tid], sm.vd[t], acc);
    du_rows[((size_t)b * n_chunks + c) * H * D + (size_t)h * D + tid] = acc;
  }
  __syncthreads();

  // ---- the decays: e^{Le} and e^{LC − L} in A and B, q and kd in r and k ----
  for (int x = tid; x < C * D; x += BNT) {
    const int t = x / D, d = x % D, g = t / 4;
    const float ele = expf(sm.P[g * D + d] + sm.A[x]), ek = expf(sm.B[x] + sm.Q[g * D + d]);
    sm.A[x] = ele;
    sm.B[x] = ek;
    sm.r[t * LD + d] *= ele;
    sm.k[t * LD + d] *= ek;
  }
  __syncthreads();

  // ---- S_c into S..T through L2 while ΔG_c = qᵀ do is taken (registers) ----
  float* Sc = sm.S;
  {
    const float* src = c > 0 ? states + ((size_t)bh * n_chunks + c) * D * D
                             : s0 == nullptr ? states : s0 + (size_t)bh * D * D;
    const int bytes = c == 0 && s0 == nullptr ? 0 : 16;   // no state: zeros
    for (int x = tid; x < D * D / 4; x += BNT)
      cp_async16(Sc + (x / NEG) * LD + 4 * (x % NEG), src + 4 * x, bytes);
  }
  const bool g_thread = tid < NEG * NEG;
  const int gd0 = 4 * (tid / NEG), ge0 = 4 * (tid % NEG);
  float dG[4][4] = {};
  if (g_thread) {
#pragma unroll 8
    for (int t = 0; t < C; ++t) {
      const float4 a = ld4(sm.r + t * LD + gd0), y = ld4(sm.dO + t * LD + ge0);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) dG[x][e] = fmaf(av[x], bv[e], dG[x][e]);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- ∂r = e^{Le} ⊙ (S_c do) + drb, written; β = q ⊙ (S_c do) into drb ----
  const O ot;
  const bool o_thread = tid < O::THREADS;
  if (o_thread) {
    float acc[TT][4] = {};
    rows_by_rows<D, TT, NTG>(sm.dO, LD, Sc, LD, ot.tg, ot.e0, acc);
#pragma unroll
    for (int x = 0; x < TT; ++x) {
      const int t = ot.tg + x * NTG;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ot.e0 + e;
        if (t < n) dr[base + t * stride + i] = from_float<T>(sm.A[t * D + i] * acc[x][e] +
                                                             sm.drb[t * D + i]);
        sm.drb[t * D + i] = sm.r[t * LD + i] * acc[x][e];
      }
    }
  }
  __syncthreads();
  // ---- ∂lw's pre-wait part: Σ_{s'>t} β_s' + γ_t, one thread a channel ----
  if (tid < D) {
    float acc = 0.f;
    for (int t = C - 1; t >= 0; --t) {
      sm.gam[t * D + tid] = acc + sm.gam[t * D + tid];
      acc += sm.drb[t * D + tid];
    }
  }
  __syncthreads();
  // ---- ∂v's pre-wait part: Σ_{s'>t} att[s'][t] do_s' + (Σ r u k) do_t ----
  if (o_thread) {
    float acc[TT][4] = {};
#pragma unroll 4
    for (int s = 0; s < C; ++s) {
      const float4 y = ld4(sm.dO + s * LD + ot.e0);
#pragma unroll
      for (int x = 0; x < TT; ++x) {
        const float a = sm.att[s * C + ot.tg + x * NTG];
        acc[x][0] = fmaf(a, y.x, acc[x][0]);
        acc[x][1] = fmaf(a, y.y, acc[x][1]);
        acc[x][2] = fmaf(a, y.z, acc[x][2]);
        acc[x][3] = fmaf(a, y.w, acc[x][3]);
      }
    }
#pragma unroll
    for (int x = 0; x < TT; ++x) {
      const int t = ot.tg + x * NTG;
      const float rk = sm.ruk[t];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sm.drb[t * D + ot.e0 + e] = acc[x][e] + rk * sm.dO[t * LD + ot.e0 + e];
    }
  }

  // ---- wait for G_{c+1} (the next chunk's block has nearly always
  // published it by now) and load it over r and do ----
  unsigned* flag = sync + bh;
  if (c + 1 < n_chunks && tid == 0) {
    const long long t0 = clock64();
    while (ld_acquire(flag) < (unsigned)(n_chunks - 1 - c)) {
      if (clock64() - t0 > WAIT_LIMIT) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
  float* Gn = sm.r;
  {
    const float* src = c + 1 < n_chunks ? slots + ((size_t)bh * 2 + ((c + 1) & 1)) * D * D
                                        : dsT == nullptr ? states : dsT + (size_t)bh * D * D;
    const int bytes = c + 1 == n_chunks && dsT == nullptr ? 0 : 16;
    for (int x = tid; x < D * D / 4; x += BNT)
      cp_async16(Gn + (x / NEG) * LD + 4 * (x % NEG), src + 4 * x, bytes);
  }
  cp_async_wait_all();
  __syncthreads();
  // ---- G_c = e^{LC} ⊙ G_{c+1} + ΔG_c to the other slot (∂state₀ for the
  // first chunk), the product and the sum rounded apart; publish ----
  if (g_thread) {
    float* dst = c == 0 ? ds0 + (size_t)bh * D * D : slots + ((size_t)bh * 2 + (c & 1)) * D * D;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float a = sm.eLC[gd0 + x];
      const float4 g = ld4(Gn + (gd0 + x) * LD + ge0);
      __stcg(reinterpret_cast<float4*>(dst + (gd0 + x) * D + ge0),
             make_float4(__fadd_rn(__fmul_rn(a, g.x), dG[x][0]),
                         __fadd_rn(__fmul_rn(a, g.y), dG[x][1]),
                         __fadd_rn(__fmul_rn(a, g.z), dG[x][2]),
                         __fadd_rn(__fmul_rn(a, g.w), dG[x][3])));
    }
  }
  __syncthreads();
  if (tid == 0) {
    if (c > 0) {
      __threadfence();
      st_release(flag, (unsigned)(n_chunks - c));
    } else {
      *flag = 0u;   // every other block of this (row, head) has passed its wait
    }
  }

  // ---- ∂k = e^{LC − L} ⊙ (G_{c+1} v) + dkp, written; α = kd ⊙ (G_{c+1} v)
  // into dkp; ∂v = kd · G_{c+1} + its pre-wait part, written ----
  if (o_thread) {
    float acc[TT][4] = {};
    rows_by_rows<D, TT, NTG>(sm.v, LD, Gn, LD, ot.tg, ot.e0, acc);
#pragma unroll
    for (int x = 0; x < TT; ++x) {
      const int t = ot.tg + x * NTG;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ot.e0 + e;
        if (t < n) dk[base + t * stride + i] = from_float<T>(sm.B[t * D + i] * acc[x][e] +
                                                             sm.dkp[t * D + i]);
        sm.dkp[t * D + i] = sm.k[t * LD + i] * acc[x][e];
      }
    }
    float acc2[TT][4] = {};
    rows_by_cols<D, TT, NTG>(sm.k, LD, Gn, LD, ot.tg, ot.e0, acc2);
#pragma unroll
    for (int x = 0; x < TT; ++x) {
      const int t = ot.tg + x * NTG;
      if (t >= n) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dv[base + t * stride + ot.e0 + e] = from_float<T>(acc2[x][e] +
                                                          sm.drb[t * D + ot.e0 + e]);
    }
  }
  if (tid < D) {
    float acc = 0.f;
    for (int j = 0; j < D; ++j) acc = fmaf(Gn[tid * LD + j], Sc[tid * LD + j], acc);
    sm.X[tid] = acc;
  }
  __syncthreads();
  // ---- ∂lw_t = (e^{LC} X + Σ_{s<t} α_s) + its pre-wait part ----
  if (tid < D) {
    float acc = sm.eLC[tid] * sm.X[tid];
    for (int t = 0; t < n; ++t) {
      dlw[base + t * stride + tid] = acc + sm.gam[t * D + tid];
      acc += sm.dkp[t * D + tid];
    }
  }
}

// The forward's chain with no outputs: the state entering every chunk.
template <typename T, int D>
__global__ void __launch_bounds__(NT, 3)
wkv6_bwd_states_kernel(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ w,
                       const T* __restrict__ u, const float* __restrict__ s0, float* states,
                       unsigned* sync, int T_len, int H, int n_launched) {
  prefill_body<T, D, true>(r, k, v, w, u, s0, nullptr, nullptr, states, sync, T_len, H,
                           n_launched);
}

// ∂u[h][i] = Σ_b Σ_c du_rows[b][c][h][i], the rows and chunks in order.
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ du_rows, float* __restrict__ du,
                                   int BC, int HD) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= HD) return;
  float acc = 0.f;
  for (int j = 0; j < BC; ++j) acc += du_rows[(size_t)j * HD + x];
  du[x] = acc;
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* w, const void* u,
           const float* s0, const void* dout, const float* dsT, void* dr, void* dk, void* dv,
           float* dlw, float* du_rows, float* du, float* ds0, float* states, float* slots,
           unsigned* sync, int B, int T_len, int H, cudaStream_t stream) {
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ut = static_cast<const T*>(u);
  const int n_chunks = (T_len + C - 1) / C, BH = B * H;
  static std::atomic<unsigned long long> states_smem{0}, bwd_smem{0};   // a bit a device
  cudaError_t err;
  if (n_chunks > 1) {
    constexpr size_t smem = sizeof(PrefillSmem<D>);
    err = allow_smem_per_device(wkv6_bwd_states_kernel<T, D>, (int)smem, states_smem);
    if (err != cudaSuccess) return (int)err;
    wkv6_bwd_states_kernel<T, D><<<(unsigned)(n_chunks - 1) * BH, NT, smem, stream>>>(
        rt, kt, vt, w, ut, s0, states, sync, T_len, H, n_chunks - 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  constexpr size_t smem = sizeof(BwdSmem<D>);
  err = allow_smem_per_device(wkv6_bwd_kernel<T, D>, (int)smem, bwd_smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_kernel<T, D><<<(unsigned)n_chunks * BH, BNT, smem, stream>>>(
      rt, kt, vt, w, ut, s0, static_cast<const T*>(dout), dsT, states, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), dlw, du_rows, ds0, slots, sync, T_len, H,
      n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int HD = H * D;
  wkv6_bwd_du_kernel<<<(HD + 255) / 256, 256, 0, stream>>>(du_rows, du, B * n_chunks, HD);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* r, const void* k, const void* v, const float* w, const void* u,
             const float* s0, const void* dout, const float* dsT, void* dr, void* dk, void* dv,
             float* dlw, float* du_rows, float* du, float* ds0, float* states, float* slots,
             unsigned* sync, int B, int T_len, int H, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dlw, du_rows, du,
                                  ds0, states, slots, sync, B, T_len, H, st);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dlw, du_rows, du,
                                  ds0, states, slots, sync, B, T_len, H, st);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dlw, du_rows, du,
                                  ds0, states, slots, sync, B, T_len, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Tokens a chunk: the wrapper sizes the scratch from it.
extern "C" int repro_wkv6_bwd_chunk() { return C; }

// r, k, v, dout, dr, dk, dv: (B, T, H, D) of dtype (0 float32, 1 bfloat16);
// w, dlw: (B, T, H, D) float32; u: (H, D) of dtype; state, d_state, ds0:
// (B, H, D, D) float32 (state and d_state may be null: zeros); du_rows
// (B, ceil(T / C), H, D) and du (H, D) float32.  Scratch: states,
// B·H·ceil(T / C)·D² floats (the state entering each chunk); slots,
// B·H·2·D² floats (G in two slots a (row, head)); sync, B·H + 1 words of 4
// bytes, zero before the call and left zero by it.  All contiguous and
// 16-byte aligned; D in {16, 32, 64}.  Up to three launches on `stream`;
// returns cudaGetLastError() after them (0 on success).
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* state, const void* dout,
                              const void* d_state, void* dr, void* dk, void* dv, void* dlw,
                              void* du_rows, void* du, void* ds0, int B, int T_len, int H, int D,
                              int dtype, void* states, void* slots, void* sync, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || states == nullptr || slots == nullptr ||
      sync == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* s0 = static_cast<const float*>(state);
  const float* dsT = static_cast<const float*>(d_state);
  float* dl = static_cast<float*>(dlw);
  float* dur = static_cast<float*>(du_rows);
  float* duf = static_cast<float*>(du);
  float* d0 = static_cast<float*>(ds0);
  float* st_ = static_cast<float*>(states);
  float* sl = static_cast<float*>(slots);
  unsigned* sy = static_cast<unsigned*>(sync);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_d<float>(r, k, v, wf, u, s0, dout, dsT, dr, dk, dv, dl, dur, duf, d0, st_, sl,
                           sy, B, T_len, H, D, st);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(r, k, v, wf, u, s0, dout, dsT, dr, dk, dv, dl, dur, duf, d0,
                                   st_, sl, sy, B, T_len, H, D, st);
  return (int)cudaErrorInvalidValue;
}
