// Backward of causal GQA flash attention, hand-written for Hopper (sm_90a).
//
// Replaces: no Pallas kernel.  The JAX package trains through jax.grad of
// _flash_jnp (src/repro/kernels/ops.py:57), the chunked jnp version of
// flash_attention_pallas (src/repro/kernels/flash_attention.py:124), whose
// lax.scan over KV tiles XLA differentiates.  The port's forward is a CUDA
// kernel (flash_attention.cu) that autograd cannot see through, so training
// on the card needs this kernel: dQ, dK and dV of
//   O = softmax(Q·Kᵀ·scale + mask)·V,  scale = 1/sqrt(D),
// for q, dO (B, S, H, D) and k, v (B, S, Hk, D), head h on KV head h / G
// (G = H / Hk), with the forward kernel's masks: key j is visible to query
// i when j <= i (causal) and j > i - window (sliding window, window > 0).
// Gradients in the input dtype.
//
// What bounds it on the H100: five products of 2·D FLOPs a visible (query,
// key) pair (S, dP, dV, dK, dQ) against q, k, v, dO read and dq, dk, dv
// written once, so at Qwen1.5-0.5B's training shape (8 x 512 tokens, 16
// heads of 64, causal) the FLOPs over 989 TFLOP/s bf16 (~0.011 ms) and the
// bytes over 3.35 TB/s (~0.015 ms) are close.  The design below runs nine
// products, not five (S and dP in each of three passes over a tile pair),
// so its own floor on the tensor cores is ~0.02 ms.
//
// Both dtypes run two launches and no atomics, so the gradients are the same
// bits on every launch:
//  A. a dq kernel, one block per (Q tile, head, batch row).  Pass 1 walks
//     the visible KV tiles and keeps each row's online max, sum and
//     δ_i = Σ_j P_ij dP_ij (= dO_i · O_i with O the fp32 output, summed
//     over the keys online like the log-sum-exp, so the rounding of a bf16
//     output, up to ~6% of a row's gradient through δ, never enters), then
//     writes the rows' LSE and δ to the (B, H, S) fp32 scratch.  Pass 2
//     walks the same tiles again: P = exp(S·scale − LSE), dP = dO·Vᵀ,
//     dS = P ∘ (dP − δ), dQ += dS·K.  Q and dO are loaded once for both.
//  B. a dkdv kernel, one block per (KV tile, KV head, batch row): K and V
//     stay while the block walks the G query heads of the group and, for
//     each, the Q tiles that see the tile, with their LSE and δ; it
//     rebuilds Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ and adds Pᵀ·dO into dV and dSᵀ·Q
//     into dK, the group's sum over G inside the block.
// Tiles no row of a block sees are skipped; only tiles that cross the
// diagonal, the window's edge or the end of S are masked.  Blocks of A are
// issued last Q tile first, those of B first KV tile first: under the
// causal mask they have the most tiles to walk.
//
// bf16: bwd_dq_tc_kernel and bwd_dkdv_tc_kernel, one warpgroup a block, on
// the tensor cores with the pieces of hopper.cuh that the forward's
// flash_tc_kernel uses:
//  * Tiles of 64 rows (queries or keys) x 64 columns arrive by TMA through
//    4-d tensor maps over (D, heads, S, B), 128-byte rows with the 128-byte
//    swizzle; TMA's zero fill pads D = 16 and 32 to the 64-wide atom column
//    and the rows past S.  A's Q and dO, and B's K and V, arrive once; A's
//    K/V tiles and B's Q/dO tiles go through rings of two stages, a stage
//    refilled with the tile two ahead once every warp has read it.
//  * S, dP (A) and Sᵀ, dPᵀ (B): wgmma m64n64k16 with both operands K-major
//    from shared memory, D/16 steps.  dQ += dS·K (A), dV += Pᵀ·dO and
//    dK += dSᵀ·Q (B): wgmma m64n64k16 with A from registers and B read
//    MN-major (the transpose bit) from the same swizzled tiles, the
//    reduction over keys (A) or query rows (B) in 16-wide steps, 2048 bytes
//    apart.  The accumulator's 16-column chunk i, packed to bf16 pairs, is
//    the A fragment of the i-th step, as P is in the forward.
//  * P and dS are rounded to bf16 for the products; LSE, δ and the row
//    sums stay fp32 (P unrounded in δ).  Exponents in the log2 domain: the
//    scratch holds LSE·log2(e).
//  * In B's Sᵀ accumulator, a thread holds keys 16w + t/4 (+ 8) and query
//    columns 8c + 2(t%4) + {0, 1}: it reads those 16 queries' LSE and δ
//    from the scratch before waiting on the tiles (rows past S read as
//    LSE = +inf, δ = 0, so their P and dS are 0).
//  * dQ, dK and dV accumulators (32 floats a thread each) stay in registers
//    until the end.  Each product group is committed and waited on before
//    its result is read; several blocks an SM overlap one another's
//    products with their exponentials and copies.
// fp32: bwd_dq_kernel and bwd_dkdv_kernel on the CUDA cores, because the
// fp32 gate (1e-4 row-relative) needs full-fp32 products.  Tiles are
// widened in shared memory, rows padded by one float; a block's 4·BT
// threads form a (BT/4) x 16 grid; thread (ty, tx) owns rows ty + BT/4·a
// (a < 4) and columns tx + 16b (b < BT/16) of a BT x BT score tile, and
// columns tx + 16c (c < D/16) of a gradient tile; a row's max and sum
// reduce over its 16 threads with shuffles.  The next tile is fetched into
// registers in 16-byte pieces while the current one is used.  BT = 64: on
// the H100 it beat 32 on the tiny pool's training shapes taken together and
// at 1,024 blocks, though 32 won at 144-160 blocks
// (benchmarks/torch_flash_bwd_tiles.py).
// D = 256 (RecurrentGemma's local attention): in bf16 bwd_dq_wg2_kernel and
// bwd_dkdv_wg2_kernel, the tensor-core design above with two warpgroups a
// block, D split between them, and the dkdv kernel's GQA group split over a
// cluster of blocks that sums its partials in shared memory; in fp32
// bwd_dq_wide_kernel and bwd_dkdv_wide_kernel, the same two launches on the
// CUDA cores with tiles of 32 rows by 256 columns (see their sections below).
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

struct Shape {
  int S, H, Hk, G, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(int i, int j, const Shape& s) {
  return i < s.S && j < s.S && (!s.causal || j <= i) && (s.window <= 0 || j > i - s.window);
}

// First key (inclusive) and last key (exclusive) any row of the Q tile of
// bt rows at q0 sees.
__device__ __forceinline__ int key_lo(int q0, const Shape& s) {
  return s.window > 0 ? max(0, q0 - s.window + 1) : 0;
}
__device__ __forceinline__ int key_hi(int q0, int bt, const Shape& s) {
  return s.causal ? min(s.S, q0 + bt) : s.S;
}
// First and last (exclusive) query rows that see any key of the KV tile of
// bt keys at k0.
__device__ __forceinline__ int query_lo(int k0, const Shape& s) { return s.causal ? k0 : 0; }
__device__ __forceinline__ int query_hi(int k0, int bt, const Shape& s) {
  return s.window > 0 ? min(s.S, k0 + bt - 1 + s.window) : s.S;
}
// Whether some (query, key) pair of the tiles at q0 and k0 (bt each) is
// hidden: the tile crosses the diagonal, the window's edge or the end of S.
__device__ __forceinline__ bool edge_tile(int q0, int k0, int bt, const Shape& s) {
  return q0 + bt > s.S || k0 + bt > s.S || (s.causal && k0 + bt - 1 > q0) ||
         (s.window > 0 && k0 <= q0 + bt - 1 - s.window);
}

// ---- bf16: tensor cores (wgmma over swizzled TMA tiles) ------------------
constexpr int TC_T = 64;                 // rows of a Q tile, keys of a KV tile
constexpr int TC_THREADS = 128;          // one warpgroup
constexpr int TILE = TC_T * 128;         // bytes of one 64 x 64 bf16 tile (128-byte rows)
// 1024 bytes to align the first tile; six tiles; three barriers
constexpr int TC_SMEM = 1024 + 6 * TILE + 8 * 3;

// K-major operand of a 64-row tile at `tile`, 16-wide step kk of the reduction
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 32, 16, 1024);
}
// MN-major operand of a tile at `tile`, rows 16·kk .. 16·kk + 15 as the reduction
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, TILE, 1024);
}

// d = zero, then += A·Bᵀ over D/16 steps, both tiles K-major
template <int D>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_m64n64k16(d, kmajor(a, kk), kmajor(b, kk));
}
// d += A·B: A the 64 x 64 bf16 fragment in f (four 16-wide steps), B a tile read MN-major
__device__ __forceinline__ void issue_rs(float (&d)[32], const uint32_t (&f)[16], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < TC_T / 16; ++kk) wgmma_rs_m64n64k16(d, f + 4 * kk, mnmajor(b, kk));
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// A: dQ of one (Q tile, head, batch row), and the rows' LSE·log2(e) and δ.
// Accumulator layout (hopper.cuh): thread t of warp w holds rows 16w + t/4
// (index bit 1 clear) and + 8 (set), columns 8c + 2(t%4) + {0, 1} at
// indices 4c + {0, 1} (+ 2).
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 __nv_bfloat16* __restrict__ dq, float* __restrict__ lse,
                 float* __restrict__ delta, Shape s, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t dos = qs + TILE;
  const uint32_t ks = dos + TILE;          // stage st at ks + st·TILE
  const uint32_t vs = ks + 2 * TILE;
  const uint32_t bar_q = vs + 2 * TILE;    // Q and dO
  const uint32_t bar_kv = bar_q + 8;       // K and V of stage st at bar_kv + 8·st

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nt = (s.S + TC_T - 1) / TC_T;
  const int q0 = (nt - 1 - static_cast<int>(blockIdx.x)) * TC_T;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / s.G;
  const int lo = key_lo(q0, s) / TC_T;
  const int n = (key_hi(q0, TC_T, s) + TC_T - 1) / TC_T - lo;   // at least 1

  // iteration it of the two passes reads KV tile lo + it % n from stage it % 2
  auto load_kv = [&](int it) {
    const int st = it % 2, k0 = (lo + it % n) * TC_T;
    const uint32_t bar = bar_kv + 8 * st;
    mbar_expect_tx(bar, 2 * TILE);
    tma_load_4d(ks + st * TILE, &tk, bar, 0, hk, k0, b);
    tma_load_4d(vs + st * TILE, &tv, bar, 0, hk, k0, b);
  };
  if (tid == 0) {
    prefetch_tensormap(&tq);
    prefetch_tensormap(&tk);
    prefetch_tensormap(&tv);
    prefetch_tensormap(&tdo);
    for (int i = 0; i < 3; ++i) mbar_init(bar_q + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * TILE);
    tma_load_4d(qs, &tq, bar_q, 0, h, q0, b);
    tma_load_4d(dos, &tdo, bar_q, 0, h, q0, b);
    load_kv(0);
    load_kv(1);                            // 2n >= 2 iterations
  }
  // stage it % 2 is read by every warp: refill it with the tile two ahead
  auto release = [&](int it) {
    __syncthreads();
    if (tid == 0 && it + 2 < 2 * n) load_kv(it + 2);
  };

  const int r0 = 16 * warp + lane / 4;
  const int pos[2] = {q0 + r0, q0 + r0 + 8};
  float sc[32], dp[32];
  // S = Q·Kᵀ and dP = dO·Vᵀ of the tiles in stage st
  auto scores = [&](int st) {
    zero(sc);
    zero(dp);
    wgmma_fence();
    issue_ss<D>(sc, qs, ks + st * TILE);
    issue_ss<D>(dp, dos, vs + st * TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
  };
  auto key_of = [&](int k0, int i) { return k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2; };

  mbar_wait(bar_q, 0);
  // pass 1: online max, sum and Σ e·dP of this thread's two rows (its
  // share of them: the quad's four threads are summed at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, ds_sum[2] = {0.f, 0.f};
  for (int it = 0; it < n; ++it) {
    mbar_wait(bar_kv + 8 * (it % 2), (it / 2) & 1);
    scores(it % 2);
    release(it);
    const int k0 = (lo + it) * TC_T;
    const bool edge = edge_tile(q0, k0, TC_T, s);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      float x = sc[i] * scale_log2;
      if (edge && !visible(pos[r], key_of(k0, i), s)) x = -INFINITY;
      sc[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;   // a row with no visible key yet
      const float corr = exp2f(m[r] - mu[r]);     // 0 while m is -inf
      l[r] *= corr;
      ds_sum[r] *= corr;
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      const float e = exp2f(sc[i] - mu[r]);
      l[r] += e;
      ds_sum[r] = fmaf(e, dp[i], ds_sum[r]);
    }
  }
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    ds_sum[r] += __shfl_xor_sync(0xffffffffu, ds_sum[r], 1);
    ds_sum[r] += __shfl_xor_sync(0xffffffffu, ds_sum[r], 2);
    lse2[r] = l[r] > 0.f ? m[r] + log2f(l[r]) : INFINITY;
    dl[r] = l[r] > 0.f ? ds_sum[r] / l[r] : 0.f;
    if (lane % 4 == 0 && pos[r] < s.S) {
      const size_t row = (static_cast<size_t>(b) * s.H + h) * s.S + pos[r];
      lse[row] = lse2[r];
      delta[row] = dl[r];
    }
  }

  // pass 2: dS of each tile, dQ += dS·K
  float acc[32];
  zero(acc);
  uint32_t dsf[16];
  for (int it = n; it < 2 * n; ++it) {
    const int st = it % 2;
    mbar_wait(bar_kv + 8 * st, (it / 2) & 1);
    scores(st);
    const int k0 = (lo + it - n) * TC_T;
    const bool edge = edge_tile(q0, k0, TC_T, s);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i / 2) % 2;
      float d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = !edge || visible(pos[r], key_of(k0, i + e), s);
        const float p = ok ? exp2f(sc[i + e] * scale_log2 - lse2[r]) : 0.f;
        d2[e] = p * (dp[i + e] - dl[r]);
      }
      dsf[i / 2] = pack_bf16(d2[0], d2[1]);
    }
    wgmma_fence();
    issue_rs(acc, dsf, ks + st * TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    release(it);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (pos[r] >= s.S) continue;
    __nv_bfloat16* out = dq + ((static_cast<size_t>(b) * s.S + pos[r]) * s.H + h) * D +
                         2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) = __floats2bfloat162_rn(
          acc[4 * c + 2 * r] * s.scale, acc[4 * c + 2 * r + 1] * s.scale);
  }
}

// B: dK and dV of one (KV tile, KV head, batch row), summed over the G
// heads of the group.  In the Sᵀ accumulator rows are keys and columns
// queries.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, Shape s, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ks = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t vs = ks + TILE;
  const uint32_t qs = vs + TILE;           // stage st at qs + st·TILE
  const uint32_t dos = qs + 2 * TILE;
  const uint32_t bar_kv = dos + 2 * TILE;  // K and V
  const uint32_t bar_s = bar_kv + 8;       // Q and dO of stage st at bar_s + 8·st

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * TC_T, hk = blockIdx.y, b = blockIdx.z;
  const int qlo = query_lo(k0, s) / TC_T;
  const int nq = (query_hi(k0, TC_T, s) + TC_T - 1) / TC_T - qlo;   // at least 1
  const int n = s.G * nq;

  // iteration it reads Q tile qlo + it % nq of head hk·G + it / nq from stage it % 2
  auto load_q = [&](int it) {
    const int st = it % 2, q0 = (qlo + it % nq) * TC_T, h = hk * s.G + it / nq;
    const uint32_t bar = bar_s + 8 * st;
    mbar_expect_tx(bar, 2 * TILE);
    tma_load_4d(qs + st * TILE, &tq, bar, 0, h, q0, b);
    tma_load_4d(dos + st * TILE, &tdo, bar, 0, h, q0, b);
  };
  if (tid == 0) {
    prefetch_tensormap(&tq);
    prefetch_tensormap(&tk);
    prefetch_tensormap(&tv);
    prefetch_tensormap(&tdo);
    for (int i = 0; i < 3; ++i) mbar_init(bar_kv + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * TILE);
    tma_load_4d(ks, &tk, bar_kv, 0, hk, k0, b);
    tma_load_4d(vs, &tv, bar_kv, 0, hk, k0, b);
    load_q(0);
    if (n > 1) load_q(1);
  }

  const int r0 = 16 * warp + lane / 4;
  const int key[2] = {k0 + r0, k0 + r0 + 8};
  float dka[32], dva[32], st_[32], dpt[32];
  zero(dka);
  zero(dva);
  uint32_t pf[16], dsf[16];
  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % 2, q0 = (qlo + it % nq) * TC_T, h = hk * s.G + it / nq;
    // LSE·log2(e) and δ of this thread's 16 query columns, 8c + 2(t%4) + e
    const size_t row0 = (static_cast<size_t>(b) * s.H + h) * s.S;
    float ls[16], dl[16];
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = q0 + 8 * c + 2 * (lane % 4) + e;
        ls[2 * c + e] = i < s.S ? __ldg(lse + row0 + i) : INFINITY;
        dl[2 * c + e] = i < s.S ? __ldg(delta + row0 + i) : 0.f;
      }
    mbar_wait(bar_s + 8 * st, (it / 2) & 1);
    zero(st_);
    zero(dpt);
    wgmma_fence();
    issue_ss<D>(st_, ks, qs + st * TILE);
    issue_ss<D>(dpt, vs, dos + st * TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st_);
    fence_regs(dpt);
    const bool edge = edge_tile(q0, k0, TC_T, s);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i / 2) % 2;
      float p2[2], d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * (i / 4) + e;     // this column's LSE and δ
        const int qi = q0 + 8 * (i / 4) + 2 * (lane % 4) + e;
        const bool ok = !edge || visible(qi, key[r], s);
        p2[e] = ok ? exp2f(st_[i + e] * scale_log2 - ls[c]) : 0.f;
        d2[e] = p2[e] * (dpt[i + e] - dl[c]);
      }
      pf[i / 2] = pack_bf16(p2[0], p2[1]);
      dsf[i / 2] = pack_bf16(d2[0], d2[1]);
    }
    wgmma_fence();
    issue_rs(dva, pf, dos + st * TILE);
    issue_rs(dka, dsf, qs + st * TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    __syncthreads();                       // stage st is read by every warp
    if (tid == 0 && it + 2 < n) load_q(it + 2);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= s.S) continue;
    const size_t base = ((static_cast<size_t>(b) * s.S + key[r]) * s.Hk + hk) * D +
                        2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * c) = __floats2bfloat162_rn(
          dka[4 * c + 2 * r] * s.scale, dka[4 * c + 2 * r + 1] * s.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * c) =
          __floats2bfloat162_rn(dva[4 * c + 2 * r], dva[4 * c + 2 * r + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
              void* dv, float* lse, float* delta, int B, int S, int H, int Hk, int causal,
              int window, cudaStream_t stream) {
  const Shape s{S, H, Hk, H / Hk, causal, window, static_cast<float>(1.0 / std::sqrt(double(D)))};
  const float scale_log2 = static_cast<float>(1.4426950408889634 / std::sqrt(double(D)));
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_bf16_4d(&tq, q, D, H, S, B, 64, 1, TC_T, 1) ||
      !encode_bf16_4d(&tk, k, D, Hk, S, B, 64, 1, TC_T, 1) ||
      !encode_bf16_4d(&tv, v, D, Hk, S, B, 64, 1, TC_T, 1) ||
      !encode_bf16_4d(&tdo, dout, D, H, S, B, 64, 1, TC_T, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // on every launch: the attribute belongs to the current device
  cudaError_t err = allow_smem(bwd_dq_tc_kernel<D>, TC_SMEM);
  if (err == cudaSuccess) err = allow_smem(bwd_dkdv_tc_kernel<D>, TC_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (S + TC_T - 1) / TC_T;
  bwd_dq_tc_kernel<D><<<dim3(nt, H, B), TC_THREADS, TC_SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<__nv_bfloat16*>(dq), lse, delta, s, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_tc_kernel<D><<<dim3(nt, Hk, B), TC_THREADS, TC_SMEM, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), s, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 at D = 256: two warpgroups a block, D split between them -------
// RecurrentGemma's local attention (16 heads on one KV head, D = 256, window
// 2048).  A 64 x 256 fp32 accumulator is 128 floats a thread in one
// warpgroup: dK and dV together would not fit, dQ beside S and dP would sit
// at the register cap.  So a block has two warpgroups (256 threads), and
// warpgroup w owns gradient columns [w·D/2, (w+1)·D/2): 64 floats a thread
// for dQ (A), 128 for dK and dV (B).  S and dP need the whole of D: each
// warpgroup forms both itself, as m64n64 products over D/16 steps, so the
// two never wait on each other inside a tile pair and nothing is exchanged
// through shared memory; the price is that S and dP are formed twice (15
// products of 2·64·64·D a tile pair over the two kernels, not 9).  A
// variant that formed each once (warpgroup 0 S, warpgroup 1 dP, the fp32
// dP and the bf16 P and dS traded through 32 KB of shared memory behind
// named barriers) gave the same bits and was slower on the H100: the
// kernels wait on latency more than on the tensor cores' rate (PERF.md §6,
// benchmarks/torch_flash_bwd_d256.py).
//  * Tiles of 64 rows x D arrive by TMA as D/64 atom columns of 64 x 64
//    (128-byte swizzle, 8 KB each, ATOM apart).  A loads Q and dO once and
//    streams K/V through a ring of two stages; B loads K and V once and
//    streams Q/dO.  Six tiles: 192 KB of the 227 KB a block may take.
//  * S, dP (A) and Sᵀ, dPᵀ (B): wgmma m64n64k16, both operands K-major, the
//    k-th step at atom kk / 4, offset 32·(kk % 4), as the forward's S.
//    dQ, dV, dK: wgmma m64n(D/2)k16 with A from registers (dS, P, packed
//    to bf16) and B the warpgroup's D/64 / 2 atom columns read MN-major (LBO
//    = ATOM between atom columns), as the forward's P·V.
//  * B splits the G query heads of a KV head over GS blocks, which form one
//    cluster (1, GS, 1): block g walks heads [G·g/GS, G·(g+1)/GS) of the
//    group.  Each block leaves its fp32 partial dK and dV in its own shared
//    memory (the Q/dO ring, free once the walk ends); after a cluster
//    barrier block g sums its share of the rows over the GS partials in rank
//    order 0 .. GS-1, reading its peers' shared memory, and rounds each
//    gradient once.  No scratch in device memory and no atomics: the same
//    bits on every launch.  GS (group_split) doubles from 1 up to min(G, 4)
//    while the grid has fewer than two blocks an SM.  At RecurrentGemma's
//    training shape (B = 2, S = 3,072) that is GS = 4: 384 blocks instead
//    of 96 blocks of 16 heads x ~33 Q tiles each.
//  * B's per-query LSE and δ go through shared memory (two buffers of 64
//    each): threads 0-63 load those of the next tile pair while this one
//    is computed and store them before the refill barrier.
// Masks, rounding points and the log2 domain are those of the one-warpgroup
// kernels above.  D is a template parameter: D = 128 is the same design
// (one atom column a warpgroup); D = 192 would need an m64n96 split.
template <int D>
struct Wg2 {
  static_assert(D % 128 == 0, "each warpgroup takes whole atom columns");
  static constexpr int THREADS = 256;
  static constexpr int NA = D / 64;             // atom columns across a row
  static constexpr int DW = D / 2;              // gradient columns a warpgroup
  static constexpr int ATOM = TC_T * 128;       // bytes of one 64 x 64 atom column
  static constexpr int TILE_B = NA * ATOM;      // one 64 x D tile
  // 1024 bytes of alignment, six tiles, three barriers, B's LSE/δ buffers
  static constexpr int SMEM = 1024 + 6 * TILE_B + 8 * 3 + 4 * 4 * TC_T;
};

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b) {
  if constexpr (N == 64) wgmma_rs_m64n64k16(d, a, b);
  else wgmma_rs_m64n128k16(d, a, b);
}

// d = zero, then += A·Bᵀ over D/16 steps, both 64 x D tiles K-major
template <int D>
__device__ __forceinline__ void issue_ss_wide(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * Wg2<D>::ATOM + (kk % 4) * 32;
    wgmma_ss_m64n64k16(d, sw128_desc(a + off, 16, 1024), sw128_desc(b + off, 16, 1024));
  }
}
// d += A·B: A the 64 x 64 bf16 fragment in f, B the D/2 columns of a tile
// starting at atom column `cols`, read MN-major
template <int D>
__device__ __forceinline__ void issue_rs_wide(float (&d)[D / 4], const uint32_t (&f)[16],
                                              uint32_t cols) {
#pragma unroll
  for (int kk = 0; kk < TC_T / 16; ++kk)
    wgmma_rs<D / 2>(d, f + 4 * kk, sw128_desc(cols + kk * 16 * 128, Wg2<D>::ATOM, 1024));
}

// One 64-row tile (NA boxes of 64 columns) of a 4-d tensor map
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int head, int row0, int b) {
#pragma unroll
  for (int c = 0; c < Wg2<D>::NA; ++c)
    tma_load_4d(dst + c * Wg2<D>::ATOM, map, bar, 64 * c, head, row0, b);
}

// A: dQ of one (Q tile, head, batch row), and the rows' LSE·log2(e) and δ,
// the columns of dQ split between the warpgroups.
template <int D>
__global__ void __launch_bounds__(Wg2<D>::THREADS, 1)
bwd_dq_wg2_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  __nv_bfloat16* __restrict__ dq, float* __restrict__ lse,
                  float* __restrict__ delta, Shape s, float scale_log2) {
  using W = Wg2<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t dos = qs + W::TILE_B;
  const uint32_t ks = dos + W::TILE_B;     // stage st at ks + st·TILE_B
  const uint32_t vs = ks + 2 * W::TILE_B;
  const uint32_t bar_q = vs + 2 * W::TILE_B;
  const uint32_t bar_kv = bar_q + 8;       // K and V of stage st at bar_kv + 8·st

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int nt = (s.S + TC_T - 1) / TC_T;
  const int q0 = (nt - 1 - static_cast<int>(blockIdx.x)) * TC_T;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / s.G;
  const int lo = key_lo(q0, s) / TC_T;
  const int n = (key_hi(q0, TC_T, s) + TC_T - 1) / TC_T - lo;   // at least 1

  // iteration it of the two passes reads KV tile lo + it % n from stage it % 2
  auto load_kv = [&](int it) {
    const int st = it % 2, k0 = (lo + it % n) * TC_T;
    const uint32_t bar = bar_kv + 8 * st;
    mbar_expect_tx(bar, 2 * W::TILE_B);
    load_tile<D>(ks + st * W::TILE_B, &tk, bar, hk, k0, b);
    load_tile<D>(vs + st * W::TILE_B, &tv, bar, hk, k0, b);
  };
  if (tid == 0) {
    prefetch_tensormap(&tq);
    prefetch_tensormap(&tk);
    prefetch_tensormap(&tv);
    prefetch_tensormap(&tdo);
    for (int i = 0; i < 3; ++i) mbar_init(bar_q + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * W::TILE_B);
    load_tile<D>(qs, &tq, bar_q, h, q0, b);
    load_tile<D>(dos, &tdo, bar_q, h, q0, b);
    load_kv(0);
    load_kv(1);                            // 2n >= 2 iterations
  }
  auto release = [&](int it) {
    __syncthreads();
    if (tid == 0 && it + 2 < 2 * n) load_kv(it + 2);
  };

  const int r0 = 16 * warp + lane / 4;
  const int pos[2] = {q0 + r0, q0 + r0 + 8};
  float sc[32], dp[32];
  // S = Q·Kᵀ and dP = dO·Vᵀ of the tiles in stage st, over the whole of D
  auto scores = [&](int st) {
    zero(sc);
    zero(dp);
    wgmma_fence();
    issue_ss_wide<D>(sc, qs, ks + st * W::TILE_B);
    issue_ss_wide<D>(dp, dos, vs + st * W::TILE_B);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
  };
  auto key_of = [&](int k0, int i) { return k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2; };

  mbar_wait(bar_q, 0);
  // pass 1: online max, sum and Σ e·dP of this thread's two rows
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, ds_sum[2] = {0.f, 0.f};
  for (int it = 0; it < n; ++it) {
    mbar_wait(bar_kv + 8 * (it % 2), (it / 2) & 1);
    scores(it % 2);
    release(it);
    const int k0 = (lo + it) * TC_T;
    const bool edge = edge_tile(q0, k0, TC_T, s);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      float x = sc[i] * scale_log2;
      if (edge && !visible(pos[r], key_of(k0, i), s)) x = -INFINITY;
      sc[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[r] - mu[r]);
      l[r] *= corr;
      ds_sum[r] *= corr;
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      const float e = exp2f(sc[i] - mu[r]);
      l[r] += e;
      ds_sum[r] = fmaf(e, dp[i], ds_sum[r]);
    }
  }
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    ds_sum[r] += __shfl_xor_sync(0xffffffffu, ds_sum[r], 1);
    ds_sum[r] += __shfl_xor_sync(0xffffffffu, ds_sum[r], 2);
    lse2[r] = l[r] > 0.f ? m[r] + log2f(l[r]) : INFINITY;
    dl[r] = l[r] > 0.f ? ds_sum[r] / l[r] : 0.f;
    // both warpgroups hold the same values; the first writes them
    if (wg == 0 && lane % 4 == 0 && pos[r] < s.S) {
      const size_t row = (static_cast<size_t>(b) * s.H + h) * s.S + pos[r];
      lse[row] = lse2[r];
      delta[row] = dl[r];
    }
  }

  // pass 2: dS of each tile, dQ[:, this warpgroup's columns] += dS·K
  float acc[D / 4];
  zero(acc);
  uint32_t dsf[16];
  const uint32_t cols = wg * (W::NA / 2) * W::ATOM;
  for (int it = n; it < 2 * n; ++it) {
    const int st = it % 2;
    mbar_wait(bar_kv + 8 * st, (it / 2) & 1);
    scores(st);
    const int k0 = (lo + it - n) * TC_T;
    const bool edge = edge_tile(q0, k0, TC_T, s);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i / 2) % 2;
      float d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = !edge || visible(pos[r], key_of(k0, i + e), s);
        const float p = ok ? exp2f(sc[i + e] * scale_log2 - lse2[r]) : 0.f;
        d2[e] = p * (dp[i + e] - dl[r]);
      }
      dsf[i / 2] = pack_bf16(d2[0], d2[1]);
    }
    wgmma_fence();
    issue_rs_wide<D>(acc, dsf, ks + st * W::TILE_B + cols);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    release(it);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (pos[r] >= s.S) continue;
    __nv_bfloat16* out = dq + ((static_cast<size_t>(b) * s.S + pos[r]) * s.H + h) * D +
                         wg * W::DW + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < W::DW / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) = __floats2bfloat162_rn(
          acc[4 * c + 2 * r] * s.scale, acc[4 * c + 2 * r + 1] * s.scale);
  }
}

// B: dK and dV of one (KV tile, KV head, batch row) over heads
// [G·g/GS, G·(g+1)/GS) of the group, g the block's rank in its cluster of
// GS; the cluster sums its partials.  In the Sᵀ accumulator rows are keys
// and columns queries.
template <int D>
__global__ void __launch_bounds__(Wg2<D>::THREADS, 1)
bwd_dkdv_wg2_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, Shape s, float scale_log2, int GS) {
  using W = Wg2<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ks = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t vs = ks + W::TILE_B;
  const uint32_t qs = vs + W::TILE_B;      // stage st at qs + st·TILE_B
  const uint32_t dos = qs + 2 * W::TILE_B;
  const uint32_t bar_kv = dos + 2 * W::TILE_B;   // K and V
  const uint32_t bar_s = bar_kv + 8;       // Q and dO of stage st at bar_s + 8·st
  // LSE·log2(e) and δ of the Q tile of stage st: [st][64] each
  float* lse_s = reinterpret_cast<float*>(smem_raw + (bar_s + 16 - smem_u32(smem_raw)));
  float* dl_s = lse_s + 2 * TC_T;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int k0 = blockIdx.x * TC_T, hk = blockIdx.y / GS, g = blockIdx.y % GS, b = blockIdx.z;
  const int h_lo = hk * s.G + s.G * g / GS;
  const int nh = hk * s.G + s.G * (g + 1) / GS - h_lo;   // at least 1: GS <= G
  const int qlo = query_lo(k0, s) / TC_T;
  const int nq = (query_hi(k0, TC_T, s) + TC_T - 1) / TC_T - qlo;   // at least 1
  const int n = nh * nq;

  // iteration it reads Q tile qlo + it % nq of head h_lo + it / nq from stage it % 2
  auto load_q = [&](int it) {
    const int st = it % 2, q0 = (qlo + it % nq) * TC_T, h = h_lo + it / nq;
    const uint32_t bar = bar_s + 8 * st;
    mbar_expect_tx(bar, 2 * W::TILE_B);
    load_tile<D>(qs + st * W::TILE_B, &tq, bar, h, q0, b);
    load_tile<D>(dos + st * W::TILE_B, &tdo, bar, h, q0, b);
  };
  // threads 0-63: the LSE·log2(e) and δ of query q0 + tid of iteration it
  // (rows past S: +inf and 0, so their P and dS are 0)
  auto fetch_ld = [&](int it, float& ls, float& dl) {
    const int q = (qlo + it % nq) * TC_T + tid, h = h_lo + it / nq;
    const size_t row = (static_cast<size_t>(b) * s.H + h) * s.S + q;
    ls = q < s.S ? __ldg(lse + row) : INFINITY;
    dl = q < s.S ? __ldg(delta + row) : 0.f;
  };
  if (tid == 0) {
    prefetch_tensormap(&tq);
    prefetch_tensormap(&tk);
    prefetch_tensormap(&tv);
    prefetch_tensormap(&tdo);
    for (int i = 0; i < 3; ++i) mbar_init(bar_kv + 8 * i, 1);
    mbar_fence_init();
  }
  if (tid < TC_T) fetch_ld(0, lse_s[tid], dl_s[tid]);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * W::TILE_B);
    load_tile<D>(ks, &tk, bar_kv, hk, k0, b);
    load_tile<D>(vs, &tv, bar_kv, hk, k0, b);
    load_q(0);
    if (n > 1) load_q(1);
  }

  const int r0 = 16 * warp + lane / 4;
  const int key[2] = {k0 + r0, k0 + r0 + 8};
  const uint32_t cols = wg * (W::NA / 2) * W::ATOM;
  float dka[D / 4], dva[D / 4], st_[32], dpt[32];
  zero(dka);
  zero(dva);
  uint32_t pf[16], dsf[16];
  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % 2, q0 = (qlo + it % nq) * TC_T;
    float next_ls = 0.f, next_dl = 0.f;
    if (tid < TC_T && it + 1 < n) fetch_ld(it + 1, next_ls, next_dl);
    mbar_wait(bar_s + 8 * st, (it / 2) & 1);
    zero(st_);
    zero(dpt);
    wgmma_fence();
    issue_ss_wide<D>(st_, ks, qs + st * W::TILE_B);
    issue_ss_wide<D>(dpt, vs, dos + st * W::TILE_B);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st_);
    fence_regs(dpt);
    const bool edge = edge_tile(q0, k0, TC_T, s);
    const float* ls = lse_s + st * TC_T;
    const float* dl = dl_s + st * TC_T;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i / 2) % 2;
      float p2[2], d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * (i / 4) + 2 * (lane % 4) + e;   // this column's query in the tile
        const bool ok = !edge || visible(q0 + c, key[r], s);
        p2[e] = ok ? exp2f(st_[i + e] * scale_log2 - ls[c]) : 0.f;
        d2[e] = p2[e] * (dpt[i + e] - dl[c]);
      }
      pf[i / 2] = pack_bf16(p2[0], p2[1]);
      dsf[i / 2] = pack_bf16(d2[0], d2[1]);
    }
    wgmma_fence();
    issue_rs_wide<D>(dva, pf, dos + st * W::TILE_B + cols);
    issue_rs_wide<D>(dka, dsf, qs + st * W::TILE_B + cols);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    // buffer (it + 1) % 2 was last read in iteration it - 1, before its barrier
    if (tid < TC_T && it + 1 < n) {
      lse_s[((it + 1) % 2) * TC_T + tid] = next_ls;
      dl_s[((it + 1) % 2) * TC_T + tid] = next_dl;
    }
    __syncthreads();                       // stage st is read by every warp
    if (tid == 0 && it + 2 < n) load_q(it + 2);
  }

  // The Q/dO ring is free (every copy issued was waited on): this block's
  // fp32 partials there, dK then dV, [2][64][D].
  float* part = reinterpret_cast<float*>(smem_raw + (qs - smem_u32(smem_raw)));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* pk = part + (r0 + 8 * r) * D + wg * W::DW + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < W::DW / 8; ++c) {
      *reinterpret_cast<float2*>(pk + 8 * c) = make_float2(dka[4 * c + 2 * r], dka[4 * c + 2 * r + 1]);
      *reinterpret_cast<float2*>(pk + TC_T * D + 8 * c) =
          make_float2(dva[4 * c + 2 * r], dva[4 * c + 2 * r + 1]);
    }
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                          // every partial of the cluster is written
  // block g: rows [128·g/GS, 128·(g+1)/GS) of the 128 (dK and dV) rows,
  // summed over the cluster's blocks in rank order, in 16-byte pieces
  const int row_lo = 2 * TC_T * g / GS, rows = 2 * TC_T * (g + 1) / GS - row_lo;
  for (int p = tid; p < rows * (D / 4); p += W::THREADS) {
    const int tr = row_lo + p / (D / 4), c = 4 * (p % (D / 4));
    float4 sum = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0) + tr * D + c);
    for (int j = 1; j < GS; ++j) {
      const float4 x =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, j) + tr * D + c);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const int kr = k0 + tr % TC_T;
    if (kr >= s.S) continue;
    const bool is_k = tr < TC_T;
    const float mul = is_k ? s.scale : 1.f;
    __nv_bfloat16* out = (is_k ? dk : dv) + ((static_cast<size_t>(b) * s.S + kr) * s.Hk + hk) * D + c;
    reinterpret_cast<__nv_bfloat162*>(out)[0] = __floats2bfloat162_rn(sum.x * mul, sum.y * mul);
    reinterpret_cast<__nv_bfloat162*>(out)[1] = __floats2bfloat162_rn(sum.z * mul, sum.w * mul);
  }
  cluster.sync();                          // no block leaves while its partial may be read
}

// Blocks of the dkdv kernel a KV head's group is split over: doubled from 1
// up to min(G, 4) while the grid has fewer than two blocks an SM.
int group_split(int blocks, int G, int sms) {
  int gs = 1;
  while (2 * gs <= G && 2 * gs <= 4 && blocks * gs < 2 * sms) gs *= 2;
  return gs;
}

template <int D>
int launch_wg2(const void* q, const void* k, const void* v, const void* dout, void* dq,
               void* dk, void* dv, float* lse, float* delta, int B, int S, int H, int Hk,
               int causal, int window, cudaStream_t stream) {
  using W = Wg2<D>;
  const Shape s{S, H, Hk, H / Hk, causal, window, static_cast<float>(1.0 / std::sqrt(double(D)))};
  const float scale_log2 = static_cast<float>(1.4426950408889634 / std::sqrt(double(D)));
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_bf16_4d(&tq, q, D, H, S, B, 64, 1, TC_T, 1) ||
      !encode_bf16_4d(&tk, k, D, Hk, S, B, 64, 1, TC_T, 1) ||
      !encode_bf16_4d(&tv, v, D, Hk, S, B, 64, 1, TC_T, 1) ||
      !encode_bf16_4d(&tdo, dout, D, H, S, B, 64, 1, TC_T, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // on every launch: the attribute belongs to the current device
  cudaError_t err = allow_smem(bwd_dq_wg2_kernel<D>, W::SMEM);
  if (err == cudaSuccess) err = allow_smem(bwd_dkdv_wg2_kernel<D>, W::SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (S + TC_T - 1) / TC_T;
  bwd_dq_wg2_kernel<D><<<dim3(nt, H, B), W::THREADS, W::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<__nv_bfloat16*>(dq), lse, delta, s, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int gs = group_split(nt * Hk * B, s.G, sms);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nt, Hk * gs, B);
  cfg.blockDim = dim3(W::THREADS);
  cfg.dynamicSmemBytes = W::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = gs;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bwd_dkdv_wg2_kernel<D>, tq, tk, tv, tdo,
                           static_cast<const float*>(lse), static_cast<const float*>(delta),
                           static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), s,
                           scale_log2, gs);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32: CUDA cores ------------------------------------------------------
// Rows of an fp32 tile (queries in A, keys in B): 32 or 64, the thread grid
// below.  benchmarks/torch_flash_bwd_tiles.py times a copy built with 32.
constexpr int FP_T = 64;

template <int BT>
struct Grid {
  static constexpr int THREADS = 4 * BT;   // a (BT/4) x 16 grid of threads
  static constexpr int TY = BT / 4;        // thread rows
  static constexpr int CB = BT / 16;       // score columns a thread
  static constexpr int PS = BT + 1;        // row pitch of a BT x BT tile in shared memory
};

// One BT x D tile in 16-byte pieces, D/16 a thread: fetched from global
// memory into registers, then stored widened into shared memory.
template <int D, int BT>
struct Pieces {
  static constexpr int N = D / 16;
  float4 v[N];

  // rows row0 .. row0 + BT - 1 of head `head` of a (B, S, n_heads, D)
  // tensor; rows past S as zeros
  __device__ __forceinline__ void fetch(const float* __restrict__ src, int b, int row0,
                                        int head, int n_heads, int S) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int p = threadIdx.x + Grid<BT>::THREADS * u, r = p / (D / 4), c = p % (D / 4);
      const int row = row0 + r;
      v[u] = row < S ? *reinterpret_cast<const float4*>(
                           src + ((static_cast<size_t>(b) * S + row) * n_heads + head) * D + 4 * c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // into dst[BT][D + 1]
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int p = threadIdx.x + Grid<BT>::THREADS * u, r = p / (D / 4), c = p % (D / 4);
      float* d = dst + r * (D + 1) + 4 * c;
      d[0] = v[u].x;
      d[1] = v[u].y;
      d[2] = v[u].z;
      d[3] = v[u].w;
    }
  }
};

// acc[a][b] = Σ_d A[ty + TY·a][d] · Bt[tx + 16b][d] over two tiles of pitch D + 1.
template <int D, int BT>
__device__ __forceinline__ void tile_dot(float (&acc)[4][Grid<BT>::CB], const float* A,
                                         const float* Bt, int ty, int tx) {
  constexpr int CB = Grid<BT>::CB, TY = Grid<BT>::TY;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[a][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[CB];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + TY * a) * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < CB; ++c) bv[c] = Bt[(tx + 16 * c) * (D + 1) + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
  }
}

// Over the 16 threads of one tile row (lanes 0-15 or 16-31 of a warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// P (if ps) and dS of one (Q tile, KV tile) pair into shared memory: rows
// are queries, columns keys.  lse_s/dl_s hold the Q tile's LSE and δ.
template <int D, int BT>
__device__ __forceinline__ void probs_and_dscores(float* ps, float* dss, const float* qs,
                                                  const float* ks, const float* dos,
                                                  const float* vs, const float* lse_s,
                                                  const float* dl_s, int q0, int k0, int ty,
                                                  int tx, const Shape& s) {
  using Gd = Grid<BT>;
  float sc[4][Gd::CB], dp[4][Gd::CB];
  tile_dot<D, BT>(sc, qs, ks, ty, tx);
  tile_dot<D, BT>(dp, dos, vs, ty, tx);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + Gd::TY * a;
#pragma unroll
    for (int c = 0; c < Gd::CB; ++c) {
      const int col = tx + 16 * c;
      const float p = visible(q0 + r, k0 + col, s) ? expf(sc[a][c] * s.scale - lse_s[r]) : 0.f;
      if (ps != nullptr) ps[r * Gd::PS + col] = p;
      dss[r * Gd::PS + col] = p * (dp[a][c] - dl_s[r]);
    }
  }
}

// A: dQ of one (Q tile, head, batch row), after a first pass that computes
// the rows' LSE and δ into lse_s/dl_s and the (B, H, S) scratch.
template <int D, int BT>
__global__ void __launch_bounds__(Grid<BT>::THREADS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ dq,
              Shape s) {
  using Gd = Grid<BT>;
  extern __shared__ float smem[];
  float* qs = smem;                        // [BT][D + 1] each
  float* dos = qs + BT * (D + 1);
  float* ks = dos + BT * (D + 1);
  float* vs = ks + BT * (D + 1);
  float* dss = vs + BT * (D + 1);          // [BT queries][PS]
  float* lse_s = dss + BT * Gd::PS;
  float* dl_s = lse_s + BT;
  const int nt = (s.S + BT - 1) / BT;
  const int q0 = (nt - 1 - static_cast<int>(blockIdx.x)) * BT;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / s.G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  constexpr int NC = D / 16;
  const int lo = key_lo(q0, s) / BT;
  const int n = (key_hi(q0, BT, s) + BT - 1) / BT - lo;   // at least 1
  {
    Pieces<D, BT> qr, dor;
    qr.fetch(q, b, q0, h, s.H, s.S);
    dor.fetch(dout, b, q0, h, s.H, s.S);
    qr.store(qs);
    dor.store(dos);
  }
  Pieces<D, BT> kr, vr;
  kr.fetch(k, b, lo * BT, hk, s.Hk, s.S);
  vr.fetch(v, b, lo * BT, hk, s.Hk, s.S);
  float m[4], l[4], acc[4], dq_acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
    acc[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[a][c] = 0.f;
  }
  // iterations 0 .. n-1: pass 1 (LSE and δ); n .. 2n-1: pass 2 (dQ)
  for (int it = 0; it < 2 * n; ++it) {
    const int k0 = (lo + it % n) * BT;
    __syncthreads();                       // the previous tiles are read
    kr.store(ks);
    vr.store(vs);
    __syncthreads();                       // this tile (and Q, dO, LSE, δ) in place
    if (it + 1 < 2 * n) {                  // the next tile, in flight while this one is used
      const int next = (lo + (it + 1) % n) * BT;
      kr.fetch(k, b, next, hk, s.Hk, s.S);
      vr.fetch(v, b, next, hk, s.Hk, s.S);
    }
    if (it < n) {
      float sc[4][Gd::CB], dp[4][Gd::CB];
      tile_dot<D, BT>(sc, qs, ks, ty, tx);
      tile_dot<D, BT>(dp, dos, vs, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = q0 + ty + Gd::TY * a;
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < Gd::CB; ++c) {
          sc[a][c] = visible(i, k0 + tx + 16 * c, s) ? sc[a][c] * s.scale : -INFINITY;
          mx = fmaxf(mx, sc[a][c]);
        }
        // every lane of the warp takes the shuffles; a row with no visible
        // key yet keeps m = -inf and l = acc = 0
        const float m_new = fmaxf(m[a], row_max(mx));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        float sum = 0.f, dsum = 0.f;
#pragma unroll
        for (int c = 0; c < Gd::CB; ++c) {
          const float e = expf(sc[a][c] - m_use);
          sum += e;
          dsum = fmaf(e, dp[a][c], dsum);
        }
        const float corr = m[a] == -INFINITY ? 0.f : expf(m[a] - m_use);
        l[a] = l[a] * corr + row_sum(sum);
        acc[a] = acc[a] * corr + row_sum(dsum);
        m[a] = m_new;
      }
      if (it == n - 1) {                   // read by pass 2 after the next barriers
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = ty + Gd::TY * a, i = q0 + r;
          const float lse_r = l[a] > 0.f ? m[a] + logf(l[a]) : INFINITY;
          const float dl_r = l[a] > 0.f ? acc[a] / l[a] : 0.f;
          if (tx == 0) {
            lse_s[r] = lse_r;
            dl_s[r] = dl_r;
            if (i < s.S) {
              const size_t row = (static_cast<size_t>(b) * s.H + h) * s.S + i;
              lse[row] = lse_r;
              delta[row] = dl_r;
            }
          }
        }
      }
    } else {
      probs_and_dscores<D, BT>(nullptr, dss, qs, ks, dos, vs, lse_s, dl_s, q0, k0, ty, tx, s);
      __syncthreads();
      // dQ[i][d] += Σ_j dS[i][j] K[j][d]
#pragma unroll 4
      for (int j = 0; j < BT; ++j) {
        float sa[4], kd[NC];
#pragma unroll
        for (int a = 0; a < 4; ++a) sa[a] = dss[(ty + Gd::TY * a) * Gd::PS + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) kd[c] = ks[j * (D + 1) + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < NC; ++c) dq_acc[a][c] = fmaf(sa[a], kd[c], dq_acc[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + Gd::TY * a;
    if (i >= s.S) continue;
    const size_t base = ((static_cast<size_t>(b) * s.S + i) * s.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[base + tx + 16 * c] = dq_acc[a][c] * s.scale;
  }
}

// B: dK and dV of one (KV tile, KV head, batch row), summed over the G heads of the group.
template <int D, int BT>
__global__ void __launch_bounds__(Grid<BT>::THREADS)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, Shape s) {
  using Gd = Grid<BT>;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BT * (D + 1);
  float* qs = vs + BT * (D + 1);
  float* dos = qs + BT * (D + 1);
  float* ps = dos + BT * (D + 1);          // [BT queries][PS]
  float* dss = ps + BT * Gd::PS;           // [BT queries][PS]
  float* lse_s = dss + BT * Gd::PS;
  float* dl_s = lse_s + BT;
  const int k0 = blockIdx.x * BT, hk = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  constexpr int NC = D / 16;
  const int qlo = query_lo(k0, s) / BT;
  const int nq = (query_hi(k0, BT, s) + BT - 1) / BT - qlo;   // at least 1
  const int n = s.G * nq;
  {
    Pieces<D, BT> kr, vr;
    kr.fetch(k, b, k0, hk, s.Hk, s.S);
    vr.fetch(v, b, k0, hk, s.Hk, s.S);
    kr.store(ks);
    vr.store(vs);
  }
  // iteration it: Q tile qlo + it % nq of head hk·G + it / nq, with its rows' LSE and δ
  Pieces<D, BT> qr, dor;
  float lse_r = 0.f, dl_r = 0.f;
  auto fetch = [&](int it) {
    const int q0 = (qlo + it % nq) * BT, h = hk * s.G + it / nq;
    qr.fetch(q, b, q0, h, s.H, s.S);
    dor.fetch(dout, b, q0, h, s.H, s.S);
    if (threadIdx.x < BT) {
      const int i = q0 + threadIdx.x;
      const size_t row = (static_cast<size_t>(b) * s.H + h) * s.S + i;
      lse_r = i < s.S ? lse[row] : INFINITY;
      dl_r = i < s.S ? delta[row] : 0.f;
    }
  };
  fetch(0);
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;
  for (int it = 0; it < n; ++it) {
    const int q0 = (qlo + it % nq) * BT;
    __syncthreads();                       // the previous pair's tiles are read
    qr.store(qs);
    dor.store(dos);
    if (threadIdx.x < BT) {
      lse_s[threadIdx.x] = lse_r;
      dl_s[threadIdx.x] = dl_r;
    }
    __syncthreads();
    if (it + 1 < n) fetch(it + 1);         // in flight while this pair is used
    probs_and_dscores<D, BT>(ps, dss, qs, ks, dos, vs, lse_s, dl_s, q0, k0, ty, tx, s);
    __syncthreads();
    // dV[j][d] += Σ_i P[i][j] dO[i][d];  dK[j][d] += Σ_i dS[i][j] Q[i][d]
#pragma unroll 4
    for (int i = 0; i < BT; ++i) {
      float pa[4], sa[4], od[NC], qd[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pa[a] = ps[i * Gd::PS + ty + Gd::TY * a];
        sa[a] = dss[i * Gd::PS + ty + Gd::TY * a];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        od[c] = dos[i * (D + 1) + tx + 16 * c];
        qd[c] = qs[i * (D + 1) + tx + 16 * c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv_acc[a][c] = fmaf(pa[a], od[c], dv_acc[a][c]);
          dk_acc[a][c] = fmaf(sa[a], qd[c], dk_acc[a][c]);
        }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + Gd::TY * a;
    if (j >= s.S) continue;
    const size_t base = ((static_cast<size_t>(b) * s.S + j) * s.Hk + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[base + tx + 16 * c] = dk_acc[a][c] * s.scale;
      dv[base + tx + 16 * c] = dv_acc[a][c];
    }
  }
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, const void* dout, void* dq,
                void* dk, void* dv, float* lse, float* delta, int B, int S, int H, int Hk,
                int causal, int window, cudaStream_t stream) {
  constexpr int BT = FP_T;
  const Shape s{S, H, Hk, H / Hk, causal, window, static_cast<float>(1.0 / std::sqrt(double(D)))};
  const int nt = (S + BT - 1) / BT;
  const size_t tile = BT * (D + 1) * sizeof(float);
  const size_t score = BT * Grid<BT>::PS * sizeof(float);
  const size_t sm_dq = 4 * tile + score + 2 * BT * sizeof(float);
  const size_t sm_dkdv = 4 * tile + 2 * score + 2 * BT * sizeof(float);
  // on every launch: the attribute belongs to the current device
  cudaError_t err = allow_smem(bwd_dq_kernel<D, BT>, sm_dq);
  if (err == cudaSuccess) err = allow_smem(bwd_dkdv_kernel<D, BT>, sm_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* df = static_cast<const float*>(dout);
  bwd_dq_kernel<D, BT><<<dim3(nt, H, B), Grid<BT>::THREADS, sm_dq, stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dq), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_kernel<D, BT><<<dim3(nt, Hk, B), Grid<BT>::THREADS, sm_dkdv, stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), s);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32 at D = 256: CUDA cores, tiles of 32 rows ------------------------
// The fp32 gate (1e-4 row-relative) needs full-fp32 products, so these
// kernels keep to the CUDA cores, with narrower tiles: 32 rows (queries in
// A, keys in B) by all 256 columns, rows padded by four floats so that a row starts
// on 16 bytes and a quarter-warp's float4 reads of eight rows fall on
// distinct banks.  A block's 256 threads form a 16 x 16 grid: thread
// (ty, tx) owns score rows ty + 16a and columns tx + 16c (a, c < 2) of a
// 32 x 32 tile, and rows ty + 16a, columns 4(tx + 16c) + e (c, e < 4) of a
// gradient tile; a row's max and sum reduce over its 16 threads (a half
// warp) with shuffles.  Tiles are loaded synchronously (no prefetch): a
// simple kernel that is right, two launches and no atomics as above.
constexpr int WD = 256;                  // the head width these kernels take
constexpr int WT = 32;                   // rows of a Q tile, keys of a KV tile
constexpr int W_THREADS = 256;
constexpr int WP = WD + 4;               // row pitch of a 32 x 256 tile in shared memory
constexpr int WSP = WT + 1;              // row pitch of a 32 x 32 score tile

// Rows row0 .. row0 + WT - 1 of head `head` of a (B, S, n_heads, WD) tensor
// into dst[WT][WP] as fp32, in 16-byte pieces; rows past S as zeros.
template <typename T>
__device__ __forceinline__ void wide_load(float* dst, const T* __restrict__ src, int b, int row0,
                                          int head, int n_heads, int S) {
  constexpr int PER = 16 / sizeof(T), ROW = WD / PER;
  for (int p = threadIdx.x; p < WT * ROW; p += W_THREADS) {
    const int r = p / ROW, c = (p % ROW) * PER, row = row0 + r;
    float* d = dst + r * WP + c;
    if (row < S) {
      store_widened(d, load_vec(src + ((static_cast<size_t>(b) * S + row) * n_heads + head) * WD + c),
                    T{});
    } else {
#pragma unroll
      for (int j = 0; j < PER; ++j) d[j] = 0.f;
    }
  }
}

// s[a][c] = Σ_d A[ty + 16a][d] · Bm[tx + 16c][d] over two tiles of pitch WP.
__device__ __forceinline__ void wide_dot(float (&s)[2][2], const float* A, const float* Bm,
                                         int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 2; ++a) s[a][0] = s[a][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < WD; d += 4) {
    float4 av[2], bv[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      av[a] = *reinterpret_cast<const float4*>(A + (ty + 16 * a) * WP + d);
      bv[a] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * a) * WP + d);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = s[a][c];
        x = fmaf(av[a].x, bv[c].x, x);
        x = fmaf(av[a].y, bv[c].y, x);
        x = fmaf(av[a].z, bv[c].z, x);
        s[a][c] = fmaf(av[a].w, bv[c].w, x);
      }
  }
}

// acc[a][4c + e] += x[a] · row[4(tx + 16c) + e] (row of pitch WP)
__device__ __forceinline__ void wide_axpy(float (&acc)[2][16], const float (&x)[2],
                                          const float* row, int tx) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 r4 = *reinterpret_cast<const float4*>(row + 4 * (tx + 16 * c));
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      acc[a][4 * c] = fmaf(x[a], r4.x, acc[a][4 * c]);
      acc[a][4 * c + 1] = fmaf(x[a], r4.y, acc[a][4 * c + 1]);
      acc[a][4 * c + 2] = fmaf(x[a], r4.z, acc[a][4 * c + 2]);
      acc[a][4 * c + 3] = fmaf(x[a], r4.w, acc[a][4 * c + 3]);
    }
  }
}

// rows row0 + ty + 16a (< S) of head `head` of a (B, S, n_heads, WD) output
template <typename T>
__device__ __forceinline__ void wide_store(T* __restrict__ dst, const float (&acc)[2][16],
                                           float mul, int b, int row0, int head, int n_heads,
                                           int S, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = row0 + ty + 16 * a;
    if (row >= S) continue;
    T* out = dst + ((static_cast<size_t>(b) * S + row) * n_heads + head) * WD;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[4 * (tx + 16 * c) + e] = from_float<T>(acc[a][4 * c + e] * mul);
  }
}

// A: dQ of one (Q tile, head, batch row), after a first pass that computes
// the rows' LSE and δ into lse_s/dl_s and the (B, H, S) scratch.
template <typename T>
__global__ void __launch_bounds__(W_THREADS)
bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, float* __restrict__ lse,
                   float* __restrict__ delta, T* __restrict__ dq, Shape s) {
  extern __shared__ float4 wide_smem[];
  float* qs = reinterpret_cast<float*>(wide_smem);
  float* dos = qs + WT * WP;
  float* ks = dos + WT * WP;
  float* vs = ks + WT * WP;
  float* dss = vs + WT * WP;               // [WT queries][WSP]
  float* lse_s = dss + WT * WSP;
  float* dl_s = lse_s + WT;
  const int nt = (s.S + WT - 1) / WT;
  const int q0 = (nt - 1 - static_cast<int>(blockIdx.x)) * WT;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / s.G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int lo = key_lo(q0, s) / WT;
  const int n = (key_hi(q0, WT, s) + WT - 1) / WT - lo;   // at least 1
  wide_load(qs, q, b, q0, h, s.H, s.S);
  wide_load(dos, dout, b, q0, h, s.H, s.S);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[2] = {0.f, 0.f};
  float dq_acc[2][16];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int x = 0; x < 16; ++x) dq_acc[a][x] = 0.f;
  // iterations 0 .. n-1: pass 1 (LSE and δ); n .. 2n-1: pass 2 (dQ)
  for (int it = 0; it < 2 * n; ++it) {
    const int k0 = (lo + it % n) * WT;
    __syncthreads();                       // the previous tiles are read
    wide_load(ks, k, b, k0, hk, s.Hk, s.S);
    wide_load(vs, v, b, k0, hk, s.Hk, s.S);
    __syncthreads();                       // this tile (and Q, dO, LSE, δ) in place
    float sc[2][2], dp[2][2];
    wide_dot(sc, qs, ks, ty, tx);
    wide_dot(dp, dos, vs, ty, tx);
    if (it < n) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int i = q0 + ty + 16 * a;
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sc[a][c] = visible(i, k0 + tx + 16 * c, s) ? sc[a][c] * s.scale : -INFINITY;
          mx = fmaxf(mx, sc[a][c]);
        }
        // a row with no visible key yet keeps m = -inf and l = acc = 0
        const float m_new = fmaxf(m[a], row_max(mx));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        float sum = 0.f, dsum = 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = expf(sc[a][c] - m_use);
          sum += e;
          dsum = fmaf(e, dp[a][c], dsum);
        }
        const float corr = m[a] == -INFINITY ? 0.f : expf(m[a] - m_use);
        l[a] = l[a] * corr + row_sum(sum);
        acc[a] = acc[a] * corr + row_sum(dsum);
        m[a] = m_new;
      }
      if (it == n - 1) {                   // read by pass 2 after the next barriers
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int r = ty + 16 * a, i = q0 + r;
          const float lse_r = l[a] > 0.f ? m[a] + logf(l[a]) : INFINITY;
          const float dl_r = l[a] > 0.f ? acc[a] / l[a] : 0.f;
          if (tx == 0) {
            lse_s[r] = lse_r;
            dl_s[r] = dl_r;
            if (i < s.S) {
              const size_t row = (static_cast<size_t>(b) * s.H + h) * s.S + i;
              lse[row] = lse_r;
              delta[row] = dl_r;
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = tx + 16 * c;
          const float p = visible(q0 + r, k0 + col, s) ? expf(sc[a][c] * s.scale - lse_s[r]) : 0.f;
          dss[r * WSP + col] = p * (dp[a][c] - dl_s[r]);
        }
      }
      __syncthreads();
      // dQ[i][d] += Σ_j dS[i][j] K[j][d]
#pragma unroll 4
      for (int j = 0; j < WT; ++j) {
        const float sa[2] = {dss[ty * WSP + j], dss[(ty + 16) * WSP + j]};
        wide_axpy(dq_acc, sa, ks + j * WP, tx);
      }
    }
  }
  wide_store(dq, dq_acc, s.scale, b, q0, h, s.H, s.S, ty, tx);
}

// B: dK and dV of one (KV tile, KV head, batch row), summed over the G heads
// of the group in the block.
template <typename T>
__global__ void __launch_bounds__(W_THREADS)
bwd_dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     Shape s) {
  extern __shared__ float4 wide_smem[];
  float* ks = reinterpret_cast<float*>(wide_smem);
  float* vs = ks + WT * WP;
  float* qs = vs + WT * WP;
  float* dos = qs + WT * WP;
  float* ps = dos + WT * WP;               // [WT queries][WSP]
  float* dss = ps + WT * WSP;              // [WT queries][WSP]
  float* lse_s = dss + WT * WSP;
  float* dl_s = lse_s + WT;
  const int k0 = blockIdx.x * WT, hk = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int qlo = query_lo(k0, s) / WT;
  const int nq = (query_hi(k0, WT, s) + WT - 1) / WT - qlo;   // at least 1
  wide_load(ks, k, b, k0, hk, s.Hk, s.S);
  wide_load(vs, v, b, k0, hk, s.Hk, s.S);
  float dk_acc[2][16], dv_acc[2][16];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int x = 0; x < 16; ++x) dk_acc[a][x] = dv_acc[a][x] = 0.f;
  // iteration it: Q tile qlo + it % nq of head hk·G + it / nq
  for (int it = 0; it < s.G * nq; ++it) {
    const int q0 = (qlo + it % nq) * WT, h = hk * s.G + it / nq;
    __syncthreads();                       // the previous pair's tiles are read
    wide_load(qs, q, b, q0, h, s.H, s.S);
    wide_load(dos, dout, b, q0, h, s.H, s.S);
    if (threadIdx.x < WT) {
      const int i = q0 + threadIdx.x;
      const size_t row = (static_cast<size_t>(b) * s.H + h) * s.S + i;
      lse_s[threadIdx.x] = i < s.S ? lse[row] : INFINITY;
      dl_s[threadIdx.x] = i < s.S ? delta[row] : 0.f;
    }
    __syncthreads();
    float sc[2][2], dp[2][2];
    wide_dot(sc, qs, ks, ty, tx);
    wide_dot(dp, dos, vs, ty, tx);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = tx + 16 * c;
        const float p = visible(q0 + r, k0 + col, s) ? expf(sc[a][c] * s.scale - lse_s[r]) : 0.f;
        ps[r * WSP + col] = p;
        dss[r * WSP + col] = p * (dp[a][c] - dl_s[r]);
      }
    }
    __syncthreads();
    // dV[j][d] += Σ_i P[i][j] dO[i][d];  dK[j][d] += Σ_i dS[i][j] Q[i][d]
#pragma unroll 2
    for (int i = 0; i < WT; ++i) {
      const float pa[2] = {ps[i * WSP + ty], ps[i * WSP + ty + 16]};
      const float sa[2] = {dss[i * WSP + ty], dss[i * WSP + ty + 16]};
      wide_axpy(dv_acc, pa, dos + i * WP, tx);
      wide_axpy(dk_acc, sa, qs + i * WP, tx);
    }
  }
  wide_store(dk, dk_acc, s.scale, b, k0, hk, s.Hk, s.S, ty, tx);
  wide_store(dv, dv_acc, 1.f, b, k0, hk, s.Hk, s.S, ty, tx);
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, const void* dout, void* dq,
                void* dk, void* dv, float* lse, float* delta, int B, int S, int H, int Hk,
                int causal, int window, cudaStream_t stream) {
  const Shape s{S, H, Hk, H / Hk, causal, window, static_cast<float>(1.0 / std::sqrt(double(WD)))};
  const int nt = (S + WT - 1) / WT;
  const size_t tile = WT * WP * sizeof(float), score = WT * WSP * sizeof(float);
  const size_t sm_dq = 4 * tile + score + 2 * WT * sizeof(float);
  const size_t sm_dkdv = 4 * tile + 2 * score + 2 * WT * sizeof(float);
  // on every launch: the attribute belongs to the current device
  cudaError_t err = allow_smem(bwd_dq_wide_kernel<T>, sm_dq);
  if (err == cudaSuccess) err = allow_smem(bwd_dkdv_wide_kernel<T>, sm_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* dt = static_cast<const T*>(dout);
  bwd_dq_wide_kernel<T><<<dim3(nt, H, B), W_THREADS, sm_dq, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dq), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_wide_kernel<T><<<dim3(nt, Hk, B), W_THREADS, sm_dkdv, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout, dq: (B, S, H, D); k, v, dk, dv: (B, S, Hk, D), all contiguous,
// 16-byte aligned (TMA's tiles and the fp32 kernels' 16-byte pieces) and of
// one dtype (0 float32, 1 bfloat16), D in {16, 32, 64, 256}; lse, delta:
// (B, H, S) float32 scratch.  window <= 0 means no window.  Two launches on
// `stream`; returns cudaGetLastError() after them (0 on success).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         void* lse, void* delta, int B, int S, int H, int Hk,
                                         int D, int dtype, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(delta);
  if (dtype == kFloat32) {
    switch (D) {
      case 16: return launch_fp32<16>(q, k, v, dout, dq, dk, dv, l, d, B, S, H, Hk, causal, window,
                                      st);
      case 32: return launch_fp32<32>(q, k, v, dout, dq, dk, dv, l, d, B, S, H, Hk, causal, window,
                                      st);
      case 64: return launch_fp32<64>(q, k, v, dout, dq, dk, dv, l, d, B, S, H, Hk, causal, window,
                                      st);
      case 256: return launch_wide<float>(q, k, v, dout, dq, dk, dv, l, d, B, S, H, Hk, causal,
                                          window, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == kBFloat16) {
    switch (D) {
      case 16: return launch_tc<16>(q, k, v, dout, dq, dk, dv, l, d, B, S, H, Hk, causal, window,
                                    st);
      case 32: return launch_tc<32>(q, k, v, dout, dq, dk, dv, l, d, B, S, H, Hk, causal, window,
                                    st);
      case 64: return launch_tc<64>(q, k, v, dout, dq, dk, dv, l, d, B, S, H, Hk, causal, window,
                                    st);
      case 256: return launch_wg2<256>(q, k, v, dout, dq, dk, dv, l, d, B, S, H, Hk, causal,
                                       window, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
