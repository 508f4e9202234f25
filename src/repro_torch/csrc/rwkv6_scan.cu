// RWKV6 ("Finch") WKV recurrence, hand-written for Hopper (sm_90a).
//
// Replaces: wkv6_pallas in src/repro/kernels/rwkv6_scan.py (the Pallas TPU
// kernel, body _kernel).  Same function, per (row b, head h), with an fp32
// (D, D) state S carried over the tokens:
//     o_t = r_t · (S + diag(u) k_tᵀ v_t),   S ← diag(w_t) S + k_tᵀ v_t
// r, k, v (B, T, H, D) and u (H, D) in the model dtype (float32 or
// bfloat16), w (B, T, H, D) in float32, state (B, H, D, D) float32; returns
// o (B, T, H, D) in the model dtype, rounded once, and the final state in
// float32.
//
// Unlike the TPU kernel, no exponent is clamped.  Within a chunk of C = 32
// tokens, with L the inclusive cumulative log-decay per channel, Le = L − lw
// its exclusive version and LC the chunk's total, every decay is exp of a
// non-positive number:
//     o_t  = Σ_d r_td e^{Le_td} S_de + Σ_{s<t} (Σ_d r_td k_sd e^{Le_td − L_sd}) v_s
//            + (Σ_d r_td u_d k_td) v_t
//     S_de ← e^{LC_d} S_de + ΔS_de,   ΔS_de = Σ_s k_sd e^{LC_d − L_sd} v_se
// so the result is exact to fp32 rounding for any w in (0, 1].  (The TPU
// kernel factors e^{Le_t − L_s} as e^{clip(Le_t)} · e^{clip(−L_s)}, clipped
// at ±30, which is wrong once a chunk's log-decay falls below −30; RWKV6's
// own decay init reaches −19 to −53 over a chunk of 32.)  No exponent is
// taken as a difference of two cumulative sums: with decays down to 1e-12
// those run to hundreds, where their fp32 rounding moves a decay near 1 by
// ~1e-4, and the outputs that far from the token-by-token oracle.  Each
// exponent is instead a sum of log-decays of one sign, over the chunk's
// groups of four tokens (the pair tiles' rows):
//     A_t  = Σ lw over t's group before t,   B_s = Σ lw over s's group after s,
//     P_g, Q_g = Σ group totals before, after g,  G_{g,h} = Σ those strictly
//     between h < g,
//     Le_t − L_s = (A_t + G) + B_s, or within one group the logs strictly
//                  between s and t (none, lw_{s+1}, or lw_{s+1} + lw_{s+2}),
//     Le_t = P_g + A_t,   LC − L_s = B_s + Q_g,   LC = Σ all totals,
// so each is within a few fp32 roundings of its own size, and the kernel's
// outputs stay within fp32's own error of the exact result (the plain
// version computes in float64).  A chunk cut short by the end of the
// sequence runs as if padded with w = 1 and r = k = v = 0.
//
// Two paths behind the one entry, chosen by the number of tokens.
//
// Prefill (T > 1): a chunk-parallel scan, wkv6_prefill_kernel, one block
// per (chunk, head, row): 2,560 blocks at RWKV6-3B's prefill, against 160
// in the kernel this one replaces, which walked a (row, head)'s 16 chunks
// in series inside one block.  Only two terms chain across chunks,
// S_c = e^{LC_c} ⊙ S_{c−1} + ΔS_c and the state read (r e^{Le}) S_{c−1};
// ΔS_c, e^{LC_c}, the pair scores and the bonus terms depend on the chunk's
// own tokens alone.  What bounds it on the H100: about 5·D² fp32 FLOPs per
// token and head (0.025 ms at RWKV6-3B's prefill, against 0.020 ms for the
// bytes of r, k, v, w and o) plus an ex2 per (pair, channel) on the SFU.
// The design:
//  * Tickets, not blockIdx, order the blocks: a block takes the next
//    ticket of an atomic counter, chunk-major, so the chunk it waits on
//    belongs to a block that is already running, and every wait ends.
//  * Everything that does not need the incoming state comes first: r, k, v
//    and log w staged with 16-byte loads by every warp, all of a thread's
//    loads in flight together, then the group sums by one thread a
//    channel; the pair scores over the 36 lower 4 × 4 (t, s)
//    tiles only (28 below the diagonal, 8 lanes each; 8 on it, 4 lanes
//    each, where s = t gives the bonus term), every loaded operand feeding
//    four pairs, each pair decay below the diagonal one ex2 of the
//    log2-scaled exponent (three ex2 a channel on it), a warp's items all
//    of one kind; then ΔS_c as a register-tiled
//    (D × C)·(C × D) product, 4 × 4 a thread.
//  * The chain step: after the pair scores thread 0 waits on the
//    predecessor's flag with an acquire load (by then it has nearly always
//    published), the block copies S_{c−1} from the (row, head)'s slot
//    into shared memory through L2 (cp.async, no registers held) while it
//    takes the decays and ΔS_c, then writes
//    S_c = e^{LC} S_{c−1} + ΔS_c (the product and the sum rounded apart)
//    to the other slot, or to the final state, and
//    publishes it with a fence and a release store.
//    Two slots a (row, head) suffice: a slot is rewritten only after the
//    block that read it has published.  The scratch is 2·D² floats a
//    (row, head), 5.2 MB at RWKV6-3B's prefill, against 42 MB for a slot a
//    chunk, and r, k, v, w are read once.
//  * Last, the output as one register-tiled pass over
//    [r e^{Le} | att] · [S_{c−1} ; V] (2 tokens × 4 columns a thread at
//    D = 64; a warp spans 8 tokens × 16 columns, and r's rows are padded
//    so its 8 token rows fall on distinct banks), the state, intra-chunk
//    and bonus terms summed apart, added in the plain version's order and
//    rounded once.
//  All products run on fp32 CUDA cores: TF32 tensor cores lose the state's
//  fp32 check.
//
// Step (T == 1): wkv6_step_kernel.  Bound by bytes: the fp32 state is read
// and written once (5.2 MB at B = 4, H = 40, D = 64: 0.0016 ms).  The
// padded chunk of one token reduces to
//     o_e = Σ_d r_d S_de + (Σ_d r_d u_d k_d) v_e,   S'_de = w'_d S_de + k_d v_e
// with w'_d = exp(log(clamp(w_d))), as the plain version gives it.  One
// warp per (row, head, 16 value columns); a lane holds 4 columns of D/8
// consecutive rows, loads them as 16-byte vectors all in flight before the
// first use, sums over d in registers and then by xor-shuffles across the
// warp, and writes S' back in 16-byte stores: S never passes through shared
// memory.
#include "common.cuh"

namespace {

constexpr int C = 32;      // tokens per chunk
constexpr int NT = 256;    // threads a prefill block
constexpr float LOG2E = 1.4426950408889634f;

// e^x for x ≤ 0 (a pair decay) as one ex2 on the SFU: relative error ~2^-22.
__device__ __forceinline__ float exp_nonpos(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * LOG2E));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }

// Stage the chunk's rows [0, n) of r, k, v (model dtype) and log(clamp(w))
// into shared memory as fp32 (r's rows RS apart, the others D apart), with
// zeros (and log w = 0, i.e. w = 1) for rows [n, C).  Every 16-byte load of
// a thread is issued before its first store.
template <typename T, int D, int RS>
__device__ __forceinline__ void stage_chunk(float* rs, float* ks, float* vs, float* lw,
                                            const T* r, const T* k, const T* v, const float* w,
                                            size_t row_stride, int n) {
  constexpr int VEC = Vec<T>::N, VPR = D / VEC, NV = (C * VPR + NT - 1) / NT;
  constexpr int WPR = D / 4, NW = (C * WPR + NT - 1) / NT;
  const int tid = threadIdx.x;
  uint4 rv[NV], kv[NV], vv[NV];
  float4 wv[NW];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = tid + j * NT, t = i / VPR, col = (i % VPR) * VEC;
    rv[j] = kv[j] = vv[j] = make_uint4(0u, 0u, 0u, 0u);
    if (i < C * VPR && t < n) {
      const size_t off = t * row_stride + col;
      rv[j] = load_vec(r + off);
      kv[j] = load_vec(k + off);
      vv[j] = load_vec(v + off);
    }
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int i = tid + j * NT, t = i / WPR, col = 4 * (i % WPR);
    wv[j] = make_float4(1.f, 1.f, 1.f, 1.f);
    if (i < C * WPR && t < n) wv[j] = *reinterpret_cast<const float4*>(w + t * row_stride + col);
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = tid + j * NT, t = i / VPR, col = (i % VPR) * VEC;
    if (i < C * VPR) {
      store_widened(rs + t * RS + col, rv[j], T());
      store_widened(ks + t * D + col, kv[j], T());
      store_widened(vs + t * D + col, vv[j], T());
    }
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int i = tid + j * NT, t = i / WPR, col = 4 * (i % WPR);
    if (i < C * WPR) {
      const float f[4] = {wv[j].x, wv[j].y, wv[j].z, wv[j].w};
      float l[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) l[x] = logf(fminf(fmaxf(f[x], 1e-12f), 1.f));
      *reinterpret_cast<float4*>(lw + t * D + col) = make_float4(l[0], l[1], l[2], l[3]);
    }
  }
}

template <int D>
struct Tiles {
  // pair scores: 4 × 4 (t, s) tiles, NQ lanes a tile below the diagonal
  // (D / NQ channels each, in float4 groups), NQ / 2 a tile on it
  static constexpr int NQ = D / 4 < 8 ? D / 4 : 8;
  static constexpr int NQD = NQ / 2;
  static constexpr int NOFF = (C / 4) * (C / 4 - 1) / 2;   // 28 tiles below the diagonal
  static constexpr int NITEM = NOFF * NQ + (C / 4) * NQD;
  // output product: TT tokens (NTG apart) × 4 columns a thread; a warp
  // covers 8 token groups × 4 column groups
  static constexpr int NEG = D / 4;
  static constexpr int NTG = NT / NEG < C ? NT / NEG : C;
  static constexpr int TT = C / NTG;
  static constexpr int RS = D + 4;     // row stride of r / q: 8 rows, 8 distinct bank groups
  static_assert(D % 16 == 0 && NITEM <= NT && NEG * NEG <= NT && NT % NEG == 0 && C % NTG == 0 &&
                    NTG % 8 == 0 && NEG % 4 == 0,
                "tiling");
};

// ---- prefill: one launch, chunks in ticket order ---------------------------

// A wait this long for the predecessor's state means a fault in the kernel:
// trap (the call then fails) rather than hang the card.
constexpr long long WAIT_LIMIT = 1ll << 32;   // cycles, ~2.4 s

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned x;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(x) : "l"(p) : "memory");
  return x;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned x) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(x) : "memory");
}

constexpr int NG = C / 4;                  // groups of four tokens a chunk
constexpr int NGP = NG * (NG - 1) / 2;     // pairs of groups h < g

template <int D>
struct PrefillSmem {
  float r[C * (D + 4)];    // r, then q = r_td e^{Le_td}; rows D + 4 apart
  float k[C * D];          // k, then kd = k_sd e^{LC_d − L_sd}
  float v[C * D];
  float A[C * D], B[C * D];   // A and B, then ΔS (D × D fits in their 2·C·D)
  float G[NGP * D];        // G[g (g − 1) / 2 + h]: Σ group totals strictly between h < g
  float P[NG * D], Q[NG * D];   // Σ group totals before, after g
  float S[(D > C ? D : C) * D];   // log w (C × D) until the pair scores end; then the
                                  // state entering the chunk (D × D)
  float attT[C * C];       // attT[s][t] = Σ_d r_td k_sd e^{Le_td − L_sd}, s < t; else 0
  float bonus[C];          // Σ_d r_td u_d k_td
  float u[D], eLC[D];
  unsigned ticket;
  static_assert(2 * C * D >= D * D, "ΔS reuses A and B");
};

// Channel d's log-decay sums, each over terms of one sign, from the logs
// staged in S: A_t and B_t within t's group, P_g and Q_g over the groups
// before and after g, G over the groups strictly between two, and e^{LC}.
template <int D>
__device__ __forceinline__ void log_decay_sums(int d, PrefillSmem<D>& sm) {
  float tot[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    float lw[4], a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) lw[i] = sm.S[(4 * g + i) * D + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sm.A[(4 * g + i) * D + d] = a;
      a += lw[i];
    }
#pragma unroll
    for (int i = 3; i >= 0; --i) {
      sm.B[(4 * g + i) * D + d] = b;
      b += lw[i];
    }
    tot[g] = a;
  }
  float p = 0.f, q = 0.f;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    sm.P[g * D + d] = p;
    p += tot[g];
  }
  sm.eLC[d] = expf(p);
#pragma unroll
  for (int g = NG - 1; g >= 0; --g) {
    sm.Q[g * D + d] = q;
    q += tot[g];
  }
#pragma unroll
  for (int g = 1; g < NG; ++g) {
    float x = 0.f;
#pragma unroll
    for (int h = g - 1; h >= 0; --h) {
      sm.G[(g * (g - 1) / 2 + h) * D + d] = x;
      x += tot[h];
    }
  }
}

// One item of the pair phase: tile (ti, sj) over the channels 4·dq + 4·NQX·j,
// summed into acc[a][b] for t = 4ti + a, s = 4sj + b.  Below the diagonal
// the exponent is (A_t + G) + B_s.  On it (DIAG, ti == sj) s == t takes u,
// s > t stays 0, and s < t takes the logs strictly between them, read from
// S's room: none (a decay of 1), lw_{s+1}, or lw_{s+1} + lw_{s+2}; a
// difference of two sums that include a large log would lose the decay's
// low bits.
template <int D, bool DIAG, int NQX>
__device__ __forceinline__ void pair_tile(const PrefillSmem<D>& sm, int ti, int sj, int dq,
                                          float (&acc)[4][4]) {
  const int gt = ti * (ti - 1) / 2 + sj;   // G's row of the pair of groups
#pragma unroll
  for (int j = 0; j < D / (4 * NQX); ++j) {
    const int d = 4 * dq + 4 * NQX * j;
    float4 kk[4], bs[4];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) kk[bb] = ld4(sm.k + (4 * sj + bb) * D + d);
    float g4[4], e1[4], e2[4], e12[4];   // below: G; on: u and the three decays
    if (DIAG) {
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) bs[bb] = make_float4(0.f, 0.f, 0.f, 0.f);   // unused
      const float4 uu = ld4(sm.u + d), l1 = ld4(sm.S + (4 * ti + 1) * D + d),
                   l2 = ld4(sm.S + (4 * ti + 2) * D + d);
      const float u4[4] = {uu.x, uu.y, uu.z, uu.w}, a1[4] = {l1.x, l1.y, l1.z, l1.w},
                  a2[4] = {l2.x, l2.y, l2.z, l2.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        g4[x] = u4[x];
        e1[x] = exp_nonpos(a1[x]);
        e2[x] = exp_nonpos(a2[x]);
        e12[x] = exp_nonpos(a1[x] + a2[x]);
      }
    } else {
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) bs[bb] = ld4(sm.B + (4 * sj + bb) * D + d);
      const float4 gg = ld4(sm.G + gt * D + d);
      g4[0] = gg.x; g4[1] = gg.y; g4[2] = gg.z; g4[3] = gg.w;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 rt = ld4(sm.r + (4 * ti + a) * (D + 4) + d);
      const float r4[4] = {rt.x, rt.y, rt.z, rt.w};
      float a4[4] = {};
      if (!DIAG) {
        const float4 at = ld4(sm.A + (4 * ti + a) * D + d);
        a4[0] = at.x; a4[1] = at.y; a4[2] = at.z; a4[3] = at.w;
      }
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        if (DIAG && bb > a) continue;
        const float k4[4] = {kk[bb].x, kk[bb].y, kk[bb].z, kk[bb].w};
        const float b4[4] = {bs[bb].x, bs[bb].y, bs[bb].z, bs[bb].w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float f;
          if (!DIAG)
            f = exp_nonpos((a4[x] + g4[x]) + b4[x]);
          else if (bb == a)
            f = g4[x];
          else if (a - bb == 1)
            f = 1.f;
          else if (a - bb == 2)
            f = bb == 0 ? e1[x] : e2[x];
          else
            f = e12[x];
          acc[a][bb] = fmaf(r4[x] * f, k4[x], acc[a][bb]);
        }
      }
    }
  }
}

// scratch: the two state slots of every (row, head), B·H × 2 × D·D floats,
// then B·H flags (chunks whose outgoing state is published) and the ticket
// counter, zeroed by wkv6_clear_kernel just before the launch.
template <typename T, int D>
__global__ void __launch_bounds__(NT, 3)
wkv6_prefill_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ w, const T* __restrict__ u,
                    const float* __restrict__ s0, T* __restrict__ o, float* __restrict__ sT,
                    float* slots, unsigned* sync, int T_len, int H, int n_chunks) {
  using K = Tiles<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PrefillSmem<D>& sm = *reinterpret_cast<PrefillSmem<D>*>(smem_raw);
  const int BH = gridDim.x / n_chunks;
  const int tid = threadIdx.x;
  // chunk-major tickets: a block waits only on a block with a smaller
  // ticket, which is already running, so every wait ends
  if (tid == 0) sm.ticket = atomicAdd(sync + BH, 1u);
  __syncthreads();
  const int c = sm.ticket / BH, bh = sm.ticket % BH;
  const int b = bh / H, h = bh % H;
  const int c0 = c * C;
  const int n = min(C, T_len - c0);
  const size_t stride = (size_t)H * D;
  const size_t base = ((size_t)b * T_len + c0) * stride + (size_t)h * D;

  // ---- stage r, k, v and log w; then one thread a channel takes the sums ----
  stage_chunk<T, D, K::RS>(sm.r, sm.k, sm.v, sm.S, r + base, k + base, v + base, w + base,
                           stride, n);
  for (int i = tid; i < C * C; i += NT) sm.attT[i] = 0.f;
  if (tid < D) sm.u[tid] = to_float(u[(size_t)h * D + tid]);
  __syncthreads();
  if (tid < D) log_decay_sums<D>(tid, sm);
  __syncthreads();

  // ---- pair scores: the 28 tiles below the diagonal first, NQ lanes each,
  // then the 8 on it, NQD lanes each; an item's lanes are adjacent ----
  {
    const int item = tid;
    const bool diag = item >= K::NOFF * K::NQ;
    const int nq = diag ? K::NQD : K::NQ;
    const int di = diag ? item - K::NOFF * K::NQ : item;
    const int tile = di / nq, dq = di % nq;
    int ti, sj;
    if (diag) {
      ti = sj = tile;
    } else {
      ti = 1;                                   // tile = ti (ti − 1) / 2 + sj, sj < ti
      while ((ti + 1) * ti / 2 <= tile) ++ti;
      sj = tile - ti * (ti - 1) / 2;
    }
    const bool live = item < K::NITEM && 4 * ti < n;
    float acc[4][4] = {};
    if (live) {
      if (diag)
        pair_tile<D, true, K::NQD>(sm, ti, sj, dq, acc);
      else
        pair_tile<D, false, K::NQ>(sm, ti, sj, dq, acc);
    }
#pragma unroll
    for (int off = 1; off < K::NQ; off <<= 1)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const float other = __shfl_xor_sync(0xffffffffu, acc[a][bb], off);
          if (off < nq) acc[a][bb] += other;
        }
    if (live && dq == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          if (!diag)
            sm.attT[(4 * sj + bb) * C + 4 * ti + a] = acc[a][bb];
          else if (bb < a)
            sm.attT[(4 * sj + bb) * C + 4 * ti + a] = acc[a][bb];
          else if (bb == a)
            sm.bonus[4 * ti + a] = acc[a][a];
        }
    }
  }
  // ---- wait for the state that enters this chunk (its predecessor has
  // usually published it by now), then load it while the decays and ΔS
  // are computed ----
  unsigned* flag = sync + bh;
  if (c > 0 && tid == 0) {
    const long long t0 = clock64();
    while (ld_acquire(flag) < (unsigned)c) {
      if (clock64() - t0 > WAIT_LIMIT) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
  constexpr int PER = (D * D / 4 + NT - 1) / NT;   // float4s of S a thread
  {
    const float* src = c == 0 ? s0 + (size_t)bh * D * D
                              : slots + ((size_t)bh * 2 + (c & 1)) * D * D;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * NT;
      if (i < D * D / 4) cp_async16(sm.S + 4 * i, src + 4 * i, 16);   // through L2
    }
  }

  // ---- decayed r and k in place; the chunk's state decay ----
  for (int i = tid; i < C * D; i += NT) {
    const int t = i / D, d = i % D, g = t / 4;
    sm.r[t * K::RS + d] *= expf(sm.P[g * D + d] + sm.A[i]);
    sm.k[i] *= expf(sm.B[i] + sm.Q[g * D + d]);
  }
  __syncthreads();

  // ---- ΔS[d][e] = Σ_s kd[s][d] v[s][e], 4 × 4 a thread, into A/B ----
  float* dS = sm.A;
  if (tid < K::NEG * K::NEG) {
    const int d0 = 4 * (tid / K::NEG), e0 = 4 * (tid % K::NEG);
    float acc[4][4] = {};
#pragma unroll 8
    for (int s = 0; s < C; ++s) {
      const float4 a = ld4(sm.k + s * D + d0), bv = ld4(sm.v + s * D + e0);
      const float av[4] = {a.x, a.y, a.z, a.w}, bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bb[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st4(dS + (d0 + i) * D + e0, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
  __syncthreads();
  // ---- S_out = e^{LC} S_in + ΔS to the next slot (the final state after
  // the last chunk), the product and the sum rounded apart; a thread reads
  // back only the S_in it copied ----
  cp_async_wait_all();
  {
    float* dst = c + 1 == n_chunks ? sT + (size_t)bh * D * D
                                   : slots + ((size_t)bh * 2 + ((c + 1) & 1)) * D * D;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * NT;
      if (i >= D * D / 4) break;
      const float4 x = ld4(sm.S + 4 * i), d4 = ld4(dS + 4 * i);
      const float a = sm.eLC[(4 * i) / D];
      __stcg(reinterpret_cast<float4*>(dst) + i,
             make_float4(__fadd_rn(__fmul_rn(a, x.x), d4.x), __fadd_rn(__fmul_rn(a, x.y), d4.y),
                         __fadd_rn(__fmul_rn(a, x.z), d4.z), __fadd_rn(__fmul_rn(a, x.w), d4.w)));
    }
  }
  __syncthreads();
  if (tid == 0 && c + 1 < n_chunks) {
    __threadfence();
    st_release(flag, (unsigned)(c + 1));
  }

  // ---- o = q S_in + att · V + bonus · v: TT tokens (NTG apart) × 4
  // columns a thread; the state, intra-chunk and bonus terms summed apart,
  // added in the plain version's order and rounded once ----
  if (tid < K::NTG * K::NEG) {
    constexpr int TT = K::TT, NTG = K::NTG;
    const int lane = tid % 32, warp = tid / 32;
    const int tg = (warp % (NTG / 8)) * 8 + lane % 8;
    const int e0 = 4 * ((warp / (NTG / 8)) * 4 + lane / 8);
    float acc_s[TT][4] = {}, acc_i[TT][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float a[TT][4];
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        const float4 f = ld4(sm.r + (tg + i * NTG) * K::RS + d);
        a[i][0] = f.x; a[i][1] = f.y; a[i][2] = f.z; a[i][3] = f.w;
      }
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const float4 s4 = ld4(sm.S + (d + dd) * D + e0);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int i = 0; i < TT; ++i)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc_s[i][x] = fmaf(a[i][dd], sv[x], acc_s[i][x]);
      }
    }
#pragma unroll 8
    for (int s = 0; s < C; ++s) {
      const float4 v4 = ld4(sm.v + s * D + e0);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        const float a = sm.attT[s * C + tg + i * NTG];
#pragma unroll
        for (int x = 0; x < 4; ++x) acc_i[i][x] = fmaf(a, vv[x], acc_i[i][x]);
      }
    }
#pragma unroll
    for (int i = 0; i < TT; ++i) {
      const int t = tg + i * NTG;
      if (t >= n) continue;
      const float4 vt = ld4(sm.v + t * D + e0);
      const float vv[4] = {vt.x, vt.y, vt.z, vt.w};
      T* dst = o + base + (size_t)t * stride + e0;
#pragma unroll
      for (int x = 0; x < 4; ++x)
        dst[x] = from_float<T>((acc_s[i][x] + acc_i[i][x]) + sm.bonus[t] * vv[x]);
    }
  }
}

// Zero the flags and the ticket counter of the prefill's scratch.
__global__ void wkv6_clear_kernel(unsigned* sync, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    sync[i] = 0u;
}

// ---- step: T == 1 ------------------------------------------------------------

constexpr int STEP_E = 16;   // value columns a step block

template <typename T, int D>
__global__ void __launch_bounds__(32)
wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ w, const T* __restrict__ u,
                 const float* __restrict__ s0, T* __restrict__ o, float* __restrict__ sT,
                 int H) {
  constexpr int QE = STEP_E / 4;      // lanes across a tile's columns
  constexpr int RG = 32 / QE;         // lanes down the rows
  constexpr int RPL = D / RG;         // consecutive rows a lane
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x;
  const int quad = lane % QE, rg = lane / QE;
  const int e0 = tile * STEP_E + 4 * quad, d0 = rg * RPL;
  const size_t row = ((size_t)b * H + h) * D;            // r, k, v, w of (b, 0, h)
  const size_t s_off = ((size_t)b * H + h) * D * D;

  // every load first: the state's 16-byte vectors, then the token's vectors
  float4 S[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) S[i] = ld4(s0 + s_off + (size_t)(d0 + i) * D + e0);
  float rr[RPL], kk[RPL], ww[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    rr[i] = to_float(r[row + d0 + i]);
    kk[i] = to_float(k[row + d0 + i]);
    ww[i] = w[row + d0 + i];
  }
  float vv[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) vv[x] = to_float(v[row + e0 + x]);
  float bonus = 0.f;
  for (int d = lane; d < D; d += 32)
    bonus += to_float(r[row + d]) * (to_float(u[(size_t)h * D + d]) * to_float(k[row + d]));
  bonus = warp_sum(bonus);

  float acc[4] = {};
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const float s4[4] = {S[i].x, S[i].y, S[i].z, S[i].w};
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[x] = fmaf(rr[i], s4[x], acc[x]);
  }
#pragma unroll
  for (int off = QE; off < 32; off <<= 1)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[x] += __shfl_xor_sync(0xffffffffu, acc[x], off);
  if (rg == 0) {
#pragma unroll
    for (int x = 0; x < 4; ++x) o[row + e0 + x] = from_float<T>(acc[x] + bonus * vv[x]);
  }
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const float wd = expf(logf(fminf(fmaxf(ww[i], 1e-12f), 1.f)));
    const float s4[4] = {S[i].x, S[i].y, S[i].z, S[i].w};
    float n4[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) n4[x] = __fadd_rn(__fmul_rn(wd, s4[x]), __fmul_rn(kk[i], vv[x]));
    st4(sT + s_off + (size_t)(d0 + i) * D + e0, make_float4(n4[0], n4[1], n4[2], n4[3]));
  }
}

// ---- launches ------------------------------------------------------------------

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* w, const void* u,
           const float* s0, void* o, float* sT, float* scratch, int B, int T_len, int H,
           cudaStream_t stream) {
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ut = static_cast<const T*>(u);
  T* ot = static_cast<T*>(o);
  if (T_len == 1) {
    const dim3 grid((D + STEP_E - 1) / STEP_E, H, B);
    wkv6_step_kernel<T, D><<<grid, 32, 0, stream>>>(rt, kt, vt, w, ut, s0, ot, sT, H);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int n_chunks = (T_len + C - 1) / C;
  unsigned* sync = reinterpret_cast<unsigned*>(scratch + (size_t)B * H * 2 * D * D);
  const int n_sync = B * H + 1;
  wkv6_clear_kernel<<<(n_sync + 255) / 256, 256, 0, stream>>>(sync, n_sync);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem = sizeof(PrefillSmem<D>);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(wkv6_prefill_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)n_chunks * B * H;
  wkv6_prefill_kernel<T, D><<<grid, NT, smem, stream>>>(rt, kt, vt, w, ut, s0, ot, sT, scratch,
                                                       sync, T_len, H, n_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* r, const void* k, const void* v, const float* w, const void* u,
             const float* s0, void* o, float* sT, float* scratch, int B, int T_len, int H, int D,
             cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, o, sT, scratch, B, T_len, H, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, o, sT, scratch, B, T_len, H, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, o, sT, scratch, B, T_len, H, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v: (B, T, H, D) of dtype (0 float32, 1 bfloat16); w: (B, T, H, D)
// float32; u: (H, D) of dtype; state: (B, H, D, D) float32; o: (B, T, H, D)
// of dtype; s_out: (B, H, D, D) float32; scratch: for T > 1, B·H·2·D·D + B·H
// + 1 words of 4 bytes (two state slots a (row, head), then the flags and
// the ticket counter, which a first small kernel zeroes); unused, and may be null, at
// T == 1.
// All contiguous and 16-byte aligned.  Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* state, void* o, void* s_out, void* scratch,
                          int B, int T_len, int H, int D, int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* s0 = static_cast<const float*>(state);
  float* sT = static_cast<float*>(s_out);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_d<float>(r, k, v, wf, u, s0, o, sT, sc, B, T_len, H, D, st);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(r, k, v, wf, u, s0, o, sT, sc, B, T_len, H, D, st);
  return (int)cudaErrorInvalidValue;
}
