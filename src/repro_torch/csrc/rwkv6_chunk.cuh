// The WKV6 prefill's chunk block, shared by the forward (rwkv6_scan.cu) and
// the backward (rwkv6_scan_bwd.cu): the constants, the staging, the
// log-decay sums of one sign, the pair tiles and the block's body.  The
// arithmetic is described in rwkv6_scan.cu's header.  Each source includes
// this once, after common.cuh; everything here lies in an unnamed namespace.
#pragma once

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
// staged in sm.S (C rows D apart; written to sm.A, sm.B, sm.P, sm.Q, sm.G
// and sm.eLC, D apart): A_t and B_t within t's group, P_g and Q_g over the groups
// before and after g, G over the groups strictly between two, and e^{LC}.
template <int D, class Sm>
__device__ __forceinline__ void log_decay_sums(int d, Sm& sm) {
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

// The prefill's block, for wkv6_prefill_kernel (STATES false) and the
// backward's first launch, wkv6_bwd_states_kernel (STATES true).
// scratch: the two state slots of every (row, head), B·H × 2 × D·D floats,
// then B·H flags (chunks whose outgoing state is published) and the ticket
// counter, zero before the launch and left zero after it (the prefill's
// entry still zeroes them with wkv6_clear_kernel, as its scratch comes from
// the caching allocator).
// With STATES, the same chain with no outputs: the grid holds every chunk
// but the last, `slots` is the state entering each chunk, B·H × (n_chunks +
// 1) × D·D floats (the first of each (row, head) unused: it is s0, and s0
// null means zeros), and o and sT are unused.
template <typename T, int D, bool STATES>
__device__ __forceinline__ void
prefill_body(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
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
  if (tid == 0) {
    sm.ticket = atomicAdd(sync + BH, 1u);
    if (sm.ticket == gridDim.x - 1) sync[BH] = 0u;   // ready for the next launch
  }
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
  if constexpr (!STATES) {
    for (int i = tid; i < C * C; i += NT) sm.attT[i] = 0.f;
    if (tid < D) sm.u[tid] = to_float(u[(size_t)h * D + tid]);
  }
  __syncthreads();
  if (tid < D) log_decay_sums<D>(tid, sm);
  __syncthreads();

  // ---- pair scores: the 28 tiles below the diagonal first, NQ lanes each,
  // then the 8 on it, NQD lanes each; an item's lanes are adjacent ----
  if constexpr (!STATES) {
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
    const float* src;
    if constexpr (STATES)
      src = c > 0 ? slots + ((size_t)bh * (n_chunks + 1) + c) * D * D
                  : s0 == nullptr ? slots : s0 + (size_t)bh * D * D;
    else
      src = c == 0 ? s0 + (size_t)bh * D * D : slots + ((size_t)bh * 2 + (c & 1)) * D * D;
    const int bytes = STATES && c == 0 && s0 == nullptr ? 0 : 16;   // no state: zeros
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * NT;
      if (i < D * D / 4) cp_async16(sm.S + 4 * i, src + 4 * i, bytes);   // through L2
    }
  }

  // ---- decayed r and k in place; the chunk's state decay ----
  for (int i = tid; i < C * D; i += NT) {
    const int t = i / D, d = i % D, g = t / 4;
    if constexpr (!STATES) sm.r[t * K::RS + d] *= expf(sm.P[g * D + d] + sm.A[i]);
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
    float* dst;
    if constexpr (STATES)
      dst = slots + ((size_t)bh * (n_chunks + 1) + c + 1) * D * D;
    else
      dst = c + 1 == n_chunks ? sT + (size_t)bh * D * D
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
  // the last chunk's block has waited on the flag after every other block
  // of its (row, head), so none reads it again: ready for the next launch
  if (tid == 0 && c + 1 == n_chunks) *flag = 0u;
  if constexpr (STATES) return;

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

}  // namespace
