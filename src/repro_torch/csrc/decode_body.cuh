// The body of one-token decode attention, shared by the paged kernel
// (paged_attention.cu, D in {16, 32, 64, 128, 192}) and the contiguous one
// (decode_attention.cu, D <= 64).  The two differ only in where the K/V row
// of a sequence position lies, which an address policy says: strides for a
// contiguous or horizon-view cache (ContiguousRows), a page-table lookup for
// the pool (PagedRows).
//
// Design, for one block per (KV head, batch row, slice of at most GMAX query
// heads):
//  * The row's positions split into NW contiguous ranges, one per warp.  A
//    K/V row of D elements is LPR = D / VEC lanes wide (VEC elements per
//    16-byte load), so one load instruction of a warp covers RPL = 32 / LPR
//    rows (bf16 at D = 64: 8 lanes a row, 4 rows a load; at D = 128 16 lanes
//    and 2 rows in bf16, the whole warp and 1 row in fp32).  A lane holds
//    VEC columns whatever D is, so its registers do not grow with D: a wider
//    row takes more lanes, fewer rows a load, and one more shuffle step.
//    A row whose D / VEC vectors do not tile a warp (D = 192: 24 in bf16,
//    48 in fp32) takes the whole warp instead, CPL = D / 32 = 6 columns a
//    lane, loaded with the widest accesses their offset allows (three 4-byte
//    loads in bf16, three 8-byte loads in fp32); the warp still reads the
//    row as one contiguous 384 or 768 bytes.
//  * A warp walks its range in sub-tiles of NL loads per lane.  Every K and
//    V load of a sub-tile is issued before any is used, so one memory
//    latency covers NL · RPL positions; the vectors stay in registers and are
//    widened to fp32 where they are used: no copy of K/V in shared memory and
//    no block barrier inside the loop.  fp32 needs twice the loads of bf16
//    for a row, so its sub-tile covers half the positions (the two passes of
//    the earlier design).  A position at or past the length, or one that
//    the policy masks (a sentinel page), is never loaded.
//  * A lane's dot product over its VEC columns is summed over the row's LPR
//    lanes by an xor-shuffle.  Each group of LPR lanes keeps its own online
//    softmax (m, l) and its share of P·V for its VEC columns, in the lanes
//    that hold V; all GB query heads of the slice score against each K row a
//    warp holds, so GQA reads the cache once per slice.
//  * After the loop the groups of a warp merge by xor-shuffle, and the
//    warps' (m, l, acc) merge once through shared memory.  fp32 throughout,
//    with the TPU kernels' finite NEG_INF: an empty range is (NEG_INF, 0, 0)
//    and a row with nothing to read gives acc / max(l, 1e-30) = 0.
//
// Next steps, not built: a split of the sequence across blocks with a
// last-block merge, for shapes with fewer (KV head, row) pairs than SMs
// (batch-1 serving); cp.async or TMA rings in place of register staging;
// the decode step as a CUDA graph, which removes the launch this kernel's
// time is mostly made of at serving shapes.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace decode_body {

constexpr int NW = 8;          // warps per block, each one range of positions
constexpr int NT = NW * 32;    // threads per block
constexpr int GMAX = 8;        // query heads a block handles at most

// The most query heads a block takes at width D: GMAX, or 4 above D = 128,
// where the warps' merge room (NW · GB · D floats) of eight heads would
// fill the 48 KB of static shared memory (Nemotron-4-340B's G = 12 at
// D = 192 then runs as 3 blocks a KV head).
constexpr int gmax(int D) { return D > 128 ? 4 : GMAX; }

// Query heads a block takes for a group of G at width D: the smallest of 1,
// 2, 4 and gmax(D) that holds G (capped at gmax(D), so a larger G runs
// several blocks a KV head).
inline int heads_per_block(int G, int D) {
  return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : gmax(D);
}

// Address policies: the element offset of position pos's K/V row from the
// (batch row, KV head) base pointer, or -1 where the position is not read.
struct ContiguousRows {
  long long ss;                  // sequence stride, in elements
  __device__ __forceinline__ long long operator()(int pos) const {
    return (long long)pos * ss;
  }
};

struct PagedRows {
  const int* table;              // the batch row's table, in shared memory
  int ps;                        // positions per page
  int n_pool;                    // pages in the pool; an entry outside [0, n_pool) is a sentinel
  long long pool_row;            // elements from one pool position to the next: Hk · D
  __device__ __forceinline__ long long operator()(int pos) const {
    const int page = table[pos / ps];
    return page >= 0 && page < n_pool ? ((long long)page * ps + pos % ps) * pool_row : -1;
  }
};

template <typename T, int D, int GB>
struct Tiling {
  static constexpr int VEC = Vec<T>::N;          // elements per 16-byte load
  // lanes a K/V row: D / VEC where those vectors tile a warp, else all 32
  static constexpr bool kTiles = D % VEC == 0 && D / VEC <= 32 && 32 % (D / VEC) == 0;
  static constexpr int LPR = kTiles ? D / VEC : 32;
  static constexpr int CPL = D / LPR;            // columns a lane: VEC, or 6 at D = 192
  static constexpr int RPL = 32 / LPR;           // rows a warp load instruction
  static constexpr int NL = GB <= 2 ? 8 : 4;     // K (and V) loads in flight a lane
  static constexpr int SUB = NL * RPL;           // positions a warp sub-tile
  static_assert(D % LPR == 0 && CPL * sizeof(T) % 4 == 0, "a row must tile a warp");
  static_assert(GB <= gmax(D), "the merge room of GB heads must fit the shared memory");
};

// A lane's CPL columns of one row as raw words, read with the widest loads
// their 16-, 8- or 4-byte alignment allows (one 16-byte load where CPL is
// VEC), and widened to fp32 where they are used.
template <int W> struct WordOf;
template <> struct WordOf<16> { using type = uint4; };
template <> struct WordOf<8> { using type = uint2; };
template <> struct WordOf<4> { using type = uint32_t; };

template <typename T, int CPL>
struct Chunk {
  static constexpr int BYTES = CPL * (int)sizeof(T);
  static constexpr int W = BYTES % 16 == 0 ? 16 : BYTES % 8 == 0 ? 8 : 4;   // bytes a load
  using Word = typename WordOf<W>::type;
  Word w[BYTES / W];
};

template <typename T, int CPL>
__device__ __forceinline__ Chunk<T, CPL> load_chunk(const T* p) {
  using C = Chunk<T, CPL>;
  C c;
  const typename C::Word* src = reinterpret_cast<const typename C::Word*>(p);
#pragma unroll
  for (int i = 0; i < C::BYTES / C::W; ++i) c.w[i] = src[i];
  return c;
}

template <int CPL>
__device__ __forceinline__ void widen(float* dst, const Chunk<float, CPL>& c) {
  const float* f = reinterpret_cast<const float*>(c.w);
#pragma unroll
  for (int j = 0; j < CPL; ++j) dst[j] = f[j];
}
template <int CPL>
__device__ __forceinline__ void widen(float* dst, const Chunk<__nv_bfloat16, CPL>& c) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(c.w);
#pragma unroll
  for (int j = 0; j < CPL / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}

// One query token of GB (ng live) heads against the first n positions of a
// sequence.  q and o point at the slice's first query head (heads D apart);
// kb and vb at the (batch row, KV head) base that rows() offsets.  Every
// thread of the block calls it.
template <typename T, int D, int GB, class Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q, const T* __restrict__ kb,
                                       const T* __restrict__ vb, const Rows rows, int n, int ng,
                                       float scale, T* __restrict__ o) {
  using Tl = Tiling<T, D, GB>;
  using C = Chunk<T, Tl::CPL>;
  constexpr int CPL = Tl::CPL, LPR = Tl::LPR, RPL = Tl::RPL, NL = Tl::NL;
  __shared__ float m_all[NW][GB], l_all[NW][GB];
  __shared__ __align__(16) float acc_all[NW][GB][D];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPR;              // the row this lane takes in each load
  const int col = (lane % LPR) * CPL;      // its first column

  float qf[GB][CPL], acc[GB][CPL], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = REPRO_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < CPL; ++e) {
      acc[g][e] = 0.f;
      qf[g][e] = 0.f;
    }
    if (g < ng) widen(qf[g], load_chunk<T, CPL>(q + g * D + col));
  }

  const int per = (n + NW - 1) / NW;       // positions a warp
  const int lo = min(n, warp * per);
  const int hi = min(n, lo + per);
  for (int base = lo; base < hi; base += Tl::SUB) {
    C kr[NL], vr[NL];
    bool live[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {       // every load of the sub-tile, then any use
      const int pos = base + i * RPL + grp;
      const long long off = pos < hi ? rows(pos) : -1;
      live[i] = off >= 0;
      kr[i] = C{};
      vr[i] = C{};
      if (live[i]) {
        kr[i] = load_chunk<T, CPL>(kb + off + col);
        vr[i] = load_chunk<T, CPL>(vb + off + col);
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < ng) {                        // uniform over the block
        float s[NL];
        float mx = REPRO_NEG_INF;
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          float kf[CPL];
          widen(kf, kr[i]);
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < CPL; ++e) dot += qf[g][e] * kf[e];
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          s[i] = live[i] ? dot * scale : REPRO_NEG_INF;
          mx = fmaxf(mx, s[i]);
        }
        const float m_new = fmaxf(m[g], mx);
        const float c = expf(m[g] - m_new);
        m[g] = m_new;
        l[g] *= c;
#pragma unroll
        for (int e = 0; e < CPL; ++e) acc[g][e] *= c;
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const float p = live[i] ? expf(s[i] - m_new) : 0.f;
          float vf[CPL];
          widen(vf, vr[i]);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < CPL; ++e) acc[g][e] += p * vf[e];
        }
      }
    }
  }

  // the warp's row groups merge by xor-shuffle (lanes LPR apart hold the
  // same columns of other rows), then the warps through shared memory
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < ng) {
        const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float m_new = fmaxf(m[g], m_o);
        const float c = expf(m[g] - m_new), c_o = expf(m_o - m_new);
        m[g] = m_new;
        l[g] = l[g] * c + l_o * c_o;
#pragma unroll
        for (int e = 0; e < CPL; ++e)
          acc[g][e] = acc[g][e] * c + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * c_o;
      }
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < ng) {
#pragma unroll
        for (int e = 0; e < CPL; ++e) acc_all[warp][g][col + e] = acc[g][e];
        if (lane == 0) {
          m_all[warp][g] = m[g];
          l_all[warp][g] = l[g];
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * D; i += NT) {
    const int g = i / D;
    const int d = i - g * D;
    float mx = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, m_all[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(m_all[w][g] - mx);
      lsum += l_all[w][g] * c;
      a += acc_all[w][g][d] * c;
    }
    o[i] = from_float<T>(a / fmaxf(lsum, 1e-30f));
  }
}

}  // namespace decode_body
