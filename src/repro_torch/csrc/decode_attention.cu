// Decode attention against a contiguous KV cache, hand-written for Hopper
// (sm_90a): one new query token per sequence.
//
// Replaces: decode_attention_pallas in src/repro/kernels/decode_attention.py
// (the Pallas TPU kernel, body _kernel).  Same function: q (B, 1, H, D)
// against k, v (B, Smax, Hk, D); row b attends the positions
// pos < min(lengths[b], Smax).  fp32 online softmax with the TPU kernel's
// finite NEG_INF, so a row with length 0 gives acc / max(l, 1e-30) = 0,
// never NaN.  k and v are addressed through their batch and sequence
// strides, so a horizon slice of a longer cache is read where it lies.
//
// What bounds it on the H100: at serving shapes, latency.  Each step reads
// each row's live K/V once, 4·D·Hk bytes per position in bf16, and does 4·D
// FLOPs per (query head, position): memory-bound in principle, but a serving
// step moves only a few MB, which the card's bandwidth clears in about a
// microsecond, so the launch and the dependent memory latencies set the time.
//
// What the design does about it, at D <= 64 (decode_body.cuh holds the body,
// shared with the paged kernel; here a K/V row lies at pos · Smax-stride):
//  * One block of NW = 8 warps per (KV head, batch row, slice of up to 8
//    query heads); all query heads of the slice share every K/V row the
//    block loads, so GQA reads the cache once per slice.
//  * Each warp takes a contiguous range of the row's positions and issues
//    all K/V loads of a sub-tile (32 positions at bf16 D = 64) before it uses
//    any, keeping them in registers: one memory latency covers the row at
//    serving lengths; no shared-memory staging and no barrier in the loop.
//    Rows at or past the length are never loaded.
//  * Scores by xor-shuffle within a row's lanes, the online softmax per row
//    group, P·V in the lanes that hold V; the warps merge once at the end.
//
// Wide heads (D = 128, 192, 256) take a second design, decode_wide_kernel below
// ("flash-decoding" in one launch), entered through
// repro_decode_attention_split.  The design above runs one block per (row,
// KV head, slice of at most 8 query heads): at RecurrentGemma-9B's decode
// (B = 4, Hk = 1) that lights 4 of 132 SMs, and under MQA with G = 16 it
// would read every row twice.  What bounds it on the H100 there: bytes.  A
// step reads each row's live K/V once, 8.4 MB at q (4, 1, 16, 256) against
// 2,048-slot rings, 2.5 µs at 3.35 TB/s; its 4·D FLOPs per (query head,
// position) are 3% of that time on the tensor cores.  What the design does:
//  * The sequence splits into pieces of at least two 16-position tiles, one
//    block of 4 warps each (grid: pieces × (KV heads · slices) × rows), at
//    most 64 pieces a row, in whole clusters of 8: 2,048 slots at B = 4 run
//    as 256 blocks, all resident at once.  A block takes up to 16 query
//    heads of its KV head, so the piece of K/V is read once for all of them.
//  * q (bf16) and the piece's tiles pass into shared memory by cp.async, one
//    commit group each, q first: tile i + 1 (and the refill of the stage
//    just read, in a ring of two stages) is in flight while tile i is
//    multiplied.  Positions at or past the length are zero-filled, never
//    read from memory; a piece past the length loads nothing.
//  * bf16: S = q·Kᵀ and O += P·V on the tensor cores with mma.sync
//    m16n8k16 (bf16 in, fp32 accumulate): the slice's 16 query heads are the
//    16 rows of A (G < 16 pads them with zeros, G > 16 takes more slices).
//    Each warp takes a quarter of D for S; the four partial score tiles meet
//    in shared memory, where every warp sums them at its own fragment's
//    places and takes the online softmax in registers (a row's four lanes
//    by xor-shuffle), so no warp waits on another's softmax.  P, rounded to
//    bf16 as the flash kernel rounds it while the row sums stay fp32, is
//    the A fragment of P·V where it lies in S's accumulators; each warp
//    takes a quarter of the columns of P·V.  wgmma is not the tool here:
//    its 64-row tile would leave 75% of its rows empty at G = 16.  fp32:
//    the same ring and merge, products exact in fp32 on CUDA cores (TF32
//    loses the fp32 checks).  At D = 192 (Nemotron-4-340B, 12 query heads a
//    KV head in one slice) a warp's quarter is 48 columns: three k16 steps
//    of S and six n8 tiles of P·V; the merge's column slices are 24 wide.
//  * The merge, in the same launch, in two levels of at most 8 partials.
//    Each block leaves its partial (m, l, acc) in fp32 in its own shared
//    memory; after a cluster barrier, block r of each cluster of 8 pieces
//    sums column slice r of the 8 partials, read from its peers' shared
//    memory, and writes it to the wrapper's scratch.  After a __threadfence
//    the last cluster to finish slice r (an atomic ticket a (row, KV head,
//    slice, column slice)) sums that slice of the clusters' partials and
//    writes the output; it zeroes its counter, so the kernel can be
//    launched again (and captured in a CUDA graph) on the same scratch.
//    Every load of a merge is in flight before the first is used.  An empty
//    piece is (−1e30, 0, 0), so a length-0 row merges to zeros.
//  * What sets its time on the card, by copies of this kernel with phases
//    cut out: the launch and the loads first, then the merge's barriers,
//    fence and atomic, then the two tiles' arithmetic in series.
#include <cooperative_groups.h>

#include <cstdint>

#include "decode_body.cuh"

namespace {

// One block an SM, as the paged kernel: no spill at eight query heads.
template <typename T, int D, int GB>
__global__ void __launch_bounds__(decode_body::NT, 1)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lengths, T* __restrict__ o, int S, int Hk, int G,
              int n_gsplit, long long bs, long long ss, float scale) {
  const int h = blockIdx.x / n_gsplit;               // KV head
  const int g0 = (blockIdx.x % n_gsplit) * GB;       // first query head of the slice
  const int b = blockIdx.y;
  const size_t q_off = ((size_t)b * Hk * G + (size_t)h * G + g0) * D;
  const size_t kv_off = (size_t)b * bs + (size_t)h * D;
  decode_body::attend<T, D, GB>(q + q_off, k + kv_off, v + kv_off,
                                decode_body::ContiguousRows{ss},
                                max(0, min(lengths[b], S)), min(GB, G - g0), scale, o + q_off);
}

template <typename T, int D, int GB>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o, int B,
           int Hk, int G, int S, long long bs, long long ss, cudaStream_t stream) {
  const int n_gsplit = (G + GB - 1) / GB;
  const dim3 grid(Hk * n_gsplit, B);
  decode_kernel<T, D, GB><<<grid, decode_body::NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(o), S, Hk, G, n_gsplit, bs, ss, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_g(const void* q, const void* k, const void* v, const int* lengths, void* o, int B,
             int Hk, int G, int S, long long bs, long long ss, cudaStream_t stream) {
  switch (decode_body::heads_per_block(G, D)) {
    case 1:
      return launch<T, D, 1>(q, k, v, lengths, o, B, Hk, G, S, bs, ss, stream);
    case 2:
      return launch<T, D, 2>(q, k, v, lengths, o, B, Hk, G, S, bs, ss, stream);
    case 4:
      return launch<T, D, 4>(q, k, v, lengths, o, B, Hk, G, S, bs, ss, stream);
    default:
      return launch<T, D, decode_body::gmax(D)>(q, k, v, lengths, o, B, Hk, G, S, bs, ss,
                                                stream);
  }
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const int* lengths, void* o, int B,
             int Hk, int G, int D, int S, long long bs, long long ss, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_g<T, 16>(q, k, v, lengths, o, B, Hk, G, S, bs, ss, stream);
    case 32:
      return launch_g<T, 32>(q, k, v, lengths, o, B, Hk, G, S, bs, ss, stream);
    case 64:
      return launch_g<T, 64>(q, k, v, lengths, o, B, Hk, G, S, bs, ss, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---- wide heads: D = 128, 192, 256, split over the sequence -------------
constexpr int WNT = 128;        // threads a block: 4 warps
constexpr int WNW = WNT / 32;
constexpr int WTILE = 16;       // positions a tile: one k16 step of P·V
constexpr int WG = 16;          // query heads a slice: the 16 rows of an m16n8k16 A
constexpr int WCL = 8;          // blocks a cluster: the pieces a first-level merge takes
constexpr int WMAX_PIECES = 64; // pieces a row at most: at most 8 clusters a row

// Pieces of the sequence a (row, KV head, slice) is split into, and the
// tiles a piece takes: at least two tiles, so the second is in flight while
// the first is multiplied; at most WMAX_PIECES pieces, so the second merge
// level reads at most 8 partials; a multiple of WCL pieces, so clusters
// tile the row (pieces past the sequence are empty).
__host__ __device__ inline int wide_tiles_per_piece(int S) {
  const int n_tiles = (S + WTILE - 1) / WTILE;
  return max(2, (n_tiles + WMAX_PIECES - 1) / WMAX_PIECES);
}
__host__ __device__ inline int wide_pieces(int S) {
  const int per = wide_tiles_per_piece(S) * WTILE;
  const int n = max(1, (S + per - 1) / per);
  return (n + WCL - 1) / WCL * WCL;
}

// m16n8k16, bf16 in, fp32 accumulate: d += a · b.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <typename T, int D>
struct WideSmem {
  static constexpr bool kTC = sizeof(T) == 2;        // bf16: tensor cores
  static constexpr int KS = D + 16 / (int)sizeof(T); // padded K/V row, elements
  T k[2][WTILE * KS], v[2][WTILE * KS];              // the two stages of the ring
  T qb[kTC ? WG * KS : 1];                           // bf16 route: q, rows KS apart
  // bf16: the four warps' partial scores (each over a quarter of D), rows
  // padded against bank conflicts; fp32: the tile's scores, then P
  alignas(16) float sp[kTC ? WNW : 1][WG][WTILE + 4];
  // fp32 route only: q widened, and each head's rescale
  alignas(16) float qs[kTC ? 4 : WG * D];
  float c[WG];
  float m[WG], l[WG];                                // each head's running max and sum
  int last;
  // after the tiles: the block's acc (WG × D fp32) in the ring's room
  static_assert(sizeof(T) * 4 * WTILE * KS >= sizeof(float) * WG * D, "acc fits the ring");
  __device__ float* acc() { return reinterpret_cast<float*>(&k[0][0]); }
};

// One merge item: four columns of one head over n <= WCL partials (m, l,
// acc), every load in flight before the first use.  Returns the rescaled sum
// of the accs and sets the merged max and sum.
template <typename ML, typename ACC>
__device__ __forceinline__ float4 merge_item(int n, ML ml_of, ACC acc_of, float& mx,
                                             float& lsum) {
  float2 ml[WCL];
  float4 x[WCL];
#pragma unroll
  for (int j = 0; j < WCL; ++j) {
    if (j < n) {
      ml[j] = ml_of(j);
      x[j] = acc_of(j);
    }
  }
  mx = REPRO_NEG_INF;
#pragma unroll
  for (int j = 0; j < WCL; ++j)
    if (j < n) mx = fmaxf(mx, ml[j].x);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  lsum = 0.f;
#pragma unroll
  for (int j = 0; j < WCL; ++j) {
    if (j < n) {
      const float f = expf(ml[j].x - mx);
      lsum += f * ml[j].y;
      a.x += f * x[j].x;
      a.y += f * x[j].y;
      a.z += f * x[j].z;
      a.w += f * x[j].w;
    }
  }
  return a;
}

// One block per (piece of the sequence, KV head and slice of up to WG query
// heads, row); the WCL pieces of a cluster are consecutive.  scratch, in fp32
// words: the clusters' partials, acc (R, NGR, WG, D) then (m, l) (R, NGR,
// WCL, WG, 2), a copy for each column slice, so the block that counts a
// slice has written its own; then R · WCL counters, one a column slice,
// zero between launches (R = rows · KV heads · slices, NGR = pieces / WCL).
template <typename T, int D>
__global__ void __cluster_dims__(WCL, 1, 1) __launch_bounds__(WNT, 2)
decode_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ lengths, T* __restrict__ o, float* scratch, int S,
                   int Hk, int G, int n_gs, long long bs, long long ss, float scale) {
  using SM = WideSmem<T, D>;
  constexpr bool kTC = SM::kTC;
  constexpr int KS = SM::KS;
  constexpr int VEC = Vec<T>::N, VPR = D / VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SM& sm = *reinterpret_cast<SM*>(smem_raw);

  const int piece = blockIdx.x, n_pieces = gridDim.x;
  const int h = blockIdx.y / n_gs, gs = blockIdx.y % n_gs;
  const int b = blockIdx.z;
  const int rs = (b * Hk + h) * n_gs + gs;     // (row, KV head, slice), flat
  const int g0 = gs * WG, ng = min(WG, G - g0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tpp = wide_tiles_per_piece(S);
  const int p0 = piece * tpp * WTILE;
  const int len = max(0, min(lengths[b], S));
  const int live = max(0, min(tpp * WTILE, len - p0));   // live positions of the piece
  const int n_tiles = (live + WTILE - 1) / WTILE;
  const size_t head0 = ((size_t)b * Hk + h) * G + g0;     // first query head of the slice, flat
  const T* kb = k + (size_t)b * bs + (size_t)h * D;
  const T* vb = v + (size_t)b * bs + (size_t)h * D;

  // the ring: tile i of the piece into stage i & 1, one cp.async group a tile;
  // positions past the length are zero-filled and never read from memory
  auto issue = [&](int i) {
    const int t0 = p0 + i * WTILE;
    for (int idx = tid; idx < WTILE * VPR; idx += WNT) {
      const int r = idx / VPR, col = (idx % VPR) * VEC;
      const bool ok = t0 + r < len;
      const size_t off = ok ? (size_t)(t0 + r) * ss + col : 0;
      cp_async16(sm.k[i & 1] + r * KS + col, kb + off, ok ? 16 : 0);
      cp_async16(sm.v[i & 1] + r * KS + col, vb + off, ok ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // q into shared memory: bf16 by cp.async in its own commit group, first
  // (rows past ng zero-filled), its A fragments read from there; fp32
  // widened after the tiles are asked for
  constexpr int KQ = D / 16;                     // k16 steps over D
  const int gr = lane / 4, tg = lane % 4;        // fragment row group, thread in group
  if constexpr (kTC) {
    for (int idx = tid; idx < WG * VPR; idx += WNT) {
      const int row = idx / VPR, col = (idx % VPR) * VEC;
      cp_async16(sm.qb + row * KS + col, q + (head0 + (row < ng ? row : 0)) * D + col,
                 row < ng ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  if (n_tiles > 0) issue(0);
  if (n_tiles > 1) issue(1);
  if constexpr (!kTC) {
    for (int i = tid; i < WG * D; i += WNT)
      sm.qs[i] = i / D < ng ? to_float(q[head0 * D + i]) : 0.f;
  }

  if (!kTC && tid < WG) {
    sm.m[tid] = REPRO_NEG_INF;
    sm.l[tid] = 0.f;
  }
  float mr[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, lr[2] = {0.f, 0.f};   // bf16: rows gr, gr + 8

  // P·V accumulators: bf16, this warp's quarter of the columns as n8 tiles
  // (rows gr and gr + 8); fp32, HPT items of (head, 4 columns), item j the
  // (tid + j · WNT)-th of the WG · D / 4 items in (head, column) order: at
  // D = 128 and 256 a thread's items share their columns, at D = 192 they
  // do not (48 column groups do not divide the 128 threads)
  constexpr int NT8 = D / WNW / 8;
  constexpr int D4 = D / 4, HPT = WG * D4 / WNT;
  static_assert(kTC || WG * D4 % WNT == 0, "the fp32 items must share out evenly");
  auto item_head = [&](int j) { return (tid + j * WNT) / D4; };
  auto item_col = [&](int j) { return ((tid + j * WNT) % D4) * 4; };
  float acc[kTC ? NT8 : HPT][4];
#pragma unroll
  for (int j = 0; j < (kTC ? NT8 : HPT); ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    // groups in order: q (bf16), tile 0, tile 1, then each refill; at tile i
    // only tile i + 1 may stay in flight
    if (i + 1 < n_tiles)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const T* ks = sm.k[i & 1];
    const T* vs = sm.v[i & 1];
    const int cnt = min(WTILE, live - i * WTILE);

    if constexpr (kTC) {
      // S = q · Kᵀ of the tile: each warp over its quarter of D, the four
      // partials summed through shared memory by every warp at its own
      // fragment's places (rows gr and gr + 8, positions n8 · 8 + tg · 2 +
      // {0, 1}), so each warp holds the whole tile's scores and takes the
      // softmax itself
      float s4[2][4];
      const T* qr = sm.qb + gr * KS + tg * 2 + warp * (D / WNW);
#pragma unroll
      for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) s4[n8][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KQ / WNW; ++s) {
        const uint32_t qa[4] = {ld_u32(qr + s * 16), ld_u32(qr + 8 * KS + s * 16),
                                ld_u32(qr + s * 16 + 8), ld_u32(qr + 8 * KS + s * 16 + 8)};
#pragma unroll
        for (int n8 = 0; n8 < 2; ++n8) {
          const T* kr = ks + (n8 * 8 + gr) * KS + tg * 2 + warp * (D / WNW) + s * 16;
          mma_16816(s4[n8], qa, ld_u32(kr), ld_u32(kr + 8));
        }
      }
#pragma unroll
      for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(&sm.sp[warp][gr + 8 * r][n8 * 8 + tg * 2]) =
              make_float2(s4[n8][2 * r], s4[n8][2 * r + 1]);
      __syncthreads();
#pragma unroll
      for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float2 t = make_float2(0.f, 0.f);
#pragma unroll
          for (int w = 0; w < WNW; ++w) {
            const float2 x =
                *reinterpret_cast<const float2*>(&sm.sp[w][gr + 8 * r][n8 * 8 + tg * 2]);
            t.x += x.x;
            t.y += x.y;
          }
          s4[n8][2 * r] = t.x;
          s4[n8][2 * r + 1] = t.y;
        }
      // online softmax in registers; the four lanes of a row group share a row
      float cr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x[4], mx = REPRO_NEG_INF;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = (e / 2) * 8 + tg * 2 + e % 2;
          x[e] = pos < cnt ? s4[e / 2][2 * r + e % 2] * scale : REPRO_NEG_INF;
          mx = fmaxf(mx, x[e]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(mr[r], mx);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = (e / 2) * 8 + tg * 2 + e % 2;
          const float p = pos < cnt ? expf(x[e] - m_new) : 0.f;
          s4[e / 2][2 * r + e % 2] = p;
          sum += p;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        cr[r] = expf(mr[r] - m_new);
        lr[r] = lr[r] * cr[r] + sum;
        mr[r] = m_new;
      }
      // P, rounded to bf16, is the A fragment of P · V as it lies in S's
      // accumulators; O = c · O + P · V over this warp's quarter of the columns
      uint32_t pa[4];
      pa[0] = pack2(__float2bfloat16_rn(s4[0][0]), __float2bfloat16_rn(s4[0][1]));
      pa[1] = pack2(__float2bfloat16_rn(s4[0][2]), __float2bfloat16_rn(s4[0][3]));
      pa[2] = pack2(__float2bfloat16_rn(s4[1][0]), __float2bfloat16_rn(s4[1][1]));
      pa[3] = pack2(__float2bfloat16_rn(s4[1][2]), __float2bfloat16_rn(s4[1][3]));
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int col = warp * (D / WNW) + j * 8 + gr;
        const T* v0 = vs + (tg * 2) * KS + col;
        const uint32_t b0 = pack2(v0[0], v0[KS]);
        const uint32_t b1 = pack2(v0[8 * KS], v0[9 * KS]);
        acc[j][0] *= cr[0];
        acc[j][1] *= cr[0];
        acc[j][2] *= cr[1];
        acc[j][3] *= cr[1];
        mma_16816(acc[j], pa, b0, b1);
      }
    } else {
      // fp32: the block's threads score (head, position) pairs from shared
      // memory, warp 0 takes the softmax, every thread 4 columns of P · V
      for (int idx = tid; idx < WG * WTILE; idx += WNT) {
        const int hh = idx / WTILE, p = idx % WTILE;
        float dot = 0.f;
        for (int d = 0; d < D; d += 4) {
          const float4 a = *reinterpret_cast<const float4*>(sm.qs + hh * D + d);
          const float4 kk = *reinterpret_cast<const float4*>(ks + p * KS + d);
          dot += a.x * kk.x + a.y * kk.y + a.z * kk.z + a.w * kk.w;
        }
        sm.sp[0][hh][p] = dot;
      }
      __syncthreads();
      if (warp == 0) {       // lane → head lane / 2, positions (lane % 2) · 8 + j
        const int hh = lane / 2, p8 = (lane % 2) * 8;
        float sv[8], mx = REPRO_NEG_INF;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sv[j] = p8 + j < cnt ? sm.sp[0][hh][p8 + j] * scale : REPRO_NEG_INF;
          mx = fmaxf(mx, sv[j]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        const float m_old = sm.m[hh], m_new = fmaxf(m_old, mx);
        float lsum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = p8 + j < cnt ? expf(sv[j] - m_new) : 0.f;
          lsum += p;
          sm.sp[0][hh][p8 + j] = p;
        }
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
        if (lane % 2 == 0) {
          const float c = expf(m_old - m_new);
          sm.c[hh] = c;
          sm.l[hh] = sm.l[hh] * c + lsum;
          sm.m[hh] = m_new;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < HPT; ++j) {
        const float c = sm.c[item_head(j)];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= c;
      }
      for (int p = 0; p < WTILE; ++p) {
        const T* vrow = vs + p * KS;
        const float4 v0 = *reinterpret_cast<const float4*>(vrow + item_col(0));
#pragma unroll
        for (int j = 0; j < HPT; ++j) {
          const float4 vv = WNT % D4 == 0
                                ? v0
                                : *reinterpret_cast<const float4*>(vrow + item_col(j));
          const float pp = sm.sp[0][item_head(j)][p];
          acc[j][0] += pp * vv.x;
          acc[j][1] += pp * vv.y;
          acc[j][2] += pp * vv.z;
          acc[j][3] += pp * vv.w;
        }
      }
    }
    __syncthreads();              // the stage is read; refill it
    if (i + 2 < n_tiles) issue(i + 2);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");   // q, where no tile was live

  // this piece's partial (m, l, acc) into the ring's room (its tiles are
  // read); an empty piece is (NEG_INF, 0, 0)
  float* pacc = sm.acc();
  if constexpr (kTC) {
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      const int col = warp * (D / WNW) + j * 8 + tg * 2;
      *reinterpret_cast<float2*>(pacc + gr * D + col) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(pacc + (gr + 8) * D + col) = make_float2(acc[j][2], acc[j][3]);
    }
    if (warp == 0 && tg == 0) {
      sm.m[gr] = mr[0];
      sm.l[gr] = lr[0];
      sm.m[gr + 8] = mr[1];
      sm.l[gr + 8] = lr[1];
    }
  } else {
#pragma unroll
    for (int j = 0; j < HPT; ++j)
      *reinterpret_cast<float4*>(pacc + item_head(j) * D + item_col(j)) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }

  // first level, in the cluster: block r sums column slice r of its WCL
  // pieces' partials, read from their shared memory, a thread an item of
  // four columns of one head
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                       // every partial of the cluster is written
  constexpr int SC = D / WCL;           // columns a slice
  const int r = (int)cluster.block_rank();
  const int n_groups = n_pieces / WCL, grp = piece / WCL;
  float* g_acc = scratch;
  float* g_ml = g_acc + (size_t)gridDim.y * gridDim.z * n_groups * WG * D;
  unsigned* counters =
      reinterpret_cast<unsigned*>(g_ml + (size_t)gridDim.y * gridDim.z * n_groups * WCL * WG * 2);
  T* out = o + head0 * D;
  const int hi = tid / (SC / 4), ci = r * SC + (tid % (SC / 4)) * 4;
  if (hi < ng) {
    float mx, lsum;
    const float4 a = merge_item(
        WCL,
        [&](int j) {
          const SM* peer = cluster.map_shared_rank(&sm, j);
          return make_float2(peer->m[hi], peer->l[hi]);
        },
        [&](int j) {
          const float* pa = cluster.map_shared_rank(sm.acc(), j);
          return *reinterpret_cast<const float4*>(pa + hi * D + ci);
        },
        mx, lsum);
    if (n_groups == 1) {
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
      T* dst = out + (size_t)hi * D + ci;
      dst[0] = from_float<T>(a.x * inv);
      dst[1] = from_float<T>(a.y * inv);
      dst[2] = from_float<T>(a.z * inv);
      dst[3] = from_float<T>(a.w * inv);
    } else {
      const size_t gi = (size_t)rs * n_groups + grp;
      __stcg(reinterpret_cast<float4*>(g_acc + (gi * WG + hi) * D + ci), a);
      if (ci == r * SC)          // this slice's own copy of the head's (m, l)
        __stcg(reinterpret_cast<float2*>(g_ml + ((gi * WCL + r) * WG + hi) * 2),
               make_float2(mx, lsum));
    }
  }

  // second level: the last cluster to finish column slice r sums that slice
  // of the clusters' partials and writes it out; it zeroes the slice's counter
  if (n_groups > 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      unsigned* cnt = counters + (size_t)rs * WCL + r;
      const bool last = atomicAdd(cnt, 1u) == (unsigned)n_groups - 1;
      if (last) *cnt = 0u;
      sm.last = last;
    }
    __syncthreads();
    if (sm.last && hi < ng) {
      __threadfence();
      const size_t gb = (size_t)rs * n_groups;
      float mx, lsum;
      const float4 a = merge_item(
          n_groups,
          [&](int j) {
            return __ldcg(reinterpret_cast<const float2*>(
                g_ml + (((gb + j) * WCL + r) * WG + hi) * 2));
          },
          [&](int j) {
            return __ldcg(reinterpret_cast<const float4*>(g_acc + ((gb + j) * WG + hi) * D + ci));
          },
          mx, lsum);
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
      T* dst = out + (size_t)hi * D + ci;
      dst[0] = from_float<T>(a.x * inv);
      dst[1] = from_float<T>(a.y * inv);
      dst[2] = from_float<T>(a.z * inv);
      dst[3] = from_float<T>(a.w * inv);
    }
  }
  cluster.sync();                       // no block leaves while its partial may be read
}

template <typename T, int D>
int launch_wide(const void* q, const void* k, const void* v, const int* lengths, void* o,
                float* scratch, int B, int Hk, int G, int S, long long bs, long long ss,
                cudaStream_t stream) {
  constexpr size_t smem = sizeof(WideSmem<T, D>);
  static std::atomic<unsigned long long> smem_devices{0};   // once per instantiation and device
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem_per_device(decode_wide_kernel<T, D>, (int)smem,
                                                  smem_devices);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_gs = (G + WG - 1) / WG;
  const dim3 grid(wide_pieces(S), Hk * n_gs, B);
  decode_wide_kernel<T, D><<<grid, WNT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(o), scratch, S, Hk, G, n_gs, bs, ss, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide_d(const void* q, const void* k, const void* v, const int* lengths, void* o,
                  float* scratch, int B, int Hk, int G, int D, int S, long long bs,
                  long long ss, cudaStream_t stream) {
  switch (D) {
    case 128:
      return launch_wide<T, 128>(q, k, v, lengths, o, scratch, B, Hk, G, S, bs, ss, stream);
    case 192:
      return launch_wide<T, 192>(q, k, v, lengths, o, scratch, B, Hk, G, S, bs, ss, stream);
    case 256:
      return launch_wide<T, 256>(q, k, v, lengths, o, scratch, B, Hk, G, S, bs, ss, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Wide heads (D = 128, 192 or 256).  Arguments as repro_decode_attention, plus
// the fp32 scratch of decode_wide_kernel for n_pieces = wide_pieces(S)
// pieces (the wrapper's wide_pieces mirrors it; any other count is
// refused), its counters zero before the first launch (every launch leaves
// them zero).  Returns cudaGetLastError() after the launch.
extern "C" int repro_decode_attention_split(const void* q, const void* k, const void* v,
                                            const void* lengths, void* o, void* scratch, int B,
                                            int H, int Hk, int D, int S, int dtype, long long bs,
                                            long long ss, int n_pieces, void* stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || S < 0 || n_pieces != wide_pieces(S) ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hk;
  const int* len = static_cast<const int*>(lengths);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_wide_d<float>(q, k, v, len, o, sc, B, Hk, G, D, S, bs, ss, st);
  if (dtype == kBFloat16)
    return launch_wide_d<__nv_bfloat16>(q, k, v, len, o, sc, B, Hk, G, D, S, bs, ss, st);
  return (int)cudaErrorInvalidValue;
}

// q: (B, 1, H, D) contiguous; k/v: (B, S, Hk, D) with element stride 1,
// head stride D, batch stride bs and sequence stride ss (in elements);
// lengths: (B,) int32; o: (B, 1, H, D) contiguous.  q, k, v and o share one
// dtype (0 float32, 1 bfloat16).  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lengths, void* o, int B, int H, int Hk, int D,
                                      int S, int dtype, long long bs, long long ss,
                                      void* stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || S < 0) return (int)cudaErrorInvalidValue;
  const int G = H / Hk;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_d<float>(q, k, v, len, o, B, Hk, G, D, S, bs, ss, st);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(q, k, v, len, o, B, Hk, G, D, S, bs, ss, st);
  return (int)cudaErrorInvalidValue;
}
