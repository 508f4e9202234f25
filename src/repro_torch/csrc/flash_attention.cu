// Causal GQA flash attention for prefill, hand-written for Hopper (sm_90a).
//
// Replaces: flash_attention_pallas in src/repro/kernels/flash_attention.py
// (the Pallas TPU kernel, pallas_call at line 124, body _kernel), and
// beyond it the function the JAX package's ops.flash_attention computes
// (_flash_jnp, src/repro/kernels/ops.py:57), whose keys may outnumber the
// queries: q (B, S, H, D) against k, v (B, Skv, Hk, D), the sequence ends
// aligned, so query row i sits at key position i + (Skv - S) and attends
// keys j <= i + (Skv - S) (causal; S <= Skv) and j > i + (Skv - S) - window
// (sliding window); without causal every key j < Skv.  Scores scaled by
// 1/sqrt(D), fp32 online softmax with the TPU kernel's finite NEG_INF, a
// fully masked row gives zeros, output (B, S, H, D) in the input dtype.
// The TPU kernel asserts S == Skv; an encoder (not causal, S == Skv) and a
// decoder's cross-attention over it (not causal, S != Skv) need the rest.
//
// Two designs, one a dtype:
//
// bf16: flash_tc_kernel, on the tensor cores.  What bounds it on the H100:
// 4·D FLOPs a visible (query, key) pair against ~2·D·(H + Hk) bytes a
// token, so at RecurrentGemma-9B's prefill (D = 256, 16 heads on 1, window
// 2048) the FLOPs over 989 TFLOP/s (bf16 wgmma), and at the serving
// admission shape (D = 64, S = 256) the bytes over 3.35 TB/s.  The design:
//  * A block owns 64·WGS (position, head) rows, one warpgroup (128 threads)
//    per 64: WGS = 2 at D = 256, where a K/V tile is worth sharing, 1 below,
//    where more, shorter blocks finish sooner.  Row R is (position q0 + R /
//    GH, head h0 + R % GH): GH = G query heads of one KV head when G divides
//    the block (under MQA at D = 256, 8 positions x 16 heads, so one K/V
//    tile serves all 16), else GH = 1 (a block of one head).
//  * TMA copies through 4-d tensor maps over (D, H, S, B) for q and (D, Hk,
//    Skv, B) for k/v, built per call with cuTensorMapEncodeTiled (found
//    through cudaGetDriverEntryPointByVersion, so no -lcuda) and passed as
//    __grid_constant__ parameters.  Boxes are 64 columns (128 bytes) wide
//    with the 128-byte swizzle; a row of D values is D/64 such atom columns
//    side by side.  Q is loaded once; K and V tiles of 64 keys go through
//    rings of two stages, each stage with its own mbarrier.  A K stage is
//    released once its S is computed, a V stage once its P·V is, and
//    refilled with the tile two ahead: with one warpgroup after a block
//    barrier by thread 0; with two, each warp adds one to the stage's count
//    in shared memory by an acquire-release atomic, and the warp that
//    completes it issues the copy, so neither warpgroup waits on the other
//    for a copy and every warp's reads of the stage happen before it.  The
//    standard "empty" mbarrier a stage, on which one consumer thread waits
//    before the refill, made the D = 256 call markedly slower on the card:
//    its waiter belongs with a producer warp (see below).  TMA fills what lies
//    outside the tensor with zeros, so keys past Skv, rows past S, and the
//    columns that pad D = 16, 32 to 64, read as 0.
//  * S = Q·Kᵀ: wgmma m64n64k16, bf16 in, fp32 out, A (Q) and B (K) both
//    K-major from shared memory.  O += P·V: wgmma m64nDk16 with A = P in
//    registers and B = V read MN-major (the transpose bit), N = D (64 for
//    D < 64; at D = 192, Nemotron-4-340B's width, m64n192k16 over three
//    atom columns, LBO apart as at 128 and 256).  The O accumulator (D/2
//    floats a thread, 96 at D = 192) stays in registers.
//  * A warpgroup works in sections: S of the first tile; then P·V of tile
//    j - 1 and S of tile j in one commit group, followed by the softmax of
//    tile j; then P·V of the last tile.  With two warpgroups the sections
//    take turns on named barriers 1 and 2 (warpgroup 0 first), so one
//    warpgroup's softmax runs while the other's products keep the tensor
//    cores busy.
//  * Online softmax in the log2 domain (exp2f, log2(e) folded into the
//    scale); a row's max and sum reduce over the 4 threads of a quad.  Only
//    tiles that cross the diagonal, the window's edge or the end of Skv are
//    masked; tiles no row of the block sees are never loaded (the TPU
//    kernel's pl.when skip).
//  * P is rounded to bf16 for the tensor-core product while the row sums
//    take it in fp32: a row-relative error of one bf16 unit (~0.0078) on
//    the card, the same as rounding the output, inside the 2e-2 check.
//
// What was hard, and how it is settled (each piece was checked alone on the
// card, against torch.matmul, before the kernel was written):
//  1. Descriptors (hopper.cuh, sw128_desc): start address >> 4, layout type
//     1 (128-byte swizzle), SBO = 1024 bytes (8 rows of 128), LBO unused for
//     K-major; every atom column on a 1024-byte boundary (the dynamic shared
//     memory is aligned by hand), so the k-th 16-wide step of a K-major
//     operand is simply the atom column's address + 32·k.
//  2. The MN-major V operand: LBO = the distance between atom columns (64
//     values of N each, 64·128 bytes apart in a tile), SBO = 1024 bytes
//     between groups of 8 keys; a 16-key step moves 2048 bytes.
//  3. Ordering: wgmma.fence before each section (the accumulators and P
//     were written by ordinary instructions), one commit_group and
//     wait_group 0 after it, and an empty asm on every accumulator register
//     after the wait, so the compiler cannot hoist a read of S or O above
//     it.  P depends on S only through registers, and is rewritten only
//     after the product that reads it has completed.  Every product must
//     be issued on a path that ptxas sees all threads take: a section
//     chosen by a runtime flag made ptxas insert a warpgroup.arrive on a
//     divergent path and serialise every wgmma (its warning C7520), which
//     made the kernel markedly slower, so the first and last sections are
//     peeled out of the loop.
//  4. The accumulator layout: thread t of warp w of a warpgroup holds rows
//     16w + t/4 and 16w + t/4 + 8 and columns 8i + 2(t%4) + {0, 1}; the
//     16-column chunk j of S, packed to bf16 pairs, is exactly the A
//     fragment of the j-th 16-key step of P·V.  Masks and the (position,
//     head) of each row derive from it.
//  5. Partial tiles: TMA zero-fills keys past Skv (and the mask drops them);
//     rows past S compute on zero q and are not stored.  A tile range that
//     is empty leaves l = 0 and stores zeros.
//  6. G not dividing the block: GH = 1, a block of 64·WGS positions of one
//     head (phase 3's G = 3 case at D = 256, and Nemotron-4-340B's G = 12
//     at D = 192, where each of a KV head's 12 blocks reads its K/V tiles).
//  7. D = 192: three atom columns a row (NA = 3); the S steps walk them as
//     kk / 4 and kk % 4 as at the power-of-two widths, and one warpgroup
//     takes a block (~124 KB of shared memory: Q and two stages of K and V
//     at 24 KB each).
// What is left out, and would come next: clusters of two blocks with TMA
// multicast of K/V (under MQA at D = 256 every block of a batch row reads
// the same tiles from L2, ~64 KB a tile for 128 rows, and two stages of
// 64 KB fill the shared memory, so copy latency is the likely limit at
// ~50% of the tensor-core bound); a producer warp with setmaxnreg, which
// would free registers for a second S accumulator so each warpgroup could
// overlap its own softmax with its products; persistent blocks.
//
// fp32: the CUDA-core kernels below, flash_fwd_kernel (D <= 64) and
// flash_wide_kernel (D = 128, 192, 256; at 192 a thread's 12 columns are
// three 16-byte chunks, ~106 KB of shared memory).  They serve only the fp32
// parity legs and fp32 checks, held at 2e-5 and 1e-3, which neither TF32
// (10 mantissa bits) nor bf16 tensor-core inputs could meet.
//  * flash_fwd_kernel: one block per (query tile of BQ rows, head, batch
//    row); each thread owns one query row and keeps q and its fp32
//    accumulator in registers; K/V tiles of BK keys staged in shared memory,
//    widened to fp32, with 16-byte loads, several in flight per thread.
//  * flash_wide_kernel: one query row's q and accumulator in registers
//    would need 2·D registers a thread (512 at D = 256), so a block takes
//    64 (position, head) rows (packed as above), its 256 threads form a
//    16 x 16 grid, a row's accumulator is split over 16 threads and its max
//    and sum reduced with shuffles; q in shared memory; K/V tiles of 32
//    keys by cp.async, rows padded by 16 bytes against bank conflicts; P
//    through shared memory.
//  * Both skip hidden KV tiles as above, read the (B, S, H, D) layout in
//    place, and map head h to KV head h / (H / Hk).  Their templates keep
//    the element type; only float is instantiated.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block, one per thread
constexpr int BK = 64;  // keys per shared-memory tile
constexpr int CH = 16;  // keys scored per online-softmax update
static_assert(BQ == BK, "each thread stages the same share of every tile row");

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int Skv, int H, int Hk, int causal, int window,
                 float scale) {
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x;
  const int qi = q_start + tid;
  const bool row_ok = qi < S;
  const int off = Skv - S;          // query row i sits at key position i + off
  const int qk = qi + off;

  float qr[D];
  float acc[D];
  {
    const T* qp = q + ((size_t)(b * S + (row_ok ? qi : 0)) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = row_ok ? to_float(qp[d]) : 0.f;
      acc[d] = 0.f;
    }
  }
  float m = REPRO_NEG_INF;
  float l = 0.f;

  // KV tiles some row of this query tile can see.
  const int q_last = min(q_start + BQ, S) - 1 + off;   // as a key position
  const int n_tiles = (Skv + BK - 1) / BK;
  const int hi = causal ? min(n_tiles, q_last / BK + 1) : n_tiles;
  int lo = 0;
  if (window > 0) {
    const int first = q_start + off - window + 1;  // earliest key row q_start sees
    lo = first > 0 ? first / BK : 0;
  }

  constexpr int VEC = Vec<T>::N;                 // elements per 16-byte load
  constexpr int VPR = D / VEC;                   // vectors per K/V row
  constexpr int GROUP = VPR < 4 ? VPR : 4;       // vectors in flight per thread
  static_assert(VPR % GROUP == 0, "tile rows must split into whole groups");
  const size_t row_stride = (size_t)Hk * D;
  const T* kb = k + (size_t)b * Skv * row_stride + (size_t)hk * D;
  const T* vb = v + (size_t)b * Skv * row_stride + (size_t)hk * D;

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every thread is done with the previous tile
    // Stage the K and V tiles with 16-byte loads, GROUP vectors of each in
    // flight per thread before any is stored, so the tile costs a few
    // memory latencies rather than one per element.
#pragma unroll
    for (int r0 = 0; r0 < VPR; r0 += GROUP) {
      uint4 kr[GROUP], vr[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int i = tid + (r0 + g) * BQ;
        const int kp = k0 + i / VPR;
        kr[g] = make_uint4(0u, 0u, 0u, 0u);
        vr[g] = kr[g];
        if (kp < Skv) {
          const size_t at = (size_t)kp * row_stride + (i % VPR) * VEC;
          kr[g] = load_vec(kb + at);
          vr[g] = load_vec(vb + at);
        }
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int i = tid + (r0 + g) * BQ;
        store_widened(&ks[i / VPR][(i % VPR) * VEC], kr[g], T());
        store_widened(&vs[i / VPR][(i % VPR) * VEC], vr[g], T());
      }
    }
    __syncthreads();

    for (int c = 0; c < BK; c += CH) {
      if (k0 + c >= Skv || (causal && k0 + c > q_last)) break;  // no row sees these keys
      float s[CH];
      unsigned visible = 0u;
      float m_chunk = REPRO_NEG_INF;
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        const int kp = k0 + c + t;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[c + t][d]);
          dot += qr[d] * kk.x + qr[d + 1] * kk.y + qr[d + 2] * kk.z + qr[d + 3] * kk.w;
        }
        const bool ok = kp < Skv && (!causal || kp <= qk) && (window <= 0 || kp > qk - window);
        s[t] = ok ? dot * scale : REPRO_NEG_INF;
        visible |= ok ? (1u << t) : 0u;
        m_chunk = fmaxf(m_chunk, s[t]);
      }
      const float m_new = fmaxf(m, m_chunk);
      const float corr = expf(m - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        s[t] = (visible >> t) & 1u ? expf(s[t] - m_new) : 0.f;
        p_sum += s[t];
      }
      l = l * corr + p_sum;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        float4 a = make_float4(acc[d] * corr, acc[d + 1] * corr, acc[d + 2] * corr,
                               acc[d + 3] * corr);
#pragma unroll
        for (int t = 0; t < CH; ++t) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[c + t][d]);
          a.x += s[t] * vv.x;
          a.y += s[t] * vv.y;
          a.z += s[t] * vv.z;
          a.w += s[t] * vv.w;
        }
        acc[d] = a.x;
        acc[d + 1] = a.y;
        acc[d + 2] = a.z;
        acc[d + 3] = a.w;
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* op = o + ((size_t)(b * S + qi) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = from_float<T>(acc[d] * inv);
  }
}

// ---- wide heads: D = 128, 192, 256 -------------------------------------
constexpr int WNT = 256;          // threads per block, a 16 x 16 grid
constexpr int WTX = 16;           // threads sharing a row
constexpr int WM = 64;            // (position, head) rows per block
constexpr int WRPT = WM / (WNT / WTX);  // rows per thread
constexpr int WBK = 32;           // keys per tile
constexpr int WKPT = WBK / WTX;   // keys per thread

template <typename T, int D>
constexpr size_t wide_smem_bytes() {
  // q (WM x D fp32), K and V tiles (WBK x (D + VEC) of T), P (WM x WBK fp32)
  return sizeof(float) * WM * D + 2 * sizeof(T) * WBK * (D + Vec<T>::N) +
         sizeof(float) * WM * WBK;
}

// Two blocks an SM (128 registers a thread) at D = 128 and 256; one at
// D = 192, whose 48 accumulators and three 16-byte chunks a thread spilled
// 8 bytes under the 128-register cap on the card.
template <typename T, int D>
__global__ void __launch_bounds__(WNT, D == 192 ? 1 : 2)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, int S, int Skv, int H, int Hk, int GH, int causal,
                  int window, float scale) {
  constexpr int VEC = Vec<T>::N;      // elements per 16-byte copy
  constexpr int VPR = D / VEC;        // 16-byte vectors per row
  constexpr int KS = D + VEC;         // padded K/V row stride, elements
  constexpr int CPT = D / WTX;        // output columns per thread
  constexpr int NCH = CPT / VEC;      // 16-byte column chunks per thread
  static_assert(CPT % VEC == 0, "a thread's columns must be whole 16-byte chunks");
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                       // WM x D
  T* ks = reinterpret_cast<T*>(qs + WM * D);                        // WBK x KS
  T* vs = ks + WBK * KS;                                            // WBK x KS
  float* ps = reinterpret_cast<float*>(vs + WBK * KS);              // WM x WBK

  const int tid = threadIdx.x;
  const int tx = tid % WTX;
  const int ty = tid / WTX;
  const int bqp = WM / GH;                      // query positions per block
  const int q0 = blockIdx.x * bqp;
  const int h0 = blockIdx.y * GH;               // first query head of the group
  const int b = blockIdx.z;
  const int G = H / Hk;
  const int hk = h0 / G;
  const int off = Skv - S;                      // query row i sits at key position i + off

  // stage the q rows, widened to fp32; row r is (position q0 + r / GH,
  // head h0 + r % GH), so a position's GH heads are adjacent in memory
  for (int i = tid; i < WM * VPR; i += WNT) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    const int pos = q0 + r / GH;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (pos < S) raw = load_vec(q + ((size_t)(b * S + pos) * H + h0 + r % GH) * D + c);
    store_widened(qs + r * D + c, raw, T());
  }

  int pos_r[WRPT];
  float m[WRPT], l[WRPT], acc[WRPT][CPT];
#pragma unroll
  for (int i = 0; i < WRPT; ++i) {
    pos_r[i] = q0 + (ty * WRPT + i) / GH;
    m[i] = REPRO_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // KV tiles some row of this block can see
  const int q_last = min(q0 + bqp, S) - 1 + off;   // as a key position
  const int n_tiles = (Skv + WBK - 1) / WBK;
  const int hi = causal ? min(n_tiles, q_last / WBK + 1) : n_tiles;
  int lo = 0;
  if (window > 0) {
    const int first = q0 + off - window + 1;  // earliest key position q0 sees
    lo = first > 0 ? first / WBK : 0;
  }
  const size_t row_stride = (size_t)Hk * D;
  const T* kb = k + (size_t)b * Skv * row_stride + (size_t)hk * D;
  const T* vb = v + (size_t)b * Skv * row_stride + (size_t)hk * D;

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * WBK;
    __syncthreads();  // every thread is done with the previous tile and its P
    for (int i = tid; i < WBK * VPR; i += WNT) {
      const int kr = i / VPR;
      const int c = (i % VPR) * VEC;
      const int kp = k0 + kr;
      const size_t at = (size_t)(kp < Skv ? kp : 0) * row_stride + c;
      const int n = kp < Skv ? 16 : 0;
      cp_async16(ks + kr * KS + c, kb + at, n);
      cp_async16(vs + kr * KS + c, vb + at, n);
    }
    cp_async_wait_all();
    __syncthreads();

    // scores of this thread's rows against keys tx and tx + 16
    float s[WRPT][WKPT];
#pragma unroll
    for (int i = 0; i < WRPT; ++i)
#pragma unroll
      for (int jj = 0; jj < WKPT; ++jj) s[i][jj] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += VEC) {
      float kf[WKPT][VEC];
#pragma unroll
      for (int jj = 0; jj < WKPT; ++jj)
        store_widened(kf[jj], load_vec(ks + (tx + WTX * jj) * KS + d), T());
#pragma unroll
      for (int i = 0; i < WRPT; ++i) {
        const float* qr = qs + (ty * WRPT + i) * D + d;
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qr + e);
#pragma unroll
          for (int jj = 0; jj < WKPT; ++jj)
            s[i][jj] += qq.x * kf[jj][e] + qq.y * kf[jj][e + 1] + qq.z * kf[jj][e + 2] +
                        qq.w * kf[jj][e + 3];
        }
      }
    }

    // online softmax, one row's statistics reduced over its 16 threads
#pragma unroll
    for (int i = 0; i < WRPT; ++i) {
      const int pos = pos_r[i] + off;           // the row's key position
      bool ok[WKPT];
      float m_tile = REPRO_NEG_INF;
#pragma unroll
      for (int jj = 0; jj < WKPT; ++jj) {
        const int kp = k0 + tx + WTX * jj;
        ok[jj] = kp < Skv && (!causal || kp <= pos) && (window <= 0 || kp > pos - window);
        s[i][jj] = ok[jj] ? s[i][jj] * scale : REPRO_NEG_INF;
        m_tile = fmaxf(m_tile, s[i][jj]);
      }
#pragma unroll
      for (int off = WTX / 2; off > 0; off >>= 1)
        m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
      const float m_new = fmaxf(m[i], m_tile);
      const float corr = expf(m[i] - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < WKPT; ++jj) {
        const float p = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
        ps[(ty * WRPT + i) * WBK + tx + WTX * jj] = p;
        p_sum += p;
      }
#pragma unroll
      for (int off = WTX / 2; off > 0; off >>= 1)
        p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
      l[i] = l[i] * corr + p_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // P of every row is in shared memory

    const int n_keys = min(WBK, Skv - k0);
    for (int kk = 0; kk < n_keys; ++kk) {
      float vf[NCH][VEC];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
        store_widened(vf[ch], load_vec(vs + kk * KS + (tx + WTX * ch) * VEC), T());
#pragma unroll
      for (int i = 0; i < WRPT; ++i) {
        const float p = ps[(ty * WRPT + i) * WBK + kk];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[i][ch * VEC + e] += p * vf[ch][e];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < WRPT; ++i) {
    const int pos = pos_r[i];
    if (pos < S) {
      const int r = ty * WRPT + i;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      T* op = o + ((size_t)(b * S + pos) * H + h0 + r % GH) * D;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          op[(tx + WTX * ch) * VEC + e] = from_float<T>(acc[i][ch * VEC + e] * inv);
    }
  }
}

template <typename T, int D>
int launch_wide(const void* q, const void* k, const void* v, void* o, int B, int S, int Skv,
                int H, int Hk, int causal, int window, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes<T, D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wide_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = H / Hk;
  const int GH = WM % G == 0 ? G : 1;  // query heads of one KV head per block
  const int bqp = WM / GH;
  const dim3 grid((S + bqp - 1) / bqp, H / GH, B);
  flash_wide_kernel<T, D><<<grid, WNT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Skv, H, Hk, GH, causal, window, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Skv, int H,
           int Hk, int causal, int window, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Skv, H, Hk, causal, window, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores (wgmma over swizzled TMA tiles) ------------------
constexpr int TC_BK = 64;        // keys a K/V tile
constexpr int TC_STAGES = 2;     // K/V tiles in flight

template <int D>
struct TcTile {
  // warpgroups a block, 64 rows each: two at D = 256, where a K/V tile is
  // worth sharing; one below, where more and shorter blocks win
  static constexpr int WGS = D == 256 ? 2 : 1;
  static constexpr int M = 64 * WGS;            // (position, head) rows a block
  static constexpr int THREADS = 128 * WGS;     // consumers that also issue the copies
  static constexpr int DP = D < 64 ? 64 : D;    // width padded to whole 128-byte rows
  static constexpr int NA = DP / 64;            // 128-byte atom columns across a row
  static constexpr int Q_ATOM = M * 128;        // bytes of one Q atom column
  static constexpr int KV_ATOM = TC_BK * 128;   // bytes of one K or V atom column
  static constexpr int Q_BYTES = NA * Q_ATOM;
  static constexpr int KV_BYTES = NA * KV_ATOM; // one K (or V) tile
  // 1024 bytes to align the first atom column; at the end the barriers
  // (Q, K and V of each stage) and the stages' release counters
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * TC_STAGES * KV_BYTES + 8 * (1 + 2 * TC_STAGES) + 4 * 2 * TC_STAGES;
};

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b) {
  if constexpr (N == 64) wgmma_rs_m64n64k16(d, a, b);
  else if constexpr (N == 128) wgmma_rs_m64n128k16(d, a, b);
  else if constexpr (N == 192) wgmma_rs_m64n192k16(d, a, b);
  else wgmma_rs_m64n256k16(d, a, b);
}

template <int D>
__global__ void __launch_bounds__(TcTile<D>::THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S,
                int Skv, int H, int G, int GH, int causal, int window, float scale_log2) {
  using T = TcTile<D>;
  constexpr int DP = T::DP;
  constexpr int KSTEPS = D / 16;   // 16-wide steps of S = Q·Kᵀ (the padding adds 0)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = qs + T::Q_BYTES;                   // stage s at ks + s·KV_BYTES
  const uint32_t vs = ks + TC_STAGES * T::KV_BYTES;
  const uint32_t bar_q = vs + TC_STAGES * T::KV_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int bqp = T::M / GH;                    // query positions a block
  const int q0 = blockIdx.x * bqp;
  const int h0 = blockIdx.y * GH;               // first query head of the group
  const int b = blockIdx.z;
  const int hk = h0 / G;
  const int off = Skv - S;                      // query row i sits at key position i + off
  const int q0k = q0 + off;                     // the block's first position, as a key

  // KV tiles some row of this block can see
  const int q_last = min(q0 + bqp, S) - 1 + off;
  const int n_tiles = (Skv + TC_BK - 1) / TC_BK;
  const int hi = causal ? min(n_tiles, q_last / TC_BK + 1) : n_tiles;
  int lo = 0;
  if (window > 0) {
    const int first = q0k - window + 1;         // earliest key position q0 sees
    lo = first > 0 ? first / TC_BK : 0;
  }

  // Barriers: Q, then K full and V full of each stage; then the stages'
  // release counts.
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * TC_STAGES;
  int* released =
      reinterpret_cast<int*>(smem_raw + (bar_v + 8 * TC_STAGES - smem_u32(smem_raw)));
  auto load = [&](const CUtensorMap* map, uint32_t dst, uint32_t bar, int tile) {
    mbar_expect_tx(bar, T::KV_BYTES);
#pragma unroll
    for (int c = 0; c < T::NA; ++c)
      tma_load_4d(dst + c * T::KV_ATOM, map, bar, 64 * c, hk, tile * TC_BK, b);
  };
  auto load_k = [&](int st, int tile) { load(&tk, ks + st * T::KV_BYTES, bar_k + 8 * st, tile); };
  auto load_v = [&](int st, int tile) { load(&tv, vs + st * T::KV_BYTES, bar_v + 8 * st, tile); };
  // After section it's wait: release the V stage of tile lo + it - 1 (if
  // the section had a P·V) and the K stage of tile lo + it, refilling each
  // with the tile two ahead.  One warpgroup: a block barrier, then thread 0
  // copies.  Two: each warp adds one to the stage's count (acquire-release,
  // so the warps' reads of the stage happen before the copy), and the warp
  // that completes it copies (the counts only grow: nothing to reset).
  auto release = [&](bool has_v, int it) {
    const int v_st = (it + TC_STAGES - 1) % TC_STAGES, k_st = it % TC_STAGES;
    const int v_tile = lo + it + 1, k_tile = lo + it + TC_STAGES;
    if constexpr (T::WGS == 1) {
      __syncthreads();
      if (tid == 0) {
        if (has_v && v_tile < hi) load_v(v_st, v_tile);
        if (k_tile < hi) load_k(k_st, k_tile);
      }
    } else {
      __syncwarp();
      if (lane == 0) {
        constexpr int WARPS = 4 * T::WGS;
        if (has_v && (atom_add_acq_rel(released + TC_STAGES + v_st, 1) + 1) % WARPS == 0 &&
            v_tile < hi)
          load_v(v_st, v_tile);
        if ((atom_add_acq_rel(released + k_st, 1) + 1) % WARPS == 0 && k_tile < hi)
          load_k(k_st, k_tile);
      }
    }
  };
  if (tid == 0) {
    prefetch_tensormap(&tq);
    prefetch_tensormap(&tk);
    prefetch_tensormap(&tv);
    for (int i = 0; i < 1 + 2 * TC_STAGES; ++i) mbar_init(bar_q + 8 * i, 1);
    for (int i = 0; i < 2 * TC_STAGES; ++i) released[i] = 0;
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, T::Q_BYTES);
#pragma unroll
    for (int c = 0; c < T::NA; ++c)
      tma_load_4d(qs + c * T::Q_ATOM, &tq, bar_q, 64 * c, h0, q0, b);
    for (int st = 0; st < TC_STAGES && lo + st < hi; ++st) {
      load_k(st, lo + st);
      load_v(st, lo + st);
    }
  }

  // This thread holds block rows r0 and r0 + 8 of the accumulator layout;
  // row R is (position q0 + R / GH, head h0 + R % GH), as the Q box lays
  // them out (heads innermost).
  const int r0 = 64 * wg + 16 * warp + lane / 4;
  int pos[2], head[2];          // the row's query position and head
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pos[h] = q0 + (r0 + 8 * h) / GH;
    head[h] = h0 + (r0 + 8 * h) % GH;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float sc[32];
  uint32_t p[16];
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
  float l[2] = {0.f, 0.f};      // this thread's share of the row sums
  const uint32_t q_wg = qs + wg * 64 * 128;     // this warpgroup's rows in each atom column

  // S = Q·Kᵀ of the K tile in stage st, both operands K-major
  auto issue_s = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss_m64n64k16(
          sc, sw128_desc(q_wg + (kk / 4) * T::Q_ATOM + (kk % 4) * 32, 16, 1024),
          sw128_desc(ks + st * T::KV_BYTES + (kk / 4) * T::KV_ATOM + (kk % 4) * 32, 16, 1024));
  };
  // O += P·V of the V tile in stage st, P from registers, V MN-major
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kj = 0; kj < TC_BK / 16; ++kj)
      wgmma_rs<DP>(acc, p + 4 * kj,
                   sw128_desc(vs + st * T::KV_BYTES + kj * 16 * 128, T::KV_ATOM, 1024));
  };
  // Online softmax of S for KV tile j in the log2 domain; only a tile that
  // crosses the diagonal, the window's edge or the end of Skv is masked.
  // Leaves P in bf16 pairs (the S accumulator's 16-column chunk i is the A
  // fragment of the i-th 16-key step of P·V) and O rescaled.
  auto softmax = [&](int j) {
    const int k0 = j * TC_BK;
    const bool edge = k0 + TC_BK > Skv || (causal && k0 + TC_BK - 1 > q0k) ||
                      (window > 0 && k0 <= q0k + bqp - 1 - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      float x = sc[i] * scale_log2;
      if (edge) {
        const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const int pk = pos[h] + off;
        const bool ok = kp < Skv && (!causal || kp <= pk) && (window <= 0 || kp > pk - window);
        x = ok ? x : REPRO_NEG_INF;
      }
      sc[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i / 2) % 2;
      float e0 = exp2f(sc[i] - m[h]);
      float e1 = exp2f(sc[i + 1] - m[h]);
      if (edge) {   // a masked key adds 0, also in a row that saw no key yet
        e0 = sc[i] > 0.5f * REPRO_NEG_INF ? e0 : 0.f;
        e1 = sc[i + 1] > 0.5f * REPRO_NEG_INF ? e1 : 0.f;
      }
      rsum[h] += e0 + e1;
      p[i / 2] = pack_bf16(e0, e1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rsum[h];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i / 2) % 2];
  };
  // With two warpgroups, their product sections take turns (named barriers
  // 1 and 2), so one warpgroup's softmax runs under the other's products.
  auto turn = [&]() {
    if (T::WGS == 2) named_bar_sync(1 + wg, 256);
  };
  auto pass = [&](bool last) {
    if (T::WGS == 2 && !(last && wg == 1)) named_bar_arrive(2 - wg, 256);
  };

  auto wait_k = [&](int it) { mbar_wait(bar_k + 8 * (it % TC_STAGES), (it / TC_STAGES) & 1); };
  auto wait_v = [&](int it) { mbar_wait(bar_v + 8 * (it % TC_STAGES), (it / TC_STAGES) & 1); };

  // Sections: S of tile lo; then PV of tile j - 1 with S of tile j; then PV
  // of the last tile.  A K stage is released after its S, a V stage after
  // its PV, each refilled with the tile two ahead.  The first and last
  // sections are peeled so every product is issued on a path all threads of
  // the warpgroup take (ptxas serialises wgmma on a divergent one).
  // at least 1: causal rows see their own key (S <= Skv), the others all
  // Skv keys, and a window's first tile lies below the last
  const int n = hi - lo;
  if (T::WGS == 2 && wg == 1) named_bar_arrive(1, 256);   // warpgroup 0 goes first
  mbar_wait(bar_q, 0);
  wait_k(0);
  turn();
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  pass(false);
  wgmma_wait_all();
  fence_regs(sc);
  release(false, 0);
  softmax(lo);
  for (int it = 1; it < n; ++it) {
    wait_k(it);
    wait_v(it - 1);
    turn();
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
    issue_pv((it - 1) % TC_STAGES);
    issue_s(it % TC_STAGES);
    wgmma_commit();
    pass(false);
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(acc);
    release(true, it);
    softmax(lo + it);
  }
  wait_v(n - 1);
  turn();
  wgmma_fence();
  issue_pv((n - 1) % TC_STAGES);
  wgmma_commit();
  pass(true);
  wgmma_wait_all();
  fence_regs(acc);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (pos[h] < S) {
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      __nv_bfloat16* op = o + ((size_t)(b * S + pos[h]) * H + head[h]) * D + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i + 2 * h] * inv, acc[4 * i + 2 * h + 1] * inv);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int S, int Skv, int H,
              int Hk, int causal, int window, cudaStream_t stream) {
  const int G = H / Hk;
  const int GH = TcTile<D>::M % G == 0 ? G : 1;   // query heads of one KV head per block
  const int bqp = TcTile<D>::M / GH;
  CUtensorMap tq, tk, tv;
  if (!encode_bf16_4d(&tq, q, D, H, S, B, 64, GH, bqp, 1) ||
      !encode_bf16_4d(&tk, k, D, Hk, Skv, B, 64, 1, TC_BK, 1) ||
      !encode_bf16_4d(&tv, v, D, Hk, Skv, B, 64, 1, TC_BK, 1))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = TcTile<D>::SMEM;
  static std::atomic<unsigned long long> smem_devices{0};   // once per width and device
  const cudaError_t err = allow_smem_per_device(flash_tc_kernel<D>, smem, smem_devices);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + bqp - 1) / bqp, H / GH, B);
  flash_tc_kernel<D><<<grid, TcTile<D>::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, Skv, H, G, GH, causal, window,
      (float)(1.4426950408889634 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

// fp32: the CUDA-core kernels
int launch_fp32(const void* q, const void* k, const void* v, void* o, int B, int S, int Skv,
                int H, int Hk, int D, int causal, int window, cudaStream_t st) {
  switch (D) {
    case 16: return launch<float, 16>(q, k, v, o, B, S, Skv, H, Hk, causal, window, st);
    case 32: return launch<float, 32>(q, k, v, o, B, S, Skv, H, Hk, causal, window, st);
    case 64: return launch<float, 64>(q, k, v, o, B, S, Skv, H, Hk, causal, window, st);
    case 128: return launch_wide<float, 128>(q, k, v, o, B, S, Skv, H, Hk, causal, window, st);
    case 192: return launch_wide<float, 192>(q, k, v, o, B, S, Skv, H, Hk, causal, window, st);
    case 256: return launch_wide<float, 256>(q, k, v, o, B, S, Skv, H, Hk, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16: the tensor-core kernel
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S, int Skv,
                int H, int Hk, int D, int causal, int window, cudaStream_t st) {
  switch (D) {
    case 16: return launch_tc<16>(q, k, v, o, B, S, Skv, H, Hk, causal, window, st);
    case 32: return launch_tc<32>(q, k, v, o, B, S, Skv, H, Hk, causal, window, st);
    case 64: return launch_tc<64>(q, k, v, o, B, S, Skv, H, Hk, causal, window, st);
    case 128: return launch_tc<128>(q, k, v, o, B, S, Skv, H, Hk, causal, window, st);
    case 192: return launch_tc<192>(q, k, v, o, B, S, Skv, H, Hk, causal, window, st);
    case 256: return launch_tc<256>(q, k, v, o, B, S, Skv, H, Hk, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, S, H, D), k/v: (B, Skv, Hk, D), o: (B, S, H, D), all contiguous and
// of one dtype (dtype: 0 float32, 1 bfloat16).  window <= 0 means no window;
// causal needs S <= Skv (a query past the keys' end would see none).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int S, int Skv, int H, int Hk, int D, int dtype,
                                     int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || (causal && S > Skv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_fp32(q, k, v, o, B, S, Skv, H, Hk, D, causal, window, st);
  if (dtype == kBFloat16) return launch_bf16(q, k, v, o, B, S, Skv, H, Hk, D, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
