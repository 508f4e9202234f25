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
// What bounds it on the H100: memory.  Each step reads each row's live K/V
// once, 4·D·Hk bytes per position in bf16, and does 4·D FLOPs per (query
// head, position): a few FLOPs per byte, far below the ~295 the card needs
// to be compute-bound.
//
// What the design does about it:
//  * One block per (KV head, batch row); all G = H / Hk query heads of the
//    KV head share every K/V row the block loads, so GQA reads the cache
//    once per group.  (Groups of more than GMAX heads are split over
//    several blocks along grid.x.)
//  * fp32 at D = 64 would hold 32 16-byte vectors per lane in flight; it
//    stages a tile in two passes of 16 to stay clear of register spills.
//  * The TPU kernel's sequential KV grid axis becomes a loop, split across
//    the block's warps: warp w takes tiles w, w + NW, ... of 32 positions,
//    and each warp carries its own (m, l, acc) in registers.  The warps'
//    partial softmaxes merge through shared memory at the end.
//  * A warp stages its tile in its own slice of shared memory with 16-byte
//    loads, every load of the tile in flight before any is stored; rows at
//    or past the length are never loaded, so the kernel reads only what the
//    row needs.  Lane t then scores position t of the tile (the K tile is
//    padded by one float per row so this is free of bank conflicts), and
//    lane d accumulates value dimensions d, d + 32, ...
//
// Wide heads (D = 128, 256) take a second design, decode_split_kernel and
// decode_merge_kernel below ("flash-decoding"), entered through
// repro_decode_attention_split.  The design above would need NW·TK·(2D + 1)
// floats of shared memory (263 KB at D = 256, above the 227 KB a block may
// have), and it caps a block at GMAX = 8 query heads, so under MQA with
// G = 16 it would read every row twice; and at RecurrentGemma-9B's decode
// (B = 4, Hk = 1) one block per (row, KV head) lights 4 of 132 SMs.
//  * The sequence is split into pieces of STS = 64 positions, one block
//    each (grid: pieces × KV heads × rows), so a 2,048-slot ring at B = 4
//    runs as 128 blocks.  Each block takes up to SGMAX = 16 query heads of
//    its KV head: the piece of K/V is read once for all of them.
//  * A block stages its piece of K and V in the input dtype in dynamic
//    shared memory by cp.async (rows padded by 16 bytes, so the eight rows a
//    phase reads fall in distinct banks), scores every (head, position)
//    pair, takes each head's max and sum over the piece with one warp, and
//    accumulates P·V with each thread on 16 bytes of columns of a few heads.
//  * It writes its partial (m, l, acc) in fp32 to scratch that the wrapper
//    allocates; decode_merge_kernel rescales and sums the pieces.  A piece
//    at or past the row's length loads nothing and writes (−1e30, 0, 0), so
//    a length-0 row merges to zeros.
#include "common.cuh"

namespace {

constexpr int TK = 32;    // positions per warp tile (one per lane)
constexpr int NW = 4;     // warps per block
constexpr int NT = NW * 32;
constexpr int GMAX = 8;   // query heads a block handles

// gs = min(G, GMAX), the heads of one block
template <int D>
size_t smem_bytes(int gs) {
  // per warp: K tile TK x (D + 1) and V tile TK x D; then, for the merge,
  // every warp's (m, l) and acc for the block's heads; and the q vectors
  return sizeof(float) * ((size_t)NW * TK * (2 * D + 1) + (size_t)NW * gs * (D + 2) +
                          (size_t)gs * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lengths, T* __restrict__ o, int S, int Hk, int G,
              int n_gsplit, long long bs, long long ss, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ks = sm + (size_t)warp * TK * (2 * D + 1);  // this warp's K tile
  float* vs = ks + TK * (D + 1);                     // and its V tile
  const int gs = min(G, GMAX);                       // head stride of the merge arrays
  float* m_all = sm + (size_t)NW * TK * (2 * D + 1); // NW x gs
  float* l_all = m_all + NW * gs;                    // NW x gs
  float* acc_all = l_all + NW * gs;                  // NW x gs x D
  float* qs = acc_all + (size_t)NW * gs * D;         // gs x D

  const int h = blockIdx.x / n_gsplit;               // KV head
  const int g0 = (blockIdx.x % n_gsplit) * GMAX;     // first query head of the group slice
  const int ng = min(GMAX, G - g0);                  // heads this block handles
  const int b = blockIdx.y;
  const int H = Hk * G;
  const size_t q_off = ((size_t)b * H + (size_t)h * G + g0) * D;

  for (int i = threadIdx.x; i < ng * D; i += NT) qs[i] = to_float(q[q_off + i]);
  __syncthreads();

  constexpr int VEC = Vec<T>::N;        // elements per 16-byte load
  constexpr int VPR = D / VEC;          // vectors per K/V row
  constexpr int PER = TK * VPR / 32;    // vectors of K (and of V) per lane
  static_assert(TK * VPR % 32 == 0, "a tile must split evenly over the lanes");
  constexpr int PASS = PER > 8 ? 2 : 1; // fp32 at D=64 stages in two passes
  constexpr int PP = PER / PASS;        // vectors of K (and of V) per lane and pass
  constexpr int DPL = (D + 31) / 32;    // value dimensions per lane

  float m[GMAX], l[GMAX], acc[GMAX][DPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = REPRO_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }

  const int n_pos = min(lengths[b], S);
  const T* kb = k + (size_t)b * bs + (size_t)h * D;
  const T* vb = v + (size_t)b * bs + (size_t)h * D;

  for (int base = warp * TK; base < n_pos; base += NW * TK) {
    __syncwarp();  // the previous tile is consumed
#pragma unroll
    for (int pass = 0; pass < PASS; ++pass) {
      uint4 kr[PP], vr[PP];
#pragma unroll
      for (int r = 0; r < PP; ++r) {
        const int i = lane + (pass * PP + r) * 32;
        const int pos = base + i / VPR;
        kr[r] = make_uint4(0u, 0u, 0u, 0u);
        vr[r] = kr[r];
        if (pos < n_pos) {
          const size_t off = (size_t)pos * ss + (i % VPR) * VEC;
          kr[r] = load_vec(kb + off);
          vr[r] = load_vec(vb + off);
        }
      }
#pragma unroll
      for (int r = 0; r < PP; ++r) {
        const int i = lane + (pass * PP + r) * 32;
        const int t = i / VPR;
        store_widened(ks + t * (D + 1) + (i % VPR) * VEC, kr[r], T());
        store_widened(vs + t * D + (i % VPR) * VEC, vr[r], T());
      }
    }
    __syncwarp();
    const bool live = base + lane < n_pos;
    const float* kt = ks + lane * (D + 1);
    float p[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < ng) {
        const float* qg = qs + g * D;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot += qg[d] * kt[d];
        const float s = live ? dot * scale : REPRO_NEG_INF;
        const float m_new = fmaxf(m[g], warp_max(s));
        p[g] = live ? expf(s - m_new) : 0.f;
        const float c = expf(m[g] - m_new);
        l[g] = l[g] * c + warp_sum(p[g]);
        m[g] = m_new;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] *= c;
      }
    }
    const int n_t = min(TK, n_pos - base);
    for (int t = 0; t < n_t; ++t) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < ng) {
          const float pt = __shfl_sync(0xffffffffu, p[g], t);
#pragma unroll
          for (int j = 0; j < DPL; ++j) {
            const int d = lane + 32 * j;
            if (d < D) acc[g][j] += pt * vs[t * D + d];
          }
        }
      }
    }
  }

  // merge the warps' partial softmaxes
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < ng) {
      if (lane == 0) {
        m_all[warp * gs + g] = m[g];
        l_all[warp * gs + g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        if (d < D) acc_all[((size_t)warp * gs + g) * D + d] = acc[g][j];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * D; i += NT) {
    const int g = i / D;
    const int d = i - g * D;
    float mx = REPRO_NEG_INF;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, m_all[w * gs + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float c = expf(m_all[w * gs + g] - mx);
      lsum += l_all[w * gs + g] * c;
      a += acc_all[((size_t)w * gs + g) * D + d] * c;
    }
    o[q_off + i] = from_float<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o, int B,
           int Hk, int G, int S, long long bs, long long ss, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(G < GMAX ? G : GMAX);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_gsplit = (G + GMAX - 1) / GMAX;
  const dim3 grid(Hk * n_gsplit, B);
  decode_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(o), S, Hk, G, n_gsplit, bs, ss, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const int* lengths, void* o, int B,
             int Hk, int G, int D, int S, long long bs, long long ss, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, lengths, o, B, Hk, G, S, bs, ss, stream);
    case 32:
      return launch<T, 32>(q, k, v, lengths, o, B, Hk, G, S, bs, ss, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, o, B, Hk, G, S, bs, ss, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---- wide heads: D = 128, 256, split over the sequence ------------------
constexpr int SNT = 256;    // threads per block
constexpr int STS = 64;     // positions per piece (one block)
constexpr int SGMAX = 16;   // query heads a block handles
static_assert(SNT % STS == 0 && SGMAX % (SNT / STS) == 0, "score threads must tile heads");

template <typename T, int D>
constexpr size_t split_smem_bytes() {
  // K and V pieces (STS x (D + VEC) of T), q (SGMAX x D fp32), scores and
  // probabilities (SGMAX x STS fp32), each head's (m, l)
  return 2 * sizeof(T) * STS * (D + Vec<T>::N) +
         sizeof(float) * ((size_t)SGMAX * D + SGMAX * STS + 2 * SGMAX);
}

template <typename T, int D>
__global__ void __launch_bounds__(SNT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int S, int Hk, int G, int n_gsplit,
                    int n_split, long long bs, long long ss, float scale) {
  constexpr int VEC = Vec<T>::N;          // elements per 16-byte copy
  constexpr int VPR = D / VEC;            // 16-byte vectors per row
  constexpr int KS = D + VEC;             // padded K/V row stride, elements
  constexpr int SHL = SNT / STS;          // head lanes of the score phase
  constexpr int SHP = SGMAX / SHL;        // heads per thread there
  constexpr int HG = SNT / VPR;           // head lanes of the P·V phase
  constexpr int HPT = (SGMAX + HG - 1) / HG;  // heads per thread there
  static_assert(SNT % VPR == 0, "P·V threads must tile the columns");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                           // STS x KS
  T* vs = ks + STS * KS;                                        // STS x KS
  float* qs = reinterpret_cast<float*>(vs + STS * KS);          // SGMAX x D
  float* sc = qs + SGMAX * D;                                   // SGMAX x STS
  float* ml = sc + SGMAX * STS;                                 // SGMAX x 2

  const int split = blockIdx.x;
  const int h = blockIdx.y / n_gsplit;                          // KV head
  const int g0 = (blockIdx.y % n_gsplit) * SGMAX;               // first query head of the slice
  const int ng = min(SGMAX, G - g0);
  const int b = blockIdx.z;
  const int H = Hk * G;
  const int tid = threadIdx.x;
  const int p0 = split * STS;
  const int cnt = min(STS, min(lengths[b], S) - p0);            // live positions of the piece
  const size_t head0 = (size_t)b * H + (size_t)h * G + g0;      // first query head, flat
  // partial of query head g (0 <= g < ng): index (head0 + g) * n_split + split

  if (cnt <= 0) {
    for (int i = tid; i < ng * D; i += SNT) {
      const int g = i / D;
      part_acc[((head0 + g) * n_split + split) * D + i % D] = 0.f;
    }
    if (tid < ng) {
      part_ml[((head0 + tid) * n_split + split) * 2] = REPRO_NEG_INF;
      part_ml[((head0 + tid) * n_split + split) * 2 + 1] = 0.f;
    }
    return;
  }

  const T* kb = k + (size_t)b * bs + (size_t)h * D;
  const T* vb = v + (size_t)b * bs + (size_t)h * D;
  for (int i = tid; i < cnt * VPR; i += SNT) {
    const int t = i / VPR;
    const int c = (i % VPR) * VEC;
    const size_t off = (size_t)(p0 + t) * ss + c;
    cp_async16(ks + t * KS + c, kb + off, 16);
    cp_async16(vs + t * KS + c, vb + off, 16);
  }
  for (int i = tid; i < ng * D; i += SNT) qs[i] = to_float(q[head0 * D + i]);
  cp_async_wait_all();
  __syncthreads();

  // scores: thread (hl, t) takes position t against heads hl, hl + SHL, ...
  {
    const int t = tid % STS;
    const int hl = tid / STS;
    float dot[SHP];
#pragma unroll
    for (int i = 0; i < SHP; ++i) dot[i] = 0.f;
    if (t < cnt) {
#pragma unroll 4
      for (int d = 0; d < D; d += VEC) {
        float kf[VEC];
        store_widened(kf, load_vec(ks + t * KS + d), T());
#pragma unroll
        for (int i = 0; i < SHP; ++i) {
          const float* qg = qs + (hl + SHL * i) * D + d;
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 qq = *reinterpret_cast<const float4*>(qg + e);
            dot[i] += qq.x * kf[e] + qq.y * kf[e + 1] + qq.z * kf[e + 2] + qq.w * kf[e + 3];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < SHP; ++i) {
      const int g = hl + SHL * i;
      if (g < ng) sc[g * STS + t] = t < cnt ? dot[i] * scale : REPRO_NEG_INF;
    }
  }
  __syncthreads();

  // each head's max and sum over the piece, one warp a head
  {
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int g = warp; g < ng; g += SNT / 32) {
      float sv[STS / 32];
      float mx = REPRO_NEG_INF;
#pragma unroll
      for (int j = 0; j < STS / 32; ++j) {
        sv[j] = sc[g * STS + lane + 32 * j];
        mx = fmaxf(mx, sv[j]);
      }
      mx = warp_max(mx);
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < STS / 32; ++j) {
        const int t = lane + 32 * j;
        const float p = t < cnt ? expf(sv[j] - mx) : 0.f;
        sc[g * STS + t] = p;
        lsum += p;
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        ml[2 * g] = mx;
        ml[2 * g + 1] = lsum;
      }
    }
  }
  __syncthreads();

  // P·V: thread (hl, c) accumulates columns c·VEC .. + VEC of heads hl, hl + HG, ...
  const int c = tid % VPR;
  const int hl = tid / VPR;
  float acc[HPT][VEC];
#pragma unroll
  for (int i = 0; i < HPT; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
  for (int t = 0; t < cnt; ++t) {
    float vf[VEC];
    store_widened(vf, load_vec(vs + t * KS + c * VEC), T());
#pragma unroll
    for (int i = 0; i < HPT; ++i) {
      const int g = hl + HG * i;
      if (g < ng) {
        const float p = sc[g * STS + t];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] += p * vf[e];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < HPT; ++i) {
    const int g = hl + HG * i;
    if (g < ng) {
      float* dst = part_acc + ((head0 + g) * n_split + split) * D + c * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[e] = acc[i][e];
    }
  }
  if (tid < ng) {
    part_ml[((head0 + tid) * n_split + split) * 2] = ml[2 * tid];
    part_ml[((head0 + tid) * n_split + split) * 2 + 1] = ml[2 * tid + 1];
  }
}

// One block per (query head, row), one thread per column: rescale every
// piece's partial to the largest max and sum them.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml, T* __restrict__ o,
                                    int H, int D, int n_split) {
  const size_t head = (size_t)blockIdx.y * H + blockIdx.x;
  const int d = threadIdx.x;
  const float* mls = part_ml + head * n_split * 2;
  float mx = REPRO_NEG_INF;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, mls[2 * s]);
  float lsum = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float c = expf(mls[2 * s] - mx);
    lsum += mls[2 * s + 1] * c;
    a += part_acc[(head * n_split + s) * D + d] * c;
  }
  o[head * D + d] = from_float<T>(a / fmaxf(lsum, 1e-30f));
}

template <typename T, int D>
int launch_split(const void* q, const void* k, const void* v, const int* lengths, void* o,
                 float* part_acc, float* part_ml, int B, int Hk, int G, int S, int n_split,
                 long long bs, long long ss, cudaStream_t stream) {
  const size_t smem = split_smem_bytes<T, D>();
  const cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_gsplit = (G + SGMAX - 1) / SGMAX;
  const dim3 grid(n_split, Hk * n_gsplit, B);
  decode_split_kernel<T, D><<<grid, SNT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      part_acc, part_ml, S, Hk, G, n_gsplit, n_split, bs, ss, (float)(1.0 / sqrt((double)D)));
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return (int)e1;
  decode_merge_kernel<T><<<dim3(Hk * G, B), D, 0, stream>>>(part_acc, part_ml,
                                                          static_cast<T*>(o), Hk * G, D,
                                                          n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_split_d(const void* q, const void* k, const void* v, const int* lengths, void* o,
                   float* part_acc, float* part_ml, int B, int Hk, int G, int D, int S,
                   int n_split, long long bs, long long ss, cudaStream_t stream) {
  switch (D) {
    case 128:
      return launch_split<T, 128>(q, k, v, lengths, o, part_acc, part_ml, B, Hk, G, S,
                                  n_split, bs, ss, stream);
    case 256:
      return launch_split<T, 256>(q, k, v, lengths, o, part_acc, part_ml, B, Hk, G, S,
                                  n_split, bs, ss, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Wide heads (D = 128 or 256).  Arguments as repro_decode_attention, plus
// fp32 scratch for the partials of n_split = ceil(S / 64) (at least 1)
// pieces: part_acc (B, H, n_split, D) and part_ml (B, H, n_split, 2), both
// contiguous.  Returns cudaGetLastError() after the two launches.
extern "C" int repro_decode_attention_split(const void* q, const void* k, const void* v,
                                            const void* lengths, void* o, void* part_acc,
                                            void* part_ml, int B, int H, int Hk, int D, int S,
                                            int dtype, long long bs, long long ss,
                                            int n_split, void* stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || S < 0 ||
      n_split != (S + STS - 1) / STS + (S == 0))
    return (int)cudaErrorInvalidValue;
  const int G = H / Hk;
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_split_d<float>(q, k, v, len, o, pa, pm, B, Hk, G, D, S, n_split, bs, ss, st);
  if (dtype == kBFloat16)
    return launch_split_d<__nv_bfloat16>(q, k, v, len, o, pa, pm, B, Hk, G, D, S, n_split, bs,
                                         ss, st);
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
