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
// Wide heads (D = 128, 256) take a second design, decode_split_kernel and
// decode_merge_kernel below ("flash-decoding"), entered through
// repro_decode_attention_split.  The design above runs one block per (row,
// KV head, slice of at most 8 query heads): at RecurrentGemma-9B's decode
// (B = 4, Hk = 1) that lights 4 of 132 SMs, and under MQA with G = 16 it
// would read every row twice.
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
  switch (decode_body::heads_per_block(G)) {
    case 1:
      return launch<T, D, 1>(q, k, v, lengths, o, B, Hk, G, S, bs, ss, stream);
    case 2:
      return launch<T, D, 2>(q, k, v, lengths, o, B, Hk, G, S, bs, ss, stream);
    case 4:
      return launch<T, D, 4>(q, k, v, lengths, o, B, Hk, G, S, bs, ss, stream);
    default:
      return launch<T, D, decode_body::GMAX>(q, k, v, lengths, o, B, Hk, G, S, bs, ss, stream);
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
