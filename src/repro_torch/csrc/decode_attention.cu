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

}  // namespace

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
