// Causal GQA flash attention for prefill, hand-written for Hopper (sm_90a).
//
// Replaces: flash_attention_pallas in src/repro/kernels/flash_attention.py
// (the Pallas TPU kernel, body _kernel).  Same function: q (B, S, H, D)
// against k, v (B, S, Hk, D), query row i attends keys j <= i (causal) and
// j > i - window (sliding window), scores scaled by 1/sqrt(D), fp32 online
// softmax with the TPU kernel's finite NEG_INF, output (B, S, H, D) in the
// input dtype.
//
// What bounds it on the H100: prefill attention does 4·D FLOPs per visible
// (query, key) pair on about 2·D·(H + Hk) bytes per token, so at the serving
// shapes (S >= 128, D = 64) it is bound by arithmetic, not by memory.  This
// first version computes on the fp32 CUDA cores (67 TFLOP/s on the card),
// not on the tensor cores (989 TFLOP/s bf16), so it cannot reach the bound;
// wgmma and TMA staging are later work.
//
// What the design does about it:
//  * One block per (query tile of BQ rows, head, batch row); each thread owns
//    one query row and keeps q and its fp32 accumulator in registers, so the
//    only shared-memory traffic is the K/V tile, read as broadcasts.
//  * The TPU grid's sequential KV axis becomes a loop inside the block over
//    KV tiles of BK keys, staged in shared memory (converted to fp32 once)
//    with 16-byte loads, several in flight per thread.
//  * KV tiles that the causal mask or the window hide from every row of the
//    query tile are never loaded (the TPU kernel's pl.when skip).
//  * The layout is the JAX one, (B, S, H, D), strided directly: no transposes.
//  * GQA: head h reads KV head h / (H / Hk).
#include "common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block, one per thread
constexpr int BK = 64;  // keys per shared-memory tile
constexpr int CH = 16;  // keys scored per online-softmax update
static_assert(BQ == BK, "each thread stages the same share of every tile row");

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int H, int Hk, int causal, int window, float scale) {
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x;
  const int qi = q_start + tid;
  const bool row_ok = qi < S;

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
  const int q_last = min(q_start + BQ, S) - 1;
  const int n_tiles = (S + BK - 1) / BK;
  const int hi = causal ? min(n_tiles, q_last / BK + 1) : n_tiles;
  int lo = 0;
  if (window > 0) {
    const int first = q_start - window + 1;  // earliest key row q_start sees
    lo = first > 0 ? first / BK : 0;
  }

  constexpr int VEC = Vec<T>::N;                 // elements per 16-byte load
  constexpr int VPR = D / VEC;                   // vectors per K/V row
  constexpr int GROUP = VPR < 4 ? VPR : 4;       // vectors in flight per thread
  static_assert(VPR % GROUP == 0, "tile rows must split into whole groups");
  const size_t row_stride = (size_t)Hk * D;
  const T* kb = k + (size_t)b * S * row_stride + (size_t)hk * D;
  const T* vb = v + (size_t)b * S * row_stride + (size_t)hk * D;

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
        if (kp < S) {
          const size_t off = (size_t)kp * row_stride + (i % VPR) * VEC;
          kr[g] = load_vec(kb + off);
          vr[g] = load_vec(vb + off);
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
      if (k0 + c >= S || (causal && k0 + c > q_last)) break;  // no row sees these keys
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
        const bool ok = kp < S && (!causal || kp <= qi) && (window <= 0 || kp > qi - window);
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int Hk,
           int causal, int window, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, Hk, causal, window, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int Hk,
             int D, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, Hk, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, Hk, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, Hk, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, S, H, D), k/v: (B, S, Hk, D), o: (B, S, H, D), all contiguous and of
// one dtype (dtype: 0 float32, 1 bfloat16).  window <= 0 means no window.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int S, int H, int Hk, int D, int dtype, int causal,
                                     int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_d<float>(q, k, v, o, B, S, H, Hk, D, causal, window, st);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, S, H, Hk, D, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
