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
//
// Wide heads (D = 128, 256) take a second design, flash_wide_kernel below:
// one query row's q and fp32 accumulator in registers would need 2·D
// registers a thread (512 at D = 256, against the limit of 255), and fp32
// K/V tiles of 64 keys 128 KB of static shared memory (limit 48 KB).
//  * A block takes a tile of M = 64 (position, head) rows: BQP = 64 / GH
//    query positions times GH query heads of one KV head (GH = G when G
//    divides 64; under MQA with H = 16, 4 positions × 16 heads), so each
//    K/V tile it loads serves every head of the group.
//  * Its 256 threads form a 16 × 16 grid: thread (ty, tx) owns rows
//    4·ty .. 4·ty + 3, scores those rows against keys tx and tx + 16 of
//    the tile, and accumulates output columns (tx + 16·j)·VEC .. + VEC.
//    The accumulator is split over the 16 threads of a row (64 floats a
//    thread at D = 256), and a row's max and sum are reduced across them
//    with shuffles; q sits in shared memory in fp32.
//  * K and V tiles of BK = 32 keys are staged in the input dtype in dynamic
//    shared memory by cp.async (16 bytes a copy, rows past S zero-filled),
//    each row padded by 16 bytes so the 16 keys a phase reads fall in
//    distinct banks; the probabilities go through shared memory to the
//    P·V product.
//  * The causal and window skip of KV tiles is the same as above.
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

// ---- wide heads: D = 128, 256 ------------------------------------------
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

template <typename T, int D>
__global__ void __launch_bounds__(WNT)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, int S, int H, int Hk, int GH, int causal, int window,
                  float scale) {
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
  const int q_last = min(q0 + bqp, S) - 1;
  const int n_tiles = (S + WBK - 1) / WBK;
  const int hi = causal ? min(n_tiles, q_last / WBK + 1) : n_tiles;
  int lo = 0;
  if (window > 0) {
    const int first = q0 - window + 1;  // earliest key position q0 sees
    lo = first > 0 ? first / WBK : 0;
  }
  const size_t row_stride = (size_t)Hk * D;
  const T* kb = k + (size_t)b * S * row_stride + (size_t)hk * D;
  const T* vb = v + (size_t)b * S * row_stride + (size_t)hk * D;

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * WBK;
    __syncthreads();  // every thread is done with the previous tile and its P
    for (int i = tid; i < WBK * VPR; i += WNT) {
      const int kr = i / VPR;
      const int c = (i % VPR) * VEC;
      const int kp = k0 + kr;
      const size_t off = (size_t)(kp < S ? kp : 0) * row_stride + c;
      const int n = kp < S ? 16 : 0;
      cp_async16(ks + kr * KS + c, kb + off, n);
      cp_async16(vs + kr * KS + c, vb + off, n);
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
      const int pos = pos_r[i];
      bool ok[WKPT];
      float m_tile = REPRO_NEG_INF;
#pragma unroll
      for (int jj = 0; jj < WKPT; ++jj) {
        const int kp = k0 + tx + WTX * jj;
        ok[jj] = kp < S && (!causal || kp <= pos) && (window <= 0 || kp > pos - window);
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

    const int n_keys = min(WBK, S - k0);
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
int launch_wide(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                int Hk, int causal, int window, cudaStream_t stream) {
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
      static_cast<T*>(o), S, H, Hk, GH, causal, window, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
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
    case 128: return launch_wide<T, 128>(q, k, v, o, B, S, H, Hk, causal, window, stream);
    case 256: return launch_wide<T, 256>(q, k, v, o, B, S, H, Hk, causal, window, stream);
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
