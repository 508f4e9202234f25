// Paged decode attention, hand-written for Hopper (sm_90a): one new query
// token per sequence against a KV cache held in a refcounted page pool.
//
// Replaces: paged_attention_pallas in src/repro/kernels/paged_attention.py
// (the Pallas TPU kernel, body _kernel).  Same function: q (B, 1, H, D)
// against k_pool, v_pool (P, ps, Hk, D) through table (B, n_cols) int32 and
// lengths (B,): row b attends the positions pos < lengths[b] whose page
// table[b, pos / ps] is mapped (< P); sentinel pages and positions at or past
// the length are skipped.  fp32 online softmax with the TPU kernel's finite
// NEG_INF, so a row with nothing to attend (a retired slot whose table is all
// sentinels) gives acc / max(l, 1e-30) = 0, never NaN.
//
// What bounds it on the H100: memory.  Each step reads every live K/V row
// once, about 4·D·Hk bytes per position in bf16, and does 4·D FLOPs per
// (query head, position): a few FLOPs per byte, far below the ~295 the card
// needs to be compute-bound.
//
// What the design does about it:
//  * One block per (KV head, batch row).  The block copies its own table row
//    into shared memory (this replaces the TPU kernel's scalar prefetch) and
//    walks the sequence in chunks of TK positions, issuing every 16-byte load
//    of a chunk's K and V rows before storing any, so a chunk costs about one
//    memory latency whatever the page size; positions past the length, or on
//    a sentinel page, are never loaded.
//  * The pool is indexed in its (P, ps, Hk, D) layout; no transposed copy of
//    the pool is made (the TPU wrapper's transpose is a full pool copy).
//  * All G = H / Hk query heads of the KV head share each staged chunk, so
//    GQA reads the cache once per group.
//  * Scores, probabilities and the running (m, l, acc) live in shared memory
//    in fp32; the K tile is padded by one float per row so the score loop is
//    free of bank conflicts.
#include "common.cuh"

namespace {

constexpr int TK = 64;   // sequence positions staged per chunk
constexpr int NT = 128;  // threads per block

template <int D>
size_t smem_bytes(int G, int n_cols) {
  return sizeof(float) * ((size_t)TK * (D + 1) + (size_t)TK * D + 2 * (size_t)G * D +
                          (size_t)G * TK + 3 * (size_t)G) +
         sizeof(int) * ((size_t)TK + n_cols);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ o, int n_cols, int n_pool,
                    int ps, int Hk, int G, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                      // TK x (D + 1)
  float* vs = ks + TK * (D + 1);       // TK x D
  float* qs = vs + TK * D;             // G x D
  float* acc = qs + G * D;             // G x D
  float* ss = acc + G * D;             // G x TK: scores, then probabilities
  float* m_run = ss + G * TK;          // G
  float* l_run = m_run + G;            // G
  float* corr = l_run + G;             // G
  int* row_of = reinterpret_cast<int*>(corr + G);  // TK: pool row, or -1
  int* trow = row_of + TK;                          // n_cols: this row's table

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int H = Hk * G;
  const size_t q_off = ((size_t)b * H + (size_t)h * G) * D;

  for (int i = tid; i < G * D; i += NT) {
    qs[i] = to_float(q[q_off + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    m_run[g] = REPRO_NEG_INF;
    l_run[g] = 0.f;
  }
  for (int c = tid; c < n_cols; c += NT) trow[c] = table[(size_t)b * n_cols + c];

  constexpr int VEC = Vec<T>::N;                 // elements per 16-byte load
  constexpr int VPR = D / VEC;                   // vectors per K/V row
  constexpr int PER = TK * VPR / NT;             // vectors of K (and of V) per thread
  static_assert(TK * VPR % NT == 0, "a chunk must split evenly over the threads");
  const int n_pos = min(lengths[b], n_cols * ps);  // positions the table can map
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int base = 0; base < n_pos; base += TK) {
    __syncthreads();  // the previous chunk is consumed
    if (tid < TK) {
      const int pos = base + tid;
      int row = -1;
      if (pos < n_pos) {
        const int page = trow[pos / ps];
        if (page >= 0 && page < n_pool) row = page * ps + pos % ps;
      }
      row_of[tid] = row;
    }
    __syncthreads();
    {
      // every K and V vector of the chunk is in flight before any is stored
      uint4 kr[PER], vr[PER];
#pragma unroll
      for (int r = 0; r < PER; ++r) {
        const int i = tid + r * NT;
        const int row = row_of[i / VPR];
        kr[r] = make_uint4(0u, 0u, 0u, 0u);
        vr[r] = kr[r];
        if (row >= 0) {
          const size_t off = ((size_t)row * Hk + h) * D + (i % VPR) * VEC;
          kr[r] = load_vec(k_pool + off);
          vr[r] = load_vec(v_pool + off);
        }
      }
#pragma unroll
      for (int r = 0; r < PER; ++r) {
        const int i = tid + r * NT;
        const int t = i / VPR;
        store_widened(ks + t * (D + 1) + (i % VPR) * VEC, kr[r], T());
        store_widened(vs + t * D + (i % VPR) * VEC, vr[r], T());
      }
    }
    __syncthreads();
    for (int i = tid; i < G * TK; i += NT) {
      const int g = i / TK;
      const int t = i - g * TK;
      const float* qg = qs + g * D;
      const float* kt = ks + t * (D + 1);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qg[d] * kt[d];
      ss[i] = row_of[t] >= 0 ? dot * scale : REPRO_NEG_INF;
    }
    __syncthreads();
    for (int g = warp; g < G; g += NT / 32) {  // one warp per query head
      float* sg = ss + g * TK;
      float mx = REPRO_NEG_INF;
      for (int t = lane; t < TK; t += 32) mx = fmaxf(mx, sg[t]);
      mx = warp_max(mx);
      const float m_prev = m_run[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < TK; t += 32) {
        const float p = row_of[t] >= 0 ? expf(sg[t] - m_new) : 0.f;
        sg[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[g] = c;
        l_run[g] = l_run[g] * c + sum;
        m_run[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = ss + g * TK;
      float a = acc[i] * corr[g];
#pragma unroll 8
      for (int t = 0; t < TK; ++t) a += pg[t] * vs[t * D + d];
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    o[q_off + i] = from_float<T>(acc[i] / fmaxf(l_run[g], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* table,
           const int* lengths, void* o, int B, int n_cols, int n_pool, int ps, int Hk, int G,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(G, n_cols);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(Hk, B);
  paged_decode_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      table, lengths, static_cast<T*>(o), n_cols, n_pool, ps, Hk, G, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k_pool, const void* v_pool, const int* table,
             const int* lengths, void* o, int B, int n_cols, int n_pool, int ps, int Hk, int G,
             int D, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k_pool, v_pool, table, lengths, o, B, n_cols, n_pool, ps, Hk, G,
                           stream);
    case 32:
      return launch<T, 32>(q, k_pool, v_pool, table, lengths, o, B, n_cols, n_pool, ps, Hk, G,
                           stream);
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, table, lengths, o, B, n_cols, n_pool, ps, Hk, G,
                           stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, 1, H, D); k_pool/v_pool: (P, ps, Hk, D); table: (B, n_cols) int32;
// lengths: (B,) int32; o: (B, 1, H, D).  All contiguous; q, pools and o share
// one dtype (dtype: 0 float32, 1 bfloat16).  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int repro_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                     const void* table, const void* lengths, void* o, int B,
                                     int H, int D, int n_pool, int ps, int Hk, int n_cols,
                                     int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || ps <= 0 || n_cols <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hk;
  const int* tab = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_d<float>(q, k_pool, v_pool, tab, len, o, B, n_cols, n_pool, ps, Hk, G, D, st);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(q, k_pool, v_pool, tab, len, o, B, n_cols, n_pool, ps, Hk, G,
                                   D, st);
  return (int)cudaErrorInvalidValue;
}
