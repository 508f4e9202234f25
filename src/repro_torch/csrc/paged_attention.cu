// Paged decode attention, hand-written for Hopper (sm_90a): one new query
// token per sequence against a KV cache held in a refcounted page pool.
//
// Replaces: paged_attention_pallas in src/repro/kernels/paged_attention.py
// (the Pallas TPU kernel, body _kernel).  Same function: q (B, 1, H, D)
// against k_pool, v_pool (P, ps, Hk, D) through table (B, n_cols) int32 and
// lengths (B,): row b attends the positions pos < min(lengths[b], n_cols·ps)
// whose page table[b, pos / ps] is mapped (< P); sentinel pages and positions
// at or past the length are skipped.  fp32 online softmax with the TPU
// kernel's finite NEG_INF, so a row with nothing to attend (a retired slot
// whose table is all sentinels) gives acc / max(l, 1e-30) = 0, never NaN.
//
// What bounds it on the H100: at serving shapes, latency.  Each step reads
// every live K/V row once, about 4·D·Hk bytes per position in bf16, and does
// 4·D FLOPs per (query head, position): memory-bound in principle, but a
// serving step moves only a few MB, which the card's bandwidth clears in
// about a microsecond, so the launch and the chain of dependent memory
// latencies (lengths and table, then K/V, then the merge) set the time.
//
// What the design does about it (decode_body.cuh holds the body, shared with
// the contiguous kernel; only the address of a K/V row differs):
//  * One block of NW = 8 warps per (KV head, batch row, slice of up to 8
//    query heads).  The block copies its table row into shared memory while
//    it reads its length (this replaces the TPU kernel's scalar prefetch),
//    one barrier before any K/V load; then each warp takes a contiguous
//    range of the positions and issues all its K/V loads of a sub-tile at
//    once: one memory latency for the whole row at serving lengths, and no
//    block barrier inside the loop.  It reads only the table entries of its
//    own row, and never a position on a sentinel page or past the length.
//  * The pool is indexed in its (P, ps, Hk, D) layout; no transposed copy of
//    the pool is made (the TPU wrapper's transpose is a full pool copy).
//  * All query heads of a slice share each K/V row a warp loads, so GQA reads
//    the cache once per slice.  A slice holds up to 8 query heads, 4 at
//    D = 192 (Nemotron-4-340B's 12 heads a KV head run as 3 slices), where
//    a row is a whole warp's 32 lanes of 6 columns (decode_body.cuh).
#include "decode_body.cuh"

namespace {

using decode_body::NT;

// One block an SM is enough to fill the card at serving shapes, and lets a
// thread hold the q and acc of eight query heads in registers without spilling.
template <typename T, int D, int GB>
__global__ void __launch_bounds__(NT, 1)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ o, int n_cols, int n_pool,
                    int ps, int Hk, int G, int n_gsplit, float scale) {
  extern __shared__ int trow[];                      // n_cols: this row's table
  const int h = blockIdx.x / n_gsplit;               // KV head
  const int g0 = (blockIdx.x % n_gsplit) * GB;       // first query head of the slice
  const int b = blockIdx.y;
  for (int c = threadIdx.x; c < n_cols; c += NT) trow[c] = table[(size_t)b * n_cols + c];
  const int n = max(0, min(lengths[b], n_cols * ps));
  __syncthreads();
  const size_t q_off = ((size_t)b * Hk * G + (size_t)h * G + g0) * D;
  decode_body::attend<T, D, GB>(q + q_off, k_pool + (size_t)h * D, v_pool + (size_t)h * D,
                                decode_body::PagedRows{trow, ps, n_pool, (long long)Hk * D}, n,
                                min(GB, G - g0), scale, o + q_off);
}

template <typename T, int D, int GB>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* table,
           const int* lengths, void* o, int B, int n_cols, int n_pool, int ps, int Hk, int G,
           cudaStream_t stream) {
  // the table row is dynamic shared memory beside the body's static merge
  // room (NW·GB·(D + 2) floats, 33 KB at D = 128, GB = 8, 25 KB at D = 192,
  // GB = 4); past 48 KB in all
  // the launch must opt in
  const size_t smem = sizeof(int) * (size_t)n_cols;
  const size_t smem_static = sizeof(float) * decode_body::NW * GB * (D + 2);
  if (smem + smem_static > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, D, GB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_gsplit = (G + GB - 1) / GB;
  const dim3 grid(Hk * n_gsplit, B);
  paged_decode_kernel<T, D, GB><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      table, lengths, static_cast<T*>(o), n_cols, n_pool, ps, Hk, G, n_gsplit,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_g(const void* q, const void* k_pool, const void* v_pool, const int* table,
             const int* lengths, void* o, int B, int n_cols, int n_pool, int ps, int Hk, int G,
             cudaStream_t stream) {
  switch (decode_body::heads_per_block(G, D)) {
    case 1:
      return launch<T, D, 1>(q, k_pool, v_pool, table, lengths, o, B, n_cols, n_pool, ps, Hk, G,
                             stream);
    case 2:
      return launch<T, D, 2>(q, k_pool, v_pool, table, lengths, o, B, n_cols, n_pool, ps, Hk, G,
                             stream);
    case 4:
      return launch<T, D, 4>(q, k_pool, v_pool, table, lengths, o, B, n_cols, n_pool, ps, Hk, G,
                             stream);
    default:
      return launch<T, D, decode_body::gmax(D)>(q, k_pool, v_pool, table, lengths, o, B,
                                                n_cols, n_pool, ps, Hk, G, stream);
  }
}

template <typename T>
int launch_d(const void* q, const void* k_pool, const void* v_pool, const int* table,
             const int* lengths, void* o, int B, int n_cols, int n_pool, int ps, int Hk, int G,
             int D, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_g<T, 16>(q, k_pool, v_pool, table, lengths, o, B, n_cols, n_pool, ps, Hk, G,
                             stream);
    case 32:
      return launch_g<T, 32>(q, k_pool, v_pool, table, lengths, o, B, n_cols, n_pool, ps, Hk, G,
                             stream);
    case 64:
      return launch_g<T, 64>(q, k_pool, v_pool, table, lengths, o, B, n_cols, n_pool, ps, Hk, G,
                             stream);
    case 128:
      return launch_g<T, 128>(q, k_pool, v_pool, table, lengths, o, B, n_cols, n_pool, ps, Hk,
                              G, stream);
    case 192:
      return launch_g<T, 192>(q, k_pool, v_pool, table, lengths, o, B, n_cols, n_pool, ps, Hk,
                              G, stream);
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
