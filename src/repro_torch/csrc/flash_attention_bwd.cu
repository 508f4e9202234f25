// Backward of causal GQA flash attention, hand-written for Hopper (sm_90a).
//
// Replaces: no Pallas kernel.  The JAX package trains through jax.grad of
// _flash_jnp (src/repro/kernels/ops.py:57), the chunked jnp version of
// flash_attention_pallas (src/repro/kernels/flash_attention.py:124), whose
// lax.scan over KV tiles XLA differentiates.  The port's forward is a CUDA
// kernel (flash_attention.cu) that autograd cannot see through, so training
// on the card needs this kernel: dQ, dK and dV of
//   O = softmax(Q·Kᵀ·scale + mask)·V,  scale = 1/sqrt(D),
// for q, dO (B, S, H, D) and k, v (B, S, Hk, D), head h on KV head h / G
// (G = H / Hk), with the forward kernel's masks: key j is visible to query
// i when j <= i (causal) and j > i - window (sliding window, window > 0).
// fp32 or bf16 in, fp32 arithmetic throughout, gradients in the input dtype.
//
// What bounds it on the H100: five products of 2·D FLOPs a visible (query,
// key) pair (S, dP, dV, dK, dQ) against q, k, v, dO read and dq, dk, dv
// written once, so at Qwen1.5-0.5B's training shape (8 x 512 tokens, 16
// heads of 64, causal) the FLOPs over 989 TFLOP/s bf16 (~0.011 ms) and the
// bytes over 3.35 TB/s (~0.015 ms) are close.  This first design runs on
// the CUDA cores and is far from either bound; tensor cores (wgmma over
// TMA tiles) and a fused single pass are the next step.
//
// The design, three launches and no atomics, so the gradients are the same
// bits on every launch:
//  1. lse_delta_kernel, one block per (Q tile of 64 rows, head, batch row):
//     recomputes each row's log-sum-exp over its visible keys (online max
//     and sum in fp32, as the forward does) and δ_i = dO_i · O_i, with O
//     the fp32 output, as Σ_j P_ij (dO_i · v_j) in the same online pass.
//     The forward kernels are left as they are (the serving paths call
//     them and keep their times), and the saved bf16 output is not read.
//  2. dkdv_kernel, one block per (KV tile of 64 keys, KV head, batch row):
//     K and V stay in shared memory while the block walks the G query heads
//     of its group and, for each, the Q tiles that see the tile.  For each
//     pair of tiles it rebuilds P = exp(S·scale − LSE), dP = dO·Vᵀ and
//     dS = P ∘ (dP − δ), then adds Pᵀ·dO into dV and dSᵀ·Q into dK in
//     registers.  The group's sum over G happens in the block.
//  3. dq_kernel, one block per (Q tile, head, batch row): Q, dO, LSE and δ
//     stay in shared memory while the block walks the visible KV tiles and
//     adds dS·K into dQ in registers.
// Every tile is widened to fp32 in shared memory, rows padded by one float
// so that a warp's reads down a column fall on distinct banks.  A block's
// 256 threads form a 16 x 16 grid; thread (ty, tx) owns rows ty + 16a and
// columns tx + 16b (a, b < 4) of a 64 x 64 score tile, and rows ty + 16a
// and columns tx + 16c (c < D/16) of a 64 x D gradient tile; a row's max
// and sum in the pre-pass reduce over its 16 threads with shuffles.  Tiles
// no row of a block sees are skipped; keys and rows past S are zero in
// shared memory and masked.
#include "common.cuh"

namespace {

constexpr int BT = 64;         // rows of a Q tile and keys of a KV tile
constexpr int THREADS = 256;   // a 16 x 16 grid of threads
constexpr int PS = BT + 1;     // row pitch of a 64 x 64 tile in shared memory

struct Shape {
  int S, H, Hk, G, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(int i, int j, const Shape& s) {
  return i < s.S && j < s.S && (!s.causal || j <= i) && (s.window <= 0 || j > i - s.window);
}

// First key (inclusive) and last key (exclusive) any row of the Q tile at q0 sees.
__device__ __forceinline__ int key_lo(int q0, const Shape& s) {
  return s.window > 0 ? max(0, q0 - s.window + 1) : 0;
}
__device__ __forceinline__ int key_hi(int q0, const Shape& s) {
  return s.causal ? min(s.S, q0 + BT) : s.S;
}
// First and last (exclusive) query rows that see any key of the KV tile at k0.
__device__ __forceinline__ int query_lo(int k0, const Shape& s) { return s.causal ? k0 : 0; }
__device__ __forceinline__ int query_hi(int k0, const Shape& s) {
  return s.window > 0 ? min(s.S, k0 + BT - 1 + s.window) : s.S;
}

// Rows row0 .. row0 + 63 of head `head` of a (B, S, n_heads, D) tensor into
// dst[64][D + 1] as fp32, rows past S as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int b, int row0,
                                          int head, int n_heads, int S) {
  for (int i = threadIdx.x; i < BT * D; i += THREADS) {
    const int r = i / D, c = i % D, row = row0 + r;
    float x = 0.f;
    if (row < S) x = to_float(src[((static_cast<size_t>(b) * S + row) * n_heads + head) * D + c]);
    dst[r * (D + 1) + c] = x;
  }
}

// acc[a][b] = Σ_d A[ty + 16a][d] · Bt[tx + 16b][d] over two tiles of pitch D + 1.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A, const float* Bt,
                                         int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + 16 * a) * (D + 1) + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = Bt[(tx + 16 * b) * (D + 1) + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

// Over the 16 threads of one tile row (lanes 0-15 or 16-31 of a warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// LSE and δ of the 64 rows of one (Q tile, head, batch row), into (B, H, S)
// fp32.  δ_i = Σ_j P_ij dP_ij = dO_i · O_i with O the output in fp32: it is
// summed here over the keys, online like the LSE, so the rounding of a bf16
// output (up to ~6% of a row's gradient through δ) never enters.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
lse_delta_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
                 Shape s) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [64][D + 1] each
  float* dos = qs + BT * (D + 1);
  float* ks = dos + BT * (D + 1);
  float* vs = ks + BT * (D + 1);
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, hk = h / s.G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<T, D>(qs, q, b, q0, h, s.H, s.S);
  load_tile<T, D>(dos, dout, b, q0, h, s.H, s.S);
  float m[4], l[4], acc[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
    acc[a] = 0.f;
  }
  const int hi = key_hi(q0, s);
  for (int k0 = key_lo(q0, s) / BT * BT; k0 < hi; k0 += BT) {
    __syncthreads();                   // the previous tiles are read; Q, dO are loaded
    load_tile<T, D>(ks, k, b, k0, hk, s.Hk, s.S);
    load_tile<T, D>(vs, v, b, k0, hk, s.Hk, s.S);
    __syncthreads();
    float sc[4][4], dp[4][4];
    tile_dot<D>(sc, qs, ks, ty, tx);
    tile_dot<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ty + 16 * a;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[a][c] = visible(i, k0 + tx + 16 * c, s) ? sc[a][c] * s.scale : -INFINITY;
        mx = fmaxf(mx, sc[a][c]);
      }
      // every lane of the warp takes the shuffles; a row with no visible
      // key yet keeps m = -inf and l = acc = 0
      const float m_new = fmaxf(m[a], row_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f, dsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = expf(sc[a][c] - m_use);
        sum += e;
        dsum = fmaf(e, dp[a][c], dsum);
      }
      const float corr = m[a] == -INFINITY ? 0.f : expf(m[a] - m_use);
      l[a] = l[a] * corr + row_sum(sum);
      acc[a] = acc[a] * corr + row_sum(dsum);
      m[a] = m_new;
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (tx == 0 && i < s.S) {
      const size_t r = (static_cast<size_t>(b) * s.H + h) * s.S + i;
      lse[r] = l[a] > 0.f ? m[a] + logf(l[a]) : INFINITY;
      delta[r] = l[a] > 0.f ? acc[a] / l[a] : 0.f;
    }
  }
}

// P and dS of one (Q tile, KV tile) pair into shared memory: rows are
// queries, columns keys.  lse_s/dl_s hold the Q tile's LSE and δ.
template <int D>
__device__ __forceinline__ void probs_and_dscores(float* ps, float* dss, const float* qs,
                                                  const float* ks, const float* dos,
                                                  const float* vs, const float* lse_s,
                                                  const float* dl_s, int q0, int k0, int ty,
                                                  int tx, const Shape& s) {
  float sc[4][4], dp[4][4];
  tile_dot<D>(sc, qs, ks, ty, tx);
  tile_dot<D>(dp, dos, vs, ty, tx);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = tx + 16 * c;
      const float p = visible(q0 + r, k0 + col, s) ? expf(sc[a][c] * s.scale - lse_s[r]) : 0.f;
      if (ps != nullptr) ps[r * PS + col] = p;
      dss[r * PS + col] = p * (dp[a][c] - dl_s[r]);
    }
  }
}

__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s, const float* __restrict__ lse,
                                          const float* __restrict__ delta, int b, int h, int q0,
                                          const Shape& s) {
  if (threadIdx.x < BT) {
    const int i = q0 + threadIdx.x;
    const size_t r = (static_cast<size_t>(b) * s.H + h) * s.S + i;
    lse_s[threadIdx.x] = i < s.S ? lse[r] : INFINITY;
    dl_s[threadIdx.x] = i < s.S ? delta[r] : 0.f;
  }
}

// dK and dV of one (KV tile, KV head, batch row), summed over the G heads of the group.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Shape s) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BT * (D + 1);
  float* qs = vs + BT * (D + 1);
  float* dos = qs + BT * (D + 1);
  float* ps = dos + BT * (D + 1);      // [64 queries][PS]
  float* dss = ps + BT * PS;           // [64 queries][PS]
  float* lse_s = dss + BT * PS;
  float* dl_s = lse_s + BT;
  const int k0 = blockIdx.x * BT, hk = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  constexpr int NC = D / 16;
  load_tile<T, D>(ks, k, b, k0, hk, s.Hk, s.S);
  load_tile<T, D>(vs, v, b, k0, hk, s.Hk, s.S);
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;
  const int lo = query_lo(k0, s) / BT * BT, hi = query_hi(k0, s);
  for (int g = 0; g < s.G; ++g) {
    const int h = hk * s.G + g;
    for (int q0 = lo; q0 < hi; q0 += BT) {
      __syncthreads();                 // the previous pair's tiles are read
      load_tile<T, D>(qs, q, b, q0, h, s.H, s.S);
      load_tile<T, D>(dos, dout, b, q0, h, s.H, s.S);
      load_rows(lse_s, dl_s, lse, delta, b, h, q0, s);
      __syncthreads();
      probs_and_dscores<D>(ps, dss, qs, ks, dos, vs, lse_s, dl_s, q0, k0, ty, tx, s);
      __syncthreads();
      // dV[j][d] += Σ_i P[i][j] dO[i][d];  dK[j][d] += Σ_i dS[i][j] Q[i][d]
#pragma unroll 4
      for (int i = 0; i < BT; ++i) {
        float pa[4], sa[4], od[NC], qd[NC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = ps[i * PS + ty + 16 * a];
          sa[a] = dss[i * PS + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          od[c] = dos[i * (D + 1) + tx + 16 * c];
          qd[c] = qs[i * (D + 1) + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv_acc[a][c] = fmaf(pa[a], od[c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(sa[a], qd[c], dk_acc[a][c]);
          }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= s.S) continue;
    const size_t base = ((static_cast<size_t>(b) * s.S + j) * s.Hk + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[base + tx + 16 * c] = from_float<T>(dk_acc[a][c] * s.scale);
      dv[base + tx + 16 * c] = from_float<T>(dv_acc[a][c]);
    }
  }
}

// dQ of one (Q tile, head, batch row).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, Shape s) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BT * (D + 1);
  float* ks = dos + BT * (D + 1);
  float* vs = ks + BT * (D + 1);
  float* dss = vs + BT * (D + 1);      // [64 queries][PS]
  float* lse_s = dss + BT * PS;
  float* dl_s = lse_s + BT;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, hk = h / s.G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  constexpr int NC = D / 16;
  load_tile<T, D>(qs, q, b, q0, h, s.H, s.S);
  load_tile<T, D>(dos, dout, b, q0, h, s.H, s.S);
  load_rows(lse_s, dl_s, lse, delta, b, h, q0, s);
  float dq_acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[a][c] = 0.f;
  const int hi = key_hi(q0, s);
  for (int k0 = key_lo(q0, s) / BT * BT; k0 < hi; k0 += BT) {
    __syncthreads();                   // the previous tile is read; Q, dO are loaded
    load_tile<T, D>(ks, k, b, k0, hk, s.Hk, s.S);
    load_tile<T, D>(vs, v, b, k0, hk, s.Hk, s.S);
    __syncthreads();
    probs_and_dscores<D>(nullptr, dss, qs, ks, dos, vs, lse_s, dl_s, q0, k0, ty, tx, s);
    __syncthreads();
    // dQ[i][d] += Σ_j dS[i][j] K[j][d]
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float sa[4], kd[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = dss[(ty + 16 * a) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kd[c] = ks[j * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) dq_acc[a][c] = fmaf(sa[a], kd[c], dq_acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= s.S) continue;
    const size_t base = ((static_cast<size_t>(b) * s.S + i) * s.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[base + tx + 16 * c] = from_float<T>(dq_acc[a][c] * s.scale);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, float* lse, float* delta, int B, int S, int H, int Hk, int causal, int window,
           cudaStream_t stream) {
  const Shape s{S, H, Hk, H / Hk, causal, window, static_cast<float>(1.0 / std::sqrt(double(D)))};
  const int nt = (S + BT - 1) / BT;
  const size_t tile = BT * (D + 1) * sizeof(float);
  const size_t sm_lse = 4 * tile;
  const size_t sm_dkdv = 4 * tile + (2 * BT * PS + 2 * BT) * sizeof(float);
  const size_t sm_dq = 4 * tile + (BT * PS + 2 * BT) * sizeof(float);
  cudaError_t err = allow_smem(lse_delta_kernel<T, D>, sm_lse);
  if (err == cudaSuccess) err = allow_smem(dkdv_kernel<T, D>, sm_dkdv);
  if (err == cudaSuccess) err = allow_smem(dq_kernel<T, D>, sm_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  lse_delta_kernel<T, D><<<dim3(nt, H, B), THREADS, sm_lse, stream>>>(qt, kt, vt, dot, lse,
                                                                      delta, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, D><<<dim3(nt, Hk, B), THREADS, sm_dkdv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, D><<<dim3(nt, H, B), THREADS, sm_dq, stream>>>(qt, kt, vt, dot, lse, delta,
                                                               static_cast<T*>(dq), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, const void* dout, void* dq,
                 void* dk, void* dv, float* lse, float* delta, int B, int S, int H, int Hk, int D,
                 int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H, Hk, causal,
                                  window, stream);
    case 32: return launch<T, 32>(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H, Hk, causal,
                                  window, stream);
    case 64: return launch<T, 64>(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H, Hk, causal,
                                  window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, dout, dq: (B, S, H, D); k, v, dk, dv: (B, S, Hk, D), all contiguous and
// of one dtype (0 float32, 1 bfloat16); lse, delta: (B, H, S) float32
// scratch.  window <= 0 means no window.  Three launches on `stream`;
// returns cudaGetLastError() after them (0 on success).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         void* lse, void* delta, int B, int S, int H, int Hk,
                                         int D, int dtype, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(delta);
  if (dtype == kFloat32)
    return launch_dtype<float>(q, k, v, dout, dq, dk, dv, l, d, B, S, H, Hk, D, causal, window,
                               st);
  if (dtype == kBFloat16)
    return launch_dtype<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, l, d, B, S, H, Hk, D, causal,
                                       window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
