// The RG-LRU scan's chunk constants, its gates and its chain across blocks,
// shared by the forward (rglru_scan.cu) and the backward (rglru_scan_bwd.cu),
// so that the backward rebuilds the forward's states bit for bit: a value
// and a ready tag in one 64-bit word a (chunk, row, channel), stored in one
// relaxed store and zeroed by its reader, so no fence or barrier is needed
// and the scratch is left zero for the next launch.
#pragma once

#include "common.cuh"

namespace {

constexpr int NT = 128;               // threads (channels) a block
constexpr int C = 16;                 // tokens a chunk
constexpr float FP64_BAND = -0.5f;    // 2a above this: exp(2a) in fp64
constexpr long long WAIT_LIMIT = 1ll << 32;   // cycles, ~2.4 s
constexpr unsigned long long READY = 1ull << 32;

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long x;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(x) : "l"(p) : "memory");
  return x;
}
__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long x) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(x) : "memory");
}

// The state entering this thread's chunk from its predecessor's word, which
// is then zeroed for the next launch.
__device__ __forceinline__ float take_state(unsigned long long* word) {
  unsigned long long v = ld_relaxed(word);
  if (!(v & READY)) {
    const long long t0 = clock64();
    do {
      __nanosleep(64);
      if (clock64() - t0 > WAIT_LIMIT) __trap();
      v = ld_relaxed(word);
    } while (!(v & READY));
  }
  st_relaxed(word, 0ull);
  return __uint_as_float(static_cast<unsigned>(v));
}

struct Gate {
  float a, g, dg;                     // exp(a), the input gate, ∂g/∂a
};

__device__ __forceinline__ Gate gate(float al) {
  const float a = expf(al);
  const float e2 = 2.f * al > FP64_BAND ? (float)exp(2.0 * (double)al)   // correctly rounded
                                        : __fmul_rn(a, a);
  const float one_m = __fsub_rn(1.f, e2);
  const float g = sqrtf(fmaxf(one_m, 1e-12f));
  return {a, g, one_m >= 1e-12f ? -__fdiv_rn(e2, g) : 0.f};
}

// The ticket of this block: blockIdx.x for a single launch of one chunk a
// chain, else the next of word 0's counter, which the last ticket zeroes.
__device__ __forceinline__ int take_ticket(unsigned long long* scratch, bool chained) {
  if (!chained) return blockIdx.x;
  __shared__ unsigned s_ticket;
  if (threadIdx.x == 0) {
    s_ticket = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
    if (s_ticket == gridDim.x - 1) *reinterpret_cast<unsigned*>(scratch) = 0u;
  }
  __syncthreads();
  return s_ticket;
}

// Hand `value` on through `word`, value and ready tag in one store.
__device__ __forceinline__ void give_state(unsigned long long* word, float value) {
  st_relaxed(word, READY | __float_as_uint(value));
}

// The forward's block: (row b, NT channels, chunk c) from its ticket.
// scratch (chains of more than one chunk): word 0 holds the ticket counter;
// then one word a (chunk c < n_chunks − 1, row, channel), the state leaving
// chunk c, all zero between launches.  h0 may be null (zeros).  With STATES,
// the backward's first launch: the same chain with no outputs over the
// chunks of a scan but its last (every one whole), each writing the state
// it ends in, the state entering chunk c + 1, to hT as (B, n_chunks + 1, W).
template <typename T, bool STATES>
__device__ __forceinline__ void chain_body(const T* __restrict__ x,
                                           const float* __restrict__ a_log,
                                           const float* __restrict__ h0, T* __restrict__ out,
                                           float* __restrict__ hT, unsigned long long* scratch,
                                           int B, int T_len, int W, int n_chunks) {
  const int tid = threadIdx.x;
  const int n_wb = (W + NT - 1) / NT;
  const int n_chain = B * n_wb;
  const int ticket = take_ticket(scratch, n_chunks > 1);
  const int c = ticket / n_chain, chain = ticket % n_chain;
  const int b = chain / n_wb, w = (chain % n_wb) * NT + tid;
  if (w >= W) return;
  // a chunk of the states pass is whole: its loops lose their branches and
  // issue every load at once (with the branches that pass took 17% longer)
  const int n = STATES ? C : min(C, T_len - c * C);
  const size_t base = ((size_t)b * T_len + (size_t)c * C) * W + w;
  const size_t bw = (size_t)b * W + w;

  // every load of the chunk in flight before the first use; a loop stops
  // at the chunk's end by a branch, so a short chunk (the decode step's one
  // token) runs only its own iterations of the unrolled code
  T xs[C];
  float as[C];
#pragma unroll
  for (int u = 0; u < C; ++u) {
    if (u == n) break;
    xs[u] = x[base + (size_t)u * W];
    as[u] = a_log[base + (size_t)u * W];
  }
  const float h_first = c == 0 && h0 != nullptr ? h0[bw] : 0.f;

  // the gates: nothing here needs another block
  float gs[C];
#pragma unroll
  for (int u = 0; u < C; ++u) {
    if (u == n) break;
    const Gate gt = gate(as[u]);
    gs[u] = __fmul_rn(gt.g, to_float(xs[u]));
    as[u] = gt.a;
  }

  // the chain: take the incoming state, walk the chunk, publish its end
  unsigned long long* words = scratch + 1;
  const size_t stride = (size_t)B * W;
  float h = c == 0 ? h_first : take_state(words + (size_t)(c - 1) * stride + bw);
#pragma unroll
  for (int u = 0; u < C; ++u) {
    if (u == n) break;
    h = __fadd_rn(__fmul_rn(as[u], h), gs[u]);
    gs[u] = h;
  }
  if (c + 1 < n_chunks) give_state(words + (size_t)c * stride + bw, h);
  if constexpr (STATES) {
    hT[((size_t)b * (n_chunks + 1) + c + 1) * W + w] = h;
  } else {
    if (c + 1 == n_chunks) hT[bw] = h;
    // the outputs
#pragma unroll
    for (int u = 0; u < C; ++u) {
      if (u == n) break;
      out[base + (size_t)u * W] = from_float<T>(gs[u]);
    }
  }
}

}  // namespace
