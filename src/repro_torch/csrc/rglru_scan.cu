// RG-LRU scan (RecurrentGemma's gated diagonal linear recurrence),
// hand-written for Hopper (sm_90a).
//
// Replaces: rglru_pallas in src/repro/kernels/rglru_scan.py (the Pallas TPU
// kernel, body _kernel).  Same function, per channel (b, w), with an fp32
// state h carried over the tokens:
//     h_t = exp(a_t) · h_{t−1} + sqrt(max(1 − exp(2·a_t), 1e-12)) · x_t
// x (B, T, W) in the model dtype (float32 or bfloat16), a_log (B, T, W) in
// float32 (every a_t ≤ 0, so every decay is exp of a non-positive number),
// state (B, W) float32; returns h (B, T, W) in x's dtype and the final state
// in float32.  The TPU kernel pads T to a multiple of its chunk with the
// identity step x = 0, a_log = 0; this kernel runs over the T valid tokens.
//
// What bounds it on the H100: memory.  Each token and channel reads x (2 or
// 4 bytes) and a_log (4 bytes) and writes h (2 or 4 bytes) for 8 operations;
// at RecurrentGemma-9B's prefill (B = 4, T = 3072, W = 4096, bf16) that is
// ~403 MB, ~0.12 ms at 3.35 TB/s.  At decode (T = 1) it moves 0.26 MB and is
// bound by the launch.
//
// What the design does about it: the TPU walks its chunks in order on one
// core; here the tokens are split over blocks so that enough loads are in
// flight to fill the card.  A block is (row b, NT channels, chunk of C
// tokens): 24,576 blocks at RecurrentGemma-9B's prefill, against 128 in the
// kernel this one replaces, which walked all T tokens of a channel in one
// thread.
//  * One thread a channel, adjacent threads on adjacent channels, so every
//    load and store of a warp is one contiguous run.  A thread issues all 2C
//    loads of its chunk (x and a_log, into registers) before it uses any.
//    C = 16 keeps a thread within 64 registers, so 8 blocks (1,024 threads)
//    fit an SM and their loads and gates overlap; 32 tokens at 128
//    registers, half as many threads, were slower on the card, and 8 tokens
//    spilled.
//  * Before it needs any other block, each thread takes its chunk's gates,
//    a_t = exp(a_log_t) and g_t = sqrt(max(1 − exp(2a_t), 1e-12)) · x_t, and
//    keeps them in registers.
//  * The chain, in one launch: blocks take chunk-major tickets from an
//    atomic counter, so the chunk a block waits on belongs to a block that
//    is already running and every wait ends.  Each thread waits for its own
//    channel's incoming state in a 64-bit word of the scratch (the value
//    and a ready tag together, so one store publishes both and no fence or
//    barrier is needed) and zeroes the word; it then walks its C tokens,
//    h_t = a_t · h_{t−1} + g_t, and publishes the end for the next chunk
//    before it stores any output.  A wait past ~2.4 s traps.  The block that
//    takes the last ticket zeroes the counter, and every word is zeroed by
//    its reader, so the scratch is ready for the next launch (a CUDA graph
//    can replay it).
//  * The state a chunk hands on is the token-by-token walk's own, not a
//    composed P · h_in + L (P the chunk's decay, L its walk from 0): with
//    gates within 1e-6 of 0, each fp32 step a · h moves h by less than a
//    unit of its last place and rounds, and only a walk of the same steps
//    rounds alike; the composed form, with P as exp of the log-gate sum or
//    as the product of the rounded gates, ends over 1e-5 from the fp32
//    plain version and oracle at 3,072 tokens, on the card and in
//    tests/test_torch_rglru_design.py.  The walk adds C dependent steps to
//    each link of the chain and cost no time that the card showed.
//
// Numerics: the TPU kernel's expression 1 − exp(2a) clamped at 1e-12 (not
// −expm1(2a), which would not clamp where a lies within ~1e-6 of 0); the
// update as a rounded product plus a rounded sum, never contracted into an
// FMA, in the plain version's order; no --use_fast_math.  exp(2a) is taken
// correctly rounded (in fp64, rounded once) where 2a > FP64_BAND = −0.5:
// near 0, 1 − exp(2a) keeps only the few bits that exp rounds, and one unit
// in the last place of exp moves the gate by up to ~1e-4 relative.  Below
// the band it is a · a (a = expf(a_t), within 2 units): within ~4.5 units
// of exp(2a), which moves the gate by < 2.1e-7 relative, and the fp64 pipe
// (64 units an SM against 128 for fp32) is left out
// (benchmarks/torch_decode_turns.py times the kernel with fp64 everywhere
// beside it).  So the kernel is the plain version's
// recurrence to the bit wherever every 2a > −0.5, and within a few units
// elsewhere.  chip_smoke.py holds it to the plain version (2e-5 fp32, 2e-2
// bf16, scaled by 1 + |h|) and, in fp32, to the token-by-token oracle
// ref.rglru_ref at 1e-5.
#include "common.cuh"
#include "rglru_chain.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(NT, 8)
rglru_kernel(const T* __restrict__ x, const float* __restrict__ a_log,
             const float* __restrict__ h0, T* __restrict__ out, float* __restrict__ hT,
             unsigned long long* scratch, int B, int T_len, int W, int n_chunks) {
  chain_body<T, false>(x, a_log, h0, out, hT, scratch, B, T_len, W, n_chunks);
}

template <typename T>
int launch(const void* x, const float* a_log, const float* h0, void* out, float* hT,
           unsigned long long* scratch, int B, int T_len, int W, cudaStream_t stream) {
  const int n_chunks = (T_len + C - 1) / C;
  if (n_chunks > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)n_chunks * B * ((W + NT - 1) / NT);
  rglru_kernel<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(x), a_log, h0,
                                           static_cast<T*>(out), hT, scratch, B, T_len, W,
                                           n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// Tokens a chunk: the wrapper sizes the scratch from it.
extern "C" int repro_rglru_chunk() { return C; }

// x: (B, T, W) of dtype (0 float32, 1 bfloat16); a_log: (B, T, W) float32;
// state: (B, W) float32; out: (B, T, W) of dtype; h_out: (B, W) float32.
// All contiguous.  scratch: for T > C, 1 + (ceil(T / C) − 1) · B · W words
// of 8 bytes, all zero before the first launch (the kernel leaves them
// zero); unused, and may be null, at T ≤ C.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int repro_rglru_scan(const void* x, const void* a_log, const void* state, void* out,
                                void* h_out, void* scratch, int B, int T_len, int W, int dtype,
                                void* stream) {
  if (B <= 0 || T_len <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const float* al = static_cast<const float*>(a_log);
  const float* h0 = static_cast<const float*>(state);
  float* hT = static_cast<float*>(h_out);
  auto* sc = static_cast<unsigned long long*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(x, al, h0, out, hT, sc, B, T_len, W, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, al, h0, out, hT, sc, B, T_len, W, st);
  return (int)cudaErrorInvalidValue;
}
