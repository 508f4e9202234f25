// RWKV6 ("Finch") WKV recurrence, hand-written for Hopper (sm_90a).
//
// Replaces: wkv6_pallas in src/repro/kernels/rwkv6_scan.py (the Pallas TPU
// kernel, body _kernel).  Same function, per (row b, head h), with an fp32
// (D, D) state S carried over the tokens:
//     o_t = r_t · (S + diag(u) k_tᵀ v_t),   S ← diag(w_t) S + k_tᵀ v_t
// r, k, v (B, T, H, D) and u (H, D) in the model dtype (float32 or
// bfloat16), w (B, T, H, D) in float32, state (B, H, D, D) float32; returns
// o (B, T, H, D) in the model dtype, rounded once, and the final state in
// float32.
//
// Unlike the TPU kernel, no exponent is clamped.  Within a chunk of C = 32
// tokens, with L the inclusive cumulative log-decay per channel, Le = L − lw
// its exclusive version and LC the chunk's total, every decay is exp of a
// non-positive number:
//     o_t  = Σ_d r_td e^{Le_td} S_de + Σ_{s<t} (Σ_d r_td k_sd e^{Le_td − L_sd}) v_s
//            + (Σ_d r_td u_d k_td) v_t
//     S_de ← e^{LC_d} S_de + ΔS_de,   ΔS_de = Σ_s k_sd e^{LC_d − L_sd} v_se
// so the result is exact to fp32 rounding for any w in (0, 1].  (The TPU
// kernel factors e^{Le_t − L_s} as e^{clip(Le_t)} · e^{clip(−L_s)}, clipped
// at ±30, which is wrong once a chunk's log-decay falls below −30; RWKV6's
// own decay init reaches −19 to −53 over a chunk of 32.)  No exponent is
// taken as a difference of two cumulative sums: with decays down to 1e-12
// those run to hundreds, where their fp32 rounding moves a decay near 1 by
// ~1e-4, and the outputs that far from the token-by-token oracle.  Each
// exponent is instead a sum of log-decays of one sign, over the chunk's
// groups of four tokens (the pair tiles' rows):
//     A_t  = Σ lw over t's group before t,   B_s = Σ lw over s's group after s,
//     P_g, Q_g = Σ group totals before, after g,  G_{g,h} = Σ those strictly
//     between h < g,
//     Le_t − L_s = (A_t + G) + B_s, or within one group the logs strictly
//                  between s and t (none, lw_{s+1}, or lw_{s+1} + lw_{s+2}),
//     Le_t = P_g + A_t,   LC − L_s = B_s + Q_g,   LC = Σ all totals,
// so each is within a few fp32 roundings of its own size, and the kernel's
// outputs stay within fp32's own error of the exact result (the plain
// version computes in float64).  A chunk cut short by the end of the
// sequence runs as if padded with w = 1 and r = k = v = 0.
//
// Two paths behind the one entry, chosen by the number of tokens.
//
// Prefill (T > 1): a chunk-parallel scan, wkv6_prefill_kernel, one block
// per (chunk, head, row): 2,560 blocks at RWKV6-3B's prefill, against 160
// in the kernel this one replaces, which walked a (row, head)'s 16 chunks
// in series inside one block.  Only two terms chain across chunks,
// S_c = e^{LC_c} ⊙ S_{c−1} + ΔS_c and the state read (r e^{Le}) S_{c−1};
// ΔS_c, e^{LC_c}, the pair scores and the bonus terms depend on the chunk's
// own tokens alone.  What bounds it on the H100: about 5·D² fp32 FLOPs per
// token and head (0.025 ms at RWKV6-3B's prefill, against 0.020 ms for the
// bytes of r, k, v, w and o) plus an ex2 per (pair, channel) on the SFU.
// The design:
//  * Tickets, not blockIdx, order the blocks: a block takes the next
//    ticket of an atomic counter, chunk-major, so the chunk it waits on
//    belongs to a block that is already running, and every wait ends.
//  * Everything that does not need the incoming state comes first: r, k, v
//    and log w staged with 16-byte loads by every warp, all of a thread's
//    loads in flight together, then the group sums by one thread a
//    channel; the pair scores over the 36 lower 4 × 4 (t, s)
//    tiles only (28 below the diagonal, 8 lanes each; 8 on it, 4 lanes
//    each, where s = t gives the bonus term), every loaded operand feeding
//    four pairs, each pair decay below the diagonal one ex2 of the
//    log2-scaled exponent (three ex2 a channel on it), a warp's items all
//    of one kind; then ΔS_c as a register-tiled
//    (D × C)·(C × D) product, 4 × 4 a thread.
//  * The chain step: after the pair scores thread 0 waits on the
//    predecessor's flag with an acquire load (by then it has nearly always
//    published), the block copies S_{c−1} from the (row, head)'s slot
//    into shared memory through L2 (cp.async, no registers held) while it
//    takes the decays and ΔS_c, then writes
//    S_c = e^{LC} S_{c−1} + ΔS_c (the product and the sum rounded apart)
//    to the other slot, or to the final state, and
//    publishes it with a fence and a release store.
//    Two slots a (row, head) suffice: a slot is rewritten only after the
//    block that read it has published.  The scratch is 2·D² floats a
//    (row, head), 5.2 MB at RWKV6-3B's prefill, against 42 MB for a slot a
//    chunk, and r, k, v, w are read once.
//  * Last, the output as one register-tiled pass over
//    [r e^{Le} | att] · [S_{c−1} ; V] (2 tokens × 4 columns a thread at
//    D = 64; a warp spans 8 tokens × 16 columns, and r's rows are padded
//    so its 8 token rows fall on distinct banks), the state, intra-chunk
//    and bonus terms summed apart, added in the plain version's order and
//    rounded once.
//  All products run on fp32 CUDA cores: TF32 tensor cores lose the state's
//  fp32 check.
//
// Step (T == 1): wkv6_step_kernel.  Bound by bytes: the fp32 state is read
// and written once (5.2 MB at B = 4, H = 40, D = 64: 0.0016 ms).  The
// padded chunk of one token reduces to
//     o_e = Σ_d r_d S_de + (Σ_d r_d u_d k_d) v_e,   S'_de = w'_d S_de + k_d v_e
// with w'_d = exp(log(clamp(w_d))), as the plain version gives it.  One
// warp per (row, head, 16 value columns); a lane holds 4 columns of D/8
// consecutive rows, loads them as 16-byte vectors all in flight before the
// first use, sums over d in registers and then by xor-shuffles across the
// warp, and writes S' back in 16-byte stores: S never passes through shared
// memory.
#include "common.cuh"
#include "rwkv6_chunk.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(NT, 3)
wkv6_prefill_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ w, const T* __restrict__ u,
                    const float* __restrict__ s0, T* __restrict__ o, float* __restrict__ sT,
                    float* slots, unsigned* sync, int T_len, int H, int n_chunks) {
  prefill_body<T, D, false>(r, k, v, w, u, s0, o, sT, slots, sync, T_len, H, n_chunks);
}

// Zero the flags and the ticket counter of the prefill's scratch.
__global__ void wkv6_clear_kernel(unsigned* sync, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    sync[i] = 0u;
}

// ---- step: T == 1 ------------------------------------------------------------

constexpr int STEP_E = 16;   // value columns a step block

template <typename T, int D>
__global__ void __launch_bounds__(32)
wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ w, const T* __restrict__ u,
                 const float* __restrict__ s0, T* __restrict__ o, float* __restrict__ sT,
                 int H) {
  constexpr int QE = STEP_E / 4;      // lanes across a tile's columns
  constexpr int RG = 32 / QE;         // lanes down the rows
  constexpr int RPL = D / RG;         // consecutive rows a lane
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x;
  const int quad = lane % QE, rg = lane / QE;
  const int e0 = tile * STEP_E + 4 * quad, d0 = rg * RPL;
  const size_t row = ((size_t)b * H + h) * D;            // r, k, v, w of (b, 0, h)
  const size_t s_off = ((size_t)b * H + h) * D * D;

  // every load first: the state's 16-byte vectors, then the token's vectors
  float4 S[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) S[i] = ld4(s0 + s_off + (size_t)(d0 + i) * D + e0);
  float rr[RPL], kk[RPL], ww[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    rr[i] = to_float(r[row + d0 + i]);
    kk[i] = to_float(k[row + d0 + i]);
    ww[i] = w[row + d0 + i];
  }
  float vv[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) vv[x] = to_float(v[row + e0 + x]);
  float bonus = 0.f;
  for (int d = lane; d < D; d += 32)
    bonus += to_float(r[row + d]) * (to_float(u[(size_t)h * D + d]) * to_float(k[row + d]));
  bonus = warp_sum(bonus);

  float acc[4] = {};
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const float s4[4] = {S[i].x, S[i].y, S[i].z, S[i].w};
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[x] = fmaf(rr[i], s4[x], acc[x]);
  }
#pragma unroll
  for (int off = QE; off < 32; off <<= 1)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[x] += __shfl_xor_sync(0xffffffffu, acc[x], off);
  if (rg == 0) {
#pragma unroll
    for (int x = 0; x < 4; ++x) o[row + e0 + x] = from_float<T>(acc[x] + bonus * vv[x]);
  }
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const float wd = expf(logf(fminf(fmaxf(ww[i], 1e-12f), 1.f)));
    const float s4[4] = {S[i].x, S[i].y, S[i].z, S[i].w};
    float n4[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) n4[x] = __fadd_rn(__fmul_rn(wd, s4[x]), __fmul_rn(kk[i], vv[x]));
    st4(sT + s_off + (size_t)(d0 + i) * D + e0, make_float4(n4[0], n4[1], n4[2], n4[3]));
  }
}

// ---- launches ------------------------------------------------------------------

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* w, const void* u,
           const float* s0, void* o, float* sT, float* scratch, int B, int T_len, int H,
           cudaStream_t stream) {
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ut = static_cast<const T*>(u);
  T* ot = static_cast<T*>(o);
  if (T_len == 1) {
    const dim3 grid((D + STEP_E - 1) / STEP_E, H, B);
    wkv6_step_kernel<T, D><<<grid, 32, 0, stream>>>(rt, kt, vt, w, ut, s0, ot, sT, H);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int n_chunks = (T_len + C - 1) / C;
  unsigned* sync = reinterpret_cast<unsigned*>(scratch + (size_t)B * H * 2 * D * D);
  const int n_sync = B * H + 1;
  wkv6_clear_kernel<<<(n_sync + 255) / 256, 256, 0, stream>>>(sync, n_sync);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem = sizeof(PrefillSmem<D>);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(wkv6_prefill_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)n_chunks * B * H;
  wkv6_prefill_kernel<T, D><<<grid, NT, smem, stream>>>(rt, kt, vt, w, ut, s0, ot, sT, scratch,
                                                       sync, T_len, H, n_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* r, const void* k, const void* v, const float* w, const void* u,
             const float* s0, void* o, float* sT, float* scratch, int B, int T_len, int H, int D,
             cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, o, sT, scratch, B, T_len, H, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, o, sT, scratch, B, T_len, H, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, o, sT, scratch, B, T_len, H, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v: (B, T, H, D) of dtype (0 float32, 1 bfloat16); w: (B, T, H, D)
// float32; u: (H, D) of dtype; state: (B, H, D, D) float32; o: (B, T, H, D)
// of dtype; s_out: (B, H, D, D) float32; scratch: for T > 1, B·H·2·D·D + B·H
// + 1 words of 4 bytes (two state slots a (row, head), then the flags and
// the ticket counter, which a first small kernel zeroes); unused, and may be null, at
// T == 1.
// All contiguous and 16-byte aligned.  Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* state, void* o, void* s_out, void* scratch,
                          int B, int T_len, int H, int D, int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* s0 = static_cast<const float*>(state);
  float* sT = static_cast<float*>(s_out);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_d<float>(r, k, v, wf, u, s0, o, sT, sc, B, T_len, H, D, st);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(r, k, v, wf, u, s0, o, sT, sc, B, T_len, H, D, st);
  return (int)cudaErrorInvalidValue;
}
