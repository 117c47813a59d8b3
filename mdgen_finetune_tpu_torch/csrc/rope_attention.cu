// rope_attention: the attention core shared by trunk stage 1 (over the L
// residues of a frame), trunk stage 2 (over the T frames of a residue) and the
// prepend-IPA encoder's residue MHA.
//
// Replaces the attention cores inside
//   - mdgen_finetune_tpu/ops/fused_layer.py::_trunk_call (body _kernel:
//     stage 1's pair loop with the no-max exp2 softmax, stage 2's grouped
//     core `_grouped_attend` with base2=True);
//   - mdgen_finetune_tpu/ops/ipa_encoder.py::_encoder_call (body _kernel: the
//     residue MHA with a natural-exp, max-subtracted softmax).
//
// Layout: qkv is (G, N, I, 3C) bf16 (q | k | v column blocks); attention runs
// over N for every (g, i) pair, so one kernel serves both trunk axes without
// a transpose (stage 1: G = B*T, N = L, I = 1; stage 2: G = B, N = T, I = L).
// key_valid is (G, N, I) f32. For each sequence and head the kernel
//   - RoPEs q and k (rotate-half, f32 tables (N+1, D) from the host);
//   - appends the learned bias key/value, the key RoPE'd at position N;
//   - adds the mask bias (-1e9 on invalid keys; the bias key is always valid);
//   - softmax: base 2 (q carries scale*log2(e); exp2(min(l, 100)), no max,
//     denominator + 1e-30) or natural exp with max subtraction;
//   - multiplies by V and writes (G, N, I, C) bf16.
//
// What bounds it on the H100: per (sequence, head) at most N + 1 keys of
// D lanes; the whole call moves ~4*M*C*2 bytes (M = B*T*L: q, k, v in, the
// output out) against 4*N*(N+1)*D FLOP per (sequence, head). At stage 2 of
// the flagship (B = 64, T = 100, L = 4, 16 heads of D = 24) that is 79 MB
// (0.0235 ms at 3.35 TB/s) against 4.0e9 FLOP (0.004 ms at 989 TFLOP/s):
// the bytes bound it, by ~6x.
//
// Short sequences (N <= 16: trunk stage 1 and the encoder's residue MHA at
// N = L = 4; the modular layer's residue attention, TPU row 12) replace a
// first version that gave a warp 32 / N heads of one sequence and a lane a
// (head, query): q loaded as D scalar 2-byte loads from rows 3C apart, K and
// V staged through 2-byte loads, the output stored 2 bytes at a time, one
// task per warp with nothing of the next in flight, and the natural mode
// forming every logit twice. At the flagship's stage 1 ((G, N, I, 3C) =
// (6400, 4, 1, 1152), 16 heads of D = 24) the call moves 78.6 MB (0.0235 ms
// at 3.35 TB/s) against ~0.2 GFLOP: only bytes bound it, and a 16-row
// tensor-core tile would be 75% padding at N = 4. Design (a streaming
// kernel on the CUDA cores):
//   - a unit is SPB whole sequences x HG heads (HG = H unless the unit would
//     not fit; ops/rope_attention.py::short_plan picks SPB and HG so that
//     SPB x HG x N is about 128 queries and three blocks fit an SM); at I = 1
//     and HG = H a unit's q|k|v is one contiguous span (2 x 9,216 bytes at
//     the flagship) and its output another;
//   - a persistent grid (resident blocks x SMs) walks the units: the next
//     unit's span is brought in by 16-byte cp.async while this one is
//     computed (two raw buffers, ~55 KB in flight per SM at three blocks),
//     consecutive threads on consecutive 16 bytes;
//   - K (RoPE'd) and V in f32 shared memory, each key once; then a thread
//     per (sequence, head, query), the queries of a head on neighbouring
//     lanes (broadcast reads of its keys), a head's keys at a stride that
//     puts the 8 heads of a warp on distinct banks; RoPE and both softmaxes
//     in f32, the logits kept in registers (at most 17 keys), so natural
//     mode forms each once (max, then exp);
//   - the output staged in shared memory and written as 16-byte stores;
//   - I > 1 (stage 2 at T <= 16): the same kernel, token n of sequence
//     (g, i) at row (g N + n) I + i, so a unit's rows are runs of I.
// Every output's arithmetic is the first version's (the same RoPE, logit,
// softmax and sum order), whatever SPB, HG or the walk. The merged layer
// backward runs a unit as one virtual block with one raw buffer.
//
// Long sequences (N > 16: stage 2, the modular layer's frame and residue
// attention up to max_keys) replace a first version that gave one thread a
// query row and did every product on the CUDA cores in f32 (every query
// re-read every f32 key from shared memory, staged in 2-byte reads at an
// 8-way bank conflict; the natural mode formed each logit twice for its
// max). Design:
//   - one block of 4 warps per (sequence, head) stages the head's N + 1
//     keys and N queries once, every thread a row at a time so that their
//     loads are in flight together: 16-byte reads of the 48-byte head
//     slices of (G, N, I, 3C), RoPE in f32, q and k to fp16, v to bf16, the
//     key bias in f32 (-1e9 masked, 0 for the bias key at N), rows padded
//     to a multiple of 16 (pad rows zero, bias -1e9) and the head dim to DP
//     (24 -> 32, zero lanes), at a row stride of DP + 8 lanes so that
//     ldmatrix reads no bank twice;
//   - the warps take 16-query tiles in turn, the tile's q held as mma.sync
//     A fragments; per chunk of 64 keys S = Q K^T with mma.sync m16n8k16
//     (fp16 in, f32 out; K's B fragments by ldmatrix), p in registers,
//     O += P V (p to bf16 A fragments through the accumulator layout, V's B
//     fragments by ldmatrix.trans), f32 row sums from the f32 p; the output
//     goes out through the tile's q rows as 16-byte vectors;
//   - base 2: p = exp2(min(l, 100)) with no max (q carries scale*log2(e));
//     natural: an online max in base-2 units (t = l*log2(e), p = exp2(t - m),
//     the sums rescaled when a chunk raises the max), as tiled_attention.cu
//     does, so every logit is formed once in either mode.
// Precision: the JAX kernel rounds the RoPE'd q and k to bf16. At logits of
// several units (q unscaled, as the port's kernel checks hold it) that
// rounding alone takes about all of the checks' 1e-2 tolerance before the
// kernel rounds p and its output (chip_smoke.py's bf16_staging_err_of_tol);
// with fp16 (11 bits) the whole kernel stays near half of it.
// fp16's range is the price: when the head's largest RoPE'd k or q leaves
// [2^-6, 2^15), those rows are staged again times a power of two
// (blocked_attention_bwd.cuh's rule) and the logits scaled back in f32.
// Shared memory: 164 bytes per key and 80 per query at D = 24 (27.4 KB at
// N = 100), so N <= 943 at D = 24 and 527 at D = 64
// (ops/rope_attention.py max_keys).
//
// The kernel bodies live in rope_attention.cuh, which the merged layer
// backward (fused_layer_bwd.cu) includes too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rope_attention.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace ropefwd;

template <int D>
__global__ void __launch_bounds__(SHORT_THREADS) rope_attention_short_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias_k,
    const bf16* __restrict__ bias_v, const float* __restrict__ key_valid,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    bf16* __restrict__ out, int G, int N, int I, int H, int C, int base2, int spb, int hg) {
  extern __shared__ __align__(16) unsigned char smem_s[];
  const ShortArgs a = short_args(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H,
                                 C, base2, spb, hg);
  short_stream<D>(a, blockIdx.x, gridDim.x, smem_s);
}

// resident blocks per SM that the register allocation must allow: up to
// D = 32, 5 (at most 102 registers) measured faster than the 3 that the
// compiler's own ~130 registers give (PERF.md); D = 64 needs ~235, so 2
template <int D>
__global__ void __launch_bounds__(LONG_THREADS, D <= 32 ? 5 : 2)
    rope_attention_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias_k,
    const bf16* __restrict__ bias_v, const float* __restrict__ key_valid,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    bf16* __restrict__ out, int G, int N, int I, int H, int C, int base2) {
  extern __shared__ __align__(16) float smem[];
  long_block<D>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2,
                blockIdx.x, smem);
}

template <int D>
int launch(const void* qkv, const void* bias_k, const void* bias_v, const void* key_valid,
           const void* cos_t, const void* sin_t, void* out, int G, int N, int I, int H,
           int C, int base2, cudaStream_t stream, int spb, int hg, int grid) {
  const Shape sh = shape(G, N, I, H, D, spb, hg, 2);
  if (sh.blocks == 0) return (int)cudaErrorInvalidValue;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* bk = static_cast<const bf16*>(bias_k);
  const bf16* bv = static_cast<const bf16*>(bias_v);
  const float* kv = static_cast<const float*>(key_valid);
  const float* cs = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  bf16* o = static_cast<bf16*>(out);
  if (sh.short_seq) {
    if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
    cudaError_t e = cudaFuncSetAttribute(rope_attention_short_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
    if (e != cudaSuccess) return (int)e;
    rope_attention_short_kernel<D><<<grid, sh.threads, sh.smem, stream>>>(
        q, bk, bv, kv, cs, sn, o, G, N, I, H, C, base2, spb, hg);
  } else {
    cudaError_t e = cudaFuncSetAttribute(rope_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
    if (e != cudaSuccess) return (int)e;
    rope_attention_kernel<D><<<sh.blocks, sh.threads, sh.smem, stream>>>(
        q, bk, bv, kv, cs, sn, o, G, N, I, H, C, base2);
  }
  return (int)cudaGetLastError();
}

// the resources of the kernel that a call of this shape runs (one kernel
// serves both softmax modes; the short one at plan (spb, hg)): info[0]
// registers per thread, [1] local (spill) bytes per thread, [2] dynamic
// shared memory per block, [3] resident blocks per SM
template <typename K>
cudaError_t kernel_resources(K kern, const Shape& sh, long long* info) {
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, sh.threads, sh.smem);
  if (e != cudaSuccess) return e;
  info[0] = fa.numRegs;
  info[1] = (long long)fa.localSizeBytes;
  info[2] = (long long)sh.smem;
  info[3] = per_sm;
  return cudaSuccess;
}

template <int D>
int resources(int N, int H, long long* info, int spb, int hg) {
  const Shape sh = shape(1, N, 1, H, D, spb, hg, 2);
  if (sh.blocks == 0) return (int)cudaErrorInvalidValue;
  return (int)(sh.short_seq ? kernel_resources(rope_attention_short_kernel<D>, sh, info)
                            : kernel_resources(rope_attention_kernel<D>, sh, info));
}

}  // namespace

// spb, hg: the short kernel's plan (trailing: an older entry point without
// them is called the same way)
extern "C" int rope_attention_resources(int N, int H, int C, long long* info, int spb, int hg) {
  switch (C / H) {
    case 16: return resources<16>(N, H, info, spb, hg);
    case 24: return resources<24>(N, H, info, spb, hg);
    case 32: return resources<32>(N, H, info, spb, hg);
    case 64: return resources<64>(N, H, info, spb, hg);
    default: return (int)cudaErrorInvalidValue;
  }
}

// spb, hg, grid: the short kernel's plan and its persistent grid (its
// resident blocks, at most one per unit; ops/rope_attention.py::_slots)
extern "C" int rope_attention(const void* qkv, const void* bias_k, const void* bias_v,
                              const void* key_valid, const void* cos_t, const void* sin_t,
                              void* out, int G, int N, int I, int H, int C, int base2,
                              void* stream, int spb, int hg, int grid) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 16: return launch<16>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s, spb, hg, grid);
    case 24: return launch<24>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s, spb, hg, grid);
    case 32: return launch<32>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s, spb, hg, grid);
    case 64: return launch<64>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s, spb, hg, grid);
    default: return (int)cudaErrorInvalidValue;
  }
}
