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
// What bounds it on the H100: at most 101 keys of D = 24, so per (sequence,
// head) it reads and writes a few KB and does ~2*N*(N+1)*D*2 FLOP; the whole
// call moves ~4*M*C*2 bytes (M = B*T*L) and is memory-bound (stage 2:
// 0.5 MFLOP per head against 15 KB). Design: a warp stages roped K and V
// (N+1 rows) in shared memory as f32; each lane owns one query row at a
// time and streams the keys from shared memory in 16-byte reads (every
// thread reads the same key: a broadcast, no bank conflicts), accumulating the
// output in registers. Long sequences (stage 2) give a block of 128
// threads one (sequence, head), one thread per query, so the staged keys
// serve 128 queries and ~11 blocks fit an SM; short ones (N <= 16: stage 1
// and the encoder, N = 4) give a warp 32/N heads of one sequence, one lane
// per (head, query), so the lanes are not idle. Nothing but q/k/v in and the output out touches device memory;
// the f32 logits and probabilities never leave registers.
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
__global__ void __launch_bounds__(WARPS * 32) rope_attention_short_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias_k,
    const bf16* __restrict__ bias_v, const float* __restrict__ key_valid,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    bf16* __restrict__ out, int G, int N, int I, int H, int C, int base2) {
  extern __shared__ __align__(16) float smem_s[];
  short_block<D>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2,
                 blockIdx.x, smem_s);
}

template <int D>
__global__ void __launch_bounds__(LONG_THREADS) rope_attention_kernel(
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
           int C, int base2, cudaStream_t stream) {
  const Shape sh = shape(G, N, I, H, D);
  auto kern = sh.short_seq ? rope_attention_short_kernel<D> : rope_attention_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<sh.blocks, sh.threads, sh.smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias_k),
      static_cast<const bf16*>(bias_v), static_cast<const float*>(key_valid),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<bf16*>(out), G, N, I, H, C, base2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rope_attention(const void* qkv, const void* bias_k, const void* bias_v,
                              const void* key_valid, const void* cos_t, const void* sin_t,
                              void* out, int G, int N, int I, int H, int C, int base2,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 16: return launch<16>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s);
    case 24: return launch<24>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s);
    case 32: return launch<32>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s);
    case 64: return launch<64>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
