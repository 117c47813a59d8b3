// rope_attention_bwd: the backward of rope_attention in base-2 mode, for
// trunk stage 1 (over the L residues of a frame) and stage 2 (over the T
// frames of a residue).
//
// Replaces the attention adjoints inside the stage backward kernels of
// mdgen_finetune_tpu/ops/fused_layer_bwd.py: _k2 (frame attention, :258-309)
// and _k1 (residue attention, :420-458).
//
// Layout as the forward: qkv (G, N, I, 3C) bf16, attention over N for every
// (g, i) (stage 1: G = B*T, N = L, I = 1; stage 2: G = B, N = T, I = L);
// dout (G, N, I, C) bf16, the gradient of the attention output; key_valid
// (G, N, I) f32. For each sequence and head the kernel
//   1. recomputes the RoPE'd q and k (f32 tables (N+1, D)) and the bias key
//      RoPE'd at position N, with V and the bias value;
//   2. recomputes the logits with the mask bias (-1e9 on invalid keys) and
//      p as the forward takes it: exp2(min(l, 100)) with no max,
//      normalised by the sum + 1e-30;
//   3-4. per query n: dp_j = dO_n . v_j, rowsum_n = sum_j p_j dp_j and
//      dl_j = ln2 * p_j * (dp_j - rowsum_n) (the ln 2 of the base-2
//      softmax, fused_layer_bwd.py:280-281, 437-438);
//   5. dq_n = sum_j dl_nj k_j; per key j: dk_j = sum_n dl_nj q_n and
//      dv_j = sum_n p_nj dO_n;
//   6. applies the RoPE transpose (_rot_t :112) to dq and dk at their
//      positions (the bias key's at N);
//   7. writes dq, dk, dv into dqkv (G, N, I, 3C) bf16;
//   8. writes the bias key's and value's gradients of each sequence as an f32
//      partial; colsum.cuh sums them over the sequences into (2, C) f32.
// Masked keys have p = 0 exactly, so their dk and dv are exactly zero.
//
// What bounds it on the H100: per (sequence, head) it reads q, k, v, dO
// (N x D each) and writes dq, dk, dv, with ~8*N*(N+1)*D FLOP: stage 2
// (N = 100, D = 24, 128 x 16 sequence-heads) moves ~36 MB of bf16 against
// ~0.6 GFLOP of f32 work, so it is memory-bound (~0.011 ms at 3.35 TB/s);
// stage 1 (N = 4) even more so. Design: one block of 128 threads per
// (sequence, group of heads) stages q, k (RoPE'd), v and dO of its heads in
// f32 shared memory (at most 128 keys: ~40 KB for one head of stage 2; for
// N <= 16 a block takes up to 128 / (N + 1) heads so the threads are not
// idle); phase A gives a thread one (head, query) row: two passes over the
// keys (softmax statistics, then dq); phase B gives a thread one (head, key)
// column: one pass over the queries (dk, dv). Every thread of a phase reads
// the same key or query row at a time, a shared-memory broadcast. The
// logits and probabilities are recomputed in registers and never stored.
//
// The block body lives in rope_attention_bwd.cuh, which the merged layer
// backward (fused_layer_bwd.cu) includes too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "colsum.cuh"
#include "rope_attention_bwd.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace ropebwd;

template <int D>
__global__ void __launch_bounds__(THREADS) rope_attention_bwd_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
    const bf16* __restrict__ bias_k, const bf16* __restrict__ bias_v,
    const float* __restrict__ key_valid, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, bf16* __restrict__ dqkv, float* __restrict__ part,
    int N, int I, int H, int C, int HPB) {
  extern __shared__ __align__(16) float smem[];
  block<D>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, part, N, I, H, C, HPB,
           blockIdx.x, smem);
}

template <int D>
int launch(const void* qkv, const void* dout, const void* bias_k, const void* bias_v,
           const void* key_valid, const void* cos_t, const void* sin_t, void* dqkv,
           void* dbias, void* scratch, int G, int N, int I, int H, int C, cudaStream_t stream) {
  const int HPB = heads_per_block(N, H);
  const size_t smem = smem_bytes(N, H, D);
  cudaError_t e = cudaFuncSetAttribute(rope_attention_bwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long S = (long long)G * I;
  rope_attention_bwd_kernel<D><<<blocks(S, N, H), THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(bias_k), static_cast<const bf16*>(bias_v),
      static_cast<const float*>(key_valid), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<bf16*>(dqkv), static_cast<float*>(scratch),
      N, I, H, C, HPB);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return colsum::launch(static_cast<const float*>(scratch), static_cast<float*>(dbias), S,
                        2LL * C, 2LL * C, 0, stream);
}

}  // namespace

extern "C" int rope_attention_bwd(const void* qkv, const void* dout, const void* bias_k,
                                  const void* bias_v, const void* key_valid, const void* cos_t,
                                  const void* sin_t, void* dqkv, void* dbias, void* scratch,
                                  int G, int N, int I, int H, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 16: return launch<16>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, s);
    case 24: return launch<24>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, s);
    case 32: return launch<32>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, s);
    case 64: return launch<64>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
