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
// (N x D each) and writes dq, dk, dv, with ~10*N*(N+1)*D FLOP: stage 2
// (N = 100, D = 24, 128 x 16 sequence-heads at B = 32) moves ~69 MB
// (0.0206 ms at 3.35 TB/s) against ~5.0e9 FLOP (0.005 ms at 989 TFLOP/s),
// so the bytes bound it; stage 1 (N = 4) even more so.
//
// Short sequences (N <= 16): one block of 128 threads per (sequence,
// group of up to 128 / (N + 1) heads) stages q, k (RoPE'd), v and dO in f32
// shared memory; phase A gives a thread one (head, query) row (two passes
// over the keys: softmax statistics, then dq), phase B one (head, key)
// column (dk, dv).
//
// Long sequences (16 < N <= MAX_N = 128: stage 2 at T <= 128) replace a
// first version that ran the short design with one head per block: f32
// staging (5 blocks per SM), every product on the CUDA cores, and each
// logit and its exp2 formed three times. Design:
//   - one block of 4 warps per (sequence, head) stages RoPE'd q and k in
//     fp16, v and dO in bf16 (16-byte reads, rows padded to 16, D to DP at
//     a stride of DP + 8 lanes) and the key biases: 43.6 KB at N = 100,
//     51.6 KB at N = 128;
//   - phase A, 16-query tiles: S = Q K^T for the whole row (at most 144
//     keys) with p = exp2(min(S + bias, 100)) kept in registers, inv =
//     1 / (sum p + 1e-30), pn = p * inv in bf16 (the JAX kernel's rounding
//     point, fused_layer_bwd.py:276-285); dP = dO V^T, rowsum = sum pn dP;
//     dP again (one more product, no logit), dS = ln2 pn (dP - rowsum),
//     dQ = dS K; inv and rowsum (2 floats per query) go to shared memory;
//   - phase B, 16-key tiles: S^T = K Q^T, P^T = exp2(min(., 100)) * inv,
//     dP^T = V dO^T, dS^T, then dV += P^T dO and dK += dS^T Q;
//   - all six products are mma.sync m16n8k16 (A fragments by ldmatrix,
//     the transposed operands by ldmatrix.trans, no transposed copies);
//     each logit is formed twice (once per phase);
//   - dq, dk go through a per-warp f32 tile for the RoPE transpose and out
//     as 16-byte bf16 vectors; the bias key's dk, dv go to the sequence's
//     f32 partial (colsum.cuh sums them).
// Precision: bf16 RoPE'd q and k (JAX's rounding point) alone take about
// all of the checks' 1e-2 tolerance at unscaled q (chip_smoke.py's
// bf16_staging_err_of_tol), so the kernel takes blocked_attention_bwd.cuh's
// recipe: q and k in fp16,
// staged again times a power of two when their block maximum leaves
// [2^-6, 2^15), and dS in fp16 as dS * ln2 / max|dO| (dS of a real step is
// ~1e-6, below fp16's normal range), scaled back in f32.
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
__global__ void __launch_bounds__(THREADS) rope_attention_bwd_short_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
    const bf16* __restrict__ bias_k, const bf16* __restrict__ bias_v,
    const float* __restrict__ key_valid, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, bf16* __restrict__ dqkv, float* __restrict__ part,
    int N, int I, int H, int C, int HPB) {
  extern __shared__ __align__(16) float smem[];
  short_block<D>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, part, N, I, H, C, HPB,
                 blockIdx.x, smem);
}

// resident blocks per SM that the register allocation must allow: up to
// D = 32, 4 (at most 128 registers) measured faster than the 2 that the
// compiler's own ~230 registers give (PERF.md); D = 64 needs ~232
// registers (no spills), so 2
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 32 ? 4 : 2)
    rope_attention_bwd_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
    const bf16* __restrict__ bias_k, const bf16* __restrict__ bias_v,
    const float* __restrict__ key_valid, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, bf16* __restrict__ dqkv, float* __restrict__ part,
    int N, int I, int H, int C, int HPB) {
  extern __shared__ __align__(16) float smem[];
  long_block<D>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, part, N, I, H, C,
                blockIdx.x, smem);
}

template <int D>
int launch(const void* qkv, const void* dout, const void* bias_k, const void* bias_v,
           const void* key_valid, const void* cos_t, const void* sin_t, void* dqkv,
           void* dbias, void* scratch, int G, int N, int I, int H, int C, cudaStream_t stream) {
  if (N > MAX_N) return (int)cudaErrorInvalidValue;
  const int HPB = heads_per_block(N, H);
  const size_t smem = smem_bytes(N, H, D);
  auto kern = N <= 16 ? rope_attention_bwd_short_kernel<D> : rope_attention_bwd_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long S = (long long)G * I;
  kern<<<blocks(S, N, H), THREADS, smem, stream>>>(
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

// the resources of the kernel at sequence length N: info[0] registers per
// thread, [1] local (spill) bytes per thread, [2] dynamic shared memory per
// block, [3] resident blocks per SM
template <int D>
int resources(int N, int H, long long* info) {
  const size_t smem = smem_bytes(N, H, D);
  auto kern = N <= 16 ? rope_attention_bwd_short_kernel<D> : rope_attention_bwd_kernel<D>;
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = fa.numRegs;
  info[1] = (long long)fa.localSizeBytes;
  info[2] = (long long)smem;
  info[3] = per_sm;
  return 0;
}

}  // namespace

extern "C" int rope_attention_bwd_resources(int N, int H, int C, long long* info) {
  switch (C / H) {
    case 16: return resources<16>(N, H, info);
    case 24: return resources<24>(N, H, info);
    case 32: return resources<32>(N, H, info);
    case 64: return resources<64>(N, H, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
