// blocked_attention_bwd: the backward of the trunk's base-2 attention core
// for sequences of 129 to a few hundred tokens, one block per (sequence,
// head) with the head's whole surfaces on chip.
//
// Replaces the attention adjoint inside the JAX package's
// mdgen_finetune_tpu/ops/blocked_block_bwd.py::_bwd_kernel (:53), the body
// of time_block_bwd (:298, frame attention) and rows_block_bwd (:380,
// residue attention): the TPU kernels that train the ATLAS crop-256 preset
// (L = 256, T = 250), where a head's (rows, keys) logit surface stays
// resident in VMEM (_blocked_bwd_fits, time_attention.py:650).
//
// Interface and layout as rope_attention_bwd.cu: qkv (G, N, I, 3C) bf16,
// attention over N for every (g, i) (frame stage: G = B, N = T, I = L;
// residue stage: G = B*T, N = L, I = 1); dout (G, N, I, C) bf16; key_valid
// (G, N, I) f32; the RoPE tables (N+1, D) f32. q carries
// head_dim^-0.5 * log2(e), so with l = q.k (RoPE'd, the bias key at
// position N, masked keys at -1e9) the forward's no-max softmax is
//   p = exp2(min(l, 100)),  den = sum over all keys of p + 1e-30,  pn = p / den
// and its adjoint (blocked_block_bwd.py:20-28, in normalised form)
//   dp = dO . v^T,  delta = rowsum(pn * dp),  ds = ln2 * pn * (dp - delta)
//   dv = pn^T . dO,  dk = ds^T . q,  dq = ds . k
// then the RoPE transpose of dq and dk at their positions. Outputs dqkv
// (G, N, I, 3C) bf16 and the bias key's and value's gradients of each
// sequence as f32 partials, summed over the sequences by colsum.cuh.
//
// Precision: the products run on the tensor cores with f32 accumulators.
// q, k and ds meet in fp16 (10 mantissa bits), the rest in bf16. A logit's
// rounding error becomes a relative error of p through exp2, and with q and k
// in bf16 that was the largest term against the f32 twin (1.03% of the
// output's scale in the ATLAS frame view on an H100; the output's own bf16
// rounding is 0.2%); ds in bf16 was the next (0.94% at N = 129 against
// 0.32% in fp16). But ds is a gradient, ~1e-6 in a real
// step, below fp16's normal range (6.1e-5): each query tile therefore
// scales its ds by 1 / max|dO| of the tile before rounding it to fp16, and
// its dq and dk partials by max|dO| after the products, in f32. q and k are
// scaled too where they need it, so that any finite bf16 input fits fp16's
// range (65,504 at most; full precision from 6.1e-5): the staging loops
// take max|RoPE'd q| of each query tile and max|RoPE'd k| of the head as
// they go, and a tile or head whose maximum lies outside [2^-6, 2^15) is
// staged again times 2^s, a power of two that puts the maximum in
// [2^14, 2^15) (1 / max up to a power of two and a constant; a power of
// two adds no rounding of its own). The f32 logits q.k come back times
// 2^-(sq + sk) after the product, dq = ds.k times 2^-sk and dk = ds^T.q
// times 2^-sq, each folded into the tile's one factor with max|dO|. Inside
// the window nothing is staged twice and s = 0: the results are bit for
// bit those of the kernel without the scales, at nearly its cost. dO, v,
// pn and the stored unnormalised p (up to 2^100) stay bf16.

// Design (mma.sync m16n8k16 helpers of attention_tile.cuh; D padded to a
// multiple of 16, 24 -> 32): one block of 4 warps per (sequence, head).
//   - Once per block: the head's N+1 RoPE'd keys (row-major for q.k^T and
//     transposed for ds.k) and values (row-major for dO.v^T) are staged in
//     shared memory, the key tiles padded to 64 with zero rows.
//   - Per 64-query tile (each warp keeps 16 rows of q and dO as A
//     fragments): pass 1 walks the key tiles, forms S = q.k^T and
//     p = exp2(min(S, 100)) once, keeps p in shared memory (bf16, in the
//     accumulator layout of the thread that made it) and sums den and
//     sum(p * dp) in f32 with dp = dO.v^T; pass 2 walks the key tiles again,
//     reads p back, recomputes dp, forms pn and ds, accumulates dq = ds.k in
//     registers, and hands pn^T and ds^T through shared memory to the
//     products over the tile's queries, dv += pn^T.dO and dk += ds^T.q, in
//     which each warp owns 16 keys of the tile. dk and dv accumulate in f32
//     in shared memory across the query tiles; every sum runs in a fixed
//     order, so the result is deterministic and needs no atomics.
//   - P is formed once per (query, key) pair; the six products are q.k^T,
//     dO.v^T twice, ds.k, pn^T.dO and ds^T.q.
//
// Shared memory grows with the padded key count NKP = 64 * ceil((N+1)/64)
// (every staged element takes 2 bytes, bf16 or fp16):
// ~544 bytes per key at D = 24 plus ~38 KB, 213,824 bytes at N = 256; the
// wrapper names the limit (N <= 319 at D = 24) and raises beyond it.
//
// What bounds it on the H100: at the ATLAS residue stage (250 frames x 16
// heads, N = 256, D = 24) the least work is the five products of a backward
// that recomputes P, 10 * S * H * N * (N+1) * D = 1.3e11 FLOP (0.13 ms at
// 989 TFLOP/s), against ~20 MB of operands (0.006 ms): the tensor cores
// bound it. This first version uses mma.sync with 4 warps per SM (one
// ~210 KB block each), no wgmma or TMA: making it fast is later work.
//
// The block body lives in blocked_attention_bwd.cuh, which the merged layer
// backward (fused_layer_bwd.cu) includes too.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "blocked_attention_bwd.cuh"
#include "colsum.cuh"

namespace {

using namespace blockedbwd;

template <int D>
__global__ void __launch_bounds__(THREADS) blocked_attention_bwd_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
    const bf16* __restrict__ bias_k, const bf16* __restrict__ bias_v,
    const float* __restrict__ key_valid, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, bf16* __restrict__ dqkv, float* __restrict__ part,
    int N, int I, int H, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  block<D>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, part, N, I, H, C,
           blockIdx.x, smem);
}

template <int D>
int launch(const void* qkv, const void* dout, const void* bias_k, const void* bias_v,
           const void* key_valid, const void* cos_t, const void* sin_t, void* dqkv,
           void* dbias, void* scratch, int G, int N, int I, int H, int C, int smem_limit,
           cudaStream_t stream) {
  const Layout<D> lay(N);
  const long long S = (long long)G * I;
  if (N <= 0 || S <= 0 || S * H > 0x7fffffffLL || lay.total > (size_t)smem_limit)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(blocked_attention_bwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)lay.total);
  if (e != cudaSuccess) return (int)e;
  blocked_attention_bwd_kernel<D><<<(unsigned)(S * H), THREADS, lay.total, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(bias_k), static_cast<const bf16*>(bias_v),
      static_cast<const float*>(key_valid), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<bf16*>(dqkv), static_cast<float*>(scratch),
      N, I, H, C);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return colsum::launch(static_cast<const float*>(scratch), static_cast<float*>(dbias), S,
                        2LL * C, 2LL * C, 0, stream);
}

}  // namespace

// The shared memory one block takes at N tokens and head dim D (0 for an
// unsupported D): the wrapper's limit on N comes from this.
extern "C" long long blocked_attention_bwd_smem(int N, int D) {
  switch (D) {
    case 16: return (long long)Layout<16>(N).total;
    case 24: return (long long)Layout<24>(N).total;
    case 32: return (long long)Layout<32>(N).total;
    case 64: return (long long)Layout<64>(N).total;
    default: return 0;
  }
}

extern "C" int blocked_attention_bwd(const void* qkv, const void* dout, const void* bias_k,
                                     const void* bias_v, const void* key_valid,
                                     const void* cos_t, const void* sin_t, void* dqkv,
                                     void* dbias, void* scratch, int G, int N, int I, int H,
                                     int C, int smem_limit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 16: return launch<16>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, smem_limit, s);
    case 24: return launch<24>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, smem_limit, s);
    case 32: return launch<32>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, smem_limit, s);
    case 64: return launch<64>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, smem_limit, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
