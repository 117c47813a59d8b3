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
// step, below fp16's normal range (6.1e-5): each 16-query tile therefore
// scales its ds by ln2 / max|dO| of the tile before rounding it to fp16, and
// its dq and dk products by max|dO| after them, in f32. q and k are
// scaled too where they need it, so that any finite bf16 input fits fp16's
// range (65,504 at most; full precision from 6.1e-5): the staging loop
// takes max|RoPE'd q| and max|RoPE'd k| of the head as it goes, and q or k
// whose maximum lies outside [2^-6, 2^15) is staged again times 2^s, a
// power of two that puts the maximum in [2^14, 2^15) (rope_tile.cuh's
// scale_exponent; a power of two adds no rounding of its own). The f32
// logits q.k come back times 2^-(sq + sk) after the product, dq = ds.k
// times 2^-sk and dk = ds^T.q times 2^-sq. dO, v and pn stay bf16. The
// softmax is the forward's, without a running maximum: p = exp2(min(l,
// 100)), den = sum p + 1e-30, masked keys at -1e9 and the bias key at
// position N.

// Design (mma.sync m16n8k16, and m16n8k8 for the last 8 lanes at D = 24;
// fragments through ldmatrix, .trans for the products over rows, so no
// tile is transposed in memory): one block of 4 warps per (sequence,
// head), the head's q, dO, k and v staged once in shared memory in rows of
// D lanes (48 bytes at D = 24: no pad to 32).
//   - Pass 1, 16-query tiles over the warps: S = q.k^T and dP = dO.v^T over
//     all keys, p = exp2(min(S, 100)), and the row statistics 1 / sum p and
//     delta = sum p dP / sum p, kept per query in shared memory (the kernel
//     is not given the forward's output or normaliser, so they are made
//     here: the FlashAttention-2 backward's pre-pass).
//   - Pass 2, rounds of 4 key tiles of 16, one per warp: the warp keeps its
//     keys and values as A fragments and its dK and dV in f32 registers
//     across the round, and walks all query tiles: S^T = K Q^T and
//     dP^T = V dO^T, pn^T (bf16) and ds^T (fp16) from the statistics, then
//     dV += pn^T dO, dK += ds^T Q and the query tile's dq partial ds K, with
//     ds^T transposed in registers (movmatrix). The dq partials are added
//     into an f32 dq in shared memory (over the keys' region, free after
//     pass 1): in step t warp w takes query tile (t + w) mod nq, so the
//     warps of a step touch distinct rows, and the block meets after each
//     step; every sum runs in one fixed order: deterministic, no atomics.
//     A last round of fewer than 4 key tiles (17 at N = 256: the bias key
//     makes the 17th) gives each tile's query tiles to 4 / R warps, whose
//     dK and dV partials one of them adds in a fixed order.
//   - Seven products per (query, key) pair: q.k^T and dO.v^T in each pass,
//     then pn^T.dO, ds^T.q and ds.k; p is formed twice. The five-product
//     form needs a surface of p or dP of a query tile held across the key
//     walk (41 KB of bf16 p for 64 queries at N = 256), which would cost
//     the occupancy below.
//
// Shared memory grows with N: 2 bytes per staged element (q, dO at NQP =
// 16 * ceil(N / 16) rows, k, v at NKP = 16 * ceil((N + 1) / 16)), the key
// biases and the row statistics, and each warp's 16-row area: 60,352 bytes
// at N = 256, D = 24, 3 blocks (12 warps) per SM.
//
// What bounds it on the H100: at the ATLAS residue stage (250 frames x 16
// heads, N = 256, D = 24) the least work is the five products of a backward
// that recomputes P, 10 * S * H * N * (N+1) * D = 6.3e10 FLOP (0.064 ms at
// 989 TFLOP/s), against 344 MB of qkv, dO and dqkv (0.103 ms at 3.35
// TB/s): the bytes bound it. This design takes seven products on mma.sync,
// exp2 twice per pair, and a barrier per query tile of pass 2.
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
__global__ void __launch_bounds__(THREADS, 3) blocked_attention_bwd_kernel(
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

// the resources of the kernel at sequence length N: info[0] registers per
// thread, [1] local (spill) bytes per thread, [2] dynamic shared memory per
// block, [3] resident blocks per SM
template <int D>
int resources(int N, long long* info) {
  const size_t smem = Layout<D>(N).total;
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(blocked_attention_bwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, blocked_attention_bwd_kernel<D>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, blocked_attention_bwd_kernel<D>,
                                                      THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = fa.numRegs;
  info[1] = (long long)fa.localSizeBytes;
  info[2] = (long long)smem;
  info[3] = per_sm;
  return 0;
}

}  // namespace

extern "C" int blocked_attention_bwd_resources(int N, int D, long long* info) {
  switch (D) {
    case 16: return resources<16>(N, info);
    case 24: return resources<24>(N, info);
    case 32: return resources<32>(N, info);
    case 64: return resources<64>(N, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
