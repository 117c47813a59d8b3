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
// Short sequences (N <= 16: trunk stage 1 at N = L = 4, stage 2 at
// T <= 16) replace a first version that gave a block of 128 threads one
// sequence (up to 128 / (N + 1) heads), staged q, k, v and dO through 2-byte
// loads into f32 shared memory, ran 64 threads in phase A and 80 in phase B,
// formed every exp2 three times (twice for the row's statistics and dq,
// once more per key for dk and dv), and wrote each sequence's bias partial
// for a second launch. At the training path's stage 1 ((G, N, I) = (3200,
// 4, 1), 16 heads of D = 24) the call moves 69 MB (0.0206 ms at 3.35 TB/s)
// against ~0.25 GFLOP: only bytes bound it. Design (a streaming kernel on
// the CUDA cores, the shape of rope_attention's short body):
//   - a unit is SPB whole sequences x HG heads (ops/rope_attention_bwd.py::
//     short_plan: about a key per thread, so that the key side is one pass:
//     at stage 1 one sequence, 16 x 5 keys, four blocks per SM); at I = 1
//     and HG = H a unit's q|k|v is one contiguous span (9,216 bytes at
//     stage 1), its dO another, and its gradients a third;
//   - a persistent grid (resident blocks x SMs) walks the units, the next
//     unit's spans in flight by 16-byte cp.async (two raw buffers);
//   - q and k RoPE'd once into f32 shared memory; the bias key and value of
//     every head staged once per block;
//   - the query side, a thread per (sequence, head, query): each key's
//     exp2(min(l, 100)) and dp = dO . v formed once and kept in registers
//     (at most 17 keys), 1 / (sum + 1e-30) and rowsum, then p and
//     dl = ln2 p (dp - rowsum) for dq = sum_j dl k_j; p and dl go to a
//     shared tile, dq (RoPE-transposed) over the row's q slice;
//   - N = 4 (stage 1) has a build of its own, its loops unrolled without
//     guards, so that the keys' dot-product chains interleave;
//   - the key side, a thread per (sequence, head, key): dk = sum_n dl q_n
//     and dv = sum_n p dO_n from the tile, not by forming the logits again;
//     dk (RoPE-transposed) and dv over the key's k and v slices, the bias
//     key's into the sequence's f32 partial;
//   - the gradients go out as 16-byte stores; colsum.cuh sums the partials
//     (colsum_tall_kernel: the 2C columns' rows staged in shared memory).
// Every output's arithmetic and order are the first version's (dq summed
// over the keys in order, dk and dv over the queries in order, the same
// logits, exp2, sums and RoPE; the RoPE transpose's products written out as
// fma(g, cos, +-g' sin), the first version's contraction, and rowsum
// rounded once with __fmul_rn, as the first version's loop left it, so
// that no context, N = 4's straight-line code included, fuses them
// otherwise), so dqkv and the bias gradients are its bits. The partials
// stay per sequence (19.6 MB written and read at stage 1):
// with a sequence per unit there is nothing to sum inside a unit, and a sum
// over a plan's units would tie the bias gradients' bits to the plan.
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

// NKC = 5: the body specialised for N = 4 (trunk stage 1 of the 4AA
// peptides); 0: any N <= 16 (the same arithmetic). A -DMDGEN_GENERIC_SHORT
// build runs the generic instance at N = 4 too, to time it
#ifdef MDGEN_GENERIC_SHORT
constexpr bool SHORT_N4 = false;
#else
constexpr bool SHORT_N4 = true;
#endif

template <int D, int NKC, bool NAT>
__global__ void __launch_bounds__(SHORT_THREADS) rope_attention_bwd_short_kernel(const ShortArgs a) {
  extern __shared__ __align__(16) unsigned char smem_s[];
  short_stream<D, NKC, NAT>(a, blockIdx.x, gridDim.x, smem_s);
}

// base2 = 0: the natural-softmax instances (the modular layer's residue
// attention, the backward of rope_attention(base2=False)); N = 4 keeps its
// unrolled build in both modes
template <int D>
auto short_kernel(int N, int base2 = 1) {
  if (!base2)
    return N == 4 && SHORT_N4 ? rope_attention_bwd_short_kernel<D, 5, true>
                               : rope_attention_bwd_short_kernel<D, 0, true>;
  return N == 4 && SHORT_N4 ? rope_attention_bwd_short_kernel<D, 5, false>
                             : rope_attention_bwd_short_kernel<D, 0, false>;
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
    int N, int I, int H, int C) {
  extern __shared__ __align__(16) float smem[];
  long_block<D>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, part, N, I, H, C,
                blockIdx.x, smem);
}

template <int D>
int launch(const void* qkv, const void* dout, const void* bias_k, const void* bias_v,
           const void* key_valid, const void* cos_t, const void* sin_t, void* dqkv,
           void* dbias, void* scratch, int G, int N, int I, int H, int C, cudaStream_t stream,
           int spb, int hg, int grid, int base2) {
  const long long S = (long long)G * I;
  const Shape sh = shape(S, N, H, D, spb, hg, 2);
  if (sh.blocks == 0) return (int)cudaErrorInvalidValue;
  // the natural softmax has the short body only (N > 16 takes
  // fused_attention_bwd, ops/rope_attention_bwd.py)
  if (!base2 && !sh.short_seq) return (int)cudaErrorInvalidValue;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* go = static_cast<const bf16*>(dout);
  const bf16* bk = static_cast<const bf16*>(bias_k);
  const bf16* bv = static_cast<const bf16*>(bias_v);
  const float* kv = static_cast<const float*>(key_valid);
  const float* cs = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  bf16* dq = static_cast<bf16*>(dqkv);
  float* part = static_cast<float*>(scratch);
  if (sh.short_seq) {
    if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
    auto kern = short_kernel<D>(N, base2);
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
    if (e != cudaSuccess) return (int)e;
    const unsigned blocks = (unsigned)grid < sh.blocks ? (unsigned)grid : sh.blocks;
    kern<<<blocks, SHORT_THREADS, sh.smem, stream>>>(
        short_args(q, go, bk, bv, kv, cs, sn, dq, part, G, N, I, H, C, spb, hg));
  } else {
    cudaError_t e = cudaFuncSetAttribute(rope_attention_bwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
    if (e != cudaSuccess) return (int)e;
    rope_attention_bwd_kernel<D><<<sh.blocks, THREADS, sh.smem, stream>>>(
        q, go, bk, bv, kv, cs, sn, dq, part, N, I, H, C);
  }
  int err = (int)cudaGetLastError();
  if (err) return err;
  return colsum::launch(part, static_cast<float*>(dbias), S, 2LL * C, 2LL * C, 0, stream);
}

// the resources of the kernel that a call at sequence length N runs (the
// short one at plan (spb, hg)): info[0] registers per thread, [1] local
// (spill) bytes per thread, [2] dynamic shared memory per block, [3]
// resident blocks per SM
template <typename K>
int kernel_resources(K kern, int threads, size_t smem, long long* info) {
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = fa.numRegs;
  info[1] = (long long)fa.localSizeBytes;
  info[2] = (long long)smem;
  info[3] = per_sm;
  return 0;
}

template <int D>
int resources(int N, int H, long long* info, int spb, int hg, int base2) {
  const Shape sh = shape(1, N, H, D, spb, hg, 2);
  if (sh.blocks == 0 || (!base2 && !sh.short_seq)) return (int)cudaErrorInvalidValue;
  return sh.short_seq ? kernel_resources(short_kernel<D>(N, base2), SHORT_THREADS, sh.smem, info)
                      : kernel_resources(rope_attention_bwd_kernel<D>, THREADS, sh.smem, info);
}

}  // namespace

// spb, hg: the short kernel's plan; base2: its softmax (0 natural). Trailing
// arguments: an older entry point without them is called the same way
extern "C" int rope_attention_bwd_resources(int N, int H, int C, long long* info, int spb, int hg,
                                            int base2) {
  switch (C / H) {
    case 16: return resources<16>(N, H, info, spb, hg, base2);
    case 24: return resources<24>(N, H, info, spb, hg, base2);
    case 32: return resources<32>(N, H, info, spb, hg, base2);
    case 64: return resources<64>(N, H, info, spb, hg, base2);
    default: return (int)cudaErrorInvalidValue;
  }
}

// spb, hg, grid: the short kernel's plan and its persistent grid (its
// resident blocks, at most one per unit; ops/rope_attention_bwd.py::_slots);
// base2: the softmax (1 the trunk's exp2 fold, 0 the natural one, N <= 16)
extern "C" int rope_attention_bwd(const void* qkv, const void* dout, const void* bias_k,
                                  const void* bias_v, const void* key_valid, const void* cos_t,
                                  const void* sin_t, void* dqkv, void* dbias, void* scratch,
                                  int G, int N, int I, int H, int C, void* stream, int spb,
                                  int hg, int grid, int base2) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 16: return launch<16>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, s, spb, hg, grid, base2);
    case 24: return launch<24>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, s, spb, hg, grid, base2);
    case 32: return launch<32>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, s, spb, hg, grid, base2);
    case 64: return launch<64>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, s, spb, hg, grid, base2);
    default: return (int)cudaErrorInvalidValue;
  }
}
