// tiled_attention: the frame-attention core at long T (and the residue
// attention at large L), for any number of keys.
//
// Replaces the attention core of
//   mdgen_finetune_tpu/ops/time_attention.py::_block_pallas_fwd_blocked
//   (body _block_kernel_blocked: RoPE, the bias key, `_grouped_attend` with
//   base2=True), the TPU kernel that the JAX package's trunk runs for the
//   frame stage at T > MAX_T = 256 (the 4AA forward-simulation preset,
//   T = 1000) and, through its rows form (_block_pallas_fwd_blocked_rows),
//   for the residue stage at L > 8 (ATLAS); and, in its natural-softmax
//   mode (base2 = 0), the whole of
//   mdgen_finetune_tpu/ops/time_attention.py::_pallas_fwd_blocked (:343,
//   body _kernel_blocked :303, `_grouped_attend` with base2=False): the
//   modular layer's frame attention above L = 8 or T = 256, and its residue
//   attention above L = 8 with the axes swapped.
//
// Layout (that of rope_attention, so the trunk swaps one call for the other
// with no transpose): qkv is (G, N, I, 3C) bf16 (q | k | v column blocks);
// attention runs over N for every (g, i) (frame stage: G = B, N = T, I = L).
// key_valid is (G, N, I) f32, bias_k / bias_v (C,) bf16, the RoPE tables
// (N+1, D) f32. For each sequence and head:
//   - RoPE on q and k (rotate-half), rounded to bf16 as the JAX kernel does;
//   - the learned bias key/value appended at position N, the key RoPE'd there;
//   - the key mask as an additive -1e9 (the bias key is always valid);
//   - base 2 (the trunk): q carries head_dim^-0.5 * log2(e), the weights
//     are p = exp2(min(l, 100)) with no max, over the sum of the f32 p plus
//     1e-30; natural (the modular layer): q carries head_dim^-0.5 and the
//     weights are p = exp2(t - max t) with t = l log2(e), JAX's
//     max-subtracted softmax, so no exp overflows at any logit;
//   - p goes to the PV product in bf16 (as JAX casts p before its PV dot);
//   - the output (G, N, I, C) bf16.
//
// What bounds it on the H100: at the 4AA preset (B = 8, T = 1000, L = 4,
// 16 heads of D = 24) it does 4*B*L*H*T*(T+1)*D = 4.9e10 FLOP on the tensor
// cores (0.050 ms at 989 TFLOP/s) against ~98 MB of q/k/v and output
// (0.029 ms). But every design forms one exp2 per (query, key), 5.1e8
// there, and the SFU issues 16 of them per clock per SM: 0.122 ms at the
// H100's 1,980 MHz, above both, and each logit also costs the FP32 pipe
// 3-4 instructions (mask, clamp or max, row sum, bf16 pack).
//
// Design (long_attention.cuh): one block of 8 warps per (sequence, head)
// (or per chunk of its query tiles where the heads alone do not fill the
// SMs; ops/long_attention.py). The block stages its head's keys once: k and
// v by cp.async (every copy in flight at once), then k RoPE'd in place in
// f32 and rounded to bf16, and each key's additive mask, in rows of D lanes
// (no pad of D = 24 to 32; 100 bytes a key at D = 24, so the 1,001 keys of
// T = 1000 take 101 KB and two blocks share an SM). Each warp then takes
// two 16-query tiles at a time: it stages their queries RoPE'd into its own
// rows, keeps them as A fragments, and walks every resident key in steps
// of 32 (16 at the tail) with no barrier: each B fragment of k (ldmatrix,
// an m16n8k8 tail at D = 24) and of v (ldmatrix.trans of the row-major
// tile) serves both tiles; logits and p stay in registers, the accumulator
// layout of the logits reused as the A fragments of P.V. The natural mode
// keeps a running max per query row over the steps and rescales the f32
// output and row sums only when the max of some row of the warp rose in the
// step (multiplying by exp2(0) = 1 changes no bit), which after the first
// steps it rarely does. Heads whose keys do not fit (larger N or D) stream
// them in windows, one pair of query tiles per warp, every window staged
// once per block.

#include <cuda_runtime.h>

#include "long_attention.cuh"

using namespace longattn;
using rope_tile::load_row;
using rope_tile::load_row_scalar;
using rope_tile::rope;

namespace {

template <int D, bool NATURAL>
__global__ void __launch_bounds__(THREADS, Occ<D>::MIN_BLOCKS) tiled_attention_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias_k,
    const bf16* __restrict__ bias_v, const float* __restrict__ key_valid,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    bf16* __restrict__ out, int N, int I, int H, int C, int chunks, int chunk, int win) {
  constexpr int RS = Geo<D>::RS, OB = Geo<D>::OB;
  constexpr int NBK = D <= 32 ? 4 : 2;  // 8-key blocks of a full step
  const float km = NATURAL ? LOG2E : 1.f;  // the logits' scale to base-2 units
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout<D> lay(win);
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.ks);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.vs);
  float* Kb = reinterpret_cast<float*>(smem + lay.kb);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  bf16* Qw = reinterpret_cast<bf16*>(smem + lay.qw) + warp * TQ * 16 * RS;

  const long long sh = blockIdx.x / chunks;
  const int h = (int)(sh % H);
  const long long seq = sh / H;
  const long long row0 = (seq / I) * (long long)N * I + seq % I;  // token n: row0 + n * I
  auto tok = [&](int n) { return row0 + (long long)n * I; };
  const int NKP = (N + 1 + 15) / 16 * 16;  // the keys (N and the bias key) in 16-key tiles
  const Sched sc(blockIdx.x % chunks, chunk, (N + 15) / 16, NKP, win, TQ);

  // keys w0 .. of the window: k and v copied in by cp.async (every 16-byte
  // unit of the window in flight at once) and the masks (issue); then k
  // RoPE'd in place in f32 and rounded to bf16, and the bias key and value
  // at N (finish); zero rows at -1e9 past it
  auto issue = [&](int w0) {
    constexpr int U = D / 8;  // 16-byte units of a row
    const int rows = min(win, NKP - w0);
    for (int e = tid; e < rows * U; e += THREADS) {
      const int r = e / U, u = e % U, n = w0 + r;
      const bf16* src = qkv + tok(n < N ? n : 0) * 3LL * C + h * D + u * 8;
      cp_async16(Ks + r * RS + u * 8, src + C, n < N);
      cp_async16(Vs + r * RS + u * 8, src + 2 * C, n < N);
    }
    for (int r = tid; r < rows; r += THREADS) {
      const int n = w0 + r;
      Kb[r] = n < N ? (key_valid[tok(n)] > 0.f ? 0.f : MASKED) : (n == N ? 0.f : MASKED);
    }
  };
  auto finish = [&](int w0) {
    const int rows = min(win, NKP - w0);
    cp_async_wait_all();
    __syncthreads();
    for (int r = tid; r < rows; r += THREADS) {
      const int n = w0 + r;
      if (n > N) continue;
      float k[D];
      if (n < N) {
        load_row<D>(k, Ks + r * RS);
      } else {
        float v[D];
        load_row_scalar<D>(k, bias_k + h * D);
        load_row_scalar<D>(v, bias_v + h * D);
        blockedbwd::store_row<D, false>(Vs + r * RS, v);
      }
      rope<D>(k, cos_t + (long long)n * D, sin_t + (long long)n * D);
      blockedbwd::store_row<D, false>(Ks + r * RS, k);
    }
    __syncthreads();
  };

  for (int round = 0; round < sc.rounds; ++round) {
    const int tile0 = sc.t0 + (round * WARPS + warp) * TQ;
    const bool active = tile0 < sc.t1;  // uniform over the warp
    if (round == 0) issue(0);  // the first window's copies fly while the queries load
    AFrag<D> qa[TQ];
    if (active) {
      {  // the tiles' queries, RoPE'd and rounded to bf16: lane i, row i
        const int n = tile0 * 16 + lane;
        float x[D];
        if (lane < TQ * 16 && n < N) {
          load_row<D>(x, qkv + tok(n) * 3LL * C + h * D);
          rope<D>(x, cos_t + (long long)n * D, sin_t + (long long)n * D);
        } else {
#pragma unroll
          for (int d = 0; d < D; ++d) x[d] = 0.f;
        }
        if (lane < TQ * 16) blockedbwd::store_row<D, false>(Qw + lane * RS, x);
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < TQ; ++t) qa[t].load(Qw, t * 16);
      __syncwarp();
    }
    float o[TQ][OB][4], l[TQ][2], m[TQ][2];
#pragma unroll
    for (int t = 0; t < TQ; ++t) {
      l[t][0] = l[t][1] = 0.f;
      m[t][0] = m[t][1] = -INFINITY;
#pragma unroll
      for (int db = 0; db < OB; ++db) o[t][db][0] = o[t][db][1] = o[t][db][2] = o[t][db][3] = 0.f;
    }
    for (int w = 0; w < sc.nwin; ++w) {
      if (sc.nwin > 1 || round == 0) {  // one window: staged once for every round
        if (round > 0 || w > 0) {
          __syncthreads();  // every warp is done with the last window
          issue(w * win);
        }
        finish(w * win);
      }
      if (active) {
        const int nk = min(win, NKP - w * win);
        int k0 = 0;
        for (; k0 + NBK * 8 <= nk; k0 += NBK * 8) step<D, NATURAL, NBK>(o, l, m, qa, Ks, Vs, Kb, km, k0);
        for (; k0 < nk; k0 += 16) step<D, NATURAL, 2>(o, l, m, qa, Ks, Vs, Kb, km, k0);
      }
    }
    if (!active) continue;
    // the normalised rows in bf16 into the warp's own rows, then one row
    // per lane to device memory in 16-byte stores
#pragma unroll
    for (int t = 0; t < TQ; ++t)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float li = l[t][i];
        li += __shfl_xor_sync(0xffffffffu, li, 1);
        li += __shfl_xor_sync(0xffffffffu, li, 2);
        // the natural row sums hold exp2(0) = 1 at least (the row's max key)
        const float inv = NATURAL ? 1.f / li : 1.f / (li + 1e-30f);
        bf16* row = Qw + (t * 16 + gid + 8 * i) * RS + tig * 2;
#pragma unroll
        for (int db = 0; db < OB; ++db)
          *reinterpret_cast<uint32_t*>(row + db * 8) = pack2(o[t][db][2 * i] * inv, o[t][db][2 * i + 1] * inv);
      }
    __syncwarp();
    const int n = tile0 * 16 + lane;
    if (lane < TQ * 16 && tile0 + lane / 16 < sc.t1 && n < N) {
      const uint4* src = reinterpret_cast<const uint4*>(Qw + lane * RS);
      uint4* dst = reinterpret_cast<uint4*>(out + tok(n) * C + h * D);
#pragma unroll
      for (int u = 0; u < D / 8; ++u) dst[u] = src[u];
    }
    __syncwarp();
  }
}

template <int D, bool NATURAL>
int launch(const void* qkv, const void* bias_k, const void* bias_v, const void* key_valid,
           const void* cos_t, const void* sin_t, void* out, int G, int N, int I, int H, int C,
           int chunk, int win, cudaStream_t stream) {
  const long long S = (long long)G * I * H;
  const int tiles = (N + 15) / 16;
  if (N <= 0 || S <= 0 || chunk <= 0 || win < 16 || win % 16) return (int)cudaErrorInvalidValue;
  const int chunks = (tiles + chunk - 1) / chunk;
  if (S * chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = FwdLayout<D>(win).total;
  cudaError_t e = cudaFuncSetAttribute(tiled_attention_kernel<D, NATURAL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  tiled_attention_kernel<D, NATURAL><<<(unsigned)(S * chunks), THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias_k),
      static_cast<const bf16*>(bias_v), static_cast<const float*>(key_valid),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<bf16*>(out), N, I, H, C, chunks, chunk, win);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mode(const void* qkv, const void* bias_k, const void* bias_v, const void* key_valid,
                const void* cos_t, const void* sin_t, void* out, int G, int N, int I, int H,
                int C, int base2, int chunk, int win, cudaStream_t stream) {
  return base2 ? launch<D, false>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H,
                                  C, chunk, win, stream)
               : launch<D, true>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H,
                                 C, chunk, win, stream);
}

template <int D>
int resources_mode(int win, int base2, long long* info) {
  const size_t smem = FwdLayout<D>(win).total;
  return base2 ? resources(tiled_attention_kernel<D, false>, smem, info)
               : resources(tiled_attention_kernel<D, true>, smem, info);
}

}  // namespace

// base2 = 1: the base-2 no-max softmax (the fused trunk); 0: the natural
// max-subtracted softmax (the modular layer). The schedule (ops/
// long_attention.py) follows the stream: `chunk` 16-query tiles per block,
// `win` resident keys (a multiple of 16)
extern "C" int tiled_attention(const void* qkv, const void* bias_k, const void* bias_v,
                               const void* key_valid, const void* cos_t, const void* sin_t,
                               void* out, int G, int N, int I, int H, int C, int base2,
                               void* stream, int chunk, int win) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 16: return launch_mode<16>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, chunk, win, s);
    case 24: return launch_mode<24>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, chunk, win, s);
    case 32: return launch_mode<32>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, chunk, win, s);
    case 64: return launch_mode<64>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, chunk, win, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the kernel's resources at a window of `win` keys (long_attention.cuh's
// resources: registers, spill bytes, shared memory, blocks per SM)
extern "C" int tiled_attention_resources(int win, int D, int base2, long long* info) {
  switch (D) {
    case 16: return resources_mode<16>(win, base2, info);
    case 24: return resources_mode<24>(win, base2, info);
    case 32: return resources_mode<32>(win, base2, info);
    case 64: return resources_mode<64>(win, base2, info);
    default: return (int)cudaErrorInvalidValue;
  }
}
