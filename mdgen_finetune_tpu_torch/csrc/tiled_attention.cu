// tiled_attention: the frame-attention core at long T, with its keys tiled
// through shared memory, so that no shared-memory buffer grows with N.
//
// Replaces the attention core of
//   mdgen_finetune_tpu/ops/time_attention.py::_block_pallas_fwd_blocked
//   (body _block_kernel_blocked: RoPE, the bias key, `_grouped_attend` with
//   base2=True), the TPU kernel that the JAX package's trunk runs for the
//   frame stage at T > MAX_T = 256 (the 4AA forward-simulation preset,
//   T = 1000), and, in its natural-softmax mode (base2 = 0), the whole of
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
//   - the base-2 no-max softmax: q carries head_dim^-0.5 * log2(e), the
//     weights are p = exp2(min(l, 100)), the denominator is the sum of the
//     f32 p plus 1e-30, and p goes to the PV product in bf16 (as JAX casts
//     the unnormalised p before its PV dot);
//   - the output (G, N, I, C) bf16.
//
// The no-max contract is what makes the key loop simple: with no running
// max there is nothing to rescale, so each key tile adds its unnormalised
// p.V into the f32 accumulators and its p into the row sums, and the one
// division happens after the last tile. A masked key gets exp2(-1e9) = 0
// exactly, so a tile that holds only masked (or padding) keys adds nothing.
//
// The natural mode (the modular layer: q carries head_dim^-0.5 only) is
// JAX's max-subtracted softmax, p = exp(l - max l), computed online: each
// row keeps a running max across the key tiles, and when a tile raises it
// the f32 accumulators and the row sums are rescaled by exp(old - new)
// before the tile's p = exp(l - new) is added. So no exp overflows however
// large the logits (exp without the max would overflow f32 above l = 88).
// It runs in base-2 units, t = l * log2(e) and p = exp2(t - max t), the
// same function: exp2f is the short hardware sequence that the base-2 mode
// also uses, where expf is a longer accurate one (PERF.md times both). A
// tile of masked keys only (l = -1e9) may set the first max; the first
// attendable key (the bias key, at the latest) rescales its terms by
// exp2(-1e9 - t) = 0. The two modes are one kernel with a template flag;
// the base-2 instructions are those of the base-2 kernel before the mode
// existed.
//
// Design: one block of 4 warps per (sequence, head, 64-query tile). The
// query tile is RoPE'd into shared memory once; each warp keeps its 16 rows
// as mma.sync A fragments in registers. K and V stream through shared memory
// in tiles of 64 keys (bf16, RoPE'd as they are staged; V transposed so that
// its B fragments are 32-bit reads). Per key tile a warp computes its
// 16 x 64 logits with mma.sync m16n8k16 (bf16 in, f32 out; D padded with
// zero lanes to a multiple of 16: 24 -> 32), forms p in registers, reuses the
// f32 accumulator layout of the logits as the A fragments of the PV product,
// and accumulates O (16 x D) in f32 registers. Only q/k/v in and the output
// out touch device memory; shared memory is a fixed ~15 KB (D = 24) to
// ~28 KB (D = 64) at any N.
//
// What bounds it on the H100: at the 4AA preset (B = 8, T = 1000, L = 4,
// 16 heads of D = 24) it does 4*B*L*H*T*(T+1)*D = 4.9e10 FLOP against
// ~98 MB of q/k/v and output, so the tensor cores bound it (0.050 ms at
// 989 TFLOP/s, against 0.029 ms for the bytes). This first version restages
// each key tile for every query tile (through L2), pads D = 24 to 32 and
// uses mma.sync, not wgmma/TMA: making it fast is later work.

#include <cuda_runtime.h>

#include "attention_tile.cuh"

using attn_tile::bf16;
using attn_tile::ld32;
using attn_tile::mma16816;
using attn_tile::pack2;

namespace {

constexpr int QT = 64;        // queries per block: 4 warps x 16 rows
constexpr int KT = 64;        // keys per shared-memory tile
constexpr int THREADS = 128;
constexpr int VS = KT + 8;    // row stride (bf16) of the transposed V tile

// Stage `rows` tokens n0.. of q (col = 0) or k (col = C) of head h into
// dst (row stride S), RoPE'd at their positions. With `bias`, token N is the
// bias key; other tokens past the sequence are zero rows.
template <int D, int S>
__device__ __forceinline__ void stage_roped(bf16* dst, const bf16* qkv, const bf16* bias,
                                            const float* cos_t, const float* sin_t,
                                            long long row0, int n0, int rows, int N, int I,
                                            int h, int C, int col) {
  constexpr int HALF = D / 2;
  for (int e = threadIdx.x; e < rows * HALF; e += THREADS) {
    const int r = e / HALF, d = e % HALF, n = n0 + r;
    float v0 = 0.f, v1 = 0.f;
    if (n < N) {
      const bf16* src = qkv + (row0 + (long long)n * I) * 3LL * C + col + h * D;
      v0 = __bfloat162float(src[d]);
      v1 = __bfloat162float(src[d + HALF]);
    } else if (n == N && bias != nullptr) {
      v0 = __bfloat162float(bias[h * D + d]);
      v1 = __bfloat162float(bias[h * D + d + HALF]);
    }
    float o0 = 0.f, o1 = 0.f;
    if (n < N || (n == N && bias != nullptr)) {
      const float* cs = cos_t + (long long)n * D;
      const float* sn = sin_t + (long long)n * D;
      o0 = v0 * cs[d] - v1 * sn[d];
      o1 = v1 * cs[d + HALF] + v0 * sn[d + HALF];
    }
    dst[r * S + d] = __float2bfloat16(o0);
    dst[r * S + d + HALF] = __float2bfloat16(o1);
  }
}

template <int D, bool NATURAL>
__global__ void __launch_bounds__(THREADS) tiled_attention_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias_k,
    const bf16* __restrict__ bias_v, const float* __restrict__ key_valid,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    bf16* __restrict__ out, int N, int I, int H, int C, int qtiles) {
  constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to the mma depth
  constexpr int KS = DP + 8;              // row stride (bf16) of the Q and K tiles
  constexpr int NB = KT / 8;              // 8-key blocks of the logits
  constexpr int KC = DP / 16;             // 16-deep chunks of q.k
  constexpr int DB = DP / 8;              // 8-lane blocks of the output
  __shared__ __align__(16) bf16 Qs[QT * KS];
  __shared__ __align__(16) bf16 Ks[KT * KS];
  __shared__ __align__(16) bf16 Vt[DP * VS];
  __shared__ float Kb[KT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  long long task = blockIdx.x;
  const int qt = (int)(task % qtiles);
  task /= qtiles;
  const int h = (int)(task % H);
  const long long s = task / H;
  const long long row0 = (s / I) * (long long)N * I + s % I;  // token n: row0 + n * I
  const int q0 = qt * QT;

  if constexpr (DP > D) {  // zero pad lanes: they meet only zeros in the products
    constexpr int P = DP - D;
    for (int e = tid; e < QT * P; e += THREADS) Qs[(e / P) * KS + D + e % P] = __float2bfloat16(0.f);
    for (int e = tid; e < KT * P; e += THREADS) Ks[(e / P) * KS + D + e % P] = __float2bfloat16(0.f);
    for (int e = tid; e < P * VS; e += THREADS) Vt[D * VS + e] = __float2bfloat16(0.f);
  }
  stage_roped<D, KS>(Qs, qkv, nullptr, cos_t, sin_t, row0, q0, QT, N, I, h, C, 0);
  __syncthreads();

  uint32_t qa[KC][4];
  {
    const bf16* q_lo = Qs + (warp * 16 + gid) * KS + tig * 2;
    const bf16* q_hi = q_lo + 8 * KS;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      qa[kc][0] = ld32(q_lo + kc * 16);
      qa[kc][1] = ld32(q_hi + kc * 16);
      qa[kc][2] = ld32(q_lo + kc * 16 + 8);
      qa[kc][3] = ld32(q_hi + kc * 16 + 8);
    }
  }
  float o[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;  // row sums of rows gid and gid + 8 (this thread's columns)
  float m0 = -INFINITY, m1 = -INFINITY;  // natural mode: the rows' running maxima

  const int ntiles = (N + 1 + KT - 1) / KT;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * KT;
    __syncthreads();  // every warp is done with the previous tile
    stage_roped<D, KS>(Ks, qkv, bias_k, cos_t, sin_t, row0, k0, KT, N, I, h, C, C);
    for (int e = tid; e < KT * D; e += THREADS) {
      const int r = e / D, d = e % D, n = k0 + r;
      bf16 v = __float2bfloat16(0.f);
      if (n < N) v = qkv[(row0 + (long long)n * I) * 3LL * C + 2 * C + h * D + d];
      else if (n == N) v = bias_v[h * D + d];
      Vt[d * VS + r] = v;
    }
    if (tid < KT) {
      const int n = k0 + tid;
      Kb[tid] = n < N ? (key_valid[row0 + (long long)n * I] > 0.f ? 0.f : -1e9f)
                      : (n == N ? 0.f : -1e9f);
    }
    __syncthreads();

    // logits: this warp's 16 queries x 64 keys
    float sf[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      sf[nb][0] = sf[nb][1] = sf[nb][2] = sf[nb][3] = 0.f;
      const bf16* kr = Ks + (nb * 8 + gid) * KS + tig * 2;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) mma16816(sf[nb], qa[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
    }
    // p = exp2(min(l + bias, 100)): f32 row sums, bf16 A fragments for p.V
    uint32_t pa[KT / 16][4];
    if constexpr (NATURAL) {
      // the logits in base-2 units, the tile's row maxima (the four threads
      // of a row group hold disjoint columns), then rescale what earlier
      // tiles summed
      float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = nb * 8 + tig * 2;
        sf[nb][0] = fmaf(sf[nb][0], attn_tile::LOG2E, Kb[c]);
        sf[nb][1] = fmaf(sf[nb][1], attn_tile::LOG2E, Kb[c + 1]);
        sf[nb][2] = fmaf(sf[nb][2], attn_tile::LOG2E, Kb[c]);
        sf[nb][3] = fmaf(sf[nb][3], attn_tile::LOG2E, Kb[c + 1]);
        t0 = fmaxf(t0, fmaxf(sf[nb][0], sf[nb][1]));
        t1 = fmaxf(t1, fmaxf(sf[nb][2], sf[nb][3]));
      }
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
      const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
      const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);  // 0 at the first tile
      m0 = n0;
      m1 = n1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int db = 0; db < DB; ++db) {
        o[db][0] *= a0;
        o[db][1] *= a0;
        o[db][2] *= a1;
        o[db][3] *= a1;
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float p0 = exp2f(sf[nb][0] - n0), p1 = exp2f(sf[nb][1] - n0);
        const float p2 = exp2f(sf[nb][2] - n1), p3 = exp2f(sf[nb][3] - n1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        pa[nb / 2][(nb % 2) * 2] = pack2(p0, p1);
        pa[nb / 2][(nb % 2) * 2 + 1] = pack2(p2, p3);
      }
    } else {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = nb * 8 + tig * 2;
        const float p0 = exp2f(fminf(sf[nb][0] + Kb[c], 100.f));
        const float p1 = exp2f(fminf(sf[nb][1] + Kb[c + 1], 100.f));
        const float p2 = exp2f(fminf(sf[nb][2] + Kb[c], 100.f));
        const float p3 = exp2f(fminf(sf[nb][3] + Kb[c + 1], 100.f));
        l0 += p0 + p1;
        l1 += p2 + p3;
        pa[nb / 2][(nb % 2) * 2] = pack2(p0, p1);
        pa[nb / 2][(nb % 2) * 2 + 1] = pack2(p2, p3);
      }
    }
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
#pragma unroll
      for (int db = 0; db < DB; ++db) {
        const bf16* vr = Vt + (db * 8 + gid) * VS + j * 16 + tig * 2;
        mma16816(o[db], pa[j], ld32(vr), ld32(vr + 8));
      }
    }
  }

  // the four threads of a row group hold disjoint columns of each row
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // the natural row sums hold exp(0) = 1 at least (the row's max key)
  const float inv0 = NATURAL ? 1.f / l0 : 1.f / (l0 + 1e-30f);
  const float inv1 = NATURAL ? 1.f / l1 : 1.f / (l1 + 1e-30f);
  const int n_lo = q0 + warp * 16 + gid, n_hi = n_lo + 8;
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    const int d = db * 8 + tig * 2;
    if (d >= D) continue;
    if (n_lo < N)
      *reinterpret_cast<uint32_t*>(out + (row0 + (long long)n_lo * I) * C + h * D + d) =
          pack2(o[db][0] * inv0, o[db][1] * inv0);
    if (n_hi < N)
      *reinterpret_cast<uint32_t*>(out + (row0 + (long long)n_hi * I) * C + h * D + d) =
          pack2(o[db][2] * inv1, o[db][3] * inv1);
  }
}

template <int D, bool NATURAL>
int launch(const void* qkv, const void* bias_k, const void* bias_v, const void* key_valid,
           const void* cos_t, const void* sin_t, void* out, int G, int N, int I, int H, int C,
           cudaStream_t stream) {
  const int qtiles = (N + QT - 1) / QT;
  const long long blocks = (long long)G * I * H * qtiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tiled_attention_kernel<D, NATURAL><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias_k),
      static_cast<const bf16*>(bias_v), static_cast<const float*>(key_valid),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<bf16*>(out), N, I, H, C, qtiles);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mode(const void* qkv, const void* bias_k, const void* bias_v, const void* key_valid,
                const void* cos_t, const void* sin_t, void* out, int G, int N, int I, int H,
                int C, int base2, cudaStream_t stream) {
  return base2 ? launch<D, false>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H,
                                  C, stream)
               : launch<D, true>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H,
                                 C, stream);
}

}  // namespace

// base2 = 1: the base-2 no-max softmax (the fused trunk); 0: the natural
// max-subtracted softmax (the modular layer)
extern "C" int tiled_attention(const void* qkv, const void* bias_k, const void* bias_v,
                               const void* key_valid, const void* cos_t, const void* sin_t,
                               void* out, int G, int N, int I, int H, int C, int base2,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 16: return launch_mode<16>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s);
    case 24: return launch_mode<24>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s);
    case 32: return launch_mode<32>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s);
    case 64: return launch_mode<64>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
