// rope_attention.cuh: the bodies of rope_attention.cu's two kernels (the
// design note is there) as device functions over a block index and a
// shared-memory buffer, so that rope_attention.cu and the merged layer
// backward (fused_layer_bwd.cu, which recomputes the trunk's attention
// outputs) run the same code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rope_tile.cuh"

namespace ropefwd {

typedef __nv_bfloat16 bf16;


constexpr int WARPS = 4;          // short kernel: warps per block
constexpr int LONG_THREADS = 128;  // long kernel: threads per (sequence, head)

template <int D>
__device__ __forceinline__ void rope_row(float* v, const float* cs, const float* sn) {
  float r[D];
#pragma unroll
  for (int d = 0; d < D; ++d) r[d] = d < D / 2 ? -v[d + D / 2] : v[d - D / 2];
#pragma unroll
  for (int d = 0; d < D; ++d) v[d] = v[d] * cs[d] + r[d] * sn[d];
}

// one query row against the NK keys/values staged at Ks/Vs/Kb: softmax
// (base 2 without max, or natural with max) and the weighted sum of values
template <int D>
__device__ __forceinline__ void attend_row(const float* q, const float* Ks, const float* Vs,
                                           const float* Kb, int NK, int base2, float* acc) {
  auto logit = [&](int j) {
    const float4* k4 = reinterpret_cast<const float4*>(Ks + j * D);
    float l = Kb[j];
#pragma unroll
    for (int d = 0; d < D / 4; ++d) {
      float4 k = k4[d];
      l += q[4 * d] * k.x + q[4 * d + 1] * k.y + q[4 * d + 2] * k.z + q[4 * d + 3] * k.w;
    }
    return l;
  };
  float m = 0.f;
  if (!base2) {
    m = -3.0e38f;
    for (int j = 0; j < NK; ++j) m = fmaxf(m, logit(j));
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float denom = 0.f;
  for (int j = 0; j < NK; ++j) {
    float l = logit(j);
    float p = base2 ? exp2f(fminf(l, 100.f)) : expf(l - m);
    denom += p;
    const float4* v4 = reinterpret_cast<const float4*>(Vs + j * D);
#pragma unroll
    for (int d = 0; d < D / 4; ++d) {
      float4 v = v4[d];
      acc[4 * d] += p * v.x;
      acc[4 * d + 1] += p * v.y;
      acc[4 * d + 2] += p * v.z;
      acc[4 * d + 3] += p * v.w;
    }
  }
  float inv = 1.f / (base2 ? denom + 1e-30f : denom);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] *= inv;
}

// per-head staging: NK roped keys, NK values, NK key biases (16-byte aligned)
__host__ __device__ constexpr int head_floats(int NK, int D) { return 2 * NK * D + ((NK + 3) & ~3); }

// stage key/value row n (n == N: the bias token) of head h, RoPE'd at n
template <int D>
__device__ __forceinline__ void stage_key(const bf16* qkv, const bf16* bias_k, const bf16* bias_v,
                                          const float* key_valid, const float* cos_t,
                                          const float* sin_t, long long row, int n, int N, int h,
                                          int C, float* Ks, float* Vs, float* Kb) {
  float kv[D], vv[D];
  if (n < N) {
    const bf16* src = qkv + row * 3LL * C + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kv[d] = __bfloat162float(src[C + d]);
      vv[d] = __bfloat162float(src[2 * C + d]);
    }
    Kb[n] = key_valid[row] > 0.f ? 0.f : -1e9f;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kv[d] = __bfloat162float(bias_k[h * D + d]);
      vv[d] = __bfloat162float(bias_v[h * D + d]);
    }
    Kb[n] = 0.f;
  }
  rope_row<D>(kv, cos_t + n * D, sin_t + n * D);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    Ks[n * D + d] = kv[d];
    Vs[n * D + d] = vv[d];
  }
}

// short sequences: a warp takes HPW = 32 / N heads of one sequence
template <int D>
__device__ __forceinline__ void short_block(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias_k,
    const bf16* __restrict__ bias_v, const float* __restrict__ key_valid,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    bf16* __restrict__ out, int G, int N, int I, int H, int C, int base2, int bx,
    float* smem_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int HPW = 32 / N, groups = (H + HPW - 1) / HPW, NK = N + 1;
  const long long task = (long long)bx * WARPS + warp;
  if (task >= (long long)G * I * groups) return;
  const int hg = (int)(task % groups);
  const long long s = task / groups, g = s / I, i = s % I;
  const long long row0 = g * N * I + i;
  const int hf = head_floats(NK, D);
  float* base = smem_s + (size_t)warp * HPW * hf;

  for (int e = lane; e < HPW * NK; e += 32) {
    int hl = e / NK, n = e % NK, h = hg * HPW + hl;
    if (h >= H) continue;
    float* Ks = base + hl * hf;
    stage_key<D>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, row0 + (long long)(n < N ? n : 0) * I,
                 n, N, h, C, Ks, Ks + NK * D, Ks + 2 * NK * D);
  }
  __syncwarp();
  const int hl = lane / N, n = lane % N, h = hg * HPW + hl;
  if (hl >= HPW || h >= H) return;
  const float* Ks = base + hl * hf;
  float q[D], acc[D];
  const long long row = row0 + (long long)n * I;
  const bf16* src = qkv + row * 3LL * C + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = __bfloat162float(src[d]);
  rope_row<D>(q, cos_t + n * D, sin_t + n * D);
  attend_row<D>(q, Ks, Ks + NK * D, Ks + 2 * NK * D, NK, base2, acc);
  bf16* dst = out + row * C + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) dst[d] = __float2bfloat16(acc[d]);
}

// ---- long sequences (N > 16): a block of 4 warps takes one (sequence,
// head); the design note is in rope_attention.cu ----

// shared memory of the long body (bytes): K (fp16, RoPE'd, times 2^sk) and
// V (bf16) of the NKP keys (N + 1 rounded up to 16), Q (fp16, RoPE'd, times
// 2^sq; each warp's tile then holds its output in bf16) of the NQP queries
// (N rounded up to 16), pad rows zero; the key biases; the warps' maxima
struct LongLayout {
  int NKP, NQP, RS;
  size_t ks, vs, qs, kb, red, total;
  __host__ __device__ LongLayout(int N, int D) {
    RS = (D + 15) / 16 * 16 + 8;  // attention_tile.cuh Dims<D>::RS
    NKP = (N + 1 + 15) / 16 * 16;
    NQP = (N + 15) / 16 * 16;
    size_t o = 0;
    ks = o; o += (size_t)NKP * RS * 2;
    vs = o; o += (size_t)NKP * RS * 2;
    qs = o; o += (size_t)NQP * RS * 2;
    kb = o; o += (size_t)NKP * 4;
    red = o; o += 16 * 4;
    total = o;
  }
};

template <int D, bool NATURAL>
__device__ __forceinline__ void long_tiles(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias_k,
    const bf16* __restrict__ bias_v, const float* __restrict__ key_valid,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    bf16* __restrict__ out, int N, int I, int H, int C, int bx, const LongLayout& lay,
    unsigned char* sm) {
  using namespace rope_tile;
  constexpr int RS = Dims<D>::RS, KC = Dims<D>::KC, OB = D / 8;
  constexpr int NB = 8;  // 8-key blocks of a 64-key chunk
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int h = bx % H;
  const long long s = bx / H;
  const long long row0 = (s / I) * (long long)N * I + s % I;  // token n: row0 + n * I
  const int NKP = lay.NKP, NQP = lay.NQP;
  f16* Ks = reinterpret_cast<f16*>(sm + lay.ks);
  bf16* Vs = reinterpret_cast<bf16*>(sm + lay.vs);
  f16* Qs = reinterpret_cast<f16*>(sm + lay.qs);
  float* Kb = reinterpret_cast<float*>(sm + lay.kb);
  float* Red = reinterpret_cast<float*>(sm + lay.red);

  // ---- stage, once: the keys (k RoPE'd, the bias key at N, v, the mask
  // bias) and the queries (q RoPE'd); zero rows past N ----
  auto key_row = [&](int n, float* k, float* v) {
    float b = -1e9f;
    if (n <= N) {
      if (n < N) {
        const long long row = row0 + (long long)n * I;
        const bf16* src = qkv + row * 3LL * C + h * D;
        load_row<D>(k, src + C);
        load_row<D>(v, src + 2 * C);
        b = key_valid[row] > 0.f ? 0.f : -1e9f;
      } else {
        load_row_scalar<D>(k, bias_k + h * D);
        load_row_scalar<D>(v, bias_v + h * D);
        b = 0.f;
      }
      rope<D>(k, cos_t + (long long)n * D, sin_t + (long long)n * D);
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) k[d] = v[d] = 0.f;
    }
    return b;
  };
  auto q_row = [&](int n, float* q) {
    if (n < N) {
      load_row<D>(q, qkv + (row0 + (long long)n * I) * 3LL * C + h * D);
      rope<D>(q, cos_t + (long long)n * D, sin_t + (long long)n * D);
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) q[d] = 0.f;
    }
  };
  float kmax = 0.f, qmax = 0.f;
  for (int t = tid; t < NKP + NQP; t += LONG_THREADS) {
    float x[D], y[D];
    if (t < NKP) {
      Kb[t] = key_row(t, x, y);
      kmax = fmaxf(kmax, row_max<D>(x));
      store_row<D, true>(Ks + t * RS, x);
      store_row<D, false>(Vs + t * RS, y);
    } else {
      q_row(t - NKP, x);
      qmax = fmaxf(qmax, row_max<D>(x));
      store_row<D, true>(Qs + (t - NKP) * RS, x);
    }
  }
  kmax = warp_max(kmax);
  qmax = warp_max(qmax);
  if (lane == 0) {
    Red[warp] = kmax;
    Red[4 + warp] = qmax;
  }
  __syncthreads();
  // k or q outside fp16's comfortable range: staged again, times a power
  // of two (the maxima are the block's, so the branches are uniform)
  const int sk = scale_exponent(max4(Red)), sq = scale_exponent(max4(Red + 4));
  if (sk != 0) {
    const float mul = ldexpf(1.f, sk);
    for (int n = tid; n <= N; n += LONG_THREADS) {
      float k[D], v[D];
      key_row(n, k, v);
      store_row<D, true>(Ks + n * RS, k, mul);
    }
  }
  if (sq != 0) {
    const float mul = ldexpf(1.f, sq);
    for (int n = tid; n < N; n += LONG_THREADS) {
      float q[D];
      q_row(n, q);
      store_row<D, true>(Qs + n * RS, q, mul);
    }
  }
  if (sk != 0 || sq != 0) __syncthreads();
  const float lscale = ldexpf(1.f, -(sq + sk));  // the logits' scale

  // ---- 16-query tiles, the warps in turn ----
  for (int q0 = warp * 16; q0 < NQP; q0 += (LONG_THREADS / 32) * 16) {
    uint32_t qa[KC][4];
    load_a<D>(qa, Qs, q0);

    float o[OB][4];
#pragma unroll
    for (int db = 0; db < OB; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;
    float l0 = 0.f, l1 = 0.f;              // row sums of rows gid, gid + 8 (this thread's columns)
    float m0 = -INFINITY, m1 = -INFINITY;  // natural: the rows' running maxima (base-2 units)
    for (int k0 = 0; k0 < NKP; k0 += 64) {
      const int nsub = min(4, (NKP - k0) >> 4);  // 16-key blocks in this chunk
      // logits: 16 queries x up to 64 keys, fp16 in, f32 out
      float sf[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        sf[nb][0] = sf[nb][1] = sf[nb][2] = sf[nb][3] = 0.f;
        if (nb / 2 < nsub) {
          uint32_t b[KC][2];
          load_b_d<D>(b, Ks, k0 + nb * 8);
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) mma16816_f16(sf[nb], qa[kc], b[kc][0], b[kc][1]);
        }
      }
      // p: f32 row sums, bf16 A fragments of the PV product (the
      // accumulator layout of the logits: 8-key blocks 2j, 2j + 1 form
      // 16-deep chunk j)
      uint32_t pa[4][4];
      if constexpr (NATURAL) {
        const float sl = lscale * attn_tile::LOG2E;
        float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          if (nb / 2 < nsub) {
            const float2 kb = *reinterpret_cast<const float2*>(Kb + k0 + nb * 8 + tig * 2);
            sf[nb][0] = fmaf(sf[nb][0], sl, kb.x);
            sf[nb][1] = fmaf(sf[nb][1], sl, kb.y);
            sf[nb][2] = fmaf(sf[nb][2], sl, kb.x);
            sf[nb][3] = fmaf(sf[nb][3], sl, kb.y);
            t0 = fmaxf(t0, fmaxf(sf[nb][0], sf[nb][1]));
            t1 = fmaxf(t1, fmaxf(sf[nb][2], sf[nb][3]));
          }
        }
        t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
        t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
        t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
        t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
        const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
        const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);  // 0 at the first chunk
        m0 = n0;
        m1 = n1;
        l0 *= a0;
        l1 *= a1;
#pragma unroll
        for (int db = 0; db < OB; ++db) {
          o[db][0] *= a0;
          o[db][1] *= a0;
          o[db][2] *= a1;
          o[db][3] *= a1;
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          if (nb / 2 < nsub) {
            const float p0 = exp2f(sf[nb][0] - n0), p1 = exp2f(sf[nb][1] - n0);
            const float p2 = exp2f(sf[nb][2] - n1), p3 = exp2f(sf[nb][3] - n1);
            l0 += p0 + p1;
            l1 += p2 + p3;
            pa[nb / 2][(nb % 2) * 2] = attn_tile::pack2(p0, p1);
            pa[nb / 2][(nb % 2) * 2 + 1] = attn_tile::pack2(p2, p3);
          }
        }
      } else {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          if (nb / 2 < nsub) {
            const float2 kb = *reinterpret_cast<const float2*>(Kb + k0 + nb * 8 + tig * 2);
            const float p0 = exp2f(fminf(fmaf(sf[nb][0], lscale, kb.x), 100.f));
            const float p1 = exp2f(fminf(fmaf(sf[nb][1], lscale, kb.y), 100.f));
            const float p2 = exp2f(fminf(fmaf(sf[nb][2], lscale, kb.x), 100.f));
            const float p3 = exp2f(fminf(fmaf(sf[nb][3], lscale, kb.y), 100.f));
            l0 += p0 + p1;
            l1 += p2 + p3;
            pa[nb / 2][(nb % 2) * 2] = attn_tile::pack2(p0, p1);
            pa[nb / 2][(nb % 2) * 2 + 1] = attn_tile::pack2(p2, p3);
          }
        }
      }
      // O += P V: V's B fragments by ldmatrix.trans of its rows
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nsub) {
          uint32_t b[OB][2];
          load_b_rows<D>(b, Vs, k0 + 16 * j);
#pragma unroll
          for (int db = 0; db < OB; ++db) attn_tile::mma16816(o[db], pa[j], b[db][0], b[db][1]);
        }
      }
    }
    // the four threads of a row group hold disjoint columns of each row
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    // the natural row sums hold exp2(0) = 1 at least (the row's max key)
    const float inv0 = NATURAL ? 1.f / l0 : 1.f / (l0 + 1e-30f);
    const float inv1 = NATURAL ? 1.f / l1 : 1.f / (l1 + 1e-30f);
    // the output tile through the tile's q rows (bf16), out as 16-byte vectors
    __syncwarp();
    bf16* Ow = reinterpret_cast<bf16*>(Qs + q0 * RS);
#pragma unroll
    for (int db = 0; db < OB; ++db) {
      const int d = db * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(Ow + gid * RS + d) = attn_tile::pack2(o[db][0] * inv0, o[db][1] * inv0);
      *reinterpret_cast<uint32_t*>(Ow + (gid + 8) * RS + d) =
          attn_tile::pack2(o[db][2] * inv1, o[db][3] * inv1);
    }
    __syncwarp();
    for (int e = lane; e < 16 * OB; e += 32) {
      const int r = e / OB, v = e % OB, n = q0 + r;
      if (n < N)
        *reinterpret_cast<uint4*>(out + (row0 + (long long)n * I) * C + h * D + 8 * v) =
            *reinterpret_cast<const uint4*>(Ow + r * RS + 8 * v);
    }
  }
}

template <int D>
__device__ __forceinline__ void long_block(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias_k,
    const bf16* __restrict__ bias_v, const float* __restrict__ key_valid,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    bf16* __restrict__ out, int G, int N, int I, int H, int C, int base2, int bx,
    float* smem) {
  const LongLayout lay(N, D);
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem);
  if (base2)
    long_tiles<D, false>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, N, I, H, C, bx, lay, sm);
  else
    long_tiles<D, true>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, N, I, H, C, bx, lay, sm);
}

// the launch shape of a call: short (N <= 16: a warp takes 32 / N heads of
// one sequence) or long (a block per (sequence, head)); blocks and the
// dynamic shared memory of a block
struct Shape {
  bool short_seq;
  unsigned blocks, threads;
  size_t smem;
};

__host__ __device__ inline Shape shape(int G, int N, int I, int H, int D) {
  Shape s;
  const int NK = N + 1;
  s.short_seq = N <= 16;
  const int HPW = s.short_seq ? 32 / N : 1;
  s.smem = s.short_seq ? (size_t)WARPS * HPW * head_floats(NK, D) * sizeof(float)
                       : LongLayout(N, D).total;
  const long long tasks = (long long)G * I * ((H + HPW - 1) / HPW);
  s.blocks = (unsigned)(s.short_seq ? (tasks + WARPS - 1) / WARPS : tasks);
  s.threads = s.short_seq ? WARPS * 32 : LONG_THREADS;
  return s;
}

template <int D>
__device__ __forceinline__ void block(const Shape& sh, const bf16* qkv, const bf16* bias_k,
                                      const bf16* bias_v, const float* key_valid,
                                      const float* cos_t, const float* sin_t, bf16* out, int G,
                                      int N, int I, int H, int C, int base2, int bx,
                                      float* smem) {
  if (sh.short_seq)
    short_block<D>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, bx, smem);
  else
    long_block<D>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, bx, smem);
}

}  // namespace ropefwd
