// blocked_attention_bwd.cuh: the block body of blocked_attention_bwd.cu
// (the design note is there) as a device function over a block index and a
// shared-memory buffer, so that blocked_attention_bwd.cu and the merged
// layer backward (fused_layer_bwd.cu, the frame stage at 128 < T <= 256)
// run the same code.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "attention_tile.cuh"
#include "rope_tile.cuh"

namespace blockedbwd {

using namespace attn_tile;
using rope_tile::max4;
using rope_tile::scale_exponent;  // the fp16 range rule, shared with rope_attention_bwd
using rope_tile::warp_max;


typedef __half f16;

// the two element types of the products: fp16 (q, k, scaled ds) and bf16
struct BF16 {
  typedef bf16 T;
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
    mma16816(c, a, b0, b1);
  }
};

struct F16 {
  typedef f16 T;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return rope_tile::pack_h2(lo, hi);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
    rope_tile::mma16816_f16(c, a, b0, b1);
  }
};

__device__ __forceinline__ uint32_t ld32h(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// stride (elements) of the transposed query / dO tiles and of the pn^T /
// ds^T tiles: 64 columns + 8
constexpr int QTS = ROWS + 8;

template <int D>
struct Layout {
  static constexpr int DP = Dims<D>::DP, RS = Dims<D>::RS;
  int NKP, KTS;                          // padded keys, stride of the transposed keys
  size_t ks, vs, kt, qs, gs, qt, gt, pt, st, pst, dka, dva, kc, red, total;  // byte offsets
  __host__ __device__ explicit Layout(int N) {
    NKP = (N + 1 + ROWS - 1) / ROWS * ROWS;
    KTS = NKP + 8;
    size_t o = 0;
    ks = o; o += (size_t)NKP * RS * 2;
    vs = o; o += (size_t)NKP * RS * 2;
    kt = o; o += (size_t)DP * KTS * 2;
    qs = o; o += (size_t)ROWS * RS * 2;
    gs = o; o += (size_t)ROWS * RS * 2;
    qt = o; o += (size_t)DP * QTS * 2;
    gt = o; o += (size_t)DP * QTS * 2;
    pt = o; o += (size_t)ROWS * QTS * 2;   // also the f32 dq tile (64 x DP) at a tile's end
    st = o; o += (size_t)ROWS * QTS * 2;
    pst = o; o += (size_t)NKP * 128;        // p of one query tile: 2 words per 8 keys per thread
    dka = o; o += (size_t)NKP * D * 4;
    dva = o; o += (size_t)NKP * D * 4;
    kc = o; o += (size_t)NKP * 4;
    red = o; o += 16 * 4;                   // the warps' max|dO|, max|q| and max|k|
    total = o;
  }
};

// RoPE of one (token, pair of lanes d, d + D/2) at position n
__device__ __forceinline__ void rope_pair(float& o0, float& o1, float v0, float v1,
                                          const float* cs, const float* sn, int d, int half) {
  o0 = v0 * cs[d] - v1 * sn[d];
  o1 = v1 * cs[d + half] + v0 * sn[d + half];
}

// its transpose: g * cos + rot^T(g * sin), rot^T(a, b) = (b, -a)
__device__ __forceinline__ void rope_pair_t(float& o0, float& o1, float g0, float g1,
                                            const float* cs, const float* sn, int d, int half) {
  o0 = g0 * cs[d] + g1 * sn[d + half];
  o1 = g1 * cs[d + half] - g0 * sn[d];
}

// the A fragments (16 rows) of a row-major tile of element type E
template <int D, class E>
__device__ __forceinline__ void load_rows(uint32_t (*a)[4], const typename E::T* tile, int row0) {
  constexpr int RS = Dims<D>::RS;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const typename E::T* lo = tile + (row0 + gid) * RS + tig * 2;
  const typename E::T* hi = lo + 8 * RS;
#pragma unroll
  for (int kc = 0; kc < Dims<D>::KC; ++kc) {
    a[kc][0] = ld32h(lo + kc * 16);
    a[kc][1] = ld32h(hi + kc * 16);
    a[kc][2] = ld32h(lo + kc * 16 + 8);
    a[kc][3] = ld32h(hi + kc * 16 + 8);
  }
}

// s (16 x 64) = A (16 x D) . tile^T (product_d of attention_tile.cuh, type E)
template <int D, class E>
__device__ __forceinline__ void product_over_d(float (*s)[4], uint32_t (*a)[4],
                                               const typename E::T* tile) {
  constexpr int RS = Dims<D>::RS;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    const typename E::T* br = tile + (nb * 8 + gid) * RS + tig * 2;
#pragma unroll
    for (int kc = 0; kc < Dims<D>::KC; ++kc)
      E::mma(s[nb], a[kc], ld32h(br + kc * 16), ld32h(br + kc * 16 + 8));
  }
}

// acc (16 x DP) += A (16 x 64, rows of a row-major tile, stride sa) .
// X (64 x DP), X given transposed ([d][row], stride sb); type E
template <int D, class E>
__device__ __forceinline__ void tile_product(float (*acc)[4], const typename E::T* a_tile, int sa,
                                             const typename E::T* x_t, int sb) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const typename E::T* lo = a_tile + gid * sa + tig * 2;
  const typename E::T* hi = lo + 8 * sa;
#pragma unroll
  for (int kc = 0; kc < ROWS / 16; ++kc) {
    const uint32_t a[4] = {ld32h(lo + kc * 16), ld32h(hi + kc * 16), ld32h(lo + kc * 16 + 8),
                           ld32h(hi + kc * 16 + 8)};
#pragma unroll
    for (int db = 0; db < Dims<D>::DB; ++db) {
      const typename E::T* br = x_t + (db * 8 + gid) * sb + kc * 16 + tig * 2;
      E::mma(acc[db], a, ld32h(br), ld32h(br + 8));
    }
  }
}

// acc (16 x DP) += p (16 x 64, accumulator layout, rounded to E) . X (64 x DP),
// X transposed with stride sb (product_rows of attention_tile.cuh, any stride)
template <int D, class E>
__device__ __forceinline__ void rows_product(float (*acc)[4], float (*p)[4],
                                             const typename E::T* x_t, int sb) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < ROWS / 16; ++j) {
    const uint32_t pa[4] = {E::pack(p[2 * j][0], p[2 * j][1]), E::pack(p[2 * j][2], p[2 * j][3]),
                            E::pack(p[2 * j + 1][0], p[2 * j + 1][1]),
                            E::pack(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int db = 0; db < Dims<D>::DB; ++db) {
      const typename E::T* br = x_t + (db * 8 + gid) * sb + j * 16 + tig * 2;
      E::mma(acc[db], pa, ld32h(br), ld32h(br + 8));
    }
  }
}

template <int D>
__device__ __forceinline__ void block(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
    const bf16* __restrict__ bias_k, const bf16* __restrict__ bias_v,
    const float* __restrict__ key_valid, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, bf16* __restrict__ dqkv, float* __restrict__ part,
    int N, int I, int H, int C, int bx, unsigned char* smem) {
  constexpr int DP = Dims<D>::DP, RS = Dims<D>::RS, DB = Dims<D>::DB, HALF = D / 2;
  const Layout<D> lay(N);
  const int NKP = lay.NKP, KTS = lay.KTS, ktiles = NKP / ROWS;
  f16* Ks = reinterpret_cast<f16*>(smem + lay.ks);    // RoPE'd keys [key][d], for S
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.vs);  // values [key][d]
  f16* Kt = reinterpret_cast<f16*>(smem + lay.kt);    // RoPE'd keys [d][key], for dq
  f16* Qs = reinterpret_cast<f16*>(smem + lay.qs);    // the tile's RoPE'd q [query][d], for S
  bf16* Gs = reinterpret_cast<bf16*>(smem + lay.gs);  // its dO [query][d]
  f16* Qt = reinterpret_cast<f16*>(smem + lay.qt);    // q [d][query], for dk
  bf16* Gt = reinterpret_cast<bf16*>(smem + lay.gt);  // dO [d][query]
  bf16* Pt = reinterpret_cast<bf16*>(smem + lay.pt);  // pn^T [key][query]
  f16* St = reinterpret_cast<f16*>(smem + lay.st);    // scaled ds^T [key][query]
  float* dQf = reinterpret_cast<float*>(smem + lay.pt);
  uint32_t* Pst = reinterpret_cast<uint32_t*>(smem + lay.pst);
  float* dKa = reinterpret_cast<float*>(smem + lay.dka);
  float* dVa = reinterpret_cast<float*>(smem + lay.dva);
  float* Kc = reinterpret_cast<float*>(smem + lay.kc);
  float* Red = reinterpret_cast<float*>(smem + lay.red);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const long long seq = bx / H;
  const int h = (int)(bx % H);
  const long long row0 = (seq / I) * (long long)N * I + seq % I;  // token n: row0 + n * I
  const bf16 zero = __float2bfloat16(0.f);
  const f16 hzero = __float2half_rn(0.f);

  // ---- the head's keys (RoPE'd; the bias key at N) and values, once ----
  // (times 2^sk: staged again in the first query tile if max|k| needs it)
  auto stage_key = [&](int n, int d, int sk) {
    float o0 = 0.f, o1 = 0.f;
    if (n <= N) {
      const bf16* src = n < N ? qkv + (row0 + (long long)n * I) * 3LL * C + C + h * D
                              : bias_k + h * D;
      rope_pair(o0, o1, __bfloat162float(src[d]), __bfloat162float(src[d + HALF]),
                cos_t + (long long)n * D, sin_t + (long long)n * D, d, HALF);
    }
    const float m = fmaxf(fabsf(o0), fabsf(o1));
    if (sk != 0) {
      o0 = ldexpf(o0, sk);
      o1 = ldexpf(o1, sk);
    }
    const f16 h0 = __float2half_rn(o0), h1 = __float2half_rn(o1);
    Ks[n * RS + d] = h0;
    Ks[n * RS + d + HALF] = h1;
    Kt[d * KTS + n] = h0;
    Kt[(d + HALF) * KTS + n] = h1;
    return m;
  };
  float kmax = 0.f;
  for (int e = tid; e < NKP * HALF; e += THREADS) {
    const int n = e / HALF, d = e % HALF;
    float v0 = 0.f, v1 = 0.f;
    if (n < N) {
      const bf16* src = qkv + (row0 + (long long)n * I) * 3LL * C + h * D;
      v0 = __bfloat162float(src[2 * C + d]);
      v1 = __bfloat162float(src[2 * C + d + HALF]);
    } else if (n == N) {
      v0 = __bfloat162float(bias_v[h * D + d]);
      v1 = __bfloat162float(bias_v[h * D + d + HALF]);
    }
    kmax = fmaxf(kmax, stage_key(n, d, 0));
    Vs[n * RS + d] = __float2bfloat16(v0);
    Vs[n * RS + d + HALF] = __float2bfloat16(v1);
  }
  kmax = warp_max(kmax);
  if (lane == 0) Red[8 + warp] = kmax;  // read after the first query tile's barrier
  if constexpr (DP > D) {  // pad lanes meet only zeros in the products
    constexpr int P = DP - D;
    for (int e = tid; e < NKP * P; e += THREADS) {
      const int n = e / P, d = D + e % P;
      Ks[n * RS + d] = hzero;
      Vs[n * RS + d] = zero;
      Kt[d * KTS + n] = hzero;
    }
    for (int e = tid; e < ROWS * P; e += THREADS) {
      const int r = e / P, d = D + e % P;
      Qs[r * RS + d] = hzero;
      Gs[r * RS + d] = zero;
      Qt[d * QTS + r] = hzero;
      Gt[d * QTS + r] = zero;
    }
  }
  for (int n = tid; n < NKP; n += THREADS)
    Kc[n] = n < N ? (key_valid[row0 + (long long)n * I] > 0.f ? 1.f : 0.f) : (n == N ? 1.f : -1.f);
  for (int e = tid; e < NKP * D; e += THREADS) dKa[e] = dVa[e] = 0.f;

  const int qtiles = (N + ROWS - 1) / ROWS;
  int sk = 0;  // the keys' scale exponent (set in the first query tile)
  for (int qtile = 0; qtile < qtiles; ++qtile) {
    const int q0 = qtile * ROWS;
    // ---- the query tile: RoPE'd q and dO, row-major and transposed ----
    // (q times 2^sq: staged again if max|q| of the tile needs it)
    auto stage_query = [&](int r, int d, int sq) {
      const int n = q0 + r;
      float o0 = 0.f, o1 = 0.f;
      if (n < N) {
        const bf16* src = qkv + (row0 + (long long)n * I) * 3LL * C + h * D;
        rope_pair(o0, o1, __bfloat162float(src[d]), __bfloat162float(src[d + HALF]),
                  cos_t + (long long)n * D, sin_t + (long long)n * D, d, HALF);
      }
      const float m = fmaxf(fabsf(o0), fabsf(o1));
      if (sq != 0) {
        o0 = ldexpf(o0, sq);
        o1 = ldexpf(o1, sq);
      }
      const f16 h0 = __float2half_rn(o0), h1 = __float2half_rn(o1);
      Qs[r * RS + d] = h0;
      Qs[r * RS + d + HALF] = h1;
      Qt[d * QTS + r] = h0;
      Qt[(d + HALF) * QTS + r] = h1;
      return m;
    };
    float gmax = 0.f, qmax = 0.f;
    for (int e = tid; e < ROWS * HALF; e += THREADS) {
      const int r = e / HALF, d = e % HALF, n = q0 + r;
      float g0 = 0.f, g1 = 0.f;
      if (n < N) {
        const bf16* go = dout + (row0 + (long long)n * I) * C + h * D;
        g0 = __bfloat162float(go[d]);
        g1 = __bfloat162float(go[d + HALF]);
        gmax = fmaxf(gmax, fmaxf(fabsf(g0), fabsf(g1)));
      }
      qmax = fmaxf(qmax, stage_query(r, d, 0));
      const bf16 c0 = __float2bfloat16(g0), c1 = __float2bfloat16(g1);
      Gs[r * RS + d] = c0;
      Gs[r * RS + d + HALF] = c1;
      Gt[d * QTS + r] = c0;
      Gt[(d + HALF) * QTS + r] = c1;
    }
    gmax = warp_max(gmax);
    qmax = warp_max(qmax);
    if (lane == 0) {
      Red[warp] = gmax;
      Red[4 + warp] = qmax;
    }
    __syncthreads();
    // ds of this tile goes to fp16 as ds / max|dO|, its dq and dk partials
    // come back times max|dO|
    const float gm = max4(Red);
    const float to_f16 = gm > 0.f ? 1.f / gm : 1.f, from_f16 = gm > 0.f ? gm : 1.f;
    // q and k outside fp16's comfortable range: staged again, scaled (the
    // maxima are the block's, so the branches are uniform)
    const int sq = scale_exponent(max4(Red + 4));
    if (qtile == 0) sk = scale_exponent(max4(Red + 8));
    if (sq != 0)
      for (int e = tid; e < ROWS * HALF; e += THREADS) stage_query(e / HALF, e % HALF, sq);
    if (qtile == 0 && sk != 0)
      for (int e = tid; e < (N + 1) * HALF; e += THREADS) stage_key(e / HALF, e % HALF, sk);
    if (sq != 0 || (qtile == 0 && sk != 0)) __syncthreads();
    const float lscale = ldexpf(1.f, -(sq + sk));  // the logits' scale
    const float dk_back = ldexpf(from_f16, -sq), dq_back = ldexpf(from_f16, -sk);

    uint32_t qa[Dims<D>::KC][4], ga[Dims<D>::KC][4];
    load_rows<D, F16>(qa, Qs, warp * 16);
    load_rows<D, BF16>(ga, Gs, warp * 16);
    const bool live[2] = {q0 + warp * 16 + gid < N, q0 + warp * 16 + gid + 8 < N};

    // ---- pass 1: p once, den and sum(p * dp) over all keys ----
    float den[2] = {0.f, 0.f}, sdp[2] = {0.f, 0.f};
    for (int kt = 0; kt < ktiles; ++kt) {
      float s[NB][4], dp[NB][4];
      product_over_d<D, F16>(s, qa, Ks + kt * ROWS * RS);
      product_over_d<D, BF16>(dp, ga, Vs + kt * ROWS * RS);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float cls = Kc[kt * ROWS + nb * 8 + tig * 2 + (e & 1)];
          p[e] = exp2f(fminf(logit2(s[nb][e], cls, lscale), 100.f));
          den[e >> 1] += p[e];
          sdp[e >> 1] += p[e] * dp[nb][e];
        }
        uint32_t* dst = Pst + ((kt * NB + nb) * 2) * THREADS + tid;
        dst[0] = pack2(p[0], p[1]);
        dst[THREADS] = pack2(p[2], p[3]);
      }
    }
    float inv[2], delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the four threads of a row group hold disjoint keys
      den[i] += __shfl_xor_sync(0xffffffffu, den[i], 1);
      den[i] += __shfl_xor_sync(0xffffffffu, den[i], 2);
      sdp[i] += __shfl_xor_sync(0xffffffffu, sdp[i], 1);
      sdp[i] += __shfl_xor_sync(0xffffffffu, sdp[i], 2);
      inv[i] = live[i] ? 1.f / (den[i] + 1e-30f) : 0.f;  // rows past N take no part
      delta[i] = sdp[i] * inv[i];
    }

    // ---- pass 2: pn, ds; dq in registers, dk and dv through the key warps ----
    float dq[DB][4];
#pragma unroll
    for (int db = 0; db < DB; ++db) dq[db][0] = dq[db][1] = dq[db][2] = dq[db][3] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
      float pn[NB][4], ds[NB][4];
      product_over_d<D, BF16>(ds, ga, Vs + kt * ROWS * RS);  // dp
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint32_t* src = Pst + ((kt * NB + nb) * 2) * THREADS + tid;
        const uint32_t w[2] = {src[0], src[THREADS]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&w[e >> 1]);
          const float p = __bfloat162float((e & 1) ? pair.y : pair.x);
          pn[nb][e] = p * inv[e >> 1];
          ds[nb][e] = LN2 * pn[nb][e] * (ds[nb][e] - delta[e >> 1]) * to_f16;
          const int c = nb * 8 + tig * 2 + (e & 1), r = warp * 16 + gid + 8 * (e >> 1);
          Pt[c * QTS + r] = __float2bfloat16(pn[nb][e]);
          St[c * QTS + r] = __float2half_rn(ds[nb][e]);
        }
      }
      rows_product<D, F16>(dq, ds, Kt + kt * ROWS, KTS);  // dq += ds . k (scaled)
      __syncthreads();
      // this warp's 16 keys of the tile: dv += pn^T . dO, dk += ds^T . q
      float dv[DB][4], dk[DB][4];
#pragma unroll
      for (int db = 0; db < DB; ++db)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv[db][e] = dk[db][e] = 0.f;
      tile_product<D, BF16>(dv, Pt + warp * 16 * QTS, QTS, Gt, QTS);
      tile_product<D, F16>(dk, St + warp * 16 * QTS, QTS, Qt, QTS);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = kt * ROWS + warp * 16 + gid + 8 * i;
#pragma unroll
        for (int db = 0; db < DB; ++db)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int d = db * 8 + tig * 2 + j;
            if (d < D) {
              dVa[key * D + d] += dv[db][2 * i + j];
              dKa[key * D + d] += dk[db][2 * i + j] * dk_back;
            }
          }
      }
      __syncthreads();
    }

    // ---- dq of the tile: RoPE transpose, bf16 into dqkv ----
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int db = 0; db < DB; ++db)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          dQf[(warp * 16 + gid + 8 * i) * DP + db * 8 + tig * 2 + j] = dq[db][2 * i + j] * dq_back;
    __syncthreads();
    for (int e = tid; e < ROWS * HALF; e += THREADS) {
      const int r = e / HALF, d = e % HALF, n = q0 + r;
      if (n >= N) continue;
      float o0, o1;
      rope_pair_t(o0, o1, dQf[r * DP + d], dQf[r * DP + d + HALF], cos_t + (long long)n * D,
                  sin_t + (long long)n * D, d, HALF);
      bf16* dst = dqkv + (row0 + (long long)n * I) * 3LL * C + h * D;
      dst[d] = __float2bfloat16(o0);
      dst[d + HALF] = __float2bfloat16(o1);
    }
    __syncthreads();
  }

  // ---- dk (RoPE transpose) and dv into dqkv; the bias key's into part ----
  for (int e = tid; e < (N + 1) * HALF; e += THREADS) {
    const int n = e / HALF, d = e % HALF;
    float o0, o1;
    rope_pair_t(o0, o1, dKa[n * D + d], dKa[n * D + d + HALF], cos_t + (long long)n * D,
                sin_t + (long long)n * D, d, HALF);
    if (n < N) {
      bf16* dst = dqkv + (row0 + (long long)n * I) * 3LL * C + h * D;
      dst[C + d] = __float2bfloat16(o0);
      dst[C + d + HALF] = __float2bfloat16(o1);
      dst[2 * C + d] = __float2bfloat16(dVa[n * D + d]);
      dst[2 * C + d + HALF] = __float2bfloat16(dVa[n * D + d + HALF]);
    } else {
      float* pb = part + seq * 2LL * C + h * D;
      pb[d] = o0;
      pb[d + HALF] = o1;
      pb[C + d] = dVa[n * D + d];
      pb[C + d + HALF] = dVa[n * D + d + HALF];
    }
  }
}

}  // namespace blockedbwd
