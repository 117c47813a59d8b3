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

typedef __nv_bfloat16 bf16;
typedef __half f16;
using attn_tile::mma16816;
using attn_tile::pack2;
using rope_tile::ldsm_x2;
using rope_tile::ldsm_x2_t;
using rope_tile::ldsm_x4;
using rope_tile::ldsm_x4_t;
using rope_tile::load_row;
using rope_tile::load_row_scalar;
using rope_tile::max4;
using rope_tile::mma16816_f16;
using rope_tile::pack_h2;
using rope_tile::rope;
using rope_tile::rope_t;
using rope_tile::row_max;
using rope_tile::scale_exponent;  // the fp16 range rule, shared with rope_attention_bwd
using rope_tile::store_global;
using rope_tile::unpack_bf2;
using rope_tile::warp_max;

constexpr int THREADS = 128;
constexpr float LN2F = 0.6931471805599453f;

// the head dim's staging geometry: rows of RS 2-byte elements, an odd
// number of 16-byte units (conflict-free ldmatrix) and no pad to 16 lanes:
// a product over d takes D / 16 chunks of 16 and, at D = 24, one of 8
template <int D>
struct Geo {
  static constexpr int RS = (D / 8) % 2 ? D : D + 8;
  static constexpr int K16 = D / 16, TAIL = D % 16, OB = D / 8;
  static constexpr int SS = D + 1;  // f32 stride of a warp's output tile
  // a warp's own area: its 16 keys and values in phase B, then its f32 output tile
  static constexpr int WA = (16 * RS * 2 * 2 > 16 * SS * 4 ? 16 * RS * 2 * 2 : 16 * SS * 4);
};

// byte offsets of the block's shared memory at N tokens: q (fp16, RoPE'd,
// times 2^sq) and dO (bf16) of the NQP queries (N rounded up to 16); k
// (fp16, RoPE'd, times 2^sk) and v (bf16) of the NKP keys (N + 1 rounded up
// to 16), whose region holds dq (f32, NQP x RS) once the statistics pass is
// done; the key biases; 1 / sum p and delta per query; max|dO| per 16-query
// tile; the warps' maxima; the warps' own areas
template <int D>
struct Layout {
  int NQP, NKP;
  size_t qs, gs, kv, kb, inv, rs, gm, red, wa, total;
  __host__ __device__ explicit Layout(int N) {
    constexpr int RS = Geo<D>::RS;
    NQP = (N + 15) / 16 * 16;
    NKP = (N + 1 + 15) / 16 * 16;
    size_t o = 0;
    qs = o; o += (size_t)NQP * RS * 2;
    gs = o; o += (size_t)NQP * RS * 2;
    kv = o; o += (size_t)NKP * RS * 2 * 2;
    kb = o; o += (size_t)NKP * 4;
    inv = o; o += (size_t)NQP * 4;
    rs = o; o += (size_t)NQP * 4;
    gm = o; o += ((size_t)NQP / 16 * 4 + 15) / 16 * 16;
    red = o; o += 16 * 4;
    wa = o; o += (size_t)(THREADS / 32) * Geo<D>::WA;
    total = o;
  }
};

// c += a (16x8, row) * b (8x8, col): the 8-deep tail of a product over d
__device__ __forceinline__ void mma1688_f16(float* c, const uint32_t* a, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}
__device__ __forceinline__ void mma1688_bf16(float* c, const uint32_t* a, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// the transpose of an 8x8 b16 fragment across the warp
__device__ __forceinline__ uint32_t movt(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// the A fragments of 16 staged rows from row0 over d: K16 chunks of 16
// (x4) and the tail of 8 (x2)
template <int D>
struct AFrag {
  uint32_t a[Geo<D>::K16 > 0 ? Geo<D>::K16 : 1][4];
  uint32_t t[2];
  __device__ __forceinline__ void load(const void* tile, int row0) {
    constexpr int RS = Geo<D>::RS;
    const int lane = threadIdx.x & 31;
    const uint16_t* p = static_cast<const uint16_t*>(tile) + (row0 + (lane & 15)) * RS;
#pragma unroll
    for (int kc = 0; kc < Geo<D>::K16; ++kc) ldsm_x4(a[kc], p + kc * 16 + (lane >> 4) * 8);
    if constexpr (Geo<D>::TAIL) ldsm_x2(t, p + Geo<D>::K16 * 16);
  }
};

// c (16 x 8) = A (16 x D) . rows r0 .. r0 + 7 of a staged tile (their d
// lanes the reduction): fp16 or bf16
template <int D, bool F16>
__device__ __forceinline__ void product_d(float* c, const AFrag<D>& a, const void* tile, int r0) {
  constexpr int RS = Geo<D>::RS, OB = Geo<D>::OB;
  const int lane = threadIdx.x & 31;
  uint32_t b[OB];
#pragma unroll
  for (int m0 = 0; m0 < OB; m0 += 4) {
    const int m = m0 + min(lane >> 3, OB - 1 - m0);  // lanes past the end repeat the last
    uint32_t r[4];
    ldsm_x4(r, static_cast<const uint16_t*>(tile) + (r0 + (lane & 7)) * RS + m * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (m0 + i < OB) b[m0 + i] = r[i];
  }
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < Geo<D>::K16; ++kc) {
    if (F16) mma16816_f16(c, a.a[kc], b[2 * kc], b[2 * kc + 1]);
    else mma16816(c, a.a[kc], b[2 * kc], b[2 * kc + 1]);
  }
  if constexpr (Geo<D>::TAIL) {
    if (F16) mma1688_f16(c, a.t, b[OB - 1]);
    else mma1688_bf16(c, a.t, b[OB - 1]);
  }
}

// the B fragments of a product over rows: rows r0 .. r0 + 15 of a staged
// tile are the 16-deep chunk, its D lanes the OB 8-lane output blocks
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (*b)[2], const void* tile, int r0) {
  constexpr int RS = Geo<D>::RS, OB = Geo<D>::OB;
  const int lane = threadIdx.x & 31;
  const uint16_t* p = static_cast<const uint16_t*>(tile) + (r0 + (lane & 15)) * RS + (lane >> 4) * 8;
#pragma unroll
  for (int db = 0; db + 1 < OB; db += 2) {
    uint32_t r[4];
    ldsm_x4_t(r, p + db * 8);
    b[db][0] = r[0];
    b[db][1] = r[1];
    b[db + 1][0] = r[2];
    b[db + 1][1] = r[3];
  }
  if constexpr (OB % 2) {
    uint32_t r[2];
    ldsm_x2_t(r, static_cast<const uint16_t*>(tile) + (r0 + (lane & 15)) * RS + (OB - 1) * 8);
    b[OB - 1][0] = r[0];
    b[OB - 1][1] = r[1];
  }
}

// one staged row of D lanes (16-byte aligned): x times `mul` (a power of
// two) in fp16 (F16) or x in bf16
template <int D, bool F16>
__device__ __forceinline__ void store_row(void* dst, const float* x, float mul = 1.f) {
#pragma unroll
  for (int v = 0; v < D / 8; ++v) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lo = x[8 * v + 2 * e], hi = x[8 * v + 2 * e + 1];
      w[e] = F16 ? pack_h2(lo * mul, hi * mul) : pack2(lo, hi);
    }
    static_cast<uint4*>(dst)[v] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float (*acc)[4]) {
#pragma unroll
  for (int db = 0; db < Geo<D>::OB; ++db) acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;
}

template <int D>
__device__ __forceinline__ void block(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
    const bf16* __restrict__ bias_k, const bf16* __restrict__ bias_v,
    const float* __restrict__ key_valid, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, bf16* __restrict__ dqkv, float* __restrict__ part,
    int N, int I, int H, int C, int bx, unsigned char* smem) {
  constexpr int RS = Geo<D>::RS, OB = Geo<D>::OB, SS = Geo<D>::SS, NW = THREADS / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const Layout<D> lay(N);
  f16* Qs = reinterpret_cast<f16*>(smem + lay.qs);
  bf16* Gs = reinterpret_cast<bf16*>(smem + lay.gs);
  f16* Ks = reinterpret_cast<f16*>(smem + lay.kv);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.kv + (size_t)lay.NKP * RS * 2);
  float* dQ = reinterpret_cast<float*>(smem + lay.kv);  // after the statistics pass
  float* Kb = reinterpret_cast<float*>(smem + lay.kb);
  float* Inv = reinterpret_cast<float*>(smem + lay.inv);
  float* Rs = reinterpret_cast<float*>(smem + lay.rs);
  float* Gm = reinterpret_cast<float*>(smem + lay.gm);
  float* Red = reinterpret_cast<float*>(smem + lay.red);
  unsigned char* Wa = smem + lay.wa + (size_t)warp * Geo<D>::WA;
  f16* Kw = reinterpret_cast<f16*>(Wa);                 // phase B: the warp's 16 keys
  bf16* Vw = reinterpret_cast<bf16*>(Wa + 16 * RS * 2);  // and values
  float* Sc = reinterpret_cast<float*>(Wa);             // then its output tile
  const int NQP = lay.NQP, NKP = lay.NKP, nqt = NQP / 16, nkb = NKP / 16;
  const int h = bx % H;
  const long long seq = bx / H;
  const long long row0 = (seq / I) * (long long)N * I + seq % I;  // token n: row0 + n * I
  auto tok = [&](int n) { return row0 + (long long)n * I; };

  // ---- stage: query rows (q RoPE'd, dO; max|dO| per 16-row tile) and key
  // rows (k RoPE'd, the bias key at N, v, the mask bias); pad rows zero ----
  auto q_row = [&](int n, float* q) {
    if (n < N) {
      load_row<D>(q, qkv + tok(n) * 3LL * C + h * D);
      rope<D>(q, cos_t + (long long)n * D, sin_t + (long long)n * D);
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) q[d] = 0.f;
    }
  };
  auto k_row = [&](int n, float* k, float* v) {
    float b = -1e9f;
    if (n <= N) {
      if (n < N) {
        const bf16* src = qkv + tok(n) * 3LL * C + h * D;
        load_row<D>(k, src + C);
        load_row<D>(v, src + 2 * C);
        b = key_valid[tok(n)] > 0.f ? 0.f : -1e9f;
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
  float qmax = 0.f, kmax = 0.f;
  for (int base = 0; base < NQP; base += THREADS) {  // lanes 16j .. 16j + 15: one query tile
    const int t = base + tid;
    float tm = 0.f;
    if (t < NQP) {
      float x[D], y[D];
      q_row(t, x);
      if (t < N) {
        load_row<D>(y, dout + tok(t) * C + h * D);
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) y[d] = 0.f;
      }
      qmax = fmaxf(qmax, row_max<D>(x));
      tm = row_max<D>(y);
      store_row<D, true>(Qs + t * RS, x);
      store_row<D, false>(Gs + t * RS, y);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, off));
    if (t < NQP && (lane & 15) == 0) Gm[t / 16] = tm;
  }
  for (int n = tid; n < NKP; n += THREADS) {
    float x[D], y[D];
    Kb[n] = k_row(n, x, y);
    kmax = fmaxf(kmax, row_max<D>(x));
    store_row<D, true>(Ks + n * RS, x);
    store_row<D, false>(Vs + n * RS, y);
  }
  qmax = warp_max(qmax);
  kmax = warp_max(kmax);
  if (lane == 0) {
    Red[warp] = qmax;
    Red[4 + warp] = kmax;
  }
  __syncthreads();
  // q and k outside fp16's comfortable range: staged again, scaled by
  // powers of two (the maxima are the block's, so the branches are uniform)
  const int sq = scale_exponent(max4(Red)), sk = scale_exponent(max4(Red + 4));
  const float kmul = ldexpf(1.f, sk);
  if (sq != 0) {
    const float mul = ldexpf(1.f, sq);
    for (int n = tid; n < N; n += THREADS) {
      float x[D];
      q_row(n, x);
      store_row<D, true>(Qs + n * RS, x, mul);
    }
  }
  if (sk != 0) {
    for (int n = tid; n <= N; n += THREADS) {
      float x[D], y[D];
      k_row(n, x, y);
      store_row<D, true>(Ks + n * RS, x, kmul);
    }
  }
  if (sq != 0 || sk != 0) __syncthreads();
  const float lscale = ldexpf(1.f, -(sq + sk));  // the logits' scale

  // ---- pass 1 (16-query tiles over the warps): the row statistics
  // 1 / sum p and delta = sum p dP / sum p over all keys ----
  for (int qt = warp; qt < nqt; qt += NW) {
    const int q0 = qt * 16;
    AFrag<D> qa, ga;
    qa.load(Qs, q0);
    ga.load(Gs, q0);
    float den0 = 0.f, den1 = 0.f, sdp0 = 0.f, sdp1 = 0.f;
    for (int nb = 0; nb < NKP / 8; ++nb) {
      float s[4], dp[4];
      product_d<D, true>(s, qa, Ks, nb * 8);
      product_d<D, false>(dp, ga, Vs, nb * 8);
      const float2 kb = *reinterpret_cast<const float2*>(Kb + nb * 8 + tig * 2);
      const float p0 = exp2f(fminf(fmaf(s[0], lscale, kb.x), 100.f));
      const float p1 = exp2f(fminf(fmaf(s[1], lscale, kb.y), 100.f));
      const float p2 = exp2f(fminf(fmaf(s[2], lscale, kb.x), 100.f));
      const float p3 = exp2f(fminf(fmaf(s[3], lscale, kb.y), 100.f));
      den0 += p0 + p1;
      den1 += p2 + p3;
      sdp0 += p0 * dp[0] + p1 * dp[1];
      sdp1 += p2 * dp[2] + p3 * dp[3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the four threads of a row hold disjoint keys
      den0 += __shfl_xor_sync(0xffffffffu, den0, off);
      den1 += __shfl_xor_sync(0xffffffffu, den1, off);
      sdp0 += __shfl_xor_sync(0xffffffffu, sdp0, off);
      sdp1 += __shfl_xor_sync(0xffffffffu, sdp1, off);
    }
    if (tig == 0) {
      const float i0 = q0 + gid < N ? 1.f / (den0 + 1e-30f) : 0.f;  // rows past N take no part
      const float i1 = q0 + gid + 8 < N ? 1.f / (den1 + 1e-30f) : 0.f;
      Inv[q0 + gid] = i0;
      Inv[q0 + gid + 8] = i1;
      Rs[q0 + gid] = sdp0 * i0;
      Rs[q0 + gid + 8] = sdp1 * i1;
    }
  }
  __syncthreads();  // the keys' region now takes dq
  for (int e = tid; e < NQP * RS; e += THREADS) dQ[e] = 0.f;
  __syncthreads();

  // ---- pass 2: rounds of 4 key tiles, one per warp (dk, dv in registers;
  // a last round of fewer tiles splits each tile's query tiles among the
  // warps and adds their dk, dv in a fixed order); per query tile: S^T =
  // K Q^T and dP^T = V dO^T, pn^T in bf16 and ds^T in fp16 (times
  // ln2 / max|dO| of the query tile), then dv += pn^T dO, dk += ds^T Q and
  // the tile's dq += ds K (ds^T transposed in registers), added into dQ.
  // The warps of a step touch distinct query tiles and meet after it, so
  // every dq sum runs in one fixed order ----
  const float dq_unscale = ldexpf(1.f, -sk), dk_unscale = ldexpf(1.f, -sq);
  // a 16 x D accumulator tile into a warp's area (rows of SS floats)
  auto to_sc = [&](float* sc, float (*acc)[4]) {
#pragma unroll
    for (int db = 0; db < OB; ++db) {
      const int d = db * 8 + tig * 2;
      sc[gid * SS + d] = acc[db][0];
      sc[gid * SS + d + 1] = acc[db][1];
      sc[(gid + 8) * SS + d] = acc[db][2];
      sc[(gid + 8) * SS + d + 1] = acc[db][3];
    }
  };
  for (int r0 = 0; r0 < nkb; r0 += NW) {
    // R key tiles this round; G warps on each (the last round of a head
    // whose key tiles are not a multiple of 4), warp w = g G + sub taking
    // the query tiles j = sub mod G: in step t, j = ((t + g) G + sub) mod
    // nq, distinct over the warps of a step and covering every tile
    const int R = min(NW, nkb - r0), G = NW / R, g = warp / G, sub = warp % G;
    const int nq = G == 1 ? max(nqt, NW) : (nqt + NW - 1) / NW * NW;
    const int kt = r0 + g, k0 = kt * 16;
    const bool mine = g < R;
    AFrag<D> ka, va;
    uint32_t kbq[OB][2];
    float kb0 = 0.f, kb1 = 0.f, dk[OB][4], dv[OB][4];
    zero_acc<D>(dk);
    zero_acc<D>(dv);
    if (mine) {
      if (lane < 16) {  // the warp's keys, staged as pass 1 staged them
        float x[D], y[D];
        k_row(k0 + lane, x, y);
        store_row<D, true>(Kw + lane * RS, x, kmul);
        store_row<D, false>(Vw + lane * RS, y);
      }
      __syncwarp();
      ka.load(Kw, 0);
      va.load(Vw, 0);
      load_b_rows<D>(kbq, Kw, 0);
      kb0 = Kb[k0 + gid];
      kb1 = Kb[k0 + gid + 8];
    }
    for (int t = 0; t < nq / G; ++t) {
      const int j = ((t + g) * G + sub) % nq;
      if (mine && j < nqt) {
        const int q0 = j * 16;
        const float gmj = Gm[j];
        const float to_f16 = gmj > 0.f ? LN2F / gmj : LN2F, from_f16 = gmj > 0.f ? gmj : 1.f;
        uint32_t pa[4], da[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c0 = q0 + half * 8;  // this 8-query block
          float st[4], dpt[4];
          product_d<D, true>(st, ka, Qs, c0);
          product_d<D, false>(dpt, va, Gs, c0);
          const float2 iv = *reinterpret_cast<const float2*>(Inv + c0 + tig * 2);
          const float2 rs = *reinterpret_cast<const float2*>(Rs + c0 + tig * 2);
          const uint32_t lo = pack2(exp2f(fminf(fmaf(st[0], lscale, kb0), 100.f)) * iv.x,
                                    exp2f(fminf(fmaf(st[1], lscale, kb0), 100.f)) * iv.y);
          const uint32_t hi = pack2(exp2f(fminf(fmaf(st[2], lscale, kb1), 100.f)) * iv.x,
                                    exp2f(fminf(fmaf(st[3], lscale, kb1), 100.f)) * iv.y);
          pa[2 * half] = lo;
          pa[2 * half + 1] = hi;
          const float2 a = unpack_bf2(lo), b = unpack_bf2(hi);
          da[2 * half] = pack_h2(a.x * (dpt[0] - rs.x) * to_f16, a.y * (dpt[1] - rs.y) * to_f16);
          da[2 * half + 1] = pack_h2(b.x * (dpt[2] - rs.x) * to_f16, b.y * (dpt[3] - rs.y) * to_f16);
        }
        uint32_t b[OB][2];
        load_b_rows<D>(b, Gs, q0);
#pragma unroll
        for (int db = 0; db < OB; ++db) mma16816(dv[db], pa, b[db][0], b[db][1]);
        float dks[OB][4];
        zero_acc<D>(dks);
        load_b_rows<D>(b, Qs, q0);
#pragma unroll
        for (int db = 0; db < OB; ++db) mma16816_f16(dks[db], da, b[db][0], b[db][1]);
        const float kback = from_f16 * dk_unscale;
#pragma unroll
        for (int db = 0; db < OB; ++db)
#pragma unroll
          for (int e = 0; e < 4; ++e) dk[db][e] = fmaf(dks[db][e], kback, dk[db][e]);
        // dq of the query tile from these 16 keys: ds (queries x keys) . K
        const uint32_t dsa[4] = {movt(da[0]), movt(da[2]), movt(da[1]), movt(da[3])};
        float dqs[OB][4];
        zero_acc<D>(dqs);
#pragma unroll
        for (int db = 0; db < OB; ++db) mma16816_f16(dqs[db], dsa, kbq[db][0], kbq[db][1]);
        const float qback = from_f16 * dq_unscale;
#pragma unroll
        for (int db = 0; db < OB; ++db)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float2* p = reinterpret_cast<float2*>(dQ + (q0 + gid + 8 * i) * RS + db * 8 + tig * 2);
            float2 v = *p;
            v.x = fmaf(dqs[db][2 * i], qback, v.x);
            v.y = fmaf(dqs[db][2 * i + 1], qback, v.y);
            *p = v;
          }
      }
      __syncthreads();
    }
    // the group's dk and dv: warp sub 0 adds the others' in order
    auto gather = [&](float (*acc)[4]) {
      if (mine && sub > 0) to_sc(Sc, acc);
      __syncthreads();
      if (mine && sub == 0)
        for (int o = 1; o < G; ++o) {
          const float* sc = reinterpret_cast<const float*>(
              smem + lay.wa + (size_t)(warp + o) * Geo<D>::WA);
#pragma unroll
          for (int db = 0; db < OB; ++db) {
            const int d = db * 8 + tig * 2;
            acc[db][0] += sc[gid * SS + d];
            acc[db][1] += sc[gid * SS + d + 1];
            acc[db][2] += sc[(gid + 8) * SS + d];
            acc[db][3] += sc[(gid + 8) * SS + d + 1];
          }
        }
      __syncthreads();
    };
    if (G > 1) {
      gather(dk);
      gather(dv);
    }
    if (mine && sub == 0) {  // dk (RoPE transpose) and dv of the keys; the bias key's into part
      float* pb = part + seq * 2LL * C + h * D;
      auto write_tile = [&](float (*acc)[4], int col, bool roped, float* bias_part) {
        __syncwarp();
        to_sc(Sc, acc);
        __syncwarp();
        if (lane < 16) {
          const int n = k0 + lane;
          if (n <= N) {
            float g[D];
#pragma unroll
            for (int d = 0; d < D; ++d) g[d] = Sc[lane * SS + d];
            if (roped) rope_t<D>(g, cos_t + (long long)n * D, sin_t + (long long)n * D);
            if (n < N) {
              store_global<D>(dqkv + tok(n) * 3LL * C + col + h * D, g);
            } else {
#pragma unroll
              for (int d = 0; d < D; ++d) bias_part[d] = g[d];
            }
          }
        }
      };
      write_tile(dk, C, true, pb);
      write_tile(dv, 2 * C, false, pb + C);
      __syncwarp();
    }
  }

  // ---- dq: RoPE transpose, bf16 into dqkv ----
  for (int n = tid; n < N; n += THREADS) {
    float g[D];
#pragma unroll
    for (int d = 0; d < D; ++d) g[d] = dQ[n * RS + d];
    rope_t<D>(g, cos_t + (long long)n * D, sin_t + (long long)n * D);
    store_global<D>(dqkv + tok(n) * 3LL * C + h * D, g);
  }
}

}  // namespace blockedbwd
