// rope_attention_bwd.cuh: the block body of rope_attention_bwd.cu (the
// design note is there) as a device function over a block index and a
// shared-memory buffer, so that rope_attention_bwd.cu and the merged layer
// backward (fused_layer_bwd.cu) run the same code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rope_attention.cuh"
#include "rope_tile.cuh"

namespace ropebwd {

typedef __nv_bfloat16 bf16;


constexpr int THREADS = 128;
constexpr float LN2F = 0.6931471805599453f;
constexpr int MAX_N = 128;  // ops/rope_attention_bwd.MAX_N: the long body holds a row of p in registers
constexpr int MAX_KB = (MAX_N + 1 + 15) / 16;  // its 16-key blocks

// the transpose of ropefwd::rope_row: g * cos + rot^T(g * sin), rot^T(a, b) = (b, -a),
// each lane as fma(g, cos, +-g' sin) written out, so that no context of
// the body contracts it another way (the first version's arithmetic)
template <int D>
__device__ __forceinline__ void rope_row_t(float* g, const float* cos_row, const float* sin_row) {
  float cs[D], sn[D], t[D];
#pragma unroll
  for (int d = 0; d < D / 4; ++d) {  // the tables' row as float4s
    const float4 c = __ldg(reinterpret_cast<const float4*>(cos_row) + d);
    const float4 s = __ldg(reinterpret_cast<const float4*>(sin_row) + d);
    cs[4 * d] = c.x; cs[4 * d + 1] = c.y; cs[4 * d + 2] = c.z; cs[4 * d + 3] = c.w;
    sn[4 * d] = s.x; sn[4 * d + 1] = s.y; sn[4 * d + 2] = s.z; sn[4 * d + 3] = s.w;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int e = d < D / 2 ? d + D / 2 : d - D / 2;
    t[d] = __fmaf_rn(g[d], cs[d], __fmul_rn(d < D / 2 ? g[e] : -g[e], sn[e]));
  }
#pragma unroll
  for (int d = 0; d < D; ++d) g[d] = t[d];
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
}

// ---- short sequences (N <= 16): the streaming body; the design note is
// in rope_attention_bwd.cu ----

constexpr int SHORT_THREADS = 128;  // ops/rope_attention_bwd.py SHORT_THREADS
constexpr int SHORT_KEYS = 17;      // the most keys: N <= 16, + the bias key

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// one unit's shared memory (bytes; ops/rope_attention_bwd.py::short_bytes
// mirrors it): nbuf raw buffers, each the bf16 q|k|v span of SPB sequences
// x HG heads ([sequence][token][q|k|v][HG*D]; the gradients dq|dk|dv
// replace it), their dO span ([sequence][token][HG*D]) and their tokens'
// key_valid ([sequence][KBS] f32); q and k RoPE'd in f32, each
// [sequence][head][token][D] at a head stride of N * D + 4 floats; the key
// biases [sequence][KBS]; p and dl, each [sequence][head][query][N + 1]
// f32; the bias key of every head, RoPE'd at N, and the bias value, f32
// [2][H][D]
struct ShortLayout {
  int hs, kbs, nk;
  size_t span, dspan, raw, qs, ks, kb, pt, dt, bias, total;
  __host__ __device__ ShortLayout(int spb, int hg, int N, int D, int nbuf, int H) {
    hs = N * D + 4;
    kbs = (N + 3) & ~3;
    nk = N + 1;
    span = (size_t)spb * N * 3 * hg * D * 2;
    dspan = (size_t)spb * N * hg * D * 2;
    raw = span + dspan + (size_t)spb * kbs * 4;
    size_t o = (size_t)nbuf * raw;
    qs = o; o += (size_t)spb * hg * hs * 4;
    ks = o; o += (size_t)spb * hg * hs * 4;
    kb = o; o += (size_t)spb * kbs * 4;
    pt = o; o += align16((size_t)spb * hg * N * nk * 4);
    dt = o; o += align16((size_t)spb * hg * N * nk * 4);
    bias = o; o += (size_t)2 * H * D * 4;
    total = o;
  }
};

struct ShortArgs {
  const bf16 *qkv, *dout, *bias_k, *bias_v;
  const float *key_valid, *cos_t, *sin_t;
  bf16* dqkv;
  float* part;         // (G * I, 2C) f32: each sequence's bias-key and bias-value gradients
  long long S, units;  // sequences (G * I); units (sequence blocks x head groups)
  int N, I, H, C, spb, hg, groups;
};

__host__ __device__ inline ShortArgs short_args(const bf16* qkv, const bf16* dout,
                                                const bf16* bias_k, const bf16* bias_v,
                                                const float* key_valid, const float* cos_t,
                                                const float* sin_t, bf16* dqkv, float* part,
                                                int G, int N, int I, int H, int C, int spb,
                                                int hg) {
  ShortArgs a;
  a.qkv = qkv; a.dout = dout; a.bias_k = bias_k; a.bias_v = bias_v;
  a.key_valid = key_valid; a.cos_t = cos_t; a.sin_t = sin_t; a.dqkv = dqkv; a.part = part;
  a.N = N; a.I = I; a.H = H; a.C = C; a.spb = spb; a.hg = hg;
  a.S = (long long)G * I;
  a.groups = hg > 0 ? (H + hg - 1) / hg : 0;
  a.units = spb > 0 ? (a.S + spb - 1) / spb * a.groups : 0;
  return a;
}

struct Unit {
  long long s0;    // first sequence
  int ns, h0, nh;  // sequences, first head, heads
};

__device__ __forceinline__ Unit unit_of(const ShortArgs& a, long long u) {
  Unit U;
  const long long sb = u / a.groups;
  U.s0 = sb * a.spb;
  U.ns = (int)min((long long)a.spb, a.S - U.s0);
  U.h0 = (int)(u % a.groups) * a.hg;
  U.nh = min(a.hg, a.H - U.h0);
  return U;
}

// token n of sequence s = (g, i) is row (g * N + n) * I + i of (G, N, I, .)
__device__ __forceinline__ long long token_row(const ShortArgs& a, long long s, int n) {
  return (s / a.I * a.N + n) * a.I + s % a.I;
}

// a unit whose rows are one contiguous span (I = 1, all heads): copied in
// and out without per-chunk row arithmetic
__device__ __forceinline__ bool contiguous(const ShortArgs& a, const Unit& U) {
  return a.I == 1 && U.nh == a.H;
}

// D floats from 16-byte aligned shared memory
template <int D>
__device__ __forceinline__ void load_f4(const float* src, float* v) {
#pragma unroll
  for (int d = 0; d < D / 4; ++d) {
    const float4 x = reinterpret_cast<const float4*>(src)[d];
    v[4 * d] = x.x; v[4 * d + 1] = x.y; v[4 * d + 2] = x.z; v[4 * d + 3] = x.w;
  }
}

template <int D>
__device__ __forceinline__ void store_f4(float* dst, const float* v) {
#pragma unroll
  for (int d = 0; d < D / 4; ++d)
    reinterpret_cast<float4*>(dst)[d] = make_float4(v[4 * d], v[4 * d + 1], v[4 * d + 2], v[4 * d + 3]);
}

// D floats as bf16 (round to nearest even) into 16-byte stores
template <int D>
__device__ __forceinline__ void pack_row(const float* v, bf16* dst) {
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    uint4 w;
    uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(v[8 * c + 2 * e], v[8 * c + 2 * e + 1]);
      wp[e] = *reinterpret_cast<const uint32_t*>(&p);
    }
    reinterpret_cast<uint4*>(dst)[c] = w;
  }
}

// the unit's q|k|v and dO spans and key_valid into a raw buffer: 16-byte
// cp.async chunks, the threads on consecutive chunks
template <int D>
__device__ __forceinline__ void load_unit(const ShortArgs& a, const Unit& U, unsigned char* raw,
                                          const ShortLayout& lay) {
  using ropefwd::cp16;
  bf16* qb = reinterpret_cast<bf16*>(raw);
  bf16* db = reinterpret_cast<bf16*>(raw + lay.span);
  float* kv = reinterpret_cast<float*>(raw + lay.span + lay.dspan);
  for (int e = threadIdx.x; e < U.ns * a.N; e += SHORT_THREADS)
    ropefwd::cp4(kv + e / a.N * lay.kbs + e % a.N, a.key_valid + token_row(a, U.s0 + e / a.N, e % a.N));
  if (contiguous(a, U)) {
    const bf16* src = a.qkv + U.s0 * a.N * 3LL * a.C;
    const int total = U.ns * a.N * 3 * a.C / 8;
    for (int e = threadIdx.x; e < total; e += SHORT_THREADS) cp16(qb + e * 8, src + e * 8);
    const bf16* dsrc = a.dout + U.s0 * a.N * (long long)a.C;
    for (int e = threadIdx.x; e < total / 3; e += SHORT_THREADS) cp16(db + e * 8, dsrc + e * 8);
    return;
  }
  const int hgd = a.hg * D, segc = U.nh * D / 8, total = U.ns * a.N * 3 * segc;
  for (int e = threadIdx.x; e < total; e += SHORT_THREADS) {
    const int c = e % segc, r = e / segc, part = r % 3, tok = r / 3;
    const long long row = token_row(a, U.s0 + tok / a.N, tok % a.N);
    cp16(qb + (size_t)(tok * 3 + part) * hgd + c * 8,
         a.qkv + row * 3LL * a.C + part * a.C + U.h0 * D + c * 8);
  }
  for (int e = threadIdx.x; e < total / 3; e += SHORT_THREADS) {
    const int c = e % segc, tok = e / segc;
    const long long row = token_row(a, U.s0 + tok / a.N, tok % a.N);
    cp16(db + (size_t)tok * hgd + c * 8, a.dout + row * a.C + U.h0 * D + c * 8);
  }
}

// the bias key of every head, RoPE'd at position N, and the bias value, in
// f32: the same for every sequence of the call
template <int D>
__device__ __forceinline__ void stage_bias(const ShortArgs& a, const ShortLayout& lay,
                                           unsigned char* sm) {
  float* Bq = reinterpret_cast<float*>(sm + lay.bias);
  for (int h = threadIdx.x; h < a.H; h += SHORT_THREADS) {
    float k[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      k[d] = __bfloat162float(a.bias_k[h * D + d]);
      Bq[(a.H + h) * D + d] = __bfloat162float(a.bias_v[h * D + d]);
    }
    ropefwd::rope_row4<D>(k, a.cos_t + a.N * D, a.sin_t + a.N * D);
    store_f4<D>(Bq + h * D, k);
  }
}

// a unit whose raw buffer has landed (and is visible to every thread):
// RoPE q and k once; the query side (dq, p and dl of a row); the key side
// (dk, dv of a key from the p and dl of its column); the gradients out.
// NKC: N + 1 known at compile time (trunk stage 1 at L = 4: the loops over
// keys and queries unroll without guards, so the compiler interleaves the
// keys' dot products), 0: N read from the arguments; the same arithmetic.
// NAT: the natural softmax (the backward of rope_attention(base2=False), the
// modular layer's residue attention): the row's logits are kept in
// registers and their maximum taken before the exponent, p = exp(l - max) /
// sum, and dl = p (dp - rowsum) without the factor ln 2
template <int D, int NKC, bool NAT = false>
__device__ __forceinline__ void unit_body(const ShortArgs& a, const Unit& U, unsigned char* raw,
                                          const ShortLayout& lay, unsigned char* sm) {
  const int N = NKC > 0 ? NKC - 1 : a.N, NK = N + 1, hgd = a.hg * D;
  bf16* qb = reinterpret_cast<bf16*>(raw);
  const bf16* db = reinterpret_cast<const bf16*>(raw + lay.span);
  const float* kv = reinterpret_cast<const float*>(raw + lay.span + lay.dspan);
  float* Qs = reinterpret_cast<float*>(sm + lay.qs);
  float* Ks = reinterpret_cast<float*>(sm + lay.ks);
  float* Kb = reinterpret_cast<float*>(sm + lay.kb);
  float* Pt = reinterpret_cast<float*>(sm + lay.pt);
  float* Dt = reinterpret_cast<float*>(sm + lay.dt);
  const float* Bq = reinterpret_cast<const float*>(sm + lay.bias);
  const int items = U.ns * U.nh * N;

  // a thread per (sequence, head, token): q and k RoPE'd at the token's
  // position, in f32; the key biases (the tokens of a head on neighbouring
  // lanes here and below)
  for (int e = threadIdx.x; e < items; e += SHORT_THREADS) {
    const int n = e % N, r = e / N, hl = r % U.nh, sl = r / U.nh;
    const bf16* src = qb + (size_t)(sl * N + n) * 3 * hgd + hl * D;
    float q[D], k[D];
    ropefwd::unpack_row<D>(src, q);
    ropefwd::unpack_row<D>(src + hgd, k);
    ropefwd::rope_row4<D>(q, a.cos_t + n * D, a.sin_t + n * D);
    ropefwd::rope_row4<D>(k, a.cos_t + n * D, a.sin_t + n * D);
    const size_t o = (size_t)(sl * a.hg + hl) * lay.hs + n * D;
    store_f4<D>(Qs + o, q);
    store_f4<D>(Ks + o, k);
    if (hl == 0) Kb[sl * lay.kbs + n] = kv[sl * lay.kbs + n] > 0.f ? 0.f : -1e9f;
  }
  __syncthreads();

  // the query side, a thread per (sequence, head, query n): each key's exp2
  // and dp formed once and kept in registers (at most 17 keys); dq; the
  // row's p and dl to shared memory for the key side; dq over its q slice.
  // rowsum is rounded once (__fmul_rn), as the first version's loop over a
  // runtime N left it: with N known, dp - rowsum would fuse with its product
  for (int e = threadIdx.x; e < items; e += SHORT_THREADS) {
    const int n = e % N, r = e / N, hl = r % U.nh, sl = r / U.nh, h = U.h0 + hl;
    const size_t ho = (size_t)(sl * a.hg + hl) * lay.hs;
    const float* K = Ks + ho;
    const float* kb = Kb + sl * lay.kbs;
    const bf16* V = qb + (size_t)(sl * N * 3 + 2) * hgd + hl * D;  // token j at V + j * 3 * hgd
    float q[D], go[D];
    load_f4<D>(Qs + ho + n * D, q);
    ropefwd::unpack_row<D>(db + (size_t)(sl * N + n) * hgd + hl * D, go);
    float ex[SHORT_KEYS], dp[SHORT_KEYS];
    float den = 0.f, sdp = 0.f, mx = -3.0e38f;
#pragma unroll
    for (int j = 0; j < SHORT_KEYS; ++j) {
      if (j <= N) {
        float kj[D], vj[D];
        load_f4<D>(j < N ? K + j * D : Bq + h * D, kj);
        const float l = dot<D>(q, kj) + (j < N ? kb[j] : 0.f);
        if constexpr (NAT) {
          ex[j] = l;  // the logit; its exponent once the row's maximum is known
          mx = fmaxf(mx, l);
        } else {
          ex[j] = exp2f(fminf(l, 100.f));
          den += ex[j];
        }
        if (j < N)
          ropefwd::unpack_row<D>(V + (size_t)j * 3 * hgd, vj);
        else
          load_f4<D>(Bq + (a.H + h) * D, vj);
        dp[j] = dot<D>(go, vj);
        if constexpr (!NAT) sdp += ex[j] * dp[j];
      }
    }
    if constexpr (NAT) {
#pragma unroll
      for (int j = 0; j < SHORT_KEYS; ++j) {
        if (j <= N) {
          ex[j] = expf(ex[j] - mx);
          den += ex[j];
          sdp += ex[j] * dp[j];
        }
      }
    }
    const float inv = NAT ? 1.f / den : 1.f / (den + 1e-30f), rsum = __fmul_rn(sdp, inv);
    float dq[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dq[d] = 0.f;
    float* pr = Pt + ((size_t)(sl * a.hg + hl) * N + n) * NK;
    float* dr = Dt + ((size_t)(sl * a.hg + hl) * N + n) * NK;
#pragma unroll
    for (int j = 0; j < SHORT_KEYS; ++j) {
      if (j <= N) {
        const float p = ex[j] * inv;
        const float dl = NAT ? p * (dp[j] - rsum) : LN2F * p * (dp[j] - rsum);
        float kj[D];
        load_f4<D>(j < N ? K + j * D : Bq + h * D, kj);
#pragma unroll
        for (int d = 0; d < D; ++d) dq[d] += dl * kj[d];
        pr[j] = p;
        dr[j] = dl;
      }
    }
    rope_row_t<D>(dq, a.cos_t + n * D, a.sin_t + n * D);
    pack_row<D>(dq, qb + (size_t)(sl * N + n) * 3 * hgd + hl * D);
  }
  __syncthreads();

  // the key side, a thread per (sequence, head, key j <= N): dk and dv over
  // the queries in order from p and dl; dk, dv over the key's k and v
  // slices, the bias key's (j = N) to the sequence's f32 partial
  for (int e = threadIdx.x; e < U.ns * U.nh * NK; e += SHORT_THREADS) {
    const int j = e % NK, r = e / NK, hl = r % U.nh, sl = r / U.nh, h = U.h0 + hl;
    const float* Q = Qs + (size_t)(sl * a.hg + hl) * lay.hs;
    const bf16* dO = db + (size_t)sl * N * hgd + hl * D;
    const float* pc = Pt + (size_t)(sl * a.hg + hl) * N * NK + j;
    const float* dc = Dt + (size_t)(sl * a.hg + hl) * N * NK + j;
    float dk[D], dv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dk[d] = dv[d] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float p = pc[n * NK], dl = dc[n * NK];
      float qn[D], go[D];
      load_f4<D>(Q + n * D, qn);
      ropefwd::unpack_row<D>(dO + (size_t)n * hgd, go);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dk[d] += dl * qn[d];
        dv[d] += p * go[d];
      }
    }
    rope_row_t<D>(dk, a.cos_t + j * D, a.sin_t + j * D);
    if (j < N) {
      bf16* dst = qb + (size_t)(sl * N + j) * 3 * hgd + hl * D;
      pack_row<D>(dk, dst + hgd);
      pack_row<D>(dv, dst + 2 * hgd);
    } else {  // 16-byte stores: scalar ones held the bias key's warps 2D stores long
      float* pb = a.part + (U.s0 + sl) * 2LL * a.C + h * D;
      store_f4<D>(pb, dk);
      store_f4<D>(pb + a.C, dv);
    }
  }
  __syncthreads();

  // dqkv: 16-byte stores, the threads on consecutive chunks
  if (contiguous(a, U)) {
    uint4* dst = reinterpret_cast<uint4*>(a.dqkv + U.s0 * N * 3LL * a.C);
    const uint4* src = reinterpret_cast<const uint4*>(qb);
    for (int e = threadIdx.x; e < U.ns * N * 3 * a.C / 8; e += SHORT_THREADS) dst[e] = src[e];
  } else {
    const int segc = U.nh * D / 8;
    for (int e = threadIdx.x; e < U.ns * N * 3 * segc; e += SHORT_THREADS) {
      const int c = e % segc, r = e / segc, part = r % 3, tok = r / 3;
      const long long row = token_row(a, U.s0 + tok / N, tok % N);
      *reinterpret_cast<uint4*>(a.dqkv + row * 3LL * a.C + part * a.C + U.h0 * D + c * 8) =
          *reinterpret_cast<const uint4*>(qb + (size_t)(tok * 3 + part) * hgd + c * 8);
    }
  }
}

// the standalone kernel's walk: units u0, u0 + stride, ... with the next
// unit's spans in flight (the other raw buffer) while this one is computed
template <int D, int NKC, bool NAT = false>
__device__ __forceinline__ void short_stream(const ShortArgs& a, long long u, long long stride,
                                             unsigned char* sm) {
  const ShortLayout lay(a.spb, a.hg, a.N, D, 2, a.H);
  if (u >= a.units) return;
  stage_bias<D>(a, lay, sm);
  load_unit<D>(a, unit_of(a, u), sm, lay);
  ropefwd::cp_commit();
  for (int k = 0; u < a.units; u += stride, k ^= 1) {
    ropefwd::cp_wait<0>();
    __syncthreads();  // unit u has landed; every thread is done with the last one
    if (u + stride < a.units) load_unit<D>(a, unit_of(a, u + stride), sm + (k ^ 1) * lay.raw, lay);
    ropefwd::cp_commit();
    unit_body<D, NKC, NAT>(a, unit_of(a, u), sm + k * lay.raw, lay, sm);
  }
}

// one unit, one raw buffer: a virtual block of the merged layer backward
template <int D, int NKC>
__device__ __forceinline__ void short_unit(const ShortArgs& a, long long u, unsigned char* sm) {
  const ShortLayout lay(a.spb, a.hg, a.N, D, 1, a.H);
  const Unit U = unit_of(a, u);
  load_unit<D>(a, U, sm, lay);
  ropefwd::cp_commit();
  stage_bias<D>(a, lay, sm);
  ropefwd::cp_wait<0>();
  __syncthreads();
  unit_body<D, NKC>(a, U, sm, lay, sm);
}

// ---- long sequences (16 < N <= MAX_N): a block of 4 warps takes one
// (sequence, head); the design note is in rope_attention_bwd.cu ----

// shared memory of the long body (bytes): q (fp16, RoPE'd, times 2^sq) and
// dO (bf16) of the NQP queries (N rounded up to 16), k (fp16, RoPE'd, times
// 2^sk) and v (bf16) of the NKP keys (N + 1 rounded up to 16), pad rows
// zero; the key biases; 1 / sum p and rowsum(p dP) per query; the warps'
// maxima; one f32 16-row tile per warp for the gradients' RoPE transpose
struct LongLayout {
  int NQP, NKP, RS, SS;
  size_t qs, gs, ks, vs, kb, inv, rs, red, sc, total;
  __host__ __device__ LongLayout(int N, int D) {
    RS = (D + 15) / 16 * 16 + 8;  // attention_tile.cuh Dims<D>::RS
    SS = D + 1;                   // f32 stride of the gradient tiles
    NQP = (N + 15) / 16 * 16;
    NKP = (N + 1 + 15) / 16 * 16;
    size_t o = 0;
    qs = o; o += (size_t)NQP * RS * 2;
    gs = o; o += (size_t)NQP * RS * 2;
    ks = o; o += (size_t)NKP * RS * 2;
    vs = o; o += (size_t)NKP * RS * 2;
    kb = o; o += (size_t)NKP * 4;
    inv = o; o += (size_t)NQP * 4;
    rs = o; o += (size_t)NQP * 4;
    red = o; o += 16 * 4;
    sc = o; o += (size_t)(THREADS / 32) * 16 * SS * 4;
    total = (o + 15) / 16 * 16;
  }
};

template <int D>
__device__ __forceinline__ void long_block(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
    const bf16* __restrict__ bias_k, const bf16* __restrict__ bias_v,
    const float* __restrict__ key_valid, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, bf16* __restrict__ dqkv, float* __restrict__ part,
    int N, int I, int H, int C, int bx, float* smem) {
  using namespace rope_tile;
  constexpr int RS = Dims<D>::RS, KC = Dims<D>::KC, OB = D / 8, SS = D + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const LongLayout lay(N, D);
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem);
  f16* Qs = reinterpret_cast<f16*>(sm + lay.qs);
  bf16* Gs = reinterpret_cast<bf16*>(sm + lay.gs);
  f16* Ks = reinterpret_cast<f16*>(sm + lay.ks);
  bf16* Vs = reinterpret_cast<bf16*>(sm + lay.vs);
  float* Kb = reinterpret_cast<float*>(sm + lay.kb);
  float* Inv = reinterpret_cast<float*>(sm + lay.inv);
  float* Rs = reinterpret_cast<float*>(sm + lay.rs);
  float* Red = reinterpret_cast<float*>(sm + lay.red);
  float* Sc = reinterpret_cast<float*>(sm + lay.sc) + warp * 16 * SS;
  const int NQP = lay.NQP, NKP = lay.NKP;
  const int h = bx % H;
  const long long seq = bx / H;
  const long long row0 = (seq / I) * (long long)N * I + seq % I;  // token n: row0 + n * I
  auto tok = [&](int n) { return row0 + (long long)n * I; };

  // ---- stage: query rows (q RoPE'd, dO) and key rows (k RoPE'd, the bias
  // key at N, v, the mask bias); pad rows zero ----
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
  float qmax = 0.f, kmax = 0.f, gmax = 0.f;
  for (int t = tid; t < NQP + NKP; t += THREADS) {
    float x[D], y[D];
    if (t < NQP) {
      q_row(t, x);
      if (t < N) {
        load_row<D>(y, dout + tok(t) * C + h * D);
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) y[d] = 0.f;
      }
      qmax = fmaxf(qmax, row_max<D>(x));
      gmax = fmaxf(gmax, row_max<D>(y));
      store_row<D, true>(Qs + t * RS, x);
      store_row<D, false>(Gs + t * RS, y);
    } else {
      const int n = t - NQP;
      Kb[n] = k_row(n, x, y);
      kmax = fmaxf(kmax, row_max<D>(x));
      store_row<D, true>(Ks + n * RS, x);
      store_row<D, false>(Vs + n * RS, y);
    }
  }
  qmax = warp_max(qmax);
  kmax = warp_max(kmax);
  gmax = warp_max(gmax);
  if (lane == 0) {
    Red[warp] = qmax;
    Red[4 + warp] = kmax;
    Red[8 + warp] = gmax;
  }
  __syncthreads();
  // q and k outside fp16's comfortable range: staged again, scaled by
  // powers of two (the maxima are the block's, so the branches are uniform)
  const int sq = scale_exponent(max4(Red)), sk = scale_exponent(max4(Red + 4));
  if (sq != 0) {
    const float mul = ldexpf(1.f, sq);
    for (int n = tid; n < N; n += THREADS) {
      float x[D];
      q_row(n, x);
      store_row<D, true>(Qs + n * RS, x, mul);
    }
  }
  if (sk != 0) {
    const float mul = ldexpf(1.f, sk);
    for (int n = tid; n <= N; n += THREADS) {
      float x[D], y[D];
      k_row(n, x, y);
      store_row<D, true>(Ks + n * RS, x, mul);
    }
  }
  if (sq != 0 || sk != 0) __syncthreads();
  // ds goes to fp16 as ds / max|dO|; the dq and dk products come back times
  // max|dO| and the other operand's 2^-s
  const float gm = max4(Red + 8);
  const float to_f16 = gm > 0.f ? LN2F / gm : LN2F, from_f16 = gm > 0.f ? gm : 1.f;
  const float lscale = ldexpf(1.f, -(sq + sk));  // the logits' scale
  const float dq_back = ldexpf(from_f16, -sk), dk_back = ldexpf(from_f16, -sq);
  const int nkb = NKP / 16;

  // write a warp's 16 x D f32 tile (the Sc buffer), RoPE-transposed at
  // positions r0 + r if `roped`, as rows of dqkv at column `col`; the
  // row r0 + r == N (the bias key) as f32 to the sequence's partial
  auto write_tile = [&](int r0, int col, bool roped, float* bias_part) {
    __syncwarp();
    if (lane < 16) {
      const int n = r0 + lane;
      if (n <= N) {
        float g[D];
#pragma unroll
        for (int d = 0; d < D; ++d) g[d] = Sc[lane * SS + d];
        if (roped) rope_t<D>(g, cos_t + (long long)n * D, sin_t + (long long)n * D);
        if (n < N) {
          store_global<D>(dqkv + tok(n) * 3LL * C + col + h * D, g);
        } else if (bias_part != nullptr) {
#pragma unroll
          for (int d = 0; d < D; ++d) bias_part[d] = g[d];
        }
      }
    }
    __syncwarp();
  };
  auto to_tile = [&](float (*acc)[4], float mul) {
#pragma unroll
    for (int db = 0; db < OB; ++db) {
      const int d = db * 8 + tig * 2;
      Sc[gid * SS + d] = acc[db][0] * mul;
      Sc[gid * SS + d + 1] = acc[db][1] * mul;
      Sc[(gid + 8) * SS + d] = acc[db][2] * mul;
      Sc[(gid + 8) * SS + d + 1] = acc[db][3] * mul;
    }
  };

  // ---- phase A: 16-query tiles; p of the whole row stays in registers ----
  for (int qt = warp; qt < NQP / 16; qt += THREADS / 32) {
    const int q0 = qt * 16;
    uint32_t qa[KC][4], ga[KC][4];
    load_a<D>(qa, Qs, q0);
    load_a<D>(ga, Gs, q0);
    // S = Q K^T, p = exp2(min(S + bias, 100)) (no max, as the forward)
    float p[2 * MAX_KB][4];
    float den0 = 0.f, den1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < 2 * MAX_KB; ++nb) {
      p[nb][0] = p[nb][1] = p[nb][2] = p[nb][3] = 0.f;
      if (nb < 2 * nkb) {
        uint32_t b[KC][2];
        load_b_d<D>(b, Ks, nb * 8);
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) mma16816_f16(p[nb], qa[kc], b[kc][0], b[kc][1]);
        const float2 kb = *reinterpret_cast<const float2*>(Kb + nb * 8 + tig * 2);
        p[nb][0] = exp2f(fminf(fmaf(p[nb][0], lscale, kb.x), 100.f));
        p[nb][1] = exp2f(fminf(fmaf(p[nb][1], lscale, kb.y), 100.f));
        p[nb][2] = exp2f(fminf(fmaf(p[nb][2], lscale, kb.x), 100.f));
        p[nb][3] = exp2f(fminf(fmaf(p[nb][3], lscale, kb.y), 100.f));
        den0 += p[nb][0] + p[nb][1];
        den1 += p[nb][2] + p[nb][3];
      }
    }
    den0 += __shfl_xor_sync(0xffffffffu, den0, 1);
    den0 += __shfl_xor_sync(0xffffffffu, den0, 2);
    den1 += __shfl_xor_sync(0xffffffffu, den1, 1);
    den1 += __shfl_xor_sync(0xffffffffu, den1, 2);
    const bool live0 = q0 + gid < N, live1 = q0 + gid + 8 < N;
    const float inv0 = live0 ? 1.f / (den0 + 1e-30f) : 0.f;
    const float inv1 = live1 ? 1.f / (den1 + 1e-30f) : 0.f;
    // pn = p / sum p in bf16 (the A fragments of the dV product's layout)
    uint32_t pn[2 * MAX_KB][2];
#pragma unroll
    for (int nb = 0; nb < 2 * MAX_KB; ++nb) {
      pn[nb][0] = attn_tile::pack2(p[nb][0] * inv0, p[nb][1] * inv0);
      pn[nb][1] = attn_tile::pack2(p[nb][2] * inv1, p[nb][3] * inv1);
    }
    // dP = dO V^T, rowsum = sum pn dP
    auto dp_block = [&](float* c, int nb) {
      c[0] = c[1] = c[2] = c[3] = 0.f;
      uint32_t b[KC][2];
      load_b_d<D>(b, Vs, nb * 8);
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) attn_tile::mma16816(c, ga[kc], b[kc][0], b[kc][1]);
    };
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < 2 * MAX_KB; ++nb) {
      if (nb < 2 * nkb) {
        float c[4];
        dp_block(c, nb);
        const float2 a = unpack_bf2(pn[nb][0]), b = unpack_bf2(pn[nb][1]);
        rs0 += a.x * c[0] + a.y * c[1];
        rs1 += b.x * c[2] + b.y * c[3];
      }
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    if (tig == 0) {
      Inv[q0 + gid] = inv0;
      Inv[q0 + gid + 8] = inv1;
      Rs[q0 + gid] = rs0;
      Rs[q0 + gid + 8] = rs1;
    }
    // dS = ln2 pn (dP - rowsum) (as ds / max|dO| in fp16), dQ = dS K
    float dq[OB][4];
#pragma unroll
    for (int db = 0; db < OB; ++db) dq[db][0] = dq[db][1] = dq[db][2] = dq[db][3] = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_KB; ++j) {
      if (j < nkb) {
        uint32_t da[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nb = 2 * j + half;
          float c[4];
          dp_block(c, nb);
          const float2 a = unpack_bf2(pn[nb][0]), b = unpack_bf2(pn[nb][1]);
          da[2 * half] = pack_h2(a.x * (c[0] - rs0) * to_f16, a.y * (c[1] - rs0) * to_f16);
          da[2 * half + 1] = pack_h2(b.x * (c[2] - rs1) * to_f16, b.y * (c[3] - rs1) * to_f16);
        }
        uint32_t b[OB][2];
        load_b_rows<D>(b, Ks, 16 * j);
#pragma unroll
        for (int db = 0; db < OB; ++db) mma16816_f16(dq[db], da, b[db][0], b[db][1]);
      }
    }
    to_tile(dq, dq_back);
    write_tile(q0, 0, true, nullptr);
  }
  __syncthreads();

  // ---- phase B: 16-key tiles: S^T = K Q^T and dP^T = V dO^T again, then
  // dV = P^T dO and dK = dS^T Q ----
  for (int kt = warp; kt < nkb; kt += THREADS / 32) {
    const int k0 = kt * 16;
    uint32_t ka[KC][4], va[KC][4];
    load_a<D>(ka, Ks, k0);
    load_a<D>(va, Vs, k0);
    const float kb0 = Kb[k0 + gid], kb1 = Kb[k0 + gid + 8];
    float dk[OB][4], dv[OB][4];
#pragma unroll
    for (int db = 0; db < OB; ++db)
      dk[db][0] = dk[db][1] = dk[db][2] = dk[db][3] = dv[db][0] = dv[db][1] = dv[db][2] = dv[db][3] = 0.f;
    for (int q0 = 0; q0 < NQP; q0 += 16) {
      uint32_t pa[4], da[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c0 = q0 + half * 8;  // this 8-query block
        float st[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f};
        uint32_t b[KC][2];
        load_b_d<D>(b, Qs, c0);
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) mma16816_f16(st, ka[kc], b[kc][0], b[kc][1]);
        load_b_d<D>(b, Gs, c0);
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) attn_tile::mma16816(dpt, va[kc], b[kc][0], b[kc][1]);
        const float2 iv = *reinterpret_cast<const float2*>(Inv + c0 + tig * 2);
        const float2 rs = *reinterpret_cast<const float2*>(Rs + c0 + tig * 2);
        // pn^T in bf16, as phase A rounds it
        const uint32_t lo = attn_tile::pack2(exp2f(fminf(fmaf(st[0], lscale, kb0), 100.f)) * iv.x,
                                             exp2f(fminf(fmaf(st[1], lscale, kb0), 100.f)) * iv.y);
        const uint32_t hi = attn_tile::pack2(exp2f(fminf(fmaf(st[2], lscale, kb1), 100.f)) * iv.x,
                                             exp2f(fminf(fmaf(st[3], lscale, kb1), 100.f)) * iv.y);
        pa[2 * half] = lo;
        pa[2 * half + 1] = hi;
        const float2 a = unpack_bf2(lo), bb = unpack_bf2(hi);
        da[2 * half] = pack_h2(a.x * (dpt[0] - rs.x) * to_f16, a.y * (dpt[1] - rs.y) * to_f16);
        da[2 * half + 1] = pack_h2(bb.x * (dpt[2] - rs.x) * to_f16, bb.y * (dpt[3] - rs.y) * to_f16);
      }
      uint32_t b[OB][2];
      load_b_rows<D>(b, Gs, q0);
#pragma unroll
      for (int db = 0; db < OB; ++db) attn_tile::mma16816(dv[db], pa, b[db][0], b[db][1]);
      load_b_rows<D>(b, Qs, q0);
#pragma unroll
      for (int db = 0; db < OB; ++db) mma16816_f16(dk[db], da, b[db][0], b[db][1]);
    }
    float* pb = part + seq * 2LL * C + h * D;
    to_tile(dk, dk_back);
    write_tile(k0, C, true, pb);
    to_tile(dv, 1.f);
    write_tile(k0, 2 * C, false, pb + C);
  }
}

// the launch shape of a call: short (N <= 16: units of spb sequences x hg
// heads, nbuf raw buffers: 2 streaming, 1 in the merged layer backward;
// ops/rope_attention_bwd.py::short_plan) or long (a block per (sequence,
// head)); blocks (short: units) and dynamic shared memory of a block;
// blocks 0 for a plan the short body does not take
struct Shape {
  bool short_seq;
  unsigned blocks;
  size_t smem;
  int spb, hg;
};

__host__ __device__ inline Shape shape(long long S, int N, int H, int D, int spb, int hg, int nbuf) {
  Shape s;
  s.short_seq = N <= 16;
  s.spb = spb;
  s.hg = hg;
  if (s.short_seq) {
    const bool ok = N >= 1 && spb >= 1 && hg >= 1 && hg <= H && (nbuf == 1 || nbuf == 2);
    s.smem = ok ? ShortLayout(spb, hg, N, D, nbuf, H).total : 0;
    const long long units = ok ? (S + spb - 1) / spb * ((H + hg - 1) / hg) : 0;
    s.blocks = units > 0x7fffffffLL ? 0u : (unsigned)units;
  } else {
    s.smem = LongLayout(N, D).total;
    s.blocks = N <= MAX_N && S * H <= 0x7fffffffLL ? (unsigned)(S * H) : 0u;
  }
  return s;
}

}  // namespace ropebwd
