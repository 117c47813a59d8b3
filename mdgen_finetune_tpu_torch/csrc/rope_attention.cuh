// rope_attention.cuh: the bodies of rope_attention.cu's two kernels (the
// design note is there) as device functions over a block (or unit) index
// and a shared-memory buffer, so that rope_attention.cu and the merged layer
// backward (fused_layer_bwd.cu, which recomputes the trunk's attention
// outputs) run the same code. Both bodies are written for 128 threads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rope_tile.cuh"

namespace ropefwd {

typedef __nv_bfloat16 bf16;


constexpr int SHORT_THREADS = 128;                // short body: threads per block
constexpr int LONG_THREADS = 128;                 // long kernel: threads per (sequence, head)
constexpr int SHORT_KEYS = 17;                    // the short body's most keys: N <= 16, + the bias key

template <int D>
__device__ __forceinline__ void rope_row(float* v, const float* cs, const float* sn) {
  float r[D];
#pragma unroll
  for (int d = 0; d < D; ++d) r[d] = d < D / 2 ? -v[d + D / 2] : v[d - D / 2];
#pragma unroll
  for (int d = 0; d < D; ++d) v[d] = v[d] * cs[d] + r[d] * sn[d];
}

// ---- short sequences (N <= 16): the streaming body; the design note is
// in rope_attention.cu ----

// one unit's shared memory (bytes): nbuf buffers of the raw bf16 q|k|v span
// of SPB sequences x HG heads (token-major: [sequence][token][q|k|v][HG*D];
// V is read from there, and each thread's output replaces its q slice),
// each followed by the span's key_valid, [sequence][KBS] f32; K
// RoPE'd in f32, [sequence][head][key][D] at a head stride of N * D + 4
// floats (a float4 read by the 8 heads of a warp hits 8 distinct bank
// quads); the key biases, [sequence][KBS]; the bias key of every head,
// RoPE'd at N, and the bias value, f32 [2][H][D].
// ops/rope_attention.py::short_bytes mirrors it.
struct ShortLayout {
  int hs, kbs;
  size_t span, raw, ks, kb, bias, total;  // span: the q|k|v bytes of a raw buffer
  __host__ __device__ ShortLayout(int spb, int hg, int N, int D, int nbuf, int H) {
    hs = N * D + 4;
    kbs = (N + 3) & ~3;
    span = (size_t)spb * N * 3 * hg * D * 2;
    raw = span + (size_t)spb * kbs * 4;
    size_t o = (size_t)nbuf * raw;
    ks = o; o += (size_t)spb * hg * hs * 4;
    kb = o; o += (size_t)spb * kbs * 4;
    bias = o; o += (size_t)2 * H * D * 4;
    total = o;
  }
};

struct ShortArgs {
  const bf16 *qkv, *bias_k, *bias_v;
  const float *key_valid, *cos_t, *sin_t;
  bf16* out;
  long long S, units;  // sequences (G * I); units (sequence blocks x head groups)
  int N, I, H, C, base2, spb, hg, groups;
};

__host__ __device__ inline ShortArgs short_args(const bf16* qkv, const bf16* bias_k,
                                                const bf16* bias_v, const float* key_valid,
                                                const float* cos_t, const float* sin_t, bf16* out,
                                                int G, int N, int I, int H, int C, int base2,
                                                int spb, int hg) {
  ShortArgs a;
  a.qkv = qkv; a.bias_k = bias_k; a.bias_v = bias_v;
  a.key_valid = key_valid; a.cos_t = cos_t; a.sin_t = sin_t; a.out = out;
  a.N = N; a.I = I; a.H = H; a.C = C; a.base2 = base2; a.spb = spb; a.hg = hg;
  a.S = (long long)G * I;
  a.groups = hg > 0 ? (H + hg - 1) / hg : 0;
  a.units = spb > 0 ? (a.S + spb - 1) / spb * a.groups : 0;
  return a;
}

struct Unit {
  long long s0;  // first sequence
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

// a unit whose rows are one contiguous span of (G, N, I, .): I = 1, all
// heads (copied in and out without per-chunk row arithmetic); a build with
// -DMDGEN_SHORT_GENERAL takes every unit through the general path, to time
// what this one saves (chip_smoke.py, phase rope_short)
__device__ __forceinline__ bool contiguous(const ShortArgs& a, const Unit& U) {
#ifdef MDGEN_SHORT_GENERAL
  return false;
#else
  return a.I == 1 && U.nh == a.H;
#endif
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int D>
__device__ __forceinline__ void unpack_row(const bf16* src, float* f) {
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 v = reinterpret_cast<const uint4*>(src)[c];
    const bf16* b = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[8 * c + e] = __bfloat162float(b[e]);
  }
}

// rope_row with the tables' row read as float4s (the same products)
template <int D>
__device__ __forceinline__ void rope_row4(float* v, const float* cos_row, const float* sin_row) {
  float cs[D], sn[D];
#pragma unroll
  for (int d = 0; d < D / 4; ++d) {
    const float4 c = __ldg(reinterpret_cast<const float4*>(cos_row) + d);
    const float4 s = __ldg(reinterpret_cast<const float4*>(sin_row) + d);
    cs[4 * d] = c.x; cs[4 * d + 1] = c.y; cs[4 * d + 2] = c.z; cs[4 * d + 3] = c.w;
    sn[4 * d] = s.x; sn[4 * d + 1] = s.y; sn[4 * d + 2] = s.z; sn[4 * d + 3] = s.w;
  }
  rope_row<D>(v, cs, sn);
}

// the unit's q|k|v span into a raw buffer: 16-byte cp.async chunks, the
// threads on consecutive chunks (one span at I = 1 with every head, else
// each token's head-group slices); and its tokens' key_valid after it
template <int D>
__device__ __forceinline__ void load_unit(const ShortArgs& a, const Unit& U, bf16* raw,
                                          const ShortLayout& lay) {
  float* kv = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(raw) + lay.span);
  for (int e = threadIdx.x; e < U.ns * a.N; e += SHORT_THREADS)
    cp4(kv + e / a.N * lay.kbs + e % a.N, a.key_valid + token_row(a, U.s0 + e / a.N, e % a.N));
  if (contiguous(a, U)) {
    const bf16* src = a.qkv + U.s0 * a.N * 3LL * a.C;
    const int total = U.ns * a.N * 3 * a.C / 8;
    for (int e = threadIdx.x; e < total; e += SHORT_THREADS) cp16(raw + e * 8, src + e * 8);
    return;
  }
  const int segc = U.nh * D / 8, total = U.ns * a.N * 3 * segc;
  for (int e = threadIdx.x; e < total; e += SHORT_THREADS) {
    const int c = e % segc, r = e / segc, part = r % 3, tok = r / 3;
    const long long row = token_row(a, U.s0 + tok / a.N, tok % a.N);
    cp16(raw + (size_t)(tok * 3 + part) * a.hg * D + c * 8,
         a.qkv + row * 3LL * a.C + part * a.C + U.h0 * D + c * 8);
  }
}

// the bias key of every head, RoPE'd at position N, and the bias value, in
// f32: the same for every sequence of the call
template <int D>
__device__ __forceinline__ void stage_bias(const ShortArgs& a, const ShortLayout& lay,
                                           unsigned char* sm) {
  float* Kq = reinterpret_cast<float*>(sm + lay.bias);
  for (int h = threadIdx.x; h < a.H; h += SHORT_THREADS) {
    float k[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      k[d] = __bfloat162float(a.bias_k[h * D + d]);
      Kq[(a.H + h) * D + d] = __bfloat162float(a.bias_v[h * D + d]);
    }
    rope_row4<D>(k, a.cos_t + a.N * D, a.sin_t + a.N * D);
#pragma unroll
    for (int d = 0; d < D; ++d) Kq[h * D + d] = k[d];
  }
}

// one query row against the N keys at Ks / Kb (their values bf16 in the raw
// span, a token's apart) and the bias key: softmax (base 2 without max, or
// natural with max) and the weighted sum of values; the logits stay in
// registers (at most 17), so each is formed once
template <int D>
__device__ __forceinline__ void attend_short(const float* q, const float* Ks, const float* Kb,
                                             const bf16* V, int vstride, const float* kbias,
                                             const float* vbias, int N, int base2, float* acc) {
  float lg[SHORT_KEYS];
  float m = -3.0e38f;
#pragma unroll
  for (int j = 0; j < SHORT_KEYS; ++j) {
    if (j <= N) {
      const float4* k4 = reinterpret_cast<const float4*>(j < N ? Ks + j * D : kbias);
      float l = j < N ? Kb[j] : 0.f;
#pragma unroll
      for (int d = 0; d < D / 4; ++d) {
        float4 k = k4[d];
        l += q[4 * d] * k.x + q[4 * d + 1] * k.y + q[4 * d + 2] * k.z + q[4 * d + 3] * k.w;
      }
      lg[j] = l;
      m = fmaxf(m, l);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float denom = 0.f;
#pragma unroll
  for (int j = 0; j < SHORT_KEYS; ++j) {
    if (j <= N) {
      const float p = base2 ? exp2f(fminf(lg[j], 100.f)) : expf(lg[j] - m);
      denom += p;
      float v[D];
      if (j < N) {
        unpack_row<D>(V + j * vstride, v);
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) v[d] = vbias[d];
      }
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += p * v[d];
    }
  }
  float inv = 1.f / (base2 ? denom + 1e-30f : denom);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] *= inv;
}

// a unit whose raw span has landed (and is visible to every thread):
// stage K, attend (each output over its q slice), write the output
template <int D>
__device__ __forceinline__ void unit_body(const ShortArgs& a, const Unit& U, bf16* raw,
                                          const ShortLayout& lay, unsigned char* sm) {
  float* Ks = reinterpret_cast<float*>(sm + lay.ks);
  float* Kb = reinterpret_cast<float*>(sm + lay.kb);
  const float* Kq = reinterpret_cast<const float*>(sm + lay.bias);
  const int N = a.N, hgd = a.hg * D;
  // a thread per (sequence, head, key): K RoPE'd at its position, the key
  // biases; the queries of a head on neighbouring lanes here and below
  for (int e = threadIdx.x; e < U.ns * U.nh * N; e += SHORT_THREADS) {
    const int j = e % N, r = e / N, hl = r % U.nh, sl = r / U.nh;
    float k[D];
    unpack_row<D>(raw + (size_t)((sl * N + j) * 3 + 1) * hgd + hl * D, k);
    if (hl == 0) {
      const float* kv = reinterpret_cast<const float*>(reinterpret_cast<const unsigned char*>(raw) + lay.span);
      Kb[sl * lay.kbs + j] = kv[sl * lay.kbs + j] > 0.f ? 0.f : -1e9f;
    }
    rope_row4<D>(k, a.cos_t + j * D, a.sin_t + j * D);
    float4* kd = reinterpret_cast<float4*>(Ks + (size_t)(sl * a.hg + hl) * lay.hs + j * D);
#pragma unroll
    for (int d = 0; d < D / 4; ++d)
      kd[d] = make_float4(k[4 * d], k[4 * d + 1], k[4 * d + 2], k[4 * d + 3]);
  }
  __syncthreads();
  // a thread per (sequence, head, query)
  for (int e = threadIdx.x; e < U.ns * U.nh * N; e += SHORT_THREADS) {
    const int n = e % N, r = e / N, hl = r % U.nh, sl = r / U.nh, h = U.h0 + hl;
    float q[D], acc[D];
    bf16* qs = raw + (size_t)(sl * N + n) * 3 * hgd + hl * D;
    unpack_row<D>(qs, q);
    rope_row4<D>(q, a.cos_t + n * D, a.sin_t + n * D);
    attend_short<D>(q, Ks + (size_t)(sl * a.hg + hl) * lay.hs, Kb + sl * lay.kbs,
                    raw + (size_t)(sl * N * 3 + 2) * hgd + hl * D, 3 * hgd, Kq + h * D,
                    Kq + (a.H + h) * D, N, a.base2, acc);
    uint4* dst = reinterpret_cast<uint4*>(qs);  // this thread's q slice, read above
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      uint4 w;
      uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(acc[8 * c + 2 * e2], acc[8 * c + 2 * e2 + 1]);
        wp[e2] = *reinterpret_cast<const uint32_t*>(&p);
      }
      dst[c] = w;
    }
  }
  __syncthreads();
  // out: 16-byte stores, the threads on consecutive chunks of each token's slice
  const int segc = U.nh * D / 8;
  if (contiguous(a, U)) {
    bf16* dst = a.out + U.s0 * N * (long long)a.C;
    for (int e = threadIdx.x; e < U.ns * N * segc; e += SHORT_THREADS) {
      const int c = e % segc, tok = e / segc;
      reinterpret_cast<uint4*>(dst)[e] = *reinterpret_cast<const uint4*>(raw + (size_t)tok * 3 * hgd + c * 8);
    }
  } else {
    for (int e = threadIdx.x; e < U.ns * N * segc; e += SHORT_THREADS) {
      const int c = e % segc, tok = e / segc;
      const long long row = token_row(a, U.s0 + tok / N, tok % N);
      *reinterpret_cast<uint4*>(a.out + row * a.C + U.h0 * D + c * 8) =
          *reinterpret_cast<const uint4*>(raw + (size_t)tok * 3 * hgd + c * 8);
    }
  }
  __syncthreads();  // the raw buffer (now the output) is read: it may be refilled
}

// the standalone kernel's walk: units u0, u0 + stride, ... with the next
// unit's span in flight (the second raw buffer) while this one is computed
template <int D>
__device__ __forceinline__ void short_stream(const ShortArgs& a, long long u, long long stride,
                                             unsigned char* sm) {
  const ShortLayout lay(a.spb, a.hg, a.N, D, 2, a.H);
  bf16* raw0 = reinterpret_cast<bf16*>(sm);
  const size_t rb = lay.raw / 2;  // a raw buffer's bf16 elements
  if (u >= a.units) return;
  load_unit<D>(a, unit_of(a, u), raw0, lay);
  cp_commit();
  stage_bias<D>(a, lay, sm);
  for (int k = 0; u < a.units; u += stride, k ^= 1) {
    if (u + stride < a.units) load_unit<D>(a, unit_of(a, u + stride), raw0 + (k ^ 1) * rb, lay);
    cp_commit();
    cp_wait<1>();  // this unit's span has landed (the next one's may not have)
    __syncthreads();
    unit_body<D>(a, unit_of(a, u), raw0 + k * rb, lay, sm);
  }
  cp_wait<0>();
}

// one unit, one raw buffer: a virtual block of the merged layer backward
template <int D>
__device__ __forceinline__ void short_unit(const ShortArgs& a, long long u, unsigned char* sm) {
  const ShortLayout lay(a.spb, a.hg, a.N, D, 1, a.H);
  const Unit U = unit_of(a, u);
  bf16* raw = reinterpret_cast<bf16*>(sm);
  load_unit<D>(a, U, raw, lay);
  cp_commit();
  stage_bias<D>(a, lay, sm);
  cp_wait<0>();
  __syncthreads();
  unit_body<D>(a, U, raw, lay, sm);
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


// the launch shape of a call: short (N <= 16: units of spb sequences x hg
// heads, nbuf raw buffers: 2 streaming, 1 in the merged layer backward;
// ops/rope_attention.py::short_plan) or long (a
// block per (sequence, head)); blocks (short: units), threads, dynamic shared
// memory of a block; blocks 0 for a plan the short body does not take
struct Shape {
  bool short_seq;
  unsigned blocks, threads;
  size_t smem;
  int spb, hg;
};

__host__ __device__ inline Shape shape(int G, int N, int I, int H, int D, int spb, int hg,
                                       int nbuf) {
  Shape s;
  s.short_seq = N <= 16;
  s.spb = spb;
  s.hg = hg;
  if (s.short_seq) {
    const bool ok = N >= 1 && spb >= 1 && hg >= 1 && hg <= H && (nbuf == 1 || nbuf == 2);
    s.smem = ok ? ShortLayout(spb, hg, N, D, nbuf, H).total : 0;
    const long long units = ok ? ((long long)G * I + spb - 1) / spb * ((H + hg - 1) / hg) : 0;
    s.blocks = units > 0x7fffffffLL ? 0u : (unsigned)units;
    s.threads = SHORT_THREADS;
  } else {
    s.smem = LongLayout(N, D).total;
    s.blocks = (unsigned)((long long)G * I * H);
    s.threads = LONG_THREADS;
  }
  return s;
}

// virtual block bx of a call (the merged layer backward's walk): a short
// unit (one raw buffer) or a long (sequence, head)
template <int D>
__device__ __forceinline__ void block(const Shape& sh, const bf16* qkv, const bf16* bias_k,
                                      const bf16* bias_v, const float* key_valid,
                                      const float* cos_t, const float* sin_t, bf16* out, int G,
                                      int N, int I, int H, int C, int base2, int bx,
                                      unsigned char* smem) {
  if (sh.short_seq)
    short_unit<D>(short_args(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C,
                             base2, sh.spb, sh.hg),
                  bx, smem);
  else
    long_block<D>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, bx,
                  reinterpret_cast<float*>(smem));
}

}  // namespace ropefwd
