// rope_attention.cuh: the bodies of rope_attention.cu's two kernels (the
// design note is there) as device functions over a block index and a
// shared-memory buffer, so that rope_attention.cu and the merged layer
// backward (fused_layer_bwd.cu, which recomputes the trunk's attention
// outputs) run the same code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// long sequences: a block of 128 threads takes one (sequence, head); the
// keys are staged by all threads, then each thread owns one query row
template <int D>
__device__ __forceinline__ void long_block(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias_k,
    const bf16* __restrict__ bias_v, const float* __restrict__ key_valid,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    bf16* __restrict__ out, int G, int N, int I, int H, int C, int base2, int bx,
    float* smem) {
  const int tid = threadIdx.x;
  const long long task = bx;
  const int NK = N + 1;
  float* Ks = smem;
  float* Vs = Ks + NK * D;
  float* Kb = Vs + NK * D;
  const int h = (int)(task % H);
  const long long s = task / H, g = s / I, i = s % I;
  // row of token n: (g*N + n)*I + i
  const long long row0 = g * N * I + i;

  for (int n = tid; n < NK; n += LONG_THREADS)
    stage_key<D>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, row0 + (long long)(n < N ? n : 0) * I,
                 n, N, h, C, Ks, Vs, Kb);
  __syncthreads();

  for (int n = tid; n < N; n += LONG_THREADS) {
    float q[D], acc[D];
    const long long row = row0 + (long long)n * I;
    const bf16* src = qkv + row * 3LL * C + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = __bfloat162float(src[d]);
    rope_row<D>(q, cos_t + n * D, sin_t + n * D);
    attend_row<D>(q, Ks, Vs, Kb, NK, base2, acc);
    bf16* dst = out + row * C + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) dst[d] = __float2bfloat16(acc[d]);
  }
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
  s.smem = (s.short_seq ? (size_t)WARPS * HPW : 1) * head_floats(NK, D) * sizeof(float);
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
