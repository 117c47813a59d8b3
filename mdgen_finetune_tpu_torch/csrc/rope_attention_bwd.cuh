// rope_attention_bwd.cuh: the block body of rope_attention_bwd.cu (the
// design note is there) as a device function over a block index and a
// shared-memory buffer, so that rope_attention_bwd.cu and the merged layer
// backward (fused_layer_bwd.cu) run the same code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ropebwd {

typedef __nv_bfloat16 bf16;


constexpr int THREADS = 128;
constexpr float LN2F = 0.6931471805599453f;

// per head: q[N][D], dO[N][D], k[NK][D], v[NK][D], kbias[NK], inv[N], rsum[N]
__host__ __device__ constexpr int head_floats(int N, int D) {
  return 2 * N * D + 2 * (N + 1) * D + (N + 1) + 2 * N;
}

template <int D>
__device__ __forceinline__ void rope_row(float* v, const float* cs, const float* sn) {
  float r[D];
#pragma unroll
  for (int d = 0; d < D; ++d) r[d] = d < D / 2 ? -v[d + D / 2] : v[d - D / 2];
#pragma unroll
  for (int d = 0; d < D; ++d) v[d] = v[d] * cs[d] + r[d] * sn[d];
}

// the transpose of rope_row: g * cos + rot^T(g * sin), rot^T(a, b) = (b, -a)
template <int D>
__device__ __forceinline__ void rope_row_t(float* g, const float* cs, const float* sn) {
  float t[D];
#pragma unroll
  for (int d = 0; d < D; ++d) t[d] = d < D / 2 ? g[d + D / 2] * sn[d + D / 2] : -g[d - D / 2] * sn[d - D / 2];
#pragma unroll
  for (int d = 0; d < D; ++d) g[d] = g[d] * cs[d] + t[d];
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
}

template <int D>
__device__ __forceinline__ void block(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
    const bf16* __restrict__ bias_k, const bf16* __restrict__ bias_v,
    const float* __restrict__ key_valid, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, bf16* __restrict__ dqkv, float* __restrict__ part,
    int N, int I, int H, int C, int HPB, int bx, float* smem) {
  const int NK = N + 1, hf = head_floats(N, D);
  const int groups = (H + HPB - 1) / HPB;
  const long long seq = bx / groups;
  const int h0 = (int)(bx % groups) * HPB;
  const long long g = seq / I, i = seq % I;
  const long long row0 = g * N * I + i;  // row of token n: row0 + n * I
  const int nh = min(HPB, H - h0);

  auto Qs = [&](int hl) { return smem + (size_t)hl * hf; };
  auto dOs = [&](int hl) { return Qs(hl) + N * D; };
  auto Ks = [&](int hl) { return dOs(hl) + N * D; };
  auto Vs = [&](int hl) { return Ks(hl) + NK * D; };
  auto Kb = [&](int hl) { return Vs(hl) + NK * D; };
  auto Inv = [&](int hl) { return Kb(hl) + NK; };
  auto Rs = [&](int hl) { return Inv(hl) + N; };

  // ---- stage q, dO (query rows) and k, v (key rows, the bias token at N) ----
  for (int t = threadIdx.x; t < nh * NK; t += THREADS) {
    const int hl = t / NK, n = t % NK, h = h0 + hl;
    float kv[D], vv[D];
    if (n < N) {
      const long long row = row0 + (long long)n * I;
      const bf16* src = qkv + row * 3LL * C + h * D;
      const bf16* go = dout + row * C + h * D;
      float qv[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qv[d] = __bfloat162float(src[d]);
        kv[d] = __bfloat162float(src[C + d]);
        vv[d] = __bfloat162float(src[2 * C + d]);
        dOs(hl)[n * D + d] = __bfloat162float(go[d]);
      }
      rope_row<D>(qv, cos_t + n * D, sin_t + n * D);
#pragma unroll
      for (int d = 0; d < D; ++d) Qs(hl)[n * D + d] = qv[d];
      Kb(hl)[n] = key_valid[row] > 0.f ? 0.f : -1e9f;
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        kv[d] = __bfloat162float(bias_k[h * D + d]);
        vv[d] = __bfloat162float(bias_v[h * D + d]);
      }
      Kb(hl)[n] = 0.f;
    }
    rope_row<D>(kv, cos_t + n * D, sin_t + n * D);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      Ks(hl)[n * D + d] = kv[d];
      Vs(hl)[n * D + d] = vv[d];
    }
  }
  __syncthreads();

  // ---- phase A: one (head, query) row per thread: statistics, then dq ----
  for (int t = threadIdx.x; t < nh * N; t += THREADS) {
    const int hl = t / N, n = t % N, h = h0 + hl;
    const float* q = Qs(hl) + n * D;
    const float* go = dOs(hl) + n * D;
    const float *K = Ks(hl), *V = Vs(hl), *kb = Kb(hl);
    float den = 0.f, sdp = 0.f;
    for (int j = 0; j < NK; ++j) {
      const float e = exp2f(fminf(dot<D>(q, K + j * D) + kb[j], 100.f));
      den += e;
      sdp += e * dot<D>(go, V + j * D);
    }
    const float inv = 1.f / (den + 1e-30f), rsum = sdp * inv;
    Inv(hl)[n] = inv;
    Rs(hl)[n] = rsum;
    float dq[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dq[d] = 0.f;
    for (int j = 0; j < NK; ++j) {
      const float p = exp2f(fminf(dot<D>(q, K + j * D) + kb[j], 100.f)) * inv;
      const float dl = LN2F * p * (dot<D>(go, V + j * D) - rsum);
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] += dl * K[j * D + d];
    }
    rope_row_t<D>(dq, cos_t + n * D, sin_t + n * D);
    bf16* dst = dqkv + (row0 + (long long)n * I) * 3LL * C + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) dst[d] = __float2bfloat16(dq[d]);
  }
  __syncthreads();

  // ---- phase B: one (head, key) column per thread: dk, dv ----
  for (int t = threadIdx.x; t < nh * NK; t += THREADS) {
    const int hl = t / NK, j = t % NK, h = h0 + hl;
    const float *Q = Qs(hl), *dO = dOs(hl);
    float k[D], v[D], dk[D], dv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      k[d] = Ks(hl)[j * D + d];
      v[d] = Vs(hl)[j * D + d];
      dk[d] = 0.f;
      dv[d] = 0.f;
    }
    const float kbj = Kb(hl)[j];
    for (int n = 0; n < N; ++n) {
      const float p = exp2f(fminf(dot<D>(Q + n * D, k) + kbj, 100.f)) * Inv(hl)[n];
      const float dl = LN2F * p * (dot<D>(dO + n * D, v) - Rs(hl)[n]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dk[d] += dl * Q[n * D + d];
        dv[d] += p * dO[n * D + d];
      }
    }
    rope_row_t<D>(dk, cos_t + j * D, sin_t + j * D);
    if (j < N) {
      bf16* dst = dqkv + (row0 + (long long)j * I) * 3LL * C + h * D;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dst[C + d] = __float2bfloat16(dk[d]);
        dst[2 * C + d] = __float2bfloat16(dv[d]);
      }
    } else {
      float* pb = part + seq * 2LL * C + h * D;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        pb[d] = dk[d];
        pb[C + d] = dv[d];
      }
    }
  }
}

// heads per block (N <= 16: up to 128 / (N + 1), so the threads are not
// idle), blocks and dynamic shared memory of a call over S = G * I sequences
__host__ __device__ inline int heads_per_block(int N, int H) {
  return N <= 16 ? max(1, min(H, THREADS / (N + 1))) : 1;
}
__host__ __device__ inline size_t smem_bytes(int N, int H, int D) {
  return (size_t)heads_per_block(N, H) * head_floats(N, D) * sizeof(float);
}
__host__ __device__ inline unsigned blocks(long long S, int N, int H) {
  const int HPB = heads_per_block(N, H);
  return (unsigned)(S * ((H + HPB - 1) / HPB));
}

}  // namespace ropebwd
