// modln_bwd.cuh: the block body of modln_bwd.cu (the design note is there)
// as a device function over a block index (element b, split s) and a
// shared-memory buffer, so that modln_bwd.cu's kernel and the merged layer
// backward (fused_layer_bwd.cu) run the same code. The body is written for
// WARPS = 8 warps; a block of NT threads (NT / 32 warps) runs them as
// virtual warps, each real warp taking warps warp, warp + NT / 32, ... in
// turn: every virtual warp keeps its own rows and its own slice of the sums,
// so the result does not depend on NT.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace modln {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;

__host__ __device__ constexpr size_t smem_bytes(int C) { return (size_t)WARPS * 3 * C * sizeof(float); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename XT, int NT>
__device__ __forceinline__ void block(
    const XT* __restrict__ x, long long ldx, const float* __restrict__ dh,
    const float* __restrict__ dout, const float* __restrict__ y,
    const bf16* __restrict__ scale, long long ld_mod, float* __restrict__ dx,
    float* __restrict__ part, int C, int nb, int rows, int rows_per_split, int b, int s,
    float* acc /* shared, [WARPS][3][C] */) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < WARPS * 3 * C; i += NT) acc[i] = 0.f;
  __syncthreads();

  const bf16* sc = scale + (long long)b * ld_mod;
  const int r_lo = s * rows_per_split, r_hi = min(rows, r_lo + rows_per_split);
  const float inv_c = 1.0f / C;
  for (int warp = threadIdx.x >> 5; warp < WARPS; warp += NT / 32) {
    float* mine = acc + (size_t)warp * 3 * C;
    for (int rr = r_lo + warp; rr < r_hi; rr += WARPS) {
      const long long r = (long long)b * rows + rr;
      const XT* xr = x + r * ldx;
      const float* dhr = dh + r * C;
      float sum = 0.f;
      for (int c = lane; c < C; c += 32) sum += to_f(xr[c]);
      const float mean = warp_sum(sum) * inv_c;
      float var = 0.f;
      for (int c = lane; c < C; c += 32) {
        float d = to_f(xr[c]) - mean;
        var += d * d;
      }
      const float rstd = rsqrtf(warp_sum(var) * inv_c + 1e-6f);
      float m1 = 0.f, m2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        float hh = (to_f(xr[c]) - mean) * rstd;
        float dhh = dhr[c] * (1.0f + __bfloat162float(sc[c]));
        m1 += dhh;
        m2 += dhh * hh;
      }
      m1 = warp_sum(m1) * inv_c;
      m2 = warp_sum(m2) * inv_c;
      for (int c = lane; c < C; c += 32) {
        const float hh = (to_f(xr[c]) - mean) * rstd;
        const float g = dhr[c];
        const float dhh = g * (1.0f + __bfloat162float(sc[c]));
        const float go = dout[r * C + c];
        dx[r * C + c] = go + rstd * (dhh - m1 - hh * m2);
        mine[c] += g;
        mine[C + c] += g * hh;
        mine[2 * C + c] += go * y[r * C + c];
      }
    }
  }
  __syncthreads();
  float* out = part + ((long long)s * nb + b) * 3 * C;
  for (int i = threadIdx.x; i < 3 * C; i += NT) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += acc[w * 3 * C + i];
    out[i] = t;
  }
}

}  // namespace modln
