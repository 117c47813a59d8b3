// modln_bwd: the adjoint of LayerNorm + AdaLN modulate, fused with the
// residual add of a trunk stage and the stage's AdaLN-row gradients.
//
// Replaces, inside the stage backward kernels of
// mdgen_finetune_tpu/ops/fused_layer_bwd.py (_k3 :157, _k2 :323, _k1 :474):
// `_modln_bwd` (:79-89) with the recompute of `_modln_fwd` (:66-76), the
// gate gradient `dg = sum(dOUT * y)` (:139, :259, :422) and the residual add
// `dOUT + dx_ln` (:154, :320, :471).
//
// Per row r of batch element b (rows of b: b * R .. b * R + R - 1):
//   mean, rstd, h_hat = LN(x_r) in f32 (non-affine, eps 1e-6);
//   dhh = dh_r * (1 + scale_b);  m1 = mean(dhh);  m2 = mean(dhh * h_hat);
//   dx_r = dout_r + rstd * (dhh - m1 - h_hat * m2);
// and per element b, over its R rows, in f32:
//   dsh_b = sum dh,  dsc_b = sum dh * h_hat,  dg_b = sum dout * y,
// written as one (3C) row [dsh | dsc | dg] of dmod (row stride ld_dmod).
//
// What bounds it on the H100: it reads x (bf16), dh, dout and y (f32) and
// writes dx (f32), 18 bytes per element against ~20 FLOP: memory-bound
// (12,800 x 384 rows at the training shape: 88 MB, 0.026 ms at 3.35 TB/s).
// Design: a warp owns a row at a time (a lane owns columns lane, lane + 32,
// ...), so the row statistics are warp shuffles and the row is read from L1
// on the later passes; each warp accumulates its rows' column sums in its
// own slice of shared memory (lanes own distinct columns: no atomics), the
// block adds its warps' slices in a fixed order into one partial per
// (split, element), and colsum.cuh adds the splits in a fixed order: the
// per-element sums are deterministic. A grid of (elements x splits) blocks
// keeps the 132 SMs busy although there are only B = 32 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "colsum.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename XT>
__global__ void __launch_bounds__(WARPS * 32) modln_bwd_kernel(
    const XT* __restrict__ x, long long ldx, const float* __restrict__ dh,
    const float* __restrict__ dout, const float* __restrict__ y,
    const bf16* __restrict__ scale, long long ld_mod, float* __restrict__ dx,
    float* __restrict__ part, int C, int nb, int rows, int rows_per_split) {
  extern __shared__ float acc[];  // [WARPS][3][C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x, s = blockIdx.y;
  float* mine = acc + (size_t)warp * 3 * C;
  for (int i = threadIdx.x; i < WARPS * 3 * C; i += WARPS * 32) acc[i] = 0.f;
  __syncthreads();

  const bf16* sc = scale + (long long)b * ld_mod;
  const int r_lo = s * rows_per_split, r_hi = min(rows, r_lo + rows_per_split);
  const float inv_c = 1.0f / C;
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
  __syncthreads();
  float* out = part + ((long long)s * nb + b) * 3 * C;
  for (int i = threadIdx.x; i < 3 * C; i += WARPS * 32) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += acc[w * 3 * C + i];
    out[i] = t;
  }
}

}  // namespace

extern "C" int modln_bwd(const void* x, long long ldx, const void* dh, const void* dout,
                         const void* y, const void* scale, long long ld_mod, void* dx,
                         void* dmod, long long ld_dmod, void* scratch, int x_f32, int M,
                         int C, int nb, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = M / nb;
  splits = splits > 0 ? splits : 1;
  const int rows_per_split = (rows + splits - 1) / splits;
  const size_t smem = (size_t)WARPS * 3 * C * sizeof(float);
  dim3 grid(nb, splits);
  float* part = static_cast<float*>(scratch);
  cudaError_t e;
  if (x_f32) {
    e = cudaFuncSetAttribute(modln_bwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    modln_bwd_kernel<float><<<grid, WARPS * 32, smem, s>>>(
        static_cast<const float*>(x), ldx, static_cast<const float*>(dh),
        static_cast<const float*>(dout), static_cast<const float*>(y),
        static_cast<const bf16*>(scale), ld_mod, static_cast<float*>(dx), part, C, nb, rows,
        rows_per_split);
  } else {
    e = cudaFuncSetAttribute(modln_bwd_kernel<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    modln_bwd_kernel<bf16><<<grid, WARPS * 32, smem, s>>>(
        static_cast<const bf16*>(x), ldx, static_cast<const float*>(dh),
        static_cast<const float*>(dout), static_cast<const float*>(y),
        static_cast<const bf16*>(scale), ld_mod, static_cast<float*>(dx), part, C, nb, rows,
        rows_per_split);
  }
  int err = (int)cudaGetLastError();
  if (err) return err;
  return colsum::launch(part, static_cast<float*>(dmod), splits, (long long)nb * 3 * C,
                        3LL * C, ld_dmod, s);
}
