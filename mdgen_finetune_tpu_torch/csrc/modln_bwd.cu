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
//
// The block body lives in modln_bwd.cuh, which the merged layer backward
// (fused_layer_bwd.cu) includes too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "colsum.cuh"
#include "modln_bwd.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using modln::WARPS;

template <typename XT>
__global__ void __launch_bounds__(WARPS * 32) modln_bwd_kernel(
    const XT* __restrict__ x, long long ldx, const float* __restrict__ dh,
    const float* __restrict__ dout, const float* __restrict__ y,
    const bf16* __restrict__ scale, long long ld_mod, float* __restrict__ dx,
    float* __restrict__ part, int C, int nb, int rows, int rows_per_split) {
  extern __shared__ float acc[];  // [WARPS][3][C]
  modln::block<XT, WARPS * 32>(x, ldx, dh, dout, y, scale, ld_mod, dx, part, C, nb, rows,
                               rows_per_split, blockIdx.x, blockIdx.y, acc);
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
