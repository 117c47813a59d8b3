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
// So the design is about bytes in flight and nothing else.
//
// The reduction tree (it fixes the bits, and the grid does not change it):
// element b's rows are cut into `splits` runs of rows_per_split
// (ops/modln_bwd.py::_splits); each run belongs to eight virtual warps,
// virtual warp w summing rows r_lo + w, r_lo + w + 8, ... in order; lane l
// owns columns l, l + 32, ... (the row statistics: its columns in order,
// then the xor tree of warp_sum); the eight virtual warps' sums are added
// 0..7, and the runs in colsum.cuh's lane order. The body lives in
// modln_bwd.cuh, which the merged layer backward (fused_layer_bwd.cu) runs
// too (4 warps a block, each taking two virtual warps in turn). Every
// product and sum of the staged body is pinned to the rounding that the
// first version compiles to (__fmul_rn / __fadd_rn / __fmaf_rn: ptxas fuses
// dh * (1 + scale) into dx's first subtraction but not into m1), so the two
// give the same bits.
//
// Design: a block of eight warps takes one (element, run), a warp a virtual
// warp. What held the first version back was bytes in flight: 4-byte loads
// in four dependent passes, dout and y not asked for before the row's
// statistics were known. Here each warp stages a row's x, dh, dout and y in
// shared memory with 16-byte cp.async (plain copies where a row is not
// 16-byte aligned), all four issued before its first reduction, and waits
// for dout and y only after the statistics; the passes read shared memory.
// The column sums stay in registers (3 x J a lane, C <= 32 J) and reach
// shared memory once, in the warp's staging area; 1 + scale_b is formed once
// per block. At C = 384, 14 C bytes a warp (44.5 KB a block) and <= 85
// registers let three blocks share an SM, so the flagship's 288 blocks are
// resident at once; wider rows (J = 16, up to C = 512, the merged layer
// backward's limit too) take two blocks an SM, so that their sums stay in
// registers.
// colsum::launch adds the runs' partials, a second launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "colsum.cuh"
#include "modln_bwd.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using modln::WARPS;

constexpr int THREADS = WARPS * 32;  // a real warp per virtual warp

// blocks an SM that the register budget is set for: all of the flagship's
// 288 blocks resident at C <= 384, fewer where the sums take more registers
constexpr int min_blocks(int J) { return J <= 12 ? 3 : 2; }

template <typename XT, int J>
__global__ void __launch_bounds__(THREADS, min_blocks(J)) modln_bwd_kernel(
    const XT* __restrict__ x, long long ldx, const float* __restrict__ dh,
    const float* __restrict__ dout, const float* __restrict__ y,
    const bf16* __restrict__ scale, long long ld_mod, float* __restrict__ dx,
    float* __restrict__ part, int C, int nb, int rows, int rows_per_split, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  modln::block<XT, J, THREADS>(x, ldx, dh, dout, y, scale, ld_mod, dx, part, C, nb, rows,
                               rows_per_split, blockIdx.x, blockIdx.y, vec, smem);
}

// f(J) with J the columns a lane holds at width C (C <= MAX_C)
constexpr int MAX_C = 512;
template <typename F>
int by_width(int C, F f) {
  if (C <= 128) return f(std::integral_constant<int, 4>{});
  if (C <= 256) return f(std::integral_constant<int, 8>{});
  if (C <= 384) return f(std::integral_constant<int, 12>{});
  if (C <= MAX_C) return f(std::integral_constant<int, 16>{});
  return (int)cudaErrorInvalidValue;
}

// cudaFuncSetAttribute once per kernel and device (above 48 KB of shared
// memory only), not on every call
template <auto K>
int allow_smem(size_t smem) {
  static int set_bytes[64] = {};
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && set_bytes[dev] >= (int)smem) return 0;
  e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64) set_bytes[dev] = (int)smem;
  return 0;
}

template <typename XT>
int launch(const void* x, long long ldx, const void* dh, const void* dout, const void* y,
           const void* scale, long long ld_mod, void* dx, float* part, int C, int nb, int rows,
           int rows_per_split, int splits, int vec, cudaStream_t s) {
  return by_width(C, [&](auto j) {
    constexpr int J = decltype(j)::value;
    const size_t smem = modln::smem_bytes<XT, THREADS>(C);
    int e = allow_smem<modln_bwd_kernel<XT, J>>(smem);
    if (e) return e;
    modln_bwd_kernel<XT, J><<<dim3(nb, splits), THREADS, smem, s>>>(
        static_cast<const XT*>(x), ldx, static_cast<const float*>(dh),
        static_cast<const float*>(dout), static_cast<const float*>(y),
        static_cast<const bf16*>(scale), ld_mod, static_cast<float*>(dx), part, C, nb, rows,
        rows_per_split, vec);
    return (int)cudaGetLastError();
  });
}

template <typename XT>
int resources(int C, long long* info) {
  return by_width(C, [&](auto j) {
    constexpr auto K = modln_bwd_kernel<XT, decltype(j)::value>;
    const size_t smem = modln::smem_bytes<XT, THREADS>(C);
    cudaFuncAttributes fa;
    int per_sm = 0;
    int e = allow_smem<K>(smem);
    if (e) return e;
    cudaError_t c = cudaFuncGetAttributes(&fa, K);
    if (c == cudaSuccess)
      c = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, THREADS, smem);
    if (c != cudaSuccess) return (int)c;
    info[0] = fa.numRegs;
    info[1] = (long long)fa.localSizeBytes;
    info[2] = (long long)smem;
    info[3] = per_sm;
    return 0;
  });
}

}  // namespace

// the resources of the kernel that a call at width C runs: info[0]
// registers per thread, [1] local (spill) bytes per thread, [2] dynamic
// shared memory per block, [3] resident blocks per SM
extern "C" int modln_bwd_resources(int x_f32, int C, long long* info) {
  return x_f32 ? resources<float>(C, info) : resources<bf16>(C, info);
}

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the parent's entry point and arguments (C <= 512): the staged kernel,
// then colsum::launch adds the runs' partials (`scratch`: splits x nb x 3C
// floats) into dmod
extern "C" int modln_bwd(const void* x, long long ldx, const void* dh, const void* dout,
                         const void* y, const void* scale, long long ld_mod, void* dx,
                         void* dmod, long long ld_dmod, void* scratch, int x_f32, int M,
                         int C, int nb, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = M / nb;
  splits = splits > 0 ? splits : 1;
  const int rows_per_split = (rows + splits - 1) / splits;
  float* part = static_cast<float*>(scratch);
  // 16-byte copies where every row starts on a 16-byte boundary
  const long long xb = x_f32 ? 4 : 2;
  const int vec = aligned16(x) && ldx * xb % 16 == 0 && C * xb % 16 == 0 && aligned16(dh) &&
                  aligned16(dout) && aligned16(y);
  int e = x_f32 ? launch<float>(x, ldx, dh, dout, y, scale, ld_mod, dx, part, C, nb, rows,
                                rows_per_split, splits, vec, s)
                : launch<bf16>(x, ldx, dh, dout, y, scale, ld_mod, dx, part, C, nb, rows,
                               rows_per_split, splits, vec, s);
  if (e) return e;
  return colsum::launch(part, static_cast<float*>(dmod), splits, (long long)nb * 3 * C, 3LL * C,
                        ld_dmod, s);
}
