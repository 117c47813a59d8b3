// linear_bwd: the two products of a projection's backward, bf16 operands,
// f32 accumulation.
//
// Replaces the products inside the three stage backward kernels of
// mdgen_finetune_tpu/ops/fused_layer_bwd.py (_k3 :157, _k2 :323, _k1 :474):
// every `_mm` (:92) of a data gradient and every weight-gradient sum `_acc`
// (:97) that the TPU carried across its sequential batch grid.
//
//   dgrad  dX (M, K) = P(dY) (M, N) . W (K, N)^T, optionally times
//          gelu_fast'(act) of the recomputed f32 pre-activation act (M, K)
//          (:145); written f32 or bf16;
//   wgrad  dW (K, N) = P(A)^T . P(dY) and db (N) = colsum P(dY), f32 sums
//          over all M rows; P(A) = bf16(modulate(LN(X), shift, scale)) when
//          ln is set (LN non-affine, eps 1e-6, recomputed from the saved
//          stage input X so that the modulated activation is never stored).
// P(dY) = bf16(dY * gate[row / rows_per_gate]) when a gate is given, else
// dY rounded to bf16 (:140, :260, :423).
//
// What bounds it on the H100: at the training shapes (M = B*T*L = 12,800,
// K, N in {384, 1,152, 1,536}) each product is 2*M*K*N = 3.8e9-1.5e10 FLOP
// against 10-80 MB, 150-400 FLOP per byte: near or above the 295 FLOP/byte
// ridge, so the tensor cores bound the big ones. This first version is a
// simple tiling that is right: 64x64 output tiles, four warps of 2x2 WMMA
// (mma.sync) 16x16x16 fragments, operands staged in shared memory with
// 16-byte loads, the gate / LayerNorm / modulate prologue applied while
// staging and the GELU-derivative epilogue fused, so no gated, normalised or
// activated tensor goes to device memory. No wgmma, TMA or multi-stage ring
// yet (later work).
//
// The wgrad sum over M: the TPU accumulated it in place across its
// sequential grid; Hopper's blocks run in parallel, so the M rows are split
// into S contiguous ranges, each (k-tile, n-tile, split) block writes its f32
// partial tile, and colsum.cuh adds the S partials in a fixed order:
// deterministic, no atomics. The LayerNorm statistics of the M rows are
// computed once by a first pass (row_stats_kernel) into the scratch buffer.
//
// The block bodies live in linear_bwd.cuh, which the merged layer backward
// (fused_layer_bwd.cu) includes too.

#include "colsum.cuh"
#include "linear_bwd.cuh"

namespace {

using namespace lbwd;

__global__ void __launch_bounds__(THREADS) dgrad_kernel(Args a) {
  __shared__ __align__(128) unsigned char smem[DGRAD_SMEM];
  dgrad_block(a, blockIdx.x, blockIdx.y, smem);
}

__global__ void __launch_bounds__(THREADS) row_stats_kernel(Args a) {
  row_stats_block(a, blockIdx.x);
}

__global__ void __launch_bounds__(THREADS) wgrad_kernel(Args a) {
  __shared__ __align__(128) unsigned char smem[WGRAD_SMEM];
  wgrad_block(a, blockIdx.x, blockIdx.y, blockIdx.z, smem);
}

}  // namespace

extern "C" int linear_bwd(int mode,
                          const void* dy, int dy_f32, long long ld_dy,
                          const void* gate, long long ld_gate, int rows_per_gate,
                          const void* x, long long ld_x, const void* act, long long ld_act,
                          int ln, const void* shift, const void* scale, long long ld_mod,
                          int rows_per_mod,
                          void* out, int out_f32, long long ld_out, void* db, void* scratch,
                          int splits, int M, int N, int K, void* stream) {
  const Args a = make_args(mode, dy, dy_f32, ld_dy, gate, ld_gate, rows_per_gate, x, ld_x, act,
                           ld_act, ln, shift, scale, ld_mod, rows_per_mod, out, out_f32, ld_out,
                           scratch, splits, M, N, K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    dgrad_kernel<<<dgrad_grid(a), THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  if (ln) {
    row_stats_kernel<<<stats_blocks(a), THREADS, 0, s>>>(a);
    int e = (int)cudaGetLastError();
    if (e) return e;
  }
  wgrad_kernel<<<wgrad_grid(a), THREADS, 0, s>>>(a);
  int e = (int)cudaGetLastError();
  if (e) return e;
  e = colsum::launch(a.part, static_cast<float*>(out), a.splits, (long long)K * N,
                     (long long)K * N, 0, s);
  if (e) return e;
  return colsum::launch(a.part_db, static_cast<float*>(db), a.splits, N, N, 0, s);
}
