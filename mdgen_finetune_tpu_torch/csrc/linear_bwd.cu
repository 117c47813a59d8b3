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
// ridge, so the tensor cores bound the big ones.
//
// Design: 128 x 128 output tiles, four warps of 64 x 64 (mma.sync m16n8k16,
// bf16 in, f32 accumulators, fragments through ldmatrix: plain for operands
// staged [tile][reduction], .trans for those staged [reduction][tile], so
// no operand is transposed in memory), the reduction in chunks of 32
// through a 4-stage ring of cp.async copies, so that the next three chunks
// load while the tensor cores take this one. The copies move bytes only, so
// a prologue that is not the identity (P(dY) = bf16(dY * gate) of an f32
// or gated dY; P(A) = bf16(modulate(LN(X)))) runs first as a pass of its
// own, once per element, into a bf16 buffer at the end of the scratch
// (prologue_kernel; 9.8 MB at fc1's P(A)), and the GEMM takes plain bf16
// operands. Applied per staged chunk in shared memory instead, its loads of
// the gate, shift, scale and row statistics sat on every chunk's critical
// path (the first build of this design: fc1 wgrad 0.36 ms against 0.13).
// The GELU-derivative epilogue is fused, and the outputs go to memory in
// pairs straight from the accumulators. db is summed on the tensor cores:
// a fragment of ones times the dY fragments the warps already hold, on the
// wgrad's first k-tile, alternate 16-row steps in the two warps of a column
// half, added in a fixed order. Shared memory: 81,920 bytes per dgrad
// block, 69,632 per wgrad block (2 blocks per SM at ~250 registers; the
// merged layer backward's 85,504-byte slot holds either). No wgmma or TMA:
// a build without the products ran nearly as long as the kernel, so the
// copies of the 128 x 128 tiles' operands through L2, not the tensor
// cores, bound it at these shapes.
//
// The wgrad sum over M: the TPU accumulated it in place across its
// sequential grid; Hopper's blocks run in parallel, so the M rows are split
// into S contiguous ranges (ops/linear_bwd.py::_splits: about two blocks per
// SM), each (k-tile, n-tile, split) block writes its f32 partial tile, and
// colsum.cuh adds the S partials in a fixed order: deterministic, no
// atomics. The LayerNorm statistics of the M rows are computed once by a
// first pass (row_stats_kernel) into the scratch buffer.
//
// The block bodies live in linear_bwd.cuh, which the merged layer backward
// (fused_layer_bwd.cu) includes too.

#include "colsum.cuh"
#include "linear_bwd.cuh"

namespace {

using namespace lbwd;

__global__ void __launch_bounds__(THREADS, 2) dgrad_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  dgrad_block(a, blockIdx.x, blockIdx.y, smem);
}

__global__ void __launch_bounds__(THREADS) row_stats_kernel(Args a) {
  row_stats_block(a, blockIdx.x);
}

__global__ void __launch_bounds__(THREADS) prologue_kernel(Args a) {
  prologue_block(a, blockIdx.x);
}

__global__ void __launch_bounds__(THREADS, 2) wgrad_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  wgrad_block(a, blockIdx.x, blockIdx.y, blockIdx.z, smem);
}

template <class K>
int resources_of(K kern, size_t smem, long long* info) {
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = fa.numRegs;
  info[1] = (long long)fa.localSizeBytes;
  info[2] = (long long)smem;
  info[3] = per_sm;
  return 0;
}

}  // namespace

// the resources of the dgrad (mode 0) or wgrad (mode 1) kernel: info[0]
// registers per thread, [1] local (spill) bytes per thread, [2] dynamic
// shared memory per block, [3] resident blocks per SM
extern "C" int linear_bwd_resources(int mode, long long* info) {
  return mode == 0 ? resources_of(dgrad_kernel, DGRAD_SMEM, info)
                   : resources_of(wgrad_kernel, WGRAD_SMEM, info);
}

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
  // the prologue's buffers: at the end of the scratch, P(dY) then P(A)
  bf16* tail = reinterpret_cast<bf16*>(
      mode == 0 ? static_cast<float*>(scratch) : a.stats + (2LL * M + 3) / 4 * 4);
  const Args p = with_prologue(a, tail, tail + ((dy_f32 || gate != nullptr) ? (long long)M * N : 0));
  const Args b = gemm_args(p);
  int e = 0;
  if (p.pa != nullptr) {
    row_stats_kernel<<<stats_blocks(p), THREADS, 0, s>>>(p);
    if ((e = (int)cudaGetLastError())) return e;
  }
  if (prologue_chunks(p) > 0) {
    prologue_kernel<<<prologue_blocks(p), THREADS, 0, s>>>(p);
    if ((e = (int)cudaGetLastError())) return e;
  }
  if (mode == 0) {
    e = (int)cudaFuncSetAttribute(dgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)DGRAD_SMEM);
    if (e) return e;
    dgrad_kernel<<<dgrad_grid(b), THREADS, DGRAD_SMEM, s>>>(b);
    return (int)cudaGetLastError();
  }
  e = (int)cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)WGRAD_SMEM);
  if (e) return e;
  wgrad_kernel<<<wgrad_grid(b), THREADS, WGRAD_SMEM, s>>>(b);
  if ((e = (int)cudaGetLastError())) return e;
  e = colsum::launch(a.part, static_cast<float*>(out), a.splits, (long long)K * N,
                     (long long)K * N, 0, s);
  if (e) return e;
  return colsum::launch(a.part_db, static_cast<float*>(db), a.splits, N, N, 0, s);
}
