// colsum.cuh: a deterministic column sum, the second pass of the backward
// kernels' cross-block reductions (the TPU kernels carried such sums across
// their sequential grid; Hopper's blocks run in no order, so each block
// writes a partial row and this pass adds the rows up in a fixed order).
//
//   out[(w / row_w) * ld_out + w % row_w] = sum over r of in[r * W + w]
//
// for R rows of W f32 columns. Lane ty of a column sums rows ty, ty + 8, ...
// in order (lane_sum), then the 8 lane sums are added in order (total), so
// the result does not depend on scheduling. A block takes NC columns x 8
// row lanes (block): colsum_kernel 32 columns, the merged layer backward
// (fused_layer_bwd.cu, 128-thread blocks) 16 where the rows are many; where
// they are few the merged kernel gives one thread a whole column (column).
// launch takes colsum_tall_kernel for tall narrow sums: 768 columns in
// 32-column blocks are 24 blocks for 132 SMs. Every form adds the same sums
// in the same order.
#pragma once

#include <cuda_runtime.h>

namespace colsum {

constexpr int COLS = 32, LANES = 8;

__device__ __forceinline__ float lane_sum(const float* __restrict__ in, long long R, long long W,
                                          long long w, int ty) {
  float s = 0.f;
  for (long long r = ty; r < R; r += LANES) s += in[r * W + w];
  return s;
}

__device__ __forceinline__ float total(const float* lanes, int stride) {
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < LANES; ++i) t += lanes[i * stride];
  return t;
}

__device__ __forceinline__ void store(float* __restrict__ out, long long w, long long row_w,
                                      long long ld_out, float t) {
  out[(w / row_w) * ld_out + w % row_w] = t;
}

// column w in one thread
__device__ __forceinline__ void column(const float* __restrict__ in, float* __restrict__ out,
                                       long long R, long long W, long long row_w,
                                       long long ld_out, long long w) {
  float lanes[LANES];
#pragma unroll
  for (int i = 0; i < LANES; ++i) lanes[i] = lane_sum(in, R, W, w, i);
  store(out, w, row_w, ld_out, total(lanes, 1));
}

// block bx of NC x LANES threads: columns bx * NC + tx, row lane ty; `part`
// holds LANES x (NC + 1) floats of shared memory
template <int NC>
__device__ __forceinline__ void block(const float* __restrict__ in, float* __restrict__ out,
                                      long long R, long long W, long long row_w, long long ld_out,
                                      long long bx, float* part) {
  const int tx = threadIdx.x % NC, ty = threadIdx.x / NC;
  const long long w = bx * NC + tx;
  part[ty * (NC + 1) + tx] = w < W ? lane_sum(in, R, W, w, ty) : 0.f;
  __syncthreads();
  if (ty == 0 && w < W) store(out, w, row_w, ld_out, total(part + tx, NC + 1));
}

__global__ void __launch_bounds__(COLS * LANES) colsum_kernel(
    const float* __restrict__ in, float* __restrict__ out, long long R, long long W,
    long long row_w, long long ld_out) {
  __shared__ float part[LANES * (COLS + 1)];
  block<COLS>(in, out, R, W, row_w, ld_out, blockIdx.x, part);
}

// tall sums (many rows, few columns: the attention backwards' per-sequence
// bias partials): a block of TALL_WARPS warps takes TALL_NC = 4 columns; all
// its threads bring up to TALL_ROWS rows of them into shared memory at once
// (16-byte cp.async where the rows allow, 4-byte loads else), then the
// first TALL_NC x 8 threads' lane ty adds its rows ty, ty + 8, ... from
// there; the next chunk of rows continues the same sums
constexpr int TALL_NC = 4, TALL_ROWS = 4096, TALL_WARPS = 4;  // 64 KB: the training path's 3,200 rows at once
constexpr size_t TALL_SMEM = (size_t)TALL_ROWS * TALL_NC * sizeof(float);

__global__ void __launch_bounds__(TALL_WARPS * 32) colsum_tall_kernel(
    const float* __restrict__ in, float* __restrict__ out, long long R, long long W,
    long long row_w, long long ld_out) {
  extern __shared__ __align__(16) float strip[];  // [TALL_ROWS][TALL_NC]
  __shared__ float part[LANES * (TALL_NC + 1)];
  const int tx = threadIdx.x % TALL_NC, ty = threadIdx.x / TALL_NC;  // ty < LANES: the summers
  const bool sums = threadIdx.x < TALL_NC * LANES;
  const long long w0 = (long long)blockIdx.x * TALL_NC, w = w0 + tx;
  const bool vec = w0 + TALL_NC <= W && W % 4 == 0 &&
                   (reinterpret_cast<unsigned long long>(in) & 15) == 0;
  float s = 0.f;
  for (long long r0 = 0; r0 < R; r0 += TALL_ROWS) {
    const int rows = (int)min((long long)TALL_ROWS, R - r0);
    __syncthreads();  // the last chunk's rows are read
    if (vec) {
      for (int i = threadIdx.x; i < rows; i += TALL_WARPS * 32)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         (unsigned)__cvta_generic_to_shared(strip + i * TALL_NC)),
                     "l"(in + (r0 + i) * W + w0)
                     : "memory");
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    } else {
      for (int i = threadIdx.x; i < rows * TALL_NC; i += TALL_WARPS * 32) {
        const long long c = w0 + i % TALL_NC;
        strip[i] = c < W ? in[(r0 + i / TALL_NC) * W + c] : 0.f;
      }
    }
    __syncthreads();
    if (sums)
      for (int i = ty; i < rows; i += LANES) s += strip[i * TALL_NC + tx];
  }
  if (sums) part[ty * (TALL_NC + 1) + tx] = s;
  __syncthreads();
  if (threadIdx.x < TALL_NC && w < W) store(out, w, row_w, ld_out, total(part + tx, TALL_NC + 1));
}

// tall sums (R >= 1,024 rows, W <= 4,096 columns: rope_attention_bwd's short
// body's per-sequence partials, 3,200 and 8,000 x 768 on the training
// paths) on colsum_tall_kernel, where it measured 22-31% faster than
// colsum_kernel (PERF.md); else colsum_kernel, which it trails at few rows
// (<= 128) and at many columns
inline int launch(const float* in, float* out, long long R, long long W, long long row_w,
                  long long ld_out, cudaStream_t stream) {
  if (R >= 1024 && W <= 4096) {
    cudaError_t e = cudaFuncSetAttribute(colsum_tall_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TALL_SMEM);
    if (e != cudaSuccess) return (int)e;
    colsum_tall_kernel<<<(unsigned)((W + TALL_NC - 1) / TALL_NC), TALL_WARPS * 32, TALL_SMEM,
                         stream>>>(in, out, R, W, row_w, ld_out);
  } else {
    colsum_kernel<<<(unsigned)((W + COLS - 1) / COLS), COLS * LANES, 0, stream>>>(
        in, out, R, W, row_w, ld_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace colsum
