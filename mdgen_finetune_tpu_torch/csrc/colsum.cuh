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
// Every form adds the same sums in the same order.
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

inline int launch(const float* in, float* out, long long R, long long W, long long row_w,
                  long long ld_out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((W + COLS - 1) / COLS);
  colsum_kernel<<<blocks, COLS * LANES, 0, stream>>>(in, out, R, W, row_w, ld_out);
  return (int)cudaGetLastError();
}

}  // namespace colsum
