// colsum.cuh: a deterministic column sum, the second pass of the backward
// kernels' cross-block reductions (the TPU kernels carried such sums across
// their sequential grid; Hopper's blocks run in no order, so each block
// writes a partial row and this pass adds the rows up in a fixed order).
//
//   out[(w / row_w) * ld_out + w % row_w] = sum over r of in[r * W + w]
//
// for R rows of W f32 columns: a block of 32 columns x 8 row lanes; lane ty
// sums rows ty, ty + 8, ... in order, then the 8 lane sums are added in
// order, so the result does not depend on scheduling.
#pragma once

#include <cuda_runtime.h>

namespace colsum {

constexpr int COLS = 32, LANES = 8;

__global__ void __launch_bounds__(COLS * LANES) colsum_kernel(
    const float* __restrict__ in, float* __restrict__ out, long long R, long long W,
    long long row_w, long long ld_out) {
  __shared__ float part[LANES][COLS + 1];
  const int tx = threadIdx.x % COLS, ty = threadIdx.x / COLS;
  const long long w = (long long)blockIdx.x * COLS + tx;
  float s = 0.f;
  if (w < W)
    for (long long r = ty; r < R; r += LANES) s += in[r * W + w];
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && w < W) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < LANES; ++i) t += part[i][tx];
    out[(w / row_w) * ld_out + w % row_w] = t;
  }
}

inline int launch(const float* in, float* out, long long R, long long W, long long row_w,
                  long long ld_out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((W + COLS - 1) / COLS);
  colsum_kernel<<<blocks, COLS * LANES, 0, stream>>>(in, out, R, W, row_w, ld_out);
  return (int)cudaGetLastError();
}

}  // namespace colsum
