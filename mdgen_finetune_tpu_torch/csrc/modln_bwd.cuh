// modln_bwd.cuh: the block body of modln_bwd.cu (the design note is there)
// as a device function over a block index (element b, run s) and a
// shared-memory buffer, so that modln_bwd.cu's kernel and the merged layer
// backward (fused_layer_bwd.cu) run the same code. The body is written for
// WARPS = 8 virtual warps; a block of NT threads (NT / 32 real warps) runs
// them in turn, real warp w taking virtual warps w, w + NT / 32, ...: every
// virtual warp keeps its own rows and its own sums, so the result does not
// depend on NT. J: the columns a lane holds (C <= 32 J).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace modln {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a real warp's staging area: a row's x, dh, dout and y, each array padded
// to 16 bytes (Cp: C rounded up to 8 elements)
template <typename XT>
__host__ __device__ constexpr size_t warp_bytes(int Cp) {
  return (size_t)Cp * (sizeof(XT) + 3 * sizeof(float));
}
__host__ __device__ constexpr int padded(int C) { return (C + 7) / 8 * 8; }

// shared memory of a block of NT threads: 1 + scale_b, the real warps'
// staging areas, and the virtual warps' sums ([WARPS][3][C]; with a real
// warp per virtual warp they live in its staging area once it is done)
template <typename XT, int NT>
__host__ __device__ constexpr size_t smem_bytes(int C) {
  return (size_t)padded(C) * sizeof(float) + (NT / 32) * warp_bytes<XT>(padded(C)) +
         (NT / 32 == WARPS ? 0 : (size_t)WARPS * 3 * C * sizeof(float));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one row of n elements from device memory to a warp's staging area:
// 16-byte cp.async by the warp's lanes where the rows allow (vec), else
// plain loads and stores
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int n, int lane, bool vec) {
  if (vec) {
    const int chunks = n * (int)sizeof(T) / 16;
    for (int k = lane; k < chunks; k += 32)
      cp16(reinterpret_cast<char*>(dst) + 16 * k, reinterpret_cast<const char*>(src) + 16 * k);
  } else {
    for (int c = lane; c < n; c += 32) dst[c] = src[c];
  }
}

// block (element b, run s): dx of its rows, and its partial of element b's
// sums written to part[(s * nb + b) * 3C ...]; vec: every row of x, dh,
// dout and y starts on a 16-byte boundary and C * sizeof(XT) % 16 == 0
template <typename XT, int J, int NT>
__device__ __forceinline__ void block(
    const XT* __restrict__ x, long long ldx, const float* __restrict__ dh,
    const float* __restrict__ dout, const float* __restrict__ y,
    const bf16* __restrict__ scale, long long ld_mod, float* __restrict__ dx,
    float* __restrict__ part, int C, int nb, int rows, int rows_per_split, int b, int s,
    bool vec, unsigned char* smem) {
  const int Cp = padded(C);
  float* s1 = reinterpret_cast<float*>(smem);  // [C] 1 + scale_b
  const int lane = threadIdx.x & 31, rw = threadIdx.x >> 5;
  unsigned char* area = smem + (size_t)Cp * sizeof(float);
  unsigned char* mine = area + (size_t)rw * warp_bytes<XT>(Cp);
  XT* xs = reinterpret_cast<XT*>(mine);           // [Cp]
  float* gs = reinterpret_cast<float*>(xs + Cp);  // [Cp]
  float* os = gs + Cp;                            // [Cp]
  float* ys = os + Cp;                            // [Cp]
  // virtual warp v's sums: its staging area (a real warp each), or a slice
  // after the real warps' areas
  constexpr bool own = NT / 32 == WARPS;
  const size_t stride = own ? warp_bytes<XT>(Cp) / sizeof(float) : 3 * (size_t)C;
  float* sums = reinterpret_cast<float*>(own ? area : area + (NT / 32) * warp_bytes<XT>(Cp));
  const int r_lo = s * rows_per_split, r_hi = min(rows, r_lo + rows_per_split);
  const float inv_c = 1.0f / C;
  for (int c = threadIdx.x; c < C; c += NT)
    s1[c] = __fadd_rn(1.0f, __bfloat162float(scale[(long long)b * ld_mod + c]));
  __syncthreads();

  for (int v = rw; v < WARPS; v += NT / 32) {
    // virtual warp v: rows r_lo + v + 8 k of element b, summed in order
    const long long first = (long long)b * rows + r_lo + v;
    const int n = r_lo + v < r_hi ? (r_hi - r_lo - v + WARPS - 1) / WARPS : 0;
    float a0[J], a1[J], a2[J];  // its sums of dh, dh * h_hat, dout * y
#pragma unroll
    for (int j = 0; j < J; ++j) a0[j] = a1[j] = a2[j] = 0.f;
    for (int k = 0; k < n; ++k) {
      const long long r = first + (long long)k * WARPS;
      stage(xs, x + r * ldx, C, lane, vec);
      stage(gs, dh + r * C, C, lane, vec);
      commit();
      stage(os, dout + r * C, C, lane, vec);
      stage(ys, y + r * C, C, lane, vec);
      commit();
      wait_groups<1>();  // x and dh have landed
      __syncwarp();
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (lane + 32 * j < C) sum = __fadd_rn(sum, to_f(xs[lane + 32 * j]));
      const float mean = __fmul_rn(warp_sum(sum), inv_c);
      float var = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (lane + 32 * j < C) {
          const float d = __fsub_rn(to_f(xs[lane + 32 * j]), mean);
          var = __fmaf_rn(d, d, var);
        }
      const float rstd = rsqrtf(__fmaf_rn(warp_sum(var), inv_c, 1e-6f));
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (c < C) {
          const float hh = __fmul_rn(__fsub_rn(to_f(xs[c]), mean), rstd);
          const float dhh = __fmul_rn(gs[c], s1[c]);
          m1 = __fadd_rn(m1, dhh);
          m2 = __fmaf_rn(hh, dhh, m2);
        }
      }
      m1 = __fmul_rn(warp_sum(m1), inv_c);
      m2 = __fmul_rn(warp_sum(m2), inv_c);
      wait_groups<0>();  // dout and y
      __syncwarp();
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (c < C) {
          const float hh = __fmul_rn(__fsub_rn(to_f(xs[c]), mean), rstd);
          const float g = gs[c], go = os[c];
          const float t = __fmaf_rn(hh, -m2, __fmaf_rn(g, s1[c], -m1));
          dx[r * C + c] = __fmaf_rn(rstd, t, go);
          a0[j] = __fadd_rn(a0[j], g);
          a1[j] = __fmaf_rn(hh, g, a1[j]);
          a2[j] = __fmaf_rn(go, ys[c], a2[j]);
        }
      }
      __syncwarp();  // the area is read before the next row's copies land
    }
    float* acc = sums + v * stride;  // [3][C]
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      if (c < C) {
        acc[c] = a0[j];
        acc[C + c] = a1[j];
        acc[2 * C + c] = a2[j];
      }
    }
  }
  __syncthreads();
  // the eight virtual warps' sums added 0..7: the block's partial
  const int W = 3 * C;
  float* out = part + ((long long)s * nb + b) * W;
  for (int i = threadIdx.x; i < W; i += NT) {
    float t = 0.f;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) t += sums[v * stride + i];
    out[i] = t;
  }
}

}  // namespace modln
