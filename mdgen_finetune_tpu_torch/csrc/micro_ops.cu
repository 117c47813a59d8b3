// micro_ops: the micro-op cost probe (tools/micro_ops.py of the package).
//
// Replaces the probe kernel of tools/micro_ops.py:300 (main: one
// pallas_call per op and K, grid (32,), body `kernel`), which runs a named
// op K times inside one kernel so that (t(K = 10) - t(K = 2)) / 8 / 32 is
// the marginal cost of one op in one program. Here: one block of 128 threads
// per program b (grid (32,)), inputs x (32, 416, 384) and y (32, 416, 1536)
// bf16; block b evaluates op(x_b, y_b, k) for k = 0 .. K-1 (rot(t, k) rolls
// t's rows by 8 (k + 1), so no two evaluations are the same) and writes two
// f32 sums over every element of every evaluation to out[b]: the plain sum,
// and the sum weighted by wt(row, column) of the element's place in the
// op's output, so that an element computed or moved to the wrong place
// changes the second sum even where the first cannot change (a roll, a
// concat). The plain version (micro_ops_plain) computes the same sums in
// torch. What each op is on this
// card is named in the tool's docstring: elementwise and row ops run in f32
// registers, the dots on the tensor cores through mma.sync m16n8k16 bf16 with
// f32 accumulators (a 64 x 64 output tile per block at a time, operands
// staged in shared memory), the f32 dots as f32 FMAs, and the TPU layout ops
// (lane concat, row tiling, mask stacks, collapse, lane roll, lane slice) as
// the shared-memory or register copies of the same element counts.
//
// What bounds it: nothing here is meant to be fast. A probe of a marginal
// cost, it measures what one more op costs inside a running kernel; its
// 32 blocks fill 32 of the card's 132 SMs, as the TPU probe's grid of 32
// ran on one core.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "attention_tile.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int R = 416, C = 384, C4 = 1536, TP = 104, THREADS = 128, WARPS = THREADS / 32;
constexpr int SMEM = 16384;

struct In {
  const bf16* x;  // (R, C) of this program
  const bf16* y;  // (R, 4C)
};

__device__ __forceinline__ float f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ int rot(int i, int k) { return (i + 8 * (k + 1)) % R; }
// x, rot(x, k), y, rot(y, k), and the (4R, C) views of y and rot(y, k)
__device__ __forceinline__ bf16 X(const In& in, int i, int c) { return in.x[i * C + c]; }
__device__ __forceinline__ bf16 XR(const In& in, int k, int i, int c) { return X(in, rot(i, k), c); }
__device__ __forceinline__ bf16 Y(const In& in, int i, int c) { return in.y[i * C4 + c]; }
__device__ __forceinline__ bf16 YR(const In& in, int k, int i, int c) { return Y(in, rot(i, k), c); }
__device__ __forceinline__ bf16 Y4(const In& in, int r, int c) { return Y(in, r / 4, (r % 4) * C + c); }
__device__ __forceinline__ bf16 YR4(const In& in, int k, int r, int c) {
  return YR(in, k, r / 4, (r % 4) * C + c);
}

// the weight of output element (r, c): the top byte of a multiplicative
// hash of r * 65536 + c, as (h >> 24) / 128 - 1 in [-1, 1) (exact in f32;
// micro_ops.py's _weights is the same function)
__device__ __forceinline__ float wt(int r, int c) {
  const uint32_t h = (uint32_t)(r * 65536 + c) * 2654435761u;
  return (float)(h >> 24) * (1.f / 128.f) - 1.f;
}

// this thread's share of the two sums: plain and position-weighted
struct Acc {
  float s = 0.f, w = 0.f;
  __device__ __forceinline__ void add(float v, int r, int c) {
    s += v;
    w += wt(r, c) * v;
  }
  __device__ __forceinline__ Acc& operator+=(const Acc& o) {
    s += o.s;
    w += o.w;
    return *this;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the sums over a rows x cols output of fn(i, c), elementwise in the threads
template <class Fn>
__device__ __forceinline__ Acc each(int rows, int cols, Fn fn) {
  Acc a;
  for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
    const int i = e / cols, c = e % cols;
    a.add(fn(i, c), i, c);
  }
  return a;
}

// the sums over the (M, N) output of A (M, K) . B (K, N), bf16 operands
// from the accessors fa(i, c) and fb(c, n), f32 accumulators (rounded to
// bf16 per element when bf16_out); mma.sync m16n8k16 over 64 x 64 output
// tiles, a warp per 16 rows, operands staged 32 deep in shared memory.
// Output row i is weighted as row i % wrap (the stacked dots: the two
// halves of the rows are summed into one output)
template <class FA, class FB>
__device__ Acc dot_sum(int M, int N, int K, FA fa, FB fb, bool bf16_out, unsigned char* smem,
                       int wrap = 1 << 30) {
  constexpr int LD = 40;
  bf16* As = reinterpret_cast<bf16*>(smem);  // [64 rows][32 k]
  bf16* Bs = As + 64 * LD;                   // [64 columns][32 k]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const bf16 zero = __float2bfloat16(0.f);
  Acc total;
  for (int m0 = 0; m0 < M; m0 += 64)
    for (int n0 = 0; n0 < N; n0 += 64) {
      float acc[8][4];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
      for (int k0 = 0; k0 < K; k0 += 32) {
        __syncthreads();
        for (int e = threadIdx.x; e < 64 * 32; e += THREADS) {
          const int r = e / 32, c = e % 32;
          As[r * LD + c] = m0 + r < M && k0 + c < K ? fa(m0 + r, k0 + c) : zero;
          Bs[r * LD + c] = n0 + r < N && k0 + c < K ? fb(k0 + c, n0 + r) : zero;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < 32; kk += 16) {
          const bf16* a = As + (warp * 16 + gid) * LD + kk + tig * 2;
          const uint32_t af[4] = {attn_tile::ld32(a), attn_tile::ld32(a + 8 * LD),
                                  attn_tile::ld32(a + 8), attn_tile::ld32(a + 8 * LD + 8)};
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const bf16* bp = Bs + (nb * 8 + gid) * LD + kk + tig * 2;
            attn_tile::mma16816(acc[nb], af, attn_tile::ld32(bp), attn_tile::ld32(bp + 8));
          }
        }
      }
      // accumulator e of a fragment: row gid + 8 (e / 2), column 2 tig + e % 2
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          total.add(bf16_out ? bfr(acc[nb][e]) : acc[nb][e],
                    (m0 + warp * 16 + gid + 8 * (e >> 1)) % wrap, n0 + nb * 8 + tig * 2 + (e & 1));
    }
  return total;
}

// the f32 dots: every output element an f32 FMA chain over K
template <class FA, class FB>
__device__ __forceinline__ Acc dot_f32_sum(int M, int N, int K, FA fa, FB fb) {
  Acc total;
  for (int e = threadIdx.x; e < M * N; e += THREADS) {
    const int i = e / N, n = e % N;
    float s = 0.f;
    for (int c = 0; c < K; ++c) s += fa(i, c) * fb(c, n);
    total.add(s, i, n);
  }
  return total;
}

enum Op {
  MUL, FMA_F32, EXP_416, EXP_1664, EXP2_416, EXP2_1664, ADD_F32, MAXLANE, SUMLANE,
  LANE_CONCAT5, ROW_TILE4, DOT_104x384x16, DOT_416x384x16, PAIR_16, STACK_16, PAIR_384,
  STACK_384, PAIR_1536, STACK_1536, DOT_416x384x384, DOT_832x384x384, DOT_1664x384x384,
  DOT_416x384x1536, DOT_832x384x1536, DOT_BF16OUT, DOT_416x128x112, DOT_1664x512x112,
  DOT_416x16x384, DOT_416x80x1920, MASK_STACK, COLLAPSE, LN_F32, SOFTMAX_TAIL, ROLL_PAIR,
  SLICE_LANE, N_OPS
};

// this thread's share of the sums of op(x_b, y_b, k)
template <int OP>
__device__ Acc op_sum(const In& in, int k, unsigned char* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (OP == MUL) {
    return each(R, C, [&](int i, int c) { return bfr(f(XR(in, k, i, c)) * f(X(in, i, c))); });
  } else if constexpr (OP == FMA_F32) {
    return each(R, C, [&](int i, int c) {
      const float v = f(X(in, i, c));
      return f(XR(in, k, i, c)) * v + v;
    });
  } else if constexpr (OP == EXP_416 || OP == EXP2_416) {
    return each(R, 112, [&](int i, int c) {
      const float v = f(XR(in, k, i, c));
      return OP == EXP_416 ? expf(v) : exp2f(v);
    });
  } else if constexpr (OP == EXP_1664 || OP == EXP2_1664) {
    return each(4 * R, 112, [&](int r, int c) {
      const float v = f(YR4(in, k, r, c));
      return OP == EXP_1664 ? expf(v) : exp2f(v);
    });
  } else if constexpr (OP == ADD_F32) {
    return each(R, 112, [&](int i, int c) { return f(XR(in, k, i, c)) + f(X(in, 0, c)); });
  } else if constexpr (OP == MAXLANE || OP == SUMLANE || OP == SOFTMAX_TAIL) {
    // a warp per row of rot(x)[:, :112]: the lane max / sum, or the tail
    // (p - max) / sum(p - max)
    Acc s;
    for (int i = warp; i < R; i += WARPS) {
      float v[4], m = -3.0e38f, t = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        v[j] = c < 112 ? f(XR(in, k, i, c)) : 0.f;
        if (c < 112) m = fmaxf(m, v[j]);
        t += v[j];
      }
      m = warp_max(m);
      if (OP == MAXLANE) {
        s.add(lane == 0 ? m : 0.f, i, 0);
      } else if (OP == SUMLANE) {
        s.add(t, i, 0);
      } else {
        float den = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) den += lane + 32 * j < 112 ? v[j] - m : 0.f;
        den = warp_sum(den);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (lane + 32 * j < 112) s.add((v[j] - m) / den, i, lane + 32 * j);
      }
    }
    return s;
  } else if constexpr (OP == LN_F32) {
    Acc s;
    for (int i = warp; i < R; i += WARPS) {
      float v[C / 32], t = 0.f, t2 = 0.f;
#pragma unroll
      for (int j = 0; j < C / 32; ++j) {
        v[j] = f(XR(in, k, i, lane + 32 * j));
        t += v[j];
        t2 += v[j] * v[j];
      }
      const float mean = warp_sum(t) / C, var = warp_sum(t2) / C - mean * mean;
      const float rs = rsqrtf(var + 1e-6f);
#pragma unroll
      for (int j = 0; j < C / 32; ++j) s.add((v[j] - mean) * rs, i, lane + 32 * j);
    }
    return s;
  } else if constexpr (OP == LANE_CONCAT5) {
    // each output row [xs | x | xs | x | xs] (1,920 lanes) written to shared
    // memory, then read back
    bf16* row = reinterpret_cast<bf16*>(smem) + warp * 5 * C;
    Acc s;
    for (int i = warp; i < R; i += WARPS) {
      for (int c = lane; c < C; c += 32) {
        const bf16 a = XR(in, k, i, c), b = X(in, i, c);
        row[c] = a; row[C + c] = b; row[2 * C + c] = a; row[3 * C + c] = b; row[4 * C + c] = a;
      }
      __syncwarp();
      for (int c = lane; c < 5 * C; c += 32) s.add(f(row[c]), i, c);
      __syncwarp();
    }
    return s;
  } else if constexpr (OP == ROW_TILE4) {
    // the first 104 rows of rot(x) staged 16 at a time, each read 4 times
    bf16* tile = reinterpret_cast<bf16*>(smem);
    Acc s;
    for (int i0 = 0; i0 < TP; i0 += 16) {
      const int n = min(16, TP - i0);
      __syncthreads();
      for (int e = threadIdx.x; e < n * C; e += THREADS) tile[e] = XR(in, k, i0 + e / C, e % C);
      __syncthreads();
      for (int e = threadIdx.x; e < 4 * n * C; e += THREADS) {
        const int t = e % (n * C);  // output row (e / (n C)) 104 + i0 + t / C
        s.add(f(tile[t]), (e / (n * C)) * TP + i0 + t / C, t % C);
      }
    }
    return s;
  } else if constexpr (OP == MASK_STACK) {
    // 16 copies of rot(y)[:104, :512], copy j keeping lanes 32 j .. 32 j + 31
    bf16* row = reinterpret_cast<bf16*>(smem) + warp * 512;
    const bf16 zero = __float2bfloat16(0.f);
    Acc s;
    for (int e = warp; e < 16 * TP; e += WARPS) {
      const int j = e / TP, i = e % TP;
      for (int c = lane; c < 512; c += 32) row[c] = c / 32 == j ? YR(in, k, i, c) : zero;
      __syncwarp();
      for (int c = lane; c < 512; c += 32) s.add(f(row[c]), e, c);  // output row j 104 + i
      __syncwarp();
    }
    return s;
  } else if constexpr (OP == COLLAPSE) {
    // out[i, c] = rot(y).reshape(4R, C)[(c / 32) * 104 + i, c], c < 128
    return each(TP, 128, [&](int i, int c) { return f(YR4(in, k, (c / 32) * TP + i, c)); });
  } else if constexpr (OP == ROLL_PAIR) {
    // roll(x32, 12) + roll(x32, 372) along the lanes, through shared memory
    float* row = reinterpret_cast<float*>(smem) + warp * C;
    Acc s;
    for (int i = warp; i < R; i += WARPS) {
      for (int c = lane; c < C; c += 32) row[c] = f(XR(in, k, i, c));
      __syncwarp();
      for (int c = lane; c < C; c += 32) s.add(row[(c + C - 12) % C] + row[(c + 12) % C], i, c);
      __syncwarp();
    }
    return s;
  } else if constexpr (OP == SLICE_LANE) {
    return each(R, C, [&](int i, int c) { return f(YR(in, k, i, C + c)); });
  } else if constexpr (OP == DOT_416x16x384) {
    return dot_f32_sum(R, C, 16, [&](int i, int c) { return f(XR(in, k, i, c)); },
                       [&](int c, int n) { return f(X(in, c, n)); });
  } else if constexpr (OP == DOT_416x80x1920) {
    return dot_f32_sum(R, 5 * C, 80, [&](int i, int c) { return f(XR(in, k, i, c)); },
                       [&](int c, int n) { return f(YR4(in, k, c, n % C)); });
  } else {
    // the bf16 dots
    auto ax = [&](int i, int c) { return XR(in, k, i, c); };
    auto ay4 = [&](int i, int c) { return YR4(in, k, i, c); };
    auto wx = [&](int c, int n) { return X(in, c, n); };
    auto wy = [&](int c, int n) { return Y(in, c, n); };
    if constexpr (OP == DOT_104x384x16) return dot_sum(TP, 16, C, ax, wx, false, smem);
    if constexpr (OP == DOT_416x384x16) return dot_sum(R, 16, C, ax, wx, false, smem);
    if constexpr (OP == DOT_416x384x384) return dot_sum(R, C, C, ax, wx, false, smem);
    if constexpr (OP == DOT_832x384x384) return dot_sum(2 * R, C, C, ay4, wx, false, smem);
    if constexpr (OP == DOT_1664x384x384) return dot_sum(4 * R, C, C, ay4, wx, false, smem);
    if constexpr (OP == DOT_416x384x1536) return dot_sum(R, C4, C, ax, wy, false, smem);
    if constexpr (OP == DOT_832x384x1536) return dot_sum(2 * R, C4, C, ay4, wy, false, smem);
    if constexpr (OP == DOT_BF16OUT) return dot_sum(R, C4, C, ax, wy, true, smem);
    if constexpr (OP == DOT_416x128x112) return dot_sum(R, 112, 128, ax, wx, false, smem);
    if constexpr (OP == DOT_1664x512x112)
      return dot_sum(4 * R, 112, 512, [&](int i, int c) { return YR4(in, k, i, c % 256); },
                     [&](int c, int n) { return Y4(in, c, n); }, false, smem);
    if constexpr (OP == PAIR_16 || OP == PAIR_384 || OP == PAIR_1536 || OP == STACK_16 ||
                  OP == STACK_384 || OP == STACK_1536) {
      constexpr int NK = (OP == PAIR_16 || OP == STACK_16) ? 16
                         : (OP == PAIR_384 || OP == STACK_384) ? C : C4;
      auto w = [&](int c, int n) { return NK <= C ? X(in, c, n) : Y(in, c, n); };
      if constexpr (OP == PAIR_16 || OP == PAIR_384 || OP == PAIR_1536) {
        auto a2 = [&](int i, int c) { return XR(in, k + 11, i, c); };
        Acc a = dot_sum(R, NK, C, ax, w, false, smem);
        return a += dot_sum(R, NK, C, a2, w, false, smem);
      } else {
        auto st = [&](int i, int c) { return i < R ? XR(in, k, i, c) : XR(in, k + 11, i - R, c); };
        return dot_sum(2 * R, NK, C, st, w, false, smem, R);
      }
    }
    return Acc{};
  }
}

template <int OP>
__global__ void __launch_bounds__(THREADS) micro_kernel(const bf16* __restrict__ x,
                                                        const bf16* __restrict__ y,
                                                        float* __restrict__ out, int K) {
  __shared__ __align__(16) unsigned char smem[SMEM];
  __shared__ float red[2][WARPS];
  const In in{x + (long long)blockIdx.x * R * C, y + (long long)blockIdx.x * R * C4};
  Acc a;
  for (int k = 0; k < K; ++k) a += op_sum<OP>(in, k, smem);
  a.s = warp_sum(a.s);
  a.w = warp_sum(a.w);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = a.s;
    red[1][threadIdx.x >> 5] = a.w;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += red[threadIdx.x][w];
    out[2 * blockIdx.x + threadIdx.x] = t;
  }
}

template <int OP>
int launch(const void* x, const void* y, void* out, int programs, int K, cudaStream_t s) {
  micro_kernel<OP><<<programs, THREADS, 0, s>>>(static_cast<const bf16*>(x),
                                                static_cast<const bf16*>(y),
                                                static_cast<float*>(out), K);
  return (int)cudaGetLastError();
}

template <int... OPS>
int dispatch(int op, const void* x, const void* y, void* out, int programs, int K,
             cudaStream_t s, std::integer_sequence<int, OPS...>) {
  int code = (int)cudaErrorInvalidValue;
  ((op == OPS ? (code = launch<OPS>(x, y, out, programs, K, s), 0) : 0), ...);
  return code;
}

}  // namespace

// x (programs, 416, 384), y (programs, 416, 1536) bf16; out (programs, 2) f32
// (the plain and the position-weighted sum);
// op: the index of the op in tools/micro_ops.py's OPS
extern "C" int micro_ops(const void* x, const void* y, void* out, int op, int programs, int K,
                         void* stream) {
  if (op < 0 || op >= N_OPS || programs <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  return dispatch(op, x, y, out, programs, K, static_cast<cudaStream_t>(stream),
                  std::make_integer_sequence<int, N_OPS>{});
}

extern "C" int micro_ops_count() { return N_OPS; }
