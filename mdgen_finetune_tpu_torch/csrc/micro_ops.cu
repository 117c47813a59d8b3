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
// registers, the bf16 dots on the tensor cores (dot_sum: the block's 128
// threads are one warpgroup issuing wgmma.mma_async m64n64k16 / m64n128k16
// with f32 accumulators, fed by a ring of 16-byte cp.async slabs in the
// 128-byte swizzle, the sums taken from the accumulator fragments), the f32
// dots as f32 FMAs, and the TPU layout ops (lane concat, row tiling, mask
// stacks, collapse, lane roll, lane slice) as the shared-memory or register
// copies of the same element counts.
//
// What bounds it: a probe of a marginal cost, it measures what one more op
// costs inside a running kernel; its 32 blocks fill 32 of the card's 132
// SMs, as the TPU probe's grid of 32 ran on one core. The dots were first
// mma.sync m16n8k16 on 64 x 64 tiles whose operands went element by element
// through accessors into shared memory, 32 k deep behind two barriers, with
// nothing in flight (dot_416x384x384 at K = 2: 2.768 ms on an H100 SXM at 700 W):
// a table that priced every product at that rate. Now a dot costs about
// what a Hopper kernel's dot costs on 32 SMs (its operands from L2: each
// 64-row tile of A is read once per column tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "adaln_linear.cuh"  // adaln::wg: the wgmma descriptor, fences, m64n128k16

typedef __nv_bfloat16 bf16;

namespace {

constexpr int R = 416, C = 384, C4 = 1536, TP = 104, THREADS = 128, WARPS = THREADS / 32;
constexpr int SMEM = 16384;  // shared memory of the ops that stage rows in it

struct In {
  const bf16* x;  // (R, C) of this program
  const bf16* y;  // (R, 4C)
};

__device__ __forceinline__ float f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ int rot(int i, int k) { return (i + 8 * (k + 1)) % R; }
// x, rot(x, k), y, rot(y, k), and the (4R, C) view of rot(y, k)
__device__ __forceinline__ bf16 X(const In& in, int i, int c) { return in.x[i * C + c]; }
__device__ __forceinline__ bf16 XR(const In& in, int k, int i, int c) { return X(in, rot(i, k), c); }
__device__ __forceinline__ bf16 Y(const In& in, int i, int c) { return in.y[i * C4 + c]; }
__device__ __forceinline__ bf16 YR(const In& in, int k, int i, int c) { return Y(in, rot(i, k), c); }
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

// ---- the bf16 dots: a wgmma pipeline ----
namespace dot {

using adaln::wg::desc;
using adaln::wg::smem_u32;

constexpr int KB = 128;              // k per A slab: eight wgmma k-steps of 16
constexpr int KMAX = 512;            // the probe's deepest product
constexpr int STAGES = 4;            // A's ring of slabs
constexpr int A_BLK = 64 * 128;      // 64 rows x 64 k, 128 bytes a row: one swizzle block
constexpr int A_BYTES = KB / 64 * A_BLK;  // an A slab: 64 rows x KB k in blocks of 64 k
constexpr int BOX = 64 * 128;        // 64 k rows x 64 columns of B
constexpr int PANEL = KMAX / 64 * 2 * BOX;  // B's panel: K x 128 columns, 64-row slabs
constexpr int ALIGN = 1024;          // the 128-byte swizzle repeats every 8 rows of 128 bytes
constexpr int SMEM = ALIGN + PANEL + STAGES * A_BYTES;  // the dots' dynamic shared memory

// a 16-byte copy, or zeros where !ok (the src-size 0 form reads nothing)
__device__ __forceinline__ void cp16z(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int NR>
__device__ __forceinline__ void fence_acc(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16, K-major) . B (16 x 64, N-major: the transpose bit);
// adaln::wg::wgmma_m64n128k16 is the 128-column one
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 64) wgmma_m64n64k16(d, da, db, scale_d);
  else adaln::wg::wgmma_m64n128k16(d, da, db, scale_d);
}

}  // namespace dot

// this thread's share of the sums over a 64 x BN tile at (m0, n0) from the wgmma
// accumulators d (f32; rounded to bf16 per element when bf16_out): accumulator e of
// 8-column block j holds row gid + 8 (e / 2) of the warp's 16, column 2 tig + e % 2
// (Acc::add with wt's hash split into its row and column terms)
template <int BN>
__device__ __forceinline__ void tile_sums(Acc& acc, const float (&d)[BN / 2], int m0, int n0, int M,
                                          int N, bool bf16_out, int wrap) {
  constexpr uint32_t HASH = 2654435761u;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int r0 = m0 + (threadIdx.x >> 5) * 16 + gid;
  const uint32_t hr[2] = {(uint32_t)((r0 % wrap) * 65536) * HASH,
                          (uint32_t)(((r0 + 8) % wrap) * 65536) * HASH};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1), c = n0 + 8 * j + 2 * tig + (e & 1);
      if (r < M && c < N) {
        const float v = bf16_out ? bfr(d[4 * j + e]) : d[4 * j + e];
        const float w = (float)((hr[e >> 1] + (uint32_t)c * HASH) >> 24) * (1.f / 128.f) - 1.f;
        acc.s += v;
        acc.w += w * v;
      }
    }
}

// The sums over the (M, N) output of A (M, K) . B (K, N), bf16 operands, f32
// accumulators (rounded to bf16 per element when bf16_out), K a multiple of KB up to
// KMAX: fa(i, c) points at A's element (i, c) and fb(c, n) at B's (c, n), each the
// first of 8 contiguous elements for c (resp. n) a multiple of 8 (so A's rows may
// roll: x's rows wrap at 416). The block's 128 threads are one warpgroup. For each
// column tile of BN (64 for N <= 64, else 128; columns past N are zeros) the K x BN
// panel of B comes into shared memory once, N-major (wgmma's transpose bit) in the
// 128-byte swizzle; A streams through a ring of STAGES slabs of 64 rows x KB k
// (rows past M zeros), filled by 16-byte cp.async with STAGES - 1 slabs in flight,
// each multiplied by eight wgmma.mma_async m64nBNk16 while the last is still running.
// The sums come from the accumulator fragments (tile_sums); output row i is weighted
// as row i % wrap (the stacked dots: the two halves of the rows summed into one output).
template <int BN, class FA, class FB>
__device__ Acc dot_sum(int M, int N, int K, FA fa, FB fb, bool bf16_out, unsigned char* smem_raw,
                       int wrap = 1 << 30) {
  using namespace dot;
  constexpr int NR = BN / 2, NB = BN / 64;
  const int tid = threadIdx.x;
  unsigned char* Bp = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  unsigned char* ring = Bp + PANEL;
  const int tn = (N + BN - 1) / BN, tm = (M + 63) / 64, nslab = K / KB, total = tm * nslab;
  const void* any = fb(0, 0);  // a readable address for the zero-filling copies
  Acc acc;
  float d[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) d[i] = 0.f;
  for (int nt = 0; nt < tn; ++nt) {
    const int n0 = nt * BN;
    for (int c = tid; c < K * (BN / 8); c += 128) {  // the panel: 64-row slab, box, row, unit
      const int r = c / (BN / 8), u = c % (BN / 8), n = n0 + 8 * u, rr = r % 64;
      cp16z(Bp + ((r / 64) * NB + (u >> 3)) * BOX + rr * 128 + (((u & 7) ^ (rr & 7)) << 4),
            n < N ? fb(r, n) : any, n < N);
    }
    auto fetch = [&](int it) {  // A's slab it (tile it / nslab, k slab it % nslab) into its slot
      if (it < total) {
        const int m0 = it / nslab * 64, k0 = it % nslab * KB;
        unsigned char* As = ring + (it % STAGES) * A_BYTES;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = (tid >> 3) + 16 * j, u = tid & 7;
          const bool ok = m0 + r < M;
#pragma unroll
          for (int b = 0; b < KB / 64; ++b)
            cp16z(As + b * A_BLK + r * 128 + ((u ^ (r & 7)) << 4),
                  ok ? fa(m0 + r, k0 + 64 * b + 8 * u) : any, ok);
        }
      }
      cp_commit();  // an empty group past the end keeps the count
    };
    for (int it = 0; it < STAGES - 1; ++it) fetch(it);  // the first group carries the panel
    int it = 0;
    for (int mt = 0; mt < tm; ++mt) {
      for (int s = 0; s < nslab; ++s, ++it) {
        cp_wait<STAGES - 2>();           // slab it has landed (this thread's copies)
        adaln::wg::fence_proxy_async();  // ... visible to the tensor cores
        __syncthreads();                 // ... every thread's
        const unsigned char* As = ring + (it % STAGES) * A_BYTES;
        fence_acc(d);
        adaln::wg::wgmma_fence();
#pragma unroll
        for (int u = 0; u < KB / 16; ++u)  // k-step u: A's block u / 4, B's 64-row slab 2 s + u / 4
          wgmma<BN>(d, desc(As + (u >> 2) * A_BLK + (u & 3) * 32, 0, 1024),
                    desc(Bp + ((KB / 64) * s + (u >> 2)) * NB * BOX + (u & 3) * 2048, BOX, 1024),
                    (s | u) != 0);
        adaln::wg::wgmma_commit();
        adaln::wg::wgmma_wait<1>();  // the products of slab it - 1 are done
        fence_acc(d);
        __syncthreads();             // ... in every warp: its slot may be refilled
        fetch(it + STAGES - 1);
      }
      adaln::wg::wgmma_wait<0>();
      fence_acc(d);
      tile_sums<BN>(acc, d, mt * 64, n0, M, N, bf16_out, wrap);
    }
    cp_wait<0>();
    __syncthreads();  // the panel and the ring are free for the next column tile
  }
  return acc;
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
    // the bf16 dots: pointers to A's (i, c) and B's (c, n)
    auto ax = [&](int i, int c) { return in.x + rot(i, k) * C + c; };
    auto ay4 = [&](int i, int c) { return in.y + rot(i / 4, k) * C4 + (i % 4) * C + c; };
    auto wx = [&](int c, int n) { return in.x + c * C + n; };
    auto wy = [&](int c, int n) { return in.y + c * C4 + n; };
    if constexpr (OP == DOT_104x384x16) return dot_sum<64>(TP, 16, C, ax, wx, false, smem);
    if constexpr (OP == DOT_416x384x16) return dot_sum<64>(R, 16, C, ax, wx, false, smem);
    if constexpr (OP == DOT_416x384x384) return dot_sum<128>(R, C, C, ax, wx, false, smem);
    if constexpr (OP == DOT_832x384x384) return dot_sum<128>(2 * R, C, C, ay4, wx, false, smem);
    if constexpr (OP == DOT_1664x384x384) return dot_sum<128>(4 * R, C, C, ay4, wx, false, smem);
    if constexpr (OP == DOT_416x384x1536) return dot_sum<128>(R, C4, C, ax, wy, false, smem);
    if constexpr (OP == DOT_832x384x1536) return dot_sum<128>(2 * R, C4, C, ay4, wy, false, smem);
    if constexpr (OP == DOT_BF16OUT) return dot_sum<128>(R, C4, C, ax, wy, true, smem);
    if constexpr (OP == DOT_416x128x112) return dot_sum<128>(R, 112, 128, ax, wx, false, smem);
    if constexpr (OP == DOT_1664x512x112)
      return dot_sum<128>(4 * R, 112, 512, [&](int i, int c) { return ay4(i, c % 256); },
                          [&](int c, int n) { return in.y + (c / 4) * C4 + (c % 4) * C + n; },
                          false, smem);
    if constexpr (OP == PAIR_16 || OP == PAIR_384 || OP == PAIR_1536 || OP == STACK_16 ||
                  OP == STACK_384 || OP == STACK_1536) {
      constexpr int NK = (OP == PAIR_16 || OP == STACK_16) ? 16
                         : (OP == PAIR_384 || OP == STACK_384) ? C : C4;
      constexpr int BN = NK <= 64 ? 64 : 128;
      auto w = [&](int c, int n) { return NK <= C ? wx(c, n) : wy(c, n); };
      if constexpr (OP == PAIR_16 || OP == PAIR_384 || OP == PAIR_1536) {
        auto a2 = [&](int i, int c) { return in.x + rot(i, k + 11) * C + c; };
        Acc a = dot_sum<BN>(R, NK, C, ax, w, false, smem);
        return a += dot_sum<BN>(R, NK, C, a2, w, false, smem);
      } else {
        auto st = [&](int i, int c) {
          return i < R ? ax(i, c) : in.x + rot(i - R, k + 11) * C + c;
        };
        return dot_sum<BN>(2 * R, NK, C, st, w, false, smem, R);
      }
    }
    return Acc{};
  }
}

// the ops whose body is dot_sum: the dynamic shared memory of its ring
__host__ __device__ constexpr bool wgmma_op(int op) {
  return op == DOT_104x384x16 || op == DOT_416x384x16 || (op >= PAIR_16 && op <= DOT_1664x512x112);
}

template <int OP>
__global__ void __launch_bounds__(THREADS) micro_kernel(const bf16* __restrict__ x,
                                                        const bf16* __restrict__ y,
                                                        float* __restrict__ out, int K) {
  // the dots' ring in dynamic shared memory; the other ops' staging static, as it was
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ __align__(16) unsigned char stat[wgmma_op(OP) ? 16 : SMEM];
  unsigned char* smem = wgmma_op(OP) ? dyn : stat;
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

// a launch at the op's dynamic shared memory (the attribute set once per card)
template <int OP>
int launch(const void* x, const void* y, void* out, int programs, int K, cudaStream_t s) {
  constexpr int smem = wgmma_op(OP) ? dot::SMEM : 0;
  static bool sized[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(micro_kernel<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized[dev] = true;
  }
  micro_kernel<OP><<<programs, THREADS, smem, s>>>(static_cast<const bf16*>(x),
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
