// linear_bwd.cuh: the block bodies of linear_bwd.cu (the design note is
// there), as device functions over a block index and a shared-memory
// buffer, so that linear_bwd.cu's kernels and the merged layer backward
// (fused_layer_bwd.cu) run the same code. A block is THREADS threads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace lbwd {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BT = 64, BR = 32, THREADS = 128;  // output tile, reduction chunk
constexpr int LDS = BT + 8;                      // bf16 row stride of a 64-wide stage
constexpr int LDR = BR + 8;                      // bf16 row stride of a 32-wide stage
constexpr int LDC = BT + 4;                      // f32 stride of the staged output
// shared memory of a dgrad / wgrad block: two bf16 stages and the f32 output
constexpr size_t DGRAD_SMEM = 2 * BT * LDR * sizeof(bf16) + BT * LDC * sizeof(float);
constexpr size_t WGRAD_SMEM = 2 * BR * LDS * sizeof(bf16) + BT * LDC * sizeof(float);

struct Args {
  const void* dy; int dy_f32; long long ld_dy;
  const bf16* gate; long long ld_gate; int rows_per_gate;
  const bf16* x; long long ld_x;            // dgrad: W (K, N); wgrad: A / X (M, K)
  const float* act; long long ld_act;       // dgrad: pre-activation (M, K) or null
  int ln; const bf16* shift; const bf16* scale; long long ld_mod; int rows_per_mod;
  void* out; int out_f32; long long ld_out;
  float* part; float* part_db; float* stats;
  int splits, rows_per_split;
  int M, N, K;
};

// The arguments of one call (the C entry point's, in its order); wgrad
// partials and row statistics go to scratch (splits * (K*N + N) + 2M f32).
inline Args make_args(int mode, const void* dy, int dy_f32, long long ld_dy, const void* gate,
                      long long ld_gate, int rows_per_gate, const void* x, long long ld_x,
                      const void* act, long long ld_act, int ln, const void* shift,
                      const void* scale, long long ld_mod, int rows_per_mod, void* out,
                      int out_f32, long long ld_out, void* scratch, int splits, int M, int N,
                      int K) {
  Args a;
  a.dy = dy; a.dy_f32 = dy_f32; a.ld_dy = ld_dy;
  a.gate = static_cast<const bf16*>(gate); a.ld_gate = ld_gate;
  a.rows_per_gate = rows_per_gate > 0 ? rows_per_gate : 1;
  a.x = static_cast<const bf16*>(x); a.ld_x = ld_x;
  a.act = static_cast<const float*>(act); a.ld_act = ld_act;
  a.ln = ln; a.shift = static_cast<const bf16*>(shift); a.scale = static_cast<const bf16*>(scale);
  a.ld_mod = ld_mod; a.rows_per_mod = rows_per_mod > 0 ? rows_per_mod : 1;
  a.out = out; a.out_f32 = out_f32; a.ld_out = ld_out;
  a.M = M; a.N = N; a.K = K;
  a.splits = splits > 0 ? splits : 1;
  a.rows_per_split = (M + a.splits - 1) / a.splits;
  if (mode == 0) {
    a.part = nullptr; a.part_db = nullptr; a.stats = nullptr;
  } else {
    float* sc = static_cast<float*>(scratch);
    a.part = sc;
    a.part_db = sc + (long long)a.splits * K * N;
    a.stats = a.part_db + (long long)a.splits * N;
  }
  return a;
}

// the grids of the three bodies
inline dim3 dgrad_grid(const Args& a) { return dim3((a.K + BT - 1) / BT, (a.M + BT - 1) / BT); }
inline unsigned stats_blocks(const Args& a) {
  return (unsigned)(((long long)a.M * 32 + THREADS - 1) / THREADS);
}
inline dim3 wgrad_grid(const Args& a) {
  return dim3((a.N + BT - 1) / BT, (a.K + BT - 1) / BT, a.splits);
}

__device__ __forceinline__ void load8f(const Args& a, long long r, int c, float* f) {
  // 8 consecutive elements of dY row r from column c (16- or 32-byte aligned)
  if (a.dy_f32) {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(a.dy) + r * a.ld_dy + c);
    float4 u = p[0], v = p[1];
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w; f[4] = v.x; f[5] = v.y; f[6] = v.z; f[7] = v.w;
  } else {
    uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.dy) + r * a.ld_dy + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

// P(dY) for 8 columns c.. of row r into bf16 dst; zeros outside (M, N)
__device__ __forceinline__ void stage_dy8(const Args& a, long long r, int c, bool ok, bf16* dst) {
  float f[8];
  if (ok) {
    load8f(a, r, c, f);
    if (a.gate != nullptr) {
      const bf16* g = a.gate + (r / a.rows_per_gate) * a.ld_gate + c;
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] *= __bfloat162float(g[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = __float2bfloat16(f[e]);
}

__device__ __forceinline__ float gelu_fast_grad(float a) {
  // d/da of mdgen_finetune_tpu/ops/adaln_mlp.py::_gelu_fast (its
  // _gelu_fast_with_grad): df/dt = (1 + t^2)^(-3/2), dz/da = 1{|a| < 6}
  const float k0 = 0.798055917732286f, k1 = 0.12003597204164997f,
              k2 = 0.01547196081666821f, k3 = 0.0005614901736225192f,
              k4 = 0.00014934348411800474f;
  if (a < -6.0f) return 0.0f;
  float z = fminf(fmaxf(a, -6.0f), 6.0f);
  float u = z * z;
  float p = (((k4 * u + k3) * u + k2) * u + k1) * u + k0;
  float pp = ((4.0f * k4 * u + 3.0f * k3) * u + 2.0f * k2) * u + k1;
  float t = z * p;
  float r = rsqrtf(1.0f + t * t);
  float phi = 0.5f + 0.5f * t * r;
  float fp = fabsf(a) < 6.0f ? r * r * r * (p + 2.0f * u * pp) : 0.0f;
  return phi + 0.5f * a * fp;
}

// ---------------------------------------------------------------------------
// dgrad: block (bx, by) = 64 rows of M x 64 columns of K; reduction over N by 32
// ---------------------------------------------------------------------------
__device__ __forceinline__ void dgrad_block(const Args& a, int bx, int by, unsigned char* smem) {
  bf16* As = reinterpret_cast<bf16*>(smem);                  // P(dY) [m][n]
  bf16* Bs = As + BT * LDR;                                  // W     [k][n]
  float* Cs = reinterpret_cast<float*>(Bs + BT * LDR);
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long bm = (long long)by * BT;
  const int bk = bx * BT;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int n0 = 0; n0 < a.N; n0 += BR) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS, r = idx >> 2, c8 = (idx & 3) * 8;
      const long long gm = bm + r;
      const int gn = n0 + c8;
      stage_dy8(a, gm, gn, gm < a.M && gn < a.N, As + r * LDR + c8);
      const int gk = bk + r;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (gk < a.K && gn < a.N) w = *reinterpret_cast<const uint4*>(a.x + (long long)gk * a.ld_x + gn);
      *reinterpret_cast<uint4*>(Bs + r * LDR + c8) = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (wr + i * 16) * LDR + kk, LDR);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + (wc + j * 16) * LDR + kk, LDR);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr + i * 16) * LDC + wc + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BT * BT; idx += THREADS) {
    const int r = idx / BT, c = idx % BT;
    const long long gm = bm + r;
    const int gk = bk + c;
    if (gm >= a.M || gk >= a.K) continue;
    float v = Cs[r * LDC + c];
    if (a.act != nullptr) v *= gelu_fast_grad(a.act[gm * a.ld_act + gk]);
    if (a.out_f32) static_cast<float*>(a.out)[gm * a.ld_out + gk] = v;
    else static_cast<bf16*>(a.out)[gm * a.ld_out + gk] = __float2bfloat16(v);
  }
}

// ---------------------------------------------------------------------------
// wgrad: block (bx, by, bz) = 64 rows of K x 64 columns of N over split bz of
// the M rows, reduction over M by 32; writes its f32 partial tile (and, on
// the first k-tile, the partial column sums of P(dY) for db)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void row_stats_block(const Args& a, int bx) {
  // mean and rstd of each row of X (M, K): one warp per row, two passes
  const int warp = (bx * THREADS + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (warp >= a.M) return;
  const bf16* row = a.x + (long long)warp * a.ld_x;
  float s = 0.f;
  for (int k = lane; k < a.K; k += 32) s += __bfloat162float(row[k]);
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / a.K;
  float v = 0.f;
  for (int k = lane; k < a.K; k += 32) {
    float d = __bfloat162float(row[k]) - mean;
    v += d * d;
  }
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) {
    a.stats[2LL * warp] = mean;
    a.stats[2LL * warp + 1] = rsqrtf(v / a.K + 1e-6f);
  }
}

__device__ __forceinline__ void wgrad_block(const Args& a, int bx, int by, int bz,
                                            unsigned char* smem) {
  bf16* As = reinterpret_cast<bf16*>(smem);                  // P(A)  [m][k]
  bf16* Bs = As + BR * LDS;                                  // P(dY) [m][n]
  float* Cs = reinterpret_cast<float*>(Bs + BR * LDS);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int bn = bx * BT, bk = by * BT, s = bz;
  const long long m_lo = (long long)s * a.rows_per_split;
  const long long m_hi = min((long long)a.M, m_lo + a.rows_per_split);
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  const bool do_db = by == 0;
  float db = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (long long m0 = m_lo; m0 < m_hi; m0 += BR) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS, r = idx >> 3, c8 = (idx & 7) * 8;
      const long long gm = m0 + r;
      const bool row_ok = gm < m_hi;
      // P(A): 8 columns k.. of row gm
      const int gk = bk + c8;
      float f[8];
      if (row_ok && gk < a.K) {
        uint4 raw = *reinterpret_cast<const uint4*>(a.x + gm * a.ld_x + gk);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float2 t = __bfloat1622float2(h[e]);
          f[2 * e] = t.x;
          f[2 * e + 1] = t.y;
        }
        if (a.ln) {
          const float mean = a.stats[2 * gm], rstd = a.stats[2 * gm + 1];
          const long long mb = (gm / a.rows_per_mod) * a.ld_mod + gk;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            f[e] = (f[e] - mean) * rstd * (1.0f + __bfloat162float(a.scale[mb + e]))
                   + __bfloat162float(a.shift[mb + e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) As[r * LDS + c8 + e] = __float2bfloat16(f[e]);
      // P(dY): 8 columns n.. of row gm
      const int gn = bn + c8;
      stage_dy8(a, gm, gn, row_ok && gn < a.N, Bs + r * LDS + c8);
    }
    __syncthreads();
    if (do_db && tid < BT) {
#pragma unroll 8
      for (int r = 0; r < BR; ++r) db += __bfloat162float(Bs[r * LDS + tid]);
    }
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + kk * LDS + wr + i * 16, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + kk * LDS + wc + j * 16, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr + i * 16) * LDC + wc + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  float* part = a.part + (long long)s * a.K * a.N;
  for (int idx = tid; idx < BT * BT; idx += THREADS) {
    const int r = idx / BT, c = idx % BT, gk = bk + r, gn = bn + c;
    if (gk < a.K && gn < a.N) part[(long long)gk * a.N + gn] = Cs[r * LDC + c];
  }
  if (do_db && tid < BT && bn + tid < a.N) a.part_db[(long long)s * a.N + bn + tid] = db;
}

}  // namespace lbwd
