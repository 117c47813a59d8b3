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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "colsum.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BT = 64, BR = 32, THREADS = 128;  // output tile, reduction chunk
constexpr int LDS = BT + 8;                      // bf16 row stride of a 64-wide stage
constexpr int LDR = BR + 8;                      // bf16 row stride of a 32-wide stage
constexpr int LDC = BT + 4;                      // f32 stride of the staged output

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
// dgrad: block = 64 rows of M x 64 columns of K; reduction over N by 32
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) dgrad_kernel(Args a) {
  __shared__ __align__(32) bf16 As[BT * LDR];   // P(dY) [m][n]
  __shared__ __align__(32) bf16 Bs[BT * LDR];   // W     [k][n]
  __shared__ __align__(32) float Cs[BT * LDC];
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long bm = (long long)blockIdx.y * BT;
  const int bk = blockIdx.x * BT;
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
// wgrad: block = 64 rows of K x 64 columns of N over one split of M rows,
// reduction over M by 32; writes its f32 partial tile (and, on the first
// k-tile, the partial column sums of P(dY) for db)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) row_stats_kernel(Args a) {
  // mean and rstd of each row of X (M, K): one warp per row, two passes
  const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5, lane = threadIdx.x & 31;
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

__global__ void __launch_bounds__(THREADS) wgrad_kernel(Args a) {
  __shared__ __align__(32) bf16 As[BR * LDS];   // P(A)  [m][k]
  __shared__ __align__(32) bf16 Bs[BR * LDS];   // P(dY) [m][n]
  __shared__ __align__(32) float Cs[BT * LDC];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int bn = blockIdx.x * BT, bk = blockIdx.y * BT, s = blockIdx.z;
  const long long m_lo = (long long)s * a.rows_per_split;
  const long long m_hi = min((long long)a.M, m_lo + a.rows_per_split);
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  const bool do_db = blockIdx.y == 0;
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

}  // namespace

extern "C" int linear_bwd(int mode,
                          const void* dy, int dy_f32, long long ld_dy,
                          const void* gate, long long ld_gate, int rows_per_gate,
                          const void* x, long long ld_x, const void* act, long long ld_act,
                          int ln, const void* shift, const void* scale, long long ld_mod,
                          int rows_per_mod,
                          void* out, int out_f32, long long ld_out, void* db, void* scratch,
                          int splits, int M, int N, int K, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    a.part = nullptr; a.part_db = nullptr; a.stats = nullptr;
    dim3 grid((K + BT - 1) / BT, (M + BT - 1) / BT);
    dgrad_kernel<<<grid, THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  float* sc = static_cast<float*>(scratch);
  a.part = sc;
  a.part_db = sc + (long long)a.splits * K * N;
  a.stats = a.part_db + (long long)a.splits * N;
  if (ln) {
    row_stats_kernel<<<(unsigned)(((long long)M * 32 + THREADS - 1) / THREADS), THREADS, 0, s>>>(a);
    int e = (int)cudaGetLastError();
    if (e) return e;
  }
  dim3 grid((N + BT - 1) / BT, (K + BT - 1) / BT, a.splits);
  wgrad_kernel<<<grid, THREADS, 0, s>>>(a);
  int e = (int)cudaGetLastError();
  if (e) return e;
  e = colsum::launch(a.part, static_cast<float*>(out), a.splits, (long long)K * N,
                     (long long)K * N, 0, s);
  if (e) return e;
  return colsum::launch(a.part_db, static_cast<float*>(db), a.splits, N, N, 0, s);
}
