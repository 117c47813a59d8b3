// linear_bwd.cuh: the block bodies of linear_bwd.cu (the design note is
// there), as device functions over a block index and a shared-memory
// buffer, so that linear_bwd.cu's kernels and the merged layer backward
// (fused_layer_bwd.cu) run the same code. A block is THREADS threads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "rope_tile.cuh"

namespace lbwd {

typedef __nv_bfloat16 bf16;
using attn_tile::mma16816;
using rope_tile::ldsm_x4;
using rope_tile::ldsm_x4_t;
using rope_tile::smem_u32;

// the output tile (TILE x TILE), the reduction chunk of one ring stage, the
// ring's depth; 4 warps of 64 x 64
constexpr int TILE = 128, BK = 32, STAGES = 4, THREADS = 128;
constexpr int LDK = BK + 8;     // bf16 row stride of a [TILE][BK] stage (80 bytes)
constexpr int LDT = TILE + 8;   // bf16 row stride of a [BK][TILE] stage (272 bytes)
// one stage: the two bf16 operand tiles
constexpr size_t DGRAD_STAGE = 2 * TILE * LDK * 2;           // dY [m][n], W [k][n]
constexpr size_t WGRAD_STAGE = 2 * BK * LDT * 2;             // A [m][k], dY [m][n]
constexpr size_t DGRAD_SMEM = STAGES * DGRAD_STAGE;          // 81,920 bytes
constexpr size_t WGRAD_SMEM = STAGES * WGRAD_STAGE;          // 69,632 bytes

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
  int mode;                                 // 0 dgrad, 1 wgrad
  bf16* pdy; bf16* pa;                      // the prologue's bf16 P(dY) (M, N), P(A) (M, K), or null
};

// The arguments of one call (the C entry point's, in its order); wgrad
// partials and row statistics go to scratch (splits * (K*N + N) f32, then
// 2M rounded up to a multiple of 4).
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
  a.mode = mode; a.pdy = nullptr; a.pa = nullptr;
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

// Where the prologue is not the identity (P(dY) = bf16(dY * gate) of an f32
// or gated dY; P(A) = bf16(modulate(LN(X))) of a wgrad with ln), the bf16
// buffers it goes to: prologue_block makes them once per element, and the
// GEMM bodies take the plain bf16 operands of gemm_args.
inline Args with_prologue(Args a, void* pdy, void* pa) {
  a.pdy = (a.dy_f32 || a.gate != nullptr) ? static_cast<bf16*>(pdy) : nullptr;
  a.pa = (a.mode == 1 && a.ln) ? static_cast<bf16*>(pa) : nullptr;
  return a;
}

__host__ __device__ inline Args gemm_args(const Args& a) {
  Args b = a;
  if (a.pdy != nullptr) {
    b.dy = a.pdy; b.dy_f32 = 0; b.ld_dy = a.N; b.gate = nullptr;
  }
  if (a.pa != nullptr) {
    b.x = a.pa; b.ld_x = a.K; b.ln = 0;
  }
  return b;
}

// the prologue's 8-element chunks: P(dY)'s, then P(A)'s
__host__ __device__ inline long long prologue_chunks(const Args& a) {
  return (a.pdy != nullptr ? (long long)a.M * (a.N / 8) : 0) +
         (a.pa != nullptr ? (long long)a.M * (a.K / 8) : 0);
}

// the grids of the bodies
inline dim3 dgrad_grid(const Args& a) {
  return dim3((a.K + TILE - 1) / TILE, (a.M + TILE - 1) / TILE);
}
inline unsigned stats_blocks(const Args& a) {
  return (unsigned)(((long long)a.M * 32 + THREADS - 1) / THREADS);
}
inline unsigned prologue_blocks(const Args& a) {
  return (unsigned)((prologue_chunks(a) + THREADS - 1) / THREADS);
}
inline dim3 wgrad_grid(const Args& a) {
  return dim3((a.N + TILE - 1) / TILE, (a.K + TILE - 1) / TILE, a.splits);
}

// ---------------------------------------------------------------------------
// pieces: asynchronous copies, the prologues, the 64 x 64 warp product
// ---------------------------------------------------------------------------

// 16 bytes global -> shared, zeros where !ok (no bytes read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) { return attn_tile::pack2(lo, hi); }

// n = 4 or 8 consecutive bf16 of a read-only row as f32: one vector load
// where the address allows it
template <int n>
__device__ __forceinline__ void ldg_bf(float* f, const bf16* p) {
  uint32_t w[n / 2];
  if ((reinterpret_cast<uintptr_t>(p) & (2 * n - 1)) == 0) {
    if constexpr (n == 8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x; w[1] = u.y;
    }
#pragma unroll
    for (int e = 0; e < n / 2; ++e) {
      const float2 t = rope_tile::unpack_bf2(w[e]);
      f[2 * e] = t.x;
      f[2 * e + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < n; ++e) f[e] = __bfloat162float(__ldg(p + e));
  }
}

// row r's row of a per-element table (gate, shift, scale): r / rows_per
// (32-bit: M < 2^31)
__device__ __forceinline__ long long table_row(long long r, int rows_per, long long ld) {
  return (long long)((int)r / rows_per) * ld;
}

// P(dY) of 4 f32 values (columns c.. of row r): times the gate row, bf16
__device__ __forceinline__ uint2 gate4_f32(const Args& a, long long r, int c, float4 v) {
  if (a.gate != nullptr) {
    float g[4];
    ldg_bf<4>(g, a.gate + table_row(r, a.rows_per_gate, a.ld_gate) + c);
    v.x *= g[0]; v.y *= g[1]; v.z *= g[2]; v.w *= g[3];
  }
  return make_uint2(pack_bf2(v.x, v.y), pack_bf2(v.z, v.w));
}

// P(dY) of 8 bf16 values of dY in place (columns c.. of row r): times the gate row
__device__ __forceinline__ void gate8_bf16(const Args& a, long long r, int c, uint4* p) {
  float g[8];
  ldg_bf<8>(g, a.gate + table_row(r, a.rows_per_gate, a.ld_gate) + c);
  uint32_t w[4] = {p->x, p->y, p->z, p->w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = rope_tile::unpack_bf2(w[e]);
    w[e] = pack_bf2(f.x * g[2 * e], f.y * g[2 * e + 1]);
  }
  *p = make_uint4(w[0], w[1], w[2], w[3]);
}

// P(A) = bf16(modulate(LN(x))) of 8 bf16 values of X in place (columns
// k.. of row r; LN non-affine, eps 1e-6, statistics from row_stats_block)
__device__ __forceinline__ void ln8(const Args& a, long long r, int k, uint4* p) {
  const float2 st = *reinterpret_cast<const float2*>(a.stats + 2 * r);  // mean, rstd
  const long long mb = table_row(r, a.rows_per_mod, a.ld_mod) + k;
  float sc[8], sh[8];
  ldg_bf<8>(sc, a.scale + mb);
  ldg_bf<8>(sh, a.shift + mb);
  uint32_t w[4] = {p->x, p->y, p->z, p->w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = rope_tile::unpack_bf2(w[e]);
    const int j = 2 * e;
    w[e] = pack_bf2((f.x - st.x) * st.y * (1.0f + sc[j]) + sh[j],
                    (f.y - st.x) * st.y * (1.0f + sc[j + 1]) + sh[j + 1]);
  }
  *p = make_uint4(w[0], w[1], w[2], w[3]);
}

// The prologue: chunk e of 8 elements of P(dY) or P(A) into its dense
// bf16 buffer (with_prologue), THREADS chunks per block; reads stats from
// row_stats_block for the LN prologue.
__device__ __forceinline__ void prologue_block(const Args& a, int bx) {
  const long long e = (long long)bx * THREADS + threadIdx.x;
  const long long ndy = a.pdy != nullptr ? (long long)a.M * (a.N / 8) : 0;
  if (e < ndy) {
    const long long r = e / (a.N / 8);
    const int c = (int)(e % (a.N / 8)) * 8;
    uint4 u;
    if (a.dy_f32) {
      const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(a.dy) + r * a.ld_dy + c);
      const uint2 lo = gate4_f32(a, r, c, p[0]), hi = gate4_f32(a, r, c + 4, p[1]);
      u = make_uint4(lo.x, lo.y, hi.x, hi.y);
    } else {
      u = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.dy) + r * a.ld_dy + c);
      gate8_bf16(a, r, c, &u);
    }
    *reinterpret_cast<uint4*>(a.pdy + r * a.N + c) = u;
  } else if (a.pa != nullptr && e - ndy < (long long)a.M * (a.K / 8)) {
    const long long r = (e - ndy) / (a.K / 8);
    const int k = (int)((e - ndy) % (a.K / 8)) * 8;
    uint4 u = *reinterpret_cast<const uint4*>(a.x + r * a.ld_x + k);
    ln8(a, r, k, &u);
    *reinterpret_cast<uint4*>(a.pa + r * a.K + k) = u;
  }
}

// acc (64 x 64 of the warp at rows wi, columns wj of the tile) += the
// stage's product; A_T / B_T: the operand is staged [reduction][tile]
// (ldmatrix.trans) rather than [tile][reduction]. With do_db (wgrad, first
// k-tile) the warp also sums the dY columns into db on the tensor cores, a
// ones fragment times the B fragments it holds, on 16-deep step `db_step`.
template <bool A_T, bool B_T>
__device__ __forceinline__ void stage_product(float (*acc)[8][4], const bf16* As, const bf16* Bs,
                                              int wi, int wj, bool do_db, float (*db)[4],
                                              int db_step) {
  constexpr int SA = A_T ? LDT : LDK, SB = B_T ? LDT : LDK;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    uint32_t af[4][4], bfr[8][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int i0 = wi + mi * 16;
      if (A_T)
        ldsm_x4_t(af[mi], As + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * SA + i0 +
                              (((lane >> 3) & 1) << 3));
      else
        ldsm_x4(af[mi], As + (i0 + (lane & 15)) * SA + ks * 16 + ((lane >> 4) << 3));
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int j0 = wj + p * 16;
      uint32_t r[4];
      if (B_T)
        ldsm_x4_t(r, Bs + (ks * 16 + (lane & 15)) * SB + j0 + ((lane >> 4) << 3));
      else
        ldsm_x4(r, Bs + (j0 + (lane & 7) + ((lane >> 4) << 3)) * SB + ks * 16 +
                       (((lane >> 3) & 1) << 3));
      bfr[2 * p][0] = r[0];
      bfr[2 * p][1] = r[1];
      bfr[2 * p + 1][0] = r[2];
      bfr[2 * p + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) mma16816(acc[mi][nj], af[mi], bfr[nj][0], bfr[nj][1]);
    if (do_db && ks == db_step) {
      const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) mma16816(db[nj], ones, bfr[nj][0], bfr[nj][1]);
    }
  }
}

__device__ __forceinline__ void zero(float (*acc)[8][4]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;
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
// dgrad: block (bx, by) = 128 rows of M x 128 columns of K; reduction over N
// in chunks of 32 through the cp.async ring; a = gemm_args(...): dY bf16
// ---------------------------------------------------------------------------
__device__ __forceinline__ void dgrad_block(const Args& a, int bx, int by, unsigned char* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const long long m0 = (long long)by * TILE;
  const int k0 = bx * TILE, wi = (warp >> 1) * 64, wj = (warp & 1) * 64;
  const int nk = (a.N + BK - 1) / BK;
  const bf16* dy = static_cast<const bf16*>(a.dy);
  auto dy_st = [&](int s) { return reinterpret_cast<bf16*>(smem + s * DGRAD_STAGE); };
  auto w_st = [&](int s) { return reinterpret_cast<bf16*>(smem + s * DGRAD_STAGE) + TILE * LDK; };

  auto issue = [&](int kt, int s) {  // dY [128 m][32 n] and W [128 k][32 n]: 4 + 4 chunks a thread
    const int n0 = kt * BK;
    bf16 *dd = dy_st(s), *wd = w_st(s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = i * THREADS + tid, row = c >> 2, col = (c & 3) * 8;
      const bool ok = m0 + row < a.M && n0 + col < a.N;
      cp16(dd + row * LDK + col, ok ? dy + (m0 + row) * a.ld_dy + n0 + col : dy, ok);
      const bool okw = k0 + row < a.K && n0 + col < a.N;
      cp16(wd + row * LDK + col, okw ? a.x + (long long)(k0 + row) * a.ld_x + n0 + col : a.x, okw);
    }
  };

  float acc[4][8][4];
  zero(acc);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed everywhere; stage kt - 1 is read by no one
    if (kt + STAGES - 1 < nk) issue(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_commit();
    stage_product<false, false>(acc, dy_st(s), w_st(s), wi, wj, false, acc[0], 0);
  }
  cp_wait<0>();

  // epilogue: times gelu'(act) (all of act read before the first store, 8
  // loads in flight at a time: the loads cannot pass a store to a.out), then
  // f32 or bf16 pairs straight from the accumulators
  if (a.act != nullptr) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long gm = m0 + wi + mi * 16 + gid + 8 * h;
        float2 t[8];
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          const int gk = k0 + wj + nj * 8 + tig * 2;
          t[nj] = gm < a.M && gk < a.K
                      ? __ldg(reinterpret_cast<const float2*>(a.act + gm * a.ld_act + gk))
                      : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          acc[mi][nj][2 * h] *= gelu_fast_grad(t[nj].x);
          acc[mi][nj][2 * h + 1] *= gelu_fast_grad(t[nj].y);
        }
      }
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long gm = m0 + wi + mi * 16 + gid + 8 * h;
      if (gm >= a.M) continue;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const int gk = k0 + wj + nj * 8 + tig * 2;
        if (gk >= a.K) continue;
        const float v0 = acc[mi][nj][2 * h], v1 = acc[mi][nj][2 * h + 1];
        if (a.out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + gm * a.ld_out + gk) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.out) + gm * a.ld_out + gk) = pack_bf2(v0, v1);
      }
    }
}

// ---------------------------------------------------------------------------
// wgrad: block (bx, by, bz) = 128 rows of K x 128 columns of N over split bz
// of the M rows, reduction over M in chunks of 32 through the ring (a =
// gemm_args(...): A and dY bf16); writes its f32 partial tile (and, on the
// first k-tile, the partial column sums of P(dY) for db)
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
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int n0 = bx * TILE, k0 = by * TILE, s_ = bz;
  const int wi = (warp >> 1) * 64, wj = (warp & 1) * 64;
  const long long m_lo = (long long)s_ * a.rows_per_split;
  const long long m_hi = min((long long)a.M, m_lo + a.rows_per_split);
  const int nk = m_hi > m_lo ? (int)((m_hi - m_lo + BK - 1) / BK) : 0;
  const bool do_db = by == 0;
  const bf16* dy = static_cast<const bf16*>(a.dy);
  auto a_st = [&](int s) { return reinterpret_cast<bf16*>(smem + s * WGRAD_STAGE); };
  auto dy_st = [&](int s) { return reinterpret_cast<bf16*>(smem + s * WGRAD_STAGE) + BK * LDT; };

  auto issue = [&](int kt, int s) {  // A [32 m][128 k] and dY [32 m][128 n]: 4 + 4 chunks a thread
    const long long r0 = m_lo + (long long)kt * BK;
    bf16 *ad = a_st(s), *dd = dy_st(s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = i * THREADS + tid, row = c >> 4, col = (c & 15) * 8;
      const bool row_ok = r0 + row < m_hi;
      const bool ok = row_ok && k0 + col < a.K;
      cp16(ad + row * LDT + col, ok ? a.x + (r0 + row) * a.ld_x + k0 + col : a.x, ok);
      const bool okd = row_ok && n0 + col < a.N;
      cp16(dd + row * LDT + col, okd ? dy + (r0 + row) * a.ld_dy + n0 + col : dy, okd);
    }
  };

  float acc[4][8][4], db[8][4];
  zero(acc);
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) db[nj][0] = db[nj][1] = db[nj][2] = db[nj][3] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed everywhere; stage kt - 1 is read by no one
    if (kt + STAGES - 1 < nk) issue(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_commit();
    stage_product<true, true>(acc, a_st(s), dy_st(s), wi, wj, do_db, db, warp >> 1);
  }
  cp_wait<0>();

  float* part = a.part + (long long)s_ * a.K * a.N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gk = k0 + wi + mi * 16 + gid + 8 * h;
      if (gk >= a.K) continue;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const int gn = n0 + wj + nj * 8 + tig * 2;
        if (gn < a.N)
          *reinterpret_cast<float2*>(part + (long long)gk * a.N + gn) =
              make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
    }
  if (do_db) {
    // the two warps of a column half took alternate 16-row steps: the upper
    // one hands its sums over, the lower one adds them (a fixed order)
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
    if (warp >= 2 && gid == 0)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        red[wj + nj * 8 + tig * 2] = db[nj][0];
        red[wj + nj * 8 + tig * 2 + 1] = db[nj][1];
      }
    __syncthreads();
    if (warp < 2 && gid == 0)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const int c = wj + nj * 8 + tig * 2;
        if (n0 + c < a.N) {
          a.part_db[(long long)s_ * a.N + n0 + c] = db[nj][0] + red[c];
          a.part_db[(long long)s_ * a.N + n0 + c + 1] = db[nj][1] + red[c + 1];
        }
      }
  }
}

}  // namespace lbwd
