// adaln_linear.cuh: the resident and pipelined tilings of adaln_linear.cu
// (the design note is there) as device functions over a block index and a
// shared-memory buffer, so that adaln_linear.cu's kernels and the merged
// layer backward (fused_layer_bwd.cu) run the same code; with the
// epilogues, the argument struct and the host-side routing they share.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace adaln {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;


constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LDA_S = BK + 8;   // bf16 elements; multiple of 8 for wmma
constexpr int LDB_S = BN + 8;
constexpr int LDC_S = BN + 4;   // f32 elements; multiple of 4 for wmma

enum { LN_NONE = 0, LN_PLAIN = 1, LN_AFFINE = 2 };
enum { EPI_NONE = 0, EPI_GELU = 1, EPI_GATE_RES = 2, EPI_EULER = 3, EPI_ADD = 4 };

struct Args {
  const void* x; long long lda;
  const bf16* w;                 // (K, N) row-major
  const bf16* bias;              // (N,) or null
  void* out; long long ldo;
  int M, N, K;
  int ln_mode;
  const float* ln_w; const float* ln_b;
  const bf16* shift; const bf16* scale; long long ld_mod; int rows_per_mod;
  int epi;
  const void* res; long long ldr;
  const bf16* gate; long long ld_gate; int rows_per_gate;
  float dt;
  const bf16* add1; long long ld_add1;
  const bf16* add2; long long ld_add2; int a2_div, a2_mul, a2_mod;
  float* pre; long long ldp;   // GELU: the f32 pre-activation, or null
  int vec_epi;   // epilogue operands allow 8-column (16-byte) access
  int vec_mod;   // shift/scale rows allow 16-byte loads
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float bf_round(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float gelu_fast(float a) {
  // mdgen_finetune_tpu/ops/adaln_mlp.py::_gelu_fast
  const float k0 = 0.798055917732286f, k1 = 0.12003597204164997f,
              k2 = 0.01547196081666821f, k3 = 0.0005614901736225192f,
              k4 = 0.00014934348411800474f;
  if (a < -6.0f) return 0.0f;
  float z = fminf(fmaxf(a, -6.0f), 6.0f);
  float u = z * z;
  float p = (((k4 * u + k3) * u + k2) * u + k1) * u + k0;
  float t = z * p;
  float f = t * rsqrtf(1.0f + t * t);
  return a * (0.5f + 0.5f * f);
}

// the fused epilogue on one output element (row gr, column gc)
__device__ __forceinline__ float epilogue(const Args& a, float accv, int gr, int gc) {
  float b = a.bias != nullptr ? __bfloat162float(a.bias[gc]) : 0.f;
  float y;
  switch (a.epi) {
    case EPI_GELU:
      if (a.pre != nullptr) a.pre[(long long)gr * a.ldp + gc] = accv + b;
      y = gelu_fast(accv + b);
      break;
    case EPI_GATE_RES: {
      float g = 1.f;
      if (a.gate != nullptr)
        g = __bfloat162float(a.gate[(long long)(gr / a.rows_per_gate) * a.ld_gate + gc]);
      float res = __bfloat162float(static_cast<const bf16*>(a.res)[(long long)gr * a.ldr + gc]);
      y = res + g * (accv + b);
      break;
    }
    case EPI_EULER: {
      float v = bf_round(bf_round(accv) + b);
      float carry = static_cast<const float*>(a.res)[(long long)gr * a.ldr + gc];
      y = carry + a.dt * v;
      break;
    }
    case EPI_ADD: {
      y = bf_round(accv + b);
      if (a.add1 != nullptr) y = bf_round(y + __bfloat162float(a.add1[(long long)gr * a.ld_add1 + gc]));
      if (a.add2 != nullptr) {
        long long r2 = (long long)(gr / a.a2_div) * a.a2_mul + gr % a.a2_mod;
        y = bf_round(y + __bfloat162float(a.add2[r2 * a.ld_add2 + gc]));
      }
      break;
    }
    default:
      y = accv + b;
  }
  return y;
}

// ---------------------------------------------------------------------------
// shared pieces of the pipelined tilings
// ---------------------------------------------------------------------------
__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void store8(bf16* p, const float* y) {
  *reinterpret_cast<uint4*>(p) = pack8(y);
}
__device__ __forceinline__ void store8(float* p, const float* y) {
  reinterpret_cast<float4*>(p)[0] = make_float4(y[0], y[1], y[2], y[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(y[4], y[5], y[6], y[7]);
}

// the fused epilogue on 8 consecutive columns gc..gc+7 of row gr (a.vec_epi)
template <typename OT>
__device__ __forceinline__ void epilogue8(const Args& a, const float* c, int gr, int gc, OT* O) {
  float b[8], y[8], t[8];
  if (a.bias != nullptr) load8(a.bias + gc, b);
  else {
#pragma unroll
    for (int e = 0; e < 8; ++e) b[e] = 0.f;
  }
  switch (a.epi) {
    case EPI_GELU:
#pragma unroll
      for (int e = 0; e < 8; ++e) t[e] = c[e] + b[e];
      if (a.pre != nullptr) store8(a.pre + (long long)gr * a.ldp + gc, t);
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = gelu_fast(t[e]);
      break;
    case EPI_GATE_RES: {
      float g[8];
      if (a.gate != nullptr) load8(a.gate + (long long)(gr / a.rows_per_gate) * a.ld_gate + gc, g);
      else {
#pragma unroll
        for (int e = 0; e < 8; ++e) g[e] = 1.f;
      }
      load8(static_cast<const bf16*>(a.res) + (long long)gr * a.ldr + gc, t);
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = t[e] + g[e] * (c[e] + b[e]);
      break;
    }
    case EPI_EULER: {
      const float4* cr = reinterpret_cast<const float4*>(static_cast<const float*>(a.res) + (long long)gr * a.ldr + gc);
      float4 u = cr[0], v = cr[1];
      float carry[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = carry[e] + a.dt * bf_round(bf_round(c[e]) + b[e]);
      break;
    }
    case EPI_ADD: {
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = bf_round(c[e] + b[e]);
      if (a.add1 != nullptr) {
        load8(a.add1 + (long long)gr * a.ld_add1 + gc, t);
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = bf_round(y[e] + t[e]);
      }
      if (a.add2 != nullptr) {
        long long r2 = (long long)(gr / a.a2_div) * a.a2_mul + gr % a.a2_mod;
        load8(a.add2 + r2 * a.ld_add2 + gc, t);
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = bf_round(y[e] + t[e]);
      }
      break;
    }
    default:
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = c[e] + b[e];
  }
  store8(O + (long long)gr * a.ldo + gc, y);
}

// write a staged BMxBN f32 tile (row stride LDC) through the epilogue
template <int BM, int BN, int LDC, int THR, typename OT>
__device__ __forceinline__ void write_tile(const Args& a, const float* Cs, int bm, int bn, OT* O) {
  const int tid = threadIdx.x;
  if (a.vec_epi) {
    for (int idx = tid; idx < BM * BN / 8; idx += THR) {
      int r = idx / (BN / 8), c8 = (idx % (BN / 8)) * 8;
      int gr = bm + r, gc = bn + c8;
      if (gr >= a.M || gc >= a.N) continue;
      const float4* cp = reinterpret_cast<const float4*>(Cs + r * LDC + c8);
      float4 u = cp[0], v = cp[1];
      float c[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
      epilogue8(a, c, gr, gc, O);
    }
    return;
  }
  for (int idx = tid; idx < BM * BN; idx += THR) {
    int r = idx / BN, col = idx % BN;
    int gr = bm + r, gc = bn + col;
    if (gr < a.M && gc < a.N)
      store(O + (long long)gr * a.ldo + gc, epilogue(a, Cs[r * LDC + col], gr, gc));
  }
}

// 16-byte global -> shared copy that bypasses registers; zero-fills when !pred
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

constexpr int PBK = 32, PBN = 128, PLDB = PBN + 8, PB_ELEMS = PBK * PLDB;

// one BK x 128 slab of W (rows k0.., columns bn..) into a ring slot
template <int THR>
__device__ __forceinline__ void load_b_slab(const Args& a, bf16* slot, int k0, int bn, int tid) {
#pragma unroll
  for (int i = 0; i < PBK * PBN / 8 / THR; ++i) {
    int idx = tid + i * THR, kr = idx >> 4, nv = (idx & 15) * 8;
    int gk = k0 + kr, gn = bn + nv;
    bool ok = gk < a.K && gn < a.N;
    cp_async16(slot + kr * PLDB + nv, ok ? a.w + (long long)gk * a.N + gn : a.w, ok);
  }
}

// per-row LayerNorm statistics of rows bm.. (16-byte loads, two passes)
template <int BMR, int THR>
__device__ __forceinline__ void row_stats(const Args& a, int bm, float* s_mean, float* s_rstd) {
  const bf16* X = static_cast<const bf16*>(a.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BMR; r += THR / 32) {
    int gr = bm + r;
    float mean = 0.f, rstd = 0.f;
    if (gr < a.M) {
      const bf16* row = X + (long long)gr * a.lda;
      float s = 0.f, f[8];
      for (int k = lane * 8; k < a.K; k += 256) {
        unpack8(*reinterpret_cast<const uint4*>(row + k), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += f[e];
      }
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      mean = s / a.K;
      float v = 0.f;
      for (int k = lane * 8; k < a.K; k += 256) {
        unpack8(*reinterpret_cast<const uint4*>(row + k), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) { float d = f[e] - mean; v += d * d; }
      }
      for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      rstd = rsqrtf(v / a.K + (a.ln_mode == LN_PLAIN ? 1e-6f : 1e-5f));
    }
    if (lane == 0) { s_mean[r] = mean; s_rstd[r] = rstd; }
  }
}

// ---------------------------------------------------------------------------
// resident: K <= 512. A block owns 64 rows: it normalises and modulates them
// ONCE into shared memory (bf16, the whole K), then walks its share of the
// N/128 column chunks, streaming W through a 4-stage cp.async ring. Four
// warps, 32x64 each. The epilogue staging reuses the ring.
// ---------------------------------------------------------------------------
namespace rs {
constexpr int BM = 64, THREADS = 128, NSTAGE = 4, KMAX = 512, LDC = PBN + 4;
constexpr size_t RING = (size_t)NSTAGE * PB_ELEMS * sizeof(bf16);
constexpr size_t CST = (size_t)BM * LDC * sizeof(float);
static_assert(CST <= RING, "epilogue staging must fit in the ring");
__host__ __device__ constexpr size_t a_bytes(int K) {
  return (((size_t)BM * (K + 8) * sizeof(bf16)) + 127) & ~(size_t)127;
}
__host__ __device__ constexpr size_t smem(int K) { return a_bytes(K) + RING + 2 * BM * sizeof(float); }
}  // namespace rs

template <typename OT>
__device__ __forceinline__ void resident_block(const Args& a, int bx, int by,
                                               int chunks_per_block, unsigned char* smem_raw) {
  constexpr int BM = rs::BM, THREADS = rs::THREADS, NSTAGE = rs::NSTAGE, LDC = rs::LDC;
  const int K = a.K, LDA = K + 8;
  bf16* Ar = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + rs::a_bytes(K));
  float* Cs = reinterpret_cast<float*>(ring);
  float* s_mean = reinterpret_cast<float*>(smem_raw + rs::a_bytes(K) + rs::RING);
  float* s_rstd = s_mean + BM;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int bm = bx * BM;
  const int n_chunks = (a.N + PBN - 1) / PBN;
  const int c0 = by * chunks_per_block;
  const int c1 = min(c0 + chunks_per_block, n_chunks);
  const bf16* X = static_cast<const bf16*>(a.x);

  if (a.ln_mode != LN_NONE) {
    row_stats<BM, THREADS>(a, bm, s_mean, s_rstd);
    __syncthreads();
  }
  // ---- the block's rows, prologue applied once, into shared memory ----
  const int kv = K / 8;
  for (int v = tid; v < BM * kv; v += THREADS) {
    int r = v / kv, kc = (v % kv) * 8, gr = bm + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (gr < a.M) {
      raw = *reinterpret_cast<const uint4*>(X + (long long)gr * a.lda + kc);
      if (a.ln_mode != LN_NONE || a.shift != nullptr) {
        float f[8];
        unpack8(raw, f);
        if (a.ln_mode != LN_NONE) {
          float mean = s_mean[r], rstd = s_rstd[r];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            f[e] = (f[e] - mean) * rstd;
            if (a.ln_mode == LN_AFFINE) f[e] = f[e] * a.ln_w[kc + e] + a.ln_b[kc + e];
          }
        }
        if (a.shift != nullptr) {
          long long mb = (long long)(gr / a.rows_per_mod) * a.ld_mod + kc;
          float sc[8], sh[8];
          if (a.vec_mod) {
            load8(a.scale + mb, sc);
            load8(a.shift + mb, sh);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              sc[e] = __bfloat162float(a.scale[mb + e]);
              sh[e] = __bfloat162float(a.shift[mb + e]);
            }
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = f[e] * (1.0f + sc[e]) + sh[e];
        }
        raw = pack8(f);
      }
    }
    *reinterpret_cast<uint4*>(Ar + r * LDA + kc) = raw;
  }
  __syncthreads();

  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 64;
  const int nslab = K / PBK;
  OT* O = static_cast<OT*>(a.out);
  for (int c = c0; c < c1; ++c) {
    const int bn = c * PBN;
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < nslab) load_b_slab<THREADS>(a, ring + s * PB_ELEMS, s * PBK, bn, tid);
      cp_async_commit();
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int s = 0; s < nslab; ++s) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();
      const int nxt = s + NSTAGE - 1;
      if (nxt < nslab) load_b_slab<THREADS>(a, ring + (nxt % NSTAGE) * PB_ELEMS, nxt * PBK, bn, tid);
      cp_async_commit();
      const bf16* Bsl = ring + (s % NSTAGE) * PB_ELEMS;
#pragma unroll
      for (int kk = 0; kk < PBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], Ar + (wr + i * 16) * LDA + s * PBK + kk, LDA);
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(fb[j], Bsl + kk * PLDB + wc + j * 16, PLDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Cs + (wr + i * 16) * LDC + wc + j * 16, acc[i][j], LDC,
                                wmma::mem_row_major);
    __syncthreads();
    write_tile<BM, PBN, LDC, THREADS>(a, Cs, bm, bn, O);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// pipelined: no prologue, any K (fc2, K = 1,536). 128x128 tiles, eight warps
// (32x64 each), A and W both through a 3-stage cp.async ring; the epilogue
// staging reuses the ring.
// ---------------------------------------------------------------------------
namespace pp {
constexpr int BM = 128, THREADS = 256, NSTAGE = 3, LDA = PBK + 8, LDC = PBN + 4;
constexpr int A_ELEMS = BM * LDA;
constexpr size_t STAGE = (size_t)(A_ELEMS + PB_ELEMS) * sizeof(bf16);
constexpr size_t RING = NSTAGE * STAGE;
constexpr size_t CST = (size_t)BM * LDC * sizeof(float);
constexpr size_t SMEM = RING > CST ? RING : CST;
}  // namespace pp

// The pipelined body for a block of NT threads: its 8 warp tiles (32 x 64
// each, pp::THREADS = 256 threads) are run by NT / 32 warps, each taking
// warp tiles warp, warp + NT / 32, ... with their accumulators side by side,
// so every output element sees the same products in the same order.
template <int NT, typename OT>
__device__ __forceinline__ void pipelined_block(const Args& a, int bx, int by,
                                                unsigned char* smem_raw) {
  constexpr int BM = pp::BM, NSTAGE = pp::NSTAGE, LDA = pp::LDA;
  constexpr int LDC = pp::LDC, A_ELEMS = pp::A_ELEMS;
  constexpr int NW = NT / 32, VW = 8 / NW;  // warps, warp tiles per warp
  static_assert(NW * VW == 8, "a block runs the 8 warp tiles of pp::THREADS threads");
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* Cs = reinterpret_cast<float*>(smem_raw);
  const bf16* X = static_cast<const bf16*>(a.x);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int bm = by * BM, bn = bx * PBN;

  auto load = [&](int slab, int slot) {
    bf16* A = ring + slot * (A_ELEMS + PB_ELEMS);
    const int k0 = slab * PBK;
#pragma unroll
    for (int i = 0; i < BM * PBK / 8 / NT; ++i) {
      int idx = tid + i * NT, r = idx >> 2, kc = (idx & 3) * 8;
      int gr = bm + r, gk = k0 + kc;
      bool ok = gr < a.M && gk < a.K;
      cp_async16(A + r * LDA + kc, ok ? X + (long long)gr * a.lda + gk : X, ok);
    }
    load_b_slab<NT>(a, A + A_ELEMS, k0, bn, tid);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[VW][2][4];
#pragma unroll
  for (int v = 0; v < VW; ++v)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[v][i][j], 0.0f);
  int wr[VW], wc[VW];
#pragma unroll
  for (int v = 0; v < VW; ++v) {
    wr[v] = ((warp + v * NW) >> 1) * 32;
    wc[v] = ((warp + v * NW) & 1) * 64;
  }
  const int nslab = (a.K + PBK - 1) / PBK;
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nslab) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    const int nxt = s + NSTAGE - 1;
    if (nxt < nslab) load(nxt, nxt % NSTAGE);
    cp_async_commit();
    const bf16* A = ring + (s % NSTAGE) * (A_ELEMS + PB_ELEMS);
    const bf16* Bsl = A + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < PBK; kk += 16) {
#pragma unroll
      for (int v = 0; v < VW; ++v) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], A + (wr[v] + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], Bsl + kk * PLDB + wc[v] + j * 16, PLDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[v][i][j], fa[i], fb[j], acc[v][i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int v = 0; v < VW; ++v)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Cs + (wr[v] + i * 16) * LDC + wc[v] + j * 16, acc[v][i][j], LDC,
                                wmma::mem_row_major);
  __syncthreads();
  write_tile<BM, PBN, LDC, NT>(a, Cs, bm, bn, static_cast<OT*>(a.out));
}

// The arguments of one call (the C entry point's, in its order), with the
// 16-byte access flags of the epilogue and modulate operands.
inline Args make_args(const void* x, long long lda, const void* w, const void* bias, void* out,
                      long long ldo, int M, int N, int K, int ln_mode, const void* ln_w,
                      const void* ln_b, const void* shift, const void* scale, long long ld_mod,
                      int rows_per_mod, int epi, const void* res, long long ldr,
                      const void* gate, long long ld_gate, int rows_per_gate, float dt,
                      const void* add1, long long ld_add1, const void* add2, long long ld_add2,
                      int a2_div, int a2_mul, int a2_mod, void* pre, long long ldp) {
  Args a;
  a.x = x; a.lda = lda; a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const bf16*>(bias);
  a.out = out; a.ldo = ldo; a.M = M; a.N = N; a.K = K;
  a.ln_mode = ln_mode;
  a.ln_w = static_cast<const float*>(ln_w); a.ln_b = static_cast<const float*>(ln_b);
  a.shift = static_cast<const bf16*>(shift); a.scale = static_cast<const bf16*>(scale);
  a.ld_mod = ld_mod; a.rows_per_mod = rows_per_mod > 0 ? rows_per_mod : 1;
  a.epi = epi; a.res = res; a.ldr = ldr;
  a.gate = static_cast<const bf16*>(gate); a.ld_gate = ld_gate;
  a.rows_per_gate = rows_per_gate > 0 ? rows_per_gate : 1;
  a.dt = dt;
  a.add1 = static_cast<const bf16*>(add1); a.ld_add1 = ld_add1;
  a.add2 = static_cast<const bf16*>(add2); a.ld_add2 = ld_add2;
  a.a2_div = a2_div > 0 ? a2_div : 1; a.a2_mul = a2_mul;
  a.a2_mod = a2_mod > 0 ? a2_mod : 1;
  a.pre = static_cast<float*>(pre); a.ldp = ldp;
  auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  auto rows8 = [&](const void* p, long long ld) { return p == nullptr || (al16(p) && ld % 8 == 0); };
  a.vec_epi = N % 8 == 0 && rows8(out, ldo) && (bias == nullptr || al16(bias)) &&
              rows8(res, ldr) && rows8(gate, ld_gate) && rows8(add1, ld_add1) &&
              rows8(add2, ld_add2) && rows8(pre, ldp);
  a.vec_mod = rows8(shift, ld_mod) && rows8(scale, ld_mod);
  return a;
}

// which tiling takes a call: 0 resident, 1 pipelined, 2 tiled64
inline int route(const Args& a, int x_f32) {
  const bool aligned = !x_f32 && a.K % 8 == 0 && a.N % 8 == 0 && a.lda % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  if (aligned && a.K % 32 == 0 && a.K <= rs::KMAX) return 0;
  if (aligned && a.ln_mode == LN_NONE && a.shift == nullptr) return 1;
  return 2;
}

// the resident grid: the column chunks split so that about four waves of
// blocks exist; returns the chunks per block
inline int resident_grid(const Args& a, dim3* grid) {
  const int row_blocks = (a.M + rs::BM - 1) / rs::BM, chunks = (a.N + PBN - 1) / PBN;
  int split = (1056 + row_blocks - 1) / row_blocks;
  split = split < 1 ? 1 : (split > chunks ? chunks : split);
  const int per = (chunks + split - 1) / split;
  split = (chunks + per - 1) / per;
  *grid = dim3(row_blocks, split);
  return per;
}

inline dim3 pipelined_grid(const Args& a) {
  return dim3((a.N + PBN - 1) / PBN, (a.M + pp::BM - 1) / pp::BM);
}

}  // namespace adaln
