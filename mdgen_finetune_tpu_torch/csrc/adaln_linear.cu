// adaln_linear: Y = epilogue(prologue(X) @ W + b), bf16 operands, f32 accumulation.
//
// Replaces the projections inside two TPU kernels of the JAX package:
//   - mdgen_finetune_tpu/ops/fused_layer.py::_trunk_call (body _kernel): the
//     folded embed, qkv_l, out_l, qkv_t, out_t, fc1, fc2 and the FinalLayer
//     head with the Euler update;
//   - mdgen_finetune_tpu/ops/ipa_encoder.py::_encoder_call (body _kernel): the
//     IPA scalar/point projections, linear_out, qkv_m, out_m, fc1 and fc2.
//
// Prologue (optional), per row of X, statistics in f32:
//   LN_PLAIN  non-affine LayerNorm, eps 1e-6, then AdaLN modulate
//             h * (1 + scale_b) + shift_b with shift/scale rows per batch
//             element (b = row / rows_per_mod);
//   LN_AFFINE LayerNorm eps 1e-5 with f32 weight/bias (ipa_norm).
// The normalised row is rounded to bf16 as it is staged for the tensor cores.
// Epilogue (optional), on y = acc + bias:
//   GELU      the algebraic-sigmoid erf fit (_gelu_fast) in f32; with a
//             second output `pre` it also writes the f32 pre-activation
//             acc + bias (the training backward's recompute of an MLP takes
//             both from one product, as _pallas_bwd takes GELU and GELU'
//             from one `a`, mdgen_finetune_tpu/ops/adaln_mlp.py:173-177);
//   GATE_RES  res + gate_b * y (gate absent = 1), may write over res;
//   EULER     carry + dt * bf16(bf16(acc) + bias) into an f32 carry (in place);
//   ADD       bf16(bf16(bf16(acc) + add1[row]) + add2[map(row)]): the embed,
//             map(row) = (row / a2_div) * a2_mul + row % a2_mod.
//
// What bounds it on the H100: at the trunk's shapes (M = 25,600 rows,
// K = 384 or 1,536, N up to 1,536) the products do 2*M*N*K ~ 1e10-3e10 FLOP
// against 20-80 MB of traffic, about 400 FLOP/byte, so it sits above the
// 295 FLOP/byte ridge: the tensor cores bound it. Three tilings, all bf16
// WMMA (mma.sync) at f32 accumulation with the LayerNorm/modulate prologue
// and every epilogue fused, so no normalised activation or pre-activation
// ever goes to device memory:
//   - resident (16-byte-aligned bf16 X and W, K <= 512 and a multiple of 32:
//     qkv, out, fc1, the IPA projections): a block normalises its 64 rows
//     once into shared memory, then walks its share of the 128-column
//     chunks with W streamed through a 4-stage cp.async ring, so the
//     prologue is not repeated for every column tile;
//   - pipelined (aligned, no prologue, any K: fc2): 128x128 tiles with a
//     3-stage cp.async ring for both operands;
//   - tiled64 (everything else: the f32 carry of the embed, N = 21 of the
//     output head): 64x64 tiles, scalar loads, one stage.
// None uses wgmma or TMA yet; that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

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

template <typename AT, typename OT>
__global__ void __launch_bounds__(THREADS) tiled64_kernel(Args a) {
  __shared__ __align__(32) bf16 As[BM * LDA_S];
  __shared__ __align__(32) bf16 Bs[BK * LDB_S];
  __shared__ __align__(32) float Cs[BM * LDC_S];
  __shared__ float s_mean[BM], s_rstd[BM];

  const AT* X = static_cast<const AT*>(a.x);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;

  // ---- per-row LayerNorm statistics (two passes over the row, f32) ----
  if (a.ln_mode != LN_NONE) {
    for (int r = warp; r < BM; r += THREADS / 32) {
      int gr = bm + r;
      float mean = 0.f, rstd = 0.f;
      if (gr < a.M) {
        const AT* row = X + (long long)gr * a.lda;
        float s = 0.f;
        for (int k = lane; k < a.K; k += 32) s += to_f(row[k]);
        for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        mean = s / a.K;
        float v = 0.f;
        for (int k = lane; k < a.K; k += 32) { float d = to_f(row[k]) - mean; v += d * d; }
        for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        float eps = a.ln_mode == LN_PLAIN ? 1e-6f : 1e-5f;
        rstd = rsqrtf(v / a.K + eps);
      }
      if (lane == 0) { s_mean[r] = mean; s_rstd[r] = rstd; }
    }
    __syncthreads();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;  // warp's 32x32 sub-tile

  for (int k0 = 0; k0 < a.K; k0 += BK) {
    // ---- stage A: 64 rows x 32 k, prologue applied, rounded to bf16 ----
    {
      int r = tid >> 1, kc = (tid & 1) * 16;
      int gr = bm + r;
      const AT* row = X + (long long)gr * a.lda;
      const bf16* sh = nullptr; const bf16* sc = nullptr;
      if (a.shift != nullptr && gr < a.M) {
        long long mb = (long long)(gr / a.rows_per_mod) * a.ld_mod;
        sh = a.shift + mb; sc = a.scale + mb;
      }
      float mean = a.ln_mode != LN_NONE ? s_mean[r] : 0.f;
      float rstd = a.ln_mode != LN_NONE ? s_rstd[r] : 1.f;
#pragma unroll 4
      for (int e = 0; e < 16; ++e) {
        int k = k0 + kc + e;
        float v = 0.f;
        if (gr < a.M && k < a.K) {
          v = to_f(row[k]);
          if (a.ln_mode != LN_NONE) {
            v = (v - mean) * rstd;
            if (a.ln_mode == LN_AFFINE) v = v * a.ln_w[k] + a.ln_b[k];
          }
          if (sh != nullptr) v = v * (1.0f + __bfloat162float(sc[k])) + __bfloat162float(sh[k]);
        }
        As[r * LDA_S + kc + e] = __float2bfloat16(v);
      }
    }
    // ---- stage B: 32 k x 64 n ----
    {
      int kr = tid >> 2, nc = (tid & 3) * 16;
      int k = k0 + kr;
#pragma unroll 4
      for (int e = 0; e < 16; ++e) {
        int n = bn + nc + e;
        bf16 v = __float2bfloat16(0.f);
        if (k < a.K && n < a.N) v = a.w[(long long)k * a.N + n];
        Bs[kr * LDB_S + nc + e] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wr + i * 16) * LDA_S + kk, LDA_S);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB_S + wc + j * 16, LDB_S);
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
      wmma::store_matrix_sync(Cs + (wr + i * 16) * LDC_S + wc + j * 16, acc[i][j], LDC_S,
                              wmma::mem_row_major);
  __syncthreads();

  // ---- epilogue: coalesced along n ----
  OT* O = static_cast<OT*>(a.out);
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    int r = idx / BN, c = idx % BN;
    int gr = bm + r, gc = bn + c;
    if (gr >= a.M || gc >= a.N) continue;
    store(O + (long long)gr * a.ldo + gc, epilogue(a, Cs[r * LDC_S + c], gr, gc));
  }
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
__global__ void __launch_bounds__(rs::THREADS) resident_kernel(Args a, int chunks_per_block) {
  constexpr int BM = rs::BM, THREADS = rs::THREADS, NSTAGE = rs::NSTAGE, LDC = rs::LDC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int K = a.K, LDA = K + 8;
  bf16* Ar = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + rs::a_bytes(K));
  float* Cs = reinterpret_cast<float*>(ring);
  float* s_mean = reinterpret_cast<float*>(smem_raw + rs::a_bytes(K) + rs::RING);
  float* s_rstd = s_mean + BM;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int bm = blockIdx.x * BM;
  const int n_chunks = (a.N + PBN - 1) / PBN;
  const int c0 = blockIdx.y * chunks_per_block;
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

template <typename OT>
__global__ void __launch_bounds__(pp::THREADS) pipelined_kernel(Args a) {
  constexpr int BM = pp::BM, THREADS = pp::THREADS, NSTAGE = pp::NSTAGE, LDA = pp::LDA;
  constexpr int LDC = pp::LDC, A_ELEMS = pp::A_ELEMS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* Cs = reinterpret_cast<float*>(smem_raw);
  const bf16* X = static_cast<const bf16*>(a.x);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int bm = blockIdx.y * BM, bn = blockIdx.x * PBN;

  auto load = [&](int slab, int slot) {
    bf16* A = ring + slot * (A_ELEMS + PB_ELEMS);
    const int k0 = slab * PBK;
#pragma unroll
    for (int i = 0; i < BM * PBK / 8 / THREADS; ++i) {
      int idx = tid + i * THREADS, r = idx >> 2, kc = (idx & 3) * 8;
      int gr = bm + r, gk = k0 + kc;
      bool ok = gr < a.M && gk < a.K;
      cp_async16(A + r * LDA + kc, ok ? X + (long long)gr * a.lda + gk : X, ok);
    }
    load_b_slab<THREADS>(a, A + A_ELEMS, k0, bn, tid);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 64;
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], A + (wr + i * 16) * LDA + kk, LDA);
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
  write_tile<BM, PBN, LDC, THREADS>(a, Cs, bm, bn, static_cast<OT*>(a.out));
}

template <typename K>
void allow_smem(K kernel, size_t bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int adaln_linear(
    const void* x, int x_f32, long long lda, const void* w, const void* bias,
    void* out, int out_f32, long long ldo, int M, int N, int K,
    int ln_mode, const void* ln_w, const void* ln_b,
    const void* shift, const void* scale, long long ld_mod, int rows_per_mod,
    int epi, const void* res, long long ldr,
    const void* gate, long long ld_gate, int rows_per_gate, float dt,
    const void* add1, long long ld_add1,
    const void* add2, long long ld_add2, int a2_div, int a2_mul, int a2_mod,
    void* pre, long long ldp, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = !x_f32 && K % 8 == 0 && N % 8 == 0 && lda % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (aligned && K % 32 == 0 && K <= rs::KMAX) {
    // split the column chunks so that about four waves of blocks exist
    const int row_blocks = (M + rs::BM - 1) / rs::BM, chunks = (N + PBN - 1) / PBN;
    int split = (1056 + row_blocks - 1) / row_blocks;
    split = split < 1 ? 1 : (split > chunks ? chunks : split);
    const int per = (chunks + split - 1) / split;
    split = (chunks + per - 1) / per;
    dim3 grid(row_blocks, split);
    const size_t bytes = rs::smem(K);
    if (out_f32) {
      allow_smem(resident_kernel<float>, rs::smem(rs::KMAX));
      resident_kernel<float><<<grid, rs::THREADS, bytes, s>>>(a, per);
    } else {
      allow_smem(resident_kernel<bf16>, rs::smem(rs::KMAX));
      resident_kernel<bf16><<<grid, rs::THREADS, bytes, s>>>(a, per);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (aligned && ln_mode == LN_NONE && shift == nullptr) {
    dim3 grid((N + PBN - 1) / PBN, (M + pp::BM - 1) / pp::BM);
    if (out_f32) {
      allow_smem(pipelined_kernel<float>, pp::SMEM);
      pipelined_kernel<float><<<grid, pp::THREADS, pp::SMEM, s>>>(a);
    } else {
      allow_smem(pipelined_kernel<bf16>, pp::SMEM);
      pipelined_kernel<bf16><<<grid, pp::THREADS, pp::SMEM, s>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (x_f32 && out_f32) tiled64_kernel<float, float><<<grid, THREADS, 0, s>>>(a);
  else if (x_f32) tiled64_kernel<float, bf16><<<grid, THREADS, 0, s>>>(a);
  else if (out_f32) tiled64_kernel<bf16, float><<<grid, THREADS, 0, s>>>(a);
  else tiled64_kernel<bf16, bf16><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
