// adaln_linear.cuh: the wgmma core of adaln_linear.cu (the design note is
// there) as a device function over a block index and a shared-memory
// buffer, so that adaln_linear.cu's kernel and the merged layer backward
// (fused_layer_bwd.cu) run the same code; with the epilogues, the argument
// struct and the host side they share (the tensor maps; the plan itself is
// made in ops/adaln_linear.py::plan).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the driver is reached through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace adaln {

typedef __nv_bfloat16 bf16;

// the tiled64 route (adaln_linear.cu): 64 x 64 tiles, scalar loads
constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LDA_S = BK + 8;   // bf16 elements; multiple of 8 for wmma
constexpr int LDB_S = BN + 8;
constexpr int LDC_S = BN + 4;   // f32 elements; multiple of 4 for wmma

enum { LN_NONE = 0, LN_PLAIN = 1, LN_AFFINE = 2 };
enum { EPI_NONE = 0, EPI_GELU = 1, EPI_GATE_RES = 2, EPI_EULER = 3, EPI_ADD = 4 };
enum { ROUTE_RESIDENT = 0, ROUTE_PIPELINED = 1, ROUTE_TILED64 = 2 };

struct Args {
  CUtensorMap tm_w;              // W (K, N): boxes of 64 columns x wg::KB rows
  CUtensorMap tm_x;              // X (M, K): boxes of 64 k x the block's rows
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
  // the plan (ops/adaln_linear.py::plan): route, column chunks per block,
  // blocks across the columns, ring stages
  int route, per, splits, stages;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float bf_round(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// mdgen_finetune_tpu/ops/adaln_mlp.py::_gelu_fast, without a branch (a
// branch per element keeps the compiler from interleaving the elements'
// dependent chains); 1 + t^2 >= 1, so the flushing rsqrt is exact enough
__device__ __forceinline__ float gelu_fast(float a) {
  const float k0 = 0.798055917732286f, k1 = 0.12003597204164997f,
              k2 = 0.01547196081666821f, k3 = 0.0005614901736225192f,
              k4 = 0.00014934348411800474f;
  const float z = fminf(fmaxf(a, -6.0f), 6.0f);
  const float u = z * z;
  const float p = (((k4 * u + k3) * u + k2) * u + k1) * u + k0;
  const float t = z * p;
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.0f + t * t));
  const float y = a * (0.5f + 0.5f * (t * r));
  return a < -6.0f ? 0.0f : y;
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

// ---------------------------------------------------------------------------
// the wgmma core (one warpgroup of 128 threads per block)
// ---------------------------------------------------------------------------
namespace wg {

// A block is WGS warpgroups of 128 threads (1 or 2: ops/adaln_linear.py::plan
// gives the split kernel two, the merged layer backward's blocks are one);
// warpgroup g owns rows 64g .. 64g + 63 of the block's 64 WGS rows, and the
// warpgroups share every W slab.
constexpr int WG_THREADS = 128;
constexpr int BN = 128;              // the columns of a chunk: wgmma m64n128, f32 in registers
constexpr int LDS = 40;              // f32 row stride of a warp's 16 x 32 staging tile
constexpr int STAGING = 4 * 16 * LDS * 4;  // a warpgroup's staging tiles
constexpr int ALIGN = 1024;          // the 128-byte swizzle repeats every 8 rows of 128 bytes
constexpr int KB = 64;               // W rows per ring stage: four k-steps of 16

// X rows x 64 k at 128 bytes a row: one box of the X map, one swizzled block
__host__ __device__ constexpr int xblk(int wgs) { return 64 * wgs * 128; }
// a ring stage: the W slab of KB rows (two boxes of 64 columns), after the
// X tile on the pipelined route
__host__ __device__ constexpr int stage_bytes(int route, int wgs) {
  return route == ROUTE_RESIDENT ? KB * 256 : xblk(wgs) + KB * 256;
}
// the resident rows: K in blocks of 64
__host__ __device__ constexpr int a_bytes(int route, int K, int wgs) {
  return route == ROUTE_RESIDENT ? (K + 63) / 64 * xblk(wgs) : 0;
}
// dynamic shared memory of a block: the alignment slack, the resident rows,
// the ring, the staging tiles, the ring's barriers and the resident rows'
// barrier
__host__ __device__ constexpr size_t smem(int route, int K, int stages, int wgs) {
  return (size_t)ALIGN + a_bytes(route, K, wgs) + (size_t)stages * stage_bytes(route, wgs) +
         (size_t)STAGING * wgs + 8 * (stages + 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, TMA, proxy fences ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// generic-proxy writes of shared memory made visible to the async proxy
// (the tensor cores' operand reads, TMA's writes); a barrier follows
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a 2D box of the tensor map at (c0 inner, c1 outer) into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ----
// a shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (PTX ISA, "Matrix Descriptor Format")
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d (64 x 128, f32) (+)= A (64 x 16, K-major) . B (16 x 128, N-major: the
// transpose bit), both from shared memory; scale_d = 0 starts the sum
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The prologue on the block's TM rows, which TMA has put into shared memory
// in the wgmma layout (K in blocks of 64, each TM rows of 128 bytes whose
// 16-byte units sit at unit ^ (row % 8), the 128-byte swizzle). Two
// threads a row: the LayerNorm statistics from their halves of the units
// (shifted sums in f32, combined by a shuffle), then each normalises and
// modulates its units in f32 and rounds them back to bf16 in place, the
// loads of six units issued before their math. Rows past M stay as TMA's
// zeros. The generic-proxy writes are fenced for the tensor cores' async
// proxy before the barrier.
template <int TM, int THR>
__device__ __forceinline__ void normalize_rows(const Args& a, int bm, unsigned char* A) {
  static_assert(THR == 2 * TM, "two threads a row");
  const int K = a.K, r = threadIdx.x >> 1, h = threadIdx.x & 1, gr = bm + r;
  auto unit = [&](int kc) -> uint4* {
    return reinterpret_cast<uint4*>(A + (kc >> 6) * (TM * 128) + r * 128 +
                                    ((((kc & 63) >> 3) ^ (r & 7)) << 4));
  };
  float mean = 0.f, rstd = 1.f, f[8];
  if (a.ln_mode != LN_NONE) {
    float p1[8], p2[8];  // per-lane partial sums: eight short chains, not one long one
    unpack8(*unit(0), f);
    const float x0 = f[0];
#pragma unroll
    for (int e = 0; e < 8; ++e) p1[e] = p2[e] = 0.f;
    for (int kc = h * 8; kc < K; kc += 16) {
      unpack8(*unit(kc), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dv = f[e] - x0;
        p1[e] += dv;
        p2[e] += dv * dv;
      }
    }
    float s1 = ((p1[0] + p1[1]) + (p1[2] + p1[3])) + ((p1[4] + p1[5]) + (p1[6] + p1[7]));
    float s2 = ((p2[0] + p2[1]) + (p2[2] + p2[3])) + ((p2[4] + p2[5]) + (p2[6] + p2[7]));
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    const float m1 = s1 / K;
    mean = x0 + m1;
    rstd = rsqrtf(fmaxf(s2 / K - m1 * m1, 0.f) + (a.ln_mode == LN_PLAIN ? 1e-6f : 1e-5f));
  }
  if (gr < a.M) {
    const bool mod = a.shift != nullptr;
    const bool vec_mod = !mod || ((reinterpret_cast<uintptr_t>(a.shift) | reinterpret_cast<uintptr_t>(a.scale)) % 16 == 0 &&
                                  a.ld_mod % 8 == 0);
    const long long mb = mod ? (long long)(gr / a.rows_per_mod) * a.ld_mod : 0;
    constexpr int U = 6;
    for (int k0 = h * 8; k0 < K; k0 += 16 * U) {
      uint4 raw[U], sc4[U], sh4[U];
#pragma unroll
      for (int i = 0; i < U; ++i) {  // the loads first
        const int kc = k0 + 16 * i;
        if (kc < K) {
          raw[i] = *unit(kc);
          if (mod && vec_mod) {
            sc4[i] = __ldg(reinterpret_cast<const uint4*>(a.scale + mb + kc));
            sh4[i] = __ldg(reinterpret_cast<const uint4*>(a.shift + mb + kc));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int kc = k0 + 16 * i;
        if (kc >= K) break;
        unpack8(raw[i], f);
        if (a.ln_mode != LN_NONE) {
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = (f[e] - mean) * rstd;
        }
        if (a.ln_mode == LN_AFFINE) {
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = f[e] * a.ln_w[kc + e] + a.ln_b[kc + e];
        }
        if (mod) {
          float sc[8], sh[8];
          if (vec_mod) {
            unpack8(sc4[i], sc);
            unpack8(sh4[i], sh);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              sc[e] = __bfloat162float(a.scale[mb + kc + e]);
              sh[e] = __bfloat162float(a.shift[mb + kc + e]);
            }
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = f[e] * (1.0f + sc[e]) + sh[e];
        }
        *unit(kc) = pack8(f);
      }
    }
  }
  fence_proxy_async();
  __syncthreads();
}

// The epilogue's kind, fixed at compile time (one kernel each): none, GELU
// (with the f32 pre-activation where asked), gate_res. Euler and add (the
// head and the embed) take the tiled64 route.
enum { EC_NONE = 0, EC_GELU = 1, EC_GATE = 2 };
__host__ __device__ constexpr int epi_class(int epi) {
  return epi == EPI_GELU ? EC_GELU : epi == EPI_GATE_RES ? EC_GATE : EC_NONE;
}

// The operands of a thread's epilogue on one 128-column chunk, loaded
// before the chunk's last products complete: bias for its 16 column pairs
// and, for gate_res, the gate and residual pairs of its two rows (bf16
// pairs as 32-bit words).
struct EpiOps {
  uint32_t bias[16], gate[2][16], res[2][16];
};

__device__ __forceinline__ float2 bf2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

template <int EC>
__device__ __forceinline__ void load_ops(const Args& a, int bm, int bn, EpiOps& o) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = bm + warp * 16 + (lane >> 2), cb = bn + 2 * (lane & 3);
  const unsigned* bias = a.bias == nullptr ? nullptr : reinterpret_cast<const unsigned*>(a.bias + cb);
#pragma unroll
  for (int j = 0; j < 16; ++j) o.bias[j] = bias != nullptr && cb + 8 * j < a.N ? __ldg(bias + 4 * j) : 0u;
  if constexpr (EC == EC_GATE) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gr = r0 + 8 * i;
      const bool rok = gr < a.M;
      const unsigned* rp = reinterpret_cast<const unsigned*>(static_cast<const bf16*>(a.res) +
                                                             (long long)gr * a.ldr + cb);
      const unsigned* gp = a.gate == nullptr ? nullptr
                           : reinterpret_cast<const unsigned*>(
                                 a.gate + (long long)(gr / a.rows_per_gate) * a.ld_gate + cb);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const bool ok = rok && cb + 8 * j < a.N;
        o.res[i][j] = ok ? rp[4 * j] : 0u;
        o.gate[i][j] = ok && gp != nullptr ? __ldg(gp + 4 * j) : 0x3f803f80u;  // bf16 pair (1, 1)
      }
    }
  }
}

// The epilogue straight from the accumulators of a warpgroup's 64 x 128
// tile: warp w of the block holds rows bm + 16w + (lane / 4) + {0, 8},
// columns bn + 8j + 2(lane % 4) + {0, 1} in d[4j + 2i + e]. Each thread
// applies the epilogue to its pairs from the operands of load_ops (bias,
// GELU and its pre-activation, gate_res);
// per 32-column group the warp stages the results in f32 in its own
// 16 x 32 tile and writes them out as 16-byte row units (the f32
// pre-activation first, in a pass of its own). The residual was read before
// any store of the tile, so out may be res.
template <typename OT, int EC>
__device__ __forceinline__ void epilogue_tile(const Args& a, const float (&d)[64], const EpiOps& o,
                                              int bm, int bn, float* stg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float* ws = stg + warp * 16 * LDS;
  const int wr = bm + warp * 16;  // the warp's first row
  const bool pre = EC == EC_GELU && a.pre != nullptr;
#pragma unroll
  for (int cg = 0; cg < BN / 32; ++cg) {
    if (bn + cg * 32 < a.N) {  // uniform over the block
      float2 y[2][4], t[2][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = cg * 4 + jj;
        const float2 b = bf2(o.bias[j]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float c0 = d[4 * j + 2 * i], c1 = d[4 * j + 2 * i + 1];
          t[i][jj] = make_float2(c0 + b.x, c1 + b.y);
          if constexpr (EC == EC_NONE) {
            y[i][jj] = t[i][jj];
          } else if constexpr (EC == EC_GELU) {
            y[i][jj] = make_float2(gelu_fast(t[i][jj].x), gelu_fast(t[i][jj].y));
          } else {
            const float2 gg = bf2(o.gate[i][j]), rr = bf2(o.res[i][j]);
            y[i][jj] = make_float2(rr.x + gg.x * t[i][jj].x, rr.y + gg.y * t[i][jj].y);
          }
        }
      }
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        if (pass == 0 && !pre) continue;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<float2*>(ws + (g + 8 * i) * LDS + jj * 8 + 2 * q) = pass == 0 ? t[i][jj] : y[i][jj];
        __syncwarp();
        if (pass == 0 || sizeof(OT) == 4) {  // f32 rows: 8 float4 units each
          float* dst = pass == 0 ? a.pre : reinterpret_cast<float*>(a.out);
          const long long ld = pass == 0 ? a.ldp : a.ldo;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int idx = lane + 32 * u, rr = idx >> 3, c = cg * 32 + (idx & 7) * 4;
            if (wr + rr < a.M && bn + c < a.N)
              *reinterpret_cast<float4*>(dst + (long long)(wr + rr) * ld + bn + c) =
                  *reinterpret_cast<const float4*>(ws + rr * LDS + (idx & 7) * 4);
          }
        } else {  // bf16 rows: 4 units of 8 each
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int idx = lane + 32 * u, rr = idx >> 2, c = cg * 32 + (idx & 3) * 8;
            const float4 lo = *reinterpret_cast<const float4*>(ws + rr * LDS + (idx & 3) * 8);
            const float4 hi = *reinterpret_cast<const float4*>(ws + rr * LDS + (idx & 3) * 8 + 4);
            const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
            if (wr + rr < a.M && bn + c < a.N)
              *reinterpret_cast<uint4*>(static_cast<bf16*>(a.out) + (long long)(wr + rr) * a.ldo + bn + c) =
                  pack8(v);
          }
        }
        __syncwarp();
      }
    }
  }
}

// One block of the resident or the pipelined route, WGS warpgroups, W in
// slabs of KB rows: block index t of the plan's grid covers rows
// bm = (t / splits) * TM and column chunks [c0, c1) of 128 (one chunk on
// the pipelined route). Resident: TMA brings the block's TM rows into
// shared memory once, normalize_rows applies the prologue there, and every
// chunk reads them. Pipelined: each stage brings a TM x 64 X tile and a
// 64 x 128 W slab. Both by TMA into a ring of `stages` slots, one mbarrier
// each: thread 0 issues the copies of stage it + stages - 1 as soon as the
// products of stage it - 1 are done (wgmma.wait_group 1 keeps one product
// group in flight), so the copies run ahead of the products and across the
// chunks' epilogues. Warpgroup g takes rows 64g.. of every X block. The
// products of a chunk run over k in order, 16 at a time (steps past K read
// TMA's zeros), whatever the ring depth, the slab, the grid or WGS: every
// output element sees the same sum (the merged layer backward relies on it).
template <typename OT, int WGS, int EC>
__device__ __forceinline__ void gemm_block(const Args& a, int t, unsigned char* smem_raw) {
  constexpr int TM = 64 * WGS, THR = WG_THREADS * WGS, XB = xblk(WGS);
  const int tid = threadIdx.x, g = tid / WG_THREADS, route = a.route, stages = a.stages, K = a.K;
  unsigned char* sm = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  unsigned char* A = sm;
  unsigned char* ring = A + a_bytes(route, K, WGS);
  const int sb = stage_bytes(route, WGS);
  float* stg = reinterpret_cast<float*>(ring + (size_t)stages * sb);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(stg) + STAGING * WGS);
  uint64_t* xbar = full + stages;
  const int bm = (t / a.splits) * TM;
  const int n_chunks = (a.N + BN - 1) / BN;
  const int c0 = (t % a.splits) * a.per, c1 = min(c0 + a.per, n_chunks);
  const int nslab = (K + KB - 1) / KB, total = (c1 - c0) * nslab;

  // an earlier body of the merged kernel may have written this memory
  fence_proxy_async();
  if (tid == 0) {
    for (int s = 0; s <= stages; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int it) {  // thread 0: the copies of stage it into its slot
    const int slot = it % stages, bn = (c0 + it / nslab) * BN, k0 = (it % nslab) * KB;
    unsigned char* dst = ring + (size_t)slot * sb;
    const bool hi = bn + 64 < a.N;  // the second 64-column box holds columns < N
    mbar_expect_tx(&full[slot], (route == ROUTE_PIPELINED ? XB : 0) + KB * 128 * (hi ? 2 : 1));
    if (route == ROUTE_PIPELINED) {
      tma_load(dst, &a.tm_x, k0, bm, &full[slot]);
      dst += XB;
    }
    tma_load(dst, &a.tm_w, bn, k0, &full[slot]);
    if (hi) tma_load(dst + KB * 128, &a.tm_w, bn + 64, k0, &full[slot]);
  };
  if (tid == 0) {
    if (route == ROUTE_RESIDENT) {
      const int nkb = (K + 63) / 64;
      mbar_expect_tx(xbar, nkb * XB);
      for (int j = 0; j < nkb; ++j) tma_load(A + j * XB, &a.tm_x, j * 64, bm, xbar);
    }
    for (int it = 0; it < min(stages, total); ++it) issue(it);
  }
  if (route == ROUTE_RESIDENT) {
    mbar_wait(xbar, 0);
    if (a.ln_mode != LN_NONE || a.shift != nullptr) normalize_rows<TM, THR>(a, bm, A);
  }

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  EpiOps ops;
  int it = 0;
  for (int c = c0; c < c1; ++c) {
    for (int s = 0; s < nslab; ++s, ++it) {
      const int slot = it % stages;
      mbar_wait(&full[slot], (it / stages) & 1);
      const unsigned char* st = ring + (size_t)slot * sb;
      const unsigned char* Bs = route == ROUTE_PIPELINED ? st + XB : st;
      const unsigned char* As = route == ROUTE_PIPELINED ? st + g * 8192 : A + g * 8192 + (s * KB >> 6) * XB;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < KB / 16; ++u) {
        const int ka = route == ROUTE_PIPELINED ? u * 32 : ((s * KB + u * 16) & 63) * 2;
        wgmma_m64n128k16(d, desc(As + ka, 0, 1024), desc(Bs + u * 2048, KB * 128, 1024),
                         (s | u) != 0);
      }
      wgmma_commit();
      if (s == nslab - 1) load_ops<EC>(a, bm, c * BN, ops);  // while the last products run
      wgmma_wait<1>();  // the products of stage it - 1 are done
      fence_acc(d);
      __syncthreads();  // ... in every warp: its slot may be refilled
      if (tid == 0 && it >= 1 && it - 1 + stages < total) issue(it - 1 + stages);
    }
    wgmma_wait<0>();
    fence_acc(d);
    epilogue_tile<OT, EC>(a, d, ops, bm, c * BN, stg);
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s <= stages; ++s) mbar_inval(&full[s]);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The arguments of one call (the C entry point's, in its order); the plan
// and the tensor maps are set by with_plan.
inline Args make_args(const void* x, long long lda, const void* w, const void* bias, void* out,
                      long long ldo, int M, int N, int K, int ln_mode, const void* ln_w,
                      const void* ln_b, const void* shift, const void* scale, long long ld_mod,
                      int rows_per_mod, int epi, const void* res, long long ldr,
                      const void* gate, long long ld_gate, int rows_per_gate, float dt,
                      const void* add1, long long ld_add1, const void* add2, long long ld_add2,
                      int a2_div, int a2_mul, int a2_mod, void* pre, long long ldp) {
  Args a;
  memset(&a, 0, sizeof(Args));
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
  a.route = ROUTE_TILED64;
  a.per = a.splits = a.stages = 1;
  return a;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 (rows, cols) row-major matrix with row stride ld (elements) as a
// tensor map of (box_rows, 64) boxes, 128-byte swizzle, zeros out of bounds
inline bool encode(CUtensorMap* map, const void* base, long long rows, long long cols,
                   long long ld, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What a wgmma route needs of the call, checked again here (the plan in
// ops/adaln_linear.py decides): bf16 X and W on 16-byte bases with rows of
// whole 16-byte units (TMA's base and stride rule, and the prologue's and
// epilogue's 16-byte accesses), every epilogue operand likewise, no Euler
// or add epilogue; the resident route a K in 32s up to 512, the pipelined
// no prologue.
inline bool wgmma_ok(const Args& a, int route, int x_f32, int out_f32) {
  auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  auto rows8 = [&](const void* p, long long ld) { return p == nullptr || (al16(p) && ld % 8 == 0); };
  const bool ops = a.N % 8 == 0 && a.K % 8 == 0 && !x_f32 && rows8(a.x, a.lda) &&
                   rows8(a.w, a.N) && rows8(a.out, a.ldo) && (a.bias == nullptr || al16(a.bias)) &&
                   rows8(a.res, a.ldr) && rows8(a.gate, a.ld_gate) && rows8(a.pre, a.ldp) &&
                   a.epi != EPI_EULER && a.epi != EPI_ADD;
  if (!ops) return false;
  if (a.N < 64) return false;  // W's boxes are 64 columns wide
  if (route == ROUTE_RESIDENT) return a.K % 32 == 0 && a.K <= 512;
  return route == ROUTE_PIPELINED && a.ln_mode == LN_NONE && a.shift == nullptr && a.K >= 64;
}

// Sets the plan (route, warpgroups per block, column chunks per block,
// blocks across the columns, ring stages) and, on a wgmma route, builds
// the tensor maps (X in boxes of 64 k x the block's rows).
// False where the plan does not fit the call.
inline bool with_plan(Args* a, int route, int wgs, int per, int splits, int stages, int x_f32,
                      int out_f32) {
  a->route = route;
  a->per = per;
  a->splits = splits;
  a->stages = stages;
  if (route == ROUTE_TILED64) return true;
  const int chunks = (a->N + wg::BN - 1) / wg::BN;
  if (!wgmma_ok(*a, route, x_f32, out_f32) || stages < 2 || per < 1 || splits < 1 ||
      (long long)per * splits < chunks || (route == ROUTE_PIPELINED && per != 1) ||
      (wgs != 1 && wgs != 2))
    return false;
  return encode(&a->tm_w, a->w, a->K, a->N, a->N, wg::KB) &&
         encode(&a->tm_x, a->x, a->M, a->K, a->lda, 64 * wgs);
}

// blocks of a wgmma route's grid at `wgs` warpgroups per block
inline long long blocks(const Args& a, int wgs) {
  return (long long)((a.M + 64 * wgs - 1) / (64 * wgs)) * a.splits;
}

}  // namespace adaln
