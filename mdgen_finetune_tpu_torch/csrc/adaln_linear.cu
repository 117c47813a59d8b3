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
// against 20-80 MB of traffic, about 400 FLOP/byte, above the 295 FLOP/byte
// ridge: the tensor cores bound fc1 (0.030 ms at 989 TFLOP/s); qkv, out
// and fc2 sit near the ridge and are bound by their bytes (0.018-0.035 ms).
// Only wgmma reaches the tensor cores' full rate, and a block of 64 rows
// that streams all of W reads N x K x 2 bytes of it through L2 for every 64
// rows, so W has to arrive without the threads' help. Three routes, the
// plan made in ops/adaln_linear.py::plan and passed in as trailing
// arguments:
//   - resident (16-byte-aligned bf16 X and W and epilogue operands, K <= 512
//     and a multiple of 32: qkv, out, fc1, the IPA projections): a block of
//     one warpgroup (128 threads) owns 64 rows. It normalises and modulates
//     them once, in f32, rounds them to bf16 and writes them into shared
//     memory in the wgmma operand layout (the 128-byte swizzle applied by
//     the writing threads, then fence.proxy.async and a barrier, without
//     which the tensor cores' async proxy may read stale bytes), then walks
//     its share of the 128-column chunks: W arrives by TMA in 32 x 128
//     slabs (two 64-column boxes, 128-byte swizzle) into a ring of mbarrier
//     slots, and wgmma.mma_async m64n128k16 (bf16 in, f32 accumulators in
//     registers) reads both operands from shared memory, W N-major through
//     the transpose bit, so W is never copied transposed;
//   - pipelined (the same alignment, no prologue, any K: fc2): X tiles of
//     64 x 64 and W slabs of 64 x 128 both by TMA into the ring, the same
//     products;
//   - tiled64 (everything else: the output head, N = 21, whose 42-byte rows
//     TMA cannot take, with its Euler update; the embed, whose f32 x has
//     84-byte rows, with its adds): 64x64 tiles, wmma, scalar loads, one
//     stage.
// On both wgmma routes one thread issues the copies; wgmma.commit_group /
// wait_group keep one product group in flight, so the copies of the next
// stages overlap the products, and the slot of a finished stage is refilled
// at once. The epilogue works from the accumulator registers (no f32 tile
// in shared memory): each thread applies bias, GELU (and writes the f32
// pre-activation) or gate_res to its pairs of columns, and each
// warp stages its 16 x 32 results to write them as 16-byte units. The
// tensor maps are built on the host for every call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so nothing links libcuda) and
// passed in the __grid_constant__ argument struct.
//
// The wgmma core lives in adaln_linear.cuh, which the merged layer backward
// (fused_layer_bwd.cu) includes too: both run the same body.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "adaln_linear.cuh"

namespace {

using namespace adaln;
using namespace nvcuda;

constexpr int SMEM_MAX = 232448;  // the shared memory one block may use on an H100

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

template <typename OT, int WGS, int EC>
__global__ void __launch_bounds__(wg::WG_THREADS * WGS) gemm_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  wg::gemm_block<OT, WGS, EC>(a, blockIdx.x, smem_raw);
}

template <typename OT, int WGS>
const void* gemm_kernel_ec(int ec) {
  switch (ec) {
    case wg::EC_GELU: return reinterpret_cast<const void*>(gemm_kernel<OT, WGS, wg::EC_GELU>);
    case wg::EC_GATE: return reinterpret_cast<const void*>(gemm_kernel<OT, WGS, wg::EC_GATE>);
    default: return reinterpret_cast<const void*>(gemm_kernel<OT, WGS, wg::EC_NONE>);
  }
}

// the wgmma kernel of an output type, a block of 1 or 2 warpgroups and an
// epilogue
inline const void* gemm_kernel_of(int out_f32, int wgs, int epi) {
  const int ec = wg::epi_class(epi);
  if (wgs == 2) return out_f32 ? gemm_kernel_ec<float, 2>(ec) : gemm_kernel_ec<bf16, 2>(ec);
  return out_f32 ? gemm_kernel_ec<float, 1>(ec) : gemm_kernel_ec<bf16, 1>(ec);
}

}  // namespace

// The trailing arguments are the plan (ops/adaln_linear.py::plan): the
// route (0 resident, 1 pipelined, 2 tiled64), the block's tile (rows,
// columns), column chunks per block, blocks across the columns, ring
// stages and the dynamic shared memory; a plan that does not fit the call is
// refused (cudaErrorInvalidValue).
extern "C" int adaln_linear(
    const void* x, int x_f32, long long lda, const void* w, const void* bias,
    void* out, int out_f32, long long ldo, int M, int N, int K,
    int ln_mode, const void* ln_w, const void* ln_b,
    const void* shift, const void* scale, long long ld_mod, int rows_per_mod,
    int epi, const void* res, long long ldr,
    const void* gate, long long ld_gate, int rows_per_gate, float dt,
    const void* add1, long long ld_add1,
    const void* add2, long long ld_add2, int a2_div, int a2_mul, int a2_mod,
    void* pre, long long ldp, void* stream,
    int route, int tile_m, int tile_n, int per, int splits, int stages, long long smem_bytes) {
  Args a = make_args(x, lda, w, bias, out, ldo, M, N, K, ln_mode, ln_w, ln_b, shift, scale,
                     ld_mod, rows_per_mod, epi, res, ldr, gate, ld_gate, rows_per_gate, dt,
                     add1, ld_add1, add2, ld_add2, a2_div, a2_mul, a2_mod, pre, ldp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (route == ROUTE_TILED64) {
    if (tile_m != BM || tile_n != BN || smem_bytes != 0) return (int)cudaErrorInvalidValue;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    if (x_f32 && out_f32) tiled64_kernel<float, float><<<grid, THREADS, 0, s>>>(a);
    else if (x_f32) tiled64_kernel<float, bf16><<<grid, THREADS, 0, s>>>(a);
    else if (out_f32) tiled64_kernel<bf16, float><<<grid, THREADS, 0, s>>>(a);
    else tiled64_kernel<bf16, bf16><<<grid, THREADS, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int wgs = tile_m / 64;
  if ((tile_m != 64 && tile_m != 128) || tile_n != wg::BN ||
      smem_bytes != (long long)wg::smem(route, K, stages, wgs) ||
      !with_plan(&a, route, wgs, per, splits, stages, x_f32, out_f32))
    return (int)cudaErrorInvalidValue;
  const long long nblocks = blocks(a, wgs);
  if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const void* k = gemm_kernel_of(out_f32, wgs, epi);
  // each kernel may take a block's whole shared memory; set once (the
  // launch's own size still decides the blocks per SM)
  static bool allowed[2][2][3];
  bool& ok = allowed[out_f32 != 0][wgs - 1][wg::epi_class(epi)];
  if (!ok) {
    const cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    ok = true;
  }
  void* args[] = {&a};
  const cudaError_t e =
      cudaLaunchKernel(k, dim3((unsigned)nblocks), dim3(wg::WG_THREADS * wgs), args, (size_t)smem_bytes, s);
  if (e != cudaSuccess) return (int)e;
  return static_cast<int>(cudaGetLastError());
}

// the wgmma kernel's resources at `wgs` warpgroups per block, epilogue
// `epi`, with `smem` bytes of dynamic shared memory: info[0] registers per
// thread, [1] local (spill) bytes per thread, [2] the shared memory, [3]
// resident blocks per SM
extern "C" int adaln_linear_resources(int out_f32, int wgs, int epi, long long smem,
                                      long long* info) {
  cudaFuncAttributes fa;
  int per_sm = 0;
  if (wgs != 1 && wgs != 2) return (int)cudaErrorInvalidValue;
  const void* k = gemm_kernel_of(out_f32, wgs, epi);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, k);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, wg::WG_THREADS * wgs, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = fa.numRegs;
  info[1] = (long long)fa.localSizeBytes;
  info[2] = smem;
  info[3] = per_sm;
  return 0;
}
