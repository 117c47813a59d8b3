// fused_attention_bwd: the backward of fused_attention (fused_attention.cu).
//
// Replaces mdgen_finetune_tpu/ops/fused_attention.py::_bwd_tpu (body
// _bwd_kernel). The TPU kernel recomputes P from the whole resident row, emits
// dQ per query block and accumulates dK / dV in place across its sequential
// grid of query blocks (fused_attention.py:109-134). Hopper's blocks run in
// parallel with no order, so the sums over queries and over keys are split
// into two passes, each owning its outputs: deterministic, no atomics.
//
// Inputs: q (R, N, D), k, v (R, M, D), key_valid (B, M), the forward's
// output o (R, N, D) and statistic stat (R, N) (log2 of the softmax
// denominator), the upstream gradient dout (R, N, D). With t the logit in
// base-2 units (fused_attention.cu):
//   p     = exp2(min(t, 100) - stat) (base2)  or  exp2(t - stat) (natural)
//   delta = rowsum(dout * o)                  (f32, first pass)
//   dp    = dout . v^T
//   ds    = p * (dp - delta) on attendable keys, 0 on masked ones (the
//           adjoint of JAX's where(mask, l, -1e9)); base2 carries a factor
//           ln 2 (d exp2(x)/dx = ln 2 exp2(x), fused_attention.py:127-128)
//   dv = p^T . dout,  dk = ds^T . q,  dq = ds . k
// Outputs dq, dk, dv in bf16, as the JAX kernel returns them; `delta` is an
// (R, N) f32 scratch buffer.
//
// Design (attention_tile.cuh):
//   - fused_attention_delta_kernel: one thread per query row;
//   - fused_attention_dkdv_kernel: one block per (row, 64-key tile). Its
//     16 keys per warp are A fragments (k and v); it loops over the query
//     tiles (q and dout staged row-major and transposed), forms p^T and
//     ds^T for its keys with mma.sync, and accumulates dv and dk in f32
//     registers;
//   - fused_attention_dq_kernel: one block per (row, 64-query tile), q and
//     dout as A fragments, the key tiles streamed (k row-major and
//     transposed, v row-major); it forms p and ds again and accumulates dq.
// So P is recomputed twice, once per pass: two products more than the TPU
// kernel's single pass.
//
// What bounds it on the H100: at B = 8, T = 1000, L = 4, 16 heads of D = 24
// the passes do 4 products of 2 * R * N * M * D each for dk/dv (q.k, dout.v,
// p^T.dout, ds^T.q) and 3 for dq (q.k, dout.v, ds.k): 1.7e11 FLOP, of which
// 5 products (1.2e11, 0.124 ms at 989 TFLOP/s) is the least any backward
// that recomputes P needs; the ~175 MB of operands and outputs take
// 0.052 ms. First version, as the forward: mma.sync, D padded to 32, each
// operand tile restaged per block through L2.

#include <cuda_runtime.h>

#include "attention_tile.cuh"

using namespace attn_tile;

namespace {

__global__ void fused_attention_delta_kernel(const bf16* __restrict__ o,
                                             const bf16* __restrict__ dout,
                                             float* __restrict__ delta, long long rows, int D) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float s = 0.f;
  for (int d = 0; d < D; ++d) s += __bfloat162float(o[i * D + d]) * __bfloat162float(dout[i * D + d]);
  delta[i] = s;
}

// p and ds of one logit: t in base-2 units, stat and delta of its query row
__device__ __forceinline__ void p_ds(float& s, float& dp, float cls, float lse, float dl,
                                     float scale, int base2) {
  const float t = logit2(s, cls, scale);
  const float p = base2 ? exp2f(fminf(t, 100.f) - lse) : exp2f(t - lse);
  dp = cls > 0.f ? p * (dp - dl) * (base2 ? LN2 : 1.f) : 0.f;
  s = p;
}

template <int D>
__global__ void __launch_bounds__(THREADS) fused_attention_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ key_valid, const bf16* __restrict__ dout,
    const float* __restrict__ stat, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int N, int M, int H, int ktiles, int base2) {
  using Dm = Dims<D>;
  __shared__ __align__(16) bf16 Qs[ROWS * Dm::RS];  // q tile  [query][d]
  __shared__ __align__(16) bf16 Gs[ROWS * Dm::RS];  // dout    [query][d]
  __shared__ __align__(16) bf16 Qt[Dm::DP * TS];     // q       [d][query]
  __shared__ __align__(16) bf16 Gt[Dm::DP * TS];     // dout    [d][query]
  __shared__ float Ls[ROWS], Dl[ROWS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const long long r = blockIdx.x / ktiles;
  const int k0 = (int)(blockIdx.x % ktiles) * ROWS;
  const bf16* qr = q + r * N * D;
  const bf16* gr = dout + r * N * D;
  const float* kv = key_valid + (r / H) * M;
  const float scale = base2 ? 1.f : LOG2E;

  // this warp's 16 keys of k and v as A fragments (staged through Qs / Gs)
  stage_rows<D>(Qs, nullptr, k + r * M * D, k0, M);
  stage_rows<D>(Gs, nullptr, v + r * M * D, k0, M);
  __syncthreads();
  uint32_t ka[Dm::KC][4], va[Dm::KC][4];
  load_a<D>(ka, Qs, warp * 16);
  load_a<D>(va, Gs, warp * 16);
  const float cls[2] = {key_class(kv, k0 + warp * 16 + gid, M),
                        key_class(kv, k0 + warp * 16 + gid + 8, M)};

  float dka[Dm::DB][4], dva[Dm::DB][4];
#pragma unroll
  for (int db = 0; db < Dm::DB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[db][e] = dva[db][e] = 0.f;

  const int qtiles = (N + ROWS - 1) / ROWS;
  for (int qt = 0; qt < qtiles; ++qt) {
    const int q0 = qt * ROWS;
    __syncthreads();  // every warp is done with the previous tile (and the key staging)
    stage_rows<D>(Qs, Qt, qr, q0, N);
    stage_rows<D>(Gs, Gt, gr, q0, N);
    if (threadIdx.x < ROWS) {
      const int n = q0 + threadIdx.x;
      Ls[threadIdx.x] = n < N ? stat[r * N + n] : 0.f;
      Dl[threadIdx.x] = n < N ? delta[r * N + n] : 0.f;
    }
    __syncthreads();

    float s[NB][4], dp[NB][4];
    product_d<D>(s, ka, Qs);   // s^T:  16 keys x 64 queries
    product_d<D>(dp, va, Gs);  // dp^T: v . dout^T
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nb * 8 + tig * 2 + (e & 1);
        p_ds(s[nb][e], dp[nb][e], cls[e >> 1], Ls[c], Dl[c], scale, base2);
        if (q0 + c >= N) s[nb][e] = dp[nb][e] = 0.f;  // query rows past N
      }
    product_rows<D>(dva, s, Gt);   // dv += p^T . dout
    product_rows<D>(dka, dp, Qt);  // dk += ds^T . q
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk + r * M * D, dka, k0 + warp * 16, M, one);
  store_rows<D>(dv + r * M * D, dva, k0 + warp * 16, M, one);
}

template <int D>
__global__ void __launch_bounds__(THREADS) fused_attention_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ key_valid, const bf16* __restrict__ dout,
    const float* __restrict__ stat, const float* __restrict__ delta, bf16* __restrict__ dq,
    int N, int M, int H, int qtiles, int base2) {
  using Dm = Dims<D>;
  __shared__ __align__(16) bf16 Ks[ROWS * Dm::RS];  // k tile [key][d]
  __shared__ __align__(16) bf16 Vs[ROWS * Dm::RS];  // v      [key][d]
  __shared__ __align__(16) bf16 Kt[Dm::DP * TS];     // k      [d][key]
  __shared__ float Kc[ROWS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const long long r = blockIdx.x / qtiles;
  const int q0 = (int)(blockIdx.x % qtiles) * ROWS;
  const bf16* kr = k + r * M * D;
  const bf16* vr = v + r * M * D;
  const float* kv = key_valid + (r / H) * M;
  const float scale = base2 ? 1.f : LOG2E;

  // this warp's 16 queries of q and dout as A fragments (staged through Ks / Vs)
  stage_rows<D>(Ks, nullptr, q + r * N * D, q0, N);
  stage_rows<D>(Vs, nullptr, dout + r * N * D, q0, N);
  __syncthreads();
  uint32_t qa[Dm::KC][4], ga[Dm::KC][4];
  load_a<D>(qa, Ks, warp * 16);
  load_a<D>(ga, Vs, warp * 16);
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = q0 + warp * 16 + gid + 8 * i;
    lse[i] = n < N ? stat[r * N + n] : 0.f;
    dl[i] = n < N ? delta[r * N + n] : 0.f;
  }

  float acc[Dm::DB][4];
#pragma unroll
  for (int db = 0; db < Dm::DB; ++db) acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;

  const int ktiles = (M + ROWS - 1) / ROWS;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int k0 = kt * ROWS;
    __syncthreads();
    stage_rows<D>(Ks, Kt, kr, k0, M);
    stage_rows<D>(Vs, nullptr, vr, k0, M);
    if (threadIdx.x < ROWS) Kc[threadIdx.x] = key_class(kv, k0 + threadIdx.x, M);
    __syncthreads();

    float s[NB][4], dp[NB][4];
    product_d<D>(s, qa, Ks);   // s:  16 queries x 64 keys
    product_d<D>(dp, ga, Vs);  // dp: dout . v^T
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p_ds(s[nb][e], dp[nb][e], Kc[nb * 8 + tig * 2 + (e & 1)], lse[e >> 1], dl[e >> 1], scale,
             base2);
    product_rows<D>(acc, dp, Kt);  // dq += ds . k
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq + r * N * D, acc, q0 + warp * 16, N, one);
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* key_valid, const bf16* o,
           const bf16* dout, const float* stat, bf16* dq, bf16* dk, bf16* dv, float* delta,
           int R, int N, int M, int H, int base2, cudaStream_t stream) {
  const int qtiles = (N + ROWS - 1) / ROWS, ktiles = (M + ROWS - 1) / ROWS;
  const long long rows = (long long)R * N;
  if (rows <= 0 || M <= 0 || (long long)R * qtiles > 0x7fffffffLL ||
      (long long)R * ktiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  fused_attention_delta_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      o, dout, delta, rows, D);
  int e = (int)cudaGetLastError();
  if (e) return e;
  fused_attention_dkdv_kernel<D><<<(unsigned)(R * ktiles), THREADS, 0, stream>>>(
      q, k, v, key_valid, dout, stat, delta, dk, dv, N, M, H, ktiles, base2);
  e = (int)cudaGetLastError();
  if (e) return e;
  fused_attention_dq_kernel<D><<<(unsigned)(R * qtiles), THREADS, 0, stream>>>(
      q, k, v, key_valid, dout, stat, delta, dq, N, M, H, qtiles, base2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* key_valid, const void* o, const void* dout,
                                   const void* stat, void* dq, void* dk, void* dv, void* delta,
                                   int R, int N, int M, int H, int D, int base2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *q_ = static_cast<const bf16*>(q), *k_ = static_cast<const bf16*>(k),
             *v_ = static_cast<const bf16*>(v), *o_ = static_cast<const bf16*>(o),
             *g_ = static_cast<const bf16*>(dout);
  const float *kv_ = static_cast<const float*>(key_valid), *st_ = static_cast<const float*>(stat);
  bf16 *dq_ = static_cast<bf16*>(dq), *dk_ = static_cast<bf16*>(dk), *dv_ = static_cast<bf16*>(dv);
  float* dl_ = static_cast<float*>(delta);
  switch (D) {
    case 16: return launch<16>(q_, k_, v_, kv_, o_, g_, st_, dq_, dk_, dv_, dl_, R, N, M, H, base2, s);
    case 24: return launch<24>(q_, k_, v_, kv_, o_, g_, st_, dq_, dk_, dv_, dl_, R, N, M, H, base2, s);
    case 32: return launch<32>(q_, k_, v_, kv_, o_, g_, st_, dq_, dk_, dv_, dl_, R, N, M, H, base2, s);
    case 64: return launch<64>(q_, k_, v_, kv_, o_, g_, st_, dq_, dk_, dv_, dl_, R, N, M, H, base2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
