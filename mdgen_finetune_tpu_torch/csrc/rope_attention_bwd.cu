// rope_attention_bwd: the backward of rope_attention in base-2 mode, for
// trunk stage 1 (over the L residues of a frame) and stage 2 (over the T
// frames of a residue).
//
// Replaces the attention adjoints inside the stage backward kernels of
// mdgen_finetune_tpu/ops/fused_layer_bwd.py: _k2 (frame attention, :258-309)
// and _k1 (residue attention, :420-458).
//
// Layout as the forward: qkv (G, N, I, 3C) bf16, attention over N for every
// (g, i) (stage 1: G = B*T, N = L, I = 1; stage 2: G = B, N = T, I = L);
// dout (G, N, I, C) bf16, the gradient of the attention output; key_valid
// (G, N, I) f32. For each sequence and head the kernel
//   1. recomputes the RoPE'd q and k (f32 tables (N+1, D)) and the bias key
//      RoPE'd at position N, with V and the bias value;
//   2. recomputes the logits with the mask bias (-1e9 on invalid keys) and
//      p as the forward takes it: exp2(min(l, 100)) with no max,
//      normalised by the sum + 1e-30;
//   3-4. per query n: dp_j = dO_n . v_j, rowsum_n = sum_j p_j dp_j and
//      dl_j = ln2 * p_j * (dp_j - rowsum_n) (the ln 2 of the base-2
//      softmax, fused_layer_bwd.py:280-281, 437-438);
//   5. dq_n = sum_j dl_nj k_j; per key j: dk_j = sum_n dl_nj q_n and
//      dv_j = sum_n p_nj dO_n;
//   6. applies the RoPE transpose (_rot_t :112) to dq and dk at their
//      positions (the bias key's at N);
//   7. writes dq, dk, dv into dqkv (G, N, I, 3C) bf16;
//   8. writes the bias key's and value's gradients of each sequence as an f32
//      partial; colsum.cuh sums them over the sequences into (2, C) f32.
// Masked keys have p = 0 exactly, so their dk and dv are exactly zero.
//
// What bounds it on the H100: per (sequence, head) it reads q, k, v, dO
// (N x D each) and writes dq, dk, dv, with ~8*N*(N+1)*D FLOP: stage 2
// (N = 100, D = 24, 128 x 16 sequence-heads) moves ~36 MB of bf16 against
// ~0.6 GFLOP of f32 work, so it is memory-bound (~0.011 ms at 3.35 TB/s);
// stage 1 (N = 4) even more so. Design: one block of 128 threads per
// (sequence, group of heads) stages q, k (RoPE'd), v and dO of its heads in
// f32 shared memory (at most 128 keys: ~40 KB for one head of stage 2; for
// N <= 16 a block takes up to 128 / (N + 1) heads so the threads are not
// idle); phase A gives a thread one (head, query) row: two passes over the
// keys (softmax statistics, then dq); phase B gives a thread one (head, key)
// column: one pass over the queries (dk, dv). Every thread of a phase reads
// the same key or query row at a time, a shared-memory broadcast. The
// logits and probabilities are recomputed in registers and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "colsum.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 128;
constexpr float LN2F = 0.6931471805599453f;

// per head: q[N][D], dO[N][D], k[NK][D], v[NK][D], kbias[NK], inv[N], rsum[N]
__host__ __device__ constexpr int head_floats(int N, int D) {
  return 2 * N * D + 2 * (N + 1) * D + (N + 1) + 2 * N;
}

template <int D>
__device__ __forceinline__ void rope_row(float* v, const float* cs, const float* sn) {
  float r[D];
#pragma unroll
  for (int d = 0; d < D; ++d) r[d] = d < D / 2 ? -v[d + D / 2] : v[d - D / 2];
#pragma unroll
  for (int d = 0; d < D; ++d) v[d] = v[d] * cs[d] + r[d] * sn[d];
}

// the transpose of rope_row: g * cos + rot^T(g * sin), rot^T(a, b) = (b, -a)
template <int D>
__device__ __forceinline__ void rope_row_t(float* g, const float* cs, const float* sn) {
  float t[D];
#pragma unroll
  for (int d = 0; d < D; ++d) t[d] = d < D / 2 ? g[d + D / 2] * sn[d + D / 2] : -g[d - D / 2] * sn[d - D / 2];
#pragma unroll
  for (int d = 0; d < D; ++d) g[d] = g[d] * cs[d] + t[d];
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
}

template <int D>
__global__ void __launch_bounds__(THREADS) rope_attention_bwd_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
    const bf16* __restrict__ bias_k, const bf16* __restrict__ bias_v,
    const float* __restrict__ key_valid, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, bf16* __restrict__ dqkv, float* __restrict__ part,
    int N, int I, int H, int C, int HPB) {
  extern __shared__ __align__(16) float smem[];
  const int NK = N + 1, hf = head_floats(N, D);
  const int groups = (H + HPB - 1) / HPB;
  const long long seq = blockIdx.x / groups;
  const int h0 = (int)(blockIdx.x % groups) * HPB;
  const long long g = seq / I, i = seq % I;
  const long long row0 = g * N * I + i;  // row of token n: row0 + n * I
  const int nh = min(HPB, H - h0);

  auto Qs = [&](int hl) { return smem + (size_t)hl * hf; };
  auto dOs = [&](int hl) { return Qs(hl) + N * D; };
  auto Ks = [&](int hl) { return dOs(hl) + N * D; };
  auto Vs = [&](int hl) { return Ks(hl) + NK * D; };
  auto Kb = [&](int hl) { return Vs(hl) + NK * D; };
  auto Inv = [&](int hl) { return Kb(hl) + NK; };
  auto Rs = [&](int hl) { return Inv(hl) + N; };

  // ---- stage q, dO (query rows) and k, v (key rows, the bias token at N) ----
  for (int t = threadIdx.x; t < nh * NK; t += THREADS) {
    const int hl = t / NK, n = t % NK, h = h0 + hl;
    float kv[D], vv[D];
    if (n < N) {
      const long long row = row0 + (long long)n * I;
      const bf16* src = qkv + row * 3LL * C + h * D;
      const bf16* go = dout + row * C + h * D;
      float qv[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qv[d] = __bfloat162float(src[d]);
        kv[d] = __bfloat162float(src[C + d]);
        vv[d] = __bfloat162float(src[2 * C + d]);
        dOs(hl)[n * D + d] = __bfloat162float(go[d]);
      }
      rope_row<D>(qv, cos_t + n * D, sin_t + n * D);
#pragma unroll
      for (int d = 0; d < D; ++d) Qs(hl)[n * D + d] = qv[d];
      Kb(hl)[n] = key_valid[row] > 0.f ? 0.f : -1e9f;
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        kv[d] = __bfloat162float(bias_k[h * D + d]);
        vv[d] = __bfloat162float(bias_v[h * D + d]);
      }
      Kb(hl)[n] = 0.f;
    }
    rope_row<D>(kv, cos_t + n * D, sin_t + n * D);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      Ks(hl)[n * D + d] = kv[d];
      Vs(hl)[n * D + d] = vv[d];
    }
  }
  __syncthreads();

  // ---- phase A: one (head, query) row per thread: statistics, then dq ----
  for (int t = threadIdx.x; t < nh * N; t += THREADS) {
    const int hl = t / N, n = t % N, h = h0 + hl;
    const float* q = Qs(hl) + n * D;
    const float* go = dOs(hl) + n * D;
    const float *K = Ks(hl), *V = Vs(hl), *kb = Kb(hl);
    float den = 0.f, sdp = 0.f;
    for (int j = 0; j < NK; ++j) {
      const float e = exp2f(fminf(dot<D>(q, K + j * D) + kb[j], 100.f));
      den += e;
      sdp += e * dot<D>(go, V + j * D);
    }
    const float inv = 1.f / (den + 1e-30f), rsum = sdp * inv;
    Inv(hl)[n] = inv;
    Rs(hl)[n] = rsum;
    float dq[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dq[d] = 0.f;
    for (int j = 0; j < NK; ++j) {
      const float p = exp2f(fminf(dot<D>(q, K + j * D) + kb[j], 100.f)) * inv;
      const float dl = LN2F * p * (dot<D>(go, V + j * D) - rsum);
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] += dl * K[j * D + d];
    }
    rope_row_t<D>(dq, cos_t + n * D, sin_t + n * D);
    bf16* dst = dqkv + (row0 + (long long)n * I) * 3LL * C + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) dst[d] = __float2bfloat16(dq[d]);
  }
  __syncthreads();

  // ---- phase B: one (head, key) column per thread: dk, dv ----
  for (int t = threadIdx.x; t < nh * NK; t += THREADS) {
    const int hl = t / NK, j = t % NK, h = h0 + hl;
    const float *Q = Qs(hl), *dO = dOs(hl);
    float k[D], v[D], dk[D], dv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      k[d] = Ks(hl)[j * D + d];
      v[d] = Vs(hl)[j * D + d];
      dk[d] = 0.f;
      dv[d] = 0.f;
    }
    const float kbj = Kb(hl)[j];
    for (int n = 0; n < N; ++n) {
      const float p = exp2f(fminf(dot<D>(Q + n * D, k) + kbj, 100.f)) * Inv(hl)[n];
      const float dl = LN2F * p * (dot<D>(dO + n * D, v) - Rs(hl)[n]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dk[d] += dl * Q[n * D + d];
        dv[d] += p * dO[n * D + d];
      }
    }
    rope_row_t<D>(dk, cos_t + j * D, sin_t + j * D);
    if (j < N) {
      bf16* dst = dqkv + (row0 + (long long)j * I) * 3LL * C + h * D;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dst[C + d] = __float2bfloat16(dk[d]);
        dst[2 * C + d] = __float2bfloat16(dv[d]);
      }
    } else {
      float* pb = part + seq * 2LL * C + h * D;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        pb[d] = dk[d];
        pb[C + d] = dv[d];
      }
    }
  }
}

template <int D>
int launch(const void* qkv, const void* dout, const void* bias_k, const void* bias_v,
           const void* key_valid, const void* cos_t, const void* sin_t, void* dqkv,
           void* dbias, void* scratch, int G, int N, int I, int H, int C, cudaStream_t stream) {
  const int HPB = N <= 16 ? max(1, min(H, THREADS / (N + 1))) : 1;
  const size_t smem = (size_t)HPB * head_floats(N, D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(rope_attention_bwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long S = (long long)G * I;
  const unsigned blocks = (unsigned)(S * ((H + HPB - 1) / HPB));
  rope_attention_bwd_kernel<D><<<blocks, THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(bias_k), static_cast<const bf16*>(bias_v),
      static_cast<const float*>(key_valid), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<bf16*>(dqkv), static_cast<float*>(scratch),
      N, I, H, C, HPB);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return colsum::launch(static_cast<const float*>(scratch), static_cast<float*>(dbias), S,
                        2LL * C, 2LL * C, 0, stream);
}

}  // namespace

extern "C" int rope_attention_bwd(const void* qkv, const void* dout, const void* bias_k,
                                  const void* bias_v, const void* key_valid, const void* cos_t,
                                  const void* sin_t, void* dqkv, void* dbias, void* scratch,
                                  int G, int N, int I, int H, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 16: return launch<16>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, s);
    case 24: return launch<24>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, s);
    case 32: return launch<32>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, s);
    case 64: return launch<64>(qkv, dout, bias_k, bias_v, key_valid, cos_t, sin_t, dqkv, dbias, scratch, G, N, I, H, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
