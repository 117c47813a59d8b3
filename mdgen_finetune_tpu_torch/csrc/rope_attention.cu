// rope_attention: the attention core shared by trunk stage 1 (over the L
// residues of a frame), trunk stage 2 (over the T frames of a residue) and the
// prepend-IPA encoder's residue MHA.
//
// Replaces the attention cores inside
//   - mdgen_finetune_tpu/ops/fused_layer.py::_trunk_call (body _kernel:
//     stage 1's pair loop with the no-max exp2 softmax, stage 2's grouped
//     core `_grouped_attend` with base2=True);
//   - mdgen_finetune_tpu/ops/ipa_encoder.py::_encoder_call (body _kernel: the
//     residue MHA with a natural-exp, max-subtracted softmax).
//
// Layout: qkv is (G, N, I, 3C) bf16 (q | k | v column blocks); attention runs
// over N for every (g, i) pair, so one kernel serves both trunk axes without
// a transpose (stage 1: G = B*T, N = L, I = 1; stage 2: G = B, N = T, I = L).
// key_valid is (G, N, I) f32. For each sequence and head the kernel
//   - RoPEs q and k (rotate-half, f32 tables (N+1, D) from the host);
//   - appends the learned bias key/value, the key RoPE'd at position N;
//   - adds the mask bias (-1e9 on invalid keys; the bias key is always valid);
//   - softmax: base 2 (q carries scale*log2(e); exp2(min(l, 100)), no max,
//     denominator + 1e-30) or natural exp with max subtraction;
//   - multiplies by V and writes (G, N, I, C) bf16.
//
// What bounds it on the H100: at most 101 keys of D = 24, so per (sequence,
// head) it reads and writes a few KB and does ~2*N*(N+1)*D*2 FLOP; the whole
// call moves ~4*M*C*2 bytes (M = B*T*L) and is memory-bound (stage 2:
// 0.5 MFLOP per head against 15 KB). Design: a warp stages roped K and V
// (N+1 rows) in shared memory as f32; each lane owns one query row at a
// time and streams the keys from shared memory in 16-byte reads (every
// thread reads the same key: a broadcast, no bank conflicts), accumulating the
// output in registers. Long sequences (stage 2) give a block of 128
// threads one (sequence, head), one thread per query, so the staged keys
// serve 128 queries and ~11 blocks fit an SM; short ones (N <= 16: stage 1
// and the encoder, N = 4) give a warp 32/N heads of one sequence, one lane
// per (head, query), so the lanes are not idle. Nothing but q/k/v in and the output out touches device memory;
// the f32 logits and probabilities never leave registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 4;          // short kernel: warps per block
constexpr int LONG_THREADS = 128;  // long kernel: threads per (sequence, head)

template <int D>
__device__ __forceinline__ void rope_row(float* v, const float* cs, const float* sn) {
  float r[D];
#pragma unroll
  for (int d = 0; d < D; ++d) r[d] = d < D / 2 ? -v[d + D / 2] : v[d - D / 2];
#pragma unroll
  for (int d = 0; d < D; ++d) v[d] = v[d] * cs[d] + r[d] * sn[d];
}

// one query row against the NK keys/values staged at Ks/Vs/Kb: softmax
// (base 2 without max, or natural with max) and the weighted sum of values
template <int D>
__device__ __forceinline__ void attend_row(const float* q, const float* Ks, const float* Vs,
                                           const float* Kb, int NK, int base2, float* acc) {
  auto logit = [&](int j) {
    const float4* k4 = reinterpret_cast<const float4*>(Ks + j * D);
    float l = Kb[j];
#pragma unroll
    for (int d = 0; d < D / 4; ++d) {
      float4 k = k4[d];
      l += q[4 * d] * k.x + q[4 * d + 1] * k.y + q[4 * d + 2] * k.z + q[4 * d + 3] * k.w;
    }
    return l;
  };
  float m = 0.f;
  if (!base2) {
    m = -3.0e38f;
    for (int j = 0; j < NK; ++j) m = fmaxf(m, logit(j));
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float denom = 0.f;
  for (int j = 0; j < NK; ++j) {
    float l = logit(j);
    float p = base2 ? exp2f(fminf(l, 100.f)) : expf(l - m);
    denom += p;
    const float4* v4 = reinterpret_cast<const float4*>(Vs + j * D);
#pragma unroll
    for (int d = 0; d < D / 4; ++d) {
      float4 v = v4[d];
      acc[4 * d] += p * v.x;
      acc[4 * d + 1] += p * v.y;
      acc[4 * d + 2] += p * v.z;
      acc[4 * d + 3] += p * v.w;
    }
  }
  float inv = 1.f / (base2 ? denom + 1e-30f : denom);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] *= inv;
}

// per-head staging: NK roped keys, NK values, NK key biases (16-byte aligned)
__host__ __device__ constexpr int head_floats(int NK, int D) { return 2 * NK * D + ((NK + 3) & ~3); }

// stage key/value row n (n == N: the bias token) of head h, RoPE'd at n
template <int D>
__device__ __forceinline__ void stage_key(const bf16* qkv, const bf16* bias_k, const bf16* bias_v,
                                          const float* key_valid, const float* cos_t,
                                          const float* sin_t, long long row, int n, int N, int h,
                                          int C, float* Ks, float* Vs, float* Kb) {
  float kv[D], vv[D];
  if (n < N) {
    const bf16* src = qkv + row * 3LL * C + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kv[d] = __bfloat162float(src[C + d]);
      vv[d] = __bfloat162float(src[2 * C + d]);
    }
    Kb[n] = key_valid[row] > 0.f ? 0.f : -1e9f;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kv[d] = __bfloat162float(bias_k[h * D + d]);
      vv[d] = __bfloat162float(bias_v[h * D + d]);
    }
    Kb[n] = 0.f;
  }
  rope_row<D>(kv, cos_t + n * D, sin_t + n * D);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    Ks[n * D + d] = kv[d];
    Vs[n * D + d] = vv[d];
  }
}

// short sequences: a warp takes HPW = 32 / N heads of one sequence
template <int D>
__global__ void __launch_bounds__(WARPS * 32) rope_attention_short_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias_k,
    const bf16* __restrict__ bias_v, const float* __restrict__ key_valid,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    bf16* __restrict__ out, int G, int N, int I, int H, int C, int base2) {
  extern __shared__ __align__(16) float smem_s[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int HPW = 32 / N, groups = (H + HPW - 1) / HPW, NK = N + 1;
  const long long task = (long long)blockIdx.x * WARPS + warp;
  if (task >= (long long)G * I * groups) return;
  const int hg = (int)(task % groups);
  const long long s = task / groups, g = s / I, i = s % I;
  const long long row0 = g * N * I + i;
  const int hf = head_floats(NK, D);
  float* base = smem_s + (size_t)warp * HPW * hf;

  for (int e = lane; e < HPW * NK; e += 32) {
    int hl = e / NK, n = e % NK, h = hg * HPW + hl;
    if (h >= H) continue;
    float* Ks = base + hl * hf;
    stage_key<D>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, row0 + (long long)(n < N ? n : 0) * I,
                 n, N, h, C, Ks, Ks + NK * D, Ks + 2 * NK * D);
  }
  __syncwarp();
  const int hl = lane / N, n = lane % N, h = hg * HPW + hl;
  if (hl >= HPW || h >= H) return;
  const float* Ks = base + hl * hf;
  float q[D], acc[D];
  const long long row = row0 + (long long)n * I;
  const bf16* src = qkv + row * 3LL * C + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = __bfloat162float(src[d]);
  rope_row<D>(q, cos_t + n * D, sin_t + n * D);
  attend_row<D>(q, Ks, Ks + NK * D, Ks + 2 * NK * D, NK, base2, acc);
  bf16* dst = out + row * C + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) dst[d] = __float2bfloat16(acc[d]);
}

// long sequences: a block of 128 threads takes one (sequence, head); the
// keys are staged by all threads, then each thread owns one query row
template <int D>
__global__ void __launch_bounds__(LONG_THREADS) rope_attention_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias_k,
    const bf16* __restrict__ bias_v, const float* __restrict__ key_valid,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    bf16* __restrict__ out, int G, int N, int I, int H, int C, int base2) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const long long task = blockIdx.x;
  const int NK = N + 1;
  float* Ks = smem;
  float* Vs = Ks + NK * D;
  float* Kb = Vs + NK * D;
  const int h = (int)(task % H);
  const long long s = task / H, g = s / I, i = s % I;
  // row of token n: (g*N + n)*I + i
  const long long row0 = g * N * I + i;

  for (int n = tid; n < NK; n += LONG_THREADS)
    stage_key<D>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, row0 + (long long)(n < N ? n : 0) * I,
                 n, N, h, C, Ks, Vs, Kb);
  __syncthreads();

  for (int n = tid; n < N; n += LONG_THREADS) {
    float q[D], acc[D];
    const long long row = row0 + (long long)n * I;
    const bf16* src = qkv + row * 3LL * C + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = __bfloat162float(src[d]);
    rope_row<D>(q, cos_t + n * D, sin_t + n * D);
    attend_row<D>(q, Ks, Vs, Kb, NK, base2, acc);
    bf16* dst = out + row * C + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) dst[d] = __float2bfloat16(acc[d]);
  }
}

template <int D>
int launch(const void* qkv, const void* bias_k, const void* bias_v, const void* key_valid,
           const void* cos_t, const void* sin_t, void* out, int G, int N, int I, int H,
           int C, int base2, cudaStream_t stream) {
  const int NK = N + 1;
  const bool short_seq = N <= 16;
  const int HPW = short_seq ? 32 / N : 1;
  auto kern = short_seq ? rope_attention_short_kernel<D> : rope_attention_kernel<D>;
  const size_t smem = (short_seq ? (size_t)WARPS * HPW : 1) * head_floats(NK, D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long tasks = (long long)G * I * ((H + HPW - 1) / HPW);
  const unsigned blocks = (unsigned)(short_seq ? (tasks + WARPS - 1) / WARPS : tasks);
  kern<<<blocks, short_seq ? WARPS * 32 : LONG_THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias_k),
      static_cast<const bf16*>(bias_v), static_cast<const float*>(key_valid),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<bf16*>(out), G, N, I, H, C, base2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rope_attention(const void* qkv, const void* bias_k, const void* bias_v,
                              const void* key_valid, const void* cos_t, const void* sin_t,
                              void* out, int G, int N, int I, int H, int C, int base2,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 16: return launch<16>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s);
    case 24: return launch<24>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s);
    case 32: return launch<32>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s);
    case 64: return launch<64>(qkv, bias_k, bias_v, key_valid, cos_t, sin_t, out, G, N, I, H, C, base2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
