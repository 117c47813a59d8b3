// fused_attention: masked softmax attention over long key sequences, forward.
//
// Replaces mdgen_finetune_tpu/ops/fused_attention.py::_fwd_tpu (body
// _fwd_kernel), the TPU kernel that keeps a whole row's K/V (up to 4,096
// keys) in VMEM. On the trunk's training path it is the attention core of the
// frame stage's backward at long T (the JAX package's `_tbb_bwd` recomputes
// the stage through `_block_xla_tl` with this core): B*L*H rows of T queries
// and T + 1 keys (the bias key appended), head dim 24.
//
// Layout: q (R, N, D), k and v (R, M, D) bf16, R = B * H rows; key_valid
// (B, M) f32, 1 = attendable, shared by the H heads of a batch element
// (row r uses r / H). q is already scaled (and RoPE'd). Outputs: o (R, N, D)
// bf16 and, for the backward, one f32 statistic per query row: the log2 of
// the softmax denominator, so that p = exp2(t - stat) with t the logit in
// base-2 units.
//
// Two softmaxes, both as in the JAX kernel (fused_attention.py:44-62):
//   - base2 (q carries log2(e)): p = exp2(min(t, 100)) with no max, the
//     denominator sum(p) + 1e-30 (stat = log2 of it, and the backward takes
//     p = exp2(min(t, 100) - stat));
//   - natural: the max-subtracted softmax of the logits, t = q.k * log2(e).
//     JAX takes the max over the whole resident row; here the keys stream,
//     so a running max per row rescales the sums and the output accumulators
//     after each key tile (the flash recurrence); stat = max + log2(sum).
// A masked key's logit is -1e9 (JAX's `where(mask, l, -1e9)`, a replacement,
// so a row with every key masked is uniform over them in the natural
// softmax); keys past M take no part.
//
// Design: one block of 4 warps per (row, 64-query tile). The query tile
// stays in registers as mma.sync A fragments; K (row-major) and V
// (transposed) stream through shared memory in 64-key tiles; per tile a
// warp forms its 16 x 64 logits with mma.sync m16n8k16 (bf16 in, f32 out),
// the weights p in registers, and adds bf16(p) . V into f32 accumulators
// (attention_tile.cuh). The row is normalised once, after the last tile.
// Shared memory is fixed (~15 KB at D = 24), so M has no cap from it.
//
// What bounds it on the H100: at B = 8, T = 1000, L = 4, 16 heads of
// D = 24 it does 4 * R * N * M * D = 4.9e10 FLOP against ~100 MB of q/k/v,
// mask, output and statistic, so the tensor cores bound it (0.050 ms at
// 989 TFLOP/s, against 0.030 ms for the bytes). This first version restages each key
// tile for every query tile (through L2), pads D = 24 to 32 and uses
// mma.sync, not wgmma/TMA: making it fast is later work.

#include <cuda_runtime.h>

#include "attention_tile.cuh"

using namespace attn_tile;

namespace {

template <int D>
__global__ void __launch_bounds__(THREADS) fused_attention_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ key_valid, bf16* __restrict__ o, float* __restrict__ stat,
    int N, int M, int H, int qtiles, int base2) {
  using Dm = Dims<D>;
  __shared__ __align__(16) bf16 Qs[ROWS * Dm::RS];
  __shared__ __align__(16) bf16 Ks[ROWS * Dm::RS];
  __shared__ __align__(16) bf16 Vt[Dm::DP * TS];
  __shared__ float Kc[ROWS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tig = lane & 3;
  const long long r = blockIdx.x / qtiles;
  const int q0 = (int)(blockIdx.x % qtiles) * ROWS;
  const bf16* qr = q + r * N * D;
  const bf16* kr = k + r * M * D;
  const bf16* vr = v + r * M * D;
  const float* kv = key_valid + (r / H) * M;
  const float scale = base2 ? 1.f : LOG2E;

  stage_rows<D>(Qs, nullptr, qr, q0, N);
  __syncthreads();
  uint32_t qa[Dm::KC][4];
  load_a<D>(qa, Qs, warp * 16);

  float acc[Dm::DB][4];
#pragma unroll
  for (int db = 0; db < Dm::DB; ++db) acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;
  float l[2] = {0.f, 0.f};              // this thread's share of rows gid, gid + 8
  float m[2] = {-INFINITY, -INFINITY};  // running row max (natural softmax)

  const int ntiles = (M + ROWS - 1) / ROWS;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * ROWS;
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<D>(Ks, nullptr, kr, k0, M);
    stage_rows<D>(nullptr, Vt, vr, k0, M);
    if (threadIdx.x < ROWS) Kc[threadIdx.x] = key_class(kv, k0 + threadIdx.x, M);
    __syncthreads();

    float s[NB][4];
    product_d<D>(s, qa, Ks);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = logit2(s[nb][e], Kc[nb * 8 + tig * 2 + (e & 1)], scale);
    if (base2) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = exp2f(fminf(s[nb][e], 100.f));
    } else {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // the four threads of a row group hold disjoint columns of the row
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // every tile holds a key < M, so mx is finite and alpha is 0 on the first
        const float alpha = exp2f(m[i] - mx[i]);
        l[i] *= alpha;
#pragma unroll
        for (int db = 0; db < Dm::DB; ++db) {
          acc[db][2 * i] *= alpha;
          acc[db][2 * i + 1] *= alpha;
        }
        m[i] = mx[i];
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = exp2f(s[nb][e] - m[e >> 1]);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      l[0] += s[nb][0] + s[nb][1];
      l[1] += s[nb][2] + s[nb][3];
    }
    product_rows<D>(acc, s, Vt);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float sum = base2 ? l[i] + 1e-30f : l[i];
    inv[i] = 1.f / sum;
    const int n = q0 + warp * 16 + (lane >> 2) + 8 * i;
    if (tig == 0 && n < N) stat[r * N + n] = base2 ? log2f(sum) : m[i] + log2f(sum);
  }
  store_rows<D>(o + r * N * D, acc, q0 + warp * 16, N, inv);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* key_valid, void* o,
           void* stat, int R, int N, int M, int H, int base2, cudaStream_t stream) {
  const int qtiles = (N + ROWS - 1) / ROWS;
  const long long blocks = (long long)R * qtiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL || M <= 0) return (int)cudaErrorInvalidValue;
  fused_attention_fwd_kernel<D><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(key_valid), static_cast<bf16*>(o), static_cast<float*>(stat),
      N, M, H, qtiles, base2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_attention(const void* q, const void* k, const void* v, const void* key_valid,
                               void* o, void* stat, int R, int N, int M, int H, int D, int base2,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, key_valid, o, stat, R, N, M, H, base2, s);
    case 24: return launch<24>(q, k, v, key_valid, o, stat, R, N, M, H, base2, s);
    case 32: return launch<32>(q, k, v, key_valid, o, stat, R, N, M, H, base2, s);
    case 64: return launch<64>(q, k, v, key_valid, o, stat, R, N, M, H, base2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
