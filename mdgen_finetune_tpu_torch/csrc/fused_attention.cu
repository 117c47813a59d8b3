// fused_attention: masked softmax attention over a row's keys, forward.
//
// Replaces mdgen_finetune_tpu/ops/fused_attention.py::_fwd_tpu (:66,
// pallas_call :75, body _fwd_kernel :44-62), the TPU kernel that keeps a
// whole row's K/V (up to 4,096 keys) in VMEM. It runs as the attention core
// of the frame stage's backward at long T (the JAX package's `_tbb_bwd`
// recomputes the stage through `_block_xla_tl` with this core: B*L*H rows of
// T queries and T + 1 keys, the bias key appended by the caller, head dim
// 24), and as the `no_rope` attention of the modular layer and the encoder
// (ops/fused_attention.py::dense_attn): the frame view (B*L*H rows of T
// queries) and the residue view (B*T*H rows of L queries, L + 1 keys).
//
// Layout: q (R, N, D), k and v (R, M, D) bf16, R = B * H rows; key_valid
// (B, M) f32, 1 = attendable, shared by the H heads of a batch element
// (row r uses r / H). q is already scaled (and RoPE'd). Outputs: o (R, N, D)
// bf16 and one f32 statistic per query row for the backward
// (fused_attention_bwd.cu): the log2 of the softmax denominator in base-2
// units, log2(sum + 1e-30) in base 2 and max + log2(sum) in the natural
// mode, so that p = exp2(t - stat) with t the logit in base-2 units.
//
// Two softmaxes, both as in the JAX kernel:
//   - base2 (q carries log2(e)): p = exp2(min(t, 100)) with no max, over
//     sum(p) + 1e-30;
//   - natural: the max-subtracted softmax of t = q.k * log2(e).
// A masked key's logit is REPLACED by -1e9 (JAX's `where(mask, l, -1e9)`),
// so a row whose every key is masked is uniform over them in the natural
// mode. Here a masked key's logit is q.k * km - 1e9, with km the row's scale
// where any of its keys is attendable (the result then underflows to p = 0
// as -1e9 would) and km = 0 where none is (every logit is then exactly
// -1e9). Keys past M take no part. p goes to the PV product in bf16 (as JAX
// casts p before its PV dot), the sums stay f32.
//
// What bounds it on the H100, and the two forms (ops/long_attention.py::
// fused_plan picks the form and the schedule; the launcher sizes its grid
// and shared memory from the plan it is given):
//   - the long form (N > 16, or more than 32 keys): at B = 8, T = 1000,
//     L = 4, 16 heads of D = 24 it does 4 * R * N * M * D = 4.9e10 FLOP
//     (0.050 ms at 989 TFLOP/s) against ~100 MB (0.030 ms), but it forms one
//     exp2 per (query, key), 5.1e8, and the SFU issues 16 a clock per SM:
//     0.12 ms at 1,980 MHz, above both. It is row g's design
//     (long_attention.cuh, tiled_attention.cu): one block of 8 warps per
//     row (or per chunk of its query tiles where the rows alone do not fill
//     the SMs); the row's keys and values staged once by cp.async in rows
//     of D lanes (the 1,001 keys of T = 1000 in 101 KB, two blocks an SM),
//     each key's additive mask beside them; each warp walks every resident
//     key with two 16-query tiles in registers (mma.sync, an m16n8k8 tail
//     at D = 24) and no barrier, the natural mode rescaling only where a
//     row's max rose; windows where a row does not fit two blocks an SM. No
//     RoPE and no appended key here (the caller appends the bias key); the
//     queries come straight from device memory as A fragments.
//   - the short form (N <= 16 queries and at most 32 keys: the residue view,
//     6,400 sequences x 16 heads of 4 queries and 5 keys at the flagship):
//     a 16-row tensor-core tile would be 75% padding at N = 4, and the work,
//     ~3.4e8 FLOP against ~90 MB, is bound by the bytes (0.027 ms). A block
//     of 256 threads takes `rows` attention rows, one thread per (row,
//     query): their keys and values come in by cp.async as one contiguous
//     span of 16-byte units, the queries and outputs move as 16-byte units
//     of contiguous rows, and each thread forms its logits, softmax and
//     output in f32 on the CUDA cores (the logits of a row in registers, so
//     the natural max is exact, with no rescaling).

#include <cuda_runtime.h>

#include "long_attention.cuh"

using namespace longattn;

namespace {

constexpr int SHORT_THREADS = 256;
constexpr int SHORT_MAX_KEYS = 32;  // ops/long_attention.py: SHORT_MAX_KEYS

// the logits' scale to base-2 units of a row with an attendable key, or 0
// where every key is masked (each logit is then the mask's -1e9)
template <bool NATURAL>
__device__ __forceinline__ float row_scale(bool any_valid) {
  return any_valid ? (NATURAL ? LOG2E : 1.f) : 0.f;
}

// ---------------------------------------------------------------------------
// the long form
// ---------------------------------------------------------------------------
template <int D, bool NATURAL>
__global__ void __launch_bounds__(THREADS, Occ<D>::MIN_BLOCKS) fused_attention_long(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ key_valid, bf16* __restrict__ o, float* __restrict__ stat, int N,
    int M, int H, int chunks, int chunk, int win) {
  constexpr int RS = Geo<D>::RS, OB = Geo<D>::OB;
  constexpr int NBK = D <= 32 ? 4 : 2;  // 8-key blocks of a full step
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout<D> lay(win);
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.ks);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.vs);
  float* Kb = reinterpret_cast<float*>(smem + lay.kb);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  bf16* Qw = reinterpret_cast<bf16*>(smem + lay.qw) + warp * TQ * 16 * RS;

  const long long r = blockIdx.x / chunks;
  const bf16* qr = q + r * N * D;
  const bf16* kr = k + r * M * D;
  const bf16* vr = v + r * M * D;
  const float* kv = key_valid + (r / H) * M;
  const int NKP = (M + 15) / 16 * 16;  // the keys in 16-key tiles
  const Sched sc(blockIdx.x % chunks, chunk, (N + 15) / 16, NKP, win, TQ);
  int any = 0;
  for (int j = tid; j < M; j += THREADS) any |= kv[j] > 0.f;
  const float km = row_scale<NATURAL>(__syncthreads_or(any));

  // keys w0 .. of the window: k and v by cp.async (every 16-byte unit in
  // flight at once, zero rows past M) and the additive masks (0, -1e9, or
  // -inf past M); finish waits and syncs
  auto issue = [&](int w0) {
    const int rows = min(win, NKP - w0);
    stage_async<D>(Ks, kr, w0, rows, M, [](int) { return false; });
    stage_async<D>(Vs, vr, w0, rows, M, [](int) { return false; });
    for (int j = tid; j < rows; j += THREADS) {
      const int n = w0 + j;
      Kb[j] = n < M ? (kv[n] > 0.f ? 0.f : MASKED) : -INFINITY;
    }
  };
  auto finish = [&]() {
    cp_async_wait_all();
    __syncthreads();
  };

  for (int round = 0; round < sc.rounds; ++round) {
    const int tile0 = sc.t0 + (round * WARPS + warp) * TQ;
    const bool active = tile0 < sc.t1;  // uniform over the warp
    if (round == 0) issue(0);  // the first window's copies fly while the queries load
    AFrag<D> qa[TQ];
    if (active) {
#pragma unroll
      for (int t = 0; t < TQ; ++t) load_a_global<D>(qa[t], qr, (tile0 + t) * 16, N);
    }
    float acc[TQ][OB][4], l[TQ][2], m[TQ][2];
#pragma unroll
    for (int t = 0; t < TQ; ++t) {
      l[t][0] = l[t][1] = 0.f;
      m[t][0] = m[t][1] = -INFINITY;
#pragma unroll
      for (int db = 0; db < OB; ++db) acc[t][db][0] = acc[t][db][1] = acc[t][db][2] = acc[t][db][3] = 0.f;
    }
    for (int w = 0; w < sc.nwin; ++w) {
      if (sc.nwin > 1 || round == 0) {  // one window: staged once for every round
        if (round > 0 || w > 0) {
          __syncthreads();  // every warp is done with the last window
          issue(w * win);
        }
        finish();
      }
      if (active) {
        const int nk = min(win, NKP - w * win);
        int k0 = 0;
        for (; k0 + NBK * 8 <= nk; k0 += NBK * 8) step<D, NATURAL, NBK>(acc, l, m, qa, Ks, Vs, Kb, km, k0);
        for (; k0 < nk; k0 += 16) step<D, NATURAL, 2>(acc, l, m, qa, Ks, Vs, Kb, km, k0);
      }
    }
    if (!active) continue;
    // the statistic, and the normalised rows in bf16 into the warp's own
    // rows, then one row per lane to device memory in 16-byte stores
#pragma unroll
    for (int t = 0; t < TQ; ++t)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float li = l[t][i];
        li += __shfl_xor_sync(0xffffffffu, li, 1);
        li += __shfl_xor_sync(0xffffffffu, li, 2);
        // the natural row sums hold exp2(0) = 1 at least (the row's max key)
        const float sum = NATURAL ? li : li + 1e-30f;
        const float inv = 1.f / sum;
        const int n = (tile0 + t) * 16 + gid + 8 * i;
        if (tig == 0 && tile0 + t < sc.t1 && n < N)
          stat[r * N + n] = NATURAL ? m[t][i] + log2f(sum) : log2f(sum);
        bf16* row = Qw + (t * 16 + gid + 8 * i) * RS + tig * 2;
#pragma unroll
        for (int db = 0; db < OB; ++db)
          *reinterpret_cast<uint32_t*>(row + db * 8) = pack2(acc[t][db][2 * i] * inv, acc[t][db][2 * i + 1] * inv);
      }
    __syncwarp();
    const int n = tile0 * 16 + lane;
    if (lane < TQ * 16 && tile0 + lane / 16 < sc.t1 && n < N) {
      const uint4* src = reinterpret_cast<const uint4*>(Qw + lane * RS);
      uint4* dst = reinterpret_cast<uint4*>(o + (r * N + n) * D);
#pragma unroll
      for (int u = 0; u < D / 8; ++u) dst[u] = src[u];
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// the short form
// ---------------------------------------------------------------------------
__device__ __forceinline__ void unpack8f(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int D, bool NATURAL>
__global__ void __launch_bounds__(SHORT_THREADS) fused_attention_short(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ key_valid, bf16* __restrict__ o, float* __restrict__ stat, int R,
    int N, int M, int H, int rows) {
  constexpr int U = D / 8;  // 16-byte units of a row
  extern __shared__ __align__(16) unsigned char smem[];
  const long long r0 = (long long)blockIdx.x * rows;
  const int nr = (int)min((long long)rows, R - r0);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)rows * M * D;
  const int units = nr * M * U, tid = threadIdx.x;
  for (int e = tid; e < units; e += SHORT_THREADS) {
    cp_async16(Ks + e * 8, k + r0 * M * D + e * 8, true);
    cp_async16(Vs + e * 8, v + r0 * M * D + e * 8, true);
  }
  cp_async_wait_all();
  __syncthreads();
  const int lr = tid / N, n = tid % N;
  if (lr >= nr) return;
  const long long r = r0 + lr;
  const float* kv = key_valid + (r / H) * M;
  float qf[D];
  {
    const uint4* src = reinterpret_cast<const uint4*>(q + (r * N + n) * D);
#pragma unroll
    for (int u = 0; u < U; ++u) unpack8f(src[u], qf + 8 * u);
  }
  bool any = false;
  float kb[SHORT_MAX_KEYS];
#pragma unroll
  for (int j = 0; j < SHORT_MAX_KEYS; ++j) {
    const bool valid = j < M && kv[j] > 0.f;
    kb[j] = valid ? 0.f : MASKED;
    any |= valid;
  }
  const float km = row_scale<NATURAL>(any);
  const bf16* kr = Ks + (size_t)lr * M * D;
  const bf16* vr = Vs + (size_t)lr * M * D;
  float t[SHORT_MAX_KEYS], mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < SHORT_MAX_KEYS; ++j) {
    if (j < M) {
      const uint4* kj = reinterpret_cast<const uint4*>(kr + j * D);
      float s = 0.f, f[8];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        unpack8f(kj[u], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(qf[8 * u + e], f[e], s);
      }
      t[j] = fmaf(s, km, kb[j]);
      if (!NATURAL) t[j] = fminf(t[j], 100.f);
      mx = fmaxf(mx, t[j]);
    }
  }
  float acc[D], l = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
#pragma unroll
  for (int j = 0; j < SHORT_MAX_KEYS; ++j) {
    if (j < M) {
      const float p = ex2(NATURAL ? t[j] - mx : t[j]);
      l += p;
      const float pb = __bfloat162float(__float2bfloat16(p));
      const uint4* vj = reinterpret_cast<const uint4*>(vr + j * D);
      float f[8];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        unpack8f(vj[u], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[8 * u + e] = fmaf(pb, f[e], acc[8 * u + e]);
      }
    }
  }
  const float sum = NATURAL ? l : l + 1e-30f, inv = 1.f / sum;
  stat[r * N + n] = NATURAL ? mx + log2f(sum) : log2f(sum);
  uint4* dst = reinterpret_cast<uint4*>(o + (r * N + n) * D);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    uint4 w;
    uint32_t* p = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = pack2(acc[8 * u + 2 * i] * inv, acc[8 * u + 2 * i + 1] * inv);
    dst[u] = w;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <int D, bool NATURAL>
const void* kernel_dn(int form) {
  return form == 0 ? reinterpret_cast<const void*>(fused_attention_long<D, NATURAL>)
                   : reinterpret_cast<const void*>(fused_attention_short<D, NATURAL>);
}

template <int D>
const void* kernel_d(int form, int base2) {
  return base2 ? kernel_dn<D, false>(form) : kernel_dn<D, true>(form);
}

const void* kernel_of(int D, int form, int base2) {
  switch (D) {
    case 16: return kernel_d<16>(form, base2);
    case 24: return kernel_d<24>(form, base2);
    case 32: return kernel_d<32>(form, base2);
    case 64: return kernel_d<64>(form, base2);
    default: return nullptr;
  }
}

// the dynamic shared memory of a form at its schedule (ops/long_attention.py
// computes the same: Plan.smem)
size_t smem_of(int D, int form, int M, int win, int rows) {
  if (form == 1) return (size_t)rows * M * D * 4;
  switch (D) {
    case 16: return FwdLayout<16>(win).total;
    case 24: return FwdLayout<24>(win).total;
    case 32: return FwdLayout<32>(win).total;
    default: return FwdLayout<64>(win).total;
  }
}

}  // namespace

// The trailing arguments are the plan (ops/long_attention.py::fused_plan):
// the form (0 long, 1 short), the long form's query tiles per block and
// resident keys per window, the short form's rows per block, and the
// dynamic shared memory; a plan that does not fit the call is refused
// (cudaErrorInvalidValue).
extern "C" int fused_attention(const void* q, const void* k, const void* v, const void* key_valid,
                               void* o, void* stat, int R, int N, int M, int H, int D, int base2,
                               void* stream, int form, int chunk, int win, int rows,
                               long long smem) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* kern = kernel_of(D, form, base2);
  if (kern == nullptr || R <= 0 || N <= 0 || M <= 0 || (form != 0 && form != 1) ||
      smem != (long long)smem_of(D, form, M, win, rows))
    return (int)cudaErrorInvalidValue;
  long long blocks;
  int threads;
  if (form == 0) {
    if (chunk <= 0 || win < 16 || win % 16) return (int)cudaErrorInvalidValue;
    int chunks = ((N + 15) / 16 + chunk - 1) / chunk;
    blocks = (long long)R * chunks;
    threads = THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    const float* kvp = static_cast<const float*>(key_valid);
    bf16* op = static_cast<bf16*>(o);
    float* sp = static_cast<float*>(stat);
    void* args[] = {&qp, &kp, &vp, &kvp, &op, &sp, &N, &M, &H, &chunks, &chunk, &win};
    e = cudaLaunchKernel(kern, dim3((unsigned)blocks), dim3(threads), args, (size_t)smem, s);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  if (N > SHORT_THREADS || M > SHORT_MAX_KEYS || rows <= 0 || rows * N > SHORT_THREADS)
    return (int)cudaErrorInvalidValue;
  blocks = ((long long)R + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const float* kvp = static_cast<const float*>(key_valid);
  bf16* op = static_cast<bf16*>(o);
  float* sp = static_cast<float*>(stat);
  void* args[] = {&qp, &kp, &vp, &kvp, &op, &sp, &R, &N, &M, &H, &rows};
  e = cudaLaunchKernel(kern, dim3((unsigned)blocks), dim3(SHORT_THREADS), args, (size_t)smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the resources of a form's kernel at `smem` bytes (long_attention.cuh's
// resources: registers, spill bytes, shared memory, blocks per SM)
extern "C" int fused_attention_resources(int form, int D, int base2, long long smem,
                                         long long* info) {
  const void* kern = kernel_of(D, form, base2);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  int per_sm = 0;
  const int threads = form == 0 ? THREADS : SHORT_THREADS;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = fa.numRegs;
  info[1] = (long long)fa.localSizeBytes;
  info[2] = smem;
  info[3] = per_sm;
  return 0;
}
