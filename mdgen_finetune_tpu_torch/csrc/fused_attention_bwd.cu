// fused_attention_bwd: the backward of fused_attention (fused_attention.cu).
//
// Replaces mdgen_finetune_tpu/ops/fused_attention.py::_bwd_tpu (body
// _bwd_kernel). The TPU kernel recomputes P from the whole resident row, emits
// dQ per query block and accumulates dK / dV in place across its sequential
// grid of query blocks (fused_attention.py:109-134). Hopper's blocks run in
// parallel with no order, so the sums over keys (dq) and over queries (dk,
// dv) are two kernels, each owning its outputs: deterministic, no atomics.
//
// Inputs: q (R, N, D), k, v (R, M, D), key_valid (B, M) (row r takes
// key_valid[r / H]), the forward's output o (R, N, D) and statistic stat
// (R, N) (log2 of the softmax denominator), the upstream gradient dout
// (R, N, D). With t the logit in base-2 units (fused_attention.cu):
//   p     = exp2(min(t, 100) - stat) (base2)  or  exp2(t - stat) (natural)
//   delta = rowsum(dout * o)                  (f32, into the `delta` scratch)
//   dp    = dout . v^T
//   ds    = p * (dp - delta) on attendable keys, 0 on masked ones (the
//           adjoint of JAX's where(mask, l, -1e9)); base2 carries a factor
//           ln 2 (d exp2(x)/dx = ln 2 exp2(x), fused_attention.py:127-128)
//   dv = p^T . dout,  dk = ds^T . q,  dq = ds . k
// Outputs dq, dk, dv in bf16, as the JAX kernel returns them. p and ds go
// to their products in bf16 (f32 accumulators); ln 2 multiplies dq and dk
// in f32 after the sums.
//
// What bounds it on the H100: at B = 8, T = 1000, L = 4, 16 heads of D = 24
// (R = 512, N = 1,000, M = 1,001) the five products that any backward
// recomputing P needs (q.k, dout.v, p^T.dout, ds^T.q, ds.k) are 1.2e11 FLOP,
// 0.124 ms at 989 TFLOP/s; the ~175 MB of operands and outputs take
// 0.052 ms. Two passes form p twice, 1.0e9 exp2 there, 0.245 ms of the
// SFU's 16 per clock per SM at 1,980 MHz: the floor of this design, which
// buys a dq that needs no cross-block sum.
//
// Design (long_attention.cuh: 8 warps per block, the other side's rows
// resident in shared memory, no barrier in a warp's walk):
//   - dq pass, first: a block per (row, chunk of 16-query tiles). It stages
//     the row's k and v once with cp.async (masked keys' k as zeros, so
//     that their ds reaches no dq sum) and each key's additive mask. A warp
//     takes a query tile: q and dout as A fragments read from device memory,
//     delta = rowsum(dout * o) of its 16 rows (written to `delta` for the
//     second pass), then it walks the resident keys in steps of 32: S and
//     dP by mma.sync, p and ds in registers, dq += ds . k with k's B
//     fragments by ldmatrix.trans. dq sums over the keys in key order in
//     registers.
//   - dK / dV pass: a block per (row, chunk of 16-key tiles), the row's q
//     and dout resident (cp.async), with each query's stat and delta. A
//     warp takes a key tile (k and v as A fragments), walks the queries in
//     steps of 16: S^T and dP^T, p^T and ds^T, dv += p^T . dout and
//     dk += ds^T . q with B fragments by ldmatrix.trans. A masked key's dk
//     is zero.
// Rows of D lanes (no pad of D = 24 to 32; 48 bytes, conflict-free
// ldmatrix), an m16n8k8 tail at D = 24, no transposed copy of any tile.

#include <cuda_runtime.h>

#include "long_attention.cuh"

using namespace longattn;
using rope_tile::load_row;

namespace {

// the block's shared memory at a window of `win` resident rows: two
// bf16 row-major tiles (k, v or q, dout) and `nf` floats per row
template <int D>
__host__ __device__ inline size_t bwd_smem(int win, int nf) {
  return (size_t)win * (2 * Geo<D>::RS * 2 + 4 * nf);
}

// ---- the dq pass ----

// keys k0 .. k0 + 8 NBK - 1 against this warp's 16 queries: acc += ds . k
template <int D, bool BASE2, int NBK>
__device__ __forceinline__ void dq_step(float (*acc)[4], const AFrag<D>& qa, const AFrag<D>& ga,
                                        const float* lse, const float* dl, const bf16* Ks,
                                        const bf16* Vs, const float* Kb, int k0) {
  constexpr int OB = Geo<D>::OB;
  const int tig = threadIdx.x & 3;
  uint32_t da[NBK / 2][4];
#pragma unroll
  for (int nb = 0; nb < NBK; ++nb) {
    float s[4], dp[4];
    prod_d<D>(s, qa, Ks, k0 + nb * 8);
    prod_d<D>(dp, ga, Vs, k0 + nb * 8);
    const float2 kb = *reinterpret_cast<const float2*>(Kb + k0 + nb * 8 + tig * 2);
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a masked key's k is zero: t = its -1e9 exactly; past M, -inf
      float t = fmaf(s[e], BASE2 ? 1.f : LOG2E, e & 1 ? kb.y : kb.x);
      if (BASE2) t = fminf(t, 100.f);
      ds[e] = ex2(t - lse[e >> 1]) * (dp[e] - dl[e >> 1]);
    }
    da[nb / 2][(nb % 2) * 2] = pack2(ds[0], ds[1]);
    da[nb / 2][(nb % 2) * 2 + 1] = pack2(ds[2], ds[3]);
  }
#pragma unroll
  for (int j = 0; j < NBK / 2; ++j) {
    uint32_t b[OB][2];
    load_b_rows<D>(b, Ks, k0 + j * 16);
#pragma unroll
    for (int db = 0; db < OB; ++db) mma16816(acc[db], da[j], b[db][0], b[db][1]);
  }
}

template <int D, bool BASE2>
__global__ void __launch_bounds__(THREADS, Occ<D>::MIN_BLOCKS) fused_attention_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ key_valid, const bf16* __restrict__ o,
    const bf16* __restrict__ dout, const float* __restrict__ stat, bf16* __restrict__ dq,
    float* __restrict__ delta, int N, int M, int H, int chunks, int chunk, int win) {
  constexpr int RS = Geo<D>::RS, OB = Geo<D>::OB;
  constexpr int NBK = D <= 32 ? 4 : 2;  // 8-key blocks of a full step
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)win * RS;
  float* Kb = reinterpret_cast<float*>(Vs + (size_t)win * RS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const long long r = blockIdx.x / chunks;
  const bf16 *qr = q + r * N * D, *gr = dout + r * N * D, *orow = o + r * N * D;
  const bf16 *kr = k + r * M * D, *vr = v + r * M * D;
  const float* kv = key_valid + (r / H) * M;
  const int MKP = (M + 15) / 16 * 16;
  const Sched sc(blockIdx.x % chunks, chunk, (N + 15) / 16, MKP, win);

  auto stage = [&](int w0) {
    const int rows = min(win, MKP - w0);
    stage_async<D>(Ks, kr, w0, rows, M, [&](int n) { return !(kv[n] > 0.f); });
    stage_async<D>(Vs, vr, w0, rows, M, [](int) { return false; });
    for (int i = tid; i < rows; i += THREADS) {
      const int n = w0 + i;
      Kb[i] = n < M ? (kv[n] > 0.f ? 0.f : MASKED) : -INFINITY;
    }
    cp_async_wait_all();
  };

  for (int round = 0; round < sc.rounds; ++round) {
    const int tile = sc.t0 + round * WARPS + warp;
    const bool active = tile < sc.t1;  // uniform over the warp
    AFrag<D> qa, ga;
    float lse[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    if (active) {
      load_a_global<D>(qa, qr, tile * 16, N);
      load_a_global<D>(ga, gr, tile * 16, N);
      // delta of the tile's rows (lane i < 16: row i), kept and written
      const int n = tile * 16 + (lane & 15);
      float dsum = 0.f;
      if (lane < 16 && n < N) {
        float a[D], g[D];
        load_row<D>(a, orow + (long long)n * D);
        load_row<D>(g, gr + (long long)n * D);
#pragma unroll
        for (int d = 0; d < D; ++d) dsum = fmaf(a[d], g[d], dsum);
        delta[r * N + n] = dsum;
      }
      dl[0] = __shfl_sync(0xffffffffu, dsum, gid);
      dl[1] = __shfl_sync(0xffffffffu, dsum, gid + 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int nr = tile * 16 + gid + 8 * i;
        lse[i] = nr < N ? stat[r * N + nr] : 0.f;
      }
    }
    float acc[OB][4];
#pragma unroll
    for (int db = 0; db < OB; ++db) acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;
    for (int w = 0; w < sc.nwin; ++w) {
      if (sc.nwin > 1 || round == 0) {  // one window: staged once for every round
        if (round > 0 || w > 0) __syncthreads();
        stage(w * win);
        __syncthreads();
      }
      if (active) {
        const int nk = min(win, MKP - w * win);
        int k0 = 0;
        for (; k0 + NBK * 8 <= nk; k0 += NBK * 8)
          dq_step<D, BASE2, NBK>(acc, qa, ga, lse, dl, Ks, Vs, Kb, k0);
        for (; k0 < nk; k0 += 16) dq_step<D, BASE2, 2>(acc, qa, ga, lse, dl, Ks, Vs, Kb, k0);
      }
    }
    if (!active) continue;
    const float f = BASE2 ? LN2 : 1.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = tile * 16 + gid + 8 * i;
      if (n >= N) continue;
      bf16* dst = dq + (r * N + n) * D + tig * 2;
#pragma unroll
      for (int db = 0; db < OB; ++db)
        *reinterpret_cast<uint32_t*>(dst + db * 8) = pack2(acc[db][2 * i] * f, acc[db][2 * i + 1] * f);
    }
  }
}

// ---- the dK / dV pass ----

// queries q0 .. q0 + 15 against this warp's 16 keys: dv += p^T . dout,
// dk += ds^T . q
template <int D, bool BASE2>
__device__ __forceinline__ void dkdv_step(float (*dk)[4], float (*dv)[4], const AFrag<D>& ka,
                                          const AFrag<D>& va, const float* ks, const float* kb,
                                          const bf16* Qs, const bf16* Gs, const float* Ls,
                                          const float* Dl, int q0) {
  constexpr int OB = Geo<D>::OB;
  const int tig = threadIdx.x & 3;
  uint32_t pa[4], da[4];
#pragma unroll
  for (int hb = 0; hb < 2; ++hb) {
    float st[4], dpt[4];
    prod_d<D>(st, ka, Qs, q0 + hb * 8);
    prod_d<D>(dpt, va, Gs, q0 + hb * 8);
    const int c = q0 + hb * 8 + tig * 2;
    const float2 ls = *reinterpret_cast<const float2*>(Ls + c);
    const float2 dl = *reinterpret_cast<const float2*>(Dl + c);
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // rows: this thread's keys (a masked key: ks = 0, t = -1e9 exactly)
      float t = fmaf(st[e], ks[e >> 1], kb[e >> 1]);
      if (BASE2) t = fminf(t, 100.f);
      p[e] = ex2(t - (e & 1 ? ls.y : ls.x));
      ds[e] = p[e] * (dpt[e] - (e & 1 ? dl.y : dl.x));
    }
    pa[2 * hb] = pack2(p[0], p[1]);
    pa[2 * hb + 1] = pack2(p[2], p[3]);
    da[2 * hb] = pack2(ds[0], ds[1]);
    da[2 * hb + 1] = pack2(ds[2], ds[3]);
  }
  uint32_t b[OB][2];
  load_b_rows<D>(b, Gs, q0);
#pragma unroll
  for (int db = 0; db < OB; ++db) mma16816(dv[db], pa, b[db][0], b[db][1]);
  load_b_rows<D>(b, Qs, q0);
#pragma unroll
  for (int db = 0; db < OB; ++db) mma16816(dk[db], da, b[db][0], b[db][1]);
}

template <int D, bool BASE2>
__global__ void __launch_bounds__(THREADS, Occ<D>::MIN_BLOCKS) fused_attention_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ key_valid, const bf16* __restrict__ dout,
    const float* __restrict__ stat, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int N, int M, int H, int chunks, int chunk, int win) {
  constexpr int RS = Geo<D>::RS, OB = Geo<D>::OB;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + (size_t)win * RS;
  float* Ls = reinterpret_cast<float*>(Gs + (size_t)win * RS);
  float* Dl = Ls + win;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const long long r = blockIdx.x / chunks;
  const bf16 *qr = q + r * N * D, *gr = dout + r * N * D;
  const bf16 *kr = k + r * M * D, *vr = v + r * M * D;
  const float* kv = key_valid + (r / H) * M;
  const int NQP = (N + 15) / 16 * 16;
  const Sched sc(blockIdx.x % chunks, chunk, (M + 15) / 16, NQP, win);

  // queries w0 ..: q, dout, stat and delta; past N zero rows with stat
  // +inf, so that their p is 0
  auto stage = [&](int w0) {
    const int rows = min(win, NQP - w0);
    stage_async<D>(Qs, qr, w0, rows, N, [](int) { return false; });
    stage_async<D>(Gs, gr, w0, rows, N, [](int) { return false; });
    for (int i = tid; i < rows; i += THREADS) {
      const int n = w0 + i;
      Ls[i] = n < N ? stat[r * N + n] : INFINITY;
      Dl[i] = n < N ? delta[r * N + n] : 0.f;
    }
    cp_async_wait_all();
  };

  for (int round = 0; round < sc.rounds; ++round) {
    const int tile = sc.t0 + round * WARPS + warp;
    const bool active = tile < sc.t1;  // uniform over the warp
    AFrag<D> ka, va;
    float ks[2] = {0.f, 0.f}, kb[2] = {0.f, 0.f};
    bool valid[2] = {false, false};
    if (active) {
      load_a_global<D>(ka, kr, tile * 16, M);
      load_a_global<D>(va, vr, tile * 16, M);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = tile * 16 + gid + 8 * i;
        valid[i] = n < M && kv[n] > 0.f;
        ks[i] = valid[i] ? (BASE2 ? 1.f : LOG2E) : 0.f;
        kb[i] = n < M ? (valid[i] ? 0.f : MASKED) : -INFINITY;
      }
    }
    float dka[OB][4], dva[OB][4];
#pragma unroll
    for (int db = 0; db < OB; ++db)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[db][e] = dva[db][e] = 0.f;
    for (int w = 0; w < sc.nwin; ++w) {
      if (sc.nwin > 1 || round == 0) {
        if (round > 0 || w > 0) __syncthreads();
        stage(w * win);
        __syncthreads();
      }
      if (active) {
        const int nq = min(win, NQP - w * win);
#pragma unroll 2
        for (int q0 = 0; q0 < nq; q0 += 16)
          dkdv_step<D, BASE2>(dka, dva, ka, va, ks, kb, Qs, Gs, Ls, Dl, q0);
      }
    }
    if (!active) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = tile * 16 + gid + 8 * i;
      if (n >= M) continue;
      const float f = valid[i] ? (BASE2 ? LN2 : 1.f) : 0.f;  // a masked key's ds is 0
      bf16* pk = dk + (r * M + n) * D + tig * 2;
      bf16* pv = dv + (r * M + n) * D + tig * 2;
#pragma unroll
      for (int db = 0; db < OB; ++db) {
        *reinterpret_cast<uint32_t*>(pk + db * 8) = pack2(dka[db][2 * i] * f, dka[db][2 * i + 1] * f);
        *reinterpret_cast<uint32_t*>(pv + db * 8) = pack2(dva[db][2 * i], dva[db][2 * i + 1]);
      }
    }
  }
}

template <int D, bool BASE2>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* key_valid, const bf16* o,
           const bf16* dout, const float* stat, bf16* dq, bf16* dk, bf16* dv, float* delta,
           int R, int N, int M, int H, int qchunk, int kwin, int kchunk, int qwin,
           cudaStream_t stream) {
  if (R <= 0 || N <= 0 || M <= 0 || qchunk <= 0 || kchunk <= 0 || kwin < 16 || kwin % 16 ||
      qwin < 16 || qwin % 16)
    return (int)cudaErrorInvalidValue;
  const int qchunks = ((N + 15) / 16 + qchunk - 1) / qchunk;
  const int kchunks = ((M + 15) / 16 + kchunk - 1) / kchunk;
  if ((long long)R * qchunks > 0x7fffffffLL || (long long)R * kchunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t sq = bwd_smem<D>(kwin, 1), sk = bwd_smem<D>(qwin, 2);
  cudaError_t e = cudaFuncSetAttribute(fused_attention_dq_kernel<D, BASE2>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sq);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_attention_dkdv_kernel<D, BASE2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sk);
  if (e != cudaSuccess) return (int)e;
  // dq first: it writes delta, which the dK / dV pass reads
  fused_attention_dq_kernel<D, BASE2><<<(unsigned)(R * qchunks), THREADS, sq, stream>>>(
      q, k, v, key_valid, o, dout, stat, dq, delta, N, M, H, qchunks, qchunk, kwin);
  int err = (int)cudaGetLastError();
  if (err) return err;
  fused_attention_dkdv_kernel<D, BASE2><<<(unsigned)(R * kchunks), THREADS, sk, stream>>>(
      q, k, v, key_valid, dout, stat, delta, dk, dv, N, M, H, kchunks, kchunk, qwin);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mode(const bf16* q, const bf16* k, const bf16* v, const float* key_valid,
                const bf16* o, const bf16* dout, const float* stat, bf16* dq, bf16* dk, bf16* dv,
                float* delta, int R, int N, int M, int H, int base2, int qchunk, int kwin,
                int kchunk, int qwin, cudaStream_t s) {
  return base2 ? launch<D, true>(q, k, v, key_valid, o, dout, stat, dq, dk, dv, delta, R, N, M, H,
                                 qchunk, kwin, kchunk, qwin, s)
               : launch<D, false>(q, k, v, key_valid, o, dout, stat, dq, dk, dv, delta, R, N, M,
                                  H, qchunk, kwin, kchunk, qwin, s);
}

template <int D>
int resources_pass(int pass, int win, int base2, long long* info) {
  if (pass == 0)
    return base2 ? resources(fused_attention_dq_kernel<D, true>, bwd_smem<D>(win, 1), info)
                 : resources(fused_attention_dq_kernel<D, false>, bwd_smem<D>(win, 1), info);
  return base2 ? resources(fused_attention_dkdv_kernel<D, true>, bwd_smem<D>(win, 2), info)
               : resources(fused_attention_dkdv_kernel<D, false>, bwd_smem<D>(win, 2), info);
}

}  // namespace

// The schedule (ops/long_attention.py) follows the stream: the dq pass's
// 16-query tiles per block and resident keys, the dK / dV pass's 16-key
// tiles per block and resident queries
extern "C" int fused_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* key_valid, const void* o, const void* dout,
                                   const void* stat, void* dq, void* dk, void* dv, void* delta,
                                   int R, int N, int M, int H, int D, int base2, void* stream,
                                   int qchunk, int kwin, int kchunk, int qwin) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *q_ = static_cast<const bf16*>(q), *k_ = static_cast<const bf16*>(k),
             *v_ = static_cast<const bf16*>(v), *o_ = static_cast<const bf16*>(o),
             *g_ = static_cast<const bf16*>(dout);
  const float *kv_ = static_cast<const float*>(key_valid), *st_ = static_cast<const float*>(stat);
  bf16 *dq_ = static_cast<bf16*>(dq), *dk_ = static_cast<bf16*>(dk), *dv_ = static_cast<bf16*>(dv);
  float* dl_ = static_cast<float*>(delta);
  switch (D) {
    case 16: return launch_mode<16>(q_, k_, v_, kv_, o_, g_, st_, dq_, dk_, dv_, dl_, R, N, M, H, base2, qchunk, kwin, kchunk, qwin, s);
    case 24: return launch_mode<24>(q_, k_, v_, kv_, o_, g_, st_, dq_, dk_, dv_, dl_, R, N, M, H, base2, qchunk, kwin, kchunk, qwin, s);
    case 32: return launch_mode<32>(q_, k_, v_, kv_, o_, g_, st_, dq_, dk_, dv_, dl_, R, N, M, H, base2, qchunk, kwin, kchunk, qwin, s);
    case 64: return launch_mode<64>(q_, k_, v_, kv_, o_, g_, st_, dq_, dk_, dv_, dl_, R, N, M, H, base2, qchunk, kwin, kchunk, qwin, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the resources of one pass (0: dq, 1: dK / dV) at a window of `win` rows
extern "C" int fused_attention_bwd_resources(int pass, int win, int D, int base2, long long* info) {
  switch (D) {
    case 16: return resources_pass<16>(pass, win, base2, info);
    case 24: return resources_pass<24>(pass, win, base2, info);
    case 32: return resources_pass<32>(pass, win, base2, info);
    case 64: return resources_pass<64>(pass, win, base2, info);
    default: return (int)cudaErrorInvalidValue;
  }
}
