// ipa_attention: the core of Invariant Point Attention (c_z = 0), from the
// scalar and point projections to the (rows, H*Ch + 4*H*Pv) output features.
//
// Replaces the IPA part of mdgen_finetune_tpu/ops/ipa_encoder.py::
// _encoder_call (body _kernel: the frame lift, scalar + point logits,
// softplus head weights, frame-mask bias and the scalar / point value
// products with the inverse frame map). The projections on either side run
// in adaln_linear.
//
// Inputs, per encoder element b (B elements of L residues, rows b*L + l):
//   proj (rows, ld) f32 with column blocks
//     [q (H*Ch) | k (H*Ch) | v (H*Ch) | q pts (3*H*Pq) | k pts (3*H*Pq) | v pts (3*H*Pv)],
//     each point block coordinate-major (x | y | z), head-major inside;
//   rot (rows, 3, 3) and trans (rows, 3) f32 frames; mask (rows,) f32;
//   head_weights (H,) raw f32 (softplus in the kernel).
// Per (b, head): lift the points by the frame; logits
//   q.k * sqrt(1/(3 Ch)) - 0.5 softplus(hw) sqrt(1/(3 Pq 9/2)) |q_pts - k_pts|^2
//   + 1e5 (mask_q mask_k - 1);
// natural-exp softmax with max subtraction; scalar and point value sums;
// inverse frame map of the point outputs; norms sqrt(|p|^2 + 1e-8). All the
// point math is f32. Output features bf16, ordered scalars | x | y | z | norms.
//
// Two forms, chosen by the wrapper (ops/ipa_attention.py, RESIDENT_MAX_L):
//   - resident (small L, the 4AA peptides at L = 4): one block of 64 threads
//     per (element, head) stages its L residues' scalars, lifted points and
//     frames in shared memory, forms the L x L logits there, and writes the
//     features once. At L = 4 each (b, head) reads ~2 KB and does a few
//     thousand FLOP; the call is memory-bound (proj in, features out,
//     ~3.3 KB per row at the flagship widths). Its shared memory holds the
//     L x L logits, so it fits only up to L ~ 167 at Ch = 32, Pq = Pv = 8.
//   - tiled (large L, ATLAS at L = 256): one block of 64 threads per
//     (element, head, 64-query tile), one query per thread. The keys stream
//     through shared memory in tiles of 64 (scalars, points lifted as they
//     are staged, mask); each tile's logits go to a per-thread row of shared
//     memory, and the natural-exp softmax keeps a running max and rescales
//     its sums once per tile, as csrc/fused_attention.cu does. No buffer
//     grows with L. At the model's widths (Ch = 32, Pq = Pv = 8, template
//     arguments) a query's scalars, lifted points and sums stay in
//     registers; at any other widths (runtime loops) they live in shared
//     memory, one column per thread, so every width runs at every L, as the
//     JAX encoder's XLA form does (ops/ipa_encoder.py::encoder_xla). At
//     L = 256 each pair costs ~170 f32 FLOP (0.5 GFLOP per 100 elements):
//     f32 arithmetic, not bytes, bounds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS) ipa_attention_kernel(
    const float* __restrict__ proj, long long ld, const float* __restrict__ rot,
    const float* __restrict__ trans, const float* __restrict__ mask,
    const float* __restrict__ head_weights, bf16* __restrict__ feats, long long ldf,
    int B, int L, int H, int Ch, int Pq, int Pv) {
  extern __shared__ float sm[];
  const int b = blockIdx.x / H, h = blockIdx.x % H, tid = threadIdx.x;
  const int HCh = H * Ch, HPq = H * Pq, HPv = H * Pv;
  float* R = sm;                    // L x 9
  float* Tr = R + L * 9;            // L x 3
  float* Mk = Tr + L * 3;           // L
  float* Q = Mk + L;                // L x Ch
  float* K = Q + L * Ch;            // L x Ch
  float* V = K + L * Ch;            // L x Ch
  float* QP = V + L * Ch;           // L x Pq x 3 (global frame)
  float* KP = QP + L * Pq * 3;      // L x Pq x 3
  float* VP = KP + L * Pq * 3;      // L x Pv x 3
  float* A = VP + L * Pv * 3;       // L x L

  const long long row0 = (long long)b * L;
  for (int e = tid; e < L * 13; e += THREADS) {
    int l = e / 13, c = e % 13;
    if (c < 9) R[l * 9 + c] = rot[(row0 + l) * 9 + c];
    else if (c < 12) Tr[l * 3 + c - 9] = trans[(row0 + l) * 3 + c - 9];
    else Mk[l] = mask[row0 + l];
  }
  for (int e = tid; e < 3 * L * Ch; e += THREADS) {
    int which = e / (L * Ch), rem = e % (L * Ch), l = rem / Ch, c = rem % Ch;
    float v = proj[(row0 + l) * ld + which * HCh + h * Ch + c];
    (which == 0 ? Q : which == 1 ? K : V)[l * Ch + c] = v;
  }
  __syncthreads();
  const int np = 2 * Pq + Pv;
  for (int e = tid; e < L * np; e += THREADS) {
    int l = e / np, p = e % np;
    long long base;
    int HP, pp;
    float* dst;
    if (p < Pq) { base = 3LL * HCh; HP = HPq; pp = p; dst = QP + (l * Pq + pp) * 3; }
    else if (p < 2 * Pq) { base = 3LL * HCh + 3LL * HPq; HP = HPq; pp = p - Pq; dst = KP + (l * Pq + pp) * 3; }
    else { base = 3LL * HCh + 6LL * HPq; HP = HPv; pp = p - 2 * Pq; dst = VP + (l * Pv + pp) * 3; }
    int P = p < 2 * Pq ? Pq : Pv;
    const float* src = proj + (row0 + l) * ld + base + h * P + pp;
    float x = src[0], y = src[HP], z = src[2 * HP];
    const float* r = R + l * 9;
    const float* t = Tr + l * 3;
    dst[0] = r[0] * x + r[1] * y + r[2] * z + t[0];
    dst[1] = r[3] * x + r[4] * y + r[5] * z + t[1];
    dst[2] = r[6] * x + r[7] * y + r[8] * z + t[2];
  }
  __syncthreads();

  const float hw_raw = head_weights[h];
  const float softplus = hw_raw > 20.f ? hw_raw : log1pf(expf(hw_raw));
  const float hw = softplus * sqrtf(1.0f / (3.0f * (Pq * 9.0f / 2.0f))) * -0.5f;
  const float c_sc = sqrtf(1.0f / (3.0f * Ch));
  for (int e = tid; e < L * L; e += THREADS) {
    int i = e / L, j = e % L;
    float s = 0.f;
    for (int c = 0; c < Ch; ++c) s += Q[i * Ch + c] * K[j * Ch + c];
    float d2 = 0.f;
    for (int p = 0; p < Pq; ++p)
      for (int x = 0; x < 3; ++x) {
        float d = QP[(i * Pq + p) * 3 + x] - KP[(j * Pq + p) * 3 + x];
        d2 += d * d;
      }
    A[e] = s * c_sc + d2 * hw + 1e5f * (Mk[i] * Mk[j] - 1.0f);
  }
  __syncthreads();
  for (int i = tid; i < L; i += THREADS) {
    float m = -3.0e38f;
    for (int j = 0; j < L; ++j) m = fmaxf(m, A[i * L + j]);
    float sum = 0.f;
    for (int j = 0; j < L; ++j) { float p = expf(A[i * L + j] - m); A[i * L + j] = p; sum += p; }
    for (int j = 0; j < L; ++j) A[i * L + j] /= sum;
  }
  __syncthreads();

  for (int e = tid; e < L * Ch; e += THREADS) {
    int i = e / Ch, c = e % Ch;
    float o = 0.f;
    for (int j = 0; j < L; ++j) o += A[i * L + j] * V[j * Ch + c];
    feats[(row0 + i) * ldf + h * Ch + c] = __float2bfloat16(o);
  }
  for (int e = tid; e < L * Pv; e += THREADS) {
    int i = e / Pv, p = e % Pv;
    float g[3] = {0.f, 0.f, 0.f};
    for (int j = 0; j < L; ++j) {
      float a = A[i * L + j];
      for (int x = 0; x < 3; ++x) g[x] += a * VP[(j * Pv + p) * 3 + x];
    }
    const float* r = R + i * 9;
    const float* t = Tr + i * 3;
    float dx = g[0] - t[0], dy = g[1] - t[1], dz = g[2] - t[2];
    float lx = r[0] * dx + r[3] * dy + r[6] * dz;
    float ly = r[1] * dx + r[4] * dy + r[7] * dz;
    float lz = r[2] * dx + r[5] * dy + r[8] * dz;
    float nrm = sqrtf(lx * lx + ly * ly + lz * lz + 1e-8f);
    bf16* f = feats + (row0 + i) * ldf + HCh + h * Pv + p;
    f[0] = __float2bfloat16(lx);
    f[HPv] = __float2bfloat16(ly);
    f[2 * HPv] = __float2bfloat16(lz);
    f[3 * HPv] = __float2bfloat16(nrm);
  }
}

// ---- the tiled form ----
constexpr int QT = 64;  // queries per block, one per thread
constexpr int KT = 64;  // keys per shared-memory tile

template <int CH, int PQ, int PV>
__global__ void __launch_bounds__(QT) ipa_attention_tiled_kernel(
    const float* __restrict__ proj, long long ld, const float* __restrict__ rot,
    const float* __restrict__ trans, const float* __restrict__ mask,
    const float* __restrict__ head_weights, bf16* __restrict__ feats, long long ldf,
    int L, int H, int qtiles) {
  __shared__ float Ks[KT][CH], Vs[KT][CH], KP[KT][PQ * 3], VP[KT][PV * 3], Mk[KT];
  __shared__ float S[QT][KT + 1];  // this tile's logits, one row per query thread
  const int tid = threadIdx.x;
  const int qt = blockIdx.x % qtiles, h = (blockIdx.x / qtiles) % H;
  const long long b = blockIdx.x / qtiles / H;
  const long long row0 = b * L;
  const int HCh = H * CH, HPq = H * PQ, HPv = H * PV;
  const long long qpts = 3LL * HCh, kpts = qpts + 3LL * HPq, vpts = kpts + 3LL * HPq;

  const int i = qt * QT + tid;  // this thread's query
  const bool live = i < L;
  float q[CH], qp[PQ * 3], o[CH], op[PV * 3];
  float mq = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) o[c] = 0.f;
#pragma unroll
  for (int e = 0; e < PV * 3; ++e) op[e] = 0.f;
  if (live) {
    const float* src = proj + (row0 + i) * ld;
    const float* r = rot + (row0 + i) * 9;
    const float* t = trans + (row0 + i) * 3;
#pragma unroll
    for (int c = 0; c < CH; ++c) q[c] = src[h * CH + c];
#pragma unroll
    for (int p = 0; p < PQ; ++p) {
      const float x = src[qpts + h * PQ + p], y = src[qpts + HPq + h * PQ + p],
                  z = src[qpts + 2 * HPq + h * PQ + p];
      qp[p * 3 + 0] = r[0] * x + r[1] * y + r[2] * z + t[0];
      qp[p * 3 + 1] = r[3] * x + r[4] * y + r[5] * z + t[1];
      qp[p * 3 + 2] = r[6] * x + r[7] * y + r[8] * z + t[2];
    }
    mq = mask[row0 + i];
  } else {
#pragma unroll
    for (int c = 0; c < CH; ++c) q[c] = 0.f;
#pragma unroll
    for (int e = 0; e < PQ * 3; ++e) qp[e] = 0.f;
  }
  const float hw_raw = head_weights[h];
  const float softplus = hw_raw > 20.f ? hw_raw : log1pf(expf(hw_raw));
  const float hw = softplus * sqrtf(1.0f / (3.0f * (PQ * 9.0f / 2.0f))) * -0.5f;
  const float c_sc = sqrtf(1.0f / (3.0f * CH));
  float m = -3.0e38f, l = 0.f;  // running max and sum of this query's weights

  for (int k0 = 0; k0 < L; k0 += KT) {
    const int nk = min(KT, L - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < nk * CH; e += QT) {
      const int j = e / CH, c = e % CH;
      const float* src = proj + (row0 + k0 + j) * ld + h * CH + c;
      Ks[j][c] = src[HCh];
      Vs[j][c] = src[2 * HCh];
    }
    for (int e = tid; e < nk * (PQ + PV); e += QT) {
      const int j = e / (PQ + PV), p = e % (PQ + PV);
      const long long rj = row0 + k0 + j;
      const float* src = proj + rj * ld;
      const bool is_k = p < PQ;
      const int pp = is_k ? p : p - PQ, HP = is_k ? HPq : HPv, P = is_k ? PQ : PV;
      const long long base = (is_k ? kpts : vpts) + h * P + pp;
      const float x = src[base], y = src[base + HP], z = src[base + 2 * HP];
      const float* r = rot + rj * 9;
      const float* t = trans + rj * 3;
      float* dst = is_k ? &KP[j][pp * 3] : &VP[j][pp * 3];
      dst[0] = r[0] * x + r[1] * y + r[2] * z + t[0];
      dst[1] = r[3] * x + r[4] * y + r[5] * z + t[1];
      dst[2] = r[6] * x + r[7] * y + r[8] * z + t[2];
    }
    for (int j = tid; j < nk; j += QT) Mk[j] = mask[row0 + k0 + j];
    __syncthreads();
    if (!live) continue;
    float mt = -3.0e38f;
    for (int j = 0; j < nk; ++j) {
      float s = 0.f, d2 = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) s += q[c] * Ks[j][c];
#pragma unroll
      for (int e = 0; e < PQ * 3; ++e) {
        const float d = qp[e] - KP[j][e];
        d2 += d * d;
      }
      const float a = s * c_sc + d2 * hw + 1e5f * (mq * Mk[j] - 1.0f);
      S[tid][j] = a;
      mt = fmaxf(mt, a);
    }
    const float mn = fmaxf(m, mt), scale = expf(m - mn);
    l *= scale;
#pragma unroll
    for (int c = 0; c < CH; ++c) o[c] *= scale;
#pragma unroll
    for (int e = 0; e < PV * 3; ++e) op[e] *= scale;
    for (int j = 0; j < nk; ++j) {
      const float p = expf(S[tid][j] - mn);
      l += p;
#pragma unroll
      for (int c = 0; c < CH; ++c) o[c] += p * Vs[j][c];
#pragma unroll
      for (int e = 0; e < PV * 3; ++e) op[e] += p * VP[j][e];
    }
    m = mn;
  }
  if (!live) return;
  const float inv = 1.f / l;
  bf16* f = feats + (row0 + i) * ldf;
#pragma unroll
  for (int c = 0; c < CH; ++c) f[h * CH + c] = __float2bfloat16(o[c] * inv);
  const float* r = rot + (row0 + i) * 9;
  const float* t = trans + (row0 + i) * 3;
#pragma unroll
  for (int p = 0; p < PV; ++p) {
    const float dx = op[p * 3] * inv - t[0], dy = op[p * 3 + 1] * inv - t[1],
                dz = op[p * 3 + 2] * inv - t[2];
    const float lx = r[0] * dx + r[3] * dy + r[6] * dz;
    const float ly = r[1] * dx + r[4] * dy + r[7] * dz;
    const float lz = r[2] * dx + r[5] * dy + r[8] * dz;
    bf16* fp = f + HCh + h * PV + p;
    fp[0] = __float2bfloat16(lx);
    fp[HPv] = __float2bfloat16(ly);
    fp[2 * HPv] = __float2bfloat16(lz);
    fp[3 * HPv] = __float2bfloat16(sqrtf(lx * lx + ly * ly + lz * lz + 1e-8f));
  }
}

// the tiled form at any widths: the same steps and sums as the template,
// with the query's state in shared memory ([value][thread], conflict-free)
__host__ __device__ inline size_t tiled_any_floats(int Ch, int Pq, int Pv) {
  const size_t keys = (size_t)KT * (2 * Ch + 3 * Pq + 3 * Pv + 1);
  const size_t logits = (size_t)QT * (KT + 1);
  const size_t state = (size_t)QT * (2 * Ch + 3 * Pq + 3 * Pv);
  return keys + logits + state;
}

__global__ void __launch_bounds__(QT) ipa_attention_tiled_any_kernel(
    const float* __restrict__ proj, long long ld, const float* __restrict__ rot,
    const float* __restrict__ trans, const float* __restrict__ mask,
    const float* __restrict__ head_weights, bf16* __restrict__ feats, long long ldf,
    int L, int H, int CH, int PQ, int PV, int qtiles) {
  extern __shared__ float smt[];
  const int P3Q = 3 * PQ, P3V = 3 * PV;
  float* Ks = smt;                  // [KT][CH]
  float* Vs = Ks + KT * CH;         // [KT][CH]
  float* KP = Vs + KT * CH;         // [KT][3 PQ]
  float* VP = KP + KT * P3Q;        // [KT][3 PV]
  float* Mk = VP + KT * P3V;        // [KT]
  float* S = Mk + KT;               // [QT][KT + 1]
  float* q = S + QT * (KT + 1);     // [CH][QT]
  float* qp = q + CH * QT;          // [3 PQ][QT]
  float* o = qp + P3Q * QT;         // [CH][QT]
  float* op = o + CH * QT;          // [3 PV][QT]
  const int tid = threadIdx.x;
  const int qt = blockIdx.x % qtiles, h = (blockIdx.x / qtiles) % H;
  const long long b = blockIdx.x / qtiles / H;
  const long long row0 = b * L;
  const int HCh = H * CH, HPq = H * PQ, HPv = H * PV;
  const long long qpts = 3LL * HCh, kpts = qpts + 3LL * HPq, vpts = kpts + 3LL * HPq;

  const int i = qt * QT + tid;  // this thread's query
  const bool live = i < L;
  float mq = 0.f;
  for (int c = 0; c < CH; ++c) o[c * QT + tid] = 0.f;
  for (int e = 0; e < P3V; ++e) op[e * QT + tid] = 0.f;
  if (live) {
    const float* src = proj + (row0 + i) * ld;
    const float* r = rot + (row0 + i) * 9;
    const float* t = trans + (row0 + i) * 3;
    for (int c = 0; c < CH; ++c) q[c * QT + tid] = src[h * CH + c];
    for (int p = 0; p < PQ; ++p) {
      const float x = src[qpts + h * PQ + p], y = src[qpts + HPq + h * PQ + p],
                  z = src[qpts + 2 * HPq + h * PQ + p];
      qp[(p * 3 + 0) * QT + tid] = r[0] * x + r[1] * y + r[2] * z + t[0];
      qp[(p * 3 + 1) * QT + tid] = r[3] * x + r[4] * y + r[5] * z + t[1];
      qp[(p * 3 + 2) * QT + tid] = r[6] * x + r[7] * y + r[8] * z + t[2];
    }
    mq = mask[row0 + i];
  } else {
    for (int c = 0; c < CH; ++c) q[c * QT + tid] = 0.f;
    for (int e = 0; e < P3Q; ++e) qp[e * QT + tid] = 0.f;
  }
  const float hw_raw = head_weights[h];
  const float softplus = hw_raw > 20.f ? hw_raw : log1pf(expf(hw_raw));
  const float hw = softplus * sqrtf(1.0f / (3.0f * (PQ * 9.0f / 2.0f))) * -0.5f;
  const float c_sc = sqrtf(1.0f / (3.0f * CH));
  float m = -3.0e38f, l = 0.f;  // running max and sum of this query's weights

  for (int k0 = 0; k0 < L; k0 += KT) {
    const int nk = min(KT, L - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < nk * CH; e += QT) {
      const int j = e / CH, c = e % CH;
      const float* src = proj + (row0 + k0 + j) * ld + h * CH + c;
      Ks[j * CH + c] = src[HCh];
      Vs[j * CH + c] = src[2 * HCh];
    }
    for (int e = tid; e < nk * (PQ + PV); e += QT) {
      const int j = e / (PQ + PV), p = e % (PQ + PV);
      const long long rj = row0 + k0 + j;
      const float* src = proj + rj * ld;
      const bool is_k = p < PQ;
      const int pp = is_k ? p : p - PQ, HP = is_k ? HPq : HPv, P = is_k ? PQ : PV;
      const long long base = (is_k ? kpts : vpts) + h * P + pp;
      const float x = src[base], y = src[base + HP], z = src[base + 2 * HP];
      const float* r = rot + rj * 9;
      const float* t = trans + rj * 3;
      float* dst = is_k ? &KP[j * P3Q + pp * 3] : &VP[j * P3V + pp * 3];
      dst[0] = r[0] * x + r[1] * y + r[2] * z + t[0];
      dst[1] = r[3] * x + r[4] * y + r[5] * z + t[1];
      dst[2] = r[6] * x + r[7] * y + r[8] * z + t[2];
    }
    for (int j = tid; j < nk; j += QT) Mk[j] = mask[row0 + k0 + j];
    __syncthreads();
    if (!live) continue;
    float mt = -3.0e38f;
    for (int j = 0; j < nk; ++j) {
      float s = 0.f, d2 = 0.f;
      for (int c = 0; c < CH; ++c) s += q[c * QT + tid] * Ks[j * CH + c];
      for (int e = 0; e < P3Q; ++e) {
        const float d = qp[e * QT + tid] - KP[j * P3Q + e];
        d2 += d * d;
      }
      const float a = s * c_sc + d2 * hw + 1e5f * (mq * Mk[j] - 1.0f);
      S[tid * (KT + 1) + j] = a;
      mt = fmaxf(mt, a);
    }
    const float mn = fmaxf(m, mt), scale = expf(m - mn);
    l *= scale;
    for (int c = 0; c < CH; ++c) o[c * QT + tid] *= scale;
    for (int e = 0; e < P3V; ++e) op[e * QT + tid] *= scale;
    for (int j = 0; j < nk; ++j) {
      const float p = expf(S[tid * (KT + 1) + j] - mn);
      l += p;
      for (int c = 0; c < CH; ++c) o[c * QT + tid] += p * Vs[j * CH + c];
      for (int e = 0; e < P3V; ++e) op[e * QT + tid] += p * VP[j * P3V + e];
    }
    m = mn;
  }
  if (!live) return;
  const float inv = 1.f / l;
  bf16* f = feats + (row0 + i) * ldf;
  for (int c = 0; c < CH; ++c) f[h * CH + c] = __float2bfloat16(o[c * QT + tid] * inv);
  const float* r = rot + (row0 + i) * 9;
  const float* t = trans + (row0 + i) * 3;
  for (int p = 0; p < PV; ++p) {
    const float dx = op[(p * 3) * QT + tid] * inv - t[0],
                dy = op[(p * 3 + 1) * QT + tid] * inv - t[1],
                dz = op[(p * 3 + 2) * QT + tid] * inv - t[2];
    const float lx = r[0] * dx + r[3] * dy + r[6] * dz;
    const float ly = r[1] * dx + r[4] * dy + r[7] * dz;
    const float lz = r[2] * dx + r[5] * dy + r[8] * dz;
    bf16* fp = f + HCh + h * PV + p;
    fp[0] = __float2bfloat16(lx);
    fp[HPv] = __float2bfloat16(ly);
    fp[2 * HPv] = __float2bfloat16(lz);
    fp[3 * HPv] = __float2bfloat16(sqrtf(lx * lx + ly * ly + lz * lz + 1e-8f));
  }
}

}  // namespace

// tiled != 0: the key-tiled form (registers at Ch = 32, Pq = Pv = 8, shared
// memory at other widths); else the resident form, whose L x L logits must
// fit one block's shared memory
extern "C" int ipa_attention(const void* proj, long long ld, const void* rot, const void* trans,
                             const void* mask, const void* head_weights, void* feats,
                             long long ldf, int B, int L, int H, int Ch, int Pq, int Pv,
                             int tiled, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled) {
    const int qtiles = (L + QT - 1) / QT;
    const long long blocks = (long long)B * H * qtiles;
    if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (Ch == 32 && Pq == 8 && Pv == 8) {
      ipa_attention_tiled_kernel<32, 8, 8><<<(unsigned)blocks, QT, 0, s>>>(
          static_cast<const float*>(proj), ld, static_cast<const float*>(rot),
          static_cast<const float*>(trans), static_cast<const float*>(mask),
          static_cast<const float*>(head_weights), static_cast<bf16*>(feats), ldf, L, H, qtiles);
      return (int)cudaGetLastError();
    }
    const size_t bytes = tiled_any_floats(Ch, Pq, Pv) * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(ipa_attention_tiled_any_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    ipa_attention_tiled_any_kernel<<<(unsigned)blocks, QT, bytes, s>>>(
        static_cast<const float*>(proj), ld, static_cast<const float*>(rot),
        static_cast<const float*>(trans), static_cast<const float*>(mask),
        static_cast<const float*>(head_weights), static_cast<bf16*>(feats), ldf, L, H, Ch, Pq,
        Pv, qtiles);
    return (int)cudaGetLastError();
  }
  size_t smem = sizeof(float) * ((size_t)L * 13 + 3 * L * Ch + 3 * L * (2 * Pq + Pv) + L * L);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ipa_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ipa_attention_kernel<<<(unsigned)B * H, THREADS, smem, s>>>(
      static_cast<const float*>(proj), ld, static_cast<const float*>(rot),
      static_cast<const float*>(trans), static_cast<const float*>(mask),
      static_cast<const float*>(head_weights), static_cast<bf16*>(feats), ldf, B, L, H, Ch,
      Pq, Pv);
  return (int)cudaGetLastError();
}
