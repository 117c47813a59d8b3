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
// Three forms, chosen by the wrapper (ops/ipa_attention.py::_form):
//   - streaming (L <= 16 at the model's widths, Ch = 32, Pq = Pv = 8, H a
//     multiple of 4: the 4AA peptides at L = 4, the encoder and the
//     modular layer's interleave_ipa over the t grid). It replaces
//     the resident form there, which gave a block of 64 threads one
//     (element, head): at L = 4 that is
//     25,600 blocks of 16 logits each (48 of the 64 threads idle), the point
//     coordinates read one float at a time at a stride of H*P, each head
//     re-reading the element's frames and lifting its points, the softmax on
//     4 threads behind 5 barriers, the features written one bf16 at a time.
//     The call moves ~82 MB (68.8 MB of f32 proj in, 13 MB of bf16 features
//     out at B = 6,400, L = 4) against ~0.1 GFLOP: only bytes bound it. So:
//       * a unit is SPB whole elements x all H heads (ops/ipa_attention.py::
//         ipa_plan: four threads per query); an element's proj rows are
//         one contiguous span (4 x 2,688 B at L = 4), its frames and mask
//         three more;
//       * a persistent grid (resident blocks x SMs) walks the units, the
//         next unit's spans in flight by 16-byte cp.async while this one is
//         computed (two raw buffers); the copy puts 16 pad bytes after every
//         128, so a head's 32 scalars (and 8 points of a coordinate) start
//         on their own banks and the heads of a warp read without conflict;
//       * each point is lifted once per (element, point) in place (not once
//         per head), reading the frames staged once per element;
//       * four threads per (element, query, head), its q and lifted q points
//         in each one's registers: thread k forms the logits of keys k,
//         k + 4, ..., the four exchange them by shuffles (the L logits in
//         registers, no L x L buffer), each forms the softmax, and thread k
//         sums a quarter of the values (8 scalars, 2 points); 256 threads
//         and two blocks per SM, so that enough warps hide the latency of
//         the shared-memory reads (one thread per query, 64 a block, left
//         each SM four warps and latency-bound);
//       * the features staged in shared memory and written as 16-byte
//         vectors (an element's are 4 x 512 B, contiguous).
//     Every output's operations and order are the resident form's (the dot
//     over c, then the squared distance over (p, x), expf(a - m), the
//     division by the sum, the value sums in key order, the same lift and
//     inverse map), so the features are its bits. A unit whose proj span
//     does not start on 16 bytes is copied 4 bytes at a time (the general
//     path; -DMDGEN_IPA_GENERAL takes every unit there, to time it).
//   - resident (16 < L <= 64, and L <= 16 at other widths or over few
//     elements): one block of 64 threads per (element, head) stages its L
//     residues' scalars, lifted points and
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
#include <stdint.h>

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

// ---- the streaming form (L <= SHORT_L at Ch = 32, Pq = Pv = 8, H % 4 == 0);
// the design note is at the top ----
constexpr int SHORT_L = 16;         // ops/ipa_attention.py SHORT_L
constexpr int SHORT_THREADS = 256;  // ops/ipa_attention.py SHORT_THREADS
constexpr int KS = 4;               // threads per (element, query, head): QUERY_THREADS
constexpr int SCH = 32, SPQ = 8, SPV = 8;  // the widths it takes (REGISTER_WIDTHS)
// whether the L = H = 4 instance runs at L = H = 4: a -DMDGEN_GENERIC_SHORT
// build runs the generic instance there, to time it
#ifdef MDGEN_GENERIC_SHORT
constexpr bool SHORT_L4H4 = false;
#else
constexpr bool SHORT_L4H4 = true;
#endif
static_assert(SCH / KS == 8 && SPV / KS == 2, "a thread's share: 8 scalars, 2 points");

// a proj float's place in a raw buffer: 4 pad floats after every 32, so that
// 16-byte rows 128 bytes apart fall on distinct banks
__host__ __device__ __forceinline__ long long padf(long long f) { return f + (f >> 5) * 4; }

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// one unit's shared memory (bytes; ops/ipa_attention.py::ipa_bytes mirrors
// it): two raw buffers, each the unit's proj rows (SPB x L rows of RW =
// W + W / 8 floats, placed by padf) and its rot (9), trans (3) and mask (1)
// floats per row; then the unit's features, SPB x L rows of F bf16
struct ShortLayout {
  int rw;
  size_t rot, trans, mask, raw, feats, total;
  __host__ __device__ ShortLayout(int spb, int L, int W, int F) {
    rw = W + W / 8;
    const size_t rows = (size_t)spb * L;
    size_t o = rows * rw * 4;
    rot = o; o += align16(rows * 9 * 4);
    trans = o; o += align16(rows * 3 * 4);
    mask = o; o += align16(rows * 4);
    raw = o;
    feats = 2 * raw;
    total = feats + rows * F * 2;
  }
};

struct ShortArgs {
  const float *proj, *rot, *trans, *mask, *hw;
  bf16* feats;
  long long B, units;  // elements; units of SPB elements
  int L, H, W, F, spb;
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// the proj rows go in as 16-byte chunks where proj starts on 16 bytes (a
// row is 168 H floats, so every row does), else 4 bytes at a time (the
// general path; a -DMDGEN_IPA_GENERAL build takes it for every unit)
__device__ __forceinline__ bool vector_rows(const ShortArgs& a) {
#ifdef MDGEN_IPA_GENERAL
  return false;
#else
  return (reinterpret_cast<unsigned long long>(a.proj) & 15) == 0;
#endif
}

// unit u's spans into a raw buffer, the threads on consecutive chunks
__device__ __forceinline__ void load_unit(const ShortArgs& a, long long u, unsigned char* buf,
                                          const ShortLayout& lay) {
  const long long e0 = u * a.spb, r0 = e0 * a.L;
  const int rows = (int)min((long long)a.spb, a.B - e0) * a.L;
  float* P = reinterpret_cast<float*>(buf);
  const float* src = a.proj + r0 * a.W;
  const int nf = rows * a.W;
  if (vector_rows(a)) {
    for (int c = threadIdx.x; c < nf / 4; c += SHORT_THREADS) cp16(P + padf(4LL * c), src + 4 * c);
  } else {
    for (int f = threadIdx.x; f < nf; f += SHORT_THREADS) cp4(P + padf(f), src + f);
  }
  float* R = reinterpret_cast<float*>(buf + lay.rot);
  float* Tr = reinterpret_cast<float*>(buf + lay.trans);
  float* Mk = reinterpret_cast<float*>(buf + lay.mask);
  for (int f = threadIdx.x; f < rows * 9; f += SHORT_THREADS) cp4(R + f, a.rot + r0 * 9 + f);
  for (int f = threadIdx.x; f < rows * 3; f += SHORT_THREADS) cp4(Tr + f, a.trans + r0 * 3 + f);
  for (int f = threadIdx.x; f < rows; f += SHORT_THREADS) cp4(Mk + f, a.mask + r0 + f);
}

// 8 consecutive floats at p (16-byte aligned) into v
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 x = reinterpret_cast<const float4*>(p)[0], y = reinterpret_cast<const float4*>(p)[1];
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}

// 8 floats as bf16 into one 16-byte store
__device__ __forceinline__ void store8(bf16* dst, const float* v) {
  uint4 w;
  uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    wp[e] = *reinterpret_cast<const uint32_t*>(&p);
  }
  *reinterpret_cast<uint4*>(dst) = w;
}

// a landed unit: lift its points in place, attend, stage its features,
// write them out
// LC, HC: L and H known at compile time (the 4AA peptides' L = H = 4: the
// loops over keys unroll, the divisions by L and H are shifts), 0: read
// from the arguments; the same arithmetic either way
template <int LC, int HC>
__device__ __forceinline__ void short_unit_body(const ShortArgs& a, long long u, unsigned char* buf,
                                                bf16* Fs, const ShortLayout& lay) {
  const long long e0 = u * a.spb;
  const int L = LC > 0 ? LC : a.L, H = HC > 0 ? HC : a.H;
  const int rows = (int)min((long long)a.spb, a.B - e0) * L;
  const int HCh = H * SCH, HPq = H * SPQ, HPv = H * SPV;
  const int qpts = 3 * HCh, kpts = qpts + 3 * HPq, vpts = kpts + 3 * HPq;
  float* P = reinterpret_cast<float*>(buf);
  const float* R = reinterpret_cast<const float*>(buf + lay.rot);
  const float* Tr = reinterpret_cast<const float*>(buf + lay.trans);
  const float* Mk = reinterpret_cast<const float*>(buf + lay.mask);

  // every point of the unit lifted once, in place: a thread per (row, head,
  // point), the points of a head on neighbouring lanes
  constexpr int NP = 2 * SPQ + SPV;
  for (int t = threadIdx.x; t < rows * H * NP; t += SHORT_THREADS) {
    const int pi = t % NP, r = t / NP, h = r % H, row = r / H;
    const int blk = pi < SPQ ? 0 : pi < 2 * SPQ ? 1 : 2;
    const int p = pi - blk * SPQ, HP = blk < 2 ? HPq : HPv, Pn = blk < 2 ? SPQ : SPV;
    const int base = (blk == 0 ? qpts : blk == 1 ? kpts : vpts) + h * Pn + p;
    float* rowp = P + (size_t)row * lay.rw;
    float* px = rowp + padf(base);
    float* py = rowp + padf(base + HP);
    float* pz = rowp + padf(base + 2 * HP);
    const float x = *px, y = *py, z = *pz;
    const float* rr = R + row * 9;
    const float* t3 = Tr + row * 3;
    *px = rr[0] * x + rr[1] * y + rr[2] * z + t3[0];
    *py = rr[3] * x + rr[4] * y + rr[5] * z + t3[1];
    *pz = rr[6] * x + rr[7] * y + rr[8] * z + t3[2];
  }
  __syncthreads();

  // KS = 4 threads per (element, query, head), neighbouring lanes (then
  // the heads of a query, then the queries of an element): thread k forms
  // the logits of keys k, k + 4, ... (the keys' reads broadcast to the
  // queries), the four exchange them by shuffles, each forms the softmax,
  // and thread k sums scalars 8k .. 8k + 7 and points 2k, 2k + 1
  const int lane = threadIdx.x & 31;
  const unsigned gmask = 0xfu << (lane & ~(KS - 1));
  for (int t = threadIdx.x; t < rows * H * KS; t += SHORT_THREADS) {
    const int k = t % KS, h = (t / KS) % H, row = t / (KS * H), e = row / L;
    const int src0 = lane & ~(KS - 1);
    const float* qrow = P + (size_t)row * lay.rw;
    float q[SCH], qp[SPQ * 3];
#pragma unroll
    for (int c = 0; c < SCH; c += 8) load8(qrow + padf(h * SCH + c), q + c);
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      float v[SPQ];
      load8(qrow + padf(qpts + x * HPq + h * SPQ), v);
#pragma unroll
      for (int p = 0; p < SPQ; ++p) qp[p * 3 + x] = v[p];
    }
    const float mq = Mk[row];
    const float hw_raw = __ldg(a.hw + h);
    const float softplus = hw_raw > 20.f ? hw_raw : log1pf(expf(hw_raw));
    const float hw = softplus * sqrtf(1.0f / (3.0f * (SPQ * 9.0f / 2.0f))) * -0.5f;
    const float c_sc = sqrtf(1.0f / (3.0f * SCH));

    // this thread's logits (keys k, k + KS, ...), each in the resident
    // form's order: the dot over c, the squared distance over (p, x)
    float mine[SHORT_L / KS];
#pragma unroll
    for (int jj = 0; jj < SHORT_L / KS; ++jj) {
      const int j = jj * KS + k;
      mine[jj] = 0.f;
      if (j < L) {
        const float* krow = P + (size_t)(e * L + j) * lay.rw;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < SCH; c += 8) {
          float kk[8];
          load8(krow + padf(HCh + h * SCH + c), kk);
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) s += q[c + cc] * kk[cc];
        }
        float kp[SPQ * 3];
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          float v[SPQ];
          load8(krow + padf(kpts + x * HPq + h * SPQ), v);
#pragma unroll
          for (int p = 0; p < SPQ; ++p) kp[p * 3 + x] = v[p];
        }
        float d2 = 0.f;
#pragma unroll
        for (int e2 = 0; e2 < SPQ * 3; ++e2) {
          const float d = qp[e2] - kp[e2];
          d2 += d * d;
        }
        mine[jj] = s * c_sc + d2 * hw + 1e5f * (mq * Mk[e * L + j] - 1.0f);
      }
    }
    // every logit of the row in every thread of the group; the softmax
    float lg[SHORT_L];
    float m = -3.0e38f;
#pragma unroll
    for (int j = 0; j < SHORT_L; ++j) {
      if (j < L) {
        lg[j] = __shfl_sync(gmask, mine[j / KS], src0 + j % KS);
        m = fmaxf(m, lg[j]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < SHORT_L; ++j) {
      if (j < L) {
        const float pj = expf(lg[j] - m);
        lg[j] = pj;
        sum += pj;
      }
    }
#pragma unroll
    for (int j = 0; j < SHORT_L; ++j)
      if (j < L) lg[j] /= sum;

    // this thread's value sums, in key order: scalars 8k .. 8k + 7, points
    // 2k and 2k + 1
    constexpr int OC = SCH / KS, OP = SPV / KS;
    float o[OC], g[OP * 3];
#pragma unroll
    for (int c = 0; c < OC; ++c) o[c] = 0.f;
#pragma unroll
    for (int e2 = 0; e2 < OP * 3; ++e2) g[e2] = 0.f;
#pragma unroll
    for (int j = 0; j < SHORT_L; ++j) {
      if (j < L) {
        const float aj = lg[j];
        const float* vrow = P + (size_t)(e * L + j) * lay.rw;
        float v[OC];
        load8(vrow + padf(2 * HCh + h * SCH + k * OC), v);
#pragma unroll
        for (int c = 0; c < OC; ++c) o[c] += aj * v[c];
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          const float2 w = *reinterpret_cast<const float2*>(vrow + padf(vpts + x * HPv + h * SPV + k * OP));
          g[x] += aj * w.x;
          g[3 + x] += aj * w.y;
        }
      }
    }

    // features: scalars, then the inverse frame map of the points and
    // their norms, staged in shared memory
    bf16* frow = Fs + (size_t)row * a.F;
    store8(frow + h * SCH + k * OC, o);
    const float* rr = R + row * 9;
    const float* t3 = Tr + row * 3;
    float lx[OP], ly[OP], lz[OP], nrm[OP];
#pragma unroll
    for (int p = 0; p < OP; ++p) {
      float dx = g[p * 3] - t3[0], dy = g[p * 3 + 1] - t3[1], dz = g[p * 3 + 2] - t3[2];
      lx[p] = rr[0] * dx + rr[3] * dy + rr[6] * dz;
      ly[p] = rr[1] * dx + rr[4] * dy + rr[7] * dz;
      lz[p] = rr[2] * dx + rr[5] * dy + rr[8] * dz;
      nrm[p] = sqrtf(lx[p] * lx[p] + ly[p] * ly[p] + lz[p] * lz[p] + 1e-8f);
    }
    const int po = h * SPV + k * OP;
    *reinterpret_cast<__nv_bfloat162*>(frow + HCh + po) = __floats2bfloat162_rn(lx[0], lx[1]);
    *reinterpret_cast<__nv_bfloat162*>(frow + HCh + HPv + po) = __floats2bfloat162_rn(ly[0], ly[1]);
    *reinterpret_cast<__nv_bfloat162*>(frow + HCh + 2 * HPv + po) = __floats2bfloat162_rn(lz[0], lz[1]);
    *reinterpret_cast<__nv_bfloat162*>(frow + HCh + 3 * HPv + po) = __floats2bfloat162_rn(nrm[0], nrm[1]);
  }
  __syncthreads();

  // the unit's features are one contiguous span of the output
  uint4* dst = reinterpret_cast<uint4*>(a.feats + e0 * L * a.F);
  const uint4* fs = reinterpret_cast<const uint4*>(Fs);
  for (int c = threadIdx.x; c < rows * a.F / 8; c += SHORT_THREADS) dst[c] = fs[c];
}

// the persistent walk: units u0, u0 + grid, ..., the next unit's spans in
// flight (the other raw buffer) while this one is computed
template <int LC, int HC>
__global__ void __launch_bounds__(SHORT_THREADS) ipa_attention_short_kernel(const ShortArgs a) {
  extern __shared__ __align__(16) unsigned char sms[];
  const ShortLayout lay(a.spb, a.L, a.W, a.F);
  long long u = blockIdx.x;
  if (u >= a.units) return;
  load_unit(a, u, sms, lay);
  cp_commit();
  for (int k = 0; u < a.units; u += gridDim.x, k ^= 1) {
    cp_wait_all();
    __syncthreads();  // unit u has landed; every thread is done with the last one
    if (u + gridDim.x < a.units) load_unit(a, u + gridDim.x, sms + (k ^ 1) * lay.raw, lay);
    cp_commit();
    short_unit_body<LC, HC>(a, u, sms + k * lay.raw, reinterpret_cast<bf16*>(sms + lay.feats), lay);
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

namespace {

// the launch resources of kernel `kern` at `threads` threads and `smem`
// bytes: info[0] registers per thread, [1] local (spill) bytes per thread,
// [2] dynamic shared memory per block, [3] resident blocks per SM
template <typename K>
int kernel_resources(K kern, int threads, size_t smem, long long* info) {
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = fa.numRegs;
  info[1] = (long long)fa.localSizeBytes;
  info[2] = (long long)smem;
  info[3] = per_sm;
  return 0;
}

bool short_shape(int L, int H, int Ch, int Pq, int Pv, int spb) {
  return L >= 1 && L <= SHORT_L && Ch == SCH && Pq == SPQ && Pv == SPV && H >= 4 && H % 4 == 0 &&
         spb >= 1;
}

}  // namespace

// the resources of the kernel that a call at (L, H) with the model's
// widths runs: the streaming form at plan spb > 0, else the key-tiled form
// (the resident form's are not asked for)
extern "C" int ipa_attention_resources(int L, int H, int spb, long long* info) {
  const int W = H * (3 * SCH + 6 * SPQ + 3 * SPV), F = H * (SCH + 4 * SPV);
  if (spb > 0) {
    if (!short_shape(L, H, SCH, SPQ, SPV, spb)) return (int)cudaErrorInvalidValue;
    return kernel_resources(L == 4 && H == 4 && SHORT_L4H4 ? ipa_attention_short_kernel<4, 4>
                                                          : ipa_attention_short_kernel<0, 0>,
                            SHORT_THREADS,
                            ShortLayout(spb, L, W, F).total, info);
  }
  if (L <= 64) return (int)cudaErrorInvalidValue;
  return kernel_resources(ipa_attention_tiled_kernel<32, 8, 8>, QT, 0, info);
}

// tiled != 0: the key-tiled form (registers at Ch = 32, Pq = Pv = 8, shared
// memory at other widths); spb > 0 (tiled 0): the streaming form, units of
// spb elements over a persistent grid of `grid` blocks
// (ops/ipa_attention.py::ipa_plan; trailing, so an older entry point is
// called the same way); else the resident form, whose L x L logits must
// fit one block's shared memory
extern "C" int ipa_attention(const void* proj, long long ld, const void* rot, const void* trans,
                             const void* mask, const void* head_weights, void* feats,
                             long long ldf, int B, int L, int H, int Ch, int Pq, int Pv,
                             int tiled, void* stream, int spb, int grid) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (spb > 0) {
    ShortArgs a;
    a.proj = static_cast<const float*>(proj);
    a.rot = static_cast<const float*>(rot);
    a.trans = static_cast<const float*>(trans);
    a.mask = static_cast<const float*>(mask);
    a.hw = static_cast<const float*>(head_weights);
    a.feats = static_cast<bf16*>(feats);
    a.B = B; a.L = L; a.H = H; a.spb = spb;
    a.W = H * (3 * SCH + 6 * SPQ + 3 * SPV);
    a.F = H * (SCH + 4 * SPV);
    a.units = ((long long)B + spb - 1) / spb;
    if (tiled || !short_shape(L, H, Ch, Pq, Pv, spb) || ld != a.W || ldf != a.F || B <= 0 ||
        grid <= 0 || (reinterpret_cast<unsigned long long>(feats) & 15))
      return (int)cudaErrorInvalidValue;
    const size_t smem = ShortLayout(spb, L, a.W, a.F).total;
    auto kern = L == 4 && H == 4 && SHORT_L4H4 ? ipa_attention_short_kernel<4, 4>
                                               : ipa_attention_short_kernel<0, 0>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = grid < a.units ? grid : a.units;
    kern<<<(unsigned)blocks, SHORT_THREADS, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
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
