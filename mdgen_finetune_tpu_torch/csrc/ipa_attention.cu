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
// point math is f32 (3xTF32 products in the tensor-core form). Output
// features bf16, ordered scalars | x | y | z | norms.
//
// Four forms, chosen by the wrapper (ops/ipa_attention.py::_form):
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
//   - resident (L <= 64 at widths the tensor-core form does not take, and
//     L <= 16 at its widths off the streaming route): one block of 64 threads
//     per (element, head) stages its L
//     residues' scalars, lifted points and
//     frames in shared memory, forms the L x L logits there, and writes the
//     features once. At L = 4 each (b, head) reads ~2 KB and does a few
//     thousand FLOP; the call is memory-bound (proj in, features out,
//     ~3.3 KB per row at the flagship widths). Its shared memory holds the
//     L x L logits, so it fits only up to L ~ 167 at Ch = 32, Pq = Pv = 8.
//   - tensor-core (L >= 17 at (Ch, Pq, Pv) = (32, 8, 8) or (16, 4, 6):
//     ATLAS's encoder over the t grid at L = 256, its training and dopri5 at
//     B = 1; from L = 17 it measured faster than the resident form).
//     It replaces a key-tiled form that gave a block of 64 threads one
//     (element, head, 64-query tile), a thread per query: every logit a chain
//     of 32 scalar products and 24 squared differences in f32, every value sum
//     56 more FMAs a key, the keys staged by 4-byte loads and lifted again in
//     each of the 4 query tiles, the logits through a 64 x 65 shared buffer,
//     2 warps a block: bound by the f32 pipe (~0.1 ms at (100, 256)) and
//     slower than SDPA on augmented heads. Here the logits are one product of
//     augmented rows, Q_aug = [q | lifted q_pts] and K_aug = [c k | w lifted
//     k_pts] (c = sqrt(1 / (3 Ch)), w = softplus(hw) sqrt(1 / (3 Pq 9 / 2))),
//     plus a per-key bias -w/2 |k_pts|^2 and the mask term 1e5 m_q (m_k - 1)
//     (the per-query terms -w/2 |q_pts|^2 and -1e5 (1 - m_q) cancel in the
//     softmax; a query with m_q = 0 so attends over every key, as in the
//     reference); the values one product of p with [v | lifted v_pts]:
//       * a block is `warps` warps of 16 queries of one (element, head)
//         (ops/ipa_attention.py::tc_plan: the fewest blocks of at most 8
//         warps, 2 per (element, head) at L = 256), each warp's queries held
//         as mma A fragments in registers;
//       * the key side of the (element, head) streams through a ring of
//         STAGES stages by 16-byte cp.async (its proj segments, frames and
//         mask), the next 64 keys in flight while these are lifted (once per key and
//         head in the block, a thread per point) and multiplied; rows padded
//         to 4 mod 8 floats so that every fragment load is conflict-free;
//       * products on the tensor cores, mma.sync m16n8k8 TF32 with f32
//         accumulators: the scalar columns in single TF32 (c q and p rounded,
//         k and v fed as they landed: the tensor cores read their top 19
//         bits), the point columns in 3xTF32 (high and low TF32 parts, the
//         low x low term dropped):
//         the expanded distance at a crop's extent (+-40 A) loses ~0.3 of a
//         logit in single TF32, and the value points ~0.02 A, half the
//         features' tolerance (tests/test_torch_ipa_long.py emulates both);
//       * the natural-exp online softmax keeps each row's running max and
//         sum in registers (no logits buffer); P's accumulator fragments are
//         the value product's A fragments, the keys of a k-step read in the
//         order 0, 2, 4, 6, 1, 3, 5, 7;
//       * the epilogue (the inverse frame map, the norms) runs on the value
//         sums in registers; each warp stages its features in the ring and
//         writes them as 16-byte vectors.
//     The products are ~6.7 GFLOP at (100, 256) (3xTF32 ~0.04 ms at the TF32
//     peak), the bytes ~82 MB (0.025 ms): the products and the exponentials
//     bound it. Widths other than those two keep the key-tiled form with its
//     state in shared memory (ipa_attention_tiled_any_kernel).

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
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

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

// ---- the key-tiled form at any widths: constants ----
constexpr int QT = 64;  // queries per block, one per thread
constexpr int KT = 64;  // keys per shared-memory tile

// ---- the tensor-core form (the design note is at the top) ----
namespace tc {

constexpr int KT = 64;          // keys per ring stage
constexpr int STAGES = 2;       // ring stages: STAGES - 1 tiles in flight
constexpr int SUB = 32;         // keys per online-softmax step: four n-tiles of 8 keys
#ifdef MDGEN_TC_WARPS16
constexpr int MAX_WARPS = 16;   // a measuring build: an (element, head) in one block (form_clock)
#else
constexpr int MAX_WARPS = 8;    // ops/ipa_attention.py TC_MAX_WARPS: 16 queries a warp
#endif
constexpr float NEG = -1e30f;   // the bias of a key past L: no weight

// The layout of the widths (Ch, Pq, Pv) = (CH, PQ, PV) (ops/ipa_attention.py::tc_bytes
// mirrors SMEM). The augmented q / k rows are [q | x | y | z] with each coordinate's PQ
// points padded to PQP (a multiple of 4, so that a thread's fragment columns, tig and
// tig + 4 of every k-step, hold whole points), the whole padded to k-steps of 8; the
// augmented v rows [v | x | y | z] with each coordinate's PV points padded to PVP (a
// multiple of 8, so that an n-tile's columns 2 tig, 2 tig + 1 hold whole points).
template <int CH, int PQ, int PV>
struct Shape {
  static_assert(CH % 8 == 0 && PQ % 4 == 0, "the scalar columns fill k-steps, points a thread's columns");
  static constexpr int PQP = PQ, PVP = (PV + 7) / 8 * 8;
  static constexpr int KQ = (CH + 3 * PQP + 7) / 8 * 8;        // augmented q / k width
  static constexpr int QS = KQ / 8, SS = CH / 8, PS = QS - SS;  // k-steps: all, scalar, point
  static constexpr int VN = (CH + 3 * PVP) / 8, VP = 3 * PVP / 8;  // value n-tiles: all, point
  // row strides (floats), each 4 mod 8: a fragment's 8 rows x 4 columns (and the values'
  // 4 row pairs x 8 columns) fall on 32 distinct banks
  static constexpr int KS = KQ + 4, KLS = PS * 8 + 4, VS = CH + 3 * PVP + 4, VLS = 3 * PVP + 4;
  // a ring stage (floats): K (the scalars as they landed, the points' TF32 high parts), the
  // points' low parts, the same for V, the keys' rot (9), trans (3) and mask, and the per-key
  // bias and mask term
  static constexpr int K_OFF = 0, KL_OFF = KT * KS, V_OFF = KL_OFF + KT * KLS,
                       VL_OFF = V_OFF + KT * VS, R_OFF = VL_OFF + KT * VLS,
                       T_OFF = R_OFF + KT * 9, M_OFF = T_OFF + KT * 3, B_OFF = M_OFF + KT,
                       X_OFF = B_OFF + KT, STAGE = X_OFF + KT;
  static constexpr int FS = CH + 4 * PVP;  // a staged feature row (bf16): scalars | x | y | z | norms
  static constexpr size_t SMEM = STAGES * (size_t)STAGE * sizeof(float);
  static_assert((size_t)MAX_WARPS * 16 * FS * 2 <= SMEM, "the features' staging fits the ring");
};

struct Args {
  const float *proj, *rot, *trans, *mask, *hw;
  bf16* feats;
  long long ldf;
  int L, H, W, qgroups;  // qgroups: blocks per (element, head) (ops/ipa_attention.py::tc_plan)
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float tf32f(float x) { return __uint_as_float(tf32(x)); }
__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// c += a (16 x 8, row) . b (8 x 8, col), TF32 in, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the 3xTF32 product of a split pair: c += a_lo b_hi + a_hi b_lo + a_hi b_hi
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

__device__ __forceinline__ void cp8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
// n floats, 16 bytes a copy where src starts on 16 bytes (dst always does), else 4
__device__ __forceinline__ void copy_span(float* dst, const float* src, int n) {
  int f0 = 0;
  if ((reinterpret_cast<unsigned long long>(src) & 15) == 0) {
    for (int c = threadIdx.x; c < n / 4; c += blockDim.x) cp16(dst + 4 * c, src + 4 * c);
    f0 = n / 4 * 4;
  }
  for (int f = f0 + threadIdx.x; f < n; f += blockDim.x) cp4(dst + f, src + f);
}

// the key side of keys k0 .. k0 + nk - 1 of (element, head) into a ring stage: per key
// eight proj segments (k, v, then the x / y / z blocks of its k and v points) and the
// spans of the keys' frames and mask. ALIGNED (proj's rows on 16 bytes): 16-byte copies
// (8-byte for v points whose count is not a multiple of 4), the chunk layout known at
// compile time; else copies of wc floats (wv for the v points)
template <int CH, int PQ, int PV, bool ALIGNED>
__device__ __forceinline__ void stage_keys(const Args& a, float* st, long long rk, int nk, int h,
                                           int wc, int wv) {
  using S = Shape<CH, PQ, PV>;
  if constexpr (ALIGNED) {
    wc = 4;
    wv = PV % 4 == 0 ? 4 : PV % 2 == 0 ? 2 : 1;
  }
  const int HCh = a.H * CH, HPq = a.H * PQ, HPv = a.H * PV;
  const int ns = CH / wc, np = PQ / wc, nv = PV / wv, per = 2 * ns + 3 * np + 3 * nv;
  for (int c = threadIdx.x; c < nk * per; c += blockDim.x) {
    const int j = c / per;
    int r = c - j * per;
    const float* src = a.proj + (rk + j) * a.W;
    float* dst;
    int w = wc;
    if (r < 2 * ns) {  // k, v
      const int v = r >= ns, i = r - v * ns;
      src += (1 + v) * HCh + h * CH + i * wc;
      dst = st + (v ? S::V_OFF + j * S::VS : S::K_OFF + j * S::KS) + i * wc;
    } else if ((r -= 2 * ns) < 3 * np) {  // k points
      const int x = r / np, i = r - x * np;
      src += 3 * HCh + 3 * HPq + x * HPq + h * PQ + i * wc;
      dst = st + S::K_OFF + j * S::KS + CH + x * S::PQP + i * wc;
    } else {  // v points
      r -= 3 * np;
      const int x = r / nv, i = r - x * nv;
      src += 3 * HCh + 6 * HPq + x * HPv + h * PV + i * wv;
      dst = st + S::V_OFF + j * S::VS + CH + x * S::PVP + i * wv;
      w = wv;
    }
    if (w == 4) cp16(dst, src);
    else if (w == 2) cp8(dst, src);
    else cp4(dst, src);
  }
  copy_span(st + S::R_OFF, a.rot + rk * 9, nk * 9);
  copy_span(st + S::T_OFF, a.trans + rk * 3, nk * 3);
  copy_span(st + S::M_OFF, a.mask + rk, nk);
}

// a landed stage made ready for the products, a thread per (key, point): the key and
// value points lifted by their key's frame (once per key of the stage), the keys' as
// w x the lifted point, both split into TF32 high and low parts; the per-key bias
// -w/2 |k_pts|^2 (summed over a key's PQ neighbouring lanes) and mask term
// 1e5 (m_k - 1). The scalars stay as they landed: the tensor cores read their top 19
// bits (TF32 truncated). Keys past nk: zero rows, bias NEG.
template <int CH, int PQ, int PV>
__device__ __forceinline__ void prep(float* st, int nk, float w) {
  using S = Shape<CH, PQ, PV>;
  static_assert((PQ & (PQ - 1)) == 0 && PQ <= 32, "a key's points on neighbouring lanes");
  for (int e = threadIdx.x; e < KT * PQ; e += blockDim.x) {  // whole warps: KT PQ % 32 == 0
    const int j = e / PQ, p = e % PQ;
    float* hi = st + S::K_OFF + j * S::KS + CH + p;
    float* lo = st + S::KL_OFF + j * S::KLS + p;
    float sq = 0.f;
    if (j < nk) {
      const float* r = st + S::R_OFF + j * 9;
      const float* t = st + S::T_OFF + j * 3;
      const float x = hi[0], y = hi[S::PQP], z = hi[2 * S::PQP];
      const float g[3] = {r[0] * x + r[1] * y + r[2] * z + t[0], r[3] * x + r[4] * y + r[5] * z + t[1],
                          r[6] * x + r[7] * y + r[8] * z + t[2]};
      sq = g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = w * g[c], hv = tf32f(v);
        hi[c * S::PQP] = hv;
        lo[c * S::PQP] = tf32f(v - hv);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) hi[c * S::PQP] = lo[c * S::PQP] = 0.f;
    }
#pragma unroll
    for (int o = PQ / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if (p == 0) {
      st[S::B_OFF + j] = j < nk ? -0.5f * w * sq : NEG;
      st[S::X_OFF + j] = j < nk ? 1e5f * (st[S::M_OFF + j] - 1.0f) : 0.f;
    }
  }
  for (int e = threadIdx.x; e < KT * PV; e += blockDim.x) {
    const int j = e / PV, p = e % PV;
    float* hi = st + S::V_OFF + j * S::VS + CH + p;
    float* lo = st + S::VL_OFF + j * S::VLS + p;
    if (j < nk) {
      const float* r = st + S::R_OFF + j * 9;
      const float* t = st + S::T_OFF + j * 3;
      const float x = hi[0], y = hi[S::PVP], z = hi[2 * S::PVP];
      const float g[3] = {r[0] * x + r[1] * y + r[2] * z + t[0], r[3] * x + r[4] * y + r[5] * z + t[1],
                          r[6] * x + r[7] * y + r[8] * z + t[2]};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float hv = tf32f(g[c]);
        hi[c * S::PVP] = hv;
        lo[c * S::PVP] = tf32f(g[c] - hv);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) hi[c * S::PVP] = lo[c * S::PVP] = 0.f;
    }
  }
  if (nk < KT)  // the last tile: its rows past nk stale
    for (int e = threadIdx.x; e < (KT - nk) * (CH / 4); e += blockDim.x) {
      const int j = nk + e / (CH / 4), c = e % (CH / 4) * 4;
      *reinterpret_cast<float4*>(st + S::K_OFF + j * S::KS + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(st + S::V_OFF + j * S::VS + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// bf16 elements per store of a feature segment of n elements at column off of rows ldf
// apart from feats: 8 (16 bytes) where every row's segment allows it, else 2 or 1
__device__ __forceinline__ int seg_vec(const bf16* feats, long long ldf, long long off, int n) {
  const unsigned long long base = reinterpret_cast<unsigned long long>(feats);
  for (int v = 8; v > 1; v >>= 2)
    if (n % v == 0 && off % v == 0 && ldf % v == 0 && base % (2 * v) == 0) return v;
  return 1;
}

// One block: warps x 16 queries of (element b, head h), block index (b H + h) qgroups + qg.
// The keys stream through a ring of STAGES stages (16-byte cp.async, the next stages in flight
// while this one is lifted and multiplied); each warp keeps its 16 queries' augmented rows (TF32,
// the points split high / low) as A fragments, its running max and sum per row and its
// value sums in registers, and for every 32 keys forms S = Q K^T (m16n8k8 TF32: the scalar
// k-steps single, the point k-steps 3xTF32), adds the per-key bias and m_q x mask term, takes
// the natural-exp online softmax, and adds P [v | v_pts] (the point n-tiles 3xTF32; P's C
// fragments are its A fragments with the keys of a k-step in the order 0, 2, 4, 6, 1, 3, 5,
// 7, which the value rows follow). The epilogue divides by the sum, maps the points back
// into the query's frame, forms the norms and writes bf16 features as 16-byte vectors
// (staged per warp in the ring).
template <int CH, int PQ, int PV>
__global__ void __launch_bounds__(MAX_WARPS * 32, 16 / MAX_WARPS) ipa_attention_tc_kernel(const Args a) {
  using S = Shape<CH, PQ, PV>;
  extern __shared__ __align__(16) float tsm[];
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int qg = blockIdx.x % a.qgroups, h = (blockIdx.x / a.qgroups) % a.H;
  const long long b = blockIdx.x / a.qgroups / a.H, row0 = b * a.L;
  const int L = a.L, HCh = a.H * CH, HPq = a.H * PQ, HPv = a.H * PV;
  const int q0 = (qg * (nthr >> 5) + warp) * 16;  // this warp's first query
  const bool active = q0 < L;
  const float hw_raw = __ldg(a.hw + h);
  const float w = (hw_raw > 20.f ? hw_raw : log1pf(expf(hw_raw))) * sqrtf(1.0f / (3.0f * (PQ * 9.0f / 2.0f)));
  const float c_sc = sqrtf(1.0f / (3.0f * CH));
  // copy widths: 4 floats where proj's rows keep 16-byte alignment, else 2 or 1
  const unsigned long long pb = reinterpret_cast<unsigned long long>(a.proj);
  const int al = (pb % 16 == 0 && a.W % 4 == 0) ? 4 : (pb % 8 == 0 && a.W % 2 == 0) ? 2 : 1;
  const int wc = al, wv = min(al, PV % 4 == 0 ? 4 : PV % 2 == 0 ? 2 : 1);
  auto load_tile = [&](float* st, int t) {
    const long long rk = row0 + (long long)t * KT;
    const int nk = min(KT, L - t * KT);
    if (al == 4) stage_keys<CH, PQ, PV, true>(a, st, rk, nk, h, wc, wv);
    else stage_keys<CH, PQ, PV, false>(a, st, rk, nk, h, wc, wv);
  };

  // the ring's pad columns stay zero (the copies and prep write only real columns)
  for (int i = tid; i < STAGES * S::STAGE; i += nthr) tsm[i] = 0.f;
  __syncthreads();
  const int ntiles = (L + KT - 1) / KT;
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_tile(tsm + t * S::STAGE, t);
    cp_commit();
  }

  // this warp's queries as A fragments: rows gid, gid + 8; columns 8 s + tig (+ 4)
  uint32_t qh[S::QS][4], ql[S::PS][4];
  float mq[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qi = q0 + gid + 8 * ri;
    const bool live = qi < L;
    const float* prow = a.proj + (row0 + (live ? qi : 0)) * a.W;
    const float* r = a.rot + (row0 + (live ? qi : 0)) * 9;
    const float* t = a.trans + (row0 + (live ? qi : 0)) * 3;
    mq[ri] = live ? a.mask[row0 + qi] : 0.f;
#pragma unroll
    for (int s = 0; s < S::QS; ++s)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 8 * s + tig + 4 * half, idx = ri + 2 * half;
        float v = 0.f;
        if (live && s < S::SS) {
          v = c_sc * prow[h * CH + col];
        } else if (live) {
          const int cc = col - CH, x = cc / S::PQP, p = cc % S::PQP;
          if (x < 3 && p < PQ) {
            const float* src = prow + 3 * HCh + h * PQ + p;
            const float px = src[0], py = src[HPq], pz = src[2 * HPq];
            const float g0 = r[0] * px + r[1] * py + r[2] * pz + t[0];
            const float g1 = r[3] * px + r[4] * py + r[5] * pz + t[1];
            const float g2 = r[6] * px + r[7] * py + r[8] * pz + t[2];
            v = x == 0 ? g0 : x == 1 ? g1 : g2;
          }
        }
        qh[s][idx] = tf32(v);
        if (s >= S::SS) ql[s >= S::SS ? s - S::SS : 0][idx] = tf32(v - __uint_as_float(qh[s][idx]));
      }
  }

  float o[S::VN][4], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < S::VN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    float* st = tsm + (it % STAGES) * S::STAGE;
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile it has landed in every thread; every warp is done with tile it - 1
    const int next = it + STAGES - 1;  // into the stage of tile it - 1
    if (next < ntiles) load_tile(tsm + (next % STAGES) * S::STAGE, next);
    cp_commit();
    const int nk = min(KT, L - it * KT);
    prep<CH, PQ, PV>(st, nk, w);
    __syncthreads();
    if (!active) continue;
#ifdef MDGEN_TC_STAGING_ONLY
    continue;  // a measuring build: the ring and the lift without the products (tools/form_clock.py)
#endif
    const float* K = st + S::K_OFF;
    const float* KL = st + S::KL_OFF;
    const float* V = st + S::V_OFF;
    const float* VL = st + S::VL_OFF;
    for (int s0 = 0; s0 < nk; s0 += SUB) {
      float sc[SUB / 8][4];
#pragma unroll
      for (int nt = 0; nt < SUB / 8; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
        const float* kr = K + (s0 + 8 * nt + gid) * S::KS + tig;
        const float* klr = KL + (s0 + 8 * nt + gid) * S::KLS + tig;
#pragma unroll
        for (int s = 0; s < S::QS; ++s) {
          const uint32_t b0 = bits(kr[8 * s]), b1 = bits(kr[8 * s + 4]);
          if (s < S::SS) {
            mma(sc[nt], qh[s], b0, b1);
          } else {
            const int u = s >= S::SS ? s - S::SS : 0;
            mma3(sc[nt], qh[s], ql[u], b0, b1, bits(klr[8 * u]), bits(klr[8 * u + 4]));
          }
        }
        // the per-key bias and mask term: keys s0 + 8 nt + 2 tig (+ 1)
        const float2 bb = *reinterpret_cast<const float2*>(st + S::B_OFF + s0 + 8 * nt + 2 * tig);
        const float2 xx = *reinterpret_cast<const float2*>(st + S::X_OFF + s0 + 8 * nt + 2 * tig);
        sc[nt][0] += bb.x + mq[0] * xx.x;
        sc[nt][1] += bb.y + mq[0] * xx.y;
        sc[nt][2] += bb.x + mq[1] * xx.x;
        sc[nt][3] += bb.y + mq[1] * xx.y;
      }
      // the online softmax of rows gid and gid + 8 (each over the four threads of a group)
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int nt = 0; nt < SUB / 8; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[nt][0], sc[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[nt][2], sc[nt][3]));
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
        mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
        const float mn = fmaxf(m[ri], mx[ri]), scale = __expf(m[ri] - mn);
        m[ri] = mn;
        l[ri] *= scale;
#pragma unroll
        for (int n = 0; n < S::VN; ++n) {
          o[n][2 * ri] *= scale;
          o[n][2 * ri + 1] *= scale;
        }
      }
#pragma unroll
      for (int nt = 0; nt < SUB / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] = __expf(sc[nt][e] - m[e >> 1]);
          l[e >> 1] += sc[nt][e];
        }
        // P's fragments: k-step column tig is key 2 tig, column tig + 4 key 2 tig + 1
        const uint32_t ph[4] = {tf32(sc[nt][0]), tf32(sc[nt][2]), tf32(sc[nt][1]), tf32(sc[nt][3])};
        const uint32_t pl[4] = {tf32(sc[nt][0] - __uint_as_float(ph[0])),
                                tf32(sc[nt][2] - __uint_as_float(ph[1])),
                                tf32(sc[nt][1] - __uint_as_float(ph[2])),
                                tf32(sc[nt][3] - __uint_as_float(ph[3]))};
        const int kr = s0 + 8 * nt + 2 * tig;
        const float* v0 = V + kr * S::VS + gid;
        const float* vl0 = VL + kr * S::VLS + gid;
#pragma unroll
        for (int n = 0; n < S::SS; ++n) mma(o[n], ph, bits(v0[8 * n]), bits(v0[S::VS + 8 * n]));
#pragma unroll
        for (int u = 0; u < S::VP; ++u) {
          const int n = S::SS + u;
          mma3(o[n], ph, pl, bits(v0[8 * n]), bits(v0[S::VS + 8 * n]), bits(vl0[8 * u]),
               bits(vl0[S::VLS + 8 * u]));
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the ring: it stages the features
  if (!active) return;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 1);
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 2);
  }
  bf16* Fw = reinterpret_cast<bf16*>(tsm) + warp * 16 * S::FS;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = gid + 8 * ri, qi = q0 + row;
    const float inv = 1.f / l[ri];
    bf16* f = Fw + row * S::FS;
#pragma unroll
    for (int n = 0; n < S::SS; ++n)
      *reinterpret_cast<__nv_bfloat162*>(f + 8 * n + 2 * tig) =
          __floats2bfloat162_rn(o[n][2 * ri] * inv, o[n][2 * ri + 1] * inv);
    if (qi >= L) continue;
    const float* r = a.rot + (row0 + qi) * 9;
    const float* t = a.trans + (row0 + qi) * 3;
    const float r0 = r[0], r1 = r[1], r2 = r[2], r3 = r[3], r4 = r[4], r5 = r[5], r6 = r[6],
                r7 = r[7], r8 = r[8], t0 = t[0], t1 = t[1], t2 = t[2];
#pragma unroll
    for (int pb = 0; pb < S::PVP / 8; ++pb) {
      float lx[2], ly[2], lz[2], nrm[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dx = o[S::SS + pb][2 * ri + e] * inv - t0;
        const float dy = o[S::SS + S::PVP / 8 + pb][2 * ri + e] * inv - t1;
        const float dz = o[S::SS + 2 * S::PVP / 8 + pb][2 * ri + e] * inv - t2;
        lx[e] = r0 * dx + r3 * dy + r6 * dz;
        ly[e] = r1 * dx + r4 * dy + r7 * dz;
        lz[e] = r2 * dx + r5 * dy + r8 * dz;
        nrm[e] = sqrtf(lx[e] * lx[e] + ly[e] * ly[e] + lz[e] * lz[e] + 1e-8f);
      }
      const int p = CH + 8 * pb + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(f + p) = __floats2bfloat162_rn(lx[0], lx[1]);
      *reinterpret_cast<__nv_bfloat162*>(f + p + S::PVP) = __floats2bfloat162_rn(ly[0], ly[1]);
      *reinterpret_cast<__nv_bfloat162*>(f + p + 2 * S::PVP) = __floats2bfloat162_rn(lz[0], lz[1]);
      *reinterpret_cast<__nv_bfloat162*>(f + p + 3 * S::PVP) = __floats2bfloat162_rn(nrm[0], nrm[1]);
    }
  }
  __syncwarp();
  // the staged rows out: the scalars, then x, y, z and the norms of this head's points
#pragma unroll 1
  for (int sg = 0; sg < 5; ++sg) {
    const int n = sg == 0 ? CH : PV, so = sg == 0 ? 0 : CH + (sg - 1) * S::PVP;
    const long long off = sg == 0 ? (long long)h * CH : HCh + (long long)(sg - 1) * HPv + h * PV;
    const int vw = seg_vec(a.feats, a.ldf, off, n), nc = n / vw;
    for (int u = lane; u < 16 * nc; u += 32) {
      const int row = u / nc, c = (u - row * nc) * vw;
      if (q0 + row >= L) continue;
      const bf16* src = Fw + row * S::FS + so + c;
      bf16* dst = a.feats + (row0 + q0 + row) * a.ldf + off + c;
      if (vw == 8) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      else if (vw == 2) *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
      else *dst = *src;
    }
  }
}

// a launch of the instance at its shared memory, set on the kernel once per card
template <int CH, int PQ, int PV>
int launch(const Args& a, long long blocks, int warps, cudaStream_t s) {
  constexpr size_t smem = Shape<CH, PQ, PV>::SMEM;
  static bool sized[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(ipa_attention_tc_kernel<CH, PQ, PV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized[dev] = true;
  }
  ipa_attention_tc_kernel<CH, PQ, PV><<<(unsigned)blocks, warps * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tc

// the key-tiled form at widths the tensor-core form does not take: one block of 64
// threads per (element, head, 64-query tile), a thread per query, the keys in tiles of 64
// (points lifted as they are staged), each tile's logits in a row of shared memory and a
// running-max softmax; the query's state in shared memory ([value][thread], conflict-free)
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
// widths runs: the streaming form at plan spb > 0, else the tensor-core form
// in blocks of `warps` warps (the resident form's are not asked for)
extern "C" int ipa_attention_resources(int L, int H, int spb, int warps, long long* info) {
  const int W = H * (3 * SCH + 6 * SPQ + 3 * SPV), F = H * (SCH + 4 * SPV);
  if (spb > 0) {
    if (!short_shape(L, H, SCH, SPQ, SPV, spb)) return (int)cudaErrorInvalidValue;
    return kernel_resources(L == 4 && H == 4 && SHORT_L4H4 ? ipa_attention_short_kernel<4, 4>
                                                          : ipa_attention_short_kernel<0, 0>,
                            SHORT_THREADS,
                            ShortLayout(spb, L, W, F).total, info);
  }
  if (warps < 1 || warps > tc::MAX_WARPS) return (int)cudaErrorInvalidValue;
  return kernel_resources(tc::ipa_attention_tc_kernel<SCH, SPQ, SPV>, warps * 32,
                          tc::Shape<SCH, SPQ, SPV>::SMEM, info);
}

// tiled 2: the tensor-core form (widths (32, 8, 8) and (16, 4, 6)), `grid`
// blocks per (element, head) of `warps` warps (ops/ipa_attention.py::
// tc_plan); tiled 1: the key-tiled form at any widths; spb > 0 (tiled 0):
// the streaming form, units of spb elements over a persistent grid of
// `grid` blocks (ops/ipa_attention.py::ipa_plan); else the resident form,
// whose L x L logits must fit one block's shared memory. The plans are
// trailing arguments, so an older entry point is called the same way.
extern "C" int ipa_attention(const void* proj, long long ld, const void* rot, const void* trans,
                             const void* mask, const void* head_weights, void* feats,
                             long long ldf, int B, int L, int H, int Ch, int Pq, int Pv,
                             int tiled, void* stream, int spb, int grid, int warps) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled == 2) {
    tc::Args a;
    a.proj = static_cast<const float*>(proj);
    a.rot = static_cast<const float*>(rot);
    a.trans = static_cast<const float*>(trans);
    a.mask = static_cast<const float*>(mask);
    a.hw = static_cast<const float*>(head_weights);
    a.feats = static_cast<bf16*>(feats);
    a.ldf = ldf; a.L = L; a.H = H; a.qgroups = grid;
    a.W = H * (3 * Ch + 6 * Pq + 3 * Pv);
    const long long blocks = (long long)B * H * grid;
    if (ld != a.W || ldf != (long long)H * (Ch + 4 * Pv) || B <= 0 || L <= 0 || H <= 0 ||
        warps < 1 || warps > tc::MAX_WARPS || grid < 1 || (long long)grid * warps * 16 < L ||
        blocks > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    if (Ch == 32 && Pq == 8 && Pv == 8) return tc::launch<32, 8, 8>(a, blocks, warps, s);
    if (Ch == 16 && Pq == 4 && Pv == 6) return tc::launch<16, 4, 6>(a, blocks, warps, s);
    return (int)cudaErrorInvalidValue;
  }
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
