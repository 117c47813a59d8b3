// fused_layer_bwd: the backward of one trunk layer as ONE cooperative
// kernel launch (the merged route, MDGEN_FUSED_BWD=merged).
//
// Replaces mdgen_finetune_tpu/ops/fused_layer_bwd.py::_kmerged (:501,
// pallas_call :646), the TPU's whole-layer backward: the MLP core _k3_core
// (:122), then the frame-attention core _k2_core (:175), then the
// residue-attention core _k1_core (:342), with the inter-stage cotangents
// dx2 and dx1 kept out of HBM. It computes exactly what the split route of
// ops/fused_layer_bwd.py computes, with the same code: every step of that
// route is a block body of a split kernel (adaln_linear.cuh,
// linear_bwd.cuh, modln_bwd.cuh, rope_attention.cuh, rope_attention_bwd.cuh,
// blocked_attention_bwd.cuh, colsum.cuh), and this kernel runs those bodies
// over the same block indices, with the same arguments, in phases:
//
//   P0  recompute: fc1 + GELU (ge, a) of X2; qkv of X1 and of x_in; the
//       LayerNorm statistics of X2, X1, x_in for the wgrad prologues;
//       bf16(dOUT * g8) (linear_bwd's prologue)
//   P1  y = ge @ w2 + b2; dW2 partials; da = dgrad(dOUT * g8, w2) * gelu'(a);
//       att of the frame and of the residue stage (rope_attention); the
//       LN + modulate prologues of X2, X1, x_in in bf16
//   P2  dW1 partials; dh = da @ w1^T; y of both attention stages (att @ wout)
//   P3  modln_bwd of the MLP stage: dx2
//   P4  bf16(dx2 * g5)
//   P5  dWout_t partials; datt = dgrad(dx2 * g5, wout_t)
//   P6  the frame attention backward (rope_attention_bwd, or
//       blocked_attention_bwd at 128 < T)
//   P7  dWqkv_t partials; dh = dqkv @ wqkv_t^T
//   P8  modln_bwd of the frame stage: dx1
//   P9-13  the same five steps for the residue stage: dx
//   P14 the last AdaLN-row sums
// with every cross-block sum (colsum) in the phase after its partials; the
// phases are separated by cooperative_groups' grid.sync(). Each phase walks
// its blocks over the grid (block t of a phase takes virtual blocks t,
// t + grid, ...), and a virtual block computes what the split kernel's block
// of that index computes, so the outputs are the split route's bit for bit
// where the instruction sequence of each output is the same (modln_bwd,
// which the split route runs with 256 threads, runs here with 128 threads
// as virtual warps: same products, same order; adaln_linear's wgmma core is
// one warpgroup of 128 threads here, a block of 64 rows, where the split
// route's blocks hold two warpgroups and 128 rows, with a shallower TMA
// ring: the products of each 64 rows run the same wgmma sequence either
// way). The weight-gradient sums keep the split kernels' fixed-order
// partial sums: no atomics.
//
// What bounds it on the H100: the layer backward recomputes the forward's
// three stages and takes their data and weight products: at B = 32, T = 100,
// L = 4, C = 384 (M = 12,800 rows) about 3 x 2 x M x 16 C^2 = 1.8e11 FLOP of
// products (0.18 ms at 989 TFLOP/s) against ~0.2 GB of saved inputs,
// weights and outputs (0.06 ms at 3.35 TB/s): the tensor cores bound it. The
// intermediates (ge, a, da, the attention outputs, dx2, dx1: ~0.3 GB at
// B = 32) pass through device memory between phases as in the split route;
// "kept on chip" on the H100 means the 50 MB L2, which holds a phase's
// share of them only at small B. What the merged launch removes is the host
// side: 1 launch per layer instead of ~25, and no gaps between them. The
// design is the split route's tiling, not a new one: one persistent block
// of 128 threads per resident slot (SM count x blocks per SM at the largest
// phase's shared memory); the forward products on adaln_linear's wgmma +
// TMA core, the rest mma.sync through the split kernels' inline PTX. A
// column sum over many rows (the residue stage's bias-key sums: 3,200 rows
// at B = 32) runs colsum_kernel's lanes on blocks of 16 columns (the split
// kernel's hold 32); one over few rows (the weight gradients' partials), a
// thread per column.
//
// Where the time goes (tools/merged_phase_clock.py; PERF.md): every phase
// runs 1.5-6 x its split kernels' time. The products: adaln_linear's wgmma
// pipeline is serialized by ptxas when the body is a call of its own (C7510:
// "wgmma pipeline crossing function boundary"), and inlined it spills with
// the other bodies in one 255-register allocation. Blocks of 256 threads
// (the split route's two-warpgroup GEMM, the 128-thread bodies in pairs),
// the bodies as calls of their own, and their arguments read through opaque
// pointers were each measured slower than this shape (PR 12).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "adaln_linear.cuh"
#include "blocked_attention_bwd.cuh"
#include "colsum.cuh"
#include "linear_bwd.cuh"
#include "modln_bwd.cuh"
#include "rope_attention.cuh"
#include "rope_attention_bwd.cuh"

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 128;
constexpr int PHASES = 15, MAX_JOBS = 8;
constexpr int SUM_COLS = THREADS / colsum::LANES;  // the column sums' columns per block
// column sums over at least this many rows spread each column's rows over
// lanes (the bias-key sums: a row per sequence); fewer (the weight
// gradients' split partials), a thread per column
constexpr long long LANE_ROWS = 64;
constexpr int ROPE_BWD_MAX_N = 128;  // ops/rope_attention_bwd.MAX_N: blocked_attention_bwd above

enum Kind {
  GEMM_BF16 = 0, GEMM_F32,          // adaln_linear's wgmma core (resident or pipelined)
  STATS, PROLOGUE, DGRAD, WGRAD,    // linear_bwd
  MODLN, ROPE_FWD, ROPE_BWD, BLOCKED, COLSUM
};

struct Job {
  int kind, arg;       // what, and which entry of its argument array
  int tiles, gx, gy;   // virtual blocks, and the split kernel's grid extents
  int per;             // resident: column chunks per block
};

struct Phase {
  int njobs;
  Job job[MAX_JOBS];
};

struct Modln {
  const bf16* x; long long ldx;
  const float *dh, *dout, *y;
  const bf16* scale; long long ld_mod;
  float *dx, *part;
  int C, nb, rows, rows_per_split;
  int vec;  // every row 16-byte aligned: modln::block's cp.async staging
};

struct Attn {  // rope_attention, rope_attention_bwd, blocked_attention_bwd
  ropefwd::Shape sh;   // the forward's launch shape (its short plan)
  ropebwd::Shape bsh;  // rope_attention_bwd's (its short plan)
  const bf16 *qkv, *grad, *bk, *bv;
  const float *kv, *cos, *sin;
  bf16* out;
  float* part;
  int G, N, I;
};

struct Colsum {
  const float* in;
  float* out;
  long long R, W, row_w, ld_out;
};

struct Params {
  adaln::Args ad[6];
  lbwd::Args lb[12];  // with the prologue's buffers (STATS, PROLOGUE)
  lbwd::Args lg[12];  // the GEMMs' plain bf16 operands: gemm_args(lb[i])
  Modln ml[3];
  Attn at[4];  // forward frame, forward residue, backward frame, backward residue
  Colsum cs[19];
  Phase ph[PHASES];
  int H, C;
  unsigned long long* clock;  // the phase clock's stamps (MDGEN_PHASE_CLOCK builds only)
};
static_assert(sizeof(Params) <= 32764, "the kernel's parameters must fit 32,764 bytes");

// adaln_linear's body as a call of its own: inlined into the kernel's one
// register allocation it made the kernel spill kilobytes a thread, called
// it spills a few hundred bytes (same code, same bits)
template <typename OT, int EC>
__device__ __noinline__ void gemm_phase(const adaln::Args& a, int t, unsigned char* smem) {
  adaln::wg::gemm_block<OT, 1, EC>(a, t, smem);
}

// rope_attention_bwd's short body as a call of its own: inlined, its
// registers (a row's exp2 and dp kept for up to 17 keys) made the whole
// kernel spill kilobytes a thread (ptxas; same code, same bits). The
// generic instance at every N: the split kernel's N = 4 instance measured
// no faster here (PERF.md)
template <int D>
__device__ __noinline__ void rope_bwd_short_phase(const Attn& a, int H, int C, int t,
                                                  unsigned char* smem) {
  ropebwd::short_unit<D, 0>(ropebwd::short_args(a.qkv, a.grad, a.bk, a.bv, a.kv, a.cos, a.sin,
                                                  a.out, a.part, a.G, a.N, a.I, H, C, a.bsh.spb,
                                                  a.bsh.hg),
                              t, smem);
}

// modln_bwd's body as a call of its own (its row sums are J x 3 registers a
// lane; the split kernel runs the same body at 8 warps a block)
template <int J>
__device__ __noinline__ void modln_phase(const Modln& m, int t, unsigned char* smem) {
  modln::block<bf16, J, THREADS>(m.x, m.ldx, m.dh, m.dout, m.y, m.scale, m.ld_mod, m.dx, m.part,
                                 m.C, m.nb, m.rows, m.rows_per_split, t % m.nb, t / m.nb, m.vec,
                                 smem);
}

template <int D>
__device__ __forceinline__ void run(const Params& P, const Job& j, int t, unsigned char* smem) {
  switch (j.kind) {
    case GEMM_BF16:  // the resident route: fc1 (GELU, with its pre-activation), qkv
      if (P.ad[j.arg].epi == adaln::EPI_GELU)
        gemm_phase<bf16, adaln::wg::EC_GELU>(P.ad[j.arg], t, smem);
      else
        gemm_phase<bf16, adaln::wg::EC_NONE>(P.ad[j.arg], t, smem);
      break;
    case GEMM_F32:  // no epilogue: fc2 (pipelined), the out-projections (resident)
      gemm_phase<float, adaln::wg::EC_NONE>(P.ad[j.arg], t, smem);
      break;
    case STATS:
      lbwd::row_stats_block(P.lb[j.arg], t);
      break;
    case PROLOGUE:
      lbwd::prologue_block(P.lb[j.arg], t);
      break;
    case DGRAD:
      lbwd::dgrad_block(P.lg[j.arg], t % j.gx, t / j.gx, smem);
      break;
    case WGRAD:
      lbwd::wgrad_block(P.lg[j.arg], t % j.gx, (t / j.gx) % j.gy, t / (j.gx * j.gy), smem);
      break;
    case MODLN: {  // C <= 512 (ops/fused_layer_bwd_merged.py)
      const Modln& m = P.ml[j.arg];
      if (m.C <= 128)
        modln_phase<4>(m, t, smem);
      else if (m.C <= 256)
        modln_phase<8>(m, t, smem);
      else if (m.C <= 384)
        modln_phase<12>(m, t, smem);
      else
        modln_phase<16>(m, t, smem);
      break;
    }
    case ROPE_FWD: {
      const Attn& a = P.at[j.arg];
      ropefwd::block<D>(a.sh, a.qkv, a.bk, a.bv, a.kv, a.cos, a.sin, a.out, a.G, a.N, a.I, P.H,
                        P.C, 1, t, smem);
      break;
    }
    case ROPE_BWD: {
      const Attn& a = P.at[j.arg];
      if (a.bsh.short_seq)
        rope_bwd_short_phase<D>(a, P.H, P.C, t, smem);
      else
        ropebwd::long_block<D>(a.qkv, a.grad, a.bk, a.bv, a.kv, a.cos, a.sin, a.out, a.part, a.N,
                               a.I, P.H, P.C, t, reinterpret_cast<float*>(smem));
      break;
    }
    case BLOCKED: {
      const Attn& a = P.at[j.arg];
      blockedbwd::block<D>(a.qkv, a.grad, a.bk, a.bv, a.kv, a.cos, a.sin, a.out, a.part, a.N,
                           a.I, P.H, P.C, t, smem);
      break;
    }
    case COLSUM: {  // a thread per column where the rows are few, else lanes per column
      const Colsum& c = P.cs[j.arg];
      if (c.R < LANE_ROWS) {
        const long long w = (long long)t * THREADS + threadIdx.x;
        if (w < c.W) colsum::column(c.in, c.out, c.R, c.W, c.row_w, c.ld_out, w);
      } else {
        colsum::block<SUM_COLS>(c.in, c.out, c.R, c.W, c.row_w, c.ld_out, t,
                                reinterpret_cast<float*>(smem));
      }
      break;
    }
  }
}

// The phase clock: built with -DMDGEN_PHASE_CLOCK (tools/merged_phase_clock.py
// does, into a library of its own), thread 0 of every block writes
// %globaltimer (ns) at the start (w = 0) and the end (w = 1) of its work in
// each phase to clock[(phase * gridDim.x + block) * 2 + w]; the time from a
// block's end of phase p to its start of phase p + 1 is its wait at the grid
// barrier. The normal build compiles the stamp to nothing.
__device__ __forceinline__ void stamp(const Params& P, int p, int w) {
#ifdef MDGEN_PHASE_CLOCK
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    P.clock[((size_t)p * gridDim.x + blockIdx.x) * 2 + w] = t;
  }
#endif
}

template <int D>
__global__ void __launch_bounds__(THREADS) fused_layer_bwd_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  for (int p = 0; p < PHASES; ++p) {
    const Phase& ph = P.ph[p];
    stamp(P, p, 0);
    int total = 0;
    for (int j = 0; j < ph.njobs; ++j) total += ph.job[j].tiles;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int j = 0, local = t;
      while (local >= ph.job[j].tiles) local -= ph.job[j++].tiles;
      run<D>(P, ph.job[j], local, smem);
      __syncthreads();  // the next virtual block reuses the shared memory
    }
    stamp(P, p, 1);
    if (p + 1 < PHASES) grid.sync();
  }
}

// ---------------------------------------------------------------------------
// host side: the split route's arguments, phase by phase
// ---------------------------------------------------------------------------

// pointer slots of the entry point (ops/fused_layer_bwd_merged.py builds them)
enum Ptr {
  X_IN, X1, X2, DOUT, MOD, MASK,
  WQKV_L, BQKV_L, WOUT_L, BOUT_L, WQKV_T, BQKV_T, WOUT_T, BOUT_T, W1, B1, W2, B2, BKL, BVL,
  BKT, BVT,
  COS_T, SIN_T, COS_L, SIN_L,
  DX, DMOD,
  DWQKV_L, DBQKV_L, DWOUT_L, DBOUT_L, DWQKV_T, DBQKV_T, DWOUT_T, DBOUT_T, DW1, DB1, DW2, DB2,
  DBIAS_L, DBIAS_T,
  GE, ACT, Y3, YT, YL, DA, DH, DX2, DX1, QKV_T, QKV_L, ATT_T, ATT_L, DATT, DQKV,
  S_W2, S_W1, S_WOUT_T, S_WQKV_T, S_WOUT_L, S_WQKV_L,
  PM3, PM2, PM1, PB_T, PB_L,
  P_DOUT, P_X2, P_X1, P_XIN, P_DX2, P_DX1,  // linear_bwd's prologue outputs, bf16 (M, C)
  CLOCK,  // u64 [PHASES][grid][2], read by MDGEN_PHASE_CLOCK builds only (may be null)
  NPTR
};
// integer slots
// (AD_PLAN: the plans of the six adaln_linear calls, ops/adaln_linear.py::plan,
// four each: route, column chunks per block, blocks across the columns, ring
// stages; ROPE_PLAN: the short rope_attention plans of the frame and the
// residue stage, ops/rope_attention.py::short_plan(merged=True): sequences
// and heads per unit, two each, read where the stage is short; ROPE_BWD_PLAN:
// the same for rope_attention_bwd, ops/rope_attention_bwd.py::short_plan)
enum Int { NB_, NT_, NL_, NC_, NH_, NNB, LD_MOD, LD_DMOD, SPL_W2, SPL_W1, SPL_WOUT_T, SPL_WQKV_T,
           SPL_WOUT_L, SPL_WQKV_L, SPL_MODLN, SMEM_LIMIT, AD_PLAN, ROPE_PLAN = AD_PLAN + 24,
           ROPE_BWD_PLAN = ROPE_PLAN + 4, NINT = ROPE_BWD_PLAN + 4 };

struct Builder {
  Params P;
  int phase = 0;
  size_t smem = 0;
  bool ok = true;

  void add(int kind, int arg, long long tiles, int gx = 1, int gy = 1, int per = 0) {
    Phase& ph = P.ph[phase];
    if (ph.njobs >= MAX_JOBS || tiles <= 0 || tiles > 0x7fffffffLL) {
      ok = false;
      return;
    }
    ph.job[ph.njobs++] = Job{kind, arg, (int)tiles, gx, gy, per};
  }
  void need(size_t bytes) { smem = bytes > smem ? bytes : smem; }

  // an adaln_linear call on the route of its plan (resident or pipelined;
  // tiled64 is not taken here), its tensor maps built
  void adaln(int i, int out_f32, const long long* plan) {
    adaln::Args& a = P.ad[i];
    if (!adaln::with_plan(&a, (int)plan[0], 1, (int)plan[1], (int)plan[2], (int)plan[3], 0,
                          out_f32) ||
        a.route == adaln::ROUTE_TILED64 ||
        (!out_f32 && (a.route != adaln::ROUTE_RESIDENT || (a.epi != adaln::EPI_GELU && a.epi != adaln::EPI_NONE))) ||
        (out_f32 && a.epi != adaln::EPI_NONE)) {
      ok = false;
      return;
    }
    add(out_f32 ? GEMM_F32 : GEMM_BF16, i, adaln::blocks(a, 1));
    need(adaln::wg::smem(a.route, a.K, a.stages, 1));
  }
  void prologue(int i) { add(PROLOGUE, i, lbwd::prologue_blocks(P.lb[i])); }
  void dgrad(int i) {
    const dim3 g = lbwd::dgrad_grid(P.lb[i]);
    add(DGRAD, i, (long long)g.x * g.y, g.x, g.y);
    need(lbwd::DGRAD_SMEM);
  }
  void stats(int i) { add(STATS, i, lbwd::stats_blocks(P.lb[i])); }
  void wgrad(int i) {
    const dim3 g = lbwd::wgrad_grid(P.lb[i]);
    add(WGRAD, i, (long long)g.x * g.y * g.z, g.x, g.y);
    need(lbwd::WGRAD_SMEM);
  }
  void sum_cols(int i, const float* in, float* out, long long R, long long W, long long row_w,
              long long ld_out) {
    P.cs[i] = Colsum{in, out, R, W, row_w, ld_out};
    const int cols = R < LANE_ROWS ? THREADS : SUM_COLS;
    add(COLSUM, i, (W + cols - 1) / cols);
    need(colsum::LANES * (SUM_COLS + 1) * sizeof(float));
  }
};

template <int D>
int launch(const void* const* p, const long long* n, long long* info, cudaStream_t stream) {
  const int B = (int)n[NB_], T = (int)n[NT_], L = (int)n[NL_], C = (int)n[NC_], H = (int)n[NH_];
  const int nb = (int)n[NNB];
  const long long ld_mod = n[LD_MOD], ld_dmod = n[LD_DMOD];
  const int M = B * T * L, F = 4 * C, rpm = M / nb;
  if (M <= 0 || nb <= 0 || M % nb || C != H * D || T > 256 || L > 16) return (int)cudaErrorInvalidValue;
  auto bp = [&](int i) { return static_cast<const bf16*>(p[i]); };
  auto fp = [&](int i) { return static_cast<float*>(const_cast<void*>(p[i])); };
  auto vp = [&](int i) { return const_cast<void*>(p[i]); };
  auto m = [&](int j) { return bp(MOD) + (long long)j * C; };  // AdaLN row block j

  Builder b;
  memset(&b.P, 0, sizeof(Params));
  Params& P = b.P;
  P.H = H;
  P.C = C;
  P.clock = static_cast<unsigned long long*>(const_cast<void*>(p[CLOCK]));
  // ---- adaln_linear: the recomputed forward products ----
  //   0 fc1 (GELU, pre = a)  1 fc2 (f32)  2 qkv_t  3 out_t (f32)  4 qkv_l  5 out_l (f32)
  P.ad[0] = adaln::make_args(p[X2], C, p[W1], p[B1], vp(GE), F, M, F, C, adaln::LN_PLAIN, nullptr,
                             nullptr, m(6), m(7), ld_mod, rpm, adaln::EPI_GELU, nullptr, 0,
                             nullptr, 0, 1, 0.f, nullptr, 0, nullptr, 0, 1, 0, 1, vp(ACT), F);
  P.ad[1] = adaln::make_args(p[GE], F, p[W2], p[B2], vp(Y3), C, M, C, F, adaln::LN_NONE, nullptr,
                             nullptr, nullptr, nullptr, 0, 1, adaln::EPI_NONE, nullptr, 0, nullptr,
                             0, 1, 0.f, nullptr, 0, nullptr, 0, 1, 0, 1, nullptr, 0);
  const int xs[2] = {X1, X_IN}, wq[2] = {WQKV_T, WQKV_L}, bq[2] = {BQKV_T, BQKV_L};
  const int wo[2] = {WOUT_T, WOUT_L}, bo[2] = {BOUT_T, BOUT_L}, qk[2] = {QKV_T, QKV_L};
  const int at[2] = {ATT_T, ATT_L}, ys[2] = {YT, YL}, j0[2] = {3, 0};
  for (int s = 0; s < 2; ++s) {
    P.ad[2 + 2 * s] = adaln::make_args(p[xs[s]], C, p[wq[s]], p[bq[s]], vp(qk[s]), 3 * C, M, 3 * C,
                                       C, adaln::LN_PLAIN, nullptr, nullptr, m(j0[s]),
                                       m(j0[s] + 1), ld_mod, rpm, adaln::EPI_NONE, nullptr, 0,
                                       nullptr, 0, 1, 0.f, nullptr, 0, nullptr, 0, 1, 0, 1,
                                       nullptr, 0);
    P.ad[3 + 2 * s] = adaln::make_args(p[at[s]], C, p[wo[s]], p[bo[s]], vp(ys[s]), C, M, C, C,
                                       adaln::LN_NONE, nullptr, nullptr, nullptr, nullptr, 0, 1,
                                       adaln::EPI_NONE, nullptr, 0, nullptr, 0, 1, 0.f, nullptr, 0,
                                       nullptr, 0, 1, 0, 1, nullptr, 0);
  }
  // ---- linear_bwd: 0 dW2  1 da  2 dW1  3 dh (MLP); 4 dWout  5 datt  6 dWqkv
  //      7 dh (frame); 8-11 the same for the residue stage ----
  P.lb[0] = lbwd::make_args(1, p[DOUT], 1, C, m(8), ld_mod, rpm, p[GE], F, nullptr, 0, 0, nullptr,
                            nullptr, 0, 1, vp(DW2), 1, C, vp(S_W2), (int)n[SPL_W2], M, C, F);
  P.lb[1] = lbwd::make_args(0, p[DOUT], 1, C, m(8), ld_mod, rpm, p[W2], C, p[ACT], F, 0, nullptr,
                            nullptr, 0, 1, vp(DA), 0, F, nullptr, 1, M, C, F);
  P.lb[2] = lbwd::make_args(1, p[DA], 0, F, nullptr, 0, 1, p[X2], C, nullptr, 0, 1, m(6), m(7),
                            ld_mod, rpm, vp(DW1), 1, F, vp(S_W1), (int)n[SPL_W1], M, F, C);
  P.lb[3] = lbwd::make_args(0, p[DA], 0, F, nullptr, 0, 1, p[W1], F, nullptr, 0, 0, nullptr,
                            nullptr, 0, 1, vp(DH), 1, C, nullptr, 1, M, F, C);
  const int gin[2] = {DX2, DX1}, dwo[2] = {DWOUT_T, DWOUT_L}, dwq[2] = {DWQKV_T, DWQKV_L};
  const int swo[2] = {S_WOUT_T, S_WOUT_L}, swq[2] = {S_WQKV_T, S_WQKV_L};
  const int spo[2] = {SPL_WOUT_T, SPL_WOUT_L}, spq[2] = {SPL_WQKV_T, SPL_WQKV_L};
  for (int s = 0; s < 2; ++s) {
    const int k = 4 + 4 * s, j = j0[s];
    P.lb[k] = lbwd::make_args(1, p[gin[s]], 1, C, m(j + 2), ld_mod, rpm, p[at[s]], C, nullptr, 0,
                              0, nullptr, nullptr, 0, 1, vp(dwo[s]), 1, C, vp(swo[s]),
                              (int)n[spo[s]], M, C, C);
    P.lb[k + 1] = lbwd::make_args(0, p[gin[s]], 1, C, m(j + 2), ld_mod, rpm, p[wo[s]], C,
                                  nullptr, 0, 0, nullptr, nullptr, 0, 1, vp(DATT), 0, C, nullptr,
                                  1, M, C, C);
    P.lb[k + 2] = lbwd::make_args(1, p[DQKV], 0, 3 * C, nullptr, 0, 1, p[xs[s]], C, nullptr, 0, 1,
                                  m(j), m(j + 1), ld_mod, rpm, vp(dwq[s]), 1, 3 * C, vp(swq[s]),
                                  (int)n[spq[s]], M, 3 * C, C);
    P.lb[k + 3] = lbwd::make_args(0, p[DQKV], 0, 3 * C, nullptr, 0, 1, p[wq[s]], 3 * C, nullptr,
                                  0, 0, nullptr, nullptr, 0, 1, vp(DH), 1, C, nullptr, 1, M, 3 * C,
                                  C);
  }
  // linear_bwd's prologues, each made once in a phase of its own: bf16(dOUT
  // * g8) for fc2's wgrad and dgrad, the stages' LN + modulate inputs for
  // the fc1 and qkv wgrads, bf16(dx2 * g5) and bf16(dx1 * g2) for the
  // out-projections' wgrad and dgrad; the GEMMs take the bf16 results
  const int pre_a[3] = {2, 6, 10}, pa_buf[3] = {P_X2, P_X1, P_XIN};
  for (int i = 0; i < 2; ++i) {
    P.lb[i] = lbwd::with_prologue(P.lb[i], vp(P_DOUT), nullptr);
    P.lb[4 + i] = lbwd::with_prologue(P.lb[4 + i], vp(P_DX2), nullptr);
    P.lb[8 + i] = lbwd::with_prologue(P.lb[8 + i], vp(P_DX1), nullptr);
  }
  for (int i = 0; i < 3; ++i) P.lb[pre_a[i]] = lbwd::with_prologue(P.lb[pre_a[i]], nullptr, vp(pa_buf[i]));
  for (int i = 0; i < 12; ++i) P.lg[i] = lbwd::gemm_args(P.lb[i]);
  // ---- modln_bwd: 0 MLP (X2, dOUT)  1 frame (X1, dx2)  2 residue (x_in, dx1) ----
  const int splm = (int)n[SPL_MODLN], rows = M / nb;
  const int mx[3] = {X2, X1, X_IN}, mg[3] = {DOUT, DX2, DX1}, my[3] = {Y3, YT, YL};
  const int mo[3] = {DX2, DX1, DX}, mp[3] = {PM3, PM2, PM1}, mj[3] = {6, 3, 0};
  auto a16 = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  for (int s = 0; s < 3; ++s)
    P.ml[s] = Modln{bp(mx[s]), C, fp(DH), fp(mg[s]), fp(my[s]), m(mj[s] + 1), ld_mod, fp(mo[s]),
                    fp(mp[s]), C, nb, rows, (rows + splm - 1) / splm,
                    a16(bp(mx[s])) && a16(fp(DH)) && a16(fp(mg[s])) && a16(fp(my[s])) &&
                        C % 8 == 0};
  // ---- attention: views (G, N, I): frame (B, T, L), residue (B*T, L, 1) ----
  const int vG[2] = {B, B * T}, vN[2] = {T, L}, vI[2] = {L, 1};
  const int ct[2] = {COS_T, COS_L}, st[2] = {SIN_T, SIN_L}, bk[2] = {BKT, BKL}, bv[2] = {BVT, BVL};
  const int pb[2] = {PB_T, PB_L};
  const bool blocked = T > ROPE_BWD_MAX_N;
  for (int s = 0; s < 2; ++s) {
    Attn f{};
    f.sh = ropefwd::shape(vG[s], vN[s], vI[s], H, D, (int)n[ROPE_PLAN + 2 * s],
                          (int)n[ROPE_PLAN + 2 * s + 1], 1);
    if (f.sh.blocks == 0) return (int)cudaErrorInvalidValue;
    f.qkv = bp(qk[s]); f.bk = bp(bk[s]); f.bv = bp(bv[s]);
    f.kv = fp(MASK); f.cos = fp(ct[s]); f.sin = fp(st[s]);
    f.out = const_cast<bf16*>(bp(at[s]));
    f.G = vG[s]; f.N = vN[s]; f.I = vI[s];
    P.at[s] = f;
    Attn g = f;
    g.grad = bp(DATT);
    g.out = const_cast<bf16*>(bp(DQKV));
    g.part = fp(pb[s]);
    g.bsh = ropebwd::shape((long long)vG[s] * vI[s], vN[s], H, D, (int)n[ROPE_BWD_PLAN + 2 * s],
                           (int)n[ROPE_BWD_PLAN + 2 * s + 1], 1);
    if (g.bsh.blocks == 0 && !(s == 0 && blocked)) return (int)cudaErrorInvalidValue;
    P.at[2 + s] = g;
  }

  // ---- the phases ----
  float* dmod = fp(DMOD);
  auto colsum_w = [&](int cs, int lbi, int dw, int db) {  // a wgrad's two sums
    const lbwd::Args& a = P.lb[lbi];
    b.sum_cols(cs, a.part, fp(dw), a.splits, (long long)a.K * a.N, (long long)a.K * a.N, 0);
    b.sum_cols(cs + 1, a.part_db, fp(db), a.splits, a.N, a.N, 0);
  };
  auto colsum_m = [&](int cs, int s) {  // a stage's AdaLN-row sums into dmod
    b.sum_cols(cs, P.ml[s].part, dmod + (long long)mj[s] * C, splm,
             (long long)nb * 3 * C, 3LL * C, ld_dmod);
  };
  auto attn_bwd = [&](int s) {
    const long long S = (long long)vG[s] * vI[s];
    if (s == 0 && blocked) {
      const blockedbwd::Layout<D> lay(T);
      if (lay.total > (size_t)n[SMEM_LIMIT]) b.ok = false;
      b.add(BLOCKED, 2, S * H);
      b.need(lay.total);
    } else {
      b.add(ROPE_BWD, 2 + s, P.at[2 + s].bsh.blocks);
      b.need(P.at[2 + s].bsh.smem);
    }
  };
  auto attn_bias = [&](int cs, int s) {
    b.sum_cols(cs, fp(pb[s]), fp(s == 0 ? DBIAS_T : DBIAS_L), (long long)vG[s] * vI[s], 2LL * C,
             2LL * C, 0);
  };
  // P0
  const long long* ap = n + AD_PLAN;
  b.adaln(0, 0, ap); b.stats(2); b.adaln(2, 0, ap + 8); b.adaln(4, 0, ap + 16); b.stats(6);
  b.stats(10);
  b.prologue(0);  // dOUT * g8, which lb[1] shares
  // P1
  b.phase = 1;
  b.adaln(1, 1, ap + 4); b.wgrad(0); b.dgrad(1);
  for (int s = 0; s < 2; ++s) {
    b.add(ROPE_FWD, s, P.at[s].sh.blocks);
    b.need(P.at[s].sh.smem);
  }
  for (int i = 0; i < 3; ++i) b.prologue(pre_a[i]);
  // P2
  b.phase = 2;
  b.wgrad(2); b.dgrad(3); b.adaln(3, 1, ap + 12); b.adaln(5, 1, ap + 20); colsum_w(0, 0, DW2, DB2);
  // P3
  b.phase = 3;
  b.add(MODLN, 0, (long long)nb * splm); b.need(modln::smem_bytes<bf16, THREADS>(C)); colsum_w(2, 2, DW1, DB1);
  // P4-P8 frame, P9-P13 residue
  const int dbo[2] = {DBOUT_T, DBOUT_L}, dbq[2] = {DBQKV_T, DBQKV_L};
  for (int s = 0; s < 2; ++s) {
    const int ph = 4 + 5 * s, k = 4 + 4 * s, cs = 4 + 7 * s;
    b.phase = ph;
    colsum_m(cs, s);  // the previous stage's (MLP, then frame)
    b.prologue(k);    // the stage's gated cotangent, which lb[k + 1] shares
    b.phase = ph + 1;
    b.wgrad(k); b.dgrad(k + 1);
    b.phase = ph + 2;
    attn_bwd(s); colsum_w(cs + 1, k, dwo[s], dbo[s]);
    b.phase = ph + 3;
    b.wgrad(k + 2); b.dgrad(k + 3); attn_bias(cs + 3, s);
    b.phase = ph + 4;
    b.add(MODLN, s + 1, (long long)nb * splm); colsum_w(cs + 4, k + 2, dwq[s], dbq[s]);
  }
  // P14: the residue stage's AdaLN-row sums
  b.phase = 14;
  colsum_m(18, 2);
  if (!b.ok || b.smem > (size_t)n[SMEM_LIMIT]) return (int)cudaErrorInvalidValue;

  // ---- one cooperative launch: every block resident at once ----
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_layer_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)b.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_layer_bwd_kernel<D>, THREADS,
                                                      b.smem);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = sms * per_sm;
  info[0] = grid;
  info[1] = per_sm;
  info[2] = (long long)b.smem;
  void* args[] = {&b.P};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_layer_bwd_kernel<D>), dim3(grid),
                                  dim3(THREADS), args, b.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: the NPTR device pointers of enum Ptr; ints: the NINT integers of enum
// Int; info (host): grid, blocks per SM and dynamic shared memory of the
// launch. Returns a cudaError_t code (cudaErrorInvalidValue for a shape the
// merged kernel does not take).
extern "C" int fused_layer_bwd(const void* const* ptrs, const long long* ints, long long* info,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long C = ints[NC_], H = ints[NH_];
  if (H <= 0 || C % H) return (int)cudaErrorInvalidValue;
  switch (C / H) {
    case 16: return launch<16>(ptrs, ints, info, s);
    case 24: return launch<24>(ptrs, ints, info, s);
    case 32: return launch<32>(ptrs, ints, info, s);
    case 64: return launch<64>(ptrs, ints, info, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int fused_layer_bwd_slots(int which) { return which == 0 ? NPTR : NINT; }
