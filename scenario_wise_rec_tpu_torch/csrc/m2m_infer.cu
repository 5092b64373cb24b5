// Fused M2M eval forward after the transformer, for NVIDIA Hopper (sm_90a),
// f32 in and out: one kernel that runs a host-built list of steps.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/m2m_infer.py:
// m2m_fused_infer. M2M's transformer attends across the rows of a batch and
// stays in PyTorch; everything after it is per row:
//   scen, task = leakyrelu MLPs of the scenario embedding (width E),
//   x_n        = leakyrelu expert n of the transformer output (nE experts),
//   vw, vb     = leakyrelu MLPs of scen: the row's own [2E, 2E] meta matrix
//                (flat, 4E^2) and its bias,
//   score_n    = sum_f lrelu(vb[f] + sum_e [x_n ‖ task][e] vw[e, f]) v[f],
//   alpha      = softmax over the experts, rt = sum_n alpha_n x_n,
//   tw, tb     = leakyrelu MLPs of scen: the row's own [E, E] tower matrix
//                and bias,
//   h          = lrelu(tb + rt + rt tw), then the relu output MLP, its
//                head and the sigmoid.
// There is no domain select: every row runs the same weights.
//
// What bounds it on this card: arithmetic. At M2M's Ali-CCP shape (F = 376,
// Fd = 16, E = 16, 4 experts, output MLP [64, 32]) a row costs 48,896
// multiply-adds in products with shared weights (the experts 24,064, vw
// 16,384, tw 4,096, the output MLP 3,072, task, scen, vb and tb 1,280) and
// 4,576 against its own generated weights (the meta-attention 4,224, the mix
// and the meta-tower 320, the head 32): 0.438 GFLOP against 6.64 MB for B =
// 4096. The shared-weight products as three TF32 products each on the
// tensor cores take 3 x 0.4006 GFLOP / 495 TFLOP/s, the rest in f32 0.0375
// GFLOP / 67 TFLOP/s: 0.0030 ms; in f32 without tensor cores 0.0065 ms (H100
// SXM, 700 W); HBM bounds less (0.0020 ms).
//
// What the design does about it (the split, the mma products, the ring and
// its bulk copies are mma_ring.cuh's; the row gather, the slab of whole rows,
// the tensor copy of a box, the rotating accumulators, the tiles placed by
// their lifetimes, the 8-lane row sums and the head are domain_tiles.cuh's):
// - Row tiles, no partition: every row uses the same weights, so block j
//   takes rows j M .. j M + M - 1 (M = block_rows) and streams every weight
//   once (0.18 MB at Ali-CCP): 128 blocks of 32 rows at B 4096.
// - Every product with shared weights in 3xTF32 mma.sync, the weights
//   streamed slab by slab through the ring by a producer warp. The host lays
//   out a list of steps (scen, task, the experts, vb, vw, tb, tw, the output
//   MLP); the producer warp streams each product's W, the compute warps
//   consume the same list and meet at each step's end.
// - The experts' first stage is one product of all nE experts side by side
//   (64 columns at Ali-CCP: one n-tile a warp, so the 8 warps share every
//   k-step of the 376-deep product): a slab holds the same weight rows of
//   every expert, one bulk copy of whole rows an expert. Later expert stages
//   (and widths not a multiple of 8) are a product an expert. Each k-step's
//   three products go into a zeroed sum that is then added, rounded to
//   nearest, into the accumulators: the tensor core's own accumulation
//   rounds toward zero, and 141 such roundings in a row biased the experts by
//   a few ulp, which the softmax over the experts' scores amplified past
//   1e-5 of the probabilities at B 65,536 (PERF.md, section 6).
// - The generated matrices are never whole in shared memory. vw's last
//   stage (16 -> 1024: a tensor copy of a [16, 256] box a chunk) writes each
//   leakyrelu'd chunk of 256 columns into a staging tile; a row pass then adds
//   those columns into each row's meta sums [nE + 1, 2E] before the next
//   chunk lands: column c is row e = c / 2E, column f = c mod 2E of the row's
//   matrix; e < E adds x_n[e] vw[e, f] to every expert n's sum, e >= E adds
//   task[e - E] vw[e, f] once, to a sum that every expert shares. vb's
//   product writes vb where the task's sum goes, and the first chunk starts
//   every sum from it. A warp takes rows warp, warp + 8, ..., a lane a column
//   f of all of them (deterministic sums, no atomics), and loads 8 rows e of
//   each before it adds them. tw's last stage is staged the same way into h
//   = tb + rt + rt tw.
// - Scores, softmax and mix are a row pass of 8 lanes a row; the 1-wide head
//   is a warp a row.
// - The kernel is built twice for each tile: for M2M's own widths (E 16, 4
//   experts; the passes then have no division and no predicated expert) and
//   for any other E and expert count up to 8.
// - Shared memory: the host places the tiles by their lifetimes; the ring
//   takes what the peak leaves (at vw's last stage at Ali-CCP: scen, task,
//   the experts, the meta sums, the staging tile and rt, 600 floats a row:
//   77 KB at 32 rows; 64 rows fit).
// What holds it now (PERF.md, section 6): about a third of a block's
// cycles go to vw's four chunks (each a 2-k-step product, its store, two
// barriers and the pass), a fifth to the 376-deep expert product, a fifth to
// the five narrow products (2 k-steps, a wait and a barrier each whatever
// their width), the rest to the gather, tw's step and the head.
// Rows never mix: a NaN stays in its row. The last tile is partial; its
// missing rows are zero and never written out.
//
// Bound through ctypes: a plain C interface, every pointer and the stream as
// void*, the cudaError_t of the launch returned.

#include <math.h>

#include <algorithm>

#include "domain_tiles.cuh"

namespace {

using namespace ring;

constexpr int kMaxExperts = 8;  // the score pass keeps each expert's score in a register
constexpr int kMaxSteps = 40;   // products of a launch

// the chains, in the order of the stage list
enum Chain { kExpert, kTask, kScen, kVw, kVb, kTw, kTb, kOut, kChains };

enum Kind : unsigned char {
  kPlain,  // out[:, out_col + j] = act(x W + b)
  kMeta,   // vw's last stage: each chunk lrelu'd into the staging tile `out`,
           // then added into the meta sums; after the last, the scores and rt
  kTower,  // tw's last stage: each chunk likewise, added into h
};
enum Act : unsigned char { kRelu, kLrelu };

// A step: a product, then what its kind does.
struct Step {
  const float* w;  // W [K, N]; side > 1: W [side, K, N / side]
  const float* b;  // b [N] (side > 1: b [side, N / side], the same columns)
  int K, N;        // N: every output column (side > 1: all the members')
  int in, out;     // the input and output tiles: float offsets in the arena
  int in_col, out_col;  // the product reads from column in_col, writes from out_col
  int ld_in, ld_out;    // and their row strides
  short srows, sld;  // weight rows a slab (a multiple of 8) and their stride in a slot
  unsigned char kind, act;
  unsigned char side;   // > 1: that many members side by side, N / side columns each
  unsigned char whole;  // a slab is one bulk copy of whole rows (side: one a member)
  signed char map;      // a slab is one tensor copy of Args::map[map] (-1: whole or row copies)
};

struct Args {
  CUtensorMap map[kMaxMaps];  // W [K, N] of a product wider than a chunk, a box of
                              // kChunk columns by srows rows
  const float* t_out;  // [B, F]
  const float* dom;    // [B, Fd]
  const float* v;      // [2E]
  float* out;          // [B]
  const float* fw;     // the head W [kf, 1]
  const float* fb;     // b [1]
  int B, F, Fd, nE, E, n_steps;
  // tiles (float offsets in the arena) and their row strides
  int t, ld_t, d, ld_d;             // the gathered t_out and dom_emb
  int ex, ld_ex, task, ld_task;     // the experts (n at column n E) and task
  int acc, ld_acc;                  // the meta sums [nE + 1, 2E]: each expert's, the task's
  int rt, ld_rt, tb, ld_tb, h, ld_h;  // the mix, tb and the tower's h
  int hd, ld_hd, kf;                // the head's input and its width
  int arena, slot;                  // floats of the tiles and of a ring slot
  Step step[kMaxSteps];
};
static_assert(sizeof(Args) <= 4096, "the kernel parameters' limit");

// torch LeakyReLU(0.1), as where(x >= 0, x, 0.1 x): a NaN stays NaN
__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.1f * v; }

// The producer warp's part for a slab of a side-by-side product: rows k0 ..
// k0 + srows - 1 of every member's W [K, N / side], member e's as one bulk
// copy into the slot at e srows (N / side), rows from K up to K rounded to 8
// zero. Each lane arrives on the slot's full barrier, which completes when
// every member's rows have landed.
__device__ __forceinline__ void copy_side(const Step& st, int k0, float* slot, uint32_t full,
                                          int lane) {
  const int nm = st.N / st.side, blk = st.srows * nm;
  const int rows = min(static_cast<int>(st.srows), st.K - k0);
  const int pad = (min(static_cast<int>(st.srows), round_up(st.K, 8) - k0) - rows) * nm;
  for (int i = lane; i < st.side * pad; i += 32) slot[(i / pad) * blk + rows * nm + i % pad] = 0.f;
  // the slot's earlier reads (generic proxy) before the copies' writes (async)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint32_t bytes = static_cast<uint32_t>(rows * nm * 4);
  if (lane == 0) bar_arrive_tx(full, bytes * st.side);
  __syncwarp();
  if (lane < st.side)
    bulk_row(smem_addr(slot + lane * blk),
             st.w + (static_cast<size_t>(lane) * st.K + k0) * nm, bytes, full);
  if (lane != 0) bar_arrive(full);
}

// One slab of a side-by-side product on the compute warps: warp j owns
// n-tile j (columns 8j .. 8j + 7 of member 8j / nm), its k-steps in turn into
// kNTW sets of accumulators (domain_tiles.cuh's mma_slab_rot for one n-tile
// a warp, its B read from the member's block); fold<MT, 1> sums the sets.
template <int MT>
__device__ __forceinline__ void mma_side(const float* A, int lda, int k0, int K, int srows,
                                         const float* Ws, int nm, int nt,
                                         float (&acc)[MT][kNTW][4], int warp, int g, int t) {
  if (warp >= nt) return;
  const float* B = Ws + (warp * 8 / nm) * srows * nm + (warp * 8) % nm + g;
  const int steps = min(srows / 8, (K - k0 + 7) / 8);
  for (int s0 = 0; s0 < steps; s0 += kNTW) {
#pragma unroll
    for (int r = 0; r < kNTW; ++r) {
      if (s0 + r < steps) {
        const int kk = 8 * (s0 + r);
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float* a = A + (m * 16 + g) * lda + k0 + kk + t;
          split(a[0], ah[m][0], al[m][0]);
          split(a[8 * lda], ah[m][1], al[m][1]);
          split(a[4], ah[m][2], al[m][2]);
          split(a[8 * lda + 4], ah[m][3], al[m][3]);
        }
        const float* b = B + (kk + t) * nm;
        uint32_t bh0, bl0, bh1, bl1;
        split(b[0], bh0, bl0);
        split(b[4 * nm], bh1, bl1);
        // the k-step's three products into a zeroed sum, then added (rounded
        // to nearest) into the accumulators: the tensor core's own f32
        // accumulation rounds toward zero, and 141 of them in a row bias a
        // 376-deep product by a few ulp, which the softmax over the experts'
        // scores amplifies
        float d[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) d[m][0] = d[m][1] = d[m][2] = d[m][3] = 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_tf32(d[m], al[m], bh0, bh1);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_tf32(d[m], ah[m], bl0, bl1);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_tf32(d[m], ah[m], bh0, bh1);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][r][e] += d[m][e];
      }
    }
  }
}

// A finished chunk of a product: out = act(acc + bias) (rows of the tile,
// columns c0 + the warp's n-tiles; columns past N come out act(0) = 0).
// `pair`: out is 8-byte aligned. Resets the accumulators.
template <int MT>
__device__ __forceinline__ void store_chunk(float (&acc)[MT][kNTW][4],
                                            const float (&bias)[kNTW][2], int act, bool pair,
                                            int nt, int c0, float* out, int ldo, int warp, int g,
                                            int t) {
#pragma unroll
  for (int i = 0; i < kNTW; ++i) {
    const int j = warp + kWarps * i;
    if (j < nt) {
      const int col = c0 + j * 8 + 2 * t;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m-tile
          float v0 = acc[m][i][2 * h] + bias[i][0], v1 = acc[m][i][2 * h + 1] + bias[i][1];
          acc[m][i][2 * h] = acc[m][i][2 * h + 1] = 0.f;
          if (act == kRelu) {
            v0 = relu(v0);
            v1 = relu(v1);
          } else {
            v0 = lrelu(v0);
            v1 = lrelu(v1);
          }
          float* o = out + (m * 16 + g + 8 * h) * ldo + col;
          if (pair) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            o[1] = v1;
          }
        }
      }
    }
  }
}

constexpr int kRowsE = 8;  // rows e of a generated matrix a pass loads before it adds them

// The widths a pass runs at: E and nE of the launch, compile-time where the
// kernel is built for them (kE, kNE > 0: M2M's own E 16 and 4 experts, whose
// passes then have no division and no predicated expert), else Args'.
template <int kE, int kNE>
struct Widths {
  int E, nE;
  __device__ __forceinline__ explicit Widths(const Args& p)
      : E(kE ? kE : p.E), nE(kNE ? kNE : p.nE) {}
};

// vw's columns c0 .. c1 - 1 (the staging tile `stage`, column c - c0) into
// the meta sums: column c = e 2E + f adds x_n[e] vw[e, f] to each expert's
// sum for e < E, task[e - E] vw[e, f] to the task's for e >= E. A warp takes
// rows warp, warp + kWarps, ... (R of them), a lane column f of all R rows,
// so the sums are deterministic and each row's R chains of FMAs run side by
// side; the chunk's rows e are loaded kRowsE at a time before their sums. The
// first chunk first starts every expert's sum at vb[f] (where the task's sum
// goes, written there by vb's product) and the task's at 0.
template <int M, int kE, int kNE>
__device__ __forceinline__ void meta_pass(const Args& p, float* arena, const float* stage,
                                          int ld_stage, int c0, int c1, bool first) {
  constexpr int R = M / kWarps;
  const Widths<kE, kNE> w(p);
  const int E = w.E, E2 = 2 * E, nE = w.nE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sums[R];
  const float *x[R], *task[R], *st[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp + kWarps * i;
    sums[i] = arena + p.acc + r * p.ld_acc;  // [nE + 1, 2E]: each expert's, the task's
    x[i] = arena + p.ex + r * p.ld_ex;
    task[i] = arena + p.task + r * p.ld_task;
    st[i] = stage + r * ld_stage - c0;  // st[i][c]: column c of the chunk
  }
  for (int f = lane; f < E2; f += 32) {
    if (first) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float b = sums[i][nE * E2 + f];
        for (int n = 0; n < nE; ++n) sums[i][n * E2 + f] = b;
        sums[i][nE * E2 + f] = 0.f;
      }
    }
    // the rows e whose column f lies in the chunk
    const int e_lo = (c0 - f + E2 - 1) / E2, e_hi = (c1 - f + E2 - 1) / E2;
    for (int e0 = e_lo; e0 < e_hi; e0 += kRowsE) {
      float we[R][kRowsE];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < kRowsE; ++j)
          we[i][j] = e0 + j < e_hi ? st[i][(e0 + j) * E2 + f] : 0.f;
      const int ex_hi = min(e_hi, E);  // rows e < E: the experts'
      if (e0 < ex_hi) {
#pragma unroll
        for (int n = 0; n < nE; ++n) {
          float a[R];
#pragma unroll
          for (int i = 0; i < R; ++i) a[i] = sums[i][n * E2 + f];
#pragma unroll
          for (int j = 0; j < kRowsE; ++j)
            if (e0 + j < ex_hi)
#pragma unroll
              for (int i = 0; i < R; ++i) a[i] = fmaf(x[i][n * E + e0 + j], we[i][j], a[i]);
#pragma unroll
          for (int i = 0; i < R; ++i) sums[i][n * E2 + f] = a[i];
        }
      }
      if (e0 + kRowsE > E) {  // rows e >= E: the task's
        float a[R];
#pragma unroll
        for (int i = 0; i < R; ++i) a[i] = sums[i][nE * E2 + f];
#pragma unroll
        for (int j = 0; j < kRowsE; ++j) {
          const int e = e0 + j;
          if (e >= E && e < e_hi)
#pragma unroll
            for (int i = 0; i < R; ++i) a[i] = fmaf(task[i][e - E], we[i][j], a[i]);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) sums[i][nE * E2 + f] = a[i];
      }
    }
  }
}

// score_n = sum_f lrelu(meta_n[f] + task[f]) v[f], alpha = softmax over the
// experts, rt = sum_n alpha_n x_n: 8 lanes a row, a warp 4 rows side by side;
// a lane takes columns f = q8 + 8j, 4 of them at a time for every expert.
template <int M, int kE, int kNE>
__device__ __forceinline__ void score_pass(const Args& p, float* arena) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, q8 = lane & 7;
  const Widths<kE, kNE> w(p);
  const int E = w.E, E2 = 2 * E, nE = w.nE;
  for (int r = 4 * warp + lane / 8; r < M; r += 4 * kWarps) {
    const float* sums = arena + p.acc + r * p.ld_acc;
    const float* task = sums + nE * E2;
    float s[kMaxExperts];
#pragma unroll
    for (int n = 0; n < kMaxExperts; ++n) s[n] = 0.f;
    for (int f0 = q8; f0 < E2; f0 += 32) {
      float tv[4], vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + 8 * j;
        tv[j] = f < E2 ? task[f] : 0.f;
        vv[j] = f < E2 ? __ldg(p.v + f) : 0.f;
      }
#pragma unroll
      for (int n = 0; n < kMaxExperts; ++n)
        if (n < nE)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (f0 + 8 * j < E2) s[n] = fmaf(lrelu(sums[n * E2 + f0 + 8 * j] + tv[j]), vv[j], s[n]);
    }
    // the sums over the row's 8 lanes, every expert's shuffles side by side
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
#pragma unroll
      for (int n = 0; n < kMaxExperts; ++n)
        if (n < nE) s[n] += __shfl_xor_sync(0xffffffffu, s[n], o);
    float mx = -INFINITY, sum = 0.f;
#pragma unroll
    for (int n = 0; n < kMaxExperts; ++n)
      if (n < nE) mx = fmaxf(mx, s[n]);
#pragma unroll
    for (int n = 0; n < kMaxExperts; ++n) {
      if (n < nE) {
        s[n] = expf(s[n] - mx);
        sum += s[n];
      }
    }
#pragma unroll
    for (int n = 0; n < kMaxExperts; ++n) s[n] /= sum;
    const float* x = arena + p.ex + r * p.ld_ex;
    for (int e = q8; e < E; e += 8) {
      float m = s[0] * x[e];
#pragma unroll
      for (int n = 1; n < kMaxExperts; ++n)
        if (n < nE) m = fmaf(s[n], x[n * E + e], m);
      arena[p.rt + r * p.ld_rt + e] = m;
    }
  }
}

// tw's columns c0 .. c1 - 1 (column e E + f) into h[f] = tb[f] + rt[f] +
// sum_e rt[e] tw[e, f], rows and columns taken as meta_pass takes them;
// after the last chunk h = lrelu(h). Columns E up to E rounded to 8 are zero
// (the next product's k-steps read them).
template <int M, int kE, int kNE>
__device__ __forceinline__ void tower_pass(const Args& p, float* arena, const float* stage,
                                           int ld_stage, int c0, int c1, bool first, bool last) {
  constexpr int R = M / kWarps;
  const int E = Widths<kE, kNE>(p).E, E8 = round_up(E, 8);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* h[R];
  const float *rt[R], *st[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp + kWarps * i;
    h[i] = arena + p.h + r * p.ld_h;
    rt[i] = arena + p.rt + r * p.ld_rt;
    st[i] = stage + r * ld_stage - c0;
  }
  for (int f = lane; f < E8; f += 32) {
    if (f >= E) {
#pragma unroll
      for (int i = 0; i < R; ++i) h[i][f] = 0.f;
      continue;
    }
    float a[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      a[i] = first ? arena[p.tb + (warp + kWarps * i) * p.ld_tb + f] + rt[i][f] : h[i][f];
    const int e_lo = (c0 - f + E - 1) / E, e_hi = (c1 - f + E - 1) / E;
    for (int e0 = e_lo; e0 < e_hi; e0 += kRowsE) {
      float we[R][kRowsE], re[R][kRowsE];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < kRowsE; ++j) {
          we[i][j] = e0 + j < e_hi ? st[i][(e0 + j) * E + f] : 0.f;
          re[i][j] = e0 + j < e_hi ? rt[i][e0 + j] : 0.f;
        }
#pragma unroll
      for (int j = 0; j < kRowsE; ++j)
        if (e0 + j < e_hi)
#pragma unroll
          for (int i = 0; i < R; ++i) a[i] = fmaf(re[i][j], we[i][j], a[i]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) h[i][f] = last ? lrelu(a[i]) : a[i];
  }
}

template <int MT, int kE, int kNE>
__global__ void __launch_bounds__(kThreads, 1)
m2m_fused_infer_kernel(const __grid_constant__ Args p) {
  constexpr int M = MT * 16;
  extern __shared__ __align__(128) float smem[];
  const uint32_t full = smem_addr(smem);     // [kRing] barriers: the slot has landed
  const uint32_t empty = full + 8 * kRing;   // [kRing] barriers: the slot has been read
  float* ring = smem + kHeadBytes / 4;       // [kRing, slot], each slot 128-byte aligned
  float* arena = ring + kRing * p.slot;      // the tiles, each [M, its ld]
  int* rows_s = reinterpret_cast<int*>(arena + p.arena);  // [M] the block's rows

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * M, n_rows = min(M, p.B - row0);

  // 1. the block's rows and the ring's barriers
  for (int r = threadIdx.x; r < M; r += kThreads) rows_s[r] = row0 + r;
  if (threadIdx.x < kRing) {
    bar_init(full + 8 * threadIdx.x, 32);       // the producer warp's lanes
    bar_init(empty + 8 * threadIdx.x, kWarps);  // a lane of each compute warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // 2. the t_out and dom_emb tiles (rows past n_rows and pad columns zero)
  gather_rows<M>(p.t_out, p.F, p.ld_t, rows_s, n_rows, arena + p.t);
  gather_rows<M>(p.dom, p.Fd, p.ld_d, rows_s, n_rows, arena + p.d);
  __syncthreads();

  if (warp == kWarps) {
    // 3p. the producer warp: each product's W, slab by slab, through the
    //     ring, as far ahead as the compute warps free slots
    int s = 0;
    for (int q = 0; q < p.n_steps; ++q) {
      const Step& st = p.step[q];
      for (int c = 0; c * kChunk < st.N; ++c) {
        for (int k0 = 0; k0 < st.K; k0 += st.srows, ++s) {
          const int slot = s % kRing;
          float* sl = ring + slot * p.slot;
          bar_wait(empty + 8 * slot, ((s / kRing) & 1) ^ 1);  // the first pass finds it free
          if (st.side > 1)
            copy_side(st, k0, sl, full + 8 * slot, lane);
          else if (st.map >= 0)
            tensor_slab(&p.map[st.map], 0, st.srows, c, k0, sl, full + 8 * slot, lane);
          else
            issue_product_slab(st.w, 0, st.K, st.N, st.srows, st.sld, st.whole, c, k0, sl,
                               full + 8 * slot, lane);
        }
      }
    }
  } else {
    // 3. the steps in order: each product from the ring, then what its kind does
    float acc[MT][kNTW][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < kNTW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;
    float bias[kNTW][2];
    int s = 0;
    for (int q = 0; q < p.n_steps; ++q) {
      const Step& st = p.step[q];
      const bool staged = st.kind != kPlain;
      const float* A = arena + st.in + st.in_col;
      float* o = arena + st.out + (staged ? 0 : st.out_col);
      for (int c = 0; c * kChunk < st.N; ++c) {
        const int c0 = c * kChunk, wc = min(kChunk, st.N - c0);
        const int nt = (wc + 7) / 8;
        const int tiles = (nt + kWarps - 1) / kWarps;  // n-tiles a warp
        load_bias(bias, st.b, nt, c0, st.N, warp, t);
        for (int k0 = 0; k0 < st.K; k0 += st.srows, ++s) {
          const int slot = s % kRing;
          bar_wait(full + 8 * slot, (s / kRing) & 1);  // slab s has landed
          if (st.side > 1)
            mma_side<MT>(A, st.ld_in, k0, st.K, st.srows, ring + slot * p.slot, st.N / st.side,
                         nt, acc, warp, g, t);
          else
            mma_any<MT>(tiles, A, st.ld_in, k0, st.K, st.srows, ring + slot * p.slot, st.sld, nt,
                        acc, warp, g, t);
          __syncwarp();
          if (lane == 0) bar_arrive(empty + 8 * slot);  // this warp is done with the slot
        }
        if (st.side > 1)
          fold<MT, 1>(acc);
        else
          fold_any<MT>(tiles, acc);
        store_chunk<MT>(acc, bias, st.act, (st.out_col & 1) == 0, nt, staged ? 0 : c0, o,
                        st.ld_out, warp, g, t);
        if (staged) {
          compute_sync();  // the chunk, before its pass reads it
          if (st.kind == kMeta)
            meta_pass<M, kE, kNE>(p, arena, o, st.ld_out, c0, c0 + wc, c == 0);
          else
            tower_pass<M, kE, kNE>(p, arena, o, st.ld_out, c0, c0 + wc, c == 0,
                                   c0 + wc >= st.N);
        }
        // the product's output (or the pass's), before the next product or
        // chunk reads or overwrites it
        if (staged || c0 + wc >= st.N) compute_sync();
      }
      if (st.kind == kMeta) {
        score_pass<M, kE, kNE>(p, arena);
        compute_sync();
      }
    }
  }
  __syncthreads();

  // 4. the head and the sigmoid, a warp a row
  head_rows(arena + p.hd, p.ld_hd, p.kf, p.fw, p.fb, 0, rows_s, n_rows, p.out);
}

size_t smem_bytes(int tb, int arena_row, int slot) {
  const size_t floats = static_cast<size_t>(tb) * arena_row + static_cast<size_t>(kRing) * slot;
  return kHeadBytes + floats * sizeof(float) + static_cast<size_t>(tb) * sizeof(int);
}

template <int MT, int kE, int kNE>
cudaError_t launch_widths(const Args& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(m2m_fused_infer_kernel<MT, kE, kNE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (p.B + MT * 16 - 1) / (MT * 16);
  m2m_fused_infer_kernel<MT, kE, kNE><<<tiles, kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

// M2M's own widths (E 16, 4 experts) take the kernel built for them
template <int MT>
cudaError_t launch(const Args& p, size_t smem, cudaStream_t stream) {
  return p.E == 16 && p.nE == 4 ? launch_widths<MT, 16, 4>(p, smem, stream)
                                : launch_widths<MT, 0, 0>(p, smem, stream);
}

// The steps and their activation tiles, laid out on the host.
struct Plan {
  Tiles T;
  Step steps[kMaxSteps];
  int in_t[kMaxSteps], out_t[kMaxSteps];
  int n = 0;
  bool full = false;  // more than kMaxSteps products

  // the next step: the product of tile x from column in_col by W [K, N] + b,
  // into tile `into` from column out_col
  void add(Kind kind, Act act, const float* w, const float* b, int K, int N, int x, int in_col,
           int into, int out_col, int side = 1) {
    if (n == kMaxSteps) {
      full = true;
      return;
    }
    Step& st = steps[n];
    st = Step{};
    st.w = w;
    st.b = b;
    st.K = K;
    st.N = N;
    st.in_col = in_col;
    st.out_col = out_col;
    st.kind = kind;
    st.act = act;
    st.side = static_cast<unsigned char>(side);
    in_t[n] = x;
    out_t[n] = into;
    T.use(into, n);
    T.use(x, n);
    ++n;
  }
};

}  // namespace

extern "C" {

// t_out [B, F], dom_emb [B, Fd] f32. counts: the stages of the expert, task,
// scenario, vw, vb, tw, tb and output chains (8 ints); the head follows them.
// w_ptrs/b_ptrs: host arrays of device pointers, one per stage, in that order
// (the expert stages stacked [nE, in, out]); dims: (K, N) per stage. v [2E].
// block_rows: rows of one block, a multiple of 16 up to 64, or 0: 32 where a
// 32-row tile fits in shared memory, else 16. Writes the dynamic shared
// memory a block of the tile it tried takes to *smem and returns a
// cudaError_t (cudaErrorInvalidValue when that tile does not fit).
int m2m_fused_infer_f32(const void* t_out, const void* dom_emb, void* out, int B, int F,
                        int Fd, int nE, int E, const void* counts, const void* v,
                        const void* w_ptrs, const void* b_ptrs, const void* dims,
                        int block_rows, void* stream, size_t* smem) {
  *smem = 0;
  const int* cnt = static_cast<const int*>(counts);
  if (B < 0 || F < 1 || Fd < 1 || nE < 1 || nE > kMaxExperts || E < 1 || block_rows < 0 ||
      block_rows % 16 != 0 || block_rows > 16 * kMaxMT)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* const* ws = static_cast<const float* const*>(w_ptrs);
  const float* const* bs = static_cast<const float* const*>(b_ptrs);
  const int* dm = static_cast<const int*>(dims);
  // each chain runs from its input width to the width the next step needs
  const int start[kChains] = {F, Fd, Fd, E, E, E, E, E};
  const int end[kChains] = {E, E, E, 4 * E * E, 2 * E, E * E, E, -1};
  int first[kChains + 1];  // each chain's first stage; the head last
  first[0] = 0;
  for (int i = 0; i < kChains; ++i) {
    if (cnt[i] < (i == kOut ? 0 : 1) || cnt[i] > kMaxSteps)
      return static_cast<int>(cudaErrorInvalidValue);
    first[i + 1] = first[i] + cnt[i];
    int width = start[i];
    for (int s = first[i]; s < first[i + 1]; ++s) {
      if (ws[s] == nullptr || bs[s] == nullptr || dm[2 * s] != width || dm[2 * s + 1] < 1)
        return static_cast<int>(cudaErrorInvalidValue);
      width = dm[2 * s + 1];
    }
    if (end[i] >= 0 && width != end[i]) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hs = first[kChains];  // the head
  const int kf = cnt[kOut] ? dm[2 * (hs - 1) + 1] : E;
  if (ws[hs] == nullptr || bs[hs] == nullptr || dm[2 * hs] != kf || dm[2 * hs + 1] != 1)
    return static_cast<int>(cudaErrorInvalidValue);

  // the steps and their tiles: a tile written by a product from column
  // out_col holds its N columns rounded to 8 (the next product's k-steps
  // read them)
  Plan plan;
  Tiles& T = plan.T;
  const int t_tile = T.add(F, -1), d_tile = T.add(Fd, -1);  // gathered before the first step
  // a chain of leakyrelu stages from tile x; the last into a new tile, into
  // tile `into` from column `col`, or (kind kMeta, kTower) through a new
  // staging tile of one chunk
  auto chain = [&](int c, int x, Kind last, int into = -1, int col = 0) {
    for (int s = first[c]; s < first[c + 1]; ++s) {
      const int K = dm[2 * s], N = dm[2 * s + 1];
      const bool end = s == first[c + 1] - 1, staged = end && last != kPlain;
      const int y = end && into >= 0 ? into
                    : T.add(staged ? std::min(kChunk, round_up(N, 8)) : N, plan.n);
      plan.add(staged ? last : kPlain, kLrelu, ws[s], bs[s], K, N, x, 0, y, end ? col : 0);
      x = y;
    }
    return x;
  };
  const int scen = chain(kScen, d_tile, kPlain);
  const int task = chain(kTask, d_tile, kPlain);
  // the experts: the first stage side by side where each member's width is a
  // multiple of 8 and all of them make at most one n-tile a warp, else (and
  // later stages) a product an expert, expert n's columns from n N
  int x = t_tile, xK = F;
  for (int s = first[kExpert]; s < first[kExpert + 1]; ++s) {
    const int K = dm[2 * s], N = dm[2 * s + 1];
    const int y = T.add((nE - 1) * N + round_up(N, 8), plan.n);
    const bool side = s == first[kExpert] && nE > 1 && N % 8 == 0 && nE * N <= 8 * kWarps &&
                      (reinterpret_cast<uintptr_t>(ws[s]) & 15) == 0;
    if (side) {
      plan.add(kPlain, kLrelu, ws[s], bs[s], K, nE * N, x, 0, y, 0, nE);
    } else {
      for (int e = 0; e < nE; ++e)
        plan.add(kPlain, kLrelu, ws[s] + static_cast<size_t>(e) * K * N, bs[s] + e * N, K, N, x,
                 x == t_tile ? 0 : e * xK, y, e * N);
    }
    x = y;
    xK = N;
  }
  const int ex = x;
  // the meta sums [nE + 1, 2E]: vb's last step writes vb where the task's
  // sum goes, from which vw's first chunk starts every sum
  const int acc = T.add(nE * 2 * E + round_up(2 * E, 8), plan.n + cnt[kVb] - 1);
  chain(kVb, scen, kPlain, acc, nE * 2 * E);
  // vw's last step's passes read the experts and task and write the meta
  // sums, then rt
  chain(kVw, scen, kMeta);
  const int meta_step = plan.n - 1;
  const int rt = T.add(E, meta_step);
  for (int i : {ex, task, acc}) T.use(i, meta_step);
  const int tb = chain(kTb, scen, kPlain);
  // tw's last step's pass: it reads rt and tb and writes h
  chain(kTw, scen, kTower);
  const int tower_step = plan.n - 1;
  const int h = T.add(E, tower_step);
  for (int i : {rt, tb}) T.use(i, tower_step);
  int hd = h;
  for (int s = first[kOut]; s < first[kOut + 1]; ++s) {
    const int y = T.add(dm[2 * s + 1], plan.n);
    plan.add(kPlain, kRelu, ws[s], bs[s], dm[2 * s], dm[2 * s + 1], hd, 0, y, 0);
    hd = y;
  }
  if (plan.full) return static_cast<int>(cudaErrorInvalidValue);
  T.use(hd, plan.n);
  const int arena_row = T.place();

  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t budget = static_cast<size_t>(optin);
  auto ring_slot = [&](int tb_rows) {
    return size_ring(plan.steps, plan.n, smem_bytes(tb_rows, arena_row, 0), budget);
  };
  if (block_rows == 0) block_rows = smem_bytes(32, arena_row, ring_slot(32)) <= budget ? 32 : 16;
  const int slot = ring_slot(block_rows);
  *smem = smem_bytes(block_rows, arena_row, slot);
  if (*smem > budget) return static_cast<int>(cudaErrorInvalidValue);

  Args p = {};
  const int M = block_rows;
  auto at = [&](int i) { return M * T.t[i].at; };
  auto ld = [&](int i) { return ld_act(T.t[i].width); };
  for (int q = 0; q < plan.n; ++q) {
    Step& st = plan.steps[q];
    st.in = at(plan.in_t[q]);
    st.ld_in = ld(plan.in_t[q]);
    st.out = at(plan.out_t[q]);
    st.ld_out = ld(plan.out_t[q]);
    if (st.map >= 0 && !encode_map(st.w, st.K, st.N, 1, st.srows, &p.map[st.map]))
      return static_cast<int>(cudaErrorNotSupported);
    p.step[q] = st;
  }
  p.t_out = static_cast<const float*>(t_out);
  p.dom = static_cast<const float*>(dom_emb);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.fw = ws[hs];
  p.fb = bs[hs];
  p.B = B; p.F = F; p.Fd = Fd; p.nE = nE; p.E = E;
  p.n_steps = plan.n;
  p.t = at(t_tile); p.ld_t = ld(t_tile);
  p.d = at(d_tile); p.ld_d = ld(d_tile);
  p.ex = at(ex); p.ld_ex = ld(ex);
  p.task = at(task); p.ld_task = ld(task);
  p.acc = at(acc); p.ld_acc = ld(acc);
  p.rt = at(rt); p.ld_rt = ld(rt);
  p.tb = at(tb); p.ld_tb = ld(tb);
  p.h = at(h); p.ld_h = ld(h);
  p.hd = at(hd); p.ld_hd = ld(hd);
  p.kf = kf;
  p.arena = M * arena_row;
  p.slot = slot;

  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  switch (block_rows / 16) {
    case 1: err = launch<1>(p, *smem, strm); break;
    case 2: err = launch<2>(p, *smem, strm); break;
    case 3: err = launch<3>(p, *smem, strm); break;
    default: err = launch<4>(p, *smem, strm); break;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch's check
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
