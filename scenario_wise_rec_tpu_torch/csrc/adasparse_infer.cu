// Fused AdaSparse and EPNet eval forwards for NVIDIA Hopper (sm_90a), f32 in
// and out: one kernel that runs a host-built list of steps.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/gated_infer.py:
// adasparse_fused_infer. Per row, from the scenario embedding s [S] and the
// agnostic embedding a [A]:
//   a'  = prune([s ‖ a] P_0) · a,
//   h_0 = relu([s ‖ a'] W_0 + b_0),           h_0 = prune([s ‖ h_0] P_1) · h_0,
//   h_i = relu(h_{i-1} W_i + b_i),            h_i = prune([s ‖ h_i] P_i+1) · h_i,
//   out = sigmoid(h W_f + b_f)                (with no layers, the head on [s ‖ a']).
// prune(v) is sign(sigmoid(v) - eps) (Binarization) or beta sigmoid(v)
// sign(beta sigmoid(v) - eps) (Scaling, Fusion; alpha is folded into the P_i
// outside the kernel), with sign(0) = 0. BatchNorm is folded into W_i, b_i
// outside the kernel (folding.py).
//
// And the TPU kernel gated_infer.py:epnet_fused_infer, three of those steps'
// kind: h = relu([s ‖ a] W1 + b1) (a hidden layer), a' = a · gemma
// sigmoid(h W2 + b2) (a gate), out = sigmoid(a' Wo + bo) (the head).
//
// What bounds it on this card: arithmetic. At Ali-CCP (S 16, A 352, layers
// [256, 128, 64, 32, 16, 8], a pruner before the layers and after each) a row
// costs 362,824 multiply-adds (the 7 pruners 224,960, pruner 0 alone 129,536;
// the 6 layers 137,856; the head 8) against ~1.5 KB of its own data: 2.979
// GFLOP against 7.50 MB for B = 4096. As three TF32 products each on the
// tensor cores that is 3 x 2.972 GFLOP / 495 TFLOP/s = 0.018 ms; in f32
// without tensor cores 0.0445 ms at 67 TFLOP/s (H100 SXM, 700 W); HBM bounds
// less (0.0022 ms). EPNet at Ali-CCP (S 16, A 360, gate 376 -> 360 -> 360,
// head 360 -> 1) costs 265,320 a row: 2.176 GFLOP, 0.0132 ms in 3xTF32,
// 0.0325 ms in f32.
//
// What the design does about it (the split, the mma products, the ring and
// its bulk copies are mma_ring.cuh's; the row gather, the slab of whole rows,
// the tensor copy of a box, the rotating accumulators, the tiles placed by
// their lifetimes and the head are domain_tiles.cuh's, shared with
// ppnet_infer.cu and m3oe_infer.cu):
// - Row tiles, no partition: every row uses the same weights, so block j
//   takes rows j M .. j M + M - 1 (M = block_rows) and streams every weight
//   once, 1.45 MB at Ali-CCP (EPNet's 1.06 MB): 128 blocks of 32 rows at B
//   4096, ~186 MB (~136 MB) from L2 a call.
// - Every product in 3xTF32 mma.sync (f32's accuracy: a pruner thresholds
//   its input, so the error of its product must stay at f32's), the weights
//   streamed slab by slab through the ring by a producer warp. The host lays
//   out a list of steps, each a product (K, N, W, b, input and output tiles)
//   and what follows it; the producer warp streams each product's W, the
//   compute warps consume the same list and meet at each step's end. A slab
//   is one copy: whole rows (N a multiple of 8 up to kChunk) one bulk copy,
//   a product wider than a chunk (pruner 0, 352 wide at Ali-CCP; EPNet's two
//   360-wide gate products) one tensor copy of a [srows, kChunk] box; other
//   widths the bulk or cp.async copy a row (right, not fast).
// - [s ‖ x] as one operand: each activation tile keeps s in its first S
//   columns, so a pruner (and EPNet's gate l1) reads [s ‖ x] as one K loop,
//   and the next layer reads the same tile from column S. A layer's epilogue
//   adds the bias and applies relu; it copies s into its output tile and
//   zeroes the columns past its product that the next pruner's k-steps read.
//   A hidden layer (EPNet's gate l1) writes a plain tile, no s.
// - A pruner's output v is written whole to its own tile (each chunk of it
//   reads all of x), then a pass of 8 lanes a row multiplies prune(v) into x
//   in place. A gate's product reads another tile (h), never the one it
//   multiplies, so its epilogue multiplies gemma sigmoid(v) into [s ‖ a]'s
//   column S + j for its output column j in place: no v tile, pass or
//   barrier.
// - Shared memory: the host places the tiles by their lifetimes; the ring
//   takes what the peak leaves ([s ‖ a] and pruner 0's output, 744 floats a
//   row at Ali-CCP: 95 KB at 32 rows; EPNet's [s ‖ a] and h, 776 floats).
//   The 1-wide head is a warp a row.
// What holds it now (PERF.md, section 6): on an H100 it reaches about a
// sixth of the 3xTF32 bound. Pruner 0 takes two fifths of the time (its
// 96-column second chunk nearly as long as its first: the A fragments are
// loaded and split once a chunk); the narrow steps pay a wait, two barriers
// and a pass each whatever their width; the wide products run at the rate of
// the fragment loads, splits and mma.sync issue.
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

constexpr int kMaxLayers = 30;                   // layers of the stack
constexpr int kMaxSteps = 2 * kMaxLayers + 1;    // products: the pruners and the layers

enum Kind : unsigned char {
  kPruner,  // out = v = x_in P, then x_in[:, S:] *= prune(v) in place
  kLayer,   // out[:, S:] = relu(x_in W + b), out[:, :S] = in[:, :S] (s)
  kHidden,  // out = relu(x_in W + b), a plain tile (EPNet's gate l1)
  kGate,    // out[:, S + j] *= gemma sigmoid((x_in W + b)[:, j]) in the epilogue
            // (EPNet's gate l2; out is the [s ‖ a] tile, x_in another)
};

// A step: a product, then what follows it.
struct Step {
  const float* w;    // W [K, N]
  const float* b;    // b [N]; null for a pruner
  int K, N;
  int in, out;       // the input and output tiles: float offsets in the arena
  short ld_in, ld_out;  // and their row strides
  short srows, sld;  // weight rows a slab (a multiple of 8) and their stride in a slot
  unsigned char kind;
  unsigned char from_s;  // the product reads its input from column S (layers after the first)
  unsigned char whole;   // a slab is one bulk copy of whole rows, kept at stride N
  signed char map;       // a slab is one tensor copy of Args::map[map] (-1: whole or row copies)
};

struct Args {
  CUtensorMap map[kMaxMaps];  // W [K, N] of a product wider than a chunk, a box of
                              // kChunk columns by srows rows
  const float* sce;  // [B, S]
  const float* agn;  // [B, A]
  float* out;        // [B]
  const float* fw;   // the head W [kf, 1]
  const float* fb;   // b [1]
  int B, S, A, form, n_steps;
  float eps, beta, gemma;
  int xa, ld_xa;     // the [s ‖ a] tile
  int h, ld_h, kf;   // the head's input: its first column, row stride and width
  int arena, slot;   // floats of the tiles and of a ring slot
  Step step[kMaxSteps];
};
static_assert(sizeof(Args) <= 4096, "the kernel parameters' limit");

// sign() that is 0 at 0, as jnp.sign and torch.sign are (copysignf is not)
__device__ __forceinline__ float sgn(float v) { return static_cast<float>((v > 0.f) - (v < 0.f)); }

__device__ __forceinline__ float prune(float v, int form, float eps, float beta) {
  if (form == 0) return sgn(sigmoid(v) - eps);  // Binarization
  const float vo = beta * sigmoid(v);
  return vo * sgn(vo - eps);
}

// A finished chunk of a product: out = acc + bias, relu'd for a layer (rows
// of the tile, columns c0 + the warp's n-tiles; columns past N come out
// zero). `pair`: out is 8-byte aligned. Resets the accumulators.
template <int MT>
__device__ __forceinline__ void store_chunk(float (&acc)[MT][kNTW][4],
                                            const float (&bias)[kNTW][2], bool act, bool pair,
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
          if (act) {
            v0 = relu(v0);
            v1 = relu(v1);
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

// A finished chunk of a gate: x[:, col] *= gemma sigmoid(acc + bias) in
// place for the chunk's columns col < N (x: the [s ‖ a] tile from column S,
// which the product does not read). Resets the accumulators.
template <int MT>
__device__ __forceinline__ void gate_chunk(float (&acc)[MT][kNTW][4],
                                           const float (&bias)[kNTW][2], float gemma, int nt,
                                           int c0, int N, float* x, int ldx, int warp, int g,
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
          float* xr = x + (m * 16 + g + 8 * h) * ldx + col;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e < N) xr[e] *= gemma * sigmoid(acc[m][i][2 * h + e] + bias[i][e]);
            acc[m][i][2 * h + e] = 0.f;
          }
        }
      }
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
steps_fused_infer_kernel(const __grid_constant__ Args p) {
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

  // 2. the [s ‖ a] tile (rows past n_rows and pad columns zero)
  gather_rows<M>(p.sce, p.S, p.ld_xa, rows_s, n_rows, arena + p.xa, 0, p.S);
  gather_rows<M>(p.agn, p.A, p.ld_xa, rows_s, n_rows, arena + p.xa, p.S, p.ld_xa - p.S);
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
          bar_wait(empty + 8 * slot, ((s / kRing) & 1) ^ 1);  // the first pass finds it free
          if (st.map >= 0)
            tensor_slab(&p.map[st.map], 0, st.srows, c, k0, ring + slot * p.slot,
                        full + 8 * slot, lane);
          else
            issue_product_slab(st.w, 0, st.K, st.N, st.srows, st.sld, st.whole, c, k0,
                               ring + slot * p.slot, full + 8 * slot, lane);
        }
      }
    }
  } else {
    // 3. the steps in order: each product from the ring, then what follows it
    float acc[MT][kNTW][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < kNTW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;
    float bias[kNTW][2];
    const int S = p.S, q8 = lane & 7;
    int s = 0;
    for (int q = 0; q < p.n_steps; ++q) {
      const Step& st = p.step[q];
      const bool layer = st.kind == kLayer, gate = st.kind == kGate;
      const float* A = arena + st.in + (st.from_s ? S : 0);
      float* o = arena + st.out + (layer || gate ? S : 0);
      if (layer) {
        // the output tile's s columns from the input tile, and its columns
        // past the product's (up to its stride) zero: the next pruner reads
        // [s ‖ h] up to S + N rounded to 8. 8 lanes a row, a warp 4 rows.
        const int n8 = round_up(st.N, 8), per_row = st.ld_out - n8;
        for (int r = 4 * warp + lane / 8; r < M; r += 4 * kWarps) {
          const float* si = arena + st.in + r * st.ld_in;
          float* so = arena + st.out + r * st.ld_out;
          for (int c = q8; c < per_row; c += 8) so[c < S ? c : c + n8] = c < S ? si[c] : 0.f;
        }
      }
      for (int c = 0; c * kChunk < st.N; ++c) {
        const int c0 = c * kChunk;
        const int nt = (min(kChunk, st.N - c0) + 7) / 8;
        const int tiles = (nt + kWarps - 1) / kWarps;  // n-tiles a warp
        if (st.b != nullptr) {
          load_bias(bias, st.b, nt, c0, st.N, warp, t);
        } else {
#pragma unroll
          for (int i = 0; i < kNTW; ++i) bias[i][0] = bias[i][1] = 0.f;
        }
        for (int k0 = 0; k0 < st.K; k0 += st.srows, ++s) {
          const int slot = s % kRing;
          bar_wait(full + 8 * slot, (s / kRing) & 1);  // slab s has landed
          mma_any<MT>(tiles, A, st.ld_in, k0, st.K, st.srows, ring + slot * p.slot, st.sld, nt,
                      acc, warp, g, t);
          __syncwarp();
          if (lane == 0) bar_arrive(empty + 8 * slot);  // this warp is done with the slot
        }
        fold_any<MT>(tiles, acc);
        if (gate)
          gate_chunk<MT>(acc, bias, p.gemma, nt, c0, st.N, o, st.ld_out, warp, g, t);
        else
          store_chunk<MT>(acc, bias, st.kind != kPruner, !layer || (S & 1) == 0, nt, c0, o,
                          st.ld_out, warp, g, t);
      }
      compute_sync();  // the product's output, before the pass or the next product reads it
      if (st.kind == kPruner) {
        // x[:, S:] *= prune(v): 8 lanes a row, a warp 4 rows side by side,
        // a lane's elements kBatch at a time (their loads and the sigmoids'
        // chains overlap)
        constexpr int kBatch = 4;
        for (int r = 4 * warp + lane / 8; r < M; r += 4 * kWarps) {
          const float* v = arena + st.out + r * st.ld_out;
          float* x = arena + st.in + S + r * st.ld_in;
          for (int j0 = q8; j0 < st.N; j0 += 8 * kBatch) {
            float vb[kBatch], xb[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const int j = j0 + 8 * u;
              vb[u] = j < st.N ? v[j] : 0.f;
              xb[u] = j < st.N ? x[j] : 0.f;
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
              if (j0 + 8 * u < st.N) x[j0 + 8 * u] = prune(vb[u], p.form, p.eps, p.beta) * xb[u];
          }
        }
        compute_sync();
      }
    }
  }
  __syncthreads();

  // 4. the head and the sigmoid, a warp a row
  head_rows(arena + p.h, p.ld_h, p.kf, p.fw, p.fb, 0, rows_s, n_rows, p.out);
}

size_t smem_bytes(int tb, int arena_row, int slot) {
  const size_t floats = static_cast<size_t>(tb) * arena_row + static_cast<size_t>(kRing) * slot;
  return kHeadBytes + floats * sizeof(float) + static_cast<size_t>(tb) * sizeof(int);
}

template <int MT>
cudaError_t launch(const Args& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(steps_fused_infer_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (p.B + MT * 16 - 1) / (MT * 16);
  steps_fused_infer_kernel<MT><<<tiles, kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

bool rows_ok(int block_rows) {
  return block_rows >= 0 && block_rows % 16 == 0 && block_rows <= 16 * kMaxMT;
}

// A list of steps and their activation tiles, laid out on the host.
struct Plan {
  Tiles T;
  Step steps[kMaxSteps];
  int in_t[kMaxSteps], out_t[kMaxSteps];
  int n = 0;

  // the next step: the product of tile x (from column S where from_s) by W
  // [K, N] (+ b), then what its kind does; its output a new tile out_width
  // wide or, for a gate, tile `into` (the tile it multiplies). Returns the
  // output tile.
  int add(Kind kind, const float* w, const float* b, int K, int N, int x, bool from_s,
          int out_width, int into = -1) {
    Step& st = steps[n];
    st = Step{};
    st.w = w;
    st.b = b;
    st.K = K;
    st.N = N;
    st.kind = kind;
    st.from_s = from_s;
    in_t[n] = x;
    out_t[n] = into >= 0 ? into : T.add(out_width, n);
    T.use(out_t[n], n);
    T.use(x, n);
    return out_t[n++];
  }
};

// What both entry points share once the plan is laid out: the tiles placed
// (the head reads tile `head` from column head_col, p.kf wide, after the
// last step), the tile chosen (block_rows 0: 32 where a 32-row tile fits,
// else 16) and the ring sized beside it, the steps' places and tensor maps
// written into p, and the launch. xa: the [s ‖ a] tile.
int run(Plan& plan, Args& p, int xa, int head, int head_col, int block_rows, void* stream,
        size_t* smem) {
  plan.T.use(head, plan.n);
  const int arena_row = plan.T.place();

  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t budget = static_cast<size_t>(optin);
  auto ring_slot = [&](int tb) {
    return size_ring(plan.steps, plan.n, smem_bytes(tb, arena_row, 0), budget);
  };
  if (block_rows == 0) block_rows = smem_bytes(32, arena_row, ring_slot(32)) <= budget ? 32 : 16;
  const int slot = ring_slot(block_rows);
  *smem = smem_bytes(block_rows, arena_row, slot);
  if (*smem > budget) return static_cast<int>(cudaErrorInvalidValue);

  const int M = block_rows;
  auto at = [&](int i) { return M * plan.T.t[i].at; };
  auto ld = [&](int i) { return static_cast<short>(ld_act(plan.T.t[i].width)); };
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
  p.n_steps = plan.n;
  p.xa = at(xa); p.ld_xa = ld(xa);
  p.h = at(head) + head_col; p.ld_h = ld(head);
  p.arena = M * arena_row;
  p.slot = slot;

  if (p.B == 0) return static_cast<int>(cudaSuccess);
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

}  // namespace

extern "C" {

// sce [B, S], agn [B, A] f32. w_ptrs/b_ptrs: host arrays of device pointers,
// 2 n_lay + 2 stages in the order: the pruners (W [S + A, A], then [S + h_i,
// h_i]; b null), the layers (W [in, out], b [out]), the head (W [h, 1], b
// [1]); dims: (K, N) per stage. form: 0 Binarization, 1 Scaling, 2 Fusion.
// block_rows: rows of one block, a multiple of 16 up to 64, or 0: 32 where a
// 32-row tile fits in shared memory, else 16. Writes the dynamic shared
// memory a block of the tile it tried takes to *smem and returns a
// cudaError_t (cudaErrorInvalidValue when that tile does not fit).
int adasparse_fused_infer_f32(const void* sce, const void* agn, void* out, int B, int S, int A,
                              int n_lay, int form, float eps, float beta, const void* w_ptrs,
                              const void* b_ptrs, const void* dims, int block_rows, void* stream,
                              size_t* smem) {
  *smem = 0;
  if (B < 0 || S < 1 || A < 1 || n_lay < 0 || n_lay > kMaxLayers || form < 0 || form > 2 ||
      !rows_ok(block_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* const* ws = static_cast<const float* const*>(w_ptrs);
  const float* const* bs = static_cast<const float* const*>(b_ptrs);
  const int* dm = static_cast<const int*>(dims);
  const int n = 2 * n_lay + 2;  // pruners 0 .. n_lay, layers, the head
  for (int i = 0; i < n; ++i)
    if (ws[i] == nullptr || dm[2 * i] < 1 || dm[2 * i + 1] < 1 ||
        (i > n_lay && bs[i] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  // pruner 0 on [s ‖ a]; layer i from [s ‖ a'] (i = 0) or h_i-1; pruner i + 1
  // on [s ‖ h_i]; the head on h (or [s ‖ a'])
  if (dm[0] != S + A || dm[1] != A) return static_cast<int>(cudaErrorInvalidValue);
  int width = S + A;
  for (int i = 0; i < n_lay; ++i) {
    const int *L = dm + 2 * (n_lay + 1 + i), *P = dm + 2 * (i + 1);
    if (L[0] != width || P[0] != S + L[1] || P[1] != L[1])
      return static_cast<int>(cudaErrorInvalidValue);
    width = L[1];
  }
  if (dm[2 * (n - 1)] != width || dm[2 * (n - 1) + 1] != 1)
    return static_cast<int>(cudaErrorInvalidValue);

  // the steps and their tiles: an activation tile [s ‖ x] holds s in its first
  // S columns and, from column S, as many columns as the product writes
  // (N rounded to 8) and the next pruner's k-steps read ([s ‖ x] rounded to 8)
  Plan plan;
  auto step = [&](int stage, Kind kind, int x, bool from_s, int out_width) {
    return plan.add(kind, ws[stage], kind == kLayer ? bs[stage] : nullptr, dm[2 * stage],
                    dm[2 * stage + 1], x, from_s, out_width);
  };
  const int xa = plan.T.add(S + A, -1);  // gathered before the first step
  step(0, kPruner, xa, false, A);
  int x = xa;
  for (int i = 0; i < n_lay; ++i) {
    const int N = dm[2 * (n_lay + 1 + i) + 1];
    x = step(n_lay + 1 + i, kLayer, x, i > 0, std::max(S + round_up(N, 8), round_up(S + N, 8)));
    step(i + 1, kPruner, x, false, N);
  }

  Args p = {};
  p.sce = static_cast<const float*>(sce);
  p.agn = static_cast<const float*>(agn);
  p.out = static_cast<float*>(out);
  p.fw = ws[n - 1];
  p.fb = bs[n - 1];
  p.B = B; p.S = S; p.A = A; p.form = form;
  p.eps = eps; p.beta = beta;
  p.kf = width;
  return run(plan, p, xa, x, n_lay > 0 ? S : 0, block_rows, stream, smem);
}

// EPNet: sce [B, S], agn [B, A] f32. w_ptrs/b_ptrs: host arrays of device
// pointers, 3 stages: gate l1 (W [S + A, H], b [H]), gate l2 (W [H, A], b
// [A]), the head (W [A, 1], b [1]); dims: (K, N) per stage. block_rows, *smem
// and the returned cudaError_t as adasparse_fused_infer_f32's.
int epnet_fused_infer_f32(const void* sce, const void* agn, void* out, int B, int S, int A,
                          float gemma, const void* w_ptrs, const void* b_ptrs, const void* dims,
                          int block_rows, void* stream, size_t* smem) {
  *smem = 0;
  if (B < 0 || S < 1 || A < 1 || !rows_ok(block_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* const* ws = static_cast<const float* const*>(w_ptrs);
  const float* const* bs = static_cast<const float* const*>(b_ptrs);
  const int* dm = static_cast<const int*>(dims);
  for (int i = 0; i < 3; ++i)
    if (ws[i] == nullptr || bs[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int H = dm[1];
  if (H < 1 || dm[0] != S + A || dm[2] != H || dm[3] != A || dm[4] != A || dm[5] != 1)
    return static_cast<int>(cudaErrorInvalidValue);

  // h = relu([s ‖ a] W1 + b1) into a plain tile; its product's epilogue
  // multiplies a' = a gemma sigmoid(h W2 + b2) into [s ‖ a] from column S;
  // the head reads a' there
  Plan plan;
  const int xa = plan.T.add(S + A, -1);  // gathered before the first step
  const int h = plan.add(kHidden, ws[0], bs[0], S + A, H, xa, false, H);
  plan.add(kGate, ws[1], bs[1], H, A, h, false, 0, xa);

  Args p = {};
  p.sce = static_cast<const float*>(sce);
  p.agn = static_cast<const float*>(agn);
  p.out = static_cast<float*>(out);
  p.fw = ws[2];
  p.fb = bs[2];
  p.B = B; p.S = S; p.A = A;
  p.gemma = gemma;
  p.kf = A;
  return run(plan, p, xa, xa, S, block_rows, stream, smem);
}

}  // extern "C"
