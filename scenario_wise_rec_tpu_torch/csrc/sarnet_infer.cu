// Fused SAR-Net eval forward for NVIDIA Hopper (sm_90a), f32 in and out.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/sarnet_infer.py:
// sarnet_fused_infer. For each row b of emb[B, F], with
// d = clip(int32(domain_id[b]), 0, D-1):
//   x      = emb[b] * dom_w[d] + dom_b[d]            (the domain's scale/shift)
//   e_j    = x W_sh[j] + b_sh[j]                      (n_sh shared debias experts)
//   e_n_sh+i = x W_sp[d, i] + b_sp[d, i]              (the domain's n_sp own ones)
//   g      = softmax(x W_g + b_g)                     (over the n_sh + n_sp experts)
//   h      = sum_e g[e] * e_e                         (width H, 16 in SAR-Net)
//   out    = sigmoid(head(relu MLP(h)))
// Each debias expert is BatchNorm -> Linear, folded into one affine outside
// the kernel (folding.fold_bn_linear_eval). The TPU kernel computes every
// domain's specific experts on every domain's scaled embedding and selects
// after; a row's own domain on its own scaled embedding is the same value.
//
// What bounds it on this card: arithmetic. At SAR-Net's Ali-CCP shape (F =
// 368, 8 shared + 2 own experts of width 16, gate 368 -> 10, final [32, 32]
// and head) a row costs 64,128 multiply-adds (the shared experts 47,104, the
// own ones 11,776, the gate 3,680, the final MLP and head 1,568) against
// ~1.5 KB of its own data: 0.525 GFLOP for B = 4096. As three TF32 products
// each on the tensor cores that is 3 x 0.525 GFLOP / 495 TFLOP/s plus the
// scale, shift, softmax and mix in f32: 0.0033 ms; in f32 without tensor
// cores 0.0079 ms (H100 SXM, 700 W); HBM bounds less.
//
// What the design does about it (the split, the mma products, the ring and
// its bulk copies are mma_ring.cuh's; the partition by domain, the rotating
// accumulators, the tiles placed by their lifetimes and the 8-lane row sums
// are domain_tiles.cuh's):
// - One domain a block: a block of 8 compute warps and a producer warp takes
//   a tile of up to tb rows of one domain, partitioned inside the one launch
//   from int32 or int64 ids. Every thread issues its part of the tile's
//   gather by cp.async, the producer warp the first weight slab behind it;
//   the compute warps then scale and shift the tile in place by the domain
//   (rounded as x * w, then + b, as the plain version).
// - The experts and the gate are one product side by side: the n_sh shared
//   experts, the block's domain's n_sp own ones and the gate, 10 x 16 + 10
//   columns at Ali-CCP (the gate's padded to 16 in the output): 22 n-tiles
//   over the 8 warps, so every warp shares every k-step of the 368-deep
//   product and the gate adds no k-step to the warps that run 3 n-tiles
//   anyway. A warp's n-tile count is a template parameter, so that a k-step
//   is one basic block in which its tiles' chains of mma interleave (with a
//   branch a tile the kernel took 0.0368 ms, not 0.0281, on an H100 SXM).
// - A slab holds the same weight rows of every member: the shared experts'
//   blocks one tensor copy of an [n_sh, srows, H] box, the domain's own ones
//   another, the gate's 10-wide rows one bulk copy at their own stride (the
//   consumer reads zero past a member's width). Eleven bulk copies a slab, or
//   cp.async for the gate, took the producer 5,000-7,500 cycles a slab on an
//   H100 SXM, and the compute warps waited on it (PERF.md, section 6).
// - Each k-step's three TF32 products go into a zeroed sum that is then
//   added, rounded to nearest, into the accumulators, as M2M's kernel does:
//   the tensor core's own f32 accumulation rounds toward zero, and a chain
//   of them along a 368-deep product drifts by an ulp a product.
// - The softmax over the gate's logits and the gate-weighted mix (summed in
//   expert order) are a row pass of 8 lanes a row, writing the final MLP's
//   input tile; the final MLP's stages are products through the ring on
//   rotating accumulators, the 1-wide head and the sigmoid a pass of 8 lanes
//   a row.
// - Shared memory: the host places the tiles by their lifetimes (the emb
//   tile and the experts' output, 584 floats a row at Ali-CCP; the mixture
//   and the final MLP's tiles take the emb tile's place); the ring takes what
//   they leave. Every tile of 16-64 rows fits at Ali-CCP; at KuaiRand's F 796
//   64 rows do not, and the launch reports cudaErrorInvalidValue.
// What holds it now (PERF.md, section 6; H100 SXM): of a 32-row block's
// ~55k cycles the side-by-side product takes ~29k, bound by the compute
// warps' mma.sync (the slabs land before they are needed); the partition
// 5-10k, the gather 6-8k, the scale and shift 3k, the mix and the final MLP
// the rest.
// Rows never mix: a NaN stays in its row. The last tile of a domain is
// partial; its missing rows are zero and never written out.
//
// Bound through ctypes: a plain C interface, every pointer and the stream as
// void*, the cudaError_t of the launch returned.

#include <math.h>

#include <algorithm>

#include "domain_tiles.cuh"

namespace {

using namespace ring;

constexpr int kMaxSteps = 32;  // the experts' product and the final MLP's stages

// A product through the ring: step 0 is the experts' side-by-side product
// (sized as one, W its members'), the others the final MLP's stages.
struct Step {
  const float* w;  // W [K, N]
  const float* b;  // b [N]
  int K, N;
  int in, out;           // the input and output tiles: float offsets in the arena
  short ld_in, ld_out;   // and their row strides
  short srows, sld;      // weight rows a slab (a multiple of 8) and their stride in a slot
  unsigned char whole;   // a slab is one bulk copy of whole rows
  signed char map;       // a slab is one tensor copy of Args::map[map] (-1: whole or row copies)
};

struct Args {
  CUtensorMap map[kMaxMaps];  // W [K, N] of a final stage wider than a chunk
  CUtensorMap expert_map[2];  // the shared and the own experts' W, a box of every
                              // member's slab rows (when expert_maps)
  const float* emb;    // [B, F]
  const void* did;     // [B], int64 when id64, else int32
  float* out;          // [B]
  const float* dom_w;  // [D, F]
  const float* dom_b;  // [D, F]
  const float* w_sh;   // [n_sh, F, H]
  const float* b_sh;   // [n_sh, H]
  const float* w_sp;   // [D, n_sp, F, H]
  const float* b_sp;   // [D, n_sp, H]
  const float* w_g;    // [F, n_sh + n_sp]
  const float* b_g;    // [n_sh + n_sp]
  const float* fw;     // the head W [kf, 1]
  const float* fb;     // b [1]
  int id64, B, F, D, n_sh, n_sp, H, n_steps;
  int x, ld_x;         // the emb tile, scaled and shifted in place
  int e, ld_e;         // expert i's outputs at column i H8, the gate's logits at E H8
  int h, ld_h;         // the mixture
  int hd, ld_hd, kf;   // the head's input and its width
  int arena, slot;     // floats of the tiles and of a ring slot
  int ld_ew, ld_gw;    // row strides of an expert's and the gate's block in a slab
  int expert_maps;     // the experts' blocks are two tensor copies (else cp.async)
  int bulk_g;          // the gate's block is one bulk copy (else cp.async)
  Step step[kMaxSteps];
};
static_assert(sizeof(Args) <= 4096, "the kernel parameters' limit");

// The widths of the experts' product: E members of width H (each padded to
// H8 columns), then the gate's E logits (padded to G8).
struct Side {
  int E, H, H8, G8, cols;
  __host__ __device__ explicit Side(int n_sh, int n_sp, int H_)
      : E(n_sh + n_sp), H(H_), H8(round_up(H_, 8)), G8(round_up(n_sh + n_sp, 8)),
        cols((n_sh + n_sp) * round_up(H_, 8) + round_up(n_sh + n_sp, 8)) {}
};

// member m of the experts' product: shared expert m, the domain's own expert
// m - n_sh, or (m == E) the gate; W [F, width]
__device__ __forceinline__ const float* member_w(const Args& p, int dom, int m, int E) {
  const size_t fh = static_cast<size_t>(p.F) * p.H;
  if (m < p.n_sh) return p.w_sh + m * fh;
  if (m < E) return p.w_sp + (static_cast<size_t>(dom) * p.n_sp + m - p.n_sh) * fh;
  return p.w_g;
}

// The producer warp's part for the slab of the experts' product from weight
// row k0: rows k0 .. k0 + srows - 1 of every member's W, member m's block
// [srows, ld_ew] at m srows ld_ew in the slot (the gate's [srows, ld_gw]
// after the experts'). With expert_maps (W 16-byte aligned, H a multiple of
// 4) the shared experts' blocks are one tensor copy of an [n_sh, srows, H]
// box and the domain's own ones another, rows past F zero-filled by the copy;
// with bulk_g (W 16-byte aligned, F times its width a multiple of 4) the
// gate's rows are one bulk copy, its rows from F up to F rounded to 8 zeroed
// first. A member copied neither way is copied by cp.async an element at its
// width rounded to 8, zero-filled past its width and past F. The slot's full
// barrier completes when every copy has landed: each lane arrives once,
// after its cp.async copies are tracked, lane 0 with the copies' bytes.
__device__ void copy_side(const Args& p, const Side& sd, int dom, int srows, int k0,
                          float* slot, uint32_t full, int lane) {
  const int F = p.F;
  const int rows = min(srows, F - k0), used = min(srows, round_up(F, 8) - k0);
  uint32_t bytes = 0;
  if (p.expert_maps) bytes += static_cast<uint32_t>(sd.E * srows * sd.H * 4);
  if (p.bulk_g) {
    float* dst = slot + sd.E * srows * p.ld_ew;
    for (int i = lane; i < (used - rows) * sd.E; i += 32) dst[rows * sd.E + i] = 0.f;
    bytes += static_cast<uint32_t>(rows * sd.E * 4);
  }
  for (int m = p.expert_maps ? sd.E : 0; m <= sd.E - p.bulk_g; ++m) {
    const int w = m < sd.E ? sd.H : sd.E, ldw = m < sd.E ? p.ld_ew : p.ld_gw;
    const float* src = member_w(p, dom, m, sd.E);
    const uint32_t base = smem_addr(slot + m * srows * p.ld_ew);
    for (int i = lane; i < used * ldw; i += 32) {
      const int r = i / ldw, c = i % ldw;
      const bool ok = r < rows && c < w;
      cp_async4(base + 4u * i, ok ? src + static_cast<size_t>(k0 + r) * w + c : src, ok);
    }
  }
  // this lane's cp.async copies, counted on the barrier when they land (the
  // pending count is raised by one now, so the arrival below still counts)
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(full) : "memory");
  // the slot's earlier reads (generic proxy) before the bulk copies' writes (async)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (lane == 0)
    bar_arrive_tx(full, bytes);
  else
    bar_arrive(full);
  __syncwarp();
  if (p.expert_maps && lane < 2) {
    const int z = lane == 0 ? 0 : dom * p.n_sp;
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(slot + lane * p.n_sh * srows * sd.H)),
        "l"(reinterpret_cast<uint64_t>(&p.expert_map[lane])), "r"(0), "r"(k0), "r"(z), "r"(full)
        : "memory");
  }
  if (p.bulk_g && lane == 2)
    bulk_row(smem_addr(slot + sd.E * srows * p.ld_ew), p.w_g + static_cast<size_t>(k0) * sd.E,
             static_cast<uint32_t>(rows * sd.E * 4), full);
}

// One slab of the experts' product on the compute warps: the warp's T
// n-tiles read B from off[i] + k ld[i] of the slot (their member's block;
// zero where ok[i] is false, a column past the member's width), each k-step's
// three products into a zeroed sum added with rounding into acc[m][i]. T is
// a template parameter so that a k-step is one basic block in which the T
// tiles' chains of mma interleave.
template <int MT, int T>
__device__ __forceinline__ void mma_side(const float* A, int lda, int k0, int K, int srows,
                                         const float* Ws, const int (&off)[kNTW],
                                         const int (&ld)[kNTW], const bool (&ok)[kNTW],
                                         float (&acc)[MT][kNTW][4], int g, int t) {
  const int steps = min(srows / 8, (K - k0 + 7) / 8);
#pragma unroll 2
  for (int s = 0; s < steps; ++s) {
    const int kk = 8 * s;
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* a = A + (m * 16 + g) * lda + k0 + kk + t;
      split(a[0], ah[m][0], al[m][0]);
      split(a[8 * lda], ah[m][1], al[m][1]);
      split(a[4], ah[m][2], al[m][2]);
      split(a[8 * lda + 4], ah[m][3], al[m][3]);
    }
    uint32_t bh[T][2], bl[T][2];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const float* b = Ws + off[i] + (kk + t) * ld[i];
      split(ok[i] ? b[0] : 0.f, bh[i][0], bl[i][0]);
      split(ok[i] ? b[4 * ld[i]] : 0.f, bh[i][1], bl[i][1]);
    }
    float d[MT][T][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < T; ++i) d[m][i][0] = d[m][i][1] = d[m][i][2] = d[m][i][3] = 0.f;
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_tf32(d[m][i], al[m], bh[i][0], bh[i][1]);
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_tf32(d[m][i], ah[m], bl[i][0], bl[i][1]);
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_tf32(d[m][i], ah[m], bh[i][0], bh[i][1]);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][e] += d[m][i][e];
  }
}

// mma_side for the warp's count of n-tiles (0-4)
template <int MT>
__device__ __forceinline__ void mma_side_any(int mine, const float* A, int lda, int k0, int K,
                                             int srows, const float* Ws, const int (&off)[kNTW],
                                             const int (&ld)[kNTW], const bool (&ok)[kNTW],
                                             float (&acc)[MT][kNTW][4], int g, int t) {
  switch (mine) {
    case 0: break;
    case 1: mma_side<MT, 1>(A, lda, k0, K, srows, Ws, off, ld, ok, acc, g, t); break;
    case 2: mma_side<MT, 2>(A, lda, k0, K, srows, Ws, off, ld, ok, acc, g, t); break;
    case 3: mma_side<MT, 3>(A, lda, k0, K, srows, Ws, off, ld, ok, acc, g, t); break;
    default: mma_side<MT, 4>(A, lda, k0, K, srows, Ws, off, ld, ok, acc, g, t); break;
  }
}

// The bias of column c of the experts' product: expert c / H8's at its
// column c mod H8, or the gate's at c - E H8; 0 in the padding.
__device__ __forceinline__ float side_bias(const Args& p, const Side& sd, int dom, int c) {
  if (c >= sd.E * sd.H8) {
    c -= sd.E * sd.H8;
    return c < sd.E ? __ldg(p.b_g + c) : 0.f;
  }
  const int m = c / sd.H8, col = c % sd.H8;
  if (col >= sd.H) return 0.f;
  return m < p.n_sh ? __ldg(p.b_sh + m * sd.H + col)
                    : __ldg(p.b_sp + (static_cast<size_t>(dom) * p.n_sp + m - p.n_sh) * sd.H + col);
}

// A finished chunk of a final stage: out = relu(acc + bias) (rows of the
// tile, columns c0 + the warp's n-tiles; columns past N come out relu(0) =
// 0). Resets the accumulators.
template <int MT>
__device__ __forceinline__ void store_relu(float (&acc)[MT][kNTW][4], const float (&bias)[kNTW][2],
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
          *reinterpret_cast<float2*>(out + (m * 16 + g + 8 * h) * ldo + col) =
              make_float2(relu(acc[m][i][2 * h] + bias[i][0]),
                          relu(acc[m][i][2 * h + 1] + bias[i][1]));
          acc[m][i][2 * h] = acc[m][i][2 * h + 1] = 0.f;
        }
      }
    }
  }
}

// Rows rows_s[0 .. n_rows) of x [., F] into the tile [M, ld], rows past
// n_rows and columns past F zero: cp.async of 16 bytes (4 where the rows are
// not 16-byte aligned), every copy of the block in flight before any is
// waited for. Every thread of the block issues its part; the tile is whole
// after each thread's cp.async.wait_all and a block barrier.
template <int M>
__device__ __forceinline__ void gather_async(const float* __restrict__ x, int F, int ld,
                                             const int* rows_s, int n_rows, float* tile) {
  const uint32_t base = smem_addr(tile);
  if ((F & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int q4 = ld / 4;
    for (int i = threadIdx.x; i < M * q4; i += kThreads) {
      const int r = i / q4, c = 4 * (i % q4);
      const bool ok = r < n_rows && c < F;
      cp_async16(base + 16u * i, ok ? x + static_cast<size_t>(rows_s[r]) * F + c : x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < M * ld; i += kThreads) {
      const int r = i / ld, c = i % ld;
      const bool ok = r < n_rows && c < F;
      cp_async4(base + 4u * i, ok ? x + static_cast<size_t>(rows_s[r]) * F + c : x, ok);
    }
  }
}

// x = x * dom_w[dom] + dom_b[dom] in place over the tile's n_rows rows,
// rounded as the plain version rounds (the product, then the sum); 4
// columns a thread where the rows allow it, kBatch of them loaded before any
// is stored. The compute warps only.
__device__ __forceinline__ void scale_shift(const Args& p, int dom, float* x, int n_rows) {
  constexpr int kBatch = 4;
  const int F = p.F, tid = threadIdx.x;
  const float* w = p.dom_w + static_cast<size_t>(dom) * F;
  const float* b = p.dom_b + static_cast<size_t>(dom) * F;
  if ((F & 3) == 0 && ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(b)) & 15) == 0) {
    const int q4 = F / 4, n = n_rows * q4;
    for (int i0 = tid; i0 < n; i0 += kBatch * kComputeThreads) {
      float4 v[kBatch], a[kBatch], s[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kComputeThreads, r = i / q4, c = i % q4;
        if (i < n) {
          v[u] = reinterpret_cast<const float4*>(x + r * p.ld_x)[c];
          a[u] = __ldg(reinterpret_cast<const float4*>(w) + c);
          s[u] = __ldg(reinterpret_cast<const float4*>(b) + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kComputeThreads, r = i / q4, c = i % q4;
        if (i < n) {
          float4 y = v[u];
          y.x = __fadd_rn(__fmul_rn(y.x, a[u].x), s[u].x);
          y.y = __fadd_rn(__fmul_rn(y.y, a[u].y), s[u].y);
          y.z = __fadd_rn(__fmul_rn(y.z, a[u].z), s[u].z);
          y.w = __fadd_rn(__fmul_rn(y.w, a[u].w), s[u].w);
          reinterpret_cast<float4*>(x + r * p.ld_x)[c] = y;
        }
      }
    }
  } else {
    for (int i = tid; i < n_rows * F; i += kComputeThreads) {
      const int r = i / F, c = i % F;
      float* v = x + r * p.ld_x + c;
      *v = __fadd_rn(__fmul_rn(*v, __ldg(w + c)), __ldg(b + c));
    }
  }
}

// The gate's softmax in place over its E logits and the mixture h[f] =
// sum_e g[e] e_e[f], summed in expert order, into the mixture tile (columns
// H up to H rounded to 8 zero: the next product's k-steps read them): 8 lanes
// a row, a warp 4 rows side by side.
template <int M>
__device__ __forceinline__ void mix_pass(const Args& p, const Side& sd, float* arena, int warp,
                                         int lane) {
  const int q = lane & 7;
  for (int r = 4 * warp + lane / 8; r < M; r += 4 * kWarps) {
    const float* ex = arena + p.e + r * p.ld_e;
    float* gl = arena + p.e + r * p.ld_e + sd.E * sd.H8;
    float mx = -INFINITY;
    for (int j = q; j < sd.E; j += 8) mx = fmaxf(mx, gl[j]);
    mx = row_max(mx);
    float s = 0.f;
    for (int j = q; j < sd.E; j += 8) s += expf(gl[j] - mx);
    s = row_sum(s);
    for (int j = q; j < sd.E; j += 8) gl[j] = expf(gl[j] - mx) / s;
    __syncwarp();  // the row's gate, before its 8 lanes read all of it
    float* h = arena + p.h + r * p.ld_h;
    for (int f = q; f < sd.H8; f += 8) {
      float m = 0.f;
      if (f < sd.H) {
        m = gl[0] * ex[f];
        for (int e = 1; e < sd.E; ++e) m = fmaf(gl[e], ex[e * sd.H8 + f], m);
      }
      h[f] = m;
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
sarnet_fused_infer_kernel(const __grid_constant__ Args p) {
  constexpr int M = MT * 16;
  extern __shared__ __align__(128) float smem[];
  const uint32_t full = smem_addr(smem);     // [kRing] barriers: the slot has landed
  const uint32_t empty = full + 8 * kRing;   // [kRing] barriers: the slot has been read
  float* ring = smem + kHeadBytes / 4;       // [kRing, slot], each slot 128-byte aligned
  float* arena = ring + kRing * p.slot;      // the tiles, each [M, its ld]
  int* rows_s = reinterpret_cast<int*>(arena + p.arena);  // [M] the block's rows
  int* cnt_s = rows_s + M;                   // [kAllWarps, D] rows of each domain a segment
  int* blk_s = cnt_s + kAllWarps * p.D;      // [2] the block's domain (-1: none) and tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const Side sd(p.n_sh, p.n_sp, p.H);
  const Step& side = p.step[0];

  // 1. this block's domain and its tile of rows (domain_tiles.cuh)
  int n_rows = 0;
  const int dom = partition<M>(p.did, p.id64, p.B, p.D, rows_s, cnt_s, blk_s, &n_rows);
  if (dom < 0) return;  // past the last tile: the whole block leaves

  // 2. the ring's barriers
  if (threadIdx.x < kRing) {
    bar_init(full + 8 * threadIdx.x, 32);       // the producer warp's lanes
    bar_init(empty + 8 * threadIdx.x, kWarps);  // a lane of each compute warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();  // rows_s

  // 3. every thread issues its part of the emb tile's gather (rows past
  //    n_rows and pad columns zero), the producer warp then the experts'
  //    first slab (the first pass finds its slot free: more slabs in flight
  //    now only slow the gather), and the gather is waited for
  gather_async<M>(p.emb, p.F, p.ld_x, rows_s, n_rows, arena + p.x);
  int s = 0;
  if (warp == kWarps) {
    copy_side(p, sd, dom, side.srows, 0, ring, full, lane);
    s = 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  if (warp == kWarps) {
    // 4p. the producer warp: the experts' slabs, then each final stage's W,
    //     through the ring, as far ahead as the compute warps free slots
    for (int k0 = s * side.srows; k0 < p.F; k0 += side.srows, ++s) {
      const int slot = s % kRing;
      bar_wait(empty + 8 * slot, ((s / kRing) & 1) ^ 1);  // the first pass finds it free
      copy_side(p, sd, dom, side.srows, k0, ring + slot * p.slot, full + 8 * slot, lane);
    }
    for (int q = 1; q < p.n_steps; ++q) {
      const Step& st = p.step[q];
      for (int c = 0; c * kChunk < st.N; ++c) {
        for (int k0 = 0; k0 < st.K; k0 += st.srows, ++s) {
          const int slot = s % kRing;
          float* sl = ring + slot * p.slot;
          bar_wait(empty + 8 * slot, ((s / kRing) & 1) ^ 1);
          if (st.map >= 0)
            tensor_slab(&p.map[st.map], 0, st.srows, c, k0, sl, full + 8 * slot, lane);
          else
            issue_product_slab(st.w, 0, st.K, st.N, st.srows, st.sld, st.whole, c, k0, sl,
                               full + 8 * slot, lane);
        }
      }
    }
  } else {
    // 4. the domain's scale and shift, then the products in order
    scale_shift(p, dom, arena + p.x, n_rows);
    compute_sync();
    float acc[MT][kNTW][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < kNTW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;
    float bias[kNTW][2];

    // 4a. the experts and the gate side by side: this warp's n-tiles j =
    //     warp + 8 i (columns c of the experts' tile: expert c / H8's column
    //     c mod H8, or the gate's c - E H8), this lane's column of each in a
    //     slab (ok: within its member's width) and its bias
    const int nt = sd.cols / 8;
    int off[kNTW], ld[kNTW], mine = 0;
    bool ok[kNTW];
#pragma unroll
    for (int i = 0; i < kNTW; ++i) {
      const int c = 8 * (warp + kWarps * i);
      mine += c < sd.cols;
      const bool gate = c >= sd.E * sd.H8;
      const int col = gate ? c - sd.E * sd.H8 : c % sd.H8;  // the n-tile's first in its member
      ok[i] = col + g < (gate ? sd.E : sd.H);
      off[i] = (gate ? sd.E : c / sd.H8) * side.srows * p.ld_ew + col + (ok[i] ? g : 0);
      ld[i] = gate ? p.ld_gw : p.ld_ew;
      bias[i][0] = c < sd.cols ? side_bias(p, sd, dom, c + 2 * t) : 0.f;
      bias[i][1] = c < sd.cols ? side_bias(p, sd, dom, c + 2 * t + 1) : 0.f;
    }
    s = 0;
    for (int k0 = 0; k0 < p.F; k0 += side.srows, ++s) {
      const int slot = s % kRing;
      bar_wait(full + 8 * slot, (s / kRing) & 1);  // slab s has landed
      mma_side_any<MT>(mine, arena + p.x, p.ld_x, k0, p.F, side.srows, ring + slot * p.slot,
                       off, ld, ok, acc, g, t);
      __syncwarp();
      if (lane == 0) bar_arrive(empty + 8 * slot);  // this warp is done with the slot
    }
#pragma unroll
    for (int i = 0; i < kNTW; ++i) {
      if (warp + kWarps * i < nt) {
        const int col = 8 * (warp + kWarps * i) + 2 * t;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m-tile
            *reinterpret_cast<float2*>(arena + p.e + (m * 16 + g + 8 * h) * p.ld_e + col) =
                make_float2(acc[m][i][2 * h] + bias[i][0], acc[m][i][2 * h + 1] + bias[i][1]);
            acc[m][i][2 * h] = acc[m][i][2 * h + 1] = 0.f;
          }
      }
    }
    compute_sync();  // the experts' and the gate's outputs, before the pass reads them

    // 4b. the softmax and the mixture
    mix_pass<M>(p, sd, arena, warp, lane);
    compute_sync();

    // 4c. the final MLP's stages, relu
    for (int q = 1; q < p.n_steps; ++q) {
      const Step& st = p.step[q];
      const float* A = arena + st.in;
      for (int c = 0; c * kChunk < st.N; ++c) {
        const int c0 = c * kChunk, wc = min(kChunk, st.N - c0);
        const int ntc = (wc + 7) / 8;
        const int tiles = (ntc + kWarps - 1) / kWarps;  // n-tiles a warp
        load_bias(bias, st.b, ntc, c0, st.N, warp, t);
        for (int k0 = 0; k0 < st.K; k0 += st.srows, ++s) {
          const int slot = s % kRing;
          bar_wait(full + 8 * slot, (s / kRing) & 1);
          mma_any<MT>(tiles, A, st.ld_in, k0, st.K, st.srows, ring + slot * p.slot, st.sld, ntc,
                      acc, warp, g, t);
          __syncwarp();
          if (lane == 0) bar_arrive(empty + 8 * slot);
        }
        fold_any<MT>(tiles, acc);
        store_relu<MT>(acc, bias, ntc, c0, arena + st.out, st.ld_out, warp, g, t);
      }
      compute_sync();  // the stage's output, before the next stage reads it
    }

    // 5. the head and the sigmoid: 8 lanes a row, a warp 4 rows side by side
    const float fb = __ldg(p.fb);
    for (int r = 4 * warp + lane / 8; r < M; r += 4 * kWarps) {
      const float* hd = arena + p.hd + r * p.ld_hd;
      float part = 0.f;
      for (int k = lane & 7; k < p.kf; k += 8) part = fmaf(hd[k], __ldg(p.fw + k), part);
      part = row_sum(part);
      if ((lane & 7) == 0 && r < n_rows) p.out[rows_s[r]] = sigmoid(part + fb);
    }
  }
}

// the tensor map of W [members, K, N] for the experts' slabs: boxes of all N
// columns by srows rows by box_members members
bool encode_members(const float* w, int K, int N, int members, int srows, int box_members,
                    CUtensorMap* map) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(members)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * 4,
                                 static_cast<cuuint64_t>(K) * N * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(N), static_cast<cuuint32_t>(srows),
                             static_cast<cuuint32_t>(box_members)};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(w), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t smem_bytes(int tb, int D, int arena_row, int slot) {
  const size_t floats = static_cast<size_t>(tb) * arena_row + static_cast<size_t>(kRing) * slot;
  return kHeadBytes + floats * sizeof(float) +
         (static_cast<size_t>(tb) + static_cast<size_t>(kAllWarps) * D + 2) * sizeof(int);
}

template <int MT>
cudaError_t launch(const Args& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(sarnet_fused_infer_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (p.B + MT * 16 - 1) / (MT * 16) + p.D - 1;
  sarnet_fused_infer_kernel<MT><<<tiles, kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// emb [B, F] f32; did [B] domain ids, int64 when id64, else int32; dom_w,
// dom_b [D, F]. w_ptrs/b_ptrs: host arrays of device pointers, one per stage
// in the order: the shared experts (W [n_sh, F, H]), the specific experts (W
// [D, n_sp, F, H]), the gate (W [F, n_sh + n_sp]), the n_fin final stages,
// the head (W [kf, 1]); dims: (K, N) per stage. block_rows: rows of one
// block, a multiple of 16 up to 64, or 0: 32 where a 32-row tile fits in
// shared memory, else 16. Writes the dynamic shared memory a block of the
// tile it tried takes to *smem and returns a cudaError_t
// (cudaErrorInvalidValue when that tile does not fit or the shapes are not
// taken).
int sarnet_fused_infer_f32(const void* emb, const void* did, int id64, void* out,
                           const void* dom_w, const void* dom_b, int B, int F, int D, int n_sh,
                           int n_sp, int n_fin, const void* w_ptrs, const void* b_ptrs,
                           const void* dims, int block_rows, void* stream, size_t* smem) {
  *smem = 0;
  if (B < 0 || F < 1 || D < 1 || D > kMaxDomains || n_sh < 1 || n_sp < 1 || n_fin < 0 ||
      n_fin > kMaxSteps - 1 || block_rows < 0 || block_rows % 16 != 0 ||
      block_rows > 16 * kMaxMT)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* const* ws = static_cast<const float* const*>(w_ptrs);
  const float* const* bs = static_cast<const float* const*>(b_ptrs);
  const int* dm = static_cast<const int*>(dims);
  const int n = 3 + n_fin + 1;
  for (int s = 0; s < n; ++s)
    if (ws[s] == nullptr || bs[s] == nullptr || dm[2 * s] < 1 || dm[2 * s + 1] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
  const int H = dm[1];
  const Side sd(n_sh, n_sp, H);
  if (dm[0] != F || dm[2] != F || dm[3] != H || dm[4] != F || dm[5] != sd.E ||
      sd.cols > kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  int width = H;
  for (int s = 3; s < n; ++s) {
    if (dm[2 * s] != width) return static_cast<int>(cudaErrorInvalidValue);
    width = dm[2 * s + 1];
  }
  if (width != 1) return static_cast<int>(cudaErrorInvalidValue);

  // the steps and their tiles: the experts' product (step 0) reads the emb
  // tile and writes the experts' tile, the pass (step 1) reads it and writes
  // the mixture, final stage i (step 2 + i) reads the tile before it
  Tiles T;
  Step steps[kMaxSteps] = {};
  const int x = T.add(F, -1);  // gathered before the first step
  const int e = T.add(sd.cols, 0);
  T.use(x, 0);
  const int h = T.add(H, 1);
  T.use(e, 1);
  steps[0].K = F;
  steps[0].N = sd.cols;  // w null: sized as whole rows, sd.cols a slab row
  int prev = h, in_t[kMaxSteps], out_t[kMaxSteps];
  for (int i = 0; i < n_fin; ++i) {
    const int s = 3 + i;
    Step& st = steps[1 + i];
    st.w = ws[s];
    st.b = bs[s];
    st.K = dm[2 * s];
    st.N = dm[2 * s + 1];
    in_t[1 + i] = prev;
    out_t[1 + i] = prev = T.add(st.N, 2 + i);
    T.use(in_t[1 + i], 2 + i);
  }
  T.use(prev, 2 + n_fin);  // the head, after the last step
  const int arena_row = T.place();
  const int n_steps = 1 + n_fin;

  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t budget = static_cast<size_t>(optin);
  auto ring_slot = [&](int tb) {
    return size_ring(steps, n_steps, smem_bytes(tb, D, arena_row, 0), budget);
  };
  if (block_rows == 0)
    block_rows = smem_bytes(32, D, arena_row, ring_slot(32)) <= budget ? 32 : 16;
  const int slot = ring_slot(block_rows);
  *smem = smem_bytes(block_rows, D, arena_row, slot);
  if (*smem > budget) return static_cast<int>(cudaErrorInvalidValue);
  steps[0].srows = std::min<short>(steps[0].srows, 256);  // a tensor copy's box is at most 256 rows

  Args p = {};
  const int M = block_rows;
  auto at = [&](int i) { return M * T.t[i].at; };
  auto ld = [&](int i) { return ld_act(T.t[i].width); };
  p.step[0] = steps[0];
  for (int q = 1; q < n_steps; ++q) {
    Step& st = steps[q];
    st.in = at(in_t[q]);
    st.ld_in = static_cast<short>(ld(in_t[q]));
    st.out = at(out_t[q]);
    st.ld_out = static_cast<short>(ld(out_t[q]));
    if (st.map >= 0 && !encode_map(st.w, st.K, st.N, 1, st.srows, &p.map[st.map]))
      return static_cast<int>(cudaErrorNotSupported);
    p.step[q] = st;
  }
  p.emb = static_cast<const float*>(emb);
  p.did = did;
  p.out = static_cast<float*>(out);
  p.dom_w = static_cast<const float*>(dom_w);
  p.dom_b = static_cast<const float*>(dom_b);
  p.w_sh = ws[0]; p.b_sh = bs[0];
  p.w_sp = ws[1]; p.b_sp = bs[1];
  p.w_g = ws[2]; p.b_g = bs[2];
  p.fw = ws[n - 1]; p.fb = bs[n - 1];
  p.id64 = id64;
  p.B = B; p.F = F; p.D = D; p.n_sh = n_sh; p.n_sp = n_sp; p.H = H;
  p.n_steps = n_steps;
  p.x = at(x); p.ld_x = ld(x);
  p.e = at(e); p.ld_e = ld(e);
  p.h = at(h); p.ld_h = ld(h);
  p.hd = at(prev); p.ld_hd = ld(prev);
  p.kf = n_fin ? dm[2 * (n - 2) + 1] : H;
  p.arena = M * arena_row;
  p.slot = slot;
  auto aligned = [](const float* w) { return (reinterpret_cast<uintptr_t>(w) & 15) == 0; };
  p.expert_maps = aligned(ws[0]) && aligned(ws[1]) && H % 4 == 0 && n_sh <= 256 && n_sp <= 256;
  if (p.expert_maps &&
      !(encode_members(ws[0], F, H, n_sh, p.step[0].srows, n_sh, &p.expert_map[0]) &&
        encode_members(ws[1], F, H, D * n_sp, p.step[0].srows, n_sp, &p.expert_map[1])))
    return static_cast<int>(cudaErrorNotSupported);
  p.bulk_g = aligned(ws[2]) && (static_cast<long long>(F) * sd.E) % 4 == 0;
  p.ld_ew = p.expert_maps ? H : sd.H8;
  p.ld_gw = p.bulk_g ? sd.E : sd.G8;

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
