// Fused PLE (CGC) eval forward for NVIDIA Hopper (sm_90a), f32 in and out.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/ple_infer.py:
// ple_fused_infer. Each level reads D + 1 streams per row (one per domain,
// one shared; all of them the embedding at level 0). Per level:
//   spec[d][s] = relu MLP of domain d's specific expert s on stream d,
//   shared[j]  = relu MLP of shared expert j on the shared stream,
//   gate[d]    = domain d's gate on stream d, a softmax after every stage,
//   stream d  <- sum_e gate[d][e] * (spec[d][0..S), shared[0..n_sh))[e],
// and a level before the last also has a shared gate on the shared stream
// over all D*S + n_sh experts, which makes the next shared stream. After
// the last level, the row's own domain d = clip(int32(domain_id), 0, D-1)
// runs its relu tower and 1-unit head, then the sigmoid. The TPU kernel
// computes every domain's experts, gates and towers at every level and
// selects at the end. At the last level a row needs only its own domain's
// stream, so there a row runs only its own S specifics, the shared experts
// and its own gate (the value per row is the same); a level before the last
// feeds every stream and the shared gate mixes every expert, so there every
// domain's experts and gates run for every row.
//
// What bounds it on this card: arithmetic. At PLE's Ali-CCP shape (F 376,
// 1 level, 2 specific + 1 shared experts [256,128,64,32,16,8], gate 376 ->
// 3, tower [16], 3 domains) a row costs 421,008 multiply-adds (3 x 139,904
// in the experts, 1,128 in the gate, 128 in the tower: 420,968 in products;
// 24 in the mix and 16 in the head) against ~1.5 KB of its own data: 3.449
// GFLOP for B = 4096. As three TF32 products each on the tensor cores that
// is 3 x 3.448 GFLOP / 495 TFLOP/s = 0.0209 ms; in f32 without tensor cores
// 0.0515 ms at 67 TFLOP/s (H100 SXM, 700 W); HBM bounds less.
//
// What the design does about it (the split, the mma products, the ring and
// its bulk copies are mma_ring.cuh's; the partition by domain, the slab
// copies, the rotating accumulators, the tiles' placement, the ring's size
// and the head are domain_tiles.cuh's, shared with ppnet_infer.cu,
// m3oe_infer.cu and adasparse_infer.cu):
// - One domain a block: a block of 8 compute warps and a producer warp takes
//   a tile of up to tb rows of one domain, partitioned inside the one launch
//   from int32 or int64 ids, so at the last level it streams its own
//   domain's specific experts, gate and tower and the shared experts once
//   (1.7 MB at Ali-CCP), not one set for each domain its rows hold.
// - Every product in 3xTF32 mma.sync (f32's accuracy) through the ring: the
//   host lays out a schedule of steps, each a product of one member of a
//   stage (a domain's specific expert, a shared expert, a domain's gate, the
//   shared gate, the tower) from an input tile, and what its epilogue does
//   with it. The producer warp streams each step's W slab by slab; the
//   compute warps consume the same schedule and meet at each chunk's end. At
//   the last level a step's member follows the block's domain, and its input
//   is the domain's own stream; before it every member runs.
// - The epilogue: bias and relu into the next tile for an expert's inner
//   stage or a tower stage; bias for a gate stage, whose softmax then runs as
//   a pass of 8 lanes a row (a warp 4 rows side by side). The gates of a
//   level run before its experts, so an expert's last stage writes no tile
//   of its own: its epilogue adds relu(x W + b) times its gate coefficient
//   into each stream it feeds (each output element owned by one thread), with
//   no buffer an expert: at the last level the own mixed tile with the own
//   gate's weight; before it, domain d''s expert s into stream d' with
//   g_d'[s] and into the shared stream with gs[d' S + s], shared expert j
//   into every stream d with g_d[S + j] and into the shared stream with
//   gs[D S + j]. The D streams of a level before the last lie in one set of D
//   tiles of one stride, so that the last level reads the own one.
// - A gate is one n-tile wide (3 columns at Ali-CCP, 7 for the shared gate
//   at 2 levels) and 376 deep, 47 k-steps in turn on one warp. So a product
//   at most 8 wide and at least 64 deep is split over the 8 warps, each a
//   share of every slab's k-steps into n-tile 0, their partial sums into a
//   tile of 8 columns a warp; a pass of 8 lanes a row adds them in warp
//   order (the sum is the same every call), adds the bias and applies the
//   step's op. Its slab (N < 8) comes a row a lane at stride 8
//   (copy_narrow), not by mma_ring.cuh's copy of 4 bytes an element, which
//   kept the gate waiting. Both took the Ali-CCP call from 0.125 to 0.118 ms
//   on an H100 (PERF.md, section 6).
// - Shared memory: the host places each step's tiles by their lifetimes
//   (Tiles), and the ring takes what the peak leaves (size_ring): at 32
//   Ali-CCP rows the emb tile, an expert's 256- and 128-wide tiles, the gate
//   and the mixed tile take 113 KB at 1 level and 147 KB at 2; 64 rows do
//   not fit, nor 48 at 2 levels. The 1-wide tower head is a warp a row.
// What holds it now (clock stamps of an instrumented build, PERF.md section
// 6): the three 376 -> 256 products and then the 256 -> 128 ones take most
// of a block's time, at the rate of the compute warps' fragment loads,
// splits and mma.sync issue, as in mmoe_infer.cu (the slabs' 4-way bank
// conflicts at stride N are not what holds them: slabs free of them, by
// tensor copies of boxes 8 columns wider, gained 1 %); the experts' narrow
// tails pay by the step, not by the width.
// Rows never mix: a NaN stays in its row. The last tile of a domain is
// partial; its missing rows are zero and never written out.
//
// The weights come as one list in a fixed order, as the TPU kernel's cursor
// takes them: for each level its specific, shared, gate and shared-gate
// stages, then the tower stages, then the head.
//
// Bound through ctypes: a plain C interface, every pointer and the stream as
// void*, the cudaError_t of the launch returned.

#include <math.h>

#include <algorithm>
#include <vector>

#include "domain_tiles.cuh"

namespace {

using namespace ring;

constexpr int kMaxLevels = 4;
// Products and stream mixes a launch takes: the schedule is a kernel
// parameter, past the 4 KB of old (CUDA 12.1 and later take 32,764 bytes).
// Ali-CCP's expert ladder takes 20 products and 3 mixes at 1 level, 66 and
// 19 at 2, 158 and 51 at 4.
constexpr int kMaxSteps = 256;
constexpr int kMaxMixes = 256;

// what a step's epilogue makes of v = x W + b
enum Op : unsigned char {
  kRelu,     // out = relu(v)
  kSoftmax,  // out = v, then a pass: out = softmax(out) over the row
  kMix,      // each of the step's mixes: stream (=, +=) coef * relu(v)
};

// A step: one member's product, then its epilogue.
struct Step {
  const float* w;  // W [members, K, N] from member 0
  const float* b;  // b [members, N]
  int K, N;
  int in, out;     // tiles: float offsets in the arena (out: none for kMix)
  int part;        // split: the warps' partial sums, a tile [M, 8 kWarps]
  short ld_in, ld_out, ld_part;
  short srows, sld;  // weight rows a slab (a multiple of 8) and their stride in a slot
  short m0, dmul;    // the member: m0 + dmul * the block's domain
  unsigned char op, whole, n_mix;  // kMix: the next n_mix entries of Args::mix
  unsigned char in_own;  // the input is member `domain` of a set of tiles [M, ld_in]
  unsigned char narrow;  // N < 8: a slab comes a row a lane, at stride 8 (copy_narrow)
  unsigned char split;   // N <= 8, K >= 8 kWarps: the warps split each slab's k-steps
  signed char map;  // a slab is one tensor copy of Args::map[map] (-1: whole or row copies)
};

// An expert's output into one stream: to[r] (=, +=) gate[r][col] * y[r]
struct Mix {
  int to, gate;  // tiles: float offsets in the arena
  short ld_to, ld_gate, col, first;  // first: the stream's first write (=)
};

struct Args {
  CUtensorMap map[kMaxMaps];  // W [members, K, N] of a product wider than a chunk
  const float* emb;  // [B, F]
  const void* did;   // [B], int64 when id64, else int32
  float* out;        // [B]
  const float* fw;   // the tower head W [D, T, 1]
  const float* fb;   // b [D, 1]
  int id64, B, F, D, n_steps;
  int emb_at, ld_emb;  // the emb tile
  int t, ld_t, T;      // the head's input tile
  int arena, slot;     // floats of the tiles and of a ring slot
  Mix mix[kMaxMixes];
  Step step[kMaxSteps];
};
static_assert(sizeof(Args) <= 32764, "the kernel parameters' limit");

// A finished chunk of step st's product: v = acc + bias (rows of the tile,
// columns c0 + the warp's n-tiles) through the step's op. In a tile the
// columns past N come out zero; a stream's first write zeroes them up to N
// rounded to 8 (the next product reads them). Resets the accumulators.
template <int MT>
__device__ __forceinline__ void epilogue(const Args& p, const Step& st, int mix0,
                                         float (&acc)[MT][kNTW][4],
                                         const float (&bias)[kNTW][2], int nt, int c0,
                                         float* arena, int warp, int g, int t) {
#pragma unroll
  for (int i = 0; i < kNTW; ++i) {
    const int j = warp + kWarps * i;
    if (j < nt) {
      const int col = c0 + j * 8 + 2 * t;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m-tile
          const int r = m * 16 + g + 8 * h;
          float v0 = acc[m][i][2 * h] + bias[i][0], v1 = acc[m][i][2 * h + 1] + bias[i][1];
          acc[m][i][2 * h] = acc[m][i][2 * h + 1] = 0.f;
          if (st.op != kSoftmax) {
            v0 = relu(v0);
            v1 = relu(v1);
          }
          if (st.op != kMix) {
            *reinterpret_cast<float2*>(arena + st.out + r * st.ld_out + col) =
                make_float2(v0, v1);
            continue;
          }
          for (int e = 0; e < st.n_mix; ++e) {
            const Mix& x = p.mix[mix0 + e];
            const float c = arena[x.gate + r * x.ld_gate + x.col];
            float* to = arena + x.to + r * x.ld_to + col;
            if (col < st.N) to[0] = x.first ? c * v0 : fmaf(c, v0, to[0]);
            else if (x.first) to[0] = 0.f;
            if (col + 1 < st.N) to[1] = x.first ? c * v1 : fmaf(c, v1, to[1]);
            else if (x.first) to[1] = 0.f;
          }
        }
      }
    }
  }
}

// The producer warp's part for a product narrower than 8 columns: rows k0 ..
// k0 + srows - 1 of member `member`'s W [K, N], a row a lane, laid out at
// stride 8 in the slot, columns from N and rows from K up to the slab's
// zero. Each lane arrives on the slot's full barrier once its stores are
// done.
__device__ __forceinline__ void copy_narrow(const float* w, int member, int K, int N,
                                            int srows, int k0, float* slot, uint32_t full,
                                            int lane) {
  const float* __restrict__ src = w + (static_cast<size_t>(member) * K + k0) * N;
  const int rows = min(srows, K - k0), rows8 = min(srows, round_up(K, 8) - k0);
#pragma unroll 4
  for (int r = lane; r < rows8; r += 32) {
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = r < rows && c < N ? __ldg(src + r * N + c) : 0.f;
    float4* dst = reinterpret_cast<float4*>(slot + r * 8);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  bar_arrive(full);
}

// A split product's pass: 8 lanes a row, lane q its column q (N <= 8), a warp
// 4 rows side by side: v = the warps' partial sums + b[q], then the step's
// op (a stream's first write, and a tile, zero from N to 8).
__device__ __forceinline__ void split_rows(const Args& p, const Step& st, int mix0,
                                           const float* __restrict__ b, float* arena, int M,
                                           int warp, int lane) {
  const int N = st.N, q = lane & 7;
  const bool col = q < N;
  const float bq = col ? __ldg(b + q) : 0.f;
  for (int r = 4 * warp + lane / 8; r < M; r += 4 * kWarps) {
    const float* part = arena + st.part + r * st.ld_part + q;
    float v = part[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += part[8 * w];
    v += bq;
    if (st.op == kSoftmax) {
      const float mx = row_max(col ? v : -INFINITY);
      const float e = col ? expf(v - mx) : 0.f;
      const float sum = row_sum(e);
      arena[st.out + r * st.ld_out + q] = col ? e / sum : 0.f;
      continue;
    }
    v = relu(v);
    if (st.op == kRelu) {
      arena[st.out + r * st.ld_out + q] = col ? v : 0.f;
      continue;
    }
    for (int e = 0; e < st.n_mix; ++e) {
      const Mix& x = p.mix[mix0 + e];
      float* to = arena + x.to + r * x.ld_to + q;
      if (col) {
        const float c = arena[x.gate + r * x.ld_gate + x.col];
        *to = x.first ? c * v : fmaf(c, v, *to);
      } else if (x.first) {
        *to = 0.f;
      }
    }
  }
}

// A gate stage's softmax over its output rows: 8 lanes a row, a warp 4 rows
// side by side.
__device__ __forceinline__ void softmax_rows(const Step& st, float* arena, int M, int warp,
                                             int lane) {
  const int N = st.N, q = lane & 7;
  for (int r = 4 * warp + lane / 8; r < M; r += 4 * kWarps) {
    float* v = arena + st.out + r * st.ld_out;
    float mx = -INFINITY;
    for (int j = q; j < N; j += 8) mx = fmaxf(mx, v[j]);
    mx = row_max(mx);
    float s = 0.f;
    for (int j = q; j < N; j += 8) s += expf(v[j] - mx);
    s = row_sum(s);
    for (int j = q; j < N; j += 8) v[j] = expf(v[j] - mx) / s;
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
ple_fused_infer_kernel(const __grid_constant__ Args p) {
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

  // 3. the emb tile (rows past n_rows and pad columns zero)
  gather_rows<M>(p.emb, p.F, p.ld_emb, rows_s, n_rows, arena + p.emb_at);
  __syncthreads();

  if (warp == kWarps) {
    // 4p. the producer warp: each step's W of its member, slab by slab,
    //     through the ring, as far ahead as the compute warps free slots
    int s = 0;
    for (int q = 0; q < p.n_steps; ++q) {
      const Step& st = p.step[q];
      const int member = st.m0 + st.dmul * dom;
      for (int c = 0; c * kChunk < st.N; ++c) {
        for (int k0 = 0; k0 < st.K; k0 += st.srows, ++s) {
          const int slot = s % kRing;
          bar_wait(empty + 8 * slot, ((s / kRing) & 1) ^ 1);  // the first pass finds it free
          if (st.narrow)
            copy_narrow(st.w, member, st.K, st.N, st.srows, k0, ring + slot * p.slot,
                        full + 8 * slot, lane);
          else if (st.map >= 0)
            tensor_slab(&p.map[st.map], member, st.srows, c, k0, ring + slot * p.slot,
                        full + 8 * slot, lane);
          else
            issue_product_slab(st.w, member, st.K, st.N, st.srows, st.sld, st.whole, c, k0,
                               ring + slot * p.slot, full + 8 * slot, lane);
        }
      }
    }
  } else {
    // 4. the steps in schedule order: each product from the ring, then its
    //    epilogue (and a gate stage's softmax)
    float acc[MT][kNTW][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < kNTW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;
    float bias[kNTW][2];
    int s = 0, mix0 = 0;
    for (int q = 0; q < p.n_steps; ++q) {
      const Step& st = p.step[q];
      const int member = st.m0 + st.dmul * dom;
      const float* A = arena + st.in + (st.in_own ? dom * M * st.ld_in : 0);
      if (st.split) {
        // every warp n-tile 0 over its share of each slab's k-steps, then the
        // partial sums into columns 8 warp .. 8 warp + 7 of the part tile
        for (int k0 = 0; k0 < st.K; k0 += st.srows, ++s) {
          const int slot = s % kRing;
          const int steps = min(st.srows / 8, (st.K - k0 + 7) / 8);
          const int s0 = steps * warp / kWarps, s1 = steps * (warp + 1) / kWarps;
          bar_wait(full + 8 * slot, (s / kRing) & 1);  // slab s has landed
          if (s1 > s0)
            mma_slab_rot<MT, 1>(A, st.ld_in, k0 + 8 * s0, st.K, 8 * (s1 - s0),
                                ring + slot * p.slot + 8 * s0 * st.sld, st.sld, 1, acc, 0, g, t);
          __syncwarp();
          if (lane == 0) bar_arrive(empty + 8 * slot);  // this warp is done with the slot
        }
        fold<MT, 1>(acc);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m * 16 + g + 8 * h;
            *reinterpret_cast<float2*>(arena + st.part + r * st.ld_part + 8 * warp + 2 * t) =
                make_float2(acc[m][0][2 * h], acc[m][0][2 * h + 1]);
            acc[m][0][2 * h] = acc[m][0][2 * h + 1] = 0.f;
          }
        compute_sync();
        split_rows(p, st, mix0, st.b + static_cast<size_t>(member) * st.N, arena, M, warp, lane);
        compute_sync();
        mix0 += st.n_mix;
        continue;
      }
      for (int c = 0; c * kChunk < st.N; ++c) {
        const int c0 = c * kChunk;
        const int nt = (min(kChunk, st.N - c0) + 7) / 8;
        const int tiles = (nt + kWarps - 1) / kWarps;  // n-tiles a warp
        load_bias(bias, st.b + static_cast<size_t>(member) * st.N, nt, c0, st.N, warp, t);
        for (int k0 = 0; k0 < st.K; k0 += st.srows, ++s) {
          const int slot = s % kRing;
          bar_wait(full + 8 * slot, (s / kRing) & 1);  // slab s has landed
          mma_any<MT>(tiles, A, st.ld_in, k0, st.K, st.srows, ring + slot * p.slot, st.sld, nt,
                      acc, warp, g, t);
          __syncwarp();
          if (lane == 0) bar_arrive(empty + 8 * slot);  // this warp is done with the slot
        }
        fold_any<MT>(tiles, acc);
        epilogue<MT>(p, st, mix0, acc, bias, nt, c0, arena, warp, g, t);
        compute_sync();  // the chunk, before the softmax or the next product reads it
      }
      if (st.op == kSoftmax) {
        softmax_rows(st, arena, M, warp, lane);
        compute_sync();
      }
      mix0 += st.n_mix;
    }
  }
  __syncthreads();

  // 5. the tower head and the sigmoid, a warp a row
  head_rows(arena + p.t, p.ld_t, p.T, p.fw, p.fb, dom, rows_s, n_rows, p.out);
}

// an affine stage W [members..., K, N], b [members..., N]
struct Stage {
  const float* w;
  const float* b;
  int K, N;
};

// a tile of the schedule, or member `member` of a set of tiles (-1: the
// block's domain's)
struct Ref {
  int tile, member;
};

// The steps of the schedule, their mixes and their tiles, in the order the
// kernel runs them. A tile is [M, ld] or a set of D such tiles one after the
// other (a level's domain streams).
struct Schedule {
  Tiles tiles;
  std::vector<int> ld;  // each tile's (each member's) row stride
  std::vector<Step> step;
  std::vector<Ref> in, out, part;
  std::vector<int> members;  // members of each step's W (a tensor map's depth)
  std::vector<Mix> mix;
  std::vector<Ref> to, gate;

  int now() const { return static_cast<int>(step.size()); }
  // a tile (count > 1: a set of count tiles) first written at step q
  int tile(int width, int count, int q) {
    ld.push_back(ld_act(width));
    return tiles.add(count == 1 ? width : count * ld_act(width) - 4, q);
  }
  // a product of member m0 + dmul * domain of stage st (n_members deep) from
  // x, then the epilogue op: kRelu and kSoftmax write a new tile (returned);
  // kMix writes the mixes added after it (mix_into)
  int product(const Stage& st, int n_members, int m0, int dmul, Ref x, Op op) {
    const int q = now();
    Step s = {};
    s.w = st.w;
    s.b = st.b;
    s.K = st.K;
    s.N = st.N;
    s.m0 = static_cast<short>(m0);
    s.dmul = static_cast<short>(dmul);
    s.op = op;
    s.in_own = x.member < 0;
    s.split = st.N <= 8 && st.K >= 8 * kWarps;
    tiles.use(x.tile, q);
    const int y = op == kMix ? -1 : tile(st.N, 1, q);
    step.push_back(s);
    in.push_back(x);
    out.push_back(Ref{y, 0});
    part.push_back(Ref{s.split ? tile(8 * kWarps, 1, q) : -1, 0});
    members.push_back(n_members);
    return y;
  }
  // an expert's (gate = false) or a gate's chain of count stages from x: an
  // expert's stages relu'd but the last, which mixes; a gate's softmaxed.
  // Returns the gate's tile.
  int chain(const Stage* st, int count, int n_members, int m0, int dmul, Ref x, bool is_gate) {
    for (int i = 0; i < count; ++i) {
      const Op op = is_gate ? kSoftmax : i == count - 1 ? kMix : kRelu;
      x = Ref{product(st[i], n_members, m0, dmul, x, op), 0};
    }
    return x.tile;
  }
  // the last step's output into member `member` of stream tile *stream (a
  // set of `count` tiles `width` wide, made at its first write) times column
  // col of gate tile g
  void mix_into(int* stream, int width, int count, int member, int g, int col, bool first) {
    const int q = now() - 1;
    if (*stream < 0) *stream = tile(width, count, q);
    tiles.use(*stream, q);
    tiles.use(g, q);
    Mix x = {};
    x.col = static_cast<short>(col);
    x.first = first;
    mix.push_back(x);
    to.push_back(Ref{*stream, member});
    gate.push_back(Ref{g, 0});
    ++step.back().n_mix;
  }
};

size_t smem_bytes(int tb, int D, int arena_row, int slot) {
  const size_t floats = static_cast<size_t>(tb) * arena_row + static_cast<size_t>(kRing) * slot;
  return kHeadBytes + floats * sizeof(float) +
         (static_cast<size_t>(tb) + static_cast<size_t>(kAllWarps) * D + 2) * sizeof(int);
}

template <int MT>
cudaError_t launch(const Args& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ple_fused_infer_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (p.B + MT * 16 - 1) / (MT * 16) + p.D - 1;
  ple_fused_infer_kernel<MT><<<tiles, kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// emb [B, F] f32; did [B] domain ids, int64 when id64, else int32. counts:
// per level 4 ints (specific, shared, gate, shared-gate stages; the last
// level's shared-gate count is 0). w_ptrs/b_ptrs: host arrays of device
// pointers, one per stage in the order of the file's header (specific W [D,
// S, K, N], shared W [n_sh, K, N], gate W [D, K, N], shared gate W [K, N],
// tower W [D, K, N], head W [D, T, 1]); dims: (K, N) per stage. block_rows:
// rows of one block, a multiple of 16 up to 64, or 0: 32 where a 32-row tile
// fits in shared memory, else 16. Writes the dynamic shared memory a block
// of the tile it tried takes to *smem and returns a cudaError_t
// (cudaErrorInvalidValue when that tile does not fit, or the schedule takes
// more than kMaxSteps products or kMaxMixes mixes).
int ple_fused_infer_f32(const void* emb, const void* did, int id64, void* out, int B, int F,
                        int D, int S, int n_sh, int n_level, const void* counts, int n_tow,
                        const void* w_ptrs, const void* b_ptrs, const void* dims,
                        int block_rows, void* stream, size_t* smem) {
  *smem = 0;
  const int* c = static_cast<const int*>(counts);
  if (B < 0 || F < 1 || F > 30000 || D < 1 || D > kMaxDomains || S < 1 || n_sh < 1 ||
      n_level < 1 || n_level > kMaxLevels || n_tow < 0 || block_rows < 0 ||
      block_rows % 16 != 0 || block_rows > 16 * kMaxMT || D * S > 30000)
    return static_cast<int>(cudaErrorInvalidValue);
  int n = n_tow + 1, products = n_tow, mixes = 0;
  for (int l = 0; l < n_level; ++l) {
    const bool last = l == n_level - 1;
    const int* k = c + 4 * l;
    if (k[0] < 1 || k[1] < 1 || k[2] < 1 || (last ? k[3] != 0 : k[3] < 1))
      return static_cast<int>(cudaErrorInvalidValue);
    n += k[0] + k[1] + k[2] + k[3];
    products += last ? S * k[0] + n_sh * k[1] + k[2]
                     : D * S * k[0] + n_sh * k[1] + D * k[2] + k[3];
    mixes += last ? S + n_sh : 2 * D * S + n_sh * (D + 1);
  }
  if (products > kMaxSteps || mixes > kMaxMixes) return static_cast<int>(cudaErrorInvalidValue);
  const float* const* w = static_cast<const float* const*>(w_ptrs);
  const float* const* b = static_cast<const float* const*>(b_ptrs);
  const int* kn = static_cast<const int*>(dims);
  std::vector<Stage> st(n);
  for (int i = 0; i < n; ++i) {
    if (kn[2 * i] < 1 || kn[2 * i + 1] < 1 || kn[2 * i] > 30000 || kn[2 * i + 1] > 30000 ||
        w[i] == nullptr || b[i] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    st[i] = Stage{w[i], b[i], kn[2 * i], kn[2 * i + 1]};
  }

  // the schedule: per level its gates, then its experts mixing into the next
  // streams; then the own tower (the head reads its last tile)
  const int E = S + n_sh, n_all = D * S + n_sh;
  Schedule Sc;
  const int emb_tile = Sc.tile(F, 1, -1);  // loaded before the first step
  int xd = emb_tile, xsh = emb_tile, mixed = -1, width = F;
  const Stage* cur = st.data();
  for (int l = 0; l < n_level; ++l) {
    const bool last = l == n_level - 1;
    const int* k = c + 4 * l;
    const Stage *spec = cur, *shared = spec + k[0], *gate = shared + k[1], *gsh = gate + k[2];
    cur = gsh + k[3];
    const int H = spec[k[0] - 1].N;
    // each chain from the level's width to where the mixture needs it
    const Stage* chains[4] = {spec, shared, gate, gsh};
    const int ends[4] = {H, H, E, n_all};
    for (int i = 0; i < 4; ++i) {
      int wd = width;
      for (int s = 0; s < k[i]; ++s) {
        if (chains[i][s].K != wd) return static_cast<int>(cudaErrorInvalidValue);
        wd = chains[i][s].N;
      }
      if (k[i] && wd != ends[i]) return static_cast<int>(cudaErrorInvalidValue);
    }
    // stream d of this level: the emb tile, or member d of the last level's set
    auto stream = [&](int d) { return Ref{xd, xd == emb_tile ? 0 : d}; };
    if (!last) {
      std::vector<int> g(D);
      for (int d = 0; d < D; ++d) g[d] = Sc.chain(gate, k[2], D, d, 0, stream(d), true);
      const int gs = Sc.chain(gsh, k[3], 1, 0, 0, Ref{xsh, 0}, true);
      int y = -1, ysh = -1;
      for (int d = 0; d < D; ++d)
        for (int s = 0; s < S; ++s) {
          Sc.chain(spec, k[0], D * S, d * S + s, 0, stream(d), false);
          Sc.mix_into(&y, H, D, d, g[d], s, s == 0);
          Sc.mix_into(&ysh, H, 1, 0, gs, d * S + s, d == 0 && s == 0);
        }
      for (int j = 0; j < n_sh; ++j) {
        Sc.chain(shared, k[1], n_sh, j, 0, Ref{xsh, 0}, false);
        for (int d = 0; d < D; ++d) Sc.mix_into(&y, H, D, d, g[d], S + j, false);
        Sc.mix_into(&ysh, H, 1, 0, gs, D * S + j, false);
      }
      xd = y;
      xsh = ysh;
    } else {
      const Ref own{xd, xd == emb_tile ? 0 : -1};
      const int g = Sc.chain(gate, k[2], D, 0, 1, own, true);
      for (int s = 0; s < S; ++s) {
        Sc.chain(spec, k[0], D * S, s, S, own, false);
        Sc.mix_into(&mixed, H, 1, 0, g, s, s == 0);
      }
      for (int j = 0; j < n_sh; ++j) {
        Sc.chain(shared, k[1], n_sh, j, 0, Ref{xsh, 0}, false);
        Sc.mix_into(&mixed, H, 1, 0, g, S + j, false);
      }
    }
    width = H;
  }
  int head_in = mixed;
  for (int s = 0; s < n_tow; ++s, ++cur) {
    if (cur->K != width) return static_cast<int>(cudaErrorInvalidValue);
    head_in = Sc.product(*cur, D, 0, 1, Ref{head_in, 0}, kRelu);
    width = cur->N;
  }
  const Stage& head = *cur;
  if (head.K != width || head.N != 1) return static_cast<int>(cudaErrorInvalidValue);
  Sc.tiles.use(head_in, Sc.now());  // the head, after the last step
  const int arena_row = Sc.tiles.place();

  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t budget = static_cast<size_t>(optin);
  auto ring_slot = [&](int tb) {
    return size_ring(Sc.step.data(), Sc.now(), smem_bytes(tb, D, arena_row, 0), budget);
  };
  if (block_rows == 0)
    block_rows = smem_bytes(32, D, arena_row, ring_slot(32)) <= budget ? 32 : 16;
  const int slot = ring_slot(block_rows);
  for (Step& x : Sc.step)
    if (x.N < 8) {  // copy_narrow's slabs: stride 8
      x.narrow = 1;
      x.whole = 0;
      x.map = -1;
      x.sld = 8;
      x.srows = static_cast<short>(std::min((slot / 8) & ~7, round_up(x.K, 8)));
    }
  *smem = smem_bytes(block_rows, D, arena_row, slot);
  if (*smem > budget) return static_cast<int>(cudaErrorInvalidValue);

  Args p = {};
  const int M = block_rows;
  auto at = [&](Ref r) {
    return r.tile < 0 ? 0 : M * Sc.tiles.t[r.tile].at + std::max(r.member, 0) * M * Sc.ld[r.tile];
  };
  auto ld = [&](Ref r) { return static_cast<short>(r.tile < 0 ? 0 : Sc.ld[r.tile]); };
  for (int q = 0; q < Sc.now(); ++q) {
    Step& x = Sc.step[q];
    x.in = at(Sc.in[q]);
    x.ld_in = ld(Sc.in[q]);
    x.out = at(Sc.out[q]);
    x.ld_out = ld(Sc.out[q]);
    x.part = at(Sc.part[q]);
    x.ld_part = ld(Sc.part[q]);
    if (x.map >= 0 && !encode_map(x.w, x.K, x.N, Sc.members[q], x.srows, &p.map[x.map]))
      return static_cast<int>(cudaErrorNotSupported);
    p.step[q] = x;
  }
  for (size_t i = 0; i < Sc.mix.size(); ++i) {
    Mix& x = Sc.mix[i];
    x.to = at(Sc.to[i]);
    x.ld_to = ld(Sc.to[i]);
    x.gate = at(Sc.gate[i]);
    x.ld_gate = ld(Sc.gate[i]);
    p.mix[i] = x;
  }
  p.emb = static_cast<const float*>(emb);
  p.did = did;
  p.out = static_cast<float*>(out);
  p.fw = head.w;
  p.fb = head.b;
  p.id64 = id64;
  p.B = B; p.F = F; p.D = D; p.n_steps = Sc.now();
  p.emb_at = at(Ref{emb_tile, 0}); p.ld_emb = ld(Ref{emb_tile, 0});
  p.t = at(Ref{head_in, 0}); p.ld_t = ld(Ref{head_in, 0}); p.T = width;
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
