// Fused "shared trunk -> per-domain towers -> select" eval forward for NVIDIA
// Hopper (sm_90a), f32 in and out.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/tower_infer.py:
// trunk_towers_fused_infer. For each row b of emb[B, F]: a relu trunk of
// shared affine stages, then the relu tower of the row's own domain
// d = clip(int32(domain_id[b]), 0, D-1), then domain d's 1-unit head if there
// is one (else the last tower stage has width 1 and its relu comes before the
// sigmoid), then the sigmoid. The TPU kernel computes all D towers for every
// row and selects with jnp.where; the value per row is the same.
//
// It also replaces scenario_wise_rec_tpu/ops/pallas/adaptdhm_infer.py:
// adaptdhm_fused_infer, the same chain without a trunk and without biases: a
// step may have no bias. AdaptDHM's routed cluster c = clip(int32(router[b]),
// 0, C-1) is the domain, its relu stages the tower and its last, width-1
// stage the head.
//
// And scenario_wise_rec_tpu/ops/pallas/star_infer.py:star_fused_infer, as two
// chains from the emb tile: STAR's aux relu MLP of shared stages and its
// unrelu'd 1-unit head on the raw row, into a logit tile of its own; then the
// domain norm in place, g[d] * ((x - mean) * rstd) + b[d] (the batch's mean
// and rstd computed outside the kernel); then the FCN of domain d with a relu
// after every stage, the width-1 last one too; the sigmoid of the sum of the
// two logits.
//
// What bounds it on this card: arithmetic. At SharedBottom's Ali-CCP shape
// (F = 376, trunk [512], towers [256,128,64,32,16,8], head 8 -> 1, 3
// domains) a row costs 192,512 multiply-adds in the trunk and 174,728 in its
// own tower and head against ~1.5 KB of its own data: 3.008 GFLOP for B =
// 4096. As three TF32 products each on the tensor cores that is 3 x 3.008
// GFLOP / 495 TFLOP/s = 0.0182 ms; in f32 without tensor cores 0.0449 ms at
// 67 TFLOP/s (H100 SXM, 700 W); HBM bounds less. AdaptDHM's (F = 368, stages
// [256,128,64,32,16,8], then 8 -> 1, 3 clusters) costs 137,864 a row: 1.129
// GFLOP, 0.0068 ms in 3xTF32, 0.0169 ms in f32. STAR's (F = 376, aux [16]
// then 16 -> 1, FCN [256,128,64,32,16,8,1], 3 domains) costs 139,912 in its
// own FCN and 6,032 in the aux MLP a row: 1.196 GFLOP, 0.0072 ms in 3xTF32,
// 0.0179 ms in f32; its norm, 3 operations an element, adds ~4.6 MFLOP.
//
// What the design does about it (the split, the mma products, the ring and
// its bulk copies are mma_ring.cuh's; the partition by domain, the slab
// copies, the rotating accumulators, the tiles' placement and the ring's size
// are domain_tiles.cuh's, shared with ppnet_infer.cu, m3oe_infer.cu,
// adasparse_infer.cu and ple_infer.cu):
// - One domain a block: a block of 8 compute warps and a producer warp takes
//   a tile of up to tb rows of one domain, partitioned inside the one launch
//   from int32 or int64 ids, so it streams the trunk and its own domain's
//   tower once (1.5 MB at Ali-CCP), not one tower for each domain its rows
//   hold. The trunk is the same in every block: the partition costs at most
//   D - 1 partial tiles more than tiles of consecutive rows.
// - Every product in 3xTF32 mma.sync (f32's accuracy) through the ring: the
//   host lays out the chain of products (the trunk's stages, the own tower's,
//   the head), each from the tile the one before wrote. The producer warp
//   streams each product's W slab by slab (the 512-wide trunk stage one
//   tensor copy of a [rows, 256] box a slab, a slab of whole rows one bulk
//   copy); the compute warps run the same chain and meet at each chunk's
//   end. A warp with one or two n-tiles of a product (N <= 128) takes the
//   k-steps in turn into 4 or 2 sets of accumulators.
// - The epilogue adds the bias (none where the step has none: its loads are
//   skipped) and applies relu (not after the head) into the next tile;
//   columns from N to N rounded to 8 come out zero, which the next product
//   reads. A last pass writes the sigmoid of each row's column 0 (plus the
//   aux logit's, STAR's).
// - STAR's domain norm is a pass of the compute warps over the emb tile's
//   columns [0, F) just before the first FCN step, a column a thread, in the
//   plain version's order of operations; the pad columns stay zero. The
//   producer warp takes no part: it streams the FCN's first slabs meanwhile.
// - Shared memory: the host places each product's tiles by their lifetimes
//   (Tiles), and the ring takes what the peak leaves (size_ring): at 32
//   Ali-CCP rows the emb tile and the trunk's 512-wide tile take 120 KB; 48
//   rows fit, 64 do not. AdaptDHM's peak, the emb tile and the first
//   256-wide tile, is 648 floats a row: 64 rows fit. STAR's, at the first
//   FCN product, is the emb tile, the aux logit's and the 256-wide output:
//   684 floats a row, so 64 rows fit; at KuaiRand's F 800 it is 972 and 64
//   rows do not.
// Rows never mix: a NaN stays in its row. The last tile of a domain is
// partial; its missing rows are zero (after STAR's norm b - mean rstd g),
// computed and never written out.
//
// Bound through ctypes: a plain C interface, every pointer and the stream as
// void*, the cudaError_t of the launch returned.

#include <vector>

#include "domain_tiles.cuh"

namespace {

using namespace ring;

// Products a launch takes (trunk, tower and head stages; STAR's aux stages,
// aux head and FCN stages): the chain is a kernel parameter, past the 4 KB of
// old (CUDA 12.1 and later take 32,764 bytes).
constexpr int kMaxSteps = 96;

// A step: one product, v = x W + b, then relu (not after the head).
struct Step {
  const float* w;  // W [members, K, N] from member 0
  const float* b;  // b [members, N], or null: no bias
  int K, N;
  int in, out;        // tiles: float offsets in the arena
  int ld_in, ld_out;  // their row strides
  short srows, sld;   // weight rows a slab (a multiple of 8) and their stride in a slot
  unsigned char dmul;   // the member: the block's domain (1) or member 0 (0: trunk, aux)
  unsigned char relu;
  unsigned char whole;  // a slab is one bulk copy of whole rows (copy_whole)
  signed char map;  // a slab is one tensor copy of Args::map[map] (-1: whole or row copies)
};

struct Args {
  CUtensorMap map[kMaxMaps];  // W [members, K, N] of a product wider than a chunk
  const float* emb;  // [B, F]
  const void* did;   // [B], int64 when id64, else int32
  float* out;        // [B]
  int id64, B, F, D, n_steps;
  int emb_at, ld_emb;  // the emb tile
  int t, ld_t;         // the last tile: the logit in column 0
  int aux_t, ld_aux;   // the tile of a logit the sigmoid pass adds (-1: none)
  int norm_at;         // the step before which the domain norm runs (-1: none)
  const float* mean;   // [F] the norm's batch mean and rstd,
  const float* rstd;   // [F]
  const float* gamma;  // [D, F] and each domain's gamma and beta
  const float* beta;   // [D, F]
  int arena, slot;     // floats of the tiles and of a ring slot
  Step step[kMaxSteps];
};
static_assert(sizeof(Args) <= 32764, "the kernel parameters' limit");

// STAR's domain norm of domain dom in place over the columns [0, F) of the
// emb tile x [M, ld_emb], g[dom] * ((x - mean) * rstd) + b[dom] rounded as the
// plain version rounds it (no fused multiply-add); the pad columns stay zero.
// The compute warps, a column a thread. Not synchronised.
template <int M>
__device__ __forceinline__ void domain_norm(const Args& p, int dom, float* x) {
  const float* g = p.gamma + static_cast<size_t>(dom) * p.F;
  const float* b = p.beta + static_cast<size_t>(dom) * p.F;
  for (int k = threadIdx.x; k < p.F; k += kComputeThreads) {
    const float mu = __ldg(p.mean + k), rs = __ldg(p.rstd + k);
    const float gk = __ldg(g + k), bk = __ldg(b + k);
#pragma unroll 8
    for (int r = 0; r < M; ++r) {
      float* v = x + r * p.ld_emb + k;
      *v = __fadd_rn(__fmul_rn(gk, __fmul_rn(__fsub_rn(*v, mu), rs)), bk);
    }
  }
}

// A finished chunk of step st's product: bias, then relu where the step has
// it, into the step's tile (rows of the tile, columns c0 + the warp's
// n-tiles; the columns past N come out zero). Resets the accumulators.
template <int MT>
__device__ __forceinline__ void epilogue(const Step& st, float (&acc)[MT][kNTW][4],
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
          if (st.relu) {
            v0 = relu(v0);
            v1 = relu(v1);
          }
          *reinterpret_cast<float2*>(arena + st.out + r * st.ld_out + col) = make_float2(v0, v1);
        }
      }
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
tower_fused_infer_kernel(const __grid_constant__ Args p) {
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
      const int member = st.dmul * dom;
      for (int c = 0; c * kChunk < st.N; ++c) {
        for (int k0 = 0; k0 < st.K; k0 += st.srows, ++s) {
          const int slot = s % kRing;
          bar_wait(empty + 8 * slot, ((s / kRing) & 1) ^ 1);  // the first pass finds it free
          if (st.map >= 0)
            tensor_slab(&p.map[st.map], member, st.srows, c, k0, ring + slot * p.slot,
                        full + 8 * slot, lane);
          else
            issue_product_slab(st.w, member, st.K, st.N, st.srows, st.sld, st.whole, c, k0,
                               ring + slot * p.slot, full + 8 * slot, lane);
        }
      }
    }
  } else {
    // 4. the steps in order: each product from the ring, then its epilogue
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
      if (q == p.norm_at) {
        domain_norm<M>(p, dom, arena + p.emb_at);
        compute_sync();  // the normalised tile, before the step reads it
      }
      const float* A = arena + st.in;
      for (int c = 0; c * kChunk < st.N; ++c) {
        const int c0 = c * kChunk;
        const int nt = (min(kChunk, st.N - c0) + 7) / 8;
        const int tiles = (nt + kWarps - 1) / kWarps;  // n-tiles a warp
        if (st.b != nullptr) {
          load_bias(bias, st.b + static_cast<size_t>(st.dmul * dom) * st.N, nt, c0, st.N, warp,
                    t);
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
        epilogue<MT>(st, acc, bias, nt, c0, arena, warp, g, t);
        compute_sync();  // the chunk, before the next product reads it
      }
    }
  }
  __syncthreads();

  // 5. the sigmoid of each row's logit (plus its aux logit, STAR's)
  for (int r = threadIdx.x; r < n_rows; r += kThreads) {
    float v = arena[p.t + r * p.ld_t];
    if (p.aux_t >= 0) v += arena[p.aux_t + r * p.ld_aux];
    p.out[rows_s[r]] = sigmoid(v);
  }
}

size_t smem_bytes(int tb, int D, int arena_row, int slot) {
  const size_t floats = static_cast<size_t>(tb) * arena_row + static_cast<size_t>(kRing) * slot;
  return kHeadBytes + floats * sizeof(float) +
         (static_cast<size_t>(tb) + static_cast<size_t>(kAllWarps) * D + 2) * sizeof(int);
}

template <int MT>
cudaError_t launch(const Args& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(tower_fused_infer_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (p.B + MT * 16 - 1) / (MT * 16) + p.D - 1;
  tower_fused_infer_kernel<MT><<<tiles, kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

bool rows_ok(int block_rows) {
  return block_rows >= 0 && block_rows % 16 == 0 && block_rows <= 16 * kMaxMT;
}

// Chains of products and their activation tiles, laid out on the host from
// the host arrays of the stages (W and b device pointers, (K, N) a stage), a
// step for each stage in their order. The emb tile is loaded before the
// first step.
struct Plan {
  const float* const* w;
  const float* const* b;
  const int* kn;
  Tiles tiles;
  int emb;
  std::vector<Step> steps;
  std::vector<int> in, out;
  int norm_at = -1;  // the step before which the domain norm runs (-1: none)
  int aux = -1;      // the tile of a logit the sigmoid pass adds (-1: none)

  Plan(const void* w_ptrs, const void* b_ptrs, const void* dims, int F)
      : w(static_cast<const float* const*>(w_ptrs)),
        b(static_cast<const float* const*>(b_ptrs)),
        kn(static_cast<const int*>(dims)),
        emb(tiles.add(F, -1)) {}

  // The next n stages as a chain from tile x, each from the tile the one
  // before wrote: of member 0 (dmul 0) or the block's domain (dmul 1), relu
  // after each but, where `head`, the last. The last writes tile `into`
  // where given, else a new tile. Returns the last tile, or -1 where a stage
  // has no W or does not follow its input's width, or past kMaxSteps.
  int chain(int n, int x, int dmul, bool head, int into = -1) {
    for (int i = 0; i < n; ++i) {
      const int q = static_cast<int>(steps.size());
      if (q >= kMaxSteps) return -1;
      Step s = {};
      s.w = w[q];
      s.b = b[q];
      s.K = kn[2 * q];
      s.N = kn[2 * q + 1];
      const bool last = i == n - 1;
      if (s.w == nullptr || s.K != tiles.t[x].width || s.N < 1 ||
          (last && into >= 0 && tiles.t[into].width != s.N))
        return -1;
      s.dmul = static_cast<unsigned char>(dmul);
      s.relu = !(head && last);
      tiles.use(x, q);
      in.push_back(x);
      x = last && into >= 0 ? into : tiles.add(s.N, q);
      out.push_back(x);
      steps.push_back(s);
    }
    return x;
  }
};

// What both entry points share once the chains are laid out: the tiles
// placed (the sigmoid pass reads tile `logit` and plan.aux after the last
// step), the tile chosen (block_rows 0: 32 where a 32-row tile fits, else
// 16) and the ring sized beside it, the steps' places and tensor maps
// written into p, and the launch. Writes the dynamic shared memory a block of
// the tile it tried takes to *smem; returns a cudaError_t
// (cudaErrorInvalidValue when that tile does not fit).
int run(Plan& plan, Args& p, int logit, int block_rows, void* stream, size_t* smem) {
  const int n = static_cast<int>(plan.steps.size());
  Tiles& tiles = plan.tiles;
  tiles.use(logit, n);
  tiles.use(plan.aux, n);
  const int arena_row = tiles.place();

  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t budget = static_cast<size_t>(optin);
  auto ring_slot = [&](int tb) {
    return size_ring(plan.steps.data(), n, smem_bytes(tb, p.D, arena_row, 0), budget);
  };
  if (block_rows == 0)
    block_rows = smem_bytes(32, p.D, arena_row, ring_slot(32)) <= budget ? 32 : 16;
  const int slot = ring_slot(block_rows);
  *smem = smem_bytes(block_rows, p.D, arena_row, slot);
  if (*smem > budget) return static_cast<int>(cudaErrorInvalidValue);

  const int M = block_rows;
  auto at = [&](int tile) { return M * tiles.t[tile].at; };
  auto ld = [&](int tile) { return ld_act(tiles.t[tile].width); };
  for (int q = 0; q < n; ++q) {
    Step& s = plan.steps[q];
    s.in = at(plan.in[q]);
    s.ld_in = ld(plan.in[q]);
    s.out = at(plan.out[q]);
    s.ld_out = ld(plan.out[q]);
    if (s.map >= 0 &&
        !encode_map(s.w, s.K, s.N, s.dmul ? p.D : 1, s.srows, &p.map[s.map]))
      return static_cast<int>(cudaErrorNotSupported);
    p.step[q] = s;
  }
  p.n_steps = n;
  p.emb_at = at(plan.emb); p.ld_emb = ld(plan.emb);
  p.t = at(logit); p.ld_t = ld(logit);
  p.aux_t = plan.aux >= 0 ? at(plan.aux) : -1;
  p.ld_aux = plan.aux >= 0 ? ld(plan.aux) : 0;
  p.norm_at = plan.norm_at;
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

// emb [B, F] f32; did [B] domain ids, int64 when id64, else int32.
// w_ptrs/b_ptrs: host arrays of device pointers, one per stage, in the order
// trunk stages (W [K, N]), tower stages (W [D, K, N]), head (W [D, K, 1],
// when has_head), a null b for a stage without bias; dims: (K, N) per
// stage. block_rows: rows of one block, a multiple of 16 up to 64, or 0: 32
// where a 32-row tile fits in shared memory, else 16. Writes the dynamic
// shared memory a block of the tile it tried takes to *smem and returns a
// cudaError_t (cudaErrorInvalidValue when that tile does not fit, or the
// chain takes more than kMaxSteps products).
int tower_fused_infer_f32(const void* emb, const void* did, int id64, void* out, int B, int F,
                          int D, int n_trunk, int n_tow, int has_head, const void* w_ptrs,
                          const void* b_ptrs, const void* dims, int block_rows, void* stream,
                          size_t* smem) {
  *smem = 0;
  if (B < 0 || F < 1 || D < 1 || D > kMaxDomains || n_trunk < 0 || n_tow < 0 ||
      n_trunk + n_tow + (has_head ? 1 : 0) < 1 || !rows_ok(block_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  // the trunk from the emb tile, then the own tower and head
  Plan plan(w_ptrs, b_ptrs, dims, F);
  int x = plan.chain(n_trunk, plan.emb, 0, false);
  if (x >= 0) x = plan.chain(n_tow + (has_head ? 1 : 0), x, 1, has_head);
  if (x < 0 || plan.tiles.t[x].width != 1) return static_cast<int>(cudaErrorInvalidValue);

  Args p = {};
  p.emb = static_cast<const float*>(emb);
  p.did = did;
  p.out = static_cast<float*>(out);
  p.id64 = id64;
  p.B = B; p.F = F; p.D = D;
  return run(plan, p, x, block_rows, stream, smem);
}

// STAR: emb [B, F] f32; did [B] domain ids, int64 when id64, else int32;
// mean, rstd [F], gamma, beta [D, F] f32. w_ptrs/b_ptrs: host arrays of
// device pointers, one per stage, in the order aux stages (W [K, N], b [N]),
// the aux head (W [K, 1], b [1]), FCN stages (W [D, K, N], b [D, N]); dims:
// (K, N) per stage. block_rows, *smem and the returned cudaError_t as
// tower_fused_infer_f32's; both chains must end at width 1.
int star_fused_infer_f32(const void* emb, const void* did, int id64, void* out, int B, int F,
                         int D, int n_aux, int n_fcn, const void* mean, const void* rstd,
                         const void* gamma, const void* beta, const void* w_ptrs,
                         const void* b_ptrs, const void* dims, int block_rows, void* stream,
                         size_t* smem) {
  *smem = 0;
  if (B < 0 || F < 1 || D < 1 || D > kMaxDomains || n_aux < 0 || n_fcn < 1 ||
      !rows_ok(block_rows) || mean == nullptr || rstd == nullptr || gamma == nullptr ||
      beta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // the aux stages and head from the emb tile into the aux logit's tile, made
  // first so that it lies beside the emb tile and the FCN's first output
  // fits after both; the norm, in place; the FCN from the emb tile
  Plan plan(w_ptrs, b_ptrs, dims, F);
  plan.aux = plan.tiles.add(1, n_aux);
  const int aux = plan.chain(n_aux + 1, plan.emb, 0, true, plan.aux);
  plan.norm_at = static_cast<int>(plan.steps.size());
  const int x = aux < 0 ? -1 : plan.chain(n_fcn, plan.emb, 1, false);
  if (x < 0 || plan.tiles.t[x].width != 1) return static_cast<int>(cudaErrorInvalidValue);

  Args p = {};
  p.emb = static_cast<const float*>(emb);
  p.did = did;
  p.out = static_cast<float*>(out);
  p.id64 = id64;
  p.B = B; p.F = F; p.D = D;
  p.mean = static_cast<const float*>(mean);
  p.rstd = static_cast<const float*>(rstd);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  return run(plan, p, x, block_rows, stream, smem);
}

}  // extern "C"
