// Fused M3oE eval forward for NVIDIA Hopper (sm_90a), f32 in and out.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/m3oe_infer.py:
// m3oe_fused_infer. Per row, d = clip(int32(domain_id), 0, D-1):
//   skip  = Mlp_N(emb)                       (Linear -> LayerNorm -> relu),
//   star  = emb W_star[d] + b_star[d]        (slot_w ⊙ shared_w),
//   e     = Mlp_N(star) + skip,
//   fea_i = Mlp_N_i(e) for the E shared experts,
//   dom_k = Mlp_N_k(e) for EVERY domain k (the balance mix sums them all),
//   g     = softmax(e W_gate[d] + b_gate[d]),
//   fused = sum_i g_i fea_i + w_exp ((w_bal - off) dom_d + off sum_k dom_k),
//           off = (1 - w_bal) / (D - 1)  (w_exp w_bal dom_d when D == 1),
//   prob  = sigmoid(Linear(relu(LayerNorm(Linear(fused))))) of domain d.
// The TPU kernel computes every domain's slot, gate and tower and selects;
// here a row computes only its own domain's (the value is the same).
//
// What bounds it on this card: arithmetic. At M3oE's Ali-CCP shape (F 376,
// star [512, 256], 4 experts and 3 domain experts 256 -> 64, tower 64) a row
// costs 539,712 multiply-adds (the own star slot 192,512, the skip 96,256,
// the star MLP 131,072, the 7 experts 114,688, the gate 1,024, the tower
// 4,160) against ~1.5 KB of its own data: 4.421 GFLOP of products for B =
// 4096. As three TF32 products each on the tensor cores that is 3 x 4.421
// GFLOP / 495 TFLOP/s = 0.027 ms; in f32 without tensor cores 0.066 ms at
// 67 TFLOP/s (H100 SXM, 700 W); HBM bounds less.
//
// What the design does about it (the split, the mma products, the ring and
// its bulk copies are mma_ring.cuh's; the partition by domain, the slab of
// whole rows, the rotating accumulators and the head are domain_tiles.cuh's,
// shared with ppnet_infer.cu):
// - One domain a block: a block of 8 compute warps and a producer warp takes
//   a tile of up to tb rows of one domain, partitioned inside the one launch
//   from int32 or int64 ids, so it streams one star slot W_star[d] (0.77 MB
//   at Ali-CCP), not one for each domain its rows hold.
// - Every product in 3xTF32 mma.sync (f32's accuracy: a LayerNorm rescales
//   the error of the product before it, so 1xTF32 or bf16 would not do),
//   the weights streamed slab by slab through the ring. The host lays out a
//   schedule of steps, each a product (K, N, W, b, input and output tiles)
//   and the row pass after it; the producer warp streams each product's W of
//   its member (the domain, an expert, a domain expert), the compute warps
//   consume the same schedule and meet at each step's end. One product an
//   expert: the experts' first layers as one product of E x 64 columns, each
//   member's slab in its own part of the slot, ran slower on an H100 (PERF.md,
//   section 6).
// - A slab is one copy: whole rows (N a multiple of 8 up to kChunk) one bulk
//   copy, and a product wider than a chunk (the star slot, 512 wide at
//   Ali-CCP) one tensor copy of a [srows, kChunk] box (TMA, domain_tiles.cuh's
//   tensor_slab): with a bulk copy a row the star slot waited on its slabs
//   (PERF.md, section 6).
// - A LayerNorm is a reduction across a row's output columns, which the
//   compute warps hold in parts: a product's epilogue writes x W + b to
//   shared memory, the compute warps meet, and a pass takes each row's mean
//   and biased variance (eps 1e-5) by sums over 8 lanes, a warp 4 rows side by
//   side (the chain of sums paces the pass, not the width: a warp a row, its
//   rows in turn, was slower), and rewrites the row normalised, scaled,
//   shifted and relu'd. The star MLP's last pass adds the skip (e = ... +
//   skip); the gate's pass is its softmax.
// - The mix without E + D buffers: the own gate and its softmax run before
//   the experts, and each expert's last pass adds its normalised output times
//   its coefficient into one fused tile: g_i for shared expert i, w_exp w_bal
//   for the own domain's expert and w_exp off for every other domain's.
// - Shared memory: the host places each step's tiles by their lifetimes
//   (first fit, domain_tiles.cuh's Tiles), so the emb tile, dead after the skip and the star slot, and
//   the star tile, dead after the star MLP, hold the later tiles; the ring
//   takes what the peak (emb, skip and star tiles: 149 KB at 32 Ali-CCP rows,
//   so 48 and 64 rows do not fit) leaves. The 1-wide tower head is a warp a
//   row.
// What holds it now (PERF.md, section 6): the wide products run at the rate
// of the compute warps' fragment loads, splits and mma.sync issue, as in
// mmoe_infer.cu; the 7 narrow expert products (one n-tile a warp, 32 k-steps
// in turn) and their passes take about a third of the time.
// Rows never mix: a NaN stays in its row. The last tile of a domain is
// partial; its missing rows are zero and never written out.
//
// Bound through ctypes: a plain C interface, every pointer and the stream as
// void*, the cudaError_t of the launch returned.

#include <math.h>

#include <algorithm>
#include <vector>

#include "domain_tiles.cuh"

namespace {

using namespace ring;

constexpr int kMaxSteps = 48;  // products a launch: the step list is a kernel parameter
constexpr float kEps = 1e-5f;
enum { kSkip, kStarMlp, kExperts, kDomExperts, kChains };

// the pass over a step's output rows after its product
enum Pass : unsigned char {
  kNone,     // out = x W + b (the star slot)
  kLn,       // out = relu(LayerNorm(out)), in place
  kLnPlus,   // out = relu(LayerNorm(out)) + aux (the star MLP's last layer: + skip)
  kLnMix,    // fused (=, +=) coef * relu(LayerNorm(out)) (an expert's last layer)
  kSoftmax,  // out = softmax(out) (the gate)
};

// A step: a product, then the pass over its output.
struct Step {
  const float* w;   // W [members, K, N] from the step's member (per_dom: from member 0)
  const float* b;   // b [members, N], likewise
  const float* g;   // the LayerNorm's gamma and beta [members, N], likewise
  const float* be;
  int K, N;
  int in, out, aux;              // tiles: float offsets in the arena
  short ld_in, ld_out, ld_aux;   // and their row strides
  short srows, sld;  // weight rows a slab (a multiple of 8) and their stride in a slot
  short coef;        // kLnMix: the gate's column i (shared expert i), or -1 - k (domain expert k)
  unsigned char pass, per_dom, whole, first;  // first: kLnMix writes the fused tile (=)
  signed char map;   // a slab is one tensor copy of Args::map[map] (-1: whole or row copies)
};

struct Args {
  CUtensorMap map[kMaxMaps];  // W [members, K, N] of a product wider than a chunk, a
                              // box of kChunk columns by srows rows
  const float* emb;    // [B, F]
  const void* did;     // [B], int64 when id64, else int32
  float* out;          // [B]
  const float* w_exp;  // [1]
  const float* w_bal;  // [1]
  const float* fw;     // the tower head W [D, T, 1]
  const float* fb;     // b [D, 1]
  int id64, B, F, D, n_steps;
  int emb_at, ld_emb;      // the emb tile
  int gate, ld_gate;       // the gate's tile (kLnMix reads g_i there)
  int fused, ld_fused;     // the fused tile
  int t, ld_t, T;          // the tower's hidden tile, read by the head
  int arena, slot;         // floats of the tiles and of a ring slot
  Step step[kMaxSteps];
};
static_assert(sizeof(Args) <= 4096, "the kernel parameters' limit");

// A finished chunk of a product: out = acc + bias (rows of the tile, columns
// c0 + the warp's n-tiles; columns past N come out zero). Resets the
// accumulators.
template <int MT>
__device__ __forceinline__ void store_chunk(float (&acc)[MT][kNTW][4],
                                            const float (&bias)[kNTW][2], int nt, int c0,
                                            float* out, int ldo, int warp, int g, int t) {
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
              make_float2(acc[m][i][2 * h] + bias[i][0], acc[m][i][2 * h + 1] + bias[i][1]);
          acc[m][i][2 * h] = acc[m][i][2 * h + 1] = 0.f;
        }
      }
    }
  }
}

// The pass after step st's product over the tile's M rows: 8 lanes a row, a
// warp 4 rows side by side (a row's chain of sums over lanes, not its width,
// is what the pass waits on). Columns past N are left as they are (zero), but
// for the fused tile's first write, which zeroes them up to N rounded to 8
// (the tower reads them).
__device__ __forceinline__ void row_pass(const Args& p, const Step& st, float* arena, int M,
                                         int member, int dom, float w_exp, float w_bal,
                                         float off, int warp, int lane) {
  const int N = st.N, q = lane & 7;
  for (int r = 4 * warp + lane / 8; r < M; r += 4 * kWarps) {
    float* v = arena + st.out + r * st.ld_out;
    if (st.pass == kSoftmax) {
      float mx = -INFINITY;
      for (int j = q; j < N; j += 8) mx = fmaxf(mx, v[j]);
      mx = row_max(mx);
      float s = 0.f;
      for (int j = q; j < N; j += 8) s += expf(v[j] - mx);
      s = row_sum(s);
      for (int j = q; j < N; j += 8) v[j] = expf(v[j] - mx) / s;
      continue;
    }
    float s = 0.f;
    for (int j = q; j < N; j += 8) s += v[j];
    const float mean = row_sum(s) / N;
    float d2 = 0.f;
    for (int j = q; j < N; j += 8) {
      const float c = v[j] - mean;
      d2 = fmaf(c, c, d2);
    }
    const float rstd = 1.f / sqrtf(row_sum(d2) / N + kEps);
    const float* __restrict__ g = st.g + static_cast<size_t>(member) * N;
    const float* __restrict__ be = st.be + static_cast<size_t>(member) * N;
    if (st.pass == kLn) {
      for (int j = q; j < N; j += 8)
        v[j] = relu((v[j] - mean) * rstd * __ldg(g + j) + __ldg(be + j));
    } else if (st.pass == kLnPlus) {
      const float* a = arena + st.aux + r * st.ld_aux;
      for (int j = q; j < N; j += 8)
        v[j] = relu((v[j] - mean) * rstd * __ldg(g + j) + __ldg(be + j)) + a[j];
    } else {  // kLnMix
      const int k = -1 - st.coef;
      const float c = st.coef >= 0 ? arena[p.gate + r * p.ld_gate + st.coef]
                                   : w_exp * (k == dom ? w_bal : off);
      float* f = arena + p.fused + r * p.ld_fused;
      for (int j = q; j < N; j += 8) {
        const float y = relu((v[j] - mean) * rstd * __ldg(g + j) + __ldg(be + j));
        f[j] = st.first ? c * y : fmaf(c, y, f[j]);
      }
      if (st.first)
        for (int j = N + q; j < round_up(N, 8); j += 8) f[j] = 0.f;
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
m3oe_fused_infer_kernel(const __grid_constant__ Args p) {
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
    // 4p. the producer warp: each product's W of its member, slab by slab,
    //     through the ring, as far ahead as the compute warps free slots
    int s = 0;
    for (int q = 0; q < p.n_steps; ++q) {
      const Step& st = p.step[q];
      const int member = st.per_dom ? dom : 0;
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
    // 4. the steps in schedule order: each product from the ring, then its pass
    const float w_exp = __ldg(p.w_exp), w_bal = __ldg(p.w_bal);
    const float off = p.D > 1 ? (1.f - w_bal) / static_cast<float>(p.D - 1) : 0.f;
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
      const int member = st.per_dom ? dom : 0;
      const float* A = arena + st.in;
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
        store_chunk<MT>(acc, bias, nt, c0, arena + st.out, st.ld_out, warp, g, t);
        compute_sync();  // the chunk, before the pass or the next product reads it
      }
      if (st.pass != kNone) {
        row_pass(p, st, arena, M, member, dom, w_exp, w_bal, off, warp, lane);
        compute_sync();
      }
    }
  }
  __syncthreads();

  // 5. the tower head and the sigmoid, a warp a row
  head_rows(arena + p.t, p.ld_t, p.T, p.fw, p.fb, dom, rows_s, n_rows, p.out);
}

// A dense stage W [members..., K, N], b [members..., N] and, when a
// LayerNorm follows, its gamma and beta [members..., N].
struct LnStage {
  const float* w;
  const float* b;
  const float* g;
  const float* be;
  int K, N;
};

// The steps of the schedule and their tiles, in the order the kernel runs
// them: the skip chain, the star slot, the star MLP (its last pass adds the
// skip), the gate and its softmax, each shared expert's chain and each
// domain expert's (their last passes mix into the fused tile), the tower's
// first Linear and its LayerNorm; the head reads the tower's tile after the
// last step.
struct Schedule {
  Tiles tiles;
  Step step[kMaxSteps];
  int in[kMaxSteps], out[kMaxSteps], aux[kMaxSteps];  // tile indices, -1: none
  int n = 0, emb, gate = -1, fused = -1, t = -1;

  int tile(int width) { return tiles.add(width, n); }
  void use(int i) { tiles.use(i, n); }
  // a product of stage S's member `member` (per_dom: the block's domain)
  // from tile x into a new tile, then its pass; returns the new tile
  int add(const LnStage& S, int member, bool per_dom, int x, Pass pass, int aux_tile = -1,
          int coef = 0) {
    Step& q = step[n];
    q = Step{};
    const size_t kn = static_cast<size_t>(S.K) * S.N;
    q.w = S.w + member * kn;
    q.b = S.b + static_cast<size_t>(member) * S.N;
    q.g = S.g ? S.g + static_cast<size_t>(member) * S.N : nullptr;
    q.be = S.be ? S.be + static_cast<size_t>(member) * S.N : nullptr;
    q.K = S.K;
    q.N = S.N;
    const int y = tile(S.N);
    q.pass = pass;
    q.per_dom = per_dom;
    q.coef = static_cast<short>(coef);
    in[n] = x;
    out[n] = y;
    aux[n] = aux_tile;
    use(x);
    use(aux_tile);
    if (pass == kLnMix) {
      q.first = fused < 0;
      if (fused < 0) fused = tile(S.N);
      use(fused);
      if (coef >= 0) use(gate);
    }
    ++n;
    return y;
  }
  // an Mlp_N chain of `count` layers from tile x, member `member`; the last
  // layer's pass is `last`
  int chain(const LnStage* st, int count, int member, int x, Pass last, int aux_tile = -1,
            int coef = 0) {
    for (int l = 0; l < count; ++l)
      x = add(st[l], member, false, x, l == count - 1 ? last : kLn,
              l == count - 1 ? aux_tile : -1, coef);
    return x;
  }
};

size_t smem_bytes(int tb, int D, int arena_row, int slot) {
  const size_t floats = static_cast<size_t>(tb) * arena_row + static_cast<size_t>(kRing) * slot;
  return kHeadBytes + floats * sizeof(float) +
         (static_cast<size_t>(tb) + static_cast<size_t>(kAllWarps) * D + 2) * sizeof(int);
}

// The ring slot of a tb-row tile in `budget` bytes of shared memory
// (domain_tiles.cuh's size_ring); sets each step's copy, slab rows and stride.
int ring_slot(Schedule& S, int tb, int D, int arena_row, size_t budget) {
  return size_ring(S.step, S.n, smem_bytes(tb, D, arena_row, 0), budget);
}

template <int MT>
cudaError_t launch(const Args& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(m3oe_fused_infer_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (p.B + MT * 16 - 1) / (MT * 16) + p.D - 1;
  m3oe_fused_infer_kernel<MT><<<tiles, kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// emb [B, F] f32; did [B] domain ids, int64 when id64, else int32. counts:
// the layers of the skip, star MLP, expert and domain expert chains (4
// ints). w_ptrs/b_ptrs/g_ptrs/be_ptrs: host arrays of device pointers, one
// per stage in the order: the star slot (W [D, F, s1]), the skip layers, the
// star MLP layers, the expert layers (W [E, in, out]), the domain expert
// layers (W [D, in, out]), the gate (W [D, s2, E]), the tower's first Linear
// with its LayerNorm (W [D, H, T]), the tower head (W [D, T, 1]); g/be null
// where no LayerNorm follows (the star slot, the gate, the head); dims: (K, N)
// per stage. w_exp/w_bal: device pointers to one float each. block_rows:
// rows of one block, a multiple of 16 up to 64, or 0: 32 where a 32-row tile
// fits in shared memory, else 16. Writes the dynamic shared memory a block of
// the tile it tried takes to *smem and returns a cudaError_t
// (cudaErrorInvalidValue when that tile does not fit).
int m3oe_fused_infer_f32(const void* emb, const void* did, int id64, void* out, int B, int F,
                         int D, int E, const void* counts, const void* w_ptrs,
                         const void* b_ptrs, const void* g_ptrs, const void* be_ptrs,
                         const void* dims, const void* w_exp, const void* w_bal,
                         int block_rows, void* stream, size_t* smem) {
  *smem = 0;
  const int* c = static_cast<const int*>(counts);
  if (B < 0 || F < 1 || D < 1 || D > kMaxDomains || E < 1 || block_rows < 0 ||
      block_rows % 16 != 0 || block_rows > 16 * kMaxMT)
    return static_cast<int>(cudaErrorInvalidValue);
  int n = 4;  // the star, the gate, the tower's two stages
  for (int i = 0; i < kChains; ++i) {
    if (c[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    n += c[i];
  }
  if (c[kSkip] + c[kStarMlp] + E * c[kExperts] + D * c[kDomExperts] + 3 > kMaxSteps)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* const* w = static_cast<const float* const*>(w_ptrs);
  const float* const* b = static_cast<const float* const*>(b_ptrs);
  const float* const* g = static_cast<const float* const*>(g_ptrs);
  const float* const* be = static_cast<const float* const*>(be_ptrs);
  const int* kn = static_cast<const int*>(dims);
  std::vector<LnStage> st(n);
  for (int s = 0; s < n; ++s) {
    const bool norm = s > 0 && s != n - 3 && s != n - 1;  // not star, gate or head
    if (kn[2 * s] < 1 || kn[2 * s + 1] < 1 || w[s] == nullptr || b[s] == nullptr ||
        norm != (g[s] != nullptr) || norm != (be[s] != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    st[s] = LnStage{w[s], b[s], g[s], be[s], kn[2 * s], kn[2 * s + 1]};
  }
  // widths: star F -> s1; skip F -> s2; star MLP s1 -> s2; both expert
  // chains s2 -> H; gate s2 -> E; tower H -> T -> 1
  const int s1 = st[0].N;
  if (st[0].K != F) return static_cast<int>(cudaErrorInvalidValue);
  const LnStage* first[kChains + 1];  // each chain's first layer; the gate last
  first[0] = st.data() + 1;
  for (int i = 0; i < kChains; ++i) first[i + 1] = first[i] + c[i];
  const int start[kChains] = {F, s1, -1, -1};
  int ends[kChains] = {0, 0, 0, 0};
  for (int i = 0; i < kChains; ++i) {
    int width = start[i] >= 0 ? start[i] : ends[kSkip];
    for (int s = 0; s < c[i]; ++s) {
      if (first[i][s].K != width) return static_cast<int>(cudaErrorInvalidValue);
      width = first[i][s].N;
    }
    ends[i] = width;
  }
  const int s2 = ends[kSkip], H = ends[kExperts];
  const LnStage &gate = first[kChains][0], &l1 = first[kChains][1], &head = first[kChains][2];
  if (ends[kStarMlp] != s2 || ends[kDomExperts] != H || gate.K != s2 || gate.N != E ||
      l1.K != H || head.K != l1.N || head.N != 1)
    return static_cast<int>(cudaErrorInvalidValue);

  Schedule S;
  S.emb = S.tile(F);
  S.tiles.t[S.emb].first = -1;  // loaded before the first step
  const int skip = S.chain(first[kSkip], c[kSkip], 0, S.emb, kLn);
  const int star = S.add(st[0], 0, true, S.emb, kNone);
  const int e = S.chain(first[kStarMlp], c[kStarMlp], 0, star, kLnPlus, skip);
  S.gate = S.add(gate, 0, true, e, kSoftmax);
  for (int i = 0; i < E; ++i) S.chain(first[kExperts], c[kExperts], i, e, kLnMix, -1, i);
  for (int k = 0; k < D; ++k) S.chain(first[kDomExperts], c[kDomExperts], k, e, kLnMix, -1, -1 - k);
  S.t = S.add(l1, 0, true, S.fused, kLn);
  S.use(S.t);  // the head, after the last step
  const int arena_row = S.tiles.place();

  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t budget = static_cast<size_t>(optin);
  if (block_rows == 0)
    block_rows = smem_bytes(32, D, arena_row, ring_slot(S, 32, D, arena_row, budget)) <= budget
                     ? 32 : 16;
  const int slot = ring_slot(S, block_rows, D, arena_row, budget);
  *smem = smem_bytes(block_rows, D, arena_row, slot);
  if (*smem > budget) return static_cast<int>(cudaErrorInvalidValue);

  Args p = {};
  const int M = block_rows;
  auto at = [&](int i) { return i < 0 ? 0 : M * S.tiles.t[i].at; };
  auto ld = [&](int i) { return static_cast<short>(i < 0 ? 0 : ld_act(S.tiles.t[i].width)); };
  for (int q = 0; q < S.n; ++q) {
    Step& x = S.step[q];
    x.in = at(S.in[q]);
    x.ld_in = ld(S.in[q]);
    x.out = at(S.out[q]);
    x.ld_out = ld(S.out[q]);
    x.aux = at(S.aux[q]);
    x.ld_aux = ld(S.aux[q]);
    if (x.map >= 0 && !encode_map(x.w, x.K, x.N, x.per_dom ? D : 1, x.srows, &p.map[x.map]))
      return static_cast<int>(cudaErrorNotSupported);
    p.step[q] = x;
  }
  p.emb = static_cast<const float*>(emb);
  p.did = did;
  p.out = static_cast<float*>(out);
  p.w_exp = static_cast<const float*>(w_exp);
  p.w_bal = static_cast<const float*>(w_bal);
  p.fw = head.w;
  p.fb = head.b;
  p.id64 = id64;
  p.B = B; p.F = F; p.D = D; p.n_steps = S.n;
  p.emb_at = at(S.emb); p.ld_emb = ld(S.emb);
  p.gate = at(S.gate); p.ld_gate = ld(S.gate);
  p.fused = at(S.fused); p.ld_fused = ld(S.fused);
  p.t = at(S.t); p.ld_t = ld(S.t); p.T = l1.N;
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
