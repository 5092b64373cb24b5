// Fused PPNet eval forward for NVIDIA Hopper (sm_90a), f32 in and out.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/gated_infer.py:
// ppnet_fused_infer. From the gate input g [B, G] (h_0 = g), each layer i of
// domain d's tower computes
//   m = relu(h W_i[d] + b_i[d]),  gh = relu(g G1_i[d] + c1_i[d]),
//   z = gh G2_i[d] + c2_i[d],     h = m * (gemma * sigmoid(z)),
// then out = sigmoid(h Wf[d] + bf[d]), for the row's own domain
// d = clip(int32(domain_id), 0, D-1). The TPU kernel computes every domain's
// tower and selects with jnp.where, which gives the same value per row; here a
// row runs its own domain's tower only.
//
// What bounds it on this card: arithmetic. At the Ali-CCP shape (G 376, 3
// domains, layers [256,128,64,32,16,8], each gate's hidden as wide as its
// layer) a row costs 416,776 multiply-adds of its own domain (139,904 in the
// layers, 189,504 in the gate l1s, 87,360 in the gate l2s, 8 in the final)
// and moves ~2.7 KB: 3.418 GFLOP against 11.23 MB for B = 4096. With the
// products as three TF32 products each on the tensor cores that is 3 x 3.418
// GFLOP / 495 TFLOP/s = 0.0207 ms; in f32 without tensor cores 0.0510 ms at
// 67 TFLOP/s (H100 SXM, 700 W); HBM bounds less (0.0034 ms).
//
// What the design does about it (the split, the mma products, the ring's
// barriers and bulk copies and the bias loads are mma_ring.cuh's, shared with
// mmoe_infer.cu and hamur_infer.cu; the partition by domain, the slab of
// whole rows and the rotating accumulators are domain_tiles.cuh's, shared
// with m3oe_infer.cu):
// - One domain a block. A block of 8 compute warps and a producer warp takes
//   a tile of up to tb rows of one domain, partitioned inside the one launch,
//   so it streams that domain's weights only, once: 1.667 MB a block at
//   Ali-CCP, ~0.22 GB from L2 a call (a tile of mixed domains would stream
//   each of its domains in turn). The block gathers its rows of g and writes
//   out[row] for each. The partition's ids traffic grows with B^2: on an H100
//   at B 65,536, the largest B the card tests run, the kernel took 1.21x the
//   time a row it takes at B 4096 (PERF.md, section 6). Past that, split the
//   batch.
// - The products in 3xTF32 (f32's accuracy): each f32 operand x is split
//   into hi (a TF32 value) and lo = x - hi, and hi*hi + hi*lo + lo*hi go to
//   mma.sync.m16n8k8 in f32 accumulators. A layer's three products do not
//   chain as a stack's layers do, so the host lays out a schedule of
//   products, each with its K, N, W, b, input, output and epilogue; the
//   producer warp streams each product's W[d] slab by slab through the ring,
//   the compute warps consume the same schedule and meet at each product's
//   end. Every product, down to the narrow gates, runs on the tensor cores;
//   the 1-wide final is a warp a row.
// - A slab of whole rows is one bulk copy: with a copy a row for all 3,632
//   weight rows of a block the kernel took 0.1725 ms on an H100, against
//   0.1258 with a copy a slab (PERF.md, section 6).
// - Shared memory: the g tile (the gates read it in every layer), two
//   activation buffers X and Y, the ring in what the tile leaves. A layer of
//   width N <= kChunk runs its gate first: gh into the layer's output buffer,
//   z's factor gemma * sigmoid(z) kept in each warp's registers (a warp owns
//   the same output columns in z and m), then m from the other buffer (or g),
//   its epilogue relu(m) * factor over gh. So layer i's output buffer holds
//   only max(H_i, N_i) columns and the other the layer's input: at Ali-CCP,
//   X 256 and Y 128 wide, and 64-row tiles fit beside the smallest ring. A
//   wider layer (N > kChunk, more than one column pass) runs m first into its
//   output buffer, then gh into the other (h is dead by then), and z's
//   epilogue multiplies the output in place.
// On an H100 it reaches about a sixth of the 3xTF32 bound (PERF.md, section
// 6). Neither the slabs' bank conflicts (a layout free of them ran slower)
// nor the copies hold the wide products, but the compute warps' fragment
// loads, splits and mma.sync issue, as in mmoe_infer.cu.
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

constexpr int kMaxLayers = 30;               // a tower's layers
constexpr int kMaxProducts = 3 * kMaxLayers;
constexpr int kBarBytes = 64;                // a full and an empty barrier per ring slot
static_assert(16 * kRing <= kBarBytes, "two 8-byte barriers a ring slot");

// the buffers a product reads and writes
constexpr int kG = 0, kX = 1, kY = 2;

// what a product's epilogue makes of v = acc + b
enum Op : unsigned char {
  kRelu,         // out = relu(v)
  kGate,         // the warp's factor = gemma * sigmoid(v), kept in registers
  kReluGated,    // out = relu(v) * factor
  kGateInPlace,  // out = out * (gemma * sigmoid(v))
};

struct Product {
  const float* w;    // [D, K, N]
  const float* b;    // [D, N]
  int K, N;
  short srows, sld;  // weight rows a slab (a multiple of 8) and their stride in a slot
  unsigned char op, in, out;
  unsigned char whole;  // a slab is one bulk copy of whole rows, kept at stride N
};

struct Args {
  const float* g;    // [B, G]
  const void* did;   // [B], int64 when id64, else int32
  float* out;        // [B]
  const float* fw;   // final W [D, kf, 1]
  const float* fb;   // final b [D, 1]
  int id64, B, G, D, n_prod;
  int kf, fin;       // the final's input width and buffer
  int ld_g, ld_x, ld_y;  // shared-memory row strides (floats)
  int slot;              // floats of a ring slot
  float gemma;
  Product prod[kMaxProducts];
};

// A finished chunk of a product: v = acc + bias through the product's op into
// out (rows of the tile, columns c0 + the warp's n-tiles) or the warp's
// factors. Resets the accumulators.
template <int MT>
__device__ __forceinline__ void epilogue(int op, float (&acc)[MT][kNTW][4],
                                         float (&fac)[MT][kNTW][4], const float (&bias)[kNTW][2],
                                         int nt, int c0, float* out, int ldo, float gemma,
                                         int warp, int g, int t) {
#pragma unroll
  for (int i = 0; i < kNTW; ++i) {
    const int j = warp + kWarps * i;
    if (j < nt) {
      const int col = c0 + j * 8 + 2 * t;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m-tile
          float* o = out + (m * 16 + g + 8 * h) * ldo + col;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = acc[m][i][2 * h + e] + bias[i][e];
            acc[m][i][2 * h + e] = 0.f;
            if (op == kRelu) v[e] = relu(x);
            else if (op == kReluGated) v[e] = relu(x) * fac[m][i][2 * h + e];
            else if (op == kGate) fac[m][i][2 * h + e] = gemma * sigmoid(x);
            else v[e] = o[e] * (gemma * sigmoid(x));
          }
          if (op != kGate) *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
        }
      }
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
ppnet_fused_infer_kernel(const __grid_constant__ Args p) {
  constexpr int M = MT * 16;
  extern __shared__ __align__(16) float smem[];
  const uint32_t full = smem_addr(smem);     // [kRing] barriers: the slot has landed
  const uint32_t empty = full + 8 * kRing;   // [kRing] barriers: the slot has been read
  float* g_s = smem + kBarBytes / 4;         // [M, ld_g] the block's rows of g
  float* x_s = g_s + M * p.ld_g;             // [M, ld_x] even layers' outputs
  float* y_s = x_s + M * p.ld_x;             // [M, ld_y] odd layers' outputs
  float* ring = y_s + M * p.ld_y;            // [kRing, slot]
  int* rows_s = reinterpret_cast<int*>(ring + kRing * p.slot);  // [M] the block's rows
  int* cnt_s = rows_s + M;                   // [kAllWarps, D] rows of each domain a segment
  int* blk_s = cnt_s + kAllWarps * p.D;      // [2] the block's domain (-1: none) and tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  // 1-3. this block's domain and its tile of rows (domain_tiles.cuh)
  int n_rows = 0;
  const int dom = partition<M>(p.did, p.id64, p.B, p.D, rows_s, cnt_s, blk_s, &n_rows);
  if (dom < 0) return;  // past the last tile: the whole block leaves

  // 4. the ring's barriers
  if (threadIdx.x < kRing) {
    bar_init(full + 8 * threadIdx.x, 32);       // the producer warp's lanes
    bar_init(empty + 8 * threadIdx.x, kWarps);  // a lane of each compute warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();  // rows_s

  // 5. the g tile (rows past n_rows and pad columns zero)
  gather_rows<M>(p.g, p.G, p.ld_g, rows_s, n_rows, g_s);
  __syncthreads();

  auto buf = [&](int b) { return b == kG ? g_s : (b == kX ? x_s : y_s); };
  auto ld = [&](int b) { return b == kG ? p.ld_g : (b == kX ? p.ld_x : p.ld_y); };
  if (warp == kWarps) {
    // 6p. the producer warp: each product's W[dom], slab by slab, through the
    //     ring, as far ahead as the compute warps free slots
    int s = 0;
    for (int q = 0; q < p.n_prod; ++q) {
      const Product& pr = p.prod[q];
      for (int c = 0; c * kChunk < pr.N; ++c) {
        for (int k0 = 0; k0 < pr.K; k0 += pr.srows, ++s) {
          const int slot = s % kRing;
          bar_wait(empty + 8 * slot, ((s / kRing) & 1) ^ 1);  // the first pass finds it free
          issue_product_slab(pr.w, dom, pr.K, pr.N, pr.srows, pr.sld, pr.whole, c, k0,
                             ring + slot * p.slot, full + 8 * slot, lane);
        }
      }
    }
  } else {
    // 6. the products in schedule order, from the ring
    float acc[MT][kNTW][4], fac[MT][kNTW][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < kNTW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[m][i][e] = 0.f;
          fac[m][i][e] = 0.f;
        }
    float bias[kNTW][2];
    int s = 0;
    for (int q = 0; q < p.n_prod; ++q) {
      const Product& pr = p.prod[q];
      const float* A = buf(pr.in);
      const int lda = ld(pr.in);
      for (int c = 0; c * kChunk < pr.N; ++c) {
        const int c0 = c * kChunk;
        const int nt = (min(kChunk, pr.N - c0) + 7) / 8;
        const int tiles = (nt + kWarps - 1) / kWarps;  // n-tiles a warp
        load_bias(bias, pr.b + static_cast<size_t>(dom) * pr.N, nt, c0, pr.N, warp, t);
        for (int k0 = 0; k0 < pr.K; k0 += pr.srows, ++s) {
          const int slot = s % kRing;
          const float* Ws = ring + slot * p.slot;
          bar_wait(full + 8 * slot, (s / kRing) & 1);  // slab s has landed
          mma_any<MT>(tiles, A, lda, k0, pr.K, pr.srows, Ws, pr.sld, nt, acc, warp, g, t);
          __syncwarp();
          if (lane == 0) bar_arrive(empty + 8 * slot);  // this warp is done with the slot
        }
        fold_any<MT>(tiles, acc);
        epilogue<MT>(pr.op, acc, fac, bias, nt, c0, buf(pr.out), ld(pr.out), p.gemma, warp, g, t);
        compute_sync();  // its output, before the next product reads or overwrites it
      }
    }
  }
  __syncthreads();

  // 7. the final and the sigmoid, a warp a row
  head_rows(buf(p.fin), ld(p.fin), p.kf, p.fw, p.fb, dom, rows_s, n_rows, p.out);
}

struct Layout {
  int ld_g, ld_x, ld_y, slot;  // past the budget when not even the smallest ring fits
};

size_t smem_bytes(int tb, int D, const Layout& L) {
  const size_t floats = static_cast<size_t>(tb) * (L.ld_g + L.ld_x + L.ld_y) +
                        static_cast<size_t>(kRing) * L.slot;
  return kBarBytes + floats * sizeof(float) +
         (static_cast<size_t>(tb) + static_cast<size_t>(kAllWarps) * D + 2) * sizeof(int);
}

// The products of an n-layer tower in schedule order (stage i the layer, n + i
// its gate l1, 2n + i its gate l2: W ws[stage], b bs[stage], (K, N) in dims),
// their buffers and epilogues; the widths the buffers X and Y must hold.
int schedule(int n, const float* const* ws, const float* const* bs, const int* dims,
             Product* prod, int* wx, int* wy) {
  int k = 0;
  *wx = *wy = 0;
  for (int i = 0; i < n; ++i) {
    const int out = i % 2 == 0 ? kX : kY, other = out == kX ? kY : kX;
    const int in = i == 0 ? kG : other;  // the layer's input h
    const int N = dims[2 * i + 1], H = dims[2 * (n + i) + 1];
    int& w_out = out == kX ? *wx : *wy;
    int& w_other = out == kX ? *wy : *wx;
    auto add = [&](int stage, Op op, int src, int dst) {
      Product& q = prod[k++];
      q.w = ws[stage];
      q.b = bs[stage];
      q.K = dims[2 * stage];
      q.N = dims[2 * stage + 1];
      q.op = op;
      q.in = static_cast<unsigned char>(src);
      q.out = static_cast<unsigned char>(dst);
    };
    if (N <= kChunk) {  // the gate first, its factor in registers
      add(n + i, kRelu, kG, out);
      add(2 * n + i, kGate, out, out);
      add(i, kReluGated, in, out);
      w_out = std::max(w_out, std::max(N, H));
    } else {            // m first, the gate's factor applied in place
      add(i, kRelu, in, out);
      add(n + i, kRelu, kG, other);
      add(2 * n + i, kGateInPlace, other, out);
      w_out = std::max(w_out, N);
      w_other = std::max(w_other, H);
    }
  }
  return k;
}

// The layout of a tb-row tile in `budget` bytes of shared memory: the ring
// takes what the tile leaves, up to kRing slots of kSlotFloats, and at least
// 8 weight rows of each product a slot; each product's slab rows and stride.
Layout layout(int tb, int G, int D, int wx, int wy, Product* prod, int n_prod, size_t budget) {
  Layout L = {ld_act(G), ld_act(wx), ld_act(wy), 0};
  int min_slot = 0;
  for (int q = 0; q < n_prod; ++q) {
    Product& pr = prod[q];
    pr.whole = pr.N <= kChunk && pr.N % 8 == 0 && (reinterpret_cast<uintptr_t>(pr.w) & 15) == 0;
    pr.sld = static_cast<short>(pr.whole ? pr.N : ld_slab(std::min(pr.N, kChunk)));
    min_slot = std::max(min_slot, 8 * pr.sld);
  }
  const size_t tile = smem_bytes(tb, D, L);
  const size_t room = budget > tile ? (budget - tile) / sizeof(float) / kRing : 0;
  const int slot = static_cast<int>(room < kSlotFloats ? room : kSlotFloats) & ~3;
  L.slot = slot < min_slot ? min_slot : slot;
  for (int q = 0; q < n_prod; ++q)
    prod[q].srows =
        static_cast<short>(std::min((L.slot / prod[q].sld) & ~7, round_up(prod[q].K, 8)));
  return L;
}

template <int MT>
cudaError_t launch(const Args& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ppnet_fused_infer_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (p.B + MT * 16 - 1) / (MT * 16) + p.D - 1;
  ppnet_fused_infer_kernel<MT><<<tiles, kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// g [B, G] f32; did [B] domain ids, int64 when id64, else int32. w_ptrs,
// b_ptrs: host arrays of device pointers, 3 n_lay + 1 stages in the order:
// the layers (W [D, in, out]), the gate l1s (W [D, G, H_i]), the gate l2s
// (W [D, H_i, out_i]), the final (W [D, h, 1]); dims: (K, N) per stage.
// block_rows: rows of one block, a multiple of 16 up to 64, or 0: 32 where a
// 32-row tile fits in shared memory, else 16. Writes the dynamic shared
// memory a block of the tile it tried takes to *smem and returns a
// cudaError_t (cudaErrorInvalidValue when that tile does not fit).
int ppnet_fused_infer_f32(const void* g, const void* did, int id64, void* out, int B, int G,
                          int D, int n_lay, float gemma, const void* w_ptrs, const void* b_ptrs,
                          const void* dims, int block_rows, void* stream, size_t* smem) {
  const float* const* ws = static_cast<const float* const*>(w_ptrs);
  const float* const* bs = static_cast<const float* const*>(b_ptrs);
  const int* dm = static_cast<const int*>(dims);
  *smem = 0;
  if (B < 0 || G < 1 || D < 1 || D > kMaxDomains || n_lay < 0 || n_lay > kMaxLayers ||
      block_rows < 0 || block_rows % 16 != 0 || block_rows > 16 * kMaxMT)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = 3 * n_lay + 1;
  for (int s = 0; s < n; ++s)
    if (ws[s] == nullptr || bs[s] == nullptr || dm[2 * s] < 1 || dm[2 * s + 1] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
  int width = G;
  for (int i = 0; i < n_lay; ++i) {
    const int *L = dm + 2 * i, *g1 = dm + 2 * (n_lay + i), *g2 = dm + 2 * (2 * n_lay + i);
    if (L[0] != width || g1[0] != G || g2[0] != g1[1] || g2[1] != L[1])
      return static_cast<int>(cudaErrorInvalidValue);
    width = L[1];
  }
  if (dm[2 * (n - 1)] != width || dm[2 * (n - 1) + 1] != 1)
    return static_cast<int>(cudaErrorInvalidValue);

  Args p = {};
  int wx, wy;
  p.n_prod = schedule(n_lay, ws, bs, dm, p.prod, &wx, &wy);

  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t budget = static_cast<size_t>(optin);
  if (block_rows == 0)
    block_rows = smem_bytes(32, D, layout(32, G, D, wx, wy, p.prod, p.n_prod, budget)) <= budget
                     ? 32 : 16;
  const Layout L = layout(block_rows, G, D, wx, wy, p.prod, p.n_prod, budget);
  *smem = smem_bytes(block_rows, D, L);
  if (*smem > budget) return static_cast<int>(cudaErrorInvalidValue);

  p.g = static_cast<const float*>(g);
  p.did = did;
  p.id64 = id64;
  p.out = static_cast<float*>(out);
  p.fw = ws[n - 1];
  p.fb = bs[n - 1];
  p.B = B; p.G = G; p.D = D; p.gemma = gemma;
  p.kf = width;
  p.fin = n_lay == 0 ? kG : ((n_lay - 1) % 2 == 0 ? kX : kY);
  p.ld_g = L.ld_g; p.ld_x = L.ld_x; p.ld_y = L.ld_y; p.slot = L.slot;

  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_rows / 16) {
    case 1: err = launch<1>(p, *smem, s); break;
    case 2: err = launch<2>(p, *smem, s); break;
    case 3: err = launch<3>(p, *smem, s); break;
    default: err = launch<4>(p, *smem, s); break;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch's check
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
