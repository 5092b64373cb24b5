// Fused MMOE eval forward for NVIDIA Hopper (sm_90a), f32 in and out.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/mmoe_infer.py:
// mmoe_fused_infer. For each row b of the embedded batch emb[B, F] it
// computes E relu expert MLPs, the softmax gate over E of the row's own
// domain d = clip(domain_id[b], 0, D-1), the gate-weighted mixture of the
// expert outputs, domain d's relu tower, its 1-unit head and the sigmoid.
// That is the TPU kernel's function: it computes every domain and selects
// with jnp.where, which gives the same value per row.
//
// What bounds it on this card: arithmetic, almost all of it in the experts.
// At the Ali-CCP shape (F = 376, 3 experts of [256,128,64,32,16,8], 3
// domains, tower [16]) a row costs 420,984 multiply-adds, 99.7 % of them in
// the expert layers (68.6 % in 376 -> 256, 23.3 % in 256 -> 128), and moves
// ~1.9 KB: 3.45 GFLOP against 7.9 MB for B = 4096. In f32 without tensor
// cores that is 0.0515 ms at 67 TFLOP/s (H100 SXM, 700 W); HBM bounds less.
//
// What the design does about it (the split, the mma loop and the weight ring
// are mma_ring.cuh's, shared with hamur_infer.cu):
// - Expert layers on the tensor cores at about f32's accuracy ("3xTF32"):
//   each f32 operand x is split into hi (x's top 10 mantissa bits, a TF32
//   value) and lo = x - hi; a product is hi*hi + hi*lo + lo*hi, three
//   mma.sync.m16n8k8 TF32 products accumulated in f32 (the lo*lo term,
//   ~2^-20 relative, is dropped). Bound: 3 x 3.44 GFLOP / 495 TFLOP/s
//   (0.0208 ms) plus the SIMT gate, tower and head (0.01 GFLOP / 67).
// - Weights staged in shared memory and shared by every warp of a block: a
//   producer warp streams each expert layer's W [K, N] through a ring of
//   kRing slots of up to kSlotFloats (smaller where a wide emb tile leaves
//   less room, down to 8 weight rows a slot), a slab of one layer's rows (as
//   many as fill a slot, so a narrow layer is one slab) by up to kChunk
//   columns a slot,
//   with one bulk async copy a row (cp.async.bulk, completing on the slot's
//   full barrier; cp.async where rows are not 8-float multiples), as far
//   ahead as the 8 compute warps free slots (the empty barriers). The
//   compute warps never issue a copy and meet only at a layer's end. A warp
//   owns every 16-row m-tile of the block and the n-tiles j = warp + 8 i of
//   a chunk, so each weight element is read from shared memory once per
//   block, and one A fragment feeds 4 n-tiles x 3 products.
// - One block a 32-row tile at the Ali-CCP shape: 128 blocks, one wave of
//   132 SMs, each running the 3 experts in turn. L2 -> SM weight bytes a
//   call: tiles x all expert weights = 128 x 1.68 MB = 0.22 GB (the first
//   design read 0.43-0.86 GB with scalar loads).
// - Each row's own-domain softmax gate is computed by the compute warps
//   while the producer fills the ring, its weights read through L2 (__ldg:
//   every domain's gate in shared memory would not leave room for a wide F
//   with many domains), and folded in as gate x expert output into the
//   block's mixture in the last layer's epilogue (in expert order, the
//   reference's g_0 x_0 + g_1 x_1 + ...). Then each row's tower with a
//   thread per (row, output), and its head and sigmoid with a warp a row.
// The ragged last tile is masked here (zero rows, no pad copy); a NaN in a
// row stays in that row (rows never mix). Activations keep a row stride of
// 4 mod 32 floats and weight slabs 8 mod 32, so the fragment loads are free
// of bank conflicts.
//
// On an H100 it reaches about a sixth of this bound (PERF.md, section 6):
// the compute warps' fragment loads, splits and mma.sync issue and the weight
// stream from L2 share the time. A wgmma form (TF32 wants both operands
// K-major in shared memory: the weights transposed) is the next step.
//
// Bound through ctypes: a plain C interface, every pointer and the stream
// as void*, the cudaError_t of the launch returned.

#include <math.h>

#include "mma_ring.cuh"

namespace {

using namespace ring;

constexpr int kMaxExperts = 16;   // gate registers per row
constexpr int kBarBytes = 64;     // a full and an empty barrier per ring slot
static_assert(16 * kRing <= kBarBytes, "two 8-byte barriers a ring slot");

struct Args {
  const float* emb;   // [B, F]
  const void* did;    // [B], int64 when id64, else int32
  float* out;         // [B]
  int id64, B, F, E, D, H, n_tow;
  int ld_f, ld_a, ld_b;  // shared-memory row strides (floats)
  int slot;              // floats of a ring slot
  Stack ex;              // the expert layers: W [E, in, out], b [E, out]
  const float* gw;              // [D, F, E]
  const float* gb;              // [D, E]
  const float* tw[kMaxStages];  // tower stage s: W [D, in, out]
  const float* tbias[kMaxStages];  //             b [D, out]
  int tdim[kMaxStages + 1];     // H, widths...
  const float* ow;              // head W [D, h, 1]
  const float* ob;              // head b [D, 1]
};

// bias + relu of a finished chunk: into the next layer's input rows, or
// (the last layer) gate x output added to the block's partial mixture.
// Resets the accumulators.
template <int MT>
__device__ __forceinline__ void epilogue(float (&acc)[MT][kNTW][4], int nt, int c0, int N,
                                         const float (&bias)[kNTW][2], float* out, int ldo,
                                         bool last, float* mix, const float* gate, int E,
                                         int e, int warp, int g, int t) {
#pragma unroll
  for (int i = 0; i < kNTW; ++i) {
    const int j = warp + kWarps * i;
    if (j < nt) {
      const int col = c0 + j * 8 + 2 * t;
      const float b0 = bias[i][0], b1 = bias[i][1];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m-tile
          const int r = m * 16 + g + 8 * h;
          const float v0 = relu(acc[m][i][2 * h] + b0);
          const float v1 = relu(acc[m][i][2 * h + 1] + b1);
          if (!last) {
            *reinterpret_cast<float2*>(out + r * ldo + col) = make_float2(v0, v1);
          } else {
            const float gr = gate[r * E + e];
            if (col < N) mix[r * N + col] = __fadd_rn(mix[r * N + col], __fmul_rn(gr, v0));
            if (col + 1 < N)
              mix[r * N + col + 1] = __fadd_rn(mix[r * N + col + 1], __fmul_rn(gr, v1));
          }
          acc[m][i][2 * h] = 0.f;
          acc[m][i][2 * h + 1] = 0.f;
        }
      }
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
mmoe_fused_infer_kernel(const __grid_constant__ Args p) {
  constexpr int M = MT * 16;
  extern __shared__ __align__(16) float smem[];
  const uint32_t full = smem_addr(smem);     // [kRing] barriers: the slot has landed
  const uint32_t empty = full + 8 * kRing;   // [kRing] barriers: the slot has been read
  float* emb_s = smem + kBarBytes / 4;       // [M, ld_f]
  float* buf_a = emb_s + M * p.ld_f;         // [M, ld_a] even layers' outputs
  float* buf_b = buf_a + M * p.ld_a;         // [M, ld_b] odd layers' outputs
  float* ring = buf_b + M * p.ld_b;          // [kRing, slot]
  float* mix = ring + kRing * p.slot;        // [M, H] the mixture
  float* gate_s = mix + M * p.H;             // [M, E]
  int* did_s = reinterpret_cast<int*>(gate_s + M * p.E);  // [M]

  const int row0 = blockIdx.x * M;
  const int rows = min(M, p.B - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  // 1. the ring's barriers
  if (threadIdx.x < kRing) {
    bar_init(full + 8 * threadIdx.x, 32);       // the producer warp's lanes
    bar_init(empty + 8 * threadIdx.x, kWarps);  // a lane of each compute warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  // 2. the emb tile (rows past the batch and pad columns zero), domains,
  //    an empty mixture
  if ((p.F & 3) == 0 && (reinterpret_cast<uintptr_t>(p.emb) & 15) == 0) {
    const int q4 = p.ld_f / 4;
    for (int i = threadIdx.x; i < M * q4; i += kThreads) {
      const int r = i / q4, c = 4 * (i % q4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && c < p.F)
        v = __ldg(reinterpret_cast<const float4*>(p.emb + static_cast<size_t>(row0 + r) * p.F + c));
      *reinterpret_cast<float4*>(emb_s + r * p.ld_f + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < M * p.ld_f; i += kThreads) {
      const int r = i / p.ld_f, c = i % p.ld_f;
      emb_s[i] = (r < rows && c < p.F) ? __ldg(p.emb + static_cast<size_t>(row0 + r) * p.F + c)
                                       : 0.f;
    }
  }
  // an int64 id is taken modulo 2^32 as an int32, then clipped, as the
  // plain version and the reference (int32 ids) take it
  for (int r = threadIdx.x; r < M; r += kThreads) {
    int d = 0;
    if (r < rows)
      d = p.id64 ? static_cast<int>(static_cast<const long long*>(p.did)[row0 + r])
                 : static_cast<const int*>(p.did)[row0 + r];
    did_s[r] = d < 0 ? 0 : (d >= p.D ? p.D - 1 : d);
  }
  for (int i = threadIdx.x; i < M * p.H; i += kThreads) mix[i] = 0.f;
  __syncthreads();

  if (warp == kWarps) {
    // 3p. the producer warp: the experts' weights, slab by slab, through
    //     the ring, as far ahead as the compute warps free slots
    Slab prod = {0, 0, 0, 0};
    for (int s = 0; prod.e < p.E; ++s) {
      const int slot = s % kRing;
      bar_wait(empty + 8 * slot, ((s / kRing) & 1) ^ 1);  // the first pass finds it free
      issue_slab(p.ex, prod, ring + slot * p.slot, full + 8 * slot, lane);
      advance(p.ex, prod);
    }
  } else {
    // 3. the gate of each row's own domain: softmax over E (max subtracted),
    //    its weights through L2
    for (int r = warp; r < M; r += kWarps) {
      const int d = did_s[r];
      const float* __restrict__ wg = p.gw + static_cast<size_t>(d) * p.F * p.E;
      const float* a = emb_s + r * p.ld_f;
      float acc[kMaxExperts];
#pragma unroll
      for (int e = 0; e < kMaxExperts; ++e) acc[e] = 0.f;
#pragma unroll 4
      for (int k = lane; k < p.F; k += 32) {
        const float x = a[k];
#pragma unroll
        for (int e = 0; e < kMaxExperts; ++e)
          if (e < p.E) acc[e] = fmaf(x, __ldg(wg + k * p.E + e), acc[e]);
      }
#pragma unroll
      for (int e = 0; e < kMaxExperts; ++e)
        if (e < p.E) acc[e] = warp_sum(acc[e]);
      if (lane == 0) {
        float mx = -INFINITY;
#pragma unroll
        for (int e = 0; e < kMaxExperts; ++e)
          if (e < p.E) {
            acc[e] += __ldg(p.gb + d * p.E + e);
            mx = fmaxf(mx, acc[e]);
          }
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < kMaxExperts; ++e)
          if (e < p.E) {
            acc[e] = expf(acc[e] - mx);
            sum += acc[e];
          }
#pragma unroll
        for (int e = 0; e < kMaxExperts; ++e)
          if (e < p.E) gate_s[r * p.E + e] = acc[e] / sum;
      }
    }
    compute_sync();  // the gates, before any epilogue reads them

    // 4. the experts, layer by layer, from the ring
    float acc[MT][kNTW][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < kNTW; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][i][q] = 0.f;
    float bias[kNTW][2];
    Slab cons = {0, 0, 0, 0};
    for (int s = 0; cons.e < p.E; ++s) {
      const int slot = s % kRing;
      const int l = cons.l, K = p.ex.dim[l], N = p.ex.dim[l + 1];
      const float* A = l == 0 ? emb_s : ((l & 1) ? buf_a : buf_b);
      const int lda = l == 0 ? p.ld_f : ((l & 1) ? p.ld_a : p.ld_b);
      const int c0 = cons.c * kChunk;
      const int nt = (min(kChunk, N - c0) + 7) / 8;
      if (cons.k0 == 0)
        load_bias(bias, p.ex.b[l] + static_cast<size_t>(cons.e) * N, nt, c0, N, warp, t);
      bar_wait(full + 8 * slot, (s / kRing) & 1);  // slab s has landed
      mma_slab<MT>(A, lda, cons.k0, K, p.ex.srows[l], ring + slot * p.slot, p.ex.sld[l], nt, acc,
                   warp, g, t);
      __syncwarp();
      if (lane == 0) bar_arrive(empty + 8 * slot);  // this warp is done with the slot
      if (cons.k0 + p.ex.srows[l] >= K) {  // the chunk is done
        epilogue<MT>(acc, nt, c0, N, bias, (l & 1) ? buf_b : buf_a, (l & 1) ? p.ld_b : p.ld_a,
                     l == p.ex.n - 1, mix, gate_s, p.E, cons.e, warp, g, t);
        compute_sync();  // its output, before the next layer reads it
      }
      advance(p.ex, cons);
    }
  }

  // 5. the mixture into buf_a, the tower's input rows
  __syncthreads();
  for (int i = threadIdx.x; i < M * p.H; i += kThreads)
    buf_a[(i / p.H) * p.ld_a + i % p.H] = mix[i];
  __syncthreads();

  // 6. each row's own tower, a thread per (row, output) so that the weight
  //    loads of all rows are in flight at once; then its head and sigmoid,
  //    a warp a row
  float* cur = buf_a;
  float* nxt = buf_b;
  int ld_cur = p.ld_a, ld_nxt = p.ld_b;
  for (int s = 0; s < p.n_tow; ++s) {
    const int K = p.tdim[s], N = p.tdim[s + 1];
    for (int i = threadIdx.x; i < rows * N; i += kThreads) {
      const int r = i / N, j = i % N, d = did_s[r];
      const float* w = p.tw[s] + static_cast<size_t>(d) * K * N + j;
      const float* x = cur + r * ld_cur;
      float a = 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) a = fmaf(x[k], __ldg(w + static_cast<size_t>(k) * N), a);
      nxt[r * ld_nxt + j] = relu(a + __ldg(p.tbias[s] + static_cast<size_t>(d) * N + j));
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    const int ld = ld_cur;
    ld_cur = ld_nxt;
    ld_nxt = ld;
  }
  for (int r = warp; r < rows; r += kWarps + 1) {
    const int d = did_s[r];
    const int K = p.tdim[p.n_tow];
    float part = 0.f;
    for (int k = lane; k < K; k += 32)
      part = fmaf(cur[r * ld_cur + k], __ldg(p.ow + static_cast<size_t>(d) * K + k), part);
    part = warp_sum(part);
    if (lane == 0) {
      const float logit = part + __ldg(p.ob + d);
      p.out[row0 + r] = 1.f / (1.f + expf(-logit));
    }
  }
}

struct Layout {
  int ld_f, ld_a, ld_b, H, slot;  // slot 0: not even the smallest ring fits
  Stack ex;                       // the experts' slabs (no weights yet)
};

size_t smem_bytes(int tb, int E, const Layout& L) {
  const size_t floats = static_cast<size_t>(tb) * (L.ld_f + L.ld_a + L.ld_b + L.H + E) +
                        static_cast<size_t>(kRing) * L.slot;
  return kBarBytes + floats * sizeof(float) + static_cast<size_t>(tb) * sizeof(int);
}

// The layout of a tb-row tile in `budget` bytes of shared memory: the ring
// takes what the tile leaves, up to kRing slots of kSlotFloats, and at least
// 8 weight rows of each layer a slot.
Layout layout(int tb, int F, int E, int n_exp, const int* edim, int n_tow, const int* tdim,
              size_t budget) {
  Layout L = {};
  L.H = edim[n_exp];
  L.ex.n = n_exp;
  for (int s = 0; s <= n_exp; ++s) L.ex.dim[s] = edim[s];
  int wa = L.H, wb = L.H;
  for (int s = 0; s <= n_tow; ++s) {
    wa = tdim[s] > wa ? tdim[s] : wa;
    wb = tdim[s] > wb ? tdim[s] : wb;
  }
  for (int l = 0; l < n_exp; ++l) {
    const int n = edim[l + 1];
    if (l & 1) wb = n > wb ? n : wb;
    else wa = n > wa ? n : wa;
  }
  const int min_slot = slab_strides(L.ex);
  L.ld_f = ld_act(F);
  L.ld_a = ld_act(wa);
  L.ld_b = ld_act(wb);
  L.slot = 0;
  const size_t tile = smem_bytes(tb, E, L);
  const size_t room = budget > tile ? (budget - tile) / sizeof(float) / kRing : 0;
  const int slot = static_cast<int>(room < kSlotFloats ? room : kSlotFloats) & ~3;
  L.slot = slot < min_slot ? min_slot : slot;  // past the budget when it is too small
  fill_slabs(L.ex, L.slot);
  return L;
}

template <int MT>
cudaError_t launch(const Args& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mmoe_fused_infer_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mmoe_fused_infer_kernel<MT><<<(p.B + MT * 16 - 1) / (MT * 16), kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Dynamic shared memory one tb-row block takes within `budget` bytes (the
// ring sized to what is left); more than `budget` when it does not fit.
size_t mmoe_fused_infer_smem_bytes(int tb, int F, int E, int n_exp, const int* exp_dims,
                                   int n_tow, const int* tow_dims, size_t budget) {
  return smem_bytes(tb, E, layout(tb, F, E, n_exp, exp_dims, n_tow, tow_dims, budget));
}

// did: [B] domain ids, int64 when id64, else int32 (the trainer's int64 ids
// need no cast launch). exp_w/exp_b/tow_w/tow_b: host arrays of device
// pointers, one per stage.
// exp_dims: n_exp + 1 widths starting at F; tow_dims: n_tow + 1 widths
// starting at the expert output width H. block_rows: rows of one block, a
// multiple of 16 up to 64, or 0: 32 where a 32-row tile fits in shared
// memory, else 16. Returns a cudaError_t.
int mmoe_fused_infer_f32(const void* emb, const void* did, int id64, void* out, int B, int F,
                         int E, int D, int n_exp, const void* exp_w, const void* exp_b,
                         const void* exp_dims, const void* gate_w, const void* gate_b,
                         int n_tow, const void* tow_w, const void* tow_b, const void* tow_dims,
                         const void* head_w, const void* head_b, int block_rows,
                         void* stream) {
  const float* const* ew = static_cast<const float* const*>(exp_w);
  const float* const* eb = static_cast<const float* const*>(exp_b);
  const float* const* tw = static_cast<const float* const*>(tow_w);
  const float* const* tbias = static_cast<const float* const*>(tow_b);
  const int* edim = static_cast<const int*>(exp_dims);
  const int* tdim = static_cast<const int*>(tow_dims);
  if (B < 0 || F < 1 || E < 1 || E > kMaxExperts || D < 1 || n_exp < 1 ||
      n_exp > kMaxStages || n_tow < 0 || n_tow > kMaxStages || block_rows < 0 ||
      block_rows % 16 != 0 || block_rows > 16 * kMaxMT || edim[0] != F ||
      tdim[0] != edim[n_exp])
    return static_cast<int>(cudaErrorInvalidValue);
  for (int s = 1; s <= n_exp; ++s)
    if (edim[s] < 1) return static_cast<int>(cudaErrorInvalidValue);

  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t budget = static_cast<size_t>(optin);
  if (block_rows == 0)
    block_rows = smem_bytes(32, E, layout(32, F, E, n_exp, edim, n_tow, tdim, budget)) <= budget
                     ? 32 : 16;
  const Layout L = layout(block_rows, F, E, n_exp, edim, n_tow, tdim, budget);
  const size_t smem = smem_bytes(block_rows, E, L);
  if (smem > budget) return static_cast<int>(cudaErrorInvalidValue);

  Args p = {};
  p.emb = static_cast<const float*>(emb);
  p.did = did;
  p.id64 = id64;
  p.out = static_cast<float*>(out);
  p.B = B; p.F = F; p.E = E; p.D = D; p.H = L.H; p.n_tow = n_tow;
  p.ld_f = L.ld_f; p.ld_a = L.ld_a; p.ld_b = L.ld_b; p.slot = L.slot;
  p.ex = L.ex;
  for (int s = 0; s < n_exp; ++s) {
    p.ex.w[s] = ew[s];
    p.ex.b[s] = eb[s];
  }
  for (int s = 0; s < n_tow; ++s) {
    p.tw[s] = tw[s];
    p.tbias[s] = tbias[s];
  }
  for (int s = 0; s <= n_tow; ++s) p.tdim[s] = tdim[s];
  p.gw = static_cast<const float*>(gate_w);
  p.gb = static_cast<const float*>(gate_b);
  p.ow = static_cast<const float*>(head_w);
  p.ob = static_cast<const float*>(head_b);

  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_rows / 16) {
    case 1: err = launch<1>(p, smem, s); break;
    case 2: err = launch<2>(p, smem, s); break;
    case 3: err = launch<3>(p, smem, s); break;
    default: err = launch<4>(p, smem, s); break;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left for the next launch's check
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
