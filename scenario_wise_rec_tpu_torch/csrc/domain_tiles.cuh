// What ppnet_infer.cu, m3oe_infer.cu, adasparse_infer.cu and ple_infer.cu
// share on NVIDIA Hopper (sm_90a): each block takes a tile of rows (of ONE
// domain in PPNet's, M3oE's and PLE's, partitioned inside the one launch)
// and runs its products over mma_ring.cuh's weight ring.
//
// - The partition, with no sort and no host work: a launch has ceil(B/M) + D
//   - 1 blocks, enough since the tiles of all domains, sum over d of
//   ceil(c_d / M), are at most that many. Each block reads all B ids (int64
//   ids modulo 2^32 as int32, then clipped), each warp a contiguous segment,
//   4 ids a lane a 16-byte load, and counts each domain's rows in its segment
//   (shared-memory atomics into the warp's own counts); warp 0 scans the
//   domains' tile counts to find this block's (domain d, tile j); the warps
//   holding ranks j*M .. (j+1)*M - 1 of domain d list those rows in row order
//   (ballots, the ranks of earlier segments added). Blocks past the last tile
//   leave. Each block reads all B ids, so the ids traffic from L2 is B^2/M
//   words and grows with B^2 while the products' grows with B.
// - A slab of whole rows (N <= kChunk, a multiple of 8, W 16-byte aligned)
//   is contiguous in W[member], so it is one bulk copy, kept at stride N in
//   its slot (copy_whole); a product wider than a chunk (N a multiple of 4)
//   is one tensor copy (TMA) of a [srows, kChunk] box a slab (tensor_slab,
//   its map encoded on the host through the runtime's driver entry point,
//   no link to the driver library); other products take mma_ring.cuh's bulk
//   copy a row (issue_slab). A bulk copy is one copy-engine operation however
//   short its row (PERF.md, section 6).
// - The host lays out a kernel's products as a list of steps and places their
//   activation tiles in shared memory by their lifetimes (Tiles); the ring
//   takes what the tiles leave (size_ring).
// - A warp that owns one or two n-tiles of a product (N <= 128) takes the
//   k-steps in turn into 4 or 2 sets of accumulators (mma_slab_rot), so the
//   products of a narrow layer are independent chains of mma.sync.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from the runtime)
#include <math.h>

#include <algorithm>
#include <vector>

#include "mma_ring.cuh"

namespace ring {

constexpr int kMaxDomains = 256;       // per-warp domain counts in shared memory
constexpr int kMaxMaps = 2;      // tensor maps a launch: products wider than a chunk
constexpr int kHeadBytes = 128;  // the ring's barriers, then the slots, 128-byte aligned
static_assert(16 * kRing <= kHeadBytes, "two 8-byte barriers a ring slot");
constexpr int kAllWarps = kWarps + 1;  // the producer warp takes part in the partition
constexpr int kIds = 4;  // loads of 4 ids a lane in flight together in the partition

// row r's domain: an int64 id is taken modulo 2^32 as an int32, then clipped,
// as the plain versions and the reference (int32 ids) take it
__device__ __forceinline__ int domain_of(const void* did, int id64, int D, int r) {
  const int d = id64 ? static_cast<int>(static_cast<const long long*>(did)[r])
                     : static_cast<const int*>(did)[r];
  return d < 0 ? 0 : (d >= D ? D - 1 : d);
}

// the domains of rows r .. r + 3, -1 past s1: one 16-byte load of int32 ids
// or two of int64 ids where the ids are 16-byte aligned (r is a multiple of 4)
__device__ __forceinline__ void domains4(const void* did, int id64, int D, bool vec, int r,
                                         int s1, int (&d)[4]) {
  if (vec && r + 4 <= s1) {
    int v[4];
    if (id64) {
      const longlong2* q =
          reinterpret_cast<const longlong2*>(static_cast<const long long*>(did) + r);
      const longlong2 a = __ldg(q), b = __ldg(q + 1);
      v[0] = static_cast<int>(a.x), v[1] = static_cast<int>(a.y);
      v[2] = static_cast<int>(b.x), v[3] = static_cast<int>(b.y);
    } else {
      const int4 a = __ldg(reinterpret_cast<const int4*>(static_cast<const int*>(did) + r));
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = v[e] < 0 ? 0 : (v[e] >= D ? D - 1 : v[e]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = r + e < s1 ? domain_of(did, id64, D, r + e) : -1;
  }
}

// The block's tile of M rows of one domain. Every thread of the block calls
// it. Returns the domain, or -1 for a block past the last tile (the whole
// block then leaves, before any other barrier); *n_rows: the tile's rows,
// rows_s[0 .. n_rows) their indices in row order. cnt_s: [kAllWarps, D]
// ints, blk_s: 2 ints of shared memory. rows_s is written but not yet
// synchronised.
template <int M>
__device__ __forceinline__ int partition(const void* did, int id64, int B, int D, int* rows_s,
                                         int* cnt_s, int* blk_s, int* n_rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // 1. count each domain's rows in each warp's segment of the ids: a lane
  //    takes 4 consecutive ids a load, kIds loads in flight
  for (int i = threadIdx.x; i < kAllWarps * D; i += kThreads) cnt_s[i] = 0;
  __syncthreads();
  const int seg = round_up((B + kAllWarps - 1) / kAllWarps, 128);
  const int s0 = min(B, warp * seg), s1 = min(B, s0 + seg);
  const bool vec = (reinterpret_cast<uintptr_t>(did) & 15) == 0;
  for (int r0 = s0; r0 < s1; r0 += 128 * kIds) {
    int d[kIds][4];
#pragma unroll
    for (int u = 0; u < kIds; ++u) domains4(did, id64, D, vec, r0 + 128 * u + 4 * lane, s1, d[u]);
#pragma unroll
    for (int u = 0; u < kIds; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d[u][e] >= 0) atomicAdd(cnt_s + warp * D + d[u][e], 1);
  }
  __syncthreads();

  // 2. this block's (domain, tile): warp 0 scans the domains' tile counts
  if (warp == 0) {
    int before = 0, dom = -1, tile = 0;
    for (int d0 = 0; d0 < D && dom < 0; d0 += 32) {
      const int d = d0 + lane;
      int tiles = 0;
      if (d < D) {
        int n = 0;
        for (int w = 0; w < kAllWarps; ++w) n += cnt_s[w * D + d];
        tiles = (n + M - 1) / M;
      }
      int incl = tiles;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int b = static_cast<int>(blockIdx.x) - before;
      const unsigned hit = __ballot_sync(0xffffffffu, b >= incl - tiles && b < incl);
      if (hit) {
        const int src = __ffs(hit) - 1;
        dom = d0 + src;
        tile = b - __shfl_sync(0xffffffffu, incl - tiles, src);
      }
      before += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      blk_s[0] = dom;
      blk_s[1] = tile;
    }
  }
  __syncthreads();
  const int dom = blk_s[0];
  if (dom < 0) return -1;
  const int lo = blk_s[1] * M;

  // 3. the rows of domain dom with ranks lo .. lo + M - 1, in row order
  int rank = 0, mine = 0, total = 0;
  for (int w = 0; w < kAllWarps; ++w) {
    const int c = cnt_s[w * D + dom];
    rank += w < warp ? c : 0;
    mine = w == warp ? c : mine;
    total += c;
  }
  *n_rows = min(M, total - lo);
  if (rank < lo + M && rank + mine > lo) {  // this segment holds some of them
    const unsigned before_me = (1u << lane) - 1u;
    for (int r0 = s0; r0 < s1 && rank < lo + M; r0 += 128 * kIds) {
      int d[kIds][4];
#pragma unroll
      for (int u = 0; u < kIds; ++u)
        domains4(did, id64, D, vec, r0 + 128 * u + 4 * lane, s1, d[u]);
#pragma unroll
      for (int u = 0; u < kIds; ++u) {
        // rows r0 + 128 u + 4 lane + e: the earlier lanes' hits, then this lane's in order
        int k = rank, n = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned m = __ballot_sync(0xffffffffu, d[u][e] == dom);
          k += __popc(m & before_me);
          n += __popc(m);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (d[u][e] == dom) {
            if (k >= lo && k < lo + M) rows_s[k - lo] = r0 + 128 * u + 4 * lane + e;
            ++k;
          }
        }
        rank += n;
      }
    }
  }
  return dom;
}

// rows rows_s[0 .. n_rows) of x [., cols] into columns at .. at + span - 1 of
// the tile [M, ld] (by default the whole row), rows past n_rows and columns
// past cols zero; every thread of the block issues a batch of loads before it
// stores any. Not synchronised.
template <int M>
__device__ __forceinline__ void gather_rows(const float* __restrict__ x, int cols, int ld,
                                            const int* rows_s, int n_rows, float* tile,
                                            int at = 0, int span = -1) {
  constexpr int kBatch = 4;
  if (span < 0) span = ld;
  tile += at;
  if ((cols & 3) == 0 && (at & 3) == 0 && (span & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int q4 = span / 4;
    for (int i0 = threadIdx.x; i0 < M * q4; i0 += kBatch * kThreads) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads, r = i / q4, c = 4 * (i % q4);
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < M * q4 && r < n_rows && c < cols) {
          const float* src = x + static_cast<size_t>(rows_s[r]) * cols + c;
          v[u] = __ldg(reinterpret_cast<const float4*>(src));
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < M * q4) *reinterpret_cast<float4*>(tile + (i / q4) * ld + 4 * (i % q4)) = v[u];
      }
    }
  } else {
    for (int i0 = threadIdx.x; i0 < M * span; i0 += kBatch * kThreads) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads, r = i / span, c = i % span;
        v[u] = i < M * span && r < n_rows && c < cols
                   ? __ldg(x + static_cast<size_t>(rows_s[r]) * cols + c) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < M * span) tile[(i / span) * ld + i % span] = v[u];
      }
    }
  }
}

// The producer warp's part for a product of whole rows (N <= kChunk, a
// multiple of 8, w 16-byte aligned): rows k0 .. k0 + srows - 1 of w [K, N]
// are contiguous, so the slab is one bulk copy into the slot at stride N,
// rows from K up to K rounded to 8 zero. Each lane arrives on the slot's full
// barrier, which completes when the slab has landed.
__device__ __forceinline__ void copy_whole(const float* w, int K, int N, int srows, int k0,
                                           float* slot, uint32_t full, int lane) {
  const int rows = min(srows, K - k0);
  const int pad = min(srows, round_up(K, 8) - k0) - rows;
  for (int i = lane; i < pad * N; i += 32) slot[rows * N + i] = 0.f;
  // the slot's earlier reads (generic proxy) before the copy's writes (async)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (lane == 0) {
    const uint32_t bytes = static_cast<uint32_t>(rows * N * 4);
    bar_arrive_tx(full, bytes);
    bulk_row(smem_addr(slot), w + static_cast<size_t>(k0) * N, bytes, full);
  } else {
    bar_arrive(full);
  }
}

// The producer warp's part for slab (chunk c, rows from k0) of a product
// wider than a chunk: one tensor copy of the box [srows, kChunk] of member
// `member`'s W from (k0, c kChunk) into the slot at stride kChunk, rows and
// columns past W's zero-filled by the copy. Each lane arrives on the slot's
// full barrier, which completes when the box has landed.
__device__ __forceinline__ void tensor_slab(const CUtensorMap* map, int member, int srows, int c,
                                            int k0, float* slot, uint32_t full, int lane) {
  // the slot's earlier reads (generic proxy) before the copy's writes (async)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (lane == 0) {
    bar_arrive_tx(full, static_cast<uint32_t>(srows * kChunk * 4));
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(slot)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c * kChunk), "r"(k0), "r"(member), "r"(full)
        : "memory");
  } else {
    bar_arrive(full);
  }
}

// The producer warp's part for slab (chunk c, rows from k0) of a product
// W [members, K, N] of member `member`: one bulk copy of whole rows where
// `whole`, else issue_slab's copies into slot rows of stride sld.
__device__ __forceinline__ void issue_product_slab(const float* w, int member, int K, int N,
                                                   int srows, int sld, bool whole, int c,
                                                   int k0, float* slot, uint32_t full,
                                                   int lane) {
  if (whole) {
    copy_whole(w + static_cast<size_t>(member) * K * N, K, N, srows, k0, slot, full, lane);
    return;
  }
  Stack st;
  st.n = 1;
  st.dim[0] = K;
  st.dim[1] = N;
  st.srows[0] = srows;
  st.sld[0] = sld;
  st.w[0] = w;
  issue_slab(st, Slab{member, 0, c, k0}, slot, full, lane);
}

// mma_ring.cuh's mma_slab for a warp that owns T <= 2 n-tiles of a chunk: the
// k-steps go in turn to R = kNTW / T sets of accumulators (acc[m][i + T r]),
// so a tile's products make R independent chains of mma, not one; fold()
// sums the sets into acc[m][i] before the epilogue. A narrow product (width
// 8, 47 k-steps on one warp) is otherwise one chain of 141 dependent
// mma.sync.
template <int MT, int T>
__device__ __forceinline__ void mma_slab_rot(const float* A, int lda, int k0, int K, int rows,
                                             const float* Ws, int ldw, int nt,
                                             float (&acc)[MT][kNTW][4], int warp, int g, int t) {
  constexpr int R = kNTW / T;
  const int steps = min(rows / 8, (K - k0 + 7) / 8);
  for (int s0 = 0; s0 < steps; s0 += R) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
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
#pragma unroll
        for (int i = 0; i < T; ++i) {
          if (warp + kWarps * i < nt) {
            const float* b = Ws + (kk + t) * ldw + (warp + kWarps * i) * 8 + g;
            uint32_t bh0, bl0, bh1, bl1;
            split(b[0], bh0, bl0);
            split(b[4 * ldw], bh1, bl1);
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_tf32(acc[m][i + T * r], al[m], bh0, bh1);
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_tf32(acc[m][i + T * r], ah[m], bl0, bl1);
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_tf32(acc[m][i + T * r], ah[m], bh0, bh1);
          }
        }
      }
    }
  }
}

template <int MT, int T>
__device__ __forceinline__ void fold(float (&acc)[MT][kNTW][4]) {
#pragma unroll
  for (int r = 1; r < kNTW / T; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[m][i][e] += acc[m][i + T * r][e];
          acc[m][i + T * r][e] = 0.f;
        }
}

// One slab of a product on the compute warps: the mma_slab form for the
// warp's n-tile count (1, 2 or more of a chunk), over the slab's rows.
template <int MT>
__device__ __forceinline__ void mma_any(int tiles, const float* A, int lda, int k0, int K,
                                        int rows, const float* Ws, int ldw, int nt,
                                        float (&acc)[MT][kNTW][4], int warp, int g, int t) {
  if (tiles == 1)
    mma_slab_rot<MT, 1>(A, lda, k0, K, rows, Ws, ldw, nt, acc, warp, g, t);
  else if (tiles == 2)
    mma_slab_rot<MT, 2>(A, lda, k0, K, rows, Ws, ldw, nt, acc, warp, g, t);
  else
    mma_slab<MT>(A, lda, k0, K, rows, Ws, ldw, nt, acc, warp, g, t);
}

template <int MT>
__device__ __forceinline__ void fold_any(int tiles, float (&acc)[MT][kNTW][4]) {
  if (tiles == 1) fold<MT, 1>(acc);
  else if (tiles == 2) fold<MT, 2>(acc);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// sum and max over the 8 lanes of a row (lanes 8q .. 8q + 7 of a warp), for
// the row passes of m3oe_infer.cu and ple_infer.cu
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out[rows_s[r]] = sigmoid(h[r] . fw[dom] + fb[dom]) for the tile's rows, a
// warp a row over every warp of the block: h [M, ldh] of width kf, fw [D,
// kf, 1], fb [D, 1]
__device__ __forceinline__ void head_rows(const float* h, int ldh, int kf,
                                          const float* __restrict__ fw,
                                          const float* __restrict__ fb, int dom,
                                          const int* rows_s, int n_rows, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  fw += static_cast<size_t>(dom) * kf;
  for (int r = warp; r < n_rows; r += kAllWarps) {
    float part = 0.f;
    for (int k = lane; k < kf; k += 32) part = fmaf(h[r * ldh + k], __ldg(fw + k), part);
    part = warp_sum(part);
    if (lane == 0) out[rows_s[r]] = sigmoid(part + __ldg(fb + dom));
  }
}

// ---------------------------------------------------------------------------
// Host code: the tensor maps, the tiles' places and the ring's size
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no link to the
// driver library); null where the driver has none
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// the tensor map of W [members, K, N] for tensor_slab: boxes of kChunk
// columns by srows rows of one member
inline bool encode_map(const float* w, int K, int N, int members, int srows, CUtensorMap* map) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(members)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * 4,
                                 static_cast<cuuint64_t>(K) * N * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kChunk), static_cast<cuuint32_t>(srows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(w), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The activation tiles of a step list: each tile's width, the steps that
// write it first and read it last (-1: before the first step), and its place
// in the arena (floats a row, times the tile's rows when placed).
struct Tiles {
  struct Tile {
    int width, first, last, at;
  };
  std::vector<Tile> t;

  // a tile first written at step `step`
  int add(int width, int step) {
    t.push_back(Tile{width, step, step, 0});
    return static_cast<int>(t.size()) - 1;
  }
  // tile i (-1: none) is read at step `step`
  void use(int i, int step) {
    if (i >= 0) t[i].last = std::max(t[i].last, step);
  }

  // First fit by lifetime: each tile, in the order it is first written, at the
  // lowest place where it overlaps no tile alive at the same time (a step's
  // input, output and the tiles its pass reads are all alive at that step).
  // Returns the floats a row of the arena.
  int place() {
    int top = 0;
    for (size_t i = 0; i < t.size(); ++i) {
      Tile& a = t[i];
      const int size = ld_act(a.width);
      std::vector<int> at = {0};
      auto alive = [&](const Tile& b) { return b.first <= a.last && a.first <= b.last; };
      for (size_t j = 0; j < i; ++j)
        if (alive(t[j])) at.push_back(t[j].at + ld_act(t[j].width));
      std::sort(at.begin(), at.end());
      for (int x : at) {
        bool free = true;
        for (size_t j = 0; j < i && free; ++j)
          free = !alive(t[j]) || x + size <= t[j].at || t[j].at + ld_act(t[j].width) <= x;
        if (free) {
          a.at = x;
          break;
        }
      }
      top = std::max(top, a.at + size);
    }
    return top;
  }
};

// The ring slot beside `tile_bytes` of tiles in `budget` bytes of shared
// memory: the ring takes what the tiles leave, up to kRing slots of
// kSlotFloats, and at least 8 weight rows of each product a slot. Sets each
// step's copy and its slab rows (a multiple of 8) and their stride in the
// slot: whole rows (one bulk copy a slab, N a multiple of 8 up to kChunk, W
// 16-byte aligned, stride N), a tensor copy of a box kChunk wide (the first
// kMaxMaps products wider than a chunk, N a multiple of 4, stride kChunk),
// else a bulk copy a row (stride ld_slab). A Step has w, K, N, whole, map,
// sld and srows.
template <class Step>
int size_ring(Step* steps, int n, size_t tile_bytes, size_t budget) {
  int min_slot = 0, maps = 0;
  for (int q = 0; q < n; ++q) {
    Step& st = steps[q];
    const bool aligned = (reinterpret_cast<uintptr_t>(st.w) & 15) == 0;
    st.whole = st.N <= kChunk && st.N % 8 == 0 && aligned;
    st.map = st.N > kChunk && st.N % 4 == 0 && aligned && maps < kMaxMaps ? maps++ : -1;
    st.sld = static_cast<short>(st.whole ? st.N
                                : st.map >= 0 ? kChunk : ld_slab(std::min(st.N, kChunk)));
    min_slot = std::max(min_slot, 8 * st.sld);
  }
  const size_t room = budget > tile_bytes ? (budget - tile_bytes) / sizeof(float) / kRing : 0;
  const int slot = static_cast<int>(room < kSlotFloats ? room : kSlotFloats) & ~31;
  const int use = slot < min_slot ? min_slot : slot;
  for (int q = 0; q < n; ++q)
    steps[q].srows =
        static_cast<short>(std::min((use / steps[q].sld) & ~7, round_up(steps[q].K, 8)));
  return use;
}

}  // namespace ring
