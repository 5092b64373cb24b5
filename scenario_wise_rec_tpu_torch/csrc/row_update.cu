// The two row primitives of the lazy ("occurrence") embedding update: the
// duplicate-id gradient sum and the row scatter.
//
// Replaces the TPU kernels
//   scenario_wise_rec_tpu/ops/pallas/row_update.py:71  occurrence_segsum (pallas_call :104)
//   scenario_wise_rec_tpu/ops/pallas/row_update.py:177 scatter_rows      (pallas_call :228)
//
// occurrence_segsum: ids [F, N] (int32 or int64, compared by their low 32
// bits, as the JAX kernel's int32 ids), g [F, N, D] -> out [F, N, D] with
//   out[f, i] = sum over j of [ids[f, i] == ids[f, j]] g[f, j].
// Every occurrence of an id must receive a bit-identical sum: the scatter
// that follows writes all of them to one row, in any order.
// Bound: bytes (F*N*(8 + 2*D*4) with int64 ids: 12.8 MB at 23 x 4096 x 16,
// ~0.004 ms at 3.35 TB/s). The TPU computed it as F*N^2*D MXU operations (an
// equality-mask matmul) to avoid scatters; here it is sort-based, and the
// trainer calls it once per step as [23, 4096] (one row per owner).
//
// Two routes, chosen by the row length N (the wrapper picks, nothing falls
// back):
// - N <= kRowLimit (16384, the bench's batch; every row the trainer makes
//   at Ali-CCP, 4096): `segsum_rows_kernel`, one launch and no work outside
//   it. Each block takes one row (splits blocks per row, gridDim.y, each
//   sorting the same row and taking a share of its runs, so that 23 rows
//   fill more of the card's 132 SMs). The block loads the row's ids (their
//   low 32 bits) and positions into shared memory and sorts them by a
//   stable LSD radix sort, 8 bits a pass and only the passes the row's id
//   range needs (3 at Ali-CCP's 467,000 ids a feature): warp w ranks its
//   32 E positions 32 a round (the lanes of a digit found by 8 ballots),
//   the per-warp digit counts are scanned digit-major, and every key moves
//   to its place, equal ids in order of occurrence. (A bitonic network over
//   64-bit keys took ~0.039 ms a block at N = 4096 on an H100: O(N log^2 N)
//   compare-exchanges on one SM.) A block-wide scan of the run
//   heads lists the runs. Then a group of G lanes (one float4 each; G = 4
//   at D = 16) takes kBatch runs at a time (their loads in flight
//   together), sums each run's gradient rows in sorted order and writes
//   that one sum to every occurrence. A run longer than kLongRun (64) goes
//   to a whole block after the short ones (a row's long runs dealt out
//   over its blocks): rows summed strided over the block, the partial sums
//   combined by a fixed tree in shared memory. Shared memory: 12 np + 1 KB
//   * (threads / 32 + 1) bytes, 225 KB at N = 16384 (227 KB is the card's
//   limit).
// - N > kRowLimit: `segsum_sorted_kernel` after a stable torch.sort of each
//   row (the wrapper's, of the ids cast to int32: int64 ids are grouped by
//   their low 32 bits on both routes). The kernel reads the sort's int64
//   indices and adds the row offset itself. One warp per sorted position; the
//   warp of a run's first position finds the run's end 32 ids a step
//   (ballot), sums its rows with its lanes split over rows and 16-byte
//   chunks, combines them by a shuffle butterfly and writes the one sum to
//   every occurrence.
// On both routes the order of every sum is fixed by the data and the shape:
// the result is the same on every run, and does not depend on splits.
//
// scatter_rows: dst[ids[k]] = rows[k] in place, dst [V, W], rows [K, W]; ids
// (int32 or int64, as the trainer passes them) follow the XLA form of the
// reference (dst.at[ids].set(rows, mode="drop")): a negative id wraps once
// (id + V), and what is still outside [0, V) is dropped in the kernel.
// Duplicate ids (an id in [-V, -1] and its wrapped twin included) carry
// identical rows, so racing writes of one row are benign; no atomics.
// Bound: bytes (2*K*W*4 + K*8 with int64 ids: 37.3 MB at K = 94,208, W = 48,
// ~0.011 ms). A row is 192 bytes at W = 48, six 32-byte sectors. The kernel
// is chosen by the row's shape:
// - `scatter_bulk_kernel`, rows of a multiple of 4 floats, at most 896 wide
//   (64 of them fill 224 KB of shared memory), with 16-byte aligned dst and
//   rows (the trainer's [V, 48] store): Hopper's bulk async
//   copy. One thread brings the block's contiguous slice of 64 rows into
//   shared memory (cp.async.bulk, completed on an mbarrier), then each row's
//   thread stores its row to dst[id] with one bulk copy (a bulk group, waited
//   on before the block leaves), so no registers carry the data.
// - `scatter_lanes_kernel`, any other row: a group of L lanes per row (L the
//   largest power of two <= 32 dividing W), all loads of a lane issued before
//   its stores; one id load per row, shared over the group with __shfl_sync;
//   32-bit offsets where V * W and K * W allow. (The bulk copies take the
//   rows they can: at the trainer's shape a float4 form of the lanes ran
//   0.0151 ms on an H100 to their 0.0122.)
//
// Plain C interface (no PyTorch headers), built with nvcc for sm_90a and
// loaded with ctypes (ops/kernels/_build.py). The kernels run on the caller's
// stream and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kRowLimit = 16384;  // longest row of the shared-memory route
constexpr int kLongRun = 64;      // longer runs are summed by the whole block
constexpr int kBatch = 4;         // short runs a lane group sums at once
constexpr int kMaxLong = kRowLimit / (kLongRun + 1) + 1;
constexpr int kScatterThreads = 256;
constexpr int kBulkRows = 64;     // rows per block of the bulk scatter
// the widest row of the bulk scatter: kBulkRows rows of it fill 224 KB of
// shared memory (a block may have 227 KB on the card)
constexpr int kBulkMaxW = 224 * 1024 / (kBulkRows * 4);

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float shfl_xor(float a, int m) {
  return __shfl_xor_sync(kFull, a, m);
}
__device__ __forceinline__ float4 shfl_xor(float4 a, int m) {
  return make_float4(__shfl_xor_sync(kFull, a.x, m), __shfl_xor_sync(kFull, a.y, m),
                     __shfl_xor_sync(kFull, a.z, m), __shfl_xor_sync(kFull, a.w, m));
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// ---------------------------------------------------------------------------
// occurrence_segsum, shared-memory route

__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// Shared memory of segsum_rows_kernel for np keys and nt threads: two key
// buffers (u32, np + 4 each: the spare one then holds the n + 1 run starts),
// two position buffers (u16) and the warps' digit counts (u32, digit-major
// with a row of warps + 1, so that neither a warp's random digits nor the
// scan's consecutive entries share a bank), whose room then holds the long
// runs' partial sums (one T a thread).
template <typename T>
size_t rows_smem_bytes(int np, int nt) {
  const size_t counts = 4ull * 256 * (nt / 32 + 1), part = sizeof(T) * nt;
  return 2 * align16(4ull * (np + 4)) + 2 * align16(2ull * np) +
         align16(counts > part ? counts : part);
}

// Exclusive prefix sum of v over the block's threads in thread order, and
// the block's total in *total. buf: 33 ints of shared memory. Every thread
// of the block must call it; it leaves buf free for the next call.
__device__ int block_exclusive_scan(int v, int* buf, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nw ? buf[lane] : 0;
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < nw) buf[lane] = wi - w;
    if (lane == 31) buf[32] = wi;
  }
  __syncthreads();
  const int before = buf[warp] + incl - v;
  *total = buf[32];
  __syncthreads();
  return before;
}

// ids: [f, n] (Id = int or long long); g, out: [f, n, c] chunks of type T.
// np: n rounded up to a power of two, at least 128; blockDim.x = np / E, so
// that warp w's segment of the radix passes is positions [32 E w, 32 E (w +
// 1)), E per lane.
template <typename T, typename Id, int E>
__global__ void __launch_bounds__(1024)
segsum_rows_kernel(const Id* __restrict__ ids, const T* __restrict__ g, T* __restrict__ out,
                   int n, int np, int c) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* key[2];
  uint16_t* pos[2];
  key[0] = reinterpret_cast<uint32_t*>(smem);
  key[1] = reinterpret_cast<uint32_t*>(smem + align16(4ull * (np + 4)));
  pos[0] = reinterpret_cast<uint16_t*>(smem + 2 * align16(4ull * (np + 4)));
  pos[1] = pos[0] + align16(2ull * np) / 2;
  int* counts = reinterpret_cast<int*>(smem + 2 * align16(4ull * (np + 4)) +
                                       2 * align16(2ull * np));
  T* part = reinterpret_cast<T*>(counts);
  __shared__ int scan_buf[33];
  __shared__ unsigned lo_key, hi_key;
  __shared__ int n_long;
  __shared__ int long_runs[kMaxLong];

  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * n;  // first occurrence
  if (tid == 0) {
    lo_key = 0xffffffffu;
    hi_key = 0;
    n_long = 0;
  }
  __syncthreads();
  // 1. keys (the ids' low 32 bits) and positions, and the keys' range
  unsigned lo = 0xffffffffu, hi = 0;
#pragma unroll
  for (int q = 0; q < E; ++q) {  // np = E * nt: the loads in flight together
    const int i = tid + q * nt;
    if (i < n) {
      const uint32_t k = static_cast<uint32_t>(ids[row + i]);
      key[0][i] = k;
      pos[0][i] = static_cast<uint16_t>(i);
      lo = k < lo ? k : lo;
      hi = k > hi ? k : hi;
    }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {
    atomicMin(&lo_key, lo);
    atomicMax(&hi_key, hi);
  }
  __syncthreads();
  lo = lo_key;
  const uint32_t span = hi_key - lo;
  const int passes = span == 0 ? 0 : (32 - __clz(static_cast<int>(span)) + 7) / 8;
  // 2. a stable LSD radix sort on (key - lo), 8 bits a pass, only the
  //    passes the range needs (3 at Ali-CCP's 467,000 rows a feature).
  //    Warp w ranks its segment 32 positions a round (lanes of one digit
  //    rank by lane), the digit counts are scanned digit-major, warp-minor,
  //    and each key goes to its digit's offset + its warp's + its rank:
  //    equal keys keep their order of occurrence.
  const int seg = 32 * E * warp, warps = nt / 32, stride = warps + 1;
  const int wshift = __ffs(warps) - 1;  // warps is a power of two
  int* wc = counts + warp;              // this warp's count of digit d: wc[d * stride]
  for (int pass = 0; pass < passes; ++pass) {
    const uint32_t* ks = key[pass & 1];
    const uint16_t* ps = pos[pass & 1];
    const int shift = 8 * pass;
    for (int d = lane; d < 256; d += 32) wc[d * stride] = 0;
    __syncwarp();
    int rank[E];
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int i = seg + 32 * q + lane;
      const int d = i < n ? static_cast<int>(((ks[i] - lo) >> shift) & 255u) : 256;
      // the lanes of the same digit, by a ballot per bit (the lanes past n
      // match only each other)
      unsigned peers = __ballot_sync(kFull, d < 256);
      if (d == 256) peers = ~peers;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const unsigned set = __ballot_sync(kFull, (d >> b) & 1);
        peers &= (d >> b) & 1 ? set : ~set;
      }
      const int base = d < 256 ? wc[d * stride] : 0;
      rank[q] = base + __popc(peers & ((1u << lane) - 1));
      __syncwarp();
      if (d < 256 && lane == __ffs(peers) - 1) wc[d * stride] = base + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // exclusive scan of the counts, digit-major: entry L = d * warps + w,
    // 8 consecutive entries a thread (256 * warps = 8 * nt)
    int v[8], sum = 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int L = 8 * tid + u;
      v[u] = counts[(L >> wshift) * stride + (L & (warps - 1))];
      sum += v[u];
    }
    int total;
    int offset = block_exclusive_scan(sum, scan_buf, &total);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int L = 8 * tid + u;
      counts[(L >> wshift) * stride + (L & (warps - 1))] = offset;
      offset += v[u];
    }
    __syncthreads();
    uint32_t* kd = key[(pass + 1) & 1];
    uint16_t* pd = pos[(pass + 1) & 1];
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int i = seg + 32 * q + lane;
      if (i < n) {
        const int to = wc[(((ks[i] - lo) >> shift) & 255u) * stride] + rank[q];
        kd[to] = ks[i];
        pd[to] = ps[i];
      }
    }
    __syncthreads();
  }
  const uint32_t* sk = key[passes & 1];
  const uint16_t* sp = pos[passes & 1];
  int* run = reinterpret_cast<int*>(key[(passes + 1) & 1]);
  // 3. the runs' starts in sorted order (a block-wide scan of the run heads,
  //    E consecutive positions a thread); run[nr] = n
  unsigned heads = 0;
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int p = tid * E + q;
    if (p < n && (p == 0 || sk[p] != sk[p - 1])) heads |= 1u << q;
  }
  int nr;
  int next = block_exclusive_scan(__popc(heads), scan_buf, &nr);
#pragma unroll
  for (int q = 0; q < E; ++q) {
    if (heads >> q & 1u) run[next++] = tid * E + q;
  }
  if (tid == 0) run[nr] = n;
  __syncthreads();
  // this block's share of the runs
  const int r0 = static_cast<int>(static_cast<long long>(nr) * blockIdx.y / gridDim.y);
  const int r1 = static_cast<int>(static_cast<long long>(nr) * (blockIdx.y + 1) / gridDim.y);
  auto at = [&](int p) { return (row + sp[p]) * c; };
  // 4. short runs: a group of G lanes per run, kBatch runs at once (their
  //    loads in flight together), each summed in sorted order
  int G = 1;
  while (G < c && G < 32) G <<= 1;
  const int gl = tid % G, groups = nt / G;
  for (int rb = r0 + tid / G; rb < r1; rb += kBatch * groups) {
    int s[kBatch], e[kBatch], longest = 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int ru = rb + u * groups;
      s[u] = ru < r1 ? run[ru] : 0;
      e[u] = ru < r1 ? run[ru + 1] : 0;
      if (e[u] - s[u] > kLongRun) e[u] = s[u];  // step 5's
      longest = e[u] - s[u] > longest ? e[u] - s[u] : longest;
    }
    for (int ch = gl; ch < c; ch += G) {
      T acc[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) acc[u] = zero<T>();
      for (int m = 0; m < longest; ++m) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (s[u] + m < e[u]) acc[u] = add(acc[u], g[at(s[u] + m) + ch]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        for (int p = s[u]; p < e[u]; ++p) out[at(p) + ch] = acc[u];
      }
    }
  }
  // 5. long runs: the whole block, one run at a time; rows strided over
  //    rows_per row groups, then a fixed tree over the groups. A row's long
  //    runs are dealt out over its blocks by run index (Zipf ids put them
  //    all among the first runs, in one block's share)
  for (int ru = tid; ru < nr; ru += nt) {
    if (ru % gridDim.y == blockIdx.y && run[ru + 1] - run[ru] > kLongRun)
      long_runs[atomicAdd(&n_long, 1)] = ru;
  }
  __syncthreads();
  const int nl = n_long, cw = c < nt ? c : nt;
  int rows_per = 1;
  while (rows_per * 2 * cw <= nt) rows_per <<= 1;
  const int rg = tid / cw, cl = tid % cw;
  for (int q = 0; q < nl; ++q) {
    const int ru = long_runs[q], s = run[ru], e = run[ru + 1];
    for (int c0 = 0; c0 < c; c0 += cw) {
      const int ch = c0 + cl;
      if (rg < rows_per) {
        T acc = zero<T>();
        if (ch < c) {
          for (int p = s + rg; p < e; p += kBatch * rows_per) {
            T v[kBatch];  // the loads in flight together, added in order
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const int pu = p + u * rows_per;
              v[u] = pu < e ? g[at(pu) + ch] : zero<T>();
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) acc = add(acc, v[u]);
          }
        }
        part[rg * cw + cl] = acc;
      }
      for (int h = rows_per >> 1; h > 0; h >>= 1) {
        __syncthreads();
        if (rg < h) part[rg * cw + cl] = add(part[rg * cw + cl], part[(rg + h) * cw + cl]);
      }
      __syncthreads();
      for (int idx = tid; idx < (e - s) * cw; idx += nt) {
        const int p = s + idx / cw, l = idx % cw;
        if (c0 + l < c) out[at(p) + c0 + l] = part[l];
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// occurrence_segsum, the route of rows longer than kRowLimit

// sid: [total] int32 ids sorted within each row of n positions; idx: [total]
// int64, each sorted position's index in its row (torch.sort's); g, out:
// [total, c] chunks of type T (c = d / 4 with float4, d with float).
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segsum_sorted_kernel(const int* __restrict__ sid, const long long* __restrict__ idx,
                     const T* __restrict__ g, T* __restrict__ out, long long total, int n,
                     int c) {
  const long long i = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= total) return;  // uniform over the warp
  const long long row0 = i - i % n;
  const int key = sid[i];
  if (i > row0 && sid[i - 1] == key) return;  // not the first of its run
  const long long row_end = row0 + n;
  long long end = row_end;
  for (long long base = i + 1; base < row_end; base += 32) {
    const long long p = base + lane;
    const unsigned b = __ballot_sync(kFull, p >= row_end || sid[p] != key);
    if (b) {
      end = base + (__ffs(b) - 1);
      break;
    }
  }
  // lanes: lp (a power of two) per row over the chunks, rp rows at once
  int lp = 1;
  while (lp * 2 <= c && lp < 32) lp *= 2;
  const int rp = 32 / lp, rg = lane / lp, cl = lane % lp;
  for (int c0 = 0; c0 < c; c0 += lp) {
    const int ch = c0 + cl;
    const bool on = ch < c;
    T acc = zero<T>();
    if (on) {
      for (long long p = i + rg; p < end; p += rp) {
        acc = add(acc, g[(row0 + idx[p]) * c + ch]);
      }
    }
    for (int m = lp; m < 32; m <<= 1) acc = add(acc, shfl_xor(acc, m));
    if (on) {
      for (long long p = i + rg; p < end; p += rp) {
        out[(row0 + idx[p]) * c + ch] = acc;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// scatter_rows

// dst: [v, w] and rows: [k, w] f32; ids: [k]. L lanes per row (a power of
// two dividing 32); Ix: the offsets' type (32-bit where v * w and k * w fit).
template <typename Id, typename Ix>
__global__ void __launch_bounds__(kScatterThreads)
scatter_lanes_kernel(float* __restrict__ dst, const Id* __restrict__ ids,
                     const float* __restrict__ rows, int k, int w, int L, long long v) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / L;
  const int r0 = (blockIdx.x * (kScatterThreads / 32) + (threadIdx.x >> 5)) * per_warp;
  if (r0 >= k) return;  // uniform over the warp
  long long mine = -1;  // one id load per row, then shared over its group
  if (lane < per_warp && r0 + lane < k) mine = static_cast<long long>(ids[r0 + lane]);
  const int slot = lane / L, cl = lane % L;
  const long long raw = __shfl_sync(kFull, mine, slot);
  const long long id = raw < 0 ? raw + v : raw;  // a negative id wraps once
  const int r = r0 + slot;
  if (r >= k || id < 0 || id >= v) return;
  const float* src = rows + static_cast<Ix>(r) * static_cast<Ix>(w);
  float* to = dst + static_cast<Ix>(id) * static_cast<Ix>(w);
  constexpr int kInFlight = 4;  // a lane's loads issued before its stores
  for (int c0 = cl; c0 < w; c0 += kInFlight * L) {
    float buf[kInFlight];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int ch = c0 + q * L;
      if (ch < w) buf[q] = src[ch];
    }
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int ch = c0 + q * L;
      if (ch < w) to[ch] = buf[q];
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dst: [v, w] and rows: [k, w] f32 (w % 4 == 0, both 16-byte aligned); one
// thread per row, kBulkRows rows a block.
template <typename Id>
__global__ void __launch_bounds__(kBulkRows)
scatter_bulk_kernel(float* __restrict__ dst, const Id* __restrict__ ids,
                    const float* __restrict__ rows, int k, int w, long long v) {
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ __align__(8) unsigned long long bar;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kBulkRows;
  const int nrow = k - r0 < kBulkRows ? k - r0 : kBulkRows;
  const uint32_t row_bytes = static_cast<uint32_t>(w) * 4u;
  const uint32_t b = smem_addr(&bar), s = smem_addr(buf);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t bytes = row_bytes * static_cast<uint32_t>(nrow);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(s),
        "l"(rows + static_cast<long long>(r0) * w), "r"(bytes), "r"(b)
        : "memory");
  }
  long long id = tid < nrow ? static_cast<long long>(ids[r0 + tid]) : -1;
  if (tid < nrow && id < 0) id += v;  // a negative id wraps once
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(b)
      : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (id >= 0 && id < v) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     dst + id * w),
                 "r"(s + static_cast<uint32_t>(tid) * row_bytes), "r"(row_bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, typename Id, int E>
int launch_rows_e(const Id* ids, const T* g, T* out, int f, int n, int np, int c, int splits,
                  cudaStream_t s) {
  const int threads = np / E;
  const size_t smem = rows_smem_bytes<T>(np, threads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segsum_rows_kernel<T, Id, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch's check
      return err;
    }
  }
  segsum_rows_kernel<T, Id, E><<<dim3(f, splits), threads, smem, s>>>(ids, g, out, n, np, c);
  return cudaGetLastError();
}

// np = n rounded up to a power of two, at least 128; 4 keys a thread up to
// 1024 threads, then 8 or 16 (np = 8192, 16384), so a block has 1024 threads
// at most and the shared-memory passes start at 32 E.
template <typename T, typename Id>
int launch_rows(const Id* ids, const T* g, T* out, int f, int n, int c, int splits,
                cudaStream_t s) {
  int np = 128;
  while (np < n) np <<= 1;
  if (np <= 4096) return launch_rows_e<T, Id, 4>(ids, g, out, f, n, np, c, splits, s);
  if (np == 8192) return launch_rows_e<T, Id, 8>(ids, g, out, f, n, np, c, splits, s);
  return launch_rows_e<T, Id, 16>(ids, g, out, f, n, np, c, splits, s);
}

template <typename Id>
int launch_lanes(float* dst, const Id* ids, const float* rows, int k, int w, long long v,
                 cudaStream_t s) {
  int L = 1;
  while (L < 32 && w % (2 * L) == 0) L *= 2;
  const long long warps = (static_cast<long long>(k) + 32 / L - 1) / (32 / L);
  const long long blocks = (warps + kScatterThreads / 32 - 1) / (kScatterThreads / 32);
  if (blocks >= 0x7fffffffLL) return cudaErrorInvalidValue;
  if (v * w < (1ll << 32) && static_cast<long long>(k) * w < (1ll << 32)) {
    scatter_lanes_kernel<Id, uint32_t><<<static_cast<unsigned>(blocks), kScatterThreads, 0, s>>>(
        dst, ids, rows, k, w, L, v);
  } else {
    scatter_lanes_kernel<Id, unsigned long long>
        <<<static_cast<unsigned>(blocks), kScatterThreads, 0, s>>>(dst, ids, rows, k, w, L, v);
  }
  return cudaGetLastError();
}

template <typename Id>
int launch_bulk(float* dst, const Id* ids, const float* rows, int k, int w, long long v,
                cudaStream_t s) {
  const size_t smem = static_cast<size_t>(kBulkRows) * w * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_bulk_kernel<Id>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left for the next launch's check
      return err;
    }
  }
  scatter_bulk_kernel<Id><<<(k + kBulkRows - 1) / kBulkRows, kBulkRows, smem, s>>>(dst, ids,
                                                                                   rows, k, w, v);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The longest row of the shared-memory route, and the longest run that a
// lane group sums (longer ones go to the whole block).
int occurrence_segsum_row_limit() { return kRowLimit; }
int occurrence_segsum_long_run() { return kLongRun; }

// The shared-memory route: ids [f, n] (int64 when id64, else int32); g, out:
// [f, n, d] f32; n <= kRowLimit; splits blocks per row. Returns
// cudaGetLastError() after the launch (0 = success).
int occurrence_segsum_rows_f32(const void* ids, int id64, const float* g, float* out, int f,
                               int n, int d, int splits, void* stream) {
  if (f < 0 || n <= 0 || n > kRowLimit || d <= 0 || splits <= 0 || splits > 65535)
    return cudaErrorInvalidValue;
  if (f == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && aligned16(g) && aligned16(out);
  if (vec) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* o4 = reinterpret_cast<float4*>(out);
    return id64 ? launch_rows(static_cast<const long long*>(ids), g4, o4, f, n, d / 4, splits, s)
                : launch_rows(static_cast<const int*>(ids), g4, o4, f, n, d / 4, splits, s);
  }
  return id64 ? launch_rows(static_cast<const long long*>(ids), g, out, f, n, d, splits, s)
              : launch_rows(static_cast<const int*>(ids), g, out, f, n, d, splits, s);
}

// The route of longer rows: sid [total] int32 sorted within each row of n;
// idx [total] int64, each sorted position's index in its row; g, out:
// [total, d] f32 (total = f * n). Returns cudaGetLastError() after the launch.
int occurrence_segsum_sorted_f32(const int* sid, const long long* idx, const float* g,
                                 float* out, long long total, int n, int d, void* stream) {
  if (total < 0 || n <= 0 || d <= 0) return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks >= 0x7fffffffLL) return cudaErrorInvalidValue;
  if (d % 4 == 0 && aligned16(g) && aligned16(out)) {
    segsum_sorted_kernel<float4><<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock, 0, s>>>(
        sid, idx, reinterpret_cast<const float4*>(g), reinterpret_cast<float4*>(out), total, n,
        d / 4);
  } else {
    segsum_sorted_kernel<float><<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock, 0, s>>>(
        sid, idx, g, out, total, n, d);
  }
  return cudaGetLastError();
}

// dst: [v, w] f32, updated in place; ids: [k] (int64 when id64, else int32);
// rows: [k, w] f32. A negative id wraps once (id + v); ids still outside
// [0, v) are dropped. Rows of a multiple of 4 floats, at most kBulkMaxW (896)
// wide, with 16-byte aligned dst and rows take the bulk copies, the others the
// lanes. Returns
// cudaGetLastError() after the launch (0 = success).
int scatter_rows_f32(float* dst, const void* ids, int id64, const float* rows, int k, int w,
                     long long v, void* stream) {
  if (k < 0 || w <= 0 || v < 0) return cudaErrorInvalidValue;
  if (k == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w % 4 == 0 && w <= kBulkMaxW && aligned16(dst) && aligned16(rows)) {
    return id64 ? launch_bulk(dst, static_cast<const long long*>(ids), rows, k, w, v, s)
                : launch_bulk(dst, static_cast<const int*>(ids), rows, k, w, v, s);
  }
  return id64 ? launch_lanes(dst, static_cast<const long long*>(ids), rows, k, w, v, s)
              : launch_lanes(dst, static_cast<const int*>(ids), rows, k, w, v, s);
}

}  // extern "C"
