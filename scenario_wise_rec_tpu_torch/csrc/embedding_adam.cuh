// Device code shared by the two exact dense-Adam embedding kernels,
// csrc/sorted_adam.cu and csrc/fused_adam.cu: both sum a vocab tile's
// duplicate-id gradient rows in shared memory from ids sorted ascending, then
// stream torch-Adam over every row of the tile. They differ only in how a
// sorted position finds its gradient row (in place, or through `pos`) and in
// how many sorted spans feed one tile (one, or one per segment).
//
// Adam, per element, with bc1r = 1 / (1 - b1^t), bc2r = 1 / (1 - b2^t):
//   g  = sum of the row's gradients + wd * p
//   mu = b1 * mu + (1 - b1) * g
//   nu = b2 * nu + (1 - b2) * g * g
//   p  = p - lr * (mu * bc1r) / (sqrt(nu * bc2r) + eps)
// The _rn intrinsics keep nvcc from contracting anything into an FMA, so each
// element rounds exactly as the plain PyTorch versions' chain of elementwise
// ops does; the two differ only in the order in which three or more duplicate
// gradients are summed.
//
// The seven Adam numbers (lr, wd, b1, b2, bc1r, bc2r, eps) reach the kernel
// either by value (`Hp`, set per launch) or from a `const float*` [7] in
// device memory that each block loads once: the form a CUDA graph replays,
// whose captured launch must read step t's bias corrections afresh each
// replay. The host computes them in f32 either way; the math is the same.
//
// Table, mu and nu are stored in f32 or, for the sorted kernel's bf16 form,
// in bf16 (the storage type T of `adam_tile`, `dense_adam_kernel` and
// `launch`). The tile's accumulator and the gradient rows are f32 in both;
// a bf16 element is widened, takes the same f32 chain and is rounded back to
// nearest even, so a bf16 result differs from the plain version's only
// where the f32 sums' order flips a rounding.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace emb_adam {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Hp {
  float lr, wd, b1, b2, bc1r, bc2r, eps;
};

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (static_cast<long long>(a[mid]) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A row shard: the arrays hold the v rows [row0, row0 + v) of a larger table
// (row0 = 0 and v = the table's rows when it is not sharded), and the ids are
// the whole table's. The shard's tiles are the whole table's tiles of
// block_rows rows that meet it: tile b starts at global row
// first_tile(row0, block_rows) + b * block_rows, so the first and last tiles
// may hold rows of the neighbouring shards. Their positions are summed into
// the accumulator like any other and never written back: a tile's span of
// positions starts where the unsharded table's tile starts, so every row's
// duplicates are summed in the same chunks and the same order as there, and
// a shard's rows come out bit for bit those of the unsharded kernel.
__host__ __device__ __forceinline__ long long first_tile(long long row0, int block_rows) {
  return (row0 / block_rows) * block_rows;
}

// For segment s (sorted positions [seg_off[s], seg_off[s + 1]), or [0, k) when
// seg_off is null and nseg == 1) and tile b: starts[s * (nb + 1) + b] is the
// first position of the segment whose id reaches tile b. Tile b of segment s
// owns positions [starts[s * (nb + 1) + b], starts[s * (nb + 1) + b + 1]);
// ids below the first tile sort before it and ids >= row0 + v after the last
// tile, so they reach no tile.
__global__ void tile_starts_kernel(const int* __restrict__ ids,
                                   const int* __restrict__ seg_off, int nseg,
                                   int k, long long v, long long row0, int block_rows,
                                   int nb, int* __restrict__ starts) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(nseg) * (nb + 1)) return;
  const int s = static_cast<int>(t / (nb + 1));
  const int b = static_cast<int>(t - static_cast<long long>(s) * (nb + 1));
  const int lo = seg_off ? seg_off[s] : 0;
  const int hi = seg_off ? seg_off[s + 1] : k;
  long long bound = first_tile(row0, block_rows) + static_cast<long long>(b) * block_rows;
  if (bound > row0 + v) bound = row0 + v;
  starts[t] = lo + lower_bound(ids + lo, hi - lo, bound);
}

__device__ __forceinline__ float adam_element(float p, float& m, float& s,
                                              float acc, const Hp& h,
                                              float omb1, float omb2) {
  const float g = __fadd_rn(acc, __fmul_rn(h.wd, p));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(omb1, g));
  s = __fadd_rn(__fmul_rn(h.b2, s), __fmul_rn(omb2, __fmul_rn(g, g)));
  const float upd = __fdiv_rn(__fmul_rn(h.lr, __fmul_rn(m, h.bc1r)),
                              __fadd_rn(__fsqrt_rn(__fmul_rn(s, h.bc2r)), h.eps));
  return __fsub_rn(p, upd);
}

// A stored element as f32 (exact for both types), and an f32 result in the
// storage type, bf16 rounded to nearest even.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sorted positions one staging pass of a block holds in shared memory.
inline int stage_rows_for(int d) {
  int s = (2048 / d) & ~31;
  return s < 32 ? 32 : (s > 128 ? 128 : s);
}

// Dynamic shared memory one block needs: the tile's accumulator, the
// staging buffers of `accumulate_span` and the tile's span of each of the
// nseg segments.
inline size_t smem_bytes(int d, int block_rows, int nseg) {
  const size_t stage = static_cast<size_t>(stage_rows_for(d));
  return sizeof(float) * static_cast<size_t>(block_rows) * d +
         stage * (sizeof(float) * (d | 1) + sizeof(int)) +
         2 * sizeof(int) * static_cast<size_t>(nseg);
}

// Adds the gradient rows of the sorted positions [lo, hi), whose ids lie in
// the tile starting at row0 and ascend, into the tile's accumulator
// acc[block_rows * d]. The gradient row of position p is g[pos[p]], or g[p]
// when pos is null. Every thread of the block calls it.
//
// The block stages `stage_rows` positions at a time in shared memory; then
// warp w sums columns w, w + 8, ...: its 32 lanes take 32 consecutive
// positions and a segmented warp scan (shuffles, head flags from the id
// changes) leaves each run's total in the run's last lane, which adds it to
// the accumulator. A hot row of thousands of duplicates is summed 32
// positions per step by every warp at once, not by one thread; one warp owns
// a column, so no two threads add to one element at once, and the order of
// the sum is fixed by the data.
__device__ __forceinline__ void accumulate_span(
    float* acc, float* s_g, int* s_row, const int* __restrict__ ids,
    const int* __restrict__ pos, const float* __restrict__ g, int lo, int hi,
    long long row0, int d, int stage_rows) {
  const int dp = d | 1;  // odd row stride: a warp reading one column hits 32 banks
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int base = lo; base < hi; base += stage_rows) {
    const int cnt = min(stage_rows, hi - base);
    for (int i = tid; i < cnt * d; i += kThreads) {
      const int r = i / d;
      const int c = i - r * d;
      const long long src = pos ? static_cast<long long>(pos[base + r]) : base + r;
      s_g[r * dp + c] = g[src * d + c];
    }
    for (int i = tid; i < cnt; i += kThreads) {
      s_row[i] = static_cast<int>(ids[base + i] - row0);
    }
    __syncthreads();
    for (int c = warp; c < d; c += kWarps) {
      for (int p0 = 0; p0 < cnt; p0 += 32) {
        const int p = p0 + lane;
        const bool valid = p < cnt;
        const int row = valid ? s_row[p] : -1;
        float x = valid ? s_g[p * dp + c] : 0.f;
        const int prev = __shfl_up_sync(kFull, row, 1);
        const int next = __shfl_down_sync(kFull, row, 1);
        const bool head = valid && (lane == 0 || prev != row);
        const unsigned heads = __ballot_sync(kFull, head);
        // the lane where this lane's run starts: the highest head at or below
        // it (lane 0 of a chunk is always a valid head)
        const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float y = __shfl_up_sync(kFull, x, off);
          if (lane - off >= start) x = __fadd_rn(x, y);
        }
        const bool tail = valid && (lane == 31 || p + 1 == cnt || next != row);
        if (tail) acc[row * d + c] = __fadd_rn(acc[row * d + c], x);
      }
    }
    __syncthreads();
  }
}

// Adam over the tile's `rows` rows starting at row0, from the summed
// gradients in acc. T is the storage type of table, mu and nu: float, or
// __nv_bfloat16, whose elements are widened to f32 (exact), run through the
// same f32 chain and rounded back to nearest even by __float2bfloat16_rn, as
// `.to(torch.bfloat16)` and XLA's `astype` round. 16-byte loads and stores
// when vec: 4 floats (d % 4 == 0) or 8 bf16 values (d % 8 == 0), the three
// arrays 16-byte aligned.
template <typename T>
__device__ __forceinline__ void adam_tile(T* __restrict__ table, T* __restrict__ mu,
                                          T* __restrict__ nu, const float* acc,
                                          long long row0, int rows, int d, int vec,
                                          const Hp& h) {
  const int n = rows * d, tid = threadIdx.x;
  const float omb1 = __fsub_rn(1.f, h.b1), omb2 = __fsub_rn(1.f, h.b2);
  const size_t off0 = static_cast<size_t>(row0) * d;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      float4* t4 = reinterpret_cast<float4*>(table + off0);
      float4* m4 = reinterpret_cast<float4*>(mu + off0);
      float4* v4 = reinterpret_cast<float4*>(nu + off0);
      const float4* a4 = reinterpret_cast<const float4*>(acc);
      for (int i = tid; i < (n >> 2); i += kThreads) {
        float4 p = t4[i], m = m4[i], s = v4[i];
        const float4 a = a4[i];
        p.x = adam_element(p.x, m.x, s.x, a.x, h, omb1, omb2);
        p.y = adam_element(p.y, m.y, s.y, a.y, h, omb1, omb2);
        p.z = adam_element(p.z, m.z, s.z, a.z, h, omb1, omb2);
        p.w = adam_element(p.w, m.w, s.w, a.w, h, omb1, omb2);
        t4[i] = p;
        m4[i] = m;
        v4[i] = s;
      }
      return;
    }
  } else {
    if (vec) {
      uint4* t8 = reinterpret_cast<uint4*>(table + off0);
      uint4* m8 = reinterpret_cast<uint4*>(mu + off0);
      uint4* v8 = reinterpret_cast<uint4*>(nu + off0);
      const float4* a4 = reinterpret_cast<const float4*>(acc);
      for (int i = tid; i < (n >> 3); i += kThreads) {
        uint4 pw = t8[i], mw = m8[i], sw = v8[i];
        const float4 a0 = a4[2 * i], a1 = a4[2 * i + 1];
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(&pw);
        __nv_bfloat16* m = reinterpret_cast<__nv_bfloat16*>(&mw);
        __nv_bfloat16* s = reinterpret_cast<__nv_bfloat16*>(&sw);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float mj = __bfloat162float(m[j]), sj = __bfloat162float(s[j]);
          const float pj = adam_element(__bfloat162float(p[j]), mj, sj, a[j], h, omb1, omb2);
          p[j] = __float2bfloat16_rn(pj);
          m[j] = __float2bfloat16_rn(mj);
          s[j] = __float2bfloat16_rn(sj);
        }
        t8[i] = pw;
        m8[i] = mw;
        v8[i] = sw;
      }
      return;
    }
  }
  T* t = table + off0;
  T* m = mu + off0;
  T* s = nu + off0;
  for (int i = tid; i < n; i += kThreads) {
    float mi = widen(m[i]), si = widen(s[i]);
    t[i] = narrow<T>(adam_element(widen(t[i]), mi, si, acc[i], h, omb1, omb2));
    m[i] = narrow<T>(mi);
    s[i] = narrow<T>(si);
  }
}

// One block per tile of block_rows rows: zero the accumulator, sum the tile's
// sorted spans (one per segment: positions [starts[s * (nb + 1) + b],
// starts[s * (nb + 1) + b + 1]), read into shared memory all at once), then
// Adam over the tile's rows of the shard [row0, row0 + v) (rows with no id
// decay too). Ids are sorted within a segment, so a tile's ids in one
// segment are one contiguous span and no row is shared with another block:
// no cross-block reduction, no atomics. The Adam numbers are `h`, or when
// `hp_dev` is not null the 7 floats there, loaded once by the block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_adam_kernel(T* __restrict__ table, T* __restrict__ mu, T* __restrict__ nu,
                  const int* __restrict__ ids, const int* __restrict__ pos,
                  const float* __restrict__ g, const int* __restrict__ starts, int nseg,
                  int nb, long long v, long long row0, int d, int block_rows,
                  int stage_rows, int vec, const Hp h, const float* __restrict__ hp_dev) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_hp[7];
  float* acc = smem;                                           // [block_rows * d]
  float* s_g = acc + static_cast<size_t>(block_rows) * d;      // [stage_rows * (d | 1)]
  int* s_row = reinterpret_cast<int*>(s_g + static_cast<size_t>(stage_rows) * (d | 1));
  int* s_span = s_row + stage_rows;                            // [2 * nseg]

  const int b = blockIdx.x;
  // the tile's global rows [t0, t0 + block_rows); the shard's of them
  // [lo, hi); its positions' ids lie in [t0, hi)
  const long long t0 = first_tile(row0, block_rows) + static_cast<long long>(b) * block_rows;
  const long long lo = max(t0, row0);
  const long long hi = min(t0 + block_rows, row0 + v);
  const int rows = static_cast<int>(hi - lo);
  const int skip = static_cast<int>(lo - t0);
  if (hp_dev && threadIdx.x < 7) s_hp[threadIdx.x] = hp_dev[threadIdx.x];
  for (int s = threadIdx.x; s < nseg; s += kThreads) {
    const int* st = starts + static_cast<size_t>(s) * (nb + 1) + b;
    s_span[2 * s] = st[0];
    s_span[2 * s + 1] = st[1];
  }
  for (int i = threadIdx.x; i < (skip + rows) * d; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  for (int s = 0; s < nseg; ++s) {
    accumulate_span(acc, s_g, s_row, ids, pos, g, s_span[2 * s], s_span[2 * s + 1],
                    t0, d, stage_rows);
  }
  const float* acc_own = acc + static_cast<size_t>(skip) * d;
  if (hp_dev) {
    const Hp hd{s_hp[0], s_hp[1], s_hp[2], s_hp[3], s_hp[4], s_hp[5], s_hp[6]};
    adam_tile(table, mu, nu, acc_own, lo - row0, rows, d, vec, hd);
  } else {
    adam_tile(table, mu, nu, acc_own, lo - row0, rows, d, vec, h);
  }
}

// The largest dynamic shared memory dense_adam_kernel<T> has been allowed on
// each device: `launch` raises the limit only when a call needs more, so a
// launch that follows one at the same shape (a captured step after its
// warm-up steps) makes no cudaFuncSetAttribute call. Internal linkage: each
// library that includes this header keeps its own record for its own
// kernel (an inline function's static would be one object for every library
// loaded in the process).
namespace {
template <typename T>
cudaError_t allow_smem(size_t smem) {
  static size_t allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem <= 48 * 1024 || smem <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(dense_adam_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess) allowed[dev] = smem;
  return e;
}
}  // namespace

// Launches tile_starts_kernel, then dense_adam_kernel<T> with the Adam
// numbers `h`, or those at `hp_dev` ([7] f32 on the device) when it is not
// null. table, mu and nu hold the v rows [row0, row0 + v) of the table the
// ids address (row0 = 0: the whole table). Returns cudaGetLastError() after
// the launches (0 = success).
template <typename T>
inline cudaError_t launch(T* table, T* mu, T* nu, const int* ids,
                          const int* pos, const float* g, const int* seg_off,
                          int nseg, int* starts, long long v, int d, int k,
                          int block_rows, const Hp& h, void* stream,
                          const float* hp_dev = nullptr, long long row0 = 0) {
  if (v <= 0 || d <= 0 || k < 0 || nseg <= 0 || block_rows <= 0 || row0 < 0) {
    return cudaErrorInvalidValue;
  }
  const long long nb_ll =
      (row0 + v + block_rows - 1) / block_rows - first_tile(row0, block_rows) / block_rows;
  if (nb_ll >= 0x7fffffffLL) return cudaErrorInvalidValue;
  const int nb = static_cast<int>(nb_ll);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(d, block_rows, nseg);
  cudaError_t e = allow_smem<T>(smem);
  if (e != cudaSuccess) return e;
  // 16 bytes a thread: 4 floats or 8 bf16 values
  const int vec = (d % (16 / static_cast<int>(sizeof(T))) == 0) &&
                  (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(mu) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(nu) % 16 == 0);
  const long long n_starts = static_cast<long long>(nseg) * (nb + 1);
  tile_starts_kernel<<<static_cast<unsigned>((n_starts + 255) / 256), 256, 0, s>>>(
      ids, seg_off, nseg, k, v, row0, block_rows, nb, starts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dense_adam_kernel<T><<<nb, kThreads, smem, s>>>(table, mu, nu, ids, pos, g, starts,
                                                  nseg, nb, v, row0, d, block_rows,
                                                  stage_rows_for(d), vec, h, hp_dev);
  return cudaGetLastError();
}

}  // namespace emb_adam
