// Exact dense torch-Adam over a whole [V, D] embedding table, after summing
// the batch's duplicate-id gradient rows. In place on table, mu and nu.
//
// Replaces the TPU kernel
//   scenario_wise_rec_tpu/ops/pallas/sorted_adam.py:281 sorted_dense_adam_apply
// (its Pallas body `_kernel`, :86-156). Same function: ids sorted ascending,
// one gradient row per id occurrence; every table row, touched or not, gets
//   g  = sum of its rows' gradients + wd * p
//   mu = b1 * mu + (1 - b1) * g
//   nu = b2 * nu + (1 - b2) * g * g
//   p  = p - lr * (mu * bc1r) / (sqrt(nu * bc2r) + eps)
// with bc1r = 1 / (1 - b1^t), bc2r = 1 / (1 - b2^t). Ids outside [0, V),
// negative ones included, contribute nothing.
//
// Bound: bytes. Every row of table, mu and nu is read and written once
// (6 * V * D * 4 bytes; 4.12 GB at the Ali-CCP shape, V = 10,741,000, D = 16)
// plus the K ids and K gradient rows, against ~14 flops per element. At
// 3.35 TB/s that is ~1.23 ms; nothing here may cost more than the stream.
//
// Design (not the TPU's: its lane-dispersed [K, 128] gradient matrix, one-hot
// MXU segment sum and sequential work list exist for a core that runs its grid
// in order):
//   1. `tile_starts_kernel`: for every tile of `block_rows` vocab rows, the
//      first sorted position whose id reaches the tile (a binary search per
//      tile boundary, all in parallel). Tile t owns positions
//      [starts[t], starts[t+1]); ids below 0 sort before tile 0 and ids >= V
//      after the last tile, so they reach no tile.
//   2. `sorted_adam_kernel`, one block per tile. Ids are sorted, so a tile's
//      ids are one contiguous span and no row is shared with another block:
//      no cross-block reduction, no atomics. The block stages its span in
//      shared memory, `stage_rows` positions at a time, with coalesced loads;
//      then warp w sums columns w, w + 8, ...: its 32 lanes take 32
//      consecutive positions and a segmented warp scan (shuffles, head flags
//      from the id changes) leaves each run's total in the run's last lane,
//      which adds it to the tile's shared accumulator [block_rows, D]. A hot
//      row of thousands of duplicates is summed 32 positions per step by
//      every warp at once, not by one thread. The order of the sum is fixed
//      by the data, so the result is the same on every run.
//   3. The same block streams Adam over its whole tile (rows with no id
//      decay too) with 16-byte loads and stores where D % 4 == 0.
// The arithmetic uses the _rn intrinsics so that nvcc contracts nothing into
// an FMA: each element rounds exactly as the plain PyTorch version's chain of
// elementwise ops does, and the two differ only in the order in which three
// or more duplicate gradients are summed.
//
// Plain C interface (no PyTorch headers), built with nvcc for sm_90a and
// loaded with ctypes (ops/kernels/_build.py). The kernels run on the caller's
// stream and allocate nothing: `starts` ([ceil(V / block_rows) + 1] int32) is
// the caller's scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__global__ void tile_starts_kernel(const int* __restrict__ ids, int k,
                                   long long v, int block_rows, int nb,
                                   int* __restrict__ starts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t > nb) return;
  long long bound = static_cast<long long>(t) * block_rows;
  if (bound > v) bound = v;
  starts[t] = lower_bound(ids, k, bound);
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

__global__ void __launch_bounds__(kThreads)
sorted_adam_kernel(float* __restrict__ table, float* __restrict__ mu,
                   float* __restrict__ nu, const int* __restrict__ ids,
                   const float* __restrict__ g, const int* __restrict__ starts,
                   long long v, int d, int block_rows, int stage_rows, int vec4,
                   const Hp h) {
  extern __shared__ __align__(16) float smem[];
  const int dp = d | 1;  // odd row stride: a warp reading one column hits 32 banks
  float* acc = smem;                                           // [block_rows * d]
  float* s_g = acc + static_cast<size_t>(block_rows) * d;      // [stage_rows * dp]
  int* s_row = reinterpret_cast<int*>(s_g + static_cast<size_t>(stage_rows) * dp);

  const long long row0 = static_cast<long long>(blockIdx.x) * block_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(block_rows), v - row0));
  const int n = rows * d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < n; i += kThreads) acc[i] = 0.f;
  const int lo = starts[blockIdx.x], hi = starts[blockIdx.x + 1];
  __syncthreads();

  for (int base = lo; base < hi; base += stage_rows) {
    const int cnt = min(stage_rows, hi - base);
    const float* gsrc = g + static_cast<size_t>(base) * d;
    for (int i = tid; i < cnt * d; i += kThreads) {
      const int r = i / d;
      s_g[r * dp + (i - r * d)] = gsrc[i];
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

  const float omb1 = __fsub_rn(1.f, h.b1), omb2 = __fsub_rn(1.f, h.b2);
  const size_t off0 = static_cast<size_t>(row0) * d;
  if (vec4) {
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
  } else {
    float* t = table + off0;
    float* m = mu + off0;
    float* s = nu + off0;
    for (int i = tid; i < n; i += kThreads) {
      float mi = m[i], si = s[i];
      t[i] = adam_element(t[i], mi, si, acc[i], h, omb1, omb2);
      m[i] = mi;
      s[i] = si;
    }
  }
}

int stage_rows_for(int d) {
  int s = (2048 / d) & ~31;
  return s < 32 ? 32 : (s > 128 ? 128 : s);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of sorted_adam_kernel needs.
size_t sorted_dense_adam_smem_bytes(int d, int block_rows) {
  const size_t stage = static_cast<size_t>(stage_rows_for(d));
  return sizeof(float) * static_cast<size_t>(block_rows) * d +
         stage * (sizeof(float) * (d | 1) + sizeof(int));
}

// table, mu, nu: [v, d] f32, updated in place. ids: [k] int32 sorted
// ascending; g: [k, d] f32 aligned with ids. starts: [ceil(v / block_rows) + 1]
// int32 scratch. Returns cudaGetLastError() after the launches (0 = success).
int sorted_dense_adam_f32(float* table, float* mu, float* nu, const int* ids,
                          const float* g, int* starts, long long v, int d, int k,
                          int block_rows, float lr, float wd, float b1, float b2,
                          float bc1r, float bc2r, float eps, void* stream) {
  if (v <= 0 || d <= 0 || k < 0 || block_rows <= 0) return cudaErrorInvalidValue;
  const long long nb_ll = (v + block_rows - 1) / block_rows;
  if (nb_ll >= 0x7fffffffLL) return cudaErrorInvalidValue;
  const int nb = static_cast<int>(nb_ll);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sorted_dense_adam_smem_bytes(d, block_rows);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sorted_adam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int vec4 = (d % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(mu) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(nu) % 16 == 0);
  tile_starts_kernel<<<(nb + 1 + 255) / 256, 256, 0, s>>>(ids, k, v, block_rows,
                                                          nb, starts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const Hp h{lr, wd, b1, b2, bc1r, bc2r, eps};
  sorted_adam_kernel<<<nb, kThreads, smem, s>>>(table, mu, nu, ids, g, starts, v,
                                                d, block_rows, stage_rows_for(d),
                                                vec4, h);
  return cudaGetLastError();
}

}  // extern "C"
