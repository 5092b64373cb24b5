// The two row primitives of the lazy ("occurrence") embedding update: the
// duplicate-id gradient sum and the row scatter.
//
// Replaces the TPU kernels
//   scenario_wise_rec_tpu/ops/pallas/row_update.py:71  occurrence_segsum (pallas_call :104)
//   scenario_wise_rec_tpu/ops/pallas/row_update.py:177 scatter_rows      (pallas_call :228)
//
// occurrence_segsum: ids [F, N], g [F, N, D] -> out [F, N, D] with
//   out[f, i] = sum over j of [ids[f, i] == ids[f, j]] g[f, j].
// Every occurrence of an id must receive a bit-identical sum: the scatter
// that follows writes all of them to one row, in any order.
// Bound: bytes (F*N*(4 + 2*D*4): 12.4 MB at 23 x 4096 x 16, ~0.004 ms at
// 3.35 TB/s). The TPU computed it as F*N^2*D MXU operations (an equality-mask
// matmul) to avoid scatters; here it is sort-based. The caller sorts each row
// of ids (a stable sort, so a run keeps its order of occurrence) and passes the
// sorted ids and, per sorted position, the flat index f * N + j of its
// occurrence. `segsum_kernel` gives one warp to every sorted position; a warp
// whose position does not start a run of equal ids leaves at once. The warp of
// a run's first position finds the run's end 32 ids per step (ballot), sums
// the run's gradient rows with its lanes split over rows and 16-byte column
// chunks (a 4096-long hot row takes 512 steps of 8 rows at D = 16, not one
// thread's 65k adds), combines the row groups by a shuffle butterfly (every
// lane ends with the same bits), and writes that one sum to every occurrence.
// The order of each sum is fixed by the data: the result is the same on every
// run.
//
// scatter_rows: dst[ids[k]] = rows[k] in place, dst [V, W], rows [K, W]; ids
// outside [0, V) are dropped. Duplicate ids carry identical rows, so racing
// writes of one row are benign.
// Bound: bytes (2*K*W*4 + K*4: 36.6 MB at K = 94,208, W = 48, ~0.011 ms).
// `scatter_kernel`: one thread per 16-byte chunk of a row (12 per 192-byte
// row at W = 48), so consecutive threads store consecutive chunks of a row.
//
// Plain C interface (no PyTorch headers), built with nvcc for sm_90a and
// loaded with ctypes (ops/kernels/_build.py). The kernels run on the caller's
// stream and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

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

// sid: [total] ids sorted within each row of n positions; perm: [total] the
// flat occurrence index of each sorted position; g, out: [total, c] chunks of
// type T (c = d / 4 with float4, d with float).
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segsum_kernel(const int* __restrict__ sid, const int* __restrict__ perm,
              const T* __restrict__ g, T* __restrict__ out, long long total,
              int n, int c) {
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
        acc = add(acc, g[static_cast<long long>(perm[p]) * c + ch]);
      }
    }
    for (int m = lp; m < 32; m <<= 1) acc = add(acc, shfl_xor(acc, m));
    if (on) {
      for (long long p = i + rg; p < end; p += rp) {
        out[static_cast<long long>(perm[p]) * c + ch] = acc;
      }
    }
  }
}

// dst: [v, c] and rows: [k, c] chunks of type T; one thread per chunk of rows.
template <typename T>
__global__ void scatter_kernel(T* __restrict__ dst, const int* __restrict__ ids,
                               const T* __restrict__ rows, long long k, int c,
                               long long v) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= k * c) return;
  const long long r = t / c;
  const int id = ids[r];
  if (id < 0 || id >= v) return;
  dst[static_cast<long long>(id) * c + (t - r * c)] = rows[t];
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// sid, perm: [total] int32 (total = f * n); g, out: [total, d] f32. Returns
// cudaGetLastError() after the launch (0 = success).
int occurrence_segsum_f32(const int* sid, const int* perm, const float* g,
                          float* out, long long total, int n, int d, void* stream) {
  if (total < 0 || n <= 0 || d <= 0) return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks >= 0x7fffffffLL) return cudaErrorInvalidValue;
  if (d % 4 == 0 && aligned16(g) && aligned16(out)) {
    segsum_kernel<float4><<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock, 0, s>>>(
        sid, perm, reinterpret_cast<const float4*>(g), reinterpret_cast<float4*>(out),
        total, n, d / 4);
  } else {
    segsum_kernel<float><<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock, 0, s>>>(
        sid, perm, g, out, total, n, d);
  }
  return cudaGetLastError();
}

// dst: [v, w] f32, updated in place; ids: [k] int32; rows: [k, w] f32.
// Returns cudaGetLastError() after the launch (0 = success).
int scatter_rows_f32(float* dst, const int* ids, const float* rows, long long k,
                     int w, long long v, void* stream) {
  if (k < 0 || w <= 0 || v < 0) return cudaErrorInvalidValue;
  if (k == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = w % 4 == 0 && aligned16(dst) && aligned16(rows);
  const int c = vec ? w / 4 : w;
  const long long blocks = (k * c + 255) / 256;
  if (blocks >= 0x7fffffffLL) return cudaErrorInvalidValue;
  if (vec) {
    scatter_kernel<float4><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        reinterpret_cast<float4*>(dst), ids, reinterpret_cast<const float4*>(rows), k,
        c, v);
  } else {
    scatter_kernel<float><<<static_cast<unsigned>(blocks), 256, 0, s>>>(dst, ids, rows,
                                                                       k, c, v);
  }
  return cudaGetLastError();
}

}  // extern "C"
