// Building blocks of a fused eval kernel for NVIDIA Hopper (sm_90a), f32:
// sarnet_infer.cu's (the others, mmoe_infer.cu, hamur_infer.cu,
// ppnet_infer.cu, m3oe_infer.cu, adasparse_infer.cu, which also runs EPNet's,
// ple_infer.cu, tower_infer.cu, which also runs AdaptDHM's FCN and STAR's,
// and m2m_infer.cu, are built over mma_ring.cuh).
//
// Such a kernel runs a model's whole eval stack after the embedding
// for a tile of `tb` rows in one thread block, with every activation in
// dynamic shared memory: one read of the tile's embedding rows, one write of
// its probabilities. The stack is a series of dense affine stages; what
// differs between rows is only which domain's weights a stage uses. So a
// block sorts its rows by domain and cuts them into *groups*: rows that
// share a weight matrix, at most R of them.
//
// - Shared-weight stages (SAR-Net's shared experts) take the tile's rows in order, R = kSharedRows at a
//   time, as one domain.
// - Per-domain stages (SAR-Net's own experts) take the rows of one domain,
//   R = kDomainRows at a time. A row computes only its own domain, where
//   the TPU kernels compute every domain and select.
//
// In a dense stage a thread owns one output column of one group: one weight
// load from L2 feeds R FMAs, and the activations are read from shared memory
// as float4 along k, the same address across the warp (a broadcast).
// Nothing here uses tensor cores (wgmma) or TMA yet: simple first.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace fused {

constexpr int kThreads = 256;
constexpr int kMaxStages = 96;     // affine stages one launch takes, all chains
constexpr int kMaxBlockRows = 64;  // rows of a tile
constexpr int kSharedRows = 8;     // rows of a shared-weight group
constexpr int kDomainRows = 4;     // rows of a per-domain group

// One affine stage: W [members..., K, N] and b [members..., N]; the member
// a group uses is chosen by the caller (see chain()).
struct Stage {
  const float* w;
  const float* b;
  int K, N;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// relu that keeps a NaN visible, as max(x, 0) does in XLA
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Row groups of a tile: group g holds rows[g * R + m] for m < cnt[g] (the
// rest repeat its first row and are never written) and uses domain dom[g].
struct Groups {
  const int* rows;
  const int* cnt;
  const int* dom;
  int n;
};

// An activation tensor in shared memory: row r of domain d at
// p + d * dstride + r * ld (dstride 0: one tensor for every domain).
struct Act {
  const float* p;
  size_t dstride;
  int ld;
};

// Integer scratch a block needs for its groups (ints).
__host__ __device__ inline int group_ints(int tb) {
  // did, order, shared rows/cnt/dom, domain rows (R = kDomainRows)/cnt/dom, 2 counts
  return tb * (5 + kDomainRows + 2) + 2;
}

// Stages the tile: emb rows [row0, row0 + rows) into dst [tb, ld], zeros past
// the batch and in the pad columns, and the domain ids clipped to [0, D) (all
// 0 when did is null: no domain).
__device__ void stage_tile(const float* __restrict__ emb, const int* __restrict__ did,
                           int row0, int rows, int F, int D, float* dst, int ld,
                           int tb, int* did_s) {
  for (int i = threadIdx.x; i < tb * ld; i += blockDim.x) {
    const int r = i / ld, c = i % ld;
    dst[i] = (r < rows && c < F) ? emb[(size_t)(row0 + r) * F + c] : 0.f;
  }
  for (int r = threadIdx.x; r < tb; r += blockDim.x) {
    const int d = (r < rows && did != nullptr) ? did[row0 + r] : 0;
    did_s[r] = min(max(d, 0), D - 1);
  }
}

// Builds both group sets of the tile's `rows` valid rows from did_s. `ints`
// is the block's group scratch after did_s (group_ints(tb) - tb ints).
__device__ void build_groups(const int* did_s, int rows, int tb, int* ints,
                             Groups* shared_g, Groups* domain_g) {
  int* order = ints;
  int* srows = order + tb;
  int* scnt = srows + tb;
  int* sdom = scnt + tb;
  int* drows = sdom + tb;
  int* dcnt = drows + kDomainRows * tb;
  int* ddom = dcnt + tb;
  int* dn = ddom + tb;
  // shared: consecutive rows, kSharedRows at a time
  const int sn = (rows + kSharedRows - 1) / kSharedRows;
  for (int i = threadIdx.x; i < sn * kSharedRows; i += blockDim.x) {
    srows[i] = min(i, rows - 1);
    if (i % kSharedRows == 0) {
      scnt[i / kSharedRows] = min(kSharedRows, rows - i);
      sdom[i / kSharedRows] = 0;
    }
  }
  // by domain: a stable rank of every row by (domain, row)
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int d = did_s[r];
    int rank = 0;
    for (int q = 0; q < rows; ++q) {
      const int e = did_s[q];
      rank += (e < d) || (e == d && q < r);
    }
    order[rank] = r;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int g = -1, c = kDomainRows;
    for (int i = 0; i < rows; ++i) {
      const int r = order[i], d = did_s[r];
      if (c == kDomainRows || d != ddom[g]) {
        if (g >= 0) {
          dcnt[g] = c;
          for (int m = c; m < kDomainRows; ++m) drows[g * kDomainRows + m] = drows[g * kDomainRows];
        }
        ++g;
        ddom[g] = d;
        c = 0;
      }
      drows[g * kDomainRows + c++] = r;
    }
    dcnt[g] = c;
    for (int m = c; m < kDomainRows; ++m) drows[g * kDomainRows + m] = drows[g * kDomainRows];
    *dn = g + 1;
  }
  __syncthreads();
  *shared_g = Groups{srows, scnt, sdom, sn};
  *domain_g = Groups{drows, dcnt, ddom, *dn};
}

// The epilogue of a dense stage: column j of the group's valid rows, relu
// (kRelu) after the bias.
template <int R, bool kRelu, bool kAccum>
__device__ __forceinline__ void store(const Groups& G, int g, int d, int j, const float* acc,
                                      const int* rr, const float* __restrict__ bias,
                                      size_t b_dstride, float* out, int ld_out) {
  const float bj = bias != nullptr ? __ldg(bias + (size_t)d * b_dstride + j) : 0.f;
  const int c = G.cnt[g];
#pragma unroll
  for (int m = 0; m < R; ++m)
    if (m < c) {
      float* o = out + (size_t)rr[m] * ld_out + j;
      const float v = (kAccum ? *o + acc[m] : acc[m]) + bj;
      *o = kRelu ? relu(v) : v;
    }
}

// out[r, j] = act(sum_k in_d[r, k] * W_d[k, j] + b_d[j]) for every row r of
// every group, d the group's domain, where in_d = in.p + d * in.dstride,
// W_d = W + d * w_dstride and b_d = bias + d * b_dstride (a null bias adds
// nothing). With kAccum the stage adds to what out holds,
// out[r, j] = act((out[r, j] + sum_k ...) + b_d[j]): the second half of a
// product split over two inputs, [s ‖ a] W = s W[:S] + a W[S:], so that no
// concatenated activation is ever built.
//
// A narrow stage (fewer (group, column) items than half the block) splits k
// over `ks` neighbouring lanes instead, ks a power of two up to 32, summed
// by a shuffle: otherwise an aux layer of 16 columns would keep 32 of 256
// threads busy, each walking all of k.
template <int R, bool kRelu, bool kAccum = false>
__device__ void dense_split_k(const Groups& G, Act in, int K, const float* __restrict__ W,
                              size_t w_dstride, const float* __restrict__ bias,
                              size_t b_dstride, int N, float* out, int ld_out, int ks) {
  const int items = G.n * N;
  const int item = threadIdx.x / ks, part = threadIdx.x % ks;
  const bool active = item < items;
  const int g = active ? item / N : 0, j = active ? item % N : 0;
  const int d = G.dom[g];
  const float* w = W + (size_t)d * w_dstride + j;
  const float* a = in.p + (size_t)d * in.dstride;
  int rr[R];
  float acc[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    rr[m] = G.rows[g * R + m];
    acc[m] = 0.f;
  }
  if (active) {
    const int k4 = K & ~3;
    for (int k = 4 * part; k < k4; k += 4 * ks) {
      const float w0 = __ldg(w + (size_t)(k + 0) * N);
      const float w1 = __ldg(w + (size_t)(k + 1) * N);
      const float w2 = __ldg(w + (size_t)(k + 2) * N);
      const float w3 = __ldg(w + (size_t)(k + 3) * N);
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(a + (size_t)rr[m] * in.ld + k);
        acc[m] = fmaf(v.x, w0, acc[m]);
        acc[m] = fmaf(v.y, w1, acc[m]);
        acc[m] = fmaf(v.z, w2, acc[m]);
        acc[m] = fmaf(v.w, w3, acc[m]);
      }
    }
    for (int k = k4 + part; k < K; k += ks) {
      const float wk = __ldg(w + (size_t)k * N);
#pragma unroll
      for (int m = 0; m < R; ++m) acc[m] = fmaf(a[(size_t)rr[m] * in.ld + k], wk, acc[m]);
    }
  }
  // every lane of the block takes part: items * ks <= blockDim
  for (int o = ks / 2; o > 0; o >>= 1)
#pragma unroll
    for (int m = 0; m < R; ++m) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
  if (active && part == 0)
    store<R, kRelu, kAccum>(G, g, d, j, acc, rr, bias, b_dstride, out, ld_out);
}

template <int R, bool kRelu, bool kAccum = false>
__device__ void dense(const Groups& G, Act in, int K, const float* __restrict__ W,
                      size_t w_dstride, const float* __restrict__ bias,
                      size_t b_dstride, int N, float* out, int ld_out) {
  const int items = G.n * N;
  int ks = 1;
  while (ks < 32 && 2 * ks * items <= (int)blockDim.x) ks *= 2;
  if (ks > 1) {
    dense_split_k<R, kRelu, kAccum>(G, in, K, W, w_dstride, bias, b_dstride, N, out, ld_out,
                                    ks);
    return;
  }
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int g = item / N, j = item % N;
    const int d = G.dom[g];
    const float* w = W + (size_t)d * w_dstride + j;
    const float* a = in.p + (size_t)d * in.dstride;
    const float* ar[R];
    int rr[R];
    float acc[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      rr[m] = G.rows[g * R + m];
      ar[m] = a + (size_t)rr[m] * in.ld;
      acc[m] = 0.f;
    }
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      const float w0 = __ldg(w + (size_t)(k + 0) * N);
      const float w1 = __ldg(w + (size_t)(k + 1) * N);
      const float w2 = __ldg(w + (size_t)(k + 2) * N);
      const float w3 = __ldg(w + (size_t)(k + 3) * N);
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(ar[m] + k);
        acc[m] = fmaf(v.x, w0, acc[m]);
        acc[m] = fmaf(v.y, w1, acc[m]);
        acc[m] = fmaf(v.z, w2, acc[m]);
        acc[m] = fmaf(v.w, w3, acc[m]);
      }
    }
    for (; k < K; ++k) {
      const float wk = __ldg(w + (size_t)k * N);
#pragma unroll
      for (int m = 0; m < R; ++m) acc[m] = fmaf(ar[m][k], wk, acc[m]);
    }
    store<R, kRelu, kAccum>(G, g, d, j, acc, rr, bias, b_dstride, out, ld_out);
  }
}

// Softmax over N columns of each of the first `rows` rows of x [., ld], in
// place, the max subtracted first.
__device__ void softmax_rows(float* x, int ld, int N, int rows) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float* v = x + (size_t)r * ld;
    float mx = -INFINITY;
    for (int j = 0; j < N; ++j) mx = fmaxf(mx, v[j]);
    float s = 0.f;
    for (int j = 0; j < N; ++j) {
      v[j] = expf(v[j] - mx);
      s += v[j];
    }
    for (int j = 0; j < N; ++j) v[j] /= s;
  }
}

// Runs stages st[0..n) on `in`, each followed by relu (kAct = 1), by a
// softmax over its columns (kAct = 2), or by nothing (kAct = 0). Stage s of group g uses member
// `member + dom[g] * member_dmul` of its stacked weights. Intermediate results alternate between pp0 and pp1 [tb, ld_pp]
// (never the buffer being read); the last stage writes to `last` [tb,
// ld_last] when it is given. Returns where the result lies. Every thread
// of the block calls it; it ends synchronised.
template <int R, int kAct>
__device__ Act chain(const Groups& G, Act in, const Stage* st, int n, int member,
                     int member_dmul, float* pp0, float* pp1, int ld_pp, int rows,
                     float* last = nullptr, int ld_last = 0) {
  for (int s = 0; s < n; ++s) {
    const Stage& S = st[s];
    const size_t kn = (size_t)S.K * S.N;
    const bool to_last = last != nullptr && s == n - 1;
    float* out = to_last ? last : (in.p == pp0 ? pp1 : pp0);
    const int ld_out = to_last ? ld_last : ld_pp;
    dense<R, kAct == 1, false>(
        G, in, S.K, S.w + (size_t)member * kn, (size_t)member_dmul * kn,
        S.b + (size_t)member * S.N, (size_t)member_dmul * S.N, S.N, out, ld_out);
    __syncthreads();
    if (kAct == 2) {
      softmax_rows(out, ld_out, S.N, rows);
      __syncthreads();
    }
    in = Act{out, 0, ld_out};
  }
  return in;
}

// Host side: the stage pool from host arrays of device pointers and of
// (K, N) pairs; false if there are too many stages.
inline bool fill_stages(Stage* st, int n, const void* w_ptrs, const void* b_ptrs,
                        const void* dims) {
  if (n < 0 || n > kMaxStages) return false;
  const float* const* w = static_cast<const float* const*>(w_ptrs);
  const float* const* b = static_cast<const float* const*>(b_ptrs);
  const int* kn = static_cast<const int*>(dims);
  for (int s = 0; s < n; ++s) {
    if (kn[2 * s] < 1 || kn[2 * s + 1] < 1) return false;
    st[s] = Stage{w[s], b[s], kn[2 * s], kn[2 * s + 1]};
  }
  return true;
}

// Host side: allow `smem` bytes of dynamic shared memory for `kernel` and
// launch it on `grid` blocks; returns a cudaError_t.
template <typename Args>
int launch(void (*kernel)(Args), const Args& p, int B, int tb, size_t smem,
           void* stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B == 0) return (int)cudaSuccess;
  kernel<<<(B + tb - 1) / tb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace fused
