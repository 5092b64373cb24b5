// Fused AdaptDHM eval forward for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/adaptdhm_infer.py:
// adaptdhm_fused_infer. For each row b of emb[B, F], with its cluster
// c = clip(router[b], 0, C-1) (the argmax of its logits against the frozen
// centers, taken outside the kernel): h = relu(... relu(emb[b] W_c^0) ...)
// through every stage but the last, then sigmoid(h W_c^last), the last of
// width 1. The stages are W_shared ⊙ W_cluster with no bias (the model
// creates biases and never applies them). The TPU kernel computes every
// cluster for every row and selects; the value per row is the same.
//
// What bounds it on this card: arithmetic. At AdaptDHM's Ali-CCP shape
// (F = 368, stages [256,128,64,32,16,8,1], 3 clusters) a row costs 137,864
// multiply-adds in its own cluster and moves ~1.5 KB: a 4096-row batch is
// ~1.13 GFLOP against ~7 MB (3.39 GFLOP if every cluster ran).
//
// What the design does about it (fused_mlp.cuh): one block of 256 threads
// owns tb rows (default 16) in two ping-pong buffers of dynamic shared
// memory; rows are grouped by cluster, 4 at a time, so a row pays for its
// own cluster only, and the weights (~0.7 MB for 3 clusters) stream from L2.
//
// Bound through ctypes: a plain C interface, every pointer and the stream as
// void*, the cudaError_t of the launch returned.

#include "fused_mlp.cuh"

namespace {

using fused::Act;
using fused::Groups;
using fused::Stage;

struct Args {
  const float* emb;  // [B, F]
  const int* rid;    // [B] cluster ids
  float* out;        // [B]
  int B, F, C, tb, ld, n;
  Stage st[fused::kMaxStages];  // W [C, in, out], no bias
};

__global__ void __launch_bounds__(fused::kThreads)
adaptdhm_fused_infer_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(16) float smem[];
  const int tb = p.tb;
  float* buf0 = smem;                       // [tb, ld]
  float* buf1 = buf0 + tb * p.ld;           // [tb, ld]
  float* logit = buf1 + tb * p.ld;          // [tb]
  int* rid_s = reinterpret_cast<int*>(logit + fused::round4(tb));

  const int row0 = blockIdx.x * tb;
  const int rows = min(tb, p.B - row0);
  fused::stage_tile(p.emb, p.rid, row0, rows, p.F, p.C, buf0, p.ld, tb, rid_s);
  __syncthreads();
  Groups all, own;
  fused::build_groups(rid_s, rows, tb, rid_s + tb, &all, &own);

  const Act h = fused::chain<fused::kDomainRows, 1>(own, Act{buf0, 0, p.ld}, p.st, p.n - 1,
                                                    0, 1, buf0, buf1, p.ld, rows);
  fused::chain<fused::kDomainRows, 0>(own, h, p.st + p.n - 1, 1, 0, 1, buf0, buf1, p.ld,
                                      rows, logit, 1);
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    p.out[row0 + r] = fused::sigmoid(logit[r]);
}

}  // namespace

extern "C" {

// w_ptrs: a host array of device pointers, one per stage (b_ptrs: nulls);
// dims: (K, N) per stage. Writes the dynamic shared memory a block needs to
// *smem_bytes. Returns a cudaError_t.
int adaptdhm_fused_infer_f32(const void* emb, const void* rid, void* out, int B, int F,
                             int C, int n, const void* w_ptrs, const void* b_ptrs,
                             const void* dims, int block_rows, void* stream,
                             size_t* smem_bytes) {
  Args p = {};
  if (B < 0 || F < 1 || C < 1 || n < 1 || block_rows < fused::kSharedRows ||
      block_rows > fused::kMaxBlockRows || block_rows % fused::kSharedRows != 0 ||
      !fused::fill_stages(p.st, n, w_ptrs, b_ptrs, dims))
    return (int)cudaErrorInvalidValue;
  int width = F, max_w = F;
  for (int s = 0; s < n; ++s) {
    if (p.st[s].K != width || p.st[s].b != nullptr) return (int)cudaErrorInvalidValue;
    width = p.st[s].N;
    max_w = width > max_w ? width : max_w;
  }
  if (width != 1) return (int)cudaErrorInvalidValue;
  p.emb = static_cast<const float*>(emb);
  p.rid = static_cast<const int*>(rid);
  p.out = static_cast<float*>(out);
  p.B = B; p.F = F; p.C = C; p.tb = block_rows; p.n = n;
  p.ld = fused::round4(max_w);
  const size_t smem = (2 * (size_t)block_rows * p.ld + fused::round4(block_rows)) * sizeof(float)
                      + (size_t)fused::group_ints(block_rows) * sizeof(int);
  *smem_bytes = smem;
  return fused::launch(adaptdhm_fused_infer_kernel, p, B, block_rows, smem, stream);
}

}  // extern "C"
