// Fused "shared trunk -> per-domain towers -> select" eval forward for NVIDIA
// Hopper (sm_90a), f32.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/tower_infer.py:
// trunk_towers_fused_infer. For each row b of emb[B, F]: a relu trunk of
// shared affine stages, then the relu tower of the row's own domain
// d = clip(domain_id[b], 0, D-1), then domain d's 1-unit head if there is
// one (else the last tower stage has width 1), then the sigmoid. The TPU
// kernel computes all D towers for every row and selects with jnp.where;
// the value per row is the same.
//
// What bounds it on this card: arithmetic. At SharedBottom's Ali-CCP shape
// (F = 376, trunk [512], towers [256,128,64,32,16,8], 3 domains) a row
// costs 192,512 multiply-adds in the trunk and 174,728 in its own tower and
// moves ~1.5 KB, so a 4096-row batch is ~3.0 GFLOP against ~6 MB: f32
// without tensor cores, the FP32 SIMT peak bounds it, not HBM.
//
// What the design does about it (fused_mlp.cuh): everything after the
// embedding stays on chip. One block of 256 threads owns tb rows (default
// 16); the tile lives in two ping-pong activation buffers in dynamic shared
// memory, [tb, max width]. The trunk runs on the tile's rows 8 at a time;
// the towers on rows grouped by domain, 4 at a time, so a row pays for its
// own tower only. Weights (~1.8 MB) stream from L2. Blocks are independent;
// the ragged last tile is masked here (no pad copy).
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
  const int* did;    // [B]
  float* out;        // [B]
  int B, F, D, tb, ld;
  int n_trunk, n_tow, has_head;
  Stage st[fused::kMaxStages];  // trunk stages, tower stages, head
};

__global__ void __launch_bounds__(fused::kThreads)
tower_fused_infer_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(16) float smem[];
  const int tb = p.tb;
  float* buf0 = smem;                       // [tb, ld]
  float* buf1 = buf0 + tb * p.ld;           // [tb, ld]
  float* logit = buf1 + tb * p.ld;          // [tb]
  int* did_s = reinterpret_cast<int*>(logit + fused::round4(tb));

  const int row0 = blockIdx.x * tb;
  const int rows = min(tb, p.B - row0);
  fused::stage_tile(p.emb, p.did, row0, rows, p.F, p.D, buf0, p.ld, tb, did_s);
  __syncthreads();
  Groups all, own;
  fused::build_groups(did_s, rows, tb, did_s + tb, &all, &own);

  Act h{buf0, 0, p.ld};
  h = fused::chain<fused::kSharedRows, 1>(all, h, p.st, p.n_trunk, 0, 0, buf0, buf1,
                                          p.ld, rows);
  h = fused::chain<fused::kDomainRows, 1>(own, h, p.st + p.n_trunk, p.n_tow, 0, 1,
                                          buf0, buf1, p.ld, rows);
  if (p.has_head)
    h = fused::chain<fused::kDomainRows, 0>(own, h, p.st + p.n_trunk + p.n_tow, 1, 0,
                                            1, buf0, buf1, p.ld, rows, logit, 1);
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    p.out[row0 + r] = fused::sigmoid(h.p[(size_t)r * h.ld]);
}

}  // namespace

extern "C" {

// w_ptrs/b_ptrs: host arrays of device pointers, one per stage, in the order
// trunk stages, tower stages, head (when has_head); dims: (K, N) per stage.
// Writes the dynamic shared memory a block needs to *smem_bytes. Returns a
// cudaError_t.
int tower_fused_infer_f32(const void* emb, const void* did, void* out, int B, int F,
                          int D, int n_trunk, int n_tow, int has_head,
                          const void* w_ptrs, const void* b_ptrs, const void* dims,
                          int block_rows, void* stream, size_t* smem_bytes) {
  Args p = {};
  const int n = n_trunk + n_tow + (has_head ? 1 : 0);
  if (B < 0 || F < 1 || D < 1 || n_trunk < 0 || n_tow < 0 ||
      block_rows < fused::kSharedRows || block_rows > fused::kMaxBlockRows ||
      block_rows % fused::kSharedRows != 0 ||
      !fused::fill_stages(p.st, n, w_ptrs, b_ptrs, dims))
    return (int)cudaErrorInvalidValue;
  int width = F, max_w = F;
  for (int s = 0; s < n; ++s) {
    if (p.st[s].K != width) return (int)cudaErrorInvalidValue;
    width = p.st[s].N;
    max_w = width > max_w ? width : max_w;
  }
  if (width != 1) return (int)cudaErrorInvalidValue;
  p.emb = static_cast<const float*>(emb);
  p.did = static_cast<const int*>(did);
  p.out = static_cast<float*>(out);
  p.B = B; p.F = F; p.D = D; p.tb = block_rows;
  p.ld = fused::round4(max_w);
  p.n_trunk = n_trunk; p.n_tow = n_tow; p.has_head = has_head ? 1 : 0;
  const size_t smem = (2 * (size_t)block_rows * p.ld + fused::round4(block_rows)) * sizeof(float)
                      + (size_t)fused::group_ints(block_rows) * sizeof(int);
  *smem_bytes = smem;
  return fused::launch(tower_fused_infer_kernel, p, B, block_rows, smem, stream);
}

}  // extern "C"
