// Fused STAR eval forward for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/star_infer.py:
// star_fused_infer. For each row b of emb[B, F], with
// d = clip(domain_id[b], 0, D-1):
//   aux   = relu MLP of shared stages on the raw row, then its 1-unit head;
//   h     = gamma[d] * ((emb[b] - mean) * rstd) + beta[d]   (the domain norm,
//           its batch mean and rstd [F] computed outside the kernel);
//   h     = relu(h W_d + b_d) for every FCN stage of domain d, the last of
//           width 1 included (BatchNorm folded into W_d, b_d);
//   out   = sigmoid(h + aux).
// The TPU kernel computes every domain's FCN for every row and selects; the
// value per row is the same.
//
// What bounds it on this card: arithmetic. At STAR's Ali-CCP shape (F = 376,
// FCN [256,128,64,32,16,8,1], aux [16], 3 domains) a row costs 139,912
// multiply-adds in its own FCN and 6,032 in the aux MLP and moves ~1.5 KB,
// so a 4096-row batch is ~1.2 GFLOP against ~6 MB: the FP32 SIMT peak
// bounds it, not HBM.
//
// What the design does about it (fused_mlp.cuh): one block of 256 threads
// owns tb rows (default 16), held in dynamic shared memory: the raw tile
// [tb, F], which the aux MLP reads and the domain norm then overwrites in
// place, and two ping-pong buffers [tb, widest stage output]. The aux MLP
// runs on the tile's rows 8 at a time, the FCN on rows grouped by domain, 4
// at a time, so a row pays for its own domain only. Weights (~0.9 MB for 3
// domains) stream from L2 through L1, which shares the SM's memory with the
// blocks' buffers: three buffers as wide as the tile left it too little.
//
// Bound through ctypes: a plain C interface, every pointer and the stream as
// void*, the cudaError_t of the launch returned.

#include "fused_mlp.cuh"

namespace {

using fused::Act;
using fused::Groups;
using fused::Stage;

struct Args {
  const float* emb;    // [B, F]
  const int* did;      // [B]
  float* out;          // [B]
  const float* mean;   // [F]
  const float* rstd;   // [F]
  const float* gamma;  // [D, F]
  const float* beta;   // [D, F]
  int B, F, D, tb, ld_x, ld;     // row strides of the tile and of the buffers
  int n_fcn, n_aux;
  Stage st[fused::kMaxStages];  // FCN stages, aux stages, aux head
};

__global__ void __launch_bounds__(fused::kThreads)
star_fused_infer_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(16) float smem[];
  const int tb = p.tb, ld = p.ld, ld_x = p.ld_x, F = p.F;
  float* x = smem;                       // [tb, ld_x] raw tile, then normalised
  float* buf0 = x + tb * ld_x;           // [tb, ld]
  float* buf1 = buf0 + tb * ld;          // [tb, ld]
  float* aux = buf1 + tb * ld;           // [tb]
  int* did_s = reinterpret_cast<int*>(aux + fused::round4(tb));

  const int row0 = blockIdx.x * tb;
  const int rows = min(tb, p.B - row0);
  fused::stage_tile(p.emb, p.did, row0, rows, F, p.D, x, ld_x, tb, did_s);
  __syncthreads();
  Groups all, own;
  fused::build_groups(did_s, rows, tb, did_s + tb, &all, &own);

  // 1. the aux MLP on the raw rows and its head: aux logit per row
  Act a = fused::chain<fused::kSharedRows, 1>(all, Act{x, 0, ld_x}, p.st + p.n_fcn,
                                              p.n_aux, 0, 0, buf0, buf1, ld, rows);
  fused::chain<fused::kSharedRows, 0>(all, a, p.st + p.n_fcn + p.n_aux, 1, 0, 0, buf0,
                                      buf1, ld, rows, aux, 1);

  // 2. the domain norm of the row's own domain, in place
  for (int i = threadIdx.x; i < rows * F; i += blockDim.x) {
    const int r = i / F, k = i % F;
    const size_t dk = (size_t)did_s[r] * F + k;
    float* v = x + (size_t)r * ld_x + k;
    *v = fmaf(__ldg(p.gamma + dk), (*v - __ldg(p.mean + k)) * __ldg(p.rstd + k),
              __ldg(p.beta + dk));
  }
  __syncthreads();

  // 3. the own domain's FCN, relu after every stage, the width-1 one too
  const Act h = fused::chain<fused::kDomainRows, 1>(own, Act{x, 0, ld_x}, p.st, p.n_fcn, 0,
                                                    1, buf0, buf1, ld, rows);
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    p.out[row0 + r] = fused::sigmoid(h.p[(size_t)r * h.ld] + aux[r]);
}

}  // namespace

extern "C" {

// w_ptrs/b_ptrs: host arrays of device pointers, one per stage, in the order
// FCN stages, aux stages, aux head; dims: (K, N) per stage. Writes the
// dynamic shared memory a block needs to *smem_bytes. Returns a cudaError_t.
int star_fused_infer_f32(const void* emb, const void* did, void* out, const void* mean,
                         const void* rstd, const void* gamma, const void* beta, int B,
                         int F, int D, int n_fcn, int n_aux, const void* w_ptrs,
                         const void* b_ptrs, const void* dims, int block_rows,
                         void* stream, size_t* smem_bytes) {
  Args p = {};
  const int n = n_fcn + n_aux + 1;
  if (B < 0 || F < 1 || D < 1 || n_fcn < 1 || n_aux < 0 ||
      block_rows < fused::kSharedRows || block_rows > fused::kMaxBlockRows ||
      block_rows % fused::kSharedRows != 0 ||
      !fused::fill_stages(p.st, n, w_ptrs, b_ptrs, dims))
    return (int)cudaErrorInvalidValue;
  int max_w = 1, width = F;
  for (int s = 0; s < n_fcn; ++s) {
    if (p.st[s].K != width) return (int)cudaErrorInvalidValue;
    width = p.st[s].N;
    max_w = width > max_w ? width : max_w;
  }
  if (width != 1) return (int)cudaErrorInvalidValue;
  width = F;
  for (int s = n_fcn; s < n; ++s) {
    if (p.st[s].K != width) return (int)cudaErrorInvalidValue;
    width = p.st[s].N;
    max_w = width > max_w ? width : max_w;
  }
  if (width != 1) return (int)cudaErrorInvalidValue;
  p.emb = static_cast<const float*>(emb);
  p.did = static_cast<const int*>(did);
  p.out = static_cast<float*>(out);
  p.mean = static_cast<const float*>(mean);
  p.rstd = static_cast<const float*>(rstd);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.B = B; p.F = F; p.D = D; p.tb = block_rows;
  p.ld_x = fused::round4(F);
  p.ld = fused::round4(max_w);
  p.n_fcn = n_fcn; p.n_aux = n_aux;
  const size_t smem = ((size_t)block_rows * (p.ld_x + 2 * p.ld) + fused::round4(block_rows)) * sizeof(float)
                      + (size_t)fused::group_ints(block_rows) * sizeof(int);
  *smem_bytes = smem;
  return fused::launch(star_fused_infer_kernel, p, B, block_rows, smem, stream);
}

}  // extern "C"
