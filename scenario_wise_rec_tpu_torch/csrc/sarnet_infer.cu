// Fused SAR-Net eval forward for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel scenario_wise_rec_tpu/ops/pallas/sarnet_infer.py:
// sarnet_fused_infer. For each row b of emb[B, F], with
// d = clip(domain_id[b], 0, D-1):
//   x      = emb[b] * dom_w[d] + dom_b[d]            (the domain's scale/shift)
//   e_j    = x W_sh[j] + b_sh[j]                      (n_sh shared debias experts)
//   e_n_sh+i = x W_sp[d, i] + b_sp[d, i]              (the domain's n_sp own ones)
//   g      = softmax(x W_g + b_g)                     (over the n_sh + n_sp experts)
//   h      = sum_e g[e] * e_e                         (width 16)
//   out    = sigmoid(head(relu MLP(h)))
// Each debias expert is BatchNorm -> Linear, folded into one affine outside
// the kernel (folding.fold_bn_linear_eval). The TPU kernel computes every
// domain's specific experts on every domain's scaled embedding and selects
// after; a row's own domain on its own scaled embedding is the same value.
//
// What bounds it on this card: arithmetic. At SAR-Net's Ali-CCP shape
// (F = 368, 8 shared + 2 specific experts of width 16, gate 368 -> 10, final
// [32, 32] and head) a row costs ~64.7k multiply-adds and moves ~1.5 KB, so
// a 4096-row batch is ~0.53 GFLOP against ~6 MB: the FP32 SIMT peak bounds
// it, not HBM.
//
// What the design does about it (fused_mlp.cuh): one block of 256 threads
// owns tb rows (default 16) in dynamic shared memory: the tile, scaled in
// place by each row's own domain; the n_sh + n_sp expert outputs; the gate;
// two ping-pong buffers for the final MLP. The shared experts, the gate and
// the final MLP take the tile's rows 8 at a time; the specific experts take
// rows grouped by domain, 4 at a time. Every stage is narrow (16 or 10
// columns), so split-k spreads each over up to 32 lanes.
//
// The weights come as one list: shared experts, specific experts, gate,
// the final stages, the head.
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
  const float* dom_w;  // [D, F]
  const float* dom_b;  // [D, F]
  int B, F, D, n_sh, n_sp, n_fin, tb;
  int ld_f, ld_w, ld_e, ld_g;  // row strides: tile, ping-pong, expert slot, gate
  Stage st[fused::kMaxStages];  // shared, specific, gate, final stages, head
};

__global__ void __launch_bounds__(fused::kThreads)
sarnet_fused_infer_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(16) float smem[];
  const int tb = p.tb, F = p.F, E = p.n_sh + p.n_sp;
  float* x = smem;                                   // [tb, ld_f]
  float* slots = x + (size_t)tb * p.ld_f;            // [E, tb, ld_e]
  float* gate = slots + (size_t)E * tb * p.ld_e;     // [tb, ld_g]
  float* pp0 = gate + (size_t)tb * p.ld_g;           // [tb, ld_w]
  float* pp1 = pp0 + (size_t)tb * p.ld_w;            // [tb, ld_w]
  float* logit = pp1 + (size_t)tb * p.ld_w;          // [tb]
  int* did_s = reinterpret_cast<int*>(logit + fused::round4(tb));

  const int row0 = blockIdx.x * tb;
  const int rows = min(tb, p.B - row0);
  fused::stage_tile(p.emb, p.did, row0, rows, F, p.D, x, p.ld_f, tb, did_s);
  __syncthreads();
  Groups all, own;
  fused::build_groups(did_s, rows, tb, did_s + tb, &all, &own);

  // 1. the own domain's scale and shift, in place (rounded as x * w, then + b)
  for (int i = threadIdx.x; i < rows * F; i += blockDim.x) {
    const int r = i / F, k = i % F;
    const size_t dk = (size_t)did_s[r] * F + k;
    float* v = x + (size_t)r * p.ld_f + k;
    *v = __fadd_rn(__fmul_rn(*v, __ldg(p.dom_w + dk)), __ldg(p.dom_b + dk));
  }
  __syncthreads();

  // 2. the experts: shared ones on every row, the own domain's specific ones
  const Act in{x, 0, p.ld_f};
  const size_t slot = (size_t)tb * p.ld_e;
  for (int j = 0; j < p.n_sh; ++j)
    fused::chain<fused::kSharedRows, 0>(all, in, p.st, 1, j, 0, pp0, pp1, p.ld_w, rows,
                                        slots + j * slot, p.ld_e);
  for (int i = 0; i < p.n_sp; ++i)
    fused::chain<fused::kDomainRows, 0>(own, in, p.st + 1, 1, i, p.n_sp, pp0, pp1, p.ld_w,
                                        rows, slots + (p.n_sh + i) * slot, p.ld_e);
  // 3. the gate, a softmax over the experts
  fused::chain<fused::kSharedRows, 2>(all, in, p.st + 2, 1, 0, 0, pp0, pp1, p.ld_w, rows,
                                      gate, p.ld_g);

  // 4. the mixture into pp0, summed over the experts in order
  const int H = p.st[0].N;
  for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
    const int h = i % H, r = i / H;
    const float* g = gate + (size_t)r * p.ld_g;
    const float* e = slots + (size_t)r * p.ld_e + h;
    float m = g[0] * e[0];
    for (int k = 1; k < E; ++k) m = fmaf(g[k], e[k * slot], m);
    pp0[(size_t)r * p.ld_w + h] = m;
  }
  __syncthreads();

  // 5. the final relu MLP and its head
  const Act t = fused::chain<fused::kSharedRows, 1>(all, Act{pp0, 0, p.ld_w}, p.st + 3,
                                                    p.n_fin, 0, 0, pp0, pp1, p.ld_w, rows);
  fused::chain<fused::kSharedRows, 0>(all, t, p.st + 3 + p.n_fin, 1, 0, 0, pp0, pp1, p.ld_w,
                                      rows, logit, 1);
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    p.out[row0 + r] = fused::sigmoid(logit[r]);
}

}  // namespace

extern "C" {

// w_ptrs/b_ptrs: host arrays of device pointers, one per stage, in the order
// shared experts (W [n_sh, F, H]), specific experts (W [D, n_sp, F, H]),
// gate (W [F, n_sh + n_sp]), final stages, head; dims: (K, N) per stage.
// Writes the dynamic shared memory a block needs to *smem_bytes. Returns a
// cudaError_t.
int sarnet_fused_infer_f32(const void* emb, const void* did, void* out, const void* dom_w,
                           const void* dom_b, int B, int F, int D, int n_sh, int n_sp,
                           int n_fin, const void* w_ptrs, const void* b_ptrs,
                           const void* dims, int block_rows, void* stream,
                           size_t* smem_bytes) {
  Args p = {};
  const int n = 3 + n_fin + 1;
  if (B < 0 || F < 1 || D < 1 || n_sh < 1 || n_sp < 1 || n_fin < 0 ||
      block_rows < fused::kSharedRows || block_rows > fused::kMaxBlockRows ||
      block_rows % fused::kSharedRows != 0 ||
      !fused::fill_stages(p.st, n, w_ptrs, b_ptrs, dims))
    return (int)cudaErrorInvalidValue;
  const int H = p.st[0].N;
  if (p.st[0].K != F || p.st[1].K != F || p.st[1].N != H || p.st[2].K != F ||
      p.st[2].N != n_sh + n_sp)
    return (int)cudaErrorInvalidValue;
  int width = H, max_w = H;
  for (int s = 3; s < n; ++s) {
    if (p.st[s].K != width) return (int)cudaErrorInvalidValue;
    width = p.st[s].N;
    max_w = width > max_w ? width : max_w;
  }
  if (width != 1) return (int)cudaErrorInvalidValue;
  p.emb = static_cast<const float*>(emb);
  p.did = static_cast<const int*>(did);
  p.out = static_cast<float*>(out);
  p.dom_w = static_cast<const float*>(dom_w);
  p.dom_b = static_cast<const float*>(dom_b);
  p.B = B; p.F = F; p.D = D; p.n_sh = n_sh; p.n_sp = n_sp; p.n_fin = n_fin;
  p.tb = block_rows;
  p.ld_f = fused::round4(F);
  p.ld_w = fused::round4(max_w);
  p.ld_e = fused::round4(H);
  p.ld_g = fused::round4(n_sh + n_sp);
  const size_t tb = block_rows;
  const size_t floats = tb * (p.ld_f + (size_t)(n_sh + n_sp) * p.ld_e + p.ld_g + 2 * p.ld_w)
                        + fused::round4(block_rows);
  const size_t smem = floats * sizeof(float) + (size_t)fused::group_ints(block_rows) * sizeof(int);
  *smem_bytes = smem;
  return fused::launch(sarnet_fused_infer_kernel, p, B, block_rows, smem, stream);
}

}  // extern "C"
